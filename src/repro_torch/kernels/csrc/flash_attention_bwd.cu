// Blocked GQA flash attention, backward, for sm_90a.
//
// The port's own kernel: the TPU package has no backward kernel (JAX trains
// through autograd of its XLA attention, repro/models/layers.py::_attn_chunked,
// so this replaces that XLA gradient).  It is the backward of
// flash_attention.cu's forward, with FlashAttention-2's math: the forward
// saves each row's log-sum-exp (lse), and
//
//   P  = exp(S - lse),  S = softcap(Q K^T * scale)          (recomputed)
//   Δ  = rowsum(dO ∘ O)                                      (delta kernels)
//   dV = P^T dO,  dP = dO V^T,  dS = P ∘ (dP - Δ) ∘ tanh'    (dK/dV pass)
//   dK = dS^T Q * scale,  dQ = dS K * scale                  (dK/dV, dQ passes)
//
// Bound on the card: operations.  The least work is five products of the
// visible (query, key) pairs, 10 * D FLOPs a pair (Q K^T, dO V^T, P^T dO,
// dS^T Q, dS K): 2.5x the forward's.  Both routes do seven (S and dP are
// recomputed in the dQ pass, which keeps them free of atomics and their
// outputs bit-identical from run to run).
//
// bf16 route (Hopper: TMA, wgmma, warp specialisation; sm90.cuh).  Four
// launches:
//  1. delta_pad_kernel: Δ and a copy of lse into (B, Hq, Sq_pad) f32 buffers,
//     Sq_pad = Sq rounded up to 128; padding rows get Δ = 0 and lse = 1e30,
//     so a query row past Sq has P = 0.
//  2. dkdv_sm90: one block of 384 threads per (128-key block, q head, batch).
//     Warpgroup 0 is the producer: one thread loads the block's K and V once
//     and streams (Q, dO, lse, Δ) tiles of 64 query rows through a ring of
//     two TMA stages.  Warpgroups 1 and 2 own 64 keys each.  Per tile:
//     S^T = K Q^T and dP^T = V dO^T by wgmma from shared memory (K-major);
//     P^T and dS^T in registers; dV += P^T dO and dK += dS^T Q by wgmma with A
//     from registers and B (dO, Q) MN-major.  dK and dV stay in f32 registers
//     for the block's life and are written once, as f32 partials of the q
//     head, into (B, Sk, Hq, D) scratch.
//  3. group_sum_kernel: sums each GQA group's partials in a fixed order,
//     scales dK, writes bf16 dk and dv.
//  4. dq_sm90: one block per (128-query block, q head, batch): the forward's
//     loop over the visible 64-key tiles (two TMA stages); S = Q K^T and
//     dP = dO V^T by wgmma, dS in registers, dQ += dS K with A from registers
//     and B = K MN-major; dQ stays in registers and is written once, scaled.
// Only tiles on the causal diagonal, the window's edge or the key tail are
// masked.  P and dS are rounded to bf16 for their products, as
// FlashAttention-2 does; scores and accumulators are f32.  Consumers run at
// 240 registers and the producer at 24 (setmaxnreg).
//
// f32 route (the first version's, unchanged): one block of 4 warps per (k
// block, kv head, batch) loops over the G query heads of its group, so the
// GQA sum is taken inside the block; then dQ per (q block, q head, batch).
// Accumulators in shared memory, scalar FMAs in full f32 (the TPU kernel's
// f32 dots), tiles of 64 query rows and 32 keys.
//
// Supported: bf16 and f32, D in {32, 64, 128}, any Hq % Hkv == 0.  The
// wrapper (repro_torch/kernels/flash_attention/ops.py) checks everything
// else and allocates the scratch.
#include "attn_tile.cuh"
#include "sm90.cuh"

using namespace attn;

namespace {

__host__ __device__ constexpr size_t al(size_t n) { return (n + 127) / 128 * 128; }

// ===========================================================================
// f32 route
// ===========================================================================

// Shared memory of the two f32 block kernels; the same numbers size the
// launch.  Pitches pad by 1 to keep the scalar path's column reads free of
// bank conflicts.  P and dS overwrite S and dP in place.
template <int D, int BQ, int BK>
struct Bwd {
  static constexpr int LQ = D + 1;  // Q, dO, K, V
  static constexpr int LS = BK + 4;  // S, dP, and P, dS in place
  static constexpr int LO = D + 4;   // dK, dV, dQ accumulators
  static constexpr size_t kv = al(size_t(BK) * LQ * 4);
  static constexpr size_t qd = al(size_t(BQ) * LQ * 4);
  static constexpr size_t s = al(size_t(BQ) * LS * 4);
  static constexpr size_t rows = al(size_t(BQ) * 4);
  static constexpr size_t kacc = al(size_t(BK) * LO * 4);
  static constexpr size_t qacc = al(size_t(BQ) * LO * 4);
  static constexpr size_t dkdv_bytes = 2 * kv + 2 * qd + 2 * s + 2 * rows + 2 * kacc;
  static constexpr size_t dq_bytes = 2 * kv + 2 * qd + 2 * s + 2 * rows + qacc;
};

// Hands out consecutive 128-byte aligned pieces of dynamic shared memory.
struct Carve {
  unsigned char* at;
  template <typename U>
  __device__ U* take(size_t bytes) {
    U* out = reinterpret_cast<U*>(at);
    at += bytes;
    return out;
  }
};

// C (M x N, pitch ldc) = [C +] op(A) op(B), all f32 in shared memory, where
// op(A)(m, k) = TA ? A[k * lda + m] : A[m * lda + k] and
// op(B)(k, n) = TB ? B[n * ldb + k] : B[k * ldb + n].  Whole block, one
// element a thread.  The K products are summed on their own and added to C
// once, so a long accumulation (dK over every q block of a GQA group) rounds
// once per tile, not once per product, at the magnitude of the running sum.
// The caller synchronises before reading C.
template <int M, int N, int K, bool TA, bool TB>
__device__ void block_mma(float* C, int ldc, const float* A, int lda, const float* B, int ldb,
                          bool accumulate) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int m = i / N;
    const int n = i % N;
    float part = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = TA ? A[k * lda + m] : A[m * lda + k];
      const float b = TB ? B[n * ldb + k] : B[k * ldb + n];
      part = fmaf(a, b, part);
    }
    C[m * ldc + n] = accumulate ? C[m * ldc + n] + part : part;
  }
}

// From S = Q K^T and dP = dO V^T (pitch LS) of a BQ x BK tile and the rows'
// lse and delta: P = exp(softcap(S * scale) - lse) where `mask(row, col)`
// holds, else 0, and dS = P (dP - delta) times the softcap's tanh derivative.
// P (when `with_p`) overwrites S and dS overwrites dP in place (each element
// is read and written by one thread).  Whole block.
template <int BQ, int BK, int LS, class Mask>
__device__ void probs_and_dscores(float* S, float* dP, const float* lse, const float* delta,
                                  bool with_p, float scale, float softcap, Mask mask) {
  for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
    const int r = i / BK;
    const int c = i % BK;
    float s = S[r * LS + c] * scale;
    float dcap = 1.f;
    if (softcap > 0.f) {
      const float t = tanhf(s / softcap);
      s = softcap * t;
      dcap = 1.f - t * t;
    }
    const float p = mask(r, c) ? expf(s - lse[r]) : 0.f;
    const float ds = p * (dP[r * LS + c] - delta[r]) * dcap;
    if (with_p) S[r * LS + c] = p;
    dP[r * LS + c] = ds;
  }
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], f32.  One warp per
// row of the (B, Sq, Hq) layout.
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 float* __restrict__ delta, int Sq, int Hq, int D, long rows) {
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const float* po = o + row * D;
  const float* pd = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(po[d], pd[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long h = row % Hq;
    const long i = (row / Hq) % Sq;
    const long b = row / ((long)Hq * Sq);
    delta[(b * Hq + h) * Sq + i] = acc;
  }
}

// Loads the lse and delta of q rows [q0, q0 + valid) of head h (0 past valid).
__device__ void load_row_stats(float* slse, float* sdelta, const float* lse, const float* delta,
                               long base, int n, int valid) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    slse[r] = r < valid ? lse[base + r] : 0.f;
    sdelta[r] = r < valid ? delta[base + r] : 0.f;
  }
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
                int causal, int window, float softcap, int q_offset, float scale) {
  using L = Bwd<D, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carve cv{smem_raw};
  float* sk = cv.take<float>(L::kv);
  float* sv = cv.take<float>(L::kv);
  float* sq = cv.take<float>(L::qd);
  float* sdo = cv.take<float>(L::qd);
  float* sS = cv.take<float>(L::s);
  float* sdP = cv.take<float>(L::s);
  float* slse = cv.take<float>(L::rows);
  float* sdelta = cv.take<float>(L::rows);
  float* sdk = cv.take<float>(L::kacc);
  float* sdv = cv.take<float>(L::kacc);

  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int k_lo = blockIdx.x * BK;
  const int k_valid = min(BK, Sk - k_lo);
  const long kv_stride = (long)Hkv * D;
  const long kv_off = ((long)b * Sk + k_lo) * kv_stride + (long)hk * D;
  load_rows<float, D, L::LQ>(sk, k + kv_off, kv_stride, BK, k_valid);
  load_rows<float, D, L::LQ>(sv, v + kv_off, kv_stride, BK, k_valid);
  for (int i = threadIdx.x; i < BK * L::LO; i += kThreads) {
    sdk[i] = 0.f;
    sdv[i] = 0.f;
  }

  // the q blocks that can see keys [k_lo, k_lo + k_valid): causal needs
  // q_pos >= k_pos, the window q_pos < k_pos + window
  int qb0 = 0;
  int qb1 = (Sq + BQ - 1) / BQ;
  if (causal) qb0 = max(0, k_lo - q_offset) / BQ;
  if (window > 0) {
    const int last = k_lo + k_valid - 1 + window - 1 - q_offset;  // last q index that sees a key
    qb1 = min(qb1, last < 0 ? 0 : last / BQ + 1);
  }

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qb = qb0; qb < qb1; ++qb) {
      const int q0 = qb * BQ;
      const int q_valid = min(BQ, Sq - q0);
      __syncthreads();  // the previous tile is fully consumed
      const long q_off = ((long)b * Sq + q0) * Hq * D + (long)h * D;
      load_rows<float, D, L::LQ>(sq, q + q_off, (long)Hq * D, BQ, q_valid);
      load_rows<float, D, L::LQ>(sdo, dout + q_off, (long)Hq * D, BQ, q_valid);
      load_row_stats(slse, sdelta, lse, delta, ((long)b * Hq + h) * Sq + q0, BQ, q_valid);
      __syncthreads();
      block_mma<BQ, BK, D, false, true>(sS, L::LS, sq, L::LQ, sk, L::LQ, false);    // Q K^T
      block_mma<BQ, BK, D, false, true>(sdP, L::LS, sdo, L::LQ, sv, L::LQ, false);  // dO V^T
      __syncthreads();
      const int qp0 = q_offset + q0;
      auto mask = [=](int r, int c) {
        const int qp = qp0 + r;
        const int kp = k_lo + c;
        bool ok = r < q_valid && c < k_valid;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        return ok;
      };
      probs_and_dscores<BQ, BK, L::LS>(sS, sdP, slse, sdelta, true, scale, softcap, mask);
      __syncthreads();
      block_mma<BK, D, BQ, true, false>(sdv, L::LO, sS, L::LS, sdo, L::LQ, true);   // += P^T dO
      block_mma<BK, D, BQ, true, false>(sdk, L::LO, sdP, L::LS, sq, L::LQ, true);  // += dS^T Q
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int row = i / D;
    const int d = i % D;
    if (row < k_valid) {
      const long at = kv_off + (long)row * kv_stride + d;
      dk[at] = sdk[row * L::LO + d] * scale;
      dv[at] = sdv[row * L::LO + d];
    }
  }
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal, int window,
              float softcap, int q_offset, float scale) {
  using L = Bwd<D, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carve cv{smem_raw};
  float* sk = cv.take<float>(L::kv);
  float* sv = cv.take<float>(L::kv);
  float* sq = cv.take<float>(L::qd);
  float* sdo = cv.take<float>(L::qd);
  float* sS = cv.take<float>(L::s);
  float* sdP = cv.take<float>(L::s);
  float* slse = cv.take<float>(L::rows);
  float* sdelta = cv.take<float>(L::rows);
  float* sdq = cv.take<float>(L::qacc);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int q_valid = min(BQ, Sq - q0);
  const long q_off = ((long)b * Sq + q0) * Hq * D + (long)h * D;
  load_rows<float, D, L::LQ>(sq, q + q_off, (long)Hq * D, BQ, q_valid);
  load_rows<float, D, L::LQ>(sdo, dout + q_off, (long)Hq * D, BQ, q_valid);
  load_row_stats(slse, sdelta, lse, delta, ((long)b * Hq + h) * Sq + q0, BQ, q_valid);
  for (int i = threadIdx.x; i < BQ * L::LO; i += kThreads) sdq[i] = 0.f;

  // the KV blocks this q block can see, as in the forward kernel
  const int qp0 = q_offset + q0;
  const int q_hi = qp0 + BQ - 1;
  int kb0 = 0;
  int kb1 = (Sk + BK - 1) / BK;
  if (window > 0) kb0 = max(0, qp0 - window + 1) / BK;
  if (causal) kb1 = min(kb1, q_hi < 0 ? 0 : q_hi / BK + 1);

  const long kv_stride = (long)Hkv * D;
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k_lo = kb * BK;
    const int k_valid = min(BK, Sk - k_lo);
    __syncthreads();  // the previous tile is fully consumed
    const long kv_off = ((long)b * Sk + k_lo) * kv_stride + (long)hk * D;
    load_rows<float, D, L::LQ>(sk, k + kv_off, kv_stride, BK, k_valid);
    load_rows<float, D, L::LQ>(sv, v + kv_off, kv_stride, BK, k_valid);
    __syncthreads();
    block_mma<BQ, BK, D, false, true>(sS, L::LS, sq, L::LQ, sk, L::LQ, false);    // Q K^T
    block_mma<BQ, BK, D, false, true>(sdP, L::LS, sdo, L::LQ, sv, L::LQ, false);  // dO V^T
    __syncthreads();
    auto mask = [=](int r, int c) {
      const int qp = qp0 + r;
      const int kp = k_lo + c;
      bool ok = r < q_valid && c < k_valid;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      return ok;
    };
    probs_and_dscores<BQ, BK, L::LS>(sS, sdP, slse, sdelta, false, scale, softcap, mask);
    __syncthreads();
    block_mma<BQ, D, BK, false, false>(sdq, L::LO, sdP, L::LS, sk, L::LQ, true);  // += dS K
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int row = i / D;
    const int d = i % D;
    if (row < q_valid) dq[q_off + (long)row * Hq * D + d] = sdq[row * L::LO + d] * scale;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const void* lse, void* delta, void* dq, void* dk,
                       void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int causal, int window,
                       float softcap, int q_offset, float scale, cudaStream_t stream) {
  constexpr int BQ = 64;
  constexpr int BK = 32;
  using L = Bwd<D, BQ, BK>;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fdelta = static_cast<float*>(delta);

  auto dkdv = dkdv_kernel<D, BQ, BK>;
  auto dqk = dq_kernel<D, BQ, BK>;
  cudaError_t err = prepare(dkdv, L::dkdv_bytes);
  if (err == cudaSuccess) err = prepare(dqk, L::dq_bytes);
  if (err != cudaSuccess) return err;

  const long rows = (long)B * Sq * Hq;
  delta_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const float*>(o), tdo, fdelta, Sq, Hq, D, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((Sk + BK - 1) / BK, Hkv, B), kThreads, L::dkdv_bytes, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk,
      Hq, Hkv, causal, window, softcap, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((Sq + BQ - 1) / BQ, Hq, B), kThreads, L::dq_bytes, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, static_cast<float*>(dq), Sq, Sk, Hq, Hkv, causal, window,
      softcap, q_offset, scale);
  return cudaGetLastError();
}

// ===========================================================================
// bf16 route (sm_90a)
// ===========================================================================
namespace hopper {

using sm90::bf16;
constexpr int kThreads90 = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kStages = 2;
constexpr int kKeyBlock = 128;  // dK/dV pass: keys a block (64 a consumer warpgroup)
constexpr int kQTile = 64;      // dK/dV pass: query rows a streamed tile
constexpr int kQBlock = 128;    // dQ pass: query rows a block (= kernel.py's BWD_Q_PAD)
constexpr int kKTile = 64;      // dQ pass: keys a streamed tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadLse = 1e30f;  // lse of a padding row: P = exp(s - 1e30) = 0

// Δ and lse of every (b, h, i < Sq_pad) into (B, Hq, Sq_pad) buffers; rows
// past Sq get Δ = 0 and lse = kPadLse.  One warp per row.
__global__ void __launch_bounds__(kThreads)
    delta_pad_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ delta_pad,
                     float* __restrict__ lse_pad, int Sq, int Sq_pad, int Hq, int D, long rows) {
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long i = row % Sq_pad;
  const long bh = row / Sq_pad;
  if (i >= Sq) {
    if (lane == 0) {
      delta_pad[row] = 0.f;
      lse_pad[row] = kPadLse;
    }
    return;
  }
  const long h = bh % Hq;
  const long b = bh / Hq;
  const long at = ((b * Sq + i) * Hq + h) * D;
  float acc = 0.f;
  for (int d = lane * 2; d < D; d += 64) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + at + d));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + at + d));
    acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta_pad[row] = acc;
    lse_pad[row] = lse[bh * Sq + i];
  }
}

// Probability and score gradient of one element: s the raw dot, lse2 the
// row's lse * log2(e); returns P and writes dS into dp (which holds dP).
template <bool kSoftcap>
__device__ __forceinline__ float prob_dscore(float s, float& dp, float lse2, float delta,
                                             float scale, float softcap, bool ok) {
  float p;
  float dcap = 1.f;
  if constexpr (kSoftcap) {
    const float t = tanhf(s * scale / softcap);
    dcap = 1.f - t * t;
    p = exp2f(softcap * t * kLog2e - lse2);
  } else {
    p = exp2f(s * (scale * kLog2e) - lse2);
  }
  p = ok ? p : 0.f;
  dp = p * (dp - delta) * dcap;
  return p;
}

// Shared memory of dkdv_sm90 (offsets from a 1024-byte aligned base).
template <int D>
struct DkdvSmem {
  static constexpr int kKV = kKeyBlock * D * 2;
  static constexpr int kQ = kQTile * D * 2;
  static constexpr int k_off = 0;
  static constexpr int v_off = kKV;
  static constexpr int q_off = 2 * kKV;                        // + stage * kQ
  static constexpr int do_off = q_off + kStages * kQ;          // + stage * kQ
  static constexpr int stat_off = do_off + kStages * kQ;       // lse, Δ: 2 x 64 f32 a stage
  static constexpr int bar_off = stat_off + kStages * 2 * kQTile * 4;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

template <int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads90, 1)
    dkdv_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
              const float* __restrict__ lse_pad, const float* __restrict__ delta_pad,
              float* __restrict__ dk_part, float* __restrict__ dv_part, int Sq, int Sk,
              int Sq_pad, int Hq, int Hkv, int causal, int window, float softcap, int q_offset,
              float scale) {
  using L = DkdvSmem<D>;
  using P = sm90::Panel<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = sm90::align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::bar_off);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int k_lo = blockIdx.x * kKeyBlock;
  const int k_valid = min(kKeyBlock, Sk - k_lo);

  // the q tiles that can see keys [k_lo, k_lo + k_valid), as in the f32 route
  int qb0 = 0;
  int qb1 = (Sq + kQTile - 1) / kQTile;
  if (causal) qb0 = max(0, k_lo - q_offset) / kQTile;
  if (window > 0) {
    const int last = k_lo + k_valid - 1 + window - 1 - q_offset;
    qb1 = min(qb1, last < 0 ? 0 : last / kQTile + 1);
  }
  const int n_tiles = max(0, qb1 - qb0);

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer
    sm90::setmaxnreg_dec_24();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(kv_full, 2 * L::kKV);
      sm90::load_tile<D>(sm + L::k_off, &tm_k, kv_full, kKeyBlock, hk, k_lo, b);
      sm90::load_tile<D>(sm + L::v_off, &tm_v, kv_full, kKeyBlock, hk, k_lo, b);
      const long stat_row = ((long)b * Hq + h) * Sq_pad;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const int q0 = (qb0 + it) * kQTile;
        sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kQ + 2 * kQTile * 4);
        sm90::load_tile<D>(sm + L::q_off + s * L::kQ, &tm_q, &full[s], kQTile, h, q0, b);
        sm90::load_tile<D>(sm + L::do_off + s * L::kQ, &tm_do, &full[s], kQTile, h, q0, b);
        float* stats = reinterpret_cast<float*>(sm + L::stat_off) + s * 2 * kQTile;
        sm90::bulk_load(stats, lse_pad + stat_row + q0, kQTile * 4, &full[s]);
        sm90::bulk_load(stats + kQTile, delta_pad + stat_row + q0, kQTile * 4, &full[s]);
      }
    }
  } else {
    // consumers: warpgroup c owns keys k_lo + 64 c .. + 63
    sm90::setmaxnreg_inc_240();
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int kr0 = 16 * warp + lane / 4;  // this thread's key rows: kr0, kr0 + 8
    const int qc0 = 2 * (lane % 4);        // and query columns qc0 + 8 j (+ 1)
    const int wk_lo = k_lo + 64 * c;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(kv_full, 0);
    const unsigned char* sK = sm + L::k_off;
    const unsigned char* sV = sm + L::v_off;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      sm90::mbar_wait(&full[s], (it / kStages) & 1);
      const unsigned char* sQ = sm + L::q_off + s * L::kQ;
      const unsigned char* sDO = sm + L::do_off + s * L::kQ;
      const float* slse = reinterpret_cast<const float*>(sm + L::stat_off) + s * 2 * kQTile;
      const float* sdelta = slse + kQTile;

      float st[32], dpt[32];  // S^T and dP^T: 64 keys x 64 query rows
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<64>::ss<0, 0>(st, P::template kmajor<kKeyBlock>(sK, 64 * c, kk),
                                  P::template kmajor<kQTile>(sQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<64>::ss<0, 0>(dpt, P::template kmajor<kKeyBlock>(sV, 64 * c, kk),
                                  P::template kmajor<kQTile>(sDO, 0, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      const int q0 = (qb0 + it) * kQTile;
      const int qp_lo = q_offset + q0;
      const bool masked =
          sm90::needs_mask(qp_lo, qp_lo + kQTile - 1, wk_lo, wk_lo + 63, Sk, causal, window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(slse + 8 * j + qc0);
        const float2 dl = *reinterpret_cast<const float2*>(sdelta + 8 * j + qc0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const int qc = 8 * j + qc0 + (e & 1);
          const int kp = wk_lo + kr0 + 8 * (e >> 1);
          const bool ok = !masked || sm90::visible(qp_lo + qc, kp, Sk, causal, window);
          st[i] = prob_dscore<kSoftcap>(st[i], dpt[i], ((e & 1) ? l2.y : l2.x) * kLog2e,
                                        (e & 1) ? dl.y : dl.x, scale, softcap, ok);
        }
      }
      uint32_t pa[4][4], da[4][4];  // A fragments of P^T and dS^T, k-steps of 16 query rows
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = sm90::pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          da[kk][r] = sm90::pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::Wgmma<D>::template rs<1>(dv, pa[kk], P::template mnmajor<kQTile>(sDO, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::Wgmma<D>::template rs<1>(dk, da[kk], P::template mnmajor<kQTile>(sQ, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dk);
      sm90::fence_regs(dv);
      sm90::mbar_arrive(&empty[s]);
    }

    // f32 partials of this q head; the group sum scales dK
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int key = wk_lo + kr0 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + qc0;
      if (key < Sk) {
        const long at = (((long)b * Sk + key) * Hq + h) * D + col;
        *reinterpret_cast<float2*>(dk_part + at) = make_float2(dk[i], dk[i + 1]);
        *reinterpret_cast<float2*>(dv_part + at) = make_float2(dv[i], dv[i + 1]);
      }
    }
  }
}

// dk[b, s, hk] = scale * sum_g dk_part[b, s, hk G + g] (g = 0 .. G-1 in
// order), dv likewise without the scale; four elements a thread.
__global__ void __launch_bounds__(256)
    group_sum_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, long n4, int Hkv, int G, int D,
                     float scale) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const long e = i * 4;  // element of the (B, Sk, Hkv, D) output
  const int d = int(e % D);
  const long hk = (e / D) % Hkv;
  const long row = e / ((long)D * Hkv);  // b * Sk + s
  const long src = (row * Hkv * G + hk * G) * D + d;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 sv = sk;
  for (int g = 0; g < G; ++g) {
    const float4 a = *reinterpret_cast<const float4*>(dk_part + src + (long)g * D);
    const float4 c = *reinterpret_cast<const float4*>(dv_part + src + (long)g * D);
    sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
    sv.x += c.x, sv.y += c.y, sv.z += c.z, sv.w += c.w;
  }
  __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk + e);
  __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv + e);
  ok[0] = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
  ok[1] = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
  ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
  ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

// Shared memory of dq_sm90 (offsets from a 1024-byte aligned base).
template <int D>
struct DqSmem {
  static constexpr int kQ = kQBlock * D * 2;
  static constexpr int kKV = kKTile * D * 2;
  static constexpr int q_off = 0;
  static constexpr int do_off = kQ;
  static constexpr int k_off = 2 * kQ;                   // + stage * kKV
  static constexpr int v_off = k_off + kStages * kKV;    // + stage * kKV
  static constexpr int bar_off = v_off + kStages * kKV;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads90, 1)
    dq_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse_pad, const float* __restrict__ delta_pad,
            bf16* __restrict__ dq, int Sq, int Sk, int Sq_pad, int Hq, int Hkv, int causal,
            int window, float softcap, int q_offset, float scale) {
  using L = DqSmem<D>;
  using P = sm90::Panel<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = sm90::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::bar_off);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQBlock;  // longest rows first

  // the key tiles this q block can see, as in the forward
  const int qp0 = q_offset + q0;
  const int q_hi = qp0 + kQBlock - 1;
  int kb0 = 0;
  int kb1 = (Sk + kKTile - 1) / kKTile;
  if (window > 0) kb0 = max(0, qp0 - window + 1) / kKTile;
  if (causal) kb1 = min(kb1, q_hi < 0 ? 0 : q_hi / kKTile + 1);
  const int n_tiles = max(0, kb1 - kb0);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    sm90::setmaxnreg_dec_24();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(q_full, 2 * L::kQ);
      sm90::load_tile<D>(sm + L::q_off, &tm_q, q_full, kQBlock, h, q0, b);
      sm90::load_tile<D>(sm + L::do_off, &tm_do, q_full, kQBlock, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const int k0 = (kb0 + it) * kKTile;
        sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kKV);
        sm90::load_tile<D>(sm + L::k_off + s * L::kKV, &tm_k, &full[s], kKTile, hk, k0, b);
        sm90::load_tile<D>(sm + L::v_off + s * L::kKV, &tm_v, &full[s], kKTile, hk, k0, b);
      }
    }
  } else {
    sm90::setmaxnreg_inc_240();
    const int c = wg - 1;  // query rows q0 + 64 c .. + 63
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int r0 = 64 * c + 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
    const int kc0 = 2 * (lane % 4);                // and key columns kc0 + 8 j (+ 1)
    const long stat_row = ((long)b * Hq + h) * Sq_pad + q0 + r0;
    const float lse2[2] = {lse_pad[stat_row] * kLog2e, lse_pad[stat_row + 8] * kLog2e};
    const float dlt[2] = {delta_pad[stat_row], delta_pad[stat_row + 8]};
    const int qp_lo = qp0 + 64 * c;

    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

    sm90::mbar_wait(q_full, 0);
    const unsigned char* sQ = sm + L::q_off;
    const unsigned char* sDO = sm + L::do_off;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      sm90::mbar_wait(&full[s], (it / kStages) & 1);
      const unsigned char* sK = sm + L::k_off + s * L::kKV;
      const unsigned char* sV = sm + L::v_off + s * L::kKV;

      float sc[32], dp[32];  // S and dP: 64 query rows x 64 keys
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<64>::ss<0, 0>(sc, P::template kmajor<kQBlock>(sQ, 64 * c, kk),
                                  P::template kmajor<kKTile>(sK, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<64>::ss<0, 0>(dp, P::template kmajor<kQBlock>(sDO, 64 * c, kk),
                                  P::template kmajor<kKTile>(sV, 0, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      const int k_lo = (kb0 + it) * kKTile;
      const bool masked =
          sm90::needs_mask(qp_lo, qp_lo + 63, k_lo, k_lo + kKTile - 1, Sk, causal, window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hi = (i >> 1) & 1;
        const int qp = q_offset + q0 + r0 + 8 * hi;
        const int kp = k_lo + 8 * (i >> 2) + kc0 + (i & 1);
        const bool ok = !masked || sm90::visible(qp, kp, Sk, causal, window);
        prob_dscore<kSoftcap>(sc[i], dp[i], lse2[hi], dlt[hi], scale, softcap, ok);
      }
      uint32_t da[4][4];  // A fragments of dS, k-steps of 16 keys
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = sm90::pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::Wgmma<D>::template rs<1>(dqa, da[kk], P::template mnmajor<kKTile>(sK, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dqa);
      sm90::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int row = q0 + r0 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + kc0;
      if (row < Sq)
        *reinterpret_cast<__nv_bfloat162*>(dq + (((long)b * Sq + row) * Hq + h) * D + col) =
            __floats2bfloat162_rn(dqa[i] * scale, dqa[i + 1] * scale);
    }
  }
}

template <int D, bool kSoftcap>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, float* delta_pad, float* lse_pad, float* dk_part,
                   float* dv_part, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int Hq,
                   int Hkv, int causal, int window, float softcap, int q_offset, float scale,
                   cudaStream_t stream) {
  const int Sq_pad = (Sq + kQBlock - 1) / kQBlock * kQBlock;
  constexpr int bd = sm90::Panel<D>::kBoxD;
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  cudaError_t err = sm90::make_bshd_map(&q64, q, B, Sq, Hq, D, bd, kQTile);
  if (err == cudaSuccess) err = sm90::make_bshd_map(&do64, dout, B, Sq, Hq, D, bd, kQTile);
  if (err == cudaSuccess) err = sm90::make_bshd_map(&k128, k, B, Sk, Hkv, D, bd, kKeyBlock);
  if (err == cudaSuccess) err = sm90::make_bshd_map(&v128, v, B, Sk, Hkv, D, bd, kKeyBlock);
  if (err == cudaSuccess) err = sm90::make_bshd_map(&q128, q, B, Sq, Hq, D, bd, kQBlock);
  if (err == cudaSuccess) err = sm90::make_bshd_map(&do128, dout, B, Sq, Hq, D, bd, kQBlock);
  if (err == cudaSuccess) err = sm90::make_bshd_map(&k64, k, B, Sk, Hkv, D, bd, kKTile);
  if (err == cudaSuccess) err = sm90::make_bshd_map(&v64, v, B, Sk, Hkv, D, bd, kKTile);
  if (err != cudaSuccess) return err;
  auto dkdv = dkdv_sm90<D, kSoftcap>;
  auto dqk = dq_sm90<D, kSoftcap>;
  err = prepare(dkdv, DkdvSmem<D>::bytes);
  if (err == cudaSuccess) err = prepare(dqk, DqSmem<D>::bytes);
  if (err != cudaSuccess) return err;

  const long rows = (long)B * Hq * Sq_pad;
  delta_pad_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), delta_pad, lse_pad, Sq, Sq_pad, Hq, D, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((Sk + kKeyBlock - 1) / kKeyBlock, Hq, B), kThreads90, DkdvSmem<D>::bytes,
         stream>>>(q64, k128, v128, do64, lse_pad, delta_pad, dk_part, dv_part, Sq, Sk, Sq_pad,
                   Hq, Hkv, causal, window, softcap, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n4 = (long)B * Sk * Hkv * D / 4;
  group_sum_kernel<<<(n4 + 255) / 256, 256, 0, stream>>>(dk_part, dv_part,
                                                         static_cast<bf16*>(dk),
                                                         static_cast<bf16*>(dv), n4, Hkv,
                                                         Hq / Hkv, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((Sq + kQBlock - 1) / kQBlock, Hq, B), kThreads90, DqSmem<D>::bytes, stream>>>(
      q128, k64, v64, do128, lse_pad, delta_pad, static_cast<bf16*>(dq), Sq, Sk, Sq_pad, Hq,
      Hkv, causal, window, softcap, q_offset, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, float* delta_pad, float* lse_pad,
                        float* dk_part, float* dv_part, void* dq, void* dk, void* dv, int B,
                        int Sq, int Sk, int Hq, int Hkv, int causal, int window, float softcap,
                        int q_offset, float scale, cudaStream_t s) {
  if (softcap > 0.f)
    return launch<D, true>(q, k, v, o, dout, lse, delta_pad, lse_pad, dk_part, dv_part, dq, dk,
                           dv, B, Sq, Sk, Hq, Hkv, causal, window, softcap, q_offset, scale, s);
  return launch<D, false>(q, k, v, o, dout, lse, delta_pad, lse_pad, dk_part, dv_part, dq, dk,
                          dv, B, Sq, Sk, Hq, Hkv, causal, window, softcap, q_offset, scale, s);
}

}  // namespace hopper

}  // namespace

extern "C" {

// q, o, dout, dq (B,Sq,Hq,D); k, v, dk, dv (B,Sk,Hkv,D), all contiguous, of
// one type: dtype 0 = f32, 1 = bf16.  lse (B,Hq,Sq) f32 from the forward.
// f32: delta is (B,Hq,Sq) f32 scratch and the other scratch pointers are
// unused.  bf16: delta and lse_pad are (B,Hq,Sq_pad) f32 scratch with
// Sq_pad = Sq rounded up to 128, dk_part and dv_part (B,Sk,Hq,D) f32
// scratch.  Returns the first failed launch's cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* delta, void* lse_pad,
                        void* dk_part, void* dv_part, void* dq, void* dk, void* dv, int B, int Sq,
                        int Sk, int Hq, int Hkv, int D, int dtype, int causal, int window,
                        float softcap, int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || Sk == 0) return cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (D) {
      case 32:
        return launch_f32<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                              causal, window, softcap, q_offset, scale, s);
      case 64:
        return launch_f32<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                              causal, window, softcap, q_offset, scale, s);
      case 128:
        return launch_f32<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                               causal, window, softcap, q_offset, scale, s);
    }
    return cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    float* fd = static_cast<float*>(delta);
    float* fl = static_cast<float*>(lse_pad);
    float* pk = static_cast<float*>(dk_part);
    float* pv = static_cast<float*>(dv_part);
    switch (D) {
      case 32:
        return hopper::launch_bf16<32>(q, k, v, o, dout, lse, fd, fl, pk, pv, dq, dk, dv, B,
                                        Sq, Sk, Hq, Hkv, causal, window, softcap, q_offset,
                                        scale, s);
      case 64:
        return hopper::launch_bf16<64>(q, k, v, o, dout, lse, fd, fl, pk, pv, dq, dk, dv, B,
                                        Sq, Sk, Hq, Hkv, causal, window, softcap, q_offset,
                                        scale, s);
      case 128:
        return hopper::launch_bf16<128>(q, k, v, o, dout, lse, fd, fl, pk, pv, dq, dk, dv, B,
                                        Sq, Sk, Hq, Hkv, causal, window, softcap, q_offset,
                                        scale, s);
    }
  }
  return cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
