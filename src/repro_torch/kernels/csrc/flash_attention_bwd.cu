// Blocked GQA flash attention, backward, for sm_90a.
//
// The port's own kernel: the TPU package has no backward kernel (JAX trains
// through autograd of its XLA attention, repro/models/layers.py::_attn_chunked).
// It is the backward of flash_attention.cu's forward, with FlashAttention-2's
// math: the forward saves each row's log-sum-exp (lse), and
//
//   P  = exp(S - lse),  S = softcap(Q K^T * scale)          (recomputed)
//   Δ  = rowsum(dO ∘ O)                                      (delta_kernel)
//   dV = P^T dO,  dP = dO V^T,  dS = P ∘ (dP - Δ) ∘ tanh'    (dkdv_kernel)
//   dK = dS^T Q * scale,  dQ = dS K * scale                  (dkdv / dq kernels)
//
// Three launches: Δ (one warp per row), then dK/dV with one block per (k
// block, kv head, batch) that loops over the G query heads of its group and
// over the q blocks that can see its keys (causal, window), so the sum over a
// GQA group is taken inside the block and dK/dV need no atomics; then dQ with
// one block per (q block, q head, batch) over the k blocks it can see.  S and
// dP are recomputed in both passes.  Accumulators (dK, dV, dQ) are f32 in
// shared memory; products of bf16 operands go through the tensor cores with
// WMMA (P and dS are rounded to bf16 for their products, as FlashAttention-2
// does), f32 operands through scalar FMAs.  Outputs are in the input's type.
//
// Bound on the card: operations.  The least work is five products of the
// visible (query, key) pairs, 10 * D FLOPs a pair (Q K^T, dO V^T, P^T dO,
// dS^T Q, dS K): 2.5x the forward's.  This first version does seven (S and dP
// twice), with no TMA, no wgmma and no load/compute overlap, one block of 4
// warps per SM at D = 128, so it sits well below that bound.
//
// Supported: T in {f32, bf16}, D in {32, 64, 128}, any Hq % Hkv == 0.  Tiles
// are fixed: 64 query rows, and 64 keys for bf16 or 32 for f32 (an f32 tile
// of 64 keys at D = 128 is over a block's shared memory).  The wrapper
// (repro_torch/kernels/flash_attention/ops.py) checks everything else.
#include "attn_tile.cuh"

using namespace attn;

namespace {

__host__ __device__ constexpr size_t al(size_t n) { return (n + 127) / 128 * 128; }

// Shared memory of the two block kernels; the same numbers size the launch.
// Pitches pad as in attn_tile.cuh's Layout (bf16 by 8 for WMMA, f32 by 1 to
// keep the scalar path's column reads free of bank conflicts).
template <typename T, int D, int BQ, int BK>
struct Bwd {
  static constexpr int LQ = kIsBf16<T> ? D + 8 : D + 1;  // Q, dO, K, V (T)
  static constexpr int LS = BK + 4;                          // S, dP (f32)
  static constexpr int LP = kIsBf16<T> ? BK + 8 : LS;     // P, dS (T; f32 ones overwrite S, dP)
  static constexpr int LO = D + 4;                           // dK, dV, dQ accumulators (f32)
  static constexpr size_t kv = al(size_t(BK) * LQ * sizeof(T));
  static constexpr size_t qd = al(size_t(BQ) * LQ * sizeof(T));
  static constexpr size_t s = al(size_t(BQ) * LS * 4);
  static constexpr size_t p = kIsBf16<T> ? al(size_t(BQ) * LP * sizeof(T)) : 0;
  static constexpr size_t rows = al(size_t(BQ) * 4);
  static constexpr size_t kacc = al(size_t(BK) * LO * 4);
  static constexpr size_t qacc = al(size_t(BQ) * LO * 4);
  static constexpr size_t dkdv_bytes = 2 * kv + 2 * qd + 2 * s + 2 * p + 2 * rows + 2 * kacc;
  static constexpr size_t dq_bytes = 2 * kv + 2 * qd + 2 * s + p + 2 * rows + qacc;
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

// C (M x N, f32, pitch ldc) = [C +] op(A) op(B), all in shared memory, where
// op(A)(m, k) = TA ? A[k * lda + m] : A[m * lda + k] and
// op(B)(k, n) = TB ? B[n * ldb + k] : B[k * ldb + n].
// Whole block; each 16x16 tile of C belongs to one warp (bf16) and each
// element to one thread (f32).  The caller synchronises before reading C.
template <typename T, int M, int N, int K, bool TA, bool TB>
__device__ void block_mma(float* C, int ldc, const T* A, int lda, const T* B, int ldb,
                          bool accumulate) {
  if constexpr (kIsBf16<T>) {
    using namespace nvcuda;
    using LA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
    constexpr int NT = N / 16;
    for (int t = threadIdx.x >> 5; t < (M / 16) * NT; t += kWarps) {
      const int mt = t / NT;
      const int nt = t % NT;
      float* c_at = C + mt * 16 * ldc + nt * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (accumulate) {
        wmma::load_matrix_sync(c, c_at, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(c, 0.f);
      }
#pragma unroll 4
      for (int kk = 0; kk < K / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(a, TA ? A + kk * 16 * lda + mt * 16 : A + mt * 16 * lda + kk * 16,
                               lda);
        wmma::load_matrix_sync(b, TB ? B + nt * 16 * ldb + kk * 16 : B + kk * 16 * ldb + nt * 16,
                               ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(c_at, c, ldc, wmma::mem_row_major);
    }
  } else {
    // The K products are summed on their own and added to C once, so a long
    // accumulation (dK over every q block of a GQA group) rounds once per
    // tile, not once per product, at the magnitude of the running sum.
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
}

// From S = Q K^T and dP = dO V^T (f32, pitch LS) of a BQ x BK tile and the
// rows' lse and delta: P = exp(softcap(S * scale) - lse) where `mask(row, col)`
// holds, else 0, and dS = P (dP - delta) times the softcap's tanh derivative.
// P (when non-null) and dS are written in T with pitch LP; in f32 they may
// overwrite S and dP in place (each element is read and written by one
// thread).  Whole block.
template <typename T, int BQ, int BK, int LS, int LP, class Mask>
__device__ void probs_and_dscores(const float* S, const float* dP, const float* lse,
                                  const float* delta, T* P, T* dS, float scale, float softcap,
                                  Mask mask) {
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
    if (P != nullptr) P[r * LP + c] = from_f<T>(p);
    dS[r * LP + c] = from_f<T>(ds);
  }
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], f32.  One warp per
// row of the (B, Sq, Hq) layout.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                 int Sq, int Hq, int D, long rows) {
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const T* po = o + row * D;
  const T* pd = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(po[d]), to_f(pd[d]), acc);
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

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq,
                int Sk, int Hq, int Hkv, int causal, int window, float softcap, int q_offset,
                float scale) {
  using L = Bwd<T, D, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carve cv{smem_raw};
  T* sk = cv.take<T>(L::kv);
  T* sv = cv.take<T>(L::kv);
  T* sq = cv.take<T>(L::qd);
  T* sdo = cv.take<T>(L::qd);
  float* sS = cv.take<float>(L::s);
  float* sdP = cv.take<float>(L::s);
  T* sP = kIsBf16<T> ? cv.take<T>(L::p) : reinterpret_cast<T*>(sS);
  T* sdS = kIsBf16<T> ? cv.take<T>(L::p) : reinterpret_cast<T*>(sdP);
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
  load_rows<T, D, L::LQ>(sk, k + kv_off, kv_stride, BK, k_valid);
  load_rows<T, D, L::LQ>(sv, v + kv_off, kv_stride, BK, k_valid);
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
      load_rows<T, D, L::LQ>(sq, q + q_off, (long)Hq * D, BQ, q_valid);
      load_rows<T, D, L::LQ>(sdo, dout + q_off, (long)Hq * D, BQ, q_valid);
      load_row_stats(slse, sdelta, lse, delta, ((long)b * Hq + h) * Sq + q0, BQ, q_valid);
      __syncthreads();
      block_mma<T, BQ, BK, D, false, true>(sS, L::LS, sq, L::LQ, sk, L::LQ, false);    // Q K^T
      block_mma<T, BQ, BK, D, false, true>(sdP, L::LS, sdo, L::LQ, sv, L::LQ, false);  // dO V^T
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
      probs_and_dscores<T, BQ, BK, L::LS, L::LP>(sS, sdP, slse, sdelta, sP, sdS, scale, softcap,
                                                  mask);
      __syncthreads();
      block_mma<T, BK, D, BQ, true, false>(sdv, L::LO, sP, L::LP, sdo, L::LQ, true);  // += P^T dO
      block_mma<T, BK, D, BQ, true, false>(sdk, L::LO, sdS, L::LP, sq, L::LQ, true);  // += dS^T Q
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int row = i / D;
    const int d = i % D;
    if (row < k_valid) {
      const long at = kv_off + (long)row * kv_stride + d;
      dk[at] = from_f<T>(sdk[row * L::LO + d] * scale);
      dv[at] = from_f<T>(sdv[row * L::LO + d]);
    }
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv,
              int causal, int window, float softcap, int q_offset, float scale) {
  using L = Bwd<T, D, BQ, BK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Carve cv{smem_raw};
  T* sk = cv.take<T>(L::kv);
  T* sv = cv.take<T>(L::kv);
  T* sq = cv.take<T>(L::qd);
  T* sdo = cv.take<T>(L::qd);
  float* sS = cv.take<float>(L::s);
  float* sdP = cv.take<float>(L::s);
  T* sdS = kIsBf16<T> ? cv.take<T>(L::p) : reinterpret_cast<T*>(sdP);
  float* slse = cv.take<float>(L::rows);
  float* sdelta = cv.take<float>(L::rows);
  float* sdq = cv.take<float>(L::qacc);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int q_valid = min(BQ, Sq - q0);
  const long q_off = ((long)b * Sq + q0) * Hq * D + (long)h * D;
  load_rows<T, D, L::LQ>(sq, q + q_off, (long)Hq * D, BQ, q_valid);
  load_rows<T, D, L::LQ>(sdo, dout + q_off, (long)Hq * D, BQ, q_valid);
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
    load_rows<T, D, L::LQ>(sk, k + kv_off, kv_stride, BK, k_valid);
    load_rows<T, D, L::LQ>(sv, v + kv_off, kv_stride, BK, k_valid);
    __syncthreads();
    block_mma<T, BQ, BK, D, false, true>(sS, L::LS, sq, L::LQ, sk, L::LQ, false);    // Q K^T
    block_mma<T, BQ, BK, D, false, true>(sdP, L::LS, sdo, L::LQ, sv, L::LQ, false);  // dO V^T
    __syncthreads();
    auto mask = [=](int r, int c) {
      const int qp = qp0 + r;
      const int kp = k_lo + c;
      bool ok = r < q_valid && c < k_valid;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      return ok;
    };
    probs_and_dscores<T, BQ, BK, L::LS, L::LP>(sS, sdP, slse, sdelta, static_cast<T*>(nullptr),
                                                sdS, scale, softcap, mask);
    __syncthreads();
    block_mma<T, BQ, D, BK, false, false>(sdq, L::LO, sdS, L::LP, sk, L::LQ, true);  // += dS K
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int row = i / D;
    const int d = i % D;
    if (row < q_valid) dq[q_off + (long)row * Hq * D + d] = from_f<T>(sdq[row * L::LO + d] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int Hq, int Hkv, int causal, int window, float softcap, int q_offset,
                   float scale, cudaStream_t stream) {
  constexpr int BQ = 64;
  constexpr int BK = kIsBf16<T> ? 64 : 32;
  using L = Bwd<T, D, BQ, BK>;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fdelta = static_cast<float*>(delta);

  auto dkdv = dkdv_kernel<T, D, BQ, BK>;
  auto dqk = dq_kernel<T, D, BQ, BK>;
  cudaError_t err = prepare(dkdv, L::dkdv_bytes);
  if (err == cudaSuccess) err = prepare(dqk, L::dq_bytes);
  if (err != cudaSuccess) return err;

  const long rows = (long)B * Sq * Hq;
  delta_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const T*>(o), tdo, fdelta, Sq, Hq, D, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((Sk + BK - 1) / BK, Hkv, B), kThreads, L::dkdv_bytes, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, Hq, Hkv,
      causal, window, softcap, q_offset, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((Sq + BQ - 1) / BQ, Hq, B), kThreads, L::dq_bytes, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dq), Sq, Sk, Hq, Hkv, causal, window,
      softcap, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int D, const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                   int B, int Sq, int Sk, int Hq, int Hkv, int causal, int window, float softcap,
                   int q_offset, float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal,
                           window, softcap, q_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal,
                           window, softcap, q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal,
                            window, softcap, q_offset, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, o, dout, dq (B,Sq,Hq,D); k, v, dk, dv (B,Sk,Hkv,D), all contiguous, of
// one type: dtype 0 = f32, 1 = bf16.  lse (B,Hq,Sq) f32 from the forward;
// delta (B,Hq,Sq) f32 scratch.  Returns the first failed launch's cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* delta, void* dq, void* dk,
                        void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, int dtype,
                        int causal, int window, float softcap, int q_offset, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0 || Sk == 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return by_dim<float>(D, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal,
                         window, softcap, q_offset, scale, s);
  if (dtype == 1)
    return by_dim<bf16>(D, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal,
                        window, softcap, q_offset, scale, s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
