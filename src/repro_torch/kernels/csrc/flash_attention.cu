// Blocked GQA flash attention (forward) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::_fa_kernel
// (pallas_call in flash_attention_fwd): the same function, not the same blocks.
// The TPU grid's sequential KV dimension becomes a loop inside a block.  Dots
// accumulate in f32 and the 1/sqrt(D) scale is applied after the dot, in f32,
// as in _fa_kernel; then the tanh softcap, then the masks.  KV tiles wholly
// above the causal diagonal or wholly outside the sliding window are never
// loaded.  Ragged Sq and Sk tails read zeros and are masked, with no padded
// copies in device memory.
//
// Bound on the card: 4*B*Hq*Sq*Sk*D FLOPs (Q.K^T and P.V), about halved by
// causal masking and cut further by a window, against 989 TFLOP/s of dense
// bf16 tensor-core math on an H100 SXM.
//
// bf16 route (Hopper: TMA, wgmma, warp specialisation; sm90.cuh).  One block
// of 384 threads per (128-query block, q head, batch), the blocks with the
// most keys first.  Warpgroup 0 is the producer: one thread loads the block's
// Q once and keeps tiles of BK keys (128, or 64) of K and V in flight through
// a ring of two TMA stages (Q 32 KB + 2 x 64 KB at D = 128 and BK = 128),
// with separate barriers for K and V so that Q K^T starts before V lands.
// Warpgroups 1 and 2 own 64 query rows each: S = Q K^T by wgmma from shared
// memory into registers, the online softmax in registers (quad shuffles for
// the row max and sum), O += P V by wgmma with P from registers and V
// MN-major.  O, m and l never touch shared memory.  Only tiles on the causal
// diagonal, the window's edge or the key tail are masked.  P is rounded to
// bf16 for its product, as in the first version; scores, m, l and O are f32.
// Consumers run at 240 registers and the producer at 24 (setmaxnreg).
//
// f32 route (the first version's, unchanged): one block of 4 warps per (q
// block, q head, batch), the online-softmax state (m, l, acc) in f32 shared
// memory, scalar FMAs in full f32 (the TPU kernel's f32 dots) through
// attn_tile.cuh's tile step.
//
// With a non-null `lse` the kernel also writes each row's log-sum-exp,
// m + log(l) of the online softmax in f32, (B, Hq, Sq): the backward kernel
// (flash_attention_bwd.cu) recomputes the probabilities from it.
//
// Supported: D in {32, 64, 128}, any Hq % Hkv == 0 (GQA, MQA, MHA);
// bf16 with (block_q, block_k) in {(128, 128), (128, 64)}; f32 with block_q
// in {64, 128} and block_k in {32, 64}, but not 128 x 64 at D = 128 (over
// the shared memory of a block).  The wrapper
// (repro_torch/kernels/flash_attention/ops.py) rejects anything else; a bf16
// tile that the kernel has no instantiation for returns an error.
#include "attn_tile.cuh"
#include "sm90.cuh"

using namespace attn;

namespace {

// ===========================================================================
// f32 route
// ===========================================================================
template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                  int Sq, int Sk, int Hq, int Hkv, int causal, int window, float softcap,
                  int q_offset, float scale) {
  using L = Layout<float, D, BK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<float, D, BK> sm(smem_raw, BQ);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;  // first row of this block, within Sq
  const int warp = threadIdx.x >> 5;

  load_rows<float, D, L::LQ>(sm.q, q + ((long)b * Sq + q0) * Hq * D + (long)h * D,
                             (long)Hq * D, BQ, min(BQ, Sq - q0));
  sm.init(BQ);

  // absolute positions and the KV blocks this q block can see
  const int q_lo = q_offset + q0;
  const int q_hi = q_lo + BQ - 1;
  int kb0 = 0;
  int kb1 = (Sk + BK - 1) / BK;
  if (window > 0) kb0 = max(0, q_lo - window + 1) / BK;
  if (causal) kb1 = min(kb1, q_hi < 0 ? 0 : q_hi / BK + 1);

  const long kv_stride = (long)Hkv * D;
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k_lo = kb * BK;
    __syncthreads();  // previous tile fully consumed
    const long off = ((long)b * Sk + k_lo) * kv_stride + (long)hk * D;
    load_rows<float, D, L::LQ>(sm.k, k + off, kv_stride, BK, min(BK, Sk - k_lo));
    load_rows<float, D, L::LQ>(sm.v, v + off, kv_stride, BK, min(BK, Sk - k_lo));
    __syncthreads();
    auto mask = [=](int row, int col) {
      const int qp = q_lo + row;
      const int kp = k_lo + col;
      bool ok = kp < Sk;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      return ok;
    };
    for (int rg = warp; rg < BQ / 16; rg += kWarps)
      attend_rows<float, D, BK>(sm, rg, scale, softcap, mask);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int row = i / D;
    const int d = i % D;
    if (q0 + row < Sq) {
      const float out = sm.o[row * L::LO + d] / fmaxf(sm.l[row], 1e-30f);
      o[(((long)b * Sq + q0 + row) * Hq + h) * D + d] = out;
    }
  }
  if (lse != nullptr) {
    for (int row = threadIdx.x; row < BQ && q0 + row < Sq; row += kThreads)
      lse[((long)b * Hq + h) * Sq + q0 + row] = sm.m[row] + logf(fmaxf(sm.l[row], 1e-30f));
  }
}

template <int D, int BQ, int BK>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int Hq, int Hkv, int causal, int window, float softcap,
                       int q_offset, float scale, cudaStream_t stream) {
  auto kernel = fa_fwd_kernel<D, BQ, BK>;
  const size_t smem = Layout<float, D, BK>::bytes(BQ);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Sq, Sk, Hq, Hkv, causal, window, softcap, q_offset, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t f32_by_blocks(int block_q, int block_k, const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                          int window, float softcap, int q_offset, float scale, cudaStream_t s) {
#define FA_CASE(BQ_, BK_)                                                                      \
  if (block_q == BQ_ && block_k == BK_)                                                        \
    return launch_f32<D, BQ_, BK_>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, window, softcap, \
                                   q_offset, scale, s);
  FA_CASE(64, 32)
  FA_CASE(64, 64)
  FA_CASE(128, 32)
  FA_CASE(128, 64)
#undef FA_CASE
  return cudaErrorInvalidValue;
}

// ===========================================================================
// bf16 route (sm_90a)
// ===========================================================================
namespace hopper {

using sm90::bf16;
constexpr int kThreads90 = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kStages = 2;
constexpr int kBQ = 128;  // query rows a block, 64 a consumer warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegBig = -1e30f;  // initial row max (log2 units): no inf - inf

template <int D, int BK>
struct FwdSmem {
  static constexpr int kQ = kBQ * D * 2;
  static constexpr int kKV = BK * D * 2;
  static constexpr int q_off = 0;
  static constexpr int k_off = kQ;                     // + stage * kKV
  static constexpr int v_off = k_off + kStages * kKV;  // + stage * kKV
  static constexpr int bar_off = v_off + kStages * kKV;
  static constexpr int bytes = bar_off + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

template <int D, int BK, bool kSoftcap>
__global__ void __launch_bounds__(kThreads90, 1)
    fwd_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
             float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal, int window,
             float softcap, int q_offset, float scale) {
  using L = FwdSmem<D, BK>;
  using P = sm90::Panel<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = sm90::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::bar_off);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first

  // absolute positions and the KV tiles this q block can see
  const int qp0 = q_offset + q0;
  const int q_hi = qp0 + kBQ - 1;
  int kb0 = 0;
  int kb1 = (Sk + BK - 1) / BK;
  if (window > 0) kb0 = max(0, qp0 - window + 1) / BK;
  if (causal) kb1 = min(kb1, q_hi < 0 ? 0 : q_hi / BK + 1);
  const int n_tiles = max(0, kb1 - kb0);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
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
      sm90::mbar_arrive_expect_tx(q_full, L::kQ);
      sm90::load_tile<D>(sm + L::q_off, &tm_q, q_full, kBQ, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const int k0 = (kb0 + it) * BK;
        sm90::mbar_arrive_expect_tx(&k_full[s], L::kKV);
        sm90::load_tile<D>(sm + L::k_off + s * L::kKV, &tm_k, &k_full[s], BK, hk, k0, b);
        sm90::mbar_arrive_expect_tx(&v_full[s], L::kKV);
        sm90::load_tile<D>(sm + L::v_off + s * L::kKV, &tm_v, &v_full[s], BK, hk, k0, b);
      }
    }
  } else {
    // consumers: warpgroup c owns query rows q0 + 64 c .. + 63
    sm90::setmaxnreg_inc_240();
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int r0 = 64 * c + 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
    const int kc0 = 2 * (lane % 4);                // and key columns kc0 + 8 j (+ 1)
    const int qp_lo = qp0 + 64 * c;
    const float scale2 = scale * kLog2e;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegBig, kNegBig};  // running row max of the scores, log2 units
    float l[2] = {0.f, 0.f};          // this thread's part of the running row sums

    sm90::mbar_wait(q_full, 0);
    const unsigned char* sQ = sm + L::q_off;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int parity = (it / kStages) & 1;
      sm90::mbar_wait(&k_full[s], parity);
      const unsigned char* sK = sm + L::k_off + s * L::kKV;
      float sc[BK / 2];  // S: 64 query rows x BK keys
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<BK>::template ss<0, 0>(sc, P::template kmajor<kBQ>(sQ, 64 * c, kk),
                                           P::template kmajor<BK>(sK, 0, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // scores in log2 units; masked ones -inf
      const int k_lo = (kb0 + it) * BK;
      const bool masked =
          sm90::needs_mask(qp_lo, qp_lo + 63, k_lo, k_lo + BK - 1, Sk, causal, window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x;
        if constexpr (kSoftcap) {
          x = softcap * tanhf(sc[i] * scale / softcap) * kLog2e;
        } else {
          x = sc[i] * scale2;
        }
        if (masked) {
          const int qp = qp0 + r0 + 8 * ((i >> 1) & 1);
          const int kp = k_lo + 8 * (i >> 2) + kc0 + (i & 1);
          x = sm90::visible(qp, kp, Sk, causal, window) ? x : -INFINITY;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float p = exp2f(sc[i] - m[r]);
        sc[i] = p;
        l[r] += p;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[BK / 16][4];  // A fragments of P, k-steps of 16 keys
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = sm90::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      sm90::mbar_wait(&v_full[s], parity);
      const unsigned char* sV = sm + L::v_off + s * L::kKV;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::Wgmma<D>::template rs<1>(acc, pa[kk], P::template mnmajor<BK>(sV, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::mbar_arrive(&empty[s]);
    }

    // the row sums over the quad, then O / l and lse = m + log(l)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const int row = q0 + r0 + 8 * r;
      const int col = 8 * (i >> 2) + kc0;
      if (row < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o + (((long)b * Sq + row) * Hq + h) * D + col) =
            __floats2bfloat162_rn(acc[i] / l[r], acc[i + 1] / l[r]);
    }
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + r0 + 8 * r;
        if (row < Sq) lse[((long)b * Hq + h) * Sq + row] = (m[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

template <int D, int BK, bool kSoftcap>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Sk, int Hq, int Hkv, int causal, int window, float softcap,
                   int q_offset, float scale, cudaStream_t stream) {
  using L = FwdSmem<D, BK>;
  constexpr int bd = sm90::Panel<D>::kBoxD;
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_bshd_map(&tq, q, B, Sq, Hq, D, bd, kBQ);
  if (err == cudaSuccess) err = sm90::make_bshd_map(&tk, k, B, Sk, Hkv, D, bd, BK);
  if (err == cudaSuccess) err = sm90::make_bshd_map(&tv, v, B, Sk, Hkv, D, bd, BK);
  if (err != cudaSuccess) return err;
  auto kernel = fwd_sm90<D, BK, kSoftcap>;
  err = prepare(kernel, L::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Sq + kBQ - 1) / kBQ, Hq, B), kThreads90, L::bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, Sq, Sk, Hq, Hkv, causal, window, softcap, q_offset,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bf16_by_blocks(int block_q, int block_k, const void* q, const void* k,
                           const void* v, void* o, float* lse, int B, int Sq, int Sk, int Hq,
                           int Hkv, int causal, int window, float softcap, int q_offset,
                           float scale, cudaStream_t s) {
  if (block_q != kBQ) return cudaErrorInvalidValue;
  const bool cap = softcap > 0.f;
  if (block_k == 128)
    return cap ? launch<D, 128, true>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, window,
                                      softcap, q_offset, scale, s)
               : launch<D, 128, false>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, window,
                                       softcap, q_offset, scale, s);
  if (block_k == 64)
    return cap ? launch<D, 64, true>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, window,
                                     softcap, q_offset, scale, s)
               : launch<D, 64, false>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, window,
                                      softcap, q_offset, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace hopper

}  // namespace

extern "C" {

// q (B,Sq,Hq,D), k and v (B,Sk,Hkv,D), o (B,Sq,Hq,D), all contiguous, of one
// type: dtype 0 = f32, 1 = bf16; lse (B,Hq,Sq) f32 or null.  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a tile, type or head dim
// that has no kernel).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                        int Sq, int Sk, int Hq, int Hkv, int D, int dtype, int causal, int window,
                        float softcap, int q_offset, int block_q, int block_k, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    switch (D) {
      case 32:
        return f32_by_blocks<32>(block_q, block_k, q, k, v, o, l, B, Sq, Sk, Hq, Hkv, causal,
                                 window, softcap, q_offset, scale, s);
      case 64:
        return f32_by_blocks<64>(block_q, block_k, q, k, v, o, l, B, Sq, Sk, Hq, Hkv, causal,
                                 window, softcap, q_offset, scale, s);
      case 128:
        return f32_by_blocks<128>(block_q, block_k, q, k, v, o, l, B, Sq, Sk, Hq, Hkv, causal,
                                  window, softcap, q_offset, scale, s);
    }
    return cudaErrorInvalidValue;
  }
  if (dtype == 1 && Sq > 0) {
    switch (D) {
      case 32:
        return hopper::bf16_by_blocks<32>(block_q, block_k, q, k, v, o, l, B, Sq, Sk, Hq,
                                          Hkv, causal, window, softcap, q_offset, scale, s);
      case 64:
        return hopper::bf16_by_blocks<64>(block_q, block_k, q, k, v, o, l, B, Sq, Sk, Hq,
                                          Hkv, causal, window, softcap, q_offset, scale, s);
      case 128:
        return hopper::bf16_by_blocks<128>(block_q, block_k, q, k, v, o, l, B, Sq, Sk, Hq,
                                          Hkv, causal, window, softcap, q_offset, scale, s);
    }
  }
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
