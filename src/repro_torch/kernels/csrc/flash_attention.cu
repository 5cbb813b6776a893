// Blocked GQA flash attention (forward) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::_fa_kernel
// (pallas_call in flash_attention_fwd): the same function, not the same blocks.
// One thread block per (q block, q head, batch); the TPU grid's sequential KV
// dimension becomes a loop inside the block, with the online-softmax state
// (m, l, acc) in f32 shared memory.  Dots accumulate in f32 and the 1/sqrt(D)
// scale is applied after the dot, in f32, as in _fa_kernel; then the tanh
// softcap, then the masks.  KV blocks wholly above the causal diagonal or
// wholly outside the sliding window are never loaded.  Ragged Sq and Sk tails
// are zero-filled in shared memory and masked, with no padded copies in
// device memory.
//
// Bound on the card: 4*B*Hq*Sq*Sk*D FLOPs (Q.K^T and P.V), about halved by
// causal masking and cut further by a window, against 989 TFLOP/s of dense
// bf16 tensor-core math on an H100 SXM.  This first version issues its bf16
// products through WMMA (mma.sync) from shared memory, with no TMA, no wgmma
// and no load/compute overlap, so it sits well below that bound.
//
// With a non-null `lse` the kernel also writes each row's log-sum-exp,
// m + log(l) of the online softmax in f32, (B, Hq, Sq): the backward kernel
// (flash_attention_bwd.cu) recomputes the probabilities from it.
//
// Supported: T in {f32, bf16}, D in {32, 64, 128}, block_q in {64, 128},
// block_k in {32, 64} (but not f32 with D=128 at 128x64: over the shared
// memory of a block, and prepare() refuses it), any Hq % Hkv == 0 (GQA, MQA,
// MHA).  The wrapper (repro_torch/kernels/flash_attention/ops.py) rejects
// anything else.
#include "attn_tile.cuh"

using namespace attn;

namespace {

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                  int causal, int window, float softcap, int q_offset, float scale) {
  using L = Layout<T, D, BK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T, D, BK> sm(smem_raw, BQ);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;  // first row of this block, within Sq
  const int warp = threadIdx.x >> 5;

  load_rows<T, D, L::LQ>(sm.q, q + ((long)b * Sq + q0) * Hq * D + (long)h * D, (long)Hq * D, BQ,
                         min(BQ, Sq - q0));
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
    load_rows<T, D, L::LQ>(sm.k, k + off, kv_stride, BK, min(BK, Sk - k_lo));
    load_rows<T, D, L::LQ>(sm.v, v + off, kv_stride, BK, min(BK, Sk - k_lo));
    __syncthreads();
    auto mask = [=](int row, int col) {
      const int qp = q_lo + row;
      const int kp = k_lo + col;
      bool ok = kp < Sk;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      return ok;
    };
    for (int rg = warp; rg < BQ / 16; rg += kWarps) attend_rows<T, D, BK>(sm, rg, scale, softcap, mask);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int row = i / D;
    const int d = i % D;
    if (q0 + row < Sq) {
      const float out = sm.o[row * L::LO + d] / fmaxf(sm.l[row], 1e-30f);
      o[(((long)b * Sq + q0 + row) * Hq + h) * D + d] = from_f<T>(out);
    }
  }
  if (lse != nullptr) {
    for (int row = threadIdx.x; row < BQ && q0 + row < Sq; row += kThreads)
      lse[((long)b * Hq + h) * Sq + q0 + row] = sm.m[row] + logf(fmaxf(sm.l[row], 1e-30f));
  }
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Sk,
                   int Hq, int Hkv, int causal, int window, float softcap, int q_offset,
                   float scale, cudaStream_t stream) {
  auto kernel = fa_fwd_kernel<T, D, BQ, BK>;
  const size_t smem = Layout<T, D, BK>::bytes(BQ);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Sk, Hq, Hkv, causal, window, softcap, q_offset, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_blocks(int block_q, int block_k, const void* q, const void* k, const void* v,
                      void* o, float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                      int window, float softcap, int q_offset, float scale, cudaStream_t s) {
#define FA_CASE(BQ_, BK_)                                                                   \
  if (block_q == BQ_ && block_k == BK_)                                                     \
    return launch<T, D, BQ_, BK_>(q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal, window, softcap, \
                                  q_offset, scale, s);
  FA_CASE(64, 32)
  FA_CASE(64, 64)
  FA_CASE(128, 32)
  FA_CASE(128, 64)
#undef FA_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(int D, int block_q, int block_k, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                   int window, float softcap, int q_offset, float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return by_blocks<T, 32>(block_q, block_k, q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal,
                              window, softcap, q_offset, scale, s);
    case 64:
      return by_blocks<T, 64>(block_q, block_k, q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal,
                              window, softcap, q_offset, scale, s);
    case 128:
      return by_blocks<T, 128>(block_q, block_k, q, k, v, o, lse, B, Sq, Sk, Hq, Hkv, causal,
                               window, softcap, q_offset, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B,Sq,Hq,D), k and v (B,Sk,Hkv,D), o (B,Sq,Hq,D), all contiguous, of one
// type: dtype 0 = f32, 1 = bf16; lse (B,Hq,Sq) f32 or null.  Returns the
// launch's cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                        int Sq, int Sk, int Hq, int Hkv, int D, int dtype, int causal, int window,
                        float softcap, int q_offset, int block_q, int block_k, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return by_dim<float>(D, block_q, block_k, q, k, v, o, l, B, Sq, Sk, Hq, Hkv, causal, window,
                         softcap, q_offset, scale, s);
  if (dtype == 1)
    return by_dim<bf16>(D, block_q, block_k, q, k, v, o, l, B, Sq, Sk, Hq, Hkv, causal, window,
                        softcap, q_offset, scale, s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
