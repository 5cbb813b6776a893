// Fused MoE router (softmax, top-k, capacity slots) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/moe_router/kernel.py::
// _router_kernel (pallas_call in moe_router_fwd).  Per token, as there:
// softmax over the E experts, k rounds of (max, lowest-id argmax, mask the
// winner), gates renormalised over the k winners with max(sum, 1e-9).  Slots
// are assigned token-major over the flattened (T*k) choice list, with a
// per-expert count carried from one token block to the next:
//
//   slot(t, j) = #{(t', j') before (t, j) in token-major order: id = id(t, j)}
//
// which is the gshard exclusive cumsum of models.layers.moe_ffn.
//
// The count makes this a scan, so one thread block walks the token blocks
// of 64 tokens in order, with the counts in shared memory.  Per token block:
// the (64, E) logits tile is staged in shared memory; each warp owns whole
// tokens (softmax and the k rounds of argmax by warp shuffles; lane l owns
// experts l, l+32, ..., so a winner is masked by its owner without a sync);
// then warp 0 walks the block's 64*k choices 32 at a time in token-major
// order: __match_any_sync groups the lanes that chose one expert, a lane's
// slot is the expert's count plus the lanes of its group below it, and the
// group's highest lane writes the new count.  Tokens past T are never read
// and take no slot.
//
// Bound on the card: bytes, T*E*4 read and 3*T*k*4 written (about 1.3 MB at
// T=4096, E=64, k=6, well under a microsecond at 3.35 TB/s on an H100 SXM).
// One block on one SM runs the whole scan, so launch and latency dominate.
//
// Supported: logits f32 (T, E), E <= 384 (the (64, 384) f32 tile is 96 KB,
// above the default 48 KB, so the launch opts in), k <= min(E, 8).
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockT = 64;  // tokens per block of the scan
constexpr int kMaxK = 8;
constexpr int kMaxE = 384;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
    moe_router_kernel(const float* __restrict__ logits, int* __restrict__ ids,
                      float* __restrict__ gates, int* __restrict__ slots, int T, int E, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* probs = reinterpret_cast<float*>(smem_raw);  // (kBlockT, E)
  int* chosen = reinterpret_cast<int*>(probs + kBlockT * E);  // (kBlockT, k)
  int* counts = chosen + kBlockT * kMaxK;                      // (E,)
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int e = tid; e < E; e += kThreads) counts[e] = 0;
  for (int t0 = 0; t0 < T; t0 += kBlockT) {
    const int nt = min(kBlockT, T - t0);
    __syncthreads();  // the previous block's slot pass is done with chosen, counts
    for (int i = tid; i < nt * E; i += kThreads) probs[i] = logits[(long)t0 * E + i];
    __syncthreads();

    for (int r = warp; r < nt; r += kWarps) {
      float* p = probs + r * E;
      float m = -INFINITY;
      for (int e = lane; e < E; e += 32) m = fmaxf(m, p[e]);
      m = warp_max(m);
      float s = 0.f;
      for (int e = lane; e < E; e += 32) {
        const float ex = expf(p[e] - m);
        p[e] = ex;
        s += ex;
      }
      s = warp_sum(s);
      for (int e = lane; e < E; e += 32) p[e] = p[e] / s;

      float g[kMaxK];
      int id[kMaxK];
      float gsum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j >= k) break;
        float best = -INFINITY;
        int bi = E;
        for (int e = lane; e < E; e += 32) {  // ascending e: strict > keeps the lowest id
          const float v = p[e];
          if (v > best) {
            best = v;
            bi = e;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ov > best || (ov == best && oi < bi)) {
            best = ov;
            bi = oi;
          }
        }
        g[j] = best;
        id[j] = bi;
        gsum += best;
        if ((bi & 31) == lane) p[bi] = -1.f;  // the owner masks the winner
      }
      if (lane == 0) {
        const float den = fmaxf(gsum, 1e-9f);
        const long row = (long)(t0 + r) * k;
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
          if (j >= k) break;
          ids[row + j] = id[j];
          gates[row + j] = g[j] / den;
          chosen[r * k + j] = id[j];
        }
      }
    }
    __syncthreads();

    if (warp == 0) {
      const int n = nt * k;
      const unsigned below = (1u << lane) - 1u;
      for (int base = 0; base < n; base += 32) {
        const int i = base + lane;
        const bool act = i < n;
        const int e = act ? chosen[i] : -1;
        const unsigned same = __match_any_sync(0xffffffffu, e);
        const int slot = act ? counts[e] + __popc(same & below) : 0;
        __syncwarp();
        if (act) {
          slots[(long)t0 * k + i] = slot;
          if ((same >> lane) == 1u) counts[e] = slot + 1;  // highest lane of its group
        }
        __syncwarp();
      }
    }
  }
}

}  // namespace

extern "C" {

// logits (T,E) f32; ids and slots (T,k) int32; gates (T,k) f32.  All
// contiguous.  Returns the cudaError_t of the launch.
int moe_router_fwd(const void* logits, void* ids, void* gates, void* slots, int T, int E, int k,
                   void* stream) {
  if (T < 1 || E < 1 || E > kMaxE || k < 1 || k > kMaxK || k > E) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * size_t(kBlockT) * E + sizeof(int) * size_t(kBlockT) * kMaxK +
                      sizeof(int) * size_t(E);
  cudaError_t err = cudaFuncSetAttribute(moe_router_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  moe_router_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<int*>(ids), static_cast<float*>(gates),
      static_cast<int*>(slots), T, E, k);
  return cudaGetLastError();
}

const char* moe_router_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
