// Fused MoE router (softmax, top-k, capacity slots) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/moe_router/kernel.py::
// _router_kernel (pallas_call in moe_router_fwd).  Per token, as there:
// softmax over the E experts, k rounds of (max, lowest-id argmax, mask the
// winner), gates renormalised over the k winners with max(sum, 1e-9).  Slots
// are assigned token-major over the flattened (T*k) choice list:
//
//   slot(t, j) = #{(t', j') before (t, j) in token-major order: id = id(t, j)}
//
// which is the gshard exclusive cumsum of models.layers.moe_ffn.
//
// The TPU kernel carries the per-expert counts from one token block to the
// next down its sequential grid.  Here the scan is split in two launches so
// that every token block runs at once, on its own SM:
//
//  1. route_blocks, one block of 32 warps per block of 32 tokens (kBlockT),
//     one warp per token.  Lane l holds experts l, l + 32, ... in registers
//     (2 at E = 64, 12 at E = 384), so no logits tile is staged.  The
//     arithmetic of a token is the first version's: m by fmaxf over the
//     lane's experts then the warp, expf(p - m), the lane's sum in ascending
//     e then the butterfly, p / s; each round takes the lane's strict > in
//     ascending e and, across lanes, the larger value or the lower id on a
//     tie, so ids are bit-equal to the plain version's on near-ties.  Then
//     warp 0 walks the block's 32 k choices 32 at a time in token-major
//     order: __match_any_sync groups the lanes that chose one expert, a
//     choice's slot within the block is the expert's running count plus the
//     lanes of its group below it.  The block writes those slots and its
//     count per expert, block_counts[b][e].
//  2. add_prefix, one block per token block b: base[e] = the sum over the
//     blocks b' < b of block_counts[b'][e] (partial sums over 8 strided sets
//     of b', then their sum), added to the slots of b's choices.  Integer
//     sums, exact in any order, and no atomics: two runs are bit-equal.
//     Its reads grow with the square of the token blocks (E nb^2 / 2 counts
//     from L2), which is why a block takes 32 tokens and not fewer.
//
// When T fits one token block (serving: T = the batch), launch 1 alone
// writes the final slots.
//
// Backward (route_bwd, the port's own kernel: the JAX package differentiates
// its jnp router in models/layers.py:267 through XLA).  Only the gates have
// a gradient.  The renormalised top-k of a softmax is a softmax over the k
// winning logits (the softmax's normaliser cancels), so
//
//   dlogits[t, ids[t, j]] = g_tj (dg_tj - sum_i g_ti dg_ti),  0 at every other expert.
//
// The max(sum, 1e-9) clamp of the forward never binds: the k winners'
// probabilities sum to at least k / E >= 1 / 384, so the gradient is that
// of the plain division.  One warp per token, 8 tokens a block: every lane
// forms the token's k values in the same order (bit-equal across lanes and
// runs) and writes experts lane, lane + 32, ... of the row, zeros included,
// so one launch writes the whole (T, E) gradient.  Bound: bytes, the (T,
// E) f32 write (1 MB at T = 4096, E = 64; 6.3 MB at E = 384).
//
// Bound on the card: bytes, T*E*4 read and 3*T*k*4 written (about 1.3 MB at
// T=4096, E=64, k=6, well under a microsecond at 3.35 TB/s on an H100 SXM),
// plus block_counts (ceil(T / 32) * E * 4, through L2).  The design spreads
// the tokens over every SM and keeps them in registers; launch and the k
// dependent rounds of shuffles per token are what remain.
//
// Supported: logits f32 (T, E), E <= 384, k <= min(E, 8).
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockT = kWarps;  // tokens per block, one a warp
constexpr int kMaxK = 8;
constexpr int kMaxE = 384;
constexpr int kParts = 8;  // add_prefix: strided partial sums over the earlier blocks
constexpr int kPrefixThreads = 256;

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

// NPL: experts a lane holds, E <= 32 NPL.
template <int NPL>
__global__ void __launch_bounds__(kThreads, 1)
    route_blocks(const float* __restrict__ logits, int* __restrict__ ids,
                 float* __restrict__ gates, int* __restrict__ slots,
                 int* __restrict__ block_counts, int T, int E, int k) {
  __shared__ int chosen[kBlockT * kMaxK];  // the block's choices, token-major
  __shared__ float won[kBlockT * kMaxK];   // their probabilities
  __shared__ int counts[kMaxE];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t0 = blockIdx.x * kBlockT;
  const int nt = min(kBlockT, T - t0);

  for (int e = tid; e < E; e += kThreads) counts[e] = 0;
  if (warp < nt) {
    const float* row = logits + (long)(t0 + warp) * E;
    float p[NPL];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int e = lane + 32 * i;
      p[i] = e < E ? row[e] : -INFINITY;
      if (e < E) m = fmaxf(m, p[i]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      if (lane + 32 * i < E) {
        const float ex = expf(p[i] - m);
        p[i] = ex;
        s += ex;
      }
    }
    s = warp_sum(s);
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      if (lane + 32 * i < E) p[i] = p[i] / s;

    float gsum = 0.f;
    for (int j = 0; j < k; ++j) {
      float best = -INFINITY;
      int bi = E;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {  // ascending e: strict > keeps the lowest id
        const int e = lane + 32 * i;
        if (e < E && p[i] > best) {
          best = p[i];
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
      if (lane == 0) {
        won[warp * k + j] = best;
        chosen[warp * k + j] = bi;
      }
      gsum += best;
#pragma unroll
      for (int i = 0; i < NPL; ++i)  // the owner masks the winner
        if (lane + 32 * i == bi) p[i] = -1.f;
    }
    __syncwarp();
    if (lane < k) {
      const float den = fmaxf(gsum, 1e-9f);
      const long at = (long)(t0 + warp) * k;
      ids[at + lane] = chosen[warp * k + lane];
      gates[at + lane] = won[warp * k + lane] / den;
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
  if (block_counts != nullptr) {
    __syncthreads();
    for (int e = tid; e < E; e += kThreads)
      block_counts[(long)blockIdx.x * E + e] = counts[e];
  }
}

// Adds to the slots of token block b the choices of every earlier block:
// base[e] = sum_{b' < b} block_counts[b'][e], from kParts partial sums over
// strided sets of b' (consecutive threads on consecutive e, so each read of
// a row of counts is coalesced), then their sum.
__global__ void __launch_bounds__(kPrefixThreads)
    add_prefix(const int* __restrict__ ids, int* __restrict__ slots,
               const int* __restrict__ block_counts, int T, int E, int k) {
  __shared__ int part[kParts][kMaxE];
  __shared__ int base[kMaxE];
  const int b = blockIdx.x;
  if (b == 0) return;  // block 0's slots are final
  const int tid = threadIdx.x;
  for (int i = tid; i < kParts * E; i += kPrefixThreads) {
    const int p = i / E;
    const int e = i - p * E;
    int s = 0;
    for (int bb = p; bb < b; bb += kParts) s += block_counts[(long)bb * E + e];
    part[p][e] = s;
  }
  __syncthreads();
  for (int e = tid; e < E; e += kPrefixThreads) {
    int s = 0;
#pragma unroll
    for (int p = 0; p < kParts; ++p) s += part[p][e];
    base[e] = s;
  }
  __syncthreads();
  const long at = (long)b * kBlockT * k;
  const int n = min(kBlockT, T - b * kBlockT) * k;
  for (int i = tid; i < n; i += kPrefixThreads) slots[at + i] += base[ids[at + i]];
}

constexpr int kBwdWarps = 8;

__global__ void __launch_bounds__(kBwdWarps * 32)
    route_bwd(const int* __restrict__ ids, const float* __restrict__ gates,
              const float* __restrict__ dgates, float* __restrict__ dlogits, int T, int E,
              int k) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kBwdWarps + (threadIdx.x >> 5);
  if (t >= T) return;
  const long at = (long)t * k;
  float g[kMaxK], dg[kMaxK];
  int id[kMaxK];
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      g[j] = gates[at + j];
      dg[j] = dgates[at + j];
      id[j] = ids[at + j];
      dot = fmaf(g[j], dg[j], dot);
    }
  }
  float* row = dlogits + (long)t * E;
  for (int e = lane; e < E; e += 32) {
    float out = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j < k && id[j] == e) out = g[j] * (dg[j] - dot);
    row[e] = out;
  }
}

template <int NPL>
cudaError_t launch(const float* logits, int* ids, float* gates, int* slots, int* block_counts,
                   int T, int E, int k, int nb, cudaStream_t stream) {
  route_blocks<NPL><<<nb, kThreads, 0, stream>>>(logits, ids, gates, slots,
                                                 nb > 1 ? block_counts : nullptr, T, E, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nb == 1) return err;
  add_prefix<<<nb, kPrefixThreads, 0, stream>>>(ids, slots, block_counts, T, E, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// logits (T,E) f32; ids and slots (T,k) int32; gates (T,k) f32; all
// contiguous.  block_counts is (ceil(T / 32), E) int32 scratch, unused (and
// may be null) when T <= 32.  Returns the cudaError_t of the first launch
// that failed.
int moe_router_fwd(const void* logits, void* ids, void* gates, void* slots, void* block_counts,
                   int T, int E, int k, void* stream) {
  if (T < 1 || E < 1 || E > kMaxE || k < 1 || k > kMaxK || k > E) return cudaErrorInvalidValue;
  const int nb = (T + kBlockT - 1) / kBlockT;
  if (nb > 1 && block_counts == nullptr) return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(logits);
  int* i = static_cast<int*>(ids);
  float* g = static_cast<float*>(gates);
  int* s = static_cast<int*>(slots);
  int* c = static_cast<int*>(block_counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int npl = (E + 31) / 32;
  if (npl <= 1) return launch<1>(l, i, g, s, c, T, E, k, nb, st);
  if (npl <= 2) return launch<2>(l, i, g, s, c, T, E, k, nb, st);
  if (npl <= 4) return launch<4>(l, i, g, s, c, T, E, k, nb, st);
  if (npl <= 8) return launch<8>(l, i, g, s, c, T, E, k, nb, st);
  return launch<12>(l, i, g, s, c, T, E, k, nb, st);
}

// ids (T,k) int32, gates and dgates (T,k) f32, dlogits (T,E) f32, all
// contiguous: the gradient of the logits for the gates' gradient dgates.
int moe_router_bwd(const void* ids, const void* gates, const void* dgates, void* dlogits, int T,
                   int E, int k, void* stream) {
  if (T < 1 || E < 1 || E > kMaxE || k < 1 || k > kMaxK || k > E) return cudaErrorInvalidValue;
  route_bwd<<<(T + kBwdWarps - 1) / kBwdWarps, kBwdWarps * 32, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(gates),
      static_cast<const float*>(dgates), static_cast<float*>(dlogits), T, E, k);
  return cudaGetLastError();
}

const char* moe_router_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
