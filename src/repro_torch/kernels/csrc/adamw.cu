// The AdamW update of one leaf in one pass, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package updates each leaf with jnp ops
// (src/repro/train/optimizer.py, apply_updates' upd) that XLA fuses into one
// loop over the leaf.  Eager PyTorch ran the same update as eleven tensor ops a
// leaf (scale, the two moments, the bias corrections, the root, the quotient,
// the decay and the step), each reading and writing a leaf-sized tensor: about
// 112 bytes moved an f32 element, and the host read the clip scale before the
// first of them.  This kernel is that fusion written by hand.
//
// Each element, in f32, JAX's upd term by term, each operation rounded on its
// own (the intrinsics keep the compiler from contracting a product and a sum
// into one FMA; the square root and the divisions are IEEE's):
//   gs = g * s                      s the clip scale, read from the card
//   m  = b1 * m + (1 - b1) * gs
//   v  = b2 * v + ((1 - b2) * gs) * gs
//   d  = (m / c1) / (sqrt(v / c2) + eps)
//   d  = d + wd * p                 leaves of ndim >= 2 (the caller passes wd 0
//                                   for the others)
//   p  = p - lr * d
// then p, m and v are stored in their own dtypes, rounded to nearest.  c1, c2
// and lr come from the host's step count; the clip scale is a 0-d f32 tensor
// on the card, so no host read waits for the gradient norm.
//
// Bound on the card: bytes, far below the ridge (17 operations an element
// against 28 bytes).  One pass reads p, g, m and v once and writes p, m and v
// once: 28 bytes an f32 element, 2.70 G elements in mamba2-2.7b, 76 GB, 22.6 ms
// at 3.35 TB/s.  The design is a pure stream:
//
// * Chunks of 8 values: 16-byte loads and stores, two a chunk for an f32
//   tensor and one for a bf16 one, with streaming cache hints (__ldcs,
//   __stcs: every byte is touched once, so nothing is worth keeping in L2).
//   A thread issues the loads of all four tensors of a chunk before it uses
//   any, so each thread keeps 4 to 8 independent 16-byte loads in flight.
// * One chunk a thread: as many blocks of 256 threads as the leaf has
//   chunks for (a grid-stride loop takes any beyond 2^31 - 1 blocks).
//   Measured on an H100 at mamba2-2.7b's in_proj (48.5 GB moved), this grid
//   streams at 3.05 TB/s, 91% of 3.35; a persistent grid of the blocks the
//   card holds at once, each walking the leaf, at 2.85-2.91 TB/s: blocks
//   that retire and are replaced keep more loads in flight than threads
//   that wait on their own stores before their next loads.
// * A leaf whose address or size is not a multiple of a chunk: the host finds
//   the first element at which all four tensors are 16-byte aligned (fewer
//   than 8 in), the elements before it and after the last whole chunk go
//   element by element; where no such element exists, every element does.
//
// Supported: p, g and the moments (m and v in one dtype) each f32 or bf16;
// contiguous tensors of up to 2^63 elements (the wrapper,
// repro_torch/kernels/adamw_update/ops.py, checks shapes and types and
// rejects anything else).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kVec = 8;         // values of a chunk
constexpr int kThreads = 256;   // threads of a block
constexpr int kAlign = 16;      // bytes of a vector load

struct Hyper {
  float b1, omb1, b2, omb2, eps, c1, c2, lr, wd;
};

// --- one element ----------------------------------------------------------
__device__ __forceinline__ void update(float& p, float g, float& m, float& v, float s,
                                       const Hyper& h) {
  const float gs = __fmul_rn(g, s);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, gs));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, gs), gs));
  float d = __fdiv_rn(__fdiv_rn(m, h.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps));
  if (h.wd != 0.f) d = __fadd_rn(d, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, d));
}

// --- scalar loads and stores ----------------------------------------------
__device__ __forceinline__ float load1(const float* x) { return *x; }
__device__ __forceinline__ float load1(const bf16* x) { return __bfloat162float(*x); }
__device__ __forceinline__ void store1(float* x, float y) { *x = y; }
__device__ __forceinline__ void store1(bf16* x, float y) { *x = __float2bfloat16_rn(y); }

// --- a chunk of 8 values: two float4 of f32, one uint4 of bf16 --------------
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  float4 a, b;
};
template <>
struct Raw<bf16> {
  uint4 a;
};

__device__ __forceinline__ Raw<float> load8(const float* x) {
  const float4* q = reinterpret_cast<const float4*>(x);
  return {__ldcs(q), __ldcs(q + 1)};
}
__device__ __forceinline__ Raw<bf16> load8(const bf16* x) {
  return {__ldcs(reinterpret_cast<const uint4*>(x))};
}

// a bf16 is the upper half of an f32: the widening is exact
__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void unpack(const Raw<float>& r, float (&o)[kVec]) {
  o[0] = r.a.x; o[1] = r.a.y; o[2] = r.a.z; o[3] = r.a.w;
  o[4] = r.b.x; o[5] = r.b.y; o[6] = r.b.z; o[7] = r.b.w;
}
__device__ __forceinline__ void unpack(const Raw<bf16>& r, float (&o)[kVec]) {
  o[0] = lo(r.a.x); o[1] = hi(r.a.x); o[2] = lo(r.a.y); o[3] = hi(r.a.y);
  o[4] = lo(r.a.z); o[5] = hi(r.a.z); o[6] = lo(r.a.w); o[7] = hi(r.a.w);
}

__device__ __forceinline__ void store8(float* x, const float (&o)[kVec]) {
  float4* q = reinterpret_cast<float4*>(x);
  __stcs(q, make_float4(o[0], o[1], o[2], o[3]));
  __stcs(q + 1, make_float4(o[4], o[5], o[6], o[7]));
}
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
}
__device__ __forceinline__ void store8(bf16* x, const float (&o)[kVec]) {
  __stcs(reinterpret_cast<uint4*>(x),
         make_uint4(pack(o[0], o[1]), pack(o[2], o[3]), pack(o[4], o[5]), pack(o[6], o[7])));
}

// The update over n elements: chunks of 8 from element `head` on (`chunks` of
// them), every other element one by one (the `head` before them and those
// from head + 8 * chunks to n).
template <typename P, typename G, typename S>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(P* __restrict__ p, const G* __restrict__ g, S* __restrict__ m,
                    S* __restrict__ v, const float* __restrict__ scale, long long n,
                    long long head, long long chunks, Hyper h) {
  const float s = *scale;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long c = first; c < chunks; c += stride) {
    const long long i = head + c * kVec;
    const Raw<P> rp = load8(p + i);
    const Raw<G> rg = load8(g + i);
    const Raw<S> rm = load8(m + i);
    const Raw<S> rv = load8(v + i);
    float fp[kVec], fg[kVec], fm[kVec], fv[kVec];
    unpack(rp, fp);
    unpack(rg, fg);
    unpack(rm, fm);
    unpack(rv, fv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) update(fp[k], fg[k], fm[k], fv[k], s, h);
    store8(p + i, fp);
    store8(m + i, fm);
    store8(v + i, fv);
  }
  const long long tail = head + chunks * kVec;
  const long long loose = head + (n - tail);
  for (long long j = first; j < loose; j += stride) {
    const long long i = j < head ? j : tail + (j - head);
    float fp = load1(p + i), fm = load1(m + i), fv = load1(v + i);
    update(fp, load1(g + i), fm, fv, s, h);
    store1(p + i, fp);
    store1(m + i, fm);
    store1(v + i, fv);
  }
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<P>, Tag<G>, Tag<S>) for the dtype codes (0 f32, 1 bf16)
template <typename F>
cudaError_t by_types(int pdt, int gdt, int sdt, F&& f) {
  auto one = [](int code, auto&& k) -> cudaError_t {
    if (code == 0) return k(Tag<float>{});
    if (code == 1) return k(Tag<bf16>{});
    return cudaErrorInvalidValue;
  };
  return one(pdt, [&](auto tp) {
    return one(gdt, [&](auto tg) { return one(sdt, [&](auto ts) { return f(tp, tg, ts); }); });
  });
}

// The first element, fewer than a chunk in, at which every tensor is 16-byte
// aligned; -1 where there is none.
long long aligned_head(const void* const* ptrs, const int* sizes, int count) {
  for (long long e = 0; e < kVec; ++e) {
    bool ok = true;
    for (int t = 0; t < count && ok; ++t) {
      ok = (reinterpret_cast<uintptr_t>(ptrs[t]) + e * sizes[t]) % kAlign == 0;
    }
    if (ok) return e;
  }
  return -1;
}

}  // namespace

extern "C" {

// One AdamW step of one leaf of n elements, in place: p (pdt), g (gdt), m and
// v (sdt) contiguous; scale a 0-d f32 on the card; omb1 = 1 - b1 and omb2 =
// 1 - b2 as the caller rounds them; wd 0 for a leaf that is not decayed.
int adamw_update(void* p, const void* g, void* m, void* v, const void* scale, long long n,
                 float b1, float omb1, float b2, float omb2, float eps, float c1, float c2,
                 float lr, float wd, int pdt, int gdt, int sdt, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h{b1, omb1, b2, omb2, eps, c1, c2, lr, wd};
  auto size = [](int code) { return code == 1 ? 2 : 4; };
  const void* ptrs[4] = {p, g, m, v};
  const int sizes[4] = {size(pdt), size(gdt), size(sdt), size(sdt)};
  long long head = aligned_head(ptrs, sizes, 4);
  long long chunks = 0;
  if (head < 0 || head >= n) {
    head = n;
  } else {
    chunks = (n - head) / kVec;
  }
  const long long loose = n - chunks * kVec;
  return by_types(pdt, gdt, sdt, [&](auto tp, auto tg, auto ts) {
    using P = typename decltype(tp)::type;
    using G = typename decltype(tg)::type;
    using S = typename decltype(ts)::type;
    const long long work = std::max(chunks, loose);
    const long long want = (work + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(std::max(1LL, std::min<long long>(want, INT_MAX)));
    adamw_update_kernel<P, G, S><<<blocks, kThreads, 0, st>>>(
        static_cast<P*>(p), static_cast<const G*>(g), static_cast<S*>(m), static_cast<S*>(v),
        static_cast<const float*>(scale), n, head, chunks, h);
    return cudaGetLastError();
  });
}

const char* adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
