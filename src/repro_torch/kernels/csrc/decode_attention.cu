// Split-K flash decoding (one new token per sequence against a deep KV
// cache) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py::
// _decode_kernel (pallas_call in decode_attention_fwd) and the jnp merge after
// it (kernel.py:156-161).
//
// Phase 1 (decode_partial_kernel): one thread block per (split, kv head,
// batch).  The block keeps the G grouped query rows of its kv head in shared
// memory (zero rows pad G to a multiple of 16) and streams its cache segment
// in 64-key tiles through the same online-softmax tile step as the flash
// kernel.  As in _decode_kernel, q is scaled by 1/sqrt(D) in f32 and rounded
// to the cache type before the dot, dots accumulate in f32, and keys at or
// past lengths[b], or at or before lengths[b] - 1 - window, are masked.  Tiles
// that hold no visible key are skipped, which leaves (m, l, acc) as the TPU
// kernel's masked pass would.  It writes the partial (acc, m, l) in f32.
// Phase 2 (decode_merge_kernel): one block per (q head, batch) rescales the
// partials by exp(m - max m) and divides by the summed l.
//
// Bound on the card: the K and V bytes of the visible cache, 2*B*S*Hkv*D*
// sizeof(T) at full length, against 3.35 TB/s of HBM on an H100 SXM.  This
// first version loads each tile with plain 16-byte loads and no overlap of
// load and compute.
//
// Supported: T in {f32, bf16}, D in {32, 64, 128}, G = Hq/Hkv <= 64.
#include "attn_tile.cuh"

using namespace attn;

namespace {

constexpr int kTile = 64;  // keys per shared-memory tile

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                          const T* __restrict__ vc, const int* __restrict__ lengths,
                          float* __restrict__ acc, float* __restrict__ m_out,
                          float* __restrict__ l_out, int S, int Hkv, int G, int seg, int window,
                          float scale) {
  using L = Layout<T, D, kTile>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rows = (G + 15) / 16 * 16;
  Smem<T, D, kTile> sm(smem_raw, rows);

  const int sp = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int ns = gridDim.x;
  const int warp = threadIdx.x >> 5;

  // q rows of this kv head: contiguous (G, D) at q[b, hk*G : hk*G+G, :]
  const T* qg = q + ((long)b * Hkv * G + (long)hk * G) * D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    sm.q[g * L::LQ + d] = from_f<T>(g < G ? to_f(qg[g * D + d]) * scale : 0.f);
  }
  sm.init(rows);

  const int length = lengths[b];
  const int seg_lo = sp * seg;
  const int hi = min(min(seg_lo + seg, S), length);  // keys at or past hi are masked
  const int lo = window > 0 ? max(seg_lo, length - window) : seg_lo;
  const long kv_stride = (long)Hkv * D;
  for (int k_lo = seg_lo + (lo > seg_lo ? (lo - seg_lo) / kTile * kTile : 0); k_lo < hi;
       k_lo += kTile) {
    __syncthreads();
    const long off = ((long)b * S + k_lo) * kv_stride + (long)hk * D;
    load_rows<T, D, L::LQ>(sm.k, kc + off, kv_stride, kTile, min(kTile, S - k_lo));
    load_rows<T, D, L::LQ>(sm.v, vc + off, kv_stride, kTile, min(kTile, S - k_lo));
    __syncthreads();
    auto mask = [=](int, int col) {
      const int kp = k_lo + col;
      return kp < hi && (window <= 0 || kp > length - 1 - window);
    };
    for (int rg = warp; rg < rows / 16; rg += kWarps)
      attend_rows<T, D, kTile>(sm, rg, 1.0f, 0.0f, mask);
  }
  __syncthreads();

  // partials laid out as the TPU kernel's: acc (B,Hkv,ns,G,D), m and l (B,Hkv,ns,G)
  const long base = ((long)b * Hkv + hk) * ns + sp;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    acc[(base * G + g) * D + d] = sm.o[g * L::LO + d];
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m_out[base * G + g] = sm.m[g];
    l_out[base * G + g] = sm.l[g];
  }
}

template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                                    const float* __restrict__ l, T* __restrict__ out, int Hkv,
                                    int G, int ns, int D) {
  const int hq = blockIdx.x;  // = hk * G + g
  const int b = blockIdx.y;
  const int hk = hq / G;
  const int g = hq % G;
  const long base = ((long)b * Hkv + hk) * ns;
  float mg = kNegInf;
  for (int s = 0; s < ns; ++s) mg = fmaxf(mg, m[(base + s) * G + g]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float lt = 0.f;
    float o = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float w = expf(m[(base + s) * G + g] - mg);
      lt += l[(base + s) * G + g] * w;
      o += acc[((base + s) * G + g) * D + d] * w;
    }
    out[((long)b * Hkv * G + hq) * D + d] = from_f<T>(o / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths, void* acc,
                   void* m, void* l, void* out, int B, int S, int Hq, int Hkv, int num_splits,
                   int seg, int window, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G > 64) return cudaErrorInvalidValue;
  auto kernel = decode_partial_kernel<T, D>;
  const size_t smem = Layout<T, D, kTile>::bytes((G + 15) / 16 * 16);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(num_splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), S, Hkv, G, seg, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<dim3(Hq, B), D, 0, stream>>>(
      static_cast<const float*>(acc), static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<T*>(out), Hkv, G, num_splits, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int D, const void* q, const void* k, const void* v, const void* lengths,
                   void* acc, void* m, void* l, void* out, int B, int S, int Hq, int Hkv,
                   int num_splits, int seg, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, acc, m, l, out, B, S, Hq, Hkv, num_splits, seg,
                           window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, lengths, acc, m, l, out, B, S, Hq, Hkv, num_splits, seg,
                           window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, lengths, acc, m, l, out, B, S, Hq, Hkv, num_splits, seg,
                            window, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B,Hq,D); k and v caches (B,S,Hkv,D); lengths (B,) int32; scratch acc
// (B,Hkv,num_splits,G,D), m and l (B,Hkv,num_splits,G) f32; out (B,Hq,D).
// All contiguous; q, caches and out of one type (dtype 0 = f32, 1 = bf16).
// Split s covers cache rows [s*seg, (s+1)*seg).  Returns the cudaError_t of
// the two launches.
int decode_attention_fwd(const void* q, const void* k, const void* v, const void* lengths,
                         void* acc, void* m, void* l, void* out, int B, int S, int Hq, int Hkv,
                         int D, int dtype, int num_splits, int seg, int window, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_dim<float>(D, q, k, v, lengths, acc, m, l, out, B, S, Hq, Hkv, num_splits, seg,
                         window, scale, s);
  if (dtype == 1)
    return by_dim<bf16>(D, q, k, v, lengths, acc, m, l, out, B, S, Hq, Hkv, num_splits, seg,
                        window, scale, s);
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
