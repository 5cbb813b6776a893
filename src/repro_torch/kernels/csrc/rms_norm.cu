// RMSNorm over the last dim, plain or gated by SiLU, forward and backward, for
// sm_90a.
//
// Replaces no TPU kernel.  The JAX package computes these norms in
// src/repro/models/layers.py (rms_norm, and mamba2_mixer's gated norm
// rms_norm(y * silu(z))) with jnp ops that XLA fuses into one pass over a row;
// the published Mamba-2 layer runs its gated norm as one kernel too
// (RMSNormGated).  Eager PyTorch ran each as a chain of elementwise and reduce
// kernels, each writing an f32 copy of the tensor: the gated form 11 kernels
// forward and 21 backward, the plain form 8 and 16.  This pair is that fusion
// written by hand.
//
// Forward, each row of D values: p = x (plain) or p = c(c(y) * c(silu(z)))
// (gated, c the rounding to z's dtype, as the models' y.to(z.dtype) * silu(z)
// rounds), then out = o(((p * r) * w)) with r = rsqrt(sum(p^2) * (1 / D) +
// eps), each product rounded in f32 as the plain version's ops round it, o the
// rounding to z's dtype (x's, plain); r is kept in f32 for the backward.
// Backward, all in f32 from the same inputs: dn = dout * w, dp = r dn -
// p r^3 sum(dn p) / D; plain dx = dp, gated dy = dp * c(silu(z)) and dz = dp *
// c(y) * silu'(z); per block partial sums of dw = sum dout * (p * r) over the
// rows it walks, which a second launch reduces over the blocks in a fixed
// order (no atomics: a run repeats bit for bit).
//
// Bound on the card: bytes.  At mamba2-2.7b's train shape (8192 rows) the
// gated forward reads y (f32, 5120 wide) and z (bf16) once and writes out
// (bf16): 336 MB, 0.100 ms at 3.35 TB/s; its backward reads y, z and dout and
// writes dy (f32) and dz (bf16): 588 MB, 0.176 ms; the plain block norm at
// width 2560 moves 84 MB forward and 126 MB backward.  The gated backward
// also computes an exp and two divisions an element (SiLU, its derivative),
// about as long on the cores as its bytes take: it needs many warps to hide
// its loads.  The design:
//
// * A row is split into chunks of 8 values (16 bytes of bf16), and the
//   threads of a row take chunks t, t + T, t + 2T, ... so a warp's access is
//   one contiguous piece: 16-byte loads and stores.  The forward holds p in
//   registers from the sum of squares to the write.  The backward starts
//   the loads of all its chunks (x, z, dout) before it uses any and holds
//   them from its pass over the row for sum(dn p) to its pass that writes
//   dx and dz, which computes the gate again rather than hold it; bf16 is
//   held packed, 8 values in 4 registers.  Where that is not lean (more than
//   2 chunks a thread, a gate held in f32), the second pass reads the row
//   again, from L1 or L2.  The dw partial sums live in shared memory, slot
//   j of thread t at [j][t]: no two threads of a warp share a bank and no
//   register holds them.
// * The threads per row T and the chunks per thread N follow from the width
//   and the dtypes (plan()): N the least of 1, 2, 4, 8 that keeps T at 256
//   or fewer; backward, 512 or fewer where it holds its 1 or 2 chunks lean
//   (max_threads()): more threads with fewer chunks each, since it holds
//   more a chunk.  So 128 (qk-norm) takes 16 threads a row and 8 rows a
//   block, 5120 160 threads of 4 chunks forward and, gated with bf16 z, 320
//   of 2 backward, 16384 256 of 8 both ways.  The gated form takes N up to
//   4: D at most 8192, every mixer's d_inner.  The sum of a row is a
//   butterfly of warp shuffles, then a sum over the row's warps in shared
//   memory, the same order on every thread.
// * y and z are read in place: each a (rows, D) view with its own row stride
//   (z is the mixer's in_proj output, 10576 wide at mamba2-2.7b), so no copy
//   precedes the kernel.  A stride, width or address that is not a multiple
//   of a chunk takes the element-wise route: scalar loads, masked at D.
// * The backward is a persistent grid: as many blocks as the card holds at
//   once, at most `parts` (the caller's scratch rows), each walking rows b,
//   b + grid, ...; its dw partials are (grid, D) f32, read once by the
//   reduction.
//
// Supported: plain x f32 or bf16; gated (y, z) f32 or bf16 with y in f32 or
// z's dtype; w f32 or bf16; D up to 16384 (8192 gated); any number of rows
// (the wrapper, repro_torch/kernels/rms_norm/ops.py, checks shapes and types
// and rejects anything else).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kVec = 8;             // values of a chunk
constexpr int kFwdThreads = 256;    // threads of a row, at most, forward
constexpr int kBwdThreads = 512;    // and backward, with 1 or 2 chunks a thread
constexpr int kChunks = 8;          // chunks a thread, at most
constexpr int kGatedChunks = 4;     // the gated form: D at most 8192
constexpr int kBlockThreads = 128;  // a block of narrow rows holds this many threads
constexpr int kMaxWidth = kFwdThreads * kChunks * kVec;  // 16384
constexpr int kMaxGatedWidth = kFwdThreads * kGatedChunks * kVec;  // 8192

// Threads of a row, at most, for N chunks a thread.  The backward holds a
// row's chunks in registers (x and dout, gated y, z and dout): where they
// are lean (the plain form, or bf16 z and dout held packed) and 1 or 2 a
// thread, it takes up to 512 threads of 128 registers; otherwise 256 of 255.
__host__ __device__ constexpr int max_threads(bool backward, int n, bool lean) {
  return backward && lean && n <= 2 ? kBwdThreads : kFwdThreads;
}

template <typename Z, bool Gated, bool Wide>
__host__ __device__ constexpr bool lean() {
  return !Gated || (Wide && sizeof(Z) == 2);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// The n (<= kVec) values of a chunk at p: 16-byte loads on the wide route
// (n is kVec there), element-wise ones masked at n otherwise; zero past n.
template <typename T, bool Wide>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p, int n, float (&v)[kVec]) {
  if constexpr (Wide) {
    constexpr int E = 16 / int(sizeof(T));  // values a 16-byte piece
#pragma unroll
    for (int c = 0; c < kVec / E; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < E; ++i) v[c * E + i] = to_f(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = i < n ? to_f(p[i]) : 0.0f;
  }
}

template <typename T, bool Wide>
__device__ __forceinline__ void store_chunk(T* __restrict__ p, int n, const float (&v)[kVec]) {
  if constexpr (Wide) {
    constexpr int E = 16 / int(sizeof(T));
#pragma unroll
    for (int c = 0; c < kVec / E; ++c) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int i = 0; i < E; ++i) e[i] = from_f<T>(v[c * E + i]);
      reinterpret_cast<uint4*>(p)[c] = u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (i < n) p[i] = from_f<T>(v[i]);
    }
  }
}

// A chunk's values held as loaded: bf16 on the wide route packed in one
// 16-byte piece (4 registers, not 8), anything else as f32 values.
template <typename T, bool Wide>
struct Held {
  float v[kVec];
  __device__ __forceinline__ void load(const T* __restrict__ p, int n) {
    load_chunk<T, Wide>(p, n, v);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = 0.0f;
  }
  __device__ __forceinline__ float operator[](int i) const { return v[i]; }
};

template <>
struct Held<bf16, true> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* __restrict__ p, int) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ float operator[](int i) const {
    return to_f(reinterpret_cast<const bf16*>(&u)[i]);
  }
};

// The scale's chunk at col, w in f32 or bf16 (wbf16).
template <bool Wide>
__device__ __forceinline__ void load_w(const void* __restrict__ w, int wbf16, int col, int n,
                                       float (&v)[kVec]) {
  if (wbf16) {
    load_chunk<bf16, Wide>(static_cast<const bf16*>(w) + col, n, v);
  } else {
    load_chunk<float, Wide>(static_cast<const float*>(w) + col, n, v);
  }
}

// The gated product p = c(c(y) * c(silu(z))) of one value, c the rounding to
// Z, with its factors a = c(y) and s = c(silu(z)), and sigmoid(z).
template <typename Z>
__device__ __forceinline__ float gated(float y, float z, float& a, float& s, float& sg) {
  const float e = expf(-z);
  a = round_to<Z>(y);
  s = round_to<Z>(z / (1.0f + e));  // silu as PyTorch's kernel computes it
  sg = 1.0f / (1.0f + e);
  return round_to<Z>(__fmul_rn(a, s));
}

// Chunk k of this thread's row: its first column, and how many of its values
// lie in the row (none for a row past the last).
__device__ __forceinline__ int chunk_col(int k) { return (threadIdx.x + k * blockDim.x) * kVec; }
__device__ __forceinline__ int chunk_len(bool valid, int col, int D) {
  return valid ? min(kVec, D - col) : 0;
}

// The sum of v over the row's threads (blockDim.x of them, row threadIdx.y),
// the same bits on each: a shuffle butterfly within the warp (or within the
// row's lanes, for rows narrower than a warp), then the row's warps in order
// through red (a float a warp of the block).
__device__ __forceinline__ float row_sum(float v, float* red) {
  const int tr = blockDim.x;
  const int width = tr < 32 ? tr : 32;
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (tr <= 32) return v;
  const int t = threadIdx.y * tr + threadIdx.x;
  const int wpr = tr >> 5;
  __syncthreads();  // every thread has read the last row's sums
  if ((t & 31) == 0) red[t >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < wpr; ++i) s += red[threadIdx.y * wpr + i];
  return s;
}

// out (rows, D) contiguous in Z, rstd (rows,) f32; x (rows, D) at row stride
// sx, z at sz (gated).  A block holds blockDim.y rows.
template <typename X, typename Z, bool Gated, int N, bool Wide>
__global__ void __launch_bounds__(kFwdThreads)
    rms_norm_fwd_kernel(const X* __restrict__ x, long long sx, const Z* __restrict__ z,
                        long long sz, const void* __restrict__ w, int wbf16,
                        Z* __restrict__ out, float* __restrict__ rstd, int rows, int D,
                        float eps) {
  __shared__ float red[kFwdThreads / 32];
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool valid = row < rows;
  float p[N][kVec];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int col = chunk_col(k), n = chunk_len(valid, col, D);
    if (n > 0) {
      load_chunk<X, Wide>(x + row * sx + col, n, p[k]);
      if constexpr (Gated) {
        float zv[kVec];
        load_chunk<Z, Wide>(z + row * sz + col, n, zv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          float a, s, sg;
          p[k][i] = gated<Z>(p[k][i], zv[i], a, s, sg);
        }
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) ss = __fadd_rn(ss, __fmul_rn(p[k][i], p[k][i]));
    }
  }
  const float r = rsqrtf(__fadd_rn(__fmul_rn(row_sum(ss, red), 1.0f / float(D)), eps));
  if (!valid) return;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int col = chunk_col(k), n = chunk_len(true, col, D);
    if (n > 0) {
      float wv[kVec], o[kVec];
      load_w<Wide>(w, wbf16, col, n, wv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) o[i] = __fmul_rn(__fmul_rn(p[k][i], r), wv[i]);
      store_chunk<Z, Wide>(out + row * D + col, n, o);
    }
  }
  if (threadIdx.x == 0) rstd[row] = r;
}

// dx (rows, D) contiguous in X, dz (rows, D) contiguous in Z (gated); dout
// (rows, D) contiguous in Z; part (gridDim.x, D) f32, this block's dw partial
// in row blockIdx.x; acc, the dynamic shared memory, rb x N x 8 x T floats.
template <typename X, typename Z, bool Gated, int N, bool Wide>
__global__ void __launch_bounds__(max_threads(true, N, lean<Z, Gated, Wide>()))
    rms_norm_bwd_kernel(const X* __restrict__ x, long long sx, const Z* __restrict__ z,
                        long long sz, const void* __restrict__ w, int wbf16,
                        const Z* __restrict__ dout, const float* __restrict__ rstd,
                        X* __restrict__ dx, Z* __restrict__ dz, float* __restrict__ part,
                        int rows, int D) {
  // chunk k of a row's x (gated: y), z and dout, zero past D
  struct In {
    Held<X, Wide> x;
    Held<Z, Wide> z, go;
    __device__ __forceinline__ void load(const X* __restrict__ x_, long long sx_,
                                         const Z* __restrict__ z_, long long sz_,
                                         const Z* __restrict__ g_, long long row, int k,
                                         bool valid, int D) {
      const int col = chunk_col(k), n = chunk_len(valid, col, D);
      if (n > 0) {
        x.load(x_ + row * sx_ + col, n);
        if constexpr (Gated) z.load(z_ + row * sz_ + col, n);
        go.load(g_ + row * D + col, n);
      } else {
        x.zero();
        z.zero();
        go.zero();
      }
    }
  };
  // hold a row's lean chunks in registers, 1 or 2 a thread; read the others
  // (wider rows, f32 or element-wise gates) again in the second pass, which
  // L1 or L2 serves
  constexpr bool kHold = N <= 2 && lean<Z, Gated, Wide>();
  __shared__ float red[kBwdThreads / 32];
  extern __shared__ float acc[];
  const int tr = blockDim.x, rb = blockDim.y;
  const float inv_d = 1.0f / float(D);
  float* mine = acc + threadIdx.y * (N * kVec * tr) + threadIdx.x;  // slot j at mine[j * tr]
#pragma unroll
  for (int j = 0; j < N * kVec; ++j) mine[j * tr] = 0.0f;
  for (long long g = blockIdx.x; g * rb < rows; g += gridDim.x) {
    const long long row = g * rb + threadIdx.y;
    const bool valid = row < rows;
    const float r = valid ? rstd[row] : 0.0f;
    // x (gated: y), z and dout of the thread's chunks, zero past D: loaded
    // all at once and held (N <= 2), or chunk by chunk in each pass
    In ins[kHold ? N : 1];
    if constexpr (kHold) {
#pragma unroll
      for (int k = 0; k < N; ++k) ins[k].load(x, sx, z, sz, dout, row, k, valid, D);
    }
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      In in;
      if constexpr (kHold) {
        in = ins[k];
      } else {
        in.load(x, sx, z, sz, dout, row, k, valid, D);
      }
      const int col = chunk_col(k), n = chunk_len(true, col, D);
      float wv[kVec] = {};
      if (n > 0) load_w<Wide>(w, wbf16, col, n, wv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float p = in.x[i];
        if constexpr (Gated) {
          float a, s, sg;
          p = gated<Z>(in.x[i], in.z[i], a, s, sg);
        }
        dot += (in.go[i] * wv[i]) * p;
        mine[(k * kVec + i) * tr] += in.go[i] * (p * r);
      }
    }
    const float c = r * r * r * row_sum(dot, red) * inv_d;
    if (!valid) continue;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int col = chunk_col(k), n = chunk_len(true, col, D);
      if (n > 0) {
        In in;
        if constexpr (kHold) {
          in = ins[k];
        } else {
          in.load(x, sx, z, sz, dout, row, k, true, D);  // again: from L1 or L2
        }
        float wv[kVec], d[kVec];
        load_w<Wide>(w, wbf16, col, n, wv);
        if constexpr (Gated) {  // the gate again from y and z: fewer registers held
          float e[kVec];
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            float a, s, sg;
            const float p = gated<Z>(in.x[i], in.z[i], a, s, sg);
            const float dp = r * (in.go[i] * wv[i]) - p * c;
            e[i] = dp * a * (sg * (1.0f + in.z[i] * (1.0f - sg)));  // silu'(z)
            d[i] = dp * s;
          }
          store_chunk<Z, Wide>(dz + row * D + col, n, e);
        } else {
#pragma unroll
          for (int i = 0; i < kVec; ++i) d[i] = r * (in.go[i] * wv[i]) - in.x[i] * c;
        }
        store_chunk<X, Wide>(dx + row * D + col, n, d);
      }
    }
  }
  // the block's dw partial: its rows' slots summed in row order
  __syncthreads();
  for (int e = threadIdx.y * tr + threadIdx.x; e < D; e += tr * rb) {
    const int ch = e / kVec, k = ch / tr;
    const float* slot = acc + (k * kVec + e % kVec) * tr + (ch - k * tr);
    float sum = 0.0f;
    for (int y = 0; y < rb; ++y) sum += slot[y * N * kVec * tr];
    part[(long long)blockIdx.x * D + e] = sum;
  }
}

// dw (D,) in W: the sum over the blocks of part (parts, D), in block order.
template <typename W>
__global__ void __launch_bounds__(256)
    rms_norm_bwd_reduce(const float* __restrict__ part, W* __restrict__ dw, int parts, int D) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= D) return;
  float s = 0.0f;
  for (int b = 0; b < parts; ++b) s += part[(long long)b * D + e];
  dw[e] = from_f<W>(s);
}

// Threads per row (T), chunks per thread (N) and rows per block of a width:
// N the least power of two that keeps T at max_threads() or fewer.
struct Plan {
  int n, tr, rb;
};

Plan plan(int D, bool backward, bool lean) {
  const int chunks = (D + kVec - 1) / kVec;
  int n = 1;
  while ((chunks + n - 1) / n > max_threads(backward, n, lean)) n *= 2;
  int tr = (chunks + n - 1) / n;
  if (tr > 32) {
    tr = (tr + 31) / 32 * 32;
  } else {
    int t = 1;
    while (t < tr) t *= 2;
    tr = t;
  }
  const int rb = tr < kBlockThreads && kBlockThreads % tr == 0 ? kBlockThreads / tr : 1;
  return {n, tr, rb};
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<X>, Tag<Z>, gated) for the dtype codes (0 f32, 1 bf16): plain x in
// either; gated y in f32 or z's dtype.
template <typename F>
cudaError_t by_types(int gated, int xdt, int zdt, F&& f) {
  if (!gated) {
    if (xdt == 0) return f(Tag<float>{}, Tag<float>{}, std::false_type{});
    if (xdt == 1) return f(Tag<bf16>{}, Tag<bf16>{}, std::false_type{});
  } else {
    if (xdt == 0 && zdt == 0) return f(Tag<float>{}, Tag<float>{}, std::true_type{});
    if (xdt == 0 && zdt == 1) return f(Tag<float>{}, Tag<bf16>{}, std::true_type{});
    if (xdt == 1 && zdt == 1) return f(Tag<bf16>{}, Tag<bf16>{}, std::true_type{});
  }
  return cudaErrorInvalidValue;
}

// f(std::integral_constant<int, N>, wide) for N in 1, 2, 4, ... up to Max
template <int Max, typename F>
cudaError_t by_chunks(int n, bool wide, F&& f) {
  auto go = [&](auto nc) { return wide ? f(nc, std::true_type{}) : f(nc, std::false_type{}); };
  if (n == 1) return go(std::integral_constant<int, 1>{});
  if constexpr (Max >= 2) {
    if (n == 2) return go(std::integral_constant<int, 2>{});
  }
  if constexpr (Max >= 4) {
    if (n == 4) return go(std::integral_constant<int, 4>{});
  }
  if constexpr (Max >= 8) {
    if (n == 8) return go(std::integral_constant<int, 8>{});
  }
  return cudaErrorInvalidValue;
}

bool aligned(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// x: (rows, D) at row stride sx (unit column stride); z the gate at row
// stride sz, or null (plain); w (D,) contiguous; out (rows, D) contiguous in
// z's dtype (x's, plain); rstd (rows,) f32.  dtype codes: 0 f32, 1 bf16.
// Returns the launch's cudaError_t.
int rms_norm_fwd(const void* x, long long sx, const void* z, long long sz, const void* w,
                 void* out, void* rstd, int rows, int D, float eps, int xdt, int zdt, int wdt,
                 void* stream) {
  const bool gated = z != nullptr;
  if (rows < 0 || D < 1 || D > (gated ? kMaxGatedWidth : kMaxWidth)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan pl = plan(D, false, true);
  const bool wide = D % kVec == 0 && sx % kVec == 0 && (!gated || sz % kVec == 0) &&
                    aligned(x) && aligned(z) && aligned(w) && aligned(out);
  const dim3 threads(pl.tr, pl.rb), grid((rows + pl.rb - 1) / pl.rb);
  return by_types(gated, xdt, zdt, [&](auto tx, auto tz, auto g) {
    using X = typename decltype(tx)::type;
    using Z = typename decltype(tz)::type;
    constexpr bool G = decltype(g)::value;
    return by_chunks<G ? kGatedChunks : kChunks>(pl.n, wide, [&](auto nc, auto wc) {
      rms_norm_fwd_kernel<X, Z, G, decltype(nc)::value, decltype(wc)::value>
          <<<grid, threads, 0, s>>>(static_cast<const X*>(x), sx, static_cast<const Z*>(z), sz,
                                    w, wdt, static_cast<Z*>(out), static_cast<float*>(rstd),
                                    rows, D, eps);
      return cudaGetLastError();
    });
  });
}

// The backward: dout (rows, D) contiguous in z's dtype (x's, plain), rstd the
// forward's; dx (rows, D) contiguous in x's dtype, dz (rows, D) contiguous in
// z's (gated; null plain), dw (D,) in w's dtype; part the f32 scratch of
// parts x D partials (parts >= 1 when rows >= 1).  Two launches: as many
// blocks as fit on the card at once, at most `parts`, walk the rows; then
// their partials are summed in order.
int rms_norm_bwd(const void* x, long long sx, const void* z, long long sz, const void* w,
                 const void* dout, const void* rstd, void* dx, void* dz, void* dw, void* part,
                 int parts, int rows, int D, int xdt, int zdt, int wdt, void* stream) {
  const bool gated = z != nullptr;
  if (rows < 0 || parts < 0 || (rows > 0 && parts < 1) || D < 1 ||
      D > (gated ? kMaxGatedWidth : kMaxWidth))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = D % kVec == 0 && sx % kVec == 0 && (!gated || sz % kVec == 0) &&
                    aligned(x) && aligned(z) && aligned(w) && aligned(dout) && aligned(dx) &&
                    aligned(dz);
  const Plan pl = plan(D, true, !gated || (wide && zdt == 1));  // lean<Z, Gated, Wide>()
  int blocks = 0;
  if (rows > 0) {
    const cudaError_t err = by_types(gated, xdt, zdt, [&](auto tx, auto tz, auto g) {
      using X = typename decltype(tx)::type;
      using Z = typename decltype(tz)::type;
      constexpr bool G = decltype(g)::value;
      return by_chunks<G ? kGatedChunks : kChunks>(pl.n, wide, [&](auto nc, auto wc) {
        constexpr int N = decltype(nc)::value;
        auto kernel = rms_norm_bwd_kernel<X, Z, G, N, decltype(wc)::value>;
        const int threads = pl.tr * pl.rb;
        const int smem = pl.rb * N * kVec * pl.tr * int(sizeof(float));
        cudaError_t e = cudaSuccess;
        if (smem > 48 * 1024) {  // above the default only when asked for
          e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        }
        int device = 0, sms = 0, per_sm = 0;
        if (e == cudaSuccess) e = cudaGetDevice(&device);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                                         device);
        if (e == cudaSuccess) {
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
        }
        if (e != cudaSuccess) return e;
        const int groups = (rows + pl.rb - 1) / pl.rb;
        blocks = std::min(std::min(groups, parts), std::max(1, per_sm) * sms);
        kernel<<<blocks, dim3(pl.tr, pl.rb), smem, s>>>(
            static_cast<const X*>(x), sx, static_cast<const Z*>(z), sz, w, wdt,
            static_cast<const Z*>(dout), static_cast<const float*>(rstd), static_cast<X*>(dx),
            static_cast<Z*>(dz), static_cast<float*>(part), rows, D);
        return cudaGetLastError();
      });
    });
    if (err != cudaSuccess) return err;
  }
  const int rgrid = (D + 255) / 256;
  if (wdt == 1) {
    rms_norm_bwd_reduce<bf16><<<rgrid, 256, 0, s>>>(static_cast<const float*>(part),
                                                    static_cast<bf16*>(dw), blocks, D);
  } else {
    rms_norm_bwd_reduce<float><<<rgrid, 256, 0, s>>>(static_cast<const float*>(part),
                                                     static_cast<float*>(dw), blocks, D);
  }
  return cudaGetLastError();
}

const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
