// Depthwise causal conv of width 4 + bias + SiLU over the (x, B, C) columns of
// the mamba2 mixer's in_proj output, forward and backward, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package computes this step in
// src/repro/models/layers.py::mamba2_mixer (_depthwise_causal_conv, then
// silu) with jnp ops that XLA fuses into one pass; the published Mamba-2 layer
// runs it as one kernel too (causal_conv1d with the SiLU fused).  Eager
// PyTorch runs the same loop over the 4 taps as a dozen kernels forward and
// some thirty backward, each writing an f32 (B, L, Ch) tensor: this pair is
// that fusion written by hand.
//
// Forward: pre[t] = bias + sum_k w[k] x[t - 3 + k] (x before t = 0 is zero),
// out[t] = silu(pre[t]), the taps summed in f32 in that order (each product
// and sum rounded once, as the plain version's ops round them), written to
// three contiguous outputs in promote(x, w): xs (B, L, di) and B and C (B, L,
// gn) each.  Backward: g[t] = dout[t] silu'(pre[t]) with pre recomputed from
// x, dx[s] = sum_k w[k] g[s + 3 - k] in f32 rounded once to x's type, and per
// block partial sums of dw[k] = sum g[t] x[t - 3 + k] and db = sum g[t] in f32,
// which a second launch reduces over the blocks in a fixed order (no atomics:
// a run repeats bit for bit).
//
// Bound on the card: bytes.  The forward reads x once and writes the three
// outputs once; the backward reads x and the three output gradients and
// writes dx (the weights' partials are (B * L / kBlockRows) x 5 x Ch floats,
// under 3% of that).  At mamba2-2.7b's train shape (B 4, L 2048, Ch 5376, bf16
// x, f32 w) that is 264 MB forward and 352 MB backward: 79 us and 105 us at
// 3.35 TB/s.  The design keeps wide loads in flight and nothing else in
// device memory:
//
// * x is read in place: a (B, L, Ch) view with a batch and a row stride (the
//   in_proj output's row), so no copy, pad or concatenation precedes it.
// * A thread takes V neighbouring channels (16 bytes of the widest stream:
//   x forward, the f32 gradients backward) over kRows time steps, with its
//   channels' 4 weights and bias in registers; a warp covers 32 x V channels
//   of one row, so each row's access is one contiguous piece.  The K - 1 = 3
//   rows before the strip are read again by the thread (zero before t = 0);
//   backward the 3 rows after it too (g is zero past L).
// * V drops to 1 where an address, a stride or a split width (di, gn) is not
//   a multiple of the vector: any layout runs, the aligned one at full width.
//
// Supported: x and w each f32 or bf16, any B, L >= 1, di and gn >= 1, K = 4
// only (the wrapper, repro_torch/kernels/causal_conv/ops.py, checks shapes and
// types and rejects anything else).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTaps = 4;
constexpr int kThreadsX = 32;  // threads of a block across channels (one warp)
constexpr int kThreadsY = 4;   // time strips of a block, one warp each
constexpr int kRows = 32;      // time steps of a strip
constexpr int kBlockRows = kThreadsY * kRows;  // repro_torch: kernel.BLOCK_ROWS
constexpr int kParts = kTaps + 1;  // dw[0..3], db: the partials of a block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// The access of V elements of T: 16-byte, 8-byte or element-wise pieces.
template <typename T, int V>
struct Piece {
  static constexpr int kBytes = V * int(sizeof(T));
  static constexpr int kWidth = kBytes % 16 == 0 ? 16 : kBytes % 8 == 0 ? 8 : int(sizeof(T));
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[V]) {
  constexpr int W = Piece<T, V>::kWidth;
  constexpr int E = W / int(sizeof(T));  // elements a piece
  if constexpr (W == 16 || W == 8) {
    using U = std::conditional_t<W == 16, uint4, uint2>;
#pragma unroll
    for (int c = 0; c < V / E; ++c) {
      const U u = reinterpret_cast<const U*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < E; ++i) v[c * E + i] = to_f(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[V]) {
  constexpr int W = Piece<T, V>::kWidth;
  constexpr int E = W / int(sizeof(T));
  if constexpr (W == 16 || W == 8) {
    using U = std::conditional_t<W == 16, uint4, uint2>;
#pragma unroll
    for (int c = 0; c < V / E; ++c) {
      U u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int i = 0; i < E; ++i) e[i] = from_f<T>(v[c * E + i]);
      reinterpret_cast<U*>(p)[c] = u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f<T>(v[i]);
  }
}

// The channels c0 .. c0 + V - 1 of the (x, B, C) columns: which of the three
// contiguous tensors they lie in, and their place there (V divides di and gn,
// so a thread's channels never straddle two of them).
template <typename T>
struct Split {
  T* base;
  int col;
  int width;
  __device__ Split(T* xs, T* bo, T* co, int c0, int di, int gn) {
    if (c0 < di) {
      base = xs, col = c0, width = di;
    } else if (c0 < di + gn) {
      base = bo, col = c0 - di, width = gn;
    } else {
      base = co, col = c0 - di - gn, width = gn;
    }
  }
  __device__ T* row(long long r) const { return base + r * width + col; }
};

// One thread's channels' weights and bias in f32.
template <typename W, int V>
struct Taps {
  float w[kTaps][V];
  float b[V];
  __device__ Taps(const W* __restrict__ wt, const W* __restrict__ bias, int c0, int Ch) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
#pragma unroll
      for (int k = 0; k < kTaps; ++k) w[k][i] = to_f(wt[k * Ch + c0 + i]);
      b[i] = to_f(bias[c0 + i]);
    }
  }
  // the pre-activation: ((((x0 w0) + x1 w1) + x2 w2) + x3 w3) + b, each
  // product and sum rounded (the plain version's order)
  __device__ __forceinline__ float pre(int i, float x0, float x1, float x2, float x3) const {
    float a = __fmul_rn(x0, w[0][i]);
    a = __fadd_rn(a, __fmul_rn(x1, w[1][i]));
    a = __fadd_rn(a, __fmul_rn(x2, w[2][i]));
    a = __fadd_rn(a, __fmul_rn(x3, w[3][i]));
    return __fadd_rn(a, b[i]);
  }
};

__device__ __forceinline__ float sigmoid(float u) { return 1.0f / (1.0f + expf(-u)); }

// silu as the plain version's kernel computes it: u / (1 + exp(-u))
__device__ __forceinline__ float silu(float u) { return u / (1.0f + expf(-u)); }

template <typename X, int V>
__device__ __forceinline__ void load_row(const X* __restrict__ xb, long long sr, int t,
                                         float (&v)[V]) {
  if (t >= 0) {
    load<X, V>(xb + t * sr, v);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.0f;
  }
}

template <typename X, typename W, typename O, int V>
__global__ void __launch_bounds__(kThreadsX* kThreadsY)
    causal_conv_fwd_kernel(const X* __restrict__ x, long long sb, long long sr,
                           const W* __restrict__ wt, const W* __restrict__ bias,
                           O* __restrict__ xs, O* __restrict__ bo, O* __restrict__ co, int L,
                           int di, int gn) {
  const int Ch = di + 2 * gn;
  const int c0 = (blockIdx.x * kThreadsX + threadIdx.x) * V;
  const int t0 = blockIdx.y * kBlockRows + threadIdx.y * kRows;
  if (c0 >= Ch || t0 >= L) return;
  const int b = blockIdx.z;
  const Taps<W, V> tp(wt, bias, c0, Ch);
  const X* xb = x + b * sb + c0;
  const Split<O> out(xs, bo, co, c0, di, gn);
  const long long r0 = (long long)b * L;

  float h0[V], h1[V], h2[V];  // x[t - 3], x[t - 2], x[t - 1]
  load_row<X, V>(xb, sr, t0 - 3, h0);
  load_row<X, V>(xb, sr, t0 - 2, h1);
  load_row<X, V>(xb, sr, t0 - 1, h2);
  const int rows = min(kRows, L - t0);
  // unrolled on the vector route only: the element-wise route's division
  // slow path, unrolled, spills
#pragma unroll (V > 1 ? 4 : 1)
  for (int j = 0; j < rows; ++j) {
    const int t = t0 + j;
    float cur[V], y[V];
    load<X, V>(xb + t * sr, cur);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float p = tp.pre(i, h0[i], h1[i], h2[i], cur[i]);
      y[i] = silu(p);
      h0[i] = h1[i], h1[i] = h2[i], h2[i] = cur[i];
    }
    store<O, V>(out.row(r0 + t), y);
  }
}

// dx, and the block's partial dw and db in part[(b, row block), 5, Ch].
template <typename X, typename W, typename O, int V>
__global__ void __launch_bounds__(kThreadsX* kThreadsY)
    causal_conv_bwd_kernel(const X* __restrict__ x, long long sb, long long sr,
                           const W* __restrict__ wt, const W* __restrict__ bias,
                           const O* __restrict__ dxs, const O* __restrict__ dbo,
                           const O* __restrict__ dco, X* __restrict__ dx,
                           float* __restrict__ part, int L, int di, int gn) {
  __shared__ float red[kThreadsY][kParts][kThreadsX * V];
  const int Ch = di + 2 * gn;
  const int c0 = (blockIdx.x * kThreadsX + threadIdx.x) * V;
  const int t0 = blockIdx.y * kBlockRows + threadIdx.y * kRows;
  const int b = blockIdx.z;
  float dw[kTaps][V], db[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    db[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) dw[k][i] = 0.0f;
  }
  if (c0 < Ch && t0 < L) {
    const Taps<W, V> tp(wt, bias, c0, Ch);
    const X* xb = x + b * sb + c0;
    const Split<const O> dout(dxs, dbo, dco, c0, di, gn);
    const long long r0 = (long long)b * L;
    X* dxb = dx + r0 * Ch + c0;
    float h0[V], h1[V], h2[V];  // x[t - 3], x[t - 2], x[t - 1]
    float g0[V], g1[V], g2[V];  // g[t - 3], g[t - 2], g[t - 1]
    load_row<X, V>(xb, sr, t0 - 3, h0);
    load_row<X, V>(xb, sr, t0 - 2, h1);
    load_row<X, V>(xb, sr, t0 - 1, h2);
#pragma unroll
    for (int i = 0; i < V; ++i) g0[i] = g1[i] = g2[i] = 0.0f;
    const int own = min(kRows, L - t0);  // the strip's rows: its dx, dw and db
    const int last = min(own + kTaps - 1, L - t0);  // g needed up to t0 + own + 2
#pragma unroll 2
    for (int j = 0; j < last; ++j) {
      const int t = t0 + j;
      float cur[V], go[V], g[V], d[V];
      load<X, V>(xb + t * sr, cur);
      load<O, V>(dout.row(r0 + t), go);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float p = tp.pre(i, h0[i], h1[i], h2[i], cur[i]);
        const float s = sigmoid(p);
        g[i] = go[i] * (s * (1.0f + p * (1.0f - s)));
        if (j < own) {
          dw[0][i] += g[i] * h0[i];
          dw[1][i] += g[i] * h1[i];
          dw[2][i] += g[i] * h2[i];
          dw[3][i] += g[i] * cur[i];
          db[i] += g[i];
        }
        // dx[t - 3] = w0 g[t] + w1 g[t - 1] + w2 g[t - 2] + w3 g[t - 3]
        d[i] = tp.w[0][i] * g[i] + tp.w[1][i] * g2[i] + tp.w[2][i] * g1[i] +
               tp.w[3][i] * g0[i];
        h0[i] = h1[i], h1[i] = h2[i], h2[i] = cur[i];
        g0[i] = g1[i], g1[i] = g2[i], g2[i] = g[i];
      }
      if (j >= kTaps - 1) store<X, V>(dxb + (long long)(t - (kTaps - 1)) * Ch, d);
    }
    // steps t = t0 + j past L (the strip ends within 3 rows of L): g[t] is zero
    for (int j = last; j < own + kTaps - 1; ++j) {
      float d[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        d[i] = tp.w[1][i] * g2[i] + tp.w[2][i] * g1[i] + tp.w[3][i] * g0[i];
        g0[i] = g1[i], g1[i] = g2[i], g2[i] = 0.0f;
      }
      if (j >= kTaps - 1) store<X, V>(dxb + (long long)(t0 + j - (kTaps - 1)) * Ch, d);
    }
  }
  // the block's partials: its strips summed in strip order
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int k = 0; k < kTaps; ++k) red[threadIdx.y][k][threadIdx.x * V + i] = dw[k][i];
    red[threadIdx.y][kTaps][threadIdx.x * V + i] = db[i];
  }
  __syncthreads();
  const int cb = blockIdx.x * kThreadsX * V;  // the block's first channel
  const long long pb = ((long long)b * gridDim.y + blockIdx.y) * kParts;
  for (int e = threadIdx.y * kThreadsX + threadIdx.x; e < kParts * kThreadsX * V;
       e += kThreadsX * kThreadsY) {
    const int q = e / (kThreadsX * V);
    const int c = e - q * (kThreadsX * V);
    if (cb + c >= Ch) continue;
    float s = red[0][q][c];
#pragma unroll
    for (int y = 1; y < kThreadsY; ++y) s += red[y][q][c];
    part[(pb + q) * Ch + cb + c] = s;
  }
}

// dw (4, Ch) and db (Ch,) in w's type: each the sum over the row blocks of
// part (rows x 5 x Ch), in row order.
template <typename W>
__global__ void __launch_bounds__(256)
    causal_conv_bwd_reduce(const float* __restrict__ part, W* __restrict__ dw,
                           W* __restrict__ db, int rows, int Ch) {
  const int e = blockIdx.x * 256 + threadIdx.x;  // q * Ch + c
  if (e >= kParts * Ch) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += part[(long long)r * kParts * Ch + e];
  if (e < kTaps * Ch) {
    dw[e] = from_f<W>(s);
  } else {
    db[e - kTaps * Ch] = from_f<W>(s);
  }
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<X>, Tag<W>) for the dtype codes (0 f32, 1 bf16) of x and w.
template <typename F>
cudaError_t by_types(int xdt, int wdt, F&& f) {
  if (xdt == 0 && wdt == 0) return f(Tag<float>{}, Tag<float>{});
  if (xdt == 1 && wdt == 0) return f(Tag<bf16>{}, Tag<float>{});
  if (xdt == 0 && wdt == 1) return f(Tag<float>{}, Tag<bf16>{});
  if (xdt == 1 && wdt == 1) return f(Tag<bf16>{}, Tag<bf16>{});
  return cudaErrorInvalidValue;
}

template <typename X, typename W>
using Out = std::conditional_t<std::is_same_v<X, bf16> && std::is_same_v<W, bf16>, bf16, float>;

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % uintptr_t(bytes) == 0;
}

// Whether the V-wide route fits: V divides the split widths and the strides,
// and every pointer of T is aligned to a piece of V elements of its type.
template <typename T, int V>
bool fits(const void* p) {
  return aligned(p, Piece<T, V>::kWidth);
}

dim3 grid(int B, int L, int Ch, int V) {
  return dim3((Ch / V + kThreadsX - 1) / kThreadsX, (L + kBlockRows - 1) / kBlockRows, B);
}

}  // namespace

extern "C" {

// x: the (B, L, Ch) columns of the in_proj output, element (b, t, c) at
// x + b sb + t sr + c; w (4, Ch) and bias (Ch,) contiguous; xs (B, L, di), bo
// and co (B, L, gn) contiguous in promote(x, w).  Ch = di + 2 gn.  dtype
// codes: 0 f32, 1 bf16.  Returns the launch's cudaError_t.
int causal_conv_fwd(const void* x, long long sb, long long sr, const void* w, const void* bias,
                    void* xs, void* bo, void* co, int B, int L, int di, int gn, int xdt, int wdt,
                    void* stream) {
  if (B < 0 || L < 1 || di < 1 || gn < 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Ch = di + 2 * gn;
  return by_types(xdt, wdt, [&](auto tx, auto tw) {
    using X = typename decltype(tx)::type;
    using W = typename decltype(tw)::type;
    using O = Out<X, W>;
    constexpr int V = 16 / int(sizeof(X));
    const bool wide = di % V == 0 && gn % V == 0 && sb % V == 0 && sr % V == 0 &&
                      fits<X, V>(x) && fits<O, V>(xs) && fits<O, V>(bo) && fits<O, V>(co);
    if (wide) {
      causal_conv_fwd_kernel<X, W, O, V><<<grid(B, L, Ch, V), dim3(kThreadsX, kThreadsY), 0, s>>>(
          static_cast<const X*>(x), sb, sr, static_cast<const W*>(w),
          static_cast<const W*>(bias), static_cast<O*>(xs), static_cast<O*>(bo),
          static_cast<O*>(co), L, di, gn);
    } else {
      causal_conv_fwd_kernel<X, W, O, 1><<<grid(B, L, Ch, 1), dim3(kThreadsX, kThreadsY), 0, s>>>(
          static_cast<const X*>(x), sb, sr, static_cast<const W*>(w),
          static_cast<const W*>(bias), static_cast<O*>(xs), static_cast<O*>(bo),
          static_cast<O*>(co), L, di, gn);
    }
    return cudaGetLastError();
  });
}

// The backward: dxs (B, L, di), dbo and dco (B, L, gn) contiguous in
// promote(x, w), the gradients of the forward's outputs; dx (B, L, Ch)
// contiguous in x's type; dw (4, Ch) and db (Ch,) in w's type; part the f32
// scratch of B * ceil(L / 128) x 5 x Ch partials.  Two launches.
int causal_conv_bwd(const void* x, long long sb, long long sr, const void* w, const void* bias,
                    const void* dxs, const void* dbo, const void* dco, void* dx, void* dw,
                    void* db, void* part, int B, int L, int di, int gn, int xdt, int wdt,
                    void* stream) {
  if (B < 1 || L < 1 || di < 1 || gn < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Ch = di + 2 * gn;
  return by_types(xdt, wdt, [&](auto tx, auto tw) {
    using X = typename decltype(tx)::type;
    using W = typename decltype(tw)::type;
    using O = Out<X, W>;
    constexpr int V = 16 / int(sizeof(O));
    const bool wide = di % V == 0 && gn % V == 0 && sb % V == 0 && sr % V == 0 &&
                      fits<X, V>(x) && fits<X, V>(dx) && fits<O, V>(dxs) &&
                      fits<O, V>(dbo) && fits<O, V>(dco);
    const dim3 threads(kThreadsX, kThreadsY);
    const int v = wide ? V : 1;
    const dim3 g = grid(B, L, Ch, v);
    if (wide) {
      causal_conv_bwd_kernel<X, W, O, V><<<g, threads, 0, s>>>(
          static_cast<const X*>(x), sb, sr, static_cast<const W*>(w),
          static_cast<const W*>(bias), static_cast<const O*>(dxs), static_cast<const O*>(dbo),
          static_cast<const O*>(dco), static_cast<X*>(dx), static_cast<float*>(part), L, di, gn);
    } else {
      causal_conv_bwd_kernel<X, W, O, 1><<<g, threads, 0, s>>>(
          static_cast<const X*>(x), sb, sr, static_cast<const W*>(w),
          static_cast<const W*>(bias), static_cast<const O*>(dxs), static_cast<const O*>(dbo),
          static_cast<const O*>(dco), static_cast<X*>(dx), static_cast<float*>(part), L, di, gn);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int rows = B * int(g.y);
    causal_conv_bwd_reduce<W><<<(kParts * Ch + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(part), static_cast<W*>(dw), static_cast<W*>(db), rows, Ch);
    return cudaGetLastError();
  });
}

const char* causal_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
