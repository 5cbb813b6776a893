// Backward of the mamba2 SSD chunked scan for sm_90a, chunk-parallel.
//
// The port's own kernel: the JAX package has no backward kernel for the
// scan.  Its mixer (src/repro/models/layers.py:362) is plain jnp, which XLA
// differentiates; this is the gradient of ssd_scan.cu, which replaces
// src/repro/kernels/ssd_scan/kernel.py::_ssd_kernel.  Its plain version is
// ssd_scan/ref.py::ssd_scan_bwd_ref, whose docstring states the math.  Per
// (batch, head, chunk c of Q tokens) with cum_i = a s_i (s the in-chunk
// cumsum of dt), h_c the state entering the chunk, R_c the gradient of the
// state leaving it, G_ij = dy_i . x_j and L_ij = exp(cum_i - cum_j) (j <= i):
//
//   R_{c-1} = exp(cum_last) R_c + sum_i exp(cum_i) C_i dy_i^T   (R_last = dh_final)
//   dx_j  = dt_j sum_i (C_i . B_j) L_ij dy_i + exp(cum_last - cum_j) dt_j R_c^T B_j + D dy_j
//   dB_j  = dt_j sum_i G_ij L_ij C_i + exp(cum_last - cum_j) dt_j R_c x_j
//   dC_i  = sum_j G_ij L_ij dt_j B_j + exp(cum_i) h_c dy_i
//   ddt_j = sum_i G_ij L_ij (C_i . B_j) + exp(cum_last - cum_j) B_j . R_c x_j + a sum_{i>=j} dcum_i
//   da = sum_i dcum_i s_i,  dD = sum dy . x
//
// with dcum as ref.py states it.  The call runs, on one stream:
//
//   0. the forward's kernels 1-2 (ssd_scan.cu, entry ssd_scan_states) at this
//      kernel's chunk Q = min(64, L): the states h_c entering each chunk and
//      their log-decays.  They are recomputed, not saved by the forward: at
//      Q = 64 every operand of a chunk fits one block's shared memory in
//      f32 (below), and nothing of 168-335 MB a layer is held from the
//      forward to the backward.
//   1. ssd_bwd_chunk_state: per (chunk, head, batch), sum_i exp(cum_i) C_i
//      dy_i^T, stored transposed (P, N) in the R workspace.
//   2. ssd_bwd_state_pass: per (batch, head, p, n), the reverse scan over the
//      chunks, in place: the workspace then holds R_c of every chunk.
//   3. ssd_bwd_chunk: per (chunk, head, batch), every gradient of the chunk.
//      C, B, x, dy, h_c and R_c (f32 in shared memory, 206 KB at N = 128,
//      P = 64) give C.B^T and G on a 16 x 16 thread grid (each thread rows
//      ty + 16 r and columns tx + 16 s), then P = G o L and K = C.B^T o L in
//      shared memory, and from them dx, dB, dC and the terms of dcum.  Every
//      exponent is a difference <= 0, as in the forward: in mamba2's regime
//      the log-decay inside a chunk reaches the hundreds.  The in-chunk
//      cumsum, dcum and its reverse cumsum are f64 (dcum is a sum of terms of
//      both signs, and its cumsum is multiplied by a).  dB and dC are written
//      per head to f32 workspaces; da and dD per (batch, head, chunk) as f64
//      partials.
//   4. ssd_bwd_group_sum (dB, then dC): the sum over the heads of each group,
//      in head order, to x's type; ssd_bwd_head_sum: da and dD summed over
//      batches and chunks in order.
// No atomics: two runs are bit-equal.
//
// Products run on the CUDA cores in f32 (FMA), C.B^T and G over the whole
// Q x Q tile (the causal half is masked, not skipped).  Tensor cores, wgmma
// and TMA are later work.
//
// Bound on the card: operations.  Per chunk of q tokens and head: the causal
// q(q+1)/2 entries of C.B^T (2N each), of G (2P), of the products with W
// for dx (2P) and with G o L for dB and dC (2N each), and per token the
// state terms R^T B, R x, h dy and the backward chunk state (2NP each); the
// bytes (x, B, C, dy read, dx, dB, dC written, the states a few times) are
// well under that at f32's 67 TFLOP/s on an H100 SXM.
//
// Supported: T in {f32, bf16} for x, B, C, dy and dx, dB, dC; dt, a, D, ddt,
// da, dD and the states in f32; P in {32, 64}; N a multiple of 16 up to 128;
// Q <= 64.  Rows past Q in a chunk, and tokens past L, are zero with dt = 0.
#include <type_traits>

#include "warp_mma.cuh"

using namespace warp_mma;

namespace {

constexpr int kQ = 64;  // rows of a chunk in shared memory: Q <= kQ
constexpr int kThreads = 256;  // a 16 x 16 grid: ty = tid / 16, tx = tid % 16
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 128;
constexpr int kSN = kMaxN / 16;  // state columns a thread holds: n = tx + 16 s

struct Dims {
  int L, H, G, N, Q, nc;
};

// Rows r < kQ of a (B, L, X, cols) tensor at (b, t0 + r, xi) into dst[r *
// pitch + col] as f32; zero past Q or L.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* src, int b, int t0,
                                          int xi, int X, int cols, const Dims& d) {
  for (int i = threadIdx.x; i < kQ * cols; i += kThreads) {
    const int r = i / cols;
    const int col = i - r * cols;
    const int t = t0 + r;
    dst[r * pitch + col] =
        (r < d.Q && t < d.L) ? to_f(src[((long(b) * d.L + t) * X + xi) * cols + col]) : 0.f;
  }
}

__device__ __forceinline__ void load_dt(float* dts, const float* dt, int b, int t0, int h,
                                        const Dims& d) {
  for (int r = threadIdx.x; r < kQ; r += kThreads) {
    const int t = t0 + r;
    dts[r] = (r < d.Q && t < d.L) ? dt[(long(b) * d.L + t) * d.H + h] : 0.f;
  }
}

// s[i] = sum_{r <= i} dts[r] and cum[i] = a s[i] in f64, by one warp, two
// rows a lane.
__device__ __forceinline__ void warp_cumsum(const float* dts, double a, double* s,
                                            double* cum) {
  const int lane = threadIdx.x & 31;
  const double v0 = dts[2 * lane];
  const double v1 = v0 + dts[2 * lane + 1];
  double tot = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += n;
  }
  const double excl = tot - v1;
  s[2 * lane] = excl + v0;
  s[2 * lane + 1] = excl + v1;
  cum[2 * lane] = a * (excl + v0);
  cum[2 * lane + 1] = a * (excl + v1);
}

// The sum over the 16 lanes of a half warp (tx), the same in each.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v in a fixed order (warps, then their totals), in
// every thread.
__device__ __forceinline__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

// ---------------------------------------------------------------------------
// 1. backward chunk states
// ---------------------------------------------------------------------------
// rstate (B, H, nc, P, N) f32: sum_i exp(cum_i) dy_i[p] C_i[n] at [p][n].
template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk_state(
    const T* __restrict__ dy, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ Cm, float* __restrict__ rstate, Dims d) {
  constexpr int RP = P / 16;
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = h / (d.H / d.G);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int N = d.N;
  const int pN = N + 1;
  constexpr int pP = P + 1;
  const int t0 = c * d.Q;

  extern __shared__ __align__(16) unsigned char smem[];
  double* s = reinterpret_cast<double*>(smem);  // (kQ)
  double* cum = s + kQ;                         // (kQ)
  float* dts = reinterpret_cast<float*>(cum + kQ);
  float* cs = dts + kQ;       // [kQ][pN]: C rows
  float* dys = cs + kQ * pN;  // [kQ][pP]: dy rows, then scaled by exp(cum_i)

  load_dt(dts, dt, b, t0, h, d);
  load_rows(cs, pN, Cm, b, t0, grp, d.G, N, d);
  load_rows(dys, pP, dy, b, t0, h, d.H, P, d);
  __syncthreads();
  if (tid < 32) warp_cumsum(dts, a[h], s, cum);
  __syncthreads();
  for (int i = tid; i < kQ * P; i += kThreads) {
    const int r = i / P;
    dys[r * pP + i - r * P] *= expf(float(cum[r]));
  }
  __syncthreads();
  float acc[RP][kSN] = {};
  for (int i = 0; i < kQ; ++i) {
    float dv[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) dv[r] = dys[i * pP + ty + 16 * r];
#pragma unroll
    for (int sn = 0; sn < kSN; ++sn) {
      if (16 * sn < N) {
        const float cv = cs[i * pN + tx + 16 * sn];
#pragma unroll
        for (int r = 0; r < RP; ++r) acc[r][sn] = fmaf(dv[r], cv, acc[r][sn]);
      }
    }
  }
  float* out = rstate + ((long(b) * d.H + h) * d.nc + c) * P * N;
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int sn = 0; sn < kSN; ++sn)
      if (16 * sn < N) out[(ty + 16 * r) * N + tx + 16 * sn] = acc[r][sn];
}

// ---------------------------------------------------------------------------
// 2. reverse state pass
// ---------------------------------------------------------------------------
// Per (batch, head, e = p * N + n), from the last chunk back: R = dh_final
// (0 when dh is null); at chunk c the workspace's backward chunk state S is
// replaced by R_c, then R = exp(cum_last,c) R + S.  The loads of kAhead
// chunks go out before their first use, as in the forward's state pass.
__global__ void __launch_bounds__(256) ssd_bwd_state_pass(float* __restrict__ rstate,
                                                          const float* __restrict__ cq,
                                                          const float* __restrict__ dh, int nc,
                                                          int N, int PN) {
  constexpr int kAhead = 8;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const long bh = blockIdx.y;  // b * H + h
  if (e >= PN) return;
  float* st = rstate + bh * nc * PN + e;
  const float* lc = cq + bh * nc;
  const int p = e / N;
  const int n = e - p * N;
  float run = dh != nullptr ? dh[bh * PN + long(n) * (PN / N) + p] : 0.f;
  for (int c0 = nc - 1; c0 >= 0; c0 -= kAhead) {
    float sc[kAhead];
    float l[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 - k;
      sc[k] = c >= 0 ? st[long(c) * PN] : 0.f;
      l[k] = c >= 0 ? lc[c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 - k;
      if (c >= 0) {
        st[long(c) * PN] = run;
        run = fmaf(expf(l[k]), run, sc[k]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. chunk gradients
// ---------------------------------------------------------------------------
// x, dy (B,L,H,P), B and C (B,L,G,N) of type T; hp the KH pieces of the
// entering states (B, H, nc, KH, P, N) of type T; rstate R_c (B, H, nc, P,
// N) f32.  Writes dx (type T) and ddt (B,L,H) f32, the per-head dB_h and
// dC_h (B,L,H,N) f32 and the partials da_part, dD_part (B,H,nc) f64.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dv,
    const T* __restrict__ dy, const T* __restrict__ hp, const float* __restrict__ rstate,
    T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dB_h,
    float* __restrict__ dC_h, double* __restrict__ da_part, double* __restrict__ dD_part,
    Dims d) {
  constexpr int KH = std::is_same<T, float>::value ? 1 : 2;
  constexpr int RP = P / 16;
  constexpr int pP = P + 1;
  constexpr int pQ = kQ + 1;
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = h / (d.H / d.G);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int lane = tid & 31;
  const int N = d.N;
  const int pN = N + 1;  // odd pitches: 16 rows at one column hit 16 banks
  const int t0 = c * d.Q;
  const int PN = P * N;
  const long chunk_at = (long(b) * d.H + h) * d.nc + c;

  extern __shared__ __align__(16) unsigned char smem[];
  double* s = reinterpret_cast<double*>(smem);  // (kQ) in-chunk cumsum of dt
  double* cum = s + kQ;                         // (kQ) a s
  double* red = cum + kQ;                       // (kWarps) block sums
  float* dts = reinterpret_cast<float*>(red + kWarps);
  float* e_in = dts + kQ;    // exp(cum_i)
  float* e_out = e_in + kQ;  // exp(cum_last - cum_j)
  float* rowz = e_out + kQ;  // sum_j G_ij W_ij
  float* colz = rowz + kQ;   // sum_i G_ij W_ij
  float* vcol = colz + kQ;   // sum_i G_ij L_ij (C_i . B_j)
  float* u = vcol + kQ;      // C_i . h_c dy_i
  float* v = u + kQ;         // B_j . R_c x_j
  float* cs = v + kQ;        // [kQ][pN]: C rows
  float* bs = cs + kQ * pN;  // [kQ][pN]: B rows
  float* xs = bs + kQ * pN;  // [kQ][pP]: x rows
  float* dys = xs + kQ * pP;  // [kQ][pP]: dy rows
  float* hs = dys + kQ * pP;  // [P][pN]: h_c^T
  float* rs = hs + P * pN;    // [P][pN]: R_c^T
  float* pm = rs + P * pN;    // [kQ][pQ]: G o L
  float* km = pm + kQ * pQ;   // [kQ][pQ]: C.B^T o L
  float* colpart = km + kQ * pQ;  // [2][16][kQ]: column partials of each ty

  load_dt(dts, dt, b, t0, h, d);
  load_rows(cs, pN, Cm, b, t0, grp, d.G, N, d);
  load_rows(bs, pN, Bm, b, t0, grp, d.G, N, d);
  load_rows(xs, pP, x, b, t0, h, d.H, P, d);
  load_rows(dys, pP, dy, b, t0, h, d.H, P, d);
  {
    const T* hsrc = hp + chunk_at * KH * PN;
    const float* rsrc = rstate + chunk_at * PN;
    for (int e = tid; e < PN; e += kThreads) {
      const int p = e / N;
      const int n = e - p * N;
      float hv = 0.f;
#pragma unroll
      for (int k = 0; k < KH; ++k) hv += to_f(hsrc[k * PN + e]);
      hs[p * pN + n] = hv;
      rs[p * pN + n] = rsrc[e];
    }
  }
  __syncthreads();
  if (tid < 32) warp_cumsum(dts, a[h], s, cum);
  __syncthreads();
  if (tid < kQ) {
    e_in[tid] = expf(float(cum[tid]));
    e_out[tid] = expf(float(cum[kQ - 1] - cum[tid]));
  }

  // C.B^T and G at (i, j) = (ty + 16 r, tx + 16 s); then P, K, and the row
  // and column sums of Z = G o W and of G o L o C.B^T
  {
    float cb[4][4] = {};
    float gm[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * pN + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = bs[(tx + 16 * q) * pN + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) cb[r][q] = fmaf(cv[r], bv[q], cb[r][q]);
    }
    for (int p = 0; p < P; ++p) {
      float dv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = dys[(ty + 16 * r) * pP + p];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = xs[(tx + 16 * q) * pP + p];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) gm[r][q] = fmaf(dv[r], xv[q], gm[r][q]);
    }
    float zrow[4] = {}, zcol[4] = {}, vc[4] = {};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = tx + 16 * q;
        const float l = j <= i ? expf(float(cum[i] - cum[j])) : 0.f;
        const float pv = gm[r][q] * l;
        const float pc = pv * cb[r][q];
        const float z = pc * dts[j];
        pm[i * pQ + j] = pv;
        km[i * pQ + j] = cb[r][q] * l;
        zrow[r] += z;
        zcol[q] += z;
        vc[q] += pc;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float zr = sum16(zrow[r]);
      if (tx == 0) rowz[ty + 16 * r] = zr;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      colpart[ty * kQ + tx + 16 * q] = zcol[q];
      colpart[(16 + ty) * kQ + tx + 16 * q] = vc[q];
    }
  }
  __syncthreads();
  if (tid < kQ) {
    float z = 0.f, vv = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      z += colpart[k * kQ + tid];
      vv += colpart[(16 + k) * kQ + tid];
    }
    colz[tid] = z;
    vcol[tid] = vv;
  }

  // dx at (j, p) = (ty + 16 r, tx + 16 q)
  {
    float ai[4][RP] = {}, as[4][RP] = {};
    for (int i = 0; i < kQ; ++i) {
      float kv[4], dv[RP];
#pragma unroll
      for (int r = 0; r < 4; ++r) kv[r] = km[i * pQ + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < RP; ++q) dv[q] = dys[i * pP + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < RP; ++q) ai[r][q] = fmaf(kv[r], dv[q], ai[r][q]);
    }
    for (int n = 0; n < N; ++n) {
      float bv[4], rv[RP];
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = bs[(ty + 16 * r) * pN + n];
#pragma unroll
      for (int q = 0; q < RP; ++q) rv[q] = rs[(tx + 16 * q) * pN + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < RP; ++q) as[r][q] = fmaf(bv[r], rv[q], as[r][q]);
    }
    const float dh = Dv[h];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      const int t = t0 + j;
      if (j < d.Q && t < d.L) {
        const float wj = e_out[j] * dts[j];
        T* row = dx + ((long(b) * d.L + t) * d.H + h) * P;
#pragma unroll
        for (int q = 0; q < RP; ++q) {
          const int p = tx + 16 * q;
          row[p] = from_f<T>(dts[j] * ai[r][q] + wj * as[r][q] + dh * dys[j * pP + p]);
        }
      }
    }
  }

  // dB at (j, n) = (ty + 16 r, tx + 16 q), and v_j
  {
    float ai[4][kSN] = {}, as[4][kSN] = {};
    for (int i = 0; i < kQ; ++i) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = pm[i * pQ + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < kSN; ++q) {
        if (16 * q < N) {
          const float cv = cs[i * pN + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r) ai[r][q] = fmaf(pv[r], cv, ai[r][q]);
        }
      }
    }
    for (int p = 0; p < P; ++p) {
      float xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[(ty + 16 * r) * pP + p];
#pragma unroll
      for (int q = 0; q < kSN; ++q) {
        if (16 * q < N) {
          const float rv = rs[p * pN + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r) as[r][q] = fmaf(xv[r], rv, as[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      float vp = 0.f;
#pragma unroll
      for (int q = 0; q < kSN; ++q)
        if (16 * q < N) vp = fmaf(bs[j * pN + tx + 16 * q], as[r][q], vp);
      vp = sum16(vp);
      if (tx == 0) v[j] = vp;
      const int t = t0 + j;
      if (j < d.Q && t < d.L) {
        const float wj = e_out[j] * dts[j];
        float* row = dB_h + ((long(b) * d.L + t) * d.H + h) * N;
#pragma unroll
        for (int q = 0; q < kSN; ++q)
          if (16 * q < N) row[tx + 16 * q] = dts[j] * ai[r][q] + wj * as[r][q];
      }
    }
  }

  // dC at (i, n) = (ty + 16 r, tx + 16 q), and u_i
  {
    float ai[4][kSN] = {}, as[4][kSN] = {};
    for (int j = 0; j < kQ; ++j) {
      float pv[4];
      const float dtj = dts[j];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = pm[(ty + 16 * r) * pQ + j] * dtj;
#pragma unroll
      for (int q = 0; q < kSN; ++q) {
        if (16 * q < N) {
          const float bv = bs[j * pN + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r) ai[r][q] = fmaf(pv[r], bv, ai[r][q]);
        }
      }
    }
    for (int p = 0; p < P; ++p) {
      float dv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = dys[(ty + 16 * r) * pP + p];
#pragma unroll
      for (int q = 0; q < kSN; ++q) {
        if (16 * q < N) {
          const float hv = hs[p * pN + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r) as[r][q] = fmaf(dv[r], hv, as[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      float up = 0.f;
#pragma unroll
      for (int q = 0; q < kSN; ++q)
        if (16 * q < N) up = fmaf(cs[i * pN + tx + 16 * q], as[r][q], up);
      up = sum16(up);
      if (tx == 0) u[i] = up;
      const int t = t0 + i;
      if (i < d.Q && t < d.L) {
        float* row = dC_h + ((long(b) * d.L + t) * d.H + h) * N;
#pragma unroll
        for (int q = 0; q < kSN; ++q)
          if (16 * q < N) row[tx + 16 * q] = ai[r][q] + e_in[i] * as[r][q];
      }
    }
  }

  // <h_c, R_c> and sum dy . x over the chunk, then dcum, ddt and da by warp 0
  double hr = 0.0, dd = 0.0;
  for (int e = tid; e < PN; e += kThreads) {
    const int p = e / N;
    const int n = e - p * N;
    hr += double(hs[p * pN + n]) * double(rs[p * pN + n]);
  }
  for (int e = tid; e < kQ * P; e += kThreads) {
    const int i = e / P;
    const int p = e - i * P;
    dd += double(dys[i * pP + p]) * double(xs[i * pP + p]);
  }
  __syncthreads();  // u and v are written
  hr = block_sum(hr, red);
  dd = block_sum(dd, red);
  if (tid < 32) {
    double dc[2];
    double wv = 0.0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = 2 * lane + k;
      const double w = double(e_out[i]) * double(dts[i]) * double(v[i]);
      dc[k] = double(rowz[i]) - double(colz[i]) + double(e_in[i]) * double(u[i]) - w;
      wv += w;
    }
    wv = warp_sum(wv);
    if (lane == 31) dc[1] += exp(cum[kQ - 1]) * hr + wv;  // the chunk's last row
    // reverse inclusive cumsum: the pairs of the lanes above, then this pair
    const double pair = dc[0] + dc[1];
    double above = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double n = __shfl_down_sync(0xffffffffu, above, off);
      if (lane + off < 32) above += n;
    }
    above -= pair;
    const double rev[2] = {above + pair, above + dc[1]};
    const double ah = a[h];
    double da = 0.0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = 2 * lane + k;
      da += dc[k] * s[i];
      const int t = t0 + i;
      if (i < d.Q && t < d.L)
        ddt[(long(b) * d.L + t) * d.H + h] =
            float(double(vcol[i]) + double(e_out[i]) * double(v[i]) + ah * rev[k]);
    }
    da = warp_sum(da);
    if (lane == 0) {
      da_part[chunk_at] = da;
      dD_part[chunk_at] = dd;
    }
  }
}

// ---------------------------------------------------------------------------
// 4. reductions
// ---------------------------------------------------------------------------
// out (rows, G, N) of type T = the sum over the hpg heads of each group of
// ws (rows, G * hpg, N) f32, in head order.
template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_group_sum(const float* __restrict__ ws,
                                                         T* __restrict__ out, long rows, int G,
                                                         int hpg, int N) {
  const long e = long(blockIdx.x) * blockDim.x + threadIdx.x;
  const long GN = long(G) * N;
  if (e >= rows * GN) return;
  const long row = e / GN;
  const int gn = int(e - row * GN);
  const float* src = ws + (row * G * hpg + long(gn / N) * hpg) * N + gn % N;
  float acc = 0.f;
  for (int k = 0; k < hpg; ++k) acc += src[long(k) * N];
  out[e] = from_f<T>(acc);
}

// da[h] and dD[h]: the partials of every batch and chunk, summed in order.
__global__ void __launch_bounds__(128) ssd_bwd_head_sum(const double* __restrict__ da_part,
                                                        const double* __restrict__ dD_part,
                                                        float* __restrict__ da,
                                                        float* __restrict__ dD, int Bsz, int H,
                                                        int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  double sa = 0.0, sd = 0.0;
  for (int b = 0; b < Bsz; ++b) {
    const long at = (long(b) * H + h) * nc;
    for (int c = 0; c < nc; ++c) {
      sa += da_part[at + c];
      sd += dD_part[at + c];
    }
  }
  da[h] = float(sa);
  dD[h] = float(sd);
}

template <int P>
size_t state_smem(int N) {
  return 2 * kQ * sizeof(double) + (kQ + size_t(kQ) * (N + 1) + size_t(kQ) * (P + 1)) * 4;
}

template <int P>
size_t chunk_smem(int N) {
  const size_t floats = 8 * kQ + 2 * size_t(kQ) * (N + 1) + 2 * size_t(kQ) * (P + 1) +
                        2 * size_t(P) * (N + 1) + 2 * size_t(kQ) * (kQ + 1) + 2 * 16 * kQ;
  return (2 * kQ + kWarps) * sizeof(double) + floats * 4;
}

struct Args {
  const void *x, *dt, *a, *Bm, *Cm, *D, *dy, *dh, *hp, *cq;
  void *dx, *ddt, *da, *dB, *dC, *dD, *rstate, *dB_h, *dC_h, *da_part, *dD_part;
};

template <typename T, int P>
cudaError_t launch(const Args& g, int Bsz, int L, int H, int G, int N, int Q,
                   cudaStream_t stream) {
  static unsigned ready_state = 0, ready_chunk = 0;
  const int nc = (L + Q - 1) / Q;
  const Dims d{L, H, G, N, Q, nc};
  auto k1 = ssd_bwd_chunk_state<T, P>;
  auto k3 = ssd_bwd_chunk<T, P>;
  const size_t s1 = state_smem<P>(N);
  const size_t s3 = chunk_smem<P>(N);
  if (s1 > size_t(kMaxSmem) || s3 > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem_once(k1, kMaxSmem, ready_state);
  if (err == cudaSuccess) err = set_smem_once(k3, kMaxSmem, ready_chunk);
  if (err != cudaSuccess) return err;
  const T* x = static_cast<const T*>(g.x);
  const float* dt = static_cast<const float*>(g.dt);
  const float* a = static_cast<const float*>(g.a);
  const T* Cm = static_cast<const T*>(g.Cm);
  const T* dy = static_cast<const T*>(g.dy);
  float* rstate = static_cast<float*>(g.rstate);
  const dim3 grid(nc, H, Bsz);
  k1<<<grid, kThreads, s1, stream>>>(dy, dt, a, Cm, rstate, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int PN = P * N;
  ssd_bwd_state_pass<<<dim3((PN + 255) / 256, Bsz * H), 256, 0, stream>>>(
      rstate, static_cast<const float*>(g.cq), static_cast<const float*>(g.dh), nc, N, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k3<<<grid, kThreads, s3, stream>>>(
      x, dt, a, static_cast<const T*>(g.Bm), Cm, static_cast<const float*>(g.D), dy,
      static_cast<const T*>(g.hp), rstate, static_cast<T*>(g.dx), static_cast<float*>(g.ddt),
      static_cast<float*>(g.dB_h), static_cast<float*>(g.dC_h),
      static_cast<double*>(g.da_part), static_cast<double*>(g.dD_part), d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long rows = long(Bsz) * L;
  const unsigned blocks = unsigned((rows * G * N + 255) / 256);
  ssd_bwd_group_sum<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(g.dB_h),
                                                   static_cast<T*>(g.dB), rows, G, H / G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_group_sum<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(g.dC_h),
                                                   static_cast<T*>(g.dC), rows, G, H / G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_head_sum<<<(H + 127) / 128, 128, 0, stream>>>(
      static_cast<const double*>(g.da_part), static_cast<const double*>(g.dD_part),
      static_cast<float*>(g.da), static_cast<float*>(g.dD), Bsz, H, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dy, dx (B,L,H,P) of one type (dtype 0 = f32, 1 = bf16); dt, ddt (B,L,H)
// f32; a, D, da, dD (H,) f32; B, C, dB, dC (B,L,G,N) of x's type; dh (B,H,N,P)
// f32 or null (0).  hp (B,H,nc,K,P,N) of x's type and cq (B,H,nc) f32: the
// entering states and log-decays that ssd_scan_states wrote at chunk Q (<=
// min(L, 64)), nc = ceil(L / Q).  Workspace: rstate (B,H,nc,P,N) f32, dB_h
// and dC_h (B,L,H,N) f32, da_part and dD_part (B,H,nc) f64.  All contiguous.
// Runs the kernels on `stream`; returns the first cudaError_t.
int ssd_scan_bwd(const void* x, const void* dt, const void* a, const void* Bm, const void* Cm,
                 const void* D, const void* dy, const void* dh, const void* hp, const void* cq,
                 void* dx, void* ddt, void* da, void* dB, void* dC, void* dD, void* rstate,
                 void* dB_h, void* dC_h, void* da_part, void* dD_part, int Bsz, int L, int H,
                 int G, int P, int N, int Q, int dtype, void* stream) {
  if (G <= 0 || H % G || N % 16 || N < 16 || N > kMaxN || Q < 1 || Q > kQ || Q > L)
    return cudaErrorInvalidValue;
  const Args g{x, dt, a, Bm, Cm, D, dy, dh, hp, cq,
               dx, ddt, da, dB, dC, dD, rstate, dB_h, dC_h, da_part, dD_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && P == 32) return launch<float, 32>(g, Bsz, L, H, G, N, Q, s);
  if (dtype == 0 && P == 64) return launch<float, 64>(g, Bsz, L, H, G, N, Q, s);
  if (dtype == 1 && P == 32) return launch<bf16, 32>(g, Bsz, L, H, G, N, Q, s);
  if (dtype == 1 && P == 64) return launch<bf16, 64>(g, Bsz, L, H, G, N, Q, s);
  return cudaErrorInvalidValue;
}

const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
