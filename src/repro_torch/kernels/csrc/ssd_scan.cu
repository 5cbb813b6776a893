// Mamba2 SSD chunked scan for sm_90a, chunk-parallel.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::_ssd_kernel
// (pallas_call in ssd_scan_fwd).  Per chunk c of Q tokens and head h, with
// cum the inclusive cumsum of dt * a over the chunk and h_c the (N, P) state
// entering the chunk, exactly as _ssd_kernel:
//
//   W[i, j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for j <= i, else 0
//   y       = W x + exp(cum) * (C h_c) + D * x
//   h_{c+1} = exp(cum_Q) h_c + S_c,   S_c = sum_j (exp(cum_Q - cum_j) dt_j) B_j x_j^T
//
// The TPU kernel walks the chunks of a (batch, head) in order with the state
// in VMEM.  Here the chunks run in parallel, in the SSD paper's decomposition
// (chunk state, state passing, chunk output), as three kernels of one call:
//
//   1. ssd_chunk_state: per (chunk, head block, batch), S_c of each head
//      (stored transposed, (P, N)) and its log-decay cum_Q.
//   2. ssd_state_pass: per (batch, head, p, n), the short scan over chunks
//      h_{c+1} = exp(cum_Q,c) h_c + S_c; it writes the state entering each
//      chunk (bf16 inputs: as two bf16 pieces; f32: in f32) and the final
//      state in f32.
//   3. ssd_chunk_out: per (chunk, head block, batch), y.  C.B^T is computed
//      once per block and kept in registers (each of the 8 warps owns 16 rows
//      i and their causal columns j), and shared by the block's heads, which
//      all read one group of B and C.  W is formed from it in registers with
//      the exponent taken as the difference cum_i - cum_j (<= 0: exp(cum_i) *
//      exp(-cum_j) would overflow, since in mamba2's regime the log-decay
//      inside a chunk reaches the hundreds) and fed to the next product as
//      its A operand without leaving registers.  A head's x rows and
//      entering state arrive by cp.async while the previous head computes.
//
// Products run on the tensor cores with f32 accumulation, and keep f32's
// precision where the output needs it:
//   * bf16 x, B and C: mma.sync m16n8k16 bf16.  C.B^T takes one pass
//     (exact); the state and B o w, split into two bf16 pieces against the
//     exact x or C (warp_mma.cuh: split_pieces, pieces_mma), two passes; W
//     three pieces, three passes (a row whose output cancels to 1e-4 of its
//     terms, W_ii x_i against D x_i, keeps f32's relative precision only
//     with all three).
//   * f32 x, B and C (the mamba2 mixer's: its conv runs with f32 weights):
//     mma.sync m16n8k8 tf32 with every operand split into tf32 hi + lo in
//     registers and three passes a product (3xTF32, warp_mma.cuh:
//     mma_3xtf32), each product to about 2^-21 of itself.  x, B, C and the
//     entering states stay f32 in shared memory.
// The in-chunk cumsum of dt * a is taken in f64.  The diagonal of W joins the
// D term: y_i gets (C_i . B_i dt_i + D) x_i with the coefficient in f64 (C_i
// . B_i summed in f64 from the inputs), added in f32 from x itself, and W x
// runs over j < i.  Where C_i . B_i dt_i nearly cancels D (with N = 16, as
// jamba's mixer has, in about 1 row of 1e5 at the mixer's inputs), y_i is
// about 1e-6 of its two terms, and an f32 sum of them would err by f32's
// ulp of D, some percent of that row.  No atomics: two runs are bit-equal.
//
// Bound on the card: operations.  Per chunk of q tokens: q(q+1)/2 causal
// entries of C.B^T (2N FLOPs each) once per group, and per head q(q+1)/2
// entries of W x (2P each) plus C h and the state update (2qNP each); the
// bytes (x, B, C, y once each, the states a few times) are a few percent of
// that at f32's 67 TFLOP/s on an H100 SXM.  On the tensor cores the passes
// make it 1-3x the FLOPs at bf16's 989 TFLOP/s (bf16 inputs) or 3x at
// tf32's 495 (f32).
//
// Supported: T in {f32, bf16} for x, B, C and y; dt, a, D and the state in
// f32; P in {32, 64}; N a multiple of 16 up to 128; chunk Q up to 128 (rows
// past Q in a chunk, and tokens past L, are zero with dt = 0: their weights
// and decays are 0 and 1, and their y is not written).  B and C hold G
// groups; head h reads group h / (H / G) in place.
#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "warp_mma.cuh"

using namespace warp_mma;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = 128;  // 8 warps x 16 rows
constexpr int kMaxN = 128;
constexpr int kStages = 2;  // a head's rows load while the previous one computes

struct Dims {
  int L, H, G, N, Q, Qp, HB, nc;
};

// Row pads (elements) of the shared-memory tiles.  bf16 rows end 16 bytes
// past a multiple of 128 (conflict-free ldmatrix).  f32 rows are padded so
// that the lanes of a tf32 fragment load hit 32 distinct banks: by 8 floats
// where the lanes of a load step over rows by t (chunk states), by 4 where
// they step over rows by g (chunk output).
constexpr int kPadState = 8;
template <typename T>
struct Route {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int kPadOut = F32 ? 4 : 8;
  static constexpr int KH = F32 ? 1 : 2;  // entering states: f32, or two bf16 pieces
};
constexpr int kStatePieces = 2;  // bf16 route: pieces of B o w
constexpr int kWPieces = 3;      // bf16 route: pieces of W

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Rows of `cols` elements (16 bytes' worth a multiple) into shared memory
// with a pitch of `pitch` elements by 16-byte cp.async: row r from src +
// row_off(r), or zeros where row_off(r) < 0.  The caller commits and waits.
template <typename E, class RowOff>
__device__ __forceinline__ void copy_rows(E* dst, const E* src, int rows, int cols, int pitch,
                                          RowOff row_off) {
  constexpr int kPer = 16 / sizeof(E);
  const int cpr = cols / kPer;
  for (int i = threadIdx.x; i < rows * cpr; i += kThreads) {
    const int r = i / cpr;
    const int c = (i % cpr) * kPer;
    const long o = row_off(r);
    cp_async16(dst + r * pitch + c, src + (o >= 0 ? o + c : 0), o >= 0);
  }
}

// cum[i] = sum_{r <= i} dts[r] * a for i < Qp <= 128, by one warp: four
// values a lane, then a scan of the lanes' totals.  In f64: in mamba2's
// regime cum reaches the thousands within a chunk, where an f32 ulp (1e-4)
// would be the relative error of every decay exp(cum_i - cum_j) taken from
// it; the products dt * a are exact in f64.
__device__ __forceinline__ void warp_cumsum(const float* dts, float a, double* cum, int Qp) {
  const int lane = threadIdx.x & 31;
  double v[4];
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = lane * 4 + e;
    run += i < Qp ? double(dts[i]) * double(a) : 0.0;
    v[e] = run;
  }
  double tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += n;
  }
  const double excl = tot - run;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = lane * 4 + e;
    if (i < Qp) cum[i] = excl + v[e];
  }
}

// dt of the block's HB heads over the chunk (0 past Q or L) into dts (HB,
// Qp).  The caller synchronises after.
__device__ __forceinline__ void load_dt(float* dts, const float* dt, int b, int t0, int h0,
                                        const Dims& d) {
  for (int i = threadIdx.x; i < d.HB * d.Qp; i += kThreads) {
    const int hh = i / d.Qp;
    const int j = i % d.Qp;
    const int t = t0 + j;
    dts[i] = (j < d.Q && t < d.L) ? dt[(long(b) * d.L + t) * d.H + h0 + hh] : 0.f;
  }
}

// Offset of token row j of a (B, L, X, cols) tensor at (b, t0 + j, xi), or
// -1 past the chunk or L.
__device__ __forceinline__ long token_row(int j, int b, int t0, int xi, int X, int cols,
                                          const Dims& d) {
  const int t = t0 + j;
  return (j < d.Q && t < d.L) ? ((long(b) * d.L + t) * X + xi) * cols : -1L;
}

// B fragments of the KB pieces of a transposed operand Bt[n][k] (pieces
// `stride` elements apart): b[j] = {b0, b1} of piece j.
template <int KB>
__device__ __forceinline__ void load_b_pieces(uint32_t (&b)[KB][2], const bf16* bt, int stride,
                                              int pitch, int n0, int k0) {
#pragma unroll
  for (int j = 0; j < KB; ++j) load_b(b[j][0], b[j][1], bt + j * stride, pitch, n0, k0);
}

// ---------------------------------------------------------------------------
// 1. chunk states
// ---------------------------------------------------------------------------
// x (B,L,H,P), B (B,L,G,N) of type T.  states (B, H, nc, P, N) f32, cq (B,
// H, nc) f32.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_state(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ Bm, float* __restrict__ states, float* __restrict__ cq, Dims d) {
  constexpr bool F32 = Route<T>::F32;
  const int c = blockIdx.x;
  const int h0 = blockIdx.y * d.HB;
  const int b = blockIdx.z;
  const int grp = h0 / (d.H / d.G);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int N = d.N;
  const int Qp = d.Qp;
  const int pN = N + kPadState;
  const int pP = P + kPadState;
  const int t0 = c * d.Q;
  const int xplane = Qp * pP;

  extern __shared__ __align__(16) unsigned char smem[];
  T* bs = reinterpret_cast<T*>(smem);  // [Qp][pN]: B rows
  T* xs = bs + Qp * pN;                // [kStages][Qp][pP]: x rows
  double* cum = reinterpret_cast<double*>(xs + kStages * xplane);  // (HB, Qp)
  float* dts = reinterpret_cast<float*>(cum + d.HB * Qp);           // (HB, Qp)
  float* w = dts + d.HB * Qp;                                       // (HB, Qp)

  copy_rows(bs, Bm, Qp, N, pN, [&](int j) { return token_row(j, b, t0, grp, d.G, N, d); });
  auto load_x = [&](int hh, int stage) {
    copy_rows(xs + stage * xplane, x, Qp, P, pP,
              [&](int j) { return token_row(j, b, t0, h0 + hh, d.H, P, d); });
  };
  load_x(0, 0);
  cp_async_commit();
  load_dt(dts, dt, b, t0, h0, d);
  __syncthreads();
  if (warp < d.HB) warp_cumsum(dts + warp * Qp, a[h0 + warp], cum + warp * Qp, Qp);
  __syncthreads();
  for (int i = tid; i < d.HB * Qp; i += kThreads) {
    const int hh = i / Qp;
    w[i] = expf(float(cum[hh * Qp + Qp - 1] - cum[i])) * dts[i];
  }
  if (tid < d.HB) cq[(long(b) * d.H + h0 + tid) * d.nc + c] = float(cum[tid * Qp + Qp - 1]);

  for (int hh = 0; hh < d.HB; ++hh) {
    const int h = h0 + hh;
    if (hh + 1 < d.HB) load_x(hh + 1, (hh + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* x0 = xs + (hh & 1) * xplane;
    const float* wh = w + hh * Qp;
    float* st = states + ((long(b) * d.H + h) * d.nc + c) * P * N;
    for (int ms = warp; ms < N / 16; ms += kWarps) {
      float acc[P / 8][4] = {};
      // A[n][j] = B[j][n] * w[j]: rows n = 16 ms.., columns j (the tokens)
      if constexpr (F32) {
        // 3xTF32 in k steps of 8 tokens: a0..a3 = A[g][t], A[g+8][t],
        // A[g][t+4], A[g+8][t+4]; x[j][p] as B (b0 = x[t][g], b1 = x[t+4][g])
        for (int kk = 0; kk < Qp / 8; ++kk) {
          const int j = 8 * kk + t4;
          const float* r0 = bs + j * pN + 16 * ms + g;
          const float* r1 = r0 + 4 * pN;
          const float w0 = wh[j];
          const float w1 = wh[j + 4];
          const Tf32A af = tf32_a(r0[0] * w0, r0[8] * w0, r1[0] * w1, r1[8] * w1);
          const float* xr = x0 + j * pP + g;
#pragma unroll
          for (int nt = 0; nt < P / 8; ++nt)
            mma_3xtf32(acc[nt], af, tf32_b(xr[8 * nt], xr[4 * pP + 8 * nt]));
        }
      } else {
        // bf16 in k steps of 16 tokens: B o w in two pieces against exact x
        for (int kk = 0; kk < Qp / 16; ++kk) {
          uint32_t raw[4];
          ldsm_at(raw, bs, pN, 16 * ms, 16 * kk);
          uint32_t af[kStatePieces][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = 16 * kk + 8 * (q >> 1) + 2 * t4;
            const float2 v = unpack(raw[q]);
            uint32_t pc[kStatePieces];
            split_pieces<kStatePieces>(v.x * wh[j], v.y * wh[j + 1], pc);
#pragma unroll
            for (int k = 0; k < kStatePieces; ++k) af[k][q] = pc[k];
          }
#pragma unroll
          for (int nt = 0; nt < P / 8; nt += 2) {
            uint32_t r[4];
            ldsm_b(r, x0, pP, 16 * kk, 8 * nt);
            const uint32_t xb0[1][2] = {{r[0], r[1]}};
            const uint32_t xb1[1][2] = {{r[2], r[3]}};
            pieces_mma<kStatePieces, 1>(acc[nt], af, xb0);
            pieces_mma<kStatePieces, 1>(acc[nt + 1], af, xb1);
          }
        }
      }
      // S^T: (P, N); element (n, p) of the accumulators to st[p * N + n]
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        const int n = 16 * ms + g;
        const int p = 8 * nt + 2 * t4;
        st[p * N + n] = acc[nt][0];
        st[(p + 1) * N + n] = acc[nt][1];
        st[p * N + n + 8] = acc[nt][2];
        st[(p + 1) * N + n + 8] = acc[nt][3];
      }
    }
    __syncthreads();  // this stage is refilled two heads on
  }
}

// ---------------------------------------------------------------------------
// 2. state passing
// ---------------------------------------------------------------------------
// Per (batch, head, e) with e = p * N + n: the entering states of the
// chunks, hp (B, H, nc, KH, P, N) as KH pieces of type HT (two bf16 pieces,
// or f32 itself), and the final state h_out (B, H, N, P) f32.  The loads of
// kAhead chunks go out before their first use, so that each thread keeps
// that many reads in flight.
template <typename HT, int KH>
__global__ void __launch_bounds__(256) ssd_state_pass(const float* __restrict__ states,
                                                      const float* __restrict__ cq,
                                                      HT* __restrict__ hp,
                                                      float* __restrict__ h_out, int nc,
                                                      int N, int PN) {
  constexpr int kAhead = 8;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const long bh = blockIdx.y;  // b * H + h
  if (e >= PN) return;
  const float* src = states + bh * nc * PN + e;
  const float* lc = cq + bh * nc;
  HT* dst = hp + bh * nc * KH * PN + e;
  float run = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float s[kAhead];
    float l[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 + k;
      s[k] = c < nc ? src[long(c) * PN] : 0.f;
      l[k] = c < nc ? lc[c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 + k;
      if (c < nc) {
        float rest = run;
#pragma unroll
        for (int j = 0; j < KH; ++j) {
          const HT piece = from_f<HT>(rest);
          dst[(long(c) * KH + j) * PN] = piece;
          rest -= to_f(piece);
        }
        run = fmaf(expf(l[k]), run, s[k]);
      }
    }
  }
  const int p = e / N;
  const int n = e % N;
  h_out[bh * PN + long(n) * (PN / N) + p] = run;
}

// ---------------------------------------------------------------------------
// 3. chunk output
// ---------------------------------------------------------------------------
// x (B,L,H,P), B and C (B,L,G,N) of type T; hp the KH pieces of the
// entering states (ssd_state_pass).
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_out(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dv,
    const T* __restrict__ hp, T* __restrict__ y, Dims d) {
  constexpr bool F32 = Route<T>::F32;
  constexpr int KH = Route<T>::KH;
  const int c = blockIdx.x;
  const int h0 = blockIdx.y * d.HB;
  const int b = blockIdx.z;
  const int grp = h0 / (d.H / d.G);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int N = d.N;
  const int Qp = d.Qp;
  const int pN = N + Route<T>::kPadOut;
  const int pP = P + Route<T>::kPadOut;
  const int t0 = c * d.Q;
  const int PN = P * N;
  const int cplane = Qp * pN;  // shared-memory strides
  const int xplane = Qp * pP;
  const int hplane = P * pN;

  extern __shared__ __align__(16) unsigned char smem[];
  T* cs = reinterpret_cast<T*>(smem);  // [Qp][pN]: C rows
  T* region = cs + cplane;
  T* bs = region;                                  // [Qp][pN]: B rows, until C.B^T
  const int stage_len = xplane + KH * hplane;      // x rows, then the entering state
  const int region_len = max(cplane, kStages * stage_len);
  double* cum = reinterpret_cast<double*>(region + region_len);  // (HB, Qp)
  float* dts = reinterpret_cast<float*>(cum + d.HB * Qp);         // (HB, Qp)
  float* fcol = dts + d.HB * Qp;                                  // (HB, Qp)
  double* cbd = reinterpret_cast<double*>(fcol + d.HB * Qp);      // (Qp): C_i . B_i

  auto crow = [&](int j) { return token_row(j, b, t0, grp, d.G, N, d); };
  copy_rows(cs, Cm, Qp, N, pN, crow);
  copy_rows(bs, Bm, Qp, N, pN, crow);
  cp_async_commit();
  load_dt(dts, dt, b, t0, h0, d);
  cp_async_wait<0>();
  __syncthreads();
  if (warp < d.HB) warp_cumsum(dts + warp * Qp, a[h0 + warp], cum + warp * Qp, Qp);

  // C.B^T for rows 16 s .. 16 s + 15 and columns j < 16 (s + 1).  Warps w
  // and w + 4 share a scheduler (SM sub-partition): they take slabs w and 7 -
  // w, so that each pair has the same causal work.
  const int s = (warp & 4) ? kWarps - 1 - (warp & 3) : warp;
  const bool active = s < Qp / 16;
  const int i0 = 16 * s + g;  // this thread's rows: i0 and i0 + 8
  float cb[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[nt][e] = 0.f;
  if (active) {
    if constexpr (F32) {
      for (int kk = 0; kk < N / 8; ++kk) {
        const float* cr = cs + i0 * pN + 8 * kk + t4;
        const Tf32A ca = tf32_a(cr[0], cr[8 * pN], cr[4], cr[8 * pN + 4]);
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          if (nt <= 2 * s + 1) {
            const float* br = bs + (8 * nt + g) * pN + 8 * kk + t4;
            mma_3xtf32(cb[nt], ca, tf32_b(br[0], br[4]));
          }
        }
      }
    } else {
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t ca[4];
        load_a(ca, cs, pN, 16 * s, 16 * kk);
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          if (nt <= 2 * s + 1) {
            uint32_t b0, b1;
            load_b(b0, b1, bs, pN, 8 * nt, 16 * kk);
            mma(cb[nt], ca, b0, b1);
          }
        }
      }
    }
  }
  for (int i = tid; i < Qp; i += kThreads) {  // the diagonal in f64: exact products
    double dot = 0.0;
    for (int n = 0; n < N; ++n)
      dot = fma(double(to_f(cs[i * pN + n])), double(to_f(bs[i * pN + n])), dot);
    cbd[i] = dot;
  }
  __syncthreads();  // B is done: the region takes the heads' stages; cum is written
  // Column factors of the decay off the diagonal blocks of 16 tokens:
  // exp(cum_i - cum_j) = exp(cum_i - cum_e) exp(cum_e - cum_j) with e the
  // last token of j's block; both exponents are <= 0 for i past that block.
  for (int i = tid; i < d.HB * Qp; i += kThreads) {
    const int j = i % Qp;
    fcol[i] = expf(float(cum[i - j + (j | 15)] - cum[i])) * dts[i];
  }

  auto load_head = [&](int hh, int stage) {
    T* dst = region + stage * stage_len;
    copy_rows(dst, x, Qp, P, pP, [&](int j) { return token_row(j, b, t0, h0 + hh, d.H, P, d); });
    const long base = ((long(b) * d.H + h0 + hh) * d.nc + c) * KH * PN;
    copy_rows(dst + xplane, hp, KH * P, N, pN, [&](int r) { return base + long(r) * N; });
  };
  load_head(0, 0);
  cp_async_commit();

  for (int hh = 0; hh < d.HB; ++hh) {
    const int h = h0 + hh;
    if (hh + 1 < d.HB) load_head(hh + 1, (hh + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* x0 = region + (hh & 1) * stage_len;
    const T* h0s = x0 + xplane;  // (P, pN): entering state, transposed
    if (active) {
      const double* cum_h = cum + hh * Qp;
      const float* dt_h = dts + hh * Qp;
      float acc[P / 8][4] = {};
      // C h_c, then scaled by exp(cum_i)
      if constexpr (F32) {
        for (int kk = 0; kk < N / 8; ++kk) {
          const float* cr = cs + i0 * pN + 8 * kk + t4;
          const Tf32A ca = tf32_a(cr[0], cr[8 * pN], cr[4], cr[8 * pN + 4]);
          const float* hr = h0s + g * pN + 8 * kk + t4;
#pragma unroll
          for (int nt = 0; nt < P / 8; ++nt)
            mma_3xtf32(acc[nt], ca, tf32_b(hr[8 * nt * pN], hr[8 * nt * pN + 4]));
        }
      } else {
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t ca[1][4];
          load_a(ca[0], cs, pN, 16 * s, 16 * kk);
#pragma unroll
          for (int nt = 0; nt < P / 8; ++nt) {
            uint32_t hb[KH][2];
            load_b_pieces<KH>(hb, h0s, hplane, pN, 8 * nt, 16 * kk);
            pieces_mma<1, KH>(acc[nt], ca, hb);
          }
        }
      }
      const double cum0 = cum_h[i0];
      const double cum1 = cum_h[i0 + 8];
      const float e0 = expf(float(cum0));
      const float e1 = expf(float(cum1));
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
      // + W x over the causal column tiles: on the diagonal block the decay
      // from its exponent; off it as the product of the row's factor to the
      // block's end and the block's column factor (fcol)
      const float* fc_h = fcol + hh * Qp;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk <= s) {
          const double ce = cum_h[16 * kk + 15];
          const float er[2] = {kk < s ? expf(float(cum0 - ce)) : 0.f,
                               kk < s ? expf(float(cum1 - ce)) : 0.f};
          // wv[q] = W at (row i0 + 8 (q & 1), columns col and col + 1) with
          // col = 16 kk + 8 (q >> 1) + 2 t4: the m16n8k16 A fragment's order
          float wv[4][2];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = i0 + 8 * (q & 1);
            const double cr = (q & 1) ? cum1 : cum0;
            const int col = 16 * kk + 8 * (q >> 1) + 2 * t4;
            const float c0 = cb[2 * kk + (q >> 1)][2 * (q & 1)];
            const float c1 = cb[2 * kk + (q >> 1)][2 * (q & 1) + 1];
            if (kk < s) {
              wv[q][0] = c0 * er[q & 1] * fc_h[col];
              wv[q][1] = c1 * er[q & 1] * fc_h[col + 1];
            } else {  // the diagonal joins the D term
              wv[q][0] = col < row ? c0 * expf(float(cr - cum_h[col])) * dt_h[col] : 0.f;
              wv[q][1] =
                  col + 1 < row ? c1 * expf(float(cr - cum_h[col + 1])) * dt_h[col + 1] : 0.f;
            }
          }
          if constexpr (F32) {
            // two k8 steps over columns 16 kk + 8 hf ..: slot t takes column
            // 2t and slot t + 4 column 2t + 1, in A and x alike
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const Tf32A wa = tf32_a(wv[2 * hf][0], wv[2 * hf + 1][0], wv[2 * hf][1],
                                      wv[2 * hf + 1][1]);
              const float* xr = x0 + (16 * kk + 8 * hf + 2 * t4) * pP + g;
#pragma unroll
              for (int nt = 0; nt < P / 8; ++nt)
                mma_3xtf32(acc[nt], wa, tf32_b(xr[8 * nt], xr[pP + 8 * nt]));
            }
          } else {
            uint32_t wa[kWPieces][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              uint32_t pc[kWPieces];
              split_pieces<kWPieces>(wv[q][0], wv[q][1], pc);
#pragma unroll
              for (int k = 0; k < kWPieces; ++k) wa[k][q] = pc[k];
            }
#pragma unroll
            for (int nt = 0; nt < P / 8; nt += 2) {
              uint32_t r[4];
              ldsm_b(r, x0, pP, 16 * kk, 8 * nt);
              const uint32_t xb0[1][2] = {{r[0], r[1]}};
              const uint32_t xb1[1][2] = {{r[2], r[3]}};
              pieces_mma<kWPieces, 1>(acc[nt], wa, xb0);
              pieces_mma<kWPieces, 1>(acc[nt + 1], wa, xb1);
            }
          }
        }
      }
      // + (C_i . B_i dt_i + D) x_i, the coefficient in f64, in f32 from x itself
      const double dh = Dv[h];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + 8 * half;
        const int t = t0 + i;
        if (i >= d.Q || t >= d.L) continue;
        const float coef = float(fma(cbd[i], double(dt_h[i]), dh));
        const long row = ((long(b) * d.L + t) * d.H + h) * P;
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          const int p = 8 * nt + 2 * t4;
          const float2 xv = load2(x + row + p);
          store2(y + row + p, fmaf(coef, xv.x, acc[nt][2 * half]),
                 fmaf(coef, xv.y, acc[nt][2 * half + 1]));
        }
      }
    }
    __syncthreads();  // this stage is refilled two heads on
  }
}

template <typename T, int P>
size_t state_smem(int N, int Qp, int HB) {
  return (size_t(Qp) * (N + kPadState) + size_t(kStages) * Qp * (P + kPadState)) * sizeof(T) +
         size_t(HB) * Qp * (sizeof(double) + 2 * sizeof(float));
}

template <typename T, int P>
size_t out_smem(int N, int Qp, int HB) {
  constexpr int pad = Route<T>::kPadOut;
  const size_t plane = size_t(Qp) * (N + pad);
  const size_t stage = size_t(Qp) * (P + pad) + size_t(Route<T>::KH) * P * (N + pad);
  return (plane + std::max(plane, kStages * stage)) * sizeof(T) +
         size_t(HB) * Qp * (sizeof(double) + 2 * sizeof(float)) + size_t(Qp) * sizeof(double);
}

template <typename T, int P>
cudaError_t launch(const void* xv, const void* dtv, const void* av, const void* Bv,
                   const void* Cv, const void* Dv, void* yv, void* hv, void* statesv, void* hpv,
                   void* cqv, int Bsz, int L, int H, int G, int N, int Q, cudaStream_t stream) {
  static unsigned ready_state = 0, ready_out = 0;
  const T* x = static_cast<const T*>(xv);
  const T* Bm = static_cast<const T*>(Bv);
  const float* dt = static_cast<const float*>(dtv);
  const float* a = static_cast<const float*>(av);
  float* states = static_cast<float*>(statesv);
  float* cq = static_cast<float*>(cqv);
  T* hp = static_cast<T*>(hpv);
  const int Qp = (Q + 15) / 16 * 16;
  const int nc = (L + Q - 1) / Q;
  int HB = 1;
  for (int hb : {8, 4, 2}) {
    if ((H / G) % hb == 0) {
      HB = hb;
      break;
    }
  }
  const Dims d{L, H, G, N, Q, Qp, HB, nc};
  auto k1 = ssd_chunk_state<T, P>;
  auto k3 = ssd_chunk_out<T, P>;
  const size_t s1 = state_smem<T, P>(N, Qp, HB);
  const size_t s3 = out_smem<T, P>(N, Qp, HB);
  if (s1 > size_t(kMaxSmem) || s3 > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t err = set_smem_once(k1, kMaxSmem, ready_state);
  if (err == cudaSuccess) err = set_smem_once(k3, kMaxSmem, ready_out);
  if (err != cudaSuccess) return err;
  const dim3 grid(nc, H / HB, Bsz);
  k1<<<grid, kThreads, s1, stream>>>(x, dt, a, Bm, states, cq, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int PN = P * N;
  ssd_state_pass<T, Route<T>::KH><<<dim3((PN + 255) / 256, Bsz * H), 256, 0, stream>>>(
      states, cq, hp, static_cast<float*>(hv), nc, N, PN);
  if ((err = cudaGetLastError()) != cudaSuccess || yv == nullptr) return err;
  k3<<<grid, kThreads, s3, stream>>>(x, dt, a, Bm, static_cast<const T*>(Cv),
                                     static_cast<const float*>(Dv), hp, static_cast<T*>(yv), d);
  return cudaGetLastError();
}

int run(const void* x, const void* dt, const void* a, const void* Bm, const void* Cm,
        const void* D, void* y, void* h, void* states, void* hp, void* cq, int Bsz, int L,
        int H, int G, int P, int N, int Q, int dtype, void* stream) {
  if (G <= 0 || H % G || N % 16 || N < 16 || N > kMaxN || Q < 1 || Q > kMaxQ || L < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) {
    return kernel(x, dt, a, Bm, Cm, D, y, h, states, hp, cq, Bsz, L, H, G, N, Q, s);
  };
  if (dtype == 0 && P == 32) return go(launch<float, 32>);
  if (dtype == 0 && P == 64) return go(launch<float, 64>);
  if (dtype == 1 && P == 32) return go(launch<bf16, 32>);
  if (dtype == 1 && P == 64) return go(launch<bf16, 64>);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (B,L,H,P) and y of one type (dtype 0 = f32, 1 = bf16); dt (B,L,H), a and
// D (H,) f32; B and C (B,L,G,N) of x's type; h (B,H,N,P) f32, the final
// state.  Workspace: states (B, H, nc, P, N) f32, hp (B, H, nc, K, P, N) of
// x's type with K = 2 for bf16 and 1 for f32, cq (B, H, nc) f32 with nc =
// ceil(L / Q).  All contiguous and 16-byte aligned.  Q = the chunk (<=
// min(L, 128)).  Runs the kernels on `stream`; returns the first
// cudaError_t.
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* Bm, const void* Cm,
                 const void* D, void* y, void* h, void* states, void* hp, void* cq, int Bsz,
                 int L, int H, int G, int P, int N, int Q, int dtype, void* stream) {
  return run(x, dt, a, Bm, Cm, D, y, h, states, hp, cq, Bsz, L, H, G, P, N, Q, dtype, stream);
}

// Kernels 1 and 2 alone: the states entering each chunk (hp), their
// log-decays (cq) and the final state (h), as ssd_scan_fwd writes them, with
// no output.  The backward (ssd_scan_bwd.cu) recomputes them at its chunk.
int ssd_scan_states(const void* x, const void* dt, const void* a, const void* Bm, void* h,
                    void* states, void* hp, void* cq, int Bsz, int L, int H, int G, int P,
                    int N, int Q, int dtype, void* stream) {
  return run(x, dt, a, Bm, nullptr, nullptr, nullptr, h, states, hp, cq, Bsz, L, H, G, P, N,
             Q, dtype, stream);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
