// Backward of the mamba2 SSD chunked scan for sm_90a, chunk-parallel, with
// its products on the tensor cores.
//
// The port's own kernel: the JAX package has no backward kernel for the
// scan.  Its mixer (src/repro/models/layers.py:362) is plain jnp, which XLA
// differentiates; this is the gradient of ssd_scan.cu, which replaces
// src/repro/kernels/ssd_scan/kernel.py::_ssd_kernel.  Its plain version is
// ssd_scan/ref.py::ssd_scan_bwd_ref, whose docstring states the math, and
// ref.py::ssd_scan_bwd_chunked_model is a plain model of the decomposition
// below.  Per (batch, head, chunk c of Q tokens) with cum_i = a s_i (s the
// in-chunk cumsum of dt), h_c the state entering the chunk, R_c the
// gradient of the state leaving it, G_ij = dy_i . x_j and L_ij =
// exp(cum_i - cum_j) (j <= i):
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
//      their log-decays.  They are recomputed, not saved by the forward, so
//      nothing of 168-335 MB a layer is held from the forward to the
//      backward.
//   1. ssd_bwd_chunk_state: per (chunk, head block, batch), sum_i exp(cum_i)
//      C_i dy_i^T of each head, stored transposed (P, N) in the R workspace.
//   2. ssd_bwd_state_pass: per (batch, head, p, n), the reverse scan over the
//      chunks, in place: the workspace then holds R_c of every chunk.
//   3. ssd_bwd_chunk: per (chunk, head block, batch), every gradient of the
//      chunk for each of the block's heads (below).
//   4. ssd_bwd_group_sum (dB, then dC): the sum of the head blocks' partials
//      of each group, in order, to x's type; ssd_bwd_head_sum: da and dD
//      summed over batches and chunks in order.
//
// Kernel 3.  A block takes one chunk and a block of up to kHeadBlock heads of
// one group (the last block of a group takes what is left), as the forward's
// ssd_chunk_out does: C and B are loaded once, and B.C^T is formed once and
// kept in registers for every head.  Per head, 8 warps: warp w takes the row
// slab st = w % 4 (16 rows) of G^T, dB and dC and the slab 3 - st of dx, and
// half of the slab's column tiles: the causal work of the three steps then
// sums to the same for every warp.  Steps:
//   a. G^T = x dy^T over the causal tiles (i >= j); P^T = G^T o L^T to shared
//      memory, and the diagonal of G (its sum is dD).
//   b. dC = (exp(cum) o dy) h_c^T + (P o dt) B, the first part dotted with
//      C_i before the second is added: exp(cum_i) u_i (u_i = C_i . h_c dy_i);
//      and <h_c, R_c>.
//   c. dx = dt o (K^T dy + (exp(cum_last - cum) o B) R_c) + D dy with K^T =
//      B.C^T o L^T built in registers from the kept B.C^T (the accumulators
//      feed the next product as its A operand without a shuffle); and from
//      Z^T = P^T o B.C^T its row sums vcol_j = sum_i G_ij L_ij (C_i . B_j) and
//      its dt-weighted column sums rowz_i = sum_j G_ij W_ij.
//   d. dB = dt o ((exp(cum_last - cum) o x) R_c^T + P^T C), the first part
//      dotted with B_j first: exp(cum_last - cum_j) v_j (v_j = B_j . R_c x_j).
//   e. by warp 7 during step a of the next head: dcum_i = rowz_i - dt_i vcol_i
//      + exp(cum_i) u_i - w_i v_i (each term an f32 sum of its own, combined
//      in f64; at the chunk's last row also exp(cum_last) <h_c, R_c> + sum_j
//      w_j v_j), its reverse cumsum, ddt_j = vcol_j + exp(cum_last - cum_j)
//      v_j + a rev_j, and the chunk's partials of da and dD.
// Warp 0 makes the cumsum of the next head at the end of each head.  Two
// barriers a head: one after which a head's x, dy and cumsum are in place
// (h_c and R_c then load by cp.async during step a), one after step a (P^T,
// h_c and R_c in place; the next head's x and dy then load during steps b-d
// into the other of two stages).  dB and dC are summed over the block's heads
// in head order into the block's f32 partial (B, L, G, head blocks, N): each
// thread adds its own elements, which stay in L2 between heads.  Every
// exponent is a difference <= 0: in mamba2's regime the log-decay inside a
// chunk reaches the hundreds.  The in-chunk cumsum, dcum and its reverse
// cumsum are f64 (dcum is a sum of terms of both signs, and its cumsum is
// multiplied by a).  No float atomics, every sum in a fixed order: two runs
// are bit-equal.
//
// Products run on the tensor cores: mma.sync m16n8k8 tf32 with f32
// accumulation and every f32 operand split into tf32 hi + lo in registers
// (split, below), three passes a product (3xTF32), each product to about
// 2^-20 of itself.  bf16 x, dy, B and C are exact in tf32: a product whose
// operand is one of them skips that operand's lo pass (two passes, or one for
// G and B.C^T).  The passes of one product go over all its n tiles before the
// next pass, so that products issued back to back are independent.  No mma
// sits under a condition that differs between the warp's lanes as the
// compiler sees it: tiles past N, and the causal tiles a warp does not need
// in steps a and c, run on valid data and are dropped or are zero.
//
// Bound on the card: operations.  Per chunk of q tokens and head: the causal
// q(q+1)/2 entries of C.B^T (2N each, once per group), of G (2P), of the
// products with K for dx (2P) and with P for dB and dC (2N each), and per
// token the state terms R^T B, R x, h dy and the backward chunk state (2NP
// each), plus the forward's recomputed chunk state; on the tensor cores
// three tf32 passes of them at 495 TFLOP/s.  What holds it back on an H100
// is the rate of mma.sync with the splits and loads around each product,
// and the load of h_c and R_c (64 KB a head in f32) after each head's first
// barrier.
//
// Shared memory of kernel 3 at N = 128, P = 64 in f32: 226 KB, one block an
// SM.
//
// Supported: T in {f32, bf16} for x, B, C, dy and dx, dB, dC; dt, a, D, ddt,
// da, dD and the states in f32; P in {32, 64}; N a multiple of 16 up to 128;
// Q <= 64.  Rows past Q in a chunk, and tokens past L, are zero with dt = 0.
#include <type_traits>

#include "warp_mma.cuh"

using namespace warp_mma;

namespace {

constexpr int kQ = 64;  // rows of a chunk in shared memory: Q <= kQ
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 128;
constexpr int kHeadBlock = 8;  // heads of one group a block takes (kernel.HEAD_BLOCK)
constexpr int kNT = kMaxN / 16;  // n8 tiles of N a warp holds: nt = q + 2 k, k < kNT

struct Dims {
  int L, H, G, N, Q, nc, hpg, nhb;  // hpg heads a group, nhb head blocks a group
};

template <typename T>
struct Route {
  static constexpr bool kExact = !std::is_same<T, float>::value;  // bf16 is exact in tf32
  static constexpr int KH = kExact ? 2 : 1;  // entering states: two bf16 pieces, or f32
  // Row pads (elements) of the shared-memory tiles.  f32 rows read along k
  // are padded by 4 (the lanes of a fragment load step over rows by g), rows
  // read across k (lanes step over rows by t) by 8: 32 distinct banks either
  // way.  bf16 rows by 8, so that each row starts 16 bytes aligned.
  static constexpr int kPadK = kExact ? 8 : 4;
  static constexpr int kPadN = 8;
};

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

// x as tf32 hi + lo in two operations (no cvt, whose rate is a small
// fraction of the FMA rate's): hi is x cut to tf32 (its top 19 bits), lo = x
// - hi (exact in f32, |lo| < 2^-10 |x|), handed to the tensor cores as it is:
// they read the top 19 bits of a tf32 operand, so lo is cut to 2^-10 of
// itself and hi + lo is x to about 2^-20.  An operand that is exact in tf32
// (a bf16 value) is its own hi and takes no lo piece.
template <bool Exact>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (Exact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

template <bool Exact>
__device__ __forceinline__ Tf32A frag_a(float a0, float a1, float a2, float a3) {
  Tf32A f;
  split<Exact>(a0, f.hi[0], f.lo[0]);
  split<Exact>(a1, f.hi[1], f.lo[1]);
  split<Exact>(a2, f.hi[2], f.lo[2]);
  split<Exact>(a3, f.hi[3], f.lo[3]);
  return f;
}

template <bool Exact>
__device__ __forceinline__ Tf32B frag_b(float b0, float b1) {
  Tf32B f;
  split<Exact>(b0, f.hi[0], f.lo[0]);
  split<Exact>(b1, f.hi[1], f.lo[1]);
  return f;
}

// c[k] += a b[k] for the n tiles k < KT, in the passes of mma_3xtf32 (lo.hi,
// hi.lo, hi.hi) less those whose lo piece is 0 (an exact operand).  Each
// pass goes over every tile before the next one starts, so that the
// products issued back to back are independent.  No mma sits under a
// condition of its own (the compiler would fence each one with a WARPSYNC):
// tiles past N, or past the causal range, run on a valid tile and their
// results are dropped or masked.
template <bool AE, bool BE, int KT>
__device__ __forceinline__ void mma3(float (&c)[KT][4], const Tf32A& a, const Tf32B (&b)[KT]) {
  if constexpr (!AE) {
#pragma unroll
    for (int k = 0; k < KT; ++k) mma_tf32(c[k], a.lo, b[k].hi[0], b[k].hi[1]);
  }
  if constexpr (!BE) {
#pragma unroll
    for (int k = 0; k < KT; ++k) mma_tf32(c[k], a.hi, b[k].lo[0], b[k].lo[1]);
  }
#pragma unroll
  for (int k = 0; k < KT; ++k) mma_tf32(c[k], a.hi, b[k].hi[0], b[k].hi[1]);
}

// Tiles 4 gi .. 4 gi + 3 of an accumulator array, for mma3 (gi a constant
// after unrolling, so the view stays in registers).
template <int KT>
__device__ __forceinline__ float (&tiles4(float (&c)[KT][4], int gi))[4][4] {
  return *reinterpret_cast<float(*)[4][4]>(&c[4 * gi]);
}

// Rows of `cols` elements (16 bytes' worth a multiple, at most 512 bytes)
// into shared memory with a pitch of `pitch` elements by 16-byte cp.async:
// each warp instruction copies 32 / (row bytes / 16) whole rows, row r from
// src + row_off(r), or zeros where row_off(r) < 0.  The caller commits and
// waits.
template <typename E, class RowOff>
__device__ __forceinline__ void copy_rows(E* dst, const E* src, int rows, int cols, int pitch,
                                          RowOff row_off) {
  constexpr int kPer = 16 / sizeof(E);
  const int lpr = cols / kPer;  // lanes a row
  const int rpw = 32 / lpr;     // rows a warp instruction
  const int lane = threadIdx.x & 31;
  const int lr = lane / lpr;
  if (lr >= rpw) return;
  const int c = (lane - lr * lpr) * kPer;
  for (int r = (threadIdx.x >> 5) * rpw + lr; r < rows; r += kWarps * rpw) {
    const long o = row_off(r);
    cp_async16(dst + r * pitch + c, src + (o >= 0 ? o + c : 0), o >= 0);
  }
}

// Warp shuffles over the whole warp as PTX.  They run only where every lane
// of the warp takes part, but often under a condition on the warp index,
// where the compiler would wrap each __shfl_*_sync in a loop over the active
// lanes.
__device__ __forceinline__ float shfl_xor(float v, int m) {
  float r;
  asm volatile("shfl.sync.bfly.b32 %0, %1, %2, 0x1f, 0xffffffff;" : "=f"(r) : "f"(v), "r"(m));
  return r;
}
__device__ __forceinline__ double shfl_xor(double v, int m) {
  int lo, hi;
  asm("mov.b64 {%0, %1}, %2;" : "=r"(lo), "=r"(hi) : "d"(v));
  asm volatile("shfl.sync.bfly.b32 %0, %0, %1, 0x1f, 0xffffffff;" : "+r"(lo) : "r"(m));
  asm volatile("shfl.sync.bfly.b32 %0, %0, %1, 0x1f, 0xffffffff;" : "+r"(hi) : "r"(m));
  double r;
  asm("mov.b64 %0, {%1, %2};" : "=d"(r) : "r"(lo), "r"(hi));
  return r;
}
__device__ __forceinline__ double shfl_up(double v, int n) {
  int lo, hi;
  asm("mov.b64 {%0, %1}, %2;" : "=r"(lo), "=r"(hi) : "d"(v));
  asm volatile("shfl.sync.up.b32 %0, %0, %1, 0x0, 0xffffffff;" : "+r"(lo) : "r"(n));
  asm volatile("shfl.sync.up.b32 %0, %0, %1, 0x0, 0xffffffff;" : "+r"(hi) : "r"(n));
  double r;
  asm("mov.b64 %0, {%1, %2};" : "=d"(r) : "r"(lo), "r"(hi));
  return r;
}
__device__ __forceinline__ double shfl_down(double v, int n) {
  int lo, hi;
  asm("mov.b64 {%0, %1}, %2;" : "=r"(lo), "=r"(hi) : "d"(v));
  asm volatile("shfl.sync.down.b32 %0, %0, %1, 0x1f, 0xffffffff;" : "+r"(lo) : "r"(n));
  asm volatile("shfl.sync.down.b32 %0, %0, %1, 0x1f, 0xffffffff;" : "+r"(hi) : "r"(n));
  double r;
  asm("mov.b64 %0, {%1, %2};" : "=d"(r) : "r"(lo), "r"(hi));
  return r;
}
__device__ __forceinline__ double shfl_idx(double v, int src) {
  int lo, hi;
  asm("mov.b64 {%0, %1}, %2;" : "=r"(lo), "=r"(hi) : "d"(v));
  asm volatile("shfl.sync.idx.b32 %0, %0, %1, 0x1f, 0xffffffff;" : "+r"(lo) : "r"(src));
  asm volatile("shfl.sync.idx.b32 %0, %0, %1, 0x1f, 0xffffffff;" : "+r"(hi) : "r"(src));
  double r;
  asm("mov.b64 %0, {%1, %2};" : "=d"(r) : "r"(lo), "r"(hi));
  return r;
}

// Offset of token row j of a (B, L, X, cols) tensor at (b, t0 + j, xi), or
// -1 past the chunk or L.
__device__ __forceinline__ long token_row(int j, int b, int t0, int xi, int X, int cols,
                                          const Dims& d) {
  const int t = t0 + j;
  return (j < d.Q && t < d.L) ? ((long(b) * d.L + t) * X + xi) * cols : -1L;
}

// The block's heads: h0 and their count, for blockIdx.y = group * nhb + k.
__device__ __forceinline__ void head_block(const Dims& d, int& grp, int& hb, int& h0, int& nh) {
  grp = blockIdx.y / d.nhb;
  hb = blockIdx.y - grp * d.nhb;
  h0 = grp * d.hpg + hb * kHeadBlock;
  nh = min(kHeadBlock, d.hpg - hb * kHeadBlock);
}

// s_i = sum_{r <= i} dt_r and cum_i = a s_i in f64 for the rows 2 lane and
// 2 lane + 1 of one warp, from their dt (d0, d1).  Returns cum of the last
// row (63) in every lane.
__device__ __forceinline__ double warp_cumsum(float d0, float d1, double a, double* s,
                                              double* cum) {
  const int lane = threadIdx.x & 31;
  const double v0 = d0;
  const double v1 = v0 + d1;
  double tot = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double n = shfl_up(tot, off);
    if (lane >= off) tot += n;
  }
  const double excl = tot - v1;
  s[2 * lane] = excl + v0;
  s[2 * lane + 1] = excl + v1;
  cum[2 * lane] = a * (excl + v0);
  cum[2 * lane + 1] = a * (excl + v1);
  return a * shfl_idx(tot, 31);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += shfl_xor(v, o);
  return v;
}

// The sum over the four lanes of a quad (t), the same in each.
__device__ __forceinline__ float quad_sum(float v) {
  v += shfl_xor(v, 1);
  v += shfl_xor(v, 2);
  return v;
}

// ---------------------------------------------------------------------------
// 1. backward chunk states
// ---------------------------------------------------------------------------
// rstate (B, H, nc, P, N) f32: sum_i exp(cum_i) dy_i[p] C_i[n] at [p][n].
// Per head: A = (exp(cum) o dy)^T (rows p, k = token), B = C (k = token);
// the warps take P / 16 row slabs by 8 / (P / 16) strided sets of n tiles.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_chunk_state(
    const T* __restrict__ dy, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ Cm, float* __restrict__ rstate, Dims d) {
  constexpr bool E = Route<T>::kExact;
  constexpr int PS = P / 16;        // row slabs of p
  constexpr int NW = kWarps / PS;   // warps of a slab
  constexpr int KT = (kMaxN / 8) / NW;
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  int grp, hb, h0, nh;
  head_block(d, grp, hb, h0, nh);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int ps = warp % PS;
  const int part = warp / PS;
  const int N = d.N;
  const int pN = N + Route<T>::kPadN;
  constexpr int pP = P + 8;  // read across k: 8 (f32) or 16 bytes (bf16) past a multiple of 128
  const int t0 = c * d.Q;
  const int yplane = kQ * pP;

  extern __shared__ __align__(16) unsigned char smem[];
  T* cs = reinterpret_cast<T*>(smem);  // [kQ][pN]: C rows
  T* ys = cs + kQ * pN;                // [2][kQ][pP]: dy rows of two heads
  double* s = reinterpret_cast<double*>(ys + 2 * yplane);  // [kHeadBlock][kQ]
  double* cum = s + kHeadBlock * kQ;                        // [kHeadBlock][kQ]
  float* ein = reinterpret_cast<float*>(cum + kHeadBlock * kQ);  // [kHeadBlock][kQ]

  copy_rows(cs, Cm, kQ, N, pN, [&](int i) { return token_row(i, b, t0, grp, d.G, N, d); });
  auto load_y = [&](int hh, int stage) {
    copy_rows(ys + stage * yplane, dy, kQ, P, pP,
              [&](int i) { return token_row(i, b, t0, h0 + hh, d.H, P, d); });
  };
  load_y(0, 0);
  cp_async_commit();
  if (warp < nh) {
    const int h = h0 + warp;
    float dv[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = 2 * lane + k;
      const int t = t0 + r;
      dv[k] = (r < d.Q && t < d.L) ? dt[(long(b) * d.L + t) * d.H + h] : 0.f;
    }
    warp_cumsum(dv[0], dv[1], a[h], s + warp * kQ, cum + warp * kQ);
    __syncwarp();
    ein[warp * kQ + 2 * lane] = expf(float(cum[warp * kQ + 2 * lane]));
    ein[warp * kQ + 2 * lane + 1] = expf(float(cum[warp * kQ + 2 * lane + 1]));
  }

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    if (hh + 1 < nh) load_y(hh + 1, (hh + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* y0 = ys + (hh & 1) * yplane;
    const float* e = ein + hh * kQ;
    float acc[KT][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < kQ / 8; ++kk) {
      const int i0 = 8 * kk + t4;
      // a0..a3 = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4] with A[p][i] =
      // exp(cum_i) dy_i[p]
      const T* yr = y0 + i0 * pP + 16 * ps + g;
      const float e0 = e[i0];
      const float e1 = e[i0 + 4];
      const Tf32A af = frag_a<false>(e0 * to_f(yr[0]), e0 * to_f(yr[8]), e1 * to_f(yr[4 * pP]),
                              e1 * to_f(yr[4 * pP + 8]));
      Tf32B bf[KT];
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const int nt = part + NW * k;
        const T* cr = cs + i0 * pN + 8 * (8 * nt < N ? nt : part) + g;
        bf[k] = frag_b<E>(to_f(cr[0]), to_f(cr[4 * pN]));
      }
      mma3<false, E>(acc, af, bf);
    }
    float* out = rstate + ((long(b) * d.H + h) * d.nc + c) * P * N;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int nt = part + NW * k;
      if (8 * nt < N) {
        const int p = 16 * ps + g;
        const int n = 8 * nt + 2 * t4;
        store2(out + p * N + n, acc[k][0], acc[k][1]);
        store2(out + (p + 8) * N + n, acc[k][2], acc[k][3]);
      }
    }
    __syncthreads();  // this stage is refilled two heads on
  }
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
// Shared memory of ssd_bwd_chunk, in the order the kernel lays it out.
template <typename T, int P>
struct ChunkSmem {
  int pN, pB, pP;
  static constexpr int pQ = kQ + 4;
  __host__ __device__ explicit ChunkSmem(int N)
      : pN(N + Route<T>::kPadN), pB(N + Route<T>::kPadK), pP(P + Route<T>::kPadK) {}
  __host__ __device__ size_t floats() const {  // rs, pt
    return size_t(P) * pN + size_t(kQ) * pQ;
  }
  __host__ __device__ size_t elems() const {  // cs, bs, two stages of x and dy, hs
    return size_t(kQ) * pN + size_t(kQ) * pB + 4 * size_t(kQ) * pP +
           size_t(Route<T>::KH) * P * pN;
  }
  __host__ __device__ size_t bytes() const {
    return floats() * 4 + elems() * sizeof(T) + (4 * kQ + kWarps) * sizeof(double) +
           (16 * kQ + 2 * kWarps) * sizeof(float);
  }
};

// x, dy (B,L,H,P), B and C (B,L,G,N) of type T; hp the KH pieces of the
// entering states (B, H, nc, KH, P, N) of type T; rstate R_c (B, H, nc, P,
// N) f32.  Writes dx (type T) and ddt (B,L,H) f32, the block's partials of
// dB and dC (B, L, G, nhb, N) f32 and the partials da_part, dD_part (B,H,nc)
// f64.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dv,
    const T* __restrict__ dy, const T* __restrict__ hp, const float* __restrict__ rstate,
    T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dB_part,
    float* __restrict__ dC_part, double* __restrict__ da_part, double* __restrict__ dD_part,
    Dims d) {
  constexpr bool E = Route<T>::kExact;
  constexpr int KH = Route<T>::KH;
  constexpr int PT = P / 16;  // dx: p tiles of 8 a warp, nt = q + 2 k
  constexpr int pQ = ChunkSmem<T, P>::pQ;
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  int grp, hb, h0, nh;
  head_block(d, grp, hb, h0, nh);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int st = warp & 3;  // row slab of G^T, dB and dC
  const int sx = 3 - st;    // row slab of dx
  const int q = warp >> 2;  // which of the slab's two warps
  const int N = d.N;
  const int NT = N / 8;
  const ChunkSmem<T, P> lay(N);
  const int pN = lay.pN;  // C, h, R: read across k
  const int pB = lay.pB;  // B: read along k (dx) and across it (dC)
  const int pP = lay.pP;  // x, dy
  const int t0 = c * d.Q;
  const int PN = P * N;
  const int xplane = kQ * pP;

  extern __shared__ __align__(16) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem);  // [P][pN]: R_c^T
  float* pt = rs + P * pN;                     // [kQ][pQ]: P^T = G^T o L^T
  T* cs = reinterpret_cast<T*>(pt + kQ * pQ);  // [kQ][pN]: C rows
  T* bs = cs + kQ * pN;                        // [kQ][pB]: B rows
  T* xy = bs + kQ * pB;                        // [2][x, dy][kQ][pP]
  T* hs = xy + 4 * xplane;                     // [KH][P][pN]: h_c^T pieces
  // Per head, [2] by the head's parity: warp 7 finishes head hh - 1 (step e)
  // during step a of head hh, and warp 0 makes the cumsum of head hh + 1 at
  // the end of head hh.
  double* s2 = reinterpret_cast<double*>(hs + KH * P * pN);  // [2][kQ] in-chunk cumsum of dt
  double* cum2 = s2 + 2 * kQ;                                // [2][kQ] a s
  double* hr = cum2 + 2 * kQ;                                // (kWarps) <h_c, R_c> partials
  float* dts2 = reinterpret_cast<float*>(hr + kWarps);       // [2][kQ]
  float* ein2 = dts2 + 2 * kQ;                               // [2][kQ] exp(cum_i)
  float* eout2 = ein2 + 2 * kQ;                              // [2][kQ] exp(cum_last - cum_j)
  float* upart = eout2 + 2 * kQ;  // [2][kQ]: exp(cum_i) C_i . h_c dy_i, by n half
  float* vpart = upart + 2 * kQ;  // [2][kQ]: exp(cum_last - cum_j) B_j . R_c x_j
  float* vcol = vpart + 2 * kQ;   // [2][kQ]: sum_i Z^T_ji, by half of the tiles
  float* colz = vcol + 2 * kQ;    // [4][kQ]: sum_j dt_j Z^T_ji over slab s's rows
  float* diag2 = colz + 4 * kQ;   // [2][kWarps]: sums of G_jj

  auto crow = [&](int j) { return token_row(j, b, t0, grp, d.G, N, d); };
  auto chunk_at = [&](int hh) { return (long(b) * d.H + h0 + hh) * d.nc + c; };
  auto load_xy = [&](int hh, int stage) {
    T* dst = xy + stage * 2 * xplane;
    auto row = [&](int j) { return token_row(j, b, t0, h0 + hh, d.H, P, d); };
    copy_rows(dst, x, kQ, P, pP, row);
    copy_rows(dst + xplane, dy, kQ, P, pP, row);
  };
  auto load_hr = [&](int hh) {
    const long hb0 = chunk_at(hh) * KH * PN;
    const long rb0 = chunk_at(hh) * PN;
    copy_rows(hs, hp, KH * P, N, pN, [&](int r) { return hb0 + long(r) * N; });
    copy_rows(rs, rstate, P, N, pN, [&](int r) { return rb0 + long(r) * N; });
  };
  // cp.async groups, in commit order: {C, B, x and dy of head 0}; then per
  // head hh {h_c and R_c of hh} after its first barrier and {x, dy of hh + 1}
  // (empty past the last head) after its second.  Each barrier waits for
  // every group issued before it.
  copy_rows(cs, Cm, kQ, N, pN, crow);
  copy_rows(bs, Bm, kQ, N, pB, crow);
  load_xy(0, 0);
  cp_async_commit();
  const int valid = min(d.Q, d.L - t0);  // rows of the chunk that hold tokens
  // dt of a head ahead, in warp 0's registers (rows 2 lane, 2 lane + 1)
  float dtn[2];
  auto fetch_dt = [&](int hh) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = 2 * lane + k;
      dtn[k] = r < valid ? dt[(long(b) * d.L + t0 + r) * d.H + h0 + hh] : 0.f;
    }
  };
  // In-chunk cumsum of dt and the row factors of head hh into its parity's
  // buffers, by warp 0: for head 0 before the loop, for head hh + 1 at the
  // end of head hh; the next head's first barrier publishes them.
  auto head_cumsum = [&](int hh) {
    const int par = hh & 1;
    dts2[par * kQ + 2 * lane] = dtn[0];
    dts2[par * kQ + 2 * lane + 1] = dtn[1];
    double* cum = cum2 + par * kQ;
    const double last = warp_cumsum(dtn[0], dtn[1], a[h0 + hh], s2 + par * kQ, cum);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const double cr = cum[2 * lane + k];  // written by this lane
      ein2[par * kQ + 2 * lane + k] = expf(float(cr));
      eout2[par * kQ + 2 * lane + k] = expf(float(last - cr));
    }
  };
  if (warp == 0) {
    fetch_dt(0);
    head_cumsum(0);
    if (nh > 1) fetch_dt(1);
  }

  // B.C^T of dx's slab: rows 16 sx + g (+ 8), columns 8 nt + 2 t4 (+ 1) of
  // the 8 tiles nt (those below the diagonal, nt < 2 sx, go unused), as the
  // accumulators hold them
  float bc[8][4];
  float dCs[kNT][4];  // the block's sum of dC over its heads, in head order
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) bc[k][e] = dCs[k][e] = 0.f;
  // The block's sums of dB and dC over its heads: this thread's elements
  // (rows 16 st + (g, g + 8), columns 8 (q + 2 k) + 2 t4 (+ 1)) of the
  // block's f32 partial, which only this thread reads and writes, head by
  // head in order (they stay in L2 between heads); f is the per-row factor.
  auto add_head = [&](float* part, const float (&acc)[kNT][4], const float (&f)[2], bool first) {
    float* row[2];
    float2 old[2][kNT];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {  // every load first, at valid addresses
      const int t = min(t0 + 16 * st + g + 8 * hf, d.L - 1);
      row[hf] = part + (((long(b) * d.L + t) * d.G + grp) * d.nhb + hb) * N;
#pragma unroll
      for (int k = 0; k < kNT; ++k) {
        const int nt = q + 2 * k;
        old[hf][k] = first ? make_float2(0.f, 0.f)
                           : load2(row[hf] + 8 * (nt < NT ? nt : q) + 2 * t4);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = 16 * st + g + 8 * hf;
      if (j < d.Q && t0 + j < d.L) {
#pragma unroll
        for (int k = 0; k < kNT; ++k) {
          const int nt = q + 2 * k;
          if (nt < NT)
            store2(row[hf] + 8 * nt + 2 * t4, old[hf][k].x + f[hf] * acc[k][2 * hf],
                   old[hf][k].y + f[hf] * acc[k][2 * hf + 1]);
        }
      }
    }
  };

  // e. for head hh, by warp 7 during step a of the next head: dcum, its
  // reverse cumsum, ddt and the partials of da and dD
  auto finish_head = [&](int hh) {
    const int par = hh & 1;
    const double* s = s2 + par * kQ;
    const double* cum = cum2 + par * kQ;
    const float* dts = dts2 + par * kQ;
    const int h = h0 + hh;
    double dc[2], dd_t[2];
    double wv = 0.0;  // sum_j dt_j exp(cum_last - cum_j) v_j
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = 2 * lane + k;
      double rowz = 0.0;
      for (int sl = 0; sl <= (i >> 4); ++sl) rowz += double(colz[sl * kQ + i]);
      const double vc = double(vcol[i]) + double(vcol[kQ + i]);
      const double eu = double(upart[i]) + double(upart[kQ + i]);
      const double ev = double(vpart[i]) + double(vpart[kQ + i]);
      const double dti = dts[i];
      dc[k] = rowz - dti * vc + eu - dti * ev;
      dd_t[k] = vc + ev;
      wv += dti * ev;
    }
    wv = warp_sum(wv);
    double hrs = 0.0, dd = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      hrs += hr[w];
      dd += double(diag2[par * kWarps + w]);
    }
    // the chunk's last row
    if (lane == 31) dc[1] += double(expf(float(cum[kQ - 1]))) * hrs + wv;
    // reverse inclusive cumsum: the pairs of the lanes above, then this pair
    const double pair = dc[0] + dc[1];
    double above = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double n = shfl_down(above, off);
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
      if (i < d.Q && t < d.L) ddt[(long(b) * d.L + t) * d.H + h] = float(dd_t[k] + ah * rev[k]);
    }
    da = warp_sum(da);
    if (lane == 0) {
      da_part[chunk_at(hh)] = da;
      dD_part[chunk_at(hh)] = dd;
    }
  };

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const int par = hh & 1;
    double* s = s2 + par * kQ;
    double* cum = cum2 + par * kQ;
    float* dts = dts2 + par * kQ;
    float* ein = ein2 + par * kQ;
    float* eout = eout2 + par * kQ;
    float* diag = diag2 + par * kWarps;
    const float dvh = Dv[h];
    cp_async_wait<0>();
    __syncthreads();  // x, dy and the cumsum of this head; the previous head is done
    load_hr(hh);
    cp_async_commit();
    if (hh == 0) {  // B.C^T: all 8 tiles (those below the diagonal go unused)
#pragma unroll 1
      for (int kk = 0; kk < N / 8; ++kk) {
        const T* br = bs + (16 * sx + g) * pB + 8 * kk + t4;
        const Tf32A af = frag_a<E>(to_f(br[0]), to_f(br[8 * pB]), to_f(br[4]),
                                   to_f(br[8 * pB + 4]));
#pragma unroll
        for (int gi = 0; gi < 2; ++gi) {  // tiles 4 gi .. 4 gi + 3
          Tf32B bf[4];
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const T* cr = cs + (8 * (4 * gi + k4) + g) * pN + 8 * kk + t4;
            bf[k4] = frag_b<E>(to_f(cr[0]), to_f(cr[4]));
          }
          mma3<E, E>(tiles4(bc, gi), af, bf);
        }
      }
    }
    const T* xs = xy + (hh & 1) * 2 * xplane;
    const T* ys = xs + xplane;
    if (warp == kWarps - 1 && hh > 0) finish_head(hh - 1);

    // a. G^T at rows 16 st + (g, g + 8), column tiles nt = 2 st + q + 2 m
    // (m < 4 - st: the causal ones); P^T = G^T o L^T (0 for i < j) to pt; the
    // diagonal's sum
    {
      float ga[4][4] = {}, ga2[4][4] = {};  // k steps of even and odd parity
#pragma unroll 1
      for (int k2 = 0; k2 < P / 8; k2 += 2) {
#pragma unroll
        for (int par2 = 0; par2 < 2; ++par2) {
          const int kk = k2 + par2;
          const T* xr = xs + (16 * st + g) * pP + 8 * kk + t4;
          const Tf32A af = frag_a<E>(to_f(xr[0]), to_f(xr[8 * pP]), to_f(xr[4]),
                                     to_f(xr[8 * pP + 4]));
          Tf32B bf[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {  // past the last tile: tile 7, dropped
            const T* yr = ys + (8 * min(2 * st + q + 2 * m, 7) + g) * pP + 8 * kk + t4;
            bf[m] = frag_b<E>(to_f(yr[0]), to_f(yr[4]));
          }
          mma3<E, E>(par2 ? ga2 : ga, af, bf);
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) ga[m][e] += ga2[m][e];
      float dsum = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int nt = 2 * st + q + 2 * m;
        if (nt < 8) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int j = 16 * st + g + 8 * hf;
            const int i = 8 * nt + 2 * t4;
            const double cj = cum[j];
            const float l0 = i >= j ? expf(float(cum[i] - cj)) : 0.f;
            const float l1 = i + 1 >= j ? expf(float(cum[i + 1] - cj)) : 0.f;
            store2(pt + j * pQ + i, ga[m][2 * hf] * l0, ga[m][2 * hf + 1] * l1);
            dsum += (i == j ? ga[m][2 * hf] : 0.f) + (i + 1 == j ? ga[m][2 * hf + 1] : 0.f);
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dsum += shfl_xor(dsum, o);
      if (lane == 0) diag[warp] = dsum;
    }
    cp_async_wait<0>();
    __syncthreads();  // P^T; h_c and R_c of this head
    if (hh + 1 < nh) load_xy(hh + 1, (hh + 1) & 1);
    cp_async_commit();

    // b. dC at rows i = 16 st + (g, g + 8), n tiles nt = q + 2 k: first
    // (exp(cum) o dy) h_c^T, whose dot with C_i is exp(cum_i) u_i, then (P o
    // dt) B over the causal k steps (tokens j <= i) into the same sums.
    // The warps of a q read the same elements of h_c, those of slab s in the
    // k steps kk = s (mod 4) also sum <h_c, R_c> over them.
    {
      float acc[kNT][4] = {};
      const float e0 = ein[16 * st + g];
      const float e1 = ein[16 * st + g + 8];
#pragma unroll 1
      for (int kk = 0; kk < P / 8; ++kk) {
        const T* yr = ys + (16 * st + g) * pP + 8 * kk + t4;
        const Tf32A af = frag_a<false>(e0 * to_f(yr[0]), e1 * to_f(yr[8 * pP]),
                                       e0 * to_f(yr[4]), e1 * to_f(yr[8 * pP + 4]));
#pragma unroll
        for (int gi = 0; gi < kNT / 4; ++gi) {  // tiles 4 gi .. 4 gi + 3
          Tf32B bf[4];
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const int nt = q + 2 * (4 * gi + k4);
            const int at = (8 * kk + t4) * pN + 8 * (nt < NT ? nt : q) + g;
            float h0v = 0.f, h1v = 0.f;
#pragma unroll
            for (int pc = 0; pc < KH; ++pc) {
              h0v += to_f(hs[pc * P * pN + at]);
              h1v += to_f(hs[pc * P * pN + at + 4 * pN]);
            }
            bf[k4] = frag_b<false>(h0v, h1v);
          }
          mma3<false, false>(tiles4(acc, gi), af, bf);
        }
      }
      {  // <h_c, R_c>: slab s's warps of a q over the rows p of the k steps kk = s (mod 4)
        float hk = 0.f;
        for (int kk = st; kk < P / 8; kk += 4) {
#pragma unroll
          for (int k = 0; k < kNT; ++k) {
            const int nt = q + 2 * k;
            if (nt < NT) {
              const int at = (8 * kk + t4) * pN + 8 * nt + g;
              float h0v = 0.f, h1v = 0.f;
#pragma unroll
              for (int pc = 0; pc < KH; ++pc) {
                h0v += to_f(hs[pc * P * pN + at]);
                h1v += to_f(hs[pc * P * pN + at + 4 * pN]);
              }
              hk = fmaf(h0v, rs[at], fmaf(h1v, rs[at + 4 * pN], hk));
            }
          }
        }
        const double hrv = warp_sum(double(hk));
        if (lane == 0) hr[warp] = hrv;
      }
      float u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int k = 0; k < kNT; ++k) {
        const int nt = q + 2 * k;
        if (nt < NT) {
          const int n = 8 * nt + 2 * t4;
          const float2 c0 = load2(cs + (16 * st + g) * pN + n);
          const float2 c1 = load2(cs + (16 * st + g + 8) * pN + n);
          u0 = fmaf(c0.x, acc[k][0], fmaf(c0.y, acc[k][1], u0));
          u1 = fmaf(c1.x, acc[k][2], fmaf(c1.y, acc[k][3], u1));
        }
      }
      u0 = quad_sum(u0);
      u1 = quad_sum(u1);
      if (t4 == 0) {
        upart[q * kQ + 16 * st + g] = u0;
        upart[q * kQ + 16 * st + g + 8] = u1;
      }
      // k slots t and t + 4 take tokens 8 kk + 2 t4 and 8 kk + 2 t4 + 1, in
      // A and B alike: conflict-free reads of P^T's columns and B's rows
#pragma unroll 1
      for (int kk = 0; kk < 2 * st + 2; ++kk) {
        const int j = 8 * kk + 2 * t4;
        const float* p0 = pt + j * pQ + 16 * st + g;
        const float d0 = dts[j];
        const float d1 = dts[j + 1];
        const Tf32A af = frag_a<false>(p0[0] * d0, p0[8] * d0, p0[pQ] * d1, p0[pQ + 8] * d1);
#pragma unroll
        for (int gi = 0; gi < kNT / 4; ++gi) {
          Tf32B bf[4];
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const int nt = q + 2 * (4 * gi + k4);
            const T* br = bs + j * pB + 8 * (nt < NT ? nt : q) + g;
            bf[k4] = frag_b<E>(to_f(br[0]), to_f(br[pB]));
          }
          mma3<false, E>(tiles4(acc, gi), af, bf);
        }
      }
#pragma unroll
      for (int k = 0; k < kNT; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) dCs[k][e] += acc[k][e];
    }

    // c. dx at rows j = 16 sx + (g, g + 8), p tiles nt = q + 2 k: K^T dy over
    // the causal k steps (tokens i >= j) with K^T = B.C^T o L^T from bc (the
    // accumulators of tile kk are the A fragment of a k step whose slots t
    // and t + 4 take tokens 8 kk + 2 t4 and 8 kk + 2 t4 + 1), then (exp(cum_last
    // - cum) o B) R_c.  Over this warp's half of the causal tiles, Z^T = P^T o
    // B.C^T: its row sums (vcol_j) and its dt_j-weighted column sums over the
    // slab (this slab's part of rowz_i)
    {
      float acc[PT][4] = {}, acc2[PT][4] = {};  // k steps of even and odd parity
      const int j0 = 16 * sx + g;
      const double cj0 = cum[j0];
      const double cj1 = cum[j0 + 8];
      const float dj0 = dts[j0];
      const float dj1 = dts[j0 + 8];
      float vp0 = 0.f, vp1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {  // K^T is 0 in the tiles kk < 2 sx
        const int i = 8 * kk + 2 * t4;
        const double ci0 = cum[i];
        const double ci1 = cum[i + 1];
        const float k0 = i >= j0 ? bc[kk][0] * expf(float(ci0 - cj0)) : 0.f;
        const float k1 = i + 1 >= j0 ? bc[kk][1] * expf(float(ci1 - cj0)) : 0.f;
        const float k2 = i >= j0 + 8 ? bc[kk][2] * expf(float(ci0 - cj1)) : 0.f;
        const float k3 = i + 1 >= j0 + 8 ? bc[kk][3] * expf(float(ci1 - cj1)) : 0.f;
        const Tf32A af = frag_a<false>(k0, k2, k1, k3);
        Tf32B bf[PT];
#pragma unroll
        for (int k = 0; k < PT; ++k) {
          const T* yr = ys + i * pP + 8 * (q + 2 * k) + g;
          bf[k] = frag_b<E>(to_f(yr[0]), to_f(yr[pP]));
        }
        mma3<false, E>(kk & 1 ? acc2 : acc, af, bf);
        if (kk >= 2 * sx && ((kk - 2 * sx) & 1) == q) {
          const float2 p0 = load2(pt + j0 * pQ + i);
          const float2 p1 = load2(pt + (j0 + 8) * pQ + i);
          const float z0 = p0.x * bc[kk][0], z1 = p0.y * bc[kk][1];
          const float z2 = p1.x * bc[kk][2], z3 = p1.y * bc[kk][3];
          vp0 += z0 + z1;
          vp1 += z2 + z3;
          // this warp's rows of the columns i, i + 1, weighted by dt_j
          float c0 = fmaf(dj1, z2, dj0 * z0);
          float c1 = fmaf(dj1, z3, dj0 * z1);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            c0 += shfl_xor(c0, o);
            c1 += shfl_xor(c1, o);
          }
          if (g == 0) store2(colz + sx * kQ + i, c0, c1);
        }
      }
      vp0 = quad_sum(vp0);
      vp1 = quad_sum(vp1);
      if (t4 == 0) {
        vcol[q * kQ + j0] = vp0;
        vcol[q * kQ + j0 + 8] = vp1;
      }
      const float w0 = eout[j0];
      const float w1 = eout[j0 + 8];
#pragma unroll 1
      for (int k2 = 0; k2 < N / 8; k2 += 2) {
#pragma unroll
        for (int par2 = 0; par2 < 2; ++par2) {
          // slots t and t + 4 take n = 8 kk + 2 t4 and 8 kk + 2 t4 + 1
          const int n = 8 * (k2 + par2) + 2 * t4;
          const float2 b0 = load2(bs + j0 * pB + n);
          const float2 b1 = load2(bs + (j0 + 8) * pB + n);
          const Tf32A af = frag_a<false>(w0 * b0.x, w1 * b1.x, w0 * b0.y, w1 * b1.y);
          Tf32B bf[PT];
#pragma unroll
          for (int k = 0; k < PT; ++k) {
            const float2 r = load2(rs + (8 * (q + 2 * k) + g) * pN + n);
            bf[k] = frag_b<false>(r.x, r.y);
          }
          mma3<false, false>(par2 ? acc2 : acc, af, bf);
        }
      }
#pragma unroll
      for (int k = 0; k < PT; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][e] += acc2[k][e];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = j0 + 8 * hf;
        const int t = t0 + j;
        if (j < d.Q && t < d.L) {
          const float dtj = dts[j];
          T* row = dx + ((long(b) * d.L + t) * d.H + h) * P;
#pragma unroll
          for (int k = 0; k < PT; ++k) {
            const int p = 8 * (q + 2 * k) + 2 * t4;
            const float2 yv = load2(ys + j * pP + p);
            store2(row + p, fmaf(dtj, acc[k][2 * hf], dvh * yv.x),
                   fmaf(dtj, acc[k][2 * hf + 1], dvh * yv.y));
          }
        }
      }
    }

    // d. dB at rows j = 16 st + (g, g + 8), n tiles nt = q + 2 k: first
    // (exp(cum_last - cum) o x) R_c^T, whose dot with B_j is exp(cum_last -
    // cum_j) v_j, then P^T C over the causal k steps (tokens i >= j)
    {
      float acc[kNT][4] = {};
      const int j0 = 16 * st + g;
      const float w0 = eout[j0];
      const float w1 = eout[j0 + 8];
#pragma unroll 1
      for (int kk = 0; kk < P / 8; ++kk) {
        const T* xr = xs + j0 * pP + 8 * kk + t4;
        const Tf32A af = frag_a<false>(w0 * to_f(xr[0]), w1 * to_f(xr[8 * pP]),
                                       w0 * to_f(xr[4]), w1 * to_f(xr[8 * pP + 4]));
#pragma unroll
        for (int gi = 0; gi < kNT / 4; ++gi) {
          Tf32B bf[4];
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const int nt = q + 2 * (4 * gi + k4);
            const float* rr = rs + (8 * kk + t4) * pN + 8 * (nt < NT ? nt : q) + g;
            bf[k4] = frag_b<false>(rr[0], rr[4 * pN]);
          }
          mma3<false, false>(tiles4(acc, gi), af, bf);
        }
      }
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int k = 0; k < kNT; ++k) {
        const int nt = q + 2 * k;
        if (nt < NT) {
          const int n = 8 * nt + 2 * t4;
          const float2 b0 = load2(bs + j0 * pB + n);
          const float2 b1 = load2(bs + (j0 + 8) * pB + n);
          v0 = fmaf(b0.x, acc[k][0], fmaf(b0.y, acc[k][1], v0));
          v1 = fmaf(b1.x, acc[k][2], fmaf(b1.y, acc[k][3], v1));
        }
      }
      v0 = quad_sum(v0);
      v1 = quad_sum(v1);
      if (t4 == 0) {
        vpart[q * kQ + j0] = v0;
        vpart[q * kQ + j0 + 8] = v1;
      }
#pragma unroll 1
      for (int kk = 2 * st; kk < 8; ++kk) {
        const float* p0 = pt + j0 * pQ + 8 * kk + t4;
        const Tf32A af = frag_a<false>(p0[0], p0[8 * pQ], p0[4], p0[8 * pQ + 4]);
#pragma unroll
        for (int gi = 0; gi < kNT / 4; ++gi) {
          Tf32B bf[4];
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const int nt = q + 2 * (4 * gi + k4);
            const T* cr = cs + (8 * kk + t4) * pN + 8 * (nt < NT ? nt : q) + g;
            bf[k4] = frag_b<E>(to_f(cr[0]), to_f(cr[4 * pN]));
          }
          mma3<false, E>(tiles4(acc, gi), af, bf);
        }
      }
      add_head(dB_part, acc, {dts[j0], dts[j0 + 8]}, hh == 0);
    }
    if (warp == 0 && hh + 1 < nh) {
      head_cumsum(hh + 1);
      if (hh + 2 < nh) fetch_dt(hh + 2);
    }
  }
  add_head(dC_part, dCs, {1.f, 1.f}, true);
  __syncthreads();  // the last head's row partials
  if (warp == kWarps - 1) finish_head(nh - 1);
}

// ---------------------------------------------------------------------------
// 4. reductions
// ---------------------------------------------------------------------------
// out (rows, G, N) of type T = the sum over the nhb head blocks of each group
// of part (rows, G * nhb, N) f32, in order.
template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_group_sum(const float* __restrict__ part,
                                                         T* __restrict__ out, long rows, int G,
                                                         int nhb, int N) {
  const long e = long(blockIdx.x) * blockDim.x + threadIdx.x;
  const long GN = long(G) * N;
  if (e >= rows * GN) return;
  const long row = e / GN;
  const int gn = int(e - row * GN);
  const float* src = part + (row * G * nhb + long(gn / N) * nhb) * N + gn % N;
  float acc = 0.f;
  for (int k = 0; k < nhb; ++k) acc += src[long(k) * N];
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

template <typename T, int P>
size_t state_smem(int N) {
  return (size_t(kQ) * (N + Route<T>::kPadN) + 2 * size_t(kQ) * (P + 8)) * sizeof(T) +
         2 * size_t(kHeadBlock) * kQ * sizeof(double) + size_t(kHeadBlock) * kQ * sizeof(float);
}

struct Args {
  const void *x, *dt, *a, *Bm, *Cm, *D, *dy, *dh, *hp, *cq;
  void *dx, *ddt, *da, *dB, *dC, *dD, *rstate, *dB_part, *dC_part, *da_part, *dD_part;
};

template <typename T, int P>
cudaError_t launch(const Args& g, int Bsz, int L, int H, int G, int N, int Q,
                   cudaStream_t stream) {
  static unsigned ready_state = 0, ready_chunk = 0;
  const int nc = (L + Q - 1) / Q;
  const int hpg = H / G;
  const int nhb = (hpg + kHeadBlock - 1) / kHeadBlock;
  const Dims d{L, H, G, N, Q, nc, hpg, nhb};
  auto k1 = ssd_bwd_chunk_state<T, P>;
  auto k3 = ssd_bwd_chunk<T, P>;
  const size_t s1 = state_smem<T, P>(N);
  const size_t s3 = ChunkSmem<T, P>(N).bytes();
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
  const dim3 grid(nc, G * nhb, Bsz);
  k1<<<grid, kThreads, s1, stream>>>(dy, dt, a, Cm, rstate, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int PN = P * N;
  ssd_bwd_state_pass<<<dim3((PN + 255) / 256, Bsz * H), 256, 0, stream>>>(
      rstate, static_cast<const float*>(g.cq), static_cast<const float*>(g.dh), nc, N, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k3<<<grid, kThreads, s3, stream>>>(
      x, dt, a, static_cast<const T*>(g.Bm), Cm, static_cast<const float*>(g.D), dy,
      static_cast<const T*>(g.hp), rstate, static_cast<T*>(g.dx), static_cast<float*>(g.ddt),
      static_cast<float*>(g.dB_part), static_cast<float*>(g.dC_part),
      static_cast<double*>(g.da_part), static_cast<double*>(g.dD_part), d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long rows = long(Bsz) * L;
  const unsigned blocks = unsigned((rows * G * N + 255) / 256);
  ssd_bwd_group_sum<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(g.dB_part),
                                                   static_cast<T*>(g.dB), rows, G, nhb, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_group_sum<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(g.dC_part),
                                                   static_cast<T*>(g.dC), rows, G, nhb, N);
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
// min(L, 64)), nc = ceil(L / Q).  Workspace: rstate (B,H,nc,P,N) f32,
// dB_part and dC_part (B,L,G,nhb,N) f32 with nhb = ceil(H / G / 8) head
// blocks a group, da_part and dD_part (B,H,nc) f64.  All contiguous, x, dy,
// B, C, hp, rstate 16-byte aligned.  Runs the kernels on `stream`; returns
// the first cudaError_t.
int ssd_scan_bwd(const void* x, const void* dt, const void* a, const void* Bm, const void* Cm,
                 const void* D, const void* dy, const void* dh, const void* hp, const void* cq,
                 void* dx, void* ddt, void* da, void* dB, void* dC, void* dD, void* rstate,
                 void* dB_part, void* dC_part, void* da_part, void* dD_part, int Bsz, int L,
                 int H, int G, int P, int N, int Q, int dtype, void* stream) {
  if (G <= 0 || H % G || N % 16 || N < 16 || N > kMaxN || Q < 1 || Q > kQ || Q > L)
    return cudaErrorInvalidValue;
  const Args g{x, dt, a, Bm, Cm, D, dy, dh, hp, cq,
               dx, ddt, da, dB, dC, dD, rstate, dB_part, dC_part, da_part, dD_part};
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
