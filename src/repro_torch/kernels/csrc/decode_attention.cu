// Split-K flash decoding (one new token per sequence against a deep KV
// cache) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py::
// _decode_kernel (pallas_call in decode_attention_fwd) and the jnp merge after
// it (kernel.py:156-161).  As there, q is scaled by 1/sqrt(D) in f32 and
// rounded to the cache type before the dot, dots accumulate in f32, and key
// kp of sequence b is visible when kp < lengths[b] and, with a window,
// kp >= lengths[b] - window.
//
// Bound on the card: bytes.  Each visible key's K and V rows are read once
// (2 * D * sizeof(T) bytes per key and kv head) against 3.35 TB/s of HBM on an
// H100 SXM; the math is a few FLOPs per byte.  The design keeps every SM
// streaming:
//
// * The split is of the visible keys, made on the card.  Block (split, unit,
//   b) reads lengths[b], takes the visible range [lo, hi) of its sequence and
//   walks an equal share of its 64-key tiles (split_range; the tiles start at
//   lo, so no tile holds a key below the window).  The host picks the number
//   of splits from S, the number of (b, kv head, row block) units and the SM
//   count only, so it never reads lengths.
// * Every warp works.  A tile's 64 keys are split over the 4 warps, 16 each;
//   each warp keeps its own online-softmax state (m, l, acc) for the block's
//   rows, and the block merges the 4 states in shared memory in warp order.
//   The rows of a block are R of the G query heads of one kv head:
//   - R = 16 (bf16, G >= 8): S = Q K^T and acc += P V on the tensor cores
//     (mma.sync m16n8k16, f32 accumulate; P is rounded to bf16 as the TPU
//     kernel rounds it to the cache type), Q's fragments held in registers,
//     P fed from the S accumulators as the A operand.  wgmma's 64-row minimum
//     would waste 4x or more at G <= 16.
//   - R in {1, 2, 4, 8} (f32, or bf16 with G < 8): CUDA-core dots with lanes
//     across D (ceil(D / 32) columns a lane; at D = 112 lanes 28-31 hold
//     none) and a butterfly sum per key; lane j keeps key j's score.
//   G above R takes several row blocks (units) per kv head.
// * Loads overlap math: a 3-stage ring of K/V tiles filled by 16-byte
//   cp.async copies; rows past the split's end are zero-filled by the copy.
// * One launch when one split suffices: the block writes the output.
//   Otherwise each block writes its partial (acc, m, l) in f32 to a
//   workspace, and a second small kernel (one block per q head and
//   sequence) merges the splits in a fixed order.  No atomics: two runs are
//   bit-equal.
//
// Supported: T in {f32, bf16}, D in {32, 64, 112, 128}, G = Hq / Hkv <= 64.
#include <type_traits>

#include "warp_mma.cuh"

using namespace warp_mma;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;                       // keys per tile
constexpr int kWarpKeys = kTile / kWarps;       // keys per warp and tile
constexpr int kStages = 3;                      // K/V tiles in flight
constexpr float kNegInf = -1e30f;               // finite, as in the TPU kernel
constexpr int kMaxSplits = 128;                 // the merge keeps a weight per split

template <typename T, int D>
__host__ __device__ constexpr int pitch() {
  return D + 16 / int(sizeof(T));  // 16 bytes of padding per row
}

template <typename T, int D>
__host__ __device__ constexpr size_t ring_bytes() {
  return size_t(kStages) * 2 * kTile * pitch<T, D>() * sizeof(T);
}

// Scratch of the in-block merge, laid over the ring once it is drained.
template <int D, int R>
__host__ __device__ constexpr size_t merge_bytes() {
  return size_t(kWarps) * R * (D + 2) * sizeof(float);
}

template <typename T, int D, int R>
__host__ __device__ constexpr size_t smem_bytes() {
  return ring_bytes<T, D>() + (R == 16 ? size_t(16) * pitch<T, D>() * sizeof(T) : 0);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  float* ws;  // partials: acc (units, ns, R, D), then m and l (units, ns, R)
  void* out;
  int S, Hkv, G, nrc, ns, window;
  float scale;
};

// Keys [k0, k1) of split sp: an equal share of the 64-key tiles that tile
// the visible range [lo, hi) from lo.  Empty (k0 == k1) when the range has
// fewer tiles than splits.  ops.split_range is its twin.
__device__ __forceinline__ void split_range(int length, int S, int window, int ns, int sp,
                                            int& k0, int& k1) {
  const int hi = min(length, S);
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int ntiles = (max(hi - lo, 0) + kTile - 1) / kTile;
  const int per = (ntiles + ns - 1) / ns;
  const int t0 = min(sp * per, ntiles);
  const int t1 = min(t0 + per, ntiles);
  k0 = lo + t0 * kTile;
  k1 = t1 > t0 ? min(lo + t1 * kTile, hi) : k0;
}

// Keys k0 .. k0 + 63 of one kv head into a ring stage; keys at or past k1
// are zero-filled (and masked later).
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kg, const T* vg, long stride,
                                          int k0, int k1) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = D / E;
  constexpr int P = pitch<T, D>();
  for (int i = threadIdx.x; i < kTile * CPR; i += kThreads) {
    const int r = i / CPR;
    const int c = (i % CPR) * E;
    const bool ok = k0 + r < k1;
    const long off = long(ok ? k0 + r : k0) * stride + c;
    cp_async16(ks + r * P + c, kg + off, ok);
    cp_async16(vs + r * P + c, vg + off, ok);
  }
}

// Columns of D a lane holds on the CUDA-core route and in the split merge:
// lane l takes columns l DL .. l DL + DL - 1 below D.
template <int D>
__host__ __device__ constexpr int lane_cols() {
  return (D + 31) / 32;
}

// ---------------------------------------------------------------------------
// CUDA-core route: R rows, lanes across D (DL = ceil(D / 32) columns a lane,
// masked at D).
// ---------------------------------------------------------------------------
template <typename T, int D, int R>
struct CoreState {
  static constexpr int DL = lane_cols<D>();
  float q[R][DL];
  float acc[R][DL];
  float m[R];
  float l[R];

  __device__ void init(const T* qg, int rows, float scale, unsigned char*) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        const int d = lane * DL + e;
        const float x = r < rows && d < D ? to_f(qg[r * D + d]) * scale : 0.f;
        q[r][e] = to_f(from_f<T>(x));
        acc[r][e] = 0.f;
      }
      m[r] = kNegInf;
      l[r] = 0.f;
    }
  }

  // The warp's 16 keys kb .. kb + 15 (rows of ks / vs), visible below k1.
  __device__ void step(const T* ks, const T* vs, int kb, int k1) {
    constexpr int P = pitch<T, D>();
    const int lane = threadIdx.x & 31;
    float s_own[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s_own[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kWarpKeys; ++j) {
      float kv[DL];
#pragma unroll
      for (int e = 0; e < DL; ++e)
        kv[e] = lane * DL + e < D ? to_f(ks[j * P + lane * DL + e]) : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < DL; ++e) part = fmaf(q[r][e], kv[e], part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == j) s_own[r] = part;
      }
    }
    const bool ok = lane < kWarpKeys && kb + lane < k1;
    float p_own[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float sv = ok ? s_own[r] : kNegInf;
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float p = ok ? expf(sv - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
      p_own[r] = p;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kWarpKeys; ++j) {
      float vv[DL];
#pragma unroll
      for (int e = 0; e < DL; ++e)
        vv[e] = lane * DL + e < D ? to_f(vs[j * P + lane * DL + e]) : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p_own[r], j);
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[r][e] = fmaf(pj, vv[e], acc[r][e]);
      }
    }
  }

  // This warp's state into the merge scratch: m, l (kWarps, R), acc
  // (kWarps, R, D + 2).
  __device__ void store(float* ms, float* ls, float* os, int warp) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < DL; ++e)
        if (lane * DL + e < D) os[(warp * R + r) * (D + 2) + lane * DL + e] = acc[r][e];
      if (lane == 0) {
        ms[warp * R + r] = m[r];
        ls[warp * R + r] = l[r];
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Tensor-core route (bf16): 16 rows; per warp S (16 x 16 keys) and acc
// (16 x D) in mma.sync accumulators.  Thread (g, t) holds rows g and g + 8.
// ---------------------------------------------------------------------------
template <int D>
struct MmaState {
  static constexpr int NT = D / 8;  // n8 tiles of acc
  uint32_t qa[D / 16][4];
  float acc[NT][4];
  float m[2];
  float l[2];

  // Q (16 rows, scaled, rounded) goes through shared memory once to take the
  // A-fragment layout.
  __device__ void init(const bf16* qg, int rows, float scale, unsigned char* qsmem) {
    constexpr int P = pitch<bf16, D>();
    bf16* qs = reinterpret_cast<bf16*>(qsmem);
    for (int i = threadIdx.x; i < 16 * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      qs[r * P + d] = __float2bfloat16(r < rows ? to_f(qg[r * D + d]) * scale : 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) load_a(qa[kk], qs, P, 0, kk * 16);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  __device__ void step(const bf16* ks, const bf16* vs, int kb, int k1) {
    constexpr int P = pitch<bf16, D>();
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, ks, P, nt * 8, kk * 16);
        mma(s[nt], qa[kk], b0, b1);
      }
    }
    // online softmax: element e of tile nt is row g + 8 (e / 2), key
    // nt * 8 + 2 t + (e % 2)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kb + nt * 8 + 2 * t + (e & 1) < k1;
        s[nt][e] = ok ? s[nt][e] : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
    float m_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new[h]);
      m[h] = m_new[h];
    }
    float sum[2] = {0.f, 0.f};
    float p[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kb + nt * 8 + 2 * t + (e & 1) < k1;
        p[nt][e] = ok ? expf(s[nt][e] - m_new[e >> 1]) : 0.f;
        sum[e >> 1] += p[nt][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
    const uint32_t pa[4] = {pack_f(p[0][0], p[0][1]), pack_f(p[0][2], p[0][3]),
                            pack_f(p[1][0], p[1][1]), pack_f(p[1][2], p[1][3])};
    // acc += P V: B[k = key][n = d] = V[key][d], gathered in pairs of keys
    const unsigned short* vu = reinterpret_cast<const unsigned short*>(vs);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int d = nt * 8 + g;
      const uint32_t b0 = uint32_t(vu[(2 * t) * P + d]) | (uint32_t(vu[(2 * t + 1) * P + d]) << 16);
      const uint32_t b1 =
          uint32_t(vu[(2 * t + 8) * P + d]) | (uint32_t(vu[(2 * t + 9) * P + d]) << 16);
      mma(acc[nt], pa, b0, b1);
    }
  }

  __device__ void store(float* ms, float* ls, float* os, int warp) const {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        os[(warp * 16 + g + 8 * (e >> 1)) * (D + 2) + nt * 8 + 2 * t + (e & 1)] = acc[nt][e];
    if (t == 0) {
      ms[warp * 16 + g] = m[0];
      ms[warp * 16 + g + 8] = m[1];
      ls[warp * 16 + g] = l[0];
      ls[warp * 16 + g + 8] = l[1];
    }
  }
};

template <typename T, int D, int R>
using State = typename std::conditional<R == 16, MmaState<D>, CoreState<T, D, R>>::type;

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads) decode_kernel(Args a) {
  static_assert(R != 16 || std::is_same<T, bf16>::value, "the tensor-core route is bf16");
  static_assert(merge_bytes<D, R>() + 2 * kWarps * R * sizeof(float) <= ring_bytes<T, D>(),
                "the merge scratch must fit in the drained ring");
  constexpr int P = pitch<T, D>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int sp = blockIdx.x;
  const int unit = blockIdx.y;  // = hk * nrc + rc
  const int b = blockIdx.z;
  const int hk = unit / a.nrc;
  const int rc = unit % a.nrc;
  const int warp = threadIdx.x >> 5;
  const int tid = threadIdx.x;

  int k0, k1;
  split_range(a.lengths[b], a.S, a.window, a.ns, sp, k0, k1);
  const int ntiles = (k1 - k0 + kTile - 1) / kTile;
  const long stride = long(a.Hkv) * D;
  const T* kg = static_cast<const T*>(a.k) + (long(b) * a.S * a.Hkv + hk) * D;
  const T* vg = static_cast<const T*>(a.v) + (long(b) * a.S * a.Hkv + hk) * D;
  const int g0 = rc * R;
  const int rows = min(R, a.G - g0);
  const T* qg = static_cast<const T*>(a.q) + (long(b) * a.Hkv * a.G + long(hk) * a.G + g0) * D;

  auto stage_k = [&](int s) { return ring + (2 * s) * kTile * P; };
  auto stage_v = [&](int s) { return ring + (2 * s + 1) * kTile * P; };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile<T, D>(stage_k(s), stage_v(s), kg, vg, stride, k0 + s * kTile, k1);
    cp_async_commit();
  }
  State<T, D, R> st;
  st.init(qg, rows, a.scale, smem + ring_bytes<T, D>());

  for (int t = 0; t < ntiles; ++t) {
    const int tn = t + kStages - 1;
    if (tn < ntiles)
      load_tile<T, D>(stage_k(tn % kStages), stage_v(tn % kStages), kg, vg, stride,
                      k0 + tn * kTile, k1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int s = t % kStages;
    st.step(stage_k(s) + warp * kWarpKeys * P, stage_v(s) + warp * kWarpKeys * P,
            k0 + t * kTile + warp * kWarpKeys, k1);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the warps' states in warp order
  float* ms = reinterpret_cast<float*>(smem);
  float* ls = ms + kWarps * R;
  float* os = ls + kWarps * R;
  st.store(ms, ls, os, warp);
  __syncthreads();

  const long units = long(gridDim.z) * gridDim.y;
  const long ug = long(b) * gridDim.y + unit;
  T* out = static_cast<T*>(a.out) + (long(b) * a.Hkv * a.G + long(hk) * a.G + g0) * D;
  float* wacc = a.ws + (ug * a.ns) * R * D;
  float* wm = a.ws + units * a.ns * R * D;
  float* wl = wm + units * a.ns * R;
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ms[w * R + r]);
    float o = 0.f;
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(ms[w * R + r] - mx);
      o += os[(w * R + r) * (D + 2) + d] * f;
      lt += ls[w * R + r] * f;
    }
    if (a.ns == 1) {
      out[r * D + d] = from_f<T>(o / fmaxf(lt, 1e-30f));
    } else {
      wacc[(long(sp) * R + r) * D + d] = o;
      if (d == 0) {
        wm[ug * a.ns * R + sp * R + r] = mx;
        wl[ug * a.ns * R + sp * R + r] = lt;
      }
    }
  }
}

// The splits' partials of one (q head, batch) merged by one block of
// kMergeWarps warps: m = max_s m_s, then sum_s acc_s exp(m_s - m) / sum_s l_s
// exp(m_s - m).  Threads take the splits in strides for m, the weights and
// l; warp w sums acc over the splits s = w mod kMergeWarps, ceil(D / 32)
// columns a lane (masked at D); the warps' partial sums are added in warp
// order.  Every sum has a fixed order, so two runs are bit-equal.
constexpr int kMergeWarps = 4;
template <typename T, int D, int R>
__global__ void __launch_bounds__(kMergeWarps * 32) decode_merge_kernel(
    const float* __restrict__ ws, T* __restrict__ out, int Hkv, int G, int nrc, int ns,
    int units) {
  constexpr int DL = lane_cols<D>();
  __shared__ float wts[kMaxSplits];
  __shared__ float red[kMergeWarps];
  __shared__ float part[kMergeWarps][D];
  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hk = hq / G;
  const int rc = (hq % G) / R;
  const int r = (hq % G) % R;
  const long ug = (long(b) * Hkv + hk) * nrc + rc;
  const float* acc = ws + ug * ns * R * D + r * D + lane * DL;
  const float* m = ws + long(units) * ns * R * D + ug * ns * R + r;
  const float* l = m + long(units) * ns * R;
  auto block_reduce = [&](float v, bool is_max) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = is_max ? fmaxf(v, o) : v + o;
    }
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = red[0];
#pragma unroll
    for (int w = 1; w < kMergeWarps; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
    return v;
  };
  float mx = kNegInf;
  for (int s = tid; s < ns; s += kMergeWarps * 32) mx = fmaxf(mx, m[s * R]);
  mx = block_reduce(mx, true);
  float lt = 0.f;
  for (int s = tid; s < ns; s += kMergeWarps * 32) {
    const float f = expf(m[s * R] - mx);
    wts[s] = f;
    lt += l[s * R] * f;
  }
  lt = fmaxf(block_reduce(lt, false), 1e-30f);  // its barriers also publish wts
  float o[DL] = {};
#pragma unroll 4
  for (int s = warp; s < ns; s += kMergeWarps) {
    const float f = wts[s];
    const float* v = acc + long(s) * R * D;
#pragma unroll
    for (int e = 0; e < DL; ++e)
      if (lane * DL + e < D) o[e] = fmaf(v[e], f, o[e]);
  }
#pragma unroll
  for (int e = 0; e < DL; ++e)
    if (lane * DL + e < D) part[warp][lane * DL + e] = o[e];
  __syncthreads();
  if (warp == 0) {
    T* dst = out + (long(b) * Hkv * G + hq) * D + lane * DL;
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      if (lane * DL + e >= D) break;
      float sum = part[0][lane * DL + e];
#pragma unroll
      for (int w = 1; w < kMergeWarps; ++w) sum += part[w][lane * DL + e];
      dst[e] = from_f<T>(sum / lt);
    }
  }
}

template <typename T, int D, int R>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  static unsigned ready = 0;
  auto kernel = decode_kernel<T, D, R>;
  constexpr size_t smem = smem_bytes<T, D, R>();
  static_assert(smem <= size_t(kMaxSmem), "shared memory");
  cudaError_t err = set_smem_once(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.ns, a.Hkv * a.nrc, B), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.ns == 1) return err;
  decode_merge_kernel<T, D, R><<<dim3(a.Hkv * a.G, B), kMergeWarps * 32, 0, stream>>>(
      a.ws, static_cast<T*>(a.out), a.Hkv, a.G, a.nrc, a.ns, B * a.Hkv * a.nrc);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_rows(int R, const Args& a, int B, cudaStream_t s) {
  switch (R) {
    case 1: return launch<T, D, 1>(a, B, s);
    case 2: return launch<T, D, 2>(a, B, s);
    case 4: return launch<T, D, 4>(a, B, s);
    case 8: return launch<T, D, 8>(a, B, s);
    case 16:
      if constexpr (std::is_same<T, bf16>::value) return launch<T, D, 16>(a, B, s);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(int D, int R, const Args& a, int B, cudaStream_t s) {
  switch (D) {
    case 32: return by_rows<T, 32>(R, a, B, s);
    case 64: return by_rows<T, 64>(R, a, B, s);
    case 112: return by_rows<T, 112>(R, a, B, s);
    case 128: return by_rows<T, 128>(R, a, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B,Hq,D); k and v caches (B,S,Hkv,D); lengths (B,) int32; out (B,Hq,D).
// All contiguous; q, caches and out of one type (dtype 0 = f32, 1 = bf16).
// R rows per block (1, 2, 4, 8, or 16 for the bf16 tensor-core route),
// nrc = ceil(G / R) row blocks per kv head; num_splits (<= 128) splits of
// each unit's visible keys.  ws holds (B * Hkv * nrc) * num_splits * R * (D + 2) floats
// (not touched when num_splits is 1).  Returns the first cudaError_t of the
// launch and, with more than one split, the merge's launch.
int decode_attention_fwd(const void* q, const void* k, const void* v, const void* lengths,
                         void* ws, void* out, int B, int S, int Hq, int Hkv,
                         int D, int dtype, int R, int num_splits, int window, float scale,
                         void* stream) {
  if (Hkv <= 0 || Hq % Hkv || num_splits < 1 || num_splits > kMaxSplits || R < 1)
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if (G > 64) return cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const int*>(lengths), static_cast<float*>(ws), out, S, Hkv, G,
         (G + R - 1) / R, num_splits, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_dim<float>(D, R, a, B, s);
  if (dtype == 1) return by_dim<bf16>(D, R, a, B, s);
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
