// Shared building blocks of the f32 flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): one online-softmax step of a
// (rows x BK) tile of queries against BK keys, with the running (m, l, acc) in f32 shared memory.
//
// A block has kWarps warps. Rows are handled in groups of 16, and a row group
// belongs to one warp for the whole kernel (warp w owns groups w, w + kWarps,
// ...), so the softmax and P.V phases of a group need only __syncwarp(); the
// block synchronises only around the K/V tile loads.
//
// bf16 operands go through the tensor cores with the WMMA API (16x16x16
// fragments, f32 accumulate).  f32 operands take a scalar FMA path, so f32
// keeps full f32 products (the TPU kernel's f32 dots) instead of TF32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// As in the TPU kernels: a large finite "minus infinity" keeps fully masked
// rows free of inf - inf NaNs.
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // opt-in dynamic shared memory of one sm_90 block

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// Shared-memory layout for `rows` query rows, BK keys and head dim D.
// Pitches: bf16 tiles pad by 8 elements (WMMA wants a multiple of 8 and
// 32-byte aligned fragments); f32 tiles pad by 1 so the scalar path reads
// columns without bank conflicts.  In the f32 path P overwrites S in place.
template <typename T, int D, int BK>
struct Layout {
  static constexpr int LQ = kIsBf16<T> ? D + 8 : D + 1;  // Q, K, V
  static constexpr int LS = BK + 4;                          // S (f32)
  static constexpr int LP = kIsBf16<T> ? BK + 8 : LS;     // P
  static constexpr int LO = D + 4;                           // acc (f32)

  static __host__ __device__ constexpr size_t align(size_t n) { return (n + 127) / 128 * 128; }
  static __host__ __device__ constexpr size_t o_bytes(int rows) { return align(size_t(rows) * LO * 4); }
  static __host__ __device__ constexpr size_t s_bytes(int rows) { return align(size_t(rows) * LS * 4); }
  static __host__ __device__ constexpr size_t ml_bytes(int rows) { return align(size_t(rows) * 4); }
  static __host__ __device__ constexpr size_t q_bytes(int rows) { return align(size_t(rows) * LQ * sizeof(T)); }
  static __host__ __device__ constexpr size_t kv_bytes() { return align(size_t(BK) * LQ * sizeof(T)); }
  static __host__ __device__ constexpr size_t p_bytes(int rows) {
    return kIsBf16<T> ? align(size_t(rows) * LP * sizeof(T)) : 0;
  }
  static __host__ __device__ constexpr size_t bytes(int rows) {
    return o_bytes(rows) + s_bytes(rows) + 2 * ml_bytes(rows) + q_bytes(rows) + 2 * kv_bytes() +
           p_bytes(rows);
  }
};

template <typename T, int D, int BK>
struct Smem {
  using L = Layout<T, D, BK>;
  using PT = typename std::conditional<kIsBf16<T>, bf16, float>::type;
  float* o;
  float* s;
  float* m;
  float* l;
  T* q;
  T* k;
  T* v;
  PT* p;

  __device__ Smem(unsigned char* base, int rows) {
    o = reinterpret_cast<float*>(base);
    base += L::o_bytes(rows);
    s = reinterpret_cast<float*>(base);
    base += L::s_bytes(rows);
    m = reinterpret_cast<float*>(base);
    base += L::ml_bytes(rows);
    l = reinterpret_cast<float*>(base);
    base += L::ml_bytes(rows);
    q = reinterpret_cast<T*>(base);
    base += L::q_bytes(rows);
    k = reinterpret_cast<T*>(base);
    base += L::kv_bytes();
    v = reinterpret_cast<T*>(base);
    base += L::kv_bytes();
    if constexpr (kIsBf16<T>) {
      p = reinterpret_cast<PT*>(base);
    } else {
      p = reinterpret_cast<PT*>(s);
    }
  }

  // acc = 0, m = -inf, l = 0 for `rows` rows (whole block).
  __device__ void init(int rows) {
    for (int i = threadIdx.x; i < rows * L::LO; i += kThreads) o[i] = 0.f;
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
  }
};

// Copies `rows` rows of D elements, row r at g + r * gstride, into s (pitch
// LQ) with 16-byte loads; rows >= valid are zero-filled (the ragged tail is
// masked later, never padded in device memory).  Whole block.
template <typename T, int D, int LQ>
__device__ void load_rows(T* s, const T* g, long gstride, int rows, int valid) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = D / V;
  for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * V;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) raw = *reinterpret_cast<const uint4*>(g + r * gstride + c);
    if constexpr (kIsBf16<T>) {
      *reinterpret_cast<uint4*>(s + r * LQ + c) = raw;
    } else {
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) s[r * LQ + c + j] = e[j];
    }
  }
}

// One online-softmax step for row group rg (rows 16*rg .. 16*rg+15) against
// the BK keys in sm.k / sm.v.  `mask(row, col)` says whether key col is
// visible to query row.  Scores are multiplied by `scale` after the dot, in
// f32, then soft-capped when softcap > 0.  Called by the owning warp only.
template <typename T, int D, int BK, class Mask>
__device__ void attend_rows(Smem<T, D, BK>& sm, int rg, float scale, float softcap, Mask mask) {
  using L = Layout<T, D, BK>;
  const int lane = threadIdx.x & 31;
  const int r0 = rg * 16;

  // S = Q K^T
  if constexpr (kIsBf16<T>) {
    using namespace nvcuda;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, sm.q + r0 * L::LQ + kk * 16, L::LQ);
        wmma::load_matrix_sync(b, sm.k + j * 16 * L::LQ + kk * 16, L::LQ);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(sm.s + r0 * L::LS + j * 16, c, L::LS, wmma::mem_row_major);
    }
  } else {
    for (int c = lane; c < BK; c += 32) {
      float acc[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kd = to_f(sm.k[c * L::LQ + d]);
#pragma unroll
        for (int r = 0; r < 16; ++r) acc[r] = fmaf(to_f(sm.q[(r0 + r) * L::LQ + d]), kd, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) sm.s[(r0 + r) * L::LS + c] = acc[r];
    }
  }
  __syncwarp();

  // online softmax, one row at a time across the warp
  constexpr int CPL = BK / 32;  // columns per lane
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    float sv[CPL];
    bool ok[CPL];
    float mx = kNegInf;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
      float x = sm.s[row * L::LS + c] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      ok[t] = mask(row, c);
      sv[t] = ok[t] ? x : kNegInf;
      mx = fmaxf(mx, sv[t]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_prev = sm.m[row];
    const float m_new = fmaxf(m_prev, mx);
    const float alpha = expf(m_prev - m_new);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const float p = ok[t] ? expf(sv[t] - m_new) : 0.f;
      sum += p;
      sm.p[row * L::LP + lane + 32 * t] = from_f<typename Smem<T, D, BK>::PT>(p);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int d = lane; d < D; d += 32) sm.o[row * L::LO + d] *= alpha;
    __syncwarp();
    if (lane == 0) {
      sm.m[row] = m_new;
      sm.l[row] = sm.l[row] * alpha + sum;
    }
  }
  __syncwarp();

  // acc += P V
  if constexpr (kIsBf16<T>) {
    using namespace nvcuda;
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, sm.o + r0 * L::LO + dd * 16, L::LO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sm.p + r0 * L::LP + kk * 16, L::LP);
        wmma::load_matrix_sync(b, sm.v + kk * 16 * L::LQ + dd * 16, L::LQ);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(sm.o + r0 * L::LO + dd * 16, c, L::LO, wmma::mem_row_major);
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      float acc[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = 0.f;
      for (int j = 0; j < BK; ++j) {
        const float vj = to_f(sm.v[j * L::LQ + d]);
#pragma unroll
        for (int r = 0; r < 16; ++r) acc[r] = fmaf(sm.p[(r0 + r) * L::LP + j], vj, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) sm.o[(r0 + r) * L::LO + d] += acc[r];
    }
  }
  __syncwarp();
}

// Sets the block's dynamic shared memory and returns cudaSuccess, or the
// error (too much shared memory) without launching.
template <class K>
inline cudaError_t prepare(K kernel, size_t smem) {
  if (smem > size_t(kMaxSmem)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

}  // namespace attn
