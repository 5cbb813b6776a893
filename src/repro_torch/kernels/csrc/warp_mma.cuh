// Warp-level building blocks of the decode-attention and SSD-scan kernels
// (decode_attention.cu, ssd_scan.cu): the bf16 tensor-core product
// mma.sync m16n8k16 with f32 accumulation, its fragment layouts, the split
// of an f32 value into bf16 pieces for products that must keep f32
// precision, the tf32 product m16n8k8 taken three times on hi + lo operands
// (3xTF32) for products of f32 operands, ldmatrix loads of transposed
// fragments, and 16-byte cp.async copies into shared memory.
//
// Fragment layout of mma.sync.m16n8k16.row.col (PTX ISA, "Matrix Fragments
// for mma.m16n8k16"); in lane l, g = l / 4 and t = l % 4:
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1],    a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9],  a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8):             b0 = B[2t..2t+1][g],    b1 = B[2t+8..2t+9][g]
//   C (16 x 8, f32):        c0 = C[g][2t], c1 = C[g][2t+1],
//                           c2 = C[g+8][2t], c3 = C[g+8][2t+1]
// Each 32-bit A or B register packs two bf16 values, the lower k index in the
// low half.  So the accumulators of two neighbouring n8 tiles of one product
// are, packed in pairs, the A fragment of a k16 step of the next product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace warp_mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ uint32_t pack(bf16 lo_k, bf16 hi_k) {
  return uint32_t(__bfloat16_as_ushort(lo_k)) | (uint32_t(__bfloat16_as_ushort(hi_k)) << 16);
}

// Two floats rounded to bf16 and packed (the lower k index first).
__device__ __forceinline__ uint32_t pack_f(float x, float y) {
  return pack(__float2bfloat16_rn(x), __float2bfloat16_rn(y));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return make_float2(__bfloat162float(__ushort_as_bfloat16(uint16_t(v & 0xffffu))),
                     __bfloat162float(__ushort_as_bfloat16(uint16_t(v >> 16))));
}

// A pair of f32 values as K bf16 pieces x = p[0] + ... + p[K-1], each the
// rounding of what the pieces before it leave (the remainders are exact in
// f32): x to about 2^-9 (K = 1), 2^-17 (K = 2) or 2^-25 (K = 3) of itself.
// A product of two split values keeps the products of pieces i, j with
// i + j < max(Ka, Kb) (``pieces_mma``), each exact in f32; the terms it
// drops are below 2^-8K of the product.
template <int K>
__device__ __forceinline__ void split_pieces(float x, float y, uint32_t (&p)[K]) {
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);  // x in the low half
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
    p[k] = u;
    x -= __uint_as_float(u << 16);
    y -= __uint_as_float(u & 0xffff0000u);
  }
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  p[K - 1] = *reinterpret_cast<const uint32_t*>(&h);
}

// c += a b, one m16n8k16 product of bf16 operands with f32 accumulation.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for A in KA pieces and B in KB pieces (b[j] = {b0, b1} of piece
// j), the pairs of pieces i + j < max(KA, KB).
template <int KA, int KB>
__device__ __forceinline__ void pieces_mma(float (&c)[4], const uint32_t (&a)[KA][4],
                                           const uint32_t (&b)[KB][2]) {
  constexpr int KM = KA > KB ? KA : KB;
#pragma unroll
  for (int i = 0; i < KA; ++i)
#pragma unroll
    for (int j = 0; j < KB; ++j)
      if (i + j < KM) mma(c, a[i], b[j][0], b[j][1]);
}

// f32 operands on the tf32 tensor cores (3xTF32).  mma.sync m16n8k8 tf32,
// in lane l with g = l / 4 and t = l % 4 (PTX ISA, "Matrix Fragments for
// mma.m16n8k8"):
//   A (16 x 8): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8):  b0 = B[t][g], b1 = B[t+4][g]
//   C (16 x 8, f32): as m16n8k16's.
// A product sums over k, so any one permutation of the 8 k slots taken by A
// and B alike gives the same result; the SSD kernel uses that to feed its
// accumulators to the next product as A without a shuffle.
//
// An f32 value as hi + lo: hi its rounding to tf32 (cvt.rna, 11 significant
// bits), lo the rounding of the remainder x - hi (exact in f32), so that
// hi + lo is x to about 2^-22 of itself.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

struct Tf32A {
  uint32_t hi[4], lo[4];
};
struct Tf32B {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ Tf32A tf32_a(float a0, float a1, float a2, float a3) {
  Tf32A f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ Tf32B tf32_b(float b0, float b1) {
  Tf32B f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three tf32 products: lo.hi, hi.lo, then hi.hi.  The dropped
// lo.lo is below 2^-22 of each term.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Tf32A& a, const Tf32B& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// The A fragment of rows r0..r0+15 and columns k0..k0+15 of a row-major bf16
// matrix in shared memory with a pitch of `pitch` elements (even).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* m, int pitch, int r0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* p = m + (r0 + g) * pitch + k0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * pitch);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * pitch + 8);
}

// The B fragment of B[k0..k0+15][n0..n0+7] where B is held transposed,
// Bt[n][k] row-major with a pitch of `pitch` elements (even): k contiguous.
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* bt, int pitch,
                                       int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = bt + (n0 + (lane >> 2)) * pitch + k0 + 2 * (lane & 3);
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// Four 8x8 bf16 matrices from shared memory, transposed (ldmatrix .trans):
// lanes 8i..8i+7 give the 16-byte row addresses of matrix i, and lane
// (g, t) receives r[i] = rows 2t, 2t+1 of column g of matrix i.  So from a
// row-major X[k][n]:
//   * ldsm_b: the B fragments of n tiles n0 and n0 + 8 at k0 (k = X's rows),
//     r = {b0, b1} of tile n0, then {b0, b1} of tile n0 + 8;
//   * ldsm_at: the A fragment of A = X^T, rows (X's columns) m0..m0+15 and
//     columns (X's rows) k0..k0+15.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_b(uint32_t (&r)[4], const bf16* x, int pitch, int k0,
                                       int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, x + (k0 + (lane & 15)) * pitch + n0 + ((lane >> 4) << 3));
}
__device__ __forceinline__ void ldsm_at(uint32_t (&r)[4], const bf16* x, int pitch, int m0,
                                        int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, x + (k0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + m0 + (((lane >> 3) & 1) << 3));
}

// 16 bytes from global to shared memory, asynchronously; `valid` false
// fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sets a kernel's dynamic shared memory once per device (the attribute is a
// property of the function on that device); later calls only read a flag.
template <class K>
inline cudaError_t set_smem_once(K kernel, size_t bytes, unsigned& done_mask) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done_mask & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess) done_mask |= bit;
  return err;
}

constexpr int kMaxSmem = 232448;  // opt-in dynamic shared memory of one sm_90 block

}  // namespace warp_mma
