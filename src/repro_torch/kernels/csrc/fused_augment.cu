// Fused crop + horizontal flip + normalise for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/fused_augment/kernel.py::_augment_kernel
// (pallas_call in fused_augment_fwd): the same function, not the same blocks.
// The TPU kernel copies each whole uint8 image into VMEM and slices it there;
// here a block reads only the crop window's rows.  The normalisation is one
// FMA, x * (1 / (255 std)) + (-mean / std), with the per-channel scale and
// bias computed once per block in shared memory.
//
// The corner is taken as lax.dynamic_slice takes it in the JAX reference: a
// negative start is first wrapped once by the dimension (y0 + H), then the
// start is clamped to [0, H - out_h] (x0 likewise to [0, W - out_w]), so a
// corner out of range never reads out of bounds.
//
// Bound on the card: bytes.  The function reads B * out_h * out_w * C bytes
// and writes four times as many; it does one FMA per output value, far below
// the card's arithmetic rate.  ResNet-50's recipe (B 256, 256x256x3 cropped to
// 224x224) moves 38.5 MB + 154.1 MB, 57.5 us at 3.35 TB/s.  The design keeps
// many wide accesses in flight:
//
// * A block takes kRows output rows of one image (grid: row groups x B).
// * Load: each crop row's out_w * C bytes are read with 16-byte loads from
//   the 16-byte aligned address at or before the row's start into shared
//   memory, so an unaligned x0 * C costs nothing; a chunk that would leave
//   the images tensor is read byte by byte.  A row longer than kPieceBytes
//   is staged and written in pieces of whole pixels.
// * Flip: a reversed index into the staged row.
// * Store: each thread writes aligned groups of 4 output floats as one
//   float4; a group that a row (piece) only partly covers, at its ends when
//   out_w * C is not a multiple of 4, is written element by element, so
//   neighbouring blocks never write the same float.
// * C = 1, 3 and 4 are compile-time (the pixel of an output index is a
//   multiply and a shift); other C <= 16 take a generic instantiation.
//
// Supported: C <= 16 (the wrapper, repro_torch/kernels/fused_augment/ops.py,
// checks shapes and types and rejects anything else).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 16;
constexpr int kRows = 16;          // output rows a block
constexpr int kPieceBytes = 2048;  // crop-row bytes a row stages at a time

// Shared-memory pitch of a staged row piece of `pix` pixels: its bytes
// rounded up to 16, plus 16 for the offset of the aligned first chunk.
__host__ __device__ constexpr int stage_pitch(int pix, int C) {
  return (pix * C + 15) / 16 * 16 + 16;
}

// 16 bytes at p, or byte by byte (zeros outside [lo, hi)) when the chunk
// leaves the tensor.
__device__ __forceinline__ uint4 load_chunk(const uint8_t* p, const uint8_t* lo,
                                            const uint8_t* hi) {
  if (p >= lo && p + 16 <= hi) return *reinterpret_cast<const uint4*>(p);
  union {
    uint4 v;
    uint8_t b[16];
  } u;
#pragma unroll
  for (int i = 0; i < 16; ++i) u.b[i] = (p + i >= lo && p + i < hi) ? p[i] : 0;
  return u.v;
}

// CT: channels, 0 = the runtime Cr.  pix: pixels a piece of a row.
template <int CT>
__global__ void __launch_bounds__(kThreads)
    augment_rows(const uint8_t* __restrict__ img, const int* __restrict__ crops,
                 const int* __restrict__ flips, const float* __restrict__ mean,
                 const float* __restrict__ stdev, float* __restrict__ out, int B, int H, int W,
                 int Cr, int out_h, int out_w, int pix) {
  const int C = CT > 0 ? CT : Cr;
  extern __shared__ __align__(16) uint8_t stage[];  // kRows x pitch bytes
  __shared__ float scale[kMaxC];
  __shared__ float bias[kMaxC];
  const int b = blockIdx.y;
  const int ybase = blockIdx.x * kRows;
  const int rows = min(kRows, out_h - ybase);
  if (threadIdx.x < C) {
    const float sd = stdev[threadIdx.x];
    scale[threadIdx.x] = 1.0f / (255.0f * sd);
    bias[threadIdx.x] = -mean[threadIdx.x] / sd;
  }
  int y0 = crops[2 * b];
  int x0 = crops[2 * b + 1];
  y0 = min(max(y0 < 0 ? y0 + H : y0, 0), H - out_h);
  x0 = min(max(x0 < 0 ? x0 + W : x0, 0), W - out_w);
  const bool flip = flips[b] > 0;

  const uint8_t* end = img + (long)B * H * W * C;
  const long row_stride = (long)W * C;
  const uint8_t* crop = img + (((long)b * H + y0 + ybase) * W + x0) * C;  // the block's row 0
  const long n = (long)out_w * C;                                         // floats a row
  const long out0 = ((long)b * out_h + ybase) * n;  // the block's first output
  const int pitch = stage_pitch(pix, C);
  const int chunks = pitch / 16;

  for (int p0 = 0; p0 < out_w; p0 += pix) {
    const int p1 = min(p0 + pix, out_w);
    const int sp0 = flip ? out_w - p1 : p0;  // first source pixel of output pixels [p0, p1)
    const int len = (p1 - p0) * C;           // bytes (and floats) of a row's piece

    // stage the rows' pieces: 16-byte chunks from the aligned address at or
    // before each piece's first byte
    for (int j = threadIdx.x; j < rows * chunks; j += kThreads) {
      const int r = j / chunks;
      const int q = j - r * chunks;
      const uint8_t* src = crop + r * row_stride + sp0 * C;
      const int mis = int(reinterpret_cast<uintptr_t>(src) & 15);
      if (q * 16 < mis + len)
        *reinterpret_cast<uint4*>(stage + r * pitch + q * 16) =
            load_chunk(src - mis + q * 16, img, end);
    }
    __syncthreads();

    // aligned groups of 4 outputs that meet a row's piece: at most len / 4 + 2
    const int groups = len / 4 + 2;
    for (int j = threadIdx.x; j < rows * groups; j += kThreads) {
      const int r = j / groups;
      const long start = out0 + r * n + (long)p0 * C;  // the piece's first output
      const long g0 = ((start >> 2) + (j - r * groups)) << 2;
      if (g0 >= start + len) continue;
      const uint8_t* src = crop + r * row_stride + sp0 * C;
      const uint8_t* st = stage + r * pitch + int(reinterpret_cast<uintptr_t>(src) & 15);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = int(g0 + e - start);  // output index within the piece
        if (i >= 0 && i < len) {
          const int x = i / C;
          const int c = i - x * C;
          const int sx = flip ? out_w - 1 - (p0 + x) : p0 + x;  // source pixel
          v[e] = fmaf(float(st[(sx - sp0) * C + c]), scale[c], bias[c]);
        }
      }
      if (g0 >= start && g0 + 4 <= start + len) {
        *reinterpret_cast<float4*>(out + g0) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (g0 + e >= start && g0 + e < start + len) out[g0 + e] = v[e];
      }
    }
    __syncthreads();  // the stage is reused by the next piece
  }
}

template <int CT>
cudaError_t launch(const void* images, const void* crops, const void* flips, const void* mean,
                   const void* stdev, void* out, int B, int H, int W, int C, int out_h,
                   int out_w, cudaStream_t stream) {
  const int pix = min(out_w, max(1, kPieceBytes / C));
  const size_t smem = size_t(kRows) * stage_pitch(pix, C);
  dim3 grid((out_h + kRows - 1) / kRows, B);
  augment_rows<CT><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(images), static_cast<const int*>(crops),
      static_cast<const int*>(flips), static_cast<const float*>(mean),
      static_cast<const float*>(stdev), static_cast<float*>(out), B, H, W, C, out_h, out_w,
      pix);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// images (B,H,W,C) uint8, crops (B,2) int32 (y0, x0), flips (B,) int32, mean
// and std (C,) f32, out (B,out_h,out_w,C) f32; all contiguous, out 16-byte
// aligned.  Returns the launch's cudaError_t.
int fused_augment_fwd(const void* images, const void* crops, const void* flips, const void* mean,
                      const void* stdev, void* out, int B, int H, int W, int C, int out_h,
                      int out_w, void* stream) {
  if (C < 1 || C > kMaxC || out_h < 1 || out_w < 1 || out_h > H || out_w > W ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(images, crops, flips, mean, stdev, out, B, H, W, C, out_h, out_w, s);
    case 3: return launch<3>(images, crops, flips, mean, stdev, out, B, H, W, C, out_h, out_w, s);
    case 4: return launch<4>(images, crops, flips, mean, stdev, out, B, H, W, C, out_h, out_w, s);
  }
  return launch<0>(images, crops, flips, mean, stdev, out, B, H, W, C, out_h, out_w, s);
}

const char* fused_augment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
