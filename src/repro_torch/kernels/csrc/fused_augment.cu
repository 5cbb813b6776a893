// Fused crop + horizontal flip + normalise for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/fused_augment/kernel.py::_augment_kernel
// (pallas_call in fused_augment_fwd): the same function, not the same blocks.
// The TPU kernel copies each whole uint8 image into VMEM and slices it there;
// here one thread block writes one output row of one image, so a block reads
// only the crop window's row (out_w * C contiguous bytes, or the same bytes
// walked backwards under a flip) and writes out_w * C contiguous f32 values:
// neighbouring threads read neighbouring bytes and write neighbouring floats.
// The normalisation is one FMA, x * (1 / (255 std)) + (-mean / std), with the
// per-channel scale and bias computed once per block in shared memory.
//
// The corner is taken as lax.dynamic_slice takes it in the JAX reference: a
// negative start is first wrapped once by the dimension (y0 + H), then the
// start is clamped to [0, H - out_h] (x0 likewise to [0, W - out_w]), so a
// corner out of range never reads out of bounds.
//
// Bound on the card: bytes.  The function reads B * out_h * out_w * C bytes
// and writes four times as many; it does one FMA per output value, far below
// the card's arithmetic rate.  ResNet-50's recipe (B 256, 256x256x3 cropped to
// 224x224) moves 38.5 MB + 154.1 MB, 57.5 us at 3.35 TB/s.
//
// Supported: C <= 16 (the wrapper, repro_torch/kernels/fused_augment/ops.py,
// checks shapes and types and rejects anything else).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 16;

__global__ void __launch_bounds__(kThreads)
    augment_kernel(const uint8_t* __restrict__ img, const int* __restrict__ crops,
                   const int* __restrict__ flips, const float* __restrict__ mean,
                   const float* __restrict__ stdev, float* __restrict__ out, int H, int W, int C,
                   int out_h, int out_w) {
  __shared__ float scale[kMaxC];
  __shared__ float bias[kMaxC];
  const int y = blockIdx.x;  // output row
  const int b = blockIdx.y;  // image
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
  __syncthreads();

  const uint8_t* src = img + (((long)b * H + y0 + y) * W + x0) * C;
  float* dst = out + ((long)b * out_h + y) * out_w * C;
  const int n = out_w * C;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int x = i / C;
    const int c = i - x * C;
    const int sx = flip ? out_w - 1 - x : x;
    dst[i] = fmaf(float(src[sx * C + c]), scale[c], bias[c]);
  }
}

}  // namespace

extern "C" {

// images (B,H,W,C) uint8, crops (B,2) int32 (y0, x0), flips (B,) int32, mean
// and std (C,) f32, out (B,out_h,out_w,C) f32; all contiguous.  Returns the
// launch's cudaError_t.
int fused_augment_fwd(const void* images, const void* crops, const void* flips, const void* mean,
                      const void* stdev, void* out, int B, int H, int W, int C, int out_h,
                      int out_w, void* stream) {
  if (C < 1 || C > kMaxC || out_h < 1 || out_w < 1 || out_h > H || out_w > W)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  dim3 grid(out_h, B);
  augment_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(images), static_cast<const int*>(crops),
      static_cast<const int*>(flips), static_cast<const float*>(mean),
      static_cast<const float*>(stdev), static_cast<float*>(out), H, W, C, out_h, out_w);
  return cudaGetLastError();
}

const char* fused_augment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
