// Mamba2 SSD chunked scan for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::_ssd_kernel
// (pallas_call in ssd_scan_fwd).  Per chunk of Q tokens, with cum the
// inclusive cumsum of dt * a over the chunk and h the (N, P) state entering
// it, exactly as _ssd_kernel:
//
//   W[i, j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for j <= i, else 0
//   y       = W x + exp(cum) * (C h) + D * x
//   h      <- exp(cum_Q) h + sum_j (exp(cum_Q - cum_j) * dt_j) B_j x_j^T
//
// One thread block per (head, batch) walks the chunks in order; the state
// stays in shared memory for the whole sequence and is written once at the
// end.  The chunk's x, B and C are staged in shared memory in f32 (Q is
// padded to a multiple of 16 with zero rows, which add nothing: dt = 0 there,
// so the decay is 1 and the weights are 0).  Tokens at or past L are loaded
// as zeros with dt = 0 and their y is not written: the ragged tail is masked
// here, with no padding copy.  W is built 32 rows at a time, and only its
// columns j <= i are multiplied.  B and C may hold G groups instead of H
// heads: head h reads group h / (H / G) in place.
//
// Every product is a scalar f32 FMA (as the TPU kernel's f32 dots): each
// thread accumulates a small register tile of the output and reads its
// operands from shared memory.
//
// Bound on the card: f32 operations, Q(Q+1)(N + P) + 4QNP per chunk and head
// (the causal entries of W and of its product with x, C h and the state
// update), against 67 TFLOP/s of f32 outside the tensor cores on an H100
// SXM; the bytes (x, B, C and y once each) take a fifth of that time at the
// mamba2 prefill shape.  This
// first version runs one block per (head, batch) - 80 blocks on 132 SMs at
// that shape - with no tensor cores and no load/compute overlap.
//
// Supported: T in {f32, bf16} for x, B, C and y; dt, a, D and the state in
// f32; N and P multiples of 4; shared memory (smem_bytes below) within the
// 227 KB a block may opt into - a longer chunk is refused with
// cudaErrorLaunchOutOfResources (Q 128 at N 128, P 64 takes 216 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRowBlock = 32;  // rows of W held in shared memory at once
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// acc[r][c] += sum_{k < K} a(i_r, k) * b(k, j_c) for one register tile of an
// (M x Nc) product, with rows i_r = ti + r * (M / TM) and columns
// j_c = tj + c * (Nc / TN): neighbouring threads take neighbouring columns,
// so their shared-memory reads of b fall in different banks.
template <int TM, int TN, class FA, class FB>
__device__ __forceinline__ void tile_product(float (&acc)[TM][TN], int ti, int tj, int M,
                                             int Nc, int K, FA a, FB b) {
  const int sr = M / TM;
  const int sc = Nc / TN;
  for (int k = 0; k < K; ++k) {
    float av[TM];
    float bv[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) av[r] = a(ti + r * sr, k);
#pragma unroll
    for (int c = 0; c < TN; ++c) bv[c] = b(k, tj + c * sc);
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ Dv, T* __restrict__ y,
                    float* __restrict__ h_out, int L, int H, int G, int P, int N, int Q,
                    int Qp) {
  const int hd = blockIdx.x;
  const int b = blockIdx.y;
  const int g = hd / (H / G);
  const int tid = threadIdx.x;
  const int LB = N + 1;   // pitch of B and C rows
  const int LW = Qp + 1;  // pitch of W rows

  extern __shared__ __align__(16) float smem[];
  float* hs = smem;              // (N, P) state
  float* xs = hs + N * P;        // (Qp, P)
  float* bs = xs + Qp * P;       // (Qp, LB)
  float* cs = bs + Qp * LB;      // (Qp, LB)
  float* ws = cs + Qp * LB;      // (kRowBlock, LW)
  float* dts = ws + kRowBlock * LW;  // (Qp,) dt, 0 past the chunk or L
  float* cum = dts + Qp;         // (Qp,) inclusive cumsum of dt * a
  float* wst = cum + Qp;         // (Qp,) exp(cum_Q - cum_j) * dt_j
  float* ecum = wst + Qp;        // (Qp,) exp(cum_i)

  const float av = a[hd];
  const float dv = Dv[hd];
  for (int i = tid; i < N * P; i += kThreads) hs[i] = 0.f;

  const int nc = (L + Q - 1) / Q;
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * Q;
    __syncthreads();  // the previous chunk is done with xs, bs, cs, dts
    for (int i = tid; i < Qp * P; i += kThreads) {
      const int r = i / P;
      const int t = t0 + r;
      xs[i] = (r < Q && t < L) ? to_f(x[((long)(b * L + t) * H + hd) * P + i % P]) : 0.f;
    }
    for (int i = tid; i < Qp * N; i += kThreads) {
      const int r = i / N;
      const int n = i % N;
      const int t = t0 + r;
      const bool ok = r < Q && t < L;
      const long off = ((long)(b * L + t) * G + g) * N + n;
      bs[r * LB + n] = ok ? to_f(Bm[off]) : 0.f;
      cs[r * LB + n] = ok ? to_f(Cm[off]) : 0.f;
    }
    for (int r = tid; r < Qp; r += kThreads) {
      const int t = t0 + r;
      dts[r] = (r < Q && t < L) ? dt[((long)b * L + t) * H + hd] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < Qp; ++r) {
        s += dts[r] * av;
        cum[r] = s;
      }
    }
    __syncthreads();
    const float cq = cum[Qp - 1];
    for (int r = tid; r < Qp; r += kThreads) {
      wst[r] = expf(cq - cum[r]) * dts[r];
      ecum[r] = expf(cum[r]);
    }

    for (int r0 = 0; r0 < Qp; r0 += kRowBlock) {
      const int M = min(kRowBlock, Qp - r0);  // a multiple of 16
      const int J = r0 + M;                   // W[i, j] = 0 for j > i
      __syncthreads();  // the previous row block is done with ws; wst, ecum written
      {
        const int tc = J / 4;
        for (int t = tid; t < (M / 4) * tc; t += kThreads) {
          const int ti = t / tc;
          const int tj = t % tc;
          float acc[4][4] = {};
          tile_product<4, 4>(
              acc, ti, tj, M, J, N, [&](int i, int k) { return cs[(r0 + i) * LB + k]; },
              [&](int k, int j) { return bs[j * LB + k]; });
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = ti + r * (M / 4);
            const int gi = r0 + i;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int j = tj + c * tc;
              ws[i * LW + j] = j <= gi ? acc[r][c] * expf(cum[gi] - cum[j]) * dts[j] : 0.f;
            }
          }
        }
      }
      __syncthreads();
      {
        const int tc = P / 4;
        for (int t = tid; t < (M / 2) * tc; t += kThreads) {
          const int ti = t / tc;
          const int tj = t % tc;
          float yd[2][4] = {};
          float yo[2][4] = {};
          tile_product<2, 4>(
              yd, ti, tj, M, P, J, [&](int i, int k) { return ws[i * LW + k]; },
              [&](int k, int p) { return xs[k * P + p]; });
          tile_product<2, 4>(
              yo, ti, tj, M, P, N, [&](int i, int k) { return cs[(r0 + i) * LB + k]; },
              [&](int k, int p) { return hs[k * P + p]; });
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int gi = r0 + ti + r * (M / 2);
            const int tok = t0 + gi;
            if (gi >= Q || tok >= L) continue;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int p = tj + c * tc;
              const float v = yd[r][c] + ecum[gi] * yo[r][c] + dv * xs[gi * P + p];
              y[((long)(b * L + tok) * H + hd) * P + p] = from_f<T>(v);
            }
          }
        }
      }
    }
    __syncthreads();  // every read of the entering state is done
    {
      const float ecq = expf(cq);
      const int tc = P / 4;
      for (int t = tid; t < (N / 4) * tc; t += kThreads) {
        const int ti = t / tc;
        const int tj = t % tc;
        float acc[4][4] = {};
        tile_product<4, 4>(
            acc, ti, tj, N, P, Qp, [&](int n, int j) { return bs[j * LB + n] * wst[j]; },
            [&](int j, int p) { return xs[j * P + p]; });
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = ti + r * (N / 4);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = tj + c * tc;
            hs[n * P + p] = fmaf(ecq, hs[n * P + p], acc[r][c]);
          }
        }
      }
    }
  }
  __syncthreads();
  float* ho = h_out + ((long)b * H + hd) * N * P;
  for (int i = tid; i < N * P; i += kThreads) ho[i] = hs[i];
}

size_t smem_bytes(int Qp, int N, int P) {
  return sizeof(float) *
         (size_t(N) * P + size_t(Qp) * P + 2 * size_t(Qp) * (N + 1) +
          size_t(kRowBlock) * (Qp + 1) + 4 * size_t(Qp));
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a, const void* Bm, const void* Cm,
                   const void* D, void* y, void* h, int Bsz, int L, int H, int G, int P, int N,
                   int Q, cudaStream_t stream) {
  if (G <= 0 || H % G || P % 4 || N % 4 || Q < 1) return cudaErrorInvalidValue;
  const int Qp = (Q + 15) / 16 * 16;
  const size_t smem = smem_bytes(Qp, N, P);
  if (smem > size_t(kMaxSmem)) return cudaErrorLaunchOutOfResources;
  auto kernel = ssd_scan_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, Bsz), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(h), L, H, G, P, N, Q, Qp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B,L,H,P) and y of one type (dtype 0 = f32, 1 = bf16); dt (B,L,H), a and
// D (H,) f32; B and C (B,L,G,N) of x's type; h (B,H,N,P) f32, the final state.
// All contiguous.  Q = the chunk (<= L).  Returns the cudaError_t of the
// launch.
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* Bm, const void* Cm,
                 const void* D, void* y, void* h, int Bsz, int L, int H, int G, int P, int N,
                 int Q, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, a, Bm, Cm, D, y, h, Bsz, L, H, G, P, N, Q, s);
  if (dtype == 1) return launch<bf16>(x, dt, a, Bm, Cm, D, y, h, Bsz, L, H, G, P, N, Q, s);
  return cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
