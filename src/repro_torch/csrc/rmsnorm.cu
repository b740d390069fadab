// Fused RMSNorm for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes); see repro_torch/kernels/rmsnorm.py.
//
// Replaces the Pallas TPU kernel fused_rmsnorm of the reference package
// (repro/kernels/rmsnorm.py, body _kernel):
//   out = x * rsqrt(mean(x^2) + eps) * (1 + w)   per row of the last dim,
// in fp32, written at x's dtype.
//
// Bound: device-memory bytes (x read once, out written once, w once; a few
// flops per element).  Design: one block per row; each thread sums the
// squares of a strided slice of the row, a warp-shuffle reduction and one
// shared-memory pass across warps give the row's mean, and the same
// threads then scale and write the row (the second read of x hits L1/L2).
// Any number of rows and any D: no tiling limit like the Pallas wrapper's
// block_rows divisibility.
#include <cuda_runtime.h>
#include <math.h>

#include "dtype.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* x, const W* w, T* out, int D, float eps) {
  __shared__ float part[kWarps];
  const long row = blockIdx.x;
  const T* xr = x + row * D;
  T* orow = out + row * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float ss = 0.f;
  for (int i = tid; i < D; i += kThreads) {
    const float a = to_f(xr[i]);
    ss = fmaf(a, a, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(part[0] / (float)D + eps);
  for (int i = tid; i < D; i += kThreads)
    orow[i] = from_f<T>(to_f(xr[i]) * r * (1.f + to_f(w[i])));
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* out, long rows, int D,
                   float eps, cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  rmsnorm_kernel<T, W><<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), D, eps);
  return cudaGetLastError();
}

// w at x's type or at fp32
template <typename T>
cudaError_t launch_w(bool w_f32, const void* x, const void* w, void* out,
                     long rows, int D, float eps, cudaStream_t stream) {
  return w_f32 ? launch<T, float>(x, w, out, rows, D, eps, stream)
               : launch<T, T>(x, w, out, rows, D, eps, stream);
}

}  // namespace

// dtype of x and out: 0 = float32, 1 = float16, 2 = bfloat16; w_f32: w is
// fp32 (else at x's dtype).  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              int dtype, int w_f32, long rows, int D,
                              float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float, float>(x, w, out, rows, D, eps, s);
    case 1: return (int)launch_w<__half>(w_f32, x, w, out, rows, D, eps, s);
    case 2:
      return (int)launch_w<__nv_bfloat16>(w_f32, x, w, out, rows, D, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
