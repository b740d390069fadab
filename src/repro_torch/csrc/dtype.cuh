// Device helpers shared by the port's kernels: fp32 <-> element-type
// conversions (float, __half and __nv_bfloat16; rounding to nearest even),
// warp-wide reductions and the attention kernels' key mask.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// A key at position kp is visible to a query at qp when 0 <= kp <= qp,
// and kp > qp - window with a window (window <= 0: none).
__device__ __forceinline__ bool visible(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
}

}  // namespace
