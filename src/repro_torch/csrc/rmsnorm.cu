// Fused RMSNorm for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (ctypes); see repro_torch/kernels/rmsnorm.py.
//
// Replaces the Pallas TPU kernel fused_rmsnorm of the reference package
// (repro/kernels/rmsnorm.py, body _kernel):
//   out = x * rsqrt(mean(x^2) + eps) * (1 + w)   per row of the last dim,
// in fp32, written at x's dtype.
//
// Bound: device-memory bytes: x read once and out written once (w once,
// a few flops per element).  What a block per row with element loads
// loses to that bound: 2-byte loads (64 bytes a warp instruction), x read
// twice and two block barriers a row.  Two bodies, chosen by the wrapper's
// plan (rmsnorm.rmsnorm_plan) from the shape and x's alignment:
//
//  * rows (rmsnorm_rows_kernel): x 16-byte aligned, rows a whole number
//    of 16-byte vectors and at most 2048 of them (D <= 16384 at 16-bit
//    types, 8192 at fp32).  A row group of one, two or four warps owns a
//    row at a time; each lane holds its up to 16 vectors of the row in
//    registers from the sum of squares to the scale, so x is read once,
//    with 16-byte loads and stores (8 bf16 / fp16 or 4 fp32 a lane, all of
//    a lane's loads in flight together).  One warp's shuffles reduce a row
//    (several warps add their sums through a named barrier of the group
//    alone), with no block barrier per row.  A block's groups walk rows
//    with a grid stride over about two blocks an SM, and 1 + w is staged
//    in shared memory as fp32 once per block.
//  * scalar (rmsnorm_scalar_kernel): everything else (a D that is not a
//    whole number of vectors, an x that starts off a 16-byte boundary,
//    such as a contiguous view at an odd offset, and rows wider than the
//    rows body's registers hold).  A block per row, element loads, x read
//    twice (the second time from L2).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// 16 bytes of T as fp32 values, and back (rounding to nearest even)
template <typename T>
struct Vec16 {
  static constexpr int n = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8],
                                       __nv_bfloat16) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8],
                                       __half) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p =
        __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

template <typename T>
__device__ __forceinline__ void load_vec(const uint4& v,
                                         float (&f)[Vec16<T>::n]) {
  if constexpr (sizeof(T) == 4)
    unpack(v, f);
  else
    unpack(v, f, T());
}

template <typename T>
__device__ __forceinline__ uint4 store_vec(const float (&f)[Vec16<T>::n]) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    return make_uint4(pack2<T>(f[0], f[1]), pack2<T>(f[2], f[3]),
                      pack2<T>(f[4], f[5]), pack2<T>(f[6], f[7]));
  }
}

__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// grid-stride over rows; wpr warps a row (1, 2 or 4), kWarps / wpr rows
// of the block at a time; each lane holds NV vectors of its row
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_rows_kernel(const T* x, const W* w, T* out, long rows, int D,
                        int wpr, float eps) {
  constexpr int V = Vec16<T>::n;
  extern __shared__ __align__(16) float w1[];     // 1 + w, fp32
  __shared__ float part[2][kWarps];
  for (int i = threadIdx.x; i < D; i += kThreads) w1[i] = 1.f + to_f(w[i]);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = kWarps / wpr, grp = warp / wpr;
  const int t = (warp % wpr) * 32 + lane, tpr = wpr * 32;
  const int nvec = D / V;
  int parity = 0;
  for (long row = (long)blockIdx.x * groups + grp; row < rows;
       row += (long)gridDim.x * groups) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
    uint4 v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + i * tpr;
      if (j < nvec) v[i] = xr[j];
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (t + i * tpr < nvec) {
        float f[V];
        load_vec<T>(v[i], f);
#pragma unroll
        for (int e = 0; e < V; ++e) ss = fmaf(f[e], f[e], ss);
      }
    }
    ss = warp_sum(ss);
    if (wpr > 1) {             // the group's warps add their sums
      if (lane == 0) part[parity][warp] = ss;
      group_barrier(1 + grp, tpr);
      ss = 0.f;
      for (int k = 0; k < wpr; ++k) ss += part[parity][grp * wpr + k];
      parity ^= 1;
    }
    const float r = rsqrtf(ss / (float)D + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + row * D);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + i * tpr;
      if (j < nvec) {
        float f[V];
        load_vec<T>(v[i], f);
        const float4* wv = reinterpret_cast<const float4*>(w1 + j * V);
#pragma unroll
        for (int e4 = 0; e4 < V / 4; ++e4) {
          const float4 ww = wv[e4];
          f[4 * e4] = f[4 * e4] * r * ww.x;
          f[4 * e4 + 1] = f[4 * e4 + 1] * r * ww.y;
          f[4 * e4 + 2] = f[4 * e4 + 2] * r * ww.z;
          f[4 * e4 + 3] = f[4 * e4 + 3] * r * ww.w;
        }
        orow[j] = store_vec<T>(f);
      }
    }
  }
}

// one block per row, element loads: any D and any alignment
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_scalar_kernel(const T* x, const W* w, T* out, int D, float eps) {
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

enum Body { kScalar = 0, kRows = 1 };   // rmsnorm.BODIES

template <typename T, typename W, int NV>
cudaError_t launch_rows(const T* x, const W* w, T* out, long rows, int D,
                        int wpr, int blocks, float eps, cudaStream_t s) {
  void (*kernel)(const T*, const W*, T*, long, int, int, float) =
      rmsnorm_rows_kernel<T, W, NV>;
  const size_t smem = (size_t)D * sizeof(float);
  cudaError_t e = opt_in_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kThreads, smem, s>>>(x, w, out, rows, D, wpr, eps);
  return cudaGetLastError();
}

// The body the plan names, after checking that it takes this shape: the
// rows body needs x and out 16-byte aligned, D a whole number of vectors,
// wpr in {1, 2, 4}, nv in {4, 8, 16} and the row within wpr x 32 x nv
// vectors.
template <typename T, typename W>
cudaError_t launch(const void* xp, const void* wp, void* op, long rows,
                   int D, float eps, int body, int wpr, int nv, int blocks,
                   cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const W* w = static_cast<const W*>(wp);
  T* out = static_cast<T*>(op);
  constexpr int V = Vec16<T>::n;
  if (rows == 0) return cudaSuccess;
  if (body == kScalar) {
    rmsnorm_scalar_kernel<T, W><<<(unsigned)rows, kThreads, 0, s>>>(
        x, w, out, D, eps);
    return cudaGetLastError();
  }
  const bool vec = D % V == 0 &&
                   ((uintptr_t)xp | (uintptr_t)op) % 16 == 0;
  if (!vec || blocks < 1 || body != kRows ||
      !(wpr == 1 || wpr == 2 || wpr == 4) ||
      (long)D / V > (long)wpr * 32 * nv)
    return cudaErrorInvalidValue;
  switch (nv) {
    case 4: return launch_rows<T, W, 4>(x, w, out, rows, D, wpr, blocks,
                                        eps, s);
    case 8: return launch_rows<T, W, 8>(x, w, out, rows, D, wpr, blocks,
                                        eps, s);
    case 16: return launch_rows<T, W, 16>(x, w, out, rows, D, wpr, blocks,
                                          eps, s);
    default: return cudaErrorInvalidValue;
  }
}

// w at x's type or at fp32
template <typename T>
cudaError_t launch_w(bool w_f32, const void* x, const void* w, void* out,
                     long rows, int D, float eps, int body, int wpr, int nv,
                     int blocks, cudaStream_t s) {
  return w_f32 ? launch<T, float>(x, w, out, rows, D, eps, body, wpr, nv,
                                  blocks, s)
               : launch<T, T>(x, w, out, rows, D, eps, body, wpr, nv, blocks,
                              s);
}

}  // namespace

// dtype of x and out: 0 = float32, 1 = float16, 2 = bfloat16; w_f32: w is
// fp32 (else at x's dtype).  body / wpr / nv / blocks: the plan
// (rmsnorm.rmsnorm_plan; body 0 scalar, 1 rows).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// plan the shape does not fit.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              int dtype, int w_f32, long rows, int D,
                              float eps, int body, int wpr, int nv,
                              int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float, float>(x, w, out, rows, D, eps, body, wpr,
                                       nv, blocks, s);
    case 1:
      return (int)launch_w<__half>(w_f32, x, w, out, rows, D, eps, body,
                                   wpr, nv, blocks, s);
    case 2:
      return (int)launch_w<__nv_bfloat16>(w_f32, x, w, out, rows, D, eps,
                                          body, wpr, nv, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
