// Weight-only int8 matrix product for Hopper (sm_90a), bound to PyTorch
// through a plain C interface (ctypes); see
// repro_torch/kernels/quant_matmul.py.
//
// Replaces the Pallas TPU kernel repro/kernels/quant_matmul.py
// quant_matmul (body _kernel):
//
//     out (M, N) fp32 = (x (M, K) @ q (K, N) int8) * s (N,) fp32
//
// with x at fp32, fp16 or bf16 (converted to fp32 as it is staged), the
// product of codes accumulated in fp32 and the per-output-channel scale
// applied once per output, in the epilogue (the per-column identity
// x @ (q * s) == (x @ q) * s the TPU kernel uses).
//
// Bound: at decode (M <= 8) by device-memory bytes, the K x N code bytes
// read once; at M = 256 the CUDA cores' fp32 rate bounds this version
// (tensor cores come later).  Design: each block owns 32 output columns
// (one per lane, so a warp reads 32 contiguous code bytes of a row of q)
// and an M-tile of MT rows (8, 16 or 32) whose accumulators live in
// registers; its 8 warps take interleaved rows of q, and the x tile of
// each 256-row slice of K is staged in shared memory as fp32 (read from x
// along its rows, so the loads coalesce), read by every lane as
// broadcasts.  The warps' partial sums are added in warp
// order at the end.  When those blocks are too few to fill the card (small
// N at decode), K is also split over blockIdx.z: each split writes its fp32
// partial sums to a workspace, and a second kernel adds the splits in
// order and applies the scale.  Every shape is handled in the kernel with
// bounds checks; nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "dtype.cuh"

namespace {

constexpr int kQmThreads = 256;
constexpr int kQmWarps = kQmThreads / 32;
constexpr int kQmCols = 32;            // output columns per block
constexpr int kQmKChunk = 256;         // rows of q per staged x tile
constexpr int kQmTargetBlocks = 528;   // 4 per SM of an H100
constexpr int kQmMaxSplits = 16;

int m_tile(int M) { return M <= 8 ? 8 : M <= 16 ? 16 : 32; }

int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

// grid (N / 32, M / MT, splits); split z covers q rows
// [z * chunks * 256, (z + 1) * chunks * 256).  part == nullptr: write
// out = sum * s; else write the unscaled sum to part[z].
template <typename T, int MT>
__global__ void __launch_bounds__(kQmThreads)
    quant_matmul_kernel(const T* x, const int8_t* q, const float* s,
                        float* out, float* part, int M, int K, int N,
                        int chunks) {
  // the staged x tile [256][XS] (a row per k, MT values used; the 4
  // spare floats keep the float4 reads aligned and spread the stores
  // over the banks), later the warps' sums [8][MT][32]
  constexpr int XS = MT + 4;
  __shared__ __align__(16) float sm[kQmKChunk * XS];
  static_assert(kQmKChunk * XS >= kQmWarps * MT * kQmCols, "smem reuse");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockIdx.x * kQmCols + lane;
  const int m0 = blockIdx.y * MT;
  const int k_begin = blockIdx.z * chunks * kQmKChunk;
  const int k_end = min(K, k_begin + chunks * kQmKChunk);
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kQmKChunk) {
    const int kc = min(kQmKChunk, k_end - k0);
    __syncthreads();  // the previous tile has been read
    for (int i = threadIdx.x; i < kQmKChunk * MT; i += kQmThreads) {
      const int m = i / kQmKChunk, kk = i % kQmKChunk;
      sm[kk * XS + m] = (kk < kc && m0 + m < M)
                            ? to_f(x[(long)(m0 + m) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int8_t* qc = q + (long)k0 * N + n;
#pragma unroll 8
      for (int kk = warp; kk < kc; kk += kQmWarps) {
        const float w = (float)qc[(long)kk * N];
        const float4* xr = reinterpret_cast<const float4*>(sm + kk * XS);
#pragma unroll
        for (int j = 0; j < MT / 4; ++j) {
          const float4 xv = xr[j];
          acc[4 * j] = fmaf(xv.x, w, acc[4 * j]);
          acc[4 * j + 1] = fmaf(xv.y, w, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(xv.z, w, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(xv.w, w, acc[4 * j + 3]);
        }
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) sm[(warp * MT + m) * kQmCols + lane] = acc[m];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * kQmCols; i += kQmThreads) {
    const int m = i / kQmCols, c = i % kQmCols;
    const int row = m0 + m, col = blockIdx.x * kQmCols + c;
    if (row >= M || col >= N) continue;
    float sum = 0.f;
    for (int w = 0; w < kQmWarps; ++w) sum += sm[(w * MT + m) * kQmCols + c];
    if (part)
      part[((long)blockIdx.z * M + row) * N + col] = sum;
    else
      out[(long)row * N + col] = sum * s[col];
  }
}

// out[i] = s[col] * (sum of the splits' partial sums, in split order)
__global__ void quant_matmul_reduce_kernel(const float* part, const float* s,
                                           float* out, int splits, long MN,
                                           int N) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float sum = 0.f;
  for (int z = 0; z < splits; ++z) sum += part[z * MN + i];
  out[i] = sum * s[i % N];
}

template <typename T, int MT>
cudaError_t launch_mt(const void* x, const int8_t* q, const float* s,
                      float* out, float* part, int M, int K, int N,
                      int splits, cudaStream_t stream) {
  const int chunks = std::max(1, cdiv(cdiv(K, kQmKChunk), splits));
  const dim3 grid(cdiv(N, kQmCols), cdiv(M, MT), splits);
  quant_matmul_kernel<T, MT><<<grid, kQmThreads, 0, stream>>>(
      static_cast<const T*>(x), q, s, out, splits > 1 ? part : nullptr, M, K,
      N, chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long MN = (long)M * N;
  quant_matmul_reduce_kernel<<<cdiv(MN, 256), 256, 0, stream>>>(
      part, s, out, splits, MN, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* q, const float* s,
                   float* out, float* part, int M, int K, int N, int splits,
                   cudaStream_t stream) {
  switch (m_tile(M)) {
    case 8: return launch_mt<T, 8>(x, q, s, out, part, M, K, N, splits,
                                   stream);
    case 16: return launch_mt<T, 16>(x, q, s, out, part, M, K, N, splits,
                                     stream);
    default: return launch_mt<T, 32>(x, q, s, out, part, M, K, N, splits,
                                     stream);
  }
}

}  // namespace

// How many slices of K a launch at this shape splits into (1: none).  The
// caller allocates a (splits, M, N) fp32 workspace when it is above 1.
extern "C" int quant_matmul_splits(int M, int K, int N) {
  const long blocks = (long)cdiv(N, kQmCols) * cdiv(M, m_tile(M));
  const int kchunks = cdiv(K, kQmKChunk);
  if (blocks >= kQmTargetBlocks || kchunks <= 1) return 1;
  const int splits = std::min(
      {kQmMaxSplits, kchunks, cdiv(kQmTargetBlocks, blocks)});
  return cdiv(kchunks, cdiv(kchunks, splits));  // no empty split
}

// dtype of x: 0 = float32, 1 = float16, 2 = bfloat16.  q (K, N) int8
// row-major, s (N,) fp32, out (M, N) fp32; workspace (splits, M, N) fp32
// when splits > 1.  M, N >= 1 and M <= 65535 * 32.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int quant_matmul_launch(const void* x, const void* q,
                                   const void* s, void* out, void* workspace,
                                   int dtype, int M, int K, int N, int splits,
                                   void* stream) {
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch<float>(x, qq, ss, o, ws, M, K, N, splits, st);
    case 1: return (int)launch<__half>(x, qq, ss, o, ws, M, K, N, splits, st);
    case 2:
      return (int)launch<__nv_bfloat16>(x, qq, ss, o, ws, M, K, N, splits,
                                        st);
    default: return (int)cudaErrorInvalidValue;
  }
}
