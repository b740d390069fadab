// The tensor-core bodies of the paged attention kernels (paged_attention.cu),
// each kind in a translation unit of its own -- paged_decode_mma.cu,
// paged_mixed_mma.cu, paged_packed_mma.cu -- so that nvcc builds the three
// beside each other and beside the rest: together in one source they were
// the build's long pole (36 instantiations of mma_attend, ~80 s of ptxas).
// Each unit defines its kernel template (a __global__ wrapper of
// attn_mma.cuh's mma_attend, the same code as before the split) and its
// launcher below; paged_attention.cu's launch_windows calls them.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_mma.cuh"

namespace repro_attn {

// The decode, mixed or packed kernel over ``units`` units (batch rows, or
// packed work rows) at q's dtype (1 = float16, 2 = bfloat16) over a pool of
// that dtype or of int8 codes (``quant``), at the head-dim bucket of
// max(D, Dv); cudaErrorInvalidValue for another dtype.
cudaError_t paged_decode_mma_launch(int dtype, bool quant, const MmaArgs& a,
                                    int units, cudaStream_t stream);
cudaError_t paged_mixed_mma_launch(int dtype, bool quant, const MmaArgs& a,
                                   int units, cudaStream_t stream);
cudaError_t paged_packed_mma_launch(int dtype, bool quant, const MmaArgs& a,
                                    int units, cudaStream_t stream);

}  // namespace repro_attn

namespace {

constexpr int kPagedMmaThreads = 128;   // four warps of 16 rows at most

// Launch Kernels::get<T, KV, DMAX>() at the head-dim bucket of max(D, Dv)
// (64, 128 or 256) and q's dtype, ``warps`` warps a block (0: four).
template <class Kernels, typename T, typename KV>
cudaError_t launch_bucket(const MmaArgs& a, int units, cudaStream_t stream,
                          int warps) {
  const int dvp = round16(a.D > a.Dv ? a.D : a.Dv);
  if (warps == 0) warps = kMmaRows / 16;
  return dvp <= 64
             ? mma_launch(Kernels::template get<T, KV, 64>(), a, units,
                          stream, warps)
         : dvp <= 128
             ? mma_launch(Kernels::template get<T, KV, 128>(), a, units,
                          stream, warps)
             : mma_launch(Kernels::template get<T, KV, 256>(), a, units,
                          stream, warps);
}

template <class Kernels>
cudaError_t launch_paged_mma(int dtype, bool quant, const MmaArgs& a,
                             int units, cudaStream_t stream, int warps) {
  if (units == 0 || a.NQ == 0) return cudaSuccess;
  switch (dtype) {
    case 1:
      return quant ? launch_bucket<Kernels, __half, int8_t>(a, units, stream,
                                                            warps)
                   : launch_bucket<Kernels, __half, __half>(a, units, stream,
                                                            warps);
    case 2:
      return quant ? launch_bucket<Kernels, __nv_bfloat16, int8_t>(
                         a, units, stream, warps)
                   : launch_bucket<Kernels, __nv_bfloat16, __nv_bfloat16>(
                         a, units, stream, warps);
    default: return cudaErrorInvalidValue;
  }
}

// The warps of a decode or packed block: only those its rows fill
inline int filled_warps(const MmaArgs& a) {
  return ((a.NQ * a.g < kMmaRows ? a.NQ * a.g : kMmaRows) + 15) / 16;
}

}  // namespace
