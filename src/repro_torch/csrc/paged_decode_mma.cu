// The paged decode kernels' tensor-core body (paged_decode_attention[_q8]
// at bf16 / fp16 q), in a translation unit of its own; see paged_mma.cuh
// and, for what it computes and what bounds it, paged_attention.cu.
#include "paged_mma.cuh"

namespace {

// grid (row_tiles * splits, Hkv, B), ceil(min(g, 64) / 16) warps: slot
// b's single query token, the g heads of kv head h, against the keys of
// split s (tensor cores, bf16 / fp16 q; pools at q's dtype or int8).  Its
// own symbol keeps decode launches apart from mixed ones in a profile.
template <typename T, typename KV, int DMAX>
__global__ void __launch_bounds__(kPagedMmaThreads, mma_min_blocks(DMAX))
    paged_decode_mma_kernel(MmaArgs a) {
  extern __shared__ float smem[];
  mma_attend<T, KV, DMAX>(a, reinterpret_cast<char*>(smem));
}

struct DecodeKernels {
  template <typename T, typename KV, int DMAX>
  static auto get() { return paged_decode_mma_kernel<T, KV, DMAX>; }
};

}  // namespace

cudaError_t repro_attn::paged_decode_mma_launch(int dtype, bool quant,
                                                const MmaArgs& a, int units,
                                                cudaStream_t stream) {
  return launch_paged_mma<DecodeKernels>(dtype, quant, a, units, stream,
                                         filled_warps(a));
}
