// The paged packed kernels' tensor-core body (paged_packed_attention[_q8]
// at bf16 / fp16 q), in a translation unit of its own; see paged_mma.cuh
// and, for what it computes and what bounds it, paged_attention.cu.
#include "paged_mma.cuh"

namespace {

// grid (row_tiles * splits, Hkv, n_work), ceil(min(8 g, 64) / 16) warps:
// rows [64 t, 64 t + 64) of work row w's lanes x the g heads of kv head h
// against the keys of split s of its slot (tensor cores, bf16 / fp16 q;
// pools at q's dtype or int8).
template <typename T, typename KV, int DMAX>
__global__ void __launch_bounds__(kPagedMmaThreads, mma_min_blocks(DMAX))
    paged_packed_mma_kernel(MmaArgs a) {
  extern __shared__ float smem[];
  mma_attend<T, KV, DMAX>(a, reinterpret_cast<char*>(smem));
}

struct PackedKernels {
  template <typename T, typename KV, int DMAX>
  static auto get() { return paged_packed_mma_kernel<T, KV, DMAX>; }
};

}  // namespace

cudaError_t repro_attn::paged_packed_mma_launch(int dtype, bool quant,
                                                const MmaArgs& a, int units,
                                                cudaStream_t stream) {
  return launch_paged_mma<PackedKernels>(dtype, quant, a, units, stream,
                                         filled_warps(a));
}
