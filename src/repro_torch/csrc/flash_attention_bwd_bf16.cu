// The flash attention backward at bf16 q/k/v, in a translation unit of its
// own; see flash_attention_bwd.cuh and flash_attention_bwd.cu.
#include "flash_attention_bwd.cuh"

namespace {

const NamedKernel kKernels[] = {
    BWD_MMA_ENTRIES(__nv_bfloat16, "bf16", 64, 64, 64),
    BWD_MMA_ENTRIES(__nv_bfloat16, "bf16", 128, 128, 128),
    BWD_MMA_ENTRIES(__nv_bfloat16, "bf16", 256, 256, 256),
    BWD_MMA_ENTRIES(__nv_bfloat16, "bf16", 256, 192, 128),
    BWD_MMA_ENTRIES(__nv_bfloat16, "bf16", 64, 0, 0),
    BWD_MMA_ENTRIES(__nv_bfloat16, "bf16", 128, 0, 0),
    BWD_MMA_ENTRIES(__nv_bfloat16, "bf16", 256, 0, 0),
    {"attn_bwd_dkdv_sum_kernel<bf16>",
     (const void*)attn_bwd_dkdv_sum_kernel<__nv_bfloat16>},
};

}  // namespace

cudaError_t repro_bwd::launch_bf16(const BwdParams& p, const BwdPlan& plan,
                                   cudaStream_t stream) {
  return launch_mma<__nv_bfloat16>(p, plan, stream);
}

const NamedKernel* repro_bwd::kernels_bf16(int* n) {
  *n = (int)(sizeof(kKernels) / sizeof(kKernels[0]));
  return kKernels;
}
