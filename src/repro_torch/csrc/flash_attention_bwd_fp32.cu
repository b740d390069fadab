// The flash attention backward at fp32 q/k/v, in a translation unit of its
// own; see flash_attention_bwd.cuh and flash_attention_bwd.cu.
#include "flash_attention_bwd.cuh"

namespace {

const NamedKernel kKernels[] = {
    BWD_MMA_ENTRIES(float, "fp32", 64, 64, 64),
    BWD_MMA_ENTRIES(float, "fp32", 64, 0, 0),
    BWD_MMA_ENTRIES(float, "fp32", 128, 0, 0),
    BWD_MMA_ENTRIES(float, "fp32", 256, 0, 0),
    {"attn_bwd_dkdv_sum_kernel<fp32>",
     (const void*)attn_bwd_dkdv_sum_kernel<float>},
};

}  // namespace

cudaError_t repro_bwd::launch_fp32(const BwdParams& p, const BwdPlan& plan,
                                   cudaStream_t stream) {
  return launch_mma<float>(p, plan, stream);
}

const NamedKernel* repro_bwd::kernels_fp32(int* n) {
  *n = (int)(sizeof(kKernels) / sizeof(kKernels[0]));
  return kKernels;
}
