// Hopper (sm_90a) building blocks for warpgroup kernels fed by the Tensor
// Memory Accelerator, used by ragged_matmul.cu:
//
//  * host: tensor maps (cuTensorMapEncodeTiled, reached through the runtime's
//    cudaGetDriverEntryPoint, so the library links without -lcuda), 128-byte
//    swizzled boxes of 64 16-bit elements on the innermost dimension, or
//    unswizzled fp32 boxes;
//  * mbarrier: init, arrive, arrive with an expected byte count, parity wait
//    (which traps after seconds rather than hang on a phase that never
//    completes);
//  * TMA: 2-D / 3-D tiled loads that complete on an mbarrier, 3-D tiled
//    stores from shared memory in bulk groups, their commit and waits;
//  * wgmma: shared-memory matrix descriptors for the 128-byte swizzle,
//    fence / commit / wait, and m64n128k16 with fp32 accumulators for bf16
//    and fp16 operands, either of them K-major or MN-major (transposed);
//  * the proxy fence between generic shared-memory writes and the async
//    proxy (TMA, wgmma), and named barriers over a subset of the block.
//
// Layouts (the canonical GMMA layouts of the 128-byte swizzle): a box of
// 64 x 16-bit elements per row lands as 128-byte rows, 8 rows (1 KB) per
// swizzle atom, so a tile's base must be 1 KB aligned.
//  * K-major operand (K contiguous): rows of the M/N dimension, 8-row
//    groups 1 KB apart (SBO); a k16 step moves the start by 32 bytes.
//  * MN-major operand (M/N contiguous, the transpose bit set): rows of the
//    K dimension, 8-row K groups 1 KB apart (SBO), 64-element atoms along
//    M/N LBO bytes apart; a k16 step moves the start by 16 rows (2 KB).
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "dtype.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled's entry point, looked up once (null where the
// CUDA installation has none)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  });
  return fn;
}

// A map over a row-major tensor of 16-bit elements (bf16 if ``bf16``, else
// fp16) of ``rank`` dims (innermost first, dims[0] contiguous), boxes of
// box[] elements, 128-byte swizzle, zeros outside the tensor.  Returns
// false if the encoding is refused.
inline bool tensor_map16(CUtensorMap* map, const void* ptr, bool bf16,
                         int rank, const cuuint64_t* dims,
                         const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  cuuint64_t strides[2];
  cuuint64_t s = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
            (cuuint32_t)rank, const_cast<void*>(ptr), dims, strides, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map over a row-major fp32 tensor of ``rank`` dims (innermost first),
// boxes of box[] elements landing unswizzled (rows of box[0] x 4 bytes,
// box[0] at most 256), zeros outside the tensor: the raw tiles the fp32
// bodies cut into bf16 parts themselves.  Returns false if the encoding is
// refused.
inline bool tensor_map_f32(CUtensorMap* map, const void* ptr, int rank,
                           const cuuint64_t* dims, const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  cuuint64_t strides[2];
  cuuint64_t s = 4;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank,
            const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// Device: barriers, fences
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// one arrival that also expects ``bytes`` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait for the completion of the barrier's phase of parity ``parity``; a
// phase that has not completed after kWaitLimitNs traps (a launch error)
// rather than hang the card
constexpr uint64_t kWaitLimitNs = 4000000000ull;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t n = 1;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 0xFFFF) == 0) {
      const uint64_t t = global_ns();
      if (!t0)
        t0 = t;
      else if (t - t0 > kWaitLimitNs)
        __trap();
    }
  }
}

// generic-proxy writes to shared memory before async-proxy accesses
// (wgmma operands, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier ``id`` (1..15) over ``kCount`` threads (whole warps)
template <int kCount>
__device__ __forceinline__ void named_bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kCount) : "memory");
}

// ---------------------------------------------------------------------------
// Device: TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// at most N bulk groups still reading their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// at most N bulk groups not yet complete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte swizzled operand at shared address ``addr``
// (a 1 KB aligned tile plus a k16 step's offset); lbo / sbo in bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of accumulators across the
// asynchronous wgmma's fence, commit and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_WGMMA_M64N128K16(TY)                                            \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." #TY "." #TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
      "%57, %58, %59, %60, %61, %62, %63}, "                                  \
      "%64, %65, p, 1, 1, %67, %68;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB))

// d (64 x 128, fp32) = A (64 x 16) B (16 x 128) + (scale_d ? d : 0), A and
// B in shared memory by descriptor; kTA / kTB = 1: the operand is MN-major.
// Thread t of the warpgroup holds d[4 j + x] at row 16 (t / 32) + (t % 32)
// / 4 (+ 8 for x >= 2), column 8 j + 2 (t % 4) (+ 1 for odd x).
template <typename T, int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    REPRO_WGMMA_M64N128K16(bf16);
  else
    REPRO_WGMMA_M64N128K16(f16);
}
#undef REPRO_WGMMA_M64N128K16

}  // namespace
