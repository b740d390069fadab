// Tensor-core and copy primitives for Hopper (sm_90a), shared by the
// attention core (attn_mma.cuh), flash_attention_bwd.cu, quant_matmul.cu,
// mlstm_chunk.cu and mlstm_chunk_bwd.cu:
// cp.async with zero fill, ldmatrix, mma.sync.m16n8k16 with fp32
// accumulators for bf16 / fp16, fp32 pairs rounded to bf16 / fp16, fp32
// values cut into bf16 parts whose sum is the value and the products of
// such parts (the fp32 operands of the mLSTM kernels and of flash
// attention's fp32 bodies), and exact int8 -> fp32 without I2F.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "dtype.cuh"

namespace {

// Opt ``kernel`` into ``bytes`` of dynamic shared memory on the current
// device (needed above 48 KB).  cudaFuncSetAttribute runs only when a
// launch needs more than the kernel was last given on that device: a
// call on every launch costs host time on the serve's launch path.
inline cudaError_t opt_in_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  struct Granted {
    const void* kernel;
    int device;
    size_t bytes;
  };
  static Granted granted[64];
  static int n = 0;
  static std::mutex mu;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < n && !(granted[i].kernel == kernel && granted[i].device == device))
    ++i;
  if (i < n && granted[i].bytes >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return e;
  if (i < n)
    granted[i].bytes = bytes;
  else if (n < 64)
    granted[n++] = {kernel, device, bytes};
  return cudaSuccess;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16, 8 or 4 bytes; with valid == false the destination is
// filled with zeros and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// two 8x8 matrices: lanes 0-15 give the row addresses
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col), fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to T (nearest even), lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as P bf16 pairs (x0 in the low halves) whose sums are x0 and
// x1 to 2^-8P of their size: each part is the bf16 rounding of what the
// parts before it left (exact fp32 differences)
template <int P>
__device__ __forceinline__ void split_bf16(float x0, float x1,
                                           uint32_t (&out)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    out[p] = pack2<__nv_bfloat16>(x0, x1);
    x0 -= __uint_as_float(out[p] << 16);
    x1 -= __uint_as_float(out[p] & 0xffff0000u);
  }
}

// one fp32 value as P bf16 parts at dst[0], dst[stride], ...
template <int P>
__device__ __forceinline__ void split_store(float x, __nv_bfloat16* dst,
                                            int stride) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const __nv_bfloat16 b = __float2bfloat16_rn(x);
    *dst = b;
    x -= __bfloat162float(b);
    dst += stride;
  }
}

// Fragments of mma.m16n8k16 from fp32 or T values in shared memory, cut
// into P bf16 parts (split_bf16), and products over the part pairs: the
// operands of the mLSTM backward and of flash attention's fp32 bodies.

__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld_pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
template <typename E>
__device__ __forceinline__ float2 ld_pair_strided(const E* p, int stride) {
  return make_float2(to_f(p[0]), to_f(p[stride]));
}

// A (16 x 16 from row m0, column k0) of X as P parts: kRowMajor, X[m][k] at
// p[m * ld + k]; else X[m][k] at p[k * ld + m]
template <int P, bool kRowMajor, typename E>
__device__ __forceinline__ void load_a(uint32_t (&a)[P][4], const E* p,
                                       int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int m = m0 + gid + (x & 1) * 8, k = k0 + 2 * tig + (x >> 1) * 8;
    const float2 f = kRowMajor ? ld_pair(p + m * ld + k)
                               : ld_pair_strided(p + k * ld + m, ld);
    uint32_t s[P];
    split_bf16<P>(f.x, f.y, s);
#pragma unroll
    for (int pp = 0; pp < P; ++pp) a[pp][x] = s[pp];
  }
}

// B (16 x 8 from row k0, column n0) of Y as P parts: kNK, Y[k][n] at
// p[n * ld + k]; else Y[k][n] at p[k * ld + n]
template <int P, bool kNK, typename E>
__device__ __forceinline__ void load_b(uint32_t (&b)[P][2], const E* p,
                                       int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int k = k0 + 2 * tig + x * 8, n = n0 + gid;
    const float2 f = kNK ? ld_pair(p + n * ld + k)
                         : ld_pair_strided(p + k * ld + n, ld);
    uint32_t s[P];
    split_bf16<P>(f.x, f.y, s);
#pragma unroll
    for (int pp = 0; pp < P; ++pp) b[pp][x] = s[pp];
  }
}

// d += a b over the part pairs (i, j) with i + j below the larger count
template <int PA, int PB>
__device__ __forceinline__ void mma_parts(float (&d)[4],
                                          const uint32_t (&a)[PA][4],
                                          const uint32_t (&b)[PB][2]) {
  constexpr int top = PA > PB ? PA : PB;
#pragma unroll
  for (int i = 0; i < PA; ++i)
#pragma unroll
    for (int j = 0; j < PB; ++j)
      if (i + j < top) mma16816<__nv_bfloat16>(d, a[i], b[j][0], b[j][1]);
}

// mma_parts with the product of the leading parts in `hi` and every other
// pair in `lo`: the tensor cores add into their accumulator with
// truncation at the size of the largest term, so the small pairs summed
// into hi would each cost it an ulp; the caller adds lo to hi once
template <int PA, int PB>
__device__ __forceinline__ void mma_parts_apart(float (&hi)[4], float (&lo)[4],
                                                const uint32_t (&a)[PA][4],
                                                const uint32_t (&b)[PB][2]) {
  constexpr int top = PA > PB ? PA : PB;
  mma16816<__nv_bfloat16>(hi, a[0], b[0][0], b[0][1]);
#pragma unroll
  for (int i = 0; i < PA; ++i)
#pragma unroll
    for (int j = 0; j < PB; ++j)
      if (i + j > 0 && i + j < top)
        mma16816<__nv_bfloat16>(lo, a[i], b[j][0], b[j][1]);
}

// The A fragment (16 rows x 16, P parts) of a k-step held in the fp32
// accumulators of two 16 x 8 tiles: columns 0-7 in c0, 8-15 in c1
template <int P>
__device__ __forceinline__ void split_acc_a(uint32_t (&a)[P][4],
                                            const float (&c0)[4],
                                            const float (&c1)[4]) {
  const float v[8] = {c0[0], c0[1], c0[2], c0[3],
                      c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t s[P];
    split_bf16<P>(v[2 * r], v[2 * r + 1], s);
#pragma unroll
    for (int p = 0; p < P; ++p) a[p][r] = s[p];
  }
}

// Two adjacent fp32 values stored at T (rounded to nearest even)
template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y) {
  if constexpr (std::is_same_v<T, float>)
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  else
    *reinterpret_cast<uint32_t*>(p) = pack2<T>(x, y);
}

// Exact fp32 values of int8 codes without I2F: the byte c + 128 (c ^ 0x80)
// becomes the low mantissa of 2^23, and 2^23 + 128 is subtracted.  lo / hi
// take bytes 0 and 1 of x.
__device__ __forceinline__ float i8_lo(unsigned x) {
  return __int_as_float(__byte_perm(x ^ 0x8080u, 0x4B000000u, 0x7440)) -
         8388736.f;
}
__device__ __forceinline__ float i8_hi(unsigned x) {
  return __int_as_float(__byte_perm(x ^ 0x8080u, 0x4B000000u, 0x7441)) -
         8388736.f;
}
// two adjacent int8 codes (2-byte aligned) in one shared-memory load
__device__ __forceinline__ unsigned i8pair(const int8_t* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// Two int8 codes as a T pair for an mma fragment, exactly (|code| <= 128
// has at most 8 significant bits): byte B of lo in the low half, byte B of
// hi in the high half.  lo and hi hold codes already XORed with 0x80 (u =
// code + 128, one LOP3 per four codes).  bf16: 2^23 + u as an fp32 (a byte
// permute), minus 2^23 + 128, and the top halves of the two fp32 words
// (exact: the low 16 bits are zero).  fp16: 1024 + u as a half (the byte
// under the exponent byte 0x64), minus 1152 in one HSUB2.
template <typename T, int B>
__device__ __forceinline__ uint32_t code_pair(uint32_t lo, uint32_t hi) {
  static_assert(B >= 0 && B < 4, "a byte of a 32-bit word");
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const float f0 =
        __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7440 | B)) -
        8388736.f;
    const float f1 =
        __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7440 | B)) -
        8388736.f;
    return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  } else {
    static_assert(std::is_same_v<T, __half>, "bf16 or fp16");
    const uint32_t t = __byte_perm(lo, hi, B | ((B + 4) << 4));
    const uint32_t h = __byte_perm(t, 0x64646464u, 0x4140);
    uint32_t r;
    asm("sub.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(h), "r"(0x64806480u));
    return r;
  }
}

}  // namespace
