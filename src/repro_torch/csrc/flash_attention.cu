// Dense flash attention (forward) for Hopper (sm_90a), bound to PyTorch
// through a plain C interface (ctypes); see
// repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel of the reference package
// repro/kernels/flash_attention.py:flash_attention (body _kernel):
// q (B,Sq,Hq,D) against k/v (B,Sk,Hkv,D[v]), query head h reading kv head
// h / g (g = Hq / Hkv), with the mask built from absolute positions
// (q_pos (B,Sq), k_pos (B,Sk); key visible when 0 <= kp <= qp, and
// kp > qp - window with a window), an optional softcap, and an fp32 online
// softmax.  The output is at q's dtype; a row that sees no key is 0.  Any
// Sq and Sk: the ragged last tiles are masked here, so the TPU wrapper's
// "Sq divisible by the block" limit does not carry over.  For training the
// launcher also takes an lse buffer (B, Hq, Sq) fp32: each row's
// log-sum-exp of its visible scores, +inf for a row that sees no key (so
// the backward's exp(s - lse) is exactly 0 there), which
// flash_attention_bwd.cu reads; serving calls pass null and store nothing.
//
// One body for every dtype, flash_mma_kernel, the tensor-core core of
// attn_mma.cuh.  A block takes 64 rows of (query, head of the kv group)
// pairs of one batch row and kv head, so at GQA the K/V tile is read once
// for all g heads; 32-key tiles come through a cp.async ring (three
// stages; two for fp32 tiles in the 256 bucket), their positions read
// first so a tile beyond the causal diagonal or outside the window is
// never requested; Q.K^T and P.V are mma.sync.m16n8k16 with fp32
// accumulators and the online softmax in registers.  Grid (ceil(Sq * g /
// 64), Hkv, B).
//
//  * bf16 / fp16: the operands at their type through ldmatrix; P rounded
//    to q's type for P.V.
//  * fp32: the same walk over fp32 tiles, each operand of each product cut
//    into three bf16 parts whose sum is the value (mma_parts_apart: the
//    part pairs i + j < 3, six mma a k-step), P kept in fp32 and cut as
//    well, so the products are exact to ~2^-24 of their size: as accurate
//    as fp32 FMAs, where TF32 tensor cores would keep about three decimal
//    digits.  The leading parts' products and the rest sum in separate
//    accumulators, and P.V's sums over each tile in fresh ones added to O
//    with fp32 adds: the tensor cores add with truncation, and the error
//    of one long chain would grow with its length.  Up to a head dim of 64
//    each warp's Q parts stay in registers for the whole walk.
//
// Bound: at the shapes the port runs it (the draft model's full forwards,
// 8 x 260 tokens at 16 heads x 64; the fp32 train step's 8 x 128) by
// bytes, at ~5 us for q, k, v and out once, though causal attention does
// 4 * D flops per visible (query, key) pair and head (six times that in
// bf16 products at fp32).  What still bounds the body there is neither:
// it is the time each block spends per 32-key tile (two block barriers,
// the copy issue, the mask and the online softmax's scalar work beside 32
// mma per warp, 192 at fp32, whose fragments are cut from fp32 rows) and
// the fixed cost of staging Q and positions, so it runs ~6x its bound at
// bf16 (PERF.md).  Longer key tiles, wgmma over 64-row warpgroups and TMA
// copies are the next steps.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "dtype.cuh"

namespace {

constexpr int kThreads = 128;

struct Params {
  const void* q;      // (B,Sq,Hq,D)
  const void* k;      // (B,Sk,Hkv,D)
  const void* v;      // (B,Sk,Hkv,Dv)
  const int* q_pos;   // (B,Sq)
  const int* k_pos;   // (B,Sk)
  void* out;          // (B,Sq,Hq,Dv)
  float* lse;         // (B,Hq,Sq) or null
  int Sq, Sk, Hq, Hkv, g, D, Dv;
  float scale, softcap;  // softcap <= 0: none
  int window;            // window <= 0: none
};

// grid (ceil(Sq * g / 64), Hkv, B): one tile of 64 (query, group head)
// rows of batch row b against kv head h
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, mma_min_blocks(DMAX, sizeof(T)))
    flash_mma_kernel(MmaArgs a) {
  extern __shared__ float smem[];
  mma_attend<T, T, DMAX>(a, reinterpret_cast<char*>(smem));
}

template <typename T>
cudaError_t launch_mma(int B, const Params& p, cudaStream_t stream) {
  if (B == 0 || p.Sq == 0) return cudaSuccess;
  MmaArgs a{};
  a.q = p.q;
  a.k = p.k;
  a.v = p.v;
  a.kpos = p.k_pos;
  a.q_pos = p.q_pos;
  a.out = p.out;
  a.lse = p.lse;
  a.NQ = p.Sq;
  a.Sk = p.Sk;
  a.Hq = p.Hq;
  a.Hkv = p.Hkv;
  a.g = p.g;
  a.D = p.D;
  a.Dv = p.Dv;
  a.row_tiles = (p.Sq * p.g + kMmaRows - 1) / kMmaRows;
  a.splits = 1;
  a.keys_per_split = p.Sk;
  a.scale = p.scale;
  a.softcap = p.softcap;
  a.window = p.window;
  const int dvp = round16(p.D > p.Dv ? p.D : p.Dv);   // head-dim bucket
  constexpr int w = kMmaRows / 16;
  constexpr bool f32 = sizeof(T) == 4;
  return dvp <= 64
             ? mma_launch(flash_mma_kernel<T, 64>, a, B, stream, w, f32)
         : dvp <= 128
             ? mma_launch(flash_mma_kernel<T, 128>, a, B, stream, w, f32)
             : mma_launch(flash_mma_kernel<T, 256>, a, B, stream, w, f32);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16, for q, k, v and out (all
// on the tensor cores; fp32 as bf16 parts); lse: (B, Hq, Sq) fp32 or null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, void* out, void* lse, int dtype, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, int Dv, float scale, float softcap,
    int window, void* stream) {
  Params p{q, k, v, static_cast<const int*>(q_pos),
           static_cast<const int*>(k_pos), out, static_cast<float*>(lse),
           Sq, Sk, Hq, Hkv, Hq / Hkv, D, Dv, scale, softcap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_mma<float>(B, p, s);
    case 1: return (int)launch_mma<__half>(B, p, s);
    case 2: return (int)launch_mma<__nv_bfloat16>(B, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
