// Dense flash attention backward for Hopper (sm_90a), bound to PyTorch
// through a plain C interface (ctypes); see
// repro_torch/kernels/flash_attention.py (flash_attention_bwd and its
// launch plan bwd_plan) and repro_torch/kernels/ops.py (FlashAttentionFn).
//
// Replaces no TPU kernel: the reference's Pallas flash_attention
// (repro/kernels/flash_attention.py) has no backward, and the reference
// trains by differentiating its plain jnp attention.  The port's forward
// on the card is the hand-written flash kernel (flash_attention.cu), whose
// output has no autograd history, so its gradient is this kernel.  It
// computes what jax.grad of the plain attention computes, from the
// forward's output o and its log-sum-exp lse (B, Hq, Sq), +inf for a row
// that sees no key:
//
//   P  = exp(S - lse) on visible entries, 0 elsewhere (S = scale q.k,
//        softcapped as the forward: cap tanh(S / cap))
//   D  = rowsum(dO o)
//   dS = P (dO.v - D) (1 - tanh^2) scale
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO
//
// with the forward's mask (positions, -1 = invalid, causal, optional
// window), GQA (query head h reads kv head h / g), any Dv (MLA: 192 / 128)
// and head dims up to 256.  Deterministic, no atomics: every sum is taken
// in a fixed order inside one block, or, where the plan splits a kv
// head's query heads over blocks, by a second launch that adds the
// splits' fp32 partials in split order; two calls give bit-identical
// gradients.
//
// Bound: at the train shapes (unimo-text 8 x 128 tokens of 16 x 64 heads,
// qwen3-4b's 4 x 128 of 32 / 8 x 128, gemma2-2b's 4 x 256 of 8 / 4 x 256,
// MLA's 128 heads of 192 / 128) by bytes, 5-13 us for q, k, v, o, dO and
// lse read and dq, dk, dv written once, above the tensor cores' time for
// the 2.5x forward flops over the visible pairs (chip_smoke.py:
// run_flash_bwd_case).  What holds a kernel of this size back in practice
// is the latency of each block's walk over its tiles and how many blocks
// fill the card; the design keeps every product on the tensor cores,
// every intermediate in registers, and the copies in flight behind them.
//
// One design for every dtype, on the tensor cores (mma.sync.m16n8k16 with
// fp32 accumulators), its block sizes and shared memory taken from the
// host-side plan after checking them against what the kernels were built
// for; two kernels (three with a head split):
//  - attn_bwd_dq_mma_kernel, grid (ceil(Sq g / 64), Hkv, B).  A block owns
//    64 rows of (query, head of the kv group) pairs, as the forward's
//    blocks do (attn_mma.cuh), so the g heads of a kv head read each K / V
//    tile once; a warp owns 16 rows.  It first writes D = rowsum(dO o) of
//    its rows (delta, which the dK / dV kernel reads; no launch of its
//    own), then walks 32-key tiles: S = Q K^T and dP = dO V^T, then P and
//    dS in registers, then dQ += dS K with dS re-packed from the
//    accumulators as the A operand.  dQ stays in registers.  A separate dQ
//    pass that recomputes S and dP (7 products where FlashAttention-2's
//    takes 5) is what keeps its sums free of atomics.
//  - attn_bwd_dkdv_mma_kernel, grid (ceil(Sk / Bc) x head splits, Hkv, B):
//    FlashAttention-2's backward with the keys as the M dimension of every
//    product.  A block owns Bc keys of one kv head, keeps their K and V in
//    shared memory and walks tiles of 32 (query, head) pairs of its heads:
//    S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in registers, then dV +=
//    P^T dO and dK += dS^T Q with P^T and dS^T re-packed from the
//    accumulators as A operands.  A warp owns 16 keys; above a head dim of
//    128 two warps share 16 keys and split dK's and dV's columns (both
//    recompute S^T and dP^T), so dK and dV stay within 128 registers a
//    lane.  Where the grid would be under one wave, the plan splits the g
//    query heads over blocks: each writes fp32 partials, and
//    attn_bwd_dkdv_sum_kernel adds them in split order.
// Both walks read positions first: a tile in which nothing can be visible
// (past the causal diagonal, outside the window, -1) is never requested.
// The rest come through a cp.async ring with one barrier a tile; a block's
// own rows, its positions and its first tiles are all in flight before it
// waits.  Every sum is fp32.  Two bodies of this design, chosen by q's
// dtype in the plan (flash_attention.py:bwd_plan, bodies "mma" and
// "split"; not a fallback):
//  * bf16 / fp16 ("mma"): operands at q's type in shared memory, fragments
//    by ldmatrix (K, Q and dO through ldmatrix.trans as B of the dQ, dK
//    and dV products); P and dS rounded to q's type for their products, as
//    FlashAttention-2 does.  A warp's fixed A operand (Q and dO rows in dQ
//    up to a head dim of 128, K and V rows in dK/dV at 64) stays in
//    registers for the whole walk.  Rings of three stages, two in the 256
//    bucket so that two dK/dV blocks fit an SM.
//  * fp32 ("split"): the same kernels over fp32 tiles, every operand of
//    every product cut into three bf16 parts whose sum is the value as its
//    fragment loads (attn_mma.cuh: mma_abt_split, mma_xb_split; the part
//    pairs i + j < 3, six mma a k-step), P and dS kept in fp32 and cut as
//    well, as the plain version keeps them: the products are exact to
//    ~2^-24 of their size, as fp32 FMAs are, where TF32 would keep three
//    decimal digits.  At a head dim of 64 a warp holds its fixed side's
//    first operand cut (Q's parts in dQ, K's in dK/dV) for the whole
//    walk; the second (dO, V) is cut again every tile.  The leading parts' products and the rest sum in
//    separate accumulators, and dQ's, dK's and dV's sums over each tile in
//    fresh ones added with fp32 adds (the tensor cores add with
//    truncation).  fp32 rows take twice the room: the dQ block computes D
//    from o in device memory instead of staging it, and the 256 bucket's
//    rings hold one tile (dQ) or two (dK/dV).
// The kernels and their launcher are in flash_attention_bwd.cuh, built
// once a dtype (flash_attention_bwd_{bf16,fp16,fp32}.cu) so that nvcc
// compiles the three in parallel; this file holds the entry points.
// What measured best at bf16 (chip_smoke.py, PERF.md): nothing checked at
// run time inside a tile's unrolled work.  The train shapes' head dims
// (64, 128, 256, MLA's 192 / 128) have kernels of their own with constant
// loop bounds (fp32: 64, the fp32 train step's), the rest their bucket's
// general ones, and the softcap and the mask each select their own copy of
// the probabilities' loop.  At these shapes the kernels are bound by their
// registers (dK and dV take 128 a lane above a head dim of 64: two blocks
// an SM) and each block's fixed cost (its first copies and positions, one
// launch), not by bytes or the tensor cores.
#include <cuda_runtime.h>

#include "flash_attention_bwd.cuh"

// dtype: 0 = float32, 1 = float16, 2 = bfloat16, for q, k, v, o, dout and
// the gradients; lse (B, Hq, Sq) from the forward and delta (B, Hq, Sq), a
// scratch buffer, are fp32.  The launch plan (flash_attention.py:bwd_plan):
// `body` (1: "mma", bf16 / fp16 only; 2: "split", fp32 only), the keys of
// a dK/dV block and the rows of a dQ block, which size the grids,
// `head_splits` of each kv head's query heads over dK/dV blocks, and each
// block's shared-memory bytes; with more than one split `part`, fp32
// scratch of B * Sk * Hkv * head_splits * (D + Dv).  A plan the kernels
// were not built for is cudaErrorInvalidValue.  Launches on `stream`: dQ
// (with D), dK / dV, and the splits' sum.  Returns cudaGetLastError()
// after them (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* q_pos, const void* k_pos,
    void* delta, void* dq, void* dk, void* dv, int dtype, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, int Dv, float scale, float softcap,
    int window, int body, int block_keys, int dq_rows, int head_splits,
    int smem_dq, int smem_dkdv, void* part, void* stream) {
  BwdParams p{q, k, v, o, dout, static_cast<const float*>(lse),
              static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
              static_cast<float*>(delta), dq, dk, dv, B, Sq, Sk, Hq, Hkv,
              Hq / Hkv, D, Dv, scale, softcap, window, head_splits,
              static_cast<float*>(part)};
  const BwdPlan plan{block_keys, dq_rows, smem_dq, smem_dkdv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body != (dtype == 0 ? 2 : 1)) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)repro_bwd::launch_fp32(p, plan, s);
    case 1: return (int)repro_bwd::launch_fp16(p, plan, s);
    case 2: return (int)repro_bwd::launch_bf16(p, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The name of kernel i of the backward (its three units' kernels in turn;
// null past the last) and, from cudaFuncGetAttributes, its registers a
// thread and local memory a thread (spills) into attrs[0..1]; attrs[0] =
// -1 if the query failed.
extern "C" const char* flash_attention_bwd_kernel_attrs(int i, int* attrs) {
  const repro_bwd::NamedKernel* (*units[])(int*) = {
      repro_bwd::kernels_bf16, repro_bwd::kernels_fp16,
      repro_bwd::kernels_fp32};
  if (i < 0) return nullptr;
  for (auto unit : units) {
    int n = 0;
    const repro_bwd::NamedKernel* k = unit(&n);
    if (i >= n) {
      i -= n;
      continue;
    }
    cudaFuncAttributes fa;
    if (cudaFuncGetAttributes(&fa, k[i].fn) != cudaSuccess) {
      attrs[0] = attrs[1] = -1;
    } else {
      attrs[0] = fa.numRegs;
      attrs[1] = (int)fa.localSizeBytes;
    }
    return k[i].name;
  }
  return nullptr;
}
