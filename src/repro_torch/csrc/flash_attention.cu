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
// Two bodies, chosen by q's dtype in the launcher (not a fallback):
//
//  * bf16 / fp16: flash_mma_kernel, the tensor-core core of attn_mma.cuh.
//    A block takes 64 rows of (query, head of the kv group) pairs of one
//    batch row and kv head, so at GQA the K/V tile is read once for all g
//    heads; 32-key tiles come through a three-stage cp.async ring, their
//    positions read first so a tile beyond the causal diagonal or outside
//    the window is never requested; Q.K^T and P.V are mma.sync.m16n8k16
//    with fp32 accumulators and the online softmax in registers.
//    Grid (ceil(Sq * g / 64), Hkv, B).
//  * fp32: flash_kernel, on CUDA cores.  A tensor-core body would multiply
//    in TF32 (about three decimal digits), and the card's fp32 greedy
//    streams must keep equalling the CPU's.  Grid (B, Hq, ceil(Sq / 32)):
//    32 query rows of one head, 32-key tiles through shared memory,
//    running max, denominator and accumulator in shared memory.
//
// Bound: at the shape the port runs it (the draft model's full forwards,
// 8 x 260 tokens at 16 heads x 64) by bytes, at ~5 us for q, k, v and out
// once, though causal attention does 4 * D flops per visible (query, key)
// pair and head.  What still bounds the tensor-core body there is neither:
// it is the time each block spends per 32-key tile (two block barriers,
// the copy issue, the mask and the online softmax's scalar work beside 32
// mma per warp) and the fixed cost of staging Q and positions, so it runs
// ~6x its bound (PERF.md).  Longer key tiles, wgmma over 64-row
// warpgroups and TMA copies are the next steps.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "dtype.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 32;   // query rows per block
constexpr int kBlockK = 32;   // keys per tile
constexpr size_t kMaxSmem = 227 * 1024;

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

__host__ __device__ inline size_t smem_floats(int D, int Dv) {
  // q rows, K tile (padded rows), V tile, score tile, accumulator,
  // m / l / alpha per row, then key and row positions as ints
  return (size_t)kBlockQ * D + (size_t)kBlockK * (D + 1) +
         (size_t)kBlockK * Dv + (size_t)kBlockQ * kBlockK +
         (size_t)kBlockQ * Dv + 3 * (size_t)kBlockQ + kBlockK + kBlockQ;
}

__global__ void __launch_bounds__(kThreads) flash_kernel(Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * kBlockQ;
  const int hk = h / p.g, D = p.D, Dv = p.Dv, KT = kBlockK;
  const int nq = min(kBlockQ, p.Sq - q0);
  float* qs = smem;                         // [nq][D]
  float* ks = qs + (size_t)kBlockQ * D;     // [KT][D + 1]
  float* vs = ks + (size_t)KT * (D + 1);    // [KT][Dv]
  float* ss = vs + (size_t)KT * Dv;         // [nq][KT]
  float* acc = ss + (size_t)kBlockQ * KT;   // [nq][Dv]
  float* ms = acc + (size_t)kBlockQ * Dv;   // running max
  float* ls = ms + kBlockQ;                 // running denominator
  float* al = ls + kBlockQ;                 // this tile's rescale factor
  int* kp = reinterpret_cast<int*>(al + kBlockQ);  // [KT]
  int* qp = kp + KT;                               // [nq]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);

  for (int i = tid; i < nq * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[i] = q[(((long)b * p.Sq + q0 + r) * p.Hq + h) * D + d];
  }
  for (int i = tid; i < nq * Dv; i += kThreads) acc[i] = 0.f;
  int live = 0;
  for (int r = tid; r < nq; r += kThreads) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
    qp[r] = p.q_pos[(long)b * p.Sq + q0 + r];
    live |= qp[r] >= 0;
  }
  // rows that are all invalid (-1) see no key: skip the keys, write zeros
  const int Sk = __syncthreads_or(live) ? p.Sk : 0;

  for (int k0 = 0; k0 < Sk; k0 += KT) {
    const int nk = min(KT, Sk - k0);
    if (tid < nk) kp[tid] = p.k_pos[(long)b * p.Sk + k0 + tid];
    __syncthreads();
    int any = 0;
    for (int i = tid; i < nq * nk; i += kThreads)
      any |= visible(kp[i % nk], qp[i / nk], p.window);
    if (!__syncthreads_or(any)) continue;  // nothing visible: skip K/V

    for (int i = tid; i < nk * D; i += kThreads) {
      const int t = i / D, d = i % D;
      ks[t * (D + 1) + d] =
          k[(((long)b * p.Sk + k0 + t) * p.Hkv + hk) * D + d];
    }
    for (int i = tid; i < nk * Dv; i += kThreads) {
      const int t = i / Dv, d = i % Dv;
      vs[i] = v[(((long)b * p.Sk + k0 + t) * p.Hkv + hk) * Dv + d];
    }
    __syncthreads();

    for (int i = tid; i < nq * nk; i += kThreads) {
      const int r = i / nk, t = i % nk;
      float s = -INFINITY;
      if (visible(kp[t], qp[r], p.window)) {
        const float* qr = qs + (size_t)r * D;
        const float* kt = ks + (size_t)t * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kt[d], dot);
        s = dot * p.scale;
        if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
      }
      ss[r * KT + t] = s;
    }
    __syncthreads();

    for (int r = warp; r < nq; r += kWarps) {
      float mx = -INFINITY;
      for (int t = lane; t < nk; t += 32) mx = fmaxf(mx, ss[r * KT + t]);
      mx = warp_max(mx);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      const float alpha = isinf(m_prev) ? 0.f : expf(m_prev - m_safe);
      float sum = 0.f;
      for (int t = lane; t < nk; t += 32) {
        const float s = ss[r * KT + t];
        const float e = isinf(s) ? 0.f : expf(s - m_safe);
        ss[r * KT + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + sum;
        al[r] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < nq * Dv; i += kThreads) {
      const int r = i / Dv, d = i % Dv;
      float a = acc[i] * al[r];
      for (int t = 0; t < nk; ++t)
        a = fmaf(ss[r * KT + t], vs[t * Dv + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  float* o = static_cast<float*>(p.out);
  for (int i = tid; i < nq * Dv; i += kThreads) {
    const int r = i / Dv, d = i % Dv;
    // a row with no visible key has l == 0 and acc == 0: it writes 0
    o[(((long)b * p.Sq + q0 + r) * p.Hq + h) * Dv + d] =
        acc[i] / fmaxf(ls[r], 1e-37f);
  }
  if (p.lse != nullptr)
    for (int r = tid; r < nq; r += kThreads)
      p.lse[((long)b * p.Hq + h) * p.Sq + q0 + r] =
          ls[r] > 0.f ? ms[r] + logf(ls[r]) : INFINITY;
}

cudaError_t launch_fp32(int B, const Params& p, cudaStream_t stream) {
  if (B == 0 || p.Sq == 0) return cudaSuccess;
  const size_t smem = smem_floats(p.D, p.Dv) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = opt_in_smem((const void*)flash_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B, p.Hq, (p.Sq + kBlockQ - 1) / kBlockQ);
  flash_kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// grid (ceil(Sq * g / 64), Hkv, B): one tile of 64 (query, group head)
// rows of batch row b against kv head h
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, mma_min_blocks(DMAX))
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
  return dvp <= 64    ? mma_launch(flash_mma_kernel<T, 64>, a, B, stream)
         : dvp <= 128 ? mma_launch(flash_mma_kernel<T, 128>, a, B, stream)
                      : mma_launch(flash_mma_kernel<T, 256>, a, B, stream);
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core body), 1 = float16, 2 = bfloat16 (the
// tensor-core body), for q, k, v and out; lse: (B, Hq, Sq) fp32 or null.
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
    case 0: return (int)launch_fp32(B, p, s);
    case 1: return (int)launch_mma<__half>(B, p, s);
    case 2: return (int)launch_mma<__nv_bfloat16>(B, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
