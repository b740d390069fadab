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
// softmax.  The output is at q's dtype; a row that sees no key is 0.
//
// Bound: at the shapes the port runs it (the draft model's full forwards,
// Sq = Sk of a few hundred tokens) by operations: 4 * D flops per visible
// (query, key) pair and query head against 2 * D element reads per key row
// and kv head, far above the card's ~295 flops-per-byte ridge.
// Design: grid (B, Hq, ceil(Sq / 32)).  The TPU kernel's sequential k grid
// axis becomes a loop over 32-key tiles inside the block, which keeps the
// running max, denominator and accumulator of its 32 query rows in shared
// memory.  Each tile's positions are read first, and a tile no row can see
// (beyond the causal diagonal, outside a window, past Sk) is skipped before
// its K/V are read.  Any Sq and Sk: the ragged last tiles are masked here,
// so the TPU wrapper's "Sq divisible by the block" limit does not carry
// over.  This first version uses CUDA cores only (scores and P.V as fp32
// FMAs from shared memory); mma.sync / wgmma come later.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ bool visible(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
}

template <typename T>
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
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  for (int i = tid; i < nq * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[i] = to_f(q[(((long)b * p.Sq + q0 + r) * p.Hq + h) * D + d]);
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
          to_f(k[(((long)b * p.Sk + k0 + t) * p.Hkv + hk) * D + d]);
    }
    for (int i = tid; i < nk * Dv; i += kThreads) {
      const int t = i / Dv, d = i % Dv;
      vs[i] = to_f(v[(((long)b * p.Sk + k0 + t) * p.Hkv + hk) * Dv + d]);
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

  T* o = static_cast<T*>(p.out);
  for (int i = tid; i < nq * Dv; i += kThreads) {
    const int r = i / Dv, d = i % Dv;
    // a row with no visible key has l == 0 and acc == 0: it writes 0
    o[(((long)b * p.Sq + q0 + r) * p.Hq + h) * Dv + d] =
        from_f<T>(acc[i] / fmaxf(ls[r], 1e-37f));
  }
}

template <typename T>
cudaError_t launch(int B, const Params& p, cudaStream_t stream) {
  if (B == 0 || p.Sq == 0) return cudaSuccess;
  const size_t smem = smem_floats(p.D, p.Dv) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)flash_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, p.Hq, (p.Sq + kBlockQ - 1) / kBlockQ);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, k, v and out).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, void* out, int dtype, int B, int Sq, int Sk, int Hq,
    int Hkv, int D, int Dv, float scale, float softcap, int window,
    void* stream) {
  Params p{q, k, v, static_cast<const int*>(q_pos),
           static_cast<const int*>(k_pos), out, Sq, Sk, Hq, Hkv, Hq / Hkv,
           D, Dv, scale, softcap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(B, p, s);
    case 1: return (int)launch<__half>(B, p, s);
    case 2: return (int)launch<__nv_bfloat16>(B, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
