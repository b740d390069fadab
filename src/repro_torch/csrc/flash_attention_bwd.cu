// Dense flash attention backward for Hopper (sm_90a), bound to PyTorch
// through a plain C interface (ctypes); see
// repro_torch/kernels/flash_attention.py (flash_attention_bwd) and
// repro_torch/kernels/ops.py (FlashAttentionFn).
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
//   D  = rowsum(dO o)                  (attn_bwd_delta_kernel)
//   dS = P (dO.v - D) (1 - tanh^2) scale
//   dQ = dS K                          (attn_bwd_dq_kernel)
//   dK = dS^T Q, dV = P^T dO           (attn_bwd_dkdv_kernel)
//
// with the forward's mask (positions, -1 = invalid, causal, optional
// window), GQA (query head h reads kv head h / g), any Dv (MLA: 192 / 128)
// and head dims up to 256.
//
// Deterministic, no atomics: a dK/dV block owns 32 keys of one kv head of
// one batch row and walks the g query heads of that kv head and every
// 32-query tile in a fixed order, summing in fp32 in shared memory; a dQ
// block owns 32 queries of one query head and walks the 32-key tiles.
// Each block first checks the positions of a tile pair and skips a pair
// in which no key is visible (past the causal diagonal, outside the
// window), so a causal pass costs about half of the full square.
//
// A simple first kernel: every body runs on CUDA cores, with fp32
// products and sums whatever the inputs' type (bf16 / fp16 are converted
// as they are staged), so the card's fp32 gradients equal the CPU's
// within summation order.  What bounds it is shared-memory traffic: each
// fma reads one operand from shared memory (the other is a broadcast),
// far above both the bytes (q, k, v, o, dO, lse in; dq, dk, dv out) and
// the tensor cores' rate for the 2.5x forward flops (PERF.md).  mma.sync
// or wgmma tiles are the next steps.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;          // queries or keys per tile
constexpr size_t kMaxSmem = 227 * 1024;

struct BwdParams {
  const void* q;        // (B, Sq, Hq, D)
  const void* k;        // (B, Sk, Hkv, D)
  const void* v;        // (B, Sk, Hkv, Dv)
  const void* o;        // (B, Sq, Hq, Dv)
  const void* dout;     // (B, Sq, Hq, Dv)
  const float* lse;     // (B, Hq, Sq)
  const int* q_pos;     // (B, Sq)
  const int* k_pos;     // (B, Sk)
  float* delta;         // (B, Hq, Sq): rowsum(dO o)
  void* dq;             // (B, Sq, Hq, D)
  void* dk;             // (B, Sk, Hkv, D)
  void* dv;             // (B, Sk, Hkv, Dv)
  int B, Sq, Sk, Hq, Hkv, g, D, Dv;
  float scale, softcap;  // softcap <= 0: none
  int window;            // window <= 0: none
};

// Shared-memory floats of either tile kernel: Q and K tiles (rows padded
// to D + 1 so that 32 threads reading 32 rows hit 32 banks), dO and V
// tiles (Dv + 1), the block's two accumulators (dK and dV, or dQ and a
// spare of Dv), P and dS (32 x 33), lse and D per query, then the 2 x 32
// positions as ints.
inline size_t bwd_smem_floats(int D, int Dv) {
  return 2 * (size_t)kTile * (D + 1) + 2 * (size_t)kTile * (Dv + 1) +
         (size_t)kTile * D + (size_t)kTile * Dv +
         2 * (size_t)kTile * (kTile + 1) + 4 * (size_t)kTile;
}

struct BwdSmem {
  float *qs, *ks, *dos, *vs, *acc_a, *acc_b, *ps, *dss, *lse, *dl;
  int *qp, *kp;
  int sD, sV;
  __device__ BwdSmem(float* s, int D, int Dv) {
    sD = D + 1;
    sV = Dv + 1;
    qs = s;
    ks = qs + kTile * sD;
    dos = ks + kTile * sD;
    vs = dos + kTile * sV;
    acc_a = vs + kTile * sV;        // dK [32][D] or dQ [32][D]
    acc_b = acc_a + kTile * D;      // dV [32][Dv]
    ps = acc_b + kTile * Dv;        // [32][33]
    dss = ps + kTile * (kTile + 1);
    lse = dss + kTile * (kTile + 1);
    dl = lse + kTile;
    qp = reinterpret_cast<int*>(dl + kTile);
    kp = qp + kTile;
  }
};

// Rows [0, n) of a (rows, H, dim) tensor at row `row0`, head h, into
// `dst` as fp32 with row stride `stride`; rows past n are zeros.
template <typename T>
__device__ void stage_rows(float* dst, int stride, const T* src, long long row0,
                           int H, int h, int dim, int n) {
  for (int i = threadIdx.x; i < kTile * dim; i += kThreads) {
    const int r = i / dim, d = i % dim;
    dst[r * stride + d] =
        r < n ? to_f(src[((row0 + r) * H + h) * (long long)dim + d]) : 0.f;
  }
}

// Query rows [q0, q0 + nq) of head h: positions (-1 past nq), Q, dO, lse
// and D.
template <typename T>
__device__ void stage_queries(const BwdParams& p, const BwdSmem& s, int b,
                              int h, int q0, int nq) {
  const long long row0 = (long long)b * p.Sq + q0;
  stage_rows(s.qs, s.sD, static_cast<const T*>(p.q), row0, p.Hq, h, p.D, nq);
  stage_rows(s.dos, s.sV, static_cast<const T*>(p.dout), row0, p.Hq, h,
             p.Dv, nq);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const long long i = ((long long)b * p.Hq + h) * p.Sq + q0 + r;
    s.lse[r] = r < nq ? p.lse[i] : INFINITY;
    s.dl[r] = r < nq ? p.delta[i] : 0.f;
  }
}

// Key rows [k0, k0 + nk) of kv head hk: K and V.
template <typename T>
__device__ void stage_keys(const BwdParams& p, const BwdSmem& s, int b,
                           int hk, int k0, int nk) {
  const long long row0 = (long long)b * p.Sk + k0;
  stage_rows(s.ks, s.sD, static_cast<const T*>(p.k), row0, p.Hkv, hk, p.D,
             nk);
  stage_rows(s.vs, s.sV, static_cast<const T*>(p.v), row0, p.Hkv, hk, p.Dv,
             nk);
}

// Positions of 32 rows from `pos` (n of them, -1 after).
__device__ void stage_pos(int* dst, const int* pos, long long row0, int n) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = r < n ? pos[row0 + r] : -1;
}

// Whether some query of the staged tile sees some staged key; the whole
// block takes the same answer.
__device__ bool any_visible(const BwdSmem& s, int window) {
  int any = 0;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads)
    any |= visible(s.kp[i % kTile], s.qp[i / kTile], window);
  return __syncthreads_or(any) != 0;
}

// P and dS of every (query r, key t) pair of the staged tiles: the scores
// recomputed from Q and K, P from the forward's lse, dS from dO.V^T and D.
__device__ void pair_grads(const BwdParams& p, const BwdSmem& s,
                           bool keep_p) {
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, t = i % kTile;
    float pr = 0.f, ds = 0.f;
    if (visible(s.kp[t], s.qp[r], p.window)) {
      const float* qr = s.qs + r * s.sD;
      const float* kt = s.ks + t * s.sD;
      float dot = 0.f;
      for (int d = 0; d < p.D; ++d) dot = fmaf(qr[d], kt[d], dot);
      float sc = dot * p.scale, chain = p.scale;
      if (p.softcap > 0.f) {
        const float th = tanhf(sc / p.softcap);
        sc = th * p.softcap;
        chain *= 1.f - th * th;
      }
      pr = expf(sc - s.lse[r]);          // lse = +inf: 0
      const float* dor = s.dos + r * s.sV;
      const float* vt = s.vs + t * s.sV;
      float dp = 0.f;
      for (int d = 0; d < p.Dv; ++d) dp = fmaf(dor[d], vt[d], dp);
      ds = pr * (dp - s.dl[r]) * chain;
    }
    if (keep_p) s.ps[r * (kTile + 1) + t] = pr;
    s.dss[r * (kTile + 1) + t] = ds;
  }
}

// grid (ceil(B * Sq * Hq / 8)): one warp per (batch row, query, head) row
// of o, in memory order; D = rowsum(dO o) into delta (B, Hq, Sq).
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_delta_kernel(BwdParams p) {
  const long long row =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.Sq * p.Hq) return;
  const T* o = static_cast<const T*>(p.o) + row * p.Dv;
  const T* d = static_cast<const T*>(p.dout) + row * p.Dv;
  float acc = 0.f;
  for (int i = lane; i < p.Dv; i += 32) acc = fmaf(to_f(o[i]), to_f(d[i]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = (int)(row % p.Hq);
    const long long bq = row / p.Hq;            // b * Sq + q
    const long long b = bq / p.Sq, q = bq % p.Sq;
    p.delta[(b * p.Hq + h) * p.Sq + q] = acc;
  }
}

// grid (ceil(Sk / 32), Hkv, B): dK and dV of 32 keys of kv head hk,
// summed over its g query heads and every query tile, in that order.
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv_kernel(BwdParams p) {
  extern __shared__ float smem[];
  BwdSmem s(smem, p.D, p.Dv);
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int nk = min(kTile, p.Sk - k0), D = p.D, Dv = p.Dv;
  stage_keys<T>(p, s, b, hk, k0, nk);
  stage_pos(s.kp, p.k_pos, (long long)b * p.Sk + k0, nk);
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) s.acc_a[i] = 0.f;
  for (int i = threadIdx.x; i < kTile * Dv; i += kThreads) s.acc_b[i] = 0.f;
  for (int hi = 0; hi < p.g; ++hi) {
    const int h = hk * p.g + hi;
    for (int q0 = 0; q0 < p.Sq; q0 += kTile) {
      const int nq = min(kTile, p.Sq - q0);
      __syncthreads();                  // the last pair's tiles are read
      stage_pos(s.qp, p.q_pos, (long long)b * p.Sq + q0, nq);
      __syncthreads();
      if (!any_visible(s, p.window)) continue;
      stage_queries<T>(p, s, b, h, q0, nq);
      __syncthreads();
      pair_grads(p, s, true);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q (rows past nq hold P = dS = 0)
      for (int i = threadIdx.x; i < nk * Dv; i += kThreads) {
        const int t = i / Dv, d = i % Dv;
        float a = s.acc_b[i];
        for (int r = 0; r < nq; ++r)
          a = fmaf(s.ps[r * (kTile + 1) + t], s.dos[r * s.sV + d], a);
        s.acc_b[i] = a;
      }
      for (int i = threadIdx.x; i < nk * D; i += kThreads) {
        const int t = i / D, d = i % D;
        float a = s.acc_a[i];
        for (int r = 0; r < nq; ++r)
          a = fmaf(s.dss[r * (kTile + 1) + t], s.qs[r * s.sD + d], a);
        s.acc_a[i] = a;
      }
    }
  }
  __syncthreads();
  T* dk = static_cast<T*>(p.dk);
  T* dv = static_cast<T*>(p.dv);
  const long long row0 = (long long)b * p.Sk + k0;
  for (int i = threadIdx.x; i < nk * D; i += kThreads)
    dk[((row0 + i / D) * p.Hkv + hk) * D + i % D] = from_f<T>(s.acc_a[i]);
  for (int i = threadIdx.x; i < nk * Dv; i += kThreads)
    dv[((row0 + i / Dv) * p.Hkv + hk) * Dv + i % Dv] = from_f<T>(s.acc_b[i]);
}

// grid (ceil(Sq / 32), Hq, B): dQ of 32 queries of head h over every key
// tile of its kv head, in order.
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(BwdParams p) {
  extern __shared__ float smem[];
  BwdSmem s(smem, p.D, p.Dv);
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int nq = min(kTile, p.Sq - q0), hk = h / p.g, D = p.D;
  stage_queries<T>(p, s, b, h, q0, nq);
  stage_pos(s.qp, p.q_pos, (long long)b * p.Sq + q0, nq);
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) s.acc_a[i] = 0.f;
  for (int k0 = 0; k0 < p.Sk; k0 += kTile) {
    const int nk = min(kTile, p.Sk - k0);
    __syncthreads();
    stage_pos(s.kp, p.k_pos, (long long)b * p.Sk + k0, nk);
    __syncthreads();
    if (!any_visible(s, p.window)) continue;
    stage_keys<T>(p, s, b, hk, k0, nk);
    __syncthreads();
    pair_grads(p, s, false);
    __syncthreads();
    // dQ += dS K (keys past nk hold dS = 0)
    for (int i = threadIdx.x; i < nq * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float a = s.acc_a[i];
      for (int t = 0; t < nk; ++t)
        a = fmaf(s.dss[r * (kTile + 1) + t], s.ks[t * s.sD + d], a);
      s.acc_a[i] = a;
    }
  }
  __syncthreads();
  T* dq = static_cast<T*>(p.dq);
  const long long row0 = (long long)b * p.Sq + q0;
  for (int i = threadIdx.x; i < nq * D; i += kThreads)
    dq[((row0 + i / D) * p.Hq + h) * D + i % D] = from_f<T>(s.acc_a[i]);
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  if (p.B == 0 || (p.Sq == 0 && p.Sk == 0)) return cudaSuccess;
  const size_t smem = bwd_smem_floats(p.D, p.Dv) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = opt_in_smem((const void*)attn_bwd_dkdv_kernel<T>, smem);
  if (e == cudaSuccess)
    e = opt_in_smem((const void*)attn_bwd_dq_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const long long rows = (long long)p.B * p.Sq * p.Hq;
  if (rows > 0) {
    const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
    attn_bwd_delta_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (p.Sk > 0) {
    const dim3 grid((p.Sk + kTile - 1) / kTile, p.Hkv, p.B);
    attn_bwd_dkdv_kernel<T><<<grid, kThreads, smem, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (p.Sq > 0) {
    const dim3 grid((p.Sq + kTile - 1) / kTile, p.Hq, p.B);
    attn_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16, for q, k, v, o, dout and
// the gradients; lse (B, Hq, Sq) from the forward and delta (B, Hq, Sq), a
// scratch buffer, are fp32.  Three launches on `stream`: D, then dK / dV,
// then dQ.  Returns cudaGetLastError() after them (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* q_pos, const void* k_pos,
    void* delta, void* dq, void* dk, void* dv, int dtype, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, int Dv, float scale, float softcap,
    int window, void* stream) {
  BwdParams p{q, k, v, o, dout, static_cast<const float*>(lse),
              static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
              static_cast<float*>(delta), dq, dk, dv, B, Sq, Sk, Hq, Hkv,
              Hq / Hkv, D, Dv, scale, softcap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_bwd<float>(p, s);
    case 1: return (int)launch_bwd<__half>(p, s);
    case 2: return (int)launch_bwd<__nv_bfloat16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
