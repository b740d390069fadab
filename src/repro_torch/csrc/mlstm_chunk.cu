// Chunkwise stabilised mLSTM for Hopper (sm_90a), bound to PyTorch through
// a plain C interface (ctypes); see repro_torch/kernels/mlstm_chunk.py.
//
// Replaces the Pallas TPU kernel mlstm_chunked_kernel of the reference
// package (repro/kernels/mlstm_chunk.py, body _kernel): the xLSTM
// matrix-memory recurrence over a whole prompt, chunk by chunk, carrying
// C (dh x dh), n (dh) and the stabiliser m per (batch row, head) from one
// chunk to the next.  It computes, per chunk of L steps with cumulative
// log forget F and input pre-activations i,
//   m_i   = max(max_{j<=i} F_i - F_j + i_j, F_i + m_prev)
//   h_i   = (sum_j s_ij v_j + e^{F_i + m_prev - m_i} q_i C)
//           / max(|sum_j s_ij + e^{F_i + m_prev - m_i} q_i . n|, e^{-m_i})
//           with s_ij = (q_i . k_j) e^{F_i - F_j + i_j - m_i}, j <= i
//   m_new = max(m_prev + F_L, max_j F_L - F_j + i_j)
//   C     = e^{m_prev + F_L - m_new} C + sum_j e^{F_L - F_j + i_j - m_new}
//           k_j v_j^T   (n likewise with k_j)
// as the reference's oracle (repro/models/ssm.py mlstm_chunked) does.
//
// Bound: operations.  Per chunk and head it does L^2 dh (scores), 2 L dh^2
// (q C and the k v^T update) and L^2 dh (s v) fused multiply-adds on
// (2 L dh + L dh) inputs, so at dh = 384 it sits far above the card's
// flops-per-byte ridge even at L = 32.
//
// Design.  The TPU kernel keeps C resident in VMEM across its sequential
// chunk axis; at xlstm-125m's dh = 384 that is 576 KiB per head, more than
// a Hopper block's 227 KiB of shared memory.  So C is split by value
// columns: one block per (batch row, head, tile of kTileE columns) walks
// all chunks in order (the loop replaces the TPU grid's sequential axis)
// and keeps its dh x kTileE slice of C in shared memory.  The columns of C
// are independent in every formula above; what couples them (the scores,
// q . n, the n and m updates) is recomputed by every tile block, which is
// cheap next to q C and k v^T, and only tile 0 writes n and m.  The chunk
// length L = 32 is the kernel's own: the stabiliser is a running max over
// the same terms however the sequence is cut, so h and the state equal
// the oracle's (chunk 128) up to fp32 rounding, and the ragged last chunk
// is masked here, so any S is taken.  Inputs are cast to fp32 as they are
// staged; all arithmetic is fp32 on CUDA cores (tensor cores come later).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                 // L: one warp's lanes
constexpr int kTileE = 64;                 // value columns of C per block
constexpr int kRowGroups = kThreads / kTileE;
constexpr int kRowsPerThread = kChunk / kRowGroups;
static_assert(kChunk == 32, "the per-chunk reductions use one warp");
static_assert(kChunk % kRowGroups == 0, "rows split evenly over groups");

struct Params {
  const void* q;      // (B,S,H,dh) at T
  const void* k;
  const void* v;
  const float* ig;    // (B,S,H) input-gate pre-activations
  const float* lf;    // (B,S,H) log forget gates
  const float* C0;    // (B,H,dh,dh) initial state
  const float* n0;    // (B,H,dh)
  const float* m0;    // (B,H)
  float* h;           // (B,S,H,dh)
  float* C;           // final state, like the initial one
  float* n;
  float* m;
  int B, S, H, dh;
};

__host__ __device__ inline size_t smem_floats(int dh) {
  // q and k rows (padded to dh + 1), the C tile, the v tile, n, the
  // L x L scores, then per row F, i, m_i, state weight, den, key weight
  return 2 * (size_t)kChunk * (dh + 1) + (size_t)dh * kTileE +
         (size_t)kChunk * kTileE + dh + (size_t)kChunk * kChunk +
         6 * (size_t)kChunk;
}

// grid (B * H, ceil(dh / kTileE)): block (bh, y) owns C[b, h][:, cols]
// with cols = [y * kTileE, y * kTileE + te) and walks every chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_chunk_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ float m_prev, m_next, decay;
  const int dh = p.dh, ld = dh + 1, L = kChunk;
  const int b = blockIdx.x / p.H, hh = blockIdx.x % p.H;
  const int e0 = blockIdx.y * kTileE, te = min(kTileE, dh - e0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* qs = smem;                              // [L][dh + 1]
  float* ks = qs + (size_t)L * ld;               // [L][dh + 1]
  float* Cs = ks + (size_t)L * ld;               // [dh][kTileE]
  float* vs = Cs + (size_t)dh * kTileE;          // [L][kTileE]
  float* ns = vs + (size_t)L * kTileE;           // [dh]
  float* ss = ns + dh;                           // [L][L]
  float* Fs = ss + (size_t)L * L;                // cumulative log forget
  float* is = Fs + L;                            // input pre-activations
  float* ms = is + L;                            // row stabilisers m_i
  float* sw = ms + L;                            // state-path weights
  float* dn = sw + L;                            // denominators
  float* wk = dn + L;                            // key weights to chunk end
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const long sbh = (long)b * p.H + hh;           // state row (b, h)

  for (int i = tid; i < dh * kTileE; i += kThreads) {
    const int d = i / kTileE, e = i % kTileE;
    Cs[i] = e < te ? p.C0[(sbh * dh + d) * dh + e0 + e] : 0.f;
  }
  for (int d = tid; d < dh; d += kThreads) ns[d] = p.n0[sbh * dh + d];
  if (tid == 0) m_prev = p.m0[sbh];
  __syncthreads();

  for (int c0 = 0; c0 < p.S; c0 += L) {
    const int Lc = min(L, p.S - c0);             // ragged last chunk
    const long row0 = ((long)b * p.S + c0) * p.H + hh;  // (b, c0, h)
    for (int i = tid; i < Lc * dh; i += kThreads) {
      const int t = i / dh, d = i % dh;
      const long src = (row0 + (long)t * p.H) * dh + d;
      qs[t * ld + d] = to_f(q[src]);
      ks[t * ld + d] = to_f(k[src]);
    }
    for (int i = tid; i < Lc * kTileE; i += kThreads) {
      const int t = i / kTileE, e = i % kTileE;
      vs[i] = e < te ? to_f(v[(row0 + (long)t * p.H) * dh + e0 + e]) : 0.f;
    }
    if (warp == 0) {
      // cumulative sum of the log forget gates over the chunk (warp scan)
      float f = lane < Lc ? p.lf[row0 + (long)lane * p.H] : 0.f;
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(~0u, f, o);
        if (lane >= o) f += up;
      }
      if (lane < Lc) {
        Fs[lane] = f;
        is[lane] = p.ig[row0 + (long)lane * p.H];
      }
    }
    __syncthreads();

    const float mp = m_prev, Ftot = Fs[Lc - 1];
    for (int r = warp; r < Lc; r += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j <= r; j += 32) mx = fmaxf(mx, Fs[r] - Fs[j] + is[j]);
      mx = warp_max(mx);
      if (lane == 0) {
        const float lst = Fs[r] + mp;
        float mi = fmaxf(mx, lst);
        if (!isfinite(mi)) mi = 0.f;
        ms[r] = mi;
        sw[r] = expf(lst - mi);
      }
    }
    if (warp == kWarps - 1) {
      const float t = lane < Lc ? Ftot - Fs[lane] + is[lane] : -INFINITY;
      const float mn = fmaxf(mp + Ftot, warp_max(t));
      if (lane < Lc) wk[lane] = expf(t - mn);
      if (lane == 0) {
        m_next = mn;
        decay = expf(mp + Ftot - mn);
      }
    }
    __syncthreads();

    // decay-weighted scores s_ij, j <= i (0 above the diagonal)
    for (int x = tid; x < Lc * L; x += kThreads) {
      const int i = x / L, j = x % L;
      float s = 0.f;
      if (j <= i) {
        const float* qr = qs + (size_t)i * ld;
        const float* kr = ks + (size_t)j * ld;
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * expf(Fs[i] - Fs[j] + is[j] - ms[i]);
      }
      ss[x] = s;
    }
    __syncthreads();

    for (int r = warp; r < Lc; r += kWarps) {
      float a = 0.f, srow = 0.f;
      for (int d = lane; d < dh; d += 32) a = fmaf(qs[r * ld + d], ns[d], a);
      for (int j = lane; j <= r; j += 32) srow += ss[r * L + j];
      a = warp_sum(a);
      srow = warp_sum(srow);
      if (lane == 0) dn[r] = srow + sw[r] * a;
    }
    __syncthreads();

    // h for this block's columns: thread (row group g, column e) owns rows
    // g, g + kRowGroups, ... and reads each C entry once for all of them
    {
      const int e = tid % kTileE, g = tid / kTileE;
      float acc[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
      for (int d = 0; d < dh; ++d) {
        const float c = Cs[d * kTileE + e];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          acc[r] = fmaf(qs[(g + r * kRowGroups) * ld + d], c, acc[r]);
      }
      if (e < te) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const int i = g + r * kRowGroups;
          if (i >= Lc) continue;
          float sv = 0.f;
          for (int j = 0; j <= i; ++j)
            sv = fmaf(ss[i * L + j], vs[j * kTileE + e], sv);
          const float num = sv + sw[i] * acc[r];
          const float den = fmaxf(fabsf(dn[i]), expf(-ms[i]));
          p.h[(row0 + (long)i * p.H) * dh + e0 + e] = num / den;
        }
      }
    }
    __syncthreads();

    // carry C, n and m to the chunk's end
    const float dc = decay;
    {
      const int e = tid % kTileE;
      for (int d = tid / kTileE; d < dh; d += kRowGroups) {
        float a = 0.f;
        for (int j = 0; j < Lc; ++j)
          a = fmaf(wk[j] * ks[j * ld + d], vs[j * kTileE + e], a);
        Cs[d * kTileE + e] = dc * Cs[d * kTileE + e] + a;
      }
    }
    for (int d = tid; d < dh; d += kThreads) {
      float a = 0.f;
      for (int j = 0; j < Lc; ++j) a = fmaf(wk[j], ks[j * ld + d], a);
      ns[d] = dc * ns[d] + a;
    }
    if (tid == 0) m_prev = m_next;
    __syncthreads();
  }

  for (int i = tid; i < dh * kTileE; i += kThreads) {
    const int d = i / kTileE, e = i % kTileE;
    if (e < te) p.C[(sbh * dh + d) * dh + e0 + e] = Cs[i];
  }
  if (blockIdx.y == 0) {
    for (int d = tid; d < dh; d += kThreads) p.n[sbh * dh + d] = ns[d];
    if (tid == 0) p.m[sbh] = m_prev;
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(p.dh) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)mlstm_chunk_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.B * p.H, (p.dh + kTileE - 1) / kTileE);
  mlstm_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype of q, k, v: 0 = float32, 1 = float16, 2 = bfloat16; gates, state
// and h are fp32.  Returns cudaGetLastError() after the launch.
extern "C" int mlstm_chunk_launch(const void* q, const void* k, const void* v,
                                  const void* ig, const void* lf,
                                  const void* C0, const void* n0,
                                  const void* m0, void* h, void* C, void* n,
                                  void* m, int dtype, int B, int S, int H,
                                  int dh, void* stream) {
  Params p{q, k, v, static_cast<const float*>(ig),
           static_cast<const float*>(lf), static_cast<const float*>(C0),
           static_cast<const float*>(n0), static_cast<const float*>(m0),
           static_cast<float*>(h), static_cast<float*>(C),
           static_cast<float*>(n), static_cast<float*>(m), B, S, H, dh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(p, s);
    case 1: return (int)launch<__half>(p, s);
    case 2: return (int)launch<__nv_bfloat16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared-memory bytes a launch needs at head dim dh.
extern "C" long mlstm_chunk_smem_bytes(int dh) {
  return (long)(smem_floats(dh) * sizeof(float));
}
