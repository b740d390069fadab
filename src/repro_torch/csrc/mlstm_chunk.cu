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
// Bound: at xlstm-125m's dh = 384 and short prompts, the bytes of the fp32
// state (C read and written once: 1.2 MB per (row, head)); per step it
// does 2 dh^2 (q C and the k v^T update) plus (L + 1) dh fused
// multiply-adds, so a long prompt is bound by operations.
//
// Both bodies split C by value columns: one block per (batch row, head,
// tile of te columns) walks all chunks in order (the loop replaces the TPU
// grid's sequential axis; the TPU kernel keeps all of C in VMEM, 576 KiB
// per head at dh = 384, more than a Hopper block's 227 KiB).  The columns
// of C are independent in every formula above; what couples them (the
// scores, q . n, n and m) is recomputed by every tile block, and only tile
// 0 writes n and m.  Chunks are L = 32 steps, the kernel's own choice: the
// stabiliser is a running max over the same terms however the sequence is
// cut, so h and the state equal the oracle's (chunk 128) up to rounding.
// The ragged last chunk is masked, so any S is taken.  Bodies by q's
// dtype and shape, chosen by mlstm_chunk.mlstm_plan and checked here:
//
//  * q/k/v at any dtype, dh a multiple of 8 up to 384, 16-byte aligned:
//    mlstm_chunk_mma_kernel<T>, the chunk products on the tensor cores
//    (mma.sync.m16n8k16 on bf16 operands, fp32 accumulators, operands by
//    ldmatrix).  The block's warps split its C^T tile (te x dh) into
//    16-row x up-to-192-column pieces held as fp32 accumulator fragments in
//    registers for the whole walk (te = 96 at dh = 384: 12 warps, 96 values
//    a thread), so the state never goes through shared memory.  Per chunk:
//    S = Q K^T; h^T = C^T q^T (C's fragments used as the A operand
//    directly) and V^T S^T; then C^T = decay C^T + (w V)^T K.  Every fp32
//    (or fp16) operand is cut into bf16 parts whose sum is its value
//    (MmaParts), and the products run over the part pairs: at bf16 q/k/v
//    are exact and C (in q C: 2 parts), the weighted scores s (in S V: 2)
//    and w_j v_j (in the update: 3; C is held to 1e-5 of its scale) are
//    cut; at fp16 q/k/v take two parts, at fp32 three and every other
//    operand three too, the leading pair's products kept apart from the
//    rest so that truncating tensor-core sums do not cost the fp32 gates.
//    The per-row weight e^{F_i + m_prev - m_i} is applied to the q C
//    accumulators after the product.  Partial h of the column groups meet
//    in shared memory.  bf16: the next chunk's q, k, v and gates arrive by
//    16-byte cp.async while this chunk is computed (two stages).  fp16 /
//    fp32: two stages of raw rows do not fit (fp32 Q and K alone: 200,704
//    bytes at dh = 384), so each chunk lands in one stage, cut into bf16
//    planes as it arrives (batched 16-byte loads; 224,528 bytes at dh =
//    384, te = 96), its load not overlapped with the compute.  Its bound
//    at long prompts is the parts' extra products: at bf16 2 + 3 of them
//    for every product of q C and the update, at fp32 six for each of the
//    five products.
//  * shapes the tensor-core body does not take (dh off 8 or above 384,
//    inputs off a 16-byte boundary): mlstm_chunk_kernel, on CUDA cores,
//    all arithmetic fp32.  Each block keeps its dh x 64 slice of C in
//    shared memory; every product is a serial fp32 dot product.
//
// For training, mlstm_chunk_states_launch runs the same bodies, compiled
// with kStates, which also write the state (C, n, m) at the start of every
// chunk for the backward (mlstm_chunk_bwd.cu) to read instead of
// recomputing it: each column tile block writes its columns of C, tile 0 n
// and m, as for the final state.  The serving path (mlstm_chunk_launch)
// runs the bodies without kStates, whose code is the same as before.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "dtype.cuh"
#include "mma.cuh"

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
  int te;             // tensor-core body: value columns per block
  float* Cst;         // null, or the state at each chunk's start:
  float* nst;         //   (B,H,NC,dh,dh), (B,H,NC,dh), (B,H,NC) with
  float* mst;         //   NC = ceil(S / L)
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
template <typename T, bool kStates>
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
    if constexpr (kStates) {                     // the chunk's start state
      const long cs = sbh * ((p.S + L - 1) / L) + c0 / L;
      for (int i = tid; i < dh * kTileE; i += kThreads) {
        const int d = i / kTileE, e = i % kTileE;
        if (e < te) p.Cst[(cs * dh + d) * dh + e0 + e] = Cs[i];
      }
      if (blockIdx.y == 0) {
        for (int d = tid; d < dh; d += kThreads) p.nst[cs * dh + d] = ns[d];
        if (tid == 0) p.mst[cs] = m_prev;
      }
    }
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

// ---------------------------------------------------------------------------
// The tensor-core body
// ---------------------------------------------------------------------------

constexpr int kMmaChunk = 32;      // L
constexpr int kMmaMaxWarps = 12;   // 16 columns of C^T x one column group each
constexpr int kMmaMaxDW = 192;     // columns of C^T (d) a warp holds at most
constexpr int kMmaMaxNT = kMmaMaxDW / 8;
static_assert(kMmaChunk == 32, "the per-chunk reductions use one warp");

// bf16 parts of the operands by q's type T: q / k / v themselves (kQ: bf16
// exact in one part, fp16 in two, fp32 in three), C in q C (kC), the
// weighted scores in S V (kS) and w_j v_j in the update of C (kW).  Every
// product runs over the part pairs (i, j) with i + j < 3 (part_pair):
// every pair whose product is at least 2^-16 of the leading pair's, so
// that fp16's and fp32's products keep fp32 accuracy (fp16's exact parts
// multiply whole); bf16's C is kept to 2^-16 of its size beside exact q.
template <typename T> struct MmaParts;
template <> struct MmaParts<__nv_bfloat16> {
  static constexpr int kQ = 1, kC = 2, kS = 2, kW = 3;
};
template <> struct MmaParts<__half> {
  static constexpr int kQ = 2, kC = 2, kS = 2, kW = 3;
};
template <> struct MmaParts<float> {
  static constexpr int kQ = 3, kC = 3, kS = 3, kW = 3;
};

__host__ __device__ constexpr bool part_pair(int i, int j) {
  return i + j < 3;
}

// Shared-memory layout of the tensor-core body at head dim dh, column tile
// te and the parts of q/k/v (pq), of the weighted scores (ps) and of w_j
// v_j (pw) (byte offsets; every region 16-byte aligned).  bf16 q/k/v (pq =
// 1): two cp.async stages of the chunk's Q and K rows (dh padded to dhp, a
// multiple of 16, row stride dhp + 8 elements so the 8 rows an ldmatrix
// reads fall in distinct banks), of its V columns and its gates.  fp16 /
// fp32 (pq > 1): one stage, the chunk's Q, K and V each as pq bf16 planes
// of that layout, cut as the rows land (two stages of fp32 rows would not
// fit beside the rest: 200,704 bytes of Q and K at dh = 384), and its
// gates.  Then n as three bf16 parts in the rows of an 8-row key tile (the
// rest zeros); the raw scores; the bf16 parts of the weighted scores and
// of w_j v_j; the partial h of column groups 1.. for group 0 to add; n;
// per-row values and the block's scalars.
struct MlstmMmaSmem {
  int dhp, groups, dw, q_stride, v_stride, bufs;
  int q, k, v, gates, nk, sraw, sp, wv, red, n, rows, total;
  __host__ __device__ MlstmMmaSmem(int dh, int te, int pq, int ps, int pw) {
    const int L = kMmaChunk;
    dhp = (dh + 15) & ~15;
    groups = (dhp + kMmaMaxDW - 1) / kMmaMaxDW;
    dw = (dhp / 16 + groups - 1) / groups * 16;
    q_stride = (dhp + 8) * 2;
    v_stride = (te + 8) * 2;
    bufs = pq == 1 ? 2 : pq;                     // stages, or planes
    const int gate_stages = pq == 1 ? 2 : 1;
    q = 0;
    k = q + bufs * L * q_stride;
    v = k + bufs * L * q_stride;
    gates = v + bufs * L * v_stride;             // [stage][i | log f][L]
    nk = gates + gate_stages * 2 * L * 4;        // [8][dhp + 8] bf16
    sraw = nk + 8 * q_stride;                    // [L][L + 4] fp32
    sp = sraw + L * (L + 4) * 4;                 // [ps][L][L + 8] bf16
    wv = sp + ps * L * (L + 8) * 2;              // [pw][L][te + 8] bf16
    red = wv + pw * L * v_stride;                // [groups - 1][L][te + 4]
    n = red + (groups - 1) * L * (te + 4) * 4;   // [dhp] fp32
    rows = n + dhp * 4;                          // 7 x [L] fp32, 4 scalars
    total = rows + 7 * L * 4 + 16;
  }
};

template <typename T>
__host__ __device__ inline MlstmMmaSmem mma_smem(int dh, int te) {
  using PT = MmaParts<T>;
  return MlstmMmaSmem(dh, te, PT::kQ, PT::kS, PT::kW);
}

// The 16 / sizeof(T) values of T in raw as P bf16 planes: their parts at
// dst, dst + plane, ... (split_bf16)
template <typename T, int P>
__device__ __forceinline__ void split_planes(const uint4& raw, char* dst,
                                             int plane) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (std::is_same_v<T, float>) {
    uint32_t a[P], b[P];
    split_bf16<P>(__uint_as_float(w[0]), __uint_as_float(w[1]), a);
    split_bf16<P>(__uint_as_float(w[2]), __uint_as_float(w[3]), b);
#pragma unroll
    for (int pp = 0; pp < P; ++pp)
      *reinterpret_cast<uint2*>(dst + pp * plane) = make_uint2(a[pp], b[pp]);
  } else {
    static_assert(std::is_same_v<T, __half>, "fp32 or fp16 planes");
    uint32_t o[P][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[u]));
      uint32_t s[P];
      split_bf16<P>(f.x, f.y, s);
#pragma unroll
      for (int pp = 0; pp < P; ++pp) o[pp][u] = s[pp];
    }
#pragma unroll
    for (int pp = 0; pp < P; ++pp)
      *reinterpret_cast<uint4*>(dst + pp * plane) =
          make_uint4(o[pp][0], o[pp][1], o[pp][2], o[pp][3]);
  }
}

// Eight bf16 values at src (16-byte aligned) summed over P planes, the
// smallest part first: exactly the fp32 / fp16 values they were cut from
template <int P>
__device__ __forceinline__ void sum_planes8(const char* src, int plane,
                                            float (&v)[8]) {
#pragma unroll
  for (int pp = P - 1; pp >= 0; --pp) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + pp * plane);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float lo = __uint_as_float(w[u] << 16);
      const float hi = __uint_as_float(w[u] & 0xffff0000u);
      v[2 * u] = pp == P - 1 ? lo : v[2 * u] + lo;
      v[2 * u + 1] = pp == P - 1 ? hi : v[2 * u + 1] + hi;
    }
  }
}

// Element i of P bf16 planes at src, summed as sum_planes8 does
template <int P>
__device__ __forceinline__ float sum_planes(const char* src, int plane,
                                            int i) {
  float x = 0.f;
#pragma unroll
  for (int pp = P - 1; pp >= 0; --pp)
    x += __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(src + pp * plane)[i]);
  return x;
}

// A warp's fragments of C^T (columns d = d0 + 8 nt, + 1 with d0 = d_lo +
// 2 tig; rows e = ea, ea + 8) into a (dh, dh) state, columns e < e_end.
__device__ __forceinline__ void store_ct(const float (&c)[kMmaMaxNT][4],
                                         float* Cout, int dh, int d0, int ea,
                                         int ntiles, int e_end) {
#pragma unroll
  for (int nt = 0; nt < kMmaMaxNT; ++nt) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int d = d0 + nt * 8 + (x & 1);
      const int e = ea + (x >> 1) * 8;
      if (nt < ntiles && d < dh && e < e_end) Cout[(long)d * dh + e] = c[nt][x];
    }
  }
}

// grid (B * H, ceil(dh / te)), (te / 16) x groups warps: warp (eg, dg)
// holds C^T[e][d] for the block's columns e0 + 16 eg .. + 15 and d in
// column group dg as accumulator fragments c[nt] (rows e = gid, gid + 8;
// columns d = d_lo + 8 nt + 2 tig, + 1) from the first chunk to the last.
// bf16 q/k/v are staged as they are, the next chunk's by cp.async while
// this one is computed; fp16 / fp32 land in one stage as bf16 planes
// (batched 16-byte loads, cut into parts as they arrive).  With more than
// one part of q/k/v (kApart), the products of the leading part pair and of
// the other pairs go to separate accumulators that meet once, rounded to
// nearest: the tensor cores add into an accumulator with truncation at the
// size of its largest term, so the small pairs summed into the leading sum
// would each cost it an ulp (as in flash attention's fp32 bodies).
template <typename T, bool kStates>
__global__ void __launch_bounds__(kMmaMaxWarps * 32, 1)
    mlstm_chunk_mma_kernel(Params p) {
  using PT = MmaParts<T>;
  constexpr int PQ = PT::kQ, PC = PT::kC, PS = PT::kS, PW = PT::kW;
  constexpr bool kPlanes = PQ > 1;
  extern __shared__ __align__(16) char sm[];
  const MlstmMmaSmem Ls = mma_smem<T>(p.dh, p.te);
  constexpr int L = kMmaChunk;
  const int dh = p.dh, dhp = Ls.dhp, te = p.te;
  const int groups = Ls.groups, qst = Ls.q_stride, vst = Ls.v_stride;
  const int qplane = L * qst, vplane = L * vst;  // bytes between buffers
  const int b = blockIdx.x / p.H, hh = blockIdx.x % p.H;
  const int e0 = blockIdx.y * te, te_valid = min(te, dh - e0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, nwarps = nthreads >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int eg = warp % (te / 16), dg = warp / (te / 16);
  const int d_lo = dg * Ls.dw, ntiles = min(Ls.dw, dhp - d_lo) / 8;
  const long sbh = (long)b * p.H + hh;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  __nv_bfloat16* nk = reinterpret_cast<__nv_bfloat16*>(sm + Ls.nk);
  float* Sraw = reinterpret_cast<float*>(sm + Ls.sraw);
  __nv_bfloat16* Sp = reinterpret_cast<__nv_bfloat16*>(sm + Ls.sp);
  __nv_bfloat16* WVp = reinterpret_cast<__nv_bfloat16*>(sm + Ls.wv);
  float* red = reinterpret_cast<float*>(sm + Ls.red);
  float* ns = reinterpret_cast<float*>(sm + Ls.n);
  float* Fs = reinterpret_cast<float*>(sm + Ls.rows);
  float* is = Fs + L;          // input pre-activations
  float* ms = is + L;          // row stabilisers m_i
  float* sw = ms + L;          // state-path weights (0 past the chunk)
  float* dinv = sw + L;        // 1 / max(|denominator|, e^{-m_i})
  float* qn = dinv + L;        // q_i . n
  float* wk = qn + L;          // key weights to the chunk's end
  float* scal = wk + L;        // m_prev, m_next, decay
  const int rstride = te + 4;  // red's row stride (floats)
  const int nks = qst / 2;     // nk's row stride (elements)

  // C^T into registers; n, its bf16 parts and m_prev into shared memory
  float c[kMmaMaxNT][4];
  {
    const float* C0 = p.C0 + sbh * dh * dh;
    const int ea = e0 + eg * 16 + gid;
#pragma unroll
    for (int nt = 0; nt < kMmaMaxNT; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = d_lo + nt * 8 + 2 * tig + (x & 1);
        const int e = ea + (x >> 1) * 8;
        c[nt][x] = nt < ntiles && d < dh && e < e0 + te_valid
                       ? C0[(long)d * dh + e] : 0.f;
      }
    }
  }
  for (int d = tid; d < dhp; d += nthreads) {
    const float nd = d < dh ? p.n0[sbh * dh + d] : 0.f;
    ns[d] = nd;
    split_store<3>(nd, nk + d, nks);
#pragma unroll
    for (int r = 3; r < 8; ++r) nk[r * nks + d] = __float2bfloat16_rn(0.f);
  }
  if (tid == 0) scal[0] = p.m0[sbh];

  // bf16: request chunk c0's Q, K, V rows (zeros past the chunk and in the
  // padding of dh and te) and gates into stage st
  auto issue = [&](int c0, int st) {
    const int Lc = min(L, p.S - c0);
    const long row0 = ((long)b * p.S + c0) * p.H + hh;
    char* qd = sm + Ls.q + st * qplane;
    char* kd = sm + Ls.k + st * qplane;
    char* vd = sm + Ls.v + st * vplane;
    const int per_row = dhp / 8;
    for (int i = tid; i < L * per_row; i += nthreads) {
      const int t = i / per_row, col = i % per_row * 8;
      const bool ok = t < Lc && col < dh;
      const long src = ok ? (row0 + (long)t * p.H) * dh + col : 0;
      cp_async16(qd + t * qst + col * 2, q + src, ok);
      cp_async16(kd + t * qst + col * 2, k + src, ok);
    }
    const int per_v = te / 8;
    for (int i = tid; i < L * per_v; i += nthreads) {
      const int t = i / per_v, col = i % per_v * 8;
      const bool ok = t < Lc && col < te_valid;
      const long src = ok ? (row0 + (long)t * p.H) * dh + e0 + col : 0;
      cp_async16(vd + t * vst + col * 2, v + src, ok);
    }
    float* g = reinterpret_cast<float*>(sm + Ls.gates) + st * 2 * L;
    if (tid < L) {
      const bool ok = tid < Lc;
      const long src = ok ? row0 + (long)tid * p.H : 0;
      cp_async4(g + tid, p.ig + src, ok);
      cp_async4(g + L + tid, p.lf + src, ok);
    }
  };

  // fp16 / fp32: chunk c0's Q, K, V as PQ bf16 planes and its gates (zeros
  // past the chunk and in the padding of dh and te); 16-byte loads, kBatch
  // of Q and of K in flight a thread before their parts are stored
  auto land = [&](int c0) {
    if constexpr (kPlanes) {   // (bf16 never calls it)
      constexpr int kVec = 16 / (int)sizeof(T);
      constexpr int kBatch = 4;
      const int Lc = min(L, p.S - c0);
      const long row0 = ((long)b * p.S + c0) * p.H + hh;
      const int per_row = dhp / kVec, nq = L * per_row;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int i0 = tid; i0 < nq; i0 += kBatch * nthreads) {
        uint4 rq[kBatch], rk[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * nthreads;
          const int t = i / per_row, col = i % per_row * kVec;
          const bool ok = i < nq && t < Lc && col < dh;
          const long src = (row0 + (long)t * p.H) * dh + col;
          rq[u] = ok ? __ldg(reinterpret_cast<const uint4*>(q + src)) : zero;
          rk[u] = ok ? __ldg(reinterpret_cast<const uint4*>(k + src)) : zero;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * nthreads;
          if (i < nq) {
            const int off = i / per_row * qst + i % per_row * kVec * 2;
            split_planes<T, PQ>(rq[u], sm + Ls.q + off, qplane);
            split_planes<T, PQ>(rk[u], sm + Ls.k + off, qplane);
          }
        }
      }
      const int per_v = te / kVec;
      for (int i = tid; i < L * per_v; i += nthreads) {
        const int t = i / per_v, col = i % per_v * kVec;
        const bool ok = t < Lc && col < te_valid;
        const long src = (row0 + (long)t * p.H) * dh + e0 + col;
        split_planes<T, PQ>(
            ok ? __ldg(reinterpret_cast<const uint4*>(v + src)) : zero,
            sm + Ls.v + t * vst + col * 2, vplane);
      }
      float* g = reinterpret_cast<float*>(sm + Ls.gates);
      if (tid < L) {
        const bool ok = tid < Lc;
        const long src = row0 + (long)tid * p.H;
        g[tid] = ok ? p.ig[src] : 0.f;
        g[L + tid] = ok ? p.lf[src] : 0.f;
      }
    }
  };

  if constexpr (!kPlanes) {
    issue(0, 0);
    cp_async_commit();
  }
  int st = 0;
  for (int c0 = 0; c0 < p.S; c0 += L, st ^= 1) {
    const int Lc = min(L, p.S - c0);
    const long row0 = ((long)b * p.S + c0) * p.H + hh;
    if constexpr (kPlanes) {
      __syncthreads();           // the last chunk has read its planes
      land(c0);
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();             // the chunk is in (bf16: the other stage free)
    if constexpr (kStates) {     // the chunk's start state (n, m: tile 0)
      const long cs = sbh * ((p.S + L - 1) / L) + c0 / L;
      store_ct(c, p.Cst + cs * dh * dh, dh, d_lo + 2 * tig,
               e0 + eg * 16 + gid, ntiles, e0 + te_valid);
      if (blockIdx.y == 0) {
        for (int d = tid; d < dh; d += nthreads) p.nst[cs * dh + d] = ns[d];
        if (tid == 0) p.mst[cs] = scal[0];
      }
    }
    if constexpr (!kPlanes) {
      if (c0 + L < p.S) issue(c0 + L, st ^ 1);
      cp_async_commit();
    }
    const int sb = kPlanes ? 0 : st;   // the chunk's stage
    const char* qs = sm + Ls.q + sb * qplane;
    const char* ks = sm + Ls.k + sb * qplane;
    const char* vs = sm + Ls.v + sb * vplane;
    const float* gs = reinterpret_cast<const float*>(sm + Ls.gates) +
                      sb * 2 * L;

    // Phase A, on the tensor cores: eight items of 16 rows i x 8 columns,
    // one a warp: the six tiles of raw scores q_i . k_j on or below the
    // diagonal, and q_i . n (n's three parts as columns 0-2 of a key
    // tile, times each part of q) for both row tiles ...
    for (int item = warp; item < 8; item += nwarps) {
      const int mt = item < 2 || item == 6 ? 0 : 1;
      const int jt = item < 2 ? item : item < 6 ? item - 2 : -1;
      const char* bsrc = jt >= 0 ? ks + jt * 8 * qst : (const char*)nk;
      const int pb = jt >= 0 ? PQ : 1;   // B's parts: K's planes, or n's tile
      float s[2][4] = {}, sl[4] = {};    // two chains; the other part pairs
      for (int kk = 0; kk < dhp / 16; kk += 2) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (kk + u < dhp / 16) {
            const int d0 = (kk + u) * 16;
#pragma unroll
            for (int i = 0; i < PQ; ++i) {
              uint32_t a[4];
              ldsm_x4(a, qs + i * qplane + (mt * 16 + (lane & 15)) * qst +
                             (d0 + (lane >> 4) * 8) * 2);
#pragma unroll
              for (int j = 0; j < PQ; ++j) {
                if (j < pb && part_pair(i, j)) {
                  uint32_t bb[2];
                  ldsm_x2(bb, bsrc + j * qplane + (lane & 7) * qst +
                                  (d0 + ((lane >> 3) & 1) * 8) * 2);
                  mma16816<__nv_bfloat16>(i + j == 0 ? s[u] : sl, a, bb[0],
                                          bb[1]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) s[0][x] += s[1][x];
      if constexpr (kPlanes) {
#pragma unroll
        for (int x = 0; x < 4; ++x) s[0][x] += sl[x];
      }
      if (jt >= 0) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *reinterpret_cast<float2*>(Sraw + (mt * 16 + gid + rr * 8) *
                                                (L + 4) + jt * 8 + 2 * tig) =
              make_float2(s[0][rr * 2], s[0][rr * 2 + 1]);
      } else {
        // columns 0, 1 sit with tig 0, column 2 with tig 1
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float t = tig == 0 ? s[0][rr * 2] + s[0][rr * 2 + 1]
                             : tig == 1 ? s[0][rr * 2] : 0.f;
          t += __shfl_xor_sync(~0u, t, 1);
          if (tig == 0) qn[mt * 16 + gid + rr * 8] = t;
        }
      }
    }
    // ... and, in the last warp, the gates: the cumulative log forget F
    // (a scan), the row stabilisers m_i = max(F_i + max_{j<=i} (i_j -
    // F_j), F_i + m_prev) (a prefix-max scan) with their state weights,
    // the key weights to the chunk's end, m_new and the decay
    if (warp == nwarps - 1) {
      float f = lane < Lc ? gs[L + lane] : 0.f;
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(~0u, f, o);
        if (lane >= o) f += up;
      }
      const float ig = lane < Lc ? gs[lane] : 0.f;
      const float mp = scal[0], Ftot = __shfl_sync(~0u, f, Lc - 1);
      float pm = lane < Lc ? ig - f : -INFINITY;
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(~0u, pm, o);
        if (lane >= o) pm = fmaxf(pm, up);
      }
      const float lst = f + mp;
      float mi = fmaxf(f + pm, lst);
      if (!isfinite(mi)) mi = 0.f;
      const float t = lane < Lc ? Ftot - f + ig : -INFINITY;
      const float mn = fmaxf(mp + Ftot, warp_max(t));
      Fs[lane] = f;
      is[lane] = ig;
      ms[lane] = mi;
      sw[lane] = lane < Lc ? expf(lst - mi) : 0.f;
      wk[lane] = lane < Lc ? expf(t - mn) : 0.f;
      if (lane == 0) {
        scal[1] = mn;
        scal[2] = expf(mp + Ftot - mn);
      }
    }
    __syncthreads();

    // Phase B.  The weighted scores s_ij (0 above the diagonal and past
    // the chunk) as bf16 parts and the rows' 1 / denominators; w_j v_j as
    // parts; n to the chunk's end, and its parts
    const float dc = scal[2];
    if (tid == 0) scal[0] = scal[1];
    for (int i = warp; i < L; i += nwarps) {
      const int j = lane;
      const float s = i < Lc && j <= i
          ? Sraw[i * (L + 4) + j] * expf(Fs[i] - Fs[j] + is[j] - ms[i])
          : 0.f;
      split_store<PS>(s, Sp + i * (L + 8) + j, L * (L + 8));
      const float rs = warp_sum(s);
      if (lane == 0 && i < Lc)
        dinv[i] = 1.f / fmaxf(fabsf(rs + sw[i] * qn[i]), expf(-ms[i]));
    }
    {
      // 8 columns of one row j a thread: one 16-byte load a plane, PW
      // stores
      const int per = te / 8;
      for (int x = tid; x < L * per; x += nthreads) {
        const int j = x / per, e = x % per * 8;
        float vv[8];
        sum_planes8<PQ>(vs + j * vst + e * 2, vplane, vv);
        const float w = wk[j];
        uint32_t out[PW][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t pr[PW];
          split_bf16<PW>(w * vv[2 * u], w * vv[2 * u + 1], pr);
#pragma unroll
          for (int pp = 0; pp < PW; ++pp) out[pp][u] = pr[pp];
        }
#pragma unroll
        for (int pp = 0; pp < PW; ++pp)
          *reinterpret_cast<uint4*>(WVp + (pp * L + j) * (te + 8) + e) =
              make_uint4(out[pp][0], out[pp][1], out[pp][2], out[pp][3]);
      }
      for (int d = tid; d < dhp; d += nthreads) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < L; ++j)          // wk_j = 0 past the chunk
          a = fmaf(wk[j], sum_planes<PQ>(ks, qplane, j * (dhp + 8) + d), a);
        const float nd = dc * ns[d] + a;
        ns[d] = nd;
        split_store<3>(nd, nk + d, nks);
      }
    }
    __syncthreads();

    // Phase C, per warp.  h^T (16 columns e x 32 rows i) = sw_i x (C^T
    // q^T over the warp's d) + V^T S^T (the j steps spread over the
    // column groups), with the old C
    float hacc[4][4], hlo[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) hacc[nt][x] = hlo[nt][x] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMmaMaxNT / 2; ++kk) {
      if (2 * kk < ntiles) {
        // C's fragments of d columns 16 kk .. + 15 are the A operand
        uint32_t a[PC][4];
        split_acc_a<PC>(a, c[2 * kk], c[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
#pragma unroll
          for (int j = 0; j < PQ; ++j) {
            uint32_t qb[4];
            ldsm_x4(qb, qs + j * qplane +
                            (np * 16 + (lane >> 4) * 8 + (lane & 7)) * qst +
                            (d_lo + kk * 16 + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
            for (int i = 0; i < PC; ++i) {
              if (part_pair(i, j)) {
                const bool lead = !kPlanes || i + j == 0;
                mma16816<__nv_bfloat16>(lead ? hacc[np * 2] : hlo[np * 2],
                                        a[i], qb[0], qb[1]);
                mma16816<__nv_bfloat16>(
                    lead ? hacc[np * 2 + 1] : hlo[np * 2 + 1], a[i], qb[2],
                    qb[3]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if constexpr (kPlanes) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          hacc[nt][x] += hlo[nt][x];
          hlo[nt][x] = 0.f;
        }
      }
      const float w0 = sw[nt * 8 + 2 * tig], w1 = sw[nt * 8 + 2 * tig + 1];
      hacc[nt][0] *= w0;
      hacc[nt][1] *= w1;
      hacc[nt][2] *= w0;
      hacc[nt][3] *= w1;
    }
#pragma unroll
    for (int kj = 0; kj < 2; ++kj) {
      if (kj % groups != dg || kj * 16 >= Lc) continue;
      uint32_t va[PQ][4];
#pragma unroll
      for (int i = 0; i < PQ; ++i)
        ldsm_x4_t(va[i], vs + i * vplane +
                             (kj * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                                 vst +
                             (eg * 16 + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
#pragma unroll
        for (int j = 0; j < PS; ++j) {
          uint32_t sb[4];
          ldsm_x4(sb, Sp + j * L * (L + 8) +
                          (np * 16 + (lane >> 4) * 8 + (lane & 7)) * (L + 8) +
                          kj * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int i = 0; i < PQ; ++i) {
            if (part_pair(i, j)) {
              const bool lead = !kPlanes || i + j == 0;
              mma16816<__nv_bfloat16>(lead ? hacc[np * 2] : hlo[np * 2],
                                      va[i], sb[0], sb[1]);
              mma16816<__nv_bfloat16>(
                  lead ? hacc[np * 2 + 1] : hlo[np * 2 + 1], va[i], sb[2],
                  sb[3]);
            }
          }
        }
      }
    }
    if constexpr (kPlanes) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) hacc[nt][x] += hlo[nt][x];
    }
    if (dg > 0) {              // column groups 1.. leave their partial h
      float* rd = red + (dg - 1) * L * rstride;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          rd[(nt * 8 + 2 * tig + (x & 1)) * rstride + eg * 16 + gid +
             (x >> 1) * 8] = hacc[nt][x];
    }

    // Phase D: column group 0 adds the other groups' partials and writes
    // h for the chunk's rows and the block's valid columns (every shared
    // value read before the next chunk's first store)
    if (groups > 1) __syncthreads();
    if (dg == 0) {
      float di[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) di[nt][u] = dinv[nt * 8 + 2 * tig + u];
      for (int g2 = 1; g2 < groups; ++g2) {
        const float* rd = red + (g2 - 1) * L * rstride;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            hacc[nt][x] += rd[(nt * 8 + 2 * tig + (x & 1)) * rstride +
                              eg * 16 + gid + (x >> 1) * 8];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = nt * 8 + 2 * tig + (x & 1);
          const int e = eg * 16 + gid + (x >> 1) * 8;
          if (i < Lc && e < te_valid)
            p.h[(row0 + (long)i * p.H) * dh + e0 + e] =
                hacc[nt][x] * di[nt][x & 1];
        }
      }
    }

    // C^T = decay C^T + (w V)^T K in the registers, a pair of C's tiles at
    // a time (kPlanes: the other part pairs' fresh sums added once)
#pragma unroll
    for (int nt = 0; nt < kMmaMaxNT; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) c[nt][x] *= dc;
    uint32_t wa[2][PW][4];
#pragma unroll
    for (int kj = 0; kj < 2; ++kj) {
      if (kj * 16 >= Lc) break;
#pragma unroll
      for (int pp = 0; pp < PW; ++pp)
        ldsm_x4_t(wa[kj][pp], WVp + pp * L * (te + 8) +
                                  (kj * 16 + (lane & 7) +
                                   ((lane >> 4) & 1) * 8) * (te + 8) +
                                  eg * 16 + ((lane >> 3) & 1) * 8);
    }
#pragma unroll
    for (int np = 0; np < kMmaMaxNT / 2; ++np) {
      if (2 * np < ntiles) {
        float lo0[4] = {}, lo1[4] = {};
#pragma unroll
        for (int kj = 0; kj < 2; ++kj) {
          if (kj * 16 >= Lc) break;
#pragma unroll
          for (int j = 0; j < PQ; ++j) {
            uint32_t kb[4];
            ldsm_x4_t(kb, ks + j * qplane + (kj * 16 + (lane & 15)) * qst +
                              (d_lo + np * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
            for (int i = 0; i < PW; ++i) {
              if (part_pair(i, j)) {
                const bool lead = !kPlanes || i + j == 0;
                mma16816<__nv_bfloat16>(lead ? c[2 * np] : lo0, wa[kj][i],
                                        kb[0], kb[1]);
                mma16816<__nv_bfloat16>(lead ? c[2 * np + 1] : lo1,
                                        wa[kj][i], kb[2], kb[3]);
              }
            }
          }
        }
        if constexpr (kPlanes) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            c[2 * np][x] += lo0[x];
            c[2 * np + 1][x] += lo1[x];
          }
        }
      }
    }
  }

  // the final C, and n and m from the first column tile
  store_ct(c, p.C + sbh * dh * dh, dh, d_lo + 2 * tig, e0 + eg * 16 + gid,
           ntiles, e0 + te_valid);
  if (blockIdx.y == 0) {
    for (int d = tid; d < dh; d += nthreads) p.n[sbh * dh + d] = ns[d];
    if (tid == 0) p.m[sbh] = scal[0];
  }
}

// The tensor-core body's launch, if its plan fits: q/k/v rows of dh (a
// multiple of 8, at most 2 x kMmaMaxDW) elements on 16-byte boundaries,
// te a multiple of 16, at most kMmaMaxWarps warps, the layout within
// 227 KB.
template <typename T, bool kStates>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  if (p.dh % 8 || p.dh > 2 * kMmaMaxDW || p.te < 16 || p.te % 16)
    return cudaErrorInvalidValue;
  for (const void* x : {p.q, p.k, p.v})
    if (reinterpret_cast<uintptr_t>(x) % 16) return cudaErrorInvalidValue;
  const MlstmMmaSmem Ls = mma_smem<T>(p.dh, p.te);
  const int warps = p.te / 16 * Ls.groups;
  if (warps > kMmaMaxWarps || Ls.total > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaError_t e = opt_in_smem(
      (const void*)mlstm_chunk_mma_kernel<T, kStates>, Ls.total);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.dh + p.te - 1) / p.te);
  mlstm_chunk_mma_kernel<T, kStates>
      <<<grid, warps * 32, Ls.total, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kStates>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(p.dh) * sizeof(float);
  cudaError_t e =
      opt_in_smem((const void*)mlstm_chunk_kernel<T, kStates>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.dh + kTileE - 1) / kTileE);
  mlstm_chunk_kernel<T, kStates><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The body's launch (checked against q's dtype), with or without the
// chunk states.
template <bool kStates>
int launch_body(const Params& p, int dtype, int body, cudaStream_t s) {
  if (body == 1) {
    switch (dtype) {
      case 0: return (int)launch_mma<float, kStates>(p, s);
      case 1: return (int)launch_mma<__half, kStates>(p, s);
      case 2: return (int)launch_mma<__nv_bfloat16, kStates>(p, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch<float, kStates>(p, s);
    case 1: return (int)launch<__half, kStates>(p, s);
    case 2: return (int)launch<__nv_bfloat16, kStates>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* ig, const void* lf, const void* C0,
                   const void* n0, const void* m0, void* h, void* C, void* n,
                   void* m, void* Cst, void* nst, void* mst, int B, int S,
                   int H, int dh, int te) {
  return Params{q, k, v, static_cast<const float*>(ig),
                static_cast<const float*>(lf), static_cast<const float*>(C0),
                static_cast<const float*>(n0), static_cast<const float*>(m0),
                static_cast<float*>(h), static_cast<float*>(C),
                static_cast<float*>(n), static_cast<float*>(m), B, S, H, dh,
                te, static_cast<float*>(Cst), static_cast<float*>(nst),
                static_cast<float*>(mst)};
}

}  // namespace

// dtype of q, k, v: 0 = float32, 1 = float16, 2 = bfloat16; gates, state
// and h are fp32.  body: 0 = CUDA cores, 1 = tensor cores (te value
// columns per block; q/k/v 16-byte aligned), either at any dtype.  Returns
// cudaGetLastError() after the launch.
extern "C" int mlstm_chunk_launch(const void* q, const void* k, const void* v,
                                  const void* ig, const void* lf,
                                  const void* C0, const void* n0,
                                  const void* m0, void* h, void* C, void* n,
                                  void* m, int dtype, int B, int S, int H,
                                  int dh, int body, int te, void* stream) {
  return launch_body<false>(
      make_params(q, k, v, ig, lf, C0, n0, m0, h, C, n, m, nullptr, nullptr,
                  nullptr, B, S, H, dh, te),
      dtype, body, static_cast<cudaStream_t>(stream));
}

// The forward for training: mlstm_chunk_launch's arguments, then the
// state at the start of every chunk (Cst (B,H,NC,dh,dh), nst (B,H,NC,dh),
// mst (B,H,NC) fp32, NC = ceil(S / 32)), written beside h and the final
// state by the kStates bodies.
extern "C" int mlstm_chunk_states_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* lf, const void* C0, const void* n0, const void* m0, void* h,
    void* C, void* n, void* m, void* Cst, void* nst, void* mst, int dtype,
    int B, int S, int H, int dh, int body, int te, void* stream) {
  if (!Cst || !nst || !mst) return (int)cudaErrorInvalidValue;
  return launch_body<true>(
      make_params(q, k, v, ig, lf, C0, n0, m0, h, C, n, m, Cst, nst, mst, B,
                  S, H, dh, te),
      dtype, body, static_cast<cudaStream_t>(stream));
}

// Dynamic shared-memory bytes a launch of ``body`` needs at head dim dh
// (and, for the tensor-core body, q's dtype code and column tile te).
extern "C" long mlstm_chunk_smem_bytes(int body, int dtype, int dh, int te) {
  if (body != 1) return (long)(smem_floats(dh) * sizeof(float));
  switch (dtype) {
    case 0: return (long)mma_smem<float>(dh, te).total;
    case 1: return (long)mma_smem<__half>(dh, te).total;
    default: return (long)mma_smem<__nv_bfloat16>(dh, te).total;
  }
}
