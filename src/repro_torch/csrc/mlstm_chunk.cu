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
//  * bf16 q/k/v, dh a multiple of 8 up to 384, 16-byte aligned:
//    mlstm_chunk_mma_kernel, the chunk products on the tensor cores
//    (mma.sync.m16n8k16, fp32 accumulators, operands by ldmatrix).  The
//    block's warps split its C^T tile (te x dh) into 16-row x up-to-192-
//    column pieces held as fp32 accumulator fragments in registers for the
//    whole walk (te = 96 at dh = 384: 12 warps, 96 values a thread), so
//    the state never goes through shared memory.  Per chunk: S = Q K^T
//    (exact bf16 operands); h^T = C^T q^T (C's fragments used as the A
//    operand directly) and V^T S^T; then C^T = decay C^T + (w V)^T K.
//    Three operands are fp32, and each is split into bf16 parts whose sum
//    is the fp32 value, every part's product summed into the same fp32
//    accumulator: C in q C (2 parts), the weighted scores s in S V (2),
//    and w_j v_j in the update (3; C is held to 1e-5 of its scale).  The
//    per-row weight e^{F_i + m_prev - m_i} is applied to the q C
//    accumulators after the product.  Partial h of the column groups meet
//    in shared memory.  The next chunk's q, k, v and gates arrive by
//    16-byte cp.async while this chunk is computed (two stages).  Its
//    bound at long prompts is the parts' extra products: 2 + 3 of them
//    for every product of q C and the update.
//  * fp32 and fp16 q/k/v, and shapes the tensor-core body does not take:
//    mlstm_chunk_kernel, on CUDA cores, all arithmetic fp32 (a tensor-core
//    body would multiply fp32 in TF32, and the card's fp32 greedy streams
//    must keep equalling the CPU's; fp16's 11-bit values would need two
//    bf16 parts each).  Each block keeps its dh x 64 slice of C in shared
//    memory; every product is a serial fp32 dot product.
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
// The tensor-core body (bf16 q/k/v)
// ---------------------------------------------------------------------------

constexpr int kMmaChunk = 32;      // L
constexpr int kMmaMaxWarps = 12;   // 16 columns of C^T x one column group each
constexpr int kMmaMaxDW = 192;     // columns of C^T (d) a warp holds at most
constexpr int kMmaMaxNT = kMmaMaxDW / 8;
constexpr int kPartsC = 2;         // bf16 parts of C in q C
constexpr int kPartsS = 2;         // of the weighted scores in S V
constexpr int kPartsW = 3;         // of w_j v_j in the update of C
static_assert(kMmaChunk == 32, "the per-chunk reductions use one warp");

// Shared-memory layout of the tensor-core body at head dim dh and column
// tile te (byte offsets; every region 16-byte aligned): two stages of the
// chunk's Q and K rows (dh padded to dhp, a multiple of 16, row stride
// dhp + 8 elements so the 8 rows an ldmatrix reads fall in distinct
// banks), its V columns and gates; n as three bf16 parts in the rows of
// an 8-row key tile (the rest zeros); the raw scores; the bf16 parts of
// the weighted scores and of w_j v_j; the partial h of column groups 1..
// for group 0 to add; n; per-row values and the block's scalars.
struct MlstmMmaSmem {
  int dhp, groups, dw, q_stride, v_stride;
  int q, k, v, gates, nk, sraw, sp, wv, red, n, rows, total;
  __host__ __device__ MlstmMmaSmem(int dh, int te) {
    const int L = kMmaChunk;
    dhp = (dh + 15) & ~15;
    groups = (dhp + kMmaMaxDW - 1) / kMmaMaxDW;
    dw = (dhp / 16 + groups - 1) / groups * 16;
    q_stride = (dhp + 8) * 2;
    v_stride = (te + 8) * 2;
    q = 0;
    k = q + 2 * L * q_stride;
    v = k + 2 * L * q_stride;
    gates = v + 2 * L * v_stride;                // [stage][i | log f][L]
    nk = gates + 2 * 2 * L * 4;                  // [8][dhp + 8] bf16
    sraw = nk + 8 * q_stride;                    // [L][L + 4] fp32
    sp = sraw + L * (L + 4) * 4;                 // [kPartsS][L][L + 8] bf16
    wv = sp + kPartsS * L * (L + 8) * 2;         // [kPartsW][L][te + 8] bf16
    red = wv + kPartsW * L * v_stride;           // [groups - 1][L][te + 4]
    n = red + (groups - 1) * L * (te + 4) * 4;   // [dhp] fp32
    rows = n + dhp * 4;                          // 7 x [L] fp32, 4 scalars
    total = rows + 7 * L * 4 + 16;
  }
};

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
template <bool kStates>
__global__ void __launch_bounds__(kMmaMaxWarps * 32, 1)
    mlstm_chunk_mma_kernel(Params p) {
  extern __shared__ __align__(16) char sm[];
  const MlstmMmaSmem Ls(p.dh, p.te);
  constexpr int L = kMmaChunk;
  const int dh = p.dh, dhp = Ls.dhp, te = p.te;
  const int groups = Ls.groups, qst = Ls.q_stride, vst = Ls.v_stride;
  const int b = blockIdx.x / p.H, hh = blockIdx.x % p.H;
  const int e0 = blockIdx.y * te, te_valid = min(te, dh - e0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, nwarps = nthreads >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int eg = warp % (te / 16), dg = warp / (te / 16);
  const int d_lo = dg * Ls.dw, ntiles = min(Ls.dw, dhp - d_lo) / 8;
  const long sbh = (long)b * p.H + hh;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
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

  // request chunk c0's Q, K, V rows (zeros past the chunk and in the
  // padding of dh and te) and gates into stage st
  auto issue = [&](int c0, int st) {
    const int Lc = min(L, p.S - c0);
    const long row0 = ((long)b * p.S + c0) * p.H + hh;
    char* qd = sm + Ls.q + st * L * qst;
    char* kd = sm + Ls.k + st * L * qst;
    char* vd = sm + Ls.v + st * L * vst;
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

  issue(0, 0);
  cp_async_commit();
  int st = 0;
  for (int c0 = 0; c0 < p.S; c0 += L, st ^= 1) {
    const int Lc = min(L, p.S - c0);
    const long row0 = ((long)b * p.S + c0) * p.H + hh;
    cp_async_wait<0>();
    __syncthreads();             // this chunk's stage is in; the other free
    if constexpr (kStates) {     // the chunk's start state (n, m: tile 0)
      const long cs = sbh * ((p.S + L - 1) / L) + c0 / L;
      store_ct(c, p.Cst + cs * dh * dh, dh, d_lo + 2 * tig,
               e0 + eg * 16 + gid, ntiles, e0 + te_valid);
      if (blockIdx.y == 0) {
        for (int d = tid; d < dh; d += nthreads) p.nst[cs * dh + d] = ns[d];
        if (tid == 0) p.mst[cs] = scal[0];
      }
    }
    if (c0 + L < p.S) issue(c0 + L, st ^ 1);
    cp_async_commit();
    const char* qs = sm + Ls.q + st * L * qst;
    const char* ks = sm + Ls.k + st * L * qst;
    const char* vs = sm + Ls.v + st * L * vst;
    const float* gs = reinterpret_cast<const float*>(sm + Ls.gates) +
                      st * 2 * L;

    // Phase A, on the tensor cores: eight items of 16 rows i x 8 columns,
    // one a warp: the six tiles of raw scores q_i . k_j on or below the
    // diagonal, and q_i . n (n's three parts as columns 0-2 of a key
    // tile) for both row tiles ...
    for (int item = warp; item < 8; item += nwarps) {
      const int mt = item < 2 || item == 6 ? 0 : 1;
      const int jt = item < 2 ? item : item < 6 ? item - 2 : -1;
      const char* bsrc = jt >= 0 ? ks + jt * 8 * qst : (const char*)nk;
      float s[2][4] = {};        // two chains of accumulators
      for (int kk = 0; kk < dhp / 16; kk += 2) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (kk + u < dhp / 16) {
            const int d0 = (kk + u) * 16;
            uint32_t a[4], bb[2];
            ldsm_x4(a, qs + (mt * 16 + (lane & 15)) * qst +
                           (d0 + (lane >> 4) * 8) * 2);
            ldsm_x2(bb, bsrc + (lane & 7) * qst +
                            (d0 + ((lane >> 3) & 1) * 8) * 2);
            mma16816<__nv_bfloat16>(s[u], a, bb[0], bb[1]);
          }
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) s[0][x] += s[1][x];
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
      split_store<kPartsS>(s, Sp + i * (L + 8) + j, L * (L + 8));
      const float rs = warp_sum(s);
      if (lane == 0 && i < Lc)
        dinv[i] = 1.f / fmaxf(fabsf(rs + sw[i] * qn[i]), expf(-ms[i]));
    }
    {
      // 8 columns of one row j a thread: one 16-byte load, three stores
      const int per = te / 8;
      for (int x = tid; x < L * per; x += nthreads) {
        const int j = x / per, e = x % per * 8;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(vs + j * vst + e * 2);
        const float w = wk[j];
        const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t out[kPartsW][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t pr[kPartsW];
          split_bf16<kPartsW>(w * __uint_as_float(in[u] << 16),
                              w * __uint_as_float(in[u] & 0xffff0000u), pr);
#pragma unroll
          for (int pp = 0; pp < kPartsW; ++pp) out[pp][u] = pr[pp];
        }
#pragma unroll
        for (int pp = 0; pp < kPartsW; ++pp)
          *reinterpret_cast<uint4*>(WVp + (pp * L + j) * (te + 8) + e) =
              make_uint4(out[pp][0], out[pp][1], out[pp][2], out[pp][3]);
      }
      const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(ks);
      for (int d = tid; d < dhp; d += nthreads) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < L; ++j)          // wk_j = 0 past the chunk
          a = fmaf(wk[j], __bfloat162float(kb[j * (dhp + 8) + d]), a);
        const float nd = dc * ns[d] + a;
        ns[d] = nd;
        split_store<3>(nd, nk + d, nks);
      }
    }
    __syncthreads();

    // Phase C, per warp.  h^T (16 columns e x 32 rows i) = sw_i x (C^T
    // q^T over the warp's d) + V^T S^T (the j steps spread over the
    // column groups), with the old C
    float hacc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      hacc[nt][0] = hacc[nt][1] = hacc[nt][2] = hacc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMmaMaxNT / 2; ++kk) {
      if (2 * kk < ntiles) {
        // C's fragments of d columns 16 kk .. + 15 are the A operand
        uint32_t a0[kPartsC], a1[kPartsC], a2[kPartsC], a3[kPartsC];
        split_bf16<kPartsC>(c[2 * kk][0], c[2 * kk][1], a0);
        split_bf16<kPartsC>(c[2 * kk][2], c[2 * kk][3], a1);
        split_bf16<kPartsC>(c[2 * kk + 1][0], c[2 * kk + 1][1], a2);
        split_bf16<kPartsC>(c[2 * kk + 1][2], c[2 * kk + 1][3], a3);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t qb[4];
          ldsm_x4(qb, qs + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * qst +
                          (d_lo + kk * 16 + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
          for (int pp = 0; pp < kPartsC; ++pp) {
            const uint32_t a[4] = {a0[pp], a1[pp], a2[pp], a3[pp]};
            mma16816<__nv_bfloat16>(hacc[np * 2], a, qb[0], qb[1]);
            mma16816<__nv_bfloat16>(hacc[np * 2 + 1], a, qb[2], qb[3]);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float w0 = sw[nt * 8 + 2 * tig], w1 = sw[nt * 8 + 2 * tig + 1];
      hacc[nt][0] *= w0;
      hacc[nt][1] *= w1;
      hacc[nt][2] *= w0;
      hacc[nt][3] *= w1;
    }
#pragma unroll
    for (int kj = 0; kj < 2; ++kj) {
      if (kj % groups != dg || kj * 16 >= Lc) continue;
      uint32_t va[4];
      ldsm_x4_t(va, vs + (kj * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                             vst + (eg * 16 + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
#pragma unroll
        for (int pp = 0; pp < kPartsS; ++pp) {
          uint32_t sb[4];
          ldsm_x4(sb, Sp + pp * L * (L + 8) +
                          (np * 16 + (lane >> 4) * 8 + (lane & 7)) * (L + 8) +
                          kj * 16 + ((lane >> 3) & 1) * 8);
          mma16816<__nv_bfloat16>(hacc[np * 2], va, sb[0], sb[1]);
          mma16816<__nv_bfloat16>(hacc[np * 2 + 1], va, sb[2], sb[3]);
        }
      }
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

    // C^T = decay C^T + (w V)^T K, in the registers
#pragma unroll
    for (int nt = 0; nt < kMmaMaxNT; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) c[nt][x] *= dc;
#pragma unroll
    for (int kj = 0; kj < 2; ++kj) {
      if (kj * 16 >= Lc) break;
      uint32_t wa[kPartsW][4];
#pragma unroll
      for (int pp = 0; pp < kPartsW; ++pp)
        ldsm_x4_t(wa[pp], WVp + pp * L * (te + 8) +
                              (kj * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                                  (te + 8) +
                              eg * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < kMmaMaxNT / 2; ++np) {
        if (2 * np < ntiles) {
          uint32_t kb[4];
          ldsm_x4_t(kb, ks + (kj * 16 + (lane & 15)) * qst +
                            (d_lo + np * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
          for (int pp = 0; pp < kPartsW; ++pp) {
            mma16816<__nv_bfloat16>(c[2 * np], wa[pp], kb[0], kb[1]);
            mma16816<__nv_bfloat16>(c[2 * np + 1], wa[pp], kb[2], kb[3]);
          }
        }
      }
    }

    // Phase D: column group 0 adds the other groups' partials and writes
    // h for the chunk's rows and the block's valid columns (every shared
    // value read before the first store)
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
  }

  // the final C, and n and m from the first column tile
  {
    float* Cout = p.C + sbh * dh * dh;
    const int ea = e0 + eg * 16 + gid;
#pragma unroll
    for (int nt = 0; nt < kMmaMaxNT; ++nt) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = d_lo + nt * 8 + 2 * tig + (x & 1);
        const int e = ea + (x >> 1) * 8;
        if (nt < ntiles && d < dh && e < e0 + te_valid)
          Cout[(long)d * dh + e] = c[nt][x];
      }
    }
  }
  if (blockIdx.y == 0) {
    for (int d = tid; d < dh; d += nthreads) p.n[sbh * dh + d] = ns[d];
    if (tid == 0) p.m[sbh] = scal[0];
  }
}

// The tensor-core body's launch, if its plan fits: bf16 q/k/v rows of dh
// (a multiple of 8, at most 2 x kMmaMaxDW) elements, te a multiple of 16,
// at most kMmaMaxWarps warps, the layout within 227 KB.
template <bool kStates>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  if (p.dh % 8 || p.dh > 2 * kMmaMaxDW || p.te < 16 || p.te % 16)
    return cudaErrorInvalidValue;
  const MlstmMmaSmem Ls(p.dh, p.te);
  const int warps = p.te / 16 * Ls.groups;
  if (warps > kMmaMaxWarps || Ls.total > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaError_t e =
      opt_in_smem((const void*)mlstm_chunk_mma_kernel<kStates>, Ls.total);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.B * p.H, (p.dh + p.te - 1) / p.te);
  mlstm_chunk_mma_kernel<kStates><<<grid, warps * 32, Ls.total, stream>>>(p);
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
  if (body == 1)
    return dtype == 2 ? (int)launch_mma<kStates>(p, s)
                      : (int)cudaErrorInvalidValue;
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
// and h are fp32.  body: 0 = CUDA cores (any dtype), 1 = tensor cores
// (bf16 only; te value columns per block).  Returns cudaGetLastError()
// after the launch.
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
// (and, for the tensor-core body, column tile te).
extern "C" long mlstm_chunk_smem_bytes(int body, int dh, int te) {
  if (body == 1) return (long)MlstmMmaSmem(dh, te).total;
  return (long)(smem_floats(dh) * sizeof(float));
}
