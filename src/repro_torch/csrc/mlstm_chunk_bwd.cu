// The backward of the chunkwise mLSTM (mlstm_chunk.cu) for Hopper (sm_90a),
// bound to PyTorch through a plain C interface (ctypes); see
// repro_torch/kernels/mlstm_chunk.py (mlstm_chunked_bwd) and its plain
// version repro_torch/kernels/ref.py (mlstm_chunked_bwd_ref).
//
// Replaces no TPU kernel: the reference's Pallas mLSTM kernel has no
// backward, and the reference trains xlstm by differentiating its jnp path
// (repro/models/ssm.py mlstm_chunked) with jax.grad.  It computes the
// gradient of h with respect to q, k, v, the input-gate pre-activations
// and the log forget gates, from the state (C, n, m) at the start of every
// 32-step chunk that the forward kernel kept (mlstm_chunk_states_launch),
// h and its cotangent dh.  No cotangent reaches the final state and the
// initial state takes none (the wrapper's autograd Function refuses both).
//
// h is invariant to the stabiliser m (every e^{-m} of the stabilised
// formulas cancels, the floor's too), so m is a constant here, as in the
// xLSTM authors' kernels; every exponential is still taken relative to
// the forward's m's, so that none exceeds 1.  Per chunk, with the scores
// qk_ij = q_i.k_j, w_ij = e^{F_i - F_j + i_j - m_i} (j <= i), the state
// weights sw_i = e^{F_i + m_prev - m_i}, the key weights wk_j =
// e^{F_L - F_j + i_j - m_new}, decay = e^{m_prev + F_L - m_new}, the
// floor r_i = max(|den_i|, e^{-m_i}) and the cotangents (G, g) of the
// carried (C, n) (scaled by e^{m_new}; zero after the last chunk):
//   dN_i  = dh_i / r_i,  dd_i = -sign(den_i) (dh_i.h_i) / r_i if |den_i|
//           passes the floor, else 0
//   dS_ij = (dN_i.v_j + dd_i) w_ij
//   dq_i  = sum_j dS_ij k_j + sw_i (C dN_i + dd_i n)
//   dk_j  = sum_i dS_ij q_i + wk_j (G v_j + g)
//   dv_j  = sum_i qk_ij w_ij dN_i + wk_j G^T k_j
//   di_j  = sum_i dS_ij qk_ij + k_j.(dk_j's state part)
//   dF_i  = sum_j dS_ij qk_ij + q_i.(dq_i's state part) - di_i, and the
//           chunk's last step adds sum_j k_j.(state part) + decay (<G, C>
//           + <g, n>); dlogf is dF's reverse cumulative sum in the chunk
//   G     <- sum_i sw_i q_i dN_i^T + decay G,  g <- sum_i sw_i dd_i q_i
//           + decay g
// (the derivation is in ref.mlstm_chunked_bwd_ref's docstring).
//
// Design.  G (dh x dh fp32, 576 KiB at dh = 384) separates by value
// columns, as C does in the forward: one block per (batch row, head, tile
// of 32 value columns) walks the chunks from the last, holding its
// columns of G in shared memory.  dv is the tile's own; dq, dk and the gate
// sums take every column, so each tile writes fp32 partials and a second
// kernel adds them over the tiles in a fixed order, rounds dq and dk to
// q's type and takes the reverse cumulative sum of dF: no atomics, so two
// calls give the same bits.  What couples the columns within a chunk (the
// scores, q.n, the floor, dh.h) is recomputed by every tile; the terms of
// n's cotangent g (dd_i, g, <g, n>) are added by tile 0 alone.  A chunk's
// products run on CUDA cores in fp32 (the fp32 train step must equal the
// CPU's to 1e-4; bf16 and fp16 q/k/v are read exactly), a warp a row of
// G at a time with its lanes as rows i, columns j or value columns e.
// Bound: at the train shape, the bytes of the chunk states at bf16 (75 MB
// a layer at 8 x 128 x 4 heads of 384) and the operations at fp32 (per
// step the four dh x dh state products, plus five causal intra-chunk
// products of dh per key); this first version is far from either: one
// block an SM (177 KB of shared memory at dh = 384), 8 warps whose serial
// FMA chains wait on shared loads and shuffles.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"
#include "mma.cuh"

namespace {

constexpr int kL = 32;                     // steps a chunk, the forward's
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTE = 32;                    // value columns a block
constexpr int kS = kTE + 1;                // row stride of the 32-wide tiles
constexpr int kRowVals = 11;               // per-row values (below)
static_assert(kL == 32 && kTE == 32, "a warp's lanes index rows and columns");

struct BwdParams {
  const void* q;        // (B,S,H,dh) at T
  const void* k;
  const void* v;
  const float* ig;      // (B,S,H) input-gate pre-activations
  const float* lf;      // (B,S,H) log forget gates
  const float* Cst;     // (B,H,NC,dh,dh) state at each chunk's start
  const float* nst;     // (B,H,NC,dh)
  const float* mst;     // (B,H,NC)
  const float* h;       // (B,S,H,dh) the forward's output
  const float* dh_;     // (B,S,H,dh) its cotangent
  void* dq;             // (B,S,H,dh) at T
  void* dk;
  void* dv;
  float* di;            // (B,S,H)
  float* dlogf;         // (B,S,H)
  float* dq_part;       // (ntiles, B*H, dh, S) partial sums of dq
  float* dk_part;       // the same for dk
  float* di_part;       // (ntiles, B*H, S) partial sums of di
  float* dF_part;       // the same for dF (before the cumulative sum)
  int B, S, H, dh, ntiles;
};

// the row stride of the q and k rows: odd, so that lanes reading one
// column of 32 rows hit 32 banks
__host__ __device__ inline int row_stride(int dh) { return dh | 1; }

__host__ __device__ inline size_t chunk_smem_floats(int dh) {
  // q, k rows; G's columns; n and g; v, dN, qk, w, dS tiles; per-row
  // values; the warps' partial sums (di's and dF's state parts, <G, C>
  // and <g, n>)
  return 2 * (size_t)kL * row_stride(dh) + (size_t)dh * kS + 2 * (size_t)dh +
         5 * (size_t)kL * kS + (size_t)kRowVals * kL +
         2 * (size_t)kWarps * kL + 2 * (size_t)kWarps;
}

__host__ __device__ inline size_t reduce_smem_floats(int dh) {
  return (size_t)kL * row_stride(dh);
}

// grid (B * H, ntiles): block (bh, t) owns value columns [32 t, 32 t + 32)
// of G and dv and walks the chunks from the last.
template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_chunk_kernel(BwdParams p) {
  extern __shared__ float smem[];
  __shared__ float s_decay;
  const int dh = p.dh, ld = row_stride(dh);
  const int bh = blockIdx.x, b = bh / p.H, hh = bh % p.H;
  const int tile = blockIdx.y, e0 = tile * kTE, te = min(kTE, dh - e0);
  const bool t0 = tile == 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NC = (p.S + kL - 1) / kL, BH = p.B * p.H;
  float* qs = smem;                        // [L][ld]
  float* ks = qs + kL * ld;                // [L][ld]
  float* G = ks + kL * ld;                 // [dh][kS] G[d][e]
  float* ns = G + (size_t)dh * kS;         // [dh] n of the chunk
  float* gn = ns + dh;                     // [dh] g
  float* vs = gn + dh;                     // [L][kS] v_j[e]
  float* dN = vs + kL * kS;                // [L][kS] dh_i[e], then / r_i
  float* QK = dN + kL * kS;                // [L][kS] raw scores q_i.k_j
  float* W = QK + kL * kS;                 // [L][kS] w_ij (0 for j > i)
  float* dS = W + kL * kS;                 // [L][kS]
  float* Fs = dS + kL * kS;                // cumulative log forget
  float* is = Fs + kL;                     // input pre-activations
  float* mi_s = is + kL;                   // row stabilisers m_i
  float* sw = mi_s + kL;                   // state weights
  float* wk = sw + kL;                     // key weights to the chunk's end
  float* rr = wk + kL;                     // floors r_i
  float* dd = rr + kL;                     // dDen_i (scaled)
  float* delta = dd + kL;                  // dh_i . h_i
  float* qn = delta + kL;                  // q_i . n
  float* rsum = qn + kL;                   // row sums of dS qk
  float* csum = rsum + kL;                 // column sums of dS qk
  float* red_lb = csum + kL;               // [warps][L] q_i.(dq state part)
  float* red_lw = red_lb + kWarps * kL;    // [warps][L] k_j.(dk state part)
  float* red_gc = red_lw + kWarps * kL;    // [warps] <G, C>
  float* red_gg = red_gc + kWarps;         // [warps] <g, n>
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* dv = static_cast<T*>(p.dv);

  for (int i = tid; i < dh * kS; i += kThreads) G[i] = 0.f;
  for (int d = tid; d < dh; d += kThreads) gn[d] = 0.f;

  for (int c = NC - 1; c >= 0; --c) {
    const int c0 = c * kL, Lc = min(kL, p.S - c0);
    const long row0 = ((long)b * p.S + c0) * p.H + hh;   // (b, c0, h)
    const long cs = (long)bh * NC + c;                   // state index

    // the chunk's q, k rows, this tile's v and dh columns (zeros past the
    // chunk and the tile), n, dh.h a warp a row, and the gates
    for (int x = tid; x < kL * dh; x += kThreads) {
      const int t = x / dh, d = x % dh;
      float qv = 0.f, kv = 0.f;
      if (t < Lc) {
        const long src = (row0 + (long)t * p.H) * dh + d;
        qv = to_f(q[src]);
        kv = to_f(k[src]);
      }
      qs[t * ld + d] = qv;
      ks[t * ld + d] = kv;
    }
    for (int x = tid; x < kL * kTE; x += kThreads) {
      const int t = x / kTE, e = x % kTE;
      float vv = 0.f, gv = 0.f;
      if (t < Lc && e < te) {
        const long src = (row0 + (long)t * p.H) * dh + e0 + e;
        vv = to_f(v[src]);
        gv = p.dh_[src];
      }
      vs[t * kS + e] = vv;
      dN[t * kS + e] = gv;
    }
    for (int d = tid; d < dh; d += kThreads) ns[d] = p.nst[cs * dh + d];
    for (int r = warp; r < kL; r += kWarps) {
      float a = 0.f;
      if (r < Lc) {
        const long base = (row0 + (long)r * p.H) * dh;
        for (int d = lane; d < dh; d += 32)
          a = fmaf(p.dh_[base + d], p.h[base + d], a);
      }
      a = warp_sum(a);
      if (lane == 0) delta[r] = a;
    }
    if (warp == kWarps - 1) {
      // F (a scan), m_i = max(max_{j<=i} F_i - F_j + i_j, F_i + m_prev),
      // the state weights, the key weights, m_new and the decay, as the
      // forward's CUDA-core body computes them
      float f = lane < Lc ? p.lf[row0 + (long)lane * p.H] : 0.f;
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(~0u, f, o);
        if (lane >= o) f += up;
      }
      const float ig = lane < Lc ? p.ig[row0 + (long)lane * p.H] : 0.f;
      Fs[lane] = f;
      is[lane] = ig;
      __syncwarp();
      const float mp = p.mst[cs], Ftot = __shfl_sync(~0u, f, Lc - 1);
      float mi = -INFINITY;
      if (lane < Lc)
        for (int j = 0; j <= lane; ++j) mi = fmaxf(mi, f - Fs[j] + is[j]);
      const float lst = f + mp;
      mi = fmaxf(mi, lst);
      if (!isfinite(mi)) mi = 0.f;
      mi_s[lane] = mi;
      sw[lane] = lane < Lc ? expf(lst - mi) : 0.f;
      const float t = lane < Lc ? Ftot - f + ig : -INFINITY;
      const float mn = fmaxf(mp + Ftot, warp_max(t));
      wk[lane] = lane < Lc ? expf(t - mn) : 0.f;
      if (lane == 0) s_decay = expf(mp + Ftot - mn);
    }
    __syncthreads();

    // raw scores and their weights (0 above the diagonal and past the
    // chunk), q.n a warp a row
    for (int x = tid; x < kL * kL; x += kThreads) {
      const int i = x / kL, j = x % kL;
      float s = 0.f, w = 0.f;
      if (i < Lc && j <= i) {
        const float* qr = qs + i * ld;
        const float* kr = ks + j * ld;
        for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kr[d], s);
        w = expf(Fs[i] - Fs[j] + is[j] - mi_s[i]);
      }
      QK[i * kS + j] = s;
      W[i * kS + j] = w;
    }
    for (int r = warp; r < kL; r += kWarps) {
      float a = 0.f;
      for (int d = lane; d < dh; d += 32) a = fmaf(qs[r * ld + d], ns[d], a);
      a = warp_sum(a);
      if (lane == 0) qn[r] = a;
    }
    __syncthreads();

    // denominators, floors and dDen, a warp a row
    for (int r = warp; r < kL; r += kWarps) {
      const float den =
          warp_sum(QK[r * kS + lane] * W[r * kS + lane]) + sw[r] * qn[r];
      if (lane == 0) {
        const float fl = expf(-mi_s[r]);
        const float rv = fmaxf(fabsf(den), fl);
        rr[r] = rv;
        dd[r] = r < Lc && fabsf(den) > fl
                    ? -copysignf(1.f, den) * delta[r] / rv : 0.f;
      }
    }
    __syncthreads();
    for (int x = tid; x < kL * kTE; x += kThreads) {
      const int i = x / kTE, e = x % kTE;
      dN[i * kS + e] /= rr[i];
    }
    __syncthreads();

    // dS_ij = (dN_i.v_j over the tile's columns [+ dd_i in tile 0]) w_ij
    for (int x = tid; x < kL * kL; x += kThreads) {
      const int i = x / kL, j = x % kL;
      float a = 0.f;
#pragma unroll 8
      for (int e = 0; e < kTE; ++e) a = fmaf(dN[i * kS + e], vs[j * kS + e], a);
      if (t0) a += dd[i];
      dS[i * kS + j] = a * W[i * kS + j];
    }
    __syncthreads();
    // row and column sums of dS qk (the log weights' cotangents)
    for (int r = warp; r < kL; r += kWarps) {
      const float a = warp_sum(dS[r * kS + lane] * QK[r * kS + lane]);
      if (lane == 0) rsum[r] = a;
    }
    if (warp == 0) {
      float a = 0.f;
      for (int i = 0; i < kL; ++i) a = fmaf(dS[i * kS + lane], QK[i * kS + lane], a);
      csum[lane] = a;
    }

    // dv_j[e] = sum_i qk_ij w_ij dN_i[e] + wk_j sum_d G[d][e] k_j[d]: lane
    // e, rows j = warp, warp + 8, ... (G as the next chunk left it)
    {
      float acc[kL / kWarps];
#pragma unroll
      for (int u = 0; u < kL / kWarps; ++u) acc[u] = 0.f;
      for (int d = 0; d < dh; ++d) {
        const float g = G[d * kS + lane];
#pragma unroll
        for (int u = 0; u < kL / kWarps; ++u)
          acc[u] = fmaf(g, ks[(warp + u * kWarps) * ld + d], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < kL / kWarps; ++u) {
        const int j = warp + u * kWarps;
        float a = 0.f;
        for (int i = j; i < kL; ++i)
          a = fmaf(QK[i * kS + j] * W[i * kS + j], dN[i * kS + lane], a);
        a = fmaf(wk[j], acc[u], a);
        if (j < Lc && lane < te)
          dv[(row0 + (long)j * p.H) * dh + e0 + lane] = from_f<T>(a);
      }
    }
    __syncthreads();             // every read of G before its update

    // a warp a row d of G at a time: dq (lane = row i) and dk (lane =
    // column j) partials over the tile, their log-weight sums, <G, C>,
    // <g, n>, then G's row (lane = column e) and g's entry for the next
    // chunk back
    {
      const float dc = s_decay;
      const float my_sw = sw[lane], my_wk = wk[lane], my_dd = dd[lane];
      const float* Cc = p.Cst + cs * dh * dh;
      const long pbase = ((long)tile * BH + bh) * dh;
      float lb = 0.f, lw = 0.f, gc = 0.f, gg = 0.f;
      for (int d = warp; d < dh; d += kWarps) {
        const float cde = lane < te ? Cc[(long)d * dh + e0 + lane] : 0.f;
        const float gde = G[d * kS + lane];
        const float nd = ns[d], gnd = gn[d];
        const float qd = qs[lane * ld + d], kd = ks[lane * ld + d];
        gc = fmaf(gde, cde, gc);
        // dq_i[d]: sum_j dS_ij k_j[d] + sw_i (sum_e C[d][e] dN_i[e]
        // [+ dd_i n[d]])
        float st = 0.f, a = 0.f;
#pragma unroll
        for (int e = 0; e < kTE; ++e)
          st = fmaf(__shfl_sync(~0u, cde, e), dN[lane * kS + e], st);
        if (t0) st = fmaf(my_dd, nd, st);
        st *= my_sw;
#pragma unroll 8
        for (int j = 0; j < kL; ++j) a = fmaf(dS[lane * kS + j], ks[j * ld + d], a);
        lb = fmaf(qd, st, lb);
        if (lane < Lc) p.dq_part[(pbase + d) * p.S + c0 + lane] = a + st;
        // dk_j[d]: sum_i dS_ij q_i[d] + wk_j (sum_e G[d][e] v_j[e] [+ g[d]])
        float sk = 0.f, bk = 0.f;
#pragma unroll
        for (int e = 0; e < kTE; ++e)
          sk = fmaf(__shfl_sync(~0u, gde, e), vs[lane * kS + e], sk);
        if (t0) sk += gnd;
        sk *= my_wk;
#pragma unroll 8
        for (int i = 0; i < kL; ++i) bk = fmaf(dS[i * kS + lane], qs[i * ld + d], bk);
        lw = fmaf(kd, sk, lw);
        if (lane < Lc) p.dk_part[(pbase + d) * p.S + c0 + lane] = bk + sk;
        // G[d][e] = decay G[d][e] + sum_i sw_i q_i[d] dN_i[e]
        const float sq = my_sw * qd;
        float gnew = dc * gde;
#pragma unroll
        for (int i = 0; i < kL; ++i)
          gnew = fmaf(__shfl_sync(~0u, sq, i), dN[i * kS + lane], gnew);
        G[d * kS + lane] = gnew;
        if (t0) {
          // g[d] = decay g[d] + sum_i sw_i dd_i q_i[d]
          const float gs = warp_sum(sq * my_dd);
          if (lane == 0) {
            gg = fmaf(gnd, nd, gg);
            gn[d] = fmaf(dc, gnd, gs);
          }
        }
      }
      red_lb[warp * kL + lane] = lb;
      red_lw[warp * kL + lane] = lw;
      gc = warp_sum(gc);
      if (lane == 0) {
        red_gc[warp] = gc;
        red_gg[warp] = gg;
      }
    }
    __syncthreads();

    // the gates' partial sums for these steps (warp 0, lane = step)
    if (warp == 0) {
      float lb = 0.f, lw = 0.f, gcs = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        lb += red_lb[w * kL + lane];
        lw += red_lw[w * kL + lane];
        gcs += red_gc[w] + red_gg[w];
      }
      const float di = csum[lane] + lw;
      float dF = rsum[lane] + lb - di;
      const float lw_all = warp_sum(lw);
      if (lane == Lc - 1) dF += lw_all + s_decay * gcs;
      if (lane < Lc) {
        const long o = ((long)tile * BH + bh) * p.S + c0 + lane;
        p.di_part[o] = di;
        p.dF_part[o] = dF;
      }
    }
    __syncthreads();             // before the next chunk's loads
  }
}

// grid (B * H, NC): block (bh, c) adds the tiles' partials of chunk c in
// tile order: dq and dk rounded to T through a transposing tile, di, and
// dlogf as the reverse cumulative sum of dF over the chunk (warp 0).
template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_bwd_reduce_kernel(BwdParams p) {
  extern __shared__ float tl[];            // [L][ld]
  const int dh = p.dh, ld = row_stride(dh);
  const int bh = blockIdx.x, b = bh / p.H, hh = bh % p.H;
  const int c0 = blockIdx.y * kL, Lc = min(kL, p.S - c0);
  const int BH = p.B * p.H, tid = threadIdx.x;
  const long row0 = ((long)b * p.S + c0) * p.H + hh;
  for (int which = 0; which < 2; ++which) {
    const float* part = which ? p.dk_part : p.dq_part;
    T* out = static_cast<T*>(which ? p.dk : p.dq);
    for (int x = tid; x < kL * dh; x += kThreads) {
      const int i = x % kL, d = x / kL;
      if (i < Lc) {
        float a = 0.f;
        for (int t = 0; t < p.ntiles; ++t)
          a += part[(((long)t * BH + bh) * dh + d) * p.S + c0 + i];
        tl[i * ld + d] = a;
      }
    }
    __syncthreads();
    for (int x = tid; x < Lc * dh; x += kThreads) {
      const int i = x / dh, d = x % dh;
      out[(row0 + (long)i * p.H) * dh + d] = from_f<T>(tl[i * ld + d]);
    }
    __syncthreads();
  }
  if (tid < 32) {
    const int lane = tid;
    float di = 0.f, dF = 0.f;
    if (lane < Lc) {
      for (int t = 0; t < p.ntiles; ++t) {
        const long o = ((long)t * BH + bh) * p.S + c0 + lane;
        di += p.di_part[o];
        dF += p.dF_part[o];
      }
    }
    for (int o = 1; o < 32; o <<= 1) {
      const float dn = __shfl_down_sync(~0u, dF, o);
      if (lane + o < 32) dF += dn;
    }
    if (lane < Lc) {
      p.di[row0 + (long)lane * p.H] = di;
      p.dlogf[row0 + (long)lane * p.H] = dF;
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = chunk_smem_floats(p.dh) * sizeof(float);
  cudaError_t e = opt_in_smem((const void*)mlstm_bwd_chunk_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  mlstm_bwd_chunk_kernel<T>
      <<<dim3(p.B * p.H, p.ntiles), kThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem2 = reduce_smem_floats(p.dh) * sizeof(float);
  e = opt_in_smem((const void*)mlstm_bwd_reduce_kernel<T>, smem2);
  if (e != cudaSuccess) return e;
  mlstm_bwd_reduce_kernel<T>
      <<<dim3(p.B * p.H, (p.S + kL - 1) / kL), kThreads, smem2, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype of q, k, v (and of dq, dk, dv): 0 = float32, 1 = float16,
// 2 = bfloat16; everything else fp32.  The partial buffers hold
// ntiles = ceil(dh / 32) tiles: dq_part / dk_part (ntiles, B*H, dh, S),
// di_part / dF_part (ntiles, B*H, S).  Two launches on ``stream`` (the
// chunk walk, then the ordered sums); returns cudaGetLastError() after
// them.
extern "C" int mlstm_chunk_bwd_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* lf, const void* Cst, const void* nst, const void* mst,
    const void* h, const void* dh_, void* dq, void* dk, void* dv, void* di,
    void* dlogf, void* dq_part, void* dk_part, void* di_part, void* dF_part,
    int dtype, int B, int S, int H, int dh, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dh < 1) return (int)cudaErrorInvalidValue;
  BwdParams p{q, k, v, static_cast<const float*>(ig),
              static_cast<const float*>(lf), static_cast<const float*>(Cst),
              static_cast<const float*>(nst), static_cast<const float*>(mst),
              static_cast<const float*>(h), static_cast<const float*>(dh_),
              dq, dk, dv, static_cast<float*>(di),
              static_cast<float*>(dlogf), static_cast<float*>(dq_part),
              static_cast<float*>(dk_part), static_cast<float*>(di_part),
              static_cast<float*>(dF_part), B, S, H, dh,
              (dh + kTE - 1) / kTE};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_bwd<float>(p, s);
    case 1: return (int)launch_bwd<__half>(p, s);
    case 2: return (int)launch_bwd<__nv_bfloat16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared-memory bytes of the chunk walk at head dim dh (the
// larger of the two kernels').
extern "C" long mlstm_chunk_bwd_smem_bytes(int dh) {
  return (long)(chunk_smem_floats(dh) * sizeof(float));
}
