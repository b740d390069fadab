// The backward of the chunkwise mLSTM (mlstm_chunk.cu) for Hopper (sm_90a),
// bound to PyTorch through a plain C interface (ctypes); see
// repro_torch/kernels/mlstm_chunk.py (mlstm_chunked_bwd, mlstm_bwd_plan)
// and its plain version repro_torch/kernels/ref.py (mlstm_chunked_bwd_ref).
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
// qk_ij = q_i.k_j, w_ij = e^{F_i - F_j + i_j - m_i} (j <= i), P = qk o w,
// the state weights sw_i = e^{F_i + m_prev - m_i}, the key weights wk_j =
// e^{F_L - F_j + i_j - m_new}, decay = e^{m_prev + F_L - m_new}, the
// floor r_i = max(|den_i|, e^{-m_i}) and the cotangents (G, g) of the
// carried (C, n) at the chunk's end (scaled by e^{m_new}; zero after the
// last chunk):
//   dN_i  = dh_i / r_i,  dd_i = -sign(den_i) (dh_i.h_i) / r_i if |den_i|
//           passes the floor, else 0
//   dS_ij = (dN_i.v_j + dd_i) w_ij
//   dq_i  = sum_j dS_ij k_j + sw_i (C dN_i + dd_i n)
//   dk_j  = sum_i dS_ij q_i + wk_j (G v_j + g)
//   dv_j  = sum_i P_ij dN_i + wk_j G^T k_j
//   di_j  = sum_i dS_ij qk_ij + k_j.(dk_j's state part)
//   dF_i  = sum_j dS_ij qk_ij + q_i.(dq_i's state part) - di_i, and the
//           chunk's last step adds sum_j k_j.(state part) + decay (<G, C>
//           + <g, n>); dlogf is dF's reverse cumulative sum in the chunk
//   G     <- sum_i sw_i q_i dN_i^T + decay G,  g <- sum_i sw_i dd_i q_i
//           + decay g
// (the derivation is in ref.mlstm_chunked_bwd_ref's docstring).
//
// Bound: the bytes of the chunk states at bf16 (75.5 MB a layer at
// xlstm-125m's 8 x 128, 4 heads of 384), the operations at fp32 (per step
// the four dh x dh state products, plus five causal intra-chunk products
// of dh per key).
//
// Design.  Only (G, g) crosses chunks, and it is a linear recurrence with
// one scalar decay per (row, head, chunk), so no block walks the chunks:
//  1. mlstm_bwd_dq_kernel, one block per (chunk, row and head), all of dh:
//     the gates' scalars, the scores Q K^T, dh V^T, the floors, dS, P; the
//     chunk-local dS^T Q and P^T dN (to fp32 scratch); dq whole (dS K +
//     sw (dN C^T + dd n), C read once); the chunk's increments dG = Q^T
//     (sw dN) and dg into a (D, D + 1) slab per chunk; per row a_i =
//     sum_j dS_ij qk_ij + q_i.(dq_i's state part), wk and the column sums.
//  2. mlstm_bwd_scan_kernel: the reverse scan G_end(c-1) = dG_c + decay_c
//     G_end(c) over the slabs, in place, element by element (bandwidth).
//  3. mlstm_bwd_dkdv_kernel, one block per (chunk, row and head): dk = dS^T
//     Q + wk (V G^T + g) and dv = P^T dN + wk K G, G read by half the
//     warps along its rows and by the other half along its columns (the
//     second read mostly from L2); di.
//  4. mlstm_bwd_dlogf_kernel: dlogf.  The decay's term needs no product of
//     G with C: since C_{c+1} = decay_c C_c + sum_j wk_j k_j v_j^T and
//     <dG_c, C_c> + <dg_c, n_c> = sum_i q_i.(dq_i's state part) =: lb(c),
//     decay_c (<G_c, C_c> + <g_c, n_c>) + lw(c) = sum_{c' > c} (lb(c') -
//     lw(c')), with lw(c) = sum_j k_j.(dk_j's state part).  So dlogf is the
//     chunk's reverse cumulative sum of a_i - di_i plus a running sum over
//     the later chunks, one warp per (row, head).
// Every product runs on the tensor cores (mma.sync.m16n8k16, fp32
// accumulators).  Each operand is held as it is (q/k/v at their type, the
// rest fp32) and cut into bf16 parts when its fragment is loaded: a part
// is the bf16 rounding of what the parts before it left, and of the part
// pairs only those whose indices sum below the larger count are
// multiplied (Parts: bf16 q/k/v 1 part, the fp32 operands 2; fp16 2 and
// 2; fp32 3 and 3, which holds the plain fp32 backward to 1e-4).  A
// block's warps own whole output tiles, so every sum over blocks is taken
// in a fixed order and no atomics are used: two calls give the same bits.
// Blocks run 16 warps; the state matrices C and G stream from device
// memory straight into fragments (full 32-byte sectors), one k-step ahead.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"
#include "mma.cuh"

namespace {

constexpr int kL = 32;                     // steps a chunk, the forward's
constexpr int kThreads = 512;              // the chunk passes' blocks
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 256;
constexpr int kTileLd = kL + 8;            // row stride of the 32 x 32 tiles
constexpr int kGroup = 3;                  // n-tiles a warp carries at once
constexpr int kMaxDim = kGroup * kWarps * 8;   // 384: dq's n-tiles a warp
constexpr int kRows = 12;                  // per-row arrays of pass 1
constexpr int kMaxSmem = 232448;           // a Hopper block's opt-in limit
static_assert(kL == 32, "a warp's lanes index a chunk's steps");

// bf16 parts of q/k/v (kT), of the chunk-local fp32 operands dh, P / r and
// dS (kI), and of the state products' fp32 operands sw dN / r, C and G (kS)
template <typename T> struct Parts;
template <> struct Parts<__nv_bfloat16> {
  static constexpr int kT = 1, kI = 2, kS = 2;
};
template <> struct Parts<__half> {
  static constexpr int kT = 2, kI = 2, kS = 2;
};
template <> struct Parts<float> {
  static constexpr int kT = 3, kI = 3, kS = 3;
};

struct BwdParams {
  const void* q;        // (B,S,H,D) at T
  const void* k;
  const void* v;
  const float* ig;      // (B,S,H) input-gate pre-activations
  const float* lf;      // (B,S,H) log forget gates
  const float* Cst;     // (B,H,NC,D,D) state at each chunk's start
  const float* nst;     // (B,H,NC,D)
  const float* mst;     // (B,H,NC)
  const float* h;       // (B,S,H,D) the forward's output
  const float* dh_;     // (B,S,H,D) its cotangent
  void* dq;             // (B,S,H,D) at T
  void* dk;
  void* dv;
  float* di;            // (B,S,H)
  float* dlogf;         // (B,S,H); a_i until the last pass
  float* X;             // (B*H*NC, D*(D+1)): (dG, dg), then (G, g) at the
                        //   chunk's end
  float* dk_part;       // (B,S,H,D) dS^T Q
  float* dv_part;       // (B,S,H,D) P^T dN
  float* wk;            // (B,S,H) key weights
  float* csum;          // (B,S,H) column sums of dS o qk
  float* decay;         // (B*H*NC)
  float* lb;            // (B*H*NC) sum_i q_i.(dq_i's state part)
  float* lw;            // (B*H*NC) sum_j k_j.(dk_j's state part)
  int B, S, H, D, NC;
};

// Shared-memory layout of the chunk passes at head dim D and q/k/v of
// tbytes bytes (byte offsets, every region 16-byte aligned; rows padded to
// Dp, a multiple of 16, plus 8 elements).  Pass 1: Q, K, V at T, dh (fp32,
// scaled in place to sw dN / r), the raw scores, P / r and dS (32 x 40
// fp32), n, the per-row values, the warps' row sums and the decay.  Pass
// 3: K, V, g, wk and the column sums, the warps' row sums.
struct BwdSmem {
  int Dp, ld;
  int q, k, v, dh, s, pp, ds, n, rows, red, total1;
  int k3, v3, g3, rows3, red3, total3;
  __host__ __device__ BwdSmem(int D, int tbytes) {
    Dp = (D + 15) & ~15;
    ld = Dp + 8;
    const int rowT = kL * ld * tbytes, rowF = kL * ld * 4;
    const int tile = kL * kTileLd * 4;
    q = 0;
    k = q + rowT;
    v = k + rowT;
    dh = v + rowT;
    s = dh + rowF;
    pp = s + tile;
    ds = pp + tile;
    n = ds + tile;
    rows = n + Dp * 4;
    red = rows + kRows * kL * 4;
    total1 = red + kWarps * kL * 4 + 16;
    k3 = 0;
    v3 = k3 + rowT;
    g3 = v3 + rowT;
    rows3 = g3 + Dp * 4;
    red3 = rows3 + 2 * kL * 4;
    total3 = red3 + kWarps * kL * 4;
  }
};

// ---------------------------------------------------------------------------
// State fragments from device memory (the rest of the fragments and
// mma_parts are in mma.cuh)
// ---------------------------------------------------------------------------

// The raw values of a B fragment of a D x D fp32 state matrix M (row stride
// D) in device memory, zeros past D: kNK, Y[k][n] = M[n][k] (a float2 per
// value pair); else Y[k][n] = M[k][n]
template <bool kNK>
__device__ __forceinline__ void fetch_b(float2 (&r)[2], const float* M,
                                        int D, int k0, int n0, bool live) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int n = n0 + gid;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int k = k0 + 2 * tig + x * 8;
    float2 f = make_float2(0.f, 0.f);
    if (live && n < D && k < D)
      f = kNK ? *reinterpret_cast<const float2*>(M + (long)n * D + k)
              : make_float2(M[(long)k * D + n], M[(long)(k + 1) * D + n]);
    r[x] = f;
  }
}

template <int P>
__device__ __forceinline__ void split_b(uint32_t (&b)[P][2],
                                        const float2 (&r)[2]) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    uint32_t s[P];
    split_bf16<P>(r[x].x, r[x].y, s);
#pragma unroll
    for (int pp = 0; pp < P; ++pp) b[pp][x] = s[pp];
  }
}

// acc[u][mt] += A (32 rows x Dp, row-major in shared memory, PA parts) times
// B, a state matrix M read from device memory (PB parts), for the warp's
// n-tiles nt[u] (live[u]), over all Dp / 16 k-steps; the next k-step's B
// values are in flight while this one's products run
template <int PA, int PB, bool kNK, typename E>
__device__ __forceinline__ void state_product(float (&acc)[kGroup][2][4],
                                              const E* As, int ld,
                                              const float* M, int D, int Dp,
                                              const int (&nt)[kGroup],
                                              const bool (&live)[kGroup]) {
  float2 cur[kGroup][2], nxt[kGroup][2];
#pragma unroll
#pragma unroll
  for (int u = 0; u < kGroup; ++u)
    fetch_b<kNK>(cur[u], M, D, 0, nt[u] * 8, live[u]);
  const int steps = Dp / 16;
  for (int ks = 0; ks < steps; ++ks) {
    if (ks + 1 < steps) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        fetch_b<kNK>(nxt[u], M, D, (ks + 1) * 16, nt[u] * 8, live[u]);
    }
    uint32_t a[2][PA][4];
    load_a<PA, true>(a[0], As, ld, 0, ks * 16);
    load_a<PA, true>(a[1], As, ld, 16, ks * 16);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (live[u]) {
        uint32_t b[PB][2];
        split_b<PB>(b, cur[u]);
        mma_parts<PA, PB>(acc[u][0], a[0], b);
        mma_parts<PA, PB>(acc[u][1], a[1], b);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      cur[u][0] = nxt[u][0];
      cur[u][1] = nxt[u][1];
    }
  }
}

// the sum over a quad's four lanes (the columns of an accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(~0u, v, 1);
  return v + __shfl_xor_sync(~0u, v, 2);
}

// request the chunk's rows of x (T, D wide, zeros past Lc and D) into
// dst[t * ld + col]
template <typename E>
__device__ __forceinline__ void issue_rows(E* dst, const E* x, long row0,
                                           int H, int D, int Dp, int ld,
                                           int Lc) {
  constexpr int per = 16 / sizeof(E);
  const int chunks = Dp / per;
  for (int i = threadIdx.x; i < kL * chunks; i += blockDim.x) {
    const int t = i / chunks, col = i % chunks * per;
    const bool ok = t < Lc && col < D;
    const long src = ok ? (row0 + (long)t * H) * D + col : 0;
    cp_async16(dst + t * ld + col, x + src, ok);
  }
}

// ---------------------------------------------------------------------------
// Pass 1: per chunk, the score side, dq, and the chunk's increments
// ---------------------------------------------------------------------------

// grid (NC, B * H): block (c, bh) takes chunk c of row b, head h, all of D
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_bwd_dq_kernel(BwdParams p) {
  constexpr int PT = Parts<T>::kT, PI = Parts<T>::kI, PS = Parts<T>::kS;
  extern __shared__ __align__(16) char sm[];
  const BwdSmem Ls(p.D, sizeof(T));
  const int D = p.D, Dp = Ls.Dp, ld = Ls.ld, NC = p.NC;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / p.H, hh = bh % p.H;
  const int c0 = c * kL, Lc = min(kL, p.S - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long row0 = ((long)b * p.S + c0) * p.H + hh;   // (b, c0, h)
  const long cs = (long)bh * NC + c;                   // chunk index
  T* Qs = reinterpret_cast<T*>(sm + Ls.q);
  T* Ks = reinterpret_cast<T*>(sm + Ls.k);
  T* Vs = reinterpret_cast<T*>(sm + Ls.v);
  float* dN = reinterpret_cast<float*>(sm + Ls.dh);    // dh, then sw dh / r
  float* Sx = reinterpret_cast<float*>(sm + Ls.s);     // raw scores
  float* Pp = reinterpret_cast<float*>(sm + Ls.pp);    // P_ij / r_i
  float* dS = reinterpret_cast<float*>(sm + Ls.ds);    // dh V^T, then dS
  float* ns = reinterpret_cast<float*>(sm + Ls.n);
  float* Fs = reinterpret_cast<float*>(sm + Ls.rows);  // cumulative log f
  float* is = Fs + kL;                     // input pre-activations
  float* mis = is + kL;                    // row stabilisers m_i
  float* sw = mis + kL;                    // state weights
  float* wk = sw + kL;                     // key weights
  float* rr = wk + kL;                     // floors r_i
  float* dd = rr + kL;                     // dDen_i
  float* delta = dd + kL;                  // dh_i . h_i
  float* qn = delta + kL;                  // q_i . n
  float* rsum = qn + kL;                   // row sums of dS o qk
  float* csum = rsum + kL;                 // column sums of dS o qk
  float* fac = csum + kL;                  // sw_i / r_i
  float* red = reinterpret_cast<float*>(sm + Ls.red);  // [warps][L]
  float* scal = red + kWarps * kL;         // decay
  float* Xs = p.X + cs * (long)D * (D + 1);

  issue_rows(Qs, static_cast<const T*>(p.q), row0, p.H, D, Dp, ld, Lc);
  issue_rows(Ks, static_cast<const T*>(p.k), row0, p.H, D, Dp, ld, Lc);
  issue_rows(Vs, static_cast<const T*>(p.v), row0, p.H, D, Dp, ld, Lc);
  issue_rows(dN, p.dh_, row0, p.H, D, Dp, ld, Lc);
  cp_async_commit();
  for (int d = tid; d < Dp; d += kThreads)
    ns[d] = d < D ? p.nst[cs * D + d] : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // raw scores Q K^T (warps 0-7) and dh V^T (warps 8-15), a 16 x 8 tile a
  // warp; then q.n and dh.h a warp a row; the gates in the last warp
  {
    const int mt = (warp >> 2) & 1, jt = warp & 3;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = 0; ks < Dp / 16; ++ks) {
      if (warp < kWarps / 2) {
        uint32_t a[PT][4], bb[PT][2];
        load_a<PT, true>(a, Qs, ld, mt * 16, ks * 16);
        load_b<PT, true>(bb, Ks, ld, ks * 16, jt * 8);
        mma_parts<PT, PT>(acc, a, bb);
      } else {
        uint32_t a[PI][4], bb[PT][2];
        load_a<PI, true>(a, dN, ld, mt * 16, ks * 16);
        load_b<PT, true>(bb, Vs, ld, ks * 16, jt * 8);
        mma_parts<PI, PT>(acc, a, bb);
      }
    }
    float* out = warp < kWarps / 2 ? Sx : dS;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(out + (mt * 16 + gid + hf * 8) * kTileLd +
                                 jt * 8 + 2 * tig) =
          make_float2(acc[2 * hf], acc[2 * hf + 1]);
  }
  for (int r = warp; r < kL; r += kWarps) {
    float a = 0.f, dl = 0.f;
    if (r < Lc) {
      const long base = (row0 + (long)r * p.H) * D;
      for (int d = lane; d < D; d += 32) {
        a = fmaf(to_f(Qs[r * ld + d]), ns[d], a);
        dl = fmaf(dN[r * ld + d], p.h[base + d], dl);
      }
    }
    a = warp_sum(a);
    dl = warp_sum(dl);
    if (lane == 0) {
      qn[r] = a;
      delta[r] = dl;
    }
  }
  if (warp == kWarps - 1) {
    // F (a scan), m_i = max(max_{j<=i} F_i - F_j + i_j, F_i + m_prev),
    // the state weights, the key weights, m_new and the decay
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
    mis[lane] = mi;
    sw[lane] = lane < Lc ? expf(lst - mi) : 0.f;
    const float t = lane < Lc ? Ftot - f + ig : -INFINITY;
    const float mn = fmaxf(mp + Ftot, warp_max(t));
    wk[lane] = lane < Lc ? expf(t - mn) : 0.f;
    if (lane == 0) scal[0] = expf(mp + Ftot - mn);
  }
  __syncthreads();

  // a warp a row: weights, P, the denominator, the floor, dDen, P / r, dS
  // and its row sum with the raw scores (lane = column j)
  for (int i = warp; i < kL; i += kWarps) {
    const int j = lane;
    const float wv =
        i < Lc && j <= i ? expf(Fs[i] - Fs[j] + is[j] - mis[i]) : 0.f;
    const float s = Sx[i * kTileLd + j], pv = s * wv;
    const float den = warp_sum(pv) + sw[i] * qn[i];
    const float fl = expf(-mis[i]);
    const float rv = fmaxf(fabsf(den), fl);
    const float ddv = i < Lc && fabsf(den) > fl
                          ? -copysignf(1.f, den) * delta[i] / rv : 0.f;
    const float dsv = (dS[i * kTileLd + j] / rv + ddv) * wv;
    Pp[i * kTileLd + j] = pv / rv;
    dS[i * kTileLd + j] = dsv;
    const float rs = warp_sum(dsv * s);
    if (lane == 0) {
      rr[i] = rv;
      dd[i] = ddv;
      rsum[i] = rs;
      fac[i] = sw[i] / rv;
    }
  }
  __syncthreads();

  // the column sums of dS o qk (warp 0); the chunk-local dv = (P / r)^T dh
  // and dk = dS^T Q, each warp's n-tiles of D, to fp32 scratch
  if (warp == 0) {
    float a = 0.f;
    for (int i = 0; i < kL; ++i)
      a = fmaf(dS[i * kTileLd + lane], Sx[i * kTileLd + lane], a);
    csum[lane] = a;
  }
  for (int nt = warp; nt < Dp / 8; nt += kWarps) {
    float av[2][4] = {}, ak[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t bd[PI][2], bq[PT][2];
      load_b<PI, false>(bd, dN, ld, ks * 16, nt * 8);
      load_b<PT, false>(bq, Qs, ld, ks * 16, nt * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t a[PI][4];
        load_a<PI, false>(a, Pp, kTileLd, mt * 16, ks * 16);
        mma_parts<PI, PI>(av[mt], a, bd);
        load_a<PI, false>(a, dS, kTileLd, mt * 16, ks * 16);
        mma_parts<PI, PT>(ak[mt], a, bq);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = mt * 16 + gid + hf * 8, e = nt * 8 + 2 * tig;
        if (j < Lc && e < D) {
          const long o = (row0 + (long)j * p.H) * D + e;
          *reinterpret_cast<float2*>(p.dv_part + o) =
              make_float2(av[mt][2 * hf], av[mt][2 * hf + 1]);
          *reinterpret_cast<float2*>(p.dk_part + o) =
              make_float2(ak[mt][2 * hf], ak[mt][2 * hf + 1]);
        }
      }
    }
  }
  __syncthreads();             // every read of dh before it is scaled

  // dh -> sw dh / r in place; dg = sum_i sw_i dd_i q_i
  for (int x = tid; x < kL * Dp; x += kThreads) {
    const int i = x / Dp, e = x % Dp;
    dN[i * ld + e] *= fac[i];
  }
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
    for (int i = 0; i < kL; ++i)
      a = fmaf(sw[i] * dd[i], to_f(Qs[i * ld + d]), a);
    Xs[(long)D * D + d] = a;
  }
  __syncthreads();

  // dG = Q^T (sw dN / r): a unit is 16 rows d x up to 8 n-tiles of e
  {
    const int mtn = Dp / 16, ntn = Dp / 8, ngr = (ntn + 7) / 8;
    for (int u = warp; u < mtn * ngr; u += kWarps) {
      const int mt = u / ngr, g0 = u % ngr * 8;
      uint32_t a[2][PT][4];
      load_a<PT, false>(a[0], Qs, ld, mt * 16, 0);
      load_a<PT, false>(a[1], Qs, ld, mt * 16, 16);
      for (int nt = g0; nt < min(g0 + 8, ntn); ++nt) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t bb[PS][2];
          load_b<PS, false>(bb, dN, ld, ks * 16, nt * 8);
          mma_parts<PT, PS>(acc, a[ks], bb);
        }
        const int d = mt * 16 + gid, e = nt * 8 + 2 * tig;
        if (e < D) {
          if (d < D)
            *reinterpret_cast<float2*>(Xs + (long)d * D + e) =
                make_float2(acc[0], acc[1]);
          if (d + 8 < D)
            *reinterpret_cast<float2*>(Xs + (long)(d + 8) * D + e) =
                make_float2(acc[2], acc[3]);
        }
      }
    }
  }

  // dq: the warp's n-tiles of d, both 16-row tiles of i.  The state part
  // (sw dN / r) C^T first, q . it into the row sums, then + dS K + sw dd n
  {
    const int ntn = Dp / 8;
    int nts[kGroup];
    bool live[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      nts[u] = warp + kWarps * u;
      live[u] = nts[u] < ntn;
    }
    float acc[kGroup][2][4] = {};
    state_product<PS, PS, true>(acc, dN, ld, p.Cst + cs * (long)D * D, D,
                                Dp, nts, live);
    float lbp[4] = {0.f, 0.f, 0.f, 0.f};   // rows gid + 8 x
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (!live[u]) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = mt * 16 + gid + (x >> 1) * 8;
          const int d = nts[u] * 8 + 2 * tig + (x & 1);
          lbp[mt * 2 + (x >> 1)] =
              fmaf(to_f(Qs[i * ld + d]), acc[u][mt][x], lbp[mt * 2 + (x >> 1)]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = quad_sum(lbp[r]);
      if (tig == 0) red[warp * kL + gid + 8 * r] = v;
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[2][PI][4];
      load_a<PI, true>(a[0], dS, kTileLd, 0, ks * 16);
      load_a<PI, true>(a[1], dS, kTileLd, 16, ks * 16);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (live[u]) {
          uint32_t bb[PT][2];
          load_b<PT, false>(bb, Ks, ld, ks * 16, nts[u] * 8);
          mma_parts<PI, PT>(acc[u][0], a[0], bb);
          mma_parts<PI, PT>(acc[u][1], a[1], bb);
        }
      }
    }
    T* dq = static_cast<T*>(p.dq);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (!live[u]) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = mt * 16 + gid + (x >> 1) * 8;
          const int d = nts[u] * 8 + 2 * tig + (x & 1);
          if (i < Lc && d < D)
            dq[(row0 + (long)i * p.H) * D + d] =
                from_f<T>(acc[u][mt][x] + sw[i] * dd[i] * ns[d]);
        }
    }
  }
  __syncthreads();

  // the rows' a_i = row sum of dS o qk + q_i.(dq_i's state part), the
  // chunk's lb, wk, the column sums and the decay (warp 0, lane = step)
  if (warp == 0) {
    const int i = lane;
    float lbv = sw[i] * dd[i] * qn[i];
    for (int w = 0; w < kWarps; ++w) lbv += red[w * kL + i];
    const float lbc = warp_sum(i < Lc ? lbv : 0.f);
    if (i < Lc) {
      const long o = row0 + (long)i * p.H;
      p.dlogf[o] = rsum[i] + lbv;
      p.csum[o] = csum[i];
      p.wk[o] = wk[i];
    }
    if (lane == 0) {
      p.lb[cs] = lbc;
      p.decay[cs] = scal[0];
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: the reverse scan of the carried cotangents over the chunks
// ---------------------------------------------------------------------------

// grid (ceil(D (D + 1) / 8 / 256), B * H): a thread two float4 of the
// slabs of one (row, head), from the last chunk back, four chunks' loads in
// flight.  Slab c holds dG_c and becomes G_end(c) = dG_{c+1} + decay_{c+1}
// G_end(c+1); the last chunk's (zero) is not written.
__global__ void __launch_bounds__(kScanThreads)
    mlstm_bwd_scan_kernel(BwdParams p) {
  const long E4 = (long)p.D * (p.D + 1) / 4;     // even: D % 8 == 0
  const long idx = 2 * ((long)blockIdx.x * kScanThreads + threadIdx.x);
  if (idx >= E4) return;
  const int bh = blockIdx.y, NC = p.NC;
  float4* base = reinterpret_cast<float4*>(p.X + (long)bh * NC * E4 * 4) +
                 idx;
  const float* dc = p.decay + (long)bh * NC;
  float4 G[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                 make_float4(0.f, 0.f, 0.f, 0.f)};
  for (int c = NC - 1; c >= 1;) {
    const int nb = min(4, c);    // chunks c, c - 1, .. in flight together
    float4 x[4][2];
    float w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < nb) {
        const float4* src = base + (long)(c - u) * E4;
        x[u][0] = src[0];
        x[u][1] = src[1];
        w[u] = dc[c - u];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < nb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (c - u < NC - 1) base[(long)(c - u) * E4 + h] = G[h];
          G[h] = make_float4(fmaf(w[u], G[h].x, x[u][h].x),
                             fmaf(w[u], G[h].y, x[u][h].y),
                             fmaf(w[u], G[h].z, x[u][h].z),
                             fmaf(w[u], G[h].w, x[u][h].w));
        }
      }
    }
    c -= nb;
  }
  base[0] = G[0];
  base[1] = G[1];
}

// ---------------------------------------------------------------------------
// Pass 3: per chunk, the terms that read G
// ---------------------------------------------------------------------------

// grid (NC, B * H).  Warps 0-7 take dk's n-tiles of d (V G^T: G along its
// rows), warps 8-15 dv's n-tiles of e (K G: G along its columns), each in
// two groups of kGroup; the last chunk's G and g are zero and not read.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mlstm_bwd_dkdv_kernel(BwdParams p) {
  constexpr int PT = Parts<T>::kT, PS = Parts<T>::kS;
  extern __shared__ __align__(16) char sm[];
  const BwdSmem Ls(p.D, sizeof(T));
  const int D = p.D, Dp = Ls.Dp, ld = Ls.ld, NC = p.NC;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / p.H, hh = bh % p.H;
  const int c0 = c * kL, Lc = min(kL, p.S - c0);
  const bool last = c == NC - 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long row0 = ((long)b * p.S + c0) * p.H + hh;
  const long cs = (long)bh * NC + c;
  T* Ks = reinterpret_cast<T*>(sm + Ls.k3);
  T* Vs = reinterpret_cast<T*>(sm + Ls.v3);
  float* gs = reinterpret_cast<float*>(sm + Ls.g3);
  float* wks = reinterpret_cast<float*>(sm + Ls.rows3);
  float* css = wks + kL;
  float* red = reinterpret_cast<float*>(sm + Ls.red3);
  const float* G = p.X + cs * (long)D * (D + 1);

  issue_rows(Ks, static_cast<const T*>(p.k), row0, p.H, D, Dp, ld, Lc);
  issue_rows(Vs, static_cast<const T*>(p.v), row0, p.H, D, Dp, ld, Lc);
  cp_async_commit();
  for (int d = tid; d < Dp; d += kThreads)
    gs[d] = !last && d < D ? G[(long)D * D + d] : 0.f;
  if (tid < kL) {
    const long o = row0 + (long)tid * p.H;
    wks[tid] = tid < Lc ? p.wk[o] : 0.f;
    css[tid] = tid < Lc ? p.csum[o] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const bool dkw = warp < kWarps / 2;
  const int w8 = dkw ? warp : warp - kWarps / 2, ntn = Dp / 8;
  float lwp[4] = {0.f, 0.f, 0.f, 0.f};      // rows gid + 8 x
  for (int grp = 0; grp < 2; ++grp) {
    int nts[kGroup];
    bool live[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      nts[u] = w8 + (kWarps / 2) * (grp * kGroup + u);
      live[u] = nts[u] < ntn;
    }
    float acc[kGroup][2][4] = {};
    if (!last) {
      if (dkw)
        state_product<PT, PS, true>(acc, Vs, ld, G, D, Dp, nts, live);
      else
        state_product<PT, PS, false>(acc, Ks, ld, G, D, Dp, nts, live);
    }
    T* out = static_cast<T*>(dkw ? p.dk : p.dv);
    const float* part = dkw ? p.dk_part : p.dv_part;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (!live[u]) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int j = mt * 16 + gid + (x >> 1) * 8;
          const int d = nts[u] * 8 + 2 * tig + (x & 1);
          // dk: wk_j (G v_j + g)[d]; dv: wk_j (G^T k_j)[e]
          const float st = wks[j] * (acc[u][mt][x] + (dkw ? gs[d] : 0.f));
          if (dkw)
            lwp[mt * 2 + (x >> 1)] =
                fmaf(to_f(Ks[j * ld + d]), st, lwp[mt * 2 + (x >> 1)]);
          if (j < Lc && d < D) {
            const long o = (row0 + (long)j * p.H) * D + d;
            out[o] = from_f<T>(part[o] + st);
          }
        }
    }
  }
  if (dkw) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = quad_sum(lwp[r]);
      if (tig == 0) red[w8 * kL + gid + 8 * r] = v;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int j = lane;
    float lw = 0.f;
    for (int w = 0; w < kWarps / 2; ++w) lw += red[w * kL + j];
    const float lwc = warp_sum(j < Lc ? lw : 0.f);
    if (j < Lc) p.di[row0 + (long)j * p.H] = css[j] + lw;
    if (lane == 0) p.lw[cs] = lwc;
  }
}

// ---------------------------------------------------------------------------
// Pass 4: dlogf
// ---------------------------------------------------------------------------

// grid B * H, one warp: from the last chunk back, dlogf_i = the chunk's
// reverse cumulative sum of a_i - di_i, plus the sum over the later chunks
// of lb - lw (the carried terms of the forget gates)
__global__ void __launch_bounds__(32) mlstm_bwd_dlogf_kernel(BwdParams p) {
  const int bh = blockIdx.x, b = bh / p.H, hh = bh % p.H;
  const int lane = threadIdx.x;
  float later = 0.f;
  for (int c = p.NC - 1; c >= 0; --c) {
    const int c0 = c * kL, Lc = min(kL, p.S - c0);
    const long o = ((long)b * p.S + c0 + lane) * p.H + hh;
    float x = lane < Lc ? p.dlogf[o] - p.di[o] : 0.f;
    for (int s = 1; s < 32; s <<= 1) {
      const float y = __shfl_down_sync(~0u, x, s);
      if (lane + s < 32) x += y;
    }
    if (lane < Lc) p.dlogf[o] = x + later;
    const long cs = (long)bh * p.NC + c;
    later += p.lb[cs] - p.lw[cs];
  }
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, const BwdSmem& Ls,
                       cudaStream_t s) {
  const dim3 grid(p.NC, p.B * p.H);
  cudaError_t e =
      opt_in_smem((const void*)mlstm_bwd_dq_kernel<T>, Ls.total1);
  if (e != cudaSuccess) return e;
  mlstm_bwd_dq_kernel<T><<<grid, kThreads, Ls.total1, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (p.NC > 1) {
    const long E8 = (long)p.D * (p.D + 1) / 8;
    mlstm_bwd_scan_kernel<<<dim3((unsigned)((E8 + kScanThreads - 1) /
                                            kScanThreads),
                                 p.B * p.H),
                            kScanThreads, 0, s>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  e = opt_in_smem((const void*)mlstm_bwd_dkdv_kernel<T>, Ls.total3);
  if (e != cudaSuccess) return e;
  mlstm_bwd_dkdv_kernel<T><<<grid, kThreads, Ls.total3, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mlstm_bwd_dlogf_kernel<<<p.B * p.H, 32, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
bool plan_fits(int threads, int pt, int pi, int ps, int smem1, int smem3,
               const BwdSmem& Ls) {
  return threads == kThreads && pt == Parts<T>::kT && pi == Parts<T>::kI &&
         ps == Parts<T>::kS && smem1 == Ls.total1 && smem3 == Ls.total3 &&
         Ls.total1 <= kMaxSmem && Ls.total3 <= kMaxSmem;
}

int tbytes_of(int dtype) {
  return dtype == 0 ? 4 : dtype == 1 || dtype == 2 ? 2 : 0;
}

struct NamedKernel {
  const char* name;
  const void* fn;
};
const NamedKernel kBwdKernels[] = {
    {"mlstm_bwd_dq_kernel<bf16>",
     (const void*)mlstm_bwd_dq_kernel<__nv_bfloat16>},
    {"mlstm_bwd_dq_kernel<fp16>", (const void*)mlstm_bwd_dq_kernel<__half>},
    {"mlstm_bwd_dq_kernel<fp32>", (const void*)mlstm_bwd_dq_kernel<float>},
    {"mlstm_bwd_scan_kernel", (const void*)mlstm_bwd_scan_kernel},
    {"mlstm_bwd_dkdv_kernel<bf16>",
     (const void*)mlstm_bwd_dkdv_kernel<__nv_bfloat16>},
    {"mlstm_bwd_dkdv_kernel<fp16>",
     (const void*)mlstm_bwd_dkdv_kernel<__half>},
    {"mlstm_bwd_dkdv_kernel<fp32>",
     (const void*)mlstm_bwd_dkdv_kernel<float>},
    {"mlstm_bwd_dlogf_kernel", (const void*)mlstm_bwd_dlogf_kernel},
};

}  // namespace

// dtype of q, k, v (and of dq, dk, dv): 0 = float32, 1 = float16,
// 2 = bfloat16; everything else fp32.  The plan (mlstm_chunk.mlstm_bwd_plan)
// is checked against what the kernels were built for: threads a block of
// the chunk passes, the bf16 parts of q/k/v, of the chunk-local and of the
// state operands, and the two passes' shared memory; D a multiple of 8 up
// to 384.  Scratch: X (B*H*NC, D*(D+1)), dk_part / dv_part (B,S,H,D), wk /
// csum (B,S,H), decay / lb / lw (B*H*NC), all fp32.  Up to four launches
// on ``stream`` (the scan only when there are two chunks or more); returns
// cudaGetLastError() after them.
extern "C" int mlstm_chunk_bwd_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* lf, const void* Cst, const void* nst, const void* mst,
    const void* h, const void* dh_, void* dq, void* dk, void* dv, void* di,
    void* dlogf, void* X, void* dk_part, void* dv_part, void* wk, void* csum,
    void* decay, void* lb, void* lw, int dtype, int B, int S, int H, int D,
    int threads, int parts_t, int parts_i, int parts_s, int smem1, int smem3,
    void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 8 || D % 8 || D > kMaxDim ||
      !tbytes_of(dtype))
    return (int)cudaErrorInvalidValue;
  const BwdSmem Ls(D, tbytes_of(dtype));
  const bool fits =
      dtype == 0 ? plan_fits<float>(threads, parts_t, parts_i, parts_s,
                                    smem1, smem3, Ls)
      : dtype == 1 ? plan_fits<__half>(threads, parts_t, parts_i, parts_s,
                                       smem1, smem3, Ls)
                   : plan_fits<__nv_bfloat16>(threads, parts_t, parts_i,
                                              parts_s, smem1, smem3, Ls);
  if (!fits) return (int)cudaErrorInvalidValue;
  BwdParams p{q, k, v, static_cast<const float*>(ig),
              static_cast<const float*>(lf), static_cast<const float*>(Cst),
              static_cast<const float*>(nst), static_cast<const float*>(mst),
              static_cast<const float*>(h), static_cast<const float*>(dh_),
              dq, dk, dv, static_cast<float*>(di),
              static_cast<float*>(dlogf), static_cast<float*>(X),
              static_cast<float*>(dk_part), static_cast<float*>(dv_part),
              static_cast<float*>(wk), static_cast<float*>(csum),
              static_cast<float*>(decay), static_cast<float*>(lb),
              static_cast<float*>(lw), B, S, H, D, (S + kL - 1) / kL};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_bwd<float>(p, Ls, s);
    case 1: return (int)launch_bwd<__half>(p, Ls, s);
    default: return (int)launch_bwd<__nv_bfloat16>(p, Ls, s);
  }
}

// Dynamic shared-memory bytes of pass 1 (which = 0) or pass 3 (which = 1)
// at head dim dh for q/k/v of ``dtype``.
extern "C" long mlstm_chunk_bwd_smem_bytes(int dh, int dtype, int which) {
  if (!tbytes_of(dtype)) return -1;
  const BwdSmem Ls(dh, tbytes_of(dtype));
  return which ? Ls.total3 : Ls.total1;
}

// The name of kernel i of this file (null past the last) and, from
// cudaFuncGetAttributes, its registers a thread and local memory a thread
// (spills) into attrs[0..1]; attrs[0] = -1 if the query failed.
extern "C" const char* mlstm_chunk_bwd_kernel_attrs(int i, int* attrs) {
  if (i < 0 || i >= (int)(sizeof(kBwdKernels) / sizeof(kBwdKernels[0])))
    return nullptr;
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kBwdKernels[i].fn) != cudaSuccess) {
    attrs[0] = attrs[1] = -1;
  } else {
    attrs[0] = fa.numRegs;
    attrs[1] = (int)fa.localSizeBytes;
  }
  return kBwdKernels[i].name;
}
