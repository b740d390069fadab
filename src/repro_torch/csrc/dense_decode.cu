// Dense single-query decode attention for Hopper (sm_90a), bf16 / fp16 q,
// bound to PyTorch through a plain C interface (ctypes); see
// repro_torch/kernels/decode_attention.py (decode_attention and its plan,
// dense_decode_plan).
//
// Replaces the Pallas TPU kernel decode_attention of the reference package
// (repro/kernels/decode_attention.py, body _kernel) at bf16 / fp16: one
// query token per row b, its Hq heads against the row's own contiguous
// cache k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv) with positions k_pos (B, Sk).
// A key is visible when 0 <= kp <= q_pos[b] (and kp > q_pos[b] - window
// with a window); a row that sees no key writes 0.  fp32 q, and q / k / v
// not 16-byte aligned, keep attend_rows (dense_decode_kernel in
// paged_attention.cu): a tensor-core body would multiply fp32 in TF32, and
// its copies need 16-byte aligned rows.
//
// Bound: device-memory bytes.  Each visible key's K and V rows of each kv
// head are read once (2 x (D + Dv) bytes), plus 4 bytes of position a key,
// q and out; a key costs 4 x D flops per query head, about g flops a
// byte, far below the card's ~295 flops-per-byte ridge.  So the design is
// about keeping bytes in flight on every SM, issuing little besides them,
// and a small fixed cost:
//
//  * A block per (row b, kv head h, group of up to 8 of h's g query heads,
//    split of the keys).  On the tensor cores (mma.sync.m16n8k16, fp32
//    accumulators) the operands are swapped: 16 keys are the A rows and
//    the group's heads the 8 columns of B, so S^T = K Q^T and O^T = V^T P^T
//    waste no rows at qwen3-4b's g = 4 (a 16-row query tile would waste
//    12 of 16).  Q^T stays in registers for the whole walk; P^T's B
//    fragments are the S^T fragments transposed in registers (movmatrix).
//    Every K/V tile is read once for all the group's heads.
//  * The block's warps split its keys: warp w walks tiles w, w + W, w + 2W,
//    ... of 32 keys through its own three-stage cp.async ring and keeps its
//    own (m, l, acc) in registers.  No block barrier in the walk, two tiles
//    of every warp in flight.  Rows are padded to the head-dim bucket (64,
//    128, 256; zeros, nothing read), so every loop has a trip count the
//    compiler knows and the mma chains interleave.
//  * Positions before bytes: a warp reads the positions of its next 32
//    tiles at once (one int a lane and tile, all in flight together).  The
//    row's heads share one query position, so a tile's visibility is one
//    32-bit ballot: a tile with no visible key is never requested, and the
//    ballot is the tile's mask.
//  * The warps' partials are merged once, in shared memory, at the end.
//    Where B x Hkv x groups blocks leave half the card idle, the plan also
//    splits the keys across blocks: each writes its merged (m, l, acc) to
//    scratch and the last of its group to arrive, found with an arrival
//    counter, adds the splits in order in the same launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "dtype.cuh"
#include "mma.cuh"

namespace {

constexpr int kDenseRows = 8;        // query heads a block: B's columns
constexpr int kDenseKeys = 32;       // keys a tile
constexpr int kDenseStages = 3;      // a warp's ring
constexpr int kDenseMaxWarps = 4;
constexpr int kDenseMaxSplits = 32;  // DENSE_MAX_SPLITS in the wrapper
constexpr int kDenseSmemLimit = 227 * 1024;

struct DenseArgs {
  const void* q;       // (B, 1, Hq, D)
  const void* k;       // (B, Sk, Hkv, D)
  const void* v;       // (B, Sk, Hkv, Dv)
  const int* kpos;     // (B, Sk)
  const int* q_pos;    // (B, 1)
  void* out;           // (B, 1, Hq, Dv)
  float* part;         // splits > 1: (groups * splits, 16, Dv)
  float* part_ml;      // splits > 1: (groups * splits, 16, 2) (m, l)
  int* counters;       // splits > 1: (groups), zero between launches
  int Sk, Hq, Hkv, g, D, Dv;
  int row_tiles, splits, keys_per_split;  // keys_per_split: whole tiles
  float scale, softcap;                   // softcap <= 0: none
  int window;                             // window <= 0: none
};

// Shared memory (bytes): the group's 8 Q rows, then each warp's ring (K
// and V tiles of 32 keys per stage; after the walk the warp's partial
// lives there), then the merge's per-row factors.  Every row holds the
// head-dim bucket DMAX (>= D, Dv; zeros past them), so every loop over
// head dims has a trip count the compiler knows; strides are padded by 16
// bytes so the 8 rows an ldmatrix reads fall in distinct banks.
struct DenseSmem {
  int stride, q_bytes, warp_bytes;
  __host__ __device__ explicit DenseSmem(int dmax) {
    stride = (dmax + 8) * 2;
    q_bytes = kDenseRows * stride;
    warp_bytes = kDenseStages * kDenseKeys * 2 * stride;
  }
  __host__ __device__ static int misc_bytes() {
    // factors [warps][8], row max and sum [8] each, split weights and
    // sums [splits][8] each, the merge flag
    return ((kDenseMaxWarps + 2 + 2 * kDenseMaxSplits) * kDenseRows + 4) * 4;
  }
  __host__ __device__ int total(int warps) const {
    return q_bytes + warps * warp_bytes + misc_bytes();
  }
};

// The warps a block runs at head-dim bucket dmax: four where their rings
// fit, else fewer (two at 256).
inline int dense_warps(int dmax) {
  const DenseSmem L(dmax);
  int w = kDenseMaxWarps;
  while (w > 1 && L.total(w) > kDenseSmemLimit) w >>= 1;
  return w;
}

// One warp's walk over its tiles of the block's keys [k_begin, k_stop):
// warp tile u is tile warp + u * nw of the split.  Lane u of `vis` holds
// the visibility ballot of warp tile base + u; bit u of `live` says it has
// a visible key.
struct DenseWalk {
  const int* kp_row;
  int k_begin, k_stop, warp, nw, n_wt, qp, window, lane;
  int base;
  unsigned vis, live;

  __device__ int key0(int u) const {
    return k_begin + (warp + u * nw) * kDenseKeys;
  }

  // The positions of warp tiles [nb, nb + 32), all loads in flight
  // together, then one ballot per tile.
  __device__ void fill(int nb) {
    base = nb;
    int p[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const int key = key0(nb + u) + lane;
      p[u] = nb + u < n_wt && key < k_stop ? __ldg(kp_row + key) : -1;
    }
    unsigned mine = 0;
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const unsigned bal = __ballot_sync(~0u, visible(p[u], qp, window));
      if (lane == u) mine = bal;
    }
    vis = mine;
    live = __ballot_sync(~0u, mine != 0);
  }

  // The first warp tile at or after u with a visible key (n_wt if none);
  // `mask` gets its ballot.
  __device__ int next(int u, unsigned& mask) {
    while (u < n_wt) {
      if (u >= base + 32) fill(u);
      const unsigned bits = live >> (u - base);
      if (bits) {
        u += __ffs(bits) - 1;
        mask = __shfl_sync(~0u, vis, u - base);
        return u;
      }
      u = base + 32;
    }
    return n_wt;
  }
};

// How a warp's lanes copy a tile's 32 rows of `dim` elements, zero-padded
// to DMAX, in 16-byte chunks: lane l takes chunk `col` of rows key0,
// key0 + kStep, ... (chunks past dim are zero-filled, nothing is read).
template <int DMAX>
struct WarpCopy {
  static constexpr int kPerRow = DMAX / 8, kStep = 32 / kPerRow;
  int key0, col;
  bool in_row;
  __device__ WarpCopy(int dim, int lane)
      : key0(lane / kPerRow), col((lane % kPerRow) * 16),
        in_row(col < dim * 2) {}
};

// the 8 x 8 b16 matrix whose fragment x holds, transposed (in registers)
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kDenseMaxWarps * 32)
    dense_decode_mma_kernel(DenseArgs a) {
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x, split = blockIdx.z;
  const int h = blockIdx.y / a.row_tiles, rt = blockIdx.y % a.row_tiles;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, nw = blockDim.x >> 5;
  const int D = a.D, Dv = a.Dv;
  const int r0 = rt * kDenseRows;
  const int nrows = min(kDenseRows, a.g - r0);
  const DenseSmem L(DMAX);
  char* q_s = smem;
  char* ring = smem + L.q_bytes + warp * L.warp_bytes;
  float* misc =
      reinterpret_cast<float*>(smem + L.q_bytes + nw * L.warp_bytes);
  const long long head0 = (long long)b * a.Hq + (long long)h * a.g + r0;

  // the group's Q rows (zeros past nrows and in D's padding), in flight
  // while the warps read their first positions
  {
    const T* q = static_cast<const T*>(a.q) + head0 * D;
    constexpr int per_row = DMAX / 8;
    for (int i = tid; i < kDenseRows * per_row; i += blockDim.x) {
      const int r = i / per_row, c = (i % per_row) * 8;
      const bool ok = r < nrows && c < D;
      cp_async16(q_s + r * L.stride + c * 2, ok ? q + r * D + c : q, ok);
    }
    cp_async_commit();
  }

  const int qp = a.q_pos[b];
  DenseWalk wk;
  wk.kp_row = a.kpos + (long long)b * a.Sk;
  wk.k_begin = split * a.keys_per_split;
  wk.k_stop = min(a.Sk, wk.k_begin + a.keys_per_split);
  const int ntiles = qp < 0 || wk.k_stop <= wk.k_begin
                         ? 0
                         : (wk.k_stop - wk.k_begin + kDenseKeys - 1) /
                               kDenseKeys;
  wk.warp = warp;
  wk.nw = nw;
  wk.n_wt = ntiles > warp ? (ntiles - warp + nw - 1) / nw : 0;
  wk.qp = qp;
  wk.window = a.window;
  wk.lane = lane;
  wk.base = -64;
  wk.vis = wk.live = 0;

  // K / V rows of kv head h: key j at entry b * Sk + j; this lane copies
  // rows key0 + kc.key0, + Copy::kStep, ... of a tile
  using Copy = WarpCopy<DMAX>;
  const Copy kc(D, lane), vc(Dv, lane);
  const long long krow = (long long)a.Hkv * D * 2;
  const long long vrow = (long long)a.Hkv * Dv * 2;
  const char* kbase = static_cast<const char*>(a.k) +
                      ((long long)b * a.Sk + kc.key0) * krow +
                      (long long)h * D * 2 + kc.col;
  const char* vbase = static_cast<const char*>(a.v) +
                      ((long long)b * a.Sk + vc.key0) * vrow +
                      (long long)h * Dv * 2 + vc.col;
  const int stage_bytes = kDenseKeys * 2 * L.stride;
  auto request = [&](int u, int st) {
    char* kst = ring + st * stage_bytes;
    char* vst = kst + kDenseKeys * L.stride;
    const int key0 = wk.key0(u);
    const char* ksrc = kbase + key0 * krow;
    const char* vsrc = vbase + key0 * vrow;
#pragma unroll
    for (int i = 0; i < kDenseKeys / Copy::kStep; ++i) {
      const int r = kc.key0 + i * Copy::kStep;
      const bool in = key0 + r < wk.k_stop;
      cp_async16(kst + r * L.stride + kc.col, in && kc.in_row ? ksrc : a.k,
                 in && kc.in_row);
      cp_async16(vst + r * L.stride + vc.col, in && vc.in_row ? vsrc : a.v,
                 in && vc.in_row);
      ksrc += Copy::kStep * krow;
      vsrc += Copy::kStep * vrow;
    }
  };

  // the ring's first two tiles, then Q is waited for by the whole block
  unsigned m_cur = 0, m_nxt = 0;
  int t_cur = wk.next(0, m_cur);
  if (t_cur < wk.n_wt) request(t_cur, 0);
  cp_async_commit();
  int t_nxt = t_cur < wk.n_wt ? wk.next(t_cur + 1, m_nxt) : wk.n_wt;
  if (t_nxt < wk.n_wt) request(t_nxt, 1);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();

  // Q^T as the B operand of S^T = K Q^T, in registers for the whole walk:
  // qb[kk] holds query gid's d = 16 kk + 2 tig (+1) and + 8
  uint32_t qb[DMAX / 16][2];
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    ldsm_x2(qb[kk], q_s + (lane & 7) * L.stride +
                        (kk * 16 + ((lane >> 3) & 1) * 8) * 2);

  // scores stay in natural units (times the scale, or softcapped); the
  // softmax takes them to base 2 with one FFMA before ex2.  This thread
  // owns queries 2 tig and 2 tig + 1 (columns of S^T and O^T).
  const float cap = a.softcap;
  const float to2 = cap > 0.f ? kLog2e : a.scale * kLog2e;
  float o[DMAX / 16][4];      // O^T: dv 16 mt + gid (+ 8) x the 2 queries
#pragma unroll
  for (int i = 0; i < DMAX / 16; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  int st = 0;
  while (t_cur < wk.n_wt) {
    unsigned m_new = 0;
    const int t_new = t_nxt < wk.n_wt ? wk.next(t_nxt + 1, m_new) : wk.n_wt;
    if (t_new < wk.n_wt) request(t_new, (st + 2) % kDenseStages);
    cp_async_commit();
    cp_async_wait<kDenseStages - 1>();
    __syncwarp();
    const char* kst = ring + st * stage_bytes;
    const char* vst = kst + kDenseKeys * L.stride;
    // S^T = K Q^T: two 16-key m tiles x the 8 queries; s[mt] holds keys
    // 16 mt + gid ([0], [1]) and + 8 ([2], [3]) x queries 2 tig, + 1.
    // Even and odd k steps sum into separate accumulators: four
    // independent mma chains instead of two.
    float s[2][4], s2[2][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i / 4][i % 4] = s2[i / 4][i % 4] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t ka[4];
        ldsm_x4(ka, kst + (mt * 16 + (lane & 15)) * L.stride +
                        (kk * 16 + (lane >> 4) * 8) * 2);
        mma16816<T>(kk % 2 ? s2[mt] : s[mt], ka, qb[kk][0], qb[kk][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i / 4][i % 4] += s2[i / 4][i % 4];
    if (cap > 0.f) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        s[i / 4][i % 4] = tanhf(s[i / 4][i % 4] * a.scale / cap) * cap;
    }
    // the tile's ballot is every query's mask (one query position)
    if (m_cur != ~0u) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int key = (i / 4) * 16 + gid + ((i % 4) / 2) * 8;
        if (!((m_cur >> key) & 1u)) s[i / 4][i % 4] = -INFINITY;
      }
    }
    // the online softmax per query: a column of S^T, over the 8 gid lanes
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = fmaxf(fmaxf(s[0][e], s[0][2 + e]),
                       fmaxf(s[1][e], s[1][2 + e]));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 16));
      const float m_up = fmaxf(m[e], mx);
      const float m_use = m_up == -INFINITY ? 0.f : m_up * to2;
      alpha[e] = exp2_approx(fmaf(m[e], to2, -m_use));  // 0 from -inf
      m[e] = m_up;
      float sum = 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const float p = exp2_approx(fmaf(s[mt][hi * 2 + e], to2, -m_use));
          s[mt][hi * 2 + e] = p;
          sum += p;
        }
      }
      l[e] = l[e] * alpha[e] + sum;
    }
    if (__any_sync(~0u, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int mt = 0; mt < DMAX / 16; ++mt) {
        o[mt][0] *= alpha[0];
        o[mt][1] *= alpha[1];
        o[mt][2] *= alpha[0];
        o[mt][3] *= alpha[1];
      }
    }
    // O^T += V^T P^T, P rounded to T: P^T's B fragments are the S^T
    // fragments' 8 x 8 blocks transposed in registers
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t pb0 = movmatrix_t(pack2<T>(s[ks][0], s[ks][1]));
      const uint32_t pb1 = movmatrix_t(pack2<T>(s[ks][2], s[ks][3]));
#pragma unroll
      for (int mt = 0; mt < DMAX / 16; ++mt) {
        uint32_t va[4];
        ldsm_x4_t(va, vst + (ks * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                L.stride +
                          (mt * 16 + ((lane >> 3) & 1) * 8) * 2);
        mma16816<T>(o[mt], va, pb0, pb1);
      }
    }
    __syncwarp();            // the stage is refilled two tiles from now
    t_cur = t_nxt;
    m_cur = m_nxt;
    t_nxt = t_new;
    m_nxt = m_new;
    st = (st + 1) % kDenseStages;
  }
  cp_async_wait<0>();
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(~0u, l[e], 4);
    l[e] += __shfl_xor_sync(~0u, l[e], 8);
    l[e] += __shfl_xor_sync(~0u, l[e], 16);
  }

  // this warp's partial, in its own ring: acc [8][Dv], then (m, l) [8]
  float* wpo = reinterpret_cast<float*>(ring);
  float* wml = wpo + kDenseRows * Dv;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 2 * tig + e;
#pragma unroll
    for (int mt = 0; mt < DMAX / 16; ++mt) {
      const int dv = mt * 16 + gid;
      if (dv < Dv) wpo[r * Dv + dv] = o[mt][e];
      if (dv + 8 < Dv) wpo[r * Dv + dv + 8] = o[mt][2 + e];
    }
    if (gid == 0) {
      wml[r * 2] = m[e] * to2;          // base 2, or -inf
      wml[r * 2 + 1] = l[e];
    }
  }
  __syncthreads();

  // the warps' merge: per row M = max_w m_w, factors 2^(m_w - M), and
  // L = sum_w l_w 2^(m_w - M)
  float* fac = misc;                               // [warps][8]
  float* rowM = fac + kDenseMaxWarps * kDenseRows; // [8]
  float* rowL = rowM + kDenseRows;                 // [8]
  float* wt = rowL + kDenseRows;                   // [splits][8]
  float* ls = wt + kDenseMaxSplits * kDenseRows;   // [splits][8]
  int* flag = reinterpret_cast<int*>(ls + kDenseMaxSplits * kDenseRows);
  auto warp_ml = [&](int w) {
    return reinterpret_cast<const float*>(smem + L.q_bytes + w * L.warp_bytes) +
           kDenseRows * Dv;
  };
  if (tid < nrows) {
    float M = -INFINITY;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, warp_ml(w)[tid * 2]);
    float Ls = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float f = M == -INFINITY ? 0.f : exp2f(warp_ml(w)[tid * 2] - M);
      fac[w * kDenseRows + tid] = f;
      Ls += warp_ml(w)[tid * 2 + 1] * f;
    }
    rowM[tid] = M;
    rowL[tid] = Ls;
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out);
  const int pairs = Dv / 2;                   // Dv is a multiple of 8
  const long long group = (long long)b * gridDim.y + blockIdx.y;
  const long long pidx = group * a.splits + split;
  for (int i = tid; i < nrows * pairs; i += blockDim.x) {
    const int r = i / pairs, c = (i % pairs) * 2;
    float x0 = 0.f, x1 = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float f = fac[w * kDenseRows + r];
      const float2 y = *reinterpret_cast<const float2*>(
          reinterpret_cast<const float*>(smem + L.q_bytes + w * L.warp_bytes) +
          r * Dv + c);
      x0 += f * y.x;
      x1 += f * y.y;
    }
    if (a.splits == 1) {
      // a row with no visible key has L == 0 and acc == 0: it writes 0
      const float inv = rowL[r] > 0.f ? 1.f / rowL[r] : 0.f;
      *reinterpret_cast<uint32_t*>(out + (head0 + r) * Dv + c) =
          pack2<T>(x0 * inv, x1 * inv);
    } else {
      *reinterpret_cast<float2*>(a.part + (pidx * kDenseRows + r) * Dv + c) =
          make_float2(x0, x1);
    }
  }
  if (a.splits == 1) return;

  // split keys: this block's (M, L), then the last block of the group to
  // arrive adds the splits in order
  if (tid < nrows)
    *reinterpret_cast<float2*>(a.part_ml + (pidx * kDenseRows + tid) * 2) =
        make_float2(rowM[tid], rowL[tid]);
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(a.counters + group, 1) == a.splits - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float* gml = a.part_ml + group * a.splits * kDenseRows * 2;
  const float* go = a.part + group * a.splits * kDenseRows * Dv;
  for (int i = tid; i < a.splits * nrows; i += blockDim.x) {
    const int s = i / nrows, r = i % nrows;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(gml) +
                             s * kDenseRows + r);
    wt[s * kDenseRows + r] = ml.x;
    ls[s * kDenseRows + r] = ml.y;
  }
  __syncthreads();
  if (tid < nrows) {
    float M = -INFINITY, Ls = 0.f;
    for (int s = 0; s < a.splits; ++s) M = fmaxf(M, wt[s * kDenseRows + tid]);
    if (M != -INFINITY)
      for (int s = 0; s < a.splits; ++s)
        Ls += ls[s * kDenseRows + tid] * exp2f(wt[s * kDenseRows + tid] - M);
    // 0 for a split that saw no key (m_s = -inf) or a row that saw none
    const float inv = Ls > 0.f ? 1.f / Ls : 0.f;
    for (int s = 0; s < a.splits; ++s)
      wt[s * kDenseRows + tid] =
          inv > 0.f ? exp2f(wt[s * kDenseRows + tid] - M) * inv : 0.f;
  }
  __syncthreads();
  const int quarter = Dv / 4;
  for (int i = tid; i < nrows * quarter; i += blockDim.x) {
    const int r = i / quarter, c = (i % quarter) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < a.splits; ++s) {
      const float f = wt[s * kDenseRows + r];
      const float4 y = __ldcg(reinterpret_cast<const float4*>(
          go + ((long long)s * kDenseRows + r) * Dv + c));
      acc.x += f * y.x;
      acc.y += f * y.y;
      acc.z += f * y.z;
      acc.w += f * y.w;
    }
    T* orow = out + (head0 + r) * Dv + c;
    *reinterpret_cast<uint32_t*>(orow) = pack2<T>(acc.x, acc.y);
    *reinterpret_cast<uint32_t*>(orow + 2) = pack2<T>(acc.z, acc.w);
  }
  if (tid == 0) a.counters[group] = 0;
}

template <typename T, int DMAX>
cudaError_t dense_launch(const DenseArgs& a, int B, cudaStream_t stream) {
  const int warps = dense_warps(DMAX);
  const size_t smem = DenseSmem(DMAX).total(warps);
  if (smem > kDenseSmemLimit) return cudaErrorInvalidValue;
  void (*kernel)(DenseArgs) = dense_decode_mma_kernel<T, DMAX>;
  cudaError_t e = opt_in_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(B, a.Hkv * a.row_tiles, a.splits), warps * 32, smem,
           stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dense_launch_dim(const DenseArgs& a, int B, cudaStream_t stream) {
  const int dvp = round16(a.D > a.Dv ? a.D : a.Dv);   // head-dim bucket
  return dvp <= 64    ? dense_launch<T, 64>(a, B, stream)
         : dvp <= 128 ? dense_launch<T, 128>(a, B, stream)
                      : dense_launch<T, 256>(a, B, stream);
}

}  // namespace

// Dense decode, bf16 (dtype 2) / fp16 (1): q (B,1,Hq,D) against k / v
// (B,Sk,Hkv,D[v]) with k_pos (B,Sk) and q_pos (B,1), all contiguous, q / k
// / v 16-byte aligned.  The plan (decode_attention.dense_decode_plan):
// splits runs of keys_per_split keys (a multiple of 32, none empty);
// with splits > 1 scratch holds B * Hkv * ceil(g / 8) * splits * 8 *
// (Dv + 2) floats and counters B * Hkv * ceil(g / 8) zeros
// (decode_attention.dense_scratch_floats).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a plan
// or shape it does not take.
extern "C" int dense_decode_mma_launch(
    const void* q, const void* k, const void* v, const void* k_pos,
    const void* q_pos, void* out, void* scratch, void* counters, int dtype,
    int B, int Hq, int Hkv, int D, int Dv, int Sk, int splits,
    int keys_per_split, float scale, float softcap, int window,
    void* stream) {
  if (B == 0) return 0;
  const bool aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  if (B < 0 || Hkv < 1 || Hq % Hkv || Sk < 1 || D % 8 || Dv % 8 || D < 8 ||
      Dv < 8 || D > 256 || Dv > 256 || !aligned || splits < 1 ||
      splits > kDenseMaxSplits || keys_per_split < kDenseKeys ||
      keys_per_split % kDenseKeys ||
      (long long)keys_per_split * splits < Sk ||
      (long long)keys_per_split * (splits - 1) >= Sk ||
      (splits > 1 && (scratch == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  DenseArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.kpos = static_cast<const int*>(k_pos);
  a.q_pos = static_cast<const int*>(q_pos);
  a.out = out;
  a.Sk = Sk;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.g = Hq / Hkv;
  a.D = D;
  a.Dv = Dv;
  a.row_tiles = (a.g + kDenseRows - 1) / kDenseRows;
  a.splits = splits;
  a.keys_per_split = keys_per_split;
  a.scale = scale;
  a.softcap = softcap;
  a.window = window;
  if ((long long)Hkv * a.row_tiles > 65535) return (int)cudaErrorInvalidValue;
  if (splits > 1) {
    const long long parts =
        (long long)B * Hkv * a.row_tiles * splits * kDenseRows;
    a.part = static_cast<float*>(scratch);
    a.part_ml = a.part + parts * Dv;
    a.counters = static_cast<int*>(counters);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return (int)dense_launch_dim<__half>(a, B, s);
    case 2: return (int)dense_launch_dim<__nv_bfloat16>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
