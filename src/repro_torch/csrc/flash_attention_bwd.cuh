// The flash attention backward's kernels and launcher (flash_attention_bwd.cu
// says what they compute and how), compiled once a dtype in translation
// units of their own -- flash_attention_bwd_{bf16,fp16,fp32}.cu -- so that
// nvcc builds the three beside each other: in one source they were the
// build's long pole.  Each unit instantiates launch_mma<T> and lists its
// kernels (repro_bwd::launch_* / kernels_*); flash_attention_bwd.cu's
// entry points call them.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "dtype.cuh"
#include "mma.cuh"

namespace repro_bwd {

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
  // the plan's split of each kv head's query heads over dK/dV blocks and,
  // with more than one, their fp32 partials
  int head_splits;
  float* part;
};

// The launch plan (flash_attention.py:bwd_plan) but its body, which the
// entry point checks against the dtype.  The launcher sizes its grids and
// shared memory from it, after checking that the kernels it picks were
// built for this geometry (a plan they were not: an error).
struct BwdPlan {
  int block_keys;     // keys of a dK/dV block
  int dq_rows;        // (query, head) rows of a dQ block
  int smem_dq;        // shared-memory bytes of a dQ block
  int smem_dkdv;      // ... and of a dK/dV block
};

// A kernel of a unit and its name, for flash_attention_bwd_kernel_attrs
struct NamedKernel {
  const char* name;
  const void* fn;
};

// The dtype's launches (dQ with D, dK / dV, the splits' sum) of a plan the
// kernels were built for, else cudaErrorInvalidValue; and its kernels
// (*n of them).
cudaError_t launch_bf16(const BwdParams& p, const BwdPlan& plan,
                        cudaStream_t stream);
cudaError_t launch_fp16(const BwdParams& p, const BwdPlan& plan,
                        cudaStream_t stream);
cudaError_t launch_fp32(const BwdParams& p, const BwdPlan& plan,
                        cudaStream_t stream);
const NamedKernel* kernels_bf16(int* n);
const NamedKernel* kernels_fp16(int* n);
const NamedKernel* kernels_fp32(int* n);

}  // namespace repro_bwd

namespace {

using repro_bwd::BwdParams;
using repro_bwd::BwdPlan;
using repro_bwd::NamedKernel;

constexpr size_t kMaxSmem = 227 * 1024;

constexpr int kWalkN = 32;        // items a walked tile: keys, or (query, head) pairs
constexpr int kWinTiles = 32;     // tiles whose positions are read at once
constexpr int kWarps = 4;         // of either kernel's block
constexpr int kWinPer = kWinTiles / kWarps;   // a warp's tiles of a window
constexpr int kDqRows = kWarps * 16;     // (query, head) rows of a dQ block

// Bytes of a row of `dim` elements of esz bytes in shared memory: zeros up
// to a multiple of 16 elements, then 16 bytes more (2-byte elements), so
// that the 8 rows an ldmatrix reads fall in distinct banks; fp32 rows as
// attn_mma.cuh's f32_rows_bytes (four rows read as float2 pairs fall in
// distinct bank groups; read down columns, 2-way conflicts).
__host__ __device__ inline int smem_row_bytes(int dim, int esz = 2) {
  return esz == 4 ? f32_rows_bytes(dim) : (round16(dim) + 8) * 2;
}

// The head-dim bucket of a (D, Dv) pair: the widest accumulator a warp
// may need, 64, 128 or 256.
__host__ __device__ inline int bwd_dmax(int D, int Dv) {
  const int d = round16(D > Dv ? D : Dv);
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// Stages of a block's ring of tiles: 3 (two tiles in flight while one is
// multiplied), 2 in the 256 bucket, so that two dK/dV blocks fit an SM.
// fp32 rows (esz 4) take twice the room: in the 256 bucket a dQ block
// holds one tile (its 64 rows' Q and dO take 132 KB) and a dK/dV block two.
__host__ __device__ constexpr int walk_stages(int dmax) {
  return dmax > 128 ? 2 : 3;
}
__host__ __device__ constexpr int dq_stages(int dmax, int esz) {
  return esz == 4 && dmax > 128 ? 1 : walk_stages(dmax);
}

// Warps that share 16 keys of a dK/dV block and split its columns, and
// each one's part of a padded width dp (a multiple of 16 columns).
__host__ __device__ constexpr int col_split(int dmax) {
  return dmax > 128 ? 2 : 1;
}
__host__ __device__ constexpr int col_part(int dp, int cs) {
  return cs == 1 ? dp : ((dp + cs - 1) / cs + 15) & ~15;
}
// Whether the cs parts of a padded width d (> 0) cover it exactly, so that
// no column group of a part needs its bounds checked.
__host__ __device__ constexpr bool parts_whole(int d, int cs) {
  return d > 0 && col_part((d + 15) & ~15, cs) * cs == ((d + 15) & ~15);
}

// Keys of a dK/dV block: 16 a warp, 16 a pair of warps above 128.
__host__ __device__ constexpr int dkdv_keys(int dmax) {
  return kWarps / col_split(dmax) * 16;
}

// Shared memory of a dK/dV block (bytes): its keys' K and V rows; per
// stage a pair tile's Q and dO rows, then its lse, D and positions
// (kWalkN each) and a flag; then the keys' positions, the walk's window
// of positions and each warp's live bits.
struct DkdvSmem {
  int kstr, vstr, keys, stages, kv, stage;
  __host__ __device__ DkdvSmem(int D, int Dv, int esz)
      : kstr(smem_row_bytes(D, esz)), vstr(smem_row_bytes(Dv, esz)),
        keys(dkdv_keys(bwd_dmax(D, Dv))),
        stages(walk_stages(bwd_dmax(D, Dv))) {
    kv = keys * (kstr + vstr);
    stage = kWalkN * (kstr + vstr) + (3 * kWalkN + 4) * 4;
  }
  __host__ __device__ int misc() const { return kv + stages * stage; }
  __host__ __device__ int total() const {
    return misc() + (keys + kWinTiles * kWalkN + kWarps) * 4;
  }
};

// Shared memory of a dQ block (bytes): its rows' Q, dO and (2-byte
// elements) o; per stage a key tile's K and V rows, its positions and a
// flag; then the rows' positions, lse (base 2) and D, the walk's window
// and the live bits.
struct DqSmem {
  int kstr, vstr, stages, stage, vrows;
  __host__ __device__ DqSmem(int D, int Dv, int esz)
      : kstr(smem_row_bytes(D, esz)), vstr(smem_row_bytes(Dv, esz)),
        stages(dq_stages(bwd_dmax(D, Dv), esz)), vrows(esz == 4 ? 1 : 2) {
    stage = kWalkN * (kstr + vstr) + (kWalkN + 4) * 4;
  }
  __host__ __device__ int misc() const {
    return kDqRows * (kstr + vrows * vstr) + stages * stage;
  }
  __host__ __device__ int total() const {
    return misc() + (3 * kDqRows + kWinTiles * kWalkN + kWarps) * 4;
  }
};

// How the block's threads copy rows of `dim` elements of esz bytes into
// shared rows with 16-byte cp.async: thread t takes chunk `col` of rows
// r0, r0 + step, ... (one division a copy, none a row).  Row r comes from
// src + off(r) * dim for r < n; zeros after n and in the padding of dim
// up to a multiple of 16.
struct RowCopy {
  int r0, step, col, dim, esz;
  __device__ RowCopy(int d, int e) : dim(d), esz(e) {
    const int per_row = round16(d) * e / 16;   // <= 64
    step = blockDim.x / per_row;
    r0 = threadIdx.x / per_row;
    col = (threadIdx.x - r0 * per_row) * (16 / e);
    if (r0 >= step) r0 = INT_MAX;            // the spare threads
  }
  template <typename T, typename Off>
  __device__ __forceinline__ void run(char* dst, int stride, const T* src,
                                      int n, int rows, Off off) const {
    const bool in = col < dim;
    for (int r = r0; r < rows; r += step) {
      const bool ok = in && r < n;
      cp_async16(dst + r * stride + col * esz,
                 ok ? src + off(r) * dim + col : src, ok);
    }
  }
};

// A block's walk over tiles of kWalkN items, positions first.  The items
// are keys (the dQ kernel; the fixed side is the block's rows) or (query,
// head) pairs (the dK/dV kernel; the fixed side is the block's keys), and
// item i has position pos[i / div] (none past n).  The positions of
// kWinTiles tiles are read at once, and a tile in which no item can see or
// be seen by the fixed side, whose valid positions span [lo, hi], is
// marked dead and never requested.  Each warp marks its own tiles in its
// own word; no atomics.  Every thread runs next() on the same data, so its
// barriers are uniform.
struct Walk {
  const int* pos;
  int n, div, tiles;
  int lo, hi, window;
  bool keys;
  int* win;          // [kWinTiles * kWalkN] the window's positions
  int* bits;         // [kWarps] each warp's live tiles of the window
  int base;          // the window's first tile
  unsigned live;     // its live tiles: bit t is tile base + t

  // Whether an item at position p may be visible to some row of the fixed
  // side (keys) or see some of its keys (pairs).
  __device__ __forceinline__ bool cand(int p) const {
    if (p < 0) return false;
    return keys ? p <= hi && (window <= 0 || p > lo - window)
                : p >= lo && (window <= 0 || p - window < hi);
  }
  // Whether every position of [lo, hi] and p see each other.
  __device__ __forceinline__ bool whole(int p) const {
    if (p < 0) return false;
    return keys ? p <= lo && (window <= 0 || p > hi - window)
                : p >= hi && (window <= 0 || p - window < lo);
  }

  // Request the positions of tiles [t0, t0 + kWinTiles) into registers,
  // tile warp + it * kWarps into ps[it]: all loads in flight.
  __device__ __forceinline__ void load(int t0, int (&ps)[kWinPer]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int it = 0; it < kWinPer; ++it) {
      const int i = (t0 + warp + it * kWarps) * kWalkN + lane;
      ps[it] = i < n ? pos[i / div] : -1;
    }
    base = t0;
  }
  // Store the loaded positions and this warp's live bits (one vote a
  // tile); then a barrier and gather().
  __device__ __forceinline__ void mark(const int (&ps)[kWinPer]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    unsigned mine = 0;
#pragma unroll
    for (int it = 0; it < kWinPer; ++it) {
      const int t = warp + it * kWarps;
      win[t * kWalkN + lane] = ps[it];
      if (__any_sync(~0u, cand(ps[it]))) mine |= 1u << t;
    }
    if (lane == 0) bits[warp] = (int)mine;
  }
  __device__ __forceinline__ void gather() {
    unsigned v = 0;
    for (int w = 0; w < kWarps; ++w) v |= (unsigned)bits[w];
    live = v;
  }

  // The first live tile at or after t, or `tiles`; refills the window as
  // needed.
  __device__ int next(int t) {
    while (t < tiles) {
      if (t >= base + kWinTiles) {
        __syncthreads();            // the old window has been read
        int ps[kWinPer];
        load(t, ps);
        mark(ps);
        __syncthreads();
        gather();
      }
      const unsigned b = live >> (t - base);
      if (b) return t + __ffs(b) - 1;
      t = base + kWinTiles;
    }
    return tiles;
  }

  // The position of item `lane` of live tile t (t in the window).
  __device__ __forceinline__ int at(int t, int lane) const {
    return win[(t - base) * kWalkN + lane];
  }
};

// The lowest and highest valid (>= 0) of m positions in shared memory, and
// whether all m are valid; every lane of the calling warp gets them.
__device__ __forceinline__ void span(const int* ps, int m, int& lo, int& hi,
                                     bool& all) {
  const int lane = threadIdx.x & 31;
  lo = INT_MAX;
  hi = -1;
  int ok = 1;
  for (int i = lane; i < m; i += 32) {
    const int p = ps[i];
    if (p >= 0) {
      lo = min(lo, p);
      hi = max(hi, p);
    } else {
      ok = 0;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(~0u, lo, o));
    hi = max(hi, __shfl_xor_sync(~0u, hi, o));
  }
  all = __all_sync(~0u, ok) != 0;
}

// The ring over a walk's live tiles, S stages: start() requests the first
// S - 1 tiles (one cp.async group each), and each iteration of run()
// requests the next into the stage the last one multiplied, behind the
// iteration's one barrier.  With one stage nothing overlaps: each tile is
// requested, waited for and multiplied in turn, behind two barriers.
// issue(t, stage) and compute(stage) are the kernel's; every thread runs
// both.
template <int S, typename Issue>
struct Ring {
  Walk& w;
  char* stages;
  int stage_bytes;
  Issue issue;
  int t = 0, issued = 0;

  __device__ Ring(Walk& walk, char* st, int bytes, Issue is)
      : w(walk), stages(st), stage_bytes(bytes), issue(is) {}

  __device__ __forceinline__ void start() {
    t = w.next(0);
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (t < w.tiles) {
        issue(t, stages + i * stage_bytes);
        ++issued;
        t = w.next(t + 1);
      }
      cp_async_commit();
    }
  }

  template <typename Compute>
  __device__ __forceinline__ void run(Compute compute) {
    if constexpr (S == 1) {
      while (t < w.tiles) {
        issue(t, stages);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        compute(stages);
        __syncthreads();      // the stage has been read
        t = w.next(t + 1);
      }
      return;
    }
    int st = 0;
    for (int done = 0; done < issued; ++done) {
      cp_async_wait<(S > 1 ? S - 2 : 0)>();
      __syncthreads();      // stage st has landed; the last one is free
      if (t < w.tiles) {
        issue(t, stages + ((st + S - 1) % S) * stage_bytes);
        ++issued;
        t = w.next(t + 1);
      }
      cp_async_commit();
      compute(stages + st * stage_bytes);
      st = (st + 1) % S;
    }
    cp_async_wait<0>();
  }
};

template <typename T>
__device__ __forceinline__ float2 to_f2(uint32_t x);
template <>
__device__ __forceinline__ float2 to_f2<__nv_bfloat16>(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}
template <>
__device__ __forceinline__ float2 to_f2<__half>(uint32_t x) {
  return __half22float2(*reinterpret_cast<__half2*>(&x));
}

// sum of the products of 8 elements each, in order
template <typename T>
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = to_f2<T>(x[i]), v = to_f2<T>(y[i]);
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}

// The probabilities and dS of one warp's 16 x 32 tile of scores s (rows
// gid and gid + 8 of the accumulators; columns nt * 8 + tig * 2 + e), with
// dp = dO.V^T in the same layout: s becomes P, dp becomes dS / scale.  The
// per-row (rr) and per-column (c) sides are the caller's: l2 the lse in
// base 2, dl the row's D, vis the mask.  CAP: a softcap; FULL: a tile that
// every row sees whole (no mask).  Each of the four is its own code: a
// branch an element costs more than the tile's products.
template <bool CAP, bool FULL, typename L2, typename DL, typename VIS>
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      float scale, float cap, float to2,
                                      L2 l2, DL dl, VIS vis) {
  const int tig = (threadIdx.x & 31) & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = nt * 8 + tig * 2 + e;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = rr * 2 + e;
        float x = s[nt][i], chain = 1.f;
        if constexpr (CAP) {
          const float th = tanhf(x * scale / cap);
          x = th * cap;
          chain = 1.f - th * th;
        }
        // lse = +inf (a row that sees no key): 2^-inf = 0
        const float pr = FULL || vis(rr, c)
                             ? exp2_approx(fmaf(x, to2, -l2(rr, c)))
                             : 0.f;
        s[nt][i] = pr;
        dp[nt][i] = pr * (dp[nt][i] - dl(rr, c)) * chain;
      }
    }
  }
}

// probs() with its CAP and FULL chosen at run time.
template <typename L2, typename DL, typename VIS>
__device__ __forceinline__ void probs_of(bool cap_on, bool full,
                                         float (&s)[4][4], float (&dp)[4][4],
                                         float scale, float cap, float to2,
                                         L2 l2, DL dl, VIS vis) {
  if (cap_on) {
    if (full)
      probs<true, true>(s, dp, scale, cap, to2, l2, dl, vis);
    else
      probs<true, false>(s, dp, scale, cap, to2, l2, dl, vis);
  } else if (full) {
    probs<false, true>(s, dp, scale, cap, to2, l2, dl, vis);
  } else {
    probs<false, false>(s, dp, scale, cap, to2, l2, dl, vis);
  }
}

// One k-step of a product A.B^T: acc (16 x 32 a warp) += a (the A
// fragment of 16 rows x 16) . B^T, B's 32 rows from `b_rows` in shared
// memory at k-step kk (Q.K^T in the forward).
template <typename T>
__device__ __forceinline__ void mma_bt_step(float (&acc)[4][4],
                                            const uint32_t (&a)[4],
                                            const char* b_rows, int b_stride,
                                            int kk) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t bb[4];
    ldsm_x4(bb, b_rows + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * b_stride +
                    (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
    mma16816<T>(acc[np * 2], a, bb[0], bb[1]);
    mma16816<T>(acc[np * 2 + 1], a, bb[2], bb[3]);
  }
}

// The A fragment (ldmatrix) of the warp's 16 rows of `a_rows` at k-step kk.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const char* a_rows,
                                       int a_stride, int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, a_rows + (lane & 15) * a_stride + (kk * 16 + (lane >> 4) * 8) * 2);
}

// acc (16 x 32 a warp) += A (16 x kpad, the warp's rows of `a_rows`) .
// B^T (32 rows of `b_rows`), kpad a multiple of 16.
template <typename T, int DMAX>
__device__ __forceinline__ void mma_abt(float (&acc)[4][4], const char* a_rows,
                                        int a_stride, const char* b_rows,
                                        int b_stride, int kpad) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk * 16 >= kpad) break;
    uint32_t a[4];
    frag_a(a, a_rows, a_stride, kk);
    mma_bt_step<T>(acc, a, b_rows, b_stride, kk);
  }
}

// The same with A's fragments held in registers: a block that multiplies
// its own rows by every tile loads them once (a quarter of a tile's
// shared-memory reads), where the registers allow it.
template <typename T, int KS>
__device__ __forceinline__ void mma_abt(float (&acc)[4][4],
                                        const uint32_t (&a)[KS][4],
                                        const char* b_rows, int b_stride,
                                        int kpad) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk * 16 >= kpad) break;
    mma_bt_step<T>(acc, a[kk], b_rows, b_stride, kk);
  }
}

// Every k-step's A fragment of the warp's 16 rows of `a_rows`.
template <int KS>
__device__ __forceinline__ void frags_a(uint32_t (&a)[KS][4],
                                        const char* a_rows, int a_stride,
                                        int kpad) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (kk * 16 < kpad) frag_a(a[kk], a_rows, a_stride, kk);
}

// acc (16 x up to NP * 16 per warp, from column c0) += X (16 x 32, the
// accumulators of probs(), rounded to T) . B (32 rows of `b_rows` from
// column c0, up to `width` columns of the padded `dpad`), B through
// ldmatrix.trans: P.V in the forward.
template <typename T, int NP, bool WHOLE>
__device__ __forceinline__ void mma_xb(float (&acc)[NP * 2][4],
                                       const float (&x)[4][4],
                                       const char* b_rows, int b_stride,
                                       int c0, int width, int dpad) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kq = 0; kq < 2; ++kq) {
    const uint32_t xa[4] = {pack2<T>(x[2 * kq][0], x[2 * kq][1]),
                            pack2<T>(x[2 * kq][2], x[2 * kq][3]),
                            pack2<T>(x[2 * kq + 1][0], x[2 * kq + 1][1]),
                            pack2<T>(x[2 * kq + 1][2], x[2 * kq + 1][3])};
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      const int c = c0 + np * 16;
      if (np * 16 < width && (WHOLE || c < dpad)) {
        uint32_t bb[4];
        ldsm_x4_t(bb, b_rows + (kq * 16 + (lane & 15)) * b_stride +
                          (c + (lane >> 4) * 8) * 2);
        mma16816<T>(acc[np * 2], xa, bb[0], bb[1]);
        mma16816<T>(acc[np * 2 + 1], xa, bb[2], bb[3]);
      }
    }
  }
}

// grid (ceil(Sq g / 64), Hkv, B), 4 warps: dQ of 64 (query, head) rows of
// kv head hk, over every live key tile, in order; also D of those rows.
// DK, DV > 0: the head dims, fixed at compile time (then every loop bound
// below is a constant: a bound checked at run time inside the unrolled
// products costs more than the products); 0: read from p.  T float: the
// split body.
template <typename T, int DMAX, int DK, int DV>
__global__ void __launch_bounds__(kWarps * 32)
    attn_bwd_dq_mma_kernel(BwdParams p) {
  extern __shared__ __align__(16) char mma_smem[];
  char* smem = mma_smem;
  constexpr bool kSplit = std::is_same_v<T, float>;
  constexpr int S = dq_stages(DMAX, sizeof(T));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = p.g, hk = blockIdx.y, b = blockIdx.z;
  // the last row tile first: under a causal mask it sees the most keys
  const int row_tiles = (p.Sq * g + kDqRows - 1) / kDqRows;
  const int r0 = (row_tiles - 1 - (int)blockIdx.x) * kDqRows;
  const int nrows = min(kDqRows, p.Sq * g - r0);
  const int D = DK > 0 ? DK : p.D, Dv = DV > 0 ? DV : p.Dv;
  const int DP = round16(D), DVP = round16(Dv);
  const DqSmem L(D, Dv, sizeof(T));
  char* qs = smem;
  char* dos = qs + kDqRows * L.kstr;
  char* os = dos + kDqRows * L.vstr;       // 2-byte elements only
  char* stages = (kSplit ? dos : os) + kDqRows * L.vstr;
  int* row_qp = reinterpret_cast<int*>(smem + L.misc());
  float* row_l2 = reinterpret_cast<float*>(row_qp + kDqRows);
  float* row_dl = row_l2 + kDqRows;
  // row r: query (r0 + r) / g, head hk g + (r0 + r) % g; its offset in
  // rows of q / dq (times D) and of o / dO (times Dv), and of lse / delta
  auto row_off = [&](int r) -> long long {
    const int rg = r0 + r, qi = rg / g;
    return ((long long)b * p.Sq + qi) * p.Hq + (long long)hk * g + rg - qi * g;
  };
  auto stat_off = [&](int r) -> long long {
    const int rg = r0 + r, qi = rg / g;
    return ((long long)b * p.Hq + (long long)hk * g + rg - qi * g) * p.Sq + qi;
  };

  // Q, dO and (2-byte elements) o rows, the rows' positions and lse, and
  // the key positions of the walk's first window: every load in flight at
  // once
  {
    const RowCopy kcp(D, sizeof(T)), vcp(Dv, sizeof(T));
    kcp.run(qs, L.kstr, static_cast<const T*>(p.q), nrows, kDqRows, row_off);
    vcp.run(dos, L.vstr, static_cast<const T*>(p.dout), nrows, kDqRows,
            row_off);
    if constexpr (!kSplit)
      vcp.run(os, L.vstr, static_cast<const T*>(p.o), nrows, kDqRows,
              row_off);
  }
  cp_async_commit();
  Walk w;
  w.win = reinterpret_cast<int*>(row_dl + kDqRows);
  w.bits = w.win + kWinTiles * kWalkN;
  w.pos = p.k_pos + (long long)b * p.Sk;
  w.n = p.Sk;
  w.div = 1;
  w.tiles = (p.Sk + kWalkN - 1) / kWalkN;
  w.window = p.window;
  w.keys = true;
  int ps[kWinPer];
  w.load(0, ps);
  for (int r = tid; r < kDqRows; r += blockDim.x) {
    const bool ok = r < nrows;
    row_qp[r] = ok ? p.q_pos[(long long)b * p.Sq + (r0 + r) / g] : -1;
    row_l2[r] = ok ? p.lse[stat_off(r)] * kLog2e : INFINITY;
  }
  __syncthreads();
  bool rows_full;
  span(row_qp, kDqRows, w.lo, w.hi, rows_full);
  if (w.hi < 0) w.tiles = 0;               // all padding: read no key
  w.mark(ps);
  __syncthreads();
  w.gather();

  // K and V rows of key tile t of kv head hk, its positions, and whether
  // every row sees every key of it
  auto issue = [&](int t, char* st) {
    const int j0 = t * kWalkN;
    const int nk = min(kWalkN, p.Sk - j0);
    const long long row0 = ((long long)b * p.Sk + j0) * p.Hkv + hk;
    auto key_off = [&](int r) -> long long { return row0 + (long long)r * p.Hkv; };
    RowCopy(D, sizeof(T)).run(st, L.kstr, static_cast<const T*>(p.k), nk,
                              kWalkN, key_off);
    RowCopy(Dv, sizeof(T)).run(st + kWalkN * L.kstr, L.vstr,
                               static_cast<const T*>(p.v), nk, kWalkN,
                               key_off);
    int* sp = reinterpret_cast<int*>(st + kWalkN * (L.kstr + L.vstr));
    if (tid < kWalkN) {
      const int kp = w.at(t, tid);
      sp[tid] = kp;
      const bool full = __all_sync(~0u, w.whole(kp)) && rows_full;
      if (tid == 0) sp[kWalkN] = full;
    }
  };
  // the first key tiles in flight behind the rows' own copies
  Ring<S, decltype(issue)> ring(w, stages, L.stage, issue);
  ring.start();
  cp_async_wait<S - 1>();                  // Q, dO and o have landed
  __syncthreads();
  // D = rowsum(dO o): two threads a row, the two halves added in order
  // (fp32: o read from device memory, 4 columns of each 8 a thread)
  {
    const int r = tid >> 1, half = tid & 1;
    float acc = 0.f;
    const char* drow = dos + r * L.vstr;
    if constexpr (kSplit) {
      if (r < nrows) {
        const float* orow = static_cast<const float*>(p.o) + row_off(r) * Dv;
        const float* dr = reinterpret_cast<const float*>(drow);
        for (int c = half * 4; c < Dv; c += 8) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(orow + c));
          const float4 y = *reinterpret_cast<const float4*>(dr + c);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
          acc = fmaf(x.z, y.z, acc);
          acc = fmaf(x.w, y.w, acc);
        }
      }
    } else {
      const char* orow = os + r * L.vstr;
      for (int c = half * 8; c < Dv; c += 16)
        acc = dot8<T>(*reinterpret_cast<const uint4*>(orow + c * 2),
                      *reinterpret_cast<const uint4*>(drow + c * 2), acc);
    }
    const float other = __shfl_xor_sync(~0u, acc, 1);
    if (half == 0) {
      acc += other;
      row_dl[r] = acc;
      if (r < nrows) p.delta[stat_off(r)] = acc;
    }
  }
  __syncthreads();

  const int rw = warp * 16 + gid;
  const int qp[2] = {row_qp[rw], row_qp[rw + 8]};
  const float l2[2] = {row_l2[rw], row_l2[rw + 8]};
  const float dl[2] = {row_dl[rw], row_dl[rw + 8]};
  const bool has_rows = warp * 16 < nrows;
  const float cap = p.softcap;
  const float to2 = cap > 0.f ? kLog2e : p.scale * kLog2e;
  float dq[DMAX / 8][4];
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  // up to a head dim of 128 the warp's Q and dO fragments stay in
  // registers for the whole walk; fp32 holds Q's parts at 64 (dO's are cut
  // from shared memory every tile: both would pass 255 registers)
  constexpr bool HOLD = !kSplit && DMAX <= 128;
  constexpr bool HOLD_SPLIT = kSplit && DMAX <= 64;
  uint32_t qf[HOLD ? DMAX / 16 : 1][4], df[HOLD ? DMAX / 16 : 1][4];
  uint32_t qh[HOLD_SPLIT ? DMAX / 16 : 1][kSplitParts][4];
  if constexpr (HOLD) {
    frags_a(qf, qs + warp * 16 * L.kstr, L.kstr, DP);
    frags_a(df, dos + warp * 16 * L.vstr, L.vstr, DVP);
  }
  if constexpr (HOLD_SPLIT)
    split_rows_a(qh, reinterpret_cast<const float*>(qs + warp * 16 * L.kstr),
                 L.kstr / 4, DP);

  ring.run([&](const char* kst) {
    if (!has_rows) return;
    const char* vst = kst + kWalkN * L.kstr;
    const int* sp = reinterpret_cast<const int*>(vst + kWalkN * L.vstr);
    const bool full = sp[kWalkN] != 0;
    float s[4][4], dp[4][4];
    // S = Q K^T, dP = dO V^T: 16 rows x 32 keys a warp
    if constexpr (kSplit) {
      const float* kf = reinterpret_cast<const float*>(kst);
      if constexpr (HOLD_SPLIT)
        mma_abt_split(s, qh, kf, L.kstr / 4, DP);
      else
        mma_abt_split<DMAX>(
            s, reinterpret_cast<const float*>(qs + warp * 16 * L.kstr),
            L.kstr / 4, kf, L.kstr / 4, DP);
      mma_abt_split<DMAX>(
          dp, reinterpret_cast<const float*>(dos + warp * 16 * L.vstr),
          L.vstr / 4, reinterpret_cast<const float*>(vst), L.vstr / 4, DVP);
    } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i / 4][i % 4] = dp[i / 4][i % 4] = 0.f;
    if constexpr (HOLD) {
      mma_abt<T>(s, qf, kst, L.kstr, DP);
      mma_abt<T>(dp, df, vst, L.vstr, DVP);
    } else {
      mma_abt<T, DMAX>(s, qs + warp * 16 * L.kstr, L.kstr, kst, L.kstr, DP);
      mma_abt<T, DMAX>(dp, dos + warp * 16 * L.vstr, L.vstr, vst, L.vstr,
                       DVP);
    }
    }
    auto l2f = [&](int rr, int) { return l2[rr]; };
    auto dlf = [&](int rr, int) { return dl[rr]; };
    auto vis = [&](int rr, int c) {
      return visible(sp[c], qp[rr], p.window);
    };
    probs_of(cap > 0.f, full, s, dp, p.scale, cap, to2, l2f, dlf, vis);
    // dQ += dS K
    if constexpr (kSplit)
      mma_xb_split<DMAX / 16, parts_whole(DK, 1)>(
          dq, dp, reinterpret_cast<const float*>(kst), L.kstr / 4, 0, DP, DP);
    else
      mma_xb<T, DMAX / 16, parts_whole(DK, 1)>(dq, dp, kst, L.kstr, 0, DP,
                                               DP);
  });
  if (!has_rows) return;
  const float sc = p.scale;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = rw + rr * 8;
    if (r >= nrows) continue;
    T* out = static_cast<T*>(p.dq) + row_off(r) * D;
#pragma unroll
    for (int nt = 0; nt < DMAX / 8; ++nt) {
      const int c = nt * 8 + tig * 2;
      if (c < D) store2<T>(out + c, dq[nt][rr * 2] * sc, dq[nt][rr * 2 + 1] * sc);
    }
  }
}

// grid (ceil(Sk / Bc) x head_splits, Hkv, B), 4 warps: dK and dV of Bc
// keys of kv head hk (dkdv_keys), summed over the block's g / head_splits
// query heads and every live tile of their (query, head) pairs, in order.
// T float: the split body.
template <typename T, int DMAX, int DK, int DV>
__global__ void __launch_bounds__(kWarps * 32)
    attn_bwd_dkdv_mma_kernel(BwdParams p) {
  extern __shared__ __align__(16) char mma_smem[];
  char* smem = mma_smem;
  constexpr bool kSplit = std::is_same_v<T, float>;
  constexpr int CS = col_split(DMAX);
  constexpr int NP = DMAX / CS / 16;   // 16-column groups of a warp's part
  constexpr int S = walk_stages(DMAX);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  constexpr int keys = dkdv_keys(DMAX);
  const int hs = p.head_splits, gs = p.g / hs;
  const int kt = blockIdx.x / hs, split = blockIdx.x % hs;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * keys, nk = min(keys, p.Sk - k0);
  const int h0 = hk * p.g + split * gs;      // the block's first query head
  const int D = DK > 0 ? DK : p.D, Dv = DV > 0 ? DV : p.Dv;
  const int DP = round16(D), DVP = round16(Dv);
  const DkdvSmem L(D, Dv, sizeof(T));
  char* ks = smem;
  char* vs = smem + keys * L.kstr;
  char* stages = smem + L.kv;
  int* kpos = reinterpret_cast<int*>(smem + L.misc());

  // K and V rows and positions of the block's keys, and the positions of
  // the walk's first window of pairs: every load in flight at once
  {
    const long long row0 = ((long long)b * p.Sk + k0) * p.Hkv + hk;
    auto key_off = [&](int r) -> long long { return row0 + (long long)r * p.Hkv; };
    RowCopy(D, sizeof(T)).run(ks, L.kstr, static_cast<const T*>(p.k), nk,
                              keys, key_off);
    RowCopy(Dv, sizeof(T)).run(vs, L.vstr, static_cast<const T*>(p.v), nk,
                               keys, key_off);
    cp_async_commit();
  }
  Walk w;
  w.win = kpos + keys;
  w.bits = w.win + kWinTiles * kWalkN;
  w.pos = p.q_pos + (long long)b * p.Sq;
  w.n = p.Sq * gs;
  w.div = gs;
  w.tiles = (w.n + kWalkN - 1) / kWalkN;
  w.window = p.window;
  w.keys = false;
  int ps[kWinPer];
  w.load(0, ps);
  for (int i = tid; i < keys; i += blockDim.x)
    kpos[i] = i < nk ? p.k_pos[(long long)b * p.Sk + k0 + i] : -1;
  __syncthreads();
  bool keys_full;
  span(kpos, keys, w.lo, w.hi, keys_full);
  if (w.hi < 0) w.tiles = 0;               // no valid key: zeros
  w.mark(ps);
  __syncthreads();
  w.gather();

  const int kg = warp / CS, part = warp % CS;
  const int kr[2] = {kpos[kg * 16 + gid], kpos[kg * 16 + gid + 8]};
  const bool has_keys = kg * 16 < nk;
  const int cwk = col_part(DP, CS), cwv = col_part(DVP, CS);
  const int ck0 = part * cwk, cv0 = part * cwv;
  const float cap = p.softcap;
  const float to2 = cap > 0.f ? kLog2e : p.scale * kLog2e;
  float dk[NP * 2][4], dv[NP * 2][4];
#pragma unroll
  for (int i = 0; i < NP * 2; ++i)
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = dv[i][0] = dv[i][1] =
        dv[i][2] = dv[i][3] = 0.f;

  // pair pr: query pr / gs, head h0 + pr % gs
  auto pair_off = [&](int pr) -> long long {
    const int qi = gs == 1 ? pr : pr / gs;
    return ((long long)b * p.Sq + qi) * p.Hq + h0 + pr - qi * gs;
  };
  // Q and dO rows of pair tile t, its lse, D and positions, and whether
  // every pair sees every key of the block
  auto issue = [&](int t, char* st) {
    const int pr0 = t * kWalkN;
    const int np = min(kWalkN, w.n - pr0);
    auto off = [&](int r) -> long long { return pair_off(pr0 + r); };
    RowCopy(D, sizeof(T)).run(st, L.kstr, static_cast<const T*>(p.q), np,
                              kWalkN, off);
    RowCopy(Dv, sizeof(T)).run(st + kWalkN * L.kstr, L.vstr,
                               static_cast<const T*>(p.dout), np, kWalkN,
                               off);
    float* sl = reinterpret_cast<float*>(st + kWalkN * (L.kstr + L.vstr));
    int* sp = reinterpret_cast<int*>(sl + 2 * kWalkN);
    if (tid < kWalkN) {
      const bool ok = tid < np;
      long long i = 0;
      if (ok) {
        const int pr = pr0 + tid, qi = pr / gs;
        i = ((long long)b * p.Hq + h0 + pr - qi * gs) * p.Sq + qi;
      }
      cp_async4(sl + tid, p.lse + i, ok);
      cp_async4(sl + kWalkN + tid, p.delta + i, ok);
      const int qp = w.at(t, tid);
      sp[tid] = qp;
      const bool full = __all_sync(~0u, w.whole(qp)) && keys_full;
      if (tid == 0) sp[kWalkN] = full;
    }
  };
  Ring<S, decltype(issue)> ring(w, stages, L.stage, issue);
  ring.start();
  // at a head dim of 64 the warp's K and V fragments stay in registers for
  // the whole walk (above it dK and dV leave no room); fp32 holds K's parts
  // (V's are cut from shared memory every tile: both would pass 255
  // registers)
  constexpr bool HOLD = !kSplit && DMAX <= 64;
  constexpr bool HOLD_SPLIT = kSplit && DMAX <= 64;
  uint32_t kf[HOLD ? DMAX / 16 : 1][4], vf[HOLD ? DMAX / 16 : 1][4];
  uint32_t kh[HOLD_SPLIT ? DMAX / 16 : 1][kSplitParts][4];
  if constexpr (HOLD || HOLD_SPLIT) {
    cp_async_wait<S - 1>();                // K and V have landed
    __syncthreads();
  }
  if constexpr (HOLD) {
    frags_a(kf, ks + kg * 16 * L.kstr, L.kstr, DP);
    frags_a(vf, vs + kg * 16 * L.vstr, L.vstr, DVP);
  }
  if constexpr (HOLD_SPLIT)
    split_rows_a(kh, reinterpret_cast<const float*>(ks + kg * 16 * L.kstr),
                 L.kstr / 4, DP);
  ring.run([&](const char* sq) {
    if (!has_keys) return;
    const char* sdo = sq + kWalkN * L.kstr;
    const float* sl = reinterpret_cast<const float*>(sdo + kWalkN * L.vstr);
    const int* sp = reinterpret_cast<const int*>(sl + 2 * kWalkN);
    const bool full = sp[kWalkN] != 0;
    float s[4][4], dp[4][4];
    // S^T = K Q^T, dP^T = V dO^T: 16 keys x 32 pairs a warp
    if constexpr (kSplit) {
      const float* qf = reinterpret_cast<const float*>(sq);
      if constexpr (HOLD_SPLIT)
        mma_abt_split(s, kh, qf, L.kstr / 4, DP);
      else
        mma_abt_split<DMAX>(
            s, reinterpret_cast<const float*>(ks + kg * 16 * L.kstr),
            L.kstr / 4, qf, L.kstr / 4, DP);
      mma_abt_split<DMAX>(
          dp, reinterpret_cast<const float*>(vs + kg * 16 * L.vstr),
          L.vstr / 4, reinterpret_cast<const float*>(sdo), L.vstr / 4, DVP);
    } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i / 4][i % 4] = dp[i / 4][i % 4] = 0.f;
    if constexpr (HOLD) {
      mma_abt<T>(s, kf, sq, L.kstr, DP);
      mma_abt<T>(dp, vf, sdo, L.vstr, DVP);
    } else {
      mma_abt<T, DMAX>(s, ks + kg * 16 * L.kstr, L.kstr, sq, L.kstr, DP);
      mma_abt<T, DMAX>(dp, vs + kg * 16 * L.vstr, L.vstr, sdo, L.vstr, DVP);
    }
    }
    auto l2f = [&](int, int c) { return sl[c] * kLog2e; };
    auto dlf = [&](int, int c) { return sl[kWalkN + c]; };
    auto vis = [&](int rr, int c) {
      return visible(kr[rr], sp[c], p.window);
    };
    probs_of(cap > 0.f, full, s, dp, p.scale, cap, to2, l2f, dlf, vis);
    // dV += P^T dO, dK += dS^T Q: this warp's columns
    if constexpr (kSplit) {
      mma_xb_split<NP, parts_whole(DV, CS)>(
          dv, s, reinterpret_cast<const float*>(sdo), L.vstr / 4, cv0, cwv,
          DVP);
      mma_xb_split<NP, parts_whole(DK, CS)>(
          dk, dp, reinterpret_cast<const float*>(sq), L.kstr / 4, ck0, cwk,
          DP);
    } else {
      mma_xb<T, NP, parts_whole(DV, CS)>(dv, s, sdo, L.vstr, cv0, cwv, DVP);
      mma_xb<T, NP, parts_whole(DK, CS)>(dk, dp, sq, L.kstr, ck0, cwk, DP);
    }
  });
  if (!has_keys) return;
  const float sc = p.scale;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = kg * 16 + gid + rr * 8;
    if (key >= nk) continue;
    const long long row = ((long long)b * p.Sk + k0 + key) * p.Hkv + hk;
    T* dkr = static_cast<T*>(p.dk) + row * D;
    T* dvr = static_cast<T*>(p.dv) + row * Dv;
    float* part_r = hs > 1 ? p.part + (row * hs + split) * (D + Dv) : nullptr;
#pragma unroll
    for (int nt = 0; nt < NP * 2; ++nt) {
      const int c = ck0 + nt * 8 + tig * 2;
      if (nt * 8 < cwk && c < D) {
        const float x = dk[nt][rr * 2] * sc, y = dk[nt][rr * 2 + 1] * sc;
        if (part_r)
          *reinterpret_cast<float2*>(part_r + c) = make_float2(x, y);
        else
          store2<T>(dkr + c, x, y);
      }
      const int cv = cv0 + nt * 8 + tig * 2;
      if (nt * 8 < cwv && cv < Dv) {
        const float x = dv[nt][rr * 2], y = dv[nt][rr * 2 + 1];
        if (part_r)
          *reinterpret_cast<float2*>(part_r + D + cv) = make_float2(x, y);
        else
          store2<T>(dvr + cv, x, y);
      }
    }
  }
}

// One thread per two columns of a (batch row, key, kv head) row of dK | dV:
// the head splits' fp32 partials (B, Sk, Hkv, head_splits, D + Dv) added
// in split order.
template <typename T>
__global__ void __launch_bounds__(256) attn_bwd_dkdv_sum_kernel(BwdParams p) {
  const int W = p.D + p.Dv, half = W / 2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)p.B * p.Sk * p.Hkv * half) return;
  const long long row = i / half;
  const int c = (int)(i - row * half) * 2;
  const float* src = p.part + row * p.head_splits * W + c;
  float x = 0.f, y = 0.f;
  for (int s = 0; s < p.head_splits; ++s) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(src + (long long)s * W));
    x += v.x;
    y += v.y;
  }
  if (c < p.D)
    store2<T>(static_cast<T*>(p.dk) + row * p.D + c, x, y);
  else
    store2<T>(static_cast<T*>(p.dv) + row * p.Dv + c - p.D, x, y);
}

template <typename T, int DMAX, int DK, int DV>
cudaError_t launch_mma_body(const BwdParams& p, const BwdPlan& plan,
                            cudaStream_t stream) {
  const int hs = p.head_splits;
  if (plan.block_keys != dkdv_keys(DMAX) || plan.dq_rows != kDqRows ||
      hs < 1 || p.g % hs || (hs > 1 && p.part == nullptr) ||
      plan.smem_dq < DqSmem(p.D, p.Dv, sizeof(T)).total() ||
      plan.smem_dkdv < DkdvSmem(p.D, p.Dv, sizeof(T)).total() ||
      plan.smem_dq > (int)kMaxSmem || plan.smem_dkdv > (int)kMaxSmem)
    return cudaErrorInvalidValue;
  auto dq_kernel = attn_bwd_dq_mma_kernel<T, DMAX, DK, DV>;
  auto dkdv_kernel = attn_bwd_dkdv_mma_kernel<T, DMAX, DK, DV>;
  cudaError_t e = opt_in_smem((const void*)dq_kernel, plan.smem_dq);
  if (e == cudaSuccess)
    e = opt_in_smem((const void*)dkdv_kernel, plan.smem_dkdv);
  if (e != cudaSuccess) return e;
  if (p.Sq > 0) {
    // dQ first: its blocks also write D, which the dK/dV blocks read
    const dim3 grid((p.Sq * p.g + plan.dq_rows - 1) / plan.dq_rows, p.Hkv,
                    p.B);
    dq_kernel<<<grid, kWarps * 32, plan.smem_dq, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (p.Sk > 0) {
    const dim3 grid((p.Sk + plan.block_keys - 1) / plan.block_keys * hs,
                    p.Hkv, p.B);
    dkdv_kernel<<<grid, kWarps * 32, plan.smem_dkdv, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (hs > 1) {
      const long long n = (long long)p.B * p.Sk * p.Hkv * ((p.D + p.Dv) / 2);
      attn_bwd_dkdv_sum_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0,
                                    stream>>>(p);
    }
  }
  return cudaGetLastError();
}

// The kernels for (D, Dv): fixed-dim ones at the train shapes' head dims
// (64, 128, 256 and MLA's 192 / 128; fp32: 64, the fp32 train step's),
// else the bucket's general ones.
template <typename T>
cudaError_t launch_mma(const BwdParams& p, const BwdPlan& plan,
                       cudaStream_t stream) {
  if (p.B == 0 || (p.Sq == 0 && p.Sk == 0)) return cudaSuccess;
  if (p.D == p.Dv && p.D == 64)
    return launch_mma_body<T, 64, 64, 64>(p, plan, stream);
  if constexpr (!std::is_same_v<T, float>) {
    if (p.D == p.Dv && p.D == 128)
      return launch_mma_body<T, 128, 128, 128>(p, plan, stream);
    if (p.D == p.Dv && p.D == 256)
      return launch_mma_body<T, 256, 256, 256>(p, plan, stream);
    if (p.D == 192 && p.Dv == 128)
      return launch_mma_body<T, 256, 192, 128>(p, plan, stream);
  }
  switch (bwd_dmax(p.D, p.Dv)) {
    case 64: return launch_mma_body<T, 64, 0, 0>(p, plan, stream);
    case 128: return launch_mma_body<T, 128, 0, 0>(p, plan, stream);
    default: return launch_mma_body<T, 256, 0, 0>(p, plan, stream);
  }
}

// One kernel's table entries: dQ's and dK/dV's at (T, d, dk, dv)
#define BWD_MMA_ENTRIES(T, tn, d, dk, dv)                                  \
  {"attn_bwd_dq_mma_kernel<" tn ", " #d ", " #dk ", " #dv ">",            \
   (const void*)attn_bwd_dq_mma_kernel<T, d, dk, dv>},                    \
  {"attn_bwd_dkdv_mma_kernel<" tn ", " #d ", " #dk ", " #dv ">",          \
   (const void*)attn_bwd_dkdv_mma_kernel<T, d, dk, dv>}

}  // namespace
