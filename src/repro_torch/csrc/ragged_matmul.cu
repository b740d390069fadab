// Grouped (ragged) matrix product for Hopper (sm_90a), bound to PyTorch
// through a plain C interface (ctypes); see
// repro_torch/kernels/ragged_matmul.py.
//
// Replaces no Pallas kernel.  The reference's moe_apply_ragged
// (src/repro/models/moe.py, REPRO_PERF_OPTS=moe_ragged) computes its three
// expert products with XLA's jax.lax.ragged_dot, outside Pallas:
//
//     out (R, Nout) = rows (R, Kin) x B_e  for the rows of group e,
//
// the rows sorted by group: group e owns rows [off_e, off_e + sizes_e),
// off the exclusive prefix sum of sizes (int32, on the device); rows past
// the last group come out zero.  Two products of one kernel template:
//
//  * ragged_mm_kernel<T, false>: B_e = w[e] (K, N), the forward;
//  * ragged_mm_kernel<T, true>: B_e = w[e]^T, read in w's own layout: the
//    gradient of rows, dOut (R, N) x w[e]^T -> (R, K).
//
// and one more for the gradient of w:
//
//  * ragged_dw_kernel<T>: dw[e] (K, N) = rows_e^T dOut_e, summed over the
//    group's rows in order; an expert with no rows gets zeros.
//
// What bounds it: at a decode step each routed expert owns about one row
// (8 slots x top-8 = 64 rows over 128 or 256 experts), so the product is a
// weight-streaming GEMV per expert, bound by the bytes of the experts that
// received rows.  The point of the design is that an expert with no rows
// gets no tile and its weights are never read: each block of
// ragged_mm_kernel finds its work on the device (a scan of sizes into
// per-expert 16-row tile counts, then a binary search of its tile index
// in their prefix), the host sizes the grid to the static bound
// ceil(R / 16) + min(E, R) row tiles x ceil(Nout / 64) column tiles, and a
// block past the last real tile exits at once.  Nothing is read back to
// the host.  A 16-row tile reads its expert's (Kin x 64) weight slab once
// through a four-stage cp.async ring; the row tiles of one expert run
// next to each other in the grid and share the slab in L2.
//
// Bodies by dtype (one of each template, no fallback):
//  * bf16 / fp16: mma.sync.m16n8k16 with fp32 accumulators, A by ldmatrix,
//    B by ldmatrix (.trans for the row-major forward slab and for dOut),
//    4 warps of 16 output columns each (ragged_mm) or 16 rows of dw each
//    (ragged_dw); each 64-deep K tile (32 rows for dw) sums into fresh
//    accumulators added to the running ones with round-to-nearest adds
//    (the tensor cores' own accumulation truncates).
//  * fp32: CUDA-core FMA tiles (a tensor-core body would multiply in TF32,
//    and the card's fp32 greedy streams must equal the CPU's); each thread
//    owns 8 (ragged_mm) or 32 (ragged_dw) outputs of one column, each K
//    tile (row chunk) summed apart and added to the running sums.
//
// No atomics: every output is written by one block, in a fixed order, so
// two calls give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dtype.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;     // 4 warps
constexpr int kBM = 16;           // rows of a ragged_mm tile
constexpr int kBN = 64;           // output columns of a tile
constexpr int kStages = 4;
constexpr int kMaxSmem = 232448;

template <typename T>
struct Tile {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int kBK = kF32 ? 32 : 64;      // ragged_mm K tile
  static constexpr int kBR = kF32 ? 16 : 32;      // ragged_dw rows a chunk
  // 16-bit tiles: rows of 64 + 8 elements (144 bytes: the 8 rows one
  // ldmatrix reads fall in distinct banks)
  static constexpr int kS = 64 + 8;
  // ragged_mm stage: A (16 x kBK), B (64 x 64 as [k][n] or [n][k]); fp32:
  // A^T [kBK][16], B [kBK][65]
  static constexpr int kABytes = kF32 ? kBK * kBM * 4 : kBM * kS * 2;
  static constexpr int kBBytes = kF32 ? kBK * (kBN + 1) * 4 : 64 * kS * 2;
  static constexpr int kMmStage = kABytes + kBBytes;
  // ragged_dw stage: rows (kBR x 64 of K) and dOut (kBR x 64 of N)
  static constexpr int kDwHalf = kF32 ? kBR * 64 * 4 : kBR * kS * 2;
  static constexpr int kDwStage = 2 * kDwHalf;
};

__host__ __device__ inline int cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// s[0..n]: exclusive prefix sums of v(0..n-1), s[n] the total; every
// thread of the block calls it.  Each thread sums a run of consecutive
// entries, the runs are scanned across the block, then written out.
template <typename F>
__device__ void block_scan(int* s, int n, F v) {
  __shared__ int warp_tot[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = cdiv(n, kThreads), b = threadIdx.x * per;
  const int end = min(n, b + per);
  int local = 0;
  for (int i = b; i < end; ++i) local += v(i);
  int x = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_tot[w];
  int run = before + x - local;
  for (int i = b; i < end; ++i) {
    s[i] = run;
    run += v(i);
  }
  if (threadIdx.x == kThreads - 1) s[n] = run;
  __syncthreads();
}

// The rows of group e within [0, R): sizes clamped to [0, R], their
// prefix clamped to R
__device__ __forceinline__ int clamped_size(const int* sizes, int e, int R) {
  return min(max(sizes[e], 0), R);
}

__device__ __forceinline__ int warp_sum_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

struct RmArgs {
  const void* a;      // (R, Kin)
  const void* w;      // (E, K, N)
  const int* sizes;   // (E,)
  void* out;          // (R, Nout)
  int R, E, K, N;
  int vec;            // 16-bit: K, N multiples of 8 and 16-byte pointers
};

// ---------------------------------------------------------------------------
// ragged_mm: stage loads
// ---------------------------------------------------------------------------

// Request rows [m0, m0 + rows) x [k0, k0 + kBK) of a and the (kBK x 64)
// slab of B_e at (k0, n0) into stage st (zeros out of range).
template <typename T, bool kTransB>
__device__ __forceinline__ void mm_fetch(const RmArgs& a, char* st, int e,
                                         int m0, int rows, int k0, int n0) {
  using TL = Tile<T>;
  constexpr int kBK = TL::kBK;
  const int Kin = kTransB ? a.N : a.K, Nout = kTransB ? a.K : a.N;
  const T* A = static_cast<const T*>(a.a);
  const T* W = static_cast<const T*>(a.w) + (long long)e * a.K * a.N;
  if constexpr (TL::kF32) {
    float* sA = reinterpret_cast<float*>(st);               // [k][16]
    float* sB = reinterpret_cast<float*>(st + TL::kABytes);  // [k][65]
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int m = i % kBM, k = i / kBM;
      const bool ok = m < rows && k0 + k < Kin;
      cp_async4(sA + k * kBM + m,
                ok ? A + (long long)(m0 + m) * Kin + k0 + k : A, ok);
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      // read along w's contiguous dim; B[k][n] lands at sB[k * 65 + n]
      int k, n;
      long long src;
      if (kTransB) {
        n = i / kBK, k = i % kBK;
        src = (long long)(n0 + n) * a.N + k0 + k;
      } else {
        k = i / kBN, n = i % kBN;
        src = (long long)(k0 + k) * a.N + n0 + n;
      }
      const bool ok = k0 + k < Kin && n0 + n < Nout;
      cp_async4(sB + k * (kBN + 1) + n, ok ? W + src : W, ok);
    }
  } else {
    T* sA = reinterpret_cast<T*>(st);
    T* sB = reinterpret_cast<T*>(st + TL::kABytes);
    constexpr int kS = TL::kS;
    if (a.vec) {
      for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
        const int m = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
        const bool ok = m < rows && k0 + c < Kin;
        cp_async16(sA + m * kS + c,
                   ok ? A + (long long)(m0 + m) * Kin + k0 + c : A, ok);
      }
      // 64 rows of 8 chunks: [k][n] (forward) or [n][k] (transposed), the
      // contiguous dim of w being N either way
      for (int i = threadIdx.x; i < 64 * 8; i += kThreads) {
        const int r = i / 8, c = (i % 8) * 8;
        const bool ok = kTransB ? n0 + r < a.K && k0 + c < a.N
                                : k0 + r < a.K && n0 + c < a.N;
        const long long src = kTransB ? (long long)(n0 + r) * a.N + k0 + c
                                      : (long long)(k0 + r) * a.N + n0 + c;
        cp_async16(sB + r * kS + c, ok ? W + src : W, ok);
      }
    } else {
      for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
        const int m = i / kBK, c = i % kBK;
        sA[m * kS + c] = m < rows && k0 + c < Kin
                             ? A[(long long)(m0 + m) * Kin + k0 + c]
                             : from_f<T>(0.f);
      }
      for (int i = threadIdx.x; i < 64 * 64; i += kThreads) {
        const int r = i / 64, c = i % 64;
        const bool ok = kTransB ? n0 + r < a.K && k0 + c < a.N
                                : k0 + r < a.K && n0 + c < a.N;
        const long long src = kTransB ? (long long)(n0 + r) * a.N + k0 + c
                                      : (long long)(k0 + r) * a.N + n0 + c;
        sB[r * kS + c] = ok ? W[src] : from_f<T>(0.f);
      }
    }
  }
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// ragged_mm
// ---------------------------------------------------------------------------

// grid (ceil(R / 16) + min(E, R), ceil(Nout / 64)), 128 threads; dynamic
// shared memory: the ring, then the prefix arrays off[E + 1] and
// tile[E + 1].  blockIdx.x is a 16-row tile of one group (a group of s
// rows has ceil(s / 16)), in group order, then the zero tiles of rows
// past the last group; blockIdx.y the 64 output columns.
template <typename T, bool kTransB>
__global__ void __launch_bounds__(kThreads)
    ragged_mm_kernel(RmArgs a) {
  using TL = Tile<T>;
  constexpr int kBK = TL::kBK;
  extern __shared__ __align__(16) char smem[];
  int* s_off = reinterpret_cast<int*>(smem + kStages * TL::kMmStage);
  int* s_tile = s_off + a.E + 1;
  const int R = a.R, E = a.E;
  const int Kin = kTransB ? a.N : a.K, Nout = kTransB ? a.K : a.N;
  block_scan(s_off, E, [&](int e) { return clamped_size(a.sizes, e, R); });
  block_scan(s_tile, E, [&](int e) {
    return cdiv(min(s_off[e + 1], R) - min(s_off[e], R), kBM);
  });
  const int t = blockIdx.x, total = s_tile[E];
  const int tail_begin = min(s_off[E], R);
  if (t >= total + cdiv(R - tail_begin, kBM)) return;
  // the group of tile t: the last e with s_tile[e] <= t (E: the tail)
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_tile[mid] <= t) lo = mid; else hi = mid - 1;
  }
  const int e = lo;
  const int g0 = min(s_off[e], R);
  const int g1 = e < E ? min(s_off[e + 1], R) : R;
  const int m0 = g0 + (t - s_tile[e]) * kBM;
  const int rows = min(kBM, g1 - m0);
  const int n0 = blockIdx.y * kBN;
  T* out = static_cast<T*>(a.out);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (e == E) {                    // rows past the last group: zeros
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int m = i / kBN, n = n0 + i % kBN;
      if (m < rows && n < Nout)
        out[(long long)(m0 + m) * Nout + n] = from_f<T>(0.f);
    }
    return;
  }

  const int ntiles = cdiv(Kin, kBK);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles)
      mm_fetch<T, kTransB>(a, smem + s * TL::kMmStage, e, m0, rows,
                           s * kBK, n0);
    else
      cp_async_commit();
  }

  if constexpr (TL::kF32) {
    const int n = tid & 63, mg = (tid >> 6) * 8;
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ntiles; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int nxt = kt + kStages - 1;
      if (nxt < ntiles)
        mm_fetch<T, kTransB>(a, smem + (nxt % kStages) * TL::kMmStage, e, m0,
                             rows, nxt * kBK, n0);
      else
        cp_async_commit();
      const char* st = smem + (kt % kStages) * TL::kMmStage;
      const float* sA = reinterpret_cast<const float*>(st);
      const float* sB = reinterpret_cast<const float*>(st + TL::kABytes);
      // the tile's sums apart, then added to the running ones: one chain
      // of K FMAs would cost ~sqrt(K / kBK) times the rounding error
      float t[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) t[i] = 0.f;
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(sA + k * kBM + mg);
        const float4 a1 =
            *reinterpret_cast<const float4*>(sA + k * kBM + mg + 4);
        const float b = sB[k * (kBN + 1) + n];
        t[0] = fmaf(a0.x, b, t[0]);
        t[1] = fmaf(a0.y, b, t[1]);
        t[2] = fmaf(a0.z, b, t[2]);
        t[3] = fmaf(a0.w, b, t[3]);
        t[4] = fmaf(a1.x, b, t[4]);
        t[5] = fmaf(a1.y, b, t[5]);
        t[6] = fmaf(a1.z, b, t[6]);
        t[7] = fmaf(a1.w, b, t[7]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += t[i];
    }
    cp_async_wait<0>();
    if (n0 + n < Nout) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (mg + i < rows) out[(long long)(m0 + mg + i) * Nout + n0 + n] =
                               acc[i];
    }
  } else {
    constexpr int kS = TL::kS;
    const int gid = lane >> 2, tig = lane & 3;
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i / 4][i % 4] = 0.f;
    for (int kt = 0; kt < ntiles; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int nxt = kt + kStages - 1;
      if (nxt < ntiles)
        mm_fetch<T, kTransB>(a, smem + (nxt % kStages) * TL::kMmStage, e, m0,
                             rows, nxt * kBK, n0);
      else
        cp_async_commit();
      const char* st = smem + (kt % kStages) * TL::kMmStage;
      const T* sA = reinterpret_cast<const T*>(st);
      const T* sB = reinterpret_cast<const T*>(st + TL::kABytes);
      float tacc[2][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) tacc[i / 4][i % 4] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t af[4], bf[4];
        ldsm_x4(af, sA + (lane & 15) * kS + ks * 16 + (lane >> 4) * 8);
        if (kTransB)         // sB[n][k]: warp's 16 columns, k contiguous
          ldsm_x4(bf, sB + (16 * warp + (lane & 7) + (lane >> 4) * 8) * kS +
                          ks * 16 + ((lane >> 3) & 1) * 8);
        else                 // sB[k][n]
          ldsm_x4_t(bf, sB + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 kS + 16 * warp + (lane >> 4) * 8);
        mma16816<T>(tacc[0], af, bf[0], bf[1]);
        mma16816<T>(tacc[1], af, bf[2], bf[3]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i / 4][i % 4] += tacc[i / 4][i % 4];
    }
    cp_async_wait<0>();
    // fragment f of n-tile j: row gid (+ 8 for f >= 2), column
    // 16 warp + 8 j + 2 tig (+ 1 for odd f)
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const int j = f / 4, x = f % 4;
      const int m = gid + (x >= 2 ? 8 : 0);
      const int n = n0 + 16 * warp + 8 * j + 2 * tig + (x & 1);
      if (m < rows && n < Nout)
        out[(long long)(m0 + m) * Nout + n] = from_f<T>(acc[j][x]);
    }
  }
}

// ---------------------------------------------------------------------------
// ragged_dw
// ---------------------------------------------------------------------------

struct DwArgs {
  const void* a;      // rows (R, K)
  const void* d;      // dOut (R, N)
  const int* sizes;   // (E,)
  void* dw;           // (E, K, N)
  int R, E, K, N;
  int vec;
};

// Request rows [r0, r0 + kBR) (those below r1) of a's columns [k0, k0 + 64)
// and of d's columns [n0, n0 + 64) into stage st.
template <typename T>
__device__ __forceinline__ void dw_fetch(const DwArgs& a, char* st, int r0,
                                         int r1, int k0, int n0) {
  using TL = Tile<T>;
  constexpr int kBR = TL::kBR;
  const T* X = static_cast<const T*>(a.a);
  const T* D = static_cast<const T*>(a.d);
  T* sX = reinterpret_cast<T*>(st);
  T* sD = reinterpret_cast<T*>(st + TL::kDwHalf);
  if constexpr (TL::kF32) {
    for (int i = threadIdx.x; i < kBR * 64; i += kThreads) {
      const int r = i / 64, c = i % 64;
      const bool okr = r0 + r < r1;
      const bool okx = okr && k0 + c < a.K, okd = okr && n0 + c < a.N;
      cp_async4(sX + i, okx ? X + (long long)(r0 + r) * a.K + k0 + c : X,
                okx);
      cp_async4(sD + i, okd ? D + (long long)(r0 + r) * a.N + n0 + c : D,
                okd);
    }
  } else if (a.vec) {
    constexpr int kS = TL::kS;
    for (int i = threadIdx.x; i < kBR * 8; i += kThreads) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool okr = r0 + r < r1;
      const bool okx = okr && k0 + c < a.K, okd = okr && n0 + c < a.N;
      cp_async16(sX + r * kS + c,
                 okx ? X + (long long)(r0 + r) * a.K + k0 + c : X, okx);
      cp_async16(sD + r * kS + c,
                 okd ? D + (long long)(r0 + r) * a.N + n0 + c : D, okd);
    }
  } else {
    constexpr int kS = TL::kS;
    for (int i = threadIdx.x; i < kBR * 64; i += kThreads) {
      const int r = i / 64, c = i % 64;
      const bool okr = r0 + r < r1;
      sX[r * kS + c] = okr && k0 + c < a.K
                           ? X[(long long)(r0 + r) * a.K + k0 + c]
                           : from_f<T>(0.f);
      sD[r * kS + c] = okr && n0 + c < a.N
                           ? D[(long long)(r0 + r) * a.N + n0 + c]
                           : from_f<T>(0.f);
    }
  }
  cp_async_commit();
}

// grid (ceil(N / 64), ceil(K / 64), E), 128 threads: block (x, y, e)
// writes dw[e][64 y .. 64 y + 63][64 x .. 64 x + 63], the sum over group
// e's rows in chunks of kBR, in row order.
template <typename T>
__global__ void __launch_bounds__(kThreads) ragged_dw_kernel(DwArgs a) {
  using TL = Tile<T>;
  constexpr int kBR = TL::kBR;
  extern __shared__ __align__(16) char smem[];
  __shared__ int part[kThreads / 32][2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e = blockIdx.z, n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  // this group's rows: the sizes of the groups before it and its own
  int before = 0, own = 0;
  for (int i = tid; i < a.E; i += kThreads) {
    const int s = clamped_size(a.sizes, i, a.R);
    if (i < e) before += s;
    else if (i == e) own = s;
  }
  before = warp_sum_i(before);
  own = warp_sum_i(own);
  if (lane == 0) part[warp][0] = before, part[warp][1] = own;
  __syncthreads();
  long long b = 0, o = 0;
  for (int w = 0; w < kThreads / 32; ++w) b += part[w][0], o += part[w][1];
  const int r_begin = (int)(b < a.R ? b : a.R);
  const int r_end = (int)(b + o < a.R ? b + o : a.R);
  const int nchunks = max(0, cdiv(r_end - r_begin, kBR));
  T* dw = static_cast<T*>(a.dw) + (long long)e * a.K * a.N;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks)
      dw_fetch<T>(a, smem + s * TL::kDwStage, r_begin + s * kBR, r_end, k0,
                  n0);
    else
      cp_async_commit();
  }

  if constexpr (TL::kF32) {
    const int n = tid & 63, kg = (tid >> 6) * 32;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int nxt = c + kStages - 1;
      if (nxt < nchunks)
        dw_fetch<T>(a, smem + (nxt % kStages) * TL::kDwStage,
                    r_begin + nxt * kBR, r_end, k0, n0);
      else
        cp_async_commit();
      const char* st = smem + (c % kStages) * TL::kDwStage;
      const float* sX = reinterpret_cast<const float*>(st);
      const float* sD = reinterpret_cast<const float*>(st + TL::kDwHalf);
      float t[32];                  // the chunk's sums apart, as ragged_mm
#pragma unroll
      for (int i = 0; i < 32; ++i) t[i] = 0.f;
      for (int r = 0; r < kBR; ++r) {
        const float d = sD[r * 64 + n];
        const float4* xr = reinterpret_cast<const float4*>(sX + r * 64 + kg);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 x = xr[j];
          t[4 * j] = fmaf(x.x, d, t[4 * j]);
          t[4 * j + 1] = fmaf(x.y, d, t[4 * j + 1]);
          t[4 * j + 2] = fmaf(x.z, d, t[4 * j + 2]);
          t[4 * j + 3] = fmaf(x.w, d, t[4 * j + 3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += t[i];
    }
    cp_async_wait<0>();
    if (n0 + n < a.N) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + kg + i < a.K)
          dw[(long long)(k0 + kg + i) * a.N + n0 + n] = acc[i];
    }
  } else {
    constexpr int kS = TL::kS;
    const int gid = lane >> 2, tig = lane & 3;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i / 4][i % 4] = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int nxt = c + kStages - 1;
      if (nxt < nchunks)
        dw_fetch<T>(a, smem + (nxt % kStages) * TL::kDwStage,
                    r_begin + nxt * kBR, r_end, k0, n0);
      else
        cp_async_commit();
      const char* st = smem + (c % kStages) * TL::kDwStage;
      const T* sX = reinterpret_cast<const T*>(st);
      const T* sD = reinterpret_cast<const T*>(st + TL::kDwHalf);
      float tacc[8][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) tacc[i / 4][i % 4] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kBR / 16; ++ks) {
        // A = rows^T (16 of K from 16 warp x 16 rows): .trans of sX[r][k]
        uint32_t af[4];
        ldsm_x4_t(af, sX + (ks * 16 + (lane & 7) + (lane >> 4) * 8) * kS +
                          16 * warp + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bf[4];
          ldsm_x4_t(bf, sD + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 kS + 16 * jj + (lane >> 4) * 8);
          mma16816<T>(tacc[2 * jj], af, bf[0], bf[1]);
          mma16816<T>(tacc[2 * jj + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i / 4][i % 4] += tacc[i / 4][i % 4];
    }
    cp_async_wait<0>();
    // fragment x of n-tile j: K row 16 warp + gid (+ 8 for x >= 2),
    // column 8 j + 2 tig (+ 1 for odd x)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = i / 4, x = i % 4;
      const int k = k0 + 16 * warp + gid + (x >= 2 ? 8 : 0);
      const int n = n0 + 8 * j + 2 * tig + (x & 1);
      if (k < a.K && n < a.N)
        dw[(long long)k * a.N + n] = from_f<T>(acc[j][x]);
    }
  }
}

template <typename T>
int mm_smem(int E) {
  return kStages * Tile<T>::kMmStage + 2 * (E + 1) * (int)sizeof(int);
}

template <typename T, bool kTransB>
cudaError_t launch_mm(const RmArgs& a, cudaStream_t stream) {
  const int Nout = kTransB ? a.K : a.N;
  const dim3 grid(cdiv(a.R, kBM) + min(a.E, a.R), cdiv(Nout, kBN));
  const int smem = mm_smem<T>(a.E);
  cudaError_t e =
      opt_in_smem((const void*)ragged_mm_kernel<T, kTransB>, smem);
  if (e != cudaSuccess) return e;
  ragged_mm_kernel<T, kTransB><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const DwArgs& a, cudaStream_t stream) {
  const dim3 grid(cdiv(a.N, 64), cdiv(a.K, 64), a.E);
  const int smem = kStages * Tile<T>::kDwStage;
  cudaError_t e = opt_in_smem((const void*)ragged_dw_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  ragged_dw_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16, of a, w and out.  a (R,
// Kin), w (E, K, N), sizes (E,) int32, out (R, Nout), all contiguous;
// trans = 0: Kin = K, Nout = N (out = a_e w[e]); trans = 1: Kin = N, Nout =
// K (out = a_e w[e]^T).  R, E, Nout >= 1, K, N >= 0.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ragged_matmul_launch(const void* a, const void* w,
                                    const void* sizes, void* out, int dtype,
                                    int R, int E, int K, int N, int trans,
                                    void* stream) {
  const int Nout = trans ? K : N;
  if (dtype < 0 || dtype > 2 || R < 1 || E < 1 || K < 0 || N < 0 ||
      Nout < 1 || cdiv(Nout, kBN) > 65535 || (trans != 0 && trans != 1))
    return (int)cudaErrorInvalidValue;
  RmArgs args{a, w, static_cast<const int*>(sizes), out, R, E, K, N,
              K % 8 == 0 && N % 8 == 0 && aligned16(a) && aligned16(w)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype == 0 ? mm_smem<float>(E) : mm_smem<__half>(E)) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  switch (dtype * 2 + trans) {
    case 0: return (int)launch_mm<float, false>(args, st);
    case 1: return (int)launch_mm<float, true>(args, st);
    case 2: return (int)launch_mm<__half, false>(args, st);
    case 3: return (int)launch_mm<__half, true>(args, st);
    case 4: return (int)launch_mm<__nv_bfloat16, false>(args, st);
    default: return (int)launch_mm<__nv_bfloat16, true>(args, st);
  }
}

// dw (E, K, N) = per group e, rows_e^T (K, s_e) x dout_e (s_e, N); a (R,
// K), dout (R, N), sizes (E,) int32, all contiguous, of dtype as above.
// R >= 0, E, K, N >= 1.  Returns cudaGetLastError() after the launch.
extern "C" int ragged_matmul_dw_launch(const void* a, const void* dout,
                                       const void* sizes, void* dw,
                                       int dtype, int R, int E, int K, int N,
                                       void* stream) {
  if (dtype < 0 || dtype > 2 || R < 0 || E < 1 || E > 65535 || K < 1 ||
      N < 1 || cdiv(K, 64) > 65535)
    return (int)cudaErrorInvalidValue;
  DwArgs args{a, dout, static_cast<const int*>(sizes), dw, R, E, K, N,
              K % 8 == 0 && N % 8 == 0 && aligned16(a) && aligned16(dout)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_dw<float>(args, st);
    case 1: return (int)launch_dw<__half>(args, st);
    default: return (int)launch_dw<__nv_bfloat16>(args, st);
  }
}
