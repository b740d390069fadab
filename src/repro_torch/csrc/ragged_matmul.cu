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
// the last group come out zero.  Two products of each forward kernel
// template (ragged_mm_tma_kernel, ragged_mm_kernel):
//
//  * <T, false>: B_e = w[e] (K, N), the forward;
//  * <T, true>: B_e = w[e]^T, read in w's own layout: the gradient of rows,
//    dOut (R, N) x w[e]^T -> (R, K).
//
// and one more kernel for the gradient of w (ragged_dw_tma_kernel,
// ragged_dw_kernel): dw[e] (K, N) = rows_e^T dOut_e, summed over the
// group's rows in order; an expert with no rows gets zeros.
//
// What bounds it: the bytes of the experts that received rows (at fp32
// twice as many).  At a decode
// step each routed expert owns about one row (8 slots x top-8 = 64 rows
// over 128 or 256 experts): a weight-streaming GEMV per expert.  At an
// 8 x 78 admission every expert owns ~20-60 rows (4,992 rows): still bound
// by reading each routed slab once.  dW at training sizes (~32 rows an
// expert) is bound by writing dw (all E experts, zeros included).  Only
// long prompts (~512 rows an expert) reach the tensor cores' bound.  An
// expert with no rows gets no work item and its weights are never read.
// Every block finds its work on the device (a block scan of the sizes,
// per-expert tile counts and their prefix, a binary search), so nothing
// is read back to the host.
//
// Bodies, chosen on the host by dtype, shape and alignment (the wrapper's
// ragged_body; each launcher refuses operands its body cannot take):
//
//  * wgmma + TMA (bf16 / fp16, K and N positive multiples of 8 -- TMA's
//    16-byte row strides -- and 16-byte aligned operands: every MoE width
//    of the eleven archs): ragged_mm_tma_kernel, ragged_dw_tma_kernel in
//    namespace wg.  Persistent blocks, two an SM (grid sized on the host
//    to the static bound on items), of one consumer warpgroup running
//    wgmma.m64n128k16 from shared memory and one producer warp starting
//    TMA loads into a 3-stage mbarrier ring (128-byte swizzled boxes;
//    tensor maps from cuTensorMapEncodeTiled, reached through the
//    runtime's cudaGetDriverEntryPoint: the library links without
//    -lcuda; wgmma.cuh).  A forward work item is one expert's 64 rows x
//    128 output columns, so an expert with up to 64 rows (every admission
//    of the smoke) reads its (K x 128) slab from device memory once a
//    product; a longer group's row tiles are adjacent items, run side by
//    side, and share the slab through L2.  The rows tile is loaded as only
//    as many 16-row boxes as the item has rows (a decode item: one).  The
//    output tile is staged in shared memory and written with 16-byte
//    stores, rows past the group's end (the next group's) masked.  dW's
//    work item is a 64 x 128 tile of dw[e] (all experts, e-major): the
//    group's rows arrive in chunks of up to 64 (16-row boxes of rows and
//    dOut from the group's first row), the rows past its end are zeroed
//    in shared memory in both operands and fenced for the async proxy
//    before wgmma reads them, and the tile is staged as bf16 / fp16 in the
//    swizzled layout and written by TMA stores, double-buffered so one
//    tile's stores drain while the next tile is summed (the store rate is
//    dW's bound).  An expert with no rows stores zeros, reads nothing.
//  * mma.sync (other bf16 / fp16 shapes: K or N off 8, unaligned
//    operands): ragged_mm_kernel / ragged_dw_kernel, 16-row tiles through
//    a four-stage cp.async ring, the grid at the static bound ceil(R / 16)
//    + min(E, R) row tiles x ceil(Nout / 64), a block past the last real
//    tile exiting at once; dW a block per 64 x 64 tile of each expert.
//  * wgmma + TMA at fp32 (K and N multiples of 4, 16-byte aligned: every
//    MoE width again): ragged_mm_f32_tma_kernel, ragged_dw_f32_tma_kernel,
//    the same items, producer and persistent blocks (one an SM: their
//    shared memory), TMA bringing raw fp32 tiles into a 2-stage ring; the
//    consumer warpgroup cuts each stage into three bf16 planes in the
//    swizzled layouts above and runs the six part pairs i + j < 3 on
//    wgmma, the leading pair's sums apart from the rest (each operand to
//    2^-24 of its size, the products' sums not truncated into the leading
//    one), so fp32 keeps its own accuracy (held to the plain version in
//    fp64 on the card); the output is written from the fragments.
//  * fp32 at other shapes: the mma.sync kernels' CUDA-core FMA tiles;
//    each thread owns 8 (ragged_mm) or 32 (ragged_dw) outputs of one
//    column, each K tile (row chunk) summed apart and added to the running
//    sums.
//
// Accumulation: fp32.  The 16-bit wgmma bodies sum every 4 stages (256 of
// K, or of dW's rows) into fresh accumulators (the first wgmma of each run
// with scale-d = 0) and add those sums to the running ones with
// round-to-nearest adds (the tensor cores' own accumulation truncates); the
// fp32 ones every stage; mma.sync does the same per 64-deep tile (32 rows
// for dW).  No split over K and no atomics:
// every output is written by one block, in a fixed order, so two calls
// give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "dtype.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

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
template <int kNT = kThreads, typename F>
__device__ void block_scan(int* s, int n, F v) {
  __shared__ int warp_tot[kNT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = cdiv(n, kNT), b = threadIdx.x * per;
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
  if (threadIdx.x == kNT - 1) s[n] = run;
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

// ---------------------------------------------------------------------------
// wgmma + TMA bodies (bf16 / fp16; K, N multiples of 8; 16-byte aligned)
// ---------------------------------------------------------------------------

namespace wg {
constexpr int kConsumers = 128;            // one warpgroup runs the wgmmas
constexpr int kThreads = kConsumers + 32;  // and one warp starts the loads
constexpr int kBM = 64;                    // rows of a forward work item
constexpr int kBN = 128;                   // output columns of an item
constexpr int kBK = 64;                    // depth of a stage (dw: rows)
constexpr int kPiece = 16;                 // rows of a 2-D operand box
constexpr int kStages = 3;
constexpr int kFresh = 4;                  // stages summed apart
constexpr int kBox = 64 * 128;             // 64 rows of 128 bytes
constexpr int kStage = 3 * kBox;           // A, then B as two boxes
constexpr int kOutStride = kBN + 8;        // staged forward row (elements)
constexpr int kMmOut = kBM * kOutStride * 2;
constexpr int kDwOut = 2 * kBox;           // one staged dw tile
constexpr int kBlocksPerSm = 2;

__device__ __forceinline__ char* align1k(char* p) {
  return reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

struct MmItem {
  int e, m0, rows, n0;   // e == E: rows past the last group (zeros)
};

// Work item i of the forward: for each expert with rows (in order), each
// tile of kBN output columns, each tile of kBM of its rows innermost, so
// the row tiles that read one weight slab run side by side (the slab comes
// from L2 for all but the first); then the zero tiles of the rows past the
// last group.  s_off: the groups' row offsets, s_tile: the prefix of their
// row-tile counts (both over E + 1 entries), NT: column tiles.
__device__ __forceinline__ MmItem mm_item(int i, const int* s_off,
                                          const int* s_tile, int E, int R,
                                          int NT) {
  MmItem it;
  const int q = i / NT;
  if (q < s_tile[E]) {
    int lo = 0, hi = E - 1;      // the last e with s_tile[e] <= q
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_tile[mid] <= q) lo = mid; else hi = mid - 1;
    }
    const int tiles = s_tile[lo + 1] - s_tile[lo];
    const int local = i - s_tile[lo] * NT;
    const int g1 = min(s_off[lo + 1], R);
    it.e = lo;
    it.n0 = local / tiles * kBN;
    it.m0 = min(s_off[lo], R) + local % tiles * kBM;
    it.rows = min(kBM, g1 - it.m0);
  } else {
    const int tail = min(s_off[E], R);
    const int tiles = cdiv(R - tail, kBM);
    const int local = i - s_tile[E] * NT;
    it.e = E;
    it.n0 = local / tiles * kBN;
    it.m0 = tail + local % tiles * kBM;
    it.rows = min(kBM, R - it.m0);
  }
  return it;
}

// Persistent blocks (the host sizes the grid to at most kBlocksPerSm an SM
// and the static bound on items), 160 threads: warps 0-3 run the wgmmas
// and the epilogue, lane 0 of warp 4 starts the TMA loads into a ring of
// kStages (A: the item's rows, as many 16-row boxes as it has rows; B: the
// weight slab's 64 x 128 tile as two boxes), both walking the same items.
// Forward: A (rows x k) K-major, B = w[e] (k x n) MN-major; kTransB (the
// gradient of rows): A = dOut (rows x n) K-major, B = w[e]^T, K-major.
// Each tile of 128 output columns is written by one block, its kFresh
// stages (256 deep) summed into fresh accumulators and those sums added in
// order; the bf16 / fp16 tile is staged in shared memory and written with
// 16-byte stores, rows past the group's end masked (the next group's).
template <typename T, bool kTransB>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    ragged_mm_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_w,
                         RmArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = align1k(smem_raw);
  T* so = reinterpret_cast<T*>(smem + kStages * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage +
                                               kMmOut);
  uint64_t* empty = full + kStages;
  int* s_off = reinterpret_cast<int*>(empty + kStages);
  int* s_tile = s_off + a.E + 1;
  const int R = a.R, E = a.E;
  const int Kin = kTransB ? a.N : a.K, Nout = kTransB ? a.K : a.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_init_fence();
  }
  block_scan<kThreads>(s_off, E,
                       [&](int e) { return clamped_size(a.sizes, e, R); });
  block_scan<kThreads>(s_tile, E, [&](int e) {
    return cdiv(min(s_off[e + 1], R) - min(s_off[e], R), kBM);
  });
  const int NT = cdiv(Nout, kBN), nk = cdiv(Kin, kBK);
  const int total = (s_tile[E] + cdiv(R - min(s_off[E], R), kBM)) * NT;

  if (warp == kConsumers / 32) {               // the producer
    if (lane != 0) return;
    int stage = 0, phase = 0;
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
      const MmItem it = mm_item(i, s_off, s_tile, E, R, NT);
      if (it.e == E) continue;
      const int pieces = cdiv(it.rows, kPiece);
      const bool b1 = it.n0 + 64 < Nout;     // the slab's second box
      const uint32_t bytes = pieces * kPiece * 128 + (b1 ? 2 : 1) * kBox;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty + stage, phase ^ 1);
        mbar_expect_tx(full + stage, bytes);
        char* st = smem + stage * kStage;
        char* sb = st + kBox;
        const int k0 = kt * kBK;
        for (int p = 0; p < pieces; ++p)
          tma_load_2d(st + p * kPiece * 128, &tm_a, full + stage, k0,
                      it.m0 + p * kPiece);
        if (kTransB) {
          tma_load_3d(sb, &tm_w, full + stage, k0, it.n0, it.e);
          if (b1)
            tma_load_3d(sb + kBox, &tm_w, full + stage, k0, it.n0 + 64,
                        it.e);
        } else {
          tma_load_3d(sb, &tm_w, full + stage, it.n0, k0, it.e);
          if (b1)
            tma_load_3d(sb + kBox, &tm_w, full + stage, it.n0 + 64, k0,
                        it.e);
        }
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  T* out = static_cast<T*>(a.out);
  const uint32_t base = smem_u32(smem);
  float acc[64], tacc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) tacc[j] = 0.f;
  int stage = 0, phase = 0;
  for (int i = blockIdx.x; i < total; i += gridDim.x) {
    const MmItem it = mm_item(i, s_off, s_tile, E, R, NT);
    if (it.e == E) {                  // rows past the last group: zeros
      for (int x = tid; x < kBM * (kBN / 8); x += kConsumers) {
        const int r = x / (kBN / 8), c = it.n0 + x % (kBN / 8) * 8;
        if (r < it.rows && c < Nout)
          *reinterpret_cast<uint4*>(out + (long long)(it.m0 + r) * Nout +
                                    c) = make_uint4(0, 0, 0, 0);
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;
    int held = -1;               // a stage whose wgmmas may still be running
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full + stage, phase);
      const uint32_t sa = base + stage * kStage, sb = sa + kBox;
      fence_regs(tacc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s) {
        const uint64_t da = gmma_desc(sa + s * 32, 16, 1024);
        const uint64_t db = kTransB ? gmma_desc(sb + s * 32, 16, 1024)
                                    : gmma_desc(sb + s * 2048, kBox, 1024);
        wgmma_m64n128k16<T, 0, kTransB ? 0 : 1>(
            tacc, da, db, kt % kFresh != 0 || s != 0);
      }
      wgmma_commit();
      const bool flush = kt % kFresh == kFresh - 1 || kt == nk - 1;
      if (flush)
        wgmma_wait<0>();
      else
        wgmma_wait<1>();
      fence_regs(tacc);
      if (held >= 0 && lane == 0) mbar_arrive(empty + held);
      held = stage;
      if (flush) {
        if (lane == 0) mbar_arrive(empty + stage);
        held = -1;
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[j] += tacc[j];
      }
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    // stage the tile (row r at kOutStride elements: the fragment writes
    // fall in distinct banks), then 16-byte stores of its rows in range
    named_bar_sync<kConsumers>(1);
    const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<uint32_t*>(so + r0 * kOutStride + 8 * j + c0) =
          pack2<T>(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(so + (r0 + 8) * kOutStride + 8 * j + c0) =
          pack2<T>(acc[4 * j + 2], acc[4 * j + 3]);
    }
    named_bar_sync<kConsumers>(1);
    for (int x = tid; x < kBM * (kBN / 8); x += kConsumers) {
      const int r = x / (kBN / 8), cc = x % (kBN / 8) * 8;
      if (r < it.rows && it.n0 + cc < Nout)
        *reinterpret_cast<uint4*>(out + (long long)(it.m0 + r) * Nout +
                                  it.n0 + cc) =
            *reinterpret_cast<const uint4*>(so + r * kOutStride + cc);
    }
  }
}

// dw: persistent blocks as above over the work items (e, 64 rows of dw's K,
// 128 of its N), e-major, every expert's tiles included.  The producer
// loads each item's group in chunks of up to 64 rows (16-row boxes: rows'
// 64 columns, dOut's 128), starting at the group's first row; the consumer
// zeroes the boxes' rows past the group's end (the next group's, or past R:
// zeros already) in all three boxes, fences them for the async proxy, and
// runs A = rows_e^T, B = dOut_e (both MN-major) over the chunk's 16-row
// steps, kFresh chunks (256 rows) summed apart.  The tile is staged as
// bf16 / fp16 in the 128-byte swizzled layout and written by two TMA
// stores, double-buffered: one tile's stores drain while the next tile is
// loaded and summed.  An expert with no rows loads nothing and stores
// zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    ragged_dw_tma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_d,
                         const __grid_constant__ CUtensorMap tm_dw,
                         DwArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = align1k(smem_raw);
  char* so = smem + kStages * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(so + 2 * kDwOut);
  uint64_t* empty = full + kStages;
  int* s_off = reinterpret_cast<int*>(empty + kStages);
  const int R = a.R, E = a.E;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_init_fence();
  }
  block_scan<kThreads>(s_off, E,
                       [&](int e) { return clamped_size(a.sizes, e, R); });
  const int NKt = cdiv(a.K, 64), NNt = cdiv(a.N, kBN);
  const int total = E * NKt * NNt;

  if (warp == kConsumers / 32) {               // the producer
    if (lane != 0) return;
    int stage = 0, phase = 0;
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
      const int e = i / (NKt * NNt), rem = i % (NKt * NNt);
      const int k0 = rem / NNt * 64, n0 = rem % NNt * kBN;
      const int g0 = min(s_off[e], R), g1 = min(s_off[e + 1], R);
      const bool b1 = n0 + 64 < a.N;
      for (int r0 = g0; r0 < g1; r0 += kBK) {
        const int pieces = cdiv(min(kBK, g1 - r0), kPiece);
        mbar_wait(empty + stage, phase ^ 1);
        mbar_expect_tx(full + stage, pieces * kPiece * 128 * (b1 ? 3 : 2));
        char* st = smem + stage * kStage;
        for (int p = 0; p < pieces; ++p) {
          const int off = p * kPiece * 128, y = r0 + p * kPiece;
          tma_load_2d(st + off, &tm_x, full + stage, k0, y);
          tma_load_2d(st + kBox + off, &tm_d, full + stage, n0, y);
          if (b1)
            tma_load_2d(st + 2 * kBox + off, &tm_d, full + stage, n0 + 64, y);
        }
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  const uint32_t base = smem_u32(smem);
  float acc[64], tacc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) tacc[j] = 0.f;
  int stage = 0, phase = 0, done = 0;
  for (int i = blockIdx.x; i < total; i += gridDim.x, ++done) {
    const int e = i / (NKt * NNt), rem = i % (NKt * NNt);
    const int k0 = rem / NNt * 64, n0 = rem % NNt * kBN;
    const int g0 = min(s_off[e], R), g1 = min(s_off[e + 1], R);
    const bool b1 = n0 + 64 < a.N;
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;
    for (int y0 = g0, c = 0; y0 < g1; y0 += kBK, ++c) {
      const int valid = min(kBK, g1 - y0), v16 = cdiv(valid, kPiece) * kPiece;
      mbar_wait(full + stage, phase);
      char* st = smem + stage * kStage;
      if (valid < v16) {           // the next group's rows: zeros
        const int per = (v16 - valid) * 8;   // 16-byte pieces a box
        for (int x = tid; x < per * (b1 ? 3 : 2); x += kConsumers)
          *reinterpret_cast<uint4*>(st + x / per * kBox +
                                    (valid + x % per / 8) * 128 +
                                    x % 8 * 16) = make_uint4(0, 0, 0, 0);
        fence_proxy_async();
        named_bar_sync<kConsumers>(1);
      }
      const uint32_t sa = base + stage * kStage, sb = sa + kBox;
      fence_regs(tacc);
      wgmma_fence();
      for (int s = 0; s < v16 / kPiece; ++s)
        wgmma_m64n128k16<T, 1, 1>(tacc, gmma_desc(sa + s * 2048, kBox, 1024),
                                  gmma_desc(sb + s * 2048, kBox, 1024),
                                  c % kFresh != 0 || s != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(tacc);
      if (lane == 0) mbar_arrive(empty + stage);
      if (c % kFresh == kFresh - 1 || y0 + kBK >= g1) {
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[j] += tacc[j];
      }
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    // stage the tile in the swizzled layout the store map reads (16-byte
    // piece q of row r at piece q ^ (r % 8): the fragment writes fall in
    // distinct banks), then two TMA stores of 64 x 64
    char* buf = so + (done & 1) * kDwOut;
    if (tid == 0) bulk_wait_read<1>();       // buf's last stores have read it
    named_bar_sync<kConsumers>(1);
    const int r0 = 16 * warp + (lane >> 2), c4 = (lane & 3) * 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      char* half = buf + (j >> 3) * kBox;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = r0 + 8 * x;
        *reinterpret_cast<uint32_t*>(half + r * 128 +
                                     ((j & 7) ^ (r & 7)) * 16 + c4) =
            pack2<T>(acc[4 * j + 2 * x], acc[4 * j + 2 * x + 1]);
      }
    }
    fence_proxy_async();
    named_bar_sync<kConsumers>(1);
    if (tid == 0) {
      tma_store_3d(&tm_dw, buf, n0, k0, e);
      if (b1) tma_store_3d(&tm_dw, buf + kBox, n0 + 64, k0, e);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// fp32 on wgmma: every operand tile as three bf16 parts
// ---------------------------------------------------------------------------
//
// The same persistent blocks, work items and producer as above, at fp32.
// TMA brings each stage's raw fp32 tiles (unswizzled boxes; K and N need
// only be multiples of 4 for 16-byte row strides) into a 2-stage ring; the
// consumer warpgroup cuts them into three bf16 planes each, in the 128-byte
// swizzled layouts the 16-bit bodies' descriptors read (split_tile), frees
// the raw stage, fences the planes for the async proxy and runs wgmma over
// the part pairs (i, j) with i + j < 3: six products a k16 step, the
// leading pair's into its own fresh accumulators, the other five into
// another, so that the tensor cores' truncating sums cost the fp32 result
// nothing (as flash attention's fp32 bodies do).  Both are added to the
// running sums, rounded to nearest, after every stage; no atomics, so two
// calls give the same bits.  Not TF32: its 10-bit products are too coarse
// for the fp32 gates.  The output is written from the fragments as fp32
// pairs (every 32-byte sector whole).  Shared memory: two raw stages of 48
// KB, one set of planes (72 KB): one block an SM.
constexpr int kSplitParts = 3;
constexpr int kF32Stages = 2;
constexpr int kRawA = 64 * 64 * 4;          // 64 rows x 64 fp32
constexpr int kRawB = 64 * 128 * 4;         // 64 x 128 (or 128 x 64) fp32
constexpr int kRawStage = kRawA + kRawB;
constexpr int kPlaneA = kBox;               // 64 rows x 64 bf16, swizzled
constexpr int kPlaneB = 2 * kBox;           // 64 x 128 (or 128 x 64)
constexpr int kF32Planes = kSplitParts * (kPlaneA + kPlaneB);
constexpr int kF32BlocksPerSm = 1;

// The raw fp32 tile at raw (rows of `cols` floats, cols 64 or 128), its
// first `rows` rows, as three bf16 planes at planes + p * plane_bytes in
// the swizzled layout of a tile of `plane_rows` rows of 64-element boxes
// (element (r, c) at box c / 64, row r, 16-byte piece (c % 64) / 8 ^ r %
// 8); rows from `valid` on come out zero.  Four values a thread a step:
// conflict-free 16-byte reads, 8-byte writes a plane.
__device__ __forceinline__ void split_tile(const char* raw, int cols,
                                           int plane_rows, int rows,
                                           int valid, char* planes,
                                           int plane_bytes) {
  const int per = cols / 4;
  for (int x = threadIdx.x; x < rows * per; x += kConsumers) {
    const int r = x / per, c = x % per * 4;
    const float4 f = r < valid
        ? *reinterpret_cast<const float4*>(raw + (r * cols + c) * 4)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    uint32_t a[kSplitParts], b[kSplitParts];
    split_bf16<kSplitParts>(f.x, f.y, a);
    split_bf16<kSplitParts>(f.z, f.w, b);
    const int off = (c >> 6) * plane_rows * 128 + r * 128 +
                    (((c & 63) >> 3) ^ (r & 7)) * 16 + (c & 7) * 2;
#pragma unroll
    for (int p = 0; p < kSplitParts; ++p)
      *reinterpret_cast<uint2*>(planes + p * plane_bytes + off) =
          make_uint2(a[p], b[p]);
  }
}

// One k16 step of the six part products: A part i's and B part j's
// descriptors are da + i * sa, db + j * sb (the plane strides >> 4, as the
// descriptors' address field counts 16-byte units); the leading pair into
// hi, the rest into lo, each starting fresh where `fresh` says.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_parts(float (&hi)[64], float (&lo)[64],
                                            uint64_t da, uint64_t db,
                                            uint64_t sa, uint64_t sb,
                                            bool fresh) {
  wgmma_m64n128k16<__nv_bfloat16, kTA, kTB>(hi, da, db, !fresh);
  wgmma_m64n128k16<__nv_bfloat16, kTA, kTB>(lo, da, db + sb, !fresh);
  wgmma_m64n128k16<__nv_bfloat16, kTA, kTB>(lo, da + sa, db, 1);
  wgmma_m64n128k16<__nv_bfloat16, kTA, kTB>(lo, da, db + 2 * sb, 1);
  wgmma_m64n128k16<__nv_bfloat16, kTA, kTB>(lo, da + sa, db + sb, 1);
  wgmma_m64n128k16<__nv_bfloat16, kTA, kTB>(lo, da + 2 * sa, db, 1);
}

// One stage's products over k16 steps [0, steps) of the planes, summed
// into acc: hi and lo fresh, then acc += hi + lo (rounded to nearest).
// kTA / kTB as wgmma_m64n128k16's; a_step / b_step: bytes a k16 step moves
// each operand's start; lbo_a / lbo_b the descriptors' leading offsets.
template <int kTA, int kTB>
__device__ __forceinline__ void stage_products(
    float (&acc)[64], float (&hi)[64], float (&lo)[64], uint32_t pa,
    uint32_t pb, int steps, int a_step, int b_step, int lbo_a, int lbo_b) {
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
  for (int s = 0; s < steps; ++s)
    wgmma_parts<kTA, kTB>(hi, lo, gmma_desc(pa + s * a_step, lbo_a, 1024),
                          gmma_desc(pb + s * b_step, lbo_b, 1024),
                          kPlaneA >> 4, kPlaneB >> 4, s == 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(hi);
  fence_regs(lo);
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] += hi[j] + lo[j];
}

// The forward (kTransB false: A = rows K-major, B = w[e] MN-major) and dRows
// (A = dOut, B = w[e]^T K-major) at fp32: the 16-bit kernel's items and
// producer, each stage 64 deep (A: as many 16-row boxes of 64 floats as
// the item has rows; B: one box, 128 x 64 of w or 64 x 128 of w^T).
template <bool kTransB>
__global__ void __launch_bounds__(kThreads, kF32BlocksPerSm)
    ragged_mm_f32_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                             const __grid_constant__ CUtensorMap tm_w,
                             RmArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = align1k(smem_raw);
  char* planes = smem + kF32Stages * kRawStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + kF32Planes);
  uint64_t* empty = full + kF32Stages;
  int* s_off = reinterpret_cast<int*>(empty + kF32Stages);
  int* s_tile = s_off + a.E + 1;
  const int R = a.R, E = a.E;
  const int Kin = kTransB ? a.N : a.K, Nout = kTransB ? a.K : a.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_init_fence();
  }
  block_scan<kThreads>(s_off, E,
                       [&](int e) { return clamped_size(a.sizes, e, R); });
  block_scan<kThreads>(s_tile, E, [&](int e) {
    return cdiv(min(s_off[e + 1], R) - min(s_off[e], R), kBM);
  });
  const int NT = cdiv(Nout, kBN), nk = cdiv(Kin, kBK);
  const int total = (s_tile[E] + cdiv(R - min(s_off[E], R), kBM)) * NT;

  if (warp == kConsumers / 32) {               // the producer
    if (lane != 0) return;
    int stage = 0, phase = 0;
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
      const MmItem it = mm_item(i, s_off, s_tile, E, R, NT);
      if (it.e == E) continue;
      const int pieces = cdiv(it.rows, kPiece);
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty + stage, phase ^ 1);
        mbar_expect_tx(full + stage, pieces * kPiece * 64 * 4 + kRawB);
        char* st = smem + stage * kRawStage;
        const int k0 = kt * kBK;
        for (int p = 0; p < pieces; ++p)
          tma_load_2d(st + p * kPiece * 64 * 4, &tm_a, full + stage, k0,
                      it.m0 + p * kPiece);
        if (kTransB)
          tma_load_3d(st + kRawA, &tm_w, full + stage, k0, it.n0, it.e);
        else
          tma_load_3d(st + kRawA, &tm_w, full + stage, it.n0, k0, it.e);
        if (++stage == kF32Stages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  float* out = static_cast<float*>(a.out);
  const uint32_t pa = smem_u32(planes);
  const uint32_t pb = pa + kSplitParts * kPlaneA;
  float acc[64], hi[64], lo[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) hi[j] = lo[j] = 0.f;
  int stage = 0, phase = 0;
  for (int i = blockIdx.x; i < total; i += gridDim.x) {
    const MmItem it = mm_item(i, s_off, s_tile, E, R, NT);
    if (it.e == E) {                  // rows past the last group: zeros
      for (int x = tid; x < kBM * (kBN / 4); x += kConsumers) {
        const int r = x / (kBN / 4), c = it.n0 + x % (kBN / 4) * 4;
        if (r < it.rows && c < Nout)
          *reinterpret_cast<float4*>(out + (long long)(it.m0 + r) * Nout +
                                     c) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      continue;
    }
    const int rows16 = cdiv(it.rows, kPiece) * kPiece;
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full + stage, phase);
      named_bar_sync<kConsumers>(1);     // the last stage's wgmmas are done
      const char* st = smem + stage * kRawStage;
      split_tile(st, 64, 64, rows16, rows16, planes, kPlaneA);
      if (kTransB)
        split_tile(st + kRawA, 64, 128, 128, 128,
                   planes + kSplitParts * kPlaneA, kPlaneB);
      else
        split_tile(st + kRawA, 128, 64, 64, 64,
                   planes + kSplitParts * kPlaneA, kPlaneB);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);   // the raw stage is read
      fence_proxy_async();
      named_bar_sync<kConsumers>(1);
      if (kTransB)
        stage_products<0, 0>(acc, hi, lo, pa, pb, kBK / 16, 32, 32, 16, 16);
      else
        stage_products<0, 1>(acc, hi, lo, pa, pb, kBK / 16, 32, 2048, 16,
                             kBox);
      if (++stage == kF32Stages) stage = 0, phase ^= 1;
    }
    // d[4 j + x]: row 16 warp + lane / 4 (+ 8 for x >= 2), column 8 j + 2
    // (lane % 4) (+ 1 for odd x); Nout is a multiple of 4, so a pair is
    // inside or past it whole
    const int r0 = 16 * warp + (lane >> 2), c0 = it.n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = r0 + 8 * x;
        if (r < it.rows && c < Nout)
          *reinterpret_cast<float2*>(out + (long long)(it.m0 + r) * Nout +
                                     c) =
              make_float2(acc[4 * j + 2 * x], acc[4 * j + 2 * x + 1]);
      }
    }
  }
}

// dW at fp32: the 16-bit kernel's items and producer (chunks of up to 64
// of the group's rows: 16-row boxes of rows' 64 columns and dOut's 128);
// the rows past the group's end are zeroed as the planes are cut, A =
// rows_e^T and B = dOut_e both MN-major; the tile written from the
// fragments (an expert with no rows: zeros).
__global__ void __launch_bounds__(kThreads, kF32BlocksPerSm)
    ragged_dw_f32_tma_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_d,
                             DwArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = align1k(smem_raw);
  char* planes = smem + kF32Stages * kRawStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + kF32Planes);
  uint64_t* empty = full + kF32Stages;
  int* s_off = reinterpret_cast<int*>(empty + kF32Stages);
  const int R = a.R, E = a.E;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_init_fence();
  }
  block_scan<kThreads>(s_off, E,
                       [&](int e) { return clamped_size(a.sizes, e, R); });
  const int NKt = cdiv(a.K, 64), NNt = cdiv(a.N, kBN);
  const int total = E * NKt * NNt;

  if (warp == kConsumers / 32) {               // the producer
    if (lane != 0) return;
    int stage = 0, phase = 0;
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
      const int e = i / (NKt * NNt), rem = i % (NKt * NNt);
      const int k0 = rem / NNt * 64, n0 = rem % NNt * kBN;
      const int g0 = min(s_off[e], R), g1 = min(s_off[e + 1], R);
      for (int r0 = g0; r0 < g1; r0 += kBK) {
        const int pieces = cdiv(min(kBK, g1 - r0), kPiece);
        mbar_wait(empty + stage, phase ^ 1);
        mbar_expect_tx(full + stage, pieces * kPiece * (64 + kBN) * 4);
        char* st = smem + stage * kRawStage;
        for (int p = 0; p < pieces; ++p) {
          const int y = r0 + p * kPiece;
          tma_load_2d(st + p * kPiece * 64 * 4, &tm_x, full + stage, k0, y);
          tma_load_2d(st + kRawA + p * kPiece * kBN * 4, &tm_d, full + stage,
                      n0, y);
        }
        if (++stage == kF32Stages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  float* dw = static_cast<float*>(a.dw);
  const uint32_t pa = smem_u32(planes);
  const uint32_t pb = pa + kSplitParts * kPlaneA;
  float acc[64], hi[64], lo[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) hi[j] = lo[j] = 0.f;
  int stage = 0, phase = 0;
  for (int i = blockIdx.x; i < total; i += gridDim.x) {
    const int e = i / (NKt * NNt), rem = i % (NKt * NNt);
    const int k0 = rem / NNt * 64, n0 = rem % NNt * kBN;
    const int g0 = min(s_off[e], R), g1 = min(s_off[e + 1], R);
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;
    for (int y0 = g0; y0 < g1; y0 += kBK) {
      const int valid = min(kBK, g1 - y0), v16 = cdiv(valid, kPiece) * kPiece;
      mbar_wait(full + stage, phase);
      named_bar_sync<kConsumers>(1);     // the last chunk's wgmmas are done
      const char* st = smem + stage * kRawStage;
      split_tile(st, 64, 64, v16, valid, planes, kPlaneA);
      split_tile(st + kRawA, kBN, 64, v16, valid,
                 planes + kSplitParts * kPlaneA, kPlaneB);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      fence_proxy_async();
      named_bar_sync<kConsumers>(1);
      stage_products<1, 1>(acc, hi, lo, pa, pb, v16 / kPiece, 2048, 2048,
                           kBox, kBox);
      if (++stage == kF32Stages) stage = 0, phase ^= 1;
    }
    // d[4 j + x]: K row 16 warp + lane / 4 (+ 8 for x >= 2), N column 8 j
    // + 2 (lane % 4) (+ 1 for odd x)
    float* tile = dw + (long long)e * a.K * a.N;
    const int r0 = k0 + 16 * warp + (lane >> 2), c0 = n0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = r0 + 8 * x;
        if (r < a.K && c < a.N)
          *reinterpret_cast<float2*>(tile + (long long)r * a.N + c) =
              make_float2(acc[4 * j + 2 * x], acc[4 * j + 2 * x + 1]);
      }
    }
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

enum Body { kCudaCores = 0, kMmaSync = 1, kWgmmaTma = 2 };

template <typename T>
int mm_smem(int E) {
  return kStages * Tile<T>::kMmStage + 2 * (E + 1) * (int)sizeof(int);
}
int mm_tma_smem(int E) {
  return 1024 + wg::kStages * wg::kStage + wg::kMmOut +
         2 * wg::kStages * 8 + 2 * (E + 1) * (int)sizeof(int);
}
int dw_tma_smem(int E) {
  return 1024 + wg::kStages * wg::kStage + 2 * wg::kDwOut +
         2 * wg::kStages * 8 + (E + 1) * (int)sizeof(int);
}
int mm_f32_smem(int E) {
  return 1024 + wg::kF32Stages * wg::kRawStage + wg::kF32Planes +
         2 * wg::kF32Stages * 8 + 2 * (E + 1) * (int)sizeof(int);
}
int dw_f32_smem(int E) {
  return 1024 + wg::kF32Stages * wg::kRawStage + wg::kF32Planes +
         2 * wg::kF32Stages * 8 + (E + 1) * (int)sizeof(int);
}

template <typename T, bool kTransB>
cudaError_t launch_mm(const RmArgs& a, dim3 grid, cudaStream_t stream) {
  const int smem = mm_smem<T>(a.E);
  cudaError_t e =
      opt_in_smem((const void*)ragged_mm_kernel<T, kTransB>, smem);
  if (e != cudaSuccess) return e;
  ragged_mm_kernel<T, kTransB><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kTransB>
cudaError_t launch_mm_tma(const RmArgs& a, int grid, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  const int Kin = kTransB ? a.N : a.K;
  const cuuint64_t da[2] = {(cuuint64_t)Kin, (cuuint64_t)a.R};
  const cuuint32_t ba[2] = {64, wg::kPiece};
  const cuuint64_t dw[3] = {(cuuint64_t)a.N, (cuuint64_t)a.K,
                            (cuuint64_t)a.E};
  const cuuint32_t bw[3] = {64, 64, 1};
  CUtensorMap ta, tw;
  if (!tensor_map16(&ta, a.a, kBf16, 2, da, ba) ||
      !tensor_map16(&tw, a.w, kBf16, 3, dw, bw))
    return cudaErrorInvalidValue;
  const int smem = mm_tma_smem(a.E);
  const void* kernel = (const void*)wg::ragged_mm_tma_kernel<T, kTransB>;
  cudaError_t e = opt_in_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  wg::ragged_mm_tma_kernel<T, kTransB>
      <<<grid, wg::kThreads, smem, stream>>>(ta, tw, a);
  return cudaGetLastError();
}

template <bool kTransB>
cudaError_t launch_mm_f32_tma(const RmArgs& a, int grid, cudaStream_t stream) {
  const int Kin = kTransB ? a.N : a.K;
  const cuuint64_t da[2] = {(cuuint64_t)Kin, (cuuint64_t)a.R};
  const cuuint32_t ba[2] = {64, wg::kPiece};
  // w (E, K, N): a stage's 64 of K x 128 of N (forward) or, read
  // transposed, its 128 of K (output columns) x 64 of N
  const cuuint64_t dw[3] = {(cuuint64_t)a.N, (cuuint64_t)a.K,
                            (cuuint64_t)a.E};
  const cuuint32_t bw[3] = {kTransB ? 64u : 128u, kTransB ? 128u : 64u, 1};
  CUtensorMap ta, tw;
  if (!tensor_map_f32(&ta, a.a, 2, da, ba) ||
      !tensor_map_f32(&tw, a.w, 3, dw, bw))
    return cudaErrorInvalidValue;
  const int smem = mm_f32_smem(a.E);
  const void* kernel = (const void*)wg::ragged_mm_f32_tma_kernel<kTransB>;
  cudaError_t e = opt_in_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  wg::ragged_mm_f32_tma_kernel<kTransB>
      <<<grid, wg::kThreads, smem, stream>>>(ta, tw, a);
  return cudaGetLastError();
}

cudaError_t launch_dw_f32_tma(const DwArgs& a, int grid,
                              cudaStream_t stream) {
  const cuuint64_t dx[2] = {(cuuint64_t)a.K, (cuuint64_t)a.R};
  const cuuint64_t dd[2] = {(cuuint64_t)a.N, (cuuint64_t)a.R};
  const cuuint32_t bx[2] = {64, wg::kPiece};
  const cuuint32_t bd[2] = {wg::kBN, wg::kPiece};
  CUtensorMap tx, td;
  if (!tensor_map_f32(&tx, a.a, 2, dx, bx) ||
      !tensor_map_f32(&td, a.d, 2, dd, bd))
    return cudaErrorInvalidValue;
  const int smem = dw_f32_smem(a.E);
  cudaError_t e =
      opt_in_smem((const void*)wg::ragged_dw_f32_tma_kernel, smem);
  if (e != cudaSuccess) return e;
  wg::ragged_dw_f32_tma_kernel<<<grid, wg::kThreads, smem, stream>>>(tx, td,
                                                                      a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const DwArgs& a, dim3 grid, cudaStream_t stream) {
  const int smem = kStages * Tile<T>::kDwStage;
  cudaError_t e = opt_in_smem((const void*)ragged_dw_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  ragged_dw_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw_tma(const DwArgs& a, int grid, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  const cuuint64_t dx[2] = {(cuuint64_t)a.K, (cuuint64_t)a.R};
  const cuuint64_t dd[2] = {(cuuint64_t)a.N, (cuuint64_t)a.R};
  const cuuint32_t b2[2] = {64, wg::kPiece};
  const cuuint64_t dw[3] = {(cuuint64_t)a.N, (cuuint64_t)a.K,
                            (cuuint64_t)a.E};
  const cuuint32_t bw[3] = {64, 64, 1};
  CUtensorMap tx, td, tw;
  if (!tensor_map16(&tx, a.a, kBf16, 2, dx, b2) ||
      !tensor_map16(&td, a.d, kBf16, 2, dd, b2) ||
      !tensor_map16(&tw, a.dw, kBf16, 3, dw, bw))
    return cudaErrorInvalidValue;
  const int smem = dw_tma_smem(a.E);
  cudaError_t e =
      opt_in_smem((const void*)wg::ragged_dw_tma_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  wg::ragged_dw_tma_kernel<T>
      <<<grid, wg::kThreads, smem, stream>>>(tx, td, tw, a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The body may serve these operands: CUDA cores fp32 only, mma.sync 16-bit
// only (any shape), wgmma + TMA either (K and N positive multiples of 16
// bytes' elements -- 4 at fp32, 8 at 16 bits -- and the given pointers
// 16-byte aligned).
bool body_fits(int body, int dtype, int K, int N,
               std::initializer_list<const void*> ptrs) {
  if (body == kCudaCores) return dtype == 0;
  if (body == kMmaSync) return dtype != 0;
  const int q = dtype == 0 ? 4 : 8;
  if (body != kWgmmaTma || K < q || N < q || K % q || N % q) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16, of a, w and out.  a (R,
// Kin), w (E, K, N), sizes (E,) int32, out (R, Nout), all contiguous;
// trans = 0: Kin = K, Nout = N (out = a_e w[e]); trans = 1: Kin = N, Nout =
// K (out = a_e w[e]^T).  R, E, Nout >= 1, K, N >= 0.  body (Body) and the
// grid come from the wrapper's plan (repro_torch/kernels/ragged_matmul.py):
// the wgmma body takes gx persistent blocks (gy = 1), the others a grid of
// at least (ceil(R / 16) + min(E, R), ceil(Nout / 64)).  Returns
// cudaGetLastError() after the launch (0 on success), cudaErrorInvalidValue
// for arguments the body does not take.
extern "C" int ragged_matmul_launch(const void* a, const void* w,
                                    const void* sizes, void* out, int dtype,
                                    int R, int E, int K, int N, int trans,
                                    int body, int gx, int gy, void* stream) {
  const int Nout = trans ? K : N;
  if (dtype < 0 || dtype > 2 || R < 1 || E < 1 || K < 0 || N < 0 ||
      Nout < 1 || (trans != 0 && trans != 1) || gx < 1 || gy < 1 ||
      gy > 65535 || !body_fits(body, dtype, K, N, {a, w, out}))
    return (int)cudaErrorInvalidValue;
  RmArgs args{a, w, static_cast<const int*>(sizes), out, R, E, K, N,
              K % 8 == 0 && N % 8 == 0 && aligned16(a) && aligned16(w)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == kWgmmaTma && dtype == 0) {
    if (mm_f32_smem(E) > kMaxSmem) return (int)cudaErrorInvalidValue;
    return trans ? (int)launch_mm_f32_tma<true>(args, gx, st)
                 : (int)launch_mm_f32_tma<false>(args, gx, st);
  }
  if (body == kWgmmaTma) {
    if (mm_tma_smem(E) > kMaxSmem) return (int)cudaErrorInvalidValue;
    switch (dtype * 2 + trans) {
      case 2: return (int)launch_mm_tma<__half, false>(args, gx, st);
      case 3: return (int)launch_mm_tma<__half, true>(args, gx, st);
      case 4: return (int)launch_mm_tma<__nv_bfloat16, false>(args, gx, st);
      default: return (int)launch_mm_tma<__nv_bfloat16, true>(args, gx, st);
    }
  }
  if (gx < cdiv(R, kBM) + min(E, R) || gy < cdiv(Nout, kBN) ||
      (dtype == 0 ? mm_smem<float>(E) : mm_smem<__half>(E)) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gx, gy);
  switch (dtype * 2 + trans) {
    case 0: return (int)launch_mm<float, false>(args, grid, st);
    case 1: return (int)launch_mm<float, true>(args, grid, st);
    case 2: return (int)launch_mm<__half, false>(args, grid, st);
    case 3: return (int)launch_mm<__half, true>(args, grid, st);
    case 4: return (int)launch_mm<__nv_bfloat16, false>(args, grid, st);
    default: return (int)launch_mm<__nv_bfloat16, true>(args, grid, st);
  }
}

// dw (E, K, N) = per group e, rows_e^T (K, s_e) x dout_e (s_e, N); a (R,
// K), dout (R, N), sizes (E,) int32, all contiguous, of dtype as above.
// R >= 0, E, K, N >= 1.  The wgmma body takes gx persistent blocks (and R
// >= 1), the others the grid (ceil(N / 64), ceil(K / 64), E).  Returns
// cudaGetLastError() after the launch.
extern "C" int ragged_matmul_dw_launch(const void* a, const void* dout,
                                       const void* sizes, void* dw,
                                       int dtype, int R, int E, int K, int N,
                                       int body, int gx, int gy, int gz,
                                       void* stream) {
  if (dtype < 0 || dtype > 2 || R < 0 || E < 1 || K < 1 || N < 1 ||
      gx < 1 || !body_fits(body, dtype, K, N, {a, dout, dw}))
    return (int)cudaErrorInvalidValue;
  DwArgs args{a, dout, static_cast<const int*>(sizes), dw, R, E, K, N,
              K % 8 == 0 && N % 8 == 0 && aligned16(a) && aligned16(dout)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == kWgmmaTma) {
    if (R < 1 || (dtype == 0 ? dw_f32_smem(E) : dw_tma_smem(E)) > kMaxSmem)
      return (int)cudaErrorInvalidValue;
    switch (dtype) {
      case 0: return (int)launch_dw_f32_tma(args, gx, st);
      case 1: return (int)launch_dw_tma<__half>(args, gx, st);
      default: return (int)launch_dw_tma<__nv_bfloat16>(args, gx, st);
    }
  }
  if (gx != cdiv(N, 64) || gy != cdiv(K, 64) || gz != E || gy > 65535 ||
      gz > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gx, gy, gz);
  switch (dtype) {
    case 0: return (int)launch_dw<float>(args, grid, st);
    case 1: return (int)launch_dw<__half>(args, grid, st);
    default: return (int)launch_dw<__nv_bfloat16>(args, grid, st);
  }
}
