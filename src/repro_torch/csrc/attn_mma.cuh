// Tensor-core attention core for Hopper (sm_90a), shared by the bf16/fp16
// bodies of flash_attention.cu (flash_mma_kernel) and paged_attention.cu
// (paged_mixed_mma_kernel, paged_decode_mma_kernel, paged_packed_mma_kernel),
// and by flash's fp32 body (flash_mma_kernel<float, ...>: the same walk over
// fp32 tiles, every product's operands cut into bf16 parts; its own
// instantiation, chosen at compile time, so the 2-byte ones are unchanged).
//
// A block owns up to 64 rows, where a row is one (query, head of the kv
// group) pair: row r of the block is global row r0 + r = qi * g + hi, query
// qi of its unit and query head h * g + hi, so the g heads that share kv
// head h read each K/V tile once.  A unit (blockIdx.z) is a batch row of
// NQ queries (flash, mixed, decode) or one row of the packed work table:
// up to NQ = 8 consecutive lanes of the token stream, all of one slot.
// Each warp owns 16 rows: flash and the mixed kernel run 4 warps, and a
// warp without rows (a short verify window) still copies tiles and merges
// splits; the decode kernel (one query, g rows) runs ceil(g / 16) warps and
// the packed kernel ceil(min(8 g, 64) / 16).  Row tiles run last first:
// under a causal mask the last sees the most keys.  The block streams
// 32-key tiles:
//
//   * Positions first.  The positions of up to 512 keys (no further than
//     the walk reaches) are staged at once (all threads, the block-table
//     reads of the paged kernels in flight together, then one round trip
//     for the positions), and a tile in which no key can be seen by the
//     block's rows (position -1 = unwritten or unallocated, beyond the
//     latest query, outside the window of the earliest) is marked dead
//     and never requested.  A block whose rows are all padding reads no
//     key.
//   * A three-stage cp.async ring.  Two tiles are in flight while one is
//     multiplied.  Keys that are not there (past the range, unallocated
//     pages) and the zero padding of D and Dv up to a multiple of 16 are
//     written as zeros by the copies themselves (cp.async's zero fill).
//   * Q.K^T and P.V on the tensor cores: mma.sync.m16n8k16 with fp32
//     accumulators, fed by ldmatrix from shared memory (Q and K as stored,
//     V transposed); at fp32 by fp32 loads cut into three bf16 parts each
//     (mma_abt_split, mma_xb_split below), P kept in fp32.  Over int8 pools the codes and their fp32 scales are
//     staged as stored; each element is dequantized as code x scale in
//     fp32 and rounded to q's type while the B fragments are built, which
//     is exactly what the plain version's gather computes.
//   * The online softmax in registers: scores to base 2 (log2 e folded
//     into the exponent's FFMA), running max and denominator per row,
//     -inf-safe rescaling (skipped when no row max of the warp moved); P
//     is rounded to q's type for the P.V product at bf16 / fp16, as
//     FlashAttention-2 does.  On a tile that every valid row sees whole only padding rows
//     are masked.  A row that sees no key writes 0.
//
// Only addresses differ between the users.  A key: flash reads key j of
// batch row b at entry b * Sk + j of contiguous (B, Sk, Hkv, D) tensors;
// the paged kernels map it through slot b's block-table row to entry pid
// * page + j % page of the pools.  Positions live at the same entry index
// (k_pos or ppos), and so do the int8 scales.  A query: unit u's lanes
// start at lane u * NQ of q (B, NQ, Hq, D) and q_pos; a packed work row
// (slot, tile, win_start, win_end) names its slot b and its lanes
// [win_start, win_end) of the (1, T) stream, and a row with slot -1 is
// unused.
//
// Split-K (the paged kernels on a small grid): blockIdx.x = tile * splits
// + split, and split s walks keys [s, s + 1) * keys_per_split.  With more
// than one split each block writes its rows' (m, l, acc) to a scratch
// buffer, and the last block of its (unit, kv head, row tile) to finish,
// found with an atomic counter, merges them into the output and resets
// the counter for the next launch: one launch, no combine kernel.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dtype.cuh"
#include "mma.cuh"

// The arguments of every kernel of this core, in a named namespace so that
// the paged kernels' launchers in other translation units
// (paged_{decode,mixed,packed}_mma.cu, paged_mma.cuh) can take them.
namespace repro_attn {

struct MmaArgs {
  const void* q;          // (B, NQ, Hq, D)
  const void* k;          // flash (B, Sk, Hkv, D); paged (P, page, Hkv, D)
  const void* v;          // the same with Dv
  const float* kscale;    // int8 pools only: (P * page, Hkv)
  const float* vscale;
  const int* kpos;        // positions per entry: k_pos or ppos
  const int* bt;          // paged: block table (B, npages); flash: nullptr
  const int* q_pos;       // (B, NQ), -1 = padding; packed (1, T)
  const int* meta;        // packed: work rows (units, 4); else nullptr
  void* out;              // (B, NQ, Hq, Dv)
  float* part;            // splits > 1: acc, (groups * splits, 64, Dv)
  float* part_ml;         // splits > 1: (m, l), (groups * splits, 64, 2)
  int* counters;          // splits > 1: (groups), 0 between launches
  int NQ, Sk;             // queries per unit (packed: at most); keys per row
  int Hq, Hkv, g, D, Dv;
  int page, npages;       // paged only
  int row_tiles, splits, keys_per_split;
  float scale, softcap;   // softcap <= 0: none
  int window;             // window <= 0: none
  float* lse;             // flash for training: (B, Hq, NQ) fp32; else null
};

}  // namespace repro_attn

namespace {

using repro_attn::MmaArgs;

constexpr int kMmaRows = 64;      // rows per block: up to 4 warps x 16
constexpr int kMmaKeys = 32;      // keys per tile
constexpr int kMmaStages = 3;     // tiles in flight: the ring's depth
constexpr int kMmaWindow = 512;   // keys whose positions are staged at once
constexpr int kMmaMaxSplits = 16; // splits of one walk (the merge's smem)
constexpr int kTileInts = kMmaKeys + 4;  // a tile's positions, its flag
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// bf16 parts of each fp32 operand of flash attention's fp32 bodies (the
// forward here, the backward in flash_attention_bwd.cu): part products
// (i, j) with i + j < 3, six mma a k-step (mma_parts_apart)
constexpr int kSplitParts = 3;

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Blocks an SM should hold at once (the register budget of __launch_bounds__):
// as many as the shared memory of a 64-row block at that head dim allows
// (esz: q's bytes an element; fp32 tiles take twice the room).
constexpr int mma_min_blocks(int dmax, int esz = 2) {
  return esz == 4 ? (dmax <= 64 ? 2 : 1)
                  : dmax <= 64 ? 5 : dmax <= 128 ? 3 : 1;
}

// Stages of the ring: 3, but 2 for fp32 tiles in the 256 bucket (three of
// 32 keys of K and V would not fit beside the block's Q rows).
__host__ __device__ constexpr int mma_stages(int dmax, int kv_bytes) {
  return kv_bytes == 4 && dmax > 128 ? 2 : kMmaStages;
}

// Row strides (bytes) of fp32 tiles in shared memory.  Rows read along
// themselves as float2 pairs (Q and K: a fragment's half-warp reads four
// rows) start 8 floats past a multiple of 16, so the four fall in distinct
// 8-bank groups; rows read down their columns (V in P.V: lanes read rows
// 2 tig and 2 tig + 1 at column gid) 4 floats past, so those 32 reads
// fall in 32 banks.
__host__ __device__ inline int f32_rows_bytes(int dim) {
  return (round16(dim) + 8) * 4;
}
__host__ __device__ inline int f32_cols_bytes(int dim) {
  return (round16(dim) + 4) * 4;
}

// Shared-memory layout (bytes): Q rows; per stage the K tile, the V tile,
// the tile's key positions and (int8 pools) its K and V scales; then the
// position window (positions and entries of kMmaWindow keys), the rows'
// query positions and a few ints.  Row strides of 2-byte elements are
// padded by 16 bytes so the 8 rows an ldmatrix reads fall in distinct
// banks; fp32 tiles (kv_bytes 4, q fp32 too) as f32_rows_bytes and
// f32_cols_bytes say.
struct MmaSmem {
  int q_stride, k_stride, v_stride, q_bytes, k_bytes, v_bytes, sc_bytes;
  int stages;
  __host__ __device__ MmaSmem(int D, int Dv, int rows, int kv_bytes) {
    if (kv_bytes == 4) {
      q_stride = k_stride = f32_rows_bytes(D);
      v_stride = f32_cols_bytes(Dv);
    } else {
      q_stride = (round16(D) + 8) * 2;
      k_stride = kv_bytes == 1 ? round16(D) + 16 : (round16(D) + 8) * 2;
      v_stride = kv_bytes == 1 ? round16(Dv) + 16 : (round16(Dv) + 8) * 2;
    }
    q_bytes = rows * q_stride;
    k_bytes = kMmaKeys * k_stride;
    v_bytes = kMmaKeys * v_stride;
    sc_bytes = kv_bytes == 1 ? 2 * kMmaKeys * 4 : 0;
    const int d = round16(D > Dv ? D : Dv);
    stages = mma_stages(d <= 64 ? 64 : d <= 128 ? 128 : 256, kv_bytes);
  }
  __host__ __device__ int stage_bytes() const {
    return k_bytes + v_bytes + kTileInts * 4 + sc_bytes;
  }
  __host__ __device__ int misc_offset() const {
    return q_bytes + stages * stage_bytes();
  }
  __host__ __device__ int total() const {
    return misc_offset() + (2 * kMmaWindow + kMmaRows) * 4 + 16;
  }
};

// 2^x in one SFU instruction (2^-inf = 0), about 2 ulp: the scores and
// the softmax weights are then rounded to bf16 / fp16 for P.V anyway
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Element offset of block row r's query head in q (times D) / out (Dv);
// the unit's lanes start at lane0.
__device__ __forceinline__ long long mma_row(const MmaArgs& a, long long lane0,
                                             int h, int r_glob) {
  const int qi = r_glob / a.g, hi = r_glob % a.g;
  return (lane0 + qi) * a.Hq + (long long)h * a.g + hi;
}

// How the block's threads copy one tile's rows of `dim` elements: thread
// t copies the chunk at byte `col` of rows key0, key0 + step, ... < 32
// (rows of `row_bytes`, zero-padded to a multiple of 16 elements, in
// chunks of 16 bytes, or 8 for int8 rows whose dim is not a multiple of
// 16).  Worked out once per block, so the tile loop divides nothing.
struct MmaCopyPlan {
  int key0, step, col, chunk, row_bytes;
  __device__ MmaCopyPlan(int dim, int esz) {
    chunk = (esz != 1 || dim % 16 == 0) ? 16 : 8;
    row_bytes = dim * esz;
    const int per_row = round16(dim) * esz / chunk;   // <= 64
    step = blockDim.x / per_row;
    key0 = threadIdx.x / per_row;
    col = (threadIdx.x % per_row) * chunk;
    if (key0 >= step) key0 = kMmaKeys;              // the spare threads
  }
};

// The block's state around the tile loop: where shared memory is cut, the
// keys it walks and the position window.
struct MmaBlock {
  const MmaArgs& a;
  MmaSmem L;
  char* q_s;          // Q rows
  char* stages;       // the ring
  int* win_kp;        // [kMmaWindow] key positions (-1: none)
  int* win_ent;       // [kMmaWindow] entries (-1: none)
  int* row_qp;        // [kMmaRows] the rows' query positions
  int* live;          // [0] live tiles of the window (bit t), [1] merge flag
  int b, h, k_stop, win_base;
  int qlo, qhi;       // earliest and latest query position of the rows
  MmaCopyPlan kcp, vcp;

  __device__ MmaBlock(const MmaArgs& args, char* smem, int rows_alloc,
                      int kv_bytes)
      : a(args), L(args.D, args.Dv, rows_alloc, kv_bytes),
        kcp(args.D, kv_bytes), vcp(args.Dv, kv_bytes) {
    q_s = smem;
    stages = smem + L.q_bytes;
    win_kp = reinterpret_cast<int*>(smem + L.misc_offset());
    win_ent = win_kp + kMmaWindow;
    row_qp = win_ent + kMmaWindow;
    live = row_qp + kMmaRows;
  }

  // Entry index of key j of batch row b (-1: unallocated page).
  __device__ __forceinline__ int entry(int j) const {
    if (a.bt == nullptr) return b * a.Sk + j;
    const int pid = a.bt[(long long)b * a.npages + j / a.page];
    return pid < 0 ? -1 : pid * a.page + j % a.page;
  }

  // Keys of the window from win_base that the walk can reach: whole
  // tiles up to k_stop, at most kMmaWindow.
  __device__ __forceinline__ int window_keys() const {
    const int n = (k_stop - win_base + kMmaKeys - 1) / kMmaKeys * kMmaKeys;
    return max(0, min(kMmaWindow, n));
  }

  // Positions and entries of keys [k, k + window_keys()), all threads:
  // every entry first (through the block table: those reads are in flight
  // together), then the positions by cp.async (-1 where there is no key: a
  // zero-filled int is 0, so it is written as -1 directly).  The caller
  // waits for the copies and synchronizes before and after.
  __device__ void fill_window(int k) {
    win_base = k;
    const int n = window_keys();
    int e[kMmaWindow / 32];       // blockDim.x >= 32
#pragma unroll
    for (int it = 0; it < kMmaWindow / 32; ++it) {
      const int i = threadIdx.x + it * blockDim.x;
      e[it] = i < n && k + i < k_stop ? entry(k + i) : -1;
    }
#pragma unroll
    for (int it = 0; it < kMmaWindow / 32; ++it) {
      const int i = threadIdx.x + it * blockDim.x;
      if (i >= n) break;
      win_ent[i] = e[it];
      if (e[it] >= 0)
        cp_async4(win_kp + i, a.kpos + e[it], true);
      else
        win_kp[i] = -1;
    }
    if (threadIdx.x == 0) live[0] = 0;
  }

  // Mark the window's tiles in which some key may be seen by a row
  // (position >= 0, <= the latest query, inside the earliest query's
  // window), one warp per tile; the caller synchronizes after.
  __device__ void mark_window() {
    const int lane = threadIdx.x & 31;
    const int tiles = window_keys() / kMmaKeys;
    for (int t = threadIdx.x >> 5; t < tiles; t += blockDim.x >> 5) {
      const int kp = win_kp[t * kMmaKeys + lane];
      const bool cand = kp >= 0 && kp <= qhi &&
                        (a.window <= 0 || kp > qlo - a.window);
      if (__any_sync(~0u, cand) && lane == 0) atomicOr(&live[0], 1 << t);
    }
  }

  // Start of the first live tile at or after key k (k a tile start);
  // k_stop if none.  Refills the window as needed: every thread runs it
  // on the same shared data, so the barriers are uniform.
  __device__ int next_tile(int k) {
    while (k < k_stop) {
      if (k >= win_base + kMmaWindow) {
        __syncthreads();              // the old window has been read
        fill_window(k);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        mark_window();
        __syncthreads();
      }
      const unsigned bits =
          (unsigned)live[0] >> ((k - win_base) / kMmaKeys);
      if (bits) return k + (__ffs(bits) - 1) * kMmaKeys;
      k = win_base + kMmaWindow;
    }
    return k_stop;
  }

  // Request tile k's K and V rows of kv head h (and int8 scales) into a
  // stage, and copy its key positions there.
  template <typename KV>
  __device__ void issue(int k, char* st) const {
    constexpr int esz = sizeof(KV);
    const int tid = threadIdx.x;
    const int* ent = win_ent + (k - win_base);
    const char* bases[2] = {static_cast<const char*>(a.k),
                            static_cast<const char*>(a.v)};
    const MmaCopyPlan* plans[2] = {&kcp, &vcp};
    const int strides[2] = {L.k_stride, L.v_stride};
    char* dsts[2] = {st, st + L.k_bytes};
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const MmaCopyPlan& cp = *plans[w];
      const bool in_row = cp.col < cp.row_bytes;   // else: D's zero padding
      const long long head = (long long)h * cp.row_bytes + cp.col;
      char* dst = dsts[w] + cp.key0 * strides[w] + cp.col;
      for (int key = cp.key0; key < kMmaKeys; key += cp.step) {
        const int e = ent[key];
        const bool ok = in_row && e >= 0;
        const char* src =
            ok ? bases[w] + (long long)e * a.Hkv * cp.row_bytes + head
               : bases[w];
        if (cp.chunk == 16)
          cp_async16(dst, src, ok);
        else
          cp_async8(dst, src, ok);
        dst += cp.step * strides[w];
      }
    }
    // the tile's positions, and whether every valid row sees every key
    // (then only padding rows need masking)
    int* kp = reinterpret_cast<int*>(st + L.k_bytes + L.v_bytes);
    if (tid < kMmaKeys) {
      const int p = win_kp[k - win_base + tid];
      kp[tid] = p;
      const bool full = __all_sync(
          ~0u, p >= 0 && p <= qlo && (a.window <= 0 || p > qhi - a.window));
      if (tid == 0) kp[kMmaKeys] = full;
      if constexpr (esz == 1) {
        float* sc = reinterpret_cast<float*>(kp + kTileInts);
        const int e = ent[tid];
        const long long i = (long long)(e < 0 ? 0 : e) * a.Hkv + h;
        cp_async4(sc + tid, a.kscale + i, e >= 0);
        cp_async4(sc + kMmaKeys + tid, a.vscale + i, e >= 0);
      }
    }
  }
};

// fp32 operands on the bf16 tensor cores (flash attention's fp32 bodies):
// each operand cut into kSplitParts parts as its fragment loads from fp32
// rows in shared memory (load_a / load_b), or from the accumulators that
// hold it (split_acc_a).

// acc (16 x 32 a warp) = A (the warp's 16 rows of fp32 `a_rows`, kpad
// columns) . B^T (32 fp32 rows of `b_rows`), kpad a multiple of 16: Q.K^T
// in the forward, the scores and dO.V^T in the backward.  The leading
// parts' products and the rest go to separate accumulators, added once.
template <int DMAX>
__device__ __forceinline__ void mma_abt_split(float (&acc)[4][4],
                                              const float* a_rows, int a_ld,
                                              const float* b_rows, int b_ld,
                                              int kpad) {
  constexpr int P = kSplitParts;
  float lo[4][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i / 4][i % 4] = lo[i / 4][i % 4] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk * 16 >= kpad) break;
    uint32_t a[P][4];
    load_a<P, true>(a, a_rows, a_ld, 0, kk * 16);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t b[P][2];
      load_b<P, true>(b, b_rows, b_ld, kk * 16, nt * 8);
      mma_parts_apart<P, P>(acc[nt], lo[nt], a, b);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i / 4][i % 4] += lo[i / 4][i % 4];
}

// The same with A's parts held in registers for every k-step (KS of them):
// a warp that multiplies its own rows by every tile cuts them once.
template <int KS>
__device__ __forceinline__ void mma_abt_split(
    float (&acc)[4][4], const uint32_t (&a)[KS][kSplitParts][4],
    const float* b_rows, int b_ld, int kpad) {
  constexpr int P = kSplitParts;
  float lo[4][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i / 4][i % 4] = lo[i / 4][i % 4] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk * 16 >= kpad) break;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t b[P][2];
      load_b<P, true>(b, b_rows, b_ld, kk * 16, nt * 8);
      mma_parts_apart<P, P>(acc[nt], lo[nt], a[kk], b);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i / 4][i % 4] += lo[i / 4][i % 4];
}

// Every k-step's A parts of the warp's 16 fp32 rows of `a_rows`.
template <int KS>
__device__ __forceinline__ void split_rows_a(uint32_t (&a)[KS][kSplitParts][4],
                                             const float* a_rows, int a_ld,
                                             int kpad) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (kk * 16 < kpad) load_a<kSplitParts, true>(a[kk], a_rows, a_ld, 0, kk * 16);
}

// acc (16 x up to NP * 16 a warp, from column c0) += X (16 x 32, fp32 in
// the accumulators of a 16 x 32 product) . B (32 fp32 rows of `b_rows`,
// read down columns c0 ..., up to `width` of the padded `dpad`): P.V in
// the forward, dS.K, P^T.dO and dS^T.Q in the backward.  Each 16-column
// group's products over the tile go to fresh accumulators (the leading
// parts' apart from the rest), added to acc with fp32 adds: acc's sums
// over many tiles never pass through the tensor cores' truncation.
template <int NP, bool WHOLE>
__device__ __forceinline__ void mma_xb_split(float (&acc)[NP * 2][4],
                                             const float (&x)[4][4],
                                             const float* b_rows, int b_ld,
                                             int c0, int width, int dpad) {
  constexpr int P = kSplitParts;
  uint32_t xa[2][P][4];
  split_acc_a<P>(xa[0], x[0], x[1]);
  split_acc_a<P>(xa[1], x[2], x[3]);
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    const int c = c0 + np * 16;
    if (np * 16 < width && (WHOLE || c < dpad)) {
      float hi[2][4], lo[2][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) hi[i / 4][i % 4] = lo[i / 4][i % 4] = 0.f;
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t b[P][2];
          load_b<P, false>(b, b_rows, b_ld, kq * 16, c + hf * 8);
          mma_parts_apart<P, P>(hi[hf], lo[hf], xa[kq], b);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[np * 2 + i / 4][i % 4] += hi[i / 4][i % 4] + lo[i / 4][i % 4];
    }
  }
}

template <typename T, typename KV, int DMAX>
__device__ void mma_attend(const MmaArgs& a, char* smem) {
  constexpr bool kQ8 = sizeof(KV) == 1;
  // fp32 q / k / v (flash only): the split products above
  constexpr bool kSplit = std::is_same_v<T, float>;
  static_assert(!kSplit || std::is_same_v<KV, float>, "fp32 q takes fp32 K/V");
  constexpr int S = mma_stages(DMAX, sizeof(KV));
  // the last row tile first: under a causal mask it sees the most keys,
  // so the longest blocks start in the first wave
  const int tile = a.row_tiles - 1 - (int)blockIdx.x / a.splits;
  const int split = blockIdx.x % a.splits;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int D = a.D, Dv = a.Dv, DP = round16(D), DVP = round16(Dv);
  // the unit: its slot b, its first lane and its lanes
  const int unit = blockIdx.z;
  int slot = unit, nq = a.NQ;
  long long lane0 = (long long)unit * a.NQ;
  if (a.meta != nullptr) {
    const int* w = a.meta + 4 * unit;
    slot = w[0];
    lane0 = w[2];
    nq = min(w[3] - w[2], a.NQ);
    if (slot < 0 || nq <= 0) return;          // an unused work row
  }
  const int r0 = tile * kMmaRows;
  const int nrows = min(kMmaRows, nq * a.g - r0);
  if (nrows <= 0) return;                     // a row tile past the lanes
  const int rows_alloc = nthreads / 32 * 16;
  MmaBlock blk(a, smem, rows_alloc, sizeof(KV));
  const MmaSmem& L = blk.L;
  blk.b = slot;
  blk.h = blockIdx.y;
  const int h = blk.h;
  const int k_begin = split * a.keys_per_split;
  blk.k_stop = min(a.Sk, k_begin + a.keys_per_split);
  const T* q = static_cast<const T*>(a.q);

  // Q rows (zeros past nrows and in the padding of D), the rows' query
  // positions and the first position window, all in flight together
  {
    constexpr int kVec = 16 / sizeof(T);      // elements a 16-byte copy
    const int per_row = DP / kVec, step = nthreads / per_row;
    const int col = (tid % per_row) * kVec;
    for (int r = tid / per_row; r < rows_alloc && tid < step * per_row;
         r += step) {
      const bool ok = r < nrows && col < D;
      const T* src = ok ? q + mma_row(a, lane0, h, r0 + r) * D + col : q;
      cp_async16(blk.q_s + r * L.q_stride + col * (int)sizeof(T), src, ok);
    }
  }
  for (int r = tid; r < kMmaRows; r += nthreads) {
    if (r < nrows)
      cp_async4(blk.row_qp + r, a.q_pos + lane0 + (r0 + r) / a.g, true);
    else
      blk.row_qp[r] = -1;
  }
  blk.fill_window(k_begin);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  {
    int lo = INT_MAX, hi = -1;
    for (int r = lane; r < kMmaRows; r += 32) {
      const int p = blk.row_qp[r];
      if (p >= 0) {
        lo = min(lo, p);
        hi = max(hi, p);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(~0u, lo, o));
      hi = max(hi, __shfl_xor_sync(~0u, hi, o));
    }
    blk.qlo = lo;
    blk.qhi = hi;
  }
  if (blk.qhi < 0) blk.k_stop = k_begin;    // all padding: read no key
  blk.mark_window();
  __syncthreads();
  // this thread's two rows: warp * 16 + gid and + 8
  const int qp[2] = {blk.row_qp[warp * 16 + gid],
                     blk.row_qp[warp * 16 + gid + 8]};
  const bool has_rows = warp * 16 < nrows;
  // scores stay in natural units (times the scale, or softcapped); the
  // softmax takes them to base 2 with one FFMA before ex2
  const float cap = a.softcap;
  const float to2 = cap > 0.f ? kLog2e : a.scale * kLog2e;

  float o[DMAX / 8][4];
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // fp32 up to a head dim of 64: the warp's Q parts stay in registers for
  // the whole walk
  constexpr bool kHoldQ = kSplit && DMAX <= 64;
  uint32_t qh[kHoldQ ? DMAX / 16 : 1][kSplitParts][4];
  if constexpr (kHoldQ) {   // Q landed with the first window
    split_rows_a(qh, reinterpret_cast<const float*>(
                         blk.q_s + warp * 16 * L.q_stride),
                 L.q_stride / 4, DP);
  }

  // the ring: tile t_cur in stage st, t_nxt in the next; with three stages
  // each iteration requests the tile after t_nxt into the third, with two
  // t_nxt itself into the other
  const int k_stop = blk.k_stop;
  int t_cur = blk.next_tile(k_begin);
  if (t_cur < k_stop) blk.issue<KV>(t_cur, blk.stages);
  cp_async_commit();
  int t_nxt = t_cur < k_stop ? blk.next_tile(t_cur + kMmaKeys) : k_stop;
  if constexpr (S == 3) {
    if (t_nxt < k_stop) blk.issue<KV>(t_nxt, blk.stages + L.stage_bytes());
    cp_async_commit();
  }
  int st = 0;
  while (t_cur < k_stop) {
    int t_new = k_stop;
    if constexpr (S == 3) {
      t_new = t_nxt < k_stop ? blk.next_tile(t_nxt + kMmaKeys) : k_stop;
      if (t_new < k_stop)
        blk.issue<KV>(t_new, blk.stages + ((st + 2) % kMmaStages) *
                                 L.stage_bytes());
    } else {
      static_assert(S == 2, "a ring of two or three stages");
      if (t_nxt < k_stop)
        blk.issue<KV>(t_nxt, blk.stages + (st ^ 1) * L.stage_bytes());
    }
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncthreads();
    if (has_rows) {
      const char* kst = blk.stages + st * L.stage_bytes();
      const char* vst = kst + L.k_bytes;
      const int* tkp = reinterpret_cast<const int*>(vst + L.v_bytes);
      const float* sc = reinterpret_cast<const float*>(tkp + kTileInts);
      const bool full = tkp[kMmaKeys] != 0;
      // S = Q K^T: 16 rows x 32 keys per warp
      float s[4][4];
      if constexpr (kSplit) {
        const float* kf = reinterpret_cast<const float*>(kst);
        if constexpr (kHoldQ)
          mma_abt_split(s, qh, kf, L.k_stride / 4, DP);
        else
          mma_abt_split<DMAX>(s, reinterpret_cast<const float*>(
                                     blk.q_s + warp * 16 * L.q_stride),
                              L.q_stride / 4, kf, L.k_stride / 4, DP);
      } else {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        if (kk * 16 >= DP) break;
        uint32_t qa[4];
        ldsm_x4(qa, blk.q_s + (warp * 16 + (lane & 15)) * L.q_stride +
                    (kk * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kb[4];
          if constexpr (!kQ8) {
            ldsm_x4(kb, kst + (np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                  L.k_stride +
                            (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
          } else {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int key = (np * 2 + hf) * 8 + gid;
              const int8_t* row = reinterpret_cast<const int8_t*>(
                                      kst + key * L.k_stride) +
                                  kk * 16 + tig * 2;
              const float f = sc[key];
              const unsigned lo = i8pair(row), hi = i8pair(row + 8);
              kb[hf * 2] = pack2<T>(i8_lo(lo) * f, i8_hi(lo) * f);
              kb[hf * 2 + 1] = pack2<T>(i8_lo(hi) * f, i8_hi(hi) * f);
            }
          }
          mma16816<T>(s[np * 2], qa, kb[0], kb[1]);
          mma16816<T>(s[np * 2 + 1], qa, kb[2], kb[3]);
        }
      }
      }
      // scale (and softcap) into base 2, then the mask: on a tile every
      // valid row sees whole, only padding rows are masked
      if (cap > 0.f) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          s[i / 4][i % 4] = tanhf(s[i / 4][i % 4] * a.scale / cap) * cap;
      }
      if (!full) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = tkp[nt * 8 + tig * 2 + e];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
              if (!visible(kp, qp[rr], a.window))
                s[nt][rr * 2 + e] = -INFINITY;
          }
        }
      } else if (qp[0] < 0 || qp[1] < 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (qp[(i % 4) / 2] < 0) s[i / 4][i % 4] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i / 4][i % 4]);
      float alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(~0u, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(~0u, mx[rr], 2));
        const float m_new = fmaxf(m[rr], mx[rr]);
        const float m_use = m_new == -INFINITY ? 0.f : __fmul_rn(m_new, to2);
        // the exponents so far were taken against the rounded m * to2 the
        // last tile used (never contracted into an FMA): rescale from that
        // exact value, or l drifts by its rounding at every new max (~3e-6
        // of a long row's log-sum-exp at fp32); 0 from -inf
        alpha[rr] = exp2_approx(__fmul_rn(m[rr], to2) - m_use);
        m[rr] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p =
                exp2_approx(fmaf(s[nt][rr * 2 + e], to2, -m_use));
            s[nt][rr * 2 + e] = p;
            sum += p;
          }
        }
        l[rr] = l[rr] * alpha[rr] + sum;
      }
      if (__any_sync(~0u, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int nt = 0; nt < DMAX / 8; ++nt) {
          o[nt][0] *= alpha[0];
          o[nt][1] *= alpha[0];
          o[nt][2] *= alpha[1];
          o[nt][3] *= alpha[1];
        }
      }
      if constexpr (kSplit) {
        // O += P V, P in fp32 (as the plain version keeps it)
        mma_xb_split<DMAX / 16, false>(o, s, reinterpret_cast<const float*>(vst),
                                      L.v_stride / 4, 0, DVP, DVP);
      } else {
      // O += P V, P rounded to T
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t pa[4] = {pack2<T>(s[2 * ks][0], s[2 * ks][1]),
                          pack2<T>(s[2 * ks][2], s[2 * ks][3]),
                          pack2<T>(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                          pack2<T>(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
        for (int np = 0; np < DMAX / 16; ++np) {
          if (np * 16 < DVP) {
            uint32_t vb[4];
            if constexpr (!kQ8) {
              ldsm_x4_t(vb, vst + (ks * 16 + (lane & 15)) * L.v_stride +
                                (np * 16 + (lane >> 4) * 8) * 2);
            } else {
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int col = (np * 2 + hf) * 8 + gid;
                const int k0 = ks * 16 + tig * 2;
                const int8_t* c0 =
                    reinterpret_cast<const int8_t*>(vst + k0 * L.v_stride) +
                    col;
                const int vs = L.v_stride;
                const float* f = sc + kMmaKeys + k0;
                const unsigned u01 =
                    (unsigned char)c0[0] | (unsigned char)c0[vs] << 8;
                const unsigned u89 =
                    (unsigned char)c0[8 * vs] | (unsigned char)c0[9 * vs] << 8;
                vb[hf * 2] = pack2<T>(i8_lo(u01) * f[0], i8_hi(u01) * f[1]);
                vb[hf * 2 + 1] =
                    pack2<T>(i8_lo(u89) * f[8], i8_hi(u89) * f[9]);
              }
            }
            mma16816<T>(o[np * 2], pa, vb[0], vb[1]);
            mma16816<T>(o[np * 2 + 1], pa, vb[2], vb[3]);
          }
        }
      }
      }
    }
    __syncthreads();
    if constexpr (S == 3) {
      t_cur = t_nxt;
      t_nxt = t_new;
      st = (st + 1) % kMmaStages;
    } else {
      t_cur = t_nxt;
      t_nxt = t_nxt < k_stop ? blk.next_tile(t_nxt + kMmaKeys) : k_stop;
      st ^= 1;
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(~0u, l[rr], 1);
    l[rr] += __shfl_xor_sync(~0u, l[rr], 2);
  }

  T* out = static_cast<T*>(a.out);
  if (a.splits == 1) {
    if (!has_rows) return;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * 16 + gid + rr * 8;
      if (r >= nrows) continue;
      // a row with no visible key has l == 0 and o == 0: it writes 0
      const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
      if (a.lse != nullptr && tig == 0) {
        // natural log-sum-exp of the row's scores (m * to2 is the base-2
        // exponent of its max); +inf where it saw no key
        const int rg = r0 + r;
        a.lse[((long long)slot * a.Hq + (long long)h * a.g + rg % a.g) *
                  a.NQ + rg / a.g] =
            l[rr] > 0.f ? (__fmul_rn(m[rr], to2) + log2f(l[rr])) * kLn2
                        : INFINITY;
      }
      T* orow = out + mma_row(a, lane0, h, r0 + r) * Dv;
#pragma unroll
      for (int nt = 0; nt < DMAX / 8; ++nt) {
        const int col = nt * 8 + tig * 2;
        if (col < Dv)
          store2<T>(orow + col, o[nt][rr * 2] * inv, o[nt][rr * 2 + 1] * inv);
      }
    }
    return;
  }

  // split-K: this block's partial, then the last block of the group merges
  const long long group =
      ((long long)unit * a.Hkv + h) * a.row_tiles + tile;
  const long long pidx = group * a.splits + split;
  if (has_rows) {
    float* po = a.part + pidx * kMmaRows * Dv;
    float* pml = a.part_ml + pidx * kMmaRows * 2;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * 16 + gid + rr * 8;
      if (r >= nrows) continue;
#pragma unroll
      for (int nt = 0; nt < DMAX / 8; ++nt) {
        const int col = nt * 8 + tig * 2;
        if (col < Dv)
          *reinterpret_cast<float2*>(po + r * Dv + col) =
              make_float2(o[nt][rr * 2], o[nt][rr * 2 + 1]);
      }
      if (tig == 0) {
        pml[r * 2] = __fmul_rn(m[rr], to2);        // base 2, or -inf
        pml[r * 2 + 1] = l[rr];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    blk.live[1] = atomicAdd(a.counters + group, 1) == a.splits - 1;
  __syncthreads();
  if (!blk.live[1]) return;
  __threadfence();
  // the merge: every split's (m, l) of every row in flight at once, then
  // per row M = max_s m_s, L = sum_s l_s 2^(m_s - M) and the weights
  // 2^(m_s - M) / L (kMmaMaxSplits x 64 of each in shared memory, where
  // Q and the ring were); then each thread sums up to eight float4 groups
  // of columns over the splits, their loads in flight together
  const float* gml = a.part_ml + group * a.splits * kMmaRows * 2;
  const float* go = a.part + group * a.splits * kMmaRows * Dv;
  float* wt = reinterpret_cast<float*>(blk.q_s);
  float* ls = wt + kMmaMaxSplits * kMmaRows;
  for (int i = tid; i < a.splits * nrows; i += nthreads) {
    const int j = i / nrows * kMmaRows + i % nrows;   // (split, row)
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(gml) + j);
    wt[j] = ml.x;
    ls[j] = ml.y;
  }
  __syncthreads();
  for (int r = tid; r < nrows; r += nthreads) {
    float M = -INFINITY, Lsum = 0.f;
    for (int s = 0; s < a.splits; ++s) M = fmaxf(M, wt[s * kMmaRows + r]);
    if (M != -INFINITY)
      for (int s = 0; s < a.splits; ++s)
        Lsum += ls[s * kMmaRows + r] * exp2f(wt[s * kMmaRows + r] - M);
    // 0 for a split that saw no key (m_s = -inf) or a row that saw none
    const float inv = Lsum > 0.f ? 1.f / Lsum : 0.f;
    for (int s = 0; s < a.splits; ++s)
      wt[s * kMmaRows + r] =
          inv > 0.f ? exp2f(wt[s * kMmaRows + r] - M) * inv : 0.f;
  }
  __syncthreads();
  const int n4 = nrows * Dv / 4;           // Dv is a multiple of 8
  for (int i0 = tid; i0 < n4; i0 += 8 * nthreads) {
    float4 acc[8];
    int rw[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      rw[u] = (i0 + u * nthreads) * 4 / Dv;
    }
#pragma unroll 2
    for (int s = 0; s < a.splits; ++s) {
      const float4* src =
          reinterpret_cast<const float4*>(go + (long long)s * kMmaRows * Dv);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * nthreads;
        if (i < n4) {
          const float w = wt[s * kMmaRows + rw[u]];
          const float4 x = __ldcg(src + i);
          acc[u].x += w * x.x;
          acc[u].y += w * x.y;
          acc[u].z += w * x.z;
          acc[u].w += w * x.w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nthreads;
      if (i >= n4) break;
      T* orow = out + mma_row(a, lane0, h, r0 + rw[u]) * Dv + i * 4 % Dv;
      store2<T>(orow, acc[u].x, acc[u].y);
      store2<T>(orow + 2, acc[u].z, acc[u].w);
    }
  }
  if (tid == 0) a.counters[group] = 0;
}

// Launch kernel (a __global__ wrapper of mma_attend) over grid
// (row_tiles * splits, Hkv, units), ``warps`` warps a block (16 rows each;
// 4 by default, and warps without rows load tiles and merge splits).
inline cudaError_t mma_launch(void (*kernel)(MmaArgs), const MmaArgs& a,
                              int units, cudaStream_t stream,
                              int warps = kMmaRows / 16, bool fp32 = false) {
  const int kv_bytes = fp32 ? 4 : a.kscale != nullptr ? 1 : 2;
  const size_t smem = MmaSmem(a.D, a.Dv, warps * 16, kv_bytes).total();
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = opt_in_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.row_tiles * a.splits, a.Hkv, units), warps * 32, smem,
           stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
