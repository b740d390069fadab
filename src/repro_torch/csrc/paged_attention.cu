// Paged attention kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes); see repro_torch/kernels/decode_attention.py.
//
// Replaces six Pallas TPU kernels of the reference package
// (repro/kernels/decode_attention.py), and the fp32 body of its dense
// decode kernel:
//   * paged_decode_attention (body _paged_kernel): one query token per
//     slot against that slot's paged K/V.  bf16 / fp16 q:
//     paged_decode_mma_kernel<T, T>; fp32 q: paged_decode_kernel<float>.
//   * paged_decode_attention_q8 (body _paged_kernel_q8): the same over int8
//     pools, paged_decode_mma_kernel<T, int8> / paged_decode_kernel<float,
//     int8>.
//   * paged_packed_attention (body _paged_packed_kernel) and
//     paged_packed_attention_q8 (_paged_packed_kernel_q8): a token-packed
//     ragged stream of decode tokens and prefill-chunk tokens, each lane
//     against its own slot's pages, walked by rows of a work table (up to
//     8 lanes of one slot each).  bf16 / fp16 q: paged_packed_mma_kernel<T,
//     T / int8>; fp32 q: paged_packed_kernel<float, float / int8>.
//   * paged_mixed_attention (body _paged_mixed_kernel) and
//     paged_mixed_attention_q8 (_paged_mixed_kernel_q8): a window of W query
//     lanes per slot (a speculative verify window, a prefill chunk), each
//     against its slot's pages; lanes with q_pos == -1 are padding.  bf16 /
//     fp16 q: paged_mixed_mma_kernel<T, T / int8>; fp32 q:
//     paged_mixed_kernel<float / int8>.
//   * decode_attention (body _kernel) at fp32 q, and at bf16 / fp16 q
//     whose q / k / v do not start on a 16-byte boundary:
//     dense_decode_kernel<T, T>, one query token per row against the row's
//     own contiguous K/V (B,Sk,Hkv,D); the decode body with the row's cache
//     as one page of Sk entries and k_pos as its positions.  Aligned bf16 /
//     fp16 inputs take the tensor-core body of dense_decode.cu.
// Over int8 pools the codes are dequantized with one fp32 multiply by the
// per-entry, per-kv-head scale (as the Pallas bodies do), so a dequantized
// value equals the plain version's bit for bit; q and out stay at q's
// dtype.
//
// Bound: all are bound by device-memory bytes, chiefly the K/V pages they
// stream (page x Hkv x (D + Dv) x element bytes per page, plus 2 x 4-byte
// scales per entry and kv head for int8 pools), plus positions, queries
// and outputs; a decode token does 2 x (D + Dv) flops per key, far below
// the card's ~295 flops-per-byte ridge.
//
// Bodies by q's dtype (chosen in the launcher, not a fallback):
//
//  * bf16 / fp16, the decode, mixed and packed kernels: the tensor-core
//    core of attn_mma.cuh, each kind's kernels built in a translation
//    unit of their own (paged_{decode,mixed,packed}_mma.cu, paged_mma.cuh).
//    A block takes up to 64 rows of (window lane,
//    head of the kv group) pairs of one slot and kv head (at decode the g
//    heads of one token, in ceil(g / 16) warps: one at qwen3-4b's g = 4 and
//    unimo-text's g = 1; packed, the up to 8 lanes of one work row times g
//    heads, in ceil(min(8 g, 64) / 16) warps: two at g = 4, one at g = 1,
//    whose 16-row tile is then half empty), walks the slot's block table
//    in 32-key tiles
//    through a three-stage cp.async ring, and does Q.K^T and P.V with
//    mma.sync.m16n8k16; int8 codes and scales are staged as stored and
//    dequantized (code x scale in fp32, rounded to q's type) while the B
//    fragments are built.  A decode step or a verify window gives few
//    blocks (8 slots x 8 kv heads at qwen3-4b), so the page walk is split
//    over several blocks (flash-decoding): the wrapper picks the split
//    count (decode_attention.mixed_splits; packed_plan for the packed
//    kernel, whose grid of work rows x kv heads is split only in narrow
//    streams) so the grid covers the card's SMs, each split writes its (m,
//    l, acc) to a scratch buffer, and the last split of a (unit, kv head,
//    row tile) to finish merges them in the same launch.  What bounds it
//    at these shapes is latency, not bytes: each block (or split) walks
//    only a few tiles, so the fixed cost of a block (staging Q, reading
//    positions through the block table, the partials and the merge) is
//    most of its time (PERF.md).
//  * fp32, the decode, mixed and packed kernels, and the dense kernel at
//    fp32 (or unaligned inputs): attend_rows, on CUDA cores.  One block
//    per (slot, work row or query window, kv head) so the g = Hq / Hkv
//    query heads that share a kv head read each page once; every page is
//    staged through shared memory in 16-key tiles, whose positions are
//    read first so tiles with no visible key (unwritten tails of a slot's
//    pages, keys beyond a window) are skipped without reading their K/V.  Scores, the online softmax and the accumulator are fp32, with
//    the same -inf-safe rescaling as the reference's _attend_block_mq.  A
//    tensor-core body would multiply in TF32, and the card's fp32 greedy
//    streams must keep equalling the CPU's.  What bounds attend_rows is its
//    serial per-thread dot products out of shared memory and four block
//    barriers per tile with no overlap of loads and compute.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "dtype.cuh"
#include "paged_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyTile = 16;
constexpr int kPackedBlockQ = 8;  // lanes per packed work row (PACKED_BLOCK_Q)
constexpr size_t kMaxSmem = 227 * 1024;

// One K/V element as fp32: pools at the compute dtype convert, int8 pools
// dequantize with the entry's scale (scale unused otherwise).
template <typename KV>
__device__ __forceinline__ float kv_at(const KV* pool, long i, const float*,
                                       long) {
  return to_f(pool[i]);
}
__device__ __forceinline__ float kv_at(const int8_t* pool, long i,
                                       const float* scale, long si) {
  return (float)pool[i] * scale[si];
}

struct Params {
  const void* q;       // decode (B,1,Hq,D), packed (1,T,Hq,D), mixed (B,W,..)
  const void* kpool;   // (P,page,Hkv,D)
  const void* vpool;   // (P,page,Hkv,Dv)
  const float* kscale; // int8 pools only: (P,page,Hkv)
  const float* vscale; // int8 pools only: (P,page,Hkv)
  const int* ppos;     // (P,page)
  const int* bt;       // (rows of the block table, npages)
  const int* q_pos;    // decode (B,1) | packed (1,T) | mixed (B,W)
  const int* meta;     // packed only: (n_work,4) slot, tile, win_start, win_end
  void* out;           // like q with Dv
  int Hq, Hkv, g, D, Dv, page, npages;
  int W;               // mixed only: query lanes per slot
  float scale, softcap;  // softcap <= 0: none
  int window;            // window <= 0: none
};

__host__ __device__ inline size_t smem_floats(int rows, int D, int Dv) {
  // q rows, K tile (padded rows), V tile, score tile, accumulator,
  // m / l / alpha per row, then key and row positions as ints
  return (size_t)rows * D + (size_t)kKeyTile * (D + 1) +
         (size_t)kKeyTile * Dv + (size_t)rows * kKeyTile +
         (size_t)rows * Dv + 3 * (size_t)rows + kKeyTile + rows;
}

// Attend n_rows query rows (row r = lane r / g, head r % g of kv head h)
// to every page of one block-table row.  q/o point at the first lane's
// first query head of the group; lanes are q_lane / o_lane elements apart.
// KV is the pools' element type: T, or int8_t with p.kscale / p.vscale.
template <typename T, typename KV>
__device__ void attend_rows(const Params& p, int n_rows, const T* q,
                            long q_lane, T* o, long o_lane, const int* qpos,
                            const int* bt_row, int h, float* smem) {
  const int D = p.D, Dv = p.Dv, g = p.g, page = p.page, KT = kKeyTile;
  float* qs = smem;                        // [n_rows][D]
  float* ks = qs + (size_t)n_rows * D;     // [KT][D + 1]
  float* vs = ks + (size_t)KT * (D + 1);   // [KT][Dv]
  float* ss = vs + (size_t)KT * Dv;        // [n_rows][KT]
  float* acc = ss + (size_t)n_rows * KT;   // [n_rows][Dv]
  float* ms = acc + (size_t)n_rows * Dv;   // running max
  float* ls = ms + n_rows;                 // running denominator
  float* al = ls + n_rows;                 // this tile's rescale factor
  int* kp = reinterpret_cast<int*>(al + n_rows);  // [KT]
  int* qp = kp + KT;                               // [n_rows]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const KV* kpool = static_cast<const KV*>(p.kpool);
  const KV* vpool = static_cast<const KV*>(p.vpool);

  for (int i = tid; i < n_rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[i] = to_f(q[(r / g) * q_lane + (r % g) * D + d]);
  }
  for (int i = tid; i < n_rows * Dv; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < n_rows; r += kThreads) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
    qp[r] = qpos[r / g];
  }
  int live = 0;
  for (int r = tid; r < n_rows; r += kThreads) live |= qpos[r / g] >= 0;
  // rows that are all padding see no key: skip the pages, write zeros
  const int npages = __syncthreads_or(live) ? p.npages : 0;

  for (int j = 0; j < npages; ++j) {
    const int pid = bt_row[j];
    if (pid < 0) continue;  // unallocated: the reference masks it out
    for (int t0 = 0; t0 < page; t0 += KT) {
      const int nk = min(KT, page - t0);
      const long row0 = (long)pid * page + t0;  // first pool entry of tile
      if (tid < nk) kp[tid] = p.ppos[row0 + tid];
      __syncthreads();
      int any = 0;
      for (int i = tid; i < n_rows * nk; i += kThreads)
        any |= visible(kp[i % nk], qp[i / nk], p.window);
      if (!__syncthreads_or(any)) continue;  // nothing visible: skip K/V

      for (int i = tid; i < nk * D; i += kThreads) {
        const int t = i / D, d = i % D;
        const long e = (row0 + t) * p.Hkv + h;  // (entry, kv head)
        ks[t * (D + 1) + d] = kv_at(kpool, e * D + d, p.kscale, e);
      }
      for (int i = tid; i < nk * Dv; i += kThreads) {
        const int t = i / Dv, d = i % Dv;
        const long e = (row0 + t) * p.Hkv + h;
        vs[i] = kv_at(vpool, e * Dv + d, p.vscale, e);
      }
      __syncthreads();

      for (int i = tid; i < n_rows * nk; i += kThreads) {
        const int r = i / nk, t = i % nk;
        float s = -INFINITY;
        if (visible(kp[t], qp[r], p.window)) {
          const float* qr = qs + (size_t)r * D;
          const float* kt = ks + (size_t)t * (D + 1);
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kt[d], dot);
          s = dot * p.scale;
          if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
        }
        ss[r * KT + t] = s;
      }
      __syncthreads();

      for (int r = warp; r < n_rows; r += kWarps) {
        float mx = -INFINITY;
        for (int t = lane; t < nk; t += 32) mx = fmaxf(mx, ss[r * KT + t]);
        mx = warp_max(mx);
        const float m_prev = ms[r];
        const float m_new = fmaxf(m_prev, mx);
        const float m_safe = isinf(m_new) ? 0.f : m_new;
        const float alpha = isinf(m_prev) ? 0.f : expf(m_prev - m_safe);
        float sum = 0.f;
        for (int t = lane; t < nk; t += 32) {
          const float s = ss[r * KT + t];
          const float e = isinf(s) ? 0.f : expf(s - m_safe);
          ss[r * KT + t] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          ms[r] = m_new;
          ls[r] = ls[r] * alpha + sum;
          al[r] = alpha;
        }
      }
      __syncthreads();

      for (int i = tid; i < n_rows * Dv; i += kThreads) {
        const int r = i / Dv, d = i % Dv;
        float a = acc[i] * al[r];
        for (int t = 0; t < nk; ++t) a = fmaf(ss[r * KT + t], vs[t * Dv + d], a);
        acc[i] = a;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < n_rows * Dv; i += kThreads) {
    const int r = i / Dv, d = i % Dv;
    // a row with no visible key has l == 0 and acc == 0: it writes 0
    o[(r / g) * o_lane + (r % g) * Dv + d] =
        from_f<T>(acc[i] / fmaxf(ls[r], 1e-37f));
  }
}

// grid (B, Hkv), fp32 q only: slot b's single query token, query heads
// h*g .. h*g+g-1
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const T* q = static_cast<const T*>(p.q) + ((long)b * p.Hq + h * p.g) * p.D;
  T* o = static_cast<T*>(p.out) + ((long)b * p.Hq + h * p.g) * p.Dv;
  attend_rows<T, KV>(p, p.g, q, (long)p.Hq * p.D, o, (long)p.Hq * p.Dv,
                     p.q_pos + b, p.bt + (long)b * p.npages, h, smem);
}

// grid (n_work, Hkv), fp32 q only: work row w serves stream lanes
// [win_start, win_end) of slot meta[w, 0]; rows with slot < 0 are unused.
// Each lane is owned by exactly one row, so rows write disjoint outputs.
template <typename KV>
__global__ void __launch_bounds__(kThreads) paged_packed_kernel(Params p) {
  extern __shared__ float smem[];
  const int w = blockIdx.x, h = blockIdx.y;
  const int slot = p.meta[4 * w], ws = p.meta[4 * w + 2];
  const int lanes = min(p.meta[4 * w + 3] - ws, kPackedBlockQ);
  if (slot < 0 || lanes <= 0) return;
  const float* q =
      static_cast<const float*>(p.q) + ((long)ws * p.Hq + h * p.g) * p.D;
  float* o = static_cast<float*>(p.out) + ((long)ws * p.Hq + h * p.g) * p.Dv;
  attend_rows<float, KV>(p, lanes * p.g, q, (long)p.Hq * p.D, o,
                         (long)p.Hq * p.Dv, p.q_pos + ws,
                         p.bt + (long)slot * p.npages, h, smem);
}

// grid (B * ceil(W / 8), Hkv), fp32 q only: block x serves query lanes
// [8t, min(8t + 8, W)) of slot b = x / ceil(W / 8), t = x % ceil(W / 8),
// like a packed work row serves its window.  Padding lanes (q_pos == -1)
// see no key and come back as zeros.
template <typename KV>
__global__ void __launch_bounds__(kThreads) paged_mixed_kernel(Params p) {
  extern __shared__ float smem[];
  const int tiles = (p.W + kPackedBlockQ - 1) / kPackedBlockQ;
  const int b = blockIdx.x / tiles, h = blockIdx.y;
  const int w0 = (blockIdx.x % tiles) * kPackedBlockQ;
  const long lane0 = (long)b * p.W + w0;
  const float* q =
      static_cast<const float*>(p.q) + (lane0 * p.Hq + h * p.g) * p.D;
  float* o = static_cast<float*>(p.out) + (lane0 * p.Hq + h * p.g) * p.Dv;
  attend_rows<float, KV>(p, min(p.W - w0, kPackedBlockQ) * p.g, q,
                         (long)p.Hq * p.D, o, (long)p.Hq * p.Dv,
                         p.q_pos + lane0, p.bt + (long)b * p.npages, h,
                         smem);
}

// grid (B, Hkv): row b's single query token against its contiguous cache
// k/v (B,Sk,Hkv,D[v]) with positions k_pos (B,Sk), passed as the pools and
// ppos with page = Sk; row b's one-entry block table is page b itself.
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads) dense_decode_kernel(Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int page_id = b;
  const T* q = static_cast<const T*>(p.q) + ((long)b * p.Hq + h * p.g) * p.D;
  T* o = static_cast<T*>(p.out) + ((long)b * p.Hq + h * p.g) * p.Dv;
  attend_rows<T, KV>(p, p.g, q, (long)p.Hq * p.D, o, (long)p.Hq * p.Dv,
                     p.q_pos + b, &page_id, h, smem);
}

cudaError_t launch_kernel(void (*kernel)(Params), int blocks, int max_rows,
                          const Params& p, cudaStream_t stream) {
  if (blocks == 0) return cudaSuccess;
  const size_t smem = smem_floats(max_rows, p.D, p.Dv) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = opt_in_smem((const void*)kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(blocks, p.Hkv), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The dense decode kernel's CUDA-core body at q's dtype (pools at q's
// dtype).
cudaError_t dispatch_dense(int dtype, int blocks, int max_rows,
                           const Params& p, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_kernel(dense_decode_kernel<float, float>, blocks,
                           max_rows, p, stream);
    case 1:
      return launch_kernel(dense_decode_kernel<__half, __half>, blocks,
                           max_rows, p, stream);
    case 2:
      return launch_kernel(
          dense_decode_kernel<__nv_bfloat16, __nv_bfloat16>, blocks,
          max_rows, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

enum Kind { kDecode, kMixed, kPacked };

// The decode, mixed and packed launches over ``units`` (decode and mixed:
// batch rows of p.W lanes, one at decode; packed: the n_work rows of
// p.meta, up to kPackedBlockQ lanes each): fp32 q takes attend_rows (one
// split only), bf16 / fp16 q the tensor-core body with ``splits`` splits
// of pages_per_split pages each; scratch holds (units * row_tiles * Hkv *
// splits) x 64 x (Dv + 2) floats and counters units * row_tiles * Hkv
// zeros when splits > 1.
cudaError_t launch_windows(Kind kind, int dtype, bool quant, const Params& p,
                           int units, int splits, int pages_per_split,
                           float* scratch, int* counters,
                           cudaStream_t stream) {
  if (dtype == 0) {
    if (splits != 1) return cudaErrorInvalidValue;
    if (kind == kDecode)
      return launch_kernel(quant ? paged_decode_kernel<float, int8_t>
                                 : paged_decode_kernel<float, float>,
                           units, p.g, p, stream);
    if (kind == kPacked)
      return launch_kernel(quant ? paged_packed_kernel<int8_t>
                                 : paged_packed_kernel<float>,
                           units, kPackedBlockQ * p.g, p, stream);
    const int blocks = units * ((p.W + kPackedBlockQ - 1) / kPackedBlockQ);
    const int rows = min(p.W, kPackedBlockQ) * p.g;
    return launch_kernel(quant ? paged_mixed_kernel<int8_t>
                               : paged_mixed_kernel<float>,
                         blocks, rows, p, stream);
  }
  MmaArgs a{};
  a.q = p.q;
  a.k = p.kpool;
  a.v = p.vpool;
  a.kscale = p.kscale;
  a.vscale = p.vscale;
  a.kpos = p.ppos;
  a.bt = p.bt;
  a.q_pos = p.q_pos;
  a.meta = kind == kPacked ? p.meta : nullptr;
  a.out = p.out;
  a.NQ = kind == kPacked ? kPackedBlockQ : p.W;
  a.Sk = p.npages * p.page;
  a.Hq = p.Hq;
  a.Hkv = p.Hkv;
  a.g = p.g;
  a.D = p.D;
  a.Dv = p.Dv;
  a.page = p.page;
  a.npages = p.npages;
  a.row_tiles = (a.NQ * p.g + kMmaRows - 1) / kMmaRows;
  a.splits = splits;
  a.keys_per_split = pages_per_split * p.page;
  a.scale = p.scale;
  a.softcap = p.softcap;
  a.window = p.window;
  if (splits < 1 || splits > kMmaMaxSplits || pages_per_split < 1 ||
      (splits > 1 && (scratch == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  if (splits > 1) {
    const long long parts =
        (long long)units * a.row_tiles * p.Hkv * splits * kMmaRows;
    a.part = scratch;
    a.part_ml = scratch + parts * p.Dv;
    a.counters = counters;
  }
  switch (kind) {
    case kDecode:
      return repro_attn::paged_decode_mma_launch(dtype, quant, a, units,
                                                 stream);
    case kPacked:
      return repro_attn::paged_packed_mma_launch(dtype, quant, a, units,
                                                 stream);
    default:
      return repro_attn::paged_mixed_mma_launch(dtype, quant, a, units,
                                                stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q and out; the pools
// too, except in the _q8 entry points, whose pools are int8 codes with
// fp32 scale pools (P,page,Hkv)).  Each returns cudaGetLastError() after
// the launch (0 on success).
// Decode: q (B,1,Hq,D), q_pos (B,1), block_tables (B,npages); splits /
// pages_per_split / scratch / counters as in launch_windows (fp32: one
// split, no scratch).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* kpool, const void* vpool, const void* ppos,
    const void* block_tables, const void* q_pos, void* out, void* scratch,
    void* counters, int dtype, int B, int Hq, int Hkv, int D, int Dv,
    int page, int npages, int splits, int pages_per_split, float scale,
    float softcap, int window, void* stream) {
  Params p{q, kpool, vpool, nullptr, nullptr, static_cast<const int*>(ppos),
           static_cast<const int*>(block_tables),
           static_cast<const int*>(q_pos), nullptr, out,
           Hq, Hkv, Hq / Hkv, D, Dv, page, npages, 1, scale, softcap, window};
  return (int)launch_windows(kDecode, dtype, false, p, B, splits,
                             pages_per_split, static_cast<float*>(scratch),
                             static_cast<int*>(counters),
                             static_cast<cudaStream_t>(stream));
}

// Packed: q (1,T,Hq,D), q_pos (1,T), block_tables (slots,npages), meta
// (n_work,4); splits / pages_per_split / scratch / counters as in
// launch_windows, over the n_work rows.
extern "C" int paged_packed_attention_launch(
    const void* q, const void* kpool, const void* vpool, const void* ppos,
    const void* block_tables, const void* q_pos, const void* meta, void* out,
    void* scratch, void* counters, int dtype, int n_work, int Hq, int Hkv,
    int D, int Dv, int page, int npages, int splits, int pages_per_split,
    float scale, float softcap, int window, void* stream) {
  Params p{q, kpool, vpool, nullptr, nullptr, static_cast<const int*>(ppos),
           static_cast<const int*>(block_tables),
           static_cast<const int*>(q_pos), static_cast<const int*>(meta), out,
           Hq, Hkv, Hq / Hkv, D, Dv, page, npages, 0, scale, softcap, window};
  return (int)launch_windows(kPacked, dtype, false, p, n_work, splits,
                             pages_per_split, static_cast<float*>(scratch),
                             static_cast<int*>(counters),
                             static_cast<cudaStream_t>(stream));
}

extern "C" int paged_decode_attention_q8_launch(
    const void* q, const void* kpool, const void* kscale, const void* vpool,
    const void* vscale, const void* ppos, const void* block_tables,
    const void* q_pos, void* out, void* scratch, void* counters, int dtype,
    int B, int Hq, int Hkv, int D, int Dv, int page, int npages, int splits,
    int pages_per_split, float scale, float softcap, int window,
    void* stream) {
  Params p{q, kpool, vpool, static_cast<const float*>(kscale),
           static_cast<const float*>(vscale), static_cast<const int*>(ppos),
           static_cast<const int*>(block_tables),
           static_cast<const int*>(q_pos), nullptr, out,
           Hq, Hkv, Hq / Hkv, D, Dv, page, npages, 1, scale, softcap, window};
  return (int)launch_windows(kDecode, dtype, true, p, B, splits,
                             pages_per_split, static_cast<float*>(scratch),
                             static_cast<int*>(counters),
                             static_cast<cudaStream_t>(stream));
}

extern "C" int paged_packed_attention_q8_launch(
    const void* q, const void* kpool, const void* kscale, const void* vpool,
    const void* vscale, const void* ppos, const void* block_tables,
    const void* q_pos, const void* meta, void* out, void* scratch,
    void* counters, int dtype, int n_work, int Hq, int Hkv, int D, int Dv,
    int page, int npages, int splits, int pages_per_split, float scale,
    float softcap, int window, void* stream) {
  Params p{q, kpool, vpool, static_cast<const float*>(kscale),
           static_cast<const float*>(vscale), static_cast<const int*>(ppos),
           static_cast<const int*>(block_tables),
           static_cast<const int*>(q_pos), static_cast<const int*>(meta), out,
           Hq, Hkv, Hq / Hkv, D, Dv, page, npages, 0, scale, softcap, window};
  return (int)launch_windows(kPacked, dtype, true, p, n_work, splits,
                             pages_per_split, static_cast<float*>(scratch),
                             static_cast<int*>(counters),
                             static_cast<cudaStream_t>(stream));
}

// Mixed windows: q (B,W,Hq,D), q_pos (B,W), block_tables (B,npages);
// splits / pages_per_split / scratch / counters as in launch_windows.
extern "C" int paged_mixed_attention_launch(
    const void* q, const void* kpool, const void* vpool, const void* ppos,
    const void* block_tables, const void* q_pos, void* out, void* scratch,
    void* counters, int dtype, int B, int W, int Hq, int Hkv, int D, int Dv,
    int page, int npages, int splits, int pages_per_split, float scale,
    float softcap, int window, void* stream) {
  Params p{q, kpool, vpool, nullptr, nullptr, static_cast<const int*>(ppos),
           static_cast<const int*>(block_tables),
           static_cast<const int*>(q_pos), nullptr, out,
           Hq, Hkv, Hq / Hkv, D, Dv, page, npages, W, scale, softcap, window};
  return (int)launch_windows(kMixed, dtype, false, p, B, splits,
                             pages_per_split, static_cast<float*>(scratch),
                             static_cast<int*>(counters),
                             static_cast<cudaStream_t>(stream));
}

extern "C" int paged_mixed_attention_q8_launch(
    const void* q, const void* kpool, const void* kscale, const void* vpool,
    const void* vscale, const void* ppos, const void* block_tables,
    const void* q_pos, void* out, void* scratch, void* counters, int dtype,
    int B, int W, int Hq, int Hkv, int D, int Dv, int page, int npages,
    int splits, int pages_per_split, float scale, float softcap, int window,
    void* stream) {
  Params p{q, kpool, vpool, static_cast<const float*>(kscale),
           static_cast<const float*>(vscale), static_cast<const int*>(ppos),
           static_cast<const int*>(block_tables),
           static_cast<const int*>(q_pos), nullptr, out,
           Hq, Hkv, Hq / Hkv, D, Dv, page, npages, W, scale, softcap, window};
  return (int)launch_windows(kMixed, dtype, true, p, B, splits,
                             pages_per_split, static_cast<float*>(scratch),
                             static_cast<int*>(counters),
                             static_cast<cudaStream_t>(stream));
}

// Dense decode: q (B,1,Hq,D) against k/v (B,Sk,Hkv,D[v]) with k_pos (B,Sk).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_pos,
    const void* q_pos, void* out, int dtype, int B, int Hq, int Hkv, int D,
    int Dv, int Sk, float scale, float softcap, int window, void* stream) {
  Params p{q, k, v, nullptr, nullptr, static_cast<const int*>(k_pos),
           nullptr, static_cast<const int*>(q_pos), nullptr, out,
           Hq, Hkv, Hq / Hkv, D, Dv, Sk, 1, 0, scale, softcap, window};
  return (int)dispatch_dense(dtype, B, p.g, p,
                            static_cast<cudaStream_t>(stream));
}

// Shared-memory bytes a launch needs for rows query rows per block.
extern "C" long paged_attention_smem_bytes(int rows, int D, int Dv) {
  return (long)(smem_floats(rows, D, Dv) * sizeof(float));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
