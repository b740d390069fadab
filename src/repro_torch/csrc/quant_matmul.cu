// Weight-only int8 matrix product for Hopper (sm_90a), bound to PyTorch
// through a plain C interface (ctypes); see
// repro_torch/kernels/quant_matmul.py.
//
// Replaces the Pallas TPU kernel repro/kernels/quant_matmul.py
// quant_matmul (body _kernel):
//
//     out (M, N) fp32 = (x (M, K) @ q (K, N) int8) * s (N,) fp32
//
// with q row-major as core/precision.py stores it.  An int8 code is exact
// at bf16 and fp16 (|code| <= 128), and so is x at its own type, so every
// product is exact in the fp32 accumulator and the per-output-channel
// scale multiplies once per output in the epilogue (x @ (q * s) ==
// (x @ q) * s, as the TPU kernel does); only the order of the fp32 sums
// differs from the plain version.
//
// Three bodies, chosen by x's dtype and M (the plan comes from
// quant_matmul.qmm_plan and is checked here; no shape of one dtype reaches
// another dtype's body, and nothing falls back):
//
//  * fp32 x: quant_matmul_kernel, on CUDA cores.  A tensor-core body would
//    multiply in TF32, and the card's fp32 greedy streams must keep
//    equalling the CPU's.  Each block owns 32 output columns (one per
//    lane) and 8, 16 or 32 rows of x, staged as fp32 in shared memory;
//    small grids split K over blockIdx.z and a second kernel adds the
//    splits in order.
//  * bf16 / fp16 x, M <= 8 (decode steps, the tied head):
//    quant_matmul_mma_decode_kernel.  Bound by the code bytes (K x N read
//    once; 16 flops a byte at M = 8).  mma.sync.m16n8k16 with the operands
//    swapped: A (16 rows) is 16 output columns of the weight, B (8
//    columns) is x's rows, so no lane of the mma is padding at M = 8.  A
//    block owns 128 columns and walks its slice of K in 64-row tiles
//    through a four-stage ring of 16-byte cp.async copies (codes and x);
//    each of its 4 warps takes 16 rows of a tile, reads 16 code bytes of
//    each of 4 rows (one 16-byte shared-memory load each) and builds 8 A
//    fragments from them by byte permutes (code_pair in mma.cuh), the
//    columns of a warp's m-tiles interleaved so every byte it loads is
//    used.  The warps' sums are added in warp order.
//  * bf16 / fp16 x, M > 8 (verify and prefill streams):
//    quant_matmul_mma_tiled_kernel, 64 rows of x x 128 columns per block,
//    64-row K tiles of x and codes through a four-stage cp.async ring, A
//    from x by ldmatrix, B fragments dequantized from the codes as they
//    are built; each tile's sums are added to the running fp32 sums with
//    round-to-nearest adds (the tensor cores' own accumulation truncates,
//    and over K = 9728 in one chain its bias passes 1e-5 of the output's
//    scale at fp16).  Bound by the tensor cores' rate at M = 256 (2 M K N
//    flops against K N code bytes), by bytes at M = 40.  What holds it
//    back at M = 256 is the bytes each SM stages: every 64 x 128 block
//    re-reads its x rows and its codes from L2 (about 195 MB at 2560 ->
//    9728, 15x the codes), and the bf16 conversions (PERF.md).
//
// Split-K (both tensor-core bodies, where the grid alone would not fill
// the card): blockIdx.y (decode) or blockIdx.z (tiled) is the split, each
// split writes its unscaled fp32 tile to a scratch buffer, and the last
// block of a tile to arrive (an atomic counter, reset after) adds the
// splits in split order, scales and writes the output: one launch, no
// float atomics, the same result every run.  Ragged shapes are handled in
// the kernels: 16-byte copies where rows are 16-byte aligned (N % 16 == 0
// for the codes, K % 8 == 0 for x), element copies otherwise; rows past K
// and M and columns past N are zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "mma.cuh"

namespace {

enum Body { kSimt = 0, kMmaDecode = 1, kMmaTiled = 2 };

__host__ __device__ inline int cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kQmThreads = 256;
constexpr int kQmWarps = kQmThreads / 32;
constexpr int kQmCols = 32;            // output columns per block
constexpr int kQmKChunk = 256;         // rows of q per staged x tile
constexpr int kMaxSplits = 16;

int m_tile(int M) { return M <= 8 ? 8 : M <= 16 ? 16 : 32; }

// grid (N / 32, M / MT, splits); split z covers q rows
// [z * chunks * 256, (z + 1) * chunks * 256).  part == nullptr: write
// out = sum * s; else write the unscaled sum to part[z].  Each block's 8
// warps take interleaved rows of q; the x tile of each 256-row slice of K
// is staged in shared memory (read along x's rows, so the loads
// coalesce) and read by every lane as broadcasts.
template <int MT>
__global__ void __launch_bounds__(kQmThreads)
    quant_matmul_kernel(const float* x, const int8_t* q, const float* s,
                        float* out, float* part, int M, int K, int N,
                        int chunks) {
  // the staged x tile [256][XS] (a row per k, MT values used; the 4
  // spare floats keep the float4 reads aligned and spread the stores
  // over the banks), later the warps' sums [8][MT][32]
  constexpr int XS = MT + 4;
  __shared__ __align__(16) float sm[kQmKChunk * XS];
  static_assert(kQmKChunk * XS >= kQmWarps * MT * kQmCols, "smem reuse");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockIdx.x * kQmCols + lane;
  const int m0 = blockIdx.y * MT;
  const int k_begin = blockIdx.z * chunks * kQmKChunk;
  const int k_end = min(K, k_begin + chunks * kQmKChunk);
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kQmKChunk) {
    const int kc = min(kQmKChunk, k_end - k0);
    __syncthreads();  // the previous tile has been read
    for (int i = threadIdx.x; i < kQmKChunk * MT; i += kQmThreads) {
      const int m = i / kQmKChunk, kk = i % kQmKChunk;
      sm[kk * XS + m] = (kk < kc && m0 + m < M)
                            ? x[(long)(m0 + m) * K + k0 + kk] : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int8_t* qc = q + (long)k0 * N + n;
#pragma unroll 8
      for (int kk = warp; kk < kc; kk += kQmWarps) {
        const float w = (float)qc[(long)kk * N];
        const float4* xr = reinterpret_cast<const float4*>(sm + kk * XS);
#pragma unroll
        for (int j = 0; j < MT / 4; ++j) {
          const float4 xv = xr[j];
          acc[4 * j] = fmaf(xv.x, w, acc[4 * j]);
          acc[4 * j + 1] = fmaf(xv.y, w, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(xv.z, w, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(xv.w, w, acc[4 * j + 3]);
        }
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) sm[(warp * MT + m) * kQmCols + lane] = acc[m];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * kQmCols; i += kQmThreads) {
    const int m = i / kQmCols, c = i % kQmCols;
    const int row = m0 + m, col = blockIdx.x * kQmCols + c;
    if (row >= M || col >= N) continue;
    float sum = 0.f;
    for (int w = 0; w < kQmWarps; ++w) sum += sm[(w * MT + m) * kQmCols + c];
    if (part)
      part[((long)blockIdx.z * M + row) * N + col] = sum;
    else
      out[(long)row * N + col] = sum * s[col];
  }
}

// out[i] = s[col] * (sum of the splits' partial sums, in split order)
__global__ void quant_matmul_reduce_kernel(const float* part, const float* s,
                                           float* out, int splits, long MN,
                                           int N) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float sum = 0.f;
  for (int z = 0; z < splits; ++z) sum += part[z * MN + i];
  out[i] = sum * s[i % N];
}

template <int MT>
cudaError_t launch_simt_mt(const float* x, const int8_t* q, const float* s,
                           float* out, float* part, int M, int K, int N,
                           int splits, int chunks, cudaStream_t stream) {
  const dim3 grid(cdiv(N, kQmCols), cdiv(M, MT), splits);
  quant_matmul_kernel<MT><<<grid, kQmThreads, 0, stream>>>(
      x, q, s, out, splits > 1 ? part : nullptr, M, K, N, chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long MN = (long)M * N;
  quant_matmul_reduce_kernel<<<cdiv(MN, 256), 256, 0, stream>>>(
      part, s, out, splits, MN, N);
  return cudaGetLastError();
}

cudaError_t launch_simt(const float* x, const int8_t* q, const float* s,
                        float* out, float* part, int M, int K, int N,
                        int splits, int chunks, cudaStream_t stream) {
  switch (m_tile(M)) {
    case 8: return launch_simt_mt<8>(x, q, s, out, part, M, K, N, splits,
                                     chunks, stream);
    case 16: return launch_simt_mt<16>(x, q, s, out, part, M, K, N, splits,
                                       chunks, stream);
    default: return launch_simt_mt<32>(x, q, s, out, part, M, K, N, splits,
                                       chunks, stream);
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;             // 4 warps
constexpr int kBN = 128;                     // output columns per block
constexpr int kBK = 64;                      // rows of q per tile
constexpr int kDecodeRows = 8;               // x rows of the decode body
constexpr int kTiledRows = 64;               // x rows of a tiled block
constexpr int kDecodeStages = 4;
constexpr int kTiledStages = 4;
constexpr int kTiledBlocksPerSM = 3;         // registers and shared memory
// staged rows padded by 16 bytes: the rows a warp reads at once fall in
// distinct banks
constexpr int kCodeStride = kBN + 16;        // bytes per row of codes
constexpr int kXStride = kBK * 2 + 16;       // bytes per row of x
constexpr int kCodeBytes = kBK * kCodeStride;

__host__ __device__ constexpr int stage_bytes(int x_rows) {
  return kCodeBytes + x_rows * kXStride;
}
constexpr int kDecodeSmem = kDecodeStages * stage_bytes(kDecodeRows);
constexpr int kTiledSmem = kTiledStages * stage_bytes(kTiledRows);
static_assert(kDecodeSmem >= 4 * kDecodeRows * kBN * 4, "warp sums fit");

struct QmArgs {
  const void* x;          // (M, K) bf16 / fp16
  const int8_t* q;        // (K, N)
  const float* s;         // (N,)
  float* out;             // (M, N)
  float* part;            // splits > 1: (tiles, splits, rows, 128)
  int* counters;          // splits > 1: (tiles), 0 between launches
  int M, K, N;
  int splits, k_per_split;  // k_per_split a multiple of kBK
  int vec_q, vec_x;         // rows 16-byte aligned: 16-byte copies
};

// Request codes rows [k0, k0 + 64) x columns [n0, n0 + 128) into dst
// (zeros past k_end and N).
__device__ __forceinline__ void load_codes(const QmArgs& a, char* dst, int k0,
                                           int k_end, int n0) {
  if (a.vec_q) {
    for (int i = threadIdx.x; i < kBK * kBN / 16; i += blockDim.x) {
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < k_end && n < a.N;     // N % 16 == 0
      cp_async16(dst + r * kCodeStride + c,
                 ok ? a.q + (long long)k * a.N + n : a.q, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * kBN / 4; i += blockDim.x) {
      const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
      const int k = k0 + r;
      uint32_t w = 0;
      if (k < k_end) {
        const int8_t* row = a.q + (long long)k * a.N + n0 + c;
        for (int j = 0; j < 4 && n0 + c + j < a.N; ++j)
          w |= (uint32_t)(uint8_t)row[j] << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(dst + r * kCodeStride + c) = w;
    }
  }
}

// Request x rows [m0, m0 + rows) x [k0, k0 + 64) into dst (zeros past M
// and k_end).
template <typename T>
__device__ __forceinline__ void load_x(const QmArgs& a, char* dst, int rows,
                                       int m0, int k0, int k_end) {
  const T* x = static_cast<const T*>(a.x);
  if (a.vec_x) {
    for (int i = threadIdx.x; i < rows * (kBK / 8); i += blockDim.x) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < a.M && k < k_end;     // K % 8 == 0
      cp_async16(dst + r * kXStride + c * 2,
                 ok ? x + (long long)m * a.K + k : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kBK; i += blockDim.x) {
      const int r = i / kBK, c = i % kBK;
      const int m = m0 + r, k = k0 + c;
      reinterpret_cast<T*>(dst + r * kXStride)[c] =
          m < a.M && k < k_end ? x[(long long)m * a.K + k] : from_f<T>(0.f);
    }
  }
}

// After the block's unscaled partial tile (rows_valid rows of 128 floats)
// is written at part, split-major per tile: whether this block is the last
// of the tile's splits to arrive (then every split's tile is visible).
__device__ __forceinline__ bool last_arrival(const QmArgs& a, int tile) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.counters + tile, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// The last block of a tile: out = s * (sum of the splits' tiles, in split
// order) for its rows_valid rows from m0 and columns from n0; resets the
// tile's counter.  Each thread sums two float4 column groups, loading
// eight splits of both at once (16 loads in flight) before adding them in
// order, so a merge of up to 8 splits is one round trip to L2.
__device__ void merge_splits(const QmArgs& a, const float* tile_part,
                             int tile_floats, int rows_valid, int m0, int n0,
                             int tile) {
  constexpr int U = 2, C = 8;
  const int n4 = rows_valid * kBN / 4;
  const int nt = blockDim.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = threadIdx.x; i0 < n4; i0 += U * nt) {
    float4 acc[U] = {zero, zero};
    for (int s0 = 0; s0 < a.splits; s0 += C) {
      float4 v[C][U];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4* src = reinterpret_cast<const float4*>(
            tile_part + (long long)(s0 + c) * tile_floats);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * nt;
          v[c][u] = s0 + c < a.splits && i < n4 ? __ldcg(src + i) : zero;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          acc[u].x += v[c][u].x;
          acc[u].y += v[c][u].y;
          acc[u].z += v[c][u].z;
          acc[u].w += v[c][u].w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nt;
      if (i >= n4) break;
      const int row = m0 + i * 4 / kBN, col = n0 + i * 4 % kBN;
      const float v[4] = {acc[u].x, acc[u].y, acc[u].z, acc[u].w};
      float* o = a.out + (long long)row * a.N;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < a.N) o[col + e] = v[e] * a.s[col + e];
    }
  }
  if (threadIdx.x == 0) a.counters[tile] = 0;
}

// grid (ceil(N / 128), splits), 4 warps, M <= 8.  Split y walks q rows
// [y * k_per_split, ...) in 64-row tiles; warp w multiplies rows
// [16 w, 16 w + 16) of each tile.  Lane (gid, tig) owns output columns
// gid * 16 .. gid * 16 + 15 of the block: m-tile j's A rows gid and gid + 8
// are columns gid * 16 + 2 j and + 1, so the lane's 16 code bytes of one q
// row feed all 8 m-tiles; B's column n is x's row n.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads)
    quant_matmul_mma_decode_kernel(QmArgs a) {
  extern __shared__ __align__(16) char qsm[];
  constexpr int kStage = stage_bytes(kDecodeRows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kBN, split = blockIdx.y;
  const int k_begin = split * a.k_per_split;
  const int k_end = min(a.K, k_begin + a.k_per_split);
  const int ntiles = max(0, cdiv(k_end - k_begin, kBK));

  auto fetch = [&](int t) {
    if (t < ntiles) {
      char* st = qsm + (t % kDecodeStages) * kStage;
      const int k0 = k_begin + t * kBK;
      load_codes(a, st, k0, k_end, n0);
      load_x<T>(a, st + kCodeBytes, kDecodeRows, 0, k0, k_end);
    }
    cp_async_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int t = 0; t < kDecodeStages - 1; ++t) fetch(t);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kDecodeStages - 2>();
    __syncthreads();              // tile t is in; tile t - 1 has been read
    fetch(t + kDecodeStages - 1);
    const char* st = qsm + (t % kDecodeStages) * kStage;
    const char* cr = st + (warp * 16 + 2 * tig) * kCodeStride + gid * 16;
    const uint4 q0 = *reinterpret_cast<const uint4*>(cr);
    const uint4 q1 = *reinterpret_cast<const uint4*>(cr + kCodeStride);
    const uint4 q2 = *reinterpret_cast<const uint4*>(cr + 8 * kCodeStride);
    const uint4 q3 = *reinterpret_cast<const uint4*>(cr + 9 * kCodeStride);
    const char* xr =
        st + kCodeBytes + gid * kXStride + (warp * 16 + 2 * tig) * 2;
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
    const uint32_t w0[4] = {q0.x ^ 0x80808080u, q0.y ^ 0x80808080u,
                            q0.z ^ 0x80808080u, q0.w ^ 0x80808080u};
    const uint32_t w1[4] = {q1.x ^ 0x80808080u, q1.y ^ 0x80808080u,
                            q1.z ^ 0x80808080u, q1.w ^ 0x80808080u};
    const uint32_t w2[4] = {q2.x ^ 0x80808080u, q2.y ^ 0x80808080u,
                            q2.z ^ 0x80808080u, q2.w ^ 0x80808080u};
    const uint32_t w3[4] = {q3.x ^ 0x80808080u, q3.y ^ 0x80808080u,
                            q3.z ^ 0x80808080u, q3.w ^ 0x80808080u};
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      // m-tiles 2 wi (bytes 0, 1 of word wi) and 2 wi + 1 (bytes 2, 3)
      const uint32_t a0[4] = {code_pair<T, 0>(w0[wi], w1[wi]),
                              code_pair<T, 1>(w0[wi], w1[wi]),
                              code_pair<T, 0>(w2[wi], w3[wi]),
                              code_pair<T, 1>(w2[wi], w3[wi])};
      mma16816<T>(acc[2 * wi], a0, b0, b1);
      const uint32_t a1[4] = {code_pair<T, 2>(w0[wi], w1[wi]),
                              code_pair<T, 3>(w0[wi], w1[wi]),
                              code_pair<T, 2>(w2[wi], w3[wi]),
                              code_pair<T, 3>(w2[wi], w3[wi])};
      mma16816<T>(acc[2 * wi + 1], a1, b0, b1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                // the ring becomes the warps' sums

  // d0 / d1: x rows 2 tig / 2 tig + 1 at column gid * 16 + 2 j; d2 / d3:
  // the same rows at column + 1.  red[warp][row][128]
  float* red = reinterpret_cast<float*>(qsm);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float* dst = red + (warp * kDecodeRows + 2 * tig + rr) * kBN + gid * 16;
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      *reinterpret_cast<float4*>(dst + 2 * j) =
          make_float4(acc[j][rr], acc[j][rr + 2], acc[j + 1][rr],
                      acc[j + 1][rr + 2]);
  }
  __syncthreads();
  // thread t: row t / 16, columns (t % 16) * 8 .. + 7, summed in warp order
  const int row = tid / 16, c0 = (tid % 16) * 8;
  float sum[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum[e] = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float* src = red + (w * kDecodeRows + row) * kBN + c0;
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[e] += src[e];
  }
  const int rows_valid = min(a.M, kDecodeRows);
  if (a.splits == 1) {
    if (row < a.M) {
      float* o = a.out + (long long)row * a.N + n0 + c0;
      const float* sc = a.s + n0 + c0;
      if (a.N % 4 == 0 && n0 + c0 + 8 <= a.N) {
        const float4 s0 = *reinterpret_cast<const float4*>(sc);
        const float4 s1 = *reinterpret_cast<const float4*>(sc + 4);
        *reinterpret_cast<float4*>(o) = make_float4(
            sum[0] * s0.x, sum[1] * s0.y, sum[2] * s0.z, sum[3] * s0.w);
        *reinterpret_cast<float4*>(o + 4) = make_float4(
            sum[4] * s1.x, sum[5] * s1.y, sum[6] * s1.z, sum[7] * s1.w);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n0 + c0 + e < a.N) o[e] = sum[e] * sc[e];
      }
    }
    return;
  }
  const int tile = blockIdx.x, tile_floats = kDecodeRows * kBN;
  float* tile_part = a.part + (long long)tile * a.splits * tile_floats;
  if (row < rows_valid) {
    float4* dst = reinterpret_cast<float4*>(
        tile_part + (long long)split * tile_floats + row * kBN + c0);
    dst[0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
    dst[1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
  }
  if (!last_arrival(a, tile)) return;
  merge_splits(a, tile_part, tile_floats, rows_valid, 0, n0, tile);
}

// The B fragments of one k16 step for a warp's four n-tiles, from the
// lane's 4 code bytes of q rows 2 tig, 2 tig + 1, 2 tig + 8 and 2 tig + 9
// (XORed with 0x80): n-tile j takes byte j.
template <typename T>
__device__ __forceinline__ void code_frags(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           uint32_t (&bf)[4][2]) {
  bf[0][0] = code_pair<T, 0>(w0, w1);
  bf[0][1] = code_pair<T, 0>(w2, w3);
  bf[1][0] = code_pair<T, 1>(w0, w1);
  bf[1][1] = code_pair<T, 1>(w2, w3);
  bf[2][0] = code_pair<T, 2>(w0, w1);
  bf[2][1] = code_pair<T, 2>(w2, w3);
  bf[3][0] = code_pair<T, 3>(w0, w1);
  bf[3][1] = code_pair<T, 3>(w2, w3);
}

// grid (ceil(N / 128), ceil(M / 64), splits), 4 warps.  Warp w owns
// columns [32 w, 32 w + 32) of the block and all 64 rows (4 m-tiles of
// x, A by ldmatrix); its 4 n-tiles' B column n of n-tile j is column
// 32 w + 4 n + j, so a lane's 4 code bytes of one q row feed all four.
// Each tile's codes are converted once (16 k16 x n-tile fragments), then
// each m-tile runs its 16 mma into fresh sums that are added to the
// running ones.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads, kTiledBlocksPerSM)
    quant_matmul_mma_tiled_kernel(QmArgs a) {
  extern __shared__ __align__(16) char qsm[];
  constexpr int kStage = stage_bytes(kTiledRows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kTiledRows;
  const int split = blockIdx.z;
  const int k_begin = split * a.k_per_split;
  const int k_end = min(a.K, k_begin + a.k_per_split);
  const int ntiles = max(0, cdiv(k_end - k_begin, kBK));
  const int rows_valid = min(kTiledRows, a.M - m0);

  auto fetch = [&](int t) {
    if (t < ntiles) {
      char* st = qsm + (t % kTiledStages) * kStage;
      const int k0 = k_begin + t * kBK;
      load_codes(a, st, k0, k_end, n0);
      load_x<T>(a, st + kCodeBytes, kTiledRows, m0, k0, k_end);
    }
    cp_async_commit();
  };

  constexpr int MT = kTiledRows / 16;
  float acc[MT][4][4];            // [m-tile][n-tile][fragment]
#pragma unroll
  for (int i = 0; i < MT * 16; ++i) acc[i / 16][(i / 4) % 4][i % 4] = 0.f;
#pragma unroll
  for (int t = 0; t < kTiledStages - 1; ++t) fetch(t);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kTiledStages - 2>();
    __syncthreads();
    fetch(t + kTiledStages - 1);
    const char* st = qsm + (t % kTiledStages) * kStage;
    const char* xs = st + kCodeBytes;
    uint32_t bf[kBK / 16][4][2];  // [k16 step][n-tile][half]
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const char* cr =
          st + (ks * 16 + 2 * tig) * kCodeStride + warp * 32 + gid * 4;
      code_frags<T>(
          *reinterpret_cast<const uint32_t*>(cr) ^ 0x80808080u,
          *reinterpret_cast<const uint32_t*>(cr + kCodeStride) ^ 0x80808080u,
          *reinterpret_cast<const uint32_t*>(cr + 8 * kCodeStride) ^
              0x80808080u,
          *reinterpret_cast<const uint32_t*>(cr + 9 * kCodeStride) ^
              0x80808080u,
          bf[ks]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt * 16 >= rows_valid) break;       // rows past M: all zeros
      // this tile's sums, added to the running ones with round-to-nearest
      // fp32 adds: the tensor cores add into their accumulator with
      // truncation, whose bias would grow with K over one long chain
      float tacc[4][4];
#pragma unroll
      for (int i = 0; i < 16; ++i) tacc[i / 4][i % 4] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t xa[4];
        ldsm_x4(xa, xs + (mt * 16 + (lane & 15)) * kXStride +
                        (ks * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma16816<T>(tacc[j], xa, bf[ks][j][0], bf[ks][j][1]);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
        acc[mt][i / 4][i % 4] += tacc[i / 4][i % 4];
    }
  }
  cp_async_wait<0>();

  // fragment e of (mt, j): row mt * 16 + gid (+ 8 for e >= 2), column
  // 32 w + 8 tig + j (+ 4 for odd e): a lane holds 8 consecutive columns
  // of each of its rows
  const int cl = warp * 32 + 8 * tig;
  if (a.splits == 1) {
    const bool vec = (a.N % 4) == 0 && n0 + cl + 8 <= a.N;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = mt * 16 + gid + 8 * rr;
        if (r >= rows_valid) continue;
        float v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = acc[mt][j][2 * rr];
          v[4 + j] = acc[mt][j][2 * rr + 1];
        }
        float* o = a.out + (long long)(m0 + r) * a.N + n0 + cl;
        const float* sc = a.s + n0 + cl;
        if (vec) {
          const float4 s0 = *reinterpret_cast<const float4*>(sc);
          const float4 s1 = *reinterpret_cast<const float4*>(sc + 4);
          *reinterpret_cast<float4*>(o) = make_float4(
              v[0] * s0.x, v[1] * s0.y, v[2] * s0.z, v[3] * s0.w);
          *reinterpret_cast<float4*>(o + 4) = make_float4(
              v[4] * s1.x, v[5] * s1.y, v[6] * s1.z, v[7] * s1.w);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (n0 + cl + e < a.N) o[e] = v[e] * sc[e];
        }
      }
    }
    return;
  }
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int tile_floats = kTiledRows * kBN;
  float* tile_part = a.part + (long long)tile * a.splits * tile_floats;
  float* mine = tile_part + (long long)split * tile_floats;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = mt * 16 + gid + 8 * rr;
      if (r >= rows_valid) continue;
      float4* dst = reinterpret_cast<float4*>(mine + r * kBN + cl);
      dst[0] = make_float4(acc[mt][0][2 * rr], acc[mt][1][2 * rr],
                           acc[mt][2][2 * rr], acc[mt][3][2 * rr]);
      dst[1] = make_float4(acc[mt][0][2 * rr + 1], acc[mt][1][2 * rr + 1],
                           acc[mt][2][2 * rr + 1], acc[mt][3][2 * rr + 1]);
    }
  }
  if (!last_arrival(a, tile)) return;
  merge_splits(a, tile_part, tile_floats, rows_valid, m0, n0, tile);
}

template <typename T>
cudaError_t launch_mma(const QmArgs& a, int body, cudaStream_t stream) {
  const int nb = cdiv(a.N, kBN);
  if (body == kMmaDecode) {
    quant_matmul_mma_decode_kernel<T>
        <<<dim3(nb, a.splits), kMmaThreads, kDecodeSmem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaError_t e =
      opt_in_smem((const void*)quant_matmul_mma_tiled_kernel<T>, kTiledSmem);
  if (e != cudaSuccess) return e;
  quant_matmul_mma_tiled_kernel<T>
      <<<dim3(nb, cdiv(a.M, kTiledRows), a.splits), kMmaThreads, kTiledSmem,
         stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype of x: 0 = float32, 1 = float16, 2 = bfloat16.  q (K, N) int8
// row-major, s (N,) fp32, out (M, N) fp32; M, N >= 1.  body (0 CUDA cores,
// 1 tensor-core decode, 2 tensor-core tiled), splits and k_per_split come
// from quant_matmul.qmm_plan and are checked here: fp32 takes body 0,
// bf16 / fp16 body 1 at M <= 8 and body 2 above; the splits of
// k_per_split rows (a multiple of 256 for body 0, of 64 otherwise) cover
// K with none empty.  With splits > 1, scratch holds body 0's (splits, M,
// N) partials or the tensor-core bodies' (tiles, splits, rows, 128) ones,
// and counters (tensor-core bodies) one zero per output tile.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int quant_matmul_launch(const void* x, const void* q,
                                   const void* s, void* out, void* scratch,
                                   void* counters, int dtype, int M, int K,
                                   int N, int body, int splits,
                                   int k_per_split, void* stream) {
  const int want = dtype == 0 ? kSimt : M <= kDecodeRows ? kMmaDecode
                                                         : kMmaTiled;
  const int unit = body == kSimt ? kQmKChunk : kBK;
  const bool covers = K == 0 ? splits == 1
                             : (long)(splits - 1) * k_per_split < K &&
                                   (long)splits * k_per_split >= K;
  if (dtype < 0 || dtype > 2 || body != want || M < 1 || N < 1 || K < 0 ||
      splits < 1 || splits > kMaxSplits || k_per_split < unit ||
      k_per_split % unit || !covers || (splits > 1 && scratch == nullptr) ||
      (splits > 1 && body != kSimt && counters == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* ss = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  float* ws = static_cast<float*>(scratch);
  if (body == kSimt) {
    if (cdiv(M, m_tile(M)) > 65535) return (int)cudaErrorInvalidValue;
    return (int)launch_simt(static_cast<const float*>(x), qq, ss, o, ws, M,
                            K, N, splits, k_per_split / kQmKChunk, st);
  }
  if (cdiv(M, kTiledRows) > 65535) return (int)cudaErrorInvalidValue;
  QmArgs a{x, qq, ss, o, ws, static_cast<int*>(counters), M, K, N, splits,
           k_per_split,
           N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0,
           K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0};
  return dtype == 1 ? (int)launch_mma<__half>(a, body, st)
                    : (int)launch_mma<__nv_bfloat16>(a, body, st);
}
