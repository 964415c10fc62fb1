// Hand-written Hopper (sm_90a) kernels for AFA's aggregation hot path.
//
// Four functions, each the port of one Pallas TPU kernel of the JAX package:
//
//   repro_weighted_sum  <- src/repro/kernels/weighted_sum.py  weighted_sum
//   repro_cosine_sim    <- src/repro/kernels/cosine_sim.py    cosine_sim_parts
//   repro_gram          <- src/repro/kernels/gram.py          gram
//   repro_afa_screen    <- src/repro/kernels/afa_screen.py    afa_screen_call
//
// All four are reductions over the packed model width D (~5e5 for the paper
// DNN) with few rows K (the client count, 10..a few hundred).  At the main
// path's K = 10 every one of them is bound by the bytes of the (K, D) operand
// read from HBM; only the Gram product at K ~ 200 becomes bound by its
// operations, which run on the tensor cores (3xTF32, see gram_tf32x3_kernel).
//
// The TPU kernels accumulate across a SEQUENTIAL grid (one resident output
// block, `+=` on every d-step).  A CUDA grid runs its blocks in parallel and
// in no order, so every cross-block reduction here is split in two: blocks
// over D slices write their partial sums to scratch the caller allocates, and
// a second stage sums the partials in a fixed order.  There are no float
// atomics, so two runs on the same inputs are bit-identical.
//
// Every function has a plain C interface (loaded with ctypes), launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError() after
// its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-12f;   // EPS of core/afa.py and kernels/ops.py
constexpr int kThreads = 256;    // threads of every multi-block kernel
constexpr int kChunk = 2048;     // D columns per block of the cosine parts
constexpr int kScreenThreads = 1024;  // one CTA: the most threads a block may have

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Fixed-order sum of p[0 .. n) by one warp: lane l adds entries l, l + 32,
// ... in turn, then the shuffle tree; the order depends on n only, so the
// result is the same on every run.  Valid in lane 0.  Every partial-sum
// buffer below is laid out entry-major (all splits of one entry contiguous),
// so these reads are coalesced.
__device__ __forceinline__ float warp_ordered_sum(const float* __restrict__ p, int n, int lane) {
  float s = 0.f;
#pragma unroll 8
  for (int i = lane; i < n; i += 32) s += p[i];
  return warp_sum(s);
}

// ---------------------------------------------------------------------------
// weighted sum: out[j] = sum_k c[k] * u[k, j]
//
// Bound by bytes: every element of u is read once.  One thread owns one
// output column and walks k in ascending order, so no second stage is
// needed; neighbouring threads read neighbouring addresses of each row.
// ---------------------------------------------------------------------------
__global__ void weighted_sum_kernel(const float* __restrict__ c,
                                    const float* __restrict__ u,
                                    float* __restrict__ out, int K, long long D) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D) return;
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) acc = fmaf(__ldg(c + k), __ldg(u + (long long)k * D + j), acc);
  out[j] = acc;
}

// ---------------------------------------------------------------------------
// cosine similarity: s_k = <u_k, w> / (sqrt(max(|u_k|^2, EPS)) sqrt(max(|w|^2, EPS)))
//
// Stage 1: block b owns columns [b * kChunk, (b + 1) * kChunk).  Its slice of
// w is staged in shared memory once; each warp walks whole rows of the slice
// (lanes on neighbouring columns) and reduces with shuffles, writing the
// partial dots and squared norms.  Stage 2 (one block) sums the partials in a
// fixed order and divides.
// ---------------------------------------------------------------------------
__global__ void cosine_parts_kernel(const float* __restrict__ u, const float* __restrict__ w,
                                    float* __restrict__ pdot, float* __restrict__ pun,
                                    float* __restrict__ pwn, int K, long long D) {
  __shared__ float ws[kChunk];
  const int b = blockIdx.x;
  const long long j0 = (long long)b * kChunk;
  const long long j1 = (j0 + kChunk < D) ? j0 + kChunk : D;
  const int n = (int)(j1 - j0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = threadIdx.x; t < n; t += blockDim.x) ws[t] = w[j0 + t];
  __syncthreads();
  for (int k = warp; k < K; k += nwarps) {
    const float* row = u + (long long)k * D + j0;
    float dot = 0.f, sq = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float x = __ldg(row + t);
      dot = fmaf(x, ws[t], dot);
      sq = fmaf(x, x, sq);
    }
    dot = warp_sum(dot);
    sq = warp_sum(sq);
    if (lane == 0) {
      pdot[(long long)k * gridDim.x + b] = dot;
      pun[(long long)k * gridDim.x + b] = sq;
    }
  }
  if (warp == 0) {
    float s = 0.f;
    for (int t = lane; t < n; t += 32) s = fmaf(ws[t], ws[t], s);
    s = warp_sum(s);
    if (lane == 0) pwn[b] = s;
  }
}

// Stage 2, one block: |w|^2 first, then per client the dot and |u_k|^2, each
// a fixed-order warp sum over the splits, and the similarity with the EPS
// clamp on the SQUARED norms (the divide of repro/kernels/ops.py cosine_sim).
__global__ void cosine_reduce_kernel(const float* __restrict__ pdot, const float* __restrict__ pun,
                                     const float* __restrict__ pwn, float* __restrict__ sims,
                                     int K, int nsplit) {
  __shared__ float wnorm;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (warp == 0) {
    const float wn = warp_ordered_sum(pwn, nsplit, lane);
    if (lane == 0) wnorm = sqrtf(fmaxf(wn, kEps));
  }
  __syncthreads();
  for (int k = warp; k < K; k += nwarps) {
    const float d = warp_ordered_sum(pdot + (long long)k * nsplit, nsplit, lane);
    const float un = warp_ordered_sum(pun + (long long)k * nsplit, nsplit, lane);
    if (lane == 0) sims[k] = d / __fmul_rn(sqrtf(fmaxf(un, kEps)), wnorm);
  }
}

// ---------------------------------------------------------------------------
// Gram partials on the tensor cores
//
//   pg[e(i, j), s] = sum over the columns d of split s of u[i, d] * u[j, d]
//
// for the upper triangle i <= j only, e(i, j) = i K - i (i - 1) / 2 + j - i
// (entry-major: all splits of one entry contiguous).  Replaces the Gram pass
// of src/repro/kernels/gram.py:56 gram and of src/repro/kernels/afa_screen.py
// :223 afa_screen_call.
//
// What bounds it: at K = 10 the bytes of U (21 MB at D = 535,818; 55 outputs),
// at K = 200 the products (K (K + 1) D / 2 = 1.1e10 multiply-adds, three
// tensor-core products each below).  What the design does about it:
//
// * 3xTF32 on mma.sync m16n8k8.  Every value splits as x = hi + lo with
//   hi = tf32(x), lo = tf32(x - hi) (cvt.rna: to nearest, ties away), and
//   u_i u_j ~ lo_i hi_j + hi_i lo_j + hi_i hi_j, the small terms first; the
//   products of 11-bit significands are exact, the dropped lo_i lo_j is
//   2^-22 relative.  1xTF32 (hi_i hi_j alone) misses the f32 tolerance.
// * The tensor cores' f32 accumulation only ever sums one stage: each
//   warp's products of a 64-column stage go into a zeroed accumulator,
//   which FADD (round to nearest) adds to the running sum.
// * Output tiles are the upper pairs ti <= tj of BT-row blocks (BT = 16 for
//   K <= 16, else 32: 28 pairs and 1.43x the 20,100 entries at K = 200).  A
//   diagonal pair loads its row block once, and its A fragments are its B
//   fragments.
// * Loads: a ring of kGramStages<BT> 64-column stages filled by cp.async of
//   W = 16, 8 or 4 bytes (the widest that U's pointer and D allow; D =
//   535,818 is 8, D = 460,800 is 16), rows >= K and columns past the split
//   zero-filled (src-size 0).  A thread's copies keep their rows and column
//   for the whole split (GramLoader), so a copy costs an add and a select.
//   Rows are kGramStride = 80 floats apart, so a warp's 16-byte fragment
//   reads hit every bank once per quarter warp.
// * Four warps split each stage's columns (16 each, one LDS.128 per row);
//   at the end their accumulators are summed in warp order.
// * The wrapper picks the split count (ops.gram_geometry): about 8 CTAs per
//   SM at K = 10 and K = 200, the partials L2-sized; the second stage
//   (gram_reduce_kernel) is multi-CTA.
//
// On an H100 at K = 200 two costs of similar size remain, and they overlap
// little: the copies out of L2 (each row block is read by all ntiles pairs it
// is in) and the rate of mma.sync (PERF.md; tools/gram_sweep.py times each).
//
// Blocks on diagonal pairs also sum the squared row norms sum_d u_i^2 (f32
// FFMA on the CUDA cores, from the same shared stage) into pun[i, s] when pun
// is given: afa_screen needs them apart from the Gram matrix, as its TPU
// kernel computes them.  No float atomics: reruns are bit-identical.
// ---------------------------------------------------------------------------
constexpr int kGramThreads = 128;   // four warps
constexpr int kGramTileD = 64;      // columns per stage: 16 per warp
constexpr int kGramStride = 80;     // floats between shared rows (80 = 16 mod 32)
template <int BT> constexpr int kGramStages = BT == 16 ? 4 : 3;

// the shared bytes of one launch: the stage ring (one row block per stage
// when every pair is diagonal, else two), and at least the four warps'
// accumulators that the end of the kernel stages there
template <int BT> size_t gram_smem_bytes(int ntiles) {
  const size_t ring = (size_t)kGramStages<BT> * (ntiles > 1 ? 2 : 1) * BT * kGramStride;
  const size_t red = (size_t)4 * BT * BT;
  return (ring > red ? ring : red) * sizeof(float);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x -> (hi, lo), both TF32 bit patterns: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b: a 16 x 8 (row), b 8 x 8 (col), d 16 x 8 f32, TF32 operands.
// Lane l, with g = l / 4 and q = l % 4, holds a = {(g, q), (g + 8, q),
// (g, q + 4), (g + 8, q + 4)}, b = {(q, g), (q + 4, g)} and d = {(g, 2q),
// (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1)}.
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// copy of W bytes to shared address dst, the first src_bytes of them read
// (the rest zero-filled)
template <int W>
__device__ __forceinline__ void cp_async_w(uint32_t dst, const float* src, int src_bytes) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(dst), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :
                 : "r"(dst), "l"(src), "n"(W), "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A thread's share of the stage copies: columns [d, d + 64) of the ROWS rows
// (row block A, then block B unless the pair is diagonal), zero past K and
// past the split's end.  Copy c = tid + 128 k is row r0 + RS k at column col,
// so the column and the rows (and which rows are < K) are fixed for the
// whole split, and a copy costs an address add and a select per stage.
template <int BT, int W, int ROWS>
struct GramLoader {
  static constexpr int V = W / 4;                     // floats per copy
  static constexpr int kPerRow = kGramTileD / V;      // copies per row
  static constexpr int RS = kGramThreads / kPerRow;   // rows between a thread's copies
  static constexpr int N = ROWS / RS;                 // copies per thread and stage
  static constexpr int NA = BT / RS;                  // of them in block A
  const float* u;
  const float* pa;   // row r0 of block A at the split's first column + col
  const float* pb;   // row r0 of block B
  long long step;    // RS rows
  uint32_t valid;    // bit k: copy k's row is < K
  uint32_t dst;      // shared address of copy 0 in ring buffer 0
  int col;

  __device__ __forceinline__ GramLoader(const float* u_, const float* smem, int row_a0,
                                        int row_b0, int K, long long D, long long d_begin) {
    const int r0 = threadIdx.x / kPerRow;
    col = (threadIdx.x % kPerRow) * V;
    u = u_;
    step = (long long)RS * D;
    pa = u_ + (long long)(row_a0 + r0) * D + d_begin + col;
    pb = u_ + (long long)(row_b0 + r0) * D + d_begin + col;
    valid = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int row = k < NA ? row_a0 + r0 + RS * k : row_b0 + r0 + RS * (k - NA);
      valid |= (uint32_t)(row < K) << k;
    }
    dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem + r0 * kGramStride + col));
  }

  // stage s of the split into the ring buffer at byte offset buf; left =
  // columns from the stage's first to the split's end
  __device__ __forceinline__ void load(uint32_t buf, int s, long long left) const {
    const long long n = left - col;
    const int bytes = n <= 0 ? 0 : (n >= V ? W : (int)n * 4);
    const long long off = (long long)s * kGramTileD;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float* p = (k < NA ? pa + k * step : pb + (k - NA) * step) + off;
      const int b = (valid >> k) & 1u ? bytes : 0;
      cp_async_w<W>(dst + buf + k * RS * kGramStride * 4, b ? p : u, b);
    }
  }
};

__device__ __forceinline__ long long tri_index(int i, int j, int K) {
  return (long long)i * K - (long long)i * (i - 1) / 2 + (j - i);
}

// One output tile pair (DIAG: ti == tj) over the split's columns.
template <int BT, int W, bool DIAG>
__device__ __forceinline__ void gram_tile(float* smem, const float* __restrict__ u,
                                          float* __restrict__ pg, float* __restrict__ pun,
                                          int K, long long D, int row_a0, int row_b0,
                                          long long d_begin, long long d_end, int stage_rows) {
  constexpr int MT = BT / 16;               // m16 tiles of a row block
  constexpr int NT = BT / 8;                // n8 tiles of a row block
  constexpr int ROWS = DIAG ? BT : 2 * BT;
  constexpr int S = kGramStages<BT>;
  constexpr int TPR = kGramThreads / BT;    // threads per row of the norms
  const int stage_floats = stage_rows * kGramStride;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int col = 16 * warp + 4 * q;        // this lane's 4 columns of a stage
  const int nstage = (int)((d_end - d_begin + kGramTileD - 1) / kGramTileD);
  const bool norms = DIAG && pun != nullptr;

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  float rn = 0.f;

  const GramLoader<BT, W, ROWS> loader(u, smem, row_a0, row_b0, K, D, d_begin);
  const long long width = d_end - d_begin;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nstage) loader.load(s * stage_floats * 4, s, width - (long long)s * kGramTileD);
    cp_async_commit();
  }
  for (int t = 0; t < nstage; ++t) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage t is in; stage t - 1's buffer is free
    {
      const int s = t + S - 1;
      if (s < nstage)
        loader.load((s % S) * stage_floats * 4, s, width - (long long)s * kGramTileD);
      cp_async_commit();
    }
    const float* st = smem + (t % S) * stage_floats;
    // lane (g, q) reads columns col .. col + 3 of rows 16 m + g and
    // 16 m + 8 + g of each block: k-step j takes columns col + 2j (as k = q)
    // and col + 2j + 1 (as k = q + 4), the same map for A and B
    float4 xa[MT][2], xb[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xa[m][h] = *reinterpret_cast<const float4*>(st + (16 * m + 8 * h + g) * kGramStride + col);
        if constexpr (!DIAG)
          xb[m][h] = *reinterpret_cast<const float4*>(
              st + (BT + 16 * m + 8 * h + g) * kGramStride + col);
      }
    uint32_t ah[2][MT][4], al[2][MT][4], bh[2][NT][2], bl[2][NT][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float v[4] = {j ? xa[m][0].z : xa[m][0].x, j ? xa[m][1].z : xa[m][1].x,
                            j ? xa[m][0].w : xa[m][0].y, j ? xa[m][1].w : xa[m][1].y};
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(v[e], ah[j][m][e], al[j][m][e]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int m = n >> 1, h = n & 1;
        if constexpr (DIAG) {  // rows 8 n + g are A's rows g (+ 8) of m-tile m
          bh[j][n][0] = ah[j][m][h];
          bh[j][n][1] = ah[j][m][2 + h];
          bl[j][n][0] = al[j][m][h];
          bl[j][n][1] = al[j][m][2 + h];
        } else {
          split_tf32(j ? xb[m][h].z : xb[m][h].x, bh[j][n][0], bl[j][n][0]);
          split_tf32(j ? xb[m][h].w : xb[m][h].y, bh[j][n][1], bl[j][n][1]);
        }
      }
    }
    // per tile: lo hi' and hi lo' of both k-steps, then hi hi' of both, into
    // a zeroed stage sum; consecutive mmas go to different tiles
    float part[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma1688(part[m][n], al[j][m], bh[j][n][0], bh[j][n][1]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma1688(part[m][n], ah[j][m], bl[j][n][0], bl[j][n][1]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma1688(part[m][n], ah[j][m], bh[j][n][0], bh[j][n][1]);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = __fadd_rn(acc[m][n][e], part[m][n][e]);
    if (norms) {  // row tid / TPR, columns 4 (tid % TPR) + 4 TPR c
      const float* row = st + (tid / TPR) * kGramStride + 4 * (tid % TPR);
#pragma unroll
      for (int c = 0; c < kGramTileD / (4 * TPR); ++c) {
        const float4 v = *reinterpret_cast<const float4*>(row + 4 * TPR * c);
        rn = fmaf(v.x, v.x, rn);
        rn = fmaf(v.y, v.y, rn);
        rn = fmaf(v.z, v.z, rn);
        rn = fmaf(v.w, v.w, rn);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the warps' tiles there

  float* red = smem;  // [warp][BT][BT]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m + g + 8 * (e >> 1);
        const int c = 8 * n + 2 * q + (e & 1);
        red[(warp * BT + r) * BT + c] = acc[m][n][e];
      }
  __syncthreads();
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  for (int e = tid; e < BT * BT; e += kGramThreads) {
    const int i = row_a0 + e / BT;
    const int j = row_b0 + e % BT;
    if (i >= K || j >= K || (DIAG && j < i)) continue;
    const float v = __fadd_rn(__fadd_rn(__fadd_rn(red[e], red[BT * BT + e]), red[2 * BT * BT + e]),
                              red[3 * BT * BT + e]);
    pg[tri_index(i, j, K) * nsplit + split] = v;
  }
  if (norms) {
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) rn += __shfl_xor_sync(0xffffffffu, rn, off);
    const int i = row_a0 + tid / TPR;
    if (tid % TPR == 0 && i < K) pun[(long long)i * nsplit + split] = rn;
  }
}

// grid = (upper tile pairs, splits), kGramThreads threads, gram_smem_bytes
template <int BT, int W>
__global__ void __launch_bounds__(kGramThreads, BT == 16 ? 8 : 3)
gram_tf32x3_kernel(const float* __restrict__ u, float* __restrict__ pg, float* __restrict__ pun,
                   int K, long long D, long long chunk, int ntiles) {
  extern __shared__ float4 gram_smem4[];
  float* smem = reinterpret_cast<float*>(gram_smem4);
  int p = blockIdx.x;
  int ti = 0;
  while (p >= ntiles - ti) {
    p -= ntiles - ti;
    ++ti;
  }
  const int tj = ti + p;
  const long long d_begin = (long long)blockIdx.y * chunk;
  const long long d_end = d_begin + chunk < D ? d_begin + chunk : D;
  const int stage_rows = ntiles > 1 ? 2 * BT : BT;
  if (ti == tj)
    gram_tile<BT, W, true>(smem, u, pg, pun, K, D, ti * BT, ti * BT, d_begin, d_end, stage_rows);
  else
    gram_tile<BT, W, false>(smem, u, pg, pun, K, D, ti * BT, tj * BT, d_begin, d_end,
                            stage_rows);
}

// Stage 2, multi-CTA: one warp per upper entry e(i, j) sums its splits in a
// fixed order and writes G[i, j] and G[j, i]; when pun is given, K more warps
// sum the squared row norms and write rn[k] = sqrt of the sum.
__global__ void gram_reduce_kernel(const float* __restrict__ pg, const float* __restrict__ pun,
                                   float* __restrict__ g, float* __restrict__ rn, int K,
                                   int nsplit) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long ne = (long long)K * (K + 1) / 2;
  if (w < ne) {
    // row i of entry w: the largest i with tri_index(i, i, K) <= w
    const double b = 2.0 * K + 1.0;
    int i = (int)((b - sqrt(b * b - 8.0 * (double)w)) * 0.5);
    i = i < 0 ? 0 : (i >= K ? K - 1 : i);
    while (i > 0 && tri_index(i, i, K) > w) --i;
    while (i + 1 < K && tri_index(i + 1, i + 1, K) <= w) ++i;
    const int j = i + (int)(w - tri_index(i, i, K));
    const float s = warp_ordered_sum(pg + w * nsplit, nsplit, lane);
    if (lane == 0) {
      g[(long long)i * K + j] = s;
      g[(long long)j * K + i] = s;
    }
  } else if (pun != nullptr && w < ne + K) {
    const long long k = w - ne;
    const float s = warp_ordered_sum(pun + k * nsplit, nsplit, lane);
    if (lane == 0) rn[k] = sqrtf(s);
  }
}
// ---------------------------------------------------------------------------
// AFA screening (Algorithm 1) on one CTA
//
// Mirror of `_screen` in src/repro/kernels/afa_screen.py: reputation weights
// c = mask * pn / max(sum, EPS); similarities s = G c / (max(|u|, EPS) *
// sqrt(max(c^T G c, EPS))); masked mean, compare-count median (rank ties
// broken by client index) and std; the tail picked by mean vs median;
// xi += delta_xi each pass; a floor of 2 survivors; stop when nothing changes
// or at max_rounds.  The O(K^2) work is tiny beside the (K, D) passes, so one
// CTA runs it: G and the row norms come from gram_reduce_kernel; G stays in
// global memory, where it is L2-resident; the K-vectors live in shared
// memory.  Scalar reductions over K run on thread 0 in index order.
// ---------------------------------------------------------------------------
struct ScreenShared {
  float* rn;
  float* pn;
  float* c;
  float* gc;
  float* s;
  int* mask;
  int* bad;
  int* rank;
};

__device__ void screen_weights(const ScreenShared& sh, int K, float* scale) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) sh.c[k] = sh.mask[k] ? sh.pn[k] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int k = 0; k < K; ++k) tot = __fadd_rn(tot, sh.c[k]);
    *scale = fmaxf(tot, kEps);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) sh.c[k] = sh.c[k] / *scale;
  __syncthreads();
}

__device__ void screen_sims(const ScreenShared& sh, const float* __restrict__ G, int K,
                            float* agg_norm) {
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    float acc = 0.f;
    const float* row = G + (long long)i * K;
    for (int j = 0; j < K; ++j) acc = fmaf(row[j], sh.c[j], acc);
    sh.gc[i] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float cgc = 0.f;
    for (int k = 0; k < K; ++k) cgc = fmaf(sh.c[k], sh.gc[k], cgc);
    *agg_norm = sqrtf(fmaxf(cgc, kEps));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    sh.s[i] = sh.gc[i] / __fmul_rn(fmaxf(sh.rn[i], kEps), *agg_norm);
  __syncthreads();
}

// one screening pass: marks sh.bad and sets flags[1] when any client was
// newly flagged
__device__ void screen_mark_bad(const ScreenShared& sh, int K, float xi, int ddof, float* stats,
                                int* flags) {
  // flags[0] = live count m
  if (threadIdx.x == 0) {
    int m = 0;
    float sum = 0.f;
    for (int k = 0; k < K; ++k) {
      if (sh.mask[k]) {
        ++m;
        sum = __fadd_rn(sum, sh.s[k]);
      }
    }
    const float mu = m > 0 ? sum / (float)(m > 1 ? m : 1) : 0.f;
    float var = 0.f;
    for (int k = 0; k < K; ++k) {
      if (sh.mask[k]) {
        const float d = __fsub_rn(sh.s[k], mu);
        var = __fadd_rn(var, __fmul_rn(d, d));
      }
    }
    const int denom = (m - ddof) > 1 ? (m - ddof) : 1;
    var = var / (float)denom;
    stats[0] = mu;
    stats[1] = sqrtf(fmaxf(var, 0.f));
    flags[0] = m;
  }
  // compare-count rank among live clients (ties broken by client index)
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const float x = sh.s[i];
    int r = 0;
    for (int j = 0; j < K; ++j) {
      if (!sh.mask[j]) continue;
      const float y = sh.s[j];
      r += (y < x) || (y == x && j < i);
    }
    sh.rank[i] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int m = flags[0];
    const int lo = (m - 1) / 2 > 0 ? (m - 1) / 2 : 0;
    const int hi = m / 2 > 0 ? m / 2 : 0;
    float v_lo = 0.f, v_hi = 0.f;
    for (int k = 0; k < K; ++k) {
      if (sh.mask[k] && sh.rank[k] == lo) v_lo = __fadd_rn(v_lo, sh.s[k]);
      if (sh.mask[k] && sh.rank[k] == hi) v_hi = __fadd_rn(v_hi, sh.s[k]);
    }
    stats[2] = m > 0 ? __fmul_rn(0.5f, __fadd_rn(v_lo, v_hi)) : 0.f;
  }
  __syncthreads();
  const float mu_hat = stats[0];
  const float sigma = stats[1];
  const float mu_bar = stats[2];
  const float band = __fmul_rn(xi, sigma);
  const float lo_thr = __fsub_rn(mu_bar, band);
  const float hi_thr = __fadd_rn(mu_bar, band);
  const bool low = mu_hat < mu_bar;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float x = sh.s[k];
    sh.bad[k] = sh.mask[k] && (low ? (x < lo_thr) : (x > hi_thr));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int keep = 0, any = 0;
    for (int k = 0; k < K; ++k) {
      keep += sh.mask[k] && !sh.bad[k];
      any |= sh.bad[k];
    }
    if (keep < 2) {
      for (int k = 0; k < K; ++k) sh.bad[k] = 0;
      any = 0;
    }
    flags[1] = any;
  }
  __syncthreads();
}

__global__ void afa_screen_kernel(const float* __restrict__ G, const float* __restrict__ rn,
                                  const float* __restrict__ pn, const int* __restrict__ mask0,
                                  float* __restrict__ weights, int* __restrict__ good,
                                  int* __restrict__ rounds_out, float* __restrict__ sims, int K,
                                  float xi0, float delta_xi, int max_rounds, int ddof) {
  extern __shared__ float smem[];
  ScreenShared sh;
  sh.rn = smem;
  sh.pn = smem + K;
  sh.c = smem + 2 * K;
  sh.gc = smem + 3 * K;
  sh.s = smem + 4 * K;
  sh.mask = reinterpret_cast<int*>(smem + 5 * K);
  sh.bad = sh.mask + K;
  sh.rank = sh.bad + K;
  __shared__ float scalar[4];
  __shared__ float stats[3];
  __shared__ int flags[2];

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    sh.rn[k] = rn[k];
    sh.pn[k] = pn[k];
    sh.mask[k] = mask0[k] != 0;
    sh.s[k] = 0.f;
  }
  __syncthreads();

  if (max_rounds == 0) {
    // round-0 similarities: the loop never runs
    screen_weights(sh, K, &scalar[0]);
    screen_sims(sh, G, K, &scalar[1]);
  }
  float xi = xi0;
  int rounds = 0;
  int changed = 1;
  while (changed && rounds < max_rounds) {
    screen_weights(sh, K, &scalar[0]);
    screen_sims(sh, G, K, &scalar[1]);
    screen_mark_bad(sh, K, xi, ddof, stats, flags);
    for (int k = threadIdx.x; k < K; k += blockDim.x) sh.mask[k] = sh.mask[k] && !sh.bad[k];
    changed = flags[1];
    xi = __fadd_rn(xi, delta_xi);
    ++rounds;
    __syncthreads();
  }
  screen_weights(sh, K, &scalar[0]);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    weights[k] = sh.c[k];
    good[k] = sh.mask[k];
    sims[k] = sh.s[k];
  }
  if (threadIdx.x == 0) rounds_out[0] = rounds;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// the geometry ops.gram_geometry computed, checked against the operands: the
// tile rows, a split count and column chunk that cover D exactly, and a copy
// width that U's pointer and row length allow
bool gram_geometry_ok(const float* u, int K, long long D, int tile_rows, int nsplit,
                      long long chunk, int width) {
  if (K < 1 || D < 1 || nsplit < 1 || nsplit > 65535) return false;
  if (tile_rows != 16 && tile_rows != 32) return false;
  if (chunk < kGramTileD || chunk % kGramTileD != 0) return false;
  if ((long long)(nsplit - 1) * chunk >= D || (long long)nsplit * chunk < D) return false;
  if (width != 4 && width != 8 && width != 16) return false;
  return reinterpret_cast<uintptr_t>(u) % width == 0 && (D * 4) % width == 0;
}

template <int BT, int W>
cudaError_t launch_gram_tf32x3(const float* u, float* pg, float* pun, int K, long long D,
                               int nsplit, long long chunk, cudaStream_t stream) {
  const int ntiles = (int)ceil_div(K, BT);
  const dim3 grid(ntiles * (ntiles + 1) / 2, nsplit);
  const size_t smem = gram_smem_bytes<BT>(ntiles);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_tf32x3_kernel<BT, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  gram_tf32x3_kernel<BT, W><<<grid, kGramThreads, smem, stream>>>(u, pg, pun, K, D, chunk,
                                                                  ntiles);
  return cudaGetLastError();
}

// the Gram partials (and the squared row norms when pun is given), then
// their multi-CTA reduce into g (and rn); the geometry is checked first
cudaError_t launch_gram(const float* u, float* pg, float* pun, float* g, float* rn, int K,
                        long long D, int tile_rows, int nsplit, long long chunk, int width,
                        cudaStream_t stream) {
  if (!gram_geometry_ok(u, K, D, tile_rows, nsplit, chunk, width)) return cudaErrorInvalidValue;
  cudaError_t err;
  if (tile_rows == 16) {
    err = width == 16 ? launch_gram_tf32x3<16, 16>(u, pg, pun, K, D, nsplit, chunk, stream)
        : width == 8  ? launch_gram_tf32x3<16, 8>(u, pg, pun, K, D, nsplit, chunk, stream)
                      : launch_gram_tf32x3<16, 4>(u, pg, pun, K, D, nsplit, chunk, stream);
  } else {
    err = width == 16 ? launch_gram_tf32x3<32, 16>(u, pg, pun, K, D, nsplit, chunk, stream)
        : width == 8  ? launch_gram_tf32x3<32, 8>(u, pg, pun, K, D, nsplit, chunk, stream)
                      : launch_gram_tf32x3<32, 4>(u, pg, pun, K, D, nsplit, chunk, stream);
  }
  if (err != cudaSuccess) return err;
  const long long warps = (long long)K * (K + 1) / 2 + (pun != nullptr ? K : 0);
  gram_reduce_kernel<<<(unsigned)ceil_div(warps * 32, kThreads), kThreads, 0, stream>>>(
      pg, pun, g, rn, K, nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// number of D splits (partial blocks) of the cosine parts; the caller sizes
// its scratch with it
int repro_cosine_nsplit(long long D) { return (int)ceil_div(D, kChunk); }

// largest K the one-CTA screen holds in shared memory (8 K-vectors)
int repro_screen_max_k() { return (48 * 1024) / (8 * (int)sizeof(float)); }

int repro_weighted_sum(const float* c, const float* u, float* out, int K, long long D,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)ceil_div(D, kThreads);
  weighted_sum_kernel<<<blocks, kThreads, 0, st>>>(c, u, out, K, D);
  return (int)cudaGetLastError();
}

int repro_cosine_sim(const float* u, const float* w, float* pdot, float* pun, float* pwn,
                     float* sims, int K, long long D, int nsplit, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cosine_parts_kernel<<<nsplit, kThreads, 0, st>>>(u, w, pdot, pun, pwn, K, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cosine_reduce_kernel<<<1, kThreads, 0, st>>>(pdot, pun, pwn, sims, K, nsplit);
  return (int)cudaGetLastError();
}

// two launches: the Gram partials and their reduce.  pg holds
// K (K + 1) / 2 * nsplit floats; the geometry is ops.gram_geometry's
int repro_gram(const float* u, float* pg, float* g, int K, long long D, int tile_rows,
               int nsplit, long long chunk, int width, void* stream) {
  return (int)launch_gram(u, pg, nullptr, g, nullptr, K, D, tile_rows, nsplit, chunk, width,
                          static_cast<cudaStream_t>(stream));
}

// four launches: the Gram and row-norm partials, their reduce into G and rn,
// the one-CTA screen, the weighted sum with the final weights.  pun holds
// K * nsplit floats
int repro_afa_screen(const float* u, const float* pn, const int* mask0, float* pg, float* pun,
                     float* G, float* rn, float* weights, float* agg, int* good, int* rounds,
                     float* sims, int K, long long D, int tile_rows, int nsplit, long long chunk,
                     int width, float xi0, float delta_xi, int max_rounds, int ddof,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_gram(u, pg, pun, G, rn, K, D, tile_rows, nsplit, chunk, width, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)8 * K * sizeof(float);
  afa_screen_kernel<<<1, kScreenThreads, smem, st>>>(G, rn, pn, mask0, weights, good, rounds,
                                                     sims, K, xi0, delta_xi, max_rounds, ddof);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)ceil_div(D, kThreads);
  weighted_sum_kernel<<<blocks, kThreads, 0, st>>>(weights, u, agg, K, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
