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
// a second stage sums the partials in a fixed order.  For the cosine and the
// screen the second stage runs in the same launch: each block, after its
// partials, draws a ticket from an integer counter, and the block that draws
// the last one runs it (LastBlock).  There are no float atomics, and which
// block is last changes no sum, so two runs on the same inputs are
// bit-identical.
//
// Every function has a plain C interface (loaded with ctypes), launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError() after
// its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-12f;   // EPS of core/afa.py and kernels/ops.py
constexpr int kThreads = 256;    // threads of every multi-block kernel
constexpr int kScreenLoads = 16; // loads of G a thread of the block screen keeps in flight

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Fixed-order sum of p[0 .. n) by one warp: lane l adds entries l, l + 32,
// ... in turn, then the shuffle tree; the order depends on n only, so the
// result is the same on every run.  Valid in lane 0.  Every partial-sum
// buffer below is laid out entry-major (all splits of one entry contiguous),
// so these reads are coalesced.  The loads go through L2 (ld.global.cg):
// the partials may have been written by other blocks of the same launch.
__device__ __forceinline__ float warp_ordered_sum(const float* __restrict__ p, int n, int lane) {
  float s = 0.f;
#pragma unroll 8
  for (int i = lane; i < n; i += 32) s += __ldcg(p + i);
  return warp_sum(s);
}

// Sum over the warp of N values per lane (N a power of two <= 32) in 31
// shuffles: the lane bits that index no value are added first, then each
// step halves the values a lane keeps (the lanes with bit s set keep the
// upper half and send the lower).  Lane l returns the sum of value l % N.
// The order is fixed by the lane layout, so reruns are bit-identical.
template <int N>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[N], int lane) {
#pragma unroll
  for (int s = 16; s >= N; s >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], s);
#pragma unroll
  for (int s = N / 2; s >= 1; s >>= 1) {
    const bool upper = (lane & s) != 0;
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const float send = upper ? v[i] : v[i + s];
      const float keep = upper ? v[i + s] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
  return v[0];
}

// The second stage of a one-launch reduction.  Every thread calls it after
// its last store of partials; it returns true in every thread of the one
// block that drew the last ticket, whose loads (ld.global.cg) then see every
// block's partials.  The fence before the ticket publishes this block's
// stores; the fence after it orders the last block's loads after them.  The
// last block must call release() when it is done: the counter is then 0
// again for the next launch on the stream (ops.py keeps one counter per
// stream, since launches on two streams may run at once and would draw from
// one counter each other's tickets).
struct LastBlock {
  unsigned int* ticket;
  __device__ __forceinline__ bool draw() const {
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
    __syncthreads();
    if (last) __threadfence();
    return last;
  }
  __device__ __forceinline__ void release() const {
    if (threadIdx.x == 0) *ticket = 0u;
  }
};

// W bytes of floats (W = 16, 8 or 4) from p, which is W-aligned; the loads
// of the streaming kernels.
template <int W>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[W / 4]) {
  if constexpr (W == 16) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (W == 8) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[W / 4]) {
  if constexpr (W == 16) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (W == 8) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// ---------------------------------------------------------------------------
// weighted sum: out[j] = sum_k c[k] * u[k, j]
//
// Replaces src/repro/kernels/weighted_sum.py:30 weighted_sum, and is the
// aggregate pass of afa_screen.  Bound by bytes: every element of u is read
// once.  A thread owns groups of W / 4 neighbouring columns (W = 16, 8 or 4
// bytes, the widest load U's pointer, the output's and D allow) and walks k
// in ascending order, one fmaf per element, so no second stage is needed and
// the sums depend neither on W nor on the grid.  It loads
// kSumRows rows of its group before their FMAs, so that many independent
// loads are in flight.  The grid is as many blocks as the card holds at once
// (launch_weighted_sum), each thread striding over the groups, so no second
// wave runs part-empty.
// ---------------------------------------------------------------------------
constexpr int kSumRows = 8;

template <int W>
__global__ void __launch_bounds__(kThreads)
weighted_sum_kernel(const float* __restrict__ c, const float* __restrict__ u,
                    float* __restrict__ out, int K, long long D) {
  constexpr int V = W / 4;
  const long long groups = D / V;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += (long long)gridDim.x * kThreads) {
    const float* p = u + g * V;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int r0 = 0; r0 < K; r0 += kSumRows) {
      float x[kSumRows][V];
#pragma unroll
      for (int i = 0; i < kSumRows; ++i)
        if (r0 + i < K) load_vec<W>(p + (long long)(r0 + i) * D, x[i]);
#pragma unroll
      for (int i = 0; i < kSumRows; ++i) {
        if (r0 + i < K) {
          const float ck = __ldg(c + r0 + i);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(ck, x[i][v], acc[v]);
        }
      }
    }
    store_vec<W>(out + g * V, acc);
  }
}

// ---------------------------------------------------------------------------
// cosine similarity: s_k = <u_k, w> / (sqrt(max(|u_k|^2, EPS)) sqrt(max(|w|^2, EPS)))
//
// Replaces src/repro/kernels/cosine_sim.py:49 cosine_sim_parts (and the
// divide of repro/kernels/ops.py cosine_sim).  Bound by the bytes of U and w,
// one launch.  What the design does about it:
//
// * The grid comes from the card's SM count (ops.cosine_geometry): block b
//   owns the columns [b chunk, (b + 1) chunk), kCosineBlocksPerSM blocks of
//   kCosineThreads per SM, all resident at once (the launch bounds hold each
//   thread to 64 registers), so the whole of D is in one wave of 32 warps an
//   SM.
// * A thread owns groups of W / 4 columns (W = 16, 8 or 4 bytes: the widest
//   load that U's and w's pointers and D allow).  It loads w for a group
//   once per row block and then the group's elements of RB rows (4 at
//   W = 16, else 8: 64 or 32 bytes a thread, within 64 registers) before
//   the FMAs, so that many independent loads are in flight; larger K loops
//   over row blocks.
// * Each row block's 2 RB sums (dots and squared norms) go through one
//   31-shuffle transpose reduction per warp, then the warps' values in warp
//   order, into the partials: row 2k holds client k's dots, row 2k + 1 its
//   squared norms, row 2K |w|^2, each row nsplit floats padded with zeros to
//   a multiple of 4 (pstride), so the last block reads them as float4.
// * The last block (LastBlock) sums each row in a fixed order, a warp per
//   row and two rows at once, and divides, with the EPS clamp on the
//   SQUARED norms.
// ---------------------------------------------------------------------------
constexpr int kCosineThreads = 512;
constexpr int kCosineBlocksPerSM = 2;  // ops.COSINE_CTAS_PER_SM

// Fixed-order sums of rows p and q (n floats each, n a multiple of 4,
// 16-byte aligned) by one warp, their float4 loads in flight together:
// lane l adds float4s l, l + 32, ... in turn, then the shuffle tree.  Valid
// in lane 0.
__device__ __forceinline__ void warp_ordered_sum4x2(const float* __restrict__ p,
                                                    const float* __restrict__ q, int n, int lane,
                                                    float& sp, float& sq) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float a = 0.f, b = 0.f;
#pragma unroll 4
  for (int i = lane; i < n / 4; i += 32) {
    const float4 x = __ldcg(p4 + i);
    const float4 y = __ldcg(q4 + i);
    a += x.x; a += x.y; a += x.z; a += x.w;
    b += y.x; b += y.y; b += y.z; b += y.w;
  }
  sp = warp_sum(a);
  sq = warp_sum(b);
}

template <int W>
__global__ void __launch_bounds__(kCosineThreads, kCosineBlocksPerSM)
cosine_sim_kernel(const float* __restrict__ u, const float* __restrict__ w,
                  float* __restrict__ part, float* __restrict__ sims, LastBlock lb, int K,
                  long long D, long long chunk) {
  constexpr int V = W / 4;
  constexpr int RB = W == 16 ? 4 : 8;
  constexpr int kWarps = kCosineThreads / 32;
  __shared__ float red[kWarps][32];
  const int nsplit = gridDim.x;
  const int pstride = (nsplit + 3) & ~3;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long c0 = (long long)b * chunk;
  const long long c1 = c0 + chunk < D ? c0 + chunk : D;
  const int ngroups = (int)((c1 - c0) / V);
  const float* wb = w + c0;
  float wn = 0.f;
  for (int r0 = 0; r0 < K; r0 += RB) {
    float acc[2 * RB];  // dots of rows r0 + i, then their squared norms
#pragma unroll
    for (int i = 0; i < 2 * RB; ++i) acc[i] = 0.f;
    const float* ub = u + (long long)r0 * D + c0;
    for (int g = tid; g < ngroups; g += kCosineThreads) {
      float wv[V];
      load_vec<W>(wb + (long long)g * V, wv);
      float x[RB][V];
      const float* p = ub + (long long)g * V;
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        if (r0 + i < K) {
          load_vec<W>(p, x[i]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) x[i][v] = 0.f;
        }
        p += D;
      }
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[i] = fmaf(x[i][v], wv[v], acc[i]);
          acc[RB + i] = fmaf(x[i][v], x[i][v], acc[RB + i]);
        }
      if (r0 == 0) {
#pragma unroll
        for (int v = 0; v < V; ++v) wn = fmaf(wv[v], wv[v], wn);
      }
    }
    red[warp][lane] = warp_transpose_sum<2 * RB>(acc, lane);
    __syncthreads();
    if (tid < 2 * RB) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[q][tid];
      const int row = r0 + tid % RB;
      if (row < K) part[(long long)(2 * row + (tid >= RB)) * pstride + b] = s;
    }
    __syncthreads();
  }
  wn = warp_sum(wn);
  if (lane == 0) red[warp][0] = wn;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += red[q][0];
    part[2LL * K * pstride + b] = s;
  }
  if (b == nsplit - 1)  // the rows' padding
    for (int e = tid; e < (2 * K + 1) * (pstride - nsplit); e += kCosineThreads)
      part[(long long)(e / (pstride - nsplit)) * pstride + nsplit + e % (pstride - nsplit)] = 0.f;
  if (!lb.draw()) return;
  // the last block: warp w sums rows 2k and 2k + 1 for clients k = w,
  // w + kWarps, ... and, first of all, warp 0 row 2K; each sum goes back
  // into its row's first slot, which only that warp reads
  if (warp == 0) {
    float s, again;  // the one row twice: the pair's second sum is not used
    const float* row = part + 2LL * K * pstride;
    warp_ordered_sum4x2(row, row, pstride, lane, s, again);
    if (lane == 0) part[2LL * K * pstride] = sqrtf(fmaxf(s, kEps));
  }
  for (int k = warp; k < K; k += kWarps) {
    float d, un;
    warp_ordered_sum4x2(part + 2LL * k * pstride, part + (2LL * k + 1) * pstride, pstride, lane,
                        d, un);
    if (lane == 0) {
      part[2LL * k * pstride] = d;
      part[(2LL * k + 1) * pstride] = un;
    }
  }
  __syncthreads();
  const float wnorm = __ldcg(part + 2LL * K * pstride);
  for (int k = tid; k < K; k += kCosineThreads)
    sims[k] = __ldcg(part + 2LL * k * pstride) /
              __fmul_rn(sqrtf(fmaxf(__ldcg(part + (2LL * k + 1) * pstride), kEps)), wnorm);
  lb.release();
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

// Stage 2, multi-CTA: warp w sums the splits of upper entry e(i, j) = w (and
// of w plus the grid's warp count, ...) in a fixed order and writes G[i, j]
// and G[j, i]; when pun is given, K more entries are the squared row norms,
// written as rn[k] = sqrt of the sum.  The grid is at most what the card
// holds at once (resident_grid).
__device__ __forceinline__ void gram_reduce_body(const float* __restrict__ pg,
                                                 const float* __restrict__ pun,
                                                 float* __restrict__ g, float* __restrict__ rn,
                                                 int K, int nsplit) {
  const int lane = threadIdx.x & 31;
  const long long ne = (long long)K * (K + 1) / 2;
  const long long n = ne + (pun != nullptr ? K : 0);
  const long long step = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; w < n; w += step) {
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
    } else {
      const long long k = w - ne;
      const float s = warp_ordered_sum(pun + k * nsplit, nsplit, lane);
      if (lane == 0) rn[k] = sqrtf(s);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gram_reduce_kernel(const float* __restrict__ pg, float* __restrict__ g, int K, int nsplit) {
  gram_reduce_body(pg, nullptr, g, nullptr, K, nsplit);
}

// ---------------------------------------------------------------------------
// AFA screening (Algorithm 1) in the last block of the Gram reduce
//
// Mirror of `_screen` in src/repro/kernels/afa_screen.py: reputation weights
// c = mask * pn / max(sum, EPS); similarities s = G c / (max(|u|, EPS) *
// sqrt(max(c^T G c, EPS))); masked mean, compare-count median (rank ties
// broken by client index) and std; the tail picked by mean vs median;
// xi += delta_xi each pass; a floor of 2 survivors; stop when nothing changes
// or at max_rounds.  The O(K^2) work is tiny beside the (K, D) passes, so one
// block runs it: the block of afa_reduce_screen_kernel that draws the last
// ticket, once every block has written its entries of G and rn, so the
// screen costs no launch of its own.  Up to kWarpScreenMaxK clients (both
// main paths) one warp screens from registers (screen_warp), G copied into
// shared memory; above, the whole block (screen_block), its K-vectors in
// shared memory and G read through L1, which later passes hit (no block
// reads G before the last block's fence, so L1 holds no stale line of it;
// at K = 200 G's 160 KB in shared memory would leave the reduce one block
// per SM).  Scalar reductions over K are chains in client-index order (on
// thread 0, or in every lane of the warp alike), and every other loop over
// clients computes each client's value alone, so on the same G both give
// the bits of the earlier one-block kernel of 1,024 threads.
// ---------------------------------------------------------------------------
constexpr int kWarpScreenMaxK = 32;  // one warp screens up to 32 clients

// The block screen's K-vectors in shared memory, and G in global memory.
struct ScreenShared {
  const float* G;
  float* rn;
  float* pn;
  float* c;
  float* gc;
  float* s;
  int* mask;
  int* bad;
  int* rank;
};

// The scalar reductions over K run on thread 0 in client-index order, as a
// chain of one rounded operation per client.  A dead client adds +0.0 in
// place of being skipped: every such chain starts at +0.0 and, rounding to
// nearest, can never reach -0.0, so x + 0.0 = x and the bits are those of
// the chain that skips; without the branch the loads can run ahead of the
// adds (kChainUnroll at a time).
constexpr int kChainUnroll = 8;

__device__ void screen_weights(const ScreenShared& sh, int K, float* scale) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) sh.c[k] = sh.mask[k] ? sh.pn[k] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
#pragma unroll kChainUnroll
    for (int k = 0; k < K; ++k) tot = __fadd_rn(tot, sh.c[k]);
    *scale = fmaxf(tot, kEps);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) sh.c[k] = sh.c[k] / *scale;
  __syncthreads();
}

// gc = G c: thread i walks column i of G (G[j, i] = G[i, j], the same
// values in the same order as row i), so a warp's reads are contiguous
__device__ void screen_sims(const ScreenShared& sh, int K, float* agg_norm) {
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    float acc = 0.f;
    const float* col = sh.G + i;
    // kScreenLoads loads in flight before their FMAs, kept in L1 for later passes
    for (int j0 = 0; j0 < K; j0 += kScreenLoads) {
      float g[kScreenLoads];
#pragma unroll
      for (int j = 0; j < kScreenLoads; ++j)
        g[j] = j0 + j < K ? __ldca(col + (long long)(j0 + j) * K) : 0.f;
#pragma unroll
      for (int j = 0; j < kScreenLoads; ++j)
        if (j0 + j < K) acc = fmaf(g[j], sh.c[j0 + j], acc);
    }
    sh.gc[i] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float cgc = 0.f;
#pragma unroll kChainUnroll
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
#pragma unroll kChainUnroll
    for (int k = 0; k < K; ++k) {
      m += sh.mask[k];
      sum = __fadd_rn(sum, sh.mask[k] ? sh.s[k] : 0.f);
    }
    const float mu = m > 0 ? sum / (float)(m > 1 ? m : 1) : 0.f;
    float var = 0.f;
#pragma unroll kChainUnroll
    for (int k = 0; k < K; ++k) {
      const float d = __fsub_rn(sh.s[k], mu);
      var = __fadd_rn(var, sh.mask[k] ? __fmul_rn(d, d) : 0.f);
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
#pragma unroll kChainUnroll
    for (int j = 0; j < K; ++j) {
      const float y = sh.s[j];
      r += sh.mask[j] && ((y < x) || (y == x && j < i));
    }
    sh.rank[i] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int m = flags[0];
    const int lo = (m - 1) / 2 > 0 ? (m - 1) / 2 : 0;
    const int hi = m / 2 > 0 ? m / 2 : 0;
    float v_lo = 0.f, v_hi = 0.f;
#pragma unroll kChainUnroll
    for (int k = 0; k < K; ++k) {
      const bool live = sh.mask[k];
      const float x = sh.s[k];
      v_lo = __fadd_rn(v_lo, live && sh.rank[k] == lo ? x : 0.f);
      v_hi = __fadd_rn(v_hi, live && sh.rank[k] == hi ? x : 0.f);
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
#pragma unroll kChainUnroll
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

// Algorithm 1 by one warp for K <= 32 (both main paths: K = 10 for the
// paper's DNN, 6 for LoRA): client k's values live in lane k's registers,
// and each scalar reduction is taken by every lane alike over shuffles, in
// client-index order, so all lanes hold the same bits and no barrier is
// needed.  The operations and their order are those of screen_weights,
// screen_sims and screen_mark_bad, so the outputs are theirs bit for bit.
// The loops run over K, not unrolled: the code stays small, and it is
// fetched cold when the kernel runs after other work (an unrolled form read
// slower on an H100).  Gs is G in shared memory.
__device__ void screen_warp(const float* Gs, const float* __restrict__ rn_g,
                            const float* __restrict__ pn, const unsigned char* __restrict__ mask0,
                            float* __restrict__ weights, unsigned char* __restrict__ good,
                            int* __restrict__ rounds_out, float* __restrict__ sims, int K,
                            float xi0, float delta_xi, int max_rounds, int ddof) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool in = lane < K;
  const float rn = in ? __ldcg(rn_g + lane) : 0.f;
  const float pnk = in ? pn[lane] : 0.f;
  bool mask = in && mask0[lane] != 0;
  float c = 0.f, s = 0.f;

  auto weights_pass = [&]() {
    c = mask ? pnk : 0.f;
    float tot = 0.f;
    for (int k = 0; k < K; ++k) tot = __fadd_rn(tot, __shfl_sync(kAll, c, k));
    c = c / fmaxf(tot, kEps);
  };
  auto sims_pass = [&]() {
    float gc = 0.f;
    for (int j = 0; j < K; ++j) {
      const float cj = __shfl_sync(kAll, c, j);
      if (in) gc = fmaf(Gs[j * K + lane], cj, gc);  // G[j, lane] = G[lane, j]
    }
    float cgc = 0.f;
    for (int k = 0; k < K; ++k)
      cgc = fmaf(__shfl_sync(kAll, c, k), __shfl_sync(kAll, gc, k), cgc);
    const float agg_norm = sqrtf(fmaxf(cgc, kEps));
    s = in ? gc / __fmul_rn(fmaxf(rn, kEps), agg_norm) : 0.f;
  };
  // one screening pass: bit 0 this lane's bad flag, bit 1 whether any
  // client was newly flagged (the block version's flags[1])
  auto mark_bad = [&](float xi) {
    const unsigned live = __ballot_sync(kAll, mask);
    const int m = __popc(live);
    float sum = 0.f;
    for (int k = 0; k < K; ++k) {
      const float x = __shfl_sync(kAll, s, k);
      if ((live >> k) & 1u) sum = __fadd_rn(sum, x);
    }
    const float mu = m > 0 ? sum / (float)(m > 1 ? m : 1) : 0.f;
    float var = 0.f;
    for (int k = 0; k < K; ++k) {
      const float x = __shfl_sync(kAll, s, k);
      if ((live >> k) & 1u) {
        const float d = __fsub_rn(x, mu);
        var = __fadd_rn(var, __fmul_rn(d, d));
      }
    }
    const int denom = (m - ddof) > 1 ? (m - ddof) : 1;
    var = var / (float)denom;
    const float sigma = sqrtf(fmaxf(var, 0.f));
    int rank = 0;  // compare-count rank among live clients (ties broken by index)
    for (int j = 0; j < K; ++j) {
      const float y = __shfl_sync(kAll, s, j);
      if ((live >> j) & 1u) rank += (y < s) || (y == s && j < lane);
    }
    const int lo = (m - 1) / 2 > 0 ? (m - 1) / 2 : 0;
    const int hi = m / 2 > 0 ? m / 2 : 0;
    float v_lo = 0.f, v_hi = 0.f;
    for (int k = 0; k < K; ++k) {
      const float x = __shfl_sync(kAll, s, k);
      const int rk = __shfl_sync(kAll, rank, k);
      if (((live >> k) & 1u) && rk == lo) v_lo = __fadd_rn(v_lo, x);
      if (((live >> k) & 1u) && rk == hi) v_hi = __fadd_rn(v_hi, x);
    }
    const float mu_bar = m > 0 ? __fmul_rn(0.5f, __fadd_rn(v_lo, v_hi)) : 0.f;
    const float band = __fmul_rn(xi, sigma);
    const float lo_thr = __fsub_rn(mu_bar, band);
    const float hi_thr = __fadd_rn(mu_bar, band);
    const bool low = mu < mu_bar;
    const bool bad = mask && (low ? (s < lo_thr) : (s > hi_thr));
    if (__popc(__ballot_sync(kAll, mask && !bad)) < 2) return 0;
    return (bad ? 1 : 0) | (__ballot_sync(kAll, bad) != 0u ? 2 : 0);
  };

  if (max_rounds == 0) {  // round-0 similarities: the loop never runs
    weights_pass();
    sims_pass();
  }
  float xi = xi0;
  int rounds = 0;
  bool changed = true;
  while (changed && rounds < max_rounds) {
    weights_pass();
    sims_pass();
    const int flags = mark_bad(xi);
    changed = (flags & 2) != 0;
    mask = mask && !(flags & 1);
    xi = __fadd_rn(xi, delta_xi);
    ++rounds;
  }
  weights_pass();
  if (in) {
    weights[lane] = c;
    good[lane] = mask ? 1 : 0;
    sims[lane] = s;
  }
  if (lane == 0) rounds_out[0] = rounds;
}

// The screen by the whole block, for K > kWarpScreenMaxK.
__device__ void screen_block(float* smem, float* G, const float* __restrict__ rn,
                             const float* __restrict__ pn, const unsigned char* __restrict__ mask0,
                             float* __restrict__ weights, unsigned char* __restrict__ good,
                             int* __restrict__ rounds_out, float* __restrict__ sims, int K,
                             float xi0, float delta_xi, int max_rounds, int ddof) {
  ScreenShared sh;
  sh.rn = smem;
  sh.pn = smem + K;
  sh.c = smem + 2 * K;
  sh.gc = smem + 3 * K;
  sh.s = smem + 4 * K;
  sh.mask = reinterpret_cast<int*>(smem + 5 * K);
  sh.bad = sh.mask + K;
  sh.rank = sh.bad + K;
  sh.G = G;
  __shared__ float scalar[2];
  __shared__ float stats[3];
  __shared__ int flags[2];

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    sh.rn[k] = __ldcg(rn + k);
    sh.pn[k] = pn[k];
    sh.mask[k] = mask0[k] != 0;
    sh.s[k] = 0.f;
  }
  __syncthreads();

  if (max_rounds == 0) {
    // round-0 similarities: the loop never runs
    screen_weights(sh, K, &scalar[0]);
    screen_sims(sh, K, &scalar[1]);
  }
  float xi = xi0;
  int rounds = 0;
  int changed = 1;
  while (changed && rounds < max_rounds) {
    screen_weights(sh, K, &scalar[0]);
    screen_sims(sh, K, &scalar[1]);
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
    good[k] = sh.mask[k] ? 1 : 0;
    sims[k] = sh.s[k];
  }
  if (threadIdx.x == 0) rounds_out[0] = rounds;
}

// grid: one warp per upper entry of G and per row norm, at most what the
// card holds at once, kThreads threads, dynamic shared memory 8 K floats
// (+ K^2 for the warp screen).  One instantiation per screen (kWarp: K <=
// kWarpScreenMaxK), so that neither's code is compiled beside the other's:
// in one kernel, the block screen's passes at K = 200 read from ~20 to
// ~60 us on an H100 as the warp screen's code changed around them.
template <bool kWarp>
__global__ void __launch_bounds__(kThreads)
afa_reduce_screen_kernel(const float* __restrict__ pg, const float* __restrict__ pun,
                         float* __restrict__ G, float* __restrict__ rn, LastBlock lb,
                         const float* __restrict__ pn, const unsigned char* __restrict__ mask0,
                         float* __restrict__ weights, unsigned char* __restrict__ good,
                         int* __restrict__ rounds_out, float* __restrict__ sims, int K,
                         int nsplit, float xi0, float delta_xi, int max_rounds, int ddof) {
  gram_reduce_body(pg, pun, G, rn, K, nsplit);
  if (!lb.draw()) return;
  extern __shared__ float smem[];
  if constexpr (kWarp) {  // one warp, G in shared memory
    float* g = smem + 8 * K;
    for (int e = threadIdx.x; e < K * K; e += blockDim.x) g[e] = __ldcg(G + e);
    __syncthreads();
    if (threadIdx.x < 32)
      screen_warp(g, rn, pn, mask0, weights, good, rounds_out, sims, K, xi0, delta_xi,
                  max_rounds, ddof);
  } else {
    screen_block(smem, G, rn, pn, mask0, weights, good, rounds_out, sims, K, xi0, delta_xi,
                 max_rounds, ddof);
  }
  lb.release();
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

// the geometry ops.cosine_geometry computed, checked the same way: a load
// width that U's and w's pointers and D allow, a chunk of whole column groups,
// and a split count that covers D exactly
bool cosine_geometry_ok(const float* u, const float* w, int K, long long D, int nsplit,
                        long long chunk, int width) {
  if (K < 1 || D < 1 || nsplit < 1 || nsplit > 65535) return false;
  if (width != 4 && width != 8 && width != 16) return false;
  if (chunk < width / 4 || chunk % (width / 4) != 0) return false;
  if ((long long)(nsplit - 1) * chunk >= D || (long long)nsplit * chunk < D) return false;
  return reinterpret_cast<uintptr_t>(u) % width == 0 &&
         reinterpret_cast<uintptr_t>(w) % width == 0 && (D * 4) % width == 0;
}

// the partial rows are read as float4
bool cosine_part_ok(const float* part) { return reinterpret_cast<uintptr_t>(part) % 16 == 0; }

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

// the Gram partials (and the squared row norms when pun is given); the
// geometry is checked first
cudaError_t launch_gram_partials(const float* u, float* pg, float* pun, int K, long long D,
                                 int tile_rows, int nsplit, long long chunk, int width,
                                 cudaStream_t stream) {
  if (!gram_geometry_ok(u, K, D, tile_rows, nsplit, chunk, width)) return cudaErrorInvalidValue;
  if (tile_rows == 16)
    return width == 16 ? launch_gram_tf32x3<16, 16>(u, pg, pun, K, D, nsplit, chunk, stream)
         : width == 8  ? launch_gram_tf32x3<16, 8>(u, pg, pun, K, D, nsplit, chunk, stream)
                       : launch_gram_tf32x3<16, 4>(u, pg, pun, K, D, nsplit, chunk, stream);
  return width == 16 ? launch_gram_tf32x3<32, 16>(u, pg, pun, K, D, nsplit, chunk, stream)
       : width == 8  ? launch_gram_tf32x3<32, 8>(u, pg, pun, K, D, nsplit, chunk, stream)
                     : launch_gram_tf32x3<32, 4>(u, pg, pun, K, D, nsplit, chunk, stream);
}

// the widest load (16, 8 or 4 bytes) that u's and out's pointers and D allow
int stream_width(const float* u, const float* out, long long D) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(out);
  for (int w = 16; w > 4; w /= 2)
    if (a % w == 0 && (D * 4) % w == 0) return w;
  return 4;
}

// blocks of kThreads that cover `items` threads' work once, at most as many
// as the card holds at once (the kernel's occupancy at `smem` bytes of
// dynamic shared memory times the SM count)
cudaError_t resident_grid(const void* kernel, long long items, size_t smem, unsigned* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long all = ceil_div(items, kThreads);
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (unsigned)(all < cap ? all : cap);
  return cudaSuccess;
}

template <int W>
cudaError_t launch_weighted_sum_w(const float* c, const float* u, float* out, int K, long long D,
                                  cudaStream_t stream) {
  unsigned blocks = 0;
  const cudaError_t err =
      resident_grid((const void*)weighted_sum_kernel<W>, D / (W / 4), 0, &blocks);
  if (err != cudaSuccess) return err;
  weighted_sum_kernel<W><<<blocks, kThreads, 0, stream>>>(c, u, out, K, D);
  return cudaGetLastError();
}

cudaError_t launch_weighted_sum(const float* c, const float* u, float* out, int K, long long D,
                                cudaStream_t stream) {
  const int width = stream_width(u, out, D);
  return width == 16 ? launch_weighted_sum_w<16>(c, u, out, K, D, stream)
       : width == 8  ? launch_weighted_sum_w<8>(c, u, out, K, D, stream)
                     : launch_weighted_sum_w<4>(c, u, out, K, D, stream);
}

template <int W>
cudaError_t launch_cosine(const float* u, const float* w, float* part, float* sims,
                          unsigned int* ticket, int K, long long D, int nsplit, long long chunk,
                          cudaStream_t stream) {
  cosine_sim_kernel<W><<<nsplit, kCosineThreads, 0, stream>>>(u, w, part, sims,
                                                              LastBlock{ticket}, K, D, chunk);
  return cudaGetLastError();
}

template <bool kWarp>
cudaError_t launch_reduce_screen(const float* pg, const float* pun, float* G, float* rn,
                                 unsigned int* ticket, const float* pn, const unsigned char* mask0,
                                 float* weights, unsigned char* good, int* rounds, float* sims,
                                 int K, int nsplit, float xi0, float delta_xi, int max_rounds,
                                 int ddof, cudaStream_t stream) {
  const size_t smem = (size_t)(8 * K + (kWarp ? K * K : 0)) * sizeof(float);
  unsigned blocks = 0;
  const cudaError_t err = resident_grid((const void*)afa_reduce_screen_kernel<kWarp>,
                                        ((long long)K * (K + 1) / 2 + K) * 32, smem, &blocks);
  if (err != cudaSuccess) return err;
  afa_reduce_screen_kernel<kWarp><<<blocks, kThreads, smem, stream>>>(
      pg, pun, G, rn, LastBlock{ticket}, pn, mask0, weights, good, rounds, sims, K, nsplit, xi0,
      delta_xi, max_rounds, ddof);
  return cudaGetLastError();
}

// largest K the screen holds in shared memory: 8 K-vectors in the 48 KB a
// launch may ask for without opting in, beside its static shared scalars
constexpr int kScreenMaxK = (48 * 1024 - 256) / (8 * (int)sizeof(float));

}  // namespace

extern "C" {

// largest K the screen holds in shared memory (8 K-vectors)
int repro_screen_max_k() { return kScreenMaxK; }

int repro_weighted_sum(const float* c, const float* u, float* out, int K, long long D,
                       void* stream) {
  return (int)launch_weighted_sum(c, u, out, K, D, static_cast<cudaStream_t>(stream));
}

// one launch.  part holds 2 K + 1 rows of nsplit floats rounded up to a
// multiple of 4, 16-byte aligned; ticket is the stream's counter, 0 at entry
// and left at 0; the geometry is ops.cosine_geometry's
int repro_cosine_sim(const float* u, const float* w, float* part, float* sims,
                     unsigned int* ticket, int K, long long D, int nsplit, long long chunk,
                     int width, void* stream) {
  if (!cosine_geometry_ok(u, w, K, D, nsplit, chunk, width) || !cosine_part_ok(part))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(width == 16 ? launch_cosine<16>(u, w, part, sims, ticket, K, D, nsplit, chunk, st)
             : width == 8  ? launch_cosine<8>(u, w, part, sims, ticket, K, D, nsplit, chunk, st)
                           : launch_cosine<4>(u, w, part, sims, ticket, K, D, nsplit, chunk, st));
}

// two launches: the Gram partials and their reduce.  pg holds
// K (K + 1) / 2 * nsplit floats; the geometry is ops.gram_geometry's
int repro_gram(const float* u, float* pg, float* g, int K, long long D, int tile_rows,
               int nsplit, long long chunk, int width, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_gram_partials(u, pg, nullptr, K, D, tile_rows, nsplit, chunk, width,
                                         st);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = 0;
  err = resident_grid((const void*)gram_reduce_kernel, (long long)K * (K + 1) / 2 * 32, 0,
                      &blocks);
  if (err != cudaSuccess) return (int)err;
  gram_reduce_kernel<<<blocks, kThreads, 0, st>>>(pg, g, K, nsplit);
  return (int)cudaGetLastError();
}

// three launches: the Gram and row-norm partials; their reduce into G and rn
// with the screen in its last block (weights, good, rounds, sims); the
// weighted sum with the final weights into agg.  pun holds K * nsplit
// floats; mask0 and good are one byte per client (torch.bool); ticket is the
// stream's counter, 0 at entry and left at 0
int repro_afa_screen(const float* u, const float* pn, const unsigned char* mask0, float* pg,
                     float* pun, float* G, float* rn, float* weights, float* agg,
                     unsigned char* good, int* rounds, float* sims, unsigned int* ticket, int K,
                     long long D, int tile_rows, int nsplit, long long chunk, int width,
                     float xi0, float delta_xi, int max_rounds, int ddof, void* stream) {
  if (K > kScreenMaxK) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_gram_partials(u, pg, pun, K, D, tile_rows, nsplit, chunk, width, st);
  if (err != cudaSuccess) return (int)err;
  err = K <= kWarpScreenMaxK
            ? launch_reduce_screen<true>(pg, pun, G, rn, ticket, pn, mask0, weights, good, rounds,
                                         sims, K, nsplit, xi0, delta_xi, max_rounds, ddof, st)
            : launch_reduce_screen<false>(pg, pun, G, rn, ticket, pn, mask0, weights, good,
                                          rounds, sims, K, nsplit, xi0, delta_xi, max_rounds,
                                          ddof, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_weighted_sum(weights, u, agg, K, D, st);
}

}  // extern "C"
