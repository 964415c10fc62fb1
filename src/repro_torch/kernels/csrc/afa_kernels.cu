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
// read from HBM; only the Gram product at K ~ 200 becomes bound by FP32
// operations (K(K+1)D multiply-adds).
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
constexpr int kTileD = 32;       // D columns per shared-memory tile (Gram)
constexpr int kTargetBlocks = 1056;  // eight blocks for each of the 132 SMs
constexpr long long kMaxPartials = 1 << 20;  // floats of Gram partials at most
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
// Gram partials: pg[i, j, s] = sum over the columns of split s of u_i * u_j
//
// grid = (tile pairs ti <= tj of the (K, K) output, D splits).  A block of
// 16 x 16 threads owns one BT x BT output tile (BT = 16 * TM, each thread a
// TM x TM register tile), streams its D range through shared memory in
// kTileD-column tiles, and writes its partial tile.  Only the upper tile
// triangle is computed (G is symmetric); the reduction reads entry
// (min(i, j), max(i, j)).  Blocks on diagonal tiles also accumulate the row
// norms sum_d u_i^2 into pun[i, s] when pun is given (afa_screen needs them
// apart from the Gram matrix, as its TPU kernel computes them).
// ---------------------------------------------------------------------------
template <int TM>
__global__ void gram_parts_kernel(const float* __restrict__ u, float* __restrict__ pg,
                                  float* __restrict__ pun, int K, long long D, long long chunk,
                                  int ntiles) {
  constexpr int BT = 16 * TM;
  __shared__ float As[kTileD][BT + 1];
  __shared__ float Bs[kTileD][BT + 1];
  int p = blockIdx.x;
  int ti = 0;
  while (p >= ntiles - ti) {
    p -= ntiles - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int split = blockIdx.y;
  const long long d_begin = (long long)split * chunk;
  long long d_end = d_begin + chunk;
  if (d_end > D) d_end = D;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row_a0 = ti * BT;
  const int row_b0 = tj * BT;
  const bool diag = (ti == tj);

  float acc[TM][TM];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TM; ++b) acc[a][b] = 0.f;
  float rn = 0.f;

  for (long long d0 = d_begin; d0 < d_end; d0 += kTileD) {
    // cooperative load: 32 consecutive columns per warp, 8 rows per pass
    const int col = tid & (kTileD - 1);
    const long long d = d0 + col;
    const bool dok = d < d_end;
    for (int r = tid / kTileD; r < BT; r += kThreads / kTileD) {
      const int ra = row_a0 + r;
      const int rb = row_b0 + r;
      As[col][r] = (dok && ra < K) ? __ldg(u + (long long)ra * D + d) : 0.f;
      Bs[col][r] = (dok && rb < K) ? __ldg(u + (long long)rb * D + d) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTileD; ++kk) {
      float av[TM], bv[TM];
#pragma unroll
      for (int a = 0; a < TM; ++a) av[a] = As[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < TM; ++b) bv[b] = Bs[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TM; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    if (diag && pun != nullptr && tid < BT) {
      for (int kk = 0; kk < kTileD; ++kk) rn = fmaf(As[kk][tid], As[kk][tid], rn);
    }
    __syncthreads();
  }

  const int nsplit = gridDim.y;
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int i = row_a0 + ty + 16 * a;
    if (i >= K) continue;
#pragma unroll
    for (int b = 0; b < TM; ++b) {
      const int j = row_b0 + tx + 16 * b;
      if (j < K) pg[((long long)i * K + j) * nsplit + split] = acc[a][b];
    }
  }
  if (diag && pun != nullptr && tid < BT && row_a0 + tid < K) {
    pun[(long long)(row_a0 + tid) * nsplit + split] = rn;
  }
}

// Stage 2: one warp per entry (i, j), a fixed-order sum over the splits of
// partial entry (min(i, j), max(i, j)).
__global__ void gram_reduce_kernel(const float* __restrict__ pg, float* __restrict__ g, int K,
                                   int nsplit) {
  const long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long kk = (long long)K * K;
  if (idx >= kk) return;
  const int i = (int)(idx / K);
  const int j = (int)(idx % K);
  const long long off = (long long)(i < j ? i : j) * K + (i < j ? j : i);
  const float s = warp_ordered_sum(pg + off * nsplit, nsplit, lane);
  if (lane == 0) g[idx] = s;
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
// CTA runs it: G (reduced from the partials here, in split order) stays in
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

__global__ void afa_screen_kernel(const float* __restrict__ pg, const float* __restrict__ pun,
                                  int nsplit, const float* __restrict__ pn,
                                  const int* __restrict__ mask0, float* __restrict__ G,
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

  // second stage of the Gram and row-norm reductions: one warp per entry,
  // fixed-order sums over the splits
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long kk = (long long)K * K;
  for (long long idx = warp; idx < kk; idx += nwarps) {
    const int i = (int)(idx / K);
    const int j = (int)(idx % K);
    const long long off = (long long)(i < j ? i : j) * K + (i < j ? j : i);
    const float s = warp_ordered_sum(pg + off * nsplit, nsplit, lane);
    if (lane == 0) G[idx] = s;
  }
  for (int k = warp; k < K; k += nwarps) {
    const float s = warp_ordered_sum(pun + (long long)k * nsplit, nsplit, lane);
    if (lane == 0) sh.rn[k] = sqrtf(s);
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
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

int gram_tile_rows(int K) { return K <= 16 ? 16 : (K <= 32 ? 32 : 64); }

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

int gram_nsplit_impl(int K, long long D) {
  const long long ntiles = ceil_div(K, gram_tile_rows(K));
  const long long npairs = ntiles * (ntiles + 1) / 2;
  long long n = ceil_div(kTargetBlocks, npairs);
  // the one-CTA screen reduces the partials itself: keep them L2-sized
  const long long cap = kMaxPartials / ((long long)K * K);
  if (n > cap) n = cap;
  const long long max_n = ceil_div(D, kTileD);
  if (n > max_n) n = max_n;
  return (int)(n < 1 ? 1 : n);
}

// launches the Gram partial kernel; pun may be null
cudaError_t launch_gram_parts(const float* u, float* pg, float* pun, int K, long long D,
                              int nsplit, cudaStream_t stream) {
  const int bt = gram_tile_rows(K);
  const int ntiles = (int)ceil_div(K, bt);
  const int npairs = ntiles * (ntiles + 1) / 2;
  const long long chunk = ceil_div(ceil_div(D, nsplit), kTileD) * kTileD;
  const dim3 grid(npairs, nsplit);
  if (bt == 16) {
    gram_parts_kernel<1><<<grid, kThreads, 0, stream>>>(u, pg, pun, K, D, chunk, ntiles);
  } else if (bt == 32) {
    gram_parts_kernel<2><<<grid, kThreads, 0, stream>>>(u, pg, pun, K, D, chunk, ntiles);
  } else {
    gram_parts_kernel<4><<<grid, kThreads, 0, stream>>>(u, pg, pun, K, D, chunk, ntiles);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// number of D splits (partial blocks) of the cosine parts and the Gram kernels;
// the caller sizes its scratch with these
int repro_cosine_nsplit(long long D) { return (int)ceil_div(D, kChunk); }

int repro_gram_nsplit(int K, long long D) { return gram_nsplit_impl(K, D); }

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

int repro_gram(const float* u, float* pg, float* g, int K, long long D, int nsplit,
               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_gram_parts(u, pg, nullptr, K, D, nsplit, st);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)ceil_div((long long)K * K * 32, kThreads);
  gram_reduce_kernel<<<blocks, kThreads, 0, st>>>(pg, g, K, nsplit);
  return (int)cudaGetLastError();
}

// three launches: Gram + row-norm partials, the one-CTA screen, the weighted
// sum with the final weights
int repro_afa_screen(const float* u, const float* pn, const int* mask0, float* pg, float* pun,
                     float* G, float* weights, float* agg, int* good, int* rounds, float* sims,
                     int K, long long D, int nsplit, float xi0, float delta_xi, int max_rounds,
                     int ddof, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_gram_parts(u, pg, pun, K, D, nsplit, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)8 * K * sizeof(float);
  afa_screen_kernel<<<1, kScreenThreads, smem, st>>>(
      pg, pun, nsplit, pn, mask0, G, weights, good, rounds, sims, K, xi0, delta_xi, max_rounds,
      ddof);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)ceil_div(D, kThreads);
  weighted_sum_kernel<<<blocks, kThreads, 0, st>>>(weights, u, agg, K, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
