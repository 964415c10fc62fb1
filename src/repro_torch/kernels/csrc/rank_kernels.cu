// Hand-written Hopper (sm_90a) kernels for the coordinate-wise rank rules.
//
// Two functions, each the port of Pallas TPU kernels of the JAX package:
//
//   repro_coord_median  <- src/repro/kernels/coord_median.py  _coord_median_kernel (mask null)
//                          and _coord_median_masked_kernel (mask given)
//   repro_trimmed_mean  <- src/repro/kernels/trimmed_mean.py  _trimmed_mean_kernel
//
// Both reduce each column of a (K, D) update matrix (K clients, D the packed
// model width, ~5e5 for the paper DNN) to one value by rank:
//
//   rank_i = #{k live : x_k < x_i} + #{k live : x_k == x_i and k < i}
//
// the compare-count rank with ties broken by client index.  The median is the
// mean of the live values of rank (m-1)/2 and m/2 (0 where no row is live);
// the trimmed mean averages the live values of rank trim <= r < m - trim over
// m - 2 trim, or all live values over max(m, 1) when m <= 2 trim.  A dead row
// is neither ranked nor counted, and K is never padded: a zero row would
// shift the median.
//
// What bounds them: the bytes of the operand, (K D + D) * 4, read once and
// written once: 0.0070 ms at K = 10 and about 0.13 ms at K = 200 on an H100 at
// 3.35 TB/s.  The design below does K^2 compares per column (2.1e10 at
// K = 200, D = 535,818), so at large K it is bound by those compares and the
// shared-memory reads that feed them, far from the byte bound.  A selection
// or sorting network per column would cut that; it has to keep the same
// tie-break and the same masking.
//
// Design: one thread per column.  A block of T threads owns T neighbouring
// columns.  Warp 0 lists the live rows in index order (a ballot per 32 rows);
// then every thread copies its column's live values into shared memory, row
// by row, so neighbouring threads read neighbouring addresses of one row.
// Each thread then ranks its own column among the m live values and sums in
// ascending row order.  No thread reads another's column, there are no
// atomics, and two runs on the same inputs are bit-identical.  The tile is
// (T + 1) K * 4 bytes of dynamic shared memory (the row list and the
// values), so T shrinks from 128 to 32 as K grows; above 48 KB the kernel is
// given the larger limit with cudaFuncSetAttribute.  K beyond what a 32-column
// tile holds (repro_rank_max_k) is refused by the caller, never truncated.
//
// Every function has a plain C interface (loaded with ctypes), launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 227 KB, the most shared memory a block may use, less room for the kernel's
// static shared memory (one int)
constexpr int kMaxSmemBytes = 232448 - 16;
constexpr int kDefaultSmemBytes = 48 * 1024;  // above this a kernel must opt in
constexpr int kTileWidths[] = {128, 64, 32};  // columns per block, widest that fits

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

size_t tile_bytes(int K, int T) { return (size_t)(T + 1) * K * sizeof(float); }

int tile_width(int K) {
  for (int T : kTileWidths)
    if (tile_bytes(K, T) <= (size_t)kMaxSmemBytes) return T;
  return 0;
}

// kTrim == false: the median; true: the trimmed mean with `trim`.
template <bool kTrim>
__global__ void rank_select_kernel(const float* __restrict__ u, const int* __restrict__ mask,
                                   float* __restrict__ out, int K, long long D, int trim) {
  extern __shared__ float smem[];
  int* rows = reinterpret_cast<int*>(smem);   // live row indices, ascending
  float* tile = smem + K;                     // tile[r * T + t]: live row r, column t
  __shared__ int live_count;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long j = (long long)blockIdx.x * T + t;

  if (t < 32) {
    int m = 0;
    for (int base = 0; base < K; base += 32) {
      const int k = base + t;
      const bool live = k < K && (mask == nullptr || mask[k] != 0);
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      if (live) rows[m + __popc(ballot & ((1u << t) - 1u))] = k;
      m += __popc(ballot);
    }
    if (t == 0) live_count = m;
  }
  __syncthreads();
  const int m = live_count;
  if (j >= D) return;  // the ragged edge of D: no later barrier

  for (int r = 0; r < m; ++r) tile[r * T + t] = __ldg(u + (long long)rows[r] * D + j);

  float acc = 0.f;
  if (kTrim && m <= 2 * trim) {
    // empty trim window: the masked mean
    for (int r = 0; r < m; ++r) acc += tile[r * T + t];
    out[j] = acc / (float)(m > 1 ? m : 1);
    return;
  }
  const int lo = (m - 1) / 2, hi = m / 2;
  float v_lo = 0.f, v_hi = 0.f;
  for (int i = 0; i < m; ++i) {
    const float xi = tile[i * T + t];
    int rank = 0;
    for (int k = 0; k < i; ++k) rank += tile[k * T + t] <= xi;  // ties: lower index first
    for (int k = i + 1; k < m; ++k) rank += tile[k * T + t] < xi;
    if (kTrim) {
      if (rank >= trim && rank < m - trim) acc += xi;
    } else {
      if (rank == lo) v_lo = xi;
      if (rank == hi) v_hi = xi;
    }
  }
  if (kTrim)
    out[j] = acc / (float)(m - 2 * trim);
  else
    out[j] = m > 0 ? 0.5f * (v_lo + v_hi) : 0.f;
}

template <bool kTrim>
int launch_rank_select(const float* u, const int* mask, float* out, int K, long long D, int trim,
                       void* stream) {
  const int T = tile_width(K);
  if (T == 0) return (int)cudaErrorInvalidValue;  // the wrapper refuses such K first
  const size_t smem = tile_bytes(K, T);
  if (smem > (size_t)kDefaultSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        rank_select_kernel<kTrim>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)ceil_div(D, T);
  rank_select_kernel<kTrim><<<blocks, T, smem, static_cast<cudaStream_t>(stream)>>>(
      u, mask, out, K, D, trim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// largest K a 32-column tile holds in shared memory
int repro_rank_max_k() { return kMaxSmemBytes / (33 * (int)sizeof(float)); }

// mask: (K,) int32, nonzero = live, or null for every row live
int repro_coord_median(const float* u, const int* mask, float* out, int K, long long D,
                       void* stream) {
  return launch_rank_select<false>(u, mask, out, K, D, 0, stream);
}

int repro_trimmed_mean(const float* u, const int* mask, float* out, int K, long long D, int trim,
                       void* stream) {
  return launch_rank_select<true>(u, mask, out, K, D, trim, stream);
}

}  // extern "C"
