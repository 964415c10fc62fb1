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
// the compare-count rank with ties broken by client index (-0.0 and +0.0
// compare equal, so their tie falls to the index).  The median is the mean of
// the live values of rank (m-1)/2 and m/2 (0 where no row is live); the
// trimmed mean adds the live values of rank trim <= r < m - trim in ascending
// row order, from +0.0, and divides once by m - 2 trim, or adds every live
// value and divides by max(m, 1) when m <= 2 trim.  A dead row is neither
// ranked nor counted, and K is never padded: a zero row would shift the
// median.  NaN inputs are out of scope.
//
// What bounds them: the bytes of the operand, (K D + D) * 4, read once and
// written once: 0.0070 ms at K = 10 and about 0.13 ms at K = 200 on an H100
// at 3.35 TB/s.  Two paths, chosen by K inside the C entry, on the plan that
// ops.rank_geometry makes and the entry checks:
//
// * K <= 32 (the main path's K = 10, LoRA's K = 6): rank_regs_kernel streams
//   U.  A grid of resident blocks strides over groups of W / 4 neighbouring
//   columns (W = 16, 8 or 4 bytes, the widest load U's and the output's
//   pointers and D allow, at most kRegMaxValues values a thread).  Each warp
//   builds the live-row bitmask with one ballot (lane k reads mask byte k):
//   no shared memory, no block barrier.  K is a template bucket (8, 16, 32),
//   so the row loop unrolls and every live row's load is issued before the
//   first compare; dead rows are not loaded.  The live values sit in
//   registers in ascending row order, and each pair (k < i) of them is
//   compared once: x_k <= x_i counts toward i's rank, its negation toward
//   k's, which is the compare-count rank.  The ranks are packed, 4 bits
//   each (8 in the bucket of 32), so a pair costs a compare and one
//   predicated add, and the selection reads the packed words as they are.
// * K > 32: rank_select_kernel selects.  A block copies a tile of kTile
//   columns x m live rows into shared memory (cp.async; the columns XOR-
//   swizzled by row, so a warp reading one column down 32 rows and a warp
//   writing 32 columns of one row both hit 32 banks).  One warp per column
//   finds the (key, position) of each wanted rank on the order-preserving
//   32-bit image of the value (-0.0 mapped to +0.0's key); lane l holds the
//   keys of positions l, l + 32, ... in registers.  A rank within
//   kExtractMax of either end (the trimmed mean's bounds at a small trim) is
//   found one distinct key at a time from that end, by integer min or max
//   warp reductions and counts; any other (the median) by a radix select
//   with one-bit digits, 32 rounds that each count the keys below a
//   threshold with one integer warp reduction; the median's second rank is
//   the next element in (key, position) order.  The group of equal keys is
//   resolved by position, in row order, with ballots.  The median reads the
//   two chosen elements' own bits from the tile; for the trimmed mean one
//   thread per column then walks its tile in ascending row order and adds
//   the values that lie within the two bounds in (value, position) order.
//   That is at most 32 rounds of m / 32 compares a lane, where comparing
//   every pair would take m^2 compares a column (4e4 at K = 200).
//
// On both paths every output is the compare-count's bit for bit: the median
// selects, and the trimmed mean adds the same values in ascending row order.
// No float atomics, so two runs on the same inputs are bit-identical.  K
// beyond repro_rank_max_k (1,760) is refused by the caller, never truncated.
//
// Every function has a plain C interface (loaded with ctypes), launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kRankThreads = 256;   // threads of a rank block (ops.RANK_THREADS)
constexpr int kRegMaxK = 32;        // the register path's largest K (ops.RANK_REG_MAX_K)
constexpr int kRegMaxValues = 64;   // values a register thread holds (ops.RANK_REG_MAX_VALUES)
constexpr int kTile = 32;           // columns of a selection tile (ops.RANK_TILE)
// 227 KB, the most shared memory a block may use, less room for the kernel's
// static shared memory (one int)
constexpr int kMaxSmemBytes = 232448 - 16;
constexpr int kDefaultSmemBytes = 48 * 1024;  // above this a kernel must opt in

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// rows a register-path thread holds: 8, 16 or 32; 0 above kRegMaxK (the
// selection path)
__host__ __device__ constexpr int reg_bucket(int K) {
  return K <= 8 ? 8 : K <= 16 ? 16 : K <= kRegMaxK ? 32 : 0;
}

// blocks of the register path on one SM (ops._rank_ctas_per_sm): four where
// KB (V + 1) <= 48 (a thread's KB V values, with room for its ranks and
// addresses within 64 registers), else two
__host__ __device__ constexpr int reg_ctas_per_sm(int KB, int V) {
  return KB * (V + 1) <= 48 ? 4 : 2;
}

// W bytes of floats (W = 16, 8 or 4) from p, which is W-aligned
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
// K <= 32: the register path
// ---------------------------------------------------------------------------

// The ranks of a column, packed: rank i in the kBits bits from kBits (i %
// kPer) of word i / kPer (a rank is at most KB - 1).
template <int KB>
struct PackedRanks {
  static constexpr int kBits = KB <= 16 ? 4 : 8;
  static constexpr int kPer = 32 / kBits;
  static constexpr int kWords = KB / kPer;
  static constexpr unsigned kField = (1u << kBits) - 1u;
  static constexpr unsigned kOnes = kBits == 4 ? 0x11111111u : 0x01010101u;  // 1 in every field
};

// Every pair (k < i) of the m live values counted toward k: rank k starts
// at m - 1 - k.  The fields from m on hold all ones, above every rank of a
// live value when m < KB, so no selection takes them.  The same for every
// column, so made once a thread.
template <int KB>
__device__ __forceinline__ void rank_base(int m, unsigned (&w)[PackedRanks<KB>::kWords]) {
  using R = PackedRanks<KB>;
#pragma unroll
  for (int q = 0; q < R::kWords; ++q) w[q] = 0u;
#pragma unroll
  for (int k = 0; k < KB; ++k)
    w[k / R::kPer] += (k < m ? (unsigned)(m - 1 - k) : R::kField) << (R::kBits * (k % R::kPer));
}

// The median (kTrim false) or the trimmed mean of column v of x, whose rows
// 0 .. m hold the live values in ascending row order (m <= KB; m is the
// same in every thread, so the guards are uniform branches).
template <int KB, int V, bool kTrim>
__device__ __forceinline__ float rank_column(const float (&x)[KB][V], int v, int m, int trim,
                                             const unsigned (&base)[PackedRanks<KB>::kWords]) {
  using R = PackedRanks<KB>;
  if (kTrim && m <= 2 * trim) {  // empty trim window: the masked mean
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < KB; ++i)
      if (i < m) acc += x[i][v];
    return acc / (float)(m > 1 ? m : 1);
  }
  // each pair with x_k <= x_i (ties: the lower row first) moves its count
  // from k to i: one predicated add where both ranks share a word.  A field
  // stays within [0, m - 1], so no carry or borrow crosses into the next.
  unsigned w[R::kWords];
#pragma unroll
  for (int q = 0; q < R::kWords; ++q) w[q] = base[q];
#pragma unroll
  for (int i = 1; i < KB; ++i) {
    if (i < m) {
#pragma unroll
      for (int k = 0; k < i; ++k) {
        const unsigned to_i = 1u << (R::kBits * (i % R::kPer));
        const unsigned from_k = 1u << (R::kBits * (k % R::kPer));
        if (x[k][v] <= x[i][v]) {
          if (i / R::kPer == k / R::kPer) {
            w[i / R::kPer] += to_i - from_k;
          } else {
            w[i / R::kPer] += to_i;
            w[k / R::kPer] -= from_k;
          }
        }
      }
    }
  }
  if (kTrim) {  // kept: trim <= rank < m - trim, in ascending row order
    const unsigned span = m - 2 * trim;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      const unsigned r = (w[i / R::kPer] >> (R::kBits * (i % R::kPer))) & R::kField;
      if (r - trim < span) acc += x[i][v];
    }
    return acc / (float)(m - 2 * trim);
  }
  // the fields equal to lo (hi) are the zero fields of w ^ lo (hi) in every field
  unsigned zlo[R::kWords], zhi[R::kWords];
#pragma unroll
  for (int q = 0; q < R::kWords; ++q) {
    zlo[q] = w[q] ^ ((unsigned)((m - 1) / 2) * R::kOnes);
    zhi[q] = w[q] ^ ((unsigned)(m / 2) * R::kOnes);
  }
  float v_lo = 0.f, v_hi = 0.f;
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    const unsigned f = R::kField << (R::kBits * (i % R::kPer));
    if ((zlo[i / R::kPer] & f) == 0u) v_lo = x[i][v];
    if ((zhi[i / R::kPer] & f) == 0u) v_hi = x[i][v];
  }
  return m > 0 ? 0.5f * (v_lo + v_hi) : 0.f;
}

// x[r] = the r-th live row's W bytes at p, for r < m (the live rows of
// the bitmask `live`, in index order); the other rows are not loaded
template <int KB, int W>
__device__ __forceinline__ void load_live(const float* p, long long D, unsigned live, int m,
                                          float (&x)[KB][W / 4]) {
#pragma unroll
  for (int r = 0; r < KB; ++r) {
    if (r < m) {
      const int k = __ffs(live) - 1;
      live &= live - 1;
      load_vec<W>(p + (long long)k * D, x[r]);
    }
  }
}

template <int KB, int W, bool kTrim>
__global__ void __launch_bounds__(kRankThreads, reg_ctas_per_sm(KB, W / 4))
rank_regs_kernel(const float* __restrict__ u, const unsigned char* __restrict__ mask,
                 float* __restrict__ out, int K, long long D, int trim) {
  constexpr int V = W / 4;
  const int lane = threadIdx.x & 31;
  const unsigned live = __ballot_sync(kAll, lane < K && (mask == nullptr || mask[lane] != 0));
  const int m = __popc(live);
  const long long groups = D / V;
  unsigned base[PackedRanks<KB>::kWords];
  rank_base<KB>(m, base);
  for (long long g = (long long)blockIdx.x * kRankThreads + threadIdx.x; g < groups;
       g += (long long)gridDim.x * kRankThreads) {
    float x[KB][V];
    load_live<KB, W>(u + g * V, D, live, m, x);
    float y[V];
#pragma unroll
    for (int v = 0; v < V; ++v) y[v] = rank_column<KB, V, kTrim>(x, v, m, trim, base);
    store_vec<W>(out + g * V, y);
  }
}

// ---------------------------------------------------------------------------
// K > 32: the selection path
// ---------------------------------------------------------------------------

// keys a lane holds: 32 KS >= K
__host__ __device__ constexpr int select_slots(int K) {
  return K <= 64 ? 2 : K <= 128 ? 4 : K <= 256 ? 8 : K <= 512 ? 16 : K <= 1024 ? 32 : 56;
}

// shared memory of a selection block: the tile (K x kTile floats), the
// live-row list (K shorts, padded to 16 bytes), the trimmed mean's bounds
// (kTile uint4)
__host__ __device__ constexpr size_t select_rows_offset(int K) {
  return (size_t)K * kTile * sizeof(float);
}
__host__ __device__ constexpr size_t select_bounds_offset(int K) {
  return select_rows_offset(K) + ((size_t)2 * K + 15) / 16 * 16;
}
__host__ __device__ constexpr size_t select_smem_bytes(int K) {
  return select_bounds_offset(K) + kTile * sizeof(uint4);
}

// The order-preserving image of a float: a < b iff key(a) < key(b), and
// key(-0.0) == key(+0.0).
__device__ __forceinline__ unsigned order_key(float x) {
  unsigned b = __float_as_uint(x);
  b = b == 0x80000000u ? 0u : b;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// tile slot of live position pos, column c: the column XOR-swizzled by row
__device__ __forceinline__ int swz(int pos, int c) {
  return pos * kTile + (c ^ (pos & (kTile - 1)));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" : : "r"(s), "l"(src) : "memory");
}

constexpr unsigned kExtractMax = 16;  // ranks this close to an end are found by extraction

// Over the warp's keys (lane l holds key[s], the key at position l + 32 s,
// all-ones past the live count: above every key of a value): the number
// below t, the number equal to t, the smallest, the smallest above k and the
// largest below k.
template <int KS>
__device__ __forceinline__ unsigned count_below(const unsigned (&key)[KS], unsigned t) {
  unsigned c = 0;
#pragma unroll
  for (int s = 0; s < KS; ++s) c += key[s] < t;
  return __reduce_add_sync(kAll, c);
}

template <int KS>
__device__ __forceinline__ unsigned count_equal(const unsigned (&key)[KS], unsigned t) {
  unsigned c = 0;
#pragma unroll
  for (int s = 0; s < KS; ++s) c += key[s] == t;
  return __reduce_add_sync(kAll, c);
}

template <int KS>
__device__ __forceinline__ unsigned min_key(const unsigned (&key)[KS]) {
  unsigned n = kAll;
#pragma unroll
  for (int s = 0; s < KS; ++s) n = min(n, key[s]);
  return __reduce_min_sync(kAll, n);
}

template <int KS>
__device__ __forceinline__ unsigned next_key(const unsigned (&key)[KS], unsigned k) {
  unsigned n = kAll;
#pragma unroll
  for (int s = 0; s < KS; ++s) n = key[s] > k ? min(n, key[s]) : n;
  return __reduce_min_sync(kAll, n);
}

template <int KS>
__device__ __forceinline__ unsigned prev_key(const unsigned (&key)[KS], unsigned k) {
  unsigned n = 0u;
#pragma unroll
  for (int s = 0; s < KS; ++s) n = key[s] < k ? max(n, key[s]) : n;
  return __reduce_max_sync(kAll, n);
}

// The key of the element of rank t among the m live keys, and #{key < it}.
// Within kExtractMax of either end: one distinct key at a time from that end
// (a min or max reduction and a count a step); else a radix select with
// one-bit digits: the largest P with #{key < P} <= t, bit by bit from the top.
template <int KS>
__device__ __forceinline__ unsigned select_key(const unsigned (&key)[KS], int m, unsigned t,
                                               unsigned& below) {
  const unsigned from_top = m - 1 - t;
  if (t < kExtractMax) {
    below = 0u;
    for (unsigned k = min_key(key);; k = next_key(key, k)) {
      const unsigned n = count_equal(key, k);
      if (below + n > t) return k;
      below += n;
    }
  }
  if (from_top < kExtractMax) {
    unsigned above = 0u;
    for (unsigned k = prev_key(key, kAll);; k = prev_key(key, k)) {
      const unsigned n = count_equal(key, k);
      if (above + n > from_top) {
        below = m - above - n;
        return k;
      }
      above += n;
    }
  }
  unsigned p = 0u;
#pragma unroll 1
  for (int b = 31; b >= 0; --b) {
    const unsigned q = p | (1u << b);
    if (count_below(key, q) <= t) p = q;
  }
  below = count_below(key, p);
  return p;
}

// The position of the j-th (from 0) key equal to p, in position (= row)
// order.
template <int KS>
__device__ __forceinline__ int nth_equal(const unsigned (&key)[KS], unsigned p, int j) {
  int pos = -1;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (pos < 0) {
      unsigned eq = __ballot_sync(kAll, key[s] == p);
      const int n = __popc(eq);
      if (j < n) {
        for (int q = 0; q < j; ++q) eq &= eq - 1;
        pos = s * 32 + __ffs(eq) - 1;
      } else {
        j -= n;
      }
    }
  }
  return pos;
}

template <int KS, bool kTrim>
__global__ void __launch_bounds__(kRankThreads)
rank_select_kernel(const float* __restrict__ u, const unsigned char* __restrict__ mask,
                   float* __restrict__ out, int K, long long D, int trim) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);  // tile[swz(pos, c)]
  unsigned short* rows = reinterpret_cast<unsigned short*>(smem + select_rows_offset(K));
  uint4* bounds = reinterpret_cast<uint4*>(smem + select_bounds_offset(K));
  __shared__ int live_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long col0 = (long long)blockIdx.x * kTile;
  const int ncols = D - col0 < kTile ? (int)(D - col0) : kTile;

  if (warp == 0) {  // the live rows in index order, a ballot per 32 rows
    int m = 0;
    for (int base = 0; base < K; base += 32) {
      const int k = base + lane;
      const bool live = k < K && (mask == nullptr || mask[k] != 0);
      const unsigned ballot = __ballot_sync(kAll, live);
      if (live) rows[m + __popc(ballot & ((1u << lane) - 1u))] = (unsigned short)k;
      m += __popc(ballot);
    }
    if (lane == 0) live_count = m;
  }
  __syncthreads();
  const int m = live_count;
  if (!kTrim && m == 0) {
    if (tid < ncols) out[col0 + tid] = 0.f;
    return;
  }
  for (int i = tid; i < m * kTile; i += kRankThreads) {
    const int pos = i / kTile, c = i % kTile;
    if (c < ncols) cp_async4(tile + swz(pos, c), u + (long long)rows[pos] * D + col0 + c);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const bool select = !kTrim || m > 2 * trim;
  if (select) {
    const unsigned t0 = kTrim ? trim : (m - 1) / 2;
    const unsigned t1 = kTrim ? m - trim - 1 : m / 2;
    for (int c = warp; c < ncols; c += kRankThreads / 32) {
      unsigned key[KS];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int pos = s * 32 + lane;
        key[s] = pos < m ? order_key(tile[swz(pos, c)]) : kAll;
      }
      // the (key, position) of ranks t0 and t1; the median's t1 = t0 + 1 (m
      // even) is the next equal key after t0's, or else the next key up
      unsigned below0, below1;
      const unsigned k0 = select_key(key, m, t0, below0);
      unsigned k1 = k0;
      below1 = below0;
      if (kTrim) {
        k1 = select_key(key, m, t1, below1);
      } else if (t1 != t0) {
        const unsigned n0 = count_equal(key, k0);
        if (t1 >= below0 + n0) {
          k1 = next_key(key, k0);
          below1 = below0 + n0;
        }
      }
      const int p0 = nth_equal(key, k0, (int)(t0 - below0));
      const int p1 = t1 == t0 ? p0 : nth_equal(key, k1, (int)(t1 - below1));
      if (lane == 0) {
        const float v0 = tile[swz(p0, c)], v1 = tile[swz(p1, c)];
        if (kTrim)
          bounds[c] = make_uint4(__float_as_uint(v0), (unsigned)p0, __float_as_uint(v1),
                                 (unsigned)p1);
        else
          out[col0 + c] = 0.5f * (v0 + v1);
      }
    }
  }
  if (!kTrim) return;
  __syncthreads();
  if (tid >= ncols) return;
  // one thread per column, its live values in ascending row order
  float acc = 0.f;
  if (select) {
    // the bounds' own values: float order is the key order (-0.0 == +0.0)
    const uint4 b = bounds[tid];
    const float v0 = __uint_as_float(b.x), v1 = __uint_as_float(b.z);
#pragma unroll 4
    for (int pos = 0; pos < m; ++pos) {
      const float x = tile[swz(pos, tid)];
      const bool above = x > v0 || (x == v0 && pos >= (int)b.y);
      const bool below = x < v1 || (x == v1 && pos <= (int)b.w);
      if (above && below) acc += x;
    }
    out[col0 + tid] = acc / (float)(m - 2 * trim);
  } else {  // empty trim window: the masked mean
#pragma unroll 4
    for (int pos = 0; pos < m; ++pos) acc += tile[swz(pos, tid)];
    out[col0 + tid] = acc / (float)(m > 1 ? m : 1);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int max_k() { return kMaxSmemBytes / ((kTile + 1) * (int)sizeof(float)); }

// the plan ops.rank_geometry made, checked against the operands: the path
// K asks for; on the register path a load width that U's and the output's
// pointers and D allow, within kRegMaxValues values a thread, and no more
// blocks than column groups a thread each; on the selection path one block
// per kTile columns
bool rank_geometry_ok(const float* u, const float* out, int K, long long D, int bucket,
                      int blocks, int width) {
  if (K < 1 || K > max_k() || D < 1 || blocks < 1 || bucket != reg_bucket(K)) return false;
  if (bucket == 0) return width == 4 && blocks == ceil_div(D, kTile);
  if (width != 4 && width != 8 && width != 16) return false;
  if (bucket * (width / 4) > kRegMaxValues) return false;
  if ((D * 4) % width != 0 || blocks > ceil_div(D / (width / 4), kRankThreads)) return false;
  return reinterpret_cast<uintptr_t>(u) % width == 0 &&
         reinterpret_cast<uintptr_t>(out) % width == 0;
}

template <int KB, int W, bool kTrim>
cudaError_t launch_regs(const float* u, const unsigned char* mask, float* out, int K, long long D,
                        int trim, int blocks, cudaStream_t stream) {
  if constexpr (KB * (W / 4) > kRegMaxValues) {
    return cudaErrorInvalidValue;  // refused by rank_geometry_ok first
  } else {
    rank_regs_kernel<KB, W, kTrim><<<blocks, kRankThreads, 0, stream>>>(u, mask, out, K, D, trim);
    return cudaGetLastError();
  }
}

template <int KB, bool kTrim>
cudaError_t launch_regs_w(const float* u, const unsigned char* mask, float* out, int K,
                          long long D, int trim, int blocks, int width, cudaStream_t stream) {
  return width == 16 ? launch_regs<KB, 16, kTrim>(u, mask, out, K, D, trim, blocks, stream)
       : width == 8  ? launch_regs<KB, 8, kTrim>(u, mask, out, K, D, trim, blocks, stream)
                     : launch_regs<KB, 4, kTrim>(u, mask, out, K, D, trim, blocks, stream);
}

template <int KS, bool kTrim>
cudaError_t launch_select(const float* u, const unsigned char* mask, float* out, int K,
                          long long D, int trim, int blocks, cudaStream_t stream) {
  const size_t smem = select_smem_bytes(K);
  if (smem > (size_t)kDefaultSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        rank_select_kernel<KS, kTrim>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  rank_select_kernel<KS, kTrim><<<blocks, kRankThreads, smem, stream>>>(u, mask, out, K, D, trim);
  return cudaGetLastError();
}

template <bool kTrim>
int launch_rank(const float* u, const unsigned char* mask, float* out, int K, long long D,
                int trim, int bucket, int blocks, int width, void* stream) {
  if (!rank_geometry_ok(u, out, K, D, bucket, blocks, width)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bucket) {
    case 8: return (int)launch_regs_w<8, kTrim>(u, mask, out, K, D, trim, blocks, width, st);
    case 16: return (int)launch_regs_w<16, kTrim>(u, mask, out, K, D, trim, blocks, width, st);
    case 32: return (int)launch_regs_w<32, kTrim>(u, mask, out, K, D, trim, blocks, width, st);
    default: break;
  }
  switch (select_slots(K)) {
    case 2: return (int)launch_select<2, kTrim>(u, mask, out, K, D, trim, blocks, st);
    case 4: return (int)launch_select<4, kTrim>(u, mask, out, K, D, trim, blocks, st);
    case 8: return (int)launch_select<8, kTrim>(u, mask, out, K, D, trim, blocks, st);
    case 16: return (int)launch_select<16, kTrim>(u, mask, out, K, D, trim, blocks, st);
    case 32: return (int)launch_select<32, kTrim>(u, mask, out, K, D, trim, blocks, st);
    default: return (int)launch_select<56, kTrim>(u, mask, out, K, D, trim, blocks, st);
  }
}

}  // namespace

extern "C" {

// largest K accepted: a 32-column tile of floats with one word a row beside
// it in 227 KB (the selection path's tile, row list and bounds take no more
// from K = 264 on)
int repro_rank_max_k() { return max_k(); }

// mask: (K,) one byte per client (torch.bool's storage), nonzero = live, or
// null for every row live; the plan (bucket, blocks, width) is
// ops.rank_geometry's
int repro_coord_median(const float* u, const unsigned char* mask, float* out, int K, long long D,
                       int bucket, int blocks, int width, void* stream) {
  return launch_rank<false>(u, mask, out, K, D, 0, bucket, blocks, width, stream);
}

int repro_trimmed_mean(const float* u, const unsigned char* mask, float* out, int K, long long D,
                       int trim, int bucket, int blocks, int width, void* stream) {
  return launch_rank<true>(u, mask, out, K, D, trim, bucket, blocks, width, stream);
}

}  // extern "C"
