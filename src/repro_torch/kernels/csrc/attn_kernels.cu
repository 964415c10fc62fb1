// Hand-written Hopper (sm_90a) flash attention, forward only.
//
//   repro_flash_attn  <- src/repro/kernels/flash_attn.py  flash_attention_bh / _flash_attn_kernel
//                        (through src/repro/kernels/ops.py flash_attention)
//
// Computes, for q (B, Lq, Hq, D) and k, v (B, Lk, Hkv, D) in one float type,
//
//   o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / G],  s_ij = (q_i . k_j) / sqrt(D)
//
// with G = Hq / Hkv (query head h reads kv head h / G, which is what the JAX
// wrapper's jnp.repeat(k, G, axis=2) gives; nothing is copied here).  The
// mask is the TPU kernel's: key j is visible when j < Lk and, causal, when
// j <= i, aligned top-left (flash_attn.py:57; the JAX oracle ref.py:50 aligns
// bottom-right, and the two agree only when Lq == Lk).  A masked score is
// -1e30, not -inf, and the output is acc / max(l, 1e-30), cast to q's type.
//
// The online-softmax recurrence over key tiles is the TPU kernel's:
//   m' = max(m, rowmax(s)),  alpha = exp(m - m'),  p = exp(s - m'),
//   l' = alpha l + rowsum(p),  acc' = alpha acc + p v.
// Key 0 lies in the first tile and is visible to every row, so after it m is
// finite, and a later tile that is wholly masked for a row adds exactly 0
// (p = 0, alpha = 1).  That is why the causal loop may stop at the last tile
// any row of the block can see: the tiles it skips would add 0.  Blocks run
// from the last query block down, so the long causal rows start first.  No
// atomics, keys in a fixed order: reruns are bit-identical.  D up to 128; a
// larger D is refused.
//
// Two kernels, by dtype (repro_flash_attn's dtype argument), both on the
// tensor cores with warp-level mma.sync and one skeleton, the bf16 kernel's:
//
// * flash_attn_tc_kernel, bf16 (dtype 1) and f16 (dtype 2): tensor cores,
//   warp-level mma.sync.aligned.m16n8k16 with f32 accumulators (the
//   FlashAttention-2 layout).  S = q k^T is the TPU kernel's f32 dot of the
//   upcast inputs up to summation order (a product of two bf16 or f16 values
//   is exact in f32).  Mask, m, l and alpha are f32 in registers; the scale
//   and log2(e) fold into one FFMA before ex2.approx (MUFU.EX2, denormals
//   flushed), so p = 2^(s c - m c) with c = log2(e) / sqrt(D).  P is rounded to the input type
//   before P.V -- the one place the arithmetic leaves the TPU kernel's -- and
//   l is summed from the unrounded f32 p.  ref.flash_attention_tc_ref is the
//   twin of exactly this arithmetic.
//   Bound: at D = 64 the exponentials cost as much as the products.  Tensor
//   cores: 4 D operations per visible pair, 1.93e10 at the smollm shape,
//   0.0196 ms at 989 TFLOP/s dense bf16; exponentials: one per visible pair,
//   7.55e7, 0.0195 ms at 16 MUFU.EX2 per SM per clock (132 SMs, 1.83 GHz);
//   bytes under 0.01 ms.  The bound is the larger of the two operation terms.
//   mma.sync does not reach wgmma's rate on Hopper; a wgmma + TMA + warp-
//   specialised kernel is the headroom this design leaves.
//   Design: one CTA of 4 warps per (64-query block, batch x query head); warp
//   w owns query rows 16 w .. 16 w + 15 of the block.  Key tiles of kBK = 64.
//   D is padded with zeros to kDPad in {32, 64, 128}, a multiple of the k16
//   step.  Shared memory holds the q tile once and two buffers each of the k
//   and v tiles (tile j + 1 is in flight while tile j is computed), rows
//   padded by 8 elements so that the 8 row addresses of an ldmatrix fall in
//   8 distinct 4-bank groups; 46 KB at kDPad = 64, 87 KB at 128 (opt-in above
//   48 KB).  Loads are cp.async.cg 16-byte copies with commit/wait groups; a
//   row past L or a chunk past D uses the zero-filling form (src-size 0), so
//   v rows past Lk are zeros (p = 0 times stale data could make NaN).  Where
//   a 16-byte copy is not possible (D % 8 != 0, or a pointer not 16-byte
//   aligned) the wrapper clears a flag and the same kernel loads element by
//   element.  The q fragments come from one ldmatrix.x4 per k16 step and stay
//   in registers for the whole key loop; k fragments from ldmatrix (k's rows
//   are the n dimension).  Each thread holds two rows of S (groupID and
//   groupID + 8); their max is reduced over the quad with two xor shuffles,
//   their sums are kept per thread and reduced once at the end.  The mask is
//   applied only on a tile that crosses the warp's diagonal or Lk.  P stays
//   in registers: the f32 C fragments of two adjacent n8 tiles of S, packed
//   to pairs of T, are the A fragment of one k16 step of P.V, whose v
//   fragments come from ldmatrix.trans.  O is accumulated in f32, kDPad / 2
//   registers a thread.  The epilogue stages each warp's rows of T in its own
//   rows of the q tile and stores them 16 bytes at a time where aligned.
//
// * flash_attn_tf32x3_kernel, f32 (dtype 0): 3xTF32 on
//   mma.sync.aligned.m16n8k8 (TF32 operands, f32 accumulators), which keeps
//   the TPU kernel's f32 accuracy.  Each operand of both products splits as
//   x = hi + lo with hi = tf32(x), lo = tf32(x - hi) (to nearest, ties away,
//   as cvt.rna rounds, in two integer operations where cvt.rna.tf32.f32
//   costs several), and a b ~ lo hi' + hi lo' + hi hi', the small terms first:
//   products of 11-bit significands are exact, the dropped lo lo' is 2^-22
//   relative.  The tensor cores' f32 accumulation, which is not round-to-
//   nearest, only sums one stage into a zeroed tile: S over 64 d columns (at
//   D = 128 two such stages, joined by FADD), and P.V over one 64-key tile,
//   which then enters acc = acc alpha + pv in f32, the TPU kernel's
//   recurrence.  Mask, m, l, alpha and the folded ex2 are the bf16 kernel's.
//   ref.flash_attention_3xtf32_ref is the twin of this arithmetic; it reads
//   as close to exact attention as the f32 twin does, while 1xTF32 or a
//   dropped lo-term product reads ~1e-4 of max |v| from it.
//   Bound: operations, 3 x 4 D TF32 operations per visible pair, 5.8e10 at
//   the smollm shape: 0.117 ms at 495 TFLOP/s dense TF32, against 0.0195 ms
//   of exponentials and 0.015 ms of bytes.  mma.sync issues TF32 at about
//   half that rate (the dense peak needs wgmma), and the three products at
//   that rate are about half the kernel's time on an H100; the splits and
//   the softmax take most of the rest (PERF.md, tools/attn_sweep.py).
//   Where the design departs from the bf16 kernel's: tiles are f32 in shared
//   memory, and fragments come from LDS, not ldmatrix (which moves 16-bit
//   elements).  The two k8 steps of a 16-column chunk c read k index t as d
//   columns 16 c + 4 t and + 2, and t + 4 as + 1 and + 3, the same map for q
//   (A) and k (B), so one LDS.128 per row feeds both steps; q and k rows are
//   kDPad + 16 floats apart (16 mod 32: a quarter warp's LDS.128 hits every
//   bank once).  Each product runs as passes over all its n8 tiles (lo hi'
//   for every tile, then hi lo', then hi hi'), so consecutive mmas are
//   independent.  P needs no shuffle: key 2t of an n8 tile of S read as k
//   index t and key 2t + 1 as t + 4 make its C fragment the A fragment of
//   one k8 step of P.V.  v's B fragment is then rows 2t and 2t + 1, read as
//   float2 at columns 16 j + 2g: column 16 j + 2g + e is n index g of O's
//   d-tile 2j + e (v rows kDPad + 4 floats apart, so a half warp's LDS.64
//   hits every bank once), and each lane ends up holding four adjacent
//   output columns of its two rows, stored as one float4 each.  At
//   kDPad <= 64 q is staged once in k buffer 1 and held in registers as f32
//   (74 KB of shared memory and up to 255 registers at kDPad = 64: two CTAs
//   an SM; at three, 168 registers spill); at 128 it has its own tile and is
//   read again for every key tile (174 KB, one CTA).
//   Every warp splits the k and v values it reads itself.  Loads as in the
//   bf16 kernel: 16-byte cp.async copies where D % 4 == 0 and every pointer
//   is 16-byte aligned, else element by element.
//
// The C interface is plain (loaded with ctypes): it launches on the stream it
// is given, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;              // query rows per CTA
constexpr int kBK = 64;              // keys per tile
constexpr float kNegInf = -1e30f;    // the TPU kernel's NEG_INF
constexpr int kDefaultSmemBytes = 48 * 1024;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// ---------------------------------------------------------------------------
// bf16 / f16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;                 // 16 query rows each
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcPad = 8;                   // elements added to each shared row
constexpr float kLog2e = 1.4426950408889634f;

// shared row stride (elements) of the q, k and v tiles: 16-byte rows whose
// starts fall 4 banks apart, so the 8 row reads of an ldmatrix never collide
template <int kDPad> constexpr int kTcStride = kDPad + kTcPad;

// CTAs an SM holds: 4 at kDPad <= 64 (46 KB of shared memory and <= 128
// registers a thread each), 2 at kDPad = 128 (87 KB)
template <int kDPad> constexpr int kTcMinBlocks = kDPad <= 64 ? 4 : 2;

template <int kDPad> constexpr size_t tc_smem_bytes() {
  return (size_t)(kBQ + 4 * kBK) * kTcStride<kDPad> * 2;   // q, k x 2, v x 2
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lanes 8 i .. 8 i + 7 give the row addresses of
// matrix i, and lane l receives, in register i, row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1 of matrix i (of its transpose with .trans)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), d 16 x 8 f32.  Lane l, with
// g = l / 4 and t = l % 4, holds a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}, b = {(2t.., g), (2t + 8.., g)} and d = {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}; each a and b register is a pair
// of b16 values, the lower column (row of b) in the low half.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to a pair of T, lo in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x on the SFU (MUFU.EX2), denormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + kRows - 1 of one head (row stride `stride` elements) into a
// shared kRows x kDPad tile of row stride S, zero past L and past D: 16-byte
// cp.async copies (zero-filling ones past the edge) when `vec`, else element
// by element
template <typename T, int kDPad, int kRows, int S = kTcStride<kDPad>>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int r0, int L,
                                          int D, int vec, int tid) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);   // elements a copy
    constexpr int CH = kDPad / E;
    for (int idx = tid; idx < kRows * CH; idx += kTcThreads) {
      const int r = idx / CH, c = (idx - r * CH) * E;
      const int pos = r0 + r;
      const bool in = pos < L && c < D;
      cp_async16(smem_addr(dst + r * S + c), in ? src + pos * stride + c : src, in ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < kRows * kDPad; idx += kTcThreads) {
      const int r = idx / kDPad, c = idx - r * kDPad;
      const int pos = r0 + r;
      dst[r * S + c] = (pos < L && c < D) ? src[pos * stride + c] : from_f32<T>(0.f);
    }
  }
}

template <typename T, int kDPad>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks<kDPad>)
flash_attn_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int Hq, int Hkv, int Lq, int Lk, int D, int nq,
                     float scale_log2, int causal, int vec) {
  constexpr int S = kTcStride<kDPad>;
  constexpr int KS = kDPad / 16;            // k16 steps of q k^T
  constexpr int NT = kBK / 8;               // n8 tiles of keys in S
  constexpr int DT = kDPad / 8;             // n8 tiles of d in O
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* q_s = reinterpret_cast<T*>(tc_smem);
  T* k_s = q_s + kBQ * S;                   // two buffers of kBK rows
  T* v_s = k_s + 2 * kBK * S;               // two buffers of kBK rows

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qb = nq - 1 - (int)(blockIdx.x % nq);   // last query block first
  const int bh = (int)(blockIdx.x / nq);
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qb * kBQ;
  const long long q_row = (long long)Hq * D;   // stride between positions
  const long long kv_row = (long long)Hkv * D;
  const T* qg = q + ((long long)b * Lq) * q_row + (long long)h * D;
  const T* kg = k + ((long long)b * Lk) * kv_row + (long long)hk * D;
  const T* vg = v + ((long long)b * Lk) * kv_row + (long long)hk * D;

  // keys any row of this block may see
  const int kv_end = causal ? min(Lk, min(q0 + kBQ, Lq)) : Lk;
  const int ntiles = (kv_end + kBK - 1) / kBK;

  load_tile<T, kDPad, kBQ>(q_s, qg, q_row, q0, Lq, D, vec, tid);
  load_tile<T, kDPad, kBK>(k_s, kg, kv_row, 0, Lk, D, vec, tid);
  load_tile<T, kDPad, kBK>(v_s, vg, kv_row, 0, Lk, D, vec, tid);
  cp_async_commit();

  // each lane's ldmatrix row and column (matrix i = lane / 8):
  // q (A): matrices (rows lo, d lo), (rows hi, d lo), (rows lo, d hi), (rows hi, d hi)
  const int qa_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int qa_col = (lane >> 4) * 8;
  // k (B of q k^T): (n-tile j, d lo), (j, d hi), (j + 1, d lo), (j + 1, d hi)
  const int kb_row = (lane & 7) + (lane >> 4) * 8;
  const int kb_col = ((lane >> 3) & 1) * 8;
  // v (B of p v, transposed): (keys lo, d-tile n), (keys hi, n), (lo, n + 1), (hi, n + 1)
  const int vb_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vb_col = (lane >> 4) * 8;

  const int row0 = q0 + warp * 16 + g;       // this thread's two rows of the block
  const int row1 = row0 + 8;
  uint32_t qf[KS][4];
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;   // running max of the unscaled scores, quad-uniform
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the running sums

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kBK;
    const int buf = j & 1;
    if (j + 1 < ntiles) {   // tile j + 1 into the other buffer, freed by the last sync
      load_tile<T, kDPad, kBK>(k_s + (buf ^ 1) * kBK * S, kg, kv_row, k0 + kBK, Lk, D, vec, tid);
      load_tile<T, kDPad, kBK>(v_s + (buf ^ 1) * kBK * S, vg, kv_row, k0 + kBK, Lk, D, vec, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], smem_addr(q_s + qa_row * S + ks * 16 + qa_col));
    }
    const T* kt = k_s + buf * kBK * S;
    const T* vt = v_s + buf * kBK * S;

    // s = q k^T: 16 rows x 64 keys per warp
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_addr(kt + (n * 8 + kb_row) * S + ks * 16 + kb_col));
        mma16816<T>(s[n], qf[ks], kf[0], kf[1]);
        mma16816<T>(s[n + 1], qf[ks], kf[2], kf[3]);
      }

    // on a tile crossing Lk or this warp's diagonal, mask; then the online
    // softmax with the scale and log2(e) folded into one FFMA before ex2:
    // p = 2^(s c - m c) = e^(s / sqrt(D) - m / sqrt(D)), c = log2(e) / sqrt(D)
    const bool masked = k0 + kBK > Lk || (causal && k0 + kBK - 1 > q0 + warp * 16);
    if (masked) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + n * 8 + 2 * t + e;
          if (kpos >= Lk || (causal && kpos > row0)) s[n][e] = kNegInf;
          if (kpos >= Lk || (causal && kpos > row1)) s[n][2 + e] = kNegInf;
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float al0 = ex2((m0 - mx0) * scale_log2), al1 = ex2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float mc0 = mx0 * scale_log2, mc1 = mx1 * scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = ex2(fmaf(s[n][e], scale_log2, -mc0));
        s[n][2 + e] = ex2(fmaf(s[n][2 + e], scale_log2, -mc1));
        sum0 += s[n][e];
        sum1 += s[n][2 + e];
      }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // acc += P v: the C fragments of n-tiles 2 kk and 2 kk + 1, rounded to
    // T, are the A fragment of k16 step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, smem_addr(vt + (kk * 16 + vb_row) * S + n * 8 + vb_col));
        mma16816<T>(acc[n], pa, vf[0], vf[1]);
        mma16816<T>(acc[n + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();   // buffer buf is free for tile j + 2
  }

  // the quad's shares of l, then acc / max(l, 1e-30) as T into this warp's
  // own rows of the q tile, then out to o
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  T* o_s = q_s + warp * 16 * S;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(o_s + g * S + c) = pack2<T>(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(o_s + (g + 8) * S + c) =
        pack2<T>(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  __syncwarp();
  T* og = o + ((long long)b * Lq) * q_row + (long long)h * D;
  const int r_base = q0 + warp * 16;
  if (vec) {
    constexpr int CH = kDPad / 8;
    for (int idx = lane; idx < 16 * CH; idx += 32) {
      const int r = idx / CH, c = (idx - r * CH) * 8;
      if (r_base + r < Lq && c < D)
        *reinterpret_cast<uint4*>(og + (r_base + r) * q_row + c) =
            *reinterpret_cast<const uint4*>(o_s + r * S + c);
    }
  } else {
    for (int idx = lane; idx < 16 * D; idx += 32) {
      const int r = idx / D, c = idx - r * D;
      if (r_base + r < Lq) og[(r_base + r) * q_row + c] = o_s[r * S + c];
    }
  }
}

template <typename T, int kDPad>
int launch_flash_attn_tc(const void* q, const void* k, const void* v, void* o, int B, int Lq,
                         int Lk, int Hq, int Hkv, int D, float scale, int causal, int vec,
                         void* stream) {
  const size_t smem = tc_smem_bytes<kDPad>();
  if (smem > (size_t)kDefaultSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_tc_kernel<T, kDPad>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nq = (Lq + kBQ - 1) / kBQ;
  const long long blocks = (long long)nq * B * Hq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attn_tc_kernel<T, kDPad><<<(unsigned)blocks, kTcThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Lq, Lk, D, nq, scale * kLog2e, causal, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_tc(const void* q, const void* k, const void* v, void* o, int B, int Lq, int Lk,
                int Hq, int Hkv, int D, float scale, int causal, int vec, void* stream) {
  if (vec && ((D & 7) || (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)))
    return (int)cudaErrorMisalignedAddress;   // the flag promised 16-byte copies
  if (D <= 32)
    return launch_flash_attn_tc<T, 32>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, vec,
                                       stream);
  if (D <= 64)
    return launch_flash_attn_tc<T, 64>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, vec,
                                       stream);
  return launch_flash_attn_tc<T, 128>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, vec,
                                      stream);
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores: 3xTF32
// ---------------------------------------------------------------------------

// shared row strides (floats): q and k rows 16 mod 32 apart (LDS.128
// fragment reads), v rows 4 mod 16 apart (LDS.64 fragment reads)
template <int kDPad> constexpr int kTfKStride = kDPad + 16;
template <int kDPad> constexpr int kTfVStride = kDPad + 4;
// q held in registers for the whole key loop (staged in k buffer 1), or
// read again from its own tile for every key tile
template <int kDPad> constexpr bool kTfQInRegs = kDPad <= 64;
// CTAs an SM: registers set it at kDPad <= 64 (three CTAs' 168 a thread
// spill), shared memory at 128 (174 KB)
template <int kDPad> constexpr int kTfMinBlocks = kDPad <= 64 ? 2 : 1;

template <int kDPad> constexpr size_t tf_smem_bytes() {
  return ((kTfQInRegs<kDPad> ? 0 : (size_t)kBQ * kTfKStride<kDPad>)
          + (size_t)2 * kBK * (kTfKStride<kDPad> + kTfVStride<kDPad>)) * sizeof(float);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest, ties
// away from zero), in two integer operations: half a TF32 ulp added to the
// magnitude bits, the low 13 bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (hi, lo), both TF32 bit patterns: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b: a 16 x 8 (row), b 8 x 8 (col), d 16 x 8 f32, TF32 operands.
// Lane l, with g = l / 4 and t = l % 4, holds a = {(g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4)}, b = {(t, g), (t + 4, g)} and d = {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kDPad>
__global__ void __launch_bounds__(kTcThreads, kTfMinBlocks<kDPad>)
flash_attn_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int Hq, int Hkv,
                         int Lq, int Lk, int D, int nq, float scale_log2, int causal, int vec) {
  constexpr int KS = kTfKStride<kDPad>;
  constexpr int VS = kTfVStride<kDPad>;
  constexpr int NC = kDPad / 16;            // 16-column chunks of d: two k8 steps each
  constexpr int NST = (kDPad + 63) / 64;    // 64-column stages of q k^T
  constexpr int CPS = NC / NST;             // chunks per stage
  constexpr int NT = kBK / 8;               // n8 tiles of keys in S = k8 steps of P.V
  constexpr int DT = kDPad / 8;             // n8 tiles of d in O
  constexpr bool QREGS = kTfQInRegs<kDPad>;
  extern __shared__ __align__(16) float tf_smem[];
  float* k_s = tf_smem;                     // two buffers of kBK rows
  float* v_s = k_s + 2 * kBK * KS;          // two buffers of kBK rows
  float* q_s = QREGS ? k_s + kBK * KS : v_s + 2 * kBK * VS;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qb = nq - 1 - (int)(blockIdx.x % nq);   // last query block first
  const int bh = (int)(blockIdx.x / nq);
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qb * kBQ;
  const long long q_row = (long long)Hq * D;   // stride between positions
  const long long kv_row = (long long)Hkv * D;
  const float* qg = q + ((long long)b * Lq) * q_row + (long long)h * D;
  const float* kg = k + ((long long)b * Lk) * kv_row + (long long)hk * D;
  const float* vg = v + ((long long)b * Lk) * kv_row + (long long)hk * D;

  // keys any row of this block may see
  const int kv_end = causal ? min(Lk, min(q0 + kBQ, Lq)) : Lk;
  const int ntiles = (kv_end + kBK - 1) / kBK;

  load_tile<float, kDPad, kBQ, KS>(q_s, qg, q_row, q0, Lq, D, vec, tid);
  load_tile<float, kDPad, kBK, KS>(k_s, kg, kv_row, 0, Lk, D, vec, tid);
  load_tile<float, kDPad, kBK, VS>(v_s, vg, kv_row, 0, Lk, D, vec, tid);
  cp_async_commit();

  // this lane's q row g of the warp's 16 (row g + 8 is 8 KS further), at its
  // 4 columns 16 c + 4 t of chunk c; k rows 8 n + g at the same columns
  const float* qw = q_s + (warp * 16 + g) * KS + 4 * t;
  float4 qr[QREGS ? NC : 1][2];
  if constexpr (QREGS) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      qr[c][0] = *reinterpret_cast<const float4*>(qw + 16 * c);
      qr[c][1] = *reinterpret_cast<const float4*>(qw + 8 * KS + 16 * c);
    }
    __syncthreads();   // k buffer 1 is free for tile 1
  }

  const int row0 = q0 + warp * 16 + g;       // this thread's two rows of the block
  const int row1 = row0 + 8;
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;   // running max of the unscaled scores, quad-uniform
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the running sums

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kBK;
    const int buf = j & 1;
    if (j + 1 < ntiles) {   // tile j + 1 into the other buffer, freed by the last sync
      load_tile<float, kDPad, kBK, KS>(k_s + (buf ^ 1) * kBK * KS, kg, kv_row, k0 + kBK, Lk, D,
                                    vec, tid);
      load_tile<float, kDPad, kBK, VS>(v_s + (buf ^ 1) * kBK * VS, vg, kv_row, k0 + kBK, Lk, D,
                                    vec, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = k_s + buf * kBK * KS + g * KS + 4 * t;
    const float* vt = v_s + buf * kBK * VS + 2 * t * VS + 2 * g;

    // s = q k^T, 16 rows x 64 keys per warp, one zeroed tile per stage
    float s[NT][4];
#pragma unroll
    for (int st = 0; st < NST; ++st) {
      float part[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPS; ++cc) {
        const int c = st * CPS + cc;
        float4 x0, x1;   // rows g and g + 8
        if constexpr (QREGS) {
          x0 = qr[c][0];
          x1 = qr[c][1];
        } else {
          x0 = *reinterpret_cast<const float4*>(qw + 16 * c);
          x1 = *reinterpret_cast<const float4*>(qw + 8 * KS + 16 * c);
        }
        // step 0: k = t is column + 0, k = t + 4 is + 1; step 1: + 2 and + 3
        uint32_t ah[2][4], al[2][4], kh[NT][4], kl[NT][4];
        split_tf32(x0.x, ah[0][0], al[0][0]);
        split_tf32(x1.x, ah[0][1], al[0][1]);
        split_tf32(x0.y, ah[0][2], al[0][2]);
        split_tf32(x1.y, ah[0][3], al[0][3]);
        split_tf32(x0.z, ah[1][0], al[1][0]);
        split_tf32(x1.z, ah[1][1], al[1][1]);
        split_tf32(x0.w, ah[1][2], al[1][2]);
        split_tf32(x1.w, ah[1][3], al[1][3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float4 y = *reinterpret_cast<const float4*>(kt + 8 * n * KS + 16 * c);
          split_tf32(y.x, kh[n][0], kl[n][0]);
          split_tf32(y.y, kh[n][1], kl[n][1]);
          split_tf32(y.z, kh[n][2], kl[n][2]);
          split_tf32(y.w, kh[n][3], kl[n][3]);
        }
        // the lo-term products of both steps, then hi hi' of both; each
        // pass runs over the NT tiles, so consecutive mmas are independent
#pragma unroll
        for (int n = 0; n < NT; ++n) mma1688(part[n], al[0], kh[n][0], kh[n][1]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma1688(part[n], ah[0], kl[n][0], kl[n][1]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma1688(part[n], al[1], kh[n][2], kh[n][3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma1688(part[n], ah[1], kl[n][2], kl[n][3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma1688(part[n], ah[0], kh[n][0], kh[n][1]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma1688(part[n], ah[1], kh[n][2], kh[n][3]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = st == 0 ? part[n][e] : __fadd_rn(s[n][e], part[n][e]);
    }

    // mask and online softmax, as in flash_attn_tc_kernel
    const bool masked = k0 + kBK > Lk || (causal && k0 + kBK - 1 > q0 + warp * 16);
    if (masked) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + n * 8 + 2 * t + e;
          if (kpos >= Lk || (causal && kpos > row0)) s[n][e] = kNegInf;
          if (kpos >= Lk || (causal && kpos > row1)) s[n][2 + e] = kNegInf;
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float al0 = ex2((m0 - mx0) * scale_log2), al1 = ex2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float mc0 = mx0 * scale_log2, mc1 = mx1 * scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = ex2(fmaf(s[n][e], scale_log2, -mc0));
        s[n][2 + e] = ex2(fmaf(s[n][2 + e], scale_log2, -mc1));
        sum0 += s[n][e];
        sum1 += s[n][2 + e];
      }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;

    // pv = P v over this tile into a zeroed tile: n8 tile n of S (keys
    // 8 n + 2t as k = t, 8 n + 2t + 1 as k = t + 4) is the A fragment of k8
    // step n; v rows 8 n + 2t and + 1, columns 16 jj + 2g (d-tile 2 jj) and
    // + 1 (d-tile 2 jj + 1); lo hi', hi lo', hi hi', each over all d-tiles
    float pv[DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t ph[4], pl[4];
      split_tf32(s[n][0], ph[0], pl[0]);
      split_tf32(s[n][2], ph[1], pl[1]);
      split_tf32(s[n][1], ph[2], pl[2]);
      split_tf32(s[n][3], ph[3], pl[3]);
      const float* vr = vt + 8 * n * VS;
      uint32_t vh[DT][2], vl[DT][2];
#pragma unroll
      for (int jj = 0; jj < DT / 2; ++jj) {
        const float2 y0 = *reinterpret_cast<const float2*>(vr + 16 * jj);
        const float2 y1 = *reinterpret_cast<const float2*>(vr + VS + 16 * jj);
        split_tf32(y0.x, vh[2 * jj][0], vl[2 * jj][0]);
        split_tf32(y1.x, vh[2 * jj][1], vl[2 * jj][1]);
        split_tf32(y0.y, vh[2 * jj + 1][0], vl[2 * jj + 1][0]);
        split_tf32(y1.y, vh[2 * jj + 1][1], vl[2 * jj + 1][1]);
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) mma1688(pv[d], pl, vh[d][0], vh[d][1]);
#pragma unroll
      for (int d = 0; d < DT; ++d) mma1688(pv[d], ph, vl[d][0], vl[d][1]);
#pragma unroll
      for (int d = 0; d < DT; ++d) mma1688(pv[d], ph, vh[d][0], vh[d][1]);
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] = fmaf(acc[n][0], al0, pv[n][0]);
      acc[n][1] = fmaf(acc[n][1], al0, pv[n][1]);
      acc[n][2] = fmaf(acc[n][2], al1, pv[n][2]);
      acc[n][3] = fmaf(acc[n][3], al1, pv[n][3]);
    }
    __syncthreads();   // buffer buf is free for tile j + 2
  }

  // the quad's shares of l, then acc / max(l, 1e-30): this lane holds
  // columns 16 jj + 4t .. + 3 of its two rows, (d-tile 2 jj, 2 jj + 1) x
  // (n index 2t, 2t + 1)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  float* og = o + ((long long)b * Lq) * q_row + (long long)h * D;
#pragma unroll
  for (int jj = 0; jj < DT / 2; ++jj) {
    const int c = 16 * jj + 4 * t;
    const float r0[4] = {acc[2 * jj][0] * inv0, acc[2 * jj + 1][0] * inv0,
                         acc[2 * jj][1] * inv0, acc[2 * jj + 1][1] * inv0};
    const float r1[4] = {acc[2 * jj][2] * inv1, acc[2 * jj + 1][2] * inv1,
                         acc[2 * jj][3] * inv1, acc[2 * jj + 1][3] * inv1};
    if (vec) {
      if (c < D) {
        if (row0 < Lq)
          *reinterpret_cast<float4*>(og + row0 * q_row + c) =
              make_float4(r0[0], r0[1], r0[2], r0[3]);
        if (row1 < Lq)
          *reinterpret_cast<float4*>(og + row1 * q_row + c) =
              make_float4(r1[0], r1[1], r1[2], r1[3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e >= D) break;
        if (row0 < Lq) og[row0 * q_row + c + e] = r0[e];
        if (row1 < Lq) og[row1 * q_row + c + e] = r1[e];
      }
    }
  }
}

template <int kDPad>
int launch_flash_attn_tf32x3(const void* q, const void* k, const void* v, void* o, int B, int Lq,
                             int Lk, int Hq, int Hkv, int D, float scale, int causal, int vec,
                             void* stream) {
  const size_t smem = tf_smem_bytes<kDPad>();
  if (smem > (size_t)kDefaultSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_tf32x3_kernel<kDPad>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nq = (Lq + kBQ - 1) / kBQ;
  const long long blocks = (long long)nq * B * Hq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attn_tf32x3_kernel<kDPad><<<(unsigned)blocks, kTcThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Hq, Hkv, Lq, Lk, D, nq, scale * kLog2e, causal, vec);
  return (int)cudaGetLastError();
}

int dispatch_tf32x3(const void* q, const void* k, const void* v, void* o, int B, int Lq, int Lk,
                    int Hq, int Hkv, int D, float scale, int causal, int vec, void* stream) {
  if (vec && ((D & 3) || (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)))
    return (int)cudaErrorMisalignedAddress;   // the flag promised 16-byte copies
  if (D <= 32)
    return launch_flash_attn_tf32x3<32>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, vec,
                                        stream);
  if (D <= 64)
    return launch_flash_attn_tf32x3<64>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, vec,
                                        stream);
  return launch_flash_attn_tf32x3<128>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, vec,
                                       stream);
}

}  // namespace

extern "C" {

// largest head dimension the kernel takes
int repro_flash_attn_max_d() { return 128; }

// dtype: 0 float32 (3xTF32), 1 bfloat16, 2 float16, all on the tensor cores;
// q, k, v and o all of it.  flags: bit 0 causal; bit 1 the caller found D a
// multiple of the elements in 16 bytes (4 in f32, 8 in bf16/f16) and every
// pointer 16-byte aligned, so tiles load by 16-byte cp.async copies (else
// element by element)
int repro_flash_attn(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                     int Lq, int Lk, int Hq, int Hkv, int D, float scale, int flags,
                     void* stream) {
  if (D < 1 || D > 128 || Lk < 1 || Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (B < 1 || Lq < 1) return (int)cudaGetLastError();  // nothing to compute
  const int causal = flags & 1, vec = (flags >> 1) & 1;
  switch (dtype) {
    case 0:
      return dispatch_tf32x3(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, vec, stream);
    case 1:
      return dispatch_tc<__nv_bfloat16>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, vec,
                                        stream);
    case 2:
      return dispatch_tc<__half>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
