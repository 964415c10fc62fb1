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
// Every input is loaded to f32 and everything is computed in f32, as the TPU
// kernel does with preferred_element_type=f32.
//
// The online-softmax recurrence over key tiles is the TPU kernel's:
//   m' = max(m, rowmax(s)),  alpha = exp(m - m'),  p = exp(s - m'),
//   l' = alpha l + rowsum(p),  acc' = alpha acc + p v.
// Key 0 lies in the first tile and is visible to every row, so after it m is
// finite, and a later tile that is wholly masked for a row adds exactly 0
// (p = 0, alpha = 1).  That is why the causal loop may stop at the last tile
// any row of the block can see: the tiles it skips would add 0.
//
// What bounds it: operations.  4 D flops per visible (query, key) pair --
// 1.9e10 at smollm-135m's B = 4, L = 2048, Hq = 9, D = 64, causal: 0.29 ms at
// the H100's 67 TFLOP/s of FP32 FMA, against 0.03 ms for the bytes (each of
// q, k, v, o read or written once).  This kernel does its FMAs on the CUDA
// cores in f32; bf16 tensor cores (989 TFLOP/s) would cut the bound ~15x but
// round the products, and are the next PR's work (wgmma/TMA).
//
// Design: one CTA of 256 threads per (64-query block, batch x query head).
// The CTA stages its q tile once and each 64-key tile of k and v in shared
// memory as f32.  The threads form a 16 x 16 grid; thread (ty, tx) owns rows
// ty + 16 i (i < 4) of the block, scores keys tx + 16 j (j < 4) of a tile --
// q and k read four d at a time as float4 -- and owns D_MAX / 16 output
// columns, read from v as float4 (float2 at D_MAX = 32).  A row's max and sum
// are reduced across its 16 threads with xor shuffles inside a half warp.
// The probabilities pass through shared memory from the score layout to the
// p.v layout.  No atomics, keys in a fixed order: reruns are bit-identical.
// Blocks run from the last query block down, so the long causal rows
// start first.  D up to 128 (D_MAX 32, 64 or 128 by template; columns past D
// are zero-filled in shared memory); a larger D is refused.
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
constexpr int kThreads = 256;        // 16 x 16
constexpr int kPStride = kBK + 4;    // p tile row stride (float4-aligned rows)
constexpr float kNegInf = -1e30f;    // the TPU kernel's NEG_INF
constexpr int kDefaultSmemBytes = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// shared-memory row stride of the q and k tiles: float4-aligned, and rows of
// neighbouring keys start 4 banks apart
template <int kDMax> constexpr int kQKStride = kDMax + 4;

template <int kDMax> constexpr size_t smem_floats() {
  return (size_t)kBQ * kQKStride<kDMax>     // q tile
         + (size_t)kBK * kQKStride<kDMax>   // k tile
         + (size_t)kBK * kDMax                // v tile
         + (size_t)kBQ * kPStride;            // p tile
}

template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, int Hq, int Hkv, int Lq, int Lk, int D, int nq,
                  float scale, int causal) {
  constexpr int QS = kQKStride<kDMax>;
  constexpr int NC = kDMax / 16;            // output columns per thread
  constexpr int CW = NC < 4 ? NC : 4;       // contiguous columns per vector read
  constexpr int NG = NC / CW;               // column groups 16 CW apart
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * QS;
  float* v_s = k_s + kBK * QS;
  float* p_s = v_s + kBK * kDMax;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qb = nq - 1 - (int)(blockIdx.x % nq);   // last query block first
  const int bh = (int)(blockIdx.x / nq);
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qb * kBQ;
  const int D4 = (D + 3) & ~3;               // d rounded up to the float4 reads
  const long long q_row = (long long)Hq * D;   // stride between positions
  const long long kv_row = (long long)Hkv * D;
  const T* qg = q + ((long long)b * Lq) * q_row + (long long)h * D;
  const T* kg = k + ((long long)b * Lk) * kv_row + (long long)hk * D;
  const T* vg = v + ((long long)b * Lk) * kv_row + (long long)hk * D;

  // q tile, zero past Lq and past D
  for (int idx = tid; idx < kBQ * D4; idx += kThreads) {
    const int r = idx / D4, d = idx - r * D4;
    const int qpos = q0 + r;
    q_s[r * QS + d] = (qpos < Lq && d < D) ? to_f32(qg[qpos * q_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // keys any row of this block may see
  const int kv_end = causal ? min(Lk, min(q0 + kBQ, Lq)) : Lk;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int idx = tid; idx < kBK * D4; idx += kThreads) {
      const int r = idx / D4, d = idx - r * D4;
      const int kpos = k0 + r;
      k_s[r * QS + d] = (kpos < Lk && d < D) ? to_f32(kg[kpos * kv_row + d]) : 0.f;
    }
    for (int idx = tid; idx < kBK * kDMax; idx += kThreads) {
      const int r = idx / kDMax, d = idx - r * kDMax;
      const int kpos = k0 + r;
      v_s[idx] = (kpos < Lk && d < D) ? to_f32(vg[kpos * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // s = q k^T for rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D4; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&q_s[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale and mask, then the online-softmax update of each owned row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Lk && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p v over the tile's keys that a row can see (the rest have p = 0)
    const int kk_end = (min(kBK, kv_end - k0) + 3) & ~3;
    for (int kk = 0; kk < kk_end; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&p_s[(ty + 16 * i) * kPStride + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[NC];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float* src = &v_s[(kk + e) * kDMax + g * 16 * CW + tx * CW];
          if constexpr (CW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vv[g * CW + 0] = t.x;
            vv[g * CW + 1] = t.y;
            vv[g * CW + 2] = t.z;
            vv[g * CW + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vv[g * CW + 0] = t.x;
            vv[g * CW + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* og = o + ((long long)b * Lq) * q_row + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Lq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < CW; ++e) {
        const int col = g * 16 * CW + tx * CW + e;
        if (col < D) og[qpos * q_row + col] = from_f32<T>(acc[i][g * CW + e] * inv_l);
      }
  }
}

template <typename T, int kDMax>
int launch_flash_attn(const void* q, const void* k, const void* v, void* o, int B, int Lq, int Lk,
                      int Hq, int Hkv, int D, float scale, int causal, void* stream) {
  const size_t smem = smem_floats<kDMax>() * sizeof(float);
  if (smem > (size_t)kDefaultSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<T, kDMax>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nq = (Lq + kBQ - 1) / kBQ;
  const long long blocks = (long long)nq * B * Hq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attn_kernel<T, kDMax><<<(unsigned)blocks, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Lq, Lk, D, nq, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int Lq, int Lk,
               int Hq, int Hkv, int D, float scale, int causal, void* stream) {
  if (D <= 32)
    return launch_flash_attn<T, 32>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, stream);
  if (D <= 64)
    return launch_flash_attn<T, 64>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, stream);
  return launch_flash_attn<T, 128>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, stream);
}

}  // namespace

extern "C" {

// largest head dimension the kernel takes
int repro_flash_attn_max_d() { return 128; }

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and o all of it)
int repro_flash_attn(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                     int Lq, int Lk, int Hq, int Hkv, int D, float scale, int causal,
                     void* stream) {
  if (D < 1 || D > 128 || Lk < 1 || Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (B < 1 || Lq < 1) return (int)cudaGetLastError();  // nothing to compute
  switch (dtype) {
    case 0:
      return dispatch_d<float>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, stream);
    case 1:
      return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, stream);
    case 2:
      return dispatch_d<__half>(q, k, v, o, B, Lq, Lk, Hq, Hkv, D, scale, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
