// Device code shared by the two one-token decode-attention kernels
// (paged_flash_decode.cu, flash_decode.cu): widening of KV rows to f32, warp
// reductions, and the block-wide online-softmax loop over spans of
// contiguous KV positions. The kernels differ only in where span p of a
// sequence lies (a page through the block table, or a chunk of the dense
// cache), which each passes in as a functor.
//
// One block serves one (sequence b, KV head h) with blockDim = D threads:
//   * scores: one thread per span position reads its key row in 16-byte
//     loads and widens fp8 e4m3 (or bf16, f32) to f32 in registers, times
//     kv_scale, against q held in shared memory (read as broadcasts);
//   * online softmax in f32 for the G query heads that share the KV head, the
//     running max starting at -inf; every span processed holds at least one
//     live position, so the max is finite after the first span and
//     exp(-inf - -inf) is never formed;
//   * only positions < len are read: a masked position is never read and
//     never multiplied, so a NaN or stale value past the live context cannot
//     reach the output (0 · NaN is never formed);
//   * the output accumulates per thread (one head dim each), eight positions
//     per unrolled step so their value loads are in flight together, and is
//     written in f32. A sequence with len <= 0 gets 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode {

constexpr int MAXG = 8;  // query heads per KV head held in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

// One 16-byte chunk of a KV row (N elements, little-endian) widened to f32.
template <typename TKV>
struct Row16;
template <>
struct Row16<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& r, float* o) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
};
template <>
struct Row16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& r, float* o) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Row16<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  __device__ static void widen(const uint4& r, float* o) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        __nv_fp8_e4m3 v;
        v.__x = static_cast<__nv_fp8_storage_t>((w[i] >> (8 * j)) & 0xffu);
        o[4 * i + j] = static_cast<float>(v);
      }
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dynamic shared memory one block needs: q [G][D], scores [G][span], and the
// running max, rescale and denominator [G] each.
inline size_t smem_bytes(int G, int D, int span) {
  return sizeof(float) * (G * D + G * span + 3 * G);
}

// One block's decode: q_head (G, D) and out_head (G, D) of this (b, h); the
// sequence's len live positions lie in spans of `span` rows of D elements,
// span p starting at element span_base(p) of k and v. KV rows must be 16-byte
// aligned (D a multiple of 32 elements of at most 4 bytes does that, given an
// aligned base).
template <typename TQ, typename TKV, typename SpanBase>
__device__ __forceinline__ void decode_block(const TQ* __restrict__ q_head,
                                             const TKV* __restrict__ k,
                                             const TKV* __restrict__ v, int len, int span,
                                             const SpanBase& span_base,
                                             float* __restrict__ out_head, int G, int D,
                                             float scale, float kv_scale) {
  extern __shared__ float sm[];
  float* qs = sm;                // [G][D]
  float* sc = qs + G * D;        // [G][span] scores, then probabilities
  float* m_s = sc + G * span;    // [G] running max
  float* corr_s = m_s + G;       // [G] rescale of the previous spans
  float* d_s = corr_s + G;       // [G] running denominator

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  if (len <= 0) {
    for (int i = tid; i < G * D; i += blockDim.x) out_head[i] = 0.f;
    return;
  }
  for (int i = tid; i < G * D; i += blockDim.x) qs[i] = to_f32(q_head[i]);
  if (tid < G) {
    m_s[tid] = -INFINITY;
    d_s[tid] = 0.f;
  }
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
  const int n_spans = (len + span - 1) / span;
  __syncthreads();

  for (int p = 0; p < n_spans; ++p) {
    const int valid = min(span, len - p * span);
    const size_t base = span_base(p);

    constexpr int N = Row16<TKV>::N;
    for (int t = tid; t < valid; t += blockDim.x) {
      const uint4* kr = reinterpret_cast<const uint4*>(k + base + (size_t)t * D);
      float part[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) part[g] = 0.f;
#pragma unroll 2
      for (int c = 0; c < D / N; ++c) {
        float kv[N];
        Row16<TKV>::widen(kr[c], kv);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float kk = kv[j] * kv_scale;
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G) part[g] += qs[g * D + c * N + j] * kk;
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) sc[g * span + t] = part[g] * scale;
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float mx = -INFINITY;
      for (int t = lane; t < valid; t += 32) mx = fmaxf(mx, sc[g * span + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < valid; t += 32) {
        const float e = expf(sc[g * span + t] - m_new);
        sc[g * span + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);  // m_old = -inf on the first span: 0
        corr_s[g] = c;
        d_s[g] = d_s[g] * c + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) acc[g] *= corr_s[g];
#pragma unroll 8
    for (int t = 0; t < valid; ++t) {
      const float vv = to_f32(v[base + (size_t)t * D + tid]) * kv_scale;
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] += sc[g * span + t] * vv;
    }
    __syncthreads();  // the next span rewrites sc
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G) out_head[g * D + tid] = acc[g] / fmaxf(d_s[g], 1e-30f);
}

// Host side: calls Launch<TQ, TKV>::run(args...) for q_dtype (0 = f32,
// 1 = bf16) and kv_dtype (0 = f32, 1 = bf16, 2 = fp8 e4m3); any other code
// gives cudaErrorInvalidValue.
template <template <typename, typename> class Launch, typename TQ, typename... Args>
int dispatch_kv(int kv_dtype, Args... args) {
  switch (kv_dtype) {
    case 0:
      return Launch<TQ, float>::run(args...);
    case 1:
      return Launch<TQ, __nv_bfloat16>::run(args...);
    case 2:
      return Launch<TQ, __nv_fp8_e4m3>::run(args...);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <template <typename, typename> class Launch, typename... Args>
int dispatch(int q_dtype, int kv_dtype, Args... args) {
  switch (q_dtype) {
    case 0:
      return dispatch_kv<Launch, float>(kv_dtype, args...);
    case 1:
      return dispatch_kv<Launch, __nv_bfloat16>(kv_dtype, args...);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace decode
