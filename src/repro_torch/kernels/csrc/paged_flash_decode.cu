// Paged flash-decode for Hopper (sm_90a): one-token GQA attention over a
// block-table-indexed KV page pool.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode/paged.py
// (`paged_flash_decode`, body `_kernel`). There the block table reached the
// kernel through scalar prefetch; here each block reads its own table entries.
//
// What bounds it on the card: every live KV byte is read once and used for
// ~2·G operations, so the bound is the KV bytes of the live pages (fp8: one
// byte per element) plus q and out over the 3.35 TB/s memory rate. At decode
// sizes (a few pages per sequence) the launch itself dominates.
//
// Design (simple and right first):
//   * one block per (sequence b, KV head h), blockDim = D threads;
//   * the block loops over pages p < ceil(lengths[b] / page) only, and inside
//     the last page over positions < lengths[b] only: a masked position is
//     never read and never multiplied, so a NaN or stale value on the scratch
//     page cannot reach a live row (0 · NaN is never formed);
//   * scores: one thread per page position reads its key row in 16-byte loads
//     and widens fp8 e4m3 (or bf16, f32) to f32 in registers, times kv_scale,
//     against q held in shared memory (read as broadcasts);
//   * online softmax in f32 for the G query heads that share the KV head, the
//     running max starting at -inf; every processed page holds at least one
//     live position, so the max is finite after the first page and
//     exp(-inf - -inf) is never formed;
//   * the output accumulates per thread (one head dim each), eight positions
//     per unrolled step so their value loads are in flight together, and is
//     written in f32. A sequence with lengths[b] == 0 (an inactive slot) gets 0.
// Left for later: split-K over pages for long contexts (flash-decoding),
// 16-byte loads in the value sum, and CUDA graphs over the decode tick.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// q: (B, Hkv, G, D) f32 or bf16; pools: (n_pages + 1, Hkv, page, D), 16-byte
// aligned rows; tables: (B, n_p) int32; lengths: (B,) int32; out: (B, Hkv, G, D)
// f32.
template <typename TQ, typename TKV>
__global__ void paged_flash_decode_kernel(const TQ* __restrict__ q,
                                          const TKV* __restrict__ k_pool,
                                          const TKV* __restrict__ v_pool,
                                          const int* __restrict__ tables,
                                          const int* __restrict__ lengths,
                                          float* __restrict__ out, int Hkv, int G, int D,
                                          int page, int n_p, float scale, float kv_scale) {
  extern __shared__ float sm[];
  float* qs = sm;                // [G][D]
  float* sc = qs + G * D;        // [G][page] scores, then probabilities
  float* m_s = sc + G * page;    // [G] running max
  float* corr_s = m_s + G;       // [G] rescale of the previous pages
  float* d_s = corr_s + G;       // [G] running denominator

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const size_t head = (size_t)(b * Hkv + h) * G * D;
  float* o = out + head;
  const int len = lengths[b];
  if (len <= 0) {
    for (int i = tid; i < G * D; i += blockDim.x) o[i] = 0.f;
    return;
  }
  for (int i = tid; i < G * D; i += blockDim.x) qs[i] = to_f32(q[head + i]);
  if (tid < G) {
    m_s[tid] = -INFINITY;
    d_s[tid] = 0.f;
  }
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
  const int n_live = min((len + page - 1) / page, n_p);
  __syncthreads();

  for (int p = 0; p < n_live; ++p) {
    const int pid = tables[b * n_p + p];
    const int valid = min(page, len - p * page);
    const size_t base = ((size_t)pid * Hkv + h) * page * D;

    constexpr int N = Row16<TKV>::N;
    for (int t = tid; t < valid; t += blockDim.x) {
      const uint4* kr = reinterpret_cast<const uint4*>(k_pool + base + (size_t)t * D);
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
        if (g < G) sc[g * page + t] = part[g] * scale;
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float mx = -INFINITY;
      for (int t = lane; t < valid; t += 32) mx = fmaxf(mx, sc[g * page + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < valid; t += 32) {
        const float e = expf(sc[g * page + t] - m_new);
        sc[g * page + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);  // m_old = -inf on the first page: 0
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
      const float vv = to_f32(v_pool[base + (size_t)t * D + tid]) * kv_scale;
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] += sc[g * page + t] * vv;
    }
    __syncthreads();  // the next page rewrites sc
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G) o[g * D + tid] = acc[g] / fmaxf(d_s[g], 1e-30f);
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* lengths, void* out, int B, int Hkv, int G, int D, int page, int n_p,
           float scale, float kv_scale, cudaStream_t stream) {
  const dim3 grid(B, Hkv), block(D);
  const size_t smem = sizeof(float) * (G * D + G * page + 3 * G);
  paged_flash_decode_kernel<TQ, TKV><<<grid, block, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(out), Hkv, G, D, page, n_p,
      scale, kv_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_q(const void* q, const void* k_pool, const void* v_pool, int kv_dtype,
             const void* tables, const void* lengths, void* out, int B, int Hkv, int G,
             int D, int page, int n_p, float scale, float kv_scale, cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return launch<TQ, float>(q, k_pool, v_pool, tables, lengths, out, B, Hkv, G, D, page,
                               n_p, scale, kv_scale, s);
    case 1:
      return launch<TQ, __nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, B, Hkv, G,
                                       D, page, n_p, scale, kv_scale, s);
    case 2:
      return launch<TQ, __nv_fp8_e4m3>(q, k_pool, v_pool, tables, lengths, out, B, Hkv, G,
                                       D, page, n_p, scale, kv_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_dtype: 0 = f32, 1 = bf16 (read as given, widened in shared memory).
// kv_dtype: 0 = f32, 1 = bf16, 2 = fp8 e4m3. D must be a multiple of 32 (at
// most 1024) and G at most 8; the wrapper checks both. Returns
// cudaGetLastError() after the launch.
extern "C" int paged_flash_decode(const void* q, int q_dtype, const void* k_pool,
                                  const void* v_pool, int kv_dtype, const void* tables,
                                  const void* lengths, void* out, int B, int Hkv, int G,
                                  int D, int page, int n_p, float scale, float kv_scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_q<float>(q, k_pool, v_pool, kv_dtype, tables, lengths, out, B, Hkv, G, D,
                             page, n_p, scale, kv_scale, s);
    case 1:
      return launch_q<__nv_bfloat16>(q, k_pool, v_pool, kv_dtype, tables, lengths, out, B,
                                     Hkv, G, D, page, n_p, scale, kv_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
