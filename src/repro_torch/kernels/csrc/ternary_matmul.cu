// Packed-ternary matmul for Hopper (sm_90a): y = x (M,K) · unpack2(packed) (K,N) · scale.
//
// Replaces the Pallas TPU kernel repro/kernels/ternary_matmul/ternary_matmul.py
// (`ternary_matmul`, body `_kernel`, decode `_decode_tile`). It computes what
// that kernel computes, not how: weights stay 2-bit codes in device memory
// (4 per byte, packed along K) and are decoded in registers; nothing unpacked
// is ever stored.
//
// What bounds it on the card: the decode GEMV (M = slot count) reads every
// weight byte once and does ~2·M operations per weight, far below the ~295
// operations per byte at which an H100's tensor cores, not its 3.35 TB/s of
// memory, would be the limit. So the bound is the packed weight bytes (plus x
// and y) over the memory rate; at M = 4 the 181 launches of one full-width
// bitnet-2b decode tick move about 470 MB.
//
// Design (simple and right first):
//   * one block per tile of BN = 32 output columns, one column per lane, so
//     neighbouring threads read neighbouring bytes of packed[kq, :] (coalesced);
//   * KL = 16 warps per block split the packed rows of K between them and
//     reduce their partial sums through shared memory at the end;
//   * the activation rows are staged in shared memory as f32, one K chunk at a
//     time, and read as broadcasts;
//   * each 2-bit code is applied as a conditional negation ('01' → +x,
//     '10' → −x, '00' and '11' → 0, the rule of `_decode_tile`), accumulated in
//     f32; `scale` multiplies once at the end and the store casts to the output
//     type;
//   * M is a loop over register tiles of MT = 4 rows, so any M works.
// Left for later: wgmma with tiles decoded into shared memory for the prefill
// GEMM shape, split-K (only N/32 blocks run, e.g. 20 for N = 640), wider loads
// (4 columns per lane), and CUDA graphs against decode launch overhead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 32;  // output columns per block, one per lane
constexpr int KL = 16;  // warps per block, splitting K
constexpr int MT = 4;   // activation rows per register tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One 2-bit code applied to an activation by conditional negation.
__device__ __forceinline__ float tern(unsigned c, float x) {
  const float t = (c & 1u) ? x : 0.f;
  return (c & 2u) ? t - x : t;
}

// strided != 0: within each K-tile of `tile` rows, byte j packs rows j + s*tile/4.
// kc: K rows staged per chunk (a multiple of 4, and of `tile` when strided).
template <typename TX, typename TO>
__global__ void __launch_bounds__(BN * KL)
ternary_matmul_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ packed,
                      const float* __restrict__ scale, TO* __restrict__ out,
                      int M, int K, int N, int strided, int tile, int kc) {
  extern __shared__ float xs[];  // [MT][kc]
  __shared__ float red[KL][MT][BN];
  const int lane = threadIdx.x, kl = threadIdx.y;
  const int tid = kl * BN + lane;
  const int n = blockIdx.x * BN + lane;
  const bool col_ok = n < N;
  const int q = strided ? tile / 4 : 1;  // packed rows per K-tile

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mt = min(MT, M - m0);
    float acc[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) acc[r] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kc) {
      const int kn = min(kc, K - k0);
      __syncthreads();  // every warp is done with the previous chunk
      for (int i = tid; i < MT * kn; i += BN * KL) {
        const int r = i / kn, c = i - r * kn;
        xs[r * kc + c] = r < mt ? to_f32(x[(size_t)(m0 + r) * K + k0 + c]) : 0.f;
      }
      __syncthreads();
      if (col_ok) {
        const uint8_t* col = packed + (size_t)(k0 / 4) * N + n;
        const int nq = kn / 4;
#pragma unroll 4
        for (int j = kl; j < nq; j += KL) {
          const unsigned b = col[(size_t)j * N];
          int base, step;  // chunk-local row of slot 0, rows between slots
          if (strided) {
            const int t = j / q;
            base = t * tile + (j - t * q);
            step = q;
          } else {
            base = 4 * j;
            step = 1;
          }
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const unsigned c = (b >> (2 * s)) & 3u;
#pragma unroll
            for (int r = 0; r < MT; ++r) acc[r] += tern(c, xs[r * kc + base + s * step]);
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < MT; ++r) red[kl][r][lane] = acc[r];
    __syncthreads();
    if (kl == 0 && col_ok) {
      const float sc = *scale;
      for (int r = 0; r < mt; ++r) {
        float sum = 0.f;
#pragma unroll
        for (int l = 0; l < KL; ++l) sum += red[l][r][lane];
        store(out + (size_t)(m0 + r) * N + n, sum * sc);
      }
    }
    // `red` is rewritten only after the next tile's chunk barriers, which
    // warp 0 reaches after its reads above.
  }
}

template <typename TX, typename TO>
int launch(const void* x, const void* packed, const void* scale, void* out, int M, int K,
           int N, int strided, int tile, int kc, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN), block(BN, KL);
  const size_t smem = sizeof(float) * MT * kc;
  ternary_matmul_kernel<TX, TO><<<grid, block, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<TO*>(out), M, K, N, strided, tile, kc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, K) f32 (x_bf16 = 0) or bf16 (1); packed: (K/4, N) uint8; scale: one
// f32 in device memory; out: (M, N) f32 (out_bf16 = 0) or bf16 (1). All
// row-major and contiguous. Returns cudaGetLastError() after the launch.
extern "C" int ternary_matmul(const void* x, int x_bf16, const void* packed,
                              const void* scale, void* out, int out_bf16, int M, int K,
                              int N, int strided, int tile, int kc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, packed, scale, out, M, K, N,
                                                           strided, tile, kc, s)
                    : launch<__nv_bfloat16, float>(x, packed, scale, out, M, K, N, strided,
                                                   tile, kc, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(x, packed, scale, out, M, K, N, strided,
                                                 tile, kc, s)
                  : launch<float, float>(x, packed, scale, out, M, K, N, strided, tile, kc, s);
}
