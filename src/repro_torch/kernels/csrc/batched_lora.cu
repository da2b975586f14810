// Batched multi-adapter ternary LoRA for Hopper (sm_90a):
//   y[b] = (x[b] · unpack2(A[idx[b]])) · unpack2(B[idx[b]]) · s[idx[b]].
//
// Replaces the Pallas TPU kernel repro/kernels/batched_lora/batched_lora.py
// (`batched_lora_matmul`, body `_kernel`). One decode tick serves slots that
// run different frozen fine-tunes: resident adapters are stacked along a
// leading adapter axis and each row picks its own A/B by index (SGMV). The
// TPU kernel resolves the index through scalar prefetch in its BlockSpec
// index maps; here each block reads its row's index itself.
//
// What bounds it on the card: at decode (4 rows, rank 8, K = 2560) a call
// reads x, the 2-bit codes of each distinct adapter in the batch (5 KB of A
// and, for N = 2560, 5 KB of B) and writes 4·N f32 outputs: ~0.1 MB, about
// 0.03 µs at 3.35 TB/s, and a few hundred thousand operations. Both are far
// below what one launch costs, so the kernel is bound by launch latency, and
// the design aims at being right and simple, not at the memory roofline.
//
// Design:
//   * one block per (row, tile of BN = 256 output columns);
//   * the block first forms z = x[row] · A (r values) in shared memory: the
//     threads split into r columns × (256 / r) groups over the packed rows of
//     K, each byte's four codes applied to four activations by conditional
//     negation ('01' → +x, '10' → −x, '00' and '11' → 0, as `tern()` in
//     ternary_matmul.cu), and one thread per column sums the groups' partials
//     in a fixed order;
//   * then each thread computes one output column from z and the column's
//     r/4 bytes of B (neighbouring threads read neighbouring bytes), in f32,
//     and multiplies by the adapter's combined scale once;
//   * a row with idx == 0 (the null adapter) writes exact zeros and reads no
//     codes and no activations, so a slot without an adapter stays bitwise
//     what the engine without adapters computes; an index outside [0, R)
//     writes NaN instead of reading out of bounds.
// r must be a multiple of 4 and at most 64; K a multiple of 4; any N.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 256;    // output columns per block, one per thread
constexpr int RMAX = 64;   // largest rank

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One 2-bit code applied to an activation by conditional negation.
__device__ __forceinline__ float tern(unsigned c, float x) {
  const float t = (c & 1u) ? x : 0.f;
  return (c & 2u) ? t - x : t;
}

// Four codes of one byte against four consecutive values v[0..3].
template <typename T>
__device__ __forceinline__ float tern4(unsigned byte, const T* v) {
  return tern(byte & 3u, to_f32(v[0])) + tern((byte >> 2) & 3u, to_f32(v[1])) +
         tern((byte >> 4) & 3u, to_f32(v[2])) + tern((byte >> 6) & 3u, to_f32(v[3]));
}

template <typename TX>
__global__ void __launch_bounds__(BN)
batched_lora_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ a_codes,
                    const uint8_t* __restrict__ b_codes, const float* __restrict__ scales,
                    const int* __restrict__ idx, float* __restrict__ out, int R, int K,
                    int r, int N) {
  __shared__ float part[BN];
  __shared__ float z[RMAX];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int n = blockIdx.y * BN + tid;
  const int ad = idx[row];
  float* orow = out + (size_t)row * N;
  if (ad <= 0 || ad >= R) {  // the same for every thread of the block
    if (n < N) orow[n] = ad == 0 ? 0.f : __int_as_float(0x7fc00000);
    return;
  }

  // z = x[row] · unpack(A[ad]): thread (g, j) sums column j over the packed
  // rows q = g, g + groups, ... of K.
  const int kq = K / 4, groups = BN / r;
  const int j = tid % r, g = tid / r;
  const uint8_t* a = a_codes + (size_t)ad * kq * r;
  const TX* xr = x + (size_t)row * K;
  float acc = 0.f;
  if (g < groups) {
    for (int q = g; q < kq; q += groups) acc += tern4(a[(size_t)q * r + j], xr + 4 * q);
  }
  part[tid] = acc;
  __syncthreads();
  if (tid < r) {
    float s = 0.f;
    for (int i = 0; i < groups; ++i) s += part[i * r + tid];
    z[tid] = s;
  }
  __syncthreads();

  // y[n] = z · unpack(B[ad])[:, n] · s[ad]
  if (n >= N) return;
  const uint8_t* b = b_codes + (size_t)ad * (r / 4) * N + n;
  float y = 0.f;
  for (int jq = 0; jq < r / 4; ++jq) y += tern4(b[(size_t)jq * N], z + 4 * jq);
  orow[n] = y * scales[ad];
}

template <typename TX>
int launch(const void* x, const void* a, const void* b, const void* s, const void* idx,
           void* out, int rows, int R, int K, int r, int N, cudaStream_t stream) {
  const dim3 grid(rows, (N + BN - 1) / BN);
  batched_lora_kernel<TX><<<grid, BN, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(a),
      static_cast<const uint8_t*>(b), static_cast<const float*>(s),
      static_cast<const int*>(idx), static_cast<float*>(out), R, K, r, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (rows, K) f32 (x_bf16 = 0) or bf16 (1); a_codes: (R, K/4, r) uint8;
// b_codes: (R, r/4, N) uint8; scales: (R,) f32; idx: (rows,) int32; out:
// (rows, N) f32. All row-major and contiguous. Returns cudaGetLastError()
// after the launch.
extern "C" int batched_lora(const void* x, int x_bf16, const void* a_codes,
                            const void* b_codes, const void* scales, const void* idx,
                            void* out, int rows, int R, int K, int r, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(x, a_codes, b_codes, scales, idx, out, rows, R, K, r,
                                        N, st)
                : launch<float>(x, a_codes, b_codes, scales, idx, out, rows, R, K, r, N, st);
}
