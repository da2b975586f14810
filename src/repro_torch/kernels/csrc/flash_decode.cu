// Flash-decode for Hopper (sm_90a): one-token GQA attention over a contiguous
// KV cache (B, Hkv, S, D), each sequence masked at its own live length.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode/flash_decode.py
// (`flash_decode`, body `_kernel`). There one scalar length covered the whole
// batch and the context was a sequential grid axis whose running (m, d, acc)
// stayed in VMEM scratch from one step to the next; here blocks run in no
// order, so the context is a loop inside the block, and each sequence reads
// its own length (a scalar length is the case where all are equal).
//
// What bounds it on the card: every live KV byte is read once and used for
// ~2·G operations, so the bound is the KV bytes of the live positions (fp8:
// one byte per element) plus q and out over the 3.35 TB/s memory rate. At
// decode sizes (a few hundred positions per sequence) the launch itself
// dominates.
//
// Design (simple and right first): one block per (sequence b, KV head h),
// blockDim = D threads, running decode_common.cuh's online-softmax loop over
// chunks of SPAN contiguous positions of the cache, up to min(lengths[b], S)
// only: positions past the live length are never read, so S needs no
// padding and stale cache rows cannot reach the output. A sequence with
// lengths[b] <= 0 gets 0 (the reference's softmax over all-masked scores
// averages the cache there instead; no caller reads such a row).
// Left for later: split-K over the context (flash-decoding proper) for long
// sequences, 16-byte loads in the value sum, and CUDA graphs over the tick.
#include "decode_common.cuh"

namespace {

constexpr int SPAN = 128;  // positions per chunk: one per thread at D = 128

// Chunk p of sequence b, KV head h: rows [p·SPAN, (p+1)·SPAN) of its cache.
struct ChunkSpans {
  size_t row0;  // element offset of (b, h, 0, 0)
  int D;
  __device__ size_t operator()(int p) const { return row0 + (size_t)p * SPAN * D; }
};

// q: (B, Hkv, G, D) f32 or bf16; k, v: (B, Hkv, S, D), 16-byte aligned rows;
// lengths: (B,) int32; out: (B, Hkv, G, D) f32.
template <typename TQ, typename TKV>
__global__ void flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                                    const TKV* __restrict__ v,
                                    const int* __restrict__ lengths,
                                    float* __restrict__ out, int Hkv, int G, int S, int D,
                                    float scale, float kv_scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const size_t bh = (size_t)b * Hkv + h;
  const ChunkSpans spans{bh * S * D, D};
  decode::decode_block(q + bh * G * D, k, v, min(lengths[b], S), SPAN, spans,
                       out + bh * G * D, G, D, scale, kv_scale);
}

template <typename TQ, typename TKV>
struct Launch {
  static int run(const void* q, const void* k, const void* v, const void* lengths, void* out,
                 int B, int Hkv, int G, int S, int D, float scale, float kv_scale,
                 cudaStream_t stream) {
    const dim3 grid(B, Hkv), block(D);
    flash_decode_kernel<TQ, TKV><<<grid, block, decode::smem_bytes(G, D, SPAN), stream>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
        static_cast<const int*>(lengths), static_cast<float*>(out), Hkv, G, S, D, scale,
        kv_scale);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q_dtype: 0 = f32, 1 = bf16 (read as given, widened in shared memory).
// kv_dtype: 0 = f32, 1 = bf16, 2 = fp8 e4m3. D must be a multiple of 32 (at
// most 1024) and G at most 8; the wrapper checks both. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_decode(const void* q, int q_dtype, const void* k, const void* v,
                            int kv_dtype, const void* lengths, void* out, int B, int Hkv,
                            int G, int S, int D, float scale, float kv_scale, void* stream) {
  return decode::dispatch<Launch>(q_dtype, kv_dtype, q, k, v, lengths, out, B, Hkv, G, S, D,
                                  scale, kv_scale, static_cast<cudaStream_t>(stream));
}
