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
// Design (simple and right first): one block per (sequence b, KV head h),
// blockDim = D threads, running decode_common.cuh's online-softmax loop with
// one span per page: the block loops over pages p < ceil(lengths[b] / page)
// only, and inside the last page over positions < lengths[b] only, so a NaN
// or stale value on the scratch page cannot reach a live row. A sequence with
// lengths[b] == 0 (an inactive slot) gets 0.
// Left for later: split-K over pages for long contexts (flash-decoding),
// 16-byte loads in the value sum, and CUDA graphs over the decode tick.
#include "decode_common.cuh"

namespace {

// Span p of sequence b is page tables[b][p] of the pool, at KV head h.
struct PageSpans {
  const int* table;  // this sequence's row of the block tables
  int Hkv, h, page, D;
  __device__ size_t operator()(int p) const {
    return ((size_t)table[p] * Hkv + h) * page * D;
  }
};

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
  const int b = blockIdx.x, h = blockIdx.y;
  const size_t head = (size_t)(b * Hkv + h) * G * D;
  const PageSpans spans{tables + (size_t)b * n_p, Hkv, h, page, D};
  decode::decode_block(q + head, k_pool, v_pool, min(lengths[b], n_p * page), page, spans,
                       out + head, G, D, scale, kv_scale);
}

template <typename TQ, typename TKV>
struct Launch {
  static int run(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                 const void* lengths, void* out, int B, int Hkv, int G, int D, int page,
                 int n_p, float scale, float kv_scale, cudaStream_t stream) {
    const dim3 grid(B, Hkv), block(D);
    paged_flash_decode_kernel<TQ, TKV><<<grid, block, decode::smem_bytes(G, D, page), stream>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
        static_cast<const TKV*>(v_pool), static_cast<const int*>(tables),
        static_cast<const int*>(lengths), static_cast<float*>(out), Hkv, G, D, page, n_p,
        scale, kv_scale);
    return static_cast<int>(cudaGetLastError());
  }
};

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
  return decode::dispatch<Launch>(q_dtype, kv_dtype, q, k_pool, v_pool, tables, lengths, out,
                                  B, Hkv, G, D, page, n_p, scale, kv_scale,
                                  static_cast<cudaStream_t>(stream));
}
