// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py,
// paged_decode_attention (_paged_kernel).
//
// Computes, for every row b and query head h, softmax(q·K^T / sqrt(D))·V
// over the row's first lengths[b] cached tokens, where logical position p
// of row b lives at (block_tables[b, p / page_size], p % page_size) of the
// shared page pool (P, page_size, KV, D). Grouped-query attention: query
// head h reads KV head h / (H / KV). A row of length 0 (a vacant slot
// parked on the null page) is written as exact zeros.
//
// What bounds it on this card: bytes. Each live K/V element is read once
// and used by only the H/KV query heads of its group (2 flops per byte in
// bf16 at rep = 1), far below the ~295 flops/byte at which an H100 turns
// compute-bound, so the floor is the live K/V bytes over 3.35 TB/s.
//
// What the design does about it: one block per (KV head, row) holds the
// whole query group (rep rows) and streams only the row's live tokens,
// so each live K/V element leaves device memory once for all rep heads.
// The block reads table entries j < ceil(len / page_size) and never the
// ones after them. Not yet done (later work): 16-byte vector loads,
// cp.async/TMA double buffering, and splitting long rows across blocks
// (flash-decoding) when B * KV blocks do not fill the 132 SMs.
//
// The block body is decode_group of attn_common.cuh, shared with the
// contiguous-cache decode kernel (decode_attention.cu): the two differ
// only in the address of key p, here a block-table lookup.
#include "attn_common.cuh"

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(T* __restrict__ out, const T* __restrict__ q,
                    const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, int H, int KV,
                    int page_size, int max_pages, float scale) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int* trow = tables + (long long)b * max_pages;
  const long long tok_stride = (long long)KV * D;
  const long long page_stride = (long long)page_size * tok_stride;
  decode_group<T, D>(out, q, kp, vp, b, g, H, H / KV, lengths[b], scale,
                     [&](int p) -> long long {
                       return trow[p / page_size] * page_stride +
                              (long long)(p % page_size) * tok_stride +
                              (long long)g * D;
                     });
}

template <typename T, int D>
static cudaError_t run(void* out, const void* q, const void* kp,
                       const void* vp, const void* tables, const void* lengths,
                       int B, int H, int KV, int page_size, int max_pages,
                       float scale, cudaStream_t stream) {
  return launch(paged_decode_kernel<T, D>, dim3(KV, B), smem_bytes<D>(),
                stream, (T*)out, (const T*)q, (const T*)kp, (const T*)vp,
                (const int*)tables, (const int*)lengths, H, KV, page_size,
                max_pages, scale);
}

// q, out: (B, H, D); k_pages, v_pages: (P, page_size, KV, D);
// tables: (B, max_pages) int32; lengths: (B,) int32; all contiguous.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int paged_decode_attention(void* out, const void* q,
                                      const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lengths, int B, int H,
                                      int KV, int D, int page_size,
                                      int max_pages, int dtype, float scale,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0) return cudaSuccess;
  if (D == 64 && dtype == 0)
    return run<float, 64>(out, q, k_pages, v_pages, tables, lengths, B, H, KV,
                          page_size, max_pages, scale, s);
  if (D == 64 && dtype == 1)
    return run<__nv_bfloat16, 64>(out, q, k_pages, v_pages, tables, lengths,
                                  B, H, KV, page_size, max_pages, scale, s);
  if (D == 128 && dtype == 0)
    return run<float, 128>(out, q, k_pages, v_pages, tables, lengths, B, H,
                           KV, page_size, max_pages, scale, s);
  if (D == 128 && dtype == 1)
    return run<__nv_bfloat16, 128>(out, q, k_pages, v_pages, tables, lengths,
                                   B, H, KV, page_size, max_pages, scale, s);
  return cudaErrorInvalidValue;
}
