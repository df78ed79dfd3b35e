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
// parked on the null page) is written as exact zeros. Lengths are clamped
// to [0, max_pages * page_size]. D is 64, 128 or 112 (zamba2-7b's shared
// attention; decode_split.cuh pads its lane groups).
//
// What bounds it on this card: bytes. Each live K/V element is read once
// and used by only the H/KV query heads of its group (2 flops per byte in
// bf16 at rep = 1), far below the ~295 flops/byte at which an H100 turns
// compute-bound, so the floor is the live K/V bytes over 3.35 TB/s.
//
// What the design does about it: the split-K flash-decoding body of the
// contiguous decode kernel (decode_split.cuh, decode_attention.cu), with a
// key address that goes through the block table (attn::PageMap). The grid
// is (splits, KV, B): a row's logical positions are cut into splits of
// split_len keys, picked by the wrapper from B, KV, max_pages * page_size
// and the SM count alone (never from the lengths, which live on the
// device), so the 8 rows x 16 KV heads of olmo-1b's serve no longer leave
// one long row streaming through one SM. Splits are whole 64-key tiles,
// so they fall on whole pages wherever the page size divides 64. Each
// block holds its KV head's whole query group, so a live K/V byte leaves
// device memory once, and reads keys as 16-byte vectors; it computes the
// address only of keys below the row's length, so no table entry at or
// past ceil(length / page_size) is read and no dead page is touched. A
// page size that is a power of two maps a key to its page by a shift, any
// other multiple of 8 by a division. The merge of the splits is its own
// kernel (paged_combine_splits, the body of combine_splits), launched as
// a programmatic dependent of the split kernel, so profiles charge the
// contiguous decode's merges and this kernel's apart. Not yet done (later
// work): cp.async/TMA double buffering.
#include "decode_split.cuh"

template <typename T, int D, int R>
__global__ void __launch_bounds__(attn::kThreads)
paged_split_kernel(float* __restrict__ part, const T* __restrict__ q,
                   const T* __restrict__ kp, const T* __restrict__ vp,
                   const int* __restrict__ tables,
                   const int* __restrict__ lengths, int H, int KV,
                   int page_size, int page_shift, int max_pages,
                   int split_len, float scale) {
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int len = max(0, min(lengths[b], max_pages * page_size));
  const int start = split * split_len;
  const int end = min(start + split_len, len);
  const long long tok_stride = (long long)KV * D;
  const attn::PageMap page{tables + (long long)b * max_pages,
                           page_size * tok_stride, tok_stride, page_size,
                           page_shift};
  split::split_decode<T, D, R>(part, q, kp + g * D, vp + g * D, b, g,
                               gridDim.z, H, H / KV, gridDim.x, split, start,
                               end, scale, page);
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_combine_splits(T* __restrict__ out, const float* __restrict__ part,
                     const int* __restrict__ lengths, int H, int C,
                     int splits) {
  split::combine<T, D>(out, part, lengths, H, C, splits);
}

template <typename T, int D, int R>
static cudaError_t run(void* out, const void* q, const void* kp,
                       const void* vp, const void* tables, const void* lengths,
                       void* scratch, int B, int H, int KV, int page_size,
                       int max_pages, int splits, int split_len, float scale,
                       cudaStream_t stream) {
  paged_split_kernel<T, D, R><<<dim3(splits, KV, B), attn::kThreads, 0,
                                stream>>>(
      (float*)scratch, (const T*)q, (const T*)kp, (const T*)vp,
      (const int*)tables, (const int*)lengths, H, KV, page_size,
      attn::page_shift_of(page_size), max_pages, split_len, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return split::launch_merge<T>(paged_combine_splits<T, D>, out, scratch,
                                lengths, B * H, D, H, max_pages * page_size,
                                splits, stream);
}

// R: query heads per pass, 1 for a group of one head (olmo-1b) and else 8,
// as in decode_attention.cu.
template <typename T, int D>
static cudaError_t run_rep(void* out, const void* q, const void* kp,
                           const void* vp, const void* tables,
                           const void* lengths, void* scratch, int B, int H,
                           int KV, int page_size, int max_pages, int splits,
                           int split_len, float scale, cudaStream_t s) {
  if (H / KV == 1)
    return run<T, D, 1>(out, q, kp, vp, tables, lengths, scratch, B, H, KV,
                        page_size, max_pages, splits, split_len, scale, s);
  return run<T, D, 8>(out, q, kp, vp, tables, lengths, scratch, B, H, KV,
                      page_size, max_pages, splits, split_len, scale, s);
}

// q, out: (B, H, D); k_pages, v_pages: (P, page_size, KV, D);
// tables: (B, max_pages) int32; lengths: (B,) int32; all contiguous.
// scratch: B * H * splits * (D + 2) floats. Logical positions [i *
// split_len, (i + 1) * split_len) of a row go to split i; splits *
// split_len >= max_pages * page_size. dtype: 0 = float32, 1 = bfloat16.
// Both kernels run on `stream`; returns the first launch error
// (cudaGetLastError()).
extern "C" int paged_decode_attention(void* out, const void* q,
                                      const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lengths, void* scratch,
                                      int B, int H, int KV, int D,
                                      int page_size, int max_pages,
                                      int splits, int split_len, int dtype,
                                      float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0) return cudaSuccess;
  if (splits < 1 || split_len < 1 || page_size < 1 ||
      (long long)splits * split_len < (long long)max_pages * page_size)
    return cudaErrorInvalidValue;
#define PAGED_RUN(TYPE, DIM)                                                 \
  return run_rep<TYPE, DIM>(out, q, k_pages, v_pages, tables, lengths,      \
                            scratch, B, H, KV, page_size, max_pages, splits, \
                            split_len, scale, s)
  if (D == 64 && dtype == 0) PAGED_RUN(float, 64);
  if (D == 64 && dtype == 1) PAGED_RUN(__nv_bfloat16, 64);
  if (D == 128 && dtype == 0) PAGED_RUN(float, 128);
  if (D == 128 && dtype == 1) PAGED_RUN(__nv_bfloat16, 128);
  if (D == 112 && dtype == 0) PAGED_RUN(float, 112);
  if (D == 112 && dtype == 1) PAGED_RUN(__nv_bfloat16, 112);
#undef PAGED_RUN
  return cudaErrorInvalidValue;
}
