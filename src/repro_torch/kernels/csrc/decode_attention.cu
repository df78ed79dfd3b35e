// Ragged single-token decode attention over contiguous per-row caches,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py,
// decode_attention (_decode_kernel).
//
// Computes, for every row b and query head h, softmax(q·K^T / sqrt(D))·V
// over the first lengths[b] entries of row b's cache (C, KV, D): the ring
// slots of continuous batching and every decode step of the batch
// generate loop. Grouped-query attention: query head h reads KV head
// h / (H / KV). A row of length 0 (a vacant slot) is written as exact
// zeros. C is any length; lengths are clamped to [0, C], and a length of
// C is a full (possibly wrapped) ring, whose key order does not matter.
//
// What bounds it on this card: bytes. Each live K/V element is read once
// and used by only the H/KV query heads of its group (2 flops per byte in
// bf16 at rep = 1), far below the ~295 flops/byte at which an H100 turns
// compute-bound, so the floor is the live K/V bytes over 3.35 TB/s.
//
// What the design does about it: one block per (KV head, row) holds the
// whole query group (rep rows) and streams only the row's live tokens, so
// each live K/V element leaves device memory once for all rep heads and
// no byte past a row's length is read (the TPU kernel gets the same
// effect by clamping its DMA index map). The block body is decode_group
// of attn_common.cuh, shared with the paged decode kernel
// (paged_attention.cu): only the address of key p differs, here the plain
// stride of a contiguous row. Not yet done (later work): 16-byte vector
// loads, cp.async/TMA double buffering, and splitting long rows across
// blocks (flash-decoding) when B * KV blocks do not fill the 132 SMs.
#include "attn_common.cuh"

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(T* __restrict__ out, const T* __restrict__ q,
              const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ lengths, int H, int KV, int C,
              float scale) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int len = max(0, min(lengths[b], C));
  const long long row = (long long)b * C;
  decode_group<T, D>(out, q, k, v, b, g, H, H / KV, len, scale,
                     [&](int p) -> long long {
                       return ((row + p) * KV + g) * D;
                     });
}

template <typename T, int D>
static cudaError_t run(void* out, const void* q, const void* k, const void* v,
                       const void* lengths, int B, int H, int KV, int C,
                       float scale, cudaStream_t stream) {
  return launch(decode_kernel<T, D>, dim3(KV, B), smem_bytes<D>(), stream,
                (T*)out, (const T*)q, (const T*)k, (const T*)v,
                (const int*)lengths, H, KV, C, scale);
}

// q, out: (B, H, D); k, v: (B, C, KV, D); lengths: (B,) int32; all
// contiguous. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int decode_attention(void* out, const void* q, const void* k,
                                const void* v, const void* lengths, int B,
                                int H, int KV, int D, int C, int dtype,
                                float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0) return cudaSuccess;
  if (D == 64 && dtype == 0)
    return run<float, 64>(out, q, k, v, lengths, B, H, KV, C, scale, s);
  if (D == 64 && dtype == 1)
    return run<__nv_bfloat16, 64>(out, q, k, v, lengths, B, H, KV, C, scale,
                                  s);
  if (D == 128 && dtype == 0)
    return run<float, 128>(out, q, k, v, lengths, B, H, KV, C, scale, s);
  if (D == 128 && dtype == 1)
    return run<__nv_bfloat16, 128>(out, q, k, v, lengths, B, H, KV, C, scale,
                                   s);
  return cudaErrorInvalidValue;
}
