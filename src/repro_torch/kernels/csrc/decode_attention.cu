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
// What the design does about it: split-K flash-decoding, whose block body
// and merge live in decode_split.cuh and also serve the paged decode
// kernel (paged_attention.cu), which differs only in the address of a key.
// The grid is (splits, KV, B): a row's keys are cut into splits of
// split_len keys, so B * KV (128 blocks at olmo-1b's 16 KV heads and 8
// rows) no longer bounds the blocks in flight, and a long row no longer
// streams through one SM while the short rows' SMs idle. The wrapper picks
// splits from C, B * KV and the SM count alone (never from the lengths,
// which live on the device). Each block holds the whole query group, so a
// live K/V byte leaves device memory once; it reads keys as 16-byte vectors
// spread over its warps and lane groups, stops at the row's length (no
// byte past it is read; a split that starts past it writes an empty
// partial), and writes f32 partials to a scratch buffer that the wrapper
// allocates. A second, small kernel merges the splits per (row, head) and
// writes the output; it is launched as a programmatic dependent of the
// first, which hides about 1.2 us of launch gap per call on the H100 (of
// 16-45 us at the port's shapes). Not yet done (later work): cp.async/TMA
// double buffering.
#include "decode_split.cuh"

template <typename T, int D, int R>
__global__ void __launch_bounds__(attn::kThreads)
decode_split_kernel(float* __restrict__ part, const T* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, int H, int KV, int C,
                    int split_len, float scale) {
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int len = max(0, min(lengths[b], C));
  const int start = split * split_len;
  const int end = min(start + split_len, len);
  const long long row = (long long)b * C;
  split::split_decode<T, D, R>(part, q, k, v, b, g, gridDim.z, H, H / KV,
                               gridDim.x, split, start, end, scale,
                               [&](int p) -> long long {
                                 return ((row + p) * KV + g) * D;
                               });
}

template <typename T, int D, int R>
static cudaError_t run(void* out, const void* q, const void* k, const void* v,
                       const void* lengths, void* scratch, int B, int H,
                       int KV, int C, int splits, int split_len, float scale,
                       cudaStream_t stream) {
  decode_split_kernel<T, D, R><<<dim3(splits, KV, B), attn::kThreads, 0,
                                 stream>>>(
      (float*)scratch, (const T*)q, (const T*)k, (const T*)v,
      (const int*)lengths, H, KV, C, split_len, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return split::launch_merge<T>(split::combine_splits<T, D>, out, scratch,
                                lengths, B * H, D, H, C, splits, stream);
}

// R: query heads per pass, 1 for a group of one head (olmo-1b) and else
// 8 (qwen2-0.5b's 7): heads past the group are padding, which costs FMAs
// but no bytes in this bytes-bound body, and groups of more than 8 heads
// take several passes.
template <typename T, int D>
static cudaError_t run_rep(void* out, const void* q, const void* k,
                           const void* v, const void* lengths, void* scratch,
                           int B, int H, int KV, int C, int splits,
                           int split_len, float scale, cudaStream_t s) {
  if (H / KV == 1)
    return run<T, D, 1>(out, q, k, v, lengths, scratch, B, H, KV, C, splits,
                        split_len, scale, s);
  return run<T, D, 8>(out, q, k, v, lengths, scratch, B, H, KV, C, splits,
                      split_len, scale, s);
}

// q, out: (B, H, D); k, v: (B, C, KV, D); lengths: (B,) int32; all
// contiguous. scratch: B * H * splits * (D + 2) floats. Keys [i *
// split_len, (i + 1) * split_len) of a row go to split i; splits *
// split_len >= C. dtype: 0 = float32, 1 = bfloat16. Both kernels run on
// `stream`; returns the first launch error (cudaGetLastError()).
extern "C" int decode_attention(void* out, const void* q, const void* k,
                                const void* v, const void* lengths,
                                void* scratch, int B, int H, int KV, int D,
                                int C, int splits, int split_len, int dtype,
                                float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0) return cudaSuccess;
  if (splits < 1 || split_len < 1 || (long long)splits * split_len < C)
    return cudaErrorInvalidValue;
  if (D == 64 && dtype == 0)
    return run_rep<float, 64>(out, q, k, v, lengths, scratch, B, H, KV, C,
                              splits, split_len, scale, s);
  if (D == 64 && dtype == 1)
    return run_rep<__nv_bfloat16, 64>(out, q, k, v, lengths, scratch, B, H,
                                      KV, C, splits, split_len, scale, s);
  if (D == 128 && dtype == 0)
    return run_rep<float, 128>(out, q, k, v, lengths, scratch, B, H, KV, C,
                               splits, split_len, scale, s);
  if (D == 128 && dtype == 1)
    return run_rep<__nv_bfloat16, 128>(out, q, k, v, lengths, scratch, B, H,
                                       KV, C, splits, split_len, scale, s);
  if (D == 112 && dtype == 0)
    return run_rep<float, 112>(out, q, k, v, lengths, scratch, B, H, KV, C,
                               splits, split_len, scale, s);
  if (D == 112 && dtype == 1)
    return run_rep<__nv_bfloat16, 112>(out, q, k, v, lengths, scratch, B, H,
                                       KV, C, splits, split_len, scale, s);
  return cudaErrorInvalidValue;
}
