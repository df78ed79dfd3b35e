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
#include "attn_common.cuh"

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(T* __restrict__ out, const T* __restrict__ q,
                    const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, int H, int KV,
                    int page_size, int max_pages, float scale) {
  Smem<D>& sm = smem<D>();
  const int g = blockIdx.x, b = blockIdx.y;
  const int rep = H / KV;
  const int len = lengths[b];
  const int* trow = tables + (long long)b * max_pages;
  const long long tok_stride = (long long)KV * D;
  const long long page_stride = (long long)page_size * tok_stride;
  // rows of the tile are query heads g*rep + r0 + r of row b
  for (int r0 = 0; r0 < rep; r0 += kBQ) {
    const int nrows = min(kBQ, rep - r0);
    auto qoff = [&](int r) -> long long {
      return r < nrows ? ((long long)b * H + g * rep + r0 + r) * D : -1;
    };
    __syncthreads();  // the previous group's tiles are no longer read
    load_q<T, D>(sm, q, qoff);
    RowState<D> st;
    st.init();
    for (int k0 = 0; k0 < len; k0 += kBK) {
      load_kv<T, D>(sm, kp, vp, [&](int t) -> long long {
        const int p = k0 + t;
        if (p >= len) return -1;
        return trow[p / page_size] * page_stride +
               (long long)(p % page_size) * tok_stride + (long long)g * D;
      });
      fold_tile<D>(sm, st, scale,
                   [&](int r, int t) { return r < nrows && k0 + t < len; });
    }
    store_rows<T, D>(st, out, qoff);
  }
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
