// Incremental chunk attention over a paged KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/chunk_attention.py,
// paged_chunk_attention (_chunk_kernel).
//
// Segment s holds R new chunk rows; row r sits at absolute position
// hist[s] + r and is real iff r < seg_lens[s]. A real row attends the
// segment's paged history [0, hist[s]) — logical position p lives at
// (block_tables[s, p / page_size], p % page_size) of the (P, page_size,
// KV, D) pool — plus the chunk's own rows c <= r with c < seg_lens[s],
// and, when window > 0, only keys less than window positions behind it.
// Query head h reads KV head h / (H / KV). Rows r >= seg_lens[s] are
// padding and are written as zeros; hist = 0 (a fresh sequence) and
// seg_lens = 0 (a padding segment) are both fine.
//
// What bounds it on this card: it depends on the chunk. A continuation of
// a few hundred rows reuses each history key for every row of the chunk
// and is operation-bound like the packed prefill; a short chunk over a long
// history (speculative verify) is byte-bound like decode.
//
// What the design does about it: the query rows of one (segment, KV head)
// are the R·rep pairs (chunk row, grouped head), row f = r·rep + u, so
// every history page read serves all rep heads of the group; they are cut
// into tiles of 32 rows, one block per (tile, KV head, segment), so a long
// chunk spreads over many SMs. A block reads table entries
// j < ceil(hist / page_size) only, walks the local causal block only up to
// its own last row, and a tile made only of padding rows writes its zeros
// and exits. Not yet done (later work): tensor-core products, vector/TMA
// loads, and sharing history tiles between the row tiles of one segment.
#include "attn_common.cuh"

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(T* __restrict__ out, const T* __restrict__ q,
                   const T* __restrict__ kp, const T* __restrict__ vp,
                   const T* __restrict__ kc, const T* __restrict__ vc,
                   const int* __restrict__ tables,
                   const int* __restrict__ hist_lens,
                   const int* __restrict__ seg_lens, int R, int H, int KV,
                   int page_size, int max_pages, int window, float scale) {
  Smem<D>& sm = smem<D>();
  const int f0 = blockIdx.x * kBQ, g = blockIdx.y, s = blockIdx.z;
  const int rep = H / KV;
  const int n_rows = R * rep;
  const int hist = hist_lens[s], slen = seg_lens[s];
  const int* trow = tables + (long long)s * max_pages;
  const long long tok_stride = (long long)KV * D;
  const long long page_stride = (long long)page_size * tok_stride;
  // tile row r is query row f = f0 + r: chunk row f / rep, head g*rep + f % rep
  auto qoff = [&](int r) -> long long {
    const int f = f0 + r;
    if (f >= n_rows) return -1;
    return (((long long)s * R + f / rep) * H + g * rep + f % rep) * D;
  };
  const int c_first = f0 / rep;                           // first chunk row
  const int c_last = (min(f0 + kBQ, n_rows) - 1) / rep;   // last chunk row
  if (c_first >= slen) {
    // padding rows only
    for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
      const long long off = qoff(idx / D);
      if (off >= 0) out[off + idx % D] = from_f<T>(0.f);
    }
    return;
  }
  load_q<T, D>(sm, q, qoff);
  RowState<D> st;
  st.init();
  auto row_of = [&](int r) { return (f0 + r) / rep; };
  auto real = [&](int r) { return f0 + r < n_rows && row_of(r) < slen; };

  // paged history [0, hist)
  for (int k0 = 0; k0 < hist; k0 += kBK) {
    // every key of this tile is outside the window of the tile's first row
    if (window > 0 && k0 + kBK - 1 <= hist + c_first - window) continue;
    load_kv<T, D>(sm, kp, vp, [&](int t) -> long long {
      const int p = k0 + t;
      if (p >= hist) return -1;
      return trow[p / page_size] * page_stride +
             (long long)(p % page_size) * tok_stride + (long long)g * D;
    });
    fold_tile<D>(sm, st, scale, [&](int r, int t) {
      const int p = k0 + t;
      return real(r) && p < hist &&
             (window <= 0 || hist + row_of(r) - p < window);
    });
  }
  // the chunk itself, causally
  const int c_end = min(slen, c_last + 1);
  for (int c0 = 0; c0 < c_end; c0 += kBK) {
    load_kv<T, D>(sm, kc, vc, [&](int t) -> long long {
      const int c = c0 + t;
      return c < c_end ? (((long long)s * R + c) * KV + g) * D : -1;
    });
    fold_tile<D>(sm, st, scale, [&](int r, int t) {
      const int c = c0 + t, rr = row_of(r);
      return real(r) && c < slen && c <= rr &&
             (window <= 0 || rr - c < window);
    });
  }
  store_rows<T, D>(st, out, qoff);
}

template <typename T, int D>
static cudaError_t run(void* out, const void* q, const void* kp,
                       const void* vp, const void* kc, const void* vc,
                       const void* tables, const void* hist_lens,
                       const void* seg_lens, int S, int R, int H, int KV,
                       int page_size, int max_pages, int window, float scale,
                       cudaStream_t stream) {
  const dim3 grid((R * (H / KV) + kBQ - 1) / kBQ, KV, S);
  return launch(paged_chunk_kernel<T, D>, grid, smem_bytes<D>(), stream,
                (T*)out, (const T*)q, (const T*)kp, (const T*)vp,
                (const T*)kc, (const T*)vc, (const int*)tables,
                (const int*)hist_lens, (const int*)seg_lens, R, H, KV,
                page_size, max_pages, window, scale);
}

// q, out: (S, R, H, D); k_pages, v_pages: (P, page_size, KV, D);
// k_chunk, v_chunk: (S, R, KV, D); tables: (S, max_pages) int32;
// hist_lens, seg_lens: (S,) int32; all contiguous. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError().
extern "C" int paged_chunk_attention(void* out, const void* q,
                                     const void* k_pages, const void* v_pages,
                                     const void* k_chunk, const void* v_chunk,
                                     const void* tables, const void* hist_lens,
                                     const void* seg_lens, int S, int R,
                                     int H, int KV, int D, int page_size,
                                     int max_pages, int window, int dtype,
                                     float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 0 || R == 0) return cudaSuccess;
#define CHUNK_RUN(TYPE, DIM)                                                 \
  return run<TYPE, DIM>(out, q, k_pages, v_pages, k_chunk, v_chunk, tables, \
                        hist_lens, seg_lens, S, R, H, KV, page_size,         \
                        max_pages, window, scale, st)
  if (D == 64 && dtype == 0) CHUNK_RUN(float, 64);
  if (D == 64 && dtype == 1) CHUNK_RUN(__nv_bfloat16, 64);
  if (D == 128 && dtype == 0) CHUNK_RUN(float, 128);
  if (D == 128 && dtype == 1) CHUNK_RUN(__nv_bfloat16, 128);
#undef CHUNK_RUN
  return cudaErrorInvalidValue;
}
