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
// and is operation-bound like the packed prefill (4 flops per visible
// (row, key) pair and head dimension, over the 989 TFLOP/s bf16 peak); a
// short chunk over a long history (speculative verify) is byte-bound like
// decode.
//
// What the design does about it. bf16 runs the tensor-core attend body of
// the flash kernels (tc_attend.cuh) over absolute key positions: key j <
// hist is the paged history at (block_tables[s, j / page_size], j %
// page_size), key hist <= j < hist + seg_len is chunk row j - hist, so a
// 64-key tile may hold both (its row addresses go through ChunkKeys, a
// cp.async per 16 bytes either way). One warpgroup takes 64 chunk rows of
// one (segment, query head): grid (ceil(R / 64), H, S), q and out rows at
// the constant stride H * D, the tile's queries at absolute positions
// hist + r0 onward. Its walk runs from the window's first key tile (0
// without a window) to the tile of its last real row, and the mask does
// per-element work only on the diagonal, window-start and ragged tiles.
// A block reads table entries j < ceil(hist / page_size) only. It writes
// zeros into its padding rows (r >= seg_len) itself, and a tile made only
// of padding rows writes its zeros and exits. Grouped-query attention at
// qwen2-0.5b's heads (14 query over 2 KV heads) has 7 blocks read one KV
// head's keys; at the operation-bound continuation shapes those re-reads
// come from L2 and cost no HBM bytes worth sharing a block for. float32
// (the parity dtype) stays on the FMA tiles of attn_common.cuh: the query
// rows of one (segment, KV head) are the R·rep pairs (chunk row, grouped
// head), cut into tiles of 32 rows, one block per (tile, KV head,
// segment), walking the history and then the chunk causally. Not yet done
// (later work): a split over the history for short chunks over long
// histories (speculative verify), and TMA loads.
#include "attn_common.cuh"
#include "tc_attend.cuh"

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(T* __restrict__ out, const T* __restrict__ q,
                   const T* __restrict__ kp, const T* __restrict__ vp,
                   const T* __restrict__ kc, const T* __restrict__ vc,
                   const int* __restrict__ tables,
                   const int* __restrict__ hist_lens,
                   const int* __restrict__ seg_lens, int R, int H, int KV,
                   int page_size, int page_shift, int max_pages, int window,
                   float scale) {
  Smem<D>& sm = smem<D>();
  const int f0 = blockIdx.x * kBQ, g = blockIdx.y, s = blockIdx.z;
  const int rep = H / KV;
  const int n_rows = R * rep;
  const int hist = hist_lens[s], slen = seg_lens[s];
  const long long tok_stride = (long long)KV * D;
  const PageMap page{tables + (long long)s * max_pages,
                     page_size * tok_stride, tok_stride, page_size,
                     page_shift};
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
      return p < hist ? page(p) + (long long)g * D : -1;
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

namespace tc {

// The keys of one (segment, KV head) over absolute positions: j < hist
// through the block table (only entries j / page_size < ceil(hist /
// page_size) are read), hist <= j < n = hist + seg_len the chunk rows.
template <int D>
struct ChunkKeys {
  const bf16* __restrict__ kp;  // the pools, at KV head g
  const bf16* __restrict__ vp;
  const bf16* __restrict__ kc;  // chunk row 0 of segment s, at KV head g
  const bf16* __restrict__ vc;
  attn::PageMap page;           // page.tok_stride is also the chunk's
  int hist, n;
  template <class Pick>
  __device__ __forceinline__ void load(bf16* dst, int k0, Pick pick) const {
    load_rows<D, kBK>(dst, [&](int r) -> const bf16* {
      const int j = k0 + r;
      if (j >= n) return nullptr;
      return j < hist ? pick(kp, vp) + page(j)
                      : pick(kc, vc) + (j - hist) * page.tok_stride;
    }, kc);
  }
  __device__ __forceinline__ void load_k(bf16* dst, long long k0) const {
    load(dst, (int)k0, [](const bf16* k, const bf16*) { return k; });
  }
  __device__ __forceinline__ void load_v(bf16* dst, long long k0) const {
    load(dst, (int)k0, [](const bf16*, const bf16* v) { return v; });
  }
};

// Visibility of chunk rows [q0, q0 + nq) (absolute positions; rows past
// nq are padding) over absolute key positions: causal, within the window
// when one is given. Every key j <= i of a real row i exists. A tile is
// full when it lies wholly below the tile's first row, all 64 rows are
// real, and the last row's window still holds its first key.
struct ChunkMask {
  int q0, nq, window;
  __device__ __forceinline__ bool full(int k0) const {
    return k0 + kBK - 1 <= q0 && nq == kBQ &&
           (window <= 0 || q0 + kBQ - 1 - k0 < window);
  }
  __device__ __forceinline__ bool visible(int i, int j) const {
    return i < q0 + nq && j <= i && (window <= 0 || i - j < window);
  }
};

}  // namespace tc

// The bf16 chunk kernel on tc_attend: one warpgroup per 64 chunk rows of
// one (segment, query head). Its name must not contain the float32
// kernel's, whose SASS the checks select by name.
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
chunk_tc_kernel(__nv_bfloat16* __restrict__ out,
                const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ kp,
                const __nv_bfloat16* __restrict__ vp,
                const __nv_bfloat16* __restrict__ kc,
                const __nv_bfloat16* __restrict__ vc,
                const int* __restrict__ tables,
                const int* __restrict__ hist_lens,
                const int* __restrict__ seg_lens, int R, int H, int KV,
                int page_size, int page_shift, int max_pages, int window,
                float scale) {
  const int r0 = blockIdx.x * tc::kBQ, h = blockIdx.y, s = blockIdx.z;
  const int g = h / (H / KV);
  const int hist = hist_lens[s], slen = seg_lens[s];
  const long long q_stride = (long long)H * D;
  const long long qo = (((long long)s * R + r0) * H + h) * D;
  // tile rows [0, nq) are real, rows [nq, rows) padding: written as zeros
  constexpr int kCh = D / 8;
  const int rows = min(tc::kBQ, R - r0);
  const int nq = min(rows, max(0, slen - r0));
  for (int idx = nq * kCh + threadIdx.x; idx < rows * kCh; idx += kThreads)
    *reinterpret_cast<uint4*>(out + qo + (idx / kCh) * q_stride +
                              (idx % kCh) * 8) = make_uint4(0, 0, 0, 0);
  if (nq == 0) return;  // padding rows only
  const int q0 = hist + r0, q_last = q0 + nq - 1;
  const int first = window > 0 ? max(0, q0 - window + 1) : 0;
  const long long tok_stride = (long long)KV * D;
  const long long ko = (long long)s * R * tok_stride + (long long)g * D;
  const tc::ChunkKeys<D> keys{
      kp + g * D, vp + g * D, kc + ko, vc + ko,
      attn::PageMap{tables + (long long)s * max_pages,
                    page_size * tok_stride, tok_stride, page_size,
                    page_shift},
      hist, hist + slen};
  tc::tc_attend<D>(out + qo, q + qo, q_stride, nq, keys, q0,
                   first / tc::kBK, q_last / tc::kBK, scale,
                   tc::ChunkMask{q0, nq, window});
}

template <int D>
static cudaError_t run_tc(void* out, const void* q, const void* kp,
                          const void* vp, const void* kc, const void* vc,
                          const void* tables, const void* hist_lens,
                          const void* seg_lens, int S, int R, int H, int KV,
                          int page_size, int max_pages, int window,
                          float scale, cudaStream_t stream) {
  typedef __nv_bfloat16 bf;
  const dim3 grid((R + tc::kBQ - 1) / tc::kBQ, H, S);
  return launch(chunk_tc_kernel<D>, grid, tc::smem_bytes<D>(), stream,
                (bf*)out, (const bf*)q, (const bf*)kp, (const bf*)vp,
                (const bf*)kc, (const bf*)vc, (const int*)tables,
                (const int*)hist_lens, (const int*)seg_lens, R, H, KV,
                page_size, page_shift_of(page_size), max_pages, window,
                scale);
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
                page_size, page_shift_of(page_size), max_pages, window,
                scale);
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
#define CHUNK_ARGS                                                           \
  out, q, k_pages, v_pages, k_chunk, v_chunk, tables, hist_lens, seg_lens,  \
      S, R, H, KV, page_size, max_pages, window, scale, st
  if (D == 64 && dtype == 0) return run<float, 64>(CHUNK_ARGS);
  if (D == 64 && dtype == 1) return run_tc<64>(CHUNK_ARGS);
  if (D == 128 && dtype == 0) return run<float, 128>(CHUNK_ARGS);
  if (D == 128 && dtype == 1) return run_tc<128>(CHUNK_ARGS);
#undef CHUNK_ARGS
  return cudaErrorInvalidValue;
}
