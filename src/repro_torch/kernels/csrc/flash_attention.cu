// Segment-masked causal attention over a packed prefill row, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// segment_flash_attention (_segment_flash_kernel).
//
// A packed row concatenates the prompts of one admission batch; seg[b, i]
// is the (non-decreasing) segment id of token i, padding tokens carry an
// id no prompt uses. Token i attends token j iff seg[i] == seg[j], j <= i,
// and, when window > 0, i - j < window. Query head h reads KV head
// h * KV / H. T is any packed bucket (3·2^k as well as 2^k): the kernel
// masks the ragged edge itself.
//
// What bounds it on this card: operations. A tile of 32 query rows reuses
// every key it loads 32 times, so at prompt lengths of hundreds of tokens
// the QK^T and PV products dominate; their floor is 4·pairs·D flops per
// head over the tensor-core peak, and this version, which runs them as f32
// FMAs on the CUDA cores, stays well above that floor.
//
// What the design does about it: one block per (query tile, head, row)
// walks only the key tiles that can hold a visible pair. The walk starts
// at the tile holding the first token of the query tile's first segment
// (a binary search over the non-decreasing ids; with a window, no earlier
// than q0 - window + 1) and stops at the diagonal, so a packed batch pays
// for the pairs inside its segments, not for T^2. Not yet done (later
// work): wgmma tensor-core products on bf16 tiles, TMA loads and a
// persistent schedule.
#include "attn_common.cuh"

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
segment_flash_kernel(T* __restrict__ out, const T* __restrict__ q,
                     const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ seg, int T_, int H, int KV,
                     int window, float scale) {
  __shared__ int seg_q[kBQ];
  __shared__ int seg_k[kBK];
  __shared__ int first_key;
  Smem<D>& sm = smem<D>();
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h * KV / H;
  const int* segb = seg + (long long)b * T_;
  const int q_last = min(q0 + kBQ, T_) - 1;

  if (threadIdx.x == 0) {
    // first token of the segment that query q0 belongs to
    const int sid = segb[q0];
    int lo = 0, hi = q0;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (segb[mid] < sid) lo = mid + 1; else hi = mid;
    }
    first_key = window > 0 ? max(lo, q0 - window + 1) : lo;
  }
  if (threadIdx.x < kBQ)
    seg_q[threadIdx.x] = q0 + (int)threadIdx.x < T_ ? segb[q0 + threadIdx.x] : -1;
  auto qoff = [&](int r) -> long long {
    const int i = q0 + r;
    return i < T_ ? (((long long)b * T_ + i) * H + h) * D : -1;
  };
  load_q<T, D>(sm, q, qoff);
  __syncthreads();

  RowState<D> st;
  st.init();
  const int kt_end = q_last / kBK;  // the diagonal tile
  for (int kt = first_key / kBK; kt <= kt_end; ++kt) {
    const int k0 = kt * kBK;
    load_kv<T, D>(sm, k, v, [&](int t) -> long long {
      const int j = k0 + t;
      seg_k[t] = j < T_ ? segb[j] : -2;
      return j < T_ ? (((long long)b * T_ + j) * KV + g) * D : -1;
    });
    fold_tile<D>(sm, st, scale, [&](int r, int t) {
      const int i = q0 + r, j = k0 + t;
      return i < T_ && j < T_ && j <= i && seg_q[r] == seg_k[t] &&
             (window <= 0 || i - j < window);
    });
  }
  store_rows<T, D>(st, out, qoff);
}

template <typename T, int D>
static cudaError_t run(void* out, const void* q, const void* k, const void* v,
                       const void* seg, int B, int T_, int H, int KV,
                       int window, float scale, cudaStream_t stream) {
  const dim3 grid((T_ + kBQ - 1) / kBQ, H, B);
  return launch(segment_flash_kernel<T, D>, grid, smem_bytes<D>(), stream,
                (T*)out, (const T*)q, (const T*)k, (const T*)v,
                (const int*)seg, T_, H, KV, window, scale);
}

// q, out: (B, T, H, D); k, v: (B, T, KV, D); seg: (B, T) int32; all
// contiguous. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int segment_flash_attention(void* out, const void* q,
                                       const void* k, const void* v,
                                       const void* seg, int B, int T_, int H,
                                       int KV, int D, int window, int dtype,
                                       float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || T_ == 0) return cudaSuccess;
  if (D == 64 && dtype == 0)
    return run<float, 64>(out, q, k, v, seg, B, T_, H, KV, window, scale, s);
  if (D == 64 && dtype == 1)
    return run<__nv_bfloat16, 64>(out, q, k, v, seg, B, T_, H, KV, window,
                                  scale, s);
  if (D == 128 && dtype == 0)
    return run<float, 128>(out, q, k, v, seg, B, T_, H, KV, window, scale, s);
  if (D == 128 && dtype == 1)
    return run<__nv_bfloat16, 128>(out, q, k, v, seg, B, T_, H, KV, window,
                                   scale, s);
  return cudaErrorInvalidValue;
}
