// Flash attention forward kernels for Hopper (sm_90a): the dense (padded)
// GQA forward and the segment-masked packed prefill. Both TPU kernels live
// in one JAX module, so both ports live in this one file.
//
// 1. flash_attention replaces the TPU kernel
//    src/repro/kernels/flash_attention.py, flash_attention (_flash_kernel).
//    q: (B, S, H, D); k, v: (B, Sk, KV, D). Query row i stands at position
//    p = i + q_offset, and attends token j iff (causal -> j <= p) and
//    (window > 0 -> p - j < window); non-causal attention without a
//    window sees every key. Query head h reads KV head h * KV / H. S and
//    Sk are any lengths: the kernel masks the ragged edges itself, so
//    every padded prefill on the card goes through it (the TPU needs S to
//    be a multiple of its 512 tile). Causal or windowed attention needs
//    q_offset + S <= Sk: Sk == S at offset 0 (a whole sequence), or one
//    context-parallel shard of the queries over the whole sequence's
//    keys (layers.cp_attention); without either, any Sk
//    (cross-attention: decoder queries over encoder frames).
//
// 2. segment_flash_attention replaces the TPU kernel
//    src/repro/kernels/flash_attention.py, segment_flash_attention
//    (_segment_flash_kernel). A packed row concatenates the prompts of one
//    admission batch; seg[b, i] is the (non-decreasing) segment id of token
//    i, padding tokens carry an id no prompt uses. Token i attends token j
//    iff seg[i] == seg[j], j <= i, and, when window > 0, i - j < window. T
//    is any packed bucket (3·2^k as well as 2^k).
//
// What bounds them on this card: operations. A query tile reuses every key
// it loads once per row, so at prompt lengths of hundreds of tokens the
// QK^T and PV products dominate; their floor is 4·pairs·D flops per head
// over the 989 TFLOP/s bf16 tensor-core peak.
//
// What the design does about it. bf16 flash_attention runs on Hopper's
// tensor cores through tc_attend (tc_attend.cuh): one warpgroup per 64
// query rows walks 64-key tiles with wgmma products and an online softmax
// in the accumulator fragments; the walk skips every tile without a
// visible pair (it stops at the diagonal when causal and starts at the
// window's first tile), and a mask policy marks the tiles that need
// per-element masking (diagonal, window start, ragged edge), so the
// others pay nothing for it. bf16 segment_flash_attention runs the same
// body (segment_tc_kernel) under a segment mask whose full() needs two id
// reads per tile (ids are non-decreasing), starting at its segment's first
// key tile. Both read their keys through tc::StridedKeys. float32 inputs
// (the parity dtype) stay on the f32 FMA tiles of attn_common.cuh
// (fold_tile), whose error stays within 2e-5 where TF32 would not.
//
// Head dims: 64, 128 and 112 (zamba2-7b's shared attention), in both
// types. At 112 both bodies run at a padded width on chip (32-lane rows
// in f32, 64-column slabs in bf16) and read and write only the 112
// columns in device memory, so their bytes stay those of D 112.
#include <cstdint>

#include "attn_common.cuh"
#include "tc_attend.cuh"

using namespace attn;

// Row i's log-sum-exp of its scaled scores, m + log l, at lse[i] for the
// rows of the query tile at q0 below S (-1e30 for a row that saw no key):
// the training path's forward saves it for the backward.
template <int D>
__device__ __forceinline__ void store_lse(const RowState<D>& st,
                                          float* __restrict__ lse, int q0,
                                          int S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane != 0) return;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = q0 + warp * kRowsPerWarp + rr;
    if (i < S) lse[i] = st.l[rr] > 0.f ? st.m[rr] + logf(st.l[rr]) : -1e30f;
  }
}

// kLse: the training path's instantiation, which also stores each row's
// log-sum-exp; serving runs the one without, whose code has no trace of it
template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_kernel(T* __restrict__ out, float* __restrict__ lse,
             const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, int S, int Sk, int H, int KV,
             int causal, int window, int q_offset, float scale) {
  Smem<D>& sm = smem<D>();
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h * KV / H;
  const int q_last = min(q0 + kBQ, S) - 1;
  auto qoff = [&](int r) -> long long {
    const int i = q0 + r;
    return i < S ? (((long long)b * S + i) * H + h) * D : -1;
  };
  load_q<T, D>(sm, q, qoff);

  RowState<D> st;
  st.init();
  // keys [first, last]: a window starts the walk at the oldest key the
  // tile's first query still sees, causality ends it at the diagonal
  // (both at the rows' positions, q_offset on)
  const int first = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int last = causal ? min(q_last + q_offset, Sk - 1) : Sk - 1;
  for (int kt = first / kBK; kt <= last / kBK; ++kt) {
    const int k0 = kt * kBK;
    load_kv<T, D>(sm, k, v, [&](int t) -> long long {
      const int j = k0 + t;
      return j < Sk ? (((long long)b * Sk + j) * KV + g) * D : -1;
    });
    fold_tile<D>(sm, st, scale, [&](int r, int t) {
      const int p = q0 + r + q_offset, j = k0 + t;
      return q0 + r < S && j < Sk && (!causal || j <= p) &&
             (window <= 0 || p - j < window);
    });
  }
  store_rows<T, D>(st, out, qoff);
  if constexpr (kLse)
    store_lse<D>(st, lse + ((long long)b * H + h) * S, q0, S);
}

namespace tc {

// The causal / window / ragged-edge visibility of the dense kernel over a
// query tile at positions [q0, q_last] (its rows shifted by q_offset) and
// Sk keys.
struct DenseMask {
  int q0, q_last, Sk, causal, window;
  __device__ __forceinline__ bool full(int k0) const {
    return k0 + kBK <= Sk && (!causal || k0 + kBK - 1 <= q0) &&
           (window <= 0 || q_last - k0 < window);
  }
  __device__ __forceinline__ bool visible(int i, int j) const {
    return j < Sk && (!causal || j <= i) && (window <= 0 || i - j < window);
  }
};

// The segment visibility of the packed kernel over a query tile of rows
// [q0, q_last]: token i attends j iff both lie below T, their segment ids
// are equal, j <= i, and i - j < window when a window is given. Segment
// ids are non-decreasing, so a key tile lies wholly in the query tile's
// segment iff its first key shares the id of the tile's last query; it
// is then full when it also lies below the diagonal and inside the
// window. Ids go through the read-only cache.
struct SegMask {
  const int* __restrict__ seg;  // this row's T segment ids
  int q0, q_last, T, window;
  __device__ __forceinline__ bool full(int k0) const {
    return k0 + kBK - 1 <= q0 && __ldg(seg + k0) == __ldg(seg + q_last) &&
           (window <= 0 || q_last - k0 < window);
  }
  __device__ __forceinline__ bool visible(int i, int j) const {
    return i < T && j <= i && (window <= 0 || i - j < window) &&
           __ldg(seg + i) == __ldg(seg + j);
  }
};

}  // namespace tc

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 3)
flash_tc_kernel(__nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, int S, int Sk, int H,
                int KV, int causal, int window, int q_offset, float scale) {
  // the last query tiles see the most keys when causal: they start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * tc::kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h * KV / H;
  const int q_last = min(q0 + tc::kBQ, S) - 1;
  // the tile's positions, and keys [first, last], as in flash_kernel
  const int p0 = q0 + q_offset, p_last = q_last + q_offset;
  const int first = window > 0 ? max(0, p0 - window + 1) : 0;
  const int last = causal ? min(p_last, Sk - 1) : Sk - 1;
  const long long q_stride = (long long)H * D, kv_stride = (long long)KV * D;
  const long long qo = (((long long)b * S + q0) * H + h) * D;
  const long long ko = ((long long)b * Sk * KV + g) * D;
  tc::tc_attend<D>(out + qo, q + qo, q_stride, S - q0,
                   tc::StridedKeys<D>{k + ko, v + ko, kv_stride, Sk}, p0,
                   first / tc::kBK, last / tc::kBK, scale,
                   tc::DenseMask{p0, p_last, Sk, causal, window},
                   kLse ? lse + ((long long)b * H + h) * S + q0 : nullptr);
}

template <int D>
static cudaError_t run_dense_tc(void* out, void* lse, const void* q,
                                const void* k, const void* v, int B, int S,
                                int Sk, int H, int KV, int causal, int window,
                                int q_offset, float scale,
                                cudaStream_t stream) {
  const dim3 grid((S + tc::kBQ - 1) / tc::kBQ, H, B);
  return launch(lse ? flash_tc_kernel<D, true> : flash_tc_kernel<D, false>,
                grid, tc::smem_bytes<D>(), stream,
                (__nv_bfloat16*)out, (float*)lse, (const __nv_bfloat16*)q,
                (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, S, Sk, H,
                KV, causal, window, q_offset, scale);
}

template <typename T, int D>
static cudaError_t run_dense(void* out, void* lse, const void* q,
                             const void* k, const void* v, int B, int S,
                             int Sk, int H, int KV, int causal, int window,
                             int q_offset, float scale, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  return launch(lse ? flash_kernel<T, D, true> : flash_kernel<T, D, false>,
                grid, smem_bytes<D>(), stream, (T*)out,
                (float*)lse, (const T*)q, (const T*)k, (const T*)v, S, Sk, H,
                KV, causal, window, q_offset, scale);
}

// q, out: (B, S, H, D); k, v: (B, Sk, KV, D); all contiguous. lse: null,
// or (B, H, S) float32 for each row's log-sum-exp (the training path).
// causal: 0/1; window: 0 = none; q_offset: the position of query row 0;
// with either, 0 <= q_offset and q_offset + S <= Sk. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError().
extern "C" int flash_attention(void* out, void* lse, const void* q,
                               const void* k, const void* v, int B, int S,
                               int Sk, int H, int KV, int D, int causal,
                               int window, int q_offset, int dtype,
                               float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || S == 0) return cudaSuccess;
  if ((causal || window > 0) && (q_offset < 0 || q_offset + S > Sk))
    return cudaErrorInvalidValue;
  if (D == 64 && dtype == 0)
    return run_dense<float, 64>(out, lse, q, k, v, B, S, Sk, H, KV, causal,
                                window, q_offset, scale, s);
  if (D == 64 && dtype == 1)
    return run_dense_tc<64>(out, lse, q, k, v, B, S, Sk, H, KV, causal, window,
                            q_offset, scale, s);
  if (D == 128 && dtype == 0)
    return run_dense<float, 128>(out, lse, q, k, v, B, S, Sk, H, KV, causal,
                                 window, q_offset, scale, s);
  if (D == 128 && dtype == 1)
    return run_dense_tc<128>(out, lse, q, k, v, B, S, Sk, H, KV, causal, window,
                             q_offset, scale, s);
  if (D == 112 && dtype == 0)
    return run_dense<float, 112>(out, lse, q, k, v, B, S, Sk, H, KV, causal,
                                 window, q_offset, scale, s);
  if (D == 112 && dtype == 1)
    return run_dense_tc<112>(out, lse, q, k, v, B, S, Sk, H, KV, causal, window,
                             q_offset, scale, s);
  return cudaErrorInvalidValue;
}

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

// The bf16 segment kernel on tc_attend: one warpgroup per 64 query rows
// of one (row, head); its key tiles run from the first key of the
// segment of query q0 (binary search; clipped by the window) to the
// diagonal tile. The name must not contain the dense kernel's, whose
// SASS the checks select by name.
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
segment_tc_kernel(__nv_bfloat16* __restrict__ out,
                  const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ seg, int T_, int H, int KV,
                  int window, float scale) {
  const int q0 = blockIdx.x * tc::kBQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h * KV / H;
  const int* segb = seg + (long long)b * T_;
  const int q_last = min(q0 + tc::kBQ, T_) - 1;
  // first token of the segment that query q0 belongs to
  const int sid = __ldg(segb + q0);
  int lo = 0, hi = q0;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(segb + mid) < sid) lo = mid + 1; else hi = mid;
  }
  const int first = window > 0 ? max(lo, q0 - window + 1) : lo;
  const long long q_stride = (long long)H * D, kv_stride = (long long)KV * D;
  const long long qo = (((long long)b * T_ + q0) * H + h) * D;
  const long long ko = ((long long)b * T_ * KV + g) * D;
  tc::tc_attend<D>(out + qo, q + qo, q_stride, T_ - q0,
                   tc::StridedKeys<D>{k + ko, v + ko, kv_stride, T_}, q0,
                   first / tc::kBK, q_last / tc::kBK, scale,
                   tc::SegMask{segb, q0, q_last, T_, window});
}

template <int D>
static cudaError_t run_segment_tc(void* out, const void* q, const void* k,
                                  const void* v, const void* seg, int B,
                                  int T_, int H, int KV, int window,
                                  float scale, cudaStream_t stream) {
  const dim3 grid((T_ + tc::kBQ - 1) / tc::kBQ, H, B);
  return launch(segment_tc_kernel<D>, grid, tc::smem_bytes<D>(), stream,
                (__nv_bfloat16*)out, (const __nv_bfloat16*)q,
                (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
                (const int*)seg, T_, H, KV, window, scale);
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
    return run_segment_tc<64>(out, q, k, v, seg, B, T_, H, KV, window, scale,
                              s);
  if (D == 128 && dtype == 0)
    return run<float, 128>(out, q, k, v, seg, B, T_, H, KV, window, scale, s);
  if (D == 128 && dtype == 1)
    return run_segment_tc<128>(out, q, k, v, seg, B, T_, H, KV, window,
                               scale, s);
  if (D == 112 && dtype == 0)
    return run<float, 112>(out, q, k, v, seg, B, T_, H, KV, window, scale, s);
  if (D == 112 && dtype == 1)
    return run_segment_tc<112>(out, q, k, v, seg, B, T_, H, KV, window,
                               scale, s);
  return cudaErrorInvalidValue;
}
