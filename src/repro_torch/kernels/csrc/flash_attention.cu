// Flash attention forward kernels for Hopper (sm_90a): the dense (padded)
// GQA forward and the segment-masked packed prefill. Both TPU kernels live
// in one JAX module, so both ports live in this one file.
//
// 1. flash_attention replaces the TPU kernel
//    src/repro/kernels/flash_attention.py, flash_attention (_flash_kernel).
//    q: (B, S, H, D); k, v: (B, S, KV, D). Token i attends token j iff
//    (causal -> j <= i) and (window > 0 -> i - j < window); non-causal
//    attention without a window sees every key. Query head h reads KV head
//    h * KV / H. S is any prompt length: the kernel masks the ragged edge
//    itself, so every padded prefill on the card goes through it (the TPU
//    needs S to be a multiple of its 512 tile).
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
// tensor cores (tc_attend below). A block is one warpgroup (4 warps) that
// owns 64 query rows, wgmma's M, and walks key tiles of 64 keys. cp.async
// copies Q, K and V 16 bytes at a time into shared memory laid out in
// 1024-byte-aligned slabs of 64 columns with the 128-byte swizzle, the
// layout wgmma's descriptors read. S = Q·K^T is a wgmma with both
// operands in shared memory; O += P·V is a wgmma with P in registers and
// V read transposed from shared memory; both accumulate in f32. The
// online softmax stays in the accumulator fragments (row max and sum by
// shuffles in each quad of lanes, exp2 on the SFU), and P is rounded to
// bf16 in registers: two 8-column accumulator tiles are one A fragment.
// K and V have one buffer each, copied in turn: K(t+1) loads while the
// softmax and P·V of tile t run, V(t+1) while S of tile t+1 runs; 48 KB of
// shared memory at D = 128 lets three blocks share an SM (measured faster
// than two K/V buffers at two blocks per SM). The walk skips every tile
// without a visible pair (it stops at the diagonal when causal and starts
// at the window's first tile); a mask policy marks the tiles that need
// per-element masking (diagonal, window start, ragged edge), so the
// others pay nothing for it. The policy is a functor: bf16
// segment_flash_attention runs the same main loop (segment_tc_kernel)
// under a segment mask whose full() needs two id reads per tile (ids are
// non-decreasing), starting at its segment's first key tile. float32
// inputs (the parity dtype) stay on the f32 FMA tiles of attn_common.cuh
// (fold_tile), whose error stays within 2e-5 where TF32 would not. The
// building blocks (swizzle, cp.async, descriptors, wgmma) live in
// wgmma.cuh, shared with the SSD scan. Not yet done (later work): TMA
// loads with multicast, warp specialisation (a producer warp, consumer
// warpgroups that overlap one's softmax with another's products,
// setmaxnreg) and a persistent schedule: within one warpgroup S, the
// softmax and P·V still run one after another.
#include <cstdint>

#include "attn_common.cuh"
#include "wgmma.cuh"

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(T* __restrict__ out, const T* __restrict__ q,
             const T* __restrict__ k, const T* __restrict__ v, int S, int H,
             int KV, int causal, int window, float scale) {
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
  const int first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int last = causal ? q_last : S - 1;
  for (int kt = first / kBK; kt <= last / kBK; ++kt) {
    const int k0 = kt * kBK;
    load_kv<T, D>(sm, k, v, [&](int t) -> long long {
      const int j = k0 + t;
      return j < S ? (((long long)b * S + j) * KV + g) * D : -1;
    });
    fold_tile<D>(sm, st, scale, [&](int r, int t) {
      const int i = q0 + r, j = k0 + t;
      return i < S && j < S && (!causal || j <= i) &&
             (window <= 0 || i - j < window);
    });
  }
  store_rows<T, D>(st, out, qoff);
}

// --------------------------------------------------------------------------
// bf16 tensor-core main loop
// --------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 64;  // query rows per block: one warpgroup, wgmma's M
constexpr int kBK = 64;  // keys per tile
static_assert(kThreads == 128, "tc_attend runs one warpgroup of 4 warps");
static_assert(kBQ == kBK, "Q and K tiles share their slab offsets");

using namespace wg;

// One block's shared memory: the query tile and one K and one V tile
// (48 KB at D = 128, so three blocks share an SM), each in the swizzled
// slabs of wgmma.cuh.
template <int D>
struct Smem {
  bf16 q[kBQ * D];
  bf16 k[kBK * D];
  bf16 v[kBK * D];
};

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(Smem<D>) + 1024;  // slack to align the base to 1024 bytes
}

// O += P·V for head dim D: the m64nDk16 product of wgmma.cuh
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 8][4],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// Start copying ROWS rows of D bf16 into a swizzled tile: tile row r is
// src + r * stride for r < nvalid, zeros past it (nothing is read there).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int nvalid) {
  constexpr int kCh = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * kCh; idx += kThreads) {
    const int r = idx / kCh, c = idx % kCh;
    const bool ok = r < nvalid;
    cp_async16(dst + swz<ROWS>(r, c), ok ? src + r * stride + c * 8 : src,
               ok);
  }
}

// Attention of one tile of up to kBQ query rows against key tiles
// [kt_begin, kt_end] of kBK keys. Query row r (r < nq) is q + r*q_stride,
// its output out + r*q_stride; key p (p < nkeys) is k + p*kv_stride (and
// v alike). mask.full(k0) says that every pair of the query tile and the
// key tile at k0 is visible; otherwise mask.visible(i, j) decides each
// pair of query r = i - q0 and key j. Rows that see no key are written as
// exact zeros. scale is 1/sqrt(D).
template <int D, class Mask>
__device__ __forceinline__ void tc_attend(bf16* __restrict__ out,
                                          const bf16* __restrict__ q,
                                          long long q_stride, int nq,
                                          const bf16* __restrict__ k,
                                          const bf16* __restrict__ v,
                                          long long kv_stride, int nkeys,
                                          int q0, int kt_begin, int kt_end,
                                          float scale, Mask mask) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const unsigned base = (unsigned)__cvta_generic_to_shared(tc_smem);
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(tc_smem +
                                            ((1024 - (base & 1023)) & 1023));
  constexpr int kNT = kBK / 8;  // 8-key column tiles of S
  constexpr int kDT = D / 8;    // 8-wide column tiles of O
  constexpr int kKS = D / 16;   // 16-deep steps of Q·K^T
  constexpr int kSbo = 8 * 128;                // 8 rows of 128 bytes
  constexpr int kSlabK = kBK * 64;             // elements per K/V slab
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // K(t) and V(t) load as two groups; K(t+1) loads once S(t) has read
  // K(t) and V(t+1) once P·V(t) has read V(t), so each copy overlaps the
  // other product and the softmax
  auto load_k = [&](int kt) {
    const long long k0 = (long long)kt * kBK;
    load_tile<D, kBK>(sm.k, k + k0 * kv_stride, kv_stride, nkeys - (int)k0);
    cp_async_commit();
  };
  auto load_v = [&](int kt) {
    const long long k0 = (long long)kt * kBK;
    load_tile<D, kBK>(sm.v, v + k0 * kv_stride, kv_stride, nkeys - (int)k0);
    cp_async_commit();
  };
  load_tile<D, kBQ>(sm.q, q, q_stride, nq);
  if (kt_begin <= kt_end) {
    load_k(kt_begin);
    load_v(kt_begin);
  }

  // softmax state in the log2 domain (scores times scale * log2 e);
  // in wgmma's accumulator layout warp w holds rows 16w..16w+15 and this
  // lane rows lane/4 (h = 0) and lane/4 + 8 (h = 1) of them, and of every
  // 8-column tile the columns 2(lane%4), +1
  const float sl2 = scale * 1.4426950408889634f;
  float o[kDT][4];
#pragma unroll
  for (int t = 0; t < kDT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const int row_lo = warp * 16 + (lane >> 2);

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    cp_async_wait<1>();  // Q and K(kt) have landed; V(kt) may not have
    // the tile was written through the generic proxy; wgmma reads it
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S = Q·K^T, 64 rows x kBK keys: both operands K-major in shared memory
    float s[kNT][4];
#pragma unroll
    for (int t = 0; t < kNT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int off = (ks >> 2) * kSlabK + (ks & 3) * 16;  // 32 B per step
      wgmma_ss_n64<0>(s, smem_desc(sm.q + off, 16, kSbo),
                   smem_desc(sm.k + off, 16, kSbo));
    }
    wgmma_commit_wait();
    fence_regs(s);
    __syncthreads();  // every warp is done with K(kt)
    if (kt < kt_end) load_k(kt + 1);

    const int k0 = kt * kBK;
    if (!mask.full(k0)) {  // the diagonal, window-start and edge tiles
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + row_lo + (e >> 1) * 8;
          const int j = k0 + t * 8 + (lane & 3) * 2 + (e & 1);
          if (!mask.visible(i, j)) s[t][e] = -CUDART_INF_F;
        }
      }
    }

    // online softmax, one row per h
    float m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < kNT; ++t)
        mx = fmaxf(mx, fmaxf(s[t][2 * h], s[t][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      // the scale is positive, so the max of the raw scores scales to the
      // max of the scaled ones
      const float m_new = fmaxf(m[h], mx * sl2);
      // a row that has seen no key yet keeps 0 as its reference, so that
      // exp2(-inf - ref) is 0 and not NaN
      m_use[h] = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float corr = fast_exp2(m[h] - m_use[h]);
      m[h] = m_new;
      l[h] *= corr;
#pragma unroll
      for (int t = 0; t < kDT; ++t) {
        o[t][2 * h] *= corr;
        o[t][2 * h + 1] *= corr;
      }
    }
    // P as the bf16 A fragments of P·V, 16 keys each: the accumulator
    // layout of two 8-column tiles is the A layout of one 16-deep step
    uint32_t pf[kNT / 2][4];
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      const float p0 = fast_exp2(fmaf(s[t][0], sl2, -m_use[0]));
      const float p1 = fast_exp2(fmaf(s[t][1], sl2, -m_use[0]));
      const float p2 = fast_exp2(fmaf(s[t][2], sl2, -m_use[1]));
      const float p3 = fast_exp2(fmaf(s[t][3], sl2, -m_use[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[t / 2][(t & 1) * 2] = pack_bf16(p0, p1);
      pf[t / 2][(t & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P·V: V (keys x D) is MN-major, its slabs kSlabK apart
    if (kt < kt_end) cp_async_wait<1>(); else cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // V(kt) has landed for every thread's copies
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk)
      wgmma_pv<D>(o, pf[kk], smem_desc(sm.v + kk * 16 * 64, kSlabK * 2, kSbo));
    wgmma_commit_wait();
    fence_regs(o);
    __syncthreads();  // every warp is done with V(kt)
    if (kt < kt_end) load_v(kt + 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    const int r = row_lo + h * 8;
    if (r >= nq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    bf16* dst = out + r * q_stride + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < kDT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(dst + t * 8) =
          __floats2bfloat162_rn(o[t][2 * h] * inv, o[t][2 * h + 1] * inv);
  }
}

// The causal / window / ragged-edge visibility of the dense kernel over a
// query tile of rows [q0, q_last].
struct DenseMask {
  int q0, q_last, S, causal, window;
  __device__ __forceinline__ bool full(int k0) const {
    return k0 + kBK <= S && (!causal || k0 + kBK - 1 <= q0) &&
           (window <= 0 || q_last - k0 < window);
  }
  __device__ __forceinline__ bool visible(int i, int j) const {
    return j < S && (!causal || j <= i) && (window <= 0 || i - j < window);
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

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
flash_tc_kernel(__nv_bfloat16* __restrict__ out,
                const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, int S, int H, int KV,
                int causal, int window, float scale) {
  // the last query tiles see the most keys when causal: they start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * tc::kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h * KV / H;
  const int q_last = min(q0 + tc::kBQ, S) - 1;
  // keys [first, last], as in flash_kernel
  const int first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int last = causal ? q_last : S - 1;
  const long long q_stride = (long long)H * D, kv_stride = (long long)KV * D;
  const long long qo = (((long long)b * S + q0) * H + h) * D;
  const long long ko = ((long long)b * S * KV + g) * D;
  tc::tc_attend<D>(out + qo, q + qo, q_stride, S - q0, k + ko, v + ko,
                   kv_stride, S, q0, first / tc::kBK, last / tc::kBK, scale,
                   tc::DenseMask{q0, q_last, S, causal, window});
}

template <int D>
static cudaError_t run_dense_tc(void* out, const void* q, const void* k,
                                const void* v, int B, int S, int H, int KV,
                                int causal, int window, float scale,
                                cudaStream_t stream) {
  const dim3 grid((S + tc::kBQ - 1) / tc::kBQ, H, B);
  return launch(flash_tc_kernel<D>, grid, tc::smem_bytes<D>(), stream,
                (__nv_bfloat16*)out, (const __nv_bfloat16*)q,
                (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, S, H, KV,
                causal, window, scale);
}

template <typename T, int D>
static cudaError_t run_dense(void* out, const void* q, const void* k,
                             const void* v, int B, int S, int H, int KV,
                             int causal, int window, float scale,
                             cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  return launch(flash_kernel<T, D>, grid, smem_bytes<D>(), stream, (T*)out,
                (const T*)q, (const T*)k, (const T*)v, S, H, KV, causal,
                window, scale);
}

// q, out: (B, S, H, D); k, v: (B, S, KV, D); all contiguous. causal: 0/1;
// window: 0 = none. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError().
extern "C" int flash_attention(void* out, const void* q, const void* k,
                               const void* v, int B, int S, int H, int KV,
                               int D, int causal, int window, int dtype,
                               float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || S == 0) return cudaSuccess;
  if (D == 64 && dtype == 0)
    return run_dense<float, 64>(out, q, k, v, B, S, H, KV, causal, window,
                                scale, s);
  if (D == 64 && dtype == 1)
    return run_dense_tc<64>(out, q, k, v, B, S, H, KV, causal, window, scale,
                            s);
  if (D == 128 && dtype == 0)
    return run_dense<float, 128>(out, q, k, v, B, S, H, KV, causal, window,
                                 scale, s);
  if (D == 128 && dtype == 1)
    return run_dense_tc<128>(out, q, k, v, B, S, H, KV, causal, window,
                             scale, s);
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
  tc::tc_attend<D>(out + qo, q + qo, q_stride, T_ - q0, k + ko, v + ko,
                   kv_stride, T_, q0, first / tc::kBK, q_last / tc::kBK,
                   scale, tc::SegMask{segb, q0, q_last, T_, window});
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
  return cudaErrorInvalidValue;
}
