// Tile machinery shared by the float32 attention bodies of the port that
// run on the CUDA cores: the float32 chunk kernel (chunk_attention.cu)
// and the float32 segment and dense flash kernels (flash_attention.cu).
// Their bf16 versions run the tensor-core body of tc_attend.cuh, and both
// decode kernels (decode_attention.cu, paged_attention.cu) the split-K
// body of decode_split.cuh; those build on the helpers here (to_f, from_f,
// kThreads, launch, PageMap).
//
// Every kernel that runs this machinery computes, for a tile of up to kBQ
// query rows, an online (flash-style) softmax over a sequence of key tiles
// of kBK keys each. The kernels differ only in where a query row and a key
// row live in device memory (a padded or packed row, a paged cache, a
// chunk) and in which (query, key) pairs are visible (a causal or segment
// mask, a length, a window); both are passed in as small device lambdas.
//
// Layout of the work inside a block of kThreads = 128 threads:
//   * the query tile and one key/value tile sit in shared memory as f32;
//   * warp w owns query rows [w*kRowsPerWarp, (w+1)*kRowsPerWarp);
//   * for one row, lane t scores key t of the tile (a dot product over D
//     read from shared memory: the query row is a broadcast, key rows are
//     padded to D+1 floats so the 32 lanes hit 32 banks), the warp reduces
//     the row max and sum with shuffles, and each lane accumulates
//     padded_dim<D>()/32 output dimensions of P·V in registers (a head dim
//     that is no multiple of 32, zamba2's 112, runs at the next multiple:
//     the value tile's extra columns are zeros and are never stored);
//   * the running max m, sum l and accumulator stay in f32 registers for
//     the whole key loop; the output is acc / max(l, 1e-30), so a row that
//     saw no visible key is written as exact zeros.
// Both products (QK^T and PV) are computed here in f32 FMAs on the CUDA
// cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per tile
constexpr int kBK = 32;                     // keys per tile: one per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// D rounded up to whole 32-lane rows: the output dimensions a warp's
// lanes hold for one row
template <int D>
__host__ __device__ constexpr int padded_dim() {
  return (D + 31) / 32 * 32;
}

// Shared memory of one block; above 48 KB for D = 128, so it is dynamic
// shared memory and the launcher raises the kernel's limit first. Value
// columns [D, padded_dim<D>()) hold zeros.
template <int D>
struct Smem {
  float q[kBQ][D];
  float k[kBK][D + 1];
  float v[kBK][padded_dim<D>()];
  long long koff[kBK];  // element offset of each key row; -1 = no key
};

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(Smem<D>);
}

template <int D>
__device__ __forceinline__ Smem<D>& smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return *reinterpret_cast<Smem<D>*>(smem_raw);
}

// Online-softmax state of the kRowsPerWarp rows a warp owns.
template <int D>
struct RowState {
  static constexpr int kDPL = padded_dim<D>() / 32;  // dims per lane
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][kDPL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      m[rr] = -CUDART_INF_F;
      l[rr] = 0.f;
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[rr][i] = 0.f;
    }
  }
};

// Load the query tile. qoff(r) is the element offset of tile row r, or -1
// for a row outside the tile (it is then zero-filled and never stored).
// The caller synchronises before the tile is read.
template <typename T, int D, class QOff>
__device__ __forceinline__ void load_q(Smem<D>& sm, const T* __restrict__ q,
                                       QOff qoff) {
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const long long off = qoff(r);
    sm.q[r][d] = off >= 0 ? to_f(q[off + d]) : 0.f;
  }
}

// Load one key/value tile. koff(t) runs once per key (threads 0..kBK-1)
// and returns the element offset of key t in k and v, or -1 for no key; it
// may also record per-key metadata in shared memory. Synchronises before
// (the previous tile may still be read) and after.
template <typename T, int D, class KOff>
__device__ __forceinline__ void load_kv(Smem<D>& sm, const T* __restrict__ k,
                                        const T* __restrict__ v, KOff koff) {
  __syncthreads();
  if (threadIdx.x < kBK) sm.koff[threadIdx.x] = koff(threadIdx.x);
  __syncthreads();
  constexpr int kDP = padded_dim<D>();
  for (int idx = threadIdx.x; idx < kBK * kDP; idx += kThreads) {
    const int t = idx / kDP, d = idx % kDP;
    const long long off = sm.koff[t];
    const bool ok = off >= 0 && d < D;
    if (d < D) sm.k[t][d] = ok ? to_f(k[off + d]) : 0.f;
    sm.v[t][d] = ok ? to_f(v[off + d]) : 0.f;
  }
  __syncthreads();
}

// Fold the key tile in shared memory into the warp's rows. visible(r, t)
// says whether tile row r may attend tile key t.
template <int D, class Visible>
__device__ __forceinline__ void fold_tile(Smem<D>& sm, RowState<D>& st,
                                          float scale, Visible visible) {
  constexpr int kDPL = padded_dim<D>() / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // fully unrolled: the row state must stay in registers
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    float s = -CUDART_INF_F;
    if (visible(r, lane)) {
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(sm.q[r][d], sm.k[lane][d], dot);
      s = dot * scale;
    }
    const float tile_max = warp_max(s);
    if (tile_max == -CUDART_INF_F) continue;  // row sees nothing here
    const float m_new = fmaxf(st.m[rr], tile_max);
    const float p = expf(s - m_new);              // exp(-inf) = 0
    const float corr = expf(st.m[rr] - m_new);    // first tile: 0
    st.l[rr] = st.l[rr] * corr + warp_sum(p);
    st.m[rr] = m_new;
    float a[kDPL];
#pragma unroll
    for (int i = 0; i < kDPL; ++i) a[i] = st.acc[rr][i] * corr;
#pragma unroll 8
    for (int t = 0; t < kBK; ++t) {
      const float pt = __shfl_sync(kFull, p, t);
#pragma unroll
      for (int i = 0; i < kDPL; ++i) a[i] = fmaf(pt, sm.v[t][lane + 32 * i], a[i]);
    }
#pragma unroll
    for (int i = 0; i < kDPL; ++i) st.acc[rr][i] = a[i];
  }
}

// Write the warp's rows: ooff(r) is the element offset of tile row r in
// out, or -1 for a row outside the tile.
template <typename T, int D, class OOff>
__device__ __forceinline__ void store_rows(const RowState<D>& st,
                                           T* __restrict__ out, OOff ooff) {
  constexpr int kDPL = padded_dim<D>() / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const long long off = ooff(warp * kRowsPerWarp + rr);
    if (off < 0) continue;
    const float denom = fmaxf(st.l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (D % 32 == 0 || d < D) out[off + d] = from_f<T>(st.acc[rr][i] / denom);
    }
  }
}

// Where logical token p of one block-table row lives in a paged pool
// (P, page_size, KV, D): the element offset of its key (and value) row of
// KV head g is trow[p / page_size] * page_stride + (p % page_size) *
// tok_stride + g * D, where the caller has folded g * D into the pool
// pointer. Only table entry p / page_size is read, so a caller that asks
// for p < n reads no entry at or past ceil(n / page_size). page_shift is
// log2(page_size) when the page size is a power of two (a shift and a
// mask then replace the integer division), else -1.
struct PageMap {
  const int* __restrict__ trow;  // this row's block-table entries
  long long page_stride, tok_stride;
  int page_size, page_shift;
  __device__ __forceinline__ long long operator()(int p) const {
    const int j = page_shift >= 0 ? p >> page_shift : p / page_size;
    const int o = page_shift >= 0 ? p & (page_size - 1) : p - j * page_size;
    return (long long)__ldg(trow + j) * page_stride + o * tok_stride;
  }
};

// log2(page_size) for a power of two, else -1 (PageMap::page_shift)
inline int page_shift_of(int page_size) {
  int shift = 0;
  while ((1 << shift) < page_size) ++shift;
  return (1 << shift) == page_size ? shift : -1;
}

// Raise the kernel's dynamic shared memory limit and launch it.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace attn
