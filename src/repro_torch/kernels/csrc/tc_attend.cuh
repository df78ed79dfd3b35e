// The bf16 tensor-core attention body of the port on Hopper (sm_90a):
// tc_attend, one warpgroup's online-softmax attention of up to 64 query
// rows over a walk of 64-key tiles. It runs the bf16 dense flash kernel
// and the bf16 segment flash kernel (flash_attention.cu), and the bf16
// chunk kernel over a paged history (chunk_attention.cu). The kernels
// differ in where a key row lies (a Keys source: StridedKeys for a packed
// or padded row, a block-table walk for the chunk kernel) and in which
// (query, key) pairs are visible (a Mask policy); both are small objects
// passed in.
//
// The design. A block is one warpgroup (4 warps) that owns 64 query rows,
// wgmma's M, and walks key tiles of 64 keys. cp.async copies Q, K and V 16
// bytes at a time into shared memory laid out in 1024-byte-aligned slabs
// of 64 columns with the 128-byte swizzle, the layout wgmma's descriptors
// read. S = Q·K^T is a wgmma with both operands in shared memory; O += P·V
// is a wgmma with P in registers and V read transposed from shared memory;
// both accumulate in f32. The online softmax stays in the accumulator
// fragments (row max and sum by shuffles in each quad of lanes, exp2 on
// the SFU), and P is rounded to bf16 in registers: two 8-column
// accumulator tiles are one A fragment. K and V have one buffer each,
// copied in turn: K(t+1) loads while the softmax and P·V of tile t run,
// V(t+1) while S of tile t+1 runs; 48 KB of shared memory at D = 128 lets
// three blocks share an SM (measured faster than two K/V buffers at two
// blocks per SM). The caller gives the walk's first and last key tile, so
// tiles without a visible pair are never loaded; the mask marks the tiles
// that need per-element masking (diagonal, window start, ragged edge), so
// the others pay nothing for it. Every copy into shared memory, a paged
// one included, is a cp.async, so one proxy fence before each barrier that
// precedes a wgmma read covers them all. The building blocks (swizzle,
// cp.async, descriptors, wgmma) live in wgmma.cuh, shared with the SSD
// scan. A head dim that is no multiple of 64 (zamba2's 112) runs at the
// next one (tile_dim): the copies read only its D columns from device
// memory and fill the rest with zeros, which add nothing to Q·K^T (whose
// last zero step is skipped) and give output columns that are never
// stored. Not yet done (later work): TMA loads with multicast, warp
// specialisation (a producer warp, consumer warpgroups that overlap one's
// softmax with another's products, setmaxnreg) and a persistent schedule:
// within one warpgroup S, the softmax and P·V still run one after another.
#pragma once

#include <cstdint>

#include "attn_common.cuh"
#include "wgmma.cuh"

namespace tc {

using attn::kFull;
using attn::kThreads;

constexpr int kBQ = 64;  // query rows per block: one warpgroup, wgmma's M
constexpr int kBK = 64;  // keys per tile
static_assert(kThreads == 128, "tc_attend runs one warpgroup of 4 warps");
static_assert(kBQ == kBK, "Q and K tiles share their slab offsets");

using namespace wg;

// D rounded up to whole 64-column slabs: the width of the tiles in
// shared memory and of the P·V product
template <int D>
__host__ __device__ constexpr int tile_dim() {
  return (D + 63) / 64 * 64;
}

// One block's shared memory: the query tile and one K and one V tile
// (48 KB at D = 128, so three blocks share an SM), each in the swizzled
// slabs of wgmma.cuh, tile_dim<D>() columns wide.
template <int D>
struct Smem {
  bf16 q[kBQ * tile_dim<D>()];
  bf16 k[kBK * tile_dim<D>()];
  bf16 v[kBK * tile_dim<D>()];
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

// Start copying ROWS rows of D bf16 into a swizzled tile of tile_dim<D>()
// columns: tile row r is src + r * stride for r < nvalid, zeros past it
// and in the columns past D (nothing is read there).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int nvalid) {
  constexpr int kCh = D / 8, kChT = tile_dim<D>() / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChT; idx += kThreads) {
    const int r = idx / kChT, c = idx % kChT;
    const bool ok = r < nvalid && (kCh == kChT || c < kCh);
    cp_async16(dst + swz<ROWS>(r, c), ok ? src + r * stride + c * 8 : src,
               ok);
  }
}

// The same through an address hook: tile row r is row(r), or zeros where
// row(r) is null (nothing is read there; the copy names `any`, a valid
// address, instead).
template <int D, int ROWS, class Row>
__device__ __forceinline__ void load_rows(bf16* dst, Row row,
                                          const bf16* any) {
  static_assert(D % 64 == 0, "load_rows fills whole slabs");
  constexpr int kCh = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * kCh; idx += kThreads) {
    const int r = idx / kCh, c = idx % kCh;
    const bf16* src = row(r);
    cp_async16(dst + swz<ROWS>(r, c), src ? src + c * 8 : any,
               src != nullptr);
  }
}

// The keys of a packed or padded row: key j < n of K is k + j * stride,
// of V v + j * stride.
template <int D>
struct StridedKeys {
  const bf16* __restrict__ k;
  const bf16* __restrict__ v;
  long long stride;
  int n;
  __device__ __forceinline__ void load_k(bf16* dst, long long k0) const {
    load_tile<D, kBK>(dst, k + k0 * stride, stride, n - (int)k0);
  }
  __device__ __forceinline__ void load_v(bf16* dst, long long k0) const {
    load_tile<D, kBK>(dst, v + k0 * stride, stride, n - (int)k0);
  }
};

// Attention of one tile of up to kBQ query rows against key tiles
// [kt_begin, kt_end] of kBK keys. Query row r (r < nq) is q + r*q_stride,
// its output out + r*q_stride; keys.load_k(dst, k0) and keys.load_v(dst,
// k0) start the copies of the key tile at k0 (zeros for keys that do not
// exist). mask.full(k0) says that every pair of the query tile and the
// key tile at k0 is visible; otherwise mask.visible(i, j) decides each
// pair of query r = i - q0 and key j. Rows that see no key are written as
// exact zeros; rows r >= nq are not written. scale is 1/sqrt(D).
template <int D, class Keys, class Mask>
__device__ __forceinline__ void tc_attend(bf16* __restrict__ out,
                                          const bf16* __restrict__ q,
                                          long long q_stride, int nq,
                                          const Keys& keys, int q0,
                                          int kt_begin, int kt_end,
                                          float scale, Mask mask) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const unsigned base = (unsigned)__cvta_generic_to_shared(tc_smem);
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(tc_smem +
                                            ((1024 - (base & 1023)) & 1023));
  constexpr int kDW = tile_dim<D>();  // columns of the tiles and of O
  static_assert(D % 16 == 0 && (kDW == 64 || kDW == 128), "head dim");
  constexpr int kNT = kBK / 8;  // 8-key column tiles of S
  constexpr int kDT = kDW / 8;  // 8-wide column tiles of O
  constexpr int kKS = D / 16;   // 16-deep steps of Q·K^T (zeros past D)
  constexpr int kSbo = 8 * 128;                // 8 rows of 128 bytes
  constexpr int kSlabK = kBK * 64;             // elements per K/V slab
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // K(t) and V(t) load as two groups; K(t+1) loads once S(t) has read
  // K(t) and V(t+1) once P·V(t) has read V(t), so each copy overlaps the
  // other product and the softmax
  auto load_k = [&](int kt) {
    keys.load_k(sm.k, (long long)kt * kBK);
    cp_async_commit();
  };
  auto load_v = [&](int kt) {
    keys.load_v(sm.v, (long long)kt * kBK);
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
      wgmma_pv<kDW>(o, pf[kk],
                    smem_desc(sm.v + kk * 16 * 64, kSlabK * 2, kSbo));
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
    for (int t = 0; t < D / 8; ++t)  // O's columns past D are not stored
      *reinterpret_cast<__nv_bfloat162*>(dst + t * 8) =
          __floats2bfloat162_rn(o[t][2 * h] * inv, o[t][2 * h + 1] * inv);
  }
}

}  // namespace tc
