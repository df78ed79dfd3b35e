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
// others pay nothing for it. The policy is a functor, so the segment
// kernel can move onto the same main loop. float32 inputs (the parity
// dtype) and the segment kernel stay on the f32 FMA tiles of
// attn_common.cuh (fold_tile), whose error stays within 2e-5 where TF32
// would not. Not yet done (later work): TMA loads with multicast, warp
// specialisation (a producer warp, consumer warpgroups that overlap one's
// softmax with another's products, setmaxnreg) and a persistent
// schedule: within one warpgroup S, the softmax and P·V still run one
// after another.
#include <cstdint>

#include "attn_common.cuh"

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

typedef __nv_bfloat16 bf16;

// A tile of ROWS rows of D bf16 lies in shared memory as D / 64 slabs of
// ROWS rows x 64 elements (128-byte rows). Chunk c (16 bytes) of row r
// sits in slab c / 8 at chunk position (c % 8) ^ (r % 8): the 128-byte
// swizzle that wgmma's descriptors name, which also spreads the 8 rows of
// an 8-row group over all banks. Slabs start on 1024-byte boundaries.
template <int ROWS>
__device__ __forceinline__ int swz(int row, int chunk) {
  return (chunk >> 3) * (ROWS * 64) + row * 64 +
         (((chunk & 7) ^ (row & 7)) << 3);
}

// One block's shared memory: the query tile and one K and one V tile
// (48 KB at D = 128, so three blocks share an SM).
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: nothing read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets, 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(const bf16* p, int lbo,
                                              int sbo) {
  const uint64_t a = (unsigned)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[i][e])::"memory");
}

// S += A·B^T with A (64 x 16) and B (64 x 16) both K-major in shared
// memory; s: the 64 x 64 f32 accumulator fragment.
__device__ __forceinline__ void wgmma_ss_n64(float (&s)[8][4], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(s[0][0]), "+f"(s[0][1]), "+f"(s[0][2]), "+f"(s[0][3]),
        "+f"(s[1][0]), "+f"(s[1][1]), "+f"(s[1][2]), "+f"(s[1][3]),
        "+f"(s[2][0]), "+f"(s[2][1]), "+f"(s[2][2]), "+f"(s[2][3]),
        "+f"(s[3][0]), "+f"(s[3][1]), "+f"(s[3][2]), "+f"(s[3][3]),
        "+f"(s[4][0]), "+f"(s[4][1]), "+f"(s[4][2]), "+f"(s[4][3]),
        "+f"(s[5][0]), "+f"(s[5][1]), "+f"(s[5][2]), "+f"(s[5][3]),
        "+f"(s[6][0]), "+f"(s[6][1]), "+f"(s[6][2]), "+f"(s[6][3]),
        "+f"(s[7][0]), "+f"(s[7][1]), "+f"(s[7][2]), "+f"(s[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// O += P·V with P (64 x 16 bf16) in registers (the A fragment) and V
// (16 x 64) MN-major in shared memory (transposed B); o: the 64 x 64 f32
// accumulator fragment.
__device__ __forceinline__ void wgmma_rs_n64(float (&o)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(o[0][0]), "+f"(o[0][1]), "+f"(o[0][2]), "+f"(o[0][3]),
        "+f"(o[1][0]), "+f"(o[1][1]), "+f"(o[1][2]), "+f"(o[1][3]),
        "+f"(o[2][0]), "+f"(o[2][1]), "+f"(o[2][2]), "+f"(o[2][3]),
        "+f"(o[3][0]), "+f"(o[3][1]), "+f"(o[3][2]), "+f"(o[3][3]),
        "+f"(o[4][0]), "+f"(o[4][1]), "+f"(o[4][2]), "+f"(o[4][3]),
        "+f"(o[5][0]), "+f"(o[5][1]), "+f"(o[5][2]), "+f"(o[5][3]),
        "+f"(o[6][0]), "+f"(o[6][1]), "+f"(o[6][2]), "+f"(o[6][3]),
        "+f"(o[7][0]), "+f"(o[7][1]), "+f"(o[7][2]), "+f"(o[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// O += P·V with P (64 x 16 bf16) in registers (the A fragment) and V
// (16 x 128) MN-major in shared memory (transposed B); o: the 64 x 128 f32
// accumulator fragment.
__device__ __forceinline__ void wgmma_rs_n128(float (&o)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(o[0][0]), "+f"(o[0][1]), "+f"(o[0][2]), "+f"(o[0][3]),
        "+f"(o[1][0]), "+f"(o[1][1]), "+f"(o[1][2]), "+f"(o[1][3]),
        "+f"(o[2][0]), "+f"(o[2][1]), "+f"(o[2][2]), "+f"(o[2][3]),
        "+f"(o[3][0]), "+f"(o[3][1]), "+f"(o[3][2]), "+f"(o[3][3]),
        "+f"(o[4][0]), "+f"(o[4][1]), "+f"(o[4][2]), "+f"(o[4][3]),
        "+f"(o[5][0]), "+f"(o[5][1]), "+f"(o[5][2]), "+f"(o[5][3]),
        "+f"(o[6][0]), "+f"(o[6][1]), "+f"(o[6][2]), "+f"(o[6][3]),
        "+f"(o[7][0]), "+f"(o[7][1]), "+f"(o[7][2]), "+f"(o[7][3]),
        "+f"(o[8][0]), "+f"(o[8][1]), "+f"(o[8][2]), "+f"(o[8][3]),
        "+f"(o[9][0]), "+f"(o[9][1]), "+f"(o[9][2]), "+f"(o[9][3]),
        "+f"(o[10][0]), "+f"(o[10][1]), "+f"(o[10][2]), "+f"(o[10][3]),
        "+f"(o[11][0]), "+f"(o[11][1]), "+f"(o[11][2]), "+f"(o[11][3]),
        "+f"(o[12][0]), "+f"(o[12][1]), "+f"(o[12][2]), "+f"(o[12][3]),
        "+f"(o[13][0]), "+f"(o[13][1]), "+f"(o[13][2]), "+f"(o[13][3]),
        "+f"(o[14][0]), "+f"(o[14][1]), "+f"(o[14][2]), "+f"(o[14][3]),
        "+f"(o[15][0]), "+f"(o[15][1]), "+f"(o[15][2]), "+f"(o[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

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

// 2^x by the SFU's approximation (relative error ~2^-22, far below the
// bf16 rounding of P); 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
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
      wgmma_ss_n64(s, smem_desc(sm.q + off, 16, kSbo),
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
