// The bf16 flash-attention backward on Hopper's tensor cores (sm_90a):
// the dK/dV and dQ kernels that flash_attention_bwd (flash_backward.cu)
// launches for bfloat16 inputs, after its delta kernel. The float32
// inputs (the parity type) stay on that file's CUDA-core kernels.
//
// The design. Both kernels run one warpgroup (4 warps, wgmma's M of 64
// rows) per block, and every product is a wgmma with bf16 operands and
// f32 accumulators; tiles sit in the swizzled slabs of wgmma.cuh
// (tc::load_tile: cp.async, zeros past the ragged edge and past D).
//   dkdv_tc_kernel: one block per 64-key tile of one KV head. K and V load
//     once. The block walks the query tiles of every query head of the
//     GQA group that can see the tile (from the diagonal when causal, to
//     the window's end when windowed); per query tile, Q, dO and the rows'
//     lse and delta arrive by cp.async into one of two buffers while the
//     previous tile computes. It works in the transposed orientation, keys
//     as rows: S^T = K·Q^T and dP^T = V·dO^T (both operands K-major in
//     shared memory), P^T = exp2(S^T·scale·log2 e - lse·log2 e) under the
//     mask (lse and delta are per column here, read from shared memory),
//     dS^T = P^T (dP^T - delta); P^T and dS^T round to bf16 in registers,
//     where the accumulator layout of two 8-column tiles is the A fragment
//     of one 16-deep step, and dV += P^T·dO, dK += dS^T·Q read dO and Q
//     MN-major from the same slabs (as tc_attend reads V). dK and dV stay
//     in f32 registers for the whole walk and are stored once, dK times
//     scale. dV's product runs while dS^T forms.
//   dq_tc_kernel: one block per 64-query tile of one head, query-major.
//     Q, dO and the rows' lse and delta load once; the K and V tiles the
//     rows can see arrive double-buffered. S = Q·K^T and dP = dO·V^T, dS
//     in registers, rounded to bf16, dQ += dS·K with K read MN-major; dQ
//     is stored once, times scale.
// No float atomics: each gradient element is summed by one thread in one
// order, so the gradients repeat bit for bit. Per visible pair the two
// kernels do 7 D-long products (S and dP in both) against the 5 the
// bound counts; folding dQ into the key-major walk (a float32 dQ in
// device memory with atomics, or a second reduction pass) would save two.
// Only the diagonal, window-start and ragged-edge tiles pay per-element
// masking (Pairs::full); tiles with no visible pair are never loaded. The
// tile index is the grid's slowest axis, so all heads' blocks of one tile
// run together: causal key tile 0 and query tile S/64 - 1, the longest
// walks, start first.
// What bounds it: operations (the products), then the exp2 of every pair
// on the SFU. Shared memory: the block's own two tiles and two buffers of
// the two walked tiles, 6 x 64 x tile_dim bf16 (96 KB at D 128, 48 KB at
// D 64) plus 1 KB of lse and delta, so two blocks share an SM at D 128.
// Head dims run at tile_dim<D>() columns (64 or 128): D 112 (zamba2-7b's
// shared attention) runs in tiles of 128 columns, as #5's forward does.
// load_tile zero-fills the 16 columns past D of every tile it loads, so
// S^T and dP^T (7 steps of 16, the zero step skipped) are exact; dV and
// dK accumulate 128 columns whose last 16 are zeros (dO and Q are zero
// there), and store_rows writes only the 112. The padding wastes 1/8 of
// the two D-wide products and of their shared memory (98 KB, as at D 128).
#pragma once

#include <cstdint>

#include "tc_attend.cuh"

namespace tcbwd {

using namespace wg;
using attn::kThreads;
using tc::kBK;
using tc::kBQ;
using tc::load_tile;
using tc::tile_dim;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSbo = 8 * 128;      // 8 rows of 128 bytes
constexpr int kSlab = kBQ * 64;    // elements per 64-column slab of a tile

template <int D>
struct Smem {
  bf16 own[2][kBQ * tile_dim<D>()];      // dkdv: K, V; dq: Q, dO
  bf16 walk[2][2][kBQ * tile_dim<D>()];  // [buffer]: dkdv Q, dO; dq K, V
  float lse[2][kBQ];                     // dkdv: the walked rows'
  float delta[2][kBQ];
};

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(Smem<D>) + 1024;  // slack to align the base to 1024 bytes
}

template <int D>
__device__ __forceinline__ Smem<D>& smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem_raw);
  return *reinterpret_cast<Smem<D>*>(smem_raw +
                                     ((1024 - (base & 1023)) & 1023));
}

// One float by cp.async (a row of lse or delta need not start on 16
// bytes); zero where !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

// Which (query row i, key j) pairs are visible, row i standing at
// position i + q_offset in the causal and window masks; full(q0, k0):
// every pair of the 64-query tile at row q0 and the 64-key tile at k0 is.
struct Pairs {
  int S, Sk, causal, window, q_offset;
  __device__ __forceinline__ bool visible(int i, int j) const {
    const int p = i + q_offset;
    return i < S && j < Sk && (!causal || j <= p) &&
           (window <= 0 || p - j < window);
  }
  __device__ __forceinline__ bool full(int q0, int k0) const {
    const int p0 = q0 + q_offset;
    return q0 + kBQ <= S && k0 + kBK <= Sk &&
           (!causal || k0 + kBK - 1 <= p0) &&
           (window <= 0 || p0 + kBQ - 1 - k0 < window);
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&r)[N][4]) {
#pragma unroll
  for (int t = 0; t < N; ++t) r[t][0] = r[t][1] = r[t][2] = r[t][3] = 0.f;
}

// acc (64 x 64) += A·B^T over D: A and B both 64-row tiles, K-major
template <int D>
__device__ __forceinline__ void issue_nt(float (&acc)[kBK / 8][4],
                                         const bf16* a, const bf16* b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {  // zeros past D add nothing
    const int off = (ks >> 2) * kSlab + (ks & 3) * 16;  // 32 B per step
    wgmma_ss_n64<0>(acc, smem_desc(a + off, 16, kSbo),
                    smem_desc(b + off, 16, kSbo));
  }
}

// acc (64 x tile_dim) += A·B: A the bf16 fragments of a 64 x 64 tile, B a
// 64-row tile read MN-major
template <int DW>
__device__ __forceinline__ void issue_rs(float (&acc)[DW / 8][4],
                                         const uint32_t (&a)[kBK / 16][4],
                                         const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    tc::wgmma_pv<DW>(acc, a[kk], smem_desc(b + kk * 16 * 64, kSlab * 2,
                                           kSbo));
}

// The bf16 A fragments of an accumulator tile: two 8-column tiles are one
// 16-deep step
__device__ __forceinline__ void pack_tile(uint32_t (&a)[kBK / 16][4],
                                          int t, const float (&v)[4]) {
  a[t / 2][(t & 1) * 2] = pack_bf16(v[0], v[1]);
  a[t / 2][(t & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
}

// Store a 64 x D accumulator's rows below nvalid, times mul, as bf16:
// tile row r at dst + r * stride.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride,
                                           int nvalid,
                                           const float (&acc)[tile_dim<D>() /
                                                              8][4],
                                           float mul) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + h * 8;
    if (r >= nvalid) continue;
    bf16* row = dst + r * stride + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < D / 8; ++t)  // columns past D are not stored
      *reinterpret_cast<__nv_bfloat162*>(row + t * 8) =
          __floats2bfloat162_rn(acc[t][2 * h] * mul, acc[t][2 * h + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
dkdv_tc_kernel(bf16* __restrict__ dk, bf16* __restrict__ dv,
               const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, int S, int Sk, int H, int KV,
               int causal, int window, int q_offset, float scale) {
  Smem<D>& sm = smem<D>();
  constexpr int kDW = tile_dim<D>();
  constexpr int kNT = kBQ / 8;  // 8-query column tiles of S^T
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kBK;
  const int nk = min(kBK, Sk - k0);
  const long long q_stride = (long long)H * D, kv_stride = (long long)KV * D;
  const long long koff = (((long long)b * Sk + k0) * KV + g) * D;
  load_tile<D, kBK>(sm.own[0], k + koff, kv_stride, nk);
  load_tile<D, kBK>(sm.own[1], v + koff, kv_stride, nk);

  // the query rows that can see a key of the tile: from the diagonal on
  // when causal, up to the window's end when windowed (rows stand at
  // their position less q_offset); for each query head of the group in
  // turn
  const int q_first = causal ? max(0, k0 - q_offset) : 0;
  const int q_end = window > 0
      ? min(S - 1, k0 + nk - 1 + window - 1 - q_offset) : S - 1;
  const int qt0 = q_first / kBQ;
  const int nqt = q_first <= q_end ? q_end / kBQ - qt0 + 1 : 0;
  const int group = H / KV;
  const int n_walk = group * nqt;
  auto load_walk = [&](int n) {
    const int buf = n & 1, h = g * group + n / nqt;
    const int q0 = (qt0 + n % nqt) * kBQ;
    const long long qoff = (((long long)b * S + q0) * H + h) * D;
    load_tile<D, kBQ>(sm.walk[buf][0], q + qoff, q_stride, S - q0);
    load_tile<D, kBQ>(sm.walk[buf][1], dout + qoff, q_stride, S - q0);
    // kThreads = 2 * kBQ: one float of lse or delta each
    const int r = threadIdx.x % kBQ;
    const bool ok = q0 + r < S;
    const long long row = ((long long)b * H + h) * S + q0 + r;
    if (threadIdx.x < kBQ)
      cp_async4(&sm.lse[buf][r], ok ? lse + row : lse, ok);
    else
      cp_async4(&sm.delta[buf][r], ok ? delta + row : delta, ok);
    cp_async_commit();
  };
  static_assert(kThreads == 2 * kBQ, "one lse or delta float a thread");
  if (n_walk > 0)
    load_walk(0);  // one group with K and V
  else
    cp_async_commit();

  float acc_k[kDW / 8][4], acc_v[kDW / 8][4];
  zero(acc_k);
  zero(acc_v);
  const float sl2 = scale * kLog2e;
  const Pairs pairs{S, Sk, causal, window, q_offset};
  // in the accumulator layout this lane holds key rows j_lo and j_lo + 8
  // and, of every 8-query tile t, the columns 8t + 2(lane%4) and + 1
  const int j_lo = k0 + warp * 16 + (lane >> 2);
  for (int n = 0; n < n_walk; ++n) {
    const int buf = n & 1;
    cp_async_wait<0>();  // tile n (and K, V) landed for this thread
    fence_async_shared();
    __syncthreads();  // ... for every thread; all are done with tile n - 1
    if (n + 1 < n_walk) load_walk(n + 1);  // into tile n - 1's buffer
    const int q0 = (qt0 + n % nqt) * kBQ;
    const bf16* qs = sm.walk[buf][0];
    const bf16* dos = sm.walk[buf][1];

    float st[kNT][4], dpt[kNT][4];
    zero(st);
    zero(dpt);
    fence_regs(st);  // the zeros land before the fence, so that dP^T's
    fence_regs(dpt);  // issue need not wait for S^T's
    wgmma_fence();
    issue_nt<D>(st, sm.own[0], qs);  // S^T = K·Q^T
    wgmma_commit();
    issue_nt<D>(dpt, sm.own[1], dos);  // dP^T = V·dO^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T, in place of S^T, and its bf16 fragments
    const bool full = pairs.full(q0, k0);
    uint32_t pf[kNT / 2][4];
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      const int c = 8 * t + 2 * (lane & 3);
      const float2 l = *reinterpret_cast<const float2*>(&sm.lse[buf][c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(
            fmaf(st[t][e], sl2, -(e & 1 ? l.y : l.x) * kLog2e));
        st[t][e] = full || pairs.visible(q0 + c + (e & 1), j_lo + (e >> 1) * 8)
                       ? p
                       : 0.f;
      }
      pack_tile(pf, t, st[t]);
    }
    // dV += P^T·dO, running while dS^T forms
    fence_regs(acc_v);
    wgmma_fence();
    issue_rs<kDW>(acc_v, pf, dos);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T has landed
    fence_regs(dpt);

    // dS^T = P^T (dP^T - delta) and its bf16 fragments
    uint32_t dsf[kNT / 2][4];
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      const int c = 8 * t + 2 * (lane & 3);
      const float2 d = *reinterpret_cast<const float2*>(&sm.delta[buf][c]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[t][e] = st[t][e] * (dpt[t][e] - (e & 1 ? d.y : d.x));
      pack_tile(dsf, t, dpt[t]);
    }
    // dK += dS^T·Q
    fence_regs(acc_k);
    wgmma_fence();
    issue_rs<kDW>(acc_k, dsf, qs);
    wgmma_commit();
    wgmma_wait<0>();  // both products are done with the buffer
    fence_regs(acc_v);
    fence_regs(acc_k);
  }
  cp_async_wait<0>();
  store_rows<D>(dk + koff, kv_stride, nk, acc_k, scale);
  store_rows<D>(dv + koff, kv_stride, nk, acc_v, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
dq_tc_kernel(bf16* __restrict__ dq, const bf16* __restrict__ q,
             const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, int S, int Sk, int H, int KV,
             int causal, int window, int q_offset, float scale) {
  Smem<D>& sm = smem<D>();
  constexpr int kDW = tile_dim<D>();
  constexpr int kNT = kBK / 8;  // 8-key column tiles of S
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the last query tiles see the most keys when causal: they start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int g = h / (H / KV);
  const int nq = min(kBQ, S - q0);
  const long long q_stride = (long long)H * D, kv_stride = (long long)KV * D;
  const long long qoff = (((long long)b * S + q0) * H + h) * D;
  const long long ko = ((long long)b * Sk * KV + g) * D;
  load_tile<D, kBQ>(sm.own[0], q + qoff, q_stride, nq);
  load_tile<D, kBQ>(sm.own[1], dout + qoff, q_stride, nq);

  // key tiles [first, last] / kBK, as in the forward
  const int first = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int last = causal ? min(q0 + nq - 1 + q_offset, Sk - 1) : Sk - 1;
  const int kt0 = first / kBK, n_walk = last / kBK - kt0 + 1;
  auto load_walk = [&](int n) {
    const int k0 = (kt0 + n) * kBK;
    const bf16* kr = k + ko + k0 * kv_stride;
    const bf16* vr = v + ko + k0 * kv_stride;
    load_tile<D, kBK>(sm.walk[n & 1][0], kr, kv_stride, Sk - k0);
    load_tile<D, kBK>(sm.walk[n & 1][1], vr, kv_stride, Sk - k0);
    cp_async_commit();
  };
  load_walk(0);  // one group with Q and dO

  // this lane's rows r_lo and r_lo + 8: their lse (log2 units) and delta
  const int r_lo = warp * 16 + (lane >> 2);
  float l2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_lo + hh * 8;
    const long long row = ((long long)b * H + h) * S + q0 + r;
    l2[hh] = r < nq ? lse[row] * kLog2e : 0.f;
    dl[hh] = r < nq ? delta[row] : 0.f;
  }
  float acc[kDW / 8][4];
  zero(acc);
  const float sl2 = scale * kLog2e;
  const Pairs pairs{S, Sk, causal, window, q_offset};
  for (int n = 0; n < n_walk; ++n) {
    const int buf = n & 1;
    cp_async_wait<0>();  // tile n (and Q, dO) landed for this thread
    fence_async_shared();
    __syncthreads();  // ... for every thread; all are done with tile n - 1
    if (n + 1 < n_walk) load_walk(n + 1);  // into tile n - 1's buffer
    const int k0 = (kt0 + n) * kBK;
    const bf16* ks = sm.walk[buf][0];
    const bf16* vs = sm.walk[buf][1];

    float s[kNT][4], dp[kNT][4];
    zero(s);
    zero(dp);
    fence_regs(s);  // the zeros land before the fence (as in dkdv)
    fence_regs(dp);
    wgmma_fence();
    issue_nt<D>(s, sm.own[0], ks);  // S = Q·K^T
    wgmma_commit();
    issue_nt<D>(dp, sm.own[1], vs);  // dP = dO·V^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P, in place of S, while dP runs
    const bool full = pairs.full(q0, k0);
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      const int j = k0 + 8 * t + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[t][e], sl2, -l2[e >> 1]));
        s[t][e] = full || pairs.visible(q0 + r_lo + (e >> 1) * 8, j + (e & 1))
                      ? p
                      : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS = P (dP - delta) as bf16 fragments; dQ += dS·K
    uint32_t dsf[kNT / 2][4];
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[t][e] = s[t][e] * (dp[t][e] - dl[e >> 1]);
      pack_tile(dsf, t, dp[t]);
    }
    fence_regs(acc);
    wgmma_fence();
    issue_rs<kDW>(acc, dsf, ks);
    wgmma_commit();
    wgmma_wait<0>();  // done with the buffer
    fence_regs(acc);
  }
  cp_async_wait<0>();
  store_rows<D>(dq + qoff, q_stride, nq, acc, scale);
}

// dK, dV then dQ for bf16 inputs; delta (B, H, S) is already written.
template <int D>
cudaError_t run(bf16* dq, bf16* dk, bf16* dv, const float* delta,
                const bf16* q, const bf16* k, const bf16* v,
                const bf16* dout, const float* lse, int B, int S, int Sk,
                int H, int KV, int causal, int window, int q_offset,
                float scale, cudaStream_t stream) {
  cudaError_t err = attn::launch(
      dkdv_tc_kernel<D>, dim3(KV, B, (Sk + kBK - 1) / kBK), smem_bytes<D>(),
      stream, dk, dv, q, k, v, dout, lse, delta, S, Sk, H, KV, causal, window,
      q_offset, scale);
  if (err != cudaSuccess) return err;
  return attn::launch(dq_tc_kernel<D>, dim3(H, B, (S + kBQ - 1) / kBQ),
                      smem_bytes<D>(), stream, dq, q, k, v, dout, lse, delta,
                      S, Sk, H, KV, causal, window, q_offset, scale);
}

}  // namespace tcbwd
