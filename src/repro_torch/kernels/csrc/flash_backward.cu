// Flash attention backward for Hopper (sm_90a): the gradient of the dense
// GQA attention that flash_attention.cu's dense kernel computes, from that
// kernel's output O and its per-row log-sum-exp.
//
// flash_attention_bwd replaces src/repro/kernels/flash_vjp.py, _bwd_impl:
// the recomputing backward of the flash forward, which the JAX package
// writes in plain jnp (it is no Pallas kernel; on a TPU the training path
// runs the Pallas forward and this jnp backward). q, O, dO: (B, S, H, D);
// k, v: (B, Sk, KV, D); lse: (B, H, S) float32, natural-log units of the
// scaled scores. Token i attends token j iff (causal -> j <= i) and
// (window > 0 -> i - j < window); Sk differs from S only without either.
// Query head h reads KV head h * KV / H. With scale = 1/sqrt(D):
//   P = exp(scale * q k^T - lse) on the visible pairs, 0 elsewhere
//   delta = rowsum(dO * O)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q
//
// The design: three kernels, no float atomics, so the gradients are the
// same from run to run.
//   1. delta_kernel: one warp per (row, head): delta = rowsum(dO * O).
//   2. dkdv_kernel: one block per key tile of kBK keys of one KV head. It
//      keeps the tile's K and V in shared memory and dK and dV in float32
//      registers, and walks the query tiles of every query head of its
//      GQA group that can see the tile (from the diagonal on when causal,
//      up to the window's end when windowed): per query tile it loads Q,
//      dO, lse and delta, recomputes S and dP, writes P and dS to shared
//      memory and folds P^T dO and dS^T Q into its accumulators. A group's
//      heads sum in the block: no repeated K/V and no later reduction.
//   3. dq_kernel: one block per query tile of one head; it walks the key
//      tiles the tile can see, recomputes S, dP and dS and folds dS K into
//      float32 registers.
// Both tile kernels run 256 threads as a 16 x 16 grid: a 64 x 64 product
// gives each thread 4 x 4 elements (rows ty + 16i, columns tx + 16j), a
// 64 x D accumulator 4 x D/16. Every operand sits in shared memory as
// float32 in rows padded to D + 1 (or kBK + 1) floats, so a half-warp's 16
// rows fall in 16 banks; the products are float32 FMAs on the CUDA cores
// for both input types (bfloat16 is widened on load, the gradients are
// rounded once on store). What bounds it: operations. Per visible pair it
// does 7 D-long dot products (S and dP twice, dV, dK, dQ), on the CUDA
// cores at a share of their 67 TFLOP/s float32 peak; the tensor cores
// (wgmma, as #5's forward) are later work.
#include <cstdint>

#include "attn_common.cuh"

namespace bwd {

using attn::from_f;
using attn::to_f;

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr int kTile = 16;  // the 16 x 16 thread grid

template <int D>
struct Smem {
  float q[kBQ][D + 1];
  float dout[kBQ][D + 1];
  float k[kBK][D + 1];
  float v[kBK][D + 1];
  float p[kBQ][kBK + 1];
  float ds[kBQ][kBK + 1];
  float lse[kBQ];
  float delta[kBQ];
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

// Load 64 rows of D elements into dst as float32: row r is src + r * stride
// for r < nvalid, zeros past it. Coalesced along the row.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float (*dst)[D + 1],
                                          const T* __restrict__ src,
                                          long long stride, int nvalid) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r][c] = r < nvalid ? to_f(src[r * stride + c]) : 0.f;
  }
}

struct Visible {
  int S, Sk, causal, window;
  __device__ __forceinline__ bool operator()(int i, int j) const {
    return i < S && j < Sk && (!causal || j <= i) &&
           (window <= 0 || i - j < window);
  }
};

// The 4 x 4 elements of S = Q K^T and dP = dO V^T this thread owns, rows
// ty + 16i of the query tile, columns tx + 16j of the key tile; then P and
// dS of them, stored to shared memory (P only where store_p).
template <int D>
__device__ __forceinline__ void scores(Smem<D>& sm, int q0, int k0,
                                       float scale, Visible vis,
                                       bool store_p) {
  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = sm.q[ty + kTile * i][d];
      da[i] = sm.dout[ty + kTile * i][d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = sm.k[tx + kTile * j][d];
      vb[j] = sm.v[tx + kTile * j][d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + kTile * i;
    const float lse = sm.lse[r], delta = sm.delta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + kTile * j;
      const float p = vis(q0 + r, k0 + c) ? expf(s[i][j] * scale - lse)
                                           : 0.f;
      if (store_p) sm.p[r][c] = p;
      sm.ds[r][c] = p * (dp[i][j] - delta);
    }
  }
}

// Load the query tile at q0 of head h: Q, dO, and the rows' lse and delta.
template <typename T, int D>
__device__ __forceinline__ void load_queries(
    Smem<D>& sm, const T* __restrict__ q, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int b,
    int h, int q0, int S, int H) {
  const long long off = (((long long)b * S + q0) * H + h) * D;
  const int n = min(kBQ, S - q0);
  load_rows<T, D>(sm.q, q + off, (long long)H * D, n);
  load_rows<T, D>(sm.dout, dout + off, (long long)H * D, n);
  if (threadIdx.x < kBQ) {
    const long long row = ((long long)b * H + h) * S + q0 + threadIdx.x;
    const bool ok = (int)threadIdx.x < n;
    sm.lse[threadIdx.x] = ok ? lse[row] : 0.f;
    sm.delta[threadIdx.x] = ok ? delta[row] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(float* __restrict__ delta, const T* __restrict__ out,
             const T* __restrict__ dout, int B, int S, int H) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);  // (b * S + i) * H + h
  if (row >= (long long)B * S * H) return;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f(out[row * D + d]), to_f(dout[row * D + d]), acc);
  acc = attn::warp_sum(acc);
  if (lane == 0) {
    const long long bi = row / H;
    const int h = (int)(row % H);
    const long long b = bi / S, i = bi % S;
    delta[(b * H + h) * S + i] = acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(T* __restrict__ dk, T* __restrict__ dv, const T* __restrict__ q,
            const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, int S, int Sk, int H, int KV,
            int causal, int window, float scale) {
  Smem<D>& sm = smem<D>();
  constexpr int kDJ = D / kTile;  // accumulator columns per thread
  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
  const int k0 = blockIdx.x * kBK, g = blockIdx.y, b = blockIdx.z;
  const int k_last = min(k0 + kBK, Sk) - 1;
  const long long koff = (((long long)b * Sk + k0) * KV + g) * D;
  load_rows<T, D>(sm.k, k + koff, (long long)KV * D, k_last - k0 + 1);
  load_rows<T, D>(sm.v, v + koff, (long long)KV * D, k_last - k0 + 1);

  float acc_k[4][kDJ], acc_v[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // the queries that can see a key of the tile: from the diagonal on when
  // causal, up to the window's end when windowed
  const int q_first = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S - 1, k_last + window - 1) : S - 1;
  const Visible vis{S, Sk, causal, window};
  const int group = H / KV;
  for (int hh = 0; hh < group; ++hh) {
    const int h = g * group + hh;
    for (int qt = q_first / kBQ; qt <= q_end / kBQ && q_first <= q_end;
         ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // every thread is done with the previous tile
      load_queries<T, D>(sm, q, dout, lse, delta, b, h, q0, S, H);
      __syncthreads();
      scores<D>(sm, q0, k0, scale, vis, true);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q: rows ty + 16i of the key tile,
      // columns tx + 16j of D
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pc[4], dsc[4], dor[kDJ], qr[kDJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pc[i] = sm.p[r][ty + kTile * i];
          dsc[i] = sm.ds[r][ty + kTile * i];
        }
#pragma unroll
        for (int j = 0; j < kDJ; ++j) {
          dor[j] = sm.dout[r][tx + kTile * j];
          qr[j] = sm.q[r][tx + kTile * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kDJ; ++j) {
            acc_v[i][j] = fmaf(pc[i], dor[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(dsc[i], qr[j], acc_k[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + kTile * i;
    if (k0 + c > k_last) continue;
    const long long row = koff + (long long)c * KV * D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      dk[row + tx + kTile * j] = from_f<T>(acc_k[i][j] * scale);
      dv[row + tx + kTile * j] = from_f<T>(acc_v[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(T* __restrict__ dq, const T* __restrict__ q,
          const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, int S, int Sk, int H, int KV,
          int causal, int window, float scale) {
  Smem<D>& sm = smem<D>();
  constexpr int kDJ = D / kTile;
  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
  // the last query tiles see the most keys when causal: they start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h * KV / H;
  const int q_last = min(q0 + kBQ, S) - 1;
  load_queries<T, D>(sm, q, dout, lse, delta, b, h, q0, S, H);

  float acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;

  // keys [first, last], as in the forward
  const int first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int last = causal ? min(q_last, Sk - 1) : Sk - 1;
  const Visible vis{S, Sk, causal, window};
  for (int kt = first / kBK; kt <= last / kBK; ++kt) {
    const int k0 = kt * kBK;
    const long long koff = (((long long)b * Sk + k0) * KV + g) * D;
    __syncthreads();  // every thread is done with the previous tile
    load_rows<T, D>(sm.k, k + koff, (long long)KV * D, min(kBK, Sk - k0));
    load_rows<T, D>(sm.v, v + koff, (long long)KV * D, min(kBK, Sk - k0));
    __syncthreads();
    scores<D>(sm, q0, k0, scale, vis, false);
    __syncthreads();
    // dQ += dS K: rows ty + 16i of the query tile, columns tx + 16j of D
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      float dsr[4], kr[kDJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = sm.ds[ty + kTile * i][c];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) kr[j] = sm.k[c][tx + kTile * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDJ; ++j)
          acc[i][j] = fmaf(dsr[i], kr[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + kTile * i;
    if (q0 + r > q_last) continue;
    const long long row = (((long long)b * S + q0 + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kDJ; ++j)
      dq[row + tx + kTile * j] = from_f<T>(acc[i][j] * scale);
  }
}

template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
static cudaError_t run(void* dq, void* dk, void* dv, float* delta,
                       const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       int B, int S, int Sk, int H, int KV, int causal,
                       int window, float scale, cudaStream_t stream) {
  const long long rows = (long long)B * S * H;
  const int warps = kThreads / 32;
  delta_kernel<T, D><<<(unsigned)((rows + warps - 1) / warps), kThreads, 0,
                       stream>>>(delta, (const T*)out, (const T*)dout, B, S,
                                 H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch(dkdv_kernel<T, D>, dim3((Sk + kBK - 1) / kBK, KV, B),
               smem_bytes<D>(), stream, (T*)dk, (T*)dv, (const T*)q,
               (const T*)k, (const T*)v, (const T*)dout, lse,
               (const float*)delta, S, Sk, H, KV, causal, window, scale);
  if (err != cudaSuccess) return err;
  return launch(dq_kernel<T, D>, dim3((S + kBQ - 1) / kBQ, H, B),
                smem_bytes<D>(), stream, (T*)dq, (const T*)q, (const T*)k,
                (const T*)v, (const T*)dout, lse, (const float*)delta, S, Sk,
                H, KV, causal, window, scale);
}

}  // namespace bwd

// dq, q, out, dout: (B, S, H, D); dk, dv, k, v: (B, Sk, KV, D); lse, delta
// (scratch, written here): (B, H, S) float32; all contiguous. causal: 0/1;
// window: 0 = none; Sk != S only with neither. dtype: 0 = float32, 1 =
// bfloat16; D 64 or 128. S == 0 writes nothing (the caller zeroes dk and
// dv). Returns cudaGetLastError().
extern "C" int flash_attention_bwd(void* dq, void* dk, void* dv, void* delta,
                                   const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse, int B,
                                   int S, int Sk, int H, int KV, int D,
                                   int causal, int window, int dtype,
                                   float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || S == 0) return cudaSuccess;
  if (Sk == 0 || (Sk != S && (causal || window > 0)))
    return cudaErrorInvalidValue;
  if (H % KV) return cudaErrorInvalidValue;
  float* dl = (float*)delta;
  const float* ls = (const float*)lse;
#define BWD_RUN(T, DD)                                                     \
  return bwd::run<T, DD>(dq, dk, dv, dl, q, k, v, out, dout, ls, B, S, Sk, \
                         H, KV, causal, window, scale, s)
  if (D == 64 && dtype == 0) BWD_RUN(float, 64);
  if (D == 64 && dtype == 1) BWD_RUN(__nv_bfloat16, 64);
  if (D == 128 && dtype == 0) BWD_RUN(float, 128);
  if (D == 128 && dtype == 1) BWD_RUN(__nv_bfloat16, 128);
#undef BWD_RUN
  return cudaErrorInvalidValue;
}
