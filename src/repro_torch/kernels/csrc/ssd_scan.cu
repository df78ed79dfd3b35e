// Mamba2 SSD (state-space duality) chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py, ssd_scan
// (_ssd_kernel), together with the layout work of its wrapper ops.ssd.
//
// For x (B, L, H, P), dt (B, L, H), a (H,), b and c (B, L, N) it computes
//   s_t = s_{t-1} * exp(dt_t a) + dt_t (b_t (x) x_t),   y_t = c_t . s_t
// in chunks of cl rows, as the TPU kernel does. With xdt = x * dt,
// adt = dt * a and acs its inclusive cumsum within the chunk:
//   y_i   = sum_{j<=i} (c_i . b_j) exp(acs_i - acs_j) xdt_j      (intra)
//         + exp(acs_i) (c_i . S)                                 (inbound)
//   S    <- S exp(acs_last) + sum_j exp(acs_last - acs_j) b_j (x) xdt_j
// It writes y (B, L, H, P) in the input dtype and the final state
// (B, H, N, P) in float32. Rows t >= L act as dt = 0 and x = b = c = 0:
// they read no memory and store no y, and the state freezes exactly, so a
// row whose tail carries dt = 0 ends with the state of its unpadded run.
//
// Built for P 64 at N 128 (mamba2-1.3b) and N 64 (zamba2-7b), both types.
//
// What bounds it on this card: at mamba2-1.3b shapes (H 64, P 64, N 128,
// cl 128) it does ~10.5 MFLOP per chunk and head against ~2 bytes per
// flop of input, so in bf16 the tensor-core bound and the byte bound are
// both ~0.09 ms at B 8, L 2048; in float32 outside the tensor cores the
// operations bound it (~1.3 ms at 67 TFLOP/s).
//
// float32 (the parity dtype) runs ssd_kernel: one block per (head, batch)
// walks its chunks in order and keeps the (N, P) state in shared memory
// for the whole sequence (a loop takes the place of the TPU's sequential
// grid axis), every product in f32 FMAs on the CUDA cores. It reads x,
// dt, b and c where they lie: the TPU wrapper's f32 xdt and its per-head
// copies of b and c (64x their bytes at these shapes) are never built;
// x * dt and dt * a form on load. A float32 chunk does not fit in 227 KB
// together with its (cl, cl) product, so that product is formed one slab
// of kSlab rows at a time.
//
// bfloat16 runs ssd_tc_kernel on the tensor cores (wgmma, f32
// accumulators). A block owns one batch row and a group of kHG heads,
// one warpgroup each, and walks the chunks in order; C·B^T, which every
// head shares (b and c have no head axis), is formed once per chunk for
// the group, and each head's (N, P) state stays in its warpgroup's
// accumulator registers for the whole sequence. Per chunk and head:
//   y    = exp(acs_i) (c · S) + (G ∘ L ∘ dt_j) · x,   G = C·B^T,
//          L_ij = exp(acs_i - acs_j) for j <= i, else 0;
//   S   <- S exp(acs_last) + (b_j dt_j w_j)^T · x,
//          w_j = exp(acs_last - acs_j).
// x, b and c are exact bf16 inputs, so x stays one side of both of its
// products and c one side of c·S; the other side (G ∘ L ∘ dt, b·dt·w, S)
// is formed in f32 and enters as a bf16 pair hi + lo, two wgmmas into one
// accumulator (~2^-17 relative): a single bf16 rounding of any of them
// misses the bf16 gates (tests/test_torch_kernels.py emulates each). G ∘
// L ∘ dt and b·dt·w are built in registers as wgmma's A fragment; S is
// written to shared memory as the B operand of c·S. Products run while
// the next A fragment forms: c·S while the fragments of G ∘ L ∘ dt do
// (y keeps the two in separate accumulators), and each 64 x 64 block of
// the state carry while the next block's fragment does; the state carry
// needs no C·B^T, so it runs before the barrier that waits for both
// warpgroups' parts of it. The chunk's rows pad to whole 64-row tiles
// (CP = 64 or 128, a template parameter) with zero rows (dt = 0);
// neither the block layout nor any order of summation depends on B or L,
// so a row whose tail carries dt = 0 ends, bit for bit, with the state
// of its unpadded run.
// Above the diagonal nothing is computed in either body: exp(acs_i -
// acs_j) is evaluated only for j <= i, so no inf is ever formed.
// Not yet done (later work): copying the next chunk while this one
// computes (TMA or cp.async double buffers; the 217 KB of shared memory
// leave no room), and a chunk-parallel two-pass layout for small B * H.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCL = 128;           // chunk rows held on chip
constexpr int kSlab = 32;             // rows of the (cl, cl) product per pass
constexpr int kBStride = kMaxCL + 1;  // row stride of b^T: no bank conflicts
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

// Shared memory of one block (210 KB at N 128, P 64), dynamic.
template <int N, int P>
struct Smem {
  float xdt[kMaxCL][P];       // x * dt of the chunk's rows
  float c[kMaxCL][N];         // c rows
  float bt[N][kBStride];      // b transposed: bt[n][t]
  float s[N][P];              // the carried state
  float g[kSlab][kMaxCL];     // one row slab of (c b^T) masked and decayed
  float dts[kMaxCL];          // dt of the chunk's rows
  float acs[kMaxCL];          // dt * a, then its inclusive cumsum
  float ein[kMaxCL];          // exp(acs_i)
  float wout[kMaxCL];         // exp(acs_last - acs_j)
};

template <int N, int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(float* __restrict__ y, float* __restrict__ state_out,
           const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ init, int L,
           int H, int cl) {
  static_assert(N % 16 == 0 && P % 4 == 0, "tile shapes");
  constexpr int kP4 = P / 4;                  // float4 columns of a P row
  constexpr int kRG = kThreads / kP4;         // row groups of kP4 threads
  static_assert(kThreads % kP4 == 0 && kSlab % kRG == 0 && N % kRG == 0,
                "thread layout");
  constexpr int kRowsPT = kSlab / kRG;        // y rows per thread per slab
  constexpr int kNPT = N / kRG;               // state rows per thread
  static_assert(kSlab == 4 * kWarps && kMaxCL == 4 * 32, "G layout");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N, P>& sm = *reinterpret_cast<Smem<N, P>*>(smem_raw);
  const int h = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float ah = a[h];
  const long long xrow = (long long)H * P;    // x elements between rows
  const float* xb = x + (long long)bi * L * xrow + (long long)h * P;
  float* yb = y + (long long)bi * L * xrow + (long long)h * P;
  const float* dtb = dt + (long long)bi * L * H + h;
  const float* bb = bm + (long long)bi * L * N;
  const float* cb = cm + (long long)bi * L * N;
  const long long sbase = ((long long)bi * H + h) * N * P;

  for (int e = tid; e < N * P; e += kThreads)
    (&sm.s[0][0])[e] = init ? init[sbase + e] : 0.f;

  const int p4 = (tid % kP4) * 4;             // this thread's 4 columns
  const int rg = tid / kP4;
  const int clr = (cl + 3) & ~3;              // rows rounded up to float4
  const int nc = (L + cl - 1) / cl;
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * cl;
    const int rows = min(cl, L - t0);         // real rows of this chunk

    // ---- load: dt and dt * a, then x * dt, c and b^T; zeros past rows
    for (int i = tid; i < clr; i += kThreads) {
      const float d = i < rows ? dtb[(long long)(t0 + i) * H] : 0.f;
      sm.dts[i] = d;
      sm.acs[i] = d * ah;
    }
    __syncthreads();
    for (int e = tid; e < clr * P; e += kThreads) {
      const int i = e / P, p = e % P;
      sm.xdt[i][p] =
          i < rows ? xb[(long long)(t0 + i) * xrow + p] * sm.dts[i]
                   : 0.f;
    }
    for (int e = tid; e < clr * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const long long off = (long long)(t0 + i) * N + n;
      sm.c[i][n] = i < rows ? cb[off] : 0.f;
      sm.bt[n][i] = i < rows ? bb[off] : 0.f;
    }
    if (warp == 0) {
      // inclusive cumsum of acs[0, clr): 4 rows per lane in order, then
      // a warp scan of the lane totals. acs_i depends on rows <= i only,
      // so zero rows appended after a chunk's real rows change nothing
      // before them.
      float loc[4], run = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * lane + q;
        run += i < clr ? sm.acs[i] : 0.f;
        loc[q] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * lane + q;
        if (i < clr) sm.acs[i] = excl + loc[q];
      }
    }
    __syncthreads();
    const float atot = sm.acs[cl - 1];
    for (int i = tid; i < clr; i += kThreads) {
      sm.ein[i] = expf(sm.acs[i]);
      sm.wout[i] = expf(atot - sm.acs[i]);
    }
    __syncthreads();

    for (int s0 = 0; s0 < rows; s0 += kSlab) {
      // ---- slab of G = (c b^T) * exp(acs_i - acs_j) for j <= i, else 0.
      // Warp w: rows s0 + 4w .. +3; lane: columns lane + 32k.
      const int jend = min(clr, s0 + kSlab);
      const int r0 = 4 * warp, i0 = s0 + r0;
      if (i0 < clr) {
        bool act[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          act[k] = 32 * k < jend && 32 * k <= i0 + 3;
        float acc[4][4] = {};
        for (int n = 0; n < N; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) cv[q] = ld4(&sm.c[i0 + q][n]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!act[k]) continue;
            const int j = lane + 32 * k;
            const float b0 = sm.bt[n][j], b1 = sm.bt[n + 1][j];
            const float b2 = sm.bt[n + 2][j], b3 = sm.bt[n + 3][j];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float v = acc[q][k];
              v = fmaf(cv[q].x, b0, v);
              v = fmaf(cv[q].y, b1, v);
              v = fmaf(cv[q].z, b2, v);
              acc[q][k] = fmaf(cv[q].w, b3, v);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + q;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = lane + 32 * k;
            if (j >= jend) continue;
            // mask BEFORE the exponential: exp(acs_i - acs_j) overflows
            // above the diagonal
            sm.g[r0 + q][j] =
                act[k] && j <= i ? acc[q][k] * expf(sm.acs[i] - sm.acs[j])
                                 : 0.f;
          }
        }
      }
      __syncthreads();

      // ---- y rows of the slab: G row . xdt plus exp(acs_i) (c_i . S)
#pragma unroll
      for (int u = 0; u < kRowsPT; ++u) {
        const int r = rg + kRG * u, i = s0 + r;
        if (i >= rows) continue;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        const int jlim = (i + 4) & ~3;        // G is 0 in (i, jlim)
        for (int j = 0; j < jlim; j += 4) {
          const float4 gv = ld4(&sm.g[r][j]);
          fma4(acc, gv.x, ld4(&sm.xdt[j][p4]));
          fma4(acc, gv.y, ld4(&sm.xdt[j + 1][p4]));
          fma4(acc, gv.z, ld4(&sm.xdt[j + 2][p4]));
          fma4(acc, gv.w, ld4(&sm.xdt[j + 3][p4]));
        }
        float4 off = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int n = 0; n < N; n += 4) {
          const float4 cv = ld4(&sm.c[i][n]);
          fma4(off, cv.x, ld4(&sm.s[n][p4]));
          fma4(off, cv.y, ld4(&sm.s[n + 1][p4]));
          fma4(off, cv.z, ld4(&sm.s[n + 2][p4]));
          fma4(off, cv.w, ld4(&sm.s[n + 3][p4]));
        }
        const float e = sm.ein[i];
        float* out = yb + (long long)(t0 + i) * xrow + p4;
        out[0] = acc.x + off.x * e;
        out[1] = acc.y + off.y * e;
        out[2] = acc.z + off.z * e;
        out[3] = acc.w + off.w * e;
      }
      __syncthreads();
    }

    // ---- state carry: S <- S exp(acs_last) + sum_j wout_j b_j (x) xdt_j.
    // Thread: columns p4.., state rows rg + kRG * k.
    {
      float4 acc[kNPT];
#pragma unroll
      for (int k = 0; k < kNPT; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < rows; ++j) {
        float4 xw = ld4(&sm.xdt[j][p4]);
        const float w = sm.wout[j];
        xw.x *= w;
        xw.y *= w;
        xw.z *= w;
        xw.w *= w;
#pragma unroll
        for (int k = 0; k < kNPT; ++k) fma4(acc[k], sm.bt[rg + kRG * k][j], xw);
      }
      const float dec = expf(atot);
#pragma unroll
      for (int k = 0; k < kNPT; ++k) {
        float* sp = &sm.s[rg + kRG * k][p4];
        sp[0] = fmaf(sp[0], dec, acc[k].x);
        sp[1] = fmaf(sp[1], dec, acc[k].y);
        sp[2] = fmaf(sp[2], dec, acc[k].z);
        sp[3] = fmaf(sp[3], dec, acc[k].w);
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < N * P; e += kThreads)
    state_out[sbase + e] = (&sm.s[0][0])[e];
}

template <int N, int P>
cudaError_t run(void* y, void* state, const void* x, const void* dt,
                const void* a, const void* b, const void* c,
                const void* init, int B, int L, int H, int cl,
                cudaStream_t stream) {
  auto kernel = ssd_kernel<N, P>;
  const size_t smem = sizeof(Smem<N, P>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      (float*)y, (float*)state, (const float*)x, (const float*)dt,
      (const float*)a, (const float*)b, (const float*)c, (const float*)init,
      L, H, cl);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// bf16 on the tensor cores
// --------------------------------------------------------------------------
namespace tc {

using namespace wg;

constexpr int kHG = 2;              // heads per block: one warpgroup each
constexpr int kWG = 128;            // threads of a warpgroup
constexpr int kThreadsTC = kHG * kWG;
constexpr int kP = 64;              // the head dim P the body is written for
constexpr int kSlabTC = kMaxCL * 64;  // elements per slab of a 128-row tile
constexpr int kSbo = 8 * 128;         // 8 rows of 128 bytes

// One block's shared memory (217 KB with the alignment slack at N 128,
// 145 KB at N 64): every bf16 tile has kMaxCL rows in the
// 128-byte-swizzled slabs of wgmma.cuh (1024-byte aligned: each tile's
// size is a multiple of 1024 bytes). N (128: mamba2-1.3b; 64: zamba2-7b)
// is a multiple of 64: whole slabs of c and b, whole 64-row blocks of
// the state.
template <int N>
struct Smem {
  static_assert(N % 64 == 0 && N <= kMaxCL, "state rows: whole 64-row blocks");
  bf16 c[kMaxCL * N];          // c rows (A of C·B^T and of c·S)
  bf16 b[kMaxCL * N];          // b rows (B of C·B^T; read for b·dt·w)
  bf16 x[kHG][kMaxCL * kP];    // x rows of each head (B of both x products)
  bf16 s_hi[kHG][N * kP];      // each head's state, rows n, as hi + lo
  bf16 s_lo[kHG][N * kP];
  float4 cb0[8][kWG];          // C·B^T rows 0..63, columns 0..63 and
  float4 cb1[16][kWG];         // rows 64..127, columns 0..127, in the
                               // accumulator order of the thread reading
  float acs[kHG][kMaxCL];      // inclusive cumsum of dt * a
  float dt[kHG][kMaxCL];       // dt
  float dtw[kHG][kMaxCL];      // dt_j exp(acs_last - acs_j)
  float wsum[kHG][4];          // warp totals of the scan
};

// barrier of one warpgroup (ids 1 and up; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int w) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "r"(kWG) : "memory");
}

// The A fragment of (G ∘ L ∘ dt_j), rows i0 and i1 = i0 + 8 of this lane,
// columns 64 kb .. 64 kb + 63, as bf16 hi + lo; g: C·B^T in this lane's
// accumulator order. No exp above the diagonal.
__device__ __forceinline__ void g_fragment(uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4],
                                           const float4* g, int kb, int tw,
                                           int col, int i0, const float* acs,
                                           const float* dt) {
  const int i1 = i0 + 8;
  const float a0 = acs[i0], a1 = acs[i1];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int jt = 8 * kb + 2 * q + half;  // 8-column tile
      const float4 gv = g[jt * kWG + tw];
      const int j = 8 * jt + col;
      const float aj0 = acs[j], aj1 = acs[j + 1];
      const float dj0 = dt[j], dj1 = dt[j + 1];
      const float v00 = j <= i0 ? gv.x * expf(a0 - aj0) * dj0 : 0.f;
      const float v01 = j + 1 <= i0 ? gv.y * expf(a0 - aj1) * dj1 : 0.f;
      const float v10 = j <= i1 ? gv.z * expf(a1 - aj0) * dj0 : 0.f;
      const float v11 = j + 1 <= i1 ? gv.w * expf(a1 - aj1) * dj1 : 0.f;
      split_bf16(v00, v01, hi[q][2 * half], lo[q][2 * half]);
      split_bf16(v10, v11, hi[q][2 * half + 1], lo[q][2 * half + 1]);
    }
}

// The A fragment of (b_j dt_j w_j)^T, rows n0 and n0 + 8 of this lane,
// columns j = 64 kb .. 64 kb + 63, as bf16 hi + lo, read from the b tile.
__device__ __forceinline__ void bw_fragment(uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4],
                                            const bf16* b, int kb, int col,
                                            int n0, const float* dtw) {
  const int n1 = n0 + 8;
  auto at = [&](int j, int n) {  // b[j][n] of the swizzled tile
    return __bfloat162float(b[swz<kMaxCL>(j, n >> 3) + (n & 7)]);
  };
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 64 * kb + 16 * q + 8 * half + col;
      const float w0 = dtw[j], w1 = dtw[j + 1];
      const float v00 = at(j, n0) * w0, v01 = at(j + 1, n0) * w1;
      const float v10 = at(j, n1) * w0, v11 = at(j + 1, n1) * w1;
      split_bf16(v00, v01, hi[q][2 * half], lo[q][2 * half]);
      split_bf16(v10, v11, hi[q][2 * half + 1], lo[q][2 * half + 1]);
    }
}

// acc += A·x over columns 64 kb .. 64 kb + 63 of A (rows of the x tile),
// A as hi + lo
__device__ __forceinline__ void times_x(float (&acc)[8][4],
                                        const uint32_t (&hi)[4][4],
                                        const uint32_t (&lo)[4][4],
                                        const bf16* xs, int kb) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint64_t db =
        smem_desc(xs + (4 * kb + q) * 16 * 64, 2 * kSlabTC, kSbo);
    wgmma_rs_n64(acc, hi[q], db);
    wgmma_rs_n64(acc, lo[q], db);
  }
}

// N: the state's rows (64 or 128); CP: the chunk's rows padded to whole
// 64-row tiles (64 or 128)
template <int N, int CP>
__global__ void __launch_bounds__(kThreadsTC, 1)
ssd_tc_kernel(bf16* __restrict__ y, float* __restrict__ state_out,
              const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a, const bf16* __restrict__ bm,
              const bf16* __restrict__ cm, const float* __restrict__ init,
              int L, int H, int cl) {
  constexpr int kT = CP / 64;  // 64-row tiles of a chunk
  constexpr int kM = N / 64;   // 64-row blocks of the state
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem_raw);
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(
      smem_raw + ((1024 - (base & 1023)) & 1023));
  const int w = threadIdx.x / kWG, tw = threadIdx.x % kWG;
  const int lane = tw & 31, warp = tw >> 5;
  const int bi = blockIdx.y, h = blockIdx.x * kHG + w;
  const bool live = h < H;  // a ragged last group leaves a warpgroup idle
  const int hh = live ? h : 0;
  const float ah = a[hh];
  const long long xrow = (long long)H * kP;  // x elements between rows
  const bf16* xb = x + (long long)bi * L * xrow + (long long)hh * kP;
  bf16* yb = y + (long long)bi * L * xrow + (long long)hh * kP;
  const float* dtb = dt + (long long)bi * L * H + hh;
  const bf16* bb = bm + (long long)bi * L * N;
  const bf16* cb = cm + (long long)bi * L * N;
  const long long sbase = ((long long)bi * H + hh) * N * kP;
  // this lane's accumulator rows (and + 8) and first column of each tile
  const int row_lo = warp * 16 + (lane >> 2), col = (lane & 3) * 2;

  // the state, rows n = 64 mt + row_lo (+ 8), columns p = 8 j + col (+ 1)
  float st[kM][8][4];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 64 * mt + row_lo + (e >> 1) * 8;
        const int q = 8 * j + col + (e & 1);
        st[mt][j][e] = init != nullptr ? init[sbase + n * kP + q] : 0.f;
      }

  const int nc = (L + cl - 1) / cl;
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * cl;
    const int rows = min(cl, L - t0);  // real rows of this chunk

    // ---- copies: c and b by the block, x by each head's warpgroup; rows
    // past the real ones are zeros
    for (int idx = threadIdx.x; idx < CP * (N / 8); idx += kThreadsTC) {
      const int r = idx / (N / 8), ch = idx % (N / 8);
      const bool ok = r < rows;
      const long long off = (long long)(t0 + (ok ? r : 0)) * N + ch * 8;
      cp_async16(sm.c + swz<kMaxCL>(r, ch), cb + off, ok);
      cp_async16(sm.b + swz<kMaxCL>(r, ch), bb + off, ok);
    }
    if (live) {
      for (int idx = tw; idx < CP * (kP / 8); idx += kWG) {
        const int r = idx / (kP / 8), ch = idx % (kP / 8);
        const bool ok = r < rows;
        cp_async16(sm.x[w] + swz<kMaxCL>(r, ch),
                   xb + (long long)(t0 + (ok ? r : 0)) * xrow + ch * 8, ok);
      }
    }
    cp_async_commit();

    // ---- dt, and the inclusive cumsum of dt * a over the chunk's rows:
    // thread tw holds row tw (a warp scan, then the warp totals); the
    // order of the sums depends on the row index alone
    const float d = live && tw < rows ? dtb[(long long)(t0 + tw) * H] : 0.f;
    float v = d * ah;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) sm.wsum[w][warp] = v;
    wg_sync(w);
    float acs = v;
    for (int k = 0; k < warp; ++k) acs = sm.wsum[w][k] + acs;
    sm.acs[w][tw] = acs;
    sm.dt[w][tw] = d;
    wg_sync(w);
    const float alast = sm.acs[w][CP - 1];
    sm.dtw[w][tw] = d * expf(alast - acs);

    // ---- the state entering the chunk, as bf16 hi + lo, rows n
    if (live) {
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r2 = 0; r2 < 2; ++r2) {
            const int n = 64 * mt + row_lo + 8 * r2;
            const int at = swz<kMaxCL>(n, j) + col;
            uint32_t hi, lo;
            split_bf16(st[mt][j][2 * r2], st[mt][j][2 * r2 + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(sm.s_hi[w] + at) = hi;
            *reinterpret_cast<uint32_t*>(sm.s_lo[w] + at) = lo;
          }
    }
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();

    // ---- C·B^T once for the group (exact products, f32 sums): warpgroup
    // m forms rows 64m..64m+63 up to the diagonal tile
    if (w == 0) {
      float g[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) g[j][0] = g[j][1] = g[j][2] = g[j][3] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        const int off = (ks >> 2) * kSlabTC + (ks & 3) * 16;
        wgmma_ss_n64<0>(g, smem_desc(sm.c + off, 16, kSbo),
                        smem_desc(sm.b + off, 16, kSbo));
      }
      wgmma_commit_wait();
      fence_regs(g);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sm.cb0[j][tw] = make_float4(g[j][0], g[j][1], g[j][2], g[j][3]);
    } else if (kT == 2) {
      float g[16][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) g[j][0] = g[j][1] = g[j][2] = g[j][3] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        const int off = (ks >> 2) * kSlabTC + (ks & 3) * 16;
        wgmma_ss_n128(g, smem_desc(sm.c + 64 * 64 + off, 16, kSbo),
                      smem_desc(sm.b + off, 16, kSbo));
      }
      wgmma_commit_wait();
      fence_regs(g);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        sm.cb1[j][tw] = make_float4(g[j][0], g[j][1], g[j][2], g[j][3]);
    }
    // the state carry needs no C·B^T: it runs while the other warpgroup
    // may still form its part
    const float* acs_s = sm.acs[w];
    const float* dtw_s = sm.dtw[w];
    const bf16* xs = sm.x[w];
    uint32_t hi[2][4][4], lo[2][4][4];  // two A fragments in flight
    if (live) {
      // ---- state carry: S <- S exp(acs_last) + (b_j dt_j w_j)^T · x over
      // kM x kT blocks (64 state rows, 64 chunk rows); each block's A
      // fragment (rows n, columns j) forms from the b tile while the
      // previous block's products run
      const float dec = expf(alast);
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[mt][j][e] *= dec;
      bw_fragment(hi[0], lo[0], sm.b, 0, col, row_lo, dtw_s);
#pragma unroll
      for (int blk = 0; blk < kM * kT; ++blk) {
        const int mt = blk / kT, kb = blk % kT;
        wgmma_fence();
        times_x(st[mt], hi[blk & 1], lo[blk & 1], xs, kb);
        wgmma_commit();
        if (blk + 1 < kM * kT) {
          wgmma_wait<1>();  // the products that read the other fragment
          bw_fragment(hi[(blk + 1) & 1], lo[(blk + 1) & 1], sm.b,
                      (blk + 1) % kT, col, 64 * ((blk + 1) / kT) + row_lo,
                      dtw_s);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) fence_regs(st[mt]);
    }
    __syncthreads();  // C·B^T of both warpgroups is in shared memory

    if (live) {
      // ---- y, one 64-row tile at a time: c·S (S as hi + lo) into one
      // accumulator while the A fragments of (G ∘ L ∘ dt_j) form, their
      // products with x into another; tiles past the real rows store
      // nothing and are skipped
#pragma unroll
      for (int m = 0; m < kT; ++m) {
        if (64 * m >= rows) break;
        float ao[8][4], ad[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          ao[j][0] = ao[j][1] = ao[j][2] = ao[j][3] = 0.f;
          ad[j][0] = ad[j][1] = ad[j][2] = ad[j][3] = 0.f;
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks) {
          const uint64_t da = smem_desc(
              sm.c + (ks >> 2) * kSlabTC + m * 64 * 64 + (ks & 3) * 16, 16,
              kSbo);
          wgmma_ss_n64<1>(ao, da, smem_desc(sm.s_hi[w] + ks * 16 * 64,
                                            2 * kSlabTC, kSbo));
          wgmma_ss_n64<1>(ao, da, smem_desc(sm.s_lo[w] + ks * 16 * 64,
                                            2 * kSlabTC, kSbo));
        }
        wgmma_commit();
        const float4* gm = m == 0 ? &sm.cb0[0][0] : &sm.cb1[0][0];
        const int i0 = 64 * m + row_lo;
#pragma unroll
        for (int kb = 0; kb <= m; ++kb) {
          g_fragment(hi[kb], lo[kb], gm, kb, tw, col, i0, acs_s, sm.dt[w]);
          wgmma_fence();
          times_x(ad, hi[kb], lo[kb], xs, kb);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(ao);
        fence_regs(ad);
        const float e0 = expf(acs_s[i0]), e1 = expf(acs_s[i0 + 8]);
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int i = i0 + 8 * r2;
          if (i >= rows) continue;
          const float e = r2 ? e1 : e0;
          bf16* dst = yb + (long long)(t0 + i) * xrow + col;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                __floats2bfloat162_rn(fmaf(ao[j][2 * r2], e, ad[j][2 * r2]),
                                      fmaf(ao[j][2 * r2 + 1], e,
                                           ad[j][2 * r2 + 1]));
        }
      }
    }
    __syncthreads();  // c, b and x are read to the end before the next copy
  }

  if (live) {
#pragma unroll
    for (int mt = 0; mt < kM; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r2 = 0; r2 < 2; ++r2) {
          const int n = 64 * mt + row_lo + 8 * r2;
          *reinterpret_cast<float2*>(state_out + sbase + n * kP + 8 * j +
                                     col) =
              make_float2(st[mt][j][2 * r2], st[mt][j][2 * r2 + 1]);
        }
  }
}

template <int N, int CP>
cudaError_t run(void* y, void* state, const void* x, const void* dt,
                const void* a, const void* b, const void* c, const void* init,
                int B, int L, int H, int cl, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<N>) + 1024;  // slack to align to 1024 B
  cudaError_t err = cudaFuncSetAttribute(
      ssd_tc_kernel<N, CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_tc_kernel<N, CP><<<dim3((H + kHG - 1) / kHG, B), kThreadsTC, smem,
                          stream>>>(
      (bf16*)y, (float*)state, (const bf16*)x, (const float*)dt,
      (const float*)a, (const bf16*)b, (const bf16*)c, (const float*)init, L,
      H, cl);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x, y: (B, L, H, P); dt: (B, L, H) float32; a: (H,) float32; b, c:
// (B, L, N); init: (B, H, N, P) float32 or null (zeros); state: (B, H, N,
// P) float32; all contiguous. cl = min(chunk, L) <= 128. dtype (of x, b,
// c, y): 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int ssd_scan(void* y, void* state, const void* x, const void* dt,
                        const void* a, const void* b, const void* c,
                        const void* init, int B, int L, int H, int P, int N,
                        int cl, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || H == 0) return cudaSuccess;
  if (L < 1 || cl < 1 || cl > kMaxCL) return cudaErrorInvalidValue;
  if (N == 128 && P == 64 && dtype == 0)
    return run<128, 64>(y, state, x, dt, a, b, c, init, B, L, H, cl, s);
  if (N == 128 && P == 64 && dtype == 1)
    return cl <= 64 ? tc::run<128, 64>(y, state, x, dt, a, b, c, init, B, L,
                                       H, cl, s)
                    : tc::run<128, 128>(y, state, x, dt, a, b, c, init, B, L,
                                        H, cl, s);
  if (N == 64 && P == 64 && dtype == 0)
    return run<64, 64>(y, state, x, dt, a, b, c, init, B, L, H, cl, s);
  if (N == 64 && P == 64 && dtype == 1)
    return cl <= 64 ? tc::run<64, 64>(y, state, x, dt, a, b, c, init, B, L, H,
                                      cl, s)
                    : tc::run<64, 128>(y, state, x, dt, a, b, c, init, B, L,
                                       H, cl, s);
  return cudaErrorInvalidValue;
}
