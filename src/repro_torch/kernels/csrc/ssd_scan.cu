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
// What bounds it on this card: at mamba2-1.3b shapes (H 64, P 64, N 128,
// cl 128) it does ~10.5 MFLOP per chunk and head against ~2 bytes per
// flop of input, so in bf16 the tensor-core bound and the byte bound are
// both ~0.09 ms at B 8, L 2048; in float32 outside the tensor cores the
// operations bound it (~1.3 ms at 67 TFLOP/s). This version does every
// product in f32 FMAs on the CUDA cores, so it is bound by them and by
// shared-memory traffic.
//
// What the design does about it: one block per (head, batch) walks its
// chunks in order and keeps the (N, P) state in shared memory for the
// whole sequence (a loop takes the place of the TPU's sequential grid
// axis). It reads x, dt, b and c where they lie: the TPU wrapper's f32
// xdt and its per-head copies of b and c (64x their bytes at these
// shapes) are never built; x * dt and dt * a form on load. A float32
// chunk does not fit in 227 KB together with its (cl, cl) product, so
// that product is formed one slab of kSlab rows at a time. Above the
// diagonal nothing is computed: exp(acs_i - acs_j) is evaluated only for
// j <= i, so no inf is ever formed and multiplied by zero.
// Not yet done (later work): wgmma on the (cl, cl) and (cl, N) products,
// TMA double buffering of the next chunk, and a chunk-parallel two-pass
// layout for small B * H.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCL = 128;           // chunk rows held on chip
constexpr int kSlab = 32;             // rows of the (cl, cl) product per pass
constexpr int kBStride = kMaxCL + 1;  // row stride of b^T: no bank conflicts
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

template <typename T, int N, int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(T* __restrict__ y, float* __restrict__ state_out,
           const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ init, int L,
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
  const T* xb = x + (long long)bi * L * xrow + (long long)h * P;
  T* yb = y + (long long)bi * L * xrow + (long long)h * P;
  const float* dtb = dt + (long long)bi * L * H + h;
  const T* bb = bm + (long long)bi * L * N;
  const T* cb = cm + (long long)bi * L * N;
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
          i < rows ? to_f(xb[(long long)(t0 + i) * xrow + p]) * sm.dts[i]
                   : 0.f;
    }
    for (int e = tid; e < clr * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const long long off = (long long)(t0 + i) * N + n;
      sm.c[i][n] = i < rows ? to_f(cb[off]) : 0.f;
      sm.bt[n][i] = i < rows ? to_f(bb[off]) : 0.f;
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
        T* out = yb + (long long)(t0 + i) * xrow + p4;
        out[0] = from_f<T>(acc.x + off.x * e);
        out[1] = from_f<T>(acc.y + off.y * e);
        out[2] = from_f<T>(acc.z + off.z * e);
        out[3] = from_f<T>(acc.w + off.w * e);
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

template <typename T, int N, int P>
cudaError_t run(void* y, void* state, const void* x, const void* dt,
                const void* a, const void* b, const void* c,
                const void* init, int B, int L, int H, int cl,
                cudaStream_t stream) {
  auto kernel = ssd_kernel<T, N, P>;
  const size_t smem = sizeof(Smem<N, P>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      (T*)y, (float*)state, (const T*)x, (const float*)dt, (const float*)a,
      (const T*)b, (const T*)c, (const float*)init, L, H, cl);
  return cudaGetLastError();
}

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
    return run<float, 128, 64>(y, state, x, dt, a, b, c, init, B, L, H, cl,
                               s);
  if (N == 128 && P == 64 && dtype == 1)
    return run<__nv_bfloat16, 128, 64>(y, state, x, dt, a, b, c, init, B, L,
                                       H, cl, s);
  return cudaErrorInvalidValue;
}
