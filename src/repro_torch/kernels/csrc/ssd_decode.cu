// Mamba2 SSD decode update: one recurrent step of each stepped row's
// state, in place, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package runs this step as XLA
// elementwise ops and a mat-vec (ref.ssd_decode_ref, through
// models.ssm.mamba_block_decode), and so did the port before this kernel:
// four float32 passes over the state a layer, then a stack of every
// layer's new state and a masked merge of it into the slot cache, about
// fifteen passes over the whole state a tick. It was added because that
// step was most of a Mamba2 decode tick.
//
// For x (B, H, P), dt (B, H), a (H,), b and c (B, N) and the float32
// state s (B, H, N, P) it computes, for every row in the mask,
//   s <- s * exp(dt a) + dt (b (x) x),   y = c . s   (summed over N)
// and writes s back where it was read and y (B, H, P) in x's dtype. The
// slot step passes its mask and the slot cache's own layer view, so the
// state is advanced in place (the port updates in place where the JAX
// package rebuilds the array). Rows outside the mask are neither read nor
// written, so they keep their state bit for bit, and their y is 0. The
// out-of-place form passes no mask and another state pointer: every row is
// stepped into a fresh tensor. x, b and c may be views with a row stride
// (the split of the conv's output); each row's (H, P) or N values are
// contiguous.
//
// What bounds it on this card: the state's bytes. Each element is read
// once and written once (8 bytes) for 4 flops; at mamba2-1.3b's decode
// (128 slots, 64 heads, N 128, P 64) that is 537 MB a layer, 0.160 ms at
// 3.35 TB/s. The design spends nothing beyond that single pass: one block
// per (head, row), whose 256 threads walk the (N, P) tile in 16-byte
// loads and stores, 16 threads on one 64-float row of the tile (a warp
// covers two rows, 512 contiguous bytes). Every thread issues all its
// state loads before their first use; x * dt, b and c are staged in shared
// memory meanwhile. y's sum over N is taken in the block (registers, a
// shuffle, then shared memory), so nothing is staged through device
// memory. The state streams (evict-first loads and stores): a tick touches
// it once, and 12.9 GB does not fit in the 50 MB L2.
//
// Built for (N, P) = (128, 64) (mamba2-1.3b) and (64, 64) (zamba2-7b), x
// in float32 or bfloat16; any H.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// s_in and s_out are one address in the in-place form: no __restrict__ on
// either, and each element is read and written by the same thread.
template <int N, int P, typename T>
__global__ void __launch_bounds__(kThreads)
ssd_decode_kernel(T* __restrict__ y, float* s_out, const float* s_in,
                  const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm,
                  const unsigned char* __restrict__ mask, int H,
                  long long x_row, long long b_row, long long c_row) {
  constexpr int kP4 = P / 4;            // float4 columns of a row of P
  constexpr int kRG = kThreads / kP4;   // row groups of kP4 threads
  constexpr int kRows = N / kRG;        // state rows per thread
  static_assert(P % 4 == 0 && kThreads % kP4 == 0 && N % kRG == 0 &&
                32 % kP4 == 0 && kP4 <= 32, "thread layout");

  __shared__ float sxdt[P];             // x * dt of this row and head
  __shared__ float sb[N];
  __shared__ float sc[N];
  __shared__ float4 sy[kWarps][kP4];    // y's partial sums, one per warp

  const int h = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  const long long head = (long long)row * H + h;
  T* yh = y + head * P;
  if (mask != nullptr && mask[row] == 0) {   // not stepped: state untouched
    for (int p = tid; p < P; p += kThreads) yh[p] = from_float<T>(0.f);
    return;
  }
  const int col = tid % kP4, rg = tid / kP4;
  const long long sbase = head * (long long)(N * P);
  const float4* src = reinterpret_cast<const float4*>(s_in + sbase);
  float4* dst = reinterpret_cast<float4*>(s_out + sbase);

  float4 s[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) s[k] = __ldcs(src + (rg + k * kRG) * kP4 + col);

  const float dth = dt[head];
  const float decay = expf(dth * a[h]);
  const T* xh = x + row * x_row + (long long)h * P;
  for (int p = tid; p < P; p += kThreads) sxdt[p] = to_float(xh[p]) * dth;
  for (int n = tid; n < N; n += kThreads) {
    sb[n] = to_float(bm[row * b_row + n]);
    sc[n] = to_float(cm[row * c_row + n]);
  }
  __syncthreads();

  const float4 xv = *reinterpret_cast<const float4*>(&sxdt[col * 4]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int n = rg + k * kRG;
    const float bn = sb[n], cn = sc[n];
    float4 v = s[k];
    v.x = fmaf(v.x, decay, bn * xv.x);
    v.y = fmaf(v.y, decay, bn * xv.y);
    v.z = fmaf(v.z, decay, bn * xv.z);
    v.w = fmaf(v.w, decay, bn * xv.w);
    __stcs(dst + n * kP4 + col, v);
    acc.x = fmaf(cn, v.x, acc.x);
    acc.y = fmaf(cn, v.y, acc.y);
    acc.z = fmaf(cn, v.z, acc.z);
    acc.w = fmaf(cn, v.w, acc.w);
  }
  // the warp's row groups, then the warps
#pragma unroll
  for (int off = kP4; off < 32; off *= 2) {
    acc.x += __shfl_xor_sync(kFull, acc.x, off);
    acc.y += __shfl_xor_sync(kFull, acc.y, off);
    acc.z += __shfl_xor_sync(kFull, acc.z, off);
    acc.w += __shfl_xor_sync(kFull, acc.w, off);
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane < kP4) sy[warp][lane] = acc;
  __syncthreads();
  if (tid < kP4) {
    float4 t = sy[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) add4(t, sy[w][tid]);
    yh[tid * 4 + 0] = from_float<T>(t.x);
    yh[tid * 4 + 1] = from_float<T>(t.y);
    yh[tid * 4 + 2] = from_float<T>(t.z);
    yh[tid * 4 + 3] = from_float<T>(t.w);
  }
}

template <int N, int P, typename T>
int run(void* y, void* state_out, const void* state_in, const void* x,
        const void* dt, const void* a, const void* b, const void* c,
        const void* mask, int B, int H, int x_row, int b_row, int c_row,
        cudaStream_t s) {
  dim3 grid(H, B);
  ssd_decode_kernel<N, P, T><<<grid, kThreads, 0, s>>>(
      (T*)y, (float*)state_out, (const float*)state_in, (const T*)x,
      (const float*)dt, (const float*)a, (const T*)b, (const T*)c,
      (const unsigned char*)mask, H, x_row, b_row, c_row);
  return cudaGetLastError();
}

}  // namespace

// y (B, H, P) in x's dtype; state_out may be state_in (in place); mask
// (B,) bytes, or null for every row; x_row, b_row, c_row are the elements
// between consecutive rows of x, b and c. dtype: 0 float32, 1 bfloat16.
extern "C" int ssd_decode(void* y, void* state_out, const void* state_in,
                          const void* x, const void* dt, const void* a,
                          const void* b, const void* c, const void* mask,
                          int B, int H, int P, int N, int x_row, int b_row,
                          int c_row, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || H == 0) return cudaSuccess;
  if (B > 65535) return cudaErrorInvalidValue;
  if (N == 128 && P == 64 && dtype == 0)
    return run<128, 64, float>(y, state_out, state_in, x, dt, a, b, c, mask,
                               B, H, x_row, b_row, c_row, s);
  if (N == 128 && P == 64 && dtype == 1)
    return run<128, 64, __nv_bfloat16>(y, state_out, state_in, x, dt, a, b,
                                       c, mask, B, H, x_row, b_row, c_row,
                                       s);
  if (N == 64 && P == 64 && dtype == 0)
    return run<64, 64, float>(y, state_out, state_in, x, dt, a, b, c, mask,
                              B, H, x_row, b_row, c_row, s);
  if (N == 64 && P == 64 && dtype == 1)
    return run<64, 64, __nv_bfloat16>(y, state_out, state_in, x, dt, a, b, c,
                                      mask, B, H, x_row, b_row, c_row, s);
  return cudaErrorInvalidValue;
}
