// Split-K single-token decode attention (flash-decoding) for Hopper: the
// block body, its partial results, and the kernel that merges them.
//
// A row's keys are cut into splits of split_len keys; one block of
// kThreads threads takes one (split, KV head g, row b) and the whole query
// group of g (rep = H / KV heads), so each live K/V byte leaves device
// memory once for all rep heads. The block writes a partial (m, l, acc)
// per head: its running max, its softmax sum and its unnormalised P·V, in
// f32. combine_splits then merges the splits of each (row, head) by the
// log-sum-exp rule.
//
// Inside a block, lanes split D into 16-byte vectors (8 bf16 or 4 f32), so
// a key row takes D / kVec lanes, rounded up to a power of two (zamba2's
// D 112: 16 lanes in bf16, 32 in f32, whose last lanes read nothing and
// hold zeros), and a warp reads 32 / that many keys per step; warps and
// lane groups take different keys. Each lane group keeps
// its own online softmax over its keys (partial dot products reduce by
// shuffles inside the group), and the block merges its groups through
// shared memory. q sits in registers in f32. The body does not know where
// a key lies: key_off(p) is the element offset of key p of head g in k and
// v: a plain stride for the contiguous caches of decode_attention.cu, a
// block-table lookup for the page pool of paged_attention.cu.
#pragma once

#include "attn_common.cuh"

namespace split {

using attn::kFull;
using attn::kThreads;
constexpr int kWarps = kThreads / 32;

// Softmax state is kept in the log2 domain: scores are multiplied by
// log2(e) with the scale, so exp2 replaces exp.
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);  // elements per 16 bytes
};

// the least power of two >= n: lanes of a key row's group
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[4]) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Partials of nbh = B * H (row, head) pairs and `splits` splits, in one
// f32 scratch buffer: (m, l) pairs first, then the (D,) accumulators.
template <typename F>  // float or const float
__device__ __forceinline__ F* part_ml(F* part, int bh, int splits,
                                      int split) {
  return part + 2 * ((long long)bh * splits + split);
}
template <typename F>
__device__ __forceinline__ F* part_acc(F* part, int nbh, int splits, int D,
                                       int bh, int split) {
  return part + 2LL * nbh * splits + ((long long)bh * splits + split) * D;
}

// Keys [start, end) of row b against query heads g*rep .. g*rep+rep-1,
// R of them at a time (R >= rep except when rep > 8). q: (B, H, D). A
// block with start >= end writes empty partials (m = -inf, l = 0).
template <typename T, int D, int R, class KeyOff>
__device__ __forceinline__ void split_decode(float* __restrict__ part,
                                             const T* __restrict__ q,
                                             const T* __restrict__ k,
                                             const T* __restrict__ v, int b,
                                             int g, int B, int H, int rep,
                                             int splits, int split,
                                             int start, int end, float scale,
                                             KeyOff key_off) {
  constexpr int kVec = Vec<T>::kN;
  constexpr int kLpk = pow2_at_least(D / kVec);  // lanes per key row
  constexpr int kDP = kLpk * kVec;        // D padded to the lane group
  constexpr int kKpw = 32 / kLpk;         // keys per warp step
  constexpr int kSlots = kWarps * kKpw;   // lane groups per block
  constexpr int kUnroll = R >= 8 ? 2 : 4; // keys per group per step
  constexpr int kStep = kSlots * kUnroll; // keys per block step
  static_assert(D % kVec == 0 && kLpk <= 32, "D: whole vectors, one warp");
  __shared__ float sm_m[kSlots][R], sm_l[kSlots][R];
  __shared__ __align__(16) float sm_acc[kSlots][R][kDP];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % kLpk;
  const int slot = warp * kKpw + lane / kLpk;
  const int nbh = B * H;
  // a lane past D (kDP > D) reads nothing and holds zeros
  const bool in_d = kDP == D || sub * kVec < D;

  if (start >= end) {
    for (int r = threadIdx.x; r < rep; r += kThreads) {
      float* ml = part_ml(part, b * H + g * rep + r, splits, split);
      ml[0] = -CUDART_INF_F;
      ml[1] = 0.f;
    }
    return;
  }

  for (int r0 = 0; r0 < rep; r0 += R) {
    const int nr = min(R, rep - r0);
    float qr[R][kVec];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr && in_d) {
        const T* src = q + ((long long)b * H + g * rep + r0 + r) * D +
                       sub * kVec;
        float x[kVec];
        unpack(*reinterpret_cast<const uint4*>(src), x);
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[r][e] = x[e] * scale * kLog2e;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) qr[r][e] = 0.f;
      }
    }
    float m[R], l[R], acc[R][kVec];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = -CUDART_INF_F;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
    }

    for (int base = start; base < end; base += kStep) {
      // issue every load of the step before using any
      uint4 kraw[kUnroll], vraw[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = base + u * kSlots + slot;
        ok[u] = p < end;
        if (ok[u] && in_d) {
          const long long off = key_off(p) + sub * kVec;
          kraw[u] = __ldg(reinterpret_cast<const uint4*>(k + off));
          vraw[u] = __ldg(reinterpret_cast<const uint4*>(v + off));
        } else {
          kraw[u] = vraw[u] = make_uint4(0, 0, 0, 0);
        }
      }
      float s[kUnroll][R];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kx[kVec];
        unpack(kraw[u], kx);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < kVec; ++e) dot = fmaf(qr[r][e], kx[e], dot);
#pragma unroll
          for (int o = kLpk / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(kFull, dot, o);
          s[u][r] = ok[u] ? dot : -CUDART_INF_F;
        }
      }
      if (!ok[0]) continue;  // this group has no key in the step
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = s[0][r];
#pragma unroll
        for (int u = 1; u < kUnroll; ++u) mx = fmaxf(mx, s[u][r]);
        const float m_new = fmaxf(m[r], mx);
        const float corr = exp2f(m[r] - m_new);  // first key: exp2(-inf)
        m[r] = m_new;
        l[r] *= corr;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] *= corr;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float vx[kVec];
        unpack(vraw[u], vx);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = exp2f(s[u][r] - m[r]);  // no key: exp2(-inf) = 0
          l[r] += p;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(p, vx[e], acc[r][e]);
        }
      }
    }

    // merge the block's lane groups through shared memory
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (sub == 0) {
        sm_m[slot][r] = m[r];
        sm_l[slot][r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        sm_acc[slot][r][sub * kVec + e] = acc[r][e];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nr * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) mx = fmaxf(mx, sm_m[s][r]);
      // the block holds at least one key, so mx is finite
      float sum = 0.f, a = 0.f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const float w = exp2f(sm_m[s][r] - mx);  // empty group: 0
        sum += w * sm_l[s][r];
        a += w * sm_acc[s][r][d];
      }
      const int bh = b * H + g * rep + r0 + r;
      part_acc(part, nbh, splits, D, bh, split)[d] = a;
      if (d == 0) {
        float* ml = part_ml(part, bh, splits, split);
        ml[0] = mx;
        ml[1] = sum;
      }
    }
    __syncthreads();  // shared memory is reused by the next row group
  }
}

// Merge the splits of one (row, head) per block of D threads: out =
// sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s, in the output type.
// Rows of length 0 are written as exact zeros; an empty split (l = 0)
// weighs 0 and its accumulator, never written, is selected away. No load
// depends on another, so a row with many splits streams its partials.
// Lengths are clamped to [0, C]. Each kernel that merges (combine_splits
// here, paged_combine_splits of the paged decode) is a thin __global__
// around this body, so that a profile tells their device time apart.
template <typename T, int D>
__device__ __forceinline__ void combine(T* __restrict__ out,
                                        const float* __restrict__ part,
                                        const int* __restrict__ lengths,
                                        int H, int C, int splits) {
  // launched as a programmatic dependent of the split kernel: wait until
  // its partials are written and visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int bh = blockIdx.x, d = threadIdx.x;
  const int nbh = gridDim.x;
  const int len = max(0, min(lengths[bh / H], C));
  if (len == 0) {
    out[(long long)bh * D + d] = attn::from_f<T>(0.f);
    return;
  }
  const float2* ml =
      reinterpret_cast<const float2*>(part_ml(part, bh, splits, 0));
  const float* acc = part_acc(part, nbh, splits, D, bh, 0) + d;
  float mx = -CUDART_INF_F;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[s].x);
  float sum = 0.f, a = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const float2 e = ml[s];
    const float x = acc[(long long)s * D];
    const float w = e.y > 0.f ? exp2f(e.x - mx) : 0.f;
    sum += w * e.y;
    a += e.y > 0.f ? w * x : 0.f;
  }
  out[(long long)bh * D + d] = attn::from_f<T>(a / sum);
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
combine_splits(T* __restrict__ out, const float* __restrict__ part,
               const int* __restrict__ lengths, int H, int C, int splits) {
  combine<T, D>(out, part, lengths, H, C, splits);
}

// Launch a merge kernel (B * H blocks of D threads) on `stream` as a
// programmatic dependent of the split kernel launched just before it:
// it is set up while the split kernel runs, and its blocks wait
// (griddepcontrol.wait) for the partials. Returns the launch error.
template <typename T, class Merge>
cudaError_t launch_merge(Merge merge, void* out, const void* part,
                         const void* lengths, int BH, int D, int H, int C,
                         int splits, cudaStream_t stream) {
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH);
  cfg.blockDim = dim3(D);
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, merge, (T*)out,
                                       (const float*)part,
                                       (const int*)lengths, H, C, splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace split
