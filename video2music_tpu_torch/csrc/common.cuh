// Shared helpers for the port's hand-written Hopper kernels: dtype
// conversion, warp/block reductions, and the vectorised row dot product that
// every GEMV of the decode step is built from.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace v2m {

// dtype codes shared with kernels.py (DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) {
  return (float)v;  // an int8 weight; its row scale is applied to the dot
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// The value v takes after a round trip through T (JAX's .astype(dtype)
// before a matmul input).
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max. blockDim.x is a multiple of 32; red holds 32 floats.
// Every thread gets the result. Safe to call back to back (leading sync).
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nw ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nw ? red[lane] : -INFINITY;
    t = warp_max(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

// The router's order of expert o (logit u) against expert e (logit v):
// larger logit first, the lower index first among equal logits (the
// Pallas top-k loop, whose argmax keeps the first maximal index), a NaN
// after every number. A strict total order, so the ranks of E experts
// (the experts ordered before each) are 0 .. E - 1 and the experts of
// rank < k are the top k, in selection order.
__device__ __forceinline__ bool ranks_before(float u, int o, float v, int e) {
  const bool nu = u != u, nv = v != v;
  if (nu != nv) return nv;
  if (!nu && u != v) return u > v;
  return o < e;
}

__device__ __forceinline__ int expert_rank(const float* logit, int E, int e) {
  const float v = logit[e];
  int rank = 0;
  for (int o = 0; o < E; ++o) rank += ranks_before(logit[o], o, v, e);
  return rank;
}

// Floats of n router weights in a workspace: n rounded up to a multiple of
// 4, so the f32 rows after them stay 16-byte aligned.
__host__ __device__ constexpr int selw_floats(int n) { return (n + 3) / 4 * 4; }

// The L2 line of p, prefetched.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Elements of T in one 16-byte load.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<bf16> { static constexpr int N = 8; };
template <> struct Vec<int8_t> { static constexpr int N = 16; };

// One lane's share of dot(w[0:K], xs[0:K]): lanes stride over K in 16-byte
// vectors of w (row 16-byte aligned, K a multiple of Vec<T>::N), xs in shared
// memory (16-byte aligned). Sum the lanes with warp_sum.
template <typename T>
__device__ __forceinline__ float dot_partial(const T* __restrict__ w,
                                             const float* __restrict__ xs,
                                             int K, int lane) {
  constexpr int V = Vec<T>::N;
  float acc = 0.f;
  for (int k = lane * V; k < K; k += 32 * V) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(w + k));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + k + i);
      acc = fmaf(to_f<T>(e[i]), xv.x, acc);
      acc = fmaf(to_f<T>(e[i + 1]), xv.y, acc);
      acc = fmaf(to_f<T>(e[i + 2]), xv.z, acc);
      acc = fmaf(to_f<T>(e[i + 3]), xv.w, acc);
    }
  }
  return acc;
}

// ---------------------------------------------------------------------------
// attention at any even head size (batch_decode.cuh attn_any_kernel,
// decode_stack.cu attend_split_any)
// ---------------------------------------------------------------------------

// True where the narrow attention instances (batch_decode.cuh
// attn_cluster_kernel and attn_kernel, decode_layer.cu
// chain_attention_kernel, decode_stack.cu attend_split) take head size hd:
// a multiple of 8 (their 16-byte loads, or 8-byte ones of int8 rows), at
// most 256 (a head column a thread); the shapes they ran at before the
// instances of any even head size existed, which take the rest.
__host__ __device__ constexpr bool narrow_head(int hd) {
  return hd % 8 == 0 && hd <= 256;
}

// The raw load of two consecutive cache values.
template <typename C> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<bf16> { using type = unsigned int; };
template <> struct Pair<int8_t> { using type = char2; };

// Two consecutive C values from p (2-element aligned) as f32: through the
// read-only cache (kRO), or through L2 only (a row an earlier kernel of the
// chain wrote).
template <typename C, bool kRO>
__device__ __forceinline__ float2 load_pair(const C* p) {
  using R = typename Pair<C>::type;
  const R* rp = reinterpret_cast<const R*>(p);
  const R r = kRO ? __ldg(rp) : __ldcg(rp);
  const C* e = reinterpret_cast<const C*>(&r);
  return make_float2(to_f<C>(e[0]), to_f<C>(e[1]));
}

// Lanes one row's logit takes at head size hd: its hd / 2 value pairs
// over a power of two of lanes, at most a warp (2 at head size 4, 8 at 12,
// 32 from 64).
__host__ __device__ __forceinline__ int pair_lanes(int hd) {
  int g = 1;
  while (g < 32 && 2 * g < hd) g *= 2;
  return g;
}

// Sum over the g lanes of a row (g a power of two, aligned lane groups).
__device__ __forceinline__ float lanes_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace v2m
