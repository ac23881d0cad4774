// Weight rows held by a warp and the staged, normalised input of a B=1
// GEMV: the pieces that the B=1 layer chain (decode_layer.cu) and the
// cooperative whole-run kernel (decode_stack.cu) both use to fetch a
// warp's weight rows before the wait on the data they multiply (registers
// when a row fits, an L2 prefetch otherwise).
#pragma once

#include "decode_step.cuh"

namespace v2m {

// 16-byte vectors of a weight row a lane holds in registers: rows of up to
// 32 * kRowVecs * Vec<W>::N values (bf16 1024, f32 512, int8 2048).
constexpr int kRowVecs = 4;

// Rows of one GEMV fit in a warp's registers.
template <typename W>
__host__ __device__ constexpr bool fits_regs(int K) {
  return K <= 32 * kRowVecs * Vec<W>::N;
}

// A warp's weight row in registers: lane l holds vectors l, l + 32, ...;
// every load is issued before any is used.
template <typename W>
struct RowRegs {
  uint4 v[kRowVecs];
  __device__ __forceinline__ void load(const W* row, int K, int lane) {
    constexpr int V = Vec<W>::N;
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) {
      const int k = (lane + 32 * i) * V;
      if (k < K) v[i] = __ldg(reinterpret_cast<const uint4*>(row + k));
    }
  }
  // dot(row, xs[0:K]) summed over the warp, every lane holding it
  __device__ __forceinline__ float dot(const float* xs, int K,
                                       int lane) const {
    constexpr int V = Vec<W>::N;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) {
      const int k = (lane + 32 * i) * V;
      if (k < K) {
        const W* e = reinterpret_cast<const W*>(&v[i]);
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + k + j);
          acc = fmaf(to_f<W>(e[j]), xv.x, acc);
          acc = fmaf(to_f<W>(e[j + 1]), xv.y, acc);
          acc = fmaf(to_f<W>(e[j + 2]), xv.z, acc);
          acc = fmaf(to_f<W>(e[j + 3]), xv.w, acc);
        }
      }
    }
    return warp_sum(acc);
  }
};

// dot(w[0:K], xs[0:K]) summed over the warp, every lane holding it:
// common.cuh dot_partial's order with four vectors' loads in flight
// (w 16-byte aligned, K a multiple of Vec<W>::N).
template <typename W>
__device__ __forceinline__ float dot_row(const W* __restrict__ w,
                                         const float* xs, int K, int lane) {
  constexpr int V = Vec<W>::N;
  float acc = 0.f;
#pragma unroll 4
  for (int k = lane * V; k < K; k += 32 * V) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(w + k));
    const W* e = reinterpret_cast<const W*>(&raw);
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + k + i);
      acc = fmaf(to_f<W>(e[i]), xv.x, acc);
      acc = fmaf(to_f<W>(e[i + 1]), xv.y, acc);
      acc = fmaf(to_f<W>(e[i + 2]), xv.z, acc);
      acc = fmaf(to_f<W>(e[i + 3]), xv.w, acc);
    }
  }
  return warp_sum(acc);
}

// The L2 lines of a weight row of K values.
template <typename W>
__device__ __forceinline__ void prefetch_row(const W* row, int K, int lane) {
  const char* p = reinterpret_cast<const char*>(row);
  const int bytes = K * (int)sizeof(W);
  for (int o = lane * 128; o < bytes; o += 32 * 128) prefetch_l2(p + o);
}

// One weight row of a warp: held in registers when it fits (REGS), else
// prefetched to L2 and read in the dot. fetch() before the dependency
// wait for weights known then, after it for a routed expert's.
template <typename W, bool REGS>
struct Row {
  const W* row = nullptr;
  RowRegs<W> regs;
  __device__ __forceinline__ void fetch(const W* r, int K, int lane) {
    row = r;
    if constexpr (REGS) {
      regs.load(r, K, lane);
    } else {
      prefetch_row<W>(r, K, lane);
    }
  }
  __device__ __forceinline__ float dot(const float* xs, int K,
                                       int lane) const {
    if constexpr (REGS) return regs.dot(xs, K, lane);
    return dot_row<W>(row, xs, K, lane);
  }
};

template <typename W>
__device__ __forceinline__ float scaled(float d, const float* scale, int row) {
  if constexpr (std::is_same<W, int8_t>::value) return d * scale[row];
  return d;
}

// LayerNorm of xs[0:K] in place (xs 16-byte aligned, K a multiple of 4),
// f32, two-pass mean / variance (the plain version's), with the
// statistics summed by every warp over the whole row (16-byte shared
// loads, warp shuffles, no block reduction): one barrier before the row is
// rewritten.
template <typename T>
__device__ __forceinline__ void layer_norm_warps(float* xs, int K, const T* g,
                                                 const T* b) {
  const int lane = threadIdx.x & 31;
  const float4* x4 = reinterpret_cast<const float4*>(xs);
  const int K4 = K / 4;
  float s = 0.f;
#pragma unroll 4
  for (int c = lane; c < K4; c += 32) {
    const float4 v = x4[c];
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = warp_sum(s) / K;
  float q = 0.f;
#pragma unroll 4
  for (int c = lane; c < K4; c += 32) {
    const float4 v = x4[c];
    const float a = v.x - mean, b2 = v.y - mean, c2 = v.z - mean,
                d = v.w - mean;
    q += (a * a + b2 * b2) + (c2 * c2 + d * d);
  }
  const float var = warp_sum(q) / K;
  const float rs = 1.f / sqrtf(var + kLnEps);
  __syncthreads();  // every warp has read the row
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    xs[k] = (xs[k] - mean) * rs * to_f<T>(g[k]) + to_f<T>(b[k]);
}

// A chain GEMV's input: stage it in xs (K floats; load or gather),
// normalise (layer_norm_warps), copy out the f32 row (block 0), round to T
// as the matmul input.
template <typename T>
__device__ __forceinline__ void stage_input(const VecIn& in, int K,
                                            float* xs) {
#pragma unroll 4
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float v;
    if (in.x == nullptr) {
      const int r = *in.root, a = *in.attr;
      v = to_f<T>(((const T*)in.emb_root)[(size_t)r * K + k]) +
          to_f<T>(((const T*)in.emb_attr)[(size_t)a * K + k]);
    } else if (in.x_is_t) {
      v = to_f<T>(((const T*)in.x)[k]);
    } else {
      v = ((const float*)in.x)[k];
    }
    xs[k] = v;
  }
  if (in.ln_g != nullptr) {
    __syncthreads();
    layer_norm_warps<T>(xs, K, (const T*)in.ln_g, (const T*)in.ln_b);
  }
  if (in.norm_out != nullptr && blockIdx.x == 0)
    for (int k = threadIdx.x; k < K; k += blockDim.x) in.norm_out[k] = xs[k];
  for (int k = threadIdx.x; k < K; k += blockDim.x) xs[k] = round_t<T>(xs[k]);
  __syncthreads();
}

// The L2 lines of `bytes` bytes at p, spread over the block's threads.
__device__ __forceinline__ void prefetch_bytes(const void* p, int bytes) {
  if (p == nullptr) return;
  for (int o = threadIdx.x * 128; o < bytes; o += blockDim.x * 128)
    prefetch_l2(reinterpret_cast<const char*>(p) + o);
}

}  // namespace v2m
