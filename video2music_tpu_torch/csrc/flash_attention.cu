// Fused full-sequence attention: softmax(q k^T * scale + bias + causal) v.
//
// Replaces the TPU kernel video2music_tpu/ops/pallas_attention.py:
// flash_attention (_attn_kernel, _flash_forward). Semantics kept: f32
// logits and softmax, the optional (B, H, L, S) additive bias, masked
// logits set to -1e9 (not -inf), and the causal mask start-aligned
// (key column <= query row), valid only for L == S (the wrapper checks).
//
// What bounds it on the H100: at the product shape (B*H = 8, L = S = 300,
// head_dim 64) the whole problem is 8 * 300 * 300 * 64 * 2 * 2 = 0.18
// GFLOP and 0.6 MB of q/k/v, far under a microsecond of either roofline, so
// the kernel is bound by latency and by the few blocks in flight (8 heads x
// 5 query tiles = 40 blocks on 132 SMs). The Pallas kernel held a whole K/V
// panel in VMEM; here K/V stream through shared memory in 32-row tiles with
// an online softmax (running max and sum in registers), so nothing of size
// (L, S) is ever written. Each thread owns one query row: q and the output
// accumulator live in registers (2 * head_dim floats), the K/V tile is read
// from shared memory as a broadcast. Plain FMA, no tensor cores: a later
// change can move the two products onto mma/wgmma.
#include "common.cuh"

namespace v2m {

constexpr int kAttnRows = 64;  // query rows per block (one per thread)
constexpr int kAttnTile = 32;  // K/V rows per shared-memory tile

template <typename T, int HD>
__global__ void __launch_bounds__(kAttnRows)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ bias, T* __restrict__ out,
                       int L, int S, int causal, float scale) {
  __shared__ float ks[kAttnTile][HD];
  __shared__ float vs[kAttnTile][HD];
  const int bh = blockIdx.y;
  const int row = blockIdx.x * kAttnRows + threadIdx.x;
  const bool live = row < L;
  const T* qb = q + (size_t)bh * L * HD;
  const T* kb = k + (size_t)bh * S * HD;
  const T* vb = v + (size_t)bh * S * HD;
  const float* brow = bias ? bias + ((size_t)bh * L + row) * S : nullptr;

  float qr[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    qr[c] = live ? to_f<T>(qb[(size_t)row * HD + c]) : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int s0 = 0; s0 < S; s0 += kAttnTile) {
    for (int i = threadIdx.x; i < kAttnTile * HD; i += kAttnRows) {
      const int r = i / HD, c = i % HD, s = s0 + r;
      ks[r][c] = s < S ? to_f<T>(kb[(size_t)s * HD + c]) : 0.f;
      vs[r][c] = s < S ? to_f<T>(vb[(size_t)s * HD + c]) : 0.f;
    }
    __syncthreads();
    if (live) {
      const int n = min(kAttnTile, S - s0);
      float sc[kAttnTile];
      float tmax = m;
#pragma unroll
      for (int j = 0; j < kAttnTile; ++j) {
        if (j < n) {
          float d = 0.f;
#pragma unroll
          for (int c = 0; c < HD; ++c) d = fmaf(qr[c], ks[j][c], d);
          d *= scale;
          if (brow) d += brow[s0 + j];
          if (causal && s0 + j > row) d = -1e9f;
          sc[j] = d;
          tmax = fmaxf(tmax, d);
        }
      }
      const float corr = expf(m - tmax);
      l *= corr;
#pragma unroll
      for (int c = 0; c < HD; ++c) acc[c] *= corr;
#pragma unroll
      for (int j = 0; j < kAttnTile; ++j) {
        if (j < n) {
          const float p = expf(sc[j] - tmax);
          l += p;
#pragma unroll
          for (int c = 0; c < HD; ++c) acc[c] = fmaf(p, vs[j][c], acc[c]);
        }
      }
      m = tmax;
    }
    __syncthreads();
  }
  if (live) {
    const float inv = 1.f / l;
    T* o = out + ((size_t)bh * L + row) * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) o[c] = from_f<T>(acc[c] * inv);
  }
}

template <typename T, int HD>
static void launch(const void* q, const void* k, const void* v,
                   const float* bias, void* out, int BH, int L, int S,
                   int causal, float scale, cudaStream_t st) {
  dim3 grid((L + kAttnRows - 1) / kAttnRows, BH);
  flash_attention_kernel<T, HD><<<grid, kAttnRows, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (T*)out, L, S, causal,
      scale);
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v,
                    const float* bias, void* out, int BH, int L, int S, int D,
                    int causal, float scale, cudaStream_t st) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, bias, out, BH, L, S, causal, scale, st); break;
    case 32: launch<T, 32>(q, k, v, bias, out, BH, L, S, causal, scale, st); break;
    case 64: launch<T, 64>(q, k, v, bias, out, BH, L, S, causal, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace v2m

// q (BH, L, D), k/v (BH, S, D), bias (BH, L, S) f32 or null, out (BH, L, D);
// all contiguous, q/k/v/out of dtype `dtype`. Returns a cudaError_t code.
extern "C" int v2m_flash_attention(int dtype, const void* q, const void* k,
                                   const void* v, const void* bias, void* out,
                                   int BH, int L, int S, int D, int causal,
                                   float scale, void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  const float* b = (const float*)bias;
  if (dtype == kF32)
    return dispatch<float>(q, k, v, b, out, BH, L, S, D, causal, scale, st);
  if (dtype == kBF16)
    return dispatch<bf16>(q, k, v, b, out, BH, L, S, D, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
