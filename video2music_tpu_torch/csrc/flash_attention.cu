// Fused full-sequence attention: softmax(q k^T * scale + bias + causal) v.
//
// Replaces the TPU kernel video2music_tpu/ops/pallas_attention.py:
// flash_attention (_attn_kernel, _flash_forward). Semantics kept: f32
// logits and softmax, the optional (B, H, L, S) additive bias, masked
// logits set to -1e9 (not -inf), and the causal mask start-aligned
// (key column <= query row), valid only for L == S (the wrapper checks);
// the normalized weights are rounded to v's dtype before the product.
//
// What bounds it on the H100: at the product shape (B*H = 8, L = S = 300,
// head_dim 64) the call moves 4 * 8 * 300 * 64 * 2 bytes = 1.2 MB in bf16
// (0.37 us at 3.35 TB/s) and does 4 * 8 * 300^2 * 64 = 0.18 GFLOP (0.19 us
// of bf16 tensor-core peak): far under a microsecond of either roofline,
// so latency and the blocks in flight set the time.
//
// bf16 (the product path) runs the tensor-core forward of
// attention_mma.cuh: a warp per 16 query rows, blocks of 2 warps at B=1
// (80 blocks at B*H = 8, L = 300) and 4 at larger batches; q k^T and p v
// as mma.sync m16n8k16 with f32 accumulators; K/V chunks of 64 rows
// double-buffered in shared memory by cp.async; two passes over the keys
// (row max and sum, then the rounded weights times V) so the weights are
// rounded at the Pallas kernel's point. The first design, kept for f32
// (the parity path: TF32 tensor cores would keep ~3 digits), had one
// thread per query row, 64 dependent FMAs per key for q.k and 64 more for
// the accumulator, 40 blocks at B=1, and no tensor cores: 0.133 ms at B=1
// against the 0.0098 ms of F.scaled_dot_product_attention (chip run, an
// H100 80GB HBM3 at 700 W).
#include "attention_mma.cuh"

namespace v2m {

constexpr int kAttnRows = 64;  // query rows per block (one per thread)
constexpr int kAttnTile = 32;  // K/V rows per shared-memory tile

// f32 only (bf16 runs the tensor-core forward of attention_mma.cuh).
template <int HD>
__global__ void __launch_bounds__(kAttnRows)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int L, int S, int causal,
                       float scale) {
  __shared__ float ks[kAttnTile][HD];
  __shared__ float vs[kAttnTile][HD];
  const int bh = blockIdx.y;
  const int row = blockIdx.x * kAttnRows + threadIdx.x;
  const bool live = row < L;
  const float* qb = q + (size_t)bh * L * HD;
  const float* kb = k + (size_t)bh * S * HD;
  const float* vb = v + (size_t)bh * S * HD;
  const float* brow = bias ? bias + ((size_t)bh * L + row) * S : nullptr;

  float qr[HD], acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    qr[c] = live ? qb[(size_t)row * HD + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int s0 = 0; s0 < S; s0 += kAttnTile) {
    for (int i = threadIdx.x; i < kAttnTile * HD; i += kAttnRows) {
      const int r = i / HD, c = i % HD, s = s0 + r;
      ks[r][c] = s < S ? kb[(size_t)s * HD + c] : 0.f;
      vs[r][c] = s < S ? vb[(size_t)s * HD + c] : 0.f;
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
    float* o = out + ((size_t)bh * L + row) * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) o[c] = acc[c] * inv;
  }
}

template <int HD>
static void launch(const void* q, const void* k, const void* v,
                   const float* bias, void* out, int BH, int L, int S,
                   int causal, float scale, cudaStream_t st) {
  dim3 grid((L + kAttnRows - 1) / kAttnRows, BH);
  flash_attention_kernel<HD><<<grid, kAttnRows, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, bias, (float*)out,
      L, S, causal, scale);
}

static int launch_f32(const void* q, const void* k, const void* v,
                      const float* bias, void* out, int BH, int L, int S,
                      int D, int causal, float scale, cudaStream_t st) {
  switch (D) {
    case 16: launch<16>(q, k, v, bias, out, BH, L, S, causal, scale, st); break;
    case 32: launch<32>(q, k, v, bias, out, BH, L, S, causal, scale, st); break;
    case 64: launch<64>(q, k, v, bias, out, BH, L, S, causal, scale, st); break;
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
    return launch_f32(q, k, v, b, out, BH, L, S, D, causal, scale, st);
  if (dtype == kBF16) {
    mma::FwdArgs a{};
    a.q = (const bf16*)q; a.k = (const bf16*)k; a.v = (const bf16*)v;
    a.bias = b; a.out = (bf16*)out;
    a.L = L; a.S = S; a.scale = scale;
    return mma::run_fwd_mma<false>(a, BH, D, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
