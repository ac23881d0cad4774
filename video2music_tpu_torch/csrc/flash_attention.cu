// Fused full-sequence attention: softmax(q k^T * scale + bias + causal) v.
//
// Replaces the TPU kernel video2music_tpu/ops/pallas_attention.py:
// flash_attention (_attn_kernel, _flash_forward). Semantics kept: f32
// logits and softmax, the optional (B, H, L, S) additive bias, masked
// logits set to -1e9 (not -inf), and the causal mask start-aligned
// (key column <= query row), valid only for L == S (the wrapper checks);
// the normalized weights are rounded to v's dtype before the product.
// The scale is an argument (CLIP's head_dim^-0.5, MaxViT's full channel
// width C^-0.5), and the bias may have fewer planes than B*H: (b, h)
// reads plane bh % bias_planes, so MaxViT's (heads, 49, 49) relative-
// position bias serves every window without a (windows, heads, 49, 49)
// copy (37 MB a call at stage 0 of a 30-frame chunk).
// Head sizes: instances at 16, 32, 64, 128 and 256; the wrapper pads any
// other head size up to the next with zero columns (as the Pallas wrapper
// pads D to a multiple of 128), which change neither q . k nor the kept
// columns of P . V, and passes the unpadded scale. The tiles live in
// dynamic shared memory (above 48 KB at 128 and 256). Above 256 the head
// is split into 64-column slices (attention_wide.cuh), D padded to a
// multiple of 64; in bf16 one thread-block cluster a query tile, its
// blocks splitting the slices, by the wrapper's plan.
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
#include "attention_wide.cuh"

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
  constexpr int kUnrollHD = mma::unroll_hd(HD);
  // K and V tiles (f32_smem bytes)
  float (*ks)[HD] = reinterpret_cast<float (*)[HD]>(mma::attn_smem);
  float (*vs)[HD] = ks + kAttnTile;
  // grid (row blocks, bias planes, B*H / planes): (b, h) = blockIdx.z *
  // planes + blockIdx.y reads bias plane blockIdx.y (bh % planes in the
  // kernel ran 8-9% slower on an H100 80GB HBM3, with or without a bias)
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const int row = blockIdx.x * kAttnRows + threadIdx.x;
  const bool live = row < L;
  const float* qb = q + (size_t)bh * L * HD;
  const float* kb = k + (size_t)bh * S * HD;
  const float* vb = v + (size_t)bh * S * HD;
  const float* brow =
      bias ? bias + ((size_t)blockIdx.y * L + row) * S : nullptr;

  float qr[HD], acc[HD];
#pragma unroll kUnrollHD
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
#pragma unroll kUnrollHD
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
#pragma unroll kUnrollHD
      for (int c = 0; c < HD; ++c) acc[c] *= corr;
#pragma unroll
      for (int j = 0; j < kAttnTile; ++j) {
        if (j < n) {
          const float p = expf(sc[j] - tmax);
          l += p;
#pragma unroll kUnrollHD
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
#pragma unroll kUnrollHD
    for (int c = 0; c < HD; ++c) o[c] = acc[c] * inv;
  }
}

template <int HD>
constexpr size_t f32_smem() {
  return 2 * kAttnTile * HD * sizeof(float);
}

template <int HD>
static int launch(const void* q, const void* k, const void* v,
                  const float* bias, int bias_planes, void* out, int BH,
                  int L, int S, int causal, float scale, cudaStream_t st) {
  static bool opted_in = false;
  const int err = mma::smem_opt_in(flash_attention_kernel<HD>, f32_smem<HD>(),
                                   opted_in);
  if (err) return err;
  dim3 grid((L + kAttnRows - 1) / kAttnRows, bias_planes, BH / bias_planes);
  flash_attention_kernel<HD><<<grid, kAttnRows, f32_smem<HD>(), st>>>(
      (const float*)q, (const float*)k, (const float*)v, bias, (float*)out,
      L, S, causal, scale);
  return 0;
}

// Head sizes 16, 32, 64, 128 and 256 (the wrapper pads the others with
// zero columns). At 128 and 256 a thread's q row and accumulator pass the
// register file and spill to local memory: right, and slow.
static int launch_f32(const void* q, const void* k, const void* v,
                      const float* bias, int planes, void* out, int BH,
                      int L, int S, int D, int causal, float scale,
                      cudaStream_t st) {
  int err;
  switch (D) {
    case 16: err = launch<16>(q, k, v, bias, planes, out, BH, L, S, causal, scale, st); break;
    case 32: err = launch<32>(q, k, v, bias, planes, out, BH, L, S, causal, scale, st); break;
    case 64: err = launch<64>(q, k, v, bias, planes, out, BH, L, S, causal, scale, st); break;
    case 128: err = launch<128>(q, k, v, bias, planes, out, BH, L, S, causal, scale, st); break;
    case 256: err = launch<256>(q, k, v, bias, planes, out, BH, L, S, causal, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace v2m

// q (BH, L, D), k/v (BH, S, D), bias (bias_planes, L, S) f32 or null (BH
// a multiple of bias_planes), out (BH, L, D); D one of 16, 32, 64, 128,
// 256 or a multiple of 64 above; all contiguous, q/k/v/out of
// dtype `dtype`. wide_plan: above 256 in bf16 the four ints of
// kernels.wide_plan (cluster, slices, passes, shared bytes), else unread.
// Returns a cudaError_t code.
extern "C" int v2m_flash_attention(int dtype, const void* q, const void* k,
                                   const void* v, const void* bias,
                                   int bias_planes, void* out, int BH, int L,
                                   int S, int D, int causal, float scale,
                                   const int* wide_plan, void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  const float* b = (const float*)bias;
  if (bias_planes <= 0 || BH % bias_planes) return (int)cudaErrorInvalidValue;
  if (D > 256) {  // the head split across blocks
    if (dtype == kF32) {
      wide::F32Args a{};
      a.q = (const float*)q; a.k = (const float*)k; a.v = (const float*)v;
      a.bias = b; a.out = (float*)out;
      a.L = L; a.S = S; a.D = D; a.causal = causal; a.scale = scale;
      return wide::run_fwd_f32<false>(a, BH, bias_planes, st);
    }
    if (dtype == kBF16) {
      mma::FwdArgs a{};
      a.q = (const bf16*)q; a.k = (const bf16*)k; a.v = (const bf16*)v;
      a.bias = b; a.out = (bf16*)out;
      a.L = L; a.S = S; a.scale = scale;
      return wide::run_fwd_mma<false>(a, BH, D, causal, bias_planes,
                                      wide_plan, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == kF32)
    return launch_f32(q, k, v, b, bias_planes, out, BH, L, S, D, causal,
                      scale, st);
  if (dtype == kBF16) {
    mma::FwdArgs a{};
    a.q = (const bf16*)q; a.k = (const bf16*)k; a.v = (const bf16*)v;
    a.bias = b; a.out = (bf16*)out;
    a.L = L; a.S = S; a.scale = scale;
    return mma::run_fwd_mma<false>(a, BH, D, causal, st, bias_planes);
  }
  return (int)cudaErrorInvalidValue;
}
