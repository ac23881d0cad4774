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
// multiple of 64: one thread-block cluster a query tile, its blocks
// splitting the slices, by the wrapper's plan (f32 in split TF32).
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
// rounded at the Pallas kernel's point. f32 (the extractors' CLIP and
// MaxViT, evaluate, compute_dtype="float32") runs attention_tf32.cuh's
// forward on the same tensor cores in split TF32 (three TF32 products a
// product, f32 accuracy): the same warps and blocks, one pass over the
// keys with an online rescale (no rounding point between the softmax and
// P . V). It replaced a first design of one thread per query row, a
// dependent FMA chain for every product and no tensor cores: 0.1316 ms at
// B=1 and 3.2065 in CLIP's form (chip run, an H100 80GB HBM3 at 700 W).
#include "attention_mma.cuh"
#include "attention_tf32.cuh"
#include "attention_wide.cuh"

// q (BH, L, D), k/v (BH, S, D), bias (bias_planes, L, S) f32 or null (BH
// a multiple of bias_planes), out (BH, L, D); D one of 16, 32, 64, 128,
// 256 or a multiple of 64 above; all contiguous, q/k/v/out of
// dtype `dtype`. wide_plan: above 256 the four ints of kernels.wide_plan
// (cluster, slices, passes, shared bytes) for the dtype, else unread.
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
  if (D > 256) {  // the head split across a cluster's blocks
    if (dtype == kF32) {
      tf32::FwdArgs a{};
      a.q = (const float*)q; a.k = (const float*)k; a.v = (const float*)v;
      a.bias = b; a.out = (float*)out;
      a.L = L; a.S = S; a.scale = scale;
      return wide::run_fwd_tf32<false>(a, BH, D, causal, bias_planes,
                                       wide_plan, st);
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
  if (dtype == kF32) {
    tf32::FwdArgs a{};
    a.q = (const float*)q; a.k = (const float*)k; a.v = (const float*)v;
    a.bias = b; a.out = (float*)out;
    a.L = L; a.S = S; a.scale = scale;
    return tf32::run_fwd<false>(a, BH, D, causal, st, bias_planes);
  }
  if (dtype == kBF16) {
    mma::FwdArgs a{};
    a.q = (const bf16*)q; a.k = (const bf16*)k; a.v = (const bf16*)v;
    a.bias = b; a.out = (bf16*)out;
    a.L = L; a.S = S; a.scale = scale;
    return mma::run_fwd_mma<false>(a, BH, D, causal, st, bias_planes);
  }
  return (int)cudaErrorInvalidValue;
}
