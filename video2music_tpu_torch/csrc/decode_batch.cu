// One batched (B>1) decoder-layer step of AMT 2.2 (post-norm V2 wiring):
// B clips at one shared position, as batched serving decodes them.
//
// Replaces two TPU kernels:
//   * video2music_tpu/ops/pallas_decode_batch.py:batched_layer_step
//     (_attn_kernel_b, _batched_prologue, _wide_attention, _embed_rows_b):
//     optional chord-embedding prologue, fused QKV + pairwise RoPE, masked
//     self-attention over each clip's cache, cross-attention over its
//     primed memory, and the SwiGLU FFN of a shallow layer;
//   * video2music_tpu/ops/pallas_decode_batch.py:batched_moe_ffn
//     (_moe_kernel_b, gate=True, with or without the head): per-row router,
//     shared expert / k, routed experts weighted by their combine weights,
//     residual + norm3, and optionally the final LayerNorm + chord head.
// The Pallas kernel's sublane-stacked slabs, one-hot replication matmuls,
// (C, C) diagonal probe and one-hot bias rows answer Mosaic limits and are
// not carried over: here every block computes its own offsets.
//
// Rounding follows the batched Pallas kernel: every matmul input is rounded
// to the compute dtype T and accumulated in f32; q, the cache-row
// probabilities before P.V and the attention output are rounded to T, the
// current row's probability stays f32; the deep layer's x2 leaves as T.
// Unlike the Pallas kernel, this step's K/V rows are written IN PLACE into
// the (B, S, D) self caches at (b, pos).
//
// The int8-KV form (quant = 1, kv_quant="int8"; the Pallas kernel's
// quant=True with _quant_rows and the k / v scale folds of
// _wide_attention): the four caches are int8 with an f32 scale per row.
// A row's scale needs the max over all D lanes, which the QKV GEMV spreads
// over warps and blocks, so the GEMV leaves the f32 roped K | V rows in the
// workspace and quant_rows_kernel (one block per clip and K or V) reduces
// the max, writes the int8 row and its scale at (b, pos) with IEEE
// divisions and round-half-to-even (quantize_kv_rows bit for bit), and
// keeps the dequantized row, rounded to T, for the current row's term.
// Attention then runs its int8 instance (attn_kernel<T, int8_t>): 16 cache
// values a load (8 at a head size that is a multiple of 8 but not of 16,
// e.g. d_model 512 at 64 heads: instances of their own; value pairs in
// attn_any_kernel<T, int8_t> at any other even head size), the scales
// folded into the logits and probabilities.
//
// What bounds it on the H100: bytes. One deep layer's attention half at
// B=16, pos 150, bf16 reads the attention block's weights once (2.6 MB),
// the clips' self K/V up to pos (4.9 MB) and cross K/V (9.8 MB): ~17 MB,
// ~5.4 us at 3.35 TB/s (computed from the shapes, not measured); from B ~ 16
// up the caches, not the weights, set the pace. A chain of 7 launches (4
// GEMVs, 2 attentions, the closing norm) pays each launch's fixed latency
// on top. What the design does (csrc/batch_decode.cuh):
//   * the bf16 GEMVs run on the tensor cores (mma.sync, the weights as the
//     A operand, the clips as the B operand, K split over a block's warps),
//     16 clips a block (the other groups' blocks read the weights from
//     L2); f32 keeps the FMA kernel;
//   * attention: one block per (head, clip), so B x 8 blocks are in
//     flight; 16-byte loads along D, a row per thread for the logits and
//     row groups for P.V (a B=1 call splits each head over a cluster);
//   * every launch uses programmatic dependent launch: a GEMV fetches its
//     weights before it waits for the previous kernel, overlapping that
//     kernel's tail and the launch gap;
//   * experts: a slot is the shared expert (0) or expert e (e + 1), each
//     expert's weights read once for the batch. Dense (a.dense, chosen by
//     decode_batch.py dense_experts), every slot takes every clip on the
//     tensor cores, with no clip lists, and the close adds only the
//     selected experts' outputs; routed, a slot stages and computes only
//     the clips the router listed for it on the FMA kernel (expert ids and
//     lists stay in device memory). The router keeps no fixed-size
//     selection: any E, any k_top <= E.
#include "batch_decode.cuh"

namespace v2m {
namespace batch {

// Field order must match BatchLayerArgs in kernels.py.
struct V2MBatchLayer {
  const void *x; void *y;
  const void *wqkv, *bqkv, *wo, *bo, *cwq, *cbq, *cwo, *cbo;
  const void *norm_scale, *norm_bias;
  const void *w1g, *b1g, *w2, *b2;
  const float *rope_cos, *rope_sin;
  void *k_cache, *v_cache;
  const void *k_cross, *v_cross;
  float *work;
  const int *token_root, *token_attr;
  const float *key;
  const void *emb_root, *emb_attr, *lc_w, *lc_krow, *lc_b;
  float *k_scale, *v_scale;             // int8 KV: (B, S) row scales
  const float *ck_scale, *cv_scale;     // and the cross K/V's (B, Sm)
  int shallow, B, D, H, F, S, Sm, pos, quant;
};

// grid (B, 2): block (b, 0) quantizes clip b's K row, (b, 1) its V row,
// from the f32 rows kv (B, 2, D) the QKV GEMV left: s = max|x| / 127 (1 for
// an all-zero row), q = round(x / s) half to even, both divisions IEEE
// (ops/decode_batch.py quantize_kv_rows bit for bit). Writes q at (b, pos)
// of the int8 cache and s at (b, pos) of its scales, and the dequantized
// row round_t(q * s) to deq (B, 2, D) for the current row's attention term.
template <typename T>
static __global__ void __launch_bounds__(kThreads)
quant_rows_kernel(const float* __restrict__ kv, int D, int S, int pos,
                  int8_t* k_cache, int8_t* v_cache, float* k_scale,
                  float* v_scale, float* __restrict__ deq) {
  __shared__ float red[32];
  const int b = blockIdx.x, which = blockIdx.y;
  pdl_wait();
  const float* x = kv + ((size_t)b * 2 + which) * D;
  float m = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) m = fmaxf(m, fabsf(x[d]));
  m = block_max(m, red);
  float s = __fdiv_rn(m, 127.f);
  if (s == 0.f) s = 1.f;
  int8_t* row = (which ? v_cache : k_cache) + ((size_t)b * S + pos) * D;
  float* out = deq + ((size_t)b * 2 + which) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float q = rintf(__fdiv_rn(x[d], s));
    row[d] = (int8_t)q;
    out[d] = round_t<T>(q * s);
  }
  if (threadIdx.x == 0) (which ? v_scale : k_scale)[(size_t)b * S + pos] = s;
}

// Field order must match BatchMoeArgs in kernels.py.
struct V2MBatchMoe {
  const void *x2; void *out;
  const void *gate_w, *gate_b, *w1g, *b1g, *w2, *b2;
  const void *ew1g, *eb1g, *ew2, *eb2;
  const void *norm_scale, *norm_bias;
  const void *dn_scale, *dn_bias, *wout, *bout;
  float *work;
  int *sel;
  int B, D, F, E, k_top, n_out;
  int dense;  // decode_batch.py dense_experts
};

template <typename T>
static int run_layer(const V2MBatchLayer& a, cudaStream_t st) {
  const int B = a.B, D = a.D, F = a.F, hd = D / a.H;
  const size_t BD = (size_t)B * D;
  // f32 workspace, laid out as in decode_batch.py:layer_workspace_size
  float* x0 = a.work;    // layer input (f32 copy)
  float* q = x0 + BD;    // roped self-attention query, rounded
  float* attn = q + BD;  // self-attention output
  float* r1 = attn + BD; // x0 + attention block (pre-LN)
  float* x1 = r1 + BD;   // LN1
  float* cq = x1 + BD;   // roped cross query, rounded
  float* cattn = cq + BD;
  float* r2 = cattn + BD;  // x1 + cross block (pre-LN)
  float* x2 = r2 + BD;     // LN2
  float* r3 = x2 + BD;     // x2 + ffn (pre-LN)
  float* act = r3 + BD;    // (B, F) SwiGLU activations
  float* kv = act + (size_t)B * F;  // int8 KV: (B, 2, D) f32 K | V rows
  float* deq = kv + 2 * BD;         // and their dequantized copies
  const T* norm_g = (const T*)a.norm_scale;
  const T* norm_b = (const T*)a.norm_bias;
  const bool embed = a.token_root != nullptr;
  const bool quant = a.quant != 0;
  int err;

  if (embed) {  // x0 = round(lc_w . round(emb) + key * lc_krow + lc_b)
    BGemv g = {};
    g.in.root = a.token_root;
    g.in.attr = a.token_attr;
    g.in.emb_root = a.emb_root;
    g.in.emb_attr = a.emb_attr;
    g.w = a.lc_w;
    g.bias = a.lc_b;
    g.B = B;
    g.K = D;
    g.units = D;
    g.key = a.key;
    g.krow = a.lc_krow;
    g.out_f = x0;
    g.round_out = 1;
    if ((err = gemv<T, kPlain>(g, 1, st))) return err;
  }
  {  // qkv + RoPE; q rounded, K/V rows into the caches at (b, pos)
    BGemv g = {};
    g.in.x = embed ? (const void*)x0 : a.x;
    g.in.x_is_t = embed ? 0 : 1;
    g.in.norm_out = embed ? nullptr : x0;
    g.w = a.wqkv;
    g.bias = a.bqkv;
    g.B = B;
    g.K = D;
    g.units = 3 * D / 2;
    g.cos = a.rope_cos;
    g.sin = a.rope_sin;
    g.pos = a.pos;
    g.hd = hd;
    g.rope_rows = a.rope_cos != nullptr ? 2 * D : 0;
    g.q_rows = D;
    g.k_rows = D;
    g.D = D;
    g.S = a.S;
    g.out_f = q;
    g.k_cache = a.k_cache;
    g.v_cache = a.v_cache;
    if (quant) {  // f32 K | V rows, quantized into the caches next
      g.kv_f = kv;
      if ((err = gemv<T, kRopeF>(g, 1, st))) return err;
      if ((err = launch(quant_rows_kernel<T>, dim3(B, 2), kThreads, 0, st, 0,
                        (const float*)kv, D, a.S, a.pos, (int8_t*)a.k_cache,
                        (int8_t*)a.v_cache, a.k_scale, a.v_scale, deq)))
        return err;
    } else if ((err = gemv<T, kRope>(g, 1, st))) {
      return err;
    }
  }
  Attn t = {};  // self-attention over rows <= pos, row pos kept f32
  t.q = q;
  t.k = a.k_cache;
  t.v = a.v_cache;
  t.out = attn;
  t.rows = a.pos + 1;
  t.stride_rows = a.S;
  t.D = D;
  t.hd = hd;
  t.cur = a.pos;
  t.batched = 1;
  t.scale = 1.f / sqrtf((float)hd);
  if (quant) {
    t.k_scale = a.k_scale;
    t.v_scale = a.v_scale;
    t.k_cur = deq;
    t.v_cur = deq + D;
    t.cur_stride = 2 * D;
    err = attention<T, int8_t>(t, B, a.H, st);
  } else {
    err = attention<T>(t, B, a.H, st);
  }
  if (err) return err;
  {  // r1 = x0 + (wo . attn + bo)
    BGemv g = {};
    g.in.x = attn;
    g.w = a.wo;
    g.bias = a.bo;
    g.B = B;
    g.K = D;
    g.units = D;
    g.residual = x0;
    g.out_f = r1;
    if ((err = gemv<T, kPlain>(g, 1, st))) return err;
  }
  {  // x1 = LN1(r1); cq = round(rope(cwq . x1 + cbq))
    BGemv g = {};
    g.in.x = r1;
    g.in.ln_g = norm_g;
    g.in.ln_b = norm_b;
    g.in.norm_out = x1;
    g.w = a.cwq;
    g.bias = a.cbq;
    g.B = B;
    g.K = D;
    g.units = D / 2;
    g.cos = a.rope_cos;
    g.sin = a.rope_sin;
    g.pos = a.pos;
    g.hd = hd;
    g.rope_rows = a.rope_cos != nullptr ? D : 0;
    g.q_rows = D;
    g.D = D;
    g.S = a.S;
    g.out_f = cq;
    if ((err = gemv<T, kRope>(g, 1, st))) return err;
  }
  t.q = cq;  // cross-attention over each clip's Sm primed rows
  t.k = a.k_cross;
  t.v = a.v_cross;
  t.out = cattn;
  t.rows = t.stride_rows = a.Sm;
  t.cur = -1;
  if (quant) {
    t.k_scale = a.ck_scale;
    t.v_scale = a.cv_scale;
    err = attention<T, int8_t>(t, B, a.H, st);
  } else {
    err = attention<T>(t, B, a.H, st);
  }
  if (err) return err;
  {  // r2 = x1 + (cwo . cattn + cbo)
    BGemv g = {};
    g.in.x = cattn;
    g.w = a.cwo;
    g.bias = a.cbo;
    g.B = B;
    g.K = D;
    g.units = D;
    g.residual = x1;
    g.out_f = r2;
    if ((err = gemv<T, kPlain>(g, 1, st))) return err;
  }
  Close ln = {};
  ln.norm = kLayerNorm;
  ln.B = B;
  ln.K = D;
  ln.out_t = a.y;
  if (a.shallow) {
    BGemv g = {};  // x2 = LN2(r2); act = swiglu(w1g . x2 + b1g)
    g.in.x = r2;
    g.in.ln_g = norm_g + D;
    g.in.ln_b = norm_b + D;
    g.in.norm_out = x2;
    g.w = a.w1g;
    g.bias = a.b1g;
    g.B = B;
    g.K = D;
    g.units = F;
    g.F = F;
    g.out_f = act;
    if ((err = gemv<T, kSwiglu>(g, 1, st))) return err;
    BGemv g2 = {};  // r3 = x2 + (w2 . act + b2)
    g2.in.x = act;
    g2.w = a.w2;
    g2.bias = a.b2;
    g2.B = B;
    g2.K = F;
    g2.units = D;
    g2.residual = x2;
    g2.out_f = r3;
    if ((err = gemv<T, kPlain>(g2, 1, st))) return err;
    ln.x = r3;  // y = round(LN3(r3))
    ln.g = norm_g + 2 * D;
    ln.bn = norm_b + 2 * D;
  } else {
    ln.x = r2;  // deep: y = round(LN2(r2)), finished by the MoE step
    ln.g = norm_g + D;
    ln.bn = norm_b + D;
  }
  return close_rows<T>(ln, st);
}

template <typename T>
static int run_moe(const V2MBatchMoe& a, cudaStream_t st) {
  const int B = a.B, D = a.D, F = a.F, E = a.E;
  if (a.k_top < 1 || a.k_top > E) return (int)cudaErrorInvalidValue;
  // f32 workspace, laid out as in decode_batch.py:moe_workspace_size
  float* selw = a.work;                             // (B, k_top)
  float* act = selw + selw_floats(B * a.k_top);     // (E + 1, B, F)
  float* ye = act + (size_t)(E + 1) * B * F;        // (E + 1, B, D)
  float* x3 = ye + (size_t)(E + 1) * B * D;         // (B, D) for the head
  // int workspace, as in decode_batch.py:moe_route_size
  int* counts = a.sel + (size_t)B * a.k_top;        // (E) clips per expert
  int* lists = counts + E;                          // (E, B) their ids
  const bool dense = a.dense != 0;
  if (dense) counts = lists = nullptr;
  int err;
  if (!dense &&
      (err = (int)cudaMemsetAsync(counts, 0, E * sizeof(int), st)))
    return err;
  if ((err = route<T, T>((const T*)a.x2, (const T*)a.gate_w,
                         (const T*)a.gate_b, B, D, E, a.k_top, a.sel, selw,
                         counts, lists, st)))
    return err;
  {  // [w1|wg] of the shared expert (slot 0) and every expert (slot e + 1)
    BGemv g = {};
    g.in.x = a.x2;
    g.in.x_is_t = 1;
    g.w = a.w1g;
    g.bias = a.b1g;
    g.ew = a.ew1g;
    g.eb = a.eb1g;
    g.counts = counts;
    g.lists = lists;
    g.B = B;
    g.K = D;
    g.n_rows = 2 * F;
    g.units = F;
    g.F = F;
    g.out_f = act;
    if ((err = gemv<T, kSwiglu>(g, E + 1, st))) return err;
  }
  {  // w2 of each slot over its own activations: ye[slot, b] = w2 . act + b2
    BGemv g = {};
    g.in.x = act;
    g.in.slot_stride = (size_t)B * F;
    g.w = a.w2;
    g.bias = a.b2;
    g.ew = a.ew2;
    g.eb = a.eb2;
    g.counts = counts;
    g.lists = lists;
    g.B = B;
    g.K = F;
    g.n_rows = D;
    g.units = D;
    g.out_f = ye;
    if ((err = gemv<T, kPlain>(g, E + 1, st))) return err;
  }
  const bool head = a.wout != nullptr;
  {  // x3 = LN3(x2 + shared / k + sum_e w_e expert_e)
    Close ln = {};
    ln.x = a.x2;
    ln.x_is_t = 1;
    ln.ye = ye;
    ln.shared = 1;
    ln.sel = a.sel;
    ln.selw = selw;
    ln.k_top = a.k_top;
    ln.g = (const T*)a.norm_scale + 2 * D;
    ln.bn = (const T*)a.norm_bias + 2 * D;
    ln.norm = kLayerNorm;
    ln.B = B;
    ln.K = D;
    if (head) {
      ln.out_f = x3;
      ln.round_f = 1;
    } else {
      ln.out_t = a.out;
    }
    if ((err = close_rows<T>(ln, st))) return err;
  }
  if (head) {  // logits = round(wout . round(LN(round(x3))) + bout)
    BGemv g = {};
    g.in.x = x3;
    g.in.ln_g = a.dn_scale;
    g.in.ln_b = a.dn_bias;
    g.w = a.wout;
    g.bias = a.bout;
    g.B = B;
    g.K = D;
    g.units = a.n_out;
    g.out_t = a.out;
    if ((err = gemv<T, kPlain>(g, 1, st))) return err;
  }
  return (int)cudaGetLastError();
}

}  // namespace batch
}  // namespace v2m

// Launch one batched layer's attention half (+ SwiGLU FFN when shallow) on
// `stream`. Returns a cudaError_t code; never synchronises.
extern "C" int v2m_batched_layer(int dtype,
                                 const v2m::batch::V2MBatchLayer* args,
                                 void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  if (args->quant && (args->D % 8 || args->H <= 0 ||
                      (args->D / args->H) % 2))
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return batch::run_layer<float>(*args, st);
  if (dtype == kBF16) return batch::run_layer<bf16>(*args, st);
  return (int)cudaErrorInvalidValue;
}

// Launch one batched MoE half (router, experts, norm3, optional head) on
// `stream`. Returns a cudaError_t code; never synchronises.
extern "C" int v2m_batched_moe(int dtype, const v2m::batch::V2MBatchMoe* args,
                               void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) return batch::run_moe<float>(*args, st);
  if (dtype == kBF16) return batch::run_moe<bf16>(*args, st);
  return (int)cudaErrorInvalidValue;
}

// y = x . w^T + bias for B rows of x (B, K) and w (N, K), T out: the GEMV
// of the chains above alone (the tensor cores for bf16 at B >= 2), for
// timing it beside one library call. Returns a cudaError_t code.
extern "C" int v2m_batched_gemv(int dtype, const void* x, const void* w,
                                const void* bias, void* y, int B, int K,
                                int N, void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  batch::BGemv g = {};
  g.in.x = x;
  g.in.x_is_t = 1;
  g.w = w;
  g.bias = bias;
  g.B = B;
  g.K = K;
  g.units = N;
  g.out_t = y;
  if (dtype == kF32) return batch::gemv<float, batch::kPlain>(g, 1, st);
  if (dtype == kBF16) return batch::gemv<bf16, batch::kPlain>(g, 1, st);
  return (int)cudaErrorInvalidValue;
}
