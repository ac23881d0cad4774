// One B=1 decoder-layer step of AMT 2.2 (post-norm V2 wiring), optionally
// with the chord-embedding prologue and the final-LayerNorm + chord-head
// epilogue folded in.
//
// Replaces two TPU kernels:
//   * video2music_tpu/ops/pallas_decode.py:decode_layer_step
//     (_shallow_kernel, _deep_kernel): fused QKV, pairwise RoPE, cache
//     append at pos, masked self-attention over rows <= pos, cross-attention
//     over the primed memory, then SwiGLU or the top-k shared-expert MoE;
//   * video2music_tpu/ops/pallas_decode_stack.py:decode_flat_monolith_step
//     (_flat_monolith_kernel) as the product uses it, a one-layer run with
//     the embed prologue (layer 0: root+attr rows, Linear_chord as
//     emb @ lc_w[:D] + key * lc_w[D] + b) or the head epilogue (last layer:
//     final LayerNorm and the 159-way Wout).
// The f32 accumulation, the rounding of every matmul input to the compute
// dtype, the f32 residual stream inside the layer and the rounding of the
// layer output follow the Pallas kernels, which follow the XLA path.
//
// What bounds it on the H100: one step reads every weight of the layer once
// at B=1. Per step of the full 2.2 decoder that is 3 shallow layers x 6.3 MB
// + 3 deep layers x 12.6 MB (attention + shared expert + 2 of 6 experts) =
// 57 MB in bf16, plus ~7 MB of caches: ~19 us at 3.35 TB/s if the card
// streamed at peak (computed from the shapes, not measured). A TPU kernel
// could run one layer in one core from VMEM; a single CUDA block would read
// those megabytes through one SM. So the layer is a short chain of launches
// on one stream, each spread over many SMs:
//   1. [embed]  GEMV Linear_chord over the gathered embedding rows;
//   2. QKV GEMV, one warp per output pair, with bias + RoPE and the K/V
//      append into the caches at row pos (the caches are updated IN PLACE);
//   3. cached self-attention, one block per head, over rows <= pos;
//   4. out-projection GEMV + residual;
//   5. LayerNorm (recomputed in every block's prologue) + cross-q GEMV + RoPE;
//   6. cross-attention over the Sm primed memory rows;
//   7. cross out-projection GEMV + residual;
//   8. shallow: LayerNorm + [linear1|gate] GEMV with the SwiGLU epilogue,
//      then linear2 GEMV + residual;
//      deep: router (LayerNorm, 512 x E gate GEMV, top-k with first-index
//      tie-break, softmax over the selected raw logits; the expert ids stay
//      in device memory), one GEMV over the shared expert and the selected
//      experts' [w1|wg] rows, one GEMV over their w2 rows that combines
//      shared/k + sum_j w_j * expert_j + residual;
//   9. the closing LayerNorm, rounded to the compute dtype;
//  10. [head] LayerNorm + Wout GEMV.
// Weights are stored (out, in) row-major so that each output row is one
// contiguous dot product read with 16-byte loads by one warp. Plain FMA and
// warp shuffles, no tensor cores: at B=1 every weight byte is used once.
// With int8 weights (pack_decoder_layers(quantize="int8"), the Pallas
// kernel's int8 form) the layer's GEMVs read int8 rows and scale each f32
// dot by its row's scale before the bias: half the weight bytes of bf16.
// The embed and head GEMVs stay in the compute dtype. The device code is in
// decode_step.cuh, shared with the cooperative kernel of decode_stack.cu.
#include "decode_step.cuh"

namespace v2m {

// Field order must match DecodeLayerArgs in kernels.py.
struct V2MDecodeLayer {
  const void *x; void *y;
  const void *wqkv, *bqkv, *wo, *bo, *cwq, *cbq, *cwo, *cbo;
  const void *norm_scale, *norm_bias;
  const void *w1g, *b1g, *w2, *b2;
  const void *gate_w, *gate_b, *ew1g, *eb1g, *ew2, *eb2;
  const float *rope_cos, *rope_sin;
  void *k_cache, *v_cache;
  const void *k_cross, *v_cross;
  float *work;
  int *sel;
  const int *token_root, *token_attr;
  const float *key;
  const void *emb_root, *emb_attr, *lc_w, *lc_krow, *lc_b;
  const void *dn_scale, *dn_bias, *wout, *bout;
  void *logits;
  // int8 weights: the f32 row scales of wqkv, wo, cwq, cwo, w1g, w2 and the
  // experts' ew1g (E, 2F) / ew2 (E, D); all null for T weights
  const float *wqkv_s, *wo_s, *cwq_s, *cwo_s, *w1g_s, *w2_s, *ew1g_s, *ew2_s;
  int D, H, F, E, k_top, Sm, n_out, pos;
};

template <typename T, typename W, int EPI>
__global__ void __launch_bounds__(kThreads) gemv_kernel(GemvArgs a) {
  extern __shared__ __align__(16) float xs[];
  __shared__ float red[32];
  load_input<T>(a.in, a.K, xs, red);
  const int unit = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit < a.units) gemv_unit<T, W, EPI>(a, xs, unit);
}

// One block per head (attention_head).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cached_attention_kernel(const float* q, const T* k, const T* v, float* out,
                        int rows, int D, int hd, float scale) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  attention_head<T, true>(q, k, v, out, rows, D, hd, scale, blockIdx.x, sm,
                          red);
}

template <typename T>
static size_t attention_smem(int hd, int rows) {
  return (size_t)attention_smem_floats<T>(hd, rows) * sizeof(float);
}

// MoE router at B=1 (one block): LayerNorm in the prologue (block 0 stores
// x2), then route(). Writes the expert ids and weights.
template <typename T>
__global__ void __launch_bounds__(kThreads)
router_kernel(VecIn in, int K, const T* gate_w, const T* gate_b, int E,
              int k_top, int* sel, float* selw) {
  extern __shared__ __align__(16) float xs[];
  __shared__ float red[32];
  __shared__ float logit[32];
  load_input<T>(in, K, xs, red);
  route<T>(xs, K, gate_w, gate_b, E, k_top, logit, sel, selw);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
moe_up_kernel(VecIn in, int K, int F, int slots, MoeWeights<T, W> m,
              const int* sel, float* act) {
  extern __shared__ __align__(16) float xs[];
  __shared__ float red[32];
  load_input<T>(in, K, xs, red);
  const int unit = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit < slots * F) moe_up_unit<T, W, true>(xs, K, F, m, sel, act, unit);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
moe_down_kernel(const float* act, int F, int D, int k_top, MoeWeights<T, W> m,
                const int* sel, const float* selw, const float* x2,
                float* out) {
  extern __shared__ __align__(16) float as[];
  stage_act<T, true>(act, (k_top + 1) * F, as);
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n < D)
    moe_down_unit<T, W, true>(as, F, D, k_top, m, sel, selw, x2, out, n);
}

// The closing LayerNorm of a layer: f32 in, T out (one block).
template <typename T>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(VecIn in, int K, T* __restrict__ out) {
  extern __shared__ __align__(16) float xs[];
  __shared__ float red[32];
  load_input<T>(in, K, xs, red);
  for (int k = threadIdx.x; k < K; k += blockDim.x) out[k] = from_f<T>(xs[k]);
}

static inline int blocks_for(int units) { return (units + kWarps - 1) / kWarps; }

#define V2M_CHECK_LAUNCH()                     \
  do {                                         \
    cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

template <typename T, typename W>
static int run_layer(const V2MDecodeLayer& a, cudaStream_t st) {
  const int D = a.D, F = a.F, hd = D / a.H;
  const float scale = 1.f / sqrtf((float)hd);
  const Work w(a.work, D);  // decode_layer.py:workspace_size
  const size_t vec_smem = (size_t)D * sizeof(float);
  const T* norm_g = (const T*)a.norm_scale;
  const T* norm_b = (const T*)a.norm_bias;
  const bool embed = a.token_root != nullptr;

  if (embed) {  // 1. x0 = round(lc_w . round(emb) + key * lc_krow + lc_b)
    GemvArgs g = {};
    g.in.root = a.token_root;
    g.in.attr = a.token_attr;
    g.in.emb_root = a.emb_root;
    g.in.emb_attr = a.emb_attr;
    g.w = a.lc_w;
    g.bias = a.lc_b;
    g.K = D;
    g.units = D;
    g.key = a.key;
    g.krow = a.lc_krow;
    g.out_f = w.x0;
    g.round_out = 1;
    gemv_kernel<T, T, kPlain><<<blocks_for(D), kThreads, vec_smem, st>>>(g);
    V2M_CHECK_LAUNCH();
  }
  {  // 2. qkv + RoPE + cache append at pos
    GemvArgs g = {};
    g.in.x = embed ? (const void*)w.x0 : a.x;
    g.in.x_is_t = embed ? 0 : 1;
    g.in.norm_out = embed ? nullptr : w.x0;
    g.w = a.wqkv;
    g.scale = a.wqkv_s;
    g.bias = a.bqkv;
    g.K = D;
    g.units = 3 * D / 2;
    g.cos = a.rope_cos;
    g.sin = a.rope_sin;
    g.pos = a.pos;
    g.hd = hd;
    g.rope_rows = a.rope_cos != nullptr ? 2 * D : 0;
    g.D = D;
    g.out_f = w.q;
    g.k_cache = a.k_cache;
    g.v_cache = a.v_cache;
    gemv_kernel<T, W, kRope><<<blocks_for(g.units), kThreads, vec_smem, st>>>(
        g);
    V2M_CHECK_LAUNCH();
  }
  const int self_rows = a.pos + 1;
  // 3. self-attention over rows <= pos
  cached_attention_kernel<T><<<a.H, kThreads,
                               attention_smem<T>(hd, self_rows), st>>>(
      w.q, (const T*)a.k_cache, (const T*)a.v_cache, w.attn, self_rows, D, hd,
      scale);
  V2M_CHECK_LAUNCH();
  {  // 4. r1 = x0 + (wo . attn + bo)
    GemvArgs g = {};
    g.in.x = w.attn;
    g.w = a.wo;
    g.scale = a.wo_s;
    g.bias = a.bo;
    g.K = D;
    g.units = D;
    g.residual = w.x0;
    g.out_f = w.r1;
    gemv_kernel<T, W, kPlain><<<blocks_for(D), kThreads, vec_smem, st>>>(g);
    V2M_CHECK_LAUNCH();
  }
  {  // 5. x1 = LN1(r1); cq = rope(cwq . x1 + cbq)
    GemvArgs g = {};
    g.in.x = w.r1;
    g.in.ln_g = norm_g;
    g.in.ln_b = norm_b;
    g.in.norm_out = w.x1;
    g.w = a.cwq;
    g.scale = a.cwq_s;
    g.bias = a.cbq;
    g.K = D;
    g.units = D / 2;
    g.cos = a.rope_cos;
    g.sin = a.rope_sin;
    g.pos = a.pos;
    g.hd = hd;
    g.rope_rows = a.rope_cos != nullptr ? D : 0;
    g.D = D;
    g.out_f = w.cq;
    gemv_kernel<T, W, kRope><<<blocks_for(g.units), kThreads, vec_smem, st>>>(
        g);
    V2M_CHECK_LAUNCH();
  }
  // 6. cross-attention over the primed memory
  cached_attention_kernel<T><<<a.H, kThreads,
                               attention_smem<T>(hd, a.Sm), st>>>(
      w.cq, (const T*)a.k_cross, (const T*)a.v_cross, w.cattn, a.Sm, D, hd,
      scale);
  V2M_CHECK_LAUNCH();
  {  // 7. r2 = x1 + (cwo . cattn + cbo)
    GemvArgs g = {};
    g.in.x = w.cattn;
    g.w = a.cwo;
    g.scale = a.cwo_s;
    g.bias = a.cbo;
    g.K = D;
    g.units = D;
    g.residual = w.x1;
    g.out_f = w.r2;
    gemv_kernel<T, W, kPlain><<<blocks_for(D), kThreads, vec_smem, st>>>(g);
    V2M_CHECK_LAUNCH();
  }
  // 8. feed-forward: x2 = LN2(r2); r3 = x2 + ffn(x2)
  VecIn ln2 = {};
  ln2.x = w.r2;
  ln2.ln_g = norm_g + D;
  ln2.ln_b = norm_b + D;
  ln2.norm_out = w.x2;
  if (a.gate_w == nullptr) {
    GemvArgs g = {};
    g.in = ln2;
    g.w = a.w1g;
    g.scale = a.w1g_s;
    g.bias = a.b1g;
    g.K = D;
    g.units = F;
    g.F = F;
    g.out_f = w.act;
    gemv_kernel<T, W, kSwiglu><<<blocks_for(F), kThreads, vec_smem, st>>>(g);
    V2M_CHECK_LAUNCH();
    GemvArgs g2 = {};
    g2.in.x = w.act;
    g2.w = a.w2;
    g2.scale = a.w2_s;
    g2.bias = a.b2;
    g2.K = F;
    g2.units = D;
    g2.residual = w.x2;
    g2.out_f = w.r3;
    gemv_kernel<T, W, kPlain><<<blocks_for(D), kThreads,
                                (size_t)F * sizeof(float), st>>>(g2);
    V2M_CHECK_LAUNCH();
  } else {
    if (a.k_top < 1 || a.k_top > kMaxTop || a.E > 32 || a.k_top > a.E)
      return (int)cudaErrorInvalidValue;
    router_kernel<T><<<1, kThreads, vec_smem, st>>>(
        ln2, D, (const T*)a.gate_w, (const T*)a.gate_b, a.E, a.k_top, a.sel,
        w.selw);
    V2M_CHECK_LAUNCH();
    VecIn in2 = {};
    in2.x = w.x2;
    const int slots = a.k_top + 1;
    const MoeWeights<T, W> m = {
        (const W*)a.w1g, (const T*)a.b1g, a.w1g_s,
        (const W*)a.w2, (const T*)a.b2, a.w2_s,
        (const W*)a.ew1g, (const T*)a.eb1g, a.ew1g_s,
        (const W*)a.ew2, (const T*)a.eb2, a.ew2_s};
    moe_up_kernel<T, W><<<blocks_for(slots * F), kThreads, vec_smem, st>>>(
        in2, D, F, slots, m, a.sel, w.act);
    V2M_CHECK_LAUNCH();
    moe_down_kernel<T, W><<<blocks_for(D), kThreads,
                            (size_t)slots * F * sizeof(float), st>>>(
        w.act, F, D, a.k_top, m, a.sel, w.selw, w.x2, w.r3);
    V2M_CHECK_LAUNCH();
  }
  {  // 9. y = round(LN3(r3))
    VecIn ln3 = {};
    ln3.x = w.r3;
    ln3.ln_g = norm_g + 2 * D;
    ln3.ln_b = norm_b + 2 * D;
    layernorm_kernel<T><<<1, kThreads, vec_smem, st>>>(ln3, D, (T*)a.y);
    V2M_CHECK_LAUNCH();
  }
  if (a.wout != nullptr) {  // 10. logits = round(wout . round(LN(y)) + bout)
    GemvArgs g = {};
    g.in.x = a.y;
    g.in.x_is_t = 1;
    g.in.ln_g = a.dn_scale;
    g.in.ln_b = a.dn_bias;
    g.w = a.wout;
    g.bias = a.bout;
    g.K = D;
    g.units = a.n_out;
    g.out_t = a.logits;
    gemv_kernel<T, T, kPlain><<<blocks_for(a.n_out), kThreads, vec_smem, st>>>(
        g);
    V2M_CHECK_LAUNCH();
  }
  return (int)cudaGetLastError();
}

}  // namespace v2m

// Launches one decoder layer's chain on `stream` (see the file comment).
// Returns a cudaError_t code; never synchronises.
extern "C" int v2m_decode_layer(int dtype, const v2m::V2MDecodeLayer* args,
                                void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  const bool int8 = args->wqkv_s != nullptr;  // int8 weights
  if (dtype == kF32)
    return int8 ? run_layer<float, int8_t>(*args, st)
                : run_layer<float, float>(*args, st);
  if (dtype == kBF16)
    return int8 ? run_layer<bf16, int8_t>(*args, st)
                : run_layer<bf16, bf16>(*args, st);
  return (int)cudaErrorInvalidValue;
}
