// One decoder-layer step of the variant wirings (every decoder the V2
// kernels do not cover: base AMT, V1, V3), at B=1 and for a batch of clips
// at one shared position.
//
// Replaces three TPU kernels:
//   * video2music_tpu/ops/pallas_decode_variant.py:decode_variant_layer_step
//     (one whole B=1 layer: v2m_variant_layer);
//   * video2music_tpu/ops/pallas_decode_batch_variant.py:
//     batched_variant_layer_step (the attention half of a B>1 layer, plus
//     the FFN of a shallow one: v2m_variant_batched_layer);
//   * video2music_tpu/ops/pallas_decode_batch_variant.py:
//     batched_variant_moe_ffn (the MoE half: v2m_variant_batched_moe).
// Every wiring of the Pallas kernels: vanilla, RPR (Shaw/Huang relative
// bias on the unscaled q.k) or differential attention (2H query/key heads
// against H value heads, p_even - lambda * p_odd, a per-head RMSNorm with
// eps 1e-5 and the packed subln row), optional pairwise RoPE; ReLU, SwiGLU
// or top-k MoE feed-forwards with GLU or SiLU-MLP experts, with or without
// the shared expert; LayerNorm (eps 1e-5) or RMSNorm (eps 1e-6); post- or
// pre-norm residuals; and, at B=1, int8 weights (the Pallas kernel's
// QUANT_KEYS with their <key>_s scales, :165-174 and :305-320): every GEMV
// of the layer runs its int8 instance (W = int8_t in batch_decode.cuh),
// which reads 16 weights a load and multiplies each row's f32 sum by its
// scale before the bias; a routed expert's scale rows are read by its id,
// like its weights. The GEMVs are latency-bound at B=1, so halving their
// weight bytes is expected to buy little time. The Pallas kernels' one-hot
// head, pair and shift matmuls, sublane-stacked slabs and diagonal probe
// answer Mosaic limits and are not carried over: each attention block reads
// its own head of its own clip, its pair of query heads and its RPR rows by
// address.
//
// Rounding follows each Pallas kernel. B=1: matmul inputs rounded to the
// compute dtype T, q, the probabilities and the attention output in f32,
// the residual stream in f32 up to the layer output. Batched: as B=1, and
// q, the cache rows' probabilities and RPR biases, the value products, the
// differential combine and the attention output rounded to T (the current
// row's probability and bias stay f32); a deep layer's x2 leaves as T. The
// B=1 MoE adds the routed experts in selection order, the batched one in
// expert order, as their Pallas kernels do. Unlike the Pallas kernels,
// this step's K/V rows are written IN PLACE into the self caches at
// (b, pos), at B=1 and B>1.
//
// What bounds it on the H100: bytes. A deep V3 layer at B=1, pos 150, bf16
// reads ~6.5 MB of attention weights and ~4.2 MB of routed and shared
// experts, the self caches (2D-wide K: 0.5 MB) and the cross K/V (0.9 MB):
// ~12 MB, ~3.6 us at 3.35 TB/s (computed from the shapes, not measured).
// At B=16 the cross and self caches of the clips (~25 MB) set the pace. At
// B=1 each launch of the chain moves 0.3-2.6 MB, well under a microsecond of
// bytes, so the launches' fixed latency sets the time. The design is that
// of csrc/decode_batch.cu (csrc/batch_decode.cuh): the GEMVs read each
// weight row once per step, the bf16 ones at B >= 2 on the tensor cores,
// with the norms folded into their input staging; attention splits each
// (value head, clip) over a cluster of blocks (4-8 at B=1, so 32-64 blocks
// work where one per head did) that holds both query heads of a
// differential pair, so the shared value head is read once for both, and
// whose first block finishes the pair combine and subln (a vanilla or RPR
// head at B >= 2: one block per (value head, clip); a head size the
// narrow instances do not take: attn_any_kernel's clusters); every
// launch uses programmatic dependent launch, so a GEMV's weight fetch
// overlaps the previous kernel. A deep layer at B=1 is 13 launches.
#include "batch_decode.cuh"

namespace v2m {
namespace variant {

using namespace batch;

enum AttnKind : int { kVanilla = 0, kRpr = 1, kDiff = 2 };
enum FfnKind : int { kReluFfn = 0, kSwigluFfn = 1, kMoeFfn = 2 };

// Field order must match VariantArgs in kernels.py. Weights (out, in)
// row-major in T, or int8 with the f32 row scales <key>_s (null in a T
// pack); lam / subw / er in f32.
struct V2MVariant {
  const void *x; void *y;
  const void *wqkv, *bqkv, *wo, *bo;
  const float *lam, *subw, *er;
  const void *cwq, *cbq, *cwo, *cbo;
  const float *clam, *csubw;
  const void *norm_scale, *norm_bias;
  const void *fw1g, *fb1g, *fw2, *fb2;
  const void *gate_w, *gate_b, *sw1g, *sb1g, *sw2, *sb2;
  const void *ew1g, *eb1g, *ew2, *eb2;
  const float *rope_cos, *rope_sin;
  void *k_cache, *v_cache;
  const void *k_cross, *v_cross;
  float *work;
  int *sel;
  const float *wqkv_s, *wo_s, *cwq_s, *cwo_s, *fw1g_s, *fw2_s, *sw1g_s,
      *sw2_s, *ew1g_s, *ew2_s;
  int B, D, H, S, Sm, pos, er_len;
  int attn, cross, ffn, expert, F, Fe, E, k_top, rms, pre_norm;
  int dense;  // the MoE's experts dense (decode_batch.py dense_experts)
};

// f32 workspace of the attention half, in rows of B x D (the FFN
// activations (B, F) follow): x0, q (2), attn, r1, x1, cq (2), cattn, r2,
// x2, r3 — as decode_variant.py:layer_workspace_size.
constexpr int kLayerRows = 12;

// ---------------------------------------------------------------------------
// the launch chains
// ---------------------------------------------------------------------------

static inline int norm_kind(const V2MVariant& a) {
  return a.rms ? kRmsNorm : kLayerNorm;
}

// The MoE half: xn = round(norm3(x2)) (pre-norm; post-norm: x2, which the
// router and the GEMV's staging round); router; the shared expert (slot 0,
// when present) and every expert's first layer (GLU pair or SiLU MLP) and
// second layer, for the clips its router listed or (a.dense) for
// every clip; y = x2 + combine (pre-norm) or norm3(x2 + combine).
template <typename T, typename W>
static int run_moe(const V2MVariant& a, const void* x2, int x2_is_t,
                   int sel_order, float* work, cudaStream_t st) {
  const int B = a.B, D = a.D, E = a.E, Fe = a.Fe;
  if (a.k_top < 1 || a.k_top > E) return (int)cudaErrorInvalidValue;
  const size_t BD = (size_t)B * D;
  // f32 workspace, as in decode_variant.py:moe_workspace_size
  float* xn = work;                                  // (B, D)
  float* selw = xn + BD;                             // (B, k_top)
  float* act = selw + selw_floats(B * a.k_top);      // (E + 1, B, Fe)
  float* ye = act + (size_t)(E + 1) * B * Fe;        // (E + 1, B, D)
  // int workspace, as in decode_variant.py:moe_route_size
  int* counts = a.sel + (size_t)B * a.k_top;         // (E) clips per expert
  int* lists = counts + E;                           // (E, B) their ids
  const bool dense = a.dense != 0;
  if (dense) counts = lists = nullptr;
  const T* ns = (const T*)a.norm_scale;
  const T* nb = (const T*)a.norm_bias;
  const bool shared = a.sw1g != nullptr;
  const void* rows = x2;  // the router's and the first layer's input
  int rows_t = x2_is_t;
  int err;
  if (a.pre_norm) {
    Close c = {};
    c.x = x2;
    c.x_is_t = x2_is_t;
    c.norm = norm_kind(a);
    c.g = ns + 2 * D;
    c.bn = nb + 2 * D;
    c.out_f = xn;
    c.round_f = 1;
    c.B = B;
    c.K = D;
    if ((err = close_rows<T>(c, st))) return err;
    rows = xn;
    rows_t = 0;
  }
  if (!dense &&
      (err = (int)cudaMemsetAsync(counts, 0, E * sizeof(int), st)))
    return err;
  err = rows_t ? route<T, T>((const T*)rows, (const T*)a.gate_w,
                             (const T*)a.gate_b, B, D, E, a.k_top, a.sel,
                             selw, counts, lists, st)
               : route<T, float>((const float*)rows, (const T*)a.gate_w,
                                 (const T*)a.gate_b, B, D, E, a.k_top, a.sel,
                                 selw, counts, lists, st);
  if (err) return err;
  {  // first layer of the shared expert (slot 0) and of each routed expert
    BGemv g = {};
    g.in.x = rows;
    g.in.x_is_t = rows_t;
    g.w = a.sw1g;
    g.ws = a.sw1g_s;  // int8 weights: the row scales
    g.ews = a.ew1g_s;
    g.bias = a.sb1g;
    g.ew = a.ew1g;
    g.eb = a.eb1g;
    g.counts = counts;
    g.lists = lists;
    g.B = B;
    g.K = D;
    g.units = Fe;
    g.out_f = act;
    if (a.expert == 0) {  // GLU: rows j and Fe + j -> h * silu(g)
      g.n_rows = 2 * Fe;
      g.F = Fe;
      if ((err = gemv<T, kSwiglu, W>(g, E + 1, st))) return err;
    } else {              // MLP: silu(w1 . x + b1)
      g.n_rows = Fe;
      g.act = kSilu;
      if ((err = gemv<T, kPlain, W>(g, E + 1, st))) return err;
    }
  }
  {  // second layer of each slot over its own activations
    BGemv g = {};
    g.in.x = act;
    g.in.slot_stride = (size_t)B * Fe;
    g.w = a.sw2;
    g.ws = a.sw2_s;
    g.ews = a.ew2_s;
    g.bias = a.sb2;
    g.ew = a.ew2;
    g.eb = a.eb2;
    g.counts = counts;
    g.lists = lists;
    g.B = B;
    g.K = Fe;
    g.n_rows = D;
    g.units = D;
    g.out_f = ye;
    if ((err = gemv<T, kPlain, W>(g, E + 1, st))) return err;
  }
  Close c = {};
  c.x = x2;
  c.x_is_t = x2_is_t;
  c.ye = ye;
  c.shared = shared;
  c.sel_order = sel_order;
  c.sel = a.sel;
  c.selw = selw;
  c.k_top = a.k_top;
  c.norm = a.pre_norm ? kNoNorm : norm_kind(a);
  c.g = ns + 2 * D;
  c.bn = nb + 2 * D;
  c.out_t = a.y;
  c.B = B;
  c.K = D;
  return close_rows<T>(c, st);
}

// One layer. batched = false: the whole B=1 layer (a deep layer finishes
// with run_moe, its x2 in f32). batched = true: the attention half, plus
// the FFN of a shallow layer; a deep layer returns x2 as T.
template <typename T, typename W>
static int run_layer(const V2MVariant& a, bool batched, cudaStream_t st) {
  const int B = a.B, D = a.D, H = a.H, hd = D / a.H, F = a.F;
  const bool pre = a.pre_norm != 0;
  const bool rope = a.rope_cos != nullptr;
  const int nq = a.attn == kDiff ? 2 : 1;   // self query/key width / D
  const int nc = a.cross == kDiff ? 2 : 1;  // cross query/key width / D
  const size_t BD = (size_t)B * D;
  float* x0 = a.work;          // layer input (f32 copy, post-norm)
  float* q = x0 + BD;          // self query (nq D)
  float* attn = q + 2 * BD;
  float* r1 = attn + BD;       // residual + self block
  float* x1 = r1 + BD;         // norm1(r1) (post-norm)
  float* cq = x1 + BD;         // cross query (nc D)
  float* cattn = cq + 2 * BD;
  float* r2 = cattn + BD;      // residual + cross block
  float* x2 = r2 + BD;         // norm2(r2) (post-norm)
  float* r3 = x2 + BD;         // x2 + FFN (post-norm)
  float* act = r3 + BD;        // (B, F) FFN activations
  const T* ns = (const T*)a.norm_scale;
  const T* nb = (const T*)a.norm_bias;
  // fold norm row i into a GEMV's input staging (f32 result into out)
  auto fold = [&](RowsIn& in, int i, float* out) {
    in.ln_g = ns + (size_t)i * D;
    in.ln_b = nb + (size_t)i * D;
    in.rms = a.rms;
    in.norm_out = out;
  };
  int err;
  {  // q | k | v (+ RoPE at pos); K/V rows into the caches at (b, pos)
    BGemv g = {};
    g.in.x = a.x;
    g.in.x_is_t = 1;
    if (pre) {
      fold(g.in, 0, nullptr);
    } else {
      g.in.norm_out = x0;
    }
    g.w = a.wqkv;
    g.ws = a.wqkv_s;
    g.bias = a.bqkv;
    g.B = B;
    g.K = D;
    g.units = (2 * nq + 1) * D / 2;
    g.cos = a.rope_cos;
    g.sin = a.rope_sin;
    g.pos = a.pos;
    g.hd = hd;
    g.rope_rows = rope ? 2 * nq * D : 0;
    g.q_rows = nq * D;
    g.k_rows = nq * D;
    g.q_f32 = !batched;
    g.D = D;
    g.S = a.S;
    g.out_f = q;
    g.k_cache = a.k_cache;
    g.v_cache = a.v_cache;
    if ((err = gemv<T, kRope, W>(g, 1, st))) return err;
  }
  {  // self-attention over rows <= pos, row pos kept f32
    Attn t = {};
    t.q = q;
    t.k = a.k_cache;
    t.v = a.v_cache;
    t.out = attn;
    t.lam = a.lam;
    t.subw = a.subw;
    t.er = a.attn == kRpr ? a.er : nullptr;
    t.rows = a.pos + 1;
    t.stride_rows = a.S;
    t.D = D;
    t.hd = hd;
    t.diff = a.attn == kDiff;
    t.er_len = a.er_len;
    t.pos = a.pos;
    t.cur = a.pos;
    t.batched = batched;
    t.scale = 1.f / sqrtf((float)hd);
    if ((err = attention<T>(t, B, H, st))) return err;
  }
  {  // r1 = residual + (wo . attn + bo); the residual is x0 or, pre-norm, x
    BGemv g = {};
    g.in.x = attn;
    g.w = a.wo;
    g.ws = a.wo_s;
    g.bias = a.bo;
    g.B = B;
    g.K = D;
    g.units = D;
    if (pre) {
      g.residual_t = a.x;
    } else {
      g.residual = x0;
    }
    g.out_f = r1;
    if ((err = gemv<T, kPlain, W>(g, 1, st))) return err;
  }
  {  // cross query of norm1(r1) (post: kept as x1) or norm2(r1) (pre)
    BGemv g = {};
    g.in.x = r1;
    fold(g.in, pre ? 1 : 0, pre ? nullptr : x1);
    g.w = a.cwq;
    g.ws = a.cwq_s;
    g.bias = a.cbq;
    g.B = B;
    g.K = D;
    g.units = nc * D / 2;
    g.cos = a.rope_cos;
    g.sin = a.rope_sin;
    g.pos = a.pos;
    g.hd = hd;
    g.rope_rows = rope ? nc * D : 0;
    g.q_rows = nc * D;
    g.q_f32 = !batched;
    g.D = D;
    g.S = a.S;
    g.out_f = cq;
    if ((err = gemv<T, kRope, W>(g, 1, st))) return err;
  }
  {  // cross-attention over each clip's Sm primed rows
    Attn t = {};
    t.q = cq;
    t.k = a.k_cross;
    t.v = a.v_cross;
    t.out = cattn;
    t.lam = a.clam;
    t.subw = a.csubw;
    t.rows = a.Sm;
    t.stride_rows = a.Sm;
    t.D = D;
    t.hd = hd;
    t.diff = a.cross == kDiff;
    t.pos = a.pos;
    t.cur = -1;
    t.batched = batched;
    t.scale = 1.f / sqrtf((float)hd);
    if ((err = attention<T>(t, B, H, st))) return err;
  }
  const bool deep = a.ffn == kMoeFfn;
  {  // r2 = residual + (cwo . cattn + cbo)
    BGemv g = {};
    g.in.x = cattn;
    g.w = a.cwo;
    g.ws = a.cwo_s;
    g.bias = a.cbo;
    g.B = B;
    g.K = D;
    g.units = D;
    g.residual = pre ? r1 : x1;
    if (pre && deep && batched) {
      g.out_t = a.y;  // the batched deep layer's x2, finished by the MoE
    } else {
      g.out_f = r2;
    }
    if ((err = gemv<T, kPlain, W>(g, 1, st))) return err;
  }
  Close c = {};
  c.B = B;
  c.K = D;
  c.norm = norm_kind(a);
  if (deep) {
    if (pre && batched) return 0;
    if (batched) {  // x2 = norm2(r2) as T
      c.x = r2;
      c.g = ns + D;
      c.bn = nb + D;
      c.out_t = a.y;
      return close_rows<T>(c, st);
    }
    const float* x2f = r2;  // B=1: the MoE half on x2 in f32
    if (!pre) {
      c.x = r2;
      c.g = ns + D;
      c.bn = nb + D;
      c.out_f = x2;
      if ((err = close_rows<T>(c, st))) return err;
      x2f = x2;
    }
    return run_moe<T, W>(a, x2f, 0, 1,
                      a.work + kLayerRows * BD + (size_t)B * F, st);
  }
  {  // FFN first layer on norm2(r2) (post: kept as x2) or norm3(r2) (pre)
    BGemv g = {};
    g.in.x = r2;
    fold(g.in, pre ? 2 : 1, pre ? nullptr : x2);
    g.w = a.fw1g;
    g.ws = a.fw1g_s;
    g.bias = a.fb1g;
    g.B = B;
    g.K = D;
    g.units = F;
    g.out_f = act;
    if (a.ffn == kSwigluFfn) {
      g.F = F;
      if ((err = gemv<T, kSwiglu, W>(g, 1, st))) return err;
    } else {
      g.act = kRelu;
      if ((err = gemv<T, kPlain, W>(g, 1, st))) return err;
    }
  }
  {  // + w2 . act + b2 over the residual x2 (post) or r2 (pre)
    BGemv g = {};
    g.in.x = act;
    g.w = a.fw2;
    g.ws = a.fw2_s;
    g.bias = a.fb2;
    g.B = B;
    g.K = F;
    g.units = D;
    g.residual = pre ? r2 : x2;
    if (pre) {
      g.out_t = a.y;
    } else {
      g.out_f = r3;
    }
    if ((err = gemv<T, kPlain, W>(g, 1, st))) return err;
  }
  if (pre) return 0;
  c.x = r3;  // y = norm3(r3)
  c.g = ns + 2 * D;
  c.bn = nb + 2 * D;
  c.out_t = a.y;
  return close_rows<T>(c, st);
}

// The widths the kernels hold; `heads`: the attention's head split too
// (an even head size: RoPE pairs, the attention's value-pair loads).
// int8 rows load 16 weights at a time.
static bool widths_ok(const V2MVariant& a, bool heads) {
  constexpr int N8 = Vec<int8_t>::N;
  if (a.wqkv_s != nullptr && (a.D % N8 || a.F % N8 || a.Fe % N8))
    return false;
  return !heads || (a.H > 0 && a.D % a.H == 0 && (a.D / a.H) % 2 == 0);
}

}  // namespace variant
}  // namespace v2m

// Launch one B=1 layer (attention, FFN or MoE, norms) on `stream`, with int8
// weights when the pack carries their row scales. Returns a cudaError_t
// code; never synchronises.
extern "C" int v2m_variant_layer(int dtype, const v2m::variant::V2MVariant* a,
                                 void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  if (!variant::widths_ok(*a, true)) return (int)cudaErrorInvalidValue;
  const bool q8 = a->wqkv_s != nullptr;
  if (dtype == kF32)
    return q8 ? variant::run_layer<float, int8_t>(*a, false, st)
              : variant::run_layer<float, float>(*a, false, st);
  if (dtype == kBF16)
    return q8 ? variant::run_layer<bf16, int8_t>(*a, false, st)
              : variant::run_layer<bf16, bf16>(*a, false, st);
  return (int)cudaErrorInvalidValue;
}

// Launch one batched layer's attention half (+ the FFN of a shallow layer)
// on `stream`. Returns a cudaError_t code; never synchronises.
extern "C" int v2m_variant_batched_layer(int dtype,
                                         const v2m::variant::V2MVariant* a,
                                         void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  if (!variant::widths_ok(*a, true) || a->wqkv_s != nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return variant::run_layer<float, float>(*a, true, st);
  if (dtype == kBF16) return variant::run_layer<bf16, bf16>(*a, true, st);
  return (int)cudaErrorInvalidValue;
}

// Launch one batched MoE half (x2 = a->x as T, out a->y) on `stream`.
// Returns a cudaError_t code; never synchronises.
extern "C" int v2m_variant_batched_moe(int dtype,
                                       const v2m::variant::V2MVariant* a,
                                       void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  if (!variant::widths_ok(*a, false) || a->wqkv_s != nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return variant::run_moe<float, float>(*a, a->x, 1, 0, a->work, st);
  if (dtype == kBF16)
    return variant::run_moe<bf16, bf16>(*a, a->x, 1, 0, a->work, st);
  return (int)cudaErrorInvalidValue;
}
