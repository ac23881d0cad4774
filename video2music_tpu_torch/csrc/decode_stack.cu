// A run of B=1 AMT 2.2 decoder layers (post-norm V2 wiring) at one position
// as ONE cooperative kernel, optionally with the chord-embedding prologue
// before the first layer and the final LayerNorm + chord head after the
// last.
//
// Replaces three TPU kernels, which compute the same function and differ
// only in how the TPU addresses the weights:
//   * video2music_tpu/ops/pallas_decode_stack.py:decode_monolith_step
//     (_monolith_kernel): the whole step, weights stacked over all layers;
//   * video2music_tpu/ops/pallas_decode_stack.py:decode_segment_step
//     (_shallow_stack_kernel, _deep_stack_kernel): one run of same-kind
//     layers over a grid of layers, x (1, D) in and y (1, D) out;
//   * video2music_tpu/ops/pallas_decode_stack.py:decode_flat_monolith_step
//     (_flat_monolith_kernel) over more than one layer, per-layer operands.
// Here every layer is one entry of a pointer table passed by value in the
// kernel's argument struct (its caches included), so the three share this
// kernel. The TPU kernels' one-hot gathers, masked full-buffer cache select
// and expert DMAs are not carried over: the ids index device memory and the
// K/V row is written at pos.
//
// What bounds it on the H100: every weight of the run read once (57 MB in
// bf16 for the six 2.2 layers: 17 us at 3.35 TB/s, computed, not measured)
// plus the cache rows <= pos. A single block cannot stream that, so the
// kernel is persistent and cooperative: as many blocks as the card holds at
// once (SM count x occupancy), launched with cudaLaunchCooperativeKernel,
// walking the phases of decode_layer.cu's chain with grid barriers between
// them:
//   0. [embed] Linear_chord GEMV over the gathered embedding rows;
//   per layer:
//   1. QKV GEMV + RoPE, K/V written at pos; the input is the previous
//      layer's closing LayerNorm, recomputed in every block's prologue and
//      rounded to the compute dtype (the per-layer kernels' rounding point);
//   2. self-attention, one block per head, over rows <= pos;
//   3. out-projection GEMV + residual;
//   4. LN1 in each block's prologue, cross-q GEMV + RoPE;
//   5. cross-attention over the Sm memory rows, one block per head;
//   6. cross out-projection GEMV + residual;
//   7. LN2 in the prologue, then SwiGLU's [w1|wg] GEMV, or (MoE) the router
//      in every working block (first index wins a tie, softmax over the
//      selected raw logits) and the up-GEMVs of the shared and selected
//      experts;
//   8. the down GEMV (the MoE combine) + residual;
//   end: [head] LN3, the final LayerNorm and the Wout GEMV, or y = LN3.
// That is 8 grid barriers a layer (+1 after the embed). No block returns
// early: every block reaches every barrier.
#include <cooperative_groups.h>

#include "decode_step.cuh"

namespace cg = cooperative_groups;

namespace v2m {

constexpr int kMaxLayers = 16;  // keeps the argument struct under 4 KB

// One layer of the run. Field order must match StackLayerArgs in kernels.py.
struct V2MStackLayer {
  const void *wqkv, *bqkv, *wo, *bo, *cwq, *cbq, *cwo, *cbo;
  const void *norm_scale, *norm_bias;
  const void *w1g, *b1g, *w2, *b2;
  const void *gate_w, *gate_b, *ew1g, *eb1g, *ew2, *eb2;  // null: SwiGLU
  void *k_cache, *v_cache;          // (S, D), written at row pos
  const void *k_cross, *v_cross;    // (Sm, D)
};

// Field order must match StackArgs in kernels.py.
struct V2MStack {
  const void *x;   // (1, D) input when there is no embed prologue
  void *y;         // (1, D) output when there is no head
  const float *rope_cos, *rope_sin;
  float *work;     // decode_layer.py:workspace_size floats
  int *sel;        // k_top expert ids
  const int *token_root, *token_attr;
  const float *key;
  const void *emb_root, *emb_attr, *lc_w, *lc_krow, *lc_b;  // null: no embed
  const void *dn_scale, *dn_bias, *wout, *bout;             // null: no head
  void *logits;
  int D, H, F, E, k_top, S, Sm, n_out, pos, n_layers, grid, smem;
  V2MStackLayer layers[kMaxLayers];
};

// Stage the input of a GEMV phase and run its units, in the blocks that
// have any.
template <typename T, int EPI>
__device__ void gemv_phase(const GemvArgs& g, float* xs, float* red) {
  if (blockIdx.x * kWarps >= g.units) return;
  load_input<T>(g.in, g.K, xs, red);
  gemv_units<T, T, EPI>(g, xs, blockIdx.x * kWarps + (threadIdx.x >> 5),
                        gridDim.x * kWarps);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_stack_kernel(
    const V2MStack a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  const int D = a.D, F = a.F, hd = D / a.H;
  const float scale = 1.f / sqrtf((float)hd);
  const int warp0 = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int wstride = gridDim.x * kWarps;
  const Work w(a.work, D, a.k_top);
  const bool embed = a.token_root != nullptr;

  if (embed) {  // 0. x0 = round(lc_w . round(emb) + key * lc_krow + lc_b)
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
    gemv_phase<T, kPlain>(g, sm, red);
    grid.sync();
  }
  for (int i = 0; i < a.n_layers; ++i) {
    const V2MStackLayer& l = a.layers[i];
    const T* norm_g = (const T*)l.norm_scale;
    const T* norm_b = (const T*)l.norm_bias;
    {  // 1. qkv + RoPE + cache append at pos
      GemvArgs g = {};
      if (i > 0) {  // x0 = round(LN3 of the previous layer)
        g.in.x = w.r3;
        g.in.ln_g = (const T*)a.layers[i - 1].norm_scale + 2 * D;
        g.in.ln_b = (const T*)a.layers[i - 1].norm_bias + 2 * D;
        g.in.round_first = 1;
        g.in.norm_out = w.x0;
      } else if (embed) {
        g.in.x = w.x0;
      } else {
        g.in.x = a.x;
        g.in.x_is_t = 1;
        g.in.norm_out = w.x0;
      }
      g.w = l.wqkv;
      g.bias = l.bqkv;
      g.K = D;
      g.units = 3 * D / 2;
      g.cos = a.rope_cos;
      g.sin = a.rope_sin;
      g.pos = a.pos;
      g.hd = hd;
      g.rope_rows = a.rope_cos != nullptr ? 2 * D : 0;
      g.D = D;
      g.out_f = w.q;
      g.k_cache = l.k_cache;
      g.v_cache = l.v_cache;
      gemv_phase<T, kRope>(g, sm, red);
    }
    grid.sync();
    // 2. self-attention over rows <= pos (this kernel wrote row pos)
    if (blockIdx.x < a.H)
      attention_head<T, false>(w.q, (const T*)l.k_cache, (const T*)l.v_cache,
                               w.attn, a.pos + 1, D, hd, scale, blockIdx.x,
                               sm, red);
    grid.sync();
    {  // 3. r1 = x0 + (wo . attn + bo)
      GemvArgs g = {};
      g.in.x = w.attn;
      g.w = l.wo;
      g.bias = l.bo;
      g.K = D;
      g.units = D;
      g.residual = w.x0;
      g.out_f = w.r1;
      gemv_phase<T, kPlain>(g, sm, red);
    }
    grid.sync();
    {  // 4. x1 = LN1(r1); cq = rope(cwq . x1 + cbq)
      GemvArgs g = {};
      g.in.x = w.r1;
      g.in.ln_g = norm_g;
      g.in.ln_b = norm_b;
      g.in.norm_out = w.x1;
      g.w = l.cwq;
      g.bias = l.cbq;
      g.K = D;
      g.units = D / 2;
      g.cos = a.rope_cos;
      g.sin = a.rope_sin;
      g.pos = a.pos;
      g.hd = hd;
      g.rope_rows = a.rope_cos != nullptr ? D : 0;
      g.D = D;
      g.out_f = w.cq;
      gemv_phase<T, kRope>(g, sm, red);
    }
    grid.sync();
    // 5. cross-attention over the primed memory (read-only here)
    if (blockIdx.x < a.H)
      attention_head<T, true>(w.cq, (const T*)l.k_cross, (const T*)l.v_cross,
                              w.cattn, a.Sm, D, hd, scale, blockIdx.x, sm,
                              red);
    grid.sync();
    {  // 6. r2 = x1 + (cwo . cattn + cbo)
      GemvArgs g = {};
      g.in.x = w.cattn;
      g.w = l.cwo;
      g.bias = l.cbo;
      g.K = D;
      g.units = D;
      g.residual = w.x1;
      g.out_f = w.r2;
      gemv_phase<T, kPlain>(g, sm, red);
    }
    grid.sync();
    // 7. x2 = LN2(r2), then the FFN's up GEMV
    VecIn ln2 = {};
    ln2.x = w.r2;
    ln2.ln_g = norm_g + D;
    ln2.ln_b = norm_b + D;
    ln2.norm_out = w.x2;
    const bool deep = l.gate_w != nullptr;
    if (!deep) {
      GemvArgs g = {};
      g.in = ln2;
      g.w = l.w1g;
      g.bias = l.b1g;
      g.K = D;
      g.units = F;
      g.F = F;
      g.out_f = w.act;
      gemv_phase<T, kSwiglu>(g, sm, red);
    } else if (blockIdx.x * kWarps < (a.k_top + 1) * F) {
      // the router's scratch after the staged input: E logits, then the
      // k_top expert ids and weights
      float* logit = sm + D;
      int* sel_s = reinterpret_cast<int*>(logit + a.E);
      float* selw_s = reinterpret_cast<float*>(sel_s + a.k_top);
      load_input<T>(ln2, D, sm, red);
      route<T>(sm, D, (const T*)l.gate_w, (const T*)l.gate_b, a.E, a.k_top,
               logit, sel_s, selw_s);
      __syncthreads();
      if (blockIdx.x == 0) {
        for (int j = threadIdx.x; j < a.k_top; j += blockDim.x) {
          a.sel[j] = sel_s[j];
          w.selw[j] = selw_s[j];
        }
      }
      const MoeWeights<T, T> m = {
          (const T*)l.w1g, (const T*)l.b1g, nullptr,
          (const T*)l.w2, (const T*)l.b2, nullptr,
          (const T*)l.ew1g, (const T*)l.eb1g, nullptr,
          (const T*)l.ew2, (const T*)l.eb2, nullptr};
      moe_up_units<T, T>(sm, D, F, a.k_top + 1, m, sel_s, w.act, warp0,
                         wstride);
    }
    grid.sync();
    // 8. r3 = x2 + ffn down GEMV
    if (!deep) {
      GemvArgs g = {};
      g.in.x = w.act;
      g.w = l.w2;
      g.bias = l.b2;
      g.K = F;
      g.units = D;
      g.residual = w.x2;
      g.out_f = w.r3;
      gemv_phase<T, kPlain>(g, sm, red);
    } else if (blockIdx.x * kWarps < D) {
      const MoeWeights<T, T> m = {
          (const T*)l.w1g, (const T*)l.b1g, nullptr,
          (const T*)l.w2, (const T*)l.b2, nullptr,
          (const T*)l.ew1g, (const T*)l.eb1g, nullptr,
          (const T*)l.ew2, (const T*)l.eb2, nullptr};
      stage_act<T>(w.act, (a.k_top + 1) * F, sm);
      moe_down_units<T, T>(sm, F, D, a.k_top, m, a.sel, w.selw, w.x2, w.r3,
                           warp0, wstride);
    }
    grid.sync();
  }
  const V2MStackLayer& last = a.layers[a.n_layers - 1];
  VecIn ln3 = {};  // round(LN3(r3)) of the last layer
  ln3.x = w.r3;
  ln3.ln_g = (const T*)last.norm_scale + 2 * D;
  ln3.ln_b = (const T*)last.norm_bias + 2 * D;
  if (a.wout != nullptr) {  // logits = round(wout . round(LN(y)) + bout)
    GemvArgs g = {};
    g.in = ln3;
    g.in.ln2_g = a.dn_scale;
    g.in.ln2_b = a.dn_bias;
    g.w = a.wout;
    g.bias = a.bout;
    g.K = D;
    g.units = a.n_out;
    g.out_t = a.logits;
    gemv_phase<T, kPlain>(g, sm, red);
  } else if (blockIdx.x == 0) {
    load_input<T>(ln3, D, sm, red);
    for (int k = threadIdx.x; k < D; k += blockDim.x)
      ((T*)a.y)[k] = from_f<T>(sm[k]);
  }
}

template <typename T>
static int stack_blocks(int smem, int* blocks) {
  const void* fn = (const void*)decode_stack_kernel<T>;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = sms * per_sm;
  return *blocks > 0 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

template <typename T>
static int launch_stack(const V2MStack& a, cudaStream_t st) {
  void* args[] = {(void*)&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)decode_stack_kernel<T>, dim3(a.grid), dim3(kThreads), args,
      (size_t)a.smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace v2m

// Shared memory (bytes) and the number of blocks the card holds at once
// for a run of this shape: the wrapper calls it once per run and keeps both
// in the argument struct.
extern "C" int v2m_decode_stack_grid(int dtype, int D, int H, int F,
                                     int E, int k_top, int rows, int* smem,
                                     int* blocks) {
  using namespace v2m;
  const int hd = D / H;
  const int vec = dtype == kF32 ? Vec<float>::N : Vec<bf16>::N;
  int floats = D;
  if (F > floats) floats = F;
  if ((k_top + 1) * F > floats) floats = (k_top + 1) * F;
  if (D + E + 2 * k_top > floats) floats = D + E + 2 * k_top;  // router
  const int attn = hd + kThreads * vec + rows;
  if (attn > floats) floats = attn;
  *smem = floats * (int)sizeof(float);
  if (dtype == kF32) return stack_blocks<float>(*smem, blocks);
  if (dtype == kBF16) return stack_blocks<bf16>(*smem, blocks);
  return (int)cudaErrorInvalidValue;
}

// Launches the run on `stream` (see the file comment). Returns a cudaError_t
// code (a refused cooperative launch included); never synchronises.
extern "C" int v2m_decode_stack(int dtype, const v2m::V2MStack* args,
                                void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  if (args->n_layers < 1 || args->n_layers > kMaxLayers ||
      args->k_top < 1 || (args->E > 0 && args->k_top > args->E))
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return launch_stack<float>(*args, st);
  if (dtype == kBF16) return launch_stack<bf16>(*args, st);
  return (int)cudaErrorInvalidValue;
}
