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
#include "common.cuh"

namespace v2m {

constexpr int kWarps = 8;  // GEMV rows (or row pairs) per block
constexpr int kThreads = kWarps * 32;
constexpr float kLnEps = 1e-5f;
constexpr int kMaxTop = 8;

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
  int D, H, F, E, k_top, Sm, n_out, pos;
};

// The input vector a GEMV block stages in shared memory.
struct VecIn {
  const void* x;      // T when x_is_t, else float; null = embedding gather
  int x_is_t;
  const void* ln_g;   // LayerNorm scale/bias (T) to apply, or null
  const void* ln_b;
  float* norm_out;    // block 0 stores the f32 (normalized) input, or null
  const int* root;    // embedding gather: emb_root[*root] + emb_attr[*attr]
  const int* attr;
  const void* emb_root;
  const void* emb_attr;
};

// Stage the input in xs (K floats): load or gather, optional LayerNorm in
// f32 (two-pass mean / variance), optional f32 copy out, then round to T
// as the matmul input. Each thread owns the same k in every loop.
template <typename T>
__device__ void load_input(const VecIn& in, int K, float* xs, float* red) {
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
    float s = 0.f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) s += xs[k];
    const float mean = block_sum(s, red) / K;
    float q = 0.f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float d = xs[k] - mean;
      q += d * d;
    }
    const float var = block_sum(q, red) / K;
    const float rs = 1.f / sqrtf(var + kLnEps);
    const T* g = (const T*)in.ln_g;
    const T* b = (const T*)in.ln_b;
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      xs[k] = (xs[k] - mean) * rs * to_f<T>(g[k]) + to_f<T>(b[k]);
  }
  if (in.norm_out != nullptr && blockIdx.x == 0)
    for (int k = threadIdx.x; k < K; k += blockDim.x) in.norm_out[k] = xs[k];
  for (int k = threadIdx.x; k < K; k += blockDim.x) xs[k] = round_t<T>(xs[k]);
  __syncthreads();
}

enum Epi : int { kPlain = 0, kRope = 1, kSwiglu = 2 };

struct GemvArgs {
  VecIn in;
  const void* w;      // (rows, K) T, row-major
  const void* bias;   // (rows) T
  int K;
  int units;          // rows (plain), row pairs (rope, swiglu)
  // plain epilogue: y = dot [+ key * krow] + bias [residual + y]
  const float* key;
  const void* krow;
  const float* residual;
  float* out_f;       // f32 output (rounded to T when round_out) ...
  void* out_t;        // ... or T output
  int round_out;
  // rope epilogue: rows < rope_rows rotate in (2j, 2j+1) pairs at pos;
  // rows < D go to out_f, rows in [D, 2D) / [2D, 3D) to k_cache / v_cache
  // row pos (D wide)
  const float* cos;
  const float* sin;
  int pos, hd, rope_rows, D;
  void* k_cache;
  void* v_cache;
  // swiglu epilogue: pair j = rows (j, F + j) -> out_f[j] = h * silu(g)
  int F;
};

template <typename T>
__device__ __forceinline__ float row_dot(const T* w, int row, const float* xs,
                                         int K, int lane) {
  return warp_sum(dot_partial<T>(w + (size_t)row * K, xs, K, lane));
}

template <typename T>
__device__ __forceinline__ void rope_store(const GemvArgs& a, int r, float y) {
  if (r < a.D) {
    a.out_f[r] = y;
  } else if (r < 2 * a.D) {
    ((T*)a.k_cache)[(size_t)a.pos * a.D + (r - a.D)] = from_f<T>(y);
  } else {
    ((T*)a.v_cache)[(size_t)a.pos * a.D + (r - 2 * a.D)] = from_f<T>(y);
  }
}

template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads) gemv_kernel(GemvArgs a) {
  extern __shared__ __align__(16) float xs[];
  __shared__ float red[32];
  load_input<T>(a.in, a.K, xs, red);
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= a.units) return;
  const T* w = (const T*)a.w;
  const T* b = (const T*)a.bias;
  if (EPI == kPlain) {
    float y = row_dot<T>(w, unit, xs, a.K, lane);
    if (lane == 0) {
      if (a.key != nullptr) y += *a.key * to_f<T>(((const T*)a.krow)[unit]);
      y += to_f<T>(b[unit]);
      if (a.residual != nullptr) y = a.residual[unit] + y;
      if (a.out_t != nullptr) {
        ((T*)a.out_t)[unit] = from_f<T>(y);
      } else {
        a.out_f[unit] = a.round_out ? round_t<T>(y) : y;
      }
    }
  } else if (EPI == kRope) {
    const int r0 = 2 * unit, r1 = r0 + 1;
    float y0 = row_dot<T>(w, r0, xs, a.K, lane) + to_f<T>(b[r0]);
    float y1 = row_dot<T>(w, r1, xs, a.K, lane) + to_f<T>(b[r1]);
    if (lane == 0) {
      if (r0 < a.rope_rows) {
        const int f = (r0 % a.hd) >> 1;
        const float c = a.cos[(size_t)a.pos * (a.hd / 2) + f];
        const float s = a.sin[(size_t)a.pos * (a.hd / 2) + f];
        const float t0 = y0 * c - y1 * s;
        const float t1 = y1 * c + y0 * s;
        y0 = t0;
        y1 = t1;
      }
      rope_store<T>(a, r0, y0);
      rope_store<T>(a, r1, y1);
    }
  } else {  // kSwiglu
    const float h = row_dot<T>(w, unit, xs, a.K, lane) + to_f<T>(b[unit]);
    const float g =
        row_dot<T>(w, a.F + unit, xs, a.K, lane) + to_f<T>(b[a.F + unit]);
    if (lane == 0) a.out_f[unit] = h * (g * (1.f / (1.f + expf(-g))));
  }
}

// One block per head: softmax over rows [0, rows) of q . k_cache * scale,
// then the weighted sum of v rows. Caches are (rows, D) with heads
// concatenated along D. Rows beyond `rows` are never read (the -1e9 mask of
// the TPU kernel makes them exact zeros there). The pass is bound by the
// latency of cache reads, so every thread keeps whole 16-byte loads in
// flight: for the logits a thread owns a row (hd / Vec<T> independent loads
// against q in shared memory); for the output a thread owns Vec<T>
// consecutive dims of one row group and walks rows in steps of
// blockDim * Vec / hd, and the groups are summed in shared memory.
// Needs hd % Vec<T>::N == 0 (the wrapper checks hd % 8 == 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cached_attention_kernel(const float* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, float* __restrict__ out,
                        int rows, int D, int hd, float scale) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  float* qs = sm;                    // hd
  float* part = qs + hd;             // blockDim.x * V
  float* p = part + blockDim.x * V;  // rows
  const int h = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < hd; i += blockDim.x) qs[i] = q[h * hd + i];
  __syncthreads();
  float lmax = -INFINITY;
  for (int s = tid; s < rows; s += blockDim.x) {
    const T* kr = k + (size_t)s * D + h * hd;
    float acc = 0.f;
    for (int d = 0; d < hd; d += V) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(kr + d));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) acc = fmaf(qs[d + i], to_f<T>(e[i]), acc);
    }
    acc *= scale;
    p[s] = acc;
    lmax = fmaxf(lmax, acc);
  }
  const float m = block_max(lmax, red);
  float lsum = 0.f;
  for (int s = tid; s < rows; s += blockDim.x) {
    const float e = expf(p[s] - m);
    p[s] = e;
    lsum += e;
  }
  const float denom = block_sum(lsum, red);  // also orders the p[] writes
  const int chunks = hd / V;                 // 16-byte chunks per head row
  const int groups = blockDim.x / chunks;
  const int g = tid / chunks, c = tid % chunks;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (g < groups) {
    for (int s = g; s < rows; s += groups) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          v + (size_t)s * D + h * hd + c * V));
      const T* e = reinterpret_cast<const T*>(&raw);
      const float ps = p[s];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(ps, to_f<T>(e[i]), acc[i]);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) part[g * hd + c * V + i] = acc[i];
  }
  __syncthreads();
  for (int d = tid; d < hd; d += blockDim.x) {
    float t = 0.f;
    for (int j = 0; j < groups; ++j) t += part[j * hd + d];
    out[h * hd + d] = t / denom;
  }
}

template <typename T>
static size_t attention_smem(int hd, int rows) {
  return (size_t)(hd + kThreads * Vec<T>::N + rows) * sizeof(float);
}

// MoE router at B=1 (one block): LayerNorm in the prologue (block 0 stores
// x2), E gate logits, top-k with the first index winning a tie, softmax over
// the k selected raw logits. Writes the expert ids and weights.
template <typename T>
__global__ void __launch_bounds__(kThreads)
router_kernel(VecIn in, int K, const T* __restrict__ gate_w,
              const T* __restrict__ gate_b, int E, int k_top, int* sel,
              float* selw) {
  extern __shared__ __align__(16) float xs[];
  __shared__ float red[32];
  __shared__ float logit[32];
  load_input<T>(in, K, xs, red);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = warp; e < E; e += kWarps) {
    const float acc = row_dot<T>(gate_w, e, xs, K, lane);
    if (lane == 0) logit[e] = acc + to_f<T>(gate_b[e]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int chosen[kMaxTop];
    float val[kMaxTop];
    unsigned used = 0u;
    for (int j = 0; j < k_top; ++j) {
      int best = -1;
      float bv = 0.f;
      for (int e = 0; e < E; ++e) {
        if ((used >> e) & 1u) continue;
        if (best < 0 || logit[e] > bv) {
          best = e;
          bv = logit[e];
        }
      }
      used |= 1u << best;
      chosen[j] = best;
      val[j] = bv;
    }
    float den = 0.f;
    for (int j = 0; j < k_top; ++j) den += expf(val[j] - val[0]);
    for (int j = 0; j < k_top; ++j) {
      sel[j] = chosen[j];
      selw[j] = expf(val[j] - val[0]) / den;
    }
  }
}

// [w1|wg] rows of the shared expert (slot 0) and the selected experts
// (slots 1..k, ids read from sel): act[slot * F + j] = h_j * silu(g_j).
template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_up_kernel(VecIn in, int K, int F, int slots, const T* __restrict__ sw1g,
              const T* __restrict__ sb1g, const T* __restrict__ ew1g,
              const T* __restrict__ eb1g, const int* __restrict__ sel,
              float* __restrict__ act) {
  extern __shared__ __align__(16) float xs[];
  __shared__ float red[32];
  load_input<T>(in, K, xs, red);
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= slots * F) return;
  const int slot = unit / F, j = unit % F;
  const T* w = sw1g;
  const T* b = sb1g;
  if (slot > 0) {
    const int e = sel[slot - 1];
    w = ew1g + (size_t)e * 2 * F * K;
    b = eb1g + (size_t)e * 2 * F;
  }
  const float h = row_dot<T>(w, j, xs, K, lane) + to_f<T>(b[j]);
  const float g = row_dot<T>(w, F + j, xs, K, lane) + to_f<T>(b[F + j]);
  if (lane == 0) act[unit] = h * (g * (1.f / (1.f + expf(-g))));
}

// w2 rows: out[n] = x2[n] + (shared_n / k + sum_j selw[j] * expert_j,n).
template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_down_kernel(const float* __restrict__ act, int F, int D, int k_top,
                const T* __restrict__ sw2, const T* __restrict__ sb2,
                const T* __restrict__ ew2, const T* __restrict__ eb2,
                const int* __restrict__ sel, const float* __restrict__ selw,
                const float* __restrict__ x2, float* __restrict__ out) {
  extern __shared__ __align__(16) float as[];
  const int n_act = (k_top + 1) * F;
  for (int i = threadIdx.x; i < n_act; i += blockDim.x)
    as[i] = round_t<T>(act[i]);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= D) return;
  const float shared = row_dot<T>(sw2, n, as, F, lane) + to_f<T>(sb2[n]);
  float h = shared / (float)k_top;
  for (int j = 0; j < k_top; ++j) {
    const int e = sel[j];
    const float y = row_dot<T>(ew2 + (size_t)e * D * F, n, as + (j + 1) * F,
                               F, lane) +
                    to_f<T>(eb2[(size_t)e * D + n]);
    h += selw[j] * y;
  }
  if (lane == 0) out[n] = x2[n] + h;
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

template <typename T>
static int run_layer(const V2MDecodeLayer& a, cudaStream_t st) {
  const int D = a.D, F = a.F, hd = D / a.H;
  const float scale = 1.f / sqrtf((float)hd);
  // f32 workspace, laid out as in decode_layer.py:workspace_size
  float* x0 = a.work;         // layer input (f32 copy)
  float* q = x0 + D;          // roped self-attention query
  float* attn = q + D;        // self-attention output
  float* r1 = attn + D;       // x0 + attention block (pre-LN)
  float* x1 = r1 + D;         // LN1
  float* cq = x1 + D;         // roped cross query
  float* cattn = cq + D;      // cross-attention output
  float* r2 = cattn + D;      // x1 + cross block (pre-LN)
  float* x2 = r2 + D;         // LN2
  float* r3 = x2 + D;         // x2 + ffn (pre-LN)
  float* selw = r3 + D;       // kMaxTop router weights
  float* act = selw + kMaxTop;  // (k_top + 1) * F
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
    g.out_f = x0;
    g.round_out = 1;
    gemv_kernel<T, kPlain><<<blocks_for(D), kThreads, vec_smem, st>>>(g);
    V2M_CHECK_LAUNCH();
  }
  {  // 2. qkv + RoPE + cache append at pos
    GemvArgs g = {};
    g.in.x = embed ? (const void*)x0 : a.x;
    g.in.x_is_t = embed ? 0 : 1;
    g.in.norm_out = embed ? nullptr : x0;
    g.w = a.wqkv;
    g.bias = a.bqkv;
    g.K = D;
    g.units = 3 * D / 2;
    g.cos = a.rope_cos;
    g.sin = a.rope_sin;
    g.pos = a.pos;
    g.hd = hd;
    g.rope_rows = a.rope_cos != nullptr ? 2 * D : 0;
    g.D = D;
    g.out_f = q;
    g.k_cache = a.k_cache;
    g.v_cache = a.v_cache;
    gemv_kernel<T, kRope><<<blocks_for(g.units), kThreads, vec_smem, st>>>(g);
    V2M_CHECK_LAUNCH();
  }
  const int self_rows = a.pos + 1;
  // 3. self-attention over rows <= pos
  cached_attention_kernel<T><<<a.H, kThreads,
                               attention_smem<T>(hd, self_rows), st>>>(
      q, (const T*)a.k_cache, (const T*)a.v_cache, attn, self_rows, D, hd,
      scale);
  V2M_CHECK_LAUNCH();
  {  // 4. r1 = x0 + (wo . attn + bo)
    GemvArgs g = {};
    g.in.x = attn;
    g.w = a.wo;
    g.bias = a.bo;
    g.K = D;
    g.units = D;
    g.residual = x0;
    g.out_f = r1;
    gemv_kernel<T, kPlain><<<blocks_for(D), kThreads, vec_smem, st>>>(g);
    V2M_CHECK_LAUNCH();
  }
  {  // 5. x1 = LN1(r1); cq = rope(cwq . x1 + cbq)
    GemvArgs g = {};
    g.in.x = r1;
    g.in.ln_g = norm_g;
    g.in.ln_b = norm_b;
    g.in.norm_out = x1;
    g.w = a.cwq;
    g.bias = a.cbq;
    g.K = D;
    g.units = D / 2;
    g.cos = a.rope_cos;
    g.sin = a.rope_sin;
    g.pos = a.pos;
    g.hd = hd;
    g.rope_rows = a.rope_cos != nullptr ? D : 0;
    g.D = D;
    g.out_f = cq;
    gemv_kernel<T, kRope><<<blocks_for(g.units), kThreads, vec_smem, st>>>(g);
    V2M_CHECK_LAUNCH();
  }
  // 6. cross-attention over the primed memory
  cached_attention_kernel<T><<<a.H, kThreads,
                               attention_smem<T>(hd, a.Sm), st>>>(
      cq, (const T*)a.k_cross, (const T*)a.v_cross, cattn, a.Sm, D, hd, scale);
  V2M_CHECK_LAUNCH();
  {  // 7. r2 = x1 + (cwo . cattn + cbo)
    GemvArgs g = {};
    g.in.x = cattn;
    g.w = a.cwo;
    g.bias = a.cbo;
    g.K = D;
    g.units = D;
    g.residual = x1;
    g.out_f = r2;
    gemv_kernel<T, kPlain><<<blocks_for(D), kThreads, vec_smem, st>>>(g);
    V2M_CHECK_LAUNCH();
  }
  // 8. feed-forward: x2 = LN2(r2); r3 = x2 + ffn(x2)
  VecIn ln2 = {};
  ln2.x = r2;
  ln2.ln_g = norm_g + D;
  ln2.ln_b = norm_b + D;
  ln2.norm_out = x2;
  if (a.gate_w == nullptr) {
    GemvArgs g = {};
    g.in = ln2;
    g.w = a.w1g;
    g.bias = a.b1g;
    g.K = D;
    g.units = F;
    g.F = F;
    g.out_f = act;
    gemv_kernel<T, kSwiglu><<<blocks_for(F), kThreads, vec_smem, st>>>(g);
    V2M_CHECK_LAUNCH();
    GemvArgs g2 = {};
    g2.in.x = act;
    g2.w = a.w2;
    g2.bias = a.b2;
    g2.K = F;
    g2.units = D;
    g2.residual = x2;
    g2.out_f = r3;
    gemv_kernel<T, kPlain><<<blocks_for(D), kThreads,
                             (size_t)F * sizeof(float), st>>>(g2);
    V2M_CHECK_LAUNCH();
  } else {
    if (a.k_top < 1 || a.k_top > kMaxTop || a.E > 32 || a.k_top > a.E)
      return (int)cudaErrorInvalidValue;
    router_kernel<T><<<1, kThreads, vec_smem, st>>>(
        ln2, D, (const T*)a.gate_w, (const T*)a.gate_b, a.E, a.k_top, a.sel,
        selw);
    V2M_CHECK_LAUNCH();
    VecIn in2 = {};
    in2.x = x2;
    const int slots = a.k_top + 1;
    moe_up_kernel<T><<<blocks_for(slots * F), kThreads, vec_smem, st>>>(
        in2, D, F, slots, (const T*)a.w1g, (const T*)a.b1g,
        (const T*)a.ew1g, (const T*)a.eb1g, a.sel, act);
    V2M_CHECK_LAUNCH();
    moe_down_kernel<T><<<blocks_for(D), kThreads,
                         (size_t)slots * F * sizeof(float), st>>>(
        act, F, D, a.k_top, (const T*)a.w2, (const T*)a.b2,
        (const T*)a.ew2, (const T*)a.eb2, a.sel, selw, x2, r3);
    V2M_CHECK_LAUNCH();
  }
  {  // 9. y = round(LN3(r3))
    VecIn ln3 = {};
    ln3.x = r3;
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
    gemv_kernel<T, kPlain><<<blocks_for(a.n_out), kThreads, vec_smem, st>>>(g);
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
  if (dtype == kF32) return run_layer<float>(*args, st);
  if (dtype == kBF16) return run_layer<bf16>(*args, st);
  return (int)cudaErrorInvalidValue;
}
