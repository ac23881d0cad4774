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
// on one stream, each spread over many SMs, and each launch's dependent
// round trips, not its bytes, set the time (each moves 0.3-4 MB, a
// microsecond or less of bytes). The chain (eight launches a layer):
//   1. [embed]  GEMV Linear_chord over the gathered embedding rows;
//   2. QKV GEMV, one warp per output pair, with bias + RoPE and the K/V
//      append into the caches at row pos (the caches are updated IN PLACE);
//   3. cached self-attention over rows <= pos, one block a head (at a
//      head size the chain's kernel does not take, batch_decode.cuh's
//      attention of any even head size, a cluster of blocks a head);
//   4. out-projection GEMV + residual;
//   5. LayerNorm (recomputed in every block's prologue) + cross-q GEMV +
//      RoPE, four row pairs a block;
//   6. cross-attention over the Sm primed memory rows, as 3.;
//   7. cross out-projection GEMV + residual;
//   8. shallow: LayerNorm + [linear1|gate] GEMV with the SwiGLU epilogue,
//      then linear2 GEMV + residual; deep: LayerNorm 2 and the router in
//      every block of the first expert GEMV (the 512 x E gate GEMV, top-k
//      by rank with first-index tie-break, any E and k_top <= E, softmax
//      over the selected raw logits; the expert ids stay in device
//      memory), which runs the shared expert's and the selected experts'
//      [w1|wg] rows, then one GEMV over their w2 rows (a warp a (row,
//      expert)); either way the block of the second GEMV that finishes
//      last (a ticket: an atomic counter after a memory fence) forms r3
//      (the MoE: x2 + shared / k + sum_j w_j expert_j) and applies the
//      closing LayerNorm, rounded to the compute dtype;
//   9. [head] LayerNorm + Wout GEMV.
// Every launch uses programmatic dependent launch (batch::launch): before
// its griddepcontrol.wait a kernel only reads weights (a GEMV whose rows
// fit holds its warp's rows in registers; longer rows, the gate, biases,
// norm weights and RoPE rows are prefetched into L2) and L2-prefetches the
// caches, and writes nothing; so a kernel's weight fetch and launch overlap
// the kernel before. Work vectors an earlier launch wrote are read with
// plain loads (or through L2 only) after the wait, never through the
// read-only cache.
// Measured against the first, ten-launch chain (PERF.md): splitting
// each head's attention over a thread-block cluster (batch_decode.cuh
// attn_cluster_kernel at B=1), folding the router into the cwo GEMV's last
// block and folding the out-projections into the attention kernels (per-
// head partials the next launch adds) all lost, and folding the cross
// query into the cross-attention kernel gained nothing (its work stays on
// the critical path; only a launch goes); the attention here is one block
// a head with its loads issued together (512 threads past 256 rows).
// Weights are stored (out, in) row-major so that each output row is one
// contiguous dot product read with 16-byte loads by one warp. Plain FMA and
// warp shuffles, no tensor cores: at B=1 every weight byte is used once.
// With int8 weights (pack_decoder_layers(quantize="int8"), the Pallas
// kernel's int8 form) the layer's GEMVs read int8 rows and scale each f32
// dot by its row's scale before the bias: half the weight bytes of bf16.
// The embed and head GEMVs stay in the compute dtype. The GEMV arguments
// and epilogues, MoE weights and workspace layout are decode_step.cuh's,
// the weight rows and staged, normalised inputs decode_rows.cuh's, shared
// with the cooperative kernel of decode_stack.cu. Rounding is the Pallas
// kernel's (q, the
// probabilities and the attention output f32; every matmul input rounded
// to the compute dtype; the residual stream f32).
#include "batch_decode.cuh"
#include "decode_rows.cuh"
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

// The closing LayerNorm of a layer, run once its grid is done by the block
// that finishes last (a ticket): the n-wide row r, or the MoE combine
// r = x2 + ye[0] / k + sum_j selw[j] ye[j + 1] over the k + 1 expert
// outputs ye (in that order), normalised (LayerNorm ln_g / ln_b,
// layer_norm_warps) and rounded to T into y_out. ticket null: no tail.
// clear: a counter this launch's block 0 sets to 0 after its wait (the
// QKV launch, for the chain's ticket in the workspace: every block that
// takes a ticket waits after it, through the chain's PDL waits).
struct Tail {
  int* ticket;
  int* clear;
  int n;
  const float* r;
  const float* ye;
  const float* x2;
  const float* selw;
  int k_top;
  const void* ln_g;
  const void* ln_b;
  void* y_out;
};

// True in the one block of the grid that arrives last, after the writes
// every block made before its call are visible to it. (The grid-barrier
// pattern: a block barrier, then one thread's fence and atomic.)
__device__ __forceinline__ bool last_block(int* ticket) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1) == (int)(gridDim.x * gridDim.y) - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  return last != 0;
}

// Before the wait: the tail's norm weights into L2 (any block may be last).
template <typename T>
__device__ __forceinline__ void tail_prefetch(const Tail& t) {
  if (t.ticket == nullptr) return;
  prefetch_bytes(t.ln_g, t.n * (int)sizeof(T));
  prefetch_bytes(t.ln_b, t.n * (int)sizeof(T));
}

template <typename T>
__device__ __forceinline__ void run_tail(const Tail& t, float* xs) {
  if (t.ticket == nullptr || !last_block(t.ticket)) return;
  const int D = t.n;
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    if (t.ye == nullptr) {
      xs[k] = __ldcg(t.r + k);
    } else {  // shared / k, then each selected expert's w_j y_j, in order
      float h = __ldcg(t.ye + k) / (float)t.k_top;
      for (int j = 0; j < t.k_top; ++j)
        h += __ldcg(t.selw + j) * __ldcg(t.ye + (size_t)(j + 1) * D + k);
      xs[k] = __ldcg(t.x2 + k) + h;
    }
  }
  __syncthreads();
  layer_norm_warps<T>(xs, D, (const T*)t.ln_g, (const T*)t.ln_b);
  for (int k = threadIdx.x; k < D; k += blockDim.x)
    ((T*)t.y_out)[k] = from_f<T>(xs[k]);
}

// A GEMV of the chain, NW warps a block, a unit (row or row pair) a warp.
// Before the wait the warp's rows go to registers (REGS: K fits) or are
// prefetched to L2; after it the block stages the input (stage_input: the
// optional LayerNorm, the f32 copy out), computes the unit and runs the
// tail.
template <typename T, typename W, int EPI, int NW, bool REGS>
__global__ void __launch_bounds__(NW * 32) chain_gemv_kernel(GemvArgs a,
                                                            Tail t) {
  extern __shared__ __align__(16) float xs[];
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * NW + (threadIdx.x >> 5);
  const bool active = unit < a.units;
  const W* w = (const W*)a.w;
  const int2 r = unit_rows<EPI>(a, unit);
  Row<W, REGS> w0, w1;
  if (active) {
    w0.fetch(w + (size_t)r.x * a.K, a.K, lane);
    if (EPI != kPlain) w1.fetch(w + (size_t)r.y * a.K, a.K, lane);
    if (lane == 0) {  // the epilogue's constants into L2
      const T* b = (const T*)a.bias;
      batch::prefetch_l2(b + r.x);
      batch::prefetch_l2(b + r.y);
      if (EPI == kRope && r.x < a.rope_rows) {
        const size_t f = (size_t)a.pos * (a.hd / 2) + ((r.x % a.hd) >> 1);
        batch::prefetch_l2(a.cos + f);
        batch::prefetch_l2(a.sin + f);
      }
    }
  }
  prefetch_bytes(a.in.ln_g, a.K * (int)sizeof(T));
  prefetch_bytes(a.in.ln_b, a.K * (int)sizeof(T));
  tail_prefetch<T>(t);
  batch::pdl_wait();
  if (t.clear != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *t.clear = 0;
  stage_input<T>(a.in, a.K, xs);
  if (active) {
    const float d0 = scaled<W>(w0.dot(xs, a.K, lane), a.scale, r.x);
    const float d1 =
        EPI == kPlain ? 0.f : scaled<W>(w1.dot(xs, a.K, lane), a.scale, r.y);
    unit_epilogue<T, EPI>(a, unit, d0, d1, lane);
  }
  run_tail<T>(t, xs);
}

// Attention of one head a block of THREADS threads: f32 logits q . k
// times the scale, exponentials of their difference from the maximum, P.V
// divided by their sum at the end (the plain version's softmax), with
// the latency cut: a thread a row for the
// logits (one round: THREADS >= rows up to 512), the row's 16-byte loads
// issued together; P.V by row groups with eight rows' loads in flight;
// the groups' partials summed in a two-level tree. The K / V rows are
// prefetched to L2 before the wait. kRO: the cache is read-only while the
// chain runs (the primed cross K/V); the self caches, whose row pos the
// QKV kernel wrote, are read through L2 only.
template <typename T, bool kRO, int THREADS>
__global__ void __launch_bounds__(THREADS)
chain_attention_kernel(const float* q, const T* k, const T* v, float* out,
                       int rows, int D, int hd, float scale) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  const int h = blockIdx.x, tid = threadIdx.x;
  const int per = (hd * (int)sizeof(T) + 127) / 128;  // lines a head row
  for (int i = tid; i < rows * per; i += THREADS) {
    const size_t o = (size_t)(i / per) * D + h * hd;
    const int line = (i % per) * 128 / (int)sizeof(T);
    batch::prefetch_l2(k + o + line);
    batch::prefetch_l2(v + o + line);
  }
  float* qs = sm;                   // hd
  float* part = qs + hd;            // groups * hd = THREADS * V
  float* tmp = part + THREADS * V;  // THREADS
  float* p = tmp + THREADS;         // rows
  batch::pdl_wait();
  for (int i = tid; i < hd; i += THREADS) qs[i] = q[h * hd + i];
  __syncthreads();
  float lmax = -INFINITY;
  for (int s = tid; s < rows; s += THREADS) {
    const T* kr = k + (size_t)s * D + h * hd;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < hd; d += V) {
      const uint4 raw = load16<kRO>(kr + d);
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
  for (int s = tid; s < rows; s += THREADS) {
    const float e = expf(p[s] - m);
    p[s] = e;
    lsum += e;
  }
  const float denom = block_sum(lsum, red);  // also orders the p[] writes
  const int chunks = hd / V;                 // 16-byte chunks per head row
  const int groups = THREADS / chunks;
  const int g = tid / chunks, c = tid % chunks;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll 8
  for (int s = g; s < rows; s += groups) {
    const uint4 raw = load16<kRO>(v + (size_t)s * D + h * hd + c * V);
    const T* e = reinterpret_cast<const T*>(&raw);
    const float ps = p[s];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(ps, to_f<T>(e[i]), acc[i]);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) part[g * hd + c * V + i] = acc[i];
  __syncthreads();
  const int Q = THREADS / hd, d = tid % hd, qq = tid / hd;
  if (qq < Q) {
    float t = 0.f;
    for (int j = qq; j < groups; j += Q) t += part[j * hd + d];
    tmp[qq * hd + d] = t;
  }
  __syncthreads();
  if (tid < hd) {
    float t = 0.f;
    for (int j = 0; j < Q; ++j) t += tmp[j * hd + tid];
    out[h * hd + tid] = t / denom;
  }
}

// The arguments of the MoE's first GEMV (chain_moe_up_kernel).
struct MoeUp {
  const float* r2;     // the row before LayerNorm 2
  const void* ln_g;    // LayerNorm 2
  const void* ln_b;
  float* x2;           // block 0: LN2(r2) in f32
  const void* gate_w;  // the router (E, D) and its bias
  const void* gate_b;
  int E, k_top;
  int* sel;            // block 0: the selection's expert ids ...
  float* selw;         // ... and weights
  int K, F, slots;
  float* act;          // (slots, F): h * silu(g)
};

// The MoE's first GEMV with the router folded in. Every block normalises
// r2 (LayerNorm 2), rounds it to T and routes it (E logits, the rank
// top-k of common.cuh expert_rank, softmax over the selected raw logits
// from the first one's; block 0
// stores x2, the ids and the weights for the second GEMV), then a warp a
// unit s F + j: rows j and F + j of the shared expert's (slot 0) or the
// s-th selected expert's [w1|wg], act[unit] = h * silu(g). Before the
// wait: the shared expert's rows (registers or L2) and the gate rows (L2).
template <typename T, typename W, bool REGS>
__global__ void __launch_bounds__(kThreads)
chain_moe_up_kernel(MoeUp u, MoeWeights<T, W> m) {
  extern __shared__ __align__(16) float xs[];  // K, E logits, the selection
  float* logit = xs + u.K;
  int* sid = reinterpret_cast<int*>(logit + u.E);
  float* sv = reinterpret_cast<float*>(sid + u.k_top);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = u.K, F = u.F;
  const int unit = blockIdx.x * kWarps + warp;
  const bool active = unit < u.slots * F;
  const int slot = unit / F, j = unit % F;
  const T* gw = (const T*)u.gate_w;
  Row<W, REGS> w0, w1;
  if (active && slot == 0) {
    w0.fetch(m.sw1g + (size_t)j * K, K, lane);
    w1.fetch(m.sw1g + (size_t)(F + j) * K, K, lane);
  }
  for (int e = warp; e < u.E; e += kWarps)
    prefetch_row<T>(gw + (size_t)e * K, K, lane);
  prefetch_bytes(u.gate_b, u.E * (int)sizeof(T));
  prefetch_bytes(u.ln_g, K * (int)sizeof(T));
  prefetch_bytes(u.ln_b, K * (int)sizeof(T));
  if (active && slot == 0 && lane == 0) {
    batch::prefetch_l2(m.sb1g + j);
    batch::prefetch_l2(m.sb1g + F + j);
  }
  batch::pdl_wait();
#pragma unroll 4
  for (int k = threadIdx.x; k < K; k += blockDim.x) xs[k] = u.r2[k];
  __syncthreads();
  layer_norm_warps<T>(xs, K, (const T*)u.ln_g, (const T*)u.ln_b);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    if (blockIdx.x == 0) u.x2[k] = xs[k];
    xs[k] = round_t<T>(xs[k]);
  }
  __syncthreads();
  for (int e = warp; e < u.E; e += kWarps) {
    const float d = dot_row<T>(gw + (size_t)e * K, xs, K, lane);
    if (lane == 0) logit[e] = d + to_f<T>(((const T*)u.gate_b)[e]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < u.E; e += blockDim.x) {
    const int rank = expert_rank(logit, u.E, e);
    if (rank < u.k_top) {
      sid[rank] = e;
      sv[rank] = logit[e];
    }
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    float den = 0.f;  // the softmax's sum, in selection order
    for (int i = 0; i < u.k_top; ++i) den += expf(sv[i] - sv[0]);
    for (int i = threadIdx.x; i < u.k_top; i += blockDim.x) {
      u.sel[i] = sid[i];
      u.selw[i] = expf(sv[i] - sv[0]) / den;
    }
  }
  if (!active) return;
  const W* w = m.sw1g;
  const T* b = m.sb1g;
  const float* s = m.ss1g;
  if (slot > 0) {
    const int e = sid[slot - 1];
    w = m.ew1g + (size_t)e * 2 * F * K;
    b = m.eb1g + (size_t)e * 2 * F;
    if constexpr (std::is_same<W, int8_t>::value)
      s = m.es1g + (size_t)e * 2 * F;
    w0.fetch(w + (size_t)j * K, K, lane);
    w1.fetch(w + (size_t)(F + j) * K, K, lane);
  }
  const float h = scaled<W>(w0.dot(xs, K, lane), s, j) + to_f<T>(b[j]);
  const float g = scaled<W>(w1.dot(xs, K, lane), s, F + j) + to_f<T>(b[F + j]);
  if (lane == 0) u.act[unit] = h * (g * (1.f / (1.f + expf(-g))));
}

// The MoE's second GEMV: row n of the shared expert's (slot 0) or a
// selected expert's w2 over that slot's activations (rounded to T), a
// unit s D + n a warp: ye[unit] = w2 . act_s + b2. The tail combines the
// slots over the residual and applies the closing LayerNorm.
template <typename T, typename W, bool REGS>
__global__ void __launch_bounds__(kThreads)
chain_moe_down_kernel(const float* act, int F, int D, int slots,
                      MoeWeights<T, W> m, const int* sel, float* ye, Tail t) {
  extern __shared__ __align__(16) float as[];
  const int lane = threadIdx.x & 31;
  const int unit = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = unit < slots * D;
  const int slot0 = blockIdx.x * kWarps / D;  // D % kWarps == 0: one slot
  const int n = unit % D;
  Row<W, REGS> w0;
  if (active && slot0 == 0) {
    w0.fetch(m.sw2 + (size_t)n * F, F, lane);
    if (lane == 0) batch::prefetch_l2(m.sb2 + n);
  }
  tail_prefetch<T>(t);
  batch::pdl_wait();
  const T* b = m.sb2;
  const float* s = m.ss2;
  if (active && slot0 > 0) {
    const int e = sel[slot0 - 1];
    if constexpr (std::is_same<W, int8_t>::value) s = m.es2 + (size_t)e * D;
    b = m.eb2 + (size_t)e * D;
    w0.fetch(m.ew2 + ((size_t)e * D + n) * F, F, lane);
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < F; i += blockDim.x)
    as[i] = round_t<T>(act[(size_t)slot0 * F + i]);
  __syncthreads();
  if (active) {
    const float y = scaled<W>(w0.dot(as, F, lane), s, n) + to_f<T>(b[n]);
    if (lane == 0) ye[unit] = y;
  }
  run_tail<T>(t, as);
}

static inline int blocks_for(int units, int per) {
  return (units + per - 1) / per;
}

// Launches kernel (an instance taking `smem` bytes of dynamic shared
// memory) with PDL; opts it in above 48 KB once.
template <typename K, typename... A>
static int launch_pdl(K kernel, bool& opted_in, dim3 grid, int threads,
                      size_t smem, cudaStream_t st, A&&... args) {
  int err;
  if ((err = batch::allow_smem(kernel, opted_in))) return err;
  return batch::launch(kernel, grid, threads, smem, st, 0,
                       std::forward<A>(args)...);
}

// A chain GEMV with NW warps a block: shared memory for the K staged
// inputs or the tail's row.
template <typename T, typename W, int EPI, int NW = kWarps>
static int gemv(const GemvArgs& g, cudaStream_t st, const Tail& t = {}) {
  const size_t smem = (size_t)std::max(g.K, t.n) * sizeof(float);
  const dim3 grid(blocks_for(g.units, NW));
  if (fits_regs<W>(g.K)) {
    static bool opted_in = false;
    return launch_pdl(chain_gemv_kernel<T, W, EPI, NW, true>, opted_in, grid,
                      NW * 32, smem, st, g, t);
  }
  static bool opted_in = false;
  return launch_pdl(chain_gemv_kernel<T, W, EPI, NW, false>, opted_in, grid,
                    NW * 32, smem, st, g, t);
}

// Attention of the chain over `rows` cache rows, one block a head: 256
// threads, 512 past 256 rows. A head size chain_attention_kernel does not
// take (narrow_head: no multiple of 8, or above 256) runs
// batch_decode.cuh attn_any_kernel at B=1: each head's rows over a
// cluster of blocks, value-pair loads (the self caches through L2 only,
// as here).
template <typename T, bool kRO>
static int attend(const float* q, const void* k, const void* v, float* out,
                  int rows, int D, int H, cudaStream_t st) {
  const int hd = D / H;
  const float scale = 1.f / sqrtf((float)hd);
  if (!narrow_head(hd)) {
    batch::Attn t = {};
    t.q = q;
    t.k = k;
    t.v = v;
    t.out = out;
    t.rows = t.stride_rows = rows;
    t.D = D;
    t.hd = hd;
    t.cur = -1;
    t.scale = scale;
    return batch::attention_any<T, T, kRO>(t, 1, H, st);
  }
  auto smem = [&](int threads) {
    return (size_t)(hd + threads * Vec<T>::N + threads + rows) * sizeof(float);
  };
  if (rows > kThreads) {
    static bool opted_in = false;
    return launch_pdl(chain_attention_kernel<T, kRO, 2 * kThreads>, opted_in,
                      dim3(H), 2 * kThreads, smem(2 * kThreads), st, q,
                      (const T*)k, (const T*)v, out, rows, D, hd, scale);
  }
  static bool opted_in = false;
  return launch_pdl(chain_attention_kernel<T, kRO, kThreads>, opted_in,
                    dim3(H), kThreads, smem(kThreads), st, q, (const T*)k,
                    (const T*)v, out, rows, D, hd, scale);
}

// The MoE half of a deep layer: LN2 + router + [w1|wg], then w2 and the
// combine + LN3 tail.
template <typename T, typename W>
static int moe(const V2MDecodeLayer& a, const Work& w, const Tail& ln3,
               cudaStream_t st) {
  const int D = a.D, F = a.F, slots = a.k_top + 1;
  MoeUp u = {};
  u.r2 = w.r2;
  u.ln_g = (const T*)a.norm_scale + D;
  u.ln_b = (const T*)a.norm_bias + D;
  u.x2 = w.x2;
  u.gate_w = a.gate_w;
  u.gate_b = a.gate_b;
  u.E = a.E;
  u.k_top = a.k_top;
  u.sel = a.sel;
  u.selw = w.selw;
  u.K = D;
  u.F = F;
  u.slots = slots;
  u.act = w.act;
  const MoeWeights<T, W> m = {
      (const W*)a.w1g, (const T*)a.b1g, a.w1g_s,
      (const W*)a.w2, (const T*)a.b2, a.w2_s,
      (const W*)a.ew1g, (const T*)a.eb1g, a.ew1g_s,
      (const W*)a.ew2, (const T*)a.eb2, a.ew2_s};
  const dim3 up(blocks_for(slots * F, kWarps)), down(blocks_for(slots * D,
                                                                kWarps));
  const size_t up_smem = (size_t)(D + a.E + 2 * a.k_top) * sizeof(float);
  const size_t down_smem = (size_t)std::max(F, D) * sizeof(float);
  int err;
  if (fits_regs<W>(D)) {
    static bool in = false;
    err = launch_pdl(chain_moe_up_kernel<T, W, true>, in, up, kThreads,
                     up_smem, st, u, m);
  } else {
    static bool in = false;
    err = launch_pdl(chain_moe_up_kernel<T, W, false>, in, up, kThreads,
                     up_smem, st, u, m);
  }
  if (err) return err;
  float* ye = w.act + (size_t)slots * F;  // decode_layer.py workspace_size
  if (fits_regs<W>(F)) {
    static bool in = false;
    return launch_pdl(chain_moe_down_kernel<T, W, true>, in, down, kThreads,
                      down_smem, st, (const float*)w.act, F, D, slots, m,
                      (const int*)a.sel, ye, ln3);
  }
  static bool in = false;
  return launch_pdl(chain_moe_down_kernel<T, W, false>, in, down, kThreads,
                    down_smem, st, (const float*)w.act, F, D, slots, m,
                    (const int*)a.sel, ye, ln3);
}

template <typename T, typename W>
static int run_layer(const V2MDecodeLayer& a, cudaStream_t st) {
  const int D = a.D, F = a.F, hd = D / a.H;
  const Work w(a.work, D, a.k_top);  // decode_layer.py:workspace_size
  // the closing LayerNorm's block counter, after the (k_top + 1, D) outputs
  int* ticket = (int*)(w.act + (size_t)(a.k_top + 1) * (F + D));
  const T* norm_g = (const T*)a.norm_scale;
  const T* norm_b = (const T*)a.norm_bias;
  const bool embed = a.token_root != nullptr;
  int err;

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
    if ((err = gemv<T, T, kPlain>(g, st))) return err;
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
    Tail t = {};
    t.clear = ticket;
    if ((err = gemv<T, W, kRope>(g, st, t))) return err;
  }
  // 3. self-attention over rows <= pos
  if ((err = attend<T, false>(w.q, a.k_cache, a.v_cache, w.attn, a.pos + 1,
                              D, a.H, st)))
    return err;
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
    if ((err = gemv<T, W, kPlain>(g, st))) return err;
  }
  {  // 5. x1 = LN1(r1); cq = rope(cwq . x1 + cbq), four row pairs a block
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
    if ((err = gemv<T, W, kRope, kWarps / 2>(g, st))) return err;
  }
  // 6. cross-attention over the primed memory
  if ((err = attend<T, true>(w.cq, a.k_cross, a.v_cross, w.cattn, a.Sm, D,
                             a.H, st)))
    return err;
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
    if ((err = gemv<T, W, kPlain>(g, st))) return err;
  }
  Tail ln3 = {};  // y = round(LN3(r3)) by the last block of the FFN
  ln3.ticket = ticket;
  ln3.n = D;
  ln3.r = w.r3;
  ln3.ln_g = norm_g + 2 * D;
  ln3.ln_b = norm_b + 2 * D;
  ln3.y_out = a.y;
  if (a.gate_w == nullptr) {  // 8. x2 = LN2(r2); r3 = x2 + w2 . swiglu(..)
    GemvArgs g = {};
    g.in.x = w.r2;
    g.in.ln_g = norm_g + D;
    g.in.ln_b = norm_b + D;
    g.in.norm_out = w.x2;
    g.w = a.w1g;
    g.scale = a.w1g_s;
    g.bias = a.b1g;
    g.K = D;
    g.units = F;
    g.F = F;
    g.out_f = w.act;
    if ((err = gemv<T, W, kSwiglu>(g, st))) return err;
    GemvArgs g2 = {};
    g2.in.x = w.act;
    g2.w = a.w2;
    g2.scale = a.w2_s;
    g2.bias = a.b2;
    g2.K = F;
    g2.units = D;
    g2.residual = w.x2;
    g2.out_f = w.r3;
    if ((err = gemv<T, W, kPlain>(g2, st, ln3))) return err;
  } else {  // 8. x2 = LN2(r2), the router, r3 = x2 + shared / k + sum_j ..
    if (a.k_top < 1 || a.k_top > a.E) return (int)cudaErrorInvalidValue;
    Tail t = ln3;
    t.r = nullptr;
    t.ye = w.act + (size_t)(a.k_top + 1) * F;
    t.x2 = w.x2;
    t.k_top = a.k_top;
    t.selw = w.selw;
    if ((err = moe<T, W>(a, w, t, st))) return err;
  }
  if (a.wout != nullptr) {  // 9. logits = round(wout . round(LN(y)) + bout)
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
    if ((err = gemv<T, T, kPlain>(g, st))) return err;
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
