// Device code of one B=1 decoder-layer step of AMT 2.2 (post-norm V2
// wiring): the pieces of the cooperative whole-run kernel of
// decode_stack.cu, several of which (the GEMV arguments and epilogues, the
// workspace layout, the int8 dot) the launch chain of decode_layer.cu
// shares.
//
// The GEMVs come as one work unit (a row or a row pair) for a warp: the
// cooperative kernel walks the units of a phase with all its warps (the
// *_units loops). No piece returns from a kernel, so a cooperative kernel
// can put a grid barrier after any of them.
//
// Loads: weights and the primed cross K/V are read-only while a kernel runs
// and go through the read-only cache (__ldg). The self-attention caches are
// written at row pos by the QKV phase of the same cooperative kernel that
// reads them, so that kernel reads them with __ldcg (L2, coherent). Work
// vectors written in a kernel are read with plain loads, never through
// const __restrict__ pointers (which may compile to non-coherent loads).
//
// int8 weights (W = int8_t): a GEMV reads int8 rows with 16-byte loads,
// multiplies the f32 dot by the row's f32 scale and then adds the bias, as
// the Pallas kernel's _scaled_dot does on the output side.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace v2m {

constexpr int kWarps = 8;  // GEMV rows (or row pairs) per block
constexpr int kThreads = kWarps * 32;
constexpr float kLnEps = 1e-5f;

// The input vector a GEMV block stages in shared memory.
struct VecIn {
  const void* x;      // T when x_is_t, else float; null = embedding gather
  int x_is_t;
  const void* ln_g;   // LayerNorm scale/bias (T) to apply, or null
  const void* ln_b;
  const void* ln2_g;  // a second LayerNorm after rounding to T, or null
  const void* ln2_b;
  float* norm_out;    // block 0 stores the f32 (normalized) input, or null
  int round_first;    // ... rounded to T (the next layer's x0), not raw
  const int* root;    // embedding gather: emb_root[*root] + emb_attr[*attr]
  const int* attr;
  const void* emb_root;
  const void* emb_attr;
};

// LayerNorm of xs[0:K] in place, f32, two-pass mean / variance. Each thread
// owns the same k in every loop.
template <typename T>
__device__ __forceinline__ void layer_norm_smem(float* xs, int K, const T* g,
                                                const T* b, float* red) {
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
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    xs[k] = (xs[k] - mean) * rs * to_f<T>(g[k]) + to_f<T>(b[k]);
}

// Stage the input in xs (K floats): load or gather, optional LayerNorm in
// f32, optional f32 copy out, then round to T as the matmul input.
template <typename T>
__device__ __forceinline__ void load_input(const VecIn& in, int K, float* xs,
                                           float* red) {
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
  if (in.ln_g != nullptr)
    layer_norm_smem<T>(xs, K, (const T*)in.ln_g, (const T*)in.ln_b, red);
  if (in.ln2_g != nullptr) {
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      xs[k] = round_t<T>(xs[k]);
    layer_norm_smem<T>(xs, K, (const T*)in.ln2_g, (const T*)in.ln2_b, red);
  }
  if (in.round_first)
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      xs[k] = round_t<T>(xs[k]);
  if (in.norm_out != nullptr && blockIdx.x == 0)
    for (int k = threadIdx.x; k < K; k += blockDim.x) in.norm_out[k] = xs[k];
  for (int k = threadIdx.x; k < K; k += blockDim.x) xs[k] = round_t<T>(xs[k]);
  __syncthreads();
}

enum Epi : int { kPlain = 0, kRope = 1, kSwiglu = 2 };

struct GemvArgs {
  VecIn in;
  const void* w;      // (rows, K) W, row-major
  const float* scale; // (rows) f32 dequantization scale when W is int8
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

template <typename W>
__device__ __forceinline__ float row_dot(const W* w, int row, const float* xs,
                                         int K, int lane) {
  return warp_sum(dot_partial<W>(w + (size_t)row * K, xs, K, lane));
}

// The dot of row `row` of w with xs, dequantized when W is int8.
template <typename W>
__device__ __forceinline__ float wdot(const W* w, const float* scale, int row,
                                      const float* xs, int K, int lane) {
  const float d = row_dot<W>(w, row, xs, K, lane);
  if constexpr (std::is_same<W, int8_t>::value) return d * scale[row];
  return d;
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

// The rows of GEMV unit `unit`: plain: the row; rope: the pair 2u, 2u + 1;
// swiglu: rows u and F + u.
template <int EPI>
__device__ __forceinline__ int2 unit_rows(const GemvArgs& a, int unit) {
  if (EPI == kPlain) return make_int2(unit, unit);
  if (EPI == kRope) return make_int2(2 * unit, 2 * unit + 1);
  return make_int2(unit, a.F + unit);
}

// The epilogue of one GEMV unit from the (dequantized) dots d0 and d1 of
// its rows, every lane holding both; lane 0 stores.
template <typename T, int EPI>
__device__ __forceinline__ void unit_epilogue(const GemvArgs& a, int unit,
                                              float d0, float d1, int lane) {
  const T* b = (const T*)a.bias;
  if (EPI == kPlain) {
    if (lane == 0) {
      float y = d0;
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
    float y0 = d0 + to_f<T>(b[r0]);
    float y1 = d1 + to_f<T>(b[r1]);
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
    const float h = d0 + to_f<T>(b[unit]);
    const float g = d1 + to_f<T>(b[a.F + unit]);
    if (lane == 0) a.out_f[unit] = h * (g * (1.f / (1.f + expf(-g))));
  }
}

// One GEMV unit (a row, or a row pair) over the input staged in xs.
template <typename T, typename W, int EPI>
__device__ __forceinline__ void gemv_unit(const GemvArgs& a, const float* xs,
                                          int unit) {
  const int lane = threadIdx.x & 31;
  const W* w = (const W*)a.w;
  const int2 r = unit_rows<EPI>(a, unit);
  const float d0 = wdot<W>(w, a.scale, r.x, xs, a.K, lane);
  const float d1 = EPI == kPlain ? 0.f : wdot<W>(w, a.scale, r.y, xs, a.K, lane);
  unit_epilogue<T, EPI>(a, unit, d0, d1, lane);
}

// The GEMV units [unit0, units) in steps of stride.
template <typename T, typename W, int EPI>
__device__ __forceinline__ void gemv_units(const GemvArgs& a, const float* xs,
                                           int unit0, int stride) {
  for (int unit = unit0; unit < a.units; unit += stride)
    gemv_unit<T, W, EPI>(a, xs, unit);
}

// One 16-byte load of a K/V cache row: read-only cache, or L2 only for a
// cache the same kernel writes.
template <bool kReadOnly>
__device__ __forceinline__ uint4 load16(const void* p) {
  if constexpr (kReadOnly) return __ldg(reinterpret_cast<const uint4*>(p));
  return __ldcg(reinterpret_cast<const uint4*>(p));
}

// Head h: softmax over rows [0, rows) of q . k * scale, then the weighted
// sum of v rows. Caches are (rows, D) with heads concatenated along D. Rows
// beyond `rows` are never read (the -1e9 mask of the TPU kernel makes them
// exact zeros there). The pass is bound by the latency of cache reads, so
// every thread keeps whole 16-byte loads in flight: for the logits a thread
// owns a row (hd / Vec<T> independent loads against q in shared memory); for
// the output a thread owns Vec<T> consecutive dims of one row group and
// walks rows in steps of blockDim * Vec / hd, and the groups are summed in
// shared memory. Needs hd % Vec<T>::N == 0 (the wrapper checks hd % 8 == 0)
// and attention_smem floats of shared memory at sm.
template <typename T, bool kReadOnly>
__device__ __forceinline__ void attention_head(const float* q, const T* k,
                                               const T* v, float* out,
                                               int rows, int D, int hd,
                                               float scale, int h, float* sm,
                                               float* red) {
  constexpr int V = Vec<T>::N;
  float* qs = sm;                    // hd
  float* part = qs + hd;             // blockDim.x * V
  float* p = part + blockDim.x * V;  // rows
  const int tid = threadIdx.x;
  for (int i = tid; i < hd; i += blockDim.x) qs[i] = q[h * hd + i];
  __syncthreads();
  float lmax = -INFINITY;
  for (int s = tid; s < rows; s += blockDim.x) {
    const T* kr = k + (size_t)s * D + h * hd;
    float acc = 0.f;
    for (int d = 0; d < hd; d += V) {
      const uint4 raw = load16<kReadOnly>(kr + d);
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
      const uint4 raw =
          load16<kReadOnly>(v + (size_t)s * D + h * hd + c * V);
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
__host__ __device__ constexpr int attention_smem_floats(int hd, int rows) {
  return hd + kThreads * Vec<T>::N + rows;
}

// MoE router at B=1 over the input staged in xs: E gate logits into
// logit (E floats of scratch), top-k with the first index winning a tie
// (expert_rank: any E, any k_top <= E), softmax over the k selected raw
// logits. Writes the expert ids to sel and their weights to selw (k_top
// each, shared or global memory); sync the block before reading them.
template <typename T>
__device__ __forceinline__ void route(const float* xs, int K, const T* gate_w,
                      const T* gate_b, int E, int k_top, float* logit,
                      int* sel, float* selw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int e = warp; e < E; e += nw) {
    const float acc = row_dot<T>(gate_w, e, xs, K, lane);
    if (lane == 0) logit[e] = acc + to_f<T>(gate_b[e]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int rank = expert_rank(logit, E, e);
    if (rank < k_top) {
      sel[rank] = e;
      selw[rank] = logit[e];  // the raw logit until the softmax below
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float v0 = selw[0];
    float den = 0.f;
    for (int j = 0; j < k_top; ++j) den += expf(selw[j] - v0);
    for (int j = 0; j < k_top; ++j) selw[j] = expf(selw[j] - v0) / den;
  }
}

// The weights of one MoE layer as the up / down GEMVs read them.
template <typename T, typename W>
struct MoeWeights {
  const W* sw1g; const T* sb1g; const float* ss1g;  // shared expert [w1|wg]
  const W* sw2; const T* sb2; const float* ss2;     // shared expert w2
  const W* ew1g; const T* eb1g; const float* es1g;  // (E, 2F, K) experts
  const W* ew2; const T* eb2; const float* es2;     // (E, D, F) experts
};

// [w1|wg] rows of the shared expert (slot 0) and the selected experts
// (slots 1..k, ids read from sel): act[slot * F + j] = h_j * silu(g_j) for
// unit slot * F + j.
template <typename T, typename W>
__device__ __forceinline__ void moe_up_unit(const float* xs, int K, int F,
                                            const MoeWeights<T, W>& m,
                                            const int* sel, float* act,
                                            int unit) {
  const int lane = threadIdx.x & 31;
  {
    const int slot = unit / F, j = unit % F;
    const W* w = m.sw1g;
    const T* b = m.sb1g;
    const float* s = m.ss1g;
    if (slot > 0) {
      const int e = sel[slot - 1];
      w = m.ew1g + (size_t)e * 2 * F * K;
      b = m.eb1g + (size_t)e * 2 * F;
      if constexpr (std::is_same<W, int8_t>::value)
        s = m.es1g + (size_t)e * 2 * F;
    }
    const float h = wdot<W>(w, s, j, xs, K, lane) + to_f<T>(b[j]);
    const float g = wdot<W>(w, s, F + j, xs, K, lane) + to_f<T>(b[F + j]);
    if (lane == 0) act[unit] = h * (g * (1.f / (1.f + expf(-g))));
  }
}

// moe_up_unit over units [unit0, slots * F) in steps of stride.
template <typename T, typename W>
__device__ __forceinline__ void moe_up_units(const float* xs, int K, int F,
                                             int slots,
                                             const MoeWeights<T, W>& m,
                                             const int* sel, float* act,
                                             int unit0, int stride) {
  for (int unit = unit0; unit < slots * F; unit += stride)
    moe_up_unit<T, W>(xs, K, F, m, sel, act, unit);
}

// Stage the (k_top + 1) * F activations, rounded to T, in shared memory.
template <typename T>
__device__ __forceinline__ void stage_act(const float* act, int n,
                                          float* as) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    as[i] = round_t<T>(act[i]);
  __syncthreads();
}

// w2 row n over the staged activations as: out[n] = x2[n] + (shared_n / k
// + sum_j selw[j] * expert_j,n).
template <typename T, typename W>
__device__ __forceinline__ void moe_down_unit(const float* as, int F, int D,
                                              int k_top,
                                              const MoeWeights<T, W>& m,
                                              const int* sel,
                                              const float* selw,
                                              const float* x2, float* out,
                                              int n) {
  const int lane = threadIdx.x & 31;
  {
    const float shared = wdot<W>(m.sw2, m.ss2, n, as, F, lane) +
                         to_f<T>(m.sb2[n]);
    float h = shared / (float)k_top;
    for (int j = 0; j < k_top; ++j) {
      const int e = sel[j];
      const float* s = nullptr;
      if constexpr (std::is_same<W, int8_t>::value) s = m.es2 + (size_t)e * D;
      const float y = wdot<W>(m.ew2 + (size_t)e * D * F, s, n,
                              as + (j + 1) * F, F, lane) +
                      to_f<T>(m.eb2[(size_t)e * D + n]);
      h += selw[j] * y;
    }
    if (lane == 0) out[n] = x2[n] + h;
  }
}

// moe_down_unit over units [unit0, D) in steps of stride.
template <typename T, typename W>
__device__ __forceinline__ void moe_down_units(
    const float* as, int F, int D, int k_top, const MoeWeights<T, W>& m,
    const int* sel, const float* selw, const float* x2, float* out,
    int unit0, int stride) {
  for (int n = unit0; n < D; n += stride)
    moe_down_unit<T, W>(as, F, D, k_top, m, sel, selw, x2, out, n);
}

// Layout of the f32 workspace of one layer step (decode_layer.py
// workspace_size): ten D-wide vectors, the router weights, the activations.
struct Work {
  float *x0, *q, *attn, *r1, *x1, *cq, *cattn, *r2, *x2, *r3, *selw, *act;
  __host__ __device__ Work(float* w, int D, int k_top) {
    x0 = w;             // layer input (f32 copy)
    q = x0 + D;         // roped self-attention query
    attn = q + D;       // self-attention output
    r1 = attn + D;      // x0 + attention block (pre-LN)
    x1 = r1 + D;        // LN1
    cq = x1 + D;        // roped cross query
    cattn = cq + D;     // cross-attention output
    r2 = cattn + D;     // x1 + cross block (pre-LN)
    x2 = r2 + D;        // LN2
    r3 = x2 + D;        // x2 + ffn (pre-LN)
    selw = r3 + D;      // k_top router weights
    act = selw + selw_floats(k_top);  // (k_top + 1) * F, then the
                                      // chain's (k_top + 1) * D outputs
  }
};

}  // namespace v2m
