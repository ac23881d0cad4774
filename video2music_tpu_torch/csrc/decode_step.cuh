// Definitions of one B=1 decoder-layer step of AMT 2.2 (post-norm V2
// wiring) that the launch chain of decode_layer.cu and the cooperative
// whole-run kernel of decode_stack.cu share: a GEMV's staged input and
// arguments, its work units (a row or a row pair for a warp) and their
// epilogues, the MoE weights and the workspace layout.
//
// Loads: weights and the primed cross K/V are read-only while a kernel runs
// and go through the read-only cache (__ldg). The self-attention caches are
// written at row pos by a kernel that may read them, so they are read with
// __ldcg (L2, coherent). Work vectors written in a kernel are read with
// plain loads or through L2, never through const __restrict__ pointers
// (which may compile to non-coherent loads).
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

// One 16-byte load of a K/V cache row: read-only cache, or L2 only for a
// cache the same kernel writes.
template <bool kReadOnly>
__device__ __forceinline__ uint4 load16(const void* p) {
  if constexpr (kReadOnly) return __ldg(reinterpret_cast<const uint4*>(p));
  return __ldcg(reinterpret_cast<const uint4*>(p));
}

// The weights of one MoE layer as the up / down GEMVs read them.
template <typename T, typename W>
struct MoeWeights {
  const W* sw1g; const T* sb1g; const float* ss1g;  // shared expert [w1|wg]
  const W* sw2; const T* sb2; const float* ss2;     // shared expert w2
  const W* ew1g; const T* eb1g; const float* es1g;  // (E, 2F, K) experts
  const W* ew2; const T* eb2; const float* es2;     // (E, D, F) experts
};

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
