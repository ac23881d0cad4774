// The blocks of the batched decode kernels (csrc/decode_batch.cu and
// csrc/decode_variant.cu), at B=1 as well as for B clips at one shared
// position: tensor cores (mma.sync) for bf16 at B >= 2, cluster-split
// attention, and programmatic dependent launch (PDL) between the launches
// of a chain.
//
// The GEMV, y[b] = W . x[b] (+ epilogue), has two instances, picked by the
// launcher (gemv) by dtype and shape:
//   * bf16 at B >= 2 where every slot takes every clip (one weight, or a
//     MoE's dense expert slots, blockIdx.z the slot) runs
//     on the tensor cores (mgemv_kernel): the weights (out, in) row-major
//     are the A operand of mma.sync.m16n8k16, 16 output rows a tile,
//     streamed in 64-wide k chunks by 16-byte cp.async into a ring of
//     stages per warp and read with ldmatrix; the staged clips (B, K) are
//     the B operand ("col" layout, no transpose), 16 clips a block, padded
//     with zero rows; the block's 8 warps split K and reduce their f32
//     partials in shared memory in warp order; the epilogues (RoPE pairs
//     across lanes 4 apart by one shuffle, SwiGLU pairs as two A tiles,
//     bias, residual, activation) run on the C fragments;
//   * everything else (f32, int8 weights, B=1, routed expert slots) runs
//     the FMA kernel (bgemv_kernel): a warp holds one weight row (or a row
//     pair) in registers, 1024 values at a time (longer rows in chunks),
//     and walks the clips' rows staged in shared memory kTile at a time
//     with independent sums. blockIdx.y picks a slot: slot 0 the plain
//     weight (or a MoE's shared expert), slot e + 1 expert e, which stages
//     and computes only the clips its router listed.
// Both stage the input rows with a LayerNorm or RMSNorm folded in (f32
// statistics, an f32 copy in norm_out) and round them to T, the Pallas
// rounding point of a matmul input. No width limit.
//
// Attention over cached rows runs one thread-block cluster of 1-8 blocks per
// (value head, clip), more where the grid would leave SMs idle (B=1):
// each block takes a contiguous chunk of the rows (8 lanes per row, 16
// bytes each), its logits and local max; the cluster exchanges the maxima,
// then the sums, through distributed shared memory, each block normalises
// and rounds its probabilities where the Pallas kernel does and forms its
// partial P.V, and the cluster's first block sums the partials in rank
// order and finishes (rounding, the differential combine, subln). A
// vanilla or RPR head at B >= 2 runs one block per (value head, clip)
// instead, which does all of it. A head size neither takes (no multiple
// of their load width, or above kThreads) runs attn_any_kernel, one block
// per (value head, clip) at any even head size, its loads value pairs.
// The MoE router and the per-clip closing residual + norm follow.
//
// Every kernel here is launched by launch() with programmatic dependent
// launch allowed. Before pdl_wait() it reads only what no kernel of a
// decode step writes (weights, biases, norm weights, RoPE tables; L2
// prefetches of the caches) and writes nothing; once the wait returns it
// lets the next kernel launch. So a kernel's weight fetch overlaps the
// previous kernel's work and the launch gap, one kernel ahead.
//
// What bounds them on the H100: bytes (each weight read once a step, the
// caches once per clip) and, for chains of 7-13 launches per layer, the
// latency of each launch; the tensor cores leave the B >= 2 GEMVs at their
// weight fetch and input staging.
//
// int8 forms, each its own template instance beside the T one: the FMA GEMV
// with int8 weight rows (W = int8_t: 16 weights a load, the f32 sum times
// the row's scale before the bias), and attention over int8 cache rows
// (C = int8_t: one f32 scale per row, folded into the logit and the
// probability; the current row from its dequantized copy).
//
// The kernels are static: each source that includes this header builds its
// own instances.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>
#include <utility>

#include "attention_mma.cuh"
#include "common.cuh"

namespace v2m {
namespace batch {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 8;          // staged rows a warp sums side by side
constexpr int kRowChunk = 1024;   // weight values a warp holds in registers
constexpr float kLnEps = 1e-5f;   // LayerNorm
constexpr float kRmsEps = 1e-6f;  // RMSNorm
constexpr size_t kSmemMax = 227 * 1024;  // dynamic shared memory a block may use

// ---------------------------------------------------------------------------
// programmatic dependent launch
// ---------------------------------------------------------------------------

// Blocks until every kernel before this one in the stream has completed and
// its writes are visible, then lets the next kernel of the stream launch:
// its blocks run their prologue (weight fetch) while this kernel works, one
// kernel ahead and no further.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

using v2m::prefetch_l2;

// kernel<<<grid, threads, smem, st>>>(args...) with programmatic dependent
// launch allowed, as clusters of `cluster` blocks along x when cluster > 0.
// Returns the launch's cudaError_t code.
template <typename... P, typename... A>
static int launch(void (*kernel)(P...), dim3 grid, int threads, size_t smem,
                  cudaStream_t st, int cluster, A&&... args) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  int n = 1;
  if (cluster > 0) {
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = cluster;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = 1;
    n = 2;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return (int)cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
}

// Lets `kernel` take as much dynamic shared memory as fits beside its
// static shared memory in kSmemMax; once per instance. Returns a
// cudaError_t code.
template <typename K>
static int allow_smem(K kernel, bool& done) {
  if (done) return 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(kSmemMax - fa.sharedSizeBytes));
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// ---------------------------------------------------------------------------
// input staging
// ---------------------------------------------------------------------------

// The B input rows of a batched GEMV.
struct RowsIn {
  const void* x;        // (slots, B, K): T when x_is_t, else f32;
                        // null = embedding gather
  int x_is_t;
  size_t slot_stride;   // elements between slots' rows (0 = one input)
  const void* ln_g;     // norm (T) to apply to each row, or null
  const void* ln_b;     // LayerNorm shift (unused by RMSNorm)
  int rms;              // 0: LayerNorm (eps 1e-5), 1: RMSNorm (eps 1e-6)
  float* norm_out;      // (B, K) f32 copy of the rows, by the first block
                        // of the lowest slot
  const int* root;      // gather: emb_root[root[b]] + emb_attr[attr[b]]
  const int* attr;
  const void* emb_root;
  const void* emb_attr;
};

// Four consecutive T values as loaded (f32: 16 bytes, bf16: the first 8).
template <typename T> __device__ __forceinline__ uint4 load_bits(const T* p);
template <> __device__ __forceinline__ uint4 load_bits<float>(const float* p) {
  return *reinterpret_cast<const uint4*>(p);
}
template <> __device__ __forceinline__ uint4 load_bits<bf16>(const bf16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_uint4(r.x, r.y, 0u, 0u);
}

// The same through the read-only cache (weights: never written by a kernel).
template <typename T> __device__ __forceinline__ uint4 load_bits_ro(const T* p);
template <>
__device__ __forceinline__ uint4 load_bits_ro<float>(const float* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
template <>
__device__ __forceinline__ uint4 load_bits_ro<bf16>(const bf16* p) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  return make_uint4(r.x, r.y, 0u, 0u);
}

template <typename T> __device__ __forceinline__ float4 from_bits(uint4 r);
template <> __device__ __forceinline__ float4 from_bits<float>(uint4 r) {
  return make_float4(__uint_as_float(r.x), __uint_as_float(r.y),
                     __uint_as_float(r.z), __uint_as_float(r.w));
}
template <> __device__ __forceinline__ float4 from_bits<bf16>(uint4 r) {
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

// The kinds of input rows, one per launch: the embedding gather, T rows,
// f32 rows. Staging loops are instantiated per kind, so each load of a batch
// has its own registers and issues before any value is used: their
// latencies overlap.
enum InKind : int { kGather = 0, kInT = 1, kInF32 = 2 };

__device__ __forceinline__ int in_kind(const RowsIn& in) {
  return in.x == nullptr ? kGather : in.x_is_t ? kInT : kInF32;
}

// Calls f(std::integral_constant<int, kind>) for the input's kind.
template <typename F>
__device__ __forceinline__ void by_kind(const RowsIn& in, F&& f) {
  switch (in_kind(in)) {
    case kGather: f(std::integral_constant<int, kGather>()); break;
    case kInT: f(std::integral_constant<int, kInT>()); break;
    default: f(std::integral_constant<int, kInF32>()); break;
  }
}

// Values k .. k + 3 of input row b of `slot` as loaded (the gather's two
// embedding rows in a and b).
struct Raw4 {
  uint4 a, b;
};

template <typename T, int KIND>
__device__ __forceinline__ Raw4 load_raw4(const RowsIn& in, int slot, int b,
                                          int K, int k) {
  Raw4 r;
  if constexpr (KIND == kGather) {
    r.a = load_bits<T>((const T*)in.emb_root + (size_t)in.root[b] * K + k);
    r.b = load_bits<T>((const T*)in.emb_attr + (size_t)in.attr[b] * K + k);
  } else {
    const size_t o = (size_t)slot * in.slot_stride + (size_t)b * K + k;
    if constexpr (KIND == kInT) r.a = load_bits<T>((const T*)in.x + o);
    else r.a = load_bits<float>((const float*)in.x + o);
  }
  return r;
}

// The f32 values of a Raw4, before the norm.
template <typename T, int KIND>
__device__ __forceinline__ float4 cook4(const Raw4& r) {
  if constexpr (KIND == kGather) {
    const float4 u = from_bits<T>(r.a), t = from_bits<T>(r.b);
    return make_float4(u.x + t.x, u.y + t.y, u.z + t.z, u.w + t.w);
  } else if constexpr (KIND == kInT) {
    return from_bits<T>(r.a);
  } else {
    return from_bits<float>(r.a);
  }
}

// Values k .. k + 3 of input row b of `slot`, before the norm.
template <typename T>
__device__ __forceinline__ float4 input4(const RowsIn& in, int slot, int b,
                                         int K, int k) {
  switch (in_kind(in)) {
    case kGather:
      return cook4<T, kGather>(load_raw4<T, kGather>(in, slot, b, K, k));
    case kInT: return cook4<T, kInT>(load_raw4<T, kInT>(in, slot, b, K, k));
    default: return cook4<T, kInF32>(load_raw4<T, kInF32>(in, slot, b, K, k));
  }
}

constexpr int kStageUnroll = 8;  // staging loads a thread has in flight

// (mean, 1 / std) of the folded norm of a row whose values the warp's lanes
// fetch with get(c), c the row's four-value chunks: two-pass LayerNorm, or
// RMSNorm (mean 0). Every lane gets them.
template <typename Get>
__device__ __forceinline__ float2 row_stats(Get get, int K, int rms,
                                            int lane) {
  const int K4 = K / 4;
  float mean = 0.f, rs;
  if (rms) {  // y = x * rsqrt(mean(x^2) + eps) * g
    float q = 0.f;
#pragma unroll 4
    for (int c = lane; c < K4; c += 32) {
      const float4 v = get(c);
      q += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
    rs = 1.f / sqrtf(warp_sum(q) / K + kRmsEps);
  } else {    // y = (x - mean) * rsqrt(var + eps) * g + b
    float s = 0.f;
#pragma unroll 4
    for (int c = lane; c < K4; c += 32) {
      const float4 v = get(c);
      s += (v.x + v.y) + (v.z + v.w);
    }
    mean = warp_sum(s) / K;
    float q = 0.f;
#pragma unroll 4
    for (int c = lane; c < K4; c += 32) {
      const float4 v = get(c);
      const float dx = v.x - mean, dy = v.y - mean;
      const float dz = v.z - mean, dw = v.w - mean;
      q += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
    rs = 1.f / sqrtf(warp_sum(q) / K + kLnEps);
  }
  return make_float2(mean, rs);
}

// row_stats of a row held in registers: v[j] the lane's chunk lane + 32 j
// (K <= 32 N * 4; zeros past the row), the same sums in the same order.
template <int N>
__device__ __forceinline__ float2 reg_stats(const float4 (&v)[N], int K,
                                            int rms, int lane) {
  return row_stats(
      [&](int c) {
        float4 r = v[0];
#pragma unroll
        for (int j = 1; j < N; ++j)
          if (c == lane + 32 * j) r = v[j];
        return r;
      },
      K, rms, lane);
}

// The norm weight and shift at k .. k + 3 (read-only, cached).
struct NormW4 {
  float4 g, b;
};

template <typename T>
__device__ __forceinline__ NormW4 norm_w4(const RowsIn& in, int k) {
  NormW4 w;
  w.g = from_bits<T>(load_bits_ro<T>((const T*)in.ln_g + k));
  w.b = in.rms ? make_float4(0.f, 0.f, 0.f, 0.f)
               : from_bits<T>(load_bits_ro<T>((const T*)in.ln_b + k));
  return w;
}

// The folded norm of four values with statistics st and weights w.
__device__ __forceinline__ float4 norm4(float4 v, float2 st, const NormW4& w) {
  const float4 g = w.g, bb = w.b;
  return make_float4((v.x - st.x) * st.y * g.x + bb.x,
                     (v.y - st.x) * st.y * g.y + bb.y,
                     (v.z - st.x) * st.y * g.z + bb.z,
                     (v.w - st.x) * st.y * g.w + bb.w);
}

// Four consecutive T values from p as f32 (p 4-element aligned).
template <typename T> __device__ __forceinline__ float4 load4(const T* p) {
  return from_bits<T>(load_bits<T>(p));
}

// Stage rows b0 .. b0 + nt of the input in xs (nt x K floats), or the
// clips map[b0 .. b0 + nt) when a map is given (the FMA GEMV). Pass 1: every
// thread loads four-value chunks (K a multiple of 4), many in flight at
// once; without a norm it stores the f32 copy and the rows rounded to T
// (the matmul input) right away. Pass 2, with a norm: one warp per row
// normalises it in f32 (LayerNorm two-pass) from shared memory, stores the
// f32 copy and rounds.
template <typename T>
__device__ void stage_rows(const RowsIn& in, int slot, const int* map, int b0,
                           int nt, int K, float* xs, bool write_norm) {
  const int K4 = K / 4;
  const bool ln = in.ln_g != nullptr;
  float* norm = write_norm ? in.norm_out : nullptr;
#pragma unroll 8
  for (int idx = threadIdx.x; idx < nt * K4; idx += blockDim.x) {
    const int i = idx / K4, c = idx - i * K4;
    const int b = map != nullptr ? map[b0 + i] : b0 + i;
    float4 v;
    if (in.x == nullptr) {
      const float4 r =
          load4<T>((const T*)in.emb_root + (size_t)in.root[b] * K + 4 * c);
      const float4 t =
          load4<T>((const T*)in.emb_attr + (size_t)in.attr[b] * K + 4 * c);
      v = make_float4(r.x + t.x, r.y + t.y, r.z + t.z, r.w + t.w);
    } else {
      const size_t o = (size_t)slot * in.slot_stride + (size_t)b * K + 4 * c;
      v = in.x_is_t ? load4<T>((const T*)in.x + o)
                    : load4<float>((const float*)in.x + o);
    }
    if (!ln) {
      if (norm != nullptr)
        reinterpret_cast<float4*>(norm + (size_t)b * K)[c] = v;
      v = make_float4(round_t<T>(v.x), round_t<T>(v.y), round_t<T>(v.z),
                      round_t<T>(v.w));
    }
    reinterpret_cast<float4*>(xs + (size_t)i * K)[c] = v;
  }
  if (!ln) return;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < nt; i += kWarps) {
    const int b = map != nullptr ? map[b0 + i] : b0 + i;
    float4* row = reinterpret_cast<float4*>(xs + (size_t)i * K);
    const float2 st = row_stats([&](int c) { return row[c]; }, K, in.rms, lane);
    for (int c = lane; c < K4; c += 32) {
      const float4 y = norm4(row[c], st, norm_w4<T>(in, 4 * c));
      if (norm != nullptr)
        reinterpret_cast<float4*>(norm + (size_t)b * K)[c] = y;
      row[c] = make_float4(round_t<T>(y.x), round_t<T>(y.y), round_t<T>(y.z),
                           round_t<T>(y.w));
    }
  }
}

// ---------------------------------------------------------------------------
// the FMA GEMV
// ---------------------------------------------------------------------------

constexpr int kRegs = kRowChunk / 32;  // weight values a lane holds

// Weight values w[0:n] held in registers as f32: lane owns the 16-byte
// vectors j * 32 + lane (n a multiple of Vec<T>::N, n <= kRowChunk); zeros
// past n.
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ w, int n,
                                         int lane, float (&r)[kRegs]) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int j = 0; j < kRegs / V; ++j) {
    const int k = (j * 32 + lane) * V;
    if (k < n) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(w + k));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) r[j * V + i] = to_f<T>(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) r[j * V + i] = 0.f;
    }
  }
}

// acc0[i] (and acc1[i] when TWO) += this lane's share of dot(register row r0
// (r1), the n values of row i of xs (rows ld apart)) for the nt <= kTile
// staged f32 rows. Each staged value is read once for both rows; the rows'
// sums are independent, so their loads and FMAs overlap.
template <typename T, bool TWO>
__device__ __forceinline__ void dot_tile(const float (&r0)[kRegs],
                                         const float (&r1)[kRegs],
                                         const float* __restrict__ xs, int ld,
                                         int nt, int n, int lane,
                                         float (&acc0)[kTile],
                                         float (&acc1)[kTile]) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int j = 0; j < kRegs / V; ++j) {
    const int k = (j * 32 + lane) * V;
    if (k < n) {
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        if (i < nt) {
          const float* x = xs + (size_t)i * ld + k;
#pragma unroll
          for (int v = 0; v < V; v += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(x + v);
            const int q = j * V + v;
            acc0[i] = fmaf(r0[q], xv.x, acc0[i]);
            acc0[i] = fmaf(r0[q + 1], xv.y, acc0[i]);
            acc0[i] = fmaf(r0[q + 2], xv.z, acc0[i]);
            acc0[i] = fmaf(r0[q + 3], xv.w, acc0[i]);
            if (TWO) {
              acc1[i] = fmaf(r1[q], xv.x, acc1[i]);
              acc1[i] = fmaf(r1[q + 1], xv.y, acc1[i]);
              acc1[i] = fmaf(r1[q + 2], xv.z, acc1[i]);
              acc1[i] = fmaf(r1[q + 3], xv.w, acc1[i]);
            }
          }
        }
      }
    }
  }
}

// kRopeF: kRope whose K / V rows go to the f32 rows kv_f (int8 KV caches)
enum Epi : int { kPlain = 0, kRope = 1, kSwiglu = 2, kRopeF = 3 };
enum Act : int { kNone = 0, kRelu = 1, kSilu = 2 };

__device__ __forceinline__ float silu(float g) {
  return g * (1.f / (1.f + expf(-g)));
}

struct BGemv {
  RowsIn in;
  const void* w;        // slot 0: (n_rows, K) W, row-major; null: no slot 0
  const void* bias;     // slot 0: (n_rows) T
  const void* ew;       // slots >= 1: expert slot - 1 of (E, n_rows, K)
  const void* eb;       // (E, n_rows)
  const float* ws;      // int8 weights: slot 0's row scales (n_rows)
  const float* ews;     // and the experts' (E, n_rows)
  const int* counts;    // slot >= 1 computes only the counts[slot - 1]
  const int* lists;     // clips lists[(slot - 1) * B + i] routed to it
  int B, K, n_rows;
  int units;            // plain: output rows; rope: row pairs; swiglu: F
  int group;            // FMA: clips per blockIdx.z
  int chunk;            // FMA: input rows staged per pass
  int stages, panel;    // tensor cores: weight chunks in flight per warp,
                        // input columns staged per pass
  // plain: y = act(dot [+ key[b] * krow] + bias) [+ residual]; out is
  // (slot, B, units)
  int act;              // Act
  const float* key;
  const void* krow;
  const float* residual;
  const void* residual_t;  // T residual (instead of the f32 one)
  float* out_f;         // f32 out (rounded to T when round_out) ...
  void* out_t;          // ... or T out
  int round_out;
  // rope (row pairs): rows < rope_rows rotate at pos; rows [0, q_rows) ->
  // out_f (B, q_rows), rounded to T unless q_f32; rows [q_rows, q_rows +
  // k_rows) -> k_cache (B, S, k_rows) and the rest -> v_cache (B, S, D),
  // both at (b, pos); kRopeF: the K | V rows to kv_f (B, k_rows + D) in f32
  const float* cos;
  const float* sin;
  int pos, hd, rope_rows, q_rows, k_rows, q_f32, D, S;
  void* k_cache;
  void* v_cache;
  float* kv_f;
  // swiglu (row pairs j, F + j): out_f[slot, b, j] = h * silu(g)
  int F;
};

template <typename T, bool F32KV>
__device__ __forceinline__ void rope_store(const BGemv& a, int b, int r,
                                           float y) {
  if (r < a.q_rows) {
    a.out_f[(size_t)b * a.q_rows + r] = a.q_f32 ? y : round_t<T>(y);
    return;
  }
  if constexpr (F32KV) {
    a.kv_f[(size_t)b * (a.k_rows + a.D) + (r - a.q_rows)] = y;
  } else if (r < a.q_rows + a.k_rows) {
    ((T*)a.k_cache)[((size_t)b * a.S + a.pos) * a.k_rows + (r - a.q_rows)] =
        from_f<T>(y);
  } else {
    ((T*)a.v_cache)[((size_t)b * a.S + a.pos) * a.D +
                    (r - a.q_rows - a.k_rows)] = from_f<T>(y);
  }
}

// The residual at output index o (f32 or T), 0 without one.
template <typename T>
__device__ __forceinline__ float residual_at(const BGemv& a, size_t o) {
  if (a.residual != nullptr) return a.residual[o];
  if (a.residual_t != nullptr) return to_f<T>(((const T*)a.residual_t)[o]);
  return 0.f;
}

// The plain epilogue of output (b, r); res: residual_at of its index.
template <typename T>
__device__ __forceinline__ void plain_store(const BGemv& a, size_t out_slot,
                                            int b, int r, float y, float bias,
                                            float kr, float res) {
  if (a.key != nullptr) y += a.key[b] * kr;
  y += bias;
  if (a.act == kRelu) y = fmaxf(y, 0.f);
  if (a.act == kSilu) y = silu(y);
  const size_t o = out_slot + (size_t)b * a.units + r;
  if (a.residual != nullptr || a.residual_t != nullptr) y = res + y;
  if (a.out_t != nullptr) {
    ((T*)a.out_t)[o] = from_f<T>(y);
  } else {
    a.out_f[o] = a.round_out ? round_t<T>(y) : y;
  }
}

// grid (ceil(units / kWarps), slots, ceil(B / group)): a warp holds the
// weight rows of one unit of one slot in registers (plain: row u; rope: the
// rotated pair 2u, 2u + 1; swiglu: rows u and F + u) and computes them for
// the clips of its group, reading each staged input value once for both
// rows of a pair. WIDE (K > kRowChunk): the rows are walked kRowChunk
// values at a time, each lane's sums carried across; its own instance, so
// the registers of the K <= kRowChunk one stay those of a single chunk. W:
// the weights' type, T or int8_t (then each row's f32 sum is multiplied by
// its scale before the bias, as the Pallas _dot does). Slot 0's weights
// are fetched before the dependency wait; an expert slot's once its router
// has listed clips.
template <typename T, int EPI, typename W, bool WIDE>
static __global__ void __launch_bounds__(kThreads) bgemv_kernel(BGemv a) {
  constexpr bool kTwo = EPI != kPlain;
  constexpr bool kRopeAny = EPI == kRope || EPI == kRopeF;
  constexpr bool kQ = std::is_same<W, int8_t>::value;
  extern __shared__ __align__(16) float xs[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = blockIdx.y;
  if (slot == 0 && a.w == nullptr) return;  // a MoE without a shared expert
  const int K = a.K, K0 = WIDE ? kRowChunk : K;  // K0: the first chunk
  const int unit = blockIdx.x * kWarps + warp;
  const bool active = unit < a.units;
  const W* w = (const W*)a.w;
  const T* bias = (const T*)a.bias;
  const float* ws = a.ws;
  if (slot > 0) {
    w = (const W*)a.ew + (size_t)(slot - 1) * a.n_rows * K;
    bias = (const T*)a.eb + (size_t)(slot - 1) * a.n_rows;
    if constexpr (kQ) ws = a.ews + (size_t)(slot - 1) * a.n_rows;
  }
  const int r0 = kRopeAny ? 2 * unit : unit;
  const int r1 = kRopeAny ? r0 + 1 : a.F + unit;
  const W* w0p = w + (size_t)r0 * K;
  const W* w1p = w + (size_t)r1 * K;
  float w0[kRegs], w1[kRegs];
  float b0 = 0.f, b1 = 0.f, kr = 0.f, rc = 1.f, rs = 0.f;
  float s0 = 1.f, s1 = 1.f;  // int8 rows' scales
  auto fetch = [&]() {
    if (!active) return;
    load_row<W>(w0p, K0, lane, w0);
    b0 = to_f<T>(bias[r0]);
    if constexpr (kQ) s0 = ws[r0];
    if (kTwo) {
      load_row<W>(w1p, K0, lane, w1);
      b1 = to_f<T>(bias[r1]);
      if constexpr (kQ) s1 = ws[r1];
    }
    if (EPI == kPlain && a.key != nullptr) kr = to_f<T>(((const T*)a.krow)[r0]);
    if (kRopeAny && r0 < a.rope_rows) {
      const size_t f = (size_t)a.pos * (a.hd / 2) + ((r0 % a.hd) >> 1);
      rc = a.cos[f];
      rs = a.sin[f];
    }
  };
  const bool listed = slot > 0 && a.lists != nullptr;
  if (!listed) fetch();
  pdl_wait();
  const int* map = nullptr;  // expert slots walk the clips routed to them
  int n = a.B;
  if (listed) {
    map = a.lists + (size_t)(slot - 1) * a.B;
    n = a.counts[slot - 1];
  }
  const int begin = blockIdx.z * a.group;
  if (begin >= n) return;  // no clips of this group (the whole block)
  if (listed) fetch();
  const int end = min(n, begin + a.group);
  const size_t out_slot = (size_t)slot * a.B * a.units;
  for (int c0 = begin; c0 < end; c0 += a.chunk) {
    const int nc = min(a.chunk, end - c0);
    __syncthreads();  // the previous chunk is consumed
    stage_rows<T>(a.in, slot, map, c0, nc, K, xs,
                  blockIdx.x == 0 && blockIdx.y == 0);
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < nc; t += kTile) {
      const int nt = min(kTile, nc - t);
      const float* xt = xs + (size_t)t * K;
      float acc0[kTile], acc1[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) acc0[i] = acc1[i] = 0.f;
      dot_tile<W, kTwo>(w0, w1, xt, K, nt, K0, lane, acc0, acc1);
      if constexpr (WIDE) {  // the rest of the rows, then chunk 0 again
        for (int k0 = kRowChunk; k0 < K; k0 += kRowChunk) {
          const int nk = min(kRowChunk, K - k0);
          load_row<W>(w0p + k0, nk, lane, w0);
          if (kTwo) load_row<W>(w1p + k0, nk, lane, w1);
          dot_tile<W, kTwo>(w0, w1, xt + k0, K, nt, nk, lane, acc0, acc1);
        }
        load_row<W>(w0p, K0, lane, w0);
        if (kTwo) load_row<W>(w1p, K0, lane, w1);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          acc0[i] += __shfl_xor_sync(0xffffffffu, acc0[i], o);
          if (kTwo) acc1[i] += __shfl_xor_sync(0xffffffffu, acc1[i], o);
        }
      }
      // every lane holds every sum: lane i finishes row t + i, so the
      // epilogues' loads and stores run side by side
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        if (lane == i) {
          y0 = acc0[i];
          if (kTwo) y1 = acc1[i];
        }
      }
      if constexpr (kQ) {  // dequantize the dot, then the bias
        y0 *= s0;
        y1 *= s1;
      }
      if (lane < nt) {
        const int r = c0 + t + lane;
        const int b = map != nullptr ? map[r] : r;
        if (EPI == kPlain) {
          plain_store<T>(a, out_slot, b, r0, y0, b0, kr,
                         residual_at<T>(a, out_slot + (size_t)b * a.units + r0));
        } else if (kRopeAny) {
          y0 += b0;
          y1 += b1;
          const float t0r = y0 * rc - y1 * rs;  // rc = 1, rs = 0: no rotation
          const float t1r = y1 * rc + y0 * rs;
          rope_store<T, EPI == kRopeF>(a, b, r0, t0r);
          rope_store<T, EPI == kRopeF>(a, b, r1, t1r);
        } else {  // kSwiglu: y0 = h, y1 = g
          y0 += b0;
          y1 += b1;
          a.out_f[out_slot + (size_t)b * a.units + unit] = y0 * silu(y1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the tensor-core GEMV: bf16, B >= 2, one weight (slot 0, no lists)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 8;                  // the block's warps split K
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcKC = 64;                    // k of a weight chunk: 4 k-steps
constexpr int kTcStride = kTcKC + 8;         // bf16 a padded chunk row
constexpr int kTcChunk = 16 * kTcStride;     // one A tile's chunk, bf16
constexpr int kTcMaxStages = 4;              // chunks in flight per warp
// Clips a block. The blocks of the other clip groups read the weights
// from L2: staging the clips' rows, not the weight bytes, sets the time;
// of 64, 32 and 16 clips a block, 16 ran the GEMV alone fastest at B=64
// on an H100 (chip_smoke.py "gemv yardstick"; PERF.md).
constexpr int kTcClips = 16;
constexpr int kTcNT = kTcClips / 8;          // its n-tiles of 8 clips
constexpr int kStatRegs = 4;                 // row chunks a lane holds (K 512)

template <int N>
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if constexpr (N > 0) {
    if (n >= N) {
      mma::cp_async_wait<N>();
      return;
    }
    cp_async_wait_upto<N - 1>(n);
  } else {
    mma::cp_async_wait<0>();
  }
}

// grid (ceil(rows / 16), ceil(B / kTcClips), slots): a block computes 16
// output rows (plain, rope: W rows t0 .. t0 + 15, a RoPE pair never split;
// swiglu: units j0 .. j0 + 15 from the two A tiles of rows j and F + j)
// for up to kTcClips clips. Warp w takes the 64-wide k chunks w, w + 8, ...: they stream
// into its ring of `stages` chunks by cp.async, the first ones before the
// dependency wait. The clips' rows, normalised and rounded to bf16, are
// staged `panel` columns at a time (zero rows up to a multiple of 16 clips,
// zero columns past K). Each k-step: ldmatrix of the A tile from the ring
// and of two n-tiles of clips from the staged rows, then mma into f32
// fragments. The warps' fragments are summed in shared memory in warp order
// and warp j finishes n-tile j: lane l holds rows l / 4 and l / 4 + 8,
// clips 2 (l % 4) + {0, 1}; a RoPE pair's rows sit on lanes 4 apart.
// blockIdx.z picks the slot (the weight, or a MoE's dense expert slots).
// Held to three blocks an SM (85 registers), as before the expert slots
// came in: left free ptxas takes 93-106 and the SM holds two.
template <int EPI>
static __global__ void __launch_bounds__(kTcThreads, 3) mgemv_kernel(BGemv a) {
  using T = bf16;
  constexpr int NA = EPI == kSwiglu ? 2 : 1;
  constexpr bool kRopeAny = EPI == kRope || EPI == kRopeF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = a.K, S = a.stages, KP = a.panel;
  const int Kp = ceil_div(K, kTcKC) * kTcKC, nch = Kp / kTcKC;
  const int c0 = blockIdx.y * kTcClips;
  const int nclip = min(kTcClips, a.B - c0);
  const int NT = ceil_div(nclip, 16) * 2;     // n-tiles of 8 clips, even
  const int t0 = blockIdx.x * 16;
  const int n_valid = kRopeAny ? 2 * a.units : a.units;
  const int slot = blockIdx.z;  // 0: the weight (a MoE's shared expert)
  if (slot == 0 && a.w == nullptr) return;  // a MoE without a shared expert
  const T* W = (const T*)a.w;
  const T* bias = (const T*)a.bias;
  if (slot > 0) {  // expert slot - 1, for every clip
    W = (const T*)a.ew + (size_t)(slot - 1) * a.n_rows * K;
    bias = (const T*)a.eb + (size_t)(slot - 1) * a.n_rows;
  }
  const size_t out_slot = (size_t)slot * a.B * a.units;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* mine = ring + (size_t)warp * S * NA * kTcChunk;
  bf16* xsm = ring + (size_t)kTcWarps * S * NA * kTcChunk;
  const int xld = KP + 8;
  float2* stats = reinterpret_cast<float2*>(xsm + (size_t)NT * 8 * xld);

  // weight chunk ch of this warp into ring stage `stage` (one commit group
  // each, empty past the end)
  auto fetch = [&](int stage, int ch) {
    if (ch < nch) {
#pragma unroll
      for (int i = lane; i < NA * 16 * (kTcKC / 8); i += 32) {
        const int at = i / (16 * (kTcKC / 8));
        const int r = (i / (kTcKC / 8)) % 16, c = (i % (kTcKC / 8)) * 8;
        const int row = t0 + r, k = ch * kTcKC + c;
        const bool ok = row < n_valid && k < K;
        const size_t src = (size_t)(at == 0 ? row : a.F + row) * K + k;
        mma::cp_async16(mine + (stage * NA + at) * kTcChunk + r * kTcStride + c,
                        W + (ok ? src : 0), ok);
      }
    }
    mma::cp_async_commit();
  };
  // this lane's epilogue rows t0 + l / 4 + 8h: biases, key row, RoPE angle
  float bv[NA][2], kr[2], rc[2], rsn[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = t0 + (lane >> 2) + 8 * h;
    const bool ok = r < n_valid;
    bv[0][h] = ok ? to_f<T>(bias[r]) : 0.f;
    if (NA == 2) bv[NA - 1][h] = ok ? to_f<T>(bias[a.F + r]) : 0.f;
    kr[h] = (EPI == kPlain && a.key != nullptr && ok)
                ? to_f<T>(((const T*)a.krow)[r]) : 0.f;
    rc[h] = 1.f;
    rsn[h] = 0.f;
    if (kRopeAny && ok && r < a.rope_rows) {
      const size_t f = (size_t)a.pos * (a.hd / 2) + ((r % a.hd) >> 1);
      rc[h] = a.cos[f];
      rsn[h] = a.sin[f];
    }
  }
  for (int i = 0; i < S; ++i) fetch(i, warp + kTcWarps * i);
  pdl_wait();

  const RowsIn& in = a.in;
  const bool ln = in.ln_g != nullptr;
  if (ln && K <= 32 * 4 * kStatRegs) {
    // the folded norm's statistics, a warp per clip, two clips' rows in
    // registers at a time (their loads in flight together)
    const int K4 = K / 4;
    by_kind(in, [&](auto kind) {
      constexpr int KIND = decltype(kind)::value;
      for (int i = warp; i < nclip; i += 2 * kTcWarps) {
        const int i2 = i + kTcWarps;
        Raw4 ra[kStatRegs], rb[kStatRegs];  // the loads, then the values
#pragma unroll
        for (int j = 0; j < kStatRegs; ++j) {
          const int c = min(lane + 32 * j, K4 - 1);
          ra[j] = load_raw4<T, KIND>(in, slot, c0 + i, K, 4 * c);
          rb[j] = load_raw4<T, KIND>(in, slot, c0 + min(i2, nclip - 1), K,
                                     4 * c);
        }
        float4 va[kStatRegs], vb[kStatRegs];
#pragma unroll
        for (int j = 0; j < kStatRegs; ++j) {
          const bool in_row = lane + 32 * j < K4;
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          va[j] = in_row ? cook4<T, KIND>(ra[j]) : zero;
          vb[j] = in_row ? cook4<T, KIND>(rb[j]) : zero;
        }
        stats[i] = reg_stats(va, K, in.rms, lane);
        if (i2 < nclip) stats[i2] = reg_stats(vb, K, in.rms, lane);
      }
    });
  } else if (ln) {  // wider rows: from device memory, pass by pass
    for (int i = warp; i < nclip; i += kTcWarps) {
      const int b = c0 + i;
      stats[i] = row_stats(
          [&](int c) { return input4<T>(in, slot, b, K, 4 * c); }, K, in.rms,
          lane);
    }
  }
  float* norm = blockIdx.x == 0 && slot == 0 ? in.norm_out : nullptr;
  float acc[NA][kTcNT][4];
#pragma unroll
  for (int at = 0; at < NA; ++at)
#pragma unroll
    for (int j = 0; j < kTcNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[at][j][e] = 0.f;
  int it = 0;  // this warp's chunks consumed
  for (int p0 = 0; p0 < Kp; p0 += KP) {
    const int pw = min(KP, Kp - p0), pw4 = pw / 4;
    __syncthreads();  // statistics written; the previous panel consumed
    const int total = NT * 8 * pw4;
    by_kind(in, [&](auto kind) {
      constexpr int KIND = decltype(kind)::value;
      for (int base = threadIdx.x; base < total;
           base += kStageUnroll * kTcThreads) {
        Raw4 raw[kStageUnroll];  // the loads, then the values
#pragma unroll
        for (int u = 0; u < kStageUnroll; ++u) {
          const int idx = min(base + u * kTcThreads, total - 1);
          const int i = idx / pw4, k = p0 + 4 * (idx - i * pw4);
          raw[u] = load_raw4<T, KIND>(in, slot, c0 + min(i, nclip - 1), K,
                                      min(k, K - 4));
        }
#pragma unroll
        for (int u = 0; u < kStageUnroll; ++u) {
          const int idx = base + u * kTcThreads;
          if (idx >= total) break;
          const int i = idx / pw4, k = p0 + 4 * (idx - i * pw4);
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < nclip && k < K) {
            v = cook4<T, KIND>(raw[u]);
            if (ln) v = norm4(v, stats[i], norm_w4<T>(in, k));
            if (norm != nullptr)
              *reinterpret_cast<float4*>(norm + (size_t)(c0 + i) * K + k) = v;
          }
          uint2 packed;
          packed.x = mma::pack_bf16(v.x, v.y);
          packed.y = mma::pack_bf16(v.z, v.w);
          *reinterpret_cast<uint2*>(xsm + (size_t)i * xld + (k - p0)) = packed;
        }
      }
    });
    __syncthreads();
    for (;; ++it) {
      const int ch = warp + kTcWarps * it;
      if (ch >= nch || ch * kTcKC >= p0 + pw) break;
      cp_async_wait_upto<kTcMaxStages - 1>(S - 1);
      __syncwarp();
      const bf16* wst = mine + (it % S) * NA * kTcChunk;
      const bf16* xk = xsm + (ch * kTcKC - p0);
#pragma unroll
      for (int kk = 0; kk < kTcKC / 16; ++kk) {
        uint32_t af[NA][4];
#pragma unroll
        for (int at = 0; at < NA; ++at)
          mma::ldmatrix_x4(af[at], wst + at * kTcChunk +
                                       (lane & 15) * kTcStride + kk * 16 +
                                       (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < kTcNT / 2; ++jp) {
          if (2 * jp < NT) {
            uint32_t b[4];
            mma::ldmatrix_x4(
                b, xk + (size_t)(jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * xld +
                       kk * 16 + (((lane >> 3) & 1) << 3));
#pragma unroll
            for (int at = 0; at < NA; ++at) {
              mma::mma_bf16(acc[at][2 * jp], af[at], b[0], b[1]);
              mma::mma_bf16(acc[at][2 * jp + 1], af[at], b[2], b[3]);
            }
          }
        }
      }
      __syncwarp();
      fetch(it % S, ch + kTcWarps * S);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring and the panel
  float4* red = reinterpret_cast<float4*>(smem_raw);  // (warps, NA, kTcNT, 32)
#pragma unroll
  for (int at = 0; at < NA; ++at)
#pragma unroll
    for (int j = 0; j < kTcNT; ++j)
      if (j < NT)
        red[((warp * NA + at) * kTcNT + j) * 32 + lane] =
            make_float4(acc[at][j][0], acc[at][j][1], acc[at][j][2],
                        acc[at][j][3]);
  __syncthreads();
  const int j = warp;  // n-tile j: clips c0 + 8j ..
  if (j >= NT) return;
  float v[NA][4];
#pragma unroll
  for (int at = 0; at < NA; ++at) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[at][e] = 0.f;
    for (int w = 0; w < kTcWarps; ++w) {
      const float4 t = red[((w * NA + at) * kTcNT + j) * 32 + lane];
      v[at][0] += t.x;
      v[at][1] += t.y;
      v[at][2] += t.z;
      v[at][3] += t.w;
    }
  }
  float res[4];  // the residuals, their loads together
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = t0 + (lane >> 2) + 8 * (e >> 1);
    const int cl = 8 * j + 2 * (lane & 3) + (e & 1);
    res[e] = EPI == kPlain && r < n_valid && cl < nclip
                 ? residual_at<T>(a, out_slot + (size_t)(c0 + cl) * a.units + r)
                 : 0.f;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int h = e >> 1;
    const int r = t0 + (lane >> 2) + 8 * h;
    const int cl = 8 * j + 2 * (lane & 3) + (e & 1);
    const bool ok = r < n_valid && cl < nclip;
    const int b = c0 + cl;
    if constexpr (kRopeAny) {
      const float y = v[0][e] + bv[0][h];
      const float partner = __shfl_xor_sync(0xffffffffu, y, 4);
      const float t = ((lane >> 2) & 1) == 0 ? y * rc[h] - partner * rsn[h]
                                             : y * rc[h] + partner * rsn[h];
      if (ok) rope_store<T, EPI == kRopeF>(a, b, r, t);
    } else if constexpr (EPI == kSwiglu) {
      if (ok)
        a.out_f[out_slot + (size_t)b * a.units + r] =
            (v[0][e] + bv[0][h]) * silu(v[NA - 1][e] + bv[NA - 1][h]);
    } else {
      if (ok)
        plain_store<T>(a, out_slot, b, r, v[0][e], bv[0][h], kr[h], res[e]);
    }
  }
}

template <int EPI>
static int gemv_tc(BGemv g, int slots, cudaStream_t st) {
  constexpr int NA = EPI == kSwiglu ? 2 : 1;
  static bool opted_in = false;  // per instantiation
  int err;
  if ((err = allow_smem(mgemv_kernel<EPI>, opted_in))) return err;
  const int Kp = ceil_div(g.K, kTcKC) * kTcKC;
  g.stages = min(kTcMaxStages, ceil_div(Kp / kTcKC, kTcWarps));
  const int rows_pad = ceil_div(min(g.B, kTcClips), 16) * 16;
  const size_t ring = (size_t)kTcWarps * g.stages * NA * kTcChunk * 2;
  const size_t stats = kTcClips * sizeof(float2);
  // the widest panel of input columns (a multiple of kTcKC) that fits
  const long room = (long)(kSmemMax - ring - stats) / (rows_pad * 2) - 8;
  g.panel = min(Kp, (int)(room / kTcKC) * kTcKC);
  if (g.panel < kTcKC) return (int)cudaErrorInvalidValue;
  const size_t red = (size_t)kTcWarps * NA * kTcNT * 32 * sizeof(float4);
  const size_t smem =
      std::max(ring + (size_t)rows_pad * (g.panel + 8) * 2 + stats, red);
  const int rows = (EPI == kRope || EPI == kRopeF) ? 2 * g.units : g.units;
  return launch(mgemv_kernel<EPI>,
                dim3(ceil_div(rows, 16), ceil_div(g.B, kTcClips), slots),
                kTcThreads, smem, st, 0, g);
}

// Clips per FMA GEMV block (blockIdx.z picks the group). Each group's block
// loads the same weight rows: from device memory once, the other groups
// from L2. Per block, staging and the dot loop grow with the group, not B.
constexpr int kGroup = 16;
// Shared memory for the staged input rows of one FMA GEMV block: as many
// rows (a multiple of kTile, at most the group) as fit, at least one.
constexpr size_t kStageBytes = 64 * 1024;

template <typename T, int EPI, typename W, bool WIDE>
static int gemv_fma(BGemv g, int slots, cudaStream_t st) {
  static bool opted_in = false;  // per instantiation
  int err;
  if ((err = allow_smem(bgemv_kernel<T, EPI, W, WIDE>, opted_in))) return err;
  const size_t row = (size_t)g.K * sizeof(float);
  if (row > kSmemMax) return (int)cudaErrorInvalidValue;
  int fit = (int)(std::max(kStageBytes, row) / row);
  if (fit >= kTile) fit = fit / kTile * kTile;
  g.group = kGroup;
  g.chunk = min(fit, ceil_div(min(g.B, kGroup), kTile) * kTile);
  const dim3 grid(ceil_div(g.units, kWarps), slots, ceil_div(g.B, kGroup));
  return launch(bgemv_kernel<T, EPI, W, WIDE>, grid, kThreads,
                (size_t)g.chunk * row, st, 0, g);
}

// One GEMV launch: the tensor cores for bf16 at B >= 2 where every slot
// takes every clip (one weight, or a MoE's dense slots: no lists), the FMA
// kernel otherwise.
template <typename T, int EPI, typename W = T>
static int gemv(BGemv g, int slots, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value && std::is_same<W, bf16>::value) {
    if (g.B >= 2 && g.lists == nullptr) return gemv_tc<EPI>(g, slots, st);
  }
  if (g.K > kRowChunk) return gemv_fma<T, EPI, W, true>(g, slots, st);
  return gemv_fma<T, EPI, W, false>(g, slots, st);
}

// ---------------------------------------------------------------------------
// attention over cached rows, split over a thread-block cluster
// ---------------------------------------------------------------------------

enum NormKind : int { kNoNorm = 0, kLayerNorm = 1, kRmsNorm = 2 };
constexpr float kSublnEps = 1e-5f;  // differential attention's subln
constexpr int kMaxCluster = 8;      // blocks a (value head, clip) at most

struct Attn {
  const float* q;     // (B, nq * D) f32; rounded to T in batched mode
  const void* k;      // (B, stride_rows, nq * D) C
  const void* v;      // (B, stride_rows, D) C
  float* out;         // (B, D) f32
  const float* lam;   // differential: lambda (1,) and the subln row (D,)
  const float* subw;
  const float* er;    // RPR: (er_len, D) f32 head-tiled table, or null
  int rows, stride_rows, D, hd, diff, er_len, pos, cur, batched;
  float scale;
  // int8 caches (C = int8_t): the rows' f32 scales (B, stride_rows), and
  // row `cur` read from its dequantized K / V (f32, rounded to T) at
  // k_cur / v_cur + b * cur_stride instead of the cache
  const float* k_scale;
  const float* v_scale;
  const float* k_cur;
  const float* v_cur;
  int cur_stride;
  int per;            // rows a cluster block takes
};

// Block-wide max (MAX) or sum of two values at once; red holds 64 floats.
// Every thread gets both. Safe to call back to back (leading sync).
template <bool MAX>
__device__ __forceinline__ float2 block_reduce2(float x, float y, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  x = MAX ? warp_max(x) : warp_sum(x);
  y = MAX ? warp_max(y) : warp_sum(y);
  __syncthreads();
  if (lane == 0) {
    red[warp] = x;
    red[32 + warp] = y;
  }
  __syncthreads();
  if (warp == 0) {
    const float id = MAX ? -INFINITY : 0.f;
    float t = lane < nw ? red[lane] : id, u = lane < nw ? red[32 + lane] : id;
    t = MAX ? warp_max(t) : warp_sum(t);
    u = MAX ? warp_max(u) : warp_sum(u);
    if (lane == 0) {
      red[0] = t;
      red[32] = u;
    }
  }
  __syncthreads();
  return make_float2(red[0], red[32]);
}

// The raw load of a row piece of BYTES bytes: 16 (V = Vec<C>::N elements,
// the rule), or 8 (8 int8 values: int8 caches at a head size that is a
// multiple of 8 but not of 16, e.g. the product's d_model 512 at 64 heads).
template <int BYTES> struct RawVec;
template <> struct RawVec<16> { using type = uint4; };
template <> struct RawVec<8> { using type = uint2; };

// Sum over the 8 lanes of a row group (lanes 8g .. 8g + 7).
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// grid (H * cs, B), clusters of cs blocks along x: cluster block `rank` of
// (value head h, clip b) takes cache rows [rank * per, (rank + 1) * per) of
// [0, rows). Query/key heads h (vanilla, RPR) or 2h and 2h + 1
// (differential): logits (q . k [+ RPR bias]) * scale, with 8 lanes a row
// (16 bytes each, 4 rows a warp load); the maxima and then the sums of the
// cluster's blocks exchanged through distributed shared memory (f32 softmax
// per query head); in batched mode the probabilities are rounded to T
// except row `cur` (-1: none); each block's P.V over its rows, the value
// head read once for both query heads; the first block sums the partials in
// rank order and finishes. Vanilla / RPR: out = sum_s p_s v_s.
// Differential: c = pv_even - lambda * pv_odd, then out = c * rsqrt(mean(c^2)
// + 1e-5) * subw over the head. Needs hd % V == 0, hd <= kThreads and
// hd <= 8 kVL V, V the elements of a load (Vec<C>::N, or 8 for int8 rows
// at a head size that is no multiple of 16: RawVec).
// C = int8_t (vanilla, batched): a cached row's logit is (q . k) * scale *
// k_scale[s], its probability times v_scale[s] is rounded to T before P.V
// over the integer V; row `cur` uses k_cur / v_cur with no scale and an f32
// probability (the Pallas _wide_attention).
template <typename T, typename C, int kVL, int V = Vec<C>::N>
static __global__ void __launch_bounds__(kThreads)
attn_cluster_kernel(Attn a) {
  namespace cg = cooperative_groups;
  // kVL: the loads of V elements of a row a lane holds
  using Raw = typename RawVec<V * (int)sizeof(C)>::type;
  constexpr bool kQ = std::is_same<C, int8_t>::value;
  constexpr int kVR = 2;  // row iterations whose V vectors a lane keeps
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[64];
  __shared__ float stat[4];  // this block's max and sum per query head
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int nq = a.diff ? 2 : 1;
  const int hd = a.hd, D = a.D, kw = nq * D, nvec = hd / V;
  const int h = blockIdx.x / cs, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, sub = lane & 7;
  const int r0 = min(a.rows, rank * a.per), r1 = min(a.rows, r0 + a.per);
  const int n = r1 - r0;
  float* qs = sm;                       // (nq, hd)
  float* p = qs + nq * hd;              // (nq, per)
  float* part = p + nq * a.per;         // (kWarps, nq, hd)
  float* mine = part + kWarps * nq * hd;  // (nq, hd) this block's P.V
  const C* k = (const C*)a.k + (size_t)b * a.stride_rows * kw + h * nq * hd;
  const C* v = (const C*)a.v + (size_t)b * a.stride_rows * D + h * hd;
  for (int s = r0 + (tid >> 3); s < r1; s += kThreads / 8) {  // to L2
    for (int j = sub; j < nvec; j += 8) {
      prefetch_l2(k + (size_t)s * kw + j * V);
      if (nq == 2) prefetch_l2(k + (size_t)s * kw + hd + j * V);
      prefetch_l2(v + (size_t)s * D + j * V);
    }
  }
  const float lam = a.diff ? a.lam[0] : 0.f;  // constants, before the wait
  const float subw = a.diff && tid < hd ? a.subw[h * hd + tid] : 0.f;
  pdl_wait();
  const float* ksc = nullptr;
  const float* vsc = nullptr;
  if constexpr (kQ) {
    ksc = a.k_scale + (size_t)b * a.stride_rows;
    vsc = a.v_scale + (size_t)b * a.stride_rows;
  }
  for (int i = tid; i < nq * hd; i += blockDim.x)
    qs[i] = a.q[(size_t)b * kw + h * nq * hd + i];
  __syncthreads();
  // logits: row group g = 4 warp + lane / 8 takes rows r0 + g, r0 + g + 32
  // ..; its K vectors and, for its first kVR rows, its V vectors are loaded
  // together before any is used
  float lmax0 = -INFINITY, lmax1 = -INFINITY;
  Raw vkeep[kVR][kVL];
  int it = 0;
  for (int s0 = r0 + 4 * warp; s0 < r1; s0 += 4 * kWarps, ++it) {
    const int s = s0 + (lane >> 3);
    const bool ok = s < r1;
    const bool cached = ok && !(kQ && s == a.cur);
    const int sl = cached ? s : r0;  // a row to address
    Raw kraw[kVL], kraw1[kVL];
#pragma unroll
    for (int jv = 0; jv < kVL; ++jv) {
      const int j = sub + 8 * jv;
      if (j >= nvec) continue;
      const C* kr = k + (size_t)sl * kw + j * V;
      kraw[jv] = __ldg(reinterpret_cast<const Raw*>(kr));
      if (nq == 2) kraw1[jv] = __ldg(reinterpret_cast<const Raw*>(kr + hd));
#pragma unroll
      for (int r = 0; r < kVR; ++r)
        if (it == r)
          vkeep[r][jv] = __ldg(
              reinterpret_cast<const Raw*>(v + (size_t)sl * D + j * V));
    }
    float acc0 = 0.f, acc1 = 0.f;
    if (ok && !cached) {  // the current row: its dequantized K
      const float* kc = a.k_cur + (size_t)b * a.cur_stride + h * hd;
      for (int d = sub; d < hd; d += 8) acc0 = fmaf(qs[d], kc[d], acc0);
    } else if (ok) {
#pragma unroll
      for (int jv = 0; jv < kVL; ++jv) {
        const int j = sub + 8 * jv;
        if (j >= nvec) continue;
        const C* e = reinterpret_cast<const C*>(&kraw[jv]);
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc0 = fmaf(qs[j * V + i], to_f<C>(e[i]), acc0);
        if (nq == 2) {
          const C* e1 = reinterpret_cast<const C*>(&kraw1[jv]);
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc1 = fmaf(qs[hd + j * V + i], to_f<C>(e1[i]), acc1);
        }
      }
    }
    acc0 = group_sum(acc0);
    if (nq == 2) acc1 = group_sum(acc1);
    if (a.er != nullptr) {  // RPR: q . Er[er_len - 1 - (pos - s)]
      float bias = 0.f;
      if (ok) {
        const float* er =
            a.er + (size_t)(a.er_len - 1 - (a.pos - s)) * D + h * hd;
        for (int d = sub; d < hd; d += 8)
          bias = fmaf(qs[d], a.batched ? round_t<T>(er[d]) : er[d], bias);
      }
      bias = group_sum(bias);
      acc0 += (a.batched && s != a.cur) ? round_t<T>(bias) : bias;
    }
    if (ok) {
      acc0 *= a.scale;
      if constexpr (kQ) {
        if (s != a.cur) acc0 *= ksc[s];
      }
      lmax0 = fmaxf(lmax0, acc0);
      if (nq == 2) {
        acc1 *= a.scale;
        lmax1 = fmaxf(lmax1, acc1);
      }
      if (sub == 0) {
        p[s - r0] = acc0;
        if (nq == 2) p[a.per + s - r0] = acc1;
      }
    }
  }
  // the cluster's max, then its sum, through distributed shared memory
  const float2 bm = block_reduce2<true>(lmax0, lmax1, red);
  if (tid == 0) {
    stat[0] = bm.x;
    stat[1] = bm.y;
  }
  cluster.sync();
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {  // the loads issued together
    if (r < cs) {
      const float* st = cluster.map_shared_rank(stat, r);
      m0 = fmaxf(m0, st[0]);
      m1 = fmaxf(m1, st[1]);
    }
  }
  float ls0 = 0.f, ls1 = 0.f;
  for (int i = tid; i < n; i += blockDim.x) {
    const float e0 = expf(p[i] - m0);
    p[i] = e0;
    ls0 += e0;
    if (nq == 2) {
      const float e1 = expf(p[a.per + i] - m1);
      p[a.per + i] = e1;
      ls1 += e1;
    }
  }
  const float2 bs = block_reduce2<false>(ls0, ls1, red);  // orders p[]
  if (tid == 0) {
    stat[2] = bs.x;
    stat[3] = bs.y;
  }
  cluster.sync();
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {  // in rank order
    if (r < cs) {
      const float* st = cluster.map_shared_rank(stat, r);
      l0 += st[2];
      l1 += st[3];
    }
  }
  const float inv0 = 1.f / l0, inv1 = nq == 2 ? 1.f / l1 : 0.f;
  for (int i = tid; i < n; i += blockDim.x) {
    const int s = r0 + i;
    const bool rnd = a.batched && s != a.cur;
    float w0 = p[i] * inv0;
    if constexpr (kQ) {
      if (s != a.cur) w0 *= vsc[s];
    }
    p[i] = rnd ? round_t<T>(w0) : w0;
    if (nq == 2) {
      const float w1 = p[a.per + i] * inv1;
      p[a.per + i] = rnd ? round_t<T>(w1) : w1;
    }
  }
  __syncthreads();
  // P.V over this block's rows, in the logits' row groups
  float acc0[kVL][V], acc1[kVL][V];
#pragma unroll
  for (int jv = 0; jv < kVL; ++jv)
#pragma unroll
    for (int i = 0; i < V; ++i) acc0[jv][i] = acc1[jv][i] = 0.f;
  it = 0;
  for (int s0 = r0 + 4 * warp; s0 < r1; s0 += 4 * kWarps, ++it) {
    const int s = s0 + (lane >> 3);
    if (s >= r1) continue;
    const float p0 = p[s - r0];
    const float p1 = nq == 2 ? p[a.per + s - r0] : 0.f;
#pragma unroll
    for (int jv = 0; jv < kVL; ++jv) {
      const int j = sub + 8 * jv;
      if (j >= nvec) continue;
      if (kQ && s == a.cur) {  // the current row: its dequantized V
        const float* vc = a.v_cur + (size_t)b * a.cur_stride + h * hd + j * V;
#pragma unroll
        for (int i = 0; i < V; ++i) acc0[jv][i] = fmaf(p0, vc[i], acc0[jv][i]);
        continue;
      }
      Raw raw;
      if (it < kVR) {  // kept from the logits pass
#pragma unroll
        for (int r = 0; r < kVR; ++r)
          if (it == r) raw = vkeep[r][jv];
      } else {
        raw = __ldg(reinterpret_cast<const Raw*>(v + (size_t)s * D + j * V));
      }
      const C* e = reinterpret_cast<const C*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float ve = to_f<C>(e[i]);
        acc0[jv][i] = fmaf(p0, ve, acc0[jv][i]);
        if (nq == 2) acc1[jv][i] = fmaf(p1, ve, acc1[jv][i]);
      }
    }
  }
  // the warp's four row groups, then the block's warps in order
#pragma unroll
  for (int jv = 0; jv < kVL; ++jv) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      acc0[jv][i] += __shfl_xor_sync(0xffffffffu, acc0[jv][i], 8);
      acc0[jv][i] += __shfl_xor_sync(0xffffffffu, acc0[jv][i], 16);
      if (nq == 2) {
        acc1[jv][i] += __shfl_xor_sync(0xffffffffu, acc1[jv][i], 8);
        acc1[jv][i] += __shfl_xor_sync(0xffffffffu, acc1[jv][i], 16);
      }
    }
  }
  if (lane < 8) {
#pragma unroll
    for (int jv = 0; jv < kVL; ++jv) {
      const int j = sub + 8 * jv;
      if (j >= nvec) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        part[(warp * nq) * hd + j * V + i] = acc0[jv][i];
        if (nq == 2) part[(warp * nq + 1) * hd + j * V + i] = acc1[jv][i];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nq * hd; i += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += part[w * nq * hd + i];
    mine[i] = t;
  }
  cluster.sync();  // every block's partial is in place
  if (rank == 0) {
    float o = 0.f;
    if (tid < hd) {
      float t0 = 0.f, t1 = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {  // in rank order
        if (r < cs) {
          const float* pr = cluster.map_shared_rank(mine, r);
          t0 += pr[tid];
          if (nq == 2) t1 += pr[hd + tid];
        }
      }
      if (!a.diff) {
        o = a.batched ? round_t<T>(t0) : t0;
      } else {
        if (a.batched) {
          t0 = round_t<T>(t0);
          t1 = round_t<T>(t1);
        }
        o = t0 - lam * t1;
        if (a.batched) o = round_t<T>(o);
      }
    }
    if (a.diff) {  // subln: RMSNorm over the head, then the packed row
      const float ss = block_sum(tid < hd ? o * o : 0.f, red);
      if (tid < hd) o = o * (1.f / sqrtf(ss / hd + kSublnEps)) * subw;
    }
    if (tid < hd) a.out[(size_t)b * D + h * hd + tid] = o;
  }
  cluster.sync();  // no block leaves before the first has read its partial
}

// grid (H, B): one block per (value head h, clip b). Query/key heads h
// (vanilla, RPR) or 2h and 2h + 1 (differential) over cache rows
// [0, rows): logits (q . k [+ RPR bias]) * scale, f32 softmax per query
// head; in batched mode the probabilities are rounded to T except row
// `cur` (-1: none). P.V reads the value head once for both query heads.
// Vanilla / RPR: out = sum_s p_s v_s. Differential: c = pv_even - lambda *
// pv_odd, then out = c * rsqrt(mean(c^2) + 1e-5) * subw over the head.
// Logits: a thread owns a row; P.V: a thread owns V consecutive dims of a
// row group, the groups summed in shared memory. Needs hd % Vec<C>::N == 0
// and hd <= kThreads (V the elements of a load, as attn_cluster_kernel).
// C = int8_t (vanilla, batched): a cached row's logit
// is (q . k) * scale * k_scale[s], its probability times v_scale[s] is
// rounded to T before P.V over the integer V; row `cur` uses k_cur / v_cur
// with no scale and an f32 probability (the Pallas _wide_attention). Runs
// for vanilla and RPR heads where a cluster would have fewer than
// kMinCluster blocks (attention()).
template <typename T, typename C, int V = Vec<C>::N>
static __global__ void __launch_bounds__(kThreads) attn_kernel(Attn a) {
  using Raw = typename RawVec<V * (int)sizeof(C)>::type;
  constexpr bool kQ = std::is_same<C, int8_t>::value;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  const int nq = a.diff ? 2 : 1;
  const int hd = a.hd, D = a.D, kw = nq * D, rows = a.rows;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  float* qs = sm;                 // (nq, hd)
  float* p = qs + nq * hd;        // (nq, rows)
  float* part = p + nq * rows;    // (groups, nq, hd)
  const C* k = (const C*)a.k + (size_t)b * a.stride_rows * kw + h * nq * hd;
  const C* v = (const C*)a.v + (size_t)b * a.stride_rows * D + h * hd;
  const float* ksc = nullptr;
  const float* vsc = nullptr;
  if constexpr (kQ) {
    ksc = a.k_scale + (size_t)b * a.stride_rows;
    vsc = a.v_scale + (size_t)b * a.stride_rows;
  }
  pdl_wait();
  for (int i = tid; i < nq * hd; i += blockDim.x)
    qs[i] = a.q[(size_t)b * kw + h * nq * hd + i];
  __syncthreads();
  float lmax0 = -INFINITY, lmax1 = -INFINITY;
  for (int s = tid; s < rows; s += blockDim.x) {
    const C* kr = k + (size_t)s * kw;
    float acc0 = 0.f, acc1 = 0.f;
    if (kQ && s == a.cur) {  // the current row: its dequantized K
      const float* kc = a.k_cur + (size_t)b * a.cur_stride + h * hd;
      for (int d = 0; d < hd; ++d) acc0 = fmaf(qs[d], kc[d], acc0);
    } else {
      for (int d = 0; d < hd; d += V) {
        const Raw raw = __ldg(reinterpret_cast<const Raw*>(kr + d));
        const C* e = reinterpret_cast<const C*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc0 = fmaf(qs[d + i], to_f<C>(e[i]), acc0);
        if (nq == 2) {
          const Raw raw1 =
              __ldg(reinterpret_cast<const Raw*>(kr + hd + d));
          const C* e1 = reinterpret_cast<const C*>(&raw1);
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc1 = fmaf(qs[hd + d + i], to_f<C>(e1[i]), acc1);
        }
      }
    }
    if (a.er != nullptr) {  // RPR: q . Er[er_len - 1 - (pos - s)]
      const float* er =
          a.er + (size_t)(a.er_len - 1 - (a.pos - s)) * D + h * hd;
      float bias = 0.f;
      for (int d = 0; d < hd; ++d)
        bias = fmaf(qs[d], a.batched ? round_t<T>(er[d]) : er[d], bias);
      acc0 += (a.batched && s != a.cur) ? round_t<T>(bias) : bias;
    }
    acc0 *= a.scale;
    if constexpr (kQ) {
      if (s != a.cur) acc0 *= ksc[s];
    }
    p[s] = acc0;
    lmax0 = fmaxf(lmax0, acc0);
    if (nq == 2) {
      acc1 *= a.scale;
      p[rows + s] = acc1;
      lmax1 = fmaxf(lmax1, acc1);
    }
  }
  const float m0 = block_max(lmax0, red);
  const float m1 = nq == 2 ? block_max(lmax1, red) : 0.f;
  float ls0 = 0.f, ls1 = 0.f;
  for (int s = tid; s < rows; s += blockDim.x) {
    const float e0 = expf(p[s] - m0);
    p[s] = e0;
    ls0 += e0;
    if (nq == 2) {
      const float e1 = expf(p[rows + s] - m1);
      p[rows + s] = e1;
      ls1 += e1;
    }
  }
  const float inv0 = 1.f / block_sum(ls0, red);  // also orders p[] writes
  const float inv1 = nq == 2 ? 1.f / block_sum(ls1, red) : 0.f;
  for (int s = tid; s < rows; s += blockDim.x) {
    const bool rnd = a.batched && s != a.cur;
    float w0 = p[s] * inv0;
    if constexpr (kQ) {
      if (s != a.cur) w0 *= vsc[s];
    }
    p[s] = rnd ? round_t<T>(w0) : w0;
    if (nq == 2) {
      const float w1 = p[rows + s] * inv1;
      p[rows + s] = rnd ? round_t<T>(w1) : w1;
    }
  }
  __syncthreads();
  const int chunks = hd / V;
  const int groups = blockDim.x / chunks;
  const int g = tid / chunks, c = tid % chunks;
  float acc0[V], acc1[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc0[i] = acc1[i] = 0.f;
  if (g < groups) {
    for (int s = g; s < rows; s += groups) {
      if (kQ && s == a.cur) {  // the current row: its dequantized V
        const float* vc = a.v_cur + (size_t)b * a.cur_stride + h * hd + c * V;
        const float p0 = p[s];
#pragma unroll
        for (int i = 0; i < V; ++i) acc0[i] = fmaf(p0, vc[i], acc0[i]);
        continue;
      }
      const Raw raw =
          __ldg(reinterpret_cast<const Raw*>(v + (size_t)s * D + c * V));
      const C* e = reinterpret_cast<const C*>(&raw);
      const float p0 = p[s];
      const float p1 = nq == 2 ? p[rows + s] : 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float ve = to_f<C>(e[i]);
        acc0[i] = fmaf(p0, ve, acc0[i]);
        if (nq == 2) acc1[i] = fmaf(p1, ve, acc1[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      part[(g * nq) * hd + c * V + i] = acc0[i];
      if (nq == 2) part[(g * nq + 1) * hd + c * V + i] = acc1[i];
    }
  }
  __syncthreads();
  float o = 0.f;
  if (tid < hd) {
    float t0 = 0.f, t1 = 0.f;
    for (int j = 0; j < groups; ++j) {
      t0 += part[(j * nq) * hd + tid];
      if (nq == 2) t1 += part[(j * nq + 1) * hd + tid];
    }
    if (!a.diff) {
      o = a.batched ? round_t<T>(t0) : t0;
    } else {
      if (a.batched) {
        t0 = round_t<T>(t0);
        t1 = round_t<T>(t1);
      }
      o = t0 - a.lam[0] * t1;
      if (a.batched) o = round_t<T>(o);
    }
  }
  if (a.diff) {  // subln: RMSNorm over the head, then the packed row
    const float ss = block_sum(tid < hd ? o * o : 0.f, red);
    if (tid < hd)
      o = o * (1.f / sqrtf(ss / hd + kSublnEps)) * a.subw[h * hd + tid];
  }
  if (tid < hd) a.out[(size_t)b * D + h * hd + tid] = o;
}

// ---------------------------------------------------------------------------
// attention at any even head size
// ---------------------------------------------------------------------------

constexpr int kAnyRows = 4;    // attn_any_kernel: rows a lane group loads
constexpr int kAnyGroups = 8;  // at once; row groups from kThreads pairs

// attn_kernel's function at any even head size, for the heads the narrow
// instances do not take (narrow_head, common.cuh): grid (H * cs, B),
// clusters of cs blocks along x, every form (vanilla, RPR, differential,
// int8 rows, batched rounding). Cluster block `rank` of (value head h,
// clip b) takes rows [rank * per, (rank + 1) * per) of [0, rows), as
// attn_cluster_kernel does: its logits and local max, the cluster's max
// and then its sum through distributed shared memory (the sums added in
// rank order), its probabilities normalised (and rounded where the Pallas
// kernel rounds) and its partial P.V; the first block adds the partials in
// rank order and finishes (rounding, the differential combine, subln).
// Loads are value pairs (4 bytes of bf16, 8 of f32, 2 of int8), so any
// even head size lines up. Logits: pair_lanes(hd) lanes a row, kAnyRows
// rows a lane group at once (their loads issued before their products),
// the lanes' sums reduced by shuffles. A block's P.V: below kThreads pairs
// a head, a thread owns one pair of a row group (the block's rows g,
// g + groups, ...) and the groups are summed in group order, as in
// attn_kernel; from kThreads pairs up (head size 512 and above) a thread
// owns the pairs c, c + kThreads, ..., each over kAnyGroups row groups
// held in registers and summed in group order. The partial lives in q's
// shared memory. kRO: the caches are read through the read-only cache
// (the batched chains, as attn_kernel reads them), else through L2 only
// (the B=1 chain's self caches, whose row pos its QKV kernel wrote).
template <typename T, typename C, bool kRO>
static __global__ void __launch_bounds__(kThreads) attn_any_kernel(Attn a) {
  namespace cg = cooperative_groups;
  constexpr bool kQ = std::is_same<C, int8_t>::value;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[64];
  __shared__ float stat[4];  // this block's max and sum per query head
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int nq = a.diff ? 2 : 1;
  const int hd = a.hd, D = a.D, kw = nq * D, np = hd / 2, per = a.per;
  const int h = blockIdx.x / cs, b = blockIdx.y, tid = threadIdx.x;
  const int r0 = min(a.rows, rank * per), r1 = min(a.rows, r0 + per);
  const int n = r1 - r0;
  const int G = pair_lanes(hd), sub = tid % G;
  float* qs = sm;              // (nq, hd); then this block's P.V
  float* p = qs + nq * hd;     // (nq, per), row r0 + i at i
  float* part = p + nq * per;  // (groups, nq, hd); rank 0's combine
  const C* k = (const C*)a.k + (size_t)b * a.stride_rows * kw + h * nq * hd;
  const C* v = (const C*)a.v + (size_t)b * a.stride_rows * D + h * hd;
  const float* ksc = nullptr;
  const float* vsc = nullptr;
  if constexpr (kQ) {
    ksc = a.k_scale + (size_t)b * a.stride_rows;
    vsc = a.v_scale + (size_t)b * a.stride_rows;
  }
  pdl_wait();
  for (int i = tid; i < nq * hd; i += kThreads)
    qs[i] = a.q[(size_t)b * kw + h * nq * hd + i];
  __syncthreads();
  float lmax0 = -INFINITY, lmax1 = -INFINITY;
  // a lane group takes kAnyRows rows at once (rows s, s + step, ...), the
  // loads of all of them issued before their products
  const int step = kThreads / G;
  for (int s0 = r0 + tid / G; s0 - tid / G < r1; s0 += kAnyRows * step) {
    float acc0[kAnyRows], acc1[kAnyRows];
    const C* kr[kAnyRows];
    bool ok[kAnyRows], fresh[kAnyRows];
#pragma unroll
    for (int r = 0; r < kAnyRows; ++r) {
      const int s = s0 + r * step;
      ok[r] = s < r1;
      fresh[r] = kQ && s == a.cur;  // the current row: its dequantized K
      kr[r] = k + (size_t)(ok[r] && !fresh[r] ? s : 0) * kw;
      acc0[r] = acc1[r] = 0.f;
    }
    const float* kc = a.k_cur + (size_t)b * a.cur_stride + h * hd;
    for (int j = sub; j < np; j += G) {
      float2 e[kAnyRows], e1[kAnyRows];
#pragma unroll
      for (int r = 0; r < kAnyRows; ++r) {
        if (!ok[r]) continue;
        e[r] = fresh[r] ? make_float2(kc[2 * j], kc[2 * j + 1])
                        : load_pair<C, kRO>(kr[r] + 2 * j);
        if (nq == 2) e1[r] = load_pair<C, kRO>(kr[r] + hd + 2 * j);
      }
#pragma unroll
      for (int r = 0; r < kAnyRows; ++r) {
        if (!ok[r]) continue;
        acc0[r] = fmaf(qs[2 * j], e[r].x, acc0[r]);
        acc0[r] = fmaf(qs[2 * j + 1], e[r].y, acc0[r]);
        if (nq == 2) {
          acc1[r] = fmaf(qs[hd + 2 * j], e1[r].x, acc1[r]);
          acc1[r] = fmaf(qs[hd + 2 * j + 1], e1[r].y, acc1[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kAnyRows; ++r) {
      const int s = s0 + r * step;
      acc0[r] = lanes_sum(acc0[r], G);
      if (nq == 2) acc1[r] = lanes_sum(acc1[r], G);
      if (a.er != nullptr) {  // RPR: q . Er[er_len - 1 - (pos - s)]
        float bias = 0.f;
        if (ok[r]) {
          const float* er =
              a.er + (size_t)(a.er_len - 1 - (a.pos - s)) * D + h * hd;
          for (int d = sub; d < hd; d += G)
            bias = fmaf(qs[d], a.batched ? round_t<T>(er[d]) : er[d], bias);
        }
        bias = lanes_sum(bias, G);
        acc0[r] += (a.batched && s != a.cur) ? round_t<T>(bias) : bias;
      }
      if (!ok[r]) continue;
      acc0[r] *= a.scale;
      if constexpr (kQ) {
        if (s != a.cur) acc0[r] *= ksc[s];
      }
      lmax0 = fmaxf(lmax0, acc0[r]);
      if (nq == 2) {
        acc1[r] *= a.scale;
        lmax1 = fmaxf(lmax1, acc1[r]);
      }
      if (sub == 0) {
        p[s - r0] = acc0[r];
        if (nq == 2) p[per + s - r0] = acc1[r];
      }
    }
  }
  // the cluster's max, then its sum, through distributed shared memory
  const float2 bm = block_reduce2<true>(lmax0, lmax1, red);  // orders p[]
  if (tid == 0) {
    stat[0] = bm.x;
    stat[1] = bm.y;
  }
  cluster.sync();
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int r = 0; r < cs; ++r) {
    const float* st = cluster.map_shared_rank(stat, r);
    m0 = fmaxf(m0, st[0]);
    m1 = fmaxf(m1, st[1]);
  }
  float ls0 = 0.f, ls1 = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float e0 = expf(p[i] - m0);
    p[i] = e0;
    ls0 += e0;
    if (nq == 2) {
      const float e1 = expf(p[per + i] - m1);
      p[per + i] = e1;
      ls1 += e1;
    }
  }
  const float2 bs = block_reduce2<false>(ls0, ls1, red);  // orders p[]
  if (tid == 0) {
    stat[2] = bs.x;
    stat[3] = bs.y;
  }
  cluster.sync();
  float l0 = 0.f, l1 = 0.f;
  for (int r = 0; r < cs; ++r) {  // in rank order
    const float* st = cluster.map_shared_rank(stat, r);
    l0 += st[2];
    l1 += st[3];
  }
  const float inv0 = 1.f / l0, inv1 = nq == 2 ? 1.f / l1 : 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const int s = r0 + i;
    const bool rnd = a.batched && s != a.cur;
    float w0 = p[i] * inv0;
    if constexpr (kQ) {
      if (s != a.cur) w0 *= vsc[s];
    }
    p[i] = rnd ? round_t<T>(w0) : w0;
    if (nq == 2) {
      const float w1 = p[per + i] * inv1;
      p[per + i] = rnd ? round_t<T>(w1) : w1;
    }
  }
  __syncthreads();
  // row s's term of P.V for value pair c: (o0, o1) for query heads 0, 1
  auto pv_row = [&](int c, int s, float2& o0, float2& o1) {
    const float p0 = p[s - r0];
    float2 e;
    if (kQ && s == a.cur) {  // the current row: its dequantized V
      const float* vc = a.v_cur + (size_t)b * a.cur_stride + h * hd + 2 * c;
      e = make_float2(vc[0], vc[1]);
    } else {
      e = load_pair<C, kRO>(v + (size_t)s * D + 2 * c);
    }
    o0.x = fmaf(p0, e.x, o0.x);
    o0.y = fmaf(p0, e.y, o0.y);
    if (nq == 2) {
      const float p1 = p[per + s - r0];
      o1.x = fmaf(p1, e.x, o1.x);
      o1.y = fmaf(p1, e.y, o1.y);
    }
  };
  if (np < kThreads) {  // row groups, summed in group order
    const int groups = kThreads / np, g = tid / np, c = tid % np;
    if (g < groups) {
      float2 o0 = make_float2(0.f, 0.f), o1 = o0;
      for (int s = r0 + g; s < r1; s += groups) pv_row(c, s, o0, o1);
      float* dst = part + (size_t)(g * nq) * hd + 2 * c;
      dst[0] = o0.x;
      dst[1] = o0.y;
      if (nq == 2) {
        dst[hd] = o1.x;
        dst[hd + 1] = o1.y;
      }
    }
    __syncthreads();
    for (int i = tid; i < nq * hd; i += kThreads) {
      float t = 0.f;
      for (int j = 0; j < groups; ++j) t += part[(size_t)j * nq * hd + i];
      qs[i] = t;
    }
  } else {  // a thread owns pairs c, c + kThreads, ...: kAnyGroups row
            // groups in registers, summed in group order
    for (int c = tid; c < np; c += kThreads) {
      float2 o0[kAnyGroups], o1[kAnyGroups];
#pragma unroll
      for (int g = 0; g < kAnyGroups; ++g) {
        o0[g] = make_float2(0.f, 0.f);
        o1[g] = o0[g];
      }
      for (int s0 = r0; s0 < r1; s0 += kAnyGroups) {
#pragma unroll
        for (int g = 0; g < kAnyGroups; ++g)
          if (s0 + g < r1) pv_row(c, s0 + g, o0[g], o1[g]);
      }
      float2 t0 = o0[0], t1 = o1[0];
#pragma unroll
      for (int g = 1; g < kAnyGroups; ++g) {
        t0.x += o0[g].x;
        t0.y += o0[g].y;
        t1.x += o1[g].x;
        t1.y += o1[g].y;
      }
      qs[2 * c] = t0.x;
      qs[2 * c + 1] = t0.y;
      if (nq == 2) {
        qs[hd + 2 * c] = t1.x;
        qs[hd + 2 * c + 1] = t1.y;
      }
    }
  }
  cluster.sync();  // every block's partial is in place
  if (rank == 0) {
    float ss = 0.f;
    for (int i = tid; i < hd; i += kThreads) {
      float t0 = 0.f, t1 = 0.f;
      for (int r = 0; r < cs; ++r) {  // in rank order
        const float* pr = cluster.map_shared_rank(qs, r);
        t0 += pr[i];
        if (nq == 2) t1 += pr[hd + i];
      }
      if (!a.diff) {
        a.out[(size_t)b * D + h * hd + i] = a.batched ? round_t<T>(t0) : t0;
        continue;
      }
      if (a.batched) {
        t0 = round_t<T>(t0);
        t1 = round_t<T>(t1);
      }
      float o = t0 - a.lam[0] * t1;
      if (a.batched) o = round_t<T>(o);
      part[i] = o;  // free: every group sum has been read
      ss += o * o;
    }
    if (a.diff) {  // subln: RMSNorm over the head, then the packed row
      const float rs = 1.f / sqrtf(block_sum(ss, red) / hd + kSublnEps);
      for (int i = tid; i < hd; i += kThreads)
        a.out[(size_t)b * D + h * hd + i] = part[i] * rs * a.subw[h * hd + i];
    }
  }
  cluster.sync();  // no block leaves before the first has read its partial
}

// Cluster blocks per (value head, clip): doubled while the grid has fewer
// blocks than the card's 132 SMs and each block keeps at least 32 rows (at
// H=8: 8 at B=1 over 300 cross rows, 4 over 151 self rows; 2 at B=16; 1 at
// B=64). A vanilla or RPR head below kMinCluster runs the one-block kernel:
// at 1 and 2 blocks a pair the cluster kernel was the slower of the two for
// them on an H100, and the faster for a differential pair, whose rows are
// twice as wide (PERF.md).
constexpr int kMinCluster = 4;

static inline int attn_cluster(int rows, int pairs) {
  int cs = 1;
  while (cs < kMaxCluster && pairs * cs < 132 && rows >= 64 * cs) cs *= 2;
  return cs;
}

// Launches attn_any_kernel over H value heads and B clips, each head's
// rows split over a cluster of attn_cluster(rows, H B) blocks. Shared
// memory: q (then the block's partial), the block's probabilities and
// the row groups' partials (at least hd floats: rank 0's combine).
template <typename T, typename C, bool kRO>
static int attention_any(Attn t, int B, int H, cudaStream_t st) {
  if (t.hd < 2 || t.hd % 2) return (int)cudaErrorInvalidValue;
  const int nq = t.diff ? 2 : 1, np = t.hd / 2;
  const int groups = np < kThreads ? kThreads / np : 1;
  const int cs = attn_cluster(t.rows, H * B);
  t.per = ceil_div(t.rows, cs);
  const size_t smem =
      (size_t)(nq * t.hd + nq * t.per + groups * nq * t.hd) * sizeof(float);
  static bool opted_in = false;
  int err;
  if ((err = allow_smem(attn_any_kernel<T, C, kRO>, opted_in))) return err;
  return launch(attn_any_kernel<T, C, kRO>, dim3(H * cs, B), kThreads, smem,
                st, cs, t);
}

template <typename T, typename C, int kVL, int V>
static int attention_vl(Attn t, int B, int H, int cs, size_t smem,
                        cudaStream_t st) {
  static bool opted_in = false;
  int err;
  if ((err = allow_smem(attn_cluster_kernel<T, C, kVL, V>, opted_in)))
    return err;
  return launch(attn_cluster_kernel<T, C, kVL, V>, dim3(H * cs, B), kThreads,
                smem, st, cs, t);
}

// attention() with V elements a load.
template <typename T, typename C, int V>
static int attention_v(Attn t, int B, int H, cudaStream_t st) {
  if (t.hd % V || t.hd > kThreads) return (int)cudaErrorInvalidValue;
  const int nq = t.diff ? 2 : 1;
  const int cs = attn_cluster(t.rows, H * B);
  if (!t.diff && cs < kMinCluster) {  // one block per (value head, clip)
    static bool opted_in = false;
    int err;
    if ((err = allow_smem(attn_kernel<T, C, V>, opted_in))) return err;
    const int groups = kThreads / (t.hd / V);
    const size_t smem =
        (size_t)(nq * t.hd + nq * t.rows + groups * nq * t.hd) * sizeof(float);
    return launch(attn_kernel<T, C, V>, dim3(H, B), kThreads, smem, st, 0, t);
  }
  t.per = ceil_div(t.rows, cs);
  const size_t smem =
      (size_t)(nq * t.hd + nq * t.per + (kWarps + 1) * nq * t.hd) *
      sizeof(float);
  // a lane holds ceil(hd / V / 8) vectors of a row: one instance for heads
  // up to 64 wide, one up to 256
  constexpr int kSmall = 64 / V / 8 > 0 ? 64 / V / 8 : 1;
  if (ceil_div(t.hd / V, 8) <= kSmall)
    return attention_vl<T, C, kSmall, V>(t, B, H, cs, smem, st);
  return attention_vl<T, C, 32 / V, V>(t, B, H, cs, smem, st);
}

template <typename T, typename C = T>
static int attention(Attn t, int B, int H, cudaStream_t st) {
  // the int8 form: vanilla batched attention
  if (std::is_same<C, int8_t>::value &&
      (t.diff || t.er != nullptr || !t.batched))
    return (int)cudaErrorInvalidValue;
  // a head size no narrow instance takes: the one-block kernel of any even
  // head size
  if (!narrow_head(t.hd)) return attention_any<T, C, true>(t, B, H, st);
  if constexpr (std::is_same<C, int8_t>::value) {
    // int8 rows at a head size that is a multiple of 8 but not of 16:
    // 8-byte loads (instances of their own; 16-wide heads keep theirs)
    if (t.hd % Vec<C>::N && t.hd % 8 == 0)
      return attention_v<T, C, 8>(t, B, H, st);
  }
  return attention_v<T, C, Vec<C>::N>(t, B, H, st);
}

// ---------------------------------------------------------------------------
// router and the closing residual
// ---------------------------------------------------------------------------

// Per-clip router, one block per clip: E gate logits of the row xn[b] (T,
// or f32; rounded to T, the gate's matmul input; a warp per expert), top-k
// with the first index winning a tie (expert_rank: any E, any k_top <= E),
// softmax over the k selected raw logits. Writes sel / selw (k_top per
// clip) in selection order and, with `counts`, appends the clip to each
// selected expert's list (counts start at 0). Shared memory: the row (K
// floats), the logits (E) and the selection (k_top values, k_top ids).
template <typename T, typename X>
static __global__ void __launch_bounds__(kThreads)
router_kernel(const X* __restrict__ xn, const T* __restrict__ gate_w,
              const T* __restrict__ gate_b, int B, int K, int E, int k_top,
              int* __restrict__ sel, float* __restrict__ selw,
              int* __restrict__ counts, int* __restrict__ lists) {
  extern __shared__ __align__(16) float row[];
  float* logit = row + K;
  float* sv = logit + E;
  int* sid = reinterpret_cast<int*>(sv + k_top);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  pdl_wait();
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    row[k] = round_t<T>(to_f<X>(xn[(size_t)b * K + k]));
  __syncthreads();
  for (int e = warp; e < E; e += kWarps) {
    const float d =
        warp_sum(dot_partial<T>(gate_w + (size_t)e * K, row, K, lane));
    if (lane == 0) logit[e] = d + to_f<T>(gate_b[e]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int rank = expert_rank(logit, E, e);
    if (rank < k_top) {
      sid[rank] = e;
      sv[rank] = logit[e];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k_top; j += blockDim.x) {
    float den = 0.f;  // the same sum, in the same order, in every thread
    for (int i = 0; i < k_top; ++i) den += expf(sv[i] - sv[0]);
    const int e = sid[j];
    sel[(size_t)b * k_top + j] = e;
    selw[(size_t)b * k_top + j] = expf(sv[j] - sv[0]) / den;
    if (counts != nullptr)
      lists[(size_t)e * B + atomicAdd(counts + e, 1)] = b;
  }
}

template <typename T, typename X>
static int route(const X* xn, const T* gate_w, const T* gate_b, int B, int K,
                 int E, int k_top, int* sel, float* selw, int* counts,
                 int* lists, cudaStream_t st) {
  static bool opted_in = false;
  int err;
  if ((err = allow_smem(router_kernel<T, X>, opted_in))) return err;
  return launch(router_kernel<T, X>, dim3(B), kThreads,
                (size_t)(K + E + 2 * k_top) * sizeof(float), st, 0, xn,
                gate_w, gate_b, B, K, E, k_top, sel, selw, counts, lists);
}

// Per-clip closing step, one block per clip (the row in shared memory):
// v = x[b] (+ the MoE combine: the shared expert ye[0, b] / k when present,
// plus w_j * ye[e_j + 1, b] over the routed experts, in selection order or
// in expert order), then y = norm(v) (or v) -> T out, or f32 out (rounded to
// T when round_f).
struct Close {
  const void* x;        // (B, K): T when x_is_t, else f32
  int x_is_t;
  const float* ye;      // (E + 1, B, K) expert outputs, or null
  int shared, sel_order;
  const int* sel;       // (B, k_top) expert ids and their weights
  const float* selw;
  int k_top;
  const void* g;        // norm weight (T), and the LayerNorm shift
  const void* bn;
  int norm;             // NormKind
  float* out_f;
  int round_f;
  void* out_t;
  int B, K;
};

template <typename T>
static __global__ void __launch_bounds__(kThreads) close_kernel(Close a) {
  extern __shared__ __align__(16) float vrow[];  // K, then the selection
  __shared__ float red[32];
  const int k_top = a.ye != nullptr ? a.k_top : 0;
  float* sw = vrow + a.K;                            // k_top weights
  int* sid = reinterpret_cast<int*>(sw + k_top);     // their experts
  int* ord = sid + k_top;  // the selection in expert order
  const int b = blockIdx.x;
  pdl_wait();
  for (int j = threadIdx.x; j < k_top; j += blockDim.x) {
    sid[j] = a.sel[(size_t)b * k_top + j];
    sw[j] = a.selw[(size_t)b * k_top + j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k_top; j += blockDim.x) {
    int at = 0;
    for (int i = 0; i < k_top; ++i) at += sid[i] < sid[j];
    ord[at] = j;
  }
  __syncthreads();
  const size_t slot = (size_t)a.B * a.K;
  float s = 0.f, sq = 0.f;
  for (int k = threadIdx.x; k < a.K; k += kThreads) {
    const size_t o = (size_t)b * a.K + k;
    float x = a.x_is_t ? to_f<T>(((const T*)a.x)[o]) : ((const float*)a.x)[o];
    if (a.ye != nullptr) {
      float acc = a.shared ? a.ye[o] / (float)a.k_top : 0.f;
      for (int i = 0; i < k_top; ++i) {
        const int j = a.sel_order ? i : ord[i];
        acc += sw[j] * a.ye[(size_t)(sid[j] + 1) * slot + o];
      }
      x = x + acc;
    }
    vrow[k] = x;
    s += x;
    sq += x * x;
  }
  float mean = 0.f, rs = 1.f;
  if (a.norm == kLayerNorm) {
    mean = block_sum(s, red) / a.K;
    float q = 0.f;
    for (int k = threadIdx.x; k < a.K; k += kThreads) {
      const float d = vrow[k] - mean;
      q += d * d;
    }
    rs = 1.f / sqrtf(block_sum(q, red) / a.K + kLnEps);
  } else if (a.norm == kRmsNorm) {
    rs = 1.f / sqrtf(block_sum(sq, red) / a.K + kRmsEps);
  }
  const T* g = (const T*)a.g;
  const T* bb = (const T*)a.bn;
  for (int k = threadIdx.x; k < a.K; k += kThreads) {
    float y = vrow[k];
    if (a.norm == kLayerNorm) y = (y - mean) * rs * to_f<T>(g[k]) + to_f<T>(bb[k]);
    if (a.norm == kRmsNorm) y = y * rs * to_f<T>(g[k]);
    const size_t o = (size_t)b * a.K + k;
    if (a.out_t != nullptr) {
      ((T*)a.out_t)[o] = from_f<T>(y);
    } else {
      a.out_f[o] = a.round_f ? round_t<T>(y) : y;
    }
  }
}

template <typename T>
static int close_rows(const Close& c, cudaStream_t st) {
  static bool opted_in = false;
  int err;
  if ((err = allow_smem(close_kernel<T>, opted_in))) return err;
  const int k_top = c.ye != nullptr ? c.k_top : 0;
  return launch(close_kernel<T>, dim3(c.B), kThreads,
                (size_t)(c.K + 3 * k_top) * sizeof(float), st, 0, c);
}

}  // namespace batch
}  // namespace v2m
