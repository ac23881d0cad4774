// The blocks of the batched decode kernels (csrc/decode_batch.cu and
// csrc/decode_variant.cu), at B=1 as well as for B clips at one shared
// position.
//
// The GEMV, y[b] = W . x[b] (+ epilogue), each weight row read from device
// memory once per step: a warp holds one weight row (or a row pair) in
// registers and walks a group of 16 clips' input rows staged in shared
// memory (loaded by every thread with many loads in flight; a LayerNorm or
// RMSNorm of the rows folded into the staging), kTile rows at a time with
// independent sums, so their loads, FMAs and shuffles overlap; lane i then
// finishes row i. blockIdx.y picks a slot: slot 0 is the plain weight (or
// a MoE's shared expert), slot e + 1 expert e, which stages and computes
// only the clips its router listed.
//
// Attention over cached rows (one block per value head and clip; vanilla,
// RPR or differential), the MoE router and the per-clip closing residual +
// norm follow the GEMV.
//
// int8 forms, each its own template instance beside the T one: the GEMV
// with int8 weight rows (W = int8_t: 16 weights a load, the f32 sum times
// the row's scale before the bias), and attention over int8 cache rows
// (C = int8_t: one f32 scale per row, folded into the logit and the
// probability; the current row from its dequantized copy).
//
// Plain FMA and warp shuffles, no tensor cores. The kernels are static:
// each source that includes this header builds its own instances.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace v2m {
namespace batch {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 8;       // staged rows a warp sums side by side
constexpr int kMaxK = 1024;    // longest row a warp holds in registers
constexpr int kRegs = kMaxK / 32;
constexpr float kLnEps = 1e-5f;   // LayerNorm
constexpr float kRmsEps = 1e-6f;  // RMSNorm
constexpr int kMaxTop = 8;

// The B input rows of a batched GEMV.
struct RowsIn {
  const void* x;        // (slots, B, K): T when x_is_t, else f32;
                        // null = embedding gather
  int x_is_t;
  size_t slot_stride;   // elements between slots' rows (0 = one input)
  const void* ln_g;     // norm (T) to apply to each row, or null
  const void* ln_b;     // LayerNorm shift (unused by RMSNorm)
  int rms;              // 0: LayerNorm (eps 1e-5), 1: RMSNorm (eps 1e-6)
  float* norm_out;      // (B, K) f32 copy of the rows, by blocks (0, 0, z)
  const int* root;      // gather: emb_root[root[b]] + emb_attr[attr[b]]
  const int* attr;
  const void* emb_root;
  const void* emb_attr;
};

// Four consecutive T values from p as f32 (p 4-element aligned).
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<bf16>(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
  return make_float4(to_f<bf16>(e[0]), to_f<bf16>(e[1]), to_f<bf16>(e[2]),
                     to_f<bf16>(e[3]));
}

// Stage rows b0 .. b0 + nt of the input in xs (nt x K floats), or the
// clips map[b0 .. b0 + nt) when a map is given. Pass 1: every thread loads
// four-value chunks (K a multiple of 4), many in flight at once; without a
// norm it stores the f32 copy and the rows rounded to T (the matmul input)
// right away. Pass 2, with a norm: one warp per row normalises it in f32
// (LayerNorm two-pass) from shared memory, stores the f32 copy and rounds.
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
    float mean = 0.f, rs;
    if (in.rms) {  // y = x * rsqrt(mean(x^2) + eps) * g
      float q = 0.f;
      for (int c = lane; c < K4; c += 32) {
        const float4 v = row[c];
        q += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
      }
      rs = 1.f / sqrtf(warp_sum(q) / K + kRmsEps);
    } else {       // y = (x - mean) * rsqrt(var + eps) * g + b
      float s = 0.f;
      for (int c = lane; c < K4; c += 32) {
        const float4 v = row[c];
        s += (v.x + v.y) + (v.z + v.w);
      }
      mean = warp_sum(s) / K;
      float q = 0.f;
      for (int c = lane; c < K4; c += 32) {
        const float4 v = row[c];
        const float dx = v.x - mean, dy = v.y - mean;
        const float dz = v.z - mean, dw = v.w - mean;
        q += (dx * dx + dy * dy) + (dz * dz + dw * dw);
      }
      rs = 1.f / sqrtf(warp_sum(q) / K + kLnEps);
    }
    for (int c = lane; c < K4; c += 32) {
      const float4 g = load4<T>((const T*)in.ln_g + 4 * c);
      const float4 bb = in.rms ? make_float4(0.f, 0.f, 0.f, 0.f)
                               : load4<T>((const T*)in.ln_b + 4 * c);
      const float4 v = row[c];
      const float4 y = make_float4((v.x - mean) * rs * g.x + bb.x,
                                   (v.y - mean) * rs * g.y + bb.y,
                                   (v.z - mean) * rs * g.z + bb.z,
                                   (v.w - mean) * rs * g.w + bb.w);
      if (norm != nullptr)
        reinterpret_cast<float4*>(norm + (size_t)b * K)[c] = y;
      row[c] = make_float4(round_t<T>(y.x), round_t<T>(y.y), round_t<T>(y.z),
                           round_t<T>(y.w));
    }
  }
}

// A weight row w[0:K] held in registers: lane owns the 16-byte vectors
// j * 32 + lane (K a multiple of Vec<T>::N, K <= kMaxK).
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ w, int K,
                                         int lane, float (&r)[kRegs]) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int j = 0; j < kRegs / V; ++j) {
    const int k = (j * 32 + lane) * V;
    if (k < K) {
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

// acc0[i] (and acc1[i] when TWO) = dot(register row r0 (r1), row i of xs)
// for the nt <= kTile staged f32 rows, summed over the warp (every lane
// gets them). Each staged value is read once for both rows; the rows' sums
// are independent, so their loads, FMAs and shuffles overlap.
template <typename T, bool TWO>
__device__ __forceinline__ void dot_tile(const float (&r0)[kRegs],
                                         const float (&r1)[kRegs],
                                         const float* __restrict__ xs, int nt,
                                         int K, int lane, float (&acc0)[kTile],
                                         float (&acc1)[kTile]) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int i = 0; i < kTile; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kRegs / V; ++j) {
    const int k = (j * 32 + lane) * V;
    if (k < K) {
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        if (i < nt) {
          const float* x = xs + (size_t)i * K + k;
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
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      acc0[i] += __shfl_xor_sync(0xffffffffu, acc0[i], o);
      if (TWO) acc1[i] += __shfl_xor_sync(0xffffffffu, acc1[i], o);
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
  int group;            // clips per blockIdx.z
  int chunk;            // input rows staged per pass (a multiple of kTile)
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

template <typename T>
__device__ __forceinline__ void plain_store(const BGemv& a, size_t out_slot,
                                            int b, int r, float y, float bias,
                                            float kr) {
  if (a.key != nullptr) y += a.key[b] * kr;
  y += bias;
  if (a.act == kRelu) y = fmaxf(y, 0.f);
  if (a.act == kSilu) y = silu(y);
  const size_t o = out_slot + (size_t)b * a.units + r;
  if (a.residual != nullptr) y = a.residual[o] + y;
  if (a.residual_t != nullptr) y = to_f<T>(((const T*)a.residual_t)[o]) + y;
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
// rows of a pair. W: the weights' type, T or int8_t (then each row's f32
// sum is multiplied by its scale before the bias, as the Pallas _dot does).
template <typename T, int EPI, typename W = T>
static __global__ void __launch_bounds__(kThreads) bgemv_kernel(BGemv a) {
  constexpr bool kTwo = EPI != kPlain;
  constexpr bool kRopeAny = EPI == kRope || EPI == kRopeF;
  constexpr bool kQ = std::is_same<W, int8_t>::value;
  extern __shared__ __align__(16) float xs[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = blockIdx.y;
  if (slot == 0 && a.w == nullptr) return;  // a MoE without a shared expert
  const int unit = blockIdx.x * kWarps + warp;
  const bool active = unit < a.units;
  const W* w = (const W*)a.w;
  const T* bias = (const T*)a.bias;
  const float* ws = a.ws;
  if (slot > 0) {
    w = (const W*)a.ew + (size_t)(slot - 1) * a.n_rows * a.K;
    bias = (const T*)a.eb + (size_t)(slot - 1) * a.n_rows;
    if constexpr (kQ) ws = a.ews + (size_t)(slot - 1) * a.n_rows;
  }
  const int* map = nullptr;  // expert slots walk the clips routed to them
  int n = a.B;
  if (slot > 0 && a.lists != nullptr) {
    map = a.lists + (size_t)(slot - 1) * a.B;
    n = a.counts[slot - 1];
  }
  const int begin = blockIdx.z * a.group;
  if (begin >= n) return;  // no clips of this group (the whole block)
  const int end = min(n, begin + a.group);
  const int r0 = kRopeAny ? 2 * unit : unit;
  const int r1 = kRopeAny ? r0 + 1 : a.F + unit;
  float w0[kRegs], w1[kRegs];
  float b0 = 0.f, b1 = 0.f, kr = 0.f, rc = 1.f, rs = 0.f;
  float s0 = 1.f, s1 = 1.f;  // int8 rows' scales
  if (active) {
    load_row<W>(w + (size_t)r0 * a.K, a.K, lane, w0);
    b0 = to_f<T>(bias[r0]);
    if constexpr (kQ) s0 = ws[r0];
    if (kTwo) {
      load_row<W>(w + (size_t)r1 * a.K, a.K, lane, w1);
      b1 = to_f<T>(bias[r1]);
      if constexpr (kQ) s1 = ws[r1];
    }
    if (EPI == kPlain && a.key != nullptr) kr = to_f<T>(((const T*)a.krow)[r0]);
    if (kRopeAny && r0 < a.rope_rows) {
      const size_t f = (size_t)a.pos * (a.hd / 2) + ((r0 % a.hd) >> 1);
      rc = a.cos[f];
      rs = a.sin[f];
    }
  }
  const size_t out_slot = (size_t)slot * a.B * a.units;
  for (int c0 = begin; c0 < end; c0 += a.chunk) {
    const int nc = min(a.chunk, end - c0);
    __syncthreads();  // the previous chunk is consumed
    stage_rows<T>(a.in, slot, map, c0, nc, a.K, xs,
                  blockIdx.x == 0 && blockIdx.y == 0);
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < nc; t += kTile) {
      const int nt = min(kTile, nc - t);
      float acc0[kTile], acc1[kTile];
      dot_tile<W, kTwo>(w0, w1, xs + (size_t)t * a.K, nt, a.K, lane, acc0,
                        acc1);
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
          plain_store<T>(a, out_slot, b, r0, y0, b0, kr);
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

static inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

#define V2M_CHECK_LAUNCH()                     \
  do {                                         \
    cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

// Clips per GEMV block (blockIdx.z picks the group). Each group's block
// loads the same weight rows: from device memory once, the other groups
// from L2. Per block, staging and the dot loop grow with the group, not B.
constexpr int kGroup = 16;
// Shared memory for the staged input rows of one GEMV block: as many rows
// (a multiple of kTile, at most the group) as fit.
constexpr size_t kStageBytes = 64 * 1024;

template <typename T, int EPI, typename W = T>
static int gemv(BGemv g, int slots, cudaStream_t st) {
  static bool opted_in = false;  // per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        bgemv_kernel<T, EPI, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kStageBytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int fit = (int)(kStageBytes / (g.K * sizeof(float))) / kTile * kTile;
  g.group = kGroup;
  g.chunk = min(fit, ceil_div(min(g.B, kGroup), kTile) * kTile);
  const dim3 grid(ceil_div(g.units, kWarps), slots, ceil_div(g.B, kGroup));
  bgemv_kernel<T, EPI, W><<<grid, kThreads,
                            (size_t)g.chunk * g.K * sizeof(float), st>>>(g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the other blocks of a batched decode step: attention over cached rows, the
// MoE router and the per-clip closing residual + norm
// ---------------------------------------------------------------------------

enum NormKind : int { kNoNorm = 0, kLayerNorm = 1, kRmsNorm = 2 };
constexpr float kSublnEps = 1e-5f;  // differential attention's subln
constexpr int kMaxExperts = 32;

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
};

// grid (H, B): one block per (value head h, clip b). Query/key heads h
// (vanilla, RPR) or 2h and 2h + 1 (differential) over cache rows
// [0, rows): logits (q . k [+ RPR bias]) * scale, f32 softmax per query
// head; in batched mode the probabilities are rounded to T except row
// `cur` (-1: none). P.V reads the value head once for both query heads.
// Vanilla / RPR: out = sum_s p_s v_s. Differential: c = pv_even - lambda *
// pv_odd, then out = c * rsqrt(mean(c^2) + 1e-5) * subw over the head.
// Logits: a thread owns a row; P.V: a thread owns V consecutive dims of a
// row group, the groups summed in shared memory. Needs hd % Vec<C>::N == 0
// and hd <= kThreads. C = int8_t (vanilla, batched): a cached row's logit
// is (q . k) * scale * k_scale[s], its probability times v_scale[s] is
// rounded to T before P.V over the integer V; row `cur` uses k_cur / v_cur
// with no scale and an f32 probability (the Pallas _wide_attention).
template <typename T, typename C = T>
static __global__ void __launch_bounds__(kThreads) attn_kernel(Attn a) {
  constexpr int V = Vec<C>::N;
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
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(kr + d));
        const C* e = reinterpret_cast<const C*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc0 = fmaf(qs[d + i], to_f<C>(e[i]), acc0);
        if (nq == 2) {
          const uint4 raw1 =
              __ldg(reinterpret_cast<const uint4*>(kr + hd + d));
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
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(v + (size_t)s * D + c * V));
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

constexpr size_t kAttnSmemMax = 96 * 1024;

template <typename T, typename C = T>
static int attention(const Attn& t, int B, int H, cudaStream_t st) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kAttnSmemMax);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  // the int8 form: vanilla batched attention, heads of whole 16-byte loads
  if (std::is_same<C, int8_t>::value &&
      (t.diff || t.er != nullptr || !t.batched || t.hd % Vec<C>::N))
    return (int)cudaErrorInvalidValue;
  const int nq = t.diff ? 2 : 1;
  const int groups = kThreads / (t.hd / Vec<C>::N);
  const size_t smem =
      (size_t)(nq * t.hd + nq * t.rows + groups * nq * t.hd) * sizeof(float);
  if (smem > kAttnSmemMax) return (int)cudaErrorInvalidValue;
  attn_kernel<T, C><<<dim3(H, B), kThreads, smem, st>>>(t);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// router and the closing residual
// ---------------------------------------------------------------------------

// Per-clip router, one block per clip: E gate logits of the row xn[b] (T,
// or f32 already rounded to T; a warp per expert), top-k with the first index
// winning a tie, softmax over the k selected raw logits. Writes sel / selw
// (kMaxTop per clip) in selection order and appends the clip to each
// selected expert's list (counts start at 0).
template <typename T, typename X>
static __global__ void __launch_bounds__(kThreads)
router_kernel(const X* __restrict__ xn, const T* __restrict__ gate_w,
              const T* __restrict__ gate_b, int B, int K, int E, int k_top,
              int* __restrict__ sel, float* __restrict__ selw,
              int* __restrict__ counts, int* __restrict__ lists) {
  extern __shared__ __align__(16) float row[];
  __shared__ float logit[kMaxExperts];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    row[k] = to_f<X>(xn[(size_t)b * K + k]);
  __syncthreads();
  for (int e = warp; e < E; e += kWarps) {
    const float d =
        warp_sum(dot_partial<T>(gate_w + (size_t)e * K, row, K, lane));
    if (lane == 0) logit[e] = d + to_f<T>(gate_b[e]);
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
      sel[b * kMaxTop + j] = chosen[j];
      selw[b * kMaxTop + j] = expf(val[j] - val[0]) / den;
      lists[(size_t)chosen[j] * B + atomicAdd(counts + chosen[j], 1)] = b;
    }
  }
}

// Per-clip closing step, one block per clip (kMaxK / kThreads values per
// thread): v = x[b] (+ the MoE combine: the shared expert ye[0, b] / k when
// present, plus w_j * ye[e_j + 1, b] over the routed experts, in selection
// order or in expert order), then y = norm(v) (or v) -> T out, or f32 out
// (rounded to T when round_f).
struct Close {
  const void* x;        // (B, K): T when x_is_t, else f32
  int x_is_t;
  const float* ye;      // (E + 1, B, K) expert outputs, or null
  int shared, sel_order;
  const int* sel;
  const float* selw;
  int k_top, E;
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
  constexpr int kPer = kMaxK / kThreads;
  __shared__ float red[32];
  __shared__ float cw[kMaxExperts];
  __shared__ int sid[kMaxTop];
  __shared__ float sw[kMaxTop];
  __shared__ unsigned routed_mask;
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    unsigned m = 0u;
    if (a.ye != nullptr) {
      for (int j = 0; j < a.k_top; ++j) {
        const int e = a.sel[b * kMaxTop + j];
        m |= 1u << e;
        cw[e] = sw[j] = a.selw[b * kMaxTop + j];
        sid[j] = e;
      }
    }
    routed_mask = m;
  }
  __syncthreads();
  const unsigned mask = routed_mask;
  const size_t slot = (size_t)a.B * a.K;
  float v[kPer];
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = threadIdx.x + j * kThreads;
    v[j] = 0.f;
    if (k < a.K) {
      const size_t o = (size_t)b * a.K + k;
      float x = a.x_is_t ? to_f<T>(((const T*)a.x)[o]) : ((const float*)a.x)[o];
      if (a.ye != nullptr) {
        float acc = a.shared ? a.ye[o] / (float)a.k_top : 0.f;
        if (a.sel_order) {
          for (int i = 0; i < a.k_top; ++i)
            acc += sw[i] * a.ye[(size_t)(sid[i] + 1) * slot + o];
        } else {
          for (int e = 0; e < a.E; ++e)
            if ((mask >> e) & 1u) acc += cw[e] * a.ye[(size_t)(e + 1) * slot + o];
        }
        x = x + acc;
      }
      v[j] = x;
      s += x;
      sq += x * x;
    }
  }
  float mean = 0.f, rs = 1.f;
  if (a.norm == kLayerNorm) {
    mean = block_sum(s, red) / a.K;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = threadIdx.x + j * kThreads;
      if (k < a.K) {
        const float d = v[j] - mean;
        q += d * d;
      }
    }
    rs = 1.f / sqrtf(block_sum(q, red) / a.K + kLnEps);
  } else if (a.norm == kRmsNorm) {
    rs = 1.f / sqrtf(block_sum(sq, red) / a.K + kRmsEps);
  }
  const T* g = (const T*)a.g;
  const T* bb = (const T*)a.bn;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = threadIdx.x + j * kThreads;
    if (k < a.K) {
      float y = v[j];
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
}

template <typename T>
static int close_rows(const Close& c, cudaStream_t st) {
  close_kernel<T><<<c.B, kThreads, 0, st>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace batch
}  // namespace v2m
