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
// What bounds it on the H100: bytes. One step at B=16 reads, per layer, the
// clips' cross K/V (16 x 300 x 512 x 2 x 2 B = 9.8 MB in bf16), their self
// K/V up to pos (~5 MB at pos 150) and the layer's weights (6.3 MB shallow,
// 25 MB deep with all six experts): ~180 MB per step of six layers, ~55 us
// at 3.35 TB/s (computed from the shapes, not measured). From B ~ 16 up the
// cache reads, not the weights, set the pace. What the design does:
//   * attention: one block per (head, clip), so B x 8 blocks are in flight;
//     16-byte loads along D, a row per thread for the logits and row groups
//     for P.V (the B=1 kernel's scheme with a clip index);
//   * GEMMs: one warp per output row (or row pair) holds its weight row in
//     registers and walks a group of 16 clips' input rows staged in shared
//     memory (loaded by every thread with many loads in flight, a LayerNorm
//     of the rows folded into the staging), kTile rows at a time with
//     independent sums, so their loads, FMAs and shuffles overlap; a RoPE
//     or SwiGLU warp holds its two weight rows and reads each staged value
//     once for both; lane i then finishes row i. Each weight row is read
//     from device memory once per step: the blocks of the other clip groups
//     (B > 16) find it in L2;
//   * experts: blockIdx.y picks the shared expert (0) or expert e (e + 1);
//     each expert's weights are read once for the batch, and it stages and
//     computes only the clips the router listed for it (expert ids and
//     lists stay in device memory);
//   * a short chain of launches per layer on one stream (10-11 for a shallow
//     layer, 8 for the attention half of a deep one, 4-5 for the MoE half).
// Plain FMA and warp shuffles, no tensor cores (mma / wgmma, TMA and CUDA
// graphs are later work).
#include "common.cuh"

namespace v2m {
namespace batch {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 8;       // staged rows a warp sums side by side
constexpr int kMaxK = 1024;    // longest row a warp holds in registers
constexpr int kRegs = kMaxK / 32;
constexpr float kLnEps = 1e-5f;
constexpr int kMaxTop = 8;

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
  int shallow, B, D, H, F, S, Sm, pos;
};

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
};

// The B input rows of a batched GEMV.
struct RowsIn {
  const void* x;        // (slots, B, K): T when x_is_t, else f32;
                        // null = embedding gather
  int x_is_t;
  size_t slot_stride;   // elements between slots' rows (0 = one input)
  const void* ln_g;     // LayerNorm (T) to apply to each row, or null
  const void* ln_b;
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
// LayerNorm it stores the f32 copy and the rows rounded to T (the matmul
// input) right away. Pass 2, with a LayerNorm: one warp per row normalises
// it in f32 (two-pass) from shared memory, stores the f32 copy and rounds.
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
    float s = 0.f;
    for (int c = lane; c < K4; c += 32) {
      const float4 v = row[c];
      s += (v.x + v.y) + (v.z + v.w);
    }
    const float mean = warp_sum(s) / K;
    float q = 0.f;
    for (int c = lane; c < K4; c += 32) {
      const float4 v = row[c];
      const float dx = v.x - mean, dy = v.y - mean;
      const float dz = v.z - mean, dw = v.w - mean;
      q += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
    const float rs = 1.f / sqrtf(warp_sum(q) / K + kLnEps);
    for (int c = lane; c < K4; c += 32) {
      const float4 g = load4<T>((const T*)in.ln_g + 4 * c);
      const float4 bb = load4<T>((const T*)in.ln_b + 4 * c);
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

enum Epi : int { kPlain = 0, kRope = 1, kSwiglu = 2 };

struct BGemv {
  RowsIn in;
  const void* w;        // slot 0: (n_rows, K) T, row-major
  const void* bias;     // slot 0: (n_rows) T
  const void* ew;       // slots >= 1: expert slot - 1 of (E, n_rows, K)
  const void* eb;       // (E, n_rows)
  const int* counts;    // slot >= 1 computes only the counts[slot - 1]
  const int* lists;     // clips lists[(slot - 1) * B + i] routed to it
  int B, K, n_rows;
  int units;            // plain: output rows; rope: row pairs; swiglu: F
  int group;            // clips per blockIdx.z
  int chunk;            // input rows staged per pass (a multiple of kTile)
  // plain: y = dot [+ key[b] * krow] + bias [+ residual]; (slot, B, units)
  const float* key;
  const void* krow;
  const float* residual;
  float* out_f;         // f32 out (rounded to T when round_out) ...
  void* out_t;          // ... or T out
  int round_out;
  // rope (row pairs): rows < rope_rows rotate at pos; rows [0, D) -> out_f
  // rounded to T, rows [D, 2D) / [2D, 3D) -> k_cache / v_cache at (b, pos)
  const float* cos;
  const float* sin;
  int pos, hd, rope_rows, D, S;
  void* k_cache;
  void* v_cache;
  // swiglu (row pairs j, F + j): out_f[slot, b, j] = h * silu(g)
  int F;
};

template <typename T>
__device__ __forceinline__ void rope_store(const BGemv& a, int b, int r,
                                           float y) {
  if (r < a.D) {
    a.out_f[(size_t)b * a.D + r] = round_t<T>(y);
  } else if (r < 2 * a.D) {
    ((T*)a.k_cache)[((size_t)b * a.S + a.pos) * a.D + (r - a.D)] = from_f<T>(y);
  } else {
    ((T*)a.v_cache)[((size_t)b * a.S + a.pos) * a.D + (r - 2 * a.D)] =
        from_f<T>(y);
  }
}

template <typename T>
__device__ __forceinline__ void plain_store(const BGemv& a, size_t out_slot,
                                            int b, int r, float y, float bias,
                                            float kr) {
  if (a.key != nullptr) y += a.key[b] * kr;
  y += bias;
  const size_t o = out_slot + (size_t)b * a.units + r;
  if (a.residual != nullptr) y = a.residual[o] + y;
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
// rows of a pair.
template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads) bgemv_kernel(BGemv a) {
  constexpr bool kTwo = EPI != kPlain;
  extern __shared__ __align__(16) float xs[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = blockIdx.y;
  const int unit = blockIdx.x * kWarps + warp;
  const bool active = unit < a.units;
  const T* w = (const T*)a.w;
  const T* bias = (const T*)a.bias;
  if (slot > 0) {
    w = (const T*)a.ew + (size_t)(slot - 1) * a.n_rows * a.K;
    bias = (const T*)a.eb + (size_t)(slot - 1) * a.n_rows;
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
  const int r0 = EPI == kRope ? 2 * unit : unit;
  const int r1 = EPI == kRope ? r0 + 1 : a.F + unit;
  float w0[kRegs], w1[kRegs];
  float b0 = 0.f, b1 = 0.f, kr = 0.f, rc = 1.f, rs = 0.f;
  if (active) {
    load_row<T>(w + (size_t)r0 * a.K, a.K, lane, w0);
    b0 = to_f<T>(bias[r0]);
    if (kTwo) {
      load_row<T>(w + (size_t)r1 * a.K, a.K, lane, w1);
      b1 = to_f<T>(bias[r1]);
    }
    if (EPI == kPlain && a.key != nullptr) kr = to_f<T>(((const T*)a.krow)[r0]);
    if (EPI == kRope && r0 < a.rope_rows) {
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
      dot_tile<T, kTwo>(w0, w1, xs + (size_t)t * a.K, nt, a.K, lane, acc0,
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
      if (lane < nt) {
        const int r = c0 + t + lane;
        const int b = map != nullptr ? map[r] : r;
        if (EPI == kPlain) {
          plain_store<T>(a, out_slot, b, r0, y0, b0, kr);
        } else if (EPI == kRope) {
          y0 += b0;
          y1 += b1;
          const float t0r = y0 * rc - y1 * rs;  // rc = 1, rs = 0: no rotation
          const float t1r = y1 * rc + y0 * rs;
          rope_store<T>(a, b, r0, t0r);
          rope_store<T>(a, b, r1, t1r);
        } else {  // kSwiglu: y0 = h, y1 = g
          y0 += b0;
          y1 += b1;
          a.out_f[out_slot + (size_t)b * a.units + unit] =
              y0 * (y1 * (1.f / (1.f + expf(-y1))));
        }
      }
    }
  }
}

// grid (H, B): one block per (head, clip). Softmax over rows [0, rows) of
// q . k * scale; probabilities rounded to T except row `cur` (-1: none);
// out = round(sum_s p_s v_s). k/v hold `stride_rows` rows per clip. For the
// logits a thread owns a row (hd / V independent 16-byte loads); for P.V a
// thread owns V consecutive dims of one row group and the groups are summed
// in shared memory. Needs hd % Vec<T>::N == 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
battn_kernel(const float* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ out, int rows,
             int stride_rows, int D, int hd, float scale, int cur) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  float* qs = sm;                    // hd
  float* part = qs + hd;             // blockDim.x * V
  float* p = part + blockDim.x * V;  // rows
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  k += (size_t)b * stride_rows * D + h * hd;
  v += (size_t)b * stride_rows * D + h * hd;
  for (int i = tid; i < hd; i += blockDim.x) qs[i] = q[(size_t)b * D + h * hd + i];
  __syncthreads();
  float lmax = -INFINITY;
  for (int s = tid; s < rows; s += blockDim.x) {
    const T* kr = k + (size_t)s * D;
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
  const float inv = 1.f / block_sum(lsum, red);  // also orders p[] writes
  for (int s = tid; s < rows; s += blockDim.x)
    p[s] = s == cur ? p[s] * inv : round_t<T>(p[s] * inv);
  __syncthreads();
  const int chunks = hd / V;
  const int groups = blockDim.x / chunks;
  const int g = tid / chunks, c = tid % chunks;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (g < groups) {
    for (int s = g; s < rows; s += groups) {
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(v + (size_t)s * D + c * V));
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
    out[(size_t)b * D + h * hd + d] = round_t<T>(t);
  }
}

template <typename T>
static size_t attention_smem(int hd, int rows) {
  return (size_t)(hd + kThreads * Vec<T>::N + rows) * sizeof(float);
}

// Per-clip router, one block per clip: E gate logits of the T row x2[b]
// (a warp per expert), top-k with the first index winning a tie, softmax
// over the k selected raw logits. Writes sel / selw (kMaxTop per clip) and
// appends the clip to each selected expert's list (counts start at 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
router_kernel(const T* __restrict__ x2, const T* __restrict__ gate_w,
              const T* __restrict__ gate_b, int B, int K, int E, int k_top,
              int* __restrict__ sel, float* __restrict__ selw,
              int* __restrict__ counts, int* __restrict__ lists) {
  extern __shared__ __align__(16) float row[];
  __shared__ float logit[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    row[k] = to_f<T>(x2[(size_t)b * K + k]);
  __syncthreads();
  for (int e = warp; e < E; e += kWarps) {
    const float d = warp_sum(dot_partial<T>(gate_w + (size_t)e * K, row, K, lane));
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
      // the expert's list of clips (in no fixed order; each clip's result
      // depends on its own row only)
      lists[(size_t)chosen[j] * B + atomicAdd(counts + chosen[j], 1)] = b;
    }
  }
}

// Per-clip LayerNorm, one block per clip (kMaxK / kThreads values per
// thread): v = x[b] (+ the MoE combine ye[0, b] / k + sum over routed
// experts e, in expert order, of w_e * ye[e + 1, b]), then LN(v) -> T out,
// or f32 rounded to T.
struct RowsLn {
  const void* x;        // (B, K): T when x_is_t, else f32
  int x_is_t;
  const float* ye;      // (E + 1, B, K) expert outputs, or null
  const int* sel;
  const float* selw;
  int k_top, E;
  const void* g;
  const void* bln;
  float* out_f;
  void* out_t;
  int B, K;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) rows_ln_kernel(RowsLn a) {
  constexpr int kPer = kMaxK / kThreads;
  __shared__ float red[32];
  __shared__ float cw[32];
  __shared__ unsigned routed_mask;
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    unsigned m = 0u;
    if (a.ye != nullptr) {
      for (int j = 0; j < a.k_top; ++j) {
        const int e = a.sel[b * kMaxTop + j];
        m |= 1u << e;
        cw[e] = a.selw[b * kMaxTop + j];
      }
    }
    routed_mask = m;
  }
  __syncthreads();
  const unsigned mask = routed_mask;
  float v[kPer];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = threadIdx.x + j * kThreads;
    v[j] = 0.f;
    if (k < a.K) {
      const size_t o = (size_t)b * a.K + k;
      float x = a.x_is_t ? to_f<T>(((const T*)a.x)[o]) : ((const float*)a.x)[o];
      if (a.ye != nullptr) {
        float acc = a.ye[o] / (float)a.k_top;
        for (int e = 0; e < a.E; ++e)
          if ((mask >> e) & 1u)
            acc += cw[e] * a.ye[(size_t)(e + 1) * a.B * a.K + o];
        x = x + acc;
      }
      v[j] = x;
      s += x;
    }
  }
  const float mean = block_sum(s, red) / a.K;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = threadIdx.x + j * kThreads;
    if (k < a.K) {
      const float d = v[j] - mean;
      q += d * d;
    }
  }
  const float rs = 1.f / sqrtf(block_sum(q, red) / a.K + kLnEps);
  const T* g = (const T*)a.g;
  const T* bb = (const T*)a.bln;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = threadIdx.x + j * kThreads;
    if (k < a.K) {
      const float y = (v[j] - mean) * rs * to_f<T>(g[k]) + to_f<T>(bb[k]);
      const size_t o = (size_t)b * a.K + k;
      if (a.out_t != nullptr) {
        ((T*)a.out_t)[o] = from_f<T>(y);
      } else {
        a.out_f[o] = round_t<T>(y);
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

template <typename T, int EPI>
static int gemv(BGemv g, int slots, cudaStream_t st) {
  static bool opted_in = false;  // per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        bgemv_kernel<T, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kStageBytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int fit = (int)(kStageBytes / (g.K * sizeof(float))) / kTile * kTile;
  g.group = kGroup;
  g.chunk = min(fit, ceil_div(min(g.B, kGroup), kTile) * kTile);
  const dim3 grid(ceil_div(g.units, kWarps), slots, ceil_div(g.B, kGroup));
  bgemv_kernel<T, EPI><<<grid, kThreads,
                         (size_t)g.chunk * g.K * sizeof(float), st>>>(g);
  return (int)cudaGetLastError();
}

template <typename T>
static int rows_ln(const RowsLn& r, cudaStream_t st) {
  rows_ln_kernel<T><<<r.B, kThreads, 0, st>>>(r);
  return (int)cudaGetLastError();
}

template <typename T>
static int run_layer(const V2MBatchLayer& a, cudaStream_t st) {
  const int B = a.B, D = a.D, F = a.F, hd = D / a.H;
  const float scale = 1.f / sqrtf((float)hd);
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
  const T* norm_g = (const T*)a.norm_scale;
  const T* norm_b = (const T*)a.norm_bias;
  const bool embed = a.token_root != nullptr;
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
    g.D = D;
    g.S = a.S;
    g.out_f = q;
    g.k_cache = a.k_cache;
    g.v_cache = a.v_cache;
    if ((err = gemv<T, kRope>(g, 1, st))) return err;
  }
  // self-attention over rows <= pos, row pos kept f32
  battn_kernel<T><<<dim3(a.H, B), kThreads,
                    attention_smem<T>(hd, a.pos + 1), st>>>(
      q, (const T*)a.k_cache, (const T*)a.v_cache, attn, a.pos + 1, a.S, D,
      hd, scale, a.pos);
  V2M_CHECK_LAUNCH();
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
    g.D = D;
    g.S = a.S;
    g.out_f = cq;
    if ((err = gemv<T, kRope>(g, 1, st))) return err;
  }
  // cross-attention over each clip's Sm primed rows
  battn_kernel<T><<<dim3(a.H, B), kThreads, attention_smem<T>(hd, a.Sm),
                    st>>>(cq, (const T*)a.k_cross, (const T*)a.v_cross, cattn,
                          a.Sm, a.Sm, D, hd, scale, -1);
  V2M_CHECK_LAUNCH();
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
  RowsLn ln = {};
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
    ln.bln = norm_b + 2 * D;
  } else {
    ln.x = r2;  // deep: y = round(LN2(r2)), finished by the MoE step
    ln.g = norm_g + D;
    ln.bln = norm_b + D;
  }
  return rows_ln<T>(ln, st);
}

template <typename T>
static int run_moe(const V2MBatchMoe& a, cudaStream_t st) {
  const int B = a.B, D = a.D, F = a.F, E = a.E;
  if (a.k_top < 1 || a.k_top > kMaxTop || a.k_top > E || E > 32)
    return (int)cudaErrorInvalidValue;
  // f32 workspace, laid out as in decode_batch.py:moe_workspace_size
  float* selw = a.work;                             // (B, kMaxTop)
  float* act = selw + (size_t)B * kMaxTop;          // (E + 1, B, F)
  float* ye = act + (size_t)(E + 1) * B * F;        // (E + 1, B, D)
  float* x3 = ye + (size_t)(E + 1) * B * D;         // (B, D) for the head
  // int workspace, as in decode_batch.py:moe_route_size
  int* counts = a.sel + (size_t)B * kMaxTop;        // (32) clips per expert
  int* lists = counts + 32;                         // (E, B) their ids
  int err;
  if ((err = (int)cudaMemsetAsync(counts, 0, E * sizeof(int), st))) return err;
  router_kernel<T><<<B, kThreads, (size_t)D * sizeof(float), st>>>(
      (const T*)a.x2, (const T*)a.gate_w, (const T*)a.gate_b, B, D, E,
      a.k_top, a.sel, selw, counts, lists);
  V2M_CHECK_LAUNCH();
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
    RowsLn ln = {};
    ln.x = a.x2;
    ln.x_is_t = 1;
    ln.ye = ye;
    ln.sel = a.sel;
    ln.selw = selw;
    ln.k_top = a.k_top;
    ln.E = E;
    ln.g = (const T*)a.norm_scale + 2 * D;
    ln.bln = (const T*)a.norm_bias + 2 * D;
    ln.B = B;
    ln.K = D;
    if (head) {
      ln.out_f = x3;
    } else {
      ln.out_t = a.out;
    }
    if ((err = rows_ln<T>(ln, st))) return err;
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
  if (args->D > batch::kMaxK || args->F > batch::kMaxK)
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
  if (args->D > batch::kMaxK || args->F > batch::kMaxK)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return batch::run_moe<float>(*args, st);
  if (dtype == kBF16) return batch::run_moe<bf16>(*args, st);
  return (int)cudaErrorInvalidValue;
}
