// Attention above head size 256 (rows 1 and 11 at any head size), for
// flash_attention.cu (row 1) and flash_attention_dropout.cu (row 11's
// forward and backward).
//
// The Pallas wrappers pad D to a multiple of 128 and keep whole rows in
// VMEM (video2music_tpu/ops/pallas_attention.py:143,
// pallas_attention_dropout.py:162). On the H100 the widest instance of
// attention_mma.cuh keeps a (16, 256) f32 accumulator a warp in registers;
// a wider head does not fit. So the head is split into column slices of
// kWide (the wrappers pad D with zero columns to a multiple of kWide: zero
// columns change neither q . k nor the kept columns of P . V).
//
// The forward, bf16 (the product and training path): one thread-block
// cluster of C blocks a tile of kTile query rows, block r of it owning
// the slices [r nd / C, (r + 1) nd / C) of the head and the rows [r kTile
// / C, (r + 1) kTile / C) of the tile (the plan, kernels.wide_plan, passes
// C). A block reads only its own slices of q, K and V. For each 64-key
// chunk it forms its partial S_r = q_r K_r^T on the tensor cores (mma.sync
// m16n8k16, f32 accumulators; q and K pieces double-buffered by cp.async)
// and leaves it in its shared memory; after a cluster barrier each block
// adds its own rows of the partials of every block of the cluster through
// distributed shared memory (a reduce-scatter). So S is formed once a
// (tile, chunk) for the whole head, not once a slice. One pass where the
// block's rows of logits over every key fit its shared memory: the logits
// stay there, the exact row max and sum follow the last chunk, and the
// weights are rounded to bf16 [* the dropout factor] as the Pallas kernel
// rounds them (pallas_attention.py:60-64). Beyond that S, two passes: the
// first keeps a running max and sum, the second forms S again and hands
// each chunk's weights round. Every block then multiplies the tile's
// weights, read from their owners through distributed shared memory, by
// its own V slices, kGroup slices at a time (a block of more slices loops
// over groups). The dropout mask hashes (plane, row, column) only, so it
// is bit for bit that of the narrow instances; the owner of a row writes
// its (m, l) for the backward.
//
// f32 (the train_amt CLI's default and the evaluate CLI at head size 512)
// runs the same plan on the same tensor cores in split TF32
// (attention_tf32.cuh: three TF32 mma.sync.m16n8k8 products a product,
// chains of kChainSlices k-slices added rounded, f32 accuracy), in f32
// pieces of 64 rows padded by 4 floats (the scalar B-fragment loads fall
// into 32 distinct banks), 8 warps a block: a warp takes 16 rows of the
// tile and half of a chunk's columns (of S, dP) or of a slice's (of the
// outputs). The forward keeps a block's q slices in shared memory for the
// whole tile where they fit and streams only K and V through the cp.async
// ring; the owners' weights stay f32 and unsplit: a gathering warp splits
// each A fragment once and reuses it for the 4 column tiles of its half of
// every slice of its group, while owners that wrote (big, small) pairs
// would double the remote loads, the slow part.
//
// The backward (dQ, D and dbias; then dK and dV), in both dtypes, is one
// skeleton (bwd_wide_body, the dtype's products in BwdOps<E>), 8 warps a
// block as the f32 forward's: one cluster a 64-row query (dQ) or key
// (dK/dV) tile, its blocks owning the plan's slices and rows. For each
// 64-row chunk of the other side every block adds its partials of S and
// dP (dQ: q K^T, dO V^T; dK/dV: K q^T, V dO^T) over its slices into two
// f32 shared tiles; one reduce-scatter through distributed shared memory
// hands each owner its rows of both, so S and dP are formed once a (tile,
// chunk) for the whole head. The owner forms P and dS (dQ: D = rowsum(dO
// * O) from per-block partials reduced in the first exchange, dbias
// written in f32, dsum for dK/dV; dK/dV: (m, l) from the stats and D from
// dsum) and pushes them into every block's shared memory (bf16: P * mask
// and dS rounded there, as the narrow bf16 kernels round them; the owners'
// rows are keys in dK/dV, so the pushed (P * mask)^T and dS^T are A
// operands as they lie, read by ldmatrix); every block then multiplies
// them by its own slices of the chunk (dQ += dS K; dV += (P * mask)^T dO,
// dK += dS^T q). q and dO (dQ) or K and V (dK/dV) stay resident where
// they fit; the other side streams. A block holds the outputs of kGroup
// slices at once; more take another pass over the chunks. No atomics: the
// gradients are the same run to run.
//
// What bounds them: at row 11's hd 512 training shape (B*H = 16, L = S =
// 300) the bf16 forward moves 19.7 MB (5.9 us at 3.35 TB/s) and needs two
// (L, S, D) products, 2.9 GFLOP (3.0 us at 989 TFLOP/s), the backward 34.4
// MB (10.3 us) and five, 7.4 GFLOP (7.5 us): the bytes bound both; f32
// doubles the bytes (39.3 and 68.8 MB) and halves the peak (495 TFLOP/s
// TF32), with three products on the card for each. A block is a chain of
// cluster barriers, one (the forward) or two (the backward) a (tile,
// chunk), and of steps a (chunk, slice); that chain's latency, not the
// bound, sets the time (at B=1 from the shapes; at B=16 the backward's
// 0.2-0.6 ms bf16 against its 6-21 us bound, an H100 80GB HBM3 at 700 W).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "attention_tf32.cuh"

namespace v2m {
namespace wide {

constexpr int kWide = 64;      // columns a block owns; the D-chunk width

using mma::Chunk;

// Rows r0 .. r0 + 63, kWide columns, of a (rows, stride) bf16 matrix (src
// at the chunk's first column) into a padded shared chunk by the block's
// THREADS threads; rows at or past `limit` zero.
template <int THREADS>
__device__ __forceinline__ void load_chunk_s(bf16* dst,
                                             const bf16* __restrict__ src,
                                             int r0, int limit, int stride) {
  constexpr int kPieces = kWide / 8;
  constexpr int kTotal = mma::kChunk * kPieces;
#pragma unroll
  for (int it = 0; it < kTotal / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i / kPieces, c = (i % kPieces) * 8;
    const bool ok = r0 + r < limit;
    mma::cp_async16(dst + r * Chunk<kWide>::kStride + c,
                    src + (size_t)(ok ? r0 + r : 0) * stride + c, ok);
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores: one thread-block cluster a query tile,
// its blocks splitting the head's kWide-column slices
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kTile = 64;                  // query rows a cluster: 4 warps of 16
constexpr int kThreads = kTile / 16 * 32;
constexpr int kGroup = 2;                  // slices a block's P . V holds at once
constexpr int kStages = 2;                 // cp.async ring stages
constexpr int kLoads = 4;                  // remote loads in flight an item
constexpr int kClusterMin = 4;             // a block owns at most 16 rows
constexpr int kClusterMax = 8;             // the portable cluster size
constexpr int kPartLd = mma::kChunk + 8;        // f32 a row of a partial S tile
constexpr int kPLd = mma::kChunk + 8;           // bf16 a row of a weight chunk
constexpr int kSmemMax = 232448;           // dynamic shared bytes a block

// The launch plan, kernels.wide_plan's: blocks a cluster (one cluster a
// query tile), slices a block at most (ceil(nd / cluster)), passes over the
// keys (1 or 2), dynamic shared bytes.
struct Plan {
  int cluster, slices, passes, smem;
};

// Rows of the tile a block owns at most.
__host__ __device__ constexpr int own_rows(int cluster) {
  return (kTile + cluster - 1) / cluster;
}

// Items of the reduction a thread takes: 16 lanes a row a chunk.
constexpr int kItems = (own_rows(kClusterMin) * 16 + kThreads - 1) / kThreads;

// Dynamic shared bytes of a plan: the cp.async ring (kStages stages of two
// 64 x kWide pieces: q and K, or V), two partial S tiles, and the block's
// own rows: one pass, their logits (f32) and weights (bf16) over every
// key; two passes, two chunks of weights.
__host__ __device__ constexpr int plan_smem(int cluster, int S, int passes) {
  return kStages * 2 * Chunk<kWide>::kElems * 2 + 2 * kTile * kPartLd * 4 +
         (passes == 1
              ? own_rows(cluster) *
                    ((S + mma::kChunk - 1) / mma::kChunk * mma::kChunk * 6 + 16)
              : 2 * own_rows(cluster) * kPLd * 2);
}

// The A operand of this warp's 16 rows of a 64 x kWide shared piece.
__device__ __forceinline__ void load_a_piece(uint32_t (&a)[kWide / 16][4],
                                             const bf16* piece, int warp,
                                             int lane) {
  const bf16* p = piece + (warp * 16 + (lane & 15)) * Chunk<kWide>::kStride +
                  (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kWide / 16; ++kk) mma::ldmatrix_x4(a[kk], p + kk * 16);
}

// The weights of this warp's 16 rows for one 64-key chunk, as the A
// operand of P . V, from the blocks that own the rows: `w` is a block's
// (local) weights, `ld` bf16 a row, col0 the chunk's first column there.
__device__ __forceinline__ void gather_p(uint32_t (&p)[mma::kChunk / 16][4],
                                         cg::cluster_group& cluster,
                                         const bf16* w, int ld, int col0,
                                         int C, int warp, int lane) {
  const int ta = warp * 16 + (lane >> 2), tb = ta + 8;  // rows of the tile
  const int oa = (C * (ta + 1) - 1) / kTile, ob = (C * (tb + 1) - 1) / kTile;
  const int c = col0 + (lane & 3) * 2;
  const bf16* pa = cluster.map_shared_rank(w, oa) +
                   (ta - oa * kTile / C) * ld + c;
  const bf16* pb = cluster.map_shared_rank(w, ob) +
                   (tb - ob * kTile / C) * ld + c;
#pragma unroll
  for (int kk = 0; kk < mma::kChunk / 16; ++kk) {
    p[kk][0] = *reinterpret_cast<const uint32_t*>(pa + kk * 16);
    p[kk][1] = *reinterpret_cast<const uint32_t*>(pb + kk * 16);
    p[kk][2] = *reinterpret_cast<const uint32_t*>(pa + kk * 16 + 8);
    p[kk][3] = *reinterpret_cast<const uint32_t*>(pb + kk * 16 + 8);
  }
}

// Max and sum over the 16 lanes that share a row of the reduction.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Four weights exp(x - m) / l [* the dropout factor] of a row from column
// col, rounded to bf16, as two packed pairs.
template <bool DROPOUT>
__device__ __forceinline__ uint2 weights4(const float (&x)[4], float ml2,
                                          float inv, const DropoutSpec& d,
                                          unsigned int rt, int col) {
  float w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    w[e] = mma::exp_from(x[e], ml2) * inv;
    if (DROPOUT && d.apply) w[e] *= mma::keep_factor(d, rt, mma::col_term(col + e));
  }
  return make_uint2(mma::pack_bf16(w[0], w[1]), mma::pack_bf16(w[2], w[3]));
}

// grid (query tiles x cluster, planes, BH / planes), clusters of
// plan.cluster blocks along x; (b, h) = blockIdx.z * planes + blockIdx.y
// reads bias plane blockIdx.y. One sequence of ring steps, each one
// 64-key chunk of one slice: the q K^T steps (chunk-major over the
// block's slices; the chunk's last one ends in the exchange), then, with
// one pass, the P . V steps (a group of kGroup slices, its chunks, its
// slices); with two passes, per group and chunk the chunk's q K^T steps
// again (the exchange hands its weights round) and its P . V steps.
// Every block of a cluster makes the same exchanges in the same order
// (the groups are counted from plan.slices), so their barriers pair up.
template <bool CAUSAL, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
attention_fwd_wide_mma(mma::FwdArgs a, int D, Plan plan) {
  using namespace mma;
  constexpr int kNT = kChunk / 8;  // key tiles of a chunk
  constexpr int kDT = kWide / 8;   // column tiles of a slice
  constexpr int kPiece = Chunk<kWide>::kElems;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = plan.cluster, rank = (int)cluster.block_rank();
  const int nd = D / kWide;
  const int s_lo = rank * nd / C, nsl = (rank + 1) * nd / C - s_lo;
  const int r_lo = rank * kTile / C, nown = (rank + 1) * kTile / C - r_lo;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const int L = a.L, S = a.S;
  const int tile0 = (blockIdx.x / C) * kTile;
  const bf16* qb = a.q + (size_t)bh * L * D;
  const bf16* kb = a.k + (size_t)bh * S * D;
  const bf16* vb = a.v + (size_t)bh * S * D;
  const int n_all = (S + kChunk - 1) / kChunk;
  const int n_chunks = CAUSAL ? min(n_all, tile0 / kChunk + 1) : n_all;
  const int sc = n_all * kChunk;  // keys a row of logits holds
  const int rows = own_rows(C);
  const bool one = plan.passes == 1;
  const unsigned int salt = DROPOUT ? drop_salt(a.seed, a.drop, bh) : 0u;

  // shared memory (plan_smem): ring [kStages][q or V, K], partials [2],
  // then one pass: logits [rows][sc] and weights [rows][sc + 8]; two
  // passes: weight chunks [2][rows][kPLd]
  bf16* ring = reinterpret_cast<bf16*>(attn_smem);
  float* part = reinterpret_cast<float*>(ring + kStages * 2 * kPiece);
  float* lg = part + 2 * kTile * kPartLd;
  bf16* wts = one ? reinterpret_cast<bf16*>(lg + rows * sc)
                  : reinterpret_cast<bf16*>(lg);
  const int wld = one ? sc + 8 : kPLd;

  // the steps
  const int s_steps = n_chunks * nsl;
  const int n_groups = (plan.slices + kGroup - 1) / kGroup;
  const int full = one ? kGroup * n_chunks : (nsl + kGroup) * n_chunks;
  const int steps =
      s_steps + (one ? s_steps : n_chunks * (n_groups * nsl + nsl));
  struct Step {
    int kind, c, j, g, w;  // 0 q K^T / 1 P . V, chunk, slice (of the
                           // block's), group, the group's width
  };
  auto step_at = [&](int t) -> Step {
    if (t < s_steps) return Step{0, t / nsl, t % nsl, 0, 0};
    t -= s_steps;
    const int gi = t / full;
    t -= gi * full;
    const int w = max(0, min(kGroup, nsl - gi * kGroup));
    if (one) return Step{1, t / w, gi * kGroup + t % w, gi, w};
    const int c = t / (nsl + w), k = t % (nsl + w);
    return k < nsl ? Step{0, c, k, gi, w}
                   : Step{1, c, gi * kGroup + k - nsl, gi, w};
  };
  // step t's pieces into stage t % kStages (an empty group past the end,
  // so that the wait below counts groups alike)
  auto issue = [&](int t) {
    if (t < steps) {
      const Step s = step_at(t);
      bf16* st = ring + (t % kStages) * 2 * kPiece;
      const int col = (s_lo + s.j) * kWide;
      if (s.kind == 0) {
        load_chunk_s<kThreads>(st, qb + col, tile0, L, D);
        load_chunk_s<kThreads>(st + kPiece, kb + col, s.c * kChunk, S, D);
      } else {
        load_chunk_s<kThreads>(st, vb + col, s.c * kChunk, S, D);
      }
    }
    cp_async_commit();
  };

  float s[kNT][4], o[kGroup][kDT][4];
  uint32_t p[kNT / 2][4];
#pragma unroll
  for (int u = 0; u < kGroup; ++u)
#pragma unroll
    for (int j = 0; j < kDT; ++j) o[u][j][0] = o[u][j][1] = o[u][j][2] = o[u][j][3] = 0.f;
  // the reduction's items: it * kThreads + threadIdx.x, 16 lanes a row of
  // the block's own, 4 columns a lane; two passes keep each row's running
  // max and sum (m, l)
  float m_run[kItems], l_run[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    m_run[it] = -INFINITY;
    l_run[it] = 0.f;
  }
  int ex = 0, pe = 0;  // exchanges of partials; of weight chunks

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < steps; ++t) {
    issue(t + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const Step st = step_at(t);
    const bf16* stage = ring + (t % kStages) * 2 * kPiece;
    if (st.kind == 0) {
      if (st.j == 0) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      }
      uint32_t qf[kWide / 16][4];
      load_a_piece(qf, stage, warp, lane);
      mma_a_rowsT<kWide, kNT>(s, qf, stage + kPiece, lane);
      if (st.j == nsl - 1) {
        // The exchange of this chunk: the block's partial in; after the
        // cluster's barrier, the sum over the cluster of the block's own
        // rows out: as logits (mode 1, one pass), into the running max
        // and sum (2, the first of two passes) or as weights (3, the
        // second). Two partial buffers: a block writes one while the
        // others may still read the other.
        float* pt = part + (ex++ & 1) * kTile * kPartLd;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          float* r = pt + (warp * 16 + (lane >> 2)) * kPartLd + n * 8 + c2;
          *reinterpret_cast<float2*>(r) = make_float2(s[n][0], s[n][1]);
          *reinterpret_cast<float2*>(r + 8 * kPartLd) =
              make_float2(s[n][2], s[n][3]);
        }
        cluster.sync();  // every block's partial is in place
        const int mode = t < s_steps ? (one ? 1 : 2) : 3;
        bf16* wc = wts + (pe & 1) * rows * kPLd;  // mode 3's weight chunk
        float x[kItems][4];
#pragma unroll
        for (int it = 0; it < kItems; ++it)
          x[it][0] = x[it][1] = x[it][2] = x[it][3] = 0.f;
        // the partials of every block, kLoads blocks' loads in flight
        for (int b0 = 0; b0 < C; b0 += kLoads) {
          float4 y[kItems][kLoads];
#pragma unroll
          for (int it = 0; it < kItems; ++it) {
            const int i = it * kThreads + threadIdx.x;
            const int rl = i >> 4, c4 = (i & 15) * 4;
#pragma unroll
            for (int u = 0; u < kLoads; ++u)
              y[it][u] = rl < nown && b0 + u < C
                             ? *reinterpret_cast<const float4*>(
                                   cluster.map_shared_rank(pt, b0 + u) +
                                   (r_lo + rl) * kPartLd + c4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int it = 0; it < kItems; ++it)
#pragma unroll
            for (int u = 0; u < kLoads; ++u) {
              x[it][0] += y[it][u].x;
              x[it][1] += y[it][u].y;
              x[it][2] += y[it][u].z;
              x[it][3] += y[it][u].w;
            }
        }
#pragma unroll
        for (int it = 0; it < kItems; ++it) {
          const int i = it * kThreads + threadIdx.x;
          const int rl = i >> 4, c4 = (i & 15) * 4;
          const bool ok = rl < nown;
          const int row = tile0 + r_lo + rl;
          const int col = st.c * kChunk + c4;
          const float* br = a.bias && ok && row < L
                                ? a.bias + ((size_t)blockIdx.y * L + row) * S
                                : nullptr;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = x[it][e] * a.scale;
            if (br && col + e < S) v += br[col + e];
            if (col + e >= S) v = -INFINITY;
            else if (CAUSAL && col + e > row) v = kNegInf;
            x[it][e] = v;
          }
          if (mode == 1) {
            if (ok)
              *reinterpret_cast<float4*>(lg + rl * sc + col) =
                  make_float4(x[it][0], x[it][1], x[it][2], x[it][3]);
          } else if (mode == 2) {
            const float mn = fmaxf(
                m_run[it], row_max16(fmaxf(fmaxf(x[it][0], x[it][1]),
                                           fmaxf(x[it][2], x[it][3]))));
            const float mn2 = mn * kLog2e;
            const float sum =
                row_sum16(exp_from(x[it][0], mn2) + exp_from(x[it][1], mn2) +
                          exp_from(x[it][2], mn2) + exp_from(x[it][3], mn2));
            l_run[it] = l_run[it] * exp_from(m_run[it], mn2) + sum;
            m_run[it] = mn;
          } else if (ok) {
            *reinterpret_cast<uint2*>(wc + rl * kPLd + c4) =
                weights4<DROPOUT>(x[it], m_run[it] * kLog2e, 1.f / l_run[it],
                                  a.drop, DROPOUT ? row_term(row, salt) : 0u,
                                  col);
          }
        }
        if (mode == 3) {
          cluster.sync();  // the chunk's weights are in place
          gather_p(p, cluster, wc, kPLd, 0, C, warp, lane);
          ++pe;
        }
        if (t == s_steps - 1) {
          // the statistics are final: one pass, the exact row max and sum
          // over the logits, then the weights; two passes, the running ones
#pragma unroll
          for (int it = 0; it < kItems; ++it) {
            const int i = it * kThreads + threadIdx.x;
            const int rl = i >> 4, q16 = i & 15;
            const bool ok = rl < nown;
            const int row = tile0 + r_lo + rl;
            if (one) {
              const float* lr = lg + rl * sc;
              float mx = -INFINITY, sum = 0.f;
              if (ok) {
                for (int j = q16 * 4; j < n_chunks * kChunk; j += 64) {
                  const float4 y = *reinterpret_cast<const float4*>(lr + j);
                  mx = fmaxf(mx, fmaxf(fmaxf(y.x, y.y), fmaxf(y.z, y.w)));
                }
              }
              mx = row_max16(mx);
              const float m2 = mx * kLog2e;
              if (ok) {
                for (int j = q16 * 4; j < n_chunks * kChunk; j += 64) {
                  const float4 y = *reinterpret_cast<const float4*>(lr + j);
                  sum += exp_from(y.x, m2) + exp_from(y.y, m2) +
                         exp_from(y.z, m2) + exp_from(y.w, m2);
                }
              }
              sum = row_sum16(sum);
              m_run[it] = mx;
              l_run[it] = sum;
              if (ok) {
                const float inv = 1.f / sum;
                const unsigned int rt = DROPOUT ? row_term(row, salt) : 0u;
                for (int j = q16 * 4; j < n_chunks * kChunk; j += 64) {
                  const float4 y = *reinterpret_cast<const float4*>(lr + j);
                  const float xv[4] = {y.x, y.y, y.z, y.w};
                  *reinterpret_cast<uint2*>(wts + rl * wld + j) =
                      weights4<DROPOUT>(xv, m2, inv, a.drop, rt, j);
                }
              }
            }
            if (DROPOUT && ok && q16 == 0 && row < L) {
              a.stats[((size_t)bh * L + row) * 2] = m_run[it];
              a.stats[((size_t)bh * L + row) * 2 + 1] = l_run[it];
            }
          }
          if (one) cluster.sync();  // every block's weights are in place
        }
      }
    } else {
      const int u = st.j - st.g * kGroup;
      if (one && u == 0)
        gather_p(p, cluster, wts, wld, st.c * kChunk, C, warp, lane);
#pragma unroll
      for (int uu = 0; uu < kGroup; ++uu)
        if (uu == u) mma_a_rows<kWide, kNT / 2>(o[uu], p, stage, lane);
      if (st.c == n_chunks - 1 && u == st.w - 1) {
        // the group's columns are complete
        const int ra = tile0 + warp * 16 + (lane >> 2), rb = ra + 8;
#pragma unroll
        for (int uu = 0; uu < kGroup; ++uu) {
          if (uu < st.w) {
            bf16* ob = a.out + (size_t)bh * L * D +
                       (s_lo + st.g * kGroup + uu) * kWide;
#pragma unroll
            for (int j = 0; j < kDT; ++j) {
              const int col = j * 8 + c2;
              if (ra < L)
                *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)ra * D + col) =
                    __floats2bfloat162_rn(o[uu][j][0], o[uu][j][1]);
              if (rb < L)
                *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rb * D + col) =
                    __floats2bfloat162_rn(o[uu][j][2], o[uu][j][3]);
            }
          }
#pragma unroll
          for (int j = 0; j < kDT; ++j)
            o[uu][j][0] = o[uu][j][1] = o[uu][j][2] = o[uu][j][3] = 0.f;
        }
      }
    }
    __syncthreads();
  }
  cluster.sync();  // no block leaves while another may read its weights
}

// Whether `p` is a plan the kernel takes for nd slices and S keys (the
// plan kernels.wide_plan makes, with its shared bytes).
inline bool plan_ok(const Plan& p, int nd, int S) {
  return p.cluster >= kClusterMin && p.cluster <= kClusterMax &&
         p.cluster <= nd && p.slices == (nd + p.cluster - 1) / p.cluster &&
         (p.passes == 1 || p.passes == 2) &&
         p.smem == plan_smem(p.cluster, S, p.passes) && p.smem <= kSmemMax;
}

template <bool CAUSAL, bool DROPOUT>
inline int launch_fwd_wide(const mma::FwdArgs& a, int D, const Plan& p,
                           dim3 grid, cudaStream_t st) {
  static bool opted_in = false;
  void (*kernel)(mma::FwdArgs, int, Plan) =
      attention_fwd_wide_mma<CAUSAL, DROPOUT>;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a, D, p);
}

// Launches the bf16 wide forward for head size D (a multiple of kWide)
// over BH planes whose bias has `planes` planes (BH for the dropout
// forward) by the plan {cluster, slices, passes, shared bytes} of
// kernels.wide_plan; returns a cudaError_t code (cudaErrorInvalidValue for
// a plan the kernel does not take).
template <bool DROPOUT>
inline int run_fwd_mma(const mma::FwdArgs& a, int BH, int D, int causal,
                       int planes, const int* plan, cudaStream_t st) {
  if (!plan || D % kWide || planes <= 0 || BH % planes)
    return (int)cudaErrorInvalidValue;
  const Plan p{plan[0], plan[1], plan[2], plan[3]};
  if (!plan_ok(p, D / kWide, a.S)) return (int)cudaErrorInvalidValue;
  dim3 grid((a.L + kTile - 1) / kTile * p.cluster, planes, BH / planes);
  return causal ? launch_fwd_wide<true, DROPOUT>(a, D, p, grid, st)
                : launch_fwd_wide<false, DROPOUT>(a, D, p, grid, st);
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores in split TF32: the forward on the bf16 forward's
// plan, and the backward's dQ and dK / dV kernels on one skeleton
// ---------------------------------------------------------------------------

constexpr int kPadF32 = 4;                       // floats an f32 row is padded
constexpr int kLdF32 = kWide + kPadF32;          // floats a padded f32 row
constexpr int kPieceF32 = mma::kChunk * kLdF32;  // floats a 64-row piece
constexpr int kTileFloats = kTile * kPartLd;     // floats a 64 x 64 tile
static_assert(kLdF32 == tf32::Tile<kWide>::kStride,
              "the split-TF32 products read pieces at Tile<kWide>'s stride");
// kSplit x 4 warps a block: warp w takes the 16 rows (w % 4) * 16.. of
// the tile (its row group) and the part w / 4 of a chunk's 64 columns of S
// and dP, and of a slice's 64 output columns (kHalf columns a part). With
// one part (4 warps, a whole chunk a warp, 255 registers and spills, one
// block an SM by its shared memory) row 11's forward and backward at head
// size 512, B=16 took 0.32 and 1.20 ms, with two 0.22 and 0.72, with four
// 0.25 and 0.69 (an H100 80GB HBM3 at 700 W).
constexpr int kSplit = 2;
constexpr int kThreadsF32 = kSplit * kThreads;
constexpr int kHalf = mma::kChunk / kSplit;  // columns a warp's part
// Items of the reduction a thread takes: 16 lanes a row a chunk.
constexpr int kItemsF32 =
    (own_rows(kClusterMin) * 16 + kThreadsF32 - 1) / kThreadsF32;

// Whether a block of the f32 forward keeps its q slices (at most `slices`)
// in shared memory for the whole tile: the two-pass layout with them fits.
// (A ring of three stages ran no faster than two.)
__host__ __device__ constexpr bool fwd_resident_f32(int cluster, int slices) {
  return ((kStages + slices) * kPieceF32 + 2 * kTileFloats +
          2 * own_rows(cluster) * kPLd) * 4 <= kSmemMax;
}

// Dynamic shared bytes of an f32 forward plan: the cp.async ring (kStages
// stages of one piece, K or V, or of two, q beside K, where q is not
// resident), the resident q slices, two partial S tiles, and the block's
// own rows: one pass, their logits over every key, turned into weights in
// place (sc + 8 floats a row); two passes, two chunks of weights.
__host__ __device__ constexpr int plan_smem_f32(int cluster, int slices,
                                                int S, int passes) {
  return 4 * ((fwd_resident_f32(cluster, slices) ? kStages + slices
                                                 : 2 * kStages) *
                  kPieceF32 +
              2 * kTileFloats +
              (passes == 1 ? own_rows(cluster) *
                                 ((S + mma::kChunk - 1) / mma::kChunk *
                                      mma::kChunk + 8)
                           : 2 * own_rows(cluster) * kPLd));
}

// The backward's pieces, in either dtype: 64 rows x kWide, f32 rows padded
// by kPadF32 floats, bf16 rows by 8 halves (Chunk<kWide>).
__host__ __device__ constexpr int piece_bytes(bool b16) {
  return b16 ? Chunk<kWide>::kElems * 2 : kPieceF32 * 4;
}

// The backward's shared tiles: the partial S and dP (f32), and the pushed
// dS (dQ) or (P * mask)^T and dS^T (dK / dV), in the products' dtype (bf16
// rows of kPLd halves, f32 rows of kPartLd floats).
__host__ __device__ constexpr int bwd_tile_bytes(bool dkv, bool b16) {
  return 2 * kTileFloats * 4 + (dkv ? 2 : 1) * kTileFloats * (b16 ? 2 : 4);
}

// Whether a backward block keeps its own side (q and dO for dQ, K and V
// for dK / dV; at most `slices` pieces of each) in shared memory for the
// whole tile, the ring streaming the other side's two pieces a step.
__host__ __device__ constexpr bool bwd_resident(int slices, bool dkv,
                                                bool b16) {
  return (2 * slices + 2 * kStages) * piece_bytes(b16) +
             bwd_tile_bytes(dkv, b16) <= kSmemMax;
}

// Dynamic shared bytes of a backward block: the ring (two pieces a stage,
// four where the own side streams too), the resident pieces, the tiles.
__host__ __device__ constexpr int bwd_smem(int slices, bool dkv, bool b16) {
  return (bwd_resident(slices, dkv, b16) ? 2 * slices + 2 * kStages
                                         : 4 * kStages) *
             piece_bytes(b16) +
         bwd_tile_bytes(dkv, b16);
}

// bwd_smem's bytes for 1 .. kBwdSlicesMax slices a block (every plan up to
// head size 4608 at clusters of 8), [f32][dK / dV][slices - 1]: the numbers
// kernels.wide_bwd_smem gives (a CPU test reads this table), held to
// bwd_smem here.
constexpr int kBwdSlicesMax = 9;
constexpr int kBwdSmem[2][2][kBwdSlicesMax] = {
    {{101376, 119808, 138240, 156672, 175104, 193536, 211968, 230400, 119808},
     {110592, 129024, 147456, 165888, 184320, 202752, 221184, 129024, 129024}},
    {{159744, 194560, 229376, 194560, 194560, 194560, 194560, 194560, 194560},
     {178176, 212992, 212992, 212992, 212992, 212992, 212992, 212992, 212992}}};
constexpr bool bwd_smem_table_ok() {
  for (int f = 0; f < 2; ++f)
    for (int d = 0; d < 2; ++d)
      for (int s = 1; s <= kBwdSlicesMax; ++s)
        if (kBwdSmem[f][d][s - 1] != bwd_smem(s, d, !f)) return false;
  return true;
}
static_assert(bwd_smem_table_ok(), "kBwdSmem differs from bwd_smem");

// Rows r0 .. r0 + 63, kWide columns, of a (rows, stride) f32 matrix (src
// at the slice's first column) into a padded shared piece by the block's
// kThreadsF32 threads; rows at or past `limit` zero.
__device__ __forceinline__ void load_piece_f32(float* dst,
                                               const float* __restrict__ src,
                                               int r0, int limit, int stride) {
  constexpr int kPieces = kWide / 4;  // 16-byte pieces a row
  constexpr int kTotal = mma::kChunk * kPieces;
#pragma unroll
  for (int it = 0; it < kTotal / kThreadsF32; ++it) {
    const int i = it * kThreadsF32 + threadIdx.x;
    const int r = i / kPieces, c = (i % kPieces) * 4;
    const bool ok = r0 + r < limit;
    mma::cp_async16(dst + r * kLdF32 + c,
                    src + (size_t)(ok ? r0 + r : 0) * stride + c, ok);
  }
}

// A warp's 16 rows (row group rg) of a 64 x 64 f32 tile (kPartLd floats a
// row), NT column tiles from col0, as C tiles, in and out.
template <int NT>
__device__ __forceinline__ void get_tile(float (&c)[NT][4], const float* tile,
                                         int rg, int col0, int lane) {
  const float* p =
      tile + (rg * 16 + (lane >> 2)) * kPartLd + col0 + (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 x = *reinterpret_cast<const float2*>(p + n * 8);
    const float2 y = *reinterpret_cast<const float2*>(p + 8 * kPartLd + n * 8);
    c[n][0] = x.x;
    c[n][1] = x.y;
    c[n][2] = y.x;
    c[n][3] = y.y;
  }
}
template <int NT>
__device__ __forceinline__ void put_tile(float* tile, const float (&c)[NT][4],
                                         int rg, int col0, int lane) {
  float* p = tile + (rg * 16 + (lane >> 2)) * kPartLd + col0 + (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<float2*>(p + n * 8) = make_float2(c[n][0], c[n][1]);
    *reinterpret_cast<float2*>(p + 8 * kPartLd + n * 8) =
        make_float2(c[n][2], c[n][3]);
  }
}

// The reduce-scatter: x[it][n] = the sum over the cluster's blocks, in
// rank order, of the four floats at row r_lo + rl, columns c4.. of tile n
// (tiles + n * kTileFloats in each block's shared memory) for the thread's
// items i = it * kThreadsF32 + threadIdx.x (rl = i / 16, c4 = i % 16 * 4);
// zero past the block's nown rows. kLoads / N blocks' loads in flight.
template <int N>
__device__ __forceinline__ void reduce_rows(float (&x)[kItemsF32][N][4],
                                            cg::cluster_group& cluster,
                                            const float* tiles, int C,
                                            int r_lo, int nown) {
  constexpr int kB = kLoads / N;
#pragma unroll
  for (int it = 0; it < kItemsF32; ++it)
#pragma unroll
    for (int n = 0; n < N; ++n) x[it][n][0] = x[it][n][1] = x[it][n][2] = x[it][n][3] = 0.f;
  for (int b0 = 0; b0 < C; b0 += kB) {
    float4 y[kItemsF32][N][kB];
#pragma unroll
    for (int it = 0; it < kItemsF32; ++it) {
      const int i = it * kThreadsF32 + threadIdx.x;
      const int rl = i >> 4, c4 = (i & 15) * 4;
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int u = 0; u < kB; ++u)
          y[it][n][u] = rl < nown && b0 + u < C
                            ? *reinterpret_cast<const float4*>(
                                  cluster.map_shared_rank(tiles, b0 + u) +
                                  n * kTileFloats + (r_lo + rl) * kPartLd + c4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int it = 0; it < kItemsF32; ++it)
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          x[it][n][0] += y[it][n][u].x;
          x[it][n][1] += y[it][n][u].y;
          x[it][n][2] += y[it][n][u].z;
          x[it][n][3] += y[it][n][u].w;
        }
  }
}

// The weights of a warp's 16 rows (row group rg) for one 64-key chunk as
// C tiles (the A operand of P . V in tf32::mma_rows' order), from the
// blocks that own the rows: `w` is a block's (local) f32 weights, `ld`
// floats a row, col0 the chunk's first column there.
__device__ __forceinline__ void gather_w(float (&p)[mma::kChunk / 8][4],
                                         cg::cluster_group& cluster,
                                         const float* w, int ld, int col0,
                                         int C, int rg, int lane) {
  const int ta = rg * 16 + (lane >> 2), tb = ta + 8;  // rows of the tile
  const int oa = (C * (ta + 1) - 1) / kTile, ob = (C * (tb + 1) - 1) / kTile;
  const int c = col0 + (lane & 3) * 2;
  const float* pa = cluster.map_shared_rank(w, oa) +
                    (ta - oa * kTile / C) * ld + c;
  const float* pb = cluster.map_shared_rank(w, ob) +
                    (tb - ob * kTile / C) * ld + c;
#pragma unroll
  for (int n = 0; n < mma::kChunk / 8; ++n) {
    const float2 x = *reinterpret_cast<const float2*>(pa + n * 8);
    const float2 y = *reinterpret_cast<const float2*>(pb + n * 8);
    p[n][0] = x.x;
    p[n][1] = x.y;
    p[n][2] = y.x;
    p[n][3] = y.y;
  }
}

// Four weights exp(x - m) / l [* the dropout factor] of a row from column
// col, f32.
template <bool DROPOUT>
__device__ __forceinline__ float4 weights4_f32(const float (&x)[4], float ml2,
                                               float inv, const DropoutSpec& d,
                                               unsigned int rt, int col) {
  float w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    w[e] = mma::exp_from(x[e], ml2) * inv;
    if (DROPOUT && d.apply) w[e] *= mma::keep_factor(d, rt, mma::col_term(col + e));
  }
  return make_float4(w[0], w[1], w[2], w[3]);
}

// The f32 forward: attention_fwd_wide_mma's steps, exchanges and owners on
// split-TF32 products. grid (query tiles x cluster, planes, BH / planes),
// clusters of plan.cluster blocks along x.
template <bool CAUSAL, bool DROPOUT>
__global__ void __launch_bounds__(kThreadsF32)
attention_fwd_wide_tf32(tf32::FwdArgs a, int D, Plan plan) {
  using namespace mma;
  constexpr int kNT = kChunk / 8;  // key tiles of a chunk
  constexpr int kNH = kHalf / 8;   // key tiles of a warp's half
  constexpr int kDH = kHalf / 8;   // column tiles of a warp's half slice
  cg::cluster_group cluster = cg::this_cluster();
  const int C = plan.cluster, rank = (int)cluster.block_rank();
  const int nd = D / kWide;
  const int s_lo = rank * nd / C, nsl = (rank + 1) * nd / C - s_lo;
  const int r_lo = rank * kTile / C, nown = (rank + 1) * kTile / C - r_lo;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 3, h0 = (warp >> 2) * kHalf;  // rows, columns
  const int c2 = (lane & 3) * 2;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const int L = a.L, S = a.S;
  const int tile0 = (blockIdx.x / C) * kTile;
  const float* qb = a.q + (size_t)bh * L * D;
  const float* kb = a.k + (size_t)bh * S * D;
  const float* vb = a.v + (size_t)bh * S * D;
  const int n_all = (S + kChunk - 1) / kChunk;
  const int n_chunks = CAUSAL ? min(n_all, tile0 / kChunk + 1) : n_all;
  const int sc = n_all * kChunk;  // keys a row of logits holds
  const int rows = own_rows(C);
  const bool one = plan.passes == 1;
  const bool res = fwd_resident_f32(C, plan.slices);
  const unsigned int salt = DROPOUT ? drop_salt(a.seed, a.drop, bh) : 0u;

  // shared memory (plan_smem_f32): ring [kStages][K or V (, q)], the
  // resident q slices [plan.slices], partials [2], then one pass: logits,
  // then weights, [rows][sc + 8]; two passes: weight chunks [2][rows][kPLd]
  float* ring = reinterpret_cast<float*>(attn_smem);
  const int stage_len = (res ? 1 : 2) * kPieceF32;
  float* qres = ring + kStages * stage_len;
  float* part = qres + (res ? plan.slices * kPieceF32 : 0);
  float* wts = part + 2 * kTileFloats;
  const int wld = one ? sc + 8 : kPLd;

  // the steps, as attention_fwd_wide_mma's
  const int s_steps = n_chunks * nsl;
  const int n_groups = (plan.slices + kGroup - 1) / kGroup;
  const int full = one ? kGroup * n_chunks : (nsl + kGroup) * n_chunks;
  const int steps =
      s_steps + (one ? s_steps : n_chunks * (n_groups * nsl + nsl));
  struct Step {
    int kind, c, j, g, w;
  };
  auto step_at = [&](int t) -> Step {
    if (t < s_steps) return Step{0, t / nsl, t % nsl, 0, 0};
    t -= s_steps;
    const int gi = t / full;
    t -= gi * full;
    const int w = max(0, min(kGroup, nsl - gi * kGroup));
    if (one) return Step{1, t / w, gi * kGroup + t % w, gi, w};
    const int c = t / (nsl + w), k = t % (nsl + w);
    return k < nsl ? Step{0, c, k, gi, w}
                   : Step{1, c, gi * kGroup + k - nsl, gi, w};
  };
  auto issue = [&](int t) {
    if (t < steps) {
      const Step s = step_at(t);
      float* st = ring + (t % kStages) * stage_len;
      const int col = (s_lo + s.j) * kWide;
      load_piece_f32(st, (s.kind == 0 ? kb : vb) + col, s.c * kChunk, S, D);
      if (s.kind == 0 && !res)
        load_piece_f32(st + kPieceF32, qb + col, tile0, L, D);
    }
    cp_async_commit();
  };
  if (res)  // the resident q slices join the first stage's group
    for (int j = 0; j < nsl; ++j)
      load_piece_f32(qres + j * kPieceF32, qb + (s_lo + j) * kWide, tile0, L,
                     D);

  float s[kNH][4], o[kGroup][kDH][4], p[kNT][4];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) tf32::zero(o[u]);
  float m_run[kItemsF32], l_run[kItemsF32];
#pragma unroll
  for (int it = 0; it < kItemsF32; ++it) {
    m_run[it] = -INFINITY;
    l_run[it] = 0.f;
  }
  int ex = 0, pe = 0;  // exchanges of partials; of weight chunks

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < steps; ++t) {
    issue(t + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const Step st = step_at(t);
    const float* stage = ring + (t % kStages) * stage_len;
    if (st.kind == 0) {
      if (st.j == 0) tf32::zero(s);
      tf32::OwnRows<kWide, true> q;
      q.s = (res ? qres + st.j * kPieceF32 : stage + kPieceF32) +
            rg * 16 * kLdF32;
      tf32::mma_rowsT<kWide, kNH, true>(s, q, stage + h0 * kLdF32, lane);
      if (st.j == nsl - 1) {
        // the exchange of this chunk, as attention_fwd_wide_mma's (modes 1
        // logits, 2 running max and sum, 3 weights), two partial buffers
        float* pt = part + (ex++ & 1) * kTileFloats;
        put_tile(pt, s, rg, h0, lane);
        cluster.sync();  // every block's partial is in place
        const int mode = t < s_steps ? (one ? 1 : 2) : 3;
        float* wc = wts + (pe & 1) * rows * kPLd;  // mode 3's weight chunk
        float x[kItemsF32][1][4];
        reduce_rows<1>(x, cluster, pt, C, r_lo, nown);
#pragma unroll
        for (int it = 0; it < kItemsF32; ++it) {
          const int i = it * kThreadsF32 + threadIdx.x;
          const int rl = i >> 4, c4 = (i & 15) * 4;
          const bool ok = rl < nown;
          const int row = tile0 + r_lo + rl;
          const int col = st.c * kChunk + c4;
          const float* br = a.bias && ok && row < L
                                ? a.bias + ((size_t)blockIdx.y * L + row) * S
                                : nullptr;
          float* xv = x[it][0];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = xv[e] * a.scale;
            if (br && col + e < S) v += br[col + e];
            if (col + e >= S) v = -INFINITY;
            else if (CAUSAL && col + e > row) v = kNegInf;
            xv[e] = v;
          }
          if (mode == 1) {
            if (ok)
              *reinterpret_cast<float4*>(wts + rl * wld + col) =
                  make_float4(xv[0], xv[1], xv[2], xv[3]);
          } else if (mode == 2) {
            const float mn = fmaxf(
                m_run[it], row_max16(fmaxf(fmaxf(xv[0], xv[1]),
                                           fmaxf(xv[2], xv[3]))));
            const float mn2 = mn * kLog2e;
            const float sum =
                row_sum16(exp_from(xv[0], mn2) + exp_from(xv[1], mn2) +
                          exp_from(xv[2], mn2) + exp_from(xv[3], mn2));
            l_run[it] = l_run[it] * exp_from(m_run[it], mn2) + sum;
            m_run[it] = mn;
          } else if (ok) {
            *reinterpret_cast<float4*>(wc + rl * kPLd + c4) =
                weights4_f32<DROPOUT>(x[it][0], m_run[it] * kLog2e,
                                      1.f / l_run[it], a.drop,
                                      DROPOUT ? row_term(row, salt) : 0u, col);
          }
        }
        if (mode == 3) {
          cluster.sync();  // the chunk's weights are in place
          gather_w(p, cluster, wc, kPLd, 0, C, rg, lane);
          ++pe;
        }
        if (t == s_steps - 1) {
          // the statistics are final: one pass, the exact row max and sum
          // over the logits, then the weights in their place; two passes,
          // the running ones
#pragma unroll
          for (int it = 0; it < kItemsF32; ++it) {
            const int i = it * kThreadsF32 + threadIdx.x;
            const int rl = i >> 4, q16 = i & 15;
            const bool ok = rl < nown;
            const int row = tile0 + r_lo + rl;
            if (one) {
              float* lr = wts + rl * wld;
              float mx = -INFINITY, sum = 0.f;
              if (ok) {
                for (int j = q16 * 4; j < n_chunks * kChunk; j += 64) {
                  const float4 y = *reinterpret_cast<const float4*>(lr + j);
                  mx = fmaxf(mx, fmaxf(fmaxf(y.x, y.y), fmaxf(y.z, y.w)));
                }
              }
              mx = row_max16(mx);
              const float m2 = mx * kLog2e;
              if (ok) {
                for (int j = q16 * 4; j < n_chunks * kChunk; j += 64) {
                  const float4 y = *reinterpret_cast<const float4*>(lr + j);
                  sum += exp_from(y.x, m2) + exp_from(y.y, m2) +
                         exp_from(y.z, m2) + exp_from(y.w, m2);
                }
              }
              sum = row_sum16(sum);
              m_run[it] = mx;
              l_run[it] = sum;
              if (ok) {
                const float inv = 1.f / sum;
                const unsigned int rt = DROPOUT ? row_term(row, salt) : 0u;
                for (int j = q16 * 4; j < n_chunks * kChunk; j += 64) {
                  const float4 y = *reinterpret_cast<const float4*>(lr + j);
                  const float xw[4] = {y.x, y.y, y.z, y.w};
                  *reinterpret_cast<float4*>(lr + j) =
                      weights4_f32<DROPOUT>(xw, m2, inv, a.drop, rt, j);
                }
              }
            }
            if (DROPOUT && ok && q16 == 0 && row < L) {
              a.stats[((size_t)bh * L + row) * 2] = m_run[it];
              a.stats[((size_t)bh * L + row) * 2 + 1] = l_run[it];
            }
          }
          if (one) cluster.sync();  // every block's weights are in place
        }
      }
    } else {
      const int u = st.j - st.g * kGroup;
      if (one && u == 0)
        gather_w(p, cluster, wts, wld, st.c * kChunk, C, rg, lane);
#pragma unroll
      for (int uu = 0; uu < kGroup; ++uu)
        if (uu == u) tf32::mma_rows<kWide, kNT, kDH>(o[uu], p, stage, h0, lane);
      if (st.c == n_chunks - 1 && u == st.w - 1) {
        // the group's columns are complete
        const int ra = tile0 + rg * 16 + (lane >> 2), rb = ra + 8;
#pragma unroll
        for (int uu = 0; uu < kGroup; ++uu) {
          if (uu < st.w) {
            float* ob = a.out + (size_t)bh * L * D +
                        (s_lo + st.g * kGroup + uu) * kWide + h0;
#pragma unroll
            for (int j = 0; j < kDH; ++j) {
              const int col = j * 8 + c2;
              if (ra < L)
                *reinterpret_cast<float2*>(ob + (size_t)ra * D + col) =
                    make_float2(o[uu][j][0], o[uu][j][1]);
              if (rb < L)
                *reinterpret_cast<float2*>(ob + (size_t)rb * D + col) =
                    make_float2(o[uu][j][2], o[uu][j][3]);
            }
          }
          tf32::zero(o[uu]);
        }
      }
    }
    __syncthreads();
  }
  cluster.sync();  // no block leaves while another may read its weights
}

// What the backward body does differently in each dtype (BwdOps<E>, E the
// element of q, K, V and the gradients): its pieces (cp.async by the
// block's kThreadsF32 threads), its products (f32: split TF32, the pushed
// tiles read as C tiles; bf16: mma.sync m16n8k16 with f32 accumulators,
// the A operands of the own rows and of the pushed tiles by ldmatrix, the
// B operand of a product with a piece by ldmatrix.trans), the pushed
// values (bf16: rounded, as the narrow kernels round P * mask and dS) and
// the stores.
template <typename E> struct BwdOps;

template <> struct BwdOps<float> {
  static constexpr int kPiece = kPieceF32;  // floats a piece
  using Pushed = float[mma::kChunk / 8][4];  // a warp's rows of a pushed tile
  __device__ static void load(float* dst, const float* src, int r0, int limit,
                              int stride) {
    load_piece_f32(dst, src, r0, limit, stride);
  }
  // c (16 x kHalf) += the X piece's rows rg * 16.. . the U piece's rows
  // h0..^T
  __device__ static void part(float (&c)[kHalf / 8][4], const float* x,
                              const float* u, int rg, int h0, int lane) {
    tf32::OwnRows<kWide, true> xr;
    xr.s = x + rg * 16 * kLdF32;
    tf32::mma_rowsT<kWide, kHalf / 8, true>(c, xr, u + h0 * kLdF32, lane);
  }
  __device__ static void get(Pushed& p, const float* tile, int rg, int lane) {
    get_tile(p, tile, rg, 0, lane);
  }
  // acc (16 x kHalf, the piece's columns h0..) += p . the piece
  __device__ static void prod(float (&acc)[kHalf / 8][4], const Pushed& p,
                              const float* piece, int h0, int lane) {
    tf32::mma_rows<kWide, mma::kChunk / 8, kHalf / 8>(acc, p, piece, h0, lane);
  }
  __device__ static void push(float* dst, const float (&o)[4]) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  }
  __device__ static void store2(float* dst, float x, float y) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  }
  // d + the dot product of N columns of x and y
  template <int N>
  __device__ static float dot(const float* x, const float* y, float d) {
    const float4* xr = reinterpret_cast<const float4*>(x);
    const float4* yr = reinterpret_cast<const float4*>(y);
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 u = xr[c], w = yr[c];
      d = fmaf(u.x, w.x, d);
      d = fmaf(u.y, w.y, d);
      d = fmaf(u.z, w.z, d);
      d = fmaf(u.w, w.w, d);
    }
    return d;
  }
};

template <> struct BwdOps<bf16> {
  static constexpr int kPiece = Chunk<kWide>::kElems;  // halves a piece
  using Pushed = uint32_t[mma::kChunk / 16][4];         // A operands
  __device__ static void load(bf16* dst, const bf16* src, int r0, int limit,
                              int stride) {
    load_chunk_s<kThreadsF32>(dst, src, r0, limit, stride);
  }
  __device__ static void part(float (&c)[kHalf / 8][4], const bf16* x,
                              const bf16* u, int rg, int h0, int lane) {
    uint32_t xf[kWide / 16][4];
    load_a_piece(xf, x, rg, lane);
    mma::mma_a_rowsT<kWide, kHalf / 8>(c, xf, u + h0 * Chunk<kWide>::kStride,
                                       lane);
  }
  __device__ static void get(Pushed& p, const bf16* tile, int rg, int lane) {
    load_a_piece(p, tile, rg, lane);
  }
  __device__ static void prod(float (&acc)[kHalf / 8][4], const Pushed& p,
                              const bf16* piece, int h0, int lane) {
    const int lr = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int lc = (lane >> 4) << 3;
#pragma unroll
    for (int j = 0; j < mma::kChunk / 16; ++j) {
#pragma unroll
      for (int n = 0; n < kHalf / 8; n += 2) {
        uint32_t b[4];
        mma::ldmatrix_x4_trans(b, piece + (j * 16 + lr) * Chunk<kWide>::kStride +
                                      h0 + n * 8 + lc);
        mma::mma_bf16(acc[n], p[j], b[0], b[1]);
        mma::mma_bf16(acc[n + 1], p[j], b[2], b[3]);
      }
    }
  }
  __device__ static void push(bf16* dst, const float (&o)[4]) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(mma::pack_bf16(o[0], o[1]), mma::pack_bf16(o[2], o[3]));
  }
  __device__ static void store2(bf16* dst, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
  }
  template <int N>
  __device__ static float dot(const bf16* x, const bf16* y, float d) {
    const uint4* xr = reinterpret_cast<const uint4*>(x);
    const uint4* yr = reinterpret_cast<const uint4*>(y);
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      const uint4 u = xr[c], w = yr[c];
      const uint32_t us[4] = {u.x, u.y, u.z, u.w}, ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 p = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&us[e]));
        const float2 q = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ws[e]));
        d = fmaf(p.x, q.x, d);
        d = fmaf(p.y, q.y, d);
      }
    }
    return d;
  }
};

// The backward, one body for both kernels and both dtypes (Args is
// tf32::BwdArgs or mma::BwdArgs). DKV false, dQ, D and dbias: a cluster a
// 64-row query tile, chunks of 64 keys (under causal none past the tile's
// diagonal chunk). DKV true, dK and dV: a cluster a 64-row key tile,
// chunks of 64 queries (under causal from the tile's diagonal chunk). The
// own side X, Y (q, dO; or K, V) against the streamed U, V (K, V; or q,
// dO). Per group of kGroup slices and chunk: the chunk's S steps, one a
// slice of the block's, add X_j U_j^T and Y_j V_j^T into the partial S and
// dP tiles; the last ends in the exchange: a cluster barrier, each owner
// sums its rows of both over the cluster (dQ: and, at the first, its rows'
// D partials, kept in the S tile's padding column kChunk), forms dS (dQ:
// P from the stats, dS = P (dP * mask - D), dbias in the first group, f32;
// dK / dV: P^T and dS^T from the stats and dsum) and pushes it into every
// block's shared memory, and a second barrier. Then the group's product
// steps, one a slice: dQ += dS U_j; or dV += (P * mask)^T V_j and dK +=
// dS^T U_j. Every block of a cluster makes the same exchanges (the groups
// are counted from plan.slices). grid (tiles x cluster, BH).
template <typename Args, bool DKV, bool CAUSAL>
__device__ __forceinline__ void bwd_wide_body(const Args& a, int D,
                                              const Plan& plan) {
  using namespace mma;
  using E = std::remove_const_t<std::remove_pointer_t<decltype(Args::q)>>;
  using Ops = BwdOps<E>;
  constexpr int kPiece = Ops::kPiece;  // elements a piece
  constexpr int kNT = kChunk / 8;  // tiles of a chunk
  constexpr int kNH = kHalf / 8;   // tiles of a warp's half chunk
  constexpr int kDH = kHalf / 8;   // column tiles of a warp's half slice
  cg::cluster_group cluster = cg::this_cluster();
  const int C = plan.cluster, rank = (int)cluster.block_rank();
  const int nd = D / kWide;
  const int s_lo = rank * nd / C, nsl = (rank + 1) * nd / C - s_lo;
  const int r_lo = rank * kTile / C, nown = (rank + 1) * kTile / C - r_lo;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 3, h0 = (warp >> 2) * kHalf;  // rows, columns
  const int c2 = (lane & 3) * 2;
  const int bh = blockIdx.y;
  const int L = a.L, S = a.S;
  const int tile0 = (blockIdx.x / C) * kTile;
  const int n_own = DKV ? S : L;  // rows of the tile's side
  const int n_oth = DKV ? L : S;  // rows of the chunks' side
  const size_t qoff = (size_t)bh * L * D, koff = (size_t)bh * S * D;
  const E* xg = DKV ? a.k + koff : a.q + qoff;
  const E* yg = DKV ? a.v + koff : a.dout + qoff;
  const E* ug = DKV ? a.q + qoff : a.k + koff;
  const E* vg = DKV ? a.dout + qoff : a.v + koff;
  const int n_all = (n_oth + kChunk - 1) / kChunk;
  const int first = DKV && CAUSAL ? tile0 / kChunk : 0;
  const int n_chunks =
      (!DKV && CAUSAL ? min(n_all, tile0 / kChunk + 1) : n_all) - first;
  const bool res =
      bwd_resident(plan.slices, DKV, !std::is_same_v<E, float>);
  const bool drop = a.drop.apply != 0;
  const unsigned int salt = drop ? drop_salt(a.seed, a.drop, bh) : 0u;

  // shared memory (bwd_smem): ring [kStages][U, V (, X, Y)], resident X
  // [plan.slices] and Y [plan.slices], the partial S and dP tiles, the
  // pushed tiles (dS; or (P * mask)^T and dS^T)
  E* ring = reinterpret_cast<E*>(attn_smem);
  const int stage_len = (res ? 2 : 4) * kPiece;
  E* xres = ring + kStages * stage_len;
  E* yres = xres + (res ? plan.slices * kPiece : 0);
  float* part = reinterpret_cast<float*>(yres + (res ? plan.slices * kPiece : 0));
  E* pushed = reinterpret_cast<E*>(part + 2 * kTileFloats);

  const int n_groups = (plan.slices + kGroup - 1) / kGroup;
  const int full = (nsl + kGroup) * n_chunks;
  const int steps = n_chunks * (n_groups * nsl + nsl);
  struct Step {
    int kind, c, j, g, w;  // 0 S / 1 product, chunk (from first), slice
                           // (of the block's), group, the group's width
  };
  auto step_at = [&](int t) -> Step {
    const int gi = t / full;
    t -= gi * full;
    const int w = max(0, min(kGroup, nsl - gi * kGroup));
    const int c = t / (nsl + w), k = t % (nsl + w);
    return k < nsl ? Step{0, c, k, gi, w}
                   : Step{1, c, gi * kGroup + k - nsl, gi, w};
  };
  auto issue = [&](int t) {
    if (t < steps) {
      const Step s = step_at(t);
      E* st = ring + (t % kStages) * stage_len;
      const int col = (s_lo + s.j) * kWide, r0 = (first + s.c) * kChunk;
      Ops::load(st, ug + col, r0, n_oth, D);
      if (s.kind == 0 || DKV) Ops::load(st + kPiece, vg + col, r0, n_oth, D);
      if (s.kind == 0 && !res) {
        Ops::load(st + 2 * kPiece, xg + col, tile0, n_own, D);
        Ops::load(st + 3 * kPiece, yg + col, tile0, n_own, D);
      }
    }
    cp_async_commit();
  };
  if (res)  // the resident pieces join the first stage's group
    for (int j = 0; j < nsl; ++j) {
      const int col = (s_lo + j) * kWide;
      Ops::load(xres + j * kPiece, xg + col, tile0, n_own, D);
      Ops::load(yres + j * kPiece, yg + col, tile0, n_own, D);
    }
  if (!DKV) {
    // the block's partial of D = rowsum(dO * O) over its slices, kPer
    // threads a row, into the S tile's padding column
    constexpr int kPer = kThreadsF32 / kTile;
    const int r = threadIdx.x / kPer, q0 = threadIdx.x % kPer;
    float d = 0.f;
    if (tile0 + r < L) {
      const size_t at = qoff + (size_t)(tile0 + r) * D + q0 * (kWide / kPer);
      for (int j = 0; j < nsl; ++j)
        d = Ops::template dot<kWide / kPer>(a.dout + at + (s_lo + j) * kWide,
                                            a.out + at + (s_lo + j) * kWide, d);
    }
#pragma unroll
    for (int o = 1; o < kPer; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (q0 == 0) part[r * kPartLd + kChunk] = d;
  }
  // the owner's rows: dQ, m log2(e) and 1 / l from the stats and the mask
  // hash's row term; dK / dV, the key's column term
  float ma2[kItemsF32], inv[kItemsF32], dv_row[kItemsF32];
  unsigned int term[kItemsF32];
#pragma unroll
  for (int it = 0; it < kItemsF32; ++it) {
    const int i = it * kThreadsF32 + threadIdx.x;
    const int rl = i >> 4, row = tile0 + r_lo + rl;
    const bool live = rl < nown && row < n_own;
    ma2[it] = 0.f;
    inv[it] = 1.f;
    dv_row[it] = 0.f;
    if (!DKV && live) {
      ma2[it] = a.stats[((size_t)bh * L + row) * 2] * kLog2e;
      inv[it] = 1.f / a.stats[((size_t)bh * L + row) * 2 + 1];
    }
    term[it] = DKV ? col_term(row) : row_term(row, salt);
  }

  float acc[kGroup][kDH][4];               // dQ, or dK
  float acc2[DKV ? kGroup : 1][kDH][4];    // dV
#pragma unroll
  for (int u = 0; u < kGroup; ++u) tf32::zero(acc[u]);
#pragma unroll
  for (int u = 0; u < (DKV ? kGroup : 1); ++u) tf32::zero(acc2[u]);
  int ex = 0;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < steps; ++t) {
    issue(t + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const Step st = step_at(t);
    const E* stage = ring + (t % kStages) * stage_len;
    if (st.kind == 0) {
      // the block's partials of S and dP, added in their shared tiles
      const E* x = res ? xres + st.j * kPiece : stage + 2 * kPiece;
      const E* y = res ? yres + st.j * kPiece : stage + 3 * kPiece;
      float c[kNH][4];
      if (st.j == 0) tf32::zero(c); else get_tile(c, part, rg, h0, lane);
      Ops::part(c, x, stage, rg, h0, lane);
      put_tile(part, c, rg, h0, lane);
      if (st.j == 0) tf32::zero(c);
      else get_tile(c, part + kTileFloats, rg, h0, lane);
      Ops::part(c, y, stage + kPiece, rg, h0, lane);
      put_tile(part + kTileFloats, c, rg, h0, lane);
      if (st.j == nsl - 1) {
        cluster.sync();  // every block's partials are in place
        float x2[kItemsF32][2][4];  // S, dP
        reduce_rows<2>(x2, cluster, part, C, r_lo, nown);
        const int col0 = (first + st.c) * kChunk;
#pragma unroll
        for (int it = 0; it < kItemsF32; ++it) {
          const int i = it * kThreadsF32 + threadIdx.x;
          const int rl = i >> 4, c4 = (i & 15) * 4;
          const bool ok = rl < nown;
          const int row = tile0 + r_lo + rl;
          const bool live = ok && row < n_own;
          float o1[4], o2[4];  // dS; or (P * mask)^T and dS^T
          if constexpr (!DKV) {
            if (ex == 0) {  // D: the blocks' partials, in rank order
              float y[kClusterMax], d = 0.f;
#pragma unroll
              for (int b = 0; b < kClusterMax; ++b)
                y[b] = ok && b < C ? cluster.map_shared_rank(part, b)[
                                         (r_lo + rl) * kPartLd + kChunk]
                                   : 0.f;
#pragma unroll
              for (int b = 0; b < kClusterMax; ++b) d += y[b];
              dv_row[it] = d;
              if (live && (i & 15) == 0) a.dsum[(size_t)bh * L + row] = d;
            }
            const float* br = a.bias && live
                                  ? a.bias + ((size_t)bh * L + row) * S
                                  : nullptr;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = col0 + c4 + e;
              float v = x2[it][0][e] * a.scale;
              if (br && col < S) v += br[col];
              if (col >= S) v = -INFINITY;
              else if (CAUSAL && col > row) v = kNegInf;
              const float pr = exp_from(v, ma2[it]) * inv[it];
              const float f =
                  drop ? keep_factor(a.drop, term[it], col_term(col)) : 1.f;
              o1[e] = live ? pr * (x2[it][1][e] * f - dv_row[it]) : 0.f;
              o2[e] = 0.f;
            }
            if (live && a.dbias && st.g == 0) {
              float* db = a.dbias + ((size_t)bh * L + row) * S;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (col0 + c4 + e < S) db[col0 + c4 + e] = o1[e];
            }
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qr = col0 + c4 + e;  // the query
              float pm = 0.f, ds = 0.f;
              if (live && qr < L) {
                const size_t qi = (size_t)bh * L + qr;
                const float2 ml = *reinterpret_cast<const float2*>(a.stats + qi * 2);
                float v = x2[it][0][e] * a.scale;
                if (a.bias) v += a.bias[qi * S + row];
                if (CAUSAL && row > qr) v = kNegInf;
                const float pr = exp_from(v, ml.x * kLog2e) * (1.f / ml.y);
                const float f =
                    drop ? keep_factor(a.drop, row_term(qr, salt), term[it])
                         : 1.f;
                pm = pr * f;
                ds = pr * (x2[it][1][e] * f - a.dsum[qi]);
              }
              o1[e] = pm;
              o2[e] = ds;
            }
          }
          if (ok)  // pushed into every block of the cluster
            for (int b = 0; b < C; ++b) {
              E* dst = cluster.map_shared_rank(pushed, b) +
                       (r_lo + rl) * kPartLd + c4;
              Ops::push(dst, o1);
              if (DKV) Ops::push(dst + kTileFloats, o2);
            }
        }
        cluster.sync();  // every owner's rows are in every block
        ++ex;
      }
    } else {
      const int u = st.j - st.g * kGroup;
      typename Ops::Pushed p;
      Ops::get(p, pushed, rg, lane);
      if constexpr (!DKV) {
#pragma unroll
        for (int uu = 0; uu < kGroup; ++uu)
          if (uu == u) Ops::prod(acc[uu], p, stage, h0, lane);
      } else {
#pragma unroll
        for (int uu = 0; uu < kGroup; ++uu)
          if (uu == u) Ops::prod(acc2[uu], p, stage + kPiece, h0, lane);
        Ops::get(p, pushed + kTileFloats, rg, lane);
#pragma unroll
        for (int uu = 0; uu < kGroup; ++uu)
          if (uu == u) Ops::prod(acc[uu], p, stage, h0, lane);
      }
      if (st.c == n_chunks - 1 && u == st.w - 1) {
        // the group's columns are complete: dQ (or dK) * scale, dV
        const int ra = tile0 + rg * 16 + (lane >> 2), rb = ra + 8;
#pragma unroll
        for (int uu = 0; uu < kGroup; ++uu) {
          if (uu < st.w) {
            const size_t off = (DKV ? koff : qoff) +
                               (s_lo + st.g * kGroup + uu) * kWide + h0;
            E* o1 = (DKV ? a.dk : a.dq) + off;
#pragma unroll
            for (int j = 0; j < kDH; ++j) {
              const int col = j * 8 + c2;
              if (ra < n_own)
                Ops::store2(o1 + (size_t)ra * D + col, acc[uu][j][0] * a.scale,
                            acc[uu][j][1] * a.scale);
              if (rb < n_own)
                Ops::store2(o1 + (size_t)rb * D + col, acc[uu][j][2] * a.scale,
                            acc[uu][j][3] * a.scale);
            }
            if constexpr (DKV) {
              E* o2 = a.dv + off;
#pragma unroll
              for (int j = 0; j < kDH; ++j) {
                const int col = j * 8 + c2;
                if (ra < n_own)
                  Ops::store2(o2 + (size_t)ra * D + col, acc2[uu][j][0],
                              acc2[uu][j][1]);
                if (rb < n_own)
                  Ops::store2(o2 + (size_t)rb * D + col, acc2[uu][j][2],
                              acc2[uu][j][3]);
              }
              tf32::zero(acc2[uu]);
            }
          }
          tf32::zero(acc[uu]);
        }
      }
    }
    __syncthreads();
  }
  if (!DKV && CAUSAL && a.dbias) {
    // the key chunks past the tile's diagonal: dS is exactly 0 there
#pragma unroll
    for (int it = 0; it < kItemsF32; ++it) {
      const int i = it * kThreadsF32 + threadIdx.x;
      const int rl = i >> 4, row = tile0 + r_lo + rl;
      if (rl >= nown || row >= L) continue;
      float* db = a.dbias + ((size_t)bh * L + row) * S;
      for (int col = n_chunks * kChunk + (i & 15) * 4; col < S; col += kChunk)
        for (int e = 0; e < 4 && col + e < S; ++e) db[col + e] = 0.f;
    }
  }
}

// The four backward kernels: dQ (with D and dbias) and dK / dV, f32 in
// split TF32 and bf16.
template <bool CAUSAL>
__global__ void __launch_bounds__(kThreadsF32)
attention_dq_wide_tf32(tf32::BwdArgs a, int D, Plan plan) {
  bwd_wide_body<tf32::BwdArgs, false, CAUSAL>(a, D, plan);
}

template <bool CAUSAL>
__global__ void __launch_bounds__(kThreadsF32)
attention_dkv_wide_tf32(tf32::BwdArgs a, int D, Plan plan) {
  bwd_wide_body<tf32::BwdArgs, true, CAUSAL>(a, D, plan);
}

template <bool CAUSAL>
__global__ void __launch_bounds__(kThreadsF32)
attention_dq_wide_mma(mma::BwdArgs a, int D, Plan plan) {
  bwd_wide_body<mma::BwdArgs, false, CAUSAL>(a, D, plan);
}

template <bool CAUSAL>
__global__ void __launch_bounds__(kThreadsF32)
attention_dkv_wide_mma(mma::BwdArgs a, int D, Plan plan) {
  bwd_wide_body<mma::BwdArgs, true, CAUSAL>(a, D, plan);
}

// Launches one of the f32 forward's or the backward's kernels as clusters of p.cluster blocks along x
// with p.smem dynamic shared bytes (the instance opted in to kSmemMax once,
// `opted_in`); returns a cudaError_t code.
template <typename Args>
inline int launch_cluster(void (*kernel)(Args, int, Plan), bool& opted_in,
                          const Args& a, int D, const Plan& p, dim3 grid,
                          cudaStream_t st) {
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreadsF32);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a, D, p);
}

// A cluster of kClusterMin .. kClusterMax blocks, at most one a slice, and
// ceil(nd / cluster) slices a block at most.
inline bool cluster_ok(const Plan& p, int nd) {
  return p.cluster >= kClusterMin && p.cluster <= kClusterMax &&
         p.cluster <= nd && p.slices == (nd + p.cluster - 1) / p.cluster;
}

template <bool CAUSAL, bool DROPOUT>
inline int launch_fwd_tf32(const tf32::FwdArgs& a, int D, const Plan& p,
                           dim3 grid, cudaStream_t st) {
  static bool opted_in = false;
  return launch_cluster(attention_fwd_wide_tf32<CAUSAL, DROPOUT>, opted_in, a,
                        D, p, grid, st);
}

// Launches the f32 wide forward for head size D (a multiple of kWide) over
// BH planes whose bias has `planes` planes (BH for the dropout forward) by
// the plan of kernels.wide_plan in f32; returns a cudaError_t code
// (cudaErrorInvalidValue for a plan the kernel does not take).
template <bool DROPOUT>
inline int run_fwd_tf32(const tf32::FwdArgs& a, int BH, int D, int causal,
                        int planes, const int* plan, cudaStream_t st) {
  if (!plan || D % kWide || planes <= 0 || BH % planes)
    return (int)cudaErrorInvalidValue;
  const Plan p{plan[0], plan[1], plan[2], plan[3]};
  if (!cluster_ok(p, D / kWide) || (p.passes != 1 && p.passes != 2) ||
      p.smem != plan_smem_f32(p.cluster, p.slices, a.S, p.passes) ||
      p.smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  dim3 grid((a.L + kTile - 1) / kTile * p.cluster, planes, BH / planes);
  return causal ? launch_fwd_tf32<true, DROPOUT>(a, D, p, grid, st)
                : launch_fwd_tf32<false, DROPOUT>(a, D, p, grid, st);
}

template <typename Args, bool DKV, bool CAUSAL>
inline int launch_bwd(const Args& a, int D, const Plan& p, dim3 grid,
                      cudaStream_t st) {
  static bool opted_in = false;
  void (*kernel)(Args, int, Plan);
  if constexpr (std::is_same_v<Args, tf32::BwdArgs> && DKV)
    kernel = attention_dkv_wide_tf32<CAUSAL>;
  else if constexpr (std::is_same_v<Args, tf32::BwdArgs>)
    kernel = attention_dq_wide_tf32<CAUSAL>;
  else if constexpr (DKV)
    kernel = attention_dkv_wide_mma<CAUSAL>;
  else
    kernel = attention_dq_wide_mma<CAUSAL>;
  return launch_cluster(kernel, opted_in, a, D, p, grid, st);
}

// Launches the wide backward (dQ, then dK / dV) for head size D over BH
// planes, f32 (tf32::BwdArgs) or bf16 (mma::BwdArgs), on the cluster of
// the plan the wrapper passes (the four ints of kernels.wide_plan in the
// call's dtype; each kernel's shared bytes are bwd_smem's, from the plan's
// slices); returns a cudaError_t code (cudaErrorInvalidValue for a plan
// the kernels do not take).
template <typename Args>
inline int run_bwd_wide(const Args& a, int BH, int D, int causal,
                        const int* plan, cudaStream_t st) {
  constexpr bool b16 = std::is_same_v<Args, mma::BwdArgs>;
  if (!plan || D % kWide) return (int)cudaErrorInvalidValue;
  const Plan f{plan[0], plan[1], plan[2], plan[3]};
  if (!cluster_ok(f, D / kWide)) return (int)cudaErrorInvalidValue;
  const Plan pq{f.cluster, f.slices, 1, bwd_smem(f.slices, false, b16)};
  const Plan pk{f.cluster, f.slices, 1, bwd_smem(f.slices, true, b16)};
  const dim3 gq((a.L + kTile - 1) / kTile * f.cluster, BH);
  const dim3 gk((a.S + kTile - 1) / kTile * f.cluster, BH);
  int err = causal ? launch_bwd<Args, false, true>(a, D, pq, gq, st)
                   : launch_bwd<Args, false, false>(a, D, pq, gq, st);
  if (err) return err;
  err = causal ? launch_bwd<Args, true, true>(a, D, pk, gk, st)
               : launch_bwd<Args, true, false>(a, D, pk, gk, st);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace wide
}  // namespace v2m
