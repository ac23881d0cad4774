// Attention above head size 256 (rows 1 and 11 at any head size), for
// flash_attention.cu (row 1) and flash_attention_dropout.cu (row 11's
// forward; its backward lives there).
//
// The Pallas wrappers pad D to a multiple of 128 and keep whole rows in
// VMEM (video2music_tpu/ops/pallas_attention.py:143,
// pallas_attention_dropout.py:162). On the H100 the widest instance of
// attention_mma.cuh keeps a (16, 256) f32 accumulator a warp in registers;
// a wider head does not fit. So the head is split into column slices of
// kWide (the wrappers pad D with zero columns to a multiple of kWide: zero
// columns change neither q . k nor the kept columns of P . V).
//
// bf16 (the product and training path): one thread-block cluster of C
// blocks a tile of kTile query rows, block r of it owning the slices
// [r nd / C, (r + 1) nd / C) of the head and the rows [r kTile / C,
// (r + 1) kTile / C) of the tile (the plan, kernels.wide_plan, passes C).
// A block reads only its own slices of q, K and V. For each 64-key chunk
// it forms its partial S_r = q_r K_r^T on the tensor cores (mma.sync
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
// What bounds it: at row 11's hd 512 training shape (B*H = 16, L = S =
// 300) the forward moves 19.7 MB in bf16 (5.9 us at 3.35 TB/s) and needs
// two (L, S, D) products, 2.9 GFLOP (3.0 us at 989 TFLOP/s): the bytes
// bound it. A block is a chain of a cluster barrier and an exchange a key
// chunk, the softmax, a barrier and a step a (chunk, slice) of P . V;
// where the grid is small (row 1 at B=1) that chain's latency, not the
// bound, sets the time (computed from the shapes, not measured).
//
// f32 (the parity path) is one thread per query row with plain FMA, a
// block a (row block, slice) forming S over the whole head in
// kWide-column chunks in both passes (row max and sum, then the weights
// times V). The kernels get D as a parameter of their own beside the
// narrow instances' argument structs, which keep their size.
#pragma once

#include <cooperative_groups.h>

#include "attention_mma.cuh"

namespace v2m {
namespace wide {

constexpr int kWide = 64;      // columns a block owns; the D-chunk width
constexpr int kRowsF32 = 64;   // f32: query (or key) rows a block, one a thread
constexpr int kTileF32 = 32;   // f32: K / V rows a shared tile

using mma::Chunk;

// The A operand of 16 rows r0.. and kWide columns of a (rows, stride)
// bf16 matrix (m points at the chunk's first column); rows at or past
// `limit` are zero.
__device__ __forceinline__ void load_a_s(uint32_t (&a)[kWide / 16][4],
                                         const bf16* __restrict__ m, int r0,
                                         int limit, int lane, int stride) {
  const int ra = r0 + (lane >> 2), rb = ra + 8, c = (lane & 3) * 2;
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(
      m + (size_t)(ra < limit ? ra : 0) * stride + c);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(
      m + (size_t)(rb < limit ? rb : 0) * stride + c);
#pragma unroll
  for (int kk = 0; kk < kWide / 16; ++kk) {
    a[kk][0] = ra < limit ? pa[kk * 8] : 0u;
    a[kk][1] = rb < limit ? pb[kk * 8] : 0u;
    a[kk][2] = ra < limit ? pa[kk * 8 + 4] : 0u;
    a[kk][3] = rb < limit ? pb[kk * 8 + 4] : 0u;
  }
}

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

// The column of the i-th of a block's nd D-chunks: its own slice last.
__device__ __forceinline__ int chunk_col(int i, int slice, int nd) {
  return ((slice + 1 + i) % nd) * kWide;
}

// A logit of the f32 kernels from its dot product: * scale, + bias, -1e9
// above the causal diagonal (as mma::to_logits for a column below S).
__device__ __forceinline__ float logit_f32(float dot, float scale,
                                           const float* brow, int row,
                                           int col, int causal) {
  float s = dot * scale;
  if (brow) s += brow[col];
  return (causal && col > row) ? mma::kNegInf : s;
}

// The dropout factor of (row, col) of a plane whose salt is `salt`.
__device__ __forceinline__ float drop_f32(const DropoutSpec& d, int row,
                                          int col, unsigned int salt) {
  if (!d.apply) return 1.f;
  return mma::keep_factor(d, mma::row_term(row, salt), mma::col_term(col));
}

// ---------------------------------------------------------------------------
// f32 forward: one thread per query row, kWide output columns a block
// ---------------------------------------------------------------------------

struct F32Args {
  const float *q, *k, *v;
  const float* bias;  // (planes, L, S) or null; (b, h) reads plane blockIdx.y
  const int* seed;    // dropout only
  float* out;
  float* stats;       // dropout only: (BH, L, 2) row max, row sum
  int L, S, D, causal;
  float scale;
  DropoutSpec drop;
};

// grid (row blocks x slices, planes, BH / planes): block x = row block *
// slices + slice; (b, h) = blockIdx.z * planes + blockIdx.y.
template <bool DROPOUT>
__global__ void __launch_bounds__(kRowsF32) attention_fwd_wide_f32(F32Args a) {
  // K (and in pass 1 V) tiles of kTileF32 rows x kWide columns
  float (*ks)[kWide] = reinterpret_cast<float (*)[kWide]>(mma::attn_smem);
  float (*vs)[kWide] = ks + kTileF32;
  const int L = a.L, S = a.S, D = a.D, nd = D / kWide;
  const int slice = blockIdx.x % nd;
  const int row0 = (blockIdx.x / nd) * kRowsF32;
  const int row = row0 + threadIdx.x;
  const bool live = row < L;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const float* qrow = a.q + ((size_t)bh * L + (live ? row : 0)) * D;
  const float* kb = a.k + (size_t)bh * S * D;
  const float* vb = a.v + (size_t)bh * S * D;
  const float* brow =
      a.bias && live ? a.bias + ((size_t)blockIdx.y * L + row) * S : nullptr;
  const unsigned int salt = DROPOUT ? mma::drop_salt(a.seed, a.drop, bh) : 0u;
  const int s_end = a.causal ? min(S, row0 + kRowsF32) : S;

  float m = -INFINITY, l = 0.f, acc[kWide];
#pragma unroll
  for (int c = 0; c < kWide; ++c) acc[c] = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int s0 = 0; s0 < s_end; s0 += kTileF32) {
      float sc[kTileF32];
#pragma unroll
      for (int j = 0; j < kTileF32; ++j) sc[j] = 0.f;
      for (int i = 0; i < nd; ++i) {
        const int dc = chunk_col(i, slice, nd);
        const bool with_v = pass == 1 && i == nd - 1;
        __syncthreads();
        for (int e = threadIdx.x; e < kTileF32 * kWide; e += kRowsF32) {
          const int r = e / kWide, c = e % kWide, s = s0 + r;
          ks[r][c] = s < S ? kb[(size_t)s * D + dc + c] : 0.f;
          if (with_v) vs[r][c] = s < S ? vb[(size_t)s * D + dc + c] : 0.f;
        }
        __syncthreads();
        if (live) {
          float qc[kWide];
#pragma unroll
          for (int c = 0; c < kWide; ++c) qc[c] = qrow[dc + c];
#pragma unroll
          for (int j = 0; j < kTileF32; ++j)
#pragma unroll 16
            for (int c = 0; c < kWide; ++c) sc[j] = fmaf(qc[c], ks[j][c], sc[j]);
        }
      }
      if (!live) continue;
      const int n = min(kTileF32, s_end - s0);
      if (pass == 0) {
        float tmax = m;
#pragma unroll
        for (int j = 0; j < kTileF32; ++j) {
          if (j < n) {
            sc[j] = logit_f32(sc[j], a.scale, brow, row, s0 + j, a.causal);
            tmax = fmaxf(tmax, sc[j]);
          }
        }
        l *= expf(m - tmax);
#pragma unroll
        for (int j = 0; j < kTileF32; ++j)
          if (j < n) l += expf(sc[j] - tmax);
        m = tmax;
      } else {
        for (int j = 0; j < n; ++j) {
          const int col = s0 + j;
          float w = expf(logit_f32(sc[j], a.scale, brow, row, col, a.causal) -
                         m) / l;
          if (DROPOUT) w *= drop_f32(a.drop, row, col, salt);
#pragma unroll
          for (int c = 0; c < kWide; ++c) acc[c] = fmaf(w, vs[j][c], acc[c]);
        }
      }
    }
  }
  if (!live) return;
  float* o = a.out + ((size_t)bh * L + row) * D + slice * kWide;
#pragma unroll
  for (int c = 0; c < kWide; ++c) o[c] = acc[c];
  if (DROPOUT && slice == 0) {
    a.stats[((size_t)bh * L + row) * 2] = m;
    a.stats[((size_t)bh * L + row) * 2 + 1] = l;
  }
}

constexpr size_t fwd_f32_smem() { return 2 * kTileF32 * kWide * sizeof(float); }

// Launches the f32 wide forward over BH planes whose bias has `planes`
// planes (BH for the dropout forward); returns a cudaError_t code.
template <bool DROPOUT>
inline int run_fwd_f32(const F32Args& a, int BH, int planes,
                       cudaStream_t st) {
  if (a.D % kWide || planes <= 0 || BH % planes)
    return (int)cudaErrorInvalidValue;
  const int nd = a.D / kWide;
  dim3 grid((a.L + kRowsF32 - 1) / kRowsF32 * nd, planes, BH / planes);
  attention_fwd_wide_f32<DROPOUT><<<grid, kRowsF32, fwd_f32_smem(), st>>>(a);
  return (int)cudaGetLastError();
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

// The shared chunks of the wide backward (flash_attention_dropout.cu): two
// K and two V chunks of kWide columns.
constexpr size_t mma_smem() { return mma::fwd_smem<kWide>(); }

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

}  // namespace wide
}  // namespace v2m
