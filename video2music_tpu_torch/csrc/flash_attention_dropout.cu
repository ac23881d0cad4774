// Attention with in-kernel hashed dropout, forward and backward, for the
// training step: out = (dropout(softmax(q k^T * scale + bias + causal))) v.
//
// Replaces the TPU kernels of video2music_tpu/ops/pallas_attention_dropout.py:
// flash_attention_dropout (forward _fwd_kernel via _fwd_call, backward
// _bwd_kernel via _bwd_call). Semantics kept: f32 logits and softmax, the
// optional (B, H, L, S) f32 bias, masked logits -1e9, the start-aligned
// causal mask (L == S, the wrapper checks), and the dropout mask of
// _drop_mask: a murmur3-style hash of (seed, b*H + h, absolute row, column)
// in u32 arithmetic (drop_hash, attention_mma.cuh), kept iff the hash
// exceeds u32(rate * 0xFFFFFFFF), kept entries scaled by 1/(1-rate). The
// mask is a pure function of its coordinates, so the backward replays it
// bit for bit and the (L, S) probabilities never reach device memory. The
// forward rounds the dropped probabilities to v's dtype before the product
// with v (as the Pallas kernel's astype) and saves each row's softmax max m
// and sum l. Head sizes: instances at 16, 32, 64, 128 and 256, the wrappers
// padding the others with zero columns (flash_attention.cu), and above
// 256 the head split into 64-column slices (attention_wide.cuh: a
// thread-block cluster a query tile; in f32 its backward too, a cluster a
// query or key tile; the bf16 wide backward below, a block a slice), D
// padded to a multiple of 64; the mask hashes rows and columns only, so
// padding and splitting leave it as it is. A shard of
// a sharded step (B/d rows of the batch, H/m heads) passes apply 2 and its
// origin in the global grid beside the seed (drop_salt), and hashes the
// global b*H + h, so it draws its slice of the unsharded mask.
//
// What bounds it on the H100: at the training shape (B*H = 128,
// L = S = 300, head_dim 64, bf16) the forward moves 19.7 MB (5.9 us at
// 3.35 TB/s) and does two (L, S, D) products, 2.9 GFLOP; the backward
// moves 34.4 MB (10.3 us) and does five, 7.4 GFLOP (7.5 us of bf16
// tensor-core peak). Both are microseconds of either roofline.
//
// bf16 (the training path) runs on the tensor cores (mma.sync m16n8k16,
// f32 accumulators; building blocks in attention_mma.cuh):
//   * forward: attention_mma.cuh's attention_fwd_mma, a warp per 16 query
//     rows, two passes over 64-key chunks double-buffered by cp.async
//     (m and l, then the dropped weights rounded to bf16 times V);
//   * backward, two kernels and no atomics (the gradients are the same
//     run to run). First dQ (attention_dq_mma), a warp per 16 query rows
//     and one pass over the key chunks: D = rowsum(dO * O) from the
//     forward's output (equal in exact arithmetic to sum_j w_j mask_j
//     (dO . v_j), since O = (w * mask) V), then per chunk S = Q K^T and
//     dP = dO V^T, P from (m, l), dS = P * (dP * mask - D) (stored as dbias
//     when there is a bias), dQ += dS K. Then dK/dV (attention_dkv_mma), a
//     warp per 16 key rows over chunks of 64 queries (from the diagonal
//     chunk under causal) with their m, l and D staged in shared memory:
//     S^T = K Q^T, dP^T = V dO^T, dV += (P * mask)^T dO, dK += dS^T Q.
//   Rounding: the Pallas backward and the plain version are all f32; here
//   P * mask and dS are rounded to bf16 as operands of the products and D
//   comes from the bf16 output, so the gradients agree with the plain
//   backward within 2e-2 of each one's largest value (chip_smoke.py's
//   bf16 bound), not to f32 precision.
// f32 (the train_amt CLI's default: TrainConfig.mixed_precision False)
// runs the same structure on the same tensor cores in split TF32
// (attention_tf32.cuh: three TF32 products a product, f32 accuracy): a
// one-pass forward with an online rescale, dQ then dK/dV, D from the f32
// output, nothing rounded. It replaced a first design of one thread per
// query (or key) row and plain FMA for every product: the forward took
// 0.4721 ms and the backward 3.4168 ms at the training shape (chip run,
// an H100 80GB HBM3 at 700 W). Above head size 256 f32 runs
// attention_wide.cuh's cluster forward and its cluster backward (dQ, then
// dK / dV, S and dP formed once a (tile, chunk)), which replaced one thread
// a row and plain FMA in a block a slice (5.07 and 12.40 ms at head size
// 512, B=16; the same card). Under causal attention, chunks wholly in the
// masked triangle add exact zeros and are skipped.
#include "attention_mma.cuh"
#include "attention_tf32.cuh"
#include "attention_wide.cuh"

namespace v2m {

// ---------------------------------------------------------------------------
// bf16: the tensor-core backward (the forward is attention_mma.cuh's)
// ---------------------------------------------------------------------------

namespace mma {

struct BwdArgs {
  const bf16 *q, *k, *v, *out, *dout;
  const float* bias;   // (BH, L, S) or null
  const int* seed;
  const float* stats;  // (BH, L, 2): the forward's row max and sum
  bf16 *dq, *dk, *dv;
  float* dbias;        // (BH, L, S) when there is a bias, else null
  float* dsum;         // (BH, L): D, written by dQ, read by dK/dV
  int L, S;
  float scale;
  DropoutSpec drop;
};

constexpr int kBwdWarps = 4;  // 64 query (dQ) or key (dK/dV) rows a block
// Both backward kernels are held to 170 registers, three blocks an SM: left
// free, ptxas takes 234 (dQ) and 179-197 (dK/dV), two blocks an SM, and
// the 640 blocks of the training shape run in ~2.4 waves, slower on the
// H100. The forward is left free: held to 128 registers it spills and
// slows down.
constexpr int kBwdMinBlocks = 3;
// Above a head size of 64 the accumulators alone pass 170 registers and
// the chunks leave room for one or two blocks an SM: no minimum.
constexpr int bwd_min_blocks(int hd) { return hd <= 64 ? kBwdMinBlocks : 1; }

// dQ, D and dbias: a warp per 16 query rows, one pass over the key chunks.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kBwdWarps * 32, bwd_min_blocks(HD))
attention_dq_mma(BwdArgs a) {
  constexpr int kNT = kChunk / 8;
  constexpr int kDT = HD / 8;
  // K and V chunks, two of each (fwd_smem bytes)
  bf16 (*ks)[Chunk<HD>::kElems] =
      reinterpret_cast<bf16 (*)[Chunk<HD>::kElems]>(attn_smem);
  bf16 (*vs)[Chunk<HD>::kElems] = ks + 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int blk0 = blockIdx.x * kBwdWarps * 16;
  const int r0 = blk0 + warp * 16;
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  const int c2 = (lane & 3) * 2;
  const int L = a.L, S = a.S;
  const size_t qoff = (size_t)bh * L * HD;
  const bf16* kb = a.k + (size_t)bh * S * HD;
  const bf16* vb = a.v + (size_t)bh * S * HD;
  const size_t ia = (size_t)bh * L + ra, ib = (size_t)bh * L + rb;
  const float* ba = a.bias && ra < L ? a.bias + ia * S : nullptr;
  const float* bb = a.bias && rb < L ? a.bias + ib * S : nullptr;
  float* dba = a.dbias && ra < L ? a.dbias + ia * S : nullptr;
  float* dbb = a.dbias && rb < L ? a.dbias + ib * S : nullptr;

  int n_chunks = (S + kChunk - 1) / kChunk;
  if (CAUSAL) n_chunks = min(n_chunks, (blk0 + kBwdWarps * 16 - 1) / kChunk + 1);
  int mine = CAUSAL ? min(n_chunks, (r0 + 15) / kChunk + 1) : n_chunks;
  if (r0 >= L) mine = 0;

  auto issue = [&](int c) {
    load_chunk<HD, kBwdWarps * 32>(ks[c & 1], kb, c * kChunk, S);
    load_chunk<HD, kBwdWarps * 32>(vs[c & 1], vb, c * kChunk, S);
    cp_async_commit();
  };
  issue(0);

  uint32_t qf[HD / 16][4], df[HD / 16][4];
  load_a<HD>(qf, a.q + qoff, r0, L, lane);
  load_a<HD>(df, a.dout + qoff, r0, L, lane);
  float Da = 0.f, Db = 0.f;  // D = rowsum(dO * O), f32 from bf16
  {
    uint32_t of[HD / 16][4];
    load_a<HD>(of, a.out + qoff, r0, L, lane);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&df[kk][e]));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&of[kk][e]));
        const float d = fmaf(x.x, y.x, x.y * y.y);
        if (e & 1) Db += d; else Da += d;
      }
    }
    Da = quad_sum(Da);
    Db = quad_sum(Db);
  }
  // m log2(e) and 1 / l of each row, from the forward's stats
  float ma2 = 0.f, mb2 = 0.f, inva = 1.f, invb = 1.f;
  if (ra < L) { ma2 = a.stats[ia * 2] * kLog2e; inva = 1.f / a.stats[ia * 2 + 1]; }
  if (rb < L) { mb2 = a.stats[ib * 2] * kLog2e; invb = 1.f / a.stats[ib * 2 + 1]; }
  const bool drop = a.drop.apply != 0;
  unsigned int rta = 0, rtb = 0;
  if (drop) {
    const unsigned int salt = drop_salt(a.seed, a.drop, bh);
    rta = row_term(ra, salt);
    rtb = row_term(rb, salt);
  }

  float dq[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (c < mine) {
      const int c0 = c * kChunk;
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_a_rowsT<HD, kNT>(s, qf, ks[c & 1], lane);
      mma_a_rowsT<HD, kNT>(dp, df, vs[c & 1], lane);
      to_logits<kNT, CAUSAL>(s, a.scale, ba, bb, r0, c0, S, lane);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool top = e < 2;
          const int col = c0 + j * 8 + c2 + (e & 1);
          // exactly 0 past the last key and (in f32) above the diagonal
          const float p =
              exp_from(s[j][e], top ? ma2 : mb2) * (top ? inva : invb);
          const float f =
              drop ? keep_factor(a.drop, top ? rta : rtb, col_term(col)) : 1.f;
          s[j][e] = p * (dp[j][e] * f - (top ? Da : Db));
        }
        const int col = c0 + j * 8 + c2;
        if (dba && col < S) dba[col] = s[j][0];
        if (dba && col + 1 < S) dba[col + 1] = s[j][1];
        if (dbb && col < S) dbb[col] = s[j][2];
        if (dbb && col + 1 < S) dbb[col + 1] = s[j][3];
      }
      uint32_t ds[kNT / 2][4];
      pack_a<kNT>(ds, s);
      mma_a_rows<HD, kNT / 2>(dq, ds, ks[c & 1], lane);
    }
    __syncthreads();
  }

  if (mine == 0) return;
  bf16* dqb = a.dq + qoff;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int col = j * 8 + c2;
    if (ra < L)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)ra * HD + col) =
          __floats2bfloat162_rn(dq[j][0] * a.scale, dq[j][1] * a.scale);
    if (rb < L)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)rb * HD + col) =
          __floats2bfloat162_rn(dq[j][2] * a.scale, dq[j][3] * a.scale);
  }
  if ((lane & 3) == 0) {
    if (ra < L) a.dsum[ia] = Da;
    if (rb < L) a.dsum[ib] = Db;
  }
  // the key chunks this warp skipped under causal: dS is exactly 0 there
  for (int col = mine * kChunk + (lane & 3); col < S; col += 4) {
    if (dba) dba[col] = 0.f;
    if (dbb) dbb[col] = 0.f;
  }
}

// dK and dV: a warp per 16 key rows, over chunks of 64 queries, each taken
// in two halves of 32 (the accumulators of both products stay in
// registers).
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kBwdWarps * 32, bwd_min_blocks(HD))
attention_dkv_mma(BwdArgs a) {
  constexpr int kSub = 32;       // queries a product
  constexpr int kNT = kSub / 8;  // query tiles
  constexpr int kDT = HD / 8;
  // q and dO chunks, two of each (fwd_smem bytes)
  bf16 (*qs)[Chunk<HD>::kElems] =
      reinterpret_cast<bf16 (*)[Chunk<HD>::kElems]>(attn_smem);
  bf16 (*dos)[Chunk<HD>::kElems] = qs + 2;
  __shared__ __align__(16) float2 mls[2][kChunk];  // (m, l) a query
  __shared__ __align__(16) float dds[2][kChunk];   // D a query
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int blk0 = blockIdx.x * kBwdWarps * 16;
  const int k0 = blk0 + warp * 16;
  const int ka = k0 + (lane >> 2), kb = ka + 8;
  const int c2 = (lane & 3) * 2;
  const int L = a.L, S = a.S;
  const size_t qoff = (size_t)bh * L * HD, koff = (size_t)bh * S * HD;
  const bf16* qb = a.q + qoff;
  const bf16* dob = a.dout + qoff;
  const float* stb = a.stats + (size_t)bh * L * 2;
  const float* dsb = a.dsum + (size_t)bh * L;
  const float* bias = a.bias ? a.bias + (size_t)bh * L * S : nullptr;

  // queries above the block's first key see none of its keys under causal
  const int n_q = (L + kChunk - 1) / kChunk;
  const int first = CAUSAL ? blk0 / kChunk : 0;
  auto issue = [&](int c) {
    const int buf = (c - first) & 1;
    load_chunk<HD, kBwdWarps * 32>(qs[buf], qb, c * kChunk, L);
    load_chunk<HD, kBwdWarps * 32>(dos[buf], dob, c * kChunk, L);
    if (threadIdx.x < kChunk) {
      const int r = c * kChunk + threadIdx.x;
      const bool ok = r < L;
      cp_async_small<8>(&mls[buf][threadIdx.x], stb + (size_t)(ok ? r : 0) * 2, ok);
      cp_async_small<4>(&dds[buf][threadIdx.x], dsb + (ok ? r : 0), ok);
    }
    cp_async_commit();
  };
  if (first < n_q) issue(first);

  uint32_t kf[HD / 16][4], vf[HD / 16][4];
  load_a<HD>(kf, a.k + koff, k0, S, lane);
  load_a<HD>(vf, a.v + koff, k0, S, lane);
  const bool drop = a.drop.apply != 0;
  const unsigned int salt = drop ? drop_salt(a.seed, a.drop, bh) : 0u;
  const unsigned int cta = col_term(ka), ctb = col_term(kb);

  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int c = first; c < n_q; ++c) {
    const int buf = (c - first) & 1;
    if (c + 1 < n_q) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 1
    for (int h = 0; h < kChunk / kSub; ++h) {
      const int q0 = c * kChunk + h * kSub;
      // a dead warp; queries past L; or every pair above the diagonal
      if (k0 >= S || q0 >= L || (CAUSAL && q0 + kSub - 1 < k0)) continue;
      const bf16* qrows = qs[buf] + h * kSub * Chunk<HD>::kStride;
      const bf16* drows = dos[buf] + h * kSub * Chunk<HD>::kStride;
      float st[kNT][4], dpt[kNT][4];  // S^T, then (P * mask)^T; dP^T, then dS^T
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      mma_a_rowsT<HD, kNT>(st, kf, qrows, lane);
      mma_a_rowsT<HD, kNT>(dpt, vf, drows, lane);
      // the diagonal crosses this half: some key above some query
      const bool diag = CAUSAL && k0 + 15 > q0;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {  // this lane's two queries of tile j
          const int qi = h * kSub + j * 8 + c2 + u;  // in the chunk
          const int row = c * kChunk + qi;           // the query
          const float2 ml = mls[buf][qi];
          const float ml2 = ml.x * kLog2e, inv = 1.f / ml.y, D = dds[buf][qi];
          const unsigned int rt = drop ? row_term(row, salt) : 0u;
#pragma unroll
          for (int e = u; e < 4; e += 2) {
            const int key = e < 2 ? ka : kb;
            float pm = 0.f, ds = 0.f;
            if (row < L) {
              float x = st[j][e] * a.scale;
              if (bias && key < S) x += bias[(size_t)row * S + key];
              if (diag && key > row) x = kNegInf;
              const float p = exp_from(x, ml2) * inv;
              const float f =
                  drop ? keep_factor(a.drop, rt, e < 2 ? cta : ctb) : 1.f;
              pm = p * f;
              ds = p * (dpt[j][e] * f - D);
            }
            st[j][e] = pm;
            dpt[j][e] = ds;
          }
        }
      }
      uint32_t pa[kNT / 2][4], sa[kNT / 2][4];
      pack_a<kNT>(pa, st);
      pack_a<kNT>(sa, dpt);
      mma_a_rows<HD, kNT / 2>(dv, pa, drows, lane);
      mma_a_rows<HD, kNT / 2>(dk, sa, qrows, lane);
    }
    __syncthreads();
  }

  bf16* dkb = a.dk + koff;
  bf16* dvb = a.dv + koff;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int col = j * 8 + c2;
    if (ka < S) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)ka * HD + col) =
          __floats2bfloat162_rn(dk[j][0] * a.scale, dk[j][1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)ka * HD + col) =
          __floats2bfloat162_rn(dv[j][0], dv[j][1]);
    }
    if (kb < S) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)kb * HD + col) =
          __floats2bfloat162_rn(dk[j][2] * a.scale, dk[j][3] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)kb * HD + col) =
          __floats2bfloat162_rn(dv[j][2], dv[j][3]);
    }
  }
}

template <int HD, bool CAUSAL>
inline int launch_bwd_pair(const BwdArgs& a, int BH, cudaStream_t st) {
  constexpr int kRows = kBwdWarps * 16;
  static bool dq_in = false, dkv_in = false;
  int err;
  if ((err = smem_opt_in(attention_dq_mma<HD, CAUSAL>, fwd_smem<HD>(),
                         dq_in)) ||
      (err = smem_opt_in(attention_dkv_mma<HD, CAUSAL>, fwd_smem<HD>(),
                         dkv_in)))
    return err;
  attention_dq_mma<HD, CAUSAL>
      <<<dim3((a.L + kRows - 1) / kRows, BH), kBwdWarps * 32, fwd_smem<HD>(),
         st>>>(a);
  attention_dkv_mma<HD, CAUSAL>
      <<<dim3((a.S + kRows - 1) / kRows, BH), kBwdWarps * 32, fwd_smem<HD>(),
         st>>>(a);
  return 0;
}

template <int HD>
inline int launch_bwd_mma(const BwdArgs& a, int BH, int causal,
                          cudaStream_t st) {
  return causal ? launch_bwd_pair<HD, true>(a, BH, st)
                : launch_bwd_pair<HD, false>(a, BH, st);
}

}  // namespace mma

// ---------------------------------------------------------------------------
// Above head size 256 in bf16: the backward with the head split across
// blocks (attention_wide.cuh), a block owning kWide columns of dQ (or of dK
// and dV) and forming S and dP over the whole head in kWide-column chunks,
// its own slice last, so the last chunk in shared memory is the one its
// products need. D = rowsum(dO * O) over the whole head; a row's dbias and
// D are written by the blocks of slice 0. (f32: attention_wide.cuh's
// cluster kernels, S and dP formed once a (tile, chunk).)
// ---------------------------------------------------------------------------

namespace wide {

// bf16 dQ, D and dbias on the tensor cores: a warp per 16 query rows, one
// pass over the key chunks, each in nd steps of kWide columns (K and V
// double-buffered by cp.async, the step's q and dO fragments from device
// memory); at a chunk's last step (its K columns the slice's) P, dS and
// dQ += dS K, as mma::attention_dq_mma. grid (row blocks x slices, BH).
template <bool CAUSAL>
__global__ void __launch_bounds__(mma::kBwdWarps * 32)
attention_dq_wide_mma(mma::BwdArgs a, int D) {
  using namespace mma;
  constexpr int kNT = kChunk / 8;
  constexpr int kDT = kWide / 8;
  bf16 (*ks)[Chunk<kWide>::kElems] =
      reinterpret_cast<bf16 (*)[Chunk<kWide>::kElems]>(attn_smem);
  bf16 (*vs)[Chunk<kWide>::kElems] = ks + 2;
  const int nd = D / kWide;
  const int slice = blockIdx.x % nd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int blk0 = (blockIdx.x / nd) * kBwdWarps * 16;
  const int r0 = blk0 + warp * 16;
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  const int c2 = (lane & 3) * 2;
  const int L = a.L, S = a.S;
  const size_t qoff = (size_t)bh * L * D;
  const bf16* kb = a.k + (size_t)bh * S * D;
  const bf16* vb = a.v + (size_t)bh * S * D;
  const size_t ia = (size_t)bh * L + ra, ib = (size_t)bh * L + rb;
  const float* ba = a.bias && ra < L ? a.bias + ia * S : nullptr;
  const float* bb = a.bias && rb < L ? a.bias + ib * S : nullptr;
  const bool owner = slice == 0;  // writes dbias and D
  float* dba = owner && a.dbias && ra < L ? a.dbias + ia * S : nullptr;
  float* dbb = owner && a.dbias && rb < L ? a.dbias + ib * S : nullptr;

  int n_chunks = (S + kChunk - 1) / kChunk;
  if (CAUSAL) n_chunks = min(n_chunks, (blk0 + kBwdWarps * 16 - 1) / kChunk + 1);
  int mine = CAUSAL ? min(n_chunks, (r0 + 15) / kChunk + 1) : n_chunks;
  if (r0 >= L) mine = 0;

  const int steps = n_chunks * nd;
  auto issue = [&](int t) {
    const int c = t / nd, dc = chunk_col(t % nd, slice, nd);
    load_chunk_s<kBwdWarps * 32>(ks[t & 1], kb + dc, c * kChunk, S, D);
    load_chunk_s<kBwdWarps * 32>(vs[t & 1], vb + dc, c * kChunk, S, D);
    cp_async_commit();
  };
  issue(0);

  float Da = 0.f, Db = 0.f;  // D = rowsum(dO * O) over the whole head
  for (int i = 0; i < nd; ++i) {
    uint32_t df[kWide / 16][4], of[kWide / 16][4];
    load_a_s(df, a.dout + qoff + i * kWide, r0, L, lane, D);
    load_a_s(of, a.out + qoff + i * kWide, r0, L, lane, D);
#pragma unroll
    for (int kk = 0; kk < kWide / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&df[kk][e]));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&of[kk][e]));
        const float d = fmaf(x.x, y.x, x.y * y.y);
        if (e & 1) Db += d; else Da += d;
      }
    }
  }
  Da = quad_sum(Da);
  Db = quad_sum(Db);
  float ma2 = 0.f, mb2 = 0.f, inva = 1.f, invb = 1.f;
  if (ra < L) { ma2 = a.stats[ia * 2] * kLog2e; inva = 1.f / a.stats[ia * 2 + 1]; }
  if (rb < L) { mb2 = a.stats[ib * 2] * kLog2e; invb = 1.f / a.stats[ib * 2 + 1]; }
  const bool drop = a.drop.apply != 0;
  unsigned int rta = 0, rtb = 0;
  if (drop) {
    const unsigned int salt = drop_salt(a.seed, a.drop, bh);
    rta = row_term(ra, salt);
    rtb = row_term(rb, salt);
  }

  float dq[kDT][4], s[kNT][4], dp[kNT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c = t / nd, i = t % nd;
    if (c < mine) {
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
      {
        const int dc = chunk_col(i, slice, nd);
        uint32_t qf[kWide / 16][4], df[kWide / 16][4];
        load_a_s(qf, a.q + qoff + dc, r0, L, lane, D);
        load_a_s(df, a.dout + qoff + dc, r0, L, lane, D);
        mma_a_rowsT<kWide, kNT>(s, qf, ks[t & 1], lane);
        mma_a_rowsT<kWide, kNT>(dp, df, vs[t & 1], lane);
      }
      if (i == nd - 1) {
        const int c0 = c * kChunk;
        to_logits<kNT, CAUSAL>(s, a.scale, ba, bb, r0, c0, S, lane);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool top = e < 2;
            const int col = c0 + j * 8 + c2 + (e & 1);
            const float p =
                exp_from(s[j][e], top ? ma2 : mb2) * (top ? inva : invb);
            const float f =
                drop ? keep_factor(a.drop, top ? rta : rtb, col_term(col)) : 1.f;
            s[j][e] = p * (dp[j][e] * f - (top ? Da : Db));
          }
          const int col = c0 + j * 8 + c2;
          if (dba && col < S) dba[col] = s[j][0];
          if (dba && col + 1 < S) dba[col + 1] = s[j][1];
          if (dbb && col < S) dbb[col] = s[j][2];
          if (dbb && col + 1 < S) dbb[col + 1] = s[j][3];
        }
        uint32_t ds[kNT / 2][4];
        pack_a<kNT>(ds, s);
        mma_a_rows<kWide, kNT / 2>(dq, ds, ks[t & 1], lane);
      }
    }
    __syncthreads();
  }

  if (mine == 0) return;
  bf16* dqb = a.dq + qoff + slice * kWide;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int col = j * 8 + c2;
    if (ra < L)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)ra * D + col) =
          __floats2bfloat162_rn(dq[j][0] * a.scale, dq[j][1] * a.scale);
    if (rb < L)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)rb * D + col) =
          __floats2bfloat162_rn(dq[j][2] * a.scale, dq[j][3] * a.scale);
  }
  if (owner && (lane & 3) == 0) {
    if (ra < L) a.dsum[ia] = Da;
    if (rb < L) a.dsum[ib] = Db;
  }
  // the key chunks this warp skipped under causal: dS is exactly 0 there
  for (int col = mine * kChunk + (lane & 3); col < S; col += 4) {
    if (dba) dba[col] = 0.f;
    if (dbb) dbb[col] = 0.f;
  }
}

// bf16 dK and dV on the tensor cores: a warp per 16 key rows, over chunks
// of 64 queries, each in nd steps of kWide columns (q and dO
// double-buffered by cp.async, the step's K and V fragments from device
// memory); at a chunk's last step (its q and dO columns the slice's)
// (P * mask)^T and dS^T, dV += (P * mask)^T dO and dK += dS^T Q, as
// mma::attention_dkv_mma. grid (key blocks x slices, BH).
template <bool CAUSAL>
__global__ void __launch_bounds__(mma::kBwdWarps * 32)
attention_dkv_wide_mma(mma::BwdArgs a, int D) {
  using namespace mma;
  constexpr int kNT = kChunk / 8;  // query tiles of a chunk
  constexpr int kDT = kWide / 8;
  bf16 (*qs)[Chunk<kWide>::kElems] =
      reinterpret_cast<bf16 (*)[Chunk<kWide>::kElems]>(attn_smem);
  bf16 (*dos)[Chunk<kWide>::kElems] = qs + 2;
  __shared__ __align__(16) float2 mls[2][kChunk];  // (m, l) a query
  __shared__ __align__(16) float dds[2][kChunk];   // D a query
  const int nd = D / kWide;
  const int slice = blockIdx.x % nd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int blk0 = (blockIdx.x / nd) * kBwdWarps * 16;
  const int k0 = blk0 + warp * 16;
  const int ka = k0 + (lane >> 2), kb = ka + 8;
  const int c2 = (lane & 3) * 2;
  const int L = a.L, S = a.S;
  const size_t qoff = (size_t)bh * L * D, koff = (size_t)bh * S * D;
  const bf16* qb = a.q + qoff;
  const bf16* dob = a.dout + qoff;
  const float* stb = a.stats + (size_t)bh * L * 2;
  const float* dsb = a.dsum + (size_t)bh * L;
  const float* bias = a.bias ? a.bias + (size_t)bh * L * S : nullptr;

  // queries above the block's first key see none of its keys under causal
  const int n_q = (L + kChunk - 1) / kChunk;
  const int first = CAUSAL ? blk0 / kChunk : 0;
  const int steps = max(n_q - first, 0) * nd;
  auto issue = [&](int t) {
    const int c = first + t / nd, i = t % nd, dc = chunk_col(i, slice, nd);
    load_chunk_s<kBwdWarps * 32>(qs[t & 1], qb + dc, c * kChunk, L, D);
    load_chunk_s<kBwdWarps * 32>(dos[t & 1], dob + dc, c * kChunk, L, D);
    if (i == 0 && threadIdx.x < kChunk) {
      const int mb = (c - first) & 1;
      const int r = c * kChunk + threadIdx.x;
      const bool ok = r < L;
      cp_async_small<8>(&mls[mb][threadIdx.x], stb + (size_t)(ok ? r : 0) * 2, ok);
      cp_async_small<4>(&dds[mb][threadIdx.x], dsb + (ok ? r : 0), ok);
    }
    cp_async_commit();
  };
  if (steps > 0) issue(0);

  const bool drop = a.drop.apply != 0;
  const unsigned int salt = drop ? drop_salt(a.seed, a.drop, bh) : 0u;
  const unsigned int cta = col_term(ka), ctb = col_term(kb);

  float dk[kDT][4], dv[kDT][4], st[kNT][4], dpt[kNT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c = first + t / nd, i = t % nd, buf = t & 1;
    const int q0 = c * kChunk;
    // a dead warp; or every pair above the diagonal
    if (!(k0 >= S || (CAUSAL && q0 + kChunk - 1 < k0))) {
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      }
      {
        const int dc = chunk_col(i, slice, nd);
        uint32_t kf[kWide / 16][4], vf[kWide / 16][4];
        load_a_s(kf, a.k + koff + dc, k0, S, lane, D);
        load_a_s(vf, a.v + koff + dc, k0, S, lane, D);
        mma_a_rowsT<kWide, kNT>(st, kf, qs[buf], lane);
        mma_a_rowsT<kWide, kNT>(dpt, vf, dos[buf], lane);
      }
      if (i == nd - 1) {
        const int mb = (c - first) & 1;
        // the diagonal crosses this chunk: some key above some query
        const bool diag = CAUSAL && k0 + 15 > q0;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {  // this lane's two queries of tile j
            const int qi = j * 8 + c2 + u;  // in the chunk
            const int row = q0 + qi;        // the query
            const float2 ml = mls[mb][qi];
            const float ml2 = ml.x * kLog2e, inv = 1.f / ml.y, Dq = dds[mb][qi];
            const unsigned int rt = drop ? row_term(row, salt) : 0u;
#pragma unroll
            for (int e = u; e < 4; e += 2) {
              const int key = e < 2 ? ka : kb;
              float pm = 0.f, ds = 0.f;
              if (row < L) {
                float x = st[j][e] * a.scale;
                if (bias && key < S) x += bias[(size_t)row * S + key];
                if (diag && key > row) x = kNegInf;
                const float p = exp_from(x, ml2) * inv;
                const float f =
                    drop ? keep_factor(a.drop, rt, e < 2 ? cta : ctb) : 1.f;
                pm = p * f;
                ds = p * (dpt[j][e] * f - Dq);
              }
              st[j][e] = pm;
              dpt[j][e] = ds;
            }
          }
        }
        uint32_t pa[kNT / 2][4], sa[kNT / 2][4];
        pack_a<kNT>(pa, st);
        pack_a<kNT>(sa, dpt);
        mma_a_rows<kWide, kNT / 2>(dv, pa, dos[buf], lane);
        mma_a_rows<kWide, kNT / 2>(dk, sa, qs[buf], lane);
      }
    }
    __syncthreads();
  }

  bf16* dkb = a.dk + koff + slice * kWide;
  bf16* dvb = a.dv + koff + slice * kWide;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int col = j * 8 + c2;
    if (ka < S) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)ka * D + col) =
          __floats2bfloat162_rn(dk[j][0] * a.scale, dk[j][1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)ka * D + col) =
          __floats2bfloat162_rn(dv[j][0], dv[j][1]);
    }
    if (kb < S) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)kb * D + col) =
          __floats2bfloat162_rn(dk[j][2] * a.scale, dk[j][3] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)kb * D + col) =
          __floats2bfloat162_rn(dv[j][2], dv[j][3]);
    }
  }
}

template <bool CAUSAL>
inline int launch_bwd_wide(const mma::BwdArgs& a, int BH, int D,
                          cudaStream_t st) {
  constexpr int kRows = mma::kBwdWarps * 16;
  const int nd = D / kWide;
  attention_dq_wide_mma<CAUSAL>
      <<<dim3((a.L + kRows - 1) / kRows * nd, BH), mma::kBwdWarps * 32,
         mma_smem(), st>>>(a, D);
  attention_dkv_wide_mma<CAUSAL>
      <<<dim3((a.S + kRows - 1) / kRows * nd, BH), mma::kBwdWarps * 32,
         mma_smem(), st>>>(a, D);
  return (int)cudaGetLastError();
}

inline int run_bwd_mma(const mma::BwdArgs& a, int BH, int D, int causal,
                       cudaStream_t st) {
  if (D % kWide) return (int)cudaErrorInvalidValue;
  return causal ? launch_bwd_wide<true>(a, BH, D, st)
                : launch_bwd_wide<false>(a, BH, D, st);
}

}  // namespace wide

// ---------------------------------------------------------------------------
// Entry points: f32 runs attention_tf32.cuh, bf16 the kernels above
// ---------------------------------------------------------------------------

struct DropoutArgs {
  const void *q, *k, *v, *bias, *seed, *dout, *stats;
  const int* plan;  // the wide plan (attention_wide.cuh run_fwd_mma,
                    // run_fwd_tf32, run_bwd_tf32)
  void *out, *dq, *dk, *dv, *dbias, *dsum;
  int BH, L, S, causal;
  float scale;
  DropoutSpec drop;
};

static int dispatch_f32(const DropoutArgs& a, int D, bool backward,
                        cudaStream_t st) {
  if (!backward) {
    tf32::FwdArgs f{};
    f.q = (const float*)a.q; f.k = (const float*)a.k; f.v = (const float*)a.v;
    f.bias = (const float*)a.bias; f.seed = (const int*)a.seed;
    f.out = (float*)a.out; f.stats = (float*)a.stats;
    f.L = a.L; f.S = a.S; f.scale = a.scale; f.drop = a.drop;
    if (D > 256)  // the head split across a cluster (attention_wide.cuh)
      return wide::run_fwd_tf32<true>(f, a.BH, D, a.causal, a.BH, a.plan,
                                      st);
    return tf32::run_fwd<true>(f, a.BH, D, a.causal, st, a.BH);
  }
  tf32::BwdArgs b{};
  b.q = (const float*)a.q; b.k = (const float*)a.k; b.v = (const float*)a.v;
  b.out = (const float*)a.out; b.dout = (const float*)a.dout;
  b.bias = (const float*)a.bias; b.seed = (const int*)a.seed;
  b.stats = (const float*)a.stats;
  b.dq = (float*)a.dq; b.dk = (float*)a.dk; b.dv = (float*)a.dv;
  b.dbias = (float*)a.dbias; b.dsum = (float*)a.dsum;
  b.L = a.L; b.S = a.S; b.scale = a.scale; b.drop = a.drop;
  if (D > 256) return wide::run_bwd_tf32(b, a.BH, D, a.causal, a.plan, st);
  return tf32::run_bwd(b, a.BH, D, a.causal, st);
}

static int dispatch_bf16(const DropoutArgs& a, int D, bool backward,
                         cudaStream_t st) {
  if (!backward) {
    mma::FwdArgs f{};
    f.q = (const bf16*)a.q; f.k = (const bf16*)a.k; f.v = (const bf16*)a.v;
    f.bias = (const float*)a.bias; f.seed = (const int*)a.seed;
    f.out = (bf16*)a.out; f.stats = (float*)a.stats;
    f.L = a.L; f.S = a.S; f.scale = a.scale; f.drop = a.drop;
    if (D > 256)  // the head split across blocks (attention_wide.cuh)
      return wide::run_fwd_mma<true>(f, a.BH, D, a.causal, a.BH, a.plan,
                                     st);
    return mma::run_fwd_mma<true>(f, a.BH, D, a.causal, st, a.BH);
  }
  mma::BwdArgs b{};
  b.q = (const bf16*)a.q; b.k = (const bf16*)a.k; b.v = (const bf16*)a.v;
  b.out = (const bf16*)a.out; b.dout = (const bf16*)a.dout;
  b.bias = (const float*)a.bias; b.seed = (const int*)a.seed;
  b.stats = (const float*)a.stats;
  b.dq = (bf16*)a.dq; b.dk = (bf16*)a.dk; b.dv = (bf16*)a.dv;
  b.dbias = (float*)a.dbias; b.dsum = (float*)a.dsum;
  b.L = a.L; b.S = a.S; b.scale = a.scale; b.drop = a.drop;
  if (D > 256) return wide::run_bwd_mma(b, a.BH, D, a.causal, st);
  int err;
  switch (D) {
    case 16: err = mma::launch_bwd_mma<16>(b, a.BH, a.causal, st); break;
    case 32: err = mma::launch_bwd_mma<32>(b, a.BH, a.causal, st); break;
    case 64: err = mma::launch_bwd_mma<64>(b, a.BH, a.causal, st); break;
    case 128: err = mma::launch_bwd_mma<128>(b, a.BH, a.causal, st); break;
    case 256: err = mma::launch_bwd_mma<256>(b, a.BH, a.causal, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

static int run(int dtype, const DropoutArgs& a, int D, bool backward,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) return dispatch_f32(a, D, backward, st);
  if (dtype == kBF16) return dispatch_bf16(a, D, backward, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace v2m

// q (BH, L, D), k/v (BH, S, D), bias (BH, L, S) f32 or null, seed one int32
// on the device (apply 2: four, {seed, heads, heads_global, bh_offset}, a
// shard's origin in the global (batch, head) grid); out (BH, L, D) of q's
// dtype, stats (BH, L, 2) f32 (row max, row sum of exponentials);
// wide_plan: above 256 the four ints of kernels.wide_plan, else unread.
// Returns a cudaError_t code.
extern "C" int v2m_attention_dropout_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    const void* seed, void* out, void* stats, int BH, int L, int S, int D,
    int causal, float scale, unsigned int threshold, float keep_scale,
    int apply, const int* wide_plan, void* stream) {
  v2m::DropoutArgs a{};
  a.q = q; a.k = k; a.v = v; a.bias = bias; a.seed = seed;
  a.plan = wide_plan;
  a.out = out; a.stats = stats;
  a.BH = BH; a.L = L; a.S = S; a.causal = causal; a.scale = scale;
  a.drop = v2m::DropoutSpec{threshold, keep_scale, apply};
  return v2m::run(dtype, a, D, false, stream);
}

// The backward of v2m_attention_dropout_fwd from its stats and its output
// `out` (D = rowsum(dout * out) in both dtypes): dq
// (BH, L, D), dk/dv (BH, S, D) of q's dtype, dbias (BH, L, S) f32 when bias
// is given (else null), dsum (BH, L) f32 scratch; wide_plan: above 256 in
// f32 the forward's four ints of kernels.wide_plan (its cluster), else
// unread. Returns a cudaError_t code.
extern "C" int v2m_attention_dropout_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    const void* seed, const void* dout, const void* stats, const void* out,
    void* dq, void* dk, void* dv, void* dbias, void* dsum, int BH, int L,
    int S, int D, int causal, float scale, unsigned int threshold,
    float keep_scale, int apply, const int* wide_plan, void* stream) {
  v2m::DropoutArgs a{};
  a.q = q; a.k = k; a.v = v; a.bias = bias; a.seed = seed; a.dout = dout;
  a.plan = wide_plan;
  a.stats = stats; a.out = const_cast<void*>(out);
  a.dq = dq; a.dk = dk; a.dv = dv; a.dbias = dbias; a.dsum = dsum;
  a.BH = BH; a.L = L; a.S = S; a.causal = causal; a.scale = scale;
  a.drop = v2m::DropoutSpec{threshold, keep_scale, apply};
  return v2m::run(dtype, a, D, true, stream);
}
