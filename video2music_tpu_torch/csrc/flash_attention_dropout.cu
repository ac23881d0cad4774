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
// padding the others with zero columns (flash_attention.cu); the mask
// hashes rows and columns only, so padding leaves it as it is.
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
// The first design, kept for f32 (the parity path: TF32 tensor cores would
// keep ~3 digits), has one thread per query (or key) row and plain FMA for
// every product: the forward took 0.43 ms and the backward 3.32 ms at the
// training shape against 0.065 / 0.56 ms of F.scaled_dot_product_attention
// with dropout (chip run, an H100 80GB HBM3 at 700 W). Under causal
// attention, chunks (f32: tiles) wholly in the masked triangle add exact
// zeros and are skipped.
#include "attention_mma.cuh"

namespace v2m {

constexpr int kDropRows = 64;   // query (or key) rows per block, one per thread
constexpr int kDropTile = 32;   // K/V rows per shared-memory tile
constexpr int kDropQTile = 16;  // q / dO rows per shared-memory tile (dK/dV)
constexpr float kDropNegInf = -1e9f;

__device__ __forceinline__ float drop_factor(const DropoutSpec& d, int row,
                                             int col, unsigned int salt) {
  if (!d.apply) return 1.f;
  return drop_hash((unsigned int)row, (unsigned int)col, salt) > d.threshold
             ? d.keep_scale : 0.f;
}

// Scaled, biased, causally masked logit of (row, col) from its dot product.
__device__ __forceinline__ float drop_logit(float dot, float scale,
                                            const float* brow, int row,
                                            int col, int causal) {
  float s = dot * scale;
  if (brow) s += brow[col];
  return (causal && col > row) ? kDropNegInf : s;
}

// The f32 kernels (bf16 runs the tensor-core kernels below and in
// attention_mma.cuh).
template <int HD>
__device__ __forceinline__ void load_tile(float (*dst)[HD],
                                          const float* __restrict__ src, int r0,
                                          int nrows, int limit) {
  for (int i = threadIdx.x; i < nrows * HD; i += blockDim.x) {
    const int r = i / HD, c = i % HD;
    dst[r][c] = r0 + r < limit ? src[(size_t)(r0 + r) * HD + c] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kDropRows)
attention_dropout_fwd_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ bias,
                             const int* __restrict__ seed,
                             float* __restrict__ out,
                             float* __restrict__ stats, int L, int S,
                             int causal, float scale, DropoutSpec drop) {
  constexpr int kUnrollHD = mma::unroll_hd(HD);
  // K and V tiles (fwd_f32_smem bytes)
  float (*ks)[HD] = reinterpret_cast<float (*)[HD]>(mma::attn_smem);
  float (*vs)[HD] = ks + kDropTile;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kDropRows;
  const int row = row0 + threadIdx.x;
  const bool live = row < L;
  const float* kb = k + (size_t)bh * S * HD;
  const float* vb = v + (size_t)bh * S * HD;
  const float* brow = bias && live ? bias + ((size_t)bh * L + row) * S : nullptr;
  const unsigned int salt = (unsigned int)seed[0] + (unsigned int)bh * 0xC2B2AE35u;
  const int s_end = causal ? min(S, row0 + kDropRows) : S;

  float qr[HD];
#pragma unroll kUnrollHD
  for (int c = 0; c < HD; ++c)
    qr[c] = live ? q[((size_t)bh * L + row) * HD + c] : 0.f;

  // pass 1: row max and sum of exponentials
  float m = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 < s_end; s0 += kDropTile) {
    load_tile<HD>(ks, kb, s0, kDropTile, S);
    __syncthreads();
    if (live) {
      const int n = min(kDropTile, s_end - s0);
      float sc[kDropTile];
      float tmax = m;
#pragma unroll
      for (int j = 0; j < kDropTile; ++j) {
        if (j < n) {
          float d = 0.f;
#pragma unroll kUnrollHD
          for (int c = 0; c < HD; ++c) d = fmaf(qr[c], ks[j][c], d);
          sc[j] = drop_logit(d, scale, brow, row, s0 + j, causal);
          tmax = fmaxf(tmax, sc[j]);
        }
      }
      l *= expf(m - tmax);
#pragma unroll
      for (int j = 0; j < kDropTile; ++j)
        if (j < n) l += expf(sc[j] - tmax);
      m = tmax;
    }
    __syncthreads();
  }

  // pass 2: dropped weights times V
  float acc[HD];
#pragma unroll kUnrollHD
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  for (int s0 = 0; s0 < s_end; s0 += kDropTile) {
    load_tile<HD>(ks, kb, s0, kDropTile, S);
    load_tile<HD>(vs, vb, s0, kDropTile, S);
    __syncthreads();
    if (live) {
      const int n = min(kDropTile, s_end - s0);
      for (int j = 0; j < n; ++j) {
        float d = 0.f;
#pragma unroll kUnrollHD
        for (int c = 0; c < HD; ++c) d = fmaf(qr[c], ks[j][c], d);
        const int col = s0 + j;
        const float s = drop_logit(d, scale, brow, row, col, causal);
        const float w = expf(s - m) / l * drop_factor(drop, row, col, salt);
#pragma unroll kUnrollHD
        for (int c = 0; c < HD; ++c) acc[c] = fmaf(w, vs[j][c], acc[c]);
      }
    }
    __syncthreads();
  }
  if (live) {
    float* o = out + ((size_t)bh * L + row) * HD;
#pragma unroll kUnrollHD
    for (int c = 0; c < HD; ++c) o[c] = acc[c];
    stats[((size_t)bh * L + row) * 2] = m;
    stats[((size_t)bh * L + row) * 2 + 1] = l;
  }
}

// dQ, D = rowsum(dw * w) and dbias: one thread per query row.
template <int HD>
__global__ void __launch_bounds__(kDropRows)
attention_dropout_dq_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            const int* __restrict__ seed,
                            const float* __restrict__ dout,
                            const float* __restrict__ stats,
                            float* __restrict__ dq, float* __restrict__ dsum,
                            float* __restrict__ dbias, int L, int S,
                            int causal, float scale, DropoutSpec drop) {
  constexpr int kUnrollHD = mma::unroll_hd(HD);
  // K and V tiles, then each thread's own dO row, padded (dq_f32_smem)
  float (*ks)[HD] = reinterpret_cast<float (*)[HD]>(mma::attn_smem);
  float (*vs)[HD] = ks + kDropTile;
  float (*dos)[HD + 1] = reinterpret_cast<float (*)[HD + 1]>(vs + kDropTile);
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kDropRows;
  const int row = row0 + threadIdx.x;
  const bool live = row < L;
  const float* kb = k + (size_t)bh * S * HD;
  const float* vb = v + (size_t)bh * S * HD;
  const size_t rix = (size_t)bh * L + row;
  const float* brow = bias && live ? bias + rix * S : nullptr;
  float* dbrow = dbias && live ? dbias + rix * S : nullptr;
  const unsigned int salt = (unsigned int)seed[0] + (unsigned int)bh * 0xC2B2AE35u;
  const int s_end = causal ? min(S, row0 + kDropRows) : S;

  float qr[HD];
#pragma unroll kUnrollHD
  for (int c = 0; c < HD; ++c) {
    qr[c] = live ? q[rix * HD + c] : 0.f;
    dos[threadIdx.x][c] = live ? dout[rix * HD + c] : 0.f;
  }
  const float m = live ? stats[rix * 2] : 0.f;
  const float l = live ? stats[rix * 2 + 1] : 1.f;

  // pass 1: D = sum_j w_j * mask_j * (do . v_j)
  float dsumr = 0.f;
  for (int s0 = 0; s0 < s_end; s0 += kDropTile) {
    load_tile<HD>(ks, kb, s0, kDropTile, S);
    load_tile<HD>(vs, vb, s0, kDropTile, S);
    __syncthreads();
    if (live) {
      const int n = min(kDropTile, s_end - s0);
      for (int j = 0; j < n; ++j) {
        float d = 0.f, dp = 0.f;
#pragma unroll kUnrollHD
        for (int c = 0; c < HD; ++c) {
          d = fmaf(qr[c], ks[j][c], d);
          dp = fmaf(dos[threadIdx.x][c], vs[j][c], dp);
        }
        const int col = s0 + j;
        const float w =
            expf(drop_logit(d, scale, brow, row, col, causal) - m) / l;
        dsumr = fmaf(w * drop_factor(drop, row, col, salt), dp, dsumr);
      }
    }
    __syncthreads();
  }

  // pass 2: dlogits = w * (dp * mask - D); dq += dlogits * k; dbias
  float dqa[HD];
#pragma unroll kUnrollHD
  for (int c = 0; c < HD; ++c) dqa[c] = 0.f;
  for (int s0 = 0; s0 < s_end; s0 += kDropTile) {
    load_tile<HD>(ks, kb, s0, kDropTile, S);
    load_tile<HD>(vs, vb, s0, kDropTile, S);
    __syncthreads();
    if (live) {
      const int n = min(kDropTile, s_end - s0);
      for (int j = 0; j < n; ++j) {
        float d = 0.f, dp = 0.f;
#pragma unroll kUnrollHD
        for (int c = 0; c < HD; ++c) {
          d = fmaf(qr[c], ks[j][c], d);
          dp = fmaf(dos[threadIdx.x][c], vs[j][c], dp);
        }
        const int col = s0 + j;
        const float w =
            expf(drop_logit(d, scale, brow, row, col, causal) - m) / l;
        const float dl = w * (dp * drop_factor(drop, row, col, salt) - dsumr);
        if (dbrow) dbrow[col] = dl;
#pragma unroll kUnrollHD
        for (int c = 0; c < HD; ++c) dqa[c] = fmaf(dl, ks[j][c], dqa[c]);
      }
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll kUnrollHD
    for (int c = 0; c < HD; ++c) dq[rix * HD + c] = dqa[c] * scale;
    dsum[rix] = dsumr;
    if (dbrow)  // the skipped causal columns: dlogits is exactly 0 there
      for (int col = s_end; col < S; ++col) dbrow[col] = 0.f;
  }
}

// dK and dV: one thread per key row, looping over tiles of query rows.
template <int HD>
__global__ void __launch_bounds__(kDropRows)
attention_dropout_dkv_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ bias,
                             const int* __restrict__ seed,
                             const float* __restrict__ dout,
                             const float* __restrict__ stats,
                             const float* __restrict__ dsum,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int L, int S, int causal, float scale,
                             DropoutSpec drop) {
  constexpr int kUnrollHD = mma::unroll_hd(HD);
  // each thread's own K and V rows, padded, then the q and dO tiles
  // (dkv_f32_smem bytes)
  float (*kss)[HD + 1] = reinterpret_cast<float (*)[HD + 1]>(mma::attn_smem);
  float (*vss)[HD + 1] = kss + kDropRows;
  float (*qs)[HD] = reinterpret_cast<float (*)[HD]>(vss + kDropRows);
  float (*dos)[HD] = qs + kDropQTile;
  __shared__ float ms[kDropQTile], ls[kDropQTile], ds[kDropQTile];
  const int bh = blockIdx.y;
  const int col0 = blockIdx.x * kDropRows;
  const int col = col0 + threadIdx.x;
  const bool live = col < S;
  const float* qb = q + (size_t)bh * L * HD;
  const float* dob = dout + (size_t)bh * L * HD;
  const unsigned int salt = (unsigned int)seed[0] + (unsigned int)bh * 0xC2B2AE35u;

  for (int i = threadIdx.x; i < kDropRows * HD; i += blockDim.x) {
    const int r = i / HD, c = i % HD;
    const bool in = col0 + r < S;
    const size_t at = ((size_t)bh * S + col0 + r) * HD + c;
    kss[r][c] = in ? k[at] : 0.f;
    vss[r][c] = in ? v[at] : 0.f;
  }
  float dka[HD], dva[HD];
#pragma unroll kUnrollHD
  for (int c = 0; c < HD; ++c) dka[c] = dva[c] = 0.f;

  // rows above the block's first key see none of its keys under causal
  for (int r0 = causal ? col0 : 0; r0 < L; r0 += kDropQTile) {
    __syncthreads();
    load_tile<HD>(qs, qb, r0, kDropQTile, L);
    load_tile<HD>(dos, dob, r0, kDropQTile, L);
    if (threadIdx.x < kDropQTile) {
      const int r = r0 + threadIdx.x;
      const size_t rix = (size_t)bh * L + r;
      ms[threadIdx.x] = r < L ? stats[rix * 2] : 0.f;
      ls[threadIdx.x] = r < L ? stats[rix * 2 + 1] : 1.f;
      ds[threadIdx.x] = r < L ? dsum[rix] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int n = min(kDropQTile, L - r0);
    for (int i = 0; i < n; ++i) {
      const int row = r0 + i;
      float d = 0.f, dp = 0.f;
#pragma unroll kUnrollHD
      for (int c = 0; c < HD; ++c) {
        d = fmaf(qs[i][c], kss[threadIdx.x][c], d);
        dp = fmaf(dos[i][c], vss[threadIdx.x][c], dp);
      }
      const float* brow = bias ? bias + ((size_t)bh * L + row) * S : nullptr;
      const float w =
          expf(drop_logit(d, scale, brow, row, col, causal) - ms[i]) / ls[i];
      const float f = drop_factor(drop, row, col, salt);
      const float wd = w * f;
      const float dl = w * (dp * f - ds[i]);
#pragma unroll kUnrollHD
      for (int c = 0; c < HD; ++c) {
        dva[c] = fmaf(wd, dos[i][c], dva[c]);
        dka[c] = fmaf(dl, qs[i][c], dka[c]);
      }
    }
  }
  if (live) {
    const size_t at = ((size_t)bh * S + col) * HD;
#pragma unroll kUnrollHD
    for (int c = 0; c < HD; ++c) {
      dk[at + c] = dka[c] * scale;
      dv[at + c] = dva[c];
    }
  }
}

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
    const unsigned int salt = drop_salt(a.seed, bh);
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
  const unsigned int salt = drop ? drop_salt(a.seed, bh) : 0u;
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
// Entry points: f32 runs the first design above, bf16 the tensor cores
// ---------------------------------------------------------------------------

struct DropoutArgs {
  const void *q, *k, *v, *bias, *seed, *dout, *stats;
  void *out, *dq, *dk, *dv, *dbias, *dsum;
  int BH, L, S, causal;
  float scale;
  DropoutSpec drop;
};

template <int HD>
constexpr size_t fwd_f32_smem() {
  return 2 * kDropTile * HD * sizeof(float);
}
template <int HD>
constexpr size_t dq_f32_smem() {
  return (2 * kDropTile * HD + kDropRows * (HD + 1)) * sizeof(float);
}
template <int HD>
constexpr size_t dkv_f32_smem() {
  return (2 * kDropRows * (HD + 1) + 2 * kDropQTile * HD) * sizeof(float);
}

template <int HD>
static int launch_fwd(const DropoutArgs& a, cudaStream_t st) {
  static bool opted_in = false;
  int err;
  if ((err = mma::smem_opt_in(attention_dropout_fwd_kernel<HD>,
                              fwd_f32_smem<HD>(), opted_in)))
    return err;
  dim3 grid((a.L + kDropRows - 1) / kDropRows, a.BH);
  attention_dropout_fwd_kernel<HD><<<grid, kDropRows, fwd_f32_smem<HD>(),
                                     st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.bias, (const int*)a.seed, (float*)a.out,
      (float*)a.stats, a.L, a.S, a.causal, a.scale, a.drop);
  return 0;
}

template <int HD>
static int launch_bwd(const DropoutArgs& a, cudaStream_t st) {
  static bool dq_in = false, dkv_in = false;
  int err;
  if ((err = mma::smem_opt_in(attention_dropout_dq_kernel<HD>,
                              dq_f32_smem<HD>(), dq_in)) ||
      (err = mma::smem_opt_in(attention_dropout_dkv_kernel<HD>,
                              dkv_f32_smem<HD>(), dkv_in)))
    return err;
  dim3 grid_q((a.L + kDropRows - 1) / kDropRows, a.BH);
  attention_dropout_dq_kernel<HD><<<grid_q, kDropRows, dq_f32_smem<HD>(),
                                    st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.bias, (const int*)a.seed, (const float*)a.dout,
      (const float*)a.stats, (float*)a.dq, (float*)a.dsum,
      (float*)a.dbias, a.L, a.S, a.causal, a.scale, a.drop);
  dim3 grid_k((a.S + kDropRows - 1) / kDropRows, a.BH);
  attention_dropout_dkv_kernel<HD><<<grid_k, kDropRows, dkv_f32_smem<HD>(),
                                     st>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.bias, (const int*)a.seed, (const float*)a.dout,
      (const float*)a.stats, (const float*)a.dsum, (float*)a.dk,
      (float*)a.dv, a.L, a.S, a.causal, a.scale, a.drop);
  return 0;
}

template <int HD>
static int launch_f32(const DropoutArgs& a, bool backward, cudaStream_t st) {
  return backward ? launch_bwd<HD>(a, st) : launch_fwd<HD>(a, st);
}

static int dispatch_f32(const DropoutArgs& a, int D, bool backward,
                        cudaStream_t st) {
  int err;
  switch (D) {
    case 16: err = launch_f32<16>(a, backward, st); break;
    case 32: err = launch_f32<32>(a, backward, st); break;
    case 64: err = launch_f32<64>(a, backward, st); break;
    case 128: err = launch_f32<128>(a, backward, st); break;
    case 256: err = launch_f32<256>(a, backward, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

static int dispatch_bf16(const DropoutArgs& a, int D, bool backward,
                         cudaStream_t st) {
  if (!backward) {
    mma::FwdArgs f{};
    f.q = (const bf16*)a.q; f.k = (const bf16*)a.k; f.v = (const bf16*)a.v;
    f.bias = (const float*)a.bias; f.seed = (const int*)a.seed;
    f.out = (bf16*)a.out; f.stats = (float*)a.stats;
    f.L = a.L; f.S = a.S; f.scale = a.scale; f.drop = a.drop;
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
// on the device; out (BH, L, D) of q's dtype, stats (BH, L, 2) f32 (row max,
// row sum of exponentials). Returns a cudaError_t code.
extern "C" int v2m_attention_dropout_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    const void* seed, void* out, void* stats, int BH, int L, int S, int D,
    int causal, float scale, unsigned int threshold, float keep_scale,
    int apply, void* stream) {
  v2m::DropoutArgs a{};
  a.q = q; a.k = k; a.v = v; a.bias = bias; a.seed = seed;
  a.out = out; a.stats = stats;
  a.BH = BH; a.L = L; a.S = S; a.causal = causal; a.scale = scale;
  a.drop = v2m::DropoutSpec{threshold, keep_scale, apply};
  return v2m::run(dtype, a, D, false, stream);
}

// The backward of v2m_attention_dropout_fwd from its stats and its output
// `out` (read by bf16 for D = rowsum(dout * out); f32 recomputes D): dq
// (BH, L, D), dk/dv (BH, S, D) of q's dtype, dbias (BH, L, S) f32 when bias
// is given (else null), dsum (BH, L) f32 scratch. Returns a cudaError_t
// code.
extern "C" int v2m_attention_dropout_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    const void* seed, const void* dout, const void* stats, const void* out,
    void* dq, void* dk, void* dv, void* dbias, void* dsum, int BH, int L,
    int S, int D, int causal, float scale, unsigned int threshold,
    float keep_scale, int apply, void* stream) {
  v2m::DropoutArgs a{};
  a.q = q; a.k = k; a.v = v; a.bias = bias; a.seed = seed; a.dout = dout;
  a.stats = stats; a.out = const_cast<void*>(out);
  a.dq = dq; a.dk = dk; a.dv = dv; a.dbias = dbias; a.dsum = dsum;
  a.BH = BH; a.L = L; a.S = S; a.causal = causal; a.scale = scale;
  a.drop = v2m::DropoutSpec{threshold, keep_scale, apply};
  return v2m::run(dtype, a, D, true, stream);
}
