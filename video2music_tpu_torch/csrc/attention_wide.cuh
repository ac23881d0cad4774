// Attention above head size 256 (rows 1 and 11 at any head size): the
// head dimension split across blocks, for flash_attention.cu (row 1) and
// flash_attention_dropout.cu (row 11's forward; its backward lives there).
//
// The Pallas wrappers pad D to a multiple of 128 and keep whole rows in
// VMEM (video2music_tpu/ops/pallas_attention.py:143,
// pallas_attention_dropout.py:162). On the H100 the widest instance of
// attention_mma.cuh keeps a q row fragment and a (16, 256) f32 accumulator
// in registers and two 256-wide K/V chunks in shared memory; a wider head
// does not fit. So here a block owns one column slice of kWide columns of
// O (the wrappers pad D with zero columns to a multiple of kWide: zero
// columns change neither q . k nor the kept columns of P . V) and forms
// S = q k^T over the whole head in a loop over kWide-column chunks of q
// and k, then P . V over its own slice of V. Each of the D / kWide blocks
// of a row block computes the same S: the recomputation is the price of
// keeping every chunk within the registers and shared memory of today's
// 64-wide instance. The chunk loop visits the block's own slice last, so
// the backward's last chunk is the slice its products need.
// The dropout mask hashes (plane, row, column) only, so it is bit for bit
// that of the narrow instances, whatever the slice.
//
// What bounds it: at row 11's hd 512 training shape (B*H = 16, L = S =
// 300) the forward moves 19.7 MB in bf16 (5.9 us at 3.35 TB/s) and needs
// two (L, S, D) products, 2.9 GFLOP (3.0 us at 989 TFLOP/s); it computes
// S D / kWide + 1 times instead of twice, so the tensor cores' work, not
// the bytes, sets its floor (computed from the shapes, not measured).
//
// bf16 runs on the tensor cores with attention_mma.cuh's blocks (64-row
// chunks double-buffered by cp.async, mma.sync m16n8k16, f32
// accumulators, the weights rounded to bf16 as the narrow forward rounds
// them); f32 (the parity path) is one thread per query row with plain FMA.
// Both take the forward's two passes (row max and sum, then the weights
// times V). The kernels get D as a parameter of their own beside the
// narrow instances' argument structs, which keep their size.
#pragma once

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
// above the causal diagonal (drop_logit of flash_attention_dropout.cu).
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
// bf16 forward on the tensor cores: a warp per 16 query rows, kWide output
// columns a block
// ---------------------------------------------------------------------------

// grid (row blocks x slices, planes, BH / planes), as the f32 forward. Two
// passes over the key chunks, each chunk in nd steps of kWide columns: the
// step's K columns (and, at a chunk's last step of pass 1, the slice's V
// columns) double-buffered by cp.async, the step's q fragment from device
// memory (L2), S accumulated over the steps; at a chunk's last step the
// logits, then pass 0's row max and sum or pass 1's weights (rounded to
// bf16 [* the dropout factor]) times V, as mma::fwd_mma_body.
template <int WARPS, bool CAUSAL, bool DROPOUT>
__global__ void __launch_bounds__(WARPS * 32)
attention_fwd_wide_mma(mma::FwdArgs a, int D) {
  using namespace mma;
  constexpr int kNT = kChunk / 8;
  constexpr int kDT = kWide / 8;
  bf16 (*ks)[Chunk<kWide>::kElems] =
      reinterpret_cast<bf16 (*)[Chunk<kWide>::kElems]>(attn_smem);
  bf16 (*vs)[Chunk<kWide>::kElems] = ks + 2;
  const int nd = D / kWide;
  const int slice = blockIdx.x % nd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const int blk0 = (blockIdx.x / nd) * WARPS * 16;
  const int r0 = blk0 + warp * 16;
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  const int c2 = (lane & 3) * 2;
  const int L = a.L, S = a.S;
  const bf16* qb = a.q + (size_t)bh * L * D;
  const bf16* kb = a.k + (size_t)bh * S * D;
  const bf16* vb = a.v + (size_t)bh * S * D;
  const size_t bp = blockIdx.y;
  const float* ba = a.bias && ra < L ? a.bias + (bp * L + ra) * S : nullptr;
  const float* bb = a.bias && rb < L ? a.bias + (bp * L + rb) * S : nullptr;

  int n_chunks = (S + kChunk - 1) / kChunk;
  if (CAUSAL) n_chunks = min(n_chunks, (blk0 + WARPS * 16 - 1) / kChunk + 1);
  int mine = CAUSAL ? min(n_chunks, (r0 + 15) / kChunk + 1) : n_chunks;
  if (r0 >= L) mine = 0;
  unsigned int rta = 0, rtb = 0;
  if (DROPOUT) {
    const unsigned int salt = drop_salt(a.seed, a.drop, bh);
    rta = row_term(ra, salt);
    rtb = row_term(rb, salt);
  }

  // step t: pass t / (n_chunks nd), chunk (t / nd) % n_chunks, D-chunk t % nd
  const int per_pass = n_chunks * nd, steps = 2 * per_pass;
  auto issue = [&](int t) {
    const int c = (t / nd) % n_chunks, i = t % nd;
    const int dc = chunk_col(i, slice, nd);
    load_chunk_s<WARPS * 32>(ks[t & 1], kb + dc, c * kChunk, S, D);
    if (t >= per_pass && i == nd - 1)
      load_chunk_s<WARPS * 32>(vs[t & 1], vb + dc, c * kChunk, S, D);
    cp_async_commit();
  };
  issue(0);

  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  float ma2 = 0.f, mb2 = 0.f, ia = 0.f, ib = 0.f;  // m log2(e), 1 / l
  float o[kDT][4], s[kNT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool pass1 = t >= per_pass;
    const int c = (t / nd) % n_chunks, i = t % nd;
    if (c < mine) {
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      }
      uint32_t qf[kWide / 16][4];
      load_a_s(qf, qb + chunk_col(i, slice, nd), r0, L, lane, D);
      mma_a_rowsT<kWide, kNT>(s, qf, ks[t & 1], lane);
      if (i == nd - 1) {
        const int c0 = c * kChunk;
        to_logits<kNT, CAUSAL>(s, a.scale, ba, bb, r0, c0, S, lane);
        if (!pass1) {
          float xa = ma, xb = mb;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            xa = fmaxf(xa, fmaxf(s[j][0], s[j][1]));
            xb = fmaxf(xb, fmaxf(s[j][2], s[j][3]));
          }
          xa = quad_max(xa);
          xb = quad_max(xb);
          const float xa2 = xa * kLog2e, xb2 = xb * kLog2e;
          la *= exp_from(ma, xa2);
          lb *= exp_from(mb, xb2);
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            la += exp_from(s[j][0], xa2) + exp_from(s[j][1], xa2);
            lb += exp_from(s[j][2], xb2) + exp_from(s[j][3], xb2);
          }
          ma = xa;
          mb = xb;
          if (c == mine - 1) {  // the row sums are complete
            la = quad_sum(la);
            lb = quad_sum(lb);
            ma2 = ma * kLog2e;
            mb2 = mb * kLog2e;
            ia = 1.f / la;
            ib = 1.f / lb;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float w = exp_from(s[j][e], e < 2 ? ma2 : mb2) * (e < 2 ? ia : ib);
              if (DROPOUT && a.drop.apply)
                w *= keep_factor(a.drop, e < 2 ? rta : rtb,
                                 col_term(c0 + j * 8 + c2 + (e & 1)));
              s[j][e] = w;
            }
          }
          uint32_t p[kNT / 2][4];
          pack_a<kNT>(p, s);
          mma_a_rows<kWide, kNT / 2>(o, p, vs[t & 1], lane);
        }
      }
    }
    __syncthreads();
  }

  if (mine == 0) return;
  bf16* ob = a.out + (size_t)bh * L * D + slice * kWide;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int col = j * 8 + c2;
    if (ra < L)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)ra * D + col) =
          __floats2bfloat162_rn(o[j][0], o[j][1]);
    if (rb < L)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rb * D + col) =
          __floats2bfloat162_rn(o[j][2], o[j][3]);
  }
  if (DROPOUT && slice == 0 && (lane & 3) == 0) {
    if (ra < L) {
      a.stats[((size_t)bh * L + ra) * 2] = ma;
      a.stats[((size_t)bh * L + ra) * 2 + 1] = la;
    }
    if (rb < L) {
      a.stats[((size_t)bh * L + rb) * 2] = mb;
      a.stats[((size_t)bh * L + rb) * 2 + 1] = lb;
    }
  }
}

constexpr size_t mma_smem() { return mma::fwd_smem<kWide>(); }

template <int WARPS, bool CAUSAL, bool DROPOUT>
inline int launch_fwd_wide(const mma::FwdArgs& a, int D, dim3 grid,
                          cudaStream_t st) {
  attention_fwd_wide_mma<WARPS, CAUSAL, DROPOUT>
      <<<grid, WARPS * 32, mma_smem(), st>>>(a, D);
  return (int)cudaGetLastError();
}

// Launches the bf16 wide forward for head size D (a multiple of kWide)
// over BH planes whose bias has `planes` planes (BH for the dropout
// forward); returns a cudaError_t code. Blocks of 4 warps where they make
// two waves on the card's 132 SMs, else of 2 (mma::fwd_warps).
template <bool DROPOUT>
inline int run_fwd_mma(const mma::FwdArgs& a, int BH, int D, int causal,
                       int planes, cudaStream_t st) {
  if (D % kWide || planes <= 0 || BH % planes)
    return (int)cudaErrorInvalidValue;
  const int nd = D / kWide;
  const int warps = mma::fwd_warps(BH * nd, a.L);
  dim3 grid((a.L + warps * 16 - 1) / (warps * 16) * nd, planes, BH / planes);
  if (warps == 4)
    return causal ? launch_fwd_wide<4, true, DROPOUT>(a, D, grid, st)
                  : launch_fwd_wide<4, false, DROPOUT>(a, D, grid, st);
  return causal ? launch_fwd_wide<2, true, DROPOUT>(a, D, grid, st)
                : launch_fwd_wide<2, false, DROPOUT>(a, D, grid, st);
}

}  // namespace wide
}  // namespace v2m
