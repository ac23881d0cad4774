// f32 attention on the tensor cores in split TF32 (3xTF32): the forward of
// rows 1 and 11 (flash_attention.cu, flash_attention_dropout.cu) and row
// 11's backward (dQ, then dK / dV), head sizes 16, 32, 64, 128 and 256
// (the wrappers pad the others up; above 256 attention_wide.cuh).
//
// Replaces the first f32 design of both rows: one thread a query (or key)
// row, a dependent FMA chain for every product, no tensor cores (at head
// sizes 128 and 256 a thread's row spilled to local memory). The Pallas
// kernels keep f32 logits and softmax and round the weights to v's dtype
// before P . V (ops/pallas_attention.py:62, pallas_attention_dropout.py:99),
// a no-op in f32: every product stays at f32 accuracy. Single TF32 (10
// mantissa bits) would keep ~3 digits; split TF32 keeps f32's: x = big +
// small with big = cvt.rna.tf32(x), small = cvt.rna.tf32(x - big), and
// a b ~= a_small b_big + a_big b_small + a_big b_big, the two small cross
// terms accumulated first (CUTLASS's OpMultiplyAddFastF32). A product is
// then ~2^-21 of itself off (the dropped a_small b_small and the rounding
// of the small parts). The result does not depend on
// torch.backends.cuda.matmul.allow_tf32.
//
// Products are mma.sync.m16n8k8 tf32 with f32 accumulators, one warp per 16
// rows. Fragments (PTX ISA, "Matrix fragments for mma.m16n8k8"), with g =
// lane / 4 and t = lane % 4: an A operand (16 x 8) holds (row g, k t), (row
// g + 8, k t), (row g, k t + 4), (row g + 8, k t + 4); B (8 x 8) holds (k t,
// n g) and (k t + 4, n g); C (16 x 8) holds (row g, n 2t and 2t + 1) and
// (row g + 8, the same), as bf16's m16n8k16 (attention_mma.cuh). So a C tile
// is no A operand as it stands (its lane holds columns 2t, 2t + 1 where A
// wants k t, t + 4). The products whose A is a C tile (P . V, dS . K,
// (P * mask)^T dO, dS^T Q) take its columns {2t, 2t + 1} as k {t, t + 4}
// and read their B rows in the same order (rows 2t and 2t + 1 of each 8):
// no shuffles. The tensor cores truncate each sum toward zero, so no chain
// of mma on one accumulator runs over a whole head or a whole call: 4
// k-slices of q K^T, or one chunk of P . V, then a rounded add.
//
// Rows stream through shared memory in chunks filled by 16-byte cp.async
// copies, double-buffered; rows past the end are zero-filled. A row is
// padded by 4 floats, so the scalar B loads of both patterns (row g at k t
// and t + 4; rows 2t and 2t + 1 at column g) fall into 32 distinct banks.
// The rows a warp keeps for the whole call (q, and dO in dQ; K and V in
// dK/dV) stay raw in registers below head size 64 and are split at use;
// from 64 they sit in shared memory and are split at load. At head size
// 256 the dK / dV accumulators (2 x 128 floats a lane) are taken in two
// passes of half the columns each.
//
// What bounds it on the H100: at row 11's training shape (B*H = 128,
// L = S = 300, head size 64) the forward moves 39.3 MB in f32 (11.7 us at
// 3.35 TB/s) and does two (L, S, D) products, 2.9 GFLOP (6.0 us at 495
// TFLOP/s TF32; the split makes it three products on the card); the
// backward moves 68.8 MB (20.5 us) and does five, 7.4 GFLOP. The bytes
// bound both; three TF32 products a product, the splits and the softmax
// are the instructions a warp issues.
#pragma once

#include "attention_mma.cuh"

namespace v2m {
namespace tf32 {

using mma::attn_smem;
using mma::kLog2e;

// The tiling of a head size: rows of a shared chunk (the forward's keys;
// the backward's keys (dQ) or queries (dK/dV)), where the warps' own rows
// live, and the dK/dV column passes.
template <int HD> struct Tile {
  static constexpr int kStride = HD + 4;               // floats a padded row
  static constexpr int kFwdKeys = HD <= 64 ? 64 : 32;  // forward chunk
  static constexpr int kBwdRows = HD <= 64 ? 32 : 16;  // backward chunk
  // a warp's own rows in shared memory from 64 (in registers they spilled
  // beside the accumulators, or held the forward to one block an SM)
  static constexpr bool kSmemRows = HD >= 64;
  static constexpr int kPasses = HD > 128 ? 2 : 1;     // dK/dV column passes
};

// Head-dim k-slices whose products one chain of mma accumulates before the
// chain is added, rounded to nearest, into the product's sum. The tensor
// cores truncate each product's sum to the accumulator's precision, up to
// an ulp of the accumulator a product, always toward zero: one chain over
// a whole head of 256 moved dP so far that row 0 of a causal dQ (exactly 0)
// left chip_smoke.py's f32 bound. Chains of 4 slices (32 columns) keep
// both the chain and its sum short.
constexpr int kChainSlices = 4;

// x rounded to TF32, nearest with ties away from zero.
__device__ __forceinline__ uint32_t rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32.
__device__ __forceinline__ void split(const float (&x)[4], uint32_t (&big)[4],
                                      uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    big[e] = rna(x[e]);
    small[e] = rna(x[e] - __uint_as_float(big[e]));
  }
}

// d += a b: one m16n8k8 TF32 product with f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in split TF32, a split (big, small), b its raw f32 (b0, b1): the
// small cross terms first, then big . big.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0,
                                     float b1) {
  const uint32_t bb0 = rna(b0), bb1 = rna(b1);
  const uint32_t bs0 = rna(b0 - __uint_as_float(bb0));
  const uint32_t bs1 = rna(b1 - __uint_as_float(bb1));
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// Raw A operand of k-slice kk of the 16 rows at `rows` (stride floats a row).
__device__ __forceinline__ void load_a(float (&a)[4], const float* rows,
                                       int stride, int kk, int lane) {
  const float* pa = rows + (lane >> 2) * stride + kk * 8 + (lane & 3);
  const float* pb = pa + 8 * stride;
  a[0] = pa[0];
  a[1] = pb[0];
  a[2] = pa[4];
  a[3] = pb[4];
}

// Raw A operands of 16 rows r0.. of a (rows, HD) f32 matrix in device
// memory, every k-slice; rows at or past `limit` are zero.
template <int HD>
__device__ __forceinline__ void load_rows_a(float (&a)[HD / 8][4],
                                            const float* __restrict__ m,
                                            int r0, int limit, int lane) {
  const int ra = r0 + (lane >> 2), rb = ra + 8, t = lane & 3;
  const float* pa = m + (size_t)ra * HD + t;
  const float* pb = m + (size_t)rb * HD + t;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    a[kk][0] = ra < limit ? pa[kk * 8] : 0.f;
    a[kk][1] = rb < limit ? pb[kk * 8] : 0.f;
    a[kk][2] = ra < limit ? pa[kk * 8 + 4] : 0.f;
    a[kk][3] = rb < limit ? pb[kk * 8 + 4] : 0.f;
  }
}

// Rows r0 .. r0 + ROWS - 1 of a (rows, HD) f32 matrix into padded shared
// rows by the block's THREADS threads; rows at or past `limit` zero.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int limit) {
  constexpr int kPieces = HD / 4;  // 16-byte pieces a row
  constexpr int kTotal = ROWS * kPieces;
#pragma unroll
  for (int it = 0; it < (kTotal + THREADS - 1) / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    if (kTotal % THREADS != 0 && i >= kTotal) break;
    const int r = i / kPieces, c = (i % kPieces) * 4;
    const bool ok = r0 + r < limit;
    mma::cp_async16(dst + r * Tile<HD>::kStride + c,
                    src + (size_t)(ok ? r0 + r : 0) * HD + c, ok);
  }
}

// A warp's own 16 rows: raw in registers (x, loaded by load_rows_a) or in
// shared memory (SMEM: s, padded rows); of(kk, a) gives k-slice kk.
template <int HD, bool SMEM> struct OwnRows {
  float x[SMEM ? 1 : HD / 8][4];
  const float* s;
  __device__ __forceinline__ void of(int kk, float (&a)[4], int lane) const {
    if constexpr (SMEM) {
      load_a(a, s, Tile<HD>::kStride, kk, lane);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = x[kk][e];
    }
  }
};

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

// acc (16 x NT*8) += A (16 x HD) . R^T, A a warp's own rows, R the NT*8
// rows of a shared chunk at `rows` (B: k = head dim, n = row), in chains
// of kChainSlices k-slices.
template <int HD, int NT, bool SMEM>
__device__ __forceinline__ void mma_rowsT(float (&acc)[NT][4],
                                          const OwnRows<HD, SMEM>& a,
                                          const float* rows, int lane) {
  constexpr int ST = Tile<HD>::kStride, DT = HD / 8;
  constexpr int CH = DT < kChainSlices ? DT : kChainSlices;
  const float* r = rows + (lane >> 2) * ST + (lane & 3);
#pragma unroll
  for (int k0 = 0; k0 < DT; k0 += CH) {
    float part[NT][4];
    zero(part);
#pragma unroll
    for (int kk = k0; kk < k0 + CH; ++kk) {
      float x[4];
      a.of(kk, x, lane);
      uint32_t ab[4], as[4];
      split(x, ab, as);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma3(part[n], ab, as, r[n * 8 * ST + kk * 8],
             r[n * 8 * ST + kk * 8 + 4]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
}

// acc (16 x NC*8, columns col0..) += C (16 x NK*8, C tiles) . R, R the
// NK*8 rows of a shared chunk at `rows` (B: k = row, n = head dim): tile
// j's columns {2t, 2t + 1} taken as k {t, t + 4}, R's rows 8j + 2t and
// 8j + 2t + 1 read to match. The chunk's products form one chain, added to
// acc rounded to nearest: acc runs over every chunk of the call, and one
// chain over all of them let the truncation bias it by an ulp a product.
template <int HD, int NK, int NC>
__device__ __forceinline__ void mma_rows(float (&acc)[NC][4],
                                         const float (&c)[NK][4],
                                         const float* rows, int col0,
                                         int lane) {
  constexpr int ST = Tile<HD>::kStride;
  const float* r = rows + 2 * (lane & 3) * ST + col0 + (lane >> 2);
  float part[NC][4];
  zero(part);
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const float x[4] = {c[j][0], c[j][2], c[j][1], c[j][3]};
    uint32_t ab[4], as[4];
    split(x, ab, as);
#pragma unroll
    for (int n = 0; n < NC; ++n)
      mma3(part[n], ab, as, r[j * 8 * ST + n * 8],
           r[(j * 8 + 1) * ST + n * 8]);
  }
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// ---------------------------------------------------------------------------
// The forward: softmax(q k^T * scale + bias + causal) [* dropout] v
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float *q, *k, *v;
  const float* bias;  // (planes, L, S) or null; (b, h) reads plane bh % planes
  const int* seed;    // dropout only
  float* out;
  float* stats;       // dropout only: (BH, L, 2) row max, row sum
  int L, S;
  float scale;
  DropoutSpec drop;
};

template <int HD, int WARPS>
constexpr size_t fwd_smem() {
  return (4 * Tile<HD>::kFwdKeys + (Tile<HD>::kSmemRows ? WARPS * 16 : 0)) *
         Tile<HD>::kStride * sizeof(float);
}

// One block: WARPS warps of 16 query rows of one (b, h), one pass over the
// key chunks with the running row max m and sum l (f32 has no rounding
// point between the softmax and P . V, so no second pass): each chunk's
// weights exp(s - m) [* the dropout factor] times V into an accumulator
// rescaled by exp(m_old - m) as m grows, divided by l at the end. DROPOUT
// draws the mask and writes the stats (m, l) for the backward.
template <int HD, int WARPS, bool CAUSAL, bool DROPOUT>
__device__ __forceinline__ void fwd_body(const FwdArgs& a) {
  using T = Tile<HD>;
  constexpr int KC = T::kFwdKeys, NT = KC / 8, DT = HD / 8, ST = T::kStride;
  float* ks = reinterpret_cast<float*>(attn_smem);  // K chunks, two
  float* vs = ks + 2 * KC * ST;                     // V chunks, two
  float* qs = vs + 2 * KC * ST;                     // the block's q rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // grid (row blocks, bias planes, B*H / planes), as attention_mma.cuh's
  const int bh = DROPOUT ? blockIdx.y : blockIdx.z * gridDim.y + blockIdx.y;
  const int blk0 = blockIdx.x * WARPS * 16;
  const int r0 = blk0 + warp * 16;
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  const int c2 = (lane & 3) * 2;
  const int L = a.L, S = a.S;
  const float* qb = a.q + (size_t)bh * L * HD;
  const float* kb = a.k + (size_t)bh * S * HD;
  const float* vb = a.v + (size_t)bh * S * HD;
  const size_t bp = DROPOUT ? bh : blockIdx.y;
  const float* ba = a.bias && ra < L ? a.bias + (bp * L + ra) * S : nullptr;
  const float* bb = a.bias && rb < L ? a.bias + (bp * L + rb) * S : nullptr;

  // chunks the block loads; chunks this warp computes (none past L; under
  // causal none wholly above its diagonal)
  int n_chunks = (S + KC - 1) / KC;
  if (CAUSAL) n_chunks = min(n_chunks, (blk0 + WARPS * 16 - 1) / KC + 1);
  int mine = CAUSAL ? min(n_chunks, (r0 + 15) / KC + 1) : n_chunks;
  if (r0 >= L) mine = 0;

  auto issue = [&](int c) {
    load_rows<HD, KC, WARPS * 32>(ks + (c & 1) * KC * ST, kb, c * KC, S);
    load_rows<HD, KC, WARPS * 32>(vs + (c & 1) * KC * ST, vb, c * KC, S);
    mma::cp_async_commit();
  };
  OwnRows<HD, T::kSmemRows> q;
  if constexpr (T::kSmemRows) {
    load_rows<HD, WARPS * 16, WARPS * 32>(qs, qb, blk0, L);
    q.s = qs + warp * 16 * ST;
  } else {
    load_rows_a<HD>(q.x, qb, r0, L, lane);
  }
  issue(0);
  unsigned int rta = 0, rtb = 0;
  if (DROPOUT) {
    const unsigned int salt = mma::drop_salt(a.seed, a.drop, bh);
    rta = mma::row_term(ra, salt);
    rtb = mma::row_term(rb, salt);
  }

  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  float o[DT][4];
  zero(o);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      issue(c + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (c < mine) {
      const int c0 = c * KC;
      float s[NT][4];
      zero(s);
      mma_rowsT<HD, NT>(s, q, ks + (c & 1) * KC * ST, lane);
      mma::to_logits<NT, CAUSAL>(s, a.scale, ba, bb, r0, c0, S, lane);
      float xa = ma, xb = mb;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        xa = fmaxf(xa, fmaxf(s[j][0], s[j][1]));
        xb = fmaxf(xb, fmaxf(s[j][2], s[j][3]));
      }
      xa = mma::quad_max(xa);
      xb = mma::quad_max(xb);
      const float xa2 = xa * kLog2e, xb2 = xb * kLog2e;
      // the earlier chunks' factor at the new max: 0 before the first, 1
      // exactly where the max stays
      const float fa = exp2f(ma * kLog2e - xa2), fb = exp2f(mb * kLog2e - xb2);
      la *= fa;
      lb *= fb;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][0] *= fa;
        o[j][1] *= fa;
        o[j][2] *= fb;
        o[j][3] *= fb;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float w = mma::exp_from(s[j][e], e < 2 ? xa2 : xb2);
          if (e < 2) la += w; else lb += w;
          if (DROPOUT && a.drop.apply)
            w *= mma::keep_factor(a.drop, e < 2 ? rta : rtb,
                                  mma::col_term(c0 + j * 8 + c2 + (e & 1)));
          s[j][e] = w;
        }
      }
      mma_rows<HD, NT, DT>(o, s, vs + (c & 1) * KC * ST, 0, lane);
      ma = xa;
      mb = xb;
    }
    __syncthreads();
  }

  if (mine == 0) return;
  la = mma::quad_sum(la);
  lb = mma::quad_sum(lb);
  const float ia = 1.f / la, ib = 1.f / lb;
  float* ob = a.out + (size_t)bh * L * HD;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + c2;
    if (ra < L)
      *reinterpret_cast<float2*>(ob + (size_t)ra * HD + col) =
          make_float2(o[j][0] * ia, o[j][1] * ia);
    if (rb < L)
      *reinterpret_cast<float2*>(ob + (size_t)rb * HD + col) =
          make_float2(o[j][2] * ib, o[j][3] * ib);
  }
  if (DROPOUT && (lane & 3) == 0) {
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

template <int HD, int WARPS, bool CAUSAL>
__global__ void __launch_bounds__(WARPS * 32) attention_fwd_tf32(FwdArgs a) {
  fwd_body<HD, WARPS, CAUSAL, false>(a);
}

template <int HD, int WARPS, bool CAUSAL>
__global__ void __launch_bounds__(WARPS * 32)
attention_dropout_fwd_tf32(FwdArgs a) {
  fwd_body<HD, WARPS, CAUSAL, true>(a);
}

template <int HD, int WARPS, bool CAUSAL, bool DROPOUT>
inline int launch_fwd_inst(const FwdArgs& a, dim3 grid, cudaStream_t st) {
  static bool opted_in = false;
  void (*kernel)(FwdArgs);
  if constexpr (DROPOUT)
    kernel = attention_dropout_fwd_tf32<HD, WARPS, CAUSAL>;
  else
    kernel = attention_fwd_tf32<HD, WARPS, CAUSAL>;
  constexpr size_t smem = fwd_smem<HD, WARPS>();
  const int err = mma::smem_opt_in(kernel, smem, opted_in);
  if (err) return err;
  kernel<<<grid, WARPS * 32, smem, st>>>(a);
  return 0;
}

template <int HD, int WARPS, bool DROPOUT>
inline int launch_fwd_warps(const FwdArgs& a, int BH, int causal, int planes,
                            cudaStream_t st) {
  dim3 grid((a.L + WARPS * 16 - 1) / (WARPS * 16), planes, BH / planes);
  return causal ? launch_fwd_inst<HD, WARPS, true, DROPOUT>(a, grid, st)
                : launch_fwd_inst<HD, WARPS, false, DROPOUT>(a, grid, st);
}

template <int HD, bool DROPOUT>
inline int launch_fwd_hd(const FwdArgs& a, int BH, int causal, int planes,
                         cudaStream_t st) {
  return mma::fwd_warps(BH, a.L) == 4
             ? launch_fwd_warps<HD, 4, DROPOUT>(a, BH, causal, planes, st)
             : launch_fwd_warps<HD, 2, DROPOUT>(a, BH, causal, planes, st);
}

// Launches the f32 forward for head_dim D (16, 32, 64, 128 or 256) over BH
// (b, h) pairs whose bias has ``planes`` planes (BH, or the head count of a
// bias shared by every batch row; the dropout forward: BH); returns a
// cudaError_t code.
template <bool DROPOUT>
inline int run_fwd(const FwdArgs& a, int BH, int D, int causal,
                   cudaStream_t st, int planes) {
  int err;
  switch (D) {
    case 16: err = launch_fwd_hd<16, DROPOUT>(a, BH, causal, planes, st); break;
    case 32: err = launch_fwd_hd<32, DROPOUT>(a, BH, causal, planes, st); break;
    case 64: err = launch_fwd_hd<64, DROPOUT>(a, BH, causal, planes, st); break;
    case 128: err = launch_fwd_hd<128, DROPOUT>(a, BH, causal, planes, st); break;
    case 256: err = launch_fwd_hd<256, DROPOUT>(a, BH, causal, planes, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row 11's backward: dQ (and D, dbias), then dK / dV; no atomics, the same
// gradients every run
// ---------------------------------------------------------------------------

struct BwdArgs {
  const float *q, *k, *v, *out, *dout;
  const float* bias;   // (BH, L, S) or null
  const int* seed;
  const float* stats;  // (BH, L, 2): the forward's row max and sum
  float *dq, *dk, *dv;
  float* dbias;        // (BH, L, S) when there is a bias, else null
  float* dsum;         // (BH, L): D, written by dQ, read by dK/dV
  int L, S;
  float scale;
  DropoutSpec drop;
};

constexpr int kBwdWarps = 4;  // 64 query (dQ) or key (dK/dV) rows a block

template <int HD>
constexpr size_t bwd_smem() {
  return (4 * Tile<HD>::kBwdRows +
          (Tile<HD>::kSmemRows ? 2 * kBwdWarps * 16 : 0)) *
         Tile<HD>::kStride * sizeof(float);
}

// dQ, D and dbias: a warp per 16 query rows, one pass over the key chunks.
// D = rowsum(dO * O) from the forward's f32 output (equal in exact
// arithmetic to sum_j w_j mask_j (dO . v_j)); per chunk S = Q K^T and dP =
// dO V^T, P from the stats (m, l), dS = P * (dP * mask - D) (dbias when
// there is a bias), dQ += dS K.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kBwdWarps * 32)
attention_dropout_dq_tf32(BwdArgs a) {
  using T = Tile<HD>;
  constexpr int KC = T::kBwdRows, NT = KC / 8, DT = HD / 8, ST = T::kStride;
  float* ks = reinterpret_cast<float*>(attn_smem);  // K chunks, two
  float* vs = ks + 2 * KC * ST;                     // V chunks, two
  float* qs = vs + 2 * KC * ST;                     // the block's q rows
  float* dos = qs + kBwdWarps * 16 * ST;            // and its dO rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int blk0 = blockIdx.x * kBwdWarps * 16;
  const int r0 = blk0 + warp * 16;
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  const int t = lane & 3, c2 = t * 2;
  const int L = a.L, S = a.S;
  const size_t qoff = (size_t)bh * L * HD;
  const float* kb = a.k + (size_t)bh * S * HD;
  const float* vb = a.v + (size_t)bh * S * HD;
  const size_t ia = (size_t)bh * L + ra, ib = (size_t)bh * L + rb;
  const float* ba = a.bias && ra < L ? a.bias + ia * S : nullptr;
  const float* bb = a.bias && rb < L ? a.bias + ib * S : nullptr;
  float* dba = a.dbias && ra < L ? a.dbias + ia * S : nullptr;
  float* dbb = a.dbias && rb < L ? a.dbias + ib * S : nullptr;

  int n_chunks = (S + KC - 1) / KC;
  if (CAUSAL) n_chunks = min(n_chunks, (blk0 + kBwdWarps * 16 - 1) / KC + 1);
  int mine = CAUSAL ? min(n_chunks, (r0 + 15) / KC + 1) : n_chunks;
  if (r0 >= L) mine = 0;

  auto issue = [&](int c) {
    load_rows<HD, KC, kBwdWarps * 32>(ks + (c & 1) * KC * ST, kb, c * KC, S);
    load_rows<HD, KC, kBwdWarps * 32>(vs + (c & 1) * KC * ST, vb, c * KC, S);
    mma::cp_async_commit();
  };
  OwnRows<HD, T::kSmemRows> q, dout;
  if constexpr (T::kSmemRows) {
    constexpr int kRows = kBwdWarps * 16;
    load_rows<HD, kRows, kBwdWarps * 32>(qs, a.q + qoff, blk0, L);
    load_rows<HD, kRows, kBwdWarps * 32>(dos, a.dout + qoff, blk0, L);
    q.s = qs + warp * 16 * ST;
    dout.s = dos + warp * 16 * ST;
  } else {
    load_rows_a<HD>(q.x, a.q + qoff, r0, L, lane);
    load_rows_a<HD>(dout.x, a.dout + qoff, r0, L, lane);
  }
  issue(0);

  float Da = 0.f, Db = 0.f;  // D = rowsum(dO * O): this lane's columns
  {
    const float* da = a.dout + qoff + (size_t)ra * HD + t;
    const float* oa = a.out + qoff + (size_t)ra * HD + t;
#pragma unroll 8
    for (int c = 0; c < HD; c += 4) {
      if (ra < L) Da = fmaf(da[c], oa[c], Da);
      if (rb < L) Db = fmaf(da[8 * HD + c], oa[8 * HD + c], Db);
    }
    Da = mma::quad_sum(Da);
    Db = mma::quad_sum(Db);
  }
  // m log2(e) and 1 / l of each row, from the forward's stats
  float ma2 = 0.f, mb2 = 0.f, inva = 1.f, invb = 1.f;
  if (ra < L) { ma2 = a.stats[ia * 2] * kLog2e; inva = 1.f / a.stats[ia * 2 + 1]; }
  if (rb < L) { mb2 = a.stats[ib * 2] * kLog2e; invb = 1.f / a.stats[ib * 2 + 1]; }
  const bool drop = a.drop.apply != 0;
  unsigned int rta = 0, rtb = 0;
  if (drop) {
    const unsigned int salt = mma::drop_salt(a.seed, a.drop, bh);
    rta = mma::row_term(ra, salt);
    rtb = mma::row_term(rb, salt);
  }

  float dq[DT][4];
  zero(dq);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      issue(c + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (c < mine) {
      const int c0 = c * KC;
      const float* kc = ks + (c & 1) * KC * ST;
      float s[NT][4], dp[NT][4];
      zero(s);
      zero(dp);
      mma_rowsT<HD, NT>(s, q, kc, lane);
      mma_rowsT<HD, NT>(dp, dout, vs + (c & 1) * KC * ST, lane);
      mma::to_logits<NT, CAUSAL>(s, a.scale, ba, bb, r0, c0, S, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool top = e < 2;
          const int col = c0 + j * 8 + c2 + (e & 1);
          // exactly 0 past the last key
          const float p =
              mma::exp_from(s[j][e], top ? ma2 : mb2) * (top ? inva : invb);
          const float f = drop ? mma::keep_factor(a.drop, top ? rta : rtb,
                                                  mma::col_term(col))
                               : 1.f;
          s[j][e] = p * (dp[j][e] * f - (top ? Da : Db));
        }
        const int col = c0 + j * 8 + c2;
        if (dba && col < S) dba[col] = s[j][0];
        if (dba && col + 1 < S) dba[col + 1] = s[j][1];
        if (dbb && col < S) dbb[col] = s[j][2];
        if (dbb && col + 1 < S) dbb[col + 1] = s[j][3];
      }
      mma_rows<HD, NT, DT>(dq, s, kc, 0, lane);
    }
    __syncthreads();
  }

  if (mine == 0) return;
  float* dqb = a.dq + qoff;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + c2;
    if (ra < L)
      *reinterpret_cast<float2*>(dqb + (size_t)ra * HD + col) =
          make_float2(dq[j][0] * a.scale, dq[j][1] * a.scale);
    if (rb < L)
      *reinterpret_cast<float2*>(dqb + (size_t)rb * HD + col) =
          make_float2(dq[j][2] * a.scale, dq[j][3] * a.scale);
  }
  if (t == 0) {
    if (ra < L) a.dsum[ia] = Da;
    if (rb < L) a.dsum[ib] = Db;
  }
  // the key chunks this warp skipped under causal: dS is exactly 0 there
  for (int col = mine * KC + t; col < S; col += 4) {
    if (dba) dba[col] = 0.f;
    if (dbb) dbb[col] = 0.f;
  }
}

// dK and dV: a warp per 16 key rows over chunks of queries (from the
// diagonal chunk under causal), their m, l and D staged beside them: S^T =
// K Q^T, dP^T = V dO^T, dV += (P * mask)^T dO, dK += dS^T Q. At head size
// 256, two passes over the queries, each for half of dK's and dV's columns.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kBwdWarps * 32)
attention_dropout_dkv_tf32(BwdArgs a) {
  using T = Tile<HD>;
  constexpr int KQ = T::kBwdRows, NT = KQ / 8, ST = T::kStride;
  constexpr int NC = HD / 8 / T::kPasses;  // column tiles a pass
  float* qs = reinterpret_cast<float*>(attn_smem);  // q chunks, two
  float* dos = qs + 2 * KQ * ST;                    // dO chunks, two
  float* kss = dos + 2 * KQ * ST;                   // the block's K rows
  float* vss = kss + kBwdWarps * 16 * ST;           // and its V rows
  __shared__ __align__(16) float2 mls[2][KQ];       // (m, l) a query
  __shared__ __align__(16) float dds[2][KQ];        // D a query
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int blk0 = blockIdx.x * kBwdWarps * 16;
  const int k0 = blk0 + warp * 16;
  const int ka = k0 + (lane >> 2), kb = ka + 8;
  const int c2 = (lane & 3) * 2;
  const int L = a.L, S = a.S;
  const size_t qoff = (size_t)bh * L * HD, koff = (size_t)bh * S * HD;
  const float* qb = a.q + qoff;
  const float* dob = a.dout + qoff;
  const float* stb = a.stats + (size_t)bh * L * 2;
  const float* dsb = a.dsum + (size_t)bh * L;
  const float* bias = a.bias ? a.bias + (size_t)bh * L * S : nullptr;

  // queries above the block's first key see none of its keys under causal
  const int n_q = (L + KQ - 1) / KQ;
  const int first = CAUSAL ? min(blk0 / KQ, n_q) : 0;
  const int per_pass = n_q - first, steps = per_pass * T::kPasses;
  auto issue = [&](int i) {
    const int buf = i & 1, c = first + i % per_pass;
    load_rows<HD, KQ, kBwdWarps * 32>(qs + buf * KQ * ST, qb, c * KQ, L);
    load_rows<HD, KQ, kBwdWarps * 32>(dos + buf * KQ * ST, dob, c * KQ, L);
    if (threadIdx.x < KQ) {
      const int r = c * KQ + threadIdx.x;
      const bool ok = r < L;
      mma::cp_async_small<8>(&mls[buf][threadIdx.x],
                             stb + (size_t)(ok ? r : 0) * 2, ok);
      mma::cp_async_small<4>(&dds[buf][threadIdx.x], dsb + (ok ? r : 0), ok);
    }
    mma::cp_async_commit();
  };
  OwnRows<HD, T::kSmemRows> kr, vr;
  if constexpr (T::kSmemRows) {
    constexpr int kRows = kBwdWarps * 16;
    load_rows<HD, kRows, kBwdWarps * 32>(kss, a.k + koff, blk0, S);
    load_rows<HD, kRows, kBwdWarps * 32>(vss, a.v + koff, blk0, S);
    kr.s = kss + warp * 16 * ST;
    vr.s = vss + warp * 16 * ST;
  } else {
    load_rows_a<HD>(kr.x, a.k + koff, k0, S, lane);
    load_rows_a<HD>(vr.x, a.v + koff, k0, S, lane);
  }
  if (steps > 0) issue(0);
  const bool drop = a.drop.apply != 0;
  const unsigned int salt = drop ? mma::drop_salt(a.seed, a.drop, bh) : 0u;
  const unsigned int cta = mma::col_term(ka), ctb = mma::col_term(kb);

  float dk[NC][4], dv[NC][4];
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1, c = first + i % per_pass, pass = i / per_pass;
    if (i % per_pass == 0) {
      zero(dk);
      zero(dv);
    }
    if (i + 1 < steps) {
      issue(i + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = c * KQ;
    // a dead warp; queries past L; or every pair above the diagonal
    if (!(k0 >= S || q0 >= L || (CAUSAL && q0 + KQ - 1 < k0))) {
      const float* qrows = qs + buf * KQ * ST;
      const float* drows = dos + buf * KQ * ST;
      float st[NT][4], dpt[NT][4];  // S^T, then (P * mask)^T; dP^T, then dS^T
      zero(st);
      zero(dpt);
      mma_rowsT<HD, NT>(st, kr, qrows, lane);
      mma_rowsT<HD, NT>(dpt, vr, drows, lane);
      // the diagonal crosses this chunk: some key above some query
      const bool diag = CAUSAL && k0 + 15 > q0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {  // this lane's two queries of tile j
          const int qi = j * 8 + c2 + u;  // in the chunk
          const int row = q0 + qi;        // the query
          const float2 ml = mls[buf][qi];
          const float ml2 = ml.x * kLog2e, inv = 1.f / ml.y, D = dds[buf][qi];
          const unsigned int rt = drop ? mma::row_term(row, salt) : 0u;
#pragma unroll
          for (int e = u; e < 4; e += 2) {
            const int key = e < 2 ? ka : kb;
            float pm = 0.f, ds = 0.f;
            if (row < L) {
              float x = st[j][e] * a.scale;
              if (bias && key < S) x += bias[(size_t)row * S + key];
              if (diag && key > row) x = mma::kNegInf;
              const float p = mma::exp_from(x, ml2) * inv;
              const float f =
                  drop ? mma::keep_factor(a.drop, rt, e < 2 ? cta : ctb) : 1.f;
              pm = p * f;
              ds = p * (dpt[j][e] * f - D);
            }
            st[j][e] = pm;
            dpt[j][e] = ds;
          }
        }
      }
      const int col0 = pass * NC * 8;
      mma_rows<HD, NT, NC>(dv, st, drows, col0, lane);
      mma_rows<HD, NT, NC>(dk, dpt, qrows, col0, lane);
    }
    __syncthreads();
    if (i % per_pass == per_pass - 1) {  // the pass's columns are complete
      float* dkb = a.dk + koff + pass * NC * 8;
      float* dvb = a.dv + koff + pass * NC * 8;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = j * 8 + c2;
        if (ka < S) {
          *reinterpret_cast<float2*>(dkb + (size_t)ka * HD + col) =
              make_float2(dk[j][0] * a.scale, dk[j][1] * a.scale);
          *reinterpret_cast<float2*>(dvb + (size_t)ka * HD + col) =
              make_float2(dv[j][0], dv[j][1]);
        }
        if (kb < S) {
          *reinterpret_cast<float2*>(dkb + (size_t)kb * HD + col) =
              make_float2(dk[j][2] * a.scale, dk[j][3] * a.scale);
          *reinterpret_cast<float2*>(dvb + (size_t)kb * HD + col) =
              make_float2(dv[j][2], dv[j][3]);
        }
      }
    }
  }
}

template <int HD, bool CAUSAL>
inline int launch_bwd_pair(const BwdArgs& a, int BH, cudaStream_t st) {
  constexpr int kRows = kBwdWarps * 16;
  constexpr size_t smem = bwd_smem<HD>();
  static bool dq_in = false, dkv_in = false;
  int err;
  if ((err = mma::smem_opt_in(attention_dropout_dq_tf32<HD, CAUSAL>, smem,
                              dq_in)) ||
      (err = mma::smem_opt_in(attention_dropout_dkv_tf32<HD, CAUSAL>, smem,
                              dkv_in)))
    return err;
  attention_dropout_dq_tf32<HD, CAUSAL>
      <<<dim3((a.L + kRows - 1) / kRows, BH), kBwdWarps * 32, smem, st>>>(a);
  attention_dropout_dkv_tf32<HD, CAUSAL>
      <<<dim3((a.S + kRows - 1) / kRows, BH), kBwdWarps * 32, smem, st>>>(a);
  return 0;
}

template <int HD>
inline int launch_bwd_hd(const BwdArgs& a, int BH, int causal,
                         cudaStream_t st) {
  return causal ? launch_bwd_pair<HD, true>(a, BH, st)
                : launch_bwd_pair<HD, false>(a, BH, st);
}

// Launches the f32 backward (dQ, then dK/dV) for head_dim D (16, 32, 64,
// 128 or 256) over BH (b, h) pairs; returns a cudaError_t code.
inline int run_bwd(const BwdArgs& a, int BH, int D, int causal,
                   cudaStream_t st) {
  int err;
  switch (D) {
    case 16: err = launch_bwd_hd<16>(a, BH, causal, st); break;
    case 32: err = launch_bwd_hd<32>(a, BH, causal, st); break;
    case 64: err = launch_bwd_hd<64>(a, BH, causal, st); break;
    case 128: err = launch_bwd_hd<128>(a, BH, causal, st); break;
    case 256: err = launch_bwd_hd<256>(a, BH, causal, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace tf32
}  // namespace v2m
