// Tensor-core building blocks of the bf16 attention kernels
// (flash_attention.cu, flash_attention_dropout.cu), and the forward they
// share. The f32 kernels (attention_tf32.cuh, split TF32) reuse its
// cp.async copies, logits, softmax and dropout blocks.
//
// Products are bf16 mma.sync.m16n8k16 with f32 accumulators, one warp per
// 16 rows. Their fragments (PTX ISA, "Matrix fragments for mma.m16n8k16"):
// lane l holds, in a C tile of 16 rows x 8 columns, the elements
// (row l/4, columns 2*(l%4) + {0, 1}) in c[0], c[1] and (row l/4 + 8, the
// same columns) in c[2], c[3]. An A operand (16 x 16) is four registers of
// two bf16 each: (row l/4, k 2*(l%4) + {0,1}), (row l/4 + 8, the same k),
// and both again at k + 8. So the C tiles 2j and 2j+1 of a product, rounded
// to bf16 and packed in pairs, are the A operand of k-slice j of the next
// product (pack_a): P, (P*mask)^T and dS never leave registers.
//
// Key (or query) rows stream through shared memory in chunks of 64 rows,
// double-buffered and filled by 16-byte cp.async copies (rows past the end
// are zero-filled). A row is padded by 16 bytes, so the eight 16-byte rows
// one ldmatrix reads fall into distinct banks. ldmatrix gives the B operand
// of q k^T straight from the key rows; ldmatrix.trans gives it of p v from
// the value rows.
#pragma once

#include "common.cuh"

namespace v2m {
namespace mma {

constexpr int kChunk = 64;           // key / query rows per shared chunk
constexpr float kNegInf = -1e9f;     // a masked logit, as the Pallas kernels

// Dynamic shared memory of the attention kernels, one declaration for all
// of them: at a head size of 128 or 256 their tiles pass the 48 KB a
// kernel may declare statically.
extern __shared__ __align__(16) unsigned char attn_smem[];

// Lets `kernel` take `bytes` of dynamic shared memory, once per instance
// (`done`); returns a cudaError_t code.
template <typename K>
inline int smem_opt_in(K kernel, size_t bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

template <int HD> struct Chunk {
  static constexpr int kStride = HD + 8;           // bf16 per padded row
  static constexpr int kElems = kChunk * kStride;  // bf16 per chunk
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 or 8 bytes global -> shared (row statistics), zero-filled when !valid.
template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src,
                                               bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(N), "r"(valid ? N : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b: one m16n8k16 bf16 product with f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), the lower column in the low
// half: one register of an A operand.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// C tiles (NT of 8 columns) -> A operands (NT / 2 k-slices of 16).
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NT / 2][4],
                                       const float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    a[j][0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
    a[j][2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[j][3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

// The A operand of 16 rows r0.. of a (rows, HD) bf16 matrix in device
// memory, HD / 16 k-slices; rows at or past `limit` are zero.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4],
                                       const bf16* __restrict__ m, int r0,
                                       int limit, int lane) {
  const int ra = r0 + (lane >> 2), rb = ra + 8, c = (lane & 3) * 2;
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(m + (size_t)ra * HD + c);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(m + (size_t)rb * HD + c);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    a[kk][0] = ra < limit ? pa[kk * 8] : 0u;
    a[kk][1] = rb < limit ? pb[kk * 8] : 0u;
    a[kk][2] = ra < limit ? pa[kk * 8 + 4] : 0u;
    a[kk][3] = rb < limit ? pb[kk * 8 + 4] : 0u;
  }
}

// Rows r0 .. r0 + 63 of a (rows, HD) bf16 matrix into a padded shared
// chunk by the block's THREADS threads; rows at or past `limit` zero.
template <int HD, int THREADS>
__device__ __forceinline__ void load_chunk(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int r0, int limit) {
  constexpr int kPieces = HD / 8;  // 16-byte pieces a row
  constexpr int kTotal = kChunk * kPieces;
#pragma unroll
  for (int it = 0; it < (kTotal + THREADS - 1) / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    if (kTotal % THREADS != 0 && i >= kTotal) break;
    const int r = i / kPieces, c = (i % kPieces) * 8;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * Chunk<HD>::kStride + c,
               src + (size_t)(ok ? r0 + r : 0) * HD + c, ok);
  }
}

// acc (16 x NT*8) += A (16 x HD) . rows^T, where `rows` points at NT*8
// consecutive rows of a shared chunk (the B operand k = head dim, n = row;
// ldmatrix without .trans).
template <int HD, int NT>
__device__ __forceinline__ void mma_a_rowsT(float (&acc)[NT][4],
                                            const uint32_t (&a)[HD / 16][4],
                                            const bf16* rows, int lane) {
  const int lr = (lane & 7) + ((lane >> 4) << 3);
  const int lc = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int n = 0; n < NT; n += 2) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, rows + (n * 8 + lr) * Chunk<HD>::kStride + kk * 16 + lc);
      mma_bf16(acc[n], a[kk], b[0], b[1]);
      mma_bf16(acc[n + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x HD) += A (16 x NK*16) . rows, where `rows` points at NK*16
// consecutive rows of a shared chunk (the B operand k = row, n = head dim;
// ldmatrix.trans).
template <int HD, int NK>
__device__ __forceinline__ void mma_a_rows(float (&acc)[HD / 8][4],
                                           const uint32_t (&a)[NK][4],
                                           const bf16* rows, int lane) {
  const int lr = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int lc = (lane >> 4) << 3;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, rows + (j * 16 + lr) * Chunk<HD>::kStride + n * 8 + lc);
      mma_bf16(acc[n], a[j], b[0], b[1]);
      mma_bf16(acc[n + 1], a[j], b[2], b[3]);
    }
  }
}

// Sum / max over the four lanes of a quad: the lanes that share a row of a
// C fragment.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ---------------------------------------------------------------------------
// The dropout mask (ops/pallas_attention_dropout.py:_drop_mask)
// ---------------------------------------------------------------------------

}  // namespace mma

struct DropoutSpec {
  unsigned int threshold;  // keep iff hash > threshold
  float keep_scale;        // 1 / (1 - rate), rounded to f32
  // 0: rate 0, no mask at all; 1: the mask; 2: a shard's mask, its seed
  // pointer holding {seed, heads, heads_global, bh_offset} (drop_salt).
  // The shard's origin travels in that block, not in this struct: a
  // larger kernel argument block moved the capped backward kernels'
  // registers (+20-28% time).
  int apply;
};

// _drop_mask's hash of one (row, column); salt = u32(seed) + bh * 0xC2B2AE35,
// bh the plane's index in the global (batch, head) grid.
__device__ __forceinline__ unsigned int drop_hash(unsigned int row,
                                                  unsigned int col,
                                                  unsigned int salt) {
  unsigned int x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA6Bu) ^ salt;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

namespace mma {

// The same hash split in its two terms, each taken once per row (with the
// salt) or once per column: drop_hash(r, c, s) ==
// drop_hash(0, 0, row_term(r, s) ^ col_term(c)).
__device__ __forceinline__ unsigned int row_term(int row, unsigned int salt) {
  return ((unsigned int)row * 0x9E3779B1u) ^ salt;
}
__device__ __forceinline__ unsigned int col_term(int col) {
  return (unsigned int)col * 0x85EBCA6Bu;
}

// The dropout factor of an entry from its two terms: keep_scale or 0.
__device__ __forceinline__ float keep_factor(const DropoutSpec& d,
                                             unsigned int rt,
                                             unsigned int ct) {
  return drop_hash(0u, 0u, rt ^ ct) > d.threshold ? d.keep_scale : 0.f;
}

// The salt of the launch's plane bh. A shard's launch (apply 2) covers the
// local (b, h) of `heads` heads of the global grid and hashes the global
// (b0 + b) * heads_global + h0 + h, with bh_offset = b0 * heads_global + h0.
__device__ __forceinline__ unsigned int drop_salt(const int* seed,
                                                  const DropoutSpec& d,
                                                  int bh) {
  if (d.apply == 2) {
    const int heads = seed[1];
    bh += (bh / heads) * (seed[2] - heads) + seed[3];
  }
  return (unsigned int)seed[0] + (unsigned int)bh * 0xC2B2AE35u;
}

// ---------------------------------------------------------------------------
// The forward: softmax(q k^T * scale + bias + causal) [* dropout] v
// ---------------------------------------------------------------------------

struct FwdArgs {
  const bf16 *q, *k, *v;
  const float* bias;  // (planes, L, S) or null; (b, h) reads plane bh % planes
  const int* seed;    // dropout only
  bf16* out;
  float* stats;       // dropout only: (BH, L, 2) row max, row sum
  int L, S;
  float scale;
  DropoutSpec drop;
};

// The backward's arguments (flash_attention_dropout.cu; above head size
// 256 attention_wide.cuh's cluster backward).
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

constexpr float kLog2e = 1.4426950408889634f;

// exp(x - m) as exp2(x log2(e) - m log2(e)): one FMA and the MUFU's ex2;
// ml2 = m * log2(e), taken once per row.
__device__ __forceinline__ float exp_from(float x, float ml2) {
  return exp2f(fmaf(x, kLog2e, -ml2));
}

// The dot products of a warp's 16 rows (r0 ..; this lane's rows ra and
// ra + 8) with NT*8 columns from col0, in place, into logits: * scale,
// + bias (rows ba / bb of it, or null), -inf past the last column S (an
// exact zero weight) and -1e9 above the causal diagonal, as the Pallas
// kernels. The masks are tested only in a chunk that reaches past S or
// over the diagonal.
template <int NT, bool CAUSAL>
__device__ __forceinline__ void to_logits(float (&s)[NT][4], float scale,
                                          const float* ba, const float* bb,
                                          int r0, int col0, int S, int lane) {
  const int ra = r0 + (lane >> 2), c2 = (lane & 3) * 2;
  const bool masked =
      col0 + NT * 8 > S || (CAUSAL && col0 + NT * 8 - 1 > r0);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + j * 8 + c2 + (e & 1);
      const int row = e < 2 ? ra : ra + 8;
      const float* br = e < 2 ? ba : bb;
      float x = s[j][e] * scale;
      if (br && col < S) x += br[col];
      if (masked) {
        if (col >= S) x = -INFINITY;
        else if (CAUSAL && col > row) x = kNegInf;
      }
      s[j][e] = x;
    }
  }
}

// One block: WARPS warps of 16 query rows of one (b, h). Two passes over
// the key chunks: pass 0 the row max m and sum l of exp(s - m); pass 1 the
// weights exp(s - m) / l [* the dropout factor], rounded to bf16 as the A
// operand of the product with V, as the Pallas kernels round them. DROPOUT
// also draws the mask and writes the stats (m, l) for the backward. The
// body of the kernels below.
template <int HD, int WARPS, bool CAUSAL, bool DROPOUT>
__device__ __forceinline__ void fwd_mma_body(FwdArgs a) {
  constexpr int kNT = kChunk / 8;  // key tiles of a chunk
  constexpr int kDT = HD / 8;      // head-dim tiles
  // K and V chunks, two of each (fwd_smem bytes)
  bf16 (*ks)[Chunk<HD>::kElems] =
      reinterpret_cast<bf16 (*)[Chunk<HD>::kElems]>(attn_smem);
  bf16 (*vs)[Chunk<HD>::kElems] = ks + 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // grid (row blocks, bias planes, B*H / planes): (b, h) = blockIdx.z *
  // planes + blockIdx.y reads bias plane blockIdx.y, no division in the
  // kernel. The dropout forward keeps one plane per (b, h), and with it
  // the code it had before shared biases.
  const int bh = DROPOUT ? blockIdx.y : blockIdx.z * gridDim.y + blockIdx.y;
  const int blk0 = blockIdx.x * WARPS * 16;
  const int r0 = blk0 + warp * 16;
  const int ra = r0 + (lane >> 2), rb = ra + 8;
  const int c2 = (lane & 3) * 2;
  const int L = a.L, S = a.S;
  const bf16* kb = a.k + (size_t)bh * S * HD;
  const bf16* vb = a.v + (size_t)bh * S * HD;
  const size_t bp = DROPOUT ? bh : blockIdx.y;
  const float* ba = a.bias && ra < L ? a.bias + (bp * L + ra) * S : nullptr;
  const float* bb = a.bias && rb < L ? a.bias + (bp * L + rb) * S : nullptr;

  // chunks the block loads; chunks this warp computes (none past L; under
  // causal none wholly above its diagonal)
  int n_chunks = (S + kChunk - 1) / kChunk;
  if (CAUSAL) n_chunks = min(n_chunks, (blk0 + WARPS * 16 - 1) / kChunk + 1);
  int mine = CAUSAL ? min(n_chunks, (r0 + 15) / kChunk + 1) : n_chunks;
  if (r0 >= L) mine = 0;

  uint32_t qf[HD / 16][4];
  load_a<HD>(qf, a.q + (size_t)bh * L * HD, r0, L, lane);
  unsigned int rta = 0, rtb = 0;
  if (DROPOUT) {
    const unsigned int salt = drop_salt(a.seed, a.drop, bh);
    rta = row_term(ra, salt);
    rtb = row_term(rb, salt);
  }

  // steps 0 .. n-1 stream K (pass 0), n .. 2n-1 stream K and V (pass 1)
  const int steps = 2 * n_chunks;
  auto issue = [&](int t) {
    const int c = t < n_chunks ? t : t - n_chunks;
    load_chunk<HD, WARPS * 32>(ks[t & 1], kb, c * kChunk, S);
    if (t >= n_chunks) load_chunk<HD, WARPS * 32>(vs[t & 1], vb, c * kChunk, S);
    cp_async_commit();
  };
  issue(0);

  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  float ma2 = 0.f, mb2 = 0.f, ia = 0.f, ib = 0.f;  // m log2(e), 1 / l
  float o[kDT][4];
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
    const bool pass1 = t >= n_chunks;
    const int c = pass1 ? t - n_chunks : t;
    if (c < mine) {
      const int c0 = c * kChunk;
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mma_a_rowsT<HD, kNT>(s, qf, ks[t & 1], lane);
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
        mma_a_rows<HD, kNT / 2>(o, p, vs[t & 1], lane);
      }
    }
    __syncthreads();
  }

  if (mine == 0) return;
  bf16* ob = a.out + (size_t)bh * L * HD;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int col = j * 8 + c2;
    if (ra < L)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)ra * HD + col) =
          __floats2bfloat162_rn(o[j][0], o[j][1]);
    if (rb < L)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rb * HD + col) =
          __floats2bfloat162_rn(o[j][2], o[j][3]);
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

// Blocks of 4 warps (64 rows) where they make at least two waves on the
// card's 132 SMs, else of 2 warps, so that a small batch (B=1, H=8,
// L=300: 80 blocks) still spreads over the SMs.
inline int fwd_warps(int BH, int L) {
  return BH * ((L + 63) / 64) >= 2 * 132 ? 4 : 2;
}

template <int HD, int WARPS, bool CAUSAL, bool DROPOUT>
__global__ void __launch_bounds__(WARPS * 32) attention_fwd_mma(FwdArgs a) {
  fwd_mma_body<HD, WARPS, CAUSAL, DROPOUT>(a);
}

// The plain (no causal mask, no dropout) 4-warp forward at head sizes up
// to 64, the instance of large grids (CLIP's 30 x 16 x 577 rows, the AMT
// encoder at B=16), held to 4 blocks an SM (at most 128 registers a
// thread): left to the compiler it took 158 registers, 3 blocks an SM,
// and ran 9% slower on an H100 80GB HBM3.
template <int HD>
__global__ void __launch_bounds__(4 * 32, 4) attention_fwd_mma_4x(FwdArgs a) {
  fwd_mma_body<HD, 4, false, false>(a);
}

template <int HD>
constexpr size_t fwd_smem() {
  return 4 * Chunk<HD>::kElems * sizeof(bf16);
}

template <int HD, int WARPS, bool CAUSAL, bool DROPOUT>
inline int launch_fwd_inst(const FwdArgs& a, dim3 grid, cudaStream_t st) {
  static bool opted_in = false;
  void (*kernel)(FwdArgs);
  if constexpr (WARPS == 4 && HD <= 64 && !CAUSAL && !DROPOUT)
    kernel = attention_fwd_mma_4x<HD>;
  else
    kernel = attention_fwd_mma<HD, WARPS, CAUSAL, DROPOUT>;
  const int err = smem_opt_in(kernel, fwd_smem<HD>(), opted_in);
  if (err) return err;
  kernel<<<grid, WARPS * 32, fwd_smem<HD>(), st>>>(a);
  return 0;
}

template <int HD, int WARPS, bool DROPOUT>
inline int launch_fwd_mma(const FwdArgs& a, int BH, int causal, int planes,
                          cudaStream_t st) {
  dim3 grid((a.L + WARPS * 16 - 1) / (WARPS * 16), planes, BH / planes);
  return causal ? launch_fwd_inst<HD, WARPS, true, DROPOUT>(a, grid, st)
                : launch_fwd_inst<HD, WARPS, false, DROPOUT>(a, grid, st);
}

template <int HD, bool DROPOUT>
inline int launch_fwd_hd(const FwdArgs& a, int BH, int causal, int planes,
                         cudaStream_t st) {
  return fwd_warps(BH, a.L) == 4
             ? launch_fwd_mma<HD, 4, DROPOUT>(a, BH, causal, planes, st)
             : launch_fwd_mma<HD, 2, DROPOUT>(a, BH, causal, planes, st);
}

// Launches the bf16 forward for head_dim D (16, 32, 64, 128 or 256; the
// wrappers pad other head sizes with zero columns) over BH (b, h) pairs
// whose bias has ``planes`` planes (BH, or the head count of a bias shared
// by every batch row; the dropout forward: BH); returns a cudaError_t code.
template <bool DROPOUT>
inline int run_fwd_mma(const FwdArgs& a, int BH, int D, int causal,
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

}  // namespace mma
}  // namespace v2m
