// Attention with in-kernel hashed dropout, forward and backward, for the
// training step: out = (dropout(softmax(q k^T * scale + bias + causal))) v.
//
// Replaces the TPU kernels of video2music_tpu/ops/pallas_attention_dropout.py:
// flash_attention_dropout (forward _fwd_kernel via _fwd_call, backward
// _bwd_kernel via _bwd_call). Semantics kept: f32 logits and softmax, the
// optional (B, H, L, S) f32 bias, masked logits -1e9, the start-aligned
// causal mask (L == S, the wrapper checks), and the dropout mask of
// _drop_mask: a murmur3-style hash of (seed, b*H + h, absolute row, column)
// in u32 arithmetic, kept iff the hash exceeds u32(rate * 0xFFFFFFFF), kept
// entries scaled by 1/(1-rate). The mask is a pure function of its
// coordinates, so the backward replays it bit for bit and the (L, S)
// probabilities never reach device memory. The forward rounds the dropped
// probabilities to v's dtype before the product with v (as the Pallas
// kernel's astype); the backward is all f32 (dv = (w*mask)^T do,
// dw = (do v^T) * mask, dlogits = w * (dw - rowsum(dw * w)),
// dq = dlogits k * scale, dk = dlogits^T q * scale, dbias = dlogits).
//
// What bounds it on the H100: at the training shape (B*H = 128,
// L = S = 300, head_dim 64) the forward is ~3 GFLOP on ~20 MB (bf16) and
// the backward about twice that on ~35 MB: microseconds of either roofline.
// This first design is bound by its plain-FMA inner loops, not by bytes:
//   * forward: one block per (b*h, 64 query rows), one thread per query
//     row (q and the output accumulator in registers), K/V streamed
//     through shared memory in 32-row tiles. Two passes over K: the first
//     takes the row max m and sum l, the second forms exp(s - m) / l
//     exactly as the Pallas kernel does (so the rounding to bf16 happens on
//     the same value) and accumulates the dropped, rounded weights times V.
//     (m, l) per row are saved for the backward.
//   * backward, two kernels: dQ with one thread per query row (a first
//     pass forms D = rowsum(dw * w), a second dlogits, dq and dbias), then
//     dK/dV with one thread per key row, looping over 16-row tiles of
//     q / dO / (m, l, D). Nothing of size (L, S) is stored but dbias.
// Under causal attention, tiles that lie wholly in the masked triangle add
// exact zeros and are skipped. Tensor cores (mma / wgmma) are later work.
#include "common.cuh"

namespace v2m {

constexpr int kDropRows = 64;   // query (or key) rows per block, one per thread
constexpr int kDropTile = 32;   // K/V rows per shared-memory tile
constexpr int kDropQTile = 16;  // q / dO rows per shared-memory tile (dK/dV)
constexpr float kDropNegInf = -1e9f;

struct DropoutSpec {
  unsigned int threshold;  // keep iff hash > threshold
  float keep_scale;        // 1 / (1 - rate), rounded to f32
  int apply;               // rate > 0 (rate 0 applies no mask at all)
};

// _drop_mask's hash of one (row, column); salt = u32(seed) + bh * 0xC2B2AE35.
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

template <typename T, int HD>
__device__ __forceinline__ void load_tile(float (*dst)[HD],
                                          const T* __restrict__ src, int r0,
                                          int nrows, int limit) {
  for (int i = threadIdx.x; i < nrows * HD; i += blockDim.x) {
    const int r = i / HD, c = i % HD;
    dst[r][c] = r0 + r < limit ? to_f<T>(src[(size_t)(r0 + r) * HD + c]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDropRows)
attention_dropout_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ bias,
                             const int* __restrict__ seed, T* __restrict__ out,
                             float* __restrict__ stats, int L, int S,
                             int causal, float scale, DropoutSpec drop) {
  __shared__ float ks[kDropTile][HD];
  __shared__ float vs[kDropTile][HD];
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kDropRows;
  const int row = row0 + threadIdx.x;
  const bool live = row < L;
  const T* kb = k + (size_t)bh * S * HD;
  const T* vb = v + (size_t)bh * S * HD;
  const float* brow = bias && live ? bias + ((size_t)bh * L + row) * S : nullptr;
  const unsigned int salt = (unsigned int)seed[0] + (unsigned int)bh * 0xC2B2AE35u;
  const int s_end = causal ? min(S, row0 + kDropRows) : S;

  float qr[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c)
    qr[c] = live ? to_f<T>(q[((size_t)bh * L + row) * HD + c]) : 0.f;

  // pass 1: row max and sum of exponentials
  float m = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 < s_end; s0 += kDropTile) {
    load_tile<T, HD>(ks, kb, s0, kDropTile, S);
    __syncthreads();
    if (live) {
      const int n = min(kDropTile, s_end - s0);
      float sc[kDropTile];
      float tmax = m;
#pragma unroll
      for (int j = 0; j < kDropTile; ++j) {
        if (j < n) {
          float d = 0.f;
#pragma unroll
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

  // pass 2: dropped weights, rounded to T, times V
  float acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  for (int s0 = 0; s0 < s_end; s0 += kDropTile) {
    load_tile<T, HD>(ks, kb, s0, kDropTile, S);
    load_tile<T, HD>(vs, vb, s0, kDropTile, S);
    __syncthreads();
    if (live) {
      const int n = min(kDropTile, s_end - s0);
      for (int j = 0; j < n; ++j) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) d = fmaf(qr[c], ks[j][c], d);
        const int col = s0 + j;
        const float s = drop_logit(d, scale, brow, row, col, causal);
        const float w = round_t<T>(expf(s - m) / l *
                                   drop_factor(drop, row, col, salt));
#pragma unroll
        for (int c = 0; c < HD; ++c) acc[c] = fmaf(w, vs[j][c], acc[c]);
      }
    }
    __syncthreads();
  }
  if (live) {
    T* o = out + ((size_t)bh * L + row) * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) o[c] = from_f<T>(acc[c]);
    stats[((size_t)bh * L + row) * 2] = m;
    stats[((size_t)bh * L + row) * 2 + 1] = l;
  }
}

// dQ, D = rowsum(dw * w) and dbias: one thread per query row.
template <typename T, int HD>
__global__ void __launch_bounds__(kDropRows)
attention_dropout_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ bias,
                            const int* __restrict__ seed,
                            const T* __restrict__ dout,
                            const float* __restrict__ stats,
                            T* __restrict__ dq, float* __restrict__ dsum,
                            float* __restrict__ dbias, int L, int S,
                            int causal, float scale, DropoutSpec drop) {
  __shared__ float ks[kDropTile][HD];
  __shared__ float vs[kDropTile][HD];
  __shared__ float dos[kDropRows][HD + 1];  // own row per thread, padded
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kDropRows;
  const int row = row0 + threadIdx.x;
  const bool live = row < L;
  const T* kb = k + (size_t)bh * S * HD;
  const T* vb = v + (size_t)bh * S * HD;
  const size_t rix = (size_t)bh * L + row;
  const float* brow = bias && live ? bias + rix * S : nullptr;
  float* dbrow = dbias && live ? dbias + rix * S : nullptr;
  const unsigned int salt = (unsigned int)seed[0] + (unsigned int)bh * 0xC2B2AE35u;
  const int s_end = causal ? min(S, row0 + kDropRows) : S;

  float qr[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    qr[c] = live ? to_f<T>(q[rix * HD + c]) : 0.f;
    dos[threadIdx.x][c] = live ? to_f<T>(dout[rix * HD + c]) : 0.f;
  }
  const float m = live ? stats[rix * 2] : 0.f;
  const float l = live ? stats[rix * 2 + 1] : 1.f;

  // pass 1: D = sum_j w_j * mask_j * (do . v_j)
  float dsumr = 0.f;
  for (int s0 = 0; s0 < s_end; s0 += kDropTile) {
    load_tile<T, HD>(ks, kb, s0, kDropTile, S);
    load_tile<T, HD>(vs, vb, s0, kDropTile, S);
    __syncthreads();
    if (live) {
      const int n = min(kDropTile, s_end - s0);
      for (int j = 0; j < n; ++j) {
        float d = 0.f, dp = 0.f;
#pragma unroll
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
#pragma unroll
  for (int c = 0; c < HD; ++c) dqa[c] = 0.f;
  for (int s0 = 0; s0 < s_end; s0 += kDropTile) {
    load_tile<T, HD>(ks, kb, s0, kDropTile, S);
    load_tile<T, HD>(vs, vb, s0, kDropTile, S);
    __syncthreads();
    if (live) {
      const int n = min(kDropTile, s_end - s0);
      for (int j = 0; j < n; ++j) {
        float d = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          d = fmaf(qr[c], ks[j][c], d);
          dp = fmaf(dos[threadIdx.x][c], vs[j][c], dp);
        }
        const int col = s0 + j;
        const float w =
            expf(drop_logit(d, scale, brow, row, col, causal) - m) / l;
        const float dl = w * (dp * drop_factor(drop, row, col, salt) - dsumr);
        if (dbrow) dbrow[col] = dl;
#pragma unroll
        for (int c = 0; c < HD; ++c) dqa[c] = fmaf(dl, ks[j][c], dqa[c]);
      }
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < HD; ++c) dq[rix * HD + c] = from_f<T>(dqa[c] * scale);
    dsum[rix] = dsumr;
    if (dbrow)  // the skipped causal columns: dlogits is exactly 0 there
      for (int col = s_end; col < S; ++col) dbrow[col] = 0.f;
  }
}

// dK and dV: one thread per key row, looping over tiles of query rows.
template <typename T, int HD>
__global__ void __launch_bounds__(kDropRows)
attention_dropout_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ bias,
                             const int* __restrict__ seed,
                             const T* __restrict__ dout,
                             const float* __restrict__ stats,
                             const float* __restrict__ dsum,
                             T* __restrict__ dk, T* __restrict__ dv, int L,
                             int S, int causal, float scale,
                             DropoutSpec drop) {
  __shared__ float kss[kDropRows][HD + 1];  // own row per thread, padded
  __shared__ float vss[kDropRows][HD + 1];
  __shared__ float qs[kDropQTile][HD];
  __shared__ float dos[kDropQTile][HD];
  __shared__ float ms[kDropQTile], ls[kDropQTile], ds[kDropQTile];
  const int bh = blockIdx.y;
  const int col0 = blockIdx.x * kDropRows;
  const int col = col0 + threadIdx.x;
  const bool live = col < S;
  const T* qb = q + (size_t)bh * L * HD;
  const T* dob = dout + (size_t)bh * L * HD;
  const unsigned int salt = (unsigned int)seed[0] + (unsigned int)bh * 0xC2B2AE35u;

  for (int i = threadIdx.x; i < kDropRows * HD; i += blockDim.x) {
    const int r = i / HD, c = i % HD;
    const bool in = col0 + r < S;
    const size_t at = ((size_t)bh * S + col0 + r) * HD + c;
    kss[r][c] = in ? to_f<T>(k[at]) : 0.f;
    vss[r][c] = in ? to_f<T>(v[at]) : 0.f;
  }
  float dka[HD], dva[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) dka[c] = dva[c] = 0.f;

  // rows above the block's first key see none of its keys under causal
  for (int r0 = causal ? col0 : 0; r0 < L; r0 += kDropQTile) {
    __syncthreads();
    load_tile<T, HD>(qs, qb, r0, kDropQTile, L);
    load_tile<T, HD>(dos, dob, r0, kDropQTile, L);
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
#pragma unroll
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
#pragma unroll
      for (int c = 0; c < HD; ++c) {
        dva[c] = fmaf(wd, dos[i][c], dva[c]);
        dka[c] = fmaf(dl, qs[i][c], dka[c]);
      }
    }
  }
  if (live) {
    const size_t at = ((size_t)bh * S + col) * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      dk[at + c] = from_f<T>(dka[c] * scale);
      dv[at + c] = from_f<T>(dva[c]);
    }
  }
}

struct DropoutArgs {
  const void *q, *k, *v, *bias, *seed, *dout, *stats;
  void *out, *dq, *dk, *dv, *dbias, *dsum;
  int BH, L, S, causal;
  float scale;
  DropoutSpec drop;
};

template <typename T, int HD>
static void launch_fwd(const DropoutArgs& a, cudaStream_t st) {
  dim3 grid((a.L + kDropRows - 1) / kDropRows, a.BH);
  attention_dropout_fwd_kernel<T, HD><<<grid, kDropRows, 0, st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.bias,
      (const int*)a.seed, (T*)a.out, (float*)a.stats, a.L, a.S, a.causal,
      a.scale, a.drop);
}

template <typename T, int HD>
static void launch_bwd(const DropoutArgs& a, cudaStream_t st) {
  dim3 grid_q((a.L + kDropRows - 1) / kDropRows, a.BH);
  attention_dropout_dq_kernel<T, HD><<<grid_q, kDropRows, 0, st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.bias,
      (const int*)a.seed, (const T*)a.dout, (const float*)a.stats,
      (T*)a.dq, (float*)a.dsum, (float*)a.dbias, a.L, a.S, a.causal,
      a.scale, a.drop);
  dim3 grid_k((a.S + kDropRows - 1) / kDropRows, a.BH);
  attention_dropout_dkv_kernel<T, HD><<<grid_k, kDropRows, 0, st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.bias,
      (const int*)a.seed, (const T*)a.dout, (const float*)a.stats,
      (const float*)a.dsum, (T*)a.dk, (T*)a.dv, a.L, a.S, a.causal, a.scale,
      a.drop);
}

template <typename T>
static int dispatch(const DropoutArgs& a, int D, bool backward,
                    cudaStream_t st) {
  switch (D) {
    case 16: backward ? launch_bwd<T, 16>(a, st) : launch_fwd<T, 16>(a, st); break;
    case 32: backward ? launch_bwd<T, 32>(a, st) : launch_fwd<T, 32>(a, st); break;
    case 64: backward ? launch_bwd<T, 64>(a, st) : launch_fwd<T, 64>(a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

static int run(int dtype, const DropoutArgs& a, int D, bool backward,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) return dispatch<float>(a, D, backward, st);
  if (dtype == kBF16) return dispatch<bf16>(a, D, backward, st);
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

// The backward of v2m_attention_dropout_fwd from its stats: dq (BH, L, D),
// dk/dv (BH, S, D) of q's dtype, dbias (BH, L, S) f32 when bias is given
// (else null), dsum (BH, L) f32 scratch. Returns a cudaError_t code.
extern "C" int v2m_attention_dropout_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    const void* seed, const void* dout, const void* stats, void* dq,
    void* dk, void* dv, void* dbias, void* dsum, int BH, int L, int S, int D,
    int causal, float scale, unsigned int threshold, float keep_scale,
    int apply, void* stream) {
  v2m::DropoutArgs a{};
  a.q = q; a.k = k; a.v = v; a.bias = bias; a.seed = seed; a.dout = dout;
  a.stats = stats; a.dq = dq; a.dk = dk; a.dv = dv; a.dbias = dbias;
  a.dsum = dsum;
  a.BH = BH; a.L = L; a.S = S; a.causal = causal; a.scale = scale;
  a.drop = v2m::DropoutSpec{threshold, keep_scale, apply};
  return v2m::run(dtype, a, D, true, stream);
}
