// The kernels of the two probes under video2music_tpu_torch/tools/, the
// counterparts of the JAX package's TPU probes.
//
// Rows 13 and 14 of the port's kernel table. Neither is on a serving or
// training path: they measure and check the building blocks of the
// batched decode attention (rows 6 and 9).
//
// Row 13 replaces tools/kv_traffic_probe.py:_kernel (its pallas_call at
// :128), the batched decode-attention core timed alone in four modes:
//   * attend (bf16 or int8 caches): per (clip, head), softmax over the
//     cache rows 0..pos of q . k / sqrt(hd) in f32, then P . V; the int8
//     form folds each row's f32 scales into the logit (k) and the
//     probability (v), as the Pallas _attend_core does (its one-hot
//     _head_map / _row_map products are the TPU's way to these sums and
//     are not ported). One block per (head, clip), a thread per cache row
//     for the logits (16-byte loads along the head), row groups for P . V.
//   * floor: read every slab byte and reduce: per block of `block` clips,
//     the column sums of its K and V rows plus each clip's q, in f32. The
//     rows are split over many blocks (a block sums kFloorRows rows of a
//     group and adds its column sums to the group's atomically, so their
//     order varies from run to run), then one kernel adds q: the
//     cache-traffic floor beside attend's time.
//   * noattn: q * 1.0001, the launch and the q / out traffic alone.
// What bounds it: bytes. At the probe's B = 32, S = 300, D = 512 the bf16
// slabs are 19.7 MB (5.87 us at 3.35 TB/s), the int8 ones 9.9 MB (2.96
// us).
//
// Row 14 replaces tools/probe_dotgeneral.py:_kernel (its pallas_call at
// :35), which checks that the product forms a wide batched attention
// needs lower: NT logits (rows, D) . (C, D)^T, TN pv (rows, C)^T . (rows,
// D), NT tiny-diag (C, D) . (C, D)^T, f32 out. Here: one tensor-core kernel
// for all three, C = A' B'^T with A'(m, k) = a[m * a_sm + k * a_sk] and
// B'(n, k) = b[n * b_sn + k * b_sk], so a form is a choice of strides. A
// block stages 64 x 16 tiles of A' and B' in shared memory, element by
// element (the strides may transpose), and each of its four warps builds
// its mma.sync fragments from them with plain loads, by the fragment
// layouts of the PTX ISA: bf16 inputs as m16n8k16 (f32 accumulators); f32
// inputs as TF32 m16n8k8 (rounded to TF32 by cvt.rna; about three decimal
// digits). A probe of the fragment layouts, not a fast product: it
// re-reads strided operands element by element. K is split over the grid's
// z (about two blocks an SM), the splits' f32 partials added in order by a
// second kernel, so a product with few output tiles (TN pv: 64 x 512 over
// K = 2400) still fills the card. What bounds it: bytes at the probe's
// shapes (rows = 2400, D = 512, C = 64: 3.1 MB in bf16, 0.16 GFLOP).
#include <type_traits>

#include "attention_mma.cuh"

namespace v2m {
namespace probe {

constexpr int kThreads = 128;   // attend: a block per (head, clip)
constexpr int kFloorRows = 16;  // floor: rows a block sums
constexpr int kFloorUnroll = 4; // floor: rows a lane loads before it adds
constexpr int kFloorThreads = 256;

// ---------------------------------------------------------------------------
// row 13: the decode-attention core, its floor and its no-cache form
// ---------------------------------------------------------------------------

// grid (H, B). q (B, D) bf16; k, v (B, S, D) of C; ks, vs (B, S) f32 row
// scales (C = int8_t); out (B, D) bf16. Needs hd % Vec<C>::N == 0 and
// hd <= kThreads.
template <typename C>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const bf16* __restrict__ q, const C* __restrict__ k,
              const C* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, bf16* __restrict__ out, int S,
              int D, int hd, int pos, float scale) {
  constexpr int V = Vec<C>::N;
  constexpr bool kQ = std::is_same<C, int8_t>::value;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int rows = pos + 1;
  float* qs = sm;            // (hd)
  float* p = qs + hd;        // (rows)
  float* part = p + rows;    // (groups, hd)
  const C* kb = k + (size_t)b * S * D + h * hd;
  const C* vb = v + (size_t)b * S * D + h * hd;
  for (int i = tid; i < hd; i += kThreads)
    qs[i] = __bfloat162float(q[(size_t)b * D + h * hd + i]);
  __syncthreads();
  float lmax = -INFINITY;
  for (int s = tid; s < rows; s += kThreads) {
    float acc = 0.f;
    for (int d = 0; d < hd; d += V) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)s * D + d));
      const C* e = reinterpret_cast<const C*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) acc = fmaf(qs[d + i], to_f<C>(e[i]), acc);
    }
    acc *= scale;
    if (kQ) acc *= ks[(size_t)b * S + s];
    p[s] = acc;
    lmax = fmaxf(lmax, acc);
  }
  const float m = block_max(lmax, red);
  float ls = 0.f;
  for (int s = tid; s < rows; s += kThreads) {
    const float e = expf(p[s] - m);
    p[s] = e;
    ls += e;
  }
  const float inv = 1.f / block_sum(ls, red);  // also orders p[] writes
  for (int s = tid; s < rows; s += kThreads) {
    float w = p[s] * inv;
    if (kQ) w *= vs[(size_t)b * S + s];
    p[s] = w;
  }
  __syncthreads();
  const int chunks = hd / V, groups = kThreads / chunks;
  const int g = tid / chunks, c = tid % chunks;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (g < groups) {
    for (int s = g; s < rows; s += groups) {
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(vb + (size_t)s * D + c * V));
      const C* e = reinterpret_cast<const C*>(&raw);
      const float w = p[s];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(w, to_f<C>(e[i]), acc[i]);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) part[g * hd + c * V + i] = acc[i];
  }
  __syncthreads();
  for (int i = tid; i < hd; i += kThreads) {
    float o = 0.f;
    for (int j = 0; j < groups; ++j) o += part[j * hd + i];
    out[(size_t)b * D + h * hd + i] = __float2bfloat16_rn(o);
  }
}

// grid (splits, groups): block (j, g) sums rows j * kFloorRows .. of group
// g's slab (block * S rows of K and of V) into the group's f32 column sums
// sums[g, D], which start at zero, by one atomic add a column; a thread
// takes 8 columns (one 16-byte load a row) of every lanes-th row,
// kFloorUnroll rows of K and of V loaded before any is added, so that a
// thread keeps 8 loads in flight.
__global__ void __launch_bounds__(kFloorThreads)
floor_partial_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                     float* __restrict__ sums, int rows, int D) {
  extern __shared__ __align__(16) float fsm[];  // (lanes, D)
  const int pieces = D / 8, lanes = kFloorThreads / pieces;
  const int tid = threadIdx.x, c = (tid % pieces) * 8, lane = tid / pieces;
  const int g = blockIdx.y, j = blockIdx.x;
  const int r0 = j * kFloorRows, r1 = min(rows, r0 + kFloorRows);
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  if (lane < lanes) {
    const bf16* kg = k + (size_t)g * rows * D + c;
    const bf16* vg = v + (size_t)g * rows * D + c;
    for (int base = r0 + lane; base < r1; base += kFloorUnroll * lanes) {
      uint4 raw[2 * kFloorUnroll];
#pragma unroll
      for (int u = 0; u < kFloorUnroll; ++u) {
        const int r = base + u * lanes;
        const bool ok = r < r1;
        raw[u] = ok ? __ldg(reinterpret_cast<const uint4*>(kg + (size_t)r * D))
                    : make_uint4(0, 0, 0, 0);
        raw[kFloorUnroll + u] =
            ok ? __ldg(reinterpret_cast<const uint4*>(vg + (size_t)r * D))
               : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 2 * kFloorUnroll; ++u) {
        const bf16* e = reinterpret_cast<const bf16*>(&raw[u]);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += __bfloat162float(e[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) fsm[lane * D + c + i] = acc[i];
  }
  __syncthreads();
  for (int d = tid; d < D; d += kFloorThreads) {
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += fsm[l * D + d];
    atomicAdd(sums + (size_t)g * D + d, s);
  }
}

// grid (B): out[b] = bf16(the column sums of b's group + q[b]).
__global__ void __launch_bounds__(kFloorThreads)
floor_finish_kernel(const float* __restrict__ sums, const bf16* __restrict__ q,
                    bf16* __restrict__ out, int block, int D) {
  const int b = blockIdx.x, g = b / block;
  for (int d = threadIdx.x; d < D; d += kFloorThreads)
    out[(size_t)b * D + d] = __float2bfloat16_rn(
        sums[(size_t)g * D + d] + __bfloat162float(q[(size_t)b * D + d]));
}

__global__ void noattn_kernel(const bf16* __restrict__ q, bf16* __restrict__ out,
                              int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __float2bfloat16_rn(__bfloat162float(q[i]) * 1.0001f);
}

// ---------------------------------------------------------------------------
// row 14: the dot_general forms on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kGm = 64, kGn = 64, kGk = 16;  // block tile (m, n, k)

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
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

// grid (ceil(N / kGn), ceil(M / kGm), splits), 4 warps: warp w computes
// rows m0 + 16 w .. + 15 and the block's kGn columns over the k range
// blockIdx.z * kc .. + kc - 1, into c + blockIdx.z * M * N (split K:
// dot_sum_kernel adds the splits in order). Fragments (g = lane / 4,
// t = lane % 4): bf16 m16n8k16: A (g, 2t..2t+1), (g+8, 2t..), (g,
// 2t+8..), (g+8, 2t+8..); B (k 2t..2t+1, n g), (k 2t+8.., n g). TF32
// m16n8k8: A (g, t), (g+8, t), (g, t+4), (g+8, t+4); B (k t, n g), (k t+4,
// n g). C (both): (g, 2t..2t+1), (g+8, 2t..2t+1).
template <typename T>
__global__ void __launch_bounds__(128)
dot_kernel(const T* __restrict__ a, const T* __restrict__ b,
           float* __restrict__ c, int M, int N, int K, int kc, int a_sm,
           int a_sk, int b_sn, int b_sk) {
  __shared__ T As[kGm][kGk];
  __shared__ T Bs[kGn][kGk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kGm, n0 = blockIdx.x * kGn;
  const int wr = warp * 16;
  float acc[kGn / 8][4];
#pragma unroll
  for (int j = 0; j < kGn / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int k_lo = blockIdx.z * kc, k_hi = min(K, k_lo + kc);
  c += (size_t)blockIdx.z * M * N;
  for (int k0 = k_lo; k0 < k_hi; k0 += kGk) {
    __syncthreads();
    for (int e = threadIdx.x; e < kGm * kGk; e += 128) {
      const int r = e / kGk, kk = e % kGk, m = m0 + r, n = n0 + r, k = k0 + kk;
      As[r][kk] = m < M && k < k_hi ? a[(size_t)m * a_sm + (size_t)k * a_sk]
                                    : from_f<T>(0.f);
      Bs[r][kk] = n < N && k < k_hi ? b[(size_t)n * b_sn + (size_t)k * b_sk]
                                    : from_f<T>(0.f);
    }
    __syncthreads();
    if constexpr (std::is_same<T, bf16>::value) {
      uint32_t af[4];
      af[0] = mma::pack_bf16(to_f<T>(As[wr + g][2 * t]), to_f<T>(As[wr + g][2 * t + 1]));
      af[1] = mma::pack_bf16(to_f<T>(As[wr + g + 8][2 * t]), to_f<T>(As[wr + g + 8][2 * t + 1]));
      af[2] = mma::pack_bf16(to_f<T>(As[wr + g][2 * t + 8]), to_f<T>(As[wr + g][2 * t + 9]));
      af[3] = mma::pack_bf16(to_f<T>(As[wr + g + 8][2 * t + 8]), to_f<T>(As[wr + g + 8][2 * t + 9]));
#pragma unroll
      for (int j = 0; j < kGn / 8; ++j) {
        const int n = j * 8 + g;
        const uint32_t b0 = mma::pack_bf16(to_f<T>(Bs[n][2 * t]), to_f<T>(Bs[n][2 * t + 1]));
        const uint32_t b1 = mma::pack_bf16(to_f<T>(Bs[n][2 * t + 8]), to_f<T>(Bs[n][2 * t + 9]));
        mma::mma_bf16(acc[j], af, b0, b1);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kGk; ks += 8) {
        uint32_t af[4];
        af[0] = to_tf32(to_f<T>(As[wr + g][ks + t]));
        af[1] = to_tf32(to_f<T>(As[wr + g + 8][ks + t]));
        af[2] = to_tf32(to_f<T>(As[wr + g][ks + t + 4]));
        af[3] = to_tf32(to_f<T>(As[wr + g + 8][ks + t + 4]));
#pragma unroll
        for (int j = 0; j < kGn / 8; ++j) {
          const int n = j * 8 + g;
          mma_tf32(acc[j], af, to_tf32(to_f<T>(Bs[n][ks + t])),
                   to_tf32(to_f<T>(Bs[n][ks + t + 4])));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kGn / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wr + g + (e < 2 ? 0 : 8);
      const int n = n0 + j * 8 + 2 * t + (e & 1);
      if (m < M && n < N) c[(size_t)m * N + n] = acc[j][e];
    }
  }
}

// c[i] = sum over the splits of part[z][i], in split order.
__global__ void dot_sum_kernel(const float* __restrict__ part,
                               float* __restrict__ c, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + i];
  c[i] = s;
}

// K split so that the grid has about two blocks an SM of the card's 132,
// each split a multiple of kGk and at least 64 deep.
inline int dot_split_depth(int M, int N, int K) {
  const int blocks = ((M + kGm - 1) / kGm) * ((N + kGn - 1) / kGn);
  const int want = max(1, (2 * 132 + blocks - 1) / blocks);
  int kc = (K + want - 1) / want;
  kc = max(64, (kc + kGk - 1) / kGk * kGk);
  return kc;
}

}  // namespace probe
}  // namespace v2m

// The decode-attention core of row 13: q (B, D) bf16; k, v (B, S, D) bf16
// (kv_dtype 1) or int8 (kv_dtype 2, with ks / vs (B, S) f32 row scales);
// out (B, D) bf16; rows 0..pos; H heads of D / H. Returns a cudaError_t
// code.
extern "C" int v2m_kv_probe_attend(int kv_dtype, const void* q, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, void* out, int B, int S,
                                   int D, int H, int pos, void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  if (H <= 0 || D % H || pos < 0 || pos >= S) return (int)cudaErrorInvalidValue;
  const int hd = D / H;
  const int V = kv_dtype == 2 ? Vec<int8_t>::N : Vec<bf16>::N;
  if (hd % V || hd > probe::kThreads) return (int)cudaErrorInvalidValue;
  const int groups = probe::kThreads / (hd / V);
  const size_t smem = (size_t)(hd + pos + 1 + groups * hd) * sizeof(float);
  const float scale = 1.f / sqrtf((float)hd);
  if (kv_dtype == 1) {
    static bool opted = false;
    const int err = mma::smem_opt_in(probe::attend_kernel<bf16>, smem, opted);
    if (err) return err;
    probe::attend_kernel<bf16><<<dim3(H, B), probe::kThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, nullptr, nullptr,
        (bf16*)out, S, D, hd, pos, scale);
  } else if (kv_dtype == 2) {
    static bool opted = false;
    const int err = mma::smem_opt_in(probe::attend_kernel<int8_t>, smem, opted);
    if (err) return err;
    probe::attend_kernel<int8_t><<<dim3(H, B), probe::kThreads, smem, st>>>(
        (const bf16*)q, (const int8_t*)k, (const int8_t*)v, (const float*)ks,
        (const float*)vs, (bf16*)out, S, D, hd, pos, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Row 13's floor: q (B, D), k, v (B, S, D) bf16, out (B, D) bf16; clips in
// groups of `block` (B a multiple); sums a (B / block, D) f32 workspace of
// zeros (the groups' column sums, added to atomically).
extern "C" int v2m_kv_probe_floor(const void* q, const void* k, const void* v,
                                  void* sums, void* out, int B, int S, int D,
                                  int block, void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  if (block <= 0 || B % block || D % 8 || D / 8 > probe::kFloorThreads)
    return (int)cudaErrorInvalidValue;
  const int rows = block * S;
  const int splits = (rows + probe::kFloorRows - 1) / probe::kFloorRows;
  const int lanes = probe::kFloorThreads / (D / 8);
  const size_t smem = (size_t)lanes * D * sizeof(float);
  static bool opted = false;
  const int err = mma::smem_opt_in(probe::floor_partial_kernel, smem, opted);
  if (err) return err;
  probe::floor_partial_kernel<<<dim3(splits, B / block), probe::kFloorThreads,
                                smem, st>>>((const bf16*)k, (const bf16*)v,
                                            (float*)sums, rows, D);
  probe::floor_finish_kernel<<<B, probe::kFloorThreads, 0, st>>>(
      (const float*)sums, (const bf16*)q, (bf16*)out, block, D);
  return (int)cudaGetLastError();
}

// Row 13's no-cache form: out = q * 1.0001 over n bf16 values.
extern "C" int v2m_kv_probe_noattn(const void* q, void* out, int n,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  v2m::probe::noattn_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const v2m::bf16*)q, (v2m::bf16*)out, n);
  return (int)cudaGetLastError();
}

// Row 14's split of K: the splits v2m_probe_dot makes (its workspace holds
// splits x M x N f32 where there are more than one).
extern "C" int v2m_probe_dot_splits(int M, int N, int K) {
  const int kc = v2m::probe::dot_split_depth(M, N, K);
  return (K + kc - 1) / kc;
}

// Row 14: c (M, N) f32 = A' B'^T over K, A'(m, k) = a[m * a_sm + k * a_sk],
// B'(n, k) = b[n * b_sn + k * b_sk], a and b of `dtype` (f32 through TF32,
// bf16); work: v2m_probe_dot_splits(M, N, K) x M x N f32 when that is above
// 1, else unused. Returns a cudaError_t code.
extern "C" int v2m_probe_dot(int dtype, const void* a, const void* b, void* c,
                             void* work, int M, int N, int K, int a_sm,
                             int a_sk, int b_sn, int b_sk, void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int kc = probe::dot_split_depth(M, N, K);
  const int splits = (K + kc - 1) / kc;
  if (splits > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  float* out = splits > 1 ? (float*)work : (float*)c;
  dim3 grid((N + probe::kGn - 1) / probe::kGn,
            (M + probe::kGm - 1) / probe::kGm, splits);
  if (dtype == kF32)
    probe::dot_kernel<float><<<grid, 128, 0, st>>>(
        (const float*)a, (const float*)b, out, M, N, K, kc, a_sm, a_sk, b_sn,
        b_sk);
  else if (dtype == kBF16)
    probe::dot_kernel<bf16><<<grid, 128, 0, st>>>(
        (const bf16*)a, (const bf16*)b, out, M, N, K, kc, a_sm, a_sk, b_sn,
        b_sk);
  else
    return (int)cudaErrorInvalidValue;
  if (splits > 1)
    probe::dot_sum_kernel<<<(M * N + 255) / 256, 256, 0, st>>>(
        (const float*)work, (float*)c, M * N, splits);
  return (int)cudaGetLastError();
}
