// Mamba selective scan: h = exp(delta * A) * h + delta * B * x,
// y = C . h + D * x, walked once over the sequence.
//
// Replaces the TPU kernel video2music_tpu/ops/pallas_scan.py:
// selective_scan_pallas (_scan_kernel). On the JAX product path the same
// function runs as jax.lax.associative_scan (ops/scan.py:selective_scan);
// the port puts this kernel on the bimamba+ regression path instead. Like
// the Pallas kernel (which pads N to 128) it takes any d_state N, here up
// to kMaxState (32 lanes of a warp x kMaxPer states in registers).
//
// What bounds it on the H100: the recurrence is sequential in L. At the
// product shape (b = 1, L = 300, ED = 128, N = 16) it reads x, delta, B, C
// once (0.3 MB, 0.08 us at 3.35 TB/s) and does 300 dependent steps per
// state; the chain through time is one FMA a step (h = dA * h + dBx), so
// the latency floor is L x the FMA's dependent latency (~4 cycles): ~1200
// cycles, ~0.6 us at 1.98 GHz, plus one load round trip before the first
// step and one store after the last (computed from the shapes and the
// card's published clock, not measured). The first design (one thread a
// channel, x and delta read from device memory inside the time loop) took
// 0.14 ms: 300 x the latency of that load.
//
// The design keeps device memory out of the time loop and only the FMA on
// the chain of h:
//   * a channel's N states are spread over a group of G lanes (G the
//     power of two >= N, at least kPre, at most 32), each lane holding
//     P = N / G states (padded with zero states to G x P) and their A in
//     registers; a block is kThreads / G channels of one batch row, so the
//     product shape runs 16 blocks at b = 1;
//   * x, delta, B and C for a chunk of TC time steps (up to 256, as long as
//     the buffers let two blocks share an SM) are staged in shared memory
//     by 16-byte cp.async, double-buffered: the next chunk loads while this
//     one is scanned (rows of odd widths go by element copies, issued
//     before the scan of the chunk before);
//   * steps go in groups: first every step's exp(dt * A) (one exp2, A
//     scaled by log2 e) and dt * x * B of the group, all independent of h,
//     then the group's chain, one FMA a state a step; a lane's partial
//     C . h is pre-added over kPre lanes by two shuffles and stored to
//     shared memory; after the chunk the partials of each (step, channel)
//     are summed, D * x is added in f32 and y is rounded to the dtype once,
//     staged in shared memory and stored row by row (coalesced over the
//     block's channels).
// Longer chunks pay: the chunk's end (the sums, the stores, three block
// barriers) is the cost beside the steps (chip_variants.py, PERF.md).
// The state stays f32 throughout.
#include "attention_mma.cuh"

namespace v2m {
namespace scan {

constexpr int kThreads = 128;
constexpr int kMaxChunk = 256;         // time steps staged per pass
constexpr int kPre = 4;   // lanes whose partial sums a shuffle pre-adds
constexpr size_t kSmemBudget = 100 * 1024;  // two blocks an SM
constexpr int kStageBytes = 32 * 1024; // B and C of one chunk at most
constexpr int kMaxPer = 32;            // states a lane holds
constexpr int kMaxState = 32 * kMaxPer;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void *x, *delta, *B, *C;
  const float *A, *D;
  void* y;
  int L, ED, N;
  int G, CH, TC;    // lanes a channel, channels a block, steps a chunk
  int Np;           // staged B / C row: N padded to G x P with zeros
  int vec_xd;       // x / delta rows by 16-byte cp.async
  int vec_bc;       // B / C rows by 16-byte cp.async
};

__host__ __device__ inline size_t pad16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Byte offsets of the shared-memory arrays: a buffer (x, delta, B, C) of
// `buffer` bytes, twice; then the partial sums and the staged outputs.
struct Layout {
  size_t x, d, b, c, buffer, part, y, total;
  __host__ __device__ Layout(int TC, int CH, int Np, int elt) {
    x = 0;
    d = x + pad16((size_t)TC * CH * elt);
    b = d + pad16((size_t)TC * CH * elt);
    c = b + pad16((size_t)TC * Np * elt);
    buffer = c + pad16((size_t)TC * Np * elt);
    part = 2 * buffer;  // a row of TC + 1 partials for every kPre lanes
    y = part + pad16((size_t)kThreads / kPre * (TC + 1) * sizeof(float));
    total = y + pad16((size_t)TC * CH * elt);
  }
};

// Rows of `row` bytes, `stride` bytes apart from `base`, go by 16-byte
// cp.async pieces.
static bool vec16(const void* base, size_t row, size_t stride) {
  return (uintptr_t)base % 16 == 0 && row % 16 == 0 && stride % 16 == 0;
}

// rows x width elements (source rows `stride` apart) into dst rows of
// dst_stride, by cp.async pieces of PB bytes (PB 0: element copies, which
// wait for their loads).
template <typename T, int PB>
__device__ __forceinline__ void copy_rows(T* dst, int dst_stride,
                                          const T* src, size_t stride,
                                          int rows, int width) {
  if constexpr (PB == 0) {
    for (int i = threadIdx.x; i < rows * width; i += kThreads) {
      const int r = i / width, j = i % width;
      dst[r * dst_stride + j] = src[(size_t)r * stride + j];
    }
  } else {
    constexpr int V = PB / (int)sizeof(T);
    const int per = width / V;
    for (int i = threadIdx.x; i < rows * per; i += kThreads) {
      const int r = i / per, j = (i % per) * V;
      if constexpr (PB == 16) {
        mma::cp_async16(dst + r * dst_stride + j, src + (size_t)r * stride + j,
                        true);
      } else {  // 8 or 4
        mma::cp_async_small<PB>(dst + r * dst_stride + j,
                                src + (size_t)r * stride + j, true);
      }
    }
  }
}

// copy_rows by 16-byte pieces when `vec`, else element by element (one
// loop each: the kernel's code stays small enough for the instruction
// cache).
template <typename T>
__device__ __forceinline__ void copy_rows_any(bool vec, T* dst,
                                              int dst_stride, const T* src,
                                              size_t stride, int rows,
                                              int width) {
  if (vec) {
    copy_rows<T, 16>(dst, dst_stride, src, stride, rows, width);
  } else {
    copy_rows<T, 0>(dst, dst_stride, src, stride, rows, width);
  }
}

// The nt steps of a staged chunk for one lane (states n = g + G p), its
// partial sums C . h, pre-added over kPre neighbouring lanes by two
// shuffles (a group of G >= kPre lanes is one channel; below that, the
// lanes beyond G are padded states of the same channel and add 0), to
// out[t] by the first of them. Every lane of the warp calls it. Steps go in groups of U: first every
// step's exp(dt a) and dt x B (and C) of the group into registers, all
// independent of h, so their loads and exponentials issue together; then
// the group's chain, one FMA a state a step, and its partial sums; then
// their stores. The staged B / C rows are padded with zeros to G x P (a
// padded state's a is 0), so no load is conditional: a padded state stays
// 0 and adds 0. A is scaled by log2(e) once, so exp(dt a) is one exp2.
template <typename T, int P>
__device__ __forceinline__ void scan_steps(
    const T* __restrict__ sx, const T* __restrict__ sd,
    const T* __restrict__ sb, const T* __restrict__ sc,
    float* __restrict__ out, int nt, int CH, int c, int Np, int G, int g,
    const float (&a2)[P], float (&h)[P]) {
  constexpr int U = P == 1 ? 16 : P == 2 ? 8 : P <= 8 ? 4 : 1;
  int t = 0;
  for (; t + U <= nt; t += U) {
    float e[U][P], bx[U][P], cc[U][P];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float dt = to_f<T>(sd[(t + u) * CH + c]);
      const float dtx = dt * to_f<T>(sx[(t + u) * CH + c]);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int n = g + G * p;
        e[u][p] = exp2f(dt * a2[p]);
        bx[u][p] = dtx * to_f<T>(sb[(t + u) * Np + n]);
        cc[u][p] = to_f<T>(sc[(t + u) * Np + n]);
      }
    }
    float yv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float yt = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        h[p] = fmaf(e[u][p], h[p], bx[u][p]);
        yt = fmaf(h[p], cc[u][p], yt);
      }
      yv[u] = yt;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      yv[u] += __shfl_xor_sync(0xffffffffu, yv[u], 1);
      yv[u] += __shfl_xor_sync(0xffffffffu, yv[u], 2);
    }
    if (g % kPre == 0)
#pragma unroll
      for (int u = 0; u < U; ++u) out[t + u] = yv[u];
  }
  for (; t < nt; ++t) {
    const float dt = to_f<T>(sd[t * CH + c]);
    const float dtx = dt * to_f<T>(sx[t * CH + c]);
    float yt = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int n = g + G * p;
      h[p] = fmaf(exp2f(dt * a2[p]), h[p], dtx * to_f<T>(sb[t * Np + n]));
      yt = fmaf(h[p], to_f<T>(sc[t * Np + n]), yt);
    }
    yt += __shfl_xor_sync(0xffffffffu, yt, 1);
    yt += __shfl_xor_sync(0xffffffffu, yt, 2);
    if (g % kPre == 0) out[t] = yt;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) scan_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float dskip[kThreads];
  const int G = a.G, CH = a.CH, TC = a.TC, N = a.N, Np = a.Np, L = a.L;
  const int ED = a.ED;
  const Layout lay(TC, CH, Np, (int)sizeof(T));
  const int tid = threadIdx.x, c = tid / G, g = tid % G;
  const int ch0 = blockIdx.x * CH;
  const int CHv = min(CH, ED - ch0);  // the block's channels
  const size_t row0 = (size_t)blockIdx.y * L;
  const bool live = c < CHv;
  float av[P], h[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int n = g + G * p;
    av[p] = live && n < N ? a.A[(size_t)(ch0 + c) * N + n] * kLog2e : 0.f;
    h[p] = 0.f;
  }
  if (tid < CHv) dskip[tid] = a.D[ch0 + tid];
  const T* x = (const T*)a.x;
  const T* dl = (const T*)a.delta;
  const T* Bm = (const T*)a.B;
  const T* Cm = (const T*)a.C;
  const bool vxd = CHv == CH && a.vec_xd;
  auto buf = [&](int k) { return smem + (k & 1) * lay.buffer; };
  if (Np > N)  // the pad columns of B and C, never copied over
    for (int i = tid; i < TC * (Np - N); i += kThreads) {
      const int at = i / (Np - N) * Np + N + i % (Np - N);
      for (int k = 0; k < 2; ++k) {
        ((T*)(buf(k) + lay.b))[at] = from_f<T>(0.f);
        ((T*)(buf(k) + lay.c))[at] = from_f<T>(0.f);
      }
    }
  auto stage = [&](int k) {
    const int t0 = k * TC, nt = min(TC, L - t0);
    const size_t at = (row0 + t0) * ED + ch0, bt = (row0 + t0) * N;
    copy_rows_any<T>(vxd, (T*)(buf(k) + lay.x), CH, x + at, ED, nt, CHv);
    copy_rows_any<T>(vxd, (T*)(buf(k) + lay.d), CH, dl + at, ED, nt, CHv);
    copy_rows_any<T>(a.vec_bc, (T*)(buf(k) + lay.b), Np, Bm + bt, N, nt, N);
    copy_rows_any<T>(a.vec_bc, (T*)(buf(k) + lay.c), Np, Cm + bt, N, nt, N);
  };
  float* yp = (float*)(smem + lay.part);
  T* sy = (T*)(smem + lay.y);
  T* y = (T*)a.y;
  const int chunks = (L + TC - 1) / TC;
  for (int k = -1; k < chunks; ++k) {  // stage chunk k + 1, scan chunk k
    if (k + 1 < chunks) stage(k + 1);
    mma::cp_async_commit();
    if (k < 0) continue;
    mma::cp_async_wait<1>();  // chunk k has landed
    __syncthreads();
    const int t0 = k * TC, nt = min(TC, L - t0);
    const T* sx = (const T*)(buf(k) + lay.x);
    scan_steps<T, P>(sx, (const T*)(buf(k) + lay.d),
                     (const T*)(buf(k) + lay.b), (const T*)(buf(k) + lay.c),
                     yp + (size_t)(tid / kPre) * (TC + 1), nt, CH, c, Np, G,
                     g, av, h);
    __syncthreads();
    for (int o = tid; o < CHv * nt; o += kThreads) {
      const int cc = o / nt, t = o % nt;
      const float* part = yp + (size_t)cc * (G / kPre) * (TC + 1) + t;
      float s = 0.f;
      for (int j = 0; j < G / kPre; ++j) s += part[(size_t)j * (TC + 1)];
      sy[t * CH + cc] = from_f<T>(s + dskip[cc] * to_f<T>(sx[t * CH + cc]));
    }
    __syncthreads();
    for (int i = tid; i < nt * CHv; i += kThreads) {
      const int t = i / CHv, cc = i % CHv;
      y[(row0 + t0 + t) * ED + ch0 + cc] = sy[t * CH + cc];
    }
  }
}

template <typename T, int P>
static int launch(const Args& a, int b, cudaStream_t st) {
  const size_t smem = Layout(a.TC, a.CH, a.Np, (int)sizeof(T)).total;
  static size_t opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  const dim3 grid((a.ED + a.CH - 1) / a.CH, b);
  scan_kernel<T, P><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(Args a, int b, cudaStream_t st) {
  const size_t elt = sizeof(T);
  int G = kPre;  // at least kPre lanes a channel (padded states add 0)
  while (G < a.N && G < 32) G *= 2;
  int P = 1;
  while (G * P < a.N) P *= 2;
  a.G = G;
  a.CH = kThreads / G;
  a.Np = G * P;
  int TC = kMaxChunk;  // the longest chunk whose buffers fit the budget
  while (TC > 1 && (2 * TC * a.Np * elt > (size_t)kStageBytes ||
                    Layout(TC, a.CH, a.Np, elt).total > kSmemBudget))
    TC /= 2;
  a.TC = TC;
  a.vec_xd = vec16(a.x, a.CH * elt, a.ED * elt) &&
             vec16(a.delta, a.CH * elt, a.ED * elt);
  a.vec_bc = vec16(a.B, a.N * elt, a.N * elt) &&
             vec16(a.C, a.N * elt, a.N * elt);
  switch (P) {
    case 1: return launch<T, 1>(a, b, st);
    case 2: return launch<T, 2>(a, b, st);
    case 4: return launch<T, 4>(a, b, st);
    case 8: return launch<T, 8>(a, b, st);
    case 16: return launch<T, 16>(a, b, st);
    case 32: return launch<T, 32>(a, b, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace scan
}  // namespace v2m

// x/delta/y (b, L, ED) and B/C (b, L, N) of dtype `dtype`; A (ED, N) and
// D (ED) float32; all contiguous; 1 <= N <= 1024. Returns a cudaError_t
// code.
extern "C" int v2m_selective_scan(int dtype, const void* x, const void* delta,
                                  const void* A, const void* B, const void* C,
                                  const void* D, void* y, int b, int L, int ED,
                                  int N, void* stream) {
  using namespace v2m;
  if (N < 1 || N > scan::kMaxState || L < 1 || ED < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  scan::Args a = {};
  a.x = x;
  a.delta = delta;
  a.B = B;
  a.C = C;
  a.A = (const float*)A;
  a.D = (const float*)D;
  a.y = y;
  a.L = L;
  a.ED = ED;
  a.N = N;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kF32) return scan::dispatch<float>(a, b, st);
  if (dtype == kBF16) return scan::dispatch<bf16>(a, b, st);
  return (int)cudaErrorInvalidValue;
}
