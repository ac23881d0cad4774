// Mamba selective scan: h = exp(delta * A) * h + delta * B * x,
// y = C . h + D * x, walked once over the sequence.
//
// Replaces the TPU kernel video2music_tpu/ops/pallas_scan.py:
// selective_scan_pallas (_scan_kernel). On the JAX product path the same
// function runs as jax.lax.associative_scan (ops/scan.py:selective_scan);
// the port puts this kernel on the bimamba+ regression path instead.
//
// What bounds it on the H100: the recurrence is sequential in L. At the
// product shape (b = 1, L = 300, ED = 128, N = 16) it reads x, delta, B, C
// once (0.3 MB) and does 300 dependent steps of 16 exp + 48 FMA per
// channel, so it is bound by the latency of that chain, not by bytes or
// FLOPs, and the 128 channels fill only two blocks. The design keeps the
// whole N-wide state of a channel in registers (one thread per (b, ed)
// channel, no state ever leaves the SM), stages B and C for a chunk of time
// steps in shared memory (every channel of a batch row reads the same B_t,
// C_t), and reads x and delta coalesced across the channels of a warp.
#include "common.cuh"

namespace v2m {

constexpr int kScanThreads = 64;  // channels per block
constexpr int kScanChunk = 64;    // time steps of B/C staged per pass

template <typename T, int N>
__global__ void __launch_bounds__(kScanThreads)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                      const float* __restrict__ A, const T* __restrict__ B,
                      const T* __restrict__ C, const float* __restrict__ Dv,
                      T* __restrict__ y, int L, int ED) {
  __shared__ float bs[kScanChunk][N];
  __shared__ float cs[kScanChunk][N];
  const int b = blockIdx.y;
  const int e = blockIdx.x * kScanThreads + threadIdx.x;
  const bool live = e < ED;
  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[(size_t)e * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dskip = live ? Dv[e] : 0.f;
  const size_t row0 = (size_t)b * L;
  for (int t0 = 0; t0 < L; t0 += kScanChunk) {
    const int nt = min(kScanChunk, L - t0);
    for (int i = threadIdx.x; i < nt * N; i += kScanThreads) {
      bs[i / N][i % N] = to_f<T>(B[(row0 + t0) * N + i]);
      cs[i / N][i % N] = to_f<T>(C[(row0 + t0) * N + i]);
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < nt; ++t) {
        const size_t at = (row0 + t0 + t) * ED + e;
        const float xt = to_f<T>(x[at]);
        const float dt = to_f<T>(delta[at]);
        const float dtx = dt * xt;
        float yt = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = fmaf(expf(dt * a[n]), h[n], dtx * bs[t][n]);
          yt = fmaf(h[n], cs[t][n], yt);
        }
        y[at] = from_f<T>(yt + dskip * xt);
      }
    }
    __syncthreads();
  }
}

template <typename T, int N>
static void launch(const void* x, const void* delta, const float* A,
                   const void* B, const void* C, const float* D, void* y,
                   int b, int L, int ED, cudaStream_t st) {
  dim3 grid((ED + kScanThreads - 1) / kScanThreads, b);
  selective_scan_kernel<T, N><<<grid, kScanThreads, 0, st>>>(
      (const T*)x, (const T*)delta, A, (const T*)B, (const T*)C, D, (T*)y, L,
      ED);
}

template <typename T>
static int dispatch(const void* x, const void* delta, const float* A,
                    const void* B, const void* C, const float* D, void* y,
                    int b, int L, int ED, int N, cudaStream_t st) {
  switch (N) {
    case 4: launch<T, 4>(x, delta, A, B, C, D, y, b, L, ED, st); break;
    case 8: launch<T, 8>(x, delta, A, B, C, D, y, b, L, ED, st); break;
    case 16: launch<T, 16>(x, delta, A, B, C, D, y, b, L, ED, st); break;
    case 32: launch<T, 32>(x, delta, A, B, C, D, y, b, L, ED, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace v2m

// x/delta/y (b, L, ED) and B/C (b, L, N) of dtype `dtype`; A (ED, N) and
// D (ED) float32; all contiguous. Returns a cudaError_t code.
extern "C" int v2m_selective_scan(int dtype, const void* x, const void* delta,
                                  const void* A, const void* B, const void* C,
                                  const void* D, void* y, int b, int L, int ED,
                                  int N, void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  const float* a = (const float*)A;
  const float* d = (const float*)D;
  if (dtype == kF32)
    return dispatch<float>(x, delta, a, B, C, d, y, b, L, ED, N, st);
  if (dtype == kBF16)
    return dispatch<bf16>(x, delta, a, B, C, d, y, b, L, ED, N, st);
  return (int)cudaErrorInvalidValue;
}
