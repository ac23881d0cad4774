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
//     are not ported).
//   * floor: read every slab byte and reduce: per group of `block` clips,
//     the f32 column sums of its K and V rows plus each clip's q: the
//     cache-traffic floor beside attend's time.
//   * noattn: q * 1.0001, the launch and the q / out traffic alone.
// What bounds it: bytes. At the probe's B = 32, S = 300, D = 512 the bf16
// slabs are 19.7 MB (5.87 us at 3.35 TB/s), the int8 ones 9.9 MB (2.96
// us). So the designs keep bytes in flight and stay one launch:
//   * attend_kernel: each warp takes a share of a (clip, head)'s rows; a
//     row group of lanes takes a row, 16 bytes a lane, and every lane
//     issues the K and the V pieces of its next rows (8 loads of 16 bytes)
//     before any arithmetic, then an online softmax folds them in, so no
//     pos is too long; the warps' (max, sum, P . V) are combined in order
//     by the block, or by the first block of a cluster through
//     distributed shared memory where a head's rows are split over a
//     thread-block cluster (few (clip, head) pairs). int8 rows are
//     unpacked exactly by byte permutes (I2F is quarter-rate). On an H100
//     (PERF.md, PR 19) this beat staging the rows in shared memory first
//     (a cp.async ring: 1.5-1.7x slower; TMA bulk copies a row: no
//     faster) and every cluster split at B >= 16.
//   * floor_kernel: one launch. A block streams a contiguous row range of
//     one group's K and V in a column slice, 8 loads of 16 bytes in
//     flight a thread, and reduces in registers; where a slice's rows are
//     one range the block writes the sums plus q itself, else it writes
//     one f32 partial row and the last block of a (group, slice) to take
//     its ticket (an acquire-release atomic) adds the partials in block
//     order, adds q and resets the ticket. No memset, no atomics on data:
//     the same bits every run.
//
// Row 14 replaces tools/probe_dotgeneral.py:_kernel (its pallas_call at
// :35), which checks that the product forms a wide batched attention
// needs lower: NT logits (rows, D) . (C, D)^T, TN pv (rows, C)^T . (rows,
// D), NT tiny-diag (C, D) . (C, D)^T, f32 out. What bounds it: bytes at
// the probe's shapes (rows = 2400, D = 512, C = 64: 3.1 MB in bf16, 0.16
// GFLOP), and few output tiles to spread them over (38, 8 and 1 tiles of
// 64 x 64). dot_kernel: a block computes a 64 x 64 tile of C over a range
// of K; 16-byte cp.async copies fill a ring of four stages of 128-byte
// deep K tiles (64 bf16, 32 f32) in shared memory, each operand staged as
// it lies in memory (K-major for NT, M- or N-major for TN); its 8 warps
// take the even and the odd 16-deep steps of each tile (two halves added
// at the end), so a block's chain of dependent products is half as long;
// bf16 feeds mma.sync m16n8k16 through ldmatrix (.trans for the MN-major
// operands), f32 runs TF32 m16n8k8 on fragments read from the staged
// tiles (rounded by cvt.rna; about three decimal digits). Where the
// output has too few tiles to fill the card, K is split over the blocks
// of a thread-block cluster and their partial tiles added through
// distributed shared memory in rank order: one launch, no partials in
// device memory, the same sum every run. Operands whose rows are no
// multiple of 16 bytes are staged element by element (a separate
// instance: a runtime branch between the two slowed the vector path).
#include <cooperative_groups.h>

#include <type_traits>
#include <utility>

#include "attention_mma.cuh"

namespace v2m {
namespace probe {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kSmemMax = 232448;  // dynamic shared memory a block can use

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// kernel<<<grid, threads, smem, st>>>(args...) as clusters of `cluster`
// blocks. Returns the launch's cudaError_t code.
template <typename... P, typename... A>
static int launch_cluster(void (*kernel)(P...), dim3 grid, int threads,
                          size_t smem, cudaStream_t st, dim3 cluster,
                          A&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
}

// Lets `kernel` take as much dynamic shared memory as fits beside its
// static shared memory in kSmemMax, once per instance (`done`), whatever
// a call asks for. Returns a cudaError_t code.
template <typename K>
static int allow_smem(K kernel, bool& done) {
  if (done) return 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax - (int)fa.sharedSizeBytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

// ---------------------------------------------------------------------------
// row 13: the decode-attention core, its floor and its no-cache form
// ---------------------------------------------------------------------------

constexpr int kAttLoads = 8;  // 16-byte loads a lane keeps in flight

struct AttendArgs {
  const bf16* q;     // (B, D)
  const void* k;     // (B, S, D) C
  const void* v;     // (B, S, D) C
  const float* ks;   // (B, S) f32 row scales (C = int8_t)
  const float* vs;
  bf16* out;         // (B, D)
  int S, D, hd, rows, per;
  float scale;
};

// Shared memory of attend_kernel<C, W, KV> at head size hd: each warp's
// P . V, max and sum (hd + 2).
__host__ __device__ constexpr size_t attend_smem(int hd, int W) {
  return (size_t)W * (hd + 2) * sizeof(float);
}

// The 16 values of a 16-byte piece as floats: bf16 by a shift each; int8
// exactly by a byte permute into 0x4B0000uu (2^23 + u, u = x + 128) and
// one subtraction, two full-rate instructions where I2F is quarter-rate.
template <typename C>
__device__ __forceinline__ void unpack16(const uint4& raw,
                                         float (&f)[Vec<C>::N]) {
  if constexpr (std::is_same<C, int8_t>::value) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] =
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | j)) -
            8388736.f;
    }
  } else {
    const C* e = reinterpret_cast<const C*>(&raw);
#pragma unroll
    for (int i = 0; i < Vec<C>::N; ++i) f[i] = to_f<C>(e[i]);
  }
}

// grid (H * cs, B), clusters of cs blocks along x, W warps a block: block
// `rank` of (head h, clip b) takes rows [rank * per, (rank + 1) * per) of
// [0, rows), warp w of it the w-th W-th of those. Each warp works alone
// until the cluster combines: a row group of G lanes takes a row, a lane
// KV 16-byte pieces of it (hd <= G KV Vec<C>::N); a step of the warp
// takes 32 / G x U rows (U = kAttLoads / 2 KV a group), and every lane
// issues the K and the V pieces of all its U rows (and, int8, their
// scales) before any arithmetic: kAttLoads 16-byte loads in flight a
// lane. The warp keeps a running max m (shuffles), each lane its share of
// sum(exp(logit - m)) and of P . V, rescaled when a step raises m; a
// row's probability never leaves registers. The cluster's first block
// then combines every warp's (m, sum, P . V), ranks and warps in order,
// through distributed shared memory (its own, with no cluster barrier,
// when cs = 1).
template <typename C, int W, int G, int KV>
__global__ void __launch_bounds__(32 * W)
attend_kernel(AttendArgs a) {
  constexpr int V = Vec<C>::N;  // elements of a 16-byte piece
  constexpr bool kQ = std::is_same<C, int8_t>::value;
  constexpr int U = kAttLoads / (2 * KV);  // rows a row group a step
  constexpr int kGroups = 32 / G;          // row groups a warp
  extern __shared__ __align__(16) float res[];  // (W, hd + 2)
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int hd = a.hd, D = a.D, S = a.S, nvec = hd / V;
  const int h = blockIdx.x / cs, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, sub = lane % G, grp = lane / G;
  const int r0 = min(a.rows, rank * a.per), r1 = min(a.rows, r0 + a.per);
  const int pw = (r1 - r0 + W - 1) / W;
  const int w0 = min(r1, r0 + warp * pw), w1 = min(r1, w0 + pw);
  const C* kg = (const C*)a.k + (size_t)b * S * D + h * hd;
  const C* vg = (const C*)a.v + (size_t)b * S * D + h * hd;
  const float* ksg = kQ ? a.ks + (size_t)b * S : nullptr;
  const float* vsg = kQ ? a.vs + (size_t)b * S : nullptr;
  float m = -INFINITY, lsum = 0.f;
  float qv[KV][V], acc[KV][V];
  const bf16* qh = a.q + (size_t)b * D + h * hd;
#pragma unroll
  for (int jv = 0; jv < KV; ++jv) {  // this lane's q pieces
    const int j = sub + G * jv;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      qv[jv][i] = j < nvec ? __bfloat162float(qh[j * V + i]) : 0.f;
      acc[jv][i] = 0.f;
    }
  }
  for (int base = w0; base < w1; base += kGroups * U) {
    uint4 kr[U][KV], vr[U][KV];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every load of the step, then the math
      const int r = base + kGroups * u + grp;
      const bool ok = r < w1;
#pragma unroll
      for (int jv = 0; jv < KV; ++jv) {
        const int j = sub + G * jv;
        const bool in = ok && j < nvec;
        kr[u][jv] = in ? __ldg(reinterpret_cast<const uint4*>(
                             kg + (size_t)r * D + j * V))
                       : make_uint4(0, 0, 0, 0);
        vr[u][jv] = in ? __ldg(reinterpret_cast<const uint4*>(
                             vg + (size_t)r * D + j * V))
                       : make_uint4(0, 0, 0, 0);
      }
      if (kQ) {
        ksc[u] = ok ? __ldg(ksg + r) : 0.f;
        vsc[u] = ok ? __ldg(vsg + r) : 0.f;
      }
    }
    float lg[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int jv = 0; jv < KV; ++jv) {
        float e[V];
        unpack16<C>(kr[u][jv], e);
#pragma unroll
        for (int i = 0; i < V; ++i) dot = fmaf(qv[jv][i], e[i], dot);
      }
      lg[u] = dot;
    }
#pragma unroll
    for (int o = 1; o < G; o <<= 1)  // a row group's lanes
#pragma unroll
      for (int u = 0; u < U; ++u)
        lg[u] += __shfl_xor_sync(0xffffffffu, lg[u], o);
    float cmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = base + kGroups * u + grp < w1;
      lg[u] = ok ? lg[u] * a.scale * (kQ ? ksc[u] : 1.f) : -INFINITY;
      cmax = fmaxf(cmax, lg[u]);
    }
#pragma unroll
    for (int o = G; o < 32; o <<= 1)  // the warp's row groups
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
    const float mn = fmaxf(m, cmax);
    const float alpha = expf(m - mn);  // 0 on the first step
    m = mn;
    lsum *= alpha;
#pragma unroll
    for (int jv = 0; jv < KV; ++jv)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[jv][i] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float e = expf(lg[u] - m);  // 0 past the rows
      if (sub == 0) lsum += e;          // a row counted once
      const float w = kQ ? e * vsc[u] : e;
#pragma unroll
      for (int jv = 0; jv < KV; ++jv) {
        float f[V];
        unpack16<C>(vr[u][jv], f);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[jv][i] = fmaf(w, f[i], acc[jv][i]);
      }
    }
  }
  // the warp's row groups, then its lanes' sums
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int jv = 0; jv < KV; ++jv)
#pragma unroll
      for (int i = 0; i < V; ++i)
        acc[jv][i] += __shfl_xor_sync(0xffffffffu, acc[jv][i], o);
  lsum = warp_sum(lsum);
  const int st = hd + 2;  // floats an entry
  float* mine = res + warp * st;
  if (lane < G) {
#pragma unroll
    for (int jv = 0; jv < KV; ++jv) {
      const int j = sub + G * jv;
      if (j < nvec)
#pragma unroll
        for (int i = 0; i < V; ++i) mine[j * V + i] = acc[jv][i];
    }
  }
  if (lane == 0) {
    mine[hd] = m;
    mine[hd + 1] = lsum;
  }
  if (cs == 1)
    __syncthreads();
  else
    cluster.sync();  // every warp's (P . V, max, sum) is in place
  if (rank == 0) {  // block-uniform: the barriers below are safe
    constexpr int kE = kMaxCluster * W;  // entries at most
    __shared__ float scale_e[kE], sum_e[kE];
    const int n = cs * W;
    // entry e: warp e % W of rank e / W
    auto entry = [&](int e) -> const float* {
      return cs == 1 ? res + e * st
                     : cluster.map_shared_rank(res, e / W) + (e % W) * st;
    };
    for (int e0 = 0; e0 < kE; e0 += 32) {
      if (warp == 0) {  // lane e fetches entry e0 + e's max and sum
        const int e = e0 + lane;
        float em = -INFINITY, el = 0.f;
        if (e < n) {
          const float* pr = entry(e);
          em = pr[hd];
          el = pr[hd + 1];
        }
        scale_e[e] = em;
        sum_e[e] = el;
      }
    }
    __syncthreads();
    float mx = -INFINITY;
    for (int e = 0; e < n; ++e) mx = fmaxf(mx, scale_e[e]);
    float total = 0.f;
    for (int e = 0; e < n; ++e)  // in order
      total += sum_e[e] * expf(scale_e[e] - mx);  // 0 for no rows
    for (int i = tid; i < hd; i += 32 * W) {
      float o = 0.f;
      for (int e0 = 0; e0 < n; e0 += 8) {
        float x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)  // the loads issued together
          x[e] = e0 + e < n ? entry(e0 + e)[i] : 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e)  // in order
          if (e0 + e < n) o += x[e] * expf(scale_e[e0 + e] - mx);
      }
      a.out[(size_t)b * D + h * hd + i] = __float2bfloat16_rn(o / total);
    }
  }
  if (cs > 1) cluster.sync();  // no block leaves before the first read it
}

template <typename C, int W, int G, int KV>
static int attend_launch(const AttendArgs& args, int H, int B, int cluster,
                         cudaStream_t st) {
  return launch_cluster(attend_kernel<C, W, G, KV>, dim3(H * cluster, B),
                        32 * W, attend_smem(args.hd, W), st,
                        dim3(cluster, 1, 1), args);
}

// attend_launch with a row's lanes and a lane's pieces: a row of at most
// four 16-byte pieces (int8 to head size 64) takes 4 lanes, one piece
// each; a longer one 8 lanes, with 2 pieces each above eight (bf16 above
// head size 64). Blocks of 8 warps for bf16 rows, 4 for int8 ones: the
// faster counts on an H100 at B = 16, 32 and 64 (PERF.md, PR 19).
template <typename C>
static int attend_kv(const AttendArgs& args, int H, int B, int cluster,
                     cudaStream_t st) {
  constexpr int V = Vec<C>::N, W = std::is_same<C, bf16>::value ? 8 : 4;
  if (args.hd <= 4 * V)
    return attend_launch<C, W, 4, 1>(args, H, B, cluster, st);
  if constexpr (8 * V < 128) {  // a head of up to 128 needs 2 pieces a lane
    if (args.hd > 8 * V)
      return attend_launch<C, W, 8, 2>(args, H, B, cluster, st);
  }
  return attend_launch<C, W, 8, 1>(args, H, B, cluster, st);
}

constexpr int kFloorThreads = 256;
constexpr int kFloorUnroll = 4;  // rows of K and of V a lane loads at once

// grid (chunks, slices, groups). Group g is `rows` = block * S rows of K
// and of V (B / block groups, each a contiguous (rows, D) slab). Block
// (j, sl, g) sums rows [j rows / chunks, (j + 1) rows / chunks) of both,
// columns [sl * width, sl * width + width) (clipped at D), in f32: a lane
// takes 8 columns (one 16-byte load a row) of every lanes-th row,
// kFloorUnroll rows of K and of V loaded before any is added; the lanes'
// sums are added in lane order. With one range (chunks = 1) the block
// writes out[b, those columns] = bf16(sums + q[b]) for the group's clips.
// Else it writes one partial row of `width` floats at
// ws[((g * slices + sl) * chunks + j) * width] and takes a ticket of (g,
// sl); the last one adds the chunks' partials in block order, adds each
// clip's q and writes out, then resets the ticket to zero for the next
// call.
__global__ void __launch_bounds__(kFloorThreads)
floor_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out,
             float* __restrict__ ws, unsigned int* __restrict__ tickets,
             int rows, int D, int block, int width, int chunks) {
  extern __shared__ __align__(16) float fsm[];  // (lanes, width)
  __shared__ bool last;
  const int pieces = width / 8, lanes = kFloorThreads / pieces;
  const int tid = threadIdx.x, lane = tid / pieces, cc = (tid % pieces) * 8;
  const int j = blockIdx.x, sl = blockIdx.y, g = blockIdx.z;
  const int slices = gridDim.y, c0 = sl * width;
  const int cw = min(width, D - c0);  // this slice's columns
  const int r0 = (int)((long long)j * rows / chunks);
  const int r1 = (int)((long long)(j + 1) * rows / chunks);
  for (int i = tid; i < block; i += kFloorThreads)  // the finish's q, to L2
    prefetch_l2(q + (size_t)(g * block + i) * D + c0);
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  if (lane < lanes && cc < cw) {
    const bf16* kg = k + (size_t)g * rows * D + c0 + cc;
    const bf16* vg = v + (size_t)g * rows * D + c0 + cc;
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
  }
  if (lane < lanes)
#pragma unroll
    for (int i = 0; i < 8; ++i) fsm[lane * width + cc + i] = acc[i];
  __syncthreads();
  const size_t tile = (size_t)g * slices + sl;
  if (chunks == 1) {  // the block has every row: no partials, no ticket
    for (int i = tid; i < block * cw; i += kFloorThreads) {  // (clip, col)
      const int c = i % cw;
      float s = 0.f;
      for (int l = 0; l < lanes; ++l) s += fsm[l * width + c];
      const size_t o = (size_t)(g * block + i / cw) * D + c0 + c;
      out[o] = __float2bfloat16_rn(s + __bfloat162float(q[o]));
    }
    return;
  }
  float* mine = ws + (tile * chunks + j) * width;
  for (int c = tid; c < cw; c += kFloorThreads) {
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += fsm[l * width + c];
    mine[c] = s;
  }
  __syncthreads();  // the block's partial row is written
  if (tid == 0) {  // release it, and acquire the others' if last
    unsigned int before;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(before)
                 : "l"(tickets + tile)
                 : "memory");
    last = before == (unsigned int)(chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  const float* parts = ws + tile * chunks * width;
  float sum = 0.f;  // column tid's (width <= kFloorThreads)
  for (int j0 = 0; j0 < chunks; j0 += lanes) {  // lanes rows a piece
    const int nn = min(lanes, chunks - j0);
    __syncthreads();  // the last piece is read
    for (int i = tid; i < nn * cw; i += kFloorThreads) {
      const int jj = i / cw, c = i - jj * cw;
      fsm[jj * width + c] = __ldcg(parts + (size_t)(j0 + jj) * width + c);
    }
    __syncthreads();
    if (tid < cw)
      for (int jj = 0; jj < nn; ++jj) sum += fsm[jj * width + tid];  // in order
  }
  __syncthreads();
  if (tid < cw) fsm[tid] = sum;
  __syncthreads();
  for (int i = tid; i < block * cw; i += kFloorThreads) {  // (clip, column)
    const int c = i % cw;
    const size_t o = (size_t)(g * block + i / cw) * D + c0 + c;
    out[o] = __float2bfloat16_rn(fsm[c] + __bfloat162float(q[o]));
  }
  if (tid == 0) tickets[tile] = 0u;  // ready for the next call
}

__global__ void noattn_kernel(const bf16* __restrict__ q, bf16* __restrict__ out,
                              int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __float2bfloat16_rn(__bfloat162float(q[i]) * 1.0001f);
}

// ---------------------------------------------------------------------------
// row 14: the dot_general forms on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kDotThreads = 256;  // 2 k-halves x 2 x 2 warps of 32 x 32
constexpr int kDotStages = 4;
constexpr int kRedLd = 64 + 4;  // floats a row of a partial tile

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

// A staged operand tile of T: 64 rows (m or n) by kBK of K, 128 bytes
// deep. K-major (KM: NT, k contiguous in memory) it is 64 staged rows of
// kBK; MN-major (TN, m or n contiguous) kBK staged rows of 64. A staged
// row is padded so that the eight 16-byte rows an ldmatrix reads, and the
// lanes' TF32 fragment loads, fall into distinct banks.
template <typename T, bool KM> struct DotTile {
  static constexpr int kBK = 128 / (int)sizeof(T);
  static constexpr int kV = 16 / (int)sizeof(T);  // elements a copy
  static constexpr int kRows = KM ? 64 : kBK;
  static constexpr int kCols = KM ? kBK : 64;
  static constexpr int kLd = kCols + (KM ? kV : 8);
  static constexpr int kElems = kRows * kLd;
};

__host__ __device__ constexpr size_t dot_smem() {
  return (size_t)kDotStages * 2 * 64 * 72 * 2;  // every DotTile is 9216 B
}

struct DotArgs {
  const void* a;  // NT: (M, K); TN: (K, M)
  const void* b;  // NT: (N, K); TN: (K, N)
  float* c;       // (M, N)
  int M, N, K;
};

// Staged rows row0 .. row0 + kRows - 1 of x (rows ld apart), columns
// col0 .. + kCols - 1, into a tile; rows at or past row_lim and columns
// at or past col_lim are zero. VEC: 16-byte cp.async copies (ld and
// col_lim multiples of kV, x 16-byte aligned); else element by element.
template <typename T, bool KM, bool VEC>
__device__ __forceinline__ void dot_stage(T* dst, const T* __restrict__ x,
                                          int ld, int row0, int row_lim,
                                          int col0, int col_lim) {
  using Tl = DotTile<T, KM>;
  constexpr int kPer = Tl::kCols / Tl::kV;  // copies a staged row
  constexpr int kTotal = Tl::kRows * kPer;  // 512
#pragma unroll
  for (int it = 0; it < kTotal / kDotThreads; ++it) {
    const int i = it * kDotThreads + threadIdx.x;
    const int r = i / kPer, cc = (i % kPer) * Tl::kV;
    const int row = row0 + r, col = col0 + cc;
    T* d = dst + r * Tl::kLd + cc;
    if constexpr (VEC) {
      const bool ok = row < row_lim && col < col_lim;
      mma::cp_async16(d, ok ? x + (size_t)row * ld + col : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < Tl::kV; ++e)
        d[e] = row < row_lim && col + e < col_lim
                   ? x[(size_t)row * ld + col + e]
                   : from_f<T>(0.f);
    }
  }
}

// grid (ceil(N / 64), ceil(M / 64), cs), clusters of (1, 1, cs): block
// rank r of tile (m0, n0) computes C[m0.., n0..] over K tiles [r per,
// (r + 1) per) of the ceil(K / kBK). Its warps 0-3 take the even 16-deep
// (bf16; 8-deep TF32) steps of each K tile, warps 4-7 the odd ones, each
// warp a 32 x 32 quarter of the tile; the two halves are added (even +
// odd) in shared memory at the end. With cs > 1 the blocks' tiles meet
// there too and rank r writes rows [r 64 / cs, (r + 1) 64 / cs) of the
// tile, the ranks' partials added in rank order. Fragments (g = lane / 4,
// t = lane % 4), PTX ISA: bf16 m16n8k16 A (g, 2t..2t+1), (g+8, ..), (g,
// 2t+8..), (g+8, 2t+8..), B (k 2t..2t+1, n g), (k 2t+8.., n g); TF32
// m16n8k8 A (g, t), (g+8, t), (g, t+4), (g+8, t+4), B (k t, n g), (k t+4,
// n g); C (g, 2t..2t+1), (g+8, 2t..2t+1).
template <typename T, bool KM, bool VEC>
__global__ void __launch_bounds__(kDotThreads) dot_kernel(DotArgs d) {
  using Tl = DotTile<T, KM>;
  constexpr int kBK = Tl::kBK, kLd = Tl::kLd;
  constexpr bool kBf = std::is_same<T, bf16>::value;
  constexpr int kSteps = kBK / (kBf ? 16 : 8);  // mma k-steps a K tile
  extern __shared__ __align__(16) unsigned char dot_smem_raw[];
  T* ring = reinterpret_cast<T*>(dot_smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int M = d.M, N = d.N, K = d.K;
  const T* a = (const T*)d.a;
  const T* b = (const T*)d.b;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = warp >> 2, g = lane >> 2, t = lane & 3;
  const int wm = ((warp >> 1) & 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const int ktiles = cdiv(K, kBK), per = cdiv(ktiles, cs);
  const int kt0 = min(ktiles, rank * per), nk = min(ktiles, kt0 + per) - kt0;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  auto load = [&](int slot, int kt) {
    T* As = ring + slot * 2 * Tl::kElems;
    T* Bs = As + Tl::kElems;
    const int k0 = kt * kBK;
    if (KM) {
      dot_stage<T, KM, VEC>(As, a, K, m0, M, k0, K);
      dot_stage<T, KM, VEC>(Bs, b, K, n0, N, k0, K);
    } else {
      dot_stage<T, KM, VEC>(As, a, M, k0, K, m0, M);
      dot_stage<T, KM, VEC>(Bs, b, N, k0, K, n0, N);
    }
  };
#pragma unroll
  for (int s = 0; s < kDotStages - 1; ++s) {
    if (s < nk) load(s, kt0 + s);
    mma::cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    mma::cp_async_wait<kDotStages - 2>();  // tile i is in
    __syncthreads();  // everyone's copies; slot (i - 1) is read
    if (i + kDotStages - 1 < nk)
      load((i + kDotStages - 1) % kDotStages, kt0 + i + kDotStages - 1);
    mma::cp_async_commit();
    const T* As = ring + (i % kDotStages) * 2 * Tl::kElems;
    const T* Bs = As + Tl::kElems;
#pragma unroll
    for (int ks = 0; ks < kSteps / 2; ++ks) {
      const int kk = 2 * ks + half;
      if constexpr (kBf) {
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (KM)
            mma::ldmatrix_x4(af[mi], As + (wm + mi * 16 + (lane & 15)) * kLd +
                                         kk * 16 + (lane >> 4) * 8);
          else
            mma::ldmatrix_x4_trans(
                af[mi], As + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                            wm + mi * 16 + (((lane >> 3) & 1) << 3));
        }
#pragma unroll
        for (int n2 = 0; n2 < 2; ++n2) {
          uint32_t r[4];
          if (KM)
            mma::ldmatrix_x4(
                r, Bs + (wn + n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                       kk * 16 + (((lane >> 3) & 1) << 3));
          else
            mma::ldmatrix_x4_trans(
                r, Bs + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kLd +
                       wn + n2 * 16 + ((lane >> 4) << 3));
          bfr[2 * n2][0] = r[0];
          bfr[2 * n2][1] = r[1];
          bfr[2 * n2 + 1][0] = r[2];
          bfr[2 * n2 + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma::mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
      } else {
        // element (row, k) of a staged tile
        auto at = [&](const T* tl, int row, int k) -> float {
          return to_f<T>(KM ? tl[row * kLd + k] : tl[k * kLd + row]);
        };
        const int k = kk * 8 + t;
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int row = wm + mi * 16 + g;
          af[mi][0] = to_tf32(at(As, row, k));
          af[mi][1] = to_tf32(at(As, row + 8, k));
          af[mi][2] = to_tf32(at(As, row, k + 4));
          af[mi][3] = to_tf32(at(As, row + 8, k + 4));
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = wn + ni * 8 + g;
          const uint32_t b0 = to_tf32(at(Bs, col, k));
          const uint32_t b1 = to_tf32(at(Bs, col, k + 4));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_tf32(acc[mi][ni], af[mi], b0, b1);
        }
      }
    }
  }
  // the odd half's tile into shared memory, added to the even half's
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds partial tiles now
  float* red = reinterpret_cast<float*>(dot_smem_raw);  // (64, kRedLd)
  auto at_red = [&](int mi, int ni, int e) -> float& {
    return red[(wm + mi * 16 + g + (e < 2 ? 0 : 8)) * kRedLd + wn + ni * 8 +
               2 * t + (e & 1)];
  };
  if (half == 1)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) at_red(mi, ni, e) = acc[mi][ni][e];
  __syncthreads();
  if (half == 0)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = acc[mi][ni][e] + at_red(mi, ni, e);
          if (cs == 1) {
            const int m = m0 + wm + mi * 16 + g + (e < 2 ? 0 : 8);
            const int n = n0 + wn + ni * 8 + 2 * t + (e & 1);
            if (m < M && n < N) d.c[(size_t)m * N + n] = v;
          } else {
            at_red(mi, ni, e) = v;  // each element read and written once
          }
        }
  if (cs == 1) return;
  cluster.sync();  // every rank's tile is in place
  const int rows = 64 / cs;
  for (int i = tid; i < rows * 16; i += kDotThreads) {
    const int r = rank * rows + i / 16, c4 = (i % 16) * 4;
    float4 x[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)  // the loads issued together
      if (q < cs)
        x[q] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red, q) + r * kRedLd + c4);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)  // in rank order
      if (q < cs) {
        s.x += x[q].x;
        s.y += x[q].y;
        s.z += x[q].z;
        s.w += x[q].w;
      }
    const int m = m0 + r, n = n0 + c4;
    if (m < M) {
      float* o = d.c + (size_t)m * N;
      if (n < N) o[n] = s.x;
      if (n + 1 < N) o[n + 1] = s.y;
      if (n + 2 < N) o[n + 2] = s.z;
      if (n + 3 < N) o[n + 3] = s.w;
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

template <typename T, bool KM, bool VEC>
static int dot_launch(const DotArgs& args, int cluster, cudaStream_t st) {
  static bool opted = false;
  const int err = allow_smem(dot_kernel<T, KM, VEC>, opted);
  if (err) return err;
  const dim3 grid(cdiv(args.N, 64), cdiv(args.M, 64), cluster);
  return launch_cluster(dot_kernel<T, KM, VEC>, grid, kDotThreads, dot_smem(),
                        st, dim3(1, 1, cluster), args);
}

template <typename T>
static int dot_form(const DotArgs& args, int form, int vec, int cluster,
                    cudaStream_t st) {
  if (form == 0)
    return vec ? dot_launch<T, true, true>(args, cluster, st)
               : dot_launch<T, true, false>(args, cluster, st);
  return vec ? dot_launch<T, false, true>(args, cluster, st)
             : dot_launch<T, false, false>(args, cluster, st);
}

inline bool pow2_cluster(int c) {
  return c == 1 || c == 2 || c == 4 || c == 8;
}

inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

}  // namespace probe
}  // namespace v2m

// The decode-attention core of row 13: q (B, D) bf16; k, v (B, S, D) bf16
// (kv_dtype 1) or int8 (kv_dtype 2, with ks / vs (B, S) f32 row scales),
// k and v 16-byte aligned; out (B, D) bf16; rows 0..pos; H heads of D / H. The
// plan (the wrapper's attend_plan): each head's rows over a cluster of
// `cluster` blocks of `per` rows. Returns a cudaError_t code.
extern "C" int v2m_kv_probe_attend(int kv_dtype, const void* q, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, void* out, int B, int S,
                                   int D, int H, int pos, int cluster, int per,
                                   void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || H <= 0 || D % H || pos < 0 || pos >= S)
    return (int)cudaErrorInvalidValue;
  const int hd = D / H, rows = pos + 1;
  const bool quant = kv_dtype == 2;
  const int V = quant ? Vec<int8_t>::N : Vec<bf16>::N;
  if ((kv_dtype != 1 && !quant) || hd % V || hd > 128 ||
      !probe::pow2_cluster(cluster) || per < 1 ||
      (long long)per * cluster < rows || !probe::aligned16(k) ||
      !probe::aligned16(v))
    return (int)cudaErrorInvalidValue;
  const probe::AttendArgs args{(const bf16*)q, k, v, (const float*)ks,
                               (const float*)vs, (bf16*)out, S, D, hd, rows,
                               per, 1.f / sqrtf((float)hd)};
  const int err =
      quant ? probe::attend_kv<int8_t>(args, H, B, cluster, st)
            : probe::attend_kv<bf16>(args, H, B, cluster, st);
  if (err) return err;
  return (int)cudaGetLastError();
}

// Row 13's floor: q (B, D), k, v (B, S, D) bf16, out (B, D) bf16; clips in
// groups of `block` (B a multiple). The plan (the wrapper's floor_plan):
// column slices of `width` (a multiple of 8), `chunks` row ranges a group.
// ws: (B / block) x ceil(D / width) x chunks x width f32 (no initial
// value); tickets: (B / block) x ceil(D / width) u32, zero before the
// first call and left zero by every call. Returns a cudaError_t code.
extern "C" int v2m_kv_probe_floor(const void* q, const void* k, const void* v,
                                  void* out, void* ws, void* tickets, int B,
                                  int S, int D, int block, int width,
                                  int chunks, void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  if (block <= 0 || B < block || B % block || S < 1 || D < 8 || D % 8 ||
      width < 8 || width % 8 || width > D || width > probe::kFloorThreads ||
      chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int slices = probe::cdiv(D, width);
  const int lanes = probe::kFloorThreads / (width / 8);
  const size_t smem = (size_t)lanes * width * sizeof(float);
  probe::floor_kernel<<<dim3(chunks, slices, B / block), probe::kFloorThreads,
                        smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)ws,
      (unsigned int*)tickets, block * S, D, block, width, chunks);
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

// Row 14: c (M, N) f32 = a . b^T (form 0, NT: a (M, K), b (N, K)) or a^T .
// b (form 1, TN: a (K, M), b (K, N)), a and b of `dtype` (f32 through
// TF32, bf16), contiguous. The plan (the wrapper's dot_plan): K split
// over clusters of `cluster` blocks; vec: stage by 16-byte copies (the
// rows a multiple of 16 bytes, a and b 16-byte aligned). Returns a
// cudaError_t code.
extern "C" int v2m_probe_dot(int dtype, int form, const void* a, const void* b,
                             void* c, int M, int N, int K, int cluster,
                             int vec, void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || N < 1 || K < 1 || probe::cdiv(M, 64) > 65535 ||
      !probe::pow2_cluster(cluster) || (form != 0 && form != 1))
    return (int)cudaErrorInvalidValue;
  const int V = dtype == kBF16 ? 8 : 4;
  if (vec && (!probe::aligned16(a) || !probe::aligned16(b) ||
              (form == 0 ? K % V : (M % V || N % V))))
    return (int)cudaErrorInvalidValue;
  const probe::DotArgs args{a, b, (float*)c, M, N, K};
  int err;
  if (dtype == kF32)
    err = probe::dot_form<float>(args, form, vec, cluster, st);
  else if (dtype == kBF16)
    err = probe::dot_form<bf16>(args, form, vec, cluster, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  return (int)cudaGetLastError();
}
