// A run of B=1 AMT 2.2 decoder layers (post-norm V2 wiring) at one position
// as ONE cooperative kernel, optionally with the chord-embedding prologue
// before the first layer and the final LayerNorm + chord head after the
// last.
//
// Replaces three TPU kernels, which compute the same function and differ
// only in how the TPU addresses the weights:
//   * video2music_tpu/ops/pallas_decode_stack.py:decode_monolith_step
//     (_monolith_kernel): the whole step, weights stacked over all layers;
//   * video2music_tpu/ops/pallas_decode_stack.py:decode_segment_step
//     (_shallow_stack_kernel, _deep_stack_kernel): one run of same-kind
//     layers over a grid of layers, x (1, D) in and y (1, D) out;
//   * video2music_tpu/ops/pallas_decode_stack.py:decode_flat_monolith_step
//     (_flat_monolith_kernel) over more than one layer, per-layer operands.
// Here every layer is one entry of a pointer table passed by value in the
// kernel's argument struct (its caches included), so the three share this
// kernel. The TPU kernels' one-hot gathers, masked full-buffer cache select
// and expert DMAs are not carried over: the ids index device memory and the
// K/V row is written at pos.
//
// What bounds it on the H100: every weight of the run read once (57 MB in
// bf16 for the six 2.2 layers: 17 us at 3.35 TB/s, computed, not measured)
// plus the cache rows <= pos. A single block cannot stream that, so the
// kernel is persistent and cooperative: as many blocks as the card holds at
// once (SM count x occupancy), launched with cudaLaunchCooperativeKernel.
// At B=1 each phase moves a microsecond of bytes or less, so the time is
// the chain of dependent round trips: a wait, the input's staging, the
// weight rows, the dot, the store. The probe instance (below) measured the
// first design (a grid barrier after each of 8 phases a layer, each phase
// fetching its weight rows after its barrier, attention one block a head):
// 344 us for the six-layer run, attention 101 us of it (PERF.md).
//
// The phases of a layer and what each waits for:
//   1. QKV GEMV + RoPE, K/V written at pos; the input is the previous
//      layer's closing LayerNorm, recomputed by every block that has QKV
//      rows (after all the down GEMV's blocks arrived) and rounded to the
//      compute dtype (the per-layer kernels' rounding point); each warp
//      then arrives on its head's counter;
//   2. self-attention over rows <= pos, each head's rows split over up to
//      kMaxSplits blocks of up to kTileRows = 64 rows (flash-decoding; 32-
//      row splits, twice as many, measured slower): a block waits for its
//      head's QKV counter only, and writes (m, l, unnormalised P.V) of its
//      rows;
//   3. out-projection GEMV + residual, after the attention counter: its
//      staging merges the splits' triples into the attention output;
//   4. LN1 of r1 (after all the out-projection's blocks arrived) in each
//      block's prologue, cross-q GEMV + RoPE, per-head arrivals;
//   5. cross-attention over the Sm memory rows, split as 2.;
//   6. cross out-projection GEMV + residual, merging as 3.;
//   7. LN2 of r2 (after all of 6.'s blocks arrived), then SwiGLU's [w1|wg]
//      GEMV, or (MoE) the router in every block (first index wins a tie,
//      softmax over the selected raw logits) and the up-GEMVs of the
//      shared and selected experts;
//   8. the down GEMV (the MoE combine) + residual, after all of 7.'s
//      blocks arrived;
//   end: [head] LN3, the final LayerNorm and the Wout GEMV, or y = LN3.
// A phase that reads a whole vector (LN1, LN2, LN3, the down GEMV's
// input) waits for the blocks that write it, not for the grid: no grid
// barrier is left inside a layer (there were 8); one follows the embed and
// one ends the run. Around the waits:
//   * before each wait, every warp stages the weight rows of its unit in
//     the next phase in shared memory (Stager: lane 0 issues cp.async.bulk
//     copies on the warp's mbarrier; a row too long for the warp's slot
//     goes to L2 instead), so nothing waits for a weight row after the
//     data it multiplies arrives and no register holds a row across a
//     wait; lane 0 loads its units' biases and RoPE rows, and thread 0
//     stages the block's LayerNorm weights (its own mbarrier). The routed
//     experts' rows of the MoE down GEMV are staged before its barrier
//     (every block routed in the phase before); those of the up GEMV
//     after the router (prefetching every expert's rows of the warp's
//     unit to L2 before the barrier measured slower: chip_variants.py);
//   * an attention block copies its rows' K and V into shared memory by
//     cp.async before it waits, all but row pos, which this kernel writes
//     and which is read after the wait through L2;
//   * the arrival counters (QKV and cross-q per head; the self- and
//     cross-attention splits; the blocks of 3., 6., 7. and 8.) are
//     cumulative over the run's layers (layer i waits for all its arrivals
//     and the earlier layers'): a roped GEMV's warp arrives by its lane
//     0's red.release after that lane's stores, a block after a block
//     barrier by one thread's; a consumer's thread 0 polls with relaxed
//     loads, then one acquire fence. Every block arrives after 7. (each
//     staged r2 for its router), so no block still reads r2 when the next
//     layer writes it; every other vector is rewritten only downstream of
//     all its readers' arrivals. Block 0 zeroes the counters after the
//     run's last grid barrier, when no block reads them any more, so the
//     next launch (or CUDA-graph replay) starts from zero; the wrapper
//     allocates them zeroed. Every spin-wait relies on the cooperative
//     launch: all blocks are resident, and each block runs its parts in
//     the phase order above, so every block a wait depends on reaches its
//     arrival.
// The grid is one block of 256 threads an SM (132 on the H100), with up to
// 255 registers a thread: two blocks an SM (registers capped at 128, which
// spill) and 512-thread blocks were slower (chip_variants.py, PERF.md).
// Rounding is the per-layer kernels': f32 logits, probabilities and
// attention output (the merge rescales each split's sums by exp(m_s - M));
// every matmul input rounded to the compute dtype; the residual stream f32.
#include <cooperative_groups.h>

#include "attention_mma.cuh"
#include "decode_rows.cuh"
#include "decode_step.cuh"

namespace cg = cooperative_groups;

namespace v2m {

constexpr int kMaxLayers = 16;  // keeps the argument struct under 4 KB
constexpr int kTileRows = 64;   // cache rows of a split in shared memory
constexpr int kMaxSplits = 16;  // blocks one head's attention splits over

// One layer of the run. Field order must match StackLayerArgs in kernels.py.
struct V2MStackLayer {
  const void *wqkv, *bqkv, *wo, *bo, *cwq, *cbq, *cwo, *cbo;
  const void *norm_scale, *norm_bias;
  const void *w1g, *b1g, *w2, *b2;
  const void *gate_w, *gate_b, *ew1g, *eb1g, *ew2, *eb2;  // null: SwiGLU
  void *k_cache, *v_cache;          // (S, D), written at row pos
  const void *k_cross, *v_cross;    // (Sm, D)
};

// Field order must match StackArgs in kernels.py.
struct V2MStack {
  const void *x;   // (1, D) input when there is no embed prologue
  void *y;         // (1, D) output when there is no head
  const float *rope_cos, *rope_sin;
  float *work;     // decode_layer.py:workspace_size floats
  float *attn;     // decode_stack.py attention_floats: the splits' triples
  unsigned int *sync;  // 2 H + 6 arrival counters, zero between launches
  int *sel;        // k_top expert ids of each layer (n_layers x k_top)
  const int *token_root, *token_attr;
  const float *key;
  const void *emb_root, *emb_attr, *lc_w, *lc_krow, *lc_b;  // null: no embed
  const void *dn_scale, *dn_bias, *wout, *bout;             // null: no head
  void *logits;
  unsigned long long *probe;  // null: the main instance (see Probe)
  int D, H, F, E, k_top, S, Sm, n_out, pos, n_layers, grid, smem;
  int max_splits;  // splits of a head's attention at most
  V2MStackLayer layers[kMaxLayers];
};

// The probe instance (PROBE, launched when V2MStack.probe is set; the main
// path's instance compiles it out) stamps %globaltimer at every phase
// boundary. probe (u64): [0] block 0's start; for boundary slot s,
// [1 + 2 s] the time the last block to finish the phase finished it and
// [2 + 2 s] the time block 0 left the grid barrier after it (0: none);
// then kProbeSlots u32 arrival counters, zero at launch. Slots: phase kind
// k of layer i at k + kKinds i, the embed and the head after them.
enum Kind : int { kQkv, kSelf, kWo, kCq, kCross, kCwo, kUp, kDown, kKinds };
constexpr int kEmbedSlot = kKinds * kMaxLayers;
constexpr int kHeadSlot = kEmbedSlot + 1;
constexpr int kProbeSlots = kHeadSlot + 1;
// after the counters: kMarks stamps of block 0 and of the last block at
// points inside layer 1 (mark())
constexpr int kMarkBase = 1 + 2 * kProbeSlots + (kProbeSlots + 1) / 2;
constexpr int kMarks = 32;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// This block has finished the phase of `slot`; the last of `blocks` to
// finish stamps the time.
template <bool PROBE>
__device__ __forceinline__ void phase_done(unsigned long long* probe,
                                           int slot, int blocks) {
  if constexpr (PROBE) {
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned int* cnt =
          reinterpret_cast<unsigned int*>(probe + 1 + 2 * kProbeSlots);
      __threadfence();
      if (atomicAdd(cnt + slot, 1u) == (unsigned int)blocks - 1)
        probe[1 + 2 * slot] = global_ns();
    }
  }
}

// A grid barrier after the phase of `slot`.
template <bool PROBE>
__device__ __forceinline__ void barrier(cg::grid_group& grid,
                                        unsigned long long* probe, int slot) {
  phase_done<PROBE>(probe, slot, gridDim.x);
  grid.sync();
  if constexpr (PROBE) {
    if (blockIdx.x == 0 && threadIdx.x == 0) probe[2 + 2 * slot] = global_ns();
  }
}

// ---------------------------------------------------------------------------
// arrival counters
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned int ld_relaxed(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The whole block waits until *cnt >= target: thread 0 polls with relaxed
// loads (an acquire load would invalidate the SM's L1 at every poll), then
// one acquire fence.
__device__ __forceinline__ void wait_for(const unsigned int* cnt,
                                         unsigned int target) {
  if (threadIdx.x == 0) {
    while (ld_relaxed(cnt) < target) {
    }
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
}

// n arrivals on cnt, released at gpu scope: after a block barrier, the
// writes of every thread of the block go before them.
__device__ __forceinline__ void red_release(unsigned int* cnt,
                                            unsigned int n) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(cnt), "r"(n)
               : "memory");
}

// One arrival of the block on cnt, after every write its threads made.
__device__ __forceinline__ void arrive(unsigned int* cnt) {
  __syncthreads();
  if (threadIdx.x == 0) red_release(cnt, 1u);
}

// ---------------------------------------------------------------------------
// weight rows fetched before a wait
// ---------------------------------------------------------------------------

// A warp's weight rows staged in shared memory by the TMA engine: lane 0
// issues cp.async.bulk copies of whole rows into the warp's slot of
// kSlotBytes, completed on one of the warp's two mbarriers, before the
// wait on the data they multiply; the dots after it read shared memory.
// Nothing is held in registers across a wait. Rows that do not fit the
// slot are prefetched into L2 instead and read from device memory. Every
// fetch that stages is waited for exactly once (the parity bits follow
// the barriers' phases), on the same barrier, before the slot is reused.
constexpr int kSlotBytes = 6144;

__device__ __forceinline__ unsigned int saddr(const void* p) {
  return (unsigned int)__cvta_generic_to_shared(p);
}

struct Stager {
  unsigned long long* bar;  // this warp's two mbarriers
  unsigned char* slot;      // this warp's kSlotBytes
  unsigned int parity;      // bit b: the phase barrier b completes next
  __device__ __forceinline__ void init(int lane) {
    parity = 0;
    if (lane == 0) {
      for (int b = 0; b < 2; ++b)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                         saddr(bar + b))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
  }
  // Rows r0, r1, r2 (each null or `bytes` long) into the slot at off,
  // off + bytes, off + 2 bytes, on barrier b; false (the rows prefetched to
  // L2 by the warp instead) when they do not fit, or when there are none.
  __device__ __forceinline__ bool fetch(int b, int off, const void* r0,
                                        const void* r1, const void* r2,
                                        int bytes, int lane) {
    const int n = r2 != nullptr ? 3 : r1 != nullptr ? 2 : r0 != nullptr;
    if (n == 0) return false;
    if (off + n * bytes > kSlotBytes) {
      const void* rows[3] = {r0, r1, r2};
      for (int r = 0; r < 3; ++r)
        if (rows[r] != nullptr)
          for (int o = lane * 128; o < bytes; o += 32 * 128)
            prefetch_l2(reinterpret_cast<const char*>(rows[r]) + o);
      return false;
    }
    __syncwarp();  // every lane has read the slot's earlier rows
    if (lane == 0) {
      const unsigned int total = (unsigned int)bytes *
                                 ((r0 != nullptr) + (r1 != nullptr) +
                                  (r2 != nullptr));
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              saddr(bar + b)),
          "r"(total)
          : "memory");
      const void* rows[3] = {r0, r1, r2};
      for (int r = 0; r < 3; ++r)
        if (rows[r] != nullptr)
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
              "bytes [%0], [%1], %2, [%3];" ::"r"(saddr(slot + off +
                                                         r * bytes)),
              "l"(rows[r]), "r"(bytes), "r"(saddr(bar + b))
              : "memory");
    }
    return true;
  }
  __device__ __forceinline__ void wait(int b) {
    const unsigned int ph = (parity >> b) & 1u;
    unsigned int done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(saddr(bar + b)), "r"(ph)
          : "memory");
    parity ^= 1u << b;
  }
};

// dot(row[0:K], xs[0:K]) summed over the warp (dot_row's order), the row
// staged in shared memory or (when it did not fit) in device memory: one
// generic-load loop for both, so the kernel's code stays small.
template <typename W>
__device__ __forceinline__ float dot_any(const void* row, const float* xs,
                                         int K, int lane) {
  constexpr int V = Vec<W>::N;
  const W* w = reinterpret_cast<const W*>(row);
  float acc = 0.f;
#pragma unroll 4
  for (int k = lane * V; k < K; k += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(w + k);
    const W* e = reinterpret_cast<const W*>(&raw);
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + k + i);
      acc = fmaf(to_f<W>(e[i]), xv.x, acc);
      acc = fmaf(to_f<W>(e[i + 1]), xv.y, acc);
      acc = fmaf(to_f<W>(e[i + 2]), xv.z, acc);
      acc = fmaf(to_f<W>(e[i + 3]), xv.w, acc);
    }
  }
  return warp_sum(acc);
}

// The rows of a warp's GEMV unit (decode_step.cuh unit_rows), staged
// before the wait, with the epilogue's constants (biases, the RoPE row's
// cos and sin, Linear_chord's key row) loaded into lane 0's registers;
// early() loads the residual (a vector an earlier phase wrote) as soon as
// the wait is over, before the input is staged. run() computes the warp's
// units of the phase over the staged input, the first from the staged
// rows, any later one fetched then. The epilogue is decode_step.cuh
// unit_epilogue's arithmetic over those registers.
template <typename T, int EPI>
struct Unit {
  int unit = -1;
  bool staged = false;
  T b0, b1, kr;  // lane 0's epilogue operands, raw until used
  float c, s, res;
  __device__ __forceinline__ void fetch(Stager& st, const GemvArgs& g, int u,
                                        int lane) {
    unit = u;
    staged = false;
    if (u >= g.units) return;
    const int2 r = unit_rows<EPI>(g, u);
    const T* w = (const T*)g.w;
    staged = st.fetch(0, 0, w + (size_t)r.x * g.K,
                      EPI == kPlain ? nullptr : w + (size_t)r.y * g.K,
                      nullptr, g.K * (int)sizeof(T), lane);
    if (lane == 0) {
      const T* b = (const T*)g.bias;
      b0 = b[r.x];
      b1 = EPI == kPlain ? b0 : b[r.y];
      if (EPI == kRope && r.x < g.rope_rows) {
        const size_t f = (size_t)g.pos * (g.hd / 2) + ((r.x % g.hd) >> 1);
        c = g.cos[f];
        s = g.sin[f];
      }
      kr = EPI == kPlain && g.key != nullptr ? ((const T*)g.krow)[u] : b0;
    }
  }
  __device__ __forceinline__ void early(const GemvArgs& g, int lane) {
    if (EPI == kPlain && lane == 0 && unit < g.units &&
        g.residual != nullptr)
      res = __ldcg(g.residual + unit);
  }
  // heads (roped units): after its stores, lane 0 arrives on the counter
  // of its unit's head (unit u is the row pair (2u, 2u + 1))
  __device__ __forceinline__ void run(Stager& st, const GemvArgs& g,
                                      const float* xs, int warp, int nwarp,
                                      int lane, unsigned int* heads = nullptr) {
    for (int u = warp; u < g.units; u += nwarp) {
      if (u != unit) {
        fetch(st, g, u, lane);
        early(g, lane);
      }
      const int2 r = unit_rows<EPI>(g, u);
      const T* w = (const T*)g.w;
      if (staged) st.wait(0);
      const float d0 = dot_any<T>(
          staged ? (const void*)st.slot : w + (size_t)r.x * g.K, xs, g.K,
          lane);
      const float d1 =
          EPI == kPlain
              ? 0.f
              : dot_any<T>(staged ? (const void*)(st.slot + g.K * sizeof(T))
                                  : w + (size_t)r.y * g.K,
                           xs, g.K, lane);
      if (lane != 0) continue;
      if (EPI == kPlain) {
        float y = d0;
        if (g.key != nullptr) y += *g.key * to_f<T>(kr);
        y += to_f<T>(b0);
        if (g.residual != nullptr) y = res + y;
        if (g.out_t != nullptr) {
          ((T*)g.out_t)[u] = from_f<T>(y);
        } else {
          g.out_f[u] = g.round_out ? round_t<T>(y) : y;
        }
      } else if (EPI == kRope) {
        const int r0 = 2 * u;
        float y0 = d0 + to_f<T>(b0), y1 = d1 + to_f<T>(b1);
        if (r0 < g.rope_rows) {
          const float t0 = y0 * c - y1 * s;
          const float t1 = y1 * c + y0 * s;
          y0 = t0;
          y1 = t1;
        }
        rope_store<T>(g, r0, y0);
        rope_store<T>(g, r0 + 1, y1);
        if (heads != nullptr) red_release(heads + (r0 % g.D) / g.hd, 1u);
      } else {  // kSwiglu
        const float h = d0 + to_f<T>(b0), gg = d1 + to_f<T>(b1);
        g.out_f[u] = h * (gg * (1.f / (1.f + expf(-gg))));
      }
    }
  }
};

// A block's LayerNorm weights (the scale and bias of one or two norms, D
// values each) staged in shared memory by thread 0 before the wait, on the
// block's own mbarrier; every thread waits for them before staging.
template <typename T>
struct NormWeights {
  unsigned long long* bar;
  T* buf;  // 4 D values: g, b, g2, b2
  unsigned int parity;
  __device__ __forceinline__ void fetch(const void* g, const void* b,
                                        const void* g2, const void* b2,
                                        int D) {
    if (threadIdx.x != 0) return;
    const unsigned int bytes = D * sizeof(T);
    const void* src[4] = {g, b, g2, b2};
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            saddr(bar)),
        "r"(bytes * (g2 != nullptr ? 4 : 2))
        : "memory");
    for (int i = 0; i < 4; ++i)
      if (src[i] != nullptr)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];" ::"r"(saddr(buf + i * D)),
            "l"(src[i]), "r"(bytes), "r"(saddr(bar))
            : "memory");
  }
  // in with its norms' weights read from the staged copies
  __device__ __forceinline__ VecIn wait(VecIn in, int D) {
    unsigned int done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(saddr(bar)), "r"(parity)
          : "memory");
    parity ^= 1u;
    in.ln_g = buf;
    in.ln_b = buf + D;
    if (in.ln2_g != nullptr) {
      in.ln2_g = buf + 2 * D;
      in.ln2_b = buf + 3 * D;
    }
    return in;
  }
};

// n floats (n % 4 == 0, both ends 16-byte aligned) from device memory
// through L2 into shared memory: every thread's loads in flight before its
// first store (a store to a generic pointer would order the next load).
__device__ __forceinline__ void copy_l2(float* dst, const float* src, int n) {
  constexpr int kBatch = 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i0 = threadIdx.x; i0 < n / 4; i0 += kBatch * blockDim.x) {
    float4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n / 4) v[j] = __ldcg(s4 + i);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n / 4) d4[i] = v[j];
    }
  }
}

// Stage a GEMV's input in xs (K floats): load or gather (f32 work vectors
// through L2: another block wrote them), LayerNorm (layer_norm_warps: every
// warp sums the row itself, no block reduction), optional round + second
// LayerNorm, optional round before the f32 copy out (block 0), then round
// to T as the matmul input.
template <typename T>
__device__ __forceinline__ void stage(const VecIn& in, int K, float* xs) {
  if (in.x == nullptr) {
    const int r = *in.root, at = *in.attr;
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      xs[k] = to_f<T>(((const T*)in.emb_root)[(size_t)r * K + k]) +
              to_f<T>(((const T*)in.emb_attr)[(size_t)at * K + k]);
  } else if (in.x_is_t) {
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      xs[k] = to_f<T>(((const T*)in.x)[k]);
  } else {
    copy_l2(xs, (const float*)in.x, K);
  }
  __syncthreads();
  if (in.ln_g != nullptr)
    layer_norm_warps<T>(xs, K, (const T*)in.ln_g, (const T*)in.ln_b);
  if (in.ln2_g != nullptr) {
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      xs[k] = round_t<T>(xs[k]);
    __syncthreads();
    layer_norm_warps<T>(xs, K, (const T*)in.ln2_g, (const T*)in.ln2_b);
  }
  if (in.round_first)
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      xs[k] = round_t<T>(xs[k]);
  if (in.norm_out != nullptr && blockIdx.x == 0)
    for (int k = threadIdx.x; k < K; k += blockDim.x) in.norm_out[k] = xs[k];
  for (int k = threadIdx.x; k < K; k += blockDim.x) xs[k] = round_t<T>(xs[k]);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// split attention
// ---------------------------------------------------------------------------

// Float offsets of the dynamic shared memory: the GEMV input (or the MoE
// activations), the router's logits and selection, the attention triples
// being merged, the K / V tile, q, the tile's probabilities, the P.V
// partials and the softmax statistics.
struct Smem {
  int xs, route, trip, tile, q, p, part, stat, bars, norms, slots, total;
  __host__ __device__ static int round4(int n) { return (n + 3) / 4 * 4; }
  __host__ __device__ Smem(int D, int H, int F, int E, int k_top, int elt,
                           int threads, int max_splits) {
    const int hd = D / H;
    int n = D > F ? D : F;
    if ((k_top + 1) * F > n) n = (k_top + 1) * F;
    int o = 0;
    xs = o;    o += round4(n);
    route = o; o += round4(E + 3 * k_top);
    trip = o;  o += H * max_splits * (hd + 4);
    tile = o;  o += round4((2 * kTileRows * (hd + 16 / elt) * elt + 3) / 4);
    q = o;     o += round4(hd);
    p = o;     o += round4(kTileRows);
    part = o;  o += threads;
    stat = o;  o += 4;
    bars = o;  o += (threads / 32 * 2 + 2) * 2;  // u64 mbarriers: two a
                                                 // warp, the norms'
    norms = o; o += round4(4 * D * elt / 4);
    slots = o; o += threads / 32 * kSlotBytes / 4;
    total = o;
  }
};

// Splits of an attention over `rows` rows: one a tile of rows, at most
// max_splits (V2MStack) and (so that every split of every head has a
// block) nb / H.
__device__ __forceinline__ int n_splits(int rows, int H, int nb,
                                        int max_splits) {
  int most = nb / H;
  most = most < 1 ? 1 : most > max_splits ? max_splits : most;
  const int want = (rows + kTileRows - 1) / kTileRows;
  return want < most ? want : most;
}

// K and V of one split in shared memory: kTileRows rows of hd values, rows
// padded by 16 bytes (conflict-free 16-byte reads of a row a thread).
template <typename T>
struct Tile {
  T* k;
  T* v;
  int stride;  // T elements a row
  __device__ Tile(float* base, int hd)
      : k(reinterpret_cast<T*>(base)),
        stride(hd + 16 / (int)sizeof(T)) {
    v = k + kTileRows * stride;
  }
  // cp.async of rows [r0, r0 + n) of head h into the tile, all but row
  // `skip`; one commit group.
  __device__ __forceinline__ void issue(const T* kc, const T* vc, int D,
                                        int hd, int h, int r0, int n,
                                        int skip) {
    constexpr int V = Vec<T>::N;
    const int chunks = hd / V, per = n * chunks;
    for (int i = threadIdx.x; i < 2 * per; i += blockDim.x) {
      const int which = i / per, rem = i % per;
      const int r = rem / chunks, c = rem % chunks;
      if (r0 + r == skip) continue;
      const size_t at = (size_t)(r0 + r) * D + h * hd + c * V;
      mma::cp_async16((which ? v : k) + r * stride + c * V,
                      (which ? vc : kc) + at, true);
    }
    mma::cp_async_commit();
  }
};

// The rows [r0, r1) of one split of head h (the first tile issued before
// the wait, all but row `fresh`, which this kernel wrote and which is read
// now through L2; -1: none): softmax statistics and P.V over them, online
// across tiles. Writes the triple (o[hd] unnormalised, m, l) to dst.
// The logits are f32 dots of q (f32) with the rows, times the scale (the
// plain version's).
template <typename T, int NT>
__device__ __forceinline__ void attend_split(const float* q, const T* kc, const T* vc, int D,
                             int hd, float scale, int h, int r0, int r1,
                             int fresh, Tile<T>& tile, float* qs, float* ps,
                             float* part, float* stat, float* dst) {
  constexpr int V = Vec<T>::N;
  const int tid = threadIdx.x, lane = tid & 31;
  const int chunks = hd / V;
  // q and the fresh row: both loads in flight before either is stored
  // (hd <= NT and 2 hd / V <= NT)
  const float qv = tid < hd ? __ldcg(q + h * hd + tid) : 0.f;
  const bool fresh_first = fresh >= r0 && fresh < min(r1, r0 + kTileRows);
  uint4 fv = {};
  if (fresh_first && tid < 2 * chunks) {
    const int which = tid / chunks, c = tid % chunks;
    fv = __ldcg(reinterpret_cast<const uint4*>(
        (which ? vc : kc) + (size_t)fresh * D + h * hd + c * V));
  }
  if (tid < hd) qs[tid] = qv;
  float m_run = -INFINITY, l_run = 0.f, o_run = 0.f;
  for (int t0 = r0; t0 < r1; t0 += kTileRows) {
    const int n = min(kTileRows, r1 - t0);
    if (t0 != r0) tile.issue(kc, vc, D, hd, h, t0, n, fresh);
    if (fresh >= t0 && fresh < t0 + n) {
      if (t0 != r0 && tid < 2 * chunks) {
        const int which = tid / chunks, c = tid % chunks;
        fv = __ldcg(reinterpret_cast<const uint4*>(
            (which ? vc : kc) + (size_t)fresh * D + h * hd + c * V));
      }
      if (tid < 2 * chunks) {
        const int which = tid / chunks, c = tid % chunks;
        *reinterpret_cast<uint4*>((which ? tile.v : tile.k) +
                                  (fresh - t0) * tile.stride + c * V) = fv;
      }
    }
    mma::cp_async_wait<0>();
    __syncthreads();
    for (int r = tid; r < n; r += NT) {  // a thread a row
      const T* kr = tile.k + r * tile.stride;
      float acc = 0.f;
      for (int c = 0; c < chunks; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * V);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc = fmaf(qs[c * V + i], to_f<T>(e[i]), acc);
      }
      ps[r] = acc * scale;
    }
    __syncthreads();
    if (tid < 32) {
      float mt = -INFINITY;
      for (int r = lane; r < n; r += 32) mt = fmaxf(mt, ps[r]);
      const float m_new = fmaxf(m_run, warp_max(mt));
      float lt = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float e = expf(ps[r] - m_new);
        ps[r] = e;
        lt += e;
      }
      lt = warp_sum(lt);
      if (lane == 0) {
        const float corr = expf(m_run - m_new);
        stat[0] = m_new;
        stat[1] = corr;
        stat[2] = l_run * corr + lt;
      }
    }
    __syncthreads();
    const int groups = NT / hd;  // row groups of the P.V sums
    const int g = tid / hd, d = tid % hd;
    if (g < groups) {
      float acc = 0.f;
      for (int r = g; r < n; r += groups)
        acc = fmaf(ps[r], to_f<T>(tile.v[r * tile.stride + d]), acc);
      part[g * hd + d] = acc;
    }
    __syncthreads();
    if (tid < hd) {
      float t = 0.f;
      for (int j = 0; j < groups; ++j) t += part[j * hd + tid];
      o_run = o_run * stat[1] + t;
    }
    m_run = stat[0];
    l_run = stat[2];
    __syncthreads();  // the tile, ps and part are free again
  }
  if (tid < hd) dst[tid] = o_run;
  if (tid == 0) {
    dst[hd] = m_run;
    dst[hd + 1] = l_run;
  }
}

// The attention output of all heads from their ns splits' triples (global
// (H, ns, hd + 4) floats, through L2 into `trip`), rounded to T
// into xs: o = sum_s exp(m_s - M) o_s / sum_s exp(m_s - M) l_s; one split
// gives o_0 / l_0, the plain softmax's division of P.V by its sum.
template <typename T, int NT>
__device__ __forceinline__ void stage_merged(const float* src, int H, int hd,
                                             int ns, float* trip, float* xs) {
  const int stride = hd + 4;
  copy_l2(trip, src, H * ns * stride);
  __syncthreads();
  for (int k = threadIdx.x; k < H * hd; k += NT) {
    const float* t = trip + (k / hd) * ns * stride;
    const int d = k % hd;
    float M = -INFINITY;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, t[s * stride + hd]);
    float L = 0.f, acc = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float w = expf(t[s * stride + hd] - M);
      L = fmaf(w, t[s * stride + hd + 1], L);
      acc = fmaf(w, t[s * stride + d], acc);
    }
    xs[k] = round_t<T>(acc / L);
  }
  __syncthreads();
}

// The attention parts of one block: items j = nb - 1 - b, + nb, ... of the
// H x ns splits (the last blocks of the grid, which have the fewest GEMV
// units), split s of head h = j / ns over rows [s per, (s + 1) per).
struct Items {
  int first, step, count, ns, per, rows;
  __device__ Items(int rows_, int H, int nb, int max_splits) : rows(rows_) {
    ns = n_splits(rows, H, nb, max_splits);
    per = (rows + ns - 1) / ns;
    count = H * ns;
    first = nb - 1 - (int)blockIdx.x;
    step = nb;
  }
  __device__ int blocks() const { return count < step ? count : step; }
  __device__ int head(int j) const { return j / ns; }
  __device__ int r0(int j) const { return (j % ns) * per; }
  __device__ int r1(int j) const {
    const int e = r0(j) + per;
    return e < rows ? e : rows;
  }
};

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <typename T, int NW, bool PROBE>
__global__ void __launch_bounds__(NW * 32, 1)
    decode_stack_kernel(const V2MStack a) {
  constexpr int NT = NW * 32;
  cg::grid_group grid = cg::this_grid();
  if constexpr (PROBE) {
    if (blockIdx.x == 0 && threadIdx.x == 0) a.probe[0] = global_ns();
  }
  extern __shared__ __align__(16) float sm[];
  const int D = a.D, F = a.F, H = a.H, hd = D / H, k_top = a.k_top;
  const int lane = threadIdx.x & 31, nb = gridDim.x, b = blockIdx.x;
  const int warp = b * NW + (threadIdx.x >> 5), nwarp = nb * NW;
  const float scale = 1.f / sqrtf((float)hd);
  const Smem so(D, H, F, a.E, k_top, (int)sizeof(T), NT, a.max_splits);
  float* xs = sm + so.xs;
  float* logit = sm + so.route;
  int* sel_s = reinterpret_cast<int*>(logit + a.E);
  float* raw_s = reinterpret_cast<float*>(sel_s + k_top);
  float* selw_s = raw_s + k_top;
  Tile<T> tile(sm + so.tile, hd);
  const Work w(a.work, D, k_top);
  unsigned int* qkv_cnt = a.sync;
  unsigned int* cq_cnt = a.sync + H;
  unsigned int* self_cnt = a.sync + 2 * H;
  unsigned int* cross_cnt = self_cnt + 1;
  unsigned int* r1_cnt = self_cnt + 2;   // out-projection blocks
  unsigned int* r2_cnt = self_cnt + 3;   // cross out-projection blocks
  unsigned int* act_cnt = self_cnt + 4;  // up-GEMV blocks
  unsigned int* r3_cnt = self_cnt + 5;   // down-GEMV blocks
  float* self_trip = a.attn;
  float* cross_trip = a.attn + (size_t)H * kMaxSplits * (hd + 4);
  const Items self_items(a.pos + 1, H, nb, a.max_splits),
      cross_items(a.Sm, H, nb, a.max_splits);
  const bool embed = a.token_root != nullptr;
  Stager st;
  st.bar = reinterpret_cast<unsigned long long*>(sm + so.bars) +
           2 * (threadIdx.x >> 5);
  st.slot = reinterpret_cast<unsigned char*>(sm + so.slots) +
            (threadIdx.x >> 5) * kSlotBytes;
  st.init(lane);
  NormWeights<T> nw;
  nw.bar = reinterpret_cast<unsigned long long*>(sm + so.bars) + 2 * NW;
  nw.buf = reinterpret_cast<T*>(sm + so.norms);
  nw.parity = 0;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(nw.bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int q_blocks = min(nb, (3 * D / 2 + NW - 1) / NW);
  const int cq_blocks = min(nb, (D / 2 + NW - 1) / NW);
  const int d_blocks = min(nb, (D + NW - 1) / NW);  // D-row GEMVs
  const int up_blocks = min(nb, (F + NW - 1) / NW);  // SwiGLU's up GEMV
  unsigned int act_target = 0;  // act_cnt's arrivals up to this layer

  auto mark = [&](int i, int k) {
    if constexpr (PROBE) {
      if (threadIdx.x == 0 && i == 1 && (b == 0 || b == nb - 1))
        a.probe[kMarkBase + (b == 0 ? 0 : kMarks) + k] = global_ns();
    }
  };
  // the QKV GEMV of layer i (x0: its input, see the file comment)
  auto qkv_args = [&](int i) {
    GemvArgs g = {};
    if (i > 0) {  // x0 = round(LN3 of the previous layer)
      g.in.x = w.r3;
      g.in.ln_g = (const T*)a.layers[i - 1].norm_scale + 2 * D;
      g.in.ln_b = (const T*)a.layers[i - 1].norm_bias + 2 * D;
      g.in.round_first = 1;
      g.in.norm_out = w.x0;
    } else if (embed) {
      g.in.x = w.x0;
    } else {
      g.in.x = a.x;
      g.in.x_is_t = 1;
      g.in.norm_out = w.x0;
    }
    g.w = a.layers[i].wqkv;
    g.bias = a.layers[i].bqkv;
    g.K = D;
    g.units = 3 * D / 2;
    g.cos = a.rope_cos;
    g.sin = a.rope_sin;
    g.pos = a.pos;
    g.hd = hd;
    g.rope_rows = a.rope_cos != nullptr ? 2 * D : 0;
    g.D = D;
    g.out_f = w.q;
    g.k_cache = a.layers[i].k_cache;
    g.v_cache = a.layers[i].v_cache;
    return g;
  };
  // the head: logits = round(wout . round(LN(round(LN3(r3)))) + bout)
  auto head_args = [&]() {
    const V2MStackLayer& last = a.layers[a.n_layers - 1];
    GemvArgs g = {};
    g.in.x = w.r3;
    g.in.ln_g = (const T*)last.norm_scale + 2 * D;
    g.in.ln_b = (const T*)last.norm_bias + 2 * D;
    g.in.ln2_g = a.dn_scale;
    g.in.ln2_b = a.dn_bias;
    g.w = a.wout;
    g.bias = a.bout;
    g.K = D;
    g.units = a.wout != nullptr ? a.n_out : 0;
    g.out_t = a.logits;
    return g;
  };
  // the other GEMVs of layer i, built where they are used (a GemvArgs
  // kept across a wait would hold ~50 registers)
  auto wo_args = [&](int i) {  // 3. r1 = x0 + (wo . attn + bo)
    GemvArgs g = {};
    g.w = a.layers[i].wo;
    g.bias = a.layers[i].bo;
    g.K = D;
    g.units = D;
    g.residual = w.x0;
    g.out_f = w.r1;
    return g;
  };
  auto cq_args = [&](int i) {  // 4. x1 = LN1(r1); cq = rope(cwq . x1 + cbq)
    GemvArgs g = {};
    g.in.x = w.r1;
    g.in.ln_g = a.layers[i].norm_scale;
    g.in.ln_b = a.layers[i].norm_bias;
    g.in.norm_out = w.x1;
    g.w = a.layers[i].cwq;
    g.bias = a.layers[i].cbq;
    g.K = D;
    g.units = D / 2;
    g.cos = a.rope_cos;
    g.sin = a.rope_sin;
    g.pos = a.pos;
    g.hd = hd;
    g.rope_rows = a.rope_cos != nullptr ? D : 0;
    g.D = D;
    g.out_f = w.cq;
    return g;
  };
  auto cwo_args = [&](int i) {  // 6. r2 = x1 + (cwo . cattn + cbo)
    GemvArgs g = {};
    g.w = a.layers[i].cwo;
    g.bias = a.layers[i].cbo;
    g.K = D;
    g.units = D;
    g.residual = w.x1;
    g.out_f = w.r2;
    return g;
  };
  auto up_args = [&](int i) {  // 7. SwiGLU: act = h * silu(g) of LN2(r2)
    GemvArgs g = {};
    g.in.x = w.r2;
    g.in.ln_g = (const T*)a.layers[i].norm_scale + D;
    g.in.ln_b = (const T*)a.layers[i].norm_bias + D;
    g.in.norm_out = w.x2;
    g.w = a.layers[i].w1g;
    g.bias = a.layers[i].b1g;
    g.K = D;
    g.units = F;
    g.F = F;
    g.out_f = w.act;
    return g;
  };
  auto down_args = [&](int i) {  // 8. r3 = x2 + w2 . act + b2
    GemvArgs g = {};
    g.in.x = w.act;
    g.w = a.layers[i].w2;
    g.bias = a.layers[i].b2;
    g.K = F;
    g.units = D;
    g.residual = w.x2;
    g.out_f = w.r3;
    return g;
  };
  // the first attention item's tile: self of layer i (all rows but pos),
  // or cross of layer i
  auto issue_first = [&](int i, bool self) {
    const Items& it = self ? self_items : cross_items;
    const int j = it.first;
    if (j >= it.count) return;
    const V2MStackLayer& l = a.layers[i];
    const T* kc = (const T*)(self ? l.k_cache : l.k_cross);
    const T* vc = (const T*)(self ? l.v_cache : l.v_cross);
    const int r0 = it.r0(j), n = min(kTileRows, it.r1(j) - r0);
    if (n > 0) tile.issue(kc, vc, D, hd, it.head(j), r0, n,
                          self ? a.pos : -1);
  };
  // this block's attention items of layer i: wait for the head's producer
  // counter, attend, arrive; then issue the next tile (next item, the
  // cross attention after the self, the next layer's self after the cross)
  auto attend_items = [&](int i, bool self) {
    const Items& it = self ? self_items : cross_items;
    const V2MStackLayer& l = a.layers[i];
    const T* kc = (const T*)(self ? l.k_cache : l.k_cross);
    const T* vc = (const T*)(self ? l.v_cache : l.v_cross);
    unsigned int* producers = self ? qkv_cnt : cq_cnt;
    const unsigned int target =
        (unsigned int)(i + 1) * (self ? 3 : 1) * (hd / 2);
    for (int j = it.first; j < it.count; j += it.step) {
      const int h = it.head(j);
      if (j != it.first) {
        const int r0 = it.r0(j), n = min(kTileRows, it.r1(j) - r0);
        if (n > 0) tile.issue(kc, vc, D, hd, h, r0, n, self ? a.pos : -1);
      }
      mark(i, self ? 0 : 4);
      wait_for(producers + h, target);
      mark(i, self ? 1 : 5);
      attend_split<T, NT>(self ? w.q : w.cq, kc, vc, D, hd, scale, h,
                          it.r0(j), it.r1(j), self ? a.pos : -1, tile,
                          sm + so.q, sm + so.p, sm + so.part, sm + so.stat,
                          (self ? self_trip : cross_trip) +
                              (size_t)j * (hd + 4));
      mark(i, self ? 2 : 6);
      arrive(self ? self_cnt : cross_cnt);
      mark(i, self ? 3 : 7);
    }
    if (self) {
      issue_first(i, false);
    } else if (i + 1 < a.n_layers) {
      issue_first(i + 1, true);
    }
  };

  Unit<T, kRope> uq;
  if (embed) {  // 0. x0 = round(lc_w . round(emb) + key * lc_krow + lc_b)
    GemvArgs g = {};
    g.in.root = a.token_root;
    g.in.attr = a.token_attr;
    g.in.emb_root = a.emb_root;
    g.in.emb_attr = a.emb_attr;
    g.w = a.lc_w;
    g.bias = a.lc_b;
    g.K = D;
    g.units = D;
    g.key = a.key;
    g.krow = a.lc_krow;
    g.out_f = w.x0;
    g.round_out = 1;
    Unit<T, kPlain> ue;
    ue.fetch(st, g, warp, lane);
    if (b * NW < g.units) {
      stage<T>(g.in, D, xs);
      ue.run(st, g, xs, warp, nwarp, lane);
    }
    uq.fetch(st, qkv_args(0), warp, lane);
    issue_first(0, true);
    barrier<PROBE>(grid, a.probe, kEmbedSlot);
  } else {
    uq.fetch(st, qkv_args(0), warp, lane);
    issue_first(0, true);
  }
  Unit<T, kPlain> uhead;
  for (int i = 0; i < a.n_layers; ++i) {
    const V2MStackLayer& l = a.layers[i];
    const T* norm_g = (const T*)l.norm_scale;
    const T* norm_b = (const T*)l.norm_bias;
    const int slot = kKinds * i;
    const bool deep = l.gate_w != nullptr;
    if (b < q_blocks) {  // 1. qkv + RoPE + cache append at pos
      mark(i, 0);
      if (i > 0) wait_for(r3_cnt, (unsigned int)i * d_blocks);
      const GemvArgs g = qkv_args(i);
      stage<T>(i > 0 ? nw.wait(g.in, D) : g.in, D, xs);
      mark(i, 1);
      uq.run(st, g, xs, warp, nwarp, lane, qkv_cnt);
      mark(i, 2);
      phase_done<PROBE>(a.probe, slot + kQkv, q_blocks);
    }
    Unit<T, kPlain> uwo;
    uwo.fetch(st, wo_args(i), warp, lane);
    // 2. self-attention over rows <= pos (this kernel wrote row pos)
    attend_items(i, true);
    if (self_items.first < self_items.count)
      phase_done<PROBE>(a.probe, slot + kSelf, self_items.blocks());
    if (b * NW < D) {
      mark(i, 4);
      wait_for(self_cnt, (unsigned int)(i + 1) * self_items.count);
      mark(i, 5);
      uwo.early(wo_args(i), lane);
      stage_merged<T, NT>(self_trip, H, hd, self_items.ns, sm + so.trip, xs);
      mark(i, 6);
      uwo.run(st, wo_args(i), xs, warp, nwarp, lane);
      mark(i, 7);
      arrive(r1_cnt);
      phase_done<PROBE>(a.probe, slot + kWo, d_blocks);
    }
    Unit<T, kRope> ucq;
    ucq.fetch(st, cq_args(i), warp, lane);
    if (b < cq_blocks) nw.fetch(norm_g, norm_b, nullptr, nullptr, D);
    mark(i, 8);
    {
      if (b < cq_blocks) {  // LN1 reads the whole r1
        wait_for(r1_cnt, (unsigned int)(i + 1) * d_blocks);
        mark(i, 9);
        const GemvArgs g = cq_args(i);
        stage<T>(nw.wait(g.in, D), D, xs);
        mark(i, 10);
        ucq.run(st, g, xs, warp, nwarp, lane, cq_cnt);
        mark(i, 11);
        phase_done<PROBE>(a.probe, slot + kCq, cq_blocks);
      }
    }
    Unit<T, kPlain> ucwo;
    ucwo.fetch(st, cwo_args(i), warp, lane);
    // 5. cross-attention over the primed memory (read-only here)
    attend_items(i, false);
    if (cross_items.first < cross_items.count)
      phase_done<PROBE>(a.probe, slot + kCross, cross_items.blocks());
    if (b * NW < D) {
      wait_for(cross_cnt, (unsigned int)(i + 1) * cross_items.count);
      mark(i, 13);
      ucwo.early(cwo_args(i), lane);
      stage_merged<T, NT>(cross_trip, H, hd, cross_items.ns, sm + so.trip,
                          xs);
      mark(i, 14);
      ucwo.run(st, cwo_args(i), xs, warp, nwarp, lane);
      mark(i, 15);
      arrive(r2_cnt);
      phase_done<PROBE>(a.probe, slot + kCwo, d_blocks);
    }
    // 7. x2 = LN2(r2), then the FFN's up GEMV
    if (deep || b * NW < F)
      nw.fetch(norm_g + D, norm_b + D, nullptr, nullptr, D);
    if (!deep) {
      Unit<T, kSwiglu> uup;
      uup.fetch(st, up_args(i), warp, lane);
      if (b * NW < F) {  // LN2 reads the whole r2
        wait_for(r2_cnt, (unsigned int)(i + 1) * d_blocks);
        const GemvArgs g = up_args(i);
        stage<T>(nw.wait(g.in, D), D, xs);
        uup.run(st, g, xs, warp, nwarp, lane);
        arrive(act_cnt);
        phase_done<PROBE>(a.probe, slot + kUp, up_blocks);
      }
      act_target += up_blocks;
      Unit<T, kPlain> udown;
      udown.fetch(st, down_args(i), warp, lane);
      if (b * NW < D) {  // the down GEMV reads the whole activation
        wait_for(act_cnt, act_target);
        const GemvArgs g = down_args(i);
        udown.early(g, lane);
        stage<T>(g.in, F, xs);
        udown.run(st, g, xs, warp, nwarp, lane);
        arrive(r3_cnt);
        phase_done<PROBE>(a.probe, slot + kDown, d_blocks);
      }
    } else {
      const int E = a.E, slots = k_top + 1;
      const T* gate_w = (const T*)l.gate_w;
      const T* gate_b = (const T*)l.gate_b;
      const T* sw1g = (const T*)l.w1g;
      const T* sb1g = (const T*)l.b1g;
      const T* ew1g = (const T*)l.ew1g;
      const T* eb1g = (const T*)l.eb1g;
      // before the barrier: the shared expert's rows of this warp's unit
      // and the gate row of this warp, staged
      const int wl = threadIdx.x >> 5, rb = D * (int)sizeof(T);
      const bool up_staged = st.fetch(
          0, 0, warp < F ? sw1g + (size_t)warp * D : nullptr,
          warp < F ? sw1g + (size_t)(F + warp) * D : nullptr,
          wl < E ? gate_w + (size_t)wl * D : nullptr, rb, lane);
      if (warp < F && lane == 0) {
        prefetch_l2(sb1g + warp);
        prefetch_l2(sb1g + F + warp);
      }
      for (int e = wl + NW; e < E; e += NW)
        prefetch_row<T>(gate_w + (size_t)e * D, D, lane);
      prefetch_bytes(gate_b, E * (int)sizeof(T));
      mark(i, 16);
      wait_for(r2_cnt, (unsigned int)(i + 1) * d_blocks);  // LN2: all of r2
      mark(i, 17);
      stage<T>(nw.wait(up_args(i).in, D), D, xs);
      mark(i, 18);
      if (up_staged) st.wait(0);
      // the router, in every block: E logits, the rank top-k (first index
      // wins a tie), softmax over the selected raw logits from the first
      for (int e = wl; e < E; e += NW) {
        const float d = dot_any<T>(
            e == wl && up_staged ? (const void*)(st.slot + 2 * rb)
                                 : gate_w + (size_t)e * D,
            xs, D, lane);
        if (lane == 0) logit[e] = d + to_f<T>(gate_b[e]);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < E; e += NT) {
        const int rank = expert_rank(logit, E, e);
        if (rank < k_top) {
          sel_s[rank] = e;
          raw_s[rank] = logit[e];
        }
      }
      __syncthreads();
      for (int j = threadIdx.x; j < k_top; j += NT) {
        const float v0 = raw_s[0];
        float den = 0.f;
        for (int t = 0; t < k_top; ++t) den += expf(raw_s[t] - v0);
        selw_s[j] = expf(raw_s[j] - v0) / den;
      }
      __syncthreads();
      if (b == 0)
        for (int j = threadIdx.x; j < k_top; j += NT)
          a.sel[i * k_top + j] = sel_s[j];
      mark(i, 19);
      // a warp's units: shared u < F and routed F <= u < slots F; the
      // routed rows are staged first (barrier 1, after the shared rows and
      // the gate row), the shared dot runs meanwhile
      auto swiglu = [](float h, float g) {
        return h * (g * (1.f / (1.f + expf(-g))));
      };
      for (int m = 0;; ++m) {
        const int us = warp + m * nwarp, ur = F + warp + m * nwarp;
        if (us >= F && ur >= slots * F) break;
        const int j = ur % F;
        const int e = ur < slots * F ? sel_s[ur / F - 1] : 0;
        const T* erow = ew1g + (size_t)e * 2 * F * D;
        const bool routed_staged =
            ur < slots * F &&
            st.fetch(1, 3 * rb, erow + (size_t)j * D,
                     erow + (size_t)(F + j) * D, nullptr, rb, lane);
        if (us < F) {
          const bool mine = m == 0 && up_staged;
          const float h =
              dot_any<T>(mine ? (const void*)st.slot : sw1g + (size_t)us * D,
                         xs, D, lane) +
              to_f<T>(sb1g[us]);
          const float g =
              dot_any<T>(mine ? (const void*)(st.slot + rb)
                              : sw1g + (size_t)(F + us) * D,
                         xs, D, lane) +
              to_f<T>(sb1g[F + us]);
          if (lane == 0) w.act[us] = swiglu(h, g);
        }
        if (ur < slots * F) {
          if (routed_staged) st.wait(1);
          const T* bias = eb1g + (size_t)e * 2 * F;
          const float h =
              dot_any<T>(routed_staged ? (const void*)(st.slot + 3 * rb)
                                       : erow + (size_t)j * D,
                         xs, D, lane) +
              to_f<T>(bias[j]);
          const float g =
              dot_any<T>(routed_staged ? (const void*)(st.slot + 4 * rb)
                                       : erow + (size_t)(F + j) * D,
                         xs, D, lane) +
              to_f<T>(bias[F + j]);
          if (lane == 0) w.act[ur] = swiglu(h, g);
        }
      }
      mark(i, 20);
      // before the barrier: this warp's down rows, the shared expert's and
      // the selected experts' (staged for k_top <= 2, else to L2)
      const T* sw2 = (const T*)l.w2;
      const T* sb2 = (const T*)l.b2;
      const T* ew2 = (const T*)l.ew2;
      const T* eb2 = (const T*)l.eb2;
      const int fb = F * (int)sizeof(T);
      auto expert_row = [&](int j, int n) {
        return ew2 + ((size_t)sel_s[j] * D + n) * F;
      };
      bool down_staged = false;
      if (warp < D) {
        const int n = warp;
        if (k_top <= 2) {
          down_staged = st.fetch(0, 0, sw2 + (size_t)n * F,
                                 expert_row(0, n),
                                 k_top > 1 ? expert_row(1, n) : nullptr, fb,
                                 lane);
        } else {
          prefetch_row<T>(sw2 + (size_t)n * F, F, lane);
          for (int j = 0; j < k_top; ++j)
            prefetch_row<T>(expert_row(j, n), F, lane);
        }
        if (lane == 0)
          for (int j = 2; j < k_top; ++j)
            prefetch_l2(eb2 + (size_t)sel_s[j] * D + n);
      }
      // lane 0's epilogue operands: the biases of the shared expert and
      // the first two selected ones, then (after the barrier) x2
      T bsh, be0, be1;  // raw until used: no wait on them here
      float x2n = 0.f;
      if (warp < D && lane == 0) {
        bsh = sb2[warp];
        be0 = eb2[(size_t)sel_s[0] * D + warp];
        be1 = k_top > 1 ? eb2[(size_t)sel_s[1] * D + warp] : be0;
      }
      mark(i, 21);
      arrive(act_cnt);  // every block: every block read r2 for its router
      phase_done<PROBE>(a.probe, slot + kUp, nb);
      act_target += nb;
      // 8. r3 = x2 + (shared / k + sum_j selw_j expert_j, in that order)
      // over the activations rounded to T
      if (b * NW < D) {
        wait_for(act_cnt, act_target);  // the whole activation
        mark(i, 22);
        if (warp < D && lane == 0) x2n = __ldcg(w.x2 + warp);
        copy_l2(xs, w.act, slots * F);
        __syncthreads();
        for (int t = threadIdx.x; t < slots * F; t += NT)
          xs[t] = round_t<T>(xs[t]);
        __syncthreads();
        mark(i, 23);
        for (int n = warp; n < D; n += nwarp) {
          const bool first = n == warp, mine = first && down_staged;
          if (mine) st.wait(0);
          const float shared =
              dot_any<T>(mine ? (const void*)st.slot : sw2 + (size_t)n * F,
                         xs, F, lane) +
              to_f<T>(first ? bsh : sb2[n]);
          float h = shared / (float)k_top;
          for (int j = 0; j < k_top; ++j) {
            const float* as = xs + (size_t)(j + 1) * F;
            const float d = dot_any<T>(
                mine ? (const void*)(st.slot + (j + 1) * fb)
                     : expert_row(j, n),
                as, F, lane);
            const float bj = to_f<T>(first && j == 0   ? be0
                                     : first && j == 1 ? be1
                                         : eb2[(size_t)sel_s[j] * D + n]);
            h += selw_s[j] * (d + bj);
          }
          if (lane == 0) w.r3[n] = (first ? x2n : __ldcg(w.x2 + n)) + h;
        }
        mark(i, 24);
        arrive(r3_cnt);
        phase_done<PROBE>(a.probe, slot + kDown, d_blocks);
      }
    }
    // before the barrier: the next layer's QKV rows, or the head's
    if (i + 1 < a.n_layers) {
      uq.fetch(st, qkv_args(i + 1), warp, lane);
      if (b < q_blocks)
        nw.fetch(norm_g + 2 * D, norm_b + 2 * D, nullptr, nullptr, D);
    } else {
      uhead.fetch(st, head_args(), warp, lane);
      if (a.wout != nullptr ? b * NW < a.n_out : b == 0)
        nw.fetch(norm_g + 2 * D, norm_b + 2 * D, a.dn_scale, a.dn_bias, D);
    }
    mark(i, 25);
  }
  const unsigned int r3_all = (unsigned int)a.n_layers * d_blocks;
  const GemvArgs g = head_args();
  if (a.wout != nullptr) {
    if (b * NW < g.units) {  // LN3 reads the whole r3
      wait_for(r3_cnt, r3_all);
      stage<T>(nw.wait(g.in, D), D, xs);
      uhead.run(st, g, xs, warp, nwarp, lane);
    }
  } else if (b == 0) {  // y = round(LN3(r3)) of the last layer
    wait_for(r3_cnt, r3_all);
    VecIn ln3 = g.in;
    ln3.ln2_g = nullptr;
    stage<T>(nw.wait(ln3, D), D, xs);
    for (int t = threadIdx.x; t < D; t += NT) ((T*)a.y)[t] = from_f<T>(xs[t]);
  }
  phase_done<PROBE>(a.probe, kHeadSlot, nb);
  // every block is past its last wait: block 0 zeroes the counters for
  // the next launch
  grid.sync();
  if (b == 0)
    for (int t = threadIdx.x; t < 2 * H + 6; t += NT) a.sync[t] = 0;
}

// The blocks of one instance the card holds at once (per SM x SMs).
static int resident_blocks(const void* fn, int threads, int smem,
                           int* blocks) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = sms * per_sm;
  return 0;
}

// The grid both instances (main and probe) can hold at once.
template <typename T, int NW>
static int stack_blocks(int smem, int* blocks) {
  int main_blocks = 0, probe_blocks = 0, err;
  if ((err = resident_blocks((const void*)decode_stack_kernel<T, NW, false>,
                             NW * 32, smem, &main_blocks)))
    return err;
  if ((err = resident_blocks((const void*)decode_stack_kernel<T, NW, true>,
                             NW * 32, smem, &probe_blocks)))
    return err;
  *blocks = main_blocks < probe_blocks ? main_blocks : probe_blocks;
  return *blocks > 0 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

template <typename T, int NW>
static int launch_stack(const V2MStack& a, cudaStream_t st) {
  void* args[] = {(void*)&a};
  const void* fn = a.probe != nullptr
                       ? (const void*)decode_stack_kernel<T, NW, true>
                       : (const void*)decode_stack_kernel<T, NW, false>;
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(a.grid), dim3(NW * 32), args, (size_t)a.smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

constexpr int kStackWarps = 8;  // 256 threads, one block an SM

}  // namespace v2m

// Shared memory (bytes) and the number of blocks the card holds at once
// for a run of this shape: the wrapper calls it once per run and keeps both
// in the argument struct.
extern "C" int v2m_decode_stack_grid(int dtype, int D, int H, int F,
                                     int E, int k_top, int max_splits,
                                     int* smem, int* blocks) {
  using namespace v2m;
  const int elt = dtype == kF32 ? 4 : 2;
  *smem = Smem(D, H, F, E, k_top, elt, kStackWarps * 32, max_splits).total *
          (int)sizeof(float);
  if (dtype == kF32) return stack_blocks<float, kStackWarps>(*smem, blocks);
  if (dtype == kBF16) return stack_blocks<bf16, kStackWarps>(*smem, blocks);
  return (int)cudaErrorInvalidValue;
}

// Launches the run on `stream` (see the file comment). Returns a cudaError_t
// code (a refused cooperative launch included); never synchronises.
extern "C" int v2m_decode_stack(int dtype, const v2m::V2MStack* args,
                                void* stream) {
  using namespace v2m;
  cudaStream_t st = (cudaStream_t)stream;
  if (args->n_layers < 1 || args->n_layers > kMaxLayers ||
      args->k_top < 1 || (args->E > 0 && args->k_top > args->E) ||
      args->max_splits < 1 || args->max_splits > kMaxSplits ||
      args->D % args->H != 0 || args->D / args->H > kStackWarps * 32)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32) return launch_stack<float, kStackWarps>(*args, st);
  if (dtype == kBF16) return launch_stack<bf16, kStackWarps>(*args, st);
  return (int)cudaErrorInvalidValue;
}
