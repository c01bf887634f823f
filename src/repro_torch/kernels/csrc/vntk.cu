// Vectorized Node Transition Kernel (paper Alg. 2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/vntk.py; each kernel
// is templated on FUSED (log-softmax inside), STACKED (a multi-tenant store)
// and Edge (int2 pairs, or the int16_t / int32_t deltas of a compressed
// slab):
//   * vntk_topk_kernel<FUSED, false, int2> <- vntk_topk_pallas
//       (fused_logsoftmax=False/True; _vntk_topk_call, _vntk_topk_body,
//       _dma_front, _project_and_select)
//   * vntk_mask_kernel<FUSED, false, int2> <- vntk_pallas /
//       vntk_fused_logsoftmax_pallas (_vntk_call, _vntk_body,
//       _project_and_write)
//   * vntk_topk_kernel<FUSED, true, int2>  <- vntk_stacked_topk_pallas (both
//       modes; _vntk_topk_call's stacked branch, _vntk_stacked_topk_body)
//   * vntk_mask_kernel<FUSED, true, int2>  <- vntk_stacked_pallas /
//       vntk_stacked_fused_logsoftmax_pallas (_vntk_stacked_call,
//       _vntk_stacked_body)
//   * with a delta Edge, each fused or not, all through
//     _vntk_compressed_call and _decode_delta_slots:
//       vntk_topk_kernel<FUSED, false, delta> <- vntk_compressed_topk_pallas
//       vntk_mask_kernel<FUSED, false, delta> <- vntk_compressed_pallas
//       vntk_topk_kernel<FUSED, true, delta>  <- vntk_stacked_compressed_topk_pallas
//       vntk_mask_kernel<FUSED, true, delta>  <- vntk_stacked_compressed_pallas
// (each vntk_topk_kernel above stands for both topk routes, the
// vntk_topk_warp_kernel of the same template arguments included).
//
// STACKED reads a multi-tenant ConstraintStore: row_pointers (K, S+1) and
// edges (K, E, 2), row r through member k = cids[r].  That is one extra
// gather level: the member's base pointers are row_pointers + k * rp_stride
// and edges + k * edge_stride, computed in int64 (a store of several
// 20M-SID members lies past 2^31 int32 elements, where an int product
// wraps silently).  k is clamped into [0, K), as the reference's gather
// clamps it, so no id reads outside the store; the host rejects
// out-of-range ids before a retrieve.  Within a member every index is the
// single-matrix kernel's.
//
// The edge source (template parameter Edge) is either the raw (token, next)
// int2 pairs or a delta-compressed slab (DESIGN.md §11): int16_t or int32_t
// token deltas, the row start holding the absolute token, and next states
// row_start + slot + base, base the member's next-state base of this level
// (bases[k * base_stride]).  The kernels decode only the row's n_real slots:
// a block-wide inclusive prefix sum of the int32-cast deltas (warp shuffles,
// block_scan) over chunks of one slot a thread with a running carry, or for
// rows of <= 32 slots one warp's scan (warp_scan).  The topk block kernel
// decodes a run of consecutive slots a warp, a warp scan a chunk of 32,
// after one barrier that gives each run the sum of the runs before it, so
// each run re-walks its tokens with no barrier; the mask kernel scatters
// each chunk as it is decoded, so a root row of any width needs no extra
// shared memory.  The reference decodes the whole burst
// and masks what lies past the row end; slots past n_child are not read here
// at all, with the same outputs.  A member's delta row starts k *
// edge_stride elements in, computed in int64 (ten 20M-SID members hold about
// 1.1e9 int16 deltas, 2.2 GB).
//
// What bounds it on this card.  Per beam row the step reads its constraint
// id (STACKED), one CSR row pointer pair, at most n_child (token, next)
// pairs (or 2-byte deltas) and, when FUSED, the whole (V,) f32 logit row; it
// writes (C,) scores/tokens/next states (topk) or the (V,) masked row and
// (V,) next-state map (mask).  At the main paths' shapes (nb = 140 single or
// 350 stacked, V = 2048, C = 72) that is at most ~2.9 MB of logits read when
// fused and 350 * 72 * 12 B = 302 KB written by topk: about a microsecond
// at 3.35 TB/s.  The mask writes 8 bytes a column, 2.3 MB at nb = 140:
// 0.7 us.  What bounds both steps is latency: a launch, then a chain of
// dependent loads (node, member, row pointers, slot, log-prob).
//
// What the design does about it.  The TPU kernel's compare-broadcast
// projection, beam tiling and DMA semaphores worked around the TPU's
// missing VMEM scatter (DESIGN.md §3.3); here the row is a plain gather of
// the valid slots' log-probs and the mask variant scatters them (the
// paper's form).  The topk launcher picks one of two routes by bmax:
//   * bmax <= 32 (every sparse level of the main paths): a warp per beam
//     row (vntk_topk_warp_kernel), lane j on slot j, a block per warp (four
//     rows a block made the fused rows slower: their row reads then shared
//     an SM), no shared memory and no barrier.  The fused row's loads are
//     issued while the chase waits, the log-sum-exp is one pass, and the
//     top-C selection is in closed form (ballots and shuffles, no
//     O((bmax + C)^2) rank).  Bounded by the chain of dependent loads and
//     the launch.
//   * bmax > 32 (a root row, levels 0-1 of a dense_d=0 store, any level
//     with one wide node): a block per beam row (vntk_topk_kernel; 256
//     threads, 1024 past 8192 slots), O(n_real) work: the padding and
//     missing candidates take closed-form ranks, and only the real slots
//     are selected, by a radix select over order-preserving unsigned keys
//     (8 bits a pass, one barrier each, stopping as soon as the threshold's
//     bin holds exactly the slots still needed), then the <= C winners are
//     ranked among themselves.  The keys are staged in shared memory at 4
//     bytes a slot while they fit (~56k slots beside the kernel's static
//     arrays); wider rows re-read them from the CSR row and the logit row
//     (both in L2) in each pass, so no row width is refused.  Where both
//     work, staging is the faster (vntk_topk_reread forces re-reading, to
//     check and time that path at any width).  The fused
//     row's log-sum-exp is one pass (block_row_lse).  Bounded by the chase,
//     the passes' barriers and, on wide rows, the re-reads.
// Both keep the same order: key descending, then candidate index, which is
// the dense path's flat-index order (slots are token-ascending), on which
// bit-identity rests (DESIGN.md §8).  Only slots below n_child are read, so
// a burst never leaves the row; the builder's tail pad still bounds the
// speculative width bmax.
//
// The mask kernel is a block of 128 per row on both routes, with one
// barrier: warp 0 runs the chase while warps 1-3 write the vocab-wide fill
// with 16-byte stores and, when FUSED, fold the row's 16-byte loads into a
// one-pass log-sum-exp.  For bmax <= 32 (every sparse level of the main
// paths) warp 0 holds the slots in its lanes and scatters them after the
// barrier: no block scan, no shared staging.  Wider rows scatter chunk by
// chunk after the barrier.  The fold is the same code on both routes and
// for every Edge, so a compressed function stays bit-equal to its twin.
//
// The launchers return cudaGetLastError() of the launch; the caller raises
// on a non-zero value.  They launch on the caller's stream and allocate
// nothing.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarpBmax = 32;  // rows of at most this many slots: one warp
constexpr int kLseBatch = 16;  // float4 loads in flight per lane, warp route
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1.0e10f;  // NEG_INF of core/vntk.py
constexpr float kMinF = -FLT_MAX;    // jnp.finfo(float32).min

// Block-wide inclusive prefix sum of one int per thread, in thread order:
// a shuffle scan in each warp, then one over the warps' totals.  `total`
// receives the block's sum.  Every thread of the block (of THREADS) must
// call it.
template <int THREADS>
__device__ __forceinline__ int block_scan(int v, int* part, int& total) {
  constexpr int kBlockWarps = THREADS / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kBlockWarps ? part[lane] : 0;
    for (int o = 1; o < kBlockWarps; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    if (lane < kBlockWarps) part[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += part[warp - 1];
  total = part[kBlockWarps - 1];
  __syncthreads();  // part is reused by the next chunk
  return v;
}

// A delta slab's token deltas, or the raw (token, next) pairs.
template <typename Edge>
constexpr bool kDelta = !std::is_same<Edge, int2>::value;

// The constraint tables a launch reads.  Strides count elements of one
// member (row pointers, edges of type Edge, bases); cids, the strides and
// K are read only when STACKED, bases only by a delta source.
struct Tables {
  const int* cids;
  int K;
  const int* row_pointers;
  int64_t rp_stride;
  const void* edges;
  int64_t edge_stride;
  const int* bases;
  int64_t base_stride;
};

// The CSR tables of row `row`'s constraint set: the store's member
// k = clamp(cids[row], 0, K-1) when STACKED, else the single matrix; with a
// delta source also the member's next-state base.
template <bool STACKED, typename Edge>
struct Member {
  const int* rp;
  const Edge* edges;
  int base = 0;

  __device__ __forceinline__ Member(const Tables& t, int row)
      : rp(t.row_pointers), edges(static_cast<const Edge*>(t.edges)) {
    int64_t k = 0;
    if constexpr (STACKED) {
      k = min(max(t.cids[row], 0), t.K - 1);
      rp += k * t.rp_stride;
      edges += k * t.edge_stride;
    }
    if constexpr (kDelta<Edge>) base = t.bases[k * t.base_stride];
  }
};

// Decodes the delta slots [0, n_real) of the row starting at `start`, chunk
// by chunk, and calls slot(j, token, next) for each.  Every thread of the
// block (of THREADS) must call it (n_real is the same for all of them).
template <int THREADS, bool STACKED, typename Edge, typename Slot>
__device__ __forceinline__ void for_each_delta_slot(
    const Member<STACKED, Edge>& mem, int start, int n_real, int* part,
    Slot slot) {
  int carry = 0;  // the tokens' prefix sum over the chunks before
  for (int c0 = 0; c0 < n_real; c0 += THREADS) {
    const int j = c0 + threadIdx.x;
    const int d = j < n_real ? static_cast<int>(mem.edges[start + j]) : 0;
    int total;
    const int tok = carry + block_scan<THREADS>(d, part, total);
    if (j < n_real) slot(j, tok, start + j + mem.base);
    carry += total;
  }
}

// Warp-wide inclusive prefix sum of one int per lane, in lane order.
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// The largest of v over the warp, on every lane: the floats mapped to
// unsigned ints of the same order, reduced by one redux.
__device__ __forceinline__ float warp_max(float v) {
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  u = __reduce_max_sync(kFull, u);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// exp(d) for d <= 0 (an element less the running max) on the exp2 unit.
__device__ __forceinline__ float exp_le0(float d) {
  return exp2f(d * kLog2e);
}

// A row's (max m, log of the sum of exp(x - m)) in one pass over memory by
// one warp.  The constructor issues the first kLseBatch 16-byte loads of
// each lane (lane l takes float4s l, l+32, ...: a 2048-wide row at once)
// and returns, so the chase's loads go on.  finish() folds the row into an
// online pair per lane, batch by batch: m rises to the batch's max over the
// lane's elements (s scaled by exp(m_old - m_new)), then the lane adds the
// batch's exp(x - m), 64 independent terms summed as a tree.  No lane waits
// on another until the end, where the pairs meet: the row's max by one
// redux, each s scaled to it, one butterfly sum.  A row that is not 16-byte
// aligned, or V % 4 != 0, is read by scalar loads into the same pairs.
// Without FUSED it loads nothing and is not used.
template <bool FUSED>
struct WarpRowLse {
  const float* x;
  int V;
  bool vec = false;
  float4 v[kLseBatch];

  __device__ __forceinline__ WarpRowLse(const float* row, int V_)
      : x(row), V(V_) {
    if (!FUSED) return;
    vec = (V & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    if (vec) load(0);
  }

  // float4s b + lane + 32 u of the row, -inf past its end
  __device__ __forceinline__ void load(int b) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int n4 = V >> 2, lane = threadIdx.x & 31;
#pragma unroll
    for (int u = 0; u < kLseBatch; ++u) {
      const int k = b + lane + 32 * u;
      v[u] = k < n4 ? __ldg(x4 + k)
                    : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
  }

  // (m, log s) of the row; (0, 0) without FUSED
  __device__ __forceinline__ float2 finish() {
    if (!FUSED) return make_float2(0.f, 0.f);
    // this lane's pair; m starts at -FLT_MAX, so -inf adds 0, never NaN
    float m = kMinF, s = 0.f;
    if (vec) {
      for (int b = 0;;) {  // b is the same on every lane
        float r[kLseBatch];
#pragma unroll
        for (int u = 0; u < kLseBatch; ++u)
          r[u] = fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w));
#pragma unroll
        for (int w = kLseBatch / 2; w > 0; w >>= 1)
#pragma unroll
          for (int u = 0; u < w; ++u) r[u] = fmaxf(r[u], r[u + w]);
        if (r[0] > m) {
          s *= exp_le0(m - r[0]);
          m = r[0];
        }
#pragma unroll
        for (int u = 0; u < kLseBatch; ++u)
          r[u] = (exp_le0(v[u].x - m) + exp_le0(v[u].y - m)) +
                 (exp_le0(v[u].z - m) + exp_le0(v[u].w - m));
#pragma unroll
        for (int w = kLseBatch / 2; w > 0; w >>= 1)
#pragma unroll
          for (int u = 0; u < w; ++u) r[u] += r[u + w];
        s += r[0];
        b += 32 * kLseBatch;
        if (b >= (V >> 2)) break;
        load(b);
      }
    } else {
      for (int i = threadIdx.x & 31; i < V; i += 32) {
        const float xi = __ldg(x + i);
        if (xi > m) {
          s = s * exp_le0(m - xi) + 1.f;
          m = xi;
        } else {
          s += exp_le0(xi - m);
        }
      }
    }
    const float mr = warp_max(m);
    return make_float2(mr, logf(warp_sum(s * exp_le0(m - mr))));
  }
};

// A warp per beam row, alone in its block, for rows of bmax <= kWarpBmax
// slots: lane j holds slot j.  The same function as
// vntk_topk_kernel, with no shared memory and no barrier:
//   1. the pointer chase: nodes[row] and the member (cids[row], its base)
//      first, then the row's pointer pair, then lane j's slot (an int2 pair,
//      or a delta decoded by a warp scan), then its log-prob's logit;
//   2. when FUSED, the row's log-sum-exp in one pass (WarpRowLse), its
//      first batch's loads issued while the chase waits on its own, folded
//      after the last link;
//   3. the selection in closed form.  The i-th missing token is i + cnt(i),
//      cnt(i) = |{j < n_real : tok_j - j <= i}|; the in-range ones (key
//      NEG_INF) are a prefix of i, the rest are -FLT_MAX.  Slot j's rank
//      counts the slots before it in (key desc, index asc) order (a shuffle
//      per real slot; the padding slots at -FLT_MAX in closed form) and the
//      missing candidates with a greater key (they all have greater
//      indices).  Missing candidate i's rank counts the slots with a key >=
//      its own (one of two ballots) and the i missing ones before it.  Ranks
//      are a permutation of [0, bmax + width): each output is written once.
template <bool FUSED, bool STACKED, typename Edge>
__global__ void __launch_bounds__(32) vntk_topk_warp_kernel(
    const float* __restrict__ values, int64_t ld, const int* __restrict__ nodes,
    Tables t, int V, int bmax, int width, float* __restrict__ out_sc,
    int* __restrict__ out_tok, int* __restrict__ out_next) {
  const int lane = threadIdx.x;
  const int row = blockIdx.x;

  // 1. the chase's head, then (FUSED) the row's loads, then the chase
  const int node = nodes[row];
  const Member<STACKED, Edge> mem(t, row);
  const float* x = values + row * ld;
  WarpRowLse<FUSED> row_lse(x, V);
  const int start = mem.rp[node];
  const int n_real = max(0, min(mem.rp[node + 1] - start, bmax));
  const bool real = lane < n_real;
  const Edge e = real ? mem.edges[start + lane] : Edge{};
  int tok, nx;
  if constexpr (kDelta<Edge>) {
    tok = warp_scan(static_cast<int>(e));
    nx = start + lane + mem.base;
  } else {
    tok = e.x;
    nx = e.y;
  }
  const float xv = real ? x[min(max(tok, 0), V - 1)] : 0.f;
  // 2. the log-prob of the slot
  const float2 lse = row_lse.finish();
  float key = kMinF;
  if (real) key = FUSED ? (xv - lse.x) - lse.y : xv;
  if (!real) tok = nx = 0;

  // 3. the selection
  float* sc = out_sc + static_cast<int64_t>(row) * width;
  int* tk = out_tok + static_cast<int64_t>(row) * width;
  int* nxo = out_next + static_cast<int64_t>(row) * width;
  const bool cand = lane < bmax;
  const int c_neg = __popc(__ballot_sync(kFull, cand && key >= kNegInf));
  const int c_min = __popc(__ballot_sync(kFull, cand && key >= kMinF));
  const int g = real ? tok - lane : INT_MAX;  // missing tokens below tok
  int n_in = 0;  // in-range missing tokens among the first `width`
  for (int i0 = 0; i0 < width; i0 += 32) {
    const int i = i0 + lane;
    int cnt = 0;
    for (int q = 0; q < n_real; ++q) cnt += __shfl_sync(kFull, g, q) <= i;
    const int miss = i + cnt;
    const bool live = i < width;
    const bool in_range = live && miss < V;
    n_in += __popc(__ballot_sync(kFull, in_range));
    const int rank = (in_range ? c_neg : c_min) + i;
    if (live && rank < width) {
      sc[rank] = in_range ? kNegInf : kMinF;
      tk[rank] = in_range ? miss : 0;
      nxo[rank] = 0;
    }
  }
  int rank = 0;
  for (int q = 0; q < n_real; ++q) {
    const float kq = __shfl_sync(kFull, key, q);
    rank += (kq > key) || (kq == key && q < lane);
  }
  const int n_pad = bmax - n_real;  // slots [n_real, bmax) at -FLT_MAX
  rank += kMinF > key ? n_pad
                      : (kMinF == key ? min(max(lane - n_real, 0), n_pad) : 0);
  rank += (kNegInf > key ? n_in : 0) + (kMinF > key ? width - n_in : 0);
  if (cand && rank < width) {
    sc[rank] = key;
    tk[rank] = tok;
    nxo[rank] = nx;
  }
}

// ---------------------------------------------------------------------------
// The block route: a block of THREADS per beam row, for rows of more than
// kWarpBmax slots: 256 threads, or 1024 for rows of more than kWideBmax
// slots, whose keys fill most of an SM's shared memory, so that the block
// holding it alone walks 4x fewer slots a thread.

constexpr int kBlockThreads = 256;
constexpr int kWideThreads = 1024;
constexpr int kWideBmax = 8192;
constexpr int kBins = 256;          // a radix digit of 8 bits a pass
constexpr int kRound = 256;         // winners ranked a round: one a thread
constexpr int kWalk = 8;            // slots a thread loads at once in a walk
constexpr int kBlockLseBatch = 4;   // float4 loads in flight per thread

// A float key mapped to an unsigned of the same order, so that u > u' iff
// the key comes first in (key desc) order: -0 takes +0's value and every
// NaN the largest, as the plain version's stable sort ranks them.
__device__ __forceinline__ unsigned order_key(float k) {
  if (isnan(k)) return 0xffffffffu;
  unsigned u = __float_as_uint(k);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A row's (max m, log of the sum of exp(x - m)) in one pass over memory by
// the whole block: thread t folds float4s t, t + THREADS, ... into an
// online pair, kBlockLseBatch loads at once (m rises to the batch's max, s
// scaled by exp(m_old - m_new), then s adds the batch's exp(x - m)); each
// warp merges its pairs as WarpRowLse does (the max by one redux, each s
// scaled to it, one butterfly sum) and, after one barrier, every thread
// merges the warps' pairs in warp order.  m starts at -FLT_MAX, so a -inf
// logit adds 0, never NaN.  A row that is not 16-byte aligned, or V % 4 !=
// 0, is read by scalar loads into the same pairs.  (0, 0) and no barrier
// without FUSED.
template <bool FUSED, int THREADS>
__device__ __forceinline__ float2 block_row_lse(const float* x, int V,
                                                float2* red) {
  if constexpr (!FUSED) {
    return make_float2(0.f, 0.f);
  } else {
    float m = kMinF, s = 0.f;
    if ((V & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      const int n4 = V >> 2;
      for (int b = threadIdx.x; b < n4; b += THREADS * kBlockLseBatch) {
        float4 v[kBlockLseBatch];
#pragma unroll
        for (int u = 0; u < kBlockLseBatch; ++u) {
          const int k = b + THREADS * u;
          v[u] = k < n4 ? __ldg(x4 + k)
                        : make_float4(-INFINITY, -INFINITY, -INFINITY,
                                      -INFINITY);
        }
        float r = kMinF;
#pragma unroll
        for (int u = 0; u < kBlockLseBatch; ++u)
          r = fmaxf(r, fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w)));
        if (r > m) {
          s *= exp_le0(m - r);
          m = r;
        }
        float e = 0.f;
#pragma unroll
        for (int u = 0; u < kBlockLseBatch; ++u)
          e += (exp_le0(v[u].x - m) + exp_le0(v[u].y - m)) +
               (exp_le0(v[u].z - m) + exp_le0(v[u].w - m));
        s += e;
      }
    } else {
      for (int i = threadIdx.x; i < V; i += THREADS) {
        const float xi = __ldg(x + i);
        if (xi > m) {
          s = s * exp_le0(m - xi) + 1.f;
          m = xi;
        } else {
          s += exp_le0(xi - m);
        }
      }
    }
    const float mr = warp_max(m);
    const float sr = warp_sum(s * exp_le0(m - mr));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(mr, sr);
    __syncthreads();
    float M = red[0].x;
#pragma unroll
    for (int q = 1; q < THREADS / 32; ++q) M = fmaxf(M, red[q].x);
    float S = 0.f;
#pragma unroll
    for (int q = 0; q < THREADS / 32; ++q)
      S += red[q].y * exp_le0(red[q].x - M);
    return make_float2(M, logf(S));
  }
}

// The digit of the k-th largest key counted in a histogram of kBins, the
// same on every warp: lane l sums bins 8l..8l+7 (read rotated: no bank
// conflict), a suffix scan over the lanes finds the lane whose bins hold
// it, and that lane walks its bins from the top.  `above` receives the
// keys in higher bins, `cnt` those in the digit's bin.
__device__ __forceinline__ int find_digit(const unsigned* h, int k, int& above,
                                          int& cnt) {
  const int lane = threadIdx.x & 31;
  int tot = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) tot += h[lane * 8 + ((u + (lane >> 2)) & 7)];
  int suf = tot;  // the bins of lanes >= lane
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_down_sync(kFull, suf, o);
    if (lane + o < 32) suf += n;
  }
  const int hi = suf - tot;  // the bins of lanes > lane
  const unsigned who = __ballot_sync(kFull, suf >= k && hi < k);
  const int l = who ? __ffs(who) - 1 : 0;
  int b = 0, a = hi, c = 0;
  if (lane == l) {
    for (int u = 7; u >= 0; --u) {
      const int v = h[lane * 8 + u];
      if (a + v >= k) {
        b = lane * 8 + u;
        c = v;
        break;
      }
      a += v;
    }
  }
  above = __shfl_sync(kFull, a, l);
  cnt = __shfl_sync(kFull, c, l);
  return __shfl_sync(kFull, b, l);
}

// The CSR row a block selects from: member `mem`'s row at `start`, its
// n_real slots, and the key of a column (the log-prob: (x - m) - lse when
// FUSED).  Int2 pairs are walked strided (slot j by thread j % THREADS:
// the loads coalesce); delta slots in one run of consecutive slots a warp,
// warp w on [lo, hi) with `carry` the token of slot lo - 1 (the sum of the
// deltas before lo: each warp sums its run, then one barrier), lane l on
// slots lo + l, lo + 32 + l, ..., so the warp decodes its tokens alone (a
// warp scan a chunk of 32), its loads and the tokens' gathers coalesce, and
// it re-walks them with no barrier.  walk<X, PREV>(fn) calls fn(j, tok,
// next, key, prev) for this thread's slots, kWalk loads at once: key when X
// (else 0), prev the token of slot j - 1 when PREV (-1 before slot 0).
template <bool FUSED, bool STACKED, typename Edge, int THREADS>
struct BlockRow {
  const float* x;
  int V;
  float m, lse;
  const Member<STACKED, Edge>& mem;
  int start, n_real;
  int lo = 0, hi = 0, carry = 0;

  __device__ __forceinline__ float key(float xv) const {
    return FUSED ? (xv - m) - lse : xv;
  }
  __device__ __forceinline__ float logit(int tok) const {
    return __ldg(x + min(max(tok, 0), V - 1));
  }

  // delta: this warp's run and its carry, `total` the row's delta sum (the
  // token of slot n_real - 1); every thread must call it
  __device__ __forceinline__ void runs(int* part, int& total) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    constexpr int kW = THREADS / 32;
    const int per = (n_real + kW - 1) / kW;
    lo = min(warp * per, n_real);
    hi = min(lo + per, n_real);
    int sum = 0;
    for (int c0 = lo + lane; c0 < hi; c0 += 32 * kWalk) {
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        const int j = c0 + 32 * u;
        sum += j < hi ? static_cast<int>(mem.edges[start + j]) : 0;
      }
    }
    sum = __reduce_add_sync(kFull, sum);
    if (lane == 0) part[warp] = sum;
    __syncthreads();
    carry = total = 0;
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      carry += q < warp ? part[q] : 0;
      total += part[q];
    }
  }

  template <bool X, bool PREV, typename Fn>
  __device__ __forceinline__ void walk(Fn fn) const {
    if constexpr (kDelta<Edge>) {
      const int lane = threadIdx.x & 31;
      int tok = carry;  // the token before the chunk, on every lane
      for (int c0 = lo; c0 < hi; c0 += 32 * kWalk) {  // the same on a warp
        int d[kWalk], tk[kWalk];
#pragma unroll
        for (int u = 0; u < kWalk; ++u) {
          const int j = c0 + 32 * u + lane;
          d[u] = j < hi ? static_cast<int>(mem.edges[start + j]) : 0;
        }
#pragma unroll
        for (int u = 0; u < kWalk; ++u) {
          const int incl = warp_scan(d[u]);
          tk[u] = tok + incl;
          tok += __shfl_sync(kFull, incl, 31);
        }
        float xv[kWalk];
#pragma unroll
        for (int u = 0; u < kWalk; ++u)
          xv[u] = X && c0 + 32 * u + lane < hi ? logit(tk[u]) : 0.f;
#pragma unroll
        for (int u = 0; u < kWalk; ++u) {
          const int j = c0 + 32 * u + lane;
          if (j < hi)
            fn(j, tk[u], start + j + mem.base, key(xv[u]),
               j == 0 ? -1 : tk[u] - d[u]);
        }
      }
    } else {
      for (int j0 = threadIdx.x; j0 < n_real; j0 += THREADS * kWalk) {
        int2 e[kWalk];
        int pv[kWalk];
#pragma unroll
        for (int u = 0; u < kWalk; ++u) {
          const int j = j0 + THREADS * u;
          e[u] = j < n_real ? mem.edges[start + j] : make_int2(0, 0);
          pv[u] = PREV && j < n_real && j > 0 ? mem.edges[start + j - 1].x
                                              : -1;
        }
        float xv[kWalk];
#pragma unroll
        for (int u = 0; u < kWalk; ++u)
          xv[u] = X && j0 + THREADS * u < n_real ? logit(e[u].x) : 0.f;
#pragma unroll
        for (int u = 0; u < kWalk; ++u)
          if (j0 + THREADS * u < n_real)
            fn(j0 + THREADS * u, e[u].x, e[u].y, key(xv[u]), pv[u]);
      }
    }
  }
};

// One block per beam row, for rows of more than kWarpBmax slots: the same
// function as vntk_topk_warp_kernel.  The candidates are the row's n_real
// real slots (R), the padding slots [n_real, bmax) at -FLT_MAX (P), and the
// missing tokens: the first n_in = min(width, V - n_real) in range at
// NEG_INF (Mi), the rest at -FLT_MAX (Mo); in (key desc, index asc) order
// only R needs a selection, and the rest take closed-form ranks:
//   1. the chase's head; (FUSED) the row's log-sum-exp in one pass
//      (block_row_lse); delta slots: each warp's run summed, one barrier;
//   2. pass 0 maps each real slot's key to order_key (staged in shared
//      memory, 4 bytes a slot, when `staged`), counts the keys at >=
//      NEG_INF (c_neg) and >= -FLT_MAX (c_min), and histograms the top
//      digit;
//   3. P, Mo and the needed Mi are written in closed form: padding slot p
//      at rank c_min + n_in + p, missing candidate i at c_neg + i (Mi) or
//      c_min + n_pad + i (Mo).  Mi's token is i + cnt(i), cnt(i) = |{j :
//      tok_j - j <= i}|: g_j = tok_j - j is non-decreasing along a row
//      (its tokens are sorted and distinct), so slot j owns the i in
//      [g_{j-1}, g_j), whose token is i + j, and the tail i >= g_{n_real-1}
//      takes i + n_real; only i < width - c_neg are written;
//   4. R's top min(width, n_real) by a radix select on the composite
//      (order key, inverted slot index), unique per slot: 8 bits a pass,
//      each pass a histogram of the slots that match the digits chosen so
//      far, one barrier, and the digit found by every warp alike; it stops
//      as soon as the digit's bin holds exactly the slots still needed.
//      The slots at or above the threshold are gathered (tokens and next
//      states by slot index; a delta run re-walks its tokens), ranked among
//      themselves by counting, and written at rank + n_in below NEG_INF +
//      (n_pad + width - n_in) below -FLT_MAX.  Past kRound winners the
//      selection repeats, a round of kRound ranks at a time;
//   5. without staging (bmax past the shared memory a block has) each pass
//      re-reads the keys from the CSR row and the logit row, both in L2.
// Scores are the keys re-read at the winners' tokens, bit for bit.  Ranks
// are a permutation of [0, bmax + width): each output is written once.
template <bool FUSED, bool STACKED, typename Edge, int THREADS>
__global__ void __launch_bounds__(THREADS) vntk_topk_kernel(
    const float* __restrict__ values, int64_t ld, const int* __restrict__ nodes,
    Tables t, int V, int bmax, int width, int staged,
    float* __restrict__ out_sc, int* __restrict__ out_tok,
    int* __restrict__ out_next) {
  extern __shared__ unsigned skey[];  // staged: slot j's order key
  __shared__ unsigned hist[3][kBins];
  __shared__ float2 red[THREADS / 32];
  __shared__ int part[THREADS / 32];
  __shared__ int count[3];  // real slots at >= NEG_INF, >= -FLT_MAX; winners
  __shared__ unsigned wkey[kRound];
  __shared__ int wslot[kRound], wtok[kRound], wnext[kRound];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;

  // 1. the chase's head, the cleared counts, the row's fold
  const int node = nodes[row];
  const Member<STACKED, Edge> mem(t, row);
  const float* x = values + row * ld;
  unsigned* const hflat = &hist[0][0];
  for (int i = tid; i < 3 * kBins; i += THREADS) hflat[i] = 0u;
  if (tid < 3) count[tid] = 0;
  const int start = mem.rp[node];
  const int n_real = max(0, min(mem.rp[node + 1] - start, bmax));
  const float2 lse = block_row_lse<FUSED, THREADS>(x, V, red);
  BlockRow<FUSED, STACKED, Edge, THREADS> r{x,   V,     lse.x, lse.y,
                                           mem, start, n_real};
  int last_tok;  // the token of slot n_real - 1
  if constexpr (kDelta<Edge>) {
    r.runs(part, last_tok);
  } else {
    last_tok = n_real > 0 ? mem.edges[start + n_real - 1].x : -1;
    if constexpr (!FUSED) __syncthreads();  // the clears
  }

  // 2. pass 0
  const unsigned uneg = order_key(kNegInf), umin = order_key(kMinF);
  int cneg = 0, cmin = 0;
  r.template walk<true, false>([&](int j, int, int, float key, int) {
    const unsigned uk = order_key(key);
    if (staged) skey[j] = uk;
    atomicAdd(&hist[0][uk >> 24], 1u);
    cneg += uk >= uneg;
    cmin += uk >= umin;
  });
  if (cneg) atomicAdd(&count[0], cneg);
  if (cmin) atomicAdd(&count[1], cmin);
  __syncthreads();
  const int c_neg = count[0], c_min = count[1];

  // 3. the candidates in closed form
  float* sc = out_sc + static_cast<int64_t>(row) * width;
  int* tk = out_tok + static_cast<int64_t>(row) * width;
  int* nxo = out_next + static_cast<int64_t>(row) * width;
  const auto put = [&](int rank, float s, int tok, int nx) {
    sc[rank] = s;
    tk[rank] = tok;
    nxo[rank] = nx;
  };
  const int n_pad = bmax - n_real;
  const int n_in = min(width, max(V - n_real, 0));
  for (int p = tid; p < min(n_pad, width - c_min - n_in); p += THREADS)
    put(c_min + n_in + p, kMinF, 0, 0);
  for (int i = n_in + tid; i < width - c_min - n_pad; i += THREADS)
    put(c_min + n_pad + i, kMinF, 0, 0);
  const int need = max(0, min(n_in, width - c_neg));
  if (need > 0) {
    const int g_tail = n_real > 0 ? last_tok - (n_real - 1) : 0;
    for (int i = max(g_tail, 0) + tid; i < need; i += THREADS)
      put(c_neg + i, kNegInf, i + n_real, 0);
    r.template walk<false, true>([&](int j, int tok, int, float, int prev) {
      const int end = min(tok - j, need);
      for (int i = max(prev - (j - 1), 0); i < end; ++i)
        put(c_neg + i, kNegInf, i + j, 0);
    });
  }

  // 4. R's top min(width, n_real), kRound ranks a round
  const int kk = min(width, n_real);
  int ns = 1;  // bytes of the inverted slot index the composite keeps
  while (ns < 4 && (bmax - 1) >> (8 * ns)) ++ns;
  const int D = 4 + ns;  // digits of the composite
  const uint64_t smask = ns == 4 ? 0xffffffffull : (1ull << (8 * ns)) - 1;
  const auto comp = [&](int j, unsigned uk) {
    return (static_cast<uint64_t>(uk) << (8 * ns)) |
           (~static_cast<uint64_t>(j) & smask);
  };
  // fn(j, order key) over this thread's real slots
  const auto each = [&](auto fn) {
    if (staged) {
      for (int j = tid; j < n_real; j += THREADS) fn(j, skey[j]);
    } else {
      r.template walk<true, false>(
          [&](int j, int, int, float key, int) { fn(j, order_key(key)); });
    }
  };
  // the composite of the k-th largest: the slots at or above it are the
  // top k.  hist0: pass 0's histogram is made (and a barrier passed).
  const auto select = [&](int k, bool hist0) {
    uint64_t prefix = 0;
    for (int p = 0; p < D; ++p) {
      unsigned* h = hist[p % 3];
      const int dsh = 8 * (D - 1 - p);
      if (p > 0 || !hist0) {
        unsigned* hn = hist[(p + 1) % 3];  // last read two passes ago
        for (int i = tid; i < kBins; i += THREADS) hn[i] = 0u;
        each([&](int j, unsigned uk) {
          const uint64_t c = comp(j, uk);
          if (p == 0 || (c >> (dsh + 8)) == (prefix >> (dsh + 8)))
            atomicAdd(&h[(c >> dsh) & (kBins - 1)], 1u);
        });
        __syncthreads();
      }
      int above, cnt;
      prefix |= static_cast<uint64_t>(find_digit(h, k, above, cnt)) << dsh;
      k -= above;
      if (cnt == k) break;
    }
    return prefix;
  };
  uint64_t thr_prev = 0;
  for (int done = 0, k = min(kk, kRound); done < kk;
       done = k, k = min(kk, k + kRound)) {
    if (done > 0) {  // the last round's winners are ranked
      __syncthreads();
      for (int i = tid; i < 3 * kBins; i += THREADS) hflat[i] = 0u;
      if (tid == 0) count[2] = 0;
      __syncthreads();
    }
    const uint64_t thr = select(k, done == 0);
    const auto gather = [&](int j, unsigned uk, int tok, int nx) {
      const uint64_t c = comp(j, uk);
      if (c < thr || (done > 0 && c >= thr_prev)) return;
      const int pos = atomicAdd(&count[2], 1);
      if (pos >= kRound) return;
      if constexpr (!kDelta<Edge>) {
        const int2 e = mem.edges[start + j];
        tok = e.x;
        nx = e.y;
      }
      wkey[pos] = uk;
      wslot[pos] = j;
      wtok[pos] = tok;
      wnext[pos] = nx;
    };
    if constexpr (kDelta<Edge>) {
      if (staged) {
        r.template walk<false, false>([&](int j, int tok, int nx, float, int) {
          gather(j, skey[j], tok, nx);
        });
      } else {
        r.template walk<true, false>([&](int j, int tok, int nx, float key,
                                         int) {
          gather(j, order_key(key), tok, nx);
        });
      }
    } else {
      each([&](int j, unsigned uk) { gather(j, uk, 0, 0); });
    }
    __syncthreads();
    const int nw = k - done;
    if (tid < nw) {
      const unsigned uk = wkey[tid];
      const uint64_t c = comp(wslot[tid], uk);
      int rank = done;
      for (int q = 0; q < nw; ++q) rank += comp(wslot[q], wkey[q]) > c;
      rank += (uk < uneg ? n_in : 0) + (uk < umin ? n_pad + width - n_in : 0);
      if (rank < width)
        put(rank, r.key(r.logit(wtok[tid])), wtok[tid], wnext[tid]);
    }
    thr_prev = thr;
  }
}

// The mask kernel's block and its workers: warps 1.. (warp 0 runs the
// chase).
constexpr int kMaskThreads = 128;
constexpr int kMaskWarps = kMaskThreads / 32;
constexpr int kMaskWorkers = kMaskThreads - 32;
// float4 loads in flight per worker: a row of up to 3072 at once
constexpr int kMaskBatch = 8;

// One worker's share of a row's (max m, sum of exp(x - m)) in one pass
// over memory: WarpRowLse's fold over kMaskWorkers threads (worker w takes
// float4s w, w + kMaskWorkers, ...).  The constructor issues the worker's
// first kMaskBatch 16-byte loads and returns, so the fill's stores go out
// while they land.  fold() folds the row into an online pair, batch by
// batch: m rises to the batch's max (s scaled by exp(m_old - m_new)), then
// s adds the batch's exp(x - m), summed as a tree.  m starts at -FLT_MAX,
// so a -inf logit adds 0, never NaN.  A row that is not 16-byte aligned,
// or V % 4 != 0, is read by scalar loads into the same pair.  Without
// FUSED it loads nothing and is not used.  (One template for this and
// WarpRowLse made the topk warp kernel's fused rows ~5% slower.)
template <bool FUSED>
struct WorkerRowLse {
  const float* x;
  int V, w;
  bool vec = false;
  float4 v[kMaskBatch];

  __device__ __forceinline__ WorkerRowLse(const float* row, int V_, int w_)
      : x(row), V(V_), w(w_) {
    if (!FUSED) return;
    vec = (V & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    if (vec) load(0);
  }

  // float4s b + w + kMaskWorkers u of the row, -inf past its end
  __device__ __forceinline__ void load(int b) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int n4 = V >> 2;
#pragma unroll
    for (int u = 0; u < kMaskBatch; ++u) {
      const int k = b + w + kMaskWorkers * u;
      v[u] = k < n4 ? __ldg(x4 + k)
                    : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
  }

  // this worker's (m, s); (-FLT_MAX, 0) when it holds no element
  __device__ __forceinline__ float2 fold() {
    float m = kMinF, s = 0.f;
    if (vec) {
      for (int b = 0;;) {  // b is the same on every worker
        float r[kMaskBatch];
#pragma unroll
        for (int u = 0; u < kMaskBatch; ++u)
          r[u] = fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w));
#pragma unroll
        for (int h = kMaskBatch / 2; h > 0; h >>= 1)
#pragma unroll
          for (int u = 0; u < h; ++u) r[u] = fmaxf(r[u], r[u + h]);
        if (r[0] > m) {
          s *= exp_le0(m - r[0]);
          m = r[0];
        }
#pragma unroll
        for (int u = 0; u < kMaskBatch; ++u)
          r[u] = (exp_le0(v[u].x - m) + exp_le0(v[u].y - m)) +
                 (exp_le0(v[u].z - m) + exp_le0(v[u].w - m));
#pragma unroll
        for (int h = kMaskBatch / 2; h > 0; h >>= 1)
#pragma unroll
          for (int u = 0; u < h; ++u) r[u] += r[u + h];
        s += r[0];
        b += kMaskWorkers * kMaskBatch;
        if (b >= (V >> 2)) break;
        load(b);
      }
    } else {
      for (int i = w; i < V; i += kMaskWorkers) {
        const float xi = __ldg(x + i);
        if (xi > m) {
          s = s * exp_le0(m - xi) + 1.f;
          m = xi;
        } else {
          s += exp_le0(xi - m);
        }
      }
    }
    return make_float2(m, s);
  }
};

// The mask kernel's fill and, when FUSED, its row's log-sum-exp, by the
// workers while warp 0 chases.  A worker issues its row loads
// (WorkerRowLse), writes its columns of NEG_INF and 0 (16-byte stores where
// both output rows are 16-byte aligned, which V % 4 == 0 gives; scalar
// stores otherwise), then folds the row into its pair; each warp merges its
// pairs as WarpRowLse does (the max by one redux, each s scaled to it, one
// butterfly sum) into red[warp].  Then the kernel's one barrier, which also
// orders the fill before the scatter; after it every thread merges the
// warps' pairs in warp order.  Returns (m, log s) of the row, (0, 0)
// without FUSED.
template <bool FUSED>
__device__ __forceinline__ float2 fill_and_lse(const float* x, int V, float* o,
                                               int* on, float2* red) {
  const int warp = threadIdx.x >> 5;
  if (warp > 0) {
    const int w = threadIdx.x - 32;
    WorkerRowLse<FUSED> lse(x, V, w);
    const uintptr_t rows = reinterpret_cast<uintptr_t>(o) |
                           reinterpret_cast<uintptr_t>(on);
    const bool vec = (V & 3) == 0 && (rows & 15) == 0;
    if (vec) {
      float4* o4 = reinterpret_cast<float4*>(o);
      int4* on4 = reinterpret_cast<int4*>(on);
      for (int k = w; k < (V >> 2); k += kMaskWorkers) {
        o4[k] = make_float4(kNegInf, kNegInf, kNegInf, kNegInf);
        on4[k] = make_int4(0, 0, 0, 0);
      }
    } else {
      for (int k = w; k < V; k += kMaskWorkers) {
        o[k] = kNegInf;
        on[k] = 0;
      }
    }
    if constexpr (FUSED) {
      const float2 p = lse.fold();
      const float mr = warp_max(p.x);
      const float sr = warp_sum(p.y * exp_le0(p.x - mr));
      if ((threadIdx.x & 31) == 0) red[warp] = make_float2(mr, sr);
    }
  }
  __syncthreads();
  if constexpr (!FUSED) return make_float2(0.f, 0.f);
  float m = red[1].x;
#pragma unroll
  for (int q = 2; q < kMaskWarps; ++q) m = fmaxf(m, red[q].x);
  float s = 0.f;
#pragma unroll
  for (int q = 1; q < kMaskWarps; ++q) s += red[q].y * exp_le0(red[q].x - m);
  return make_float2(m, logf(s));
}

// One block per beam row: the vocab-aligned masked log-prob row (NEG_INF off
// the trie) and next-state map (0 when invalid), by fill then scatter.
// WARP (bmax <= kWarpBmax, every sparse level of the main paths):
//   1. warp 0 runs the pointer chase first: nodes[row] and the member
//      (cids[row], its base), then the row's pointer pair, then lane j's
//      slot (an int2 pair, or a delta decoded by a warp scan), then its
//      logit x[tok], all kept in registers;
//   2. meanwhile warps 1.. fill the row and, when FUSED, fold it
//      (fill_and_lse), and the block meets at its one barrier;
//   3. warp 0 scatters its slots from registers.
// Otherwise (a root row, the stress shapes) every thread runs the chase,
// then the same fill and barrier, then the slots are scattered chunk by
// chunk (for_each_delta_slot's block scan, or a strided int2 loop).  Only
// slots below n_child are read; tokens outside [0, V) are not written.
// Tokens within a row are distinct, so no two slots write one column.
template <bool FUSED, bool STACKED, typename Edge, bool WARP>
__global__ void __launch_bounds__(kMaskThreads) vntk_mask_kernel(
    const float* __restrict__ values, int64_t ld, const int* __restrict__ nodes,
    Tables t, int V, int bmax, float* __restrict__ out_lp,
    int* __restrict__ out_next) {
  __shared__ float2 red[kMaskWarps];
  __shared__ int part[kMaskWarps];
  const int row = blockIdx.x;
  const float* x = values + row * ld;
  float* o = out_lp + static_cast<int64_t>(row) * V;
  int* on = out_next + static_cast<int64_t>(row) * V;
  if constexpr (WARP) {
    const int lane = threadIdx.x;
    int tok = -1, nx = 0;  // tok -1: this lane writes nothing
    float xv = 0.f;
    if (threadIdx.x < 32) {
      const int node = nodes[row];
      const Member<STACKED, Edge> mem(t, row);
      const int start = mem.rp[node];
      const int n_real = max(0, min(mem.rp[node + 1] - start, bmax));
      const bool real = lane < n_real;
      const Edge e = real ? mem.edges[start + lane] : Edge{};
      if constexpr (kDelta<Edge>) {
        tok = warp_scan(static_cast<int>(e));
        nx = start + lane + mem.base;
      } else {
        tok = e.x;
        nx = e.y;
      }
      if (!real || tok < 0 || tok >= V) tok = -1;
      if (tok >= 0) xv = x[tok];
    }
    const float2 lse = fill_and_lse<FUSED>(x, V, o, on, red);
    if (tok >= 0) {
      o[tok] = FUSED ? (xv - lse.x) - lse.y : xv;
      on[tok] = nx;
    }
  } else {
    const int node = nodes[row];
    const Member<STACKED, Edge> mem(t, row);
    const int start = mem.rp[node];
    const int n_real = max(0, min(mem.rp[node + 1] - start, bmax));
    const float2 lse = fill_and_lse<FUSED>(x, V, o, on, red);
    const auto lp = [&](int col) {
      return FUSED ? (x[col] - lse.x) - lse.y : x[col];
    };
    if constexpr (kDelta<Edge>) {
      for_each_delta_slot<kMaskThreads>(mem, start, n_real, part,
                                        [&](int, int tok, int nx) {
        if (tok >= 0 && tok < V) {
          o[tok] = lp(tok);
          on[tok] = nx;
        }
      });
    } else {
      for (int j = threadIdx.x; j < n_real; j += kMaskThreads) {
        const int2 e = mem.edges[start + j];
        if (e.x >= 0 && e.x < V) {
          o[e.x] = lp(e.x);
          on[e.x] = e.y;
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t prepare_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool warp_route(int bmax) { return bmax <= kWarpBmax; }

// Set by vntk_topk_reread: block-route launches stage no keys at any width.
bool g_reread = false;

// Dynamic shared memory of a block-route launch over rows of bmax slots:
// their keys (4 bytes a slot) when they fit beside the kernel's static
// arrays, else 0 (the kernel re-reads the keys in each pass).
template <typename Kernel>
cudaError_t topk_stage_bytes(Kernel kernel, int bmax, size_t& bytes) {
  bytes = 0;
  if (g_reread) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int dev = 0, optin = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t want = static_cast<size_t>(bmax) * sizeof(unsigned);
  if (want + attr.sharedSizeBytes <= static_cast<size_t>(optin)) bytes = want;
  return cudaSuccess;
}

// One launch's rows and outputs: out_sc holds the scores (topk) or the
// masked log-probs (mask, which has no out_tok and no width).
struct Rows {
  const float* values;
  int64_t ld;
  const int* nodes;
  int nb, V, bmax, width;
  float* out_sc;
  int* out_tok;
  int* out_next;
  cudaStream_t stream;
};

// The block route's launch: the keys staged when they fit.
template <bool FUSED, bool STACKED, typename Edge, int THREADS>
int launch_block(const Rows& r, const Tables& t) {
  const auto kernel = vntk_topk_kernel<FUSED, STACKED, Edge, THREADS>;
  size_t smem;
  cudaError_t err = topk_stage_bytes(kernel, r.bmax, smem);
  if (err == cudaSuccess) err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<r.nb, THREADS, smem, r.stream>>>(
      r.values, r.ld, r.nodes, t, r.V, r.bmax, r.width, smem > 0 ? 1 : 0,
      r.out_sc, r.out_tok, r.out_next);
  return static_cast<int>(cudaGetLastError());
}

// bmax <= kWarpBmax: a warp per row; wider rows: a block per row.
template <bool FUSED, bool STACKED, typename Edge>
int launch_topk(const Rows& r, const Tables& t) {
  if (warp_route(r.bmax)) {
    vntk_topk_warp_kernel<FUSED, STACKED, Edge><<<r.nb, 32, 0, r.stream>>>(
        r.values, r.ld, r.nodes, t, r.V, r.bmax, r.width, r.out_sc, r.out_tok,
        r.out_next);
    return static_cast<int>(cudaGetLastError());
  }
  if (r.bmax > kWideBmax)
    return launch_block<FUSED, STACKED, Edge, kWideThreads>(r, t);
  return launch_block<FUSED, STACKED, Edge, kBlockThreads>(r, t);
}

// A block per row either way; bmax <= kWarpBmax: warp 0 holds the slots.
template <bool FUSED, bool STACKED, typename Edge>
int launch_mask(const Rows& r, const Tables& t) {
  if (warp_route(r.bmax)) {
    vntk_mask_kernel<FUSED, STACKED, Edge, true>
        <<<r.nb, kMaskThreads, 0, r.stream>>>(r.values, r.ld, r.nodes, t, r.V,
                                               r.bmax, r.out_sc, r.out_next);
  } else {
    vntk_mask_kernel<FUSED, STACKED, Edge, false>
        <<<r.nb, kMaskThreads, 0, r.stream>>>(r.values, r.ld, r.nodes, t, r.V,
                                               r.bmax, r.out_sc, r.out_next);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for `fused` and the edge source: int2 pairs
// (delta_bytes 0) or int16_t / int32_t deltas (2 / 4).
template <bool TOPK, bool STACKED, typename Edge>
int launch_fused(int fused, const Rows& r, const Tables& t) {
  if constexpr (TOPK) {
    return fused ? launch_topk<true, STACKED, Edge>(r, t)
                 : launch_topk<false, STACKED, Edge>(r, t);
  } else {
    return fused ? launch_mask<true, STACKED, Edge>(r, t)
                 : launch_mask<false, STACKED, Edge>(r, t);
  }
}

template <bool TOPK, bool STACKED>
int launch(int fused, int delta_bytes, const Rows& r, const Tables& t) {
  switch (delta_bytes) {
    case 0:
      return launch_fused<TOPK, STACKED, int2>(fused, r, t);
    case 2:
      return launch_fused<TOPK, STACKED, int16_t>(fused, r, t);
    case 4:
      return launch_fused<TOPK, STACKED, int32_t>(fused, r, t);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Tables single(const int* row_pointers, const void* edges, const int* base) {
  return Tables{nullptr, 1, row_pointers, 0, edges, 0, base, 0};
}

}  // namespace

extern "C" {

// 1 if the block route stages the keys of rows of bmax slots in shared
// memory, 0 if it re-reads them in each pass, -1 on a CUDA error.
int vntk_topk_staged(int bmax) {
  size_t bytes;
  const cudaError_t err =
      bmax > kWideBmax
          ? topk_stage_bytes(vntk_topk_kernel<true, true, int2, kWideThreads>,
                             bmax, bytes)
          : topk_stage_bytes(vntk_topk_kernel<true, true, int2, kBlockThreads>,
                             bmax, bytes);
  if (err != cudaSuccess) return -1;
  return bytes > 0 ? 1 : 0;
}

// Nonzero `on`: the block route re-reads its keys in each pass at every
// row width, as it does past vntk_topk_staged's limit (to check and time
// that path at widths that would stage); 0: it stages them while they fit.
void vntk_topk_reread(int on) { g_reread = on != 0; }

// 1 if rows of bmax slots take the warp route, 0 for the block route.
int vntk_topk_warp_route(int bmax) { return warp_route(bmax) ? 1 : 0; }

// 1 if rows of bmax slots take the block route's kWideThreads instantiation.
int vntk_topk_wide_route(int bmax) {
  return !warp_route(bmax) && bmax > kWideBmax ? 1 : 0;
}

// 1 if the mask kernel holds rows of bmax slots in one warp's registers, 0
// if it scatters them chunk by chunk.
int vntk_mask_warp_route(int bmax) { return warp_route(bmax) ? 1 : 0; }

int vntk_topk_launch(const float* values, int64_t ld, const int* nodes,
                     const int* row_pointers, const int* edges, int nb, int V,
                     int bmax, int width, int fused, float* out_sc, int* out_tok,
                     int* out_next, cudaStream_t stream) {
  const Rows r{values, ld, nodes, nb, V, bmax, width, out_sc, out_tok,
               out_next, stream};
  return launch<true, false>(fused, 0, r, single(row_pointers, edges, nullptr));
}

int vntk_mask_launch(const float* values, int64_t ld, const int* nodes,
                     const int* row_pointers, const int* edges, int nb, int V,
                     int bmax, int fused, float* out_lp, int* out_next,
                     cudaStream_t stream) {
  const Rows r{values, ld, nodes, nb, V, bmax, 0, out_lp, nullptr, out_next,
               stream};
  return launch<false, false>(fused, 0, r, single(row_pointers, edges, nullptr));
}

// Stacked store: rp_stride = S + 1 row pointers and edge_stride = E edge
// pairs per member, K members.
int vntk_stacked_topk_launch(const float* values, int64_t ld, const int* nodes,
                             const int* cids, int K, const int* row_pointers,
                             int64_t rp_stride, const int* edges,
                             int64_t edge_stride, int nb, int V, int bmax,
                             int width, int fused, float* out_sc, int* out_tok,
                             int* out_next, cudaStream_t stream) {
  const Rows r{values, ld, nodes, nb, V, bmax, width, out_sc, out_tok,
               out_next, stream};
  const Tables t{cids, K, row_pointers, rp_stride, edges, edge_stride,
                 nullptr, 0};
  return launch<true, true>(fused, 0, r, t);
}

int vntk_stacked_mask_launch(const float* values, int64_t ld, const int* nodes,
                             const int* cids, int K, const int* row_pointers,
                             int64_t rp_stride, const int* edges,
                             int64_t edge_stride, int nb, int V, int bmax,
                             int fused, float* out_lp, int* out_next,
                             cudaStream_t stream) {
  const Rows r{values, ld, nodes, nb, V, bmax, 0, out_lp, nullptr, out_next,
               stream};
  const Tables t{cids, K, row_pointers, rp_stride, edges, edge_stride,
                 nullptr, 0};
  return launch<false, true>(fused, 0, r, t);
}

// Compressed slab: tok_delta holds delta_bytes-wide (2: int16, 4: int32)
// token deltas; base points at the step's int32 next-state base.
int vntk_compressed_topk_launch(const float* values, int64_t ld,
                                const int* nodes, const int* row_pointers,
                                const void* tok_delta, int delta_bytes,
                                const int* base, int nb, int V, int bmax,
                                int width, int fused, float* out_sc,
                                int* out_tok, int* out_next,
                                cudaStream_t stream) {
  const Rows r{values, ld, nodes, nb, V, bmax, width, out_sc, out_tok,
               out_next, stream};
  return launch<true, false>(fused, delta_bytes, r,
                             single(row_pointers, tok_delta, base));
}

int vntk_compressed_mask_launch(const float* values, int64_t ld,
                                const int* nodes, const int* row_pointers,
                                const void* tok_delta, int delta_bytes,
                                const int* base, int nb, int V, int bmax,
                                int fused, float* out_lp, int* out_next,
                                cudaStream_t stream) {
  const Rows r{values, ld, nodes, nb, V, bmax, 0, out_lp, nullptr, out_next,
               stream};
  return launch<false, false>(fused, delta_bytes, r,
                              single(row_pointers, tok_delta, base));
}

// Stacked compressed slab: delta_stride deltas per member and the step's
// per-member bases base_k[k * base_stride].
int vntk_stacked_compressed_topk_launch(
    const float* values, int64_t ld, const int* nodes, const int* cids, int K,
    const int* row_pointers, int64_t rp_stride, const void* tok_delta,
    int64_t delta_stride, int delta_bytes, const int* base_k,
    int64_t base_stride, int nb, int V, int bmax, int width, int fused,
    float* out_sc, int* out_tok, int* out_next, cudaStream_t stream) {
  const Rows r{values, ld, nodes, nb, V, bmax, width, out_sc, out_tok,
               out_next, stream};
  const Tables t{cids, K, row_pointers, rp_stride, tok_delta, delta_stride,
                 base_k, base_stride};
  return launch<true, true>(fused, delta_bytes, r, t);
}

int vntk_stacked_compressed_mask_launch(
    const float* values, int64_t ld, const int* nodes, const int* cids, int K,
    const int* row_pointers, int64_t rp_stride, const void* tok_delta,
    int64_t delta_stride, int delta_bytes, const int* base_k,
    int64_t base_stride, int nb, int V, int bmax, int fused, float* out_lp,
    int* out_next, cudaStream_t stream) {
  const Rows r{values, ld, nodes, nb, V, bmax, 0, out_lp, nullptr, out_next,
               stream};
  const Tables t{cids, K, row_pointers, rp_stride, tok_delta, delta_stride,
                 base_k, base_stride};
  return launch<false, true>(fused, delta_bytes, r, t);
}

}  // extern "C"
