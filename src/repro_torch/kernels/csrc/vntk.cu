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
// writes the decoded slots into the shared arrays it stages anyway; the
// mask kernel scatters each chunk as it is decoded, so a root row of any
// width needs no extra shared memory.  The reference decodes the whole burst
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
//   * bmax > 32 (a root row, the stress shapes): a block per beam row
//     (vntk_topk_kernel), the candidates staged in shared memory and ranked
//     by counting, rank[j] = #{j' : key[j'] > key[j] or (key[j'] == key[j]
//     and j' < j)}: O((bmax + C)^2 / 256) per thread, bounded by that and
//     the block's barriers.
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpBmax = 32;  // rows of at most this many slots: one warp
constexpr int kLseBatch = 16;  // float4 loads in flight per lane, warp route
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1.0e10f;  // NEG_INF of core/vntk.py
constexpr float kMinF = -FLT_MAX;    // jnp.finfo(float32).min

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : -INFINITY;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red is reused by the next reduction
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  return v;
}

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

// Row statistics of the in-register log-softmax (kernels/vntk.py:276-279):
// lp = (x - m) - log(sum(exp(x - m))).  Without FUSED the row already holds
// normalized log-probs and is used as it is.
template <bool FUSED>
struct RowLogProb {
  const float* x;
  float m = 0.f, lse = 0.f;

  __device__ RowLogProb(const float* row, int V, float* red) : x(row) {
    if (!FUSED) return;
    float v = -INFINITY;
    for (int i = threadIdx.x; i < V; i += kThreads) v = fmaxf(v, x[i]);
    m = block_max(v, red);
    float s = 0.f;
    for (int i = threadIdx.x; i < V; i += kThreads) s += expf(x[i] - m);
    lse = logf(block_sum(s, red));
  }

  __device__ __forceinline__ float operator()(int col) const {
    return FUSED ? (x[col] - m) - lse : x[col];
  }
};

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

// One block per beam row: per-beam dense-rank top-`width` of the CSR row of
// nodes[row] — valid children by (lp desc, token asc), then the first
// missing tokens at NEG_INF; slots that do not exist sink to -FLT_MAX.
template <bool FUSED, bool STACKED, typename Edge>
__global__ void __launch_bounds__(kThreads) vntk_topk_kernel(
    const float* __restrict__ values, int64_t ld, const int* __restrict__ nodes,
    Tables t, int V, int bmax, int width, float* __restrict__ out_sc,
    int* __restrict__ out_tok, int* __restrict__ out_next) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  __shared__ int part[kWarps];
  const int J = bmax + width;
  float* keys = reinterpret_cast<float*>(smem);
  int* toks = reinterpret_cast<int*>(keys + J);
  int* nexts = toks + J;

  const int row = blockIdx.x;
  const RowLogProb<FUSED> lp(values + row * ld, V, red);
  const Member<STACKED, Edge> mem(t, row);
  const int node = nodes[row];
  const int start = mem.rp[node];
  const int n_child = mem.rp[node + 1] - start;
  const int n_real = max(0, min(n_child, bmax));

  // candidate slots of the CSR row (token-ascending)
  if constexpr (kDelta<Edge>) {
    for_each_delta_slot<kThreads>(mem, start, n_real, part,
                                  [&](int j, int tok, int nx) {
      keys[j] = lp(min(max(tok, 0), V - 1));
      toks[j] = tok;
      nexts[j] = nx;
    });
    for (int j = n_real + threadIdx.x; j < bmax; j += kThreads) {
      keys[j] = kMinF;
      toks[j] = 0;
      nexts[j] = 0;
    }
  } else {
    for (int j = threadIdx.x; j < bmax; j += kThreads) {
      if (j < n_real) {
        const int2 e = mem.edges[start + j];
        keys[j] = lp(min(max(e.x, 0), V - 1));
        toks[j] = e.x;
        nexts[j] = e.y;
      } else {
        keys[j] = kMinF;
        toks[j] = 0;
        nexts[j] = 0;
      }
    }
  }
  __syncthreads();

  // the i-th missing token: i + |{j : cols[j] - j <= i}| (core/vntk.py:219-226)
  for (int i = threadIdx.x; i < width; i += kThreads) {
    int cnt = 0;
    for (int j = 0; j < n_real; ++j) cnt += (toks[j] - j <= i);
    const int t = i + cnt;
    const bool in_range = t < V;
    keys[bmax + i] = in_range ? kNegInf : kMinF;
    toks[bmax + i] = in_range ? t : 0;
    nexts[bmax + i] = 0;
  }
  __syncthreads();

  // rank by counting; ranks are a permutation of [0, J), so each of the
  // `width` output lanes is written exactly once
  float* sc = out_sc + static_cast<int64_t>(row) * width;
  int* tk = out_tok + static_cast<int64_t>(row) * width;
  int* nx = out_next + static_cast<int64_t>(row) * width;
  for (int j = threadIdx.x; j < J; j += kThreads) {
    const float k = keys[j];
    int rank = 0;
    for (int q = 0; q < J; ++q) {
      const float kq = keys[q];
      rank += (kq > k) || (kq == k && q < j);
    }
    if (rank < width) {
      sc[rank] = k;
      tk[rank] = toks[j];
      nx[rank] = nexts[j];
    }
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

size_t topk_smem_bytes(int bmax, int width) {
  if (warp_route(bmax)) return 0;
  return static_cast<size_t>(bmax + width) * (sizeof(float) + 2 * sizeof(int));
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

// bmax <= kWarpBmax: a warp per row; wider rows: a block per row.
template <bool FUSED, bool STACKED, typename Edge>
int launch_topk(const Rows& r, const Tables& t) {
  if (warp_route(r.bmax)) {
    vntk_topk_warp_kernel<FUSED, STACKED, Edge><<<r.nb, 32, 0, r.stream>>>(
        r.values, r.ld, r.nodes, t, r.V, r.bmax, r.width, r.out_sc, r.out_tok,
        r.out_next);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = topk_smem_bytes(r.bmax, r.width);
  const cudaError_t err =
      prepare_smem(vntk_topk_kernel<FUSED, STACKED, Edge>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  vntk_topk_kernel<FUSED, STACKED, Edge><<<r.nb, kThreads, smem, r.stream>>>(
      r.values, r.ld, r.nodes, t, r.V, r.bmax, r.width, r.out_sc, r.out_tok,
      r.out_next);
  return static_cast<int>(cudaGetLastError());
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

// Shared memory the topk kernel needs for bmax + width candidate keys (none
// on the warp route).
size_t vntk_topk_smem_bytes(int bmax, int width) {
  return topk_smem_bytes(bmax, width);
}

// 1 if rows of bmax slots take the warp route, 0 for the block route.
int vntk_topk_warp_route(int bmax) { return warp_route(bmax) ? 1 : 0; }

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
