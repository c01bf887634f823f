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
// block_scan) over chunks of kThreads slots with a running carry.  The topk
// kernel writes the decoded slots into the shared arrays it stages anyway;
// the mask kernel scatters each chunk as it is decoded, so a root row of any
// width needs no extra shared memory.  The reference decodes the whole burst
// and masks what lies past the row end; slots past n_child are not read here
// at all, with the same outputs.  A member's delta row starts k *
// edge_stride elements in, computed in int64 (ten 20M-SID members hold about
// 1.1e9 int16 deltas, 2.2 GB).
//
// What bounds it on this card: bytes.  Per beam row the step reads its
// constraint id (STACKED), one CSR row pointer pair, at most n_child
// (token, next) pairs (or 2-byte deltas) and, when FUSED, the whole (V,)
// f32 logit row; it writes (C,) scores/tokens/next states (topk) or the
// (V,) masked row and (V,) next-state map (mask).  At the main paths' shapes (nb = 140 single
// or 350 stacked, V = 2048, C = 72) that is at most ~2.9 MB of logits read
// when fused and 350 * 72 * 12 B = 302 KB written by topk: about a
// microsecond at 3.35 TB/s, so launch latency dominates.
//
// What the design does about it: one thread block per beam row, no
// staging beyond what the row needs.  The TPU kernel's compare-broadcast
// projection, beam tiling and DMA semaphores worked around the TPU's
// missing VMEM scatter (DESIGN.md §3.3); here the row is a plain gather of
// the valid slots' log-probs, the mask variant scatters them (the paper's
// form), and the top-C selection is a rank-by-counting pass in shared
// memory: rank[j] = #{j' : key[j'] > key[j] or (key[j'] == key[j] and
// j' < j)}.  The index tie-break is the dense path's flat-index order
// (slots are token-ascending), which bit-identity rests on (DESIGN.md §8).
// Only slots below n_child are read, so a burst never leaves the row; the
// builder's tail pad still bounds the speculative width bmax.
//
// The launchers return cudaGetLastError() of the launch; the caller raises
// on a non-zero value.  They launch on the caller's stream and allocate
// nothing.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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
// receives the block's sum.  Every thread of the block must call it.
__device__ __forceinline__ int block_scan(int v, int* part, int& total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? part[lane] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    if (lane < kWarps) part[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += part[warp - 1];
  total = part[kWarps - 1];
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
// block must call it (n_real is the same for all of them).
template <bool STACKED, typename Edge, typename Slot>
__device__ __forceinline__ void for_each_delta_slot(
    const Member<STACKED, Edge>& mem, int start, int n_real, int* part,
    Slot slot) {
  int carry = 0;  // the tokens' prefix sum over the chunks before
  for (int c0 = 0; c0 < n_real; c0 += kThreads) {
    const int j = c0 + threadIdx.x;
    const int d = j < n_real ? static_cast<int>(mem.edges[start + j]) : 0;
    int total;
    const int tok = carry + block_scan(d, part, total);
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
    for_each_delta_slot(mem, start, n_real, part, [&](int j, int tok, int nx) {
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

// One block per beam row: the vocab-aligned masked log-prob row (NEG_INF off
// the trie) and next-state map (0 when invalid), by fill then scatter.
template <bool FUSED, bool STACKED, typename Edge>
__global__ void __launch_bounds__(kThreads) vntk_mask_kernel(
    const float* __restrict__ values, int64_t ld, const int* __restrict__ nodes,
    Tables t, int V, int bmax, float* __restrict__ out_lp,
    int* __restrict__ out_next) {
  __shared__ float red[kWarps];
  __shared__ int part[kWarps];
  const int row = blockIdx.x;
  const RowLogProb<FUSED> lp(values + row * ld, V, red);
  float* o = out_lp + static_cast<int64_t>(row) * V;
  int* on = out_next + static_cast<int64_t>(row) * V;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    o[v] = kNegInf;
    on[v] = 0;
  }
  const Member<STACKED, Edge> mem(t, row);
  const int node = nodes[row];
  const int start = mem.rp[node];
  const int n_real = max(0, min(mem.rp[node + 1] - start, bmax));
  __syncthreads();  // the fill lands before the scatter overwrites it
  // tokens within a row are distinct, so no two slots write one column
  if constexpr (kDelta<Edge>) {
    for_each_delta_slot(mem, start, n_real, part, [&](int, int tok, int nx) {
      if (tok >= 0 && tok < V) {
        o[tok] = lp(tok);
        on[tok] = nx;
      }
    });
  } else {
    for (int j = threadIdx.x; j < n_real; j += kThreads) {
      const int2 e = mem.edges[start + j];
      if (e.x >= 0 && e.x < V) {
        o[e.x] = lp(e.x);
        on[e.x] = e.y;
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

size_t topk_smem_bytes(int bmax, int width) {
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

template <bool FUSED, bool STACKED, typename Edge>
int launch_topk(const Rows& r, const Tables& t) {
  const size_t smem = topk_smem_bytes(r.bmax, r.width);
  const cudaError_t err =
      prepare_smem(vntk_topk_kernel<FUSED, STACKED, Edge>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  vntk_topk_kernel<FUSED, STACKED, Edge><<<r.nb, kThreads, smem, r.stream>>>(
      r.values, r.ld, r.nodes, t, r.V, r.bmax, r.width, r.out_sc, r.out_tok,
      r.out_next);
  return static_cast<int>(cudaGetLastError());
}

template <bool FUSED, bool STACKED, typename Edge>
int launch_mask(const Rows& r, const Tables& t) {
  vntk_mask_kernel<FUSED, STACKED, Edge><<<r.nb, kThreads, 0, r.stream>>>(
      r.values, r.ld, r.nodes, t, r.V, r.bmax, r.out_sc, r.out_next);
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

// Shared memory the topk kernels need for bmax + width candidate keys.
size_t vntk_topk_smem_bytes(int bmax, int width) {
  return topk_smem_bytes(bmax, width);
}

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
