// Vectorized Node Transition Kernel (paper Alg. 2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/vntk.py:
//   * vntk_topk_kernel<FUSED, false> <- vntk_topk_pallas (fused_logsoftmax=
//                                 False/True) (_vntk_topk_call,
//                                 _vntk_topk_body, _dma_front,
//                                 _project_and_select)
//   * vntk_mask_kernel<FUSED, false> <- vntk_pallas /
//                                 vntk_fused_logsoftmax_pallas (_vntk_call,
//                                 _vntk_body, _project_and_write)
//   * vntk_topk_kernel<FUSED, true>  <- vntk_stacked_topk_pallas (both modes;
//                                 _vntk_topk_call's stacked branch,
//                                 _vntk_stacked_topk_body)
//   * vntk_mask_kernel<FUSED, true>  <- vntk_stacked_pallas /
//                                 vntk_stacked_fused_logsoftmax_pallas
//                                 (_vntk_stacked_call, _vntk_stacked_body)
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
// What bounds it on this card: bytes.  Per beam row the step reads its
// constraint id (STACKED), one CSR row pointer pair, at most n_child
// (token, next) pairs and, when FUSED, the whole (V,) f32 logit row; it
// writes (C,) scores/tokens/next states (topk) or the (V,) masked row and
// (V,) next-state map (mask).  At the main paths' shapes (nb = 140 single
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

// The CSR tables of row `row`'s constraint set: the store's member
// clamp(cids[row], 0, K-1) when STACKED, else the single matrix.
template <bool STACKED>
struct Member {
  const int* rp;
  const int2* edges;

  __device__ __forceinline__ Member(const int* row_pointers, const int2* e,
                                    const int* cids, int K, int64_t rp_stride,
                                    int64_t edge_stride, int row)
      : rp(row_pointers), edges(e) {
    if (!STACKED) return;
    const int64_t k = min(max(cids[row], 0), K - 1);
    rp += k * rp_stride;
    edges += k * edge_stride;
  }
};

// One block per beam row: per-beam dense-rank top-`width` of the CSR row of
// nodes[row] — valid children by (lp desc, token asc), then the first
// missing tokens at NEG_INF; slots that do not exist sink to -FLT_MAX.
template <bool FUSED, bool STACKED>
__global__ void __launch_bounds__(kThreads) vntk_topk_kernel(
    const float* __restrict__ values, int64_t ld, const int* __restrict__ nodes,
    const int* __restrict__ cids, int K, const int* __restrict__ row_pointers,
    int64_t rp_stride, const int2* __restrict__ edges, int64_t edge_stride,
    int V, int bmax, int width, float* __restrict__ out_sc,
    int* __restrict__ out_tok, int* __restrict__ out_next) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  const int J = bmax + width;
  float* keys = reinterpret_cast<float*>(smem);
  int* toks = reinterpret_cast<int*>(keys + J);
  int* nexts = toks + J;

  const int row = blockIdx.x;
  const RowLogProb<FUSED> lp(values + row * ld, V, red);
  const Member<STACKED> mem(row_pointers, edges, cids, K, rp_stride,
                            edge_stride, row);
  const int node = nodes[row];
  const int start = mem.rp[node];
  const int n_child = mem.rp[node + 1] - start;
  const int n_real = max(0, min(n_child, bmax));

  // candidate slots of the CSR row (token-ascending)
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
template <bool FUSED, bool STACKED>
__global__ void __launch_bounds__(kThreads) vntk_mask_kernel(
    const float* __restrict__ values, int64_t ld, const int* __restrict__ nodes,
    const int* __restrict__ cids, int K, const int* __restrict__ row_pointers,
    int64_t rp_stride, const int2* __restrict__ edges, int64_t edge_stride,
    int V, int bmax, float* __restrict__ out_lp, int* __restrict__ out_next) {
  __shared__ float red[kWarps];
  const int row = blockIdx.x;
  const RowLogProb<FUSED> lp(values + row * ld, V, red);
  float* o = out_lp + static_cast<int64_t>(row) * V;
  int* on = out_next + static_cast<int64_t>(row) * V;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    o[v] = kNegInf;
    on[v] = 0;
  }
  const Member<STACKED> mem(row_pointers, edges, cids, K, rp_stride,
                            edge_stride, row);
  const int node = nodes[row];
  const int start = mem.rp[node];
  const int n_real = max(0, min(mem.rp[node + 1] - start, bmax));
  __syncthreads();  // the fill lands before the scatter overwrites it
  for (int j = threadIdx.x; j < n_real; j += kThreads) {
    const int2 e = mem.edges[start + j];
    if (e.x >= 0 && e.x < V) {  // tokens within a row are distinct
      o[e.x] = lp(e.x);
      on[e.x] = e.y;
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

template <bool FUSED, bool STACKED>
int launch_topk(const float* values, int64_t ld, const int* nodes,
                const int* cids, int K, const int* row_pointers,
                int64_t rp_stride, const int* edges, int64_t edge_stride,
                int nb, int V, int bmax, int width, float* out_sc,
                int* out_tok, int* out_next, cudaStream_t stream) {
  const size_t smem = topk_smem_bytes(bmax, width);
  const cudaError_t err = prepare_smem(vntk_topk_kernel<FUSED, STACKED>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  vntk_topk_kernel<FUSED, STACKED><<<nb, kThreads, smem, stream>>>(
      values, ld, nodes, cids, K, row_pointers, rp_stride,
      reinterpret_cast<const int2*>(edges), edge_stride, V, bmax, width,
      out_sc, out_tok, out_next);
  return static_cast<int>(cudaGetLastError());
}

template <bool FUSED, bool STACKED>
int launch_mask(const float* values, int64_t ld, const int* nodes,
                const int* cids, int K, const int* row_pointers,
                int64_t rp_stride, const int* edges, int64_t edge_stride,
                int nb, int V, int bmax, float* out_lp, int* out_next,
                cudaStream_t stream) {
  vntk_mask_kernel<FUSED, STACKED><<<nb, kThreads, 0, stream>>>(
      values, ld, nodes, cids, K, row_pointers, rp_stride,
      reinterpret_cast<const int2*>(edges), edge_stride, V, bmax, out_lp,
      out_next);
  return static_cast<int>(cudaGetLastError());
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
  return fused ? launch_topk<true, false>(values, ld, nodes, nullptr, 1,
                                          row_pointers, 0, edges, 0, nb, V,
                                          bmax, width, out_sc, out_tok,
                                          out_next, stream)
               : launch_topk<false, false>(values, ld, nodes, nullptr, 1,
                                           row_pointers, 0, edges, 0, nb, V,
                                           bmax, width, out_sc, out_tok,
                                           out_next, stream);
}

int vntk_mask_launch(const float* values, int64_t ld, const int* nodes,
                     const int* row_pointers, const int* edges, int nb, int V,
                     int bmax, int fused, float* out_lp, int* out_next,
                     cudaStream_t stream) {
  return fused ? launch_mask<true, false>(values, ld, nodes, nullptr, 1,
                                          row_pointers, 0, edges, 0, nb, V,
                                          bmax, out_lp, out_next, stream)
               : launch_mask<false, false>(values, ld, nodes, nullptr, 1,
                                           row_pointers, 0, edges, 0, nb, V,
                                           bmax, out_lp, out_next, stream);
}

// Stacked store: rp_stride = S + 1 row pointers and edge_stride = E edge
// pairs per member, K members.
int vntk_stacked_topk_launch(const float* values, int64_t ld, const int* nodes,
                             const int* cids, int K, const int* row_pointers,
                             int64_t rp_stride, const int* edges,
                             int64_t edge_stride, int nb, int V, int bmax,
                             int width, int fused, float* out_sc, int* out_tok,
                             int* out_next, cudaStream_t stream) {
  return fused ? launch_topk<true, true>(values, ld, nodes, cids, K,
                                         row_pointers, rp_stride, edges,
                                         edge_stride, nb, V, bmax, width,
                                         out_sc, out_tok, out_next, stream)
               : launch_topk<false, true>(values, ld, nodes, cids, K,
                                          row_pointers, rp_stride, edges,
                                          edge_stride, nb, V, bmax, width,
                                          out_sc, out_tok, out_next, stream);
}

int vntk_stacked_mask_launch(const float* values, int64_t ld, const int* nodes,
                             const int* cids, int K, const int* row_pointers,
                             int64_t rp_stride, const int* edges,
                             int64_t edge_stride, int nb, int V, int bmax,
                             int fused, float* out_lp, int* out_next,
                             cudaStream_t stream) {
  return fused ? launch_mask<true, true>(values, ld, nodes, cids, K,
                                         row_pointers, rp_stride, edges,
                                         edge_stride, nb, V, bmax, out_lp,
                                         out_next, stream)
               : launch_mask<false, true>(values, ld, nodes, cids, K,
                                          row_pointers, rp_stride, edges,
                                          edge_stride, nb, V, bmax, out_lp,
                                          out_next, stream);
}

}  // extern "C"
