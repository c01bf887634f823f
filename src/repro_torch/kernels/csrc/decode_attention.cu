// Single-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's decode_attention
// (src/repro/models/attention.py) is plain jnp, which the port first
// carried over as plain torch ops (kernels/decode_attention.py,
// decode_attention_plain).  On the card those ops copied the whole beam
// cache twice a layer and step (K permuted to (rows*KVH, Dh, S), V to
// (rows*KVH, S, Dv)), then ran both products as float32-output bmms, which
// cuBLAS sends to sm75 align1 kernels at odd cache lengths (265 on the main
// path), with a chain of elementwise passes over the scores between them.
// This kernel reads the cache where it lies.  It computes, per row b, KV
// head kv and query head h = kv * G + g, the plain version's arithmetic in
// its order:
//
//   s[j] = float32 dot(q[b, h], k[b, j, kv]) * scale
//   s[j] = NEG (-1e30) unless pos[j] >= 0, pos[j] <= cur and, with a
//          window, pos[j] > cur - window
//   p    = softmax(s) in float32: max, exp(s - max), sum, divide;
//          a row with every slot masked gets uniform weights
//   p    rounded to the value dtype, then back to float32
//   out  = sum_j p[j] * v[b, j, kv] in float32, cast to the query's dtype.
//
// Sums run in another order than cuBLAS's, so results differ from the plain
// version on the card by float32 rounding (and a p near a rounding boundary
// of the value dtype may round the other way); a row's result depends on
// that row's inputs alone (no split, route or order depends on the number
// of rows), so a row computed among many equals the row computed alone.
//
// What bounds it: bytes.  G = 3 query heads per KV head do ~3 operations a
// cache byte, two orders below the card's ~295 (bf16), so the least time is
// reading K and V once: 560 rows x 265 slots x 8 heads x 128 x 2 B x 2 =
// 608 MB a call at B = 8, 181 us at 3.35 TB/s.  What the design does:
//   * a block of 128 threads per (row, KV head, group of <= 8 query heads):
//     the queries of a KV head share each K and V byte it reads; 1,120
//     blocks at B = 2 and 4,480 at B = 8, several resident per SM.
//   * K, then V, stream through a ring of kStages shared-memory tiles of 32
//     slots with 16-byte cp.async.cg copies (L2 only), two tiles in flight
//     while a third is used; a slot's head slice (256 B at Dh = 128 bf16) is
//     read whole and in place through the cache's strides, so no permuted
//     copy exists.  Rows are padded to an odd number of 16-byte chunks, so
//     the score loop's 8 slots per quarter-warp hit distinct banks.
//   * scores: each slot takes 4 lanes (a chunk every 4th), the queries held
//     in shared memory as float32 and broadcast; [G, S] float32 scores stay
//     in shared memory (3.2 KB at S = 265, G = 3), and the softmax runs
//     there; V's first tiles are already in flight meanwhile.
//   * P.V: each thread owns one 16-byte chunk of the value row for a subset
//     of slots and accumulates G x (8 bf16) float32 sums in registers; the
//     subsets are added in a fixed order through shared memory at the end,
//     and only the output is written to device memory.
//   * long caches (S > kShortMaxS, whose scores would not fit in shared
//     memory): a split-S route.  Pass 1, a block per 1,024-slot split,
//     writes each split's max and sum of exp(s - max); pass 2, a block per
//     (row, KV head, group), merges them, then streams K and V tile by tile,
//     recomputes each tile's scores, normalises, rounds p and accumulates.
//     The route is chosen by S alone.
//
// The launcher returns cudaGetLastError() of its launches (or
// cudaErrorInvalidValue on arguments it does not take); the caller raises on
// a non-zero value.  It launches on the caller's stream and allocates
// nothing: the split route's statistics live in a buffer the caller passes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;       // cache slots a tile
constexpr int kStages = 3;      // ring tiles: two in flight, one in use
constexpr int kParts = 4;       // lanes a slot in the score loop
constexpr int kSlotsPerWarp = 32 / kParts;
constexpr int kShortMaxS = 1024;  // longest S whose scores stay in shared memory
constexpr int kSplit = 1024;      // slots a split on the long route
constexpr int kSplitGroup = 8;    // query heads a block on the long route
constexpr int kMaxGroup = 8;      // query heads a block at most
constexpr float kNeg = -1.0e30f;

static_assert(kWarps * kSlotsPerWarp == kTile, "a tile is one pass of slots");
static_assert(kSplit % kTile == 0, "splits are whole tiles");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* pos;  // slot positions, int32 or int64
  const void* cur;  // per-row query positions, or null: cur_value
  void* out;        // (B, 1, H, Dv), contiguous, the query's dtype
  float* stats;     // split route: (B, H, nsplit, 2) max and sum
  int64_t q_sb, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t pos_sb, pos_ss;
  int64_t cur_sb, cur_value;
  int64_t window;  // <= 0: none
  int pos_i64, cur_i64;
  int q_dtype;  // 0 float32, 1 bfloat16, 2 float16 (the output's too)
  int B, S, KVH, G, Dh, Dv;
  int n_group, group;  // query-head groups a KV head, heads a group
  int nsplit;
  int row_bytes;  // a ring row: max(Dh, Dv) padded to an odd number of chunks
  float scale;
};

template <typename T>
struct Chunk;  // a 16-byte chunk of T as float32
template <>
struct Chunk<float> {
  static constexpr int n = 4;
  __device__ static void load(const unsigned char* p, float* f) {
    const float4 c = *reinterpret_cast<const float4*>(p);
    f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
  }
  __device__ static float round(float x) { return x; }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const unsigned char* p, float* f) {
    const uint4 c = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h2;
      *reinterpret_cast<unsigned*>(&h2) = w[i];
      const float2 t = __bfloat1622float2(h2);
      f[2 * i] = t.x; f[2 * i + 1] = t.y;
    }
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};
template <>
struct Chunk<__half> {
  static constexpr int n = 8;
  __device__ static void load(const unsigned char* p, float* f) {
    const uint4 c = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __half2 h2;
      *reinterpret_cast<unsigned*>(&h2) = w[i];
      const float2 t = __half22float2(h2);
      f[2 * i] = t.x; f[2 * i + 1] = t.y;
    }
  }
  __device__ static float round(float x) { return __half2float(__float2half(x)); }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float load_q(const void* q, int dtype, int64_t i) {
  if (dtype == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
  if (dtype == 2) return __half2float(static_cast<const __half*>(q)[i]);
  return static_cast<const float*>(q)[i];
}

__device__ __forceinline__ void store_out(void* out, int dtype, int64_t i, float x) {
  if (dtype == 1) static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);
  else if (dtype == 2) static_cast<__half*>(out)[i] = __float2half(x);
  else static_cast<float*>(out)[i] = x;
}

__device__ __forceinline__ int64_t load_int(const void* p, int i64, int64_t i) {
  return i64 ? static_cast<const int64_t*>(p)[i]
             : static_cast<int64_t>(static_cast<const int32_t*>(p)[i]);
}

// What a block works on: row b, KV head kv, query heads kv * G + g0 ...
// + ng - 1, and (split route, pass 1) split sp.
struct Work {
  int b, kv, g0, ng, sp;
  int64_t cur;
};

__device__ __forceinline__ Work work_of(const Params& p, int blk, int nsplit) {
  Work w;
  w.sp = blk % nsplit;
  blk /= nsplit;
  const int gb = blk % p.n_group;
  blk /= p.n_group;
  w.kv = blk % p.KVH;
  w.b = blk / p.KVH;
  w.g0 = gb * p.group;
  w.ng = min(p.group, p.G - w.g0);
  w.cur = p.cur ? load_int(p.cur, p.cur_i64, w.b * p.cur_sb) : p.cur_value;
  return w;
}

__device__ __forceinline__ bool live(const Params& p, const Work& w, int j) {
  const int64_t pos = load_int(p.pos, p.pos_i64, w.b * p.pos_sb + j * p.pos_ss);
  return pos >= 0 && pos <= w.cur && (p.window <= 0 || pos > w.cur - p.window);
}

// The block's queries into shared memory as float32: qs[g * Dh + d].
__device__ void load_queries(const Params& p, const Work& w, float* qs) {
  const int64_t base = w.b * p.q_sb + static_cast<int64_t>(w.kv * p.G + w.g0) * p.q_sh;
  for (int i = threadIdx.x; i < w.ng * p.Dh; i += kThreads) {
    const int g = i / p.Dh, d = i - g * p.Dh;
    qs[i] = load_q(p.q, p.q_dtype, base + g * p.q_sh + d);
  }
}

// Issue the copies of slots [j0, j0 + kTile) of one head's K or V rows
// (`width` elements of T, at slot stride `ss` from `src`) into a ring tile.
template <typename T>
__device__ void issue_tile(unsigned char* tile, const T* src, int64_t ss, int j0,
                           int S, int width, int row_bytes) {
  const int nc = width * static_cast<int>(sizeof(T)) / 16;
  const int n = min(kTile, S - j0) * nc;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int j = i / nc, c = i - j * nc;
    cp_async16(tile + j * row_bytes + c * 16,
               reinterpret_cast<const unsigned char*>(src + (j0 + j) * ss) + c * 16);
  }
}

// Scores of a tile's n slots (cache slots j0 ...) for the block's queries:
// sc[g * stride + at + j] = masked dot * scale.  Four lanes a slot; every
// lane takes part in the shuffles.
template <typename T, int GB>
__device__ void tile_scores(const Params& p, const Work& w, const unsigned char* tile,
                            const float* qs, int j0, int n, float* sc, int stride,
                            int at) {
  constexpr int E = Chunk<T>::n;
  const int lane = threadIdx.x & 31;
  const int j = (threadIdx.x >> 5) * kSlotsPerWarp + lane % kSlotsPerWarp;
  const int part = lane / kSlotsPerWarp;
  const int nc = p.Dh / E;
  float acc[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) acc[g] = 0.0f;
  if (j < n) {
    for (int c = part; c < nc; c += kParts) {
      float kf[E];
      Chunk<T>::load(tile + j * p.row_bytes + c * 16, kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < w.ng) {
          const float4* qv = reinterpret_cast<const float4*>(qs + g * p.Dh + c * E);
#pragma unroll
          for (int e4 = 0; e4 < E / 4; ++e4) {
            const float4 qq = qv[e4];
            acc[g] = fmaf(qq.x, kf[4 * e4], acc[g]);
            acc[g] = fmaf(qq.y, kf[4 * e4 + 1], acc[g]);
            acc[g] = fmaf(qq.z, kf[4 * e4 + 2], acc[g]);
            acc[g] = fmaf(qq.w, kf[4 * e4 + 3], acc[g]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], kSlotsPerWarp);
    acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], 2 * kSlotsPerWarp);
  }
  if (part == 0 && j < n) {
    const bool ok = live(p, w, j0 + j);
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < w.ng) sc[g * stride + at + j] = ok ? acc[g] * p.scale : kNeg;
  }
}

// P.V of a tile's n slots into the thread's accumulators: thread t owns
// value chunk t % nc for the slots j = t / nc (mod kThreads / nc).
template <typename T, int GB>
__device__ void tile_pv(const Params& p, const Work& w, const unsigned char* tile,
                        const float* sc, int stride, int at, int n,
                        float (&acc)[GB][Chunk<T>::n]) {
  constexpr int E = Chunk<T>::n;
  const int nc = p.Dv / E, lanes = kThreads / nc;
  const int c = threadIdx.x % nc, tl = threadIdx.x / nc;
  if (tl >= lanes) return;
  for (int j = tl; j < n; j += lanes) {
    float vf[E];
    Chunk<T>::load(tile + j * p.row_bytes + c * 16, vf);
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < w.ng) {
        const float pg = sc[g * stride + at + j];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
      }
    }
  }
}

// Add the slot subsets' sums in order and write the block's outputs.  `red`
// may alias the ring: every copy has landed and been read.
template <typename T, int GB>
__device__ void write_out(const Params& p, const Work& w, float (&acc)[GB][Chunk<T>::n],
                          float* red) {
  constexpr int E = Chunk<T>::n;
  const int nc = p.Dv / E, lanes = kThreads / nc;
  const int c = threadIdx.x % nc, tl = threadIdx.x / nc;
  if (tl < lanes) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < w.ng)
#pragma unroll
        for (int e = 0; e < E; ++e) red[(tl * GB + g) * p.Dv + c * E + e] = acc[g][e];
  }
  __syncthreads();
  const int64_t head0 = static_cast<int64_t>(w.b) * p.KVH * p.G + w.kv * p.G + w.g0;
  for (int i = threadIdx.x; i < w.ng * p.Dv; i += kThreads) {
    const int g = i / p.Dv, d = i - g * p.Dv;
    float s = red[g * p.Dv + d];
    for (int t = 1; t < lanes; ++t) s += red[(t * GB + g) * p.Dv + d];
    store_out(p.out, p.q_dtype, (head0 + g) * p.Dv + d, s);
  }
}

// Block-wide max (MAX) or sum of x[g], the same value in every thread.
template <int GB, bool MAX>
__device__ void block_reduce(float (&x)[GB], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[g], off);
      x[g] = MAX ? fmaxf(x[g], y) : x[g] + y;
    }
    if (lane == 0) scratch[warp * GB + g] = x[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float r = scratch[g];
    for (int i = 1; i < kWarps; ++i) r = MAX ? fmaxf(r, scratch[i * GB + g]) : r + scratch[i * GB + g];
    x[g] = r;
  }
  __syncthreads();
}

// Max and sum of exp(s - max) over n scores of each query row; with
// NORMALISE the row becomes p = exp(s - max) / sum rounded to T.
template <typename T, int GB, bool NORMALISE>
__device__ void softmax_rows(const Work& w, float* sc, int stride, int n, float* scratch,
                             float (&mx)[GB], float (&sum)[GB]) {
#pragma unroll
  for (int g = 0; g < GB; ++g) { mx[g] = -INFINITY; sum[g] = 0.0f; }
  for (int j = threadIdx.x; j < n; j += kThreads)
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < w.ng) mx[g] = fmaxf(mx[g], sc[g * stride + j]);
  block_reduce<GB, true>(mx, scratch);
  for (int j = threadIdx.x; j < n; j += kThreads)
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < w.ng) {
        const float e = expf(sc[g * stride + j] - mx[g]);
        if (NORMALISE) sc[g * stride + j] = e;
        sum[g] += e;
      }
  block_reduce<GB, false>(sum, scratch);
  if (NORMALISE) {
    for (int j = threadIdx.x; j < n; j += kThreads)
#pragma unroll
      for (int g = 0; g < GB; ++g)
        if (g < w.ng) sc[g * stride + j] = Chunk<T>::round(sc[g * stride + j] / sum[g]);
    __syncthreads();
  }
}

__device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t{15}; }

// Shared memory: [ring | reduction, aliased] [queries] [scores] [scratch].
struct Smem {
  unsigned char* ring;
  float* red;
  float* qs;
  float* sc;
  float* scratch;
};

__host__ __device__ inline size_t ring_bytes(int row_bytes) {
  return static_cast<size_t>(kStages) * kTile * row_bytes;
}

template <typename T>
__host__ __device__ inline size_t red_bytes(int group, int Dv) {
  const int nc = Dv * static_cast<int>(sizeof(T)) / 16;
  return static_cast<size_t>(kThreads / nc) * group * Dv * sizeof(float);
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(int group, int Dh, int Dv, int row_bytes,
                                             int sc_len) {
  const size_t a = ring_bytes(row_bytes), r = red_bytes<T>(group, Dv);
  return ((a > r ? a : r) + 15) / 16 * 16 + (group * Dh * sizeof(float) + 15) / 16 * 16 +
         (static_cast<size_t>(group) * sc_len * sizeof(float) + 15) / 16 * 16 +
         2 * kWarps * kMaxGroup * sizeof(float);
}

template <typename T>
__device__ Smem carve(unsigned char* base, const Params& p, int group, int sc_len) {
  Smem s;
  const size_t a = ring_bytes(p.row_bytes), r = red_bytes<T>(group, p.Dv);
  s.ring = base;
  s.red = reinterpret_cast<float*>(base);
  base += align16(a > r ? a : r);
  s.qs = reinterpret_cast<float*>(base);
  base += align16(group * p.Dh * sizeof(float));
  s.sc = reinterpret_cast<float*>(base);
  base += align16(static_cast<size_t>(group) * sc_len * sizeof(float));
  s.scratch = reinterpret_cast<float*>(base);
  return s;
}

// The short route: one block per (row, KV head, query group) holds the
// group's [ng, S] scores in shared memory.  Ring tiles 0 .. nt-1 are K's,
// nt .. 2nt-1 V's.
template <typename T, int GB>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = Chunk<T>::n;
  const Work w = work_of(p, blockIdx.x, 1);
  const Smem s = carve<T>(smem, p, GB, p.S);
  const T* kb = static_cast<const T*>(p.k) + w.b * p.k_sb + w.kv * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + w.b * p.v_sb + w.kv * p.v_sh;
  const int nt = (p.S + kTile - 1) / kTile, total = 2 * nt;
  const int tile_bytes = kTile * p.row_bytes;
  auto issue = [&](int t) {
    unsigned char* dst = s.ring + (t % kStages) * tile_bytes;
    if (t < nt) issue_tile(dst, kb, p.k_ss, t * kTile, p.S, p.Dh, p.row_bytes);
    else issue_tile(dst, vb, p.v_ss, (t - nt) * kTile, p.S, p.Dv, p.row_bytes);
  };
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < total) issue(t);
    cp_commit();
  }
  load_queries(p, w, s.qs);
  float acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  for (int t = 0; t < total; ++t) {
    cp_wait<kStages - 2>();
    __syncthreads();  // tile t landed for all; tile t - 1 is free
    if (t + kStages - 1 < total) issue(t + kStages - 1);
    cp_commit();
    const unsigned char* tile = s.ring + (t % kStages) * tile_bytes;
    if (t < nt) {
      const int j0 = t * kTile;
      tile_scores<T, GB>(p, w, tile, s.qs, j0, min(kTile, p.S - j0), s.sc, p.S, j0);
      if (t == nt - 1) {
        __syncthreads();
        float mx[GB], sum[GB];
        softmax_rows<T, GB, true>(w, s.sc, p.S, p.S, s.scratch, mx, sum);
      }
    } else {
      const int j0 = (t - nt) * kTile;
      tile_pv<T, GB>(p, w, tile, s.sc, p.S, j0, min(kTile, p.S - j0), acc);
    }
  }
  cp_wait<0>();
  __syncthreads();
  write_out<T, GB>(p, w, acc, s.red);
}

// Long route, pass 1: block (row, KV head, group, split) writes its split's
// max and sum of exp(s - max) for each query head.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attn_split_stats_kernel(
    const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int GB = kSplitGroup;
  const Work w = work_of(p, blockIdx.x, p.nsplit);
  const Smem s = carve<T>(smem, p, GB, kSplit);
  const T* kb = static_cast<const T*>(p.k) + w.b * p.k_sb + w.kv * p.k_sh;
  const int first = w.sp * kSplit, n_slots = min(kSplit, p.S - first);
  const int nt = (n_slots + kTile - 1) / kTile;
  const int tile_bytes = kTile * p.row_bytes;
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nt)
      issue_tile(s.ring + t * tile_bytes, kb, p.k_ss, first + t * kTile, p.S, p.Dh,
                 p.row_bytes);
    cp_commit();
  }
  load_queries(p, w, s.qs);
  for (int t = 0; t < nt; ++t) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int nx = t + kStages - 1;
    if (nx < nt)
      issue_tile(s.ring + (nx % kStages) * tile_bytes, kb, p.k_ss, first + nx * kTile,
                 p.S, p.Dh, p.row_bytes);
    cp_commit();
    const int j0 = t * kTile;
    tile_scores<T, GB>(p, w, s.ring + (t % kStages) * tile_bytes, s.qs, first + j0,
                       min(kTile, n_slots - j0), s.sc, kSplit, j0);
  }
  cp_wait<0>();
  __syncthreads();
  float mx[GB], sum[GB];
  softmax_rows<T, GB, false>(w, s.sc, kSplit, n_slots, s.scratch, mx, sum);
  const int g = threadIdx.x;
  if (g < w.ng) {
    const int64_t h = static_cast<int64_t>(w.b) * p.KVH * p.G + w.kv * p.G + w.g0 + g;
    // per-thread copies of mx/sum are equal; index by the owning g
    float m = 0.0f, l = 0.0f;
#pragma unroll
    for (int i = 0; i < GB; ++i)
      if (i == g) { m = mx[i]; l = sum[i]; }
    p.stats[(h * p.nsplit + w.sp) * 2] = m;
    p.stats[(h * p.nsplit + w.sp) * 2 + 1] = l;
  }
}

// Long route, pass 2: block (row, KV head, group) merges the splits'
// statistics, then streams K and V tile by tile: each K tile's scores
// become p = exp(s - max) / sum rounded to T, and the next (V) tile adds
// p.V.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attn_split_kernel(
    const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int GB = kSplitGroup;
  constexpr int E = Chunk<T>::n;
  const Work w = work_of(p, blockIdx.x, 1);
  const Smem s = carve<T>(smem, p, GB, kTile);
  const T* kb = static_cast<const T*>(p.k) + w.b * p.k_sb + w.kv * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + w.b * p.v_sb + w.kv * p.v_sh;
  const int nt = (p.S + kTile - 1) / kTile, total = 2 * nt;
  const int tile_bytes = kTile * p.row_bytes;
  auto issue = [&](int t) {
    unsigned char* dst = s.ring + (t % kStages) * tile_bytes;
    const int j0 = (t / 2) * kTile;
    if (t % 2 == 0) issue_tile(dst, kb, p.k_ss, j0, p.S, p.Dh, p.row_bytes);
    else issue_tile(dst, vb, p.v_ss, j0, p.S, p.Dv, p.row_bytes);
  };
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < total) issue(t);
    cp_commit();
  }
  load_queries(p, w, s.qs);
  float mx[GB], sum[GB];
  const int64_t head0 = static_cast<int64_t>(w.b) * p.KVH * p.G + w.kv * p.G + w.g0;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    mx[g] = -INFINITY;
    sum[g] = 0.0f;
    if (g < w.ng) {
      const float* st = p.stats + (head0 + g) * p.nsplit * 2;
      for (int i = 0; i < p.nsplit; ++i) mx[g] = fmaxf(mx[g], st[2 * i]);
      for (int i = 0; i < p.nsplit; ++i) sum[g] += st[2 * i + 1] * expf(st[2 * i] - mx[g]);
    }
  }
  float acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  for (int t = 0; t < total; ++t) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < total) issue(t + kStages - 1);
    cp_commit();
    const unsigned char* tile = s.ring + (t % kStages) * tile_bytes;
    const int j0 = (t / 2) * kTile, n = min(kTile, p.S - j0);
    if (t % 2 == 0) {
      tile_scores<T, GB>(p, w, tile, s.qs, j0, n, s.sc, kTile, 0);
      __syncthreads();
      for (int i = threadIdx.x; i < w.ng * kTile; i += kThreads) {
        const int g = i / kTile, j = i - g * kTile;
        float m = 0.0f, l = 1.0f;
#pragma unroll
        for (int k = 0; k < GB; ++k)
          if (k == g) { m = mx[k]; l = sum[k]; }
        if (j < n) s.sc[i] = Chunk<T>::round(expf(s.sc[i] - m) / l);
      }
    } else {
      tile_pv<T, GB>(p, w, tile, s.sc, kTile, 0, n, acc);
    }
  }
  cp_wait<0>();
  __syncthreads();
  write_out<T, GB>(p, w, acc, s.red);
}

template <typename K>
cudaError_t launch(K kernel, const Params& p, int blocks, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(Params& p, cudaStream_t stream) {
  const int64_t heads = static_cast<int64_t>(p.B) * p.KVH * p.n_group;
  if (p.S > kShortMaxS) {
    p.nsplit = (p.S + kSplit - 1) / kSplit;
    cudaError_t err = launch(decode_attn_split_stats_kernel<T>, p,
                             static_cast<int>(heads * p.nsplit),
                             smem_bytes<T>(kSplitGroup, p.Dh, p.Dv, p.row_bytes, kSplit),
                             stream);
    if (err != cudaSuccess) return err;
    return launch(decode_attn_split_kernel<T>, p, static_cast<int>(heads),
                  smem_bytes<T>(kSplitGroup, p.Dh, p.Dv, p.row_bytes, kTile), stream);
  }
  p.nsplit = 1;
  const int blocks = static_cast<int>(heads);
  switch (p.group) {
    case 1:
      return launch(decode_attn_kernel<T, 1>, p, blocks,
                    smem_bytes<T>(1, p.Dh, p.Dv, p.row_bytes, p.S), stream);
    case 2:
      return launch(decode_attn_kernel<T, 2>, p, blocks,
                    smem_bytes<T>(2, p.Dh, p.Dv, p.row_bytes, p.S), stream);
    case 3:
      return launch(decode_attn_kernel<T, 3>, p, blocks,
                    smem_bytes<T>(3, p.Dh, p.Dv, p.row_bytes, p.S), stream);
    case 4:
      return launch(decode_attn_kernel<T, 4>, p, blocks,
                    smem_bytes<T>(4, p.Dh, p.Dv, p.row_bytes, p.S), stream);
    default:
      return launch(decode_attn_kernel<T, kMaxGroup>, p, blocks,
                    smem_bytes<T>(kMaxGroup, p.Dh, p.Dv, p.row_bytes, p.S), stream);
  }
}

}  // namespace

extern "C" {

// The longest cache the short route takes, and the split length beyond it.
int decode_attention_short_max_s() { return kShortMaxS; }
int decode_attention_split_s() { return kSplit; }

// dtype / q_dtype: 0 float32, 1 bfloat16, 2 float16.  Strides in elements.
// cur == null: every row's query position is cur_value.  window <= 0: none.
// stats: B * H * ceil(S / split) * 2 floats when S > short_max_s, else
// unused.  out: (B, 1, H, Dv) contiguous.
int decode_attention_launch(int dtype, int q_dtype, const void* q, int64_t q_sb,
                            int64_t q_sh, const void* k, int64_t k_sb, int64_t k_ss,
                            int64_t k_sh, const void* v, int64_t v_sb, int64_t v_ss,
                            int64_t v_sh, const void* pos, int64_t pos_sb, int64_t pos_ss,
                            int pos_i64, const void* cur, int64_t cur_sb, int cur_i64,
                            int64_t cur_value, int64_t window, void* out, float* stats,
                            int B, int S, int KVH, int G, int Dh, int Dv, float scale,
                            void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || q_dtype < 0 || q_dtype > 2 || B < 0 || S < 1 ||
      KVH < 1 || G < 1 || Dh % 8 || Dv % 8 || Dh < 8 || Dv < 8 || Dh > 256 || Dv > 256 ||
      (S > kShortMaxS && stats == nullptr))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  Params p{};
  p.q = q; p.k = k; p.v = v; p.pos = pos; p.cur = cur; p.out = out; p.stats = stats;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.pos_sb = pos_sb; p.pos_ss = pos_ss; p.pos_i64 = pos_i64;
  p.cur_sb = cur_sb; p.cur_i64 = cur_i64; p.cur_value = cur_value;
  p.window = window;
  p.q_dtype = q_dtype;
  p.B = B; p.S = S; p.KVH = KVH; p.G = G; p.Dh = Dh; p.Dv = Dv;
  p.scale = scale;
  p.n_group = (G + kMaxGroup - 1) / kMaxGroup;
  const int per = (G + p.n_group - 1) / p.n_group;
  p.group = S > kShortMaxS ? per : (per <= 4 ? per : kMaxGroup);
  const int chunks = (Dh > Dv ? Dh : Dv) * esize / 16;
  p.row_bytes = 16 * (chunks | 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return run<__nv_bfloat16>(p, st);
  if (dtype == 2) return run<__half>(p, st);
  return run<float>(p, st);
}

}  // extern "C"
