// Fixed-arity EmbeddingBag (the recsys models' sparse lookup) for Hopper
// (sm_90a), over one table or a group of up to 64 tables of one width.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/embedding_bag.py
// (embedding_bag_pallas, _bag_body).  The function is the same, per table f
// of a group and per bag b:
//
//   out[b, f] = sum_{k = 0..K-1} table_f[clamp(ids[b, f, k], 0, R_f)]
//   out[b, f] /= K                                 when mode == "mean"
//   out[b, f]  cast once to the tables' type (float32 or bfloat16)
//
// over (R_f+1, D) tables whose row R_f is the zero sentinel (padding of a
// bag to K ids).  The sum is taken in float32, first row first, exactly as
// the plain version adds, so the two are equal bit for bit (a mean differs
// by torch's product with 1/K on the card).  Its block structure is not the
// TPU kernel's: that one copies each row of a tile of bags into VMEM with
// one blocking DMA per row and reduces the tile there.
//
// What bounds it on this card: bytes.  Per bag it reads K ids and K rows at
// random addresses (each at least one 32-byte sector) and writes D outputs;
// at serve_p99 (B = 512) the launch dominates.  A design that keeps one row
// of one bag in flight per warp (a thread per output element, the id load,
// then the row load) is latency-bound: ~8 KB in flight per SM at ~0.8 us
// per random read gives ~1.3 TB/s.  What this design does:
//   * one launch for a group: every table's base pointer and row count is
//     passed by value in a __grid_constant__ struct (no device pointer
//     array, no copy, no allocation), copied to shared memory once per
//     block; work item w = b * F + f reads the (B, F, K) id batch in place
//     through its strides and writes the (B, F, D) output, so consecutive
//     items read consecutive ids and write consecutive rows.  F = 1 (the
//     single-table entry) reads its one table from the parameters.
//   * 16-byte rows ("v16") where D * sizeof(T) is a multiple of 16 and
//     every table and the output are 16-byte aligned (the wrapper chooses;
//     the launcher checks): a row takes D * sizeof(T) / 16 lanes (8 for
//     D = 32 float32, so a warp covers 4 bags), loaded with
//     ld.global.nc.L1::no_allocate.v4 and stored with __stcs; bf16 rows
//     carry 8 values per load and are summed in float32.  Other rows (D = 1,
//     D = 10, a misaligned view) take the scalar path: one element a lane.
//   * many bags in flight: each thread owns kBagsPerThread bags, loads all
//     their ids, then issues all their row loads before it adds anything
//     (K > 1 repeats this per k, in order).  The grid is the card's resident
//     blocks and strides over the items, so the bytes in flight per SM rise
//     by an order of magnitude and random-read efficiency sets the pace.  A
//     launch too small to give each SM a block (B = 512) takes one bag a
//     thread instead, so its one round trip is spread over more SMs.
//   * a row's lanes are the next power of two of its 16-byte (or element)
//     chunks, at most 32 (idle lanes return; wider rows loop), so items and
//     chunks come from shifts; b = w / F is a multiply-high and a shift.
// Also: ids clamped into each table's [0, R_f] (the model path's
// jnp.take(mode="clip")); int64 row offsets (DLRM-MLPerf's largest table,
// 39,979,776 x 128 floats, holds 5.1e9 elements); any D >= 1; any bag stride.
// No TMA: on Hopper it cannot gather scattered rows, and staging rows in
// shared memory would add a copy and save nothing.
//
// The launchers return cudaGetLastError() of the launch (or an argument
// error before it); the caller raises on a non-zero value.  They launch on
// the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBagsPerThread = 4;  // bags whose rows one thread has in flight
constexpr int kMaxTables = 64;     // tables of one grouped launch
constexpr int kMaxDevices = 64;
constexpr int64_t kMaxItems = int64_t{1} << 31;  // B * F: the divider's range

template <int kMaxF>
struct Tables {
  const void* ptr[kMaxF];
  int64_t rows[kMaxF];  // R_f + 1, the sentinel included
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// One chunk of a row: an element (scalar path) or 16 bytes (v16 path).
template <typename T, bool kV16>
struct Chunk;

template <typename T>
struct Chunk<T, false> {
  using Raw = T;
  static constexpr int kElems = 1;
  __device__ static Raw load(const Raw* p) { return *p; }
  __device__ static void unpack(Raw r, float* x) { x[0] = to_f32(r); }
  __device__ static void store(Raw* p, const float* x) {
    *p = from_f32<T>(x[0]);
  }
};

template <typename T>
struct Chunk<T, true> {
  using Raw = uint4;
  static constexpr int kElems = 16 / sizeof(T);
  __device__ static Raw load(const Raw* p) {
    Raw r;  // read-only path, not kept in L1: a random row is read once
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p));
    return r;
  }
  __device__ static void unpack(Raw r, float* x) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        x[i] = __uint_as_float(w[i]);
      } else {  // two bf16, the first in the low half (exact widening)
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
  __device__ static void store(Raw* p, const float* x) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(x[i]);
      } else {
        w[i] = static_cast<uint32_t>(
                   __bfloat16_as_ushort(__float2bfloat16(x[2 * i]))) |
               (static_cast<uint32_t>(
                    __bfloat16_as_ushort(__float2bfloat16(x[2 * i + 1])))
                << 16);
      }
    }
    __stcs(p, make_uint4(w[0], w[1], w[2], w[3]));  // streaming: not re-read
  }
};

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31, from the wrapper's (mul, shift)
// of d (torch's IntDivider): ((n * mul) >> 32) + n, shifted right.
__device__ __forceinline__ uint32_t fast_div(uint32_t n, uint32_t mul,
                                             uint32_t shift) {
  return (__umulhi(n, mul) + n) >> shift;
}

// kSlots: bags one thread owns at a time (4 for large launches, 1 for those
// too small to give every SM a block).  Item indices are 32-bit (B * F <
// 2^31); id, row and output offsets are 64-bit.
template <typename T, bool kV16, int kMaxF, int kSlots>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const __grid_constant__ Tables<kMaxF> tables,
                         int n_tables, uint32_t f_mul, uint32_t f_shift,
                         uint32_t n_items, const int* __restrict__ ids,
                         int64_t id_stride_b, int64_t id_stride_f, int k,
                         int row_chunks, int lanes_log2,
                         int64_t out_stride_b, int mean, T* __restrict__ out) {
  using C = Chunk<T, kV16>;
  using Raw = typename C::Raw;
  constexpr int kE = C::kElems;

  __shared__ const Raw* s_ptr[kMaxF];
  __shared__ int64_t s_rows[kMaxF];
  if constexpr (kMaxF > 1) {
    for (int i = threadIdx.x; i < n_tables; i += kThreads) {
      s_ptr[i] = static_cast<const Raw*>(tables.ptr[i]);
      s_rows[i] = tables.rows[i];
    }
    __syncthreads();
  }

  const uint32_t lane = threadIdx.x & 31;
  const int lanes = 1 << lanes_log2;
  const int c0 = lane & (lanes - 1);  // this lane's first chunk of a row
  if (c0 >= row_chunks) return;  // idle lane of a narrow row (no barrier after)
  const uint32_t per_warp = 32u >> lanes_log2;       // items per warp per slot
  const uint32_t layer = kWarps * per_warp;          // ... per block
  const uint32_t tile = layer * kSlots;              // ... per block per step
  const uint32_t sub = (threadIdx.x >> 5) * per_warp + (lane >> lanes_log2);
  Raw* const out_raw = reinterpret_cast<Raw*>(out);

  for (uint32_t first = blockIdx.x * tile + sub; first < n_items;
       first += gridDim.x * tile) {
    // item of slot u, and its table f and bag b (a slot past the end repeats
    // the first, which is live, and is not stored)
    uint32_t b[kSlots], f[kSlots];
    bool live[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const uint32_t w = first + u * layer;
      live[u] = w < n_items;
      const uint32_t item = live[u] ? w : first;
      if constexpr (kMaxF > 1) {
        b[u] = fast_div(item, f_mul, f_shift);
        f[u] = item - b[u] * n_tables;
      } else {
        b[u] = item;
        f[u] = 0;
      }
    }
    for (int c = c0; c < row_chunks; c += lanes) {
      float acc[kSlots][kE];
      for (int j = 0; j < k; ++j) {
        const Raw* src[kSlots];
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {  // every slot's id first ...
          const Raw* base = kMaxF > 1 ? s_ptr[f[u]]
                                      : static_cast<const Raw*>(tables.ptr[0]);
          const int64_t n_rows = kMaxF > 1 ? s_rows[f[u]] : tables.rows[0];
          int64_t row = ids[b[u] * id_stride_b + f[u] * id_stride_f + j];
          row = row < 0 ? 0 : (row < n_rows ? row : n_rows - 1);
          src[u] = base + row * row_chunks + c;
        }
        Raw raw[kSlots];
#pragma unroll
        for (int u = 0; u < kSlots; ++u) raw[u] = C::load(src[u]);  // rows
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {  // ... then the adds, k in order
          float x[kE];
          C::unpack(raw[u], x);
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[u][e] = j ? acc[u][e] + x[e] : x[e];
        }
      }
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        if (!live[u]) continue;
        if (mean) {
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[u][e] = acc[u][e] / static_cast<float>(k);
        }
        C::store(out_raw + b[u] * out_stride_b + f[u] * row_chunks + c,
                 acc[u]);
      }
    }
  }
}

// The current device's SM count and how many blocks of kThreads of the
// large-launch kernel it holds at once, computed once per device.
struct Card {
  int64_t sms, resident;
};

template <typename T, bool kV16, int kMaxF>
Card card() {
  static std::atomic<int> sms_of[kMaxDevices], per_sm_of[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return {1, 1};  // the launch reports the error
  }
  int sms = sms_of[dev].load(std::memory_order_relaxed);
  int per_sm = per_sm_of[dev].load(std::memory_order_relaxed);
  if (sms == 0 || per_sm == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, embedding_bag_kernel<T, kV16, kMaxF, kBagsPerThread>,
        kThreads, 0);
    sms = std::max(1, sms);
    per_sm = std::max(1, per_sm);
    sms_of[dev].store(sms, std::memory_order_relaxed);
    per_sm_of[dev].store(per_sm, std::memory_order_relaxed);
  }
  return {sms, int64_t{sms} * per_sm};
}

struct Args {
  int64_t dim;
  const int* ids;
  int64_t id_stride_b, id_stride_f;
  int k;
  int64_t n_bags;
  uint32_t f_mul, f_shift;
  int mean;
  void* out;
  int64_t out_stride_b;  // elements
  cudaStream_t stream;
};

template <typename T, bool kV16, int kMaxF>
int launch(const Tables<kMaxF>& tables, int n_tables, const Args& a) {
  constexpr int64_t kE = kV16 ? 16 / sizeof(T) : 1;
  const int64_t row_chunks = a.dim / kE;
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (int64_t{1} << lanes_log2) < row_chunks) {
    ++lanes_log2;
  }
  const int64_t n_items = a.n_bags * n_tables;
  auto blocks_for = [&](int slots) {
    const int64_t per_block = int64_t{slots} * kWarps * (32 >> lanes_log2);
    return (n_items + per_block - 1) / per_block;
  };
  // A launch too small to give every SM a block of kBagsPerThread-bag
  // threads (serve_p99's B = 512) takes one bag a thread: its time is one
  // round trip, which more SMs shorten.  (Blocks smaller than kThreads, for
  // still more SMs, measured slower at B = 512 on an H100.)
  const Card card_ = card<T, kV16, kMaxF>();
  const bool large = blocks_for(kBagsPerThread) >= card_.sms;
  const unsigned blocks = static_cast<unsigned>(std::min(
      blocks_for(large ? kBagsPerThread : 1), card_.resident));
  auto kernel = large ? embedding_bag_kernel<T, kV16, kMaxF, kBagsPerThread>
                      : embedding_bag_kernel<T, kV16, kMaxF, 1>;
  kernel<<<blocks, kThreads, 0, a.stream>>>(
      tables, n_tables, a.f_mul, a.f_shift, static_cast<uint32_t>(n_items),
      a.ids, a.id_stride_b, a.id_stride_f, a.k,
      static_cast<int>(row_chunks), lanes_log2, a.out_stride_b / kE, a.mean,
      static_cast<T*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kMaxF>
int dispatch(const Tables<kMaxF>& tables, int n_tables, int bf16, int v16,
             const Args& a) {
  if (n_tables < 1 || n_tables > kMaxF || a.dim < 1 || a.dim >= kMaxItems ||
      a.k < 1 || a.n_bags < 1 || a.n_bags * n_tables >= kMaxItems ||
      a.out_stride_b < n_tables * a.dim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int f = 0; f < n_tables; ++f) {
    if (tables.rows[f] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (v16) {  // 16-byte rows, tables and output rows, or no v16 path
    const int64_t size = bf16 ? 2 : 4;
    bool ok = a.dim * size % 16 == 0 && aligned16(a.out) &&
              a.out_stride_b * size % 16 == 0;
    for (int f = 0; f < n_tables; ++f) ok = ok && aligned16(tables.ptr[f]);
    if (!ok) return static_cast<int>(cudaErrorMisalignedAddress);
    return bf16 ? launch<__nv_bfloat16, true>(tables, n_tables, a)
                : launch<float, true>(tables, n_tables, a);
  }
  return bf16 ? launch<__nv_bfloat16, false>(tables, n_tables, a)
              : launch<float, false>(tables, n_tables, a);
}

}  // namespace

extern "C" {

// One table: (n_rows, dim) contiguous, float32 (bf16 == 0) or bfloat16
// (bf16 == 1); ids (n_bags, k) int32 with bag stride id_stride and unit K
// stride; out (n_bags, dim) contiguous, the table's type.  v16 == 1 asks for
// the 16-byte path (the table and out 16-byte aligned, dim * size a multiple
// of 16).  The F = 1 case of the grouped kernel.
int embedding_bag_launch(const void* table, int64_t n_rows, int64_t dim,
                         int bf16, int v16, const int* ids, int64_t id_stride,
                         int k, int64_t n_bags, int mean, void* out,
                         cudaStream_t stream) {
  Tables<1> tables{{table}, {n_rows}};
  const Args a{dim, ids, id_stride, 0, k, n_bags, 1, 0, mean, out, dim,
               stream};
  return dispatch(tables, 1, bf16, v16, a);
}

// n_tables (1..64) tables of one dim and type: tables[f] (n_rows[f], dim)
// contiguous; ids (n_bags, n_tables, k) int32 with strides (id_stride_b,
// id_stride_f, 1); out (n_bags, n_tables, dim) with bag stride out_stride_b
// elements and unit strides after it.  (f_mul, f_shift) divide by n_tables
// (see the wrapper's _fast_divider).
int embedding_bag_grouped_launch(const void* const* tables,
                                 const int64_t* n_rows, int n_tables,
                                 int64_t dim, int bf16, int v16,
                                 const int* ids, int64_t id_stride_b,
                                 int64_t id_stride_f, int k, int64_t n_bags,
                                 uint32_t f_mul, uint32_t f_shift, int mean,
                                 void* out, int64_t out_stride_b,
                                 cudaStream_t stream) {
  const Args a{dim, ids, id_stride_b, id_stride_f, k, n_bags, f_mul, f_shift,
               mean, out, out_stride_b, stream};
  if (n_tables == 1) {
    Tables<1> one{{tables[0]}, {n_rows[0]}};
    return dispatch(one, 1, bf16, v16, a);
  }
  if (n_tables < 1 || n_tables > kMaxTables) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tables<kMaxTables> group{};
  for (int f = 0; f < n_tables; ++f) {
    group.ptr[f] = tables[f];
    group.rows[f] = n_rows[f];
  }
  return dispatch(group, n_tables, bf16, v16, a);
}

}  // extern "C"
