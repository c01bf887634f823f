// Fixed-arity EmbeddingBag (the recsys models' sparse lookup) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/embedding_bag.py
// (embedding_bag_pallas, _bag_body).  The function is the same:
//
//   out[b] = sum_{k = 0..K-1} table[clamp(ids[b, k], 0, R)]   (float32 sum)
//   out[b] /= K                                   when mode == "mean"
//   out[b]  cast once to the table's type (float32 or bfloat16)
//
// over a (R+1, D) table whose row R is the zero sentinel (padding of a bag
// to K ids).  Its block structure is not: the TPU kernel copies each row of
// a tile of bags into VMEM with one blocking DMA per row and reduces the
// tile there.  Here one thread owns one output element (b, d) and walks
// k = 0..K-1 in order, reading table[row * D + d] and adding it in float32,
// first row first (so the plain version, which adds in the same order, is
// equal bit for bit).  Neighbouring threads take neighbouring d of one bag,
// so a row is read coalesced and the bag's ids are broadcast loads; with
// D = 1 neighbouring threads take neighbouring bags.
//
// Where it departs from the TPU kernel, on purpose:
//   * ids are clamped into [0, R] here, as the model path's
//     jnp.take(mode="clip") does; the TPU kernel copies whatever row it is
//     given (its contract is ids in [0, R]).
//   * the row offset row * D is int64: DLRM-MLPerf's largest table
//     (39,979,776 x 128 floats) holds 5.1e9 elements, past 2^31.
//   * any D >= 1 and any row alignment: the loads are scalar, so rows of
//     D = 1 or D = 10 floats (not 16-byte aligned) need no special case.
//   * the ids may have any bag stride (a feature's column of the model's
//     (B, F, K) batch is read in place); their K axis is contiguous.
//
// What bounds it on this card: bytes, and at serving batch sizes the
// launch.  Per bag it reads K ids and K rows (each at least one 32-byte
// sector) and writes D outputs: at B = 512 and D = 32 about 133 KB (0.04 us
// at 3.35 TB/s), so the launch latency dominates; at B = 262,144 about
// 68 MB of rows at random addresses (~20 us).  What this design does about
// it: nothing beyond coalescing along D.  Vector loads, cp.async and one
// launch for all of a model's feature tables are later work.
//
// The launcher returns cudaGetLastError() of the launch; the caller raises
// on a non-zero value.  It launches on the caller's stream and allocates
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // beyond this, a grid-stride loop

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const T* __restrict__ table, int64_t n_rows,
                         int64_t dim, const int* __restrict__ ids,
                         int64_t id_stride, int k, int64_t n_bags, int mean,
                         T* __restrict__ out) {
  const int64_t n = n_bags * dim;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n; t += step) {
    const int64_t b = t / dim, d = t - b * dim;
    const int* bag = ids + b * id_stride;
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      int64_t row = bag[j];
      row = row < 0 ? 0 : (row < n_rows ? row : n_rows - 1);
      const float x = to_f32(table[row * dim + d]);
      acc = j ? acc + x : x;
    }
    if (mean) acc = acc / static_cast<float>(k);
    out[t] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* table, int64_t n_rows, int64_t dim, const int* ids,
           int64_t id_stride, int k, int64_t n_bags, int mean, void* out,
           cudaStream_t stream) {
  const int64_t blocks =
      std::min((n_bags * dim + kThreads - 1) / kThreads, kMaxBlocks);
  embedding_bag_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(static_cast<const T*>(table), n_rows,
                                      dim, ids, id_stride, k, n_bags, mean,
                                      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table (n_rows, dim) contiguous, float32 (bf16 == 0) or bfloat16 (bf16 ==
// 1); ids (n_bags, k) int32 with bag stride id_stride and unit K stride;
// out (n_bags, dim) contiguous, the table's type.  n_bags * dim >= 1.
int embedding_bag_launch(const void* table, int64_t n_rows, int64_t dim,
                         int bf16, const int* ids, int64_t id_stride, int k,
                         int64_t n_bags, int mean, void* out,
                         cudaStream_t stream) {
  if (n_rows < 1 || dim < 1 || k < 1 || n_bags < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? launch<__nv_bfloat16>(table, n_rows, dim, ids, id_stride, k,
                                      n_bags, mean, out, stream)
              : launch<float>(table, n_rows, dim, ids, id_stride, k, n_bags,
                              mean, out, stream);
}

}  // extern "C"
