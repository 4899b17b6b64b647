// Ascending row sort for Hopper (sm_90a) by a bitonic network, the
// paper's cache-bound kernel class.
//
// Replaces the TPU kernel repro/kernels/bitonic_sort/kernel.py
// (sort_rows_pallas, network in _bitonic_block).
//
// What bounds a row sort on the H100: bytes.  The paper's 262 KB row
// (65,536 int32) moves 512 KB, and a comparison sort needs at most
// n ceil(log2 n) = 1,048,576 comparisons, less time than the bytes at
// the card's min/max rate.  This network does more work than that: a row
// padded to P = 2^p elements takes P/2 * p(p+1)/2 compare-exchanges,
// 4,456,448 for the paper's row.  The TPU kernel kept the whole row in VMEM.
// A Hopper block has at most 227 KB of shared memory and the row is
// 256 KB, so the network runs in two places:
//   * a row of up to kTile (8,192) elements sorts wholly in shared memory,
//     one block per row, in one launch (read once, written once);
//   * a longer row is cut into tiles of kTile.  One launch sorts every
//     tile in shared memory, in the direction the full network gives it
//     (so the tiles already form the bitonic sequences of the next merge).
//     Then, for each merge size k > kTile, the steps whose stride j is a
//     tile or more run in global memory, one launch per step and one
//     thread per compare-exchange, and the steps with j < kTile run in one
//     launch per k that loads each tile into shared memory, finishes the
//     small strides there and writes it back.  The row, 256 KB, stays in
//     the 50 MB L2 between launches, so it is still the cache class.  The
//     paper's row takes 1 + 6 + 3 = 10 launches from one host call.
// A row whose length is not a power of two is padded with the type's
// largest value (INT_MAX, +inf), which sorts last and is dropped on the
// way out: in shared memory on the short path; in a scratch buffer of the
// padded length, which the wrapper allocates, on the long one.  A long row
// of a power-of-two length sorts in place in the output.  The merge
// directions follow the TPU network: ascending iff (index & k) == 0, so
// the last merge (k = P) is ascending.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>

namespace {

constexpr int kTile = 8192;              // elements sorted in shared memory
constexpr int kTileThreads = 1024;
constexpr int kStepThreads = 256;

template <typename T> __device__ __forceinline__ T pad_value();
template <> __device__ __forceinline__ int pad_value<int>() { return INT_MAX; }
template <> __device__ __forceinline__ float pad_value<float>() {
  return CUDART_INF_F;
}

template <typename T>
__device__ __forceinline__ void compare_exchange(T* v, long long i,
                                                 long long l, bool asc) {
  const T a = v[i], b = v[l];
  if (asc ? (b < a) : (a < b)) {
    v[i] = b;
    v[l] = a;
  }
}

// One step (k, j) of the network over a tile in shared memory whose first
// element has row index g0.
template <typename T>
__device__ __forceinline__ void tile_step(T* s, int tile, long long g0,
                                          long long k, int j) {
  for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
    const int i = (p / j) * 2 * j + p % j;
    compare_exchange(s, i, i + j, ((g0 + i) & k) == 0);
  }
  __syncthreads();
}

// Grid (P / tile, rows).  Loads elements [g0, g0 + tile) of the padded
// row, runs the network's merges k = 2 .. tile, writes indices < dst_n.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
tile_sort_kernel(const T* __restrict__ src, long long src_stride,
                 long long n, T* __restrict__ dst, long long dst_stride,
                 long long dst_n, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const long long g0 = (long long)blockIdx.x * tile;
  const T* row = src + blockIdx.y * src_stride;
  for (int e = threadIdx.x; e < tile; e += blockDim.x)
    s[e] = g0 + e < n ? row[g0 + e] : pad_value<T>();
  __syncthreads();
  for (long long k = 2; k <= tile; k <<= 1)
    for (int j = (int)(k >> 1); j > 0; j >>= 1) tile_step(s, tile, g0, k, j);
  T* out = dst + blockIdx.y * dst_stride;
  for (int e = threadIdx.x; e < tile; e += blockDim.x)
    if (g0 + e < dst_n) out[g0 + e] = s[e];
}

// Grid (ceil(P / 2 / kStepThreads), rows): step (k, j >= tile) in global
// memory, one compare-exchange per thread.
template <typename T>
__global__ void __launch_bounds__(kStepThreads)
global_step_kernel(T* buf, long long stride, long long half, long long k,
                   long long j) {
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= half) return;
  const long long i = (p / j) * 2 * j + p % j;
  compare_exchange(buf + blockIdx.y * stride, i, i + j, (i & k) == 0);
}

// Grid (P / tile, rows): the steps j = tile/2 .. 1 of merge k, in shared
// memory; writes indices < out_n of the tile to out.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
tile_merge_kernel(const T* buf, long long stride, long long k, int tile,
                  T* out, long long out_stride, long long out_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const long long g0 = (long long)blockIdx.x * tile;
  const T* row = buf + blockIdx.y * stride;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) s[e] = row[g0 + e];
  __syncthreads();
  for (int j = tile >> 1; j > 0; j >>= 1) tile_step(s, tile, g0, k, j);
  T* orow = out + blockIdx.y * out_stride;
  for (int e = threadIdx.x; e < tile; e += blockDim.x)
    if (g0 + e < out_n) orow[g0 + e] = s[e];
}

template <typename T>
int launch(const void* src_v, void* work_v, void* out_v, int rows,
           long long n, long long src_stride, long long work_stride,
           long long out_stride, cudaStream_t s) {
  const T* src = static_cast<const T*>(src_v);
  T* work = static_cast<T*>(work_v);
  T* out = static_cast<T*>(out_v);
  long long P = 1;
  while (P < n) P <<= 1;
  const int tile = P < kTile ? (int)P : kTile;
  const int threads = tile / 2 < 32 ? 32
                      : (tile / 2 > kTileThreads ? kTileThreads : tile / 2);
  const size_t smem = (size_t)tile * sizeof(T);
  const unsigned tiles = (unsigned)(P / tile);
  if (P == tile) {                     // the whole row in shared memory
    tile_sort_kernel<T><<<dim3(1, rows), threads, smem, s>>>(
        src, src_stride, n, out, out_stride, n, tile);
    return static_cast<int>(cudaGetLastError());
  }
  if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  tile_sort_kernel<T><<<dim3(tiles, rows), threads, smem, s>>>(
      src, src_stride, n, work, work_stride, P, tile);
  cudaError_t err = cudaGetLastError();
  const long long half = P / 2;
  const unsigned step_blocks =
      (unsigned)((half + kStepThreads - 1) / kStepThreads);
  for (long long k = 2LL * tile; k <= P && err == cudaSuccess; k <<= 1) {
    for (long long j = k >> 1; j >= tile; j >>= 1)
      global_step_kernel<T><<<dim3(step_blocks, rows), kStepThreads, 0, s>>>(
          work, work_stride, half, k, j);
    const bool last = k == P;
    tile_merge_kernel<T><<<dim3(tiles, rows), threads, smem, s>>>(
        work, work_stride, k, tile, last ? out : work,
        last ? out_stride : work_stride, last ? n : P);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 float32, 1 int32.  Sorts each of `rows` rows of n elements
// (row strides in elements) from src into out.  work holds rows of the
// padded length P = 2^ceil(log2 n) when P > kTile (it may be out itself
// when n == P); it is unused, and may be null, otherwise.  Returns
// cudaGetLastError() after the launches.
extern "C" int bitonic_sort_launch(int dtype, const void* src, void* work,
                                   void* out, int rows, long long n,
                                   long long src_stride,
                                   long long work_stride,
                                   long long out_stride, void* stream) {
  if (rows <= 0 || rows > 65535 || n <= 0 || n > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(src, work, out, rows, n, src_stride, work_stride,
                         out_stride, s);
  if (dtype == 1)
    return launch<int>(src, work, out, rows, n, src_stride, work_stride,
                       out_stride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int bitonic_sort_tile() { return kTile; }
