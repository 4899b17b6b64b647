// Streaming kernels for Hopper (sm_90a), the paper's bandwidth-bound
// kernel class: a byte copy and out = a * x + b * y.
//
// Replace the TPU kernels repro/kernels/stream_copy/kernel.py
// (stream_copy_pallas, body _copy_kernel; stream_scale_add_pallas, body
// _saxpby_kernel).
//
// What bounds them on the H100: bytes.  A copy moves 2 n bytes (one read,
// one write), the paper's 16.8 MB copy 33.6 MB: 10.0 us at 3.35 TB/s.
// Scale-add moves 3 n elements and does 3 operations per element.  The
// design is what the memory system wants, and nothing more:
//   * 16-byte loads and stores (uint4 for the copy, four floats or eight
//     bfloat16 for scale-add), consecutive threads on consecutive
//     addresses, a grid-stride loop over at most 16 blocks per SM;
//   * no length assertion: the copy is byte-generic, so where source and
//     destination share their offset within 16 bytes, a head of up to 15
//     bytes and a tail of up to 15 bytes are copied byte by byte around
//     the 16-byte body; pointers of different offsets are copied byte
//     by byte.  (The runtime's COPY chunks of 4.2 M
//     int32, 64 x 65,625 elements, start and end on 16-byte boundaries
//     at every width up to 7, so there head and tail are empty.)
//     Scale-add takes its vector path when x, y and out are all 16-byte
//     aligned, else the scalar one, and finishes a ragged tail element
//     by element;
//   * a and b are run-time floats (the TPU kernel's compile-time
//     constants were a Pallas artefact).  The products and the sum are
//     rounded one by one (__fmul_rn, __fadd_rn: no FMA contraction), as
//     PyTorch rounds a * x.float() + b * y.float(), so float32 results
//     are bit-identical to the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

long long grid_for(long long items) {
  long long g = (items + kThreads - 1) / kThreads;
  if (g > kMaxBlocks) g = kMaxBlocks;
  return g < 1 ? 1 : g;
}

// head bytes, then nwords words of W, then tail bytes.
template <typename W>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
            long long head, long long nwords, long long tail) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (tid < head) dst[tid] = src[tid];
  const W* s = reinterpret_cast<const W*>(src + head);
  W* d = reinterpret_cast<W*>(dst + head);
  for (long long i = tid; i < nwords; i += stride) d[i] = s[i];
  const long long t0 = head + nwords * (long long)sizeof(W);
  if (tid < tail) dst[t0 + tid] = src[t0 + tid];
}

template <typename W>
void launch_copy(const uint8_t* src, uint8_t* dst, long long nbytes,
                 cudaStream_t s) {
  const long long a = sizeof(W);
  const long long mis = (long long)(reinterpret_cast<uintptr_t>(src) % a);
  long long head = (a - mis) % a;
  if (head > nbytes) head = nbytes;
  const long long nwords = (nbytes - head) / a;
  const long long tail = nbytes - head - nwords * a;
  copy_kernel<W><<<grid_for(nwords > 0 ? nwords : 1), kThreads, 0, s>>>(
      src, dst, head, nwords, tail);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ T axpby(T x, T y, float a, float b) {
  return from_f<T>(__fadd_rn(__fmul_rn(a, to_f(x)), __fmul_rn(b, to_f(y))));
}

// vec: the body in 16-byte vectors of 16 / sizeof(T) elements, then a
// scalar tail; otherwise every element scalar.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
scale_add_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 T* __restrict__ out, long long n, float a, float b) {
  constexpr int kV = 16 / sizeof(T);
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (kVec) {
    const long long nv = n / kV;
    for (long long i = tid; i < nv; i += stride) {
      uint4 xv = reinterpret_cast<const uint4*>(x)[i];
      uint4 yv = reinterpret_cast<const uint4*>(y)[i];
      uint4 ov;
      const T* xe = reinterpret_cast<const T*>(&xv);
      const T* ye = reinterpret_cast<const T*>(&yv);
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int e = 0; e < kV; ++e) oe[e] = axpby(xe[e], ye[e], a, b);
      reinterpret_cast<uint4*>(out)[i] = ov;
    }
    done = nv * kV;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = axpby(x[i], y[i], a, b);
}

template <typename T>
void launch_scale_add(const void* x, const void* y, void* out, long long n,
                      float a, float b, cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  T* op = static_cast<T*>(out);
  if (vec)
    scale_add_kernel<T, true><<<grid_for(n / kV + 1), kThreads, 0, s>>>(
        xp, yp, op, n, a, b);
  else
    scale_add_kernel<T, false><<<grid_for(n), kThreads, 0, s>>>(
        xp, yp, op, n, a, b);
}

}  // namespace

// Copies nbytes from src to dst (no overlap).  Returns cudaGetLastError()
// after the launch.
extern "C" int stream_copy_launch(const void* src, void* dst,
                                  long long nbytes, void* stream) {
  if (nbytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* sp = static_cast<const uint8_t*>(src);
  uint8_t* dp = static_cast<uint8_t*>(dst);
  const uintptr_t so = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d0 = reinterpret_cast<uintptr_t>(dst);
  if (so % 16 == d0 % 16)
    launch_copy<uint4>(sp, dp, nbytes, s);
  else
    launch_copy<uint8_t>(sp, dp, nbytes, s);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 float32, 1 bfloat16.  out = a * x + b * y over n elements.
extern "C" int stream_scale_add_launch(int dtype, const void* x,
                                       const void* y, void* out, long long n,
                                       float a, float b, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_scale_add<float>(x, y, out, n, a, b, s);
  else if (dtype == 1)
    launch_scale_add<__nv_bfloat16>(x, y, out, n, a, b, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
