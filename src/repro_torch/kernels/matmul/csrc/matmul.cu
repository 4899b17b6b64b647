// Dense matrix product for Hopper (sm_90a): out = x @ y with a float32
// accumulator, x (M, K) and y (K, N) row-major, any M, N, K.
//
// Replaces the TPU kernel repro/kernels/matmul/kernel.py (matmul_pallas,
// body _mm_kernel), the paper's compute-bound kernel class.
//
// What bounds it on the H100: at the runtime's shapes, neither bytes nor
// operations but latency.  A 64x64x64 product is 0.52 MFLOP over 48 KB:
// 7.8 ns at the f32 rate and 15 ns at the memory rate, far below one
// launch.  A 16-row slice (a TAO chunk at width 4) is a quarter of that.
// This first version is written for being right and simple:
//   * float32 inputs are multiplied and summed in plain f32 FMAs on the
//     CUDA cores, in k order, so the result keeps parity with numpy's
//     float32 product (no TF32, no tensor cores);
//   * one 64x64 output tile per block of 256 threads, each thread owning
//     a 4x4 patch strided by 16 rows and 16 columns; x and y are staged
//     through shared memory 16 columns / rows of k at a time, as f32
//     (bfloat16 inputs are widened on the way in);
//   * every edge is masked, so any (M, K) x (K, N) works: the TPU
//     wrapper's (bm, bn, bk) tiling assertion does not carry over.  Row
//     strides are arguments, so x may be a row slice a[lo:hi] of a larger
//     matrix and out a row slice out[lo:hi].
// The next step is the tensor cores (mma / wgmma on bf16 tiles), which
// matter only for products far larger than the runtime's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;            // 16 x 16, a 4 x 4 patch each

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

// Grid (ceil(N / kBN), ceil(M / kBM)).
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
              O* __restrict__ out, int M, int N, int K, long long ldx,
              long long ldy, long long ldo) {
  __shared__ float xs[kBK][kBM + 1];     // x tile, transposed: xs[k][m]
  __shared__ float ys[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK, gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? to_f(x[gm * ldx + gk]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN, gk = k0 + r, gn = n0 + c;
      ys[r][c] = (gk < K && gn < N) ? to_f(y[gk * ldy + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ys[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[gm * ldo + gn] = from_f<O>(acc[i][j]);
    }
  }
}

template <typename T, typename O>
void launch(const void* x, const void* y, void* out, int M, int N, int K,
            long long ldx, long long ldy, long long ldo, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  matmul_kernel<T, O><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<O*>(out), M, N, K, ldx, ldy, ldo);
}

}  // namespace

// dtype, out_dtype: 0 float32, 1 bfloat16.  ldx, ldy, ldo are the row
// strides in elements (column stride 1).  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int matmul_launch(int dtype, int out_dtype, const void* x,
                             const void* y, void* out, int M, int N, int K,
                             long long ldx, long long ldy, long long ldo,
                             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0)
    launch<float, float>(x, y, out, M, N, K, ldx, ldy, ldo, s);
  else if (dtype == 0 && out_dtype == 1)
    launch<float, __nv_bfloat16>(x, y, out, M, N, K, ldx, ldy, ldo, s);
  else if (dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(x, y, out, M, N, K, ldx, ldy, ldo, s);
  else if (dtype == 1 && out_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(x, y, out, M, N, K, ldx, ldy, ldo,
                                         s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
