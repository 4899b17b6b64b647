// Dense matrix product for Hopper (sm_90a): out = x @ y with a float32
// accumulator, x (M, K) and y (K, N) row-major, any M, N, K, any row
// strides.
//
// Replaces the TPU kernel repro/kernels/matmul/kernel.py (matmul_pallas,
// body _mm_kernel), the paper's compute-bound kernel class.
//
// What bounds it on the H100: at the runtime's shapes, neither bytes nor
// operations but latency.  A 64x64x64 product is 0.52 MFLOP over 48 KB:
// 7.8 ns at the f32 rate and 15 ns at the memory rate, far below one
// launch.  What is left to a kernel is the time between its launch and its
// last store: how many dependent trips to cold memory it makes, how long
// one SM computes, how many threads share the work.  So:
//   * small output tiles over many SMs: a block owns a 16 x 16 tile of out
//     (kBM x kBN), so the 64x64 product runs as 16 blocks, and a 16-row
//     TAO slice (a chunk at width 4) as 4 blocks with no masked rows; each
//     block reads only its 16 rows of x and its 16 columns of y;
//   * one trip to memory per block at the runtime's K: the block's panel
//     is staged 64 deep at once (a 16 x 64 slice of x and a 64 x 16 panel
//     of y, 8 KB of f32) by 16-byte cp.async, all in flight together; at
//     larger K a 3-stage ring keeps the next two k-tiles' loads in flight
//     while the FMAs of the current one run;
//   * a register tile fed by vector shared loads: each of the 64 threads
//     owns a 1 x 4 strip of out; per 4 values of k it reads 4 of x in one
//     16-byte load and 4 rows of its 4 columns of y in four, 16 FMAs for 5
//     shared loads (the first version: 2 FMAs per shared load);
//   * float32 inputs are multiplied and summed in plain f32 FMAs on the
//     CUDA cores, one accumulator per output, in k order, so the result
//     keeps parity with numpy's float32 product (no TF32, no tensor cores:
//     TF32 cannot hold the runtime's 1e-5 relative check).  bfloat16
//     inputs are widened in registers and summed in f32 the same way;
//   * every edge is masked, so any (M, K) x (K, N) works: rows of a panel
//     whose base or stride is not 16-byte aligned, and the partial 16-byte
//     chunk at the end of a row, are loaded element by element inside the
//     kernel; out is written 16 (f32) or 8 (bf16) bytes at a time where it
//     is aligned, element by element elsewhere.  x may be a row slice
//     a[lo:hi] of a larger matrix and out a row slice out[lo:hi].
// One launch per call, no host sync, no scratch: the grid follows from
// the shape alone (ops.TilePlan mirrors it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int kBM = 16, kBN = 16, kBK = 64;   // out tile, k-tile depth
constexpr int kStages = 3;                    // k-tiles in the ring
constexpr int kThreads = 64;                  // a 1 x 4 strip each

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 4 consecutive elements of shared memory as floats (16 or 8 bytes,
// aligned by the layouts below)
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(float (&v)[4], const __nv_bfloat16* p) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16), v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16), v[3] = __uint_as_float(t.y & 0xffff0000u);
}

// The shared-memory layout of one ring stage: the x slice kBM x kBK, each
// row padded by one 16-byte chunk so the eight rows a warp reads at one k
// fall in distinct banks; the y panel kBK x kBN.
template <typename T> struct Stage {
  static constexpr int kE = 16 / sizeof(T);        // elements per chunk
  static constexpr int kLdx = kBK + kE;
  alignas(16) T xs[kBM * kLdx];
  alignas(16) T ys[kBK * kBN];
};

// rows [r0, r0 + R) x columns [c0, c0 + C) of g (row stride ldg) into s
// (row stride lds); elements past (nrows, ncols) are zero.  A 16-byte
// chunk goes by cp.async where the panel is aligned (vec) and the chunk
// lies wholly inside; a chunk wholly outside by cp.async's zero fill;
// the rest element by element.
template <typename T, int R, int C>
__device__ __forceinline__ void load_panel(T* s, int lds, const T* g,
                                           long long ldg, int r0, int nrows,
                                           int c0, int ncols, bool vec,
                                           int tid) {
  constexpr int E = 16 / sizeof(T), CPR = C / E;
#pragma unroll
  for (int i = tid; i < R * CPR; i += kThreads) {
    const int r = i / CPR, e0 = (i % CPR) * E;
    const int gr = r0 + r, gc = c0 + e0;
    T* dst = s + r * lds + e0;
    const bool inside = gr < nrows && gc + E <= ncols;
    const bool outside = gr >= nrows || gc >= ncols;
    if (vec && (inside || outside)) {
      sm90::cp_async16(dst, inside ? g + gr * ldg + gc : g, inside);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        dst[e] = !outside && gc + e < ncols ? g[gr * ldg + gc + e]
                                            : from_f<T>(0.f);
    }
  }
}

// Grid (ceil(M / kBM), ceil(N / kBN)), kThreads threads.
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
              O* __restrict__ out, int M, int N, int K, long long ldx,
              long long ldy, long long ldo) {
  __shared__ Stage<T> ring[kStages];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int n_kt = (K + kBK - 1) / kBK;
  // a panel goes by 16-byte copies if its base and row stride allow them
  const bool vx = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  ldx * (long long)sizeof(T) % 16 == 0;
  const bool vy = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                  ldy * (long long)sizeof(T) % 16 == 0;
  auto load = [&](int kt) {
    Stage<T>& st = ring[kt % kStages];
    const int k0 = kt * kBK;
    load_panel<T, kBM, kBK>(st.xs, Stage<T>::kLdx, x, ldx, m0, M, k0, K, vx,
                            tid);
    load_panel<T, kBK, kBN>(st.ys, kBN, y, ldy, k0, K, n0, N, vy, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load(s);
    sm90::cp_async_commit();             // empty groups keep the count
  }

  const int row = tid / (kBN / 4), col = (tid % (kBN / 4)) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kt = 0; kt < n_kt; ++kt) {
    sm90::cp_async_wait<kStages - 2>();  // k-tile kt has landed
    __syncthreads();                     // for every thread; kt - 1 is free
    if (kt + kStages - 1 < n_kt) load(kt + kStages - 1);
    sm90::cp_async_commit();
    const Stage<T>& st = ring[kt % kStages];
    const T* xr = st.xs + row * Stage<T>::kLdx;
    // zeros past K on both sides add nothing: every k-tile runs whole
#pragma unroll
    for (int k = 0; k < kBK; k += 4) {
      float a[4];
      load4(a, xr + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float b[4];
        load4(b, st.ys + (k + j) * kBN + col);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(a[j], b[c], acc[c]);
      }
    }
  }

  const int gm = m0 + row, gn = n0 + col;
  if (gm >= M) return;
  O* o = out + gm * ldo + gn;
  const bool vo = reinterpret_cast<uintptr_t>(o) % (4 * sizeof(O)) == 0 &&
                  gn + 4 <= N;
  if (vo) {
    if constexpr (sizeof(O) == 4) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0], acc[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2], acc[3]);
      uint2 w;
      w.x = *reinterpret_cast<const uint32_t*>(&lo);
      w.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(o) = w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (gn + c < N) o[c] = from_f<O>(acc[c]);
  }
}

template <typename T, typename O>
void launch(const void* x, const void* y, void* out, int M, int N, int K,
            long long ldx, long long ldy, long long ldo, cudaStream_t s) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
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
  if (M <= 0 || N <= 0 || K <= 0 || (N + kBN - 1) / kBN > 65535)
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
