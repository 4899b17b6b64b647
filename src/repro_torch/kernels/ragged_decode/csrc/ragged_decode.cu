// Ragged decode attention for Hopper (sm_90a): one query token per batch
// slot, GQA, online softmax over the slot's live cache rows only.
//
// Replaces the TPU kernel repro/kernels/ragged_decode/kernel.py
// (ragged_decode_pallas, body _ragged_decode_kernel).
//
// What bounds it on the H100: bytes.  Each call reads q and the live K/V
// rows of every slot (2 * (pos[b] + 1) * Hkv * hd elements per slot) and
// does about 4 * rep * hd operations per K/V row read: far below the ~295
// operations per byte at which the tensor cores, not HBM, become the limit.
// So the design moves no byte it does not need:
//   * a block serves one (slot, kv head) pair and all `rep` query heads of
//     that group, so a K/V row is read from device memory once, never once
//     per query head;
//   * the K/V sweep stops at the slot's position: rows past pos[b] are
//     neither loaded nor computed, and the ragged tail of the last tile is
//     masked in place.  Nothing is padded or copied (the TPU wrapper padded
//     the whole layer cache to a block multiple on every call);
//   * loads are coalesced along hd; scores and the PV product read shared
//     memory without bank conflicts (K rows are padded by one float).
// What it does not do yet: with B * Hkv = 16 blocks at B=8 the card's 132
// SMs are mostly idle.  Splitting each slot's K/V sweep across blocks and
// combining (m, l, acc) afterwards is the next step.
//
// Semantics follow the TPU kernel: scores are dot(q, k) * scale in f32,
// masked to -1e30 past pos[b]; p is rounded to the cache's type before
// the PV product; the output is f32 acc / max(l, 1e-30).  A position past
// the cache attends all Smax rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRep = 16;          // query heads per kv head
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// q: (B, Hkv * rep, HD); k, v: (B, Smax, Hkv, HD); pos: (B,) int32;
// out: (B, Hkv * rep, HD) f32.  Grid (Hkv, B), kThreads threads.
template <typename T, int HD, int BK>
__global__ void __launch_bounds__(kThreads)
ragged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ pos,
                     float* __restrict__ out, int Smax, int Hkv, int rep,
                     float scale) {
  constexpr int kAcc = kMaxRep * HD / kThreads;  // output cells per thread
  __shared__ float q_s[kMaxRep][HD];
  __shared__ float k_s[BK][HD + 1];               // +1: conflict-free rows
  __shared__ float v_s[BK][HD];
  __shared__ float p_s[kMaxRep][BK];
  __shared__ float m_s[kMaxRep], l_s[kMaxRep], corr_s[kMaxRep];

  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * rep;
  const int last = min(pos[b], Smax - 1);         // newest live row

  const T* qb = q + ((size_t)b * Hq + (size_t)g * rep) * HD;
  for (int e = tid; e < rep * HD; e += kThreads) q_s[e / HD][e % HD] = to_f(qb[e]);
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const size_t row_stride = (size_t)Hkv * HD;     // between cache rows
  const T* kb = k + (size_t)b * Smax * row_stride + (size_t)g * HD;
  const T* vb = v + (size_t)b * Smax * row_stride + (size_t)g * HD;
  __syncthreads();

  for (int k0 = 0; k0 <= last; k0 += BK) {
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, row = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (row <= last) {
        kv = to_f(kb[row * row_stride + d]);
        vv = to_f(vb[row * row_stride + d]);
      }
      k_s[j][d] = kv;
      v_s[j][d] = vv;
    }
    __syncthreads();

    for (int e = tid; e < rep * BK; e += kThreads) {
      const int r = e / BK, j = e % BK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s += q_s[r][d] * k_s[j][d];
      p_s[r][j] = (k0 + j <= last) ? s * scale : kNegInf;
    }
    __syncthreads();

    for (int r = warp; r < rep; r += kThreads / 32) {
      float mx = kNegInf;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, p_s[r][j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(p_s[r][j] - m_new);
        sum += p;
        p_s[r][j] = to_f(from_f<T>(p));           // PV takes p in T
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr_s[r] = c;
        l_s[r] = l_s[r] * c + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads, r = e / HD, d = e % HD;
      if (r < rep) {
        float a = acc[i] * corr_s[r];
#pragma unroll 16
        for (int j = 0; j < BK; ++j) a += p_s[r][j] * v_s[j][d];
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  float* ob = out + ((size_t)b * Hq + (size_t)g * rep) * HD;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads, r = e / HD;
    if (r < rep) ob[e] = acc[i] / fmaxf(l_s[r], 1e-30f);
  }
}

template <typename T, int HD, int BK>
void launch(const void* q, const void* k, const void* v, const void* pos,
            void* out, int B, int Smax, int Hkv, int rep, float scale,
            cudaStream_t stream) {
  ragged_decode_kernel<T, HD, BK><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<float*>(out), Smax, Hkv, rep, scale);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int ragged_decode_launch(int dtype, const void* q, const void* k,
                                    const void* v, const void* pos, void* out,
                                    int B, int Smax, int Hkv, int rep, int hd,
                                    float scale, void* stream) {
  if (B <= 0 || Smax <= 0 || Hkv <= 0 || rep < 1 || rep > kMaxRep)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    launch<float, 64, 64>(q, k, v, pos, out, B, Smax, Hkv, rep, scale, s);
  else if (dtype == 0 && hd == 128)
    launch<float, 128, 32>(q, k, v, pos, out, B, Smax, Hkv, rep, scale, s);
  else if (dtype == 1 && hd == 64)
    launch<__nv_bfloat16, 64, 64>(q, k, v, pos, out, B, Smax, Hkv, rep,
                                  scale, s);
  else if (dtype == 1 && hd == 128)
    launch<__nv_bfloat16, 128, 32>(q, k, v, pos, out, B, Smax, Hkv, rep,
                                   scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
