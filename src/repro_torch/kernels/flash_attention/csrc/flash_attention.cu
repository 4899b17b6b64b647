// Flash attention (GQA, causal or not) for Hopper (sm_90a): the port's
// whole-prompt prefill attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _flash_kernel).
//
// What bounds it on the H100: operations, at long prompts.  A causal
// prompt of S tokens costs about 2 * Hq * S^2 * hd operations against
// 4 * (Hq + Hkv) * S * hd bytes (bf16 q, k, v and output), about
// 0.44 * S operations per byte at qwen2-0.5b's heads: past the ~295 at
// which the tensor cores, not HBM, are the limit once S exceeds ~700.
// This first version is written for being right and simple, not for the
// tensor cores:
//   * one block per (64-row query tile, query head, batch); four threads
//     share a query row, each owning every fourth element of hd, so a score
//     is four partial dot products joined by two warp shuffles;
//   * K/V tiles of 64 (32 at hd 128) rows are staged in shared memory as
//     f32 and read without bank conflicts;
//   * query head h reads kv head h / rep directly: no K/V head is
//     replicated in memory;
//   * causal tiles strictly above the diagonal are never loaded, and the
//     heaviest query tiles are scheduled first;
//   * prompts of any length: the ragged last query and key tiles are
//     masked in the kernel (the TPU kernel asserted Sq % bq == 0);
//   * tensors are addressed through (batch, head, seq) strides with hd
//     contiguous, so the model passes (B, S, H, hd) activations as
//     transposed views and nothing is copied in or out.
// The next step is the tensor cores (mma / wgmma on bf16 tiles).
//
// Semantics follow the TPU kernel: scores dot(q, k) * scale in f32, masked
// to -1e30 above the diagonal (both positions start at 0); p is rounded to
// the input type before the PV product; output acc / max(l, 1e-30) in the
// input type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// element strides of (batch, head, seq) for q, k, v, out; hd is contiguous
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// Grid (ceil(Sq / BQ), Hq, B), 4 * BQ threads.
template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(4 * BQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Hq,
                       int Hkv, int Sq, int Skv, Strides st, int causal,
                       float scale) {
  constexpr int kThreads = 4 * BQ;
  constexpr int DPT = HD / 4;                     // hd elements per thread
  __shared__ float k_s[BK][HD];
  __shared__ float v_s[BK][HD];

  const int qi = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (Hq / Hkv);
  const int tid = threadIdx.x, row = tid >> 2, quad = tid & 3;
  const int q_start = qi * BQ, qpos = q_start + row;

  const T* qp = q + b * st.q[0] + h * st.q[1];
  const T* kp = k + b * st.k[0] + g * st.k[1];
  const T* vp = v + b * st.v[0] + g * st.v[1];

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = qpos < Sq ? to_f(qp[qpos * st.q[2] + i * 4 + quad]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  int k_end = Skv;                                // keys this tile needs
  if (causal) k_end = min(Skv, q_start + BQ);
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, kr = k0 + j;
      const bool live = kr < Skv;
      k_s[j][d] = live ? to_f(kp[kr * st.k[2] + d]) : 0.f;
      v_s[j][d] = live ? to_f(vp[kr * st.v[2] + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * k_s[j][i * 4 + quad];
      part += __shfl_xor_sync(~0u, part, 1);
      part += __shfl_xor_sync(~0u, part, 2);
      const int kpos = k0 + j;
      const bool masked = kpos >= Skv || (causal && kpos > qpos);
      s[j] = masked ? kNegInf : part * scale;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      lsum += p;
      s[j] = to_f(from_f<T>(p));                  // PV takes p in T
    }
    l = l * corr + lsum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < BK; ++j) a += s[j] * v_s[j][i * 4 + quad];
      acc[i] = a;
    }
    __syncthreads();
  }

  if (qpos < Sq) {
    T* op = out + b * st.o[0] + h * st.o[1] + qpos * st.o[2];
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[i * 4 + quad] = from_f<T>(acc[i] * inv);
  }
}

template <typename T, int HD, int BQ, int BK>
void launch(const void* q, const void* k, const void* v, void* out, int B,
            int Hq, int Hkv, int Sq, int Skv, const Strides& st, int causal,
            float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<T, HD, BQ, BK><<<grid, 4 * BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Skv, st,
      causal, scale);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; strides: 12 element strides, (batch, head,
// seq) of q, k, v, out in that order.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int hd,
                                      const long long* strides, int causal,
                                      float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    launch<float, 64, 64, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, st, causal,
                              scale, s);
  else if (dtype == 0 && hd == 128)
    launch<float, 128, 64, 32>(q, k, v, out, B, Hq, Hkv, Sq, Skv, st, causal,
                               scale, s);
  else if (dtype == 1 && hd == 64)
    launch<__nv_bfloat16, 64, 64, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, st,
                                      causal, scale, s);
  else if (dtype == 1 && hd == 128)
    launch<__nv_bfloat16, 128, 64, 32>(q, k, v, out, B, Hq, Hkv, Sq, Skv, st,
                                       causal, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
