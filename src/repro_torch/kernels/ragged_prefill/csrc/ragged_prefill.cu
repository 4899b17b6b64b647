// Chunked ragged prefill attention for Hopper (sm_90a): a chunk of T query
// tokens per batch slot, GQA, causal against the slot's whole resident
// cache (the earlier chunks plus the chunk itself).
//
// Replaces the TPU kernel repro/kernels/ragged_prefill/kernel.py
// (ragged_prefill_pallas, body _ragged_prefill_kernel).
//
// What bounds it on the H100: operations.  A chunk of T tokens at offset
// `start` costs about 4 * Hq * hd * sum_t (start + t + 1) operations
// against 2 * (start + T) * Hkv * hd cache elements read: at the serving
// chunk (T = 256, start >= 256, qwen2-0.5b's 14/2 heads) that is over a
// thousand operations per byte, far past the ~295 at which the tensor
// cores, not HBM, are the limit.  This first version is written for being
// right and simple, not for the tensor cores:
//   * GQA is folded by index: folded row i of kv head g is chunk token
//     i / rep and query head g * rep + i % rep, read straight from the
//     model's (B, T, Hq, hd) activations and written to a (B, T, Hq, hd)
//     f32 output in the same order, so nothing is transposed or copied;
//   * one block per (tile of BQ folded rows, kv head, slot): the engine's
//     chunk (B = 1, Hkv = 2, 256 tokens x 7 heads = 1792 rows) gives 112
//     blocks, where the TPU's one program per (slot, kv head) would give
//     2 for 132 SMs.  Every K/V row a block stages serves all of its rows;
//   * eight threads share a folded row, each owning every eighth element
//     of hd, so a score is eight partial dot products joined by three warp
//     shuffles; K/V tiles are staged in shared memory as f32 and read
//     without bank conflicts;
//   * each tile stops its K/V sweep at its own causal horizon,
//     min(start + its last token, start + qlen - 1); the TPU kernel swept
//     every row up to the horizon of the whole chunk.  A tile whose rows
//     are all past qlen, and a slot with qlen == 0, read nothing.
// The next step is the tensor cores (mma / wgmma on bf16 tiles).
//
// Semantics follow the TPU kernel: scores dot(q, k) * scale in f32,
// masked to -1e30 past each row's position; p is zeroed explicitly where
// masked (a fully padded row keeps m at -1e30, where exp(s - m) would be
// 1) and rounded to the cache's type before the PV product; the output is
// f32 acc / max(l, 1e-30), exact zeros on padded rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTPR = 8;              // threads per folded row
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

// q: (B, T, Hkv * rep, HD); k, v: (B, Smax, Hkv, HD); start, qlen: (B,)
// int32; out: (B, T, Hkv * rep, HD) f32.  Grid (ceil(T * rep / BQ), Hkv,
// B), kTPR * BQ threads.
template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(kTPR * BQ)
ragged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ start,
                      const int* __restrict__ qlen, float* __restrict__ out,
                      int n_tok, int Smax, int Hkv, int rep, float scale) {
  constexpr int kThreads = kTPR * BQ;
  constexpr int DPT = HD / kTPR;                  // hd elements per thread
  __shared__ float k_s[BK][HD];
  __shared__ float v_s[BK][HD];

  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, part = tid % kTPR;
  const int rows = n_tok * rep;                   // folded rows of kv head g
  const int i0 = blockIdx.x * BQ;                 // the tile's first row
  const int i = i0 + tid / kTPR;
  const int t = i / rep, r = i - t * rep;
  const int start_b = start[b], qlen_b = qlen[b];
  const bool in_tile = i < rows;
  const bool live = in_tile && t < qlen_b;
  const int qpos = start_b + t;

  // the tile's causal horizon: the position of its last live token, capped
  // at the cache edge; no key at all when its first token is padding
  const int t_last = min((min(i0 + BQ, rows) - 1) / rep, qlen_b - 1);
  const int n_keys = i0 / rep < qlen_b ? min(start_b + t_last, Smax - 1) + 1
                                       : 0;

  const size_t row_off =
      (((size_t)b * n_tok + t) * Hkv * rep + (size_t)g * rep + r) * HD;
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) {
    qr[e] = live ? to_f(q[row_off + e * kTPR + part]) : 0.f;
    acc[e] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const size_t kv_row = (size_t)Hkv * HD;         // between cache rows
  const T* kb = k + (size_t)b * Smax * kv_row + (size_t)g * HD;
  const T* vb = v + (size_t)b * Smax * kv_row + (size_t)g * HD;

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, kr = k0 + j;
      const bool have = kr < n_keys;
      k_s[j][d] = have ? to_f(kb[kr * kv_row + d]) : 0.f;
      v_s[j][d] = have ? to_f(vb[kr * kv_row + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < DPT; ++e) dot += qr[e] * k_s[j][e * kTPR + part];
#pragma unroll
      for (int o = 1; o < kTPR; o <<= 1) dot += __shfl_xor_sync(~0u, dot, o);
      const int kpos = k0 + j;
      const bool seen = live && kpos <= qpos && kpos < n_keys;
      s[j] = seen ? dot * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kpos = k0 + j;
      const bool seen = live && kpos <= qpos && kpos < n_keys;
      const float p = seen ? expf(s[j] - m_new) : 0.f;
      lsum += p;
      s[j] = to_f(from_f<T>(p));                  // PV takes p in T
    }
    l = l * corr + lsum;
    m = m_new;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      float a = acc[e] * corr;
#pragma unroll
      for (int j = 0; j < BK; ++j) a += s[j] * v_s[j][e * kTPR + part];
      acc[e] = a;
    }
    __syncthreads();
  }

  if (in_tile) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      out[row_off + e * kTPR + part] = acc[e] * inv;
  }
}

template <typename T, int HD, int BQ, int BK>
void launch(const void* q, const void* k, const void* v, const void* start,
            const void* qlen, void* out, int B, int n_tok, int Smax, int Hkv,
            int rep, float scale, cudaStream_t stream) {
  const dim3 grid((n_tok * rep + BQ - 1) / BQ, Hkv, B);
  ragged_prefill_kernel<T, HD, BQ, BK><<<grid, kTPR * BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(start),
      static_cast<const int*>(qlen), static_cast<float*>(out), n_tok, Smax,
      Hkv, rep, scale);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int ragged_prefill_launch(int dtype, const void* q, const void* k,
                                     const void* v, const void* start,
                                     const void* qlen, void* out, int B,
                                     int n_tok, int Smax, int Hkv, int rep,
                                     int hd, float scale, void* stream) {
  if (B <= 0 || n_tok <= 0 || Smax <= 0 || Hkv <= 0 || rep < 1 ||
      rep > kMaxRep || B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    launch<float, 64, 32, 64>(q, k, v, start, qlen, out, B, n_tok, Smax, Hkv,
                              rep, scale, s);
  else if (dtype == 0 && hd == 128)
    launch<float, 128, 32, 32>(q, k, v, start, qlen, out, B, n_tok, Smax,
                               Hkv, rep, scale, s);
  else if (dtype == 1 && hd == 64)
    launch<__nv_bfloat16, 64, 32, 64>(q, k, v, start, qlen, out, B, n_tok,
                                      Smax, Hkv, rep, scale, s);
  else if (dtype == 1 && hd == 128)
    launch<__nv_bfloat16, 128, 32, 32>(q, k, v, start, qlen, out, B, n_tok,
                                       Smax, Hkv, rep, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
