// Ragged decode attention for Hopper (sm_90a): one query token per batch
// slot, GQA, online softmax over the slot's live cache rows only.
//
// Replaces the TPU kernel repro/kernels/ragged_decode/kernel.py
// (ragged_decode_pallas, body _ragged_decode_kernel).
//
// What bounds it on the H100: bytes.  Each call reads q and the live K/V
// rows of every slot (2 * (pos[b] + 1) * Hkv * hd elements per slot) and
// does about 4 * rep * hd operations per K/V row read (about 7 per byte at
// qwen2-0.5b's rep 7), far below the ~295 operations per byte at which the
// tensor cores, not HBM, become the limit.  So the design puts every SM on
// the cache read and moves no byte it does not need:
//   * split-K (flash-decoding): the grid is (n_split, Hkv, B); each block
//     takes one split of L cache rows of one slot, for all `rep` query
//     heads of its kv group, so a K/V row is read from device memory once.
//     n_split and L come from B, Hkv, Smax and the SM count alone (ops.py,
//     about two blocks per SM), never from pos: reading pos on the host
//     would cost a sync per layer.  Blocks whose split starts past the
//     slot's newest row return at once; rows past it are never read;
//   * each live block writes its un-normalised (acc, m, l) to scratch, and
//     a second small kernel merges a head's live splits (it reads pos on
//     the device): M = max m_i, out = sum e^(m_i - M) acc_i /
//     max(sum e^(m_i - M) l_i, 1e-30);
//   * bf16: 16-byte cp.async loads along hd into a 2-stage ring, K/V kept
//     bf16 in shared memory with the 16-byte chunks XOR-swizzled by row so
//     ldmatrix reads them without bank conflicts; scores and P.V on tensor
//     cores (mma.sync m16n8k16, f32 accumulate) with the group's rep <= 16
//     query heads as the 16 rows of A (zero rows pad rep 7); each warp
//     owns 16 rows of every 64-row tile and keeps its own online softmax on
//     the accumulator fragment, P rounded to bf16 in registers as the A
//     operand of P.V; the block's four warps merge before the write;
//   * float32: the same split and merge with CUDA-core FMAs (there are no
//     f32 tensor cores without TF32, and the f32 check does not allow
//     TF32), 16-byte loads.
//
// Semantics follow the TPU kernel: scores are dot(q, k) * scale in f32,
// masked past pos[b] (a masked row takes p = 0); p is rounded to the
// cache's type before the PV product, against the running max of its split
// (warp) rather than the final max; the output is f32 acc / max(l, 1e-30).
// A position past the cache attends all Smax rows; pos = 0 reads one row;
// with the log-sum-exp output a negative position reads none (out 0,
// log-sum-exp -inf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRep = 16;          // query heads per kv head
constexpr int kTile = 64;            // cache rows per bf16 tile; L % kTile == 0
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// Scratch of one call: part_acc (B, Hkv, n_split, rep, HD) f32 and part_ml
// (B, Hkv, n_split, rep, 2) f32 (m, l); only live splits are written.
__device__ __forceinline__ size_t part_row(int b, int g, int split, int r,
                                           int Hkv, int n_split, int rep) {
  return ((static_cast<size_t>(b) * Hkv + g) * n_split + split) * rep + r;
}

// ------------------------------------------------------------------ bf16
// q: (B, Hkv * rep, HD); k, v: (B, Smax, Hkv, HD); pos: (B,) int32.
// Grid (n_split, Hkv, B), kThreads threads, dynamic shared memory
// 2 stages x (K + V) x kTile x HD bf16.
template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_split_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ pos,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int Smax, int Hkv, int rep, int L, float scale) {
  constexpr int CH = HD / 8;                 // 16-byte chunks per row
  constexpr int TILE = kTile * HD;           // elements per tile
  constexpr int NT = HD / 8;                 // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][kTile][HD], swizzled
  bf16* vs = ks + 2 * TILE;

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int last = min(pos[b], Smax - 1);    // newest live row
  const int start = split * L;
  if (start > last) return;                  // a dead split writes nothing
  const int end = min(start + L, last + 1);  // exclusive
  const int n_tiles = (end - start + kTile - 1) / kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * rep;

  const size_t row_stride = static_cast<size_t>(Hkv) * HD;
  const bf16* kb = k + static_cast<size_t>(b) * Smax * row_stride +
                   static_cast<size_t>(g) * HD;
  const bf16* vb = v + static_cast<size_t>(b) * Smax * row_stride +
                   static_cast<size_t>(g) * HD;

  // 16-byte chunk ch of tile row j sits at chunk ch ^ (j & 7)
  auto load_tile = [&](int t) {
    const int r0 = start + t * kTile, st = (t & 1) * TILE;
    for (int c = tid; c < kTile * CH; c += kThreads) {
      const int j = c / CH, ch = c % CH, row = r0 + j;
      const bool live = row < end;
      const size_t off = static_cast<size_t>(live ? row : start) * row_stride
                         + ch * 8;
      const int so = st + j * HD + ((ch ^ (j & 7)) << 3);
      sm90::cp_async16(ks + so, kb + off, live);
      sm90::cp_async16(vs + so, vb + off, live);
    }
    sm90::cp_async_commit();
  };
  load_tile(0);

  // Q as the A operand: rows = the group's query heads (zero past rep)
  uint32_t qa[HD / 16][4];
  {
    const int r_lo = lane >> 2, r_hi = r_lo + 8, c = (lane & 3) * 2;
    const bf16* qg = q + (static_cast<size_t>(b) * Hq + g * rep) * HD;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int d = kk * 16 + c;
      auto ld = [&](int r, int dd) -> uint32_t {
        return r < rep ? *reinterpret_cast<const uint32_t*>(
                             qg + static_cast<size_t>(r) * HD + dd)
                       : 0u;
      };
      qa[kk][0] = ld(r_lo, d);
      qa[kk][1] = ld(r_hi, d);
      qa[kk][2] = ld(r_lo, d + 8);
      qa[kk][3] = ld(r_hi, d + 8);
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int jw = warp * 16;                  // this warp's rows of a tile

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1);
    else sm90::cp_async_commit();            // an empty group keeps the count
    sm90::cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + (t & 1) * TILE;
    const bf16* vt = vs + (t & 1) * TILE;

    // S = Q K^T for this warp's 16 rows: two n8 tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int key = jw + (lane & 7) + ((lane >> 4) << 3);
      const int ch = 2 * kk + ((lane >> 3) & 1);
      uint32_t b0, b1, b2, b3;
      sm90::ldmatrix_x4(b0, b1, b2, b3,
                        kt + key * HD + ((ch ^ (key & 7)) << 3));
      sm90::mma_bf16_16816(s[0], qa[kk], b0, b1);
      sm90::mma_bf16_16816(s[1], qa[kk], b2, b3);
    }

    // online softmax on the fragment: rows lane/4 (i = 0) and +8 (i = 1)
    const int kbase = start + t * kTile + jw + (lane & 3) * 2;
    bool live[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) live[n][e] = kbase + n * 8 + e < end;
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[n][2 * i + e] * scale;
          s[n][2 * i + e] = x;
          if (live[n][e]) mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = live[n][e] ? expf(s[n][2 * i + e] - m_new) : 0.f;
          s[n][2 * i + e] = p;
          sum += p;
        }
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // P (16 x 16 keys) as the A operand, rounded to bf16
    const uint32_t pa[4] = {sm90::pack_bf16(s[0][0], s[0][1]),
                            sm90::pack_bf16(s[0][2], s[0][3]),
                            sm90::pack_bf16(s[1][0], s[1][1]),
                            sm90::pack_bf16(s[1][2], s[1][3])};
    // O += P V: V rows are keys (k), columns hd (n), read transposed
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      const int key = jw + (lane & 7) + (((lane >> 3) & 1) << 3);
      const int ch = 2 * dp + (lane >> 4);
      uint32_t b0, b1, b2, b3;
      sm90::ldmatrix_x4_trans(b0, b1, b2, b3,
                              vt + key * HD + ((ch ^ (key & 7)) << 3));
      sm90::mma_bf16_16816(acc[2 * dp], pa, b0, b1);
      sm90::mma_bf16_16816(acc[2 * dp + 1], pa, b2, b3);
    }
    __syncthreads();                         // the stage is free again
  }

  // merge the four warps in shared memory (the tiles are no longer read)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(~0u, l[i], 1);
    l[i] += __shfl_xor_sync(~0u, l[i], 2);
  }
  float* w_acc = reinterpret_cast<float*>(smem);   // [4][16][HD]
  float* w_m = w_acc + 4 * 16 * HD;                // [4][16]
  float* w_l = w_m + 4 * 16;                       // [4][16]
  const int r_lo = lane >> 2;
  if ((lane & 3) == 0) {
    w_m[warp * 16 + r_lo] = m[0];
    w_m[warp * 16 + r_lo + 8] = m[1];
    w_l[warp * 16 + r_lo] = l[0];
    w_l[warp * 16 + r_lo + 8] = l[1];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r_lo + 8 * (e >> 1), d = n * 8 + (lane & 3) * 2 + (e & 1);
      w_acc[(warp * 16 + r) * HD + d] = acc[n][e];
    }
  __syncthreads();
  for (int e = tid; e < rep * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, w_m[w * 16 + r]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float c = expf(w_m[w * 16 + r] - M);
      a += c * w_acc[(w * 16 + r) * HD + d];
      ls += c * w_l[w * 16 + r];
    }
    const size_t pr = part_row(b, g, split, r, Hkv, n_split, rep);
    part_acc[pr * HD + d] = a;
    if (d == 0) {
      part_ml[pr * 2] = M;
      part_ml[pr * 2 + 1] = ls;
    }
  }
}

// ------------------------------------------------------------------ f32
// Same grid and scratch; CUDA-core FMAs, BK rows per tile.
template <int HD, int BK>
__global__ void __launch_bounds__(kThreads)
decode_split_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ pos,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 int Smax, int Hkv, int rep, int L, float scale) {
  constexpr int kAcc = kMaxRep * HD / kThreads;  // output cells per thread
  constexpr int V4 = HD / 4;                     // float4 per row
  __shared__ float q_s[kMaxRep][HD];
  __shared__ float k_s[BK][HD + 1];               // +1: conflict-free rows
  __shared__ float v_s[BK][HD];
  __shared__ float p_s[kMaxRep][BK];
  __shared__ float m_s[kMaxRep], l_s[kMaxRep], corr_s[kMaxRep];

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int last = min(pos[b], Smax - 1);
  const int start = split * L;
  if (start > last) return;
  const int end = min(start + L, last + 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * rep;

  const float* qb = q + (static_cast<size_t>(b) * Hq + g * rep) * HD;
  for (int e = tid; e < rep * HD; e += kThreads) q_s[e / HD][e % HD] = qb[e];
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const size_t row_stride = static_cast<size_t>(Hkv) * HD;
  const float* kb = k + static_cast<size_t>(b) * Smax * row_stride +
                    static_cast<size_t>(g) * HD;
  const float* vb = v + static_cast<size_t>(b) * Smax * row_stride +
                    static_cast<size_t>(g) * HD;
  __syncthreads();

  for (int k0 = start; k0 < end; k0 += BK) {
    for (int e = tid; e < BK * V4; e += kThreads) {
      const int j = e / V4, d = (e % V4) * 4, row = k0 + j;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (row < end) {
        kv = *reinterpret_cast<const float4*>(kb + row * row_stride + d);
        vv = *reinterpret_cast<const float4*>(vb + row * row_stride + d);
      }
      k_s[j][d] = kv.x;
      k_s[j][d + 1] = kv.y;
      k_s[j][d + 2] = kv.z;
      k_s[j][d + 3] = kv.w;
      *reinterpret_cast<float4*>(&v_s[j][d]) = vv;
    }
    __syncthreads();

    for (int e = tid; e < rep * BK; e += kThreads) {
      const int r = e / BK, j = e % BK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s += q_s[r][d] * k_s[j][d];
      p_s[r][j] = (k0 + j < end) ? s * scale : kNegInf;
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
        const float p = (k0 + j < end) ? expf(p_s[r][j] - m_new) : 0.f;
        sum += p;
        p_s[r][j] = p;
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

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads, r = e / HD, d = e % HD;
    if (r < rep)
      part_acc[part_row(b, g, split, r, Hkv, n_split, rep) * HD + d] = acc[i];
  }
  for (int r = tid; r < rep; r += kThreads) {
    const size_t pr = part_row(b, g, split, r, Hkv, n_split, rep);
    part_ml[pr * 2] = m_s[r];
    part_ml[pr * 2 + 1] = l_s[r];
  }
}

// --------------------------------------------------------------- combine
// Merge each (slot, query head)'s live splits.  Grid (Hq, B), HD threads.
// kLse: also write the log-sum-exp of the head's scores, M + log(sum), to
// ``lse``; there a slot with no live row (pos < 0: a shard of the cache
// that lies wholly past the slot's newest row) merges nothing and gives
// out 0 and -inf, the value a merge across cache shards weighs by.  Without
// it the body is the one the unsharded decode has always run.
template <int HD, bool kLse>
__global__ void __launch_bounds__(HD)
decode_combine(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, const int* __restrict__ pos,
               float* __restrict__ out, float* __restrict__ lse, int Smax,
               int Hkv, int rep, int n_split, int L) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int g = h / rep, r = h % rep;
  const int last = min(pos[b], Smax - 1);
  int n_live = min(last / L + 1, n_split);
  if constexpr (kLse) n_live = last < 0 ? 0 : n_live;
  float M = kNegInf;
  for (int i = 0; i < n_live; ++i)
    M = fmaxf(M, part_ml[part_row(b, g, i, r, Hkv, n_split, rep) * 2]);
  float num = 0.f, den = 0.f;
  for (int i = 0; i < n_live; ++i) {
    const size_t pr = part_row(b, g, i, r, Hkv, n_split, rep);
    const float c = expf(part_ml[pr * 2] - M);
    den += c * part_ml[pr * 2 + 1];
    num += c * part_acc[pr * HD + d];
  }
  out[(static_cast<size_t>(b) * Hkv * rep + h) * HD + d] =
      num / fmaxf(den, 1e-30f);
  if constexpr (kLse) {
    if (d == 0)
      lse[static_cast<size_t>(b) * Hkv * rep + h] =
          n_live > 0 ? M + logf(den) : __uint_as_float(0xff800000u);
  }
}

template <int HD>
void launch_combine(const float* pacc, const float* pml, const int* pos,
                    float* out, float* lse, int B, int Smax, int Hkv,
                    int rep, int n_split, int L, cudaStream_t s) {
  const dim3 grid(Hkv * rep, B);
  if (lse != nullptr)
    decode_combine<HD, true><<<grid, HD, 0, s>>>(
        pacc, pml, pos, out, lse, Smax, Hkv, rep, n_split, L);
  else
    decode_combine<HD, false><<<grid, HD, 0, s>>>(
        pacc, pml, pos, out, nullptr, Smax, Hkv, rep, n_split, L);
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* pos, float* pacc, float* pml, int B,
                        int Smax, int Hkv, int rep, int n_split, int L,
                        float scale, cudaStream_t s) {
  constexpr int kSmem = 2 * 2 * kTile * HD * sizeof(bf16);
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return attr;
  decode_split_bf16<HD><<<dim3(n_split, Hkv, B), kThreads, kSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), pos, pacc, pml, Smax, Hkv, rep, L, scale);
  return cudaSuccess;
}

template <int HD, int BK>
void launch_f32(const void* q, const void* k, const void* v, const int* pos,
                float* pacc, float* pml, int B, int Smax, int Hkv, int rep,
                int n_split, int L, float scale, cudaStream_t s) {
  decode_split_f32<HD, BK><<<dim3(n_split, Hkv, B), kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), pos, pacc, pml, Smax, Hkv, rep, L,
      scale);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  scratch: B * Hkv * n_split * rep * (hd + 2)
// floats (part_acc, then part_ml).  lse: null, or (B, Hq) floats for each
// head's log-sum-exp.  Two launches: the split pass and the combine.
// Returns cudaGetLastError() after them (cudaErrorInvalidValue for a shape
// or split the kernel does not take).
extern "C" int ragged_decode_launch(int dtype, const void* q, const void* k,
                                    const void* v, const void* pos, void* out,
                                    void* lse, void* scratch, int B,
                                    int Smax, int Hkv, int rep, int hd,
                                    int n_split, int L, float scale,
                                    void* stream) {
  if (B <= 0 || Smax <= 0 || Hkv <= 0 || rep < 1 || rep > kMaxRep ||
      n_split <= 0 || L <= 0 || L % kTile != 0 ||
      static_cast<long long>(n_split) * L < Smax ||
      static_cast<long long>(n_split - 1) * L >= Smax ||
      (hd != 64 && hd != 128) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* pacc = static_cast<float*>(scratch);
  float* pml = pacc + static_cast<size_t>(B) * Hkv * n_split * rep * hd;
  cudaError_t err = cudaSuccess;
  if (dtype == 1 && hd == 64)
    err = launch_bf16<64>(q, k, v, p, pacc, pml, B, Smax, Hkv, rep, n_split,
                          L, scale, s);
  else if (dtype == 1)
    err = launch_bf16<128>(q, k, v, p, pacc, pml, B, Smax, Hkv, rep,
                           n_split, L, scale, s);
  else if (hd == 64)
    launch_f32<64, 64>(q, k, v, p, pacc, pml, B, Smax, Hkv, rep, n_split, L,
                       scale, s);
  else
    launch_f32<128, 32>(q, k, v, p, pacc, pml, B, Smax, Hkv, rep, n_split,
                        L, scale, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* o = static_cast<float*>(out);
  float* ls = static_cast<float*>(lse);
  if (hd == 64)
    launch_combine<64>(pacc, pml, p, o, ls, B, Smax, Hkv, rep, n_split, L, s);
  else
    launch_combine<128>(pacc, pml, p, o, ls, B, Smax, Hkv, rep, n_split, L,
                        s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
