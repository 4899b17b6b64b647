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
// chunk (T = 256, start 768, qwen2-0.5b's 14/2 heads) 0.82 GFLOP, over a
// thousand operations per byte, far past the ~295 at which the tensor
// cores, not HBM, are the limit.  So the bf16 route runs on the tensor
// cores (wgmma), in the manner of the flash kernel:
//   * GQA is folded into wgmma's M: folded row i of kv head g is chunk
//     token i / rep and query head g * rep + i % rep, so a 64-row tile
//     spans about 64 / rep tokens (9 at rep 7) and every K/V tile it loads
//     serves all 64 rows.  q is read, and the f32 output written, in the
//     model's (B, T, Hq, hd) layout: nothing is transposed or copied;
//   * the Q tile's rows are not one stride apart (rep heads, then the next
//     token), so it comes once per block by 16-byte cp.async loads into
//     the 128-byte-swizzled layout that wgmma reads (8 KB at hd 64);
//   * K/V tiles of 64 rows come by TMA from the (B, Smax, Hkv, hd) cache
//     into a 2-stage mbarrier ring per warpgroup; rows past the cache are
//     zero-filled;
//   * S = Q K^T as wgmma m64n64k16 from shared memory; the online softmax
//     runs in log2 units on the accumulator fragment; P is rounded to bf16
//     in registers (the reference's p.astype(v.dtype)) and is wgmma's
//     register A operand for O += P V, V the MN-major B operand;
//   * each tile stops at its own causal horizon, start + its last live
//     token (capped at the cache): key tiles past it are never loaded.
//     Only key tiles that cross a row's horizon or the cache's end, and
//     tiles holding padded rows (token >= qlen), are masked; masked p is
//     exactly 0, so a fully padded row has l = 0 and writes exact zeros;
//   * one block per (64-row tile, kv head, slot), heaviest tiles (latest
//     tokens) first; its two warpgroups take alternate key tiles, each
//     with its own online softmax, and merge (m, l, O) through shared
//     memory at the end.  The serving chunk has only 56 such tiles for
//     132 SMs; cutting each tile's key range over more blocks (split-K
//     with a merge kernel) was measured and dropped: on an H100 SXM at
//     700 W it was 3-5 % faster at the serving chunk, 25 % slower at a
//     first chunk and slower at B=4.
// float32 keeps a CUDA-core kernel (below), routed by type: there are no
// f32 tensor cores without TF32, and the f32 check does not allow TF32.
//
// Semantics follow the TPU kernel: scores dot(q, k) * scale in f32,
// masked past each row's position; p is rounded to the cache's type before
// the PV product; the output is f32 acc / max(l, 1e-30), exact zeros on
// padded rows.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kMaxRep = 16;          // query heads per kv head
constexpr float kNegInf = -1e30f;
using bf16 = __nv_bfloat16;
using sm90::fast_exp2;
using sm90::load_tile;
using sm90::MapAxes;

// ------------------------------------------------------------------ bf16

constexpr int kRows = 64;              // folded rows per tile, keys per tile
constexpr int kBox = sm90::kBoxElems;  // elements of one 64 x 64 box
constexpr int kStages = 2;             // K/V ring depth per warpgroup

// Grid n_tiles * Hkv * B, 256 threads.  q: (B, T, Hkv * rep, HD) bf16; the
// cache through kmap / vmap; start, qlen: (B,) int32; out: (B, T, Hkv *
// rep, HD) f32.
template <int HD>
__global__ void __launch_bounds__(256)
prefill_bf16_wgmma(const bf16* __restrict__ q,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, MapAxes kax,
                   MapAxes vax, const int* __restrict__ start,
                   const int* __restrict__ qlen, float* __restrict__ out,
                   int B, int n_tok, int Smax, int Hkv, int rep,
                   float scale_log2) {
  constexpr int NO = HD / 2;                 // O accumulators per thread
  constexpr int kTile = kRows * HD;          // elements of a 64-row tile
  constexpr int kTileBytes = kTile * 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv[2][kStages];
  // 128-byte swizzle atoms repeat every 1024 bytes: align the tiles to it
  bf16* q_s = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* kv_s = q_s + kTile;                  // [wg][stage][K, V][tile]
  auto stage_s = [&](int w, int i) {
    return kv_s + (w * kStages + i % kStages) * 2 * kTile;
  };

  const int rows = n_tok * rep;              // folded rows of kv head g
  const int n_tiles = (rows + kRows - 1) / kRows;
  const int item = blockIdx.x;
  const int tile = n_tiles - 1 - item / (Hkv * B);
  const int g = item % Hkv, b = item / Hkv % B;
  const int i0 = tile * kRows;
  const int start_b = start[b], qlen_b = qlen[b];
  const int Hq = Hkv * rep;

  // the tile's causal horizon: keys 0 .. start + its last live token,
  // capped at the cache; none when its first token is padding
  const int t_first = i0 / rep;
  const int t_end = (min(i0 + kRows, rows) - 1) / rep;   // its last token
  const int n_keys =
      t_first < qlen_b ? min(start_b + min(t_end, qlen_b - 1) + 1, Smax) : 0;
  const int n_kt = (n_keys + kRows - 1) / kRows;
  // a key tile needs masking only if it crosses the smallest horizon of
  // the tile's rows, which is -1 when a row is padding or past the chunk
  const int tile_lim = i0 + kRows <= rows && t_end < qlen_b
                           ? min(start_b + t_first, Smax - 1)
                           : -1;

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int lane = tid & 31, warp = wtid >> 5;
  const int n_mine = (n_kt - wg + 1) / 2;   // key tiles wg, wg + 2, ...

  if (tid == 0) {
    for (int i = 0; i < 2 * kStages; ++i)
      sm90::mbar_init(&bar_kv[i / kStages][i % kStages], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  // this warpgroup's i-th key tile into its stage i % kStages
  auto load_kv = [&](int i) {
    uint64_t* bar = &bar_kv[wg][i % kStages];
    bf16* dst = stage_s(wg, i);
    const int kt = wg + 2 * i;
    sm90::mbar_expect_tx(bar, 2 * kTileBytes);
    load_tile<HD>(dst, &kmap, kax, bar, kt * kRows, g, b);
    load_tile<HD>(dst + kTile, &vmap, vax, bar, kt * kRows, g, b);
  };
  if (wtid == 0)
    for (int i = 0; i < kStages - 1 && i < n_mine; ++i) load_kv(i);

  // the Q tile: 16-byte chunks into the 128-byte swizzle (chunk c of a
  // 128-byte row r lands at chunk c ^ (r % 8)); rows past the chunk are 0
  for (int c = tid; c < kRows * HD / 8; c += 256) {
    const int row = c / (HD / 8), ch = c % (HD / 8);
    const int gi = i0 + row;
    const bool live = gi < rows;
    const int gc = live ? gi : 0;
    const int t = gc / rep, r = gc - t * rep;
    const bf16* src =
        q + (((size_t)b * n_tok + t) * Hq + (size_t)g * rep + r) * HD + ch * 8;
    bf16* dst = q_s + (ch / 8) * kBox + row * 64 + ((ch % 8) ^ (row & 7)) * 8;
    sm90::cp_async16(dst, src, live);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();
  __syncthreads();

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  // m is kept in log2 units: scores times scale * log2(e)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float s[32];                               // overwritten by each S = Q K^T
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = 0.f;
  // fragment rows r_lo and r_lo + 8; a row sees keys 0 .. lim (-1: none)
  const int r_lo = warp * 16 + (lane >> 2);
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gi = i0 + r_lo + 8 * r, t = gi / rep;
    lim[r] = gi < rows && t < qlen_b ? min(start_b + t, Smax - 1) : -1;
  }

  for (int i = 0; i < n_mine; ++i) {
    // the stage of tile i + kStages - 1 was freed at the end of tile i - 1
    if (wtid == 0 && i + kStages - 1 < n_mine) load_kv(i + kStages - 1);
    sm90::mbar_wait(&bar_kv[wg][i % kStages], (i / kStages) & 1);
    const bf16* kt = stage_s(wg, i);
    const bf16* vt = kt + kTile;

    // S = Q K^T (64 x 64), 16 columns of hd per step
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * kBox + (kk % 4) * 16;
      sm90::wgmma_ss_m64n64k16(s, sm90::wgmma_desc_sw128(q_s + off, 16, 1024),
                               sm90::wgmma_desc_sw128(kt + off, 16, 1024),
                               kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 32; ++j) sm90::reg_fence(s[j]);

    // online softmax on the fragment: s[4j + e] is row r_lo + 8 (e / 2),
    // key k0 + 8j + 2 (lane % 4) + e % 2
    const int k0 = (wg + 2 * i) * kRows;
    const bool masked = k0 + kRows - 1 > tile_lim;
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * r + e];
          if (masked && k0 + 8 * j + 2 * (lane & 3) + e > lim[r])
            x = kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      corr[r] = fast_exp2(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * r + e];
          float p = fast_exp2(fmaf(x, scale_log2, -m_new));
          if (masked && k0 + 8 * j + 2 * (lane & 3) + e > lim[r]) p = 0.f;
          x = p;
          sum += p;
        }
      l[r] = l[r] * corr[r] + sum;
      m[r] = m_new;
    }
    // P rounded to bf16 as wgmma's register A operand, 16 keys per step
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = sm90::pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }

    // O += P V
#pragma unroll
    for (int j = 0; j < NO; ++j) sm90::reg_fence(o[j]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // V rows kk*16.. (K of the product), hd the MN dim: 8-row groups
      // 1024 B apart, the two 64-wide halves of hd 128 one box apart
      const uint64_t dv =
          sm90::wgmma_desc_sw128(vt + kk * 16 * 64, kBox * 2, 1024);
      if constexpr (HD == 64)
        sm90::wgmma_rs_m64n64k16(o, pa[kk], dv, 1);
      else
        sm90::wgmma_rs_m64n128k16(o, pa[kk], dv, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NO; ++j) sm90::reg_fence(o[j]);
    // this warpgroup's stage is free again
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(~0u, l[r], 1);
    l[r] += __shfl_xor_sync(~0u, l[r], 2);
  }
  // merge: warpgroup 1 hands its (m, l, O) over in fragment order
  __syncthreads();                           // every tile has been read
  float* x_o = reinterpret_cast<float*>(kv_s);   // [NO][128]
  float* x_ml = x_o + NO * 128;                  // [4][128]: m0 m1 l0 l1
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < NO; ++j) x_o[j * 128 + wtid] = o[j];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      x_ml[r * 128 + wtid] = m[r];
      x_ml[(2 + r) * 128 + wtid] = l[r];
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gi = i0 + r_lo + 8 * r;
    if (gi >= rows) continue;
    const int t = gi / rep, h = g * rep + gi - t * rep;
    const bool live = t < qlen_b;
    const float m1 = x_ml[r * 128 + wtid], l1 = x_ml[(2 + r) * 128 + wtid];
    const float M = fmaxf(m[r], m1);
    const float c0 = fast_exp2(m[r] - M), c1 = fast_exp2(m1 - M);
    const float inv = 1.f / fmaxf(c0 * l[r] + c1 * l1, 1e-30f);
    float* dst = out + (((size_t)b * n_tok + t) * Hq + h) * HD +
                 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int a = 4 * j + 2 * r;
      float2 y = make_float2(0.f, 0.f);
      if (live) {
        y.x = (c0 * o[a] + c1 * x_o[a * 128 + wtid]) * inv;
        y.y = (c0 * o[a + 1] + c1 * x_o[(a + 1) * 128 + wtid]) * inv;
      }
      *reinterpret_cast<float2*>(dst + 8 * j) = y;
    }
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* start, const void* qlen, void* out,
                        int B, int n_tok, int Smax, int Hkv, int rep,
                        float scale, cudaStream_t stream) {
  // align + Q + 2 warpgroups x kStages x (K, V)
  constexpr int kSmem = 1024 + (1 + 4 * kStages) * kRows * HD * 2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_bf16_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return attr;
  // the (B, Smax, Hkv, hd) cache as (batch, head, seq) strides
  const long long st[3] = {1LL * Smax * Hkv * HD, HD, 1LL * Hkv * HD};
  CUtensorMap km, vm;
  MapAxes ka, va;
  if (!sm90::make_map(&km, &ka, k, B, Hkv, Smax, HD, st) ||
      !sm90::make_map(&vm, &va, v, B, Hkv, Smax, HD, st))
    return cudaErrorInvalidValue;
  const long long items =
      1LL * ((n_tok * rep + kRows - 1) / kRows) * Hkv * B;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  prefill_bf16_wgmma<HD><<<static_cast<unsigned>(items), 256, kSmem, stream>>>(
      static_cast<const bf16*>(q), km, vm, ka, va,
      static_cast<const int*>(start), static_cast<const int*>(qlen),
      static_cast<float*>(out), B, n_tok, Smax, Hkv, rep,
      scale * 1.4426950408889634f);
  return cudaSuccess;
}

// ------------------------------------------------------------------ f32

constexpr int kTPR = 8;              // threads per folded row

// q: (B, T, Hkv * rep, HD); k, v: (B, Smax, Hkv, HD); start, qlen: (B,)
// int32; out: (B, T, Hkv * rep, HD) f32.  Grid (ceil(T * rep / BQ), Hkv,
// B), kTPR * BQ threads: eight threads share a folded row, each owning
// every eighth element of hd, so a score is eight partial dot products
// joined by three warp shuffles; K/V tiles are staged in shared memory.
template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(kTPR * BQ)
prefill_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const int* __restrict__ start,
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
    qr[e] = live ? q[row_off + e * kTPR + part] : 0.f;
    acc[e] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const size_t kv_row = (size_t)Hkv * HD;         // between cache rows
  const float* kb = k + (size_t)b * Smax * kv_row + (size_t)g * HD;
  const float* vb = v + (size_t)b * Smax * kv_row + (size_t)g * HD;

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    for (int e = tid; e < BK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, kr = k0 + j;
      const bool have = kr < n_keys;
      k_s[j][d] = have ? kb[kr * kv_row + d] : 0.f;
      v_s[j][d] = have ? vb[kr * kv_row + d] : 0.f;
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
      s[j] = p;
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

template <int HD, int BQ, int BK>
void launch_f32(const void* q, const void* k, const void* v,
                const void* start, const void* qlen, void* out, int B,
                int n_tok, int Smax, int Hkv, int rep, float scale,
                cudaStream_t stream) {
  const dim3 grid((n_tok * rep + BQ - 1) / BQ, Hkv, B);
  prefill_f32<HD, BQ, BK><<<grid, kTPR * BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(start),
      static_cast<const int*>(qlen), static_cast<float*>(out), n_tok, Smax,
      Hkv, rep, scale);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernel does not take, or a
// cache TMA cannot address).
extern "C" int ragged_prefill_launch(int dtype, const void* q, const void* k,
                                     const void* v, const void* start,
                                     const void* qlen, void* out, int B,
                                     int n_tok, int Smax, int Hkv, int rep,
                                     int hd, float scale, void* stream) {
  if (B <= 0 || n_tok <= 0 || Smax <= 0 || Hkv <= 0 || rep < 1 ||
      rep > kMaxRep || B > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (dtype == 0 && hd == 64)
    launch_f32<64, 32, 64>(q, k, v, start, qlen, out, B, n_tok, Smax, Hkv,
                           rep, scale, s);
  else if (dtype == 0 && hd == 128)
    launch_f32<128, 32, 32>(q, k, v, start, qlen, out, B, n_tok, Smax, Hkv,
                            rep, scale, s);
  else if (dtype == 1 && hd == 64)
    err = launch_bf16<64>(q, k, v, start, qlen, out, B, n_tok, Smax, Hkv,
                          rep, scale, s);
  else if (dtype == 1 && hd == 128)
    err = launch_bf16<128>(q, k, v, start, qlen, out, B, n_tok, Smax, Hkv,
                           rep, scale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
