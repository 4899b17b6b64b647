// Flash attention backward (GQA, causal or not) for Hopper (sm_90a): the
// gradient of flash_attention.cu's forward, for training.
//
// The TPU package has no backward kernel: its training attention is the
// jnp blocked_attention (repro/models/layers.py), differentiated by
// autodiff.  The port computes whole-sequence attention with its own
// flash kernel (the counterpart of flash_attention_pallas,
// repro/kernels/flash_attention/kernel.py), so its gradient is a kernel
// too: FlashAttention-2's backward.  Given q, k, v, the forward's output o,
// the output's gradient dO and the rows' log-sum-exp (natural-log units,
// written by the forward):
//   D  = rowsum(dO * o)
//   P  = exp(scale * q k^T - lse)                (recomputed, never stored)
//   dV = P^T dO;  dP = dO v^T;  dS = P * (dP - D)
//   dQ = scale * dS k;  dK = scale * dS^T q
//
// What bounds it on the H100: operations.  Seven products of 2 * hd
// operations per (query head, visible pair): S^T, dP^T, dV and dK in the
// dK / dV kernel, S, dP and dQ in the dQ kernel (five are needed; the two
// recomputed ones are the price of keeping float atomics out, so the
// gradient is bitwise deterministic), against one read of q, k, v, o, dO
// and one write of dq, dk, dv.  At qwen2-0.5b's training shape (B 8, S
// 1024, 14/2 heads, hd 64, causal) the five needed products are 37.6
// GFLOP against 68 MB: a bound of ~0.038 ms.
//
// The bf16 route, built like the forward (wgmma from TMA-filled tiles):
//   * three launches: a stats pass, dQ, then dK / dV.  The stats pass
//     writes, per 64-query tile of a (batch, head), one 512-byte block:
//     the rows' lse in log2 units and D = rowsum(dO * o), zeros past Sq.
//     It reads o and dO with 16-byte loads, eight threads to a row (D at
//     the memory rate rather than 2 bytes a lane);
//   * every tile moves by TMA: Q, K, V and dO through 4-D tensor maps over
//     the operands' (batch, head, seq) strides (the model's transposed
//     (B, S, H, hd) views are read in place, no copy), 128-byte swizzled,
//     ragged tiles zero-filled; a stats block by one bulk copy on the same
//     mbarrier.  One elected thread per warpgroup issues the next tile one
//     item ahead of the math, into a two-stage ring; no thread computes an
//     address for a copy.  (Four stages measured no faster in dK / dV, and
//     slower in dQ, whose 81 KB at hd 64 let two blocks share an SM.  A
//     software pipeline of dK / dV, item i + 1's S^T and dP^T issued ahead
//     of item i's dV and dK, measured slower too: 0.126 against 0.105 ms
//     a call at the training shape);
//   * every product is a wgmma, with f32 accumulators.  dK / dV: keys are
//     wgmma's M, so S^T = K Q^T and dP^T = V dO^T (shared x shared,
//     K-major) leave P^T and dS^T in accumulator layout, rounded to bf16
//     in registers as the A operands of dV += P^T dO and dK += dS^T Q
//     (dO and Q the MN-major B operands, as V is in the forward's P V).
//     lse and D are indexed by the accumulator's column (the query), so
//     they come from the stats block in shared memory.  dQ: S = Q K^T and
//     dP = dO V^T, then dQ += dS K (K the MN-major B); each row's lse and
//     D sit in registers.  The S product's completion is awaited before
//     dP's, so exp2 overlaps the second product;
//   * the grid: a dK / dV block owns one 64-key tile of one kv head and
//     loops over the GQA group's query heads and the query tiles that see
//     its keys (the GQA sum stays in the block: no atomics).  At the
//     training shape that is 256 blocks, one per SM at a time (the
//     accumulators need ~200 registers a thread).  Each block holds two
//     warpgroups (256 threads) that take alternate items, so its serial
//     chain is halved; blocks are issued heaviest first (key tile 0 sees
//     every query tile under the causal mask, the last one its own), so
//     the lighter tiles fill in behind: the busiest SM does ~1.03x the
//     mean.  A dQ block owns a 64-query tile of one query head (1792 at
//     the training shape), heaviest first, its two warpgroups taking
//     alternate key tiles as the forward's do;
//   * determinism: every sum runs in a fixed order.  Each warpgroup
//     accumulates its own items in order; the two merge through shared
//     memory (warpgroup 0's plus warpgroup 1's) before the store.  No
//     float atomics anywhere, so two calls give bitwise-equal dq, dk, dv;
//   * only the causal diagonal tile and the ragged last tiles are masked;
//     tiles above the diagonal are never loaded;
//   * hd 80 (hubert-xlarge) runs the hd-128 instantiation with the tensor
//     maps' inner extent 80, as the forward does: TMA zero-fills columns
//     80-127, which leaves the S and dP products unchanged (they stop
//     after the fifth k16 step); the dV, dK and dQ products compute 128
//     columns, 48 of them zero, and only 80 are written;
//   * shared memory: two 64-row tiles kept (K, V or Q, dO) and two rings
//     of two stages of two tiles: 83 KB at hd 64, 163 KB at hd 128.
// float32 keeps CUDA-core kernels (below) and a scalar D pass: there are
// no f32 tensor cores without TF32, and float32 is not on the training
// path, which computes in bf16.
//
// Layout: every operand is (batch, head, seq, hd) addressed through its
// (batch, head, seq) element strides with hd contiguous; bf16 operands
// need 16-byte aligned bases and strides (TMA; the wrapper checks).  lse
// is float32 (B, Hq, Sq) contiguous.  Query head h reads kv head h / rep;
// causal positions start at 0 on both sides; any Sq and Skv; hd 64, 80
// and 128.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// element strides of (batch, head, seq) for q, k, v, o, dO, dq, dk, dv
struct Strides {
  long long q[3], k[3], v[3], o[3], dO[3], dq[3], dk[3], dv[3];
};

// ------------------------------------------------------------------ bf16

constexpr int kRows = 64;              // queries or keys a tile
constexpr int kBox = sm90::kBoxElems;  // elements of one 64 x 64 TMA box
constexpr int kStages = 2;             // ring depth per warpgroup
constexpr int kStat = 2 * kRows;       // floats of a stats block: lse, D

using sm90::fast_exp2;
using sm90::load_tile;
using sm90::MapAxes;

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc += __uint_as_float(x[i] << 16) * __uint_as_float(y[i] << 16);
    acc += __uint_as_float(x[i] & 0xffff0000u) *
           __uint_as_float(y[i] & 0xffff0000u);
  }
  return acc;
}

// The stats pass.  For query tile t of (batch b, query head h), one block
// of 128 floats at stats + ((b * Hq + h) * n_qt + t) * 128: the rows' lse
// in log2 units, then D = rowsum(dO * o); rows past Sq hold zeros.  Eight
// threads a row, 16-byte loads; grid rows / 32, 256 threads.
__global__ void __launch_bounds__(256)
bwd_stats_bf16(const bf16* __restrict__ o, const bf16* __restrict__ dO,
               const float* __restrict__ lse, float* __restrict__ stats,
               int Hq, int Sq, int n_qt, int hd, Strides st) {
  const long long row = blockIdx.x * 32LL + (threadIdx.x >> 3);
  const int part = threadIdx.x & 7;
  const long long bh = row / (n_qt * kRows);
  const int i = static_cast<int>(row % (n_qt * kRows));
  const int b = static_cast<int>(bh / Hq), h = static_cast<int>(bh % Hq);
  float acc = 0.f;
  if (i < Sq) {
    const bf16* orow = o + b * st.o[0] + h * st.o[1] + i * st.o[2];
    const bf16* drow = dO + b * st.dO[0] + h * st.dO[1] + i * st.dO[2];
    for (int c = part; c < hd / 8; c += 8)
      acc += dot8(*reinterpret_cast<const uint4*>(orow + 8 * c),
                  *reinterpret_cast<const uint4*>(drow + 8 * c));
  }
  acc += __shfl_xor_sync(~0u, acc, 1);
  acc += __shfl_xor_sync(~0u, acc, 2);
  acc += __shfl_xor_sync(~0u, acc, 4);
  if (part == 0) {
    float* dst = stats + (bh * n_qt + i / kRows) * kStat + i % kRows;
    dst[0] = i < Sq ? lse[bh * Sq + i] * kLog2e : 0.f;
    dst[kRows] = acc;
  }
}

// HD is the staged width (64 or 128), HDT <= HD the true head width (the
// tensor maps' inner extent; columns past it arrive zero and are not
// written).  Fragment of a 64 x N wgmma accumulator: element 4j + 2r + e
// of a thread of warp w is row 16w + lane / 4 + 8r, column 8j +
// 2 (lane % 4) + e.

// d (64 x 64) = A B^T over HDT, A and B 64-row tiles in shared memory
// (K-major): S = Q K^T and its kin.
template <int HDT>
__device__ __forceinline__ void ss_product(float (&d)[32], const bf16* a,
                                           const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < HDT / 16; ++kk) {
    const int off = (kk / 4) * kBox + (kk % 4) * 16;
    sm90::wgmma_ss_m64n64k16(d, sm90::wgmma_desc_sw128(a + off, 16, 1024),
                             sm90::wgmma_desc_sw128(b + off, 16, 1024),
                             kk > 0);
  }
}

// acc (64 x HD) += A (64 x 64, bf16 A fragments) * tile (64 rows of HD,
// shared, MN-major): the O += P V shape
template <int HD>
__device__ __forceinline__ void rs_product(float (&acc)[HD / 2],
                                           const uint32_t (&a)[4][4],
                                           const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // rows kk*16.. of the tile (K of the product), hd the MN dim: 8-row
    // groups 1024 B apart, the two 64-wide halves of hd 128 one box apart
    const uint64_t desc =
        sm90::wgmma_desc_sw128(tile + kk * 16 * 64, kBox * 2, 1024);
    if constexpr (HD == 64)
      sm90::wgmma_rs_m64n64k16(acc, a[kk], desc, 1);
    else
      sm90::wgmma_rs_m64n128k16(acc, a[kk], desc, 1);
  }
}

// a 64 x 64 accumulator fragment rounded to bf16 as wgmma's A operand,
// 16 columns (the next product's K) per step
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = sm90::pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void zero_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) sm90::reg_fence(x[i]);
}

// Two warpgroups' 64 x HD partial sums merged in a fixed order (warpgroup
// 0's plus warpgroup 1's, through `x`, HD / 2 * 128 floats of shared
// memory that no copy writes any more), times `mul`, into bf16 rows at
// base + row * rs; rows >= live and columns >= HDT are not written.
// Called by both warpgroups after a __syncthreads.
template <int HD, int HDT>
__device__ __forceinline__ void merge_store(const float (&acc)[HD / 2],
                                            float* x, int wg, int wtid,
                                            bf16* base, long long rs,
                                            int live, float mul) {
  if (wg == 1)
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) x[j * 128 + wtid] = acc[j];
  __syncthreads();
  if (wg == 0) {
    const int lane = wtid & 31, r_lo = (wtid >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      if (row >= live) continue;
      bf16* out = base + row * rs + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < HDT / 8; ++j) {
        const int a = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn((acc[a] + x[a * 128 + wtid]) * mul,
                                  (acc[a + 1] + x[(a + 1) * 128 + wtid]) *
                                      mul);
      }
    }
  }
}

// dQ.  Grid (ceil(Sq / 64) * Hq * B), 256 threads, heaviest query tiles
// first: the forward's shape.  Q and dO tiles once; two warpgroups take
// alternate key tiles, each through its own TMA ring of K / V, with S =
// Q K^T and dP = dO V^T shared x shared, dS = P (dP - D) rounded to bf16
// in registers and dQ += dS K (K the MN-major B), then merge.
template <int HD, int HDT>
__global__ void __launch_bounds__(256, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap dmap, MapAxes qax,
             MapAxes kax, MapAxes vax, MapAxes dax,
             const float* __restrict__ stats, bf16* __restrict__ dq,
             long long ds_b, long long ds_h, long long ds_s, int Hq, int Hkv,
             int Sq, int Skv, int B, int causal, float scale,
             float scale_log2) {
  constexpr int kTile = kRows * HD;
  constexpr int kTileBytes = kTile * 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_kv[2][kStages];
  bf16* q_s = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* do_s = q_s + kTile;
  bf16* kv_s = do_s + kTile;                 // [wg][stage][K, V][tile]
  auto stage_s = [&](int w, int i) {
    return kv_s + (w * kStages + i % kStages) * 2 * kTile;
  };

  const int n_q = (Sq + kRows - 1) / kRows;
  const int qi = n_q - 1 - static_cast<int>(blockIdx.x / (Hq * B));
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq % B;
  const int g = h / (Hq / Hkv);
  const int q0 = qi * kRows;
  const int k_end = causal ? min(Skv, q0 + kRows) : Skv;
  const int n_tiles = (k_end + kRows - 1) / kRows;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int lane = tid & 31, warp = wtid >> 5;
  const int n_mine = (n_tiles - wg + 1) / 2;  // tiles wg, wg + 2, ...

  if (tid == 0) {
    sm90::mbar_init(&bar_q, 1);
    for (int i = 0; i < 2 * kStages; ++i)
      sm90::mbar_init(&bar_kv[i / kStages][i % kStages], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  auto load_kv = [&](int i) {
    uint64_t* bar = &bar_kv[wg][i % kStages];
    bf16* dst = stage_s(wg, i);
    const int t = wg + 2 * i;
    sm90::mbar_expect_tx(bar, 2 * kTileBytes);
    load_tile<HD>(dst, &kmap, kax, bar, t * kRows, g, b);
    load_tile<HD>(dst + kTile, &vmap, vax, bar, t * kRows, g, b);
  };
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar_q, 2 * kTileBytes);
    load_tile<HD>(q_s, &qmap, qax, &bar_q, q0, h, b);
    load_tile<HD>(do_s, &dmap, dax, &bar_q, q0, h, b);
  }
  if (wtid == 0 && n_mine > 0) load_kv(0);

  const int r_lo = warp * 16 + (lane >> 2);  // fragment rows r_lo, r_lo + 8
  const int qpos[2] = {q0 + r_lo, q0 + r_lo + 8};
  const float* st_q = stats + ((static_cast<long long>(b) * Hq + h) * n_q +
                               qi) * kStat;
  const float l2[2] = {st_q[r_lo], st_q[r_lo + 8]};
  const float Dr[2] = {st_q[kRows + r_lo], st_q[kRows + r_lo + 8]};

  float acc[HD / 2];
  zero_regs(acc);
  float s[32], dp[32];
  sm90::mbar_wait(&bar_q, 0);

  for (int i = 0; i < n_mine; ++i) {
    // the stage of tile i + 1 was freed at the end of tile i - 1
    if (wtid == 0 && i + 1 < n_mine) load_kv(i + 1);
    sm90::mbar_wait(&bar_kv[wg][i % kStages], (i / kStages) & 1);
    const bf16* kt = stage_s(wg, i);
    const bf16* vt = kt + kTile;
    zero_regs(s);                            // overwritten: not live across
    zero_regs(dp);
    sm90::wgmma_fence();
    ss_product<HDT>(s, q_s, kt);
    sm90::wgmma_commit();
    ss_product<HDT>(dp, do_s, vt);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    fence_regs(s);
    // P = exp2(S scale log2(e) - lse2), zero where masked
    const int k0 = (wg + 2 * i) * kRows;
    const bool masked = k0 + kRows > Skv || (causal && k0 + kRows - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = x >> 1, kpos = k0 + 8 * j + 2 * (lane & 3) + (x & 1);
        float& p = s[4 * j + x];
        p = fast_exp2(fmaf(p, scale_log2, -l2[r]));
        if (masked && (kpos >= Skv || (causal && kpos > qpos[r]))) p = 0.f;
      }
    sm90::wgmma_wait<0>();
    fence_regs(dp);
    // dS = P (dP - D)
#pragma unroll
    for (int j = 0; j < 32; ++j) dp[j] = s[j] * (dp[j] - Dr[(j >> 1) & 1]);
    uint32_t dsa[4][4];
    to_a(dsa, dp);
    // dQ += dS K
    fence_regs(acc);
    sm90::wgmma_fence();
    rs_product<HD>(acc, dsa, kt);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_regs(acc);
    // this warpgroup's stage is free again
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
  __syncthreads();                           // every tile has been read
  merge_store<HD, HDT>(acc, reinterpret_cast<float*>(kv_s), wg, wtid,
                       dq + b * ds_b + h * ds_h + q0 * ds_s, ds_s, Sq - q0,
                       scale);
}

// dK / dV.  Grid (ceil(Skv / 64) * Hkv * B), 256 threads, key tile 0 (the
// heaviest under the causal mask) first.  A block owns one 64-key tile of
// one kv head: K and V once, then the (query head of the GQA group, query
// tile) items that see its keys, alternately to two warpgroups, each
// through its own TMA ring of Q, dO and the stats block.  Keys are
// wgmma's M: S^T = K Q^T and dP^T = V dO^T shared x shared, so P^T and
// dS^T come out in accumulator layout and are the register A operands of
// dV += P^T dO and dK += dS^T Q (dO and Q the MN-major B).  The GQA sum
// stays in the block; the warpgroups merge in a fixed order.
template <int HD, int HDT>
__global__ void __launch_bounds__(256, 1)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap dmap, MapAxes qax,
               MapAxes kax, MapAxes vax, MapAxes dax,
               const float* __restrict__ stats, bf16* __restrict__ dk,
               bf16* __restrict__ dv, long long dks_b, long long dks_h,
               long long dks_s, long long dvs_b, long long dvs_h,
               long long dvs_s, int Hq, int Hkv, int Sq, int Skv, int B,
               int causal, float scale, float scale_log2) {
  constexpr int kTile = kRows * HD;
  constexpr int kTileBytes = kTile * 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, bar_it[2][kStages];
  bf16* k_s = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* v_s = k_s + kTile;
  bf16* ring = v_s + kTile;                  // [wg][stage][Q, dO][tile]
  float* st_ring = reinterpret_cast<float*>(ring + 2 * kStages * 2 * kTile);
  auto stage_s = [&](int w, int i) {
    return ring + (w * kStages + i % kStages) * 2 * kTile;
  };
  auto stage_st = [&](int w, int i) {
    return st_ring + (w * kStages + i % kStages) * kStat;
  };

  const int kt_i = static_cast<int>(blockIdx.x / (Hkv * B));
  const int g = blockIdx.x % Hkv, b = blockIdx.x / Hkv % B;
  const int k0 = kt_i * kRows;
  const int rep = Hq / Hkv;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int qt0 = causal ? min(kt_i, n_qt) : 0;  // first query tile seeing k0
  const int per_head = n_qt - qt0;
  const int n_items = rep * per_head;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int lane = tid & 31, warp = wtid >> 5;
  const int n_mine = (n_items - wg + 1) / 2;  // items wg, wg + 2, ...

  if (tid == 0) {
    sm90::mbar_init(&bar_kv, 1);
    for (int i = 0; i < 2 * kStages; ++i)
      sm90::mbar_init(&bar_it[i / kStages][i % kStages], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  // this warpgroup's i-th item into its stage i % kStages
  auto load_item = [&](int i) {
    const int it = wg + 2 * i;
    const int h = g * rep + it / per_head, qt = qt0 + it % per_head;
    uint64_t* bar = &bar_it[wg][i % kStages];
    bf16* dst = stage_s(wg, i);
    sm90::mbar_expect_tx(bar, 2 * kTileBytes + kStat * 4);
    load_tile<HD>(dst, &qmap, qax, bar, qt * kRows, h, b);
    load_tile<HD>(dst + kTile, &dmap, dax, bar, qt * kRows, h, b);
    sm90::bulk_load(stage_st(wg, i),
                    stats + ((static_cast<long long>(b) * Hq + h) * n_qt +
                             qt) * kStat,
                    kStat * 4, bar);
  };
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar_kv, 2 * kTileBytes);
    load_tile<HD>(k_s, &kmap, kax, &bar_kv, k0, g, b);
    load_tile<HD>(v_s, &vmap, vax, &bar_kv, k0, g, b);
  }
  if (wtid == 0 && n_mine > 0) load_item(0);

  float dk_acc[HD / 2], dv_acc[HD / 2];
  zero_regs(dk_acc);
  zero_regs(dv_acc);
  float s[32], dp[32];
  const int key_lo = k0 + warp * 16 + (lane >> 2);   // keys key_lo, + 8
  sm90::mbar_wait(&bar_kv, 0);

  for (int i = 0; i < n_mine; ++i) {
    if (wtid == 0 && i + 1 < n_mine) load_item(i + 1);
    sm90::mbar_wait(&bar_it[wg][i % kStages], (i / kStages) & 1);
    const bf16* qt = stage_s(wg, i);
    const bf16* dot = qt + kTile;
    const float* l2 = stage_st(wg, i);       // lse in log2 units, then D
    const int q0 = (qt0 + (wg + 2 * i) % per_head) * kRows;
    zero_regs(s);                            // overwritten: not live across
    zero_regs(dp);                           // the dK / dV products
    sm90::wgmma_fence();
    ss_product<HDT>(s, k_s, qt);             // S^T = K Q^T
    sm90::wgmma_commit();
    ss_product<HDT>(dp, v_s, dot);           // dP^T = V dO^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    fence_regs(s);
    // P^T: the column is the query, so lse and D come per column
    const bool masked = q0 + kRows > Sq || (causal && q0 < k0 + kRows);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 l = *reinterpret_cast<const float2*>(l2 + c);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int qpos = q0 + c + (x & 1);
        const int key = key_lo + 8 * (x >> 1);
        float& p = s[4 * j + x];
        p = fast_exp2(fmaf(p, scale_log2, -((x & 1) ? l.y : l.x)));
        if (masked && (qpos >= Sq || (causal && key > qpos))) p = 0.f;
      }
    }
    sm90::wgmma_wait<0>();
    fence_regs(dp);
    // dS^T = P^T (dP^T - D)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d =
          *reinterpret_cast<const float2*>(l2 + kRows + 8 * j +
                                           2 * (lane & 3));
#pragma unroll
      for (int x = 0; x < 4; ++x)
        dp[4 * j + x] = s[4 * j + x] * (dp[4 * j + x] - ((x & 1) ? d.y : d.x));
    }
    uint32_t pa[4][4], dsa[4][4];
    to_a(pa, s);
    to_a(dsa, dp);
    // dV += P^T dO, dK += dS^T Q
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    sm90::wgmma_fence();
    rs_product<HD>(dv_acc, pa, dot);
    rs_product<HD>(dk_acc, dsa, qt);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    // this warpgroup's stage is free again
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
  __syncthreads();                           // every tile has been read
  float* x = reinterpret_cast<float*>(ring);
  merge_store<HD, HDT>(dv_acc, x, wg, wtid,
                       dv + b * dvs_b + g * dvs_h + k0 * dvs_s, dvs_s,
                       Skv - k0, 1.f);
  __syncthreads();                           // x is read before reuse
  merge_store<HD, HDT>(dk_acc, x, wg, wtid,
                       dk + b * dks_b + g * dks_h + k0 * dks_s, dks_s,
                       Skv - k0, scale);
}

template <int HD, int HDT>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dO, const float* lse,
                        float* stats, void* dq, void* dk, void* dv, int B,
                        int Hq, int Hkv, int Sq, int Skv, const Strides& st,
                        int causal, float scale, cudaStream_t s) {
  constexpr int kTileBytes = kRows * HD * 2;
  // align + Q + dO + 2 warpgroups x kStages x (K, V)
  constexpr int kSmemQ = 1024 + (2 + 4 * kStages) * kTileBytes;
  // align + K + V + 2 warpgroups x kStages x (Q, dO, stats)
  constexpr int kSmemKV = 1024 + (2 + 4 * kStages) * kTileBytes +
                          2 * kStages * kStat * 4;
  static const cudaError_t a1 = cudaFuncSetAttribute(
      bwd_dq_wgmma<HD, HDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemQ);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      bwd_dkdv_wgmma<HD, HDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemKV);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  CUtensorMap qm, km, vm, dm;
  MapAxes qa, ka, va, da;
  if (!sm90::make_map(&qm, &qa, q, B, Hq, Sq, HDT, st.q) ||
      !sm90::make_map(&km, &ka, k, B, Hkv, Skv, HDT, st.k) ||
      !sm90::make_map(&vm, &va, v, B, Hkv, Skv, HDT, st.v) ||
      !sm90::make_map(&dm, &da, dO, B, Hq, Sq, HDT, st.dO))
    return cudaErrorInvalidValue;
  const int n_q = (Sq + kRows - 1) / kRows, n_k = (Skv + kRows - 1) / kRows;
  const long long rows = 1LL * B * Hq * n_q * kRows;
  const long long q_items = 1LL * n_q * Hq * B, k_items = 1LL * n_k * Hkv * B;
  if (rows / 32 > 0x7fffffff || q_items > 0x7fffffff)
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;
  bwd_stats_bf16<<<static_cast<unsigned>(rows / 32), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO), lse, stats,
      Hq, Sq, n_q, HDT, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_wgmma<HD, HDT><<<static_cast<unsigned>(q_items), 256, kSmemQ, s>>>(
      qm, km, vm, dm, qa, ka, va, da, stats, static_cast<bf16*>(dq),
      st.dq[0], st.dq[1], st.dq[2], Hq, Hkv, Sq, Skv, B, causal, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_wgmma<HD, HDT>
      <<<static_cast<unsigned>(k_items), 256, kSmemKV, s>>>(
          qm, km, vm, dm, qa, ka, va, da, stats, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), st.dk[0], st.dk[1], st.dk[2], st.dv[0],
          st.dv[1], st.dv[2], Hq, Hkv, Sq, Skv, B, causal, scale,
          scale_log2);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ f32

// D[b, h, i] = sum_d dO[b, h, i, d] * o[b, h, i, d], one warp per row.
__global__ void __launch_bounds__(256)
bwd_dot(const float* __restrict__ o, const float* __restrict__ dO,
        float* __restrict__ D, int Hq, int Sq, int hd, Strides st,
        long long rows) {
  const long long row = blockIdx.x * 8LL + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = row % Sq, h = (row / Sq) % Hq, b = row / (1LL * Sq * Hq);
  const float* orow = o + b * st.o[0] + h * st.o[1] + i * st.o[2];
  const float* drow = dO + b * st.dO[0] + h * st.dO[1] + i * st.dO[2];
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += orow[d] * drow[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(~0u, acc, off);
  if (lane == 0) D[row] = acc;
}

// CUDA cores, 8 threads to a row, each holding every 8th element of hd.
constexpr int kF32Rows = 16;   // rows (keys or queries) per block
constexpr int kF32Tile = 32;   // rows of the other side per shared tile

__device__ __forceinline__ float sum8(float x) {
  x += __shfl_xor_sync(~0u, x, 1);
  x += __shfl_xor_sync(~0u, x, 2);
  x += __shfl_xor_sync(~0u, x, 4);
  return x;
}

// Grid (ceil(Skv / 16), Hkv, B), 128 threads.
template <int HD>
__global__ void __launch_bounds__(128)
bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ Dv,
             float* __restrict__ dk, float* __restrict__ dv, int Hq, int Hkv,
             int Sq, int Skv, Strides st, int causal, float scale) {
  constexpr int E = HD / 8;
  __shared__ float q_s[kF32Tile][HD], do_s[kF32Tile][HD];
  __shared__ float l_s[kF32Tile], d_s[kF32Tile];
  const int g = blockIdx.y, b = blockIdx.z, rep = Hq / Hkv;
  const int tid = threadIdx.x, part = tid & 7;
  const int j = blockIdx.x * kF32Rows + (tid >> 3);
  const bool key_live = j < Skv;
  float kr[E], vr[E], dk_acc[E], dv_acc[E];
  const float* kp = k + b * st.k[0] + g * st.k[1] + j * st.k[2];
  const float* vp = v + b * st.v[0] + g * st.v[1] + j * st.v[2];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    kr[e] = key_live ? kp[part + 8 * e] : 0.f;
    vr[e] = key_live ? vp[part + 8 * e] : 0.f;
    dk_acc[e] = dv_acc[e] = 0.f;
  }
  const int k_first = blockIdx.x * kF32Rows;
  const int i0 = causal ? min(k_first, Sq) : 0;
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    for (int t0 = i0; t0 < Sq; t0 += kF32Tile) {
      __syncthreads();
      for (int c = tid; c < kF32Tile * HD; c += 128) {
        const int rr = c / HD, d = c % HD, i = t0 + rr;
        const bool ok = i < Sq;
        q_s[rr][d] = ok ? q[b * st.q[0] + h * st.q[1] + i * st.q[2] + d] : 0.f;
        do_s[rr][d] =
            ok ? dO[b * st.dO[0] + h * st.dO[1] + i * st.dO[2] + d] : 0.f;
      }
      for (int rr = tid; rr < kF32Tile; rr += 128) {
        const long long at = (static_cast<long long>(b) * Hq + h) * Sq + t0 + rr;
        const bool ok = t0 + rr < Sq;
        l_s[rr] = ok ? lse[at] : 0.f;
        d_s[rr] = ok ? Dv[at] : 0.f;
      }
      __syncthreads();
      for (int rr = 0; rr < kF32Tile; ++rr) {
        const int i = t0 + rr;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          s += kr[e] * q_s[rr][part + 8 * e];
          dp += vr[e] * do_s[rr][part + 8 * e];
        }
        s = sum8(s);
        dp = sum8(dp);
        const bool live = i < Sq && !(causal && j > i);
        const float p = live ? expf(s * scale - l_s[rr]) : 0.f;
        const float ds = p * (dp - d_s[rr]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dv_acc[e] += p * do_s[rr][part + 8 * e];
          dk_acc[e] += ds * q_s[rr][part + 8 * e];
        }
      }
    }
  }
  if (!key_live) return;
  float* dkp = dk + b * st.dk[0] + g * st.dk[1] + j * st.dk[2];
  float* dvp = dv + b * st.dv[0] + g * st.dv[1] + j * st.dv[2];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    dkp[part + 8 * e] = dk_acc[e] * scale;
    dvp[part + 8 * e] = dv_acc[e];
  }
}

// Grid (ceil(Sq / 16), Hq, B), 128 threads.
template <int HD>
__global__ void __launch_bounds__(128)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dO,
           const float* __restrict__ lse, const float* __restrict__ Dv,
           float* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv,
           Strides st, int causal, float scale) {
  constexpr int E = HD / 8;
  __shared__ float k_s[kF32Tile][HD], v_s[kF32Tile][HD];
  const int h = blockIdx.y, b = blockIdx.z, g = h / (Hq / Hkv);
  const int tid = threadIdx.x, part = tid & 7;
  const int i = blockIdx.x * kF32Rows + (tid >> 3);
  const bool row_live = i < Sq;
  float qr[E], dor[E], dq_acc[E];
  const float* qp = q + b * st.q[0] + h * st.q[1] + i * st.q[2];
  const float* dop = dO + b * st.dO[0] + h * st.dO[1] + i * st.dO[2];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qr[e] = row_live ? qp[part + 8 * e] : 0.f;
    dor[e] = row_live ? dop[part + 8 * e] : 0.f;
    dq_acc[e] = 0.f;
  }
  const long long at = (static_cast<long long>(b) * Hq + h) * Sq + i;
  const float l = row_live ? lse[at] : 0.f;
  const float Di = row_live ? Dv[at] : 0.f;
  const int q_last = min(Sq, (blockIdx.x + 1) * kF32Rows) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  for (int t0 = 0; t0 < k_end; t0 += kF32Tile) {
    __syncthreads();
    for (int c = tid; c < kF32Tile * HD; c += 128) {
      const int rr = c / HD, d = c % HD, jj = t0 + rr;
      const bool ok = jj < Skv;
      k_s[rr][d] = ok ? k[b * st.k[0] + g * st.k[1] + jj * st.k[2] + d] : 0.f;
      v_s[rr][d] = ok ? v[b * st.v[0] + g * st.v[1] + jj * st.v[2] + d] : 0.f;
    }
    __syncthreads();
    for (int rr = 0; rr < kF32Tile; ++rr) {
      const int jj = t0 + rr;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        s += qr[e] * k_s[rr][part + 8 * e];
        dp += dor[e] * v_s[rr][part + 8 * e];
      }
      s = sum8(s);
      dp = sum8(dp);
      const bool live = jj < Skv && !(causal && jj > i);
      const float p = live ? expf(s * scale - l) : 0.f;
      const float ds = p * (dp - Di);
#pragma unroll
      for (int e = 0; e < E; ++e) dq_acc[e] += ds * k_s[rr][part + 8 * e];
    }
  }
  if (!row_live) return;
  float* dqp = dq + b * st.dq[0] + h * st.dq[1] + i * st.dq[2];
#pragma unroll
  for (int e = 0; e < E; ++e) dqp[part + 8 * e] = dq_acc[e] * scale;
}

template <int HD>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const float* dO, const float* lse, const float* D,
                       float* dq, float* dk, float* dv, int B, int Hq,
                       int Hkv, int Sq, int Skv, const Strides& st,
                       int causal, float scale, cudaStream_t s) {
  bwd_dkdv_f32<HD><<<dim3((Skv + kF32Rows - 1) / kF32Rows, Hkv, B), 128, 0,
                     s>>>(q, k, v, dO, lse, D, dk, dv, Hq, Hkv, Sq, Skv, st,
                          causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_f32<HD><<<dim3((Sq + kF32Rows - 1) / kF32Rows, Hq, B), 128, 0,
                   s>>>(q, k, v, dO, lse, D, dq, Hq, Hkv, Sq, Skv, st,
                        causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: 24 element strides, (batch, head,
// seq) of q, k, v, o, dO, dq, dk, dv in that order (hd contiguous).  lse:
// the forward's float32 (B, Hq, Sq) log-sum-exp.  D: float32 scratch of
// 2 * B * Hq * ceil(Sq / 64) * 64 floats (the bf16 route's stats blocks;
// float32 uses its first B * Hq * Sq as D).  Launches the stats (D) pass,
// then dQ and dK / dV, on `stream`; returns cudaGetLastError() after the
// last (cudaErrorInvalidValue for a shape the kernels do not take, or a
// bf16 operand TMA cannot address).
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dO, const float* lse, float* D, void* dq, void* dk, void* dv,
    int B, int Hq, int Hkv, int Sq, int Skv, int hd,
    const long long* strides, int causal, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 ||
      B > 65535 || Hq > 65535 || (dtype != 0 && dtype != 1) ||
      (hd != 64 && hd != 80 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.dO, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (hd == 64)
      err = launch_bf16<64, 64>(q, k, v, o, dO, lse, D, dq, dk, dv, B, Hq,
                                Hkv, Sq, Skv, st, causal, scale, s);
    else if (hd == 80)
      err = launch_bf16<128, 80>(q, k, v, o, dO, lse, D, dq, dk, dv, B, Hq,
                                 Hkv, Sq, Skv, st, causal, scale, s);
    else
      err = launch_bf16<128, 128>(q, k, v, o, dO, lse, D, dq, dk, dv, B,
                                  Hq, Hkv, Sq, Skv, st, causal, scale, s);
    return static_cast<int>(err);
  }
  const long long rows = 1LL * B * Hq * Sq;
  bwd_dot<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dO), D, Hq,
      Sq, hd, st, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fdo = static_cast<const float*>(dO);
  float *gq = static_cast<float*>(dq), *gk = static_cast<float*>(dk),
        *gv = static_cast<float*>(dv);
  if (hd == 64)
    err = launch_f32<64>(fq, fk, fv, fdo, lse, D, gq, gk, gv, B, Hq, Hkv, Sq,
                         Skv, st, causal, scale, s);
  else if (hd == 80)
    err = launch_f32<80>(fq, fk, fv, fdo, lse, D, gq, gk, gv, B, Hq, Hkv, Sq,
                         Skv, st, causal, scale, s);
  else
    err = launch_f32<128>(fq, fk, fv, fdo, lse, D, gq, gk, gv, B, Hq, Hkv,
                          Sq, Skv, st, causal, scale, s);
  return static_cast<int>(err);
}
