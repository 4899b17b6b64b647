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
// So the bf16 route is built to run on the tensor cores at Hopper's rate:
//   * one block per (64-row query tile, query head, batch); query head h
//     reads kv head h / rep directly (no K/V head is replicated).  A
//     causal prompt of 1000 tokens gives only 224 such tiles for 132 SMs,
//     so each block holds two warpgroups (256 threads) that share the Q
//     tile and take alternate key tiles, each with its own online softmax,
//     merging (m, l, O) through shared memory at the end: twice the warps
//     per SM, half the serial chain;
//   * causal work is uneven (a query tile costs its index + 1 key tiles),
//     so blocks take the heaviest tiles of all heads first, and when every
//     block is resident at once the second block dispatched to an SM is a
//     light one: the busiest SM's share drops toward the mean;
//   * TMA loads the Q tile once and, per warpgroup, 64-row K/V tiles into
//     a 2-stage ring with mbarriers, one elected thread issuing them one
//     tile ahead of the math (a third stage measured no faster).  The
//     tensor maps address the operands through their (batch, head, seq)
//     strides with hd contiguous, so the model's (B, S, H, hd) activations
//     pass as transposed views and nothing is copied in or out; ragged
//     tiles are zero-filled by TMA;
//   * 128-byte swizzle (a 64-wide bf16 row is exactly 128 bytes; hd 128 is
//     two such boxes), read by wgmma through shared-memory descriptors;
//   * S = Q K^T as wgmma m64n64k16 with Q and K from shared memory
//     (K-major); the online softmax runs on the f32 accumulator fragment;
//     P is rounded to bf16 in registers and is wgmma's register A operand
//     for O += P V, with V read from shared memory as the MN-major B
//     operand (the descriptor's transpose); the softmax works in log2
//     units, one FFMA and one ex2 per score (the softmax, not the tensor
//     cores, is what the per-SM issue rate spends most on);
//   * only the causal diagonal tile and the ragged last tiles are masked;
//     causal tiles above the diagonal are never loaded;
//   * shared memory is Q plus two rings of K/V: 73 KB at hd 64 (two
//     blocks per SM, as the registers allow), 145 KB at hd 128, above the
//     default 48 KB: the limit is raised once per instantiation;
//   * hd 80 (hubert-xlarge's 1280 / 16) is not a whole number of 64-wide
//     boxes.  It runs the hd-128 instantiation with the tensor maps' inner
//     extent set to the true 80: TMA zero-fills the second box's columns
//     80-127, which leaves Q K^T unchanged; Q K^T stops after the fifth
//     k16 step, O += P V still computes 128 columns (48 of them zero), and
//     only 80 are written.  No copy and no padding pass.
// float32 keeps a CUDA-core kernel (below), routed by type: there are no
// f32 tensor cores without TF32, and the f32 check does not allow TF32.
// The wrapper refuses bf16 operands whose base or strides TMA cannot take
// (not 16-byte multiples, or hd not contiguous).
//
// Semantics follow the TPU kernel: scores dot(q, k) * scale in f32, masked
// to -1e30 above the diagonal (both positions start at 0); p is rounded to
// the input type before the PV product; output acc / max(l, 1e-30) in the
// input type.  Any Sq and Skv.
//
// For training, the kernel also writes each row's log-sum-exp when the
// caller passes an lse buffer (float32, (B, Hq, Sq) contiguous; null
// writes none, as serving passes): lse = ln(sum_j exp(scale * q . k_j)) in
// natural-log units, the unit flash_attention_bwd.cu and the plain
// attention_ref_lse use.  The bf16 route keeps m and l in log2 units per
// warpgroup and stores (M + log2 L) * ln 2 from the merged M and L of the
// two warpgroups; rows past Sq write nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
using bf16 = __nv_bfloat16;

// element strides of (batch, head, seq) for q, k, v, out; hd is contiguous
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// ------------------------------------------------------------------ bf16

constexpr int kRows = 64;          // query rows per block, keys per tile
constexpr int kBox = sm90::kBoxElems;  // elements of one 64 x 64 TMA box
constexpr int kStages = 2;         // K/V ring depth per warpgroup

using sm90::fast_exp2;
using sm90::load_tile;
using sm90::MapAxes;

// HD is the staged width (64 or 128), HDT <= HD the true head width, a
// multiple of 16 (the tensor maps' inner extent; columns past it arrive
// zero and are not written).
// Grid (ceil(Sq / 64) * Hq * B), 256 threads: two warpgroups share the Q
// tile and take alternate key tiles (even, odd), each with its own ring
// and online softmax; they merge (m, l, O) through shared memory at the
// end.  Block k takes work item k, heaviest query tiles first; with
// pair_from > 0 (causal, every block resident at once) blocks pair_from..
// take the remaining items lightest first, so that the second block on an
// SM is light where the first is heavy.
template <int HD, int HDT>
__global__ void __launch_bounds__(256)
flash_bf16_wgmma(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, MapAxes qax,
                 MapAxes kax, MapAxes vax, bf16* __restrict__ out,
                 long long os_b, long long os_h, long long os_s, int Hq,
                 int Hkv, int Sq, int Skv, int causal, float scale_log2,
                 int B, int pair_from, float* __restrict__ lse) {
  constexpr int NO = HD / 2;                 // O accumulators per thread
  constexpr int kTile = kRows * HD;          // elements of a 64-row tile
  constexpr int kTileBytes = kTile * 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_kv[2][kStages];
  // 128-byte swizzle atoms repeat every 1024 bytes: align the tiles to it
  bf16* q_s = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* kv_s = q_s + kTile;                  // [wg][stage][K, V][tile]
  auto stage_s = [&](int w, int i) {
    return kv_s + (w * kStages + i % kStages) * 2 * kTile;
  };

  int item = blockIdx.x;
  if (pair_from > 0 && item >= pair_from)
    item = gridDim.x - 1 - (item - pair_from);
  const int n_q = (Sq + kRows - 1) / kRows;
  const int qi = n_q - 1 - item / (Hq * B);
  const int h = item % Hq, b = item / Hq % B;
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
  // this warpgroup's i-th key tile into its stage i % kStages
  auto load_kv = [&](int i) {
    uint64_t* bar = &bar_kv[wg][i % kStages];
    bf16* dst = stage_s(wg, i);
    const int t = wg + 2 * i;
    sm90::mbar_expect_tx(bar, 2 * kTileBytes);
    load_tile<HD>(dst, &kmap, kax, bar, t * kRows, g, b);
    load_tile<HD>(dst + kTile, &vmap, vax, bar, t * kRows, g, b);
  };
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar_q, kTileBytes);
    load_tile<HD>(q_s, &qmap, qax, &bar_q, q0, h, b);
  }
  if (wtid == 0)
    for (int i = 0; i < kStages - 1 && i < n_mine; ++i) load_kv(i);

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  // m is kept in log2 units: scores times scale * log2(e)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float s[32];                               // overwritten by each S = Q K^T
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = 0.f;
  const int r_lo = warp * 16 + (lane >> 2);  // fragment rows r_lo, r_lo + 8
  const int qpos[2] = {q0 + r_lo, q0 + r_lo + 8};
  sm90::mbar_wait(&bar_q, 0);

  for (int i = 0; i < n_mine; ++i) {
    // the stage of tile i + kStages - 1 was freed at the end of tile i - 1
    if (wtid == 0 && i + kStages - 1 < n_mine) load_kv(i + kStages - 1);
    sm90::mbar_wait(&bar_kv[wg][i % kStages], (i / kStages) & 1);
    const bf16* kt = stage_s(wg, i);
    const bf16* vt = kt + kTile;

    // S = Q K^T (64 x 64), 16 columns of hd per step
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDT / 16; ++kk) {
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
    const bool masked = k0 + kRows > Skv || (causal && k0 + kRows - 1 > q0);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * r + e];
          if (masked) {
            const int kpos = k0 + 8 * j + 2 * (lane & 3) + e;
            if (kpos >= Skv || (causal && kpos > qpos[r])) x = kNegInf;
          }
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
          const float p =
              fast_exp2(fmaf(s[4 * j + 2 * r + e], scale_log2, -m_new));
          s[4 * j + 2 * r + e] = p;
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
  float c0[2], c1[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = x_ml[r * 128 + wtid], l1 = x_ml[(2 + r) * 128 + wtid];
    const float M = fmaxf(m[r], m1);
    c0[r] = fast_exp2(m[r] - M);
    c1[r] = fast_exp2(m1 - M);
    const float Lsum = c0[r] * l[r] + c1[r] * l1;
    inv[r] = 1.f / fmaxf(Lsum, 1e-30f);
    // the four threads of a row hold the same M and L: one writes
    if (lse != nullptr && (lane & 3) == 0 && qpos[r] < Sq)
      lse[(static_cast<long long>(b) * Hq + h) * Sq + qpos[r]] =
          (M + log2f(Lsum)) * 0.6931471805599453f;
  }
  bf16* ob = out + b * os_b + h * os_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= Sq) continue;
    bf16* orow = ob + qpos[r] * os_s + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HDT / 8; ++j) {
      const int a = 4 * j + 2 * r;
      const float y0 = (c0[r] * o[a] + c1[r] * x_o[a * 128 + wtid]) * inv[r];
      const float y1 =
          (c0[r] * o[a + 1] + c1[r] * x_o[(a + 1) * 128 + wtid]) * inv[r];
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
}

// ------------------------------------------------------------------ f32
// Grid (ceil(Sq / BQ), Hq, B), 4 * BQ threads: four threads share a query
// row, each owning every fourth element of hd; K/V tiles in shared memory.
template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(4 * BQ)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int Hq,
          int Hkv, int Sq, int Skv, Strides st, int causal, float scale,
          float* __restrict__ lse) {
  constexpr int kThreads = 4 * BQ;
  constexpr int DPT = HD / 4;                     // hd elements per thread
  __shared__ float k_s[BK][HD];
  __shared__ float v_s[BK][HD];

  const int qi = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (Hq / Hkv);
  const int tid = threadIdx.x, row = tid >> 2, quad = tid & 3;
  const int q_start = qi * BQ, qpos = q_start + row;

  const float* qp = q + b * st.q[0] + h * st.q[1];
  const float* kp = k + b * st.k[0] + g * st.k[1];
  const float* vp = v + b * st.v[0] + g * st.v[1];

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = qpos < Sq ? qp[qpos * st.q[2] + i * 4 + quad] : 0.f;
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
      k_s[j][d] = live ? kp[kr * st.k[2] + d] : 0.f;
      v_s[j][d] = live ? vp[kr * st.v[2] + d] : 0.f;
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
      s[j] = p;
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
    float* op = out + b * st.o[0] + h * st.o[1] + qpos * st.o[2];
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[i * 4 + quad] = acc[i] * inv;
    if (lse != nullptr && quad == 0)
      lse[(static_cast<long long>(b) * Hq + h) * Sq + qpos] = m + logf(l);
  }
}

template <int HD, int BQ, int BK>
void launch_f32(const void* q, const void* k, const void* v, void* out,
                int B, int Hq, int Hkv, int Sq, int Skv, const Strides& st,
                int causal, float scale, float* lse, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_f32<HD, BQ, BK><<<grid, 4 * BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Hq, Hkv, Sq,
      Skv, st, causal, scale, lse);
}

// ---------------------------------------------------------------- launch

template <int HD, int HDT>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int Hq, int Hkv, int Sq, int Skv,
                        const Strides& st, int causal, float scale,
                        float* lse, cudaStream_t stream) {
  // align + Q + 2 warpgroups x kStages x (K, V)
  constexpr int kSmem = 1024 + (1 + 4 * kStages) * kRows * HD * 2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bf16_wgmma<HD, HDT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap qm, km, vm;
  MapAxes qa, ka, va;
  if (!sm90::make_map(&qm, &qa, q, B, Hq, Sq, HDT, st.q) ||
      !sm90::make_map(&km, &ka, k, B, Hkv, Skv, HDT, st.k) ||
      !sm90::make_map(&vm, &va, v, B, Hkv, Skv, HDT, st.v))
    return cudaErrorInvalidValue;
  // all blocks resident at once (a causal prompt up to ~2k tokens at
  // qwen2-0.5b's heads): pair heavy and light query tiles on an SM
  static int sms = 0, per_sm = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flash_bf16_wgmma<HD, HDT>, 256, kSmem);
  }
  const long long items = 1LL * ((Sq + kRows - 1) / kRows) * Hq * B;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const int pair_from = causal && items <= 1LL * sms * per_sm ? sms : 0;
  flash_bf16_wgmma<HD, HDT>
      <<<static_cast<unsigned>(items), 256, kSmem, stream>>>(
      qm, km, vm, qa, ka, va, static_cast<bf16*>(out), st.o[0], st.o[1],
      st.o[2], Hq, Hkv, Sq, Skv, causal, scale * 1.4426950408889634f, B,
      pair_from, lse);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; strides: 12 element strides, (batch, head,
// seq) of q, k, v, out in that order; lse: null, or float32 (B, Hq, Sq)
// contiguous for the rows' log-sum-exp.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a shape the kernel does not take,
// or a bf16 operand TMA cannot address).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int Hq, int Hkv, int Sq, int Skv,
                                      int hd, const long long* strides,
                                      int causal, float scale, void* stream) {
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
  cudaError_t err = cudaSuccess;
  if (dtype == 0 && hd == 64)
    launch_f32<64, 64, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, st, causal,
                           scale, lse, s);
  else if (dtype == 0 && hd == 80)
    launch_f32<80, 64, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, st, causal,
                           scale, lse, s);
  else if (dtype == 0 && hd == 128)
    launch_f32<128, 64, 32>(q, k, v, out, B, Hq, Hkv, Sq, Skv, st, causal,
                            scale, lse, s);
  else if (dtype == 1 && hd == 64)
    err = launch_bf16<64, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, st, causal,
                              scale, lse, s);
  else if (dtype == 1 && hd == 80)
    err = launch_bf16<128, 80>(q, k, v, out, B, Hq, Hkv, Sq, Skv, st,
                               causal, scale, lse, s);
  else if (dtype == 1 && hd == 128)
    err = launch_bf16<128, 128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, st,
                                causal, scale, lse, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
