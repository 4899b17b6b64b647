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
// in three launches:
//   * bwd_dot: D, one warp per row;
//   * dK / dV: one block per (64-key tile, kv head, batch).  It loops over
//     the group's rep query heads and over the query tiles that see its
//     keys (causal: from the tile holding query k0 on), so the GQA sum over
//     the group stays inside the block: no float atomics, and the
//     gradient is deterministic;
//   * dQ: one block per (64-query tile, query head, batch), looping over
//     the key tiles it sees.
// What bounds it on the H100: operations.  Five products of the forward's
// shape (S^T and dP^T, dV, dK in the first kernel, S, dP and dQ in the
// second: seven products done where five are needed, the price of keeping
// atomics out) against one read of q, k, v, o, dO and one write of dq, dk,
// dv: at qwen2-0.5b's training shape (B 8, S 1024, 14/2 heads, hd 64,
// causal) 37.6 GFLOP against 68 MB.
//
// This first version is simple and right rather than fast: bf16 operands
// go through mma.sync m16n8k16 (sm90.cuh) from padded shared-memory tiles
// (row stride hd + 8 elements: ldmatrix reads no bank twice), filled by
// cp.async in a two-stage ring, f32 accumulation, P and dS rounded to bf16
// as the products' A operands straight from the accumulator fragments, and
// the gradients written in the input type.  wgmma and TMA, as the forward
// has them, are later work.  float32 keeps CUDA-core kernels (no f32
// tensor cores without TF32).
//
// Layout: every operand is (batch, head, seq, hd) addressed through its
// (batch, head, seq) element strides with hd contiguous; bf16 rows must be
// 16-byte aligned (the wrapper checks).  lse and D are float32 (B, Hq, Sq)
// contiguous.  Query head h reads kv head h / rep; causal positions start
// at 0 on both sides; any Sq and Skv; hd 64, 80 and 128.

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ------------------------------------------------------------------ D pass
// D[b, h, i] = sum_d dO[b, h, i, d] * o[b, h, i, d], one warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_dot(const T* __restrict__ o, const T* __restrict__ dO,
        float* __restrict__ D, int Hq, int Sq, int hd, Strides st,
        long long rows) {
  const long long row = blockIdx.x * 8LL + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = row % Sq, h = (row / Sq) % Hq, b = row / (1LL * Sq * Hq);
  const T* orow = o + b * st.o[0] + h * st.o[1] + i * st.o[2];
  const T* drow = dO + b * st.dO[0] + h * st.dO[1] + i * st.dO[2];
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += to_f(orow[d]) * to_f(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(~0u, acc, off);
  if (lane == 0) D[row] = acc;
}

// ------------------------------------------------------------------ bf16

constexpr int kKeys = 64;    // keys per dK/dV block, per dQ key tile
constexpr int kQRows = 64;   // queries per dQ block

// rows of a padded bf16 tile: hd + 8 elements (16 bytes) per row, so the
// 8 rows one ldmatrix reads start in 8 distinct groups of 4 banks
template <int HD>
struct Pad {
  static constexpr int kRow = HD + 8;
};

// `n` rows of hd columns from global (row r at base + r * rs) into a padded
// tile, 16 bytes per cp.async; rows >= live are zero-filled.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          long long rs, int n, int live,
                                          int tid, int nthreads) {
  constexpr int kChunks = HD / 8;           // 16-byte chunks of a row
  for (int c = tid; c < n * kChunks; c += nthreads) {
    const int r = c / kChunks, x = (c % kChunks) * 8;
    const bool ok = r < live;
    sm90::cp_async16(dst + r * Pad<HD>::kRow + x,
                     base + (ok ? r * rs : 0) + x, ok);
  }
}

// A operand (16 x 16, row-major in a padded tile) at (row r0, column c0)
template <int HD>
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* t, int r0,
                                    int c0, int lane) {
  sm90::ldmatrix_x4(a[0], a[1], a[2], a[3],
                    t + (r0 + (lane & 15)) * Pad<HD>::kRow + c0 +
                        (lane >> 4) * 8);
}
// B operands of two n8 tiles (n0, n0 + 8) over k16 at k0, from a tile
// stored [n][k] (n rows, k contiguous): b[0], b[1] tile n0; b[2], b[3]
// tile n0 + 8.
template <int HD>
__device__ __forceinline__ void ldb_nk(uint32_t (&b)[4], const bf16* t,
                                       int n0, int k0, int lane) {
  sm90::ldmatrix_x4(b[0], b[1], b[2], b[3],
                    t + (n0 + (lane >> 4) * 8 + (lane & 7)) * Pad<HD>::kRow +
                        k0 + ((lane >> 3) & 1) * 8);
}
// the same from a tile stored [k][n] (k rows, n contiguous), transposed
// by ldmatrix
template <int HD>
__device__ __forceinline__ void ldb_kn(uint32_t (&b)[4], const bf16* t,
                                       int k0, int n0, int lane) {
  sm90::ldmatrix_x4_trans(b[0], b[1], b[2], b[3],
                          t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  Pad<HD>::kRow +
                              n0 + (lane >> 4) * 8);
}

// acc (16 x N, NT = N / 8 tiles) += A-tile (16 rows of `a_t` from r0) *
// B^T, B stored [n][k] with N rows: the S = Q K^T shape, k over hd
template <int HD, int NT>
__device__ __forceinline__ void mma_rows_nk(float (&acc)[NT][4],
                                            const bf16* a_t, int r0,
                                            const bf16* b_t, int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    lda<HD>(a, a_t, r0, kk * 16, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldb_nk<HD>(b, b_t, np * 16, kk * 16, lane);
      sm90::mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      sm90::mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x HD) += P (16 x K, accumulator fragments, KT = K / 8 tiles,
// rounded to bf16) * B, B stored [k][n] (K rows of hd): the O = P V shape
template <int HD, int KT>
__device__ __forceinline__ void mma_frag_kn(float (&acc)[HD / 8][4],
                                            const float (&p)[KT][4],
                                            const bf16* b_t, int lane) {
#pragma unroll
  for (int kq = 0; kq < KT / 2; ++kq) {
    const uint32_t a[4] = {sm90::pack_bf16(p[2 * kq][0], p[2 * kq][1]),
                           sm90::pack_bf16(p[2 * kq][2], p[2 * kq][3]),
                           sm90::pack_bf16(p[2 * kq + 1][0], p[2 * kq + 1][1]),
                           sm90::pack_bf16(p[2 * kq + 1][2],
                                           p[2 * kq + 1][3])};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      ldb_kn<HD>(b, b_t, kq * 16, np * 16, lane);
      sm90::mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      sm90::mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// rows r_lo, r_lo + 8 of a 16 x HD accumulator, times `mul`, into bf16 rows
// at base + row * rs (rows >= live are not written)
template <int HD>
__device__ __forceinline__ void store_rows(bf16* base, long long rs,
                                           const float (&acc)[HD / 8][4],
                                           int r_lo, int live, float mul,
                                           int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    if (r >= live) continue;
    bf16* row = base + r * rs + 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * nt) =
          __floats2bfloat162_rn(acc[nt][2 * half] * mul,
                                acc[nt][2 * half + 1] * mul);
  }
}

// dK / dV.  Grid (ceil(Skv / 64), Hkv, B), 128 threads: warp w owns keys
// k0 + 16w .. + 15 and computes S^T (its keys x BQ queries) so that P^T
// and dS^T are the A operands of dV += P^T dO and dK += dS^T Q without a
// trip through shared memory.  Items (query head of the group, query tile)
// stream through a two-stage cp.async ring of Q / dO tiles.
template <int HD, int BQ>
__global__ void __launch_bounds__(128)
bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ Dv,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq, int Hkv,
              int Sq, int Skv, Strides st, int causal, float scale) {
  constexpr int R = Pad<HD>::kRow;
  constexpr int QT = BQ / 8;                 // n8 tiles of a query tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);        // [64][R]
  bf16* v_s = k_s + kKeys * R;                          // [64][R]
  bf16* q_s = v_s + kKeys * R;                          // [2][BQ][R]
  bf16* do_s = q_s + 2 * BQ * R;                        // [2][BQ][R]
  float* l_s = reinterpret_cast<float*>(do_s + 2 * BQ * R);   // [2][BQ]
  float* d_s = l_s + 2 * BQ;                                  // [2][BQ]

  const int k0 = blockIdx.x * kKeys, g = blockIdx.y, b = blockIdx.z;
  const int rep = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt0 = causal ? min(k0 / BQ, n_qt) : 0;
  const int per_head = n_qt - qt0;
  const int n_items = rep * per_head;
  const float scale_log2 = scale * kLog2e;

  load_rows<HD>(k_s, k + b * st.k[0] + g * st.k[1] + k0 * st.k[2], st.k[2],
                kKeys, Skv - k0, tid, 128);
  load_rows<HD>(v_s, v + b * st.v[0] + g * st.v[1] + k0 * st.v[2], st.v[2],
                kKeys, Skv - k0, tid, 128);
  // item `it` into stage `sg`: Q and dO tiles by cp.async, lse (in log2
  // units) and D by plain stores, seen after the next __syncthreads
  auto issue = [&](int it, int sg) {
    const int h = g * rep + it / per_head;
    const int q0 = (qt0 + it % per_head) * BQ;
    load_rows<HD>(q_s + sg * BQ * R,
                  q + b * st.q[0] + h * st.q[1] + q0 * st.q[2], st.q[2], BQ,
                  Sq - q0, tid, 128);
    load_rows<HD>(do_s + sg * BQ * R,
                  dO + b * st.dO[0] + h * st.dO[1] + q0 * st.dO[2], st.dO[2],
                  BQ, Sq - q0, tid, 128);
    for (int r = tid; r < BQ; r += 128) {
      const long long at = (static_cast<long long>(b) * Hq + h) * Sq + q0 + r;
      const bool ok = q0 + r < Sq;
      l_s[sg * BQ + r] = ok ? lse[at] * kLog2e : 0.f;
      d_s[sg * BQ + r] = ok ? Dv[at] : 0.f;
    }
  };
  if (n_items > 0) issue(0, 0);
  sm90::cp_async_commit();

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  const int key_lo = k0 + warp * 16 + (lane >> 2);     // keys key_lo, +8

  for (int it = 0; it < n_items; ++it) {
    const int sg = it & 1;
    if (it + 1 < n_items) issue(it + 1, sg ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = q_s + sg * BQ * R;
    const bf16* dot = do_s + sg * BQ * R;
    const float* lt = l_s + sg * BQ;
    const float* dt = d_s + sg * BQ;
    const int q0 = (qt0 + it % per_head) * BQ;

    // S^T = K Q^T -> P^T
    float p[QT][4];
#pragma unroll
    for (int nt = 0; nt < QT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = 0.f;
    mma_rows_nk<HD, QT>(p, k_s, warp * 16, qt, lane);
#pragma unroll
    for (int nt = 0; nt < QT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * nt + 2 * (lane & 3) + (e & 1);
        const int i = q0 + ql, key = key_lo + 8 * (e >> 1);
        const bool live = i < Sq && !(causal && key > i);
        p[nt][e] = live ? sm90::fast_exp2(p[nt][e] * scale_log2 - lt[ql])
                        : 0.f;
      }
    // dV += P^T dO
    mma_frag_kn<HD, QT>(dv_acc, p, dot, lane);
    // dP^T = V dO^T -> dS^T = P^T (dP^T - D)
    float ds[QT][4];
#pragma unroll
    for (int nt = 0; nt < QT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nt][e] = 0.f;
    mma_rows_nk<HD, QT>(ds, v_s, warp * 16, dot, lane);
#pragma unroll
    for (int nt = 0; nt < QT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nt][e] = p[nt][e] * (ds[nt][e] - dt[8 * nt + 2 * (lane & 3) +
                                                (e & 1)]);
    // dK += dS^T Q
    mma_frag_kn<HD, QT>(dk_acc, ds, qt, lane);
    __syncthreads();                  // this stage may be refilled
  }
  sm90::cp_async_wait<0>();           // no copy outlives the block
  store_rows<HD>(dk + b * st.dk[0] + g * st.dk[1] + k0 * st.dk[2], st.dk[2],
                 dk_acc, warp * 16 + (lane >> 2), Skv - k0, scale, lane);
  store_rows<HD>(dv + b * st.dv[0] + g * st.dv[1] + k0 * st.dv[2], st.dv[2],
                 dv_acc, warp * 16 + (lane >> 2), Skv - k0, 1.f, lane);
}

// dQ.  Grid (ceil(Sq / 64), Hq, B), 128 threads: warp w owns queries
// q0 + 16w .. + 15; K / V tiles stream through a two-stage cp.async ring.
template <int HD>
__global__ void __launch_bounds__(128)
bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ Dv,
            bf16* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv,
            Strides st, int causal, float scale) {
  constexpr int R = Pad<HD>::kRow;
  constexpr int KT = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);        // [64][R]
  bf16* do_s = q_s + kQRows * R;                        // [64][R]
  bf16* k_s = do_s + kQRows * R;                        // [2][64][R]
  bf16* v_s = k_s + 2 * kKeys * R;                      // [2][64][R]
  float* l_s = reinterpret_cast<float*>(v_s + 2 * kKeys * R);  // [64]
  float* d_s = l_s + kQRows;                                   // [64]

  const int q0 = blockIdx.x * kQRows, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k_end = causal ? min(Skv, q0 + kQRows) : Skv;
  const int n_kt = (k_end + kKeys - 1) / kKeys;
  const float scale_log2 = scale * kLog2e;

  load_rows<HD>(q_s, q + b * st.q[0] + h * st.q[1] + q0 * st.q[2], st.q[2],
                kQRows, Sq - q0, tid, 128);
  load_rows<HD>(do_s, dO + b * st.dO[0] + h * st.dO[1] + q0 * st.dO[2],
                st.dO[2], kQRows, Sq - q0, tid, 128);
  for (int r = tid; r < kQRows; r += 128) {
    const long long at = (static_cast<long long>(b) * Hq + h) * Sq + q0 + r;
    const bool ok = q0 + r < Sq;
    l_s[r] = ok ? lse[at] * kLog2e : 0.f;
    d_s[r] = ok ? Dv[at] : 0.f;
  }
  auto issue = [&](int t, int sg) {
    const int kb = t * kKeys;
    load_rows<HD>(k_s + sg * kKeys * R,
                  k + b * st.k[0] + g * st.k[1] + kb * st.k[2], st.k[2],
                  kKeys, Skv - kb, tid, 128);
    load_rows<HD>(v_s + sg * kKeys * R,
                  v + b * st.v[0] + g * st.v[1] + kb * st.v[2], st.v[2],
                  kKeys, Skv - kb, tid, 128);
  };
  issue(0, 0);
  sm90::cp_async_commit();

  float dq_acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[i][e] = 0.f;
  const int r_lo = warp * 16 + (lane >> 2);          // rows r_lo, r_lo + 8

  for (int t = 0; t < n_kt; ++t) {
    const int sg = t & 1;
    if (t + 1 < n_kt) issue(t + 1, sg ^ 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = k_s + sg * kKeys * R;
    const bf16* vt = v_s + sg * kKeys * R;
    const int kb = t * kKeys;

    // S = Q K^T -> P
    float p[KT][4];
#pragma unroll
    for (int nt = 0; nt < KT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = 0.f;
    mma_rows_nk<HD, KT>(p, q_s, warp * 16, kt, lane);
#pragma unroll
    for (int nt = 0; nt < KT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = r_lo + 8 * (e >> 1);
        const int key = kb + 8 * nt + 2 * (lane & 3) + (e & 1);
        const bool live = key < Skv && !(causal && key > q0 + rl);
        p[nt][e] = live ? sm90::fast_exp2(p[nt][e] * scale_log2 - l_s[rl])
                        : 0.f;
      }
    // dP = dO V^T -> dS = P (dP - D)
    float ds[KT][4];
#pragma unroll
    for (int nt = 0; nt < KT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nt][e] = 0.f;
    mma_rows_nk<HD, KT>(ds, do_s, warp * 16, vt, lane);
#pragma unroll
    for (int nt = 0; nt < KT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nt][e] = p[nt][e] * (ds[nt][e] - d_s[r_lo + 8 * (e >> 1)]);
    // dQ += dS K
    mma_frag_kn<HD, KT>(dq_acc, ds, kt, lane);
    __syncthreads();                  // this stage may be refilled
  }
  store_rows<HD>(dq + b * st.dq[0] + h * st.dq[1] + q0 * st.dq[2], st.dq[2],
                 dq_acc, r_lo, Sq - q0, scale, lane);
}

template <int HD, int BQ>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                        const bf16* dO, const float* lse, const float* D,
                        bf16* dq, bf16* dk, bf16* dv, int B, int Hq, int Hkv,
                        int Sq, int Skv, const Strides& st, int causal,
                        float scale, cudaStream_t s) {
  constexpr int R = Pad<HD>::kRow;
  constexpr int kSmemKV = (2 * kKeys + 4 * BQ) * R * 2 + 4 * BQ * 4;
  constexpr int kSmemQ = (2 * kQRows + 4 * kKeys) * R * 2 + 2 * kQRows * 4;
  static const cudaError_t a1 = cudaFuncSetAttribute(
      bwd_dkdv_bf16<HD, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemKV);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      bwd_dq_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemQ);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  bwd_dkdv_bf16<HD, BQ>
      <<<dim3((Skv + kKeys - 1) / kKeys, Hkv, B), 128, kSmemKV, s>>>(
          q, k, v, dO, lse, D, dk, dv, Hq, Hkv, Sq, Skv, st, causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_bf16<HD><<<dim3((Sq + kQRows - 1) / kQRows, Hq, B), 128, kSmemQ,
                    s>>>(q, k, v, dO, lse, D, dq, Hq, Hkv, Sq, Skv, st,
                         causal, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ f32
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
// the forward's float32 (B, Hq, Sq) log-sum-exp; D: float32 (B, Hq, Sq)
// scratch.  Launches the D pass, dK / dV and dQ on `stream`; returns
// cudaGetLastError() after the last (cudaErrorInvalidValue for a shape the
// kernels do not take).
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
  const long long rows = 1LL * B * Hq * Sq;
  if (dtype == 0)
    bwd_dot<float><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dO), D, Hq,
        Sq, hd, st, rows);
  else
    bwd_dot<bf16><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dO), D, Hq,
        Sq, hd, st, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0) {
    const float *fq = static_cast<const float*>(q),
                *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v),
                *fdo = static_cast<const float*>(dO);
    float *gq = static_cast<float*>(dq), *gk = static_cast<float*>(dk),
          *gv = static_cast<float*>(dv);
    if (hd == 64)
      err = launch_f32<64>(fq, fk, fv, fdo, lse, D, gq, gk, gv, B, Hq, Hkv,
                           Sq, Skv, st, causal, scale, s);
    else if (hd == 80)
      err = launch_f32<80>(fq, fk, fv, fdo, lse, D, gq, gk, gv, B, Hq, Hkv,
                           Sq, Skv, st, causal, scale, s);
    else
      err = launch_f32<128>(fq, fk, fv, fdo, lse, D, gq, gk, gv, B, Hq, Hkv,
                            Sq, Skv, st, causal, scale, s);
  } else {
    const bf16 *bq = static_cast<const bf16*>(q),
               *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v),
               *bdo = static_cast<const bf16*>(dO);
    bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk),
         *gv = static_cast<bf16*>(dv);
    // hd 128: 32-query tiles keep S^T, dP^T, dK and dV in registers
    if (hd == 64)
      err = launch_bf16<64, 64>(bq, bk, bv, bdo, lse, D, gq, gk, gv, B, Hq,
                                Hkv, Sq, Skv, st, causal, scale, s);
    else if (hd == 80)
      err = launch_bf16<80, 64>(bq, bk, bv, bdo, lse, D, gq, gk, gv, B, Hq,
                                Hkv, Sq, Skv, st, causal, scale, s);
    else
      err = launch_bf16<128, 32>(bq, bk, bv, bdo, lse, D, gq, gk, gv, B, Hq,
                                 Hkv, Sq, Skv, st, causal, scale, s);
  }
  return static_cast<int>(err);
}
