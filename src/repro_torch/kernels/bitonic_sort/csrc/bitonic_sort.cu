// Ascending row sort for Hopper (sm_90a) by a bitonic network, the
// paper's cache-bound kernel class.
//
// Replaces the TPU kernel repro/kernels/bitonic_sort/kernel.py
// (sort_rows_pallas, network in _bitonic_block).
//
// What bounds a row sort on the H100: bytes.  The paper's 256 KB row
// (65,536 int32) moves 512 KB, and a comparison sort needs at most
// n ceil(log2 n) = 1,048,576 comparisons, less time than the bytes at
// the card's min/max rate.  This network does more work than that: a row
// padded to P = 2^p elements takes P/2 * p(p+1)/2 compare-exchanges,
// 4,456,448 for the paper's row.  The TPU kernel kept the whole row in
// VMEM; here the whole row stays on chip too, in one launch:
//   * a row of P <= 131,072 elements sorts in one cluster of C = 1, 2, 4
//     or 8 blocks (the wrapper's plan: N = P / C elements a block, at
//     least 4,096 when C > 1 and at most 16,384 = 64 KB), whose shared
//     memories together hold the row.  It is read from device memory once
//     and written once.  Many rows run one cluster per row.  The paper's
//     row takes 8 blocks of 8,192: on an H100 SXM at 700 W that measured
//     0.051 ms against 0.062 for 4 blocks of 16,384;
//   * each thread owns R = 2^W elements in registers, so a step whose
//     stride is one of the R's index bits is compare-exchanges between
//     registers with compile-time indices, and no sync.  The network's
//     steps are taken in windows of W index bits: the block moves the
//     data through shared memory (one store, one __syncthreads, one load)
//     into the layout whose register bits are the window's, then runs all
//     of the stage's steps in that window on registers.  One round trip
//     thus serves up to W strides, at two shared accesses an element,
//     where a warp shuffle would cost one an element for every stride;
//     strides within a warp and across warps both go this way;
//   * strides across the cluster's blocks (one of C's bits: 6 steps for
//     the paper's row) read the partner block's shared memory through
//     distributed shared memory, between cluster barriers;
//   * there is no division in the network: an element's index is the
//     thread's bits and the register's bits, put together by shifts and
//     masks, and the merge of stage s runs ascending where bit s of the
//     index is 0 (so the last merge is ascending).  A descending run is
//     an ascending one on keys xor -1, so every compare-exchange is one
//     min and one max;
//   * float32 sorts as int32 keys (x ^ ((x >> 31) & 0x7fffffff) orders
//     them as the floats, -0.0 just before +0.0), one code path for both;
//   * shared memory is padded with one word after every R, so that a
//     warp's 32 threads hit 32 banks in every layout.
// A row whose length is not a power of two is padded on chip with the
// type's largest value (INT_MAX, +inf), which sorts last and is dropped on
// the way out.  A row longer than a cluster holds keeps a multi-launch
// path through device memory: one launch sorts every cluster-sized chunk
// in the direction the full network gives it, then for each later stage
// one launch per step whose stride is a chunk or more (one thread per
// compare-exchange) and one cluster launch that finishes the stage's
// smaller strides on chip.  Its non-power-of-two rows go through a scratch
// row of the padded length that the wrapper allocates.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kStepThreads = 256;
constexpr int kW = 5;          // 2^kW elements in a thread's registers

// kernel launches issued, for a caller that checks the launch plan (the
// runtime launches from several threads)
std::atomic<long long> g_launches{0};

// float bits <-> int32 keys in the floats' order (an involution)
__device__ __forceinline__ int to_key(int x, bool is_float) {
  return is_float ? x ^ ((x >> 31) & 0x7fffffff) : x;
}

template <int W>
__device__ __forceinline__ int spos(int idx) {    // padded shared index
  return idx + (idx >> W);
}

// The window of group G: index bits [G W, G W + W) of a block of 2^LB,
// held in registers by the layout AP (its register bits' offset, pulled
// down to end at bit LB): register r of thread t holds index
// base(t) + (r << AP), base(t) = ((t >> AP) << (AP + W)) | (t & (2^AP - 1)).
// AP is 0 or at least W, so a register's shared position is the thread's
// plus a constant.
template <int W, int LB, int G>
struct Win {
  static_assert(LB >= 2 * W, "a block holds at least 32 threads of 2^W");
  static constexpr int A = G * W;
  static constexpr int AP = A < LB - W ? A : LB - W;
  __device__ static __forceinline__ int base(int t) {
    return ((t >> AP) << (AP + W)) | (t & ((1 << AP) - 1));
  }
  __device__ static __forceinline__ int pbase(int t) {
    return spos<W>(base(t));
  }
  __host__ __device__ static constexpr int off(int r) {
    return AP == 0 ? r : (r << AP) + ((r << AP) >> W);
  }
};

template <int W, int LB, int G>
__device__ __forceinline__ void store_win(int* sm, const int (&v)[1 << W],
                                          int t) {
  using Wn = Win<W, LB, G>;
  int* p = sm + Wn::pbase(t);
#pragma unroll
  for (int r = 0; r < (1 << W); ++r) p[Wn::off(r)] = v[r];
}

template <int W, int LB, int G>
__device__ __forceinline__ void load_win(const int* sm, int (&v)[1 << W],
                                         int t) {
  using Wn = Win<W, LB, G>;
  const int* p = sm + Wn::pbase(t);
#pragma unroll
  for (int r = 0; r < (1 << W); ++r) v[r] = p[Wn::off(r)];
}

template <int W, int LB>
__device__ __forceinline__ void store_cur(int* sm, const int (&v)[1 << W],
                                          int t, int cur) {
  if (cur == 0) store_win<W, LB, 0>(sm, v, t);
  else if (cur == 1) store_win<W, LB, 1>(sm, v, t);
  else if (cur == 2) store_win<W, LB, 2>(sm, v, t);
}

// keys of register r xor -1 where bit SB of r is set
template <int W, int SB>
__device__ __forceinline__ void flip_bit(int (&v)[1 << W]) {
#pragma unroll
  for (int r = 0; r < (1 << W); ++r)
    if (r & (1 << SB)) v[r] = ~v[r];
}

// A descending run of stage s (bit s of the index set) becomes an
// ascending one on keys xor -1: in place, for the window of group G.
template <int W, int LB, int G>
__device__ __forceinline__ void flip(int (&v)[1 << W], int t, int s,
                                     long long gbase) {
  constexpr int AP = Win<W, LB, G>::AP;
  const int sb = s - AP;
  if (s < LB && sb >= 0 && sb < W) {        // a register bit
    switch (sb) {
      case 0: flip_bit<W, 0>(v); break;
      case 1: if constexpr (W > 1) flip_bit<W, 1>(v); break;
      case 2: if constexpr (W > 2) flip_bit<W, 2>(v); break;
      case 3: if constexpr (W > 3) flip_bit<W, 3>(v); break;
      case 4: if constexpr (W > 4) flip_bit<W, 4>(v); break;
      default: if constexpr (W > 5) flip_bit<W, 5>(v); break;
    }
    return;
  }
  const int d = s >= LB ? -static_cast<int>((gbase >> s) & 1)
                        : -((Win<W, LB, G>::base(t) >> s) & 1);
  if (__any_sync(~0u, d != 0)) {
#pragma unroll
    for (int r = 0; r < (1 << W); ++r) v[r] ^= d;
  }
}

// The steps of stage s whose strides are index bits of group G's window,
// from the highest: the block's data moves into the window's layout (if
// it is not there), then every step is compare-exchanges of registers.
template <int W, int LB, int G>
__device__ __forceinline__ void window(int* sm, int (&v)[1 << W], int& cur,
                                       int t, int s, long long gbase) {
  using Wn = Win<W, LB, G>;
  if (cur != G) {
    store_cur<W, LB>(sm, v, t, cur);
    __syncthreads();
    load_win<W, LB, G>(sm, v, t);
    cur = G;
  }
  const int top = min(s, LB) - 1;
  const int hi = min(top, Wn::A + W - 1) - Wn::AP;
  constexpr int lo = Wn::A - Wn::AP;
  flip<W, LB, G>(v, t, s, gbase);
#pragma unroll
  for (int bb = W - 1; bb >= lo; --bb) {
    if (bb > hi) continue;
#pragma unroll
    for (int r = 0; r < (1 << W); ++r)
      if (!(r & (1 << bb))) {
        const int x = v[r], y = v[r | (1 << bb)];
        v[r] = min(x, y);
        v[r | (1 << bb)] = max(x, y);
      }
  }
  flip<W, LB, G>(v, t, s, gbase);
}

// Sorts elements [g0, g0 + C * N) of each row (g0 = chunk * C * N, chunk
// = blockIdx.x / C; rows by blockIdx.y) through stages s_lo .. s_hi of the
// network, with the steps whose strides are below C * N; reads src
// (indices >= n are padding), writes dst indices < dst_n.  Block rank c of
// the cluster holds indices g0 + c * N .. + N, N = 2^LB, as keys in
// shared memory, N >> W threads of 2^W registers each.
template <int W, int LB, bool F>
__global__ void __launch_bounds__((1 << LB) >> W)
sort_cluster(const int* __restrict__ src, long long src_stride, long long n,
             int* __restrict__ dst, long long dst_stride, long long dst_n,
             int s_lo, int s_hi) {
  constexpr int R = 1 << W, N = 1 << LB, T = N >> W;
  extern __shared__ __align__(16) int sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int lc = LB + 31 - __clz(C);          // log2 of the cluster's span
  const int t = threadIdx.x;
  const long long gbase = static_cast<long long>(blockIdx.x) << LB;
  const int pad = F ? 0x7f800000 : INT_MAX;   // +inf's key, or INT_MAX

  const int* srow = src + blockIdx.y * src_stride;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * T + t;
    const long long gi = gbase + e;
    sm[spos<W>(e)] = gi < n ? to_key(srow[gi], F) : pad;
  }

  int v[R];
  int cur = -1;   // the window group whose layout v holds, or -1

  for (int s = s_lo; s <= s_hi; ++s) {
    // strides of a block or more: block c against block c ^ (j / N), the
    // whole block keeping the min or the max
    for (int b = min(s, lc) - 1; b >= LB; --b) {
      store_cur<W, LB>(sm, v, t, cur);
      cur = -1;
      const int partner = c ^ (1 << (b - LB));
      const bool lower = ((c >> (b - LB)) & 1) == 0;
      const bool asc = ((gbase >> s) & 1) == 0;
      const int* rem = cluster.map_shared_rank(sm, partner);
      cluster.sync();                         // every block's data is there
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = rem[spos<W>(r * T + t)];
      cluster.sync();                         // the partner has read mine
      if (lower == asc) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          int& x = sm[spos<W>(r * T + t)];
          x = min(x, v[r]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          int& x = sm[spos<W>(r * T + t)];
          x = max(x, v[r]);
        }
      }
    }
    // strides below a block: the windows from the top group down
    const int gtop = (min(s, LB) - 1) / W;
    if constexpr (LB > 2 * W)
      if (gtop >= 2) window<W, LB, 2>(sm, v, cur, t, s, gbase);
    if (gtop >= 1) window<W, LB, 1>(sm, v, cur, t, s, gbase);
    window<W, LB, 0>(sm, v, cur, t, s, gbase);
  }

  store_cur<W, LB>(sm, v, t, cur);
  __syncthreads();
  int* drow = dst + blockIdx.y * dst_stride;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * T + t;
    const long long gi = gbase + e;
    if (gi < dst_n) drow[gi] = to_key(sm[spos<W>(e)], F);
  }
}

// Grid (ceil(P / 2 / kStepThreads), rows): step (stage s, stride 2^b) of
// the network in device memory, one compare-exchange per thread.
template <typename T>
__global__ void __launch_bounds__(kStepThreads)
global_step(T* buf, long long stride, long long half, int s, int b) {
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= half) return;
  const long long i = ((p >> b) << (b + 1)) | (p & ((1LL << b) - 1));
  const long long l = i | (1LL << b);
  T* row = buf + blockIdx.y * stride;
  const T x = row[i], y = row[l];
  const bool asc = ((i >> s) & 1) == 0;
  if (asc ? (y < x) : (x < y)) {
    row[i] = y;
    row[l] = x;
  }
}

template <int W, int LB, bool F>
cudaError_t launch_cluster(const int* src, long long src_stride, long long n,
                           int* dst, long long dst_stride, long long dst_n,
                           int rows, int C, int chunks, int s_lo, int s_hi,
                           cudaStream_t s) {
  constexpr int N = 1 << LB;
  constexpr size_t smem = (N + (N >> W)) * sizeof(int);
  static const cudaError_t attr = cudaFuncSetAttribute(
      sort_cluster<W, LB, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C * chunks),
                     static_cast<unsigned>(rows));
  cfg.blockDim = dim3(N >> W);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  ++g_launches;
  return cudaLaunchKernelEx(&cfg, sort_cluster<W, LB, F>, src, src_stride,
                            n, dst, dst_stride, dst_n, s_lo, s_hi);
}

// launch_cluster for the run-time block size 2^lb
template <int W, bool F>
cudaError_t cluster_pass(int lb, const int* src, long long src_stride,
                         long long n, int* dst, long long dst_stride,
                         long long dst_n, int rows, int C, int chunks,
                         int s_lo, int s_hi, cudaStream_t s) {
#define REPRO_SORT_LB(LB)                                                   \
  if (lb == LB)                                                             \
    return launch_cluster<W, LB, F>(src, src_stride, n, dst, dst_stride,    \
                                    dst_n, rows, C, chunks, s_lo, s_hi, s);
  REPRO_SORT_LB(10)
  REPRO_SORT_LB(11)
  REPRO_SORT_LB(12)
  REPRO_SORT_LB(13)
  REPRO_SORT_LB(14)
#undef REPRO_SORT_LB
  return cudaErrorInvalidValue;
}

template <int W, bool F>
int launch(const void* src_v, void* work_v, void* out_v, int rows,
           long long n, long long src_stride, long long work_stride,
           long long out_stride, int lb, int C, cudaStream_t s) {
  using T = typename std::conditional<F, float, int>::type;
  const int* src = static_cast<const int*>(src_v);
  int* work = static_cast<int*>(work_v);
  int* out = static_cast<int*>(out_v);
  int p = 0;
  while ((1LL << p) < n) ++p;
  const int lc = lb + 31 - __builtin_clz(C);
  if (p <= lc) {                       // the whole row on chip
    return static_cast<int>(cluster_pass<W, F>(
        lb, src, src_stride, n, out, out_stride, n, rows, C, 1, 1, p, s));
  }
  if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long P = 1LL << p;
  const int chunks = static_cast<int>(P >> lc);
  cudaError_t err = cluster_pass<W, F>(lb, src, src_stride, n, work,
                                       work_stride, P, rows, C, chunks, 1,
                                       lc, s);
  const long long half = P / 2;
  const unsigned step_blocks =
      static_cast<unsigned>((half + kStepThreads - 1) / kStepThreads);
  for (int st = lc + 1; st <= p && err == cudaSuccess; ++st) {
    for (int b = st - 1; b >= lc; --b) {
      global_step<T><<<dim3(step_blocks, rows), kStepThreads, 0, s>>>(
          reinterpret_cast<T*>(work), work_stride, half, st, b);
      ++g_launches;
    }
    const bool last = st == p;
    err = cudaGetLastError();
    if (err == cudaSuccess)
      err = cluster_pass<W, F>(lb, work, work_stride, P, last ? out : work,
                               last ? out_stride : work_stride, last ? n : P,
                               rows, C, chunks, st, st, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 int32.  Sorts each of `rows` rows of n elements
// (row strides in elements) from src into out, by the wrapper's plan:
// blocks of 2^lb elements (1,024 .. 16,384: at least 32 threads of 2^kW),
// clusters of C in {1, 2, 4, 8}.  work holds rows of the padded length
// P = 2^ceil(log2 n) when P > C * 2^lb (it may be out itself when n == P);
// it is unused, and may be null, otherwise.  Returns cudaGetLastError()
// after the launches.
extern "C" int bitonic_sort_launch(int dtype, const void* src, void* work,
                                   void* out, int rows, long long n,
                                   long long src_stride,
                                   long long work_stride,
                                   long long out_stride, int lb, int C,
                                   void* stream) {
  if (rows <= 0 || rows > 65535 || n <= 0 || n > (1LL << 30) ||
      lb < 2 * kW || lb > 14 || (C != 1 && C != 2 && C != 4 && C != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<kW, true>(src, work, out, rows, n, src_stride, work_stride,
                            out_stride, lb, C, s);
  if (dtype == 1)
    return launch<kW, false>(src, work, out, rows, n, src_stride,
                             work_stride, out_stride, lb, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel launches this library has issued for sorts so far.
extern "C" long long bitonic_sort_kernel_launches() { return g_launches; }
