"""The port's kernels of the paper's three classes (``repro_torch.kernels``:
``matmul``, ``stream_copy`` with ``stream_scale_add``, ``bitonic_sort``),
plain versions on the CPU, held against the JAX package's jnp oracles and
its Pallas kernels in interpret mode on the same numpy inputs, at the
shapes and tolerances of the reference's ``tests/test_kernels.py``:
matmul 1e-4 (float32) and 2e-2 (bfloat16) relative with ``tol * sqrt(k)``
absolute, sort and copy exact, scale-add 2e-2.

Also the ops' ``out=`` (the runtime's TAO bodies write row slices in
place), the shapes the TPU kernels refused (any matmul shape, rows whose
length is not a power of two, copies of any length), and the refusal of
any device but the CPU and the card.  The CUDA kernels themselves run
only on the card (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitonic_sort.kernel import sort_rows_pallas
from repro.kernels.bitonic_sort.ref import sort_rows_ref as jax_sort_ref
from repro.kernels.matmul.kernel import matmul_pallas
from repro.kernels.matmul.ref import matmul_ref as jax_matmul_ref
from repro.kernels.stream_copy.kernel import (stream_copy_pallas,
                                              stream_scale_add_pallas)
from repro.kernels.stream_copy.ref import stream_copy_ref as jax_copy_ref
from repro.kernels.stream_copy.ref import (
    stream_scale_add_ref as jax_scale_add_ref)
from repro_torch.kernels.bitonic_sort import ops as so
from repro_torch.kernels.matmul import ops as mm
from repro_torch.kernels.stream_copy import ops as sc

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast, and the suite's other
    workers keep their cores (their latency-driven tests read wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray, dtype: str):
    """The same values in both packages (float32 -> bfloat16 rounds to
    nearest even on both sides)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 512, 128, 128, 128, 256),
    (512, 256, 256, 256, 128, 128),
    (128, 1024, 256, 64, 128, 512),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_jax(m, k, n, bm, bn, bk, dtype):
    rng = np.random.default_rng(m + k + n)
    jx, tx = _pair(rng.standard_normal((m, k)).astype(np.float32), dtype)
    jy, ty = _pair(rng.standard_normal((k, n)).astype(np.float32), dtype)
    got = mm.matmul(tx, ty)
    assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for want in (jax_matmul_ref(jx, jy),
                 matmul_pallas(jx, jy, block_m=bm, block_n=bn, block_k=bk,
                               interpret=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                                   atol=tol * np.sqrt(k))


@pytest.mark.parametrize("m,k,n", [(37, 19, 23), (1, 64, 64), (64, 1, 5)])
def test_matmul_any_shape(m, k, n):
    """The TPU wrapper asserted a (bm, bn, bk) tiling; the port takes any
    (M, K) x (K, N)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    np.testing.assert_allclose(mm.matmul(torch.from_numpy(x),
                                         torch.from_numpy(y)).numpy(),
                               x @ y, rtol=1e-5, atol=1e-5 * np.sqrt(k))


def test_matmul_out_writes_a_row_slice():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    out = torch.zeros(64, 64)
    got = mm.matmul(a[16:32], a, out=out[16:32])
    assert got.data_ptr() == out[16:32].data_ptr()
    torch.testing.assert_close(out[16:32], a[16:32] @ a)
    assert not out[:16].any() and not out[32:].any()
    lo = torch.zeros(4, 64, dtype=torch.bfloat16)
    mm.matmul(a[:4], a, out=lo)                     # out's dtype decides
    torch.testing.assert_close(lo, (a[:4] @ a).to(torch.bfloat16))
    with pytest.raises(TypeError):
        mm.matmul(a, a, out=torch.empty(64, 64), out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        mm.matmul(a, a, out=torch.empty(32, 64))
    with pytest.raises(ValueError):
        mm.matmul(a, a[:10])


# the kernel's tile plan: the runtime's product (64x64x64) and every row
# slice its TAO bodies take at widths 1-4 (rows c*64//w .. (c+1)*64//w:
# 64, 32, 22 and 21, 16), the checks' large product, a ragged one and a
# single row
PLAN_SHAPES = [(m, 64, 64) for m in (64, 32, 22, 21, 16)] + [
    (1000, 700, 300), (37, 19, 23), (1, 64, 64)]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_matmul_tile_plan_covers_each_output_once(m, k, n):
    """Every output element lies in exactly one thread's strip; a product
    whose sides are multiples of the tile (every TAO slice at width 1, 2
    and 4) has no thread without work."""
    plan = mm.TilePlan(m, n, k)
    gx, gy = plan.grid
    assert (gx - 1) * mm.BM < m <= gx * mm.BM
    assert (gy - 1) * mm.BN < n <= gy * mm.BN
    assert plan.k_tiles * mm.BK >= k > (plan.k_tiles - 1) * mm.BK
    hits = np.zeros((m, n), np.int32)
    strips = list(plan.strips())
    for r, c, w in strips:
        hits[r, c:c + w] += 1
    assert (hits == 1).all()
    if m % mm.BM == 0 and n % mm.BN == 0:
        assert len(strips) == gx * gy * mm.THREADS
        assert all(w == mm.STRIP for _, _, w in strips)


def _emulate_plan(plan, x, y):
    """The kernel's arithmetic in numpy: each thread's strip summed in f32
    FMAs in k order over its k-tiles, zero-padded past K (an FMA as the
    float64 product, exact, plus the f32 accumulator, rounded once to f32:
    a true FMA up to double rounding)."""
    kp = plan.k_tiles * mm.BK
    xp = np.zeros((plan.M, kp), np.float32)
    yp = np.zeros((kp, plan.N + mm.STRIP), np.float32)
    xp[:, :plan.K], yp[:plan.K, :plan.N] = x, y
    strips = np.array([(r, c) for r, c, _ in plan.strips()])
    rows, cols = strips[:, 0], strips[:, 1:] + np.arange(mm.STRIP)
    acc = np.zeros(cols.shape, np.float32)
    for k in range(kp):
        prod = (xp[rows, k].astype(np.float64)[:, None]
                * yp[k, cols].astype(np.float64))
        acc = (prod + acc).astype(np.float32)
    out = np.full((plan.M, plan.N + mm.STRIP), np.nan, np.float32)
    out[rows[:, None], cols] = acc
    return out[:, :plan.N]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_matmul_tile_plan_emulation_matches_jax(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    got = _emulate_plan(mm.TilePlan(m, n, k), x, y)
    want = np.asarray(jax_matmul_ref(jnp.asarray(x), jnp.asarray(y)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.sqrt(k))


# ---------------------------------------------------------------------------
# bitonic sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,n,br", [(8, 128, 8), (16, 256, 4),
                                       (4, 1024, 2)])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_sort_plain_matches_jax(rows, n, br, dtype):
    rng = np.random.default_rng(rows * n)
    if dtype == "int32":
        x = rng.integers(-1000, 1000, (rows, n)).astype(np.int32)
    else:
        x = rng.standard_normal((rows, n)).astype(np.float32)
    got = so.sort_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_sort_ref(x)))
    np.testing.assert_array_equal(
        got, np.asarray(sort_rows_pallas(jnp.asarray(x), block_rows=br,
                                         interpret=True)))


@pytest.mark.parametrize("rows,n", [(1, 21845), (3, 1000), (2, 1)])
def test_sort_rows_of_any_length(rows, n):
    """The TPU kernel took powers of two only; the runtime's sort chunks at
    width 3 are 65,536 / 3 long."""
    x = np.random.default_rng(n).integers(0, 1 << 30, (rows, n)).astype(
        np.int32)
    np.testing.assert_array_equal(so.sort_rows(torch.from_numpy(x)).numpy(),
                                  np.sort(x, axis=-1))


# The CUDA kernel runs the bitonic network on chip by the wrapper's plan
# (``so.sort_plan``): a row padded to 2^p sorts in one cluster of C blocks
# of 2^lb elements; each thread holds 2^W elements in registers, and each
# stage's steps run in windows of W index bits, the block moving its data
# through shared memory into the layout whose register bits are the
# window's; strides of a block or more pair whole blocks of the cluster.
# Longer rows add steps in device memory.  The mirror below repeats that
# plan in numpy, with the kernel's shift-and-mask indices, on int32 keys
# (floats as x ^ ((x >> 31) & 0x7fffffff)).

def _keys(x: np.ndarray, is_float: bool) -> np.ndarray:
    """int32 keys of float32 bits in the floats' order, and back (an
    involution); int32 as they are."""
    k = x.view(np.int32)
    return k ^ ((k >> 31) & 0x7FFFFFFF) if is_float else k


def _cluster_pass(buf, plan, s_lo, s_hi):
    """One launch of the cluster kernel over every cluster-sized chunk of
    buf: stages s_lo .. s_hi, the steps whose strides are below a chunk."""
    W, lb = so.REG_LOG2, plan.lb
    R = 1 << W
    lc, N = plan.span_log2, 1 << lb
    T = N >> W
    t = np.arange(T)[:, None]
    r = np.arange(R)[None, :]
    for g0 in range(0, len(buf), 1 << lc):
        blocks = buf[g0:g0 + (1 << lc)].reshape(plan.C, N)   # shared memory
        for s in range(s_lo, s_hi + 1):
            for b in range(min(s, lc) - 1, lb - 1, -1):       # cluster steps
                old = blocks.copy()
                for c in range(plan.C):
                    partner = c ^ (1 << (b - lb))
                    lower = (c >> (b - lb)) & 1 == 0
                    asc = ((g0 + (c << lb)) >> s) & 1 == 0
                    pick = np.minimum if lower == asc else np.maximum
                    blocks[c] = pick(old[c], old[partner])
            top = min(s, lb) - 1
            for a in range(top // W * W, -1, -W):             # windows
                ap = min(a, lb - W)
                hi, lo = min(top, a + W - 1) - ap, a - ap
                idx = (((t >> ap) << (ap + W)) | (t & ((1 << ap) - 1))
                       | (r << ap))
                assert np.array_equal(np.sort(idx, axis=None), np.arange(N))
                for c in range(plan.C):
                    v = blocks[c][idx]                        # registers
                    d = -((((g0 + (c << lb)) | idx) >> s) & 1).astype(
                        np.int32)
                    v ^= d                                    # flip
                    for bb in range(W - 1, -1, -1):
                        if lo <= bb <= hi:
                            rl = [x for x in range(R) if not x & (1 << bb)]
                            rh = [x | (1 << bb) for x in rl]
                            x, y = v[:, rl], v[:, rh]
                            v[:, rl], v[:, rh] = (np.minimum(x, y),
                                                  np.maximum(x, y))
                    blocks[c][idx] = v ^ d


def _sort_mirror(x: np.ndarray) -> np.ndarray:
    n = len(x)
    plan = so.sort_plan(n)
    lc = plan.span_log2
    pad = 0x7F800000 if x.dtype == np.float32 else np.iinfo(np.int32).max
    buf = np.full(max(1 << plan.p, 1 << lc), pad, np.int32)
    buf[:n] = _keys(x, x.dtype == np.float32)
    _cluster_pass(buf, plan, 1, min(plan.p, lc))
    for st in range(lc + 1, plan.p + 1):     # longer rows
        for b in range(st - 1, lc - 1, -1):  # a step in device memory
            p = np.arange(len(buf) // 2)
            i = ((p >> b) << (b + 1)) | (p & ((1 << b) - 1))
            j = i | (1 << b)
            asc = (i >> st) & 1 == 0
            lo, hi = np.minimum(buf[i], buf[j]), np.maximum(buf[i], buf[j])
            buf[i], buf[j] = np.where(asc, lo, hi), np.where(asc, hi, lo)
        _cluster_pass(buf, plan, st, st)
    return _keys(buf[:n].copy(), x.dtype == np.float32).view(x.dtype)


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 21845, 16384, 32768, 65536,
                               140000])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_sort_step_plan_mirror_matches_jax(n, dtype):
    """The plan in numpy equals np.sort and the JAX reference, for rows on
    one block, on clusters of 4 and 8, and past a cluster (140,000)."""
    rng = np.random.default_rng(n)
    if dtype == "int32":
        x = rng.integers(-(1 << 31), (1 << 31) - 1, n,
                         endpoint=True).astype(np.int32)
        x[: min(n, 2)] = np.iinfo(np.int32).max      # equal to the padding
    else:
        x = rng.standard_normal(n).astype(np.float32)
        x[: min(n, 4)] = np.float32([-0.0, np.inf, 0.0, -np.inf])[:min(n, 4)]
    got = _sort_mirror(x)
    np.testing.assert_array_equal(got, np.sort(x))
    np.testing.assert_array_equal(got, np.asarray(jax_sort_ref(x[None]))[0])


@pytest.mark.parametrize("n,launches", [
    (1, 1), (3, 1), (1000, 1), (4096, 1), (8192, 1), (16384, 1),
    (21845, 1), (32768, 1), (65536, 1), (70000, 1), (131072, 1),
    (131073, 3), (262144, 3), (1 << 20, 10)])
def test_sort_plan_one_launch_up_to_a_cluster(n, launches):
    """A row sorts in one device launch while its padded length fits a
    cluster (131,072 4-byte elements in 8 x 64 KB); the runtime's rows at
    widths 1, 2 and 4 (65,536, 32,768, 16,384) spread over 8, 8 and 4
    blocks of at least 4,096."""
    plan = so.sort_plan(n)
    assert plan.device_launches == launches
    assert (n <= 1 << plan.span_log2) == (launches == 1)
    assert plan.C in (1, 2, 4, 8)
    assert so.BLOCK_MIN_LOG2 <= plan.lb <= so.BLOCK_MAX_LOG2
    assert plan.lb - so.REG_LOG2 >= 5                  # whole warps
    want_c = {16384: 4, 32768: 8, 65536: 8}
    if n in want_c:
        assert plan.C == want_c[n] and 1 << plan.span_log2 == n
    if n <= 4096:
        assert plan.C == 1


def test_sort_out_writes_a_chunk():
    src = torch.from_numpy(np.random.default_rng(2).integers(
        0, 1 << 30, 3000).astype(np.int32))
    dst = torch.full((3000,), -1, dtype=torch.int32)
    so.sort_rows(src[1000:2000][None], out=dst[1000:2000][None])
    np.testing.assert_array_equal(dst[1000:2000].numpy(),
                                  np.sort(src[1000:2000].numpy()))
    assert (dst[:1000] == -1).all() and (dst[2000:] == -1).all()
    with pytest.raises(ValueError):
        so.sort_rows(src)                             # rows must be 2-D
    with pytest.raises(ValueError):
        so.sort_rows(src[None], out=torch.empty(1, 3000))   # dtype


# ---------------------------------------------------------------------------
# stream copy / scale-add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,block", [(1 << 14, 4096), (1 << 16, 1 << 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_plain_matches_jax(n, block, dtype):
    rng = np.random.default_rng(n)
    jx, tx = _pair(rng.standard_normal(n).astype(np.float32), dtype)
    jy, ty = _pair(rng.standard_normal(n).astype(np.float32), dtype)
    got = sc.stream_copy(tx)
    assert got.data_ptr() != tx.data_ptr()
    for want in (jax_copy_ref(jx),
                 stream_copy_pallas(jx, block=block, interpret=True)):
        np.testing.assert_array_equal(_f32(got), _f32(want))
    got = sc.stream_scale_add(tx, ty, 0.9, 0.1)
    assert got.dtype == tx.dtype
    for want in (jax_scale_add_ref(jx, jy, 0.9, 0.1),
                 stream_scale_add_pallas(jx, jy, 0.9, 0.1, block=block,
                                         interpret=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2,
                                   atol=2e-2)


def test_stream_ops_write_chunks_of_any_length():
    """The TPU kernels asserted ``n % block == 0``; the port's copy is
    byte-generic, and ``out=`` writes a chunk in place."""
    src = torch.arange(1001, dtype=torch.int32)
    dst = torch.full((1001,), -1, dtype=torch.int32)
    sc.stream_copy(src[333:667], out=dst[333:667])
    assert torch.equal(dst[333:667], src[333:667])
    assert (dst[:333] == -1).all() and (dst[667:] == -1).all()
    raw = torch.arange(7, dtype=torch.uint8)
    assert torch.equal(sc.stream_copy(raw[1:6]), raw[1:6])
    x, y = torch.linspace(-1, 1, 1001), torch.linspace(2, 3, 1001)
    out = torch.zeros(1001)
    sc.stream_scale_add(x[1:], y[1:], 0.5, -2.0, out=out[1:])
    torch.testing.assert_close(out[1:], 0.5 * x[1:] - 2.0 * y[1:])
    assert out[0] == 0
    with pytest.raises(ValueError):
        sc.stream_copy(src, out=torch.empty(1000, dtype=torch.int32))
    with pytest.raises(ValueError):
        sc.stream_scale_add(x, y[:10], 1.0, 1.0)


# ---------------------------------------------------------------------------
# no fallback: a tensor that is not on the CPU launches or raises
# ---------------------------------------------------------------------------

def test_paper_ops_refuse_devices_without_a_kernel():
    meta = torch.empty(8, 8, device="meta")
    ints = torch.empty(2, 64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        mm.matmul(meta, meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        so.sort_rows(ints)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sc.stream_copy(ints)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sc.stream_scale_add(meta, meta, 0.9, 0.1)
