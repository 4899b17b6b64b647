"""The port's attention kernels (``repro_torch.kernels``), plain versions on
the CPU, held against the JAX package's: the jnp oracles, the Pallas
kernels in interpret mode, and the reference's ``blocked_attention``,
which the port's whole-prompt prefill replaces with ``flash_attention``.

Inputs come from numpy seeds and go to both packages.  Tolerance: 1e-5 abs
in float32 (the two sides sum in different orders).  The CUDA kernels
themselves run only on the card (``chip_smoke.py``); here the wrappers must
take the plain path for CPU tensors and refuse any other device.  The
``ragged_prefill`` plain version is held against JAX in
``test_torch_disagg.py``; here a mirror of its CUDA kernel's tiling is.
"""

import dataclasses
import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.ragged_decode import ops as jax_rd_ops
from repro.kernels.ragged_decode.ref import ragged_decode_ref as jax_rd_ref
from repro.kernels.ragged_prefill import force_pallas as jax_rp_force_pallas
from repro.kernels.ragged_prefill import ragged_prefill_attention as jax_rp
from repro.kernels.ragged_prefill.ref import ragged_prefill_ref as jax_rp_ref
from repro.models.layers import blocked_attention
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.ragged_decode import ops as rd
from repro_torch.kernels.ragged_prefill import ops as rp

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and the suite's other
    workers keep their cores (their latency-driven tests read wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# ragged decode
# ---------------------------------------------------------------------------

RAGGED_CASES = [
    # (B, Hq, Hkv, Smax, hd, pos): GQA rep 7 and 3, Smax off the 128-row
    # block, an idle slot at pos 0, a slot at the last row
    (3, 14, 2, 200, 16, (0, 130, 199)),
    (2, 9, 3, 64, 8, (0, 17)),
]


@pytest.mark.parametrize("B,Hq,Hkv,Smax,hd,pos", RAGGED_CASES)
def test_ragged_decode_plain_matches_jax(B, Hq, Hkv, Smax, hd, pos):
    rng = np.random.default_rng(Smax)
    q, k, v = _np(rng, B, Hq, hd), _np(rng, B, Smax, Hkv, hd), \
        _np(rng, B, Smax, Hkv, hd)
    p = np.asarray(pos, np.int32)
    want_ref = np.asarray(jax_rd_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(p)))
    with jax_rd_ops.force_pallas():       # Pallas kernel, interpret mode
        want_pallas = np.asarray(jax_rd_ops.ragged_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(p)))
    n0 = rd.launches
    got = rd.ragged_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), torch.from_numpy(p))
    assert rd.launches == n0              # CPU tensors: plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, Hq, hd)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=TOL, rtol=0)


def test_ragged_decode_ignores_rows_past_pos():
    """Garbage past each slot's position must not change the output."""
    rng = np.random.default_rng(1)
    q, k, v = _np(rng, 2, 6, 8), _np(rng, 2, 40, 2, 8), _np(rng, 2, 40, 2, 8)
    pos = torch.tensor([3, 20], dtype=torch.int32)
    a = rd.ragged_decode_attention(*map(torch.from_numpy, (q, k, v)), pos)
    k[0, 4:], v[0, 4:], k[1, 21:], v[1, 21:] = 1e3, -1e3, 7.0, 7.0
    b = rd.ragged_decode_attention(*map(torch.from_numpy, (q, k, v)), pos)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# The CUDA kernel splits each slot's cache into splits of L rows (chosen on
# the host from the shapes and the SM count), runs an online softmax per
# split and merges the splits by log-sum-exp.  The mirror below repeats
# that arithmetic in plain torch (per-split max, p rounded to the cache
# type against it, the merge) and is held against the JAX reference.

def _split_merge_mirror(q, k, v, pos, L):
    B, Hq, hd = q.shape
    Smax, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    out = torch.zeros(B, Hq, hd)
    for b in range(B):
        last = min(int(pos[b]), Smax - 1)
        for g in range(Hkv):
            qg = q[b, g * rep:(g + 1) * rep].float()
            ms, ls, accs = [], [], []
            for start in range(0, last + 1, L):
                end = min(start + L, last + 1)
                s = qg @ k[b, start:end, g].float().T / math.sqrt(hd)
                m = s.max(dim=1, keepdim=True).values
                p = torch.exp(s - m)
                ms.append(m)
                ls.append(p.sum(dim=1, keepdim=True))
                accs.append(p.to(v.dtype).float() @ v[b, start:end, g].float())
            M = torch.stack(ms).max(dim=0).values
            c = [torch.exp(m - M) for m in ms]
            num = sum(ci * a for ci, a in zip(c, accs))
            den = sum(ci * li for ci, li in zip(c, ls))
            out[b, g * rep:(g + 1) * rep] = num / den.clamp_min(1e-30)
    return out


SPLIT_SMAX, SPLIT_SMS = 256, 16          # 4 splits of 64 at B=4, Hkv=2


@pytest.mark.parametrize("edge", ("boundaries", "past_cache"))
@pytest.mark.parametrize("hd", (64, 128))
@pytest.mark.parametrize("rep", (7, 16))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_split_merge_mirror_matches_jax(dtype, rep, hd, edge):
    B, Hkv, Smax = 4, 2, SPLIT_SMAX
    n_split, L = rd.split_geometry(B, Hkv, Smax, SPLIT_SMS)
    assert (n_split, L) == (4, 64)
    pos = {"boundaries": (0, L - 1, L, 2 * L - 1),
           "past_cache": (Smax + 7, Smax - 1, 2 * L, 1)}[edge]
    rng = np.random.default_rng(rep * hd)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(_np(rng, *shape)).to(tdt) for shape in
               ((B, Hkv * rep, hd), (B, Smax, Hkv, hd), (B, Smax, Hkv, hd)))
    p = np.asarray(pos, np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jax_rd_ref(*(jnp.asarray(t.float().numpy(), jdt)
                                   for t in (q, k, v)), jnp.asarray(p)))
    got = _split_merge_mirror(q, k, v, p, L).numpy()
    tol = 2e-2 if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("sms", (132, 16))
@pytest.mark.parametrize("Smax", (32, 1000, 2048))
@pytest.mark.parametrize("B", (1, 8))
def test_split_geometry_covers_each_row_once(B, Smax, sms):
    n_split, L = rd.split_geometry(B, 2, Smax, sms)
    assert L % rd.SPLIT_TILE == 0 and n_split >= 1
    assert (n_split - 1) * L < Smax <= n_split * L   # no split starts past
    owner = np.full(Smax, -1)
    for i in range(n_split):
        rows = owner[i * L:(i + 1) * L]
        assert (rows == -1).all()
        rows[:] = i
    assert (owner >= 0).all()


# ---------------------------------------------------------------------------
# ragged prefill: the tensor-core kernel's tiling
# ---------------------------------------------------------------------------

# The bf16 CUDA kernel folds GQA into 64-row tiles (row i of kv head g is
# token i // rep, query head g * rep + i % rep), stops each tile at its
# causal horizon, gives alternate 64-key tiles to two warpgroups with an
# online softmax each (p rounded to the cache's type), masks only key
# tiles that cross the smallest horizon of the tile's rows, and merges the
# warpgroups.  The mirror below follows that order in plain torch;
# ``visits`` counts each (row, key) pair whose p it computes.

PREFILL_TILE = 64       # the kernel's folded rows and keys a tile (kRows)


def _prefill_tile_mirror(q, k, v, start, qlen, visits=None):
    B, T, Hq, hd = q.shape
    Smax, Hkv = k.shape[1], k.shape[2]
    rep, tile_rows = Hq // Hkv, PREFILL_TILE
    rows = T * rep
    neg = -1e30
    out = torch.zeros(B, T, Hq, hd)
    for b, g in np.ndindex(B, Hkv):
        s0, ql = int(start[b]), int(qlen[b])
        for i0 in range(0, rows, tile_rows):
            gi = torch.arange(i0, i0 + tile_rows)
            inrow = gi < rows
            t = torch.where(inrow, gi // rep, 0)
            h = g * rep + gi % rep
            qt = torch.where(inrow[:, None], q[b, t, h].float(), 0.0)
            t_first = i0 // rep
            t_end = (min(i0 + tile_rows, rows) - 1) // rep
            n_keys = (min(s0 + min(t_end, ql - 1) + 1, Smax)
                      if t_first < ql else 0)
            n_kt = -(-n_keys // tile_rows)
            tile_lim = (min(s0 + t_first, Smax - 1)
                        if i0 + tile_rows <= rows and t_end < ql else -1)
            lim = torch.where(inrow & (t < ql), (s0 + t).clamp(max=Smax - 1),
                              -1)
            wgs = []
            for wg in (0, 1):
                m = torch.full((tile_rows, 1), neg)
                l = torch.zeros(tile_rows, 1)
                acc = torch.zeros(tile_rows, hd)
                for kt in range(wg, n_kt, 2):
                    keys = torch.arange(kt * tile_rows, (kt + 1) * tile_rows)
                    live = keys < Smax          # past the cache: TMA zeros
                    kk = torch.where(live[:, None],
                                     k[b, keys.clamp(max=Smax - 1), g]
                                     .float(), 0.0)
                    vv = torch.where(live[:, None],
                                     v[b, keys.clamp(max=Smax - 1), g]
                                     .float(), 0.0)
                    sc = qt @ kk.T / math.sqrt(hd)
                    mask = torch.zeros_like(sc, dtype=torch.bool)
                    if keys[-1] > tile_lim:
                        mask = keys[None, :] > lim[:, None]
                    sc = sc.masked_fill(mask, neg)
                    m_new = torch.maximum(m, sc.max(dim=1,
                                                    keepdim=True).values)
                    p = torch.exp(sc - m_new).masked_fill(mask, 0.0)
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(dim=1, keepdim=True)
                    acc = acc * corr + p.to(v.dtype).float() @ vv
                    m = m_new
                    if visits is not None:
                        for r in torch.nonzero(inrow).flatten():
                            seen = keys[~mask[r] & live]
                            visits[b, g, i0 + r, seen] += 1
                wgs.append((m, l, acc))
            (m0, l0, a0), (m1, l1, a1) = wgs
            M = torch.maximum(m0, m1)
            c0, c1 = torch.exp(m0 - M), torch.exp(m1 - M)
            y = (c0 * a0 + c1 * a1) / (c0 * l0 + c1 * l1).clamp_min(1e-30)
            y = torch.where((t < ql)[:, None], y, 0.0)
            out[b, t[inrow], h[inrow]] = y[inrow]
    return out


# (T, Smax, starts, qlens): "mixed" holds a full chunk from 0, a chunk
# ending at the cache's edge, an empty slot (qlen 0) and a partial chunk,
# T = 37 not a multiple of a tile's tokens at rep 7 or 16, Smax = 150 not
# a multiple of a key tile; "deep" holds chunks late in a longer cache, so
# both warpgroups take several key tiles and the masked tiles are the last
PREFILL_SETS = {"mixed": (37, 150, (0, 113, 50, 20), (37, 37, 0, 11)),
                "deep": (20, 400, (330, 380), (20, 17))}
_prefill_want = {}


def _prefill_case(dtype, rep, hd, inputs):
    """Inputs and the JAX package's answers (jnp oracle, Pallas kernel in
    interpret mode), made once per configuration."""
    key = (dtype, rep, hd, inputs)
    if key not in _prefill_want:
        T, Smax, starts, qlens = PREFILL_SETS[inputs]
        B, Hkv = len(starts), 2
        rng = np.random.default_rng(rep * hd + Smax)
        tdt = getattr(torch, dtype)
        q, k, v = (torch.from_numpy(_np(rng, *shape)).to(tdt) for shape in
                   ((B, T, Hkv * rep, hd), (B, Smax, Hkv, hd),
                    (B, Smax, Hkv, hd)))
        start = np.asarray(starts, np.int32)
        qlen = np.asarray(qlens, np.int32)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        jargs = (*(jnp.asarray(t.float().numpy(), jdt) for t in (q, k, v)),
                 jnp.asarray(start), jnp.asarray(qlen))
        want_ref = np.asarray(jax_rp_ref(*jargs), np.float32)
        with jax_rp_force_pallas():        # Pallas kernel, interpret mode
            want_pallas = np.asarray(jax_rp(*jargs, block_k=16), np.float32)
        _prefill_want[key] = (q, k, v, start, qlen, want_ref, want_pallas)
    return _prefill_want[key]


@pytest.mark.parametrize("inputs", ("mixed", "deep"))
@pytest.mark.parametrize("hd", (64, 128))
@pytest.mark.parametrize("rep", (7, 16))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_prefill_tile_mirror_matches_jax(dtype, rep, hd, inputs):
    q, k, v, start, qlen, want_ref, want_pallas = _prefill_case(dtype, rep,
                                                                hd, inputs)
    got = _prefill_tile_mirror(q, k, v, start, qlen).numpy()
    tol = 2e-2 if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(got, want_ref, atol=tol, rtol=0)
    np.testing.assert_allclose(got, want_pallas, atol=tol, rtol=0)
    for b, n in enumerate(qlen):
        assert not got[b, n:].any()                      # exact zeros


@pytest.mark.parametrize("inputs", ("mixed", "deep"))
@pytest.mark.parametrize("rep", (1, 7, 16))
def test_prefill_tiles_visit_each_causal_pair_once(rep, inputs):
    """Every (row, key) pair the causal mask allows is computed exactly
    once, by one of the two warpgroups, and none past it."""
    T, Smax, starts, qlens = PREFILL_SETS[inputs]
    B, Hkv, hd = len(starts), 2, 8
    rng = np.random.default_rng(rep)
    q, k, v = (torch.from_numpy(_np(rng, *shape)) for shape in
               ((B, T, Hkv * rep, hd), (B, Smax, Hkv, hd),
                (B, Smax, Hkv, hd)))
    visits = torch.zeros(B, Hkv, T * rep, Smax, dtype=torch.int32)
    _prefill_tile_mirror(q, k, v, starts, qlens, visits)
    keys = torch.arange(Smax)
    for b, (s0, ql) in enumerate(zip(starts, qlens)):
        t = torch.arange(T * rep) // rep
        allowed = (keys[None, :] <= s0 + t[:, None]) & (t[:, None] < ql)
        assert torch.equal(visits[b], allowed.int()[None].expand(Hkv, -1, -1))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (B, Hq, Hkv, Sq, Skv, hd)
    (1, 14, 2, 37, 37, 4),       # odd S: the ragged edge
    (2, 9, 3, 64, 64, 8),
    (1, 4, 4, 24, 40, 16),       # Sq != Skv
]


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,hd", FLASH_CASES)
def test_flash_attention_plain_matches_jax(B, Hq, Hkv, Sq, Skv, hd, causal):
    rng = np.random.default_rng(Sq * Skv)
    q, k, v = _np(rng, B, Hq, Sq, hd), _np(rng, B, Hkv, Skv, hd), \
        _np(rng, B, Hkv, Skv, hd)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(jax_attention_ref(jq, jk, jv, causal=causal))
    n0 = fa.launches
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal)
    assert fa.launches == n0
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, Hq, Sq, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    if Sq % 16 == 0 and Skv % 16 == 0:    # the Pallas kernel's tiling rule
        pallas = np.asarray(jax_flash(jq, jk, jv, causal=causal, block_q=16,
                                      block_k=16, force_pallas=True))
        np.testing.assert_allclose(got.numpy(), pallas, atol=TOL, rtol=0)


@pytest.mark.parametrize("scheme", ("blocked", "wrapped"))
@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("S", (37, 64))
def test_flash_attention_matches_blocked_attention(scheme, causal, S):
    """The prefill attention the port replaces: the reference's jnp
    ``blocked_attention`` in both causal schemes (S=64 takes the wrapped
    pairing path at q_block 16; odd S falls back to the blocked path)."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b", reduced=True),
                              causal_scheme=scheme)
    B, Hq, Hkv, hd = 2, cfg.n_heads, cfg.n_kv_heads, 8
    rng = np.random.default_rng(S)
    q, k, v = _np(rng, B, S, Hq, hd), _np(rng, B, S, Hkv, hd), \
        _np(rng, B, S, Hkv, hd)
    want = np.asarray(blocked_attention(cfg, jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal))
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    got = got.transpose(1, 2).reshape(B, S, Hq * hd)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("layout,ok", (
    ("bshd_view", True),         # the model's transposed activations
    ("bhsd", True),
    ("odd_heads", False),        # a head stride of 1601 elements
    ("hd_strided", False),
))
def test_flash_tma_operand_check(layout, ok):
    """bf16 operands go to TMA: base and stepped strides in 16-byte units,
    hd contiguous; the op refuses anything else instead of copying."""
    if layout == "bshd_view":
        t = torch.zeros(1, 37, 14, 64, dtype=torch.bfloat16).transpose(1, 2)
    elif layout == "bhsd":
        t = torch.zeros(2, 2, 17, 64, dtype=torch.bfloat16)
    elif layout == "odd_heads":
        t = torch.zeros(1, 5, 2, 25 * 64 + 1,
                        dtype=torch.bfloat16)[..., :64].transpose(1, 2)
    else:
        t = torch.zeros(1, 2, 9, 128, dtype=torch.bfloat16)[..., ::2]
    if ok:
        fa.check_tma(t, "q")
    else:
        with pytest.raises(ValueError):
            fa.check_tma(t, "q")


# ---------------------------------------------------------------------------
# no fallback: a tensor that is not on the CPU launches or raises
# ---------------------------------------------------------------------------

def test_ops_refuse_devices_without_a_kernel():
    q = torch.empty(2, 4, 64, device="meta")
    kv = torch.empty(2, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rd.ragged_decode_attention(q, kv, kv, torch.zeros(2, device="meta"))
    q4 = torch.empty(1, 4, 8, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q4, q4, q4)
    one = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rp.ragged_prefill_attention(q4, q4, q4, one, one)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_names_library_by_source_hash():
    srcs = _build.sources()
    assert {p.parent.parent.name for p in srcs} == {
        "ragged_decode", "flash_attention", "ragged_prefill", "matmul",
        "stream_copy", "bitonic_sort"}
    assert len(_build._digest(srcs)) == 16
    assert _build._digest(srcs) != _build._digest(srcs[:1])


@pytest.mark.parametrize("change", ("edit", "add"))
def test_build_digest_covers_headers(monkeypatch, tmp_path, change):
    """A header edited or added under kernels/ renames the library, so a
    stale build is never loaded."""
    assert any(h.name == "sm90.cuh" for h in _build.headers())
    root = tmp_path / "kernels"
    shutil.copytree(_build._KERNELS, root,
                    ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    monkeypatch.setattr(_build, "_KERNELS", root)
    before = _build._digest(_build.sources())
    if change == "edit":
        hdr = root / "csrc" / "sm90.cuh"
        hdr.write_text(hdr.read_text() + "// edited\n")
    else:
        (root / "ragged_decode" / "csrc" / "extra.cuh").write_text("#pragma once\n")
    assert _build._digest(_build.sources()) != before
