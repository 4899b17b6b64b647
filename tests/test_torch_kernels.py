"""The port's attention kernels (``repro_torch.kernels``), plain versions on
the CPU, held against the JAX package's: the jnp oracles, the Pallas
kernels in interpret mode, and the reference's ``blocked_attention``,
which the port's whole-prompt prefill replaces with ``flash_attention``.

Inputs come from numpy seeds and go to both packages.  Tolerance: 1e-5 abs
in float32 (the two sides sum in different orders).  The CUDA kernels
themselves run only on the card (``chip_smoke.py``); here the wrappers must
take the plain path for CPU tensors and refuse any other device.  The
``ragged_prefill`` plain version is held against JAX in
``test_torch_disagg.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.ragged_decode import ops as jax_rd_ops
from repro.kernels.ragged_decode.ref import ragged_decode_ref as jax_rd_ref
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
