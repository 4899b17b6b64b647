"""The port's dense model (``repro_torch.models``) on the CPU, held against
the JAX package: layers one by one, then whole-prompt prefill and per-step
decode logits with the reference's weights carried over by
``params_from_numpy``.  Inputs come from numpy seeds and go to both.

Tolerance: 1e-4 abs and rel on logits and caches (float32 on both sides;
products and sums run in different orders), 1e-5 on single layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import get_model, layers as JL
from repro.models import sessions as jsessions
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import torch_dtype
from repro_torch.device import resolve_device
from repro_torch.models import get_model as tget_model
from repro_torch.models import layers as TL
from repro_torch.models import sessions as tsessions
from repro_torch.models.convert import params_from_numpy

ARCHS = ("qwen2-0.5b", "smollm-135m")
TOL = 1e-4


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


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _configs(arch, **changes):
    jc = dataclasses.replace(get_config(arch, reduced=True), **changes)
    tc = dataclasses.replace(tget_config(arch, reduced=True), **changes)
    return jc, tc


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ("rmsnorm", "layernorm"))
def test_apply_norm_matches_jax(kind):
    rng = np.random.default_rng(0)
    x, scale, bias = _np(rng, 2, 5, 24), _np(rng, 24), _np(rng, 24)
    p = {"scale": scale} if kind == "rmsnorm" else {"scale": scale,
                                                   "bias": bias}
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    got = TL.apply_norm(TL.Norm(_t(scale), _t(bias) if "bias" in p else None),
                        _t(x), kind)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("theta", (1e4, 1e6))
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 7, 3, 8)
    full = np.arange(7)                                  # prefill positions
    ragged = np.array([[3], [11]], np.int32)             # per-slot decode
    _close(TL.apply_rope(_t(x), torch.from_numpy(full), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(full), theta), 1e-5)
    x1 = x[:, :1]
    _close(TL.apply_rope(_t(x1), torch.from_numpy(ragged), theta),
           JL.apply_rope(jnp.asarray(x1), jnp.asarray(ragged), theta), 1e-5)


def _attn_params(cfg, rng):
    D, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": _np(rng, D, Hq * hd), "wk": _np(rng, D, Hkv * hd),
         "wv": _np(rng, D, Hkv * hd), "wo": _np(rng, Hq * hd, D)}
    if cfg.qkv_bias:
        p.update(bq=_np(rng, Hq * hd), bk=_np(rng, Hkv * hd),
                 bv=_np(rng, Hkv * hd))
    if cfg.qk_norm:
        p.update(q_norm=_np(rng, hd), k_norm=_np(rng, hd))
    return p


@pytest.mark.parametrize("arch,qk_norm", [("qwen2-0.5b", False),
                                          ("smollm-135m", False),
                                          ("smollm-135m", True)])
def test_qkv_matches_jax(arch, qk_norm):
    jc, tc = _configs(arch, qk_norm=qk_norm)
    rng = np.random.default_rng(2)
    p = _attn_params(jc, rng)
    x = _np(rng, 2, 5, jc.d_model)
    pos = np.arange(5)
    want = JL._qkv(jc, {k: jnp.asarray(v) for k, v in p.items()},
                   jnp.asarray(x), jnp.asarray(x), jnp.asarray(pos),
                   jnp.asarray(pos), True)
    got = TL._qkv(tc, TL.Attention(tc, {k: _t(v) for k, v in p.items()}),
                  _t(x), _t(x), torch.from_numpy(pos), torch.from_numpy(pos),
                  True)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("act", ("silu", "gelu"))
def test_mlp_matches_jax(act):
    jc, tc = _configs("qwen2-0.5b", act=act)
    rng = np.random.default_rng(3)
    D, Fd = jc.d_model, jc.d_ff
    if act == "silu":
        p = {"w_gate": _np(rng, D, Fd), "w_up": _np(rng, D, Fd),
             "w_down": _np(rng, Fd, D)}
    else:
        p = {"w_in": _np(rng, D, Fd), "b_in": _np(rng, Fd),
             "w_out": _np(rng, Fd, D), "b_out": _np(rng, D)}
    x = _np(rng, 2, 3, D)
    want = JL.mlp_apply(jc, {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    got = TL.mlp_apply(tc, TL.MLP(tc, {k: _t(v) for k, v in p.items()}),
                       _t(x))
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# whole model: prefill, then ragged per-step decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    jc, tc = _configs(arch)
    jm, tm = get_model(jc), tget_model(tc)
    params = jax.jit(lambda key: jm.init(key)[0])(jax.random.PRNGKey(0))
    jprefill = jax.jit(jm.prefill)
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jc.vocab, n) for n in (5, 9)]
    B, Smax = 2, 24
    jspec = jm.cache_spec(B, Smax)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jspec)
    tcache = {n: torch.zeros(shape, dtype=dt)
              for n, (shape, dt) in tm.cache_spec(B, Smax).items()}
    assert {n: tuple(s.shape) for n, s in jspec.items()} == \
        {n: tuple(t.shape) for n, t in tcache.items()}
    nxt = []
    for slot, prompt in enumerate(prompts):
        jl, jpc = jprefill(params, {"tokens": jnp.asarray(prompt)[None]})
        tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)[None]})
        _close(tl, jl)
        for name in ("k", "v"):
            _close(tpc[name], jpc[name])
        jcache = jsessions.insert_session(jcache, slot, jpc,
                                          jm.cache_logical_axes())
        tm.insert_session(tcache, slot, tpc)
        nxt.append(int(np.argmax(np.asarray(jl)[0, -1])))
    tok = np.asarray(nxt, np.int32)[:, None]
    pos = np.asarray([len(p) for p in prompts], np.int32)   # ragged
    for _ in range(3):
        jl, jcache = jm.decode_jit(params, jnp.asarray(tok), jnp.asarray(pos),
                                   jcache)
        tl, tcache = tm.decode(tp, torch.from_numpy(tok).long(),
                               torch.from_numpy(pos), tcache)
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])


def test_decode_fused_updates_cache_in_place():
    """The in-place counterpart of the reference's donated cache: the
    cache tensors ``decode_fused`` returns are the ones it was given."""
    tc = tget_config("smollm-135m", reduced=True)
    tm = tget_model(tc)
    gen = torch.Generator().manual_seed(0)
    tp = tm.init(gen, "cpu")
    cache = {n: torch.zeros(shape, dtype=dt)
             for n, (shape, dt) in tm.cache_spec(2, 16).items()}
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    tok = torch.zeros((2, 1), dtype=torch.long)
    pos = torch.tensor([0, 3], dtype=torch.int32)
    toks, nxt, pos2, cache2 = tm.decode_fused(tp, tok, pos, cache, 3)
    assert cache2 is cache
    assert {n: t.data_ptr() for n, t in cache2.items()} == ptrs
    assert tuple(toks.shape) == (2, 3) and toks.dtype == torch.long
    assert torch.equal(nxt[:, 0], toks[:, -1])
    assert pos2.tolist() == [3, 6]
    assert bool(cache["k"][:, 1, 3:6].abs().sum() > 0)   # rows were written
    assert bool(cache["k"][:, 1, 6:].abs().sum() == 0)


def test_init_uses_reference_distributions():
    tc = tget_config("qwen2-0.5b", reduced=True)
    tp = tget_model(tc).init(torch.Generator().manual_seed(1), "cpu")
    a = tp.layers[0].attn
    bound = 1.0 / np.sqrt(tc.d_model)
    assert float(a.wq.abs().max()) <= bound
    assert float(a.bq.abs().max()) == 0.0
    assert float(tp.layers[0].ln1.scale.min()) == 1.0
    assert abs(float(tp.tok.embed.std()) - 0.02) < 0.005
    assert tp.tok.lm_head is None                       # tied embeddings
    assert a.wq.dtype == torch_dtype(tc.compute_dtype)


def test_bf16_session_travels_bit_exact():
    """numpy has no bfloat16: a bf16 cache leaf leaves as uint16 bits, is
    never widened (its byte size is the cache's own), and comes back
    bit-exact into a bf16 cache."""
    tc = tget_config("qwen2-0.5b")                      # bf16 compute
    axes = {"k": (None, "batch", "seq_mp", None, None)}
    src = {"k": torch.randn(2, 3, 10, 2, 4).to(torch.bfloat16)}
    sess = tsessions.extract_session(src, 1, 6, axes, {"k": 2})
    assert sess["k"].dtype == np.uint16 and sess["k"].shape == (2, 1, 6, 2, 4)
    assert tsessions.session_nbytes(sess) == 2 * 6 * 2 * 4 * 2
    dst = {"k": torch.full((2, 3, 10, 2, 4), 5.0, dtype=torch.bfloat16)}
    tsessions.insert_session(dst, 2, sess, axes)
    assert torch.equal(dst["k"][:, 2, :6].view(torch.int16),
                       src["k"][:, 1, :6].view(torch.int16))
    assert bool((dst["k"][:, 2, 6:] == 0).all())         # zero past the pos
    assert bool((dst["k"][:, :2] == 5.0).all())          # other slots intact
    assert torch_dtype(tc.compute_dtype) == torch.bfloat16


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-130m",
                                  "jamba-v0.1-52b"])
def test_non_dense_forward_matches_jax(arch):
    """The MoE, SSM and hybrid families' full-sequence ``forward`` (the
    training compute) gives the JAX package's logits, with the reference's
    weights carried over."""
    jc, tc = _configs(arch)
    jm, tm = get_model(jc), tget_model(tc)
    params = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, params), "cpu")
    tokens = np.random.default_rng(5).integers(0, jc.vocab, (2, 12))
    want = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape
    _close(got, want)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
