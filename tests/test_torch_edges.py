"""The port at the edges of the cache and across packages in bfloat16, held
against the JAX package on the CPU with the same weights (carried over by
``params_from_numpy``) and the same prompts:

* a prompt that fills the cache (its first decode runs at ``pos ==
  max_seq``, whose K/V write the reference's scatter drops): the fused
  path at chunk 1 and 4 and the legacy path, with a prompt one token
  shorter as the control;
* chunked prefill of a prompt as long as or longer than the cache (rows
  at or past ``max_seq`` are dropped, not wrapped onto the first rows),
  also in one chunk longer than the cache;
* a bfloat16 session the JAX engine exports (``ml_dtypes`` leaves) and
  the port imports;

and, under those, ``attention_decode_inplace`` and
``attention_prefill_chunk_inplace`` against the reference's layers, with
the rows they must not write compared bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import get_model
from repro.models import layers as jl
from repro.serve import Request, ServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.models import get_model as tget_model
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.sessions import _to_device
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

# qwen2.5-3b: QKV bias, tied; starcoder2-15b: LayerNorm, GELU, bias, untied
ARCHS = ("qwen2-0.5b", "smollm-135m", "qwen2.5-3b", "starcoder2-15b")
MAX_SEQ = 32
N_PROMPTS = 12                   # prompts from default_rng(100 + s)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """Per (arch, compute dtype): the reference (model, params) and the
    port's, same weights; built once per module."""
    cache = {}

    def get(arch, dtype=None):
        key = (arch, dtype)
        if key not in cache:
            jc = get_config(arch, reduced=True)
            tc = tget_config(arch, reduced=True)
            if dtype is not None:
                jc = dataclasses.replace(jc, compute_dtype=dtype)
                tc = dataclasses.replace(tc, compute_dtype=dtype)
            jm = get_model(jc)
            params = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
            tp = params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                   "cpu")
            cache[key] = (jm, params, tget_model(tc), tp)
        return cache[key]
    return get


def _prompts(vocab, length, n=N_PROMPTS):
    return [np.random.default_rng(100 + s).integers(0, vocab, length)
            for s in range(n)]


def _run(engine_cls, req_cls, model, params, prompts, max_new, **kw):
    engine = engine_cls(model, params, max_batch=2, max_seq=MAX_SEQ, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained(max_steps=500)
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs], engine


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fused,chunk", [(True, 1), (True, 4), (False, 1)])
@pytest.mark.parametrize("plen", [MAX_SEQ, MAX_SEQ - 1])
def test_prompt_filling_the_cache_matches_jax(pair, arch, fused, chunk,
                                             plen):
    """A prompt of ``max_seq`` tokens: its first decode runs at ``pos ==
    max_seq`` and keeps its token, and its K/V write must not land on the
    prompt's last row.  ``max_seq - 1`` tokens is the control."""
    jm, params, tm, tp = pair(arch)
    prompts = _prompts(tm.cfg.vocab, plen)
    want, jeng = _run(ServeEngine, Request, jm, params, prompts, 4,
                      fused=fused, decode_chunk=chunk)
    got, teng = _run(TServeEngine, TRequest, tm, tp, prompts, 4,
                     fused=fused, decode_chunk=chunk)
    assert got == want, (arch, fused, chunk, plen, got, want)
    assert teng.scheduler.ptt.updates == jeng.scheduler.ptt.updates


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("plen", [MAX_SEQ, MAX_SEQ + 1, MAX_SEQ + 8])
def test_chunked_prefill_past_the_cache_matches_jax(pair, arch, plen):
    """Chunks of 8 over a prompt as long as the cache or longer: rows at or
    past ``max_seq`` are dropped, so the prompt's first rows stay."""
    jm, params, tm, tp = pair(arch)
    prompts = _prompts(tm.cfg.vocab, plen, n=4)
    want, jeng = _run(ServeEngine, Request, jm, params, prompts, 4,
                      prefill_chunk_tokens=8, decode_chunk=2)
    got, teng = _run(TServeEngine, TRequest, tm, tp, prompts, 4,
                     prefill_chunk_tokens=8, decode_chunk=2)
    assert got == want, (arch, plen, got, want)
    assert teng.scheduler.ptt.updates == jeng.scheduler.ptt.updates


@pytest.mark.parametrize("chunk", [48, 64])
def test_chunk_longer_than_the_cache_matches_jax(pair, chunk):
    """A chunk longer than ``max_seq`` (40-token prompts, chunks of 48 and
    64): the reference prefills each prompt in one chunk and drops the
    rows past the cache; the port must too, so that the PTT learns the
    same samples (three prefills and three decode chunks: 6 updates, not
    the 9 of a prompt split at the cache)."""
    jm, params, tm, tp = pair("qwen2-0.5b")
    prompts = _prompts(tm.cfg.vocab, 40, n=3)
    want, jeng = _run(ServeEngine, Request, jm, params, prompts, 4,
                      prefill_chunk_tokens=chunk)
    got, teng = _run(TServeEngine, TRequest, tm, tp, prompts, 4,
                     prefill_chunk_tokens=chunk)
    assert got == want, (chunk, got, want)
    assert teng.scheduler.ptt.updates == jeng.scheduler.ptt.updates == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_session_from_jax_resumes_on_the_port(pair, arch):
    """``compute_dtype="bfloat16"``: the JAX engine exports a session after
    one step at ``decode_chunk=2`` (its cache leaves ``ml_dtypes``
    bfloat16); the port imports it, and the stream continues as the
    unmigrated JAX stream does."""
    jm, params, tm, tp = pair(arch, "bfloat16")
    prompt = _prompts(tm.cfg.vocab, 6, n=1)[0]
    want, _ = _run(ServeEngine, Request, jm, params, [prompt], 8,
                   decode_chunk=2)
    req = Request(rid=0, prompt=prompt.copy(), max_new=8)
    a = ServeEngine(jm, params, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    a.submit(req)
    a.step()                           # prefill token + one chunk of 2
    assert not req.done
    sess = a.export_session(req.rid)
    assert {v.dtype for v in sess.cache.values()} == {
        np.dtype(ml_dtypes.bfloat16)}
    b = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    b.import_session(sess)
    b.run_until_drained(max_steps=100)
    assert req.done and list(req.out_tokens) == want[0]
    assert b.stats()["sessions_imported"] == 1


def test_bf16_leaf_from_either_package_lands_bit_exact():
    """A bfloat16 leaf as ``ml_dtypes`` bfloat16 (the JAX package's) or as
    ``uint16`` bits (the port's own export) becomes the same tensor."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    like = torch.zeros((), dtype=torch.bfloat16)
    want = torch.from_numpy(x).to(torch.bfloat16)
    from_jax = _to_device(x.astype(ml_dtypes.bfloat16), like)
    from_port = _to_device(x.astype(ml_dtypes.bfloat16).view(np.uint16), like)
    assert from_jax.dtype == from_port.dtype == torch.bfloat16
    assert torch.equal(from_jax.view(torch.int16), want.view(torch.int16))
    assert torch.equal(from_port.view(torch.int16), want.view(torch.int16))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _attn(arch, rng):
    """The reference's attention parameters of one layer (numpy) and the
    port's module over the same values."""
    jc = get_config(arch, reduced=True)
    tc = tget_config(arch, reduced=True)
    D, hd, Hq, Hkv = jc.d_model, jc.hd, jc.n_heads, jc.n_kv_heads
    p = {"wq": rng.standard_normal((D, Hq * hd)) / np.sqrt(D),
         "wk": rng.standard_normal((D, Hkv * hd)) / np.sqrt(D),
         "wv": rng.standard_normal((D, Hkv * hd)) / np.sqrt(D),
         "wo": rng.standard_normal((Hq * hd, D)) / np.sqrt(Hq * hd)}
    if jc.qkv_bias:
        for name, n in (("bq", Hq), ("bk", Hkv), ("bv", Hkv)):
            p[name] = rng.standard_normal(n * hd) * 0.1
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return jc, tc, p, tl.Attention(tc, {k: torch.from_numpy(v)
                                        for k, v in p.items()})


def _caches(cfg, rng, L, B, Smax):
    shape = (L, B, Smax, cfg.n_kv_heads, cfg.hd)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _check_caches(got, want, old, written):
    """Rows written hold the reference's K/V (the two projections round
    alike to 1e-5); every other row is its old value, bit for bit, in both
    packages."""
    for g, w, o in zip(got, want, old):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(w[~written], o[~written])
        np.testing.assert_array_equal(g[~written], o[~written])
        np.testing.assert_allclose(g[written], w[written], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pos", [[MAX_SEQ, 5], [MAX_SEQ - 1, MAX_SEQ + 3],
                                 [MAX_SEQ + 7, MAX_SEQ]])
def test_decode_write_at_or_past_the_cache_matches_jax(arch, pos):
    """A slot at ``pos >= Smax`` writes nothing (the reference's dropped
    scatter); every other slot writes its row; the output and both caches
    equal the reference's."""
    rng = np.random.default_rng(1)
    jc, tc, p, tp = _attn(arch, rng)
    B, L, layer = len(pos), 2, 1
    x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    k0, v0 = _caches(jc, rng, L, B, MAX_SEQ)
    pos = np.array(pos, np.int32)
    jout, jk, jv = jl.attention_decode_inplace(
        jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(k0), jnp.asarray(v0), layer, jnp.asarray(pos))
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tout = tl.attention_decode_inplace(tc, tp, torch.from_numpy(x), tk, tv,
                                       layer, torch.from_numpy(pos))
    written = np.zeros((L, B, MAX_SEQ), bool)
    for b in range(B):
        if pos[b] < MAX_SEQ:
            written[layer, b, pos[b]] = True
    _check_caches((tk, tv), (jk, jv), (k0, v0), written)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("starts,qlens,T", [
    ([MAX_SEQ - 5, 0], [8, 8], 8),           # crosses the cache's end
    ([MAX_SEQ, 24], [8, 8], 8),              # starts at the cache's end
    ([MAX_SEQ + 8, MAX_SEQ - 3], [5, 8], 8),  # past it; crossing, ragged
    ([16, 40], [MAX_SEQ, 3], MAX_SEQ)])      # a chunk as long as the cache
def test_prefill_chunk_rows_past_the_cache_match_jax(arch, starts, qlens, T):
    """Rows at or past ``Smax`` are dropped, not wrapped onto the cache's
    first rows; queries past the cache still attend to all of it.  The
    output and both caches equal the reference's."""
    rng = np.random.default_rng(2)
    jc, tc, p, tp = _attn(arch, rng)
    B, L, layer = len(starts), 2, 0
    x = rng.standard_normal((B, T, jc.d_model)).astype(np.float32)
    k0, v0 = _caches(jc, rng, L, B, MAX_SEQ)
    start = np.array(starts, np.int32)
    qlen = np.array(qlens, np.int32)
    positions = (start[:, None] + np.arange(T, dtype=np.int32)[None, :])
    jout, jk, jv = jl.attention_prefill_chunk_inplace(
        jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(k0), jnp.asarray(v0), layer, jnp.asarray(start),
        jnp.asarray(qlen), jnp.asarray(positions))
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tout = tl.attention_prefill_chunk_inplace(
        tc, tp, torch.from_numpy(x), tk, tv, layer, torch.from_numpy(start),
        torch.from_numpy(qlen), torch.from_numpy(positions))
    written = np.zeros((L, B, MAX_SEQ), bool)
    for b in range(B):
        written[layer, b, start[b]:min(start[b] + qlen[b], MAX_SEQ)] = True
    _check_caches((tk, tv), (jk, jv), (k0, v0), written)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
