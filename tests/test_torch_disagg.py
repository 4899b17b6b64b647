"""Chunked prefill and the prefill-role handoff of the port
(``repro_torch``) on the CPU, held against the JAX package with the same
inputs and weights (carried over by ``params_from_numpy``):

* the ``ragged_prefill`` plain version against the jnp oracle and the
  Pallas kernel in interpret mode, live / partial / empty slots (1e-5);
* ``attention_prefill_chunk_inplace`` against the JAX function: outputs
  within 1e-5, the cache equal on live rows and byte-identical elsewhere,
  padded rows running past ``Smax`` included;
* ``Model.prefill_chunk`` against JAX's, chunk by chunk (logits 1e-4,
  caches 1e-5), and against the port's whole-prompt prefill;
* the chunked ``ServeEngine``: streams identical to the JAX chunked and
  whole-prompt engines, as many PTT samples; mid-prefill export / import;
  a ``role="prefill"`` engine handing sessions to a ``role="decode"`` one;
  draining and crashing with prefills in flight.

Float32 on both sides; the tolerances cover summation order only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.ragged_prefill import force_pallas
from repro.kernels.ragged_prefill import ragged_prefill_attention as jax_rp
from repro.kernels.ragged_prefill.ref import ragged_prefill_ref as jax_rp_ref
from repro.models import get_model
from repro.models import layers as JL
from repro.serve import Request, ServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.models import get_model as tget_model
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_numpy
from repro_torch.kernels.ragged_prefill import ops as rp
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import Session as TSession

# qwen2.5-3b: QKV bias, tied; starcoder2-15b: LayerNorm, GELU, bias, untied
ARCHS = ("qwen2-0.5b", "smollm-135m", "qwen2.5-3b", "starcoder2-15b")
MAX_SEQ = 32
MAX_NEW = 6
PLEN = 11                    # prompt tokens: chunks of 4 + 4 + 3
CHUNK = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and the suite's other
    workers keep their cores (their latency-driven tests read wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """Per arch: the reference (model, params) and the port's, same
    weights; built once per module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jm = get_model(get_config(arch, reduced=True))
            params = jax.jit(lambda key: jm.init(key)[0])(
                jax.random.PRNGKey(0))
            tc = tget_config(arch, reduced=True)
            tp = params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                   "cpu")
            cache[arch] = (jm, params, tget_model(tc), tp)
        return cache[arch]
    return get


def _prompts(vocab, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, PLEN) for _ in range(n)]


def _run(engine_cls, req_cls, model, params, prompts, **kw):
    engine = engine_cls(model, params, max_batch=2, max_seq=MAX_SEQ, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained(max_steps=300)
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs], engine


@pytest.fixture(scope="module")
def jax_streams(pair):
    """The reference engine's streams (and engine) per (arch,
    prefill_chunk_tokens, decode_chunk) for :func:`_prompts`, run once."""
    cache = {}

    def get(arch, chunk_tokens, decode_chunk):
        key = (arch, chunk_tokens, decode_chunk)
        if key not in cache:
            jm, params, tm, _ = pair(arch)
            cache[key] = _run(ServeEngine, Request, jm, params,
                              _prompts(tm.cfg.vocab),
                              prefill_chunk_tokens=chunk_tokens,
                              decode_chunk=decode_chunk)
        return cache[key]
    return get


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# 1. the kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Smax,T,Hq,Hkv,hd,bk", [
    (3, 32, 8, 8, 2, 16, 8),     # GQA, block-divisible cache
    (2, 19, 5, 6, 6, 8, 8),      # MHA, cache not a bk multiple
    (4, 24, 4, 4, 1, 8, 16),     # MQA
    (3, 40, 6, 14, 2, 8, 8),     # rep 7, qwen2-0.5b's grouping
])
def test_ragged_prefill_plain_matches_jax(B, Smax, T, Hq, Hkv, hd, bk):
    rng = np.random.default_rng(11)
    q, k, v = _np(rng, B, T, Hq, hd), _np(rng, B, Smax, Hkv, hd), \
        _np(rng, B, Smax, Hkv, hd)
    start = rng.integers(0, Smax - T, B).astype(np.int32)
    # live, partial and fully padded (qlen = 0) slots
    qlen = np.asarray(([T, max(T - 2, 1), 0, T] * B)[:B], np.int32)
    jargs = tuple(map(jnp.asarray, (q, k, v, start, qlen)))
    want_ref = np.asarray(jax_rp_ref(*jargs))
    with force_pallas():                  # Pallas kernel, interpret mode
        want_pallas = np.asarray(jax_rp(*jargs, block_k=bk))
    n0 = rp.launches
    got = rp.ragged_prefill_attention(*map(torch.from_numpy,
                                           (q, k, v, start, qlen)))
    assert rp.launches == n0              # CPU tensors: plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, Hq, hd)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=1e-5, rtol=0)
    for b in range(B):
        assert not got[b, int(qlen[b]):].any()    # exact zeros


# ---------------------------------------------------------------------------
# 2. one layer's chunk attention, cache written in place
# ---------------------------------------------------------------------------

def _attn_params(cfg, rng):
    """At the model's scale (1/sqrt(in)), so activations stay O(1)."""
    D, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": _np(rng, D, Hq * hd) / np.sqrt(D),
         "wk": _np(rng, D, Hkv * hd) / np.sqrt(D),
         "wv": _np(rng, D, Hkv * hd) / np.sqrt(D),
         "wo": _np(rng, Hq * hd, D) / np.sqrt(Hq * hd)}
    if cfg.qkv_bias:
        p.update(bq=_np(rng, Hq * hd), bk=_np(rng, Hkv * hd),
                 bv=_np(rng, Hkv * hd))
    return p


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_prefill_chunk_inplace_matches_jax(arch):
    jc = get_config(arch, reduced=True)
    tc = tget_config(arch, reduced=True)
    rng = np.random.default_rng(3)
    L, B, Smax, T = 2, 3, 12, 5
    p = _attn_params(jc, rng)
    x = _np(rng, B, T, jc.d_model)
    kfull = _np(rng, L, B, Smax, jc.n_kv_heads, jc.hd)   # earlier contents
    vfull = _np(rng, L, B, Smax, jc.n_kv_heads, jc.hd)
    # a full chunk, a ragged one whose padded rows run past Smax (9 + 5 >
    # 12), and an empty slot
    start = np.asarray([3, 9, 6], np.int32)
    qlen = np.asarray([5, 2, 0], np.int32)
    positions = start[:, None] + np.arange(T, dtype=np.int32)[None]
    want, jk, jv = JL.attention_prefill_chunk_inplace(
        jc, {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        jnp.asarray(kfull), jnp.asarray(vfull), 1, jnp.asarray(start),
        jnp.asarray(qlen), jnp.asarray(positions))
    tk, tv = torch.from_numpy(kfull.copy()), torch.from_numpy(vfull.copy())
    got = TL.attention_prefill_chunk_inplace(
        tc, TL.Attention(tc, {n: torch.from_numpy(a) for n, a in p.items()}),
        torch.from_numpy(x), tk, tv, 1, torch.from_numpy(start),
        torch.from_numpy(qlen), torch.from_numpy(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    live = np.zeros((L, B, Smax), bool)
    for b in range(B):
        live[1, b, start[b]:start[b] + qlen[b]] = True
    for got_c, want_c, old in ((tk, jk, kfull), (tv, jv, vfull)):
        got_c = got_c.numpy()
        np.testing.assert_allclose(got_c[live], np.asarray(want_c)[live],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(got_c[~live], old[~live])


def test_attention_prefill_chunk_refuses_chunk_longer_than_cache():
    """A chunk longer than the cache is no longer refused (the name is
    kept from when it was): as in the reference, rows at or past ``Smax``
    are dropped, the rows below it are written, and every query attends.
    Outputs within 1e-5 of the JAX function; the cache equal on the live
    rows and bit-identical on every row it must not write."""
    jc = get_config("smollm-135m", reduced=True)
    tc = tget_config("smollm-135m", reduced=True)
    rng = np.random.default_rng(4)
    L, B, Smax, T = 2, 3, 4, 6
    p = _attn_params(jc, rng)
    x = _np(rng, B, T, jc.d_model)
    kfull = _np(rng, L, B, Smax, jc.n_kv_heads, jc.hd)
    vfull = _np(rng, L, B, Smax, jc.n_kv_heads, jc.hd)
    # the whole chunk from 0, a ragged one from 1, and one starting past
    # the cache
    start = np.asarray([0, 1, 5], np.int32)
    qlen = np.asarray([6, 4, 2], np.int32)
    positions = start[:, None] + np.arange(T, dtype=np.int32)[None]
    want, jk, jv = JL.attention_prefill_chunk_inplace(
        jc, {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        jnp.asarray(kfull), jnp.asarray(vfull), 1, jnp.asarray(start),
        jnp.asarray(qlen), jnp.asarray(positions))
    tk, tv = torch.from_numpy(kfull.copy()), torch.from_numpy(vfull.copy())
    got = TL.attention_prefill_chunk_inplace(
        tc, TL.Attention(tc, {n: torch.from_numpy(a) for n, a in p.items()}),
        torch.from_numpy(x), tk, tv, 1, torch.from_numpy(start),
        torch.from_numpy(qlen), torch.from_numpy(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    live = np.zeros((L, B, Smax), bool)
    for b in range(B):
        live[1, b, start[b]:min(start[b] + qlen[b], Smax)] = True
    assert live.sum() == 4 + 3
    for got_c, want_c, old in ((tk, jk, kfull), (tv, jv, vfull)):
        got_c = got_c.numpy()
        np.testing.assert_allclose(got_c[live], np.asarray(want_c)[live],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(got_c[~live], old[~live])
        np.testing.assert_array_equal(np.asarray(want_c)[~live], old[~live])


# ---------------------------------------------------------------------------
# 3. Model.prefill_chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_chunk_matches_jax(pair, arch):
    jm, params, tm, tp = pair(arch)
    prompt = _prompts(tm.cfg.vocab)[0]
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_spec(1, MAX_SEQ))
    tcache = {n: torch.zeros(shape, dtype=dt)
              for n, (shape, dt) in tm.cache_spec(1, MAX_SEQ).items()}
    ptrs = {n: t.data_ptr() for n, t in tcache.items()}
    for s in range(0, PLEN, CHUNK):
        qlen = min(CHUNK, PLEN - s)
        chunk = np.zeros((1, CHUNK), np.int32)
        chunk[0, :qlen] = prompt[s:s + qlen]
        jl, jcache = jm.prefill_chunk(
            params, jnp.asarray(chunk), jcache, jnp.asarray([s], jnp.int32),
            jnp.asarray([qlen], jnp.int32))
        tl, tcache = tm.prefill_chunk(
            tp, torch.from_numpy(chunk).long(), tcache,
            torch.tensor([s], dtype=torch.int32),
            torch.tensor([qlen], dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        for n in ("k", "v"):
            np.testing.assert_allclose(tcache[n].numpy(),
                                       np.asarray(jcache[n]), atol=1e-5,
                                       rtol=1e-5)
    assert {n: t.data_ptr() for n, t in tcache.items()} == ptrs  # in place
    whole, _ = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)[None]})
    np.testing.assert_allclose(tl.numpy(), whole.numpy(), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# 4-7. the chunked engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("decode_chunk", (1, 4))
def test_chunked_engine_token_identity_with_jax(pair, jax_streams, arch,
                                                decode_chunk):
    _, _, tm, tp = pair(arch)
    want, jeng = jax_streams(arch, CHUNK, decode_chunk)
    whole, _ = jax_streams(arch, 0, decode_chunk)
    got, teng = _run(TServeEngine, TRequest, tm, tp, _prompts(tm.cfg.vocab),
                     prefill_chunk_tokens=CHUNK, decode_chunk=decode_chunk)
    assert got == want == whole, (arch, decode_chunk, got, want, whole)
    assert all(len(t) == MAX_NEW for t in got)
    assert teng.scheduler.ptt.updates == jeng.scheduler.ptt.updates
    assert teng.stats()["requests_served"] == 3
    assert teng.stats()["prefilling"] == 0 and teng.pending() == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_mid_prefill_export_import_token_identity(pair, jax_streams, arch):
    """A session exported after two of three chunks resumes its last
    chunk on a second engine and emits the reference's monolithic
    stream."""
    _, _, tm, tp = pair(arch)
    want = jax_streams(arch, 0, 1)[0][0]
    req = TRequest(rid=0, prompt=_prompts(tm.cfg.vocab)[0].copy(),
                   max_new=MAX_NEW)
    a = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                     prefill_chunk_tokens=CHUNK)
    a.submit(req)
    a.step()                             # 4 of 11 prompt tokens
    a.step()                             # 8 of 11
    assert a.active_count() == 0 and not req.out_tokens
    sess = a.export_prefill(req.rid)
    assert isinstance(sess, TSession) and sess.prefilled == 8
    assert all(isinstance(x, np.ndarray) and x.shape[2] == 8
               for x in sess.cache.values())
    assert a.pending() == 0 and a.stats()["sessions_exported"] == 1
    with pytest.raises(KeyError):
        a.export_prefill(req.rid)
    whole = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="chunked-prefill engine"):
        whole.import_session(sess)
    b = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                     prefill_chunk_tokens=CHUNK)
    b.import_session(sess)
    assert b.stats()["prefilling"] == 1
    b.run_until_drained(max_steps=100)
    assert req.done and list(req.out_tokens) == want
    assert b.stats()["sessions_imported"] == 1


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunk_tokens", (CHUNK, 0))
def test_prefill_role_handoff_token_identity(pair, jax_streams, arch,
                                             chunk_tokens):
    """A ``role="prefill"`` engine hands every finished prefill to a
    ``role="decode"`` engine through ``on_prefill_complete``: the streams
    are the reference's monolithic ones, the prefill engine never takes a
    slot or decodes, and each chunk reports to ``on_prefill_latency``."""
    _, _, tm, tp = pair(arch)
    want, _ = jax_streams(arch, 0, 1)
    pre = TServeEngine(tm, tp, max_batch=1, max_seq=MAX_SEQ, role="prefill",
                       prefill_chunk_tokens=chunk_tokens)
    dec = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, role="decode")
    chunk_lat, step_lat, shipped = [], [], []
    pre.on_prefill_latency = chunk_lat.append
    pre.on_step_latency = step_lat.append
    pre.on_prefill_complete = lambda s: (shipped.append(s),
                                         dec.import_session(s))
    reqs = [TRequest(rid=i, prompt=p.copy(), max_new=MAX_NEW)
            for i, p in enumerate(_prompts(tm.cfg.vocab))]
    for r in reqs:
        pre.submit(r)
    for _ in range(100):
        pre.step()
        dec.step()
        assert pre.active_count() == 0
        if all(r.done for r in reqs):
            break
    assert [list(r.out_tokens) for r in reqs] == want
    assert [s.pos for s in shipped] == [PLEN] * 3
    assert step_lat == []
    n_chunks = 3 * -(-PLEN // chunk_tokens) if chunk_tokens else 0
    assert len(chunk_lat) == n_chunks
    assert pre.last_prefill_chunk_latency == (chunk_lat[-1] if chunk_lat
                                              else 0.0)
    assert pre.stats()["sessions_exported"] == 3
    assert pre.stats()["role"] == "prefill" and dec.stats()["role"] == "decode"


def _engine_with_prefills_in_flight(tm, tp):
    """A one-slot chunked engine stepped until request 0 decodes, request
    1 has finished its prefill and waits for the slot, and request 2 is
    one chunk in."""
    eng = TServeEngine(tm, tp, max_batch=1, max_seq=MAX_SEQ,
                       prefill_chunk_tokens=CHUNK)
    reqs = [TRequest(rid=i, prompt=p.copy(), max_new=MAX_NEW)
            for i, p in enumerate(_prompts(tm.cfg.vocab))]
    for r in reqs:
        eng.submit(r)
    for _ in range(7):
        eng.step()
    assert eng.active_pos(0) == PLEN + 4 and eng.active_pos(1) is None
    assert eng.stats()["prefilling"] == 2 and eng.pending() == 2
    return eng, reqs


@pytest.mark.parametrize("how", ("drain", "crash"))
def test_drain_and_crash_with_prefills_in_flight(pair, jax_streams, how):
    _, _, tm, tp = pair("smollm-135m")
    want, _ = jax_streams("smollm-135m", 0, 1)
    eng, reqs = _engine_with_prefills_in_flight(tm, tp)
    if how == "crash":
        eng.crash()
        assert eng.stats()["prefilling"] == 0 and eng.pending() == 0
        assert eng.drain_queue() == [] and eng.drain_sessions() == []
        assert eng.step() == 0
        return
    assert eng.drain_queue() == [reqs[2]]           # one chunk in: restarts
    sessions = eng.drain_sessions()
    assert eng.stats()["prefilling"] == 0 and eng.pending() == 0
    assert [s.req for s in sessions] == [reqs[1]]
    sess = sessions[0]
    assert sess.prefilled is None and sess.pos == PLEN
    assert sess.cur_token == reqs[1].out_tokens[0]
    assert all(isinstance(x, np.ndarray) and x.shape[2] == PLEN
               for x in sess.cache.values())
    other = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ)
    other.import_session(sess)
    other.submit(reqs[2])
    other.run_until_drained(max_steps=100)
    eng.run_until_drained(max_steps=100)
    assert [list(r.out_tokens) for r in reqs] == want
