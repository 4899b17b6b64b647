"""The port's hybrid family (``repro_torch.models.jamba``) on the CPU, held
against the JAX package's ``repro.models.jamba`` with the same inputs and
weights (carried over by ``params_from_numpy``), on ``jamba-v0.1-52b``
reduced with ``n_layers = 8`` (one superblock) and ``n_layers = 16`` (two,
so a swapped ``(nb, i)`` index of the stacked layers or caches shows):

* ``prefill`` / ``decode`` logits and all six cache leaves, the decode
  cache written in place;
* the ``ServeEngine``: greedy tokens identical to the JAX engine's, fused
  at chunk 1 and 4, legacy, and with ``prefill_chunk_tokens > 0`` (which
  prefills whole); prompts filling the cache at ``max_seq=32``, which
  holds the cache's edge on the rope-free decode path (31 tokens the
  control); the prefill-role handoff; ``drain`` and ``crash``; sessions
  migrated in process and over the wire both ways between the packages,
  in float32 and bfloat16;
* checkpoint shards and manifest byte-identical to the JAX package's, a
  port checkpoint loading into the JAX model, and ``params_to_numpy``
  inverting ``params_from_numpy``;
* the MoE family's layout check (``moe._check_layout``, which refuses
  every family but ``"moe"``) on none of the hybrid's entry points.

Float32 on both sides unless a test says bfloat16; tokens are exact, the
tolerances cover summation order only.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config
from repro.models import get_model
from repro.models import sessions as jsessions
from repro.serve import Request, ServeEngine
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_config as tget_config
from repro_torch.models import get_model as tget_model
from repro_torch.models import moe as TMoE
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

ARCH = "jamba-v0.1-52b"
MAX_SEQ = 32
LEAVES = ("k", "v", "ssm_moe", "conv_moe", "ssm_dense", "conv_dense")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(n_layers=8, dtype=None):
    jc = dataclasses.replace(get_config(ARCH, reduced=True),
                             n_layers=n_layers)
    tc = dataclasses.replace(tget_config(ARCH, reduced=True),
                             n_layers=n_layers)
    if dtype is not None:
        jc = dataclasses.replace(jc, compute_dtype=dtype)
        tc = dataclasses.replace(tc, compute_dtype=dtype)
    return jc, tc


@pytest.fixture(scope="module")
def pair():
    """Per (n_layers, compute dtype): the reference (model, params) and
    the port's, same weights; built once per module."""
    cache = {}

    def get(n_layers=8, dtype=None):
        key = (n_layers, dtype)
        if key not in cache:
            jc, tc = _configs(n_layers, dtype)
            jm = get_model(jc)
            params = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
            tp = params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                   "cpu")
            cache[key] = (jm, params, tget_model(tc), tp)
        return cache[key]
    return get


def _close(t, j, tol=1e-4):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [8, 16])
def test_prefill_and_decode_logits_match_jax(pair, n_layers):
    jm, params, tm, tp = pair(n_layers)
    assert len(tp.blocks) == n_layers // 8
    assert tm.prefill_chunk is None            # the hybrid prefills whole
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tm.cfg.vocab, n) for n in (5, 19)]
    B = 2
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_spec(B, MAX_SEQ))
    tcache = {n: torch.zeros(shape, dtype=dt)
              for n, (shape, dt) in tm.cache_spec(B, MAX_SEQ).items()}
    assert {n: tuple(t.shape) for n, t in tcache.items()} == {
        n: s.shape for n, s in jcache.items()}
    nxt = []
    for slot, prompt in enumerate(prompts):
        jl, jpc = jax.jit(jm.prefill)(params,
                                      {"tokens": jnp.asarray(prompt)[None]})
        tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)[None]})
        _close(tl, jl)
        for name in LEAVES:
            assert tpc[name].shape == jpc[name].shape, name
            _close(tpc[name], jpc[name], 1e-5)
        jcache = jsessions.insert_session(jcache, slot, jpc,
                                          jm.cache_logical_axes())
        tm.insert_session(tcache, slot, tpc)
        nxt.append(int(np.argmax(np.asarray(jl)[0, -1])))
    ptrs = {n: t.data_ptr() for n, t in tcache.items()}
    tok = np.asarray(nxt, np.int32)[:, None]
    pos = np.asarray([len(p) for p in prompts], np.int32)     # ragged
    for _ in range(3):
        jl, jcache = jm.decode_jit(params, jnp.asarray(tok), jnp.asarray(pos),
                                   jcache)
        tl, tcache2 = tm.decode(tp, torch.from_numpy(tok).long(),
                                torch.from_numpy(pos), tcache)
        assert tcache2 is tcache
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1
    assert {n: t.data_ptr() for n, t in tcache.items()} == ptrs
    for name in LEAVES:
        _close(tcache[name], jcache[name], 1e-5)


def test_moe_layout_check_is_not_on_the_hybrid_path(pair, monkeypatch):
    """The reduced hybrid config has ``moe_every = 2``, its own superblock's
    and not the MoE family's alternating layout, and its family is not
    ``"moe"``, which the MoE family's check refuses: with the check made
    to fail, init, cache_spec, prefill, decode and both conversions still
    run."""
    _, params, tm, _ = pair()
    assert tm.cfg.moe_every == 2

    def refuse(cfg):
        raise AssertionError("moe._check_layout is on the hybrid path")
    monkeypatch.setattr(TMoE, "_check_layout", refuse)
    tp = tm.init(torch.Generator().manual_seed(1), "cpu")
    cache = {n: torch.zeros(shape, dtype=dt)
             for n, (shape, dt) in tm.cache_spec(1, MAX_SEQ).items()}
    _, pc = tm.prefill(tp, {"tokens": torch.arange(5)[None]})
    tm.insert_session(cache, 0, pc)
    tm.decode(tp, torch.tensor([[3]]), torch.tensor([5]), cache)
    tree = params_to_numpy(tm.cfg, tp)
    params_from_numpy(tm.cfg, tree, "cpu")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _prompts(vocab, length, n, seed=0):
    return [np.random.default_rng(seed + s).integers(0, vocab, length)
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


@pytest.mark.parametrize("n_layers,fused,chunk,kw", [
    (8, True, 1, {}), (8, True, 4, {}), (8, False, 1, {}),
    (8, True, 2, {"prefill_chunk_tokens": 4}),   # prefills whole anyway
    (16, True, 4, {})])
def test_engine_token_identity_with_jax(pair, n_layers, fused, chunk, kw):
    jm, params, tm, tp = pair(n_layers)
    prompts = _prompts(tm.cfg.vocab, 6, 3)          # 3 requests, 2 slots
    want, jeng = _run(ServeEngine, Request, jm, params, prompts, 6,
                      fused=fused, decode_chunk=chunk, **kw)
    got, teng = _run(TServeEngine, TRequest, tm, tp, prompts, 6,
                     fused=fused, decode_chunk=chunk, **kw)
    assert got == want, (n_layers, fused, chunk, got, want)
    assert all(len(t) == 6 for t in got)
    assert teng.scheduler.ptt.updates == jeng.scheduler.ptt.updates
    assert not teng._chunking()


@pytest.mark.parametrize("plen,fused,chunk", [
    (MAX_SEQ, True, 1), (MAX_SEQ, True, 4), (MAX_SEQ, False, 1),
    (MAX_SEQ - 1, True, 4)])
def test_prompt_filling_the_cache_matches_jax(pair, plen, fused, chunk):
    """The cache's edge on the rope-free decode path: a prompt of
    ``max_seq`` tokens decodes its first token at ``pos == max_seq``,
    whose K/V write the reference drops; ``max_seq - 1`` is the
    control."""
    jm, params, tm, tp = pair()
    prompts = _prompts(tm.cfg.vocab, plen, 3, seed=100)
    want, _ = _run(ServeEngine, Request, jm, params, prompts, 4,
                   fused=fused, decode_chunk=chunk)
    got, _ = _run(TServeEngine, TRequest, tm, tp, prompts, 4,
                  fused=fused, decode_chunk=chunk)
    assert got == want, (fused, chunk, plen, got, want)


def test_prefill_role_hands_off_to_a_decode_engine(pair):
    jm, params, tm, tp = pair()
    prompts = _prompts(tm.cfg.vocab, 6, 3, seed=11)
    want, _ = _run(ServeEngine, Request, jm, params, prompts, 6,
                   decode_chunk=2)
    pre = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, role="prefill")
    dec = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2,
                       role="decode")
    pre.on_prefill_complete = dec.import_session
    reqs = [TRequest(rid=i, prompt=p.copy(), max_new=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        pre.submit(r)
    pre.run_until_drained(max_steps=50)
    assert pre.active_count() == 0 and len(dec.sessions_in) == 3
    # the K/V leaves trimmed to the prompt, the state leaves whole
    sess = dec.sessions_in[0]
    assert sess.cache["k"].shape[2] == 6
    assert sess.cache["ssm_moe"].shape == tm.cache_spec(1, MAX_SEQ)[
        "ssm_moe"][0]
    dec.run_until_drained(max_steps=100)
    assert [list(r.out_tokens) for r in reqs] == want


@pytest.mark.parametrize("how", ["drain", "crash"])
def test_drain_and_crash(pair, how):
    """Two requests decoding on 2 slots, one queued, and one session
    imported but not yet slotted: ``crash`` loses all of them;
    ``drain_queue`` and ``drain_sessions`` hand back the queued request
    and the session (its cache whole, as exported), which finish on
    another engine while the slotted request finishes here, every stream
    the JAX engine's."""
    jm, params, tm, tp = pair()
    prompts = _prompts(tm.cfg.vocab, 6, 3, seed=30)
    want, _ = _run(ServeEngine, Request, jm, params, prompts, 6,
                   decode_chunk=2)
    eng = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    reqs = [TRequest(rid=i, prompt=p.copy(), max_new=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.step()                       # 0 and 1 slotted, 2 queued
    eng.import_session(eng.export_session(1))
    assert eng.pending() == 2 and eng.active_count() == 1
    if how == "crash":
        eng.crash()
        assert eng.pending() == 0 and eng.active_count() == 0
        assert eng.drain_queue() == [] and eng.drain_sessions() == []
        assert eng.step() == 0 and eng.cache is None
        return
    assert eng.drain_queue() == [reqs[2]]
    sessions = eng.drain_sessions()
    assert [s.req for s in sessions] == [reqs[1]] and eng.pending() == 0
    other = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                         decode_chunk=2)
    other.import_session(sessions[0])
    other.submit(reqs[2])
    other.run_until_drained(max_steps=100)
    eng.run_until_drained(max_steps=100)
    assert [list(r.out_tokens) for r in reqs] == want


def _engines(entry, kinds):
    jm, params, tm, tp = entry

    def engine(kind):
        if kind == "jax":
            return ServeEngine(jm, params, max_batch=2, max_seq=MAX_SEQ,
                               decode_chunk=2), Request
        return TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                            decode_chunk=2), TRequest
    return [engine(k) for k in kinds]


def _unmigrated(engine, req_cls, prompt):
    r = req_cls(rid=0, prompt=prompt.copy(), max_new=8)
    engine.submit(r)
    engine.run_until_drained(max_steps=100)
    return list(r.out_tokens)


def _migrated(src, src_req, dst, prompt, how, to_jax=False):
    """Prefill and one chunk of 2 on ``src``, then the session in process
    (its bits intact: a port session's ``uint16`` leaves viewed as
    ``ml_dtypes`` bfloat16 for the JAX engine) or as wire bytes to
    ``dst``, and on to the end there; returns the moved request's
    tokens."""
    req = src_req(rid=0, prompt=prompt.copy(), max_new=8, tenant=7)
    src.submit(req)
    src.step()
    assert not req.done
    if how == "wire":
        dst.import_session_wire(src.export_session_wire(0))
        req = dst.sessions_in[-1].req
        assert req.tenant == 7
    else:
        sess = src.export_session(0)
        if to_jax:
            sess.cache = {n: (a.view(ml_dtypes.bfloat16)
                              if a.dtype == np.uint16 else a)
                          for n, a in sess.cache.items()}
        dst.import_session(sess)
    dst.run_until_drained(max_steps=100)
    assert req.done and req.rid == 0
    return list(req.out_tokens)


@pytest.mark.parametrize("src,dst,how", [
    ("port", "port", "in-process"), ("port", "port", "wire"),
    ("jax", "port", "wire"), ("port", "jax", "wire")])
def test_migration_token_identity(pair, src, dst, how):
    """A session exported after one decode chunk (K/V to its position,
    every mamba layer's state whole) continues the unmigrated JAX
    stream."""
    entry = pair()
    prompt = _prompts(entry[2].cfg.vocab, 6, 1, seed=7)[0]
    (j, jreq), = _engines(entry, ["jax"])
    want = _unmigrated(j, jreq, prompt)
    (a, req_cls), (b, _) = _engines(entry, [src, dst])
    got = _migrated(a, req_cls, b, prompt, how)
    assert got == want, (src, dst, how, got, want)


@pytest.mark.parametrize("direction", ("jax->port", "port->jax"))
def test_bf16_sessions_cross_the_packages_over_the_wire(pair, direction):
    """bfloat16: ``k``, ``v`` and the conv leaves travel as
    ``"bfloat16"`` bits, the ssm leaves as float32.  Over the wire the
    destination resumes exactly as from the session handed over in
    process with its bits intact, and that is the unmigrated stream, on
    which the two packages agree for this prompt."""
    entry = pair(8, "bfloat16")
    prompt = _prompts(entry[2].cfg.vocab, 6, 1, seed=7)[0]
    src, dst = direction.split("->")
    (a, req_cls), (b, _) = _engines(entry, [src, dst])
    got = _migrated(a, req_cls, b, prompt, "wire")
    (a, req_cls), (b, _) = _engines(entry, [src, dst])
    assert got == _migrated(a, req_cls, b, prompt, "in-process",
                            to_jax=dst == "jax")
    (s, s_req), (d, d_req) = _engines(entry, [src, dst])
    want = _unmigrated(s, s_req, prompt)
    assert want == _unmigrated(d, d_req, prompt)   # they agree here
    assert got == want, (direction, got, want)


# ---------------------------------------------------------------------------
# checkpoints and conversion
# ---------------------------------------------------------------------------

def _files(step_dir):
    return {name: open(os.path.join(step_dir, name), "rb").read()
            for name in sorted(os.listdir(step_dir))}


@pytest.mark.parametrize("n_layers", [8, 16])
def test_checkpoint_byte_identical_and_cross_loading(pair, tmp_path,
                                                     n_layers):
    """The reference's tree written by the JAX package and the same
    parameters written by the port from its modules give the same files;
    the port reads the JAX package's back into the same modules, and the
    JAX model's logits on the port's checkpoint are the port's."""
    jm, params, tm, tp = pair(n_layers)
    jd = jstore.save_checkpoint(str(tmp_path / "jax"), 4, params)
    td = tstore.save_checkpoint(str(tmp_path / "port"), 4,
                                params_to_numpy(tm.cfg, tp))
    jf, tf = _files(jd), _files(td)
    assert tf.keys() == jf.keys()
    for name in jf:
        assert tf[name] == jf[name], name
    tree, _ = tstore.load_checkpoint(str(tmp_path / "jax"), 4,
                                     params_to_numpy(tm.cfg, tp),
                                     device="cpu")
    tp2 = params_from_numpy(tm.cfg, tree, "cpu")
    mine, back = dict(tp.named_parameters()), dict(tp2.named_parameters())
    assert mine.keys() == back.keys()
    for n, a in mine.items():
        assert torch.equal(a, back[n]), n
    jparams, _ = jstore.load_checkpoint(str(tmp_path / "port"), 4, params)
    tokens = np.random.default_rng(1).integers(0, tm.cfg.vocab, (1, 9))
    jl, _ = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl, 1e-5)


@pytest.mark.parametrize("n_layers", [8, 16])
def test_params_to_numpy_inverts_params_from_numpy(pair, n_layers):
    _, params, tm, tp = pair(n_layers)
    tree = jax.tree.map(np.asarray, params)
    assert tree["mamba_moe"]["ssm"]["in_proj"].shape[:2] == (n_layers // 8,
                                                             4)
    back = params_to_numpy(tm.cfg, params_from_numpy(tm.cfg, tree, "cpu"))
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.float32, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
