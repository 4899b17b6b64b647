"""The port's MoE family (``repro_torch.models.moe``) on the CPU, held
against the JAX package's ``repro.models.moe`` with the same inputs and
weights (carried over by ``params_from_numpy``):

* the MoE layer against ``moe_dense`` and ``_moe_ep_local`` on the
  ``tests/test_moe.py`` shapes, a case whose capacity drops copies (the
  same copies dropped) and the no-drop decode capacity (1e-5);
* routing (weights 1e-6, experts exact) and capacity ranks (exact);
* ``prefill`` / ``decode`` logits on ``granite-moe-1b-a400m`` and
  ``qwen3-moe-235b-a22b`` reduced (the latter with ``qk_norm``; 1e-4,
  caches 1e-5);
* the ``ServeEngine``: greedy tokens identical to the JAX engine's, fused
  at chunk 1 and 4 and legacy, prompts filling the cache at
  ``max_seq=32``, a chunked engine (MoE prefills whole), and sessions
  migrated in process and over the wire, both ways between the packages.

Float32 on both sides (the reduced configs' compute dtype); tokens are
exact, the tolerances cover summation order only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import get_model
from repro.models import moe as JM
from repro.models import sessions as jsessions
from repro.region.wire import decode_session as jdecode
from repro.serve import Request, ServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import get_model as tget_model
from repro_torch.models import moe as TM
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.region.wire import decode_session as tdecode
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b")
MAX_SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    """tests/test_moe.py's layer config, in both packages."""
    base = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab=64, n_experts=8, top_k=2,
                d_expert=16, capacity_factor=16.0, param_dtype="float32",
                compute_dtype="float32")
    base.update(kw)
    return JModelConfig(**base), TModelConfig(**base)


def _layer(jc, tc, seed=0):
    p, _ = JM.moe_init(jc, jax.random.PRNGKey(seed))
    tp = TM.MoE(tc, {k: torch.from_numpy(np.array(v))
                     for k, v in p.items()})
    return p, tp


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("cf,shape", [(16.0, (4, 8, 32)),    # no drops
                                      (0.25, (2, 16, 32)),   # drops copies
                                      (1.25, (1, 96, 32))])  # serving factor
def test_moe_layer_matches_dense_and_ep_local(cf, shape):
    jc, tc = _cfgs(capacity_factor=cf)
    p, tp = _layer(jc, tc)
    x = _x(shape)
    dense = np.asarray(JM.moe_dense(jc, p, jnp.asarray(x)))
    ep = np.asarray(JM._moe_ep_local(jc, p, jnp.asarray(x), n_cols=1,
                                     axis=None))
    got = TM.moe_apply(tc, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ep, rtol=1e-5, atol=1e-5)


def test_dropped_copies_are_the_references():
    """At capacity factor 0.25 copies drop: the port picks the reference's
    experts and ranks every copy as the reference does, so it drops the
    same copies (the layer's output at this factor is compared above)."""
    jc, tc = _cfgs(capacity_factor=0.25)
    p, tp = _layer(jc, tc)
    x = _x((2, 16, 32))
    T, E, k = 32, jc.n_experts, jc.top_k
    cap = TM.capacity(tc, T)
    _, idx = JM._route(jc, p["router"], jnp.asarray(x).reshape(T, -1))
    jpos = np.asarray(JM._sorted_positions(idx.reshape(-1), E))
    _, tidx = TM.route(tc, tp.router, torch.from_numpy(x).reshape(T, -1))
    tpos = TM.sorted_positions(tidx.reshape(-1), E).numpy()
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tpos, jpos)
    assert (jpos >= cap).sum() > 0, "the case must drop copies"
    assert cap == max(1, int(np.ceil(T * k * 0.25 / E)))


def test_decode_runs_at_no_drop_capacity():
    """Decode's ``min_capacity`` is the batch's token count: the output is
    the reference's ``moe_apply(decode=True)`` and each slot's row equals
    that slot run alone."""
    jc, tc = _cfgs(capacity_factor=1.25)
    p, tp = _layer(jc, tc)
    x = _x((8, 1, 32), seed=3)
    want = np.asarray(JM.moe_apply(jc, p, jnp.asarray(x), decode=True))
    got = TM.moe_apply(tc, tp, torch.from_numpy(x), min_capacity=8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    alone = TM.moe_apply(tc, tp, torch.from_numpy(x[3:4]),
                         min_capacity=1).numpy()
    np.testing.assert_allclose(alone[0], got[3], rtol=1e-5, atol=1e-6)


def test_route_and_sorted_positions_match_jax():
    jc, tc = _cfgs()
    p, tp = _layer(jc, tc)
    x = _x((6, 32), seed=2)
    jv, ji = JM._route(jc, p["router"], jnp.asarray(x))
    tv, ti = TM.route(tc, tp.router, torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(tv.sum(-1).numpy(), 1.0, rtol=1e-5)
    e = torch.tensor([2, 0, 2, 1, 0, 2])
    assert TM.sorted_positions(e, 3).tolist() == [0, 0, 1, 0, 1, 2]
    flat = np.random.default_rng(5).integers(0, 8, 200)
    np.testing.assert_array_equal(
        TM.sorted_positions(torch.from_numpy(flat), 8).numpy(),
        np.asarray(JM._sorted_positions(jnp.asarray(flat), 8)))


@pytest.mark.parametrize("every,n_layers", [(2, 4), (3, 6)])
def test_moe_every_above_one_matches_the_jax_tree(every, n_layers):
    """The alternating dense / MoE layout: the port's own init and
    ``params_from_numpy`` of the JAX package's init give the reference's
    tree, ``dense_layers`` on ``(nb, per_d)`` and ``moe_layers`` on
    ``(nb,)``, leaf for leaf by path and shape (the layout's numbers are
    held in ``tests/test_torch_moe_layout.py``)."""
    kw = dict(moe_every=every, n_layers=n_layers)
    jc = dataclasses.replace(get_config("granite-moe-1b-a400m",
                                        reduced=True), **kw)
    tc = dataclasses.replace(tget_config("granite-moe-1b-a400m",
                                         reduced=True), **kw)
    jm = get_model(jc)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))[0])
    nb, per_d = n_layers // every, every - 1
    assert tree["dense_layers"]["attn"]["wq"].shape[:2] == (nb, per_d)
    assert tree["moe_layers"]["moe"]["router"].shape[0] == nb
    want = [(p, w.shape) for p, w in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    own = tget_model(tc).init(torch.Generator().manual_seed(0), "cpu")
    for model in (own, params_from_numpy(tc, tree, "cpu")):
        got = jax.tree_util.tree_flatten_with_path(
            params_to_numpy(tc, model))[0]
        assert [(p, g.shape) for p, g in got] == want


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _close(t, j, tol=1e-4):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(pair, arch):
    jm, params, tm, tp = pair(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tm.cfg.vocab, n) for n in (5, 9)]
    B, Smax = 2, 24
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_spec(B, Smax))
    tcache = {n: torch.zeros(shape, dtype=dt)
              for n, (shape, dt) in tm.cache_spec(B, Smax).items()}
    assert tm.prefill_chunk is None            # MoE prefills whole
    nxt = []
    for slot, prompt in enumerate(prompts):
        jl, jpc = jax.jit(jm.prefill)(params,
                                      {"tokens": jnp.asarray(prompt)[None]})
        tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)[None]})
        _close(tl, jl)
        for name in ("k", "v"):
            _close(tpc[name], jpc[name], 1e-5)
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
        _close(tcache[name], jcache[name], 1e-5)


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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fused,chunk,kw", [
    (True, 1, {}), (True, 4, {}), (False, 1, {}),
    (True, 2, {"prefill_chunk_tokens": 4})])   # MoE prefills whole anyway
def test_engine_token_identity_with_jax(pair, arch, fused, chunk, kw):
    jm, params, tm, tp = pair(arch)
    prompts = _prompts(tm.cfg.vocab, 6, 3)          # 3 requests, 2 slots
    want, jeng = _run(ServeEngine, Request, jm, params, prompts, 6,
                      fused=fused, decode_chunk=chunk, **kw)
    got, teng = _run(TServeEngine, TRequest, tm, tp, prompts, 6,
                     fused=fused, decode_chunk=chunk, **kw)
    assert got == want, (arch, fused, chunk, got, want)
    assert all(len(t) == 6 for t in got)
    assert teng.scheduler.ptt.updates == jeng.scheduler.ptt.updates


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fused,chunk", [(True, 1), (True, 4), (False, 1)])
@pytest.mark.parametrize("plen", [MAX_SEQ, MAX_SEQ - 1])
def test_prompt_filling_the_cache_matches_jax(pair, arch, fused, chunk,
                                             plen):
    """The cache's edge: a prompt of ``max_seq`` tokens decodes its first
    token at ``pos == max_seq``; ``max_seq - 1`` is the control."""
    jm, params, tm, tp = pair(arch)
    prompts = _prompts(tm.cfg.vocab, plen, 3, seed=100)
    want, _ = _run(ServeEngine, Request, jm, params, prompts, 4,
                   fused=fused, decode_chunk=chunk)
    got, _ = _run(TServeEngine, TRequest, tm, tp, prompts, 4,
                  fused=fused, decode_chunk=chunk)
    assert got == want, (arch, fused, chunk, plen, got, want)


def _migrated(src_engine, src_req, dst_engine, prompt, how):
    """One request prefilled and decoded one chunk of 2 on ``src_engine``,
    moved to ``dst_engine`` (in process or as wire bytes), run to the end
    there; returns the decoded request's tokens."""
    req = src_req(rid=0, prompt=prompt.copy(), max_new=8)
    src_engine.submit(req)
    src_engine.step()                  # prefill token + one chunk of 2
    assert not req.done
    if how == "in-process":
        dst_engine.import_session(src_engine.export_session(req.rid))
        out = req
    else:
        data = src_engine.export_session_wire(req.rid)
        dst_engine.import_session_wire(data)
        out = dst_engine.sessions_in[-1].req   # the wire carries a new
                                               # Request; the rid is the id
    dst_engine.run_until_drained(max_steps=100)
    assert out.done and out.rid == req.rid
    return list(out.out_tokens)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("src,dst,how", [
    ("port", "port", "in-process"), ("port", "port", "wire"),
    ("jax", "port", "wire"), ("port", "jax", "wire")])
def test_migration_token_identity(pair, arch, src, dst, how):
    """A session exported after one decode chunk continues the unmigrated
    JAX stream, in process or over the wire, across the packages both
    ways (no-drop decode capacity makes a slot's tokens independent of
    the batch)."""
    jm, params, tm, tp = pair(arch)
    prompt = _prompts(tm.cfg.vocab, 6, 1, seed=7)[0]
    want, _ = _run(ServeEngine, Request, jm, params, [prompt], 8,
                   decode_chunk=2)

    def engine(kind):
        if kind == "jax":
            return ServeEngine(jm, params, max_batch=2, max_seq=MAX_SEQ,
                               decode_chunk=2), Request
        return TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                            decode_chunk=2), TRequest

    a, req_cls = engine(src)
    b, _ = engine(dst)
    got = _migrated(a, req_cls, b, prompt, how)
    assert got == want[0], (arch, src, dst, how, got, want[0])


def test_wire_session_of_moe_decodes_in_both_packages(pair):
    """The port's MoE session bytes decode field for field in the JAX
    package."""
    _, _, tm, tp = pair("granite-moe-1b-a400m")
    eng = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    eng.submit(TRequest(rid=3, prompt=np.arange(7), max_new=8, tenant="t1"))
    eng.step()
    data = eng.export_session_wire(3)
    js, ts = jdecode(data), tdecode(data)
    assert js.req.tenant == ts.req.tenant == "t1"
    assert js.pos == ts.pos == 7 + 2
    for name in ("k", "v"):
        np.testing.assert_array_equal(js.cache[name], ts.cache[name])
