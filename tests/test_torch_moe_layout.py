"""The MoE family's alternating dense / MoE layout (``moe_every > 1``) in
the port (``repro_torch.models.moe``) on the CPU, held against the JAX
package's ``repro.models.moe`` with the same inputs and weights (carried
over by ``params_from_numpy``), on ``granite-moe-1b-a400m`` reduced at two
layouts set with ``dataclasses.replace``:

* ``moe_every = 2``, ``n_layers = 4``: two superblocks of one dense layer
  and one MoE layer (the stacked ``nb`` axis);
* ``moe_every = 3``, ``n_layers = 6``: two superblocks of two dense layers
  and one MoE layer (the stacked ``per_d`` axis too).

It holds the cache's four leaves (names, shapes, dtypes, logical and
sequence axes), ``prefill`` logits and caches, ragged decode steps (the
caches written in place), the ``ServeEngine``'s greedy tokens (fused at
chunk 1 and 4, legacy; a prompt filling ``max_seq``), sessions migrated in
process and over the wire both ways in float32 and bfloat16,
``encode_session`` bytes, checkpoint files byte for byte and
``params_to_numpy`` inverting ``params_from_numpy``.

Float32 on both sides unless a test says bfloat16; tokens and bytes are
exact, the tolerance (1e-5, as ``tests/test_torch_moe.py`` uses on caches)
covers summation order only.
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
from repro.region import wire as jwire
from repro.serve import Request, ServeEngine
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import torch_dtype
from repro_torch.models import get_model as tget_model
from repro_torch.models import moe as TM
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.region import wire as twire
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import Session as TSession

ARCH = "granite-moe-1b-a400m"
MAX_SEQ = 32
TOL = 1e-5
LEAVES = ("k_dense", "v_dense", "k_moe", "v_moe")
LAYOUTS = {"every2": (2, 4), "every3": (3, 6)}     # (moe_every, n_layers)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(layout, dtype=None):
    every, n_layers = LAYOUTS[layout]
    kw = dict(moe_every=every, n_layers=n_layers)
    if dtype is not None:
        kw["compute_dtype"] = dtype
    return (dataclasses.replace(get_config(ARCH, reduced=True), **kw),
            dataclasses.replace(tget_config(ARCH, reduced=True), **kw))


@pytest.fixture(scope="module")
def pair():
    """Per (layout, compute dtype): the reference (model, params) and the
    port's, same weights; built once per module."""
    cache = {}

    def get(layout, dtype=None):
        key = (layout, dtype)
        if key not in cache:
            jc, tc = _configs(layout, dtype)
            jm = get_model(jc)
            params = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
            tp = params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                   "cpu")
            cache[key] = (jm, params, tget_model(tc), tp)
        return cache[key]
    return get


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol,
                               atol=tol)


def _prompts(vocab, length, n, seed=0):
    return [np.random.default_rng(seed + s).integers(0, vocab, length)
            for s in range(n)]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_cache_layout_matches_jax(layout):
    """Four leaves with the reference's names, shapes, dtypes, logical axes
    and sequence axes; the superblock order is the reference's: per_d
    dense layers, then one MoE layer."""
    jc, tc = _configs(layout)
    jm, tm = get_model(jc), tget_model(tc)
    jspec, tspec = jm.cache_spec(3, MAX_SEQ), tm.cache_spec(3, MAX_SEQ)
    assert tuple(tspec) == tuple(jspec) == LEAVES
    for name, (shape, dt) in tspec.items():
        assert tuple(shape) == jspec[name].shape, name
        assert dt == torch_dtype(str(jspec[name].dtype)), name
    assert tm.cache_logical_axes() == jm.cache_logical_axes()
    assert tm.cache_seq_axes() == jm.cache_seq_axes()
    nb, per_d = TM.layout(tc)
    assert (nb, per_d) == (tc.n_layers // tc.moe_every, tc.moe_every - 1)
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert isinstance(tp, TM.AlternatingMoE) and len(tp.blocks) == nb
    for sb in tp.blocks:
        assert len(sb.dense_layers) == per_d
        assert all(hasattr(lp, "mlp") for lp in sb.dense_layers)
        assert isinstance(sb.moe_layer, TM.MoEBlock)
    # the reference's layer ids: superblock b holds layers b*every .. +per_d
    assert [tc.is_moe_layer(i) for i in range(tc.n_layers)] == (
        ([False] * per_d + [True]) * nb)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_and_decode_logits_and_caches_match_jax(pair, layout):
    jm, params, tm, tp = pair(layout)
    prompts = _prompts(tm.cfg.vocab, 5, 1, seed=4) + _prompts(
        tm.cfg.vocab, 9, 1, seed=5)
    B, Smax = 2, 24
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_spec(B, Smax))
    tcache = {n: torch.zeros(shape, dtype=dt)
              for n, (shape, dt) in tm.cache_spec(B, Smax).items()}
    ptrs = {n: t.data_ptr() for n, t in tcache.items()}
    assert tm.prefill_chunk is None            # MoE prefills whole
    nxt = []
    for slot, prompt in enumerate(prompts):
        jl, jpc = jax.jit(jm.prefill)(params,
                                      {"tokens": jnp.asarray(prompt)[None]})
        tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)[None]})
        _close(tl, jl)
        assert tpc.keys() == jpc.keys() == set(LEAVES)
        for name in LEAVES:
            assert tuple(tpc[name].shape) == jpc[name].shape
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
        tl, tcache2 = tm.decode(tp, torch.from_numpy(tok).long(),
                                torch.from_numpy(pos), tcache)
        assert tcache2 is tcache
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1
    assert {n: t.data_ptr() for n, t in tcache.items()} == ptrs
    for name in LEAVES:
        _close(tcache[name], jcache[name])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _run(engine_cls, req_cls, model, params, prompts, max_new, **kw):
    engine = engine_cls(model, params, max_batch=2, max_seq=MAX_SEQ, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained(max_steps=500)
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs], engine


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("fused,chunk", [(True, 1), (True, 4), (False, 1)])
def test_engine_token_identity_with_jax(pair, layout, fused, chunk):
    jm, params, tm, tp = pair(layout)
    prompts = _prompts(tm.cfg.vocab, 6, 3)          # 3 requests, 2 slots
    want, jeng = _run(ServeEngine, Request, jm, params, prompts, 6,
                      fused=fused, decode_chunk=chunk)
    got, teng = _run(TServeEngine, TRequest, tm, tp, prompts, 6,
                     fused=fused, decode_chunk=chunk)
    assert got == want, (layout, fused, chunk, got, want)
    assert all(len(t) == 6 for t in got)
    assert teng.scheduler.ptt.updates == jeng.scheduler.ptt.updates


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("fused,plen", [(True, MAX_SEQ), (False, MAX_SEQ),
                                        (True, MAX_SEQ - 1)])
def test_prompt_filling_the_cache_matches_jax(pair, layout, fused, plen):
    """The cache's edge (C1): a prompt of ``max_seq`` tokens decodes at
    ``pos == max_seq``, where the reference's scatter drops the write to
    every leaf; ``max_seq - 1`` is the control."""
    jm, params, tm, tp = pair(layout)
    prompts = _prompts(tm.cfg.vocab, plen, 3, seed=100)
    want, _ = _run(ServeEngine, Request, jm, params, prompts, 4,
                   fused=fused, decode_chunk=1)
    got, _ = _run(TServeEngine, TRequest, tm, tp, prompts, 4,
                  fused=fused, decode_chunk=1)
    assert got == want, (layout, fused, plen, got, want)


def _engine(entry, kind):
    jm, params, tm, tp = entry
    if kind == "jax":
        return ServeEngine(jm, params, max_batch=2, max_seq=MAX_SEQ,
                           decode_chunk=2), Request
    return TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                        decode_chunk=2), TRequest


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
    req = src_req(rid=0, prompt=prompt.copy(), max_new=8)
    src.submit(req)
    src.step()
    assert not req.done
    if how == "wire":
        dst.import_session_wire(src.export_session_wire(0))
        sess = dst.sessions_in[-1]
        req = sess.req
    else:
        sess = src.export_session(0)
        if to_jax:
            sess.cache = {n: (a.view(ml_dtypes.bfloat16)
                              if a.dtype == np.uint16 else a)
                          for n, a in sess.cache.items()}
        dst.import_session(sess)
    # the four leaves travel trimmed to the position on their seq axes
    assert sess.cache["k_dense"].shape[3] == sess.pos
    assert sess.cache["k_moe"].shape[2] == sess.pos
    dst.run_until_drained(max_steps=100)
    assert req.done and req.rid == 0
    return list(req.out_tokens)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("src,dst,how", [
    ("port", "port", "in-process"), ("port", "port", "wire"),
    ("jax", "port", "wire"), ("port", "jax", "wire")])
def test_migration_token_identity(pair, layout, src, dst, how):
    """A session exported after one decode chunk continues the unmigrated
    JAX stream (no-drop decode capacity makes a slot's tokens independent
    of the batch)."""
    entry = pair(layout)
    prompt = _prompts(entry[2].cfg.vocab, 6, 1, seed=7)[0]
    want = _unmigrated(*_engine(entry, "jax"), prompt)
    a, req_cls = _engine(entry, src)
    b, _ = _engine(entry, dst)
    got = _migrated(a, req_cls, b, prompt, how)
    assert got == want, (layout, src, dst, how, got, want)


@pytest.mark.parametrize("direction", ("jax->port", "port->jax"))
def test_bf16_sessions_cross_the_packages_over_the_wire(pair, direction):
    """bfloat16: all four cache leaves travel as ``"bfloat16"`` bits.  Over
    the wire the destination resumes exactly as from the session handed
    over in process with its bits intact."""
    entry = pair("every2", "bfloat16")
    prompt = _prompts(entry[2].cfg.vocab, 6, 1, seed=7)[0]
    src, dst = direction.split("->")
    a, req_cls = _engine(entry, src)
    got = _migrated(a, req_cls, _engine(entry, dst)[0], prompt, "wire")
    a, req_cls = _engine(entry, src)
    assert got == _migrated(a, req_cls, _engine(entry, dst)[0], prompt,
                            "in-process", to_jax=dst == "jax")
    assert got == _unmigrated(*_engine(entry, dst), prompt), (direction, got)


@pytest.mark.parametrize("layout,dtype", [("every2", "float32"),
                                          ("every2", "bfloat16"),
                                          ("every3", "float32")])
def test_encode_session_bytes_identical(pair, layout, dtype):
    """A live session the JAX engine exported (its four cache leaves) and
    the same session in the port's types encode to the same bytes; each
    package decodes the other's."""
    jm, params, _, _ = pair(layout, None if dtype == "float32" else dtype)
    eng = ServeEngine(jm, params, max_batch=2, max_seq=MAX_SEQ,
                      decode_chunk=2)
    eng.submit(Request(rid=3, prompt=_prompts(jm.cfg.vocab, 6, 1)[0],
                       max_new=8))
    eng.step()
    js = eng.export_session(3)
    js.req.t_first, js.req.t_admit = 1.25, 1.0
    assert set(js.cache) == set(LEAVES)
    bits = {n: (np.asarray(a).view(np.uint16) if a.dtype == ml_dtypes.bfloat16
                else np.asarray(a).copy()) for n, a in js.cache.items()}
    tr = TRequest(**{f.name: getattr(js.req, f.name)
                     for f in dataclasses.fields(TRequest)})
    ts = TSession(req=tr, pos=js.pos, cur_token=js.cur_token, cache=bits)
    jb = jwire.encode_session(js, codec="zlib")
    tb = twire.encode_session(ts, codec="zlib")
    assert tb == jb
    back = twire.decode_session(jb)
    for n, a in bits.items():
        assert back.cache[n].dtype == a.dtype
        np.testing.assert_array_equal(back.cache[n], a)
    assert jwire.decode_session(tb).pos == js.pos


# ---------------------------------------------------------------------------
# checkpoints and conversion
# ---------------------------------------------------------------------------

def _files(step_dir):
    return {name: open(os.path.join(step_dir, name), "rb").read()
            for name in sorted(os.listdir(step_dir))}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_checkpoint_byte_identical_and_cross_loading(pair, layout,
                                                     tmp_path):
    """The reference's tree written by the JAX package and the same
    parameters written by the port from its modules give the same files
    (a swapped ``(b, i)`` would show); the port reads the JAX package's
    back into the same modules, and the JAX model's logits on the port's
    checkpoint are the port's."""
    jm, params, tm, tp = pair(layout)
    jd = jstore.save_checkpoint(str(tmp_path / "jax"), 2, params)
    td = tstore.save_checkpoint(str(tmp_path / "port"), 2,
                                params_to_numpy(tm.cfg, tp))
    jf, tf = _files(jd), _files(td)
    assert tf.keys() == jf.keys()
    for name in jf:
        assert tf[name] == jf[name], name
    tree, _ = tstore.load_checkpoint(str(tmp_path / "jax"), 2,
                                     params_to_numpy(tm.cfg, tp),
                                     device="cpu")
    tp2 = params_from_numpy(tm.cfg, tree, "cpu")
    mine, back = dict(tp.named_parameters()), dict(tp2.named_parameters())
    assert mine.keys() == back.keys()
    for n, a in mine.items():
        assert torch.equal(a, back[n]), n
    jparams, _ = jstore.load_checkpoint(str(tmp_path / "port"), 2, params)
    tokens = np.random.default_rng(1).integers(0, tm.cfg.vocab, (1, 9))
    jl, _ = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_params_to_numpy_inverts_params_from_numpy(pair, layout):
    _, params, tm, tp = pair(layout)
    nb, per_d = TM.layout(tm.cfg)
    tree = jax.tree.map(np.asarray, params)
    assert tree["dense_layers"]["mlp"]["w_up"].shape[:2] == (nb, per_d)
    assert tree["moe_layers"]["moe"]["w_up"].shape[:2] == (
        nb, tm.cfg.n_experts)
    back = params_to_numpy(tm.cfg, params_from_numpy(tm.cfg, tree, "cpu"))
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.float32, path
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
