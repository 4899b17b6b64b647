"""The port's SSM family (``repro_torch.models.mamba2``) on the CPU, held
against the JAX package's ``repro.models.mamba2`` with the same inputs and
weights (carried over by ``params_from_numpy``):

* ``ssm_layer_full`` (output and final state) on ``tests/test_mamba2.py``'s
  layer config at its four (S, chunk) cases, prompts that are and are not
  a multiple of the chunk, within the JAX package's own tolerance (rtol
  1e-4, atol 1e-5); ``ssm_layer_step`` continuing it;
* ``_ssd_chunked`` with a ``dt`` so large that ``exp(cum_q - cum_k)``
  overflows above the diagonal: no NaN, the reference's values;
* ``prefill`` / ``decode`` logits and caches of ``mamba2-130m`` reduced,
  and the decode cache written in place;
* the ``ServeEngine``: greedy tokens identical to the JAX engine's, fused
  at chunk 1 and 4, legacy, and with ``prefill_chunk_tokens > 0`` (which
  prefills whole: the family has no ``prefill_chunk``); 1-, 2- and 3-token
  prompts, whose conv state has fewer rows than the cache; sessions
  migrated in process and over the wire both ways between the packages,
  in float32 and bfloat16; the prefill-role handoff; ``drain`` and
  ``crash`` with a request queued and a session waiting for a slot;
* checkpoint shards and manifest byte-identical to the JAX package's,
  each package loading the other's; ``params_to_numpy`` inverting
  ``params_from_numpy``.

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
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import get_model
from repro.models import mamba2 as JM
from repro.models import sessions as jsessions
from repro.serve import Request, ServeEngine
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import get_model as tget_model
from repro_torch.models import mamba2 as TM
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

ARCH = "mamba2-130m"
MAX_SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """Per compute dtype: the reference (model, params) and the port's,
    same weights (``mamba2-130m`` reduced); built once per module."""
    cache = {}

    def get(dtype=None):
        if dtype not in cache:
            jc = get_config(ARCH, reduced=True)
            tc = tget_config(ARCH, reduced=True)
            if dtype is not None:
                jc = dataclasses.replace(jc, compute_dtype=dtype)
                tc = dataclasses.replace(tc, compute_dtype=dtype)
            jm = get_model(jc)
            params = jax.jit(lambda key: jm.init(key)[0])(
                jax.random.PRNGKey(0))
            tp = params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                   "cpu")
            cache[dtype] = (jm, params, tget_model(tc), tp)
        return cache[dtype]
    return get


# ---------------------------------------------------------------------------
# the SSD layer
# ---------------------------------------------------------------------------

def _cfgs(chunk=8):
    """tests/test_mamba2.py's layer config, in both packages."""
    kw = dict(name="m", family="ssm", n_layers=2, d_model=32, n_heads=1,
              n_kv_heads=1, d_ff=0, vocab=64, ssm_state=16, ssm_head_dim=8,
              ssm_expand=2, ssm_conv=4, ssm_chunk=chunk,
              param_dtype="float32", compute_dtype="float32")
    return JModelConfig(**kw), TModelConfig(**kw)


def _layer(jc, tc):
    p, _ = JM.ssm_layer_init(jc, jax.random.PRNGKey(0))
    return p, TM.SSM(tc, {k: torch.from_numpy(np.array(v))
                          for k, v in p.items()})


def _x(shape, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


def _close(t, j, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("S,chunk", [(32, 8), (24, 8), (16, 16), (40, 16)])
def test_ssm_layer_full_matches_jax(S, chunk):
    jc, tc = _cfgs(chunk)
    p, tp = _layer(jc, tc)
    x = _x((2, S, 32))
    y, (h, conv) = JM.ssm_layer_full(jc, p, jnp.asarray(x),
                                     conv_state=jnp.zeros(()))
    ty, (th, tconv) = TM.ssm_layer_full(tc, tp, torch.from_numpy(x))
    _close(ty, y)
    _close(th, h)
    _close(tconv, conv)
    assert tconv.shape == (2, jc.ssm_conv - 1, jc.d_inner + 2 * jc.ssm_state)


def test_ssm_layer_step_continues_full():
    """The port's full pass over 16 tokens then one step is its full pass
    over 17, and the step is the reference's step on the same state."""
    jc, tc = _cfgs(8)
    p, tp = _layer(jc, tc)
    x = torch.from_numpy(_x((2, 17, 32), seed=2))
    y_all, _ = TM.ssm_layer_full(tc, tp, x)
    _, (h, conv) = TM.ssm_layer_full(tc, tp, x[:, :16])
    y_step, (h1, conv1) = TM.ssm_layer_step(tc, tp, x[:, 16:17], h, conv)
    _close(y_step[:, 0], y_all[:, 16].numpy())
    jy, (jh, jconv) = JM.ssm_layer_step(jc, p, jnp.asarray(x[:, 16:17]),
                                        jnp.asarray(h), jnp.asarray(conv))
    _close(y_step, jy)
    _close(h1, jh)
    _close(conv1, jconv)


def test_ssd_chunked_takes_no_nan_from_an_overflow_above_the_diagonal():
    """dt of 40-60 against A down to -16: within a chunk of 8 the
    exponent ``cum_q - cum_k`` above the diagonal reaches thousands, and
    ``exp`` gives inf there.  The port's ``torch.where`` keeps it out, as
    the reference's ``jnp.where`` does; a 0/1 mask would give NaN."""
    jc, tc = _cfgs(8)
    rng = np.random.default_rng(3)
    B, S, nh, hp, ds = 2, 20, 4, 8, 16
    xh = rng.standard_normal((B, S, nh, hp)).astype(np.float32)
    dt = rng.uniform(40.0, 60.0, (B, S, nh)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, nh).astype(np.float32)
    Bm = rng.standard_normal((B, S, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, S, ds)).astype(np.float32)
    cum = np.cumsum(dt[:, :8] * A, axis=1)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cum[:, :, None] - cum[:, None, :])).any()
    y, h = TM._ssd_chunked(tc, *map(torch.from_numpy, (xh, dt, A, Bm, Cm)))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    jy, jh = JM._ssd_chunked(jc, *map(jnp.asarray, (xh, dt, A, Bm, Cm)))
    _close(y, jy)
    _close(h, jh)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_prefill_and_decode_logits_match_jax(pair):
    jm, params, tm, tp = pair()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tm.cfg.vocab, n) for n in (5, 21)]
    B = 2
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_spec(B, MAX_SEQ))
    tcache = {n: torch.zeros(shape, dtype=dt)
              for n, (shape, dt) in tm.cache_spec(B, MAX_SEQ).items()}
    assert tm.prefill_chunk is None            # SSM prefills whole
    assert tm.cache_seq_axes() == {"ssm": None, "conv": None}
    nxt = []
    for slot, prompt in enumerate(prompts):
        jl, jpc = jax.jit(jm.prefill)(params,
                                      {"tokens": jnp.asarray(prompt)[None]})
        tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)[None]})
        _close(tl, jl)
        for name in ("ssm", "conv"):
            assert tpc[name].shape == jpc[name].shape
            _close(tpc[name], jpc[name])
        jcache = jsessions.insert_session(jcache, slot, jpc,
                                          jm.cache_logical_axes())
        tm.insert_session(tcache, slot, tpc)
        nxt.append(int(np.argmax(np.asarray(jl)[0, -1])))
    ptrs = {n: t.data_ptr() for n, t in tcache.items()}
    tok = np.asarray(nxt, np.int32)[:, None]
    pos = np.asarray([len(p) for p in prompts], np.int32)
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
    for name in ("ssm", "conv"):
        _close(tcache[name], jcache[name])


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


@pytest.mark.parametrize("fused,chunk,kw", [
    (True, 1, {}), (True, 4, {}), (False, 1, {}),
    (True, 2, {"prefill_chunk_tokens": 4})])   # prefills whole anyway
def test_engine_token_identity_with_jax(pair, fused, chunk, kw):
    jm, params, tm, tp = pair()
    prompts = _prompts(tm.cfg.vocab, 6, 3)          # 3 requests, 2 slots
    want, jeng = _run(ServeEngine, Request, jm, params, prompts, 6,
                      fused=fused, decode_chunk=chunk, **kw)
    got, teng = _run(TServeEngine, TRequest, tm, tp, prompts, 6,
                     fused=fused, decode_chunk=chunk, **kw)
    assert got == want, (fused, chunk, got, want)
    assert all(len(t) == 6 for t in got)
    assert teng.scheduler.ptt.updates == jeng.scheduler.ptt.updates
    assert not teng.prefilling and not teng._chunking()


@pytest.mark.parametrize("plen", [1, 2, 3])
def test_short_prompts_match_jax(pair, plen):
    """A prompt of 1 or 2 tokens leaves a conv state of 1 or 2 rows, which
    both packages' ``insert_session`` zero-pad after its rows; 3 fills
    the ``K-1 = 3`` rows."""
    jm, params, tm, tp = pair()
    prompts = _prompts(tm.cfg.vocab, plen, 3, seed=20)
    _, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(prompts[0])[None]})
    assert tpc["conv"].shape[2] == plen
    for chunk in (1, 4):
        want, _ = _run(ServeEngine, Request, jm, params, prompts, 5,
                       decode_chunk=chunk)
        got, _ = _run(TServeEngine, TRequest, tm, tp, prompts, 5,
                      decode_chunk=chunk)
        assert got == want, (plen, chunk, got, want)


def _engines(pair_entry, kinds):
    jm, params, tm, tp = pair_entry

    def engine(kind, **kw):
        if kind == "jax":
            return ServeEngine(jm, params, max_batch=2, max_seq=MAX_SEQ,
                               decode_chunk=2, **kw), Request
        return TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                            decode_chunk=2, **kw), TRequest
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
    """A session exported after one decode chunk (its whole SSM and conv
    state, float32) continues the unmigrated JAX stream."""
    jm, params, tm, tp = pair()
    prompt = _prompts(tm.cfg.vocab, 6, 1, seed=7)[0]
    (j, jreq), = _engines(pair(), ["jax"])
    want = _unmigrated(j, jreq, prompt)
    (a, req_cls), (b, _) = _engines(pair(), [src, dst])
    got = _migrated(a, req_cls, b, prompt, how)
    assert got == want, (src, dst, how, got, want)


@pytest.mark.parametrize("direction", ("jax->port", "port->jax"))
def test_bf16_sessions_cross_the_packages_over_the_wire(pair, direction):
    """bfloat16: the conv leaf travels as ``"bfloat16"`` bits and the ssm
    leaf as float32.  Over the wire the destination resumes exactly as
    from the session handed over in process with its bits intact, and
    that is the unmigrated stream, on which the two packages agree for
    this prompt."""
    entry = pair("bfloat16")
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
    t, _ = _engines(entry, ["port"])[0]
    t.submit(TRequest(rid=0, prompt=prompt.copy(), max_new=8))
    t.step()
    sess = t.export_session(0)
    assert sess.cache["conv"].dtype == np.uint16
    assert sess.cache["ssm"].dtype == np.float32
    # the whole state at any position: no axis trimmed
    spec = entry[2].cache_spec(1, MAX_SEQ)
    assert {n: a.shape for n, a in sess.cache.items()} == {
        n: shape for n, (shape, _) in spec.items()}


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


# ---------------------------------------------------------------------------
# checkpoints and conversion
# ---------------------------------------------------------------------------

def _files(step_dir):
    return {name: open(os.path.join(step_dir, name), "rb").read()
            for name in sorted(os.listdir(step_dir))}


def test_checkpoint_byte_identical_and_cross_loading(pair, tmp_path):
    """The reference's parameter tree written by the JAX package and the
    same parameters written by the port from its modules give the same
    files; each package loads the other's into the same model."""
    jm, params, tm, tp = pair()
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
    for (n, a), (_, b) in zip(tp.named_parameters(), tp2.named_parameters()):
        assert torch.equal(a, b), n
    jparams, _ = jstore.load_checkpoint(str(tmp_path / "port"), 4, params)
    tokens = np.random.default_rng(1).integers(0, tm.cfg.vocab, (1, 9))
    jl, _ = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl, 1e-5, 1e-5)


def test_params_to_numpy_inverts_params_from_numpy(pair):
    _, params, tm, tp = pair()
    tree = jax.tree.map(np.asarray, params)
    back = params_to_numpy(tm.cfg, params_from_numpy(tm.cfg, tree, "cpu"))
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.float32, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
