"""``Model.prefill_chunk`` and ``Model.decode_step`` as cells
(``repro_torch.models.graphs``) on the CPU, and the chunked engine's one
working prefill cache, held against the JAX package (reduced qwen2-0.5b
and smollm-135m, the reference's ``init`` carried over by
``params_from_numpy``) and against the port's own eager bodies:

* the chunk cell chunk by chunk over prompts longer than two chunks at
  per-slot starts: logits within 1e-4 and both cache leaves within 1e-5
  of the reference's jitted ``prefill_chunk`` (``tests/test_torch_disagg.py``'s
  tolerances), bit for bit ``prefill_chunk.eager``'s, one cell built;
* ``decode_step`` step by step: logits within 1e-4 and caches within 1e-4
  of the reference's ``decode_jit`` (``tests/test_torch_decode_graph.py``'s
  tolerance), bit for bit ``decode_step.eager``'s, one cell built; the
  legacy engine (``fused=False``) on it, streams the reference's;
* the chunked engine: 16 requests give the JAX chunked engine's streams
  with one chunk cell built; a prefill exported mid-way and imported back
  into the same engine, a drain, and a kill and restart (which builds
  exactly one more cell) each give the same streams;
* a cell dropped with its engine; no cell under a cost counter.

On the CPU a cell captures nothing and runs its body eagerly over its
static buffers; the graphs themselves are exercised on the card by
``chip_smoke.py``.  Float32 on both sides; tokens are exact, the
tolerances cover summation order only.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import get_model
from repro.serve import Request, ServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.distributed.cost import CostCounter
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

ARCHS = ("qwen2-0.5b", "smollm-135m")
MAX_SEQ = 32
CHUNK = 4
MAX_NEW = 5
N_REQ = 16
LOGIT_TOL, CACHE_TOL, DECODE_TOL = 1e-4, 1e-5, 1e-4


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
    built = {}

    def get(arch):
        if arch not in built:
            jm = get_model(get_config(arch, reduced=True))
            params = jax.jit(lambda key: jm.init(key)[0])(
                jax.random.PRNGKey(0))
            tc = tget_config(arch, reduced=True)
            built[arch] = (jm, params, tget_model(tc),
                           params_from_numpy(tc, jax.tree.map(np.asarray,
                                                              params), "cpu"))
        return built[arch]
    return get


def _prompts(vocab: int, n: int = N_REQ, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(5, 15)))
            for _ in range(n)]


def _run(engine, req_cls, prompts, steps: int = 2000) -> list:
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained(max_steps=steps)
    assert all(r.done for r in reqs)
    return reqs


@pytest.fixture(scope="module")
def jax_streams(pair):
    """The reference chunked engine's streams of :func:`_prompts`, per
    arch, run once."""
    got = {}

    def get(arch):
        if arch not in got:
            jm, params, tm, _ = pair(arch)
            eng = ServeEngine(jm, params, max_batch=2, max_seq=MAX_SEQ,
                              prefill_chunk_tokens=CHUNK)
            reqs = _run(eng, Request, _prompts(tm.cfg.vocab))
            got[arch] = [list(r.out_tokens) for r in reqs]
        return got[arch]
    return get


def _chunked(tm, tp, **kw):
    return TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                        prefill_chunk_tokens=CHUNK, **kw)


# ---------------------------------------------------------------------------
# the cells against the reference's jitted entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_cell_matches_the_reference_chunk_by_chunk(pair, arch):
    jm, params, tm, tp = pair(arch)
    rng = np.random.default_rng(1)
    lens, base = (11, 9), (0, 3)        # slot 1 starts 3 rows in
    prompts = [rng.integers(0, tm.cfg.vocab, n) for n in lens]
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_spec(2, MAX_SEQ))
    spec = tm.cache_spec(2, MAX_SEQ).items()
    tcache = {n: torch.zeros(s, dtype=dt) for n, (s, dt) in spec}
    ecache = {n: torch.zeros(s, dtype=dt) for n, (s, dt) in spec}
    ptrs = {n: t.data_ptr() for n, t in tcache.items()}
    cell = tm.prefill_chunk
    built0 = cell.cells()
    for c in range(3):                  # 3 chunks of 4: 11 and 9 tokens
        chunk = np.zeros((2, CHUNK), np.int32)
        qlen = np.asarray([min(max(n - c * CHUNK, 0), CHUNK) for n in lens],
                          np.int32)
        for b, p in enumerate(prompts):
            chunk[b, :qlen[b]] = p[c * CHUNK:c * CHUNK + qlen[b]]
        start = np.asarray([s + c * CHUNK for s in base], np.int32)
        jl, jcache = jm.prefill_chunk(params, jnp.asarray(chunk), jcache,
                                      jnp.asarray(start), jnp.asarray(qlen))
        targs = (torch.from_numpy(chunk).long(), torch.from_numpy(start),
                 torch.from_numpy(qlen))
        tl, out = cell(tp, targs[0], tcache, *targs[1:])
        el, ecache = cell.eager(tp, targs[0], ecache, *targs[1:])
        assert out is tcache
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        assert torch.equal(tl, el)
        for n in ("k", "v"):
            np.testing.assert_allclose(tcache[n].numpy(),
                                       np.asarray(jcache[n]),
                                       atol=CACHE_TOL, rtol=CACHE_TOL)
            assert torch.equal(tcache[n], ecache[n]), n
    assert {n: t.data_ptr() for n, t in tcache.items()} == ptrs
    assert cell.cells() - built0 == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_step_cell_matches_the_reference_decode_jit(pair, arch):
    jm, params, tm, tp = pair(arch)
    rng = np.random.default_rng(2)
    spec = jm.cache_spec(3, MAX_SEQ)
    npc = {n: (0.5 * rng.standard_normal(tuple(s.shape))).astype(s.dtype)
           for n, s in spec.items()}
    jcache = {n: jnp.asarray(a) for n, a in npc.items()}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in npc.items()}
    ecache = {n: torch.from_numpy(a.copy()) for n, a in npc.items()}
    tok = rng.integers(0, tm.cfg.vocab, (3, 1)).astype(np.int32)
    pos = np.asarray([2, 9, 17], np.int32)
    step = tm.decode_step
    built0 = step.cells()
    for _ in range(4):
        jl, jcache = jm.decode_jit(params, jnp.asarray(tok), jnp.asarray(pos),
                                   jcache)
        ttok, tpos = torch.from_numpy(tok).long(), torch.from_numpy(pos)
        tl, out = step(tp, ttok, tpos, tcache)
        el, ecache = step.eager(tp, ttok, tpos, ecache)
        assert out is tcache
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=DECODE_TOL, rtol=DECODE_TOL)
        assert torch.equal(tl, el)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        assert tok.tolist() == tl[:, -1].argmax(-1)[:, None].tolist()
        pos = pos + 1
    for n, t in tcache.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jcache[n]),
                                   atol=DECODE_TOL, rtol=DECODE_TOL,
                                   err_msg=n)
        assert torch.equal(t, ecache[n]), n
    assert step.cells() - built0 == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_legacy_engine_runs_on_the_step_cell(pair, arch):
    jm, params, tm, tp = pair(arch)
    prompts = _prompts(tm.cfg.vocab, n=4, seed=3)
    want = _run(ServeEngine(jm, params, max_batch=2, max_seq=MAX_SEQ,
                            fused=False), Request, prompts)
    step, fused = tm.decode_step, tm.decode_fused
    built0 = (step.cells(), fused.cells())
    eng = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, fused=False)
    got = _run(eng, TRequest, prompts)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert (step.cells(), fused.cells()) == (built0[0] + 1, built0[1])


# ---------------------------------------------------------------------------
# the chunked engine's working prefill cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_engine_builds_one_cell_for_16_requests(pair, jax_streams,
                                                        arch):
    _, _, tm, tp = pair(arch)
    built0 = tm.prefill_chunk.cells()
    eng = _chunked(tm, tp)
    chunks = []
    eng.on_prefill_latency = chunks.append
    reqs = _run(eng, TRequest, _prompts(tm.cfg.vocab))
    assert [list(r.out_tokens) for r in reqs] == jax_streams(arch)
    assert tm.prefill_chunk.cells() - built0 == 1
    prompts = _prompts(tm.cfg.vocab)
    assert len(chunks) == sum(-(-len(p) // CHUNK) for p in prompts)


@pytest.mark.parametrize("arch", ARCHS)
def test_export_mid_prefill_reimported_into_the_same_engine(pair,
                                                            jax_streams,
                                                            arch):
    _, _, tm, tp = pair(arch)
    prompts = _prompts(tm.cfg.vocab)
    long = [i for i, p in enumerate(prompts) if len(p) > 2 * CHUNK][:3]
    built0 = tm.prefill_chunk.cells()
    eng = _chunked(tm, tp)
    reqs = [TRequest(rid=i, prompt=prompts[i].copy(), max_new=MAX_NEW)
            for i in long]
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.step()                          # the head is 2 chunks in
    head = eng.prefilling[0].req
    sess = eng.export_prefill(head.rid)
    assert sess.prefilled == 2 * CHUNK
    assert all(x.shape[2] == 2 * CHUNK for x in sess.cache.values())
    eng.import_session(sess)            # back in, behind the others
    assert eng.prefilling[-1].req is head
    eng.run_until_drained(max_steps=500)
    want = jax_streams(arch)
    assert [list(r.out_tokens) for r in reqs] == [want[i] for i in long]
    assert tm.prefill_chunk.cells() - built0 == 1


def test_drain_then_kill_and_restart(pair, jax_streams):
    _, _, tm, tp = pair("smollm-135m")
    prompts = _prompts(tm.cfg.vocab)
    want = jax_streams("smollm-135m")
    built0 = tm.prefill_chunk.cells()
    eng = _chunked(tm, tp)
    reqs = [TRequest(rid=i, prompt=p.copy(), max_new=MAX_NEW)
            for i, p in enumerate(prompts[:6])]
    for r in reqs:
        eng.submit(r)
    for _ in range(8):
        eng.step()
    drained = eng.drain_queue()
    sessions = eng.drain_sessions()
    assert drained and eng.stats()["prefilling"] == 0
    other = _chunked(tm, tp)
    for s in sessions:
        other.import_session(s)
    for r in drained:
        other.submit(r)
    other.run_until_drained(max_steps=500)
    eng.run_until_drained(max_steps=500)
    assert [list(r.out_tokens) for r in reqs] == want[:6]
    assert tm.prefill_chunk.cells() - built0 == 2     # one an engine
    # a kill loses the working cache: the restart builds one more cell
    eng.crash()
    eng.restart()
    again = _run(eng, TRequest, prompts[6:10])
    assert [list(r.out_tokens) for r in again] == want[6:10]
    assert tm.prefill_chunk.cells() - built0 == 3


def test_cells_are_dropped_with_their_engine(pair):
    _, _, tm, tp = pair("qwen2-0.5b")
    chunk, fused = tm.prefill_chunk, tm.decode_fused
    live0 = (chunk.live(), fused.live())
    eng = _chunked(tm, tp)
    _run(eng, TRequest, _prompts(tm.cfg.vocab, n=3, seed=4))
    assert (chunk.live(), fused.live()) == (live0[0] + 1, live0[1] + 1)
    del eng
    gc.collect()
    assert (chunk.live(), fused.live()) == live0


def test_no_cell_under_a_cost_counter(pair):
    _, _, tm, tp = pair("qwen2-0.5b")
    L = tm.cfg.n_layers
    spec = tm.cache_spec(2, MAX_SEQ).items()
    cache = {n: torch.zeros(s, dtype=dt) for n, (s, dt) in spec}
    tokens = torch.ones((2, CHUNK), dtype=torch.long)
    start = torch.zeros(2, dtype=torch.int32)
    qlen = torch.full((2,), CHUNK, dtype=torch.int32)
    built0 = (tm.prefill_chunk.cells(), tm.decode_step.cells())
    with torch.no_grad(), CostCounter() as c:
        logits, _ = tm.prefill_chunk(tp, tokens, cache, start, qlen)
        tm.decode_step(tp, tokens[:, :1], qlen, cache)
    assert (tm.prefill_chunk.cells(), tm.decode_step.cells()) == built0
    assert c.calls == {"ragged_prefill": L, "ragged_decode": L}
    fresh = {n: torch.zeros(s, dtype=dt) for n, (s, dt) in spec}
    with torch.no_grad():
        want, _ = tm.prefill_chunk.eager(tp, tokens, fresh, start, qlen)
    assert torch.equal(logits, want)
