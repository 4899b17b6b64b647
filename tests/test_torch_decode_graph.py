"""``Model.decode_fused`` as cells (``repro_torch.models.graphs``) on the
CPU, held against the JAX package's ``decode_fused`` (one jitted
``lax.scan`` per (batch, chunk) cell) with the same weights, carried over
by ``params_from_numpy``, and against the port's own eager loop
(``decode_fused.eager``):

* each of the five serving families' reduced configs swept over batches
  (2, 3) x chunks (1, 4), two calls a cell, from a seeded random cache:
  tokens, next tokens and positions equal to the reference's, and to the
  eager loop's bit for bit, caches within 1e-4 of the reference's and
  equal to the eager loop's, every ``data_ptr`` kept; the port's cells
  built equal the reference's ``_cache_size()``, 4;
* the port's ``audit_retrace`` clean on each family and flagging a decode
  whose key is unstable once; a host read inside the body flagged;
* two caches on one model: two cells, each stream its solo stream;
  tensors one call returned unchanged by the next; a cell dropped with
  its cache, and freed only after a capture running then; the SSM's first call advancing the state k steps, not 2k;
  no cell under a cost counter;
* ``ServeEngine``'s build of its decode cell before traffic (on the card
  as it allocates its cache; called here by hand): the steps replay it and
  the streams are those of an engine without it, for the dense and the
  SSM family; the kernels' counter registry.

On the CPU a cell captures nothing and runs the loop eagerly over its
static buffers; the graph itself is exercised on the card by
``chip_smoke.py``.  Float32 on both sides; tokens are exact, the cache
tolerance covers summation order only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import get_model
from repro_torch.analysis import audit as A
from repro_torch.configs import get_config as tget_config
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import params_from_numpy

SEQ = 16
TOL = 1e-4
VLM_GATES = {"gate_attn": [0.7, 0.5], "gate_mlp": [-0.4, 0.3]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """Per arch: the reference (model, params) and the port's, same
    weights (reduced configs; the vlm's cross gates nonzero, so its cross
    cache reaches the tokens); built once per module."""
    built = {}

    def get(arch):
        if arch not in built:
            jm = get_model(get_config(arch, reduced=True))
            params = jax.jit(lambda key: jm.init(key)[0])(
                jax.random.PRNGKey(0))
            tree = jax.tree.map(np.asarray, params)
            if jm.cfg.family == "vlm":
                for name, vals in VLM_GATES.items():
                    tree["cross_layers"][name] = np.asarray(vals, np.float32)
                params = jax.tree.map(jnp.asarray, tree)
            tc = tget_config(arch, reduced=True)
            built[arch] = (jm, params, tget_model(tc),
                           params_from_numpy(tc, tree, "cpu"))
        return built[arch]
    return get


def _inputs(spec, B: int, seed: int):
    """A random cache (numpy leaves), (B, 1) tokens and (B,) positions
    that leave room for 10 steps in ``SEQ`` rows."""
    rng = np.random.default_rng(seed)
    cache = {n: (0.5 * rng.standard_normal(tuple(s.shape))).astype(s.dtype)
             for n, s in spec.items()}
    tok = rng.integers(0, 64, (B, 1)).astype(np.int32)
    pos = rng.integers(0, SEQ - 10, B).astype(np.int32)
    return cache, tok, pos


def _port(cache, tok, pos):
    return ({n: torch.from_numpy(a.copy()) for n, a in cache.items()},
            torch.from_numpy(tok).long(), torch.from_numpy(pos))


@pytest.mark.parametrize("arch", A.FAMILY_ARCHS)
def test_cells_match_the_reference_and_the_eager_loop(pair, arch):
    jm, params, tm, tp = pair(arch)
    fused = tm.decode_fused
    built0 = fused.cells()
    caches = []                         # every cell's cache stays alive
    for B in A.BATCH_SHAPES:
        npc, tok, pos = _inputs(jm.cache_spec(B, SEQ), B, seed=B)
        jcache = {n: jnp.asarray(a) for n, a in npc.items()}
        jtok, jpos = jnp.asarray(tok), jnp.asarray(pos)
        tcache, ttok, tpos = _port(npc, tok, pos)
        ecache, etok, epos = _port(npc, tok, pos)
        caches.append(tcache)
        ptrs = {n: t.data_ptr() for n, t in tcache.items()}
        for k in A.DECODE_CHUNKS:
            for _ in range(2):
                jtoks, jtok, jpos, jcache = jm.decode_fused(
                    params, jtok, jpos, jcache, k)
                toks, ttok, tpos, out = fused(tp, ttok, tpos, tcache, k)
                etoks, etok, epos, ecache = fused.eager(tp, etok, epos,
                                                        ecache, k)
                assert out is tcache
                assert {n: t.data_ptr() for n, t in out.items()} == ptrs
                assert toks.tolist() == np.asarray(jtoks).tolist(), (B, k)
                assert ttok.tolist() == np.asarray(jtok).tolist()
                assert tpos.tolist() == np.asarray(jpos).tolist()
                assert torch.equal(toks, etoks) and torch.equal(ttok, etok)
                assert torch.equal(tpos, epos)
        for n, t in tcache.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jcache[n]),
                                       atol=TOL, rtol=TOL, err_msg=n)
            assert torch.equal(t, ecache[n]), n
    assert fused.cells() - built0 == jm.decode_fused._cache_size() == 4
    assert fused.live() >= 4
    assert A.audit_retrace(tm, tp) == []


def test_unstable_key_breaks_the_retrace_budget(pair):
    _, _, tm, tp = pair("qwen2-0.5b")
    fused = tm.decode_fused

    def unstable(params, tok, pos, cache, k):
        # a new cache each call: a new key, so a new cell, every call
        copy = {n: t.clone() for n, t in cache.items()}
        toks, nxt, pos, copy = fused(params, tok, pos, copy, k)
        for n, t in cache.items():
            t.copy_(copy[n])
        return toks, nxt, pos, cache
    unstable.cells = fused.cells
    bad = dataclasses.replace(tm, decode_fused=unstable)
    found = A.audit_retrace(bad, tp)
    assert [f.rule for f in found] == ["retrace-budget"]
    assert "compiled 8 executables across 4" in found[0].message
    # the eager loop has no cells to count: nothing to say, as the
    # reference says nothing of a jit without _cache_size
    eager = dataclasses.replace(tm, decode_fused=fused.eager)
    assert A.audit_retrace(eager, tp) == []


def test_host_read_inside_the_cell_is_flagged(pair):
    from repro_torch.models.graphs import FusedDecode
    _, _, tm, tp = pair("qwen2-0.5b")
    loop = tm.decode_fused.eager

    def reads_host(params, tok, pos, cache, k):
        out = loop(params, tok, pos, cache, k)
        if out[0][0, 0].item() < 0:
            raise AssertionError
        return out
    bad = dataclasses.replace(tm, decode_fused=FusedDecode(reads_host))
    assert [f.rule for f in A.audit_decode_fused(bad, tp)] == ["host-sync"]


def _solo(tm, tp, npc, tok, pos, steps, k):
    cache, t, p = _port(npc, tok, pos)
    out = []
    for _ in range(steps):
        toks, t, p, cache = tm.decode_fused.eager(tp, t, p, cache, k)
        out.append(toks)
    return torch.cat(out, 1)


def test_two_caches_two_cells_each_its_own_stream(pair):
    jm, _, tm, tp = pair("qwen2-0.5b")
    fused = tm.decode_fused
    built0 = fused.cells()
    npa, toka, posa = _inputs(jm.cache_spec(2, SEQ), 2, seed=11)
    npb, tokb, posb = _inputs(jm.cache_spec(2, SEQ), 2, seed=12)
    ca, ta, pa = _port(npa, toka, posa)
    cb, tb, pb = _port(npb, tokb, posb)
    got_a, got_b = [], []
    for _ in range(3):                  # interleaved, as two engines step
        toks, ta, pa, ca = fused(tp, ta, pa, ca, 2)
        got_a.append(toks)
        toks, tb, pb, cb = fused(tp, tb, pb, cb, 2)
        got_b.append(toks)
    assert fused.cells() - built0 == 2
    assert torch.equal(torch.cat(got_a, 1), _solo(tm, tp, npa, toka, posa,
                                                  3, 2))
    assert torch.equal(torch.cat(got_b, 1), _solo(tm, tp, npb, tokb, posb,
                                                  3, 2))


def test_returned_tensors_survive_the_next_call(pair):
    jm, _, tm, tp = pair("qwen2-0.5b")
    npc, tok, pos = _inputs(jm.cache_spec(3, SEQ), 3, seed=21)
    cache, t, p = _port(npc, tok, pos)
    first = tm.decode_fused(tp, t, p, cache, 4)
    kept = [x.clone() for x in first[:3]]
    for _ in range(2):                  # the replays reuse the cell
        nxt = tm.decode_fused(tp, first[1], first[2], cache, 4)
        assert all(a.data_ptr() != b.data_ptr()
                   for a, b in zip(first[:3], nxt[:3]))
    for a, b in zip(first[:3], kept):
        assert torch.equal(a, b)


def test_cell_is_dropped_with_its_cache(pair):
    jm, _, tm, tp = pair("qwen2-0.5b")
    fused = tm.decode_fused
    npc, tok, pos = _inputs(jm.cache_spec(2, SEQ), 2, seed=31)
    cache, t, p = _port(npc, tok, pos)
    live0, built0 = fused.live(), fused.cells()
    fused(tp, t, p, cache, 1)
    assert (fused.live(), fused.cells()) == (live0 + 1, built0 + 1)
    del cache
    assert fused.live() == live0 and fused.cells() == built0 + 1


def test_cell_dropped_during_a_capture_is_freed_after_it(pair):
    from repro_torch.models import graphs
    jm, _, tm, tp = pair("qwen2-0.5b")
    fused = tm.decode_fused
    npc, tok, pos = _inputs(jm.cache_spec(2, SEQ), 2, seed=32)
    cache, t, p = _port(npc, tok, pos)
    fused(tp, t, p, cache, 1)
    live0 = fused.live()
    with graphs._no_graph_dies():       # what a capture runs under
        del cache
        assert fused.live() == live0 - 1
        assert len(graphs._held) == 1   # its graph is not destroyed yet
    assert graphs._held == []


@pytest.mark.parametrize("k", [1, 4])
def test_ssm_first_call_advances_the_state_once(pair, k):
    jm, params, tm, tp = pair("mamba2-130m")
    npc, tok, pos = _inputs(jm.cache_spec(2, SEQ), 2, seed=41 + k)
    jtoks, _, _, jcache = jm.decode_fused(
        params, jnp.asarray(tok), jnp.asarray(pos),
        {n: jnp.asarray(a) for n, a in npc.items()}, k)
    cache, t, p = _port(npc, tok, pos)
    built0 = tm.decode_fused.cells()
    toks, _, _, cache = tm.decode_fused(tp, t, p, cache, k)
    assert tm.decode_fused.cells() == built0 + 1      # this call built it
    assert toks.tolist() == np.asarray(jtoks).tolist()
    for n in ("ssm", "conv"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]),
                                   atol=TOL, rtol=TOL, err_msg=n)


def test_no_cell_under_a_cost_counter(pair):
    from repro_torch.distributed.cost import CostCounter
    jm, _, tm, tp = pair("qwen2-0.5b")
    npc, tok, pos = _inputs(jm.cache_spec(2, SEQ), 2, seed=51)
    cache, t, p = _port(npc, tok, pos)
    built0 = tm.decode_fused.cells()
    with torch.no_grad(), CostCounter() as c:
        toks, _, _, _ = tm.decode_fused(tp, t, p, cache, 2)
    assert tm.decode_fused.cells() == built0
    assert c.calls == {"ragged_decode": 2 * tm.cfg.n_layers}
    assert torch.equal(toks, _solo(tm, tp, npc, tok, pos, 1, 2))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_engine_builds_its_cell_before_traffic(pair, arch):
    from repro_torch.serve import Request, ServeEngine
    _, _, tm, tp = pair(arch)
    fused = tm.decode_fused
    rng = np.random.default_rng(61)
    prompts = [rng.integers(0, tm.cfg.vocab, n) for n in (5, 9, 3)]

    def run(prepared):
        eng = ServeEngine(tm, tp, max_batch=2, max_seq=32, decode_chunk=2)
        built0 = fused.cells()
        eng._ensure_cache()
        assert fused.cells() == built0      # the CPU builds nothing here
        if prepared:
            eng._prepare_decode()            # what the card does here
            assert fused.cells() == built0 + 1
        reqs = [Request(rid=i, prompt=p, max_new=7)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        assert all(r.done for r in reqs)
        # the steps replay the cell built before them; without it the
        # first step builds it
        assert fused.cells() == built0 + 1
        return [list(r.out_tokens) for r in reqs]
    # the build's throwaway decode of the idle cache changes no stream
    assert run(True) == run(False)


def test_every_counter_is_registered():
    import importlib

    from repro_torch.kernels import counters
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ragged_decode import ops as rd
    from repro_torch.models import moe  # noqa: F401  (registers a2a_calls)

    # a module registers its counters as it is imported
    for name in ("matmul", "stream_copy", "bitonic_sort"):
        importlib.import_module(f"repro_torch.kernels.{name}.ops")
    keys = set(counters.snapshot())
    k = "repro_torch.kernels."
    assert {(k + "ragged_decode.ops", "launches"),
            (k + "ragged_prefill.ops", "launches"),
            (k + "flash_attention.ops", "launches"),
            (k + "flash_attention.ops", "bwd_launches"),
            (k + "flash_attention.ops", "dout_copies"),
            (k + "matmul.ops", "launches"),
            (k + "stream_copy.ops", "copy_launches"),
            (k + "stream_copy.ops", "scale_add_launches"),
            (k + "bitonic_sort.ops", "launches"),
            ("repro_torch.models.moe", "a2a_calls")} <= keys
    before = counters.snapshot()
    moved = {(k + "ragged_decode.ops", "launches"): 3,
             (k + "flash_attention.ops", "dout_copies"): 1}
    counters.add(moved, times=2)
    assert counters.since(before) == {key: 2 * n for key, n in moved.items()}
    counters.add(moved, times=-2)
    assert counters.since(before) == {}
    assert (rd.launches, fa.dout_copies) == (
        before[(k + "ragged_decode.ops", "launches")],
        before[(k + "flash_attention.ops", "dout_copies")])
