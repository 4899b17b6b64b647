"""The serving engine's own spans and counters (``serve/engine.py``), the
model bodies' spans inside a whole prefill (``models/transformer.py``,
``models/moe.py``) and the tracer's map onto ``torch.profiler``'s clock
(``obs/trace.py``), on tiny engines on the CPU:

* every child lies inside its parent (``step`` > ``prefill``,
  ``prefill-chunk``, ``decode.launch``, ``decode.wait``, ``trace.record``;
  ``prefill`` > ``prefill.dispatch`` > ``attn``, ``moe.*``), and self
  times are not negative;
* the tracer's recording inside a step falls in its ``trace.record``;
* a step's ``ptt_updates`` are the PTT calls it made;
* ``step`` spans survive sampling;
* under the null tracer nothing is recorded and the model bodies' context
  stays unset, and every graph cell's build (``FusedDecode``,
  ``ChunkPrefill``, ``StepDecode``, ``TrainGraph``) runs with it unset;
* ``trace_ns`` maps a span onto the profiler's stamps of the block it
  wraps.

Weights are drawn at random: the spans do not depend on the tokens."""

import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, widen_heads
from repro_torch.models import get_model, graphs
from repro_torch.models import moe as moe_mod
from repro_torch.obs import NULL_TRACER, SpanTracer
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.engine import Request, ServeEngine

CPU = torch.device("cpu")
EPS = 1e-9                       # float rounding of ts + dur
STEP_CHILDREN = ("prefill", "prefill-chunk", "decode.launch", "decode.wait",
                 "trace.record")
MODEL_SPANS = ("attn", "moe.route", "moe.dispatch", "moe.experts",
               "moe.combine")
# (config, prefill_chunk_tokens, fused)
ENGINES = {"moe": ("granite-moe-1b-a400m", 0, True),
           "dense": ("qwen2-0.5b", 0, True),
           "dense-legacy": ("qwen2-0.5b", 0, False),
           "dense-chunked": ("qwen2-0.5b", 8, True)}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in ("granite-moe-1b-a400m", "qwen2-0.5b"):
        cfg = widen_heads(get_config(name, reduced=True))
        m = get_model(cfg)
        out[name] = (m, m.init(torch.Generator().manual_seed(0), CPU))
    return out


def _engine(models, kind, tracer=None):
    name, chunk, fused = ENGINES[kind]
    m, p = models[name]
    eng = ServeEngine(m, p, max_batch=2, max_seq=64, decode_chunk=2,
                      fused=fused, prefill_chunk_tokens=chunk)
    if tracer is not None:
        eng.attach_obs(tracer=tracer, name="e0")
    return eng


def _serve(eng, rids=range(4)):
    vocab = eng.model.cfg.vocab
    for rid in rids:
        eng.submit(Request(rid=rid, prompt=np.arange(5 + 6 * rid) % vocab,
                           max_new=5))
    eng.run_until_drained(200)


def _end(e):
    return e["ts"] + e["dur"]


def _inside(child, parent):
    return (parent["ts"] - EPS <= child["ts"]
            and _end(child) <= _end(parent) + EPS)


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_children_lie_inside_their_parents(models, kind):
    tr = SpanTracer("t")
    _serve(_engine(models, kind, tr))
    ev = list(tr.events)
    steps = {(e["track"], e["args"]["step"]): e for e in ev
             if e["name"] == "step"}
    assert sorted(no for _, no in steps) == list(range(1, len(steps) + 1))
    kids = {}
    for e in ev:
        if e["name"] in STEP_CHILDREN:
            parent = steps[(e["track"], e["args"]["step"])]
            assert _inside(e, parent), e
            kids.setdefault((e["track"], e["args"]["step"]), []).append(e)
    for key, st in steps.items():
        own = st["dur"] - sum(e["dur"] for e in kids.get(key, []))
        assert own >= 0, st
        assert st["args"]["prefills"] == sum(
            e["name"] == "prefill" for e in kids.get(key, []))
        assert sum(e["name"] == "trace.record"
                   for e in kids.get(key, [])) == 1
    prefills = {(e["trace"], e["args"]["step"]): e for e in ev
                if e["name"] == "prefill"}
    dispatch = {(e["trace"], e["args"]["step"]): e for e in ev
                if e["name"] == "prefill.dispatch"}
    assert set(dispatch) == set(prefills)
    for key, e in dispatch.items():
        assert _inside(e, prefills[key])
        assert e["dur"] <= prefills[key]["dur"] + EPS
    body = [e for e in ev if e["name"] in MODEL_SPANS]
    for e in body:
        assert _inside(e, dispatch[(e["trace"], e["args"]["step"])]), e
    layers = models[ENGINES[kind][0]][0].cfg.n_layers
    names = [e["name"] for e in body]
    if kind == "moe":
        per = ("attn", "moe.route", "moe.dispatch", "moe.experts",
               "moe.combine")
    elif kind == "dense-chunked":
        per = ()                 # chunks run in their cell, not eagerly
    else:
        per = ("attn",)
    for name in MODEL_SPANS:
        want = layers * len(prefills) if name in per else 0
        assert names.count(name) == want, name
    assert len(prefills) == (0 if kind == "dense-chunked" else 4)
    assert any(e["name"] == "prefill-chunk" for e in ev) == (
        kind == "dense-chunked")


@pytest.mark.parametrize("kind", ["moe", "dense-chunked"])
def test_the_steps_recording_falls_in_its_trace_record(models, kind):
    """Every span the engine records for a step (its children, the
    requests' ``decode-chunk`` spans) is recorded inside that step's
    ``trace.record``, so ``step`` less its children leaves the tracer's
    own cost out; the model bodies' spans are recorded inside their
    prefill."""
    tr = SpanTracer("t")
    calls = []
    complete = tr.complete

    def timed(name, *a, **kw):
        calls.append((name, time.perf_counter()))
        return complete(name, *a, **kw)
    tr.complete = timed
    _serve(_engine(models, kind, tr))
    ev = list(tr.events)
    steps = sorted((e for e in ev if e["name"] == "step"),
                   key=lambda e: e["ts"])
    record = {e["args"]["step"]: e for e in ev
              if e["name"] == "trace.record"}
    held = [c for c in calls if c[0] not in ("step", "trace.record")
            and c[0] not in MODEL_SPANS]
    assert any(n == "decode-chunk" for n, _ in held)
    for name, t in held:
        st = next(e for e in steps if e["ts"] <= t <= _end(e))
        rec = record[st["args"]["step"]]
        assert rec["ts"] <= t <= _end(rec), name
    for name, t in calls:
        if name in MODEL_SPANS:
            assert any(e["ts"] <= t <= _end(e) for e in ev
                       if e["name"] == "prefill"), name


@pytest.mark.parametrize("kind", ["moe", "dense-chunked", "dense-legacy"])
def test_ptt_updates_are_the_steps_ptt_calls(models, kind):
    tr = SpanTracer("t")
    eng = _engine(models, kind, tr)
    calls = []
    sched = eng.scheduler
    for name in ("schedule_prefill", "schedule_decode", "record"):
        def counted(*a, _f=getattr(sched, name), _n=name, **kw):
            calls.append(_n)
            return _f(*a, **kw)
        setattr(sched, name, counted)
    vocab = eng.model.cfg.vocab
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=np.arange(9 + 5 * rid) % vocab,
                           max_new=4))
    made, busy = [], True
    while busy:
        busy = eng.step() or eng.pending()
        made.append(len(calls) - sum(made))
    steps = [e for e in tr.events if e["name"] == "step"]
    assert [e["args"]["ptt_updates"] for e in steps] == made
    assert sum(made) == len(calls) > 0
    assert calls.count("record") == (calls.count("schedule_prefill")
                                     + calls.count("schedule_decode"))
    for e in steps:
        assert (e["args"]["ptt_ns"] > 0) == (e["args"]["ptt_updates"] > 0)


def test_step_spans_survive_sampling(models):
    tr = SpanTracer("t", sample_rate=4)
    eng = _engine(models, "moe", tr)
    _serve(eng, rids=range(1, 6))
    ev = list(tr.events)
    steps = [e for e in ev if e["name"] == "step"]
    assert steps and all(e["trace"] == "e0" for e in steps)
    assert sum(e["args"]["prefills"] for e in steps) == 5
    # only rid 4 is sampled in: its prefill and its model spans alone
    assert {e["trace"] for e in ev if e["name"] == "prefill"} == {"t/r4"}
    assert {e["trace"] for e in ev if e["name"] in MODEL_SPANS} == {"t/r4"}
    assert sum(e["name"] == "decode.launch" for e in ev) == sum(
        e["args"]["k"] > 0 for e in steps)


def test_null_tracer_records_nothing_and_leaves_the_context_unset(
        models, monkeypatch):
    recorded, seen = [], []
    for name in ("complete", "instant", "span", "anchor"):
        def rec(self, *a, _n=name, **kw):
            recorded.append(_n)
        monkeypatch.setattr(SpanTracer, name, rec)
    route = moe_mod.route

    def watched(cfg, router, x2d):
        seen.append((x2d.shape[0], obs_trace._MODEL.get()))
        return route(cfg, router, x2d)
    monkeypatch.setattr(moe_mod, "route", watched)
    eng = _engine(models, "moe")
    assert eng.tracer is NULL_TRACER
    _serve(eng)
    assert recorded == [] and seen and all(c is None for _, c in seen)
    assert obs_trace._MODEL.get() is None
    assert obs_trace.model_span("attn") is obs_trace._NO_SPAN
    # the same run traced: the context is set inside each prefill (5 or
    # more tokens routed) and unset in every decode (the batch's 2)
    monkeypatch.undo()
    monkeypatch.setattr(moe_mod, "route", watched)
    seen.clear()
    tr = SpanTracer("t")
    _serve(_engine(models, "moe", tr))
    assert {n > 2 for n, _ in seen} == {True, False}
    assert all((c is not None and c[0] is tr) == (n > 2) for n, c in seen)
    assert obs_trace._MODEL.get() is None


def _outer(tr):
    return obs_trace.model_spans(tr, "t/r0", "e0", step=1)


def test_every_graph_build_runs_with_the_context_unset():
    """The builds of the four cell kinds, each called with a tracer set
    around it: the eager first run (and on the card the capture, in the
    same ``with``) sees none, and the caller's is restored after."""
    tr, seen, params = SpanTracer("t"), [], torch.nn.Module()
    tok = torch.zeros((2, 1), dtype=torch.long)
    pos = torch.zeros(2, dtype=torch.int32)
    cache = {"k": torch.zeros(2, 3)}

    def decode(params, token, pos, cache, k=None):
        seen.append(obs_trace._MODEL.get())
        return (token.clone(), cache) if k is None else (
            token.repeat(1, k), token, pos, cache)

    def chunk(params, tokens, cache, start, qlen):
        seen.append(obs_trace._MODEL.get())
        return tokens[:, :1].float(), cache

    def train(step, tokens, labels, state):
        seen.append(obs_trace._MODEL.get())
        return tokens.sum(), labels.sum(), torch.ones(()), state

    with _outer(tr):
        graphs.FusedDecode(decode)(params, tok, pos, cache, 2)
        graphs.FusedDecode(decode).prepare(params, tok, pos, cache, 3)
        graphs.StepDecode(decode)(params, tok, pos, cache)
        graphs.ChunkPrefill(chunk)(params, tok, cache, pos, pos)
        graphs.TrainGraph(train, 2)(torch.nn.Module(), tok, tok, cache)
        assert obs_trace._MODEL.get()[0] is tr
    assert len(seen) == 5 and all(c is None for c in seen)
    assert obs_trace._MODEL.get() is None


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_the_engines_cells_never_see_the_tracer(models, kind, monkeypatch):
    """A traced engine's decode and chunk cells run their bodies (the
    build, and on the CPU every call) with the context unset."""
    seen = []
    body = graphs.Graphed._body

    def watched(self, *a):
        seen.append(obs_trace._MODEL.get())
        return body(self, *a)
    monkeypatch.setattr(graphs.Graphed, "_body", watched)
    _serve(_engine(models, kind, SpanTracer("t")))
    assert seen and all(c is None for c in seen)


def test_trace_ns_maps_onto_the_profilers_clock():
    """Under the CPU ``torch.profiler``, a ``SpanTracer`` span around a
    ``record_function`` block maps by ``trace_ns`` onto the profiler's
    stamps of that block within 200 us: each stamp lies between the mapped
    span's edge and the tracer's clock read just inside the block (those
    two bracket the moment, whatever ``record_function`` itself costs on a
    loaded CPU), give or take 200 us."""
    tr = SpanTracer("t")
    tr.anchor()
    inner = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with tr.span("block", i=i):
                with torch.profiler.record_function(f"spans.block{i}"):
                    t_in = tr.clock()
                    time.sleep(0.002)
                    t_out = tr.clock()
            inner.append((tr.trace_ns(t_in), tr.trace_ns(t_out)))
            time.sleep(0.005)
    blocks = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("spans.block")}
    spans = [e for e in tr.events if e["name"] == "block"]
    assert len(spans) == len(inner) == len(blocks) == 20
    tol = 200_000
    for e, (t_in, t_out) in zip(spans, inner):
        a, b = blocks[f"spans.block{e['args']['i']}"]
        lo, hi = tr.trace_ns(e["ts"]), tr.trace_ns(e["ts"] + e["dur"])
        assert lo - tol <= a <= t_in + tol, (a - lo, t_in - a)
        assert t_out - tol <= b <= hi + tol, (b - t_out, hi - b)
