"""The port's fleet tier (``repro_torch.router``) over port engines on the
CPU, held against the JAX package with the same weights (carried over by
``params_from_numpy``) and the same prompts:

* the gateway end to end over two replicas (every request admitted and
  done, both replicas used, the FleetPTT and the detector trained);
* a mid-stream quarantine: every live session leaves the quarantined
  replica, and every stream equals the JAX engine's greedy stream;
* a session parked in a quarantined replica's import queue moved on
  before it decodes there;
* a seeded crash (``FaultInjector``) with heartbeats and a
  ``LoopbackTransport``: the TTFT-burn alert fires at pump 3 and clears
  at pump 8, and every victim finishes, token-identical to the JAX
  engine;
* a prefill-role replica handing every session to two decode replicas
  over a transport, token-identical to the JAX engine;
* the same crash through the JAX gateway gives the same alert ticks,
  counts and gateway counters.  Both runs read one fake clock (1 ms a
  read), monkeypatched into both engine modules' ``time`` and passed to
  both gateways: the interference detector quarantines on wall-clock step
  latencies, and a host stall in one run alone (a loaded test worker)
  would otherwise quarantine a replica there and not in the other.

Float32 on both sides.
"""

import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.chaos import FaultInjector as JFaultInjector
from repro.configs import get_config
from repro.models import get_model
from repro.obs import Objective as JObjective
from repro.obs import SLOMonitor as JSLOMonitor
from repro.region.transport import LoopbackTransport as JLoopback
from repro.router import FleetGateway as JFleetGateway
from repro.serve import Request, ServeEngine
from repro.serve import engine as jengine
from repro_torch.chaos import FaultInjector
from repro_torch.configs import get_config as tget_config
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import (MetricRegistry, Objective, ObsServer,
                             SLOMonitor, SpanTracer, TimeSeriesStore)
from repro_torch.region import LoopbackTransport
from repro_torch.router import Admission, FleetGateway
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import engine as tengine

ARCH = "smollm-135m"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """Per seed: the reference (model, params) and the port's, same
    weights; built once per module."""
    cache = {}

    def get(seed):
        if seed not in cache:
            jm = get_model(get_config(ARCH, reduced=True))
            params = jax.jit(lambda k: jm.init(k)[0])(
                jax.random.PRNGKey(seed))
            tc = tget_config(ARCH, reduced=True)
            tp = params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                   "cpu")
            cache[seed] = (jm, params, tget_model(tc), tp)
        return cache[seed]
    return get


def _prompts(vocab, seed, n, plen):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, plen) for _ in range(n)]


def _jax_streams(jm, params, prompts, max_new, max_seq, **kw):
    """The JAX engine's greedy stream of each prompt, one engine with a
    slot per prompt."""
    e = ServeEngine(jm, params, max_batch=len(prompts), max_seq=max_seq,
                    **kw)
    reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        e.submit(r)
    e.run_until_drained(max_steps=500)
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs]


def test_gateway_end_to_end_two_replicas(pair):
    _, _, tm, tp = pair(0)
    engines = [TServeEngine(tm, tp, max_batch=2, max_seq=24)
               for _ in range(2)]
    gw = FleetGateway(engines)
    reqs = [TRequest(rid=i, prompt=p, max_new=4)
            for i, p in enumerate(_prompts(tm.cfg.vocab, 0, 6, 6))]
    for r in reqs:
        assert gw.submit(r).action is Admission.ADMIT
    gw.run_until_drained(max_steps=300)
    assert all(r.done and len(r.out_tokens) >= 4 for r in reqs)
    per_replica = gw.stats()["per_replica"]
    assert sorted(per_replica) != [0, len(reqs)], per_replica
    assert len(gw.ttfts()) == len(reqs)
    assert gw.router.fleet.updates > len(reqs)
    assert gw.router.detector.samples.sum() > 0
    assert gw.stats()["requests_served"] == len(reqs)


def test_gateway_migrates_live_sessions_off_quarantined_replica(pair):
    jm, params, tm, tp = pair(5)
    prompts = _prompts(tm.cfg.vocab, 5, 4, 6)
    engines = [TServeEngine(tm, tp, max_batch=2, max_seq=48)
               for _ in range(2)]
    gw = FleetGateway(engines)
    reqs = [TRequest(rid=i, prompt=p.copy(), max_new=10)
            for i, p in enumerate(prompts)]
    for r in reqs:
        gw.submit(r)
    for _ in range(3):
        gw.pump()
    victim = max(range(2), key=lambda i: engines[i].active_count())
    n_live = engines[victim].active_count()
    assert n_live > 0
    gw.router.detector.force_quarantine(victim)
    gw.pump()
    assert engines[victim].active_count() == 0
    assert gw.stats()["migrations"] == n_live
    gw.run_until_drained(max_steps=300)
    assert all(r.done for r in reqs)
    assert len(gw.ttfts()) == len(reqs)
    want = _jax_streams(jm, params, prompts, 10, 48)
    assert [list(r.out_tokens) for r in reqs] == want


def test_gateway_drains_pending_session_imports_too(pair):
    jm, params, tm, tp = pair(6)
    prompts = _prompts(tm.cfg.vocab, 6, 2, 6)
    engines = [TServeEngine(tm, tp, max_batch=1, max_seq=48)
               for _ in range(2)]
    gw = FleetGateway(engines)
    reqs = [TRequest(rid=i, prompt=p.copy(), max_new=12)
            for i, p in enumerate(prompts)]
    for r in reqs:
        gw.submit(r)
    for _ in range(2):
        gw.pump()
    src = gw.tracked[0].replica
    dst = 1 - src
    sess = engines[src].export_session(gw.tracked[0].req.rid)
    engines[dst].import_session(sess)
    gw.tracked[0].replica = dst
    assert len(engines[dst].sessions_in) == 1
    gw.router.detector.force_quarantine(dst)
    gw.pump()
    assert not engines[dst].sessions_in
    assert gw.tracked and all(t.replica != dst or t.req.done
                              for t in gw.tracked)
    gw.run_until_drained(max_steps=300)
    assert all(r.done for r in reqs)
    assert [list(r.out_tokens) for r in reqs] == _jax_streams(
        jm, params, prompts, 12, 48)


class _Clock:
    """A fake ``perf_counter`` that moves 1 ms at every read: given to a
    gateway's ``clock`` and to its package's engines, so every latency the
    router and its detector see follows from the sequence of reads alone,
    which the two packages share."""

    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        self.now += 1e-3
        return self.now


def _crash_run(pkg, m, params, prompts, clock=time.perf_counter):
    """The seeded crash of ``tests/test_slo.py`` through either package's
    gateway: replica 1 dies at pump 1 and restarts at pump 8, heartbeats
    time out after 2 pumps, handoffs ride a loopback transport."""
    if pkg == "jax":
        Eng, Req, Gw = ServeEngine, Request, JFleetGateway
        Inj, Loop, Obj, Mon = JFaultInjector, JLoopback, JObjective, \
            JSLOMonitor
    else:
        Eng, Req, Gw = TServeEngine, TRequest, FleetGateway
        Inj, Loop, Obj, Mon = FaultInjector, LoopbackTransport, Objective, \
            SLOMonitor
    inj = Inj(0).crash(1, at_step=1, restart_at=8)
    gw = Gw([Eng(m, params, max_batch=4, max_seq=48) for _ in range(2)],
            transport=Loop(), injector=inj, heartbeat_timeout=2.0,
            clock=clock)
    mon = Mon([Obj("ttft_pumps", target=0.75, threshold=2.0)],
              fast_window=5, slow_window=15, burn_threshold=1.5)
    gw.attach_slo(mon)
    reqs = [Req(rid=i, prompt=p.copy(), max_new=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        gw.submit(r)
    for _ in range(14):
        gw.pump()
    states = [(a.state, a.tick) for a in mon.alerts]
    counts = mon.counts("ttft_pumps")
    gw.run_until_drained(400)
    streams = [list(gw.handle(r.rid).out_tokens) for r in reqs]
    assert all(gw.handle(r.rid).done for r in reqs)
    return gw, states, counts, streams


def test_crash_fires_ttft_burn_alert_then_clears(pair):
    """``tests/test_slo.py``'s seeded crash over port engines: the alert
    fires at pump 3 and clears at pump 8, two TTFTs on time and two late,
    and every victim finishes, token-identical to the JAX engine."""
    jm, params, tm, tp = pair(0)
    prompts = _prompts(tm.cfg.vocab, 5, 4, 8)
    gw, states, counts, streams = _crash_run("torch", tm, tp, prompts)
    assert states == [("firing", 3), ("cleared", 8)]
    assert counts == (2, 2)
    st = gw.stats()
    assert st["crashes_detected"] == 1
    assert st["crash_sessions_recovered"] + \
        st["crash_requests_resubmitted"] > 0
    assert streams == _jax_streams(jm, params, prompts, 6, 48)


def _clocked_crash_run(pkg, m, params, prompts, monkeypatch):
    clock = _Clock()
    module = tengine if pkg == "torch" else jengine
    monkeypatch.setattr(module, "time",
                        types.SimpleNamespace(perf_counter=clock))
    return _crash_run(pkg, m, params, prompts, clock=clock)


def test_crash_recovery_counters_match_jax_gateway(pair, monkeypatch):
    jm, params, tm, tp = pair(0)
    prompts = _prompts(tm.cfg.vocab, 5, 4, 8)
    tgw, tstates, tcounts, tstreams = _clocked_crash_run(
        "torch", tm, tp, prompts, monkeypatch)
    jgw, jstates, jcounts, jstreams = _clocked_crash_run(
        "jax", jm, params, prompts, monkeypatch)
    assert (tstates, tcounts, tstreams) == (jstates, jcounts, jstreams)
    keys = ("crashes_detected", "crash_sessions_recovered",
            "crash_requests_resubmitted", "requests_served", "per_replica",
            "events", "quarantined", "admission")
    ts, js = tgw.stats(), jgw.stats()
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}


def test_prefill_decode_handoff_fleet_matches_jax(pair):
    """One ``role="prefill"`` replica (chunks of 8) and two
    ``role="decode"`` replicas over a ``LoopbackTransport``: every request
    is handed off once, its breakdown is filled, and its stream equals the
    JAX chunked engine's.  The telemetry rides along (spans, metrics, a
    time series, an SLO monitor) and reaches the HTTP endpoint."""
    jm, params, tm, tp = pair(3)
    prompts = _prompts(tm.cfg.vocab, 3, 5, 19)
    engines = [TServeEngine(tm, tp, max_batch=2, max_seq=48, role="prefill",
                            prefill_chunk_tokens=8)]
    engines += [TServeEngine(tm, tp, max_batch=3, max_seq=48, role="decode",
                             decode_chunk=2) for _ in range(2)]
    gw = FleetGateway(engines, transport=LoopbackTransport())
    reg, tr = MetricRegistry(), SpanTracer("fleet")
    gw.attach_obs(tr, reg, name="fleet0")
    mon = SLOMonitor([Objective("ttft", target=0.9, threshold=60.0),
                      Objective("availability", target=0.9)])
    gw.attach_slo(mon)
    store = TimeSeriesStore(reg)
    gw.attach_timeseries(store)
    reqs = [TRequest(rid=i, prompt=p.copy(), max_new=5)
            for i, p in enumerate(prompts)]
    for r in reqs:
        gw.submit(r)
    gw.run_until_drained(max_steps=400)
    assert all(r.done for r in reqs)
    st = gw.stats()
    assert st["prefill_handoffs"] == len(reqs)
    bd = gw.ttft_breakdown()
    assert sorted(bd) == list(range(len(reqs)))
    assert all(b["source"] == 0 and b["dest"] in (1, 2)
               and b["prefill_s"] is not None
               and b["first_decode_s"] is not None for b in bd.values())
    want = _jax_streams(jm, params, prompts, 5, 48, prefill_chunk_tokens=8)
    assert [list(r.out_tokens) for r in reqs] == want
    assert mon.counts("availability") == (len(reqs), 0)
    text = reg.prometheus_text()
    assert f'fleet_prefill_handoffs_total{{fleet="fleet0"}} {len(reqs)}' \
        in text
    served = store.points("fleet_requests_served_total", fleet="fleet0")
    assert served and served[-1][-1] == len(reqs)
    with ObsServer(registry=reg, slo=mon, tracer=tr) as srv:
        import urllib.request
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            assert r.read().decode() == reg.prometheus_text()
