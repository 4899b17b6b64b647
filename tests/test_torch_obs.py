"""The port's telemetry plane (``repro_torch.obs``) against the JAX
package's goldens, fixtures and functions on the CPU:

* the ``MetricRegistry`` renders ``tests/golden/metrics.prom`` and the
  ``SpanTracer`` renders ``tests/golden/trace.json`` byte for byte (the
  fills of ``tests/test_obs.py``, copied here);
* ``TimeSeriesStore`` and ``SLOMonitor`` give the reference's answers on
  one scripted series;
* ``replay`` of ``tests/fixtures/decisions/route_log.jsonl``: the identity
  cost reproduces every recorded total and winner, a modified cost gives
  the reference's flips and term deltas, and the CLI runs as
  ``python -m repro_torch.obs.replay``;
* ``ObsServer`` serves its endpoints over a local socket with the
  reference's bodies and content types.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.obs import DecisionLog as JDecisionLog
from repro.obs import MetricRegistry as JMetricRegistry
from repro.obs import ObsServer as JObsServer
from repro.obs import Objective as JObjective
from repro.obs import SLOMonitor as JSLOMonitor
from repro.obs import SpanTracer as JSpanTracer
from repro.obs import TimeSeriesStore as JTimeSeriesStore
from repro.obs.replay import dump_jsonl as jdump_jsonl
from repro.obs.replay import parse_cost as jparse_cost
from repro.obs.replay import replay as jreplay
from repro.router import FleetPTT as JFleetPTT
from repro_torch.obs import (BYTE_BUCKETS, CANONICAL_STATS, DecisionLog,
                             Histogram, MetricRegistry, Objective, ObsServer,
                             SLOMonitor, SpanTracer, TimeSeriesStore,
                             dump_jsonl, load_jsonl, parse_cost,
                             record_to_json, replay, rescore)
from repro_torch.obs.replay import main as replay_main
from repro_torch.router import FleetPTT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "decisions",
                       "route_log.jsonl")


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

def _filled_registry(reg):
    """``tests/test_obs.py``'s deterministic fill: every family kind,
    several series per family, both bucket lists, an overflow sample."""
    c = reg.counter("fleet_requests_served_total",
                    "Requests finished fleet-wide", fleet="fleet")
    c.inc()
    c.inc(2)
    reg.counter("fleet_requests_served_total",
                "Requests finished fleet-wide", fleet="west").inc(5)
    reg.gauge("serve_utilization", "Batch-slot occupancy",
              engine="fleet/r0").set(0.25)
    h = reg.histogram("fleet_ttft_seconds", "Client-facing TTFT",
                      fleet="fleet")
    for v in (0.0004, 0.003, 0.003, 0.08, 0.7, 42.0):   # 42 -> +Inf slot
        h.observe(v)
    reg.histogram("region_ship_bytes", "Session wire payload",
                  buckets=BYTE_BUCKETS, region="region").observe(2048.0)
    return reg


def test_prometheus_text_matches_golden():
    text = _filled_registry(MetricRegistry()).prometheus_text()
    with open(os.path.join(GOLDEN, "metrics.prom")) as f:
        assert text == f.read()


def test_snapshot_matches_reference():
    got = _filled_registry(MetricRegistry()).snapshot()
    want = _filled_registry(JMetricRegistry()).snapshot()
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def _scripted_tracer(cls):
    """``tests/test_obs.py``'s deterministic-clock script: admit ->
    prefill -> decode on r0 -> migrate -> decode on r1 -> finish, and a
    WAN ship span on the region track."""
    state = {"now": 0.0}

    def clock() -> float:
        state["now"] = round(state["now"] + 0.001, 6)
        return state["now"]

    tr = cls(name="fleet", clock=clock)
    tid = tr.trace_for(7)
    assert tid == "fleet/r7"
    tr.instant("admit", tid, "fleet", replica=0)
    tr.complete("prefill", tid, "fleet/r0", ts=0.002, dur=0.004,
                prompt_len=8)
    tr.complete("decode-chunk", tid, "fleet/r0", ts=0.007, dur=0.006,
                tokens=4)
    tr.instant("migrate-out", tid, "fleet/r0")
    with tr.span("wan-ship", tid, "region", src=0, dst=1):
        pass
    tr.adopt(7, tid)
    tr.instant("migrate-in", tid, "fleet/r1")
    tr.complete("decode-chunk", tid, "fleet/r1", ts=0.020, dur=0.005,
                tokens=4)
    tr.instant("finish", tid, "fleet/r1")
    return tr


def test_chrome_trace_matches_golden():
    rendered = json.dumps(_scripted_tracer(SpanTracer).chrome_trace(),
                          indent=1, sort_keys=True)
    with open(os.path.join(GOLDEN, "trace.json")) as f:
        assert rendered == f.read()


def test_histogram_percentile_and_validation():
    h = Histogram()
    for v in [0.002] * 51 + [0.02] * 30 + [0.2] * 15 + [2.0] * 5:
        h.observe(v)
    assert [h.percentile(q) for q in (50, 90, 99)] == [0.0025, 0.25, 2.5]
    assert Histogram().percentile(50) == 0.0
    reg = MetricRegistry()
    reg.counter("x_total")
    with pytest.raises(ValueError):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        reg.counter("bad-name")
    assert CANONICAL_STATS == ("requests_served", "requests_shed",
                               "sessions_migrated", "queue_depth")


# ---------------------------------------------------------------------------
# time series and burn-rate alerts on one scripted series
# ---------------------------------------------------------------------------

def _scripted_obs(Reg, Store, Obj, Mon, Tracer):
    """60 pump ticks: a counter, a gauge and a histogram move every tick,
    the store samples every tick, and a TTFT / availability monitor sees
    a burst of bad events in ticks 20-29."""
    reg, tr = Reg(), Tracer("fleet", clock=lambda: 0.0)
    store = Store(reg, cap=32)
    mon = Mon([Obj("ttft", target=0.9, threshold=0.5),
               Obj("availability", target=0.95)],
              fast_window=4, slow_window=16, burn_threshold=2.0)
    mon.attach_obs(tr, reg, name="fleet/slo")
    c = reg.counter("fleet_requests_served_total", "served", fleet="f")
    g = reg.gauge("serve_queue_depth", "depth", engine="f/r0")
    h = reg.histogram("fleet_ttft_seconds", "ttft", fleet="f")
    rng = np.random.default_rng(9)
    out = []
    for tick in range(1, 61):
        n = int(rng.integers(1, 5))
        c.inc(n)
        g.set(float(rng.integers(0, 9)))
        for _ in range(n):
            v = float(rng.uniform(0.01, 0.4))
            if 20 <= tick < 30:
                v *= 4.0
            h.observe(v)
            mon.observe("ttft", v)
            mon.observe_ok("availability", not (25 <= tick < 28))
        tr.set_tick(tick)
        store.sample(tick, now=tick * 0.01)
        out.append([(a.objective, a.state, a.tick, a.burn_fast, a.burn_slow)
                    for a in mon.evaluate(tick, now=tick * 0.01)])
        if tick % 7 == 0:
            out.append((store.rate("fleet_requests_served_total",
                                   window=5, fleet="f"),
                        store.percentile("fleet_ttft_seconds", 90,
                                         window=8, fleet="f"),
                        store.window("serve_queue_depth", last=3)))
    return (out, json.dumps(store.export(), sort_keys=True),
            json.dumps(mon.alerts_json(), sort_keys=True),
            json.dumps(mon.stats(), sort_keys=True), reg.prometheus_text(),
            json.dumps(tr.chrome_trace(), sort_keys=True), store.names())


def test_timeseries_and_slo_match_reference():
    got = _scripted_obs(MetricRegistry, TimeSeriesStore, Objective,
                        SLOMonitor, SpanTracer)
    want = _scripted_obs(JMetricRegistry, JTimeSeriesStore, JObjective,
                         JSLOMonitor, JSpanTracer)
    for a, b in zip(got, want):
        assert a == b
    fired = [x for step in got[0] if isinstance(step, list) for x in step]
    assert {(a[0], a[1]) for a in fired} >= {("ttft", "firing"),
                                             ("ttft", "cleared")}


def test_slo_validation():
    with pytest.raises(ValueError):
        Objective("x", target=1.0)
    with pytest.raises(ValueError):
        SLOMonitor([])
    with pytest.raises(ValueError):
        SLOMonitor([Objective("x")], fast_window=5, slow_window=3)
    with pytest.raises(ValueError):
        SLOMonitor([Objective("x")]).observe("x", 1.0)
    with pytest.raises(ValueError):
        TimeSeriesStore(MetricRegistry(), cap=1)


# ---------------------------------------------------------------------------
# decision replay
# ---------------------------------------------------------------------------

def _identity_cost(rec):
    """The cost each recorded search ran under: metric 0 (route) scores
    queue pressure per token, metric 1 (sticky) in raw backlog."""
    if rec["context"]["metric"] == 0:
        return parse_cost("queueaware")
    return parse_cost("queueaware:value_per_token=false")


def test_identity_replay_reproduces_recorded_totals():
    recs = load_jsonl(FIXTURE)
    assert len(recs) == 60
    overrides = 0
    for rec in recs:
        out = rescore(rec, _identity_cost(rec))
        assert not out["flipped"]
        for c in out["candidates"]:
            assert c["total"] == c["old_total"]
            assert c["terms"] == c["old_terms"]
        overrides += out["policy_override"]
    assert overrides == 5


@pytest.mark.parametrize("spec", [
    "queueaware+migration:fixed=0.5,per_token=0.001",
    "queueaware:value_per_token=false", "latency+migration:fixed=0.05",
    "occupancy"])
def test_modified_cost_replay_matches_reference(spec):
    recs = load_jsonl(FIXTURE)
    got = replay(recs, parse_cost(spec))
    want = jreplay(recs, jparse_cost(spec))
    assert got.to_json() == want.to_json()
    assert got.render() == want.render()
    if spec.startswith("queueaware+migration"):
        assert len(got.flips) == 8 and got.policy_overrides == 5
        tt = got.term_totals
        assert tt["MigrationCost"]["delta"] == pytest.approx(47.376,
                                                             abs=0.01)
        assert tt["QueueAware"]["delta"] == pytest.approx(322.434,
                                                          abs=0.01)


def test_replay_cli_as_module(tmp_path):
    out = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.replay", FIXTURE, "--cost",
         "queueaware+migration:fixed=0.5,per_token=0.001", "--kind",
         "route", "--json", str(out)], capture_output=True, text=True,
        env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "replayed 60 decisions (route=60)" in p.stdout
    assert "8 flipped winner(s), 5 policy override(s)" in p.stdout
    doc = json.loads(out.read_text())
    assert doc["n"] == 60 and doc["policy_overrides"] == 5
    assert replay_main([FIXTURE, "--cost", "queueaware"]) == 0


def _logged(PTT, Log, to_json=None):
    """A DecisionLog of 30 seeded FleetPTT searches."""
    log = Log()
    f = PTT(3, 3)
    rng = np.random.default_rng(2)
    for i in range(30):
        c, r = int(rng.integers(0, 3)), int(rng.integers(0, 3))
        f.update(c, r, 0, float(rng.uniform(0.01, 1.0)))
        f.record_service(r, float(rng.uniform(0.1, 1.0)))
        backlog = [int(x) for x in rng.integers(0, 5, 3)]
        f.ranked_search(c, backlog=backlog, tokens=int(rng.integers(1, 99)),
                        attribution=log.hook("route", rid=i))
    return log


def test_dump_load_roundtrip(tmp_path):
    log = _logged(FleetPTT, DecisionLog)
    path = tmp_path / "log.jsonl"
    assert dump_jsonl(log, str(path)) == 30
    jpath = tmp_path / "jlog.jsonl"
    jdump_jsonl(_logged(JFleetPTT, JDecisionLog), str(jpath))
    assert path.read_text() == jpath.read_text()
    loaded = load_jsonl(str(path))
    for rec, got in zip(log.records, loaded):
        assert got == json.loads(json.dumps(record_to_json(rec),
                                            sort_keys=True))
        assert rec.check()
    rep = replay(loaded, parse_cost("queueaware"))
    assert rep.n == 30 and not rep.flips


# ---------------------------------------------------------------------------
# the HTTP endpoint
# ---------------------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def test_obs_server_serves_every_endpoint():
    def parts(Reg, Store, Obj, Mon, Tracer, PTT, Log, Server):
        reg = _filled_registry(Reg())
        store = Store(reg)
        store.sample(1, 0.5)
        mon = Mon([Obj("a", target=0.9)], fast_window=2, slow_window=4)
        mon.observe_ok("a", False)
        mon.evaluate(1)
        return Server(registry=reg, timeseries=store, slo=mon,
                      tracer=_scripted_tracer(Tracer),
                      decisions=_logged(PTT, Log))

    paths = ["/", "/metrics", "/timeseries", "/alerts", "/traces",
             "/debug/decisions", "/debug/decisions?n=2",
             "/debug/decisions?kind=nope", "/missing"]
    got, want = {}, {}
    for out, srv in (
            (got, parts(MetricRegistry, TimeSeriesStore, Objective,
                        SLOMonitor, SpanTracer, FleetPTT, DecisionLog,
                        ObsServer)),
            (want, parts(JMetricRegistry, JTimeSeriesStore, JObjective,
                         JSLOMonitor, JSpanTracer, JFleetPTT, JDecisionLog,
                         JObsServer))):
        with srv:
            assert srv.port != 0
            for p in paths:
                out[p] = _get(srv.url + p)
        assert srv._httpd is None
    assert got == want
    status, ctype, body = got["/metrics"]
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    with open(os.path.join(GOLDEN, "metrics.prom"), "rb") as f:
        assert body == f.read()
    assert got["/missing"][0] == 404
    assert json.loads(got["/debug/decisions?n=2"][2])["count"] == 2
