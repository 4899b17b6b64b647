"""The port's region tier (``repro_torch.region``: ``RegionRouter``,
``RegionGateway``) on the CPU, held against the JAX package's
``repro.region`` with the same records, weights and prompts:

* ``RegionRouter`` fed one scripted, seeded sequence of link RTTs (with
  aging), TTFT, service and TPOT samples, brownouts, routes and drain
  ranks: every ``RegionDecision``, ``drain_rank``, link row, aged row,
  trained table, attributed decision record and ``stats()`` identical;
* region failover over port engines: a brownout drains fleet 0's live
  sessions through the wire (or keeps one home where the move does not
  pay), every stream equals the JAX engine's, on ``smollm-135m``,
  ``granite-moe-1b-a400m`` and its ``moe_every = 2`` layout, and the link's
  RTT row is trained from the drain;
* the stay-home skip (WAN egress and migration cost) and the drain's
  re-routing of unstarted requests;
* a chaos drain at ``tests/test_chaos.py::
  test_region_chaos_drain_token_identity``'s rates, its partition moved
  onto the first drain pump: eight sessions fail their delivery and are
  parked home, then all leave through the lossy link; nothing is lost,
  nothing adopted twice, the streams are the JAX engine's.

The engines and gateways take one fake clock (1 ms a read) in each
package, so every table the router trains, and so every decision, follows
from the sequence of reads, which the two packages share: the failover's
and the chaos drain's ``stats()`` equal the JAX ``RegionGateway``'s (but
``wan_bytes``: the zlib payload of a float32 cache whose last bits differ
between the packages differs by a byte or two; the raw bytes are equal).

Float32 on both sides; tokens and counters are exact.
"""

import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch

import repro.serve.engine as jengine
import repro_torch.serve.engine as tengine
from repro.chaos import ChaosTransport as JChaos
from repro.chaos import FaultInjector as JInjector
from repro.chaos import ReliableTransport as JReliable
from repro.configs import get_config
from repro.core.tracetable import MigrationCost as JMigrationCost
from repro.models import get_model
from repro.obs import DecisionLog as JDecisionLog
from repro.obs.replay import json_default as jjson_default
from repro.obs.replay import record_to_json as jrecord_to_json
from repro.region import LoopbackTransport as JLoopback
from repro.region import RegionGateway as JRegionGateway
from repro.region import RegionRouter as JRegionRouter
from repro.router import FleetGateway as JFleetGateway
from repro.serve import Request, ServeEngine
from repro_torch.chaos import ChaosTransport, FaultInjector
from repro_torch.chaos import ReliableTransport
from repro_torch.configs import get_config as tget_config
from repro_torch.core.tracetable import MigrationCost
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import DecisionLog
from repro_torch.obs.replay import json_default, record_to_json
from repro_torch.region import (LoopbackTransport, RegionDecision,
                                RegionGateway, RegionRouter, WanCost)
from repro_torch.router import FleetGateway
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

PKGS = {
    "jax": dict(Router=JRegionRouter, Mig=JMigrationCost, Log=JDecisionLog,
                to_json=jrecord_to_json, default=jjson_default,
                Gateway=JRegionGateway, Fleet=JFleetGateway,
                Engine=ServeEngine, Request=Request, Loopback=JLoopback,
                Chaos=JChaos, Injector=JInjector, Reliable=JReliable,
                engine_module=jengine),
    "torch": dict(Router=RegionRouter, Mig=MigrationCost, Log=DecisionLog,
                  to_json=record_to_json, default=json_default,
                  Gateway=RegionGateway, Fleet=FleetGateway,
                  Engine=TServeEngine, Request=TRequest,
                  Loopback=LoopbackTransport, Chaos=ChaosTransport,
                  Injector=FaultInjector, Reliable=ReliableTransport,
                  engine_module=tengine),
}
# (arch, moe_every, n_layers); None keeps the reduced config's layout
ARCHS = {"smollm-135m": ("smollm-135m", None),
         "granite-moe-1b-a400m": ("granite-moe-1b-a400m", None),
         "granite-moe-every2": ("granite-moe-1b-a400m", (2, 4))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_exports():
    import repro.region as jregion
    import repro_torch.region as tregion
    import repro.chaos as jchaos
    import repro_torch.chaos as tchaos
    assert tregion.__all__ == jregion.__all__
    assert tchaos.__all__ == jchaos.__all__
    assert tregion.WanCost is WanCost
    assert dataclasses.is_dataclass(RegionDecision)


# ---------------------------------------------------------------------------
# RegionRouter: one scripted sequence through both packages
# ---------------------------------------------------------------------------

def _script(seed, n=300, fleets=3):
    """One seeded event sequence: link RTT samples on a clock (fleet 2's
    links slow after event 150), TTFT, service and TPOT samples, routes of
    mixed sizes with class-resolved or plain backlogs and affinities,
    drain ranks, a brownout and restore of fleet 1, and aging passes."""
    rng = np.random.default_rng(seed)
    ev, now = [], 0.0
    for i in range(n):
        now += float(rng.uniform(0.01, 0.3))
        u = rng.random()
        if i == 100:
            ev.append(("brownout", 1))
        elif i == 200:
            ev.append(("restore", 1))
        elif u < 0.2:
            s, d = (int(x) for x in rng.choice(fleets, 2, replace=False))
            rtt = float(rng.uniform(0.02, 0.08))
            if 2 in (s, d) and i >= 150:
                rtt *= 5.0
            ev.append(("rtt", s, d, rtt, now))
        elif u < 0.3:
            ev.append(("ttft", int(rng.integers(0, fleets)),
                       int(rng.integers(0, 3)),
                       float(rng.uniform(0.01, 0.2)),
                       int(rng.choice([16, 900, 3000]))))
        elif u < 0.38:
            ev.append(("service", int(rng.integers(0, fleets)),
                       float(rng.uniform(0.05, 0.5)),
                       int(rng.integers(1, 4)), int(rng.integers(0, 3))))
        elif u < 0.5:
            ev.append(("tpot", int(rng.integers(0, fleets)),
                       float(rng.uniform(0.004, 0.02))))
        elif u < 0.58:
            ev.append(("age", now))
        elif u < 0.68:
            ev.append(("drain", int(rng.integers(0, fleets)),
                       int(rng.integers(1, 4000)), _backlog(rng, fleets)))
        else:
            plen = int(rng.choice([16, 200, 1500, 3000]))
            max_new = int(rng.choice([8, 64, 512]))
            aff = None if rng.random() < 0.5 else int(rng.integers(0,
                                                                  fleets))
            ev.append(("route", plen, max_new, int(rng.integers(0, fleets)),
                       aff, _backlog(rng, fleets)))
    return ev


def _backlog(rng, fleets):
    u = rng.random()
    if u < 0.2:
        return None
    if u < 0.5:
        return [int(x) for x in rng.integers(0, 5, fleets)]
    return [{int(c): int(rng.integers(0, 4)) for c in range(3)
             if rng.random() < 0.7} for _ in range(fleets)]


def _run_router(pkg, seed, priced):
    P = PKGS[pkg]
    log = P["Log"]()
    kw = dict(egress_per_byte=2e-9, bytes_per_token=4096.0,
              migration=P["Mig"](fixed=0.01, per_token=1e-5),
              rtt_halflife_s=0.5) if priced else {}
    rr = P["Router"](3, attribution=log, **kw)
    out = []
    for e in _script(seed):
        kind = e[0]
        if kind == "brownout":
            rr.brownout(e[1])
        elif kind == "restore":
            rr.restore(e[1])
        elif kind == "rtt":
            rr.record_rtt(e[1], e[2], e[3], now=e[4])
        elif kind == "ttft":
            rr.record_ttft(e[1], e[2], e[3], prompt_len=e[4])
        elif kind == "service":
            rr.record_service(e[1], e[2], units=e[3], req_class=e[4])
        elif kind == "tpot":
            rr.record_tpot(e[1], e[2])
        elif kind == "age":
            out.append(("aged", rr.age_links(e[1]),
                        rr.links.array().tolist()))
        elif kind == "drain":
            out.append(("rank", rr.drain_rank(e[1], e[2], backlog=e[3])))
        else:
            _, plen, max_new, origin, aff, backlog = e
            d = rr.route(plen, max_new, origin=origin, affinity=aff,
                         backlog=backlog)
            out.append(("route", d.fleet, int(d.req_class), d.predicted,
                        d.wan_hop))
    records = [json.dumps(P["to_json"](r), sort_keys=True,
                          default=P["default"]) for r in log.records]
    t = rr.table
    tables = [t.table(c, m).tolist() for c in range(3) for m in (0, 1)]
    return out, rr.stats(), tables, records, rr.healthy()


@pytest.mark.parametrize("priced", (False, True))
@pytest.mark.parametrize("seed", (0, 1))
def test_region_router_matches_jax(seed, priced):
    got = _run_router("torch", seed, priced)
    want = _run_router("jax", seed, priced)
    assert got[0] == want[0]
    assert got[1:] == want[1:]
    out, stats = got[0], got[1]
    fleets = {e[1] for e in out if e[0] == "route"}
    assert len(fleets) > 1, fleets                 # the search moved
    assert any(e[0] == "route" and e[4] for e in out)       # a WAN hop
    if priced:
        assert stats["rtt_decays"] > 0             # rows aged


def test_region_sticky_affinity_and_hop_reporting():
    """``tests/test_region.py``'s router cases on the port: a chatty decode
    stays home when the hop outweighs the TPOT win and leaves when the
    link is cheap; with the affinity fleet browned out the hop is
    reported from the ingress region."""
    expensive, cheap = RegionRouter(2), RegionRouter(2)
    for rr, rtt in ((expensive, 1.0), (cheap, 0.001)):
        for _ in range(6):
            rr.record_tpot(0, 0.1)
            rr.record_tpot(1, 0.01)
            rr.record_rtt(0, 1, rtt)
    d = expensive.route(16, 256, origin=0, affinity=0)
    assert d.fleet == 0 and not d.wan_hop
    d = cheap.route(16, 256, origin=0, affinity=0)
    assert d.fleet == 1 and d.wan_hop
    rr = RegionRouter(2)
    rr.record_rtt(1, 0, 0.2)
    rr.brownout(0)
    d = rr.route(16, 256, origin=1, affinity=0)
    assert d.fleet == 1 and not d.wan_hop
    assert d.predicted == pytest.approx(0.0)


# ---------------------------------------------------------------------------
# region failover over port engines
# ---------------------------------------------------------------------------

def _configs(arch):
    name, layout = ARCHS[arch]
    jc, tc = get_config(name, reduced=True), tget_config(name, reduced=True)
    if layout is not None:
        kw = dict(moe_every=layout[0], n_layers=layout[1])
        jc, tc = (dataclasses.replace(jc, **kw),
                  dataclasses.replace(tc, **kw))
    return jc, tc


@pytest.fixture(scope="module")
def pair():
    """Per arch: the reference (model, params) and the port's, same
    weights; built once per module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, tc = _configs(arch)
            jm = get_model(jc)
            params = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
            tp = params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                   "cpu")
            cache[arch] = (jm, params, tget_model(tc), tp)
        return cache[arch]
    return get


def _jax_stream(jm, params, prompt, max_new, max_batch=2):
    e = ServeEngine(jm, params, max_batch=max_batch, max_seq=48)
    r = Request(rid=100, prompt=prompt.copy(), max_new=max_new)
    e.submit(r)
    e.run_until_drained(300)
    assert r.done
    return list(r.out_tokens)


def _region(tm, tp, router=None, link_rtt=None):
    fleets = [FleetGateway([TServeEngine(tm, tp, max_batch=2, max_seq=48)])
              for _ in range(2)]
    return RegionGateway(fleets, router=router or RegionRouter(2),
                         transport=LoopbackTransport(link_rtt=link_rtt))


class _Clock:
    """A fake ``perf_counter`` that moves 1 ms at every read: given to the
    gateways' ``clock`` and to the engines of one package, so that every
    duration, TTFT and timestamp (and so every decision the tables make)
    follows from the sequence of reads alone, which the two packages
    share."""

    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        self.now += 1e-3
        return self.now


def _clocked(pkg, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(PKGS[pkg]["engine_module"], "time",
                        types.SimpleNamespace(perf_counter=clock))
    return clock


def _failover(pkg, model, params, prompts, max_new, monkeypatch):
    """``tests/test_region.py::test_region_failover_token_identity`` in
    one package under the fake clock: two one-replica fleets, a 0.08 s
    link, every request sent home to fleet 0, a brownout of fleet 0 after
    3 pumps.  Returns the streams and everything the drain decided."""
    P = PKGS[pkg]
    clock = _clocked(pkg, monkeypatch)
    fleets = [P["Fleet"]([P["Engine"](model, params, max_batch=2,
                                      max_seq=48)], clock=clock)
              for _ in range(2)]
    rg = P["Gateway"](fleets, router=P["Router"](2),
                      transport=P["Loopback"](link_rtt=lambda s, d: 0.08),
                      clock=clock)
    reqs = [P["Request"](rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    homes = [rg.submit(r, origin=0, affinity=0).fleet for r in reqs]
    for _ in range(3):
        rg.pump()
    live = len(fleets[0].live_sessions())
    rg.brownout(0)
    rg.pump()
    left = sum(e.active_count() + e.pending() for e in fleets[0].engines)
    at_drain = rg.stats()
    rg.run_until_drained(500)
    handles = [rg.request(i) for i in range(len(reqs))]
    assert all(h.done for h in handles)
    moved = [h is not r for h, r in zip(handles, reqs)]
    return ([list(h.out_tokens) for h in handles], homes, live, left,
            at_drain, rg.stats(), moved)


@pytest.mark.parametrize("arch", ARCHS)
def test_region_failover_token_identity(pair, arch, monkeypatch):
    """A region-wide brownout drains the live sessions cross-region
    through the wire; every stream continues as the JAX engine's, the
    link's RTT row is trained from the drain, and under the shared fake
    clock every decision and counter is the JAX gateway's."""
    jm, params, tm, tp = pair(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab, 6) for _ in range(3)]
    want = [_jax_stream(jm, params, p, 10) for p in prompts]
    got = _failover("torch", tm, tp, prompts, 10, monkeypatch)
    streams, homes, live, left, at_drain, final, moved = got
    assert streams == want, arch
    assert homes == [0, 0, 0]              # sticky: everything starts home
    assert at_drain["wan_ships"] >= 1 and at_drain["wan_bytes"] > 0
    assert at_drain["wan_ships"] + at_drain["stay_home_skips"] == live
    assert at_drain["rtt_rows"][0][1] == pytest.approx(0.08)   # trained
    assert any(moved)          # a live handle is a decoded copy: bytes
    assert final["requests_served"] == len(prompts)
    jgot = _failover("jax", jm, params, prompts, 10, monkeypatch)
    assert jgot[:4] == got[:4] and jgot[6] == got[6]
    for a, b in ((jgot[4], at_drain), (jgot[5], final)):
        assert _without_wire_bytes(a) == _without_wire_bytes(b)


@pytest.mark.parametrize("kind", ("wan", "migration"))
def test_region_stay_home_skips_export(pair, kind):
    """When WAN egress or the re-ingest charge puts the browned-out source
    first, no session is exported: no wire bytes move and the request
    finishes where its cache is, on the original handle, with the JAX
    engine's stream."""
    jm, params, tm, tp = pair("smollm-135m")
    if kind == "wan":
        router = RegionRouter(2, egress_per_byte=1.0, bytes_per_token=1e6)
    else:
        router = RegionRouter(2, migration=MigrationCost(fixed=1e9))
    rg = _region(tm, tp, router=router)
    for _ in range(4):
        rg.router.record_tpot(0, 0.01)
        rg.router.record_tpot(1, 0.01)
    prompt = np.random.default_rng(0).integers(0, tm.cfg.vocab, 6)
    req = TRequest(rid=0, prompt=prompt.copy(), max_new=10)
    rg.submit(req, origin=0, affinity=0)
    for _ in range(3):
        rg.pump()
    assert not req.done
    rg.brownout(0)
    rg.pump()
    st = rg.stats()
    assert st["stay_home_skips"] >= 1
    assert st["wan_ships"] == 0 and st["wan_bytes"] == 0
    rg.run_until_drained(500)
    assert req.done and rg.request(0) is req
    assert list(req.out_tokens) == _jax_stream(jm, params, prompt, 10)


def test_region_drain_reroutes_unstarted_requests(pair):
    """Requests queued on a browned-out fleet and never started re-route
    to the healthy fleet as plain requests (no cache, no wire bytes), and
    finish with the JAX engine's streams."""
    jm, params, tm, tp = pair("smollm-135m")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab, 6) for _ in range(5)]
    rg = _region(tm, tp)
    reqs = [TRequest(rid=i, prompt=p.copy(), max_new=8)
            for i, p in enumerate(prompts)]
    for r in reqs:                   # more than fleet 0's two slots
        rg.submit(r, origin=0, affinity=0)
    rg.pump()
    rg.brownout(0)
    rg.run_until_drained(500)
    assert all(rg.request(r.rid).done for r in reqs)
    assert rg.fleets[1].stats()["served"] >= 1
    assert rg.stats()["requests_served"] == len(reqs)
    assert [list(rg.request(r.rid).out_tokens) for r in reqs] == [
        _jax_stream(jm, params, p, 8) for p in prompts]


# ---------------------------------------------------------------------------
# the chaos drain, and its counters against the JAX gateway's
# ---------------------------------------------------------------------------

def _without_wire_bytes(stats: dict) -> dict:
    """A region's stats less ``wan_bytes``: the two packages' float32
    caches differ in their last bits, so their zlib payloads differ in
    length by a byte or two; the raw session bytes are compared."""
    return {k: v for k, v in stats.items() if k != "wan_bytes"}


def _chaos_drain(pkg, model, params, prompts, monkeypatch):
    """``tests/test_chaos.py::test_region_chaos_drain_token_identity``'s
    rates (drop 0.3, corrupt 0.1, duplicate 0.4, 10 attempts, no jitter)
    in one package under the fake clock, with the partition of link 0 -> 1
    moved onto the first drain pump and a simulated backoff of 0.1 ms
    doubling to at most 1 ms, so that every session's move pays: all eight
    sessions fail their first delivery and are parked home, then leave
    through the lossy link.  Returns the streams, the region's stats
    after the first and the second drain pump and at the end, the
    sessions live at the brownout, the injector's counts and the
    transport's."""
    P = PKGS[pkg]
    clock = _clocked(pkg, monkeypatch)
    inj = (P["Injector"](3)
           .default_link(drop=0.3, corrupt=0.1, duplicate=0.4)
           .partition(0, 1, start=4, until=5))
    transport = P["Reliable"](P["Chaos"](P["Loopback"](), inj),
                              max_attempts=10, base_backoff=1e-4,
                              max_backoff=1e-3, jitter=0.0, seed=3)
    fleets = [P["Fleet"]([P["Engine"](model, params, max_batch=8,
                                      max_seq=48, decode_chunk=2)
                          for _ in range(2)], clock=clock)
              for _ in range(2)]
    region = P["Gateway"](fleets, transport=transport, clock=clock)
    # the link's row trained (as by earlier traffic), so that the fresh
    # requests' search charges the hop and every one stays home
    region.router.record_rtt(0, 1, 1e-3)
    for i, p in enumerate(prompts):
        region.submit(P["Request"](rid=i, prompt=p.copy(), max_new=12),
                      origin=0)
    for _ in range(3):
        region.pump()
        inj.advance()                # region pumps don't own the fault clock
    live = len(fleets[0].live_sessions())
    region.brownout(0)
    drains = []
    for _ in range(600):
        inj.advance()
        a = region.pump()
        if len(drains) < 2:
            drains.append((region.stats(), len(fleets[0].live_sessions())))
        if (a == 0 and not any(gw.held for gw in fleets)
                and not any(e.pending() for gw in fleets
                            for e in gw.engines)):
            break
    handles = [region.request(i) for i in range(len(prompts))]
    assert all(h.done for h in handles)
    return ([list(h.out_tokens) for h in handles], drains, region.stats(),
            live, dict(inj.counts), transport.stats())


def test_region_chaos_drain_matches_jax(pair, monkeypatch):
    """Zero loss, no double adoption, the JAX streams; and the same
    decisions, faults, retries and counters as the JAX gateway."""
    jm, params, tm, tp = pair("smollm-135m")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tm.cfg.vocab, 6 + i) for i in range(8)]
    want = [_jax_stream(jm, params, p, 12) for p in prompts]
    got = _chaos_drain("torch", tm, tp, prompts, monkeypatch)
    streams, drains, st, live, faults, sent = got
    assert streams == want                       # tokens identical
    assert st["requests_served"] == len(prompts)             # zero lost
    assert sum(st["fleet_served"]) == len(prompts)
    # the partitioned pump: every live session's delivery failed and it
    # was parked home; the next pump moved them all
    (first, home1), (second, home2) = drains
    assert live == home1 >= 2
    assert first["delivery_failures"] == live and first["wan_ships"] == 0
    assert home2 == 0 and second["wan_ships"] == live
    assert faults["partition"] == 10 * live      # every attempt of each
    assert sent["exhausted"] == live
    # every duplicated delivery was decoded and deduplicated or, corrupt,
    # dropped: none was adopted twice
    assert st["duplicates_deduped"] + st["duplicates_dropped"] == \
        faults["duplicate"] >= 1
    assert faults["drop"] + faults["corrupt"] > 0 and sent["retries"] > 0
    jgot = _chaos_drain("jax", jm, params, prompts, monkeypatch)
    assert jgot[0] == streams and jgot[3:] == got[3:]
    assert [(_without_wire_bytes(a), n) for a, n in jgot[1]] == [
        (_without_wire_bytes(a), n) for a, n in drains]
    assert _without_wire_bytes(jgot[2]) == _without_wire_bytes(st)
