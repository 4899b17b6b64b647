"""The port's fleet control plane against the JAX package's, fed the same
scripted, seeded sequences (no engine involved): ``FleetRouter`` route
decisions, quarantine / readmit events, trained tables and attributed
decision records; and ``FleetPTT``, ``InterferenceDetector``,
``AdmissionController``, ``StragglerRebalancer`` and
``HeartbeatMonitor`` alone.  Everything is host-side numpy on both sides,
so every comparison is exact.
"""

import json

import numpy as np
import pytest

from repro.distributed import elastic as JE
from repro.obs import DecisionLog as JDecisionLog
from repro.obs.replay import json_default as jjson_default
from repro.obs.replay import record_to_json as jrecord_to_json
from repro.router import admission as JA
from repro.router import fleet_ptt as JF
from repro.router import interference as JI
from repro.router import router as JR
from repro.core.tracetable import MigrationCost as JMigrationCost
from repro.serve import scheduler as JS
from repro_torch.core.tracetable import MigrationCost as TMigrationCost
from repro_torch.distributed import elastic as TE
from repro_torch.obs import DecisionLog as TDecisionLog
from repro_torch.obs.replay import json_default as tjson_default
from repro_torch.obs.replay import record_to_json as trecord_to_json
from repro_torch.router import admission as TA
from repro_torch.router import fleet_ptt as TF
from repro_torch.router import interference as TI
from repro_torch.router import router as TR
from repro_torch.serve import scheduler as TS

PKGS = {
    "jax": dict(A=JA, F=JF, I=JI, R=JR, S=JS, E=JE, Mig=JMigrationCost,
                Log=JDecisionLog, to_json=jrecord_to_json,
                default=jjson_default),
    "torch": dict(A=TA, F=TF, I=TI, R=TR, S=TS, E=TE, Mig=TMigrationCost,
                  Log=TDecisionLog, to_json=trecord_to_json,
                  default=tjson_default),
}


def _plain(x):
    """Enums of either package as their values, so that two packages'
    results compare as data."""
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if hasattr(x, "value") and hasattr(x, "name") and \
            type(x).__module__.split(".")[0] in ("repro", "repro_torch"):
        return (type(x).__name__, x.name)
    return x


def _decision(d):
    return (d.replica, int(d.req_class), d.action.value, d.predicted_ttft,
            d.predicted_tpot, d.probe)


def _slo(pkg, tight):
    RC = PKGS[pkg]["S"].RequestClass
    inf = float("inf")
    if tight:
        return PKGS[pkg]["A"].SLOPolicy(
            ttft={RC.PREFILL_SHORT: 0.02, RC.PREFILL_LONG: 0.2,
                  RC.DECODE: 0.05},
            tpot={RC.PREFILL_SHORT: inf, RC.PREFILL_LONG: inf,
                  RC.DECODE: 0.004},
            patience=3.0, tenant_weight={"a": 3.0})
    return PKGS[pkg]["A"].SLOPolicy.default()


def _script(seed, n=400):
    """One seeded event sequence: step latencies (replica 1 slowed 6x for
    events 120-220), prefill chunks, TTFT and service samples, and routes
    of mixed sizes with backlogs, affinities and requeues."""
    rng = np.random.default_rng(seed)
    ev = []
    for i in range(n):
        u = rng.random()
        if u < 0.45:
            r = int(rng.integers(0, 3))
            lat = float(rng.uniform(0.004, 0.006))
            if r == 1 and 120 <= i < 220:
                lat *= 6.0
            ev.append(("step", r, lat))
        elif u < 0.5:
            ev.append(("chunk", int(rng.integers(0, 3)),
                       float(rng.uniform(0.01, 0.03))))
        elif u < 0.62:
            plen = int(rng.choice([64, 900, 3000]))
            ev.append(("ttft", int(rng.integers(0, 3)), int(rng.integers(0, 3)),
                       float(rng.uniform(0.01, 0.2)), plen))
        elif u < 0.7:
            ev.append(("service", int(rng.integers(0, 3)),
                       float(rng.uniform(0.05, 0.5)),
                       int(rng.integers(1, 600)), int(rng.integers(0, 3))))
        else:
            plen = int(rng.choice([16, 200, 1500, 3000]))
            max_new = int(rng.choice([8, 64, 512]))
            aff = None if rng.random() < 0.6 else int(rng.integers(0, 3))
            backlog = [int(x) for x in rng.integers(0, 4, 3)]
            allowed = None if rng.random() < 0.8 else [0, 2]
            ev.append(("route", plen, max_new, aff, backlog,
                       bool(rng.random() < 0.2), allowed))
    return ev


def _run_router(pkg, seed, tight, migration):
    P = PKGS[pkg]
    log = P["Log"]()
    router = P["R"].FleetRouter(
        3, slo=_slo(pkg, tight),
        migration=P["Mig"](fixed=0.01, per_token=1e-5) if migration
        else None, attribution=log)
    out = []
    for e in _script(seed):
        if e[0] == "step":
            router.record_step(e[1], e[2])
            out.append(("flip", len(router.detector.events)))
        elif e[0] == "chunk":
            router.record_prefill_chunk(e[1], e[2])
        elif e[0] == "ttft":
            router.record_ttft(e[1], P["S"].RequestClass(e[2]), e[3],
                               prompt_len=e[4])
        elif e[0] == "service":
            router.record_service(e[1], e[2], units=e[3], req_class=e[4])
        else:
            _, plen, max_new, aff, backlog, requeue, allowed = e
            d = router.route(plen, max_new, affinity=aff, backlog=backlog,
                             requeue=requeue, allowed=allowed)
            out.append(_decision(d))
    records = [json.dumps(P["to_json"](r), sort_keys=True,
                          default=P["default"]) for r in log.records]
    f = router.fleet
    tables = (f._t.array(0), f._t.array(1), f._svc.array(),
              f._svc_class.array(), router.detector.baseline,
              router.detector.fast, router.detector.samples)
    return out, list(router.detector.events), tables, \
        _plain(router.stats()), records


@pytest.mark.parametrize("seed,tight,migration", [
    (0, False, False), (1, True, False), (2, True, True), (3, False, True)])
def test_router_decisions_identical(seed, tight, migration):
    j = _run_router("jax", seed, tight, migration)
    t = _run_router("torch", seed, tight, migration)
    assert t[0] == j[0]
    assert t[1] == j[1]
    for a, b in zip(t[2], j[2]):
        np.testing.assert_array_equal(a, b)
    assert t[3] == j[3]
    assert t[4] == j[4]
    assert len(t[4]) > 50


def test_script_quarantines_and_readmits_replica_1():
    """The scripted slowdown is seen: replica 1 is quarantined inside its
    window and readmitted after it (so the comparison above covers both
    flips, the probe path and the service decay)."""
    _, events, _, _, _ = _run_router("torch", 0, False, False)
    assert ("quarantine", 1) in events and ("readmit", 1) in events
    assert events.index(("quarantine", 1)) < events.index(("readmit", 1))


def test_fleet_ptt_alone():
    res = {}
    for pkg in PKGS:
        f = PKGS[pkg]["F"].FleetPTT(4, 3)
        out = []
        r2 = np.random.default_rng(7)
        for _ in range(200):
            c, r = int(r2.integers(0, 3)), int(r2.integers(0, 4))
            f.update(c, r, int(r2.integers(0, 2)), float(r2.uniform(0, 1)))
            f.record_service(r, float(r2.uniform(0.1, 1)),
                             units=int(r2.integers(1, 50)),
                             req_class=c if r2.random() < 0.5 else None)
            if r2.random() < 0.1:
                f.decay_service(r, float(r2.uniform(0.1, 2)))
            backlog = [int(x) for x in r2.integers(0, 5, 4)]
            cb = [{0: int(x), 2: int(y)} for x, y in r2.integers(0, 5, (4, 2))]
            out.append((
                f.global_search(c, backlog=backlog, tokens=17),
                f.global_search(c, healthy=[1, 3], backlog=cb),
                tuple(f.ranked_search(c, backlog=backlog, current=r)),
                f.sticky_search(c, r, backlog=backlog),
                f.predict_ttft(c, r, backlog[r], tokens=33),
                f.predict_ttft(c, r, cb[r], tokens=33, value_scale=1.5),
                f.service_time(r), f.service_time(r, c)))
        res[pkg] = (out, f._t.array(0), f._t.array(1), f.updates)
    assert res["torch"][0] == res["jax"][0]
    np.testing.assert_array_equal(res["torch"][1], res["jax"][1])
    np.testing.assert_array_equal(res["torch"][2], res["jax"][2])
    assert res["torch"][3] == res["jax"][3]


def test_interference_detector_alone():
    res = {}
    for pkg in PKGS:
        I = PKGS[pkg]["I"]
        det = I.InterferenceDetector(
            3, I.InterferenceConfig(quarantine_ratio=1.8, readmit_ratio=1.3,
                                    min_samples=3, min_drift_samples=2))
        rng = np.random.default_rng(11)
        flips = []
        for i in range(300):
            r = int(rng.integers(0, 3))
            lat = float(rng.uniform(1.0, 1.2))
            if r == 2 and 80 <= i < 160:
                lat *= 4.0
            if i == 200:
                det.force_quarantine(0)
            flips.append((det.observe(r, lat), det.drifts(),
                          det.healthy()))
        res[pkg] = (flips, list(det.events), det.baseline, det.fast,
                    det.samples)
    assert res["torch"][0] == res["jax"][0]
    assert res["torch"][1] == res["jax"][1]
    assert ("quarantine", 2) in res["torch"][1]
    for a, b in zip(res["torch"][2:], res["jax"][2:]):
        np.testing.assert_array_equal(a, b)


def test_admission_controller_alone():
    res = {}
    for pkg in PKGS:
        A, RC = PKGS[pkg]["A"], PKGS[pkg]["S"].RequestClass
        adm = A.AdmissionController(_slo(pkg, True))
        pol = adm.policy
        rng = np.random.default_rng(3)
        out = []
        for _ in range(200):
            c = RC(int(rng.integers(0, 3)))
            a = adm.decide(c, float(rng.uniform(0, 1)),
                           float(rng.uniform(0, 0.02)))
            out.append(a.value)
            if a.value == "queue" and rng.random() < 0.5:
                b = adm.evaluate(c, float(rng.uniform(0, 0.1)))
                if b.value != "queue":
                    adm.reclassify(c, a, b)
                out.append(b.value)
        out.append((pol.priority_of(RC.DECODE), pol.weight_of("a"),
                    pol.weight_of("z"), pol.tpot_budget(RC.DECODE)))
        res[pkg] = (out, _plain(adm.counts()))
    assert res["torch"] == res["jax"]


def test_straggler_rebalancer_alone():
    res = {}
    for pkg in PKGS:
        reb = PKGS[pkg]["E"].StragglerRebalancer(4, 30, hysteresis=0.05)
        rng = np.random.default_rng(5)
        speed = np.array([1.0, 1.0, 2.5, 1.2])
        out = [reb.rebalance().tolist()]
        for i in range(30):
            if i == 15:
                speed[0] = 3.0
            reb.observe(reb.alloc * speed * rng.uniform(0.95, 1.05, 4))
            out.append((reb.rebalance().tolist(),
                        reb.makespan(reb.alloc)))
        res[pkg] = (out, reb.t_ema)
    assert res["torch"][0] == res["jax"][0]
    np.testing.assert_array_equal(res["torch"][1], res["jax"][1])


@pytest.mark.parametrize("seeded", [True, False])
def test_heartbeat_monitor_alone(seeded):
    res = {}
    for pkg in PKGS:
        hb = PKGS[pkg]["E"].HeartbeatMonitor(
            4, timeout=2.5, now=100.0 if seeded else None)
        out = []
        for t in range(101, 120):
            for g in range(4):
                if not (g == 3 and 105 <= t < 112) and g != 1:
                    hb.beat(g, float(t))
            out.append(sorted(hb.check(float(t))))
        res[pkg] = (out, hb.last)
    assert res["torch"][0] == res["jax"][0]
    np.testing.assert_array_equal(res["torch"][1], res["jax"][1])
    assert res["torch"][0][-1] == [1, 3]
