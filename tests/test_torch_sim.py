"""The paper's simulator in the port (``repro_torch.sim``) held against the
JAX package's ``repro.sim`` (numpy only, no JAX involved):

* the platform models (``jetson_tx2``, ``haswell_2650v3``,
  ``restrict_platform`` views, ``tpu_pod_places``) equal field by field,
  and their execution-time model gives the same durations from the same
  seed;
* ``XiTAOSim`` on the same platform, policy, DAG and seed gives the same
  ``TaskRecord``s field by field, the same makespan bit for bit and the
  same trained PTT tables: the quickstart's chain and mixed DAGs (seeds
  0-3, both schedulers), the interference run's 2000-task DAG with and
  without its window, a DVFS run, VGG-16 with ``force_noncritical`` at 1,
  2 and 20 cores, and ``run_policy``;
* ``vgg16``'s layer GFLOPs, DAG shape (3,354 TAOs, 1,537,792 edges) and
  totals equal;
* the 11 behaviour tests of ``tests/test_scheduler_sim.py``,
  ``tests/test_vgg16.py`` and ``tests/test_system.py`` hold on the port,
  as cases of one parametrised test.
"""

import dataclasses

import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:         # optional dep: deterministic fallback
    from _hypothesis_shim import given, settings, strategies as st

import repro.core as R
import repro.sim as RS
import repro.sim.platform as RP
import repro.sim.vgg16 as RV
import repro_torch.core as T
import repro_torch.sim as TS
import repro_torch.sim.platform as TP
import repro_torch.sim.vgg16 as TV

PKGS = {"ref": (R, RS, RP, RV), "port": (T, TS, TP, TV)}


# ---------------------------------------------------------------------------
# platforms
# ---------------------------------------------------------------------------

PLATFORMS = {
    "tx2": lambda P: P.jetson_tx2(),
    "haswell": lambda P: P.haswell_2650v3(),
    "haswell-n1": lambda P: P.restrict_platform(P.haswell_2650v3(), 1),
    "haswell-n2": lambda P: P.restrict_platform(P.haswell_2650v3(), 2),
    "haswell-n8": lambda P: P.restrict_platform(P.haswell_2650v3(), 8),
    "haswell-n20": lambda P: P.restrict_platform(P.haswell_2650v3(), 20),
    "tx2-n3": lambda P: P.restrict_platform(P.jetson_tx2(), 3),
    "pod": lambda P: P.tpu_pod_places(),
    "pod-slow": lambda P: P.tpu_pod_places(8, (1, 2), 0.5),
}


def _platform_fields(p):
    out = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if f.name == "_rng":
            continue
        if f.name in ("speed", "width_eff"):
            v = {int(k): (x.tolist() if isinstance(x, np.ndarray) else x)
                 for k, x in v.items()}
        out[f.name] = v
    return out


@pytest.mark.parametrize("name", sorted(PLATFORMS))
def test_platform_matches_reference(name):
    ref, port = PLATFORMS[name](RP), PLATFORMS[name](TP)
    assert _platform_fields(port) == _platform_fields(ref)
    assert port.valid_widths() == ref.valid_widths()
    assert port.layout() == T.ClusterLayout(ref.layout().clusters)
    for w in range(1, port.num_cores + 1):
        assert port.shares(w).tolist() == ref.shares(w).tolist()
        for k in R.KernelType:
            assert port.eff(T.KernelType(int(k)), w) == ref.eff(k, w)
    # the execution-time model from the same seed, contention included
    ref.reseed(7), port.reseed(7)
    rc, pc = RP.ContentionState(ref), TP.ContentionState(port)
    for k in R.KernelType:
        tk = T.KernelType(int(k))
        for leader, width in ((0, 1), (0, min(2, len(ref.clusters[0])))):
            rc.begin(k, leader), pc.begin(tk, leader)
            assert (port.durations(tk, 3.0, leader, width, 1.0, pc).tolist()
                    == ref.durations(k, 3.0, leader, width, 1.0,
                                     rc).tolist())
    assert rc.active_any.tolist() == pc.active_any.tolist()


# ---------------------------------------------------------------------------
# simulations
# ---------------------------------------------------------------------------

def _mixed(C, s, w=4, n=150):
    K = C.KernelType
    return C.generate_random_dag(C.RandomDAGConfig(
        tasks_per_kernel={k: n for k in (K.MATMUL, K.SORT, K.COPY)},
        avg_width=w, edge_rate=2.0, seed=s))


def _interference_dag(C):
    return C.generate_random_dag(C.RandomDAGConfig(
        tasks_per_kernel={C.KernelType.MATMUL: 2000}, avg_width=8,
        edge_rate=2.0, seed=0))


def _windowed(P, S):
    hw = P.haswell_2650v3()
    hw.interference.append(S.InterferenceWindow(cores=(0, 1), t0=20.0,
                                                t1=60.0, slowdown=4.0))
    return hw


def _dvfs(P, S):
    tx2 = P.jetson_tx2()
    tx2.dvfs.append(S.DVFSEvent(cores=(0, 1), t0=30.0, t1=1e9, factor=0.25))
    return tx2


# case -> (platform, policy ("hom"/"perf"), DAG, seed, force_noncritical)
def _case(name):
    parts = name.split("-")
    if parts[0] == "chain":
        kern, pol, s = parts[1], parts[2], int(parts[3])
        return (lambda P, S: P.jetson_tx2(), pol,
                lambda C, V: C.chain_dag(C.KernelType[kern], 300), s, False)
    if parts[0] == "mixed":
        pol, s = parts[1], int(parts[2])
        return (lambda P, S: P.jetson_tx2(), pol,
                lambda C, V, s=s: _mixed(C, s), s, False)
    if parts[0] == "interference":
        plat = _windowed if parts[1] == "window" else (
            lambda P, S: P.haswell_2650v3())
        return plat, "perf", lambda C, V: _interference_dag(C), 0, False
    if parts[0] == "dvfs":
        return (_dvfs, "perf",
                lambda C, V: C.chain_dag(C.KernelType.MATMUL, 600), 0, False)
    n = int(parts[1])
    return (lambda P, S: P.restrict_platform(P.haswell_2650v3(), n), "perf",
            lambda C, V: V.vgg16_dag(V.VGGConfig()), 0, True)


SIM_CASES = (
    [f"chain-MATMUL-{p}-{s}" for p in ("hom", "perf") for s in range(4)]
    + [f"mixed-{p}-{s}" for p in ("hom", "perf") for s in range(4)]
    + ["chain-SORT-perf-0", "chain-COPY-hom-1", "interference-window",
       "interference-clean", "dvfs", "vgg-1", "vgg-2", "vgg-20"])


def _simulate(pkg, name):
    C, S, P, V = PKGS[pkg]
    plat_f, pol, dag_f, seed, noncrit = _case(name)
    plat = plat_f(P, S)
    policy = (C.HomogeneousScheduler(plat.layout()) if pol == "hom"
              else C.PerformanceBasedScheduler(plat.layout(), 4))
    res = S.XiTAOSim(plat, policy, seed=seed,
                     force_noncritical=noncrit).run(dag_f(C, V))
    tables = ([policy.ptt.table(k).tolist() for k in range(4)]
              if pol == "perf" else [])
    return res, tables


@pytest.mark.parametrize("name", SIM_CASES)
def test_sim_matches_reference(name):
    ref, ref_tables = _simulate("ref", name)
    port, port_tables = _simulate("port", name)
    assert len(port.records) == len(ref.records)
    assert ([dataclasses.asdict(r) for r in port.records]
            == [dataclasses.asdict(r) for r in ref.records])
    assert port.makespan == ref.makespan
    assert port.throughput == ref.throughput
    assert port.width_histogram() == ref.width_histogram()
    assert port_tables == ref_tables


def test_run_policy_matches_reference():
    out = {}
    for pkg, (C, S, P, _) in PKGS.items():
        tx2 = P.jetson_tx2()
        out[pkg] = S.run_policy(
            tx2, lambda: C.PerformanceBasedScheduler(tx2.layout(), 4),
            lambda s: _mixed(C, s, w=2, n=40), seeds=range(3))
    assert len(out["port"]) == 3
    for r, p in zip(out["ref"], out["port"]):
        assert p.makespan == r.makespan
        assert ([dataclasses.asdict(x) for x in p.records]
                == [dataclasses.asdict(x) for x in r.records])


def test_vgg16_matches_reference():
    assert TV.VGG16_LAYERS == RV.VGG16_LAYERS
    assert [TV.layer_gflops(i) for i in range(16)] == [
        RV.layer_gflops(i) for i in range(16)]
    assert TV.total_gflops() == RV.total_gflops()
    for cfg in ((4, 1), (8, 1), (64, 3)):
        r = RV.vgg16_dag(RV.VGGConfig(*cfg))
        t = TV.vgg16_dag(TV.VGGConfig(*cfg))
        assert ([(n.nid, int(n.kernel), n.work, n.parents, n.children)
                 for n in t.nodes]
                == [(n.nid, int(n.kernel), n.work, n.parents, n.children)
                    for n in r.nodes])
    d = TV.vgg16_dag()
    assert len(d.nodes) == 3354
    assert sum(len(n.children) for n in d.nodes) == 1_537_792
    assert d.critical_path_length == 16


# ---------------------------------------------------------------------------
# the reference's behaviour tests, on the port
# ---------------------------------------------------------------------------

K = T.KernelType


def _speedup(platform, dag_factory, seeds=range(5)):
    layout = platform.layout()
    hom, perf = [], []
    for s in seeds:
        hom.append(TS.XiTAOSim(platform, T.HomogeneousScheduler(layout),
                               seed=s).run(dag_factory(s)).throughput)
        perf.append(TS.XiTAOSim(
            platform, T.PerformanceBasedScheduler(layout, 4),
            seed=s).run(dag_factory(s)).throughput)
    return np.mean(perf) / np.mean(hom)


def _fig7_chain(kernel, floor):
    sp = _speedup(TS.jetson_tx2(), lambda s: T.chain_dag(kernel, 300))
    assert sp >= floor, f"{kernel.name} chain speedup {sp:.2f} < {floor}"


def _speedup_decreases_with_parallelism():
    tx2 = TS.jetson_tx2()
    sp = [_speedup(tx2, lambda s, w=w: _mixed(T, s, w), seeds=range(3))
          for w in (1, 4, 16)]
    assert sp[0] > sp[1] > 0.8 * sp[2]
    assert sp[0] >= 1.4
    assert sp[2] >= 0.85


def _fig8_interference_migration_and_recovery():
    hw = _windowed(TP, TS)
    dag = T.generate_random_dag(T.RandomDAGConfig(
        tasks_per_kernel={K.MATMUL: 1500}, avg_width=8, edge_rate=2.0,
        seed=0))
    res = TS.XiTAOSim(hw, T.PerformanceBasedScheduler(hw.layout(), 4),
                      seed=0).run(dag)
    crit = [r for r in res.records if r.critical]
    during = [r for r in crit if 22.0 <= r.t_start < 60.0]
    assert during, "no critical tasks during the window"
    assert np.mean([r.leader in (0, 1) for r in during]) <= 0.05
    assert [r for r in res.records if not r.critical and r.leader in (0, 1)
            and r.t_start >= 60.0], "PTT starved on interfered cores"
    clean = TS.XiTAOSim(
        TS.haswell_2650v3(),
        T.PerformanceBasedScheduler(TS.haswell_2650v3().layout(), 4),
        seed=0).run(dag)
    assert res.makespan <= clean.makespan * 1.12


def _vgg_run(n):
    p = TP.restrict_platform(TS.haswell_2650v3(), n)
    return TS.XiTAOSim(p, T.PerformanceBasedScheduler(p.layout(), 4), seed=0,
                       force_noncritical=True).run(TV.vgg16_dag(TV.VGGConfig()))


def _fig9_vgg_strong_scaling():
    times = {n: _vgg_run(n).makespan for n in (1, 8, 20)}
    assert times[1] / (8 * times[8]) >= 0.75
    assert 0.55 <= times[1] / (20 * times[20]) <= 1.0


def _fig10_width_histogram():
    h = _vgg_run(8).width_histogram()
    assert h, "no tasks recorded"
    assert h.get(1, 0) / sum(h.values()) >= 0.5


@given(n=st.integers(5, 60), width=st.integers(1, 8), seed=st.integers(0, 50))
@settings(max_examples=25, deadline=None)
def _liveness_no_deadlock(n, width, seed):
    dag_cfg = T.RandomDAGConfig(
        tasks_per_kernel={K.MATMUL: n // 3 + 1, K.SORT: n // 3 + 1,
                          K.COPY: n // 3 + 1},
        avg_width=width, edge_rate=1.5, seed=seed)
    tx2 = TS.jetson_tx2()
    for pol in (T.HomogeneousScheduler(tx2.layout()),
                T.PerformanceBasedScheduler(tx2.layout(), 4)):
        res = TS.XiTAOSim(tx2, pol, seed=seed).run(
            T.generate_random_dag(dag_cfg))
        assert len(res.records) == 3 * (n // 3 + 1)
        t_complete = {r.nid: r.t_complete for r in res.records}
        t_start = {r.nid: r.t_start for r in res.records}
        for node in T.generate_random_dag(dag_cfg).nodes:
            for c in node.children:
                assert t_start[c] >= t_complete[node.nid] - 1e-9


def _vgg_structure():
    assert len(TV.VGG16_LAYERS) == 16
    assert TV.vgg16_dag(TV.VGGConfig(block_len=64)).critical_path_length == 16


def _vgg_flops_scale():
    assert TV.total_gflops() == pytest.approx(30.9, rel=0.05)
    assert TV.layer_gflops(1) > TV.layer_gflops(0)


def _vgg_work_conservation():
    d = TV.vgg16_dag(TV.VGGConfig(block_len=8))
    assert sum(n.work for n in d.nodes) == pytest.approx(TV.total_gflops(),
                                                         rel=1e-6)


def _paper_headline_speedup():
    assert _speedup(TS.jetson_tx2(),
                    lambda s: T.chain_dag(K.MATMUL, 300)) >= 2.8


def _adapts_to_dvfs():
    tx2 = _dvfs(TP, TS)
    res = TS.XiTAOSim(tx2, T.PerformanceBasedScheduler(tx2.layout(), 4),
                      seed=0).run(T.chain_dag(K.MATMUL, 600))
    late = [r for r in res.records
            if r.critical and r.t_start > 0.6 * res.makespan]
    assert late
    assert np.mean([r.leader in (0, 1) for r in late]) < 0.2


BEHAVIOURS = {
    "fig7_chain_speedups[MATMUL]": lambda: _fig7_chain(K.MATMUL, 2.8),
    "fig7_chain_speedups[SORT]": lambda: _fig7_chain(K.SORT, 2.0),
    "fig7_chain_speedups[COPY]": lambda: _fig7_chain(K.COPY, 1.8),
    "speedup_decreases_with_parallelism": _speedup_decreases_with_parallelism,
    "fig8_interference_migration_and_recovery":
        _fig8_interference_migration_and_recovery,
    "fig9_vgg_strong_scaling": _fig9_vgg_strong_scaling,
    "fig10_width_histogram": _fig10_width_histogram,
    "liveness_no_deadlock": _liveness_no_deadlock,
    "vgg16_structure": _vgg_structure,
    "vgg16_flops_scale": _vgg_flops_scale,
    "vgg16_work_conservation": _vgg_work_conservation,
    "system_paper_headline_speedup": _paper_headline_speedup,
    "system_adapts_to_dvfs": _adapts_to_dvfs,
}


@pytest.mark.parametrize("name", sorted(BEHAVIOURS))
def test_reference_behaviour_holds_on_port(name):
    BEHAVIOURS[name]()
