"""The paper's runtime path in the port (``repro_torch.core``: ``dag``,
``scheduler``, ``runtime``, ``real_kernels``) on the CPU, held against the
JAX package's ``repro.core`` (numpy only, no JAX involved):

* the DAG generators give identical DAGs, field by field, for the same
  seed;
* both schedulers, driven through one scripted sequence of ``place`` and
  ``record`` calls, make identical placements and train identical PTTs;
* the port's ``ThreadedRuntime`` over its ``KernelPool(device="cpu")``
  completes every task under both policies with one PTT sample per task
  and valid places; its pool draws the reference pool's data, and its
  matmul and copy outputs equal a reference pool's run (1e-5 relative and
  1e-5 * sqrt(K) absolute for matmul, the two sides summing in different
  orders; copy exact); every sort output is its source sorted per chunk
  of the slot's last writer;
* a ``KernelPool`` with no device needs the card.

On the card the same path runs in ``chip_smoke.py``'s runtime phase.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.real_kernels import KernelPool as RefPool
from repro.core.runtime import ThreadedRuntime as RefRuntime
import repro_torch.core as T
from repro_torch.core.real_kernels import KernelPool
from repro_torch.core.runtime import ThreadedRuntime

RTOL = 1e-5
# the sizes of the reference's tests/test_runtime_threaded.py
POOL = dict(mat_n=32, sort_bytes=16_000, copy_bytes=64_000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and the suite's other
    workers keep their cores (their latency-driven tests read wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed(pkg, n, avg_width, edge_rate, seed):
    K = pkg.KernelType
    return pkg.generate_random_dag(pkg.RandomDAGConfig(
        tasks_per_kernel={K.MATMUL: n, K.SORT: n, K.COPY: n},
        avg_width=avg_width, edge_rate=edge_rate, seed=seed))


def _fields(dag):
    return [(int(n.kernel), n.work, n.criticality, n.parents, n.children,
             n.data_slot) for n in dag.nodes]


def _same_dag(got, want):
    assert _fields(got) == _fields(want)
    assert got.critical_path_length == want.critical_path_length
    assert got.parallelism == want.parallelism
    assert got.critical_tasks() == want.critical_tasks()
    assert got.roots() == want.roots()
    assert got.topo_order() == want.topo_order()


# ---------------------------------------------------------------------------
# DAGs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,avg_width,edge_rate,seed", [
    (150, 4, 2.0, 0),        # the paper's mixed DAG (chip_smoke's)
    (150, 4, 2.0, 1),
    (15, 3, 2.0, 3),         # the threaded-runtime tests'
    (40, 1, 0.5, 7),         # a near-chain
    (30, 8, 3.0, 11),        # wide and dense
])
def test_random_dag_matches_reference(n, avg_width, edge_rate, seed):
    _same_dag(_mixed(T, n, avg_width, edge_rate, seed),
              _mixed(R, n, avg_width, edge_rate, seed))


def test_paper_mixed_dag_shape():
    dag = _mixed(T, 150, 4, 2.0, 0)
    assert len(dag.nodes) == 450
    assert dag.critical_path_length == 105
    assert max(n.data_slot for n in dag.nodes) + 1 == 105


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.chain_dag(pkg.KernelType.SORT, 12),
    lambda pkg: pkg.paper_fig1_dag(),
    lambda pkg: pkg.generate_random_dag(pkg.RandomDAGConfig(
        tasks_per_kernel={}, avg_width=2, edge_rate=1.0)),
], ids=["chain", "fig1", "empty"])
def test_fixed_dags_match_reference(make):
    _same_dag(make(T), make(R))


def test_fig1_critical_path():
    dag = T.paper_fig1_dag()
    assert dag.critical_path_length == 5
    assert dag.parallelism == pytest.approx(1.4)
    assert T.is_critical_child(dag.nodes[0], dag.nodes[2])      # A -> C
    assert not T.is_critical_child(dag.nodes[0], dag.nodes[4])  # A -> E


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------

def _layouts(pkg):
    return {"homogeneous4": pkg.homogeneous_layout(4),
            "two_clusters": pkg.ClusterLayout(clusters=((0, 1),
                                                        (2, 3, 4, 5)))}


@pytest.mark.parametrize("layout", ["homogeneous4", "two_clusters"])
@pytest.mark.parametrize("policy", ["homogeneous", "homogeneous_w2",
                                    "performance"])
def test_schedulers_match_reference(policy, layout):
    """One scripted sequence of (task, core, critical) placements and
    elapsed-time records through both packages' policies."""
    def make(pkg):
        lay = _layouts(pkg)[layout]
        if policy == "performance":
            return pkg.PerformanceBasedScheduler(lay, len(pkg.KernelType))
        return pkg.HomogeneousScheduler(
            lay, static_width=2 if policy == "homogeneous_w2" else 1)

    got, want = make(T), make(R)
    rng = np.random.default_rng(5)
    cores = got.layout.num_cores
    for i in range(300):
        kernel = int(rng.integers(0, 4))
        core, critical = int(rng.integers(0, cores)), bool(rng.integers(0, 2))
        elapsed = float(rng.exponential(1e-3 * (kernel + 1)))
        p = got.place(T.TaskNode(nid=i, kernel=T.KernelType(kernel)), core,
                      critical)
        q = want.place(R.TaskNode(nid=i, kernel=R.KernelType(kernel)), core,
                       critical)
        assert (p.leader, p.width) == (q.leader, q.width), i
        assert got.layout.is_valid(p)
        got.record(T.TaskNode(nid=i, kernel=T.KernelType(kernel)), p, elapsed)
        want.record(R.TaskNode(nid=i, kernel=R.KernelType(kernel)), q,
                    elapsed)
    if policy == "performance":
        assert got.ptt.updates == want.ptt.updates == 300
        for t in range(4):
            np.testing.assert_array_equal(got.ptt.table(t),
                                          want.ptt.table(t))


# ---------------------------------------------------------------------------
# the threaded runtime over the kernel pool
# ---------------------------------------------------------------------------

def _last_writers(dag):
    """(kernel, slot) -> the highest node id writing it: a slot's tasks
    form a dependency chain, so that node writes last."""
    last = {}
    for n in dag.nodes:
        key = (n.kernel, n.data_slot)
        last[key] = max(n.nid, last.get(key, -1))
    return last


@pytest.mark.parametrize("policy", ["homogeneous", "performance"])
def test_threaded_runtime_matches_reference_pool(policy):
    dag, rdag = _mixed(T, 15, 3, 2.0, 3), _mixed(R, 15, 3, 2.0, 3)
    n_slots = 45
    pool = KernelPool(n_slots, device="cpu", **POOL)
    ref = RefPool(n_slots, **POOL)
    for mine, theirs in ((pool.mats, ref.mats), (pool.sort_src, ref.sort_src),
                         (pool.copy_src, ref.copy_src)):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a.numpy(), b)

    def make(pkg):
        lay = pkg.homogeneous_layout(4)
        if policy == "performance":
            return pkg.PerformanceBasedScheduler(lay, 4)
        return pkg.HomogeneousScheduler(lay)

    pol = make(T)
    placements = ThreadedRuntime(pol, num_workers=4, seed=0).run(
        dag, pool.bodies_for_dag(dag), timeout=90)
    RefRuntime(make(R), num_workers=4, seed=0).run(
        rdag, ref.bodies_for_dag(rdag), timeout=90)

    assert len(placements) == len(dag.nodes)
    layout = T.homogeneous_layout(4)
    assert all(layout.is_valid(T.Place(l, w)) for l, w in placements.values())
    if policy == "performance":
        assert pol.ptt.updates == len(dag.nodes)
    else:
        assert all(w == 1 for _, w in placements.values())
    K = T.KernelType
    for (kernel, slot), nid in _last_writers(dag).items():
        if kernel == K.MATMUL:
            np.testing.assert_allclose(pool.mat_out[slot].numpy(),
                                       ref.mat_out[slot], rtol=RTOL,
                                       atol=RTOL * np.sqrt(POOL["mat_n"]))
        elif kernel == K.COPY:
            np.testing.assert_array_equal(pool.copy_dst[slot].numpy(),
                                          ref.copy_dst[slot])
        else:
            src, dst = ref.sort_src[slot], pool.sort_dst[slot].numpy()
            w, m = placements[nid][1], len(src)
            for c in range(w):
                lo, hi = c * m // w, (c + 1) * m // w
                np.testing.assert_array_equal(dst[lo:hi], np.sort(src[lo:hi]))
    # slots no matmul task wrote stay zero in both
    written = {s for (k, s) in _last_writers(dag) if k == K.MATMUL}
    for s in set(range(n_slots)) - written:
        assert not pool.mat_out[s].any() and not ref.mat_out[s].any()


def test_threaded_runtime_fig1_homogeneous():
    dag = T.paper_fig1_dag()
    pool = KernelPool(7, mat_n=24, sort_bytes=8_000, copy_bytes=32_000,
                      device="cpu")
    placements = ThreadedRuntime(T.HomogeneousScheduler(
        T.homogeneous_layout(3)), num_workers=3, seed=1).run(
            dag, pool.bodies_for_dag(dag), timeout=60)
    assert len(placements) == 7
    assert all(w == 1 for _, w in placements.values())
    a = pool.mats[0]
    torch.testing.assert_close(pool.mat_out[0], a @ a, rtol=RTOL,
                               atol=RTOL * np.sqrt(24))


def test_threaded_runtime_raises_a_body_error():
    """A body that fails ends the run at once (the reference would wait
    for its timeout)."""
    dag = T.chain_dag(T.KernelType.COPY, 5)

    def body(chunk, width):
        raise ValueError("broken body")

    rt = ThreadedRuntime(T.HomogeneousScheduler(T.homogeneous_layout(2)),
                         num_workers=2)
    with pytest.raises(RuntimeError, match="TAO body failed") as info:
        rt.run(dag, {n.nid: body for n in dag.nodes}, timeout=30)
    assert isinstance(info.value.__cause__, ValueError)


def test_kernel_pool_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KernelPool(1, **POOL)


def test_kernel_pool_bodies_split_rows_like_the_reference():
    """Width 3 on rows that do not divide: each chunk writes exactly its
    [chunk * n // w, (chunk + 1) * n // w) rows."""
    pool = KernelPool(1, device="cpu", **POOL)
    ref = RefPool(1, **POOL)
    for kernel in (T.KernelType.MATMUL, T.KernelType.COPY,
                   T.KernelType.SORT):
        body = pool.body(kernel, 0)
        rbody = ref.body(R.KernelType(int(kernel)), 0)
        body(1, 3)
        rbody(1, 3)
    n = POOL["mat_n"]
    lo, hi = n // 3, 2 * n // 3
    np.testing.assert_allclose(pool.mat_out[0][lo:hi].numpy(),
                               ref.mat_out[0][lo:hi], rtol=RTOL,
                               atol=RTOL * np.sqrt(n))
    assert not pool.mat_out[0][:lo].any() and not pool.mat_out[0][hi:].any()
    m = POOL["copy_bytes"] // 4
    np.testing.assert_array_equal(pool.copy_dst[0][m // 3:2 * m // 3].numpy(),
                                  ref.copy_src[0][m // 3:2 * m // 3])
    s = POOL["sort_bytes"] // 4
    np.testing.assert_array_equal(
        pool.sort_dst[0][s // 3:2 * s // 3].numpy(),
        np.sort(ref.sort_src[0][s // 3:2 * s // 3]))


def test_core_exports_the_reference_runtime_names():
    names = ("KernelType", "RandomDAGConfig", "TaskDAG", "TaskNode",
             "chain_dag", "generate_random_dag", "is_critical_child",
             "paper_fig1_dag", "HomogeneousScheduler",
             "PerformanceBasedScheduler", "SchedulingPolicy")
    assert all(hasattr(T, n) and n in T.__all__ for n in names)
    assert dataclasses.is_dataclass(T.TaskNode)
