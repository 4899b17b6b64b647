"""Discrete-event XiTAO engine (virtual time).

Executes the *exact* scheduler mechanics of paper §3 — per-core work-stealing
queues (WSQ, LIFO-own / FIFO-steal), FIFO assembly queues (AQ), random
stealing, irrevocable partitions, commit-and-wake-up criticality propagation,
leader-core PTT updates — against a
:class:`~repro_torch.sim.platform.PlatformModel` in deterministic virtual
time.  Virtual time makes the paper's *speedup*
claims assertable in CI on a 1-core container.

Race model: in the real runtime, idle cores spin on steal and usually win the
race against the completing core's own dequeue.  The engine models this by
raffling each newly-ready task between its owner and the currently-idle cores
(seeded RNG), which reproduces the uniformly-spread placement the paper's
homogeneous baseline exhibits.

This is the PyTorch port's copy of ``repro.sim.engine``, driving the
port's ``core.scheduler`` policies and ``core.ptt.PTT``.  The seeded
generator stays ``np.random.default_rng`` and the event heap keeps its
``(time, seq, core)`` order, so every :class:`TaskRecord` and makespan
equals the reference's exactly.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Iterable

import numpy as np

from ..core.dag import TaskDAG, TaskNode, is_critical_child
from ..core.places import Place
from ..core.scheduler import SchedulingPolicy
from .platform import ContentionState, PlatformModel


@dataclasses.dataclass
class Assignment:
    node: TaskNode
    place: Place
    durations: np.ndarray            # per member core
    t_insert: float
    member_start: np.ndarray | None = None
    remaining: int = 0
    leader_elapsed: float = -1.0
    t_first_start: float = -1.0

    def __post_init__(self):
        self.member_start = np.full(self.place.width, -1.0)
        self.remaining = self.place.width


@dataclasses.dataclass
class TaskRecord:
    nid: int
    kernel: int
    critical: bool
    leader: int
    width: int
    t_insert: float
    t_start: float
    t_complete: float
    leader_elapsed: float


@dataclasses.dataclass
class SimResult:
    makespan: float
    records: list[TaskRecord]

    @property
    def throughput(self) -> float:
        return len(self.records) / self.makespan if self.makespan > 0 else 0.0

    def width_histogram(self) -> dict[int, int]:
        h: dict[int, int] = {}
        for r in self.records:
            h[r.width] = h.get(r.width, 0) + 1
        return h


class XiTAOSim:
    def __init__(self, platform: PlatformModel, policy: SchedulingPolicy,
                 num_cores: int | None = None, seed: int = 0,
                 force_noncritical: bool = False):
        self.platform = platform
        self.policy = policy
        self.num_cores = num_cores or platform.num_cores
        self.rng = np.random.default_rng(seed)
        self.force_noncritical = force_noncritical
        platform.reseed(seed * 7919 + 13)   # deterministic timing jitter

    # ------------------------------------------------------------------
    def run(self, dag: TaskDAG) -> SimResult:
        dag.reset_runtime_state()
        n_cores = self.num_cores
        wsq: list[deque[TaskNode]] = [deque() for _ in range(n_cores)]
        aq: list[deque[Assignment]] = [deque() for _ in range(n_cores)]
        # tasks won in a steal race; private to the winner (a real thief has
        # the task in hand the instant it wins the CAS — nobody can re-steal)
        mailbox: list[deque[TaskNode]] = [deque() for _ in range(n_cores)]
        current: list[tuple[Assignment, float] | None] = [None] * n_cores
        idle: set[int] = set(range(n_cores))
        crit_flag = np.zeros(len(dag.nodes), dtype=bool)
        contention = ContentionState(self.platform)
        records: list[TaskRecord] = []
        remaining_tasks = len(dag.nodes)

        heap: list[tuple[float, int, int]] = []
        seq = 0

        def schedule(t: float, core: int) -> None:
            nonlocal seq
            heapq.heappush(heap, (t, seq, core))
            seq += 1

        def wake(core: int, t: float) -> None:
            if core in idle:
                idle.discard(core)
                schedule(t, core)

        def push_ready(node: TaskNode, owner: int, t: float) -> None:
            """Owner pushes; idle cores race to steal (see module doc)."""
            cands = [owner] + sorted(idle - {owner})
            winner = owner if len(cands) == 1 else int(
                cands[self.rng.integers(len(cands))])
            if winner == owner:
                wsq[winner].append(node)
            else:
                mailbox[winner].append(node)
            wake(winner, t)

        def dispatch(node: TaskNode, core: int, t: float) -> None:
            critical = bool(crit_flag[node.nid]) and not self.force_noncritical
            place = self.policy.place(node, core, critical)
            durs = self.platform.durations(
                node.kernel, node.work, place.leader, place.width, t,
                contention)
            contention.begin(node.kernel, place.leader)
            a = Assignment(node=node, place=place, durations=durs, t_insert=t)
            for m in place.cores:
                aq[m].append(a)
                wake(m, t)

        def complete(a: Assignment, t: float) -> None:
            nonlocal remaining_tasks
            contention.end(a.node.kernel, a.place.leader)
            self.policy.record(a.node, a.place, a.leader_elapsed)
            records.append(TaskRecord(
                nid=a.node.nid, kernel=int(a.node.kernel),
                critical=bool(crit_flag[a.node.nid]), leader=a.place.leader,
                width=a.place.width, t_insert=a.t_insert,
                t_start=a.t_first_start, t_complete=t,
                leader_elapsed=a.leader_elapsed))
            remaining_tasks -= 1
            # commit-and-wake-up (paper §3.3).  The criticality chain
            # propagates only through critical parents and does not branch
            # (CATS, the paper's base, keeps a single critical chain: on
            # ties the first diff-1 child continues the path).  The chain
            # head is the start node of the longest path — it carries the
            # DAG's maximum criticality (paper §2); it is *scheduled* as
            # non-critical (paper §3.3) but seeds the chain.
            parent_on_chain = crit_flag[a.node.nid] or a.node.nid == chain_head
            marked_one = False
            for cid in a.node.children:
                child = dag.nodes[cid]
                if (parent_on_chain and not marked_one
                        and is_critical_child(a.node, child)):
                    crit_flag[cid] = True
                    marked_one = True
                child.n_pending_parents -= 1
                if child.n_pending_parents == 0:
                    push_ready(child, a.place.leader, t)

        # seed roots round-robin (default insertion policy); roots are
        # non-critical (paper §3.3: criticality of parentless tasks unknown)
        roots = dag.roots()
        chain_head = (max(roots, key=lambda r: dag.nodes[r].criticality)
                      if roots else -1)
        for i, rid in enumerate(roots):
            wsq[i % n_cores].append(dag.nodes[rid])
        idle.clear()
        for c in range(n_cores):
            schedule(0.0, c)

        makespan = 0.0
        while heap:
            t, _, core = heapq.heappop(heap)
            # finish an in-flight share if one ends now
            if current[core] is not None:
                a, t_end = current[core]
                if t_end > t:          # spurious wake while busy
                    continue
                current[core] = None
                i = core - a.place.leader
                if i == 0:
                    a.leader_elapsed = t - a.member_start[0]
                a.remaining -= 1
                if a.remaining == 0:
                    complete(a, t)
                    makespan = max(makespan, t)
            # core work loop
            while True:
                if aq[core]:
                    a = aq[core].popleft()
                    i = core - a.place.leader
                    a.member_start[i] = t
                    if a.t_first_start < 0:
                        a.t_first_start = t
                    d = float(a.durations[i])
                    current[core] = (a, t + d)
                    schedule(t + d, core)
                    break
                if mailbox[core]:
                    dispatch(mailbox[core].popleft(), core, t)
                    continue
                if wsq[core]:
                    dispatch(wsq[core].pop(), core, t)   # LIFO own end
                    continue
                victims = [v for v in range(n_cores) if v != core and wsq[v]]
                if victims:
                    v = int(victims[self.rng.integers(len(victims))])
                    dispatch(wsq[v].popleft(), core, t)  # FIFO steal end
                    continue
                idle.add(core)
                break

        if remaining_tasks != 0:
            raise RuntimeError(
                f"deadlock: {remaining_tasks} tasks never completed")
        return SimResult(makespan=makespan, records=records)


def run_policy(platform: PlatformModel, policy_factory, dag_factory,
               seeds: Iterable[int], num_cores: int | None = None,
               force_noncritical: bool = False) -> list[SimResult]:
    """Average-over-seeds helper: fresh policy + DAG per seed (the PTT must
    re-train; the paper's runs also start cold)."""
    out = []
    for s in seeds:
        sim = XiTAOSim(platform, policy_factory(), num_cores=num_cores,
                       seed=s, force_noncritical=force_noncritical)
        out.append(sim.run(dag_factory(s)))
    return out
