"""Task-DAG model: criticality, parallelism, and the random-DAG generator.

Implements paper §2 (criticality values assigned bottom-up; critical path =
longest path; average parallelism = total tasks / critical tasks) and §4.2.2
(Topcuoglu-style random DAG generation with per-kernel task counts, average
width, edge rate, seed, plus the data-reuse memory-assignment step).

This is the PyTorch port's copy of ``repro.core.dag`` (numpy only): the
generator makes the same numpy draws in the same order, so one seed gives
the same DAG in both packages.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class KernelType(enum.IntEnum):
    """The paper's three kernel classes (§4.2.1) + GEMM for VGG-16 (§4.3)."""
    MATMUL = 0     # compute-intensive: 64x64 matmul
    SORT = 1       # cache-intensive: 262KB quick+merge sort (par <= 4)
    COPY = 2       # streaming: 16.8MB copy
    GEMM = 3       # VGG-16 layer GEMM TAOs


@dataclasses.dataclass
class TaskNode:
    """One TAO in the TAO-DAG."""
    nid: int
    kernel: KernelType
    work: float = 1.0              # abstract work units (platform model scales)
    criticality: int = 0
    parents: list[int] = dataclasses.field(default_factory=list)
    children: list[int] = dataclasses.field(default_factory=list)
    data_slot: int = -1            # memory location index (data-reuse step)
    # runtime state
    n_pending_parents: int = 0


class TaskDAG:
    def __init__(self, nodes: list[TaskNode]):
        self.nodes = nodes
        self._assign_criticality()

    # ---- paper §2 --------------------------------------------------------
    def _assign_criticality(self) -> None:
        """crit(leaf)=1; crit(v) = 1 + max(crit(children)). Bottom-up
        traversal requires the full DAG (paper §2)."""
        order = self.topo_order()
        for nid in reversed(order):
            n = self.nodes[nid]
            n.criticality = 1 + max(
                (self.nodes[c].criticality for c in n.children), default=0)

    def topo_order(self) -> list[int]:
        indeg = [len(n.parents) for n in self.nodes]
        stack = [n.nid for n in self.nodes if not n.parents]
        out: list[int] = []
        while stack:
            nid = stack.pop()
            out.append(nid)
            for c in self.nodes[nid].children:
                indeg[c] -= 1
                if indeg[c] == 0:
                    stack.append(c)
        if len(out) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return out

    @property
    def critical_path_length(self) -> int:
        return max((n.criticality for n in self.nodes), default=0)

    def critical_tasks(self) -> set[int]:
        """Tasks on *a* longest path: start nodes of maximal criticality plus
        every child continuing the chain (crit diff exactly 1)."""
        crit: set[int] = set()
        top = self.critical_path_length
        frontier = [n.nid for n in self.nodes
                    if n.criticality == top and not n.parents]
        while frontier:
            nid = frontier.pop()
            if nid in crit:
                continue
            crit.add(nid)
            n = self.nodes[nid]
            frontier.extend(c for c in n.children
                            if self.nodes[c].criticality == n.criticality - 1)
        return crit

    @property
    def parallelism(self) -> float:
        """Average DAG parallelism = total tasks / critical-path length."""
        return len(self.nodes) / max(1, self.critical_path_length)

    def roots(self) -> list[int]:
        return [n.nid for n in self.nodes if not n.parents]

    def reset_runtime_state(self) -> None:
        for n in self.nodes:
            n.n_pending_parents = len(n.parents)


def is_critical_child(parent: TaskNode, child: TaskNode) -> bool:
    """Paper's runtime rule (commit-and-wake-up): the woken child is critical
    iff parent.criticality - child.criticality == 1."""
    return parent.criticality - child.criticality == 1


# ---------------------------------------------------------------------------
# Random DAG generation (paper §4.2.2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RandomDAGConfig:
    tasks_per_kernel: dict[KernelType, int]
    avg_width: int            # desired level of parallelism
    edge_rate: float          # average connected edges per task
    seed: int = 0


def generate_random_dag(cfg: RandomDAGConfig) -> TaskDAG:
    """Three-step generation (paper §4.2.2): (1) shape — nodes arranged into
    levels of ~avg_width and random edges between consecutive levels at
    edge_rate; (2) data-reuse memory assignment; (3) node spawn."""
    rng = np.random.default_rng(cfg.seed)
    total = sum(cfg.tasks_per_kernel.values())
    if total == 0:
        return TaskDAG([])

    # kernel mix, shuffled
    kinds: list[KernelType] = []
    for k, cnt in cfg.tasks_per_kernel.items():
        kinds += [k] * cnt
    rng.shuffle(kinds)

    # -- step 1: shape ------------------------------------------------------
    nodes = [TaskNode(nid=i, kernel=kinds[i]) for i in range(total)]
    levels: list[list[int]] = []
    i = 0
    while i < total:
        w = max(1, int(rng.poisson(cfg.avg_width)))
        levels.append(list(range(i, min(i + w, total))))
        i += w
    for li in range(1, len(levels)):
        cur = levels[li]
        for nid in cur:
            # each task receives on average `edge_rate` in-edges drawn from
            # the few preceding levels (geometric decay over distance), like
            # Topcuoglu-style generators: path lengths vary, so criticality
            # values differentiate and a genuine critical path emerges.
            k = max(1, int(rng.poisson(cfg.edge_rate)))
            for _ in range(k):
                back = min(li, 1 + int(rng.geometric(0.65)) - 1)
                back = max(1, min(back, li))
                prev = levels[li - back]
                p = int(prev[rng.integers(len(prev))])
                if p in nodes[nid].parents:
                    continue
                nodes[p].children.append(nid)
                nodes[nid].parents.append(p)

    # -- step 2: data-reuse memory assignment (paper's vector walk) ---------
    # One vector per kernel; each entry is "the node currently owning that
    # memory location".  A node inherits a predecessor's slot when possible
    # (data reuse), else claims a fresh slot (isolated parallel execution).
    slot_owner: dict[KernelType, list[int]] = {k: [] for k in KernelType}
    for n in nodes:
        vec = slot_owner[n.kernel]
        slot = -1
        for p in n.parents:
            if nodes[p].kernel != n.kernel:
                continue
            try:
                idx = vec.index(p)
            except ValueError:
                continue
            vec[idx] = n.nid
            slot = idx
            break
        if slot < 0:
            vec.append(n.nid)
            slot = len(vec) - 1
        n.data_slot = slot

    # -- step 3: spawn -------------------------------------------------------
    return TaskDAG(nodes)


def chain_dag(kernel: KernelType, length: int) -> TaskDAG:
    """A pure chain (parallelism 1) — the paper's hardest case (Fig. 7)."""
    nodes = [TaskNode(nid=i, kernel=kernel) for i in range(length)]
    for i in range(length - 1):
        nodes[i].children.append(i + 1)
        nodes[i + 1].parents.append(i)
    return TaskDAG(nodes)


def paper_fig1_dag() -> TaskDAG:
    """The paper's Figure 1 DAG: A..G with critical path A->C->G->D->F of
    length 5 and parallelism 7/5 = 1.4.  Node ids: A=0,B=1,C=2,D=3,E=4,F=5,G=6."""
    A, B, C, D, E, F, G = range(7)
    nodes = [TaskNode(nid=i, kernel=KernelType.MATMUL) for i in range(7)]
    edges = [(A, C), (A, E), (B, G), (C, G), (G, D), (D, F)]
    for p, c in edges:
        nodes[p].children.append(c)
        nodes[c].parents.append(p)
    return TaskDAG(nodes)
