"""PTT-driven elasticity at pod scale: the port's copy of
``repro.distributed.elastic``.

* :class:`PodPTT` — a Performance Trace Table whose "cores" are device
  groups; the serving scheduler searches it.
* :class:`StragglerRebalancer` — the paper's interference response
  (Fig. 8) applied to synchronous data parallelism: per-group step
  latencies shift the microbatch allocation toward fast groups.
* :class:`HeartbeatMonitor` + :func:`elastic_remesh` — a group silent for
  ``timeout`` is declared dead (the fleet gateway runs one on its pump
  clock); training re-places its state on a mesh of the survivors and
  goes on (the deterministic data pipeline replays from the step).

:class:`RooflineLatencyModel` seeds simulated group latencies from the
port's dry-run artifacts (``launch/dryrun.py``), so pod-scale scheduling
decisions follow the traced program's own cost structure."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
from torch.distributed.tensor import DTensor, distribute_tensor

from ..core.places import homogeneous_layout
from ..core.ptt import PTT, PTTConfig
from ..core.tracetable import CostModel, EMASearchMixin, TraceTable
from ..tree import tree_map


@dataclasses.dataclass
class RooflineLatencyModel:
    """t(width) = t_fixed + t_scale / width + t_coll * (width-1)/width,
    anchored at the dry-run mesh width.  Compute+memory terms scale down
    with width (more chips per replica); the collective term grows toward
    its ring asymptote."""

    t_scale: float
    t_fixed: float
    t_coll: float
    anchor_width: int

    @classmethod
    def from_artifact(cls, path: str) -> "RooflineLatencyModel":
        with open(path) as f:
            rec = json.load(f)
        r = rec["roofline"]
        # anchor at the mesh the artifact was traced for; 16 is only a
        # fallback for a record without "chips"
        w0 = int(rec.get("chips") or 16)
        # a single-chip artifact carries no collective-scaling information
        # (its ring term is identically zero)
        t_coll = (r["t_collective"] / ((w0 - 1) / w0)) if w0 > 1 else 0.0
        return cls(t_scale=(r["t_compute"] + r["t_memory"]) * w0,
                   t_fixed=0.0, t_coll=t_coll, anchor_width=w0)

    def latency(self, width: int) -> float:
        w = max(1, width)
        return self.t_fixed + self.t_scale / w + self.t_coll * (w - 1) / w


class PodPTT(PTT):
    """PTT over device groups.  Task types index request/step classes
    (e.g. prefill length buckets, decode, train-microbatch).  A thin
    :class:`~repro_torch.core.ptt.PTT` subclass — one homogeneous cluster
    of groups — so the EMA/search math lives in exactly one place
    (:class:`~repro_torch.core.tracetable.TraceTable`)."""

    def __init__(self, num_groups: int, num_task_types: int):
        layout = homogeneous_layout(num_groups)
        super().__init__(PTTConfig(layout=layout,
                                   num_task_types=num_task_types))
        self.layout = layout
        self.last_update = np.zeros(num_groups)

    def record(self, task_type: int, leader: int, width: int, elapsed: float,
               now: float) -> None:
        self.update(task_type, leader, width, elapsed)
        self.last_update[leader:leader + width] = now

    def place_critical(self, task_type: int,
                       metric: str | CostModel = "occupancy"):
        return self.global_search(task_type, metric=metric)

    def width_local(self, task_type: int, group: int):
        return self.local_search(task_type, group)


# ---------------------------------------------------------------------------
# straggler-aware data parallelism
# ---------------------------------------------------------------------------

class StragglerRebalancer(EMASearchMixin):
    """EMA-1:4 per-group step times -> proportional microbatch allocation.

    With per-group time t_i for one microbatch, assigning n_i ~ 1/t_i
    equalizes finish times; the allocation is recomputed only when the
    predicted makespan improves by `hysteresis` (avoids thrashing on noise,
    like the paper's EMA damping)."""

    def __init__(self, n_groups: int, total_microbatches: int,
                 hysteresis: float = 0.05):
        self.n = n_groups
        self.total = total_microbatches
        self.hysteresis = hysteresis
        # per-group EMA'd per-microbatch time; 0 = untrained
        self.trace = TraceTable((n_groups,), metrics=("mb_time",))
        self.alloc = self._even()

    @property
    def t_ema(self) -> np.ndarray:
        return self.trace.array()

    def _even(self) -> np.ndarray:
        base = self.total // self.n
        alloc = np.full(self.n, base)
        alloc[: self.total - base * self.n] += 1
        return alloc

    def observe(self, group_times: np.ndarray) -> None:
        """group_times: wall time of each group's current allocation."""
        self.trace.merge_array(group_times / np.maximum(self.alloc, 1))

    def makespan(self, alloc: np.ndarray) -> float:
        return float(np.max(alloc * self.t_ema))

    def rebalance(self) -> np.ndarray:
        if np.any(self.t_ema == 0):
            return self.alloc
        speed = 1.0 / self.t_ema
        ideal = speed / speed.sum() * self.total
        alloc = np.maximum(1, np.floor(ideal)).astype(int)
        # distribute the remainder to the fastest finishers
        while alloc.sum() < self.total:
            finish = (alloc + 1) * self.t_ema
            alloc[np.argmin(finish)] += 1
        while alloc.sum() > self.total:
            finish = alloc * self.t_ema
            alloc[np.argmax(finish)] -= 1
        if self.makespan(alloc) < self.makespan(self.alloc) * (
                1 - self.hysteresis):
            self.alloc = alloc
        return self.alloc


# ---------------------------------------------------------------------------
# failure detection
# ---------------------------------------------------------------------------

class HeartbeatMonitor:
    """Declares a group dead after ``timeout`` without a beat.  The
    monitor is clock-agnostic (``beat``/``check`` take the caller's
    ``now``), so ``last`` is seeded from the *first* clock reading it
    sees — construction ``now`` if given, else the first ``beat``/
    ``check`` — giving never-beaten groups a full timeout of grace.
    (The old 0.0 seed declared the whole fleet dead on the first check
    whenever the caller's clock read beyond ``timeout`` at startup.)"""

    def __init__(self, n_groups: int, timeout: float,
                 now: float | None = None):
        self.timeout = timeout
        self.last = np.full(n_groups, 0.0 if now is None else float(now))
        self._seeded = now is not None
        self.dead: set[int] = set()

    def _seed(self, now: float) -> None:
        if not self._seeded:
            self._seeded = True
            self.last[:] = now

    def beat(self, group: int, now: float) -> None:
        self._seed(now)
        self.last[group] = now

    def check(self, now: float) -> set[int]:
        self._seed(now)
        for g in range(len(self.last)):
            if g not in self.dead and now - self.last[g] > self.timeout:
                self.dead.add(g)
        return self.dead


def elastic_remesh(tree, shardings_fn, new_mesh):
    """Re-place a tree of tensors onto a new (smaller or larger) mesh.
    ``shardings_fn(mesh)`` returns the matching tree of shardings
    (``sharding.NamedSharding``: a mesh and its placements).  Each leaf is
    gathered whole (``full_tensor()`` of a ``DTensor``, a plain tensor as
    it is) and distributed onto ``new_mesh``.  Every rank that holds a
    shard of a leaf takes part (gathering is collective over the old
    mesh); a rank outside ``new_mesh`` gets empty local shards."""
    def move(x, s):
        full = x.full_tensor() if isinstance(x, DTensor) else x
        return distribute_tensor(full, s.mesh, s.placements)
    return tree_map(move, tree, shardings_fn(new_mesh))
