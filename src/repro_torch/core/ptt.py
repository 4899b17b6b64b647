"""Performance Trace Table (PTT) — the paper's primary data structure at
its original scale: CPU cores.

``PTT`` is a thin instantiation of :class:`repro.core.tracetable.TraceTable`
(the one EMA/search implementation shared by every scale) with key axes
(task type, leader core, width index), aware of the cluster layout: valid
(leader, width) pairs never straddle an LLC cluster, and the entry count
per cluster of N cores is 2N-1 for power-of-two N (paper §3.3 overhead
argument).  Entries start at 0.0 ("zero predicted time"), which makes
untrained configurations globally optimal until visited (§3.2); updates
are performed only by the task's *leader* core, which keeps each row local
to one core (the cache-line layout lives in TraceTable).

Searches take a :class:`~repro.core.tracetable.CostModel` — or the legacy
metric strings ``"occupancy"`` / ``"latency"``, which map to the
:class:`~repro.core.tracetable.Occupancy` and
:class:`~repro.core.tracetable.Latency` models.

The functional ops (:func:`ptt_update`, :func:`ptt_global_search`,
:func:`ptt_local_search`, on torch tensors) are re-exported from
:mod:`repro_torch.core.tracetable` for the pod-scale elastic runtime.
This is the PyTorch port's copy of ``repro.core.ptt``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .places import ClusterLayout, Place
from .tracetable import (EMA_DEN, EMA_OLD, Candidate, CostModel,
                         EMASearchMixin, Latency, Occupancy, TraceTable,
                         make_ptt_array, ptt_global_search, ptt_local_search,
                         ptt_update)

__all__ = [
    "EMA_DEN", "EMA_OLD", "EMASearchMixin", "PTT", "PTTConfig",
    "make_ptt_array", "ptt_global_search", "ptt_local_search", "ptt_update",
]

# legacy string metrics -> first-class cost models
_METRICS = {"occupancy": Occupancy(), "latency": Latency()}


def as_cost(metric: str | CostModel) -> CostModel:
    return metric if isinstance(metric, CostModel) else _METRICS[metric]


@dataclasses.dataclass(frozen=True)
class PTTConfig:
    layout: ClusterLayout
    num_task_types: int

    @property
    def num_cores(self) -> int:
        return self.layout.num_cores

    @property
    def widths(self) -> tuple[int, ...]:
        return self.layout.widths()


class PTT(EMASearchMixin):
    """Runtime Performance Trace Table over cores.

    ``value(t, c, w)`` is the EMA'd execution time of task type ``t``
    launched with leader ``c`` at width ``w``; 0.0 = untrained.  Invalid
    (leader, width) combinations (non-divisor width, misaligned leader,
    cluster-straddling) are masked out of every search by construction:
    candidates come from ``layout.valid_places()``.
    """

    def __init__(self, cfg: PTTConfig):
        self.cfg = cfg
        widths = cfg.widths
        self._w2i = {w: i for i, w in enumerate(widths)}
        self.trace = TraceTable(
            (cfg.num_task_types, cfg.num_cores, len(widths)),
            metrics=("latency",))
        self._places = cfg.layout.valid_places()

    # -- views ------------------------------------------------------------
    @property
    def widths(self) -> tuple[int, ...]:
        return self.cfg.widths

    @property
    def places(self) -> tuple[Place, ...]:
        return self._places

    @property
    def updates(self) -> int:
        return self.trace.updates

    def value(self, task_type: int, core: int, width: int) -> float:
        return self.trace.value((task_type, core, self._w2i[width]))

    def table(self, task_type: int) -> np.ndarray:
        return self.trace.array()[task_type]

    # -- update (leader core only; paper §3.2) -----------------------------
    def update(self, task_type: int, leader: int, width: int,
               elapsed: float) -> None:
        self.trace.update((task_type, leader, self._w2i[width]), elapsed)

    # -- searches (paper §3.3) ---------------------------------------------
    def _candidates(self, task_type: int, places) -> list[Candidate]:
        return [Candidate(key=(task_type, p.leader, self._w2i[p.width]),
                          item=p, width=p.width) for p in places]

    def global_search(self, task_type: int,
                      metric: str | CostModel = "occupancy") -> Place:
        """Best valid (leader, width) minimizing the objective.  Untrained
        entries score 0 -> visited first (bootstrap).

        ``metric`` is a CostModel — or "occupancy" (exec_time * width, the
        paper's default: minimum resource occupation) / "latency"
        (exec_time alone; TTFT-critical serving — queue-inflated samples
        push the search to narrower widths under load, so width adapts to
        load automatically)."""
        return self.trace.search(self._candidates(task_type, self._places),
                                 as_cost(metric))

    def local_search(self, task_type: int, core: int,
                     metric: str | CostModel = "occupancy") -> Place:
        """Best width keeping the task in partitions containing ``core``
        (non-critical tasks: avoid migration, only avoid
        oversubscription)."""
        cl = self.cfg.layout
        places = []
        for w in cl.widths():
            try:
                p = cl.place_of(core, w)
            except ValueError:
                continue
            if core in p:
                places.append(p)
        return self.trace.search(self._candidates(task_type, places),
                                 as_cost(metric))

    def snapshot(self) -> np.ndarray:
        return self.trace.array().copy()
