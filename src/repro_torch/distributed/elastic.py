"""PTT-driven elasticity at pod scale: the port's copy of
``repro.distributed.elastic``, so far only :class:`PodPTT`, which the
serving scheduler searches.  ``StragglerRebalancer``, ``HeartbeatMonitor``
and ``elastic_remesh`` are not carried over yet."""

from __future__ import annotations

import numpy as np

from ..core.places import homogeneous_layout
from ..core.ptt import PTT, PTTConfig
from ..core.tracetable import CostModel


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
