"""Scheduling policies (paper §3.3).

Policies are engine-agnostic: the execution engine (here the threaded
runtime in :mod:`repro_torch.core.runtime`; the reference also drives them
from its discrete-event simulator) owns the WSQ/AQ mechanics and asks the
policy two questions:

* :meth:`SchedulingPolicy.place` — a ready task has reached the head of core
  ``core``'s WSQ (or was stolen by ``core``); where does it run?  All
  scheduling decisions happen *before* AQ insertion (irrevocability rule,
  paper §3.1).
* :meth:`SchedulingPolicy.record` — the leader core observed the task's
  elapsed time; update any online model.

Criticality is decided by the engine at commit-and-wake-up time using
:func:`repro_torch.core.dag.is_critical_child`; initial tasks are
non-critical.

This is the PyTorch port's copy of ``repro.core.scheduler``, over the
port's own ``ptt``, ``places`` and ``tracetable``.
"""

from __future__ import annotations

from .dag import TaskNode
from .places import ClusterLayout, Place
from .ptt import PTT, PTTConfig
from .tracetable import Occupancy


class SchedulingPolicy:
    name = "abstract"

    def place(self, task: TaskNode, core: int, critical: bool) -> Place:
        raise NotImplementedError

    def record(self, task: TaskNode, place: Place, elapsed: float) -> None:
        pass  # stateless policies ignore feedback


class HomogeneousScheduler(SchedulingPolicy):
    """The baseline: XiTAO's standard random work-stealing scheduler, unaware
    of hardware and of performance state (paper §5).  The resource width is
    the programmer's static choice (default 1); the task runs wherever it was
    dequeued/stolen."""

    name = "homogeneous"

    def __init__(self, layout: ClusterLayout, static_width: int = 1):
        self.layout = layout
        self.static_width = static_width

    def place(self, task: TaskNode, core: int, critical: bool) -> Place:
        return self.layout.place_of(core, self.static_width)


class PerformanceBasedScheduler(SchedulingPolicy):
    """The paper's contribution.

    * critical task  -> global PTT search: argmin over all valid
      (leader, width) of exec_time * width  (minimum resource occupancy).
    * non-critical   -> local PTT search: keep the task on the dequeuing
      core's partition, choose only the width (interference avoidance).
    """

    name = "performance"

    def __init__(self, layout: ClusterLayout, num_task_types: int):
        self.layout = layout
        self.ptt = PTT(PTTConfig(layout=layout, num_task_types=num_task_types))
        self.cost = Occupancy()          # paper §3.3: min resource occupancy

    def place(self, task: TaskNode, core: int, critical: bool) -> Place:
        t = int(task.kernel)
        if critical:
            return self.ptt.global_search(t, self.cost)
        return self.ptt.local_search(t, core, self.cost)

    def record(self, task: TaskNode, place: Place, elapsed: float) -> None:
        self.ptt.update(int(task.kernel), place.leader, place.width, elapsed)
