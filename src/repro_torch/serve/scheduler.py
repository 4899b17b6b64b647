"""Elastic serving scheduler — the paper's performance-based policy applied
to inference tasks on pod device groups (DESIGN.md §3, integration 1).

Task types are (phase, prompt-length-bucket) classes:
* **prefill** tasks gate time-to-first-token — they are the *critical* tasks
  and search the PodPTT globally for the (group, width) minimizing
  latency x width (minimum resource occupancy, exactly paper §3.3);
* **decode** batches are steady-state *non-critical* tasks — they stay on
  their current group and only re-select width locally.

The PTT learns per-(group, width) latencies online, so a slow group (co-
tenant interference, thermal throttling, a degraded ICI link) stops
receiving critical prefills within a few EMA updates and recovers the same
way — no platform knowledge required, which is the paper's core claim.
"""

from __future__ import annotations

import dataclasses
import enum

from ..core.places import Place
from ..core.tracetable import Latency
from ..distributed.elastic import PodPTT


class RequestClass(enum.IntEnum):
    PREFILL_SHORT = 0      # <= 2k prompt
    PREFILL_LONG = 1       # > 2k prompt
    DECODE = 2


def classify_prefill(prompt_len: int) -> RequestClass:
    return (RequestClass.PREFILL_SHORT if prompt_len <= 2048
            else RequestClass.PREFILL_LONG)


def classify_request(prompt_len: int, max_new: int) -> RequestClass:
    """Fleet-level classing of a whole request: generation-dominated
    requests (more new tokens than prompt) are steady-state/non-critical
    DECODE traffic; the rest are TTFT-critical prefill classes by length —
    the paper's critical/non-critical split, one level up."""
    if max_new > prompt_len:
        return RequestClass.DECODE
    return classify_prefill(prompt_len)


@dataclasses.dataclass
class Decision:
    place: Place
    task_type: RequestClass


class ElasticServeScheduler:
    def __init__(self, num_groups: int):
        self.ptt = PodPTT(num_groups, num_task_types=len(RequestClass))

    def schedule_prefill(self, prompt_len: int) -> Decision:
        # TTFT-critical: latency objective (queue-inflated PTT samples steer
        # width/placement under load; paper §3.3 "alternative optimization
        # strategies are also possible")
        t = classify_prefill(prompt_len)
        return Decision(place=self.ptt.place_critical(int(t), Latency()),
                        task_type=t)

    def schedule_decode(self, group: int) -> Decision:
        t = RequestClass.DECODE
        return Decision(place=self.ptt.width_local(int(t), group),
                        task_type=t)

    def record(self, d: Decision, elapsed: float, now: float) -> None:
        self.ptt.record(int(d.task_type), d.place.leader, d.place.width,
                        elapsed, now)
