"""Seeded, schedulable fault plans for the serving transport plane.

The paper's premise is that performance asymmetry is *dynamic* — capacity
degrades under the scheduler's feet and the scheduler must notice and
respond.  This module makes that degradation injectable and reproducible:
a :class:`FaultInjector` holds one explicit RNG plus a schedule, and every
fault decision it ever makes is a pure function of (seed, schedule, the
sequence of questions asked).  Two runs with the same seed and the same
workload see byte-identical fault sequences, which is what lets the chaos
benchmarks assert token-identity against a fault-free run instead of
merely "it didn't crash".

Fault taxonomy (all per directed link unless noted):

* **drop** — the ship attempt is lost in flight (timeout analogue);
* **corrupt** — delivered bytes differ from sent bytes (bit flips the
  wire CRC must catch);
* **duplicate** — the payload is delivered twice (retransmission race);
* **delay** — extra seconds added to the observed delivery time;
* **partition** — a scheduled window of logical steps during which every
  ship on the link is dropped;
* **crash / restart** — scheduled replica process death (node-level, not
  link-level): the engine loses all volatile state and stops heartbeating
  until its restart step.

The injector's clock is **logical** (:meth:`advance` once per scheduler
pump/step): schedules are expressed in steps so chaos scenarios stay
deterministic regardless of wall-clock speed.

This is the PyTorch port's copy of ``repro.chaos.faults``: the same
plan, the same draws in the same order from one ``random.Random(seed)``.
The plan drives the fleet gateway's crash / restart schedule and the
link faults of :class:`~repro_torch.chaos.transport.ChaosTransport`.
"""

from __future__ import annotations

import dataclasses
import random


@dataclasses.dataclass
class LinkPlan:
    """Per-link fault probabilities and fixed delay (seconds)."""
    drop: float = 0.0
    corrupt: float = 0.0
    duplicate: float = 0.0
    delay: float = 0.0

    def validate(self) -> "LinkPlan":
        for name in ("drop", "corrupt", "duplicate"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} probability {p} outside [0, 1]")
        if self.delay < 0.0:
            raise ValueError(f"negative delay {self.delay}")
        return self


class FaultInjector:
    """One seeded fault plan: per-link probabilities, scheduled partition
    windows, and scheduled replica crash/restart steps.

    All randomness flows through one ``random.Random(seed)`` — the
    injector is the only source of nondeterminism in a chaos run, so
    pinning the seed pins the entire fault sequence."""

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.seed = seed
        self.now = 0                         # logical step clock
        self._default = LinkPlan()
        self._links: dict[tuple[int, int], LinkPlan] = {}
        # (src, dst) -> list of [start, until) step windows; src/dst None
        # matches any endpoint (a full partition of one side)
        self._partitions: list[tuple[int | None, int | None, int, int]] = []
        self._crash_at: dict[int, int] = {}      # replica -> crash step
        self._restart_at: dict[int, int] = {}    # replica -> restart step
        self.counts = {"drop": 0, "corrupt": 0, "duplicate": 0,
                       "delay": 0, "partition": 0}

    # -- plan construction -------------------------------------------------
    def default_link(self, *, drop: float = 0.0, corrupt: float = 0.0,
                     duplicate: float = 0.0,
                     delay: float = 0.0) -> "FaultInjector":
        """Fault plan for every link without an explicit one."""
        self._default = LinkPlan(drop, corrupt, duplicate, delay).validate()
        return self

    def link(self, src: int, dst: int, *, drop: float = 0.0,
             corrupt: float = 0.0, duplicate: float = 0.0,
             delay: float = 0.0) -> "FaultInjector":
        """Fault plan for one directed link (overrides the default)."""
        self._links[(src, dst)] = LinkPlan(drop, corrupt, duplicate,
                                           delay).validate()
        return self

    def partition(self, src: int | None, dst: int | None, *, start: int,
                  until: int) -> "FaultInjector":
        """Drop every ship on the (src, dst) link during logical steps
        ``[start, until)``.  ``None`` matches any endpoint, so
        ``partition(None, 2, ...)`` isolates replica 2's ingress."""
        if until <= start:
            raise ValueError(f"empty partition window [{start}, {until})")
        self._partitions.append((src, dst, int(start), int(until)))
        return self

    def crash(self, replica: int, *, at_step: int,
              restart_at: int | None = None) -> "FaultInjector":
        """Schedule replica process death at ``at_step`` (and optional
        rebirth at ``restart_at``)."""
        if restart_at is not None and restart_at <= at_step:
            raise ValueError("restart must come after the crash")
        self._crash_at[int(replica)] = int(at_step)
        if restart_at is not None:
            self._restart_at[int(replica)] = int(restart_at)
        return self

    # -- clock -------------------------------------------------------------
    def advance(self, steps: int = 1) -> int:
        """Advance the logical clock (call once per scheduler pump)."""
        self.now += int(steps)
        return self.now

    # -- queries (the ChaosTransport / gateway surface) --------------------
    def plan(self, src: int, dst: int) -> LinkPlan:
        return self._links.get((src, dst), self._default)

    def partitioned(self, src: int, dst: int) -> bool:
        for s, d, start, until in self._partitions:
            if ((s is None or s == src) and (d is None or d == dst)
                    and start <= self.now < until):
                return True
        return False

    def crashed(self, replica: int) -> bool:
        """Whether ``replica`` is dead at the current logical step."""
        at = self._crash_at.get(replica)
        if at is None or self.now < at:
            return False
        back = self._restart_at.get(replica)
        return back is None or self.now < back

    # -- fault draws (consume RNG; called by ChaosTransport) ---------------
    def draw_drop(self, src: int, dst: int) -> str | None:
        """None, or the reason this ship attempt is lost."""
        if self.partitioned(src, dst):
            self.counts["partition"] += 1
            return "partitioned"
        if self.rng.random() < self.plan(src, dst).drop:
            self.counts["drop"] += 1
            return "dropped"
        return None

    def draw_corrupt(self, src: int, dst: int, nbytes: int) -> int | None:
        """None, or the bit index (within ``nbytes`` bytes) to flip."""
        if nbytes > 0 and self.rng.random() < self.plan(src, dst).corrupt:
            self.counts["corrupt"] += 1
            return self.rng.randrange(nbytes * 8)
        return None

    def draw_duplicate(self, src: int, dst: int) -> bool:
        if self.rng.random() < self.plan(src, dst).duplicate:
            self.counts["duplicate"] += 1
            return True
        return False

    def draw_delay(self, src: int, dst: int) -> float:
        d = self.plan(src, dst).delay
        if d > 0.0:
            self.counts["delay"] += 1
        return d

    # -- views -------------------------------------------------------------
    def stats(self) -> dict:
        return {"seed": self.seed, "step": self.now, **self.counts}
