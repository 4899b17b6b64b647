"""Multi-window burn-rate SLO monitoring (the Google SRE alerting shape).

An SLO here is "at least ``target`` of events are *good* over time" —
good meaning a TTFT under its threshold, a decode step under its TPOT
bound, a request served rather than shed.  The error budget is
``1 - target``; the **burn rate** over a window is

    burn = (bad events / total events in window) / (1 - target)

— 1.0 means spending budget exactly at the allowed rate, ``N`` means
burning it N times too fast.  Alerting on one window is a trade-off
trap: a short window pages on noise, a long one pages an hour late and
takes another hour to clear.  The SRE-workbook answer — implemented by
:class:`SLOMonitor` — is **multi-window**: fire only when a *fast* and a
*slow* window both exceed the burn threshold (the slow window proves the
problem is real, the fast one proves it is *still happening*), and clear
when the fast window recovers (no waiting for the slow window to age
out).

Windows are measured in **pump ticks**, the stack's logical clock: the
gateways call :meth:`SLOMonitor.evaluate` once per pump, so a seeded
chaos schedule produces a deterministic fire/clear sequence — the alert
lifecycle is testable, not just observable.  State transitions emit
typed :class:`Alert` records (kept on a bounded deque, served by
``/alerts``), an instant on the tracer's SLO track, and an
``slo_alerts_total`` counter increment.

This is the PyTorch port's copy of ``repro.obs.slo``: host-side Python
and numpy, the same logic; only the imports differ.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable

from .trace import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class Objective:
    """One SLO: at least ``target`` of events good.  ``threshold`` makes
    value observations judgeable (good iff ``value <= threshold``);
    bool-fed objectives (availability) leave it None and use
    :meth:`SLOMonitor.observe_ok`."""
    name: str
    target: float = 0.99
    threshold: float | None = None

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target}")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


@dataclasses.dataclass(frozen=True)
class Alert:
    """One burn-rate state transition.  ``state`` is "firing" or
    "cleared"; ``burn_fast``/``burn_slow`` are the window burn rates at
    transition time, ``tick`` the pump tick it happened on."""
    objective: str
    state: str
    burn_fast: float
    burn_slow: float
    tick: int
    time: float
    severity: str = "page"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class SLOMonitor:
    """Fast/slow-window burn-rate evaluator over a set of objectives.

    Feed events with :meth:`observe` (a measured value, judged against
    the objective's threshold) or :meth:`observe_ok` (a verdict); call
    :meth:`evaluate` once per pump tick.  ``fire`` when both windows
    burn above ``burn_threshold``; ``clear`` when the fast window drops
    back under it.  Alert history is bounded (oldest evicted)."""

    ALERT_CAP = 10_000

    def __init__(self, objectives: Iterable[Objective], *,
                 fast_window: int = 8, slow_window: int = 40,
                 burn_threshold: float = 2.0, severity: str = "page"):
        objectives = tuple(objectives)
        if not objectives:
            raise ValueError("need at least one objective")
        if not 0 < fast_window <= slow_window:
            raise ValueError(
                f"need 0 < fast_window <= slow_window, got "
                f"{fast_window}/{slow_window}")
        self.objectives: dict[str, Objective] = {o.name: o
                                                 for o in objectives}
        if len(self.objectives) != len(objectives):
            raise ValueError("duplicate objective names")
        self.fast_window = int(fast_window)
        self.slow_window = int(slow_window)
        self.burn_threshold = float(burn_threshold)
        self.severity = severity
        self._good = {o.name: 0 for o in objectives}
        self._bad = {o.name: 0 for o in objectives}
        # per-objective ring of (tick, good_total, bad_total) snapshots —
        # one per evaluate; slow_window+1 points span the slow window
        self._ring: dict[str, deque] = {
            o.name: deque(maxlen=slow_window + 1) for o in objectives}
        self.alerts: deque[Alert] = deque(maxlen=self.ALERT_CAP)
        self.active: dict[str, Alert] = {}
        self.evaluations = 0
        # observability (attach_obs): no tracer/counter by default
        self.tracer = NULL_TRACER
        self.obs_name = "slo"
        self._m_alerts: dict | None = None

    # -- observability -----------------------------------------------------
    def attach_obs(self, tracer=None, metrics=None,
                   name: str | None = None) -> None:
        """State transitions become instants on the ``{name}`` tracer
        track and ``slo_alerts_total{objective=,state=}`` increments.
        Counter children are resolved here, once — never in evaluate."""
        if name is not None:
            self.obs_name = name
        if tracer is not None:
            self.tracer = tracer
        if metrics is not None:
            self._m_alerts = {
                (o, st): metrics.counter(
                    "slo_alerts_total",
                    "Burn-rate alert state transitions", monitor=self.obs_name,
                    objective=o, state=st)
                for o in self.objectives for st in ("firing", "cleared")}

    # -- event feed --------------------------------------------------------
    def wants(self, name: str) -> bool:
        """Whether any objective consumes ``name`` observations — lets a
        gateway skip computing signals nobody asked for."""
        return name in self.objectives

    def observe(self, name: str, value: float) -> None:
        """One measured event, judged against the objective's threshold."""
        o = self.objectives.get(name)
        if o is None:
            return
        if o.threshold is None:
            raise ValueError(
                f"objective {name!r} has no threshold; use observe_ok")
        self.observe_ok(name, value <= o.threshold)

    def observe_ok(self, name: str, ok: bool) -> None:
        if name not in self.objectives:
            return
        if ok:
            self._good[name] += 1
        else:
            self._bad[name] += 1

    # -- burn-rate math ----------------------------------------------------
    def _window_burn(self, name: str, window: int) -> float:
        """Burn rate over the trailing ``window`` ticks: bad fraction of
        the events that arrived in-window, over the error budget.  A
        window with no events burns 0.0 (no traffic spends no budget)."""
        ring = self._ring[name]
        if not ring:
            return 0.0
        tick, good, bad = ring[-1]
        lo = tick - window
        # baseline = newest snapshot at or before the window's left edge:
        # events counted by evaluate(lo) arrived at ticks <= lo, i.e.
        # pre-window.  At steady state the ring's oldest snapshot is
        # exactly lo, so the baseline is never evicted and old bad events
        # genuinely age out of the slow window.  Consecutive per-pump
        # ticks (the overwhelmingly common feed) resolve by index; gapped
        # clocks fall back to a newest-first walk.
        base_good = base_bad = 0
        n = len(ring)
        if n > window and ring[-1 - window][0] == lo:
            _, base_good, base_bad = ring[-1 - window]
        else:
            for t, g, b in reversed(ring):
                if t <= lo:
                    base_good, base_bad = g, b
                    break
        dg, db = good - base_good, bad - base_bad
        total = dg + db
        if total <= 0:
            return 0.0
        return (db / total) / self.objectives[name].budget

    def burn_rates(self, name: str) -> tuple[float, float]:
        """(fast, slow) burn of one objective as of the last evaluate."""
        return (self._window_burn(name, self.fast_window),
                self._window_burn(name, self.slow_window))

    # -- evaluation (one call per pump tick) -------------------------------
    def evaluate(self, tick: int, now: float = 0.0) -> list[Alert]:
        """Snapshot every objective's counts at ``tick``, update alert
        state, and return the transitions this call produced."""
        out: list[Alert] = []
        self.evaluations += 1
        thr = self.burn_threshold
        for name in self.objectives:
            self._ring[name].append((tick, self._good[name],
                                     self._bad[name]))
            fast = self._window_burn(name, self.fast_window)
            slow = self._window_burn(name, self.slow_window)
            firing = name in self.active
            if not firing and fast > thr and slow > thr:
                a = Alert(objective=name, state="firing", burn_fast=fast,
                          burn_slow=slow, tick=tick, time=now,
                          severity=self.severity)
                self.active[name] = a
                out.append(a)
            elif firing and fast <= thr:
                a = Alert(objective=name, state="cleared", burn_fast=fast,
                          burn_slow=slow, tick=tick, time=now,
                          severity=self.severity)
                del self.active[name]
                out.append(a)
        for a in out:
            self.alerts.append(a)
            if self._m_alerts is not None:
                self._m_alerts[(a.objective, a.state)].inc()
            if self.tracer.enabled:
                self.tracer.instant(
                    f"slo-{a.state}", None, self.obs_name,
                    objective=a.objective, burn_fast=round(a.burn_fast, 4),
                    burn_slow=round(a.burn_slow, 4), tick=a.tick)
        return out

    # -- views -------------------------------------------------------------
    def counts(self, name: str) -> tuple[int, int]:
        """(good, bad) lifetime event totals of one objective."""
        return self._good[name], self._bad[name]

    def stats(self) -> dict:
        return {
            "objectives": {
                n: {"target": o.target, "threshold": o.threshold,
                    "good": self._good[n], "bad": self._bad[n],
                    "burn_fast": round(self._window_burn(
                        n, self.fast_window), 6),
                    "burn_slow": round(self._window_burn(
                        n, self.slow_window), 6),
                    "firing": n in self.active}
                for n, o in self.objectives.items()},
            "active": sorted(self.active),
            "alerts_total": len(self.alerts),
            "evaluations": self.evaluations,
        }

    def alerts_json(self) -> dict:
        """The ``/alerts`` endpoint body: active alerts + full retained
        history, oldest first."""
        return {"active": [self.active[n].to_json()
                           for n in sorted(self.active)],
                "history": [a.to_json() for a in self.alerts],
                "burn_threshold": self.burn_threshold,
                "fast_window": self.fast_window,
                "slow_window": self.slow_window}
