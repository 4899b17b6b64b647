"""Interference detection at fleet scale — the paper's Fig. 8 experiment
(background process steals cores; critical tasks migrate away; operation
recovers) applied to serving replicas.

Per replica the detector keeps two EMAs of a homogeneous latency signal
(engine decode-step latency in the gateway; normalized service time in the
simulator):

* a **long** EMA at the paper's 1:4 weight — the replica's baseline;
* a **fast** EMA at 1:1 — what the replica looks like *right now*.

When the fast EMA drifts above ``quarantine_ratio`` x baseline, the replica
is quarantined: the router stops sending it critical traffic and drains it.
The baseline is frozen while quarantined (otherwise the inflated samples
would drag the baseline up and mask the interference), and the replica is
re-admitted when the fast EMA recovers to within ``readmit_ratio`` x the
frozen baseline.  Recovery samples arrive the same way the paper keeps the
PTT trained on interfered cores: non-critical probe traffic and decode
steps of the draining batch keep flowing.

Both EMAs are single-axis :class:`~repro_torch.core.tracetable.TraceTable`
instances (the baseline at the paper's 1:4 window, the fast one at 1:1 via
the table's ``old_weight``/``den``) — one shared implementation.

This is the PyTorch port's copy of ``repro.router.interference``: host-
side Python and numpy, the same logic; only the imports differ.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from ..core.tracetable import EMASearchMixin, TraceTable


@dataclasses.dataclass(frozen=True)
class InterferenceConfig:
    quarantine_ratio: float = 2.0   # fast > ratio * baseline -> quarantine
    readmit_ratio: float = 1.25     # fast <= ratio * baseline -> re-admit
    min_samples: int = 4            # don't judge an untrained baseline
    min_drift_samples: int = 2      # consecutive over-threshold samples
                                    # required (one GC pause/spike is noise,
                                    # not interference)


class InterferenceDetector(EMASearchMixin):
    def __init__(self, num_replicas: int,
                 cfg: InterferenceConfig = InterferenceConfig()):
        self.cfg = cfg
        self._base = TraceTable((num_replicas,), metrics=("latency",))
        self._fast = TraceTable((num_replicas,), metrics=("latency",),
                                old_weight=1.0, den=2.0)
        self.samples = np.zeros(num_replicas, dtype=np.int64)
        self._drift_run = np.zeros(num_replicas, dtype=np.int64)
        self.quarantined: set[int] = set()
        # ("quarantine"|"readmit", r); bounded for long-lived processes
        self.events: deque[tuple[str, int]] = deque(maxlen=1000)

    def observe(self, replica: int, latency: float) -> str | None:
        """Feed one latency sample; returns "quarantine"/"readmit" when the
        replica's state flips, else None."""
        cfg = self.cfg
        self._fast.update((replica,), latency)
        self.samples[replica] += 1
        if replica in self.quarantined:
            # baseline frozen; watch the fast EMA for recovery.  An
            # untrained baseline (possible only via force_quarantine before
            # any samples) re-admits on the first sample — no evidence of
            # slowness must not strand capacity forever
            b = self.baseline[replica]
            if b == 0.0 or self.fast[replica] <= cfg.readmit_ratio * b:
                self.quarantined.discard(replica)
                self.events.append(("readmit", replica))
                return "readmit"
            return None
        # robust baseline: anomalous samples (beyond the quarantine drift)
        # are excluded, otherwise the baseline would chase the interference
        # and the drift ratio would never cross the threshold
        b = self.baseline[replica]
        high = b > 0.0 and latency > cfg.quarantine_ratio * b
        if not high:
            self._base.update((replica,), latency)
        # the run counts consecutive high *raw samples*, not EMA readings —
        # a single spike lingers in the fast EMA for several observations
        # and would otherwise satisfy any consecutive-EMA criterion alone
        if high and self.samples[replica] >= cfg.min_samples:
            self._drift_run[replica] += 1
            if self._drift_run[replica] >= cfg.min_drift_samples:
                self._drift_run[replica] = 0
                self.quarantined.add(replica)
                self.events.append(("quarantine", replica))
                return "quarantine"
        else:
            self._drift_run[replica] = 0
        return None

    def force_quarantine(self, replica: int) -> None:
        """Administratively quarantine a replica (ops intervention, tests,
        benchmark fault injection) through the same state transition the
        detector's own trigger performs — callers must not poke
        ``quarantined``/``events`` directly or they drift from any
        bookkeeping this path gains."""
        if replica not in self.quarantined:
            self._drift_run[replica] = 0
            self.quarantined.add(replica)
            self.events.append(("quarantine", replica))

    # -- views -------------------------------------------------------------
    @property
    def baseline(self) -> np.ndarray:
        """Long-EMA (1:4) per-replica baseline; 0 = untrained."""
        return self._base.array()

    @property
    def fast(self) -> np.ndarray:
        """Fast-EMA (1:1) per-replica latency — the "right now" view."""
        return self._fast.array()

    def is_healthy(self, replica: int) -> bool:
        return replica not in self.quarantined

    def healthy(self) -> list[int]:
        return [r for r in range(len(self.baseline))
                if r not in self.quarantined]

    def drift(self, replica: int) -> float:
        """fast / baseline; 1.0 = nominal, inf-safe for untrained."""
        b = self.baseline[replica]
        return float(self.fast[replica] / b) if b > 0 else 1.0

    def drifts(self) -> list[float]:
        """Every replica's drift ratio at once — the fleet-wide Fig. 8
        signal a sampling loop exports as gauges each pump."""
        return [self.drift(r) for r in range(len(self.baseline))]
