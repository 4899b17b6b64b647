"""Bounded metric time series — the registry watched *over time*.

The :class:`~repro_torch.obs.MetricRegistry` answers "what is the counter at
now"; nothing in the stack answers "what was it doing for the last N
pumps" — yet that trajectory IS the paper's Fig. 8 signal (drift climbs,
quarantine flips, traffic migrates, drift recovers), and it is what the
ROADMAP's autoscaler must consume.  :class:`TimeSeriesStore` closes the
gap: on every call to :meth:`sample` (the gateways call it on their pump
clock) it walks the registry and appends one point per live series into a
per-series ring buffer —

* counters/gauges sample their float value;
* histograms sample ``(count, sum, per-bucket counts)`` — every bucket
  tally is itself a monotonic counter, so *rates* and *windowed
  percentiles* can be derived later by differencing two samples (the
  classic Prometheus ``rate()``/``histogram_quantile()`` moves, done
  here over in-process rings instead of a TSDB);

each point carries the **pump tick** it was sampled at and the wall time,
so series join trace instants (which carry the same tick — see
:meth:`~repro_torch.obs.trace.SpanTracer.set_tick`) on one logical clock even
when wall timestamps skew across delayed deliveries.

Rings are bounded (``cap`` points per series, oldest evicted), so a
long-lived server holds a sliding window, never a leak.  Everything
exports as one JSON document (:meth:`export`) — the ``/timeseries``
endpoint body and the CI artifact.

This is the PyTorch port's copy of ``repro.obs.timeseries``: host-side
Python and numpy, the same logic; only the imports differ.
"""

from __future__ import annotations

from collections import deque

from .metrics import MetricRegistry


class _Series:
    __slots__ = ("name", "labels", "kind", "buckets", "points")

    def __init__(self, name: str, labels: tuple, kind: str,
                 buckets: tuple | None, cap: int):
        self.name = name
        self.labels = labels          # the registry's sorted (k, v) key
        self.kind = kind
        self.buckets = buckets        # histogram bounds, else None
        # counter/gauge point: (tick, time, value)
        # histogram point:     (tick, time, count, sum, bucket counts
        #                       tuple — per-bucket tallies, last = +Inf)
        self.points: deque[tuple] = deque(maxlen=cap)


class TimeSeriesStore:
    """Ring-buffered samples of every series in one registry.

    ``cap`` bounds each series' ring; :meth:`sample` is O(live series)
    and allocation-light (one tuple per series per sample) — priced by
    the JAX package's ``benchmarks/obs_overhead.py`` sampled arm.
    """

    def __init__(self, registry: MetricRegistry, cap: int = 2048):
        if cap < 2:
            raise ValueError(f"cap must be >= 2 (windows need two points), "
                             f"got {cap}")
        self.registry = registry
        self.cap = int(cap)
        self._series: dict[tuple, _Series] = {}
        self.samples = 0             # sample() calls (not points)
        # flat scan lists (scalars / histograms), rebuilt only when the
        # registry grows — sample() must stay off the nested dicts
        self._scan_scalar: list[tuple] = []
        self._scan_hist: list[tuple] = []
        self._scan_version = -1

    def _rescan(self) -> None:
        self._scan_scalar, self._scan_hist = [], []
        for name, fam in self.registry._families.items():
            is_hist = fam.kind == "histogram"
            for key, child in fam.children.items():
                s = self._series.get((name, key))
                if s is None:
                    s = self._series[(name, key)] = _Series(
                        name, key, fam.kind,
                        child.buckets if is_hist else None, self.cap)
                (self._scan_hist if is_hist
                 else self._scan_scalar).append((s.points.append, child))
        self._scan_version = self.registry.version

    # -- recording ---------------------------------------------------------
    def sample(self, tick: int, now: float = 0.0) -> int:
        """Append one point to every live registry series; returns the
        number of points written.  ``tick`` is the caller's monotonic pump
        tick, ``now`` its wall clock."""
        if self._scan_version != self.registry.version:
            self._rescan()
        for append, child in self._scan_scalar:
            append((tick, now, child.value))
        for append, child in self._scan_hist:
            # a flat copy of the per-bucket tallies: each is a monotonic
            # counter, so queries difference then accumulate lazily —
            # cheaper here than building the cumulative view per sample
            append((tick, now, child.count, child.sum,
                    tuple(child.bucket_counts)))
        self.samples += 1
        return len(self._scan_scalar) + len(self._scan_hist)

    # -- queries -----------------------------------------------------------
    def _one(self, name: str, labels: dict) -> _Series:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        s = self._series.get((name, key))
        if s is not None:
            return s
        if not labels:
            # label-free lookup: unambiguous single-child families resolve
            # without the caller repeating attach-time labels
            matches = [s for (n, _), s in self._series.items() if n == name]
            if len(matches) == 1:
                return matches[0]
            if matches:
                raise KeyError(
                    f"{name!r} has {len(matches)} label sets; pass labels")
        raise KeyError(f"no sampled series {name!r} with labels {labels!r}")

    def names(self) -> list[str]:
        return sorted({n for (n, _) in self._series})

    def points(self, name: str, **labels) -> list[tuple]:
        """All retained points of one series, oldest first."""
        return list(self._one(name, labels).points)

    def window(self, name: str, *, since_tick: int | None = None,
               last: int | None = None, **labels) -> list[tuple]:
        """Points with ``tick >= since_tick`` (and/or the ``last`` most
        recent), oldest first."""
        pts = list(self._one(name, labels).points)
        if since_tick is not None:
            pts = [p for p in pts if p[0] >= since_tick]
        if last is not None:
            pts = pts[-last:]
        return pts

    def rate(self, name: str, *, window: int | None = None,
             per: str = "tick", **labels) -> float:
        """Increase per tick (or ``per="second"``: per wall second) of a
        counter — or of a histogram's event count — over the retained
        ring, optionally restricted to the last ``window`` ticks.  0.0
        with fewer than two points (no interval to difference)."""
        s = self._one(name, labels)
        pts = list(s.points)
        if window is not None and pts:
            lo = pts[-1][0] - window
            pts = [p for p in pts if p[0] >= lo]
        if len(pts) < 2:
            return 0.0
        first, lastp = pts[0], pts[-1]
        # histogram points carry count at the same index a counter carries
        # its value, so one difference serves both
        dv = lastp[2] - first[2]
        dt = ((lastp[1] - first[1]) if per == "second"
              else float(lastp[0] - first[0]))
        return dv / dt if dt > 0 else 0.0

    def percentile(self, name: str, q: float, *,
                   window: int | None = None, **labels) -> float:
        """Bucket-resolution percentile of a histogram's observations
        *within the window*: the per-bucket tallies of the oldest
        in-window point are subtracted from the newest (each tally is a
        monotonic counter, so they difference cleanly), recovering the
        distribution of just that interval — a windowed p99 from a
        lifetime histogram.  Falls back to the full retained ring when
        ``window`` is None; 0.0 when the window saw no events."""
        s = self._one(name, labels)
        if s.kind != "histogram":
            raise TypeError(f"{name!r} is a {s.kind}, not a histogram")
        pts = list(s.points)
        if not pts:
            return 0.0
        if window is not None:
            lo = pts[-1][0] - window
            pts = [p for p in pts if p[0] >= lo]
        first, lastp = pts[0], pts[-1]
        # the window's distribution: newest tallies minus oldest.  With
        # one in-window point the "oldest" baseline is zero — the point's
        # whole history counts (the ring's best answer at its resolution)
        base = first[4] if len(pts) > 1 else (0,) * len(lastp[4])
        base_n = first[2] if len(pts) > 1 else 0
        counts = [b - a for a, b in zip(base, lastp[4])]
        n = lastp[2] - base_n
        if n <= 0:
            return 0.0
        target = (q / 100.0) * n
        cum = 0
        for bound, c in zip(s.buckets, counts):
            cum += c
            if cum >= target:
                return bound
        return s.buckets[-1]

    # -- export ------------------------------------------------------------
    def export(self) -> dict:
        """One JSON document: every series with its retained points —
        the ``/timeseries`` endpoint body and the CI smoke artifact."""
        series = []
        for (name, key) in sorted(self._series):
            s = self._series[(name, key)]
            entry: dict = {"name": name, "labels": dict(key),
                           "kind": s.kind,
                           "points": [list(p[:4]) + [list(p[4])]
                                      if s.kind == "histogram" else list(p)
                                      for p in s.points]}
            if s.buckets is not None:
                entry["buckets"] = list(s.buckets)
            series.append(entry)
        return {"cap": self.cap, "samples": self.samples, "series": series}
