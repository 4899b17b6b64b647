"""Metric registry — typed counters, gauges, and fixed-bucket histograms
with Prometheus text exposition and a JSON snapshot.

Replaces the stack's ad-hoc ``stats()`` dicts as the *typed* telemetry
surface (the dicts remain as a compatible facade with unified key names):
every scale registers its series here under one naming scheme —
``serve_*`` (engine), ``fleet_*`` (gateway/router), ``region_*`` — with a
label identifying the instance, so one registry can serve a whole region's
worth of engines.

Design points:

* **get-or-create**: ``registry.counter(name, help, **labels)`` returns
  the live child for that (name, labels) series, creating family and
  child on first touch — instrumented code holds the child and pays a
  float add per event, no lookup;
* **fixed-bucket histograms**: cumulative bucket counts (Prometheus
  ``le`` semantics) over a fixed bound list — O(#buckets) per observe,
  no allocation, mergeable across processes by addition.  The default
  bounds cover 0.5 ms .. 10 s, the serving latency range (TTFT, TPOT,
  queue wait); byte-sized series pass :data:`BYTE_BUCKETS`;
* **two exporters**: ``prometheus_text()`` (the text exposition format a
  scrape endpoint returns) and ``snapshot()`` (a JSON-able dict for
  benchmarks/tests), both golden-file tested.

This is the PyTorch port's copy of ``repro.obs.metrics``: host-side
Python and numpy, the same logic; only the imports differ.
"""

from __future__ import annotations

import re
from bisect import bisect_left
from typing import Mapping

#: Latency seconds: 0.5 ms .. 10 s (TTFT/TPOT/queue-wait range).
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
#: Payload sizes: 1 KiB .. 1 GiB (session wire payloads).
BYTE_BUCKETS = (2.0**10, 2.0**14, 2.0**17, 2.0**20, 2.0**23, 2.0**26,
                2.0**30)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class Counter:
    """Monotonically increasing float (name by convention ``*_total``)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


class Gauge:
    """Point-in-time float (utilization, queue depth, drift ratio)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket latency histogram with Prometheus ``le`` semantics.

    ``bucket_counts`` are *non-cumulative* per-bucket tallies (the last
    slot is the +Inf overflow); the exporter emits the cumulative view.
    ``percentile(q)`` answers with the upper bound of the bucket holding
    the q-th sample — resolution-limited by design (tests compare against
    the exact ``benchmarks.common.percentile`` on the raw samples).
    """

    __slots__ = ("buckets", "bucket_counts", "sum", "count")

    def __init__(self, buckets: tuple = LATENCY_BUCKETS):
        b = tuple(float(x) for x in buckets)
        if not b or list(b) != sorted(set(b)):
            raise ValueError("buckets must be sorted, unique, non-empty")
        self.buckets = b
        self.bucket_counts = [0] * (len(b) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.bucket_counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def percentile(self, q: float) -> float:
        """Bucket-resolution percentile (``q`` in [0, 100]): the smallest
        bucket bound covering the q-th sample; overflow samples answer the
        largest finite bound.  0.0 when empty."""
        if self.count == 0:
            return 0.0
        target = (q / 100.0) * self.count
        cum = 0
        for bound, n in zip(self.buckets, self.bucket_counts):
            cum += n
            if cum >= target:
                return bound
        return self.buckets[-1]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    __slots__ = ("name", "kind", "help", "children")

    def __init__(self, name: str, kind: str, help: str):
        self.name = name
        self.kind = kind
        self.help = help
        self.children: dict[tuple, Counter | Gauge | Histogram] = {}


class MetricRegistry:
    """One process's metric families, keyed by name; series keyed by
    sorted label items within each family."""

    def __init__(self):
        self._families: dict[str, _Family] = {}
        #: bumped whenever a new family or child appears — lets samplers
        #: cache a flat child list and rescan only on growth
        self.version = 0

    def _get(self, kind: str, name: str, help: str, labels: Mapping,
             **init):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(name, kind, help)
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}")
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        child = fam.children.get(key)
        if child is None:
            child = fam.children[key] = _KINDS[kind](**init)
            self.version += 1
        return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = LATENCY_BUCKETS, **labels) -> Histogram:
        return self._get("histogram", name, help, labels, buckets=buckets)

    # -- exporters ---------------------------------------------------------
    @staticmethod
    def _fmt(v: float) -> str:
        return str(int(v)) if float(v).is_integer() else repr(float(v))

    @staticmethod
    def _labelstr(key: tuple, extra: tuple = ()) -> str:
        items = list(key) + list(extra)
        if not items:
            return ""
        return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"

    def prometheus_text(self) -> str:
        """Prometheus text exposition (the ``/metrics`` scrape body):
        families sorted by name, series by label key — deterministic, so
        the format is golden-file testable."""
        lines: list[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam.children):
                c = fam.children[key]
                if fam.kind in ("counter", "gauge"):
                    lines.append(
                        f"{name}{self._labelstr(key)} {self._fmt(c.value)}")
                    continue
                cum = 0
                for bound, n in zip(c.buckets, c.bucket_counts):
                    cum += n
                    le = self._labelstr(key, (("le", self._fmt(bound)),))
                    lines.append(f"{name}_bucket{le} {cum}")
                inf = self._labelstr(key, (("le", "+Inf"),))
                lines.append(f"{name}_bucket{inf} {c.count}")
                lines.append(
                    f"{name}_sum{self._labelstr(key)} {self._fmt(c.sum)}")
                lines.append(f"{name}_count{self._labelstr(key)} {c.count}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able dump: ``{name: {type, help, series: [{labels, ...}]}}``
        — what benchmarks embed in their ``BENCH_*.json`` artifacts."""
        out: dict = {}
        for name in sorted(self._families):
            fam = self._families[name]
            series = []
            for key in sorted(fam.children):
                c = fam.children[key]
                s: dict = {"labels": dict(key)}
                if fam.kind == "histogram":
                    s.update(count=c.count, sum=c.sum,
                             buckets=list(c.buckets),
                             bucket_counts=list(c.bucket_counts))
                else:
                    s["value"] = c.value
                series.append(s)
            out[name] = {"type": fam.kind, "help": fam.help,
                         "series": series}
        return out
