"""Telemetry plane of the port: request spans, metric registry, decision
attribution, and the SLO control plane built on top of them — the port's
copy of ``repro.obs``:

* :mod:`repro_torch.obs.trace` — per-request span tracer with trace ids
  that survive the session wire format, exportable as Chrome/Perfetto
  trace-event JSON (:class:`SpanTracer`; :data:`NULL_TRACER` default);
* :mod:`repro_torch.obs.metrics` — counters/gauges/fixed-bucket
  histograms with Prometheus text exposition and JSON snapshot
  (:class:`MetricRegistry`);
* :mod:`repro_torch.obs.attribution` — per-candidate, per-cost-model-term
  breakdown of every TraceTable search decision (:class:`DecisionLog`);
* :mod:`repro_torch.obs.timeseries` — bounded ring-buffer samples of
  every registry series on the pump clock (:class:`TimeSeriesStore`);
* :mod:`repro_torch.obs.slo` — multi-window burn-rate alerting over
  TTFT/TPOT/availability objectives (:class:`SLOMonitor`);
* :mod:`repro_torch.obs.server` — a stdlib HTTP endpoint serving
  ``/metrics``, ``/timeseries``, ``/alerts``, ``/traces`` and
  ``/debug/decisions`` (:class:`ObsServer`);
* :mod:`repro_torch.obs.replay` — DecisionLog JSONL persistence and a
  replay harness that re-scores recorded decisions under a modified
  cost model (``python -m repro_torch.obs.replay``).

All of it is opt-in: every instrumented class defaults to the null
tracer / no registry / no log.  ``CANONICAL_STATS`` names the counter
keys the engine's and the fleet gateway's ``stats()`` agree on.
"""

from .attribution import DecisionLog, DecisionRecord
from .metrics import (BYTE_BUCKETS, LATENCY_BUCKETS, Counter, Gauge,
                      Histogram, MetricRegistry)
from .replay import (ReplayReport, dump_jsonl, load_jsonl, parse_cost,
                     record_to_json, replay, rescore)
from .server import ObsServer
from .slo import Alert, Objective, SLOMonitor
from .timeseries import TimeSeriesStore
from .trace import NULL_TRACER, NullTracer, SpanTracer

#: Counter keys shared by ServeEngine.stats() and FleetGateway.stats().
CANONICAL_STATS = ("requests_served", "requests_shed", "sessions_migrated",
                   "queue_depth")

__all__ = [
    "BYTE_BUCKETS", "LATENCY_BUCKETS", "CANONICAL_STATS",
    "Counter", "Gauge", "Histogram", "MetricRegistry",
    "DecisionLog", "DecisionRecord",
    "NULL_TRACER", "NullTracer", "SpanTracer",
    "TimeSeriesStore",
    "Alert", "Objective", "SLOMonitor",
    "ObsServer",
    "ReplayReport", "dump_jsonl", "load_jsonl", "parse_cost",
    "record_to_json", "replay", "rescore",
]
