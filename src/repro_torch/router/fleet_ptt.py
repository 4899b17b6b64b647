"""FleetPTT — the Performance Trace Table at fleet scale.

Third instantiation of :class:`repro_torch.core.tracetable.TraceTable` — cores
(`core/ptt.py`) -> device groups (`distributed/elastic.py`) -> serving
replicas.  Indexed by (request class, replica) with two latency rows per
cell:

* **TTFT** — time-to-first-token *per prompt token* of requests routed to
  that replica (size-normalized by the router, so a 4k-prompt prefill and a
  512-token prefill train the same row without polluting each other); the
  signal for the router's *global* search (critical traffic);
* **TPOT** — time-per-output-token (engine decode-step latency); the
  signal for *sticky* search (non-critical, decode-heavy traffic).

A second single-axis table learns each replica's **per-request service
time** (``record_service``) — the :class:`~repro_torch.core.tracetable.QueueAware`
cost model turns backlog counts into *seconds of work ahead* with it, which
is what lets PTT routing beat join-shortest-queue instead of merely
matching it.  There is no width axis here: a replica is an opaque serving
unit (its internal width elasticity is the
:class:`~repro_torch.serve.scheduler.ElasticServeScheduler`'s job).

All searches accept a :class:`~repro_torch.core.tracetable.CostModel`; the
defaults reproduce the classic behavior (QueueAware for global/ranked,
Latency for sticky) exactly when no service rates have been recorded.

This is the PyTorch port's copy of ``repro.router.fleet_ptt``: host-side
Python and numpy, the same logic; only the imports differ.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Iterable, Sequence

import numpy as np

from ..core.tracetable import (Candidate, CostModel, EMASearchMixin,
                               GlobalSearch, Latency, QueueAware,
                               RankedSearch, SearchContext, StickySearch,
                               TraceTable)


class FleetPTT(EMASearchMixin):
    """``value(c, r, m)`` is the EMA'd latency of request class ``c`` on
    replica ``r`` for metric ``m``; 0.0 = untrained (visited first)."""

    TTFT = 0
    TPOT = 1
    NUM_METRICS = 2

    def __init__(self, num_replicas: int, num_classes: int):
        if num_replicas < 1:
            raise ValueError("need at least one replica")
        self.num_replicas = num_replicas
        self.num_classes = num_classes
        self._t = TraceTable((num_classes, num_replicas),
                             metrics=("ttft", "tpot"))
        # per-replica service rates: a pooled row (seconds per unit,
        # whatever the mix — what a caller with only queue *counts* can
        # use) plus a per-class split (short prefills drain a queue far
        # faster than decode-heavy turns; a caller passing class-resolved
        # backlogs gets each class priced at its own rate)
        self._svc = TraceTable((num_replicas,), metrics=("service",))
        self._svc_class = TraceTable((num_classes, num_replicas),
                                     metrics=("service",))

    # -- views -------------------------------------------------------------
    @property
    def updates(self) -> int:
        return self._t.updates

    def value(self, req_class: int, replica: int, metric: int = TTFT) -> float:
        return self._t.value((req_class, replica), metric)

    def table(self, req_class: int, metric: int = TTFT) -> np.ndarray:
        return self._t.array(metric)[req_class].copy()

    def trained(self, req_class: int, replica: int,
                metric: int = TTFT) -> bool:
        return self._t.trained((req_class, replica), metric)

    def service_time(self, replica: int,
                     req_class: int | None = None) -> float:
        """EMA'd per-unit wall service time on ``replica`` (seconds; 0.0 =
        untrained).  With ``req_class``, the class-split rate — falling
        back to the pooled row while the class row is untrained, so a
        class-resolved caller degrades to exactly the pooled prediction
        until per-class samples arrive."""
        if req_class is not None:
            v = self._svc_class.value((int(req_class), replica))
            if v > 0.0:
                return v
        return self._svc.value((replica,))

    # -- update ------------------------------------------------------------
    def update(self, req_class: int, replica: int, metric: int,
               sample: float) -> None:
        self._t.update((req_class, replica), sample, metric)

    def record_service(self, replica: int, seconds: float, *,
                       units: int = 1, req_class: int | None = None) -> None:
        """One completed request's wall service time on ``replica``.

        ``units`` must match the unit the caller's ``backlog`` is counted
        in: a caller passing queue *lengths* records whole-request times
        (units=1); a caller passing queued *prompt tokens* (the gateway
        knows every queued request's length — far sharper under mixed
        sizes) records per-token times (units=prompt_len).  The learned
        rate is seconds *per backlog unit* either way, so the QueueAware
        wait term ``backlog x rate`` stays dimensionally exact.

        ``req_class`` additionally trains that class's split rate (the
        pooled row always trains), which class-resolved backlogs read via
        ``service_time(replica, req_class)``."""
        rate = seconds / max(units, 1)
        self._svc.update((replica,), rate)
        if req_class is not None:
            self._svc_class.update((int(req_class), replica), rate)

    def decay_service(self, replica: int, target: float) -> None:
        """EMA the stored service rate toward ``target`` without a real
        completion sample — the router calls this while ``replica`` is
        quarantined (target = healthy-era rate x live drift ratio), so the
        stale rate *decays toward the interference-implied one in the
        store* instead of being drift-scaled at every read.  Untrained rows
        stay untrained (a decay is not evidence; adopting it would break
        the optimistic bootstrap)."""
        if target > 0.0 and self._svc.value((replica,)) > 0.0:
            self._svc.update((replica,), target)

    # -- searches ----------------------------------------------------------
    def _candidates(self, req_class: int, healthy: Iterable[int] | None,
                    backlog: Sequence[int | Mapping] | None
                    ) -> list[Candidate]:
        items = (range(self.num_replicas) if healthy is None
                 else tuple(healthy))
        def tie(r: int) -> float:
            if backlog is None:
                return 0
            b = backlog[r]
            return sum(b.values()) if isinstance(b, Mapping) else b
        return [Candidate(key=(req_class, r), item=r, tie=tie(r))
                for r in items]

    def _context(self, metric: int, backlog: Sequence[int | Mapping] | None,
                 tokens: int, current: int | None = None,
                 origin: int | None = None,
                 attribution=None) -> SearchContext:
        return SearchContext(metric=metric, backlog=backlog, tokens=tokens,
                             current=current, service=self.service_time,
                             origin=origin, attribution=attribution)

    def global_search(self, req_class: int, metric: int = TTFT,
                      healthy: Iterable[int] | None = None,
                      backlog: Sequence[int | Mapping] | None = None, *,
                      tokens: int = 1, origin: int | None = None,
                      cost: CostModel | None = None,
                      attribution=None) -> int:
        """Min-predicted-cost replica over the healthy set (critical
        traffic; the fleet analogue of the paper's global PTT search).
        Default cost: :class:`QueueAware` — ties (and the all-untrained
        bootstrap) break toward the shortest queue.  ``origin`` marks
        where the request's bytes live so a composed
        :class:`~repro_torch.core.tracetable.WanCost` can charge cross-link
        placement (the region tier's hop charge).  ``attribution``: an
        optional :class:`~repro_torch.core.tracetable.SearchAttribution` sink
        (see :mod:`repro_torch.obs.attribution`) recording the per-candidate
        cost breakdown of this decision — all three searches thread it."""
        return self._t.search(
            self._candidates(req_class, healthy, backlog),
            cost if cost is not None else QueueAware(), GlobalSearch(),
            self._context(metric, backlog, tokens, origin=origin,
                          attribution=attribution))

    def ranked_search(self, req_class: int, metric: int = TTFT,
                      healthy: Iterable[int] | None = None,
                      backlog: Sequence[int | Mapping] | None = None, *,
                      tokens: int = 1, current: int | None = None,
                      origin: int | None = None,
                      cost: CostModel | None = None,
                      attribution=None) -> list[int]:
        """All candidates in ascending predicted-cost order (same cost as
        ``global_search``) — for callers that need a fallback chain, e.g.
        session migration trying the next-best replica when the best one
        cannot hold the session.  ``current`` marks the session's present
        home so a composed :class:`~repro_torch.core.tracetable.MigrationCost`
        can charge every off-home candidate for the cache move."""
        return self._t.search(
            self._candidates(req_class, healthy, backlog),
            cost if cost is not None else QueueAware(), RankedSearch(),
            self._context(metric, backlog, tokens, current=current,
                          origin=origin, attribution=attribution))

    def sticky_search(self, req_class: int, replica: int, metric: int = TPOT,
                      healthy: Iterable[int] | None = None,
                      migrate_ratio: float = 2.0, *,
                      backlog: Sequence[int | Mapping] | None = None,
                      tokens: int = 1,
                      cost: CostModel | None = None,
                      attribution=None) -> int:
        """Stay on ``replica`` unless it is unhealthy or the best healthy
        replica beats it by more than ``migrate_ratio`` (non-critical
        traffic: avoid migration, only avoid disasters — the fleet analogue
        of the paper's local search).  Pass ``backlog`` with a queue-aware
        ``cost`` so a follow-up abandons a congested home; compose a
        :class:`~repro_torch.core.tracetable.MigrationCost` into ``cost`` to
        additionally charge the KV transfer itself."""
        return self._t.search(
            self._candidates(req_class, healthy, backlog),
            cost if cost is not None else Latency(),
            StickySearch(migrate_ratio),
            self._context(metric, backlog, tokens, current=replica,
                          attribution=attribution))

    # -- admission signal --------------------------------------------------
    def predict_ttft(self, req_class: int, replica: int,
                     backlog: int | Mapping = 0, *, tokens: int = 1,
                     value_scale: float = 1.0) -> float:
        """Predicted TTFT if routed to ``replica`` with ``backlog`` requests
        already ahead of it — the :class:`QueueAware` formula: TTFT rows
        are **size-normalized** (per prompt token), so the estimate scales
        back by ``tokens``; the wait is ``backlog`` x the replica's learned
        per-request service time (falling back to count inflation until
        that trains).  Untrained entries predict 0.0 — optimistic, so
        bootstrap traffic is always admitted.  ``value_scale`` inflates the
        TTFT *row* term only (the router's quarantine overflow scales the
        healthy-era row by the live drift ratio; the wait term needs no
        scaling because the stored service rate decays during quarantine —
        see :meth:`decay_service`).  A ``{req_class: units}`` mapping
        backlog prices each class's queued units at its own split rate
        (pooled fallback per class) — the sharper wait estimate under
        mixed short/long traffic."""
        est = self._t.value((req_class, replica), self.TTFT) * value_scale
        if isinstance(backlog, Mapping):
            return float(QueueAware().cost(
                est, Candidate(key=(req_class, replica), item=replica),
                SearchContext(metric=self.TTFT, backlog={replica: backlog},
                              tokens=tokens, service=self.service_time)))
        return float(QueueAware.predict(est, tokens, backlog,
                                        self.service_time(replica)))
