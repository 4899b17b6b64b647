"""RegionGateway — front N :class:`~repro_torch.router.FleetGateway` fleets
with a :class:`RegionRouter` and a byte
:class:`~repro_torch.region.transport.Transport`: the port's copy of
``repro/region/gateway.py``.  The fleets hold port engines, so a drain's
sessions leave one card-resident batch cache as host bytes and land in
another; the gateway itself is host-side Python and reads the wall clock
only through its injectable ``clock``.

The region tier's glue, mirroring what the fleet gateway does one level
down:

* ``submit`` routes each request to a fleet (sticky affinity keeps chatty
  decodes home unless the WAN-adjusted cost says otherwise) and hands it
  to that fleet's own admission;
* ``pump`` drains **browned-out** fleets — a region-wide incident, the
  whole-fleet analogue of a replica quarantine — then pumps every fleet
  and harvests region-level TTFT/service/TPOT observations into the
  region tables;
* a drain never hands live objects across the fleet boundary: each
  session is frozen (`FleetGateway.export_for_region`), encoded
  (:func:`~repro_torch.region.wire.encode_session`), shipped as bytes,
  decoded, and adopted (`FleetGateway.adopt_session`) — so replacing the
  loopback transport with a socket changes nothing here;
* before any export, :meth:`RegionRouter.drain_rank` asks whether the
  move *pays*: the browned-out source competes as the free stay-home
  candidate against every healthy fleet's predicted TPOT plus RTT,
  egress, and re-ingest charges.  A stay-home win skips the export
  entirely (the session finishes slowly where its cache already is);
* every shipped payload's delivery time trains the link's RTT EMA row —
  the WAN cost model learns from the drains it prices.

Cross-boundary identity is the ``rid``: a decoded session carries a *new*
:class:`~repro_torch.serve.engine.Request` object, so the gateway keeps
the live handle per rid (``request(rid)``) and the submitter's original
object stays frozen at its export-time state after a WAN migration.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from ..models.sessions import session_nbytes
from ..obs import BYTE_BUCKETS, NULL_TRACER
from ..router.gateway import FleetGateway
from ..serve.engine import Request, Session
from .router import RegionDecision, RegionRouter
from .transport import (DeliveryError, LoopbackTransport, ShipDropped,
                        Transport)
from .wire import WireFormatError, decode_session, encode_session


class RegionGateway:
    HANDLE_CAP = 100_000     # finished request handles retained (oldest
                             # harvested entries evicted first)

    def __init__(self, fleets: Sequence[FleetGateway],
                 router: RegionRouter | None = None,
                 transport: Transport | None = None,
                 clock=time.perf_counter):
        if not fleets:
            raise ValueError("need at least one fleet")
        self.fleets = list(fleets)
        self.router = router or RegionRouter(len(fleets))
        self.transport = transport or LoopbackTransport()
        self.clock = clock
        self._handles: dict[int, Request] = {}   # rid -> live handle
        self._meta: dict[int, dict] = {}         # rid -> harvest state
        self._unharvested: set[int] = set()      # rids awaiting a first
                                                 # token (pump scans ONLY
                                                 # these, not all history)
        self._shed_seen = [0] * len(self.fleets)   # per-fleet shed_total
                                                   # consumed so far
        self._wan_ships = 0
        self._wan_bytes = 0                      # wire bytes on links
        self._raw_bytes = 0                      # pre-compression cache bytes
        self._stay_home = 0                      # drain exports skipped
        # exactly-once machinery: every export of a rid gets a fresh
        # monotonic epoch in its (origin, rid, epoch) delivery id; the
        # adoption path records ids it has seen so a duplicated delivery
        # (a retransmission race the transport surfaces via
        # take_duplicates) is recognized and dropped, never double-adopted
        self._epoch: dict[int, int] = {}
        self._delivered: set[tuple] = set()
        self._delivery_failures = 0              # retry budget exhausted
        self._dups_deduped = 0
        self._dups_dropped = 0                   # undecodable duplicates
        # observability (attach_obs): null tracer / no registry by default
        self.tracer = NULL_TRACER
        self.metrics = None
        self.obs_name = "region"
        self._m_ships = self._m_stay = None
        self._h_ship_bytes = self._h_ship_rtt = None
        # SLO control plane (attach_slo / attach_timeseries), on the
        # region's own pump-tick logical clock
        self._pump_count = 0
        self.slo = None
        self._tss = None
        self._tss_every = 1

    # -- observability -----------------------------------------------------
    def attach_obs(self, tracer=None, metrics=None,
                   name: str | None = None) -> None:
        """Attach a :class:`~repro_torch.obs.SpanTracer` and/or
        :class:`~repro_torch.obs.MetricRegistry` to this gateway and every
        fleet that has none of its own (fleets propagate on down to engines) —
        one call at the region instruments all four scales. Fleets are tracked
        as ``{name}/f{i}``; WAN ships become spans on the region track,
        stay-home skips instant events."""
        if name is not None:
            self.obs_name = name
        if tracer is not None:
            self.tracer = tracer
        if metrics is not None:
            self.metrics = metrics
            g = self.obs_name
            self._m_ships = metrics.counter(
                "region_wan_ships_total",
                "Sessions shipped across WAN links", region=g)
            self._m_stay = metrics.counter(
                "region_stay_home_skips_total",
                "Drain exports skipped because staying home won", region=g)
            self._h_ship_bytes = metrics.histogram(
                "region_ship_bytes", "Wire bytes per shipped session",
                buckets=BYTE_BUCKETS, region=g)
            self._h_ship_rtt = metrics.histogram(
                "region_ship_rtt_seconds",
                "Observed per-ship link delivery time", region=g)
        for i, gw in enumerate(self.fleets):
            t = tracer if gw.tracer is NULL_TRACER else None
            m = metrics if gw.metrics is None else None
            if t is not None or m is not None:
                gw.attach_obs(t, m, name=f"{self.obs_name}/f{i}")

    def attach_slo(self, monitor) -> None:
        """Attach an :class:`~repro_torch.obs.SLOMonitor` fed region-level
        signals: client TTFT in wall seconds (``"ttft"``) and in region
        pump ticks (``"ttft_pumps"``), served/shed availability verdicts,
        and per-ship WAN delivery verdicts (``"wan_delivery"`` — a
        partitioned link burns this objective's budget until the window
        of failed drains ages out) — evaluated once per region pump."""
        self.slo = monitor
        monitor.attach_obs(
            self.tracer if self.tracer is not NULL_TRACER else None,
            self.metrics, name=f"{self.obs_name}/slo")

    def attach_timeseries(self, store, every: int = 1) -> None:
        """Sample a :class:`~repro_torch.obs.TimeSeriesStore` every ``every``
        region pumps (the fleets' own series live in the same registry, so one
        region-attached store captures all four scales)."""
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self._tss = store
        self._tss_every = int(every)

    # -- ingress -----------------------------------------------------------
    def class_backlogs(self) -> list[dict[int, int]]:
        """Per-fleet class-resolved backlog — the region search prices
        each class's queued units at its learned per-class rate."""
        return [gw.class_backlog() for gw in self.fleets]

    def submit(self, req: Request, *, origin: int = 0,
               affinity: int | None = None) -> RegionDecision:
        d = self.router.route(len(req.prompt), req.max_new, origin=origin,
                              affinity=affinity,
                              backlog=self.class_backlogs())
        if len(self._meta) >= self.HANDLE_CAP:      # evict oldest finished
            for rid in list(self._meta):
                if len(self._meta) < self.HANDLE_CAP:
                    break
                if rid not in self._unharvested:
                    del self._meta[rid]
                    del self._handles[rid]
        self._handles[req.rid] = req
        self._meta[req.rid] = {"fleet": d.fleet,
                               "req_class": int(d.req_class),
                               "t_arrival": self.clock(), "ttft": None,
                               "pump_arrival": self._pump_count}
        self._unharvested.add(req.rid)
        self.fleets[d.fleet].submit(req)
        return d

    def request(self, rid: int) -> Request:
        """The live handle for ``rid`` — after a WAN migration this is the
        decoded copy accumulating tokens, not the submitter's original.
        Finished handles are retained up to ``HANDLE_CAP`` (oldest evicted
        first); an evicted rid raises KeyError."""
        return self._handles[rid]

    # -- brownout ----------------------------------------------------------
    def brownout(self, fleet: int) -> None:
        """Take a whole fleet out of rotation; the next ``pump`` drains
        its live sessions cross-region through the wire format."""
        self.router.brownout(fleet)

    def restore(self, fleet: int) -> None:
        self.router.restore(fleet)

    def _ship_session(self, sess: Session, src: int, dst: int) -> None:
        t0 = self.clock()
        self._raw_bytes += session_nbytes(sess.cache)
        # stamp the exactly-once delivery id before encoding: same rid,
        # new epoch per export attempt — a retried/duplicated delivery of
        # THIS export re-presents the same id and dedups; a later re-export
        # (after a failed delivery) presents a fresh epoch and adopts
        epoch = self._epoch.get(sess.req.rid, -1) + 1
        self._epoch[sess.req.rid] = epoch
        sess.delivery = (src, sess.req.rid, epoch)
        data = encode_session(sess)
        try:
            delivered, rtt = self.transport.ship(data, src, dst)
        except (DeliveryError, ShipDropped):
            # retry budget exhausted (or, with no reliable layer, the one
            # attempt was lost): the session never left our hands —
            # degrade by parking it back on its source fleet, where it
            # drains slowly but is never lost
            self._delivery_failures += 1
            if self.slo is not None:
                self.slo.observe_ok("wan_delivery", False)
            self.fleets[src].adopt_session(sess)
            if self.tracer.enabled:
                self.tracer.instant(
                    "wan-delivery-failed", self.tracer.trace_for(
                        sess.req.rid), self.obs_name, src=src, dst=dst)
            return
        if rtt > 0.0:
            self.router.record_rtt(src, dst, rtt, now=self.clock())
        try:
            sess = decode_session(delivered)     # the far side's object
        except WireFormatError:
            # delivered but corrupt, with no reliable layer to have
            # retried it: same degradation as a failed delivery — the
            # pre-encode object is still in hand, park it on its source
            self._delivery_failures += 1
            if self.slo is not None:
                self.slo.observe_ok("wan_delivery", False)
            self.fleets[src].adopt_session(sess)
            if self.tracer.enabled:
                self.tracer.instant(
                    "wan-delivery-failed", self.tracer.trace_for(
                        sess.req.rid), self.obs_name, src=src, dst=dst)
            return
        try:
            self.fleets[dst].adopt_session(sess)
        except ValueError:
            # the destination refused after all (raced slot/cache churn
            # between the can_hold pre-check and the import): the export
            # is sunk but the session must not be lost — park it back on
            # the source fleet, where it drains slowly
            self.fleets[src].adopt_session(sess)
            dst = src
        if sess.delivery is not None:
            self._delivered.add(tuple(sess.delivery))
        self._handles[sess.req.rid] = sess.req
        if sess.req.rid in self._meta:
            self._meta[sess.req.rid]["fleet"] = dst
        self._wan_ships += 1
        self._wan_bytes += len(data)
        if self.slo is not None:
            self.slo.observe_ok("wan_delivery", True)
        if self.tracer.enabled:
            # the wire carried the session's trace context (v2's "trace"
            # key), so this span lands on the SAME timeline the request's
            # engine events are on — encode->ship->decode->adopt, end to end
            if sess.trace is not None:
                self.tracer.adopt(sess.req.rid, sess.trace["trace_id"])
            self.tracer.complete(
                "wan-ship", self.tracer.trace_for(sess.req.rid),
                self.obs_name, ts=t0, dur=self.clock() - t0, src=src,
                dst=dst, wire_bytes=len(data))
        if self._m_ships is not None:
            self._m_ships.inc()
            self._h_ship_bytes.observe(float(len(data)))
            if rtt > 0.0:
                self._h_ship_rtt.observe(rtt)

    def _drain_browned_out(self) -> int:
        """Empty every browned-out fleet: re-route unstarted requests,
        ship parked session imports, and migrate live sessions whose WAN
        move pays (stay-home wins skip the export).  Returns sessions
        shipped this pump."""
        shipped = 0
        for src in sorted(self.router.browned_out):
            gw = self.fleets[src]
            if not self.router.healthy():
                break                # nowhere to go: degrade gracefully
            for req in gw.drain_unstarted():
                d = self.router.route(len(req.prompt), req.max_new,
                                      origin=src,
                                      backlog=self.class_backlogs())
                if req.rid in self._meta:
                    self._meta[req.rid]["fleet"] = d.fleet
                self.fleets[d.fleet].submit(req)
            for sess in gw.drain_parked_sessions():
                # already host-numpy: the export is sunk, ship to the best
                # healthy fleet that fits (back onto the source if none)
                remaining = max(sess.req.max_new - len(sess.req.out_tokens),
                                0)
                order = self.router.drain_rank(
                    src, sess.pos, backlog=self.class_backlogs())
                dest = next((f for f in order if f != src
                             and self.fleets[f].can_hold(sess.pos,
                                                         remaining)), None)
                if dest is None:
                    gw.adopt_session(sess)
                    continue
                self._ship_session(sess, src, dest)
                shipped += 1
            for rid, pos, remaining in gw.live_sessions():
                order = self.router.drain_rank(
                    src, pos, backlog=self.class_backlogs())
                viable = [f for f in order
                          if f == src or self.fleets[f].can_hold(pos,
                                                                 remaining)]
                if not viable or viable[0] == src:
                    # stay-home win (or nowhere fits): the WAN move does
                    # not pay — no export, no device->host round trip
                    self._stay_home += 1
                    if self._m_stay is not None:
                        self._m_stay.inc()
                    if self.tracer.enabled:
                        self.tracer.instant(
                            "stay-home", self.tracer.trace_for(rid),
                            self.obs_name, fleet=src, pos=pos)
                    continue
                self._ship_session(gw.export_for_region(rid), src,
                                   viable[0])
                shipped += 1
        return shipped

    def _drain_duplicates(self) -> None:
        """Absorb duplicated deliveries the transport queued (the
        retransmission race): decode each copy and drop it against the
        delivery-id registry.  Every duplicate is redundant by
        construction — the synchronous ship path never abandons a
        session (a failed delivery parks it back on its source), so the
        original copy always has a live home and adopting a second one
        would double-run the rid.  The dedup count is the exactly-once
        evidence the chaos tests assert on."""
        take = getattr(self.transport, "take_duplicates", None)
        if take is None:
            return
        for _src, _dst, payload in take():
            try:
                sess = decode_session(payload)
            except WireFormatError:
                self._dups_dropped += 1          # corrupt copy: ignore
                continue
            if sess.delivery is not None:
                self._dups_deduped += 1

    # -- pump --------------------------------------------------------------
    def pump(self) -> int:
        """One region iteration: age stale RTT rows, drain browned-out
        fleets, pump every fleet, harvest region-level observations.
        Returns sequences still active region-wide."""
        self._pump_count += 1
        if self.tracer.enabled:
            self.tracer.set_tick(self._pump_count)
        # rows age BEFORE this pump's drain decisions read them: a link
        # whose last delivery predates a route flap must not price this
        # pump's WAN moves with its stale RTT
        self.router.age_links(self.clock())
        self._drain_browned_out()
        self._drain_duplicates()
        active = 0
        for f, gw in enumerate(self.fleets):
            a = gw.pump()
            active += a
            if a > 0:
                # region TPOT row: the fleet's engines' per-token decode
                # latency (the drain/sticky searches read this)
                lat = [e.last_step_latency for e in gw.engines
                       if e.last_step_latency > 0.0]
                if lat:
                    self.router.record_tpot(f, float(np.mean(lat)))
        for f, gw in enumerate(self.fleets):
            # requests the fleet shed will never produce a first token:
            # release them from the harvest scan (and so from the
            # eviction exemption) — only the NEW sheds since last pump
            # are walked, via the fleet's monotone shed counter
            new = gw.shed_total - self._shed_seen[f]
            if new:
                self._shed_seen[f] = gw.shed_total
                for req in list(gw.shed)[-new:]:
                    self._unharvested.discard(req.rid)
                    if self.slo is not None:
                        self.slo.observe_ok("availability", False)
        for rid in list(self._unharvested):
            mt = self._meta[rid]
            h = self._handles[rid]
            if not h.out_tokens:
                continue
            self._unharvested.discard(rid)
            tok = h.t_first if h.t_first is not None else self.clock()
            mt["ttft"] = tok - mt["t_arrival"]
            # like the fleet gateway: the learning sample is the service
            # span (prefill start -> first token), not the client span —
            # queue wait is the backlog term's job, WAN time the links'
            t0 = h.t_admit if h.t_admit is not None else mt["t_arrival"]
            self.router.record_ttft(mt["fleet"], mt["req_class"],
                                    tok - t0, prompt_len=len(h.prompt))
            # units=1: class_backlogs() counts requests per class, so the
            # learned rate must be seconds per request (the per-class
            # split is what absorbs the size differences)
            self.router.record_service(mt["fleet"], tok - t0,
                                       req_class=mt["req_class"])
            if self.slo is not None:
                if self.slo.wants("ttft"):
                    self.slo.observe("ttft", mt["ttft"])
                if self.slo.wants("ttft_pumps"):
                    self.slo.observe("ttft_pumps", float(
                        self._pump_count - mt["pump_arrival"]))
                self.slo.observe_ok("availability", True)
        if self._tss is not None and self._pump_count % self._tss_every == 0:
            self._tss.sample(self._pump_count, self.clock())
        if self.slo is not None:
            self.slo.evaluate(self._pump_count, self.clock())
        return active

    def run_until_drained(self, max_steps: int = 10000) -> None:
        for _ in range(max_steps):
            if (self.pump() == 0
                    and not any(gw.held for gw in self.fleets)
                    and not any(e.pending() for gw in self.fleets
                                for e in gw.engines)):
                return

    # -- results -----------------------------------------------------------
    def ttfts(self) -> dict[int, float]:
        return {rid: m["ttft"] for rid, m in self._meta.items()
                if m["ttft"] is not None}

    def stats(self) -> dict:
        fleet_stats = [gw.stats() for gw in self.fleets]
        return {**self.router.stats(),
                # unified cross-scale counters (obs.CANONICAL_STATS);
                # "wan_ships"/"fleet_served" remain as legacy aliases
                "requests_served": sum(s["requests_served"]
                                       for s in fleet_stats),
                "requests_shed": sum(s["requests_shed"]
                                     for s in fleet_stats),
                "sessions_migrated": self._wan_ships,
                "queue_depth": sum(s["queue_depth"] for s in fleet_stats),
                "wan_ships": self._wan_ships,
                "wan_bytes": self._wan_bytes,
                "raw_session_bytes": self._raw_bytes,
                "stay_home_skips": self._stay_home,
                "delivery_failures": self._delivery_failures,
                "duplicates_deduped": self._dups_deduped,
                "duplicates_dropped": self._dups_dropped,
                "fleet_served": [s["served"] for s in fleet_stats]}
