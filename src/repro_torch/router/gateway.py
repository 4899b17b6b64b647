"""FleetGateway — front N in-process :class:`ServeEngine` replicas with a
:class:`FleetRouter`.

The gateway is the glue between router policy and engine mechanics:

* ``submit`` classifies + routes each request (or queues/sheds it per the
  admission decision) and stamps its arrival time;
* ``pump`` retries gateway-queued requests, **drains quarantined replicas
  by migrating their live decode sessions** to the PTT-best healthy
  replica (`ServeEngine.export_session` -> `import_session`) — when the
  router carries a :class:`~repro_torch.core.tracetable.MigrationCost`, the
  drain placement charges the KV move (``fixed + per_token x pos``)
  against the predicted win, so a session only leaves when migrating
  pays for itself — steps every engine once, and harvests TTFT
  observations: client-facing TTFT
  (arrival -> first token, including gateway queue time) for ``ttfts()``,
  dispatch -> first token for the FleetPTT so admission's backlog term
  doesn't double-count queueing;
* each engine's ``on_step_latency`` hook feeds the router's interference
  detector, so a replica that suddenly slows down (co-tenant, thermal,
  link degradation) is quarantined — and now *actively drained*, not just
  starved of new traffic — without any platform knowledge: the paper's
  work-stealing of started work under dynamic asymmetry, at fleet scale;
* every harvested first token also trains the replica's **service-rate**
  row (``record_service``), which the QueueAware cost model uses to turn
  backlog counts into predicted seconds of wait;
* when load must be dropped, shed order is **(class priority, tenant
  debt)**: the lowest-priority held request goes first and, within a
  priority, the tenant that has shed the least against its
  ``SLOPolicy.tenant_weight`` share — weighted fair shedding, not
  arrival-order luck.

Probe requests stay pinned to their quarantined replica: they exist to
generate the recovery signal, so migrating them off would strand the
replica in quarantine forever.

This is the PyTorch port's copy of ``repro.router.gateway``: host-side
Python and numpy, the same logic; only the imports differ.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Sequence

from ..core.tracetable import QueueAware
from ..distributed.elastic import HeartbeatMonitor
from ..obs import NULL_TRACER
from ..serve.engine import Request, ServeEngine, Session
from ..serve.scheduler import RequestClass, classify_request
from .admission import Admission
from .fleet_ptt import FleetPTT
from .router import FleetRouter, RouteDecision


class DuplicateDelivery(ValueError):
    """The session's wire delivery id was already adopted by this fleet:
    the payload is a duplicated or retried copy of a delivery that
    completed, and dropping it is the correct (exactly-once) outcome."""


@dataclasses.dataclass
class _Tracked:
    req: Request
    replica: int
    req_class: int
    t_arrival: float         # gateway arrival: client-facing TTFT includes
                             # time spent QUEUE'd at the gateway
    t_dispatch: float        # engine submit: the PTT trains on dispatch->
                             # first-token so predict_ttft's (1+backlog)
                             # term doesn't double-count queueing
    probe: bool = False      # pinned to its (quarantined) replica
    ttft: float | None = None
    t_handoff: float | None = None   # disaggregated: when the prefilled
                                     # session landed on its decode replica
    first_decode: float | None = None


class FleetGateway:
    MAX_REQUEUES = 50        # a QUEUE'd request is shed after this many
                             # failed re-admissions (SLO unreachable)
    TTFT_CAP = 100_000       # per-request TTFTs retained (oldest evicted)
    SHED_CAP = 10_000        # shed requests retained for inspection

    def __init__(self, engines: Sequence[ServeEngine],
                 router: FleetRouter | None = None, clock=time.perf_counter,
                 transport=None, injector=None,
                 heartbeat_timeout: float | None = None):
        if not engines:
            raise ValueError("need at least one engine")
        self.engines = list(engines)
        self.router = router or FleetRouter(len(engines))
        self.clock = clock
        # chaos plane (all optional; None leaves it off):
        # * transport: prefill->decode handoffs ship their RSES bytes
        #   through it (and so through any chaos/reliable decorators)
        #   instead of an in-process encode->decode round trip;
        # * injector: a FaultInjector whose crash/restart schedule is
        #   applied to the engines each pump (the gateway owns the
        #   injector's logical clock — one advance() per pump);
        # * heartbeat_timeout (in PUMPS, not seconds): wires a
        #   HeartbeatMonitor to the pump-tick logical clock — live
        #   engines beat every pump, a crashed one goes silent, and
        #   after `timeout` silent pumps it is force-quarantined and its
        #   lost work recovered from the snapshot ledger
        self.transport = transport
        self.injector = injector
        self._pump_count = 0
        self._hb = (HeartbeatMonitor(len(engines), timeout=heartbeat_timeout,
                                     now=0.0)
                    if heartbeat_timeout is not None else None)
        self._hb_quarantined: set[int] = set()
        # exactly-once + crash-recovery ledgers (populated only when the
        # chaos plane is active — see _snapshot_session):
        # rid -> latest wire snapshot + the replica hosting the session
        self._snapshots: dict[int, tuple[bytes, int]] = {}
        self._handles: dict[int, Request] = {}   # rid -> LIVE request
        self._epoch: dict[int, int] = {}         # rid -> next delivery epoch
        self._delivered: set[tuple] = set()      # adopted delivery ids
        self._delivery_failures = 0
        self._dups_deduped = 0
        self._crashes_detected = 0
        self._crash_recovered = 0                # sessions re-placed
        self._crash_resubmitted = 0              # re-prefilled from scratch
        # only requests still in flight are tracked; finished ones fold
        # into counters and capped collections so a long-lived gateway
        # stays bounded
        self.tracked: list[_Tracked] = []
        # (request, affinity, requeue count, arrival time)
        self.held: deque[tuple[Request, int | None, int, float]] = deque()
        self.shed: deque[Request] = deque(maxlen=self.SHED_CAP)
        self.shed_total = 0      # monotone (the deque caps/evicts): lets a
                                 # region tier consume only NEW sheds per pump
        self._displaced_rids: set[int] = set()   # one displacement each
        # weighted fair shedding: each shed charges its tenant weight_of()
        # debt; victims come from the lowest-debt tenant first, so shed
        # counts converge to ~1/weight shares
        self._tenant_debt: dict = {}
        self._ttfts: dict[int, float] = {}
        self._served = 0
        self._migrations = 0
        self._handoffs = 0
        # disaggregated TTFT attribution: rid -> {prefill_s, ship_s,
        # first_decode_s} (capped alongside _ttfts)
        self._breakdown: dict[int, dict] = {}
        self._per_replica = [0] * len(self.engines)
        # role topology: each engine declares itself prefill-, decode-, or
        # both-capable (ServeEngine(role=...)).  An all-"both" fleet is the
        # monolithic baseline — no restriction is ever applied.
        self.roles = [getattr(e, "role", "both") for e in self.engines]
        self._prefill_ok = [i for i, ro in enumerate(self.roles)
                            if ro in ("prefill", "both")]
        self._decode_ok = [i for i, ro in enumerate(self.roles)
                           if ro in ("decode", "both")]
        if not self._prefill_ok or not self._decode_ok:
            raise ValueError(
                f"fleet roles {self.roles} leave no "
                f"{'prefill' if not self._prefill_ok else 'decode'}-capable "
                f"replica")
        for i, e in enumerate(self.engines):
            e.on_step_latency = (
                lambda dt, _r=i: self.router.record_step(_r, dt))
            # chunked-prefill wall time flows to its OWN router signal —
            # never record_step, so prompt chunks can't trip the
            # interference detector
            e.on_prefill_latency = (
                lambda dt, _r=i: self.router.record_prefill_chunk(_r, dt))
            if self.roles[i] == "prefill":
                # prefill-specialized: the engine hands every freshly
                # prefilled session to the gateway instead of decoding it
                e.on_prefill_complete = (
                    lambda sess, _r=i: self._handoff(sess, _r))
        # observability (attach_obs): null tracer / no registry by default
        self.tracer = NULL_TRACER
        self.metrics = None
        self.obs_name = "fleet"
        self._m_served = self._m_shed = self._m_migrations = None
        self._h_ttft = self._h_queue_wait = None
        self._m_handoffs = self._h_handoff = self._h_handoff_bytes = None
        # SLO control plane (attach_slo / attach_timeseries): both opt-in
        self.slo = None
        self._tss = None
        self._tss_every = 1
        self._g_drift: list | None = None       # per-replica drift gauges
        self._g_quar: list | None = None        # per-replica quarantine state
        # rid -> pump tick at submit: TTFT in PUMPS, the logical-clock
        # twin of the wall TTFT (deterministic under a seeded chaos run)
        self._arrival_pump: dict[int, int] = {}

    # -- observability -----------------------------------------------------
    def attach_obs(self, tracer=None, metrics=None,
                   name: str | None = None) -> None:
        """Attach a :class:`~repro_torch.obs.SpanTracer` and/or
        :class:`~repro_torch.obs.MetricRegistry` to this gateway, its router, and
        every engine that has no explicit tracer/registry of its own
        (engines keep one attached directly — the identity check against
        :data:`~repro_torch.obs.NULL_TRACER` — so a caller can still wire a
        replica separately).  Engines are tracked as ``{name}/r{i}``."""
        if name is not None:
            self.obs_name = name
        if tracer is not None:
            self.tracer = tracer
        if metrics is not None:
            self.metrics = metrics
            g = self.obs_name
            self._m_served = metrics.counter(
                "fleet_requests_served_total",
                "Requests finished fleet-wide", fleet=g)
            self._m_shed = metrics.counter(
                "fleet_requests_shed_total",
                "Requests dropped by weighted fair shedding", fleet=g)
            self._m_migrations = metrics.counter(
                "fleet_sessions_migrated_total",
                "Live sessions moved off quarantined replicas", fleet=g)
            self._h_ttft = metrics.histogram(
                "fleet_ttft_seconds",
                "Client-facing TTFT (arrival -> first token)", fleet=g)
            self._h_queue_wait = metrics.histogram(
                "fleet_queue_wait_seconds",
                "Gateway arrival -> engine dispatch wait", fleet=g)
            self._m_handoffs = metrics.counter(
                "fleet_prefill_handoffs_total",
                "Prefilled sessions shipped to decode replicas", fleet=g)
            self._h_handoff = metrics.histogram(
                "fleet_handoff_seconds",
                "Prefill->decode KV session ship wall time", fleet=g)
            self._h_handoff_bytes = metrics.histogram(
                "fleet_handoff_bytes",
                "Encoded session payload size at handoff", fleet=g)
        self.router.attach_obs(tracer, metrics, name=self.obs_name)
        for i, e in enumerate(self.engines):
            t = tracer if e.tracer is NULL_TRACER else None
            m = metrics if e.metrics is None else None
            if t is not None or m is not None:
                e.attach_obs(t, m, name=f"{self.obs_name}/r{i}")

    def attach_slo(self, monitor) -> None:
        """Attach an :class:`~repro_torch.obs.SLOMonitor`: the pump feeds it
        TTFT (wall seconds via a ``"ttft"`` objective, pump ticks via
        ``"ttft_pumps"`` — the deterministic logical-clock twin), decode
        TPOT (``"tpot"``), and served/shed verdicts (``"availability"``),
        and evaluates it once per pump on the pump-tick clock."""
        self.slo = monitor
        monitor.attach_obs(
            self.tracer if self.tracer is not NULL_TRACER else None,
            self.metrics, name=f"{self.obs_name}/slo")

    def attach_timeseries(self, store, every: int = 1) -> None:
        """Attach a :class:`~repro_torch.obs.TimeSeriesStore` sampled every
        ``every`` pumps.  Also exports the interference detector's
        Fig. 8 signal as per-replica gauges on the store's registry —
        ``fleet_replica_drift_ratio`` and ``fleet_replica_quarantined``
        (1.0 = detector- or heartbeat-quarantined) — refreshed right
        before each sample so the rings carry the full trajectory."""
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self._tss = store
        self._tss_every = int(every)
        g = self.obs_name
        self._g_drift = [store.registry.gauge(
            "fleet_replica_drift_ratio",
            "Interference detector fast/baseline latency ratio",
            fleet=g, replica=r) for r in range(len(self.engines))]
        self._g_quar = [store.registry.gauge(
            "fleet_replica_quarantined",
            "Replica quarantine state (detector or heartbeat)",
            fleet=g, replica=r) for r in range(len(self.engines))]

    def _sample_obs(self) -> None:
        """End-of-pump SLO/time-series duty: refresh the detector
        gauges, sample every registry series, evaluate burn rates."""
        if self._tss is not None:
            if self._g_drift is not None:
                det = self.router.detector
                for r, drift in enumerate(det.drifts()):
                    self._g_drift[r].set(drift)
                    self._g_quar[r].set(
                        1.0 if (r in det.quarantined
                                or r in self._hb_quarantined) else 0.0)
            if self._pump_count % self._tss_every == 0:
                self._tss.sample(self._pump_count, self.clock())
        if self.slo is not None:
            self.slo.evaluate(self._pump_count, self.clock())

    # -- ingress -----------------------------------------------------------
    def backlog(self) -> list[int]:
        return [e.pending() + e.active_count() for e in self.engines]

    def class_backlog(self) -> dict[int, int]:
        """This fleet's queued+active composition by request class — the
        class-resolved backlog a region tier prices per class (a queue of
        short prefills drains far faster than the same count of
        decode-heavy turns).  This is an O(queued+active) walk recomputed
        per call; a deployment routing at high request rates should
        maintain incremental counters instead (measured follow-up — at
        this reference scale the walk never shows up in profiles)."""
        counts: dict[int, int] = {}
        def add(c: int) -> None:
            counts[c] = counts.get(c, 0) + 1
        for e in self.engines:
            for req in e.queue:
                add(int(classify_request(len(req.prompt), req.max_new)))
            for _ in e.sessions_in:
                add(int(RequestClass.DECODE))
            for req in e.active:
                if req is not None:
                    add(int(classify_request(len(req.prompt), req.max_new)))
        for req, _, _, _ in self.held:
            add(int(classify_request(len(req.prompt), req.max_new)))
        return counts

    def prefill_capable(self) -> list[int]:
        """Replicas that can admit fresh requests (role prefill/both)."""
        return list(self._prefill_ok)

    def decode_capable(self) -> list[int]:
        """Replicas that can host decode sessions (role decode/both) — the
        region tier checks this before shipping a session here."""
        return list(self._decode_ok)

    def _route_allowed(self) -> list[int] | None:
        """The ``allowed=`` restriction for fresh-request routing: None in
        an all-"both" fleet (monolithic — no restriction, no behavior
        change), the prefill-capable subset otherwise."""
        return (None if len(self._prefill_ok) == len(self.engines)
                else list(self._prefill_ok))

    def submit(self, req: Request,
               affinity: int | None = None) -> RouteDecision:
        """Route one request.  The returned decision reflects the request's
        actual outcome: a SHED verdict that displaced a lower-priority held
        request (this one waits in its place) is reported as QUEUE."""
        t_arrival = self.clock()
        if len(self._handles) >= self.TTFT_CAP:      # evict oldest
            self._handles.pop(next(iter(self._handles)))
        self._handles[req.rid] = req
        if len(self._arrival_pump) >= self.TTFT_CAP:
            self._arrival_pump.pop(next(iter(self._arrival_pump)))
        self._arrival_pump[req.rid] = self._pump_count
        d = self.router.route(len(req.prompt), req.max_new,
                              affinity=affinity, backlog=self.backlog(),
                              allowed=self._route_allowed())
        if d.action is Admission.ADMIT:
            self._dispatch(req, d, t_arrival)
        elif d.action is Admission.QUEUE:
            if self.tracer.enabled:
                self.tracer.instant("queue", self.tracer.trace_for(req.rid),
                                    self.obs_name,
                                    predicted_ttft=d.predicted_ttft)
            self.held.append((req, affinity, 0, t_arrival))
        elif self._shed_or_displace(req, d.req_class):
            self.held.append((req, affinity, 0, t_arrival))
            d = dataclasses.replace(d, action=Admission.QUEUE)
        return d

    def handle(self, rid: int) -> Request:
        """The LIVE request object for ``rid``.  Under crash recovery the
        stream may continue on a wire-decoded copy (or a re-prefilled
        clone) of the submitter's object — the submitter's original then
        stays frozen at its pre-crash state, and this map points at
        whichever object is actually accumulating tokens (the fleet-scale
        analogue of :meth:`RegionGateway.request`)."""
        return self._handles[rid]

    def _dispatch(self, req: Request, d: RouteDecision,
                  t_arrival: float) -> None:
        t_dispatch = self.clock()
        self.tracked.append(_Tracked(req=req, replica=d.replica,
                                     req_class=int(d.req_class),
                                     t_arrival=t_arrival,
                                     t_dispatch=t_dispatch,
                                     probe=d.probe))
        self._per_replica[d.replica] += 1
        if self.tracer.enabled:
            self.tracer.instant("admit", self.tracer.trace_for(req.rid),
                                self.obs_name, replica=d.replica,
                                probe=d.probe)
        if self._h_queue_wait is not None:
            self._h_queue_wait.observe(t_dispatch - t_arrival)
        self.engines[d.replica].submit(req)

    # -- weighted fair shedding --------------------------------------------
    def _shed_request(self, req: Request) -> None:
        """Every shed flows through here so the victim's tenant pays its
        ``weight_of`` debt (the fair-shedding ledger)."""
        w = self.router.admission.policy.weight_of(req.tenant)
        self._tenant_debt[req.tenant] = (
            self._tenant_debt.get(req.tenant, 0.0) + w)
        self.shed.append(req)
        self.shed_total += 1
        if self._m_shed is not None:
            self._m_shed.inc()
        if self.slo is not None:
            self.slo.observe_ok("availability", False)
        if self.tracer.enabled:
            self.tracer.instant("shed", self.tracer.trace_for(req.rid),
                                self.obs_name, tenant=str(req.tenant))

    def _displace_lower_priority(self, req_class) -> bool:
        """If a held request has strictly lower class priority, shed *it*
        instead — choosing, among the lowest-priority held requests, the
        one whose tenant has the least shed debt (weighted fair order).
        Returns True when a victim was displaced."""
        if not self.held:
            return False
        pri = self.router.admission.policy.priority_of
        cls_of = lambda r: classify_request(len(r.prompt), r.max_new)
        i_min = min(range(len(self.held)),
                    key=lambda i: (pri(cls_of(self.held[i][0])),
                                   self._tenant_debt.get(
                                       self.held[i][0].tenant, 0.0)))
        victim, _, _, _ = self.held[i_min]
        victim_class = cls_of(victim)
        if pri(victim_class) >= pri(RequestClass(req_class)):
            return False
        del self.held[i_min]
        self._displaced_rids.discard(victim.rid)   # victim leaves the gateway
        self.router.admission.reclassify(victim_class, Admission.QUEUE,
                                         Admission.SHED)
        self._shed_request(victim)
        return True

    def _shed_or_displace(self, req: Request, req_class) -> bool:
        """A SHED-counted outcome for ``req``: drop a lower-priority held
        request instead when one exists (``req`` then waits in its place —
        the caller holds it).  Each request may displace at most ONE victim
        — a persistently hopeless request must not flush the whole
        lower-priority queue one victim per re-evaluation.  Returns True
        when ``req`` was kept (count moved SHED -> QUEUE), False when it
        was shed."""
        if (req.rid not in self._displaced_rids
                and self._displace_lower_priority(req_class)):
            self._displaced_rids.add(req.rid)
            self.router.admission.reclassify(req_class, Admission.SHED,
                                             Admission.QUEUE)
            return True
        self._displaced_rids.discard(req.rid)    # leaving the gateway
        self._shed_request(req)
        return False

    # -- chaos plane: scheduled faults, heartbeats, crash recovery ---------
    def _apply_faults(self) -> None:
        """Advance the injector's logical clock one step and apply its
        crash/restart schedule to the engines.  The gateway that holds
        the injector owns its clock: exactly one ``advance`` per pump."""
        if self.injector is None:
            return
        self.injector.advance()
        for r, e in enumerate(self.engines):
            dead = self.injector.crashed(r)
            if dead and not e.crashed:
                e.crash()
            elif not dead and e.crashed:
                e.restart()

    def _check_heartbeats(self) -> None:
        """Beat every live engine on the pump-tick clock, declare the
        silent ones dead, and recover their lost work.  A replica beating
        again after a restart rejoins the monitor here; *readmission* to
        routing stays the interference detector's call (probe samples),
        exactly like a drift quarantine."""
        if self._hb is None:
            return
        now = float(self._pump_count)
        for r, e in enumerate(self.engines):
            if not e.crashed:
                self._hb.beat(r, now)
                if r in self._hb.dead:
                    self._hb.dead.discard(r)
                    self._hb_quarantined.discard(r)
        for r in sorted(self._hb.check(now)):
            if r in self._hb_quarantined:
                continue
            self._hb_quarantined.add(r)
            self._crashes_detected += 1
            self.router.detector.force_quarantine(r)
        # re-run recovery for every dead replica every pump (not just at
        # detection): work that found no healthy home last pump retries
        # until one appears — the scan is O(tracked-on-dead-replicas),
        # which recovery itself drives to zero
        for r in sorted(self._hb_quarantined):
            self._recover_crashed(r)

    def _recover_crashed(self, r: int) -> None:
        """Re-home everything replica ``r`` lost when it crashed.  The
        engine has no volatile state left (queue, parked imports, KV
        cache all gone), so recovery works from the gateway's own
        ledgers: a session with a parked wire snapshot is decoded and
        re-placed on a healthy decode replica — greedy decode then
        regenerates the identical token suffix from the snapshot point —
        and work that never crossed a wire is re-prefilled from scratch
        as a fresh clone of its request.  Either way the stream continues
        on a NEW object: :meth:`handle` points at it, the submitter's
        original stays frozen at its pre-crash state."""
        from ..region.wire import WireFormatError, decode_session
        healthy = [h for h in self.router.healthy()
                   if not self.engines[h].crashed]
        h_decode = [h for h in healthy if h in set(self._decode_ok)]
        h_prefill = [h for h in healthy if h in set(self._prefill_ok)]
        for t in list(self.tracked):
            if t.replica != r or t.req.done:
                continue
            rid = t.req.rid
            snap = self._snapshots.get(rid)
            if snap is not None and h_decode:
                data, _home = snap
                try:
                    sess = decode_session(data)
                except WireFormatError:      # ledger rot: fall through to
                    sess = None              # the re-prefill path
                if sess is not None:
                    dest = None
                    for cand in self.router.fleet.ranked_search(
                            int(RequestClass.DECODE), metric=FleetPTT.TPOT,
                            healthy=h_decode, backlog=self.backlog()):
                        try:
                            self.engines[cand].import_session(sess)
                            dest = cand
                            break
                        except ValueError:
                            continue
                    if dest is not None:
                        t.req = sess.req
                        t.probe = False
                        t.replica = dest
                        self._handles[rid] = sess.req
                        self._per_replica[r] -= 1
                        self._per_replica[dest] += 1
                        self._snapshots[rid] = (data, dest)
                        self._crash_recovered += 1
                        continue
            fits = [h for h in h_prefill
                    if len(t.req.prompt) < self.engines[h].max_seq]
            if not fits:
                continue             # nowhere to go yet: retried next pump
            clone = Request(rid=rid, prompt=t.req.prompt,
                            max_new=t.req.max_new, tenant=t.req.tenant,
                            extras=dict(t.req.extras))
            c = classify_request(len(clone.prompt), clone.max_new)
            dest = self.router.fleet.global_search(
                int(c), metric=FleetPTT.TTFT, healthy=fits,
                backlog=self.backlog(), tokens=len(clone.prompt))
            self.engines[dest].submit(clone)
            t.req = clone
            t.probe = False
            t.replica = dest
            self._handles[rid] = clone
            self._per_replica[r] -= 1
            self._per_replica[dest] += 1
            self._crash_resubmitted += 1

    def _snapshot_session(self, rid: int, data: bytes,
                          replica: int) -> None:
        """Park a session's wire bytes in the crash-recovery ledger.
        Only when heartbeat monitoring is on: without crash detection
        nothing would ever read (or bound) the ledger."""
        if self._hb is None:
            return
        self._snapshots[rid] = (data, replica)

    def _drain_duplicates(self) -> None:
        """Absorb duplicated deliveries a chaos transport queued (the
        retransmission race): decode each copy and drop it against the
        delivery-id registry.  At this tier the synchronous handoff never
        abandons a payload — a failed delivery walks the candidate ladder
        with the session still in hand — so a decodable duplicate is
        always redundant; the dedup count is the exactly-once proof."""
        take = getattr(self.transport, "take_duplicates", None)
        if take is None:
            return
        from ..region.wire import WireFormatError, decode_session
        for _src, _dst, payload in take():
            try:
                sess = decode_session(payload)
            except WireFormatError:
                continue             # corrupt copy: nothing to dedup
            if sess.delivery is not None:
                self._dups_deduped += 1

    # -- pump --------------------------------------------------------------
    def _retry_held(self) -> None:
        """Re-evaluate every held request exactly once.  Entries that stay
        held go into a side list merged back afterwards, so a request that
        just displaced a victim (or was re-queued) is NOT re-processed —
        and not eligible as a displacement victim — within the same pass."""
        adm = self.router.admission
        requeued: list[tuple[Request, int | None, int, float]] = []
        while self.held:
            req, affinity, tries, t_arrival = self.held.popleft()
            d = self.router.route(len(req.prompt), req.max_new,
                                  affinity=affinity, backlog=self.backlog(),
                                  requeue=True,
                                  allowed=self._route_allowed())
            if d.action is Admission.ADMIT and not d.probe:
                adm.reclassify(d.req_class, Admission.QUEUE, Admission.ADMIT)
                self._displaced_rids.discard(req.rid)
                self._dispatch(req, d, t_arrival)
            elif (d.action in (Admission.ADMIT, Admission.QUEUE)
                  and tries < self.MAX_REQUEUES):
                # ADMIT here means probe=True: a held request is never used
                # as a probe — probes pin to their (quarantined) replica,
                # and this request may have just been drained off it
                requeued.append((req, affinity, tries + 1, t_arrival))
            else:
                adm.reclassify(d.req_class, Admission.QUEUE, Admission.SHED)
                if self._shed_or_displace(req, d.req_class):
                    requeued.append((req, affinity, tries + 1, t_arrival))
        self.held.extend(requeued)

    # -- quarantine drain via live migration -------------------------------
    def _tracked_index(self, rid: int) -> int | None:
        for i, t in enumerate(self.tracked):
            if t.req.rid == rid:
                return i
        return None

    def _migration_pays(self, source: int, healthy: Sequence[int],
                        pos: int) -> bool:
        """Charge the router's :class:`MigrationCost` in the drain
        placement: rank the healthy replicas *and the quarantined source
        itself* under ``QueueAware + MigrationCost`` (TPOT metric; the
        source's row keeps training on its inflated drain/probe steps, so
        its cost reflects the interference without any drift hack).  Every
        off-source candidate is charged ``fixed + per_token x pos`` for the
        KV move; staying home is free — so a near-finished session with a
        deep cache stays and drains slowly when no healthy replica wins by
        more than the transfer costs.  Free moves (no MigrationCost
        configured) or an untrained source row always migrate — quarantine
        itself is the evidence the source is slow."""
        mig = self.router.migration
        c = int(RequestClass.DECODE)
        if mig is None or not self.router.fleet.trained(c, source,
                                                        FleetPTT.TPOT):
            return True
        order = self.router.fleet.ranked_search(
            c, metric=FleetPTT.TPOT, healthy=[*healthy, source],
            backlog=self.backlog(), tokens=pos, current=source,
            cost=QueueAware(value_per_token=False) + mig,
            attribution=self.router.attr_hook(
                "migrate-pays", RequestClass.DECODE, source=source, pos=pos))
        return order[0] != source

    def _place_session(self, sess, source: int,
                       healthy: Sequence[int]) -> int | None:
        """Import ``sess`` into the first healthy replica — in the fleet
        PTT's predicted-TPOT cost order (``ranked_search``, the same cost
        routing uses) — whose cache can hold its remaining budget; back
        onto ``source`` when nowhere fits (a near-max_seq session finishes
        where it is).  Returns the destination or None.  No MigrationCost
        enters this ranking: the session is already exported (host numpy),
        so the move is sunk and charges every destination equally — the
        pay-for-the-move decision is :meth:`_migration_pays`, taken
        *before* the export."""
        for dest in self.router.fleet.ranked_search(
                int(RequestClass.DECODE), metric=FleetPTT.TPOT,
                healthy=healthy, backlog=self.backlog(),
                attribution=self.router.attr_hook(
                    "migrate", RequestClass.DECODE, source=source,
                    rid=sess.req.rid)):
            try:
                self.engines[dest].import_session(sess)
                return dest
            except ValueError:
                continue
        self.engines[source].import_session(sess, strict=False)
        return None

    def _migrate_quarantined(self) -> int:
        """Drain every quarantined replica: re-route its queued-but-
        unstarted requests, move its pending session imports, and migrate
        its live decode sessions to the best healthy replica.  Probe
        traffic stays (it carries the recovery signal).  Returns sessions
        migrated this pump."""
        quarantined = sorted(self.router.detector.quarantined)
        if not quarantined:
            return 0
        healthy = self.router.healthy()
        if not healthy:
            return 0                 # nowhere to go: degrade gracefully
        # role split: unstarted requests can only relocate to
        # prefill-capable replicas, live sessions only to decode-capable
        # ones (a prefill-only replica has no decode slots to give)
        h_prefill = [h for h in healthy if h in set(self._prefill_ok)]
        h_decode = [h for h in healthy if h in set(self._decode_ok)]
        moved = 0
        for r in quarantined:
            e = self.engines[r]
            for req in e.drain_queue():
                i = self._tracked_index(req.rid)
                t = self.tracked[i] if i is not None else None
                if t is not None and t.probe:
                    e.submit(req)    # probes stay: recovery signal
                    continue
                # a relocated prompt must fit the destination's cache
                # (heterogeneous max_seq fleets) — a non-fitting dispatch
                # would blow up that engine's next admission
                fits = [h for h in h_prefill
                        if len(req.prompt) < self.engines[h].max_seq]
                if t is None:
                    # not gateway-managed (submitted straight to the
                    # engine): relocate it without touching admission
                    # counters it was never part of
                    if not fits:
                        e.submit(req)            # stays where it fits
                        continue
                    c = classify_request(len(req.prompt), req.max_new)
                    dest = self.router.fleet.global_search(
                        int(c), metric=FleetPTT.TTFT, healthy=fits,
                        backlog=self.backlog(), tokens=len(req.prompt))
                    self.engines[dest].submit(req)
                    continue
                t_arrival = t.t_arrival
                d = self.router.route(len(req.prompt), req.max_new,
                                      backlog=self.backlog(), requeue=True,
                                      allowed=self._route_allowed())
                # the router's overflow may re-pick the replica being
                # drained (its drift-scaled cost still beats every
                # congested healthy queue): honor it — the request stays
                # and is served slowly, instead of ping-ponging
                # queue -> held -> queue forever while the crunch lasts
                if (d.action is Admission.ADMIT and not d.probe
                        and d.replica == r):
                    e.submit(req)
                    continue
                self.tracked.pop(i)
                self._per_replica[r] -= 1        # never actually served here
                # probe decisions are refused here: the probe branch would
                # happily send the evacuated request back to an idle
                # quarantined replica — possibly the one being drained —
                # and pin it there
                if (d.action is Admission.ADMIT and d.replica is not None
                        and not d.probe and d.replica in fits):
                    self._dispatch(req, d, t_arrival)
                elif d.action is Admission.SHED:
                    self.router.admission.reclassify(
                        d.req_class, Admission.ADMIT, Admission.SHED)
                    if self._shed_or_displace(req, d.req_class):
                        self.held.append((req, None, 0, t_arrival))
                else:
                    self.router.admission.reclassify(
                        d.req_class, Admission.ADMIT, Admission.QUEUE)
                    self.held.append((req, None, 0, t_arrival))
            # sessions parked in the import queue must not decode here even
            # once — move them before they get slotted
            for sess in e.drain_sessions():
                i = self._tracked_index(sess.req.rid)
                t = self.tracked[i] if i is not None else None
                if (t is not None and t.probe) or not h_decode:
                    e.import_session(sess)
                    continue
                dest = self._place_session(sess, r, h_decode)
                if dest is not None:
                    if t is not None:            # gateway-managed: move the
                        t.replica = dest         # dispatch credit along
                        self._per_replica[r] -= 1
                        self._per_replica[dest] += 1
                    moved += 1
            for t in list(self.tracked):
                if t.replica != r or t.probe or t.req.done or not h_decode:
                    continue
                pos = e.active_pos(t.req.rid)
                if pos is None:
                    continue         # finished or still queued elsewhere
                # skip the device->host KV round-trip entirely when no
                # healthy replica can hold the remaining budget (the
                # session would only bounce back here every pump)
                remaining = max(t.req.max_new - len(t.req.out_tokens), 0)
                if not any(self.engines[h].can_hold(pos, remaining)
                           for h in h_decode):
                    continue
                # the move must pay for itself: when a MigrationCost is
                # configured and staying home ranks best, skip the export
                # (the session drains slowly where its cache already is)
                if not self._migration_pays(r, h_decode, pos):
                    continue
                sess = e.export_session(t.req.rid)
                dest = self._place_session(sess, r, h_decode)
                if dest is None:
                    continue         # nowhere fits: stays on the source
                t.replica = dest
                self._per_replica[r] -= 1        # credit follows the work
                self._per_replica[dest] += 1
                moved += 1
        self._migrations += moved
        if moved and self._m_migrations is not None:
            self._m_migrations.inc(moved)
        return moved

    # -- prefill -> decode disaggregation ----------------------------------
    def _harvest_ttft(self, t: _Tracked) -> None:
        """Record one tracked request's TTFT (client-facing + PTT/service
        training samples) the first time it has a token.  Idempotent: a
        second call is a no-op.  Called from :meth:`pump`'s harvest loop
        and from :meth:`_handoff` — a disaggregated request's first token
        exists the moment prefill completes, and it must be attributed to
        the *prefill* replica before the tracked entry moves to its decode
        home."""
        if t.ttft is not None or not t.req.out_tokens:
            return
        # the engine stamps first-token time at prefill, so the sample is
        # exact — not inflated by other admissions, the batch decode, or
        # other engines' steps this pump
        tok = (t.req.t_first if t.req.t_first is not None else self.clock())
        t.ttft = tok - t.t_arrival
        if len(self._ttfts) >= self.TTFT_CAP:    # evict oldest
            self._ttfts.pop(next(iter(self._ttfts)))
        self._ttfts[t.req.rid] = t.ttft
        if self._h_ttft is not None:
            self._h_ttft.observe(t.ttft)
        if self.slo is not None:
            if self.slo.wants("ttft"):
                self.slo.observe("ttft", t.ttft)
            p0 = self._arrival_pump.pop(t.req.rid, None)
            if p0 is not None and self.slo.wants("ttft_pumps"):
                self.slo.observe("ttft_pumps",
                                 float(self._pump_count - p0))
        # the learning samples span prefill-start -> first token (the
        # engine stamps t_admit), NOT dispatch -> first token: the
        # engine-queue wait is what QueueAware's backlog term models, so
        # baking it into the TTFT row or the service rate would
        # double-count congestion against busy-but-fast replicas
        # (client-facing TTFT in ``ttfts()`` still includes every wait)
        t0 = t.req.t_admit if t.req.t_admit is not None else t.t_dispatch
        self.router.record_ttft(t.replica, t.req_class, tok - t0,
                                prompt_len=len(t.req.prompt))
        self.router.record_service(t.replica, tok - t0,
                                   req_class=t.req_class)

    def _handoff(self, sess: Session, source: int) -> None:
        """Ship a freshly prefilled session from its prefill-specialized
        replica to the predicted-TPOT-best decode replica.  Fired by the
        prefill engine's ``on_prefill_complete`` hook — the first token is
        already in ``sess.req.out_tokens`` (prefill produced it), so the
        request's TTFT is harvested HERE, against the prefill replica,
        before its tracked entry moves to the decode home.

        The destination is ranked exactly like a quarantine-drain
        placement: ``QueueAware + MigrationCost`` (the router's sticky
        cost) over the decode-capable healthy set, priced on ``sess.pos``
        tokens of KV.  The session crosses the real RSES wire format
        (encode -> bytes -> decode), so the handoff is sized and timed
        like any other migration: ship wall time and payload bytes land in
        :meth:`ttft_breakdown` and the handoff histograms."""
        # lazy import: a region-tier gateway imports this module, so a
        # top-level import of the wire codec would cycle at package init
        from ..region.transport import TransportError
        from ..region.wire import (WireFormatError, decode_session,
                                   encode_session)
        t0 = self.clock()
        i = self._tracked_index(sess.req.rid)
        t = self.tracked[i] if i is not None else None
        if t is not None:
            self._harvest_ttft(t)
        healthy = [h for h in self.router.healthy()
                   if h in set(self._decode_ok)]
        remaining = max(sess.req.max_new - len(sess.req.out_tokens), 0)
        order = self.router.fleet.ranked_search(
            int(RequestClass.DECODE), metric=FleetPTT.TPOT,
            healthy=healthy or self._decode_ok, backlog=self.backlog(),
            tokens=sess.pos, cost=self.router.sticky_cost,
            attribution=self.router.attr_hook(
                "disagg-handoff", RequestClass.DECODE, source=source,
                rid=sess.req.rid))
        order += [r for r in self._decode_ok if r not in order]
        rid = sess.req.rid
        if self.transport is not None:
            # exactly-once stamp: this export's (origin, rid, epoch) rides
            # the wire, so a duplicated delivery of it is recognized by
            # the dedup registry instead of double-adopted
            epoch = self._epoch.get(rid, -1) + 1
            self._epoch[rid] = epoch
            sess.delivery = (source, rid, epoch)
        data = encode_session(sess)
        dest = None
        if self.transport is None:
            shipped = decode_session(data)
            # the cache crossed the real wire encoding (sized, checksummed,
            # compressed) — but this tier is in-process, and callers hold
            # the original Request object, so the decoded copy's handle is
            # swapped back (cross-PROCESS identity via rid-keyed handles is
            # the region tier's job, see RegionGateway.request)
            shipped.req = sess.req
            for cand in order:
                if not self.engines[cand].can_hold(shipped.pos, remaining):
                    continue
                try:
                    self.engines[cand].import_session(shipped)
                except ValueError:
                    continue
                dest = cand
                break
        else:
            # ship through the (possibly chaos-wrapped, possibly reliable)
            # transport.  The import succeeding IS the adoption ACK: the
            # session stays in our hands — parked, never lost — until a
            # candidate adopts it, and each failed delivery walks the
            # degradation ladder to the next ranked candidate (resuming on
            # the source itself is the final rung below)
            for cand in order:
                if not self.engines[cand].can_hold(sess.pos, remaining):
                    continue
                try:
                    delivered, _rtt = self.transport.ship(data, source, cand)
                    shipped = decode_session(delivered)
                except (TransportError, WireFormatError):
                    # the link spent its whole delivery budget (or, with
                    # no reliable layer, delivered corrupt bytes): re-rank
                    # the next candidate with the payload still in hand
                    self._delivery_failures += 1
                    if self.tracer.enabled:
                        self.tracer.instant(
                            "handoff-delivery-failed",
                            self.tracer.trace_for(rid), self.obs_name,
                            source=source, dest=cand)
                    continue
                shipped.req = sess.req       # in-process tier: same handle
                try:
                    self.engines[cand].import_session(shipped)
                except ValueError:
                    continue
                if shipped.delivery is not None:
                    self._delivered.add(tuple(shipped.delivery))
                dest = cand
                break
        if dest is None:
            # nowhere decode-capable fits: finish where it was born — a
            # prefill-role engine still decodes correctly, it just isn't
            # supposed to be good at it
            self.engines[source].import_session(sess, strict=False)
            dest = source
        self._snapshot_session(rid, data, dest)
        ship = self.clock() - t0
        if t is not None:
            self._per_replica[t.replica] -= 1    # credit follows the work
            self._per_replica[dest] += 1
            t.replica = dest
            t.t_handoff = self.clock()
        self._handoffs += 1
        req = sess.req
        bd = {"prefill_s": None, "ship_s": ship, "first_decode_s": None,
              "source": source, "dest": dest, "nbytes": len(data)}
        if req.t_first is not None and req.t_admit is not None:
            bd["prefill_s"] = req.t_first - req.t_admit
        if len(self._breakdown) >= self.TTFT_CAP:
            self._breakdown.pop(next(iter(self._breakdown)))
        self._breakdown[req.rid] = bd
        if self._m_handoffs is not None:
            self._m_handoffs.inc()
            self._h_handoff.observe(ship)
            self._h_handoff_bytes.observe(float(len(data)))
        if self.tracer.enabled:
            tr = self.tracer.trace_for(req.rid)
            if tr is not None:
                self.tracer.complete(
                    "disagg-ship", tr, self.obs_name, ts=t0, dur=ship,
                    source=source, dest=dest, nbytes=len(data),
                    tokens=sess.pos)

    def ttft_breakdown(self) -> dict[int, dict]:
        """Per-rid TTFT attribution for disaggregated requests:
        ``{prefill_s, ship_s, first_decode_s, source, dest, nbytes}``.
        ``first_decode_s`` is stamped at pump granularity when the first
        decode-produced token (the request's *second* token) appears;
        ``None`` until then."""
        return {rid: dict(bd) for rid, bd in self._breakdown.items()}

    # -- region-tier export hooks ------------------------------------------
    # A RegionGateway draining a browned-out fleet pulls work out through
    # these instead of reaching into engines: unstarted requests re-route
    # as plain Requests, live sessions are enumerated (so the region tier
    # can decide per session whether the WAN move pays before any export
    # happens) and exported one by one for wire transport.

    def _untrack(self, rid: int) -> None:
        i = self._tracked_index(rid)
        if i is not None:
            t = self.tracked.pop(i)
            self._per_replica[t.replica] -= 1    # never served here

    def drain_unstarted(self) -> list[Request]:
        """Remove every queued-but-unstarted request from this fleet —
        engine queues and the gateway hold queue — for cross-fleet
        re-routing (no cache state exists yet, so no wire format is
        needed)."""
        out: list[Request] = []
        for e in self.engines:
            for req in e.drain_queue():
                if self._tracked_index(req.rid) is not None:
                    # dispatched here but never served: its ADMIT count
                    # moves to SHED — "this fleet gave it up" (the region
                    # tier re-homes it through another fleet's admission)
                    self._untrack(req.rid)
                    self.router.admission.reclassify(
                        classify_request(len(req.prompt), req.max_new),
                        Admission.ADMIT, Admission.SHED)
                out.append(req)
        while self.held:
            req, _, _, _ = self.held.popleft()
            self.router.admission.reclassify(
                classify_request(len(req.prompt), req.max_new),
                Admission.QUEUE, Admission.SHED)
            self._displaced_rids.discard(req.rid)
            out.append(req)
        return out

    def drain_parked_sessions(self) -> list[Session]:
        """Remove imported-but-not-yet-slotted sessions (already host-numpy
        — the export is sunk, so the region tier ships them regardless of
        stay-home economics)."""
        out: list[Session] = []
        for e in self.engines:
            for sess in e.drain_sessions():
                self._untrack(sess.req.rid)
                out.append(sess)
        return out

    def live_sessions(self) -> list[tuple[int, int, int]]:
        """``(rid, pos, remaining)`` for every live decode slot — lets a
        drain planner rank destinations and skip no-win exports without
        paying any device->host round trip."""
        out = []
        for e in self.engines:
            for req in e.active:
                if req is None or req.done:
                    continue
                pos = e.active_pos(req.rid)
                if pos is None:
                    continue
                remaining = max(req.max_new - len(req.out_tokens), 0)
                out.append((req.rid, pos, remaining))
        return out

    def export_for_region(self, rid: int) -> Session:
        """Freeze one live session for cross-fleet transport and drop its
        local bookkeeping (the region tier owns it from here).  Raises
        KeyError if ``rid`` is not active on any engine."""
        for e in self.engines:
            if e.active_pos(rid) is not None:
                sess = e.export_session(rid)
                self._untrack(rid)
                return sess
        raise KeyError(f"rid {rid} is not active on this fleet")

    def can_hold(self, pos: int, remaining: int) -> bool:
        """Whether any *decode-capable* replica in this fleet can finish a
        session at ``pos`` with ``remaining`` tokens without truncation —
        prefill-specialized replicas never host decode sessions, so they
        don't count toward feasibility."""
        return any(self.engines[i].can_hold(pos, remaining)
                   for i in self._decode_ok)

    def adopt_session(self, sess: Session) -> int:
        """Accept a session migrated in from another fleet: place it on
        the predicted-TPOT-best replica whose cache holds its remaining
        budget, and track it for serving stats.  Healthy replicas are
        preferred, but a fitting quarantined one is used before giving up
        — the feasibility pre-check other fleets run (:meth:`can_hold`)
        spans ALL replicas, and a session that already crossed the WAN
        must not be dropped because its only fitting host is slow.  The
        TTFT was produced (and recorded) wherever the session was born,
        so no TTFT sample is harvested here.  Adoption is idempotent on
        the session's wire delivery id: a duplicated or retried delivery
        of an already-adopted session raises ``DuplicateDelivery``
        (exactly-once's receiver half).  Returns the replica; raises
        ValueError when no replica fits."""
        did = (tuple(sess.delivery) if sess.delivery is not None else None)
        if did is not None and did in self._delivered:
            self._dups_deduped += 1
            raise DuplicateDelivery(
                f"delivery {did} was already adopted by this fleet")
        remaining = max(sess.req.max_new - len(sess.req.out_tokens), 0)
        # decode-capable hosts only: a prefill-specialized replica has no
        # decode slots, so a WAN-shipped session must never rank onto one
        healthy = [h for h in self.router.healthy()
                   if h in set(self._decode_ok)]
        ranked = self.router.fleet.ranked_search(
            int(RequestClass.DECODE), metric=FleetPTT.TPOT,
            healthy=healthy or self._decode_ok, backlog=self.backlog())
        ranked += [r for r in self._decode_ok if r not in ranked]
        for dest in ranked:
            if not self.engines[dest].can_hold(sess.pos, remaining):
                continue
            self.engines[dest].import_session(sess)
            now = self.clock()
            self.tracked.append(_Tracked(
                req=sess.req, replica=dest,
                req_class=int(RequestClass.DECODE), t_arrival=now,
                t_dispatch=now, ttft=0.0))   # pre-harvested: first token
                                             # belongs to the origin fleet
            self._per_replica[dest] += 1
            if did is not None:
                self._delivered.add(did)
            if len(self._handles) >= self.TTFT_CAP:
                self._handles.pop(next(iter(self._handles)))
            self._handles[sess.req.rid] = sess.req
            if self._hb is not None:
                # crash-recovery ledger: re-encode the adopted session so
                # a crash of `dest` can re-place it from this snapshot
                from ..region.wire import encode_session
                self._snapshots[sess.req.rid] = (encode_session(sess), dest)
            return dest
        raise ValueError("no replica in this fleet can hold the session")

    def pump(self) -> int:
        """One gateway iteration: apply scheduled faults, check
        heartbeats (recovering crashed replicas' work), retry queued,
        drain quarantined replicas, step every engine, harvest TTFTs.
        Returns the number of sequences still active fleet-wide."""
        self._pump_count += 1
        if self.tracer.enabled:
            self.tracer.set_tick(self._pump_count)
        self._apply_faults()
        self._check_heartbeats()
        self._drain_duplicates()
        self._retry_held()
        self._migrate_quarantined()
        want_tpot = self.slo is not None and self.slo.wants("tpot")
        active = 0
        for e in self.engines:
            a = e.step()
            active += a
            if want_tpot and a and e.last_step_latency > 0:
                self.slo.observe("tpot", e.last_step_latency)
        in_flight = []
        for t in self.tracked:
            self._harvest_ttft(t)
            if (t.t_handoff is not None and t.first_decode is None
                    and len(t.req.out_tokens) >= 2):
                # the first decode-produced token after a disaggregated
                # handoff (the prefill token is out_tokens[0]) — pump
                # granularity, which is also the client's visibility
                t.first_decode = self.clock()
                bd = self._breakdown.get(t.req.rid)
                if bd is not None:
                    bd["first_decode_s"] = t.first_decode - t.t_handoff
            if t.req.done and t.ttft is not None:
                self._served += 1       # finished: stop tracking it
                self._snapshots.pop(t.req.rid, None)
                if self._m_served is not None:
                    self._m_served.inc()
                if self.slo is not None:
                    self.slo.observe_ok("availability", True)
            else:
                in_flight.append(t)
        self.tracked = in_flight
        self._sample_obs()
        return active

    def run_until_drained(self, max_steps: int = 10000) -> None:
        for _ in range(max_steps):
            if (self.pump() == 0 and not self.held
                    and not any(e.pending() for e in self.engines)):
                return

    # -- results -----------------------------------------------------------
    def ttfts(self) -> dict[int, float]:
        return dict(self._ttfts)

    def stats(self) -> dict:
        s = self.router.stats()
        # unified cross-scale counters (repro_torch.obs.CANONICAL_STATS) —
        # "served"/"migrations" remain as legacy aliases
        s["requests_served"] = self._served
        s["requests_shed"] = self.shed_total
        s["sessions_migrated"] = self._migrations
        s["queue_depth"] = (len(self.held)
                            + sum(e.pending() for e in self.engines))
        s["served"] = self._served
        s["migrations"] = self._migrations
        s["roles"] = list(self.roles)
        s["prefill_handoffs"] = self._handoffs
        s["delivery_failures"] = self._delivery_failures
        s["duplicates_deduped"] = self._dups_deduped
        s["crashes_detected"] = self._crashes_detected
        s["crash_sessions_recovered"] = self._crash_recovered
        s["crash_requests_resubmitted"] = self._crash_resubmitted
        s["shed_requests"] = [r.rid for r in self.shed]
        s["tenant_shed_debt"] = dict(self._tenant_debt)
        s["per_replica"] = list(self._per_replica)
        s["utilization"] = [round(e.utilization(), 3) for e in self.engines]
        s["step_latency"] = [e.last_step_latency for e in self.engines]
        return s
