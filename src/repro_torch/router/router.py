"""FleetRouter — PTT-driven routing decisions across serving replicas.

The paper's critical/non-critical split, one level above the pod:

* **TTFT-critical** requests (prefill classes) search the FleetPTT globally
  over the healthy replica set for minimum predicted TTFT;
* **decode-heavy** requests stick to their affinity replica (a session's
  previous home) unless it is quarantined or another replica is decisively
  faster — migration avoidance, exactly the paper's local search;
* quarantined replicas receive occasional **probe** traffic so their PTT
  rows (and the detector's fast EMA) keep training — the fleet analogue of
  "non-critical tasks keep training the PTT on interfered cores" (Fig. 8)
  — and are re-admitted when the fast EMA recovers;
* the admission controller sheds or queues per class when the predicted
  TTFT blows the class SLO.

This is the PyTorch port's copy of ``repro.router.router``: host-side
Python and numpy, the same logic; only the imports differ.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..core.tracetable import CostModel, Latency, MigrationCost, QueueAware
from ..obs import NULL_TRACER
from ..serve.scheduler import RequestClass, classify_request
from .admission import Admission, AdmissionController, SLOPolicy
from .fleet_ptt import FleetPTT
from .interference import InterferenceConfig, InterferenceDetector


@dataclasses.dataclass
class RouteDecision:
    replica: int | None              # None iff action is SHED/QUEUE
    req_class: RequestClass
    action: Admission
    predicted_ttft: float
    predicted_tpot: float = 0.0
    probe: bool = False              # sacrificial probe of a quarantined
                                     # replica (bypasses admission)


class FleetRouter:
    def __init__(self, num_replicas: int, slo: SLOPolicy | None = None,
                 interference: InterferenceConfig | None = None,
                 probe_every: int = 4, cost: CostModel | None = None,
                 migration: MigrationCost | None = None,
                 attribution=None):
        """``cost``: the objective for critical (global) searches — default
        :class:`QueueAware` (learned per-replica service rates once
        ``record_service`` samples arrive, count inflation until then).
        ``migration``: when given, sticky searches charge this KV-transfer
        estimate on top of the latency objective, so a decode-heavy
        follow-up only leaves its affinity replica when the win pays for
        the cache move.  ``attribution``: an optional
        :class:`~repro_torch.obs.DecisionLog` — every PTT search this router (or
        its gateway, via :meth:`attr_hook`) performs lands there with the
        per-candidate cost breakdown and a table-row snapshot."""
        self.fleet = FleetPTT(num_replicas, num_classes=len(RequestClass))
        self.detector = InterferenceDetector(
            num_replicas, interference or InterferenceConfig())
        self.admission = AdmissionController(slo)
        self.probe_every = probe_every
        self.cost = cost if cost is not None else QueueAware()
        # sticky reads the TPOT row (absolute per-step latency, not
        # per-token), so the value is not scaled by request size — but
        # ctx.tokens still carries the session size for the migration term.
        # The gateway also charges `migration` in its quarantine-drain
        # placement (a session only leaves a drained replica when the win
        # pays for the KV move)
        self.migration = migration
        sticky = QueueAware(value_per_token=False)
        self.sticky_cost = sticky + migration if migration is not None \
            else sticky
        self._probe_rr = 0
        self._since_probe = 0   # requests routed while something was
                                # quarantined since the last probe fired
        # healthy-era service rate snapshot per quarantined replica: the
        # decay target is anchor x drift (decaying the live row by the
        # ratio every sample would compound without bound)
        self._svc_anchor: dict[int, float] = {}
        # chunked-prefill wall-time EMA per replica: its own signal,
        # deliberately OUTSIDE the interference detector (see
        # record_prefill_chunk)
        self._prefill_chunk_ema: dict[int, float] = {}
        self.attribution = attribution
        self.tracer = NULL_TRACER
        self.metrics = None
        self.obs_name = "fleet"

    # -- observability -----------------------------------------------------
    def attach_obs(self, tracer=None, metrics=None,
                   name: str | None = None) -> None:
        """Attach a :class:`~repro_torch.obs.SpanTracer` and/or
        :class:`~repro_torch.obs.MetricRegistry`.  Detector state flips
        (quarantine/readmit) become instant events on the
        ``{name}/detector`` track and tick
        ``fleet_quarantine_transitions_total``."""
        if name is not None:
            self.obs_name = name
        if tracer is not None:
            self.tracer = tracer
        if metrics is not None:
            self.metrics = metrics

    def _note_flip(self, flip: str, replica: int) -> None:
        if self.tracer.enabled:
            self.tracer.instant(
                flip, trace=f"{self.obs_name}/detector",
                track=f"{self.obs_name}/detector", replica=replica,
                drift=round(self.detector.drift(replica), 3))
        if self.metrics is not None:
            self.metrics.counter(
                "fleet_quarantine_transitions_total",
                "InterferenceDetector quarantine/readmit state flips",
                fleet=self.obs_name, event=flip).inc()

    def _rows_fn(self, c: RequestClass):
        """A ``rows_fn`` for :meth:`~repro_torch.obs.DecisionLog.hook`: per
        candidate replica, the evidence the costs were computed from —
        TTFT/TPOT EMA rows (+ trained mask), learned service rate, live
        drift ratio, quarantine state."""
        def rows(sa) -> dict:
            out = {}
            for cand in sa.candidates:
                r = cand.item
                out[r] = {
                    "ttft": self.fleet.value(int(c), r, FleetPTT.TTFT),
                    "tpot": self.fleet.value(int(RequestClass.DECODE), r,
                                             FleetPTT.TPOT),
                    "trained": self.fleet.trained(int(c), r, FleetPTT.TTFT),
                    "service": self.fleet.service_time(r),
                    "drift": round(self.detector.drift(r), 4),
                    "quarantined": r in self.detector.quarantined,
                }
            return out
        return rows

    def attr_hook(self, kind: str, req_class: RequestClass, **meta):
        """An ``attribution=`` callable for one :class:`FleetPTT` search
        recording into this router's :class:`~repro_torch.obs.DecisionLog` (None
        when no log is attached) — the gateway uses this for its migration
        placement searches so they carry the same row snapshots as routing
        decisions."""
        if self.attribution is None:
            return None
        return self.attribution.hook(kind, self._rows_fn(req_class),
                                     req_class=req_class.name, **meta)

    # -- routing -----------------------------------------------------------
    def route(self, prompt_len: int, max_new: int,
              affinity: int | None = None,
              backlog: Sequence[int] | None = None,
              requeue: bool = False,
              allowed: Sequence[int] | None = None) -> RouteDecision:
        """Pick a replica for one request.  ``backlog``: per-replica count
        of requests already queued/active (from ``ServeEngine.pending()``);
        used to inflate the predicted TTFT for admission.  ``requeue``:
        re-evaluation of an already-QUEUE-counted request — the admission
        outcome is computed without incrementing the counters (the gateway
        reclassifies on outcome change).  ``allowed``: restrict candidates
        to this replica subset (role-specialized fleets: a fresh request
        may only land on a prefill-capable replica).  Quarantine still
        filters within the subset; when every allowed replica is
        quarantined the search degrades to the allowed set itself — a
        capable-but-slow replica beats an incapable one."""
        c = classify_request(prompt_len, max_new)
        healthy = self.detector.healthy()
        quarantined = sorted(self.detector.quarantined)
        if allowed is not None:
            aset = set(allowed)
            healthy = [r for r in healthy if r in aset]
            quarantined = [r for r in quarantined if r in aset]
            if not healthy and not quarantined:
                # nothing allowed is even quarantined (empty subset):
                # caller misconfiguration — fail loudly, don't misroute
                raise ValueError("allowed replica set is empty")
            if affinity is not None and affinity not in aset:
                affinity = None
        # search pool: healthy candidates, degrading to "everything" when
        # all replicas are quarantined — but a role restriction must degrade
        # to its own (quarantined) subset, never escape to incapable hosts
        pool = healthy or None
        if allowed is not None and not healthy:
            pool = quarantined

        # probe: an occasional request visits a quarantined replica so it
        # can prove recovery — a drained quarantined replica emits no
        # decode steps, so without probes nothing would ever feed its fast
        # EMA and it would be excluded forever.  Probes prefer DECODE
        # traffic (a 64-token follow-up sacrificed to a 4x straggler costs
        # milliseconds; a 4k prefill costs nearly a second of p99):
        # non-critical requests probe once ``probe_every`` requests have
        # passed since the last probe, and TTFT-critical classes step in
        # only after a long decode drought (16x cadence — a prefill-only
        # workload must still be able to recover capacity, but it must not
        # burn big prompts while cheap probes are flowing).
        # When ``backlog`` is provided (gateway/sim), only *idle* (drained)
        # quarantined replicas are probed: at most one outstanding probe
        # each, so the straggler is never re-loaded while it is still
        # slow.  A backlog-less caller probes unconditionally — it has no
        # queue visibility, and never probing would strand its capacity.
        # The drought counter only runs while something is quarantined —
        # otherwise healthy-era traffic would bank enough drought for the
        # first post-quarantine request (possibly a 4k prefill) to probe
        # instantly.
        self._since_probe = self._since_probe + 1 if quarantined else 0
        cadence = (self.probe_every if c == RequestClass.DECODE
                   else self.probe_every * 16)
        if quarantined and self._since_probe >= cadence:
            idle = [r for r in quarantined
                    if backlog is None or backlog[r] == 0]
            if idle:
                r = idle[self._probe_rr % len(idle)]
                self._probe_rr += 1
                self._since_probe = 0
                if not requeue:      # requeue'd: gateway reclassifies
                    self.admission.count(c, Admission.ADMIT)
                return RouteDecision(replica=r, req_class=c,
                                     action=Admission.ADMIT,
                                     predicted_ttft=0.0, probe=True)

        # decision attribution: one record per search, annotated after the
        # fact with the final (post-overflow, post-admission) outcome —
        # recbox holds the record the hook appended so we can reach it
        rec = None
        attrib = None
        if self.attribution is not None:
            base = self.attr_hook("route", c, affinity=affinity)
            recbox: list = []
            attrib = lambda sa: recbox.append(base(sa))  # noqa: E731

        pred_overflow = None     # set when overflow picks a quarantined
                                 # replica (drift-scaled prediction)
        if c == RequestClass.DECODE:
            if affinity is not None:
                # sticky: queue-aware (a follow-up abandons a congested
                # home when another replica decisively wins); the
                # migration term (when configured) charges the KV/prefix
                # re-ingest the move would cost
                r = self.fleet.sticky_search(c, affinity,
                                             healthy=pool,
                                             backlog=backlog,
                                             tokens=prompt_len,
                                             cost=self.sticky_cost,
                                             attribution=attrib)
            else:
                r = self.fleet.global_search(c, metric=FleetPTT.TPOT,
                                             healthy=pool,
                                             backlog=backlog,
                                             cost=self.cost,
                                             attribution=attrib)
        else:
            # all replicas quarantined: degrade gracefully, route anyway
            r = self.fleet.global_search(c, metric=FleetPTT.TTFT,
                                         healthy=pool,
                                         backlog=backlog, tokens=prompt_len,
                                         cost=self.cost,
                                         attribution=attrib)
            if quarantined and backlog is not None:
                r, pred_overflow = self._overflow(c, r, quarantined, backlog,
                                                  prompt_len)
        if attrib is not None and recbox:
            rec = recbox[-1]
        if pred_overflow is not None:
            pred = pred_overflow        # drift-scaled: the raw row would
                                        # understate a straggler's TTFT to
                                        # admission by the drift factor
        else:
            pred = self.fleet.predict_ttft(c, r, backlog[r] if backlog else 0,
                                           tokens=prompt_len)
        # TPOT budget: the replica's decode-step latency row (0.0 when
        # untrained — optimistic, like the TTFT bootstrap); an overflow
        # pick is drift-scaled like its TTFT — the row is healthy-era
        pred_tpot = self.fleet.value(int(RequestClass.DECODE), r,
                                     FleetPTT.TPOT)
        if pred_overflow is not None:
            pred_tpot *= max(self.detector.drift(r), 1.0)
        action = (self.admission.evaluate(c, pred, pred_tpot) if requeue
                  else self.admission.decide(c, pred, pred_tpot))
        if rec is not None:
            rec.meta.update(replica=r, action=action.name,
                            overflow=pred_overflow is not None,
                            predicted_ttft=pred)
        return RouteDecision(
            replica=r if action is Admission.ADMIT else None,
            req_class=c, action=action, predicted_ttft=pred,
            predicted_tpot=pred_tpot)

    def _overflow(self, c, best: int, quarantined, backlog,
                  prompt_len: int) -> tuple[int, float | None]:
        """Quarantine costs capacity: under crunch, a quarantined replica
        whose predicted TTFT — its learned rows scaled by the detector's
        live drift ratio (Fig. 8's interference signal as a multiplier) —
        *strictly* beats the best healthy prediction takes the request.
        The paper's slow core keeps serving cheap work instead of idling;
        a 512-token prefill eats a 4x straggler penalty happily when every
        healthy queue holds seconds of 4k prefills.  Untrained quarantined
        rows never win (no evidence -> probes only).  Returns the chosen
        replica and, when it is a quarantined one, its drift-scaled
        prediction (the raw row would understate the TTFT admission sees
        by the drift factor); (best, None) otherwise."""
        pred_best = self.fleet.predict_ttft(int(c), best, backlog[best],
                                            tokens=prompt_len)
        if pred_best <= 0.0:
            return best, None                # bootstrap: stay on healthy
        pick, pick_pred = best, pred_best
        for q in quarantined:
            if not (self.fleet.trained(int(c), q, FleetPTT.TTFT)
                    and self.fleet.service_time(q) > 0.0):
                continue
            # the healthy-era TTFT row is scaled by the live drift ratio;
            # the wait term is NOT — the stored service rate decays toward
            # drift x anchor while quarantined, so scaling it again here
            # would double-charge the queue.  Tick the decay from here too:
            # a fully drained replica emits no step samples, and a frozen
            # healthy-era rate would understate its wait by the drift
            # factor exactly when overflow is deciding whether to load it
            self._decay_quarantined_service(q)
            drift = max(self.detector.drift(q), 1.0)
            p = self.fleet.predict_ttft(int(c), q, backlog[q],
                                        tokens=prompt_len, value_scale=drift)
            if p < pick_pred:
                pick, pick_pred = q, p
        return pick, (pick_pred if pick != best else None)

    # -- feedback ----------------------------------------------------------
    def record_ttft(self, replica: int, req_class: RequestClass,
                    ttft: float, *, prompt_len: int) -> None:
        """Observed time-to-first-token of a request served on ``replica``,
        measured from dispatch (client-facing arrival-based TTFT is the
        gateway's metric; the table needs the dispatch-based figure so
        ``predict_ttft``'s backlog term doesn't double-count queueing).

        The sample is stored **per prompt token** (size-normalized): one
        class row mixes prompt sizes — a run of 4k prefills would otherwise
        make the row predict 4k-latencies for 512-token requests (and the
        global search would chase prompt-size noise instead of replica
        speed).  ``prompt_len`` is keyword-required so a caller recording
        an absolute TTFT with the old arity fails loudly instead of
        silently poisoning the per-token row."""
        self.fleet.update(int(req_class), replica, FleetPTT.TTFT,
                          ttft / max(prompt_len, 1))

    def record_step(self, replica: int, latency: float) -> None:
        """Engine decode-step latency (normalized per token by the engine):
        trains the TPOT row and is the homogeneous per-replica signal the
        interference detector watches.  While the replica is quarantined,
        each sample also *decays* its stored service rate toward
        ``healthy-era anchor x live drift`` — completions stop flowing off
        a drained replica, so without this the rate would stay frozen at
        its healthy value and every read would have to re-scale it by the
        drift (the old read-time hack)."""
        self.fleet.update(int(RequestClass.DECODE), replica, FleetPTT.TPOT,
                          latency)
        flip = self.detector.observe(replica, latency)
        if flip is not None:
            self._note_flip(flip, replica)
        if replica in self.detector.quarantined:
            self._decay_quarantined_service(replica)
        else:
            # re-admitted (possibly by this very sample): stop decaying and
            # let real completion samples re-train the row
            self._svc_anchor.pop(replica, None)

    def record_prefill_chunk(self, replica: int, latency: float) -> None:
        """Chunked-prefill wall time on ``replica`` — a *separate* signal
        from decode steps.  It is never fed to the interference detector:
        a long prompt's chunks admitted mid-decode are legitimately slower
        than decode steps, and mixing them into the homogeneous per-step
        signal would read as a latency spike and quarantine a healthy
        replica.  Trains a per-replica EMA (``stats()``) and the
        ``fleet_prefill_chunk_seconds`` histogram when metrics are
        attached."""
        old = self._prefill_chunk_ema.get(replica)
        self._prefill_chunk_ema[replica] = (
            latency if old is None else (4.0 * old + latency) / 5.0)
        if self.metrics is not None:
            self.metrics.histogram(
                "fleet_prefill_chunk_seconds",
                "Chunked-prefill wall time per chunk (role-split signal)",
                fleet=self.obs_name, replica=replica).observe(latency)

    def _decay_quarantined_service(self, replica: int) -> None:
        """One bounded decay tick for a quarantined replica's service rate:
        EMA toward ``healthy-era anchor x live drift`` (the anchor is
        snapshotted at the first tick; decaying the live row by the ratio
        each tick would compound without bound).  Ticked from step samples
        AND from overflow reads, so a drained-idle replica's rate freshens
        the moment anything asks about it."""
        anchor = self._svc_anchor.setdefault(
            replica, self.fleet.service_time(replica))
        if anchor > 0.0:
            self.fleet.decay_service(
                replica, anchor * max(self.detector.drift(replica), 1.0))

    def record_service(self, replica: int, seconds: float, *,
                       units: int = 1,
                       req_class: int | None = None) -> None:
        """One request's wall service time on ``replica`` — trains the
        per-replica service rate the :class:`QueueAware` cost turns
        backlog into predicted *seconds of wait* with (the lever that
        separates PTT routing from join-shortest-queue).  ``units`` is the
        request's size in whatever unit the caller's ``backlog`` uses
        (1 = whole requests; prompt tokens when the backlog is
        token-weighted).  ``req_class`` additionally trains the per-class
        split rate (mixed queues are priced per class by callers passing
        class-resolved backlogs)."""
        self.fleet.record_service(replica, seconds, units=units,
                                  req_class=req_class)

    # -- views -------------------------------------------------------------
    def healthy(self) -> list[int]:
        return self.detector.healthy()

    def stats(self) -> dict:
        n = self.fleet.num_replicas
        return {"admission": self.admission.counts(),
                "quarantined": sorted(self.detector.quarantined),
                "events": list(self.detector.events),
                "drift": [round(self.detector.drift(r), 3)
                          for r in range(n)],
                "prefill_chunk_ema": dict(self._prefill_chunk_ema),
                "ptt_updates": self.fleet.updates}
