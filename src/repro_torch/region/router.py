"""RegionRouter — the Performance Trace Table at its fourth scale; the
port's copy of ``repro/region/router.py`` (host-side, no torch), whose
decisions equal the JAX router's on the same records.

Cores -> device groups -> serving replicas -> **whole fleets across WAN
regions**. The table machinery is unchanged — a
:class:`~repro_torch.router.FleetPTT` whose "replica" axis indexes fleets — but
the objective gains a term no intra-datacenter scale has: placing work away
from where its bytes live costs a WAN round trip plus egress.
:class:`~repro_torch.core.tracetable.WanCost` charges exactly that, off a
*link-keyed* :class:`~repro_torch.core.tracetable.TraceTable` of EMA'd per-link
RTTs that trains from observed transfers the same way every other row in the
system trains from observed latencies (paper §3.2, applied to links).

Routing objectives:

* fresh requests: ``QueueAware + WanCost`` global search — stay in the
  ingress region unless another fleet's predicted completion beats the
  home fleet *by more than the hop costs*;
* chatty decode follow-ups: sticky search under
  ``QueueAware + WanCost (+ MigrationCost)`` — the session's KV lives at
  its affinity fleet, so leaving home must pay for RTT, egress, and the
  cache re-ingest;
* brownout drains: :meth:`drain_rank` ranks the healthy fleets *and the
  browned-out source itself* under the same composed cost, so a session
  whose WAN move doesn't pay stays home and drains slowly (the caller
  skips the export entirely).

Backlogs at this scale are class-resolved (``{req_class: count}`` per fleet,
from :meth:`~repro_torch.router.FleetGateway.class_backlog`): a fleet queueing
short interactive prefills drains far faster than one queueing the same count
of decode-heavy turns, and the per-class service rates price that difference.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Sequence

from ..core.tracetable import (Candidate, MigrationCost, QueueAware,
                               SearchContext, TraceTable, WanCost)
from ..router.fleet_ptt import FleetPTT
from ..serve.scheduler import RequestClass, classify_request


@dataclasses.dataclass
class RegionDecision:
    fleet: int
    req_class: RequestClass
    predicted: float             # predicted TTFT incl. the WAN hop charge
    wan_hop: bool                # placement left the origin region


class RegionRouter:
    def __init__(self, num_fleets: int, *,
                 egress_per_byte: float = 0.0,
                 bytes_per_token: float = 0.0,
                 migration: MigrationCost | None = None,
                 migrate_ratio: float = 2.0,
                 rtt_halflife_s: float = 0.0,
                 attribution=None):
        """``egress_per_byte`` x ``bytes_per_token`` is the per-token
        charge for shipping state over a link (0.0 = RTT-only WAN model);
        ``migration`` additionally charges the destination-side cache
        re-ingest on sticky/drain moves.  ``rtt_halflife_s`` enables
        time-based RTT row aging (:meth:`age_links`): a link row that has
        not seen a delivery for a halflife decays toward the trained-link
        prior (0.0 = rows never age, the pre-aging behavior).
        ``attribution``: an optional :class:`~repro_torch.obs.DecisionLog` —
        every placement and drain-rank search lands there with its
        per-candidate WanCost/QueueAware/... breakdown and a fleet-row
        snapshot."""
        if num_fleets < 1:
            raise ValueError("need at least one fleet")
        self.num_fleets = num_fleets
        self.table = FleetPTT(num_fleets, num_classes=len(RequestClass))
        # link-keyed axes: (src fleet, dst fleet) -> EMA'd RTT seconds
        self.links = TraceTable((num_fleets, num_fleets), metrics=("rtt",))
        self.rtt_halflife_s = float(rtt_halflife_s)
        # per-link freshness: (src, dst) -> (last-delivery stamp, row value
        # right after that delivery).  The anchor makes aging idempotent:
        # each pass recomputes decay from the anchored value, so repeated
        # age_links() calls at the same `now` agree instead of compounding
        self._link_fresh: dict[tuple[int, int], tuple[float, float]] = {}
        self._rtt_decays = 0
        self.wan = WanCost(self.links, egress_per_byte=egress_per_byte,
                           bytes_per_token=bytes_per_token)
        self.migration = migration
        self.migrate_ratio = migrate_ratio
        self.cost = QueueAware() + self.wan
        sticky = QueueAware(value_per_token=False) + self.wan
        self.sticky_cost = (sticky + migration if migration is not None
                            else sticky)
        self.browned_out: set[int] = set()
        self.attribution = attribution

    # -- observability -----------------------------------------------------
    def _rows_fn(self, c: RequestClass):
        """Per-candidate fleet evidence for a decision record: TTFT/TPOT
        EMA rows, learned service rate, brownout state."""
        def rows(sa) -> dict:
            out = {}
            for cand in sa.candidates:
                f = cand.item
                out[f] = {
                    "ttft": self.table.value(int(c), f, FleetPTT.TTFT),
                    "tpot": self.table.value(int(RequestClass.DECODE), f,
                                             FleetPTT.TPOT),
                    "trained": self.table.trained(int(c), f, FleetPTT.TTFT),
                    "service": self.table.service_time(f),
                    "browned_out": f in self.browned_out,
                }
            return out
        return rows

    def _attr_hook(self, kind: str, c: RequestClass, **meta):
        if self.attribution is None:
            return None
        return self.attribution.hook(kind, self._rows_fn(c),
                                     req_class=c.name, **meta)

    # -- brownout state ----------------------------------------------------
    def brownout(self, fleet: int) -> None:
        """Take a whole fleet out of rotation (region-wide incident:
        power/cooling brownout, upstream network cut, bad rollout)."""
        self.browned_out.add(fleet)

    def restore(self, fleet: int) -> None:
        self.browned_out.discard(fleet)

    def healthy(self) -> list[int]:
        return [f for f in range(self.num_fleets)
                if f not in self.browned_out]

    # -- routing -----------------------------------------------------------
    def route(self, prompt_len: int, max_new: int, *, origin: int,
              affinity: int | None = None,
              backlog: Sequence[int | Mapping] | None = None
              ) -> RegionDecision:
        """Place one request.  ``origin`` is the region it entered at
        (where its prompt bytes are); ``affinity`` a previous decode
        session's home fleet.  All fleets browned out degrades gracefully:
        the search runs over the full set (serving slowly beats serving
        nowhere)."""
        c = classify_request(prompt_len, max_new)
        healthy = self.healthy() or None
        if (c == RequestClass.DECODE and affinity is not None
                and affinity not in self.browned_out):
            home = affinity          # the session's KV lives there
            f = self.table.sticky_search(
                c, home, healthy=healthy, backlog=backlog,
                tokens=prompt_len, cost=self.sticky_cost,
                migrate_ratio=self.migrate_ratio,
                attribution=self._attr_hook("region-route", c,
                                            origin=origin,
                                            affinity=affinity))
        else:
            # global search (fresh request, or the affinity fleet is
            # browned out): hops are charged — and reported — from the
            # ingress region, where the prompt bytes actually are
            home = origin
            f = self.table.global_search(
                c, metric=FleetPTT.TTFT, healthy=healthy, backlog=backlog,
                tokens=prompt_len, origin=home, cost=self.cost,
                attribution=self._attr_hook("region-route", c, origin=origin))
        b = backlog[f] if backlog is not None else 0
        pred = self.table.predict_ttft(int(c), f, b, tokens=prompt_len)
        # the hop charge comes from the SAME cost model the search ran
        # (value=0: the completion part is predict_ttft's job)
        pred += self.wan.cost(
            0.0, Candidate(key=(int(c), f), item=f),
            SearchContext(tokens=prompt_len, origin=home))
        return RegionDecision(fleet=f, req_class=c, predicted=pred,
                              wan_hop=f != home)

    def drain_rank(self, source: int, pos: int, *,
                   backlog: Sequence[int | Mapping] | None = None
                   ) -> list[int]:
        """Destination ranking for one live session on a browned-out
        fleet: healthy fleets plus ``source`` itself under
        ``QueueAware(TPOT) + WanCost (+ MigrationCost)``, ``pos`` sizing
        the egress and re-ingest charges.  ``order[0] == source`` means
        staying home wins — the caller must then skip the export (no
        device->host round trip, no wire bytes)."""
        return self.table.ranked_search(
            int(RequestClass.DECODE), metric=FleetPTT.TPOT,
            healthy=[*self.healthy(), source], backlog=backlog,
            tokens=pos, current=source, origin=source,
            cost=self.sticky_cost,
            attribution=self._attr_hook("region-drain", RequestClass.DECODE,
                                        source=source, pos=pos))

    # -- feedback ----------------------------------------------------------
    def record_rtt(self, src: int, dst: int, seconds: float,
                   now: float | None = None) -> None:
        """One observed ``src -> dst`` delivery time: trains the link's
        EMA RTT row (paper §3.2, the key axes naming links).  ``now``
        (the caller's clock) stamps the link fresh for :meth:`age_links`
        — a real delivery always resets the aging anchor."""
        self.links.update((src, dst), seconds)
        if now is not None:
            self._link_fresh[(src, dst)] = (
                now, self.links.value((src, dst), "rtt"))

    def age_links(self, now: float) -> int:
        """Time-based decay of stale RTT rows toward the trained-link
        prior.  A WAN route flap changes a link's physical path: the EMA
        row then describes a path that no longer exists, and — unlike
        every other row in the system — nothing retrains it until the
        *next* delivery happens to use that link, which the stale row
        itself discourages (a self-sealing error).  So rows age on wall
        time: once a link has gone ``rtt_halflife_s`` without a delivery,
        its value decays exponentially toward the mean of all trained
        links (the prior — absent link-specific evidence, the fleet-wide
        RTT landscape is the best guess), halving the gap each further
        halflife.  Decay is computed from the (stamp, value) anchor laid
        down at the last delivery, so the method is idempotent per ``now``
        and a fresh delivery fully re-anchors the row.  Returns rows
        decayed this call; a no-op when ``rtt_halflife_s`` is 0."""
        if self.rtt_halflife_s <= 0.0 or not self._link_fresh:
            return 0
        view = self.links.array("rtt")
        trained = view != 0.0
        if not trained.any():
            return 0
        prior = float(view[trained].mean())
        aged = 0
        for key, (stamp, anchor) in self._link_fresh.items():
            elapsed = now - stamp
            if elapsed <= self.rtt_halflife_s or view[key] == 0.0:
                continue
            alpha = 0.5 ** (elapsed / self.rtt_halflife_s)
            view[key] = prior + (anchor - prior) * alpha
            aged += 1
        self._rtt_decays += aged
        return aged

    def record_ttft(self, fleet: int, req_class: int, ttft: float, *,
                    prompt_len: int) -> None:
        """Observed dispatch->first-token on ``fleet`` — stored per prompt
        token, exactly like the fleet scale (WAN time is the link rows'
        job; mixing it in here would charge the hop twice)."""
        self.table.update(int(req_class), fleet, FleetPTT.TTFT,
                          ttft / max(prompt_len, 1))

    def record_service(self, fleet: int, seconds: float, *,
                       units: int = 1,
                       req_class: int | None = None) -> None:
        self.table.record_service(fleet, seconds, units=units,
                                  req_class=req_class)

    def record_tpot(self, fleet: int, latency: float) -> None:
        """Per-token decode latency of ``fleet`` — the sticky/drain
        searches read this row."""
        self.table.update(int(RequestClass.DECODE), fleet, FleetPTT.TPOT,
                          latency)

    # -- views -------------------------------------------------------------
    def stats(self) -> dict:
        return {"browned_out": sorted(self.browned_out),
                "updates": self.table.updates,
                "rtt_rows": self.links.array().tolist(),
                "rtt_decays": self._rtt_decays}
