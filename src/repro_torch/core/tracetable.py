"""TraceTable — the paper's Performance Trace Table as ONE reusable store
with pluggable cost models and search policies.

The paper contributes a single idea at a single scale: an online latency
manifest per task type, EMA-updated by the observing leader (§3.2), and
searched under an objective to place work (§3.3).  This repo applies that
idea at four scales — CPU cores (:class:`repro.core.ptt.PTT`), device
groups (:class:`repro.distributed.elastic.PodPTT`), serving replicas
(:class:`repro.router.FleetPTT`), and whole fleets across WAN regions
(:class:`repro.region.RegionRouter`, whose :class:`WanCost` link table is
a TraceTable with *link-keyed* axes) — and this module is the one
implementation all of them instantiate.  Nothing outside this file merges
an EMA or argmins a table.

Paper concept -> API surface:

* **§3.2 — EMA'd latency manifest.**  :class:`TraceTable` is an N-dim
  float64 store: *key axes* identify a configuration (task type x core x
  width; request class x replica; ...), *metric axes* hold independent
  latency rows per cell (the fleet keeps TTFT and TPOT side by side).
  Entries start at 0.0 = "zero predicted time"; :meth:`TraceTable.update`
  applies the paper's 1:4 EMA with zero-bootstrap (an untrained entry
  adopts its first sample — see :meth:`EMASearchMixin.ema_merge`).  The
  trained state is first-class (:meth:`TraceTable.trained_mask`), and the
  whole table snapshots/restores for checkpointing or A/B replays.
  Rows are padded to 64-byte lanes — the paper's cache-line layout.

* **§3.3 — search under an objective.**  A search is three orthogonal
  pieces: *candidates* (the valid configurations, supplied by the caller —
  cluster validity, healthy replica sets), a :class:`CostModel` (what to
  minimize), and a :class:`SearchPolicy` (how to pick).  The paper's
  global search is ``GlobalSearch`` + :class:`Occupancy` (time x width =
  minimum resource occupation); its "alternative optimization strategies
  are also possible" is the rest of the catalogue: :class:`Latency` for
  TTFT-critical serving, :class:`QueueAware` for fleet routing (predicted
  wait from learned per-replica *service rates*, not raw queue counts),
  :class:`MigrationCost` to charge a KV-transfer estimate so sessions
  stop moving for free.  Models compose with ``+``.  The paper's local
  search is the same argmin over a candidate set restricted to the
  current partition; the fleet's migration-averse variant is
  :class:`StickySearch`.

* **Fig. 8 — interference inference.**  Interference is read off the same
  EMA'd signal: the fleet's :class:`~repro.router.InterferenceDetector`
  keeps two single-axis TraceTables per replica — the 1:4 baseline and a
  1:1 fast window (``old_weight``/``den`` are per-table) — and quarantines
  on drift between them.  Untrained entries scoring 0 keeps the paper's
  bootstrap guarantee: every valid configuration is visited, and probe
  traffic keeps quarantined rows training.

This is the PyTorch port's copy of ``repro.core.tracetable``.  The
functional ops (:func:`make_ptt_array`, :func:`ptt_update`,
:func:`ptt_global_search`, :func:`ptt_local_search`) are the same math on
torch tensors, for the pod-scale elastic runtime (homogeneous groups,
power-of-two widths): an update returns a new tensor, and an argmin takes
the first minimum, as the reference's jnp ops do.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

# EMA weight from the paper: old:new = 4:1.
EMA_OLD = 4.0
EMA_DEN = 5.0

# Pad each trailing row to a multiple of 8 float64 = 64 bytes — the
# paper's "organized to fit into cache lines" layout.
_LANE = 8


class EMASearchMixin:
    """The PTT math shared by every trace-table scale (core
    :class:`~repro.core.ptt.PTT`, pod
    :class:`~repro.distributed.elastic.PodPTT`, fleet
    :class:`~repro.router.FleetPTT`): the paper's EMA-1:4 update with
    zero-bootstrap (§3.2) and the argmin search where untrained entries
    score 0 and are therefore visited first (§3.3)."""

    @staticmethod
    def ema_merge(old, new, old_weight: float = EMA_OLD,
                  den: float = EMA_DEN):
        """EMA with zero-bootstrap: an untrained (0.0) entry adopts the
        sample directly — EMA from zero would take ~10 samples to converge
        while the entry no longer reads as "untrained".  Works on scalars
        and numpy arrays; ``old_weight``/``den`` default to the paper's 4:1
        (override for e.g. a fast 1:1 window)."""
        if isinstance(old, np.ndarray):
            return np.where(old == 0.0, new, (old_weight * old + new) / den)
        return new if old == 0.0 else (old_weight * old + new) / den

    @staticmethod
    def argmin_search(entries):
        """``entries``: iterable of (key, cost).  Returns the min-cost key;
        untrained entries cost 0.0 and win, guaranteeing every valid
        configuration is eventually trained (bootstrap, paper §3.2).
        Costs need only support ``<`` — tuples give lexicographic
        tie-breaking (the fleet router uses (predicted, backlog))."""
        best, best_cost = None, None
        for key, cost in entries:
            if best_cost is None or cost < best_cost:
                best, best_cost = key, cost
        assert best is not None, "no valid entries to search"
        return best


# ---------------------------------------------------------------------------
# search inputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Candidate:
    """One searchable configuration.  ``key`` indexes the table's key axes;
    ``item`` is the domain object the search returns (a
    :class:`~repro.core.places.Place`, a replica id, ...).  ``width`` feeds
    occupancy objectives; ``tie`` is the secondary order (the fleet passes
    the replica's queue depth, so cost ties — and the all-untrained
    bootstrap — break toward the shortest queue)."""
    key: tuple
    item: object
    width: int = 1
    tie: float = 0.0


@dataclasses.dataclass
class SearchContext:
    """Everything a cost model may consult besides the table value.

    ``metric``: which metric axis the search reads (index or name).
    ``backlog``: per-item queue depths (``backlog[item]``), or None.  An
    entry may be a plain count *or* a ``{req_class: units}`` mapping —
    a class-resolved backlog lets :class:`QueueAware` price each class's
    queued units at its own learned service rate.
    ``tokens``: request size — scales per-token rows back to absolute
    predictions and sizes KV-transfer estimates.
    ``current``: the sticky home / migration source, or None.
    ``service``: per-item EMA'd *per-unit service time* lookup
    (seconds; 0.0 = untrained), or None.  Called as ``service(item)`` for
    the pooled rate; a caller supplying class-resolved backlogs must supply
    a callable that also accepts ``service(item, req_class)``.
    ``origin``: where the request's bytes currently live (ingress region /
    session home) — what :class:`WanCost` charges hops away from.  Unlike
    ``current`` it carries no sticky/migration semantics: a fresh request
    has an origin but no current placement.
    ``attribution``: decision-attribution hook, or None (the default — no
    cost is paid).  When set, :meth:`TraceTable.search` calls it once per
    search with a :class:`SearchAttribution`: the per-candidate,
    per-:class:`CostModel`-term cost breakdown plus the chosen item, so
    "why did this request land on replica 3" is answerable from telemetry
    (see :mod:`repro.obs.attribution`).
    """
    metric: int | str = 0
    backlog: Sequence[int | Mapping] | None = None
    tokens: int = 1
    current: object = None
    service: Callable[..., float] | None = None
    origin: object = None
    attribution: Callable[["SearchAttribution"], None] | None = None


# ---------------------------------------------------------------------------
# cost models (paper §3.3 objectives, first-class and composable)
# ---------------------------------------------------------------------------

class CostModel:
    """Maps (table value, candidate, context) -> scalar cost.  Untrained
    entries read 0.0, so any value-proportional cost preserves the paper's
    bootstrap: untrained configurations win and get visited.  Models
    compose additively with ``+``."""

    def cost(self, value: float, cand: Candidate,
             ctx: SearchContext) -> float:
        raise NotImplementedError

    def __add__(self, other: "CostModel") -> "CostModel":
        return Sum((self, other))


@dataclasses.dataclass(frozen=True)
class Sum(CostModel):
    """Additive composition: ``QueueAware() + MigrationCost(...)``."""
    parts: tuple

    def cost(self, value, cand, ctx):
        return sum(p.cost(value, cand, ctx) for p in self.parts)

    def __add__(self, other: CostModel) -> "Sum":
        return Sum(self.parts + (other,))


# ---------------------------------------------------------------------------
# decision attribution (the telemetry plane's "why this candidate" record)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CandidateCost:
    """One candidate's scoring under a search: the raw table ``value``
    (0.0 = untrained), the ``total`` cost-model output, and the per-term
    breakdown (``{cost model name: contribution}`` — the terms of a
    :class:`Sum` scored separately; their sum equals ``total`` because
    :class:`Sum` is additive)."""
    item: object
    key: tuple
    value: float
    total: float
    terms: dict
    tie: float


@dataclasses.dataclass(frozen=True)
class SearchAttribution:
    """One search's full decision record: every candidate's
    :class:`CandidateCost` plus what the policy chose (for a ranked
    policy, the head of the ranking).  Delivered to
    ``SearchContext.attribution``.

    ``context`` captures the :class:`SearchContext` *inputs* as plain
    data — the scalar fields plus, per candidate (aligned with
    ``candidates``), its width, backlog entry, and service-rate readings
    at decision time.  That makes a persisted record **replayable**: a
    modified :class:`CostModel` can re-score the exact same decision
    offline (:mod:`repro.obs.replay`) without the live tables."""
    chosen: object
    metric: int | str
    policy: str
    candidates: tuple
    context: dict | None = None


def capture_context(ctx: "SearchContext", scored: Sequence) -> dict:
    """Freeze a search's inputs for replay: scalar context fields plus a
    ``per_item`` list (one entry per scored candidate, in order) holding
    each candidate's width, backlog entry, pooled service rate, and —
    under class-resolved backlogs — per-class rates.  Only plain data
    crosses: the capture survives JSON and rebuilds a working
    :class:`SearchContext` offline."""
    per_item = []
    for s in scored:
        item = s.cand.item
        entry: dict = {"width": s.cand.width}
        b = None
        if ctx.backlog is not None:
            b = ctx.backlog[item]
            entry["backlog"] = dict(b) if isinstance(b, Mapping) else b
        if ctx.service is not None:
            entry["service"] = ctx.service(item)
            if isinstance(b, Mapping):
                entry["class_service"] = {c: ctx.service(item, c)
                                          for c in b}
        per_item.append(entry)
    return {"metric": ctx.metric, "tokens": ctx.tokens,
            "current": ctx.current, "origin": ctx.origin,
            "per_item": per_item}


def cost_terms(cost: CostModel, value: float, cand: Candidate,
               ctx: "SearchContext") -> dict:
    """Per-term cost breakdown of one candidate: each part of a
    :class:`Sum` is scored separately under its class name (``#i``
    suffixes disambiguate repeated classes); a non-composite model yields
    a single term.  Additivity of :class:`Sum` guarantees the terms sum
    to ``cost.cost(value, cand, ctx)`` exactly."""
    parts = cost.parts if isinstance(cost, Sum) else (cost,)
    terms: dict = {}
    for p in parts:
        name = type(p).__name__
        if name in terms:
            i = 2
            while f"{name}#{i}" in terms:
                i += 1
            name = f"{name}#{i}"
        terms[name] = p.cost(value, cand, ctx)
    return terms


@dataclasses.dataclass(frozen=True)
class Latency(CostModel):
    """Execution time alone — TTFT-critical serving (§3.3's "alternative
    objectives"): queue-inflated samples push the search toward narrower
    widths under load, so width adapts to load automatically."""

    def cost(self, value, cand, ctx):
        return value


@dataclasses.dataclass(frozen=True)
class Occupancy(CostModel):
    """time x width — the paper's default objective (minimum resource
    occupation)."""

    def cost(self, value, cand, ctx):
        return value * cand.width


@dataclasses.dataclass(frozen=True)
class QueueAware(CostModel):
    """Predicted completion = own service + predicted wait.

    With a trained per-item service rate (``ctx.service``), the wait is
    ``backlog x EMA'd per-request service time`` — the queue is measured in
    *seconds of work ahead*, not request counts, so a backlog of 3 on a 4x
    straggler correctly outweighs a backlog of 5 on a fast replica.
    Until service rates train, it degrades to the classic count inflation
    ``value x tokens x (1 + backlog)`` (optimistic on untrained entries,
    preserving the bootstrap).

    A backlog entry may also be a ``{req_class: units}`` mapping: each
    class's queued units are then priced at that class's learned rate
    (``ctx.service(item, req_class)`` — the per-class split of the ROADMAP's
    service-rate lever).  One pooled rate mispredicts a mixed queue — a
    backlog of short interactive prefills drains far faster than the same
    unit count of decode-heavy turns — so the per-class sum tracks the true
    seconds of work ahead.  Classes whose row (and pooled fallback) are
    untrained degrade per-class to the classic count inflation.

    ``value_per_token=False`` treats the table value as an absolute
    per-operation latency (e.g. a TPOT decode-step row) instead of a
    per-token rate: ``ctx.tokens`` then sizes only composed terms like
    :class:`MigrationCost`, not the value itself."""
    value_per_token: bool = True

    @staticmethod
    def predict(value: float, tokens: int, backlog: float,
                service: float) -> float:
        t = max(tokens, 1)
        if service > 0.0:
            return value * t + backlog * service
        return value * t * (1 + backlog)

    def cost(self, value, cand, ctx):
        b = ctx.backlog[cand.item] if ctx.backlog is not None else 0
        t = ctx.tokens if self.value_per_token else 1
        if isinstance(b, Mapping):
            if ctx.service is None:
                return self.predict(value, t, sum(b.values()), 0.0)
            own = value * max(t, 1)
            wait = 0.0
            for c, units in b.items():
                rate = ctx.service(cand.item, c)
                if rate > 0.0:
                    wait += units * rate
                else:             # untrained class AND pooled fallback:
                    wait += own * units      # classic count inflation
            return own + wait
        s = ctx.service(cand.item) if ctx.service is not None else 0.0
        return self.predict(value, t, b, s)


@dataclasses.dataclass(frozen=True)
class MigrationCost(CostModel):
    """Charges moving off ``ctx.current``: a fixed hop cost plus a
    per-token KV-transfer estimate (``ctx.tokens`` sizes the cache).
    Staying home is free, so composed with any latency objective it makes
    migration pay for itself instead of sessions flocking to the
    momentarily-best replica for free."""
    per_token: float = 0.0       # seconds per cached token moved
    fixed: float = 0.0           # per-hop cost (connection, slot churn)

    def cost(self, value, cand, ctx):
        if ctx.current is None or cand.item == ctx.current:
            return 0.0
        return self.fixed + self.per_token * max(ctx.tokens, 0)


@dataclasses.dataclass(frozen=True)
class WanCost(CostModel):
    """WAN-hop charge for placing work away from where its bytes live:
    the learned link RTT (an EMA :class:`TraceTable` keyed ``(src, dst)``
    — the same §3.2 store, its key axes naming *links* instead of cores)
    plus a per-byte egress charge sized by ``ctx.tokens x bytes_per_token``.

    The home side of the hop is ``ctx.origin`` (ingress region / session
    home), falling back to ``ctx.current`` when unset — so composed into a
    sticky search it charges the same hop a :class:`MigrationCost` charges,
    while a fresh request (origin set, no current placement) pays the hop
    without inheriting sticky semantics.  Staying home is free; an
    untrained link row reads 0.0 and charges only egress, preserving the
    bootstrap (the first hops over a link are cheap, get taken, and train
    its RTT row).  Candidate items must index the link table's key axes
    directly (the region tier uses fleet indices)."""
    links: TraceTable
    egress_per_byte: float = 0.0     # "seconds" of cost per byte shipped
                                     # (a $-to-latency exchange rate)
    bytes_per_token: float = 0.0     # KV/prompt bytes moved per token
    metric: int | str = 0

    def rtt(self, src, dst) -> float:
        """Learned round-trip time of the ``src -> dst`` link (0.0 for the
        loopback link and for untrained rows)."""
        if src == dst:
            return 0.0
        return self.links.value((src, dst), self.metric)

    def cost(self, value, cand, ctx):
        home = ctx.origin if ctx.origin is not None else ctx.current
        if home is None or cand.item == home:
            return 0.0
        return (self.rtt(home, cand.item)
                + self.egress_per_byte * self.bytes_per_token
                * max(ctx.tokens, 0))


# ---------------------------------------------------------------------------
# search policies (paper §3.3 global/local, fleet sticky)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scored:
    cand: Candidate
    value: float          # raw table entry (0.0 = untrained)
    primary: float        # cost-model output

    @property
    def order(self):
        return (self.primary, self.cand.tie)


class SearchPolicy:
    def select(self, scored: list, ctx: SearchContext):
        raise NotImplementedError


class GlobalSearch(SearchPolicy):
    """argmin over the candidate set (the paper's global search; ties —
    including the all-untrained bootstrap — break by ``Candidate.tie``
    then candidate order)."""

    def select(self, scored, ctx):
        return EMASearchMixin.argmin_search(
            (s.cand.item, s.order) for s in scored)


class RankedSearch(SearchPolicy):
    """All candidates in ascending cost order — for callers needing a
    fallback chain (e.g. session migration trying the next-best replica
    when the best one cannot hold the session)."""

    def select(self, scored, ctx):
        return [s.cand.item for s in sorted(scored, key=lambda s: s.order)]


@dataclasses.dataclass(frozen=True)
class StickySearch(SearchPolicy):
    """Stay on ``ctx.current`` unless it is not a candidate (unhealthy) or
    the best candidate beats it by more than ``migrate_ratio`` on the cost
    model — migration avoidance, the fleet analogue of the paper's local
    search.  Untrained entries stay home (bootstrap happens via routed
    traffic).  Compose :class:`MigrationCost` into the model to charge
    the move itself on top of the ratio bar."""
    migrate_ratio: float = 2.0

    def select(self, scored, ctx):
        best = min(scored, key=lambda s: s.order)
        home = next((s for s in scored if s.cand.item == ctx.current), None)
        if home is None:
            return best.cand.item
        if home.value == 0.0 or best.value == 0.0:
            return home.cand.item
        if home.primary > self.migrate_ratio * best.primary:
            return best.cand.item
        return home.cand.item


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class TraceTable(EMASearchMixin):
    """N-dim EMA'd latency store: ``key_shape`` names the configuration
    axes, ``metrics`` the independent latency rows per cell.  0.0 =
    untrained.  One ``(leading keys)`` row is C-contiguous and padded to
    64-byte lanes (the paper's cache-line layout).  ``old_weight``/``den``
    set the EMA window for the whole table (default the paper's 1:4)."""

    def __init__(self, key_shape: Sequence[int],
                 metrics: Sequence[str] = ("latency",), *,
                 old_weight: float = EMA_OLD, den: float = EMA_DEN):
        self.key_shape = tuple(int(k) for k in key_shape)
        if not self.key_shape:
            raise ValueError("need at least one key axis")
        self.metrics = tuple(metrics)
        self.old_weight = float(old_weight)
        self.den = float(den)
        self._m2i = {m: i for i, m in enumerate(self.metrics)}
        row = self.key_shape[-1] * len(self.metrics)
        padded = ((row + _LANE - 1) // _LANE) * _LANE
        self._buf = np.zeros(self.key_shape[:-1] + (padded,),
                             dtype=np.float64)
        self._tab = self._buf[..., :row].reshape(
            self.key_shape + (len(self.metrics),))
        self.updates = 0

    def _mi(self, metric: int | str) -> int:
        return self._m2i[metric] if isinstance(metric, str) else int(metric)

    # -- views -------------------------------------------------------------
    def value(self, key: Sequence[int], metric: int | str = 0) -> float:
        return float(self._tab[tuple(key) + (self._mi(metric),)])

    def trained(self, key: Sequence[int], metric: int | str = 0) -> bool:
        return self._tab[tuple(key) + (self._mi(metric),)] != 0.0

    def array(self, metric: int | str = 0) -> np.ndarray:
        """Writable live view over all key axes for one metric."""
        return self._tab[..., self._mi(metric)]

    def trained_mask(self, metric: int | str = 0) -> np.ndarray:
        return self.array(metric) != 0.0

    # -- update (leader/observer only; paper §3.2) --------------------------
    def update(self, key: Sequence[int], sample: float,
               metric: int | str = 0) -> None:
        idx = tuple(key) + (self._mi(metric),)
        self._tab[idx] = self.ema_merge(self._tab[idx], sample,
                                        self.old_weight, self.den)
        self.updates += 1

    def merge_array(self, samples: np.ndarray,
                    metric: int | str = 0) -> None:
        """Vectorized EMA over every cell of one metric at once (e.g. the
        straggler rebalancer's per-group step times)."""
        view = self.array(metric)
        view[...] = self.ema_merge(view, np.asarray(samples, np.float64),
                                   self.old_weight, self.den)
        self.updates += 1

    # -- snapshot / restore --------------------------------------------------
    def snapshot(self) -> np.ndarray:
        return self._tab.copy()

    def restore(self, snap: np.ndarray) -> None:
        self._tab[...] = snap

    # -- search (paper §3.3) -------------------------------------------------
    def search(self, candidates: Iterable[Candidate], cost: CostModel,
               policy: SearchPolicy | None = None,
               ctx: SearchContext | None = None):
        """Score every candidate under ``cost`` and let ``policy`` pick.
        Returns whatever the policy returns (an item, or a ranked list)."""
        ctx = ctx if ctx is not None else SearchContext()
        mi = self._mi(ctx.metric)
        scored = []
        for c in candidates:
            v = float(self._tab[c.key + (mi,)])
            scored.append(Scored(c, v, cost.cost(v, c, ctx)))
        assert scored, "no valid candidates to search"
        policy = policy if policy is not None else GlobalSearch()
        picked = policy.select(scored, ctx)
        if ctx.attribution is not None:
            chosen = picked[0] if isinstance(picked, list) else picked
            ctx.attribution(SearchAttribution(
                chosen=chosen, metric=ctx.metric,
                policy=type(policy).__name__,
                candidates=tuple(
                    CandidateCost(item=s.cand.item, key=s.cand.key,
                                  value=s.value, total=s.primary,
                                  terms=cost_terms(cost, s.value, s.cand,
                                                   ctx),
                                  tie=s.cand.tie)
                    for s in scored),
                context=capture_context(ctx, scored)))
        return picked


# ---------------------------------------------------------------------------
# Functional PTT on torch tensors — same math; homogeneous device groups
# with power-of-two widths (the pod-scale case).
# ---------------------------------------------------------------------------

def make_ptt_array(num_task_types: int, num_cores: int,
                   widths: Sequence[int]) -> torch.Tensor:
    return torch.zeros((num_task_types, num_cores, len(widths)),
                       dtype=torch.float32)


def _valid_mask(num_cores: int, widths: tuple[int, ...]) -> torch.Tensor:
    cores = np.arange(num_cores)[:, None]
    ws = np.array(widths)[None, :]
    return torch.from_numpy((cores % ws) == 0)        # (C, W) bool


def ptt_update(table: torch.Tensor, task_type, leader, width_idx,
               elapsed) -> torch.Tensor:
    """Functional EMA update (leader-core rule is the caller's contract):
    returns a new table; ``table`` is left as it was."""
    old = table[task_type, leader, width_idx]
    new = torch.where(old == 0.0, elapsed, (EMA_OLD * old + elapsed) / EMA_DEN)
    out = table.clone()
    out[task_type, leader, width_idx] = new
    return out


def ptt_global_search(table: torch.Tensor, task_type,
                      widths: tuple[int, ...]):
    """argmin_{leader,width} time*width with leader-validity mask.
    Returns (leader, width_idx)."""
    tab = table[task_type]                              # (C, W)
    w = torch.tensor(widths, dtype=tab.dtype, device=tab.device)[None, :]
    cost = torch.where(_valid_mask(tab.shape[0], widths).to(tab.device),
                       tab * w, torch.inf)
    flat = torch.argmin(cost.reshape(-1))
    return flat // len(widths), flat % len(widths)


def ptt_local_search(table: torch.Tensor, task_type, core,
                     widths: tuple[int, ...]):
    """Best width_idx among the partitions containing ``core``."""
    ws = torch.tensor(widths, dtype=torch.int64, device=table.device)
    leaders = torch.div(torch.as_tensor(core, device=table.device), ws,
                        rounding_mode="floor") * ws        # (W,)
    vals = table[task_type, leaders,
                 torch.arange(len(widths), device=table.device)]
    cost = vals * torch.tensor(widths, dtype=table.dtype,
                               device=table.device)
    return torch.argmin(cost)
