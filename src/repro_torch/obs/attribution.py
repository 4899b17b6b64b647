"""Decision attribution — "why did this request land on replica 3".

The TraceTable's search already computes everything needed to answer
that: each candidate's raw EMA value, the composed cost-model total, and
(via :func:`repro_torch.core.tracetable.cost_terms`) every term's contribution.
The :class:`DecisionLog` is the sink: routers hand its :meth:`hook` to
``SearchContext.attribution`` (threaded through every
:class:`~repro_torch.router.FleetPTT` search), and each routing, migration, or
drain decision lands here as a :class:`DecisionRecord` —

* the full :class:`~repro_torch.core.tracetable.SearchAttribution` (per
  candidate: value, per-term cost breakdown summing exactly to the
  total, tie-breaker);
* a caller-supplied **row snapshot** (TraceTable EMA values, trained
  mask, service rates, drift/quarantine state at decision time — the
  evidence the costs were computed from);
* free-form ``meta`` (request class, the final post-overflow pick, ...).

Everything is plain data: :meth:`DecisionRecord.check` verifies the
additivity invariant, :meth:`explain` renders a human-readable account.
The log is bounded (oldest evicted) and costs nothing when not attached —
``SearchContext.attribution`` defaults to None and the search skips the
whole breakdown.

This is the PyTorch port's copy of ``repro.obs.attribution``: host-side
Python and numpy, the same logic; only the imports differ.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

from ..core.tracetable import SearchAttribution


@dataclasses.dataclass
class DecisionRecord:
    """One attributed decision: ``kind`` names the decision site
    ("route", "migrate", "region-route", "region-drain"), ``search`` the
    cost evidence, ``rows`` the table-state snapshot, ``meta`` anything
    the decision site adds after the fact (final pick, overflow flag)."""
    kind: str
    search: SearchAttribution
    rows: dict
    meta: dict

    @property
    def chosen(self):
        return self.search.chosen

    def candidate(self, item=None):
        """The :class:`~repro_torch.core.tracetable.CandidateCost` of ``item``
        (default: the chosen one)."""
        item = item if item is not None else self.search.chosen
        for c in self.search.candidates:
            if c.item == item:
                return c
        raise KeyError(f"{item!r} was not a candidate of this decision")

    def breakdown(self, item=None) -> dict:
        return dict(self.candidate(item).terms)

    def check(self, tol: float = 1e-9) -> bool:
        """The attribution invariant: every candidate's terms sum to its
        total (additive :class:`~repro_torch.core.tracetable.Sum` composition —
        a term that double-charges or goes missing fails here)."""
        return all(abs(sum(c.terms.values()) - c.total)
                   <= tol * max(1.0, abs(c.total))
                   for c in self.search.candidates)


class DecisionLog:
    """Bounded sink of :class:`DecisionRecord`; one per router (or one
    shared across scales — records carry their ``kind``)."""

    def __init__(self, cap: int = 10_000):
        self.records: deque[DecisionRecord] = deque(maxlen=cap)

    def __len__(self) -> int:
        return len(self.records)

    def hook(self, kind: str, rows_fn: Callable | None = None,
             **meta) -> Callable[[SearchAttribution], DecisionRecord]:
        """An ``attribution`` callable for one search: appends a record
        with ``rows_fn(search)``'s snapshot (taken at decision time, not
        at read time) and returns it so the decision site can annotate
        ``meta`` after the fact (overflow overrides, admission verdicts).
        """
        def record(sa: SearchAttribution) -> DecisionRecord:
            rec = DecisionRecord(kind=kind, search=sa,
                                 rows=rows_fn(sa) if rows_fn else {},
                                 meta=dict(meta))
            self.records.append(rec)
            return rec
        return record

    def last(self, kind: str | None = None) -> DecisionRecord | None:
        for rec in reversed(self.records):
            if kind is None or rec.kind == kind:
                return rec
        return None

    @staticmethod
    def explain(rec: DecisionRecord) -> str:
        """Human-readable account of one decision: every candidate's
        per-term costs (chosen marked), then the row snapshot."""
        lines = [f"[{rec.kind}] chose {rec.chosen!r} "
                 f"({rec.search.policy}, metric={rec.search.metric})"]
        for c in sorted(rec.search.candidates, key=lambda c: c.total):
            mark = "->" if c.item == rec.search.chosen else "  "
            terms = " + ".join(f"{k}={v:.6g}" for k, v in c.terms.items())
            lines.append(f"{mark} {c.item!r}: total={c.total:.6g} "
                         f"({terms}; value={c.value:.6g}, tie={c.tie:g})")
        for item, row in rec.rows.items():
            lines.append(f"   row {item!r}: " + ", ".join(
                f"{k}={v}" for k, v in row.items()))
        if rec.meta:
            lines.append("   meta: " + ", ".join(
                f"{k}={v}" for k, v in rec.meta.items()))
        return "\n".join(lines)
