"""Decision replay — routing-policy changes as a reviewable diff.

Today a cost-model tweak is judged by re-running a benchmark and eyeballing
p99 — slow, noisy, and silent about *which decisions* changed.  This module
turns the :class:`~repro_torch.obs.DecisionLog` into a regression artifact:

* **persistence** — :func:`dump_jsonl` / :func:`load_jsonl` write records
  as one JSON object per line (every record carries the search's captured
  :class:`~repro_torch.core.tracetable.SearchContext` inputs — see
  ``SearchAttribution.context``);
* **replay** — :func:`rescore` rebuilds each recorded search's candidates
  and context and re-scores them under a *modified*
  :class:`~repro_torch.core.tracetable.CostModel`; :func:`replay` aggregates a
  whole log into a :class:`ReplayReport`: per-term cost deltas and
  **flipped winners** (decisions whose argmin changed under the new
  model).  A proposed ``MigrationCost`` bump answers "it flips 3 of 214
  recorded placements, all on the quarantined replica" instead of "p99
  moved 2%, probably fine";
* **CLI** — ``python -m repro_torch.obs.replay LOG --cost queueaware+migration:fixed=0.05``
  prints the report.

The replayed winner is the plain ``(total, tie)`` argmin on both sides —
the recorded side's argmin is recomputed the same way — so the diff
isolates the *cost model* change from policy stickiness; records whose
live policy overrode the argmin (StickySearch staying home) are counted
separately, never as flips.

This is the PyTorch port's copy of ``repro.obs.replay``: host-side
Python and numpy, the same logic; only the imports differ.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from ..core.tracetable import (Candidate, CostModel, Latency, MigrationCost,
                               Occupancy, QueueAware, SearchContext, Sum,
                               cost_terms)
from .attribution import DecisionLog, DecisionRecord


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def json_default(o):
    """``json.dumps`` fallback for values riding in decision records:
    numpy scalars (the router's backlogs/flags) and set/tuple
    containers.  Anything else is a genuine serialization bug."""
    item = getattr(o, "item", None)
    if callable(item):
        return item()                    # numpy scalar -> python scalar
    if isinstance(o, (set, frozenset, tuple)):
        return sorted(o) if isinstance(o, (set, frozenset)) else list(o)
    raise TypeError(
        f"Object of type {o.__class__.__name__} is not JSON serializable")


def record_to_json(rec: DecisionRecord) -> dict:
    """One record as plain data (the JSONL line / ``/debug/decisions``
    entry).  Candidate keys become lists; row/meta dicts pass through
    ``json``'s own coercion (int keys stringify)."""
    sa = rec.search
    return {
        "kind": rec.kind,
        "chosen": sa.chosen,
        "metric": sa.metric,
        "policy": sa.policy,
        "candidates": [
            {"item": c.item, "key": list(c.key), "value": c.value,
             "total": c.total, "terms": dict(c.terms), "tie": c.tie}
            for c in sa.candidates],
        "context": sa.context,
        "rows": {str(k): v for k, v in rec.rows.items()},
        "meta": dict(rec.meta),
    }


def dump_jsonl(log: DecisionLog, path: str) -> int:
    """Persist every retained record, one JSON object per line.  Returns
    the number written."""
    n = 0
    with open(path, "w") as f:
        for rec in log.records:
            f.write(json.dumps(record_to_json(rec), sort_keys=True,
                               default=json_default) + "\n")
            n += 1
    return n


def load_jsonl(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# re-scoring
# ---------------------------------------------------------------------------

def _service_fn(by_item: dict):
    def service(item, req_class=None):
        e = by_item.get(item, {})
        if req_class is not None:
            cs = e.get("class_service") or {}
            # class keys stringify across the JSON round trip
            return float(cs.get(req_class, cs.get(str(req_class), 0.0)))
        return float(e.get("service", 0.0))
    return service


def context_from_record(rec: dict) -> SearchContext:
    """Rebuild a working :class:`SearchContext` from a record's captured
    inputs — backlogs as an item-keyed dict, service rates as a closure
    over the captured readings."""
    ctx_cap = rec.get("context") or {}
    per_item = ctx_cap.get("per_item") or []
    items = [c["item"] for c in rec["candidates"]]
    by_item = dict(zip(items, per_item))
    backlog = None
    if any("backlog" in e for e in per_item):
        backlog = {i: by_item[i].get("backlog", 0) for i in items}
    service = (_service_fn(by_item)
               if any("service" in e for e in per_item) else None)
    return SearchContext(metric=ctx_cap.get("metric", 0),
                         backlog=backlog,
                         tokens=ctx_cap.get("tokens", 1),
                         current=ctx_cap.get("current"),
                         service=service,
                         origin=ctx_cap.get("origin"))


def _argmin(entries) -> object:
    """item of the min (total, tie) entry — both sides' winner rule."""
    return min(entries, key=lambda e: (e[1], e[2]))[0]


def rescore(rec: dict, cost: CostModel) -> dict:
    """Re-score one recorded decision under ``cost``.  Returns the old
    and new ``(total, tie)`` argmin winners, per-candidate new totals and
    terms, and whether the winner flipped."""
    ctx = context_from_record(rec)
    per_item = (rec.get("context") or {}).get("per_item") or []
    old_entries, new_entries, new_cands = [], [], []
    for i, c in enumerate(rec["candidates"]):
        width = per_item[i].get("width", 1) if i < len(per_item) else 1
        cand = Candidate(key=tuple(c["key"]), item=c["item"], width=width,
                         tie=c["tie"])
        total = cost.cost(c["value"], cand, ctx)
        terms = cost_terms(cost, c["value"], cand, ctx)
        old_entries.append((c["item"], c["total"], c["tie"]))
        new_entries.append((c["item"], total, c["tie"]))
        new_cands.append({"item": c["item"], "total": total, "terms": terms,
                          "old_total": c["total"], "old_terms": c["terms"]})
    old_winner = _argmin(old_entries)
    new_winner = _argmin(new_entries)
    return {"kind": rec["kind"], "old_winner": old_winner,
            "new_winner": new_winner, "flipped": old_winner != new_winner,
            "recorded_chosen": rec["chosen"],
            "policy_override": rec["chosen"] != old_winner,
            "candidates": new_cands}


@dataclasses.dataclass
class ReplayReport:
    """Aggregated replay of one log under one modified cost model."""
    n: int                       # records replayed
    flips: list                  # [{index, kind, old, new}]
    policy_overrides: int        # recorded chosen != old argmin (sticky)
    term_totals: dict            # term -> {"old": x, "new": y, "delta": d}
    kinds: dict                  # kind -> count replayed

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        lines = [f"replayed {self.n} decisions "
                 f"({', '.join(f'{k}={v}' for k, v in sorted(self.kinds.items()))}); "
                 f"{len(self.flips)} flipped winner(s), "
                 f"{self.policy_overrides} policy override(s)"]
        for t in sorted(self.term_totals):
            d = self.term_totals[t]
            lines.append(f"  term {t}: old={d['old']:.6g} "
                         f"new={d['new']:.6g} delta={d['delta']:+.6g}")
        for fl in self.flips:
            lines.append(f"  flip #{fl['index']} [{fl['kind']}]: "
                         f"{fl['old']!r} -> {fl['new']!r}")
        return "\n".join(lines)


def replay(records: list[dict], cost: CostModel,
           kinds: list[str] | None = None) -> ReplayReport:
    """Re-score every record (optionally filtered by ``kinds``) and
    aggregate per-term deltas + flipped winners."""
    flips, term_totals, kind_counts = [], {}, {}
    overrides = n = 0
    for i, rec in enumerate(records):
        if kinds is not None and rec["kind"] not in kinds:
            continue
        r = rescore(rec, cost)
        n += 1
        kind_counts[r["kind"]] = kind_counts.get(r["kind"], 0) + 1
        if r["flipped"]:
            flips.append({"index": i, "kind": r["kind"],
                          "old": r["old_winner"], "new": r["new_winner"]})
        if r["policy_override"]:
            overrides += 1
        for c in r["candidates"]:
            for t, v in c["old_terms"].items():
                d = term_totals.setdefault(t, {"old": 0.0, "new": 0.0})
                d["old"] += v
            for t, v in c["terms"].items():
                d = term_totals.setdefault(t, {"old": 0.0, "new": 0.0})
                d["new"] += v
    for d in term_totals.values():
        d["delta"] = d["new"] - d["old"]
    return ReplayReport(n=n, flips=flips, policy_overrides=overrides,
                        term_totals=term_totals, kinds=kind_counts)


# ---------------------------------------------------------------------------
# CLI: a cost-model spec grammar small enough to live in a CI step
# ---------------------------------------------------------------------------

_TERMS = {"latency": Latency, "occupancy": Occupancy,
          "queueaware": QueueAware, "migration": MigrationCost}


def _coerce(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return float(v)


def parse_cost(spec: str) -> CostModel:
    """``term[:k=v,...]`` joined by ``+``:
    ``queueaware+migration:fixed=0.05,per_token=2e-6``."""
    parts = []
    for chunk in spec.split("+"):
        name, _, argstr = chunk.strip().partition(":")
        cls = _TERMS.get(name.lower())
        if cls is None:
            raise ValueError(f"unknown cost term {name!r} "
                             f"(know: {sorted(_TERMS)})")
        kwargs = {}
        if argstr:
            for kv in argstr.split(","):
                k, _, v = kv.partition("=")
                kwargs[k.strip()] = _coerce(v.strip())
        parts.append(cls(**kwargs))
    if not parts:
        raise ValueError("empty cost spec")
    return parts[0] if len(parts) == 1 else Sum(tuple(parts))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.replay",
        description="Re-score a recorded DecisionLog under a modified "
                    "cost model; report per-term deltas + flipped winners.")
    p.add_argument("log", help="DecisionLog JSONL file")
    p.add_argument("--cost", required=True,
                   help="cost spec, e.g. queueaware+migration:fixed=0.05")
    p.add_argument("--kind", action="append", default=None,
                   help="only replay records of this kind (repeatable)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the report as JSON")
    args = p.parse_args(argv)
    records = load_jsonl(args.log)
    report = replay(records, parse_cost(args.cost), kinds=args.kind)
    print(report.render())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_json(), f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
