"""Layer 3 — contract checker for the TraceTable plugin surfaces and the
cross-scale stats facades: the port's copy of ``repro.analysis.contracts``,
over :mod:`repro_torch.core.tracetable` and the port's serving facades.

The telemetry plane's attribution records are only trustworthy if
every :class:`~repro_torch.core.tracetable.CostModel` keeps the additivity
contract ``sum(cost_terms(...)) == cost(...)`` *exactly* — a model that
caches state between calls or returns different values on re-evaluation
breaks the "terms sum to totals" invariant DecisionRecord.check() pins.
This layer walks every cost model and search policy registered in
:mod:`repro_torch.core.tracetable` (defined there = registered) and exercises
the contract on synthetic contexts; and it instantiates each serving
facade (engine, fleet, region) to verify ``stats()`` exposes every
:data:`repro_torch.obs.CANONICAL_STATS` counter.  The facades are
built over a reduced model on ``device`` (the card unless the caller asks
for the CPU).

A new cost model whose constructor needs non-default arguments must add a
synthetic constructor to :data:`SYNTHETIC_CTORS`, or the checker reports
it unverifiable (that is the registration step, not an exemption)."""

from __future__ import annotations

import functools
import operator

from .findings import SEVERITY_ERROR, Finding

_TT_PATH = "src/repro_torch/core/tracetable.py"


def _tracetable():
    from ..core import tracetable
    return tracetable


#: name -> zero-arg constructor for cost models whose __init__ has
#: required parameters.  Candidate items in the synthetic contexts are
#: ints 0..2, so link-table-backed models get a (3, 3) table.
SYNTHETIC_CTORS = {
    "WanCost": lambda tt: tt.WanCost(links=tt.TraceTable((3, 3)),
                                     egress_per_byte=1e-6,
                                     bytes_per_token=128.0),
}


def _synthetic_contexts(tt):
    """Context variants covering every field a cost model may consult."""
    service = lambda item, req_class=None: 0.01 * (item + 1)
    return [
        tt.SearchContext(),
        tt.SearchContext(backlog=[2, 0, 1], tokens=5, current=0, origin=1,
                         service=service),
        tt.SearchContext(backlog=[{0: 2, 1: 1}, {}, {1: 3}], tokens=3,
                         current=2, service=service),
    ]


def _cost_model_classes(tt):
    base = tt.CostModel
    out = []
    for name in sorted(vars(tt)):
        obj = vars(tt)[name]
        if (isinstance(obj, type) and issubclass(obj, base)
                and obj is not base and obj is not tt.Sum):
            out.append(obj)
    return out


def _policy_classes(tt):
    base = tt.SearchPolicy
    return [vars(tt)[n] for n in sorted(vars(tt))
            if isinstance(vars(tt)[n], type)
            and issubclass(vars(tt)[n], base) and vars(tt)[n] is not base]


def check_cost_models() -> list:
    tt = _tracetable()
    findings = []
    instances = []
    for cls in _cost_model_classes(tt):
        if cls.cost is tt.CostModel.cost:
            findings.append(Finding(
                "cost-model-contract", SEVERITY_ERROR, _TT_PATH, 0,
                f"{cls.__name__} does not implement cost() — every "
                f"registered cost model must score candidates"))
            continue
        ctor = SYNTHETIC_CTORS.get(cls.__name__)
        try:
            inst = ctor(tt) if ctor else cls()
        except TypeError:
            findings.append(Finding(
                "cost-model-contract", SEVERITY_ERROR, _TT_PATH, 0,
                f"{cls.__name__} cannot be instantiated for contract "
                f"checking — add a synthetic constructor to "
                f"repro_torch.analysis.contracts.SYNTHETIC_CTORS"))
            continue
        instances.append(inst)
    if not instances:
        return findings
    cands = [tt.Candidate(key=(i,), item=i, width=1 + i % 2, tie=float(i))
             for i in range(3)]
    values = (0.0, 0.5, 2.0)
    composite = functools.reduce(operator.add, instances)
    for ctx in _synthetic_contexts(tt):
        for cand in cands:
            for value in values:
                for inst in instances:
                    name = type(inst).__name__
                    try:
                        total = inst.cost(value, cand, ctx)
                        terms = tt.cost_terms(inst, value, cand, ctx)
                    except Exception as e:
                        findings.append(Finding(
                            "cost-model-contract", SEVERITY_ERROR,
                            _TT_PATH, 0,
                            f"{name}.cost() raised on a synthetic "
                            f"context ({type(e).__name__}: {e})"))
                        break
                    if sum(terms.values()) != total:
                        findings.append(Finding(
                            "cost-model-contract", SEVERITY_ERROR,
                            _TT_PATH, 0,
                            f"{name}: cost_terms() sums to "
                            f"{sum(terms.values())} but cost() returns "
                            f"{total} — terms must sum exactly to totals"))
                # composite additivity: the Sum of every model must break
                # down into exactly its parts, summed in evaluation order
                total = composite.cost(value, cand, ctx)
                terms = tt.cost_terms(composite, value, cand, ctx)
                if len(terms) != len(instances):
                    findings.append(Finding(
                        "cost-model-contract", SEVERITY_ERROR, _TT_PATH, 0,
                        f"Sum of {len(instances)} models yields "
                        f"{len(terms)} cost_terms — every part must "
                        f"appear in the breakdown"))
                elif sum(terms.values()) != total:
                    findings.append(Finding(
                        "cost-model-contract", SEVERITY_ERROR, _TT_PATH, 0,
                        f"Sum breakdown {terms} sums to "
                        f"{sum(terms.values())} != total {total} — "
                        f"attribution records would lie"))
    return _dedup(findings)


def check_search_policies() -> list:
    tt = _tracetable()
    findings = []
    cands = [tt.Candidate(key=(i,), item=i, tie=float(i)) for i in range(3)]
    scored = [tt.Scored(c, value=0.5 + i, primary=float(3 - i))
              for i, c in enumerate(cands)]
    items = {c.item for c in cands}
    for cls in _policy_classes(tt):
        name = cls.__name__
        if cls.select is tt.SearchPolicy.select:
            findings.append(Finding(
                "search-policy-contract", SEVERITY_ERROR, _TT_PATH, 0,
                f"{name} does not implement select()"))
            continue
        try:
            inst = cls()
            picked = inst.select(list(scored),
                                 tt.SearchContext(current=cands[0].item))
        except Exception as e:
            findings.append(Finding(
                "search-policy-contract", SEVERITY_ERROR, _TT_PATH, 0,
                f"{name}.select() raised on a synthetic scored list "
                f"({type(e).__name__}: {e})"))
            continue
        returned = picked if isinstance(picked, list) else [picked]
        if not returned or not set(returned) <= items:
            findings.append(Finding(
                "search-policy-contract", SEVERITY_ERROR, _TT_PATH, 0,
                f"{name}.select() returned {picked!r} — policies must "
                f"pick from the candidate set"))
    return findings


def check_stats_facades(device=None) -> list:
    """Instantiate one engine/fleet/region stack over the cheapest family
    and verify every facade's ``stats()`` carries the unified counters."""
    import torch

    from ..configs import get_config
    from ..device import resolve_device
    from ..models import get_model
    from ..obs import CANONICAL_STATS
    from ..region.gateway import RegionGateway
    from ..router.gateway import FleetGateway
    from ..serve.engine import ServeEngine

    dev = resolve_device(device)
    cfg = get_config("smollm-135m", reduced=True)
    model = get_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, dev)
    engine = ServeEngine(model, params, max_batch=2, max_seq=8)
    fleet = FleetGateway([engine])
    region = RegionGateway([fleet])
    findings = []
    for name, facade in (("ServeEngine", engine), ("FleetGateway", fleet),
                         ("RegionGateway", region)):
        stats = facade.stats()
        missing = [k for k in CANONICAL_STATS if k not in stats]
        if missing:
            findings.append(Finding(
                "stats-contract", SEVERITY_ERROR,
                "src/repro_torch/obs/__init__.py", 0,
                f"{name}.stats() is missing canonical counter(s) "
                f"{missing} — every scale's facade must expose "
                f"CANONICAL_STATS"))
    return findings


def _dedup(findings: list) -> list:
    seen, out = set(), []
    for f in findings:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            out.append(f)
    return out


def run_contracts(device=None) -> list:
    """The full layer-3 pass (cost models, policies, stats facades)."""
    return (check_cost_models() + check_search_policies()
            + check_stats_facades(device))
