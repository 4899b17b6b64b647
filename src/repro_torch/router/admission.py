"""SLO-aware admission control.

Per request class an SLO gives the TTFT budget and (optionally) a TPOT
budget.  The admission decision compares the FleetPTT's *predictions* on
the chosen replica against those budgets:

* TTFT: learned per-prompt-token service estimate x prompt size x queue
  backlog (see :meth:`FleetPTT.predict_ttft`);
* TPOT: the replica's decode-step latency row — a replica that decodes
  slowly (straggler mid-quarantine, overloaded batch) blows the
  time-per-output-token budget even when its prefill looks fine.

Each budget maps to a severity — ADMIT within the SLO, QUEUE within
``patience`` x SLO, SHED beyond — and the request takes the *worst* of the
two, so either a hopeless TTFT or a hopeless TPOT sheds it.

Untrained PTT entries predict 0.0, so bootstrap traffic is always admitted
— the same optimism that makes the paper's untrained entries globally
optimal until visited.

Classes also carry a **priority** (higher = more important), and tenants a
**weight** (higher = larger protected share).  When load must be dropped
the gateway sheds the lowest class priority first and, within a priority,
the tenant with the lowest *shed debt* — each shed costs its tenant
``weight`` debt, so over time shed counts split inversely to the weights
(weighted fair shedding) instead of whichever tenant happens to sit at the
head of the queue.

This is the PyTorch port's copy of ``repro.router.admission``: host-side
Python and numpy, the same logic; only the imports differ.
"""

from __future__ import annotations

import dataclasses
import enum

from ..serve.scheduler import RequestClass


class Admission(enum.Enum):
    ADMIT = "admit"
    QUEUE = "queue"
    SHED = "shed"


# severity order for combining per-budget outcomes
_SEVERITY = {Admission.ADMIT: 0, Admission.QUEUE: 1, Admission.SHED: 2}
_BY_SEVERITY = [Admission.ADMIT, Admission.QUEUE, Admission.SHED]

# default class priorities: interactive prefill traffic outranks
# generation-heavy batch-style turns
_DEFAULT_PRIORITY = {RequestClass.PREFILL_SHORT: 2,
                     RequestClass.PREFILL_LONG: 1,
                     RequestClass.DECODE: 0}


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    ttft: dict[RequestClass, float]
    patience: float = 3.0           # queue head-room as a multiple of slo
    tpot: dict[RequestClass, float] | None = None   # None = no TPOT budget
    priority: dict[RequestClass, int] | None = None  # None = default order
    tenant_weight: dict | None = None   # tenant id -> share weight (>0);
                                        # None/missing = 1.0 (equal shares)

    @classmethod
    def default(cls) -> "SLOPolicy":
        inf = float("inf")
        return cls(ttft={RequestClass.PREFILL_SHORT: 0.5,
                         RequestClass.PREFILL_LONG: 2.0,
                         RequestClass.DECODE: 4.0},
                   tpot={RequestClass.PREFILL_SHORT: inf,
                         RequestClass.PREFILL_LONG: inf,
                         RequestClass.DECODE: 5.0})

    @classmethod
    def unlimited(cls) -> "SLOPolicy":
        """No shedding/queueing — for baselines and A/B comparisons."""
        inf = float("inf")
        return cls(ttft={c: inf for c in RequestClass},
                   tpot={c: inf for c in RequestClass})

    def tpot_budget(self, req_class: RequestClass) -> float:
        if self.tpot is None:
            return float("inf")
        return self.tpot.get(req_class, float("inf"))

    def priority_of(self, req_class: RequestClass) -> int:
        """Classes missing from a partial ``priority`` map keep their
        default rank (a user overriding one class must not silently demote
        the others to the bottom)."""
        if self.priority is None:
            return _DEFAULT_PRIORITY[req_class]
        return self.priority.get(req_class, _DEFAULT_PRIORITY[req_class])

    def weight_of(self, tenant) -> float:
        """A tenant's share weight; unknown tenants weigh 1.0.  A shed
        charges the victim's tenant ``weight`` debt, and the gateway sheds
        from the lowest-debt tenant first — so a weight-3 tenant ends up
        shedding ~1/3 as often as a weight-1 tenant."""
        if self.tenant_weight is None:
            return 1.0
        return float(self.tenant_weight.get(tenant, 1.0))


class AdmissionController:
    """Counters track each request's *current* outcome: ``decide`` counts a
    first-time decision; a gateway re-evaluating a held request uses
    ``evaluate`` (pure) and moves the count with ``reclassify`` when the
    outcome changes, so sustained queuing doesn't inflate the stats."""

    def __init__(self, policy: SLOPolicy | None = None):
        self.policy = policy or SLOPolicy.default()
        self.admitted = {c: 0 for c in RequestClass}
        self.queued = {c: 0 for c in RequestClass}
        self.shed = {c: 0 for c in RequestClass}

    def _budget_severity(self, predicted: float, budget: float) -> int:
        if predicted <= budget:
            return _SEVERITY[Admission.ADMIT]
        if predicted <= self.policy.patience * budget:
            return _SEVERITY[Admission.QUEUE]
        return _SEVERITY[Admission.SHED]

    def evaluate(self, req_class: RequestClass, predicted_ttft: float,
                 predicted_tpot: float = 0.0) -> Admission:
        sev = max(
            self._budget_severity(predicted_ttft,
                                  self.policy.ttft[req_class]),
            self._budget_severity(predicted_tpot,
                                  self.policy.tpot_budget(req_class)))
        return _BY_SEVERITY[sev]

    def _bucket(self, a: Admission) -> dict[RequestClass, int]:
        return {Admission.ADMIT: self.admitted, Admission.QUEUE: self.queued,
                Admission.SHED: self.shed}[a]

    def count(self, req_class: RequestClass, action: Admission) -> None:
        """Record an outcome decided outside ``decide`` (e.g. a probe
        dispatch that bypasses the SLO check)."""
        self._bucket(action)[req_class] += 1

    def decide(self, req_class: RequestClass, predicted_ttft: float,
               predicted_tpot: float = 0.0) -> Admission:
        a = self.evaluate(req_class, predicted_ttft, predicted_tpot)
        self.count(req_class, a)
        return a

    def reclassify(self, req_class: RequestClass, frm: Admission,
                   to: Admission) -> None:
        self._bucket(frm)[req_class] -= 1
        self._bucket(to)[req_class] += 1

    def counts(self) -> dict[str, dict[RequestClass, int]]:
        return {"admitted": dict(self.admitted), "queued": dict(self.queued),
                "shed": dict(self.shed)}
