"""Fleet router of the port: PTT-driven multi-replica serving gateway —
the port's copy of ``repro.router``.

The paper's scheduler at its third scale — cores -> device groups ->
serving replicas — with interference detection and SLO-aware admission.
Cost models and search policies come from
:mod:`repro_torch.core.tracetable` (re-exported here for router
configuration convenience).
"""

from ..core.tracetable import (CostModel, Latency, MigrationCost, Occupancy,
                               QueueAware, TraceTable, WanCost)
from .admission import Admission, AdmissionController, SLOPolicy
from .fleet_ptt import FleetPTT
from .gateway import DuplicateDelivery, FleetGateway
from .interference import InterferenceConfig, InterferenceDetector
from .router import FleetRouter, RouteDecision

__all__ = [
    "Admission", "AdmissionController", "SLOPolicy",
    "DuplicateDelivery", "FleetPTT", "FleetGateway",
    "InterferenceConfig", "InterferenceDetector",
    "FleetRouter", "RouteDecision",
    "CostModel", "Latency", "MigrationCost", "Occupancy", "QueueAware",
    "TraceTable", "WanCost",
]
