"""Cross-region serving fabric of the port: the Performance Trace Table's
fourth scale, the counterpart of the JAX package's ``repro.region``.

A :class:`RegionRouter` places requests over N
:class:`~repro_torch.router.FleetGateway` fleets with the same
TraceTable / CostModel / SearchPolicy machinery every other scale uses,
plus a :class:`~repro_torch.core.tracetable.WanCost` term (learned
per-link RTT EMA rows + per-byte egress) that makes leaving the ingress
region pay for the hop.  Underneath it, the remote session transport: a
versioned byte wire format for live sessions
(:mod:`repro_torch.region.wire`) riding a pluggable :class:`Transport`
(:mod:`repro_torch.region.transport`), which is how a
:class:`RegionGateway` drains a browned-out fleet's live sessions
cross-region without in-process object handoff.
"""

from ..core.tracetable import WanCost
from .gateway import RegionGateway
from .router import RegionDecision, RegionRouter
from .transport import (DeliveryError, LoopbackTransport, ShipDropped,
                        Transport, TransportError)
from .wire import (WIRE_COMPAT, WIRE_MAGIC, WIRE_VERSION, WireFormatError,
                   decode_session, encode_session, verify_crc, wire_header)

__all__ = [
    "RegionDecision", "RegionGateway", "RegionRouter",
    "DeliveryError", "LoopbackTransport", "ShipDropped", "Transport",
    "TransportError", "WanCost",
    "WIRE_COMPAT", "WIRE_MAGIC", "WIRE_VERSION", "WireFormatError",
    "decode_session", "encode_session", "verify_crc", "wire_header",
]
