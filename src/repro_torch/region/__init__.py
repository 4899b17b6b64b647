"""The session transport of the region tier: a versioned byte wire format
for live sessions (:mod:`repro_torch.region.wire`) riding a pluggable
:class:`Transport` (:mod:`repro_torch.region.transport`).  The region
router and gateway are not ported yet (ROADMAP A6)."""

from .transport import (DeliveryError, LoopbackTransport, ShipDropped,
                        Transport, TransportError)
from .wire import (WIRE_COMPAT, WIRE_MAGIC, WIRE_VERSION, WireFormatError,
                   decode_session, encode_session, verify_crc, wire_header)

__all__ = [
    "DeliveryError", "LoopbackTransport", "ShipDropped", "Transport",
    "TransportError",
    "WIRE_COMPAT", "WIRE_MAGIC", "WIRE_VERSION", "WireFormatError",
    "decode_session", "encode_session", "verify_crc", "wire_header",
]
