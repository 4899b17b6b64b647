"""Chaos plane of the port: fault injection and reliable delivery for the
session transport, the counterpart of the JAX package's ``repro.chaos``.

* :class:`FaultInjector` (:mod:`repro_torch.chaos.faults`) — one seeded
  RNG + schedule producing deterministic per-link drop / corrupt /
  duplicate / delay draws, step-windowed partitions, and replica
  crash/restart;
* :class:`ChaosTransport` (:mod:`repro_torch.chaos.transport`) — applies
  an injector's plan to any inner transport;
* :class:`ReliableTransport` (:mod:`repro_torch.chaos.reliable`) — retry
  with capped exponential backoff + jitter, CRC verification of delivered
  bytes, typed :class:`DeliveryError` on budget exhaustion.

Typical wiring, innermost first::

    loop = LoopbackTransport()
    chaos = ChaosTransport(loop, FaultInjector(seed=7).default_link(
        drop=0.05, corrupt=0.02))
    transport = ReliableTransport(chaos, max_attempts=6, seed=7)

Exactly-once semantics come from pairing this at-least-once sender with
the idempotent receiver: sessions carry a ``(origin, rid, epoch)``
delivery id on the wire (v4) and adopting gateways dedup on it.  All of it
is host-side Python: the same seed gives the JAX package's fault sequence
draw for draw.
"""

from .faults import FaultInjector, LinkPlan
from .reliable import DeliveryError, ReliableTransport
from .transport import ChaosTransport

__all__ = [
    "ChaosTransport",
    "DeliveryError",
    "FaultInjector",
    "LinkPlan",
    "ReliableTransport",
]
