"""Fault-applying transport decorator: the port's copy of
``repro/chaos/transport.py``, host-side and free of torch, so a seed gives
the JAX package's fault sequence.

:class:`ChaosTransport` wraps any inner
:class:`~repro_torch.region.transport.Transport` and applies one
:class:`~repro_torch.chaos.faults.FaultInjector`'s plan to every ship, in
a fixed order so the RNG consumption — and therefore the whole fault
sequence — is reproducible from the seed:

1. **drop / partition** → raise
   :class:`~repro_torch.region.transport.ShipDropped` *after* charging the
   inner transport (the bytes left the source; they died on the wire —
   egress accounting still sees them);
2. **corrupt** → flip one seeded bit in the delivered copy (the sender's
   buffer is never mutated: retries resend clean bytes);
3. **duplicate** → queue a second delivery of the same payload on
   :attr:`pending`; the receiving gateway drains it via
   :meth:`take_duplicates` on its next pump, which is exactly the
   retransmission race exactly-once dedup must absorb;
4. **delay** → add seconds to the reported ``rtt_s`` (simulated, never a
   real sleep).

The wrapper holds no fault state of its own — schedule and RNG live in
the injector, so one injector can drive several transports (region +
fleet tiers) off a single seed.
"""

from __future__ import annotations

from ..region.transport import ShipDropped, Transport
from .faults import FaultInjector


class ChaosTransport(Transport):
    """Applies ``injector``'s fault plan to every ship on ``inner``."""

    def __init__(self, inner: Transport, injector: FaultInjector):
        self.inner = inner
        self.injector = injector
        # queued duplicate deliveries: (src, dst, payload-as-delivered)
        self.pending: list[tuple[int, int, bytes]] = []

    def ship(self, data: bytes, src: int, dst: int) -> tuple[bytes, float]:
        delivered, rtt = self.inner.ship(data, src, dst)
        inj = self.injector
        reason = inj.draw_drop(src, dst)
        if reason is not None:
            raise ShipDropped(src, dst, reason)
        bit = inj.draw_corrupt(src, dst, len(delivered))
        if bit is not None:
            buf = bytearray(delivered)
            buf[bit // 8] ^= 1 << (bit % 8)
            delivered = bytes(buf)
        if inj.draw_duplicate(src, dst):
            self.pending.append((src, dst, delivered))
        rtt += inj.draw_delay(src, dst)
        self.last_rtt_s = rtt        # deprecated mirror, kept coherent
        return delivered, rtt

    def take_duplicates(self) -> list[tuple[int, int, bytes]]:
        """Drain queued duplicate deliveries (receiver pump calls this)."""
        dup, self.pending = self.pending, []
        return dup

    def stats(self) -> dict:
        return {"pending_duplicates": len(self.pending),
                **self.injector.stats()}
