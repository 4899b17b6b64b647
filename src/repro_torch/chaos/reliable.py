"""Reliable delivery: retry with capped exponential backoff + jitter; the
port's copy of ``repro/chaos/reliable.py``, host-side and free of torch.

:class:`ReliableTransport` decorates any :class:`~repro_torch.region.
transport.Transport` with an attempt budget.  Two failure classes are
retryable:

* :class:`~repro_torch.region.transport.ShipDropped` — the attempt never
  arrived (drop, timeout, partition);
* a delivered payload whose RSES header or body CRC does not verify —
  the wire format's checksum finally pays for itself: corruption is
  detected *here*, before the payload reaches ``decode_session``, and
  the sender simply resends its (still clean) buffer.

Between attempts the sender backs off ``base * 2**attempt`` seconds,
capped at ``max_backoff``, plus seeded jitter in ``[0, jitter)`` — the
textbook shape that keeps N retrying senders from re-colliding in
lockstep.  The backoff is **simulated**: it is added to the reported
``rtt_s`` (the region router's RTT EMA should see retry cost — a flaky
link IS a slow link) instead of sleeping, so chaos tests run at full
speed and stay deterministic.

After ``max_attempts`` failures the caller gets a typed
:class:`DeliveryError` carrying the link and the last cause — never a
hang, never a silent loss: the session bytes are still in the caller's
hands, and the gateway's degradation ladder (re-rank next candidate,
else resume locally) takes over.

Every attempt and outcome lands in the telemetry plane
(:mod:`repro_torch.obs`) when :meth:`ReliableTransport.attach_obs` is
called: ``chaos_*`` counters in
the metric registry and per-rid ``chaos/delivery`` spans in the tracer.
"""

from __future__ import annotations

import random

# DeliveryError lives in the transport contract module (alongside
# ShipDropped) so the region gateway can catch it without importing this
# package; re-exported here because it is this class that raises it.
from ..region.transport import (DeliveryError, ShipDropped, Transport,
                                TransportError)
from ..region.wire import WireFormatError, wire_header, verify_crc


class ReliableTransport(Transport):
    """Retry/backoff decorator over an unreliable inner transport."""

    def __init__(self, inner: Transport, *, max_attempts: int = 4,
                 base_backoff: float = 0.05, max_backoff: float = 1.0,
                 jitter: float = 0.02, seed: int = 0,
                 verify: bool = True):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.inner = inner
        self.max_attempts = int(max_attempts)
        self.base_backoff = float(base_backoff)
        self.max_backoff = float(max_backoff)
        self.jitter = float(jitter)
        self.verify = verify
        self.rng = random.Random(seed)
        self.counts = {"attempts": 0, "delivered": 0, "retries": 0,
                       "drops": 0, "corrupt": 0, "exhausted": 0}
        self._attempts_c = None
        self._retries_c = None
        self._exhausted_c = None
        self._backoff_h = None
        self.tracer = None

    def attach_obs(self, registry=None, tracer=None) -> None:
        """Resolve metric children once (hot-path rule) and keep the
        tracer for per-delivery spans."""
        if registry is not None:
            self._attempts_c = registry.counter(
                "chaos_ship_attempts_total",
                "ship attempts including retries")
            self._retries_c = registry.counter(
                "chaos_ship_retries_total",
                "ship attempts after the first")
            self._exhausted_c = registry.counter(
                "chaos_delivery_exhausted_total",
                "deliveries that spent the whole retry budget")
            self._backoff_h = registry.histogram(
                "chaos_backoff_seconds",
                "simulated backoff before each retry")
        self.tracer = tracer

    def _backoff(self, attempt: int) -> float:
        b = min(self.base_backoff * (2.0 ** attempt), self.max_backoff)
        if self.jitter > 0.0:
            b += self.rng.random() * self.jitter
        return b

    def ship(self, data: bytes, src: int, dst: int) -> tuple[bytes, float]:
        """Deliver ``data`` intact or raise :class:`DeliveryError`.

        The reported ``rtt_s`` is the *total* delivery time: every failed
        attempt's rtt plus the simulated backoff — so the router's RTT
        rows learn that a lossy link costs more than its raw latency."""
        tracer = self.tracer
        total_rtt = 0.0
        cause: Exception | None = None
        # bounded for-loop, not while-True: the attempt cap IS the loop
        for attempt in range(self.max_attempts):
            self.counts["attempts"] += 1
            if self._attempts_c is not None:
                self._attempts_c.inc()
            if attempt > 0:
                back = self._backoff(attempt - 1)
                total_rtt += back
                self.counts["retries"] += 1
                if self._retries_c is not None:
                    self._retries_c.inc()
                if self._backoff_h is not None:
                    self._backoff_h.observe(back)
            try:
                delivered, rtt = self.inner.ship(data, src, dst)
                total_rtt += rtt
            except ShipDropped as e:
                self.counts["drops"] += 1
                cause = e
                if tracer is not None and tracer.enabled:
                    tracer.instant("chaos/drop", None, "chaos/delivery",
                                   src=src, dst=dst, attempt=attempt,
                                   reason=e.reason)
                continue
            if self.verify:
                try:
                    # header + CRC only — never decode the body here
                    wire_header(delivered)
                    verify_crc(delivered)
                except WireFormatError as e:
                    self.counts["corrupt"] += 1
                    cause = e
                    if tracer is not None and tracer.enabled:
                        tracer.instant("chaos/corrupt", None,
                                       "chaos/delivery", src=src, dst=dst,
                                       attempt=attempt)
                    continue
            self.counts["delivered"] += 1
            self.last_rtt_s = total_rtt   # deprecated mirror
            return delivered, total_rtt
        self.counts["exhausted"] += 1
        if self._exhausted_c is not None:
            self._exhausted_c.inc()
        if tracer is not None and tracer.enabled:
            tracer.instant("chaos/exhausted", None, "chaos/delivery",
                           src=src, dst=dst, attempts=self.max_attempts)
        raise DeliveryError(src, dst, self.max_attempts,
                            cause if cause is not None
                            else TransportError("no attempt made"))

    def take_duplicates(self) -> list[tuple[int, int, bytes]]:
        """Pass-through to the inner transport's duplicate queue (the
        chaos layer's retransmission race) so a gateway holding only the
        reliable decorator can still drain it."""
        take = getattr(self.inner, "take_duplicates", None)
        return take() if take is not None else []

    def stats(self) -> dict:
        return dict(self.counts)
