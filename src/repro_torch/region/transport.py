"""Byte transport between fleets: the port's counterpart of
``repro/region/transport.py``.

A session crosses a boundary as :func:`~repro_torch.region.wire.encode_session`
bytes on a :class:`Transport` and is rebuilt by
:func:`~repro_torch.region.wire.decode_session` on the far side; the wire
format is the contract, so swapping the in-process
:class:`LoopbackTransport` for a socket transport changes nothing above it.

:class:`LoopbackTransport` delivers the payload unchanged within the
process, keeps per-link byte and ship counters, and can report a simulated
per-link delivery time (``link_rtt``) without sleeping.

Failure surface: a transport that cannot deliver raises
:class:`ShipDropped` (one lost attempt, retryable) or another
:class:`TransportError`; :class:`DeliveryError` is a whole delivery that
failed after a sender's retry budget.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable


class TransportError(RuntimeError):
    """A transport-level delivery failure (as opposed to a payload-level
    :class:`~repro_torch.region.wire.WireFormatError`)."""


class ShipDropped(TransportError):
    """One ship attempt was lost in flight (drop, timeout, partition).
    Retryable: the sender still holds the payload bytes."""

    def __init__(self, src: int, dst: int, reason: str = "dropped"):
        super().__init__(f"ship {src}->{dst} {reason}")
        self.src = src
        self.dst = dst
        self.reason = reason


class DeliveryError(TransportError):
    """A whole delivery failed: every attempt in the sender's retry
    budget was lost or corrupt (raised by a reliable-delivery layer
    after its ``max_attempts``).  The payload never arrived intact: the
    caller still owns it and must degrade (re-rank the next candidate,
    else resume locally)."""

    def __init__(self, src: int, dst: int, attempts: int,
                 cause: Exception):
        super().__init__(
            f"delivery {src}->{dst} failed after {attempts} attempts "
            f"(last: {cause})")
        self.src = src
        self.dst = dst
        self.attempts = attempts
        self.cause = cause


class Transport:
    """Moves one encoded payload from fleet ``src`` to fleet ``dst``.

    ``ship`` returns ``(payload, rtt_s)``: the bytes as delivered at the
    destination (a real transport returns what arrived; a simulating one
    may return the input unchanged) and that ship's delivery time — the
    sample the region router trains its per-link RTT EMA rows with.
    (The reference's deprecated ``last_rtt_s`` mirror, racy when two
    gateways share a transport, is not carried over.)"""

    def ship(self, data: bytes, src: int, dst: int) -> tuple[bytes, float]:
        raise NotImplementedError


class LoopbackTransport(Transport):
    """In-process delivery with optional simulated link latency.

    ``link_rtt(src, dst) -> seconds`` (when given) is returned as each
    ship's ``rtt_s`` without sleeping — deterministic RTT training for
    tests and benchmarks.  Without it, the RTT is 0.0 (an in-process hop
    is free; real socket transports report measured wall time)."""

    def __init__(self,
                 link_rtt: Callable[[int, int], float] | None = None):
        self.link_rtt = link_rtt
        self.bytes_by_link: dict[tuple[int, int], int] = defaultdict(int)
        self.ships_by_link: dict[tuple[int, int], int] = defaultdict(int)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_link.values())

    @property
    def total_ships(self) -> int:
        return sum(self.ships_by_link.values())

    def ship(self, data: bytes, src: int, dst: int) -> tuple[bytes, float]:
        self.bytes_by_link[(src, dst)] += len(data)
        self.ships_by_link[(src, dst)] += 1
        rtt = (float(self.link_rtt(src, dst))
               if self.link_rtt is not None else 0.0)
        return data, rtt
