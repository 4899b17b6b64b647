"""What the per-layer readers (``portbench/metrics/<metric>.py``) share.
Each reader takes the driver's ``Result.layer`` dict and returns its
number, or None where the run gave it nothing to read (the metric is then
left out of the line; a share is never reported as 0 for want of data)."""

from __future__ import annotations

from ..counts import model, peaks
from . import stats


def steps(L: dict, traced: bool = False) -> list:
    loop = L.get("loop")
    if loop is None:
        return []
    return [s for s in loop.steps if s.traced or not traced]


def decode_steps(L: dict, traced: bool = False) -> list:
    return [s for s in steps(L, traced) if s.decode_wall is not None]


def chunks(L: dict, traced: bool = False) -> list:
    return [c for s in steps(L, traced) for c in s.chunks]


def ms_median(seconds) -> float | None:
    v = stats.median(seconds)
    return None if v is None else v * 1e3


def percent(num: float, den: float) -> float | None:
    return None if den <= 0 or num <= 0 else 100.0 * num / den


def trace(L: dict):
    tr = L.get("trace")
    return tr if tr is not None and tr.hi > tr.lo else None


def idle_share(L: dict) -> float | None:
    tr = trace(L)
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_ns() / (tr.hi - tr.lo))


def decode_flops_kept(L: dict) -> float:
    return sum(model.decode_flops(L["dims"], s.starts)
               for s in decode_steps(L))


def decode_rows(s, i: int, batch: int, smax: int) -> int:
    """Cache rows token step ``i`` of decode chunk ``s`` reads over the
    whole batch: a live slot at decode position ``p`` reads ``p + i + 1``
    (its position advances on the card through the chunk, even past a
    request's last kept token), an idle slot, held at position 0, reads
    ``i + 1``."""
    live = sum(min(p + i, smax - 1) + 1 for p, _ in s.starts)
    return live + (batch - len(s.starts)) * (i + 1)


def peak_share(flops: float, seconds: float) -> float | None:
    return percent(flops / peaks.BF16_FLOPS, seconds)
