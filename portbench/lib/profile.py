"""The traced run's device trace: ``torch.profiler`` over the last slice of
the window (it stops as the window closes, so its stop and the reading of
its events fall outside), its events kept in memory (no Chrome trace is
written), reduced here to what the per-layer readers need.

The harness marks its own phases with ``record_function("pb.<name>")``
(an engine step, the engine's admission and prefill chunk, a train step,
the whole slice), so device operations and host phases share the
profiler's one clock.  Busy time is the union of the device operations'
intervals (kernels, copies, sets): two operations that overlap on two
streams count once."""

from __future__ import annotations

import bisect
import contextlib

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def merge(intervals) -> list[tuple[int, int]]:
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged, lo: int, hi: int) -> int:
    """The length of ``[lo, hi)`` that ``merged`` (disjoint, sorted)
    covers."""
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in merged)


def on_device(event) -> bool:
    return str(event.device_type()).endswith("CUDA")


def is_device_op(event) -> bool:
    """A kernel, copy or set on the card.  PyTorch before 2.13 has no
    ``activity_type``: there every device event but the harness's phases'
    device copies (named ``pb.``) is one."""
    if not on_device(event):
        return False
    if hasattr(event, "activity_type"):
        return str(event.activity_type()) in DEVICE_KINDS
    return not event.name().startswith("pb.")


class Trace:
    """``start`` and ``stop`` around the slice; ``phase(name)`` marks a
    host phase while the profiler runs (a no-op otherwise).  After
    ``stop``: ``ops`` (name, start ns, end ns) of the device, ``phases``
    {name: [(start ns, end ns)]} of the host, ``lo`` / ``hi`` the slice."""

    def __init__(self):
        self.active = False
        self.ops: list[tuple[str, int, int]] = []
        self.phases: dict[str, list[tuple[int, int]]] = {}
        self.lo = self.hi = 0
        self._prof = None
        self._slice = None

    @staticmethod
    def _profiler():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self._prof = self._profiler()
        self._prof.__enter__()
        self._slice = torch.profiler.record_function("pb.slice")
        self._slice.__enter__()
        self.active = True

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        (CUPTI's) takes seconds, which would otherwise fall in the
        window."""
        with self._profiler():
            torch.zeros(1).add_(1)

    def phase(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"pb.{name}")

    def stop(self) -> None:
        self._slice.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        for e in self._prof.profiler.kineto_results.events():
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
            if is_device_op(e):
                self.ops.append((e.name(), t0, t1))
            elif e.name().startswith("pb.") and not on_device(e):
                self.phases.setdefault(e.name()[3:], []).append((t0, t1))
        self._prof = None
        self.ops.sort(key=lambda o: o[1])
        for v in self.phases.values():
            v.sort()
        (self.lo, self.hi), = self.phases.pop("slice")
        self.ops = [(n, max(a, self.lo), min(b, self.hi))
                    for n, a, b in self.ops if b > self.lo and a < self.hi]

    # -- reductions -------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def busy_ns(self, ops=None) -> int:
        """The slice's time in which any of ``ops`` (default all) ran."""
        ops = self.ops if ops is None else ops
        return covered(merge((a, b) for _, a, b in ops), self.lo, self.hi)

    @property
    def busy_s(self) -> float:
        return self.busy_ns() / 1e9

    def in_phase(self, name: str, ops=None) -> list[list[tuple[str, int, int]]]:
        """The device operations that start inside each range of phase
        ``name``, one list a range, in order."""
        ops = self.ops if ops is None else ops
        starts = [o[1] for o in ops]
        out = []
        for a, b in self.phases.get(name, []):
            i, j = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
            out.append(ops[i:j])
        return out

    def named(self, *parts: str, ops=None) -> list[tuple[str, int, int]]:
        """The operations whose name holds any of ``parts``."""
        ops = self.ops if ops is None else ops
        return [o for o in ops if any(p in o[0] for p in parts)]

    def label(self, t: int, order: tuple[str, ...]) -> str:
        """The first phase of ``order`` with a range holding ``t``, else
        ``harness``."""
        for name in order:
            ranges = self.phases.get(name, [])
            i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
            if i >= 0 and ranges[i][0] <= t < ranges[i][1]:
                return name
        return "harness"

    def device_ops(self, top: int = 10) -> list[list]:
        """Device time by operation name, most first."""
        total: dict[str, int] = {}
        for n, a, b in self.ops:
            total[n] = total.get(n, 0) + (b - a)
        best = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:120], v / 1e9] for n, v in best]

    def idle_gaps(self, order: tuple[str, ...], top: int = 10) -> list[list]:
        """Idle device time summed by the host phase it fell in (the first
        of ``order`` holding the gap's middle), most first."""
        merged = merge((a, b) for _, a, b in self.ops)
        edges = [self.lo] + [t for ab in merged for t in ab] + [self.hi]
        total: dict[str, int] = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                name = self.label((a + b) // 2, order)
                total[name] = total.get(name, 0) + (b - a)
        best = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[f"idle in {n}", v / 1e9] for n, v in best]
