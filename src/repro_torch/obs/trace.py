"""Request span tracer — one causal timeline per request, across engines,
fleets, regions, and the wire.

The serving stack routes a request through up to four scales (engine slot,
fleet replica, region fleet, WAN link); when something looks slow, the
question is "where did *this request's* time go", and the answer must
survive a live-session migration.  The tracer keeps an append-only event
log where every event carries

* a **trace id** — the request's causal identity.  Bound per ``rid`` at
  first touch (``trace_for``), carried inside the session wire format
  across process/WAN boundaries, and re-bound (``adopt``) on the far side,
  so a migrated request keeps ONE timeline spanning both replicas;
* a **track** — where the event happened (an engine, a gateway, a link):
  the thread row in the exported view;
* a monotonic **timestamp** (``time.perf_counter`` by default) and, for
  spans, a duration.

Export is Chrome trace-event JSON (:meth:`SpanTracer.chrome_trace`), the
format Perfetto / ``chrome://tracing`` load directly: traces map to
processes, tracks to threads, spans to complete ``X`` events and instants
to ``i`` events, with ``M`` metadata naming both.

The default everywhere is :data:`NULL_TRACER`: a no-op whose ``enabled``
flag lets hot paths skip even argument construction — the engine's step
pays a few attribute checks.  The port's tracing cost is measured on the
card by the benchmark (``portbench/``): its untraced runs (``--trace 0``),
compared commit against commit, carry the null tracer's cost, and
``PERF.md`` gives ``output_tok_s`` with the tracer on against off.

Two additions serve the device trace.  :meth:`SpanTracer.trace_ns` maps a
span's timestamp onto ``torch.profiler``'s clock (an event's
``start_ns()``, Unix nanoseconds) through ``(clock, time.time_ns())``
pairs the engine stamps at the top of every traced step
(:meth:`SpanTracer.anchor`), so a program span can be laid beside the
kernels and idle gaps the profiler saw.  And :func:`model_spans` hands a
tracer to the model bodies without a parameter: inside it,
:func:`model_span` records a span per layer boundary; outside it (graph
captures and replays, training, every untraced run) a span call is one
``ContextVar.get`` and a shared ``nullcontext``.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import json
import time
from collections import deque
from typing import Callable

#: Anchors a tracer keeps; past it the older half goes (one a traced
#: engine step: hours of steps).
ANCHOR_CAP = 1 << 16


class NullTracer:
    """No-op tracer: the default exporter.  ``enabled`` is False so
    instrumented code can skip building event arguments entirely —
    ``if tracer.enabled:`` is the whole hot-path cost."""

    enabled = False

    def trace_for(self, rid) -> None:
        return None

    def adopt(self, rid, trace_id) -> None:
        pass

    def instant(self, name, trace=None, track=None, **args) -> None:
        pass

    def set_tick(self, tick) -> None:
        pass

    def complete(self, name, trace=None, track=None, *, ts=0.0, dur=0.0,
                 **args) -> None:
        pass

    def span(self, name, trace=None, track=None, **args):
        return contextlib.nullcontext()


#: Shared no-op default — identity-compared by gateways when deciding
#: whether to propagate a real tracer downward.
NULL_TRACER = NullTracer()


class SpanTracer:
    """Append-only span/event recorder with Chrome trace-event export.

    ``name`` prefixes auto-minted trace ids (``{name}/r{rid}``) so two
    tracers in different processes never collide; ``clock`` must be
    monotonic (defaults to ``time.perf_counter``); ``cap`` bounds the
    event log (oldest evicted) so a long-lived server cannot leak.

    ``sample_rate`` traces 1-in-N requests: :meth:`trace_for` returns
    ``None`` for sampled-out rids (the decision is sticky per rid), and
    request-bound recording calls whose ``trace`` is ``None`` are dropped
    — instrumented code can keep passing ``trace_for``'s result straight
    through without its own guard.  Two invariants make sampling safe at
    production rates: (a) ``sample_rate=1`` (the default) is
    behavior-identical to the unsampled tracer — ``trace=None`` events
    keep falling back to the tracer-level timeline; (b) :meth:`adopt`
    force-binds regardless of the local sampling decision, so a sampled
    request that migrates in from another host keeps its full
    cross-boundary timeline — the origin's sampling verdict travels with
    the session, never re-rolled downstream.
    """

    enabled = True

    def __init__(self, name: str = "t0",
                 clock: Callable[[], float] = time.perf_counter,
                 cap: int = 200_000, sample_rate: int = 1):
        if sample_rate < 1:
            raise ValueError(f"sample_rate must be >= 1, got {sample_rate}")
        self.name = name
        self.clock = clock
        self.sample_rate = int(sample_rate)
        self.events: deque[dict] = deque(maxlen=cap)
        self._bind: dict = {}            # rid -> trace id (None: sampled out)
        self.tick: int | None = None     # current pump tick (set_tick)
        self._anchor_ts: list[float] = []    # clock readings (anchor) ...
        self._anchor_ns: list[int] = []      # ... and Unix ns beside them

    # -- logical clock -----------------------------------------------------
    def set_tick(self, tick: int) -> None:
        """Advance the tracer's pump-tick logical clock.  The owning
        gateway calls this at the top of each pump; instants recorded
        until the next call carry this tick, so they join time-series
        samples (stamped with the same tick) on one clock even when a
        chaos-delayed delivery skews their wall timestamps."""
        self.tick = tick

    # -- the device trace's clock ------------------------------------------
    def anchor(self) -> None:
        """Stamp one pair of this tracer's clock and ``time.time_ns()``
        (the midpoint of two reads around the clock's), the mapping
        :meth:`trace_ns` takes from here on.  Recording never calls it,
        so a scripted clock sees no extra read."""
        u0 = time.time_ns()
        ts = self.clock()
        u1 = time.time_ns()
        if len(self._anchor_ts) >= ANCHOR_CAP:
            del self._anchor_ts[:ANCHOR_CAP // 2]
            del self._anchor_ns[:ANCHOR_CAP // 2]
        self._anchor_ts.append(ts)
        self._anchor_ns.append((u0 + u1) // 2)

    def trace_ns(self, ts: float) -> int:
        """``ts`` on this tracer's clock as ``torch.profiler`` stamps the
        same moment (an event's ``start_ns()``: Unix nanoseconds), through
        the last anchor at or before ``ts`` (the first, for an earlier
        ``ts``; one is stamped now if there is none)."""
        if not self._anchor_ts:
            self.anchor()
        i = max(bisect.bisect_right(self._anchor_ts, ts) - 1, 0)
        return self._anchor_ns[i] + round((ts - self._anchor_ts[i]) * 1e9)

    # -- trace identity ----------------------------------------------------
    def trace_for(self, rid) -> str | None:
        """The trace id bound to ``rid`` (minted on first touch), or
        ``None`` when sampling dropped this rid.  Every scale calls this
        instead of formatting ids itself, so an adopted binding (a
        migrated-in session) wins over re-derivation — including over a
        local sampled-out verdict."""
        if rid in self._bind:
            return self._bind[rid]
        if self.sample_rate > 1:
            key = rid if isinstance(rid, int) else hash(rid)
            if key % self.sample_rate != 0:
                self._bind[rid] = None   # sticky: every later touch agrees
                return None
        tid = self._bind[rid] = f"{self.name}/r{rid}"
        return tid

    def adopt(self, rid, trace_id: str) -> None:
        """Bind ``rid`` to a trace id carried in from another tracer (the
        session wire format's trace-context field): subsequent events on
        this host continue the request's original timeline.  Force-binds
        over any local sampling verdict — the wire only carries a trace
        context for requests the origin sampled IN, and dropping their
        tail here would truncate exactly the timelines sampling kept."""
        self._bind[rid] = trace_id

    # -- recording ---------------------------------------------------------
    def _dropped(self, trace) -> bool:
        # a None trace under sampling is a sampled-out request's event;
        # under sample_rate=1 it is the legacy "tracer-level timeline"
        return trace is None and self.sample_rate > 1

    def instant(self, name: str, trace: str | None = None,
                track: str | None = None, **args) -> None:
        """A point event (admit/shed/quarantine/...)."""
        if self._dropped(trace):
            return
        self.events.append({"name": name, "ph": "i", "ts": self.clock(),
                            "trace": trace or self.name,
                            "track": track or self.name, "args": args,
                            "tick": self.tick})

    def complete(self, name: str, trace: str | None = None,
                 track: str | None = None, *, ts: float, dur: float,
                 **args) -> None:
        """A span recorded after the fact (caller measured ``ts``/``dur``
        itself — the engine's decode chunk, a WAN ship)."""
        if self._dropped(trace):
            return
        self.events.append({"name": name, "ph": "X", "ts": ts,
                            "dur": max(dur, 0.0),
                            "trace": trace or self.name,
                            "track": track or self.name, "args": args})

    @contextlib.contextmanager
    def span(self, name: str, trace: str | None = None,
             track: str | None = None, **args):
        """Context-manager span: records one complete event on exit."""
        if self._dropped(trace):
            yield
            return
        t0 = self.clock()
        try:
            yield
        finally:
            self.complete(name, trace, track, ts=t0,
                          dur=self.clock() - t0, **args)

    # -- views -------------------------------------------------------------
    def timeline(self, trace_id: str) -> list[dict]:
        """All events of one trace in timestamp order — 'where did this
        request's time go', across every track it touched."""
        return sorted((e for e in self.events if e["trace"] == trace_id),
                      key=lambda e: e["ts"])

    def tracks(self, trace_id: str) -> list[str]:
        """Distinct tracks a trace touched, in first-appearance order —
        a migrated request lists both replicas."""
        seen: dict[str, None] = {}
        for e in self.timeline(trace_id):
            seen.setdefault(e["track"], None)
        return list(seen)

    # -- export ------------------------------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable): one *process* per
        trace id, one *thread* per track, ``X`` spans / ``i`` instants in
        microseconds relative to the earliest event, plus ``M`` metadata
        events naming both axes."""
        events = sorted(self.events, key=lambda e: e["ts"])
        if not events:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        t0 = events[0]["ts"]
        pids: dict[str, int] = {}
        tids: dict[str, int] = {}
        out: list[dict] = []
        for e in events:
            pid = pids.setdefault(e["trace"], len(pids))
            tid = tids.setdefault(e["track"], len(tids))
            args = e["args"]
            if e.get("tick") is not None:
                # pump tick rides along so the viewer shows the logical
                # clock that time-series samples share
                args = dict(args, pump_tick=e["tick"])
            ev = {"name": e["name"], "ph": e["ph"], "pid": pid, "tid": tid,
                  "ts": round((e["ts"] - t0) * 1e6, 3), "args": args}
            if e["ph"] == "X":
                ev["dur"] = round(e["dur"] * 1e6, 3)
            else:
                ev["s"] = "t"            # instant scope: thread
            out.append(ev)
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": trace}} for trace, pid in pids.items()]
        meta += [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                  "args": {"name": track}} for track, tid in tids.items()]
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1, sort_keys=True)


# -- the model bodies' spans -------------------------------------------------

#: (tracer, trace, track, args) the model bodies record into, or None.
_MODEL: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_model_spans", default=None)
_NO_SPAN = contextlib.nullcontext()      # stateless: shared by every call


@contextlib.contextmanager
def model_spans(tracer, trace: str | None = None, track: str | None = None,
                **args):
    """While the block runs, :func:`model_span` records into ``tracer``
    on ``trace`` and ``track``, each span carrying ``args`` (the engine's
    step index).  ``tracer`` None unsets it: a graph cell's build runs so,
    so no captured body holds a span call."""
    token = _MODEL.set(None if tracer is None
                       else (tracer, trace, track, args))
    try:
        yield
    finally:
        _MODEL.reset(token)


def model_span(name: str):
    """A span at a layer boundary of a model body (``attn``,
    ``moe.route`` ...), recorded only inside :func:`model_spans`."""
    ctx = _MODEL.get()
    if ctx is None:
        return _NO_SPAN
    tracer, trace, track, base = ctx
    return tracer.span(name, trace, track, **base)
