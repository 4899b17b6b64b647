"""The device's work inside a whole prefill: per engine ``prefill`` span
inside the traced slice, mapped onto the profiler's clock by the tracer
(``SpanTracer.trace_ns``), the time in which any device operation ran
(the union of the trace's operations inside it); the median, in ms."""
from portbench.lib import profile, readers


def read(L):
    tr, loop = readers.trace(L), L.get("loop")
    if tr is None or not tr.ops or loop is None or loop.spans is None:
        return None
    trace_ns = getattr(loop.spans, "trace_ns", None)
    if trace_ns is None:         # a tracer that cannot map its clock
        return None
    busy = profile.merge((a, b) for _, a, b in tr.ops)
    out = []
    for e in loop.spans.events:
        if (e["name"] == "prefill" and L["t0"] <= e["ts"]
                and e["ts"] + e["dur"] <= L["t_close"]):
            lo, hi = trace_ns(e["ts"]), trace_ns(e["ts"] + e["dur"])
            if tr.lo <= lo and hi <= tr.hi:
                out.append(profile.covered(busy, lo, hi) / 1e9)
    return readers.ms_median(out)
