"""The engine's own host work a step: per ``step`` span in the window
(``ServeEngine.step``), its duration less the part of it that its
children cover (``prefill``, ``prefill-chunk``, ``decode.launch``,
``decode.wait``, and ``trace.record``, the tracer's own recording, on its
track at its index): slotting, re-uploads, the token loop, finishing,
gauges, the PTT; the median, in ms."""
from portbench.lib import profile, readers

CHILDREN = ("prefill", "prefill-chunk", "decode.launch", "decode.wait",
            "trace.record")


def read(L):
    loop = L.get("loop")
    if loop is None or loop.spans is None:
        return None
    events = list(loop.spans.events)
    kids: dict = {}
    for e in events:
        if e["name"] in CHILDREN and "step" in e["args"]:
            kids.setdefault((e["track"], e["args"]["step"]), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    own = []
    for e in events:
        if (e["name"] == "step" and L["t0"] <= e["ts"]
                and e["ts"] + e["dur"] <= L["t_close"]):
            lo, hi = e["ts"], e["ts"] + e["dur"]
            inside = profile.merge(kids.get((e["track"], e["args"]["step"]),
                                            []))
            own.append(e["dur"] - profile.covered(inside, lo, hi))
    return readers.ms_median(own)
