"""The PTT's host time a step: the window's ``step`` spans' summed
``ptt_ns`` (``ServeEngine._ptt``: every ``schedule_*`` and ``record``
call, counted and timed around the call) over those steps, in us."""


def read(L):
    loop = L.get("loop")
    if loop is None or loop.spans is None:
        return None
    ns = [e["args"]["ptt_ns"] for e in loop.spans.events
          if e["name"] == "step" and "ptt_ns" in e["args"]
          and L["t0"] <= e["ts"] and e["ts"] + e["dur"] <= L["t_close"]]
    return sum(ns) / len(ns) / 1e3 if ns else None
