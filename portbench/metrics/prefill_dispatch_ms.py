"""The whole prefill's host dispatch: the median of the engine's
``prefill.dispatch`` spans (``ServeEngine._admit``: from taking the
request to ``Model.prefill`` returning, every eager launch queued) in the
window, in ms."""
from portbench.lib import readers


def read(L):
    loop = L.get("loop")
    if loop is None or loop.spans is None:
        return None
    return readers.ms_median([e["dur"] for e in loop.spans.events
                              if e["name"] == "prefill.dispatch"
                              and L["t0"] <= e["ts"]
                              and e["ts"] + e["dur"] <= L["t_close"]])
