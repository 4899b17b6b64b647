"""The whole-prompt prefill (``_admit`` -> ``Model.prefill``, eager): the
median of the engine's ``prefill`` spans (``SpanTracer``) in the window,
in ms."""
from portbench.lib import readers


def read(L):
    loop = L.get("loop")
    if loop is None or loop.spans is None:
        return None
    return readers.ms_median([e["dur"] for e in loop.spans.events
                              if e["name"] == "prefill"
                              and L["t0"] <= e["ts"] <= L["t_close"]])
