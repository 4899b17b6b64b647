"""The MoE layers' host time inside a whole prefill: per prefill in the
window (a ``prefill.dispatch`` span), the summed ``moe.*`` spans
(``models/moe.py`` ``moe_ep_local``: route, dispatch, experts, combine)
of its request's trace at its step; the median, in ms."""
from portbench.lib import readers


def read(L):
    loop = L.get("loop")
    if loop is None or loop.spans is None:
        return None
    events = [e for e in loop.spans.events if e["ph"] == "X"
              and L["t0"] <= e["ts"] and e["ts"] + e["dur"] <= L["t_close"]]
    moe: dict = {}
    for e in events:
        if e["name"].startswith("moe."):
            key = (e["trace"], e["args"].get("step"))
            moe[key] = moe.get(key, 0.0) + e["dur"]
    return readers.ms_median([
        moe[key] for key in ((e["trace"], e["args"].get("step"))
                             for e in events
                             if e["name"] == "prefill.dispatch")
        if key in moe])
