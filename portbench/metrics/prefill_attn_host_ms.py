"""The attention blocks' host time inside a whole prefill: per prefill in
the window (a ``prefill.dispatch`` span), the summed ``attn`` spans
(``models/transformer.py`` ``_block_prefill``: norm, projections, RoPE,
the attention kernel's launch, the residual) of its request's trace at its
step; the median, in ms."""
from portbench.lib import readers


def read(L):
    loop = L.get("loop")
    if loop is None or loop.spans is None:
        return None
    events = [e for e in loop.spans.events if e["ph"] == "X"
              and L["t0"] <= e["ts"] and e["ts"] + e["dur"] <= L["t_close"]]
    attn: dict = {}
    for e in events:
        if e["name"] == "attn":
            key = (e["trace"], e["args"].get("step"))
            attn[key] = attn.get(key, 0.0) + e["dur"]
    return readers.ms_median([
        attn[key] for key in ((e["trace"], e["args"].get("step"))
                              for e in events
                              if e["name"] == "prefill.dispatch")
        if key in attn])
