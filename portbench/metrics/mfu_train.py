"""The whole train step: model FLOPs of every step of the window (6 a
weight of every product a token, and the causal attention; no recompute)
over the window's seconds, as a share of the bf16 peak, in %."""
from portbench.counts import model
from portbench.lib import readers


def read(L):
    if "steps" not in L:
        return None
    tr = L["traffic"]
    flops = L["steps"] * model.train_flops(L["dims"], tr["batch"], tr["seq"])
    return readers.peak_share(flops, L["t_close"] - L["t0"])
