"""``kernels/flash_attention``'s backward (its stats, dQ and dK / dV
kernels): the least time of the traced backward calls at the step's shape
over the three kernels' device time, in %."""
from portbench.counts import kernels
from portbench.lib import readers


def read(L):
    tr = readers.trace(L)
    if tr is None:
        return None
    calls = len(tr.named("bwd_dq"))
    ops = tr.named("bwd_stats", "bwd_dq", "bwd_dkdv")
    t = L["traffic"]
    bound = calls * kernels.flash_backward_s(L["dims"], t["batch"], t["seq"])
    return readers.percent(bound, sum(b - a for _, a, b in ops) / 1e9)
