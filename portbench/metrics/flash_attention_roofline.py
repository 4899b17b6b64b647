"""``kernels/flash_attention``'s forward in training (with its
log-sum-exp; the forward and the checkpointed layers' recompute): the
least time of its traced launches at the step's shape over their device
time, in %."""
from portbench.counts import kernels
from portbench.lib import readers


def read(L):
    tr = readers.trace(L)
    if tr is None:
        return None
    ops = tr.named("flash_bf16")
    t = L["traffic"]
    bound = len(ops) * kernels.flash_forward_s(L["dims"], t["batch"], t["seq"])
    return readers.percent(bound, sum(b - a for _, a, b in ops) / 1e9)
