"""The whole prefill chunk: model FLOPs of the window's prefill chunks over
their summed wall time, as a share of the bf16 peak, in %."""
from portbench.counts import model
from portbench.lib import readers


def read(L):
    cs = readers.chunks(L)
    return readers.peak_share(
        sum(model.prefill_flops(L["dims"], s, q) for s, q, _ in cs),
        sum(dur for _, _, dur in cs))
