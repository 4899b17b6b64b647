"""``kernels/ragged_prefill``: the least time on the card for the traced
chunks' causal pairs and rows, over the kernel's device time, in %."""
from portbench.counts import kernels
from portbench.lib import readers


def read(L):
    tr = readers.trace(L)
    if tr is None:
        return None
    d, e = L["dims"], L["traffic"]["engine"]
    bound = sum(d.L * kernels.ragged_prefill_s(
        d, start, qlen, e["prefill_chunk_tokens"])
        for start, qlen, _ in readers.chunks(L, traced=True))
    spent = sum(b - a for _, a, b in tr.named("prefill_bf16",
                                               "prefill_f32")) / 1e9
    return readers.percent(bound, spent)
