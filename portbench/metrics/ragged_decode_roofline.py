"""``kernels/ragged_decode`` (its split and combine kernels): the least
time on the card for the cache rows every traced decode step read, over
the kernels' device time, in %."""
from portbench.counts import kernels
from portbench.lib import readers


def read(L):
    tr = readers.trace(L)
    if tr is None:
        return None
    d, e = L["dims"], L["traffic"]["engine"]
    bound = sum(d.L * kernels.ragged_decode_s(
        d, readers.decode_rows(s, i, e["max_batch"], e["max_seq"]),
        e["max_batch"])
        for s in readers.decode_steps(L, traced=True) for i in range(s.k))
    spent = sum(b - a for _, a, b in tr.named("decode_split",
                                               "decode_combine")) / 1e9
    return readers.percent(bound, spent)
