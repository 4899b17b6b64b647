"""The whole serving window: model FLOPs of every prefill, chunk and kept
decode token of the window over its seconds, as a share of the bf16 peak,
in %."""
from portbench.counts import model
from portbench.lib import readers


def read(L):
    if "loop" not in L:
        return None
    d = L["dims"]
    whole = not L["traffic"]["engine"].get("prefill_chunk_tokens", 0)
    flops = readers.decode_flops_kept(L)
    for s in readers.steps(L):
        if whole:
            flops += sum(model.prefill_flops(d, 0, n) for n in s.prefills)
        flops += sum(model.prefill_flops(d, st, q) for st, q, _ in s.chunks)
    return readers.peak_share(flops, L["t_close"] - L["t0"])
