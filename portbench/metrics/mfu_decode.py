"""The whole decode step: model FLOPs of the decode tokens the window
kept, over the summed wall time of its decode chunks, as a share of the
bf16 peak, in %."""
from portbench.lib import readers


def read(L):
    steps = readers.decode_steps(L)
    return readers.peak_share(readers.decode_flops_kept(L),
                              sum(s.decode_wall for s in steps))
