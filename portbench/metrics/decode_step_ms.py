"""The decode cell: the median, over the window's decode chunks, of the
chunk's wall time over its tokens (``ServeEngine.on_step_latency``), in
ms a token step."""
from portbench.lib import readers


def read(L):
    return readers.ms_median([s.decode_wall / s.k
                              for s in readers.decode_steps(L)])
