"""The chunk cell: the median wall time of the window's prefill chunks
(``ServeEngine.on_prefill_latency``: the chunk's call and its one sync),
in ms."""
from portbench.lib import readers


def read(L):
    return readers.ms_median([dur for _, _, dur in readers.chunks(L)])
