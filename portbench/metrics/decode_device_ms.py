"""The model under the decode cell: device time of the kernels that run
in the traced slice's engine steps outside admission and prefill chunks
(the decode cell's replays), over the token steps they decoded, in ms."""
from portbench.lib import readers


def read(L):
    tr = readers.trace(L)
    steps = readers.decode_steps(L, traced=True)
    if tr is None or not steps:
        return None
    order = ("admit", "chunk", "step")
    ops = [o for o in tr.ops if tr.label(o[1], order) == "step"]
    busy = tr.busy_ns(ops)
    return busy / 1e6 / sum(s.k for s in steps) if busy else None
