"""The train cell (``DonatedStep`` -> ``TrainGraph`` -> ``TrainStep.update_``
and ``optim/adamw.py``): device time of the kernels of each traced step,
in ms a step."""
from portbench.lib import readers


def read(L):
    tr = readers.trace(L)
    if tr is None:
        return None
    per = [tr.busy_ns(ops) for ops in tr.in_phase("train")]
    per = [b for b in per if b]
    return sum(per) / len(per) / 1e6 if per else None
