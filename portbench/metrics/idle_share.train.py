"""The device in a training cell: the share of the traced slice in which
no device operation ran, in %."""
from portbench.lib import readers


def read(L):
    return readers.idle_share(L)
