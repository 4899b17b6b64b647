"""Where a cost counter (``repro_torch.distributed.cost``) sees the
hand-written kernels: every wrapper of ``kernels/*/ops.py`` runs its body
(the kernel's launch on the card, its plain version on the CPU or on fake
tensors) through :func:`run`, at the same call that counts its launch.

Without a counter :func:`run` is the body.  Under one, the body runs with
the counter paused, so what the plain version does inside is not priced,
and the counter then records one call of the kernel: its own operations
(``flops``, from the shapes) and its inputs read and outputs written
once, which is what the kernel on the card moves.  A wrapper's call count
under a counter is thus, by construction, its launch count on the card.
"""

from __future__ import annotations

import contextlib

_counters: list = []


def run(name: str, flops, inputs: tuple, body):
    """``body()``; priced as one call of kernel ``name`` when a counter is
    active.  ``flops`` is a number or a callable giving it."""
    if not _counters:
        return body()
    counter = _counters[-1]
    with counter.paused():
        out = body()
    counter.kernel(name, float(flops() if callable(flops) else flops),
                   inputs, out)
    return out


def active() -> bool:
    """Whether a cost counter is pricing the wrappers' calls."""
    return bool(_counters)


@contextlib.contextmanager
def counting(counter):
    """Route the wrappers' calls to ``counter`` while the block runs."""
    _counters.append(counter)
    try:
        yield counter
    finally:
        _counters.remove(counter)


def attention_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """(query, key) pairs attention computes: query i sees keys 0..i when
    causal (positions from 0 on both sides), every key otherwise."""
    if not causal:
        return Sq * Skv
    n = min(Sq, Skv)                    # rows i < Skv see i + 1 keys
    return n * (n + 1) // 2 + (Sq - n) * Skv
