"""Operations and bytes of one call of each attention kernel, from the
call's shapes, and its least time on the card (``peaks.bound_s``).  Each
input byte is read once and each output byte written once, whatever the
kernel reads again; where the work depends on the positions, it is what
these positions need.  Element sizes: bfloat16 inputs (2 bytes), float32
outputs of the ragged kernels and log-sum-exps (4)."""

from __future__ import annotations

from . import peaks
from .model import causal_pairs

BF16, F32, I32 = 2, 4, 4


def ragged_decode_s(d, rows: int, batch: int) -> float:
    """``ragged_decode`` over ``batch`` slots whose positions need ``rows``
    cache rows in all: reads q and those K and V rows and the positions,
    writes the float32 output; 4 x Hq x hd operations a row."""
    nbytes = (batch * d.Hq * d.hd * BF16 + 2 * rows * d.Hkv * d.hd * BF16
              + batch * I32 + batch * d.Hq * d.hd * F32)
    return peaks.bound_s(nbytes, 4.0 * d.Hq * d.hd * rows)


def ragged_prefill_s(d, start: int, qlen: int, chunk: int) -> float:
    """``ragged_prefill`` of one slot's chunk of ``chunk`` rows, ``qlen``
    live from ``start``: reads q and the ``start + qlen`` K and V rows,
    writes the float32 output."""
    rows = start + qlen if qlen > 0 else 0
    nbytes = (chunk * d.Hq * d.hd * BF16 + 2 * rows * d.Hkv * d.hd * BF16
              + 2 * I32 + chunk * d.Hq * d.hd * F32)
    return peaks.bound_s(nbytes, 4.0 * d.Hq * d.hd * causal_pairs(start,
                                                                  qlen))


def flash_forward_s(d, batch: int, seq: int) -> float:
    """The causal ``flash_attention`` forward with its log-sum-exp (the
    training forward and its recompute): reads q, k, v, writes o and the
    float32 log-sum-exp; two products of 2 x hd operations a pair."""
    n_q, n_kv = batch * d.Hq * seq * d.hd, batch * d.Hkv * seq * d.hd
    nbytes = (2 * n_q + 2 * n_kv) * BF16 + batch * d.Hq * seq * F32
    return peaks.bound_s(nbytes, 4.0 * batch * d.Hq * d.hd
                         * causal_pairs(0, seq))


def flash_backward_s(d, batch: int, seq: int) -> float:
    """The causal backward (its stats, dQ and dK / dV kernels together):
    reads q, k, v, o, dO and the log-sum-exp, writes dq, dk, dv; five
    products of 2 x hd operations a pair (the scores again, dP, dV, dQ,
    dK)."""
    n_q, n_kv = batch * d.Hq * seq * d.hd, batch * d.Hkv * seq * d.hd
    nbytes = (4 * n_q + 4 * n_kv) * BF16 + batch * d.Hq * seq * F32
    return peaks.bound_s(nbytes, 10.0 * batch * d.Hq * d.hd
                         * causal_pairs(0, seq))
