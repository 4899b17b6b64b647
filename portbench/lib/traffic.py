"""The one traffic generator.  A traffic file (``portbench/traffic/<name>.json``)
holds the parameters; this module turns them and ``--seed`` into requests.

Every seed gets the same multiset of sizes and of gaps between arrivals:
the sizes are the stratified quantiles of the stated distribution (for a
pool served only in part, in blocks that each hold them), and the gaps
those of an exponential of the stated rate.  The seed only orders them
(prompt and output lengths are permuted independently, so a seed pairs them
differently) and draws the token ids.  So two seeds offer the same work at
the same rate, and the spread between runs is the system's, not the
generator's."""

from __future__ import annotations

import math
import statistics

import numpy as np


def sizes(spec: dict, n: int) -> np.ndarray:
    """``n`` stratified quantiles (at ``(i + 0.5) / n``) of the length
    distribution ``spec``, ascending: ``{"dist": "lognormal", "median",
    "sigma", "min", "max"}`` or ``{"dist": "uniform", "min", "max"}``; each
    rounded and clipped to ``[min, max]``."""
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in u])
        raw = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        raw = spec["min"] + (spec["max"] - spec["min"]) * u
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(raw), spec["min"], spec["max"]).astype(np.int64)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream (warm-up, window, ...) of a seed."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def arrivals(gen: np.random.Generator, n: int, seconds: float) -> np.ndarray:
    """``n`` arrival times in ``[0, seconds)``: the stratified quantiles of
    an exponential as gaps, in the seed's order, scaled so that the ``n``
    gaps fill ``seconds`` (the first request is due at 0)."""
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = gaps[gen.permutation(n)]
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) * seconds / gaps.sum()


def lengths(spec: dict, n: int, gen: np.random.Generator,
            block: int | None = None) -> np.ndarray:
    """``n`` lengths of ``spec`` in the seed's order.  With ``block``, in
    blocks of ``block`` that each hold the same stratified quantiles (the
    last block cut short), so that every seed's first ``k * block``
    requests are the same work: a pool served only in part (a backlog)
    then gives no seed longer or shorter requests than another."""
    if not block or block >= n:
        return sizes(spec, n)[gen.permutation(n)]
    one = sizes(spec, block)
    return np.concatenate([one[gen.permutation(block)]
                           for _ in range(-(-n // block))])[:n]


def requests(traffic: dict, n: int, gen: np.random.Generator, vocab: int,
             max_seq: int, block: int | None = None
             ) -> list[tuple[np.ndarray, int]]:
    """``n`` requests ``(prompt ids, max_new)`` of the mix: lengths from
    ``traffic["prompt"]`` and ``traffic["output"]`` permuted by ``gen``
    (each in blocks of ``block``: :func:`lengths`), ids uniform over the
    vocabulary, and ``max_new`` cut so that a request never reaches the
    cache's edge (``prompt + max_new <= max_seq - 1``)."""
    plen = lengths(traffic["prompt"], n, gen, block)
    olen = lengths(traffic["output"], n, gen, block)
    if plen.max() > max_seq - 2:
        raise ValueError(f"a prompt of {plen.max()} does not fit max_seq "
                         f"{max_seq}")
    out = []
    for p, o in zip(plen, olen):
        ids = gen.integers(0, vocab, size=int(p), dtype=np.int64)
        out.append((ids, int(max(1, min(o, max_seq - 1 - p)))))
    return out
