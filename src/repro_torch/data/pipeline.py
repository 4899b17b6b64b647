"""Deterministic, resumable, sharded synthetic data pipeline: the port's
own copy of ``repro/data/pipeline.py`` (numpy only; the port imports
nothing of the JAX package), giving the same batches bit for bit.

Tokens are a pure function of (seed, step, shard, position) via a counter-
based xorshift hash, so:
* any DP shard can regenerate its slice independently (no coordination),
* restart-from-checkpoint replays the exact stream from the recorded step
  (determinism = the fault-tolerance contract),
* elastic re-sharding (e.g. 16 -> 8 DP groups) re-partitions the same global
  stream by recomputing shard slices.

A background prefetch thread keeps `prefetch` batches ready.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    prefetch: int = 2
    # synthetic structure: repeated n-grams so a trained model beats chance
    motif_len: int = 8


def _hash64(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> 33)) * np.uint64(0xFF51AFD7ED558CCD)
    x = (x ^ (x >> 33)) * np.uint64(0xC4CEB9FE1A85EC53)
    return x ^ (x >> 33)


class SyntheticLMData:
    """Iterator of {tokens, labels} numpy batches for one DP shard."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        if cfg.global_batch % cfg.n_shards:
            raise ValueError("global_batch must divide across shards")
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(1, cfg.prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- deterministic generation ---------------------------------------
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        bsz = cfg.global_batch // cfg.n_shards
        rows = (np.arange(bsz, dtype=np.uint64)
                + np.uint64(cfg.shard * bsz)
                + np.uint64(step) * np.uint64(cfg.global_batch))
        # each row cycles one of a few motif sequences (plus noise): next-token
        # prediction is near-deterministic given context, so small models
        # learn it in tens of steps (used by convergence tests)
        fam = rows[:, None] % np.uint64(4)
        seed_mix = np.uint64((cfg.seed * 0x9E3779B97F4A7C15 + 77)
                             & 0xFFFFFFFFFFFFFFFF)
        base = _hash64(fam ^ seed_mix)
        pos = np.arange(cfg.seq_len + 1, dtype=np.uint64)[None, :]
        motif = _hash64(base ^ (pos % np.uint64(self.cfg.motif_len)))
        noise = _hash64(base ^ pos ^ np.uint64(0xABCDEF))
        use_noise = (noise % np.uint64(10)) == 0          # 10% noise tokens
        toks = np.where(use_noise, noise, motif) % np.uint64(cfg.vocab)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # -- iteration / prefetch --------------------------------------------
    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put((step, self.batch_at(step)), timeout=0.2)
                step += 1
            except queue.Full:
                # analysis: allow-bare-retry(the blocking put's 0.2s
                # timeout already paces this loop — Full just means the
                # consumer is behind, and the retry IS the backpressure)
                continue

    def __next__(self) -> dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def __iter__(self):
        return self

    def state(self) -> dict:
        """Checkpointable state."""
        return {"step": self.step, "seed": self.cfg.seed,
                "n_shards": self.cfg.n_shards, "shard": self.cfg.shard}

    def close(self) -> None:
        self._stop.set()
