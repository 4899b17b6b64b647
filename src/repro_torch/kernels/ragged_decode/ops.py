"""Public ragged decode-attention op: the CUDA kernel for a CUDA tensor,
the plain version for a CPU tensor.

Counterpart of ``repro/kernels/ragged_decode/ops.py``.  There is no switch
and no fallback: a tensor on the card launches
``csrc/ragged_decode.cu`` or raises.  ``launches`` counts the op's calls
on the card (each runs the split pass and the combine); a caller may reset
it to 0.

The kernel splits each slot's cache sweep across blocks
(flash-decoding).  ``split_geometry`` chooses the split from the shapes
and the card's SM count alone, never from ``pos``, so a call costs no host
sync: one allocation of scratch beside the output, two launches.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import _build, _priced, counters
from .ref import ragged_decode_ref

launches = 0
counters.register(__name__, "launches")
MAX_REP = 16                 # query heads per kv head the kernel takes
HEAD_DIMS = (64, 128)        # head widths the kernel is built for
SPLIT_TILE = 64              # a split's length is a multiple of this
BLOCKS_PER_SM = 2            # split-pass blocks per SM the split aims at


def split_geometry(B: int, Hkv: int, Smax: int, sms: int
                   ) -> tuple[int, int]:
    """(n_split, L): the cache rows [i * L, (i + 1) * L) form split i, for
    i < n_split; L is a multiple of ``SPLIT_TILE`` and every split starts
    inside the cache.  About ``BLOCKS_PER_SM`` blocks per SM when every
    slot is full (B=8, Hkv=2, Smax=2048 on 132 SMs: 16 splits of 128)."""
    want = -(-BLOCKS_PER_SM * sms // (B * Hkv))
    L = -(-Smax // want)
    L = -(-L // SPLIT_TILE) * SPLIT_TILE
    return -(-Smax // L), L


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ragged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, pos: torch.Tensor, *,
                            lse: bool = False):
    """One-token GQA attention against a ragged batch cache.

    q: (B, Hq, hd); k,v: (B, Smax, Hkv, hd); pos: (B,) int32 index of each
    slot's newest live token (inclusive; a position past the cache attends
    all of it).  Returns (B, Hq, hd) float32, and with ``lse`` also the
    (B, Hq) float32 log-sum-exp of each head's scores: what a merge of the
    results over shards of the cache weighs them by.  With ``lse`` a
    negative position reads no row, which gives 0 and -inf (a shard wholly
    past the slot's newest row); without it the kernel takes positions
    >= 0 only."""
    B, Hq, hd = q.shape

    def body():
        if q.device.type == "cpu":
            return ragged_decode_ref(q, k_cache, v_cache, pos, lse=lse)
        return _launch(q, k_cache, v_cache, pos, lse)
    # priced at every cache row: the split grid covers them all
    return _priced.run("ragged_decode",
                       lambda: 4 * B * Hq * hd * k_cache.shape[1],
                       (q, k_cache, v_cache, pos), body)


def _launch(q, k_cache, v_cache, pos, want_lse=False):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode runs on cuda or cpu, not {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be (B, Hq, hd) and the caches (B, Smax, "
                         f"Hkv, hd); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    B, Hq, hd = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != hd or tuple(pos.shape) != (B,)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"pos {tuple(pos.shape)}")
    if Hq % Hkv or Hq // Hkv > MAX_REP or hd not in HEAD_DIMS:
        raise ValueError(f"ragged_decode takes Hq/Hkv <= {MAX_REP} and hd in "
                         f"{HEAD_DIMS}; got Hq={Hq}, Hkv={Hkv}, hd={hd}")
    if not (k_cache.dtype == v_cache.dtype == q.dtype):
        raise TypeError(f"q, k, v must share a dtype; got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32, not {pos.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    code = _build.dtype_code(q.dtype)
    lib = _build.library()
    rep = Hq // Hkv
    n_split, L = split_geometry(B, Hkv, Smax, sm_count(q.device.index))
    out = torch.empty((B, Hq, hd), dtype=torch.float32, device=q.device)
    lse = (torch.empty((B, Hq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    scratch = torch.empty(B * Hkv * n_split * rep * (hd + 2),
                          dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.ragged_decode_launch(
            code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), scratch.data_ptr(), B,
            Smax, Hkv,
            rep, hd, n_split, L, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ragged_decode")
    launches += 1
    return (out, lse) if want_lse else out
