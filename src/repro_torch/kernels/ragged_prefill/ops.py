"""Public chunked ragged prefill-attention op: the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor.

Counterpart of ``repro/kernels/ragged_prefill/ops.py``, with the same
``(B, T, Hq, hd)`` layout at the public function.  The kernel folds GQA by
index (query head ``g * rep + r`` of token ``t`` is folded row ``t * rep +
r`` of kv head ``g``) into 64-row tiles, so q is read, and the output
written, in the model's own layout: the TPU wrapper's transposes are gone.
The bf16 route reads the caches by TMA, which needs a 16-byte aligned base:
the op raises on any other, and on a q whose base is not 16-byte aligned.
There is no switch and no fallback: a tensor on the card launches
``csrc/ragged_prefill.cu`` or raises.  ``launches`` counts the kernel
launches of this process; a caller may reset it to 0.
"""

from __future__ import annotations

import math

import torch

from .. import _build, _priced
from ..flash_attention.ops import check_tma
from .ref import ragged_prefill_ref

launches = 0
MAX_REP = 16                 # query heads per kv head the kernel takes
HEAD_DIMS = (64, 128)        # head widths the kernel is built for


def ragged_prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, start: torch.Tensor,
                             qlen: torch.Tensor, *, lse: bool = False):
    """Chunked GQA prefill attention against a ragged batch cache.

    q: (B, T, Hq, hd) — chunk token ``i`` of slot ``b`` is at absolute
    position ``start[b] + i``; k,v: (B, Smax, Hkv, hd) caches already
    holding the chunk's K/V rows; start, qlen: (B,) int32 (chunk origin and
    live rows).  A chunk may cross or start past the cache's end: a query
    at ``start + i >= Smax`` attends to all ``Smax`` rows.  Returns (B, T,
    Hq, hd) float32 with rows ``i >= qlen[b]`` exact zeros, and with
    ``lse`` also the (B, T, Hq) float32 log-sum-exp of each row's scores:
    what a merge of the results over blocks of the cache weighs them by.
    A start may then be negative (the start made local to a block that
    begins past it): a row at ``start + i < 0`` reads no row, and it and
    a padded row give 0 and -inf."""
    B, T, Hq, hd = q.shape

    def body():
        if q.device.type == "cpu":
            return ragged_prefill_ref(q, k_cache, v_cache, start, qlen,
                                      lse=lse)
        return _launch(q, k_cache, v_cache, start, qlen, lse)
    # priced at every (chunk row, cache row) pair, as the shapes allow
    return _priced.run("ragged_prefill",
                       lambda: 4 * B * Hq * hd * T * k_cache.shape[1],
                       (q, k_cache, v_cache, start, qlen), body)


def _launch(q, k_cache, v_cache, start, qlen, want_lse=False):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"ragged_prefill runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError(f"q must be (B, T, Hq, hd) and the caches (B, Smax, "
                         f"Hkv, hd); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    B, T, Hq, hd = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != hd or tuple(start.shape) != (B,)
            or tuple(qlen.shape) != (B,)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"start {tuple(start.shape)}, qlen "
                         f"{tuple(qlen.shape)}")
    if (Hq % Hkv or Hq // Hkv > MAX_REP or hd not in HEAD_DIMS or T == 0
            or Smax == 0):
        raise ValueError(f"ragged_prefill takes Hq/Hkv <= {MAX_REP}, hd in "
                         f"{HEAD_DIMS} and non-empty T and Smax; got Hq={Hq}, "
                         f"Hkv={Hkv}, hd={hd}, T={T}, Smax={Smax}")
    if not (k_cache.dtype == v_cache.dtype == q.dtype):
        raise TypeError(f"q, k, v must share a dtype; got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if start.dtype != torch.int32 or qlen.dtype != torch.int32:
        raise TypeError(f"start and qlen must be int32, not {start.dtype}, "
                        f"{qlen.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("start", start), ("qlen", qlen)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    code = _build.dtype_code(q.dtype)
    if q.dtype == torch.bfloat16:
        if q.data_ptr() % 16:
            raise ValueError("q: base address not 16-byte aligned")
        check_tma(k_cache.transpose(1, 2), "k_cache")
        check_tma(v_cache.transpose(1, 2), "v_cache")
    lib = _build.library()
    out = torch.empty((B, T, Hq, hd), dtype=torch.float32, device=q.device)
    lse = (torch.empty((B, T, Hq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    with torch.cuda.device(q.device):
        err = lib.ragged_prefill_launch(
            code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            start.data_ptr(), qlen.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, T, Smax,
            Hkv, Hq // Hkv, hd, 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ragged_prefill")
    launches += 1
    return (out, lse) if want_lse else out
