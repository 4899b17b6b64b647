"""Public flash-attention op: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

Counterpart of ``repro/kernels/flash_attention/ops.py``, with the same
(B, H, S, hd) layout at the public function.  The kernel addresses its
operands through strides (only hd must be contiguous), so the model passes
its (B, S, H, hd) activations as ``transpose(1, 2)`` views, and the output
is allocated in (B, Sq, Hq, hd) memory order and returned as the same kind
of view: the model's ``out.transpose(1, 2).reshape(B, S, Hq * hd)`` then
copies nothing.  bf16 operands are read by TMA, which needs a 16-byte
aligned base and (batch, head, seq) strides of whole 16-byte units: the op
raises on any other.  There is no switch and no fallback: a tensor on the
card launches ``csrc/flash_attention.cu`` or raises.  ``launches`` counts the
kernel launches of this process; a caller may reset it to 0.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import attention_ref

launches = 0
HEAD_DIMS = (64, 80, 128)    # head widths the kernel is built for (80
                             # runs the 128-wide tiles, zero-filled by TMA)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k, v: (B, Hkv, Skv, hd) -> (B, Hq, Sq, hd) in
    ``q.dtype``.  Query head h reads kv head ``h // (Hq // Hkv)``; causal
    positions start at 0 on both sides.  Any Sq and Skv."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    return _launch(q, k, v, causal)


def check_tma(t: torch.Tensor, name: str) -> None:
    """Raise unless TMA can address the bf16 operand ``t`` (B, H, S, hd):
    hd contiguous, base and every stepped stride 16-byte multiples."""
    es = t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"{name} must be contiguous along hd")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: base address not 16-byte aligned")
    for i in range(3):
        if t.shape[i] > 1 and (t.stride(i) * es) % 16:
            raise ValueError(f"{name}: stride {t.stride(i)} of dim {i} is "
                             f"not a multiple of 16 bytes")


def _launch(q, k, v, causal):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Hq, Sq, hd) and k, v (B, Hkv, Skv, "
                         f"hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS or Sq == 0 or Skv == 0:
        raise ValueError(f"flash_attention takes hd in {HEAD_DIMS} and "
                         f"non-empty sequences; got hd={hd}, Sq={Sq}, "
                         f"Skv={Skv}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k, v must share a dtype; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along hd")
        if t.dtype == torch.bfloat16:
            check_tma(t, name)
    code = _build.dtype_code(q.dtype)
    lib = _build.library()
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Sq, Skv, hd, strides, int(causal),
            1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out
