"""Public flash-attention op: the CUDA kernels for a CUDA tensor, the plain
versions for a CPU tensor, with a gradient.

Counterpart of ``repro/kernels/flash_attention/ops.py``, with the same
(B, H, S, hd) layout at the public function.  The kernel addresses its
operands through strides (only hd must be contiguous), so the model passes
its (B, S, H, hd) activations as ``transpose(1, 2)`` views, and the output
is allocated in (B, Sq, Hq, hd) memory order and returned as the same kind
of view: the model's ``out.transpose(1, 2).reshape(B, S, Hq * hd)`` then
copies nothing.  bf16 operands are read by TMA, which needs a 16-byte
aligned base and (batch, head, seq) strides of whole 16-byte units: the op
raises on any other.  There is no switch and no fallback: a tensor on the
card launches ``csrc/flash_attention.cu`` or raises.

Gradient: when grad mode is on and q, k or v requires grad,
:func:`flash_attention` runs :class:`FlashAttention`, a
``torch.autograd.Function``.  Its forward also writes each row's
log-sum-exp (the kernel's optional ``lse`` output; serving passes none),
and its backward launches ``csrc/flash_attention_bwd.cu`` (a stats pass
of lse and D, then dQ and dK / dV; no float atomics, so the gradient is
bitwise deterministic).  On a CPU tensor both directions run the plain
versions of ``ref.py``.  The backward reads dO by stride, through TMA in
bf16, as it reads q, k and v; a dO that TMA cannot address (hd not
contiguous, or a base or stride not a 16-byte multiple) is copied first
and counted in ``dout_copies``: the model's layout needs no copy.

``launches`` counts the forward kernel's launches of this process,
``bwd_launches`` the backward's (each one stats pass, one dQ and one dK /
dV kernel); a caller may reset them to 0.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build, _priced, counters
from .ref import attention_ref, attention_ref_backward, attention_ref_lse

launches = 0
bwd_launches = 0
dout_copies = 0
counters.register(__name__, "launches", "bwd_launches", "dout_copies")
HEAD_DIMS = (64, 80, 128)    # head widths the kernels are built for (the
                             # forward runs 80 on its 128-wide tiles,
                             # zero-filled by TMA)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k, v: (B, Hkv, Skv, hd) -> (B, Hq, Sq, hd) in
    ``q.dtype``.  Query head h reads kv head ``h // (Hq // Hkv)``; causal
    positions start at 0 on both sides.  Any Sq and Skv.  Differentiable
    in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return flash_attention_forward(q, k, v, causal=causal)[0]


class FlashAttention(torch.autograd.Function):
    """Forward with the rows' log-sum-exp saved; backward from it."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_forward(q, k, v, causal=causal, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, lse,
                                              causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            lse: bool = False):
    """(out, lse or None): the forward, with the rows' float32 (B, Hq, Sq)
    log-sum-exp (natural-log units) when ``lse``."""
    def body():
        if q.device.type == "cpu":
            if lse:
                return attention_ref_lse(q, k, v, causal=causal)
            return attention_ref(q, k, v, causal=causal), None
        return _launch(q, k, v, causal, lse)
    return _priced.run("flash_attention", lambda: _flops(q, k, causal, 4),
                       (q, k, v), body)


def flash_attention_backward(q, k, v, o, dO, lse, *, causal: bool = True):
    """(dq, dk, dv) of the attention whose forward gave ``o`` and ``lse``,
    for the output's gradient ``dO``.  dq, dk and dv come in the layout of
    q, k and v: (B, H, S, hd) views of (B, S, H, hd) memory."""
    def body():
        if q.device.type == "cpu":
            return attention_ref_backward(q, k, v, o, dO, lse, causal=causal)
        return _launch_bwd(q, k, v, o, dO, lse, causal)
    # S and dP recomputed, dV, dQ and dK: five products of the forward's two
    return _priced.run("flash_attention_bwd",
                       lambda: _flops(q, k, causal, 10),
                       (q, k, v, o, dO, lse), body)


def _flops(q, k, causal: bool, per_pair: int) -> int:
    """``per_pair`` operations per head dim, head and (query, key) pair."""
    B, Hq, Sq, hd = q.shape
    return (per_pair * B * Hq * hd
            * _priced.attention_pairs(Sq, k.shape[2], causal))


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


def _check(q, k, v):
    """Raise on shapes, types and devices the kernels do not take."""
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


def _like_bshd(t: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, S, hd) tensor in (B, S, H, hd) memory order."""
    B, H, S, hd = t.shape
    return torch.empty((B, S, H, hd), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def _strides(*ts) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(ts)))(
        *(t.stride(i) for t in ts for i in range(3)))


def _launch(q, k, v, causal, want_lse=False):
    global launches
    _check(q, k, v)
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    code = _build.dtype_code(q.dtype)
    lib = _build.library()
    out = _like_bshd(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Hq, Hkv, Sq, Skv, hd, _strides(q, k, v, out), int(causal),
            1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out, lse


def _rows_ok(t: torch.Tensor) -> bool:
    """The backward reads ``t`` by stride: hd contiguous and, for bf16,
    what :func:`check_tma` asks (TMA tiles and 16-byte loads)."""
    if t.stride(3) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(
        t.shape[i] == 1 or (t.stride(i) * 2) % 16 == 0 for i in range(3))


def _launch_bwd(q, k, v, o, dO, lse, causal):
    global bwd_launches, dout_copies
    _check(q, k, v)
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    if o.shape != q.shape or dO.shape != q.shape:
        raise ValueError(f"o and dO must be {tuple(q.shape)}; got "
                         f"{tuple(o.shape)}, {tuple(dO.shape)}")
    if o.dtype != q.dtype or dO.dtype != q.dtype:
        raise TypeError(f"o and dO must be {q.dtype}; got {o.dtype}, "
                        f"{dO.dtype}")
    if (lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 {(B, Hq, Sq)}")
    if not _rows_ok(o):
        raise ValueError("o must be contiguous along hd with 16-byte rows")
    if not _rows_ok(dO):
        dO = dO.clone(memory_format=torch.contiguous_format)
        dout_copies += 1
    for name, t in (("o", o), ("dO", dO), ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    code = _build.dtype_code(q.dtype)
    lib = _build.library()
    dq, dk, dv = _like_bshd(q), _like_bshd(k), _like_bshd(v)
    # scratch: per 64-query tile of each (batch, head), the rows' lse and
    # D (bf16), or D alone in its first B * Hq * Sq floats (float32)
    D = torch.empty(2 * B * Hq * -(-Sq // 64) * 64, dtype=torch.float32,
                    device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_launch(
            code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dO.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Skv, hd,
            _strides(q, k, v, o, dO, dq, dk, dv), int(causal),
            1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention backward")
    bwd_launches += 1
    return dq, dk, dv
