"""Public streaming ops: the CUDA kernels for CUDA tensors, the plain
versions for CPU tensors.

Counterparts of ``repro/kernels/stream_copy/ops.py``.  ``stream_copy`` is
byte-generic (any dtype, any length: the TPU wrapper's ``n % block``
assertion does not carry over); ``stream_scale_add`` takes float32 or
bfloat16 and ``a``, ``b`` as run-time floats.  ``out=`` writes into a
given tensor, which may be a slice of a larger one, so the runtime's TAO
bodies write their chunk in place.  There is no switch and no fallback: a
tensor on the card launches ``csrc/stream_copy.cu`` or raises.
``copy_launches`` and ``scale_add_launches`` count each kernel's launches
of this process (one per call); a caller may reset them to 0.
"""

from __future__ import annotations

import threading

import torch

from .. import _build, _priced, counters
from .ref import stream_copy_ref, stream_scale_add_ref

copy_launches = 0
scale_add_launches = 0
# worker threads launch concurrently; the counts rise under this lock
_count_lock = threading.Lock()
counters.register(__name__, "copy_launches", "scale_add_launches",
                  lock=_count_lock)


def stream_copy(x: torch.Tensor, *,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """A copy of contiguous ``x`` (into ``out``: same shape and dtype,
    contiguous, not overlapping ``x``)."""
    return _priced.run("stream_copy", lambda: 0, (x,),
                       lambda: _stream_copy(x, out=out))


def _stream_copy(x: torch.Tensor, *,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The body of :func:`stream_copy`."""
    global copy_launches
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype):
        raise ValueError(f"out is {tuple(out.shape)} {out.dtype}, x "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return stream_copy_ref(x) if out is None else out.copy_(x)
    out = _check(out, x, (("x", x),))
    if x.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.stream_copy_launch(
            x.data_ptr(), out.data_ptr(), x.numel() * x.element_size(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "stream_copy")
    with _count_lock:
        copy_launches += 1
    return out


def stream_scale_add(x: torch.Tensor, y: torch.Tensor, a: float, b: float,
                     *, out: torch.Tensor | None = None) -> torch.Tensor:
    """``a * x + b * y`` computed in float32, cast to ``x.dtype``; x, y
    (and ``out``) contiguous, of one shape and dtype."""
    return _priced.run("stream_scale_add", lambda: 3 * x.numel(), (x, y),
                       lambda: _stream_scale_add(x, y, a, b, out=out))


def _stream_scale_add(x: torch.Tensor, y: torch.Tensor, a: float,
                      b: float, *, out: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """The body of :func:`stream_scale_add`."""
    global scale_add_launches
    if y.shape != x.shape or y.dtype != x.dtype:
        raise ValueError(f"x is {tuple(x.shape)} {x.dtype}, y "
                         f"{tuple(y.shape)} {y.dtype}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype):
        raise ValueError(f"out is {tuple(out.shape)} {out.dtype}, x "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        r = stream_scale_add_ref(x, y, a, b)
        return r if out is None else out.copy_(r)
    out = _check(out, x, (("x", x), ("y", y)))
    code = _build.dtype_code(x.dtype)
    if x.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.stream_scale_add_launch(
            code, x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
            float(a), float(b), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "stream_scale_add")
    with _count_lock:
        scale_add_launches += 1
    return out


def _check(out, x, inputs) -> torch.Tensor:
    """Device and layout checks of a launch; the output, allocated if
    ``out`` is None."""
    if x.device.type != "cuda":
        raise ValueError(f"the streaming kernels run on cuda or cpu, not "
                         f"{x.device}")
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    for name, t in (*inputs, ("out", out)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return out
