"""Public row-sort op: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor.

Counterpart of ``repro/kernels/bitonic_sort/ops.py``.  Rows of any length
(the TPU kernel asserted a power of two); a row longer than the kernel's
shared-memory tile sorts through a scratch row of the padded length,
which this wrapper allocates unless the length is a power of two and the
output can hold the work.  ``out=`` writes into a given tensor, which may
be a view into a larger one, so the runtime's TAO bodies write their
chunk in place.  There is no switch and no fallback: a tensor on the card
launches ``csrc/bitonic_sort.cu`` or raises.  ``launches`` counts the
calls that launched the kernel in this process (one per call, though a
long row takes several device launches); a caller may reset it to 0.
"""

from __future__ import annotations

import threading

import torch

from .. import _build
from .ref import sort_rows_ref

launches = 0
# worker threads launch concurrently; the counts rise under this lock
_count_lock = threading.Lock()
_CODES = {torch.float32: 0, torch.int32: 1}


def sort_rows(x: torch.Tensor, *,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Ascending sort of each row of x (rows, n), float32 or int32, rows of
    unit stride; float rows must hold no NaN.  Returns (rows, n), in
    ``out`` if given."""
    if x.dim() != 2:
        raise ValueError(f"sort_rows takes (rows, n); got {tuple(x.shape)}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype):
        raise ValueError(f"out is {tuple(out.shape)} {out.dtype}, x "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        r = sort_rows_ref(x)
        return r if out is None else out.copy_(r)
    return _launch(x, out)


def _launch(x, out):
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"sort_rows runs on cuda or cpu, not {x.device}")
    if x.dtype not in _CODES:
        raise TypeError(f"sort_rows takes float32 or int32, not {x.dtype}")
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows, n = x.shape
    for name, t in (("x", x), ("out", out)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.numel() and (t.stride(1) != 1 or (rows > 1
                                               and t.stride(0) < n)):
            raise ValueError(f"{name} must have rows of unit stride that "
                             f"do not overlap; strides {t.stride()}")
    if rows == 0 or n == 0:
        return out
    lib = _build.library()
    padded = 1 << (n - 1).bit_length()
    work, work_stride = None, 0
    if padded > lib.bitonic_sort_tile():
        if padded == n:
            work, work_stride = out, out.stride(0)
        else:
            work = torch.empty((rows, padded), dtype=x.dtype,
                               device=x.device)
            work_stride = padded
    with torch.cuda.device(x.device):
        err = lib.bitonic_sort_launch(
            _CODES[x.dtype], x.data_ptr(),
            None if work is None else work.data_ptr(), out.data_ptr(), rows,
            n, x.stride(0), work_stride, out.stride(0),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sort_rows")
    with _count_lock:
        launches += 1
    return out
