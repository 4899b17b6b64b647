"""Public row-sort op: the CUDA kernel for a CUDA tensor, the plain version
for a CPU tensor.

Counterpart of ``repro/kernels/bitonic_sort/ops.py``.  Rows of any length
(the TPU kernel asserted a power of two).  ``sort_plan`` says how the
kernel lays a row out on chip: a row padded to ``2^p <= 131,072`` elements
sorts in one launch, on one block or a cluster of 2, 4 or 8 blocks whose
shared memories hold it; a longer row takes several launches through a
scratch row of the padded length, which this wrapper allocates unless the
length is a power of two and the output can hold the work.  ``out=``
writes into a given tensor, which may be a view into a larger one, so the
runtime's TAO bodies write their chunk in place.  There is no switch and
no fallback: a tensor on the card launches ``csrc/bitonic_sort.cu`` or
raises.  ``launches`` counts the calls that launched the kernel in this
process (one per call, whatever its device launches); a caller may reset
it to 0.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from .. import _build, _priced, counters
from .ref import sort_rows_ref

launches = 0
# worker threads launch concurrently; the counts rise under this lock
_count_lock = threading.Lock()
counters.register(__name__, "launches", lock=_count_lock)
_CODES = {torch.float32: 0, torch.int32: 1}

REG_LOG2 = 5            # 32 elements in a thread's registers (the kernel's kW)
BLOCK_MIN_LOG2 = 10     # a block holds at least 1,024 elements (32 threads)
BLOCK_MAX_LOG2 = 14     # and at most 16,384 (64 KB of shared memory)
CLUSTER_BLOCK_LOG2 = 12  # a cluster cuts a row into blocks of >= 4,096
CLUSTER_MAX = 8         # the largest portable cluster


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """How the kernel sorts a row of n elements: padded to 2^p (at least
    a block), blocks of 2^lb elements in clusters of C, 2^REG_LOG2
    registers a thread.  A row of up to C * 2^lb elements sorts in one
    launch."""
    p: int
    lb: int
    C: int

    @property
    def span_log2(self) -> int:
        """log2 of the elements one cluster holds."""
        return self.lb + self.C.bit_length() - 1

    @property
    def device_launches(self) -> int:
        """Device launches per call: one if the padded row fits a cluster;
        else one sort of every cluster-sized chunk, then for each later
        stage s a step in device memory for each stride of a chunk or more
        (s - span of them) and one cluster launch for the smaller strides."""
        lc = self.span_log2
        return 1 + sum(s - lc + 1 for s in range(lc + 1, self.p + 1))


def sort_plan(n: int) -> SortPlan:
    p = max(n - 1, 0).bit_length()
    lp = max(p, BLOCK_MIN_LOG2)
    C = min(CLUSTER_MAX, max(1, 1 << max(lp - CLUSTER_BLOCK_LOG2, 0)))
    lb = min(lp - (C.bit_length() - 1), BLOCK_MAX_LOG2)
    return SortPlan(p=p, lb=lb, C=C)


def _sort_ops(x: torch.Tensor) -> int:
    """Compare-exchanges of a bitonic network over each padded row."""
    k = max(1, (x.shape[1] - 1).bit_length())
    return x.shape[0] * (1 << k) // 2 * k * (k + 1) // 2


def sort_rows(x: torch.Tensor, *,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Ascending sort of each row of x (rows, n), float32 or int32, rows of
    unit stride; float rows must hold no NaN.  Returns (rows, n), in
    ``out`` if given."""
    return _priced.run("bitonic_sort", lambda: _sort_ops(x), (x,),
                       lambda: _sort_rows(x, out=out))


def _sort_rows(x: torch.Tensor, *,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The body of :func:`sort_rows`."""
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
    plan = sort_plan(n)
    work, work_stride = None, 0
    if plan.device_launches > 1:
        if n == 1 << plan.p:
            work, work_stride = out, out.stride(0)
        else:
            work = torch.empty((rows, 1 << plan.p), dtype=x.dtype,
                               device=x.device)
            work_stride = 1 << plan.p
    with torch.cuda.device(x.device):
        err = lib.bitonic_sort_launch(
            _CODES[x.dtype], x.data_ptr(),
            None if work is None else work.data_ptr(), out.data_ptr(), rows,
            n, x.stride(0), work_stride, out.stride(0), plan.lb, plan.C,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sort_rows")
    with _count_lock:
        launches += 1
    return out
