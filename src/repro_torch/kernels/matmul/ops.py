"""Public matrix-product op: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

Counterpart of ``repro/kernels/matmul/ops.py``.  Any ``(M, K) x (K, N)``:
the TPU wrapper's tiling assertion does not carry over.  ``out=`` writes
the product into a given tensor, which may be a row slice of a larger
one, so the runtime's TAO bodies write their rows in place.
``TilePlan`` says how the kernel cuts a product: one block per 16 x 16
tile of the output, 64 threads each owning a 1 x 4 strip, K walked in
tiles of 64 through a 3-stage ring.  There is no switch and no fallback:
a tensor on the card launches ``csrc/matmul.cu`` or raises.  ``launches``
counts the kernel launches of this process (one per call); a caller may
reset it to 0.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from .. import _build, _priced, counters
from .ref import matmul_ref

launches = 0
# worker threads launch concurrently; the counts rise under this lock
_count_lock = threading.Lock()
counters.register(__name__, "launches", lock=_count_lock)

# the kernel's constants (csrc/matmul.cu): kBM, kBN, kBK, kStages, kThreads
BM, BN, BK, STAGES, THREADS = 16, 16, 64, 3, 64
STRIP = 4                    # output columns of one thread
MAX_GRID_Y = 65535           # CUDA's limit on gridDim.y (the n tiles)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the kernel computes an (M, K) x (K, N) product: block (bx, by)
    of ``grid`` owns out[bx*BM : (bx+1)*BM, by*BN : (by+1)*BN] (clipped at
    the edges); its thread t owns row ``t // (BN // STRIP)`` of that tile
    and the STRIP columns from ``(t % (BN // STRIP)) * STRIP``, summing
    over ``k_tiles`` tiles of BK in k order."""
    M: int
    N: int
    K: int

    @property
    def grid(self) -> tuple[int, int]:
        return -(-self.M // BM), -(-self.N // BN)

    @property
    def k_tiles(self) -> int:
        return -(-self.K // BK)

    def strips(self):
        """Every thread's strip that lies in the output: (row, first
        column, columns), in block and thread order."""
        gx, gy = self.grid
        for bx in range(gx):
            for by in range(gy):
                for t in range(THREADS):
                    r = bx * BM + t // (BN // STRIP)
                    c = by * BN + (t % (BN // STRIP)) * STRIP
                    if r < self.M and c < self.N:
                        yield r, c, min(STRIP, self.N - c)


def matmul(x: torch.Tensor, y: torch.Tensor, *,
           out: torch.Tensor | None = None,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x: (M, K), y: (K, N), float32 or bfloat16, rows of unit stride;
    returns (M, N) in ``out_dtype`` (default ``out.dtype`` when ``out`` is
    given, else ``x.dtype``), accumulated in float32."""
    return _priced.run("matmul",
                       lambda: 2 * x.shape[0] * x.shape[1] * y.shape[1],
                       (x, y), lambda: _matmul(x, y, out=out,
                                               out_dtype=out_dtype))


def _matmul(x: torch.Tensor, y: torch.Tensor, *,
            out: torch.Tensor | None = None,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The body of :func:`matmul`."""
    if out is not None:
        if out_dtype is not None and out_dtype != out.dtype:
            raise TypeError(f"out is {out.dtype}, out_dtype {out_dtype}")
        out_dtype = out.dtype
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul takes (M, K) x (K, N); got "
                         f"{tuple(x.shape)} x {tuple(y.shape)}")
    shape = (x.shape[0], y.shape[1])
    if out is not None and tuple(out.shape) != shape:
        raise ValueError(f"out is {tuple(out.shape)}, the product {shape}")
    if x.device.type == "cpu":
        r = matmul_ref(x, y, out_dtype)
        return r if out is None else out.copy_(r)
    return _launch(x, y, out, out_dtype, shape)


def _launch(x, y, out, out_dtype, shape):
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu, not {x.device}")
    if x.dtype != y.dtype:
        raise TypeError(f"x and y must share a dtype; got {x.dtype}, "
                        f"{y.dtype}")
    if out is None:
        out = torch.empty(shape, dtype=out_dtype, device=x.device)
    for name, t in (("x", x), ("y", y), ("out", out)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.numel() and (t.stride(1) != 1 or t.stride(0) < t.shape[1]):
            raise ValueError(f"{name} must be row-major with unit column "
                             f"stride; strides {t.stride()}")
    M, N = shape
    K = x.shape[1]
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    if TilePlan(M, N, K).grid[1] > MAX_GRID_Y:
        raise ValueError(f"matmul takes N <= {MAX_GRID_Y * BN}; got {N}")
    code, out_code = _build.dtype_code(x.dtype), _build.dtype_code(out_dtype)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.matmul_launch(
            code, out_code, x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N,
            K, x.stride(0), y.stride(0), out.stride(0),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "matmul")
    with _count_lock:
        launches += 1
    return out
