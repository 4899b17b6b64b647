"""Real executions of the paper's three kernels (§4.2.1) for the threaded
runtime, on the card: moldable bodies ``f(chunk_index, width)`` splitting
the work across the TAO's resource partition.

Counterpart of ``repro.core.real_kernels``, whose bodies are numpy on the
host.  Here each body runs its kernel class through the port's own op:
matmul through :func:`repro_torch.kernels.matmul.matmul`, sort through
:func:`repro_torch.kernels.bitonic_sort.sort_rows`, copy through
:func:`repro_torch.kernels.stream_copy.stream_copy`.

* **Data.** Sizes default to the paper's (64x64 matmul, 262 KB sort input,
  16.8 MB copy).  The working sets are drawn from
  ``np.random.default_rng(seed)`` in the reference's order (every
  ``mats`` slot, then every ``sort_src`` slot, then every ``copy_src``
  slot), so both pools hold identical data, and then moved to the device.
  ``sort_dst`` is new: the reference's sort throws its result away.
* **Bodies.** Each computes its ``[lo:hi)`` rows as the reference does and
  writes them into the slot's output through the op's ``out=``: matmul
  rows ``a[lo:hi] @ a``, the sorted chunk ``sort(src[lo:hi])``, the copied
  chunk ``src[lo:hi]``.  The reference's ``np.union1d`` merge of two
  sorted halves at width > 1 discards its result, has no observable
  output, and is not ported: ``sort_dst`` holds each chunk sorted.
* **Streams.** On the card each worker thread launches on a CUDA stream of
  its own (kept in a ``threading.local``), so the chunks of a wide TAO run
  side by side on the device; on the legacy default stream they would
  serialise.
* **Synchronisation.** Each body ends with its stream's ``synchronize()``.
  The runtime's leader times ``body(...)``, so the PTT learns the task's
  execution time, not its launch latency; and a child is woken only after
  its parents' writes have landed, even when it runs on another worker's
  stream, so no events are needed.

Sizes are parameters so that the CPU tests stay fast; on the CPU
(``device="cpu"``) the ops take their plain versions and no stream is
used.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.bitonic_sort import sort_rows
from ..kernels.matmul import matmul
from ..kernels.stream_copy import stream_copy
from .dag import KernelType
from .runtime import TAOBody


class KernelPool:
    """Preallocated working sets on the device, one slot per ``data_slot``
    (the generator's data-reuse memory step assigns slots; tasks sharing a
    slot reuse data)."""

    def __init__(self, n_slots: int, mat_n: int = 64, sort_bytes: int = 262_144,
                 copy_bytes: int = 16_800_000, seed: int = 0, device=None):
        dev = self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        slots = range(max(1, n_slots))

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(dev)

        self.mat_n = mat_n
        self.mats = [put(rng.standard_normal((mat_n, mat_n)).astype(np.float32))
                     for _ in slots]
        self.mat_out = [torch.zeros((mat_n, mat_n), dtype=torch.float32,
                                    device=dev) for _ in slots]
        ns = sort_bytes // 4
        self.sort_src = [put(rng.integers(0, 1 << 30, ns).astype(np.int32))
                         for _ in slots]
        self.sort_dst = [torch.empty(ns, dtype=torch.int32, device=dev)
                         for _ in slots]
        nc = copy_bytes // 4
        self.copy_src = [put(rng.integers(0, 255, nc).astype(np.int32))
                         for _ in slots]
        self.copy_dst = [torch.empty(nc, dtype=torch.int32, device=dev)
                         for _ in slots]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)      # the data is there for any stream
        self._local = threading.local()

    def _run(self, launch) -> None:
        """Run ``launch`` on this thread's stream and wait for it."""
        if self.device.type != "cuda":
            launch()
            return
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = self._local.stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(stream):
            launch()
        stream.synchronize()

    def body(self, kernel: KernelType, slot: int) -> TAOBody:
        slot = slot % len(self.mats)
        if kernel in (KernelType.MATMUL, KernelType.GEMM):
            a = self.mats[slot]
            out = self.mat_out[slot]

            def matmul_body(chunk: int, width: int) -> None:
                n = a.shape[0]
                lo, hi = chunk * n // width, (chunk + 1) * n // width
                # workers write disjoint output rows, share the inputs
                self._run(lambda: matmul(a[lo:hi], a, out=out[lo:hi]))
            return matmul_body

        if kernel == KernelType.SORT:
            src = self.sort_src[slot]
            dst = self.sort_dst[slot]

            def sort_body(chunk: int, width: int) -> None:
                n = len(src)
                lo, hi = chunk * n // width, (chunk + 1) * n // width
                self._run(lambda: sort_rows(src[lo:hi][None],
                                            out=dst[lo:hi][None]))
            return sort_body

        src = self.copy_src[slot]
        dst = self.copy_dst[slot]

        def copy_body(chunk: int, width: int) -> None:
            n = len(src)
            lo, hi = chunk * n // width, (chunk + 1) * n // width
            self._run(lambda: stream_copy(src[lo:hi], out=dst[lo:hi]))
        return copy_body

    def bodies_for_dag(self, dag) -> dict[int, TAOBody]:
        return {n.nid: self.body(n.kernel, max(n.data_slot, 0))
                for n in dag.nodes}
