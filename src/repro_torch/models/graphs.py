"""``Model.decode_fused`` as cells: the k-step greedy decode of one
(batch, chunk) shape over one cache, captured once as a CUDA graph and
replayed after.  The counterpart of the reference's one jitted
``lax.scan`` executable per (batch, chunk) cell with the cache donated
(``repro/models/__init__.py``).

A cell is keyed by the batch, ``k``, the token's and the positions'
dtypes, the device, the identity of the params and every cache leaf's
name, ``data_ptr``, shape and dtype: one ``Model`` serves many engines,
each with its own cache, and a graph reads the tensors at the addresses
it was captured on.  A cell is dropped as soon as a cache leaf or the
params are collected, so no graph outlives what it reads; one dropped
while another cell captures is freed when that capture ends, since
destroying a graph during a capture spoils it.  The params'
tensors are read where they lie: write new weights into them in place
(a parameter replaced by a new tensor needs a new params object).

On the card, a cell's first call copies the token and the positions into
the cell's static buffers and runs the body eagerly over them on a side
stream.  That run is the call's result, and it is the warm-up capture
needs: the kernels' build, each ``.cu``'s ``cudaFuncSetAttribute`` and
cuBLAS's workspaces happen in it.  The call then captures the body over
the same buffers and the live cache with ``torch.cuda.CUDAGraph``, into
one memory pool that every cell shares.  Capture runs nothing, so the
cache advances once, in the eager run: an SSM's or a hybrid's ``copy_``
into its state is not repeated, and no scratch copy of the cache is
needed.  Every later call copies the token and the positions in, replays
the graph on the current stream and returns clones of the static
outputs, so no call overwrites what an earlier one returned.  The cache
returned is the dict given.  Cells replay one at a time on the caller's
stream, which is what sharing one pool between graphs asks.

On the CPU a cell is the same object with the same buffers, copy-in and
clone-out, but nothing is captured: every call runs the body eagerly
over the buffers and copies its outputs into the static outputs.  The
keying, the budget, the aliasing and the single advance of a first call
are thus tested without a card.

Two rules run the eager k-step loop instead of a cell: an active ``tp``
layout (the sharded path over gloo or NCCL ranks, whose collectives are
not captured here), and an active cost counter
(:mod:`repro_torch.distributed.cost`), which prices the ops the body
dispatches and would see none on a replay.  A capture that fails raises;
nothing falls back to the eager loop.  The loop is ``decode_fused.eager``.

``prepare`` builds a cell without serving a call: ``ServeEngine`` builds
its decode cell on the card as it allocates its cache, so no decode step
carries a cell's eager run and capture.

The kernels' launch counters count in Python, where a wrapper launches,
and a replay runs no Python.  So the counts that moved while a body was
captured (:mod:`repro_torch.kernels.counters`) are taken off again
(capture launches nothing) and added once per replay; the first call's
eager run counts as any call does.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Callable

import torch

from ..distributed import tp
from ..kernels import _priced, counters

# device index -> (pool, the graph that holds it): a graph pool lives while
# a graph captured into it does, and capturing into a pool whose graphs
# were all destroyed fails, so a graph never replayed holds it for good
_pools: dict[int, tuple] = {}
_side: dict[int, torch.cuda.Stream] = {}       # device index -> stream
_capturing = 0                 # captures running, in any thread
_held: list = []               # cells dropped while one ran


@contextlib.contextmanager
def _no_graph_dies():
    """Hold every cell dropped while the block runs and free it after:
    destroying a CUDA graph while a stream captures spoils the capture,
    and a collection of an old engine's cache can drop a cell at any
    allocation of the body being captured."""
    global _capturing
    _capturing += 1
    try:
        yield
    finally:
        _capturing -= 1
        if not _capturing:
            _held.clear()


def _pool(index: int):
    """The memory pool every cell on card ``index`` captures into."""
    if index not in _pools:
        pool = torch.cuda.graph_pool_handle()
        holder = torch.cuda.CUDAGraph()
        one = torch.zeros(1, device=torch.device("cuda", index))
        with torch.cuda.graph(holder, pool=pool,
                              capture_error_mode="thread_local"):
            one.add_(1)
        _pools[index] = (pool, holder, one)
    return _pools[index][0]


def _side_stream(index: int) -> torch.cuda.Stream:
    if index not in _side:
        _side[index] = torch.cuda.Stream(device=index)
    return _side[index]


class _Cell:
    """One (batch, chunk) shape over one cache: static inputs ``tok`` and
    ``pos``, static outputs ``out`` (tokens (B, k), next token (B, 1),
    positions (B,)), the graph (None on the CPU) and the launches one
    replay makes."""

    def __init__(self, tok: torch.Tensor, pos: torch.Tensor):
        self.tok, self.pos = tok, pos
        self.out: tuple[torch.Tensor, ...] = ()
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[tuple[str, str], int] = {}
        self.finalizers: list[weakref.finalize] = []


class FusedDecode:
    """``(params, token (B, 1), pos (B,), cache, k) -> (tokens (B, k),
    next token (B, 1), pos (B,), cache)`` over cells (module docstring).
    ``eager`` is the k-step loop a cell captures; ``cells()`` counts the
    cells built, the counterpart of the reference's ``_cache_size()``;
    ``capture_ms`` holds each built cell's capture time on the host, in
    build order (None for a cell on the CPU, which captures nothing)."""

    def __init__(self, eager: Callable):
        self.eager = eager
        self.capture_ms: list[float | None] = []
        self._cells: dict[tuple, _Cell] = {}

    def cells(self) -> int:
        return len(self.capture_ms)

    def live(self) -> int:
        """Cells whose cache and params are alive."""
        return len(self._cells)

    @staticmethod
    def _eager_by_rule() -> bool:
        return tp.layout() is not None or _priced.active()

    @staticmethod
    def _key(params, token, pos, cache: dict, k: int) -> tuple:
        return (token.shape[0], k, token.dtype, pos.dtype, str(token.device),
                id(params), tuple((n, t.data_ptr(), tuple(t.shape), t.dtype)
                                  for n, t in cache.items()))

    def prepare(self, params, token, pos, cache: dict, k: int) -> None:
        """Build the cell of these arguments unless it is built: the first
        call's eager run over ``cache``, whose result is dropped, and on the
        card the capture.  Nothing where a rule runs the eager loop."""
        if self._eager_by_rule():
            return
        key = self._key(params, token, pos, cache, k)
        if key not in self._cells:
            with torch.no_grad():
                self._build(key, params, token, pos, cache, k)

    def __call__(self, params, token, pos, cache: dict, k: int):
        if self._eager_by_rule():
            return self.eager(params, token, pos, cache, k)
        key = self._key(params, token, pos, cache, k)
        with torch.no_grad():
            cell = self._cells.get(key)
            if cell is None:
                return (*self._build(key, params, token, pos, cache, k),
                        cache)
            cell.tok.copy_(token)
            cell.pos.copy_(pos)
            if cell.graph is None:
                for dst, src in zip(cell.out,
                                    self._body(params, cell, cache, k)):
                    dst.copy_(src)
            else:
                cell.graph.replay()
                counters.add(cell.launches)
            return (*(t.clone() for t in cell.out), cache)

    def _body(self, params, cell: _Cell, cache: dict, k: int):
        toks, nxt, pos, _ = self.eager(params, cell.tok, cell.pos, cache, k)
        return toks, nxt, pos

    def _build(self, key, params, token, pos, cache, k):
        """The cell's first call: its result (tokens, next token, pos)."""
        cell = _Cell(token.clone(memory_format=torch.contiguous_format),
                     pos.clone(memory_format=torch.contiguous_format))
        if token.device.type == "cuda":
            first = self._capture(cell, params, cache, k)
        else:
            cell.out = self._body(params, cell, cache, k)
            first = tuple(t.clone() for t in cell.out)
            self.capture_ms.append(None)
        self._cells[key] = cell
        cell.finalizers = [weakref.finalize(t, self._drop, key)
                           for t in (params, *cache.values())]
        return first

    def _capture(self, cell: _Cell, params, cache: dict, k: int):
        index = cell.tok.device.index
        cur = torch.cuda.current_stream(index)
        side = _side_stream(index)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = self._body(params, cell, cache, k)   # result and warm-up
        cur.wait_stream(side)
        first = tuple(t.clone() for t in first)          # on the caller's
        before = counters.snapshot()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # "thread_local": another thread's CUDA calls (NCCL's watchdog, the
        # runtime's workers) cannot spoil this thread's capture
        with _no_graph_dies(), torch.cuda.graph(graph, pool=_pool(index), capture_error_mode="thread_local"):  # analysis: allow-host-sync(entering capture synchronizes the device, once per cell)
            cell.out = self._body(params, cell, cache, k)
        self.capture_ms.append(1e3 * (time.perf_counter() - t0))
        cell.launches = counters.since(before)
        counters.add(cell.launches, times=-1)            # capture ran none
        cell.graph = graph
        return first

    def _drop(self, key) -> None:
        cell = self._cells.pop(key, None)
        if cell is not None:
            for f in cell.finalizers:
                f.detach()
            if _capturing:
                _held.append(cell)
