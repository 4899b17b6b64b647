"""The jitted entry points as cells: a body over one shape and one cache,
captured once as a CUDA graph and replayed after.  The counterpart of the
reference's jitted entry points, one executable per shape with the cache
donated (``repro/models/__init__.py``, ``repro/launch/train.py``):

* :class:`FusedDecode`, ``Model.decode_fused``: the k-step greedy decode,
  a cell per (batch, chunk) shape and cache;
* :class:`ChunkPrefill`, ``Model.prefill_chunk``: one prompt chunk, a cell
  per (batch, chunk length) shape and cache;
* :class:`StepDecode`, ``Model.decode_step``: one decode step, the
  per-step legacy path's (the reference's ``decode_jit``), a cell per
  batch and cache;
* :class:`TrainGraph`, the launcher's train step
  (:class:`repro_torch.train.step.DonatedStep`, the reference's
  ``jax.jit(make_train_step(...), donate_argnums=0)``): a cell per batch
  shape and training state, the state (params, AdamW's moments and step,
  the error-feedback residual) the cache, updated in place.

Each is a :class:`Graphed`, which names the body's static inputs (the
tensors copied into a cell's buffers each call) and its cache; every
other argument but the first (the params; the train step's
``TrainStep``) is static and part of the key (``k``).  The body returns
its outputs and then the cache.  The outputs are the cell's own buffers,
written by each replay and cloned out: the logits and tokens of the
serving cells, the train step's loss, gradient norm and learning rate.
So are the buffers a capture allocated and a caller can still reach:
after a train cell's build its ``TrainStep.module``'s ``.grad`` tensors
are the capture's, which the capture wrote nothing into and each replay
of that cell writes.

A cell is keyed by the static inputs' shapes and dtypes, the static
arguments, the device, the identity of the params, every cache leaf's
path (nested dicts' keys joined by ``/``; a flat cache's leaf names),
``data_ptr``, shape and dtype, and the active ``tp`` layout's
identity (:attr:`~repro_torch.distributed.tp.Layout.ident`; None without
one): one ``Model`` serves many engines, each with its own cache, a graph
reads the tensors at the addresses it was captured on, and a graph
captured under a layout holds its collectives and the rank's blocks, so a
cell captured without rules never replays under them, nor the reverse.
A cell is dropped as soon as a cache leaf, the params or the layout's
mesh is collected, so no graph outlives what it reads; one dropped while
another cell captures is freed when that capture ends, since destroying a
graph during a capture spoils it.  The params' tensors are read where
they lie: write new weights into them in place (a parameter replaced by a
new tensor needs a new params object).

On the card, a cell's first call copies the static inputs into the cell's
buffers and runs the body eagerly over them on a side stream.  That run
is the call's result, and it is the warm-up capture needs: the kernels'
build, each ``.cu``'s ``cudaFuncSetAttribute``, cuBLAS's workspaces and,
under a layout, NCCL's communicators happen in it.  The call then
captures the body over the same buffers and the live cache with
``torch.cuda.CUDAGraph``, into one memory pool that every serving cell
shares (the outputs a body allocates, and the collectives' outputs, come
from it).  That pool is never released, so a train cell, whose capture
holds a step's activations and gradients (tens of GB at full width),
captures into a pool of its own, which goes back to the allocator once
the cell is dropped (``SHARED_POOL``).  Capture runs nothing, so the
cache advances once, in the eager run: an SSM's or a hybrid's ``copy_``
into its state is not repeated, nor a train step's update, and no
scratch copy of the cache is needed.  Every later call copies the inputs
in, replays the graph on the current stream and returns clones of the
static outputs, so no call overwrites what an earlier one returned.  The
cache returned is the dict given.  Cells replay one at a time on the
caller's stream, which is what sharing one pool between graphs asks: an
engine's prefill chunk and decode chunk alternate on it every step.

On the CPU a cell is the same object with the same buffers, copy-in and
clone-out, but nothing is captured: every call runs the body eagerly
over the buffers and copies its outputs into the static outputs.  The
keying, the budget, the aliasing and the single advance of a first call
are thus tested without a card.

Two rules run the body eagerly, ``.eager``, instead of a cell: an active
cost counter (:mod:`repro_torch.distributed.cost`), which prices the ops
the body dispatches and would see none on a replay, and an active ``tp``
layout that cannot be captured
(:attr:`~repro_torch.distributed.tp.Layout.capturable`: a gloo group runs
its collectives on the host).  Under an NCCL layout the collectives are
captured with the rest; ProcessGroupNCCL forks its stream from the
capture stream and joins it back.  A capture that fails raises; nothing
falls back to the eager body.

``prepare`` builds a cell without serving a call: ``ServeEngine`` builds
its decode cell and its prefill chunk's cell on the card as it allocates
each cache, so no decode step or prefill chunk carries a cell's eager run
and capture.

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
from ..obs.trace import model_spans
from ..tree import tree_items

# device index -> (pool, the graph that holds it): a graph pool lives while
# a graph captured into it does, and capturing into a pool whose graphs
# were all destroyed fails, so a graph never replayed holds it for good
_pools: dict[int, tuple] = {}
_side: dict[int, torch.cuda.Stream] = {}       # device index -> stream
_capturing = 0                 # captures running, in any thread
_held: list = []               # cells dropped while one ran
_GAP = object()                # an argument slot not yet filled


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
    """The memory pool every serving cell on card ``index`` captures
    into."""
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
    """One shape over one cache: the static inputs, the static arguments,
    the static outputs, the graph (None on the CPU) and the launches one
    replay makes."""

    def __init__(self, inputs: tuple, statics: tuple):
        self.inputs, self.statics = inputs, statics
        self.out: tuple[torch.Tensor, ...] = ()
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[tuple[str, str], int] = {}
        self.finalizers: list[weakref.finalize] = []


class Graphed:
    """``eager`` over cells (module docstring).  ``eager(params, ...)``
    returns ``(*outputs, cache)``; a subclass names the positions of its
    static inputs (``INPUTS``) and of its cache (``CACHE``).  ``cells()``
    counts the cells built, the counterpart of the reference's
    ``_cache_size()``; ``live()`` those whose cache, params and mesh are
    alive; ``capture_ms`` holds each built cell's capture time on the
    host, in build order (None for a cell on the CPU, which captures
    nothing)."""
    INPUTS: tuple[int, ...] = ()
    CACHE: int = 0
    SHARED_POOL = True         # capture into the card's shared pool

    def __init__(self, eager: Callable):
        self.eager = eager
        self.capture_ms: list[float | None] = []
        self._cells: dict[tuple, _Cell] = {}

    def cells(self) -> int:
        return len(self.capture_ms)

    def live(self) -> int:
        return len(self._cells)

    @staticmethod
    def _eager_by_rule() -> bool:
        if _priced.active():
            return True
        lay = tp.layout()
        return lay is not None and not lay.capturable

    def _split(self, args: tuple):
        """(params, static inputs as tensors, cache, static arguments); a
        Python or numpy input becomes a tensor on the cache's device here,
        outside the body, since capture cannot hold a host-to-device copy
        of pageable memory."""
        cache = args[self.CACHE]
        dev = tree_items(cache)[0][1].device
        inputs = tuple(a if isinstance(a, torch.Tensor)
                       else torch.as_tensor(a, device=dev)
                       for a in (args[i] for i in self.INPUTS))
        statics = tuple(a for i, a in enumerate(args)
                        if i and i != self.CACHE and i not in self.INPUTS)
        return args[0], inputs, cache, statics

    def _key(self, params, inputs, cache: dict, statics) -> tuple:
        lay = tp.layout()
        return (tuple((tuple(t.shape), t.dtype) for t in inputs), statics,
                str(inputs[0].device), id(params),
                tuple((n, t.data_ptr(), tuple(t.shape), t.dtype)
                      for n, t in tree_items(cache)),
                None if lay is None else lay.ident)

    def prepare(self, *args) -> None:
        """Build the cell of these arguments unless it is built: the first
        call's eager run over the cache, whose result is dropped, and on
        the card the capture.  Nothing where a rule runs the body
        eagerly."""
        if self._eager_by_rule():
            return
        params, inputs, cache, statics = self._split(args)
        key = self._key(params, inputs, cache, statics)
        if key not in self._cells:
            with torch.no_grad():
                self._build(key, params, inputs, cache, statics)

    def __call__(self, *args):
        if self._eager_by_rule():
            return self.eager(*args)
        params, inputs, cache, statics = self._split(args)
        key = self._key(params, inputs, cache, statics)
        with torch.no_grad():
            cell = self._cells.get(key)
            if cell is None:
                return (*self._build(key, params, inputs, cache, statics),
                        cache)
            for dst, src in zip(cell.inputs, inputs):
                dst.copy_(src)
            if cell.graph is None:
                for dst, src in zip(cell.out,
                                    self._body(params, cell, cache)):
                    dst.copy_(src)
            else:
                cell.graph.replay()
                counters.add(cell.launches)
            return (*(t.clone() for t in cell.out), cache)

    def _body(self, params, cell: _Cell, cache: dict) -> tuple:
        args = [_GAP] * (2 + len(cell.inputs) + len(cell.statics))
        args[0], args[self.CACHE] = params, cache
        for i, t in zip(self.INPUTS, cell.inputs):
            args[i] = t
        rest = iter(cell.statics)
        args = [next(rest) if a is _GAP else a for a in args]
        return tuple(self.eager(*args)[:-1])

    def _build(self, key, params, inputs, cache, statics) -> tuple:
        """The cell's first call: its result (the outputs).  The eager run
        and the capture see no model spans' tracer
        (:func:`repro_torch.obs.trace.model_spans`), whoever calls, so no
        graph holds a span call."""
        cell = _Cell(tuple(t.clone(memory_format=torch.contiguous_format)
                           for t in inputs), statics)
        with model_spans(None):
            if inputs[0].device.type == "cuda":
                first = self._capture(cell, params, cache)
            else:
                cell.out = self._body(params, cell, cache)
                first = tuple(t.clone() for t in cell.out)
                self.capture_ms.append(None)
        self._cells[key] = cell
        lay = tp.layout()
        held = (params, *(t for _, t in tree_items(cache)),
                *(() if lay is None else (lay.mesh,)))
        cell.finalizers = [weakref.finalize(t, self._drop, key)
                           for t in held]
        return first

    def _capture(self, cell: _Cell, params, cache: dict) -> tuple:
        index = cell.inputs[0].device.index
        cur = torch.cuda.current_stream(index)
        side = _side_stream(index)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = self._body(params, cell, cache)   # result and warm-up
        cur.wait_stream(side)
        first = tuple(t.clone() for t in first)       # on the caller's
        before = counters.snapshot()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # "thread_local": another thread's CUDA calls (NCCL's watchdog, the
        # runtime's workers) cannot spoil this thread's capture
        pool = _pool(index) if self.SHARED_POOL else None
        with _no_graph_dies(), torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):  # analysis: allow-host-sync(entering capture synchronizes the device, once per cell)
            cell.out = self._body(params, cell, cache)
        self.capture_ms.append(1e3 * (time.perf_counter() - t0))
        cell.launches = counters.since(before)
        counters.add(cell.launches, times=-1)         # capture ran none
        cell.graph = graph
        return first

    def _drop(self, key) -> None:
        cell = self._cells.pop(key, None)
        if cell is not None:
            for f in cell.finalizers:
                f.detach()
            if _capturing:
                _held.append(cell)


class FusedDecode(Graphed):
    """``(params, token (B, 1), pos (B,), cache, k) -> (tokens (B, k),
    next token (B, 1), pos (B,), cache)``: a cell per (batch, chunk)
    shape and cache; ``eager`` is the k-step loop."""
    INPUTS, CACHE = (1, 2), 3


class ChunkPrefill(Graphed):
    """``(params, tokens (B, T), cache, start (B,), qlen (B,)) -> (logits
    (B, 1, V), cache)``: a cell per (batch, chunk length) shape and
    cache; ``eager`` is the family's ``prefill_chunk``."""
    INPUTS, CACHE = (1, 3, 4), 2


class StepDecode(Graphed):
    """``(params, token (B, 1), pos (B,), cache) -> (logits (B, 1, V),
    cache)``: a cell per batch and cache; ``eager`` is the family's
    ``decode``."""
    INPUTS, CACHE = (1, 2), 3


class TrainGraph(Graphed):
    """``(step, *batch, state) -> (loss, grad norm, lr, state)``: the
    donated train step over the batch's tensors in a fixed order
    (``tokens`` or ``frames``, ``labels``, then ``image_embeds`` for the
    vlm), a cell per batch shape and state; ``eager`` runs
    :meth:`~repro_torch.train.step.TrainStep.update_`, which writes the new
    state into the state's own tensors and turns autograd on for its
    forward and backward itself (a call runs under ``no_grad``; autograd
    records inside the capture, the backward's kernels on the capture
    stream).  ``step``, the ``TrainStep``, stands where the serving cells'
    params do: a graph reads its compute copy of the parameters at the
    addresses it was captured on.  Nothing calls ``prepare``, whose eager
    run would train a step: a cell's build is the real first step.  A
    cell captures into a pool of its own (module docstring)."""
    SHARED_POOL = False

    def __init__(self, eager: Callable, n_inputs: int):
        super().__init__(eager)
        self.INPUTS = tuple(range(1, 1 + n_inputs))
        self.CACHE = 1 + n_inputs
