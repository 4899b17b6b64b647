"""Dense layers sharded over the mesh: the per-rank machinery that stands
in for GSPMD's partitioning of the reference's dense layers.

The reference names every parameter and activation by logical axes and
lets XLA shard the products and insert the boundary collectives.  Eager
PyTorch has neither, so under :func:`~.sharding.use_rules` on a
``DeviceMesh`` every rank runs the same body on its own shards, and the
body runs the collectives itself (the approach ``models.moe.moe_ep``
takes):

* **Parameters** are the rank's block of the reference's tensor under its
  ``param_specs`` entry and the active rules (:func:`local_block`;
  ``models.convert.local_tree`` slices a whole tree).  A dim on ``data``
  (``"fsdp"``) is all-gathered before its product (:func:`full_param`);
  the gather's backward is a reduce-scatter, so the gradient arrives
  summed and sharded (ZeRO-3).  A dim on ``model`` (``"qkv"``, ``"ff"``,
  ``"vocab"``) stays local: the product is column- or row-parallel.
* **Activations**: the batch is sharded over the rules' ``batch`` axes
  where it divides, and the residual stream's sequence over ``model``
  where it divides (``"seq_sp"``, Megatron sequence parallelism); a
  dimension that does not divide is replicated, as the reference's
  fallback replicates it, and the same fallback strings are recorded.
* **Collectives** (:func:`gather`, :func:`scatter`, :func:`reduce`) are
  autograd functions whose backward is the adjoint of the sum over ranks:
  all-gather <-> reduce-scatter, all-reduce <-> all-reduce.  A rank's
  loss is therefore divided by the mesh size (``train.step``), and a
  replicated parameter's gradient is all-reduced over every mesh axis its
  spec does not shard it on (:func:`replicated_axes`).

Without rules, or with rules on a plain ``{axis: size}`` mapping (spec
arithmetic only), :func:`layout` is ``None``, no entry point sets an
activation layout (:func:`entry`), and the helpers a layer's body calls
(:func:`full_param`, :func:`model_sharded`, :func:`seq_out`,
:func:`batch_block`, ...) return their input: the one body runs as on one
device, op for op.  A rank is identified by its coordinate on each mesh
axis; blocks along several axes on one dim are taken in row-major order,
major axis first, as a ``PartitionSpec`` tuple lists them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import types
from collections.abc import Mapping
from typing import Sequence

import torch
import torch.distributed as dist

from .sharding import current_rules, mesh_shape, set_rules


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place on the active rules' mesh."""
    rules: object
    mesh: object
    sizes: dict
    coords: dict

    @property
    def world(self) -> int:
        return math.prod(self.sizes.values())

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    @property
    def model(self) -> int:
        return self.size("model")

    @property
    def model_rank(self) -> int:
        return self.coords.get("model", 0)

    def spec(self, names: Sequence, shape: Sequence[int]) -> tuple:
        """The rules' spec of a tensor, one tuple of mesh axes a dim
        (empty: replicated), computed once a (names, shape): the rules
        record a fallback the first time only, as the reference's trace
        does."""
        key = (tuple(names), tuple(int(s) for s in shape))
        cache = self.rules.cache.setdefault("spec", {})
        if key not in cache:
            cache[key] = tuple(_axes(e) for e in self.rules.spec(*key))
        return cache[key]

    def index(self, axes: Sequence[str]) -> int:
        """This rank's block index along ``axes``, row-major."""
        i = 0
        for a in axes:
            i = i * self.sizes[a] + self.coords[a]
        return i

    def count(self, axes: Sequence[str]) -> int:
        return math.prod(self.sizes[a] for a in axes)

    @functools.cached_property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this layout's collectives:
        every group it uses is NCCL's.  Gloo runs its collectives on the
        host, which a graph cannot hold."""
        return all(dist.get_backend(self.group(a)) == "nccl"
                   for a in self.sizes)

    @functools.cached_property
    def ident(self) -> tuple:
        """What a captured body depends on: the mesh, this rank's place on
        it and the rules' mapping (a graph bakes in the groups it was
        captured on and the blocks the rank computes)."""
        return (id(self.mesh), tuple(sorted(self.sizes.items())),
                tuple(sorted(self.coords.items())),
                tuple(sorted((k, tuple(v))
                             for k, v in self.rules.rules.items())))


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def layout() -> Layout | None:
    """The rank's :class:`Layout` under the active rules, or ``None``
    without rules or on a mesh that is a plain mapping."""
    r = current_rules()
    if r is None or isinstance(r.mesh, Mapping):
        return None
    lay = r.cache.get("layout")
    if lay is None:
        sizes = mesh_shape(r.mesh)
        coords = {a: r.mesh.get_local_rank(a) for a in sizes}
        lay = r.cache["layout"] = Layout(r, r.mesh, sizes, coords)
    return lay


# ---------------------------------------------------------------------------
# collectives with gradients
# ---------------------------------------------------------------------------

def _gather_fwd(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0], *xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=group)
    # contiguous, as the products downstream expect their operands: the
    # same layout gives the same rounding as without rules
    return out.movedim(0, dim).contiguous()


def _scatter_fwd(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n, *xm.shape[1:]))
    dist.reduce_scatter_tensor(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_fwd(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_fwd(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_fwd(g, ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_fwd(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_fwd(g, ctx.dim, ctx.group), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_fwd(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_fwd(g, ctx.group), None


def _all_to_all_fwd(x: torch.Tensor, split: int, cat: int, group):
    n = dist.get_world_size(group)
    xm = torch.stack(x.chunk(n, dim=split)).contiguous()
    out = torch.empty_like(xm)
    dist.all_to_all_single(out, xm, group=group)
    return torch.cat(out.unbind(0), dim=cat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, cat, group):
        ctx.split, ctx.cat, ctx.group = split, cat, group
        return _all_to_all_fwd(x, split, cat, group)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all_fwd(g, ctx.cat, ctx.split, ctx.group), None,
                None, None)


def all_to_all(x: torch.Tensor, split: int, cat: int, axis: str):
    """Block ``j`` of ``x`` along ``split`` to rank ``j`` of ``axis``, the
    blocks received concatenated along ``cat`` in rank order."""
    return _AllToAll.apply(x, split, cat, layout().group(axis))


def gather(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over the mesh ``axes`` (a name or
    names, major first): the blocks in row-major rank order."""
    lay = layout()
    for a in reversed(_axes(axes)):          # minor axis first
        x = _Gather.apply(x, dim, lay.group(a))
    return x


def scatter(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """Reduce-scatter (sum) ``x`` along ``dim`` over ``axis``."""
    return _Scatter.apply(x, dim, layout().group(axis))


def reduce(x: torch.Tensor, axes) -> torch.Tensor:
    """All-reduce (sum) ``x`` over the mesh ``axes``."""
    lay = layout()
    for a in _axes(axes):
        x = _Reduce.apply(x, lay.group(a))
    return x


def reduce_max(x: torch.Tensor, axes) -> torch.Tensor:
    """All-reduce (max) of ``x`` over the mesh ``axes`` (a name or names;
    none: ``x`` itself); no gradient."""
    lay = layout()
    x = x.detach()
    for a in _axes(axes):
        x = _reduce_fwd(x, lay.group(a), dist.ReduceOp.MAX)
    return x


# ---------------------------------------------------------------------------
# blocks of tensors
# ---------------------------------------------------------------------------

def block_slice(lay: Layout, spec: tuple, shape: Sequence[int]) -> tuple:
    """The index of this rank's block of a tensor of global ``shape``."""
    idx = []
    for axes, n in zip(spec, shape):
        if not axes:
            idx.append(slice(None))
            continue
        size = n // lay.count(axes)
        i = lay.index(axes)
        idx.append(slice(i * size, (i + 1) * size))
    return tuple(idx)


def local_block(x, names: Sequence, lay: Layout | None = None):
    """This rank's block of the global tensor (or array) ``x`` named by
    the logical ``names``; ``x`` itself without a layout."""
    lay = lay or layout()
    if lay is None:
        return x
    return x[block_slice(lay, lay.spec(names, x.shape), x.shape)]


def local_shape(names: Sequence, shape: Sequence[int],
                lay: Layout | None = None) -> tuple[int, ...]:
    """The shape of this rank's block of a tensor of global ``shape``."""
    lay = lay or layout()
    if lay is None:
        return tuple(shape)
    return tuple(n // lay.count(a)
                 for n, a in zip(shape, lay.spec(names, shape)))


def full(x: torch.Tensor, names: Sequence, shape: Sequence[int],
         skip: Sequence[str] = ()) -> torch.Tensor:
    """The global tensor of ``shape`` whose local block is ``x``: every
    sharded dim gathered over its axes, except the axes in ``skip``."""
    lay = layout()
    for d, axes in enumerate(lay.spec(names, shape)):
        axes = tuple(a for a in axes if a not in skip)
        if axes:
            x = gather(x, d, axes)
    return x


def full_param(w: torch.Tensor, names: Sequence, shape: Sequence[int]
               ) -> torch.Tensor:
    """A parameter with its FSDP dims gathered (every axis but ``model``):
    the tensor a column- or row-parallel product takes (``w`` itself
    outside an entry point's call under rules)."""
    if activation() is None:
        return w
    return full(w, names, shape, skip=("model",))


def model_sharded(names: Sequence, shape: Sequence[int], dim: int) -> bool:
    """Whether dim ``dim`` of a tensor named ``names`` is on ``model``
    (never outside an entry point's call under rules)."""
    return activation() is not None and \
        "model" in layout().spec(names, shape)[dim]


def replicated_axes(names: Sequence, shape: Sequence[int],
                    lay: Layout) -> tuple[str, ...]:
    """The mesh axes a tensor is replicated over: those its spec does not
    shard it on (its gradient is all-reduced over them)."""
    used = {a for axes in lay.spec(names, shape) for a in axes}
    return tuple(a for a in lay.sizes if a not in used)


# ---------------------------------------------------------------------------
# the activations' layout
# ---------------------------------------------------------------------------

def batch_axes(B: int, lay: Layout | None = None) -> tuple[str, ...]:
    """The mesh axes the batch of ``B`` rows is sharded over (empty:
    replicated)."""
    lay = lay or layout()
    return lay.spec(("batch",), (B,))[0]


def batch_block(x: torch.Tensor, lay: Layout | None = None) -> torch.Tensor:
    """This rank's rows of a global batch (dim 0)."""
    lay = lay or layout()
    if lay is None:
        return x
    axes = batch_axes(x.shape[0], lay)
    if not axes:
        return x
    n = x.shape[0] // lay.count(axes)
    i = lay.index(axes)
    return x[i * n:(i + 1) * n]


def token_block(x: torch.Tensor) -> torch.Tensor:
    """This rank's tokens of a global (B, S, ...) tensor: its batch rows
    and, where the residual is sequence-parallel, its sequence block (the
    rows ``forward``'s logits have under rules)."""
    act = act_for(x.shape[0], x.shape[1])
    x = batch_block(x)
    return model_block(x) if act.sp else x


def batch_full(x: torch.Tensor, B: int) -> torch.Tensor:
    """The global batch of ``B`` rows from this rank's rows (dim 0)."""
    if layout() is None:
        return x
    axes = batch_axes(B)
    return gather(x, 0, axes) if axes else x


def model_block(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's block over ``model`` of dim ``dim`` (by default the
    sequence of a residual)."""
    lay = layout()
    n = x.shape[dim] // lay.model
    return x.narrow(dim, lay.model_rank * n, n)


def seq_full(x: torch.Tensor, sp: bool) -> torch.Tensor:
    """The full sequence of a residual (B, s, D): gathered over ``model``
    when it is sequence-parallel."""
    return gather(x, 1, "model") if sp else x


def seq_out(partial: torch.Tensor, sp: bool) -> torch.Tensor:
    """A row-parallel product's partial sums (B, S, D) onto the residual's
    layout: reduce-scattered over ``model`` along the sequence when it is
    sequence-parallel, all-reduced otherwise (``partial`` itself outside
    an entry point's call under rules)."""
    if sp:
        return scatter(partial, 1, "model")
    return partial if activation() is None else reduce(partial, "model")


def replicated(what: str) -> None:
    """Record that ``what`` computes whole on every rank of ``model``
    (``launch/dryrun.py`` writes the set into its record)."""
    if activation() is not None:
        layout().rules.cache.setdefault("replicated", set()).add(what)


def note(names: Sequence, shape: Sequence[int]) -> None:
    """Take the spec of an activation the reference constrains, so that
    its fallback is recorded as the reference's trace records it."""
    if activation() is not None:
        layout().spec(names, shape)


def full_module(module, axes: dict, shapes: dict):
    """The parameters of ``module`` gathered whole, as a namespace with its
    attribute names (an absent optional tensor stays ``None``): a layer
    that computes replicated under rules reads it in place of the module.
    Outside an entry point's call, the module itself."""
    if activation() is None:
        return module
    return types.SimpleNamespace(**{
        n: None if getattr(module, n, None) is None
        else full(getattr(module, n), axes[n], shapes[n])
        for n in axes if hasattr(module, n)})


# ---------------------------------------------------------------------------
# the activation layout of one entry-point call
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Act:
    """The global batch ``B`` and sequence ``S`` of the call in progress,
    the axes its batch is sharded over, whether its residual stream is
    sequence-parallel, and the rules it runs under."""
    B: int
    S: int
    batch: tuple
    sp: bool
    rules: object = dataclasses.field(default=None, compare=False)


_tls = threading.local()


def activation() -> Act | None:
    return getattr(_tls, "act", None)


@contextlib.contextmanager
def acting(act: Act | None):
    """Make ``act`` the activation layout, and its rules the active ones,
    while the block runs (entry points set it; ``layers.remat`` sets it
    again for a recompute, which on the card runs on autograd's own
    thread, where no rules are active)."""
    prev, prev_rules = activation(), current_rules()
    _tls.act = act
    if act is not None:
        set_rules(act.rules)
    try:
        yield act
    finally:
        _tls.act = prev
        set_rules(prev_rules)


def sp(act: Act | None) -> bool:
    """Whether the call ``act`` (or none) is sequence-parallel."""
    return act is not None and act.sp


def call_shape(b: int, s: int) -> tuple[int, int]:
    """The global (B, S) of the call in progress; ``(b, s)`` outside
    one."""
    act = activation()
    return (b, s) if act is None else (act.B, act.S)


def act_for(B: int, S: int) -> Act:
    """The layout of a call on a global (B, S) batch under the rules: the
    batch on the ``batch`` axes where it divides, the residual's sequence
    on ``model`` where it divides (each fallback recorded)."""
    lay = layout()
    return Act(B, S, batch_axes(B, lay),
               "model" in lay.spec(("seq_sp",), (S,))[0], lay.rules)


@contextlib.contextmanager
def entry(B: int, S: int):
    """``with tp.entry(B, S) as act``: ``act`` is ``None`` without a
    layout, else the call's :class:`Act`, in effect while the block
    runs."""
    if layout() is None:
        yield None
        return
    with acting(act_for(B, S)) as act:
        yield act
