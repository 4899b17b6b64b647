"""Logical-axis sharding rules: the port's counterpart of
``repro/distributed/sharding.py``.

Parameters and activations are named by *logical* axes (``("batch",
"seq", "heads", None)``); a thread-local :class:`AxisRules` maps the names
to mesh axes.  Outside any rules context :func:`constrain` is a no-op and
:func:`spec_for` gives the empty spec, so the one-card paths run
unchanged.

Divisibility fallback, as in the reference: if a tensor dimension is not
divisible by the mapped mesh axes' size, the dimension drops to a prefix
of those axes (``("pod", "data")`` -> ``("pod",)``) or to replication, and
the event is recorded word for word in :attr:`AxisRules.fallbacks` (for
example qwen2-0.5b's 14 query heads over a 16-way ``model`` axis).

Eager PyTorch has no GSPMD, so what the reference hands to XLA as a
``NamedSharding(mesh, spec)`` is here a ``(DeviceMesh, placements)`` pair
(:class:`NamedSharding`, :func:`placements`): a spec entry ``("pod",
"data")`` on tensor dim ``d`` becomes ``Shard(d)`` on both mesh dims, and
``None`` leaves every mesh dim ``Replicate()``.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh``; the rules read its axis
sizes from ``mesh_dim_names`` (:func:`mesh_shape`), and also take a plain
``{axis name: size}`` mapping, which is all the spec arithmetic needs.

:func:`constrain` is not threaded through the model code: in eager
PyTorch an activation's layout comes from the collectives a layer runs
itself (``distributed/tp.py``: under rules on a ``DeviceMesh`` the dense
layers run each rank's shards and run their own all-gathers,
reduce-scatters and all-reduces).  With rules it redistributes a
``DTensor`` to its spec's placements and returns a plain tensor
unchanged.

The reference's ``shard_map_compat`` has no counterpart.  Its two users
run here as explicit per-rank bodies over the mesh's process groups,
every rank of the mesh calling them: ``models.moe.moe_ep`` (two
``all_to_all_single`` over ``model``, an all-gather of the blocks) and
``optim.compression.compressed_allreduce_demo`` (an ``all_reduce`` over
``data``, an ``all_gather`` over ``pod``).  Placement, the reference's
``device_put``, is ``distributed.elastic.elastic_remesh``
(``full_tensor`` and ``distribute_tensor``).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections.abc import Mapping
from typing import Optional, Sequence

from torch.distributed.tensor import DTensor, Replicate, Shard

LogicalAxis = Optional[str]

# default logical -> mesh-axis mapping for the production meshes
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),     # data parallel (pod axis folds into DP)
    "seq": (),                    # sequences unsharded by default
    "seq_mp": ("model",),         # long-context KV / MoE token sharding
    # sequence parallelism for the residual stream: scan carries, norms and
    # logits live seq-sharded; attention/MLP regions gather the sequence and
    # shard heads/ff instead (GSPMD inserts the boundary collectives)
    "seq_sp": ("model",),
    "d_model": (),                # residual activations replicated on model
    "heads": ("model",),          # TP over attention heads
    "kv_heads": ("model",),
    "qkv": ("model",),            # flattened q/k/v projection out-dim
    "ff": ("model",),             # TP over FFN hidden
    "vocab": ("model",),          # TP over vocab (embed + lm head)
    "experts": ("model",),        # expert parallelism
    "fsdp": ("data",),            # ZeRO-3 parameter sharding
    "img": (),
}


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s form: one entry a tensor dim, each
    ``None``, a mesh axis name, or a tuple of names (major first)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> dict[str, int]:
    """Mesh axis name -> size: a ``DeviceMesh`` by its ``mesh_dim_names``
    (its ``shape`` is a tuple), a mapping as it is."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if mesh.mesh_dim_names is None:
        raise ValueError("the mesh has no mesh_dim_names")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _size(mesh, axes: tuple[str, ...]) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes)


@dataclasses.dataclass
class AxisRules:
    mesh: object                  # a DeviceMesh or {axis name: size}
    rules: dict[str, tuple[str, ...]]
    fallbacks: list[str] = dataclasses.field(default_factory=list)
    # what ``distributed.tp`` derives from the rules once: the rank's
    # layout and each (names, shape)'s spec
    cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    def axes_for(self, name: LogicalAxis, dim: int) -> tuple[str, ...] | None:
        """Mesh axes for one logical axis, with divisibility fallback."""
        if name is None:
            return None
        shape = mesh_shape(self.mesh)
        mesh_axes = tuple(a for a in self.rules.get(name, ()) if a in shape)
        if not mesh_axes:
            return None
        total = _size(shape, mesh_axes)
        if dim % total != 0:
            # retry with a prefix of the axes (e.g. drop 'model', keep 'data')
            for cut in range(len(mesh_axes) - 1, 0, -1):
                sub = mesh_axes[:cut]
                if dim % _size(shape, sub) == 0:
                    self.fallbacks.append(
                        f"{name}: dim {dim} % {total} != 0 -> {sub}")
                    return sub
            self.fallbacks.append(f"{name}: dim {dim} !% {total} -> replicated")
            return None
        return mesh_axes

    def spec(self, names: Sequence[LogicalAxis],
             shape: Sequence[int]) -> PartitionSpec:
        used: set[str] = set()
        parts = []
        for name, dim in zip(names, shape):
            axes = self.axes_for(name, dim)
            if axes and any(a in used for a in axes):
                axes = tuple(a for a in axes if a not in used) or None
                if axes and dim % _size(self.mesh, axes) != 0:
                    axes = None
            if axes:
                used.update(axes)
                parts.append(axes if len(axes) > 1 else axes[0])
            else:
                parts.append(None)
        return P(*parts)


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim: a mesh
    axis named in entry ``d`` shards tensor dim ``d`` (``Shard(d)``), any
    other replicates.  Several axes on one dim split it in mesh-dim order,
    as a spec tuple lists them major first; an entry in any other order
    raises rather than shard in a different order."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"spec entry {axes} is not in the mesh's axis "
                             f"order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} used twice in "
                                 f"{tuple(spec)}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The reference's ``NamedSharding(mesh, spec)``: a ``DeviceMesh`` and
    a :class:`PartitionSpec`, whose :attr:`placements` a ``DTensor``
    takes (``distribute_tensor(t, s.mesh, s.placements)``)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


_tls = threading.local()


def set_rules(rules: AxisRules | None) -> None:
    _tls.rules = rules


def current_rules() -> AxisRules | None:
    return getattr(_tls, "rules", None)


class use_rules:
    """``with use_rules(mesh): ...`` activates logical-axis constraints."""

    def __init__(self, mesh, overrides: dict[str, tuple[str, ...]] | None
                 = None):
        rules = dict(DEFAULT_RULES)
        if overrides:
            rules.update(overrides)
        self.rules = AxisRules(mesh=mesh, rules=rules)

    def __enter__(self) -> AxisRules:
        self._prev = current_rules()
        set_rules(self.rules)
        return self.rules

    def __exit__(self, *exc) -> None:
        set_rules(self._prev)


def constrain(x, *names: LogicalAxis):
    """The reference's ``with_sharding_constraint`` by logical names: the
    same object without rules; with rules a ``DTensor`` redistributed to
    its spec's placements, a plain tensor returned as it is."""
    r = current_rules()
    if r is None:
        return x
    if len(names) != x.ndim:
        raise ValueError(f"{len(names)} names for rank-{x.ndim} tensor")
    if isinstance(x, DTensor):
        return x.redistribute(r.mesh, placements(r.mesh,
                                                 r.spec(names, x.shape)))
    return x


def spec_for(names: Sequence[LogicalAxis],
             shape: Sequence[int]) -> PartitionSpec:
    """PartitionSpec for a param with the active rules (P() if none)."""
    r = current_rules()
    if r is None:
        return P()
    return r.spec(names, shape)


def logical_sharding(mesh, names: Sequence[LogicalAxis],
                     shape: Sequence[int],
                     overrides: dict[str, tuple[str, ...]] | None = None
                     ) -> NamedSharding:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return NamedSharding(mesh, AxisRules(mesh, rules).spec(names, shape))
