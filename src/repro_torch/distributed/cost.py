"""The cost model of the port's program: FLOPs, bytes, collectives and
peak memory of one device, counted from the program itself as it runs.
The counterpart of the reference's ``hlo_cost.py`` (a trip-count-aware
walk of XLA's HLO text) and ``hlo_analysis.py`` (collective accounting).

There is no HLO here.  :class:`CostCounter` is a ``TorchDispatchMode``:
every ATen operation the program dispatches passes through it, on real
tensors (a run on the card or the CPU) or on fake ones
(``FakeTensorMode`` with PyTorch's fake process group: a rank of a 256- or
512-rank mesh traced with no device and no memory, as
``launch/dryrun.py`` does).  Per operation:

* **FLOPs**: the products' formulas of ``torch.utils.flop_counter``
  (2 M N K a matmul); elementwise work is not counted.
* **bytes**: the operation's tensor inputs read and outputs written, views
  excluded.  In eager mode every operation is one kernel, so nothing is
  fused: expect more bytes than XLA's fused program moves.
* **collectives** (``c10d`` operations): kind, operand and result bytes,
  group size, and whether the group spans pods (its ranks' pod index
  differs, ``devices_per_pod`` ranks a pod); wire bytes by the ring
  formulas of the reference's ``CollectiveOp.wire_bytes`` (copied).
* **peak memory**: the bytes of the storages alive at once, counted from
  the tensors :meth:`CostCounter.track` is given (parameters, state,
  inputs) and every output since.

The hand-written kernels are priced as the card runs them
(``kernels/_priced.py``): each wrapper call is one call of its kernel,
with the kernel's own FLOPs and its inputs read and outputs written once;
what its plain version does on the CPU or on fake tensors is not counted,
nor kept as live memory.  :attr:`CostCounter.calls` holds each kernel's
calls, which on the card are its launches; :attr:`CostTotals.tag_flops`
and ``tag_bytes`` are keyed by kernel name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import _priced

# c10d operation -> (kind, index of its input arg, index of its output arg)
_COLLECTIVES = {
    "allreduce_": ("all-reduce", 0, 0),
    "allreduce_coalesced_": ("all-reduce", 0, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_": ("all-gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "broadcast_": ("collective-permute", 0, 0),
}
# operations that move no bytes of their own (allocations, aliases)
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "set_",
         "_local_scalar_dense", "resize_"}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    operand_bytes: int      # per device, summed over operands
    result_bytes: int
    group_size: int
    cross_pod: bool
    ranks: tuple = ()       # the group's global ranks

    def wire_bytes(self) -> float:
        """Per-device bytes on the wire (ring algorithms)."""
        g = max(self.group_size, 1)
        frac = (g - 1) / g
        if self.kind == "all-reduce":
            return 2.0 * self.operand_bytes * frac
        if self.kind == "all-gather":
            return self.result_bytes * frac
        if self.kind == "reduce-scatter":
            return self.operand_bytes * frac
        if self.kind == "all-to-all":
            return self.operand_bytes * frac
        return float(self.operand_bytes)      # collective-permute


@dataclasses.dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    coll_operand: float = 0.0
    wire_ici: float = 0.0
    wire_dcn: float = 0.0
    coll_counts: dict = dataclasses.field(default_factory=dict)
    # bytes / flops of each hand-written kernel's calls, by kernel name
    tag_bytes: dict = dataclasses.field(default_factory=dict)
    tag_flops: dict = dataclasses.field(default_factory=dict)

    def add(self, o: "CostTotals", mult: float = 1.0) -> None:
        self.flops += o.flops * mult
        self.bytes += o.bytes * mult
        self.coll_operand += o.coll_operand * mult
        self.wire_ici += o.wire_ici * mult
        self.wire_dcn += o.wire_dcn * mult
        for k, v in o.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + v * mult
        for d, od in (("tag_bytes", o.tag_bytes), ("tag_flops", o.tag_flops)):
            mine = getattr(self, d)
            for k, v in od.items():
                mine[k] = mine.get(k, 0) + v * mult


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(x)[0]
               if isinstance(t, torch.Tensor))


def _group(args):
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:
                continue
    return None


class CostCounter(TorchDispatchMode):
    """``with CostCounter(devices_per_pod) as c: ...`` counts what the
    block dispatches into :attr:`totals`, :attr:`calls` (each kernel's
    calls), :attr:`ops` (the collectives, one :class:`CollectiveOp` each)
    and :attr:`peak_bytes`."""

    def __init__(self, devices_per_pod: int | None = None):
        super().__init__()
        self.devices_per_pod = devices_per_pod
        self.totals = CostTotals()
        self.calls: dict[str, int] = {}
        self.ops: list[CollectiveOp] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._paused = 0

    # -- memory ------------------------------------------------------------
    def track(self, tree) -> None:
        """Count the tensors of ``tree`` as live from now on."""
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._alloc(t)

    def _alloc(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._live:
            return
        n = s.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- the hooks ---------------------------------------------------------
    @contextlib.contextmanager
    def paused(self):
        """Run a kernel's body uncounted."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def kernel(self, name: str, flops: float, inputs, out) -> None:
        """One call of a hand-written kernel (``kernels/_priced.py``)."""
        nbytes = _nbytes(inputs) + _nbytes(out)
        t = self.totals
        t.flops += flops
        t.bytes += nbytes
        t.tag_flops[name] = t.tag_flops.get(name, 0.0) + flops
        t.tag_bytes[name] = t.tag_bytes.get(name, 0.0) + nbytes
        self.calls[name] = self.calls.get(name, 0) + 1
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor):
                self._alloc(o)

    def __enter__(self):
        self._route = _priced.counting(self)
        self._route.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._route.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        name = func._schema.name
        ns, _, op = name.partition("::")
        if ns == "c10d":
            if op in _COLLECTIVES:
                self._collective(op, args)
            return out
        if func.is_view:
            return out
        if op not in _FREE:
            t = self.totals
            packet = func.overloadpacket
            if packet in flop_registry:
                t.flops += flop_registry[packet](*args, **kwargs,
                                                 out_val=out)
            t.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor):
                self._alloc(o)
        return out

    def _collective(self, op: str, args) -> None:
        kind, i_in, i_out = _COLLECTIVES[op]
        pg = _group(args)
        g = pg.size() if pg is not None else 1
        ranks = tuple(dist.get_process_group_ranks(pg)) if pg else ()
        cross = bool(self.devices_per_pod) and len(
            {r // self.devices_per_pod for r in ranks}) > 1
        o = CollectiveOp(kind, _nbytes(args[i_in]), _nbytes(args[i_out]), g,
                         cross, ranks)
        self.ops.append(o)
        t = self.totals
        t.coll_operand += o.operand_bytes
        if cross:
            t.wire_dcn += o.wire_bytes()
        else:
            t.wire_ici += o.wire_bytes()
        t.coll_counts[kind] = t.coll_counts.get(kind, 0) + 1
