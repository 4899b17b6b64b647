"""Layer 2 — the model audit: run the serving fast paths on real tensors
and assert on what they did, not on the Python that says what they do.

The port's counterpart of ``repro.analysis.jaxpr_audit``'s intent.  Where
the reference lowers ``Model.decode_fused`` / ``Model.prefill_chunk`` and
reads the jaxpr and StableHLO, the port has no lowered artifact: it calls
them (each family's reduced config with its heads widened to 64, the
narrowest the card's attention kernels take, so the CPU and the card audit
the same models; or a caller's model) under a recorder and checks:

* **moved-cache** — every cache tensor keeps its ``data_ptr`` and the call
  hands back the same leaves.  The in-place cache is what replaces the
  reference's ``donate_argnums``: a model that copies its cache pays a
  full-cache copy per token, the regression a dropped donation is in the
  reference.
* **f64-promotion** — no op returns float64 (a ``TorchDispatchMode`` sees
  the outputs of every aten op the call runs).
* **host-sync** — nothing syncs the host inside the call.  The dispatch
  mode records ``aten._local_scalar_dense`` (``.item()``, ``int()`` /
  ``float()`` / ``bool()`` of a tensor) and copies from a CUDA tensor to
  the CPU; a ``TorchFunctionMode`` records ``.item()``, ``.cpu()``,
  ``.numpy()``, ``.tolist()`` and the scalar casts, which on a CPU tensor
  reach no dispatch at all.  On the card the call also runs under
  ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
  synchronizing CUDA call.
* **retrace-budget** — ``decode_fused`` builds one cell (one CUDA graph
  on the card, :mod:`repro_torch.models.graphs`) per (batch, chunk) cell
  and cache, and ``prefill_chunk`` one per (batch, chunk length) cell and
  cache: swept over batches (x chunks for the decode) with two calls a
  cell, a fresh cache per batch, each builds no more cells than there
  are cells swept.  ``.cells()`` is the counterpart of the reference's
  ``_cache_size()``.

``decode_fused`` and ``prefill_chunk`` are audited on two calls each.
The first builds the cell: the recorder sees every op of its eager run,
so float64 and host reads are checked there; on the card it runs outside
the sync-debug mode, because entering a capture synchronizes the device.
The second replays the cell, where the recorder sees only the copies in
and out: the ``data_ptr``s, and on the card the sync-debug mode, are
checked on it too.
"""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from .findings import SEVERITY_ERROR, Finding

#: The five serving families (one arch per family, reduced configs): the
#: reference audit's set.
FAMILY_ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-130m",
                "jamba-v0.1-52b", "llama-3.2-vision-90b")

DECODE_CHUNK = 4
DECODE_BATCH = 2
BATCH_SHAPES = (2, 3)       # the retrace sweep: the reference's cells
DECODE_CHUNKS = (1, 4)
AUDIT_SEQ = 16
PREFILL_CHUNK_T = 4

# findings anchor on the module that builds the fast paths
_MODELS_PATH = "src/repro_torch/models/__init__.py"

# tensor methods that hand a value to the host
_SYNC_METHODS = {"item", "cpu", "numpy", "tolist", "__int__", "__float__",
                 "__bool__", "__index__"}


class _Recorder(TorchDispatchMode):
    """Every aten op's float64 outputs and host reads, by op name."""

    def __init__(self):
        super().__init__()
        self.f64: set[str] = set()
        self.syncs: set[str] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket.__name__)
        if func is torch.ops.aten._local_scalar_dense.default:
            self.syncs.add(name)
        elif name in ("_to_copy", "copy_"):
            src = args[1] if name == "copy_" else args[0]
            dst = args[0] if name == "copy_" else out
            if (isinstance(src, torch.Tensor) and src.is_cuda
                    and isinstance(dst, torch.Tensor)
                    and dst.device.type == "cpu"):
                self.syncs.add(f"{name} to the host")
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float64:
                self.f64.add(name)
        return out


class _MethodRecorder(TorchFunctionMode):
    """Tensor methods that read a value on the host (seen on any device)."""

    def __init__(self, syncs: set):
        super().__init__()
        self.syncs = syncs

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _SYNC_METHODS:
            self.syncs.add(f".{name}()")
        return func(*args, **(kwargs or {}))


def _recorded(fn, rec: _Recorder, sync_debug: bool):
    """``fn()`` under ``rec`` (and, with ``sync_debug``, the card's
    sync-debug mode); None when the mode raised on a synchronizing call,
    which ``rec`` then holds."""
    with contextlib.ExitStack() as stack:
        if sync_debug:
            torch.cuda.synchronize()        # nothing earlier is waited on
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            stack.callback(torch.cuda.set_sync_debug_mode, prev)
        stack.enter_context(rec)
        stack.enter_context(_MethodRecorder(rec.syncs))
        try:
            return fn()
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            rec.syncs.add(f"a synchronizing CUDA call ({e})")
            return None


def audited_call(fn, cache: dict, label: str, path: str = _MODELS_PATH,
                 build=None):
    """Run ``fn()``, which must return a tuple whose last item is the cache
    (``{leaf: tensor}``) it was given, under the recorder; return
    ``(result, findings)``.  With ``build``, ``build()`` (the call that
    builds what ``fn`` replays) runs first under the recorder, outside
    the card's sync-debug mode, and its findings join ``fn``'s."""
    before = {n: t.data_ptr() for n, t in cache.items()}
    rec = _Recorder()
    on_card = any(t.is_cuda for t in cache.values())
    outs = [] if build is None else [_recorded(build, rec, False)]
    outs.append(_recorded(fn, rec, on_card))
    out = outs[-1]
    findings = []
    if rec.syncs:
        findings.append(Finding(
            "host-sync", SEVERITY_ERROR, path, 0,
            f"{label}: reads the host inside the call "
            f"({', '.join(sorted(rec.syncs))}) — the fast path makes no "
            f"host sync; the caller copies the (B, k) ids home once"))
    if rec.f64:
        findings.append(Finding(
            "f64-promotion", SEVERITY_ERROR, path, 0,
            f"{label}: float64 values produced by {sorted(rec.f64)} — a "
            f"silent float64 promotion doubles cache bandwidth"))
    moved, added = set(), set()
    for after in (o[-1] for o in outs if o is not None):
        moved |= {name for name, ptr in before.items()
                  if name not in after or after[name].data_ptr() != ptr}
        added |= set(after) - set(before)
    for name in (n for n in before if n in moved):
        findings.append(Finding(
            "moved-cache", SEVERITY_ERROR, path, 0,
            f"{label}: cache leaf {name} is not the tensor it was "
            f"given — the cache is written in place (it replaces "
            f"the reference's donation), so a new tensor means a "
            f"full-cache copy per call"))
    for name in sorted(added):
        findings.append(Finding(
            "moved-cache", SEVERITY_ERROR, path, 0,
            f"{label}: the call returns cache leaf {name}, which it "
            f"was not given"))
    return out, findings


def zero_cache(model, batch: int, seq: int, device) -> dict:
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in model.cache_spec(batch, seq).items()}


def audit_decode_fused(model, params, *, batch: int = DECODE_BATCH,
                       seq: int = AUDIT_SEQ, chunk: int = DECODE_CHUNK
                       ) -> list:
    """Findings for one model's ``decode_fused`` on a zero cache: the
    call that builds its cell, then a replay of it."""
    dev = params.device
    cache = zero_cache(model, batch, seq, dev)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    pos = torch.arange(batch, dtype=torch.int32, device=dev)
    label = f"{model.cfg.name}: decode_fused(B={batch}, k={chunk})"

    def call():
        return model.decode_fused(params, tok, pos, cache, chunk)
    with torch.no_grad():
        _, findings = audited_call(call, cache, label, build=call)
    return findings


def _over_budget(model, what: str, built: int, budget: int,
                 cells: str) -> list:
    if built <= budget:
        return []
    return [Finding(
        "retrace-budget", SEVERITY_ERROR, _MODELS_PATH, 0,
        f"{model.cfg.name}: {what} compiled {built} executables across "
        f"{budget} ({cells}) cells — something unstable leaks into the "
        f"trace and every extra compile is a serving stall")]


def audit_retrace(model, params, *, batch_shapes=BATCH_SHAPES,
                  chunks=DECODE_CHUNKS, seq: int = AUDIT_SEQ,
                  chunk_t: int = PREFILL_CHUNK_T) -> list:
    """``retrace-budget``: run the fused decode across every (batch,
    chunk) cell, and ``prefill_chunk`` (T ``chunk_t``) across every batch,
    a fresh zero cache per batch and two calls a cell, and require the
    cells each built (``.cells()``) to be no more than the cells swept.
    An entry point without ``cells`` (the eager body) is not
    introspectable and yields nothing, as the reference's audit does for
    a jit without ``_cache_size``."""
    dev = params.device
    findings = []
    caches = []                     # alive until the counts are read
    fused = model.decode_fused
    if hasattr(fused, "cells"):
        built0 = fused.cells()
        with torch.no_grad():
            for batch in batch_shapes:
                cache = zero_cache(model, batch, seq, dev)
                caches.append(cache)
                tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
                pos = torch.zeros(batch, dtype=torch.int32, device=dev)
                for k in chunks:
                    # two calls per cell: the second must find the first's
                    _, tok, pos, cache = fused(params, tok, pos, cache, k)
                    _, tok, pos, cache = fused(params, tok, pos, cache, k)
        findings += _over_budget(model, "decode_fused",
                                 fused.cells() - built0,
                                 len(batch_shapes) * len(chunks),
                                 "chunk x batch")
    chunk = model.prefill_chunk
    if hasattr(chunk, "cells"):
        built0 = chunk.cells()
        with torch.no_grad():
            for batch in batch_shapes:
                cache = zero_cache(model, batch, seq, dev)
                caches.append(cache)
                tokens = torch.ones((batch, chunk_t), dtype=torch.long,
                                    device=dev)
                qlen = torch.full((batch,), chunk_t, dtype=torch.int32,
                                  device=dev)
                for s in (0, chunk_t):
                    start = torch.full((batch,), s, dtype=torch.int32,
                                       device=dev)
                    _, cache = chunk(params, tokens, cache, start, qlen)
        findings += _over_budget(model, "prefill_chunk",
                                 chunk.cells() - built0, len(batch_shapes),
                                 "chunk length x batch")
    return findings


def audit_prefill_chunk(model, params, *, batch: int = 1,
                        seq: int = AUDIT_SEQ, chunk_t: int = PREFILL_CHUNK_T
                        ) -> list:
    """Findings for one model's ``prefill_chunk`` on a zero cache: the
    call that builds its cell, then a replay of it (none for a family
    without a chunkable prefill)."""
    if model.prefill_chunk is None:
        return []
    dev = params.device
    cache = zero_cache(model, batch, seq, dev)
    tokens = torch.ones((batch, chunk_t), dtype=torch.long, device=dev)
    start = torch.zeros(batch, dtype=torch.int32, device=dev)
    qlen = torch.full((batch,), chunk_t, dtype=torch.int32, device=dev)
    label = f"{model.cfg.name}: prefill_chunk(B={batch}, T={chunk_t})"

    def call():
        return model.prefill_chunk(params, tokens, cache, start, qlen)
    with torch.no_grad():
        _, findings = audited_call(call, cache, label, build=call)
    return findings


def audit_family(arch: str, device=None, seed: int = 0) -> list:
    """The three audits on one family's reduced config, its heads widened
    to 64 (:func:`repro_torch.configs.widen_heads`), weights from
    ``seed``; the retrace budget on a fresh model, so its cells count from
    0."""
    from ..configs import get_config, widen_heads
    from ..device import resolve_device
    from ..models import get_model
    dev = resolve_device(device)
    model = get_model(widen_heads(get_config(arch, reduced=True)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen, dev)
    return (audit_decode_fused(model, params)
            + audit_prefill_chunk(model, params)
            + audit_retrace(get_model(model.cfg), params))


def run_audit(archs=None, device=None) -> list:
    """The full layer-2 audit over every family (the CI entry point)."""
    findings = []
    for arch in (archs or FAMILY_ARCHS):
        findings += audit_family(arch, device)
    return findings
