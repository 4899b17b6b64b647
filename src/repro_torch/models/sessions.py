"""Serializable per-slot KV sessions — slice one sequence's cache state out
of / into a batch cache.  Counterpart of ``repro/models/sessions.py``.

A *session* is the cache dict restricted to one batch slot (batch axis kept
at size 1) with growable sequence axes trimmed to the sequence's live
length, as host numpy arrays, so it can be pickled, shipped to another
process, or imported into another engine's batch cache.

numpy has no bfloat16 (and the port does not depend on ``ml_dtypes``), so
a bfloat16 leaf travels bit-exact as a ``uint16`` array of the same bytes;
:func:`insert_session` views it as bfloat16 (the same helpers,
``checkpoint.store.host_leaf`` / ``device_leaf``, carry checkpoints and
the wire) and then takes the target cache's dtype.  It is never widened to
float32: :func:`session_nbytes`, which the region tier's
``WanCost`` calibrates on, stays the cache's own size.  A session the JAX
package exported holds ``ml_dtypes`` bfloat16 leaves; they are taken by
their dtype's name and reinterpreted the same way, bit for bit, without
importing ``ml_dtypes``.  The other direction goes over the session wire
(:mod:`repro_torch.region.wire`), which names a ``uint16`` cache leaf
``"bfloat16"``: handed in process, a port session's ``uint16`` leaves would
be converted by value by the JAX package.  That naming is sound because a
cache holds floating-point leaves only, which :func:`extract_session`
checks.

The port updates caches in place and has no donation hazard, so
:func:`insert_session` writes straight into the target slot.
"""

from __future__ import annotations

import numpy as np
import torch

from ..checkpoint.store import device_leaf, host_leaf


def _to_device(arr, like: torch.Tensor) -> torch.Tensor:
    """A session leaf (host numpy, or a tensor such as a fresh prefill
    cache) as a tensor of ``like``'s dtype on ``like``'s device; a
    ``uint16`` or ``ml_dtypes`` bfloat16 leaf is bfloat16 bits."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=like.device, dtype=like.dtype)
    leaf = device_leaf(*host_leaf(arr, uint16_is_bf16=True), like.device)
    return leaf.to(like.dtype)


def extract_session(cache: dict, slot: int, pos: int, logical_axes: dict,
                    seq_axes: dict) -> dict:
    """Slice slot ``slot`` out of ``cache``: batch axis narrowed to
    ``slot:slot+1``, sequence axes trimmed to ``[:pos]`` (the live entries),
    leaves copied to host numpy: a session never shares memory with the
    cache (a CPU leaf is cloned first, since ``.numpy()`` would view it),
    so a cache reused after it, as the engine's working prefill cache is,
    leaves the session as it was.  Raises ``TypeError`` on a leaf that is
    not floating point: the wire takes a ``uint16`` cache leaf for
    bfloat16 bits, so no cache may hold integers."""
    out = {}
    for name, leaf in cache.items():
        if not leaf.is_floating_point():
            raise TypeError(f"cache leaf {name!r} is {leaf.dtype}: a session "
                            f"cache holds floating-point leaves only")
        b_axis = logical_axes[name].index("batch")
        idx = [slice(None)] * leaf.dim()
        idx[b_axis] = slice(slot, slot + 1)
        s_axis = seq_axes[name]
        if s_axis is not None:
            idx[s_axis] = slice(0, pos)
        part = leaf[tuple(idx)]
        if part.device.type == "cpu":
            part = part.clone()
        out[name] = host_leaf(part)[1]
    return out


def session_nbytes(session: dict) -> int:
    """Raw (pre-compression) bytes of a session's cache slice — what a WAN
    transfer actually moves, sized from the trimmed host arrays."""
    return int(sum(np.asarray(v).nbytes for v in session.values()))


def insert_session(cache: dict, slot: int, session: dict,
                   logical_axes: dict) -> dict:
    """Write a session (or a fresh single-request prefill cache — same
    shape family) into batch slot ``slot`` in place: every non-batch axis
    shorter than the target is zero past the session's extent (a session's
    seq axes were trimmed at extraction; a prefill cache's seq axes are
    prompt-length).  Returns ``cache``."""
    for name, full in cache.items():
        b_axis = logical_axes[name].index("batch")
        new = _to_device(session[name], full)
        idx = [slice(None)] * full.dim()
        idx[b_axis] = slice(slot, slot + 1)
        for i, (df, dn) in enumerate(zip(full.shape, new.shape)):
            if i == b_axis:
                continue
            if dn > df:
                raise ValueError(
                    f"session leaf {name!r} axis {i} is {dn} > target {df}; "
                    "the target engine's cache is too small for this session")
        dst = full[tuple(idx)]
        if tuple(dst.shape) != tuple(new.shape):
            dst.zero_()
            dst = dst[tuple(slice(0, n) for n in new.shape)]
        dst.copy_(new)
    return cache
