"""Sharded, compressed checkpoints: the port's counterpart of
``repro/checkpoint/store.py``, file for file.

Layout: ``<dir>/step_<n>/{manifest.json, shard_<k>.msgpack.<zst|zz>}``

* Leaves are grouped into ``n_shards`` files by a stable hash of their
  tree path.  A path is the tree's keys joined by ``/``, in the order
  ``jax.tree_util.tree_flatten_with_path`` gives them: dict keys sorted at
  every level, list and tuple items by index.  With the same tree and
  codec, every shard and the manifest are byte-identical to the JAX
  package's, and each package reads the other's.
* The manifest records step, leaf -> (shard, dtype, shape), the codec and
  extra user state.
* ``AsyncCheckpointer`` snapshots the tensors to host, then serializes and
  writes on a background thread.
* Atomicity: shards are written to a tmp dir, manifest last, then renamed.
* Compression: zstd when the optional ``zstandard`` package is present,
  stdlib zlib otherwise.  The manifest records the codec (a manifest
  without one means zstd).

A leaf is a numpy array or a torch tensor.  numpy has no bfloat16 (and
the port does not depend on ``ml_dtypes``), so a bfloat16 tensor is
written as its bits under the dtype string ``"bfloat16"``, the string the
JAX package writes for its bfloat16 leaves.  On load a ``"bfloat16"`` leaf
is read as ``uint16`` bits and viewed as a bfloat16 tensor, bit for bit: it
is never widened to float32 on the way.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zlib

import msgpack
import numpy as np
import torch

try:
    import zstandard as zstd
except ImportError:          # optional dependency; zlib fallback below
    zstd = None

from ..device import resolve_device

_CODEC_EXT = {"zstd": "zst", "zlib": "zz"}
_DEFAULT_CODEC = "zstd" if zstd is not None else "zlib"


def default_codec() -> str:
    """The best codec this build can write: zstd when the optional
    ``zstandard`` package is present, stdlib zlib otherwise.  Shared by
    checkpoints and the session wire format (:mod:`repro_torch.region.wire`),
    so both payloads degrade to the same always-importable fallback."""
    return _DEFAULT_CODEC


def compress(data: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if zstd is None:
            raise RuntimeError(
                "zstd compression requested but the 'zstandard' package "
                "is not installed")
        return zstd.ZstdCompressor(level=3).compress(data)
    if codec != "zlib":
        raise ValueError(f"unknown codec {codec!r}")
    return zlib.compress(data, 6)


def decompress(data: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if zstd is None:
            raise RuntimeError(
                "payload was written with zstd but the 'zstandard' "
                "package is not installed")
        return zstd.ZstdDecompressor().decompress(data)
    if codec != "zlib":
        raise ValueError(f"unknown codec {codec!r}")
    return zlib.decompress(data)


# ---------------------------------------------------------------------------
# leaves: {dtype, shape, data} records, bfloat16 as its bits
# ---------------------------------------------------------------------------

def host_leaf(x, uint16_is_bf16: bool = False) -> tuple[str, np.ndarray]:
    """``(dtype string, host array)`` of a leaf, with bfloat16 as its
    ``uint16`` bits under ``"bfloat16"``: a bfloat16 tensor, an
    ``ml_dtypes`` bfloat16 array (the JAX package's), and, with
    ``uint16_is_bf16``, a ``uint16`` array (a port session's cache leaf).
    Anything else is its numpy array under ``str(dtype)``.  The one place
    the port turns bfloat16 into host bits: checkpoints, sessions and the
    wire all come through here."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
        return "bfloat16", arr.view(np.uint16)
    if uint16_is_bf16 and arr.dtype == np.uint16:
        return "bfloat16", arr
    return str(arr.dtype), arr


def device_leaf(dtype: str, arr: np.ndarray, device) -> torch.Tensor:
    """The inverse of :func:`host_leaf`: a host array as a tensor on
    ``device``; under ``"bfloat16"`` its ``uint16`` bits are viewed as
    bfloat16, bit for bit, never widened.  A 0-d array (an optimizer's
    step count) stays 0-d."""
    shape = np.shape(arr)
    arr = np.ascontiguousarray(arr)        # makes a 0-d array 1-d
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.reshape(shape).to(device)


def pack_record(dtype: str, arr: np.ndarray) -> dict:
    return {"dtype": dtype, "shape": list(arr.shape), "data": arr.tobytes()}


def unpack_record(d: dict) -> np.ndarray:
    """A ``{dtype, shape, data}`` record as a numpy array; ``"bfloat16"``
    as ``uint16`` bits (2 bytes each), without ``ml_dtypes``.  Every other
    dtype goes through ``np.frombuffer``.  ``.copy()``: frombuffer views
    are read-only and pin the payload bytes."""
    dtype = "uint16" if d["dtype"] == "bfloat16" else d["dtype"]
    return np.frombuffer(d["data"], dtype=dtype).reshape(d["shape"]).copy()


# ---------------------------------------------------------------------------
# tree paths, as jax.tree_util.tree_flatten_with_path gives them
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=()):
    """``[(path tuple, leaf)]`` in JAX's flattening order: dict keys
    sorted, list / tuple items by index; ``None`` holds no leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, prefix + (i,)))
        return out
    if tree is None:
        return []
    return [(prefix, tree)]


def _leaf_paths(tree):
    flat = _flatten(tree)
    return (["/".join(str(k) for k in path) for path, _ in flat],
            [leaf for _, leaf in flat])


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves replaced, in flattening
    order, from the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    if tree is None:
        return None
    return next(leaves)


def _shard_of(path: str, n_shards: int) -> int:
    return int(hashlib.sha1(path.encode()).hexdigest(), 16) % n_shards


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def save_checkpoint(ckpt_dir: str, step: int, tree, extra: dict | None = None,
                    n_shards: int = 4) -> str:
    paths, leaves = _leaf_paths(tree)
    host = [host_leaf(x) for x in leaves]
    return _write(ckpt_dir, step, paths, host, extra or {}, n_shards)


def _write(ckpt_dir: str, step: int, paths, host_leaves, extra: dict,
           n_shards: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    shards: dict[int, dict[str, dict]] = {k: {} for k in range(n_shards)}
    index = {}
    for path, (dtype, arr) in zip(paths, host_leaves):
        k = _shard_of(path, n_shards)
        shards[k][path] = pack_record(dtype, arr)
        index[path] = {"shard": k, "dtype": dtype, "shape": list(arr.shape)}
    codec = _DEFAULT_CODEC
    ext = _CODEC_EXT[codec]
    for k, blob in shards.items():
        with open(os.path.join(tmp, f"shard_{k}.msgpack.{ext}"), "wb") as f:
            f.write(compress(msgpack.packb(blob), codec))
    manifest = {"step": step, "n_shards": n_shards, "codec": codec,
                "index": index, "extra": extra}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: int, target_tree,
                    device=None) -> tuple:
    """Restore into the structure of ``target_tree`` (whose leaves give the
    expected shapes): every leaf comes back as a tensor of its stored
    dtype on ``device`` (the card unless the caller passes one), bfloat16
    bit for bit.  Returns ``(tree, extra)``.  A leaf the checkpoint lacks
    raises ``KeyError``, a shape that differs ``ValueError``."""
    device = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    codec = manifest.get("codec", "zstd")     # pre-codec manifests are zstd
    ext = _CODEC_EXT.get(codec)
    if ext is None:
        raise ValueError(f"unknown checkpoint codec {codec!r}")
    blobs = {}
    for k in range(manifest["n_shards"]):
        with open(os.path.join(d, f"shard_{k}.msgpack.{ext}"), "rb") as f:
            blobs[k] = msgpack.unpackb(decompress(f.read(), codec))
    paths, leaves = _leaf_paths(target_tree)
    out = []
    for path, ref in zip(paths, leaves):
        meta = manifest["index"].get(path)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        raw = blobs[meta["shard"]][path]
        if list(raw["shape"]) != list(ref.shape):
            raise ValueError(f"shape mismatch for {path}: "
                             f"{tuple(raw['shape'])} vs {tuple(ref.shape)}")
        out.append(device_leaf(raw["dtype"], unpack_record(raw), device))
    return _rebuild(target_tree, iter(out)), manifest["extra"]


class AsyncCheckpointer:
    """Snapshot-then-write-in-background checkpointing."""

    def __init__(self, ckpt_dir: str, n_shards: int = 4, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.n_shards = n_shards
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree, extra: dict | None = None) -> None:
        self.wait()                                   # one in flight
        paths, leaves = _leaf_paths(tree)
        # snapshot: host copies, so the caller may go on updating its
        # tensors in place while the thread writes
        host = [(dt, a.copy()) for dt, a in map(host_leaf, leaves)]

        def work():
            _write(self.ckpt_dir, step, paths, host, extra or {},
                   self.n_shards)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
