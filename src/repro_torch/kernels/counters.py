"""The one registry of the counters the port keeps where it launches a
kernel or makes a call: each wrapper module registers the module
attributes it counts in, with the lock its increments take (a counter
without one is read and written under this module's lock).  The counters
stay plain module attributes, which a caller may read or set to 0.

A CUDA graph's replay runs no Python, so no wrapper counts in it.  The
decode cells of :mod:`repro_torch.models.graphs` take a :func:`snapshot`
before capture and the :func:`since` of it after, and :func:`add` that
once per replay (and once with ``times=-1``, since capture launches
nothing)."""

from __future__ import annotations

import sys
import threading

_lock = threading.Lock()
# (module name, attribute) -> the lock its increments take
_registry: dict[tuple[str, str], threading.Lock] = {}


def register(module: str, *names: str, lock=None) -> None:
    """Register the counters ``names`` of the module named ``module``."""
    for name in names:
        _registry[(module, name)] = lock or _lock


def _read(key: tuple[str, str]) -> int:
    with _registry[key]:
        return getattr(sys.modules[key[0]], key[1])


def snapshot() -> dict[tuple[str, str], int]:
    """Every registered counter's value."""
    return {key: _read(key) for key in list(_registry)}


def since(before: dict[tuple[str, str], int]) -> dict[tuple[str, str], int]:
    """The counters that moved since ``before``, by how much (a counter
    registered after it counts from 0)."""
    moved = {}
    for key, n in snapshot().items():
        if n != before.get(key, 0):
            moved[key] = n - before.get(key, 0)
    return moved


def add(counts: dict[tuple[str, str], int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` to the counters, each under its lock."""
    for key, n in counts.items():
        mod = sys.modules[key[0]]
        with _registry[key]:
            setattr(mod, key[1], getattr(mod, key[1]) + times * n)
