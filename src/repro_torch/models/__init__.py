"""Model registry of the port: family -> module with a uniform interface.
Counterpart of ``repro/models/__init__.py``: all six families, dense,
audio (both ``transformer``), MoE, SSM (``mamba2``), hybrid (``jamba``)
and vlm.

Every family module provides::

    init(cfg, generator, device) -> params (an nn.Module)
    forward(cfg, p, batch)        -> full-sequence logits, the training
                                  compute (blocks rematerialized in the
                                  backward)
    prefill(cfg, p, batch)        -> (last logits, cache)
    prefill_chunk(cfg, p, tokens, cache, start, qlen)
                                  -> (last live logits, cache)   in place
                                  (dense only: an MoE, SSM, hybrid or vlm
                                  prompt prefills whole, and an audio one
                                  from frames, as in the reference)
    decode(cfg, p, token, pos, cache) -> (logits, cache)   cache in place
    cache_spec(cfg, B, S)         -> {leaf: (shape, dtype)}
    cache_logical_axes(cfg), cache_seq_axes(cfg)

On top of those, :class:`Model` exposes the per-slot session helpers and
the three serving entry points the reference jits, each as cells
(:mod:`.graphs`): one CUDA graph per shape and cache, captured on the
first call (or ``prepare``) and replayed after, where the reference has
one executable per shape with the cache donated.  On the CPU a cell runs
its body eagerly; a cost counter, or a ``tp`` layout over gloo, runs the
body eagerly everywhere; ``.eager`` is the body itself.

* ``decode_fused``, the serving fast path: a k-step greedy loop over the
  family's single-step ``decode`` with the cache updated in place and the
  argmax on the device (a cell per (batch, chunk)); tokens and positions
  stay on the device until the caller copies the ``(B, k)`` block of ids
  to the host once;
* ``prefill_chunk``, for a family with a chunkable prefill (dense): one
  prompt chunk written into the cache in place (a cell per (batch, chunk
  length));
* ``decode_step``, the per-step legacy path (``fused=False``), the
  counterpart of the reference's ``decode_jit`` (a cell per batch).

``decode`` itself stays the plain function: the sharded path and the
tests call it.  The cache tensors are written in place, so their
``data_ptr`` never changes across calls, which is what a cell's key and
its graph rest on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig
from . import graphs, jamba, mamba2, moe, sessions, transformer, vlm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable                # (generator, device) -> params
    forward: Callable             # (params, batch) -> logits (B, S, V)
    prefill: Callable             # (params, batch) -> (logits, cache)
    decode: Callable              # (params, token (B,1), pos, cache)
                                  # -> (logits (B,1,V), cache): one step
    decode_step: Callable         # decode as cells, the per-step legacy
                                  # path (fused=False); a graphs.StepDecode
                                  # (.eager is decode)
    decode_fused: Callable        # (params, token (B,1), pos (B,), cache, k)
                                  # -> (tokens (B,k), next_token, pos, cache)
                                  # greedy fast path: cache updated in place,
                                  # argmax on device, k steps per call; a
                                  # graphs.FusedDecode (.eager is the loop)
    cache_spec: Callable
    cache_logical_axes: Callable
    cache_seq_axes: Callable
    extract_session: Callable     # (cache, slot, pos) -> session dict (numpy)
    insert_session: Callable      # (cache, slot, session) -> cache (in place)
    prefill_chunk: Callable | None = None
                                  # (params, tokens (B,T), cache, start (B,),
                                  # qlen (B,)) -> (logits (B,1,V), cache):
                                  # one chunk, cache written in place; a
                                  # graphs.ChunkPrefill (.eager is the
                                  # plain call); None for a family without
                                  # a chunkable prefill


_FAMILY = {"dense": transformer, "audio": transformer, "moe": moe,
           "ssm": mamba2, "hybrid": jamba, "vlm": vlm}


def _fused_decode(cfg: ModelConfig, mod) -> Callable:
    """k greedy decode steps over ``mod.decode``, eagerly: the cache is
    written in place, ``argmax`` runs on the device, and nothing is copied
    to the host.  Returns ``(tokens (B, k), next token (B, 1), pos (B,),
    cache)`` with the same cache tensors it was given.  The body each
    :class:`graphs.FusedDecode` cell captures."""
    def fused(params, token, pos, cache, k: int):
        toks = torch.empty((token.shape[0], k), dtype=torch.long,
                           device=token.device)
        for i in range(k):
            logits, cache = mod.decode(cfg, params, token, pos, cache)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            toks[:, i] = nxt
            token = nxt[:, None]
            pos = pos + 1
        return toks, token, pos, cache

    return fused


def get_model(cfg: ModelConfig) -> Model:
    mod = _FAMILY[cfg.family]
    bind = lambda f: (lambda *a, **kw: f(cfg, *a, **kw))

    def extract_session(cache, slot: int, pos: int):
        return sessions.extract_session(cache, slot, pos,
                                        mod.cache_logical_axes(cfg),
                                        mod.cache_seq_axes(cfg))

    def insert_session(cache, slot: int, session):
        return sessions.insert_session(cache, slot, session,
                                       mod.cache_logical_axes(cfg))

    # the audio family shares the transformer module but prefills from
    # frames, not token ids, so it keeps the whole-sequence path
    chunkable = hasattr(mod, "prefill_chunk") and cfg.family != "audio"
    return Model(cfg=cfg, init=bind(mod.init),
                 forward=bind(mod.forward),
                 prefill=bind(mod.prefill), decode=bind(mod.decode),
                 decode_step=graphs.StepDecode(bind(mod.decode)),
                 decode_fused=graphs.FusedDecode(_fused_decode(cfg, mod)),
                 prefill_chunk=(graphs.ChunkPrefill(bind(mod.prefill_chunk))
                                if chunkable else None),
                 cache_spec=bind(mod.cache_spec),
                 cache_logical_axes=bind(mod.cache_logical_axes),
                 cache_seq_axes=bind(mod.cache_seq_axes),
                 extract_session=extract_session,
                 insert_session=insert_session)
