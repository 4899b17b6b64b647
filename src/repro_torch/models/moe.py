"""Mixture-of-Experts transformer (granite-moe, qwen3-moe): the port's
counterpart of ``repro/models/moe.py``.

Every layer is attention (``models/layers.py``: the ``flash_attention``
kernel at prefill, ``ragged_decode`` at decode) followed by an MoE block in
place of the dense MLP.  The layer loop, the K/V caches and their layout
are the dense family's (``models/transformer.py``); only the block's
``ffn`` differs.  The MoE block is a softmax router over
``n_experts``, the top-k experts of each token with their weights
renormalised, and a SwiGLU expert FFN.

Dispatch is the reference's sort-based one (``_sorted_positions`` and
``_local_dispatch`` with one expert column), which computes the same
function as its one-hot ``moe_dense`` oracle:

* copies of tokens are ranked within their expert in flat ``t * k + j``
  order (a stable sort by expert), and a copy whose rank reaches the
  capacity ``cap`` is dropped: it adds nothing, and the token passes
  through the residual only;
* ``cap = max(1, min_capacity, ceil(T * k * capacity_factor / E))``.  At
  prefill ``min_capacity`` is 0, so a long prompt can drop copies.  At
  decode it is the batch's token count, so no copy is ever dropped and a
  slot's token never depends on the other slots: that is what makes a
  session's stream the same after migration;
* kept copies are scattered into a static ``(E * cap + 1, D)`` buffer
  whose last row takes every dropped copy, the experts run as one batched
  product over ``(E, cap, D)``, and each copy gathers its row back.  No
  step reads a value on the host, so decode stays free of host syncs and
  its launch count does not depend on the routing.

Only ``moe_every == 1`` is ported, the layout of both MoE configs; the
alternating dense / MoE layout (the ``k_dense`` / ``k_moe`` cache) is not,
and no shipped config uses it.  The hybrid family (``models/jamba.py``)
does not need it: it calls :func:`moe_ffn` inside its own superblock.
There is no ``prefill_chunk``, as the reference has none: the engine
prefills MoE prompts whole.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig, torch_dtype
from ..device import resolve_device
from . import layers as L
from . import transformer


def _check_layout(cfg: ModelConfig) -> None:
    if cfg.family != "moe":
        raise NotImplementedError(f"family {cfg.family!r} is not 'moe'")
    if cfg.moe_every != 1:
        raise NotImplementedError(
            f"moe_every={cfg.moe_every}: the alternating dense / MoE layout "
            f"is not ported yet (ROADMAP A3; no shipped config uses it, and "
            f"the hybrid family runs its own superblock)")


class MoE(nn.Module):
    """``router`` (D, E) in float32 (the reference routes in float32);
    ``w_gate``, ``w_up`` (E, D, Fe) and ``w_down`` (E, Fe, D) in the
    compute dtype."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        cdt = torch_dtype(cfg.compute_dtype)
        self.router = L._weight(tensors["router"].float())
        for name in ("w_gate", "w_up", "w_down"):
            setattr(self, name, L._weight(tensors[name].to(cdt)))


class MoEBlock(nn.Module):
    """One layer: ``ln1``, ``attn``, ``ln2``, ``moe``."""

    def __init__(self, ln1: L.Norm, attn: L.Attention, ln2: L.Norm,
                 moe: MoE):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.moe = ln1, attn, ln2, moe

    def ffn(self, cfg: ModelConfig, h, decode: bool = False):
        return moe_ffn(cfg, self.moe, h, decode)


def _uniform(gen, shape, bound: float, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(-bound, bound, generator=gen)


def moe_init(cfg: ModelConfig, gen: torch.Generator, device) -> MoE:
    """The reference's distributions: router, gate and up uniform
    +-1/sqrt(D), down uniform +-1/sqrt(Fe), drawn in float32."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_expert
    s = 1.0 / math.sqrt(D)
    return MoE(cfg, {"router": _uniform(gen, (D, E), s, device),
                     "w_gate": _uniform(gen, (E, D, Fe), s, device),
                     "w_up": _uniform(gen, (E, D, Fe), s, device),
                     "w_down": _uniform(gen, (E, Fe, D),
                                        1.0 / math.sqrt(Fe), device)})


def init(cfg: ModelConfig, generator: torch.Generator,
         device=None) -> transformer.Transformer:
    """Random weights from the reference's distributions, drawn on
    ``device`` (the card unless the caller passes one) from ``generator``.
    Not the reference's numbers: parity tests carry weights over with
    :func:`repro_torch.models.convert.params_from_numpy`."""
    _check_layout(cfg)
    device = resolve_device(device)
    tok = L.embedding_init(cfg, generator, device)
    layers = [MoEBlock(L.norm_init(cfg.d_model, cfg.norm, device),
                       L.attention_init(cfg, generator, device),
                       L.norm_init(cfg.d_model, cfg.norm, device),
                       moe_init(cfg, generator, device))
              for _ in range(cfg.n_layers)]
    ln_f = L.norm_init(cfg.d_model, cfg.norm, device)
    return transformer.Transformer(tok, layers, ln_f)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def route(cfg: ModelConfig, router: torch.Tensor, x2d: torch.Tensor):
    """x2d: (T, D) -> (weights (T, k) float32, experts (T, k)): float32
    logits, softmax, top-k in descending order, the k weights
    renormalised."""
    probs = torch.softmax(x2d.float() @ router.float(), dim=-1)
    vals, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    return vals / vals.sum(-1, keepdim=True).clamp(min=1e-9), idx


def sorted_positions(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Rank of each copy within its expert in flat order: a stable sort by
    expert, each copy's index in the sorted order less its expert's first
    index there, scattered back.  Per-expert counts come from a
    ``scatter_add_``, not ``bincount``, which reads its maximum on the
    host."""
    n = flat_e.shape[0]
    order = torch.sort(flat_e, stable=True).indices
    counts = torch.zeros(E, dtype=torch.long, device=flat_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    first = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(n, device=flat_e.device) - first[flat_e[order]]
    return torch.empty_like(ranks).scatter_(0, order, ranks)


def expert_ffn(cfg: ModelConfig, p: MoE, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, D) slot-major copies -> (E, C, D): one batched product
    per projection over all experts."""
    xe = xe.to(torch_dtype(cfg.compute_dtype))
    h = F.silu(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
    return torch.bmm(h, p.w_down)


def capacity(cfg: ModelConfig, T: int, min_capacity: int = 0) -> int:
    return max(1, min_capacity,
               math.ceil(T * cfg.top_k * cfg.capacity_factor
                         / cfg.n_experts))


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor,
              min_capacity: int = 0) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) in x's dtype."""
    B, S, D = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    cap = capacity(cfg, T, min_capacity)
    x2d = x.reshape(T, D)
    vals, idx = route(cfg, p.router, x2d)
    flat_e = idx.reshape(-1)                               # (T*k,)
    pos = sorted_positions(flat_e, E)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, E * cap))      # overflow row
    src = torch.arange(T * k, device=x.device) // k
    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    # kept slots are distinct; only the overflow row is written twice, and
    # it is never read as an expert's input
    buf[slot] = x2d[src]
    ye = expert_ffn(cfg, p, buf[:E * cap].view(E, cap, D))
    back = torch.cat([ye.reshape(E * cap, D),
                      ye.new_zeros((1, D))])               # dropped -> 0
    w = (vals.reshape(-1) * keep).to(back.dtype)
    y = (back[slot] * w[:, None]).reshape(T, k, D).sum(dim=1)
    return y.reshape(B, S, D).to(x.dtype)


def moe_ffn(cfg: ModelConfig, p: MoE, h: torch.Tensor,
            decode: bool = False) -> torch.Tensor:
    """The MoE block in place of the dense MLP (the reference's
    ``moe_apply(..., decode=decode)``): a decode step runs at no-drop
    capacity (the batch's token count), so no copy is dropped."""
    B, S = h.shape[:2]
    return moe_apply(cfg, p, h, min_capacity=B * S if decode else 0)


# ---------------------------------------------------------------------------
# entry points: the dense family's layer loop, K/V stacking and cache
# layout, each layer running its own FFN (:meth:`MoEBlock.ffn`)
# ---------------------------------------------------------------------------

prefill = transformer.prefill
decode = transformer.decode
cache_logical_axes = transformer.cache_logical_axes
cache_seq_axes = transformer.cache_seq_axes


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    _check_layout(cfg)
    return transformer.cache_spec(cfg, batch, max_seq)
