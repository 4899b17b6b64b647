"""Mixture-of-Experts transformer (granite-moe, qwen3-moe): the port's
counterpart of ``repro/models/moe.py``.

Every MoE layer is attention (``models/layers.py``: the
``flash_attention`` kernel at prefill, ``ragged_decode`` at decode)
followed by an MoE block in place of the dense MLP.  The MoE block is a
softmax router over ``n_experts``, the top-k experts of each token with
their weights renormalised, and a SwiGLU expert FFN.

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

Two layouts, as in the reference:

* ``moe_every == 1`` (both shipped MoE configs): every layer is an MoE
  layer.  The layer loop, the ``k`` / ``v`` ``(L, B, Smax, Hkv, hd)``
  caches and their layout are the dense family's
  (``models/transformer.py``); only the block's ``ffn`` differs.
* ``moe_every > 1``: ``nb = n_layers // moe_every`` superblocks
  (:class:`SuperBlock`), each ``per_d = moe_every - 1`` dense
  ``transformer.Block``s followed by one :class:`MoEBlock`, in the
  reference's order (its ``_run_layers`` scan).  The cache holds four
  leaves with the reference's names, dtypes, logical axes and sequence
  axes: ``k_dense`` / ``v_dense`` ``(nb, per_d, B, Smax, Hkv, hd)`` and
  ``k_moe`` / ``v_moe`` ``(nb, B, Smax, Hkv, hd)``.  Decode writes them in
  place through ``attention_decode_inplace`` (the dense leaves on a
  ``(nb * per_d, B, Smax, Hkv, hd)`` view), with its edge rule: a slot at
  ``pos >= Smax`` writes nothing, as the reference's scatter drops the
  write.

The hybrid family (``models/jamba.py``) calls :func:`moe_ffn` inside its
own superblock.  There is no ``prefill_chunk``, as the reference has none:
the engine prefills MoE prompts whole.
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


def layout(cfg: ModelConfig) -> tuple[int, int]:
    """(superblocks, dense layers per superblock) of the ``moe_every > 1``
    layout; ``n_layers`` must be a multiple of ``moe_every``, as the
    reference's reshape of the stacked dense layers requires."""
    if cfg.n_layers % cfg.moe_every:
        raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of "
                         f"moe_every={cfg.moe_every}")
    return cfg.n_layers // cfg.moe_every, cfg.moe_every - 1


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


class SuperBlock(nn.Module):
    """``dense_layers`` (``moe_every - 1`` ``transformer.Block``s) and
    ``moe_layer`` (one :class:`MoEBlock`)."""

    def __init__(self, dense_layers: list[transformer.Block],
                 moe_layer: MoEBlock):
        super().__init__()
        self.dense_layers = nn.ModuleList(dense_layers)
        self.moe_layer = moe_layer


class AlternatingMoE(nn.Module):
    """The ``moe_every > 1`` layout: ``tok``, ``blocks`` (one
    :class:`SuperBlock` per ``moe_every`` layers) and ``ln_f``."""

    def __init__(self, tok: L.Embedding, blocks: list[SuperBlock],
                 ln_f: L.Norm):
        super().__init__()
        self.tok = tok
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = ln_f

    @property
    def device(self) -> torch.device:
        return self.tok.embed.device


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
         device=None) -> transformer.Transformer | AlternatingMoE:
    """Random weights from the reference's distributions, drawn on
    ``device`` (the card unless the caller passes one) from ``generator``:
    a ``transformer.Transformer`` of MoE layers at ``moe_every == 1``,
    else an :class:`AlternatingMoE`.  Not the reference's numbers: parity
    tests carry weights over with
    :func:`repro_torch.models.convert.params_from_numpy`."""
    _check_layout(cfg)
    device = resolve_device(device)

    def moe_layer() -> MoEBlock:
        return MoEBlock(L.norm_init(cfg.d_model, cfg.norm, device),
                        L.attention_init(cfg, generator, device),
                        L.norm_init(cfg.d_model, cfg.norm, device),
                        moe_init(cfg, generator, device))

    tok = L.embedding_init(cfg, generator, device)
    if cfg.moe_every == 1:
        layers = [moe_layer() for _ in range(cfg.n_layers)]
        return transformer.Transformer(
            tok, layers, L.norm_init(cfg.d_model, cfg.norm, device))
    nb, per_d = layout(cfg)
    blocks = [SuperBlock([transformer._layer_init(cfg, generator, device)
                          for _ in range(per_d)], moe_layer())
              for _ in range(nb)]
    return AlternatingMoE(tok, blocks,
                          L.norm_init(cfg.d_model, cfg.norm, device))


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
# entry points: at ``moe_every == 1`` the dense family's layer loop, K/V
# stacking and cache layout, each layer running its own FFN
# (:meth:`MoEBlock.ffn`); above it the superblocks
# ---------------------------------------------------------------------------

LEAVES = ("k_dense", "v_dense", "k_moe", "v_moe")


def _prefill_superblocks(cfg: ModelConfig, p: AlternatingMoE, batch: dict):
    """Whole prompts through every superblock; returns the final residual
    (B, S, D) and the four cache leaves at prompt length."""
    x = L.embed_tokens(cfg, p.tok, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    leaves = {name: [] for name in LEAVES}
    for sb in p.blocks:
        ks, vs = [], []
        for lp in sb.dense_layers:
            x, (k, v) = transformer._block_prefill(cfg, lp, x, positions)
            ks.append(k)
            vs.append(v)
        x, (k, v) = transformer._block_prefill(cfg, sb.moe_layer, x,
                                               positions)
        leaves["k_dense"].append(torch.stack(ks))
        leaves["v_dense"].append(torch.stack(vs))
        leaves["k_moe"].append(k)
        leaves["v_moe"].append(v)
    cache = {name: torch.stack(ts) for name, ts in leaves.items()}
    return L.apply_norm(p.ln_f, x, cfg.norm), cache


def forward(cfg: ModelConfig, p, batch: dict) -> torch.Tensor:
    """Full-sequence logits (B, S, V), the reference's ``forward``: the
    layer stack without a cache, the MoE layers at the prefill capacity
    (a copy can be dropped), each layer rematerialized in the backward."""
    if cfg.moe_every == 1:
        return transformer.forward(cfg, p, batch)
    x = L.embed_tokens(cfg, p.tok, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)
    for sb in p.blocks:
        for lp in sb.dense_layers:
            x = L.remat(transformer._block, cfg, lp, x, positions)
        x = L.remat(transformer._block, cfg, sb.moe_layer, x, positions)
    x = L.apply_norm(p.ln_f, x, cfg.norm)
    return L.lm_head(cfg, p.tok, x)


def prefill(cfg: ModelConfig, p, batch: dict):
    """Whole prompts; returns (last-token logits (B, 1, V), the cache at
    prompt length).  The MoE layers run at the reference's prefill
    capacity, where a copy can be dropped."""
    if cfg.moe_every == 1:
        return transformer.prefill(cfg, p, batch)
    x, cache = _prefill_superblocks(cfg, p, batch)
    return L.lm_head(cfg, p.tok, x[:, -1:]), cache


def decode(cfg: ModelConfig, p, token, pos, cache: dict):
    """One decode step, every cache leaf written in place (the returned
    cache is the same dict of the same tensors), the MoE layers at no-drop
    capacity.  ``pos``: a scalar or a per-slot (B,) vector."""
    if cfg.moe_every == 1:
        return transformer.decode(cfg, p, token, pos, cache)
    x = L.embed_tokens(cfg, p.tok, token)
    pos = L.position_vector(pos, x.shape[0], x.device)
    nb, per_d = layout(cfg)
    # (nb, per_d, B, Smax, Hkv, hd) as (nb * per_d, ...): a view, so the
    # in-place writes land in the cache
    kd = cache["k_dense"].view(nb * per_d, *cache["k_dense"].shape[2:])
    vd = cache["v_dense"].view(nb * per_d, *cache["v_dense"].shape[2:])
    for b, sb in enumerate(p.blocks):
        for i, lp in enumerate(sb.dense_layers):
            x = transformer._block_decode(cfg, lp, x, kd, vd, b * per_d + i,
                                          pos)
        x = transformer._block_decode(cfg, sb.moe_layer, x, cache["k_moe"],
                                      cache["v_moe"], b, pos)
    x = L.apply_norm(p.ln_f, x, cfg.norm)
    return L.lm_head(cfg, p.tok, x), cache


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """{leaf name: (shape, dtype)} of the decode cache."""
    _check_layout(cfg)
    if cfg.moe_every == 1:
        return transformer.cache_spec(cfg, batch, max_seq)
    nb, per_d = layout(cfg)
    kv = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    cdt = torch_dtype(cfg.compute_dtype)
    return {"k_dense": ((nb, per_d, *kv), cdt),
            "v_dense": ((nb, per_d, *kv), cdt),
            "k_moe": ((nb, *kv), cdt), "v_moe": ((nb, *kv), cdt)}


def cache_logical_axes(cfg: ModelConfig):
    if cfg.moe_every == 1:
        return transformer.cache_logical_axes(cfg)
    ax = ("batch", "seq_mp", None, None)
    return {"k_dense": (None, None, *ax), "v_dense": (None, None, *ax),
            "k_moe": (None, *ax), "v_moe": (None, *ax)}


def cache_seq_axes(cfg: ModelConfig):
    if cfg.moe_every == 1:
        return transformer.cache_seq_axes(cfg)
    return {"k_dense": 3, "v_dense": 3, "k_moe": 2, "v_moe": 2}
