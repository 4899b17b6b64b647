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

Expert parallelism is the reference's ``moe_ep`` as a per-rank body
(:func:`_tp_moe`, which :func:`moe_ep` and the entry points under rules
both run): under active sharding rules
(``repro_torch.distributed.sharding.use_rules``) on a ``DeviceMesh`` a
prefill of more than 4096 tokens is cut into (batch x sequence) blocks
over the mesh, each rank ranks its own block's copies at the block's
capacity, and two ``all_to_all_single`` calls over the ``model`` axis
carry copies to the rank that owns their expert column and back.
Capacity is per block, so where copies drop the result differs from the
one-column function's, as the reference's does.  Other MoE calls under
rules gather the tokens and sum each rank's experts over ``model``.
Without rules every path is the one-column body.

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
import types

import torch
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig, torch_dtype
from ..device import resolve_device
from ..distributed import tp
from ..kernels import counters
from ..obs.trace import model_span
from . import layers as L
from . import transformer

# all_to_all_single calls made by moe_ep, counted where they are made, as
# the kernels' wrappers count their launches
a2a_calls = 0
counters.register(__name__, "a2a_calls")


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


# the reference's logical axes of each tensor
MOE_AXES = {"router": ("fsdp", "experts"),
            "w_gate": ("experts", "fsdp", None),
            "w_up": ("experts", "fsdp", None),
            "w_down": ("experts", None, "fsdp")}


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


def expert_ffn(cfg: ModelConfig, p: MoE, xe: torch.Tensor,
               experts: slice = slice(None)) -> torch.Tensor:
    """xe: (E', C, D) slot-major copies of the experts ``experts`` (all
    by default) -> (E', C, D): one batched product per projection."""
    xe = xe.to(torch_dtype(cfg.compute_dtype))
    h = F.silu(torch.bmm(xe, p.w_gate[experts])) * torch.bmm(
        xe, p.w_up[experts])
    return torch.bmm(h, p.w_down[experts])


def capacity(cfg: ModelConfig, T: int, min_capacity: int = 0) -> int:
    return max(1, min_capacity,
               math.ceil(T * cfg.top_k * cfg.capacity_factor
                         / cfg.n_experts))


def local_dispatch(cfg: ModelConfig, x2d: torch.Tensor, idx: torch.Tensor,
                   n_cols: int, cap: int):
    """The reference's ``_local_dispatch``: per-destination send buffers
    on one rank.  x2d: (N, D); idx: (N, k).  Experts are column-sharded:
    expert e is local expert ``e % e_loc`` of column ``e // e_loc``, so
    copy ``(e, pos)``'s slot ``(col * e_loc + le) * cap + pos`` is
    ``e * cap + pos`` whatever ``n_cols``; a dropped copy takes the
    overflow row ``E * cap``.  Returns (send (n_cols, e_loc, cap, D), slot
    (N * k,), keep (N * k,))."""
    N, D = x2d.shape
    E, k = cfg.n_experts, cfg.top_k
    flat_e = idx.reshape(-1)                               # (N*k,)
    pos = sorted_positions(flat_e, E)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, E * cap))      # overflow row
    src = torch.arange(N * k, device=x2d.device) // k
    buf = torch.zeros((E * cap + 1, D), dtype=x2d.dtype, device=x2d.device)
    # kept slots are distinct; only the overflow row is written twice, and
    # it is never sent
    buf[slot] = x2d[src]
    return buf[:E * cap].view(n_cols, E // n_cols, cap, D), slot, keep


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.all_to_all(split_axis=0, concat_axis=0)`` over ``group``:
    block i of dim 0 goes to the group's rank i, block j of the result
    came from rank j (autograd flows through it)."""
    global a2a_calls
    x = x.contiguous()           # empty_like keeps a transposed x's strides
    out = dist_fn.all_to_all_single(torch.empty_like(x), x, group=group)
    a2a_calls += 1
    return out


def moe_ep_local(cfg: ModelConfig, p: MoE, x_blk: torch.Tensor,
                 n_cols: int = 1, col: int = 0, group=None,
                 min_capacity: int = 0, local: bool = False) -> torch.Tensor:
    """The reference's ``_moe_ep_local``: one rank's block (b, s, D) ->
    (b, s, D) in its dtype.  Capacity comes from the block's own token
    count; the send buffer goes to the ``n_cols`` expert columns over
    ``group`` (``None``: one column, no collective), this rank's experts
    ``col * e_loc .. (col + 1) * e_loc`` run on what every column sent,
    and the results go back the same way.  ``local``: ``p`` holds this
    column's experts alone (the rank's shard under ``distributed.tp``)."""
    b, s, D = x_blk.shape
    N, E, k = b * s, cfg.n_experts, cfg.top_k
    e_loc = E // n_cols
    cap = capacity(cfg, N, min_capacity)
    x2d = x_blk.reshape(N, D)
    with model_span("moe.route"):
        vals, idx = route(cfg, p.router, x2d)
    with model_span("moe.dispatch"):
        send, slot, keep = local_dispatch(cfg, x2d, idx, n_cols, cap)
        recv = send if group is None else _all_to_all(send, group)
    with model_span("moe.experts"):
        # recv: (n_src, e_loc, cap, D) -> (e_loc, n_src * cap, D)
        n_src = recv.shape[0]
        xe = recv.transpose(0, 1).reshape(e_loc, n_src * cap, D)
        ye = expert_ffn(cfg, p, xe, slice(None) if local
                        else slice(col * e_loc, (col + 1) * e_loc))
        ye = ye.reshape(e_loc, n_src, cap, D).transpose(0, 1)
    with model_span("moe.combine"):
        back = ye if group is None else _all_to_all(ye, group)
        back = torch.cat([back.reshape(E * cap, D),
                          back.new_zeros((1, D))])         # dropped -> 0
        w = (vals.reshape(-1) * keep).to(back.dtype)
        y = (back[slot] * w[:, None]).reshape(N, k, D).sum(dim=1)
    return y.reshape(b, s, D).to(x_blk.dtype)


def moe_apply(cfg: ModelConfig, p: MoE, x: torch.Tensor,
              min_capacity: int = 0) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) in x's dtype: the one-column body, which
    computes the reference's ``moe_dense`` (and its ``moe_ep`` without
    rules)."""
    return moe_ep_local(cfg, p, x, min_capacity=min_capacity)


def moe_ep(cfg: ModelConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """Expert-parallel MoE, the reference's ``moe_ep``, on the global x
    (B, S, D): tokens sharded over (batch axes x ``model``), experts over
    ``model``.  Under rules on a ``DeviceMesh`` each rank takes its block
    of ``x`` (the rows on the batch axes, the sequence on ``model``: the
    reference's ``pspec_x``) and of the experts, runs the body the entry
    points run under rules (:func:`_tp_moe`: :func:`moe_ep_local` with two
    ``all_to_all_single`` over ``model``, or where the shapes do not
    divide the mesh or it has no ``model`` axis, the dense function: the
    reference's fallbacks), and the blocks are all-gathered, so every rank
    returns the global (B, S, D).  Without rules, or with rules on a plain
    mapping, the one-column body."""
    if tp.layout() is None:
        return moe_apply(cfg, p, x)
    B, S, _ = x.shape
    with tp.entry(B, S) as act:
        blocks = types.SimpleNamespace(**{
            n: tp.local_block(getattr(p, n), MOE_AXES[n]) for n in MOE_AXES})
        y = _tp_moe(cfg, blocks, tp.token_block(x), decode=False, ep=True)
        return tp.batch_full(tp.seq_full(y, act.sp), B)


def moe_ffn(cfg: ModelConfig, p: MoE, h: torch.Tensor,
            decode: bool = False) -> torch.Tensor:
    """The MoE block in place of the dense MLP, the reference's
    ``moe_apply(..., decode=decode)``: a decode step runs at no-drop
    capacity (the batch's token count), so no copy is dropped; a prefill
    of more than 4096 tokens runs expert-parallel (:func:`moe_ep`, the
    one-column body without rules).  Inside an entry point's call under
    rules, :func:`_tp_moe` on the rank's residual."""
    act = tp.activation()
    if act is not None:
        return _tp_moe(cfg, p, h, decode,
                       ep=not decode and act.B * act.S > 4096)
    B, S = h.shape[:2]
    if decode:
        return moe_apply(cfg, p, h, min_capacity=B * S)
    if B * S > 4096:
        return moe_ep(cfg, p, h)
    return moe_apply(cfg, p, h)


def _moe_shapes(cfg: ModelConfig) -> dict:
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_expert
    return {"router": (D, E), "w_gate": (E, D, Fe), "w_up": (E, D, Fe),
            "w_down": (E, Fe, D)}


def _tp_moe(cfg: ModelConfig, p, h: torch.Tensor, decode: bool, ep: bool):
    """The MoE block on the rank's residual ``h`` under rules, ``p`` the
    rank's block of the weights, with the reference's capacities.  With
    ``ep`` (:func:`moe_ep`, or a prefill of more than 4096 tokens), where
    the residual's block is ``moe_ep``'s block (the rows on every batch
    axis, the sequence on ``model``) and the experts divide ``model``,
    :func:`moe_ep_local` on it with the rank's experts, capacity from the
    block's tokens.  Otherwise the tokens are gathered whole and routed at
    the whole batch's capacity (no-drop at decode), each rank runs its own
    experts (over ``model`` where they divide, all of them where not), and
    the partial sums are all-reduced over ``model`` and cut back to the
    rank's block: the dense function's result."""
    lay, act = tp.layout(), tp.activation()
    sh = _moe_shapes(cfg)
    M, E, k = lay.model, cfg.n_experts, cfg.top_k
    sharded = tp.model_sharded(MOE_AXES["w_gate"], sh["w_gate"], 0)
    if not sharded:
        tp.replicated("moe experts")
    whole = tp.full_param if sharded else tp.full   # the rank's experts, or all
    experts = {n: whole(getattr(p, n), MOE_AXES[n], sh[n])
               for n in ("w_gate", "w_up", "w_down")}
    pe = types.SimpleNamespace(
        router=tp.full(p.router, MOE_AXES["router"], sh["router"]),
        **experts)
    batch_all = tuple(a for a in lay.rules.rules.get("batch", ())
                      if a in lay.sizes)
    if ep and sharded and act.sp and act.batch == batch_all:
        return moe_ep_local(cfg, pe, h, M, lay.model_rank,
                            lay.group("model"), local=True)
    N = act.B * act.S
    x = tp.batch_full(tp.seq_full(h, act.sp), act.B)       # (B, S, D)
    x2d = x.reshape(N, -1)
    D = x2d.shape[1]
    cap = capacity(cfg, N, N if decode else 0)
    vals, idx = route(cfg, pe.router, x2d)
    n_cols, col = (M, lay.model_rank) if sharded else (1, 0)
    send, slot, keep = local_dispatch(cfg, x2d, idx, n_cols, cap)
    e_loc = E // n_cols
    ye = expert_ffn(cfg, pe, send[col])                    # (e_loc, cap, D)
    back = x2d.new_zeros((E * cap + 1, D))
    back[col * e_loc * cap:(col + 1) * e_loc * cap] = ye.reshape(-1, D)
    w = (vals.reshape(-1) * keep).to(back.dtype)
    y = (back[slot] * w[:, None]).reshape(N, k, D).sum(dim=1)
    if sharded:
        y = tp.reduce(y, "model")
    y = tp.batch_block(y.reshape(act.B, act.S, D).to(h.dtype))
    return tp.model_block(y) if act.sp else y


# ---------------------------------------------------------------------------
# entry points: at ``moe_every == 1`` the dense family's layer loop, K/V
# stacking and cache layout, each layer running its own FFN
# (:meth:`MoEBlock.ffn`); above it the superblocks
# ---------------------------------------------------------------------------

LEAVES = ("k_dense", "v_dense", "k_moe", "v_moe")


def _prefill_superblocks(cfg: ModelConfig, p: AlternatingMoE, batch: dict):
    """Whole prompts through every superblock; returns the final residual
    (B, S, D) and the four cache leaves at prompt length."""
    act = tp.activation()
    x = L.embed_tokens(cfg, p.tok, batch["tokens"])
    positions = torch.arange(batch["tokens"].shape[1], device=x.device)
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
    x = transformer.out_rows(x, act)
    return L.apply_norm(p.ln_f, x, cfg.norm), cache


def forward(cfg: ModelConfig, p, batch: dict) -> torch.Tensor:
    """Full-sequence logits (B, S, V), the reference's ``forward``: the
    layer stack without a cache, the MoE layers at the prefill capacity
    (a copy can be dropped), each layer rematerialized in the backward."""
    if cfg.moe_every == 1:
        return transformer.forward(cfg, p, batch)
    B, S = batch["tokens"].shape
    with tp.entry(B, S) as act:
        x = L.embed_tokens(cfg, p.tok, batch["tokens"])
        positions = torch.arange(S, device=x.device)
        for sb in p.blocks:
            for lp in sb.dense_layers:
                x = L.remat(transformer._block, cfg, lp, x, positions)
            x = L.remat(transformer._block, cfg, sb.moe_layer, x, positions)
        x = L.apply_norm(p.ln_f, x, cfg.norm)
        return L.lm_head(cfg, p.tok, x, tp.sp(act))


def prefill(cfg: ModelConfig, p, batch: dict):
    """Whole prompts; returns (last-token logits (B, 1, V), the cache at
    prompt length).  The MoE layers run at the reference's prefill
    capacity, where a copy can be dropped."""
    if cfg.moe_every == 1:
        return transformer.prefill(cfg, p, batch)
    with tp.entry(*batch["tokens"].shape) as act:
        x, cache = _prefill_superblocks(cfg, p, batch)
        return transformer.out_batch(L.lm_head(cfg, p.tok, x[:, -1:]),
                                     act), cache


def decode(cfg: ModelConfig, p, token, pos, cache: dict):
    """One decode step, every cache leaf written in place (the returned
    cache is the same dict of the same tensors), the MoE layers at no-drop
    capacity.  ``pos``: a scalar or a per-slot (B,) vector."""
    if cfg.moe_every == 1:
        return transformer.decode(cfg, p, token, pos, cache)
    B = token.shape[0]
    with tp.entry(B, 1) as act:
        x = L.embed_tokens(cfg, p.tok, token)
        pos = L.position_vector(pos, B, x.device)
        pos = tp.batch_block(pos)
        return _decode_superblocks(cfg, p, x, pos, cache, act)


def _decode_superblocks(cfg: ModelConfig, p, x, pos, cache: dict, act):
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
    x = L.apply_norm(p.ln_f, transformer.out_rows(x, act), cfg.norm)
    return transformer.out_batch(L.lm_head(cfg, p.tok, x), act), cache


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
