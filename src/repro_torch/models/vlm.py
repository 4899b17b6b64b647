"""Llama-3.2-Vision-style VLM text backbone: the port's counterpart of
``repro/models/vlm.py``.  A self-attention decoder with a gated
cross-attention layer every ``cross_attn_every``-th layer.

The vision frontend is a stub, as in the reference: ``image_embeds`` (B,
n_image_tokens, d_model) arrive precomputed.  A superblock is
``cross_attn_every - 1`` self layers (``transformer.Block``, with RoPE)
and one cross layer (:class:`CrossBlock`) whose two residuals are scaled
by ``tanh`` of a scalar gate (float32, zero at init, as in Llama-Vision).
The cross layer's keys and values are projected from the image and take
no RoPE.

Kernels: prefill runs ``flash_attention`` causal in the self layers and
non-causal over the ``n_image_tokens`` keys in the cross layers; decode
runs ``ragged_decode`` in both, the cross layers with every slot at
position ``n_image_tokens - 1``.

The cache holds four leaves with the reference's names, shapes and
dtypes: ``k_self`` / ``v_self`` ``(nb, per_self, B, Smax, Hkv, hd)`` and
``k_cross`` / ``v_cross`` ``(nb, B, n_image_tokens, Hkv, hd)``.  Only the
self leaves grow with position; the cross leaves are carried whole in
sessions and never written after prefill.  Decode writes the self leaves
in place through ``attention_decode_inplace`` on a ``(nb * per_self, B,
Smax, Hkv, hd)`` view, with its edge rule (a slot at ``pos >= Smax``
writes nothing), so their ``data_ptr`` never changes and no step syncs
with the host.  There is no ``prefill_chunk``, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig, torch_dtype
from ..device import resolve_device
from ..distributed import tp
from . import layers as L
from . import transformer


class CrossBlock(nn.Module):
    """One gated cross layer: ``ln1``, ``xattn``, ``gate_attn``, ``ln2``,
    ``mlp``, ``gate_mlp`` (the gates float32 scalars)."""

    def __init__(self, ln1: L.Norm, xattn: L.Attention,
                 gate_attn: torch.Tensor, ln2: L.Norm, mlp: L.MLP,
                 gate_mlp: torch.Tensor):
        super().__init__()
        self.ln1, self.xattn, self.ln2, self.mlp = ln1, xattn, ln2, mlp
        self.gate_attn = L._weight(gate_attn.float().reshape(()))
        self.gate_mlp = L._weight(gate_mlp.float().reshape(()))


class SuperBlock(nn.Module):
    """``self_layers`` (``cross_attn_every - 1`` ``transformer.Block``s)
    and ``cross`` (one :class:`CrossBlock`)."""

    def __init__(self, self_layers: list[transformer.Block],
                 cross: CrossBlock):
        super().__init__()
        self.self_layers = nn.ModuleList(self_layers)
        self.cross = cross


class VLM(nn.Module):
    """``tok``, ``blocks`` (one :class:`SuperBlock` per
    ``cross_attn_every`` layers) and ``ln_f``."""

    def __init__(self, tok: L.Embedding, blocks: list[SuperBlock],
                 ln_f: L.Norm):
        super().__init__()
        self.tok = tok
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = ln_f

    @property
    def device(self) -> torch.device:
        return self.tok.embed.device


def layout(cfg: ModelConfig) -> tuple[int, int]:
    """(superblocks, self layers per superblock)."""
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> VLM:
    """Random weights from the reference's distributions (gates zero),
    drawn on ``device`` (the card unless the caller passes one) from
    ``generator``.  Parity tests carry the reference's weights over with
    :func:`repro_torch.models.convert.params_from_numpy`."""
    device = resolve_device(device)
    gen, D = generator, cfg.d_model
    nb, per_self = layout(cfg)

    def norm():
        return L.norm_init(D, cfg.norm, device)

    def self_layer() -> transformer.Block:
        return transformer.Block(norm(), L.attention_init(cfg, gen, device),
                                 norm(), L.mlp_init(cfg, gen, device))

    def cross_layer() -> CrossBlock:
        zero = torch.zeros((), device=device)
        return CrossBlock(norm(), L.attention_init(cfg, gen, device), zero,
                          norm(), L.mlp_init(cfg, gen, device), zero)

    tok = L.embedding_init(cfg, gen, device)
    blocks = [SuperBlock([self_layer() for _ in range(per_self)],
                         cross_layer()) for _ in range(nb)]
    return VLM(tok, blocks, norm())


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _gated(cfg: ModelConfig, lp: CrossBlock, x, attn_out):
    """The rest of a cross layer once its attention ``attn_out`` of the
    ``ln1``-normed residual is known: both residuals scaled by ``tanh`` of
    their gate."""
    x = x + torch.tanh(lp.gate_attn).to(x.dtype) * attn_out
    h = L.apply_norm(lp.ln2, x, cfg.norm)
    return x + torch.tanh(lp.gate_mlp).to(x.dtype) * L.mlp_apply(
        cfg, lp.mlp, h)


def _run(cfg: ModelConfig, p: VLM, batch: dict):
    """Whole prompts with their images through every layer; returns the
    final residual (B, S, D) and the four cache leaves at prompt
    length."""
    x = L.embed_tokens(cfg, p.tok, batch["tokens"])
    img = tp.batch_block(batch["image_embeds"].to(
        torch_dtype(cfg.compute_dtype)))
    positions = torch.arange(batch["tokens"].shape[1], device=x.device)
    leaves = {name: [] for name in ("k_self", "v_self", "k_cross",
                                    "v_cross")}
    for sb in p.blocks:
        ks, vs = [], []
        for lp in sb.self_layers:
            x, (k, v) = transformer._block_prefill(cfg, lp, x, positions)
            ks.append(k)
            vs.append(v)
        h = L.apply_norm(sb.cross.ln1, x, cfg.norm)
        a, k, v = L.attention_apply(cfg, sb.cross.xattn, h,
                                    positions=positions, kv_src=img)
        x = _gated(cfg, sb.cross, x, a)
        leaves["k_self"].append(torch.stack(ks))
        leaves["v_self"].append(torch.stack(vs))
        leaves["k_cross"].append(k)
        leaves["v_cross"].append(v)
    cache = {name: torch.stack(ts) for name, ts in leaves.items()}
    return L.apply_norm(p.ln_f, x, cfg.norm), cache


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _cross_layer(cfg: ModelConfig, lp: CrossBlock, x, img, positions):
    """A cross layer without its K/V: the training forward's block."""
    h = L.apply_norm(lp.ln1, x, cfg.norm)
    a, _, _ = L.attention_apply(cfg, lp.xattn, h, positions=positions,
                                kv_src=img, cache=False)
    return _gated(cfg, lp, x, a)


def forward(cfg: ModelConfig, p: VLM, batch: dict) -> torch.Tensor:
    """``batch``: ``tokens`` (B, S) and ``image_embeds`` (B, n_img, D) ->
    full-sequence logits (B, S, V) (under rules of the rank's tokens).
    No cache is kept; each layer is rematerialized in the backward, as
    the dense family's are."""
    with tp.entry(*batch["tokens"].shape) as act:
        x = L.embed_tokens(cfg, p.tok, batch["tokens"])
        img = tp.batch_block(batch["image_embeds"].to(
            torch_dtype(cfg.compute_dtype)))
        positions = torch.arange(batch["tokens"].shape[1], device=x.device)
        for sb in p.blocks:
            for lp in sb.self_layers:
                x = L.remat(transformer._block, cfg, lp, x, positions)
            x = L.remat(_cross_layer, cfg, sb.cross, x, img, positions)
        x = L.apply_norm(p.ln_f, x, cfg.norm)
        return L.lm_head(cfg, p.tok, x, tp.sp(act))


def prefill(cfg: ModelConfig, p: VLM, batch: dict):
    """Whole prompts with their images; returns (last-token logits (B, 1,
    V), the four-leaf cache with prompt-length self leaves; under rules
    the rank's block)."""
    with tp.entry(*batch["tokens"].shape) as act:
        x, cache = _run(cfg, p, batch)
        x = transformer.out_rows(x, act)[:, -1:]
        return transformer.out_batch(L.lm_head(cfg, p.tok, x), act), cache


def decode(cfg: ModelConfig, p: VLM, token, pos, cache: dict):
    """One decode step: the self leaves written in place, the cross leaves
    only read (the returned cache is the same dict of the same tensors).
    ``pos``: a scalar or a per-slot (B,) vector."""
    B = token.shape[0]
    with tp.entry(B, 1) as act:
        x = L.embed_tokens(cfg, p.tok, token)
        pos = L.position_vector(pos, B, x.device)
        pos = tp.batch_block(pos)
        return _decode(cfg, p, x, pos, cache, act)


def _decode(cfg: ModelConfig, p: VLM, x, pos, cache: dict, act):
    nb, per_self = layout(cfg)
    # (nb, per_self, B, Smax, Hkv, hd) as (nb * per_self, ...): a view,
    # so the in-place writes land in the cache
    ks = cache["k_self"].view(nb * per_self, *cache["k_self"].shape[2:])
    vs = cache["v_self"].view(nb * per_self, *cache["v_self"].shape[2:])
    for b, sb in enumerate(p.blocks):
        for i, lp in enumerate(sb.self_layers):
            x = transformer._block_decode(cfg, lp, x, ks, vs,
                                          b * per_self + i, pos)
        h = L.apply_norm(sb.cross.ln1, x, cfg.norm)
        a = L.attention_cross_decode(cfg, sb.cross.xattn, h,
                                     cache["k_cross"][b], cache["v_cross"][b])
        x = _gated(cfg, sb.cross, x, a)
    x = L.apply_norm(p.ln_f, transformer.out_rows(x, act), cfg.norm)
    return transformer.out_batch(L.lm_head(cfg, p.tok, x), act), cache


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """{leaf name: (shape, dtype)} of the decode cache."""
    nb, per_self = layout(cfg)
    cdt = torch_dtype(cfg.compute_dtype)
    kv = (cfg.n_kv_heads, cfg.hd)
    self_leaf = ((nb, per_self, batch, max_seq, *kv), cdt)
    cross_leaf = ((nb, batch, cfg.n_image_tokens, *kv), cdt)
    return {"k_self": self_leaf, "v_self": self_leaf,
            "k_cross": cross_leaf, "v_cross": cross_leaf}


def cache_logical_axes(cfg: ModelConfig):
    return {
        "k_self": (None, None, "batch", "seq_mp", None, None),
        "v_self": (None, None, "batch", "seq_mp", None, None),
        "k_cross": (None, "batch", "seq_mp", None, None),
        "v_cross": (None, "batch", "seq_mp", None, None),
    }


def cache_seq_axes(cfg: ModelConfig):
    """The cross K/V spans the (fixed) image tokens, not the decode
    position: carried whole in sessions, never trimmed."""
    return {"k_self": 3, "v_self": 3, "k_cross": None, "v_cross": None}
