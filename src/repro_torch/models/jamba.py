"""Jamba-style hybrid (arXiv:2403.19887): the port's counterpart of
``repro/models/jamba.py``.  Attention and mamba layers interleave 1:7, and
every second layer's feed-forward is an MoE block (16 of 32 layers for
jamba-v0.1-52b).

A superblock is ``attn_every = 8`` layers, in the reference's order::

  pos 0:        attention + dense MLP     (``transformer.Block``)
  pos 1,3,5,7:  mamba + MoE               (``mamba_moe[0..3]``)
  pos 2,4,6:    mamba + dense MLP         (``mamba_dense[0..2]``)

The attention layers carry no RoPE: prefill runs the ``flash_attention``
kernel (``layers.attention_apply(..., rope=False)``), decode the
``ragged_decode`` kernel on the stacked ``(nb, B, Smax, Hkv, hd)`` caches
(``layers.attention_decode_inplace(..., rope=False)``, with its edge
repair for ``pos >= Smax``).  The mamba layers are ``models/mamba2.py``'s.
The MoE layers call ``moe.moe_ffn`` directly: prefill at capacity, where
a copy can be dropped, decode at no-drop capacity.  The hybrid's
``moe_every = 2`` is this superblock's, not the MoE family's alternating
layout, and the MoE family's own check (``moe._check_layout``) is not on
this path.

The cache holds six leaves with the reference's names, shapes and dtypes:
``k`` / ``v`` ``(nb, B, Smax, Hkv, hd)``, ``ssm_moe`` / ``ssm_dense``
``(nb, 4 | 3, B, nh, hp, ds)`` float32 and ``conv_moe`` / ``conv_dense``
``(nb, 4 | 3, B, K-1, conv_dim)``.  Only ``k`` and ``v`` grow with
position.  Decode writes every leaf in place, so their ``data_ptr`` never
changes.  There is no ``prefill_chunk``, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig, torch_dtype
from ..device import resolve_device
from ..distributed import tp
from . import layers as L
from . import mamba2 as S
from . import transformer
from .moe import MoE, moe_ffn, moe_init

N_MOE, N_DENSE = 4, 3          # mamba layers of a superblock, by FFN kind
# the mamba layers after the attention layer: (leaf suffix, index)
ORDER = (("moe", 0), ("dense", 0), ("moe", 1), ("dense", 1), ("moe", 2),
         ("dense", 2), ("moe", 3))


class MambaBlock(nn.Module):
    """One mamba layer: ``ln1``, ``ssm``, ``ln2`` and ``moe`` (an
    :class:`~repro_torch.models.moe.MoE`) or ``mlp``."""

    def __init__(self, ln1: L.Norm, ssm: S.SSM, ln2: L.Norm, ffn):
        super().__init__()
        self.ln1, self.ssm, self.ln2 = ln1, ssm, ln2
        if isinstance(ffn, MoE):
            self.moe = ffn
        else:
            self.mlp = ffn

    def ffn(self, cfg: ModelConfig, h, decode: bool = False):
        if hasattr(self, "moe"):
            return moe_ffn(cfg, self.moe, h, decode)
        return L.mlp_apply(cfg, self.mlp, h)


class SuperBlock(nn.Module):
    """``attn_layer``, ``mamba_moe`` (4 layers) and ``mamba_dense`` (3)."""

    def __init__(self, attn_layer: transformer.Block,
                 mamba_moe: list[MambaBlock], mamba_dense: list[MambaBlock]):
        super().__init__()
        self.attn_layer = attn_layer
        self.mamba_moe = nn.ModuleList(mamba_moe)
        self.mamba_dense = nn.ModuleList(mamba_dense)

    def mamba(self, kind: str, i: int) -> MambaBlock:
        return (self.mamba_moe if kind == "moe" else self.mamba_dense)[i]


class Jamba(nn.Module):
    """``tok``, ``blocks`` (one :class:`SuperBlock` per ``attn_every``
    layers) and ``ln_f``."""

    def __init__(self, tok: L.Embedding, blocks: list[SuperBlock],
                 ln_f: L.Norm):
        super().__init__()
        self.tok = tok
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = ln_f

    @property
    def device(self) -> torch.device:
        return self.tok.embed.device


def _n_blocks(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def init(cfg: ModelConfig, generator: torch.Generator,
         device=None) -> Jamba:
    """Random weights from the reference's distributions, drawn on
    ``device`` (the card unless the caller passes one) from ``generator``.
    Each expert tensor is drawn in float32 before its cast, as the
    reference draws it.  Parity tests carry the reference's weights over
    with :func:`repro_torch.models.convert.params_from_numpy`."""
    device = resolve_device(device)
    gen, D = generator, cfg.d_model

    def norm():
        return L.norm_init(D, cfg.norm, device)

    def mamba(moe: bool) -> MambaBlock:
        return MambaBlock(norm(), S.ssm_layer_init(cfg, gen, device), norm(),
                          moe_init(cfg, gen, device) if moe
                          else L.mlp_init(cfg, gen, device))

    def attn_layer() -> transformer.Block:
        return transformer.Block(norm(), L.attention_init(cfg, gen, device),
                                 norm(), L.mlp_init(cfg, gen, device))

    tok = L.embedding_init(cfg, gen, device)
    blocks = [SuperBlock(attn_layer(), [mamba(True) for _ in range(N_MOE)],
                         [mamba(False) for _ in range(N_DENSE)])
              for _ in range(_n_blocks(cfg))]
    return Jamba(tok, blocks, norm())


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _mamba_full(cfg: ModelConfig, lp: MambaBlock, x):
    out, state = S.ssm_full(cfg, lp.ssm, L.apply_norm(lp.ln1, x, cfg.norm))
    x = x + out
    return x + lp.ffn(cfg, L.apply_norm(lp.ln2, x, cfg.norm)), state


def _mamba(cfg: ModelConfig, lp: MambaBlock, x):
    """A mamba layer without its state: the training forward's block."""
    return _mamba_full(cfg, lp, x)[0]


def _mamba_step(cfg: ModelConfig, lp: MambaBlock, x, ssm: torch.Tensor,
                conv: torch.Tensor):
    """One decode step of a mamba layer; its state is written into
    ``ssm`` and ``conv`` (views of the cache) in place."""
    out, (h, new_conv) = S.ssm_step(
        cfg, lp.ssm, L.apply_norm(lp.ln1, x, cfg.norm), ssm, conv)
    ssm.copy_(h)
    conv.copy_(new_conv)
    x = x + out
    return x + lp.ffn(cfg, L.apply_norm(lp.ln2, x, cfg.norm), decode=True)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, p: Jamba, batch: dict) -> torch.Tensor:
    """Full-sequence logits (B, S, V), the reference's ``forward``: every
    superblock without a cache, each layer rematerialized in the backward
    (the reference checkpoints the same blocks; under rules the logits of
    the rank's batch rows)."""
    B, S_ = batch["tokens"].shape
    with tp.entry(B, S_) as act:
        x = L.embed_tokens(cfg, p.tok, batch["tokens"])
        positions = torch.arange(S_, device=x.device)
        for sb in p.blocks:
            x = L.remat(transformer._block, cfg, sb.attn_layer, x,
                        positions, False)
            for kind, i in ORDER:
                x = L.remat(_mamba, cfg, sb.mamba(kind, i), x)
        x = L.apply_norm(p.ln_f, x, cfg.norm)
        return L.lm_head(cfg, p.tok, x, tp.sp(act))


def prefill(cfg: ModelConfig, p: Jamba, batch: dict):
    """Whole prompts; returns (last-token logits (B, 1, V), the six-leaf
    cache with prompt-length ``k`` / ``v``; under rules the rank's
    block)."""
    B, S_ = batch["tokens"].shape
    with tp.entry(B, S_) as act:
        return _prefill(cfg, p, batch, act)


def _prefill(cfg: ModelConfig, p: Jamba, batch: dict, act):
    x = L.embed_tokens(cfg, p.tok, batch["tokens"])
    positions = torch.arange(batch["tokens"].shape[1], device=x.device)
    ks, vs = [], []
    states = {kind: ([], []) for kind in ("moe", "dense")}
    for sb in p.blocks:
        x, (k, v) = transformer._block_prefill(cfg, sb.attn_layer, x,
                                               positions, rope=False)
        ks.append(k)
        vs.append(v)
        per = {kind: ([], []) for kind in ("moe", "dense")}
        for kind, i in ORDER:
            x, (h, conv) = _mamba_full(cfg, sb.mamba(kind, i), x)
            per[kind][0].append(h)
            per[kind][1].append(conv)
        for kind, (hs, convs) in per.items():
            states[kind][0].append(torch.stack(hs))
            states[kind][1].append(torch.stack(convs))
    x = L.apply_norm(p.ln_f, transformer.out_rows(x, act), cfg.norm)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    for kind, (hs, convs) in states.items():
        cache[f"ssm_{kind}"] = torch.stack(hs)
        cache[f"conv_{kind}"] = torch.stack(convs)
    return transformer.out_batch(L.lm_head(cfg, p.tok, x[:, -1:]), act), \
        cache


def decode(cfg: ModelConfig, p: Jamba, token, pos, cache: dict):
    """One decode step, every cache leaf written in place (the returned
    cache is the same dict of the same tensors).  ``pos``: a scalar or a
    per-slot (B,) vector; only the attention layers read it."""
    B = token.shape[0]
    with tp.entry(B, 1) as act:
        x = L.embed_tokens(cfg, p.tok, token)
        pos = L.position_vector(pos, B, x.device)
        pos = tp.batch_block(pos)
        for b, sb in enumerate(p.blocks):
            x = transformer._block_decode(cfg, sb.attn_layer, x, cache["k"],
                                          cache["v"], b, pos, rope=False)
            for kind, i in ORDER:
                x = _mamba_step(cfg, sb.mamba(kind, i), x,
                                cache[f"ssm_{kind}"][b, i],
                                cache[f"conv_{kind}"][b, i])
        x = L.apply_norm(p.ln_f, transformer.out_rows(x, act), cfg.norm)
        return transformer.out_batch(L.lm_head(cfg, p.tok, x), act), cache


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """{leaf name: (shape, dtype)} of the decode cache."""
    nb = _n_blocks(cfg)
    nh, hp, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv = (batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * ds)
    cdt = torch_dtype(cfg.compute_dtype)
    kv = ((nb, batch, max_seq, cfg.n_kv_heads, cfg.hd), cdt)
    return {"k": kv, "v": kv,
            "ssm_moe": ((nb, N_MOE, batch, nh, hp, ds), torch.float32),
            "conv_moe": ((nb, N_MOE, *conv), cdt),
            "ssm_dense": ((nb, N_DENSE, batch, nh, hp, ds), torch.float32),
            "conv_dense": ((nb, N_DENSE, *conv), cdt)}


def cache_logical_axes(cfg: ModelConfig):
    return {
        "k": (None, "batch", "seq_mp", None, None),
        "v": (None, "batch", "seq_mp", None, None),
        "ssm_moe": (None, None, "batch", None, None, None),
        "conv_moe": (None, None, "batch", None, "ff"),
        "ssm_dense": (None, None, "batch", None, None, None),
        "conv_dense": (None, None, "batch", None, "ff"),
    }


def cache_seq_axes(cfg: ModelConfig):
    """Only the attention K/V grows with position; SSM and conv state is
    O(1)."""
    return {"k": 2, "v": 2, "ssm_moe": None, "conv_moe": None,
            "ssm_dense": None, "conv_dense": None}
