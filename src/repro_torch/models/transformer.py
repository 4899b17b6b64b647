"""Dense decoder-only transformer (qwen2 / qwen2.5 / starcoder2 / smollm)
and encoder-only audio backbone (hubert): the port's counterpart of
``repro/models/transformer.py``.  The MoE family
(``models/moe.py``) shares its layer loop and cache layout: each layer
runs its own feed-forward through ``ffn``.  The hybrid family
(``models/jamba.py``) runs its attention layers through the same block
functions without RoPE, and the SSM family (``models/mamba2.py``) keeps
its parameters in the same :class:`Transformer` container.

Layers are a Python loop over per-layer ``nn.Module``s where the reference
scans stacked layer parameters (``lax.scan``) under ``jax.checkpoint``;
inference needs no rematerialization.  The decode caches stay one stacked
``(L, B, Smax, Hkv, hd)`` tensor per K and V, written in place.

The audio family reads precomputed frame embeddings (``batch["frames"]``,
B, T, D) where the dense one embeds token ids; its attention is
non-causal (``cfg.causal`` False) and it holds a ``head`` (D, vocab) that
only ``forward`` applies: ``prefill`` takes ``lm_head`` on the last
frame, as the reference does.  ``forward`` gives full-sequence logits, the
training compute (``repro_torch.train``): each block runs under
``layers.remat``, the reference's ``jax.checkpoint``, so the backward runs
its forward again (one more ``flash_attention`` launch a layer).
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig, torch_dtype
from ..device import resolve_device
from ..distributed import tp
from ..obs.trace import model_span
from . import layers as L


class Block(nn.Module):
    """One decoder layer: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, ln1: L.Norm, attn: L.Attention, ln2: L.Norm,
                 mlp: L.MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp

    def ffn(self, cfg: ModelConfig, h, decode: bool = False):
        """The layer's feed-forward on the normed residual ``h``.
        ``decode`` says that ``h`` is one decode step, which the MoE
        block's capacity depends on; the dense MLP ignores it."""
        return L.mlp_apply(cfg, self.mlp, h)


class Transformer(nn.Module):
    """The parameters of a model whose layers form one list (dense, audio,
    MoE, SSM): ``tok`` (embedding and head), ``layers`` (one
    :class:`Block`, ``moe.MoEBlock`` or ``mamba2.SSMLayer`` per layer),
    ``ln_f`` and, for audio, ``head`` (D, vocab) in the compute dtype."""

    def __init__(self, tok: L.Embedding, layers: list[Block], ln_f: L.Norm,
                 head: torch.Tensor | None = None):
        super().__init__()
        self.tok = tok
        self.layers = nn.ModuleList(layers)
        self.ln_f = ln_f
        self.head = None if head is None else L._weight(
            head.to(tok.embed.dtype))

    @property
    def device(self) -> torch.device:
        return self.tok.embed.device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(cfg: ModelConfig, gen: torch.Generator, device) -> Block:
    return Block(L.norm_init(cfg.d_model, cfg.norm, device),
                 L.attention_init(cfg, gen, device),
                 L.norm_init(cfg.d_model, cfg.norm, device),
                 L.mlp_init(cfg, gen, device))


def init(cfg: ModelConfig, generator: torch.Generator,
         device=None) -> Transformer:
    """Random weights from the reference's distributions (uniform
    +-1/sqrt(in), embedding N(0, 1) * 0.02, zero biases, unit norms), drawn
    on ``device`` (the card unless the caller passes one) from
    ``generator`` (which must live on that device).  Not the reference's
    numbers: parity tests carry weights over with
    :func:`repro_torch.models.convert.params_from_numpy`."""
    if cfg.family not in ("dense", "audio"):
        raise NotImplementedError(
            f"family {cfg.family!r}: this module builds 'dense' and 'audio'")
    device = resolve_device(device)
    tok = L.embedding_init(cfg, generator, device)
    layers = [_layer_init(cfg, generator, device)
              for _ in range(cfg.n_layers)]
    head = None
    if cfg.family == "audio":      # classification head over frame vocab
        head = L.dense_init(generator, cfg.d_model, cfg.vocab,
                            torch_dtype(cfg.compute_dtype), device)
    return Transformer(tok, layers, L.norm_init(cfg.d_model, cfg.norm,
                                                device), head)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _block_prefill(cfg: ModelConfig, lp: Block, x, positions,
                   rope: bool = True, cache: bool = True):
    with model_span("attn"):
        h = L.apply_norm(lp.ln1, x, cfg.norm)
        a, k, v = L.attention_apply(cfg, lp.attn, h, positions=positions,
                                    rope=rope, cache=cache)
        x = x + a
    h = L.apply_norm(lp.ln2, x, cfg.norm)
    x = x + lp.ffn(cfg, h)
    return x, (k, v)


def _block(cfg: ModelConfig, lp: Block, x, positions, rope: bool = True):
    """One layer without its K/V: the training forward's block."""
    return _block_prefill(cfg, lp, x, positions, rope, cache=False)[0]


def _block_prefill_chunk(cfg: ModelConfig, lp: Block, x, kfull, vfull,
                         layer_idx: int, start, qlen, positions):
    h = L.apply_norm(lp.ln1, x, cfg.norm)
    x = x + L.attention_prefill_chunk_inplace(cfg, lp.attn, h, kfull, vfull,
                                              layer_idx, start, qlen,
                                              positions)
    h = L.apply_norm(lp.ln2, x, cfg.norm)
    return x + lp.ffn(cfg, h)


def _block_decode(cfg: ModelConfig, lp: Block, x, kfull, vfull,
                  layer_idx: int, pos, rope: bool = True):
    h = L.apply_norm(lp.ln1, x, cfg.norm)
    x = x + L.attention_decode_inplace(cfg, lp.attn, h, kfull, vfull,
                                       layer_idx, pos, rope=rope)
    h = L.apply_norm(lp.ln2, x, cfg.norm)
    return x + lp.ffn(cfg, h, decode=True)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _inputs_to_x(cfg: ModelConfig, p: Transformer, batch: dict):
    """The residual stream's input; under rules the rank's block of it."""
    if cfg.family == "audio":
        x = tp.batch_block(batch["frames"].to(torch_dtype(cfg.compute_dtype)))
        return tp.model_block(x) if tp.sp(tp.activation()) else x
    return L.embed_tokens(cfg, p.tok, batch["tokens"])


def _seq(batch: dict) -> tuple[int, int]:
    """(B, S) of a batch of token ids or audio frames."""
    x = batch["frames"] if "frames" in batch else batch["tokens"]
    return x.shape[0], x.shape[1]


def out_rows(x: torch.Tensor, act) -> torch.Tensor:
    """Under rules, the residual's whole sequence (gathered over ``model``
    where it is sequence-parallel); ``x`` itself otherwise."""
    return tp.seq_full(x, tp.sp(act))


def out_batch(logits: torch.Tensor, act) -> torch.Tensor:
    """Under rules, the logits of the whole batch from the rank's rows."""
    return logits if act is None else tp.batch_full(logits, act.B)


def forward(cfg: ModelConfig, p: Transformer, batch: dict) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V): ``lm_head`` for dense
    (and the MoE family's every-layer layout), the ``head`` for audio.  No
    cache is kept; each block is rematerialized in the backward.  Under
    rules the logits of the rank's tokens (``distributed.tp.token_block``:
    its batch rows and, sequence-parallel, its sequence block), whole over
    the vocabulary: what the rank's loss reads."""
    B, S = _seq(batch)
    with tp.entry(B, S) as act:
        x = _inputs_to_x(cfg, p, batch)
        positions = torch.arange(S, device=x.device)
        for lp in p.layers:
            x = L.remat(_block, cfg, lp, x, positions)
        x = L.apply_norm(p.ln_f, x, cfg.norm)
        if cfg.family == "audio":
            return L.head_logits(cfg, p.head, x, seq_block=tp.sp(act))
        return L.lm_head(cfg, p.tok, x, tp.sp(act))


def prefill(cfg: ModelConfig, p: Transformer, batch: dict):
    """Forward over whole prompts (token ids, or audio frames) + KV caches;
    returns (last-position logits (B, 1, V), cache {"k", "v"}: (L, B, S,
    Hkv, hd)).  Under rules the logits are whole and the cache is the
    rank's block of it (``cache_logical_axes``)."""
    B, S = _seq(batch)
    with tp.entry(B, S) as act:
        x = _inputs_to_x(cfg, p, batch)
        positions = torch.arange(S, device=x.device)
        ks, vs = [], []
        for lp in p.layers:
            x, (k, v) = _block_prefill(cfg, lp, x, positions)
            ks.append(k)
            vs.append(v)
        x = L.apply_norm(p.ln_f, out_rows(x, act), cfg.norm)
        logits = out_batch(L.lm_head(cfg, p.tok, x[:, -1:]), act)
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def prefill_chunk(cfg: ModelConfig, p: Transformer, tokens, cache: dict,
                  start, qlen):
    """Consume one fixed-size prompt chunk against (L, B, Smax, Hkv, hd)
    caches, written in place (the returned cache is the same dict of the
    same tensors).  ``tokens``: (B, T) ids, rows past ``qlen[b]`` padding;
    ``start``: (B,) absolute position of each slot's first chunk token;
    ``qlen``: (B,) live tokens.  Returns (logits at each slot's last live
    token ``max(qlen - 1, 0)``, (B, 1, V); cache) — meaningful once the
    chunk holding the prompt's final token has been consumed.  Under
    rules ``tokens``, ``start`` and ``qlen`` are the whole batch's, the
    caches the rank's block (its batch rows, its rows of ``Smax`` on
    ``model``: ``cache_logical_axes``), and the logits whole."""
    B, T = tokens.shape
    with tp.entry(B, T) as act:
        x = L.embed_tokens(cfg, p.tok, tokens)
        start = L.position_vector(start, B, x.device)
        qlen = L.position_vector(qlen, B, x.device)
        start, qlen = tp.batch_block(start), tp.batch_block(qlen)
        b = start.shape[0]
        positions = start[:, None] + torch.arange(T, dtype=torch.int32,
                                                  device=x.device)[None, :]
        for i, lp in enumerate(p.layers):
            x = _block_prefill_chunk(cfg, lp, x, cache["k"], cache["v"], i,
                                     start, qlen, positions)
        x = out_rows(x, act)
        last = (qlen - 1).clamp(min=0).long()
        x = x[torch.arange(b, device=x.device), last][:, None]   # (b, 1, D)
        x = L.apply_norm(p.ln_f, x, cfg.norm)
        return out_batch(L.lm_head(cfg, p.tok, x), act), cache


def decode(cfg: ModelConfig, p: Transformer, token, pos, cache: dict):
    """One decode step against (L, B, Smax, Hkv, hd) caches, updated in
    place (the returned cache is the same dict of the same tensors).
    ``token``: (B, 1) ids; ``pos``: a scalar or a per-slot (B,) vector —
    ragged batches decode each slot at its own position.  Under rules
    ``token`` and ``pos`` are the whole batch's, the caches the rank's
    block, and the logits whole."""
    B = token.shape[0]
    with tp.entry(B, 1) as act:
        x = L.embed_tokens(cfg, p.tok, token)
        pos = L.position_vector(pos, B, x.device)
        pos = tp.batch_block(pos)
        for i, lp in enumerate(p.layers):
            x = _block_decode(cfg, lp, x, cache["k"], cache["v"], i, pos)
        x = L.apply_norm(p.ln_f, out_rows(x, act), cfg.norm)
        return out_batch(L.lm_head(cfg, p.tok, x), act), cache


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """{leaf name: (shape, dtype)} of the decode cache."""
    shp = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dt = torch_dtype(cfg.compute_dtype)
    return {"k": (shp, dt), "v": (shp, dt)}


def cache_logical_axes(cfg: ModelConfig):
    return {"k": (None, "batch", "seq_mp", None, None),
            "v": (None, "batch", "seq_mp", None, None)}


def cache_seq_axes(cfg: ModelConfig):
    """Axis index (in the full cache leaf) that grows with decode position;
    None = fixed-size state.  Used by session extract/insert."""
    return {"k": 2, "v": 2}
