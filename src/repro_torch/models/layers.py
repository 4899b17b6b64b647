"""Shared model layers of the port: norms, RoPE, GQA self- and
cross-attention, dense MLP, embeddings.  Counterpart of
``repro/models/layers.py``.

Parameters are ``nn.Module``s whose tensor names are the keys of the
reference's parameter dicts (``wq``, ``w_gate``, ``scale``, ...), so a
function here reads ``p.wq`` where the reference reads ``p["wq"]``.
Projection weights keep the reference's ``(in, out)`` layout: ``x @ w``.

Weight dtypes: the reference keeps float32 weights and casts them to the
compute dtype on every use (``p["wq"].astype(cdt)``).  The port casts once,
when the module is built, which gives the same values: matrices, biases
and the embedding are stored in the compute dtype; norm scales and biases
stay float32, because the reference casts those to float32, not to the
compute dtype.

Training: parameters are frozen when built; :func:`set_trainable` turns
gradients on for one model.  ``flash_attention`` carries its own gradient
(the backward kernels on the card), so ``attention_apply`` is
differentiable as it stands.

Attention: whole-prompt prefill calls the ``flash_attention`` kernel where
the reference runs its jnp ``blocked_attention`` (or ``_wrapped_causal``);
both exist only to bound XLA's memory, so neither is ported.  Decode calls
the ``ragged_decode`` kernel and chunked prefill the ``ragged_prefill``
kernel, as the reference does.  Cross-attention (the vlm family) takes the
same two kernels: ``flash_attention`` non-causal over the image tokens at
prefill, ``ragged_decode`` over the static cross cache at decode.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..configs.base import ModelConfig, torch_dtype
from ..kernels.flash_attention import flash_attention
from ..kernels.ragged_decode import ragged_decode_attention
from ..kernels.ragged_prefill import ragged_prefill_attention


def _weight(t: torch.Tensor) -> nn.Parameter:
    """A parameter, frozen: serving builds no autograd graph.  The trainer
    turns gradients on for its own model with :func:`set_trainable`."""
    return nn.Parameter(t, requires_grad=False)


def set_trainable(model: nn.Module) -> nn.Module:
    """Turn ``requires_grad`` on for every parameter of ``model`` and
    return it."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def remat(fn, *args):
    """``fn(*args)``; while autograd records, under activation
    checkpointing (the reference's ``jax.checkpoint`` of a block): only
    the block's inputs are kept, and its forward runs again in the
    backward.  ``fn`` must be a module-level function of its arguments
    alone, since it is called again later."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, device) -> torch.Tensor:
    """Uniform(-1/sqrt(in), 1/sqrt(in)) drawn in float32 (the reference's
    ``param_dtype``), stored in ``dtype``."""
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.empty((in_dim, out_dim), dtype=torch.float32, device=device)
    return w.uniform_(-scale, scale, generator=gen).to(dtype)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``), float32."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.scale = _weight(scale.float())
        self.bias = None if bias is None else _weight(bias.float())


def norm_init(d: int, kind: str, device) -> Norm:
    ones = torch.ones(d, device=device)
    return Norm(ones, torch.zeros(d, device=device)
                if kind == "layernorm" else None)


def apply_norm(p: Norm, x: torch.Tensor, kind: str) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + 1e-6) * p.scale + p.bias
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + 1e-6) * p.scale
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def position_vector(pos, batch: int, device) -> torch.Tensor:
    """Normalize a position — scalar (shared) or per-slot vector — to an
    int32 ``(batch,)`` vector on ``device``."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    if pos.shape[0] == batch:
        return pos
    return pos.expand(batch).contiguous()


def rope_frequencies(hd: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    reference's formula: the head splits into halves, f32 throughout."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)               # (hd/2,)
    ang = positions[..., None].float() * freqs                  # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """``wq``/``wk``/``wv``/``wo`` (in, out) in the compute dtype, optional
    ``bq``/``bk``/``bv`` (``qkv_bias``) and ``q_norm``/``k_norm``
    (``qk_norm``, float32)."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        cdt = torch_dtype(cfg.compute_dtype)
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, _weight(tensors[name].to(cdt)))
        for name in ("bq", "bk", "bv"):
            setattr(self, name, _weight(tensors[name].to(cdt))
                    if cfg.qkv_bias else None)
        for name in ("q_norm", "k_norm"):
            setattr(self, name, _weight(tensors[name].float())
                    if cfg.qk_norm else None)


def attention_init(cfg: ModelConfig, gen: torch.Generator,
                   device) -> Attention:
    D, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    cdt = torch_dtype(cfg.compute_dtype)
    t = {"wq": dense_init(gen, D, Hq * hd, cdt, device),
         "wk": dense_init(gen, D, Hkv * hd, cdt, device),
         "wv": dense_init(gen, D, Hkv * hd, cdt, device),
         "wo": dense_init(gen, Hq * hd, D, cdt, device)}
    if cfg.qkv_bias:
        for name, n in (("bq", Hq), ("bk", Hkv), ("bv", Hkv)):
            t[name] = torch.zeros(n * hd, dtype=cdt, device=device)
    if cfg.qk_norm:
        t["q_norm"] = torch.ones(hd, device=device)
        t["k_norm"] = torch.ones(hd, device=device)
    return Attention(cfg, t)


def _q(cfg: ModelConfig, p: Attention, x: torch.Tensor) -> torch.Tensor:
    """The query heads of ``x`` (B, S, D) -> (B, S, Hq, hd), before RoPE."""
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = q.reshape(x.shape[0], -1, cfg.n_heads, cfg.hd)
    return _rms_head(q, p.q_norm) if cfg.qk_norm else q


def _qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor,
         kv_src: torch.Tensor, positions, kv_positions, rope: bool):
    B = x.shape[0]
    hd, Hkv = cfg.hd, cfg.n_kv_heads
    q = _q(cfg, p, x)
    k = kv_src @ p.wk
    v = kv_src @ p.wv
    if cfg.qkv_bias:
        k = k + p.bk
        v = v + p.bv
    k = k.reshape(B, -1, Hkv, hd)
    v = v.reshape(B, -1, Hkv, hd)
    if cfg.qk_norm:
        k = _rms_head(k, p.k_norm)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _rms_head(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale).to(x.dtype)


def decode_attention(cfg: ModelConfig, q: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos) -> torch.Tensor:
    """One-token attention against a ragged batch cache.  q: (B, 1, Hq,
    hd); caches: (B, Smax, Hkv, hd); ``pos`` a scalar or a per-slot (B,)
    vector.  The math lives in :mod:`repro_torch.kernels.ragged_decode`:
    the CUDA kernel on the card, its plain version on the CPU."""
    B, _, Hq, hd = q.shape
    pos_vec = position_vector(pos, B, q.device)
    out = ragged_decode_attention(q.reshape(B, Hq, hd), k_cache, v_cache,
                                  pos_vec)
    return out.reshape(B, 1, Hq * hd).to(q.dtype)


def attention_decode_inplace(cfg: ModelConfig, p: Attention,
                             x: torch.Tensor, kfull: torch.Tensor,
                             vfull: torch.Tensor, layer_idx: int, pos,
                             rope: bool = True) -> torch.Tensor:
    """One-token attention that writes the token's K/V into the STACKED
    (L, B, Smax, Hkv, hd) caches in place and returns the attention output.

    ``pos`` may be a scalar or a per-slot ``(B,)`` vector.  A slot at
    ``pos >= Smax`` writes nothing, as the reference's out-of-bounds
    scatter drops the write: that slot's row index is clamped to the
    cache's last row, and the row takes back its own old value.  The
    clamped row is read: a prompt of exactly ``max_seq`` tokens decodes
    its first token at ``pos == max_seq``, and the query attends to the
    prompt's last row.  No host sync: the path stays capturable."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = x.to(cdt)
    B = x.shape[0]
    pos_vec = position_vector(pos, B, x.device)
    positions = pos_vec[:, None]
    q, k, v = _qkv(cfg, p, x, x, positions, positions, rope)
    batch_ix = torch.arange(B, device=x.device)
    Smax = kfull.shape[2]
    row = pos_vec.clamp(max=Smax - 1).long()
    live = (pos_vec < Smax)[:, None, None]
    kl, vl = kfull[layer_idx], vfull[layer_idx]          # (B, Smax, Hkv, hd)
    # slot indices are distinct: nothing is written twice
    kl[batch_ix, row] = torch.where(live, k[:, 0].to(kl.dtype),
                                    kl[batch_ix, row])
    vl[batch_ix, row] = torch.where(live, v[:, 0].to(vl.dtype),
                                    vl[batch_ix, row])
    out = decode_attention(cfg, q, kl, vl, pos_vec)
    return out @ p.wo


def prefill_chunk_attention(cfg: ModelConfig, q: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            start: torch.Tensor,
                            qlen: torch.Tensor) -> torch.Tensor:
    """Chunk-of-queries attention against a ragged batch cache (the chunked
    prefill analogue of :func:`decode_attention`).  q: (B, T, Hq, hd) —
    chunk token ``i`` of slot ``b`` sits at absolute position ``start[b] +
    i``; caches: (B, Smax, Hkv, hd), already holding the chunk's own K/V
    rows; padded rows (``i >= qlen[b]``) come out zero.  The math lives in
    :mod:`repro_torch.kernels.ragged_prefill`: the CUDA kernel on the card,
    its plain version on the CPU."""
    B, T, Hq, hd = q.shape
    out = ragged_prefill_attention(q, k_cache, v_cache, start, qlen)
    return out.reshape(B, T, Hq * hd).to(q.dtype)


def attention_prefill_chunk_inplace(cfg: ModelConfig, p: Attention,
                                    x: torch.Tensor, kfull: torch.Tensor,
                                    vfull: torch.Tensor, layer_idx: int,
                                    start: torch.Tensor, qlen: torch.Tensor,
                                    positions: torch.Tensor,
                                    rope: bool = True) -> torch.Tensor:
    """Chunk-of-tokens attention that writes the chunk's live K/V rows into
    the STACKED (L, B, Smax, Hkv, hd) caches in place and returns the
    attention output.  ``x``: (B, T, D); ``positions``: (B, T) int32
    absolute positions (``start[:, None] + arange(T)``).

    Padded rows (``i >= qlen[b]``) and rows at or past the cache
    (``start[b] + i >= Smax``) must not reach the cache, where the
    reference drops them with an out-of-bounds scatter.  Only the chunk's
    first ``W = min(T, Smax)`` rows are candidates: a row ``i >= Smax``
    sits at position ``>= Smax`` and is never live.  Row ``i < W`` writes
    row ``(start[b] + i) % Smax``; those rows are distinct within a slot,
    so no index repeats in the assignment; the live ones take the chunk's
    K/V, and every other one takes back its own old value, gathered before
    the write.  That is exact, and needs no host sync.  The attention
    still takes all ``qlen[b]`` queries: one past the cache attends to all
    ``Smax`` rows, as the reference's does."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = x.to(cdt)
    B, T, _ = x.shape
    kl, vl = kfull[layer_idx], vfull[layer_idx]          # (B, Smax, Hkv, hd)
    Smax = kl.shape[1]
    W = min(T, Smax)
    q, k, v = _qkv(cfg, p, x, x, positions, positions, rope)
    pos_w = positions[:, :W]
    rows = pos_w.long() % Smax
    batch_ix = torch.arange(B, device=x.device)[:, None]
    live = ((torch.arange(W, device=x.device)[None, :] < qlen[:, None])
            & (pos_w < Smax))[:, :, None, None]
    kl[batch_ix, rows] = torch.where(live, k[:, :W].to(kl.dtype),
                                     kl[batch_ix, rows])
    vl[batch_ix, rows] = torch.where(live, v[:, :W].to(vl.dtype),
                                     vl[batch_ix, rows])
    out = prefill_chunk_attention(cfg, q, kl, vl, start, qlen)
    return out @ p.wo


def attention_cross_decode(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                           k_cache: torch.Tensor,
                           v_cache: torch.Tensor) -> torch.Tensor:
    """One-token cross-attention against the static cross cache (B, n_img,
    Hkv, hd) the prefill wrote: the reference's ``mode="decode"`` with
    ``kv_src``.  The query takes no RoPE, and every slot reads all
    ``n_img`` rows: the ``ragged_decode`` kernel with each slot at
    position ``n_img - 1``.  Nothing is written; no host sync."""
    x = x.to(torch_dtype(cfg.compute_dtype))
    B = x.shape[0]
    pos = torch.full((B,), k_cache.shape[1] - 1, dtype=torch.int32,
                     device=x.device)
    out = decode_attention(cfg, _q(cfg, p, x), k_cache, v_cache, pos)
    return out @ p.wo


def attention_apply(cfg: ModelConfig, p: Attention, x: torch.Tensor, *,
                    positions: torch.Tensor, rope: bool = True,
                    causal: bool | None = None,
                    kv_src: torch.Tensor | None = None):
    """Full-sequence attention (the reference's ``mode="full"``).  Returns
    (out, k, v); k, v are (B, Skv, Hkv, hd) for the prefill cache.  With
    ``kv_src`` (B, n_img, D) it is cross-attention: K and V come from
    ``kv_src``, neither side takes RoPE, and every query sees every key
    (``flash_attention`` non-causal, ``Skv = n_img``)."""
    cdt = torch_dtype(cfg.compute_dtype)
    x = x.to(cdt)
    cross = kv_src is not None
    causal = (cfg.causal if causal is None else causal) and not cross
    B, S, _ = x.shape
    src = kv_src.to(cdt) if cross else x
    kv_pos = torch.arange(src.shape[1], device=x.device) if cross \
        else positions
    q, k, v = _qkv(cfg, p, x, src, positions, kv_pos, rope and not cross)
    # (B, S, H, hd) -> (B, H, S, hd) views; the kernel reads them by stride
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal)
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
    return out @ p.wo, k, v


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """silu: ``w_gate``, ``w_up``, ``w_down``; gelu: ``w_in``, ``b_in``,
    ``w_out``, ``b_out``.  All in the compute dtype."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        cdt = torch_dtype(cfg.compute_dtype)
        for name, t in tensors.items():
            setattr(self, name, _weight(t.to(cdt)))


def mlp_init(cfg: ModelConfig, gen: torch.Generator, device) -> MLP:
    D, Fd = cfg.d_model, cfg.d_ff
    cdt = torch_dtype(cfg.compute_dtype)
    if cfg.act == "silu":
        t = {"w_gate": dense_init(gen, D, Fd, cdt, device),
             "w_up": dense_init(gen, D, Fd, cdt, device),
             "w_down": dense_init(gen, Fd, D, cdt, device)}
    else:
        t = {"w_in": dense_init(gen, D, Fd, cdt, device),
             "b_in": torch.zeros(Fd, dtype=cdt, device=device),
             "w_out": dense_init(gen, Fd, D, cdt, device),
             "b_out": torch.zeros(D, dtype=cdt, device=device)}
    return MLP(cfg, t)


def mlp_apply(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch_dtype(cfg.compute_dtype))
    if cfg.act == "silu":
        return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p.w_in + p.b_in, approximate="tanh")
    return h @ p.w_out + p.b_out


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """``embed`` (vocab, d_model) and, untied, ``lm_head`` (d_model, vocab),
    in the compute dtype."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 lm_head: torch.Tensor | None = None):
        super().__init__()
        cdt = torch_dtype(cfg.compute_dtype)
        self.embed = _weight(embed.to(cdt))
        self.lm_head = None if cfg.tie_embeddings else _weight(lm_head.to(cdt))


def embedding_init(cfg: ModelConfig, gen: torch.Generator,
                   device) -> Embedding:
    cdt = torch_dtype(cfg.compute_dtype)
    embed = torch.empty((cfg.vocab, cfg.d_model), device=device)
    embed = (embed.normal_(generator=gen) * 0.02).to(cdt)
    lm = None
    if not cfg.tie_embeddings:
        lm = dense_init(gen, cfg.d_model, cfg.vocab, cdt, device)
    return Embedding(cfg, embed, lm)


def embed_tokens(cfg: ModelConfig, p: Embedding,
                 tokens: torch.Tensor) -> torch.Tensor:
    return p.embed[tokens.long()]


def lm_head(cfg: ModelConfig, p: Embedding, x: torch.Tensor) -> torch.Tensor:
    w = p.embed.T if cfg.tie_embeddings else p.lm_head
    return x @ w
