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
from ..distributed import tp
from ..kernels.flash_attention import flash_attention
from ..kernels.ragged_decode import ragged_decode_attention
from ..kernels.ragged_prefill import ragged_prefill_attention

# the reference's logical axes of each tensor (``models.convert.
# param_specs`` builds the tree from them)
NORM_AXES = {"scale": (None,), "bias": (None,)}
ATTN_AXES = {"wq": ("fsdp", "qkv"), "wk": ("fsdp", "qkv"),
             "wv": ("fsdp", "qkv"), "wo": ("qkv", "fsdp"),
             "bq": ("qkv",), "bk": ("qkv",), "bv": ("qkv",),
             "q_norm": (None,), "k_norm": (None,)}
MLP_AXES = {"w_gate": ("fsdp", "ff"), "w_up": ("fsdp", "ff"),
            "w_down": ("ff", "fsdp"), "w_in": ("fsdp", "ff"),
            "b_in": ("ff",), "w_out": ("ff", "fsdp"), "b_out": (None,)}
EMBED_AXES = {"embed": ("vocab", "fsdp"), "lm_head": ("fsdp", "vocab"),
              "head": ("fsdp", "vocab")}


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
    backward, under the activation layout (``distributed.tp.acting``) of
    its first run.  ``fn`` must be a module-level function of its
    arguments alone, since it is called again later.  The generator's
    state is not stashed: no op of a block draws random numbers, so the
    recompute is exact without it, and a captured train step
    (``models/graphs.py``) may not read or set the CUDA generator."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            _acting, tp.activation(), fn, *args, use_reentrant=False,
            preserve_rng_state=False)
    return fn(*args)


def _acting(act, fn, *args):
    with tp.acting(act):
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


def _qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor,
         kv_src: torch.Tensor, positions, kv_positions, rope: bool):
    q = x @ p.wq
    k = kv_src @ p.wk
    v = kv_src @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return _heads(cfg, p, q, k, v, positions, kv_positions, rope)


def _heads(cfg: ModelConfig, p: Attention, q, k, v, positions,
           kv_positions, rope: bool):
    """Projections (B, S, H * hd) -> heads (B, S, H, hd), normed and
    rotated as the configuration says."""
    B, hd = q.shape[0], cfg.hd
    q = q.reshape(B, -1, q.shape[-1] // hd, hd)
    k = k.reshape(B, -1, k.shape[-1] // hd, hd)
    v = v.reshape(B, -1, v.shape[-1] // hd, hd)
    if cfg.qk_norm:
        q = _rms_head(q, p.q_norm)
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
    prompt's last row.  No host sync: the path stays capturable.

    Under rules (``distributed.tp``) ``x`` is the rank's rows and the
    caches its block, sharded along ``Smax`` over ``model`` (the
    reference's ``seq_mp``): q, k and v whole over their heads; the new
    row written only by the rank that owns row ``pos`` of its slot;
    ``ragged_decode`` over the rank's rows at positions made local, with
    its log-sum-exp, and the ranks' results merged by it over ``model``
    (the reference's flash-decode psums); ``wo`` row-parallel."""
    act = tp.activation()
    h = tp.seq_full(x.to(torch_dtype(cfg.compute_dtype)), tp.sp(act))
    B = h.shape[0]
    pos_vec = position_vector(pos, B, h.device)
    positions = pos_vec[:, None]
    bq, bk, bv = ("bq", "bk", "bv") if cfg.qkv_bias else (None,) * 3
    q = _proj_heads(cfg, p, "wq", h, bq)
    k = _proj_heads(cfg, p, "wk", h, bk)
    v = _proj_heads(cfg, p, "wv", h, bv)
    q, k, v = _heads(cfg, p, q, k, v, positions, positions, rope)
    kl, vl = kfull[layer_idx], vfull[layer_idx]          # (B, Sl, Hkv, hd)
    Sl = kl.shape[1]
    if act is None:
        local, live = pos_vec, pos_vec < Sl
    else:                               # the rank's block of rows
        lay = tp.layout()
        local = pos_vec - lay.model_rank * Sl
        live = (pos_vec < Sl * lay.model) & (local >= 0) & (local < Sl)
    row = local.clamp(0, Sl - 1).long()
    live = live[:, None, None]
    batch_ix = torch.arange(B, device=h.device)
    # slot indices are distinct: nothing is written twice
    kl[batch_ix, row] = torch.where(live, k[:, 0].to(kl.dtype),
                                    kl[batch_ix, row])
    vl[batch_ix, row] = torch.where(live, v[:, 0].to(vl.dtype),
                                    vl[batch_ix, row])
    if act is None:
        out = decode_attention(cfg, q, kl, vl, pos_vec)
    else:
        out = _merged(ragged_decode_attention, q.reshape(B, -1, cfg.hd), kl,
                      vl, local).reshape(B, 1, -1).to(h.dtype)
    return _row_out(cfg, p, out, False, tp.sp(act))


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
    reference drops them with an out-of-bounds scatter.  The candidates
    are ``W = min(T, Sl)`` consecutive rows of the cache block (``Sl`` its
    rows: ``Smax`` without rules) from the first the chunk reaches in it,
    taken modulo ``Sl``, so no index repeats in the assignment: block row
    ``r`` takes chunk row ``r + off - start[b]`` (``off`` the block's
    first global row) where that row is live, and its own old value,
    gathered before the write, otherwise.  A block row lies below ``Smax``,
    so a row past the cache finds no place.  That is exact, and needs no
    host sync.  The attention still takes all ``qlen[b]`` queries: one past
    the cache attends to all ``Smax`` rows, as the reference's does.

    Under rules (``distributed.tp``) ``x`` is the rank's rows and the
    caches its block, sharded along ``Smax`` over ``model`` (the
    reference's ``seq_mp``), as in :func:`attention_decode_inplace`: q, k
    and v whole over their heads; each live row written only by the rank
    that owns its position; ``ragged_prefill`` over the rank's rows at
    starts made local (negative where the block begins past a row), with
    its log-sum-exp, and the ranks' results merged by it over ``model``;
    ``wo`` row-parallel."""
    act = tp.activation()
    h = tp.seq_full(x.to(torch_dtype(cfg.compute_dtype)), tp.sp(act))
    B, T, _ = h.shape
    bq, bk, bv = ("bq", "bk", "bv") if cfg.qkv_bias else (None,) * 3
    q = _proj_heads(cfg, p, "wq", h, bq)
    k = _proj_heads(cfg, p, "wk", h, bk)
    v = _proj_heads(cfg, p, "wv", h, bv)
    q, k, v = _heads(cfg, p, q, k, v, positions, positions, rope)
    kl, vl = kfull[layer_idx], vfull[layer_idx]          # (B, Sl, Hkv, hd)
    Sl = kl.shape[1]
    off = 0 if act is None else tp.layout().model_rank * Sl
    local = start - off
    rows = ((local.clamp(0, Sl - 1)[:, None]
             + torch.arange(min(T, Sl), device=h.device)[None, :]) % Sl)
    src = rows - local[:, None]                          # its chunk row
    live = ((src >= 0) & (src < qlen[:, None]))[:, :, None, None]
    batch_ix = torch.arange(B, device=h.device)[:, None]
    src = src.clamp(0, T - 1)
    kl[batch_ix, rows] = torch.where(live, k[batch_ix, src].to(kl.dtype),
                                     kl[batch_ix, rows])
    vl[batch_ix, rows] = torch.where(live, v[batch_ix, src].to(vl.dtype),
                                     vl[batch_ix, rows])
    if act is None:
        out = prefill_chunk_attention(cfg, q, kl, vl, start, qlen)
    else:
        out = _merged(ragged_prefill_attention, q, kl, vl, local,
                      qlen).reshape(B, T, -1).to(h.dtype)
    return _row_out(cfg, p, out, False, tp.sp(act))


def attention_cross_decode(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                           k_cache: torch.Tensor,
                           v_cache: torch.Tensor) -> torch.Tensor:
    """One-token cross-attention against the static cross cache (B, n_img,
    Hkv, hd) the prefill wrote: the reference's ``mode="decode"`` with
    ``kv_src``.  The query takes no RoPE, and every slot reads all
    ``n_img`` rows: the ``ragged_decode`` kernel with each slot at
    position ``n_img - 1``.  Nothing is written; no host sync.  Under
    rules the query is whole over its heads and ``wo`` row-parallel; where
    the cross cache's rows are on ``model`` (``seq_mp``), each rank reads
    every row of its block and the ranks' results are merged by their
    log-sum-exp."""
    act = tp.activation()
    h = tp.seq_full(x.to(torch_dtype(cfg.compute_dtype)), tp.sp(act))
    B = h.shape[0]
    pos = torch.full((B,), k_cache.shape[1] - 1, dtype=torch.int32,
                     device=h.device)
    q = _proj_heads(cfg, p, "wq", h, "bq" if cfg.qkv_bias else None)
    q = q.reshape(B, 1, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = _rms_head(q, p.q_norm)
    shape = (tp.call_shape(B, 1)[0], cfg.n_image_tokens, *k_cache.shape[2:])
    if tp.model_sharded(("batch", "seq_mp", None, None), shape, 1):
        out = _merged(ragged_decode_attention, q.reshape(B, -1, cfg.hd),
                      k_cache, v_cache, pos).reshape(B, 1, -1)
    else:
        out = decode_attention(cfg, q, k_cache, v_cache, pos)
    return _row_out(cfg, p, out.to(h.dtype), False, tp.sp(act))


def attention_apply(cfg: ModelConfig, p: Attention, x: torch.Tensor, *,
                    positions: torch.Tensor, rope: bool = True,
                    causal: bool | None = None,
                    kv_src: torch.Tensor | None = None, cache: bool = True):
    """Full-sequence attention (the reference's ``mode="full"``).  Returns
    (out, k, v); k, v are (B, Skv, Hkv, hd) for the prefill cache.  With
    ``kv_src`` (B, n_img, D) it is cross-attention: K and V come from
    ``kv_src``, neither side takes RoPE, and every query sees every key
    (``flash_attention`` non-causal, ``Skv = n_img``).

    Under rules (``distributed.tp``) ``x`` is the rank's residual (b, s,
    D): the sequence gathered where it is sequence-parallel, q/k/v
    column-parallel, ``flash_attention`` over the rank's heads, ``wo``
    row-parallel with its partial sums reduce-scattered back onto the
    sequence (all-reduced where the residual is replicated); k, v are the
    rank's block of the cache: its batch rows, every kv head, its sequence
    block where the cache's ``seq_mp`` divides, or ``None`` without
    ``cache``."""
    cdt = torch_dtype(cfg.compute_dtype)
    act = tp.activation()
    sp = tp.sp(act)
    h = tp.seq_full(x.to(cdt), sp)
    b, S, _ = h.shape
    B = tp.call_shape(b, S)[0]
    cross = kv_src is not None
    causal = (cfg.causal if causal is None else causal) and not cross
    src = kv_src.to(cdt) if cross else h
    kv_pos = torch.arange(src.shape[1], device=h.device) if cross \
        else positions
    tp.note(("batch", None, "heads", None), (B, S, cfg.n_heads, cfg.hd))
    tp.note(("batch", None, "kv_heads", None),
            (B, src.shape[1], cfg.n_kv_heads, cfg.hd))
    plan = _head_plan(cfg)
    local_kv = plan is not None and plan[1] == "local"
    bq, bk, bv = ("bq", "bk", "bv") if cfg.qkv_bias else (None,) * 3
    if plan is None:
        tp.replicated("attention (heads whole on every rank)")
        q = _proj_heads(cfg, p, "wq", h, bq)
    else:
        q = _col(cfg, p, "wq", h, bq)
    if local_kv:
        k, v = _col(cfg, p, "wk", src, bk), _col(cfg, p, "wv", src, bv)
    else:
        k = _proj_heads(cfg, p, "wk", src, bk)
        v = _proj_heads(cfg, p, "wv", src, bv)
    q, k, v = _heads(cfg, p, q, k, v, positions, kv_pos, rope and not cross)
    kh, vh = k, v                               # every kv head, for a cache
    if plan is not None and not local_kv:
        k, v = k[:, :, plan[1]:plan[1] + 1], v[:, :, plan[1]:plan[1] + 1]
    # (b, S, H, hd) -> (b, H, S, hd) views; the kernel reads them by stride
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal)
    out = out.transpose(1, 2).reshape(b, S, -1)
    y = _row_out(cfg, p, out, plan is not None, sp)
    if act is None:
        return y, kh, vh
    if not cache:
        return y, None, None
    if local_kv:
        kh, vh = tp.gather(k, 2, "model"), tp.gather(v, 2, "model")
    if tp.model_sharded(("batch", "seq_mp", None, None),
                        (B, *kh.shape[1:]), 1):
        kh, vh = tp.model_block(kh), tp.model_block(vh)
    return y, kh, vh


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
    """The MLP.  Under rules on the rank's residual: the sequence gathered,
    the first product column-parallel over ``ff``, the second row-parallel
    with its partial sums reduce-scattered onto the sequence (all-reduced
    where the residual is replicated); whole on every rank where ``ff``
    does not divide ``model``."""
    sp = tp.sp(tp.activation())
    h = tp.seq_full(x.to(torch_dtype(cfg.compute_dtype)), sp)
    tp.note(("batch", None, "ff"),
            (tp.call_shape(*h.shape[:2])[0], h.shape[1], cfg.d_ff))
    if cfg.act == "silu":
        a = F.silu(_col(cfg, p, "w_gate", h)) * _col(cfg, p, "w_up", h)
        down, b_out = "w_down", None
    else:
        # jax.nn.gelu defaults to the tanh approximation
        a = F.gelu(_col(cfg, p, "w_in", h, "b_in"), approximate="tanh")
        down, b_out = "w_out", p.b_out
    shape = _mlp_shapes(cfg)[down]
    w = tp.full_param(getattr(p, down), MLP_AXES[down], shape)
    if tp.model_sharded(MLP_AXES[down], shape, 0):
        y = tp.seq_out(a @ w, sp)
    else:
        tp.replicated("mlp")
        y = a @ w
        y = tp.model_block(y) if sp else y
    return y if b_out is None else y + b_out


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
    """Token ids (B, S) -> (B, S, D).  Under rules the rank's rows of the
    global ids (and its sequence block): a vocab-parallel lookup (ids
    outside the rank's vocab block give 0) whose partial sums are
    reduce-scattered onto the sequence (all-reduced where the residual is
    replicated); a plain lookup where the vocab does not divide
    ``model``."""
    sp = tp.sp(tp.activation())
    tokens = tp.batch_block(tokens).long()
    V, D = cfg.vocab, cfg.d_model
    names = EMBED_AXES["embed"]
    E = tp.full_param(p.embed, names, (V, D))
    tp.note(("batch", "seq_sp", None), (*tp.call_shape(*tokens.shape), D))
    if not tp.model_sharded(names, (V, D), 0):
        tp.replicated("embedding")
        x = E[tokens]
        return tp.model_block(x) if sp else x
    Vl = E.shape[0]
    t = tokens - tp.layout().model_rank * Vl
    ok = ((t >= 0) & (t < Vl))[..., None]
    x = torch.where(ok, E[t.clamp(0, Vl - 1)], 0)
    return tp.seq_out(x, sp)


def lm_head(cfg: ModelConfig, p: Embedding, x: torch.Tensor,
            seq_block: bool = False) -> torch.Tensor:
    """Logits of ``x`` (B, S, D); under rules of the rank's rows, whole
    over the vocabulary (``seq_block``: ``x`` is the rank's block of a
    sequence-parallel residual, not rows every rank of ``model`` holds)."""
    if cfg.tie_embeddings:
        return head_logits(cfg, p.embed, x, tied=True, seq_block=seq_block)
    return head_logits(cfg, p.lm_head, x, seq_block=seq_block)


def head_logits(cfg: ModelConfig, w: torch.Tensor, x: torch.Tensor,
                tied: bool = False, seq_block: bool = False) -> torch.Tensor:
    """``x @ w`` for a (D, vocab) head, or ``x @ w.T`` for the tied (vocab,
    D) embedding; under rules column-parallel over the vocabulary with the
    logits made whole over it: gathered, or for a sequence block, the
    block's rows gathered first and the (sequence, vocabulary) blocks
    exchanged all-to-all, so each rank holds its own rows' logits."""
    V, D = cfg.vocab, cfg.d_model
    if tied:
        names, shape, vdim = EMBED_AXES["embed"], (V, D), 0
    else:
        names, shape, vdim = EMBED_AXES["lm_head"], (D, V), 1
    wf = tp.full_param(w, names, shape)
    wf = wf.T if tied else wf
    tp.note(("batch", "seq_sp", "vocab"), (*tp.call_shape(*x.shape[:2]), V))
    if not tp.model_sharded(names, shape, vdim):
        tp.replicated("head")
        return x @ wf
    if seq_block:
        return tp.all_to_all(tp.seq_full(x, True) @ wf, 1, -1, "model")
    return tp.gather(x @ wf, -1, "model")


# ---------------------------------------------------------------------------
# the pieces the bodies share with their sharded form (``distributed.tp``)
# ---------------------------------------------------------------------------

def _attn_shapes(cfg: ModelConfig) -> dict:
    D, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {"wq": (D, Hq * hd), "wk": (D, Hkv * hd), "wv": (D, Hkv * hd),
            "wo": (Hq * hd, D), "bq": (Hq * hd,), "bk": (Hkv * hd,),
            "bv": (Hkv * hd,), "q_norm": (hd,), "k_norm": (hd,)}


def _mlp_shapes(cfg: ModelConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {"w_gate": (D, Fd), "w_up": (D, Fd), "w_down": (Fd, D),
            "w_in": (D, Fd), "b_in": (Fd,), "w_out": (Fd, D), "b_out": (D,)}


def _col(cfg, p, name: str, x: torch.Tensor, bias: str | None = None):
    """Column-parallel ``x @ w`` (+ the bias's local block): the rank's
    output columns; the FSDP dim gathered first."""
    shapes = _attn_shapes(cfg) if name in ATTN_AXES else _mlp_shapes(cfg)
    axes = ATTN_AXES if name in ATTN_AXES else MLP_AXES
    y = x @ tp.full_param(getattr(p, name), axes[name], shapes[name])
    if bias is not None:
        y = y + getattr(p, bias)
    return y


def _proj_heads(cfg, p, name: str, x: torch.Tensor, bias: str | None):
    """A q/k/v projection, whole over its heads (gathered over ``model``
    when the column product shards it)."""
    shape = _attn_shapes(cfg)[name]
    y = _col(cfg, p, name, x, bias)
    return tp.gather(y, -1, "model") if tp.model_sharded(
        ATTN_AXES[name], shape, 1) else y


def _head_plan(cfg: ModelConfig):
    """How the attention splits over ``model``: ``(n, kv)`` with ``n`` the
    rank's query heads and ``kv`` its kv heads (``"local"``: its own
    column block; an int: that one kv head of the whole set), or ``None``:
    every rank runs every head (no rules, the query heads do not divide,
    or the group's kv heads do not line up with a rank's query heads)."""
    sh = _attn_shapes(cfg)
    if not tp.model_sharded(ATTN_AXES["wq"], sh["wq"], 1):
        return None
    lay = tp.layout()
    M, Hq, Hkv = lay.model, cfg.n_heads, cfg.n_kv_heads
    if Hq % M:
        return None
    n, rep = Hq // M, Hq // Hkv
    if (tp.model_sharded(ATTN_AXES["wk"], sh["wk"], 1) and Hkv % M == 0
            and n % rep == 0):
        return n, "local"
    if rep % n == 0:
        return n, lay.model_rank * n // rep
    return None


def _row_out(cfg, p, out: torch.Tensor, heads_local: bool, sp: bool):
    """``out`` (B, S, Hq * hd), whole or the rank's head block, through
    ``wo`` onto the residual's layout: row-parallel (partial sums
    reduce-scattered or all-reduced), or whole on every rank where ``wo``
    is not sharded over ``model``."""
    sh = _attn_shapes(cfg)["wo"]
    wo = tp.full_param(p.wo, ATTN_AXES["wo"], sh)
    if tp.model_sharded(ATTN_AXES["wo"], sh, 0):
        if not heads_local:
            out = tp.model_block(out, -1)          # the rank's wo rows
        return tp.seq_out(out @ wo, sp)
    y = out @ wo
    return tp.model_block(y) if sp else y


def _merged(kernel, q, kl, vl, local, *args):
    """``kernel`` (``ragged_decode_attention`` on q (B, Hq, hd) or
    ``ragged_prefill_attention`` on q (B, T, Hq, hd)) over the rank's cache
    rows at the positions or starts ``local``, merged over ``model`` by
    each row's log-sum-exp: out = sum_r e^(lse_r - M) out_r / sum_r
    e^(lse_r - M), M the rows' max.  A row that no rank's rows reach (a
    padded row: -inf on every rank) gives 0, not 0 / 0."""
    out, lse = kernel(q, kl, vl, local.to(torch.int32), *args, lse=True)
    m = tp.reduce_max(lse, "model")
    m = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.exp(lse - m)                       # 0 where no row is live
    n = out.shape[-2] * out.shape[-1]
    both = tp.reduce(torch.cat([(out * w[..., None]).flatten(-2), w], -1),
                     "model")
    num, den = both[..., :n], both[..., n:]
    return num.reshape(out.shape) / torch.where(den > 0, den, 1.0)[..., None]
