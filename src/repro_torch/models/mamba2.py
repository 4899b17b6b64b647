"""Mamba2 (SSD, arXiv:2405.21060): the port's counterpart of
``repro/models/mamba2.py``, the SSM family (``mamba2-130m``) and the
mamba layers of the hybrid family (``models/jamba.py``).

Layer structure (n_groups = 1)::

  in_proj -> [z (d_inner), xBC (d_inner + 2 d_state), dt (n_heads)]
  causal depthwise conv(d_conv) over xBC -> x, B, C
  SSD recurrence over (dt, A, B, C) with skip D
  y = RMSNorm(y * silu(z)) -> out_proj

Prefill runs the chunked SSD scan (:func:`_ssd_chunked`): within a chunk
of ``cfg.ssm_chunk`` tokens the quadratic (attention-dual) form, across
chunks the ``(heads, head_dim, d_state)`` state carried by a Python loop
where the reference scans.  Decode is the one-token recurrence
(:func:`ssm_layer_step`).  No Pallas kernel computes any of this in the
reference (it is jnp), so here it is plain PyTorch.

The casts are the reference's: the scan and the recurrence work in
float32 (``x``, ``dt``, ``B``, ``C``, the state, ``y + x * D``), the gated
norm in float32 with eps 1e-6 cast back to ``z``'s dtype, and the
projections and the conv in the compute dtype.  Weights are stored as the
reference uses them: ``in_proj``, ``conv_w``, ``conv_b`` and ``out_proj``
in the compute dtype, ``dt_bias``, ``A_log``, ``D`` and ``norm`` in
float32.

The decode cache has no sequence axis: ``ssm`` ``(L, B, nh, hp, ds)`` in
float32 and ``conv`` ``(L, B, K-1, conv_dim)``, the last ``K-1`` inputs of
the conv, in the compute dtype.  ``decode`` writes each layer's new state
into them with ``copy_``, so their ``data_ptr`` never changes, and reads
nothing on the host.  There is no ``prefill_chunk``, as in the reference:
the engine prefills a prompt whole.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig, torch_dtype
from ..device import resolve_device
from ..distributed import tp
from . import layers as L
from .transformer import Transformer, out_batch, out_rows


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

# the reference's logical axes of each tensor
SSM_AXES = {"in_proj": ("fsdp", "ff"), "conv_w": (None, "ff"),
            "conv_b": ("ff",), "dt_bias": (None,), "A_log": (None,),
            "D": (None,), "norm": ("ff",), "out_proj": ("ff", "fsdp")}


class SSM(nn.Module):
    """One SSD layer's weights under the reference's names: ``in_proj``
    (D, 2 di + 2 ds + nh), ``conv_w`` (K, conv_dim), ``conv_b``,
    ``dt_bias``, ``A_log``, ``D``, ``norm`` (di,), ``out_proj`` (di, D)."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        cdt = torch_dtype(cfg.compute_dtype)
        for name in ("in_proj", "conv_w", "conv_b", "out_proj"):
            setattr(self, name, L._weight(tensors[name].to(cdt)))
        for name in ("dt_bias", "A_log", "D", "norm"):
            setattr(self, name, L._weight(tensors[name].float()))


def ssm_layer_init(cfg: ModelConfig, gen: torch.Generator, device) -> SSM:
    """The reference's distributions, drawn in float32: ``in_proj`` uniform
    +-1/sqrt(D), ``conv_w`` uniform +-0.5, ``out_proj`` uniform
    +-1/sqrt(di); ``A_log`` = log(linspace(1, 16, nh)); zero ``conv_b`` and
    ``dt_bias``; unit ``D`` and ``norm``."""
    D, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * ds

    def uniform(shape, bound):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.uniform_(-bound, bound, generator=gen)

    return SSM(cfg, {
        "in_proj": uniform((D, 2 * di + 2 * ds + nh), 1.0 / math.sqrt(D)),
        "conv_w": uniform((cfg.ssm_conv, conv_dim), 0.5),
        "conv_b": torch.zeros(conv_dim, device=device),
        "dt_bias": torch.zeros(nh, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)),
        "D": torch.ones(nh, device=device),
        "norm": torch.ones(di, device=device),
        "out_proj": uniform((di, D), 1.0 / math.sqrt(di))})


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, p: SSM, x: torch.Tensor):
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = x.to(torch_dtype(cfg.compute_dtype)) @ p.in_proj
    return (zxbcdt[..., :di], zxbcdt[..., di:di + di + 2 * ds],
            zxbcdt[..., -nh:])


def _conv_full(cfg: ModelConfig, p: SSM, xBC: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, conv_dim), then silu."""
    K, S = cfg.ssm_conv, xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S] * p.conv_w[i] for i in range(K))
    return F.silu(out + p.conv_b)


def _ssd_chunked(cfg: ModelConfig, xh, dt, A, Bmat, Cmat):
    """Chunked SSD scan from a zero state.

    xh: (B, S, nh, hp); dt: (B, S, nh); A: (nh,) negative; Bmat/Cmat:
    (B, S, ds).  Returns (y (B, S, nh, hp), final state (B, nh, hp, ds)),
    float32.  A prompt that is not a multiple of the chunk is padded with
    ``dt = 0``, an identity step (decay 1, no input), and ``y`` is cut back
    to ``S``.  Above the diagonal ``exp(cum_q - cum_k)`` has a positive
    exponent and may overflow, so the exponent is masked to ``-inf``
    before the ``exp``: the same forward as the reference's ``jnp.where``
    after it, and a finite gradient, where masking after the ``exp``
    gives the backward ``inf * 0 = nan`` (as the reference's does)."""
    Bsz, S, nh, hp = xh.shape
    ds = Bmat.shape[-1]
    cl = min(cfg.ssm_chunk, S)
    nc = -(-S // cl)
    pad = nc * cl - S
    f32 = torch.float32
    xh, dt, Bmat, Cmat = xh.float(), dt.float(), Bmat.float(), Cmat.float()
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    xc = xh.reshape(Bsz, nc, cl, nh, hp)
    dtc = dt.reshape(Bsz, nc, cl, nh)
    Bm = Bmat.reshape(Bsz, nc, cl, ds)
    Cm = Cmat.reshape(Bsz, nc, cl, ds)
    cum = torch.cumsum(dtc * A, dim=2)              # within-chunk, <= 0
    h = torch.zeros((Bsz, nh, hp, ds), dtype=f32, device=xh.device)
    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                device=xh.device))[None, :, :, None]
    ys = []
    for c in range(nc):
        xck, dtck, cumk = xc[:, c], dtc[:, c], cum[:, c]
        Bk, Ck = Bm[:, c], Cm[:, c]
        # intra-chunk quadratic form
        Lmat = torch.exp(torch.where(tri, cumk[:, :, None, :]
                                     - cumk[:, None, :, :], -torch.inf))
        scores = torch.einsum("bqs,bks->bqk", Ck, Bk)       # (B, cl, cl)
        att = scores[..., None] * Lmat                      # (B, q, k, nh)
        xdt = xck * dtck[..., None]                         # (B, cl, nh, hp)
        y_intra = torch.einsum("bqkh,bkhp->bqhp", att, xdt)
        # inter-chunk contribution from the carried state
        y_inter = (torch.einsum("bqs,bhps->bqhp", Ck, h)
                   * torch.exp(cumk)[..., None])
        ys.append(y_intra + y_inter)
        # h' = exp(sum da) h + sum_j exp(cum_end - cum_j) B_j xdt_j
        total = cumk[:, -1]                                 # (B, nh)
        w = torch.exp(total[:, None, :] - cumk)             # (B, cl, nh)
        dstate = torch.einsum("bks,bkhp->bhps", Bk, xdt * w[..., None])
        h = torch.exp(total)[:, :, None, None] * h + dstate
    y = torch.stack(ys, dim=1).reshape(Bsz, nc * cl, nh, hp)[:, :S]
    return y, h


def _gated_norm(p: SSM, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = y.float() * F.silu(z.float())
    ms = y.square().mean(-1, keepdim=True)
    return (y * torch.rsqrt(ms + 1e-6) * p.norm).to(z.dtype)


def ssm_layer_full(cfg: ModelConfig, p: SSM, x: torch.Tensor):
    """Full-sequence SSD layer from a zero state.  Returns (out,
    (ssm_state, conv_state)): the conv state is the last ``K-1`` rows of
    the pre-conv ``xBC``, fewer for a shorter prompt.  (The reference
    returns it when asked, recomputing the in_proj for it in ``_raw_xbc``;
    here it is the slice of the product already taken.)"""
    di, ds, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, raw, dt_raw = _split_proj(cfg, p, x)
    xBC = _conv_full(cfg, p, raw)
    xs = xBC[..., :di].reshape(*x.shape[:2], nh, hp)
    Bmat = xBC[..., di:di + ds]
    Cmat = xBC[..., di + ds:]
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, hT = _ssd_chunked(cfg, xs, dt, A, Bmat, Cmat)
    y = y + xs.float() * p.D[None, None, :, None]
    y = _gated_norm(p, y.reshape(*x.shape[:2], di), z)
    out = y.to(x.dtype) @ p.out_proj.to(x.dtype)
    return out, (hT, raw[:, -(cfg.ssm_conv - 1):, :])


def ssm_layer_step(cfg: ModelConfig, p: SSM, x: torch.Tensor,
                   ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One-token recurrence.  x: (B, 1, D); ssm_state: (B, nh, hp, ds);
    conv_state: (B, K-1, conv_dim).  Returns (out, (state, conv)), both
    new tensors."""
    di, ds, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, xBC_raw, dt_raw = _split_proj(cfg, p, x)
    window = torch.cat([conv_state, xBC_raw], dim=1)        # (B, K, C)
    xBC = F.silu(torch.einsum("bkc,kc->bc", window, p.conv_w)
                 + p.conv_b)[:, None, :]
    new_conv = window[:, 1:, :]
    xs = xBC[..., :di].reshape(-1, nh, hp)
    Bmat = xBC[:, 0, di:di + ds].float()
    Cmat = xBC[:, 0, di + ds:].float()
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)       # (B, nh)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)                               # (B, nh)
    xdt = xs.float() * dt[..., None]                        # (B, nh, hp)
    h = (decay[..., None, None] * ssm_state
         + torch.einsum("bs,bhp->bhps", Bmat, xdt))
    y = torch.einsum("bs,bhps->bhp", Cmat, h)
    y = y + xs.float() * p.D[None, :, None]
    y = _gated_norm(p, y.reshape(-1, 1, di), z)
    out = y.to(x.dtype) @ p.out_proj.to(x.dtype)
    return out, (h, new_conv)


def _ssm_shapes(cfg: ModelConfig) -> dict:
    D, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * ds
    return {"in_proj": (D, 2 * di + 2 * ds + nh),
            "conv_w": (cfg.ssm_conv, conv_dim), "conv_b": (conv_dim,),
            "dt_bias": (nh,), "A_log": (nh,), "D": (nh,), "norm": (di,),
            "out_proj": (di, D)}


def _conv_sharded(cfg: ModelConfig) -> bool:
    """Whether the conv state's channels are on ``model`` (``"ff"``)."""
    return tp.model_sharded(("ff",), (cfg.d_inner + 2 * cfg.ssm_state,), 0)


def ssm_full(cfg: ModelConfig, p: SSM, h: torch.Tensor):
    """:func:`ssm_layer_full` on a residual; under rules computed whole on
    every rank of ``model`` (the SSD over ``heads`` is not sharded yet):
    the weights gathered, the sequence gathered where it is sequence-
    parallel, the output cut back to the rank's block and the conv state
    to its channels."""
    sp = tp.sp(tp.activation())
    tp.replicated("ssm")
    out, (hT, conv) = ssm_layer_full(
        cfg, tp.full_module(p, SSM_AXES, _ssm_shapes(cfg)),
        tp.seq_full(h, sp))
    if sp:
        out = tp.model_block(out)
    if _conv_sharded(cfg):
        conv = tp.model_block(conv, -1)
    return out, (hT, conv)


def ssm_step(cfg: ModelConfig, p: SSM, h: torch.Tensor,
             ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """:func:`ssm_layer_step`; under rules whole on every rank of
    ``model``, the conv state's channels gathered and cut back."""
    sp = tp.sp(tp.activation())
    tp.replicated("ssm")
    shard = _conv_sharded(cfg)
    if shard:
        conv_state = tp.gather(conv_state, -1, "model")
    out, (hn, conv) = ssm_layer_step(
        cfg, tp.full_module(p, SSM_AXES, _ssm_shapes(cfg)),
        tp.seq_full(h, sp), ssm_state, conv_state)
    if sp:
        out = tp.model_block(out)
    return out, (hn, tp.model_block(conv, -1) if shard else conv)


# ---------------------------------------------------------------------------
# model (mamba2-130m: every layer SSM, norm + residual)
# ---------------------------------------------------------------------------

class SSMLayer(nn.Module):
    """One layer: ``ln``, ``ssm``."""

    def __init__(self, ln: L.Norm, ssm: SSM):
        super().__init__()
        self.ln, self.ssm = ln, ssm


def init(cfg: ModelConfig, generator: torch.Generator,
         device=None) -> Transformer:
    """Random weights from the reference's distributions, drawn on
    ``device`` (the card unless the caller passes one) from ``generator``.
    Parity tests carry the reference's weights over with
    :func:`repro_torch.models.convert.params_from_numpy`."""
    device = resolve_device(device)
    tok = L.embedding_init(cfg, generator, device)
    layers = [SSMLayer(L.norm_init(cfg.d_model, cfg.norm, device),
                       ssm_layer_init(cfg, generator, device))
              for _ in range(cfg.n_layers)]
    return Transformer(tok, layers, L.norm_init(cfg.d_model, cfg.norm,
                                                device))


def _layer(cfg: ModelConfig, lp: SSMLayer, x: torch.Tensor) -> torch.Tensor:
    return x + ssm_full(cfg, lp.ssm, L.apply_norm(lp.ln, x, cfg.norm))[0]


def forward(cfg: ModelConfig, p: Transformer, batch: dict) -> torch.Tensor:
    """Full-sequence logits (B, S, V), the reference's ``forward``: every
    layer from a zero state, rematerialized in the backward (under rules
    the logits of the rank's batch rows)."""
    B, S = batch["tokens"].shape
    with tp.entry(B, S) as act:
        x = L.embed_tokens(cfg, p.tok, batch["tokens"])
        for lp in p.layers:
            x = L.remat(_layer, cfg, lp, x)
        x = L.apply_norm(p.ln_f, x, cfg.norm)
        return L.lm_head(cfg, p.tok, x, tp.sp(act))


def prefill(cfg: ModelConfig, p: Transformer, batch: dict):
    """Whole prompts; returns (last-token logits (B, 1, V), cache {"ssm":
    (L, B, nh, hp, ds), "conv": (L, B, min(S, K-1), conv_dim)}); under
    rules the cache is the rank's block."""
    B, S = batch["tokens"].shape
    with tp.entry(B, S) as act:
        x = L.embed_tokens(cfg, p.tok, batch["tokens"])
        hs, convs = [], []
        for lp in p.layers:
            out, (hT, conv) = ssm_full(cfg, lp.ssm,
                                       L.apply_norm(lp.ln, x, cfg.norm))
            x = x + out
            hs.append(hT)
            convs.append(conv)
        x = L.apply_norm(p.ln_f, out_rows(x, act), cfg.norm)
        return (out_batch(L.lm_head(cfg, p.tok, x[:, -1:]), act),
                {"ssm": torch.stack(hs), "conv": torch.stack(convs)})


def decode(cfg: ModelConfig, p: Transformer, token, pos, cache: dict):
    """One recurrence step, the cache written in place (the returned cache
    is the same dict of the same tensors).  ``pos`` is unused: the state
    does not grow with position; it is part of the uniform signature."""
    with tp.entry(token.shape[0], 1) as act:
        x = L.embed_tokens(cfg, p.tok, token)
        for i, lp in enumerate(p.layers):
            out, (h, conv) = ssm_step(
                cfg, lp.ssm, L.apply_norm(lp.ln, x, cfg.norm),
                cache["ssm"][i], cache["conv"][i])
            cache["ssm"][i].copy_(h)
            cache["conv"][i].copy_(conv)
            x = x + out
        x = L.apply_norm(p.ln_f, out_rows(x, act), cfg.norm)
        return out_batch(L.lm_head(cfg, p.tok, x), act), cache


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """{leaf name: (shape, dtype)}; ``max_seq`` sizes nothing."""
    nh, hp, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {"ssm": ((cfg.n_layers, batch, nh, hp, ds), torch.float32),
            "conv": ((cfg.n_layers, batch, cfg.ssm_conv - 1,
                      cfg.d_inner + 2 * ds),
                     torch_dtype(cfg.compute_dtype))}


def cache_logical_axes(cfg: ModelConfig):
    return {"ssm": (None, "batch", None, None, None),
            "conv": (None, "batch", None, "ff")}


def cache_seq_axes(cfg: ModelConfig):
    """Pure recurrence: the state is O(1) in position, nothing to trim."""
    return {"ssm": None, "conv": None}
