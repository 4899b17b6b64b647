"""The plain reference of the dense family (qwen2): a decoder of RMSNorm,
grouped-query attention with RoPE (the head split in halves, as Qwen2's
``rotate_half``) and QKV biases, and a SwiGLU MLP, in float32 with TF32
off, written from the published description.  No kernel, no cache, no
batching across requests: every forward runs the whole sequence.

Weights are the float32 tree ``portbench.lib.model.make_weights`` draws
from the seed; nothing the program made is read.  ``Precision`` says how
the products are computed: ``EXACT`` in float32, ``FP8`` with both
operands of every projection, and every activation where the program
stores one in bfloat16, rounded to float8 e4m3 with one scale a tensor
(the control: the step below the program's bfloat16); ``BF16`` the same in
bfloat16, a witness of the size of the program's own rounding.

Departures from the published models, which the program shares: RMSNorm's
epsilon inside the root is the configuration's ``rms_norm_eps``, and the
attention's scale is ``1 / sqrt(head_dim)``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class Precision:
    """Float32 products and activations (TF32 must be off:
    :func:`float32_only`)."""

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation where the program stores one in its compute
        dtype."""
        return x


class Fp8(Precision):
    """Every product's operands and every stored activation rounded to
    float8 e4m3 (largest 448) with one scale a tensor; products accumulate
    in float32, softmax and norms run in float32.  The gradient passes
    straight through the rounding."""

    @staticmethod
    def round(x: torch.Tensor) -> torch.Tensor:
        scale = x.detach().abs().amax().clamp(min=1e-12) / 448.0
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x).detach()

    def mm(self, a, b):
        return self.round(a) @ self.round(b)

    act = round


class _Bf16Round(torch.autograd.Function):
    """Round to bfloat16 (to nearest even) on the way in and the gradient
    on the way back, as a program whose products and their gradients run
    on bfloat16 operands."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


class Bf16(Precision):
    """Every product's operands and every stored activation rounded to
    bfloat16, and so their gradients; products accumulate in float32.  A
    witness of how far bfloat16 rounding alone takes the reference, not a
    control."""

    round = staticmethod(_Bf16Round.apply)

    def mm(self, a, b):
        return self.round(a) @ self.round(b)

    def act(self, x):
        return self.round(x)


EXACT = Precision()
FP8 = Fp8()
BF16 = Bf16()


def float32_only() -> None:
    """Products in true float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) rotated at positions ``pos`` (S,): frequency
    ``theta ** (-2i / hd)`` for pair ``(i, i + hd / 2)``."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=x.device) / hd)
    ang = pos.float()[:, None] * inv[None, :]                # (S, hd/2)
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v) -> torch.Tensor:
    """Causal attention, q (B, S, Hq, hd), k and v (B, S, Hkv, hd); query
    head ``h`` reads key head ``h // (Hq / Hkv)``.  Returns (B, S, Hq *
    hd)."""
    B, S, Hq, hd = q.shape
    rep = Hq // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, Hq * hd)


def attention_block(d, lp: dict, i: int, x, pos, prec: Precision):
    """One layer's attention on the normed residual ``x`` (B, S, D)."""
    a = lp["attn"]
    B, S, _ = x.shape
    q, k, v = (prec.mm(x, a[w][i]) for w in ("wq", "wk", "wv"))
    if d.qkv_bias:
        q, k, v = q + a["bq"][i], k + a["bk"][i], v + a["bv"][i]
    q = prec.act(rope(q.reshape(B, S, d.Hq, d.hd), pos, d.theta))
    k = prec.act(rope(k.reshape(B, S, d.Hkv, d.hd), pos, d.theta))
    v = prec.act(v.reshape(B, S, d.Hkv, d.hd))
    return prec.mm(prec.act(attention(q, k, v)), a["wo"][i])


def mlp(d, lp: dict, i: int, x, prec: Precision, **_):
    m = lp["mlp"]
    h = F.silu(prec.mm(x, m["w_gate"][i])) * prec.mm(x, m["w_up"][i])
    return prec.mm(prec.act(h), m["w_down"][i])


def hidden(d, tree: dict, tokens: torch.Tensor, prec: Precision = EXACT,
           ffn=mlp, **ffn_kw) -> torch.Tensor:
    """The final normed residual (B, S, D) of token ids (B, S) at
    positions 0..S-1.  ``ffn(d, layers, i, x, prec, **ffn_kw)`` is the
    feed-forward of layer ``i``."""
    lp = tree["layers"]
    x = prec.act(tree["tok"]["embed"][tokens])
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(d.L):
        h = prec.act(rms_norm(x, lp["ln1"]["scale"][i], d.eps))
        x = prec.act(x + attention_block(d, lp, i, h, pos, prec))
        h = prec.act(rms_norm(x, lp["ln2"]["scale"][i], d.eps))
        x = prec.act(x + ffn(d, lp, i, h, prec, **ffn_kw))
    return prec.act(rms_norm(x, tree["ln_f"]["scale"], d.eps))


def logits(d, tree: dict, x: torch.Tensor, prec: Precision = EXACT):
    """Logits of hidden rows ``x`` (..., D): the tied embedding's
    transpose, or the separate head."""
    tok = tree["tok"]
    w = tok["embed"].T if d.tied else tok["lm_head"]
    return prec.mm(x, w)


def served_logits(d, tree: dict, prompt: torch.Tensor, served: torch.Tensor,
                  prec: Precision = EXACT, ffn=mlp, **ffn_kw):
    """The logits (m, V) from which each of the ``m`` served tokens was
    chosen: the forward over the prompt and every served token but the
    last, at the positions of the prompt's last token onward."""
    tokens = torch.cat([prompt, served[:-1]])[None]
    x = hidden(d, tree, tokens, prec, ffn, **ffn_kw)[0]
    return logits(d, tree, x[prompt.shape[0] - 1:], prec)
