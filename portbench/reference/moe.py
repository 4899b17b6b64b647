"""The plain reference of the MoE family (granite-moe): the dense family's
decoder (``reference/dense.py``) with a routed SwiGLU expert layer in place
of every MLP, in float32 with TF32 off.

The router is a softmax over the experts of ``x @ router`` in float32; each
token takes its ``k`` most probable experts, their probabilities
renormalised to sum to 1, and adds the weighted outputs of those experts.

One departure from the published model is the program's and is held here
too: a whole-prompt prefill runs its expert layers at a capacity of
``ceil(tokens x k x factor / experts)`` copies an expert
(``moe_prefill_capacity_factor`` in the configuration file).  Copies are
ranked within their expert in token-major order (token ``t``'s ``j``-th
choice is copy ``t * k + j``), and a copy whose rank reaches the capacity
adds nothing.  Decode steps drop no copy."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import dense


def capacity(d, tokens: int) -> int:
    return max(1, math.ceil(tokens * d.k * d.capacity_factor / d.E))


def ffn(d, lp: dict, i: int, x: torch.Tensor, prec: dense.Precision,
        capped: int = 0) -> torch.Tensor:
    """The expert layer ``i`` on ``x`` (B, S, D).  The first ``capped``
    tokens of each row (a whole prompt's) share one capacity, ranked in
    their order; later tokens (decode steps) are never dropped."""
    m = lp["moe"]
    B, S, D = x.shape
    h = x.reshape(B * S, D)
    probs = torch.softmax(h @ m["router"][i], dim=-1)
    vals, idx = torch.topk(probs, d.k, dim=-1, sorted=True)
    w = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    keep = torch.ones_like(idx, dtype=torch.bool)
    if capped:
        cap = capacity(d, capped)
        for b in range(B):
            rows = slice(b * S, b * S + capped)
            flat = idx[rows].reshape(-1)
            onehot = F.one_hot(flat, d.E)
            rank = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
            keep[rows] = (rank < cap).reshape(-1, d.k)
    y = torch.zeros_like(h)
    for e in range(d.E):
        tok, j = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = h[tok]
        he = prec.act(F.silu(prec.mm(xe, m["w_gate"][i, e]))
                      * prec.mm(xe, m["w_up"][i, e]))
        y.index_add_(0, tok, prec.mm(he, m["w_down"][i, e])
                     * w[tok, j][:, None])
    return y.reshape(B, S, D)


def served_logits(d, tree: dict, prompt: torch.Tensor, served: torch.Tensor,
                  prec: dense.Precision = dense.EXACT):
    """The logits of every served token, the prompt prefilled whole (at
    its capacity) and each served token decoded without drops."""
    return dense.served_logits(d, tree, prompt, served, prec, ffn,
                               capped=prompt.shape[0])
