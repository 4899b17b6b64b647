"""The plain reference of a training step: the next-token cross-entropy of
a decoder of ``reference/dense.py`` (or ``moe.py``), its gradients by
autograd in float32, and AdamW, written from the published algorithm
(Loshchilov and Hutter, arXiv:1711.05101) with the launcher's settings:
gradients clipped to a global norm, moments ``b1`` / ``b2`` with bias
correction, decoupled weight decay on every stacked leaf of two or more
dimensions (the program's rule: a per-layer norm scale, stacked over the
layers, decays; the final norm's does not), and a learning rate warmed up
linearly, then cosine down to ``min_lr_frac`` of its peak.

The loss is the mean over every token of the batch; the batch is taken in
blocks of rows whose gradients add up, so that the float32 logits of the
whole vocabulary fit."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import dense


def leaves(tree: dict, prefix: str = ""):
    """``(path, tensor)`` of every leaf, in a fixed order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def loss_and_grads(d, tree: dict, tokens: torch.Tensor, family,
                   rows: int = 2, prec=dense.EXACT, **ffn_kw):
    """(mean loss, {path: gradient}) of token ids (B, S + 1): inputs
    ``tokens[:, :-1]``, labels ``tokens[:, 1:]``."""
    params = dict(leaves(tree))
    for t in params.values():
        t.requires_grad_(True)
        t.grad = None
    B, S1 = tokens.shape
    n = B * (S1 - 1)
    total = 0.0
    ffn = getattr(family, "ffn", dense.mlp)
    for lo in range(0, B, rows):
        blk = tokens[lo:lo + rows]
        with torch.enable_grad():
            x = dense.hidden(d, tree, blk[:, :-1], prec, ffn, **ffn_kw)
            lg = dense.logits(d, tree, x, prec)
            loss = F.cross_entropy(lg.reshape(-1, d.V).float(),
                                   blk[:, 1:].reshape(-1), reduction="sum")
            (loss / n).backward()
        total += float(loss.detach())
    grads = {p: t.grad.detach().clone() for p, t in params.items()}
    for t in params.values():
        t.requires_grad_(False)
        t.grad = None
    return total / n, grads


def lr_at(hp: dict, step: int) -> float:
    warm, total = hp["warmup_steps"], hp["total_steps"]
    if step < warm:
        return hp["lr"] * step / max(1, warm)
    t = min(max((step - warm) / max(1, total - warm), 0.0), 1.0)
    f = hp["min_lr_frac"]
    return hp["lr"] * (f + (1 - f) * 0.5 * (1 + math.cos(math.pi * t)))


def global_norm(grads: dict) -> float:
    return math.sqrt(sum(float(g.double().square().sum())
                         for g in grads.values()))


def adamw(hp: dict, tree: dict, grads: dict, state: dict, step: int):
    """One AdamW step at ``step`` (1-based), in place on ``tree`` and
    ``state`` ({"m", "v"} by path).  Returns the clipped gradients as the
    moments took them."""
    params = dict(leaves(tree))
    norm = global_norm(grads)
    scale = min(1.0, hp["clip_norm"] / max(norm, 1e-9))
    lr = lr_at(hp, step)
    b1, b2 = hp["b1"], hp["b2"]
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    clipped = {}
    with torch.no_grad():
        for path, p in params.items():
            g = grads[path] * scale
            clipped[path] = g
            m = state["m"].setdefault(path, torch.zeros_like(p))
            v = state["v"].setdefault(path, torch.zeros_like(p))
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            delta = (m / bc1) / ((v / bc2).sqrt() + hp["eps"])
            if p.dim() >= 2:
                delta = delta + hp["weight_decay"] * p
            p.sub_(lr * delta)
    return clipped
