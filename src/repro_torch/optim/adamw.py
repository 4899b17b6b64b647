"""AdamW with global-norm gradient clipping: the port's counterpart of
``repro/optim/adamw.py``, in plain torch on the reference's tree (nested
dicts of tensors), as the reference computes it in jnp outside any kernel.

Functional, as the reference: :func:`adamw_update` returns new trees.
:func:`adamw_update_` is the same update with its arguments donated (the
reference launcher's ``donate_argnums=0``): it writes into the state's
own tensors, bitwise what :func:`adamw_update` returns.  The same rules:
clip by the global norm of all gradients, bias correction, weight decay
only on leaves with ``ndim >= 2`` (the reference's stacked
tree decides: a per-layer norm scale is stacked on the layer axis and
decays, the final norm's does not), ``m`` and ``v`` in float32, and the
learning rate and step on the parameters' device (no host sync).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``lr *
    min_lr_frac`` at ``total_steps``; float32."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, cfg.warmup_steps)
    t = (step - cfg.warmup_steps) / max(1.0,
                                        cfg.total_steps - cfg.warmup_steps)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum()
                          for g in tree_leaves(tree)))


def _coefficients(cfg: AdamWConfig, step, grads, grad_norm):
    """(gradient norm, clip scale, lr, both bias corrections) at the new
    ``step``."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    return (gnorm, scale, cosine_lr(cfg, step),
            1 - torch.pow(cfg.b1, step.float()),
            1 - torch.pow(cfg.b2, step.float()))


def adamw_update(cfg: AdamWConfig, grads, state, params, grad_norm=None):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}).
    ``grad_norm``: the global norm of ``grads`` when they are one rank's
    shards (``train.step`` computes it over the mesh); by default the
    norm of ``grads`` themselves."""
    step = state["step"] + 1
    gnorm, scale, lr, bc1, bc2 = _coefficients(cfg, step, grads, grad_norm)
    b1, b2 = cfg.b1, cfg.b2

    def upd(g, m, v, p):
        g = g.float() * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g.square()
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        if p.dim() >= 2:                      # decay matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    out = tree_map(upd, grads, state["m"], state["v"], params)
    pick = lambda i: tree_map(lambda t: t[i], out)
    return (pick(0), {"m": pick(1), "v": pick(2), "step": step},
            {"grad_norm": gnorm, "lr": lr})


def adamw_update_(cfg: AdamWConfig, grads, state, params,
                  grad_norm=None) -> dict:
    """:func:`adamw_update` written into ``params``, ``state["m"]``,
    ``state["v"]`` and ``state["step"]`` themselves; returns the metrics.
    Each value is the same float32 operation on the same values, in the
    same order, as in :func:`adamw_update` (only the tensor it lands in
    differs, and ``lr * delta``'s operands swap), so every leaf is
    bitwise the functional one."""
    step = state["step"].add_(1)
    gnorm, scale, lr, bc1, bc2 = _coefficients(cfg, step, grads, grad_norm)
    b1, b2 = cfg.b1, cfg.b2

    def upd(g, m, v, p):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        if p.dim() >= 2:                      # decay matrices only
            delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - delta.mul_(lr))

    tree_map(upd, grads, state["m"], state["v"], params)
    return {"grad_norm": gnorm, "lr": lr}
