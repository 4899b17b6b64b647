"""Carry parameters between the JAX package's tree and the port's modules.

:func:`params_from_numpy` takes the reference's parameter tree with every
leaf a numpy array (``jax.tree.map(np.asarray, params)``) or a tensor (what
:func:`repro_torch.checkpoint.load_checkpoint` returns): a nested dict
whose per-layer leaves are stacked on a leading L axis and whose weights
are ``(in, out)``.  The port keeps the ``(in, out)`` layout, so carrying a
layer over is slicing it off the L axis.  :func:`params_to_numpy` is its
inverse: the port's modules as that tree, per-layer tensors stacked back
on the L axis, under the reference's key names and in its ``param_dtype``,
so a checkpoint the port writes loads through the JAX package's
``load_checkpoint(target_tree=init(...))``.  Both import nothing of JAX and
take the dense and the MoE (``moe_every == 1``) families.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig, torch_dtype
from ..device import resolve_device
from . import layers as L
from .moe import MoE, MoEBlock, _check_layout
from .transformer import Block, Transformer

_FAMILIES = ("dense", "moe")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port converts {_FAMILIES} "
            f"(ROADMAP A3)")
    if cfg.family == "moe":
        _check_layout(cfg)


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None
                      ) -> Transformer:
    _check_family(cfg)
    device = resolve_device(device)

    def t(a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=torch.float32)
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    def norm(d: dict) -> L.Norm:
        return L.Norm(t(d["scale"]), t(d["bias"]) if "bias" in d else None)

    tok = tree["tok"]
    lay = tree["layers"]
    layers = []
    for i in range(cfg.n_layers):
        at_i = lambda d: {k: t(v[i]) for k, v in d.items()}
        ln1 = norm({k: v[i] for k, v in lay["ln1"].items()})
        attn = L.Attention(cfg, at_i(lay["attn"]))
        ln2 = norm({k: v[i] for k, v in lay["ln2"].items()})
        if cfg.family == "moe":
            layers.append(MoEBlock(ln1, attn, ln2, MoE(cfg, at_i(lay["moe"]))))
        else:
            layers.append(Block(ln1, attn, ln2, L.MLP(cfg, at_i(lay["mlp"]))))
    embed = L.Embedding(cfg, t(tok["embed"]),
                        t(tok["lm_head"]) if "lm_head" in tok else None)
    return Transformer(embed, layers, norm(tree["ln_f"]))


def params_to_numpy(cfg: ModelConfig, model: Transformer) -> dict:
    """The reference's parameter tree of ``model``, numpy leaves in
    ``cfg.param_dtype``.  Weights the port keeps in a narrower compute
    dtype widen exactly, so ``params_from_numpy`` of the result rebuilds
    the same tensors."""
    _check_family(cfg)
    dt = torch_dtype(cfg.param_dtype)

    def host(x: torch.Tensor) -> np.ndarray:
        return x.detach().to(dt).cpu().numpy()

    def tensors(m, names) -> dict:
        return {n: getattr(m, n) for n in names
                if getattr(m, n, None) is not None}

    def stacked(get) -> dict:
        per = [get(lp) for lp in model.layers]
        return {k: host(torch.stack([d[k] for d in per])) for k in per[0]}

    ffn = ("moe", ("router", "w_gate", "w_up", "w_down")) \
        if cfg.family == "moe" else \
        ("mlp", ("w_gate", "w_up", "w_down", "w_in", "b_in", "w_out",
                 "b_out"))
    norm_names = ("scale", "bias")
    layers = {
        "ln1": stacked(lambda lp: tensors(lp.ln1, norm_names)),
        "attn": stacked(lambda lp: tensors(lp.attn, (
            "wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_norm", "k_norm"))),
        "ln2": stacked(lambda lp: tensors(lp.ln2, norm_names)),
        ffn[0]: stacked(lambda lp: tensors(getattr(lp, ffn[0]), ffn[1])),
    }
    tok = {"embed": host(model.tok.embed)}
    if model.tok.lm_head is not None:
        tok["lm_head"] = host(model.tok.lm_head)
    return {"tok": tok, "layers": layers,
            "ln_f": {k: host(v) for k, v in
                     tensors(model.ln_f, norm_names).items()}}
