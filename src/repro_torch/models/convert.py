"""Carry the JAX package's parameters over to the port.

:func:`params_from_numpy` takes the reference's parameter tree with every
leaf already a numpy array (``jax.tree.map(np.asarray, params)``): a nested
dict whose per-layer leaves are stacked on a leading L axis and whose
weights are ``(in, out)``.  It imports nothing of JAX.  The port keeps the
``(in, out)`` layout, so carrying a layer over is slicing it off the L
axis; every slice and cast happens here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L
from .transformer import Block, Transformer


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None
                      ) -> Transformer:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: only 'dense' is ported (ROADMAP A3)")
    device = resolve_device(device)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    def norm(d: dict) -> L.Norm:
        return L.Norm(t(d["scale"]), t(d["bias"]) if "bias" in d else None)

    tok = tree["tok"]
    lay = tree["layers"]
    layers = []
    for i in range(cfg.n_layers):
        at_i = lambda d: {k: t(v[i]) for k, v in d.items()}
        layers.append(Block(norm({k: v[i] for k, v in lay["ln1"].items()}),
                            L.Attention(cfg, at_i(lay["attn"])),
                            norm({k: v[i] for k, v in lay["ln2"].items()}),
                            L.MLP(cfg, at_i(lay["mlp"]))))
    embed = L.Embedding(cfg, t(tok["embed"]),
                        t(tok["lm_head"]) if "lm_head" in tok else None)
    return Transformer(embed, layers, norm(tree["ln_f"]))
