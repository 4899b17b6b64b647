"""Error-feedback int8 gradient compression: the port's counterpart of
``repro/optim/compression.py``.

:func:`ef_compress_grads` is the numerical transform ``train_step`` applies
when ``compress_dcn`` is on: per-leaf symmetric int8 quantization with an
error-feedback residual carried in the training state (the numerics of an
all-reduce of the compressed payload over the slow cross-pod link).

The reference's ``compressed_allreduce_demo`` runs that collective over a
device mesh; it waits for the port's distributed layer (ROADMAP A, item
10) and is not here yet.
"""

from __future__ import annotations

import torch

from ..tree import tree_map


def ef_init(params) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, float32 scale): ``x / scale`` rounded half to even
    and clipped to +-127, ``scale = max|x| / 127 + 1e-12``."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_grads(grads, residual):
    """int8 quantization with error feedback.  Returns (the compressed then
    decompressed gradients, the new residual)."""
    def one(g, r):
        x = g.float() + r
        deq = dequantize(*quantize(x))
        return deq.to(g.dtype), x - deq

    out = tree_map(one, grads, residual)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)
