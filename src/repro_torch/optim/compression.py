"""Error-feedback int8 gradient compression: the port's counterpart of
``repro/optim/compression.py``.

:func:`ef_compress_grads` is the numerical transform ``train_step`` applies
when ``compress_dcn`` is on: per-leaf symmetric int8 quantization with an
error-feedback residual carried in the training state (the numerics of an
all-reduce of the compressed payload over the slow cross-pod link).

:func:`compressed_allreduce_demo` runs that collective for real over a
``(pod, data)`` ``DeviceMesh``, as a per-rank body over the mesh's
process groups (the reference's ``shard_map``): an fp32 all-reduce inside
the pod, the int8 payload and its scale all-gathered across pods.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed.sharding import mesh_shape
from ..tree import tree_map


def ef_init(params) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def quantize(x: torch.Tensor, absmax=None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, float32 scale): ``x / scale`` rounded half to even
    and clipped to +-127, ``scale = max|x| / 127 + 1e-12``.  ``absmax(x)``
    gives ``max|x|`` over the whole tensor where ``x`` is one rank's block
    of it (by default ``x``'s own)."""
    m = x.abs().max() if absmax is None else absmax(x)
    scale = m / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_grads(grads, residual, absmax=None):
    """int8 quantization with error feedback.  Returns (the compressed then
    decompressed gradients, the new residual).  ``absmax``: for gradients
    that are each rank's blocks of the leaves, a tree of the leaves'
    :func:`quantize` ``absmax`` functions (``train.step`` all-reduces the
    block's max over the mesh axes the leaf is sharded on), so that every
    block is scaled by its whole leaf's max, as the reference's is."""
    def one(g, r, f=None):
        x = g.float() + r
        deq = dequantize(*quantize(x, f))
        return deq.to(g.dtype), x - deq

    out = tree_map(one, grads, residual, *(() if absmax is None
                                           else (absmax,)))
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def ef_compress_grads_(grads, residual, absmax=None):
    """:func:`ef_compress_grads` with the new residual written into
    ``residual``'s own tensors (the reference launcher's donated state):
    returns the compressed then decompressed gradients, bitwise the
    functional ones."""
    def one(g, r, f=None):
        x = g.float() + r
        deq = dequantize(*quantize(x, f))
        torch.sub(x, deq, out=r)
        return deq.to(g.dtype)

    return tree_map(one, grads, residual, *(() if absmax is None
                                           else (absmax,)))


def compressed_allreduce_demo(x: torch.Tensor, mesh) -> torch.Tensor:
    """Hierarchical compressed mean over a ``(pod, data)`` mesh, run by
    every rank of it.

    Every rank holds a distinct full gradient, synthesized as ``x * (1 +
    0.01 r)`` with ``r = pod * ndata + data`` so that the expected mean is
    analytic; the reduction is an fp32 sum over ``data`` (inside the pod),
    an int8 all-gather of the quantized sum and its scale over ``pod``
    (the cross-pod payload), then dequantize and average."""
    shape = mesh_shape(mesh)
    npod, ndata = shape["pod"], shape["data"]
    rank = mesh.get_local_rank("pod") * ndata + mesh.get_local_rank("data")
    # the factor in float32, as the reference computes it
    r = torch.tensor(float(rank), dtype=torch.float32, device=x.device)
    s = x * (1.0 + 0.01 * r)
    dist.all_reduce(s, group=mesh.get_group("data"))   # fp32 intra-pod
    q, scale = quantize(s)
    pod = mesh.get_group("pod")
    qs = [torch.empty_like(q) for _ in range(npod)]
    scales = [torch.empty_like(scale.reshape(1)) for _ in range(npod)]
    dist.all_gather(qs, q, group=pod)                   # int8 cross-pod
    dist.all_gather(scales, scale.reshape(1), group=pod)
    deq = torch.sum(torch.stack(qs).float()
                    * torch.cat(scales).view(-1, *[1] * x.dim()), dim=0)
    return deq / (npod * ndata)
