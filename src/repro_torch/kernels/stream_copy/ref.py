"""Plain PyTorch versions of the streaming kernels: the math of the
reference's ``repro/kernels/stream_copy/ref.py``.  The ops run them for
CPU tensors; on the card they are what the CUDA kernels are held
against."""

import torch


def stream_copy_ref(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def stream_scale_add_ref(x: torch.Tensor, y: torch.Tensor, a: float,
                         b: float) -> torch.Tensor:
    """``a * x + b * y`` computed in float32, cast to ``x.dtype``."""
    return (a * x.float() + b * y.float()).to(x.dtype)
