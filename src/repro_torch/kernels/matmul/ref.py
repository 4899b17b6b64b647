"""Plain PyTorch version of the matrix product: the math of the reference's
``repro/kernels/matmul/ref.py`` (a float32 product cast to ``out_dtype``).
The op runs it for CPU tensors; on the card it is what the CUDA kernel is
held against."""

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x: (M, K), y: (K, N); returns (M, N) in ``out_dtype`` (default
    ``x.dtype``), computed in float32."""
    return (x.float() @ y.float()).to(out_dtype or x.dtype)
