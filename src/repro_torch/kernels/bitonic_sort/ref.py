"""Plain PyTorch version of the row sort: the reference's
``repro/kernels/bitonic_sort/ref.py`` (an ascending sort of each row).
The op runs it for CPU tensors; on the card it is what the CUDA kernel is
held against."""

import torch


def sort_rows_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1).values
