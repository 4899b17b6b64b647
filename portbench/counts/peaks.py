"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W): the denominators of every
roofline and MFU share.  A card set below 700 W reads lower against them;
the result line gives its power limit."""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def bound_s(nbytes: float, flops: float, rate: float = BF16_FLOPS) -> float:
    """The least time the work can take: bytes over the memory rate or
    operations over ``rate``, whichever is longer."""
    return max(nbytes / HBM_BYTES, flops / rate)
