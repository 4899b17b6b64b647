"""PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper.

The JAX package stays the reference; this package keeps its subpackage and
module names so each module's counterpart is easy to find, imports neither
``jax`` nor ``repro``, and runs on ``cuda`` unless a caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
