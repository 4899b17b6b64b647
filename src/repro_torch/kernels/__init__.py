"""Hand-written Hopper kernels of the port, one package per TPU kernel of
:mod:`repro.kernels`: ``ops.py`` (the wrapper: the kernel for a CUDA
tensor, the plain version for a CPU tensor), ``ref.py`` (the plain PyTorch
version) and ``csrc/*.cu`` (the CUDA source, built by :mod:`._build`)."""
