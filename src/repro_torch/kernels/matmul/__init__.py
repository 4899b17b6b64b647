from . import ops
from .ops import matmul
from .ref import matmul_ref

__all__ = ["ops", "matmul", "matmul_ref"]
