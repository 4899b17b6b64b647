from . import ops
from .ops import ragged_decode_attention
from .ref import ragged_decode_ref

__all__ = ["ops", "ragged_decode_attention", "ragged_decode_ref"]
