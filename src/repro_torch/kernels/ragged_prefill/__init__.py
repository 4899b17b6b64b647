from . import ops
from .ops import ragged_prefill_attention
from .ref import ragged_prefill_ref

__all__ = ["ops", "ragged_prefill_attention", "ragged_prefill_ref"]
