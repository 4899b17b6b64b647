from . import ops
from .ops import (FlashAttention, flash_attention, flash_attention_backward,
                  flash_attention_forward)
from .ref import attention_ref, attention_ref_backward, attention_ref_lse

__all__ = ["ops", "FlashAttention", "flash_attention",
           "flash_attention_backward", "flash_attention_forward",
           "attention_ref", "attention_ref_backward", "attention_ref_lse"]
