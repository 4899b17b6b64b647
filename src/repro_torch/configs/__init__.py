from .base import (SHAPES, ModelConfig, input_specs, shape_skip_reason,
                   torch_dtype, widen_heads)
from .registry import ARCH_IDS, get_config

__all__ = ["SHAPES", "ModelConfig", "input_specs", "shape_skip_reason",
           "torch_dtype", "widen_heads", "ARCH_IDS", "get_config"]
