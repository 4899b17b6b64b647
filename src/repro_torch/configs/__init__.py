from .base import SHAPES, ModelConfig, shape_skip_reason, torch_dtype
from .registry import ARCH_IDS, get_config

__all__ = ["SHAPES", "ModelConfig", "shape_skip_reason", "torch_dtype",
           "ARCH_IDS", "get_config"]
