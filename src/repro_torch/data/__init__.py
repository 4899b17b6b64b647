from .pipeline import DataConfig, SyntheticLMData

__all__ = ["DataConfig", "SyntheticLMData"]
