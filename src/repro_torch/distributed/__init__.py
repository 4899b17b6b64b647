from .elastic import PodPTT

__all__ = ["PodPTT"]
