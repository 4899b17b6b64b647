from .elastic import HeartbeatMonitor, PodPTT, StragglerRebalancer

__all__ = ["HeartbeatMonitor", "PodPTT", "StragglerRebalancer"]
