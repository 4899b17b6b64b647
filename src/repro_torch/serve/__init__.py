from .engine import Request, ServeEngine, Session
from .scheduler import ElasticServeScheduler, RequestClass

__all__ = ["Request", "ServeEngine", "Session", "ElasticServeScheduler",
           "RequestClass"]
