"""Serving on the port: the continuous-batching decode engine."""
from .batcher import Future, RequestTimeout
from .decode import (DecodeEngine, DecodeModel, Session, SessionPool,
                     SessionPoolFull, prompt_buckets)

__all__ = ["DecodeEngine", "DecodeModel", "Future", "RequestTimeout",
           "Session", "SessionPool", "SessionPoolFull", "prompt_buckets"]
