"""Continuous-batching inference serving on top of the port's engine.

    from repro_torch.engine import InferenceSession, SessionConfig
    from repro_torch.serve import InferenceServer, ServerConfig

    sess = InferenceSession(graph, config=SessionConfig(backend="cuda"))
    with InferenceServer(sess, config=ServerConfig(workers=2,
                                                   max_batch=32)) as srv:
        y = srv.predict(frame)
        print(srv.stats()["latency_p99_us"], srv.stats()["qps"])
"""
from .server import (InferenceResult, InferenceServer, LMTokenServer,
                     RequestTimeout, ServeError, ServerClosed, ServerConfig,
                     ServerOverloaded)
from .stats import ServerStats

__all__ = [
    "InferenceResult",
    "InferenceServer",
    "LMTokenServer",
    "RequestTimeout",
    "ServeError",
    "ServerClosed",
    "ServerConfig",
    "ServerOverloaded",
    "ServerStats",
]
