"""repro_torch.serve — async micro-batching engine for online read-mapping.

Length-bucketed admission (`engine`), result caching keyed on (read
digest, index epoch) (`cache`), counters/histograms with text exposition
(`metrics`), and the client session + Poisson load generator
(`session`).
"""
from .cache import ResultCache
from .engine import EngineConfig, ServeEngine, ServeResult
from .metrics import Metrics
from .session import LoadReport, Session, poisson_load

__all__ = [
    "EngineConfig", "ServeEngine", "ServeResult", "ResultCache", "Metrics",
    "LoadReport", "Session", "poisson_load",
]
