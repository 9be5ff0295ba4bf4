"""Observability: the log2 Histogram and StatMap (metrics.py), the
Prometheus text exposition behind GET /metrics (prom.py) and the [log]
pipeline (log.py). Stdlib only: no torch, no numpy."""

from . import log, prom
from .metrics import Histogram, StatMap

__all__ = ["Histogram", "StatMap", "log", "prom"]
