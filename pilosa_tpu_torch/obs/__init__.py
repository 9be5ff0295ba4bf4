"""Observability: the log2 Histogram and StatMap (metrics.py), the
Prometheus text exposition behind GET /metrics (prom.py), the [log]
pipeline (log.py), per-query traces (trace.py) and measured profiles
(profile.py), the query-shape flight recorder (flight.py), the SLO
recorder (slo.py), the cost ledger (costs.py) and the liveness plane
(health.py). Stdlib only at import: no torch, no numpy (profile.py
imports them inside the functions that need them).

The cardinal rule is the JAX package's: near-free when nobody is
looking. `span()` with no active trace and `phase()` with no active
profile are one ContextVar read returning a shared no-op.
"""

from . import costs, flight, health, log, profile, prom, slo, trace
from .log import get_logger
from .metrics import Histogram, StatMap
from .trace import (NOOP_SPAN, Span, Trace, Tracer, current_span,
                    device_scope, span, wrap_ctx)

__all__ = ["Histogram", "NOOP_SPAN", "Span", "StatMap", "Trace", "Tracer",
           "costs", "current_span", "device_scope", "flight",
           "get_logger", "health", "log", "profile", "prom", "slo",
           "span", "trace", "wrap_ctx"]
