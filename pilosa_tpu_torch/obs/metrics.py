"""Metric containers: a log-bucketed latency histogram and a locked
counter map.

Histogram buckets are powers of two, the classic HdrHistogram-lite
trade: ~64 int slots cover [0, 2^63) with <= 2x relative error before
interpolation, observation is an O(1) bit_length + increment under a
lock held for nanoseconds, and percentiles are derived on snapshot
(the read path), never on the hot write path.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

_NBUCKETS = 64


class Histogram:
    """Log₂-bucketed histogram of non-negative values (microseconds by
    convention).

    Bucket 0 holds values < 1; bucket b (b >= 1) holds values in
    [2^(b-1), 2^b). Percentiles interpolate linearly inside the
    bucket and clamp to the observed min/max, so a histogram fed a
    single repeated value reports that exact value at every quantile.

    An observation may carry an exemplar (a trace id): the histogram
    keeps the latest exemplar per bucket — (trace_id, value, wall ts) —
    so exporters can link a percentile bucket to a concrete trace.
    Exemplar storage is lazy: histograms that never see one pay a
    single `is None` check per observe.
    """

    __slots__ = ("_mu", "counts", "total", "sum", "min", "max",
                 "_exemplars")

    def __init__(self):
        self._mu = threading.Lock()
        self.counts: List[int] = [0] * _NBUCKETS
        self.total = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._exemplars: Optional[
            Dict[int, Tuple[str, float, float]]] = None

    def observe(self, value, exemplar: Optional[str] = None) -> None:
        v = float(value)
        if v < 0:
            v = 0.0
        b = int(v).bit_length()  # 0 -> 0, [2^(b-1), 2^b) -> b
        if b >= _NBUCKETS:
            b = _NBUCKETS - 1
        with self._mu:
            self.counts[b] += 1
            self.total += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[b] = (exemplar, v, time.time())

    def exemplar_snapshot(self) -> Dict[int, Tuple[str, float, float]]:
        """bucket -> (trace_id, value, wall ts) under the lock; empty
        when no observation ever carried an exemplar."""
        with self._mu:
            return dict(self._exemplars) if self._exemplars else {}

    def percentile(self, q: float) -> float:
        """Value at quantile q in [0, 1], linearly interpolated within
        the containing bucket."""
        with self._mu:
            return self._percentile_locked(q)

    def percentiles(self, qs: Iterable[float]) -> List[float]:
        with self._mu:
            return [self._percentile_locked(q) for q in qs]

    def _percentile_locked(self, q: float) -> float:
        if self.total == 0:
            return 0.0
        if q <= 0.0:
            return float(self.min)
        if q >= 1.0:
            return float(self.max)
        # Rank in [0, total): the index of the sample we want if the
        # observations were sorted.
        rank = q * (self.total - 1)
        cum = 0
        for b, n in enumerate(self.counts):
            if n == 0:
                continue
            if rank < cum + n:
                lo = 0.0 if b == 0 else float(1 << (b - 1))
                hi = 1.0 if b == 0 else float(1 << b)
                frac = (rank - cum + 0.5) / n
                v = lo + frac * (hi - lo)
                # Clamp to what we actually saw — keeps single-value
                # and narrow-range histograms exact at the edges.
                if self.min is not None:
                    v = max(v, self.min)
                if self.max is not None:
                    v = min(v, self.max)
                return v
            cum += n
        return self.max if self.max is not None else 0.0

    def bucket_snapshot(self):
        """(counts, total, sum) under the lock — the raw log₂ buckets
        for exporters that need them (Prometheus cumulative `le`
        buckets: bucket b's upper bound is 2^b, see obs.prom)."""
        with self._mu:
            return list(self.counts), self.total, self.sum

    def snapshot(self, prefix: str) -> Dict[str, float]:
        """Expvar-style flat dict. Keeps the legacy `.sum`/`.count`
        keys and adds percentiles + extrema."""
        with self._mu:
            out = {
                prefix + ".sum": self.sum,
                prefix + ".count": float(self.total),
            }
            if self.total:
                out[prefix + ".min"] = float(self.min)
                out[prefix + ".max"] = float(self.max)
                for name, q in (("p50", 0.50), ("p95", 0.95),
                                ("p99", 0.99)):
                    out[f"{prefix}.{name}"] = self._percentile_locked(q)
            return out


class StatMap(dict):
    """A dict of numeric counters whose increments are atomic.

    `d[k] += v` on a plain dict is a read-modify-write race under
    threads; MeshManager's counters are bumped from the serving
    threads, the batch thread, the fetch pool, and the cost-measure
    worker all at once. StatMap keeps the dict interface (reads,
    `dict(m)` serialization for /debug/vars, direct assignment for
    initialization/gauges) and routes increments through `inc()` under
    one small lock. Deliberately a dict subclass so every existing
    read site — `WAL_STATS["x"]`, `dict(stats)`, `.items()` — keeps
    working unchanged.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._mu = threading.Lock()

    def inc(self, name: str, delta=1) -> None:
        with self._mu:
            self[name] = self.get(name, 0) + delta

    def set(self, name: str, value) -> None:
        """Gauge-style assignment under the same lock (so a reader
        iterating under `inc` contention sees consistent sizes)."""
        with self._mu:
            self[name] = value

    def copy(self) -> dict:
        with self._mu:
            return dict(self)


# Bytes moved across locality tiers, keyed by tier: "http" for
# node-to-node request and response bodies (api/client.py), "ici" for
# the SPMD plane's broadcasts (ROADMAP A11d; 0 until then). The handler
# exports it as pilosa_tier_bytes_total{tier}.
TIER_BYTES = StatMap()
