"""Query-shape flight recorder: per plan-signature aggregation in a
bounded ring, behind GET /debug/queryshapes (the JAX package's
obs/flight.py, with its names).

The tracer answers "what happened to THIS query", the SLO recorder "is
the service healthy"; this answers the question between them: which
query shapes are hot, slow, expensive, or still routed to the host.
Shapes are keyed by the executor's structural signature
(Executor._shape_sig: call names and frames, ids elided), so two queries
differing only in row ids aggregate into one row.

Recording is on the query path: one small lock hold and a handful of
dict increments. Retention is a recency ring (an LRU of `ring` shapes);
a signature unseen since the ring wrapped is evicted, and the evictions
are counted.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

from .metrics import Histogram

DEFAULT_RING = 256

# Serving backends that mean "the card did not take it", surfaced by
# sort=routed_host.
HOST_ROUTES = frozenset(("host-fold", "roaring", "bsi-host"))

SORTS = ("cost", "p99", "routed_host", "count")


class _Shape:
    __slots__ = ("count", "routes", "tiers", "cache", "hist",
                 "staged_bytes", "shadow_checks", "shadow_mismatches",
                 "first_seen", "last_seen", "example")

    def __init__(self):
        self.count = 0
        self.routes: dict = {}
        self.tiers: dict = {}
        # Result-cache interactions per shape (hit / miss / verify):
        # which shapes actually amortize through the epoch-keyed cache.
        self.cache: dict = {}
        self.hist = Histogram()
        self.staged_bytes = 0
        self.shadow_checks = 0
        self.shadow_mismatches = 0
        self.first_seen = time.time()
        self.last_seen = self.first_seen
        self.example: Optional[str] = None


class FlightRecorder:
    """Bounded per-shape aggregator. Thread-safe; `record` is the hot
    path, everything else is read-time."""

    def __init__(self, ring: int = DEFAULT_RING):
        self._mu = threading.Lock()
        self._shapes: "OrderedDict[str, _Shape]" = OrderedDict()
        self.ring = max(1, int(ring))
        self.evicted = 0

    def record(self, sig: str, route: str, tier: str,
               latency_us: float, staged_bytes: int = 0,
               shadow_checked: bool = False,
               shadow_mismatch: bool = False,
               cache: Optional[str] = None,
               example=None) -> None:
        """One served query of shape `sig`. `example` (the query text,
        or a zero-arg callable producing it — only invoked on the FIRST
        recording of a shape, so hot-path callers never pay for
        serialization) makes the signature human-readable without
        retaining bodies."""
        with self._mu:
            sh = self._shapes.get(sig)
            if sh is None:
                while len(self._shapes) >= self.ring:
                    self._shapes.popitem(last=False)
                    self.evicted += 1
                sh = self._shapes[sig] = _Shape()
                if example is not None:
                    ex = example() if callable(example) else example
                    sh.example = str(ex)[:200]
            else:
                self._shapes.move_to_end(sig)
            sh.count += 1
            sh.routes[route] = sh.routes.get(route, 0) + 1
            sh.tiers[tier] = sh.tiers.get(tier, 0) + 1
            sh.staged_bytes += int(staged_bytes)
            if cache is not None:
                sh.cache[cache] = sh.cache.get(cache, 0) + 1
            if shadow_checked:
                sh.shadow_checks += 1
            if shadow_mismatch:
                sh.shadow_mismatches += 1
            sh.last_seen = time.time()
        sh.hist.observe(latency_us)

    # -- read path -------------------------------------------------------

    def __len__(self) -> int:
        with self._mu:
            return len(self._shapes)

    def stats(self) -> dict:
        with self._mu:
            return {"shapes": len(self._shapes), "ring": self.ring,
                    "evicted": self.evicted}

    def snapshot(self, sort: str = "cost", limit: int = 50) -> dict:
        """The /debug/queryshapes document, sorted by `sort`:
        cost = cumulative recorded latency (count x mean, exact from
        the histogram sum), p99 = per-shape p99 latency, routed_host =
        queries served by a host backend, count = recordings."""
        if sort not in SORTS:
            raise ValueError(
                f"sort must be one of {', '.join(SORTS)}")
        with self._mu:
            items = list(self._shapes.items())
            evicted = self.evicted
        rows = []
        for sig, sh in items:
            counts, total, lat_sum = sh.hist.bucket_snapshot()
            routed_host = sum(n for r, n in sh.routes.items()
                              if r in HOST_ROUTES)
            rows.append({
                "signature": sig,
                "count": sh.count,
                "routes": dict(sorted(sh.routes.items())),
                "tiers": dict(sorted(sh.tiers.items())),
                "cache": dict(sorted(sh.cache.items())),
                "p50_us": round(sh.hist.percentile(0.50), 1),
                "p99_us": round(sh.hist.percentile(0.99), 1),
                "total_us": round(lat_sum, 1),
                "staged_bytes": sh.staged_bytes,
                "routed_host": routed_host,
                "shadow": {"checks": sh.shadow_checks,
                           "mismatches": sh.shadow_mismatches},
                "first_seen": sh.first_seen,
                "last_seen": sh.last_seen,
                "example": sh.example,
            })
        key = {"cost": lambda r: r["total_us"],
               "p99": lambda r: r["p99_us"],
               "routed_host": lambda r: r["routed_host"],
               "count": lambda r: r["count"]}[sort]
        rows.sort(key=key, reverse=True)
        return {"ring": self.ring, "shapes": len(items),
                "evicted": evicted, "sort": sort,
                "top": rows[:max(1, int(limit))]}
