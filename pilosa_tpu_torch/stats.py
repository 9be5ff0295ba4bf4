"""Process-wide counters and histograms of the storage and integrity
layers (WAL_STATS, GROUP_SIZE, SNAPSHOT_US, SCRUB_STATS, SHADOW_STATS,
INTEGRITY_STATS). `/debug/vars` reads them; the JAX package exports its
twins at /metrics, which the port does not serve yet."""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional


class StatMap(dict):
    """A dict of counters whose increments are atomic under threads.
    Reads are plain dict reads."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._mu = threading.Lock()

    def inc(self, name: str, delta=1) -> None:
        with self._mu:
            self[name] = self.get(name, 0) + delta

    def copy(self) -> dict:
        with self._mu:
            return dict(self)


class Histogram:
    """Count, sum and max of every observation, and exact percentiles
    over the newest `keep` of them."""

    def __init__(self, keep: int = 65536):
        self._mu = threading.Lock()
        self._recent: deque = deque(maxlen=keep)
        self.count = 0
        self.sum = 0.0
        self.max: Optional[float] = None

    def observe(self, value) -> None:
        v = float(value)
        with self._mu:
            self._recent.append(v)
            self.count += 1
            self.sum += v
            self.max = v if self.max is None else max(self.max, v)

    def values(self) -> list:
        """The kept observations, oldest first."""
        with self._mu:
            return list(self._recent)

    def percentile(self, q: float) -> Optional[float]:
        """The q-th percentile (0-100, nearest rank) of the kept
        observations; None before the first."""
        vals = sorted(self.values())
        if not vals:
            return None
        k = min(len(vals) - 1, max(0, int(round(q / 100.0 * len(vals))) - 1))
        return vals[k]

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.sum, "max": self.max,
                "p50": self.percentile(50), "p99": self.percentile(99)}
