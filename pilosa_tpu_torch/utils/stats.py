"""StatsClient interface + in-memory/expvar-style backends (the JAX
package's utils/stats.py; its StatsDStats, which no config key wires,
is not ported)."""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, Iterable, Optional

from ..obs.metrics import Histogram


class StatsClient:
    """Interface: Count/Gauge/Histogram/Set/Timing + tag scoping."""

    def with_tags(self, *tags: str) -> "StatsClient":
        return self

    def count(self, name: str, value: int = 1):
        pass

    def gauge(self, name: str, value: float):
        pass

    def histogram(self, name: str, value: float):
        pass

    def set(self, name: str, value: str):
        pass

    def timing(self, name: str, value_us: int):
        pass


class NopStats(StatsClient):
    pass


class ExpvarStats(StatsClient):
    """In-process counters, exposed at /debug/vars (stats.go:70-131).

    `histogram()`/`timing()` record into log-bucketed Histograms
    (obs.metrics) instead of bare sum/count accumulators, so
    /debug/vars can expose p50/p95/p99 alongside the legacy
    `.sum`/`.count` keys, which are preserved verbatim in snapshot().

    Entries are keyed STRUCTURED — (name, tags tuple) — so
    label-bearing exporters (obs.prom /metrics bridge) see real label
    pairs instead of parsing comma-joined strings back apart.
    snapshot() reconstructs the legacy flat `"t1,t2,name"` key shape,
    so /debug/vars consumers see byte-identical keys.
    """

    def __init__(self, tags: Optional[Iterable[str]] = None, parent=None):
        self._parent = parent
        self.tags = tuple(tags or ())
        if parent is None:
            self._lock = threading.Lock()
            # (name, tags) -> value/str/Histogram.
            self.values: Dict[tuple, float] = defaultdict(float)
            self.sets: Dict[tuple, str] = {}
            self.hists: Dict[tuple, Histogram] = {}
            # name -> "counter" | "gauge": count() and gauge() share
            # the values dict; exporters need to tell an accumulating
            # series from a set-style one. First writer wins.
            self.kinds: Dict[str, str] = {}
        else:
            self._lock = parent._lock
            self.values = parent.values
            self.sets = parent.sets
            self.hists = parent.hists
            self.kinds = parent.kinds

    def _key(self, name: str) -> tuple:
        return (name, self.tags)

    @staticmethod
    def _flat(key: tuple) -> str:
        name, tags = key
        return ",".join(tags + (name,)) if tags else name

    def with_tags(self, *tags: str) -> "ExpvarStats":
        child = ExpvarStats(self.tags + tags, parent=self)
        return child

    def count(self, name: str, value: int = 1):
        with self._lock:
            self.values[self._key(name)] += value
            self.kinds.setdefault(name, "counter")

    def gauge(self, name: str, value: float):
        with self._lock:
            self.values[self._key(name)] = value
            self.kinds.setdefault(name, "gauge")

    def histogram(self, name: str, value: float):
        key = self._key(name)
        with self._lock:
            h = self.hists.get(key)
            if h is None:
                h = self.hists[key] = Histogram()
        h.observe(value)

    def set(self, name: str, value: str):
        with self._lock:
            self.sets[self._key(name)] = value

    def timing(self, name: str, value_us: int):
        self.histogram(name + ".us", value_us)

    def structured(self):
        """(values, sets, hists, kinds) snapshots keyed (name, tags) —
        the label-preserving view the /metrics bridge renders from.
        Histogram objects are shared (observe-safe, snapshot under
        their own lock); the dicts are copies."""
        with self._lock:
            return (dict(self.values), dict(self.sets),
                    dict(self.hists), dict(self.kinds))

    def snapshot(self) -> dict:
        with self._lock:
            out = {self._flat(k): v for k, v in self.values.items()}
            out.update((self._flat(k), v) for k, v in self.sets.items())
            hists = list(self.hists.items())
        for key, h in hists:
            out.update(h.snapshot(self._flat(key)))
        return out


class MultiStats(StatsClient):
    """Fan-out to several backends (stats.go:133-185)."""

    def __init__(self, clients):
        self.clients = list(clients)

    def with_tags(self, *tags: str):
        return MultiStats([c.with_tags(*tags) for c in self.clients])

    def count(self, name, value=1):
        for c in self.clients:
            c.count(name, value)

    def gauge(self, name, value):
        for c in self.clients:
            c.gauge(name, value)

    def histogram(self, name, value):
        for c in self.clients:
            c.histogram(name, value)

    def set(self, name, value):
        for c in self.clients:
            c.set(name, value)

    def timing(self, name, value_us):
        for c in self.clients:
            c.timing(name, value_us)
