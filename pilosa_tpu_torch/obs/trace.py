"""Per-query tracing: monotonic-clock spans collected into traces,
retained in bounded rings, and carried across threads (contextvars).
The JAX package's obs/trace.py, with its names; the cross-node header
handling waits for the cluster (ROADMAP A11).

Design constraints, in order:

1. Near-free when inactive. Library code calls `span("stage")`
   unconditionally; with no trace active that is one ContextVar read
   returning a shared no-op singleton.
2. Thread-safe without locking the hot path. Span ids come from
   itertools.count (atomic in CPython), span lists grow by list.append
   (atomic under the GIL), and the only lock is the Tracer's ring lock,
   taken once per query at finish().
3. Wall clock for humans, monotonic clock for math: a trace's start is
   stamped with time.time() for the /debug/queries listing; every
   duration and order comes from time.monotonic_ns().

The active span lives in obs/log.CURRENT, so a JSON log line written
inside a query carries its trace and span ids.

`device_scope(name)` marks a kernel launch with a range that
torch.profiler (record_function) and Nsight (an NVTX range, on a card)
both show, under the JAX package's names (`pilosa:count_fused`, ...).
It is gated by $PILOSA_TORCH_DEVICE_SCOPES (1/on/true/yes), read once a
process; off, the default, it returns a shared nullcontext.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import random
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Any, Dict, List, Optional

from .log import CURRENT

DEFAULT_RING = 256
DEFAULT_SLOW_RING = 64
DEFAULT_SLOW_US = 250_000  # 250 ms; [obs] slow-query-threshold
SLOW_ENV = "PILOSA_TORCH_SLOW_QUERY_US"
SCOPES_ENV = "PILOSA_TORCH_DEVICE_SCOPES"

# Trace ids need only avoid collisions within a ring of a few hundred:
# getrandbits is one GIL-atomic call where uuid4 is a syscall a query.
_ID_RAND = random.Random()


def _new_trace_id() -> str:
    return "%016x" % _ID_RAND.getrandbits(64)


class Span:
    """One timed region of a trace. As a context manager it is the
    ambient parent of the `span()` calls nested in it."""

    __slots__ = ("trace", "span_id", "parent_id", "name", "start_ns",
                 "end_ns", "tags", "_token")

    def __init__(self, trace: "Trace", span_id: int,
                 parent_id: Optional[int], name: str,
                 tags: Optional[Dict[str, Any]] = None):
        self.trace = trace
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_ns = time.monotonic_ns()
        self.end_ns: Optional[int] = None
        # Owns `tags`: every caller passes a dict made for this span.
        self.tags: Dict[str, Any] = tags if tags is not None else {}
        self._token = None

    def tag(self, **tags) -> "Span":
        self.tags.update(tags)
        return self

    def finish(self) -> None:
        if self.end_ns is None:
            self.end_ns = time.monotonic_ns()

    @property
    def duration_us(self) -> float:
        end = self.end_ns if self.end_ns is not None else time.monotonic_ns()
        return (end - self.start_ns) / 1e3

    def __enter__(self) -> "Span":
        self._token = CURRENT.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finish()
        if exc_type is not None and "error" not in self.tags:
            self.tags["error"] = exc_type.__name__
        if self._token is not None:
            CURRENT.reset(self._token)
            self._token = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "start_us": round((self.start_ns - self.trace.start_ns) / 1e3,
                              1),
            "duration_us": round(self.duration_us, 1),
            "tags": self.tags,
        }


class _NoopSpan:
    """The shared do-nothing span `span()` returns with no trace
    active."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def tag(self, **tags):
        return self

    def finish(self):
        return None


NOOP_SPAN = _NoopSpan()


class Trace:
    """Every span of one query, rooted at `root`. Spans are made without
    a lock; a finished trace is not changed once a ring holds it."""

    __slots__ = ("trace_id", "name", "tags", "start_ns", "end_ns",
                 "start_wall", "spans", "root", "_ids")

    def __init__(self, trace_id: str, name: str,
                 tags: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id
        self.name = name
        self.tags: Dict[str, Any] = dict(tags) if tags else {}
        self.start_ns = time.monotonic_ns()
        self.end_ns: Optional[int] = None
        self.start_wall = time.time()
        self.spans: List[Span] = []
        self._ids = itertools.count(1)
        self.root = self.span(name, parent_id=None)

    def span(self, name: str, parent_id: Optional[int] = None,
             **tags) -> Span:
        if parent_id is None:
            cur = CURRENT.get()
            if cur is not None and cur.trace is self:
                parent_id = cur.span_id
        sp = Span(self, next(self._ids), parent_id, name, tags)
        self.spans.append(sp)
        return sp

    def finish(self) -> None:
        self.root.finish()
        if self.end_ns is None:
            self.end_ns = time.monotonic_ns()

    @property
    def duration_us(self) -> float:
        end = self.end_ns if self.end_ns is not None else time.monotonic_ns()
        return (end - self.start_ns) / 1e3

    def serialize_spans(self) -> List[Dict[str, Any]]:
        return [sp.to_dict() for sp in self.spans]

    def summary(self) -> Dict[str, Any]:
        return {
            "id": self.trace_id,
            "name": self.name,
            "start": self.start_wall,
            "duration_us": round(self.duration_us, 1),
            "spans": len(self.spans),
            "tags": self.tags,
        }

    def to_dict(self) -> Dict[str, Any]:
        d = self.summary()
        d["spans"] = sorted((sp.to_dict() for sp in self.spans),
                            key=lambda s: (s["start_us"], s["id"]))
        return d


class Tracer:
    """Bounded retention of finished traces: a `recent` ring of the last
    N queries and a `slow` ring of those at or over the slow threshold
    (us). $PILOSA_TORCH_SLOW_QUERY_US overrides the configured threshold
    at construction."""

    def __init__(self, ring: int = DEFAULT_RING,
                 slow_ring: int = DEFAULT_SLOW_RING,
                 slow_us: Optional[float] = None):
        env = os.environ.get(SLOW_ENV, "")
        if env:
            slow_us = float(env)
        self.slow_us = float(slow_us if slow_us is not None
                             else DEFAULT_SLOW_US)
        self._mu = threading.Lock()
        self._recent: "deque[Trace]" = deque(maxlen=max(1, int(ring)))
        self._slow: "deque[Trace]" = deque(maxlen=max(1, int(slow_ring)))

    def start(self, name: str, trace_id: Optional[str] = None,
              **tags) -> Trace:
        return Trace(trace_id or _new_trace_id(), name, tags)

    def finish(self, trace: Trace) -> None:
        trace.finish()
        with self._mu:
            self._recent.append(trace)
            if trace.duration_us >= self.slow_us:
                self._slow.append(trace)

    def get(self, trace_id: str) -> Optional[Trace]:
        with self._mu:
            for ring in (self._recent, self._slow):
                for tr in reversed(ring):
                    if tr.trace_id == trace_id:
                        return tr
        return None

    def snapshot(self) -> Dict[str, Any]:
        """The /debug/queries document (newest first)."""
        with self._mu:
            recent = [tr.summary() for tr in reversed(self._recent)]
            slow = [tr.summary() for tr in reversed(self._slow)]
        return {"slow_threshold_us": self.slow_us, "recent": recent,
                "slow": slow}


def current_span() -> Optional[Span]:
    return CURRENT.get()


def span(name: str, **tags):
    """A child span of the ambient span, or the shared no-op with no
    trace active (one ContextVar read, no allocation)."""
    cur = CURRENT.get()
    if cur is None:
        return NOOP_SPAN
    return cur.trace.span(name, parent_id=cur.span_id, **tags)


def wrap_ctx(fn):
    """`fn` bound to the caller's contextvars context, so a pool worker
    inherits the active span, query profile and cost account. Each call
    runs in its own copy of the context; with none of the three active
    `fn` comes back untouched."""
    if CURRENT.get() is None:
        from .costs import CURRENT_ACCOUNT
        from .profile import CURRENT_PROFILE
        if CURRENT_PROFILE.get() is None and CURRENT_ACCOUNT.get() is None:
            return fn
    ctx = contextvars.copy_context()

    def run(*args, **kwargs):
        return ctx.run(fn, *args, **kwargs)

    return run


_SCOPES: Optional[bool] = None
_NULL = nullcontext()


@contextlib.contextmanager
def _ranges(name: str):
    import torch

    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


def device_scope(name: str):
    """A profiler and NVTX range named `name` around a kernel launch,
    when $PILOSA_TORCH_DEVICE_SCOPES is on (resolved once a process);
    else a shared nullcontext, which imports nothing."""
    global _SCOPES
    on = _SCOPES
    if on is None:
        on = _SCOPES = os.environ.get(SCOPES_ENV, "").strip().lower() in (
            "1", "on", "true", "yes")
    return _ranges(name) if on else _NULL
