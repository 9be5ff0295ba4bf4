"""Measured per-query profiling: the EXPLAIN ANALYZE beside trace.py's
spans (the JAX package's obs/profile.py, with its names).

A `QueryProfile` is an accumulator carried by contextvar, like the
tracer's span, through the same seams: parse, plan, staging, the kernel
launch, the readback, the host fold. Where spans record shape (who
called what, when), the profile records cost: per-phase wall time
unioned across threads, bytes moved per direction, and the achieved
bytes/s against the device's peak (the roofline).

Near-free when nobody is looking: `phase("x")` with no active profile
is one ContextVar read returning a shared no-op; the byte counters
return early. Device phases are real only while a profile is active:
the serving layer synchronizes the card around a launch only then
(`current() is not None`), so an unprofiled query gains no sync.

Phase accounting is a union of intervals per phase: only the outermost
enter/exit pair across every thread touching the profile adds wall
time, so nested or concurrent same-name phases never count twice.

The roofline's peak (peak_bytes_per_s) is keyed on the card's own name
(torch.cuda.get_device_name): `NVIDIA H100 80GB HBM3` is 3.35e12 B/s,
the published rate every bound in PERF.md uses. A card not in the
table gets no roofline (null), never another card's figure. The CPU is
judged against its measured host copy rate.
"""

from __future__ import annotations

import contextvars
import threading
import time
from typing import Any, Dict, List, Optional

from .metrics import Histogram

# The canonical phases, in pipeline order: to_dict() emits them in this
# order (then any others), so profiles diff cleanly.
PHASES = ("sched_wait", "parse", "plan", "stage_h2d", "compile",
          "device_exec", "readback_d2h", "host_fold", "wal_commit",
          "fanout_remote")

BYTE_COUNTERS = ("bytes_staged", "bytes_touched_hbm", "bytes_read_back")

# Peak memory bytes/s by torch.cuda.get_device_name().
DEVICE_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM, published HBM3 rate
}

CURRENT_PROFILE: "contextvars.ContextVar[Optional[QueryProfile]]" = \
    contextvars.ContextVar("pilosa_tpu_torch_profile", default=None)

# Injectable clock: tests drive phase accounting with a fake clock
# instead of wall-clock sleeps.
monotonic_ns = time.monotonic_ns


class _NoopPhase:
    """The shared do-nothing timer returned with no active profile."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def start(self):
        return self

    def stop(self):
        return None


NOOP_PHASE = _NoopPhase()


class _Phase:
    """One enter/exit of a named phase (a context manager, or
    start()/stop() for regions with early returns)."""

    __slots__ = ("_prof", "_name")

    def __init__(self, prof: "QueryProfile", name: str):
        self._prof = prof
        self._name = name

    def __enter__(self):
        self._prof._enter(self._name)
        return self

    def __exit__(self, *exc):
        self._prof._exit(self._name)
        return None

    def start(self):
        self._prof._enter(self._name)
        return self

    def stop(self):
        self._prof._exit(self._name)
        return None


class QueryProfile:
    """Measured cost of one query. Thread-safe: every mutation takes the
    profile's lock, which only an active profile ever reaches."""

    __slots__ = ("_mu", "_phase_ns", "_active", "_bytes", "_slices",
                 "remotes", "start_ns", "end_ns", "backend", "tags",
                 "tenant")

    def __init__(self, backend: Optional[str] = None):
        self._mu = threading.Lock()
        # The bounded tenant label of the exported phase histograms (the
        # handler sets it through SLORecorder.tenant_label); "" keeps
        # the series tenant-less.
        self.tenant = ""
        self._phase_ns: Dict[str, int] = {}
        self._active: Dict[str, List[int]] = {}  # phase -> [depth, t0]
        self._bytes: Dict[str, int] = {}
        self._slices: List[Dict[str, Any]] = []
        self.remotes: List[Dict[str, Any]] = []
        self.start_ns = monotonic_ns()
        self.end_ns: Optional[int] = None
        self.backend = backend or default_backend()
        self.tags: Dict[str, Any] = {}

    # -- phase timers ----------------------------------------------------

    def _enter(self, name: str) -> None:
        now = monotonic_ns()
        with self._mu:
            ent = self._active.get(name)
            if ent is None:
                self._active[name] = [1, now]
            else:
                ent[0] += 1

    def _exit(self, name: str) -> None:
        now = monotonic_ns()
        with self._mu:
            ent = self._active.get(name)
            if ent is None:  # an unbalanced exit: ignored
                return
            ent[0] -= 1
            if ent[0] <= 0:
                del self._active[name]
                self._phase_ns[name] = (self._phase_ns.get(name, 0)
                                        + now - ent[1])

    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def add_phase_ns(self, name: str, ns: int) -> None:
        """Credit wall time a caller measured itself to a phase."""
        with self._mu:
            self._phase_ns[name] = self._phase_ns.get(name, 0) + int(ns)

    # -- byte counters and breakdowns ------------------------------------

    def add_bytes(self, counter: str, n: int) -> None:
        with self._mu:
            self._bytes[counter] = self._bytes.get(counter, 0) + int(n)

    def add_slice(self, **kv) -> None:
        """One row of the per-launch breakdown; the first 256 are kept,
        the rest counted."""
        with self._mu:
            if len(self._slices) < 256:
                self._slices.append(kv)
            else:
                self.tags["slices_truncated"] = \
                    self.tags.get("slices_truncated", 0) + 1

    def tag(self, **kv) -> "QueryProfile":
        with self._mu:
            self.tags.update(kv)
        return self

    # -- lifecycle and output --------------------------------------------

    def finish(self) -> None:
        if self.end_ns is None:
            self.end_ns = monotonic_ns()

    @property
    def total_us(self) -> float:
        end = self.end_ns if self.end_ns is not None else monotonic_ns()
        return (end - self.start_ns) / 1e3

    def phase_us(self, name: str) -> float:
        with self._mu:
            return self._phase_ns.get(name, 0) / 1e3

    def roofline(self) -> Dict[str, Any]:
        """Achieved bytes/s against the peak of the engine that touched
        the bytes: the device's over device_exec, else the host's over
        host_fold. `peak_bytes_per_s` and `fraction_of_peak` are None
        for a card without a known peak."""
        with self._mu:
            dev_ns = self._phase_ns.get("device_exec", 0)
            host_ns = self._phase_ns.get("host_fold", 0)
            touched = self._bytes.get("bytes_touched_hbm", 0)
        if dev_ns > 0:
            engine, ns = "device", dev_ns
        else:
            engine, ns = "host", host_ns
        out: Dict[str, Any] = {"engine": engine, "bytes_touched": touched}
        if ns <= 0 or touched <= 0:
            out["achieved_bytes_per_s"] = 0.0
            out["fraction_of_peak"] = 0.0
            return out
        achieved = touched / (ns / 1e9)
        peak = peak_bytes_per_s(self.backend if engine == "device"
                                else "host")
        out["achieved_bytes_per_s"] = round(achieved, 1)
        out["peak_bytes_per_s"] = None if peak is None else round(peak, 1)
        out["fraction_of_peak"] = (None if not peak
                                   else round(achieved / peak, 6))
        return out

    def to_dict(self) -> Dict[str, Any]:
        with self._mu:
            phase_ns = dict(self._phase_ns)
            # Still-open phases count up to now, so a mid-flight dump
            # stays roughly honest.
            now = monotonic_ns()
            for name, (_, t0) in self._active.items():
                phase_ns[name] = phase_ns.get(name, 0) + now - t0
            bts = dict(self._bytes)
            slices = list(self._slices)
            remotes = list(self.remotes)
            tags = dict(self.tags)
        ordered = {name: round(phase_ns[name] / 1e3, 1)
                   for name in PHASES if name in phase_ns}
        for name in sorted(phase_ns):
            if name not in ordered:
                ordered[name] = round(phase_ns[name] / 1e3, 1)
        out: Dict[str, Any] = {
            "backend": self.backend,
            "total_us": round(self.total_us, 1),
            "phases_us": ordered,
            "bytes": bts,
            "roofline": self.roofline(),
        }
        if slices:
            out["slices"] = slices
        if remotes:
            out["remotes"] = remotes
        if tags:
            out["tags"] = tags
        return out


# -- contextvar plumbing -------------------------------------------------


def current() -> Optional[QueryProfile]:
    return CURRENT_PROFILE.get()


def activate(prof: QueryProfile):
    """Make `prof` the ambient profile; returns the reset token."""
    return CURRENT_PROFILE.set(prof)


def deactivate(token) -> None:
    CURRENT_PROFILE.reset(token)


def phase(name: str):
    """A phase timer on the ambient profile, or the shared no-op."""
    prof = CURRENT_PROFILE.get()
    if prof is None:
        return NOOP_PHASE
    return _Phase(prof, name)


def add_bytes(counter: str, n: int) -> None:
    prof = CURRENT_PROFILE.get()
    if prof is not None:
        prof.add_bytes(counter, n)


def add_slice(**kv) -> None:
    prof = CURRENT_PROFILE.get()
    if prof is not None:
        prof.add_slice(**kv)


# -- backend and peak ----------------------------------------------------

_BACKEND: Optional[str] = None


def default_backend() -> str:
    """"cuda" when torch sees a card, else "cpu" (cached; "cpu" when
    torch cannot be imported). The handler passes the executor's own
    device type instead."""
    global _BACKEND
    b = _BACKEND
    if b is None:
        try:
            import torch
            b = "cuda" if torch.cuda.is_available() else "cpu"
        except Exception:  # noqa: BLE001 — config printing without torch
            b = "cpu"
        _BACKEND = b
    return b


_HOST_PEAK: Optional[float] = None
_PEAK_MU = threading.Lock()


def _measure_host_bandwidth() -> float:
    """Best of 3 copies of a 64 MB buffer (larger than the caches): the
    order of magnitude the host roofline needs."""
    import numpy as np

    src = np.ones(64 * 1024 * 1024 // 8, dtype=np.uint64)
    dst = np.empty_like(src)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return (2 * src.nbytes) / best if best > 0 else 1e9


def device_name() -> Optional[str]:
    """The card's name (torch.cuda.get_device_name), None without one."""
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.get_device_name()
    except Exception:  # noqa: BLE001
        pass
    return None


def peak_bytes_per_s(backend: str) -> Optional[float]:
    """Peak memory bytes/s of a backend: "cuda" is the card's entry in
    DEVICE_PEAK_BYTES_PER_S by name (None for a card not there);
    "cpu" / "host" the measured host copy rate (cached); anything else
    None."""
    global _HOST_PEAK
    b = (backend or "").lower()
    if b in ("cpu", "host", ""):
        with _PEAK_MU:
            if _HOST_PEAK is None:
                _HOST_PEAK = _measure_host_bandwidth()
            return _HOST_PEAK
    if b == "cuda":
        return DEVICE_PEAK_BYTES_PER_S.get(device_name() or "")
    return None


# -- process-wide phase histograms (exported at /metrics) ----------------


class ProfileStats:
    """log2 histograms per (phase, backend, tenant) and the latest
    roofline per backend. Every profiled query, explicit or sampled,
    records here."""

    def __init__(self):
        self._mu = threading.Lock()
        self._phase: Dict[tuple, Histogram] = {}
        # backend -> (fraction_of_peak, achieved_bytes_per_s, count)
        self._roofline: Dict[str, tuple] = {}

    def record(self, prof: QueryProfile) -> None:
        d = prof.to_dict()
        backend = d["backend"]
        tenant = getattr(prof, "tenant", "")
        with self._mu:
            for name, us in d["phases_us"].items():
                h = self._phase.get((name, backend, tenant))
                if h is None:
                    h = self._phase[(name, backend, tenant)] = Histogram()
                h.observe(us)
        rf = d["roofline"]
        if rf.get("fraction_of_peak"):
            with self._mu:
                prev = self._roofline.get(backend, (0.0, 0.0, 0))
                self._roofline[backend] = (rf["fraction_of_peak"],
                                           rf["achieved_bytes_per_s"],
                                           prev[2] + 1)

    def snapshot(self):
        with self._mu:
            return dict(self._phase), dict(self._roofline)

    def families(self):
        """The /metrics collector's families."""
        from .prom import MetricFamily
        phases, roofs = self.snapshot()
        fams = []
        if phases:
            fam = MetricFamily(
                "pilosa_query_phase_us", "histogram",
                "Measured per-phase query wall time (microseconds).")
            for (name, backend, tenant), h in sorted(phases.items()):
                labels = {"phase": name, "backend": backend}
                if tenant:
                    labels["tenant"] = tenant
                fam.add_histogram(h, labels)
            fams.append(fam)
        if roofs:
            fam = MetricFamily(
                "pilosa_roofline_fraction", "gauge",
                "Most recent measured fraction of peak memory bandwidth.")
            bw = MetricFamily(
                "pilosa_roofline_bytes_per_second", "gauge",
                "Most recent measured achieved bytes/s.")
            for backend, (frac, bps, _n) in sorted(roofs.items()):
                fam.add(frac, {"backend": backend})
                bw.add(bps, {"backend": backend})
            fams.append(fam)
            fams.append(bw)
        return fams


STATS = ProfileStats()
