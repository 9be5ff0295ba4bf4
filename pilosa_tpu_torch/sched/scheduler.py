"""Adaptive query scheduler: batching window + admission + fairness
(the JAX package's sched/scheduler.py, with its names and defaults).

Shape of the thing (one class, one optional dispatcher thread):

- **Idle fast path.** A request arriving with nothing queued and
  nothing in flight is admitted under one lock acquisition and returns
  immediately: the scheduler must cost (close to) nothing when there
  is no contention to schedule (the reference guards < 2%).

- **Adaptive batching window.** Once anything is in flight, arrivals
  queue and a dispatcher releases them in *cohorts*: it waits a short
  window — `idle_window_us` per pending request, growing toward the
  `max_window_us` cap under herds, skipped entirely once a full cohort
  is waiting — then wakes the whole cohort at once. The cohort's
  threads hit `MeshManager._batch_q` together (helped by the
  `on_release` burst hint into serve.expect_burst), so queries sharing
  fragments drain into one shared-read device program instead of
  fragmenting across drain cycles.

- **Deadline-aware admission.** Service time is estimated from this
  scheduler's own observed release→done latencies (p95), falling back
  to the executor's route histograms (`estimator`) and finally the
  configured `default_service_us`. A request whose estimated queue
  wait plus service time cannot fit its remaining deadline budget is
  shed at the door: `AdmissionError` with a computed Retry-After (the
  handler maps it to HTTP 429). A bounded queue (`queue_depth`) sheds
  the rest of an overload.

- **Per-tenant weighted fair queues.** Each tenant gets a FIFO; every
  ticket is stamped with a virtual finish time advanced by 1/weight,
  and the dispatcher always releases the globally-smallest stamp — so
  a tenant with weight 2 drains twice as fast as weight 1 under
  backlog, FIFO order holds within a tenant, and an idle tenant's
  first request never waits behind a hot tenant's backlog.

- **Queue wait counts against the deadline.** The waiter sleeps at
  most until its own deadline; on expiry it removes itself and raises
  DeadlineExceededError (HTTP 504) immediately — dead work is never
  dispatched. The dispatcher also drops already-expired tickets when
  building a cohort.

Fault seam `sched.admit` (fault.py) fires at the top of submit():
an armed delay stalls admission like an overloaded scheduler; an armed
error (e.g. an AdmissionError instance) forces sheds deterministically.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from .. import fault
from ..errors import DeadlineExceededError, PilosaError
from ..obs import Histogram, StatMap
from ..obs.health import HEALTH


class AdmissionError(PilosaError):
    """Request shed at admission — the HTTP layer answers 429 with a
    Retry-After of `retry_after_s` (whole seconds, >= 1)."""

    def __init__(self, msg: str, retry_after_s: float, reason: str):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)
        self.reason = reason


class _Ticket:
    """One admitted (or queued) request. `state` moves queued ->
    released | expired exactly once, under the scheduler lock."""

    __slots__ = ("tenant", "deadline", "vt", "enq_t", "release_t",
                 "event", "state")

    def __init__(self, tenant: str, deadline: Optional[float]):
        self.tenant = tenant
        self.deadline = deadline
        self.vt = 0.0
        self.enq_t = 0.0
        self.release_t = 0.0
        self.event = threading.Event()
        self.state = "queued"


# How long a cached service-time estimate stays fresh. Admission runs
# per request; the percentile walk does not need to.
_EST_TTL_S = 0.25

# Observed-service percentile used as the estimate, and how many
# observations it takes before we trust it over the external estimator.
_EST_QUANTILE = 0.95
_EST_MIN_SAMPLES = 8


class QueryScheduler:
    """See module docstring. Thread-safe; one instance per server."""

    def __init__(self, max_window_us: float = 2000.0,
                 idle_window_us: float = 150.0,
                 queue_depth: int = 256,
                 max_cohort: int = 16,
                 default_service_us: float = 1500.0,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 estimator: Optional[Callable[[], Optional[float]]] = None,
                 on_release: Optional[Callable[[int], None]] = None):
        self.max_window_us = float(max_window_us)
        self.idle_window_us = float(idle_window_us)
        self.queue_depth = int(queue_depth)
        self.max_cohort = int(max_cohort)
        self.default_service_us = float(default_service_us)
        self.tenant_weights = {str(k): float(v)
                               for k, v in (tenant_weights or {}).items()}
        self.estimator = estimator
        self.on_release = on_release
        # Admission-time cost estimator: the server wires this to the
        # cost ledger's tenant_share so the handler can stamp an
        # observe-only X-Pilosa-Cost-Debt header for tenants consuming
        # an outsized share of device time. None = unwired (no debt
        # accounting; the handler falls back to the ledger directly).
        self.cost_share_fn: Optional[Callable[[str], float]] = None
        self.stats = StatMap({
            "admitted": 0, "fastpath": 0, "queued": 0,
            "shed_deadline": 0, "shed_queue_full": 0,
            "expired_in_queue": 0, "cohorts": 0, "coalesced": 0})
        self.wait_hist = Histogram()     # µs from enqueue to release
        self.batch_hist = Histogram()    # released cohort sizes
        self.service_hist = Histogram()  # µs from release to done()
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._queues: Dict[str, deque] = {}
        self._tenant_vt: Dict[str, float] = {}
        self._vclock = 0.0
        self._pending = 0
        self._inflight = 0
        self._est_cache = (0.0, self.default_service_us)
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._hb = None  # registered when the dispatcher spawns

    # -- admission -----------------------------------------------------------

    def submit(self, tenant: str = "default",
               deadline: Optional[float] = None) -> _Ticket:
        """Admit one request. Returns a released ticket (pass it to
        done() after the query finishes), or raises AdmissionError
        (shed — HTTP 429) / DeadlineExceededError (expired before or
        while queued — HTTP 504). Blocks at most until `deadline`."""
        fault.point("sched.admit", tenant=tenant)
        now = time.monotonic()
        if deadline is not None and now >= deadline:
            raise DeadlineExceededError("deadline expired before admission")
        with self._mu:
            if self._closed:
                # Draining for shutdown: pass-through, never block.
                return self._admit_now_locked(tenant, deadline, now,
                                              fastpath=False)
            est = self._estimate_us_locked(now)
            if self._pending == 0 and self._inflight == 0:
                # Idle fast path: one lock hold, no dispatcher, no
                # window. Deadline check still applies — an idle node
                # cannot serve a 1 ms budget with a 50 ms query either.
                if deadline is not None and now + est / 1e6 > deadline:
                    self.stats.inc("shed_deadline")
                    raise AdmissionError(
                        f"estimated service {est / 1e3:.1f} ms exceeds "
                        f"deadline budget "
                        f"{(deadline - now) * 1e3:.1f} ms",
                        self._retry_after_s(0, est), "deadline")
                return self._admit_now_locked(tenant, deadline, now)
            depth = self._pending
            if depth >= self.queue_depth:
                self.stats.inc("shed_queue_full")
                raise AdmissionError(
                    f"scheduler queue full ({depth} queued)",
                    self._retry_after_s(depth, est), "queue_full")
            # Load shedding: the queue ahead of us, serialized at the
            # estimated service time, must fit the deadline budget.
            est_wait_us = (depth + self._inflight) * est
            if (deadline is not None
                    and now + (est_wait_us + est) / 1e6 > deadline):
                self.stats.inc("shed_deadline")
                raise AdmissionError(
                    f"estimated wait {est_wait_us / 1e3:.1f} ms + "
                    f"service {est / 1e3:.1f} ms exceeds deadline "
                    f"budget {(deadline - now) * 1e3:.1f} ms",
                    self._retry_after_s(depth, est), "deadline")
            t = _Ticket(tenant, deadline)
            t.enq_t = now
            w = self.tenant_weights.get(tenant, 1.0) or 1.0
            # WFQ virtual-time stamp: never behind the clock of what
            # already dispatched (an idle tenant does not bank credit),
            # advancing by 1/weight per request within a tenant.
            vt = max(self._vclock, self._tenant_vt.get(tenant, 0.0)) \
                + 1.0 / w
            self._tenant_vt[tenant] = vt
            t.vt = vt
            self._queues.setdefault(tenant, deque()).append(t)
            self._pending += 1
            self.stats.inc("admitted")
            self.stats.inc("queued")
            self._ensure_dispatcher_locked()
            self._cv.notify_all()
        timeout = (None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        if not t.event.wait(timeout):
            with self._mu:
                if t.state == "queued":
                    # Expired while queued: remove ourselves so the
                    # dispatcher never wastes a cohort slot on us, and
                    # fail NOW — queue wait counted against the budget.
                    try:
                        self._queues[t.tenant].remove(t)
                    except (KeyError, ValueError):
                        pass
                    else:
                        self._pending -= 1
                    t.state = "expired"
                    self.stats.inc("expired_in_queue")
            # Raced with a release between wait() and the lock? state
            # says; an expired ticket was never released.
        if t.state == "expired":
            waited_ms = (time.monotonic() - t.enq_t) * 1e3
            raise DeadlineExceededError(
                f"deadline expired after {waited_ms:.1f} ms queued")
        return t

    def done(self, ticket: _Ticket) -> None:
        """Mark a released ticket finished: feeds the service-time
        estimate and frees an in-flight slot (waking the dispatcher)."""
        now = time.monotonic()
        if ticket.state == "released" and ticket.release_t:
            self.service_hist.observe(
                max(0.0, (now - ticket.release_t) * 1e6))
        with self._mu:
            if self._inflight > 0:
                self._inflight -= 1
            if self._pending:
                self._cv.notify_all()

    def _admit_now_locked(self, tenant, deadline, now,
                          fastpath: bool = True) -> _Ticket:
        t = _Ticket(tenant, deadline)
        t.enq_t = t.release_t = now
        t.state = "released"
        t.event.set()
        self._inflight += 1
        self.stats.inc("admitted")
        if fastpath:
            self.stats.inc("fastpath")
        return t

    # -- service-time estimate ----------------------------------------------

    def _estimate_us_locked(self, now: float) -> float:
        stamp, est = self._est_cache
        if now - stamp < _EST_TTL_S:
            return est
        est = None
        if self.service_hist.total >= _EST_MIN_SAMPLES:
            est = self.service_hist.percentile(_EST_QUANTILE)
        if not est and self.estimator is not None:
            try:
                ext = self.estimator()
                if ext:
                    est = float(ext)
            except Exception:  # noqa: BLE001 — estimator is advisory
                est = None
        if not est or est <= 0:
            est = self.default_service_us
        self._est_cache = (now, est)
        return est

    def _retry_after_s(self, depth: int, est_us: float) -> int:
        """Whole seconds until the present backlog should have drained
        (serialized at the current estimate), floored at 1 — the
        Retry-After contract promises 'not sooner than this'."""
        with_us = (depth + self._inflight + 1) * est_us
        return max(1, int(math.ceil(with_us / 1e6)))

    # -- dispatcher ----------------------------------------------------------

    def _ensure_dispatcher_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            # Event-driven loop (interval=None): the watchdog never
            # age-judges it — an empty queue parks the dispatcher
            # legitimately — but beats attribute its thread in stack
            # dumps and the release path is tracked in-flight.
            self._hb = HEALTH.register("sched-dispatch", interval=None,
                                       critical=True)
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="sched-dispatch",
                daemon=True)
            self._thread.start()

    def _dispatch_loop(self) -> None:
        while True:
            with self._mu:
                while not self._closed and self._pending == 0:
                    self._hb.idle()
                    self._cv.wait()
                self._hb.beat()
                if not self._closed and self._pending < self.max_cohort:
                    # Adaptive window: linear in the pending backlog,
                    # capped. A full cohort skips the wait entirely.
                    window_s = min(self.max_window_us,
                                   self.idle_window_us
                                   * max(1, self._pending)) / 1e6
                    end = time.monotonic() + window_s
                    while (not self._closed
                           and self._pending < self.max_cohort):
                        w = end - time.monotonic()
                        if w <= 0 or not self._cv.wait(w):
                            break
                cohort = self._pop_cohort_locked()
                closed = self._closed
            self._release(cohort)
            if closed and not cohort:
                return

    def _pop_cohort_locked(self) -> list:
        now = time.monotonic()
        cohort = []
        while self._pending and len(cohort) < self.max_cohort:
            best_q = None
            for q in self._queues.values():
                if q and (best_q is None or q[0].vt < best_q[0].vt):
                    best_q = q
            if best_q is None:  # bookkeeping drift; resync and bail
                self._pending = 0
                break
            t = best_q.popleft()
            self._pending -= 1
            if t.deadline is not None and now >= t.deadline:
                # Dead on arrival at dispatch: fail it, never run it.
                t.state = "expired"
                self.stats.inc("expired_in_queue")
                t.event.set()
                continue
            self._vclock = t.vt
            t.state = "released"
            t.release_t = now
            self.wait_hist.observe(max(0.0, (now - t.enq_t) * 1e6))
            cohort.append(t)
        if cohort:
            self._inflight += len(cohort)
            self.stats.inc("cohorts")
            if len(cohort) > 1:
                self.stats.inc("coalesced", len(cohort))
            self.batch_hist.observe(len(cohort))
        return cohort

    def _release(self, cohort: list) -> None:
        if not cohort:
            return
        with HEALTH.inflight("sched-dispatch", "release", base=5.0):
            self._release_inner(cohort)

    def _release_inner(self, cohort: list) -> None:
        if self.on_release is not None and len(cohort) > 1:
            # Burst hint: tell the mesh batch loop a cohort is landing
            # so its drain window holds open for the whole group.
            try:
                self.on_release(len(cohort))
            except Exception:  # noqa: BLE001 — the hint is advisory
                pass
        for t in cohort:
            t.event.set()

    # -- introspection / lifecycle -------------------------------------------

    def queue_depths(self) -> Dict[str, int]:
        """Per-tenant queued counts plus an 'all' total (the series
        `ctl top` reads)."""
        with self._mu:
            out = {t: len(q) for t, q in self._queues.items() if q}
            out["all"] = self._pending
            return out

    def tenant_cost_share(self, tenant: str) -> Optional[float]:
        """Fraction of total attributed device time this tenant has
        consumed (0..1), per the wired cost estimator. None when the
        estimator is unwired or fails — callers treat that as "no
        opinion", never as zero debt."""
        fn = self.cost_share_fn
        if fn is None:
            return None
        try:
            return float(fn(tenant))
        except Exception:
            return None

    def snapshot(self) -> dict:
        """Flat dict for /debug/vars."""
        with self._mu:
            out = {"queued": self._pending, "inflight": self._inflight,
                   "tenants": {t: len(q)
                               for t, q in self._queues.items() if q},
                   "estimate_us": self._est_cache[1]}
        out.update(self.stats.copy())
        out.update(self.wait_hist.snapshot("wait_us"))
        out.update(self.batch_hist.snapshot("batch"))
        return out

    def close(self) -> None:
        """Stop scheduling: releases everything queued (pass-through)
        and joins the dispatcher."""
        with self._mu:
            self._closed = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            HEALTH.unregister("sched-dispatch")
