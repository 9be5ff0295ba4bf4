"""The query scheduler (sched/scheduler.py) against the JAX package's:
tests/test_sched.py's 18 tests, each run on both packages (fixture
`pkg`): the idle fast path, cohort coalescing (the full-cohort window
skip and the burst hint), WFQ tenant fairness and FIFO within a tenant,
deadline-aware admission (429 + Retry-After, trained and fault-forced
through the `sched.admit` seam), the expired-while-queued 504, and the
operator surfaces (pilosa_sched_* at /metrics, /debug/vars `sched`, the
`ctl top` scheduler panel). Every scheduler a test starts is closed by
it; no test sleeps longer than its 50 ms deadlines.
"""

import threading
import time

import pytest

from torch_obs import PKGS, isolated_stores, pkg  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def _wait_for(pred, timeout=5.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.001)
    return False


class TestFastPath:
    def test_idle_submit_is_immediate(self, pkg):
        s = pkg.sched.QueryScheduler()
        t0 = time.monotonic()
        tk = s.submit("default")
        dt = time.monotonic() - t0
        assert tk.state == "released"
        assert dt < 0.05  # no window, no dispatcher hop
        assert s.stats["fastpath"] == 1
        assert s.stats["admitted"] == 1
        assert s.stats["queued"] == 0
        s.done(tk)
        assert s.queue_depths() == {"all": 0}
        s.close()

    def test_fastpath_still_sheds_impossible_deadline(self, pkg):
        # An idle node cannot serve a 1 ms budget with a 10 s query.
        s = pkg.sched.QueryScheduler(default_service_us=10_000_000.0)
        with pytest.raises(pkg.sched.AdmissionError) as ei:
            s.submit("default", deadline=time.monotonic() + 0.1)
        assert ei.value.reason == "deadline"
        assert ei.value.retry_after_s >= 1
        assert s.stats["shed_deadline"] == 1
        s.close()

    def test_pre_expired_deadline_is_504_not_429(self, pkg):
        s = pkg.sched.QueryScheduler()
        with pytest.raises(pkg.errors.DeadlineExceededError):
            s.submit("default", deadline=time.monotonic() - 0.001)
        s.close()


class TestCoalescing:
    def test_full_cohort_releases_together(self, pkg):
        """Window coalescing determinism: with the window cranked far
        past the test horizon, NOTHING dispatches until the cohort
        fills — then the whole group releases at once, as one cohort,
        with one burst hint of the cohort size."""
        hints = []
        s = pkg.sched.QueryScheduler(max_window_us=5e6, idle_window_us=5e6,
                           max_cohort=4, on_release=hints.append)
        blocker = s.submit("default")  # inflight=1 forces queueing
        got, threads = [], []
        for _ in range(4):
            th = threading.Thread(
                target=lambda: got.append(s.submit("default")),
                daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=5.0)
        assert not any(th.is_alive() for th in threads)
        assert len(got) == 4
        assert all(t.state == "released" for t in got)
        # One cohort of 4 — not 4 cohorts of 1.
        assert s.stats["cohorts"] == 1
        assert s.stats["coalesced"] == 4
        assert s.batch_hist.total == 1
        assert hints == [4]
        for t in got:
            s.done(t)
        s.done(blocker)
        s.close()

    def test_close_drains_queued_tickets(self, pkg):
        s = pkg.sched.QueryScheduler(max_window_us=5e6, idle_window_us=5e6)
        blocker = s.submit("default")
        got = []
        th = threading.Thread(
            target=lambda: got.append(s.submit("default")), daemon=True)
        th.start()
        assert _wait_for(lambda: s.queue_depths()["all"] == 1)
        s.close()
        th.join(timeout=5.0)
        assert not th.is_alive()
        assert got and got[0].state == "released"
        s.done(got[0])
        s.done(blocker)


class TestFairness:
    def _enqueue_sequentially(self, s, order):
        """Launch one blocked submit() per (tenant,) entry, waiting for
        each to land in its queue before the next — deterministic
        enqueue order. Returns tickets in submission order."""
        tickets, threads = [], []
        for i, tenant in enumerate(order):
            th = threading.Thread(target=s.submit, args=(tenant,),
                                  daemon=True)
            th.start()
            threads.append(th)
            assert _wait_for(
                lambda n=i + 1: s.queue_depths().get("all") == n)
            with s._mu:
                tickets.append(s._queues[tenant][-1])
        return tickets, threads

    def test_weighted_fairness_and_fifo_within_tenant(self, pkg):
        """Weight 2 tenant drains 2x under backlog; FIFO holds within
        each tenant. Dispatcher is disabled so the pop order is
        observed directly (no release races)."""
        s = pkg.sched.QueryScheduler(max_cohort=6,
                           tenant_weights={"a": 2.0, "b": 1.0})
        s._ensure_dispatcher_locked = lambda: None  # manual dispatch
        s._inflight = 1  # defeat the idle fast path
        order = ["a", "b"] * 6
        tickets, threads = self._enqueue_sequentially(s, order)
        with s._mu:
            cohort = s._pop_cohort_locked()
        # 6 smallest virtual-finish stamps: a at 1/2 per slot vs b at
        # 1 per slot -> 4:2, the configured 2:1 weight ratio.
        tenants = [t.tenant for t in cohort]
        assert len(cohort) == 6
        assert tenants.count("a") == 4
        assert tenants.count("b") == 2
        by_tenant = {"a": [], "b": []}
        for t in cohort:
            by_tenant[t.tenant].append(t)
        sub_a = [t for t in tickets if t.tenant == "a"]
        sub_b = [t for t in tickets if t.tenant == "b"]
        assert by_tenant["a"] == sub_a[:4]  # FIFO within tenant
        assert by_tenant["b"] == sub_b[:2]
        s._release(cohort)
        with s._mu:
            rest = s._pop_cohort_locked()
        assert [t.tenant for t in rest].count("a") == 2
        assert [t.tenant for t in rest].count("b") == 4
        s._release(rest)
        for th in threads:
            th.join(timeout=5.0)
        assert not any(th.is_alive() for th in threads)

    def test_idle_tenant_first_request_not_starved(self, pkg):
        """An idle tenant's first request must not wait behind a hot
        tenant's whole backlog — it is stamped one quantum past the
        dispatch clock, interleaving near the front."""
        s = pkg.sched.QueryScheduler(tenant_weights={"hot": 1.0, "late": 1.0})
        s._ensure_dispatcher_locked = lambda: None
        s._inflight = 1
        tickets, threads = self._enqueue_sequentially(
            s, ["hot"] * 4 + ["late"])
        with s._mu:
            cohort = s._pop_cohort_locked()
        # late's stamp is vclock+1 = 1, tying hot's FIRST request — it
        # releases at the front of the cohort, not behind 4 hot ones.
        assert cohort[-1].tenant == "hot"
        assert [t.tenant for t in cohort].index("late") <= 1
        s._release(cohort)
        for th in threads:
            th.join(timeout=5.0)


class TestAdmission:
    def test_queue_full_sheds_429(self, pkg):
        s = pkg.sched.QueryScheduler(max_window_us=5e6, idle_window_us=5e6,
                           queue_depth=2)
        blocker = s.submit("default")
        threads = []
        for _ in range(2):
            th = threading.Thread(target=s.submit, args=("default",),
                                  daemon=True)
            th.start()
            threads.append(th)
        assert _wait_for(lambda: s.queue_depths()["all"] == 2)
        with pytest.raises(pkg.sched.AdmissionError) as ei:
            s.submit("default")
        assert ei.value.reason == "queue_full"
        assert ei.value.retry_after_s >= 1
        assert s.stats["shed_queue_full"] == 1
        s.close()  # drains the two queued tickets
        for th in threads:
            th.join(timeout=5.0)
        assert not any(th.is_alive() for th in threads)
        s.done(blocker)

    def test_deadline_shed_counts_backlog(self, pkg):
        """Admission projects (queue ahead + self) * estimate against
        the deadline budget — a backlog the budget cannot absorb is
        shed at the door, not after queueing."""
        s = pkg.sched.QueryScheduler(max_window_us=5e6, idle_window_us=5e6,
                           default_service_us=50_000.0)  # 50 ms est
        blocker = s.submit("default")
        th = threading.Thread(target=s.submit, args=("default",),
                              daemon=True)
        th.start()
        assert _wait_for(lambda: s.queue_depths()["all"] == 1)
        # Budget fits one 50 ms service but not the projected queue
        # (1 queued + 1 inflight + self) * 50 ms = 150 ms.
        with pytest.raises(pkg.sched.AdmissionError) as ei:
            s.submit("default", deadline=time.monotonic() + 0.1)
        assert ei.value.reason == "deadline"
        s.close()
        th.join(timeout=5.0)
        s.done(blocker)

    def test_expired_while_queued_raises_504_immediately(self, pkg):
        """Queue wait counts against the query's deadline: a ticket
        whose deadline lapses while queued fails with
        DeadlineExceededError the moment it expires. It is never
        dispatched and never waits out the window."""
        s = pkg.sched.QueryScheduler(max_window_us=5e6, idle_window_us=5e6)
        blocker = s.submit("default")
        t0 = time.monotonic()
        with pytest.raises(pkg.errors.DeadlineExceededError) as ei:
            s.submit("default", deadline=t0 + 0.05)
        waited = time.monotonic() - t0
        assert "queued" in str(ei.value)
        assert 0.04 <= waited < 2.0  # expired at ~50 ms, not window end
        assert s.stats["expired_in_queue"] == 1
        assert s.queue_depths()["all"] == 0  # removed itself
        s.close()
        s.done(blocker)

    def test_service_estimate_trains_from_done(self, pkg):
        s = pkg.sched.QueryScheduler(default_service_us=1.0)
        for _ in range(8):
            tk = s.submit("default")
            tk.release_t = time.monotonic() - 0.2  # 200 ms service
            s.done(tk)
        s._est_cache = (0.0, 0.0)  # expire the TTL cache
        with s._mu:
            est = s._estimate_us_locked(time.monotonic())
        assert est >= 100_000  # p95 of observed, not the 1 us default
        s.close()


@pytest.fixture
def env(tmp_path, pkg):
    holder, handler = pkg.make_handler(tmp_path / "data")
    yield holder, handler
    pkg.fault.reset()
    if handler.scheduler is not None:
        handler.scheduler.close()
    holder.close()


def _seed(h):
    assert h.handle("POST", "/index/i").status == 200
    assert h.handle("POST", "/index/i/frame/f").status == 200
    assert h.handle(
        "POST", "/index/i/query",
        body=b"SetBit(rowID=1, frame=f, columnID=5)").status == 200


class TestHandlerIntegration:
    def test_tenant_header_reaches_scheduler(self, env, pkg):
        holder, h = env
        _seed(h)
        h.scheduler = pkg.sched.QueryScheduler()
        resp = h.handle("POST", "/index/i/query",
                        headers={"X-Pilosa-Tenant": "acme"},
                        body=b"Count(Bitmap(rowID=1, frame=f))")
        assert resp.status == 200
        assert h.scheduler.stats["fastpath"] >= 1
        # Ticket returned via done(): nothing stuck inflight.
        assert h.scheduler._inflight == 0

    def test_overload_answers_429_with_retry_after(self, env, pkg):
        """End-to-end overload: the executor is too slow (10 s
        estimate) for the request's 100 ms deadline budget, so the
        handler sheds with 429 + a computed Retry-After."""
        holder, h = env
        _seed(h)
        h.scheduler = pkg.sched.QueryScheduler(default_service_us=10_000_000.0)
        resp = h.handle("POST", "/index/i/query",
                        headers={"X-Pilosa-Deadline-Us": "100000"},
                        body=b"Count(Bitmap(rowID=1, frame=f))")
        assert resp.status == 429
        assert int(resp.headers["Retry-After"]) >= 1
        body = resp.json()
        assert body["reason"] == "deadline"
        assert body["retry_after_s"] >= 1
        assert h.scheduler.stats["shed_deadline"] == 1

    def test_fault_forced_shed_is_deterministic(self, env, pkg):
        """The sched.admit fault seam: an armed AdmissionError instance
        forces a shed with an exact Retry-After — the chaos-test lever
        for 429 handling."""
        holder, h = env
        _seed(h)
        h.scheduler = pkg.sched.QueryScheduler()
        pkg.fault.arm("sched.admit",
                  error=pkg.sched.AdmissionError("forced shed", 7.0, "queue_full"),
                  times=1)
        resp = h.handle("POST", "/index/i/query",
                        body=b"Count(Bitmap(rowID=1, frame=f))")
        assert resp.status == 429
        assert resp.headers["Retry-After"] == "7"
        assert resp.json()["reason"] == "queue_full"
        pkg.fault.reset()
        # Rule exhausted: the next query admits normally.
        resp = h.handle("POST", "/index/i/query",
                        body=b"Count(Bitmap(rowID=1, frame=f))")
        assert resp.status == 200

    def test_expired_while_queued_is_504_through_handler(self, env, pkg):
        holder, h = env
        _seed(h)
        s = pkg.sched.QueryScheduler(max_window_us=5e6, idle_window_us=5e6)
        h.scheduler = s
        blocker = s.submit("default")  # force the queue path
        resp = h.handle("POST", "/index/i/query",
                        headers={"X-Pilosa-Deadline-Us": "50000"},
                        body=b"Count(Bitmap(rowID=1, frame=f))")
        assert resp.status == 504
        assert "queued" in resp.json()["error"]
        assert s.stats["expired_in_queue"] == 1
        s.done(blocker)

    def test_metrics_and_debug_vars_expose_sched(self, env, pkg):
        holder, h = env
        _seed(h)
        h.scheduler = pkg.sched.QueryScheduler(default_service_us=10_000_000.0)
        assert h.handle("POST", "/index/i/query",
                        body=b"Count(Bitmap(rowID=1, frame=f))"
                        ).status == 200
        assert h.handle("POST", "/index/i/query",
                        headers={"X-Pilosa-Deadline-Us": "100000"},
                        body=b"Count(Bitmap(rowID=1, frame=f))"
                        ).status == 429
        text = h.handle("GET", "/metrics").body.decode()
        assert 'pilosa_sched_queue_depth{tenant="all"} 0' in text
        assert 'pilosa_sched_shed_total{reason="deadline"} 1' in text
        assert 'pilosa_sched_admitted_total{path="fastpath"}' in text
        snap = h.handle("GET", "/debug/vars").json()
        assert snap["sched"]["fastpath"] >= 1
        assert snap["sched"]["shed_deadline"] == 1
        assert snap["query.shed"] == 1


class TestTopPanel:
    CUR = (
        'pilosa_uptime_seconds 10\n'
        'pilosa_sched_queue_depth{tenant="all"} 3\n'
        'pilosa_sched_queue_depth{tenant="acme"} 3\n'
        'pilosa_sched_shed_total{reason="deadline"} 5\n'
        'pilosa_sched_shed_total{reason="queue_full"} 1\n'
        'pilosa_sched_batch_size_bucket{le="1"} 2\n'
        'pilosa_sched_batch_size_bucket{le="4"} 10\n'
        'pilosa_sched_batch_size_bucket{le="+Inf"} 10\n'
        'pilosa_sched_batch_size_count 10\n')
    PREV = ('pilosa_sched_shed_total{reason="deadline"} 1\n'
            'pilosa_sched_shed_total{reason="queue_full"} 1\n')

    def test_sched_panel_renders(self, pkg):
        out = pkg.ctl.render_top("h:1", pkg.ctl._parse_prom(self.CUR),
                         pkg.ctl._parse_prom(self.PREV), 2.0)
        assert "sched: queue 3" in out
        # (5+1) - (1+1) = 4 sheds over 2 s.
        assert "shed 6 (2.0/s)" in out
        assert "batch p50 4 p95 4 (10 cohorts)" in out

    def test_no_sched_series_no_panel(self, pkg):
        out = pkg.ctl.render_top("h:1",
                         pkg.ctl._parse_prom("pilosa_uptime_seconds 1\n"), {},
                         1.0)
        assert "sched:" not in out
