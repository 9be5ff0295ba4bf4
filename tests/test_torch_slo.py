"""The SLO recorder (obs/slo.py) against the JAX package's.

tests/test_slo.py's tests of the recorder, run on both packages
(fixture `pkg`): the outcome vocabulary, the 5m / 1h / 6h rings'
rotation and bound, burn-rate math on hand-computed fixtures, budget
verdicts, tenant labels, the handler's outcome accounting, /debug/slo
against /metrics, and the `ctl top` SLO row; loadgen waits for ROADMAP
A9b. Equal between the packages on the same seeded inputs:
outcome_for_status for every status, log2_percentile and evaluate on
one seeded ring of buckets, and the whole status() after one seeded
record sequence on a hand-cranked clock.
"""

import numpy as np
import pytest

from pilosa_tpu.config import Config as JaxConfig
from pilosa_tpu_torch.config import Config
from torch_obs import PKGS, isolated_stores, pkg  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

JAX_SLO, PORT_SLO = PKGS["jax"].slo, PKGS["torch"].slo


def make_recorder(slo, **kw):
    """Recorder on a hand-cranked clock with no executor coupling."""
    clock = [0.0]
    kw.setdefault("mismatch_source", lambda: 0.0)
    rec = slo.SLORecorder(now=lambda: clock[0], **kw)
    return rec, clock


class TestOutcomeMapping:
    @pytest.mark.parametrize("status,partial,want", [
        (200, False, "ok"),
        (200, True, "partial"),
        (400, False, "client_error"),
        (404, False, "client_error"),
        (429, False, "shed"),
        (503, False, "backpressure"),
        (504, False, "deadline"),
        (500, False, "error"),
        (599, False, "error"),
    ])
    def test_outcome_for_status(self, status, partial, want, pkg):
        assert pkg.slo.outcome_for_status(status, partial) == want

    def test_good_set_is_availability_numerator(self, pkg):
        # 4xx counts good (the service did its job); shed + 5xx do not.
        assert pkg.slo.GOOD_OUTCOMES == {"ok", "partial", "client_error"}


class TestWindowRings:
    def test_rotation_and_eviction(self, pkg):
        rec, clock = make_recorder(pkg.slo)
        for _ in range(10):
            rec.record("ok", latency_us=100)
        assert rec.window_stats("5m")["total"] == 10
        # 4 minutes later: still inside 5m, 1h, 6h.
        clock[0] = 240.0
        assert rec.window_stats("5m")["total"] == 10
        # 6 minutes: evicted from 5m, alive in the longer windows.
        clock[0] = 360.0
        assert rec.window_stats("5m")["total"] == 0
        assert rec.window_stats("1h")["total"] == 10
        assert rec.window_stats("6h")["total"] == 10
        # Past 6h: gone everywhere; cumulative totals never reset.
        clock[0] = 22000.0
        assert rec.window_stats("6h")["total"] == 0
        assert sum(rec.outcome_totals.values()) == 10

    def test_ring_memory_is_bounded(self, pkg):
        rec, clock = make_recorder(pkg.slo)
        # A full simulated day of traffic: every ring must hold at
        # most its slot count, regardless of history length.
        for minute in range(24 * 60):
            clock[0] = minute * 60.0
            rec.record("ok", latency_us=50)
        for _, ring in rec._rings:
            assert len(ring.buckets) <= ring.slots

    def test_latency_merge_across_buckets(self, pkg):
        rec, clock = make_recorder(pkg.slo)
        rec.record("ok", latency_us=100)
        clock[0] = 25.0  # next 5m bucket
        rec.record("ok", latency_us=100_000)
        agg = rec.window_stats("5m")
        assert sum(sum(r) for r in agg["lat"].values()) == 2


class TestBurnRateMath:
    """Hand-computed fixtures for evaluate() — the math of record."""

    OBJ = {"availability": 99.0, "p99_us": 1000.0,
           "latency_target": 90.0, "shed_rate_max": 0.10}

    def agg(self, rec):
        return rec.window_stats("6h")

    def test_availability_burn(self, pkg):
        # 98 good + 2 error out of 100 -> bad 2%, budget 1% -> burn 2.
        rec, _ = make_recorder(pkg.slo)
        for _ in range(98):
            rec.record("ok", latency_us=10)
        rec.record("error")
        rec.record("error")
        ev = pkg.slo.evaluate(self.agg(rec), self.OBJ)
        assert ev["availability"]["sli"] == pytest.approx(0.98)
        assert ev["availability"]["burn_rate"] == pytest.approx(2.0)

    def test_latency_burn_counts_exact_threshold(self, pkg):
        # 8 under + 2 over of 10 served -> bad 20%, budget 10% ->
        # burn 2. The under test is exact (<= p99_us), not bucketed.
        rec, _ = make_recorder(pkg.slo, objectives={"p99_us": 1000.0})
        for _ in range(8):
            rec.record("ok", latency_us=1000.0)   # == threshold: under
        for _ in range(2):
            rec.record("ok", latency_us=1001.0)   # just over
        ev = pkg.slo.evaluate(self.agg(rec), self.OBJ)
        assert ev["latency"]["sli"] == pytest.approx(0.8)
        assert ev["latency"]["burn_rate"] == pytest.approx(2.0)

    def test_shed_burn(self, pkg):
        # 5 shed of 100 -> shed 5%, max 10% -> burn 0.5.
        rec, _ = make_recorder(pkg.slo)
        for _ in range(95):
            rec.record("ok", latency_us=10)
        for _ in range(5):
            rec.record("shed")
        ev = pkg.slo.evaluate(self.agg(rec), self.OBJ)
        assert ev["shed_rate"]["burn_rate"] == pytest.approx(0.5)
        assert ev["shed_rate"]["shed_fraction"] == pytest.approx(0.05)

    def test_empty_window_is_healthy(self, pkg):
        rec, _ = make_recorder(pkg.slo)
        ev = pkg.slo.evaluate(self.agg(rec), self.OBJ)
        for row in ev.values():
            assert row["burn_rate"] == 0.0
            assert row["sli"] == 1.0

    def test_sheds_do_not_feed_latency(self, pkg):
        rec, _ = make_recorder(pkg.slo)
        rec.record("shed")
        rec.record("deadline")
        agg = self.agg(rec)
        assert sum(agg["served"].values()) == 0


class TestBudgetAndVerdict:
    def test_budget_exhaustion_flips_verdict(self, pkg):
        rec, _ = make_recorder(pkg.slo, objectives={"availability": 99.0})
        for _ in range(99):
            rec.record("ok", latency_us=10)
        st = rec.status()
        assert st["objectives"]["availability"]["verdict"] == "OK"
        assert st["verdict"] == "OK"
        # One error in 100 burns the 1% budget exactly (burn 1.0,
        # remaining 0) — the verdict must flip.
        rec.record("error")
        st = rec.status()
        avail = st["objectives"]["availability"]
        assert avail["budget_remaining"] == pytest.approx(0.0)
        assert avail["verdict"] == "VIOLATED"
        assert st["verdict"] == "VIOLATED"

    def test_correctness_has_zero_budget(self, pkg):
        mm = [0.0]
        clock = [0.0]
        rec = pkg.slo.SLORecorder(now=lambda: clock[0],
                              mismatch_source=lambda: mm[0])
        rec.record("ok", latency_us=10)
        assert rec.status()["objectives"]["correctness"]["verdict"] \
            == "OK"
        mm[0] = 1.0  # any growth inside the window
        st = rec.status()
        assert st["objectives"]["correctness"]["verdict"] == "VIOLATED"
        assert st["objectives"]["correctness"]["budget_remaining"] == 0.0
        assert st["verdict"] == "VIOLATED"

    def test_tenant_label_bounded(self, pkg):
        rec, _ = make_recorder(pkg.slo, tenants=["gold"])
        assert rec.tenant_label("gold") == "gold"
        assert rec.tenant_label("default") == "default"
        assert rec.tenant_label("rando-42") == "other"

    def test_multi_window_burns_exported(self, pkg):
        rec, clock = make_recorder(pkg.slo, objectives={"availability": 99.0})
        # Old errors: only the long windows still see them.
        rec.record("error")
        rec.record("ok", latency_us=10)
        clock[0] = 400.0  # outside 5m
        for _ in range(8):
            rec.record("ok", latency_us=10)
        st = rec.status()
        burns = st["objectives"]["availability"]["burn_rates"]
        assert burns["5m"] == 0.0
        assert burns["6h"] == pytest.approx(10.0)  # 1/10 bad, 1% budget
        assert st["objectives"]["availability"]["fastest_burn"] \
            == pytest.approx(10.0)
        # 1h and 6h tie at 10.0; the shortest maximal window wins the
        # label (it's the page-worthy fast signal).
        assert st["objectives"]["availability"]["fastest_burn_window"] \
            == "1h"


@pytest.fixture
def env(tmp_path, pkg):
    holder, handler = pkg.make_handler(tmp_path / "data")
    yield holder, handler
    holder.close()


def seed(handler):
    assert handler.handle("POST", "/index/i").status == 200
    assert handler.handle("POST", "/index/i/frame/f").status == 200


class TestHandlerExposure:
    def test_outcomes_recorded_per_tenant_and_route(self, env, pkg):
        _, h = env
        h.slo = pkg.slo.SLORecorder(tenants=["gold"],
                                mismatch_source=lambda: 0.0)
        seed(h)
        body = b"Count(Bitmap(rowID=1, frame=f))"
        h.handle("POST", "/index/i/query", body=body)
        h.handle("POST", "/index/i/query", body=body,
                 headers={"X-Pilosa-Tenant": "gold"})
        h.handle("POST", "/index/i/query", body=body,
                 headers={"X-Pilosa-Tenant": "unknown-tenant"})
        h.handle("POST", "/index/i/query", body=b"Nope(")
        totals = h.slo.outcome_totals
        assert totals[("query", "default", "ok")] == 1
        assert totals[("query", "gold", "ok")] == 1
        assert totals[("query", "other", "ok")] == 1
        assert totals[("query", "default", "client_error")] == 1

    def test_remote_and_explain_not_judged(self, env, pkg):
        _, h = env
        h.slo = pkg.slo.SLORecorder(mismatch_source=lambda: 0.0)
        seed(h)
        r = h.handle("POST", "/index/i/query",
                     body=b"Count(Bitmap(rowID=1, frame=f))",
                     params={"explain": "true"})
        assert r.status == 200
        assert h.slo.outcome_totals == {}

    def test_debug_slo_and_metrics_agree(self, env, pkg):
        _, h = env
        h.slo = pkg.slo.SLORecorder(mismatch_source=lambda: 0.0)
        seed(h)
        for _ in range(4):
            h.handle("POST", "/index/i/query",
                     body=b"Count(Bitmap(rowID=1, frame=f))")
        r = h.handle("GET", "/debug/slo")
        assert r.status == 200
        st = r.json()
        assert st["verdict"] == "OK"
        assert st["budget_window"] == "6h"
        text = h.handle("GET", "/metrics").body.decode()
        metrics = pkg.ctl._parse_prom(text)
        for obj, row in st["objectives"].items():
            got = metrics[("pilosa_slo_budget_remaining",
                           (("objective", obj),))]
            assert got == pytest.approx(row["budget_remaining"])
            for window, burn in row["burn_rates"].items():
                key = ("pilosa_slo_burn_rate",
                       (("objective", obj), ("window", window)))
                assert metrics[key] == pytest.approx(burn)
        assert ("pilosa_query_outcome_total",
                (("outcome", "ok"), ("route", "query"),
                 ("tenant", "default"))) in metrics

    def test_slo_disabled(self, env, pkg):
        _, h = env
        h.slo = None
        seed(h)
        r = h.handle("POST", "/index/i/query",
                     body=b"Count(Bitmap(rowID=1, frame=f))")
        assert r.status == 200
        assert h.handle("GET", "/debug/slo").status == 404

    def test_profiled_query_gets_tenant_label(self, env, pkg):
        _, h = env
        h.slo = pkg.slo.SLORecorder(tenants=["gold"],
                                mismatch_source=lambda: 0.0)
        seed(h)
        r = h.handle("POST", "/index/i/query",
                     body=b"Count(Bitmap(rowID=1, frame=f))",
                     params={"profile": "true"},
                     headers={"X-Pilosa-Tenant": "gold"})
        assert r.status == 200
        phases, _ = pkg.profile.STATS.snapshot()
        assert any(key[2] == "gold" for key in phases)


class TestTopPanel:
    SCRAPE = """\
pilosa_uptime_seconds 5
pilosa_slo_budget_remaining{objective="availability"} 0.75
pilosa_slo_budget_remaining{objective="latency"} 0
pilosa_slo_burn_rate{objective="availability",window="5m"} 14.4
pilosa_slo_burn_rate{objective="availability",window="6h"} 0.25
pilosa_slo_burn_rate{objective="latency",window="6h"} 1.5
"""

    def test_slo_row(self, pkg):
        cur = pkg.ctl._parse_prom(self.SCRAPE)
        out = pkg.ctl.render_top("h:1", cur, {}, 0.0)
        assert "slo budget:" in out
        assert "availability 75% (burn 14.40@5m)" in out
        assert "latency 0% (burn 1.50@6h) VIOLATED" in out



class TestConfigWiring:
    def test_slo_section_roundtrip(self):
        c = Config.from_toml(
            "[slo]\nenabled = true\navailability = 99.5\n"
            "p99-us = 20000\nlatency-target = 98.0\n"
            "shed-rate-max = 0.02\n", is_text=True)
        assert c.slo_availability == 99.5
        assert c.slo_p99_us == 20000.0
        c2 = Config.from_toml(c.to_toml(), is_text=True)
        assert c2.slo_objectives() == c.slo_objectives()
        assert c.slo_objectives() == JaxConfig.from_toml(
            c.to_toml(), is_text=True).slo_objectives()

    def test_objectives_feed_recorder(self, pkg):
        c = Config()
        c.slo_availability = 90.0
        rec = pkg.slo.SLORecorder(objectives=c.slo_objectives(),
                                  mismatch_source=lambda: 0.0)
        assert rec.objectives["availability"] == 90.0

    def test_port_mismatch_source_reads_shadow_stats(self, monkeypatch):
        from pilosa_tpu_torch import executor

        monkeypatch.setattr(executor, "SHADOW_STATS",
                            executor.StatMap({"mismatch:mesh": 2,
                                              "mismatch:bsi": 1,
                                              "checks:mesh": 9}))
        assert PORT_SLO.shadow_mismatch_total() == 3.0


class TestEqualToTheJaxPackage:
    def test_outcome_for_status_every_status(self):
        for status in range(100, 600):
            for partial in (False, True):
                assert PORT_SLO.outcome_for_status(status, partial) == \
                    JAX_SLO.outcome_for_status(status, partial), status
        assert PORT_SLO.OUTCOMES == JAX_SLO.OUTCOMES

    @pytest.mark.parametrize("seed", range(4))
    def test_log2_percentile(self, seed):
        rng = np.random.default_rng(seed)
        counts = rng.integers(0, 50, 64).tolist()
        counts[: int(rng.integers(0, 20))] = [0] * int(rng.integers(0, 20))
        for q in (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
            assert PORT_SLO.log2_percentile(counts, q) == \
                JAX_SLO.log2_percentile(counts, q)
        assert PORT_SLO.log2_percentile([0] * 64, 0.5) == 0.0

    @staticmethod
    def _stream(mod, seed):
        """One seeded stream of records on a hand-cranked clock, the
        mismatch counter growing once in the middle."""
        rng = np.random.default_rng(seed)
        clock, mm = [0.0], [0.0]
        rec = mod.SLORecorder(objectives={"availability": 99.0,
                                          "p99_us": 2000.0},
                              tenants=["gold", "silver"],
                              now=lambda: clock[0],
                              mismatch_source=lambda: mm[0])
        tenants = ["gold", "silver", "default", "rando"]
        for i in range(3000):
            clock[0] += float(rng.exponential(4.0))
            outcome = JAX_SLO.OUTCOMES[int(rng.choice(
                7, p=[.8, .02, .05, .06, .03, .02, .02]))]
            lat = (float(rng.lognormal(6.5, 1.2))
                   if outcome in JAX_SLO.GOOD_OUTCOMES else None)
            rec.record(outcome, tenant=tenants[int(rng.integers(4))],
                       latency_us=lat, route=["query", "import"][i % 5 == 0],
                       trace_id=None if lat is None else f"{i:016x}")
            if i == 1500:
                rec.status()
                mm[0] = 1.0
        return rec

    @pytest.mark.parametrize("seed", range(3))
    def test_evaluate_and_status_equal(self, seed):
        want, got = self._stream(JAX_SLO, seed), self._stream(PORT_SLO, seed)
        for name, _, _ in JAX_SLO.WINDOWS:
            wa, ga = want.window_stats(name), got.window_stats(name)
            assert ga == wa
            assert PORT_SLO.evaluate(ga, got.objectives) == \
                JAX_SLO.evaluate(wa, want.objectives)
        assert got.status() == want.status()
        fam = lambda r: [(f.name, f.mtype, f.samples) for f in r.families()]
        assert fam(got) == fam(want)
