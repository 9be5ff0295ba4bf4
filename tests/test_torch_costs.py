"""The cost ledger and the baseline watch (obs/costs.py) against the
JAX package's.

tests/test_costs.py's tests, run on both packages (fixture `pkg`): the
(tenant x shape) accounts, LRU folds that conserve every dimension, the
device-time rollup and its warm-up floor, cache savings, HBM
byte-seconds amortized over the touchers on an injected clock, the
EWMA + MAD regression watch (a 3x slowdown through the device.exec
seam flips it, recovery clears it, 10k clean observations never do),
/debug/costs, WAL bytes charged to the tenant, the observe-only
X-Pilosa-Cost-Debt header, ?explain=true's cost block, /metrics, and
the `ctl costs` panel; the network-tier conservation test runs on live
clusters in tests/test_torch_cluster_record.py. Equal between the packages: the ledger's
snapshot() and families after one seeded charge sequence, and the
watch's bands after one seeded observation stream. Port only: the
Server's [obs] wiring, and the governor's taps (a staged view's bytes x
seconds on the account whose query staged it, ended by a DELETE).
"""

import random
import time

import numpy as np
import pytest

from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.server import Server
from torch_obs import PKGS, isolated_stores, pkg  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

SLICE_WIDTH = 1 << 20
JAX_COSTS, PORT_COSTS = PKGS["jax"].costs, PKGS["torch"].costs


class _Clock:
    """Injectable monotonic stand-in for the ledger's residency
    clock: time advances only when the test says so, making byte ×
    second arithmetic exact."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _totals(led):
    return led.totals()


class TestLedgerAccounts:
    def test_contextless_charge_lands_in_fallback(self, pkg):
        led = pkg.costs.CostLedger()
        led.charge("wal_bytes", 128)
        snap = led.snapshot()
        assert snap["n_accounts"] == 1
        row = snap["accounts"][0]
        assert (row["tenant"], row["shape"]) == pkg.costs.FALLBACK
        assert row["wal_bytes"] == 128
        assert led.events["unattributed"] == 1

    def test_ambient_context_resolution_and_shape_stamp(self, pkg):
        led = pkg.costs.CostLedger()
        ctx, tok = pkg.costs.activate("gold")
        try:
            # The executor's route tap stamps the plan shape on the
            # ambient context; everything charged afterwards in this
            # request lands on (gold, sig-a).
            led.observe_route("sig-a", "mesh", "local", 1500.0,
                              staged_bytes=4096)
            assert ctx.shape == "sig-a"
            led.charge("wal_bytes", 64)
        finally:
            pkg.costs.deactivate(tok)
        snap = led.snapshot()
        row = next(a for a in snap["accounts"]
                   if (a["tenant"], a["shape"]) == ("gold", "sig-a"))
        assert row["queries"] == 1
        assert row["staged_bytes"] == 4096
        assert row["wal_bytes"] == 64

    def test_disabled_ledger_is_a_noop(self, pkg):
        led = pkg.costs.CostLedger()
        led.enabled = False
        _, tok = pkg.costs.activate("gold")
        try:
            led.charge("device_us", 100)
            led.observe_route("s", "mesh", "local", 10.0)
            led.record_device_us(100.0)
            led.view_staged("v", 1024)
        finally:
            pkg.costs.deactivate(tok)
        led.enabled = True
        assert led.snapshot()["n_accounts"] == 0
        assert sum(led.events.values()) == 0

    def test_lru_fold_conserves_every_dimension(self, pkg):
        """Hostile cardinality: 10 tenants into a 4-account table.
        Folds reroute history into the reserved row instead of
        dropping it, so dimension totals are invariant."""
        led = pkg.costs.CostLedger(max_accounts=4)
        for i in range(10):
            led.charge("device_us", 10.0, tenant=f"t{i}", shape="s")
            led.charge("wal_bytes", 7.0, tenant=f"t{i}", shape="s")
        snap = led.snapshot(limit=100)
        assert snap["n_accounts"] <= 4
        assert led.events["folded"] >= 6
        totals = snap["totals"]
        assert totals["device_us"] == pytest.approx(100.0)
        assert totals["wal_bytes"] == pytest.approx(70.0)
        # The fallback row absorbed the folds.
        fb = next(a for a in snap["accounts"]
                  if (a["tenant"], a["shape"]) == pkg.costs.FALLBACK)
        assert fb["device_us"] > 0
        # The per-tenant device rollup conserves independently of the
        # account-table folds (the debt signal must not forget).
        assert sum(led._tenant_dev.values()) == pytest.approx(100.0)
        assert led._total_dev == pytest.approx(100.0)

    def test_fallback_row_survives_any_overflow(self, pkg):
        led = pkg.costs.CostLedger(max_accounts=2)
        led.charge("wal_bytes", 1.0)  # creates pkg.costs.FALLBACK first
        for i in range(20):
            led.charge("wal_bytes", 1.0, tenant=f"t{i}", shape="s")
        snap = led.snapshot(limit=10)
        assert any((a["tenant"], a["shape"]) == pkg.costs.FALLBACK
                   for a in snap["accounts"])
        assert snap["totals"]["wal_bytes"] == pytest.approx(21.0)

    def test_cache_hit_credits_shape_history(self, pkg):
        led = pkg.costs.CostLedger()
        led.record_device_us(900.0, tenant="gold", shape="sig-a")
        led.record_device_us(1100.0, tenant="gold", shape="sig-a")
        _, tok = pkg.costs.activate("gold")
        try:
            led.observe_route("sig-a", "result-cache", "local", 5.0,
                              cache="hit")
        finally:
            pkg.costs.deactivate(tok)
        snap = led.snapshot()
        row = next(a for a in snap["accounts"]
                   if (a["tenant"], a["shape"]) == ("gold", "sig-a"))
        # Credit is the shape's own mean device cost: (900+1100)/2.
        assert row["saved_device_us"] == pytest.approx(1000.0)

    def test_device_weight_extrapolates_but_history_stays_raw(self, pkg):
        """1-in-N sampling: the charged estimate is us × N (unbiased),
        while the cache-savings history keeps the raw observation."""
        led = pkg.costs.CostLedger()
        led.record_device_us(500.0, weight=4.0, tenant="g", shape="s")
        snap = led.snapshot()
        assert snap["accounts"][0]["device_us"] == pytest.approx(2000.0)
        _, tok = pkg.costs.activate("g")
        try:
            led.observe_route("s", "result-cache", "local", 1.0,
                              cache="hit")
        finally:
            pkg.costs.deactivate(tok)
        row = led.snapshot()["accounts"][0]
        assert row["saved_device_us"] == pytest.approx(500.0)

    def test_tenant_share_stays_silent_through_warmup(self, pkg):
        led = pkg.costs.CostLedger()
        for _ in range(pkg.costs.CostLedger.MIN_SHARE_SAMPLES - 1):
            led.record_device_us(100.0, tenant="gold", shape="s")
        assert led.tenant_share("gold") == 0.0
        led.record_device_us(100.0, tenant="gold", shape="s")
        assert led.tenant_share("gold") == pytest.approx(1.0)

    def test_tenant_shares_sum_to_one(self, pkg):
        led = pkg.costs.CostLedger()
        for i in range(pkg.costs.CostLedger.MIN_SHARE_SAMPLES):
            led.record_device_us(float(10 + i), tenant=f"t{i % 3}",
                                 shape="s")
        total = sum(led.tenant_share(f"t{j}") for j in range(3))
        assert total == pytest.approx(1.0)

    def test_snapshot_sort_aliases(self, pkg):
        led = pkg.costs.CostLedger()
        led.charge("hbm_byte_seconds", 9.0, tenant="hog", shape="a")
        led.charge("wal_bytes", 9.0, tenant="writer", shape="b")
        led.charge("net_http_bytes", 9.0, tenant="chatty", shape="c")
        led.charge("device_us", 9.0, tenant="burner", shape="d")
        for sort, tenant in (("hbm", "hog"), ("wal", "writer"),
                             ("net", "chatty"), ("device_us", "burner"),
                             ("bogus", "burner")):
            snap = led.snapshot(sort=sort)
            assert snap["accounts"][0]["tenant"] == tenant, sort

    def test_families_are_fleet_mergeable_counters(self, pkg):
        led = pkg.costs.CostLedger()
        led.charge("device_us", 5.0, tenant="g", shape="s")
        led.charge("net_ici_bytes", 7.0, tenant="g", shape="s")
        led.charge("wal_bytes", 3.0)  # fallback → unattributed event
        fams = led.families()
        assert fams, "populated ledger must export families"
        for fam in fams:
            assert fam.mtype == "counter"
            assert fam.name.endswith("_total")
        by_name = {f.name: f for f in fams}
        # Samples are (suffix, ((label, value), ...), numeric).
        net = by_name["pilosa_cost_net_bytes_total"]
        assert any(dict(s[1]).get("tier") == "ici" for s in net.samples)
        ev = by_name["pilosa_cost_ledger_events_total"]
        assert any(dict(s[1]).get("account") == "unattributed"
                   for s in ev.samples)


class TestHbmByteSeconds:
    def test_residency_conservation(self, pkg):
        clk = _Clock()
        led = pkg.costs.CostLedger(clock=clk)
        _, tok = pkg.costs.activate("gold")
        try:
            led.view_staged("va", 1000)
            clk.advance(2.0)
            led.view_staged("vb", 500)
            clk.advance(3.0)
        finally:
            pkg.costs.deactivate(tok)
        totals = led.totals()  # totals() checkpoints first
        # va resident 5s × 1000B + vb resident 3s × 500B
        assert totals["hbm_byte_seconds"] == pytest.approx(6500.0)
        assert led.snapshot()["resident_views"] == 2

    def test_touch_amortization_splits_by_touch_count(self, pkg):
        clk = _Clock()
        led = pkg.costs.CostLedger(clock=clk)
        _, ta = pkg.costs.activate("a")
        try:
            led.view_staged("v", 100)
        finally:
            pkg.costs.deactivate(ta)
        clk.advance(1.0)
        _, tb = pkg.costs.activate("b")
        try:
            # Touch charges the interval so far (a alone), then joins.
            led.view_touched("v")
        finally:
            pkg.costs.deactivate(tb)
        clk.advance(1.0)
        led.checkpoint()
        snap = {(r["tenant"], r["shape"]): r
                for r in led.snapshot(limit=10)["accounts"]}
        assert snap[("a", "-")]["hbm_byte_seconds"] == pytest.approx(150.0)
        assert snap[("b", "-")]["hbm_byte_seconds"] == pytest.approx(50.0)
        assert led.totals()["hbm_byte_seconds"] == pytest.approx(200.0)

    def test_evict_finalizes_and_stops_the_meter(self, pkg):
        clk = _Clock()
        led = pkg.costs.CostLedger(clock=clk)
        _, tok = pkg.costs.activate("gold")
        try:
            led.view_staged("v", 256)
        finally:
            pkg.costs.deactivate(tok)
        clk.advance(4.0)
        led.view_evicted("v")
        assert led.totals()["hbm_byte_seconds"] == pytest.approx(1024.0)
        clk.advance(100.0)
        assert led.totals()["hbm_byte_seconds"] == pytest.approx(1024.0)
        assert led.snapshot()["resident_views"] == 0

    def test_toucher_cap_folds_into_fallback(self, pkg):
        clk = _Clock()
        led = pkg.costs.CostLedger(clock=clk)
        _, tok = pkg.costs.activate("t0")
        try:
            led.view_staged("v", 80)
        finally:
            pkg.costs.deactivate(tok)
        for i in range(1, 12):
            _, tok = pkg.costs.activate(f"t{i}")
            try:
                led.view_touched("v")
            finally:
                pkg.costs.deactivate(tok)
        clk.advance(1.0)
        led.checkpoint()
        snap = {(r["tenant"], r["shape"]): r
                for r in led.snapshot(limit=50)["accounts"]}
        assert pkg.costs.FALLBACK in snap and snap[pkg.costs.FALLBACK]["hbm_byte_seconds"] > 0
        assert led.totals()["hbm_byte_seconds"] == pytest.approx(80.0)


class TestBaselineWatch:
    def test_no_judgement_before_min_n(self, pkg):
        w = pkg.costs.BaselineWatch(min_n=32)
        for _ in range(10):
            w.observe("s", "cpu", "local", 1000.0)
        w.observe("s", "cpu", "local", 50_000.0)
        assert w.active() == []

    def test_flip_on_3x_slowdown_then_recover(self, pkg):
        w = pkg.costs.BaselineWatch(min_n=16, k=4.0)
        rng = random.Random(19)
        for _ in range(200):
            w.observe("sig-a", "cpu", "local",
                      1000.0 + rng.uniform(-50, 50))
        assert w.active() == []
        for _ in range(20):
            w.observe("sig-a", "cpu", "local", 3000.0)
        assert ("sig-a", "latency_us") in w.active()
        # Baseline freezes while regressed — the slowdown must not
        # launder itself into the new normal.
        row = next(r for r in w.snapshot(limit=10)
                   if r["shape"] == "sig-a")
        assert row["regressed"] and row["baseline"] < 1200.0
        for _ in range(60):
            w.observe("sig-a", "cpu", "local",
                      1000.0 + rng.uniform(-50, 50))
        assert w.active() == []

    def test_clean_10k_run_has_zero_false_positives(self, pkg):
        """The acceptance bar: realistic jitter (gaussian, multiple
        shapes/tiers) over 10k observations never flags."""
        w = pkg.costs.BaselineWatch()
        rng = random.Random(7)
        shapes = ("sig-a", "sig-b", "sig-c")
        tripped = 0
        for i in range(10_000):
            shape = shapes[i % 3]
            lat = max(1.0, rng.gauss(1000.0 * (1 + i % 3), 60.0))
            w.observe(shape, "cpu", "local" if i % 5 else "ici", lat)
            if i % 100 == 99 and w.active():
                tripped += 1
        assert tripped == 0
        assert w.active() == []

    def test_cached_routes_do_not_teach_the_baseline(self, pkg):
        w = pkg.costs.BaselineWatch(min_n=2)
        for _ in range(50):
            w.observe("s", "cpu", "local", 3.0, route="memo")
            w.observe("s", "cpu", "local", 5.0, route="result-cache")
        assert w.snapshot(limit=10) == []

    def test_bytes_per_s_regression_is_lower_is_worse(self, pkg):
        w = pkg.costs.BaselineWatch(min_n=16, k=4.0)
        rng = random.Random(3)
        for _ in range(100):
            w.observe("s", "tpu", "local", 1000.0,
                      bytes_per_s=1e9 + rng.uniform(-2e7, 2e7))
        assert w.active() == []
        for _ in range(20):
            w.observe("s", "tpu", "local", 1000.0, bytes_per_s=2e8)
        assert ("s", "bytes_per_s") in w.active()

    def test_seed_from_flight_document_and_bare_list(self, pkg):
        w = pkg.costs.BaselineWatch(min_n=32)
        doc = {"ring": 512, "top": [
            {"signature": "sig-a", "count": 500, "p50_us": 2000.0,
             "p99_us": 2200.0, "tiers": {"local": 9, "ici": 1}},
            {"signature": "", "count": 5, "p50_us": 100.0},  # skipped
        ]}
        assert w.seed_from_flight(doc, backend="cpu") == 2
        rows = w.snapshot(limit=10)
        assert {(r["tier"]) for r in rows} == {"local", "ici"}
        # Warm-started bands are past min_n: a sustained 3× shift
        # trips without a relearning period.
        assert all(r["n"] >= w.min_n for r in rows)
        for _ in range(10):
            w.observe("sig-a", "cpu", "local", 6000.0)
        assert ("sig-a", "latency_us") in w.active()
        w2 = pkg.costs.BaselineWatch()
        assert w2.seed_from_flight(
            [{"shape": "x", "p50_us": 10.0}], backend="cpu") == 1

    def test_band_table_is_lru_bounded(self, pkg):
        w = pkg.costs.BaselineWatch(max_bands=4)
        for i in range(20):
            w.observe(f"s{i}", "cpu", "local", 100.0)
        assert len(w.snapshot(limit=100)) <= 4

    def test_families_export_regression_gauge(self, pkg):
        w = pkg.costs.BaselineWatch(min_n=4, k=4.0)
        for _ in range(30):
            w.observe("s", "cpu", "local", 1000.0)
        for _ in range(10):
            w.observe("s", "cpu", "local", 4000.0)
        fams = w.families()
        assert len(fams) == 1
        fam = fams[0]
        assert fam.name == "pilosa_perf_regression"
        assert fam.mtype == "gauge"
        _suffix, labels, value = fam.samples[0][:3]
        labels = dict(labels)
        assert value == 1
        assert labels["shape"] == "s"
        assert labels["dimension"] == "latency_us"


class TestDeviceExecFaultSeam:
    def test_injected_device_stall_flips_the_band_and_recovery_clears(self, pkg):
        """A 3×+ device-exec slowdown injected at the fault seam: arm
        a delay on device.exec, measure each pass through the seam
        exactly as the serve layer's launch path would experience it,
        and feed the measured latencies to the watch. Deterministic by
        construction — sleep jitter is upward-only, so the stalled
        observations can only get further from baseline."""
        w = pkg.costs.BaselineWatch(min_n=16, k=4.0)
        rng = random.Random(11)
        base_us = 1000.0
        for _ in range(100):
            w.observe("sig-f", "cpu", "local",
                      base_us + rng.uniform(-20, 20))
        assert w.active() == []
        pkg.fault.arm("device.exec", delay=0.004)  # ≥4000us per launch
        try:
            for _ in range(12):
                t0 = time.perf_counter()
                pkg.fault.point("device.exec", sig="sig-f", kind="count")
                stall_us = (time.perf_counter() - t0) * 1e6
                assert stall_us >= 3500.0
                w.observe("sig-f", "cpu", "local", base_us + stall_us)
            assert ("sig-f", "latency_us") in w.active()
        finally:
            pkg.fault.reset()
        for _ in range(60):
            w.observe("sig-f", "cpu", "local", base_us)
        assert w.active() == []


@pytest.fixture
def env(tmp_path, pkg):
    """A handler over fresh cost singletons (isolated_stores)."""
    holder, handler = pkg.make_handler(tmp_path / "data")
    yield holder, handler
    holder.close()


def _seed(h, rows=4, slices=4):
    assert h.handle("POST", "/index/i").status == 200
    assert h.handle("POST", "/index/i/frame/f").status == 200
    for row in range(rows):
        q = "".join(
            f"SetBit(rowID={row}, frame=f, columnID={s * SLICE_WIDTH + row})"
            for s in range(slices))
        assert h.handle("POST", "/index/i/query",
                        body=q.encode()).status == 200


class TestHandlerIntegration:
    def test_debug_costs_endpoint_shape(self, env, pkg):
        _, h = env
        _seed(h)
        for _ in range(3):
            r = h.handle("POST", "/index/i/query",
                         body=b"Count(Bitmap(rowID=0, frame=f))",
                         headers={"x-pilosa-tenant": "gold"})
            assert r.status == 200
        r = h.handle("GET", "/debug/costs", params={"sort": "queries"})
        assert r.status == 200
        doc = r.json()
        assert doc["enabled"] is True
        assert doc["debt_threshold"] == h.cost_debt_threshold
        assert set(doc) >= {"sort", "accounts", "n_accounts", "totals",
                            "events", "resident_views", "regression"}
        assert set(doc["regression"]) == {"active", "bands"}
        label = h.slo.tenant_label("gold")
        assert any(a["tenant"] == label and a["queries"] >= 1
                   for a in doc["accounts"])
        assert set(doc["totals"]) == set(pkg.costs.DIMENSIONS)

    def test_writes_charge_wal_bytes_to_the_tenant(self, env, pkg):
        _, h = env
        assert h.handle("POST", "/index/i").status == 200
        assert h.handle("POST", "/index/i/frame/f").status == 200
        r = h.handle("POST", "/index/i/query",
                     body=b"SetBit(rowID=1, frame=f, columnID=3)",
                     headers={"x-pilosa-tenant": "gold"})
        assert r.status == 200
        label = h.slo.tenant_label("gold")
        snap = pkg.costs.LEDGER.snapshot(sort="wal", limit=50)
        charged = sum(a["wal_bytes"] for a in snap["accounts"]
                      if a["tenant"] == label)
        assert charged > 0

    def test_cost_debt_header_is_observe_only(self, env, pkg, monkeypatch):
        _, h = env
        # Drop the share-sample floor (32 real profiled queries is a
        # load test, not a unit test) and sample every query so
        # device_us lands on the first pass.
        monkeypatch.setattr(pkg.costs.CostLedger, "MIN_SHARE_SAMPLES", 0)
        h.profile_sample_rate = 1
        h.cost_debt_threshold = 0.05
        _seed(h)
        debt = None
        for row in range(3):
            r = h.handle("POST", "/index/i/query",
                         body=f"Count(Bitmap(rowID={row}, frame=f))"
                         .encode(),
                         headers={"x-pilosa-tenant": "gold"})
            assert r.status == 200  # observe-only: never throttles
            debt = r.headers.get("X-Pilosa-Cost-Debt") or debt
        assert debt is not None
        assert 0.0 < float(debt) <= 1.0
        # Threshold 0 disables the stamp entirely.
        h.cost_debt_threshold = 0.0
        r = h.handle("POST", "/index/i/query",
                     body=b"Count(Bitmap(rowID=0, frame=f))",
                     headers={"x-pilosa-tenant": "gold"})
        assert "X-Pilosa-Cost-Debt" not in r.headers

    def test_explain_carries_the_cost_block(self, env, pkg):
        _, h = env
        h.profile_sample_rate = 1
        _seed(h)
        assert h.handle("POST", "/index/i/query",
                        body=b"Count(Bitmap(rowID=0, frame=f))",
                        headers={"x-pilosa-tenant": "gold"}).status == 200
        r = h.handle("POST", "/index/i/query",
                     body=b"Count(Bitmap(rowID=0, frame=f))",
                     params={"explain": "true"},
                     headers={"x-pilosa-tenant": "gold"})
        assert r.status == 200
        cost = r.json()["cost"]
        assert set(cost) >= {"tenant", "shape", "tenant_device_us_share",
                             "account", "regressed"}
        assert cost["tenant"] == h.slo.tenant_label("gold")
        assert cost["account"].get("queries", 0) >= 1

    def test_device_us_rollup_conservation(self, env, pkg):
        """Sum over accounts == per-tenant rollup == global total:
        the invariant the debt header and the snapshot both lean on,
        across real handler traffic from two tenants."""
        _, h = env
        h.profile_sample_rate = 1
        _seed(h)
        for row in range(4):
            for tenant in ("gold", "tin"):
                assert h.handle(
                    "POST", "/index/i/query",
                    body=f"Count(Bitmap(rowID={row}, frame=f))".encode(),
                    headers={"x-pilosa-tenant": tenant}).status == 200
        led = pkg.costs.LEDGER
        totals = led.totals()
        assert totals["device_us"] == pytest.approx(led._total_dev)
        assert sum(led._tenant_dev.values()) == \
            pytest.approx(led._total_dev)
        assert totals["queries"] >= 8

    def test_metrics_scrape_exports_cost_families(self, env, pkg):
        _, h = env
        _seed(h)
        assert h.handle("POST", "/index/i/query",
                        body=b"Count(Bitmap(rowID=0, frame=f))",
                        headers={"x-pilosa-tenant": "gold"}).status == 200
        r = h.handle("GET", "/metrics")
        assert r.status == 200
        text = r.body.decode()
        assert "pilosa_cost_queries_total" in text
        assert 'tenant="' in text and 'shape="' in text

    def test_disabled_ledger_reported_and_unstamped(self, env, pkg):
        _, h = env
        _seed(h)
        pkg.costs.LEDGER.enabled = False
        r = h.handle("GET", "/debug/costs")
        assert r.json()["enabled"] is False
        r = h.handle("POST", "/index/i/query",
                     body=b"Count(Bitmap(rowID=0, frame=f))",
                     headers={"x-pilosa-tenant": "gold"})
        assert r.status == 200
        assert "X-Pilosa-Cost-Debt" not in r.headers


class TestCtlCostsPanel:
    DOC = {
        "sort": "device_us", "n_accounts": 2, "resident_views": 1,
        "enabled": True,
        "totals": {"queries": 12, "device_us": 123456.0,
                   "saved_device_us": 1000.0,
                   "hbm_byte_seconds": 2 ** 21, "staged_bytes": 4096.0,
                   "wal_bytes": 512.0, "net_http_bytes": 100.0,
                   "net_ici_bytes": 50.0},
        "events": {"tracked": 2, "folded": 3, "unattributed": 1},
        "regression": {"active": [
            {"shape": "sig-a", "dimension": "latency_us"}]},
        "accounts": [
            {"tenant": "gold", "shape": "sig-a", "queries": 10,
             "device_us": 120000.0, "saved_device_us": 1000.0,
             "hbm_byte_seconds": 2 ** 20, "staged_bytes": 4096.0,
             "wal_bytes": 512.0, "net_http_bytes": 100.0,
             "net_ici_bytes": 50.0, "regressed": True},
            {"tenant": "system", "shape": "-", "queries": 2,
             "device_us": 3456.0, "saved_device_us": 0.0,
             "hbm_byte_seconds": 2 ** 20, "staged_bytes": 0.0,
             "wal_bytes": 0.0, "net_http_bytes": 0.0,
             "net_ici_bytes": 0.0, "regressed": False},
        ],
    }

    def test_render_costs_panel(self, pkg):
        out = pkg.ctl.render_costs("127.0.0.1:10101", self.DOC)
        assert "accounts 2" in out
        assert "REGRESSION: shape sig-a latency_us" in out
        assert "folded 3" in out
        lines = out.splitlines()
        gold = next(l for l in lines if l.startswith("gold"))
        assert "sig-a" in gold and gold.endswith("REGRESSED")
        system = next(l for l in lines if l.startswith("system"))
        assert not system.endswith("REGRESSED")

    def test_render_costs_disabled(self, pkg):
        out = pkg.ctl.render_costs("h:1", {"enabled": False})
        assert "DISABLED" in out




class TestServerWiring:
    """Port only: the port Server applies [obs]'s cost knobs."""

    def _server(self, tmp_path, **knobs):
        c = Config()
        c.data_dir = str(tmp_path / "d")
        c.use_device = "off"
        for k, v in knobs.items():
            setattr(c, k, v)
        return Server(c)

    def test_config_knobs_reach_the_singletons(self, tmp_path):
        s = self._server(tmp_path, cost_max_accounts=64,
                         cost_watch_bands=48, cost_regression_k=6.5,
                         cost_regression_min_n=12, cost_debt_threshold=0.75)
        try:
            assert PORT_COSTS.LEDGER.enabled is True
            assert PORT_COSTS.LEDGER.max_accounts == 64
            assert PORT_COSTS.WATCH.max_bands == 48
            assert PORT_COSTS.WATCH.k == 6.5
            assert PORT_COSTS.WATCH.min_n == 12
            assert s.handler.cost_debt_threshold == 0.75
            assert s.scheduler.cost_share_fn == \
                PORT_COSTS.LEDGER.tenant_share
        finally:
            s.close()

    def test_cost_ledger_false_disables_both(self, tmp_path):
        s = self._server(tmp_path, cost_ledger=False)
        try:
            assert PORT_COSTS.LEDGER.enabled is False
            assert PORT_COSTS.WATCH.enabled is False
        finally:
            s.close()

    def test_obs_cost_knobs_round_trip(self, tmp_path):
        c = Config()
        c.cost_ledger = False
        c.cost_max_accounts = 64
        c.cost_debt_threshold = 0.9
        c2 = Config.from_toml(c.to_toml(), is_text=True)
        assert (c2.cost_ledger, c2.cost_max_accounts,
                c2.cost_debt_threshold) == (False, 64, 0.9)


class TestGovernorTaps:
    """Port only: MeshManager meters each staged view's bytes x seconds
    from its staging to its eviction on the account that staged it."""

    def test_staging_and_delete_meter_residency(self, tmp_path):
        holder, h = PKGS["torch"].make_handler(tmp_path / "d")
        try:
            _seed(h, rows=2, slices=2)
            r = h.handle("POST", "/index/i/query",
                         body=b"Count(Intersect(Bitmap(rowID=0, frame=f), "
                              b"Bitmap(rowID=1, frame=f)))",
                         headers={"X-Pilosa-Tenant": "default"})
            assert r.status == 200
            led = PORT_COSTS.LEDGER
            assert led.snapshot()["resident_views"] == 1
            view = next(iter(led._views.values()))
            mgr = h.executor.mesh_manager()
            # The pools staged, and the K3 index rows the Count then kept
            # on the card: the meter follows the view's bytes.
            assert view.nbytes == mgr._staged_total() > \
                mgr.stats["h2d_bytes"] > 0
            time.sleep(0.01)
            shape = "Count(Intersect(Bitmap[f],Bitmap[f]))"
            row = next(a for a in led.snapshot()["accounts"]
                       if a["shape"] == shape)
            assert row["hbm_byte_seconds"] > 0
            assert row["staged_bytes"] == mgr.stats["h2d_bytes"]
            assert h.handle("DELETE", "/index/i").status == 200
            assert led.snapshot()["resident_views"] == 0
            before = led.totals()["hbm_byte_seconds"]
            time.sleep(0.01)
            assert led.totals()["hbm_byte_seconds"] == before
        finally:
            holder.close()


def _charges(seed: int):
    """One seeded sequence of ledger operations."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(600):
        kind = int(rng.integers(7))
        tenant = f"t{int(rng.integers(6))}"
        shape = f"s{int(rng.integers(5))}"
        amt = float(rng.integers(1, 5000))
        ops.append((kind, tenant, shape, amt, f"v{int(rng.integers(4))}",
                    float(rng.integers(1, 40)) / 8))
    return ops


def _run_ledger(mod, seed, max_accounts):
    t = [100.0]
    led = mod.CostLedger(max_accounts=max_accounts, clock=lambda: t[0])
    for kind, tenant, shape, amt, view, dt in _charges(seed):
        t[0] += dt
        if kind == 0:
            led.charge("wal_bytes", amt, tenant=tenant, shape=shape)
        elif kind == 1:
            led.record_device_us(amt, weight=float(1 + amt % 3),
                                 tenant=tenant, shape=shape)
        elif kind == 2:
            ctx, tok = mod.activate(tenant)
            try:
                led.observe_route(shape, "mesh", "local", amt,
                                  staged_bytes=int(amt),
                                  cache="hit" if amt % 7 == 0 else None)
            finally:
                mod.deactivate(tok)
        elif kind == 3:
            ctx, tok = mod.activate(tenant)
            ctx.shape = shape
            try:
                led.view_staged(view, int(amt))
            finally:
                mod.deactivate(tok)
        elif kind == 4:
            ctx, tok = mod.activate(tenant)
            ctx.shape = shape
            try:
                led.view_touched(view)
            finally:
                mod.deactivate(tok)
        elif kind == 5:
            led.view_evicted(view)
        else:
            led.charge("device_us", amt)
    snaps = [led.snapshot(sort=s, limit=500) for s in
             ("device_us", "hbm", "wal", "queries", "staged")]
    fams = [(f.name, f.mtype, sorted(f.samples)) for f in led.families()]
    return snaps, fams, {f"t{i}": led.tenant_share(f"t{i}")
                         for i in range(6)}


class TestEqualToTheJaxPackage:
    @pytest.mark.parametrize("seed,max_accounts", [(0, 256), (1, 8),
                                                   (2, 3)])
    def test_ledger_snapshot_after_a_seeded_charge_sequence(
            self, seed, max_accounts):
        got = _run_ledger(PORT_COSTS, seed, max_accounts)
        want = _run_ledger(JAX_COSTS, seed, max_accounts)
        assert got == want

    @pytest.mark.parametrize("seed", range(3))
    def test_watch_bands_after_a_seeded_stream(self, seed):
        def run(mod):
            rng = random.Random(seed)
            w = mod.BaselineWatch(max_bands=16, min_n=16)
            for i in range(3000):
                shape = f"s{i % 5}"
                slow = 3.0 if 1200 <= i < 1400 and shape == "s1" else 1.0
                w.observe(shape, "cpu", ["local", "ici"][i % 2],
                          slow * rng.gauss(1000.0 * (1 + i % 5), 40.0),
                          bytes_per_s=rng.uniform(1e9, 1.1e9) / slow,
                          route=["mesh", "memo"][i % 17 == 0])
            return (w.snapshot(limit=100), w.active(),
                    [(f.name, f.mtype, f.samples) for f in w.families()])
        assert run(PORT_COSTS) == run(JAX_COSTS)
