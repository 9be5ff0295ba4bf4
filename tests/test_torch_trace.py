"""Traces, measured profiles and the query-shape flight recorder of the
port (obs/trace.py, obs/profile.py, obs/flight.py, Executor._shape_sig)
against the JAX package's.

Run on both packages (fixture `pkg`): the span tests of
tests/test_obs.py (nesting, the no-op, error tags, wrap_ctx, the rings)
and the QueryProfile tests of tests/test_profile.py (union-of-intervals
phases on an injected clock, wrap_ctx, the roofline's engine), the
/debug/queries and /debug/traces surface, ?profile=true, 1-in-N
sampling and the `ctl top` parser and panel. Equal between the
packages on the same seeded inputs: the flight recorder's snapshot
after one seeded sequence of recordings, and `_shape_sig` of every PQL
call the port serves. Port only: the roofline's peak table (the H100's
3.35e12 B/s by the card's name, None for another card) and a CPU
profile whose roofline reads the measured host rate, never a TPU's.
"""

import threading
import time

import numpy as np
import pytest

from pilosa_tpu.pql import parse_string as jax_parse
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.obs import profile as port_profile
from pilosa_tpu_torch.pql import parse_string as port_parse
from pilosa_tpu_torch.server import Server
from torch_obs import PKGS, isolated_stores, pkg  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

SLICE_WIDTH = 1 << 20
SLOW_ENV = {"jax": "PILOSA_TPU_SLOW_QUERY_US",
            "torch": "PILOSA_TORCH_SLOW_QUERY_US"}


class _FakeNs:
    """The profiler's clock, advanced only by the test."""

    def __init__(self, start_ns: int = 1_000_000_000):
        self.t = start_ns

    def __call__(self) -> int:
        return self.t

    def advance_us(self, us: float) -> None:
        self.t += int(us * 1000)


class TestSpans:
    def test_nesting_and_ordering(self, pkg):
        obs = pkg.obs
        tracer = obs.Tracer()
        trace = tracer.start("query", index="i")
        with trace.root:
            with obs.span("plan") as plan:
                with obs.span("lower"):
                    pass
            with obs.span("gather", slices=3) as gather:
                pass
        tracer.finish(trace)
        by_name = {s.name: s for s in trace.spans}
        assert by_name["query"].parent_id is None
        assert by_name["plan"].parent_id == by_name["query"].span_id
        assert by_name["lower"].parent_id == by_name["plan"].span_id
        assert by_name["gather"].parent_id == by_name["query"].span_id
        assert gather.tags == {"slices": 3}
        starts = [s.start_ns for s in trace.spans]
        assert starts == sorted(starts)
        for s in trace.spans:
            assert s.end_ns is not None and s.end_ns >= s.start_ns
        assert plan.start_ns >= by_name["query"].start_ns

    def test_span_without_trace_is_noop(self, pkg):
        obs = pkg.obs
        assert obs.current_span() is None
        sp = obs.span("anything", key="val")
        assert sp is obs.NOOP_SPAN
        with sp as inner:
            inner.tag(more="tags")
        assert obs.current_span() is None

    def test_error_tagged_on_exception(self, pkg):
        tracer = pkg.obs.Tracer()
        trace = tracer.start("query")
        with pytest.raises(ValueError):
            with trace.root:
                with pkg.obs.span("boom"):
                    raise ValueError("x")
        tracer.finish(trace)
        boom = next(s for s in trace.spans if s.name == "boom")
        assert boom.tags["error"] == "ValueError"

    def test_wrap_ctx_carries_span_across_threads(self, pkg):
        obs = pkg.obs
        tracer = obs.Tracer()
        trace = tracer.start("query")
        seen = []

        def work():
            with obs.span("worker"):
                seen.append(obs.current_span().name)

        with trace.root:
            fn = obs.wrap_ctx(work)
        t = threading.Thread(target=fn)
        t.start()
        t.join()
        tracer.finish(trace)
        assert seen == ["worker"]
        worker = next(s for s in trace.spans if s.name == "worker")
        assert worker.parent_id == trace.root.span_id

    def test_wrap_ctx_without_anything_active_returns_fn(self, pkg):
        def fn():
            pass

        assert pkg.obs.wrap_ctx(fn) is fn

    def test_ring_eviction(self, pkg):
        tracer = pkg.obs.Tracer(ring=3, slow_us=10**12)
        traces = [tracer.start(f"q{i}") for i in range(5)]
        for tr in traces:
            tracer.finish(tr)
        snap = tracer.snapshot()
        assert [t["name"] for t in snap["recent"]] == ["q4", "q3", "q2"]
        assert snap["slow"] == []
        assert tracer.get(traces[0].trace_id) is None
        assert tracer.get(traces[4].trace_id) is traces[4]

    def test_slow_ring_threshold(self, pkg):
        tracer = pkg.obs.Tracer(ring=8, slow_us=0.0)
        tr = tracer.start("q")
        tracer.finish(tr)
        assert [t["id"] for t in tracer.snapshot()["slow"]] == [tr.trace_id]

    def test_env_overrides_slow_threshold(self, pkg, monkeypatch):
        monkeypatch.setenv(SLOW_ENV[pkg.name], "123")
        assert pkg.obs.Tracer(slow_us=10**9).slow_us == 123.0

    def test_log_record_carries_the_trace(self):
        """The port's JSON log lines carry the active trace and span:
        obs/log.CURRENT is the span the tracer sets."""
        import logging

        from pilosa_tpu_torch import obs
        from pilosa_tpu_torch.obs.log import TraceContextFilter

        tracer = obs.Tracer()
        trace = tracer.start("query")
        rec = logging.LogRecord("x", logging.INFO, __file__, 1, "m", (),
                                None)
        with trace.root, obs.span("plan") as sp:
            TraceContextFilter().filter(rec)
        tracer.finish(trace)
        assert rec.trace_id == trace.trace_id
        assert rec.span_id == sp.span_id and rec.span == "plan"


class TestQueryProfile:
    def test_noop_when_inactive(self, pkg):
        profile = pkg.profile
        assert profile.current() is None
        ph = profile.phase("device_exec")
        assert ph is profile.NOOP_PHASE
        with ph:
            pass
        ph.start().stop()
        profile.add_bytes("bytes_staged", 123)
        profile.add_slice(slice=1)
        assert profile.current() is None

    def test_phase_accumulates_and_to_dict_shape(self, pkg, monkeypatch):
        profile = pkg.profile
        clk = _FakeNs()
        monkeypatch.setattr(profile, "monotonic_ns", clk)
        p = profile.QueryProfile(backend="cpu")
        tok = profile.activate(p)
        try:
            with profile.phase("parse"):
                clk.advance_us(1500)
            ph = profile.phase("plan").start()
            clk.advance_us(2500)
            ph.stop()
            profile.add_bytes("bytes_touched_hbm", 4096)
        finally:
            profile.deactivate(tok)
        clk.advance_us(100)
        p.finish()
        d = p.to_dict()
        assert set(d) >= {"backend", "total_us", "phases_us", "bytes",
                          "roofline"}
        assert d["phases_us"] == {"parse": 1500.0, "plan": 2500.0}
        assert d["total_us"] == 4100.0
        assert d["bytes"] == {"bytes_touched_hbm": 4096}

    def test_nested_same_phase_not_double_counted(self, pkg, monkeypatch):
        clk = _FakeNs()
        monkeypatch.setattr(pkg.profile, "monotonic_ns", clk)
        p = pkg.profile.QueryProfile(backend="cpu")
        with p.phase("stage_h2d"):
            clk.advance_us(500)
            with p.phase("stage_h2d"):
                clk.advance_us(2000)
            clk.advance_us(500)
        assert p.phase_us("stage_h2d") == 3000

    def test_concurrent_same_phase_union(self, pkg, monkeypatch):
        clk = _FakeNs()
        monkeypatch.setattr(pkg.profile, "monotonic_ns", clk)
        p = pkg.profile.QueryProfile(backend="cpu")
        a = p.phase("host_fold").start()
        clk.advance_us(4000)
        b = p.phase("host_fold").start()
        clk.advance_us(6000)
        a.stop()
        clk.advance_us(2000)
        b.stop()
        assert p.phase_us("host_fold") == 12_000

    def test_open_phase_credited_in_snapshot(self, pkg, monkeypatch):
        clk = _FakeNs()
        monkeypatch.setattr(pkg.profile, "monotonic_ns", clk)
        p = pkg.profile.QueryProfile(backend="cpu")
        ph = p.phase("host_fold")
        ph.__enter__()
        clk.advance_us(1000)
        assert p.to_dict()["phases_us"]["host_fold"] == 1000.0
        ph.__exit__(None, None, None)

    def test_wrap_ctx_carries_profile_across_threads(self, pkg,
                                                     monkeypatch):
        clk = _FakeNs()
        monkeypatch.setattr(pkg.profile, "monotonic_ns", clk)
        p = pkg.profile.QueryProfile(backend="cpu")
        tok = pkg.profile.activate(p)
        try:
            def work():
                with pkg.profile.phase("host_fold"):
                    clk.advance_us(1000)

            fn = pkg.obs.wrap_ctx(work)
        finally:
            pkg.profile.deactivate(tok)
        t = threading.Thread(target=fn)
        t.start()
        t.join()
        assert p.phase_us("host_fold") == 1000

    def test_roofline_prefers_device_engine(self, pkg):
        p = pkg.profile.QueryProfile(backend="cpu")
        p.add_phase_ns("device_exec", 1_000_000)
        p.add_phase_ns("host_fold", 5_000_000)
        p.add_bytes("bytes_touched_hbm", 100 * 1024 * 1024)
        p.finish()
        rf = p.to_dict()["roofline"]
        assert rf["engine"] == "device"
        want = 100 * 1024 * 1024 / 1e-3
        assert rf["achieved_bytes_per_s"] == pytest.approx(want, rel=1e-6)
        assert rf["fraction_of_peak"] > 0

    def test_profile_stats_families(self, pkg):
        p = pkg.profile.QueryProfile(backend="cpu")
        p.tenant = "gold"
        p.add_phase_ns("parse", 50_000)
        p.finish()
        pkg.profile.STATS.record(p)
        fams = {f.name: f for f in pkg.profile.STATS.families()}
        fam = fams["pilosa_query_phase_us"]
        assert fam.mtype == "histogram"
        labels = {tuple(sorted(dict(s[1]).keys())) for s in fam.samples}
        assert ("backend", "le", "phase", "tenant") in labels


class TestPeakBandwidth:
    """Port only: the roofline's peak is keyed on the card's name."""

    def test_h100_by_name(self, monkeypatch):
        monkeypatch.setattr(port_profile, "device_name",
                            lambda: "NVIDIA H100 80GB HBM3")
        assert port_profile.peak_bytes_per_s("cuda") == 3.35e12

    def test_unknown_card_gets_no_roofline(self, monkeypatch):
        monkeypatch.setattr(port_profile, "device_name",
                            lambda: "NVIDIA A100-SXM4-80GB")
        assert port_profile.peak_bytes_per_s("cuda") is None
        assert port_profile.peak_bytes_per_s("tpu") is None
        p = port_profile.QueryProfile(backend="cuda")
        p.add_phase_ns("device_exec", 1_000_000)
        p.add_bytes("bytes_touched_hbm", 1 << 20)
        rf = p.roofline()
        assert rf["peak_bytes_per_s"] is None
        assert rf["fraction_of_peak"] is None
        assert rf["achieved_bytes_per_s"] > 0
        port_profile.STATS.record(p)  # a null fraction records no roofline
        assert port_profile.STATS.snapshot()[1] == {}

    def test_host_measured_and_cached(self):
        a = port_profile.peak_bytes_per_s("cpu")
        assert a > 1e8 and port_profile.peak_bytes_per_s("host") == a


def _seed(h, rows=6, slices=16):
    assert h.handle("POST", "/index/i").status == 200
    assert h.handle("POST", "/index/i/frame/f").status == 200
    for row in range(rows):
        q = "".join(
            f"SetBit(rowID={row}, frame=f, columnID={s * SLICE_WIDTH + row})"
            for s in range(slices))
        assert h.handle("POST", "/index/i/query", body=q.encode()).status \
            == 200


@pytest.fixture
def env(tmp_path, pkg):
    holder, handler = pkg.make_handler(tmp_path / "data")
    yield holder, handler
    holder.close()


class TestDebugQueries:
    def test_debug_queries_shape(self, env, pkg):
        _, h = env
        _seed(h, rows=1, slices=1)
        r = h.handle("POST", "/index/i/query",
                     body=b"Count(Bitmap(rowID=0, frame=f))")
        assert r.status == 200 and r.json()["results"] == [1]
        snap = h.handle("GET", "/debug/queries").json()
        assert set(snap) == {"slow_threshold_us", "recent", "slow"}
        assert len(snap["recent"]) == 2  # SetBit + Count, newest first
        for t in snap["recent"]:
            assert set(t) >= {"id", "name", "start", "duration_us",
                              "spans", "tags"}
        assert snap["recent"][0]["tags"]["query"].startswith("Count(")
        refiltered = h.handle("GET", "/debug/queries",
                              params={"threshold_us": "0"}).json()
        assert len(refiltered["slow"]) == 2

    def test_count_trace_has_pipeline_stages(self, env, pkg):
        _, h = env
        _seed(h, rows=2, slices=2)
        r = h.handle("POST", "/index/i/query",
                     body=b"Count(Intersect(Bitmap(rowID=0, frame=f), "
                          b"Bitmap(rowID=1, frame=f)))")
        assert r.status == 200
        tid = h.handle("GET", "/debug/queries").json()["recent"][0]["id"]
        tr = h.handle("GET", f"/debug/traces/{tid}").json()
        names = {s["name"] for s in tr["spans"]}
        assert {"query", "parse", "plan"} <= names and len(names) >= 4
        plan = next(s for s in tr["spans"] if s["name"] == "plan")
        assert plan["tags"]["route"] in ("roaring", "memo", "host-fold",
                                         "mesh")
        starts = [s["start_us"] for s in tr["spans"]]
        assert starts == sorted(starts)
        if pkg.name == "torch":  # the card path: down to the launch
            assert {"stage", "launch"} <= names
            launch = next(s for s in tr["spans"] if s["name"] == "launch")
            # One bit a slice: a single container, read through K3.
            assert launch["tags"]["kernel"] == "tree_count_rows"

    def test_unknown_trace_404(self, env, pkg):
        _, h = env
        assert h.handle("GET", "/debug/traces/nope").status == 404

    def test_exemplar_links_latency_to_trace(self, env, pkg):
        _, h = env
        _seed(h, rows=1, slices=2)
        h.handle("POST", "/index/i/query",
                 body=b"Count(Bitmap(rowID=0, frame=f))")
        tid = h.handle("GET", "/debug/queries").json()["recent"][0]["id"]
        text = h.handle("GET", "/metrics",
                        params={"exemplars": "true"}).body.decode()
        assert f'trace_id="{tid}"' in text
        assert 'trace_id="' not in h.handle("GET",
                                            "/metrics").body.decode()


class TestProfileEndpoint:
    def test_profile_section_shape(self, env, pkg):
        _, h = env
        _seed(h, rows=1, slices=4)
        r = h.handle("POST", "/index/i/query",
                     body=b"Count(Bitmap(rowID=0, frame=f))",
                     params={"profile": "true"})
        assert r.status == 200
        j = r.json()
        assert j["results"] == [4]
        prof = j["profile"]
        assert set(prof) >= {"backend", "total_us", "phases_us", "bytes",
                             "roofline"}
        assert prof["total_us"] > 0
        assert {"parse", "plan"} <= set(prof["phases_us"])
        assert set(prof["roofline"]) >= {"engine", "bytes_touched",
                                         "achieved_bytes_per_s",
                                         "fraction_of_peak"}

    def test_no_section_without_param(self, env, pkg):
        _, h = env
        _seed(h, rows=1, slices=2)
        r = h.handle("POST", "/index/i/query",
                     body=b"Count(Bitmap(rowID=0, frame=f))")
        assert "profile" not in r.json()

    def test_phases_cover_90_percent_on_cpu(self, env, pkg):
        """Measured phases sum to >= 90% of the profile's total, on one
        of the warm queries (the first clean sample is the claim)."""
        _, h = env
        _seed(h, rows=12, slices=32)
        h.handle("POST", "/index/i/query",
                 body=b"Count(Bitmap(rowID=0, frame=f))",
                 params={"profile": "true"})
        covs = []
        for row in range(1, 12):
            r = h.handle("POST", "/index/i/query",
                         body=f"Count(Bitmap(rowID={row}, frame=f))".encode(),
                         params={"profile": "true"})
            prof = r.json()["profile"]
            covs.append(sum(prof["phases_us"].values()) / prof["total_us"])
            if covs[-1] >= 0.90:
                break
        assert max(covs) >= 0.90, f"coverage {covs}"

    def test_cpu_roofline_is_the_host_rate(self, env, pkg):
        """On the CPU the roofline reads the measured host rate (or
        nothing), never a TPU's or another card's peak."""
        _, h = env
        _seed(h, rows=2, slices=4)
        r = h.handle("POST", "/index/i/query",
                     body=b"Count(Intersect(Bitmap(rowID=0, frame=f), "
                          b"Bitmap(rowID=1, frame=f)))",
                     params={"profile": "true"})
        rf = r.json()["profile"]["roofline"]
        assert rf.get("peak_bytes_per_s") not in (819e9, 1228e9, 2039e9)
        if pkg.name == "torch":
            assert r.json()["profile"]["backend"] == "cpu"
            assert rf["engine"] == "device"  # the plain versions ran
            # K3 reads each leaf's one container a slice and its index
            # row (16 int32 a slice): 2 leaves x 4 slices.
            assert rf["bytes_touched"] == 2 * 4 * (2048 * 4 + 16 * 4)
            assert rf["peak_bytes_per_s"] in (
                None, round(port_profile.peak_bytes_per_s("cpu"), 1))

    def test_metrics_export_after_profiled_query(self, env, pkg):
        _, h = env
        _seed(h, rows=1, slices=4)
        h.handle("POST", "/index/i/query",
                 body=b"Count(Bitmap(rowID=0, frame=f))",
                 params={"profile": "true"})
        body = h.handle("GET", "/metrics").body.decode()
        assert "pilosa_query_phase_us_bucket" in body
        assert 'phase="parse"' in body


class TestSampling:
    def _phase_count(self, pkg):
        phases, _ = pkg.profile.STATS.snapshot()
        return sum(hist.total for hist in phases.values())

    def test_one_in_n_records_without_response_section(self, env, pkg):
        _, h = env
        _seed(h, rows=1, slices=2)
        h.profile_sample_rate = 2
        before = self._phase_count(pkg)
        for _ in range(4):
            r = h.handle("POST", "/index/i/query",
                         body=b"Count(Bitmap(rowID=0, frame=f))")
            assert "profile" not in r.json()
        assert self._phase_count(pkg) - before >= 4

    def test_rate_zero_never_samples(self, env, pkg):
        _, h = env
        _seed(h, rows=1, slices=2)
        assert h.profile_sample_rate == 0
        before = self._phase_count(pkg)
        for _ in range(3):
            h.handle("POST", "/index/i/query",
                     body=b"Count(Bitmap(rowID=0, frame=f))")
        assert self._phase_count(pkg) == before

    def test_server_wires_obs(self, tmp_path):
        """Port only: [obs] sizes the port Server's tracer, sample rate
        and flight ring."""
        c = Config.from_toml(
            '[obs]\nslow-query-threshold = "2ms"\ntrace-ring = 4\n'
            'profile-sample-rate = 16\nqueryshape-ring = 7\n',
            is_text=True)
        c.data_dir = str(tmp_path / "d")
        c.use_device = "off"
        s = Server(c)
        try:
            assert s.tracer.slow_us == 2000.0
            assert s.handler.tracer is s.tracer
            assert s.tracer._recent.maxlen == 4
            assert s.handler.profile_sample_rate == 16
            assert s.executor.flight.ring == 7
        finally:
            s.close()


def _recordings(seed: int, n: int = 400):
    rng = np.random.default_rng(seed)
    sigs = [f"Count(Bitmap[f{k}])" for k in range(40)]
    routes = ["mesh", "host-fold", "roaring", "bsi-host"]
    out = []
    for _ in range(n):
        out.append((sigs[int(rng.integers(len(sigs)))],
                    routes[int(rng.integers(len(routes)))],
                    ["local", "ici"][int(rng.integers(2))],
                    float(rng.integers(1, 1 << 20)),
                    int(rng.integers(0, 4096)), bool(rng.integers(2)),
                    bool(rng.integers(2)) and bool(rng.integers(2))))
    return out


def _flight_snapshot(mod, recs, ring, sort, limit):
    fr = mod.FlightRecorder(ring=ring)
    for sig, route, tier, lat, staged, checked, mismatch in recs:
        fr.record(sig, route, tier, lat, staged_bytes=staged,
                  shadow_checked=checked, shadow_mismatch=mismatch,
                  example=lambda sig=sig: sig.lower())
    snap = fr.snapshot(sort=sort, limit=limit)
    for row in snap["top"]:
        row.pop("first_seen")
        row.pop("last_seen")
    return snap, fr.stats()


class TestFlightRecorder:
    @pytest.mark.parametrize("sort", ["cost", "p99", "routed_host",
                                      "count"])
    @pytest.mark.parametrize("ring", [8, 256])
    def test_snapshot_equals_the_jax_package(self, sort, ring):
        recs = _recordings(seed=ring)
        want = _flight_snapshot(PKGS["jax"].flight, recs, ring, sort, 50)
        got = _flight_snapshot(PKGS["torch"].flight, recs, ring, sort, 50)
        assert got == want
        if ring == 8:
            assert got[1]["evicted"] > 0

    def test_bad_sort_raises(self, pkg):
        with pytest.raises(ValueError):
            pkg.flight.FlightRecorder().snapshot(sort="nope")


# Every call the port serves, in each argument form its tests use.
SERVED_PQL = [
    "Bitmap(rowID=1, frame=f)",
    "Bitmap(columnID=3, frame=f)",
    "Count(Bitmap(rowID=1, frame=f))",
    "Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=g)))",
    "Count(Union(Bitmap(rowID=1), Bitmap(rowID=2), Bitmap(rowID=3)))",
    "Count(Difference(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f)))",
    "Count(Intersect(Union(Bitmap(rowID=1, frame=a), Bitmap(rowID=2, "
    "frame=b)), Difference(Bitmap(rowID=3, frame=a), Bitmap(rowID=4, "
    "frame=b))))",
    'Count(Range(rowID=1, frame=t, start="2017-04-01T00:00", '
    'end="2017-04-08T00:00"))',
    "Count(Range(frame=f, val > 10))",
    "Count(Range(frame=f, val >< [-5, 5]))",
    'Range(rowID=1, frame=t, start="2017-04-01T00:00", '
    'end="2017-04-02T00:00")',
    "SetBit(rowID=1, frame=f, columnID=7)",
    'SetBit(rowID=1, frame=t, columnID=7, timestamp="2017-04-02T09:00")',
    "ClearBit(rowID=1, frame=f, columnID=7)",
    "SetValue(frame=f, columnID=3, val=-4)",
    'Sum(frame=f, field="val")',
    'Sum(Bitmap(rowID=1, frame=g), frame=f, field="val")',
    'Min(frame=f, field="val")',
    'Max(Bitmap(rowID=1, frame=g), frame=f, field="val")',
    "TopN(frame=f, n=10)",
    "TopN(Bitmap(rowID=1, frame=g), frame=f, n=5, threshold=2)",
    'TopN(frame=f, n=3, ids=[1, 2, 3], field="k", filters=["a", "b"])',
    "TopN(Bitmap(rowID=1, frame=f), frame=f, tanimotoThreshold=50)",
    'SetRowAttrs(frame=f, rowID=1, k="v", n=2)',
    'SetColumnAttrs(columnID=4, k="v")',
]


class TestShapeSig:
    @pytest.mark.parametrize("pql", SERVED_PQL)
    def test_shape_sig_equals_the_jax_package(self, pql):
        jq, pq = jax_parse(pql), port_parse(pql)
        assert len(jq.calls) == len(pq.calls) == 1
        want = PKGS["jax"].executor.Executor._shape_sig(jq.calls[0])
        got = PKGS["torch"].executor.Executor._shape_sig(pq.calls[0])
        assert got == want
        assert "rowID" not in got and "7" not in got

    def test_ids_elided(self, pkg):
        parse = jax_parse if pkg.name == "jax" else port_parse
        a = parse("Count(Intersect(Bitmap(rowID=1, frame=f), "
                  "Bitmap(rowID=2, frame=f)))").calls[0]
        b = parse("Count(Intersect(Bitmap(rowID=8, frame=f), "
                  "Bitmap(rowID=9, frame=f)))").calls[0]
        sig = pkg.executor.Executor._shape_sig
        assert sig(a) == sig(b) == \
            "Count(Intersect(Bitmap[f],Bitmap[f]))"

    def test_queryshapes_count_the_stream(self, env, pkg):
        _, h = env
        _seed(h, rows=3, slices=2)
        for a, b in ((0, 1), (1, 2), (0, 2)):
            h.handle("POST", "/index/i/query",
                     body=f"Count(Intersect(Bitmap(rowID={a}, frame=f), "
                          f"Bitmap(rowID={b}, frame=f)))".encode())
        doc = h.handle("GET", "/debug/queryshapes",
                       params={"sort": "count"}).json()
        rows = {r["signature"]: r["count"] for r in doc["top"]}
        assert rows["Count(Intersect(Bitmap[f],Bitmap[f]))"] == 3


class TestCtlTop:
    SCRAPE = """\
# HELP pilosa_query_us histogram
pilosa_uptime_seconds 120
pilosa_query_us_count 50
pilosa_query_phase_us_bucket{phase="parse",backend="cpu",le="64"} 40
pilosa_query_phase_us_bucket{phase="parse",backend="cpu",le="128"} 95
pilosa_query_phase_us_bucket{phase="parse",backend="cpu",le="+Inf"} 100
pilosa_roofline_fraction{backend="cpu"} 0.125
pilosa_roofline_bytes_per_second{backend="cpu"} 2.5e9
pilosa_hbm_resident_bytes{device="dev0"} 2097152
"""

    def test_parse_prom(self, pkg):
        m = pkg.ctl._parse_prom(self.SCRAPE)
        assert m[("pilosa_query_us_count", ())] == 50
        assert m[("pilosa_roofline_fraction",
                  (("backend", "cpu"),))] == 0.125
        key = ("pilosa_query_phase_us_bucket",
               (("backend", "cpu"), ("le", "+Inf"), ("phase", "parse")))
        assert m[key] == 100

    def test_percentiles_from_cumulative_buckets(self, pkg):
        m = pkg.ctl._parse_prom(self.SCRAPE)
        p50, p95, p99, n = pkg.ctl._hist_percentiles(
            m, "pilosa_query_phase_us", {"phase": "parse",
                                         "backend": "cpu"})
        assert (p50, p95, p99, n) == (128, 128, float("inf"), 100)

    def test_render_top_one_screen(self, pkg):
        cur = pkg.ctl._parse_prom(self.SCRAPE)
        prev = {("pilosa_query_us_count", ()): 30.0}
        out = pkg.ctl.render_top("127.0.0.1:1", cur, prev, 2.0)
        assert "qps 10.0" in out
        assert "parse" in out and "p95" in out
        assert "roofline cpu: 0.125" in out
        assert "hbm resident: 2.0MiB" in out
        # The panel below the title line is the JAX ctl's, line for line.
        jax = PKGS["jax"].ctl
        assert out.splitlines()[1:] == jax.render_top(
            "127.0.0.1:1", jax._parse_prom(self.SCRAPE), prev,
            2.0).splitlines()[1:]

    def test_render_top_empty_scrape(self, pkg):
        out = pkg.ctl.render_top("h:1", {}, {}, 0.0)
        assert "no profiled queries yet" in out

    def test_parser_equals_the_jax_package_on_a_live_scrape(self, env,
                                                           pkg):
        _, h = env
        _seed(h, rows=2, slices=2)
        h.handle("POST", "/index/i/query",
                 body=b"Count(Bitmap(rowID=0, frame=f))",
                 params={"profile": "true"})
        text = h.handle("GET", "/metrics",
                        params={"exemplars": "true"}).body.decode()
        assert pkg.ctl._parse_prom(text) == \
            PKGS["jax"].ctl._parse_prom(text)


def test_port_profile_times_the_wait_of_a_batched_count(tmp_path):
    """A batched request's device_exec is its wait on the batch thread
    (the JAX package's reading): a profiled Count that queues behind
    another gets a device_exec phase and its own leaves' bytes."""
    from pilosa_tpu_torch.obs import profile

    holder, h = PKGS["torch"].make_handler(tmp_path / "d")
    try:
        _seed(h, rows=2, slices=2)
        h.handle("POST", "/index/i/query",
                 body=b"Count(Bitmap(rowID=0, frame=f))")  # stages
        mgr = h.executor.mesh_manager()
        gate = threading.Event()
        orig = mgr._run_count_group

        def slow_group(group):
            gate.wait(5)
            return orig(group)

        mgr._run_count_group = slow_group
        t = threading.Thread(target=h.handle, args=(
            "POST", "/index/i/query", {}, {},
            b"Count(Bitmap(rowID=1, frame=f))"))
        t.start()
        deadline = time.monotonic() + 5
        while mgr._counts_inflight < 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        threading.Timer(0.05, gate.set).start()
        r = h.handle("POST", "/index/i/query",
                     body=b"Count(Intersect(Bitmap(rowID=0, frame=f), "
                          b"Bitmap(rowID=1, frame=f)))",
                     params={"profile": "true"})
        t.join(5)
        prof = r.json()["profile"]
        assert prof["phases_us"]["device_exec"] > 0
        assert any(s.get("engine") == "device_batched"
                   for s in prof.get("slices", []))
        # Its own two leaves, one container and one index row a slice.
        assert prof["bytes"]["bytes_touched_hbm"] == 2 * 2 * (2048 * 4
                                                              + 16 * 4)
    finally:
        mgr._run_count_group = orig
        holder.close()
        profile.STATS._phase.clear()


def test_port_dense_pair_touches_whole_runs(tmp_path):
    """Rows holding all 16 containers of every slice are whole runs: a
    profiled pair runs K1 (coarse_count_uniform) and its
    bytes_touched_hbm is what K1 reads, 2 leaves x slices x one 16 x
    2048-word run (at 960 slices, the 251.6 MB behind K1's bound)."""
    holder, h = PKGS["torch"].make_handler(tmp_path / "d")
    try:
        assert h.handle("POST", "/index/i").status == 200
        assert h.handle("POST", "/index/i/frame/f").status == 200
        for row in range(2):
            q = "".join(f"SetBit(rowID={row}, frame=f, columnID="
                        f"{s * SLICE_WIDTH + b * 65536 + row})"
                        for s in range(3) for b in range(16))
            assert h.handle("POST", "/index/i/query",
                            body=q.encode()).status == 200
        r = h.handle("POST", "/index/i/query",
                     body=b"Count(Union(Bitmap(rowID=0, frame=f), "
                          b"Bitmap(rowID=1, frame=f)))",
                     params={"profile": "true"})
        prof = r.json()["profile"]
        assert r.json()["results"] == [96]
        assert prof["slices"][0]["kernel"] == "coarse_count_uniform"
        assert prof["bytes"]["bytes_touched_hbm"] == 2 * 3 * 16 * 2048 * 4
        assert {"parse", "plan", "stage_h2d", "device_exec",
                "readback_d2h"} <= set(prof["phases_us"])
    finally:
        holder.close()


def test_port_device_scope_names_the_launch(tmp_path, monkeypatch):
    """With $PILOSA_TORCH_DEVICE_SCOPES on, a Count's launch sits in a
    torch.profiler range under the JAX package's name
    (pilosa:count_fused); off (the default), device_scope is the shared
    nullcontext."""
    import torch

    from pilosa_tpu_torch.obs import trace

    monkeypatch.setattr(trace, "_SCOPES", None)
    monkeypatch.delenv(trace.SCOPES_ENV, raising=False)
    assert trace.device_scope("x") is trace._NULL
    monkeypatch.setattr(trace, "_SCOPES", None)
    monkeypatch.setenv(trace.SCOPES_ENV, "1")
    holder, h = PKGS["torch"].make_handler(tmp_path / "d")
    try:
        _seed(h, rows=2, slices=2)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            r = h.handle("POST", "/index/i/query",
                         body=b"Count(Intersect(Bitmap(rowID=0, frame=f), "
                              b"Bitmap(rowID=1, frame=f)))")
        assert r.status == 200
        names = {e.key for e in prof.key_averages()}
        assert {"pilosa:count_fused", "pilosa:h2d_stage"} <= names
    finally:
        holder.close()
        monkeypatch.setattr(trace, "_SCOPES", None)
