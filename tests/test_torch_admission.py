"""Admission and the query's own record through the port's handler and
Server, against the JAX handler.

One seeded stream of requests goes through a JAX handler and a port
handler on the CPU, each with a query scheduler (tenant weights gold =
4), an SLO recorder bounded to tenant gold, and the cost ledger: three
tenants, deadlines (expired on arrival: 504; generous: 200; ?deadline=
as a duration), ?profile=true, ?explain=true, a bad query, protobuf
imports, and sheds forced through the `sched.admit` seam (429 with the
seam's Retry-After). Equal between the two: every status and
Retry-After, the tenants whose answers carry X-Pilosa-Cost-Debt (only
gold's queries are profiled), the /debug/slo
outcome counts, the /debug/queryshapes signatures and counts, and the
family names, types and label names of the sched, slo, costs, profile
and health collectors at /metrics. Then the port alone: the Server acts
on [obs], [sched], [slo], [health] and [cluster] query-deadline (none
of them in NOT_ACTED_ON), closes its dispatcher and watchdog, serve()'s
handler has a tracer and an SLO recorder but no scheduler, and the
nine new routes answer.
"""

import re

import numpy as np
import pytest

from pilosa_tpu.wire import pilosa_pb2 as pb
from pilosa_tpu_torch.api.server import serve
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.server import NOT_ACTED_ON, Server
from torch_obs import PKGS, isolated_stores, pkg  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

SLICE_WIDTH = 1 << 20
COLLECTED = ("pilosa_sched_", "pilosa_query_outcome_total", "pilosa_slo_",
             "pilosa_cost_", "pilosa_perf_regression", "pilosa_query_phase_us",
             "pilosa_roofline_", "pilosa_health_", "pilosa_watchdog_",
             "pilosa_queryshape_")


def _import_body(seed: int, slice_: int) -> bytes:
    rng = np.random.default_rng(seed)
    n = 50
    rows = rng.integers(0, 4, n).tolist()
    cols = (slice_ * SLICE_WIDTH + rng.integers(0, SLICE_WIDTH, n)).tolist()
    return pb.ImportRequest(index="i", frame="f", slice=slice_,
                            row_ids=rows, column_ids=cols
                            ).SerializeToString()


def _stream(seed: int):
    """(method, path, params, headers, body, arm_shed) requests."""
    rng = np.random.default_rng(seed)
    out = [("POST", "/index/i", {}, {}, b"", False),
           ("POST", "/index/i/frame/f", {}, {}, b"", False)]
    for s in range(3):
        out.append(("POST", "/import", {}, {"X-Pilosa-Tenant": "gold"},
                    _import_body(seed + s, s), False))
    tenants = ["gold", "default", "rando"]
    for k in range(60):
        tenant = tenants[int(rng.integers(3))]
        a, b = (int(x) for x in rng.choice(4, 2, replace=False))
        op = ["Intersect", "Union", "Difference"][int(rng.integers(3))]
        body = (f"Count({op}(Bitmap(rowID={a}, frame=f), "
                f"Bitmap(rowID={b}, frame=f)))")
        if k % 9 == 4:
            body = f"Count(Bitmap(rowID={a}, frame=f))"
        if k % 13 == 7:
            body = f"SetBit(rowID={a}, frame=f, columnID={k * 1000 + b})"
        headers = {"X-Pilosa-Tenant": tenant}
        params = {}
        roll = int(rng.integers(10))
        if roll == 0:
            headers["X-Pilosa-Deadline-Us"] = "0"  # expired: 504
        elif roll == 1:
            headers["X-Pilosa-Deadline-Us"] = "30000000"
        elif roll == 2:
            params["deadline"] = "1h"
        elif roll == 3 and tenant == "gold":
            params["profile"] = "true"
        elif roll == 4:
            params["explain"] = "true"
        if k % 17 == 11:
            body = "Count(Nope("
        out.append(("POST", "/index/i/query", params, headers,
                    body.encode(), k % 11 == 5))
    return out


def _drive(p, tmp_path, seed, monkeypatch):
    monkeypatch.setattr(p.costs.CostLedger, "MIN_SHARE_SAMPLES", 0)
    holder, h = p.make_handler(tmp_path / p.name)
    h.scheduler = p.sched.QueryScheduler(tenant_weights={"gold": 4.0})
    h.slo = p.slo.SLORecorder(tenants=["gold"],
                              mismatch_source=lambda: 0.0)
    h.cost_debt_threshold = 0.5
    p.health.HEALTH.register("wal", interval=None, critical=True)
    got, debts = [], set()
    try:
        for method, path, params, headers, body, shed in _stream(seed):
            if shed:
                p.fault.arm("sched.admit", times=1,
                            error=p.sched.AdmissionError(
                                "forced shed", 3.0, "queue_full"))
            r = h.handle(method, path, params, headers, body)
            p.fault.reset()
            got.append((r.status, r.headers.get("Retry-After")))
            if "X-Pilosa-Cost-Debt" in r.headers:
                debts.add(headers.get("X-Pilosa-Tenant"))
        slo = h.handle("GET", "/debug/slo").json()
        shapes = {row["signature"]: row["count"] for row in h.handle(
            "GET", "/debug/queryshapes", {"limit": "100"}).json()["top"]}
        text = h.handle("GET", "/metrics").body.decode()
        sched = h.handle("GET", "/debug/vars").json()["sched"]
    finally:
        h.scheduler.close()
        holder.close()
    return got, slo, shapes, _families(text), sched, debts


def _families(text: str) -> dict:
    """{family: (type, {label-name tuples})} of the collectors compared."""
    types, labels = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ", 3)
            if name.startswith(COLLECTED):
                types[name] = mtype
                labels[name] = set()
        elif line and not line.startswith("#"):
            name = re.split(r"[{ ]", line, maxsplit=1)[0]
            fam = name if name in types else re.sub(
                r"_(bucket|sum|count)$", "", name)
            if fam in types:
                names = tuple(sorted(re.findall(r'(\w+)="', line)))
                labels[fam].add(names)
    return {n: (types[n], labels[n]) for n in types}


@pytest.mark.parametrize("seed", [3, 5])
def test_one_stream_through_both_handlers(tmp_path, seed, monkeypatch):
    want = _drive(PKGS["jax"], tmp_path, seed, monkeypatch)
    got = _drive(PKGS["torch"], tmp_path, seed, monkeypatch)
    statuses = [s for s, _ in got[0]]
    assert {200, 400, 429, 504} <= set(statuses)
    assert got[0] == want[0]
    assert got[1]["outcome_totals"] == want[1]["outcome_totals"]
    assert got[1]["objectives"].keys() == want[1]["objectives"].keys()
    assert got[2] == want[2]
    # The port stages and profiles on its device (the CPU here), the
    # JAX executor folds on the host: only the port's stream has staged
    # bytes, HBM byte-seconds and a device roofline.
    both = got[3].keys() & want[3].keys()
    assert {n: got[3][n] for n in both} == {n: want[3][n] for n in both}
    assert set(want[3]) <= set(got[3])
    assert set(got[3]) - set(want[3]) <= {
        "pilosa_cost_hbm_byte_seconds_total",
        "pilosa_cost_staged_bytes_total", "pilosa_roofline_fraction",
        "pilosa_roofline_bytes_per_second"}
    assert {"pilosa_sched_queue_depth", "pilosa_query_outcome_total",
            "pilosa_slo_burn_rate", "pilosa_cost_queries_total",
            "pilosa_query_phase_us", "pilosa_health_state",
            "pilosa_watchdog_sweeps_total"} <= set(got[3])
    assert got[4].keys() == want[4].keys()
    # The forced sheds answer the seam's Retry-After; the gold imports
    # are counted under route "import".
    assert ("429", "3") in {(str(s), ra) for s, ra in got[0]}
    # Only gold's queries are profiled: its share of the device time is
    # 1, over the 0.5 threshold, so only its answers carry the debt.
    assert got[5] == want[5] == {"gold"}
    assert got[1]["outcome_totals"]["import:ok:gold"] == 3


def _collector_families(p, tmp_path) -> dict:
    """Every family of the five collectors, each fed the same inputs."""
    led = p.costs.CostLedger(clock=lambda: 5.0)
    for dim in p.costs.DIMENSIONS:
        led.charge(dim, 9.0, tenant="gold", shape="s")
    led.charge("wal_bytes", 1.0)
    watch = p.costs.BaselineWatch(min_n=2)
    for lat in (100.0, 100.0, 900.0, 900.0, 900.0):
        watch.observe("s", "cpu", "local", lat, bytes_per_s=1e9)
    stats = p.profile.ProfileStats()
    prof = p.profile.QueryProfile(backend="cpu")
    prof.tenant = "gold"
    prof.add_phase_ns("device_exec", 10_000)
    prof.add_bytes("bytes_touched_hbm", 1 << 20)
    stats.record(prof)
    rec = p.slo.SLORecorder(tenants=["gold"], mismatch_source=lambda: 0.0)
    rec.record("ok", tenant="gold", latency_us=10.0, trace_id="ab")
    rec.record("shed", tenant="x")
    p.health.HEALTH.register("wal", interval=None, critical=True)
    p.health.HEALTH.register("loop", interval=0.001)
    import time
    p.health.HEALTH.sweep(now=time.monotonic() + 10)
    holder, h = p.make_handler(tmp_path / p.name)
    try:
        h.scheduler = p.sched.QueryScheduler()
        sched = h._collect_sched()
        h.scheduler.close()
    finally:
        holder.close()
    fams = (led.families() + watch.families() + stats.families()
            + rec.families() + p.health.families() + sched)
    return {f.name: (f.mtype, sorted({tuple(sorted(k for k, _ in s_[1]))
                                      for s_ in f.samples}))
            for f in fams}


def test_collector_families_equal_the_jax_handlers(tmp_path):
    want = _collector_families(PKGS["jax"], tmp_path)
    got = _collector_families(PKGS["torch"], tmp_path)
    assert got == want
    assert len(got) >= 25


def test_explain_carries_the_cost_block(tmp_path, pkg):
    holder, h = pkg.make_handler(tmp_path / "d")
    try:
        assert h.handle("POST", "/index/i").status == 200
        assert h.handle("POST", "/index/i/frame/f").status == 200
        q = b"Count(Bitmap(rowID=0, frame=f))"
        assert h.handle("POST", "/index/i/query", {}, {}, q).status == 200
        r = h.handle("POST", "/index/i/query", {"explain": "true"}, {}, q)
        cost = r.json()["cost"]
        assert cost["shape"] == "Count(Bitmap[f])"
        assert cost["tenant"] == "default"
        assert cost["account"]["queries"] == 1
        assert cost["regressed"] == []
    finally:
        holder.close()


class TestPortServer:
    TOML = ('[sched]\nqueue-depth = 16\nmax-window-us = 1000\n'
            '[sched.tenant-weights]\ngold = 4\n'
            '[obs]\nprofile-sample-rate = 10\ncost-debt-threshold = 0.4\n'
            '[slo]\navailability = 99.5\n'
            '[health]\nsweep-interval = "10ms"\nstall-after = 4\n'
            '[cluster]\nquery-deadline = "2s"\n')

    def test_not_acted_on_no_longer_names_them(self):
        text = " ".join(NOT_ACTED_ON)
        for section in ("[sched]", "[slo]", "[health]",
                        "query-deadline", "[obs] but"):
            assert section not in text

    def test_server_acts_on_the_sections(self, tmp_path):
        c = Config.from_toml(self.TOML, is_text=True)
        c.data_dir = str(tmp_path / "d")
        c.host = "127.0.0.1:0"
        c.use_device = "off"
        s = Server(c)
        s.open(port=0)
        h = s.handler
        try:
            assert s.scheduler is h.scheduler
            assert s.scheduler.queue_depth == 16
            assert s.scheduler.max_window_us == 1000.0
            assert s.scheduler.tenant_weights == {"gold": 4.0}
            assert s.scheduler.estimator == s.executor.estimate_service_us
            assert s.scheduler.on_release == s.executor.burst_hint
            assert h.profile_sample_rate == 10
            assert h.cost_debt_threshold == 0.4
            assert h.default_deadline == 2.0
            assert h.slo.objectives["availability"] == 99.5
            assert h.slo.tenant_label("gold") == "gold"
            assert h.slo.tenant_label("x") == "other"
            assert h.handle("POST", "/index/i").status == 200
            assert h.handle("POST", "/index/i/frame/f").status == 200
            r = h.handle("POST", "/index/i/query", {},
                         {"X-Pilosa-Tenant": "gold"},
                         b"Count(Bitmap(rowID=0, frame=f))")
            assert r.status == 200
            assert s.scheduler.stats["fastpath"] >= 1
            assert h.handle("GET", "/readyz").status == 200
            dispatcher = s.scheduler
        finally:
            s.close()
        assert dispatcher._closed
        assert h.handle("GET", "/readyz").status == 503

    def test_sections_disabled(self, tmp_path):
        c = Config.from_toml(
            '[sched]\nenabled = false\n[slo]\nenabled = false\n'
            '[health]\nenabled = false\n[obs]\ncost-ledger = false\n',
            is_text=True)
        c.data_dir = str(tmp_path / "d")
        c.use_device = "off"
        s = Server(c)
        try:
            assert s.scheduler is None and s.handler.scheduler is None
            assert s.handler.slo is None
            assert PKGS["torch"].health.HEALTH.enabled is False
            assert PKGS["torch"].costs.LEDGER.enabled is False
        finally:
            s.close()

    def test_serve_has_the_jax_handler_defaults(self, tmp_path):
        holder = Holder(str(tmp_path / "d"))
        holder.open()
        srv = serve(holder, device="cpu")
        try:
            h = srv.handler
            assert h.scheduler is None
            assert h.tracer is not None and h.slo is not None
            assert h.profile_sample_rate == 0
        finally:
            srv.close()
            holder.close()

    @pytest.mark.parametrize("path", [
        "/healthz", "/readyz", "/debug/health", "/debug/bundle",
        "/debug/slo", "/debug/costs", "/debug/queries",
        "/debug/queryshapes", "/debug/traces/{tid}"])
    def test_the_nine_routes_answer(self, tmp_path, path):
        holder, h = PKGS["torch"].make_handler(tmp_path / "d")
        try:
            assert h.handle("POST", "/index/i").status == 200
            tid = h.handle("GET", "/debug/queries").json()["recent"]
            assert tid == []
            assert h.handle("POST", "/index/i/query", {}, {},
                            b"Count(Bitmap(rowID=0))").status == 400
            tid = h.handle("GET", "/debug/queries").json()["recent"][0]["id"]
            r = h.handle("GET", path.format(tid=tid))
            assert r.status == 200
            assert isinstance(r.json(), dict)
            assert h.handle("POST", path.format(tid=tid)).status == 405
        finally:
            holder.close()


def test_ctl_panels_against_a_port_node(tmp_path, capsys):
    """`ctl top`, `costs` and `health -n 1` and `diagnose -o FILE`
    against a port node on the CPU exit 0, and each panel below its
    title line equals the JAX ctl's against the same node (numbers
    aside: ages and byte-seconds move between the two scrapes)."""
    import json

    jax_ctl, port_ctl = PKGS["jax"].ctl, PKGS["torch"].ctl
    c = Config.from_toml('[health]\nsweep-interval = "10ms"\n',
                         is_text=True)
    c.data_dir = str(tmp_path / "d")
    c.host = "127.0.0.1:0"
    c.use_device = "off"
    s = Server(c)
    s.open(port=0)
    try:
        h = s.handler
        assert h.handle("POST", "/index/i").status == 200
        assert h.handle("POST", "/index/i/frame/f").status == 200
        h.handle("POST", "/index/i/query", {"profile": "true"},
                 {"X-Pilosa-Tenant": "gold"},
                 b"Count(Bitmap(rowID=0, frame=f))")
        for argv in (["costs", "-n", "1"], ["health", "-n", "1"]):
            argv = argv + ["--host", s.host]
            rc, got = port_ctl.main(argv), capsys.readouterr().out
            assert rc == 0 and got
            rc, want = jax_ctl.main(argv), capsys.readouterr().out
            assert rc == 0
            # Ages and byte-seconds move between the two scrapes.
            strip = [re.sub(r"[0-9][0-9.]*", "N", ln)
                     for ln in got.splitlines()[1:]]
            assert strip == [re.sub(r"[0-9][0-9.]*", "N", ln)
                             for ln in want.splitlines()[1:]]
        rc = port_ctl.main(["top", "-n", "1", "--host", s.host])
        assert rc == 0 and "uptime" in capsys.readouterr().out
        out = tmp_path / "dossier.json"
        assert port_ctl.main(["diagnose", "--host", s.host, "-o",
                              str(out)]) == 0
        doc = json.loads(out.read_text())
        assert doc["schema"] == "pilosa-tpu/dossier/v1"
        assert doc["reason"] == "on-demand"
        assert "slo" in doc["sections"]
    finally:
        s.close()
