"""The load generator (pilosa_tpu_torch/tools/loadgen.py, `ctl loadgen`),
fault.log() and the watchdog.stall seam against the JAX package's.

Equal, exactly: `--print-schedule` byte for byte over seeds, every op of
the mix, the three burst curves and a warmup (through both ctls too);
run() on StubTransport (report keys, counts, per-op and per-tenant
tallies, verdicts; latencies are not compared); a real in-process run
against a port server on the CPU and against a JAX server (verdict OK,
no mismatch growth, the same request counts), with --fault device.exec
and --fault watchdog.stall fired and judged in both packages. The
cluster flags route as in the JAX tool: with --cluster-nodes to an
in-process cluster of that many nodes and replicas, without it to the
one-node transport with the same ?partial= and X-Pilosa-Staleness
(cluster runs themselves: tests/test_torch_loadgen_cluster.py). A
watchdog.stall delay on a
`scrub` heartbeat trips each package's watchdog and recovers, and
fault.log() records the same fired faults in both.
"""

import json
import os
import random
import sys
import tempfile
import threading
import time

import pytest

import pilosa_tpu.ctl.main as jax_ctl
from pilosa_tpu_torch.ctl import main as port_ctl
from pilosa_tpu_torch.tools import loadgen as port_lg
from torch_obs import PKGS, isolated_stores, pkg  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from tools import loadgen as jax_lg  # noqa: E402

ALL_OPS = ("read=0.25,write=0.15,topn=0.1,range=0.1,bsi_sum=0.1,"
           "bsi_range=0.15,zipf_read=0.15")
# A latency bound no CPU run misses: the CPU's latencies are not judged.
LOOSE = ["--p99-us", "600000000"]


def schedule(mod, argv, capsys) -> str:
    assert mod.main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("seed", [1, 2, 3, 7, 42, 1234])
@pytest.mark.parametrize("burst", ["none", "diurnal", "spike"])
def test_print_schedule_is_byte_identical(seed, burst, capsys):
    argv = ["--print-schedule", "--seed", str(seed), "--burst", burst,
            "--mix", ALL_OPS, "--duration", "3", "--qps", "40",
            "--warmup", "0.5", "--rows", "9", "--columns", "5000",
            "--tenants", "gold,silver,bronze,tin", "--zipf-s", "0.9",
            "--frame", "general"]
    port = schedule(port_lg, argv, capsys)
    assert port == schedule(jax_lg, argv, capsys)
    entries = [json.loads(line) for line in port.splitlines()]
    assert {e["op"] for e in entries} == {
        "read", "write", "topn", "range", "bsi_sum", "bsi_range",
        "zipf_read"}
    assert entries[0]["phase"] == "warmup" and entries[-1]["phase"] == "run"


def test_ctl_loadgen_routes_before_argparse(capsys):
    argv = ["loadgen", "--print-schedule", "--seed", "5", "--duration", "1",
            "--mix", ALL_OPS, "--warmup", "1"]
    port = schedule(port_ctl, argv, capsys)
    assert port and port == schedule(jax_ctl, argv, capsys)


def test_parser_keeps_the_jax_options():
    def options(parser):
        return [a.option_strings for a in parser._actions]

    assert options(port_lg.make_parser()) == options(jax_lg.make_parser())


@pytest.mark.parametrize("text", ["read=1", "read=0.65,write=0.2,topn=0.15",
                                  ALL_OPS, " read = 2 , , write=1"])
def test_mix_and_curves_equal(text):
    assert port_lg.parse_mix(text) == jax_lg.parse_mix(text)
    for n, s in ((1, 1.1), (8, 1.1), (64, 0.7)):
        assert port_lg.zipf_cdf(n, s) == jax_lg.zipf_cdf(n, s)
    for curve in ("none", "diurnal", "spike"):
        for frac in (0.0, 0.25, 0.45, 0.5, 0.549, 0.55, 0.9):
            assert port_lg.burst_factor(curve, frac) == \
                jax_lg.burst_factor(curve, frac)
    vals = [float(v) for v in range(1, 101)]
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert port_lg.percentile(vals, q) == jax_lg.percentile(vals, q)


@pytest.mark.parametrize("bad", ["bogus=1", "read=0"])
def test_mix_errors_equal(bad):
    with pytest.raises(ValueError) as a:
        port_lg.parse_mix(bad)
    with pytest.raises(ValueError) as b:
        jax_lg.parse_mix(bad)
    assert str(a.value) == str(b.value)


def status_of(entry):
    """A deterministic answer a request: every outcome the tally knows."""
    k = entry["i"] % 23
    return {0: (429, False), 1: (504, False), 2: (503, False),
            3: (500, False), 4: (400, False), 5: (200, True),
            6: (599, False)}.get(k, (200, False))


def stub_report(mod, spec, fn):
    stub = mod.StubTransport(fn)
    report = mod.run(dict(spec), stub)
    return report, sorted(e["i"] for e in stub.entries)


def comparable(report) -> dict:
    """The report without its timings: wall seconds, the achieved rate,
    the latency percentiles and the latency objective's measure."""
    out = json.loads(json.dumps(report))
    out.pop("wall_s")
    out.pop("achieved_qps")
    for row in out["per_tenant"].values():
        for k in ("p50_us", "p95_us", "p99_us"):
            row.pop(k)
    out["objectives"]["latency"].pop("measured")
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("mode", ["closed", "open"])
@pytest.mark.parametrize("fn", [None, status_of], ids=["ok", "mixed"])
def test_stub_run_reports_equal(seed, mode, fn):
    args = port_lg.make_parser().parse_args(
        ["--seed", str(seed), "--mode", mode, "--duration", "1",
         "--qps", "300", "--warmup", "0.2", "--mix", ALL_OPS,
         "--concurrency", "3", *LOOSE])
    spec = port_lg.spec_from_args(args)
    assert spec == jax_lg.spec_from_args(
        jax_lg.make_parser().parse_args(
            ["--seed", str(seed), "--mode", mode, "--duration", "1",
             "--qps", "300", "--warmup", "0.2", "--mix", ALL_OPS,
             "--concurrency", "3", *LOOSE]))
    port, sent = stub_report(port_lg, spec, fn)
    jax, jsent = stub_report(jax_lg, spec, fn)
    assert sent == jsent == list(range(len(jax_lg.build_schedule(spec))))
    assert sorted(port) == sorted(jax)
    assert comparable(port) == comparable(jax)
    assert port["verdict"] == ("OK" if fn is None else "VIOLATED")


class _Reached(Exception):
    """Where a tool's main() went: the call that ends its set-up."""


def _route(mod, argv, monkeypatch, tmp_path) -> tuple:
    """(exit code or None, where main() went) for `argv`: the cluster's
    start and the transport are stubbed, and the first request path
    (prepare_index) stops the run, so nothing is served."""
    def cluster(spec, nodes, replicas, log):
        raise _Reached(("cluster", nodes, replicas))

    class Transport:
        def __init__(self, host, **kw):
            self.kw = dict(host=host, **kw)

    def prepare(host, index, frame, log, **kw):
        raise _Reached(("one node", seen[-1].kw))

    seen = []
    monkeypatch.setattr(mod, "start_inprocess_cluster", cluster)
    monkeypatch.setattr(mod, "HTTPTransport",
                        lambda host, **kw: seen.append(
                            Transport(host, **kw)) or seen[-1])
    monkeypatch.setattr(mod, "prepare_index", prepare)
    try:
        rc = mod.main([*argv, "--quiet",
                       "--report", str(tmp_path / "r.json")])
    except _Reached as e:
        return None, e.args[0]
    return rc, None


@pytest.mark.parametrize("argv", [
    ["--cluster-nodes", "3"], ["--cluster-replicas", "2"],
    ["--kill-replica-at", "0.3"], ["--restart-replica-at", "0.6"],
    ["--hint-backlog-max", "5"], ["--staleness-ms", "100"], ["--partial"],
    ["--cluster-nodes", "3", "--kill-replica-at", "0.2", "--partial"],
])
def test_cluster_flags_route_as_the_jax_tool(argv, monkeypatch, tmp_path):
    """Each flag set is accepted and reaches the same place with the
    same arguments in both tools: --cluster-nodes N boots N nodes at
    --cluster-replicas (3 by default), the others go to the one-node
    transport with the JAX tool's partial / staleness options."""
    port = _route(port_lg, argv, monkeypatch, tmp_path)
    jax = _route(jax_lg, argv, monkeypatch, tmp_path)
    assert port == jax
    rc, where = port
    assert rc is None
    if "--cluster-nodes" in argv:
        assert where == ("cluster", 3, 3)
    else:
        assert where[0] == "one node"
        assert where[1]["partial"] == ("--partial" in argv)
        assert where[1]["staleness_ms"] == (
            100.0 if "--staleness-ms" in argv else 0.0)


# -- real runs on the CPU, against a port server and a JAX server ---------------


@pytest.fixture
def cpu_servers(monkeypatch, tmp_path):
    """Both packages' in-process servers on the CPU; their data
    directories and the reports under tmp_path."""
    monkeypatch.setenv("PILOSA_TORCH_USE_DEVICE", "off")
    monkeypatch.delenv("PILOSA_TPU_USE_DEVICE", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def both_runs(tmp_path, argv, jax_env=None, monkeypatch=None):
    out = {}
    for name, mod in (("torch", port_lg), ("jax", jax_lg)):
        if name == "jax" and jax_env:
            for k, v in jax_env.items():
                monkeypatch.setenv(k, v)
        path = tmp_path / f"{name}.json"
        rc = mod.main([*argv, "--report", str(path), "--quiet"])
        out[name] = (rc, json.loads(path.read_text()))
    return out


def test_in_process_runs_match(cpu_servers):
    runs = both_runs(cpu_servers, [
        "--in-process", "--duration", "2", "--qps", "40", "--seed", "3",
        "--concurrency", "4", "--mix", "read=0.6,write=0.2,topn=0.2",
        *LOOSE])
    (prc, port), (jrc, jax) = runs["torch"], runs["jax"]
    assert prc == jrc == 0
    assert port["verdict"] == jax["verdict"] == "OK"
    assert port["mismatch_growth"] == jax["mismatch_growth"] == 0
    for k in ("requests_total", "requests_judged", "outcomes",
              "read_total", "read_5xx", "total_by_decile", "spec"):
        assert port[k] == jax[k], k
    assert port["outcomes"] == {"ok": port["requests_judged"]}
    assert {t: r["served"] for t, r in port["per_tenant"].items()} == \
        {t: r["served"] for t, r in jax["per_tenant"].items()}
    assert port["server_slo"]["verdict"] == jax["server_slo"]["verdict"]


def test_device_exec_fault_fires_and_is_judged(cpu_servers, monkeypatch):
    """Half of the card launches fail with an out-of-memory error from
    a quarter of the run on: the evict, retry and host-fold ladder
    answers every request, exactly (no mismatch growth). The JAX server
    runs its device path on the CPU for the seam to fire."""
    runs = both_runs(
        cpu_servers,
        ["--in-process", "--fault",
         "device.exec:error=ResourceExhausted,prob=.5", "--duration", "2",
         "--qps", "40", "--seed", "2", "--mix", "read=0.7,topn=0.3",
         *LOOSE],
        jax_env={"PILOSA_TPU_USE_DEVICE": "on"}, monkeypatch=monkeypatch)
    for name, (rc, rep) in runs.items():
        assert rc == 0 and rep["verdict"] == "OK", (name, rep["objectives"])
        assert rep["faults_fired"] > 0, name
        assert rep["mismatch_growth"] == 0, name
        assert rep["outcomes"] == {"ok": rep["requests_judged"]}, name
    assert runs["torch"][1]["requests_total"] == \
        runs["jax"][1]["requests_total"]


def test_watchdog_stall_is_detected_and_recovers(cpu_servers):
    runs = both_runs(cpu_servers, [
        "--in-process", "--fault", "watchdog.stall:delay=3s,subsystem=scrub",
        "--duration", "5", "--qps", "30", "--seed", "4",
        "--mix", "read=0.8,write=0.2", *LOOSE])
    for name, (rc, rep) in runs.items():
        obj = rep["objectives"]
        assert obj["watchdog_detection"]["verdict"] == "OK", name
        assert obj["watchdog_recovery"]["verdict"] == "OK", name
        assert rep["watchdog"]["trips_total"] >= 1, name
        assert rep["watchdog"]["stalled_at_end"] == [], name
        assert rep["faults_fired"] >= 1 and rc == 0, name
    assert set(runs["torch"][1]["objectives"]) == \
        set(runs["jax"][1]["objectives"])


# -- fault.log() and the watchdog.stall seam ------------------------------------


def test_fault_log_records_fired_faults(pkg):
    f = pkg.fault
    f.reset()
    f.arm("handler.query", delay=0.001, times=2, index="i")
    for idx in ("i", "j", "i", "i"):
        f.point("handler.query", index=idx, host="h")
    assert f.log() == [("handler.query", {"index": "i", "host": "h"})] * 2
    f.reset()
    assert f.log() == []


def test_watchdog_stall_seam_trips_and_recovers(pkg):
    """A delay armed at watchdog.stall for subsystem `scrub` wedges the
    loop inside beat(): its identity is stamped, its beat stays stale,
    the watchdog trips it and, once the delay clears, recovers it; a
    loop of another name beats on untouched."""
    reg = pkg.health.HEALTH
    reg.sweep_interval = 0.01
    reg.stall_after = 2.0
    hb = reg.register("scrub", interval=0.05)
    other = reg.register("cache-flush", interval=0.05)
    stop = threading.Event()

    def loop(h):
        while not stop.wait(0.01):
            h.beat()

    threads = [threading.Thread(target=loop, args=(h,), name=f"loop-{n}",
                                daemon=True)
               for n, h in (("scrub", hb), ("flush", other))]
    pkg.fault.arm("watchdog.stall", delay=0.6, times=1, subsystem="scrub")
    reg.start()
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5
        while reg.state_of("scrub") != pkg.health.STALLED:
            assert time.monotonic() < deadline, "no trip"
            time.sleep(0.005)
        assert hb.thread_name == "loop-scrub"
        assert reg.state_of("cache-flush") == pkg.health.OK
        deadline = time.monotonic() + 5
        while reg.state_of("scrub") != pkg.health.OK:
            assert time.monotonic() < deadline, "no recovery"
            time.sleep(0.005)
        doc = reg.snapshot()
        assert doc["trips_total"] == 1
        assert doc["subsystems"]["scrub"]["trips"] == 1
        assert pkg.fault.log() == [("watchdog.stall", {"subsystem": "scrub"})]
    finally:
        stop.set()
        for t in threads:
            t.join()
        reg.stop()
        reg.unregister("scrub")
        reg.unregister("cache-flush")


# -- the port stands alone --------------------------------------------------------

GUARDED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys
sys.path.insert(0, sys.argv[1])


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pilosa_tpu"):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Block())
import pilosa_tpu_torch

mods = [m.name for m in pkgutil.walk_packages(pilosa_tpu_torch.__path__,
                                              "pilosa_tpu_torch.")
        if not m.name.endswith(".__main__")]  # that one runs the ctl
for m in mods:
    importlib.import_module(m)
from pilosa_tpu_torch.tools import loadgen, metrics_lint

assert metrics_lint.lint(metrics_lint.live_scrape()) == []
assert loadgen.main(["--print-schedule", "--duration", "0.1"]) == 0
print("imported", len(mods))
"""


def test_every_module_imports_with_jax_blocked():
    """Every module of the port, the new tools and obs/fleet among them,
    imports and runs with `jax` and `pilosa_tpu` blocked at import."""
    import subprocess
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", GUARDED_IMPORT, str(repo)], env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("imported ") and int(last.split()[1]) > 60


# -- shadow checks under concurrent writes (ROADMAP C4) -------------------------


def test_racing_write_is_no_mismatch(tmp_path):
    """A write that lands between the card's answer and its shadow host
    fold makes the two differ. The port counts both again over one state
    (a Count and a TopN): no mismatch, no quarantine, no host fold, the
    newer answer served. A kernel that miscomputes is still caught."""
    from pilosa_tpu_torch import fault
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.executor import SHADOW_STATS, Executor
    from pilosa_tpu_torch.pql import parse_string

    h = Holder(str(tmp_path))
    h.open()
    try:
        f = h.create_index("i").create_frame("f")
        cols = range(0, 3 << 20, 7919)
        for col in cols:
            f.set_bit(1, col)
            f.set_bit(2, col + 1)
        ex = Executor(h, device="cpu", shadow_sample=1)

        def racing(name, row, col):
            """The host fold `name` of ex, with a write landing first,
            once (an instance attribute over the method)."""
            real = getattr(ex, name)
            done = []

            def wrapped(*a):
                if not done:
                    done.append(f.set_bit(row, col))
                return real(*a)
            setattr(ex, name, wrapped)

        def mismatches():
            return sum(v for k, v in SHADOW_STATS.copy().items()
                       if k.startswith("mismatch:"))

        m0 = mismatches()
        racing("_count_host", 1, 5)
        q = parse_string("Count(Bitmap(rowID=1, frame=f))")
        assert ex.execute("i", q) == [len(cols) + 1]
        racing("_top_n_host_slices", 2, 11)
        top = ex.execute("i", parse_string("TopN(frame=f, n=2)"))[0]
        assert sorted(top) == [(1, len(cols) + 1), (2, len(cols) + 1)]
        assert mismatches() == m0
        assert ex.stats["count_host"] == ex.stats["topn_host"] == 0
        assert ex.mesh_manager().stats.get("plan_quarantined", 0) == 0
        # No write since the count: a miscompute is a mismatch at once.
        del ex._count_host, ex._top_n_host_slices
        fault.arm("device.exec", delta=5, kind="count-result", times=1)
        assert ex.execute("i", q) == [len(cols) + 1]  # the host value
        assert mismatches() == m0 + 1
        assert ex.mesh_manager().stats["plan_quarantined"] == 1
    finally:
        fault.reset()
        h.close()


def test_shadow_checks_under_concurrent_writes_never_mismatch(tmp_path):
    """Stress: writers and shadow-checked Counts and TopNs on one row set
    at once, more threads than cores and a short switch interval. Every
    check compares the card and the host over one state: no mismatch,
    no quarantine, and the last answers equal the host folds."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.executor import SHADOW_STATS, Executor
    from pilosa_tpu_torch.pql import parse_string

    h = Holder(str(tmp_path))
    h.open()
    interval = sys.getswitchinterval()
    try:
        f = h.create_index("i").create_frame("f")
        for col in range(0, 2 << 20, 4099):
            f.set_bit(col % 3, col)
        ex = Executor(h, device="cpu", shadow_sample=1)
        queries = [parse_string(q) for q in (
            "Count(Bitmap(rowID=0, frame=f))",
            "Count(Intersect(Bitmap(rowID=1, frame=f), "
            "Bitmap(rowID=2, frame=f)))", "TopN(frame=f, n=3)")]
        m0 = sum(v for k, v in SHADOW_STATS.copy().items()
                 if k.startswith("mismatch:"))
        stop = time.monotonic() + 3.0
        errors = []

        def writer(seed):
            rng = random.Random(seed)
            while time.monotonic() < stop:
                f.set_bit(rng.randrange(3), rng.randrange(2 << 20))

        def reader(k):
            try:
                while time.monotonic() < stop:
                    ex.execute("i", queries[k % 3])
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(repr(e))

        sys.setswitchinterval(1e-5)
        threads = ([threading.Thread(target=writer, args=(s,))
                    for s in range(os.cpu_count() or 2)]
                   + [threading.Thread(target=reader, args=(k,))
                      for k in range(6)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads) and not errors
        sys.setswitchinterval(interval)
        m1 = sum(v for k, v in SHADOW_STATS.copy().items()
                 if k.startswith("mismatch:"))
        assert m1 == m0
        assert ex.mesh_manager().stats.get("plan_quarantined", 0) == 0
        assert ex.stats["count_host"] == ex.stats["topn_host"] == 0
        assert ex.stats["count_device"] > 0
        ex.shadow_sample = 0
        child = queries[0].calls[0].children[0]
        assert ex.execute("i", queries[0]) == [
            ex._count_host("i", child, [0, 1])]
    finally:
        sys.setswitchinterval(interval)
        h.close()
