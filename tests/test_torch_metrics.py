"""The port's observability against the JAX package's: obs/prom (the
text format, histogram exposition, the expvar bridge, scrapes during
writes, a failing collector) run through both packages' modules with
identical text; the log2 Histogram on seeded values; ExpvarStats; a
JSON log line through both obs/log pipelines; and GET /metrics of both
handlers after the same seeded stream of requests (writes, Counts,
TopN, an import, a snapshot, a scrub pass), whose shared families for
fragments, storage and integrity, pilosa_build_info and the expvar
counters have equal names, types, help and values. Tolerance 0: every
value compared is a count (latency histograms compare their counts).
"""

import json
import logging
import re
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from pilosa_tpu.api.handler import Handler as JaxHandler
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.core.scrub import Scrubber as JaxScrubber
from pilosa_tpu.core.wal import WalConfig as JaxWalConfig
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.obs import Histogram as JaxHistogram
from pilosa_tpu.obs import log as jax_log
from pilosa_tpu.obs import prom as jax_prom
from pilosa_tpu.utils.stats import ExpvarStats as JaxExpvarStats
from pilosa_tpu.utils.stats import MultiStats as JaxMultiStats

from pilosa_tpu_torch import wire
from pilosa_tpu_torch.api.handler import Handler
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.scrub import Scrubber
from pilosa_tpu_torch.core.wal import WalConfig
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.obs import Histogram
from pilosa_tpu_torch.obs import log as port_log
from pilosa_tpu_torch.obs import prom
from pilosa_tpu_torch.utils.stats import (ExpvarStats, MultiStats,
                                          NopStats)
from torch_threads import one_torch_thread  # noqa: F401

JAX = SimpleNamespace(prom=jax_prom, Histogram=JaxHistogram,
                      ExpvarStats=JaxExpvarStats)
PORT = SimpleNamespace(prom=prom, Histogram=Histogram,
                       ExpvarStats=ExpvarStats)

_SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? "
                     r"(NaN|[+-]Inf|-?[0-9].*)$")


def parse_exposition(text):
    """(samples, types, helps) of a text-format 0.0.4 body. Every line
    must parse, each family's TYPE must come before its samples, and
    every histogram's buckets must be cumulative and end in +Inf, with
    _count equal to the +Inf bucket."""
    samples, types, helps = [], {}, {}
    assert text.endswith("\n")
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ", 3)
            assert name not in types, f"family {name} twice"
            types[name] = mtype
        elif line.startswith("# HELP "):
            _, _, name, help_text = line.split(" ", 3)
            helps[name] = help_text
        elif line:
            assert _SAMPLE.match(line), f"unparseable sample: {line!r}"
            name = re.split(r"[{ ]", line, maxsplit=1)[0]
            rest = line[len(name):]
            labels = {}
            if rest.startswith("{"):
                body, _, rest = rest[1:].partition("}")
                for k, v in re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', body):
                    labels[k] = (v.replace('\\"', '"').replace("\\n", "\n")
                                 .replace("\\\\", "\\"))
            fam = re.sub(r"_(bucket|sum|count)$", "", name)
            assert fam in types or name in types, \
                f"sample {name} before its TYPE"
            samples.append((name, labels, rest.strip()))
    for fam, mtype in types.items():
        if mtype != "histogram":
            continue
        series = {}
        for name, labels, v in samples:
            key = tuple(sorted((k, x) for k, x in labels.items()
                               if k != "le"))
            if name == fam + "_bucket":
                series.setdefault(key, []).append((labels["le"], float(v)))
            elif name == fam + "_count":
                series.setdefault(("count",) + key, []).append(float(v))
        for key, buckets in series.items():
            if key[:1] == ("count",):
                continue
            counts = [c for _, c in buckets]
            assert counts == sorted(counts), f"{fam} not cumulative"
            assert buckets[-1][0] == "+Inf"
            assert series[("count",) + key] == [buckets[-1][1]]
    return samples, types, helps


# -- obs/prom through both packages ------------------------------------------------


def case_counter_gauge(m):
    reg = m.prom.Registry()
    reg.counter("reqs_total", "Requests.").labels(code="200").inc(3)
    reg.gauge("temp", "Temp.").set(1.5)
    return reg.render()


def case_type_before_samples(m):
    reg = m.prom.Registry()
    reg.counter("a_total").inc()
    return reg.render()


def case_label_escaping(m):
    fam = m.prom.MetricFamily("m", "gauge")
    fam.add(1, {"k": 'a"b\\c\nd'})
    return m.prom.render([fam])


def case_help_escaping(m):
    return m.prom.MetricFamily("m", "gauge", "line1\nline2 \\ back") \
        .add(1).render()


def case_names(m):
    p = m.prom
    return repr([p.sanitize_name("query.Count"), p.sanitize_name("9lives"),
                 p.sanitize_name("ok_name:x"), p.sanitize_label("a.b-c"),
                 p.sanitize_label("1x")])


def case_empty_families(m):
    return m.prom.render([m.prom.MetricFamily("empty", "gauge"),
                          m.prom.MetricFamily("full", "gauge").add(1)])


def case_values(m):
    return repr([m.prom.format_value(v) for v in (
        3.0, float("inf"), float("-inf"), float("nan"), 0.25, 2**60, -7)])


def case_cumulative_buckets(m):
    h = m.Histogram()
    for v in (0, 1, 2, 3, 100, 1000, 1000, 0.5, 2**70):
        h.observe(v)
    return m.prom.render([m.prom.MetricFamily("lat", "histogram")
                          .add_histogram(h, {"backend": "mesh"})])


def case_labeled_histograms(m):
    reg = m.prom.Registry()
    inst = reg.histogram("lat", "Latency.")
    inst.labels(backend="mesh").observe(4)
    inst.labels(backend="host").observe(1000)
    return reg.render()


def case_expvar_bridge(m):
    s = m.ExpvarStats()
    s.count("reqs", 2)
    s.with_tags("index:i", "frame:f").count("reqs", 3)
    s.with_tags("index:i").count("query.Count", 4)
    s.gauge("open_files", 9)
    s.set("node_state", "UP")
    s.timing("query", 100)
    s.with_tags("index:i").timing("query", 3000)
    s.with_tags("bare").count("x")
    return m.prom.render(m.prom.expvar_families(s)) + json.dumps(
        s.snapshot(), sort_keys=True)


def case_statmap_families(m):
    return m.prom.render(m.prom.statmap_families(
        {"b.x": 2, "a": 1.5, "skip": "str"}, "pilosa_mesh_"))


def case_failing_collector(m):
    reg = m.prom.Registry()
    reg.register_collector(lambda: (_ for _ in ()).throw(RuntimeError))
    reg.gauge("ok").set(1)
    return reg.render()


def case_kind_clash(m):
    reg = m.prom.Registry()
    reg.counter("x")
    try:
        reg.gauge("x")
    except ValueError as e:
        return str(e)
    return "no error"


PROM_CASES = {f.__name__[5:]: f for f in (
    case_counter_gauge, case_type_before_samples, case_label_escaping,
    case_help_escaping, case_names, case_empty_families, case_values,
    case_cumulative_buckets, case_labeled_histograms, case_expvar_bridge,
    case_statmap_families, case_failing_collector, case_kind_clash)}


@pytest.mark.parametrize("name", sorted(PROM_CASES))
def test_prom_text_is_the_jax_text(name):
    got = PROM_CASES[name](PORT)
    assert got == PROM_CASES[name](JAX)
    if got.endswith("\n"):
        parse_exposition(got)


def test_prom_cases_hold_what_they_test():
    samples, types, helps = parse_exposition(case_counter_gauge(PORT))
    assert types == {"reqs_total": "counter", "temp": "gauge"}
    assert ("reqs_total", {"code": "200"}, "3") in samples
    lines = case_type_before_samples(PORT).splitlines()
    assert lines.index("# TYPE a_total counter") < lines.index("a_total 1")
    assert parse_exposition(case_label_escaping(PORT))[0] == [
        ("m", {"k": 'a"b\\c\nd'}, "1")]
    assert "# HELP m line1\\nline2 \\\\ back" in case_help_escaping(PORT)
    assert "empty" not in case_empty_families(PORT)
    assert "ok 1" in case_failing_collector(PORT)
    text = case_expvar_bridge(PORT)
    assert 'pilosa_query_Count_total{index="i"} 4' in text
    assert 'pilosa_node_state_info{value="UP"} 1' in text


def test_scrape_with_writers():
    """Writers hammer every store type while scrapes run; each scrape
    parses cleanly."""
    s = ExpvarStats()
    reg = prom.Registry()
    reg.register_collector(lambda: prom.expvar_families(s))
    ctr = reg.counter("ops_total")
    stop = threading.Event()

    def writer(i):
        t = s.with_tags(f"worker:{i}")
        n = 0
        while not stop.is_set():
            t.count("w")
            t.timing("lat", n % 1000)
            ctr.labels(worker=str(i)).inc()
            n += 1

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(20):
            parse_exposition(reg.render())
    finally:
        stop.set()
        for t in threads:
            t.join()


# -- the log2 Histogram and the stats clients -------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_histogram_is_the_jax_histogram(seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.exponential(10.0 ** rng.integers(0, 6),
                                           size=rng.integers(1, 400)),
                           rng.integers(0, 3, size=5)]).tolist()
    if seed == 0:
        vals = [42.0] * 7  # one repeated value: exact at every quantile
    hs = [Histogram(), JaxHistogram()]
    for h in hs:
        for v in vals:
            h.observe(v)
    qs = [0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0]
    got = [(h.bucket_snapshot(), h.min, h.max, h.percentiles(qs),
            h.snapshot("x")) for h in hs]
    assert got[0] == got[1]
    if seed == 0:
        assert got[0][3] == [42.0] * len(qs)
    assert Histogram().percentile(0.5) == JaxHistogram().percentile(0.5)


def test_histogram_exemplar_slot():
    hs = [Histogram(), JaxHistogram()]
    for h in hs:
        h.observe(5, exemplar="t1")
        h.observe(6)
    ex = [{b: e[:2] for b, e in h.exemplar_snapshot().items()} for h in hs]
    assert ex[0] == ex[1] == {3: ("t1", 5.0)}


def test_stats_clients_are_the_jax_clients():
    outs = []
    for exp, multi in ((ExpvarStats, MultiStats),
                       (JaxExpvarStats, JaxMultiStats)):
        a, b = exp(), exp()
        m = multi([a, b]).with_tags("index:i")
        m.count("c", 2)
        m.gauge("g", 3)
        m.histogram("h", 17)
        m.set("s", "v")
        m.timing("t", 250)
        outs.append((a.snapshot(), b.snapshot(), a.structured()[3]))
    assert outs[0] == outs[1]
    n = NopStats()
    assert n.with_tags("x") is n and n.count("c") is None


def test_json_log_line_has_the_jax_keys(tmp_path):
    lines = []
    for mod, root in ((port_log, "pilosa_tpu_torch"), (jax_log, "pilosa_tpu")):
        path = tmp_path / f"{root}.log"
        mod.setup(level="debug", fmt="json", path=str(path))
        try:
            mod.get_logger("server").info("hello %s", "world")
            try:
                raise ValueError("boom")
            except ValueError:
                mod.get_logger("server").exception("failed")
        finally:
            logging.getLogger(root).handlers[0].flush()
        lines.append([json.loads(x) for x in path.read_text().splitlines()])
        mod.setup()  # back to stderr, text
    port, jax = lines
    assert [sorted(d) for d in port] == [sorted(d) for d in jax]
    assert [(d["level"], d["msg"]) for d in port] == [
        ("info", "hello world"), ("error", "failed")]
    assert port[0]["component"] == "pilosa_tpu_torch.server"
    assert "trace_id" not in port[0] and "boom" in port[1]["exc"]


def test_text_log_line_and_levels(tmp_path):
    path = tmp_path / "t.log"
    port_log.setup(level="warning", fmt="text", path=str(path))
    port_log.get_logger("x").info("quiet")
    port_log.get_logger("pilosa_tpu_torch.x").warning("loud")
    logging.getLogger("pilosa_tpu_torch").handlers[0].flush()
    port_log.setup()
    text = path.read_text()
    assert "quiet" not in text
    assert " WARNING pilosa_tpu_torch.x loud" in text


# -- /metrics of both handlers after the same stream ----------------------------------

SHARED = {
    "pilosa_build_info", "pilosa_fragment_cardinality", "pilosa_fragments",
    "pilosa_wal_fsync_total", "pilosa_wal_backpressure_total",
    "pilosa_storage_snapshots_total", "pilosa_wal_group_size",
    "pilosa_storage_snapshot_us", "pilosa_wal_torn_tails_total",
    "pilosa_integrity_corrupt_total", "pilosa_integrity_repaired_total",
    "pilosa_scrub_fragments_total", "pilosa_scrub_repairs_total",
    "pilosa_shadow_checks_total", "pilosa_shadow_mismatch_total"}


def scrape(handler) -> dict:
    """{family: (type, help, {(sample name, labels): value})}; a
    histogram keeps its _count samples (its sums and buckets are
    latencies) except the group sizes, which are counts."""
    resp = handler.handle("GET", "/metrics")
    assert resp.status == 200
    assert resp.headers["Content-Type"].startswith(
        "text/plain; version=0.0.4")
    samples, types, helps = parse_exposition(resp.body.decode())
    out = {f: (t, helps.get(f), {}) for f, t in types.items()}
    for name, labels, v in samples:
        fam = name if name in types else re.sub(r"_(bucket|sum|count)$",
                                                "", name)
        if types[fam] == "histogram" and not name.endswith("_count") \
                and fam != "pilosa_wal_group_size":
            continue
        out[fam][2][(name, tuple(sorted(labels.items())))] = float(v)
    return out


def delta(after: dict, before: dict) -> dict:
    out = {}
    for fam, (t, h, vals) in after.items():
        prev = before.get(fam, (t, h, {}))[2]
        if fam == "pilosa_build_info" or t == "gauge":
            out[fam] = (t, h, vals)
        else:
            out[fam] = (t, h, {k: v - prev.get(k, 0.0)
                               for k, v in vals.items()})
    return out


def stream(handler, holder, scrubber, seed: int):
    """A seeded stream: writes and clears, Counts, TopN, an import, a
    snapshot, a scrub pass. Returns the query answers."""
    rng = np.random.default_rng(seed)
    answers = []

    def q(body):
        resp = handler.handle("POST", "/index/i/query", body=body.encode())
        assert resp.status == 200, resp.body
        answers.append(resp.json()["results"])

    for path in ("/index/i", "/index/i/frame/f"):
        assert handler.handle("POST", path, body=b"{}").status == 200
    bits = {(int(r), int(c)) for r, c in zip(
        rng.integers(0, 6, 60), rng.integers(0, 3 * (1 << 20), 60))}
    for r, c in sorted(bits):
        q(f"SetBit(rowID={r}, frame=f, columnID={c})")
    for r, c in sorted(bits)[:5]:
        q(f"ClearBit(rowID={r}, frame=f, columnID={c})")
    for a, b in ((0, 1), (2, 3), (1, 4)):
        q(f"Count(Intersect(Bitmap(rowID={a}, frame=f), "
          f"Bitmap(rowID={b}, frame=f)))")
    q("Count(Bitmap(rowID=5, frame=f))")
    q("TopN(frame=f, n=3)")
    req = wire.ImportRequest(index="i", frame="f", slice=1,
                             row_ids=[7, 7, 8], column_ids=[
                                 (1 << 20) + 1, (1 << 20) + 9, (1 << 20) + 9])
    resp = handler.handle("POST", "/import",
                          headers={"Content-Type": wire.PROTOBUF_CT},
                          body=req.encode())
    assert resp.status == 200, resp.body
    q("Count(Union(Bitmap(rowID=7, frame=f), Bitmap(rowID=8, frame=f)))")
    frag = holder.fragment("i", "f", "standard", 0)
    frag.snapshot()
    assert frag.wait_snapshot(timeout=30)
    assert scrubber.scrub_pass() > 0
    q("Count(Bitmap(rowID=7, frame=f))")
    return answers


@pytest.fixture(autouse=True)
def _lone_fused_off(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_LONE_FUSED", "off")
    # The JAX executor sends small Counts to the host fold unless told
    # otherwise; here every Count takes its device path, as the port's.
    monkeypatch.setenv("PILOSA_TPU_DEVICE_MIN_WORK", "0")


@pytest.fixture
def fresh_shadow_stats():
    """Both packages' SHADOW_STATS are process-wide: a check an earlier
    test of the same process ran (tests/test_torch_integrity.py's bsi
    shadow checks) must not show as a series of this stream. Their
    contents are set aside for the test and put back after it."""
    from pilosa_tpu.executor import SHADOW_STATS as jax_shadow
    from pilosa_tpu_torch.executor import SHADOW_STATS as port_shadow

    saved = [(m, dict(m)) for m in (jax_shadow, port_shadow)]
    for m, _ in saved:
        m.clear()
    yield
    for m, old in saved:
        m.clear()
        m.update(old)


@pytest.fixture
def stream_group_sizes(monkeypatch):
    """Both packages' WAL group-size histograms (process-wide) replaced
    for the test by ones that take only the commits of the test's own
    thread. The stream writes from that thread alone, one request after
    another, so each of its commits is led by its writer there; a commit
    another thread leads meanwhile (a daemon an earlier test of the same
    worker left running) is none of the stream's, and used to show in
    one package's buckets and not the other's under load."""
    import pilosa_tpu.core.wal as jax_wal
    import pilosa_tpu_torch.api.handler as port_handler
    import pilosa_tpu_torch.core.wal as port_wal

    me = threading.current_thread()

    def serialised(cls):
        class OnlyThisThread(cls):
            __slots__ = ()

            def observe(self, value, exemplar=None):
                if threading.current_thread() is me:
                    super().observe(value, exemplar)
        return OnlyThisThread()

    jax_h, port_h = serialised(JaxHistogram), serialised(Histogram)
    monkeypatch.setattr(jax_wal, "GROUP_SIZE", jax_h)
    monkeypatch.setattr(port_wal, "GROUP_SIZE", port_h)
    monkeypatch.setattr(port_handler, "GROUP_SIZE", port_h)
    return jax_h, port_h


def test_metrics_of_both_handlers_after_the_same_stream(
        tmp_path, fresh_shadow_stats, stream_group_sizes):
    jstats, pstats = JaxExpvarStats(), ExpvarStats()
    jh = JaxHolder(str(tmp_path / "jax"), stats=jstats,
                   wal=JaxWalConfig(fsync_policy="always"))
    ph = Holder(str(tmp_path / "port"), wal=WalConfig("always"),
                stats=pstats)
    jh.open()
    ph.open()
    try:
        jex = JaxExecutor(jh, use_device=True)
        jex.shadow_sample = 1
        jhandler = JaxHandler(jh, jex, stats=jstats)
        jhandler.scrubber = JaxScrubber(jh, rate_limit=0)
        phandler = Handler(ph, Executor(ph, device="cpu", shadow_sample=1),
                           stats=pstats)
        for handler in (jhandler, phandler):
            handler.metrics_sample_interval = 0.0
        before = (scrape(jhandler), scrape(phandler))
        answers = (stream(jhandler, jh, jhandler.scrubber, 7),
                   stream(phandler, ph, Scrubber(ph, rate_limit=0), 7))
        assert answers[0] == answers[1]
        jm, pm = (delta(scrape(h), b) for h, b in zip(
            (jhandler, phandler), before))
    finally:
        jh.close()
        ph.close()
    expvar = {f for f in pm if f in jm and jm[f][1] is not None
              and "ExpvarStats" in jm[f][1]}
    assert {"pilosa_setN_total", "pilosa_clearN_total",
            "pilosa_wal_fsyncN_total", "pilosa_query_Count_total",
            "pilosa_query_us", "pilosa_snapshot_us_us"} <= expvar
    checks = ("pilosa_shadow_checks_total", (("backend", "mesh"),))
    # The port answers TopN on the card, and checks it; the JAX
    # executor answers this TopN on the host, where nothing is checked.
    # Every Count is checked in both.
    assert pm["pilosa_shadow_checks_total"][2][checks] == 7
    assert jm["pilosa_shadow_checks_total"][2][checks] == 6
    jm["pilosa_shadow_checks_total"][2][checks] += 1
    for fam in sorted(SHARED | expvar):
        assert fam in pm and fam in jm, fam
        assert pm[fam] == jm[fam], fam
    # Every commit of the stream, in both packages' group sizes.
    assert all(h.total > 0 for h in stream_group_sizes)
    assert pm["pilosa_storage_snapshots_total"][2][(
        "pilosa_storage_snapshots_total", (("outcome", "ok"),))] >= 1
    assert pm["pilosa_query_route_total"][2][(
        "pilosa_query_route_total", (("backend", "mesh"),
                                     ("tier", "local")))] == 6
    assert {"pilosa_hbm_resident_bytes", "pilosa_hbm_budget_bytes",
            "pilosa_device_fallback_total", "pilosa_uptime_seconds",
            "pilosa_query_route_duration_microseconds"} <= set(pm)


def test_metrics_before_any_query_has_no_device_families(tmp_path):
    h = Holder(str(tmp_path / "d"))
    h.open()
    try:
        handler = Handler(h, Executor(h, device="cpu"))
        fams = scrape(handler)
        assert "pilosa_build_info" in fams and "pilosa_hbm_budget_bytes" \
            not in fams
        assert "pilosa_compile_total" not in fams
    finally:
        h.close()


def test_fragment_gauges_are_cached_for_the_sample_interval(tmp_path):
    h = Holder(str(tmp_path / "d"))
    h.open()
    try:
        handler = Handler(h, Executor(h, device="cpu"))
        handler.metrics_sample_interval = 3600.0
        handler.handle("POST", "/index/i", body=b"{}")
        handler.handle("POST", "/index/i/frame/f", body=b"{}")
        key = ("pilosa_fragment_cardinality",
               (("frame", "f"), ("index", "i")))
        handler.handle("POST", "/index/i/query",
                       body=b"SetBit(rowID=1, frame=f, columnID=2)")
        assert scrape(handler)["pilosa_fragment_cardinality"][2][key] == 1
        handler.handle("POST", "/index/i/query",
                       body=b"SetBit(rowID=1, frame=f, columnID=3)")
        assert scrape(handler)["pilosa_fragment_cardinality"][2][key] == 1
        handler.metrics_sample_interval = 0.0
        assert scrape(handler)["pilosa_fragment_cardinality"][2][key] == 2
    finally:
        h.close()


def test_debug_vars_carries_the_expvar_snapshot(tmp_path):
    stats = ExpvarStats()
    h = Holder(str(tmp_path / "d"), stats=stats)
    h.open()
    try:
        handler = Handler(h, Executor(h, device="cpu"), stats=stats)
        handler.handle("POST", "/index/i", body=b"{}")
        handler.handle("POST", "/index/i/frame/f", body=b"{}")
        handler.handle("POST", "/index/i/query",
                       body=b"SetBit(rowID=1, frame=f, columnID=2)")
        handler.handle("POST", "/index/i/query",
                       body=b"Count(Bitmap(rowID=1, frame=f))")
        dv = handler.handle("GET", "/debug/vars").json()
        assert dv["index:i,frame:f,view:standard,slice:0,setN"] == 1
        assert dv["index:i,query.Count"] == 1
        assert dv["query.us.count"] == 2 and "query.us.p99" in dv
        assert dv["version"] == "0.1.0" and dv["uptime_seconds"] >= 0
        assert dv["storage"]["group_size.count"] >= 0
        assert dv["mesh"]["quarantined_plans"] == []
    finally:
        h.close()
