"""The fleet merge and the metrics lint (obs/fleet.py, ctl fleet,
tools/metrics_lint.py) against the JAX package's.

Equal, exactly: parse_text, merge and hist_percentiles of the /metrics
text of a port node and of a JAX node after the same seeded stream; the
four FleetAggregator cases of tests/test_fleet.py (stale tolerance,
breaker skips, a member leaving, the interval cache) on both modules; a
merge of frozen scrapes, whose expected sums are taken in sorted host
order, the order snapshot() merges in, so float sums agree to the last
bit; render_fleet of the same documents; /debug/fleet's 404 on a handler
without a cluster, and `ctl fleet`'s panel of a one-node server; the
lint's violations on the texts of tests/test_fleet.py; and
the JAX lint over the port's live scrape (none). The port's modules
import nothing of the JAX package: the cross-checks are here only.
"""

import functools
import importlib.util
import operator
import os
import random

import pytest

import pilosa_tpu.ctl.main as jax_ctl
from pilosa_tpu.obs import fleet as jax_fleet
from pilosa_tpu_torch.ctl import main as port_ctl
from pilosa_tpu_torch.obs import fleet as port_fleet
from pilosa_tpu_torch.tools import metrics_lint as port_lint
from torch_obs import PKGS, isolated_stores  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

FLEETS = {"jax": jax_fleet, "torch": port_fleet}


@pytest.fixture(params=list(FLEETS))
def fleet(request):
    return FLEETS[request.param]


def _jax_lint():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                        "metrics_lint.py")
    spec = importlib.util.spec_from_file_location("jax_metrics_lint", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_LINT = _jax_lint()


def stream(seed: int) -> list:
    """A seeded stream of writes, Counts and TopNs over frame f."""
    rng = random.Random(seed)
    out = [f"SetBit(rowID={rng.randrange(6)}, frame=f, "
           f"columnID={rng.randrange(3 << 20)})" for _ in range(40)]
    for _ in range(30):
        k = rng.randrange(3)
        a, b = rng.randrange(6), rng.randrange(6)
        out.append(f"Count(Bitmap(rowID={a}, frame=f))" if k == 0 else
                   f"Count(Intersect(Bitmap(rowID={a}, frame=f), "
                   f"Bitmap(rowID={b}, frame=f)))" if k == 1 else
                   "TopN(frame=f, n=3)")
    return out


def scrape(name: str, path, seed: int) -> str:
    """/metrics of a `name` node after the seeded stream (tenants gold
    and default, gold folded into the SLO's "other"; one query
    profiled)."""
    holder, h = PKGS[name].make_handler(path)
    try:
        assert h.handle("POST", "/index/i").status == 200
        assert h.handle("POST", "/index/i/frame/f").status == 200
        for k, q in enumerate(stream(seed)):
            r = h.handle("POST", "/index/i/query",
                         {"profile": "true"} if k == 50 else {},
                         {"X-Pilosa-Tenant": "gold" if k % 3 else
                          "default"}, q.encode())
            assert r.status == 200, (q, r.body)
        return h.handle("GET", "/metrics").body.decode()
    finally:
        holder.close()


@pytest.fixture(scope="module")
def texts(tmp_path_factory):
    """The /metrics of a port node and of a JAX node, two seeds each."""
    out = {}
    for name in ("torch", "jax"):
        for seed in (1, 2):
            out[(name, seed)] = scrape(
                name, tmp_path_factory.mktemp(f"{name}{seed}"), seed)
    return out


# -- the parser, the merge, the percentiles --------------------------------------


def test_parse_text_equal_on_both_nodes_scrapes(texts):
    for key, text in texts.items():
        port = port_fleet.parse_text(text)
        assert port == jax_fleet.parse_text(text), key
        assert any(n == "pilosa_query_outcome_total" for n, _ in port)


def test_merge_and_percentiles_equal(texts):
    for fl in FLEETS.values():
        assert fl.is_cumulative("x_total") and not fl.is_cumulative("x")
    samples = [port_fleet.parse_text(t) for t in texts.values()]
    merged = port_fleet.merge(samples)
    assert merged == jax_fleet.merge(samples)
    assert all(port_fleet.is_cumulative(n) for n, _ in merged)
    names = sorted({n[:-len("_bucket")] for n, _ in merged
                    if n.endswith("_bucket")})
    assert "pilosa_query_route_duration_microseconds" in names
    for name in names:
        for fixed in ({}, {"tenant": "other"}, {"backend": "mesh"}):
            for m in (merged, *samples):
                assert port_fleet.hist_percentiles(m, name, fixed) == \
                    jax_fleet.hist_percentiles(m, name, fixed), (name, fixed)
    for key in merged:  # left to right, as merge() adds (no fsum)
        assert merged[key] == functools.reduce(
            operator.add, (s.get(key, 0.0) for s in samples), 0.0)


def test_node_row_and_sample_key_equal(texts):
    for text in texts.values():
        s = port_fleet.parse_text(text)
        assert port_fleet.node_row(s, {"sched": {"queued": 3}}) == \
            jax_fleet.node_row(s, {"sched": {"queued": 3}})
        for name, labels in list(s)[:50]:
            assert port_fleet.sample_key(name, labels) == \
                jax_fleet.sample_key(name, labels)


@pytest.mark.parametrize("text", [
    'a_total{t="x"} 2\na_total{t="x"} 3\ng{t="x"} 2\ng{t="x"} 9\n',
    'h_bucket{le="8"} 7 # {trace_id="abc"} 5.2 123.000\nh_count 7\n',
    "# HELP x y\n# TYPE x counter\n!!!not a sample\nx_total notanumber\n"
    "x_total 4\n",
    'm_total{b="2",a="1"} 3\nm_total{a="1",b="2"} 3\n',
    'q{l="a\\"b\\\\c\\nd"} 1\n',
])
def test_parse_text_cases(text):
    assert port_fleet.parse_text(text) == jax_fleet.parse_text(text)


# -- the aggregator (tests/test_fleet.py:135-235 on both modules) -------------


def _mk(fleet, texts, fail=(), breaker=None, now=None):
    calls = []

    def fetch(host, path, timeout_s):
        calls.append((host, path))
        if host in fail:
            raise ConnectionError("down")
        if path == "/metrics":
            return texts[host]
        return "{}"

    agg = fleet.FleetAggregator(
        members=lambda: {h: "UP" for h in texts},
        fetch=fetch, breaker_state=breaker,
        **({"now": now} if now else {}))
    return agg, calls


class TestAggregator:
    def test_stale_tolerance_keeps_last_good_sample(self, fleet):
        clock = [100.0]
        texts = {"n1:1": "pilosa_query_outcome_total 5\n"}
        fail = set()
        agg, _ = _mk(fleet, texts, fail=fail, now=lambda: clock[0])
        doc = agg.snapshot(force=True)
        assert doc["healthy"] == 1 and doc["scraped"] == 1
        assert doc["nodes"]["n1:1"]["scrape_age_s"] == 0.0
        fail.add("n1:1")
        clock[0] = 130.0
        doc = agg.snapshot(force=True)
        assert doc["scraped"] == 1 and doc["healthy"] == 0
        row = doc["nodes"]["n1:1"]
        assert row["scrape_age_s"] == 30.0
        assert "ConnectionError" in row["error"]
        assert doc["merged"]["pilosa_query_outcome_total"] == 5.0

    def test_breaker_open_skips_fetch(self, fleet):
        texts = {"n1:1": "x_total 1\n", "n2:1": "x_total 2\n"}
        agg, calls = _mk(fleet, texts,
                         breaker=lambda h: "open" if h == "n2:1" else "")
        doc = agg.snapshot(force=True)
        assert all(host != "n2:1" for host, _ in calls)
        assert doc["nodes"]["n2:1"]["error"] == "breaker open"
        assert doc["merged"]["x_total"] == 1.0

    def test_member_leaving_ring_forgotten(self, fleet):
        texts = {"n1:1": "x_total 1\n", "n2:1": "x_total 2\n"}
        agg, _ = _mk(fleet, texts)
        assert agg.snapshot(force=True)["merged"]["x_total"] == 3.0
        del texts["n2:1"]
        doc = agg.snapshot(force=True)
        assert doc["members"] == 1
        assert doc["merged"]["x_total"] == 1.0

    def test_snapshot_cached_within_interval(self, fleet):
        clock = [0.0]
        texts = {"n1:1": "x_total 1\n"}
        agg, calls = _mk(fleet, texts, now=lambda: clock[0])
        agg.snapshot()
        n0 = len(calls)
        agg.snapshot()  # within interval: served from cache
        assert len(calls) == n0
        clock[0] += agg.interval + 1
        agg.snapshot()
        assert len(calls) > n0


def frozen_hosts(texts) -> dict:
    """Four scrapes under host names whose sorted order differs from
    the order they are listed in."""
    names = ["127.0.0.1:9", "127.0.0.1:10", "10.0.0.2:5", "127.0.0.1:100"]
    return dict(zip(names, texts.values()))


def test_frozen_scrapes_merge_exactly(fleet, texts):
    """An aggregator over frozen expositions against a sum by hand of
    every cumulative sample, taken in sorted(hosts) order (the order
    snapshot() merges in): the whole merged map, bit for bit."""
    by_host = frozen_hosts(texts)
    agg = fleet.FleetAggregator(
        members=lambda: {h: "UP" for h in by_host},
        fetch=lambda h, path, t: (by_host[h] if path == "/metrics"
                                  else "{}"))
    doc = agg.snapshot(force=True)
    expected = {}
    for host in sorted(by_host):
        for (name, labels), v in fleet.parse_text(by_host[host]).items():
            if fleet.is_cumulative(name):
                k = fleet.sample_key(name, labels)
                expected[k] = expected.get(k, 0.0) + v
    assert doc["merged"] == expected
    assert doc["members"] == doc["scraped"] == doc["healthy"] == 4


def test_both_aggregators_build_the_same_document(texts):
    by_host = frozen_hosts(texts)
    docs = []
    for fl in FLEETS.values():
        agg = fl.FleetAggregator(
            members=lambda: {h: "UP" for h in by_host},
            fetch=lambda h, path, t: (by_host[h] if path == "/metrics"
                                      else '{"sched": {"queued": 2}}'),
            now=lambda: 50.0)
        doc = agg.snapshot(force=True)
        doc.pop("generated_at")
        docs.append(doc)
    assert docs[0] == docs[1]
    assert docs[0]["phase_percentiles"], "a profiled query's phases"


# -- the panel --------------------------------------------------------------------


def fleet_docs(texts):
    by_host = frozen_hosts(texts)
    clock = [10.0]
    fail = set()

    def fetch(h, path, t):
        if h in fail:
            raise ConnectionError("refused")
        return by_host[h] if path == "/metrics" else "{}"

    states = {h: "UP" for h in by_host}
    states["127.0.0.1:11"] = "DOWN"  # never scraped
    agg = port_fleet.FleetAggregator(members=lambda: dict(states),
                                     fetch=fetch, now=lambda: clock[0])
    first = agg.snapshot(force=True)
    fail.add("127.0.0.1:9")
    clock[0] = 40.0
    return first, agg.snapshot(force=True)


def test_render_fleet_equal(texts):
    first, second = fleet_docs(texts)
    for doc, prev, dt in ((first, None, 0.0), (second, first, 30.0),
                          ({}, None, 0.0)):
        port = port_ctl.render_fleet("h:1", doc, prev, dt)
        assert port == jax_ctl.render_fleet("h:1", doc, prev, dt)
    text = port_ctl.render_fleet("h:1", second, first, 30.0)
    assert "UNSCRAPED" in text and "STALE 30s" in text
    assert "error: ConnectionError: refused" in text


def test_debug_fleet_404_on_one_node(tmp_path):
    from pilosa_tpu.api import Handler as JaxHandler
    from pilosa_tpu.core import Holder as JaxHolder
    from pilosa_tpu.executor import Executor as JaxExecutor

    holder, h = PKGS["torch"].make_handler(tmp_path / "p")
    jholder = JaxHolder(str(tmp_path / "j"))
    jholder.open()
    try:
        jh = JaxHandler(jholder, JaxExecutor(jholder, use_device=False))
        port, jax = (x.handle("GET", "/debug/fleet") for x in (h, jh))
        assert (port.status, port.headers, port.body) == \
            (jax.status, jax.headers, jax.body) == \
            (404, {"Content-Type": "application/json"},
             b'{"error": "fleet view requires a cluster"}\n')
        assert h.handle("GET", "/debug/fleet",
                        {"force": "true"}).status == 404
    finally:
        holder.close()
        jholder.close()


def test_ctl_fleet_against_one_node(tmp_path, capsys):
    """`ctl fleet` against a one-node server of each package: a Server
    always builds its cluster, so the pane answers its one member (the
    config's default host, unscraped here), and both ctls exit 0 with
    the same panel."""
    from pilosa_tpu.config import Config as JaxConfig
    from pilosa_tpu.server import Server as JaxServer
    from pilosa_tpu_torch.config import Config
    from pilosa_tpu_torch.server import Server

    panels = {}
    for name, cfg_cls, srv_cls, ctl in (
            ("jax", JaxConfig, JaxServer, jax_ctl),
            ("torch", Config, Server, port_ctl)):
        c = cfg_cls()
        c.data_dir = str(tmp_path / name)
        c.host = "127.0.0.1:0"
        c.use_device = "off"
        srv = srv_cls(c)
        srv.open(port=0)
        try:
            assert srv.handler.fleet_scrape_interval == \
                c.fleet_scrape_interval
            assert ctl.main(["fleet", "--host", srv.host, "-n", "1"]) == 0
            panels[name] = capsys.readouterr().out.replace(srv.host, "H")
        finally:
            srv.close()
    assert "members 1" in panels["torch"]
    assert panels["torch"] == panels["jax"]


# -- the lint ---------------------------------------------------------------------

BAD = ("# TYPE nohelp_total counter\nnohelp_total 1\n"
       "# HELP bad_gauge_total g\n"
       "# TYPE bad_gauge_total gauge\nbad_gauge_total 1\n"
       "# HELP c c\n# TYPE c counter\nc 1\n"
       "# HELP h_ms h\n# TYPE h_ms histogram\n"
       'h_ms_bucket{le="+Inf"} 1\nh_ms_count 1\nh_ms_sum 1\n'
       "# HELP leak l\n# TYPE leak gauge\n"
       'leak{query="Count(...)"} 1\n')
BIG = "\n".join(["# HELP big b", "# TYPE big gauge"]
                + [f'big{{host="h{i}"}} 1' for i in range(12)]) + "\n"


@pytest.mark.parametrize("text,max_series", [
    (BAD, 500), (BIG, 10), (BIG, 20), (BIG, 12), ("", 500),
    ("# HELP pilosa_cost_x_total c\n# TYPE pilosa_cost_x_total counter\n"
     + "".join(f'pilosa_cost_x_total{{shape="s{i}"}} 1\n'
               for i in range(600)), 500),
    ("# HELP pilosa_health_state s\n# TYPE pilosa_health_state gauge\n"
     + "".join(f'pilosa_health_state{{subsystem="s{i}"}} 0\n'
               for i in range(65)), 500),
])
def test_lint_verdicts_equal(text, max_series):
    port = port_lint.lint(text, max_series=max_series)
    assert port == JAX_LINT.lint(text, max_series=max_series)
    assert port_lint.parse_exposition(text) == \
        JAX_LINT.parse_exposition(text)


def test_lint_rules_catch_violations():
    problems = port_lint.lint(BAD)
    assert any("missing HELP" in p for p in problems)
    assert any("gauge with a counter's _total" in p for p in problems)
    assert any("counter families must end in _total" in p
               for p in problems)
    assert any("unit suffix" in p for p in problems)
    assert any("'query' not in the bounded" in p for p in problems)


def test_port_live_scrape_is_clean_under_both_lints(texts):
    live = port_lint.live_scrape()
    assert port_lint.lint(live) == []
    assert JAX_LINT.lint(live) == []
    for (name, _seed), text in texts.items():
        if name == "torch":
            assert JAX_LINT.lint(text) == port_lint.lint(text) == []


def test_lint_main_file_and_url(tmp_path, capsys):
    f = tmp_path / "bad.prom"
    f.write_text(BAD)
    assert port_lint.main(["--file", str(f)]) == 1
    out = capsys.readouterr().out
    assert "nohelp_total: missing HELP text" in out
    f.write_text(port_lint.live_scrape())
    assert port_lint.main(["--file", str(f)]) == 0
    assert "families clean" in capsys.readouterr().out
