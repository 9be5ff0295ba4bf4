"""The cluster's own record in the port against the JAX package's: the
trace graft, the remote profile sections, the network cost taps with
pilosa_tier_bytes_total, and /debug/fleet over the static ring.

- `Trace.graft`: the same remote span dicts grafted into a JAX Trace and
  a port Trace give equal names, tags and parent structure (after the id
  remap), and times within 1 us of the parent's anchor.
- `QueryProfile.merge_remote`: the same section, the same `remotes`.
- Two-node clusters of each package (in-process Servers on loopback, the
  port's on the CPU, replicas 1) hold the same seeded bits. A
  coordinator's profiled Count answers numpy's count with one `remotes`
  section a peer; its trace (/debug/traces/<id>) holds the peer's spans
  under the fan-out span, tagged node=<peer>, with the names the peer
  recorded for the leg. Those names differ between the packages where
  their executors name their engine spans differently (as
  tests/test_torch_trace.py holds): both hold query, parse and plan. The
  bytes a Count moves (TIER_BYTES["http"] and the ledger's
  net_http_bytes) are equal between the packages, whose wire bodies are
  byte-equal, and equal to the legs' request and response bodies.
- A three-node port cluster's /debug/fleet merges the query counters
  exactly (tests/test_fleet.py's bit-identical merge); its document has
  the keys the JAX aggregator builds from the same scrapes; a closed
  node reads stale; a handler without a cluster answers 404, and a
  one-node Server answers one member, as the JAX server does.
- A malformed X-Pilosa-Trace-Spans or X-Pilosa-Profile from a peer (a
  stub) fails no query in either package's client; a span list of
  non-objects escapes both clients' except clauses (ROADMAP C).
- A leg in flight at a node that closes fails the coordinator's Count
  with 400 "index not found" in both packages (ROADMAP C).
- The header-size question: a 240-slice leg's spans and profile stay far
  under http.client's 65,536-byte header line in both packages, on the
  card route and on the host-fold route (ROADMAP C).
"""

import http.server
import json
import threading

import numpy as np
import pytest

from pilosa_tpu.api.client import InternalClient as JaxClient
from pilosa_tpu.config import Config as JaxConfig
from pilosa_tpu.obs import costs as jax_costs
from pilosa_tpu.obs import fleet as jax_fleet
from pilosa_tpu.obs import profile as jax_profile
from pilosa_tpu.obs import trace as jax_trace
from pilosa_tpu.obs.metrics import TIER_BYTES as JAX_TIER_BYTES
from pilosa_tpu.server import Server as JaxServer

from pilosa_tpu_torch import wire
from pilosa_tpu_torch.api.client import InternalClient
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.obs import costs as port_costs
from pilosa_tpu_torch.obs import fleet as port_fleet
from pilosa_tpu_torch.obs import profile as port_profile
from pilosa_tpu_torch.obs import trace as port_trace
from pilosa_tpu_torch.obs.metrics import TIER_BYTES
from pilosa_tpu_torch.parallel.cluster import Cluster, Node
from pilosa_tpu_torch.server import Server, build_handler
from test_torch_cluster_node import _free_ports, _http
from torch_threads import one_torch_thread  # noqa: F401

SLICE_WIDTH = 1 << 20
PKGS = ("jax", "port")
COUNT = "Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f)))"


# -- the graft and merge_remote -------------------------------------------------


def remote_spans(seed: int, n: int) -> list:
    """n span dicts of a remote trace: a root, then spans whose parent
    is an earlier span or, for some, an id the list does not hold."""
    rng = np.random.default_rng(seed)
    out = [{"id": 1, "parent": None, "name": "query", "start_us": 0.0,
            "duration_us": float(rng.integers(500, 5000)), "tags": {}}]
    for i in range(2, n + 1):
        parent = (int(rng.integers(1, i)) if rng.random() < 0.8
                  else 1000 + i)
        out.append({"id": i, "parent": parent,
                    "name": ["parse", "plan", "stage", "launch"][i % 4],
                    "start_us": round(float(rng.random() * 400), 1),
                    "duration_us": round(float(rng.random() * 300), 1),
                    "tags": {"slices": int(rng.integers(1, 240))}})
    return out


def grafted(mod, spans, parent_name, **tags) -> tuple:
    """Graft `spans` under a local span named `parent_name` ("" an
    unknown parent id) of a fresh trace of `mod`: (rows, anchor_ns) with
    rows (name, parent's row or parent id, tags, start and end - anchor,
    ns), ids replaced by rows."""
    tr = mod.Trace("t1", "query")
    with tr.root:
        local = tr.span("fanout", node="h:2")
    pid = local.span_id if parent_name else 999
    anchor = local.start_ns if parent_name else tr.root.start_ns
    n0 = len(tr.spans)
    tr.graft([dict(d, tags=dict(d["tags"])) for d in spans], pid, **tags)
    new = tr.spans[n0:]
    row = {sp.span_id: k for k, sp in enumerate(new)}
    return [(sp.name, ("row", row[sp.parent_id]) if sp.parent_id in row
             else ("id", sp.parent_id == pid), sp.tags,
             sp.start_ns - anchor, sp.end_ns - anchor) for sp in new]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("parent", ["fanout", ""],
                         ids=["known-parent", "unknown-parent"])
def test_graft_equals_the_jax_graft(seed, parent):
    spans = remote_spans(seed, 12)
    jax = grafted(jax_trace, spans, parent, node="http://h:2")
    port = grafted(port_trace, spans, parent, node="http://h:2")
    assert len(port) == len(jax) == len(spans)
    for (pn, pp, pt, ps, pe), (jn, jp, jt, js, je) in zip(port, jax):
        assert (pn, pp, pt) == (jn, jp, jt)
        assert pt["node"] == "http://h:2"
        # Tolerance: 1 us of the anchor (both round the same floats).
        assert abs(ps - js) <= 1_000 and abs(pe - je) <= 1_000
    # A missing remote parent maps to the local parent.
    assert sum(1 for _, p, *_ in port if p == ("id", True)) == 1 + sum(
        1 for d in spans[1:] if d["parent"] > len(spans))


def test_merge_remote_equals_the_jax_merge():
    section = {"backend": "cpu", "total_us": 812.5,
               "phases_us": {"parse": 20.1, "device_exec": 500.0},
               "bytes": {"bytes_touched_hbm": 4096}}
    docs = []
    for mod in (jax_profile, port_profile):
        prof = mod.QueryProfile(backend="cpu")
        with prof.phase("fanout_remote"):
            prof.merge_remote("http://h:2", dict(section))
        prof.merge_remote("http://h:3", {"total_us": 1.0})
        prof.finish()
        doc = prof.to_dict()
        assert "device_exec" not in doc["phases_us"]
        docs.append(doc["remotes"])
    assert docs[0] == docs[1] == [{"host": "http://h:2", **section},
                                  {"host": "http://h:3", "total_us": 1.0}]


# -- live two-node clusters of both packages --------------------------------------


def node_config(pkg, tmp, hosts, i, replicas=1):
    c = JaxConfig() if pkg == "jax" else Config()
    c.data_dir = str(tmp / f"{pkg}{i}")
    c.host = hosts[i]
    c.cluster_hosts = list(hosts)
    c.replica_n = replicas
    c.use_device = "off"
    c.hint_drain_interval = 3600.0
    c.polling_interval = 3600.0
    c.anti_entropy_interval = 3600.0
    c.breaker_cooldown = 3600.0
    c.client_timeout = 10.0
    return c


def boot(pkg, tmp, n, replicas=1, configure=None, min_work=None):
    """(hosts, servers) of an n-node cluster of `pkg`; `min_work` sets
    each executor's device_min_work (cost routing's threshold)."""
    hosts = [f"127.0.0.1:{p}" for p in _free_ports(n)]
    servers = []
    try:
        for i in range(n):
            c = node_config(pkg, tmp, hosts, i, replicas)
            if configure is not None:
                configure(c)
            servers.append((JaxServer if pkg == "jax" else Server)(c))
            servers[-1].open()
            if min_work is not None:
                servers[-1].executor.device_min_work = min_work
    except BaseException:
        close_all(servers)
        raise
    return hosts, servers


def close_all(servers):
    for s in servers:
        try:
            s.close()
        except Exception:  # noqa: BLE001 — a node a test closed itself
            pass


def seed_bits(host, slices: int, seed: int = 5, bits: int = 6) -> dict:
    """Rows 1 and 2 of frame f over `slices` slices from the seed, `bits`
    columns each a slice; the count of their intersection in each
    slice."""
    rng = np.random.default_rng(seed)
    assert _http(host, "POST", "/index/i", b"{}")[0] == 200
    assert _http(host, "POST", "/index/i/frame/f", b"{}")[0] == 200
    per_slice = {}
    for lo in range(0, slices, 40):
        calls = []
        for s in range(lo, min(slices, lo + 40)):
            cols = {r: set(rng.choice(SLICE_WIDTH, bits,
                                      replace=False).tolist())
                    for r in (1, 2)}
            cols[2] |= set(sorted(cols[1])[:int(rng.integers(0, bits))])
            per_slice[s] = len(cols[1] & cols[2])
            calls += [f"SetBit(rowID={r}, frame=f, "
                      f"columnID={s * SLICE_WIDTH + c})"
                      for r in (1, 2) for c in sorted(cols[r])]
        assert _http(host, "POST", "/index/i/query",
                     "".join(calls).encode())[0] == 200
    return per_slice


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """{pkg: (hosts, servers, per-slice counts)}: two nodes of each
    package, replicas 1, the same seeded bits over 6 slices."""
    tmp = tmp_path_factory.mktemp("record")
    out = {}
    try:
        for pkg in PKGS:
            hosts, servers = boot(pkg, tmp, 2)
            out[pkg] = (hosts, servers, seed_bits(hosts[0], 6))
        yield out
    finally:
        for _, servers, _ in out.values():
            close_all(servers)


def newest_trace(host) -> dict:
    st, body = _http(host, "GET", "/debug/queries")
    tid = json.loads(body)["recent"][0]["id"]
    st, body = _http(host, "GET", f"/debug/traces/{tid}")
    assert st == 200
    return json.loads(body)


def leg_trace(host, tid):
    st, body = _http(host, "GET", f"/debug/traces/{tid}")
    assert st == 200, (host, tid)
    return json.loads(body)


def test_profiled_count_grafts_the_leg_and_merges_its_profile(pair):
    names = {}
    for pkg, (hosts, _, per_slice) in pair.items():
        st, body = _http(hosts[0], "POST", "/index/i/query?profile=true",
                         COUNT.encode())
        assert st == 200, body
        doc = json.loads(body)
        assert doc["results"] == [sum(per_slice.values())]
        peer = "http://" + hosts[1]
        remotes = doc["profile"]["remotes"]
        assert [r["host"] for r in remotes] == [peer]
        assert remotes[0]["total_us"] > 0 and "phases_us" in remotes[0]
        assert doc["profile"]["phases_us"]["fanout_remote"] > 0
        tr = newest_trace(hosts[0])
        by_id = {s["id"]: s for s in tr["spans"]}
        fanout = [s for s in tr["spans"] if s["name"] == "fanout"]
        assert [s["tags"]["node"] for s in fanout] == [hosts[1]]
        mine = [s for s in tr["spans"] if s["tags"].get("node") == peer]
        assert mine
        for s in mine:
            up = s
            while up["parent"] in by_id and up["id"] != fanout[0]["id"]:
                up = by_id[up["parent"]]
            assert up["id"] == fanout[0]["id"], s
        leg = leg_trace(hosts[1], tr["id"])
        assert sorted(s["name"] for s in mine) == sorted(
            s["name"] for s in leg["spans"])
        names[pkg] = {s["name"] for s in mine}
    assert {"query", "parse", "plan"} <= names["jax"] & names["port"]


def expected_leg_bytes(host0, host1, per_slice) -> int:
    """The newest Count's request and response bodies to the peer: the
    PQL the coordinator sent (the leg's trace holds it), the peer's
    slices of index i (replicas 1) and its partial count, through the
    wire codec (byte-equal with the JAX package's protobuf)."""
    tid = newest_trace(host0)["id"]
    query = leg_trace(host1, tid)["tags"]["query"]
    cl = Cluster([Node(host0), Node(host1)], replica_n=1)
    mine = [s for s in sorted(per_slice)
            if cl.fragment_nodes("i", s)[0].host == host1]
    req = wire.QueryRequest(query=query, slices=mine, remote=True)
    resp = wire.QueryResponse(results=[wire.result_to_proto(
        sum(per_slice[s] for s in mine))])
    return len(req.encode()) + len(resp.encode())


def http_bytes(tiers) -> int:
    return tiers.copy().get("http", 0)


def test_http_bytes_equal_between_packages_and_the_bodies(pair):
    moved = {}
    for pkg, tiers, costs in (("jax", JAX_TIER_BYTES, jax_costs),
                              ("port", TIER_BYTES, port_costs)):
        hosts, _, per_slice = pair[pkg]
        for profiled in (False, True):
            t0 = http_bytes(tiers)
            l0 = costs.LEDGER.totals()["net_http_bytes"]
            path = "/index/i/query" + ("?profile=true" if profiled else "")
            assert _http(hosts[0], "POST", path, COUNT.encode())[0] == 200
            got = (http_bytes(tiers) - t0,
                   costs.LEDGER.totals()["net_http_bytes"] - l0)
            want = expected_leg_bytes(*hosts, per_slice)
            # Exact: the bodies' bytes, in the counter and the ledger.
            assert got == (want, want), (pkg, profiled)
            moved[pkg, profiled] = got
        text = _http(hosts[0], "GET", "/metrics")[1].decode()
        assert 'pilosa_tier_bytes_total{tier="http"}' in text
        assert 'pilosa_tier_bytes_total{tier="ici"} 0' in text
    assert {k[1]: v for k, v in moved.items() if k[0] == "jax"} == \
        {k[1]: v for k, v in moved.items() if k[0] == "port"}


@pytest.mark.parametrize("pkg", PKGS)
def test_http_bytes_charge_the_ambient_account(pair, pkg, monkeypatch):
    """tests/test_costs.py's conservation test on both packages: every
    internal call charges net_http_bytes where it counts TIER_BYTES, so
    their deltas over real fan-out traffic match byte for byte, and the
    activated tenant gets its share."""
    costs, tiers, client = ((jax_costs, JAX_TIER_BYTES, JaxClient)
                            if pkg == "jax" else
                            (port_costs, TIER_BYTES, InternalClient))
    monkeypatch.setattr(costs, "LEDGER", costs.CostLedger())
    hosts = pair[pkg][0]
    cli = client(hosts[0])
    t0 = http_bytes(tiers)
    _, tok = costs.activate("gold")
    try:
        for _ in range(3):
            if pkg == "jax":
                got = cli.execute_query(None, "i", COUNT, [], remote=False)
            else:
                got = cli.execute_remote(None, "i", COUNT, [], remote=False)
            assert got == [sum(pair[pkg][2].values())]
    finally:
        costs.deactivate(tok)
    moved = http_bytes(tiers) - t0
    assert moved > 0
    assert costs.LEDGER.totals()["net_http_bytes"] == moved
    snap = costs.LEDGER.snapshot(sort="net", limit=50)
    assert sum(a["net_http_bytes"] for a in snap["accounts"]
               if a["tenant"] == "gold") > 0


# -- /debug/fleet ----------------------------------------------------------------


@pytest.fixture
def trio(tmp_path):
    hosts, servers = boot("port", tmp_path, 3,
                          configure=lambda c: setattr(
                              c, "fleet_scrape_interval", 7.0))
    yield hosts, servers
    close_all(servers)


def route_sums(servers, family) -> dict:
    out = {}
    for s in servers:
        text = s.handler.handle("GET", "/metrics").body.decode()
        for (name, labels), v in port_fleet.parse_text(text).items():
            if name == family:
                k = port_fleet.sample_key(name, labels)
                out[k] = out.get(k, 0.0) + v
    return out


def test_three_node_fleet_merges_exactly(trio):
    hosts, servers = trio
    seed_bits(hosts[0], 8)
    for _ in range(3):
        assert _http(hosts[0], "POST", "/index/i/query", COUNT.encode())[0] \
            == 200
    h = servers[0].handler
    doc = h.handle("GET", "/debug/fleet", {"force": "true"}).json()
    assert h._fleet().interval == 7.0  # [obs] fleet-scrape-interval
    assert (doc["members"], doc["scraped"], doc["healthy"]) == (3, 3, 3)
    for host in hosts:
        row = doc["nodes"][host]
        assert row["state"] == "UP" and row["error"] is None
        assert set(row) >= {"tiers", "routes", "hints", "hbm",
                            "requests_total"}
    for family in ("pilosa_query_route_total", "pilosa_query_outcome_total"):
        sums = route_sums(servers, family)
        assert sums, family
        for k, v in sums.items():
            assert doc["merged"][k] == v, k
    assert doc["merged"]['pilosa_tier_bytes_total{tier="http"}'] > 0
    # The JAX aggregator over the same scrapes builds the same keys.
    jdoc = jax_fleet.FleetAggregator(
        members=servers[0].cluster.node_states,
        fetch=h._fleet_fetch).snapshot(force=True)
    assert set(jdoc) == set(doc)
    assert {k: set(r) for k, r in jdoc["nodes"].items()} == \
        {k: set(r) for k, r in doc["nodes"].items()}
    # A closed node: its scrape fails, the pane still answers.
    servers[2].close()
    doc = h.handle("GET", "/debug/fleet", {"force": "true"}).json()
    row = doc["nodes"][hosts[2]]
    assert row["error"] is not None and doc["healthy"] == 2


def test_fleet_404_without_a_cluster_and_one_member_on_one_node(tmp_path):
    from pilosa_tpu_torch.core import Holder

    holder = Holder(str(tmp_path / "bare"))
    holder.open()
    try:
        h = build_handler(holder, "cpu", 0.0)
        resp = h.handle("GET", "/debug/fleet", {"force": "true"})
        assert (resp.status, resp.json()) == (
            404, {"error": "fleet view requires a cluster"})
    finally:
        holder.close()
    docs = {}
    for pkg in PKGS:
        c = JaxConfig() if pkg == "jax" else Config()
        c.data_dir = str(tmp_path / pkg)
        c.host = "127.0.0.1:0"
        c.use_device = "off"
        s = (JaxServer if pkg == "jax" else Server)(c)
        s.open(port=0)
        try:
            resp = s.handler.handle("GET", "/debug/fleet", {"force": "true"})
            docs[pkg] = (resp.status, resp.json())
        finally:
            s.close()
    assert docs["jax"][0] == docs["port"][0] == 200
    assert docs["jax"][1]["members"] == docs["port"][1]["members"] == 1
    assert set(docs["jax"][1]) == set(docs["port"][1])


# -- malformed record headers from a peer ----------------------------------------


class _StubPeer(http.server.ThreadingHTTPServer):
    """Answers every POST with a QueryResponse of one count and the
    headers it is given."""

    def __init__(self, headers):
        stub_headers = headers

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                self.rfile.read(int(self.headers["Content-Length"]))
                body = wire.QueryResponse(
                    results=[wire.result_to_proto(7)]).encode()
                self.send_response(200)
                self.send_header("Content-Type", wire.PROTOBUF_CT)
                for k, v in stub_headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        super().__init__(("127.0.0.1", 0), H)
        self.thread = threading.Thread(target=self.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def host(self):
        return f"127.0.0.1:{self.server_address[1]}"

    def stop(self):
        self.shutdown()
        self.server_close()


def call_leg(client_cls, trace_mod, profile_mod, host):
    """A remote leg under an active trace span and profile: (results,
    grafted spans, remote sections)."""
    tr = trace_mod.Trace("t", "query")
    prof = profile_mod.QueryProfile(backend="cpu")
    tok = profile_mod.activate(prof)
    try:
        with tr.root, trace_mod.span("fanout"):
            n0 = len(tr.spans)
            if client_cls is JaxClient:
                res = client_cls(host).execute_query(None, "i", COUNT, [0])
            else:
                res = client_cls(host).execute_remote(None, "i", COUNT, [0])
            grafted_ = tr.spans[n0:]
    finally:
        profile_mod.deactivate(tok)
    return res, grafted_, prof.to_dict().get("remotes", [])


CLIENTS = {"jax": (JaxClient, jax_trace, jax_profile),
           "port": (InternalClient, port_trace, port_profile)}


@pytest.mark.parametrize("headers", [
    {"X-Pilosa-Trace-Spans": "[{not json"},
    {"X-Pilosa-Trace-Spans": '[{"id": 1, "start_us": "late"}]'},
    {"X-Pilosa-Profile": "{not json"},
    {"X-Pilosa-Profile": "[1, 2]"},
    {"X-Pilosa-Trace-Spans": "]", "X-Pilosa-Profile": "]"},
], ids=["spans-json", "spans-types", "profile-json", "profile-list",
        "both"])
@pytest.mark.parametrize("pkg", PKGS)
def test_malformed_record_headers_fail_no_query(pkg, headers):
    peer = _StubPeer(headers)
    try:
        res, spans, remotes = call_leg(*CLIENTS[pkg], peer.host)
    finally:
        peer.stop()
    assert res == [7]
    assert all(sp.name != "id" for sp in spans)
    if "X-Pilosa-Profile" in headers:
        assert remotes == []


@pytest.mark.parametrize("pkg", PKGS)
def test_span_list_of_non_objects_escapes_both_clients(pkg):
    """Observed in the reference (ROADMAP C): the clients catch
    (ValueError, KeyError, TypeError) around the graft, and a span list
    of numbers raises AttributeError (`d.get`), which fails the leg."""
    peer = _StubPeer({"X-Pilosa-Trace-Spans": "[1, 2]"})
    try:
        with pytest.raises(AttributeError):
            call_leg(*CLIENTS[pkg], peer.host)
    finally:
        peer.stop()


# -- a leg in flight at a closing node ---------------------------------------------


@pytest.mark.parametrize("query", [COUNT, "TopN(frame=f, n=2)"],
                         ids=["count", "topn"])
@pytest.mark.parametrize("pkg", PKGS)
def test_a_leg_in_flight_at_a_closing_node_fails_its_query(pkg, query,
                                                           tmp_path):
    """Observed in the reference (ROADMAP C): a remote leg still running
    when its node closes meets a holder with no index, and the
    coordinator answers 400, in both packages: {"error": "index not
    found"} for the Count in both, and for the TopN in the port (its leg
    failed with an AttributeError in Executor._num_slices before); the
    JAX TopN's answer names the node gone (connection refused).
    The leg is held in the handler.query seam while its node closes."""
    import time

    from pilosa_tpu import fault as jax_fault
    from pilosa_tpu_torch import fault as port_fault

    hosts, servers = boot(pkg, tmp_path, 2)
    try:
        seed_bits(hosts[0], 6)
        if pkg == "jax":
            jax_fault.arm("handler.query", delay=1.0, match={"remote": True})
        else:
            port_fault.arm("handler.query", delay=1.0, remote=True)
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "r", _http(hosts[0], "POST", "/index/i/query", query.encode())))
        t.start()
        time.sleep(0.3)
        servers[1].close()
        t.join()
    finally:
        jax_fault.reset()
        port_fault.reset()
        close_all(servers)
    assert out["r"][0] == 400
    if query == COUNT or pkg == "port":
        assert out["r"][1] == b'{"error": "index not found"}\n'


# -- the header-size question ----------------------------------------------------

LINE_LIMIT = 65_536  # http.client's _MAXLINE: a longer header line raises


@pytest.mark.parametrize("route", ["card", "host-fold"])
@pytest.mark.parametrize("pkg", PKGS)
def test_a_240_slice_leg_stays_under_the_header_line(pkg, route, tmp_path):
    """Two nodes, replicas 1, 384 slices: node 0 owns 240 of them, the
    leg node 1 sends it. Its span list does not grow with the slices (a
    handful of spans a call), and its profile's per-slice rows stop at
    256, so both headers stay far under the 65,536-byte line that
    http.client refuses, in both packages, on each route."""
    def configure(c):
        if pkg == "jax":
            c.use_device = "on"  # its device path, on the CPU

    # Cost routing sends every Count to the host fold, or none.
    hosts, servers = boot(pkg, tmp_path, 2, configure=configure,
                          min_work=1 << 30 if route == "host-fold" else 0)
    try:
        seed_bits(hosts[1], 384, bits=1)
        st, body = _http(hosts[1], "POST", "/index/i/query?profile=true",
                         COUNT.encode())
        assert st == 200
        doc = json.loads(body)
        tid = newest_trace(hosts[1])["id"]
        leg = leg_trace(hosts[0], tid)
    finally:
        close_all(servers)
    plan = next(s for s in leg["spans"] if s["name"] == "plan")
    assert plan["tags"]["slices"] == 240
    assert (plan["tags"]["route"] == "host-fold") == (route == "host-fold")
    spans = json.dumps(leg["spans"], separators=(",", ":"))
    prof = json.dumps(doc["profile"]["remotes"][0], separators=(",", ":"))
    assert 4 <= len(leg["spans"]) <= 8, [s["name"] for s in leg["spans"]]
    assert len(spans) < 2_048
    assert len(prof) < LINE_LIMIT // 4
    assert len(doc["profile"]["remotes"][0].get("slices", [])) <= 256
