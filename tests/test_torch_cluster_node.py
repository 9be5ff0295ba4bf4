"""Live clusters of both packages on loopback, side by side.

A three-node cluster at replicas = 2 and a four-node one at replicas = 3
of each package (every node an in-process Server: the port's with
use-device = "off", so its kernels run their plain versions on the CPU)
take one seeded stream through every coordinator in turn: schema
creates and deletes (broadcast to the peers), SetBit, ClearBit,
SetValue, SetRowAttrs and SetColumnAttrs, Count trees, Bitmap results
with their attrs, TopN in three forms, Sum / Min / Max, and /import
(the owner lookup, 412 on a non-owner, the copy to the other owners).
Placement depends only on a host's position in `hosts`, so both
clusters list their hosts in one order and every answer is compared by
position. Then the node at one position closes in both: the answers
stay equal, the writes answer the same statuses (200 while quorum
holds) and each node holds the same hint backlog; it reopens from its
data dir, the others see it (status poll, breaker close), drain, and
every coordinator and the reopened node's own remote legs answer as
before, with the writes made while it was down. Daemons are off
(polling and drain intervals of an hour, breaker cooldown too): the
test calls the ticks itself. Ports are chosen free first; a start that
finds one taken retries once with fresh ones.

Also: a four-host type = "http" TOML opens a node; gossip, spmd and
ici-hosts are refused, naming the key; /status, /hosts and
/fragment/nodes equal the JAX handler's for the same cluster.
"""

import errno
import json
import random
import re
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.config import Config as JaxConfig
from pilosa_tpu.server import Server as JaxServer

from pilosa_tpu_torch import SLICE_WIDTH, wire
from pilosa_tpu_torch.api.client import InternalClient
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.server import NOT_ACTED_ON, Server
from torch_threads import one_torch_thread  # noqa: F401

PKGS = ("jax", "port")
SLICES = 6


def _free_ports(n):
    """n free loopback ports below the kernel's ephemeral range: once a
    node closes, a port inside it can become the source port of a peer's
    outgoing connection, and the node could not bind it again."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        lo = 32768
    rng = random.Random()
    out = []
    while len(out) < n:
        p = rng.randrange(max(1024, lo - 12000), lo)
        if p in out:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", p))
            except OSError:
                continue
        out.append(p)
    return out


def _config(pkg, tmp, hosts, i, replicas):
    c = JaxConfig() if pkg == "jax" else Config()
    c.data_dir = str(tmp / f"{pkg}{i}")
    c.host = hosts[i]
    c.cluster_hosts = list(hosts)
    c.replica_n = replicas
    c.write_consistency = "quorum"
    c.use_device = "off"
    c.hint_drain_interval = 3600.0
    c.polling_interval = 3600.0
    c.anti_entropy_interval = 3600.0
    c.breaker_cooldown = 3600.0
    c.retry_backoff = 0.002
    c.client_timeout = 10.0
    return c


def _boot(pkg, tmp, hosts, i, replicas):
    s = (JaxServer if pkg == "jax" else Server)(
        _config(pkg, tmp, hosts, i, replicas))
    s.open()
    return s


def _start(tmp, n, replicas):
    """{pkg: (hosts, servers)}, retrying once with fresh ports when one
    was taken meanwhile (parallel test workers bind ports too)."""
    for attempt in range(2):
        ports = _free_ports(2 * n)
        out, started = {}, []
        try:
            for k, pkg in enumerate(PKGS):
                hosts = [f"127.0.0.1:{p}" for p in ports[k * n:(k + 1) * n]]
                servers = []
                for i in range(n):
                    servers.append(_boot(pkg, tmp, hosts, i, replicas))
                    started.append(servers[-1])
                out[pkg] = (hosts, servers)
            return out
        except OSError as e:
            for s in started:
                s.close()
            if e.errno != errno.EADDRINUSE or attempt:
                raise
    raise AssertionError("unreachable")


def _http(host, method, path, body=b"", headers=None):
    req = urllib.request.Request(f"http://{host}{path}", data=body or None,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _positions(text, hosts):
    for i, h in enumerate(hosts):
        text = text.replace(h, f"node{i}")
    return text


class Pair:
    """Both clusters, driven alike: each call goes to the coordinator at
    one position in each, and the answers come back by position."""

    def __init__(self, clusters):
        self.c = clusters

    def call(self, pos, method, path, body=b"", headers=None):
        outs = []
        for pkg in PKGS:
            hosts, _ = self.c[pkg]
            status, data = _http(hosts[pos], method, path, body, headers)
            outs.append((status, _positions(data.decode(errors="replace"),
                                            hosts)))
        return outs

    def same(self, pos, method, path, body=b"", headers=None, status=200):
        (js, jb), (ps, pb_) = self.call(pos, method, path, body, headers)
        assert js == ps == status, (path, body, js, jb, ps, pb_)
        if jb.strip().startswith(("{", "[")):
            assert json.loads(jb) == json.loads(pb_), (path, body)
        return ps, pb_

    def query(self, pos, pql, params=""):
        _, body = self.same(pos, "POST", f"/index/c/query{params}",
                            pql.encode())
        return json.loads(body)

    def servers(self, pkg):
        return self.c[pkg][1]

    def close(self):
        for pkg in PKGS:
            for s in self.servers(pkg):
                if s is not None:
                    try:
                        s.close()
                    except Exception:  # noqa: BLE001
                        pass


def _bits(seed):
    """Row r holds max(1, 4 - r) columns a slice: every slice ranks the
    rows alike, so each node's TopN candidates are the cluster's."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(SLICES):
        for r in range(6):
            for c in rng.choice(SLICE_WIDTH, max(1, 4 - r), replace=False):
                out.append((r, s * SLICE_WIDTH + int(c)))
    rng.shuffle(out)
    return out


READS = [
    "Count(Bitmap(rowID=0, frame=f))",
    "Count(Intersect(Bitmap(rowID=0, frame=f), Bitmap(rowID=1, frame=f)))",
    "Count(Union(Bitmap(rowID=2, frame=f), Bitmap(rowID=3, frame=f)))",
    "Count(Difference(Bitmap(rowID=0, frame=f), Bitmap(rowID=3, frame=f)))",
    "Count(Bitmap(rowID=7, frame=f))",
    "Bitmap(rowID=1, frame=f)",
    "Union(Bitmap(rowID=4, frame=f), Bitmap(rowID=5, frame=f))",
    "TopN(frame=f, n=3)",
    "TopN(frame=f, ids=[0, 2, 4])",
    "TopN(Bitmap(rowID=0, frame=g), frame=f, n=2)",
    'Sum(frame=g, field="v")',
    'Min(frame=g, field="v")',
    'Max(frame=g, field="v")',
    'Sum(Bitmap(rowID=0, frame=g), frame=g, field="v")',
]


def _reads(pair, coords):
    out = []
    for pos in coords:
        for q in READS:
            out.append(pair.query(pos, q))
        out.append(pair.query(pos, "Bitmap(rowID=1, frame=f)",
                              "?columnAttrs=true"))
    return out


def _import(pair, slice_, rows, cols, live):
    """/import of one slice: to a live non-owner (412 in both), then to
    its first live owner by /fragment/nodes."""
    body = wire.ImportRequest(index="c", frame="f", slice=slice_,
                              row_ids=rows, column_ids=cols).encode()
    hdr = {"Content-Type": wire.PROTOBUF_CT}
    _, nodes = pair.same(live[0], "GET", f"/fragment/nodes?index=c&slice="
                         f"{slice_}")
    owners = [int(n["host"][4:]) for n in json.loads(nodes)]
    stranger = [p for p in live if p not in owners]
    if stranger:
        pair.same(stranger[0], "POST", "/import", body, hdr, status=412)
    target = [p for p in owners if p in live][0]
    return owners, pair.call(target, "POST", "/import", body, hdr)


@pytest.mark.parametrize("n,replicas", [(3, 2), (4, 3)])
def test_both_clusters_answer_alike_through_every_coordinator(tmp_path, n,
                                                              replicas):
    pair = Pair(_start(tmp_path, n, replicas))
    try:
        _stream(pair, n, replicas, tmp_path)
    finally:
        pair.close()


def _stream(pair, n, replicas, tmp):
    coords = list(range(n))
    # Schema: every create and delete reaches the peers.
    pair.same(0, "POST", "/index/c", b"{}")
    pair.same(1, "POST", "/index/c/frame/f", b"{}")
    pair.same(n - 1, "POST", "/index/c/frame/g", json.dumps(
        {"options": {"fields": [{"name": "v", "min": -100,
                                 "max": 1000}]}}).encode())
    pair.same(0, "POST", "/index/gone", b"{}")
    pair.same(1, "POST", "/index/c/frame/tmp", b"{}")
    pair.same(n - 1, "DELETE", "/index/c/frame/tmp")
    pair.same(1, "DELETE", "/index/gone")
    for pos in coords:
        _, schema = pair.same(pos, "GET", "/schema")
        names = [(i["name"], [f["name"] for f in i["frames"]])
                 for i in json.loads(schema)["indexes"]]
        assert names == [("c", ["f", "g"])]
    # Writes through every coordinator in turn.
    bits = _bits(n)
    for k, (r, c) in enumerate(bits):
        out = pair.query(k % n, f"SetBit(rowID={r}, frame=f, columnID={c})")
        assert out == {"results": [True]}
    for k, (r, c) in enumerate(bits[:6]):
        pair.query((k + 1) % n, f"ClearBit(rowID={r}, frame=f, "
                   f"columnID={c})")
    rng = np.random.default_rng(n + 100)
    for k, c in enumerate(rng.integers(0, SLICES * SLICE_WIDTH, 12)):
        pair.query(k % n, f"SetValue(frame=g, columnID={int(c)}, "
                   f"v={int(rng.integers(-100, 1000))})")
        pair.query(k % n, f"SetBit(rowID={k % 2}, frame=g, "
                   f"columnID={int(c)})")
    pair.query(1, 'SetRowAttrs(frame=f, rowID=1, color="red", n=3)')
    col = bits[10][1]
    pair.query(n - 1, f'SetColumnAttrs(id={col}, name="x")')
    # An import over two slices.
    for s in (1, 4):
        cols = [s * SLICE_WIDTH + c for c in (3, 5, 900, 77777)]
        owners, outs = _import(pair, s, [7] * len(cols), cols, coords)
        assert [st for st, _ in outs] == [200, 200]
    before = _reads(pair, coords)
    row0 = {c for r, c in bits if r == 0} - {c for r, c in bits[:6]
                                             if r == 0}
    assert before[0]["results"][0] == len(row0)
    assert before[4]["results"][0] == 8  # the imported row
    attrs = before[READS.index("Bitmap(rowID=1, frame=f)")]
    assert attrs["results"][0]["attrs"] == {"color": "red", "n": 3}
    assert before[0] == before[len(READS) + 1]  # every coordinator alike

    # The node at position `down` closes in both clusters.
    down = n - 1
    for pkg in PKGS:
        pair.servers(pkg)[down].close()
    live = [p for p in coords if p != down]
    assert _reads(pair, live) == [x for k, x in enumerate(before)
                                  if k // (len(READS) + 1) != down]
    statuses = []
    extra = []
    for k in range(10):
        s = k % SLICES
        c = s * SLICE_WIDTH + 500000 + k
        extra.append((6, c))
        outs = pair.call(live[k % len(live)], "POST", "/index/c/query",
                         f"SetBit(rowID=6, frame=f, columnID={c})".encode())
        assert outs[0][0] == outs[1][0], outs
        statuses.append(outs[1][0])
    cols = [2 * SLICE_WIDTH + c for c in (11, 12)]
    _, outs = _import(pair, 2, [8, 8], cols, live)
    assert outs[0][0] == outs[1][0]
    backlog = {pkg: [pair.servers(pkg)[p].hints.backlog_records()
                     for p in live] for pkg in PKGS}
    assert backlog["jax"] == backlog["port"]
    assert set(statuses) <= {200, 503}
    if replicas == 3:  # quorum holds with one owner down: acked, hinted
        assert set(statuses) == {200} and sum(backlog["port"]) > 0
    written = {c for (r, c), st in zip(extra, statuses) if st == 200}
    got = pair.query(0, "Bitmap(rowID=6, frame=f)")["results"][0]["bits"]
    assert written <= set(got) <= {c for _, c in extra}

    # It comes back; the others see it, drain, and it answers as they do.
    for pkg in PKGS:
        hosts, servers = pair.c[pkg]
        servers[down] = _boot(pkg, tmp, hosts, down, replicas)
        for p in live:
            srv = servers[p]
            srv._status_poll_tick()
            srv.client.breakers.for_host(hosts[down]).record_success()
            assert srv.hints.wait_drained(30)
        servers[down]._status_poll_tick()
    after = _reads(pair, coords)
    g = len(READS) + 1
    assert after[:g] == after[-g:] == before[:g]
    again = pair.query(down, "Bitmap(rowID=6, frame=f)")["results"][0]
    assert sorted(again["bits"]) == sorted(got)
    hosts = pair.c["port"][0]
    for s in range(SLICES):
        _, nodes = pair.same(0, "GET", f"/fragment/nodes?index=c&slice={s}")
        owners = [hosts[int(x["host"][4:])] for x in json.loads(nodes)]
        legs = {h: InternalClient(h).execute_remote(
            None, "c", "Count(Bitmap(rowID=6, frame=f))", [s])
            for h in owners}
        assert len(set(map(tuple, legs.values()))) == 1, (s, legs)
    for pkg in PKGS:
        assert [s.hints.backlog_records() for s in pair.servers(pkg)] == \
            [0] * n


def test_status_hosts_and_fragment_nodes_equal_the_jax_package(tmp_path):
    pair = Pair(_start(tmp_path, 3, 2))
    try:
        pair.same(0, "POST", "/index/c", b"{}")
        pair.same(0, "POST", "/index/c/frame/f", b"{}")
        for pos, s in enumerate((0, 2, 5)):
            pair.query(pos, f"SetBit(rowID=1, frame=f, "
                       f"columnID={s * SLICE_WIDTH + 3})")
        for pkg in PKGS:
            for srv in pair.servers(pkg):
                srv._status_poll_tick()
        for pos in range(3):
            pair.query(pos, "Count(Bitmap(rowID=1, frame=f))")
            _, body = pair.same(pos, "GET", "/status")
            nodes = json.loads(body)["nodes"]
            assert [x["host"] for x in nodes][0] == f"node{pos}"
            assert {x["indexes"][0]["maxSlice"] for x in nodes} == {5}
            pair.same(pos, "GET", "/hosts")
            for s in range(8):
                pair.same(pos, "GET", f"/fragment/nodes?index=c&slice={s}")
            _, vars_ = pair.call(pos, "GET", "/debug/vars")[1]
            assert json.loads(vars_)["cluster"]["members"] == {
                f"node{i}": "UP" for i in range(3)}
            _, max_ = pair.same(pos, "GET", "/slices/max")
            assert json.loads(max_) == {"maxSlices": {"c": 5}}
        # /internal/status is the NodeStatus protobuf in both.
        for pkg in PKGS:
            hosts, _ = pair.c[pkg]
            st = InternalClient(hosts[1]).node_status()
            assert st.host == hosts[1] and st.indexes[0].max_slice == 5
        _, metrics = pair.call(0, "GET", "/metrics")[1]
        for fam in ("pilosa_member_state", "pilosa_write_consistency_total",
                    "pilosa_breaker_state"):
            assert f"# TYPE {fam} " in metrics
        assert re.search(r'pilosa_query_route_total\{backend="[a-z-]+",'
                         r'tier="http"\}', metrics)
    finally:
        pair.close()


def test_a_four_host_http_config_opens(tmp_path):
    ports = _free_ports(4)
    hosts = ", ".join(f'"127.0.0.1:{p}"' for p in ports)
    text = (f'data-dir = "{tmp_path / "d"}"\nhost = "127.0.0.1:{ports[0]}"\n'
            f'use-device = "off"\n[cluster]\ntype = "http"\n'
            f"hosts = [{hosts}]\nreplicas = 3\n"
            f'polling-interval = "1h"\nhint-drain-interval = "1h"\n')
    cfg = Config.from_toml(text, is_text=True)
    jcfg = JaxConfig.from_toml(text, is_text=True)
    assert (cfg.cluster_hosts, cfg.replica_n) == (jcfg.cluster_hosts,
                                                   jcfg.replica_n)
    s = Server(cfg)
    s.open()
    try:
        assert len(s.cluster.nodes) == 4 and s.hints is not None
        status, body = _http(s.host, "GET", "/hosts")
        assert status == 200 and [h["host"] for h in json.loads(body)] == [
            f"127.0.0.1:{p}" for p in ports]
        assert _http(s.host, "GET", "/readyz")[0] == 200
        # Creating an index broadcasts to three peers that are not up.
        assert _http(s.host, "POST", "/index/i", b"{}")[0] == 500
    finally:
        s.close()
    text_all = " ".join(NOT_ACTED_ON)
    for key in ("client-timeout", "retries", "retry-backoff", "breaker",
                "prefer-local-reads", "write-consistency", "hint-",
                "polling-interval", "timeouts"):
        assert key not in text_all


@pytest.mark.parametrize("key,toml,roadmap", [
    ('type = "gossip"', '[cluster]\ntype = "gossip"\n', "A11c"),
    ('type = "spmd"', '[cluster]\ntype = "spmd"\n', "A11d"),
    ("ici-hosts", '[cluster]\nici-hosts = ["c:3"]\n', "A11d"),
])
def test_clusters_still_to_come_are_refused(tmp_path, key, toml, roadmap):
    cfg = Config.from_toml(f'data-dir = "{tmp_path}"\nuse-device = "off"\n'
                           + toml, is_text=True)
    with pytest.raises(ValueError) as err:
        Server(cfg)
    assert key in str(err.value) and roadmap in str(err.value)
