"""The port's cluster layer against the JAX package's, without a network:
placement (fnv64a, partition, fragment_nodes, owns_slices over seeded
(index, slice) pairs, 1-6 nodes, 1-3 replicas, the same host strings),
the wire's new messages byte for byte against `pilosa_pb2` both ways,
the circuit breaker's state trace under one sequence of outcomes, the
client's retries of transient failures only, and the executor's fan-out
with the JAX package's fake clients (tests/test_executor.py:178-260):
forward, fail over to a replica, no replica raises, `remote` restricts
to local, SetBit routed to the replicas; and beyond them quorum, one and
all with a DOWN owner, `partial` with its missing_slices, the TopN and
Sum / Min / Max reduces, and explain's placement. Every answer is exact
(tolerance 0: bits and counts are integers). Every executor runs with
device="cpu".
"""

import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from pilosa_tpu.api import client as jax_client_mod
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import ExecOptions as JaxExecOptions
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.parallel import cluster as jax_cluster
from pilosa_tpu.parallel.hints import HintManager as JaxHintManager
from pilosa_tpu.pql import parse_string as jax_parse
from pilosa_tpu.wire import marshal_message as jax_marshal
from pilosa_tpu.wire import pb
from pilosa_tpu.wire import result_to_proto as jax_result_to_proto
from pilosa_tpu.wire import unmarshal_message as jax_unmarshal

from pilosa_tpu_torch import SLICE_WIDTH, fault, wire
from pilosa_tpu_torch.api import client as port_client_mod
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.errors import SliceUnavailableError, \
    WriteConsistencyError
from pilosa_tpu_torch.executor import ExecOptions, Executor, required_acks
from pilosa_tpu_torch.parallel import cluster as port_cluster
from pilosa_tpu_torch.parallel.hints import HintManager
from pilosa_tpu_torch.pql import parse_string
from torch_threads import one_torch_thread  # noqa: F401

# -- placement -------------------------------------------------------------------


def test_fnv64a_vectors():
    for data, want in ((b"", 0xCBF29CE484222325), (b"a", 0xAF63DC4C8601EC8C),
                       (b"foobar", 0x85944171F73967E8)):
        assert port_cluster.fnv64a(data) == want == jax_cluster.fnv64a(data)
    rng = np.random.default_rng(1)
    for _ in range(50):
        data = rng.bytes(int(rng.integers(0, 40)))
        assert port_cluster.fnv64a(data) == jax_cluster.fnv64a(data)


@pytest.mark.parametrize("n_nodes", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_placement_equals_the_jax_package(n_nodes, replicas):
    hosts = [f"127.0.0.1:{10101 + 7 * i}" for i in range(n_nodes)]
    pc = port_cluster.Cluster([port_cluster.Node(h) for h in hosts],
                              replica_n=replicas)
    jc = jax_cluster.Cluster([jax_cluster.Node(h) for h in hosts],
                             replica_n=replicas)
    rng = np.random.default_rng(n_nodes * 10 + replicas)
    for _ in range(200):
        index = "".join(rng.choice(list("abcdefgh"), int(rng.integers(1, 8))))
        s = int(rng.integers(0, 5000))
        assert pc.partition(index, s) == jc.partition(index, s)
        assert ([n.host for n in pc.fragment_nodes(index, s)]
                == [n.host for n in jc.fragment_nodes(index, s)])
        assert (pc.owns_fragment(hosts[0], index, s)
                == jc.owns_fragment(hosts[0], index, s))
    for h in hosts:
        assert pc.owns_slices("i", 300, h) == jc.owns_slices("i", 300, h)
    for p in range(pc.partition_n):
        assert ([n.host for n in pc.partition_nodes(p)]
                == [n.host for n in jc.partition_nodes(p)])


def test_hashers_and_states_equal_the_jax_package():
    for key in (0, 1, 2, 1 << 40, (1 << 64) - 1, 12345):
        for n in (1, 2, 7, 16):
            assert (port_cluster.JmpHasher().hash(key, n)
                    == jax_cluster.JmpHasher().hash(key, n))
            assert (port_cluster.ModHasher().hash(key, n)
                    == jax_cluster.ModHasher().hash(key, n))
    assert port_cluster.ConstHasher(3).hash(9, 5) == 3
    for state in ("UP", "DOWN", "JOINING", "LEAVING"):
        for to in ("UP", "DOWN", "JOINING", "LEAVING"):
            pn = port_cluster.Node("h", state=state)
            jn = jax_cluster.Node("h", state=state)
            outs = []
            for node in (pn, jn):
                try:
                    node.transition(to)
                    outs.append(node.state)
                except ValueError:
                    outs.append("illegal")
            assert outs[0] == outs[1], (state, to)
    pc = port_cluster.Cluster([port_cluster.Node("a"),
                               port_cluster.Node("b")])
    assert pc.mark_unreachable("b") and not pc.mark_unreachable("b")
    assert pc.node_states() == {"a": "UP", "b": "DOWN"}
    assert pc.mark_live("b") and not pc.mark_live("b")
    assert pc.status() == {"nodes": [{"host": "a", "state": "UP"},
                                     {"host": "b", "state": "UP"}]}


def test_preferred_owner_and_tier_equal_the_jax_package():
    rng = random.Random(5)
    states = ("UP", "DOWN", "LEAVING")
    for _ in range(300):
        k = rng.randint(1, 3)
        spec = [(f"h{i}", rng.choice(states), rng.choice(("closed", "open")))
                for i in range(k)]
        prefer = rng.choice([None, "h0", "h1"])
        po = [port_cluster.Node(h, state=s) for h, s, _ in spec]
        jo = [jax_cluster.Node(h, state=s) for h, s, _ in spec]
        br = {h: b for h, _, b in spec}
        assert (port_cluster.preferred_owner(po, br.get, prefer).host
                == jax_cluster.preferred_owner(jo, br.get, prefer).host)
        assert (port_cluster.preferred_owner(po, None, prefer).host
                == jax_cluster.preferred_owner(jo, None, prefer).host)
    for host in ("a:1", "b:2"):
        assert (port_cluster.owner_tier(host, "a:1")
                == jax_cluster.owner_tier(host, "a:1"))


# -- the wire ------------------------------------------------------------------------


def _jax_row(cols, attrs):
    from pilosa_tpu.core.row import Row as JaxRow

    r = JaxRow(cols)
    r.attrs = dict(attrs)
    return r


RESULTS = [
    ("row", [], {}), ("row", [0, 5, SLICE_WIDTH * 3 + 7],
                      {"a": 1, "b": "x", "c": True, "d": 2.5, "e": -3}),
    ("v", 0), ("v", 12345678901), ("v", True), ("v", False), ("v", []),
    ("v", [(3, 40), (1, 2)]), ("v", None),
    ("v", {"value": -17, "count": 3}), ("v", {"value": 2 ** 40, "count": 0}),
]


@pytest.mark.parametrize("case", RESULTS, ids=[str(i) for i in
                                                range(len(RESULTS))])
def test_query_results_equal_pb2_both_ways(case):
    if case[0] == "row":
        port_v = Row.from_columns(case[1])
        port_v.attrs = dict(case[2])
        jax_v = _jax_row(case[1], case[2])
    else:
        port_v = jax_v = case[1]
    got = wire.result_to_proto(port_v).encode()
    want = jax_result_to_proto(jax_v).SerializeToString()
    assert got == want
    back = wire.result_from_proto(wire.QueryResult.decode(want))
    if case[0] == "row":
        assert back.columns().tolist() == sorted(case[1])
        assert back.attrs == case[2]
    else:
        assert back == case[1] and type(back) is type(case[1])
    resp = wire.QueryResponse(err="", results=[wire.result_to_proto(port_v)],
                              column_attr_sets=[wire.ColumnAttrSet(
                                  id=9, attrs=wire.attrs_to_proto(
                                      {"k": "v", "n": 2}))])
    jresp = pb.QueryResponse()
    jresp.results.append(jax_result_to_proto(jax_v))
    cs = jresp.column_attr_sets.add()
    cs.id = 9
    cs.attrs.extend([pb.Attr(key="k", kind=1, string_value="v"),
                     pb.Attr(key="n", kind=2, int_value=2)])
    assert resp.encode() == jresp.SerializeToString()
    parsed = pb.QueryResponse()
    parsed.ParseFromString(resp.encode())
    assert parsed == jresp


@pytest.mark.parametrize("seed", range(6))
def test_query_request_and_error_equal_pb2(seed):
    rng = np.random.default_rng(seed)
    slices = rng.integers(0, 2000, int(rng.integers(0, 20))).tolist()
    query = "Count(Bitmap(rowID=%d, frame=\"f\"))" % seed
    for remote in (False, True):
        for col_attrs in (False, True):
            port = wire.QueryRequest(query=query, slices=slices,
                                     column_attrs=col_attrs, remote=remote)
            jax = pb.QueryRequest(query=query, slices=slices,
                                  column_attrs=col_attrs, remote=remote)
            assert port.encode() == jax.SerializeToString()
            back = wire.QueryRequest.decode(jax.SerializeToString())
            assert (back.query, back.slices.tolist(), back.remote,
                    back.column_attrs) == (query, slices, remote, col_attrs)
    err = "index not found"
    assert (wire.QueryResponse(err=err).encode()
            == pb.QueryResponse(err=err).SerializeToString())


def _status_pair(seed):
    rng = np.random.default_rng(seed)
    port = wire.NodeStatus(host=f"h{seed}:1", state="UP")
    jax = pb.NodeStatus(host=f"h{seed}:1", state="UP")
    for i in range(int(rng.integers(0, 4))):
        max_slice, inv = int(rng.integers(0, 999)), int(rng.integers(0, 9))
        pframes = []
        ji = jax.indexes.add()
        ji.name = f"i{i}"
        ji.meta.column_label = "columnID" if i % 2 else ""
        ji.meta.time_quantum = "YMD" if i == 1 else ""
        ji.max_slice = max_slice
        ji.max_inverse_slice = inv
        for k in range(int(rng.integers(0, 3))):
            jf = ji.frames.add()
            jf.name = f"f{k}"
            jf.meta.row_label = "rowID"
            jf.meta.inverse_enabled = bool(k % 2)
            jf.meta.cache_type = "ranked"
            jf.meta.cache_size = 50000
            jf.meta.fields_json = '[{"name": "v"}]' if k == 1 else ""
            pframes.append(wire.FrameInfo(name=f"f{k}", meta=wire.FrameMeta(
                row_label="rowID", inverse_enabled=bool(k % 2),
                cache_type="ranked", cache_size=50000,
                fields_json='[{"name": "v"}]' if k == 1 else "")))
        port.indexes.append(wire.IndexInfo(
            name=f"i{i}", meta=wire.IndexMeta(
                column_label="columnID" if i % 2 else "",
                time_quantum="YMD" if i == 1 else ""),
            max_slice=max_slice, frames=pframes, max_inverse_slice=inv))
    return port, jax


@pytest.mark.parametrize("seed", range(5))
def test_status_messages_equal_pb2_both_ways(seed):
    port, jax = _status_pair(seed)
    assert port.encode() == jax.SerializeToString()
    assert wire.NodeStatus.decode(jax.SerializeToString()) == port
    other, jother = _status_pair(seed + 10)
    cs = wire.ClusterStatus(nodes=[port, other])
    jcs = pb.ClusterStatus()
    jcs.nodes.extend([jax, jother])
    assert cs.encode() == jcs.SerializeToString()
    assert wire.ClusterStatus.decode(jcs.SerializeToString()) == cs


BROADCASTS = [
    (wire.CreateSliceMessage(index="i", slice=959, is_inverse=False),
     pb.CreateSliceMessage(index="i", slice=959)),
    (wire.CreateSliceMessage(index="i", slice=3, is_inverse=True),
     pb.CreateSliceMessage(index="i", slice=3, is_inverse=True)),
    (wire.CreateIndexMessage(index="i", meta=wire.IndexMeta(
        column_label="columnID", time_quantum="YM")),
     pb.CreateIndexMessage(index="i", meta=pb.IndexMeta(
         column_label="columnID", time_quantum="YM"))),
    (wire.CreateIndexMessage(index="j", meta=wire.IndexMeta()),
     pb.CreateIndexMessage(index="j", meta=pb.IndexMeta())),
    (wire.DeleteIndexMessage(index="i"), pb.DeleteIndexMessage(index="i")),
    (wire.CreateFrameMessage(index="i", frame="f", meta=wire.FrameMeta(
        row_label="r", inverse_enabled=True, cache_type="lru",
        cache_size=7, time_quantum="D",
        fields_json='[{"max": 9, "min": -1, "name": "v"}]')),
     pb.CreateFrameMessage(index="i", frame="f", meta=pb.FrameMeta(
         row_label="r", inverse_enabled=True, cache_type="lru",
         cache_size=7, time_quantum="D",
         fields_json='[{"max": 9, "min": -1, "name": "v"}]'))),
    (wire.DeleteFrameMessage(index="i", frame="f"),
     pb.DeleteFrameMessage(index="i", frame="f")),
]


@pytest.mark.parametrize("i", range(len(BROADCASTS)))
def test_broadcast_framing_equals_the_jax_package(i):
    port, jax = BROADCASTS[i]
    data = jax_marshal(jax)
    assert wire.marshal_message(port) == data
    assert wire.unmarshal_message(data) == port
    assert jax_unmarshal(wire.marshal_message(port)) == jax
    with pytest.raises(ValueError):
        wire.unmarshal_message(b"")
    with pytest.raises(ValueError):
        wire.unmarshal_message(b"\x09" + data[1:])


# -- breakers and retries ------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_breaker_state_trace_equals_the_jax_package(seed, monkeypatch):
    """One seeded sequence of allow / success / failure / time steps
    through both breakers (the clock faked in both modules) gives the
    same state after every step, the same rejections and the same
    open / close callbacks."""
    now = [1000.0]
    for mod in (jax_client_mod, port_client_mod):
        monkeypatch.setattr(mod.time, "monotonic", lambda: now[0])
    seen = ([], [])
    brs = (jax_client_mod.CircuitBreaker(
        "h", threshold=3, cooldown=5.0, stats=jax_client_mod.STATS.__class__(),
        on_change=lambda h, s: seen[0].append(s)),
        port_client_mod.CircuitBreaker(
            "h", threshold=3, cooldown=5.0,
            stats=port_client_mod.STATS.__class__(),
            on_change=lambda h, s: seen[1].append(s)))
    rng = random.Random(seed)
    for _ in range(200):
        op = rng.choice(("allow", "ok", "fail", "fail", "tick"))
        outs = ([], [])
        for b, out in zip(brs, outs):
            if op == "allow":
                try:
                    b.allow()
                    out.append("allowed")
                except Exception as e:  # noqa: BLE001
                    assert e.transient
                    out.append("rejected")
            elif op == "ok":
                b.record_success()
            elif op == "fail":
                b.record_failure()
            out.append(b.state)
        if op == "tick":
            now[0] += rng.choice((1.0, 6.0))
        assert outs[0] == outs[1], op
    assert seen[0] == seen[1]
    assert brs[0].stats.copy() == brs[1].stats.copy()


def test_registry_shares_one_policy_and_hook():
    calls = []
    reg = port_client_mod.BreakerRegistry(threshold=1, cooldown=60)
    reg.on_change = lambda h, s: calls.append((h, s))
    reg.for_host("a").record_failure()
    assert reg.state("a") == "open" and reg.state("b") == "closed"
    assert reg.snapshot() == {"a": "open"}
    reg.for_host("a").record_success()
    assert calls == [("a", "open"), ("a", "closed")]


class _Flaky(BaseHTTPRequestHandler):
    """Answers 503 `fails` times, then 200 (or always `status`)."""

    plan: list = []

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        code = self.plan.pop(0) if self.plan else 200
        body = b'{"error": "x"}' if code >= 400 else b"{}"
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture
def flaky():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Flaky)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def test_client_retries_transient_failures_only(flaky):
    stats = port_client_mod.STATS.__class__()
    c = port_client_mod.InternalClient(flaky, retry_max=2,
                                       retry_backoff=0.001, stats=stats,
                                       rand=random.Random(0))
    _Flaky.plan[:] = [503, 502]
    assert c._do("POST", "/x", body=b"a")[0] == 200
    assert stats.copy() == {"client.transport_error": 2, "client.retry": 2}
    _Flaky.plan[:] = [503, 503, 503]
    with pytest.raises(port_client_mod.ClientError) as e:
        c._do("POST", "/x", body=b"a")
    assert e.value.transient and e.value.status == 503
    _Flaky.plan[:] = [400]
    assert c._do("POST", "/x", body=b"a")[0] == 400  # not retried
    assert stats["client.retry"] == 4
    with pytest.raises(port_client_mod.ClientError) as e:
        c._check(400, b'{"error": "bad"}', "q")
    assert not e.value.transient and "bad" in str(e.value)
    # The deadline leaves no retry: 504's error, not another attempt.
    _Flaky.plan[:] = [503, 503, 503]
    slow = port_client_mod.InternalClient(flaky, retry_max=5,
                                          retry_backoff=1.0, stats=stats)
    from pilosa_tpu_torch.errors import DeadlineExceededError

    with pytest.raises(DeadlineExceededError):
        slow._do("POST", "/x", body=b"a", deadline=time.monotonic() + 0.3)


def test_client_do_fault_seam_fails_a_call(flaky):
    rule = fault.arm("client.do", error=ConnectionResetError("armed"),
                     times=1)
    try:
        c = port_client_mod.InternalClient(flaky, retry_max=0)
        with pytest.raises(port_client_mod.ClientError) as e:
            c._do("POST", "/x", body=b"a")
        assert e.value.transient and "armed" in str(e.value)
        _Flaky.plan[:] = []
        assert c._do("POST", "/x", body=b"a")[0] == 200
    finally:
        fault.disarm(rule)


def test_breaker_open_fails_fast_and_marks_transient(flaky):
    reg = port_client_mod.BreakerRegistry(threshold=2, cooldown=60)
    c = port_client_mod.InternalClient(flaky, retry_max=0,
                                       breaker=reg.for_host(flaky))
    _Flaky.plan[:] = [503, 503]
    for _ in range(2):
        with pytest.raises(port_client_mod.ClientError):
            c._do("POST", "/x", body=b"a")
    assert reg.state(flaky) == "open"
    _Flaky.plan[:] = []
    with pytest.raises(port_client_mod.ClientError) as e:
        c._do("POST", "/x", body=b"a")
    assert e.value.transient and "breaker open" in str(e.value)


# -- the executor's fan-out with fake clients --------------------------------------------


@pytest.fixture
def holders(tmp_path):
    jh = JaxHolder(str(tmp_path / "jax"))
    ph = Holder(str(tmp_path / "port"))
    jh.open()
    ph.open()
    yield jh, ph
    jh.close()
    ph.close()


def _seed(holders, bits, frame="general"):
    for h in holders:
        f = h.create_index_if_not_exists("i").create_frame_if_not_exists(
            frame)
        for row, col in bits:
            f.set_bit(row, col)


def _clusters(replica_n=1, n=2):
    return (jax_cluster.Cluster(
        nodes=[jax_cluster.Node(f"host{i}") for i in range(n)],
        hasher=jax_cluster.ModHasher(), partition_n=4, replica_n=replica_n),
        port_cluster.Cluster(
            nodes=[port_cluster.Node(f"host{i}") for i in range(n)],
            hasher=port_cluster.ModHasher(), partition_n=4,
            replica_n=replica_n))


def _pair(holders, clusters, client_cls, **kw):
    jh, ph = holders
    jc, pc = clusters
    return (JaxExecutor(jh, host="host0", cluster=jc, client=client_cls(),
                        use_device=False, **kw),
            Executor(ph, device="cpu", host="host0", cluster=pc,
                     client=client_cls()))


def _run(ex, pql, slices=None, opt=None):
    parse = jax_parse if isinstance(ex, JaxExecutor) else parse_string
    return ex.execute("i", parse(pql), slices, opt)


def test_remote_count_forwarded(holders):
    _seed(holders, [(10, s * SLICE_WIDTH) for s in range(4)])
    clusters = _clusters()
    calls = ([], [])

    def client(k):
        class MockClient:
            def execute_query(self, node, index, query, slices, remote):
                calls[k].append((node.host, index, query, tuple(slices),
                                 remote))
                return [len(slices)]
        return MockClient

    jex = JaxExecutor(holders[0], host="host0", cluster=clusters[0],
                      client=client(0)(), use_device=False)
    pex = Executor(holders[1], device="cpu", host="host0",
                   cluster=clusters[1], client=client(1)())
    for ex in (jex, pex):
        assert _run(ex, "Count(Bitmap(rowID=10))")[0] == 4
    assert calls[0] == calls[1]
    (host, index, query, slices, remote), = calls[1]
    assert host == "host1" and remote is True
    assert query == "Count(Bitmap(rowID=10))"
    assert slices == tuple(s for s in range(4) if clusters[1].fragment_nodes(
        "i", s)[0].host == "host1") and slices
    assert pex.tier_stats.get("mesh|http") == 1


def test_remote_failure_fails_over_to_replica(holders):
    _seed(holders, [(10, s * SLICE_WIDTH) for s in range(4)])

    class FailingClient:
        def execute_query(self, node, index, query, slices, remote):
            raise ConnectionError("node down")

    jex, pex = _pair(holders, _clusters(replica_n=2), FailingClient)
    assert _run(jex, "Count(Bitmap(rowID=10))")[0] == 4
    assert _run(pex, "Count(Bitmap(rowID=10))")[0] == 4
    assert pex.stats["resplit"] == 1


def test_executor_fanout_fault_seam_resplits(holders):
    _seed(holders, [(10, s * SLICE_WIDTH) for s in range(4)])

    class OkClient:
        def execute_query(self, node, index, query, slices, remote):
            return [len(slices)]

    _, pex = _pair(holders, _clusters(replica_n=2), OkClient)
    rule = fault.arm("executor.fanout", error=ConnectionError("armed"),
                     times=1)
    try:
        assert _run(pex, "Count(Bitmap(rowID=10))")[0] == 4
        assert pex.stats["resplit"] == 1
    finally:
        fault.disarm(rule)


def test_remote_failure_no_replica_raises(holders):
    _seed(holders, [(10, s * SLICE_WIDTH) for s in range(4)])

    class FailingClient:
        def execute_query(self, node, index, query, slices, remote):
            raise ConnectionError("node down")

    for ex in _pair(holders, _clusters(replica_n=1), FailingClient):
        with pytest.raises(ConnectionError):
            _run(ex, "Count(Bitmap(rowID=10))")


def test_non_transient_leg_error_propagates_without_resplit(holders):
    _seed(holders, [(10, s * SLICE_WIDTH) for s in range(4)])

    class BadQuery:
        def execute_query(self, node, index, query, slices, remote):
            raise port_client_mod.ClientError("frame not found",
                                              transient=False)

    _, pex = _pair(holders, _clusters(replica_n=2), BadQuery)
    with pytest.raises(port_client_mod.ClientError):
        _run(pex, "Count(Bitmap(rowID=10))")
    assert pex.stats["resplit"] == 0


def test_remote_opt_restricts_to_local(holders):
    _seed(holders, [(10, s * SLICE_WIDTH) for s in range(4)])

    class ExplodingClient:
        def execute_query(self, *a, **kw):
            raise AssertionError("a remote leg must not fan out")

    jex, pex = _pair(holders, _clusters(), ExplodingClient)
    local = [s for s in range(4)
             if pex.cluster.fragment_nodes("i", s)[0].host == "host0"]
    assert (_run(jex, "Count(Bitmap(rowID=10))", local,
                 JaxExecOptions(remote=True))[0]
            == _run(pex, "Count(Bitmap(rowID=10))", local,
                    ExecOptions(remote=True))[0] == len(local))
    # A remote leg's write is applied here only.
    assert _run(pex, 'SetBit(frame="general", rowID=3, columnID=1)', None,
                ExecOptions(remote=True)) == [True]


def test_setbit_routed_to_replicas(holders):
    _seed(holders, [])
    calls = ([], [])

    def client(k):
        class MockClient:
            def execute_query(self, node, index, query, slices, remote):
                calls[k].append((node.host, query))
                return [True]
        return MockClient

    jc, pc = _clusters(replica_n=2)
    jex = JaxExecutor(holders[0], host="host0", cluster=jc,
                      client=client(0)(), use_device=False)
    pex = Executor(holders[1], device="cpu", host="host0", cluster=pc,
                   client=client(1)())
    for ex in (jex, pex):
        assert _run(ex, 'SetBit(frame="general", rowID=1, columnID=0)') \
            == [True]
    assert calls[0] == calls[1] == [
        ("host1", 'SetBit(columnID=0, frame="general", rowID=1)')]
    assert holders[1].fragment("i", "general", "standard", 0).row(
        1).columns().tolist() == [0]


class _OkClient:
    def __init__(self):
        self.calls = []

    def execute_query(self, node, index, query, slices, remote):
        self.calls.append(node.host)
        return [True]


@pytest.mark.parametrize("level", ["one", "quorum", "all"])
def test_write_consistency_with_a_down_owner(holders, tmp_path, level):
    """Three owners of every slice, the third DOWN: `one` and `quorum`
    ack and hint it, `all` is refused before anything is written; the
    same in both packages (outcome, hints, the local bits)."""
    _seed(holders, [])
    jc, pc = _clusters(replica_n=3, n=3)
    outcomes = []
    for k, (ex, cl, hm_cls) in enumerate((
            (JaxExecutor(holders[0], host="host0", cluster=jc,
                         client=_OkClient(), use_device=False), jc,
             JaxHintManager),
            (Executor(holders[1], device="cpu", host="host0", cluster=pc,
                      client=_OkClient()), pc, HintManager))):
        ex.write_consistency = level
        ex.hints = hm_cls(str(tmp_path / f"hints{k}"))
        cl.nodes[2].set_state("DOWN")
        try:
            out = _run(ex, 'SetBit(frame="general", rowID=1, columnID=5)')
        except Exception as e:  # noqa: BLE001
            out = type(e).__name__
        frag = ex.holder.fragment("i", "general", "standard", 0)
        outcomes.append((out, ex.hints.backlog_records(), ex.client.calls,
                         frag is not None and frag.row(1).count()))
        ex.hints.close()
    assert outcomes[0] == outcomes[1]
    want = {"one": ([True], 1, ["host1"], 1),
            "quorum": ([True], 1, ["host1"], 1),
            "all": ("WriteConsistencyError", 0, [], 0)}[level]
    assert outcomes[1] == want
    assert required_acks(level, 3) == {"one": 1, "quorum": 2, "all": 3}[level]


def test_below_consistency_after_dispatch_hints_and_raises(holders,
                                                           tmp_path):
    _seed(holders, [])

    class Down:
        def execute_query(self, node, index, query, slices, remote):
            raise ConnectionError("gone")

    _, pc = _clusters(replica_n=3, n=3)
    ex = Executor(holders[1], device="cpu", host="host0", cluster=pc,
                  client=Down())
    ex.write_consistency = "quorum"
    ex.hints = HintManager(str(tmp_path / "h"))
    try:
        with pytest.raises(WriteConsistencyError) as e:
            _run(ex, 'SetBit(frame="general", rowID=1, columnID=5)')
        assert e.value.required == 2 and e.value.acked == 1
        assert ex.hints.backlog_records() == 2  # both misses journaled
        # The attr calls ack with hints for the peers that missed them.
        assert _run(ex, 'SetRowAttrs(frame="general", rowID=1, x=1)') \
            == [None]
        assert ex.hints.backlog_records() == 4
    finally:
        ex.hints.close()


def test_partial_lists_missing_slices(holders):
    _seed(holders, [(10, s * SLICE_WIDTH) for s in range(8)])

    class FailingClient:
        def execute_query(self, node, index, query, slices, remote):
            raise ConnectionError("node down")

    jex, pex = _pair(holders, _clusters(replica_n=1), FailingClient)
    jopt, popt = JaxExecOptions(partial=True), ExecOptions(partial=True)
    jn = _run(jex, "Count(Bitmap(rowID=10))", None, jopt)[0]
    pn = _run(pex, "Count(Bitmap(rowID=10))", None, popt)[0]
    assert jn == pn == 8 - len(popt.missing_slices)
    assert sorted(jopt.missing_slices) == sorted(popt.missing_slices)
    assert popt.missing_slices
    # A DOWN owner's slices are left out without asking it.
    pex.cluster.nodes[1].set_state("DOWN")
    popt = ExecOptions(partial=True)
    assert _run(pex, "Count(Bitmap(rowID=10))", None, popt)[0] == pn
    assert pex.stats["resplit"] == 1


def _loopback_pair(holders, n=3, replica_n=2, seed_bits=()):
    """A coordinator per package whose fake client runs every remote
    leg on an executor of the same package over the same holder (each
    node holds everything, so any split gives the whole answer): the
    reduces of both packages over one split."""
    jc, pc = _clusters(replica_n=replica_n, n=n)
    jh, ph = holders

    class JaxLoop:
        def execute_query(self, node, index, query, slices, remote):
            leg = JaxExecutor(jh, host=node.host, cluster=jc,
                              use_device=False)
            return leg.execute(index, jax_parse(query), slices,
                               JaxExecOptions(remote=True))

    class PortLoop:
        def execute_query(self, node, index, query, slices, remote):
            leg = Executor(ph, device="cpu", host=node.host, cluster=pc)
            results = leg.execute(index, parse_string(query), slices,
                                  ExecOptions(remote=True))
            # Over the wire and back, as a real leg's answer comes.
            resp = wire.QueryResponse.decode(wire.QueryResponse(results=[
                wire.result_to_proto(r) for r in results]).encode())
            return [wire.result_from_proto(r) for r in resp.results]

    return (JaxExecutor(jh, host="host0", cluster=jc, client=JaxLoop(),
                        use_device=False),
            Executor(ph, device="cpu", host="host0", cluster=pc,
                     client=PortLoop()))


QUERIES = [
    "Count(Bitmap(rowID=1, frame=f))",
    "Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f)))",
    "Count(Union(Bitmap(rowID=0, frame=f), Bitmap(rowID=3, frame=f)))",
    "Count(Difference(Bitmap(rowID=2, frame=f), Bitmap(rowID=1, frame=f)))",
    "Bitmap(rowID=1, frame=f)",
    "Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f))",
    "TopN(frame=f, n=3)",
    "TopN(frame=f, n=10)",
    "TopN(frame=f, ids=[0, 2, 5])",
    "TopN(Bitmap(rowID=1, frame=f), frame=f, n=4)",
    "Sum(frame=f, field=\"v\")",
    "Min(frame=f, field=\"v\")",
    "Max(frame=f, field=\"v\")",
    "Max(Bitmap(rowID=2, frame=f), frame=f, field=\"v\")",
]


def _norm(v):
    if hasattr(v, "columns"):
        return ("row", [int(c) for c in v.columns()], dict(v.attrs))
    if isinstance(v, list):
        return [tuple(int(x) for x in p) for p in v]
    return v


@pytest.mark.parametrize("q", QUERIES)
def test_reduces_equal_the_jax_package(holders, q):
    rng = np.random.default_rng(7)
    bits = {(int(r), int(c)) for r, c in zip(
        rng.integers(0, 8, 600), rng.integers(0, 8 * SLICE_WIDTH, 600))}
    from pilosa_tpu.bsi.field import FieldSchema as JaxField
    from pilosa_tpu_torch.bsi.field import FieldSchema

    for h, fs in zip(holders, (JaxField, FieldSchema)):
        f = h.create_index_if_not_exists("i").create_frame_if_not_exists("f")
        for r, c in sorted(bits):
            f.set_bit(r, c)
        f.create_field_if_not_exists(fs.from_dict(
            {"name": "v", "min": -50, "max": 1000}))
        vals = np.random.default_rng(8)
        for col in vals.integers(0, 8 * SLICE_WIDTH, 40).tolist():
            f.set_value("v", col, int(vals.integers(-50, 1000)))
    jex, pex = _loopback_pair(holders)
    got = _run(pex, q)
    assert [_norm(v) for v in got] == [_norm(v) for v in _run(jex, q)]
    assert pex.tier_stats or q.startswith(("Bitmap", "Intersect", "TopN"))


def test_explain_has_placement_in_a_cluster(holders):
    _seed(holders, [(10, s * SLICE_WIDTH) for s in range(8)])
    jex, pex = _pair(holders, _clusters(replica_n=2), _OkClient)
    pex.client.breaker_state = lambda h: "closed"
    for q in ("Count(Bitmap(rowID=10))",
              'SetBit(frame="general", rowID=1, columnID=1)'):
        plan = pex.explain("i", parse_string(q))
        jplan = jex.explain("i", jax_parse(q))
        pl, jpl = plan["calls"][0]["placement"], jplan["calls"][0][
            "placement"]
        assert (pl["mode"], pl["tiers"]["http"], pl["tiers"]["local"],
                pl["tier"]) == (jpl["mode"], jpl["tiers"]["http"],
                                jpl["tiers"]["local"], jpl["tier"])
        assert {h: (v["slices"], v["sample"], v["tier"])
                for h, v in pl["nodes"].items()} == {
            h: (v["slices"], v["sample"], v["tier"])
            for h, v in jpl["nodes"].items()}
    assert plan["calls"][0]["consistency"] == {
        "level": "quorum", "replicas": 2, "required_acks": 2,
        "hinted_handoff": False}


def test_no_owner_raises_slice_unavailable(holders):
    _seed(holders, [(10, 0)])
    _, pc = _clusters()
    ex = Executor(holders[1], device="cpu", host="host0", cluster=pc,
                  client=_OkClient())
    with pytest.raises(SliceUnavailableError):
        ex._slices_by_node([], "i", [0])


def test_a_node_stages_only_the_slices_it_owns(tmp_path):
    """A node of a cluster holds the fragments of its slices only (every
    third slice is left out here, as placement leaves others' slices on
    other nodes); its pools hold no bytes for the rest, and counts over
    its non-contiguous slices are exact, a row without its first
    container in some slices included (as tests/test_torch_slice.py
    holds it over contiguous slices). A remote leg asks for its
    slices."""
    from pilosa_tpu_torch.roaring import Bitmap, Container

    rng = np.random.default_rng(31)
    n = 9
    words = np.zeros((n, 3, 16, 1024), dtype=np.uint64)
    words[:, :2] = rng.integers(0, 2**64, size=words[:, :2].shape,
                                dtype=np.uint64)
    words[1::2, 0, :8] = 0  # row 0 lacks its first containers there
    words[:, 2, 3] = rng.integers(0, 2**64, size=(n, 1024), dtype=np.uint64)
    hosts = ["a:1", "b:2", "c:3"]
    pc = port_cluster.Cluster([port_cluster.Node(h) for h in hosts],
                              replica_n=2)
    mine = [s for s in range(n) if pc.owns_fragment("a:1", "i", s)]
    assert 0 < len(mine) < n
    h = Holder(str(tmp_path / "a"))
    h.open()
    try:
        view = h.create_index("i").create_frame("f").create_view_if_not_exists(
            "standard")
        for s in mine:
            bm = Bitmap()
            for r in range(3):
                for b in range(16):
                    if words[s, r, b].any():
                        bm.keys.append(r * 16 + b)
                        bm.containers.append(Container(bitmap=words[s, r, b]))
            view.create_fragment_if_not_exists(s).replace(bm)
        h.index("i").set_remote_max_slice(n - 1)
        ex = Executor(h, device="cpu", host="a:1", cluster=pc,
                      client=_OkClient(), sparse_density_threshold=0)
        sel = np.asarray(mine)
        for q, want in (
                ("Count(Bitmap(rowID=0, frame=f))", words[sel, 0]),
                ("Count(Union(Bitmap(rowID=0, frame=f), "
                 "Bitmap(rowID=2, frame=f)))", words[sel, 0] | words[sel, 2]),
                ("Count(Intersect(Bitmap(rowID=0, frame=f), "
                 "Bitmap(rowID=1, frame=f)))", words[sel, 0] & words[sel, 1])):
            got = ex.execute("i", parse_string(q), mine,
                             ExecOptions(remote=True))[0]
            assert got == int(np.bitwise_count(want).sum(dtype=np.int64)), q
        sv = ex.mesh_manager()._views[("i", "f", "standard")]
        assert sv.num_slices == len(mine)
        assert sv.sharded.words.shape[0] == len(mine)
        assert sv.space.ids.tolist() == mine
        one_node = Executor(h, device="cpu", sparse_density_threshold=0)
        one_node.execute("i", parse_string("Count(Bitmap(rowID=0, frame=f))"))
        full = one_node.mesh_manager()._views[("i", "f", "standard")]
        # The one node's pool keeps a row of every slice below the max.
        assert full.sharded.words.shape[0] == n
        assert (sv.sharded.words.numel() * n
                == full.sharded.words.numel() * len(mine))
        # A TopN over the node's slices, exact.
        pairs = ex.execute("i", parse_string("TopN(frame=f, n=3)"), mine,
                           ExecOptions(remote=True))[0]
        counts = np.bitwise_count(words[sel]).sum(axis=(0, 2, 3))
        assert pairs == sorted(((r, int(c)) for r, c in enumerate(counts)),
                               key=lambda p: (-p[1], p[0]))
    finally:
        h.close()
