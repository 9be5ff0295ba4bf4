"""Anti-entropy of the port against the JAX package's, on the CPU.

- Fragment.merge_block over 1-4 peers on both arms (a diff under 128
  bits writes bit by bit, 128 or more applies in bulk): the diffs it
  returns for each peer, this copy's bits and its epoch after, equal the
  JAX package's on the same seeded inputs.
- FragmentSyncer against fake peers (real fragments behind a client's
  surface): one diverged pair, one exact copy, one that cannot be
  reached; the PQL pushed to each peer, the epoch floor-raises, the
  counters and the bits after two passes equal the JAX syncer's.
- The attr stores' block diff equals the JAX package's.
- A merge into a view staged on device="cpu" (the plain versions): a
  per-bit diff reaches the next Count as a scatter (no restage), a bulk
  one restages, and neither the repeat-TopN memo nor the host fold's
  cache serves the bits from before; every Count equals the JAX
  executor's after the same merge.
- A three-node cluster at replicas 2 of in-process port Servers (daemons
  off, the ticks called here, a time limit of its own): a planted
  divergence converges in one HolderSyncer pass, /internal/epochs and
  its floor-raise, the two attr-diff routes against the JAX handler's
  answers, a bounded Count reported as a follower read in explain's
  placement and served from the result cache until a write moves the
  epoch, and a strict Count that bypasses the cache.
- A JAX node's TOML with [anti-entropy], default-read-staleness,
  result-cache-size and result-cache-verify-1-in starts a port node and
  takes effect.
"""

import json
import signal
import time
from contextlib import contextmanager

import numpy as np
import pytest

from pilosa_tpu.api.handler import Handler as JaxHandler
from pilosa_tpu.config import Config as JaxConfig
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.core.attr import AttrStore as JaxAttrStore
from pilosa_tpu.core.attr import diff_blocks as jax_diff_blocks
from pilosa_tpu.core.fragment import Fragment as JaxFragment
from pilosa_tpu.core.syncer import FragmentSyncer as JaxSyncer
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.parallel import Node as JaxNode
from pilosa_tpu.pql import parse_string as jax_parse

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.attr import AttrStore, diff_blocks
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.syncer import FragmentSyncer, HolderSyncer
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.parallel.cluster import Node
from pilosa_tpu_torch.parallel.plan import _lower_tree
from pilosa_tpu_torch.pql import parse_string
from pilosa_tpu_torch.server import Server
from test_torch_cluster_node import _config, _free_ports, _http
from torch_threads import one_torch_thread  # noqa: F401

FRAGMENT = {"jax": JaxFragment, "port": Fragment}


@contextmanager
def time_limit(seconds: int):
    """Fail the test when it runs past `seconds` (SIGALRM)."""
    def expired(signum, frame):
        raise TimeoutError(f"test ran past its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _frag(pkg, path):
    f = FRAGMENT[pkg](str(path), "i", "f", "standard", 0)
    f.open()
    return f


def _positions(rng, n, rows=(0, 100)):
    """n distinct positions in rows [rows) of slice 0."""
    lo, hi = rows
    return np.unique(rng.integers(lo, hi, n) * SLICE_WIDTH
                     + rng.integers(0, SLICE_WIDTH, n))


def _load(f, pos):
    for p in np.asarray(pos).tolist():
        f.set_bit(p // SLICE_WIDTH, p % SLICE_WIDTH)


def _pairs(pos):
    pos = np.asarray(pos, dtype=np.uint64)
    return ((pos // np.uint64(SLICE_WIDTH)).tolist(),
            (pos % np.uint64(SLICE_WIDTH)).tolist())


def _merge_inputs(seed, peers, bulk):
    """(this copy's positions, each peer's): the peers share a change of
    `n` bits this copy lacks or has extra (so this copy is the minority),
    each with a little noise of its own; a few bits lie in block 1,
    outside the merged block."""
    rng = np.random.default_rng(seed)
    local = _positions(rng, 3000)
    n = 400 if bulk else 30
    change = _positions(rng, n)
    drop = rng.choice(local, n // 3, replace=False)
    truth = np.setdiff1d(np.union1d(local, change), drop)
    out = []
    for _ in range(peers):
        noise = _positions(rng, 4)
        p = np.setxor1d(truth, noise)
        out.append(np.union1d(p, _positions(rng, 3, rows=(100, 110))))
    return local, out


@pytest.mark.parametrize("bulk", [False, True])
@pytest.mark.parametrize("peers", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", range(2))
def test_merge_block_equals_the_jax_package(tmp_path, seed, peers, bulk):
    local, remote = _merge_inputs(seed, peers, bulk)
    got = {}
    for pkg in ("jax", "port"):
        f = _frag(pkg, tmp_path / pkg)
        try:
            _load(f, local)
            before = set(f.storage.slice().tolist())
            gen0 = f.generation
            diffs = f.merge_block(0, [_pairs(p) for p in remote])
            after = f.storage.slice().tolist()
            changed = len(before.symmetric_difference(after))
            got[pkg] = ([[[np.asarray(a).tolist() for a in side]
                          for side in d] for d in diffs],
                        after, f.epoch, f.count())
            # The arm: under 128 bits, one logged write each; else a
            # reset of the log (a staged view restages).
            if pkg == "port":
                log = f.log_since(gen0)
                if changed < Fragment._CONSENSUS_BULK_MIN:
                    assert log is not None and len(log) == changed
                else:
                    assert log is None
                    assert f.wait_snapshot(30)  # the requested snapshot
        finally:
            f.close()
    assert got["port"] == got["jax"]


def test_merge_block_both_arms_are_exercised(tmp_path):
    for bulk in (False, True):
        local, remote = _merge_inputs(0, 2, bulk)
        f = _frag("port", tmp_path / f"b{bulk}")
        try:
            _load(f, local)
            before = set(f.storage.slice().tolist())
            f.merge_block(0, [_pairs(p) for p in remote])
            n = len(before.symmetric_difference(f.storage.slice().tolist()))
            assert (n >= Fragment._CONSENSUS_BULK_MIN) == bulk, n
        finally:
            f.close()


# -- FragmentSyncer ------------------------------------------------------------------


class _Stats:
    def __init__(self):
        self.d = {}

    def inc(self, name, n=1):
        self.d[name] = self.d.get(name, 0) + n


class _Peer:
    """A replica behind a client's surface: its fragment's blocks and
    block data, the pushed PQL applied as a remote leg would, and the
    epoch floor-raise. `down`: every call fails as a dead node's."""

    def __init__(self, frag, down=False):
        self.frag, self.down = frag, down
        self.pushed, self.advanced = [], []

    def _check(self):
        if self.down:
            raise ConnectionError("connection refused")

    def fragment_blocks(self, index, frame, view, slice_, **kw):
        self._check()
        return self.frag.blocks()

    def block_data(self, index, frame, view, slice_, block, **kw):
        self._check()
        rows, cols = self.frag.block_data(block)
        return rows.tolist(), cols.tolist()

    def _apply(self, pql):
        self.pushed.append(pql)
        for c in parse_string(pql).calls:
            fn = self.frag.set_bit if c.name == "SetBit" else \
                self.frag.clear_bit
            fn(c.args["rowID"], c.args["columnID"])

    def execute_remote(self, node, index, pql, slices, remote=True):
        self._check()
        self._apply(pql)
        return [True]

    def execute_query(self, node, index, pql, slices, remote=True):
        self._check()
        self._apply(pql)
        return [True]

    def advance_epochs(self, epochs):
        self._check()
        self.advanced.append(dict(epochs))
        return sum(self.frag.advance_epoch(e) > 0 for e in epochs.values())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("bulk", [False, True])
def test_fragment_syncer_equals_the_jax_syncer(tmp_path, seed, bulk):
    local, remote = _merge_inputs(seed, 2, bulk)
    results = {}
    for pkg, syncer_cls, node_cls in (("jax", JaxSyncer, JaxNode),
                                      ("port", FragmentSyncer, Node)):
        d = tmp_path / pkg
        d.mkdir()
        f = _frag(pkg, d / "local")
        frags = [f]
        _load(f, local)
        peers = {}
        for k, p in enumerate(remote):
            pf = _frag(pkg, d / f"p{k}")
            _load(pf, p)
            peers[f"p{k}:1"] = _Peer(pf)
            frags.append(pf)
        exact = _frag(pkg, d / "exact")
        _load(exact, local)
        frags.append(exact)
        peers["exact:1"] = _Peer(exact)
        peers["dead:1"] = _Peer(None, down=True)
        nodes = [node_cls("local:1")] + [node_cls(h) for h in peers]
        stats = _Stats()
        try:
            for _ in range(2):
                syncer_cls(f, "local:1", nodes, client_factory=peers.get,
                           stats=stats).sync_fragment()
                for x in frags:
                    x.wait_snapshot(30)
            results[pkg] = {
                "pushed": {h: p.pushed for h, p in peers.items()},
                "advanced": {h: p.advanced for h, p in peers.items()},
                "stats": stats.d,
                "bits": [x.storage.slice().tolist() for x in frags],
                "blocks": [x.blocks() for x in frags],
                "epoch": f.epoch}
        finally:
            for x in frags:
                x.close()
    assert results["port"] == results["jax"]
    r = results["port"]
    # After two passes every reachable replica holds the consensus.
    assert all(b == r["blocks"][0] for b in r["blocks"])
    assert r["stats"]["syncer_peers_skipped"] >= 2  # the dead peer
    assert r["stats"]["syncer_epochs_reconciled"] >= 3
    assert r["advanced"]["dead:1"] == []


def test_a_converged_peer_is_floor_raised_and_a_dirty_one_waits(tmp_path):
    f = _frag("port", tmp_path / "0")
    try:
        _load(f, [1, 2, 3, 5 * SLICE_WIDTH])
        peer = _Peer(f)  # bit-identical: the fragment itself
        FragmentSyncer(f, "a:1", [Node("a:1"), Node("b:1")],
                       client_factory=lambda h: peer).sync_fragment()
        assert peer.advanced == [{"i/f/standard/0": f.epoch}]
        g = _frag("port", tmp_path / "1")
        try:
            dirty = _Peer(g)
            s = FragmentSyncer(f, "a:1", [Node("a:1"), Node("b:1")],
                               client_factory=lambda h: dirty)
            s.sync_block = lambda bid: None
            s.sync_fragment()
            assert dirty.advanced == []
        finally:
            g.close()
    finally:
        f.close()


# -- the attr diff -----------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_attr_block_diff_equals_the_jax_package(tmp_path, seed):
    rng = np.random.default_rng(seed)
    stores = {}
    for name, cls in (("jax", JaxAttrStore), ("port", AttrStore)):
        pair = []
        for side in ("a", "b"):
            s = cls(str(tmp_path / f"{name}_{side}.db"))
            s.open()
            pair.append(s)
        stores[name] = pair
    items_a = {int(i): {"k": int(rng.integers(0, 3)), "s": "x"}
               for i in rng.integers(0, 1000, 60)}
    items_b = dict(items_a)
    for i in rng.integers(0, 1000, 8):
        items_b[int(i)] = {"k": 9}
    try:
        for a, b in stores.values():
            a.set_bulk_attrs(items_a)
            b.set_bulk_attrs(items_b)
        ja, jb = stores["jax"]
        pa, pb = stores["port"]
        assert pa.blocks() == ja.blocks() and pb.blocks() == jb.blocks()
        want = jax_diff_blocks(ja.blocks(), jb.blocks())
        assert diff_blocks(pa.blocks(), pb.blocks()) == want
        assert want  # the stores differ
        assert diff_blocks(pa.blocks(), pa.blocks()) == []
    finally:
        for pair in stores.values():
            for s in pair:
                s.close()


# -- the staged image follows a merge ----------------------------------------------------


ROWS = 4
COUNT = "Count(Intersect(Bitmap(rowID=0, frame=f), Bitmap(rowID=1, frame=f)))"
TOPN = "TopN(frame=f, n=3)"


def _staged_pair(tmp_path, seed):
    """Both packages' holders with frame f: rows 0-3 dense in slice 0
    (every container present, so a set or clear inside them adds or
    drops none)."""
    rng = np.random.default_rng(seed)
    pos = np.unique(rng.integers(0, ROWS, 40000) * SLICE_WIDTH
                    + rng.integers(0, SLICE_WIDTH, 40000))
    out = {}
    for pkg, holder_cls in (("jax", JaxHolder), ("port", Holder)):
        h = holder_cls(str(tmp_path / pkg))
        h.open()
        f = h.create_index("i").create_frame("f")
        f.import_bits(pos // SLICE_WIDTH, pos % SLICE_WIDTH)
        out[pkg] = h
    return out, pos


def _merge_diff(frag, pos, n, rng):
    """Two peers that agree on flipping `n` of this copy's bits in rows
    0-1 (sets and clears inside existing containers)."""
    flip = rng.choice(pos[pos < 2 * SLICE_WIDTH], n // 2, replace=False)
    extra = (rng.integers(0, 2, n - n // 2) * SLICE_WIDTH
             + rng.integers(0, SLICE_WIDTH, n - n // 2))
    truth = np.setxor1d(pos, np.union1d(flip, extra))
    return [_pairs(truth), _pairs(truth)]


def _counts(ex, parse, index="i"):
    return ex.execute(index, parse(COUNT))[0]


def test_staged_image_follows_both_arms_of_a_merge(tmp_path):
    holders, pos = _staged_pair(tmp_path, 3)
    jex = JaxExecutor(holders["jax"], use_device=True, device_min_work=0)
    ex = Executor(holders["port"], device="cpu", sparse_density_threshold=0)
    rng = np.random.default_rng(4)
    try:
        assert _counts(ex, parse_string) == _counts(jex, jax_parse)
        mgr = ex.mesh_manager()
        ex.execute("i", parse_string(TOPN))
        stats0 = dict(mgr.stats)
        for n, arm in ((40, "per-bit"), (600, "bulk")):
            diff = _merge_diff(holders["port"].fragment(
                "i", "f", "standard", 0), pos, n, rng)
            for h in holders.values():
                h.fragment("i", "f", "standard", 0).merge_block(0, diff)
            hc0 = dict(ex.host_cache_stats)
            memo0 = mgr.stats.get("memo_hit", 0)
            want = _counts(jex, jax_parse)
            assert _counts(ex, parse_string) == want, arm
            # The host fold's cache reads the new generation: a miss.
            leaves = []
            child = parse_string(COUNT).calls[0].children[0]
            shape = _lower_tree(holders["port"], "i", child, leaves)
            assert ex._count_host("i", child, [0], (shape, leaves)) == want
            assert ex.host_cache_stats.get("block_miss", 0) > \
                hc0.get("block_miss", 0)
            top = ex.execute("i", parse_string(TOPN))[0]
            jtop = jex.execute("i", jax_parse(TOPN))[0]
            assert [tuple(p) for p in top] == [tuple(p) for p in jtop]
            assert mgr.stats.get("memo_hit", 0) == memo0, arm
            s = dict(mgr.stats)
            if arm == "per-bit":
                assert s.get("incremental", 0) > stats0.get("incremental", 0)
                assert s.get("stage", 0) == stats0.get("stage", 0)
            else:
                assert s.get("stage", 0) > stats0.get("stage", 0)
            stats0 = s
            pos = holders["port"].fragment("i", "f", "standard",
                                           0).storage.slice().astype(np.int64)
    finally:
        for h in holders.values():
            h.fragment("i", "f", "standard", 0).wait_snapshot(30)
            h.close()


# -- a three-node cluster ---------------------------------------------------------------


def _boot3(tmp_path):
    for attempt in range(2):
        hosts = [f"127.0.0.1:{p}" for p in _free_ports(3)]
        servers = []
        try:
            for i in range(3):
                s = Server(_config("port", tmp_path, hosts, i, 2))
                s.open()
                servers.append(s)
            return hosts, servers
        except OSError:
            for s in servers:
                s.close()
            if attempt:
                raise
    raise AssertionError("unreachable")


def _q(host, pql, staleness=None, path="/index/i/query"):
    hdr = {"X-Pilosa-Staleness": staleness} if staleness else {}
    st, body = _http(host, "POST", path, pql.encode(), hdr)
    assert st == 200, body
    return json.loads(body)


def test_cluster_converges_and_serves_bounded_reads(tmp_path):
    with time_limit(90):
        hosts, servers = _boot3(tmp_path)
        try:
            _cluster_steps(hosts, servers)
        finally:
            for s in servers:
                s.close()


def _cluster_steps(hosts, servers):
    s0 = servers[0]
    assert _http(hosts[0], "POST", "/index/i", b"{}")[0] == 200
    assert _http(hosts[0], "POST", "/index/i/frame/f", b"{}")[0] == 200
    rng = np.random.default_rng(11)
    cols = np.unique(rng.integers(0, 6 * SLICE_WIDTH, 120))
    body = "".join(f"SetBit(rowID={k % 3}, frame=f, columnID={c})"
                   for k, c in enumerate(cols.tolist()))
    _q(hosts[0], body)
    for s in servers:
        s._status_poll_tick()
    truth = {r: {int(c) for k, c in enumerate(cols) if k % 3 == r}
             for r in range(3)}

    # A divergence planted on one owner of slice 0: bits set and cleared
    # in its own fragment, past the cluster.
    owners = [hosts.index(n.host) for n in s0.cluster.fragment_nodes("i", 0)]
    a, b = owners
    fa = servers[a].holder.fragment("i", "f", "standard", 0)
    planted = [5, 77, 4096]
    for c in planted:
        fa.set_bit(2, c)
    gone = sorted(truth[0] & set(range(SLICE_WIDTH)))[:1]
    for c in gone:
        fa.clear_bit(0, c)
    fb = servers[b].holder.fragment("i", "f", "standard", 0)
    assert fa.blocks() != fb.blocks()
    HolderSyncer(servers[b].holder, hosts[b], servers[b].cluster,
                 servers[b].client.for_host,
                 stats=servers[b].stats).sync_holder()
    assert fa.blocks() == fb.blocks()
    # Two replicas: a bit either holds is in the consensus.
    truth[2] |= set(planted)
    for r in range(3):
        got = _q(hosts[1], f"Count(Bitmap(rowID={r}, frame=f))")
        assert got["results"] == [len(truth[r])]

    # The epoch digest and its floor-raise.
    st, doc = _http(hosts[a], "GET", "/internal/epochs")
    digest = json.loads(doc)
    key = "i/f/standard/0"
    assert digest["host"] == hosts[a] and digest["epochs"][key] == fa.epoch
    up = {"epochs": {key: fa.epoch + 10, "i/f/standard/99": 5,
                     "bad": 1}}
    st, doc = _http(hosts[a], "POST", "/internal/epochs/advance",
                    json.dumps(up).encode())
    assert st == 200 and json.loads(doc) == {"applied": 1}
    raised = fa.epoch
    down = {"epochs": {key: 1}}
    st, doc = _http(hosts[a], "POST", "/internal/epochs/advance",
                    json.dumps(down).encode())
    assert json.loads(doc) == {"applied": 0} and fa.epoch == raised

    # The attr-diff routes against the JAX handler's answers.
    _q(hosts[0], 'SetRowAttrs(frame=f, rowID=1, color="red", n=3)'
       'SetRowAttrs(frame=f, rowID=250, color="blue")'
       'SetColumnAttrs(columnID=9, x=1)SetColumnAttrs(columnID=420, x=2)')
    jh = JaxHolder(str(s0.holder.path) + "_jax")
    jh.open()
    try:
        jhandler = JaxHandler(jh, JaxExecutor(jh, use_device=False))
        jhandler.handle("POST", "/index/i", body=b"{}")
        jhandler.handle("POST", "/index/i/frame/f", body=b"{}")
        jhandler.handle(
            "POST", "/index/i/query",
            body=b'SetRowAttrs(frame=f, rowID=1, color="red", n=3)'
                 b'SetRowAttrs(frame=f, rowID=250, color="blue")'
                 b'SetColumnAttrs(columnID=9, x=1)'
                 b'SetColumnAttrs(columnID=420, x=2)')
        row_blocks = s0.holder.frame("i", "f").row_attr_store.blocks()
        col_blocks = s0.holder.index("i").column_attr_store.blocks()
        bodies = [{"blocks": []},
                  {"blocks": [{"id": bid, "checksum": cs.hex()}
                              for bid, cs in row_blocks[:1]]},
                  {"blocks": [{"id": bid, "checksum": cs.hex()}
                              for bid, cs in col_blocks]}]
        for path in ("/index/i/attr/diff", "/index/i/frame/f/attr/diff"):
            for req in bodies:
                raw = json.dumps(req).encode()
                st, mine = _http(hosts[1], "POST", path, raw)
                want = jhandler.handle("POST", path, body=raw)
                assert st == want.status == 200
                assert json.loads(mine) == json.loads(want.body)
        assert _http(hosts[1], "POST", "/index/nope/attr/diff",
                     b"{}")[0] == 404
    finally:
        jh.close()

    # Passes on every node reconcile the replicas' epochs: each owner
    # raises the peers that match it to its own, so after two rounds the
    # owners of a slice agree.
    for _ in range(2):
        for s in servers:
            s._anti_entropy_tick()
    for sl in range(6):
        epochs = {servers[hosts.index(n.host)].holder.fragment(
            "i", "f", "standard", sl).epoch
            for n in s0.cluster.fragment_nodes("i", sl)}
        assert len(epochs) == 1, (sl, epochs)

    # Bounded reads: explain's placement says which slices go to a
    # follower; the answers are exact and come from the result cache.
    for s in servers:
        s._status_poll_tick()
    count_q = "Count(Bitmap(rowID=2, frame=f))"
    plan = _q(hosts[0], count_q, "5s",
              path="/index/i/query?explain=true")
    read = plan["calls"][0]["placement"]["read"]
    assert read["staleness_s"] == 5.0 and read["followers"] > 0
    roles = {r for n in plan["calls"][0]["placement"]["nodes"].values()
             for r in n.get("roles", {})}
    assert "follower" in roles
    strict = _q(hosts[0], count_q, path="/index/i/query?explain=true")
    assert "read" not in strict["calls"][0]["placement"]
    ex = s0.executor
    rc0 = dict(ex.result_cache.stats.copy())
    picks0 = dict(ex.read_stats.copy())
    want = [len(truth[2])]
    ex.result_cache_verify_1_in = 0
    assert _q(hosts[0], count_q)["results"] == want
    rc1 = dict(ex.result_cache.stats.copy())
    assert rc1.get("bypass", 0) == rc0.get("bypass", 0) + 1
    assert rc1.get("hit", 0) == rc0.get("hit", 0)
    assert rc1.get("miss", 0) == rc0.get("miss", 0)
    for _ in range(3):
        assert _q(hosts[0], count_q, "5s")["results"] == want
    rc2 = dict(ex.result_cache.stats.copy())
    assert rc2.get("miss", 0) == rc1.get("miss", 0) + 1
    assert rc2.get("hit", 0) == rc1.get("hit", 0) + 2
    picks = dict(ex.read_stats.copy())
    assert picks.get("owner|strict", 0) > picks0.get("owner|strict", 0)
    assert sum(v for k, v in picks.items() if k.endswith("|bounded")) > 0
    # A write through this coordinator to a slice it holds moves the
    # epoch it knows: the next bounded Count is a miss and sees it (a
    # slice it does not hold learns the write at the next digest poll).
    mine = next(sl for sl in range(6) if s0.cluster.owns_fragment(
        hosts[0], "i", sl))
    _q(hosts[0], f"SetBit(rowID=2, frame=f, "
       f"columnID={mine * SLICE_WIDTH + 7})")
    assert _q(hosts[0], count_q, "5s")["results"] == [want[0] + 1]
    rc3 = dict(ex.result_cache.stats.copy())
    assert rc3.get("invalidate", 0) > rc2.get("invalidate", 0)
    text = _http(hosts[0], "GET", "/metrics")[1].decode()
    assert "pilosa_read_replica_total{" in text
    assert 'pilosa_result_cache_events_total{event="hit"}' in text
    vars_ = json.loads(_http(hosts[0], "GET", "/debug/vars")[1])
    assert vars_["result_cache"]["hit"] >= 2
    assert vars_["epochs"]["tracked_fragments"] > 0


def test_a_jax_toml_with_convergence_keys_takes_effect(tmp_path):
    jc = JaxConfig()
    jc.anti_entropy_interval = 1.0
    jc.anti_entropy_jitter = 0.0
    jc.default_read_staleness = 0.25
    jc.result_cache_size = 7
    jc.result_cache_verify_1_in = 3
    toml = jc.to_toml()
    assert '[anti-entropy]\ninterval = "1s"' in toml
    c = Config.from_toml(toml, is_text=True)
    assert c.to_toml() == toml
    hosts = [f"127.0.0.1:{p}" for p in _free_ports(2)]
    c.data_dir = str(tmp_path / "d")
    c.host = hosts[0]
    c.cluster_hosts = hosts
    c.use_device = "off"
    c.polling_interval = 3600.0
    c.hint_drain_interval = 3600.0
    with time_limit(30):
        s = Server(c)
        s.open()
        try:
            assert s.handler.default_read_staleness == 0.25
            assert s.executor.result_cache.cap == 7
            assert s.executor.result_cache_verify_1_in == 3
            deadline = time.monotonic() + 10
            while s.stats.snapshot().get("anti_entropy", 0) < 1:
                assert time.monotonic() < deadline, "no anti-entropy pass"
                time.sleep(0.05)
        finally:
            s.close()
