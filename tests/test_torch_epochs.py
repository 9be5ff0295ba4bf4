"""Replication epochs of the port against the JAX package's: the
fragment's epoch and its `.epoch` sidecar (each package loads what the
other wrote, after ops, a snapshot, a floor-raise and a clean close),
EpochTracker and ResultCache under the same seeded sequences,
pick_read_replica with a seeded draw, and the hint log's epochs: a log
the JAX HintManager wrote replays through the port's and raises the
target's epoch after its ops landed. Exact throughout.
"""

import random

import numpy as np
import pytest

from pilosa_tpu.core.fragment import Fragment as JaxFragment
from pilosa_tpu.parallel import Node as JaxNode
from pilosa_tpu.parallel.cluster import pick_read_replica as jax_pick
from pilosa_tpu.parallel.epochs import EpochTracker as JaxTracker
from pilosa_tpu.parallel.epochs import ResultCache as JaxCache
from pilosa_tpu.parallel.hints import HintManager as JaxHints

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.api.handler import Handler, parse_staleness
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.executor import ExecOptions, Executor
from pilosa_tpu_torch.parallel.cluster import Node, pick_read_replica
from pilosa_tpu_torch.parallel.epochs import (EpochTracker, ResultCache,
                                              fragment_key)
from pilosa_tpu_torch.parallel.hints import HintManager
from pilosa_tpu_torch.pql import parse_string
from torch_threads import one_torch_thread  # noqa: F401

FRAGMENTS = {"jax": JaxFragment, "port": Fragment}


def _open(pkg, path):
    f = FRAGMENTS[pkg](str(path), "i", "f", "standard", 0)
    f.open()
    return f


def _ops(f, rng, n):
    for _ in range(n):
        row, col = int(rng.integers(0, 4)), int(rng.integers(0, 64))
        (f.set_bit if rng.integers(0, 3) else f.clear_bit)(row, col)


# -- the fragment's epoch and sidecar ----------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_epoch_counts_ops_and_survives_reopen(tmp_path, pkg):
    f = _open(pkg, tmp_path / "0")
    for col in range(7):
        f.set_bit(1, col)
    f.clear_bit(1, 3)
    assert f.epoch == 8
    f.close()
    f = _open(pkg, tmp_path / "0")
    assert f.epoch == 8
    f.set_bit(2, 0)
    assert f.epoch == 9
    assert f.advance_epoch(20) == 20 and f.advance_epoch(3) == 20
    f.set_bit(2, 1)
    assert f.epoch == 21
    f.close()
    assert _open(pkg, tmp_path / "0").epoch == 21


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("seed", range(4))
def test_sidecar_written_by_one_package_loads_in_the_other(tmp_path, writer,
                                                          seed):
    """Ops, a snapshot (max_op_n passed: the sidecar lands before the
    rename), a floor-raise on some seeds, more ops, a clean close: the
    other package reopens the file and its sidecar at the writer's
    epoch, byte for byte the same sidecar, and counts on from there."""
    rng = np.random.default_rng(seed)
    reader = "port" if writer == "jax" else "jax"
    f = _open(writer, tmp_path / "0")
    f.max_op_n = 10
    _ops(f, rng, 25)
    assert f.wait_snapshot(10)
    if seed % 2:
        f.advance_epoch(f.epoch + int(rng.integers(1, 50)))
    _ops(f, rng, 7)
    want_epoch, want_bits = f.epoch, f.storage.slice().tolist()
    f.close()
    sidecar = (tmp_path / "0.epoch").read_bytes()
    g = _open(reader, tmp_path / "0")
    try:
        assert g.epoch == want_epoch
        assert g.storage.slice().tolist() == want_bits
        g.set_bit(3, 63)
        assert g.epoch == want_epoch + 1
    finally:
        g.close()
    # The reader's clean close writes the same base the writer would.
    h = _open(writer, tmp_path / "0")
    try:
        assert h.epoch == want_epoch + 1
    finally:
        h.close()
    assert sidecar.decode().isdigit()


@pytest.mark.parametrize("seed", range(3))
def test_epoch_equals_the_jax_package_after_the_same_ops(tmp_path, seed):
    """Ops across several background snapshots, a floor-raise, more ops
    and a close: both packages reach the same epoch, and the port
    reloads exactly at it. (The sidecar's base against the ops past the
    region splits as the snapshots in flight fell, in either package.
    The JAX package writes its sidecar without a lock: when its
    snapshot worker and the floor-raise write at once, the digits can
    interleave and it reloads above its epoch, never below.)"""
    out = {}
    for pkg in ("jax", "port"):
        rng = np.random.default_rng(seed)
        f = _open(pkg, tmp_path / pkg)
        f.max_op_n = 8
        _ops(f, rng, 30)
        f.advance_epoch(f.epoch + 5)
        _ops(f, rng, 3)
        want = f.epoch
        f.close()
        assert (tmp_path / f"{pkg}.epoch").read_bytes().decode().isdigit()
        out[pkg] = (want, _open(pkg, tmp_path / pkg).epoch)
    assert out["jax"][0] == out["port"][0]
    assert out["port"][1] == out["port"][0]
    assert out["jax"][1] >= out["jax"][0]


# -- EpochTracker and ResultCache -----------------------------------------------------


KEYS = [f"i/{f}/standard/{s}" for f in ("f", "g") for s in range(3)] + [
    "j/f/standard/0"]


def _tracker_script(seed, n=300):
    rng = np.random.default_rng(seed)
    keys = KEYS
    hosts = ["h:1", "h:2", "h:3"]
    t = 100.0
    ops = []
    for _ in range(n):
        t += float(rng.uniform(0, 2))
        k = int(rng.integers(0, 6))
        if k <= 2:
            ops.append(("local", keys[int(rng.integers(0, len(keys)))],
                        int(rng.integers(0, 400)), t))
        elif k == 3:
            ops.append(("digest", hosts[int(rng.integers(0, 3))],
                        {kk: int(rng.integers(0, 400))
                         for kk in rng.choice(keys, 3, replace=False)},
                        int(rng.integers(0, 9)), t))
        elif k == 4:
            ops.append(("forget", hosts[int(rng.integers(0, 3))]))
        else:
            ops.append(("ask", hosts[int(rng.integers(0, 3))],
                        keys[int(rng.integers(0, len(keys)))],
                        float(rng.uniform(0, 30)), t))
    return ops


def _run_tracker(tr, ops, keys):
    """The answers along `ops`; the result cache's stamp of the port
    (EpochTracker.epoch_token) is held against the sum of the JAX
    tracker's max_epoch over the same keys."""
    out = []
    for op in ops:
        if op[0] == "local":
            tr.observe_local(op[1], op[2], now=op[3])
        elif op[0] == "digest":
            tr.observe_digest(op[1], op[2], op[3], now=op[4])
        elif op[0] == "forget":
            tr.forget_host(op[1])
        else:
            _, host, key, bound, t = op
            index, _f, _v, s = key.split("/")
            touched = [k for k in keys if k.split("/")[0] == index
                       and int(k.split("/")[3]) in (int(s), 2)]
            token = (tr.epoch_token(index, sorted({int(s), 2}))
                     if hasattr(tr, "epoch_token")
                     else sum(tr.max_epoch(k) for k in touched))
            out.append((tr.max_epoch(key), tr.queue_depth(host),
                        tr.staleness_ok(host, [key], bound, now=t),
                        tr.staleness_ok_slice(host, index, int(s), bound,
                                              now=t), token))
    snap = tr.snapshot()
    return out, snap["tracked_fragments"], sorted(snap["peers"])


@pytest.mark.parametrize("seed", range(8))
def test_epoch_tracker_equals_the_jax_tracker(seed):
    ops = _tracker_script(seed)
    assert _run_tracker(EpochTracker(), ops, KEYS) == _run_tracker(
        JaxTracker(), ops, KEYS)


def test_epoch_tracker_ring_truncation_fails_closed():
    for cls in (EpochTracker, JaxTracker):
        t = cls()
        for e in range(1, 400):
            t.observe_local("i/f/standard/0", e, now=float(e))
        t.observe_digest("h:1", {"i/f/standard/0": 1}, now=400.0)
        assert not t.staleness_ok("h:1", ["i/f/standard/0"], 1e9, now=400.0)


def _run_cache(rc, seed, n=400):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        key = ("i", f"Count(Bitmap(rowID={int(rng.integers(0, 6))}))",
               (0, 1))
        k = int(rng.integers(0, 10))
        epoch = int(rng.integers(0, 4))
        if k < 5:
            out.append(rc.get(key, epoch))
        elif k < 8:
            rc.put(key, epoch, int(rng.integers(0, 1000)))
        elif k == 8:
            rc.invalidate(key)
        else:
            rc.bypass()
        out.append(len(rc))
    return out, rc.snapshot()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cap", [1, 3, 64])
def test_result_cache_equals_the_jax_cache(seed, cap):
    assert _run_cache(ResultCache(cap), seed) == _run_cache(JaxCache(cap),
                                                            seed)


# -- pick_read_replica -------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(10))
def test_pick_read_replica_equals_the_jax_pick(seed):
    rng = np.random.default_rng(seed)
    hosts = [f"h:{k}" for k in range(4)]
    for trial in range(40):
        states = ["UP" if rng.random() < 0.8 else "DOWN" for _ in hosts]
        breakers = {h: "open" if rng.random() < 0.2 else "closed"
                    for h in hosts}
        fresh = {h: bool(rng.random() < 0.7) for h in hosts}
        depth = {h: int(rng.integers(0, 3)) for h in hosts}
        prefer = (hosts + ["h:9"])[int(rng.integers(0, 5))] \
            if rng.random() < 0.5 else None
        n_owners = int(rng.integers(1, 5))
        picks = []
        for node_cls, fn in ((JaxNode, jax_pick), (Node, pick_read_replica)):
            owners = [node_cls(h) for h in hosts[:n_owners]]
            for o, st in zip(owners, states):
                o.state = st
            pick = fn(owners, breakers.get, staleness_ok=fresh.get,
                      queue_depth=depth.get, prefer=prefer,
                      rnd=random.Random(seed * 100 + trial))
            picks.append(None if pick is None else pick.host)
        assert picks[0] == picks[1], (seed, trial)


def test_pick_read_replica_rules():
    owners = [Node("h:1"), Node("h:2"), Node("h:3")]
    assert pick_read_replica(owners, staleness_ok=lambda h: True,
                             prefer="h:2").host == "h:2"
    assert pick_read_replica(
        owners, breaker_state=lambda h: "open" if h == "h:1" else "closed",
        staleness_ok=lambda h: h != "h:3").host == "h:2"
    assert pick_read_replica(owners, staleness_ok=lambda h: False) is None

    class Rnd:
        def sample(self, xs, n):
            return [xs[0], xs[1]]

    assert pick_read_replica(
        owners, staleness_ok=lambda h: True,
        queue_depth=lambda h: {"h:1": 9, "h:2": 1}.get(h, 0),
        rnd=Rnd()).host == "h:2"


@pytest.mark.parametrize("raw,want", [
    ("", 0.0), ("0", 0.0), ("0ms", 0.0), ("250", 0.25), ("5s", 5.0),
    ("1m", 60.0), ("x", 0.0), ("-3", 0.0)])
def test_parse_staleness_equals_the_jax_handler(raw, want):
    from pilosa_tpu.api.handler import _parse_staleness

    assert parse_staleness(raw) == _parse_staleness(raw) == want


# -- the hint log's epochs ------------------------------------------------------------


class _PortTarget:
    """A replay target: a port holder behind a Handler, reached the way
    api.client.InternalClient reaches a node (a remote leg's query, the
    import, the epoch floor-raise); records the order of the calls."""

    def __init__(self, holder):
        self.holder = holder
        self.ex = Executor(holder, device="cpu")
        self.handler = Handler(holder, self.ex)
        self.calls = []

    def factory(self, host):
        return self

    def execute_remote(self, node, index, pql, slices, remote=True):
        self.calls.append("query")
        return self.ex.execute(index, parse_string(pql), slices or None,
                               ExecOptions(remote=True))

    def import_bits(self, index, frame, slice_, rows, cols, ts=None,
                    remote=False):
        self.calls.append("import")
        self.holder.frame(index, frame).import_bits(rows, cols)

    def advance_epochs(self, epochs):
        self.calls.append("advance")
        import json

        r = self.handler.handle("POST", "/internal/epochs/advance",
                                body=json.dumps({"epochs": epochs}).encode())
        assert r.status == 200
        return r.json()["applied"]


def test_a_jax_hint_log_with_epochs_replays_through_the_port(tmp_path):
    key = fragment_key("i", "f", "standard", 0)
    jm = JaxHints(str(tmp_path / "hints"), client_factory=None,
                  drain_interval=3600)
    jm.enqueue_query("h:1", "i", "SetBit(rowID=1, frame=f, columnID=5)",
                     epochs={key: 40})
    jm.enqueue_import("h:1", "i", "f", 0, [2, 2], [7, 9], None,
                      epochs={key: 55})
    jm.enqueue_query("h:1", "i", "SetBit(rowID=3, frame=f, columnID=1)")
    jm.close()
    h = Holder(str(tmp_path / "node"))
    h.open()
    try:
        h.create_index("i").create_frame("f")
        target = _PortTarget(h)
        m = HintManager(str(tmp_path / "hints"),
                        client_factory=target.factory, drain_interval=3600)
        assert m.drain_once() == 3
        m.close()
        assert target.calls == ["query", "advance", "import", "advance",
                                "query"]
        frag = h.fragment("i", "f", "standard", 0)
        assert frag.row(1).columns().tolist() == [5]
        assert frag.row(2).columns().tolist() == [7, 9]
        # Raised to 55 by the import's hint, then one bump by the last
        # SetBit, which carried no epochs.
        assert frag.epoch == 56
        assert h.fragment_epochs() == {key: 56}
    finally:
        h.close()


def test_the_port_writes_epochs_as_the_jax_writer(tmp_path):
    key = fragment_key("i", "f", "standard", 0)
    logs = {}
    for name, cls in (("jax", JaxHints), ("port", HintManager)):
        m = cls(str(tmp_path / name), client_factory=None,
                drain_interval=3600)
        m.enqueue_query("h:1", "i", "SetBit(rowID=1, frame=f, columnID=5)",
                        epochs={key: 7})
        m.enqueue_import("h:1", "i", "f", 0, [1], [2], None,
                         epochs={key: 8})
        m.enqueue_query("h:1", "i", "ClearBit(rowID=1, frame=f, "
                        "columnID=5)")
        m.close()
        logs[name] = (tmp_path / name / "h_1.hintlog").read_bytes()
    assert logs["jax"] == logs["port"]


def test_fragment_epochs_report_a_lazy_fragment_by_its_sidecar(tmp_path):
    h = Holder(str(tmp_path / "d"))
    h.open()
    f = h.create_index("i").create_frame("f")
    for col in (0, SLICE_WIDTH + 1, SLICE_WIDTH + 2):
        f.set_bit(1, col)
    h.fragment("i", "f", "standard", 1).advance_epoch(30)
    h.close()
    h = Holder(str(tmp_path / "d"))
    h.open()
    try:
        frags = [h.fragment("i", "f", "standard", s) for s in (0, 1)]
        assert all(fr._pending_load for fr in frags)
        # The sidecar holds epoch - ops past the snapshot region: slice
        # 1 closed at 30 with 2 ops logged, slice 0 at 1 with 1 (a base
        # of 0 is no entry). Nothing is parsed for the digest.
        assert h.fragment_epochs() == {"i/f/standard/1": 28}
        assert all(fr._pending_load for fr in frags)
        assert frags[1].epoch == 0 and frags[1].count() == 2
        assert frags[1].epoch == 30
        assert h.fragment_epochs() == {"i/f/standard/1": 30}
    finally:
        h.close()


def test_the_epoch_token_moves_with_every_observed_write():
    """The result cache's stamp: the JAX executor's, the highest epoch
    over the slices, stays put when a slice below the highest is
    written; the port's token, the sum, moves with every write."""
    t = JaxTracker()
    t.observe_local("i/f/standard/0", 40, now=1.0)
    t.observe_local("i/f/standard/1", 3, now=1.0)
    before = t.max_epoch_slices("i", [0, 1])
    t.observe_local("i/f/standard/1", 4, now=2.0)
    assert t.max_epoch_slices("i", [0, 1]) == before == 40
    t = EpochTracker()
    t.observe_local("i/f/standard/0", 40, now=1.0)
    t.observe_local("i/g/standard/0", 2, now=1.0)
    t.observe_local("i/f/standard/1", 3, now=1.0)
    assert t.epoch_token("i", [0, 1]) == 45
    t.observe_local("i/f/standard/1", 4, now=2.0)
    assert t.epoch_token("i", [0, 1]) == 46
    assert t.epoch_token("i", [1]) == 4 and t.epoch_token("j", [0]) == 0
    t.observe_digest("h:1", {"i/f/standard/1": 2}, now=3.0)  # behind
    assert t.epoch_token("i", [0, 1]) == 46
