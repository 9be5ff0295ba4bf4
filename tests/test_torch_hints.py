"""Hinted handoff of the port against the JAX package's: encode_hint /
scan_hints give the same bytes and the same valid prefix of damaged
logs, HintLog's files equal the JAX HintLog's after the same appends,
spills, acks and torn tails, a log the JAX HintLog wrote replays through
the port's HintManager (and one the port wrote through the JAX one), and
the manager's drain: order, stop at the first failure, the open breaker
that defers and the half-open one that admits, the `hints.replay` seam,
notify, the drainer thread with its `hint-drain` heartbeat, the restart
that resumes a backlog, and the snapshot's keys. Exact throughout.
"""

import json
import os
import time

import numpy as np
import pytest

from pilosa_tpu.core.wal import WalConfig as JaxWalConfig
from pilosa_tpu.parallel import hints as jax_hints

from pilosa_tpu_torch import fault
from pilosa_tpu_torch.core.wal import WalConfig
from pilosa_tpu_torch.obs.health import HEALTH
from pilosa_tpu_torch.parallel import hints
from pilosa_tpu_torch.parallel.hints import (HINT_STATS, HintLog,
                                             HintManager, encode_hint,
                                             scan_hints)
from torch_threads import one_torch_thread  # noqa: F401


def _payloads(seed, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if rng.integers(0, 2):
            out.append({"kind": "query", "host": f"127.0.0.1:{10100 + k}",
                        "index": "i", "pql": f"SetBit(columnID={k}, "
                        f"frame=\"f\", rowID={int(rng.integers(0, 9))})"})
        else:
            m = int(rng.integers(0, 5))
            out.append({"kind": "import", "host": "h:1", "index": "i",
                        "frame": "f", "slice": int(rng.integers(0, 99)),
                        "rows": rng.integers(0, 9, m).tolist(),
                        "cols": rng.integers(0, 1 << 20, m).tolist(),
                        "ts": None if k % 2 else [0] * m})
    return out


@pytest.mark.parametrize("seed", range(6))
def test_encode_and_scan_equal_the_jax_package(seed):
    recs = _payloads(seed)
    data = b"".join(encode_hint(p) for p in recs)
    assert data == b"".join(jax_hints.encode_hint(p) for p in recs)
    assert scan_hints(data) == jax_hints.scan_hints(data) == (recs, len(data))
    rng = np.random.default_rng(seed)
    for _ in range(20):
        cut = bytearray(data[:int(rng.integers(0, len(data) + 1))])
        if cut and rng.integers(0, 2):
            cut[int(rng.integers(0, len(cut)))] ^= 0x40
        assert scan_hints(bytes(cut)) == jax_hints.scan_hints(bytes(cut))


def _logs(tmp_path, **kw):
    return (HintLog(str(tmp_path / "port" / "t.hintlog"), "t", WalConfig(),
                    **kw),
            jax_hints.HintLog(str(tmp_path / "jax" / "t.hintlog"), "t",
                              JaxWalConfig(), **kw))


def _files(tmp_path):
    return [open(tmp_path / d / "t.hintlog", "rb").read()
            for d in ("port", "jax")]


def test_log_files_equal_the_jax_package(tmp_path):
    one = len(encode_hint({"n": 0}))
    logs = _logs(tmp_path, max_bytes=4 * one)
    dropped = HINT_STATS.copy().get("dropped:t", 0)
    for log in logs:
        for n in range(7):
            log.append({"n": n})
    files = _files(tmp_path)
    assert files[0] == files[1] and len(files[0]) == 4 * one
    assert HINT_STATS.copy()["dropped:t"] == dropped + 3
    for log in logs:
        assert [p["n"] for p in log.peek_all()] == [3, 4, 5, 6]
        log.ack(2)
        assert log.record_count() == 2 and log.byte_size() == 2 * one
    files = _files(tmp_path)
    assert files[0] == files[1]
    for log in logs:
        log.close()


def test_torn_tail_is_cut_as_the_jax_package_cuts_it(tmp_path):
    logs = _logs(tmp_path)
    for log in logs:
        for p in _payloads(3):
            log.append(p)
        log.close()
    for d in ("port", "jax"):
        path = tmp_path / d / "t.hintlog"
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 5)
    torn = HINT_STATS.copy().get("torn_tails", 0)
    logs = _logs(tmp_path)
    assert logs[0].peek_all() == logs[1].peek_all() == _payloads(3)[:-1]
    assert HINT_STATS.copy()["torn_tails"] == torn + 1
    for log in logs:
        log.append({"after": 1})
        log.close()
    files = _files(tmp_path)
    assert files[0] == files[1]


class _Replay:
    """The replay plane of both packages: records calls in order, and
    fails for hosts in `fail`."""

    def __init__(self, fail=()):
        self.calls = []
        self.fail = set(fail)
        self.host = None

    def bound(self, host):
        self.host = host
        return self

    def _check(self):
        if self.host in self.fail:
            raise ConnectionError(f"{self.host} down")

    def execute_remote(self, node, index, pql, slices, remote=True):
        self._check()
        assert remote and list(slices) == []
        self.calls.append(("query", self.host, index, pql))
        return [True]

    execute_query = execute_remote  # the JAX manager's name for it

    def import_bits(self, index, frame, slice_, rows, cols, ts=None,
                    remote=False):
        self._check()
        assert remote
        self.calls.append(("import", self.host, index, frame, slice_,
                           list(rows), list(cols),
                           None if ts is None else list(ts)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_log_written_by_one_package_replays_through_the_other(tmp_path,
                                                                writer):
    d = str(tmp_path / ".hints")
    recs = _payloads(11, n=8)
    if writer == "jax":
        m = jax_hints.HintManager(d, drain_interval=3600)
        for p in recs:
            if p["kind"] == "query":
                m.enqueue_query(p["host"], p["index"], p["pql"])
            else:
                m.enqueue_import(p["host"], p["index"], p["frame"],
                                 p["slice"], p["rows"], p["cols"], p["ts"])
        m.close()
        reader = HintManager
    else:
        m = HintManager(d, drain_interval=3600)
        for p in recs:
            if p["kind"] == "query":
                m.enqueue_query(p["host"], p["index"], p["pql"])
            else:
                m.enqueue_import(p["host"], p["index"], p["frame"],
                                 p["slice"], p["rows"], p["cols"], p["ts"])
        m.close()
        reader = jax_hints.HintManager
    cli = _Replay()
    r = reader(d, client_factory=cli.bound, drain_interval=3600)
    assert r.backlog_records() == len(recs)
    assert r.drain_once() == len(recs)
    assert r.backlog_records() == 0
    want = []
    for host in sorted({hints._sanitize(p["host"]) for p in recs}):
        for p in recs:
            if hints._sanitize(p["host"]) != host:
                continue
            if p["kind"] == "query":
                want.append(("query", p["host"], p["index"], p["pql"]))
            else:
                want.append(("import", p["host"], p["index"], p["frame"],
                             p["slice"], p["rows"], p["cols"],
                             p["ts"] if p["ts"] else None))
    assert sorted(cli.calls, key=repr) == sorted(want, key=repr)
    r.close()


def _pair(tmp_path, breaker=None, fail=()):
    clis = (_Replay(fail), _Replay(fail))
    return (HintManager(str(tmp_path / "p"), client_factory=clis[0].bound,
                        breaker_state=breaker, drain_interval=3600),
            jax_hints.HintManager(str(tmp_path / "j"),
                                  client_factory=clis[1].bound,
                                  breaker_state=breaker,
                                  drain_interval=3600)), clis


def test_drain_order_failure_and_breakers_equal_the_jax_package(tmp_path):
    state = {"h:2": "open"}
    mgrs, clis = _pair(tmp_path, breaker=lambda h: state.get(h, "closed"),
                       fail={"h:3"})
    trace = ([], [])
    for m, t in zip(mgrs, trace):
        for n in range(3):
            m.enqueue_query("h:1", "i", f"SetBit(columnID={n})")
            m.enqueue_query("h:2", "i", f"SetBit(columnID={n})")
            m.enqueue_query("h:3", "i", f"SetBit(columnID={n})")
        m.enqueue_import("h:1", "i", "f", 2, [1, 2], [5, 6], None)
        t.append((m.drain_once(), m.backlog_records()))
    state["h:2"] = "half-open"  # the replay is the probe
    for m, c, t in zip(mgrs, clis, trace):
        c.fail.clear()
        t.append((m.drain_once(), m.backlog_records()))
        t.append(sorted(m.snapshot()))
        t.append({k: v for k, v in m.snapshot().items()
                  if k not in ("targets",)}["backlog_records"])
        m.close()
    assert trace[0] == trace[1]
    assert trace[0][0] == (4, 6) and trace[0][1] == (6, 0)
    assert clis[0].calls == clis[1].calls
    assert [c[3] for c in clis[0].calls if c[1] == "h:3"] == [
        f"SetBit(columnID={n})" for n in range(3)]


def test_replay_seam_stops_a_log_in_order(tmp_path):
    cli = _Replay()
    m = HintManager(str(tmp_path / "h"), client_factory=cli.bound,
                    drain_interval=3600)
    for n in range(3):
        m.enqueue_query("h:1", "i", f"SetBit(columnID={n})")
    rule = fault.arm("hints.replay", error=ConnectionError("armed"),
                     after=1, times=1)
    failures = HINT_STATS.copy().get("replay_failures", 0)
    try:
        assert m.drain_once() == 1
        assert m.backlog_records() == 2
        assert HINT_STATS.copy()["replay_failures"] == failures + 1
        assert m.drain_once() == 2
        assert [c[3] for c in cli.calls] == [
            f"SetBit(columnID={n})" for n in range(3)]
    finally:
        fault.disarm(rule)
        m.close()


def test_drainer_thread_beats_and_drains_on_notify(tmp_path):
    cli = _Replay()
    m = HintManager(str(tmp_path / "h"), client_factory=cli.bound,
                    drain_interval=3600)
    m.start()
    try:
        assert "hint-drain" in HEALTH.snapshot()["subsystems"]
        m.enqueue_query("h:1", "i", "SetBit(columnID=1)")
        m.notify("h:1")  # the drain interval is an hour: notify drains
        deadline = time.monotonic() + 10
        while m.backlog_records() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert m.backlog_records() == 0
        assert cli.calls == [("query", "h:1", "i", "SetBit(columnID=1)")]
    finally:
        m.close()
    assert "hint-drain" not in HEALTH.snapshot()["subsystems"]


def test_backlog_survives_a_restart_and_empty_logs_go(tmp_path):
    d = str(tmp_path / "h")
    m = HintManager(d, drain_interval=3600)
    m.enqueue_query("h:1", "i", "SetBit(columnID=1)")
    m.enqueue_query("h:2", "i", "SetBit(columnID=2)")
    m.close()
    open(os.path.join(d, "empty.hintlog"), "wb").close()
    cli = _Replay()
    m2 = HintManager(d, client_factory=cli.bound, drain_interval=3600)
    assert m2.backlog_records() == 2
    assert set(m2.backlog_bytes_by_target()) == {"h_1", "h_2"}
    assert not os.path.exists(os.path.join(d, "empty.hintlog"))
    assert m2.drain_once() == 2
    snap = m2.snapshot()
    jsnap = jax_hints.HintManager(str(tmp_path / "j"),
                                  drain_interval=3600).snapshot()
    assert set(snap) == set(jsnap)
    assert set(snap["targets"]["h_1"]) == {
        "records", "bytes", "queued_total", "replayed_total",
        "dropped_total"}
    assert json.dumps(snap)  # /debug/vars takes it as it is
    m2.close()
