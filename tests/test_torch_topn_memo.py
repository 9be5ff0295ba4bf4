"""The repeat-TopN memo and its single-flight (pilosa_tpu_torch/parallel/
serve.py) against the JAX package's (pilosa_tpu/parallel/serve.py:
1510-1561, 3240-3300), after tests/test_serve.py's TestTopNMemo.

Each case runs one sequence of queries and writes through the JAX
Executor (device path on) and the port's (device="cpu") over copies of
one directory, and the answers are equal (tolerance 0: counts). On the
port side it then holds what the memo did: a repeat makes no K5 call
(kernels.pair_count_rows poisoned, the manager's launch counter
unmoved), a write scattered into the image in place (K7 keeps the same
tensor) gives the fresh answer, a purge comes with every image swap, no
entry holds a tensor, and concurrent identical TopNs make the launches
of one.
"""

import shutil
import threading
import time

import numpy as np
import pytest
import torch

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.bsi import FieldSchema as JaxSchema
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.pql import parse_string as jax_parse

from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.parallel import serve as tserve
from pilosa_tpu_torch.pql import parse_string
from torch_threads import one_torch_thread  # noqa: F401

TOPN = "TopN(frame=general, n=3)"
SRC = "TopN(Bitmap(rowID=0, frame=other), frame=general, n=3)"
TANIMOTO = ("TopN(Bitmap(rowID=0, frame=other), frame=general, "
            "tanimotoThreshold=10)")
SUM = 'Sum(frame=f, field="val")'


def write_data(path):
    """`general`: row r holds (r + 1) x 4 columns of slice 0 and r of
    slice 1 (the JAX test's rows, over two slices); `other`: row 0 the
    even columns below 40; field `val` of `f`: 30 columns."""
    h = JaxHolder(str(path))
    h.open()
    idx = h.create_index_if_not_exists("i")
    g = idx.create_frame_if_not_exists("general")
    for r in range(8):
        for c in range((r + 1) * 4):
            g.set_bit(r, c)
        for c in range(r):
            g.set_bit(r, SLICE_WIDTH + 10 + c)
    o = idx.create_frame_if_not_exists("other")
    for c in range(0, 40, 2):
        o.set_bit(0, c)
    f = idx.create_frame_if_not_exists("f")
    f.create_field_if_not_exists(JaxSchema("val", -100, 100))
    rng = np.random.default_rng(18)
    for c in range(30):
        f.set_value("val", c * 7, int(rng.integers(-100, 101)))
    h.close()


@pytest.fixture
def dirs(tmp_path):
    write_data(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    return tmp_path / "jax", tmp_path / "port"


def norm(v):
    if isinstance(v, list):
        return [tuple(int(x) for x in p) for p in v]
    return dict(v) if isinstance(v, dict) else v


def jax_answers(path, ops):
    h = JaxHolder(str(path))
    h.open()
    try:
        ex = JaxExecutor(h, use_device=True, device_min_work=0)
        return [norm(ex.execute("i", jax_parse(o))[0]) for o in ops]
    finally:
        h.close()


@pytest.fixture
def port(dirs):
    """(executor, its answer function) over the port's copy."""
    h = Holder(str(dirs[1]))
    h.open()
    ex = Executor(h, device="cpu", sparse_density_threshold=0,
                  device_min_work=0)
    yield ex, lambda o: norm(ex.execute("i", parse_string(o))[0])
    h.close()


@pytest.fixture
def poison(monkeypatch):
    """poison() makes every K5 call fail: what answers then came from the
    memo."""
    def arm():
        def boom(*a, **k):
            raise AssertionError("K5 called; a memo hit was expected")

        monkeypatch.setattr(tk, "pair_count_rows", boom)
    return arm


def launches(ex) -> int:
    return ex.mesh_manager().stats.get("kernel:pair_count_rows", 0)


def test_repeat_topn_makes_no_k5_call(dirs, port, poison):
    ops = [TOPN, TOPN, "TopN(frame=general, n=2)", "TopN(frame=general)"]
    want = jax_answers(dirs[0], ops)
    ex, ask = port
    got = [ask(ops[0])]
    mgr = ex.mesh_manager()
    assert mgr.stats["memo_store"] == 1 and mgr.stats["memo_size"] == 1
    n = launches(ex)
    poison()
    got += [ask(o) for o in ops[1:]]
    assert got == want
    assert got[2] == got[0][:2]
    # n, the threshold and ids rank the same counts anew on every call.
    assert mgr.stats["memo_hit"] == 3 and launches(ex) == n


def test_write_between_two_topns_gives_the_fresh_answer(dirs, port, poison):
    """The bit lands in a container the image holds: the refresh scatters
    it in place (K7; the pool is the same tensor), and the memo must not
    serve the counts from before it."""
    ops = [TOPN, "SetBit(rowID=7, frame=general, columnID=100)", TOPN, TOPN]
    want = jax_answers(dirs[0], ops)
    ex, ask = port
    got = [ask(ops[0])]
    mgr = ex.mesh_manager()
    sv = mgr._views[("i", "general", "standard")]
    words = sv.sharded.words
    got.append(ask(ops[1]))
    got.append(ask(ops[2]))
    assert mgr.stats["incremental"] == 1  # the scatter path, not a restage
    assert mgr._views[("i", "general", "standard")] is sv
    assert sv.sharded.words is words and sv.write_gen == 1
    assert got[2][0] == (7, 32 + 7 + 1)  # sees the write
    assert mgr.stats.get("memo_hit", 0) == 0  # purged, not hit stale
    poison()
    got.append(ask(ops[3]))  # ...and the new counts are memoized in turn
    assert got == want
    assert mgr.stats["memo_hit"] == 1


def test_a_write_to_the_src_misses(dirs, port):
    ops = [SRC, SRC, "SetBit(rowID=0, frame=other, columnID=31)", SRC]
    want = jax_answers(dirs[0], ops)
    ex, ask = port
    got = [ask(o) for o in ops]
    assert got == want
    mgr = ex.mesh_manager()
    assert mgr.stats["memo_hit"] == 1 and mgr.stats["memo_store"] == 2


def test_src_and_tanimoto_forms_hit_on_repeat(dirs, port, poison):
    ops = [SRC, TANIMOTO, SRC, TANIMOTO]
    want = jax_answers(dirs[0], ops)
    ex, ask = port
    got = [ask(o) for o in ops[:2]]
    mgr = ex.mesh_manager()
    stored = mgr.stats["memo_store"]
    poison()
    got += [ask(o) for o in ops[2:]]
    assert got == want
    assert mgr.stats["memo_store"] == stored
    assert mgr.stats["memo_hit"] >= 2


def test_sum_planes_hit_on_repeat(dirs, port, poison):
    ops = [SUM, SUM, "SetValue(frame=f, columnID=7, val=-55)", SUM]
    want = jax_answers(dirs[0], ops)
    ex, ask = port
    got = [ask(ops[0])]
    mgr = ex.mesh_manager()
    n = launches(ex)
    assert n > 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tk, "pair_count_rows", lambda *a, **k: 1 / 0)
        got.append(ask(ops[1]))
    assert launches(ex) == n and mgr.stats["memo_hit"] >= 1
    got += [ask(o) for o in ops[2:]]
    assert got == want
    assert launches(ex) > n  # the write purged the field's counts
    assert ex.stats["bsi_device"] == 3


def test_mask_change_misses(port):
    ex, _ask = port
    mgr = ex.mesh_manager()
    a = mgr.row_counts("i", "general", "standard", [0], 2)
    b = mgr.row_counts("i", "general", "standard", [0, 1], 2)
    c = mgr.row_counts("i", "general", "standard", [0], 2)
    assert a is not None and b is not None
    assert a[1].tolist() != b[1].tolist()
    assert mgr.stats["memo_store"] == 2 and mgr.stats["memo_hit"] == 1
    assert c is a


def test_rows_asked_are_part_of_the_key(dirs, port):
    ops = ["TopN(frame=general, ids=[1, 2])", "TopN(frame=general, ids=[3])",
           "TopN(frame=general, ids=[1, 2])"]
    want = jax_answers(dirs[0], ops)
    ex, ask = port
    assert [ask(o) for o in ops] == want
    assert ex.mesh_manager().stats["memo_hit"] == 1


def test_store_after_a_purge_is_dropped(port):
    ex, ask = port
    ask(TOPN)
    mgr = ex.mesh_manager()
    sv = mgr._views[("i", "general", "standard")]
    key = mgr._memo_key([sv], "x")
    epoch = mgr._memo_epoch
    with mgr._mu:
        mgr._purge_memo(sv)  # any purge moves the epoch
    assert mgr._memo_epoch == epoch + 1
    assert len(mgr._topn_memo) == 0
    mgr._memo_put(key, (1,), epoch)
    assert key not in mgr._topn_memo  # the stale store dropped
    mgr._memo_put(key, (1,), mgr._memo_epoch)
    assert key in mgr._topn_memo


def test_memo_holds_at_most_128_entries_in_lru_order(port):
    ex, ask = port
    ask(TOPN)
    mgr = ex.mesh_manager()
    sv = mgr._views[("i", "general", "standard")]
    assert mgr._TOPN_MEMO_MAX == 128
    mgr._topn_memo.clear()
    keys = [mgr._memo_key([sv], i) for i in range(130)]
    for k in keys[:128]:
        mgr._memo_put(k, (k,), mgr._memo_epoch)
    assert mgr._memo_get(keys[0]) == (keys[0],)  # now the most recent
    for k in keys[128:]:
        mgr._memo_put(k, (k,), mgr._memo_epoch)
    assert len(mgr._topn_memo) == 128 == mgr.stats["memo_size"]
    assert keys[0] in mgr._topn_memo
    assert keys[1] not in mgr._topn_memo and keys[2] not in mgr._topn_memo


def held_tensors(v) -> bool:
    if isinstance(v, torch.Tensor):
        return True
    if isinstance(v, (tuple, list, frozenset, set)):
        return any(held_tensors(x) for x in v)
    if isinstance(v, dict):
        return any(held_tensors(x) for x in v.values())
    return False


def test_no_entry_holds_a_tensor(port):
    ex, ask = port
    for o in (TOPN, SRC, TANIMOTO, SUM, "TopN(frame=general, ids=[1])"):
        ask(o)
    mgr = ex.mesh_manager()
    assert len(mgr._topn_memo) >= 5
    for key, (value, serials) in mgr._topn_memo.items():
        assert not held_tensors(key) and not held_tensors(value)
        assert all(isinstance(a, np.ndarray) for a in value)
        assert serials


def entries_of(mgr, sv) -> int:
    return sum(sv.serial in s for _v, s in mgr._topn_memo.values())


@pytest.mark.parametrize("event", ["evict_budget", "evict_oom", "restage",
                                   "demote", "delete"])
def test_every_image_swap_purges(port, event):
    ex, ask = port
    ask(TOPN)
    ask(SUM)
    mgr = ex.mesh_manager()
    key = ("i", "general", "standard")
    sv = mgr._views[key]
    other = mgr._views[("i", "f", "bsi.val")]
    # TopN's counts; the Sum's two passes (its values hold negatives).
    assert entries_of(mgr, sv) == 1 and entries_of(mgr, other) == 2
    epoch = mgr._memo_epoch
    if event == "evict_budget":
        mgr._config["hbm_budget_bytes"] = 1
        with mgr._mu:
            mgr._use_epoch += 1
            mgr._evict_over_budget()
    elif event == "evict_oom":
        assert mgr._evict_for_oom() == 2
    elif event == "restage":
        # A new row adds a container the image lacks: a restage.
        ask("SetBit(rowID=40, frame=general, columnID=3)")
        assert ask(TOPN)[0] == (7, 32 + 7)
        assert mgr._views[key] is not sv
    elif event == "demote":
        with mgr._mu:
            mgr._demote_to_dense(key, sv.num_slices)
    else:
        ex.invalidate_device_index("i")  # what DELETE of a frame calls
    assert entries_of(mgr, sv) == 0
    assert mgr._memo_epoch > epoch
    if event != "restage":
        assert key not in mgr._views or mgr._views[key] is not sv


@pytest.mark.parametrize("n_threads", [8])
def test_concurrent_identical_topns_make_the_launches_of_one(
        dirs, port, monkeypatch, n_threads):
    want = jax_answers(dirs[0], [TOPN])[0]
    ex, ask = port
    ask("Count(Bitmap(rowID=0))")  # stage the view; no TopN yet
    mgr = ex.mesh_manager()
    assert launches(ex) == 0
    real = tk.pair_count_rows

    def slow(*a, **k):
        time.sleep(0.3)  # long enough for every thread to join
        return real(*a, **k)

    monkeypatch.setattr(tk, "pair_count_rows", slow)
    gate = threading.Barrier(n_threads)
    out, errs = [None] * n_threads, []

    def one(i):
        try:
            gate.wait()
            out[i] = ask(TOPN)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert out == [want] * n_threads
    # One TopN: one launch per MAX_ROWS_PER_LAUNCH rows.
    rows = len(mgr._views[("i", "general", "standard")].sharded.row_ids)
    assert launches(ex) == -(-rows // tserve.MAX_ROWS_PER_LAUNCH) == 1
    shared = mgr.stats.get("inflight_shared", 0)
    assert shared + mgr.stats.get("memo_hit", 0) == n_threads - 1
    assert shared > 0


def test_a_shared_failure_reaches_every_waiter(port, monkeypatch):
    """Single-flight shares an error as it shares a result: each waiter
    raises (a DeviceResourceError keeps its type, so each answers on the
    host), and nothing is memoized."""
    from pilosa_tpu_torch.errors import DeviceResourceError

    ex, ask = port
    ask("Count(Bitmap(rowID=0))")
    mgr = ex.mesh_manager()

    def oom(*a, **k):
        time.sleep(0.2)
        raise DeviceResourceError("out of memory", reason="oom")

    monkeypatch.setattr(tk, "pair_count_rows", oom)
    gate = threading.Barrier(4)
    errs = []

    def one():
        gate.wait()
        try:
            mgr.row_counts("i", "general", "standard", [0, 1], 2)
        except DeviceResourceError as e:
            errs.append(e.reason)

    threads = [threading.Thread(target=one) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errs == ["oom"] * 4
    assert not mgr._topn_memo and not mgr._inflight


def test_memo_counters_reach_debug_vars_and_metrics(dirs):
    from pilosa_tpu.api.handler import Handler as JaxHandler

    from pilosa_tpu_torch.api.handler import Handler

    jh = JaxHolder(str(dirs[0]))
    th = Holder(str(dirs[1]))
    jh.open()
    th.open()
    try:
        jhd = JaxHandler(jh, JaxExecutor(jh, use_device=True,
                                         device_min_work=0))
        thd = Handler(th, Executor(th, device="cpu", device_min_work=0))
        for hd in (jhd, thd):
            for _ in range(2):
                r = hd.handle("POST", "/index/i/query", body=TOPN.encode())
                assert r.status == 200
        jv = jhd.handle("GET", "/debug/vars").json()["mesh"]
        tv = thd.handle("GET", "/debug/vars").json()["mesh"]
        jm = jhd.handle("GET", "/metrics").body.decode()
        tm = thd.handle("GET", "/metrics").body.decode()
    finally:
        jh.close()
        th.close()
    for k in ("memo_hit", "memo_store", "memo_size"):
        assert tv[k] == jv[k] == 1, k
        name = f"pilosa_mesh_{k}"
        assert any(line.startswith(name) for line in jm.splitlines())
        assert any(line.startswith(name) for line in tm.splitlines())
