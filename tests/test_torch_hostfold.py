"""The port's host folds (parallel/plan.py: HostQueryCache, HostCountPlan,
HostMaterializePlan) against the JAX package's, and their place in the
port's executor and handler.

The data is made from a seed with numpy and written by the JAX package;
the port opens a copy of its directory. Each tree lowers in each
package (its own _lower_tree) and both packages' plans must give equal
counts, equal bits and equal container forms (array or bitmap, the same
values), and equal numpy truths; tolerance 0, everything is an integer.
The trees: a pair, a 5-leaf OR, a Difference, a nested tree, a time
Range, an absent row, an absent fragment, and rows of array containers,
bitmap containers and both.

Then the caches (a repeat is answered by the memo, a write to a read row
invalidates its slice only, a deleted fragment's entry never validates,
the block LRU stays at 256, the stats move as the JAX package's do), the
executor's routes (quarantined, hbm_infeasible and a DeviceResourceError
count through HostCountPlan; a tree that does not lower stays on the
Row fold; the shadow check folds through the plan; a root Intersect /
Union / Difference / Range materializes through HostMaterializePlan),
and /debug/vars `host_cache` and the /metrics pilosa_host_cache_*
families against the JAX handler's.
"""

import gc
import shutil
from datetime import datetime, timedelta

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.api.handler import Handler as JaxHandler
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.parallel import plan as jplan
from pilosa_tpu.pql import parse_string as jax_parse

from pilosa_tpu_torch import fault
from pilosa_tpu_torch.api.handler import Handler
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.executor import SHADOW_STATS, Executor
from pilosa_tpu_torch.parallel import plan as tplan
from pilosa_tpu_torch.pql import parse_string
from torch_threads import one_torch_thread  # noqa: F401

NUM_SLICES = 3
SLICES = list(range(NUM_SLICES))
ABSENT_ROW = 99
DAY0 = datetime(2017, 4, 1, 9)


def _cols(rng, s: int, blocks, n: int) -> np.ndarray:
    """n seeded columns in each of `blocks` (65,536-column containers)
    of row-local slice s."""
    return np.concatenate([
        s * SLICE_WIDTH + b * 65536 + rng.choice(65536, size=n,
                                                 replace=False)
        for b in blocks])


def make_bits(seed: int = 17) -> dict:
    """{(frame, row): columns}. Frame `f`: row 0 bitmap containers
    (6,000 bits each) in blocks 0-3 and arrays in 4-5, row 1 arrays of
    300 in blocks 0-7, row 2 a bitmap in block 0 and an array in block 1,
    rows 3-5 2,000 random bits a slice; frame `g` holds row 0 in slice 0
    only (the other slices have no fragment)."""
    rng = np.random.default_rng(seed)
    bits = {}
    for s in SLICES:
        parts = {
            ("f", 0): [_cols(rng, s, range(4), 6000),
                       _cols(rng, s, (4, 5), 1000)],
            ("f", 1): [_cols(rng, s, range(8), 300)],
            ("f", 2): [_cols(rng, s, (0,), 5000), _cols(rng, s, (1,), 100)],
        }
        for r in (3, 4, 5):
            parts[("f", r)] = [s * SLICE_WIDTH
                               + rng.choice(SLICE_WIDTH, 2000, replace=False)]
        if s == 0:
            parts[("g", 0)] = [_cols(rng, 0, (0, 2), 3000)]
        for key, ps in parts.items():
            bits.setdefault(key, []).extend(ps)
    return {k: np.unique(np.concatenate(v)) for k, v in bits.items()}


def make_events(seed: int = 18) -> dict:
    """{day: columns} of row 0 of frame `t` (quantum YMD): days 1-10 of
    April 2017 but 4 and 6, 500 seeded columns a slice each."""
    rng = np.random.default_rng(seed)
    return {d: np.unique(np.concatenate([
        s * SLICE_WIDTH + rng.choice(SLICE_WIDTH, 500, replace=False)
        for s in SLICES])) for d in range(1, 11) if d not in (4, 6)}


def write(path, bits: dict, events: dict) -> None:
    jh = JaxHolder(str(path))
    jh.open()
    idx = jh.create_index("i")
    for frame in ("f", "g"):
        idx.create_frame(frame)
    t = idx.create_frame("t", time_quantum="YMD")
    for (frame, row), cols in bits.items():
        idx.frame(frame).import_bits(np.full(len(cols), row), cols)
    for d, cols in events.items():
        t.import_bits(np.zeros(len(cols), dtype=np.int64), cols,
                      [DAY0 + timedelta(days=d - 1)] * len(cols))
    jh.close()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("hostfold")
    bits, events = make_bits(), make_events()
    write(root / "jax", bits, events)
    return root, bits, events


@pytest.fixture
def holders(data, tmp_path):
    """(JAX holder, port holder, bits, events) over copies of one
    directory."""
    root, bits, events = data
    shutil.copytree(root / "jax", tmp_path / "jax")
    shutil.copytree(root / "jax", tmp_path / "port")
    jh, th = JaxHolder(str(tmp_path / "jax")), Holder(str(tmp_path / "port"))
    jh.open()
    th.open()
    yield jh, th, bits, events
    jh.close()
    th.close()


def B(r, frame="f"):
    return f"Bitmap(rowID={r}, frame={frame})"


RANGE = 'Range(rowID=0, frame=t, start="2017-04-02T00:00", ' \
    'end="2017-04-09T00:00")'
TREES = {
    "pair": f"Intersect({B(0)}, {B(1)})",
    "5-leaf OR": f"Union({B(0)}, {B(1)}, {B(2)}, {B(3)}, {B(4)})",
    "Difference": f"Difference({B(3)}, {B(0)}, {B(5)})",
    "nested": f"Union(Intersect({B(3)}, {B(4)}), Difference({B(2)}, {B(0)}),"
              f" Intersect({B(5)}, Union({B(1)}, {B(0)})))",
    "time Range": RANGE,
    "absent row": f"Union({B(2)}, {B(ABSENT_ROW)})",
    "absent row and": f"Intersect({B(0)}, {B(ABSENT_ROW)})",
    "absent fragment": f"Union({B(1)}, {B(0, 'g')})",
    "array x bitmap": f"Intersect({B(1)}, {B(2)})",
    "bitmap x bitmap": f"Intersect({B(0)}, {B(2)})",
    "array x array": f"Difference({B(1)}, {B(2)}, {B(5)})",
}


def truth(name: str, bits: dict, events: dict) -> np.ndarray:
    empty = np.empty(0, dtype=np.int64)

    def row(r, frame="f"):
        return bits.get((frame, r), empty)

    u, i, d = np.union1d, np.intersect1d, np.setdiff1d
    out = {
        "pair": lambda: i(row(0), row(1)),
        "5-leaf OR": lambda: u(u(u(row(0), row(1)), u(row(2), row(3))),
                               row(4)),
        "Difference": lambda: d(d(row(3), row(0)), row(5)),
        "nested": lambda: u(u(i(row(3), row(4)), d(row(2), row(0))),
                            i(row(5), u(row(1), row(0)))),
        "time Range": lambda: np.unique(np.concatenate(
            [c for day, c in events.items() if 2 <= day < 9])),
        "absent row": lambda: row(2),
        "absent row and": lambda: empty,
        "absent fragment": lambda: u(row(1), row(0, "g")),
        "array x bitmap": lambda: i(row(1), row(2)),
        "bitmap x bitmap": lambda: i(row(0), row(2)),
        "array x array": lambda: d(d(row(1), row(2)), row(5)),
    }[name]()
    return np.asarray(out, dtype=np.uint64)


def lowered(pkg, holder, pql: str):
    tree = (jax_parse if pkg is jplan else parse_string)(
        f"Count({pql})").calls[0].children[0]
    leaves: list = []
    shape = pkg._lower_tree(holder, "i", tree, leaves)
    assert shape is not None, pql
    return shape, leaves


def forms(row) -> dict:
    """{slice: [(key, "array" | "bitmap", values)]} of a Row."""
    out = {}
    for s, seg in sorted(row.segments.items()):
        out[s] = [(int(k), "array" if c.array is not None else "bitmap",
                   c.values().tolist())
                  for k, c in zip(seg.keys, seg.containers)]
    return out


@pytest.mark.parametrize("name", list(TREES))
def test_host_count_equals_the_jax_package(holders, name):
    jh, th, bits, events = holders
    want = len(truth(name, bits, events))
    jc, tc = jplan.HostQueryCache(), tplan.HostQueryCache()
    jplan_ = jplan.HostCountPlan(jh, "i", *lowered(jplan, jh, TREES[name]),
                                 cache=jc)
    tplan_ = tplan.HostCountPlan(th, "i", *lowered(tplan, th, TREES[name]),
                                 cache=tc)
    assert tplan_.count_slices(SLICES) == jplan_.count_slices(SLICES) == want
    per = [tplan_.count_slice(s) for s in SLICES]
    assert per == [jplan_.count_slice(s) for s in SLICES]
    assert per == [int(((truth(name, bits, events) // SLICE_WIDTH) == s)
                       .sum()) for s in SLICES]
    # No cache: the same answers.
    assert tplan.HostCountPlan(th, "i", *lowered(tplan, th, TREES[name])
                               ).count_slices(SLICES) == want


@pytest.mark.parametrize("name", list(TREES))
def test_host_materialize_equals_the_jax_package(holders, name):
    jh, th, bits, events = holders
    want = truth(name, bits, events)
    jp = jplan.HostMaterializePlan(jh, "i", *lowered(jplan, jh, TREES[name]),
                                   cache=jplan.HostQueryCache())
    tp = tplan.HostMaterializePlan(th, "i", *lowered(tplan, th, TREES[name]),
                                   cache=tplan.HostQueryCache())
    trow, jrow = tp.materialize_row(SLICES), jp.materialize_row(SLICES)
    np.testing.assert_array_equal(trow.columns(), want)
    np.testing.assert_array_equal(jrow.columns(), want)
    assert forms(trow) == forms(jrow)
    assert trow.count() == len(want) == jrow.count()
    assert trow._counts == jrow._counts
    for s in SLICES:
        tseg, jseg = tp.materialize_slice(s), jp.materialize_slice(s)
        assert (tseg is None) == (jseg is None)
        if tseg is not None:
            assert [(k, c.array is not None, c.values().tolist())
                    for k, c in zip(tseg.keys, tseg.containers)] == \
                [(k, c.array is not None, c.values().tolist())
                 for k, c in zip(jseg.keys, jseg.containers)]
    # A repeat comes from the matrix cache and gives the same row.
    assert forms(tp.materialize_row(SLICES)) == forms(trow)
    assert tp.cache.stats["matrix_hit"] == len(tp.leaves)


def test_materialized_row_equals_the_row_fold(holders):
    """The Row path (roaring rows merged pairwise) and the fold give the
    same containers: every set op normalizes at 4096."""
    _, th, bits, events = holders
    ex = Executor(th, device="cpu")
    for name in ("pair", "nested", "array x array", "time Range"):
        child = parse_string(TREES[name]).calls[0]
        fold = ex.execute("i", parse_string(TREES[name]))[0]
        rows = tplan.Row()
        for s in SLICES:
            rows.merge(ex._bitmap_slice("i", child, s))
        assert forms(fold) == forms(rows), name


def test_stats_move_as_the_jax_packages(holders):
    """One sequence of plans over one cache: the nine keys, and their
    values, equal the JAX package's (trees without a repeated leaf: the
    port's canonical tree reads a repeated leaf once, the JAX package's
    once a use)."""
    jh, th, bits, events = holders
    jc, tc = jplan.HostQueryCache(), tplan.HostQueryCache()
    for name in ("pair", "pair", "5-leaf OR", "time Range", "pair"):
        jplan.HostCountPlan(jh, "i", *lowered(jplan, jh, TREES[name]),
                            cache=jc).count_slices(SLICES)
        tplan.HostCountPlan(th, "i", *lowered(tplan, th, TREES[name]),
                            cache=tc).count_slices(SLICES)
    assert tc.stats == jc.stats
    assert tc.stats["memo_hit"] == 2 * NUM_SLICES
    assert set(tc.stats) == {"block_hit", "block_miss", "memo_hit",
                             "memo_miss", "query_hit", "query_miss",
                             "query_reval", "matrix_hit", "matrix_miss"}


def test_a_repeat_hits_the_memo_and_a_write_invalidates_its_slice(holders):
    _, th, bits, events = holders
    cache = tplan.HostQueryCache()
    shape, leaves = lowered(tplan, th, TREES["pair"])

    def count():
        return tplan.HostCountPlan(th, "i", shape, leaves,
                                   cache=cache).count_slices(SLICES)

    n = count()
    assert cache.stats["memo_miss"] == NUM_SLICES
    assert count() == n
    assert cache.stats["memo_hit"] == NUM_SLICES
    blocks = cache.stats["block_miss"]
    # A write to a read row (row 1, slice 1) moves that fragment's
    # generation: slice 1 folds again, the others stay memo hits.
    col = SLICE_WIDTH + 5 * 65536 + 7
    assert col not in bits[("f", 1)]
    assert th.index("i").frame("f").set_bit(1, col)
    both = col in bits[("f", 0)]
    assert count() == n + both
    assert cache.stats["memo_hit"] == 2 * NUM_SLICES - 1
    assert cache.stats["memo_miss"] == NUM_SLICES + 1
    assert cache.stats["block_miss"] == blocks + 2  # both rows of slice 1
    # A write to a row the tree does not read invalidates the slice too
    # (one generation a fragment), and the answer stands.
    th.index("i").frame("f").set_bit(7, col)
    assert count() == n + both


def test_a_deleted_fragments_entry_never_validates(holders):
    """Frame `g` deleted and made again with the same bits: its new
    fragment has the generation the old one had, and the memo and block
    entries stored against the old one must miss."""
    _, th, bits, events = holders
    cache = tplan.HostQueryCache()
    name = "absent fragment"
    shape, leaves = lowered(tplan, th, TREES[name])
    want = len(truth(name, bits, events))
    assert tplan.HostCountPlan(th, "i", shape, leaves,
                               cache=cache).count_slices(SLICES) == want
    gen = th.fragment("i", "g", "standard", 0).generation
    th.index("i").delete_frame("g")
    gc.collect()
    assert tplan.HostCountPlan(th, "i", shape, leaves,
                               cache=cache).count_slices(SLICES) \
        == len(bits[("f", 1)])
    g = th.index("i").create_frame("g")
    cols = bits[("g", 0)]
    g.import_bits(np.zeros(len(cols), dtype=np.int64), cols)
    frag = th.fragment("i", "g", "standard", 0)
    hits = dict(cache.stats)
    assert tplan.HostCountPlan(th, "i", shape, leaves,
                               cache=cache).count_slices(SLICES) == want
    # Slice 0 reads the new fragment: a memo miss and a block miss for
    # it, whatever its generation (it was {gen} before).
    assert cache.stats["memo_miss"] - hits["memo_miss"] >= 1
    assert cache.stats["block_miss"] - hits["block_miss"] >= 1
    # The stored snapshot's dead reference never equals a live one.
    key = ("k",)
    cache.memo_put(key, ((frag, frag.generation),), 5)
    assert cache.memo_get(key, ((frag, frag.generation),)) == 5
    th.index("i").delete_frame("g")
    del frag
    gc.collect()
    new = th.index("i").create_frame("g")
    new.import_bits([0], [1])
    again = th.fragment("i", "g", "standard", 0)
    assert cache.memo_get(key, ((again, again.generation),)) is None
    assert gen >= 0


def test_the_block_lru_stays_at_256(tmp_path):
    """A 300-leaf OR over one slice: 300 blocks read, 256 kept (the JAX
    bound), the oldest gone first; the count is exact."""
    h = Holder(str(tmp_path))
    h.open()
    try:
        f = h.create_index("i").create_frame("f")
        rows = np.arange(300)
        cols = rows * 3 + 1
        f.import_bits(rows, cols)
        leaves = [("f", "standard", int(r), True) for r in rows]
        shape = ["or"] + [["leaf"] for _ in rows]
        cache = tplan.HostQueryCache()
        plan = tplan.HostCountPlan(h, "i", shape, leaves, cache=cache)
        assert plan.count_slices([0]) == 300
        assert len(cache._blocks) == tplan.HostQueryCache._BLOCKS_MAX == 256
        assert cache.stats["block_miss"] == 300
        frag = h.fragment("i", "f", "standard", 0)
        assert cache.block_get(frag, 0, frag.generation) is None
        assert cache.block_get(frag, 299, frag.generation) is not None
        assert tplan.HostQueryCache._MEMO_MAX == 4096
    finally:
        h.close()


def test_the_matrix_cache_keeps_its_byte_budget(holders, monkeypatch):
    _, th, bits, events = holders
    monkeypatch.setenv("PILOSA_TORCH_MATRIX_CACHE_MB", "1")
    cache = tplan.HostQueryCache()
    plan = tplan.HostMaterializePlan(
        th, "i", *lowered(tplan, th, TREES["5-leaf OR"]), cache=cache)
    plan.materialize_row(SLICES)  # five 384 KiB matrices, a 1 MiB budget
    assert len(cache._matrix) == 2
    assert cache._matrix_bytes == 2 * NUM_SLICES * 16 * 1024 * 8


# -- the executor ---------------------------------------------------------------


@pytest.fixture
def plan_calls(monkeypatch):
    """Records every HostCountPlan.count_slices of the port."""
    calls = []
    real = tplan.HostCountPlan.count_slices

    def spy(self, slices):
        calls.append(len(list(slices)))
        return real(self, slices)
    monkeypatch.setattr(tplan.HostCountPlan, "count_slices", spy)
    return calls


PAIR = f"Count({TREES['pair']})"


def test_quarantined_count_folds_through_the_plan(holders, plan_calls):
    _, th, bits, events = holders
    ex = Executor(th, device="cpu")
    want = len(truth("pair", bits, events))
    assert ex.execute("i", parse_string(PAIR)) == [want]
    assert plan_calls == []
    shape, _ = lowered(tplan, th, TREES["pair"])
    mgr = ex.mesh_manager()
    mgr.quarantine_plan(tplan.plan_signature(shape))
    assert ex.execute("i", parse_string(PAIR)) == [want]
    assert plan_calls == [NUM_SLICES]
    assert mgr.stats["fallback_quarantined"] == 1
    assert ex.stats["count_host"] == 1
    assert ex.host_cache_stats["memo_miss"] == NUM_SLICES
    assert ex.execute("i", parse_string(PAIR)) == [want]
    assert ex.host_cache_stats["memo_hit"] == NUM_SLICES
    assert ex.route_stats.copy()["count_host-fold"] == 2


def test_hbm_infeasible_count_folds_through_the_plan(holders, plan_calls):
    _, th, bits, events = holders
    ex = Executor(th, device="cpu", mesh_config={"hbm_budget_bytes": 1024})
    ex.mesh_manager()
    q = parse_string(f"Count({TREES['nested']})")
    assert ex.execute("i", q) == [len(truth("nested", bits, events))]
    assert plan_calls == [NUM_SLICES]
    assert ex.mesh_manager().stats["fallback_hbm_infeasible"] == 1
    assert ex.mesh_manager().stats.get("staged_bytes", 0) == 0


def test_device_resource_error_folds_through_the_plan(holders, plan_calls):
    _, th, bits, events = holders
    ex = Executor(th, device="cpu", mesh_config={"quarantine_after": 1000})
    fault.arm("device.exec", error=fault.SimulatedResourceExhausted)
    try:
        q = parse_string(f"Count({TREES['time Range']})")
        assert ex.execute("i", q) == [len(truth("time Range", bits,
                                                events))]
    finally:
        fault.reset()
    assert plan_calls == [NUM_SLICES]
    assert ex.mesh_manager().stats["fallback_oom"] == 1
    assert ex.route_stats.copy()["count_host-fold"] == 1


def test_a_tree_that_does_not_lower_stays_on_the_row_fold(holders,
                                                          plan_calls):
    """A time Range wider than MAX_RANGE_VIEWS (every day of two
    months under YMD is one month view; the hour quantum is absent, so
    use a day-by-day cover of 40 days) does not lower: route roaring."""
    _, th, bits, events = holders
    ex = Executor(th, device="cpu")
    q = parse_string('Count(Range(rowID=0, frame=t, '
                     'start="2017-04-02T00:00", end="2017-05-12T00:00"))')
    assert ex.execute("i", q) == [len(np.unique(np.concatenate(
        [c for d, c in events.items() if d >= 2])))]
    assert plan_calls == []
    assert ex.route_stats.copy()["count_roaring"] == 1


def test_the_shadow_check_folds_through_the_plan(holders, plan_calls):
    _, th, bits, events = holders
    ex = Executor(th, device="cpu", shadow_sample=1)
    before = SHADOW_STATS.copy()
    want = len(truth("pair", bits, events))
    assert ex.execute("i", parse_string(PAIR)) == [want]
    assert plan_calls == [NUM_SLICES]
    after = SHADOW_STATS.copy()
    assert after.get("checks:mesh", 0) == before.get("checks:mesh", 0) + 1
    assert after.get("mismatch:mesh", 0) == before.get("mismatch:mesh", 0)
    assert ex.stats["count_device"] == 1 and ex.stats["count_host"] == 0


@pytest.mark.parametrize("name", ["pair", "5-leaf OR", "Difference",
                                  "nested", "time Range", "absent fragment"])
def test_root_results_materialize_through_the_plan(holders, monkeypatch,
                                                   name):
    jh, th, bits, events = holders
    made = []
    real = tplan.HostMaterializePlan.materialize_row

    def spy(self, slices):
        made.append(1)
        return real(self, slices)
    monkeypatch.setattr(tplan.HostMaterializePlan, "materialize_row", spy)
    ex = Executor(th, device="cpu")
    got = ex.execute("i", parse_string(TREES[name]))[0]
    jgot = JaxExecutor(jh, use_device=False).execute(
        "i", jax_parse(TREES[name]))[0]
    np.testing.assert_array_equal(got.columns(), truth(name, bits, events))
    assert forms(got) == forms(jgot)
    assert made == [1]
    assert ex.host_cache_stats["matrix_miss"] > 0


def test_a_single_leaf_bitmap_stays_on_the_fragment_row(holders,
                                                        monkeypatch):
    _, th, bits, events = holders
    monkeypatch.setattr(tplan.HostMaterializePlan, "materialize_row",
                        None)  # any call fails
    ex = Executor(th, device="cpu")
    got = ex.execute("i", parse_string(B(2)))[0]
    np.testing.assert_array_equal(got.columns(), bits[("f", 2)])
    got = ex.execute("i", parse_string(f"Union({B(2)})"))[0]
    np.testing.assert_array_equal(got.columns(), bits[("f", 2)])


# -- the handler ----------------------------------------------------------------


def test_host_cache_in_debug_vars_and_metrics_as_the_jax_handler(
        holders, monkeypatch):
    jh, th, bits, events = holders
    monkeypatch.setenv("PILOSA_TPU_LONE_FUSED", "off")
    handlers = (JaxHandler(jh, JaxExecutor(jh, use_device=False)),
                Handler(th, Executor(th, device="cpu")))
    stream = [PAIR, TREES["nested"], TREES["pair"], PAIR]
    results = []
    for h in handlers:
        for q in stream:
            resp = h.handle("POST", "/index/i/query", body=q.encode())
            assert resp.status == 200, resp.body
        results.append(resp.json()["results"])
    assert results[0] == results[1]
    jv, pv = (h.handle("GET", "/debug/vars").json()["host_cache"]
              for h in handlers)
    assert set(pv) == set(jv) and len(pv) == 9
    assert pv["matrix_miss"] > 0

    def fams(h):
        text = h.handle("GET", "/metrics").body.decode()
        return {line.split()[2]: line.split()[3] for line in
                text.splitlines()
                if line.startswith("# TYPE pilosa_host_cache_")}

    jf, pf = fams(handlers[0]), fams(handlers[1])
    assert pf == jf and len(pf) == 9
    assert set(pf) == {f"pilosa_host_cache_{k}" for k in pv}


@pytest.mark.parametrize("a,b", [(0, 1), (0, 2), (1, 2), (1, 5), (0, 0),
                                 (2, ABSENT_ROW)])
def test_intersection_counts_on_the_containers(holders, a, b):
    """Row / Bitmap / Container.intersection_count (array x array on the
    sorted kernels, array x bitmap through bitmap_contains, bitmap x
    bitmap on the popcount) against the JAX package's and numpy."""
    jh, th, bits, events = holders
    empty = np.empty(0, dtype=np.int64)
    want = len(np.intersect1d(bits.get(("f", a), empty),
                              bits.get(("f", b), empty)))
    got, jgot = 0, 0
    for s in SLICES:
        tf, jf = (h.fragment("i", "f", "standard", s) for h in (th, jh))
        got += tf.row(a).intersection_count(tf.row(b))
        jgot += jf.row(a).intersection_count(jf.row(b))
    assert got == jgot == want
