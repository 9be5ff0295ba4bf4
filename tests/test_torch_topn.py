"""The port's TopN, rank cache and attribute stores against the JAX
package.

Every TopN form (n, threshold, ids, a src child, field / filters,
tanimotoThreshold) runs through both packages on the same directory:
the port's card path (MeshManager.top_n, K5's plain version on the CPU)
against the JAX Executor with its device backend on, and the port's
host path (Executor.top_n_host, over the fragments' rank caches) against
the JAX Executor with use_device=False. The two paths are never held
against each other: the host pass is approximate by design. Also held
against the JAX package: the caches under random writes, Fragment.top,
rank_pairs and tanimoto_rank, the attribute stores and their files, the
attrs on Bitmap results and the HTTP JSON. Every answer is exact
(tolerance 0: counts are integers). The data is made from a seed with
numpy and written by the JAX package; the port opens a copy.
"""

import shutil

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.api.handler import Handler as JaxHandler
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.core import attr as jattr
from pilosa_tpu.core import cache as jcache
from pilosa_tpu.core.fragment import TopOptions as JaxTopOptions
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.parallel import serve as jserve
from pilosa_tpu.pql import parse_string as jax_parse

from pilosa_tpu_torch.api.handler import Handler
from pilosa_tpu_torch.core import Holder, TopOptions
from pilosa_tpu_torch.core import attr as tattr
from pilosa_tpu_torch.core import cache as tcache
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.parallel import serve as tserve
from pilosa_tpu_torch.pql import parse_string
from torch_threads import one_torch_thread  # noqa: F401

NUM_SLICES = 3
ROWS = 40
SMALL_CACHE = 5


# -- the caches ----------------------------------------------------------------


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind,size", [("ranked", 8), ("ranked", 50000),
                                       ("lru", 8)])
def test_caches_match_jax(seed, kind, size):
    """The same random adds, bulk adds, reads and clock steps on both
    caches leave the same pairs, ids and counts."""
    rng = np.random.default_rng(seed)
    jc, tc = Clock(), Clock()
    j, t = jcache.new_cache(kind, size, jc), tcache.new_cache(kind, size, tc)
    for _ in range(400):
        op = int(rng.integers(0, 6))
        id_, n = int(rng.integers(0, 30)), int(rng.integers(0, 50))
        if op == 0:
            j.add(id_, n)
            t.add(id_, n)
        elif op == 1:
            j.bulk_add(id_, n)
            t.bulk_add(id_, n)
        elif op == 2:
            j.invalidate()
            t.invalidate()
        elif op == 3:
            jc.t = tc.t = jc.t + float(rng.integers(0, 12))
        elif op == 4:
            assert t.get(id_) == j.get(id_)
        else:
            assert t.top() == j.top()
        assert t.ids() == j.ids() and len(t) == len(j)
    assert t.top() == j.top()


@pytest.mark.parametrize("seed", range(4))
def test_add_to_pairs_matches_jax(seed):
    rng = np.random.default_rng(seed)
    acc_j, acc_t = [], []
    for _ in range(20):
        other = [(int(i), int(n)) for i, n in
                 zip(rng.integers(0, 15, 6), rng.integers(0, 9, 6))]
        acc_j = jcache.add_to_pairs(acc_j, other)
        acc_t = tcache.add_to_pairs(acc_t, other)
        assert acc_t == acc_j


@pytest.mark.parametrize("seed", range(8))
def test_rank_pairs_and_tanimoto_match_jax(seed):
    rng = np.random.default_rng(seed)
    r = int(rng.integers(0, 60))
    rows = np.sort(rng.choice(1000, size=r, replace=False)).astype(np.uint64)
    full = rng.integers(0, 40, size=r).astype(np.int64)
    inter = np.minimum(full, rng.integers(0, 40, size=r)).astype(np.int64)
    ids = sorted(rng.choice(1000, size=8, replace=False).tolist()
                 + rows[:3].tolist())
    allowed = set(rng.choice(1000, size=500, replace=False).tolist())

    def pred(row):
        return row in allowed

    for n in (0, 1, 5, 100):
        for thr in (0, 1, 7, 30):
            for row_ids in ((), ids):
                for p in (None, pred):
                    assert tserve.rank_pairs(rows, full, n, row_ids, thr, p) \
                        == jserve.rank_pairs(rows, full, n, row_ids, thr, p)
        for src in (0, 1, 25, 80):
            for tan in (1, 20, 50, 100):
                for row_ids in ((), ids):
                    assert tserve.tanimoto_rank(
                        rows, full, inter, src, n, tan, row_ids, pred) == \
                        jserve.tanimoto_rank(rows, full, inter, src, n, tan,
                                             row_ids, pred)


# -- the attribute stores -------------------------------------------------------

ATTRS = [(3, {"a": 1, "b": "x"}), (250, {"c": True, "d": 1.5}),
         (3, {"b": None, "e": "y"}), (1 << 40, {"f": -2}),
         (99, {}), (251, {"a": "z"})]


def test_attr_stores_share_their_files(tmp_path):
    """The port's store reads what the JAX store wrote and the other way
    round; both give the same attrs, blocks and block data."""
    j = jattr.AttrStore(str(tmp_path / "a" / "attrs.db"))
    j.open()
    for id_, m in ATTRS[:3]:
        j.set_attrs(id_, m)
    j.close()
    t = tattr.AttrStore(str(tmp_path / "a" / "attrs.db"))
    t.open()
    t.set_bulk_attrs(dict(ATTRS[3:]))
    with pytest.raises(TypeError):
        t.set_attrs(5, {"g": [1]})
    t_view = ({i: t.attrs(i) for i, _ in ATTRS}, t.blocks(),
              [t.block_data(b) for b, _ in t.blocks()])
    t.close()
    j = jattr.AttrStore(str(tmp_path / "a" / "attrs.db"))
    j.open()
    try:
        j_view = ({i: j.attrs(i) for i, _ in ATTRS}, j.blocks(),
                  [j.block_data(b) for b, _ in j.blocks()])
    finally:
        j.close()
    assert t_view == j_view
    assert t_view[0][3] == {"a": 1, "e": "y"}


# -- data ----------------------------------------------------------------------


def write_topn(path, seed: int = 5):
    """Index `i`: frame `topn` of ROWS rows over NUM_SLICES slices (row r
    holds a seeded random count, some rows dense bitmap containers,
    some absent from a slice), frame `small` (the same rows, a rank cache
    of SMALL_CACHE), and frame `other` (rows 0-2 for src). Row attrs on
    `topn` give rows a category; column attrs on a few columns."""
    rng = np.random.default_rng(seed)
    jh = JaxHolder(str(path))
    jh.open()
    idx = jh.create_index("i")
    frames = {"topn": idx.create_frame("topn"),
              "small": idx.create_frame("small", cache_size=SMALL_CACHE),
              "other": idx.create_frame("other")}
    for s in range(NUM_SLICES):
        rows, cols = [], []
        for r in range(ROWS):
            if rng.random() < 0.1:
                continue
            n = int(rng.choice([rng.integers(1, 300),
                                rng.integers(4097, 20000)]))
            c = rng.choice(1 << 17, size=n, replace=False)
            rows.append(np.full(n, r))
            cols.append(c + s * SLICE_WIDTH)
        rows, cols = np.concatenate(rows), np.concatenate(cols)
        for name in ("topn", "small"):
            frames[name].import_bits(rows, cols)
        orows = np.repeat(np.arange(3), 30000)
        ocols = rng.choice(1 << 17, size=orows.size) + s * SLICE_WIDTH
        frames["other"].import_bits(orows, ocols)
    for r in range(ROWS):
        if r % 3:
            frames["topn"].row_attr_store.set_attrs(
                r, {"cat": "ab"[r % 2], "rank": r})
    for col in (5, 7, SLICE_WIDTH + 3):
        idx.column_attr_store.set_attrs(col, {"tag": f"c{col}"})
    jh.close()


@pytest.fixture
def topn_dirs(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_COUNT_BACKEND", "pallas_interpret")
    write_topn(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "torch")
    return tmp_path / "jax", tmp_path / "torch"


TOPN = [
    "TopN(frame=topn, n=5)",
    "TopN(frame=topn)",
    "TopN(frame=topn, n=7, threshold=9000)",
    "TopN(frame=topn, threshold=40000)",
    "TopN(frame=topn, ids=[1, 3, 5, 8, 99])",
    "TopN(frame=topn, n=2, ids=[4, 6, 2])",
    "TopN(Bitmap(rowID=0, frame=other), frame=topn, n=5)",
    "TopN(Bitmap(rowID=2, frame=topn), frame=topn, n=6)",
    "TopN(Intersect(Bitmap(rowID=1, frame=other), "
    "Bitmap(rowID=2, frame=other)), frame=topn, n=4, threshold=50)",
    "TopN(Bitmap(rowID=1, frame=other), frame=topn, ids=[2, 4, 9])",
    'TopN(frame=topn, n=3, field="cat", filters=["a"])',
    'TopN(frame=topn, field="cat", filters=["a", "b"], threshold=100)',
    'TopN(frame=topn, n=4, field="rank", filters=[4, 5, 7, 11])',
    "TopN(Bitmap(rowID=0, frame=other), frame=topn, tanimotoThreshold=20)",
    "TopN(Bitmap(rowID=0, frame=other), frame=topn, n=3, "
    "tanimotoThreshold=1)",
    "TopN(Bitmap(rowID=2, frame=topn), frame=topn, tanimotoThreshold=70)",
    "TopN(frame=small, n=3)",
    "TopN(frame=small, n=12)",
    "TopN(frame=nosuch, n=2)",
    "TopN(frame=topn, n=0, ids=[])",
]
# Forms the card path hands to the host (and their errors).
HOST_ONLY = [
    'TopN(frame=topn, n=3, filters=["a"])',
    "TopN(frame=topn, n=3, tanimotoThreshold=50)",
    "TopN(Bitmap(rowID=0, frame=other), frame=topn, tanimotoThreshold=101)",
    "TopN(Bitmap(rowID=0, frame=other), Bitmap(rowID=1, frame=other), "
    "frame=topn)",
    'TopN(frame=topn, ids=["x"])',
]
WRITES = ["SetBit(rowID=3, frame=topn, columnID=99999)",
          f"SetBit(rowID=30, frame=topn, columnID={SLICE_WIDTH + 4})",
          "ClearBit(rowID=3, frame=topn, columnID=99999)",
          "SetBit(rowID=41, frame=small, columnID=8)"]


def as_plain(result):
    if hasattr(result, "columns"):
        return ("row", [int(c) for c in result.columns()], result.attrs)
    if isinstance(result, list):
        return [tuple(int(x) for x in p) for p in result]
    return result


def run(execute, queries):
    out = []
    for q in queries:
        try:
            out.append(as_plain(execute(q)))
        except Exception as e:  # noqa: BLE001 — compared by type name
            out.append(("error", type(e).__name__))
    return out


def jax_run(path, queries, use_device: bool):
    jh = JaxHolder(str(path))
    jh.open()
    try:
        ex = JaxExecutor(jh, use_device=use_device, device_min_work=0)
        return run(lambda q: ex.execute("i", jax_parse(q))[0], queries)
    finally:
        jh.close()


def test_card_path_matches_jax_device_path(topn_dirs):
    jdir, tdir = topn_dirs
    queries = TOPN + WRITES + TOPN[:3] + TOPN[16:18] + HOST_ONLY
    want = jax_run(jdir, queries, use_device=True)
    h = Holder(str(tdir))
    h.open()
    try:
        ex = Executor(h, device="cpu")
        mgr = ex.mesh_manager().stats
        # Per query: (K5 launches, repeat-TopN memo hits).
        moved = []

        def execute(q):
            k5, hits = mgr["kernel:pair_count_rows"], mgr["memo_hit"]
            try:
                return ex.execute("i", parse_string(q))[0]
            finally:
                moved.append((mgr["kernel:pair_count_rows"] - k5,
                              mgr["memo_hit"] - hits))

        got = run(execute, queries)
    finally:
        h.close()
    assert got == want
    assert got[0] and len(got[0]) == 5 and len(got[1]) > 30
    assert [p[0] for p in got[4]] == [p[0] for p in got[4] if p[0] in
                                      (1, 3, 5, 8)]
    # Every form of TOPN (and the repeats after the writes) ran on the
    # card, but the unknown frame (host: no fragment) and the empty list
    # (a parse error in both packages): each on K5, or from the memo of
    # an earlier TopN over its frame since that frame's last write. The
    # first TopN over a frame after a write launches K5.
    assert got[len(TOPN) - 1] == ("error", "ParseError")
    n_card = len(TOPN) - 2 + 5
    assert ex.stats["topn_device"] == n_card
    card = [i for i, q in enumerate(queries[:len(TOPN) + len(WRITES) + 5])
            if q.startswith("TopN") and "nosuch" not in q and "ids=[])"
            not in q]
    assert len(card) == n_card
    read_since_write: set = set()
    for i, q in enumerate(queries[:card[-1] + 1]):
        frame = "small" if "frame=small" in q else "topn"
        if not q.startswith("TopN"):
            read_since_write.discard(frame)
        elif i in card:
            k5, hits = moved[i]
            assert (k5 >= 1) != (hits >= 1), (q, moved[i])
            assert hits == 0 or frame in read_since_write, q
            read_since_write.add(frame)
    after_writes = len(TOPN) + len(WRITES)
    assert moved[after_writes][0] >= 1 and moved[after_writes][1] == 0
    assert moved[after_writes + 3][0] >= 1
    assert moved[after_writes + 3][1] == 0
    assert mgr["kernel:pair_count_rows"] >= n_card - mgr["memo_hit"]
    # The unknown frame and HOST_ONLY, but the ids of the wrong type (a
    # TypeError before either path).
    assert ex.stats["topn_host"] == 1 + len(HOST_ONLY) - 1


def top_n_host_run(ex, queries):
    def one(q):
        c = parse_string(q).calls[0]
        if c.name != "TopN":
            return ex.execute("i", parse_string(q))[0]
        return ex.top_n_host("i", c, list(range(NUM_SLICES)))
    return run(one, queries)


def test_host_path_matches_jax_host_path(topn_dirs):
    """The two-phase host TopN over the rank caches the JAX package left
    in `.cache`, before and after writes that move the caches."""
    jdir, tdir = topn_dirs
    queries = TOPN[:-2] + WRITES + TOPN[:3] + TOPN[16:18] + HOST_ONLY
    want = jax_run(jdir, queries, use_device=False)
    h = Holder(str(tdir))
    h.open()
    try:
        ex = Executor(h, device="cpu")
        got = top_n_host_run(ex, queries)
    finally:
        h.close()
    assert got == want
    assert ex.stats.get("topn_device", 0) == 0


def test_fragment_top_matches_jax(topn_dirs):
    """Fragment.top of every slice with each option set, after the same
    per-bit writes on both sides."""
    jdir, tdir = topn_dirs
    jh = JaxHolder(str(jdir))
    jh.open()
    th = Holder(str(tdir))
    th.open()
    try:
        for s in range(NUM_SLICES):
            jf = jh.fragment("i", "topn", "standard", s)
            tf = th.fragment("i", "topn", "standard", s)
            for r, c in ((3, 5), (3, 6), (7, 5), (0, 9)):
                assert tf.set_bit(r, c + s * SLICE_WIDTH) == jf.set_bit(
                    r, c + s * SLICE_WIDTH)
            jsrc = jh.fragment("i", "other", "standard", s).row(1)
            tsrc = th.fragment("i", "other", "standard", s).row(1)
            for kw in ({"n": 4}, {"n": 0}, {"n": 3, "min_threshold": 200},
                       {"row_ids": [1, 2, 3, 77]},
                       {"n": 5, "src": True},
                       {"n": 0, "src": True, "min_threshold": 10},
                       {"n": 3, "filter_field": "cat",
                        "filter_values": ["b"]},
                       {"src": True, "tanimoto_threshold": 3},
                       {"n": 2, "src": True, "tanimoto_threshold": 40}):
                src = kw.pop("src", None)
                want = jf.top(JaxTopOptions(src=jsrc if src else None, **kw))
                got = tf.top(TopOptions(src=tsrc if src else None, **kw))
                assert got == want, (s, kw)
            assert tf.cache.top() == jf.cache.top()
    finally:
        jh.close()
        th.close()


def test_row_counts_match_jax(topn_dirs):
    """MeshManager.row_counts / row_counts_src of both packages over the
    same views and slice subsets."""
    from pilosa_tpu.parallel.plan import _lower_tree as jax_lower
    from pilosa_tpu_torch.parallel.plan import _lower_tree

    jdir, tdir = topn_dirs
    src_q = ("Union(Bitmap(rowID=0, frame=other), "
             "Bitmap(rowID=2, frame=topn))")
    cases = [list(range(NUM_SLICES)), [0, 2], [1]]
    jh = JaxHolder(str(jdir))
    jh.open()
    try:
        jmgr = JaxExecutor(jh, use_device=True,
                           device_min_work=0).mesh_manager()
        want = []
        for sl in cases:
            rows, counts = jmgr.row_counts("i", "topn", "standard", sl,
                                           NUM_SLICES)
            leaves = []
            shape = jax_lower(jh, "i", jax_parse(src_q).calls[0], leaves)
            srows, scounts = jmgr.row_counts_src(
                "i", "topn", "standard", shape, leaves, sl, NUM_SLICES)
            want.append((rows.tolist(), counts.tolist(), srows.tolist(),
                         scounts.tolist()))
    finally:
        jh.close()
    h = Holder(str(tdir))
    h.open()
    try:
        mgr = Executor(h, device="cpu").mesh_manager()
        got = []
        for sl in cases:
            rows, counts = mgr.row_counts("i", "topn", "standard", sl,
                                          NUM_SLICES)
            leaves = []
            tree = _lower_tree(h, "i", parse_string(src_q).calls[0], leaves)
            srows, scounts = mgr.row_counts_src(
                "i", "topn", "standard", tree, leaves, sl, NUM_SLICES)
            got.append((rows.tolist(), counts.tolist(), srows.tolist(),
                        scounts.tolist()))
    finally:
        h.close()
    assert got == want


def test_row_counts_chunk_their_launches(topn_dirs, monkeypatch):
    """More rows than one launch takes split into launches that add up
    to the same counts."""
    _jdir, tdir = topn_dirs
    h = Holder(str(tdir))
    h.open()
    try:
        mgr = Executor(h, device="cpu").mesh_manager()
        want = mgr.row_counts("i", "topn", "standard", [0, 1, 2], NUM_SLICES)
        monkeypatch.setattr(tserve, "MAX_ROWS_PER_LAUNCH", 7)
        mgr.stats.clear()
        mgr._topn_memo.clear()  # else the repeat is a memo hit
        got = mgr.row_counts("i", "topn", "standard", [0, 1, 2], NUM_SLICES)
        assert got[0].tolist() == want[0].tolist()
        assert got[1].tolist() == want[1].tolist()
        assert mgr.stats["kernel:pair_count_rows"] == -(-len(want[0]) // 7)
    finally:
        h.close()


# -- attrs over HTTP ----------------------------------------------------------

HTTP = [
    ("POST", "/index/i/query", b'SetRowAttrs(frame=topn, rowID=1, '
                               b'cat="b", active=true, score=2.5)', {}),
    ("POST", "/index/i/query", b'SetRowAttrs(frame=topn, rowID=2, cat="c") '
                               b'SetRowAttrs(frame=small, rowID=2, x=1) '
                               b'SetRowAttrs(frame=topn, rowID=2, y=2)', {}),
    ("POST", "/index/i/query", b'SetRowAttrs(rowID=2, cat="c")', {}),
    ("POST", "/index/i/query", b'SetRowAttrs(frame=nosuch, rowID=2)', {}),
    ("POST", "/index/i/query", b'SetRowAttrs(frame=topn, cat="c")', {}),
    ("POST", "/index/i/query", b'SetColumnAttrs(columnID=5, tag="new", '
                               b'z=3)', {}),
    ("POST", "/index/i/query", b'SetColumnAttrs(id=9, tag="nine")', {}),
    ("POST", "/index/i/query", b'SetColumnAttrs(tag="none")', {}),
    ("POST", "/index/i/query", b"Bitmap(rowID=1, frame=topn)", {}),
    ("POST", "/index/i/query", b"Bitmap(rowID=2, frame=topn)", {}),
    ("POST", "/index/i/query", b"Bitmap(rowID=2, frame=small)", {}),
    ("POST", "/index/i/query", b"Intersect(Bitmap(rowID=1, frame=topn), "
                               b"Bitmap(rowID=0, frame=other))", {}),
    ("POST", "/index/i/query", b"Bitmap(rowID=0, frame=other) "
                               b"Count(Bitmap(rowID=1, frame=other))",
     {"columnAttrs": "true"}),
    ("POST", "/index/i/query", b"Bitmap(rowID=39, frame=topn)",
     {"columnAttrs": "true", "slices": "0"}),
    ("POST", "/index/i/query", b'TopN(frame=topn, n=3, field="cat", '
                               b'filters=["c", "b"])', {}),
    ("POST", "/index/i/query", b"TopN(frame=topn, n=4)", {}),
    ("POST", "/index/i/query", b"TopN(frame=topn, n=4)", {"slices": "1,2"}),
    ("POST", "/index/i/query", b"TopN(Bitmap(rowID=0, frame=other), "
                               b"frame=topn, n=3)", {}),
    ("POST", "/index/i/query", b"TopN(frame=topn, tanimotoThreshold=200)",
     {}),
    ("POST", "/index/i/query", b"TopN(frame=topn, n=2) "
                               b"TopN(frame=small, n=2)", {}),
]


def test_http_json_matches_jax(topn_dirs):
    jdir, tdir = topn_dirs
    jh = JaxHolder(str(jdir))
    jh.open()
    th = Holder(str(tdir))
    th.open()
    try:
        jax_handler = JaxHandler(jh, JaxExecutor(jh, use_device=True,
                                                 device_min_work=0))
        handler = Handler(th, Executor(th, device="cpu"))
        seen = []
        for method, path, body, params in HTTP:
            want = jax_handler.handle(method, path, params, {}, body)
            got = handler.handle(method, path, params, {}, body)
            assert (got.status, got.json()) == (want.status, want.json()), \
                (method, path, body, params)
            seen.append(got.json())
    finally:
        jh.close()
        th.close()
    assert seen[8]["results"][0]["attrs"] == {"active": True, "cat": "b",
                                              "rank": 1, "score": 2.5}
    assert seen[12]["columnAttrs"][0] == {"attrs": {"tag": "new", "z": 3},
                                          "id": 5}
    assert set(seen[15]["results"][0][0]) == {"id", "count"}


def test_directory_written_by_the_port_opens_in_jax(topn_dirs):
    """The port's writes (bits, row and column attrs) and the rank caches
    it leaves in `.cache` on close: the JAX package opens them and its
    host TopN, attrs and counts answer as the port's did."""
    _jdir, tdir = topn_dirs
    queries = ["TopN(frame=topn, n=6)", "TopN(frame=small, n=4)",
               'TopN(frame=topn, n=3, field="cat", filters=["b", "z"])',
               "Bitmap(rowID=5, frame=topn)",
               "Count(Bitmap(rowID=30, frame=topn))"]
    writes = [f"SetBit(rowID=30, frame=topn, columnID={c})"
              for c in range(0, 60000, 7)] + [
        'SetRowAttrs(frame=topn, rowID=5, cat="z")',
        "SetColumnAttrs(columnID=5, k=1)",
        "SetBit(rowID=1, frame=small, columnID=3)"]
    h = Holder(str(tdir))
    h.open()
    try:
        ex = Executor(h, device="cpu")
        for w in writes:
            ex.execute("i", parse_string(w))
        want = top_n_host_run(ex, queries)
    finally:
        h.close()
    assert want[3][2]["cat"] == "z"
    assert jax_run(tdir, queries, use_device=False) == want
    jh = JaxHolder(str(tdir))
    jh.open()
    try:
        assert jh.index("i").column_attr_store.attrs(5) == {"k": 1,
                                                           "tag": "c5"}
    finally:
        jh.close()
