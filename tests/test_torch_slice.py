"""The port's serving slice against the JAX package, end to end.

A holder built on disk by pilosa_tpu (dense rows staged as aligned
whole-row runs, partial rows that gather container by container, two
frames, an inverse view, more than one slice) answers a list of PQL
queries through the JAX Executor on its device path (Pallas in
interpret mode); the port's Executor(device="cpu") answers the same
queries over the same directory. Also compared: the HTTP JSON of the
Quickstart requests, counts over a pool staged by the JAX package and
carried across with staged_from_numpy, and coalesced concurrent counts.
"""

import threading

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.api.handler import Handler as JaxHandler
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.parallel.mesh import build_sharded_index as jax_build
from pilosa_tpu.pql import parse_string as jax_parse
from pilosa_tpu.roaring import Bitmap as JaxBitmap

from pilosa_tpu_torch.api.handler import Handler
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops.kernels import MAX_LEAVES
from pilosa_tpu_torch.parallel import serve as torch_serve
from pilosa_tpu_torch.ops.pool import pack_bitmap
from pilosa_tpu_torch.parallel.mesh import (build_sharded_index, count_rows,
                                            leaf_layout, staged_from_numpy)
from pilosa_tpu_torch.pql import parse_string
from pilosa_tpu_torch.roaring import Bitmap, Container
from torch_threads import one_torch_thread  # noqa: F401

NUM_SLICES = 2
DENSE_ROWS = (0, 1, 2, 3)
PARTIAL_ROWS = (4, 5)


def seed_holder(path):
    """Rows 0-3 hold all 16 containers of both slices (aligned runs);
    rows 4-5 hold a few containers of slice 0 only or of both. Frame
    `g` has an inverse view."""
    rng = np.random.default_rng(20)
    h = JaxHolder(str(path))
    h.open()
    idx = h.create_index_if_not_exists("i")
    f = idx.create_frame_if_not_exists("general")
    rows, cols = [], []
    for r in DENSE_ROWS:
        for s in range(NUM_SLICES):
            c = rng.choice(SLICE_WIDTH, size=6000, replace=False)
            rows.append(np.full(c.size, r))
            cols.append(c + s * SLICE_WIDTH)
    for r, slices in ((4, (0,)), (5, (0, 1))):
        for s in slices:
            blocks = rng.choice(16, size=5, replace=False)
            c = np.unique(blocks[:, None] * 65536
                          + rng.integers(0, 65536, size=(5, 300)))
            rows.append(np.full(c.size, r))
            cols.append(c + s * SLICE_WIDTH)
    f.import_bits(np.concatenate(rows), np.concatenate(cols))
    g = idx.create_frame_if_not_exists("g", inverse_enabled=True)
    for r, c in ((1, 3), (1, 5), (2, 5), (7, SLICE_WIDTH + 5), (2, 3)):
        g.set_bit(r, c)
    h.close()


QUERIES = [
    "Count(Intersect(Bitmap(rowID=0), Bitmap(rowID=1)))",
    "Count(Union(Bitmap(rowID=2), Bitmap(rowID=3)))",
    "Count(Difference(Bitmap(rowID=1), Bitmap(rowID=0)))",
    "Count(Union(Intersect(Bitmap(rowID=0), Bitmap(rowID=1)), "
    "Difference(Bitmap(rowID=2), Bitmap(rowID=3))))",
    "Count(Intersect(Bitmap(rowID=4), Bitmap(rowID=0)))",
    "Count(Union(Bitmap(rowID=5), Bitmap(rowID=4)))",
    "Count(Intersect(Bitmap(rowID=99), Bitmap(rowID=1)))",
    "Count(Bitmap(rowID=5))",
    "Count(Intersect(Bitmap(rowID=1, frame=g), Bitmap(rowID=2, frame=g)))",
    "Count(Bitmap(columnID=5, frame=g))",
    "Bitmap(rowID=2, frame=g)",
    "Intersect(Bitmap(rowID=1, frame=g), Bitmap(rowID=2, frame=g))",
    "Union(Bitmap(rowID=7, frame=g), Bitmap(rowID=1, frame=g))",
    "Count(Bitmap(rowID=1, frame=nosuch))",
]


def as_plain(result):
    if hasattr(result, "columns"):
        return ("row", [int(c) for c in result.columns()])
    return result


def jax_answers(path, queries):
    h = JaxHolder(str(path))
    h.open()
    try:
        ex = JaxExecutor(h, use_device=True, device_min_work=0)
        out = []
        for q in queries:
            try:
                out.append(as_plain(ex.execute("i", jax_parse(q))[0]))
            except Exception as e:  # noqa: BLE001 — compared by type name
                out.append(("error", type(e).__name__))
        return out
    finally:
        h.close()


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_COUNT_BACKEND", "pallas_interpret")
    seed_holder(tmp_path / "data")
    return tmp_path / "data"


@pytest.fixture
def port_holder(data_dir):
    h = Holder(str(data_dir))
    h.open()
    yield h
    h.close()


def test_queries_match_jax(data_dir):
    want = jax_answers(data_dir, QUERIES)
    h = Holder(str(data_dir))
    h.open()
    try:
        # Threshold 0: every slice stages dense, so the dense kernels
        # serve (tests/test_torch_sparse.py covers the sorted arrays).
        ex = Executor(h, device="cpu", sparse_density_threshold=0)
        got = []
        for q in QUERIES:
            try:
                got.append(as_plain(ex.execute("i", parse_string(q))[0]))
            except Exception as e:  # noqa: BLE001
                got.append(("error", type(e).__name__))
        assert got == want
        # Every lowerable Count ran on the device path.
        assert ex.stats["count_device"] == 10
        stats = ex.mesh_manager().stats
        assert stats["kernel:tree_count_rows"] >= 3
        assert stats["kernel:coarse_count_uniform"] >= 3
    finally:
        h.close()


def test_unlowerable_tree_counts_on_host(port_holder):
    ex = Executor(port_holder, device="cpu")
    # MAX_LEAVES + 1 distinct rows is beyond the kernels' limit (repeated
    # rows share a leaf, so they must be distinct). Rows past 5 are
    # absent, so the union of rows 0-7 counts the same columns.
    q = "Count(Union(" + ", ".join(
        f"Bitmap(rowID={i})" for i in range(MAX_LEAVES + 1)) + "))"
    n = ex.execute("i", parse_string(q))[0]
    want = ex.execute("i", parse_string("Count(Union(" + ", ".join(
        f"Bitmap(rowID={i})" for i in range(8)) + "))"))[0]
    assert n == want
    assert ex.stats["count_host"] == 1 and ex.stats["count_device"] == 1


def test_write_restages_view(port_holder):
    ex = Executor(port_holder, device="cpu")
    q = parse_string("Count(Bitmap(columnID=3, frame=g))")
    before = ex.execute("i", q)[0]
    assert ex.execute("i", parse_string(
        "SetBit(rowID=9, frame=g, columnID=3)"))[0] is True
    assert ex.execute("i", q)[0] == before + 1
    assert ex.execute("i", parse_string(
        "ClearBit(rowID=1, frame=g, columnID=3)"))[0] is True
    assert ex.execute("i", q)[0] == before
    # Both writes land in an existing container of the staged view, so
    # each reaches it as a scatter, not a restage.
    stats = ex.mesh_manager().stats
    assert stats["stage"] == 1 and stats["incremental"] == 2


def test_staged_from_numpy_round_trip(data_dir, port_holder):
    # The bitmaps go through the file format (the JAX holder's flocks
    # would collide with the open port holder's), then the JAX package
    # stages them.
    bitmaps = [JaxBitmap.from_bytes(port_holder.fragment(
        "i", "general", "standard", s).storage.to_bytes())
        for s in range(NUM_SLICES)]
    sharded, row_ids, keys = jax_build(bitmaps, None, with_host_keys=True)
    staged = staged_from_numpy(keys, np.asarray(sharded.words), row_ids,
                               "cpu")
    ex = Executor(port_holder, device="cpu")
    for tree, rows in ((["and", ["leaf", 0], ["leaf", 1]], (0, 1)),
                       (["or", ["leaf", 0], ["leaf", 1]], (4, 5)),
                       (["andnot", ["leaf", 0], ["leaf", 1]], (2, 99))):
        op = {"and": "Intersect", "or": "Union", "andnot": "Difference"}
        want = ex.execute("i", parse_string(
            f"Count({op[tree[0]]}(Bitmap(rowID={rows[0]}), "
            f"Bitmap(rowID={rows[1]})))"))[0]
        got = count_rows([staged, staged], tree, rows, range(NUM_SLICES))
        assert got == want


def test_row_without_its_first_container_counts_every_slice(tmp_path):
    """Row 0 is dense in slice 0 but holds only blocks 8-15 of slice 1;
    row 1 is dense in slice 0 only. Slice 1 still holds row 0, so the
    row is not a whole-run (coarse) row and its count must include
    slice 1. Held against the host popcount of the written words."""
    rng = np.random.default_rng(21)
    words = np.zeros((2, 2, 16, 1024), dtype=np.uint64)
    words[0] = rng.integers(0, 2**64, size=words[0].shape, dtype=np.uint64)
    words[1, 0, 8:] = rng.integers(0, 2**64, size=(8, 1024), dtype=np.uint64)
    h = Holder(str(tmp_path))
    h.open()
    try:
        view = h.create_index("i").create_frame("f").create_view_if_not_exists(
            "standard")
        for s in range(2):
            bm = Bitmap()
            for r in range(2):
                for b in range(16):
                    if words[s, r, b].any():
                        bm.keys.append(r * 16 + b)
                        bm.containers.append(Container(bitmap=words[s, r, b]))
            view.create_fragment_if_not_exists(s).replace(bm)
        ex = Executor(h, device="cpu")
        for q, want in (
                ("Count(Bitmap(rowID=0, frame=f))", words[:, 0]),
                ("Count(Union(Bitmap(rowID=0, frame=f), "
                 "Bitmap(rowID=1, frame=f)))", words[:, 0] | words[:, 1]),
                ("Count(Difference(Bitmap(rowID=0, frame=f), "
                 "Bitmap(rowID=1, frame=f)))", words[:, 0] & ~words[:, 1])):
            got = ex.execute("i", parse_string(q))[0]
            assert got == int(np.bitwise_count(want).sum(dtype=np.int64)), q
        staged = build_sharded_index(
            [pack_bitmap(view.fragment(s).storage) for s in range(2)], "cpu")
        assert leaf_layout(staged.keys_host, 0).starts is None
        assert ex.mesh_manager().stats["kernel:tree_count_rows"] == 3
    finally:
        h.close()


def test_files_written_by_the_port_open_in_jax(tmp_path):
    """The port's writes (op log, bulk import with its snapshot) read
    back identically through the JAX package's storage layer."""
    h = Holder(str(tmp_path))
    h.open()
    f = h.create_index("i").create_frame("f")
    ex = Executor(h, device="cpu")
    ex.execute("i", parse_string("SetBit(rowID=3, frame=f, columnID=5)"))
    ex.execute("i", parse_string(
        f"SetBit(rowID=3, frame=f, columnID={SLICE_WIDTH + 9})"))
    frag = f.view("standard").fragment(0)
    frag.import_bits([4] * 5000, list(range(0, 10000, 2)))
    ex.execute("i", parse_string("ClearBit(rowID=4, frame=f, columnID=2)"))
    queries = ["Count(Bitmap(rowID=3, frame=f))",
               "Count(Union(Bitmap(rowID=3, frame=f), Bitmap(rowID=4, frame=f)))",
               "Bitmap(rowID=3, frame=f)"]
    want = [as_plain(ex.execute("i", parse_string(q))[0]) for q in queries]
    h.close()
    jh = JaxHolder(str(tmp_path))
    jh.open()
    try:
        jex = JaxExecutor(jh, use_device=False)
        got = [as_plain(jex.execute("i", jax_parse(q))[0]) for q in queries]
    finally:
        jh.close()
    assert got == want == [2, 2 + 4999, ("row", [5, SLICE_WIDTH + 9])]


PAIRS = [(a, b) for a in DENSE_ROWS for b in DENSE_ROWS if a < b]


def pair_query(a, b):
    return f"Count(Intersect(Bitmap(rowID={a}), Bitmap(rowID={b})))"


def test_coalesced_group_matches_jax(data_dir):
    want = jax_answers(data_dir, [pair_query(a, b) for a, b in PAIRS])
    h = Holder(str(data_dir))
    h.open()
    try:
        ex = Executor(h, device="cpu", sparse_density_threshold=0)
        mgr = ex.mesh_manager()
        from pilosa_tpu_torch.parallel.plan import _lower_tree

        group = []
        for a, b in PAIRS + PAIRS[:2]:  # two duplicates collapse
            leaves = []
            shape = _lower_tree(h, "i", parse_string(
                pair_query(a, b)).calls[0].children[0], leaves)
            group.append(mgr._resolve("i", shape, leaves, [0, 1], 2))
        mgr._run_count_group(group)
        assert [r.result for r in group] == want + want[:2]
        assert mgr.stats["deduped"] == 2
        assert mgr.stats["shared_batch"] == len(PAIRS)
    finally:
        h.close()


def test_concurrent_counts_coalesce(port_holder, monkeypatch):
    """Counts that arrive while another is in flight queue to the batch
    thread and run as one launch (dense views: sorted-array counts run
    on the calling thread)."""
    ex = Executor(port_holder, device="cpu", sparse_density_threshold=0)
    want = [ex.execute("i", parse_string(pair_query(a, b)))[0]
            for a, b in PAIRS]
    mgr = ex.mesh_manager()
    queued = threading.Event()
    real = torch_serve.count_batch

    def gated(*args, **kwargs):
        queued.wait(10)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch_serve, "count_batch", gated)
    mgr._counts_inflight = 1  # a count already in flight: nobody is lone
    got = [None] * len(PAIRS)

    def run(i, a, b):
        got[i] = ex.execute("i", parse_string(pair_query(a, b)))[0]

    threads = [threading.Thread(target=run, args=(i, a, b))
               for i, (a, b) in enumerate(PAIRS)]
    for t in threads:
        t.start()
    while mgr._batch_q.qsize() < len(PAIRS) - 1 and any(
            t.is_alive() for t in threads):
        threading.Event().wait(0.01)
    queued.set()
    for t in threads:
        t.join(30)
    assert got == want
    assert mgr.stats["batched"] > 0


QUICKSTART = [
    ("POST", "/index/i", b"{}"),
    ("POST", "/index/i/frame/f", b"{}"),
    ("POST", "/index/i/query", b"SetBit(rowID=1, frame=f, columnID=7)"),
    ("POST", "/index/i/query", b"SetBit(rowID=2, frame=f, columnID=7)"),
    ("POST", "/index/i/query", b"SetBit(rowID=2, frame=f, columnID=1050000)"),
    ("POST", "/index/i/query",
     b"Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f)))"),
    ("POST", "/index/i/query", b"Bitmap(rowID=2, frame=f)"),
    ("POST", "/index/i/query", b"ClearBit(rowID=2, frame=f, columnID=7)"),
    ("POST", "/index/i/query",
     b"Count(Union(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f)))"),
    ("GET", "/schema", b""),
    ("POST", "/index/i", b"{}"),
    ("POST", "/index/nosuch/frame/f", b"{}"),
    ("POST", "/index/i/query", b"Count(Bitmap(rowID=1, frame=f)"),
]


def test_quickstart_http_json_matches_jax(tmp_path):
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    th = Holder(str(tmp_path / "torch"))
    th.open()
    try:
        jax_handler = JaxHandler(jh, JaxExecutor(jh, use_device=True,
                                                 device_min_work=0))
        handler = Handler(th, Executor(th, device="cpu"))
        for method, path, body in QUICKSTART:
            want = jax_handler.handle(method, path, {}, {}, body)
            got = handler.handle(method, path, {}, {}, body)
            assert (got.status, got.json()) == (want.status, want.json()), \
                (method, path, body)
    finally:
        jh.close()
        th.close()



C1_QUERIES = ["Bitmap(col=5, frame=g)", "Bitmap(columnID=5, frame=g)",
              "Count(Bitmap(col=5, frame=g))",
              "Count(Bitmap(columnID=5, frame=g))"]


def c1_answers(execute, queries):
    out = []
    for q in queries:
        try:
            out.append(as_plain(execute(q)))
        except Exception as e:  # noqa: BLE001 — compared by type name
            out.append(("error", type(e).__name__))
    return out


@pytest.mark.parametrize("slices", [[0], None])
def test_explicit_slices_with_a_custom_column_label(tmp_path, slices):
    """With ?slices= given, a Bitmap is a column Bitmap only when it names
    the default label "columnID" (and then reads no slice); without them,
    by the index's own label. Index `i` has columnLabel "col" and an
    inverse-enabled frame `g` with bits (1, 5) and (2, 5)."""
    import shutil

    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    g = jh.create_index("i", column_label="col").create_frame(
        "g", inverse_enabled=True)
    g.set_bit(1, 5)
    g.set_bit(2, 5)
    jh.close()
    shutil.copytree(tmp_path / "jax", tmp_path / "torch")
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    try:
        jex = JaxExecutor(jh, use_device=False)
        want = c1_answers(
            lambda q: jex.execute("i", jax_parse(q), slices)[0], C1_QUERIES)
    finally:
        jh.close()
    h = Holder(str(tmp_path / "torch"))
    h.open()
    try:
        ex = Executor(h, device="cpu")
        got = c1_answers(
            lambda q: ex.execute("i", parse_string(q), slices)[0], C1_QUERIES)
    finally:
        h.close()
    assert got == want
    assert got[0] == ("row", [1, 2])
    if slices:
        assert got[1] == ("row", [])
