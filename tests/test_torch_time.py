"""The port's time quantums against the JAX package: the view covers,
timestamped writes and the views they leave on disk, quantum inheritance,
the time Range (on the card's path, on the host past 32 views, over
views that do not exist and over sorted-array views), and the HTTP
routes of the quantum. Every answer is exact (tolerance 0: counts and
bits are integers). The data is made from a seed with numpy and written
by the JAX package; the port opens a copy of its directory.
"""

import os
import shutil
from datetime import datetime, timedelta

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.api.handler import Handler as JaxHandler
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.core import timequantum as jtq
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.pql import parse_string as jax_parse

from pilosa_tpu_torch.api.handler import Handler
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core import timequantum as ttq
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.parallel.plan import MAX_RANGE_VIEWS
from pilosa_tpu_torch.pql import parse_string
from torch_threads import one_torch_thread  # noqa: F401

QUANTUMS = sorted(jtq.VALID_QUANTUMS)
NUM_SLICES = 2
ROWS = 4

# -- the view covers ------------------------------------------------------------

times = st.datetimes(min_value=datetime(1999, 11, 1),
                     max_value=datetime(2001, 3, 1)).map(
    lambda t: t.replace(minute=0, second=0, microsecond=0))


@settings(max_examples=400, deadline=None)
@given(start=times, span_h=st.integers(0, 24 * 500),
       q=st.sampled_from(QUANTUMS))
def test_views_by_time_range_matches_jax(start, span_h, q):
    end = start + timedelta(hours=span_h)
    want = jtq.views_by_time_range("standard", start, end,
                                   jtq.TimeQuantum(q))
    assert ttq.views_by_time_range("standard", start, end,
                                   ttq.TimeQuantum(q)) == want


@settings(max_examples=200, deadline=None)
@given(start=st.datetimes(min_value=datetime(2000, 1, 28),
                          max_value=datetime(2000, 3, 3)),
       end=st.datetimes(min_value=datetime(2000, 1, 28),
                        max_value=datetime(2001, 3, 3)),
       q=st.sampled_from(QUANTUMS))
def test_month_and_year_edges_match_jax(start, end, q):
    """Starts and ends at any minute around the ends of January and
    February of a leap year, and ranges that end before they start."""
    want = jtq.views_by_time_range("inverse", start, end, jtq.TimeQuantum(q))
    assert ttq.views_by_time_range("inverse", start, end,
                                   ttq.TimeQuantum(q)) == want


@settings(max_examples=200, deadline=None)
@given(t=times, q=st.sampled_from(QUANTUMS + ["HDY", "xy", "YMDHX"]))
def test_views_by_time_matches_jax(t, q):
    assert ttq.views_by_time("standard", t, ttq.TimeQuantum(q)) == \
        jtq.views_by_time("standard", t, jtq.TimeQuantum(q))


@pytest.mark.parametrize("q", QUANTUMS + ["ymd", "YMDHY", "X", "DM"])
def test_parse_time_quantum_matches_jax(q):
    try:
        want = str(jtq.parse_time_quantum(q))
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            ttq.parse_time_quantum(q)
        return
    assert str(ttq.parse_time_quantum(q)) == want


# -- data --------------------------------------------------------------------


def day(d: int, h: int = 9) -> datetime:
    return datetime(2017, 4, 1, h) + timedelta(days=d - 1)


def write_events(path, seed: int = 31, dense_days=(), per_day: int = 200,
                 dense_n: int = 2500):
    """Index `i` (quantum YMDH), frame `events` inheriting it, frame
    `plain` with no quantum. Row r of `events` gets `per_day` seeded
    random columns on days 1-30 of April 2017 (and on March 31 and May
    1), across NUM_SLICES slices, at hour r; the days in `dense_days` get
    `dense_n` columns a slice instead, enough for a sorted-array slice.
    Returns {(row, datetime): columns}."""
    rng = np.random.default_rng(seed)
    jh = JaxHolder(str(path))
    jh.open()
    idx = jh.create_index("i", time_quantum="YMDH")
    f = idx.create_frame("events")
    idx.create_frame("plain", time_quantum="")
    bits = {}
    views: dict = {}  # what a timestamped import writes, view by view
    for d in range(0, 32):
        for r in range(ROWS):
            t = day(d, h=r)
            n = dense_n if d in dense_days else per_day
            c = np.unique(np.concatenate([
                rng.choice(SLICE_WIDTH, size=n, replace=False) + s * SLICE_WIDTH
                for s in range(NUM_SLICES)]))
            bits[(r, t)] = c
            for v in ["standard"] + jtq.views_by_time("standard", t,
                                                       f.time_quantum):
                views.setdefault(v, []).append((np.full(len(c), r), c))
    for name, parts in views.items():
        rows = np.concatenate([p[0] for p in parts])
        cols = np.concatenate([p[1] for p in parts])
        view = f.create_view_if_not_exists(name)
        for s in range(NUM_SLICES):
            m = cols // SLICE_WIDTH == s
            if m.any():
                view.create_fragment_if_not_exists(s).import_bits(rows[m],
                                                                  cols[m])
    jh.close()
    return bits


def truth(bits, r, start, end) -> int:
    cols = [c for (row, t), c in bits.items() if row == r and start <= t < end]
    return len(np.unique(np.concatenate(cols))) if cols else 0


def range_pql(r, start, end, frame="events"):
    return (f'Count(Range(rowID={r}, frame={frame}, '
            f'start="{start:%Y-%m-%dT%H:%M}", end="{end:%Y-%m-%dT%H:%M}"))')


def answers(execute, queries):
    out = []
    for q in queries:
        try:
            r = execute(q)
            out.append(sorted(int(c) for c in r.columns())
                       if hasattr(r, "columns") else r)
        except Exception as e:  # noqa: BLE001 — compared by type name
            out.append(("error", type(e).__name__))
    return out


def jax_answers(path, queries, use_device=True):
    jh = JaxHolder(str(path))
    jh.open()
    try:
        ex = JaxExecutor(jh, use_device=use_device, device_min_work=0)
        return answers(lambda q: ex.execute("i", jax_parse(q))[0], queries)
    finally:
        jh.close()


@pytest.fixture
def events(tmp_path, monkeypatch):
    """(JAX directory, port directory, bits): the same data twice."""
    monkeypatch.setenv("PILOSA_TPU_COUNT_BACKEND", "pallas_interpret")
    bits = write_events(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "torch")
    return tmp_path / "jax", tmp_path / "torch", bits


# (start, end, views in the cover under YMDH)
COVERS = [
    (datetime(2017, 4, 1), datetime(2017, 5, 1), 1),        # one month
    (datetime(2017, 4, 3), datetime(2017, 4, 10), 7),       # seven days
    (datetime(2017, 4, 1), datetime(2017, 4, 30), 29),      # K2's limit x2
    (datetime(2017, 3, 31), datetime(2017, 4, 3), 3),       # month edge
    (datetime(2017, 1, 1), datetime(2018, 1, 1), 1),        # one year
    (datetime(2017, 4, 2, 1), datetime(2017, 4, 2, 3), 2),  # hours
    (datetime(2016, 1, 1), datetime(2016, 1, 5), 4),        # absent views
]
WIDE = (datetime(2017, 4, 2, 1), datetime(2017, 4, 6, 7))  # 33 views


def test_cover_sizes():
    q = ttq.TimeQuantum("YMDH")
    for start, end, n in COVERS:
        assert len(ttq.views_by_time_range("standard", start, end, q)) == n
    assert len(ttq.views_by_time_range("standard", *WIDE, q)) \
        > MAX_RANGE_VIEWS


def test_time_ranges_match_jax(events):
    jdir, tdir, bits = events
    queries = [range_pql(r, s, e) for s, e, _ in COVERS + [WIDE + (0,)]
               for r in (0, 2)]
    queries += [range_pql(1, *COVERS[1][:2], frame="plain"),
                range_pql(7, *COVERS[0][:2]),
                'Count(Range(rowID=1, frame=events, start="2017-04-01T00:00"))',
                'Count(Range(rowID=1, frame=events, start="bad", '
                'end="2017-04-01T00:00"))',
                f"Count(Intersect({range_pql(1, *COVERS[2][:2])[6:-1]}, "
                f"{range_pql(1, *COVERS[1][:2])[6:-1]}))",
                f"Count(Union({range_pql(3, *COVERS[6][:2])[6:-1]}, "
                f"{range_pql(3, *COVERS[5][:2])[6:-1]}))",
                range_pql(0, *COVERS[1][:2])[6:-1]]
    want = jax_answers(jdir, queries)
    assert jax_answers(jdir, queries, use_device=False) == want
    h = Holder(str(tdir))
    h.open()
    try:
        ex = Executor(h, device="cpu")
        got = answers(lambda q: ex.execute("i", parse_string(q))[0], queries)
        mgr = ex.mesh_manager().stats
    finally:
        h.close()
    assert got == want
    for k, (s, e, _) in enumerate(COVERS + [WIDE + (0,)]):
        for j, r in enumerate((0, 2)):
            assert got[2 * k + j] == truth(bits, r, s, e)
    assert got[-7] == 0  # a frame without a quantum reads nothing
    # Every cover of at most 32 views ran on the card's path; the wide
    # ones, the quantum-less frame and the two bad calls on the host.
    assert ex.stats["count_host"] == 2 + 1 + 2
    assert mgr["absent_views"] == 2  # the 2016 cover: no view exists
    assert mgr["kernel:coarse_count_uniform"] > 0


def test_wide_cover_runs_on_one_launch(events):
    """A cover of more than K2's 16 leaves batches on K1, and two such
    Counts coalesced in one group read the right rows."""
    from pilosa_tpu_torch.parallel.plan import _lower_tree

    jdir, tdir, bits = events
    s, e, n = COVERS[2]
    queries = [range_pql(r, s, e) for r in range(ROWS)]
    want = jax_answers(jdir, queries)
    h = Holder(str(tdir))
    h.open()
    try:
        mgr = Executor(h, device="cpu").mesh_manager()
        group = []
        for q in queries + queries[:1]:
            leaves = []
            shape = _lower_tree(h, "i", parse_string(q).calls[0].children[0],
                                leaves)
            assert len(leaves) == n
            group.append(mgr._resolve("i", shape, leaves,
                                      list(range(NUM_SLICES)), NUM_SLICES))
        mgr._run_count_group(group)
        assert [r.result for r in group] == want + want[:1]
        assert mgr.stats["kernel:coarse_count_uniform_batch"] == 1
        assert mgr.stats["deduped"] == 1
    finally:
        h.close()


def test_sorted_array_day_views(tmp_path, monkeypatch):
    """Days 3-9 hold 2,500 columns a slice: their views stage as sorted
    arrays at the default threshold. A two-day cover runs on K4, a wider
    one demotes the views to packed words."""
    monkeypatch.setenv("PILOSA_TPU_COUNT_BACKEND", "pallas_interpret")
    bits = write_events(tmp_path / "jax", dense_days=range(3, 10))
    shutil.copytree(tmp_path / "jax", tmp_path / "torch")
    covers = [(datetime(2017, 4, 3), datetime(2017, 4, 5)),
              (datetime(2017, 4, 4), datetime(2017, 4, 5)),
              (datetime(2017, 4, 3), datetime(2017, 4, 10))]
    queries = [range_pql(r, s, e) for s, e in covers for r in (0, 3)]
    want = jax_answers(tmp_path / "jax", queries)
    h = Holder(str(tmp_path / "torch"))
    h.open()
    try:
        ex = Executor(h, device="cpu")
        got = answers(lambda q: ex.execute("i", parse_string(q))[0], queries)
        stats = ex.mesh_manager().stats
    finally:
        h.close()
    assert got == want
    assert got == [truth(bits, r, s, e) for s, e in covers for r in (0, 3)]
    assert stats["stage_sparse_slices"] > 0
    assert stats["kernel:sparse_pair_count"] > 0
    assert stats["sparse_leaf_host"] > 0
    assert stats["sparse_demote"] > 0
    assert ex.stats["count_device"] == len(queries)


# -- writes ------------------------------------------------------------------

WRITES = [
    'SetBit(rowID=1, frame=f, columnID=3, timestamp="2017-03-04T05:06")',
    'SetBit(rowID=1, frame=f, columnID=3, timestamp="2017-03-04T05:06")',
    f'SetBit(rowID=2, frame=f, columnID={SLICE_WIDTH + 8}, '
    'timestamp="2018-12-31T23:59")',
    'SetBit(rowID=2, frame=f, columnID=9)',
    'SetBit(rowID=4, frame=f, columnID=9, timestamp="2017-13-01T00:00")',
    'SetBit(rowID=4, frame=f, columnID=9, timestamp=5)',
    'ClearBit(rowID=1, frame=f, columnID=3, timestamp="2017-03-04T05:06")',
    'ClearBit(rowID=2, frame=f, columnID=9)',
    'SetBit(rowID=1, frame=f, columnID=3, timestamp="2017-03-05T00:00")',
    'Count(Range(rowID=1, frame=f, start="2017-03-01T00:00", '
    'end="2017-04-01T00:00"))',
    'Count(Range(rowID=2, frame=f, start="2018-12-31T23:00", '
    'end="2019-01-01T00:00"))',
    'Range(rowID=1, frame=f, start="2017-03-04T00:00", '
    'end="2017-03-05T00:00")',
    'Bitmap(columnID=3, frame=f)',
]


def on_disk(path):
    """{(frame, view, slice): fragment file bits} under index `i`."""
    from pilosa_tpu.roaring import Bitmap as JaxBitmap

    out = {}
    root = os.path.join(path, "i")
    for frame in sorted(os.listdir(root)):
        if not os.path.isdir(os.path.join(root, frame)):
            continue
        for view in sorted(os.listdir(os.path.join(root, frame))):
            frags = os.path.join(root, frame, view, "fragments")
            if not os.path.isdir(frags):
                continue
            for name in os.listdir(frags):
                if name.isdigit():
                    with open(os.path.join(frags, name), "rb") as fh:
                        bm = JaxBitmap.from_bytes(fh.read())
                    out[(frame, view, int(name))] = sorted(bm.slice().tolist())
    return out


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("quantum", ["YMD", "YMDH", "MD", ""])
def test_timestamped_writes_leave_the_same_views(tmp_path, inverse, quantum):
    """The same writes through both executors: the same answers, frame
    metas and views on disk (the frame inherits the index's quantum)."""
    def run(holder_cls, executor, parse, path):
        h = holder_cls(str(path))
        h.open()
        h.create_index("i", time_quantum=quantum).create_frame(
            "f", inverse_enabled=inverse)
        ex = executor(h)
        got = answers(lambda q: ex.execute("i", parse(q))[0], WRITES)
        meta = h.index("i").frame("f").to_dict()["meta"]
        views = sorted(h.index("i").frame("f").views)
        h.close()
        return got, meta, views, on_disk(path)

    want = run(JaxHolder, lambda h: JaxExecutor(h, use_device=False),
               jax_parse, tmp_path / "jax")
    got = run(Holder, lambda h: Executor(h, device="cpu"), parse_string,
              tmp_path / "torch")
    assert got == want
    assert got[1]["timeQuantum"] == quantum
    if quantum == "YMD":
        assert ("f", "standard_20170304", 0) in got[3]
        assert (("f", "inverse_2017", 0) in got[3]) == inverse


def test_frame_quantum_overrides_the_index(tmp_path):
    h = Holder(str(tmp_path))
    h.open()
    try:
        idx = h.create_index("i", time_quantum="YM")
        assert str(idx.create_frame("a").time_quantum) == "YM"
        assert str(idx.create_frame("b", time_quantum="D").time_quantum) \
            == "D"
        idx.set_time_quantum(ttq.TimeQuantum("Y"))
        assert str(idx.create_frame("c").time_quantum) == "Y"
        assert str(idx.frame("a").time_quantum) == "YM"
    finally:
        h.close()
    h = Holder(str(tmp_path))
    h.open()
    try:
        assert {n: str(f.time_quantum) for n, f in
                h.index("i").frames.items()} == {"a": "YM", "b": "D",
                                                 "c": "Y"}
        assert str(h.index("i").time_quantum) == "Y"
    finally:
        h.close()


def test_directory_written_by_jax_answers_the_same(events):
    """Time views written by the JAX package, opened by the port: the
    same views, the same Range answers, then the same answers again
    after the port writes more timestamped bits and reopens."""
    jdir, tdir, bits = events
    queries = [range_pql(r, s, e) for s, e, _ in COVERS[:3] for r in range(4)]
    want = jax_answers(jdir, queries)
    jh = JaxHolder(str(jdir))
    jh.open()
    jviews = sorted(jh.index("i").frame("events").views)
    jh.close()
    h = Holder(str(tdir))
    h.open()
    try:
        assert sorted(h.index("i").frame("events").views) == jviews
        ex = Executor(h, device="cpu")
        assert answers(lambda q: ex.execute("i", parse_string(q))[0],
                       queries) == want
        ex.execute("i", parse_string(
            'SetBit(rowID=0, frame=events, columnID=77, '
            'timestamp="2017-04-05T00:30")'))
    finally:
        h.close()
    h = Holder(str(tdir))
    h.open()
    try:
        ex = Executor(h, device="cpu")
        got = answers(lambda q: ex.execute("i", parse_string(q))[0], queries)
    finally:
        h.close()
    assert 77 in on_disk(tdir)[("events", "standard_2017040500", 0)]
    assert got == jax_answers(tdir, queries)
    new = not any(77 in c for (r, t), c in bits.items()
                  if r == 0 and t.month == 4)
    assert got[0] == want[0] + new


# -- HTTP --------------------------------------------------------------------

HTTP = [
    ("POST", "/index/i", b'{"options": {"timeQuantum": "YMD"}}'),
    ("POST", "/index/i/frame/f", b"{}"),
    ("POST", "/index/i/frame/g",
     b'{"options": {"timeQuantum": "YM", "cacheType": "lru", '
     b'"cacheSize": 10, "inverseEnabled": true}}'),
    ("POST", "/index/i/frame/h", b'{"options": {"timeQuantm": "Y"}}'),
    ("POST", "/index/i/query",
     b'SetBit(rowID=1, frame=f, columnID=3, timestamp="2017-04-02T09:00")'),
    ("POST", "/index/i/query",
     b'SetBit(rowID=1, frame=g, columnID=3, timestamp="2017-04-02T09:00")'),
    ("POST", "/index/i/query",
     b'SetBit(rowID=1, frame=f, columnID=9, timestamp="2017-04-02T9:00")'),
    ("GET", "/index/i/frame/f/views", b""),
    ("GET", "/index/i/frame/g/views", b""),
    ("GET", "/index/i/frame/nosuch/views", b""),
    ("POST", "/index/i/query",
     b'Count(Range(rowID=1, frame=f, start="2017-04-01T00:00", '
     b'end="2017-04-30T00:00"))'),
    ("POST", "/index/i/query",
     b'Range(rowID=1, frame=g, start="2017-01-01T00:00", '
     b'end="2017-05-01T00:00")'),
    ("PATCH", "/index/i/time-quantum", b'{"timeQuantum": "YMDH"}'),
    ("PATCH", "/index/i/time-quantum", b'{"timeQuantum": "Q"}'),
    ("PATCH", "/index/nosuch/time-quantum", b'{"timeQuantum": "Y"}'),
    ("POST", "/index/i/frame/k", b"{}"),
    ("PATCH", "/index/i/frame/f/time-quantum", b'{"timeQuantum": "y"}'),
    ("PATCH", "/index/i/frame/nosuch/time-quantum", b'{"timeQuantum": "Y"}'),
    ("POST", "/index/i/query",
     b'SetBit(rowID=2, frame=f, columnID=3, timestamp="2017-04-02T09:00")'),
    ("GET", "/index/i/frame/f/views", b""),
    ("POST", "/index/i/query",
     b'SetBit(rowID=2, frame=k, columnID=3, timestamp="2017-04-02T09:00")'),
    ("GET", "/index/i/frame/k/views", b""),
    ("DELETE", "/index/i/time-quantum", b""),
    ("GET", "/schema", b""),
]


def test_http_json_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_COUNT_BACKEND", "pallas_interpret")
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    th = Holder(str(tmp_path / "torch"))
    th.open()
    try:
        jax_handler = JaxHandler(jh, JaxExecutor(jh, use_device=True,
                                                 device_min_work=0))
        handler = Handler(th, Executor(th, device="cpu"))
        seen = []
        for method, path, body in HTTP:
            want = jax_handler.handle(method, path, {}, {}, body)
            got = handler.handle(method, path, {}, {}, body)
            assert (got.status, got.json()) == (want.status, want.json()), \
                (method, path, body)
            seen.append((got.status, got.json()))
        # The time Range answers 200 and sees the timestamped bit.
        assert seen[10] == (200, {"results": [2]})
        assert seen[7][1]["views"] == ["standard", "standard_2017",
                                       "standard_201704", "standard_20170402"]
    finally:
        jh.close()
        th.close()
