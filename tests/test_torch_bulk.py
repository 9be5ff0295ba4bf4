"""Bulk data in and out of the port against the JAX package: the wire
codec against `pilosa_tpu/wire/pilosa_pb2.py` byte for byte, the bulk
and read-only routes of both handlers driven with the same requests,
Frame.import_bits, the fragment tar (a flipped byte included), frame
restore between two servers of each package on 127.0.0.1, the ctl's
import / export / backup / restore, and Count, TopN and time Range
through the port's executor (device="cpu") after an import and after a
restore, at thresholds 0 and 0.05. Every answer is exact (tolerance 0:
bits and counts are integers). Times in a CSV are local times: the
tests that read one set a zone east of UTC, and their truths go through
the same conversion.
"""

import io
import json
import os
import tarfile
import time
from datetime import datetime, timezone

import numpy as np
import pytest
from google.protobuf.message import DecodeError as PbDecodeError
from hypothesis import given, settings
from hypothesis import strategies as st

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.api.client import InternalClient as JaxClient
from pilosa_tpu.api.handler import Handler as JaxHandler
from pilosa_tpu.api.server import APIServer as JaxAPIServer
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.ctl import main as jax_ctl
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.pql import parse_string as jax_parse
from pilosa_tpu.wire import PROTOBUF_CT
from pilosa_tpu.wire import pilosa_pb2 as pb

from pilosa_tpu_torch import wire
from pilosa_tpu_torch.api.client import InternalClient
from pilosa_tpu_torch.api.handler import Handler
from pilosa_tpu_torch.api.server import APIServer
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.ctl import main as port_ctl
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.pql import parse_string
from torch_threads import one_torch_thread  # noqa: F401

# -- the wire codec ----------------------------------------------------------------

u64 = st.integers(0, 2**64 - 1)
i64 = st.integers(-2**63, 2**63 - 1)
name = st.text(max_size=10)


def varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def tag(num: int, wt: int) -> bytes:
    return varint((num << 3) | wt)


@settings(max_examples=200, deadline=None)
@given(index=name, frame=name, slice_=u64, rows=st.lists(u64, max_size=30),
       cols=st.lists(u64, max_size=30), ts=st.lists(i64, max_size=30))
def test_import_request_bytes_both_ways(index, frame, slice_, rows, cols, ts):
    ref = pb.ImportRequest(index=index, frame=frame, slice=slice_)
    ref.row_ids.extend(rows)
    ref.column_ids.extend(cols)
    ref.timestamps.extend(ts)
    want = ref.SerializeToString()
    got = wire.ImportRequest(index=index, frame=frame, slice=slice_,
                             row_ids=rows, column_ids=cols, timestamps=ts)
    assert got.encode() == want
    assert wire.ImportRequest.decode(want).to_dict() == {
        "index": index, "frame": frame, "slice": slice_, "row_ids": rows,
        "column_ids": cols, "timestamps": ts}


@settings(max_examples=100, deadline=None)
@given(index=name, frame=name, view=name, slice_=u64, block=u64,
       rows=st.lists(u64, max_size=30), cols=st.lists(u64, max_size=30),
       err=name)
def test_block_and_response_messages_both_ways(index, frame, view, slice_,
                                               block, rows, cols, err):
    req = pb.BlockDataRequest(index=index, frame=frame, view=view,
                              slice=slice_, block=block)
    got = wire.BlockDataRequest(index=index, frame=frame, view=view,
                                slice=slice_, block=block)
    assert got.encode() == req.SerializeToString()
    assert wire.BlockDataRequest.decode(req.SerializeToString()) == got
    resp = pb.BlockDataResponse()
    resp.row_ids.extend(rows)
    resp.column_ids.extend(cols)
    got = wire.BlockDataResponse(row_ids=rows, column_ids=cols)
    assert got.encode() == resp.SerializeToString()
    assert wire.BlockDataResponse.decode(resp.SerializeToString()) == got
    ir = pb.ImportResponse(err=err)
    assert wire.ImportResponse(err=err).encode() == ir.SerializeToString()
    assert wire.ImportResponse.decode(ir.SerializeToString()).err == err


@settings(max_examples=100, deadline=None)
@given(maxes=st.dictionaries(name, u64, max_size=8))
def test_max_slices_response_by_parsed_dict(maxes):
    """Map order is not fixed, so each side parses the other's bytes."""
    ref = pb.MaxSlicesResponse()
    for k, v in maxes.items():
        ref.max_slices[k] = v
    assert wire.MaxSlicesResponse.decode(
        ref.SerializeToString()).max_slices == maxes
    back = pb.MaxSlicesResponse()
    back.ParseFromString(wire.MaxSlicesResponse(max_slices=maxes).encode())
    assert dict(back.max_slices) == maxes
    for k, v in maxes.items():  # one entry: the bytes themselves
        one = pb.MaxSlicesResponse()
        one.max_slices[k] = v
        assert wire.MaxSlicesResponse(
            max_slices={k: v}).encode() == one.SerializeToString()


def _known(num, kind):
    if kind == "string":
        return name.map(lambda s: tag(num, 2) + varint(len(s.encode()))
                        + s.encode())
    if kind == "scalar":
        return u64.map(lambda v: tag(num, 0) + varint(v))
    if kind == "unpacked":
        return u64.map(lambda v: tag(num, 0) + varint(v))
    return st.lists(u64, min_size=0, max_size=6).map(
        lambda vs: tag(num, 2) + varint(len(b"".join(map(varint, vs))))
        + b"".join(map(varint, vs)))


unknown = st.one_of(
    st.tuples(st.integers(7, 3000), u64).map(
        lambda t: tag(t[0], 0) + varint(t[1])),
    st.tuples(st.integers(7, 3000), st.binary(min_size=8, max_size=8)).map(
        lambda t: tag(t[0], 1) + t[1]),
    st.tuples(st.integers(7, 3000), st.binary(max_size=12)).map(
        lambda t: tag(t[0], 2) + varint(len(t[1])) + t[1]),
    st.tuples(st.integers(7, 3000), st.binary(min_size=4, max_size=4)).map(
        lambda t: tag(t[0], 5) + t[1]),
    # Known fields under another wire type are unknown fields too.
    st.binary(max_size=6).map(lambda b: tag(3, 2) + varint(len(b)) + b),
    u64.map(lambda v: tag(1, 0) + varint(v)))

records = st.lists(st.one_of(
    _known(1, "string"), _known(2, "string"), _known(3, "scalar"),
    _known(4, "unpacked"), _known(4, "packed"), _known(5, "unpacked"),
    _known(5, "packed"), _known(6, "unpacked"), _known(6, "packed"),
    unknown), max_size=20)


@settings(max_examples=300, deadline=None)
@given(parts=records)
def test_unpacked_repeats_and_unknown_fields_parse_as_pb(parts):
    """Repeated fields unpacked, packed runs mixed with them in any order,
    a scalar field written twice (the last wins), unknown fields of every
    wire type: the port parses what pilosa_pb2 parses."""
    body = b"".join(parts)
    ref = pb.ImportRequest()
    ref.ParseFromString(body)
    assert wire.ImportRequest.decode(body).to_dict() == {
        "index": ref.index, "frame": ref.frame, "slice": ref.slice,
        "row_ids": list(ref.row_ids), "column_ids": list(ref.column_ids),
        "timestamps": list(ref.timestamps)}


MALFORMED = [b"\x20", b"\x0a\x05ab", b"\x22\x02\x80", b"\x0a\x02\xff\xfe",
             b"\x20" + b"\xff" * 10 + b"\x01", b"\x00\x01", b"\x0c",
             b"\x0b\x08\x01", b"\x0f", b"\x22\x02\x01"]


@pytest.mark.parametrize("body", MALFORMED)
def test_malformed_bodies_fail_in_both(body):
    with pytest.raises(PbDecodeError):
        pb.ImportRequest().ParseFromString(body)
    with pytest.raises(wire.DecodeError):
        wire.ImportRequest.decode(body)


def test_a_slice_of_an_import_round_trips():
    """~200,000 bits, the chip's request size, both ways byte for byte."""
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 8, 200_000).astype(np.uint64)
    cols = rng.integers(0, 960 << 20, 200_000).astype(np.uint64)
    ref = pb.ImportRequest(index="imp", frame="sparse", slice=5)
    ref.row_ids.extend(rows.tolist())
    ref.column_ids.extend(cols.tolist())
    body = wire.ImportRequest(index="imp", frame="sparse", slice=5,
                              row_ids=rows, column_ids=cols).encode()
    assert body == ref.SerializeToString()
    back = wire.ImportRequest.decode(body)
    assert np.array_equal(back.row_ids, rows)
    assert np.array_equal(back.column_ids, cols)


# -- the data both packages are given ----------------------------------------------

NUM_SLICES = 3
ROWS = 6


# Unix times the seeded bits carry (0: none): April 2017 across days and
# hours, and two before 1970.
TIMES = [0, 1_491_005_000, 1_491_022_000, 1_491_090_000, 1_492_000_000,
         1_493_590_000, -3_600, -86_400 * 40]


def seeded_bits(seed: int, n: int = 3000, slices: int = NUM_SLICES):
    """(rows, cols, unix times or 0) drawn from the seed; about a third of
    the bits have no time."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, ROWS, n)
    cols = rng.integers(0, slices * SLICE_WIDTH, n)
    ts = np.asarray(TIMES)[rng.integers(0, len(TIMES), n)]
    ts[rng.random(n) < 0.2] = 0
    return rows, cols, ts


def as_datetimes(ts):
    """The JAX handler's conversion of ImportRequest.timestamps."""
    return [datetime.fromtimestamp(int(t), timezone.utc).replace(tzinfo=None)
            if t else None for t in ts]


def storage_image(holder) -> dict:
    """{(index, frame, view, slice): (bits, snapshot file bytes)}."""
    out = {}
    for iname, idx in sorted(holder.indexes.items()):
        for fname, f in sorted(idx.frames.items()):
            for vname, v in sorted(f.views.items()):
                for s, frag in sorted(v.fragments.items()):
                    with open(frag.path, "rb") as fh:
                        disk = fh.read()
                    out[(iname, fname, vname, s)] = (
                        list(frag.for_each_bit()), disk)
    return out


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("quantum", ["", "YMD", "YMDH"])
@pytest.mark.parametrize("seed", [3, 4])
def test_frame_import_bits_matches_jax(tmp_path, inverse, quantum, seed):
    """The same bits, views, snapshot bytes on disk, rank caches and block
    digests, over every view and slice."""
    rows, cols, ts = seeded_bits(seed)
    got = {}
    for pkg, H in (("jax", JaxHolder), ("port", Holder)):
        h = H(str(tmp_path / pkg))
        h.open()
        try:
            f = h.create_index("i").create_frame(
                "f", inverse_enabled=inverse, time_quantum=quantum)
            f.import_bits(rows[:1000], cols[:1000])
            f.import_bits(rows, cols, as_datetimes(ts))
            frags = [fr for v in f.views.values()
                     for fr in v.fragments.values()]
            got[pkg] = (storage_image(h),
                        {(fr.view, fr.slice): fr.cache.top() for fr in frags},
                        {(fr.view, fr.slice): list(fr.blocks())
                         for fr in frags},
                        sorted(f.views), h.max_slices(),
                        h.max_inverse_slices())
        finally:
            h.close()
    assert got["port"] == got["jax"]


def test_frame_import_takes_datetime64(tmp_path):
    """The handler's form (datetime64, NaT for none) imports what the
    list of datetimes imports."""
    rows, cols, ts = seeded_bits(5)
    images = []
    for k, stamps in enumerate((as_datetimes(ts), np.where(
            ts == 0, np.datetime64("NaT"),
            ts.astype("datetime64[s]")))):
        h = Holder(str(tmp_path / str(k)))
        h.open()
        try:
            h.create_index("i").create_frame(
                "f", time_quantum="YMDH").import_bits(rows, cols, stamps)
            images.append(storage_image(h))
        finally:
            h.close()
    assert images[0] == images[1]


# -- both handlers, the same requests ----------------------------------------------


def make_handler(pkg: str, h, threshold=0.05, client_factory=None):
    if pkg == "jax":
        return JaxHandler(h, JaxExecutor(h, use_device=False),
                          client_factory=client_factory)
    return Handler(h, Executor(h, device="cpu",
                               sparse_density_threshold=threshold),
                   client_factory=client_factory)


SETUP = [("POST", "/index/i", b""),
         ("POST", "/index/i/frame/f",
          b'{"options": {"inverseEnabled": true, "timeQuantum": "YMDH"}}'),
         ("POST", "/index/i/frame/g", b""),
         ("POST", "/index/j", b'{"options": {"timeQuantum": "YM"}}'),
         ("POST", "/index/j/frame/e", b"")]


def import_body(index, frame, slice_, rows, cols, ts=None) -> bytes:
    req = pb.ImportRequest(index=index, frame=frame, slice=slice_)
    req.row_ids.extend(int(r) for r in rows)
    req.column_ids.extend(int(c) for c in cols)
    if ts is not None:
        req.timestamps.extend(int(t) for t in ts)
    return req.SerializeToString()


def seed_requests(seed: int = 6):
    """One import a slice into f (with times) and g (without), and a
    timestamped one into j/e; the first asks for a protobuf answer."""
    rows, cols, ts = seeded_bits(seed)
    out = []
    for s in range(NUM_SLICES):
        m = cols // SLICE_WIDTH == s
        out.append(import_body("i", "f", s, rows[m], cols[m], ts[m]))
        out.append(import_body("i", "g", s, rows[m], cols[m]))
    out.append(import_body("j", "e", 0, rows[:500], cols[:500] % SLICE_WIDTH,
                           ts[:500]))
    return out


@pytest.fixture(params=[0.0, 0.05], ids=["threshold0", "threshold0.05"])
def pair(request, tmp_path):
    """{package: (holder, handler)} after SETUP and the seeded imports."""
    out = {}
    for pkg, H in (("jax", JaxHolder), ("port", Holder)):
        h = H(str(tmp_path / pkg))
        h.open()
        handler = make_handler(pkg, h, request.param)
        for method, path, body in SETUP:
            assert handler.handle(method, path, {}, {}, body).status == 200
        for k, body in enumerate(seed_requests()):
            headers = {"Content-Type": PROTOBUF_CT}
            if k == 0:
                headers["Accept"] = PROTOBUF_CT
            r = handler.handle("POST", "/import", {}, headers, body)
            assert r.status == 200, r.body
            if k == 0:
                assert r.headers["Content-Type"] == PROTOBUF_CT
                assert r.body == b""  # an empty ImportResponse
            else:
                assert r.json() == {}
        out[pkg] = (h, handler)
    yield out
    for h, _ in out.values():
        h.close()


def call(pair, method, path, params=None, headers=None, body=b""):
    return {pkg: hd.handle(method, path, dict(params or {}),
                           dict(headers or {}), body)
            for pkg, (_, hd) in pair.items()}


def same(pair, *args, decode=None, **kwargs):
    """Both handlers' status, content type and body are equal (bodies
    compared parsed by `decode`, JSON by default); returns the port's."""
    r = call(pair, *args, **kwargs)
    j, t = r["jax"], r["port"]
    assert t.status == j.status, (args, t.body, j.body)
    assert t.headers.get("Content-Type") == j.headers.get("Content-Type")
    if decode is None and "json" in t.headers.get("Content-Type", ""):
        decode = json.loads
    if decode is not None:
        assert decode(t.body) == decode(j.body), args
    else:
        assert t.body == j.body, args
    return t


def all_fragments(h):
    return [(i, f, v, s) for (i, f, v, s) in storage_image(h)]


def test_import_leaves_the_same_storage(pair):
    assert storage_image(pair["port"][0]) == storage_image(pair["jax"][0])
    assert {v for (_, f, v, _) in all_fragments(pair["port"][0])
            if f == "f"} >= {"standard", "inverse", "standard_2017",
                             "inverse_2017"}


def test_read_only_routes(pair):
    for path in ("/index", "/index/i", "/index/j", "/version", "/schema",
                 "/index/i/frame/f/views", "/index/j/frame/e/views"):
        same(pair, "GET", path)
    for params in ({}, {"inverse": "true"}):
        assert same(pair, "GET", "/slices/max", params).json() == {
            "maxSlices": pair["port"][0].max_slices()
            if not params else pair["port"][0].max_inverse_slices()}
        same(pair, "GET", "/slices/max", params,
             headers={"Accept": PROTOBUF_CT},
             decode=lambda b: wire.MaxSlicesResponse.decode(b).max_slices)
    r = call(pair, "GET", "/")
    assert {k: (v.status, v.headers["Content-Type"]) for k, v in r.items()} \
        == {"jax": (200, "text/html"), "port": (200, "text/html")}


def test_export_blocks_and_block_data(pair):
    for i, f, v, s in all_fragments(pair["port"][0]):
        q = {"index": i, "frame": f, "view": v, "slice": str(s)}
        csv = same(pair, "GET", "/export", q)
        assert csv.headers["Content-Type"] == "text/csv"
        blocks = same(pair, "GET", "/fragment/blocks", q).json()["blocks"]
        assert blocks
        for b in blocks:
            bq = dict(q, block=str(b["id"]))
            same(pair, "GET", "/fragment/block/data", bq)
            same(pair, "GET", "/fragment/block/data", bq,
                 headers={"Accept": PROTOBUF_CT})
            req = pb.BlockDataRequest(index=i, frame=f, view=v, slice=s,
                                      block=b["id"])
            same(pair, "GET", "/fragment/block/data",
                 headers={"Accept": PROTOBUF_CT,
                          "Content-Type": PROTOBUF_CT},
                 body=req.SerializeToString())


def tar_members(raw: bytes) -> dict:
    with tarfile.open(fileobj=io.BytesIO(raw), mode="r|") as tar:
        return {m.name: tar.extractfile(m).read() for m in tar}


def test_fragment_data_round_trip(pair):
    """GET /fragment/data gives the same members (the data bytes with
    their footer, the cache's JSON); each package restores the other's
    tar into a new frame and serves the same bits and TopN."""
    for i, f, v, s in all_fragments(pair["port"][0]):
        q = {"index": i, "frame": f, "view": v, "slice": str(s)}
        r = call(pair, "GET", "/fragment/data", q)
        assert {k: x.status for k, x in r.items()} == {"jax": 200,
                                                       "port": 200}
        mj, mt = tar_members(r["jax"].body), tar_members(r["port"].body)
        assert list(mt) == list(mj) == ["data", "cache"]
        assert mt == mj
        if (i, v) != ("i", "standard"):
            continue
        # Crossed: each package restores the other's tar.
        for pkg, other in (("jax", "port"), ("port", "jax")):
            hd = pair[pkg][1]
            hd.handle("POST", f"/index/i/frame/r{f}", {}, {}, b"")
            got = hd.handle("POST", "/fragment/data",
                            dict(q, frame=f"r{f}"), {}, r[other].body)
            assert got.status == 200, got.body
    for f in ("f", "g"):
        for s in range(NUM_SLICES):
            q = {"index": "i", "frame": f"r{f}", "view": "standard",
                 "slice": str(s)}
            same(pair, "GET", "/export", q)
            same(pair, "GET", "/fragment/data", q,
                 decode=lambda b: tar_members(b))
        same(pair, "POST", "/index/i/query",
             body=f"TopN(frame=r{f}, n=4)".encode())


def test_queries_after_import(pair):
    qs = ["Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, "
          "frame=f)))", "Count(Union(Bitmap(rowID=0, frame=g), "
          "Bitmap(rowID=5, frame=g)))", "TopN(frame=f, n=3)",
          "TopN(frame=g)",
          'Count(Range(rowID=2, frame=f, start="2017-04-03T00:00", '
          'end="2017-04-17T05:00"))',
          'Count(Range(rowID=4, frame=f, start="1969-01-01T00:00", '
          'end="1970-01-01T00:00"))', "Bitmap(columnID=7, frame=f)"]
    for q in qs:
        same(pair, "POST", "/index/i/query", body=q.encode())
    same(pair, "POST", "/index/j/query",
         body=b'Count(Range(rowID=1, frame=e, start="2017-04-01T00:00", '
              b'end="2017-05-01T00:00"))')


ERRORS = [
    ("POST", "/import", {}, import_body("nope", "f", 0, [1], [1])),
    ("POST", "/import", {}, import_body("i", "nope", 0, [1], [1])),
    ("POST", "/import", {}, b"\x0a\x05ab"),  # malformed: 500 in both
    ("GET", "/export", {"index": "i", "frame": "f"}, b""),  # no slice: 400
    ("GET", "/export", {"index": "i", "frame": "f", "slice": "x"}, b""),
    ("GET", "/export", {"index": "i", "frame": "f", "slice": "9"}, b""),
    ("GET", "/export", {"index": "nope", "frame": "f", "slice": "0"}, b""),
    ("GET", "/fragment/data", {"index": "i", "frame": "f", "slice": "9"},
     b""),
    ("POST", "/fragment/data", {"index": "i", "frame": "nope",
                                "slice": "0"}, b""),
    ("GET", "/fragment/blocks", {"index": "i", "frame": "g",
                                 "view": "inverse", "slice": "0"}, b""),
    ("GET", "/fragment/block/data", {"index": "i", "frame": "f",
                                     "slice": "9", "block": "0"}, b""),
    ("GET", "/fragment/block/data", {}, b"\x22\x02\x01"),
    ("GET", "/fragment/block/data", {"index": "i", "frame": "f",
                                     "slice": "0"}, b""),  # no block
    ("POST", "/index/i/frame/f/restore", {}, b""),  # no host: 400
    ("POST", "/index/i/frame/f/restore", {"host": "h:1"}, b""),  # 501
    ("GET", "/index/nope", {}, b""),
    ("GET", "/nothing", {}, b""),
    ("DELETE", "/export", {}, b""),
]


@pytest.fixture
def light(tmp_path):
    """{package: (holder, handler)} after SETUP and one small import a
    frame."""
    out = {}
    for pkg, H in (("jax", JaxHolder), ("port", Holder)):
        h = H(str(tmp_path / pkg))
        h.open()
        handler = make_handler(pkg, h)
        for method, path, body in SETUP:
            assert handler.handle(method, path, {}, {}, body).status == 200
        for f in ("f", "g"):
            r = handler.handle("POST", "/import", {}, {}, import_body(
                "i", f, 0, [1, 2, 3], [7, 9, SLICE_WIDTH - 1]))
            assert r.status == 200
        out[pkg] = (h, handler)
    yield out
    for h, _ in out.values():
        h.close()


@pytest.mark.parametrize("method,path,params,body", ERRORS)
def test_error_statuses(light, method, path, params, body):
    r = call(light, method, path, params, {}, body)
    assert r["port"].status == r["jax"].status
    assert r["port"].status >= 400
    if r["port"].status != 500:  # a 500 carries the exception's own text
        assert r["port"].json() == r["jax"].json()


def test_restore_of_a_missing_frame_is_404(tmp_path):
    got = {}
    for pkg, H in (("jax", JaxHolder), ("port", Holder)):
        h = H(str(tmp_path / pkg))
        h.open()
        try:
            hd = make_handler(pkg, h, client_factory=lambda host: None)
            hd.handle("POST", "/index/i", {}, {}, b"")
            r = hd.handle("POST", "/index/i/frame/nope/restore",
                          {"host": "h:1"}, {}, b"")
            got[pkg] = (r.status, r.json())
        finally:
            h.close()
    assert got["port"] == got["jax"] == (404, {"error": "frame not found"})


# -- a tar whose data does not match its footer -------------------------------


def flip_in_data(tar_raw: bytes, at_from_end: int) -> bytes:
    members = tar_members(tar_raw)
    data = bytearray(members["data"])
    # The first container's payload starts after the header, the key
    # headers and the offsets (8 + 16 bytes a container).
    n = int.from_bytes(data[4:8], "little")
    data[8 + 16 * n + at_from_end] ^= 0x10
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        for name_, raw in (("data", bytes(data)), ("cache",
                                                   members["cache"])):
            info = tarfile.TarInfo(name_)
            info.size = len(raw)
            tar.addfile(info, io.BytesIO(raw))
    return buf.getvalue()


@pytest.mark.parametrize("at", [0, 3, 40])
def test_tar_with_a_flipped_data_byte(tmp_path, at):
    """Neither package verifies the data member's footer on restore: both
    accept the flipped bit, serve the same bits, and write a snapshot
    whose new footer verifies when the holder opens again."""
    rows, cols, _ = seeded_bits(8, slices=1)
    src = JaxHolder(str(tmp_path / "src"))
    src.open()
    try:
        src.create_index("i").create_frame("f").import_bits(rows, cols)
        buf = io.BytesIO()
        src.fragment("i", "f", "standard", 0).write_to_tar(buf)
    finally:
        src.close()
    bad = flip_in_data(buf.getvalue(), at)
    got = {}
    for pkg, H in (("jax", JaxHolder), ("port", Holder)):
        path = str(tmp_path / pkg)
        h = H(path)
        h.open()
        try:
            hd = make_handler(pkg, h)
            hd.handle("POST", "/index/i", {}, {}, b"")
            hd.handle("POST", "/index/i/frame/f", {}, {}, b"")
            r = hd.handle("POST", "/fragment/data",
                          {"index": "i", "frame": "f", "slice": "0"}, {},
                          bad)
            first = (r.status, storage_image(h))
        finally:
            h.close()
        h = H(path)
        h.open()
        try:
            frag = h.fragment("i", "f", "standard", 0)
            got[pkg] = (first, frag.count(), list(frag.for_each_bit()))
        finally:
            h.close()
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == 200
    assert set(got["port"][2]) != set(zip(rows.tolist(), cols.tolist()))


# -- servers on 127.0.0.1 ------------------------------------------------------------


class Node:
    """A server of one package over its own holder, on a free port."""

    def __init__(self, pkg: str, path: str, threshold=0.05):
        H = JaxHolder if pkg == "jax" else Holder
        self.pkg = pkg
        self.holder = H(path)
        self.holder.open()
        factory = JaxClient if pkg == "jax" else InternalClient
        self.handler = make_handler(pkg, self.holder, threshold, factory)
        cls = JaxAPIServer if pkg == "jax" else APIServer
        self.srv = cls(self.handler)
        self.srv.start()
        self.host = "%s:%d" % self.srv.address

    def req(self, method, path, body=b"", params=None):
        return self.handler.handle(method, path, params or {}, {}, body)

    def close(self):
        self.srv.close()
        self.holder.close()


def test_frame_restore_between_two_servers(tmp_path):
    """A frame with inverse and time views pulled from another node: the
    port's two servers end with what the JAX package's two end with."""
    got = {}
    for pkg in ("jax", "port"):
        src = Node(pkg, str(tmp_path / pkg / "src"))
        dst = Node(pkg, str(tmp_path / pkg / "dst"))
        try:
            for node in (src, dst):
                node.req("POST", "/index/i")
                node.req("POST", "/index/i/frame/f",
                         b'{"options": {"inverseEnabled": true, '
                         b'"timeQuantum": "YM"}}')
            for body in seed_requests(9)[:-1:2]:  # frame f's
                assert src.req("POST", "/import", body).status == 200
            r = dst.req("POST", "/index/i/frame/f/restore",
                        params={"host": src.host})
            assert r.status == 200, r.body
            image = storage_image(dst.holder)
            views = dst.req("GET", "/index/i/frame/f/views").json()
            top = dst.req("POST", "/index/i/query",
                          b"TopN(frame=f, n=3)").json()
            got[pkg] = ({k: v[0] for k, v in image.items()}, views, top)
            assert image == storage_image(src.holder)  # files too
        finally:
            src.close()
            dst.close()
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) > 4


@pytest.fixture
def east_of_utc(monkeypatch):
    """A local zone 5:30 east of UTC, so a CSV's local times move across
    the day boundary on the way to UTC."""
    monkeypatch.setenv("TZ", "XST-5:30")
    time.tzset()
    yield
    monkeypatch.undo()
    time.tzset()


CSV_TIMES = ["2017-04-01T00:10", "2017-04-01T03:00", "2017-04-01T06:00",
             "2017-04-30T23:50", "2017-05-01T02:00", ""]


def write_csv(path, seed: int, n: int = 2000) -> list:
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        r = int(rng.integers(0, 4))
        c = int(rng.integers(0, NUM_SLICES * SLICE_WIDTH))
        t = CSV_TIMES[int(rng.integers(0, len(CSV_TIMES)))]
        lines.append(f"{r},{c},{t}" if t else f"{r},{c}")
    path.write_text("\n".join(lines) + "\n")
    return lines


def test_parse_import_rows_matches_jax(east_of_utc):
    lines = ["1,2", "3,4,2017-04-01T12:30", "", " 5 , 6 ",
             "7,8,2017-04-01T00:10"]
    assert port_ctl.parse_import_rows(lines) == \
        jax_ctl.parse_import_rows(lines)
    with pytest.raises(ValueError, match="bad row"):
        port_ctl.parse_import_rows(["justone"])


RANGES = [("2017-04-01T00:00", "2017-04-02T00:00"),
          ("2017-03-31T00:00", "2017-04-01T00:00"),
          ("2017-04-01T00:00", "2017-05-01T00:00"),
          ("2017-04-30T00:00", "2017-05-02T00:00")]


def range_truth(lines, r, start, end) -> int:
    """Distinct columns of row r whose time, read as local time and
    stored as UTC (the ctl's and the handler's conversions), lies in
    [start, end) at day granularity."""
    lo, hi = (datetime.strptime(x, "%Y-%m-%dT%H:%M") for x in (start, end))
    cols = set()
    for line in lines:
        parts = line.split(",")
        if int(parts[0]) != r or len(parts) < 3:
            continue
        unix = int(datetime.strptime(parts[2], "%Y-%m-%dT%H:%M").timestamp())
        t = datetime.fromtimestamp(unix, timezone.utc).replace(tzinfo=None)
        day = t.replace(hour=0, minute=0)
        if lo <= day < hi:
            cols.add(int(parts[1]))
    return len(cols)


def queries_of(frame: str):
    qs = [f"Count(Intersect(Bitmap(rowID=1, frame={frame}), "
          f"Bitmap(rowID=2, frame={frame})))", f"TopN(frame={frame}, n=3)"]
    qs += [f'Count(Range(rowID={r}, frame={frame}, start="{a}", end="{b}"))'
           for a, b in RANGES for r in (0, 3)]
    return qs


def answers(pkg, holder, queries, threshold):
    if pkg == "jax":
        ex = JaxExecutor(holder, use_device=False)
        return [ex.execute("t", jax_parse(q))[0] for q in queries]
    ex = Executor(holder, device="cpu", sparse_density_threshold=threshold)
    return [ex.execute("t", parse_string(q))[0] for q in queries]


@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_ctl_round_trips_match_jax(tmp_path, east_of_utc, threshold):
    """Each package's ctl against its own server, on the same CSV: the
    import (with --create and a small --buffer-size), export, backup and
    restore give the same CSV, the same fragment data, and Counts, TopN
    and time Ranges equal to the JAX executor's after the import and
    after the restore (and the Ranges equal to the CSV's truth)."""
    csv = tmp_path / "in.csv"
    lines = write_csv(csv, seed=10)
    got = {}
    for pkg, ctl in (("jax", jax_ctl), ("port", port_ctl)):
        node = Node(pkg, str(tmp_path / pkg / "data"), threshold)
        try:
            node.req("POST", "/index/t", b'{"options": {"timeQuantum": '
                                         b'"YMD"}}')
            h = ["--host", node.host]
            assert ctl.main(["import", *h, "-i", "t", "-f", "ev", "--create",
                             "--buffer-size", "700", str(csv)]) == 0
            out = tmp_path / pkg / "out.csv"
            assert ctl.main(["export", *h, "-i", "t", "-f", "ev", "-o",
                             str(out)]) == 0
            tar = tmp_path / pkg / "ev.tar"
            assert ctl.main(["backup", *h, "-i", "t", "-f", "ev", "-o",
                             str(tar)]) == 0
            with tarfile.open(tar) as tf:
                backup = {m.name: tar_members(tf.extractfile(m).read())
                          for m in tf.getmembers()}
            after_import = answers(pkg, node.holder, queries_of("ev"),
                                   threshold)
            node.req("POST", "/index/t/frame/rs")
            assert ctl.main(["restore", *h, "-i", "t", "-f", "rs",
                             str(tar)]) == 0
            out2 = tmp_path / pkg / "out2.csv"
            assert ctl.main(["export", *h, "-i", "t", "-f", "rs", "-o",
                             str(out2)]) == 0
            after_restore = answers(pkg, node.holder, queries_of("rs")[:2],
                                    threshold)
            got[pkg] = (out.read_text(), backup, after_import,
                        out2.read_text(), after_restore,
                        sorted(node.holder.frame("t", "ev").views))
        finally:
            node.close()
    assert got["port"] == got["jax"]
    text, _, after_import, text2, after_restore, views = got["port"]
    assert text == text2
    assert set(text.split()) == {",".join(x.split(",")[:2]) for x in lines}
    assert "standard_20170331" in views  # local midnight is UTC's evening
    for k, (a, b) in enumerate(RANGES):
        for j, r in enumerate((0, 3)):
            assert after_import[2 + 2 * k + j] == range_truth(lines, r, a, b)
    assert after_restore == after_import[:2]


def test_ctl_export_of_an_absent_index_is_empty(tmp_path, capsys):
    node = Node("port", str(tmp_path / "d"))
    try:
        out = tmp_path / "o.csv"
        assert port_ctl.main(["export", "--host", node.host, "-i", "nope",
                              "-f", "f", "-o", str(out)]) == 0
        assert out.read_text() == ""
    finally:
        node.close()


# -- an import into a staged view ----------------------------------------------


@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_import_into_a_staged_view_restages(tmp_path, threshold):
    """An import resets the fragment's mutation log: the next Count
    restages the view (no scatter) and equals the JAX executor's after
    the same imports."""
    rows, cols, _ = seeded_bits(11, n=20000)
    more_rows, more_cols, _ = seeded_bits(12, n=5000)
    qs = ["Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, "
          "frame=f)))", "TopN(frame=f, n=4)"]
    got = {}
    for pkg, H in (("jax", JaxHolder), ("port", Holder)):
        h = H(str(tmp_path / pkg))
        h.open()
        try:
            f = h.create_index("t").create_frame("f")
            f.import_bits(rows, cols)
            ex = (JaxExecutor(h, use_device=False) if pkg == "jax" else
                  Executor(h, device="cpu",
                           sparse_density_threshold=threshold))
            parse = jax_parse if pkg == "jax" else parse_string
            first = [ex.execute("t", parse(q))[0] for q in qs]
            if pkg == "port":
                stats = ex.mesh_manager().stats
                stage = stats["stage"]
            f.import_bits(more_rows, more_cols)
            second = [ex.execute("t", parse(q))[0] for q in qs]
            if pkg == "port":
                assert stats["stage"] == stage + 1
                assert stats.get("incremental", 0) == 0
                assert ex.stats.get("count_host", 0) == 0
            got[pkg] = (first, second)
        finally:
            h.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] != got["port"][1]
