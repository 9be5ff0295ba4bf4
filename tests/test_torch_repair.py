"""Read-repair of the port against the JAX package's: a fragment whose
file fails verification is restored from a replica's verified tar
(Fragment._recover_corrupt through the IntegrityContext's source), in
both packages alike, bit for bit and epoch for epoch:

- from a verified donor: the rotted file moves aside as `.corrupt`, the
  copy is written with its footer, the epoch is restored and bumped, the
  sidecar rewritten, `repaired` counted, and a staged image restages
  (the mutation log resets);
- a side log the crash left is replayed onto the copy; one that is
  itself rotted is moved aside as `.wal.corrupt`;
- a rotted donor tar is refused, and no donor at all leaves the file in
  place and raises CorruptFragmentError on every touch;
- eight threads touching the fragment at once all read the repaired
  image, with one fetch from the source;
- the server's source (Server._repair_source) hands over a replica's tar
  only when its block checksums equal what that replica reports, and
  the holder's context reaches fragments opened before it was set.
"""

import io
import logging
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pilosa_tpu.core.fragment import INTEGRITY_STATS as JAX_INTEGRITY
from pilosa_tpu.core.fragment import Fragment as JaxFragment
from pilosa_tpu.core.fragment import IntegrityContext as JaxContext
from pilosa_tpu.errors import CorruptFragmentError as JaxCorrupt
from pilosa_tpu.parallel import Node as JaxNode
from pilosa_tpu.server import Server as JaxServer

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.fragment import (INTEGRITY_STATS, Fragment,
                                            IntegrityContext)
from pilosa_tpu_torch.errors import CorruptFragmentError
from pilosa_tpu_torch.parallel.cluster import Cluster, Node
from pilosa_tpu_torch.roaring.serialize import write_op
from pilosa_tpu_torch.server import Server
from torch_threads import one_torch_thread  # noqa: F401

PKG = {"jax": (JaxFragment, JaxContext, JaxCorrupt, JAX_INTEGRITY),
       "port": (Fragment, IntegrityContext, CorruptFragmentError,
                INTEGRITY_STATS)}


def _bits(seed, n=300):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 6, n)
    cols = rng.integers(0, SLICE_WIDTH, n)
    return list(zip(rows.tolist(), cols.tolist()))


def _frag(pkg, path, source=None):
    cls, ctx, _, _ = PKG[pkg]
    f = cls(str(path), "i", "f", "standard", 0,
            integrity=ctx(source) if source is not None else ctx())
    return f


def _donor_tar(pkg, path, bits):
    f = _frag(pkg, path)
    f.open()
    for r, c in bits:
        f.set_bit(r, c)
    buf = io.BytesIO()
    f.write_to_tar(buf)
    want = f.storage.slice().tolist()
    f.close()
    return buf.getvalue(), want


def _rotted(pkg, path, bits, ops_after=0):
    """A fragment file written, snapshotted (a footer over the whole
    region), then `ops_after` more ops logged, closed, and one byte of
    its region flipped. Returns the epoch it closed at."""
    f = _frag(pkg, path)
    f.open()
    for r, c in bits:
        f.set_bit(r, c)
    f.snapshot()
    assert f.wait_snapshot(30)
    for k in range(ops_after):
        f.set_bit(7, k)
    epoch = f.epoch
    f.close()
    with open(path, "r+b") as fh:
        fh.seek(40)
        b = fh.read(1)
        fh.seek(40)
        fh.write(bytes([b[0] ^ 0x20]))
    return epoch


def _side_log(path, ops):
    buf = io.BytesIO()
    for typ, pos in ops:
        write_op(buf, typ, pos)
    with open(str(path) + ".wal", "wb") as fh:
        fh.write(buf.getvalue())


def _state(f):
    return {"bits": f.storage.slice().tolist(), "epoch": f.epoch,
            "sidecar": open(f.path + ".epoch", "rb").read(),
            "corrupt": os.path.exists(f.path + ".corrupt"),
            "wal_corrupt": os.path.exists(f.path + ".wal.corrupt"),
            "wal": os.path.exists(f.path + ".wal")}


@pytest.mark.parametrize("side", ["none", "sound", "rotted"])
@pytest.mark.parametrize("seed", range(3))
def test_repair_from_a_verified_donor_equals_the_jax_package(tmp_path, seed,
                                                             side):
    out = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        tar, donor = _donor_tar(pkg, d / "donor", _bits(seed))
        _rotted(pkg, d / "0", _bits(seed + 100), ops_after=3)
        side_ops = [(0, 2 * SLICE_WIDTH + 5), (0, 9), (1, 9)]
        if side != "none":
            _side_log(d / "0", side_ops)
        if side == "rotted":
            with open(str(d / "0") + ".wal", "r+b") as fh:
                fh.seek(3)
                fh.write(b"\xff")
        repaired0 = PKG[pkg][3].get("repaired", 0)
        f = _frag(pkg, d / "0", lambda frag, t=tar: t)
        f.open(lazy=True)
        try:
            gen0 = getattr(f, "generation", 0)
            f.row(0)  # the touch that repairs
            st = _state(f)
            assert PKG[pkg][3].get("repaired", 0) == repaired0 + 1
            assert f.generation > gen0
        finally:
            f.close()
        want = set(donor)
        if side == "sound":
            want |= {2 * SLICE_WIDTH + 5}
        assert set(st["bits"]) == want
        assert st["corrupt"] and not st["wal"]
        assert st["wal_corrupt"] == (side == "rotted")
        # A reopen reads the repaired file, verified, at the same epoch.
        g = _frag(pkg, d / "0")
        g.open()
        try:
            assert g.storage.slice().tolist() == st["bits"]
            assert g.epoch == st["epoch"]
        finally:
            g.close()
        out[pkg] = st
    assert out["jax"] == out["port"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("donor", ["none", "empty", "rotted", "raises"])
def test_no_verified_donor_raises_on_every_touch(tmp_path, pkg, donor):
    tar, _ = _donor_tar(pkg, tmp_path / "donor", _bits(1))
    size = None
    _rotted(pkg, tmp_path / "0", _bits(2))
    size = os.path.getsize(tmp_path / "0")
    calls = []

    def source(frag):
        calls.append(1)
        if donor == "raises":
            raise ConnectionError("replica down")
        if donor == "empty":
            return b""
        if donor == "rotted":
            bad = bytearray(tar)
            bad[700] ^= 0x04  # inside the data member's region
            return bytes(bad)
        return None

    _, _, err, stats = PKG[pkg]
    unrep0 = stats.get("unrepaired", 0)
    f = _frag(pkg, tmp_path / "0", source)
    f.open(lazy=True)
    try:
        for _ in range(3):
            with pytest.raises(err):
                f.row(0)
        assert len(calls) == 3  # each touch tries again
        assert stats.get("unrepaired", 0) == unrep0 + 3
    finally:
        f.close()
    assert os.path.getsize(tmp_path / "0") == size
    assert not os.path.exists(str(tmp_path / "0") + ".corrupt")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_concurrent_touchers_all_read_the_repaired_image(tmp_path, pkg):
    tar, donor = _donor_tar(pkg, tmp_path / "donor", _bits(5, 2000))
    _rotted(pkg, tmp_path / "0", _bits(6))
    calls = []

    def slow_source(frag):
        calls.append(threading.get_ident())
        time.sleep(0.3)  # the fetch holds the fragment's lock
        return tar

    f = _frag(pkg, tmp_path / "0", slow_source)
    f.open(lazy=True)
    want = {r: sum(1 for p in donor if p // SLICE_WIDTH == r)
            for r in range(6)}
    got, errors = [], []

    def toucher(k):
        try:
            got.append(f.row(k % 6).count() == want[k % 6])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    ts = [threading.Thread(target=toucher, args=(k,)) for k in range(8)]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        f.close()
    assert not errors and got == [True] * 8
    assert len(calls) == 1


class _Replica:
    """A replica as the server's source reaches it: the fragment's tar
    and the block checksums it reports (honest or not)."""

    def __init__(self, tar, blocks):
        self.tar, self.blocks = tar, blocks

    def fragment_data(self, index, frame, view, slice_):
        return self.tar

    def fragment_blocks(self, index, frame, view, slice_):
        return list(self.blocks.items())


@pytest.mark.parametrize("honest", [True, False])
def test_server_source_checks_the_donor_against_its_blocks(tmp_path,
                                                           honest):
    from pilosa_tpu_torch.core.fragment import (bitmap_block_checksums,
                                                bitmap_from_tar)

    tar, _ = _donor_tar("port", tmp_path / "donor", _bits(3))
    blocks = bitmap_block_checksums(bitmap_from_tar(tar))
    if not honest:
        blocks = {k: b"\0" * 20 for k in blocks}
    replica = _Replica(tar, blocks)
    hosts = ["a:1", "b:1", "c:1"]
    got = []
    for node_cls, srv_cls in ((JaxNode, JaxServer), (Node, Server)):
        from pilosa_tpu.parallel.cluster import Cluster as JaxCluster

        cl_cls = JaxCluster if node_cls is JaxNode else Cluster
        ns = SimpleNamespace(
            cluster=cl_cls(nodes=[node_cls(h) for h in hosts],
                           replica_n=3),
            host="a:1", logger=logging.getLogger("test"),
            client=SimpleNamespace(for_host=lambda h: replica))
        frag = SimpleNamespace(index="i", frame="f", view="standard",
                               slice=0)
        got.append(srv_cls._repair_source(ns, frag))
    assert got[0] == got[1] == (tar if honest else None)


def test_the_holder_context_reaches_fragments_opened_before(tmp_path):
    h = Holder(str(tmp_path / "d"))
    h.open()
    f = h.create_index("i").create_frame("f")
    for r, c in _bits(8, 50):
        f.set_bit(r, c)
    frag = h.fragment("i", "f", "standard", 0)
    frag.snapshot()
    buf = io.BytesIO()
    frag.write_to_tar(buf)
    want = frag.storage.slice().tolist()
    h.close()
    with open(tmp_path / "d/i/f/standard/fragments/0", "r+b") as fh:
        fh.seek(30)
        b = fh.read(1)
        fh.seek(30)
        fh.write(bytes([b[0] ^ 1]))
    h = Holder(str(tmp_path / "d"))
    h.open()
    try:
        frag = h.fragment("i", "f", "standard", 0)
        with pytest.raises(CorruptFragmentError):
            frag.row(0)
        h.integrity.repair_source = lambda fr: buf.getvalue()
        assert frag.storage.slice().tolist() == want
        assert h.fragment_epochs()["i/f/standard/0"] == frag.epoch
    finally:
        h.close()
