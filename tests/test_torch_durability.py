"""The port's durability against the JAX package's: the torn-tail repair,
background snapshots with a side WAL, write backpressure, the bulk
import's barrier, the integrity footer's bytes, and power-loss torture.

Each case runs the same seeded op stream through the port's Fragment
(pilosa_tpu_torch/core/fragment.py) and the JAX package's, with the
same fault armed in each package's own fault module, and both files
must reopen to the same bits. Exact: bits, counts and bytes.

The power-loss torture runs a child process per fsync policy and kill
point: this module run as a script for the port (`child_main`), and
tests/ingest_child.py for the JAX package, with the same arguments.
Four writers print each bit once its commit barrier returned (the ack a
client would see); a fault rule SIGKILLs the process before a commit
fsync, before a snapshot's temp fsync or before its rename. Under group
and always every acked bit survives the reopen, in both packages; under
never (with the power-loss simulation, records buffered until a
snapshot flip) the file reopens and nothing is invented: each writer
keeps a prefix of its writes, at most one past its last ack. With one
writer the commit-fsync kill is deterministic: both packages keep
exactly the bits acked before it.
"""

import io
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CHILD = os.path.abspath(__file__)
JAX_CHILD = os.path.join(REPO, "tests", "ingest_child.py")
WRITERS, PER_WRITER = 4, 400


def child_main(argv):
    """The torture child: <pkg port|jax> <dir> <policy> <kill point>
    <kill after> [writers]. Prints "READY", then "A <row> <col>" for
    each acked bit, then "DONE" after a clean close."""
    pkg, data_dir, policy, kill_point, kill_after = argv[:5]
    writers = int(argv[5]) if len(argv) > 5 else WRITERS
    sys.path.insert(0, REPO)
    if pkg == "port":
        from pilosa_tpu_torch import fault
        from pilosa_tpu_torch.core.fragment import Fragment
        from pilosa_tpu_torch.core.wal import WalConfig
        kill = fault.ProcessKill
    else:
        os.environ["JAX_PLATFORMS"] = "cpu"
        from pilosa_tpu import fault
        from pilosa_tpu.core.fragment import Fragment
        from pilosa_tpu.core.wal import WalConfig

        class kill(Exception):  # noqa: N801 — the JAX child's _Kill
            def __init__(self, *args):
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
    seam = {"commit-fsync": ("storage.fsync", {"kind": "commit"}),
            "snapshot-fsync": ("storage.fsync", {"kind": "snapshot"}),
            "rename": ("storage.rename", {})}.get(kill_point)
    if seam is not None:
        fault.arm(seam[0], error=kill, after=int(kill_after), **seam[1])
    frag = Fragment(os.path.join(data_dir, "frag"), "i", "f", "standard", 0,
                    wal=WalConfig(fsync_policy=policy, group_window_us=500.0,
                                  max_op_n=32))
    frag.open()
    print("READY", flush=True)
    out_mu = threading.Lock()

    def writer(row):
        for i in range(PER_WRITER):
            col = row * 10000 + i
            frag.set_bit(row, col)
            with out_mu:
                print(f"A {row} {col}", flush=True)

    threads = [threading.Thread(target=writer, args=(r,))
               for r in range(writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    frag.close()
    print("DONE", flush=True)


if __name__ == "__main__":
    child_main(sys.argv[1:])
    sys.exit(0)

from pilosa_tpu import SLICE_WIDTH  # noqa: E402
from pilosa_tpu import fault as jfault  # noqa: E402
from pilosa_tpu.core.fragment import Fragment as JaxFragment  # noqa: E402
from pilosa_tpu.core.wal import WAL_STATS as JAX_WAL_STATS  # noqa: E402
from pilosa_tpu.core.wal import WalConfig as JaxWalConfig  # noqa: E402
from pilosa_tpu.errors import \
    CorruptFragmentError as JaxCorrupt  # noqa: E402
from pilosa_tpu.errors import \
    WriteBackpressureError as JaxBackpressure  # noqa: E402
from pilosa_tpu.roaring import Bitmap as JaxBitmap  # noqa: E402
from pilosa_tpu.roaring.serialize import write_op as jax_write_op  # noqa

from pilosa_tpu_torch import fault as tfault  # noqa: E402
from pilosa_tpu_torch.api.handler import Handler  # noqa: E402
from pilosa_tpu_torch.core import Fragment, Holder  # noqa: E402
from pilosa_tpu_torch.core.wal import (FSYNC_ALWAYS, FSYNC_GROUP,  # noqa
                                       FSYNC_NEVER, WAL_STATS, WalConfig)
from pilosa_tpu_torch.errors import (CorruptFragmentError,  # noqa: E402
                                     WriteBackpressureError)
from pilosa_tpu_torch.executor import Executor  # noqa: E402
from pilosa_tpu_torch.roaring import Bitmap  # noqa: E402
from pilosa_tpu_torch.roaring.serialize import write_op  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

PORT = "port"
JAX = "jax"
PKGS = {PORT: (Fragment, WalConfig, tfault, WriteBackpressureError),
        JAX: (JaxFragment, JaxWalConfig, jfault, JaxBackpressure)}
CORRUPT = {PORT: CorruptFragmentError, JAX: JaxCorrupt}


@pytest.fixture(autouse=True)
def _clean_faults():
    tfault.reset(seed=0)
    jfault.reset(seed=0)
    yield
    tfault.reset(seed=0)
    jfault.reset(seed=0)


def frag(pkg, path, **wal_kw):
    cls, cfg, _, _ = PKGS[pkg]
    f = cls(str(path), "i", "f", "standard", 0,
            wal=cfg(**wal_kw) if wal_kw else None)
    f.open()
    return f


def bits_of(pkg, path) -> set:
    """Open the file fresh (a bare fragment) and return {(row, col)}."""
    f = frag(pkg, path)
    try:
        v = f.storage.slice()
        return {(int(p) // SLICE_WIDTH, int(p) % SLICE_WIDTH) for p in v}
    finally:
        f.close()


def both(run, tmp_path):
    """run(pkg, dir) in each package on its own directory; the results."""
    out = {}
    for pkg in (PORT, JAX):
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = run(pkg, d)
    return out


def seeded_bits(seed: int, n: int):
    """n distinct (row, col) pairs of one slice, from the seed."""
    rng = np.random.default_rng(seed)
    pos = rng.choice(8 * 70000, size=n, replace=False)
    return [(int(p) // 70000, int(p) % 70000) for p in pos]


# -- C3: the torn tail ------------------------------------------------------------


TORN_TAILS = {"partial record": b"\x00\x01\x02\x03\x04",
              "bad final record": b"\x00" * 9 + b"\xde\xad\xbe\xef"}


@pytest.mark.parametrize("tail", sorted(TORN_TAILS))
@pytest.mark.parametrize("policy", [FSYNC_NEVER, FSYNC_GROUP])
@pytest.mark.parametrize("seed", [0, 1])
def test_torn_tail_is_cut_before_the_next_append(tmp_path, tail, policy,
                                                 seed):
    """Write 5 bits and close; a crash mid-append leaves part of a
    record; reopen (5 bits), ack 2 more writes, close, reopen: 7 bits in
    both packages (the port raised "op checksum mismatch" here before
    the repair)."""
    stream = seeded_bits(seed, 7)

    def run(pkg, d):
        path = d / "frag"
        stats = WAL_STATS if pkg == PORT else JAX_WAL_STATS
        f = frag(pkg, path, fsync_policy=policy)
        for r, c in stream[:5]:
            f.set_bit(r, c)
        f.close()
        with open(path, "ab") as fh:
            fh.write(TORN_TAILS[tail])
        torn0 = stats.get("torn_tails", 0)
        f = frag(pkg, path, fsync_policy=policy)
        first = f.count()
        for r, c in stream[5:]:
            f.set_bit(r, c)
        f.close()
        return first, stats.get("torn_tails", 0) - torn0, bits_of(pkg, path)

    out = both(run, tmp_path)
    assert out[PORT] == out[JAX] == (5, 1, set(stream))


def test_torn_tail_through_the_holder(tmp_path):
    """The same crash under a served holder: a Count after the restart
    sees the acked prefix."""
    h = Holder(str(tmp_path / "d"), wal=WalConfig(FSYNC_GROUP))
    h.open()
    f = h.create_index_if_not_exists("i").create_frame_if_not_exists("f")
    for c in (1, 5, 9):
        f.set_bit(1, c)
    path = h.fragment("i", "f", "standard", 0).path
    h.close()
    with open(path, "ab") as fh:
        fh.write(b"\x00\x99")
    h = Holder(str(tmp_path / "d"), wal=WalConfig(FSYNC_GROUP))
    h.open()
    try:
        f = h.frame("i", "f")
        f.set_bit(1, 11)
        assert h.fragment("i", "f", "standard", 0).row(1).count() == 4
    finally:
        h.close()
    assert {c for _, c in bits_of(PORT, path)} == {1, 5, 9, 11}


def test_mid_log_damage_still_raises(tmp_path):
    """Only a tail is torn: a damaged record with records after it is
    rot, and the fragment refuses it in both packages."""
    def run(pkg, d):
        path = d / "frag"
        f = frag(pkg, path)
        for c in range(4):
            f.set_bit(0, c)
        f.close()
        data = bytearray(open(path, "rb").read())
        data[-20] ^= 0xFF  # inside the third of the four op records
        open(path, "wb").write(bytes(data))
        g = PKGS[pkg][0](str(path), "i", "f", "standard", 0)
        g.open(lazy=True)
        try:
            for _ in range(2):  # on every touch
                with pytest.raises(CORRUPT[pkg]):
                    g.count()
        finally:
            g.close()
        return os.path.getsize(path) == len(data)

    assert both(run, tmp_path) == {PORT: True, JAX: True}


# -- background snapshots ------------------------------------------------------------


def test_side_wal_replayed_on_reopen(tmp_path):
    """A crash between a snapshot's rename and its splice leaves a side
    .wal (and a stale temp): reopen replays the side log into main."""
    def run(pkg, d):
        path = str(d / "frag")
        f = frag(pkg, path)
        for i in range(4):
            f.set_bit(1, i)
        f.close()
        buf = io.BytesIO()
        w = write_op if pkg == PORT else jax_write_op
        for i in range(4, 8):
            w(buf, 0, SLICE_WIDTH + i)
        with open(path + ".wal", "wb") as sf:
            sf.write(buf.getvalue())
        with open(path + ".snapshotting", "wb") as tf:
            tf.write(b"half a snapshot")
        first = bits_of(pkg, path)
        left = (os.path.exists(path + ".wal"),
                os.path.exists(path + ".snapshotting"))
        return first, left, bits_of(pkg, path)

    out = both(run, tmp_path)
    want = {(1, i) for i in range(8)}
    assert out[PORT] == out[JAX] == (want, (False, False), want)


def test_side_wal_torn_tail_dropped(tmp_path):
    def run(pkg, d):
        path = str(d / "frag")
        f = frag(pkg, path)
        f.set_bit(1, 0)
        f.close()
        buf = io.BytesIO()
        (write_op if pkg == PORT else jax_write_op)(buf, 0, SLICE_WIDTH + 1)
        with open(path + ".wal", "wb") as sf:
            sf.write(buf.getvalue() + b"\x07torn")
        return bits_of(pkg, path)

    out = both(run, tmp_path)
    assert out[PORT] == out[JAX] == {(1, 0), (1, 1)}


def test_writer_not_stalled_by_a_slow_snapshot(tmp_path):
    """A 0.3 s snapshot: each write during it pays only the redirect
    flip (< 0.1 s), and the side log is spliced and gone after it."""
    def run(pkg, d):
        PKGS[pkg][2].arm("storage.fsync", delay=0.3, kind="snapshot")
        f = frag(pkg, d / "frag", fsync_policy=FSYNC_NEVER, max_op_n=20)
        try:
            for i in range(21):
                f.set_bit(0, i)
            flipped = f._snapshotting
            worst = 0.0
            for i in range(21, 31):
                t0 = time.monotonic()
                f.set_bit(0, i)
                worst = max(worst, time.monotonic() - t0)
            landed = f.wait_snapshot(timeout=10)
            side = os.path.exists(f.path + ".wal")
            n = f.count()
        finally:
            f.close()
        return flipped, worst < 0.1, landed, side, n, bits_of(pkg, d / "frag")

    out = both(run, tmp_path)
    assert out[PORT] == out[JAX] == (True, True, True, False, 31,
                                     {(0, i) for i in range(31)})


def test_snapshot_moves_neither_generation_nor_the_log(tmp_path):
    """A snapshot flip and splice leave the mutation log whole: the
    staged image's generation stays valid and log_since still reaches
    back, so the next Count scatters instead of restaging."""
    f = frag(PORT, tmp_path / "frag", fsync_policy=FSYNC_NEVER, max_op_n=10)
    try:
        for i in range(10):
            f.set_bit(0, i)
        gen = f.generation
        f.set_bit(0, 10)  # trips the snapshot
        f.snapshot()
        assert f.generation == gen + 1
        assert f.log_since(gen) == [(0, 10, False)]
        assert f.log_since(0) is not None and len(f.log_since(0)) == 11
    finally:
        f.close()


def test_forced_snapshot_waits_for_a_covering_attempt(tmp_path):
    def run(pkg, d):
        PKGS[pkg][2].arm("storage.fsync", delay=0.2, kind="snapshot",
                         times=1)
        f = frag(pkg, d / "frag", fsync_policy=FSYNC_NEVER, max_op_n=5)
        try:
            for i in range(6):
                f.set_bit(0, i)
            inflight = f._snapshotting
            f.set_bit(0, 99)  # rides the side log
            f.snapshot()      # must cover (0, 99)
            op_n = f.op_n
        finally:
            f.close()
        return inflight, op_n, (0, 99) in bits_of(pkg, d / "frag")

    out = both(run, tmp_path)
    assert out[PORT] == out[JAX] == (True, 0, True)


def test_failed_snapshot_leaves_the_fragment_serviceable(tmp_path):
    def run(pkg, d):
        f = frag(pkg, d / "frag")
        f.set_bit(0, 1)
        rule = PKGS[pkg][2].arm("storage.rename", error=RuntimeError)
        try:
            with pytest.raises(RuntimeError):
                f.snapshot()
            f.set_bit(0, 2)  # the op writer survived the failure
            PKGS[pkg][2].disarm(rule)
            f.snapshot()
            op_n = f.op_n
        finally:
            f.close()
        return op_n, bits_of(pkg, d / "frag")

    out = both(run, tmp_path)
    assert out[PORT] == out[JAX] == (0, {(0, 1), (0, 2)})


@pytest.mark.parametrize("policy", [FSYNC_NEVER, FSYNC_GROUP])
def test_max_op_n_one(tmp_path, policy):
    """A snapshot on every op: the rank cache's recounts never meet a
    half-spliced image."""
    def run(pkg, d):
        f = frag(pkg, d / "frag", fsync_policy=policy, max_op_n=1)
        try:
            for i in range(8):
                f.set_bit(0, i)
            n, cached = f.row(0).count(), f.cache.get(0)
            landed = f.wait_snapshot(timeout=10)
        finally:
            f.close()
        return n, cached, landed, bits_of(pkg, d / "frag")

    out = both(run, tmp_path)
    assert out[PORT] == out[JAX] == (8, 8, True, {(0, i) for i in range(8)})


def test_readers_during_snapshots_and_splices(tmp_path):
    """Readers racing background snapshots see no torn state, and the
    generation counts every write."""
    tfault.arm("storage.fsync", delay=0.05, kind="snapshot")
    f = frag(PORT, tmp_path / "frag", fsync_policy=FSYNC_NEVER, max_op_n=25)
    errs, stop = [], threading.Event()

    def reader():
        last = 0
        try:
            while not stop.is_set():
                n = f.row(0).count()
                assert n >= last, "a row count went backwards"
                last = n
                f.count()
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    readers = [threading.Thread(target=reader) for _ in range(4)]
    for t in readers:
        t.start()
    try:
        gen0 = f.generation
        for i in range(200):
            f.set_bit(0, i)
        assert f.generation == gen0 + 200
    finally:
        stop.set()
        for t in readers:
            t.join()
    assert not errs
    assert f.wait_snapshot(timeout=10)
    f.close()
    assert len(bits_of(PORT, tmp_path / "frag")) == 200


# -- the bulk import's barrier ------------------------------------------------------


def test_import_forces_a_covering_snapshot(tmp_path):
    def run(pkg, d):
        f = frag(pkg, d / "frag")
        try:
            f.import_bits([1, 1, 2], [0, 1, 5])
            out = (f.op_n, f.row(1).count())
        finally:
            f.close()
        return out + (bits_of(pkg, d / "frag"),)

    out = both(run, tmp_path)
    assert out[PORT] == out[JAX] == (0, 2, {(1, 0), (1, 1), (2, 5)})


def test_import_partial_failure_restores_the_disk_state(tmp_path):
    def run(pkg, d):
        f = frag(pkg, d / "frag")
        f.set_bit(3, 7)
        rule = PKGS[pkg][2].arm("storage.import_apply", error=RuntimeError)
        try:
            with pytest.raises(RuntimeError):
                f.import_bits([1, 1, 2], [0, 1, 5])
            after = (f.count(), f.row(1).count(), f.cache.get(1) or 0)
            PKGS[pkg][2].disarm(rule)
            f.set_bit(3, 8)
            f.import_bits([1], [0])
        finally:
            f.close()
        return after, bits_of(pkg, d / "frag")

    out = both(run, tmp_path)
    assert out[PORT] == out[JAX] == ((1, 0, 0), {(3, 7), (3, 8), (1, 0)})


# -- write backpressure ---------------------------------------------------------------


def test_shed_when_the_snapshot_stalls(tmp_path):
    def run(pkg, d):
        _, _, flt, err = PKGS[pkg]
        flt.arm("storage.fsync", delay=1.0, kind="snapshot")
        f = frag(pkg, d / "frag", fsync_policy=FSYNC_NEVER, max_op_n=10,
                 max_wal_ops=20, backpressure_deadline=0.15)
        acked = 0
        try:
            with pytest.raises(err) as ei:
                for i in range(500):
                    f.set_bit(0, i)
                    acked += 1
            shed = (ei.value.retry_after_s >= 1.0, ei.value.transient)
            assert f.wait_snapshot(timeout=10)
            flt.reset()
            f.set_bit(1, 0)  # the gate opened again
        finally:
            f.close()
        got = bits_of(pkg, d / "frag")
        return shed, got == {(0, i) for i in range(acked)} | {(1, 0)}

    out = both(run, tmp_path)
    assert out[PORT] == out[JAX] == ((True, True), True)


def test_shed_bounds_the_side_log(tmp_path):
    tfault.arm("storage.fsync", delay=1.0, kind="snapshot")
    shed0 = WAL_STATS.get("backpressure_shed", 0)
    f = frag(PORT, tmp_path / "frag", fsync_policy=FSYNC_NEVER, max_op_n=10,
             max_wal_ops=20, backpressure_deadline=0.15)
    try:
        with pytest.raises(WriteBackpressureError):
            for i in range(500):
                f.set_bit(0, i)
        assert f.op_n <= 20 + 1
        assert WAL_STATS.get("backpressure_shed", 0) == shed0 + 1
    finally:
        tfault.reset()
        f.close()


def test_a_deadline_caps_the_backpressure_wait(tmp_path):
    tfault.arm("storage.fsync", delay=1.0, kind="snapshot")
    f = frag(PORT, tmp_path / "frag", fsync_policy=FSYNC_NEVER, max_op_n=5,
             max_wal_ops=8, backpressure_deadline=30.0)
    try:
        with pytest.raises(WriteBackpressureError):
            for i in range(100):
                t0 = time.monotonic()
                f.set_bit(0, i, deadline=time.monotonic() + 0.1)
                assert time.monotonic() - t0 < 5.0
    finally:
        tfault.reset()
        f.close()


def test_unbounded_when_disabled(tmp_path):
    tfault.arm("storage.fsync", delay=0.2, kind="snapshot")
    f = frag(PORT, tmp_path / "frag", fsync_policy=FSYNC_NEVER, max_op_n=10,
             max_wal_ops=0)
    try:
        for i in range(100):
            f.set_bit(0, i)  # never sheds
    finally:
        f.close()
    assert len(bits_of(PORT, tmp_path / "frag")) == 100


def test_query_answers_503_with_retry_after(tmp_path):
    """Through the handler: a shed SetBit answers 503 with Retry-After
    (>= 1 s), every write acked before it is kept, and /debug/vars
    carries the storage state."""
    tfault.arm("storage.fsync", delay=2.0, kind="snapshot")
    h = Holder(str(tmp_path / "data"), wal=WalConfig(
        FSYNC_NEVER, max_op_n=5, max_wal_ops=8, backpressure_deadline=0.05))
    h.open()
    handler = Handler(h, Executor(h, device="cpu"))
    try:
        assert handler.handle("POST", "/index/i").status == 200
        assert handler.handle("POST", "/index/i/frame/f").status == 200
        saw, acked = None, []
        for i in range(60):
            r = handler.handle("POST", "/index/i/query", body=(
                f"SetBit(rowID=0, frame=f, columnID={i})").encode())
            if r.status == 503:
                saw = r
                break
            assert r.status == 200
            acked.append(i)
        assert saw is not None, "backpressure never shed"
        assert int(saw.headers["Retry-After"]) >= 1
        assert "backpressure" in saw.json()["error"]
        tfault.reset()
        frag_ = h.fragment("i", "f", "standard", 0)
        assert frag_.wait_snapshot(timeout=10)
        dv = handler.handle("GET", "/debug/vars").json()
        assert [s["fsync_policy"] for s in dv["storage"]["fragments"]] == [
            FSYNC_NEVER]
        assert dv["storage"]["wal"]["backpressure_shed"] >= 1
        r = handler.handle("POST", "/index/i/query",
                           body=b"Count(Bitmap(rowID=0, frame=f))")
        assert r.json()["results"] == [len(acked)]
    finally:
        h.close()


# -- the integrity footer's bytes -------------------------------------------------------


def footer_bitmaps():
    rng = np.random.default_rng(5)
    dense = rng.choice(1 << 16, size=5000, replace=False)
    return {"empty": [],
            "arrays": [1, 5, 70000, 3 * SLICE_WIDTH + 9],
            "bitmap and arrays": sorted(set(dense.tolist())
                                        | {1 << 20, (1 << 20) + 7}),
            "full container": list(range(1 << 16))}


@pytest.mark.parametrize("name", sorted(footer_bitmaps()))
def test_footer_bytes_are_the_jax_packages(name):
    vals = footer_bitmaps()[name]
    port = Bitmap(np.asarray(vals, dtype=np.uint64)).to_bytes(footer=True)
    jax = JaxBitmap(vals).to_bytes(footer=True)
    assert port == jax
    # Each package verifies the other's file.
    a = JaxBitmap.from_bytes(port, verify=True)
    b = Bitmap.from_bytes(jax, verify=True)
    assert a.verified_footer and b.verified_footer
    assert list(a.slice()) == [int(v) for v in b.slice()] == sorted(vals)
    # Without a footer both still load, unverified.
    bare = Bitmap(np.asarray(vals, dtype=np.uint64)).to_bytes()
    assert bare == JaxBitmap(vals).to_bytes()
    assert not Bitmap.from_bytes(bare, verify=True).verified_footer


def test_snapshot_files_verify_in_both_packages(tmp_path):
    """A fragment file the port snapshotted, ops appended after it,
    loads verified in the JAX package, and the JAX package's in the
    port."""
    stream = seeded_bits(3, 300)

    def run(pkg, d):
        f = frag(pkg, d / "frag", fsync_policy=FSYNC_NEVER, max_op_n=100)
        for r, c in stream:
            f.set_bit(r, c)
        assert f.wait_snapshot(timeout=10)
        f.close()
        return open(d / "frag", "rb").read()

    out = both(run, tmp_path)
    for data in out.values():
        a = Bitmap.from_bytes(data, verify=True)
        b = JaxBitmap.from_bytes(data, verify=True)
        assert a.verified_footer and b.verified_footer
        assert [int(v) for v in a.slice()] == list(b.slice())
        assert a.count() == len(stream)


# -- power-loss torture ------------------------------------------------------------


def run_child(cmd, env, kill_after_acks=None):
    """Run a torture child; (acked {(row, col)}, ran to DONE)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL,
                            env={**os.environ, "JAX_PLATFORMS": "cpu", **env})
    acked, done = set(), False
    try:
        for raw in proc.stdout:
            line = raw.decode(errors="replace")
            if not line.endswith("\n"):
                break  # the kill landed mid-print
            if line.startswith("A "):
                _, row, col = line.split()
                acked.add((int(row), int(col)))
                if kill_after_acks is not None \
                        and len(acked) >= kill_after_acks:
                    proc.kill()
            elif line.startswith("DONE"):
                done = True
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    return acked, done


def torture(tmp_path, policy, kill_point, kill_after, writers=WRITERS,
            jax_child=JAX_CHILD):
    """The port's child and the JAX package's, side by side, each on its
    own directory: {pkg: (acked, done, survived)}."""
    env = {}
    parent_kill = None
    if policy == FSYNC_NEVER:
        env = {"PILOSA_TORCH_WAL_SIM_POWER_LOSS": "1",
               "PILOSA_TPU_WAL_SIM_POWER_LOSS": "1"}
        if kill_point == "commit-fsync":  # never commits: kill from here
            kill_point, parent_kill = "none", 300
    dirs = {pkg: tmp_path / pkg for pkg in (PORT, JAX)}
    cmds = {PORT: [sys.executable, PORT_CHILD, PORT, str(dirs[PORT]), policy,
                   kill_point, str(kill_after), str(writers)]}
    cmds[JAX] = ([sys.executable, jax_child, str(dirs[JAX]), policy,
                  kill_point, str(kill_after)] if jax_child == JAX_CHILD else
                 [sys.executable, PORT_CHILD, JAX, str(dirs[JAX]), policy,
                  kill_point, str(kill_after), str(writers)])
    results = {}

    def go(pkg):
        dirs[pkg].mkdir()
        results[pkg] = run_child(cmds[pkg], env, parent_kill)

    threads = [threading.Thread(target=go, args=(p,)) for p in (PORT, JAX)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {pkg: results[pkg] + (bits_of(pkg, dirs[pkg] / "frag"),)
            for pkg in (PORT, JAX)}


KILL_POINTS = [("commit-fsync", 10), ("snapshot-fsync", 2), ("rename", 2)]


@pytest.mark.parametrize("kill_point,kill_after", KILL_POINTS)
@pytest.mark.parametrize("policy", [FSYNC_GROUP, FSYNC_ALWAYS])
def test_power_loss_keeps_every_acked_bit(tmp_path, policy, kill_point,
                                          kill_after):
    out = torture(tmp_path, policy, kill_point, kill_after)
    written = {(r, r * 10000 + i) for r in range(WRITERS)
               for i in range(PER_WRITER)}
    for pkg, (acked, done, survived) in out.items():
        assert not done, f"{pkg}: the kill never landed"
        assert acked, f"{pkg}: no write acked before the kill"
        assert acked <= survived <= written, (
            pkg, len(acked - survived), sorted(acked - survived)[:5])


@pytest.mark.parametrize("kill_point,kill_after", KILL_POINTS)
def test_power_loss_never_policy_reopens_clean(tmp_path, kill_point,
                                               kill_after):
    """never with the power-loss simulation: acked bits may be lost (the
    policy's contract) and the file reopens. Nothing is invented: each
    writer's surviving bits are a prefix of its writes, reaching at
    most its one write in flight past its last ack."""
    out = torture(tmp_path, FSYNC_NEVER, kill_point, kill_after)
    for pkg, (acked, done, survived) in out.items():
        assert not done, f"{pkg}: the kill never landed"
        assert acked, pkg
        for r in range(WRITERS):
            k = len([c for row, c in acked if row == r])
            got = sorted(c - r * 10000 for row, c in survived if row == r)
            assert got == list(range(len(got))) and len(got) <= k + 1, (
                pkg, r, k, got[-3:])


@pytest.mark.parametrize("kill_after", [5, 23])
def test_power_loss_one_writer_is_exact(tmp_path, kill_after):
    """One writer: each commit covers one op, so a kill before commit
    k + 1 keeps exactly the first k bits, in both packages."""
    out = torture(tmp_path, FSYNC_GROUP, "commit-fsync", kill_after,
                  writers=1, jax_child=PORT_CHILD)
    want = {(0, i) for i in range(kill_after)}
    assert out[PORT] == out[JAX] == (want, False, want)


# -- the storage config, the fault specs, lazy loading ------------------------------


def test_server_flags_have_the_jax_configs_names_and_defaults():
    from pilosa_tpu.config import Config

    from pilosa_tpu_torch.api.server import parse_args

    c, a = Config(), parse_args(["-d", "x"])
    assert (a.max_wal_ops, a.backpressure_deadline, a.max_op_n,
            a.scrub_interval, a.scrub_rate_limit_bytes,
            a.shadow_sample_1_in) == (
        c.storage_max_wal_ops, c.storage_backpressure_deadline,
        c.storage_max_op_n, c.integrity_scrub_interval,
        c.integrity_rate_limit, c.integrity_shadow_sample)
    a = parse_args(["-d", "x", "--backpressure-deadline", "250ms",
                    "--scrub-interval", "10m", "--max-wal-ops", "256"])
    assert (a.backpressure_deadline, a.scrub_interval, a.max_wal_ops) == (
        0.25, 600.0, 256)


SPEC = ("storage.fsync:kind=snapshot,delay=300ms,after=2,times=3;"
        "storage.corrupt:bits=3,kind=snapshot;"
        "device.exec:kind=count-result,delta=5")


def test_fault_specs_arm_the_same_rules():
    """The JAX spec syntax arms the same rules in both packages, and the
    data faults act alike under one seed: the same bits flipped, the
    same shift."""
    out = []
    for flt in (tfault, jfault):
        flt.reset(seed=11)
        rules = flt.load_spec(SPEC)
        data = bytes(range(256)) * 4
        out.append(([(r.point, r.delay, r.after, r.times, r.bits, r.delta,
                      dict(r.match)) for r in rules],
                    flt.corrupt("storage.corrupt", data, kind="snapshot"),
                    flt.corrupt("storage.corrupt", data, kind="side-wal"),
                    flt.perturb("device.exec", 10, kind="count-result"),
                    flt.perturb("device.exec", 10, kind="count")))
        flt.reset(seed=0)
    assert out[0] == out[1]
    assert out[0][1] != bytes(range(256)) * 4 and out[0][3] == 15


def test_holder_opens_fragments_lazily(tmp_path):
    """A start parses no fragment: each loads on its first touch, with
    its policy, and an untouched one keeps its rank-cache file."""
    h = Holder(str(tmp_path / "d"))
    h.open()
    f = h.create_index_if_not_exists("i").create_frame_if_not_exists("f")
    for s in range(3):
        f.set_bit(s + 1, s * SLICE_WIDTH + 5)
    h.close()
    cache = tmp_path / "d" / "i" / "f" / "standard" / "fragments" / "2.cache"
    kept = cache.read_text()
    h = Holder(str(tmp_path / "d"), wal=WalConfig(FSYNC_GROUP))
    h.open()
    try:
        frags = [h.fragment("i", "f", "standard", s) for s in range(3)]
        assert all(fr._pending_load for fr in frags)
        assert frags[0].row(1).count() == 1
        assert [fr._pending_load for fr in frags] == [False, True, True]
        frags[1].set_bit(2, SLICE_WIDTH + 6)
        assert frags[1]._wal.fsyncs == 1  # the holder's policy
        assert [s["slice"] for s in h.storage_state()] == [0, 1]
    finally:
        h.close()
    assert cache.read_text() == kept


def test_blocks_and_checksum_are_the_jax_packages(tmp_path):
    stream = seeded_bits(4, 500) + [(150, 3), (250, 9)]

    def run(pkg, d):
        f = frag(pkg, d / "frag")
        try:
            for r, c in stream:
                f.set_bit(r, c)
            return f.blocks(), f.checksum()
        finally:
            f.close()

    out = both(run, tmp_path)
    assert out[PORT] == out[JAX] and len(out[PORT][0]) == 3


def test_footer_after_writes_matches_a_fresh_one(tmp_path):
    """A snapshot reuses the container checksums of the footer it loaded
    and hashes only what changed since: after sets and clears, an array
    grown into a bitmap and back, and a container emptied, the file
    equals the JAX package's fresh serialization of the same bits."""
    path = tmp_path / "frag"
    f = frag(PORT, path, fsync_policy=FSYNC_NEVER)
    for c in range(0, 5000, 2):
        f.set_bit(0, c)
    for c in (70000, 140000):
        f.set_bit(0, c)
    f.snapshot()
    f.close()
    f = frag(PORT, path, fsync_policy=FSYNC_NEVER)
    try:
        for c in range(1, 400, 2):
            f.set_bit(0, c)        # array -> bitmap
        for c in range(0, 800, 2):
            f.clear_bit(0, c)      # bitmap -> array
        f.clear_bit(0, 140000)     # a container emptied
        f.set_bit(3, 7)            # a new one
        f.snapshot()
        vals = [int(v) for v in f.storage.slice()]
    finally:
        f.close()
    assert open(path, "rb").read() == JaxBitmap(vals).to_bytes(footer=True)
