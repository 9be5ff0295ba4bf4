"""The port's data integrity against the JAX package's: rot detection in
snapshot files, corrupt fragments, the scrubber, and shadow
verification of the card's answers.

- Every single-byte flip of a small snapshot file either fails
  verification or parses to exactly the right bits, and both packages
  agree on which, flip by flip.
- A fragment whose file fails verification raises CorruptFragmentError
  on every touch and keeps the file; the holder opens anyway, other
  fragments serve, and the handler answers 500 for a query that touches
  it.
- The scrubber (core/scrub.py) repairs a loaded fragment's rotted file
  from memory, leaves an unloaded one's in place, catches rot in a file
  without a footer by the block diff, is inert when disabled and paces
  to its rate.
- Shadow verification on device="cpu" (the plain versions of the
  kernels): a clean sample matches, 0 means no checks, a delta= fault at
  the result seam is caught, served as the host value and quarantines
  the plan (?explain shows it), and TopN and Sum / Min / Max are
  sampled too. The Count cases run through the JAX executor as well,
  with the same counters moving.
"""

import os
import time

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu import fault as jfault
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import SHADOW_STATS as JAX_SHADOW
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.pql import parse_string as jax_parse
from pilosa_tpu.roaring import Bitmap as JaxBitmap

from pilosa_tpu_torch import fault as tfault
from pilosa_tpu_torch.api.handler import Handler
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.fragment import (INTEGRITY_STATS,
                                            bitmap_block_checksums)
from pilosa_tpu_torch.core.scrub import SCRUB_STATS, Scrubber
from pilosa_tpu_torch.errors import CorruptFragmentError
from pilosa_tpu_torch.executor import SHADOW_STATS, Executor
from pilosa_tpu_torch.pql import parse_string
from pilosa_tpu_torch.roaring import Bitmap
from pilosa_tpu_torch.roaring.serialize import CorruptSnapshotError
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_LONE_FUSED", "off")
    for f in (jfault, tfault):
        f.reset(seed=0)
    yield
    for f in (jfault, tfault):
        f.reset(seed=0)


def flip(path, offset, xor=0x01):
    """Flip one byte of a file in place: rot at rest."""
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ xor]))


def seed_holder(path, bits, cls=Holder, **kw):
    h = cls(str(path), **kw)
    h.open()
    f = h.create_index_if_not_exists("i").create_frame_if_not_exists(
        "general")
    for row, col in bits:
        f.set_bit(row, col)
    return h


def frag0(h):
    return h.fragment("i", "general", "standard", 0)


def snapshotted(h):
    """Fragment 0 written out as a bare snapshot with its footer (no op
    log), so every byte of it is covered by the footer."""
    f = frag0(h)
    f.snapshot()
    assert f.wait_snapshot(timeout=30)
    return f


# -- rot in a snapshot file ----------------------------------------------------------


def outcome(cls, data: bytes, region_len: int, want):
    """'detected', 'intact' (a flip in the footer's own bytes, data
    right), or a failure string."""
    try:
        out = cls.from_bytes(data, truncate_torn_tail=True, verify=True)
    except ValueError:
        return "detected"
    got = [int(v) for v in out.slice()]
    return "intact" if got == want else f"wrong data ({len(got)} values)"


SMALL = {"arrays": [1, 5, 70000, 3 * SLICE_WIDTH + 9],
         "one value": [42],
         "two rows": [0, 7, SLICE_WIDTH + 3, 2 * SLICE_WIDTH + 100]}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_every_byte_flip_is_detected_or_harmless(name):
    """Every single-byte flip of a footered snapshot: a flip in the
    region is detected; one in the footer's metadata is detected or
    leaves the data exact. The two packages agree flip by flip."""
    vals = SMALL[name]
    data = Bitmap(np.asarray(vals, dtype=np.uint64)).to_bytes(footer=True)
    region_len = len(Bitmap(np.asarray(vals, dtype=np.uint64)).to_bytes())
    want = sorted(vals)
    port, jax = [], []
    for off in range(len(data)):
        rotted = bytearray(data)
        rotted[off] ^= 0x01
        port.append(outcome(Bitmap, bytes(rotted), region_len, want))
        jax.append(outcome(JaxBitmap, bytes(rotted), region_len, want))
    assert port == jax
    assert all(o == "detected" for o in port[:region_len])
    assert all(o in ("detected", "intact") for o in port[region_len:])


def test_bitmap_container_flips_are_detected_sampled():
    rng = np.random.default_rng(9)
    vals = sorted(set(rng.choice(1 << 16, 6000, replace=False).tolist())
                  | {SLICE_WIDTH + 1})
    data = Bitmap(np.asarray(vals, dtype=np.uint64)).to_bytes(footer=True)
    region_len = len(Bitmap(np.asarray(vals, dtype=np.uint64)).to_bytes())
    for off in list(range(0, region_len, 331)) + [region_len - 1]:
        rotted = bytearray(data)
        rotted[off] ^= 0x10
        assert outcome(Bitmap, bytes(rotted), region_len, vals) == \
            outcome(JaxBitmap, bytes(rotted), region_len, vals) == \
            "detected", off


def test_rot_names_the_container():
    """A flip in a container's payload is localized to that container's
    key by its FNV-1a, as in the JAX package."""
    vals = [1, 3 * SLICE_WIDTH + 2]
    bm = Bitmap(np.asarray(vals, dtype=np.uint64))
    data = bytearray(bm.to_bytes(footer=True))
    data[len(bm.to_bytes()) - 2] ^= 0xFF  # the last container's payload
    with pytest.raises(CorruptSnapshotError) as ei:
        Bitmap.from_bytes(bytes(data), verify=True)
    with pytest.raises(ValueError) as ej:
        JaxBitmap.from_bytes(bytes(data), verify=True)
    assert ei.value.bad_keys == list(ej.value.bad_keys) == [bm.keys[-1]]


# -- corrupt fragments -------------------------------------------------------------


BITS = [(1, 0), (1, 3), (2, 100)]


def rotted_dir(tmp_path, name="d"):
    """A holder directory whose fragment 0 of i/general is a snapshot
    with one byte flipped, beside a sound index `j`; (dir, the file)."""
    h = seed_holder(tmp_path / name, BITS)
    j = h.create_index_if_not_exists("j").create_frame_if_not_exists("f")
    j.set_bit(4, 2)
    path = snapshotted(h).path
    h.close()
    flip(path, 10)
    return tmp_path / name, path


def test_corrupt_fragment_raises_on_every_touch_and_stays(tmp_path):
    root, path = rotted_dir(tmp_path)
    size = os.path.getsize(path)
    base = INTEGRITY_STATS.get("unrepaired", 0)
    h = Holder(str(root))
    h.open()  # opens: the fragment is parsed on first touch
    try:
        f = frag0(h)
        for _ in range(3):
            with pytest.raises(CorruptFragmentError):
                f.row(1)
        with pytest.raises(CorruptFragmentError):
            f.set_bit(1, 9)  # a write is refused, never logged
        assert INTEGRITY_STATS.get("unrepaired", 0) == base + 4
        assert h.fragment("j", "f", "standard", 0).row(4).count() == 1
    finally:
        h.close()
    assert os.path.getsize(path) == size
    assert not os.path.exists(path + ".corrupt")


def test_corrupt_fragment_fails_only_its_queries(tmp_path):
    """Through the handler on device="cpu": a Count touching the rotted
    slice answers 500 with the error's message, never a number; the
    other index answers; nothing is quarantined (not a kernel error) and
    nothing folds on the host (the fold would read the same file)."""
    root, _ = rotted_dir(tmp_path)
    h = Holder(str(root))
    h.open()
    ex = Executor(h, device="cpu", sparse_density_threshold=0)
    handler = Handler(h, ex)
    try:
        for _ in range(2):
            r = handler.handle("POST", "/index/i/query",
                               body=b"Count(Bitmap(rowID=1))")
            assert r.status == 500
            assert "corrupt" in r.json()["error"]
        r = handler.handle("POST", "/index/j/query",
                           body=b"Count(Bitmap(rowID=4, frame=f))")
        assert r.status == 200 and r.json()["results"] == [1]
        mgr = ex.mesh_manager()
        assert mgr.quarantined_plans() == []
        assert ex.stats["count_host"] == 0
    finally:
        h.close()


def test_storage_corrupt_seam_flips_bits_at_load(tmp_path):
    h = seed_holder(tmp_path / "d", BITS)
    snapshotted(h)
    h.close()
    tfault.arm("storage.corrupt", bits=1, kind="snapshot", times=1)
    h = Holder(str(tmp_path / "d"))
    h.open()
    try:
        with pytest.raises(CorruptFragmentError):
            frag0(h).row(1)
        # The rot was in the bytes read, not on disk: the next touch
        # parses the sound file.
        assert frag0(h).row(1).count() == 2
    finally:
        h.close()


# -- the scrubber -------------------------------------------------------------------


def test_clean_pass_counts_and_timestamps(tmp_path):
    h = seed_holder(tmp_path / "d", [(1, 0), (2, SLICE_WIDTH + 1)])
    frags0 = SCRUB_STATS.get("fragments", 0)
    s = Scrubber(h, rate_limit=0)
    try:
        assert s.scrub_pass() == 2
        assert SCRUB_STATS.get("fragments", 0) == frags0 + 2
        assert all(h.fragment("i", "general", "standard", sl).last_scrub > 0
                   for sl in (0, 1))
        snap = s.snapshot()
        assert snap["last_pass_fragments"] == 2 and snap["enabled"]
    finally:
        h.close()


def test_disabled_scrubber_is_inert(tmp_path):
    h = seed_holder(tmp_path / "d", [(1, 0)])
    try:
        assert Scrubber(h, enabled=False).scrub_pass() == 0
        assert frag0(h).last_scrub == 0.0
        assert h.scrubber.snapshot()["enabled"] is False  # interval 0
    finally:
        h.close()


def test_rot_in_a_loaded_fragment_is_rewritten_from_memory(tmp_path):
    h = seed_holder(tmp_path / "d", [(1, 0), (1, 9)])
    f = snapshotted(h)
    flip(f.path, 10)
    corrupt0 = SCRUB_STATS.get("corrupt", 0)
    repairs0 = SCRUB_STATS.get("repairs", 0)
    try:
        Scrubber(h, rate_limit=0).scrub_pass()
        assert SCRUB_STATS.get("corrupt", 0) == corrupt0 + 1
        assert SCRUB_STATS.get("repairs", 0) == repairs0 + 1
        data = open(f.path, "rb").read()
        for cls in (Bitmap, JaxBitmap):
            out = cls.from_bytes(data, truncate_torn_tail=True, verify=True)
            assert out.verified_footer
        assert bitmap_block_checksums(Bitmap.from_bytes(data)) == dict(
            f.blocks())
        assert f.row(1).count() == 2
    finally:
        h.close()


def test_rot_in_an_unloaded_fragment_stays_and_is_counted(tmp_path):
    root, path = rotted_dir(tmp_path)
    h = Holder(str(root))
    h.open()
    unrep0 = SCRUB_STATS.get("unrepaired", 0)
    try:
        assert frag0(h)._pending_load
        Scrubber(h, rate_limit=0).scrub_pass()
        assert SCRUB_STATS.get("unrepaired", 0) == unrep0 + 1
        with pytest.raises(CorruptFragmentError):
            frag0(h).row(1)
    finally:
        h.close()
    assert not os.path.exists(path + ".corrupt")


def test_block_diff_catches_rot_in_a_file_without_a_footer(tmp_path):
    """A file written before footers cannot show its own rot: the
    scrubber's diff of its blocks against memory does, and the repair
    writes a footered snapshot."""
    h = seed_holder(tmp_path / "d", [(1, 0), (1, 9)])
    f = snapshotted(h)
    with open(f.path, "wb") as fh:  # the same image, footerless
        f.storage.write_to(fh)
    # Flip a bit of the one container's payload (array values are u32).
    flip(f.path, len(f.storage.to_bytes()) - 4)
    assert Bitmap.from_bytes(open(f.path, "rb").read(),
                             verify=True).verified_footer is False
    corrupt0 = SCRUB_STATS.get("corrupt", 0)
    try:
        Scrubber(h, rate_limit=0).scrub_pass()
        assert SCRUB_STATS.get("corrupt", 0) == corrupt0 + 1
        out = Bitmap.from_bytes(open(f.path, "rb").read(), verify=True)
        assert out.verified_footer and out.count() == 2
    finally:
        h.close()


def test_rate_limit_paces_the_pass(tmp_path):
    h = seed_holder(tmp_path / "d", [(1, 0), (1, 1)])
    snapshotted(h)
    size = os.path.getsize(frag0(h).path)
    try:
        t0 = time.monotonic()
        Scrubber(h, rate_limit=0).scrub_pass()
        unpaced = time.monotonic() - t0
        t0 = time.monotonic()
        Scrubber(h, rate_limit=max(1, int(size / 0.3))).scrub_pass()
        paced = time.monotonic() - t0
        assert paced >= 0.25 and unpaced < paced
    finally:
        h.close()


def test_holder_runs_and_stops_the_scrubber(tmp_path):
    h = seed_holder(tmp_path / "d", [(1, 0)], scrub_interval=0.05,
                    scrub_rate_limit=0)
    try:
        for _ in range(200):
            if h.scrubber.last_pass_fragments:
                break
            time.sleep(0.01)
        assert frag0(h).last_scrub > 0
    finally:
        h.close()
    assert h.scrubber._thread is None


# -- shadow verification ---------------------------------------------------------


def shadow(stats, prefix):
    return sum(v for k, v in stats.copy().items()
               if k.startswith(prefix + ":"))


MESH = {"quarantine_after": 99, "quarantine_ttl": 60.0}


def executors(tmp_path, bits):
    """(port holder, port executor, jax holder, jax executor), each with
    shadow_sample 1."""
    ph = seed_holder(tmp_path / "port", bits)
    jh = seed_holder(tmp_path / "jax", bits, cls=JaxHolder)
    pe = Executor(ph, device="cpu", mesh_config=MESH, shadow_sample=1)
    je = JaxExecutor(jh, use_device=True, mesh_config=MESH)
    je.shadow_sample = 1
    return ph, pe, jh, je


def test_clean_sample_matches(tmp_path):
    ph, pe, jh, je = executors(tmp_path, [(1, 0), (1, SLICE_WIDTH + 5)])
    try:
        deltas = []
        for e, parse, stats in ((pe, parse_string, SHADOW_STATS),
                                (je, jax_parse, JAX_SHADOW)):
            c0, m0 = shadow(stats, "checks"), shadow(stats, "mismatch")
            assert e.execute("i", parse("Count(Bitmap(rowID=1))")) == [2]
            deltas.append((shadow(stats, "checks") - c0,
                           shadow(stats, "mismatch") - m0))
        assert deltas[0] == deltas[1] == (1, 0)
    finally:
        ph.close()
        jh.close()


def test_disabled_means_zero_checks(tmp_path):
    h = seed_holder(tmp_path / "d", [(1, 0)])
    e = Executor(h, device="cpu")  # shadow_sample stays 0
    checks0 = shadow(SHADOW_STATS, "checks")
    try:
        assert e.execute("i", parse_string("Count(Bitmap(rowID=1))")) == [1]
        assert shadow(SHADOW_STATS, "checks") == checks0
    finally:
        h.close()


def test_one_in_n_samples_every_nth(tmp_path):
    h = seed_holder(tmp_path / "d", [(1, 0)])
    e = Executor(h, device="cpu", shadow_sample=3)
    checks0 = shadow(SHADOW_STATS, "checks")
    try:
        for _ in range(7):
            e.execute("i", parse_string("Count(Bitmap(rowID=1))"))
        assert shadow(SHADOW_STATS, "checks") - checks0 == 3  # 1st, 4th, 7th
    finally:
        h.close()


def test_mismatch_serves_the_host_value_and_quarantines(tmp_path):
    """A kernel that silently miscomputes (delta= at the result seam):
    the Count answers the host value, the mismatch is counted once, the
    plan is quarantined (?explain), and the next Count of that shape
    folds on the host, exact, with the fault still armed. The same in
    both packages."""
    ph, pe, jh, je = executors(tmp_path, [(1, 0), (1, 7)])
    try:
        out = []
        for e, parse, stats, flt in (
                (pe, parse_string, SHADOW_STATS, tfault),
                (je, jax_parse, JAX_SHADOW, jfault)):
            m0 = shadow(stats, "mismatch")
            flt.arm("device.exec", delta=5, kind="count-result")
            first = e.execute("i", parse("Count(Bitmap(rowID=1))"))
            mis = shadow(stats, "mismatch") - m0
            mgr = e.mesh_manager()
            call = e.explain("i", parse("Count(Bitmap(rowID=2))"))["calls"][0]
            plan = call["plan"] if e is pe else call["plan_cache"]
            nxt = e.execute("i", parse("Count(Bitmap(rowID=1))"))
            out.append((first, mis, len(mgr.quarantined_plans()),
                        plan["quarantined"], call["route_reason"], nxt))
        assert out[0] == out[1] == ([2], 1, 1, True, "quarantined", [2])
        assert pe.stats["count_host"] == 1  # the quarantined repeat
    finally:
        ph.close()
        jh.close()


def test_topn_and_aggregates_are_sampled(tmp_path):
    """TopN (the ranked form, by recounting the ids the card returned,
    and the ids form), and Sum / Min / Max against bsi.host: checked,
    no mismatch, the card's answers served."""
    h = seed_holder(tmp_path / "d", [(1, 0), (1, 3), (2, 0), (3, 9)])
    h.index("i").create_frame_if_not_exists("v", fields=[
        {"name": "x", "min": -100, "max": 100}])
    for col, val in ((0, 5), (3, -7), (9, 60)):
        h.frame("i", "v").set_value("x", col, val)
    e = Executor(h, device="cpu", shadow_sample=1)
    c0, b0 = SHADOW_STATS.get("checks:mesh", 0), SHADOW_STATS.get(
        "checks:bsi", 0)
    m0 = shadow(SHADOW_STATS, "mismatch")
    try:
        q = lambda s: e.execute("i", parse_string(s))[0]  # noqa: E731
        assert q("TopN(frame=general, n=2)") == [(1, 2), (2, 1)]
        assert q("TopN(frame=general, n=2, ids=[1,2])") == [(1, 2), (2, 1)]
        assert q("TopN(Bitmap(rowID=2), frame=general, n=3)") == [
            (1, 1), (2, 1)]
        assert q('Sum(frame=v, field="x")') == {"value": 58, "count": 3}
        assert q('Min(frame=v, field="x")') == {"value": -7, "count": 1}
        assert q('Max(Bitmap(rowID=1), frame=v, field="x")') == {
            "value": 5, "count": 1}
        assert SHADOW_STATS.get("checks:mesh", 0) - c0 == 3
        assert SHADOW_STATS.get("checks:bsi", 0) - b0 == 3
        assert shadow(SHADOW_STATS, "mismatch") == m0
        assert e.stats["topn_device"] == 3 and e.stats["bsi_device"] == 3
    finally:
        h.close()


def test_perturbed_topn_and_sum_serve_the_host(tmp_path):
    h = seed_holder(tmp_path / "d", [(1, 0), (1, 3), (2, 0)])
    h.index("i").create_frame_if_not_exists("v", fields=[
        {"name": "x", "min": 0, "max": 100}])
    for col, val in ((0, 5), (3, 7)):
        h.frame("i", "v").set_value("x", col, val)
    e = Executor(h, device="cpu", shadow_sample=1)
    m0 = SHADOW_STATS.get("mismatch:mesh", 0)
    b0 = SHADOW_STATS.get("mismatch:bsi", 0)
    tfault.arm("device.exec", delta=5, kind="count-result")
    try:
        q = lambda s: e.execute("i", parse_string(s))[0]  # noqa: E731
        assert q("TopN(frame=general, n=2)") == [(1, 2), (2, 1)]
        assert q('Sum(frame=v, field="x")') == {"value": 12, "count": 2}
        assert SHADOW_STATS.get("mismatch:mesh", 0) == m0 + 1
        assert SHADOW_STATS.get("mismatch:bsi", 0) == b0 + 1
        assert e.stats["topn_host"] == 1
    finally:
        h.close()
