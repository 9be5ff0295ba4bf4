"""The port's commit barrier (pilosa_tpu_torch/core/wal.py) against the
JAX package's.

The policy cases of the JAX package's own durability tests run on the
port's Fragment: group commit folds concurrent writers into fewer
fsyncs than writes, `always` fsyncs every barrier, `never` never does, a
bad policy is refused and a detach releases waiters. A write returns
only once a commit covers its record, and the barrier is never waited
on under the fragment's lock. The same seeded op sequence written under
each policy by either package reopens to the same bits in both, and the
mutation log each package keeps of it is the same. Exact: bits and
counts.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.core.fragment import Fragment as JaxFragment
from pilosa_tpu.core.wal import WalConfig as JaxWalConfig

from pilosa_tpu_torch.api.server import parse_args
from pilosa_tpu_torch.core import Fragment, Holder
from pilosa_tpu_torch.core.fragment import MAX_OP_N
from pilosa_tpu_torch.core.wal import (FSYNC_ALWAYS, FSYNC_GROUP,
                                       FSYNC_NEVER, FSYNC_POLICIES,
                                       WalCommitter, WalConfig)
from torch_threads import one_torch_thread  # noqa: F401


def _frag(tmp_path, name="0", **wal_kw):
    f = Fragment(str(tmp_path / name), "i", "f", "standard", 0,
                 wal=WalConfig(**wal_kw) if wal_kw else None)
    f.open()
    return f


def port_bits(path) -> set:
    f = Fragment(str(path), "i", "f", "standard", 0)
    f.open()
    try:
        v = f.storage.slice()
        return {(int(p) // SLICE_WIDTH, int(p) % SLICE_WIDTH) for p in v}
    finally:
        f.close()


def jax_bits(path) -> set:
    f = JaxFragment(str(path), "i", "f", "standard", 0)
    f.open()
    try:
        return set(f.for_each_bit())
    finally:
        f.close()


# -- the policies -----------------------------------------------------------


def test_group_coalesces_concurrent_writers(tmp_path):
    f = _frag(tmp_path, fsync_policy=FSYNC_GROUP, group_window_us=2000.0)
    n_threads, per = 8, 25
    errs = []

    def w(row):
        try:
            for i in range(per):
                assert f.set_bit(row, i)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    try:
        ts = [threading.Thread(target=w, args=(r,))
              for r in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs
        assert 1 <= f._wal.fsyncs < n_threads * per
        assert f._wal.committed_ops == n_threads * per
    finally:
        f.close()
    want = {(r, i) for r in range(n_threads) for i in range(per)}
    assert port_bits(tmp_path / "0") == want
    assert jax_bits(tmp_path / "0") == want


def test_always_fsyncs_every_barrier(tmp_path):
    f = _frag(tmp_path, fsync_policy=FSYNC_ALWAYS)
    try:
        for i in range(10):
            f.set_bit(0, i)
        assert f._wal.fsyncs == 10
    finally:
        f.close()


def test_never_policy_no_fsync(tmp_path):
    f = _frag(tmp_path, fsync_policy=FSYNC_NEVER)
    try:
        for i in range(10):
            f.set_bit(0, i)
        assert f._wal.fsyncs == 0
    finally:
        f.close()
    assert port_bits(tmp_path / "0") == {(0, i) for i in range(10)}


def test_bad_policy_rejected():
    with pytest.raises(ValueError, match="fsync-policy"):
        WalConfig(fsync_policy="allways")
    with pytest.raises(ValueError, match="fsync-policy"):
        JaxWalConfig(fsync_policy="allways")


def test_detach_releases_barrier_waiters(tmp_path):
    c = WalCommitter(WalConfig(fsync_policy=FSYNC_GROUP))
    with open(str(tmp_path / "wal"), "ab") as target:
        c.retarget(target)
        c.write(b"x" * 13)
        c.detach()
        c.wait_durable(1)  # must not hang
    with pytest.raises(ValueError, match="detached"):
        c.write(b"x" * 13)


def test_flush_writes_and_syncs_the_buffer(tmp_path):
    path = str(tmp_path / "wal")
    c = WalCommitter(WalConfig(fsync_policy=FSYNC_GROUP))
    with open(path, "ab", buffering=0) as target:
        c.retarget(target)
        c.write(b"y" * 13)
        c.write(b"z" * 13)
        assert os.path.getsize(path) == 0  # buffered for the group
        c.flush()
        assert os.path.getsize(path) == 26
        assert c.fsyncs == 1 and c.committed_ops == 2
        c.wait_durable(2)  # already covered: no second commit
        assert c.fsyncs == 1
        c.detach()


def test_group_commit_under_contention(tmp_path):
    """More writers than cores over two fragments, with the interpreter
    switching threads as often as it can: every write returns durable
    (a commit covers its seq), no op is lost or counted twice, and the
    files reopen to every bit."""
    fs = [_frag(tmp_path, name, fsync_policy=FSYNC_GROUP,
                group_window_us=200.0) for name in ("0", "1")]
    n_threads, per = 2 * (os.cpu_count() or 4), 12
    errs = []

    def w(k):
        f = fs[k % 2]
        try:
            for i in range(per):
                before = f._wal.seq()  # this write's seq is above it
                f.set_bit(k, i)
                if f._wal._synced <= before:
                    errs.append(("acknowledged before its commit", k, i))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=w, args=(k,)) for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
        for f in fs:
            f.close()
    assert not errs
    for j, f in enumerate(fs):
        assert f._wal.committed_ops == f._wal._appended == (
            n_threads // 2) * per
        assert f._wal.fsyncs < f._wal.committed_ops
        want = {(k, i) for k in range(j, n_threads, 2) for i in range(per)}
        assert port_bits(tmp_path / str(j)) == want


@pytest.mark.parametrize("policy", [FSYNC_GROUP, FSYNC_ALWAYS])
def test_write_returns_after_its_commit(tmp_path, policy):
    """set_bit / clear_bit return only once a commit covers their
    record: nothing accepted is left unsynced, and the record is on
    disk."""
    f = _frag(tmp_path, fsync_policy=policy)
    try:
        for i in range(5):
            f.set_bit(1, i)
            assert f._wal._synced == f._wal._appended == i + 1
            assert not f._wal._buf
        f.clear_bit(1, 0)
        assert f._wal._synced == f._wal._appended == 6
    finally:
        f.close()
    assert port_bits(tmp_path / "0") == {(1, i) for i in range(1, 5)}


def test_barrier_is_waited_outside_the_fragment_lock(tmp_path):
    """A leader sleeping a long window must not hold the fragment's lock:
    a reader and a second writer get through meanwhile, and both writes
    share the one commit."""
    f = _frag(tmp_path, fsync_policy=FSYNC_GROUP, group_window_us=300_000)
    try:
        t = threading.Thread(target=f.set_bit, args=(0, 1))
        t.start()
        time.sleep(0.05)  # the leader is asleep in its window
        t0 = time.monotonic()
        assert f.count() == 1
        assert time.monotonic() - t0 < 0.1
        f.set_bit(0, 2)  # joins the leader's group
        t.join()
        assert f._wal.fsyncs == 1 and f._wal.committed_ops == 2
    finally:
        f.close()


def test_snapshot_under_group_keeps_every_write(tmp_path):
    """Past MAX_OP_N ops the fragment snapshots; records buffered for the
    group drain into the old file, whose bits the snapshot holds."""
    f = _frag(tmp_path, fsync_policy=FSYNC_GROUP, group_window_us=0.0)
    try:
        for i in range(MAX_OP_N + 5):
            f.set_bit(2, i)
        assert f.op_n == 4
    finally:
        f.close()
    want = {(2, i) for i in range(MAX_OP_N + 5)}
    assert port_bits(tmp_path / "0") == want == jax_bits(tmp_path / "0")


# -- the policy's path from the server to the fragments ----------------------


def test_holder_threads_the_policy_to_every_fragment(tmp_path):
    bare = Holder(str(tmp_path / "bare"))
    bare.open()
    served = Holder(str(tmp_path / "served"),
                    wal=WalConfig(FSYNC_GROUP, group_window_us=0.0))
    served.open()
    try:
        for h in (bare, served):
            f = h.create_index_if_not_exists("i").create_frame_if_not_exists(
                "f", inverse_enabled=True)
            f.set_bit(1, 2)
            f.set_bit(1, 3 * SLICE_WIDTH + 4)
        frags = [v.fragments[s] for v in bare.frame("i", "f").views.values()
                 for s in v.fragments]
        assert frags and all(fr._wal.cfg.fsync_policy == FSYNC_NEVER
                             and fr._wal.fsyncs == 0 for fr in frags)
        frags = [v.fragments[s]
                 for v in served.frame("i", "f").views.values()
                 for s in v.fragments]
        # standard: slices 0 and 3; inverse: both writes in slice 0.
        assert len(frags) == 3
        assert all(fr._wal.cfg.fsync_policy == FSYNC_GROUP
                   and fr._wal.fsyncs == fr._wal.committed_ops >= 1
                   for fr in frags)
    finally:
        bare.close()
        served.close()
    # A reopened holder keeps its policy for the fragments it opens.
    h = Holder(str(tmp_path / "served"), wal=WalConfig(FSYNC_ALWAYS))
    h.open()
    try:
        fr = h.fragment("i", "f", "standard", 0)
        assert fr._wal.cfg.fsync_policy == FSYNC_ALWAYS
        fr.set_bit(5, 6)
        assert fr._wal.fsyncs == 1
    finally:
        h.close()


def test_server_flag_defaults_to_group():
    assert parse_args(["-d", "x"]).fsync_policy == FSYNC_GROUP
    for p in FSYNC_POLICIES:
        assert parse_args(["-d", "x", "--fsync-policy", p]).fsync_policy == p
    with pytest.raises(SystemExit):
        parse_args(["-d", "x", "--fsync-policy", "sometimes"])


# -- the same ops through both packages --------------------------------------


def op_sequence(seed: int, n: int = 400):
    """Seeded sets and clears over 3 rows x 3 containers, with repeats,
    clears of absent bits, and a container emptied and refilled."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        row = int(rng.integers(0, 3))
        col = int(rng.integers(0, 3)) * 65536 + int(rng.integers(0, 40))
        ops.append((int(rng.random() < 0.35), row, col))
    ops += [(0, 7, 5), (1, 7, 5), (0, 7, 6)]
    return ops


def apply_ops(frag, ops):
    return [frag.clear_bit(r, c) if op else frag.set_bit(r, c)
            for op, r, c in ops]


@pytest.mark.parametrize("policy", FSYNC_POLICIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_same_ops_reopen_to_the_same_bits(tmp_path, policy, seed):
    ops = op_sequence(seed)
    cfg = dict(fsync_policy=policy, group_window_us=0.0)
    pf = Fragment(str(tmp_path / "port"), "i", "f", "standard", 0,
                  wal=WalConfig(**cfg))
    jf = JaxFragment(str(tmp_path / "jax"), "i", "f", "standard", 0,
                     wal=JaxWalConfig(**cfg))
    pf.open()
    jf.open()
    try:
        assert apply_ops(pf, ops) == apply_ops(jf, ops)
        # The mutation log: (op, pos, churn) per write, the same in both.
        assert pf.log_since(0) == jf.log_since(0)
        assert pf.generation == jf.generation == len(ops)
        if policy != FSYNC_NEVER:
            assert pf._wal.fsyncs == jf._wal.fsyncs == len(ops)
    finally:
        pf.close()
        jf.close()
    want = jax_bits(tmp_path / "jax")
    assert want and port_bits(tmp_path / "port") == want
    assert jax_bits(tmp_path / "port") == port_bits(tmp_path / "jax") == want
