"""The commit barrier of a fragment's op log: group-commit durability.

A reduced copy of the JAX package's WAL engine (pilosa_tpu/core/wal.py).
A fragment's op log is the run of 13-byte records after the snapshot in
its roaring file (roaring/serialize.write_op). Each fragment owns one
WalCommitter, which is the Bitmap's `op_writer` and decides when an
accepted record is durable:

    never   unbuffered write-through, no fsync: an acknowledged bit
            survives the death of the process, not a power cut. A bare
            Holder keeps this, as the JAX package's bare Fragment does.
    group   records gather in a buffer; the first writer to wait on the
            barrier leads the commit: it sleeps the group window, then
            makes ONE write and ONE fsync for everything gathered, and
            wakes the group. set_bit / clear_bit return only after the
            commit that covers their record. The server's default.
    always  group with a zero window: every barrier fsyncs at once
            (still folding in whatever raced in).

No thread exists while nothing is written: the leader is always a
writer that had to wait anyway.

The committer is also what a background snapshot re-aims: the fragment
retargets it at the side `.wal` file while the frozen image is written,
and back at the main file when the side log is spliced in
(core/fragment.py).

Power-loss simulation: under group / always, records sit in the buffer
until their commit, so a SIGKILL at the `storage.fsync` seam (fault.py)
loses every unsynced op, as a power cut would. With
PILOSA_TORCH_WAL_SIM_POWER_LOSS=1 (or WalConfig(simulate_power_loss=
True)), `never` buffers its records too (written out only at a snapshot
flip or close), so a kill -9 is a power cut for that policy as well.

Stats (process-wide, read by /debug/vars): WAL_STATS counts fsyncs,
ops committed, torn tails cut, snapshots taken and failed, and
backpressure waits and sheds; GROUP_SIZE is the ops per commit and
SNAPSHOT_US the background snapshots' wall time.

Lock order: Fragment._mu -> WalCommitter._cv. `write` and `retarget`
are called with the fragment's lock held; `wait_durable` never is, so a
leader sleeping its window blocks neither readers nor other writers.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from .. import fault
from ..obs.costs import LEDGER
from ..obs.health import HEALTH
from ..obs.metrics import Histogram, StatMap

FSYNC_NEVER = "never"
FSYNC_GROUP = "group"
FSYNC_ALWAYS = "always"
FSYNC_POLICIES = (FSYNC_NEVER, FSYNC_GROUP, FSYNC_ALWAYS)

DEFAULT_GROUP_WINDOW_US = 250.0
DEFAULT_MAX_WAL_OPS = 65536
DEFAULT_BACKPRESSURE_DEADLINE = 1.0
SIM_POWER_LOSS_ENV = "PILOSA_TORCH_WAL_SIM_POWER_LOSS"

WAL_STATS = StatMap()
GROUP_SIZE = Histogram()   # ops per commit
SNAPSHOT_US = Histogram()  # background snapshot wall time, us


class WalConfig:
    """The storage config (the JAX server's [storage] knobs), threaded
    Holder -> Index -> Frame -> View -> Fragment: the fsync policy and
    its group window; max_op_n, the ops after which a fragment
    snapshots (None: fragment.MAX_OP_N); max_wal_ops, the ops not yet
    covered by a snapshot past which writers wait for one
    (backpressure; <= 0 never waits); backpressure_deadline, the seconds
    a writer waits before it is shed; simulate_power_loss (module
    docstring)."""

    __slots__ = ("fsync_policy", "group_window_us", "max_wal_ops",
                 "backpressure_deadline", "max_op_n", "simulate_power_loss")

    def __init__(self, fsync_policy: str = FSYNC_GROUP,
                 group_window_us: float = DEFAULT_GROUP_WINDOW_US,
                 max_wal_ops: int = DEFAULT_MAX_WAL_OPS,
                 backpressure_deadline: float = DEFAULT_BACKPRESSURE_DEADLINE,
                 max_op_n: Optional[int] = None,
                 simulate_power_loss: bool = False):
        if fsync_policy not in FSYNC_POLICIES:
            # A typo must not silently weaken durability to "never".
            raise ValueError(
                f"fsync-policy must be one of {FSYNC_POLICIES}, "
                f"got {fsync_policy!r}")
        self.fsync_policy = fsync_policy
        self.group_window_us = float(group_window_us)
        self.max_wal_ops = int(max_wal_ops)
        self.backpressure_deadline = float(backpressure_deadline)
        self.max_op_n = max_op_n
        self.simulate_power_loss = bool(
            simulate_power_loss or os.environ.get(SIM_POWER_LOSS_ENV))


class WalCommitter:
    """One fragment's commit barrier and op-record router. All state
    lives under one condition variable."""

    def __init__(self, cfg: WalConfig, path: str = "", stats=None):
        self.cfg = cfg
        self.path = path             # the fragment's, for the fault seam
        self.stats = stats           # the fragment's stats client
        self._cv = threading.Condition()
        self._target = None          # the unbuffered append file
        self._buf = bytearray()      # accepted, not yet written
        self._appended = 0           # ops accepted (seq of the newest)
        self._synced = 0             # ops durable under the policy
        self._leader = False         # a commit leader is in flight
        self.fsyncs = 0              # fsyncs made (commits and drains)
        self.committed_ops = 0       # ops those fsyncs covered

    def _syncs(self) -> bool:
        return self.cfg.fsync_policy != FSYNC_NEVER

    def _buffers(self) -> bool:
        return self._syncs() or self.cfg.simulate_power_loss

    # -- the op_writer protocol (under Fragment._mu) -------------------------

    def write(self, data: bytes) -> int:
        """Accept one op record (Bitmap.add / remove write one per op)."""
        with self._cv:
            if self._target is None:
                raise ValueError("WAL committer detached")
            if self._buffers():
                self._buf += data
            else:
                self._target.write(data)
            self._appended += 1
        # Writes arrive on the request thread: the ambient (tenant,
        # shape) account, or the system row, pays for its WAL bytes.
        LEDGER.charge("wal_bytes", len(data))
        return len(data)

    def seq(self) -> int:
        """The newest accepted op's sequence number: the token
        wait_durable takes."""
        with self._cv:
            return self._appended

    # -- lifecycle (under Fragment._mu) --------------------------------------

    def retarget(self, new_target) -> None:
        """Aim later records at `new_target` (open, snapshot). Buffered
        records drain into the old target first, with an fsync under a
        syncing policy, so no accepted seq is left behind the swap."""
        with self._cv:
            self._drain_locked()
            self._target = new_target

    def detach(self) -> None:
        """At close: drain, count everything durable (nothing more can
        commit) and wake every barrier waiter."""
        with self._cv:
            self._drain_locked()
            self._target = None
            self._synced = self._appended
            self._cv.notify_all()

    def flush(self) -> None:
        """Force buffered records to disk (fsync under the policy)."""
        with self._cv:
            self._drain_locked()

    def _drain_locked(self) -> None:
        if self._target is None:
            self._buf.clear()
            return
        if self._buf:
            self._target.write(bytes(self._buf))
            self._buf.clear()
        if self._syncs() and self._synced < self._appended:
            os.fsync(self._target.fileno())
            self.committed_ops += self._appended - self._synced
            self._synced = self._appended
            self.fsyncs += 1

    # -- the commit barrier (WITHOUT Fragment._mu) ---------------------------

    def wait_durable(self, seq: int) -> None:
        """Return once op `seq` is durable under the policy. Under
        `group` the first waiter leads: it sleeps the window, then one
        write and one fsync cover the whole group."""
        if seq <= 0 or not self._syncs():
            return
        window = (self.cfg.group_window_us / 1e6
                  if self.cfg.fsync_policy == FSYNC_GROUP else 0.0)
        while True:
            with self._cv:
                if self._synced >= seq:
                    return
                if not self._leader:
                    self._leader = True
                    break
                self._cv.wait(0.05)
        try:
            # The leader's turn (window, write, fsync) is one in-flight op
            # of the `wal` subsystem: a disk that stops answering fsync
            # wedges every writer behind it, the hang the watchdog sees.
            with HEALTH.inflight("wal", "commit", base=max(1.0, window * 4)):
                if window > 0:
                    time.sleep(window)
                self._commit()
        finally:
            with self._cv:
                self._leader = False
                self._cv.notify_all()

    def _commit(self) -> None:
        """One write and one fsync for everything accepted so far. The
        IO runs under _cv: appenders wait out the fsync (they would wait
        on the barrier right after anyway), and retarget() cannot swap
        the file under the write."""
        with self._cv:
            if self._target is None or self._synced >= self._appended:
                return
            batch = self._appended - self._synced
            # Before the write: a kill armed here loses every unsynced
            # op, the window a power cut opens.
            fault.point("storage.fsync", path=self.path, kind="commit",
                        pending=batch)
            if self._buf:
                self._target.write(bytes(self._buf))
                self._buf.clear()
            os.fsync(self._target.fileno())
            self.committed_ops += batch
            self._synced = self._appended
            self.fsyncs += 1
            WAL_STATS.inc("fsync")
            WAL_STATS.inc("group_ops", batch)
            GROUP_SIZE.observe(batch)
            if self.stats is not None:
                self.stats.count("wal_fsyncN", 1)
