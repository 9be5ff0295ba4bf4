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

Lock order: Fragment._mu -> WalCommitter._cv. `write` and `retarget`
are called with the fragment's lock held; `wait_durable` never is, so a
leader sleeping its window blocks neither readers nor other writers.
"""

from __future__ import annotations

import os
import threading
import time

FSYNC_NEVER = "never"
FSYNC_GROUP = "group"
FSYNC_ALWAYS = "always"
FSYNC_POLICIES = (FSYNC_NEVER, FSYNC_GROUP, FSYNC_ALWAYS)

DEFAULT_GROUP_WINDOW_US = 250.0


class WalConfig:
    """The durability policy, threaded Holder -> Index -> Frame -> View
    -> Fragment."""

    __slots__ = ("fsync_policy", "group_window_us")

    def __init__(self, fsync_policy: str = FSYNC_GROUP,
                 group_window_us: float = DEFAULT_GROUP_WINDOW_US):
        if fsync_policy not in FSYNC_POLICIES:
            # A typo must not silently weaken durability to "never".
            raise ValueError(
                f"fsync-policy must be one of {FSYNC_POLICIES}, "
                f"got {fsync_policy!r}")
        self.fsync_policy = fsync_policy
        self.group_window_us = float(group_window_us)


class WalCommitter:
    """One fragment's commit barrier and op-record router. All state
    lives under one condition variable."""

    def __init__(self, cfg: WalConfig):
        self.cfg = cfg
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

    # -- the op_writer protocol (under Fragment._mu) -------------------------

    def write(self, data: bytes) -> int:
        """Accept one op record (Bitmap.add / remove write one per op)."""
        with self._cv:
            if self._target is None:
                raise ValueError("WAL committer detached")
            if self._syncs():
                self._buf += data
            else:
                self._target.write(data)
            self._appended += 1
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
            if self._buf:
                self._target.write(bytes(self._buf))
                self._buf.clear()
            os.fsync(self._target.fileno())
            self.committed_ops += self._appended - self._synced
            self._synced = self._appended
            self.fsyncs += 1
