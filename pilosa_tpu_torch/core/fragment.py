"""Fragment: the storage unit for one (frame, view, slice).

A reduced copy of the JAX package's Fragment: the roaring file (a
snapshot region followed by an op log, rewritten by temp + rename every
MAX_OP_N ops), an exclusive flock, per-bit writes, bulk import, row
materialization, and the mutation `generation` the device stager reads
to know when its image went stale (parallel/serve.py restages the view).

Bit addressing: pos = rowID * SLICE_WIDTH + (columnID % SLICE_WIDTH).
"""

from __future__ import annotations

import fcntl
import os
import threading
from typing import Sequence

import numpy as np

from .. import SLICE_WIDTH
from ..roaring import Bitmap
from .row import Row

# Snapshot after this many logged ops.
MAX_OP_N = 2000


class _MutationEpoch:
    """Process-wide count of data mutations and fragment creations:
    while it stands still, no staged image can be stale, and the stager
    skips its per-slice generation walk."""

    def __init__(self):
        self.n = 0
        self._mu = threading.Lock()

    def bump(self):
        with self._mu:
            self.n += 1


MUTATION_EPOCH = _MutationEpoch()


class Fragment:
    """One (frame, view, slice) of data."""

    def __init__(self, path: str, index: str, frame: str, view: str,
                 slice_: int):
        self.path = path
        self.index = index
        self.frame = frame
        self.view = view
        self.slice = slice_
        self._mu = threading.RLock()
        self.storage = Bitmap()
        self.op_n = 0
        # Bumped by every mutation; the stager compares it with the
        # generation it staged at.
        self.generation = 0
        self._op_file = None
        self._lock_file = None

    def open(self):
        with self._mu:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._lock_file = open(self.path + ".lock", "w")
            try:
                fcntl.flock(self._lock_file, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                self._lock_file.close()
                self._lock_file = None
                raise RuntimeError(
                    f"fragment locked by another process: {self.path}")
            if os.path.exists(self.path) and os.path.getsize(self.path):
                with open(self.path, "rb") as f:
                    self.storage = Bitmap.from_bytes(f.read())
                self.op_n = self.storage.op_n
            else:
                with open(self.path, "wb") as f:
                    self.storage.write_to(f)
            self._op_file = open(self.path, "ab", buffering=0)
            self.storage.op_writer = self._op_file

    def close(self):
        with self._mu:
            self.storage.op_writer = None
            if self._op_file is not None:
                self._op_file.close()
                self._op_file = None
            if self._lock_file is not None:
                fcntl.flock(self._lock_file, fcntl.LOCK_UN)
                self._lock_file.close()
                self._lock_file = None

    # -- reads -------------------------------------------------------------

    def row(self, row_id: int) -> Row:
        """Materialize one row as a slice-local segment."""
        with self._mu:
            seg = self.storage.offset_range(
                0, row_id * SLICE_WIDTH, (row_id + 1) * SLICE_WIDTH)
        return Row.from_segment(self.slice, seg)

    def count(self) -> int:
        with self._mu:
            return self.storage.count()

    # -- writes ------------------------------------------------------------

    def _pos(self, row_id: int, column_id: int) -> int:
        return row_id * SLICE_WIDTH + (column_id % SLICE_WIDTH)

    def set_bit(self, row_id: int, column_id: int) -> bool:
        """Set a bit, logging the op. True if it was newly set."""
        with self._mu:
            changed = self.storage.add(self._pos(row_id, column_id))
            self._mutated()
            return changed

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        with self._mu:
            changed = self.storage.remove(self._pos(row_id, column_id))
            self._mutated()
            return changed

    def _bump(self):
        self.generation += 1
        MUTATION_EPOCH.bump()

    def _mutated(self):
        self._bump()
        self.op_n += 1
        if self.op_n > MAX_OP_N:
            self.snapshot()

    def import_bits(self, row_ids: Sequence[int],
                    column_ids: Sequence[int]):
        """Bulk import: unlogged adds, then a snapshot."""
        rows = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(column_ids, dtype=np.uint64)
        if rows.shape != cols.shape:
            raise ValueError("row/column mismatch")
        pos = rows * np.uint64(SLICE_WIDTH) + cols % np.uint64(SLICE_WIDTH)
        with self._mu:
            self.storage.add_many(pos)
            self._bump()
            self.snapshot()

    def replace(self, bitmap: Bitmap):
        """Swap in a whole storage image. It lives in memory until the
        next snapshot() writes it out (bulk loaders that would take
        hours through per-bit writes)."""
        with self._mu:
            bitmap.op_writer = self._op_file
            self.storage = bitmap
            self._bump()

    def snapshot(self):
        """Rewrite the file as a bare snapshot (temp + rename) and
        restart the op log after it."""
        with self._mu:
            tmp = self.path + ".snapshotting"
            with open(tmp, "wb") as f:
                self.storage.write_to(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            if self._op_file is not None:
                self._op_file.close()
            self._op_file = open(self.path, "ab", buffering=0)
            self.storage.op_writer = self._op_file
            self.op_n = 0
