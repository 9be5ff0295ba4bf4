"""Fragment: the storage unit for one (frame, view, slice).

A reduced copy of the JAX package's Fragment: the roaring file (a
snapshot region followed by an op log, rewritten by temp + rename every
MAX_OP_N ops), an exclusive flock, per-bit writes behind the commit
barrier of its WAL policy (core/wal.py), bulk import, row
materialization, the mutation `generation` and log the device stager
reads to bring its image up to date (parallel/serve.py scatters the
logged bits into it, or restages the view), and the rank cache of row
counts behind the host TopN (`top`), kept in `<fragment>.cache` as the
JAX package keeps it.

Bit addressing: pos = rowID * SLICE_WIDTH + (columnID % SLICE_WIDTH).
"""

from __future__ import annotations

import bisect
import fcntl
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import SLICE_WIDTH
from ..roaring import Bitmap
from .cache import CACHE_TYPE_RANKED, DEFAULT_CACHE_SIZE, new_cache, \
    sort_pairs
from .row import Row
from .wal import FSYNC_NEVER, WalCommitter, WalConfig

# Snapshot after this many logged ops.
MAX_OP_N = 2000


class _MutationEpoch:
    """Process-wide count of data mutations, fragment creations and index
    or frame deletions: while it stands still, no staged image can be
    stale, and the stager skips its per-slice generation walk."""

    def __init__(self):
        self.n = 0
        self._mu = threading.Lock()

    def bump(self):
        with self._mu:
            self.n += 1


MUTATION_EPOCH = _MutationEpoch()


class TopOptions:
    """Options of Fragment.top, the host TopN of one slice."""

    def __init__(self, n=0, src=None, row_ids=None, min_threshold=0,
                 filter_field="", filter_values=None, tanimoto_threshold=0):
        self.n = n
        self.src = src  # Row, or None
        self.row_ids = row_ids or []
        self.min_threshold = min_threshold
        self.filter_field = filter_field
        self.filter_values = filter_values or []
        self.tanimoto_threshold = tanimoto_threshold


class Fragment:
    """One (frame, view, slice) of data."""

    def __init__(self, path: str, index: str, frame: str, view: str,
                 slice_: int, cache_type: str = CACHE_TYPE_RANKED,
                 cache_size: int = DEFAULT_CACHE_SIZE,
                 row_attr_store=None, wal: Optional[WalConfig] = None):
        self.path = path
        self.index = index
        self.frame = frame
        self.view = view
        self.slice = slice_
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.cache = new_cache(cache_type, cache_size)
        self.row_attr_store = row_attr_store
        self._mu = threading.RLock()
        self.storage = Bitmap()
        self.op_n = 0
        # The durability policy: a bare Fragment writes through without
        # fsync, as the JAX package's does; servers pass their policy.
        self._wal = WalCommitter(wal if wal is not None
                                 else WalConfig(FSYNC_NEVER))
        # The mutation log the stager reads (log_since): one (op 0 = set
        # / 1 = clear, pos, churn) per write, churn when the write added
        # or removed a container (a scatter cannot add or drop a slot).
        # `generation` counts writes; a reset (import, replace) moves it
        # past every logged entry, so every consumer restages.
        self.generation = 0
        self._log: List[Tuple[int, int, bool]] = []
        self._log_base = 0
        self._log_limit = 8192
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
            self._wal.retarget(self._op_file)
            self.storage.op_writer = self._wal
            self._load_cache()

    @property
    def cache_path(self) -> str:
        return self.path + ".cache"

    def close(self):
        with self._mu:
            self.flush_cache()
            self._wal.detach()
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

    def row_count(self, row_id: int) -> int:
        """Bits set in one row, from its containers' cardinalities."""
        with self._mu:
            keys = self.storage.keys
            lo = bisect.bisect_left(keys, row_id * 16)
            hi = bisect.bisect_left(keys, row_id * 16 + 16)
            return sum(self.storage.containers[i].n for i in range(lo, hi))

    def row_counts(self) -> Dict[int, int]:
        """{row id: bits set} over every row with a container, in one
        pass over the containers."""
        with self._mu:
            keys = np.asarray(self.storage.keys, dtype=np.int64)
            ns = np.fromiter((c.n for c in self.storage.containers),
                             dtype=np.int64, count=len(keys))
        rows, inv = np.unique(keys >> 4, return_inverse=True)
        sums = np.bincount(inv, weights=ns, minlength=len(rows))
        return dict(zip(rows.tolist(), sums.astype(np.int64).tolist()))

    # -- writes ------------------------------------------------------------

    def _pos(self, row_id: int, column_id: int) -> int:
        return row_id * SLICE_WIDTH + (column_id % SLICE_WIDTH)

    def set_bit(self, row_id: int, column_id: int) -> bool:
        """Set a bit, logging the op; returns once the op record is
        durable under the WAL policy. True if it was newly set."""
        with self._mu:
            pos = self._pos(row_id, column_id)
            churn = self.storage._find_key(pos >> 16) < 0
            changed = self.storage.add(pos)
            seq = self._wal.seq()
            self._log_append(0, pos, churn)
            if changed:
                self.cache.add(row_id, self.row_count(row_id))
            self._count_op()
        self._wal.wait_durable(seq)
        return changed

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        with self._mu:
            pos = self._pos(row_id, column_id)
            changed = self.storage.remove(pos)
            seq = self._wal.seq()
            churn = changed and self.storage._find_key(pos >> 16) < 0
            self._log_append(1, pos, churn)
            if changed:
                self.cache.add(row_id, self.row_count(row_id))
            self._count_op()
        self._wal.wait_durable(seq)
        return changed

    def _count_op(self):
        self.op_n += 1
        if self.op_n > MAX_OP_N:
            self.snapshot()

    # -- the mutation log ------------------------------------------------------

    def _log_append(self, op: int, pos: int, churn: bool):
        self.generation += 1
        MUTATION_EPOCH.bump()
        self._log.append((op, pos, churn))
        if len(self._log) > self._log_limit:
            drop = len(self._log) - self._log_limit
            del self._log[:drop]
            self._log_base += drop

    def _log_reset(self):
        """A whole-storage change (import, replace): consumers at any
        earlier generation must restage."""
        self.generation += 1
        MUTATION_EPOCH.bump()
        self._log.clear()
        self._log_base = self.generation

    def log_since(self, gen: int) -> Optional[List[Tuple[int, int, bool]]]:
        """The writes after generation `gen`, or None when the log no
        longer reaches back that far (pruned or reset: restage)."""
        with self._mu:
            if gen < self._log_base or gen > self.generation:
                return None
            return self._log[gen - self._log_base:]

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
            counts = self.row_counts()
            for r in np.unique(rows).tolist():
                self.cache.bulk_add(r, counts.get(r, 0))
            self.cache.invalidate()
            self._log_reset()
            self.snapshot()

    def replace(self, bitmap: Bitmap):
        """Swap in a whole storage image. It lives in memory until the
        next snapshot() writes it out (bulk loaders that would take
        hours through per-bit writes)."""
        with self._mu:
            bitmap.op_writer = self._wal
            self.storage = bitmap
            self.cache = new_cache(self.cache_type, self.cache_size)
            self.rebuild_cache()
            self._log_reset()

    def snapshot(self):
        """Rewrite the file as a bare snapshot (temp + rename) and
        restart the op log after it. Buffered op records drain into the
        old file (the snapshot already holds their bits)."""
        with self._mu:
            tmp = self.path + ".snapshotting"
            with open(tmp, "wb") as f:
                self.storage.write_to(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            old, self._op_file = self._op_file, open(self.path, "ab",
                                                     buffering=0)
            self._wal.retarget(self._op_file)
            if old is not None:
                old.close()
            self.storage.op_writer = self._wal
            self.op_n = 0

    # -- the rank cache --------------------------------------------------------

    def flush_cache(self):
        """Write the cache's pairs to `<fragment>.cache` (JSON [[id, n],
        ...], temp + rename), as the JAX package does."""
        with self._mu:
            pairs = self.cache.top() or [(i, self.cache.get(i))
                                         for i in self.cache.ids()]
            tmp = self.cache_path + ".tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump([[int(i), int(n)] for i, n in pairs], f)
                os.replace(tmp, self.cache_path)
            except OSError:
                pass

    def _load_cache(self):
        """Fill the cache from `<fragment>.cache`, recounting each listed
        row from storage; rebuild it from storage when the file is
        missing or unreadable."""
        try:
            with open(self.cache_path) as f:
                pairs = json.load(f)
        except (OSError, ValueError):
            self.rebuild_cache()
            return
        counts = self.row_counts()
        for id_, _n in pairs:
            self.cache.bulk_add(int(id_), counts.get(int(id_), 0))
        self.cache.recalculate()

    def rebuild_cache(self):
        """Recount every row with a container into the cache."""
        with self._mu:
            counts = self.row_counts()
            for r, n in counts.items():
                self.cache.bulk_add(r, n)
            if counts:
                self.cache.recalculate()

    # -- TopN ----------------------------------------------------------------

    def _top_pairs(self, row_ids: Sequence[int]) -> List[Tuple[int, int]]:
        """The rank cache's pairs when no ids are asked for; otherwise
        each asked row recounted from storage, zeros dropped, sorted."""
        if not row_ids:
            return self.cache.top()
        pairs = [(r, self.row_count(r)) for r in row_ids]
        return sort_pairs([(r, n) for r, n in pairs if n > 0])

    def top(self, opt: TopOptions) -> List[Tuple[int, int]]:
        """Top rows by count in this slice: the rank cache's candidates
        (or opt.row_ids recounted), filtered by the threshold, the row
        attrs and the Tanimoto band, and recounted against opt.src."""
        with self._mu:
            return self._top(opt)

    def _top(self, opt: TopOptions) -> List[Tuple[int, int]]:
        pairs = self._top_pairs(opt.row_ids)
        n = 0 if opt.row_ids else opt.n
        filters = (set(opt.filter_values)
                   if opt.filter_field and opt.filter_values else None)
        tanimoto = 0
        min_tan = max_tan = 0.0
        src_count = 0
        if opt.tanimoto_threshold > 0 and opt.src is not None:
            tanimoto = opt.tanimoto_threshold
            src_count = opt.src.count()
            min_tan = src_count * tanimoto / 100.0
            max_tan = src_count * 100.0 / tanimoto

        results: List[Tuple[int, int]] = []  # sorted by count desc, id asc

        def push(pair):
            bisect.insort(results, pair, key=lambda p: (-p[1], p[0]))

        for row_id, cnt in pairs:
            if cnt <= 0:
                continue
            if tanimoto > 0:
                if cnt <= min_tan or cnt >= max_tan:
                    continue
            elif cnt < opt.min_threshold:
                continue
            if filters is not None:
                if self.row_attr_store is None:
                    continue
                attr = self.row_attr_store.attrs(row_id)
                if not attr or attr.get(opt.filter_field) not in filters:
                    continue
            if n == 0 or len(results) < n:
                count = cnt
                if opt.src is not None:
                    count = opt.src.intersection_count(self.row(row_id))
                if count == 0:
                    continue
                if tanimoto > 0:
                    t = -(-100 * count // (cnt + src_count - count))  # ceil
                    if t <= tanimoto:
                        continue
                elif count < opt.min_threshold:
                    continue
                push((row_id, count))
                if n > 0 and len(results) == n and opt.src is None:
                    break
                continue
            threshold = results[-1][1]
            if threshold < opt.min_threshold or cnt < threshold:
                break
            count = opt.src.intersection_count(self.row(row_id))
            if count < threshold:
                continue
            push((row_id, count))
            results[:] = results[:n] if n else results
        return results[:n] if n else results
