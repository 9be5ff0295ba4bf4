"""Fragment: the storage unit for one (frame, view, slice).

A reduced copy of the JAX package's Fragment: the roaring file (a
snapshot region with its integrity footer, followed by an op log), an
exclusive flock, per-bit writes behind the commit barrier of its WAL
policy (core/wal.py), bulk import, row materialization, the mutation
`generation` and log the device stager reads to bring its image up to
date (parallel/serve.py scatters the logged bits into it, or restages
the view), the rank cache of row counts behind the host TopN (`top`),
kept in `<fragment>.cache` as the JAX package keeps it, the 100-row
block checksums (`blocks`, `block_data`), the bits in position order
(`bits`, `for_each_bit`: export) and the tar of a backup
(`write_to_tar`, `read_from_tar`).

Durability and integrity (pilosa_tpu/core/fragment.py:375-1090):
- Lazy load: `open(lazy=True)` (the holder's directory scan) takes the
  flock and parses the file on first touch (`ensure_loaded`). A file
  that fails verification (its footer, or a damaged op record in the
  middle of the log) raises CorruptFragmentError on every touch and
  stays in place; the other fragments serve on.
- A crash mid-append leaves a torn final op record: load cuts it off
  the file before it attaches the append fd (WAL_STATS `torn_tails`).
- Snapshots run in the background: past max_op_n ops a writer only
  flips the committer to a side `<fragment>.wal` file and freezes a
  copy-on-write view of the bitmap (`_start_snapshot`); a worker writes
  the view with its footer to a temp file, fsyncs and renames it, and
  the side log is then spliced into the new main file (or back into the
  old one when the attempt failed) and unlinked. Load replays a side
  log a crash left. A snapshot moves neither `generation` nor the
  mutation log: the staged image stays valid.
- Backpressure: while the ops not covered by a snapshot pass
  max_wal_ops, writers wait outside the lock for a snapshot to land, and
  are shed with WriteBackpressureError after the deadline.
- `op_n` counts the ops written since the newest snapshot's freeze
  (the main file's op log, or the side log while a snapshot runs).

Bit addressing: pos = rowID * SLICE_WIDTH + (columnID % SLICE_WIDTH).
"""

from __future__ import annotations

import bisect
import fcntl
import hashlib
import io
import json
import os
import tarfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import SLICE_WIDTH, fault
from ..errors import CorruptFragmentError, WriteBackpressureError
from ..roaring import Bitmap
from ..roaring.serialize import CorruptSnapshotError, scan_ops
from ..stats import StatMap
from .cache import CACHE_TYPE_RANKED, DEFAULT_CACHE_SIZE, new_cache, \
    sort_pairs
from .row import Row
from .wal import FSYNC_NEVER, SNAPSHOT_US, WAL_STATS, WalCommitter, \
    WalConfig

# Snapshot after this many logged ops (the default of WalConfig.max_op_n).
MAX_OP_N = 2000

# Rows per checksummed block (the reference's HashBlockSize).
HASH_BLOCK_SIZE = 100

# Corrupt loads found (`corrupt`) and left in place (`unrepaired`).
INTEGRITY_STATS = StatMap()


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


def bitmap_block_checksums(bm: Bitmap) -> Dict[int, bytes]:
    """{block id: SHA-1 of the block's values as little-endian u64} over
    every non-empty 100-row block of a bitmap: what Fragment.blocks()
    serves, computable on a parsed file."""
    out: Dict[int, bytes] = {}
    span = HASH_BLOCK_SIZE * SLICE_WIDTH
    for blk in sorted({int(k) // (span >> 16) for k in bm.keys}):
        vals = bm.slice_range(blk * span, (blk + 1) * span)
        if len(vals):
            out[blk] = hashlib.sha1(vals.astype("<u8").tobytes()).digest()
    return out


def _parse_tar_data(data: bytes) -> Bitmap:
    """A tar's `data` member, accepted whether or not its footer matches
    (the JAX package parses it without verifying). When the footer's
    region CRC matches, its container hashes are kept, as a verified
    load keeps them, so the restore's snapshot rehashes nothing; when it
    does not, the bytes load as they are and the snapshot hashes them
    anew."""
    try:
        return Bitmap.from_bytes(data, verify=True)
    except CorruptSnapshotError:
        return Bitmap.from_bytes(data)


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
        self._storage = Bitmap()
        self.op_n = 0
        # The storage config: a bare Fragment writes through without
        # fsync, as the JAX package's does; servers pass their policy.
        self.wal_cfg = wal if wal is not None else WalConfig(FSYNC_NEVER)
        self.max_op_n = self.wal_cfg.max_op_n or MAX_OP_N
        self._wal = WalCommitter(self.wal_cfg, path=path)
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
        # Lazy load: parsed on first touch; _loading breaks the re-entry
        # of the load's own reads.
        self._pending_load = True
        self._loading = False
        # The background snapshot: _snap_gen counts finished attempts
        # (ok or failed), so a forced snapshot can wait for one that
        # started after its caller's state.
        self._snapshotting = False
        self._snap_thread: Optional[threading.Thread] = None
        self._snap_done = threading.Event()
        self._snap_done.set()
        self._snap_gen = 0
        self._snap_err: Optional[BaseException] = None
        self._snap_base_op_n = 0
        self._side_file = None
        self._resnap = False
        self._last_snapshot_s = 0.0
        # blocks() memo, by generation.
        self._blocks_gen = -1
        self._blocks: List[Tuple[int, bytes]] = []
        # Wall-clock time of the scrubber's last pass over this fragment.
        self.last_scrub = 0.0

    @property
    def storage(self) -> Bitmap:
        """The bitmap, parsed from the file on first touch."""
        if self._pending_load:
            with self._mu:
                self.ensure_loaded()
        return self._storage

    @storage.setter
    def storage(self, bm: Bitmap) -> None:
        self._storage = bm

    @property
    def side_wal_path(self) -> str:
        return self.path + ".wal"

    @property
    def _tmp_path(self) -> str:
        return self.path + ".snapshotting"

    # -- lifecycle -----------------------------------------------------------

    def open(self, lazy: bool = False):
        """Take the flock; parse the file now, or on first touch when
        `lazy` and the file holds data."""
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
            self._pending_load = True
            if lazy and os.path.exists(self.path) \
                    and os.path.getsize(self.path):
                return
            self.ensure_loaded()

    def ensure_loaded(self):
        """Parse the file, attach the WAL and load the rank cache, once.
        Call under _mu. `_pending_load` clears only on success: a corrupt
        file raises CorruptFragmentError on every touch and never leaves
        the fragment looking loaded but empty, which would take writes
        and then snapshot the empty image over the real data."""
        if not self._pending_load or self._loading:
            return
        self._loading = True
        try:
            try:
                self._load_storage()
            except ValueError as err:
                self._storage = Bitmap()
                self.op_n = 0
                INTEGRITY_STATS.inc("corrupt")
                INTEGRITY_STATS.inc("unrepaired")
                raise CorruptFragmentError(
                    f"fragment {self.index}/{self.frame}/{self.view}/"
                    f"{self.slice} is corrupt ({self.path}): {err}") from err
            self._load_cache()
            self._pending_load = False
        finally:
            self._loading = False

    def _load_storage(self):
        """Read, verify and parse the file (cutting a torn tail off it),
        attach the append fd and replay a side log a crash left. Raises
        ValueError (a CorruptSnapshotError for a rotted footer or region)
        with no append fd attached."""
        self._detach_op_file()
        if os.path.exists(self.path) and os.path.getsize(self.path):
            with open(self.path, "rb") as f:
                data = f.read()
            data = fault.corrupt("storage.corrupt", data, path=self.path,
                                 kind="snapshot")
            bm = Bitmap.from_bytes(data, truncate_torn_tail=True,
                                   verify=True)
            if bm.torn_tail_bytes:
                # A crash mid-append: the acked prefix is whole. Cut the
                # tail before appending, or the next load would find the
                # damaged record mid-log and refuse the file.
                WAL_STATS.inc("torn_tails")
                os.truncate(self.path, len(data) - bm.torn_tail_bytes)
            self._storage = bm
            self.op_n = bm.op_n
        else:
            self._storage = Bitmap()
            self.op_n = 0
            with open(self.path, "wb") as f:
                self._storage.write_to(f, footer=True)
        self._op_file = open(self.path, "ab", buffering=0)
        self._wal.retarget(self._op_file)
        self._storage.op_writer = self._wal
        try:
            self._replay_side_wal()
        except ValueError:
            self._detach_op_file()
            raise

    def _detach_op_file(self):
        self._storage.op_writer = None
        if self._op_file is not None:
            self._wal.detach()
            self._op_file.close()
            self._op_file = None

    def _replay_side_wal(self):
        """Recover a background snapshot that a crash cut short: a
        leftover side log holds every op accepted after its freeze.
        Replay it onto the loaded image and append its bytes to the main
        file (fsynced before the unlink). Ops are absolute positions, so
        the replay is idempotent over the old file (no rename) and the
        renamed snapshot alike."""
        if os.path.exists(self._tmp_path):
            os.unlink(self._tmp_path)  # a temp that was never renamed
        if not os.path.exists(self.side_wal_path):
            return
        with open(self.side_wal_path, "rb") as f:
            data = f.read()
        data = fault.corrupt("storage.corrupt", data,
                             path=self.side_wal_path, kind="side-wal")
        ops, valid, torn = scan_ops(data)
        if torn:
            WAL_STATS.inc("torn_tails")
        for typ, value in ops:
            if typ == 0:
                self._storage._add_one(value)
            else:
                self._storage._remove_one(value)
        if valid:
            self._op_file.write(data[:valid])
            os.fsync(self._op_file.fileno())
        os.unlink(self.side_wal_path)
        self.op_n += len(ops)

    @property
    def cache_path(self) -> str:
        return self.path + ".cache"

    def close(self):
        # Let a snapshot in flight (and one chained behind it) land
        # first; joined outside _mu, which its splice takes.
        while True:
            with self._mu:
                t = self._snap_thread if self._snapshotting else None
            if t is None:
                break
            t.join()
        with self._mu:
            self.flush_cache()
            self._wal.detach()
            self._storage.op_writer = None
            if self._op_file is not None:
                self._op_file.close()
                self._op_file = None
            if self._lock_file is not None:
                fcntl.flock(self._lock_file, fcntl.LOCK_UN)
                self._lock_file.close()
                self._lock_file = None
            # A reopen parses again and reattaches the WAL.
            self._pending_load = True

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
            st = self.storage
            lo = bisect.bisect_left(st.keys, row_id * 16)
            hi = bisect.bisect_left(st.keys, row_id * 16 + 16)
            return sum(st.containers[i].n for i in range(lo, hi))

    def row_counts(self) -> Dict[int, int]:
        """{row id: bits set} over every row with a container, in one
        pass over the containers."""
        with self._mu:
            st = self.storage
            keys = np.asarray(st.keys, dtype=np.int64)
            ns = np.fromiter((c.n for c in st.containers),
                             dtype=np.int64, count=len(keys))
        rows, inv = np.unique(keys >> 4, return_inverse=True)
        sums = np.bincount(inv, weights=ns, minlength=len(rows))
        return dict(zip(rows.tolist(), sums.astype(np.int64).tolist()))

    def blocks(self) -> List[Tuple[int, bytes]]:
        """[(block id, SHA-1)] of every non-empty 100-row block (the
        JAX package's digests), memoized by generation: what the
        scrubber diffs a parsed file against."""
        with self._mu:
            st = self.storage
            if self._blocks_gen != self.generation:
                self._blocks = sorted(bitmap_block_checksums(st).items())
                self._blocks_gen = self.generation
            return list(self._blocks)

    def checksum(self) -> bytes:
        """SHA-1 over the block checksums."""
        h = hashlib.sha1()
        for _, c in self.blocks():
            h.update(c)
        return h.digest()

    def bits(self) -> Tuple[np.ndarray, np.ndarray]:
        """(row ids, absolute column ids) of every bit, as uint64 arrays
        in position order (row, then column): for_each_bit's pairs."""
        with self._mu:
            positions = self.storage.slice()
        width = np.uint64(SLICE_WIDTH)
        return (positions // width,
                np.uint64(self.slice * SLICE_WIDTH) + positions % width)

    def for_each_bit(self):
        """Yield (rowID, absolute columnID) of every bit, as the JAX
        package's does; the positions are read under the lock first."""
        rows, cols = self.bits()
        yield from zip(rows.tolist(), cols.tolist())

    def block_data(self, block_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(row ids, slice-local column ids) of one 100-row block."""
        lo = block_id * HASH_BLOCK_SIZE * SLICE_WIDTH
        with self._mu:
            vals = self.storage.slice_range(
                lo, lo + HASH_BLOCK_SIZE * SLICE_WIDTH)
        width = np.uint64(SLICE_WIDTH)
        return vals // width, vals % width

    # -- writes ------------------------------------------------------------

    def _pos(self, row_id: int, column_id: int) -> int:
        return row_id * SLICE_WIDTH + (column_id % SLICE_WIDTH)

    def set_bit(self, row_id: int, column_id: int,
                deadline: Optional[float] = None) -> bool:
        """Set a bit, logging the op; returns once the op record is
        durable under the WAL policy. True if it was newly set.
        `deadline` (time.monotonic()) caps a backpressure wait."""
        self._wal_gate(deadline)
        with self._mu:
            st = self.storage
            pos = self._pos(row_id, column_id)
            churn = st._find_key(pos >> 16) < 0
            changed = st.add(pos)
            seq = self._wal.seq()
            self._log_append(0, pos, churn)
            if changed:
                self.cache.add(row_id, self.row_count(row_id))
            self._count_op()
        self._wal.wait_durable(seq)
        return changed

    def clear_bit(self, row_id: int, column_id: int,
                  deadline: Optional[float] = None) -> bool:
        self._wal_gate(deadline)
        with self._mu:
            st = self.storage
            pos = self._pos(row_id, column_id)
            changed = st.remove(pos)
            seq = self._wal.seq()
            churn = changed and st._find_key(pos >> 16) < 0
            self._log_append(1, pos, churn)
            if changed:
                self.cache.add(row_id, self.row_count(row_id))
            self._count_op()
        self._wal.wait_durable(seq)
        return changed

    def _count_op(self):
        self.op_n += 1
        if self.op_n > self.max_op_n and not self._snapshotting:
            self._start_snapshot()  # the flip only: the writer goes on

    def _wal_gate(self, deadline: Optional[float] = None):
        """Backpressure: while more than max_wal_ops ops wait for a
        snapshot, block outside _mu (readers go on) until one lands, and
        shed with WriteBackpressureError at the deadline. A reentrant
        write skips the gate: the snapshot's splice needs the lock this
        thread holds."""
        limit = self.wal_cfg.max_wal_ops
        if limit <= 0 or self._pending_load or self._mu._is_owned():
            return
        if self.op_n <= limit:  # an unlocked read: advisory within an op
            return
        WAL_STATS.inc("backpressure")
        give_up = time.monotonic() + self.wal_cfg.backpressure_deadline
        if deadline is not None:
            give_up = min(give_up, deadline)
        while True:
            with self._mu:
                if self.op_n <= limit:
                    return
                if not self._snapshotting:
                    self._start_snapshot()
                done = self._snap_done
            remaining = give_up - time.monotonic()
            if remaining <= 0:
                WAL_STATS.inc("backpressure_shed")
                raise WriteBackpressureError(
                    f"write backpressure: {self.op_n} ops wait for a "
                    f"snapshot > max-wal-ops={limit} on {self.frame}/"
                    f"{self.view}/{self.slice}",
                    retry_after_s=max(1.0, self._last_snapshot_s))
            done.wait(min(remaining, 0.05))

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
        """Bulk import: unlogged adds, made durable by a snapshot that
        covers them (it is the import's commit barrier), waited for. The
        adds apply only when that snapshot can start at once: one frozen
        before them would not cover them."""
        self._await_snapshot(self.import_begin(row_ids, column_ids))

    def import_begin(self, row_ids: Sequence[int],
                     column_ids: Sequence[int]) -> int:
        """import_bits up to its barrier: apply the adds and start the
        snapshot that covers them; returns the snapshot generation to
        pass to import_wait. Frame.import_bits begins every fragment of
        a request before it waits for any, so their snapshots overlap."""
        rows = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(column_ids, dtype=np.uint64)
        if rows.shape != cols.shape:
            raise ValueError("row/column mismatch")
        pos = rows * np.uint64(SLICE_WIDTH) + cols % np.uint64(SLICE_WIDTH)
        while True:
            with self._mu:
                self.ensure_loaded()
                if not self._snapshotting:
                    self._import_apply_locked(rows, pos)
                    target = self._snap_gen + 1
                    self._start_snapshot()
                    return target
                done = self._snap_done
            done.wait()

    def import_wait(self, target: int) -> None:
        """Wait for import_begin's snapshot; raise its error."""
        self._await_snapshot(target)

    def _import_apply_locked(self, rows: np.ndarray, pos: np.ndarray):
        """The in-memory apply. A failure part way reloads the file: an
        import writes no op records, so the disk still holds the whole
        image before it."""
        self._storage.op_writer = None
        try:
            self._storage.add_many(pos)
            fault.point("storage.import_apply", path=self.path)
            counts = self.row_counts()
            for r in np.unique(rows).tolist():
                self.cache.bulk_add(r, counts.get(r, 0))
            self.cache.invalidate()
            self._log_reset()
        except BaseException:
            self._reload_from_disk()
            raise
        finally:
            self._storage.op_writer = self._wal

    def _reload_from_disk(self):
        """Drop the in-memory image and parse the file again (after a
        failed import). Buffered op records are written out first, so
        the file covers every accepted op."""
        self._wal.flush()
        with open(self.path, "rb") as f:
            self._storage = Bitmap.from_bytes(f.read())
        self.op_n = self._storage.op_n
        self._log_reset()
        self.cache = new_cache(self.cache_type, self.cache_size)
        self.rebuild_cache()

    def replace(self, bitmap: Bitmap):
        """Swap in a whole storage image. It lives in memory until the
        next snapshot() writes it out (bulk loaders that would take
        hours through per-bit writes)."""
        with self._mu:
            self.ensure_loaded()
            bitmap.op_writer = self._wal
            self._storage = bitmap
            self.cache = new_cache(self.cache_type, self.cache_size)
            self.rebuild_cache()
            self._log_reset()

    # -- backup / restore ------------------------------------------------------

    def write_to_tar(self, fileobj):
        """Stream the fragment as a tar: `data`, the snapshot bytes with
        their integrity footer, and `cache`, the rank cache's pairs as
        JSON (the JAX package's members)."""
        with self._mu:
            data = self.storage.to_bytes(footer=True)
            cache = json.dumps([[int(i), int(n)] for i, n
                                in (self.cache.top() or [])]).encode()
        with tarfile.open(fileobj=fileobj, mode="w|") as tar:
            for name, raw in (("data", data), ("cache", cache)):
                info = tarfile.TarInfo(name)
                info.size = len(raw)
                info.mtime = int(time.time())
                tar.addfile(info, io.BytesIO(raw))

    def read_from_tar(self, fileobj):
        """Restore from write_to_tar's archive. The `data` member replaces
        the storage whole, only while no snapshot is in flight (one frozen
        before the swap would write the old image), and a snapshot that
        covers it is waited for outside _mu: the restore's commit barrier,
        as for import_bits. The mutation log resets, so a staged view
        restages. The member is accepted whether or not its footer
        matches, as the JAX package accepts it (_parse_tar_data). The
        `cache` member re-adds its rows, recounted, and recalculates."""
        with tarfile.open(fileobj=fileobj, mode="r|") as tar:
            for member in tar:
                buf = tar.extractfile(member).read()
                if member.name == "data":
                    bm = _parse_tar_data(buf)
                    while True:
                        with self._mu:
                            self.ensure_loaded()
                            if not self._snapshotting:
                                self._storage.op_writer = None
                                bm.op_writer = self._wal
                                self._storage = bm
                                self.op_n = bm.op_n
                                self._log_reset()
                                target = self._snap_gen + 1
                                self._start_snapshot()
                                break
                            done = self._snap_done
                        done.wait()
                    self._await_snapshot(target)
                elif member.name == "cache":
                    with self._mu:
                        self.ensure_loaded()
                        for id_, _n in json.loads(buf or b"[]"):
                            self.cache.bulk_add(int(id_),
                                                self.row_count(int(id_)))
                        self.cache.recalculate()

    # -- background snapshots --------------------------------------------------

    def snapshot(self):
        """Force a snapshot that covers the current state and wait for it
        to land. Raises the attempt's error; the fragment stays
        serviceable either way (a failed attempt splices its side log
        back into the old file)."""
        with self._mu:
            self.ensure_loaded()
            if self._snapshotting:
                # The snapshot in flight froze before this call: chain one.
                self._resnap = True
                target = self._snap_gen + 2
            else:
                self._start_snapshot()
                target = self._snap_gen + 1
        self._await_snapshot(target)

    def wait_snapshot(self, timeout: Optional[float] = None) -> bool:
        """Block until no snapshot is in flight; False on timeout."""
        give_up = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._mu:
                if not self._snapshotting:
                    return True
                done = self._snap_done
            left = None if give_up is None else give_up - time.monotonic()
            if left is not None and left <= 0:
                return False
            done.wait(left)

    def storage_state(self) -> dict:
        """Durability state for /debug/vars (unlocked reads)."""
        return {"index": self.index, "frame": self.frame, "view": self.view,
                "slice": self.slice, "loaded": not self._pending_load,
                "op_n": self.op_n, "max_op_n": self.max_op_n,
                "snapshotting": self._snapshotting,
                "snapshots": self._snap_gen,
                "fsync_policy": self.wal_cfg.fsync_policy,
                "wal_fsyncs": self._wal.fsyncs,
                "last_snapshot_ms": round(self._last_snapshot_s * 1e3, 3)}

    def _start_snapshot(self):
        """The redirect flip, under _mu (O(containers) and one fsync):
        freeze the bitmap, aim the committer at a fresh side log (it
        drains what it buffered into the main file first, so main and
        side split exactly at the freeze) and hand the frozen view to a
        background writer. The only stall a snapshot costs a writer."""
        frozen = self._storage.freeze_view()
        self._side_file = open(self.side_wal_path, "wb", buffering=0)
        self._wal.retarget(self._side_file)
        self._snap_base_op_n = self.op_n
        self.op_n = 0
        self._snapshotting = True
        self._snap_done = threading.Event()
        self._snap_thread = threading.Thread(
            target=self._snapshot_worker, args=(frozen,),
            name=f"snapshot:{self.frame}/{self.view}/{self.slice}",
            daemon=True)
        self._snap_thread.start()

    def _snapshot_worker(self, frozen: Bitmap):
        start = time.monotonic()
        err: Optional[BaseException] = None
        try:
            with open(self._tmp_path, "wb") as f:
                frozen.write_to(f, footer=True)
                f.flush()
                fault.point("storage.fsync", path=self.path,
                            kind="snapshot")
                os.fsync(f.fileno())
            fault.point("storage.rename", path=self.path)
            os.replace(self._tmp_path, self.path)
        except BaseException as e:  # noqa: BLE001 — _finish reports it
            err = e
            try:
                os.unlink(self._tmp_path)
            except OSError:
                pass
        self._finish_snapshot(err, start)

    def _finish_snapshot(self, err: Optional[BaseException], start: float):
        """The splice, under _mu: the side log goes into the new main
        file (or, after a failed attempt, back into the old one, still
        valid), fsynced under a syncing policy, and is unlinked only
        then; the committer is aimed at main again and waiters wake."""
        with self._mu:
            try:
                target = (open(self.path, "ab", buffering=0)
                          if err is None else self._op_file)
                # Drains the committer's buffer into the side log first.
                self._wal.retarget(target)
                self._side_file.close()
                self._side_file = None
                with open(self.side_wal_path, "rb") as sf:
                    side = sf.read()
                if side:
                    target.write(side)
                    if self.wal_cfg.fsync_policy != FSYNC_NEVER:
                        os.fsync(target.fileno())
                os.unlink(self.side_wal_path)
                if err is None:
                    self._op_file.close()
                    self._op_file = target
                else:
                    # Main's op log still holds the ops before the freeze.
                    self.op_n += self._snap_base_op_n
            finally:
                elapsed = time.monotonic() - start
                self._last_snapshot_s = elapsed
                self._snap_err = err
                self._snap_gen += 1
                self._snapshotting = False
                self._snap_thread = None
                resnap, self._resnap = self._resnap, False
                # This attempt's event: a chained snapshot makes a new one.
                done = self._snap_done
                if resnap:
                    self._start_snapshot()
                done.set()
        SNAPSHOT_US.observe(elapsed * 1e6)
        WAL_STATS.inc("snapshots_failed" if err is not None else "snapshots")

    def _await_snapshot(self, target_gen: int):
        """Wait, without _mu (the splice needs it), until `target_gen`
        attempts have finished; raise the last one's error."""
        while True:
            with self._mu:
                if self._snap_gen >= target_gen:
                    err = self._snap_err
                    break
                done = self._snap_done
            done.wait()
        if err is not None:
            raise err

    # -- the rank cache --------------------------------------------------------

    def flush_cache(self):
        """Write the cache's pairs to `<fragment>.cache` (JSON [[id, n],
        ...], temp + rename), as the JAX package does. A fragment never
        loaded leaves the file as it is."""
        with self._mu:
            if self._pending_load:
                return
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
            self.ensure_loaded()
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
