"""The integrity scrubber: a paced background walk over every fragment
of one node that proves what is on disk still matches what was
written (pilosa_tpu/core/scrub.py, reduced to one node):

1. On-disk verification: read the file again and verify its integrity
   footer and op-log checksums (through the `storage.corrupt` seam).
   Rot in a loaded fragment is repaired from memory, which is
   authoritative: a fresh snapshot rewrites the file. Rot in a fragment
   not yet loaded stays in place and is counted `unrepaired`: the
   fragment raises CorruptFragmentError when touched (one node has no
   replica to repair it from).
2. Disk against memory: when the parse succeeds on a file without a
   footer (one written before footers, which cannot show its own rot)
   and the fragment is loaded and quiet (no snapshot in flight, no
   write since the read), the parsed image's block checksums are
   diffed against the live `blocks()`; a difference is repaired as in
   1. A verified footer already proves the region holds the bytes
   written, and every op record carries its checksum, so such a file
   is not diffed (at 960 slices the diff would hash 37 MB of values a
   fragment, twice).

The cross-replica diff of the JAX scrubber waits for the port's cluster
layer.

Pacing: `rate_limit` bytes a second over the whole pass (tokens against
the pass's start), so a large holder scrubs without starving queries;
0 does not pace. `close()` stops a pass at once. SCRUB_STATS counts
fragments verified, bytes read, corruption found, repairs, unrepaired
fragments and passes; each fragment's `last_scrub` is the wall-clock
time of its last verification.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from .. import fault
from ..obs.health import HEALTH
from ..roaring import Bitmap
from ..obs.metrics import StatMap
from .fragment import INTEGRITY_STATS, bitmap_block_checksums

SCRUB_STATS = StatMap()

DEFAULT_SCRUB_RATE_LIMIT = 16 << 20
SCRUB_JITTER = 0.1


class Scrubber:
    """Verifies and repairs the fragments of `holder`, once a pass
    (scrub_pass) or every `interval` seconds in a thread (start)."""

    def __init__(self, holder, interval: float = 600.0,
                 rate_limit: int = DEFAULT_SCRUB_RATE_LIMIT,
                 enabled: bool = True):
        self.holder = holder
        self.interval = float(interval)
        self.rate_limit = int(rate_limit)
        self.enabled = bool(enabled)
        self.last_pass_start = 0.0
        self.last_pass_end = 0.0
        self.last_pass_fragments = 0
        self.last_pass_bytes = 0
        self._closing = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pass_t0 = 0.0
        self._pass_bytes = 0

    # -- the loop ------------------------------------------------------------

    def start(self) -> None:
        """Run a pass every `interval` seconds until close()."""
        if not self.enabled or self.interval <= 0 or self._thread:
            return
        self._thread = threading.Thread(target=self._loop, name="scrub",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        # Each pass starts up to SCRUB_JITTER of the interval late
        # (uniform), so nodes that share a config do not scrub in
        # lockstep, as the JAX server's scrub loop. The loop is the
        # `scrub` heartbeat of the liveness plane (not critical).
        hb = HEALTH.register("scrub",
                             interval=self.interval * (1.0 + SCRUB_JITTER))
        while not self._closing.wait(
                self.interval * (1.0 + random.uniform(0.0, SCRUB_JITTER))):
            hb.beat()
            self.scrub_pass()

    def close(self) -> None:
        self._closing.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            HEALTH.unregister("scrub")

    # -- one pass --------------------------------------------------------------

    def _pace(self, nbytes: int) -> None:
        """Sleep until the pass's bytes over its elapsed time are within
        rate_limit: small fragments bank time that large ones spend."""
        self._pass_bytes += nbytes
        SCRUB_STATS.inc("bytes", nbytes)
        if self.rate_limit <= 0:
            return
        lag = (self._pass_bytes / self.rate_limit
               - (time.monotonic() - self._pass_t0))
        if lag > 0:
            self._closing.wait(lag)

    def scrub_pass(self) -> int:
        """One walk over every fragment; returns how many it verified.
        A pass is the `scrub` subsystem's in-flight op, visibility only
        (its wall time scales with the data and the rate limit)."""
        if not self.enabled:
            return 0
        with HEALTH.inflight("scrub", "pass"):
            return self._scrub_pass()

    def _scrub_pass(self) -> int:
        self._pass_t0 = time.monotonic()
        self._pass_bytes = 0
        self.last_pass_start = time.time()
        n = 0
        for frag in self.holder.fragments():
            if self._closing.is_set():
                return n
            try:
                self.scrub_fragment(frag)
            except Exception:  # noqa: BLE001 — a scrub never stops a node
                SCRUB_STATS.inc("errors")
                continue
            n += 1
        self.last_pass_end = time.time()
        self.last_pass_fragments = n
        self.last_pass_bytes = self._pass_bytes
        SCRUB_STATS.inc("passes")
        return n

    def scrub_fragment(self, frag) -> None:
        """Verify one fragment on disk, diff it against memory, and
        repair what either finds."""
        parsed = self._verify_disk(frag)
        if parsed is not None:
            self._diff_memory(frag, parsed)
        frag.last_scrub = time.time()
        SCRUB_STATS.inc("fragments")

    def _verify_disk(self, frag) -> Optional[Bitmap]:
        """The parsed file, or None when it is absent or was found
        rotted (and then repaired, or counted)."""
        try:
            with open(frag.path, "rb") as fh:
                data = fh.read()
        except FileNotFoundError:
            return None
        self._pace(len(data))
        data = fault.corrupt("storage.corrupt", data, path=frag.path,
                             kind="scrub")
        try:
            return Bitmap.from_bytes(data, truncate_torn_tail=True,
                                     verify=True)
        except ValueError:
            SCRUB_STATS.inc("corrupt")
            INTEGRITY_STATS.inc("scrub_detected")
            self._repair(frag)
            return None

    def _repair(self, frag) -> None:
        """A loaded fragment: rewrite the file from memory with a fresh
        snapshot. One not loaded: leave the rot for its touch to raise."""
        if frag._pending_load:
            SCRUB_STATS.inc("unrepaired")
            return
        try:
            frag.snapshot()
            SCRUB_STATS.inc("repairs")
        except Exception:  # noqa: BLE001 — counted; the next pass retries
            SCRUB_STATS.inc("unrepaired")

    def _diff_memory(self, frag, parsed: Bitmap) -> None:
        """The parsed file's block checksums against the live blocks(),
        for a file without a footer, when the fragment is loaded and
        quiet: a write or a snapshot racing the read skips the diff (the
        next pass checks again)."""
        if parsed.verified_footer:
            return
        with frag._mu:
            if frag._pending_load or frag._snapshotting \
                    or frag.op_n != parsed.op_n:
                return
            mem = dict(frag.blocks())
        if bitmap_block_checksums(parsed) == mem:
            return
        SCRUB_STATS.inc("corrupt")
        INTEGRITY_STATS.inc("scrub_detected")
        self._repair(frag)

    def oldest_scrub_age(self) -> float:
        """Seconds since the least recently scrubbed fragment was
        scrubbed; 0.0 before the first scrub (/metrics
        pilosa_scrub_last_age_seconds)."""
        stamps = [f.last_scrub for f in self.holder.fragments()
                  if f.last_scrub > 0]
        return max(0.0, time.time() - min(stamps)) if stamps else 0.0

    def snapshot(self) -> dict:
        """The /debug/vars record."""
        return {"enabled": self.enabled, "interval_s": self.interval,
                "rate_limit_bytes_s": self.rate_limit,
                "last_pass_start": self.last_pass_start,
                "last_pass_end": self.last_pass_end,
                "last_pass_fragments": self.last_pass_fragments,
                "last_pass_bytes": self.last_pass_bytes,
                **SCRUB_STATS.copy()}
