"""Replication epochs on the coordinator's side: what this node knows of
every replica's write progress, and the result cache keyed by it (the
JAX package's pilosa_tpu/parallel/epochs.py).

Every fragment counts its mutations in a replication epoch
(core/fragment.py): one bump an applied op, floor-raised by anti-entropy
and by a hint replay, so the counts of a fragment's replicas compare.

- `EpochTracker` gathers the epochs this node learns: its own writes and
  the replicated writes it coordinates (`observe_local`, at once) and
  each peer's digest of GET /internal/epochs (`observe_digest`, on the
  status poll). A replica's staleness is the writes it is behind, turned
  into time through the tracker's history: the age of the oldest write
  it misses is the time since this node first learned of the epoch past
  the replica's. A fragment key is "index/frame/view/slice".
- `ResultCache` is an LRU of whole Count results keyed by (plan, slices)
  and stamped with an epoch token over the touched slices
  (EpochTracker.epoch_token): an entry is served only at exactly that
  token, so a write this node has seen makes it a miss (counted
  `invalidate`), never a stale hit. It holds host integers only. The
  JAX executor stamps entries with the highest epoch over the slices,
  which a write to a slice whose epoch is below that highest leaves
  where it was (a stale hit); the port's token is the sum of the
  slices' known epochs, which every observed write moves.

A bound of X seconds means a read reflects every write this coordinator
has known of for at least X: its own writes at once, other
coordinators' at the digest's cadence. Where the tracker cannot tell (no
digest from a host, a backlog deeper than the history ring) the replica
is not eligible: the check fails closed.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

from ..obs.metrics import StatMap

# (epoch, first seen) pairs a key keeps; a replica further behind than
# the ring remembers is not eligible.
HISTORY_MAX = 256

DEFAULT_RESULT_CACHE_SIZE = 4096


def fragment_key(index: str, frame: str, view: str, slice_: int) -> str:
    """A fragment replica's key in the digests."""
    return f"{index}/{frame}/{view}/{slice_}"


class EpochTracker:
    """The epochs this coordinator knows, by fragment and by host.
    Thread-safe; every call is a little dict work (the write path calls
    observe_local once a coordinated op)."""

    def __init__(self):
        self._mu = threading.Lock()
        # key -> the highest epoch known from any source.
        self._max: Dict[str, int] = {}
        # key -> deque of (epoch, first seen, monotonic), appended as the
        # max moves; key -> the highest epoch that fell off the ring.
        self._history: Dict[str, deque] = {}
        self._dropped: Dict[str, int] = {}
        # host -> (epochs, queue depth, received at).
        self._digests: Dict[str, Tuple[Dict[str, int], int, float]] = {}
        # (index, slice) -> its keys: placement and the cache ask by
        # slice (they do not know which frames a plan reads).
        self._slice_keys: Dict[Tuple[str, int], set] = {}

    # -- feeds -----------------------------------------------------------------

    def observe_local(self, key: str, epoch: int,
                      now: Optional[float] = None) -> None:
        """A write this node applied or coordinated: the max moves now."""
        with self._mu:
            self._note_locked(key, int(epoch),
                              time.monotonic() if now is None else now)

    def observe_digest(self, host: str, epochs: Dict[str, int],
                       queue_depth: int = 0,
                       now: Optional[float] = None) -> None:
        """A peer's GET /internal/epochs answer."""
        t = time.monotonic() if now is None else now
        epochs = {str(k): int(v) for k, v in (epochs or {}).items()}
        with self._mu:
            self._digests[host] = (epochs, int(queue_depth), t)
            for k, e in epochs.items():
                self._note_locked(k, e, t)

    def forget_host(self, host: str) -> None:
        """An unreachable peer: without a digest it is not eligible."""
        with self._mu:
            self._digests.pop(host, None)

    def _note_locked(self, key: str, epoch: int, now: float) -> None:
        if epoch <= self._max.get(key, 0):
            return
        if key not in self._max:
            parts = key.split("/")
            if len(parts) == 4:
                try:
                    sk = (parts[0], int(parts[3]))
                except ValueError:
                    sk = None
                if sk is not None:
                    self._slice_keys.setdefault(sk, set()).add(key)
        self._max[key] = epoch
        h = self._history.setdefault(key, deque())
        h.append((epoch, now))
        while len(h) > HISTORY_MAX:
            dropped, _ = h.popleft()
            if dropped > self._dropped.get(key, 0):
                self._dropped[key] = dropped

    # -- reads -----------------------------------------------------------------

    def max_epoch(self, key: str) -> int:
        with self._mu:
            return self._max.get(key, 0)

    def queue_depth(self, host: str) -> int:
        with self._mu:
            d = self._digests.get(host)
            return d[1] if d else 0

    def epoch_token(self, index: str, slices) -> int:
        """The sum of the highest known epoch of every fragment of
        `index` in `slices`: the result cache's stamp. Epochs only rise,
        so any write the tracker learns of moves it."""
        with self._mu:
            return sum(self._max.get(k, 0) for s in slices
                       for k in self._slice_keys.get((index, int(s)), ()))

    def staleness_ok(self, host: str, keys, bound_s: float,
                     now: Optional[float] = None) -> bool:
        """Whether `host` may serve a read of `keys` within `bound_s`:
        for each key it is caught up, or the oldest write it misses is
        younger than the bound. No digest, or a backlog deeper than the
        ring: not eligible."""
        t = time.monotonic() if now is None else now
        with self._mu:
            return self._staleness_ok_locked(host, keys, bound_s, t)

    def staleness_ok_slice(self, host: str, index: str, slice_: int,
                           bound_s: float,
                           now: Optional[float] = None) -> bool:
        """staleness_ok over every known fragment of (index, slice):
        placement's question, asked before it knows the plan's frames."""
        t = time.monotonic() if now is None else now
        with self._mu:
            keys = self._slice_keys.get((index, int(slice_)), ())
            return self._staleness_ok_locked(host, keys, bound_s, t)

    def _staleness_ok_locked(self, host: str, keys, bound_s: float,
                             t: float) -> bool:
        d = self._digests.get(host)
        if d is None:
            return False
        host_epochs = d[0]
        for key in keys:
            known = self._max.get(key, 0)
            if known <= 0:
                continue  # no write known: nothing to miss
            he = host_epochs.get(key, 0)
            if he >= known:
                continue
            if he < self._dropped.get(key, 0):
                return False  # behind what the ring remembers
            # When this node learned of the oldest write the host misses.
            first_seen = None
            for epoch, seen in self._history.get(key, ()):
                if epoch > he:
                    first_seen = seen
                    break
            if first_seen is None or t - first_seen > bound_s:
                return False
        return True

    def snapshot(self) -> dict:
        """/debug/vars `epochs`."""
        with self._mu:
            return {
                "tracked_fragments": len(self._max),
                "peers": {h: {"fragments": len(d[0]), "queue_depth": d[1],
                              "age_s": round(time.monotonic() - d[2], 3)}
                          for h, d in self._digests.items()},
            }


class ResultCache:
    """An LRU of whole-query results keyed by (index, plan, slices) and
    stamped with an epoch token (the caller's EpochTracker.epoch_token):
    another token is a miss and drops the entry. Events count in
    `stats` (pilosa_result_cache_events_total{event}): hit, miss,
    invalidate, evict, bypass."""

    def __init__(self, cap: int = DEFAULT_RESULT_CACHE_SIZE):
        self.cap = max(1, int(cap))
        self._mu = threading.Lock()
        # key -> (epoch, value)
        self._entries: "OrderedDict[tuple, Tuple[int, object]]" = \
            OrderedDict()
        self.stats = StatMap()

    def get(self, base_key: tuple, epoch: int):
        """The value stored for this plan at exactly `epoch`, or None.
        An entry of an older epoch is dropped (`invalidate`)."""
        with self._mu:
            ent = self._entries.get(base_key)
            if ent is None:
                self.stats.inc("miss")
                return None
            if ent[0] != epoch:
                del self._entries[base_key]
                self.stats.inc("invalidate")
                self.stats.inc("miss")
                return None
            self._entries.move_to_end(base_key)
            self.stats.inc("hit")
            return ent[1]

    def put(self, base_key: tuple, epoch: int, value) -> None:
        with self._mu:
            self._entries[base_key] = (int(epoch), value)
            self._entries.move_to_end(base_key)
            while len(self._entries) > self.cap:
                self._entries.popitem(last=False)
                self.stats.inc("evict")

    def invalidate(self, base_key: tuple) -> None:
        """Drop one entry (a verified hit that disagreed)."""
        with self._mu:
            if self._entries.pop(base_key, None) is not None:
                self.stats.inc("invalidate")

    def bypass(self) -> None:
        """A read that may not use the cache (strict, or a plan with no
        key): counted, so a hit rate covers every read."""
        self.stats.inc("bypass")

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def snapshot(self) -> dict:
        """/debug/vars `result_cache`."""
        s = self.stats.copy()
        with self._mu:
            size = len(self._entries)
        hits, misses = s.get("hit", 0), s.get("miss", 0)
        return {"size": size, "cap": self.cap,
                "hit_rate": round(hits / (hits + misses), 4)
                if hits + misses else None, **s}
