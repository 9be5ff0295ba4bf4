"""The row-count caches behind the host TopN: the JAX package's
core/cache.py, copied (without its unbounded row cache).

RankCache keeps the top rows by count: a row enters only at or above the
current threshold, a recalculation runs at most once every 10 s on the
write path (and on read whenever writes left it dirty), and the entries
are trimmed once they pass 1.1x the cache size. LRUCache is the bounded
alternative. Pairs are (id, count) tuples ordered by count descending,
then id ascending.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, List, Tuple

# Slack on the entry count before a trim.
THRESHOLD_FACTOR = 1.1

CACHE_TYPE_RANKED = "ranked"
CACHE_TYPE_LRU = "lru"
DEFAULT_CACHE_SIZE = 50000


def sort_pairs(pairs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    return sorted(pairs, key=lambda p: (-p[1], p[0]))


class RankCache:
    """Threshold-gated top-N count cache."""

    def __init__(self, max_entries: int = DEFAULT_CACHE_SIZE,
                 clock: Callable[[], float] = time.monotonic):
        self.entries: Dict[int, int] = {}
        self.rankings: List[Tuple[int, int]] = []
        self.max_entries = max_entries
        self.threshold_buffer = int(THRESHOLD_FACTOR * max_entries)
        self.threshold_value = 0
        self._clock = clock
        self._update_time = float("-inf")
        self._dirty = False

    def add(self, id_: int, n: int):
        if n < self.threshold_value:
            return
        self.entries[id_] = n
        self._dirty = True
        self.invalidate()

    def bulk_add(self, id_: int, n: int):
        """add without the recalculation: call invalidate() after the
        batch."""
        if n < self.threshold_value:
            return
        self.entries[id_] = n
        self._dirty = True

    def get(self, id_: int) -> int:
        return self.entries.get(id_, 0)

    def __len__(self) -> int:
        return len(self.entries)

    def ids(self) -> List[int]:
        return sorted(self.entries)

    def invalidate(self):
        # At most one recalculation every 10 s on the write path.
        if self._clock() - self._update_time < 10:
            return
        self.recalculate()

    def recalculate(self):
        rankings = sort_pairs(list(self.entries.items()))
        if len(rankings) > self.max_entries:
            self.threshold_value = rankings[self.max_entries][1]
            rankings = rankings[: self.max_entries]
        else:
            self.threshold_value = 1
        self.rankings = rankings
        self._update_time = self._clock()
        self._dirty = False
        if len(self.entries) > self.threshold_buffer:
            self.entries = {id_: n for id_, n in self.entries.items()
                            if n > self.threshold_value}

    def top(self) -> List[Tuple[int, int]]:
        # The read path recalculates whenever writes left the rankings
        # dirty, so a TopN right after a write sees it.
        if self._dirty:
            self.recalculate()
        return list(self.rankings)


class LRUCache:
    """Bounded least-recently-used count cache."""

    def __init__(self, max_entries: int = DEFAULT_CACHE_SIZE):
        self.max_entries = max_entries
        self._od: "OrderedDict[int, int]" = OrderedDict()

    def add(self, id_: int, n: int):
        self._od[id_] = n
        self._od.move_to_end(id_)
        while len(self._od) > self.max_entries:
            self._od.popitem(last=False)

    bulk_add = add

    def get(self, id_: int) -> int:
        n = self._od.get(id_, 0)
        if id_ in self._od:
            self._od.move_to_end(id_)
        return n

    def __len__(self) -> int:
        return len(self._od)

    def ids(self) -> List[int]:
        return sorted(self._od)

    def invalidate(self):
        pass

    def recalculate(self):
        pass

    def top(self) -> List[Tuple[int, int]]:
        return sort_pairs(list(self._od.items()))


def new_cache(cache_type: str, size: int, clock=time.monotonic):
    if cache_type == CACHE_TYPE_RANKED:
        return RankCache(size, clock=clock)
    if cache_type == CACHE_TYPE_LRU:
        return LRUCache(size)
    raise ValueError(f"unknown cache type: {cache_type}")


def add_to_pairs(pairs: List[Tuple[int, int]],
                 other: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge two pair lists by id, summing the counts."""
    m: Dict[int, int] = dict(pairs)
    for id_, n in other:
        m[id_] = m.get(id_, 0) + n
    return sort_pairs(list(m.items()))
