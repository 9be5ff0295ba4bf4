"""AttrStore: id -> attribute map, kept in sqlite (`attrs.db`): the JAX
package's core/attr.py, copied with its schema and block checksums, so
either package opens the other's stores.

Values are str, int, bool or float; set_attrs merges into the stored
map, and a None value deletes its key. blocks() gives a SHA-1 per block
of 100 ids, which replicas compare to find the blocks that differ.
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
import threading
from typing import Dict, List, Optional, Tuple

# Ids per checksummed block.
ATTR_BLOCK_SIZE = 100

_ALLOWED = (str, int, bool, float)


def _validate(attrs: dict) -> dict:
    for k, v in attrs.items():
        if v is not None and not isinstance(v, _ALLOWED):
            raise TypeError(
                f"invalid attr type for {k!r}: {type(v).__name__}")
    return attrs


def _key(id_: int) -> str:
    # Zero-padded, so text order is numeric order for any uint64.
    return f"{id_:020d}"


class AttrStore:
    """sqlite-backed attribute store with an in-memory cache."""

    def __init__(self, path: str):
        self.path = path
        self._db: Optional[sqlite3.Connection] = None
        self._cache: Dict[int, dict] = {}
        self._lock = threading.RLock()

    def open(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._db = sqlite3.connect(self.path, check_same_thread=False)
        self._db.execute("CREATE TABLE IF NOT EXISTS attrs "
                         "(id TEXT PRIMARY KEY, data TEXT NOT NULL)")
        self._db.commit()

    def close(self):
        with self._lock:
            if self._db is not None:
                self._db.close()
                self._db = None
            self._cache.clear()

    def attrs(self, id_: int) -> dict:
        with self._lock:
            if id_ in self._cache:
                return dict(self._cache[id_])
            row = self._db.execute("SELECT data FROM attrs WHERE id = ?",
                                   (_key(id_),)).fetchone()
            m = json.loads(row[0]) if row else {}
            self._cache[id_] = m
            return dict(m)

    def _put(self, id_: int, cur: dict):
        self._db.execute(
            "INSERT OR REPLACE INTO attrs (id, data) VALUES (?, ?)",
            (_key(id_), json.dumps(cur, sort_keys=True)))
        self._cache[id_] = cur

    def set_attrs(self, id_: int, m: dict):
        """Merge m into id's attrs; a None value deletes its key."""
        self.set_bulk_attrs({id_: m})

    def set_bulk_attrs(self, items: Dict[int, dict]):
        """set_attrs for many ids, in one transaction."""
        with self._lock:
            for m in items.values():
                _validate(m)
            for id_, m in items.items():
                cur = self.attrs(id_)
                for k, v in m.items():
                    if v is None:
                        cur.pop(k, None)
                    else:
                        cur[k] = v
                self._put(id_, cur)
            self._db.commit()

    # -- anti-entropy blocks -------------------------------------------------

    def _rows(self) -> List[Tuple[int, str]]:
        with self._lock:
            return [(int(k), data) for k, data in self._db.execute(
                "SELECT id, data FROM attrs ORDER BY id")]

    def blocks(self) -> List[Tuple[int, bytes]]:
        """[(block id, SHA-1)] over the blocks of ATTR_BLOCK_SIZE ids."""
        out: List[Tuple[int, bytes]] = []
        h = None
        cur_block = None
        for id_, data in self._rows():
            blk = id_ // ATTR_BLOCK_SIZE
            if blk != cur_block:
                if h is not None:
                    out.append((cur_block, h.digest()))
                cur_block, h = blk, hashlib.sha1()
            h.update(_key(id_).encode())
            h.update(data.encode())
        if h is not None:
            out.append((cur_block, h.digest()))
        return out

    def block_data(self, block_id: int) -> Dict[int, dict]:
        """Every id's attrs in one block."""
        lo = block_id * ATTR_BLOCK_SIZE
        hi = lo + ATTR_BLOCK_SIZE
        return {id_: json.loads(data) for id_, data in self._rows()
                if lo <= id_ < hi}
