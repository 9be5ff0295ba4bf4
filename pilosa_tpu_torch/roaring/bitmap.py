"""Numpy roaring bitmap with the reference's container semantics.

A reduced copy of the JAX package's host bitmap: containers split the
uint64 value space into 2^16-wide blocks keyed by value >> 16, each an
`array` of sorted values when its cardinality is <= 4096 and a
1024-word uint64 `bitmap` otherwise. Everything here is numpy; the
device never sees these objects, only the packed words the stager
builds from them (parallel/mesh.py).
"""

from __future__ import annotations

import io
from bisect import bisect_left
from typing import Iterable, Iterator, Optional

import numpy as np

# Cardinality at which an array container converts to a bitmap.
ARRAY_MAX_SIZE = 4096

# uint64 words per bitmap container: 2^16 bits / 64.
BITMAP_N = (1 << 16) // 64

# Value span of one container.
CONTAINER_WIDTH = 1 << 16

_U64 = np.uint64
_U32 = np.uint32


def values_to_bitmap_words(values: np.ndarray) -> np.ndarray:
    """Pack low-16-bit values into a 1024-word uint64 bitmap."""
    bits = np.zeros(CONTAINER_WIDTH, dtype=np.uint8)
    bits[values] = 1
    return np.packbits(bits, bitorder="little").view(_U64)


def bitmap_to_values(words: np.ndarray) -> np.ndarray:
    """Unpack a 1024-word uint64 bitmap into sorted uint32 values."""
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(_U32)


def popcount_words(words: np.ndarray) -> int:
    return int(np.bitwise_count(words).sum(dtype=np.int64))


class Container:
    """One 2^16-value block: sorted uint32 array or 1024-word uint64
    bitmap. Normalized: n <= 4096 <=> array form. `shared` marks a
    container that a frozen view (Bitmap.freeze_view) also holds: the
    live bitmap clones it before any mutation (copy-on-write). `fnv` is
    the FNV-1a of its serialized bytes, when known (from a verified
    footer, or the last snapshot that wrote it); every mutation drops it,
    so a snapshot hashes only the containers that changed."""

    __slots__ = ("array", "bitmap", "shared", "fnv")

    def __init__(self, array: Optional[np.ndarray] = None,
                 bitmap: Optional[np.ndarray] = None,
                 fnv: Optional[int] = None):
        self.array = array
        self.bitmap = bitmap
        self.shared = False
        self.fnv = fnv
        if array is None and bitmap is None:
            self.array = np.empty(0, dtype=_U32)

    @property
    def n(self) -> int:
        if self.array is not None:
            return len(self.array)
        return popcount_words(self.bitmap)

    def is_array(self) -> bool:
        return self.array is not None

    def normalize(self) -> "Container":
        """Convert between forms at the 4096 threshold."""
        if self.array is not None and len(self.array) > ARRAY_MAX_SIZE:
            self.bitmap = values_to_bitmap_words(self.array)
            self.array = self.fnv = None
        elif self.bitmap is not None and self.n <= ARRAY_MAX_SIZE:
            self.array = bitmap_to_values(self.bitmap)
            self.bitmap = self.fnv = None
        return self

    def clone(self) -> "Container":
        if self.array is not None:
            return Container(array=self.array.copy(), fnv=self.fnv)
        return Container(bitmap=self.bitmap.copy(), fnv=self.fnv)

    def values(self) -> np.ndarray:
        """Sorted uint32 values present in this container."""
        if self.array is not None:
            return self.array
        return bitmap_to_values(self.bitmap)

    def words(self) -> np.ndarray:
        """The container as a 1024-word uint64 bitmap (dense view)."""
        if self.bitmap is not None:
            return self.bitmap
        return values_to_bitmap_words(self.array)

    def contains(self, v: int) -> bool:
        if self.array is not None:
            i = np.searchsorted(self.array, v)
            return i < len(self.array) and int(self.array[i]) == v
        return bool((int(self.bitmap[v >> 6]) >> (v & 63)) & 1)

    def add(self, v: int) -> bool:
        """Add low-bits value v. True if it was not already set."""
        if self.array is not None:
            i = int(np.searchsorted(self.array, v))
            if i < len(self.array) and int(self.array[i]) == v:
                return False
            self.fnv = None
            self.array = np.insert(self.array, i, _U32(v))
            self.normalize()
            return True
        w, b = v >> 6, v & 63
        word = int(self.bitmap[w])
        if (word >> b) & 1:
            return False
        self.fnv = None
        self.bitmap[w] = _U64(word | (1 << b))
        return True

    def remove(self, v: int) -> bool:
        """Remove low-bits value v. True if it was set."""
        if self.array is not None:
            i = int(np.searchsorted(self.array, v))
            if i >= len(self.array) or int(self.array[i]) != v:
                return False
            self.fnv = None
            self.array = np.delete(self.array, i)
            return True
        w, b = v >> 6, v & 63
        word = int(self.bitmap[w])
        if not (word >> b) & 1:
            return False
        self.fnv = None
        self.bitmap[w] = _U64(word & ~(1 << b))
        self.normalize()
        return True

    def add_many(self, vals: np.ndarray) -> int:
        """Bulk add sorted, unique low-bits values; returns the number
        newly set. An array container merges sorted arrays (a bulk
        import's common case) and packs words only when it outgrows the
        array form."""
        before = self.n
        self.fnv = None
        if self.array is not None:
            # `vals` come sorted and unique (Bitmap.add_many).
            merged = (vals.astype(_U32) if not len(self.array) else
                      np.union1d(self.array, vals.astype(_U32, copy=False)))
            if len(merged) <= ARRAY_MAX_SIZE:
                self.array = merged
            else:
                self.array = None
                self.bitmap = values_to_bitmap_words(merged)
            return len(merged) - before
        words = self.words().copy()
        words |= values_to_bitmap_words(vals)
        self.array, self.bitmap = None, words
        self.normalize()
        return self.n - before

    def _combine(self, other: "Container", op) -> "Container":
        return Container(bitmap=op(self.words(), other.words())).normalize()

    def intersect(self, other: "Container") -> "Container":
        if self.is_array() and other.is_array():
            return Container(array=np.intersect1d(
                self.array, other.array, assume_unique=True).astype(_U32))
        return self._combine(other, np.bitwise_and)

    def union(self, other: "Container") -> "Container":
        if self.is_array() and other.is_array():
            return Container(array=np.union1d(
                self.array, other.array).astype(_U32)).normalize()
        return self._combine(other, np.bitwise_or)

    def difference(self, other: "Container") -> "Container":
        if self.is_array() and other.is_array():
            return Container(array=np.setdiff1d(
                self.array, other.array, assume_unique=True).astype(_U32))
        return self._combine(other, lambda a, b: a & ~b)


class Bitmap:
    """Roaring bitmap: sorted (key -> Container) map over the uint64
    space, key = value >> 16. `op_writer`, when set, receives one WAL
    op per single-value add/remove (serialize.write_op). A parsed file
    sets `verified_footer` (its integrity footer was checked) and
    `torn_tail_bytes` (the torn op record a crash left, when the parse
    was asked to drop it)."""

    __slots__ = ("keys", "containers", "op_writer", "op_n",
                 "verified_footer", "torn_tail_bytes")

    def __init__(self, values: Optional[Iterable[int]] = None):
        self.keys: list[int] = []
        self.containers: list[Container] = []
        self.op_writer = None
        self.op_n = 0
        self.verified_footer = False
        self.torn_tail_bytes = 0
        if values is not None:
            arr = np.asarray(values if isinstance(values, np.ndarray)
                             else list(values), dtype=_U64)
            if arr.size:
                self.add_many(arr)

    def _find_key(self, key: int) -> int:
        i = bisect_left(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            return i
        return -1

    def _container_for(self, key: int, create: bool = False
                       ) -> Optional[Container]:
        i = bisect_left(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            return self.containers[i]
        if not create:
            return None
        c = Container()
        self.keys.insert(i, key)
        self.containers.insert(i, c)
        return c

    def _writable_container_for(self, key: int, create: bool = False
                                ) -> Optional[Container]:
        """_container_for, cloning a shared container first, so a
        frozen view never sees a mutation."""
        i = bisect_left(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            c = self.containers[i]
            if c.shared:
                c = self.containers[i] = c.clone()
            return c
        return self._container_for(key, create)

    def freeze_view(self) -> "Bitmap":
        """An immutable view of the current state for the background
        snapshot writer: one list copy, the containers shared and marked
        copy-on-write on both sides."""
        out = Bitmap()
        out.keys = list(self.keys)
        for c in self.containers:
            c.shared = True
        out.containers = list(self.containers)
        return out

    # -- mutation ----------------------------------------------------------

    def _log(self, typ: int, v: int) -> None:
        if self.op_writer is not None:
            from .serialize import write_op

            write_op(self.op_writer, typ, v)
            self.op_n += 1

    def add(self, *values: int) -> bool:
        """Add values, logging one WAL op each. True if any was new."""
        changed = False
        for v in values:
            v = int(v)
            self._log(0, v)
            changed |= self._add_one(v)
        return changed

    def _add_one(self, v: int) -> bool:
        return self._writable_container_for(v >> 16, create=True).add(
            v & 0xFFFF)

    def remove(self, *values: int) -> bool:
        changed = False
        for v in values:
            v = int(v)
            self._log(1, v)
            changed |= self._remove_one(v)
        return changed

    def _remove_one(self, v: int) -> bool:
        c = self._writable_container_for(v >> 16)
        if c is None or not c.remove(v & 0xFFFF):
            return False
        if c.n == 0:
            i = self._find_key(v >> 16)
            del self.keys[i]
            del self.containers[i]
        return True

    def add_many(self, values: np.ndarray) -> int:
        """Bulk add without WAL ops; returns the number newly set."""
        values = np.unique(np.asarray(values, dtype=_U64))
        if values.size == 0:
            return 0
        keys = (values >> _U64(16)).astype(np.int64)
        low = (values & _U64(0xFFFF)).astype(_U32)
        bounds = np.flatnonzero(np.diff(keys)) + 1
        total = 0
        for s, e in zip(np.concatenate(([0], bounds)),
                        np.concatenate((bounds, [len(keys)]))):
            c = self._writable_container_for(int(keys[s]), create=True)
            total += c.add_many(low[s:e])
        return total

    # -- queries -----------------------------------------------------------

    def contains(self, v: int) -> bool:
        c = self._container_for(int(v) >> 16)
        return c is not None and c.contains(int(v) & 0xFFFF)

    def count(self) -> int:
        return sum(c.n for c in self.containers)

    def slice(self) -> np.ndarray:
        """All values, sorted, as uint64."""
        if not self.keys:
            return np.empty(0, dtype=_U64)
        return np.concatenate([
            (_U64(key) << _U64(16)) | c.values().astype(_U64)
            for key, c in zip(self.keys, self.containers)])

    def slice_range(self, start: int, end: int) -> np.ndarray:
        """The values in [start, end), sorted, as uint64."""
        if start >= end or not self.keys:
            return np.empty(0, dtype=_U64)
        skey, ekey = start >> 16, (end - 1) >> 16
        parts = []
        for i in range(bisect_left(self.keys, skey),
                       bisect_left(self.keys, ekey + 1)):
            key = self.keys[i]
            v = (_U64(key) << _U64(16)) | \
                self.containers[i].values().astype(_U64)
            if key == skey:
                v = v[np.searchsorted(v, _U64(start)):]
            if key == ekey:
                v = v[:np.searchsorted(v, _U64(end))]
            parts.append(v)
        return (np.concatenate(parts) if parts
                else np.empty(0, dtype=_U64))

    def __iter__(self) -> Iterator[int]:
        for v in self.slice():
            yield int(v)

    def offset_range(self, offset: int, start: int, end: int) -> "Bitmap":
        """Copy the containers in [start, end) re-keyed to begin at
        `offset` (all three multiples of 2^16): row materialization."""
        if offset & 0xFFFF or start & 0xFFFF or end & 0xFFFF:
            raise ValueError("offset/start/end must be multiples of 2^16")
        okey, skey, ekey = offset >> 16, start >> 16, end >> 16
        out = Bitmap()
        for i in range(bisect_left(self.keys, skey),
                       bisect_left(self.keys, ekey)):
            out.keys.append(okey + (self.keys[i] - skey))
            out.containers.append(self.containers[i].clone())
        return out

    # -- pairwise set ops --------------------------------------------------

    def _merge(self, other: "Bitmap", op: str) -> "Bitmap":
        out = Bitmap()
        i = j = 0
        a_keys, b_keys = self.keys, other.keys
        while i < len(a_keys) or j < len(b_keys):
            ka = a_keys[i] if i < len(a_keys) else None
            kb = b_keys[j] if j < len(b_keys) else None
            if kb is None or (ka is not None and ka < kb):
                if op in ("union", "difference"):
                    out.keys.append(ka)
                    out.containers.append(self.containers[i].clone())
                i += 1
            elif ka is None or kb < ka:
                if op == "union":
                    out.keys.append(kb)
                    out.containers.append(other.containers[j].clone())
                j += 1
            else:
                c = getattr(self.containers[i], op)(other.containers[j])
                if c.n > 0:
                    out.keys.append(ka)
                    out.containers.append(c)
                i += 1
                j += 1
        return out

    def intersect(self, other: "Bitmap") -> "Bitmap":
        return self._merge(other, "intersect")

    def union(self, other: "Bitmap") -> "Bitmap":
        return self._merge(other, "union")

    def difference(self, other: "Bitmap") -> "Bitmap":
        return self._merge(other, "difference")

    def clone(self) -> "Bitmap":
        out = Bitmap()
        out.keys = list(self.keys)
        out.containers = [c.clone() for c in self.containers]
        return out

    # -- serialization (serialize.py) --------------------------------------

    def write_to(self, w, footer: bool = False) -> int:
        from .serialize import write_bitmap

        return write_bitmap(self, w, footer=footer)

    def to_bytes(self, footer: bool = False) -> bytes:
        buf = io.BytesIO()
        self.write_to(buf, footer=footer)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes, truncate_torn_tail: bool = False,
                   verify: bool = False) -> "Bitmap":
        from .serialize import read_bitmap

        return read_bitmap(data, truncate_torn_tail=truncate_torn_tail,
                           verify=verify)
