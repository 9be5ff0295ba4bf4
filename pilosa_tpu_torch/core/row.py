"""Row: a query-level bitmap spanning many slices (slice -> slice-local
roaring bitmap), with a per-slice count cache (`_counts`: filled by
count(), or up front by the host fold that built the row,
parallel/plan.HostMaterializePlan)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import SLICE_WIDTH
from ..roaring import Bitmap


class Row:
    """Segmented bitmap over the global column space."""

    __slots__ = ("segments", "attrs", "_counts")

    def __init__(self):
        self.segments: Dict[int, Bitmap] = {}
        self.attrs: dict = {}
        self._counts: Dict[int, int] = {}

    @classmethod
    def from_segment(cls, slice_: int, bitmap: Bitmap) -> "Row":
        r = cls()
        r.segments[slice_] = bitmap
        return r

    @classmethod
    def from_columns(cls, columns) -> "Row":
        """A row of absolute column IDs (a remote leg's answer)."""
        cols = np.unique(np.asarray(columns, dtype=np.uint64))
        r = cls()
        if len(cols):
            slices = cols // np.uint64(SLICE_WIDTH)
            bounds = np.flatnonzero(np.diff(slices)) + 1
            for part in np.split(cols, bounds):
                s = int(part[0]) // SLICE_WIDTH
                r.segments[s] = Bitmap(part - np.uint64(s * SLICE_WIDTH))
        return r

    def merge(self, other: "Row") -> None:
        """Union `other` into self."""
        for s, seg in other.segments.items():
            mine = self.segments.get(s)
            self.segments[s] = seg if mine is None else mine.union(seg)
            self._counts.pop(s, None)

    def _binop(self, other: "Row", op: str, keep_left_only: bool) -> "Row":
        out = Row()
        for s, seg in self.segments.items():
            oseg = other.segments.get(s)
            if oseg is not None:
                out.segments[s] = getattr(seg, op)(oseg)
            elif keep_left_only:
                out.segments[s] = seg
        if op == "union":
            for s, oseg in other.segments.items():
                out.segments.setdefault(s, oseg)
        return out

    def intersect(self, other: "Row") -> "Row":
        return self._binop(other, "intersect", keep_left_only=False)

    def union(self, other: "Row") -> "Row":
        return self._binop(other, "union", keep_left_only=True)

    def difference(self, other: "Row") -> "Row":
        return self._binop(other, "difference", keep_left_only=True)

    def count(self) -> int:
        total = 0
        for s, seg in self.segments.items():
            n = self._counts.get(s)
            if n is None:
                n = self._counts[s] = seg.count()
            total += n
        return total

    def intersection_count(self, other: "Row") -> int:
        """|self ∩ other| from the segments' containers, nothing built."""
        total = 0
        for s, seg in self.segments.items():
            oseg = other.segments.get(s)
            if oseg is not None:
                total += seg.intersection_count(oseg)
        return total

    def columns(self) -> np.ndarray:
        """Absolute column IDs, sorted uint64."""
        parts = [seg.slice() + np.uint64(s * SLICE_WIDTH)
                 for s, seg in sorted(self.segments.items())]
        if not parts:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(parts)
