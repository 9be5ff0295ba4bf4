"""Row: a query-level bitmap spanning many slices (slice -> slice-local
roaring bitmap)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import SLICE_WIDTH
from ..roaring import Bitmap


class Row:
    """Segmented bitmap over the global column space."""

    __slots__ = ("segments", "attrs")

    def __init__(self):
        self.segments: Dict[int, Bitmap] = {}
        self.attrs: dict = {}

    @classmethod
    def from_segment(cls, slice_: int, bitmap: Bitmap) -> "Row":
        r = cls()
        r.segments[slice_] = bitmap
        return r

    def merge(self, other: "Row") -> None:
        """Union `other` into self."""
        for s, seg in other.segments.items():
            mine = self.segments.get(s)
            self.segments[s] = seg if mine is None else mine.union(seg)

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
        return sum(seg.count() for seg in self.segments.values())

    def intersection_count(self, other: "Row") -> int:
        return self.intersect(other).count()

    def columns(self) -> np.ndarray:
        """Absolute column IDs, sorted uint64."""
        parts = [seg.slice() + np.uint64(s * SLICE_WIDTH)
                 for s, seg in sorted(self.segments.items())]
        if not parts:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(parts)
