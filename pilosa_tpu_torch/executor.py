"""Executor: PQL evaluation over a Holder.

Count over a lowerable Bitmap / Intersect / Union / Difference tree goes
to the card through MeshManager.count: on the card every lowerable Count
runs a kernel, with no cost routing to the host. Unlowerable trees (and
views that cannot be staged) count on the host from roaring rows, which
`stats["count_host"]` shows. Bitmap calls materialize roaring rows per
slice on the host; SetBit / ClearBit write through the frame.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import List, Optional, Sequence

from . import resolve_device
from .core.row import Row
from .core.view import VIEW_INVERSE, VIEW_STANDARD
from .errors import FrameNotFoundError, IndexNotFoundError, \
    IndexRequiredError, QueryError
from .parallel.mesh import DEFAULT_SPARSE_DENSITY_THRESHOLD
from .parallel.plan import DEFAULT_FRAME, _lower_tree
from .pql import Call, Query

_BINOPS = {"Intersect": "intersect", "Union": "union",
           "Difference": "difference"}


class Executor:
    """Evaluates PQL against a Holder; device work runs on `device`.
    sparse_density_threshold: mean container fill under which a slice
    stages as sorted arrays (<= 0 stages everything dense)."""

    def __init__(self, holder, device="cuda",
                 sparse_density_threshold: float =
                 DEFAULT_SPARSE_DENSITY_THRESHOLD):
        self.holder = holder
        self.device = resolve_device(device)
        self.sparse_density_threshold = sparse_density_threshold
        self._mesh_mgr = None
        self._mesh_mu = threading.Lock()
        self._stats_mu = threading.Lock()
        self.stats: Counter = Counter()

    def _inc(self, key: str) -> None:
        with self._stats_mu:
            self.stats[key] += 1

    def mesh_manager(self):
        with self._mesh_mu:
            if self._mesh_mgr is None:
                from .parallel.serve import MeshManager

                self._mesh_mgr = MeshManager(
                    self.holder, self.device,
                    sparse_density_threshold=self.sparse_density_threshold)
            return self._mesh_mgr

    def execute(self, index: str, q: Query,
                slices: Optional[Sequence[int]] = None) -> list:
        """Execute each call in order; one result per call."""
        if not index:
            raise IndexRequiredError()
        idx = self.holder.index(index)
        if slices:
            slices = list(slices)
            inverse_slices = []
        else:
            if idx is None:
                raise IndexNotFoundError()
            slices = list(range(idx.max_slice() + 1))
            inverse_slices = list(range(idx.max_inverse_slice() + 1))
        results = []
        for call in q.calls:
            call_slices = slices
            if call.name == "Bitmap" and idx is not None:
                f = idx.frame(call.args.get("frame") or DEFAULT_FRAME)
                if f is None:
                    raise FrameNotFoundError()
                if call.is_inverse(f.row_label, idx.column_label):
                    call_slices = inverse_slices
            results.append(self._execute_call(index, call, call_slices))
        return results

    def _execute_call(self, index: str, c: Call, slices: List[int]):
        if c.name == "Count":
            return self._execute_count(index, c, slices)
        if c.name == "SetBit":
            f, row_id, col_id = self._bit_args(index, c)
            return f.set_bit(row_id, col_id)
        if c.name == "ClearBit":
            f, row_id, col_id = self._bit_args(index, c)
            return f.clear_bit(row_id, col_id)
        row = Row()
        for s in slices:
            row.merge(self._bitmap_slice(index, c, s))
        return row

    # -- bitmap calls (host) -------------------------------------------------

    def _bitmap_slice(self, index: str, c: Call, slice_: int) -> Row:
        if c.name == "Bitmap":
            return self._bitmap_leaf_slice(index, c, slice_)
        op = _BINOPS.get(c.name)
        if op is None:
            raise QueryError(f"unknown call: {c.name}")
        if not c.children:
            if op == "union":
                return Row()
            raise QueryError(
                f"empty {c.name} query is currently not supported")
        out = None
        for child in c.children:
            row = self._bitmap_slice(index, child, slice_)
            out = row if out is None else getattr(out, op)(row)
        return out

    def _bitmap_leaf_slice(self, index: str, c: Call, slice_: int) -> Row:
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        frame = c.args.get("frame") or DEFAULT_FRAME
        f = idx.frame(frame)
        if f is None:
            raise FrameNotFoundError()
        row_id, row_ok = c.uint_arg(f.row_label)
        col_id, col_ok = c.uint_arg(idx.column_label)
        if row_ok and col_ok:
            raise QueryError(f"Bitmap() cannot specify both {f.row_label} "
                             f"and {idx.column_label} values")
        if not row_ok and not col_ok:
            raise QueryError(f"Bitmap() must specify either {f.row_label} "
                             f"or {idx.column_label} values")
        view, id_ = VIEW_STANDARD, row_id
        if col_ok:
            if not f.inverse_enabled:
                raise QueryError("Bitmap() cannot retrieve columns unless "
                                 "inverse storage enabled")
            view, id_ = VIEW_INVERSE, col_id
        frag = self.holder.fragment(index, frame, view, slice_)
        return frag.row(id_) if frag is not None else Row()

    # -- count ---------------------------------------------------------------

    def _execute_count(self, index: str, c: Call, slices: List[int]) -> int:
        if not c.children:
            raise QueryError("Count() requires an input bitmap")
        if len(c.children) > 1:
            raise QueryError("Count() only accepts a single bitmap input")
        child = c.children[0]
        leaves: list = []
        shape = _lower_tree(self.holder, index, child, leaves)
        if shape is not None and slices:
            idx = self.holder.index(index)
            num_slices = max(max(slices), idx.max_slice()) + 1
            n = self.mesh_manager().count(index, shape, leaves, slices,
                                          num_slices)
            if n is not None:
                self._inc("count_device")
                return n
        self._inc("count_host")
        return sum(self._bitmap_slice(index, child, s).count()
                   for s in slices)

    # -- writes --------------------------------------------------------------

    def _bit_args(self, index: str, c: Call):
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        frame = c.args.get("frame")
        if not isinstance(frame, str):
            raise QueryError(f"{c.name}() frame required")
        f = idx.frame(frame)
        if f is None:
            raise FrameNotFoundError()
        row_id, ok = c.uint_arg(f.row_label)
        if not ok:
            raise QueryError(f"{c.name}() row field '{f.row_label}' required")
        col_id, ok = c.uint_arg(idx.column_label)
        if not ok:
            raise QueryError(
                f"{c.name}() column field '{idx.column_label}' required")
        return f, row_id, col_id
