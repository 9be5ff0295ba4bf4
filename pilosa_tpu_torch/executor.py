"""Executor: PQL evaluation over a Holder.

Count over a lowerable Bitmap / Intersect / Union / Difference / Range
tree goes to the card through MeshManager.count: on the card every
lowerable Count runs a kernel, with no cost routing to the host.
Unlowerable trees (and views that cannot be staged) count on the host
from roaring rows, which `stats["count_host"]` shows.

Sum / Min / Max over an integer field (optionally filtered by one bitmap
child) run on the card too: Sum from the per-row counts of the field's
bsi view (MeshManager.bsi_plane_counts, K5), with a second pass over the
sign row only when the first saw negatives; Min / Max as an MSB-down
search over the magnitude planes, one tree count per probe. A filter
that does not lower sends the aggregate to the host folds of bsi.host
(`stats["bsi_host"]`).

Bitmap and Range calls materialize roaring rows per slice on the host;
SetBit / ClearBit / SetValue write through the frame.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import List, Optional, Sequence

from . import resolve_device
from .bsi import host as bsi_host
from .bsi import lower as bsi_lower
from .bsi.field import ROW_PLANE0, ROW_SIGN, FieldNotFoundError
from .core.row import Row
from .core.view import VIEW_INVERSE, VIEW_STANDARD
from .errors import FrameNotFoundError, IndexNotFoundError, \
    IndexRequiredError, QueryError
from .parallel.mesh import DEFAULT_SPARSE_DENSITY_THRESHOLD
from .parallel.plan import DEFAULT_FRAME, _lower_tree, canonical_tree
from .ops.bsi import sum_from_plane_dicts
from .pql import Call, Query

_BINOPS = {"Intersect": "intersect", "Union": "union",
           "Difference": "difference"}
_BSI_AGGREGATES = ("Sum", "Min", "Max")


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
        if c.name == "SetValue":
            return self._execute_set_value(index, c)
        if c.name in _BSI_AGGREGATES:
            return self._execute_bsi_aggregate(index, c, slices)
        row = Row()
        for s in slices:
            row.merge(self._bitmap_slice(index, c, s))
        return row

    # -- bitmap calls (host) -------------------------------------------------

    def _bitmap_slice(self, index: str, c: Call, slice_: int) -> Row:
        if c.name == "Bitmap":
            return self._bitmap_leaf_slice(index, c, slice_)
        if c.name == "Range":
            return self._range_slice(index, c, slice_)
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

    def _range_slice(self, index: str, c: Call, slice_: int) -> Row:
        """Range(frame=f, field <op> N) over one slice: the plane ladder
        folded over the field's bsi fragment. Time-quantum Range
        (start/end) is not ported."""
        frame = c.args.get("frame") or DEFAULT_FRAME
        f = self.holder.frame(index, frame)
        if f is None:
            raise FrameNotFoundError()
        fc = bsi_lower.field_cond(c)
        if fc is None:
            raise QueryError(f"{c.name}() needs one field comparison (time "
                             f"ranges are not served by this port)")
        fname, cond = fc
        schema = f.bsi_field(fname)
        if schema is None:
            raise FieldNotFoundError(frame, fname)
        frag = self.holder.fragment(index, frame, schema.view, slice_)
        return bsi_host.range_row(frag, schema, cond.op, cond.value)

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
            n = self.mesh_manager().count(index, shape, leaves, slices,
                                          self._num_slices(index, slices))
            if n is not None:
                self._inc("count_device")
                return n
        self._inc("count_host")
        return sum(self._bitmap_slice(index, child, s).count()
                   for s in slices)

    def _num_slices(self, index: str, slices: List[int]) -> int:
        return max(max(slices), self.holder.index(index).max_slice()) + 1

    # -- integer-field aggregates ----------------------------------------------

    def _bsi_call_schema(self, index: str, c: Call):
        """(frame name, FieldSchema) of a Sum/Min/Max call; raises the
        NotFound errors the handler maps to 404."""
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        frame = c.args.get("frame") or DEFAULT_FRAME
        f = idx.frame(frame)
        if f is None:
            raise FrameNotFoundError()
        field = c.args.get("field")
        if not isinstance(field, str) or not field:
            raise QueryError(f"{c.name}() field required")
        schema = f.bsi_field(field)
        if schema is None:
            raise FieldNotFoundError(frame, field)
        return frame, schema

    def _execute_bsi_aggregate(self, index: str, c: Call, slices: List[int]):
        """Sum / Min / Max over an integer field with an optional bitmap
        filter child. Sum answers {"value", "count"} ({0, 0} when no
        column holds a value), Min / Max the extremum and how many
        columns hold it, or None when no column holds a value."""
        frame, schema = self._bsi_call_schema(index, c)
        if len(c.children) > 1:
            raise QueryError(
                f"{c.name}() only accepts a single bitmap input")
        child = c.children[0] if c.children else None
        filt = None
        if child is not None and slices:
            fleaves: list = []
            ftree = _lower_tree(self.holder, index, child, fleaves)
            filt = (ftree, fleaves) if ftree is not None else None
        on_card = bool(slices) and (child is None or filt is not None)
        if on_card:
            num = self._num_slices(index, slices)
            try:
                if c.name == "Sum":
                    out = self._bsi_sum_device(index, frame, schema, filt,
                                               slices, num)
                else:
                    out = self._bsi_extremum_device(
                        index, frame, schema, filt, slices, num,
                        c.name == "Max")
            except _Unstaged:
                on_card = False
        self._inc("bsi_device" if on_card else "bsi_host")
        if not on_card:
            out = self._bsi_host(index, frame, schema, c, child, slices)
        if c.name == "Sum":
            s, n = out if out is not None else (0, 0)
            return {"value": int(s), "count": int(n)}
        return None if out is None else {"value": int(out[0]),
                                         "count": int(out[1])}

    def _bsi_host(self, index, frame, schema, c, child, slices):
        parts = []
        for s in slices:
            frag = self.holder.fragment(index, frame, schema.view, s)
            filt = (self._bitmap_slice(index, child, s)
                    if child is not None else None)
            if c.name == "Sum":
                parts.append(bsi_host.sum_slice(frag, schema, filt))
            elif c.name == "Max":
                parts.append(bsi_host.max_slice(frag, schema, filt))
            else:
                parts.append(bsi_host.min_slice(frag, schema, filt))
        if c.name == "Sum":
            return (sum(v for v, _ in parts), sum(n for _, n in parts))
        return bsi_host.reduce_extremes(parts, c.name == "Max")

    def _bsi_sum_device(self, index, frame, schema, filt, slices, num):
        """(sum, count) from the per-row counts of the bsi view; the sign
        pass (planes against sign AND filter) runs only when the first
        pass counted negatives. Raises _Unstaged when a view cannot be
        staged."""
        mgr = self.mesh_manager()
        view = schema.view
        counts = mgr.bsi_plane_counts(index, frame, view, slices, num,
                                      src=filt)
        if counts is None:
            raise _Unstaged()
        neg: dict = {}
        if counts.get(ROW_SIGN, 0):
            sign = (frame, view, ROW_SIGN, False)
            src = ((["leaf", 0], [sign]) if filt is None else
                   (["and", filt[0], ["leaf", len(filt[1])]],
                    list(filt[1]) + [sign]))
            neg = mgr.bsi_plane_counts(
                index, frame, view, slices, num, src=src,
                rows=range(ROW_PLANE0, ROW_PLANE0 + schema.bit_depth))
            if neg is None:
                raise _Unstaged()
        return sum_from_plane_dicts(counts, neg, schema.bit_depth)

    def _bsi_extremum_device(self, index, frame, schema, filt, slices, num,
                             maximize: bool):
        """(value, count) or None (no values) by an MSB-down search of the
        magnitude planes, each probe one MeshManager.count of a candidate
        tree (ANDed with the filter). Raises _Unstaged when a view cannot
        be staged or a tree does not fit the kernels."""
        mgr = self.mesh_manager()
        view = schema.view

        def count_tree(tree):
            raw: list = []
            shape = bsi_lower.to_shape(tree, frame, view, raw)
            if filt is not None:
                shape = ["and", shape, _unnumber(filt[0], filt[1], raw)]
            leaves: list = []
            tree = canonical_tree(shape, raw, leaves)
            n = (None if tree is None else
                 mgr.count(index, tree, leaves, slices, num))
            if n is None:
                raise _Unstaged()
            return n

        def search(cand, big_mag: bool):
            mag = 0
            for k in range(schema.bit_depth - 1, -1, -1):
                p = bsi_lower.leaf(ROW_PLANE0 + k)
                inter = bsi_lower.t_and(cand, p)
                if big_mag:
                    if count_tree(inter):
                        cand, mag = inter, mag | (1 << k)
                else:
                    rest = bsi_lower.t_andnot(cand, p)
                    if count_tree(rest):
                        cand = rest
                    else:
                        cand, mag = inter, mag | (1 << k)
            return mag, count_tree(cand)

        n_pos = count_tree(bsi_lower.POS)
        n_neg = count_tree(bsi_lower.NEG)
        sides = ((n_pos, bsi_lower.POS, 1), (n_neg, bsi_lower.NEG, -1))
        if not maximize:
            sides = sides[::-1]
        for n_side, base, sign in sides:
            if n_side:
                # max: positives hold the largest magnitude, negatives the
                # smallest; min mirrors.
                mag, n = search(base, big_mag=(sign > 0) == maximize)
                return sign * mag, n
        return None

    # -- writes --------------------------------------------------------------

    def _execute_set_value(self, index: str, c: Call) -> bool:
        """SetValue(frame=f, columnID=N, <field>=V): overwrite a column's
        integer value. Validated before anything is written: 404 for an
        unknown field, 422 for a value outside its range."""
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        frame = c.args.get("frame")
        if not isinstance(frame, str):
            raise QueryError("SetValue() frame required")
        f = idx.frame(frame)
        if f is None:
            raise FrameNotFoundError()
        col_id, ok = c.uint_arg(idx.column_label)
        if not ok:
            raise QueryError(
                f"SetValue() column field '{idx.column_label}' required")
        fields = [(k, v) for k, v in c.args.items()
                  if k not in ("frame", idx.column_label)]
        if len(fields) != 1:
            raise QueryError(
                "SetValue() requires exactly one field=value pair")
        fname, value = fields[0]
        if isinstance(value, bool) or not isinstance(value, int):
            raise QueryError(f"SetValue() field '{fname}' must be an int")
        schema = f.bsi_field(fname)
        if schema is None:
            raise FieldNotFoundError(frame, fname)
        schema.validate(value)
        return f.set_value(fname, col_id, value)

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


class _Unstaged(Exception):
    """An aggregate the card cannot serve (a view that cannot be staged,
    a filter or tree beyond the kernels): it goes to the host folds."""


def _unnumber(tree, leaves, raw: list):
    """A numbered tree over `leaves` as a lowered shape, appending its
    leaves to `raw` depth-first (the input form of canonical_tree)."""
    if tree[0] == "leaf":
        raw.append(leaves[tree[1]])
        return ["leaf"]
    return [tree[0]] + [_unnumber(c, leaves, raw) for c in tree[1:]]
