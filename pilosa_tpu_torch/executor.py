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

TopN runs on the card from exact per-row counts (MeshManager.top_n, K5)
in every argument form; when the card cannot serve it (a src child that
does not lower, filters without a field, a Tanimoto threshold without a
src or above 100) it runs the JAX package's two-phase host TopN over the
fragments' rank caches (`top_n_host`): an approximate pass, then an
exact recount of the candidate ids. `stats["topn_device"]` and
`stats["topn_host"]` show the path.

Within the card's memory governor (MeshManager, parallel/serve.py): a
Count whose plan signature is quarantined, or one of whose views would
alone pass the HBM budget, goes straight to the host fold
(`_route_to_host`, counted in the manager's `routed_host` and
`fallback_<reason>`), and a DeviceResourceError from the manager (the
same causes found later, or out of memory after its evict-and-retry
ladder) sends that one Count, aggregate or TopN to the host path. Any
other device error propagates. `explain()` reports a Count's route and
why, its plan signature and quarantine, its views' formats and what
staging them would take, without running it.

Bitmap and Range calls materialize roaring rows per slice on the host; a
time Range ORs the row over the views that cover [start, end). A root
Bitmap result carries the row's attrs (or the column's, for a column
Bitmap). SetBit (with an optional timestamp) / ClearBit / SetValue write
through the frame; SetRowAttrs / SetColumnAttrs through the attribute
stores.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np

from . import resolve_device
from .bsi import host as bsi_host
from .bsi import lower as bsi_lower
from .bsi.field import ROW_PLANE0, ROW_SIGN, FieldNotFoundError
from .core.cache import add_to_pairs, sort_pairs
from .core.fragment import TopOptions
from .core.index import DEFAULT_COLUMN_LABEL
from .core.row import Row
from .core.timequantum import parse_time, views_by_time_range
from .core.view import VIEW_INVERSE, VIEW_STANDARD
from .errors import DeviceResourceError, FrameNotFoundError, \
    IndexNotFoundError, IndexRequiredError, QueryError
from .parallel.mesh import (DEFAULT_SPARSE_DENSITY_THRESHOLD,
                            format_pool_bytes)
from .parallel.plan import (DEFAULT_FRAME, _lower_tree, _tree_signature,
                            canonical_tree, plan_signature)
from .parallel.serve import mesh_config as mesh_config_check
from .parallel.serve import sparse_shape_kind, view_stats
from .ops.bsi import sum_from_plane_dicts
from .pql import Call, Cond, Query

_BINOPS = {"Intersect": "intersect", "Union": "union",
           "Difference": "difference"}
_BSI_AGGREGATES = ("Sum", "Min", "Max")
_WRITE_CALLS = ("ClearBit", "SetBit", "SetValue", "SetRowAttrs",
                "SetColumnAttrs")

# The host TopN's threshold when none is given (the card path's
# rank_pairs keeps no row under one bit either).
MIN_THRESHOLD = 1


class Executor:
    """Evaluates PQL against a Holder; device work runs on `device`.
    sparse_density_threshold: mean container fill under which a slice
    stages as sorted arrays (<= 0 stages everything dense). mesh_config:
    the manager's [mesh] knobs (parallel.serve.MESH_DEFAULTS)."""

    def __init__(self, holder, device="cuda",
                 sparse_density_threshold: float =
                 DEFAULT_SPARSE_DENSITY_THRESHOLD,
                 mesh_config: Optional[dict] = None):
        self.holder = holder
        self.device = resolve_device(device)
        self.sparse_density_threshold = sparse_density_threshold
        mesh_config_check(mesh_config)  # a bad knob fails here, not later
        self.mesh_config = dict(mesh_config or {})
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
                    sparse_density_threshold=self.sparse_density_threshold,
                    config=self.mesh_config)
            return self._mesh_mgr

    def invalidate_device_index(self, index: Optional[str] = None) -> None:
        """Drop the staged views of `index` (or all) and free their card
        memory now: the handler calls it when an index or frame is
        deleted. A later query restages from the holder."""
        if self._mesh_mgr is not None:
            self._mesh_mgr.invalidate(index)

    def execute(self, index: str, q: Query,
                slices: Optional[Sequence[int]] = None) -> list:
        """Execute each call in order; one result per call. With `slices`
        given, a Bitmap is taken as a column Bitmap when it names the
        default column label ("columnID"), and it then reads no slice;
        without them, by the index's own label over the inverse view's
        slices (as the JAX package does)."""
        if not index:
            raise IndexRequiredError()
        idx = self.holder.index(index)
        need = any(c.name not in _WRITE_CALLS for c in q.calls)
        column_label = DEFAULT_COLUMN_LABEL
        defaulted = False
        if slices:
            slices = list(slices)
        else:
            slices = []
            if need:
                if idx is None:
                    raise IndexNotFoundError()
                defaulted = True
                slices = list(range(idx.max_slice() + 1))
                column_label = idx.column_label
        if q.calls and all(c.name == "SetRowAttrs" for c in q.calls):
            return self._execute_bulk_set_row_attrs(index, q.calls)
        results = []
        for call in q.calls:
            call_slices = slices
            if call.name == "Bitmap" and need:
                f = self.holder.frame(index,
                                      call.args.get("frame") or DEFAULT_FRAME)
                if f is None:
                    raise FrameNotFoundError()
                if call.is_inverse(f.row_label, column_label):
                    call_slices = (list(range(idx.max_inverse_slice() + 1))
                                   if defaulted else [])
            results.append(self._execute_call(index, call, call_slices))
        return results

    def _execute_call(self, index: str, c: Call, slices: List[int]):
        if c.name == "Count":
            return self._execute_count(index, c, slices)
        if c.name == "SetBit":
            f, row_id, col_id = self._bit_args(index, c)
            ts = c.args.get("timestamp")
            t = None
            if isinstance(ts, str):
                try:
                    t = parse_time(ts)
                except ValueError:
                    raise QueryError(f"invalid date: {ts}") from None
            return f.set_bit(row_id, col_id, t)
        if c.name == "ClearBit":
            f, row_id, col_id = self._bit_args(index, c)
            return f.clear_bit(row_id, col_id)
        if c.name == "SetValue":
            return self._execute_set_value(index, c)
        if c.name in _BSI_AGGREGATES:
            return self._execute_bsi_aggregate(index, c, slices)
        if c.name == "TopN":
            return self._execute_top_n(index, c, slices)
        if c.name == "SetRowAttrs":
            return self._execute_bulk_set_row_attrs(index, [c])[0]
        if c.name == "SetColumnAttrs":
            return self._execute_set_column_attrs(index, c)
        row = Row()
        for s in slices:
            row.merge(self._bitmap_slice(index, c, s))
        if c.name == "Bitmap":
            row.attrs = self._bitmap_attrs(index, c)
        return row

    def _bitmap_attrs(self, index: str, c: Call) -> dict:
        """The attrs of a root Bitmap: the column's when it names the
        index's column label, else the row's."""
        idx = self.holder.index(index)
        if idx is None:
            return {}
        col_id, col_ok = c.uint_arg(idx.column_label)
        if col_ok:
            return idx.column_attr_store.attrs(col_id)
        f = idx.frame(c.args.get("frame") or DEFAULT_FRAME)
        if f is None:
            return {}
        row_id, _ = c.uint_arg(f.row_label)
        return f.row_attr_store.attrs(row_id)

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
        """Range over one slice: with a field comparison (frame=f,
        field <op> N) the plane ladder folded over the field's bsi
        fragment; else the time Range (frame=f, rowID=r, start=...,
        end=...), the row ORed over the views that cover [start, end),
        empty when the frame has no time quantum."""
        frame = c.args.get("frame") or DEFAULT_FRAME
        f = self.holder.frame(index, frame)
        if f is None:
            raise FrameNotFoundError()
        conds = [k for k, v in c.args.items() if isinstance(v, Cond)]
        if len(conds) > 1:
            raise QueryError(f"{c.name}() accepts one field comparison, "
                             f"got {len(conds)}")
        if conds:
            fname, cond = conds[0], c.args[conds[0]]
            schema = f.bsi_field(fname)
            if schema is None:
                raise FieldNotFoundError(frame, fname)
            frag = self.holder.fragment(index, frame, schema.view, slice_)
            return bsi_host.range_row(frag, schema, cond.op, cond.value)
        row_id, _ = c.uint_arg(f.row_label)
        start, end = c.args.get("start"), c.args.get("end")
        if not isinstance(start, str):
            raise QueryError("Range() start time required")
        if not isinstance(end, str):
            raise QueryError("Range() end time required")
        try:
            start_t, end_t = parse_time(start), parse_time(end)
        except ValueError:
            raise QueryError("cannot parse Range() time") from None
        q = f.time_quantum
        if not str(q):
            return Row()
        out = Row()
        for vname in views_by_time_range(VIEW_STANDARD, start_t, end_t, q):
            frag = self.holder.fragment(index, frame, vname, slice_)
            if frag is not None:
                out = out.union(frag.row(row_id))
        return out

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
            num = self._num_slices(index, slices)
            sig = plan_signature(shape)
            if not self._route_to_host(index, leaves, num, sig):
                n = self._on_card(self.mesh_manager().count, index, shape,
                                  leaves, slices, num, sig)
                if n is not None:
                    self._inc("count_device")
                    return n
        self._inc("count_host")
        return sum(self._bitmap_slice(index, child, s).count()
                   for s in slices)

    @staticmethod
    def _on_card(fn, *args):
        """fn(*args), or None when the card cannot serve it for want of
        memory or for a quarantined plan (a DeviceResourceError, which
        the manager counted): the caller then answers on the host, out of
        this handler, so the error's traceback holds no card memory
        meanwhile."""
        try:
            return fn(*args)
        except DeviceResourceError:
            return None

    def explain(self, index: str, q: Query,
                slices: Optional[Sequence[int]] = None) -> dict:
        """The planned execution of `q`, run nowhere: for each Count, its
        route ("mesh", "host-fold" with its `route_reason`, or "roaring"
        for a tree that does not lower), its `plan` {signature,
        quarantined}, the resident format of each leaf's view
        (`device_format`) and what staging the others would take
        (`staging`). No view stages and no counter moves. Serves POST
        /index/{index}/query?explain=true (the JAX package's
        Executor.explain, pilosa_tpu/executor.py:1366-1505, without
        placement, cluster and calibration)."""
        if not index:
            raise IndexRequiredError()
        idx = self.holder.index(index)
        if slices:
            slices = list(slices)
        else:
            slices = []
            if any(c.name not in _WRITE_CALLS for c in q.calls):
                if idx is None:
                    raise IndexNotFoundError()
                slices = list(range(idx.max_slice() + 1))
        return {"index": index, "slices": len(slices),
                "calls": [self._explain_call(index, c, slices)
                          for c in q.calls]}

    def _explain_call(self, index: str, c: Call, slices: List[int]) -> dict:
        info: dict = {"call": c.name}
        if c.name in _WRITE_CALLS:
            info["route"] = "write"
            return info
        if c.name != "Count" or len(c.children) != 1 or not slices:
            return info
        leaves: list = []
        shape = _lower_tree(self.holder, index, c.children[0], leaves)
        if shape is None or not leaves:
            info["route"] = "roaring"
            return info
        sig = plan_signature(shape)
        num = self._num_slices(index, slices)
        reason = self._would_route_to_host(index, leaves, num, sig)
        info["route"] = "host-fold" if reason else "mesh"
        if reason:
            info["route_reason"] = reason
        mgr = self._mesh_mgr
        info["plan"] = {"signature": sig, "quarantined":
                        mgr is not None and mgr.plan_quarantined(sig)}
        keys = list(dict.fromkeys((f, v) for f, v, _r, _q in leaves))
        resident = (dict(zip(keys, mgr.describe_views(index, keys)))
                    if mgr is not None else dict.fromkeys(keys))
        if mgr is not None:
            info["device_format"] = self._explain_format(leaves, shape,
                                                         resident)
        info["staging"] = self._explain_staging(index, keys, num, resident)
        return info

    @staticmethod
    def _explain_format(leaves, shape, resident: dict) -> dict:
        """Each leaf's resident format ("unstaged" when its view is not
        staged) and, where one is sorted-array, whether the format groups
        serve the tree (pilosa_tpu/executor.py:1575). `resident`: (frame,
        view) -> MeshManager.describe_views' format."""
        fmts = [resident[(f, v)] or "unstaged" for f, v, _r, _q in leaves]
        out: dict = {"leaves": fmts}
        if any(f in ("sparse", "mixed") for f in fmts):
            out["sparse_shape"] = (sparse_shape_kind(_tree_signature(shape))
                                   or "unsupported")
        return out

    def _explain_staging(self, index: str, keys, num_slices: int,
                         resident: dict) -> dict:
        """The Count's views (`keys`, (frame, view) pairs): resident ones
        with their format, the others with the format their staging would
        pick and the bytes it would allocate on the card, which are also
        the bytes it copies there (pilosa_tpu/executor.py:1612)."""
        mgr = self._mesh_mgr
        staged = unstaged = est = 0
        views: list = []
        for frame, view in keys:
            if resident[(frame, view)] is not None:
                staged += 1
                views.append({"frame": frame, "view": view,
                              "resident": True,
                              "format": resident[(frame, view)]})
                continue
            unstaged += 1
            stats, formats = (
                mgr.view_stats(index, frame, view, num_slices)
                if mgr is not None else
                view_stats(self.holder, index, frame, view, num_slices,
                           float(self.sparse_density_threshold)))
            vb = format_pool_bytes(stats, formats)
            est += vb
            n_sparse = int(formats.sum())
            n_live = int(np.count_nonzero(stats[:, 0]))
            views.append({
                "frame": frame, "view": view, "resident": False,
                "format": ("mixed" if 0 < n_sparse < n_live
                           else "sparse" if n_sparse else "dense"),
                "sparse_slices": n_sparse, "estimated_h2d_bytes": vb})
        return {"staged_views": staged, "unstaged_views": unstaged,
                "estimated_h2d_bytes": est,
                "sparse_density_threshold": self.sparse_density_threshold,
                "views": views}

    def _would_route_to_host(self, index: str, leaves, num_slices: int,
                             sig: str) -> Optional[str]:
        """The routing reason of a Count, or None: "quarantined" when its
        plan signature is, "hbm_infeasible" when one of its views would
        alone pass the HBM budget. The resilience half of the JAX
        package's (pilosa_tpu/executor.py:1951-1970): the port has no
        cost routing. It asks an existing manager only (without one
        nothing is staged or quarantined) and changes nothing."""
        mgr = self._mesh_mgr
        if mgr is None:
            return None
        if mgr.plan_quarantined(sig):
            return "quarantined"
        if mgr.stage_infeasible(index, leaves, num_slices):
            return "hbm_infeasible"
        return None

    def _route_to_host(self, index: str, leaves, num_slices: int,
                       sig: str) -> Optional[str]:
        """_would_route_to_host, counted in the manager's `routed_host`
        and `fallback_<reason>`."""
        reason = self._would_route_to_host(index, leaves, num_slices, sig)
        if reason:
            self._mesh_mgr._inc("routed_host")
            self._mesh_mgr._inc(f"fallback_{reason}")
        return reason

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
            except (_Unstaged, DeviceResourceError):
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

    # -- TopN --------------------------------------------------------------

    def _execute_top_n(self, index: str, c: Call, slices: List[int]):
        """TopN from exact per-row counts on the card (MeshManager.top_n)
        or, when the card cannot serve its form, top_n_host."""
        pairs = (self._on_card(self._top_n_device, index, c, slices)
                 if slices else None)
        if pairs is not None:
            self._inc("topn_device")
            return pairs
        self._inc("topn_host")
        return self.top_n_host(index, c, slices)

    def _top_n_device(self, index: str, c: Call, slices: List[int]):
        """MeshManager.top_n for every form of the call, or None for the
        forms the host path serves (and reports the errors of): a src
        that does not lower, filters without a field, a Tanimoto
        threshold above 100 or without a src."""
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if tanimoto > 100:
            return None
        frame = c.args.get("frame") or DEFAULT_FRAME
        attr_predicate = None
        filters = c.args.get("filters")
        field = c.args.get("field") or ""
        if filters and field:
            f = self.holder.frame(index, frame)
            if f is None:
                return None
            store, allowed = f.row_attr_store, set(filters)

            def attr_predicate(row_id):
                attr = store.attrs(row_id)
                return bool(attr) and attr.get(field) in allowed
        elif filters:
            return None
        if tanimoto and not c.children:
            return None
        src = None
        if c.children:
            if len(c.children) > 1:
                return None
            leaves: list = []
            tree = _lower_tree(self.holder, index, c.children[0], leaves)
            if tree is None or not leaves:
                return None
            src = (tree, leaves)
        n, _ = c.uint_arg("n")
        row_ids, _ = c.uint_slice_arg("ids")
        min_threshold, _ = c.uint_arg("threshold")
        return self.mesh_manager().top_n(
            index, frame, VIEW_STANDARD, slices,
            self._num_slices(index, slices), 0 if row_ids else n, row_ids,
            min_threshold, src=src,
            attr_predicate=attr_predicate, tanimoto_threshold=tanimoto)

    def top_n_host(self, index: str, c: Call, slices: List[int]):
        """The JAX package's host TopN: each slice's top pairs from its
        rank cache, summed by id; then, unless ids were asked for, an
        exact recount of those candidate ids, trimmed to n."""
        row_ids, _ = c.uint_slice_arg("ids")
        n, _ = c.uint_arg("n")
        pairs = self._top_n_host_slices(index, c, slices)
        if not pairs or row_ids:
            return pairs
        other = c.clone()
        other.args["ids"] = sorted(p[0] for p in pairs)
        trimmed = self._top_n_host_slices(index, other, slices)
        return trimmed[:n] if n and n < len(trimmed) else trimmed

    def _top_n_host_slices(self, index: str, c: Call, slices: List[int]):
        pairs: list = []
        for s in slices:
            pairs = add_to_pairs(pairs, self._top_n_slice(index, c, s))
        return sort_pairs(pairs)

    def _top_n_slice(self, index: str, c: Call, slice_: int):
        """One slice of the host TopN (Fragment.top)."""
        frame = c.args.get("frame") or DEFAULT_FRAME
        n, _ = c.uint_arg("n")
        field = c.args.get("field") or ""
        row_ids, _ = c.uint_slice_arg("ids")
        min_threshold, _ = c.uint_arg("threshold")
        filters = c.args.get("filters") or []
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        src = None
        if len(c.children) == 1:
            src = self._bitmap_slice(index, c.children[0], slice_)
        elif len(c.children) > 1:
            raise QueryError("TopN() can only have one input bitmap")
        frag = self.holder.fragment(index, frame, VIEW_STANDARD, slice_)
        if frag is None:
            return []
        if tanimoto > 100:
            raise QueryError("Tanimoto Threshold is from 1 to 100 only")
        return frag.top(TopOptions(
            n=n, src=src, row_ids=row_ids,
            min_threshold=min_threshold or MIN_THRESHOLD,
            filter_field=field, filter_values=filters,
            tanimoto_threshold=tanimoto))

    # -- attribute writes ----------------------------------------------------

    def _execute_bulk_set_row_attrs(self, index: str, calls) -> list:
        """SetRowAttrs(frame=f, rowID=r, key=value, ...) calls, merged per
        frame and written to each frame's row store in one
        transaction."""
        by_frame: dict = {}
        for c in calls:
            frame = c.args.get("frame")
            if not isinstance(frame, str):
                raise QueryError("SetRowAttrs() frame required")
            f = self.holder.frame(index, frame)
            if f is None:
                raise FrameNotFoundError()
            row_id, ok = c.uint_arg(f.row_label)
            if not ok:
                raise QueryError(
                    f"SetRowAttrs() row field '{f.row_label}' required")
            attrs = dict(c.args)
            attrs.pop("frame", None)
            attrs.pop(f.row_label, None)
            by_frame.setdefault(frame, {}).setdefault(row_id, {}).update(
                attrs)
        for frame, items in by_frame.items():
            self.holder.frame(index, frame).row_attr_store.set_bulk_attrs(
                items)
        return [None] * len(calls)

    def _execute_set_column_attrs(self, index: str, c: Call):
        """SetColumnAttrs(id=N or <column label>=N, key=value, ...)."""
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        id_, ok = c.uint_arg("id")
        col_name = "id"
        if not ok:
            id_, ok = c.uint_arg(idx.column_label)
            if not ok:
                raise QueryError("SetColumnAttrs() id required")
            col_name = idx.column_label
        attrs = dict(c.args)
        attrs.pop(col_name, None)
        idx.column_attr_store.set_attrs(id_, attrs)
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
