"""Frame: a table of rows owning its views and its row attribute store
(`attrs.db`), with the JSON `.meta` the JAX package writes (rowLabel,
inverseEnabled, cacheType, cacheSize, timeQuantum, fields). Integer
fields live in `bsi.<field>` views. A bit written with a timestamp also
lands in the time views of the frame's quantum ("standard_2017", ...)
and, with inverse storage, in their inverse twins. `import_bits` splits a
bulk load into those views and their slices."""

from __future__ import annotations

import json
import os
import re
import threading
from datetime import datetime
from typing import Dict, Optional, Sequence

import numpy as np

from .. import SLICE_WIDTH
from ..bsi.field import FieldNotFoundError, FieldSchema, FieldValueError
from .attr import AttrStore
from .cache import CACHE_TYPE_RANKED, DEFAULT_CACHE_SIZE
from .timequantum import TimeQuantum, views_by_time
from .view import VIEW_INVERSE, VIEW_STANDARD, View

DEFAULT_ROW_LABEL = "rowID"

_NAME_RE = re.compile(r"^[a-z][a-z0-9_-]{0,64}$")


def validate_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise ValueError(f"invalid index or frame's name: {name!r}")
    return name


class Frame:
    def __init__(self, path: str, index: str, name: str,
                 row_label: str = DEFAULT_ROW_LABEL,
                 inverse_enabled: bool = False,
                 cache_type: str = CACHE_TYPE_RANKED,
                 cache_size: int = DEFAULT_CACHE_SIZE,
                 time_quantum: str = "",
                 fields: Optional[Sequence] = None, wal=None):
        validate_name(name)
        self.path = path
        self.wal = wal  # core/wal.WalConfig, or None: never
        self.index = index
        self.name = name
        self.meta = {"rowLabel": row_label,
                     "inverseEnabled": bool(inverse_enabled),
                     "cacheType": cache_type, "cacheSize": cache_size,
                     "timeQuantum": str(time_quantum), "fields": []}
        self.fields: Dict[str, FieldSchema] = _coerce_fields(fields)
        self.views: Dict[str, View] = {}
        self._create_mu = threading.Lock()
        self.row_attr_store = AttrStore(os.path.join(path, "attrs.db"))

    @property
    def row_label(self) -> str:
        return self.meta["rowLabel"]

    @property
    def inverse_enabled(self) -> bool:
        return bool(self.meta["inverseEnabled"])

    @property
    def time_quantum(self) -> TimeQuantum:
        return TimeQuantum(self.meta["timeQuantum"])

    @property
    def meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    def open(self):
        os.makedirs(self.path, exist_ok=True)
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                self.meta.update(json.load(f))
            if self.meta.get("fields"):
                # Disk wins over the constructor, as for every meta key.
                self.fields = _coerce_fields(self.meta["fields"])
        else:
            self._save_meta()
        self.row_attr_store.open()
        for name in sorted(os.listdir(self.path)):
            if os.path.isdir(os.path.join(self.path, name)):
                self._open_view(name)

    def close(self):
        for v in self.views.values():
            v.close()
        self.views = {}
        self.row_attr_store.close()

    def set_time_quantum(self, q: TimeQuantum):
        self.meta["timeQuantum"] = str(q)
        self._save_meta()

    def _meta_doc(self) -> dict:
        return {**self.meta, "fields": [
            s.to_dict() for _, s in sorted(self.fields.items())]}

    def _save_meta(self):
        with open(self.meta_path, "w") as f:
            json.dump(self._meta_doc(), f)

    # -- integer fields ------------------------------------------------------

    def bsi_field(self, name: str) -> Optional[FieldSchema]:
        return self.fields.get(name)

    def create_field_if_not_exists(self, schema: FieldSchema) -> FieldSchema:
        with self._create_mu:
            cur = self.fields.get(schema.name)
            if cur is not None:
                if cur != schema:
                    raise FieldValueError(
                        f"field {schema.name!r} already exists with a "
                        f"different range")
                return cur
            # Copy-on-write like the views: readers never take the lock.
            self.fields = {**self.fields, schema.name: schema}
            self._save_meta()
            return schema

    def set_value(self, field: str, column_id: int, value: int) -> bool:
        """Write one integer value: set or clear every row of the field's
        bsi view for this column. Raises FieldNotFoundError (404) or
        FieldValueError (422) before writing anything."""
        schema = self.fields.get(field)
        if schema is None:
            raise FieldNotFoundError(self.name, field)
        set_rows, clear_rows = schema.encode(value)
        view = self.create_view_if_not_exists(schema.view)
        changed = False
        for row_id in set_rows:
            changed |= view.set_bit(row_id, column_id)
        for row_id in clear_rows:
            changed |= view.clear_bit(row_id, column_id)
        return changed

    # -- views ---------------------------------------------------------------

    def _open_view(self, name: str) -> View:
        v = View(os.path.join(self.path, name), self.index, self.name, name,
                 self.meta["cacheType"], self.meta["cacheSize"],
                 self.row_attr_store, wal=self.wal)
        v.open()
        self.views = {**self.views, name: v}
        return v

    def view(self, name: str) -> Optional[View]:
        return self.views.get(name)

    def create_view_if_not_exists(self, name: str) -> View:
        with self._create_mu:
            v = self.views.get(name)
            return v if v is not None else self._open_view(name)

    def max_slice(self) -> int:
        return max((v.max_slice() for v in self.views.values()), default=0)

    def max_inverse_slice(self) -> int:
        v = self.views.get(VIEW_INVERSE)
        return v.max_slice() if v else 0

    # -- writes ------------------------------------------------------------

    def set_bit(self, row_id: int, column_id: int,
                t: Optional[datetime] = None) -> bool:
        """Set on the standard view and, with a time t, on each of its
        time views under the frame's quantum; with inverse storage, also
        on the inverse view and its time views, row and column
        swapped."""
        views = [VIEW_STANDARD]
        if self.inverse_enabled:
            views.append(VIEW_INVERSE)
        changed = False
        for base in views:
            names = [base] + (views_by_time(base, t, self.time_quantum)
                              if t is not None else [])
            a, b = ((row_id, column_id) if base == VIEW_STANDARD
                    else (column_id, row_id))
            for name in names:
                changed |= self.create_view_if_not_exists(name).set_bit(a, b)
        return changed

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        """Clear on the standard view and the inverse view; time views
        keep the bit, as in the JAX package."""
        v = self.views.get(VIEW_STANDARD)
        changed = v.clear_bit(row_id, column_id) if v else False
        iv = self.views.get(VIEW_INVERSE)
        if self.inverse_enabled and iv is not None:
            changed |= iv.clear_bit(column_id, row_id)
        return changed

    def import_bits(self, row_ids, column_ids, timestamps=None):
        """Bulk import (Fragment.import_bits per view and slice): every
        bit goes to `standard`; one with a timestamp also to each time
        view of the frame's quantum; with inverse storage, each of those
        views has its inverse twin, row and column swapped. `timestamps`
        holds a datetime or None a bit (the JAX package's form), or is a
        datetime64 array with NaT for none. Bucketed with numpy sorts:
        no Python object a bit. Every fragment's adds apply and its
        snapshot starts before the first is waited for (the snapshots
        overlap); the call returns once all have landed."""
        rows = np.asarray(row_ids, dtype=np.uint64).reshape(-1)
        cols = np.asarray(column_ids, dtype=np.uint64).reshape(-1)
        if rows.shape != cols.shape:
            raise ValueError("row/column mismatch")
        buckets = {VIEW_STANDARD: (rows, cols)}
        if timestamps is not None:
            buckets.update(_time_buckets(rows, cols, timestamps,
                                         self.time_quantum))
        if self.inverse_enabled:
            for name, (rs, cs) in list(buckets.items()):
                buckets[name.replace(VIEW_STANDARD, VIEW_INVERSE, 1)] = (cs,
                                                                        rs)
        begun = []
        try:
            for name, (rs, cs) in buckets.items():
                view = self.create_view_if_not_exists(name)
                for s, sel in _by_slice(cs):
                    frag = view.create_fragment_if_not_exists(s)
                    begun.append((frag, frag.import_begin(rs[sel], cs[sel])))
        finally:
            # Every begun snapshot is waited for, even after a failure;
            # the first error is raised.
            err = None
            for frag, target in begun:
                try:
                    frag.import_wait(target)
                except BaseException as e:  # noqa: BLE001 — raised below
                    err = err or e
            if err is not None:
                raise err

    def to_dict(self) -> dict:
        return {"name": self.name, "meta": self._meta_doc(),
                "views": sorted(self.views)}


def _groups(codes: np.ndarray):
    """(code, index array) of each distinct code, in code order; the
    indices of one code keep their order."""
    if not len(codes):
        return
    if codes[0] == codes[-1] and (codes == codes[0]).all():
        yield codes[0].item(), slice(None)
        return
    order = np.argsort(codes, kind="stable")
    uniq, starts = np.unique(codes[order], return_index=True)
    for k, (code, a) in enumerate(zip(uniq.tolist(), starts.tolist())):
        b = starts[k + 1] if k + 1 < len(starts) else len(order)
        yield code, order[a:b]


def _by_slice(cols: np.ndarray):
    """(slice, selector) of each slice the columns reach."""
    return _groups(cols // np.uint64(SLICE_WIDTH))


_FINEST = (("H", "h"), ("D", "D"), ("M", "M"), ("Y", "Y"))


def _time_buckets(rows: np.ndarray, cols: np.ndarray, timestamps,
                  q: TimeQuantum) -> Dict[str, tuple]:
    """{time view: (rows, cols)} of the bits that have a timestamp. Names
    come from views_by_time, once a distinct time at the quantum's
    finest unit."""
    unit = next((u for k, u in _FINEST if k in q), None)
    if unit is None:
        return {}
    ts = np.asarray(timestamps if isinstance(timestamps, np.ndarray)
                    else [np.datetime64("NaT") if t is None else t
                          for t in timestamps], dtype="datetime64[s]")
    n = min(len(ts), len(rows))  # zip's length, as the JAX package's
    rows, cols, ts = rows[:n], cols[:n], ts[:n]
    keep = ~np.isnat(ts)
    if not keep.any():
        return {}
    rows, cols = rows[keep], cols[keep]
    uniq, inv = np.unique(ts[keep].astype(f"datetime64[{unit}]"),
                          return_inverse=True)
    names = [views_by_time(VIEW_STANDARD,
                           t.astype("datetime64[s]").astype(datetime), q)
             for t in uniq]
    out: Dict[str, tuple] = {}
    for j in range(len(names[0])):
        ids: Dict[str, int] = {}
        code_of = np.array([ids.setdefault(n[j], len(ids)) for n in names])
        by_code = {c: n for n, c in ids.items()}
        for code, sel in _groups(code_of[inv]):
            out[by_code[code]] = (rows[sel], cols[sel])
    return out


def _coerce_fields(fields) -> Dict[str, FieldSchema]:
    out: Dict[str, FieldSchema] = {}
    for f in fields or ():
        schema = f if isinstance(f, FieldSchema) else FieldSchema.from_dict(f)
        if schema.name in out:
            raise FieldValueError(f"duplicate field {schema.name!r}")
        out[schema.name] = schema
    return out
