"""Frame: a table of rows owning its views, with the JSON `.meta` the
JAX package writes (rowLabel, inverseEnabled, cacheType, cacheSize,
timeQuantum, fields). This port serves no time quantums or integer
fields; their meta values are kept and reported as they were read."""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Dict, Optional

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
                 cache_type: str = "ranked", cache_size: int = 50000):
        validate_name(name)
        self.path = path
        self.index = index
        self.name = name
        self.meta = {"rowLabel": row_label,
                     "inverseEnabled": bool(inverse_enabled),
                     "cacheType": cache_type, "cacheSize": cache_size,
                     "timeQuantum": "", "fields": []}
        self.views: Dict[str, View] = {}
        self._create_mu = threading.Lock()

    @property
    def row_label(self) -> str:
        return self.meta["rowLabel"]

    @property
    def inverse_enabled(self) -> bool:
        return bool(self.meta["inverseEnabled"])

    @property
    def meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    def open(self):
        os.makedirs(self.path, exist_ok=True)
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                self.meta.update(json.load(f))
        else:
            self._save_meta()
        for name in sorted(os.listdir(self.path)):
            if os.path.isdir(os.path.join(self.path, name)):
                self._open_view(name)

    def close(self):
        for v in self.views.values():
            v.close()
        self.views = {}

    def _save_meta(self):
        with open(self.meta_path, "w") as f:
            json.dump(self.meta, f)

    def _open_view(self, name: str) -> View:
        v = View(os.path.join(self.path, name), self.index, self.name, name)
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

    def set_bit(self, row_id: int, column_id: int) -> bool:
        """Set on the standard view and, when enabled, the inverse view
        with row and column swapped."""
        changed = self.create_view_if_not_exists(VIEW_STANDARD).set_bit(
            row_id, column_id)
        if self.inverse_enabled:
            changed |= self.create_view_if_not_exists(VIEW_INVERSE).set_bit(
                column_id, row_id)
        return changed

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        v = self.views.get(VIEW_STANDARD)
        changed = v.clear_bit(row_id, column_id) if v else False
        iv = self.views.get(VIEW_INVERSE)
        if self.inverse_enabled and iv is not None:
            changed |= iv.clear_bit(column_id, row_id)
        return changed

    def to_dict(self) -> dict:
        return {"name": self.name, "meta": dict(self.meta),
                "views": sorted(self.views)}
