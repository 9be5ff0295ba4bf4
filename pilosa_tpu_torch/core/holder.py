"""Holder: the root of a node's data directory, one subdirectory per
index."""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from ..errors import IndexExistsError
from .index import Index


class Holder:
    def __init__(self, path: str):
        self.path = path
        self.indexes: Dict[str, Index] = {}
        self._create_mu = threading.Lock()

    def open(self):
        os.makedirs(self.path, exist_ok=True)
        for name in sorted(os.listdir(self.path)):
            # Dot-directories hold the JAX server's subsystem state.
            if (not name.startswith(".")
                    and os.path.isdir(os.path.join(self.path, name))):
                self._open_index(name)

    def close(self):
        for idx in self.indexes.values():
            idx.close()
        self.indexes = {}

    def _open_index(self, name: str, **options) -> Index:
        idx = Index(os.path.join(self.path, name), name, **options)
        idx.open()
        self.indexes = {**self.indexes, name: idx}
        return idx

    def index(self, name: str) -> Optional[Index]:
        return self.indexes.get(name)

    def create_index(self, name: str, **options) -> Index:
        with self._create_mu:
            if name in self.indexes:
                raise IndexExistsError()
            return self._open_index(name, **options)

    def create_index_if_not_exists(self, name: str, **options) -> Index:
        with self._create_mu:
            idx = self.indexes.get(name)
            return idx if idx is not None else self._open_index(
                name, **options)

    def frame(self, index: str, frame: str):
        idx = self.indexes.get(index)
        return idx.frame(frame) if idx else None

    def view(self, index: str, frame: str, view: str):
        f = self.frame(index, frame)
        return f.view(view) if f else None

    def fragment(self, index: str, frame: str, view: str, slice_: int):
        v = self.view(index, frame, view)
        return v.fragment(slice_) if v else None

    def schema(self) -> List[dict]:
        return [idx.to_dict() for _, idx in sorted(self.indexes.items())]
