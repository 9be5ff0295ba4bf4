"""View: one orientation of a frame ("standard" or "inverse"), or one of
their time-quantum views ("standard_2017", ...), owning its fragments by
slice under <view>/fragments/<slice>."""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, Optional

from .. import SLICE_WIDTH
from .cache import CACHE_TYPE_RANKED, DEFAULT_CACHE_SIZE
from .fragment import MUTATION_EPOCH, Fragment

VIEW_STANDARD = "standard"
VIEW_INVERSE = "inverse"

_FRAGMENT_FILE_RE = re.compile(r"^\d+$")


class View:
    def __init__(self, path: str, index: str, frame: str, name: str,
                 cache_type: str = CACHE_TYPE_RANKED,
                 cache_size: int = DEFAULT_CACHE_SIZE,
                 row_attr_store=None, wal=None):
        self.path = path
        self.wal = wal  # core/wal.WalConfig, or None: never
        self.index = index
        self.frame = frame
        self.name = name
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.row_attr_store = row_attr_store
        self.fragments: Dict[int, Fragment] = {}
        self._create_mu = threading.Lock()

    @property
    def fragments_path(self) -> str:
        return os.path.join(self.path, "fragments")

    def open(self):
        os.makedirs(self.fragments_path, exist_ok=True)
        for fname in sorted(os.listdir(self.fragments_path)):
            if _FRAGMENT_FILE_RE.match(fname):
                self._open_fragment(int(fname))

    def close(self):
        for f in self.fragments.values():
            f.close()
        self.fragments = {}

    def _open_fragment(self, slice_: int) -> Fragment:
        frag = Fragment(os.path.join(self.fragments_path, str(slice_)),
                        self.index, self.frame, self.name, slice_,
                        self.cache_type, self.cache_size,
                        self.row_attr_store, wal=self.wal)
        frag.open()
        # Copy-on-write: readers iterate fragments without the lock.
        self.fragments = {**self.fragments, slice_: frag}
        MUTATION_EPOCH.bump()
        return frag

    def fragment(self, slice_: int) -> Optional[Fragment]:
        return self.fragments.get(slice_)

    def max_slice(self) -> int:
        return max(self.fragments, default=0)

    def create_fragment_if_not_exists(self, slice_: int) -> Fragment:
        with self._create_mu:
            frag = self.fragments.get(slice_)
            return frag if frag is not None else self._open_fragment(slice_)

    def set_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.create_fragment_if_not_exists(column_id // SLICE_WIDTH)
        return frag.set_bit(row_id, column_id)

    def clear_bit(self, row_id: int, column_id: int) -> bool:
        frag = self.fragments.get(column_id // SLICE_WIDTH)
        return frag.clear_bit(row_id, column_id) if frag else False
