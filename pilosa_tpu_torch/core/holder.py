"""Holder: the root of a node's data directory, one subdirectory per
index. Its storage config (core/wal.WalConfig: the WAL policy, the
snapshot threshold and the write backpressure) reaches every fragment;
a bare Holder writes through without fsync (`never`), the server passes
its flags (default `group`). Fragments open lazily: a start parses no
data. With scrub_interval > 0 the integrity scrubber (core/scrub.py)
walks the fragments in a thread from open() to close()."""

from __future__ import annotations

import os
import shutil
import threading
from typing import Dict, List, Optional

from ..errors import IndexExistsError
from .fragment import MUTATION_EPOCH
from .index import Index
from .scrub import DEFAULT_SCRUB_RATE_LIMIT, Scrubber
from .wal import WalConfig


class Holder:
    def __init__(self, path: str, wal: Optional[WalConfig] = None,
                 scrub_interval: float = 0.0,
                 scrub_rate_limit: int = DEFAULT_SCRUB_RATE_LIMIT):
        self.path = path
        self.wal = wal
        self.indexes: Dict[str, Index] = {}
        self._create_mu = threading.Lock()
        self.scrubber = Scrubber(self, interval=scrub_interval,
                                 rate_limit=scrub_rate_limit,
                                 enabled=scrub_interval > 0)

    def open(self):
        os.makedirs(self.path, exist_ok=True)
        for name in sorted(os.listdir(self.path)):
            # Dot-directories hold the JAX server's subsystem state.
            if (not name.startswith(".")
                    and os.path.isdir(os.path.join(self.path, name))):
                self._open_index(name)
        self.scrubber.start()

    def close(self):
        self.scrubber.close()
        for idx in self.indexes.values():
            idx.close()
        self.indexes = {}

    def fragments(self) -> list:
        """Every open fragment, by index, frame, view and slice."""
        return [frag for _, idx in sorted(self.indexes.items())
                for _, f in sorted(idx.frames.items())
                for _, v in sorted(f.views.items())
                for _, frag in sorted(v.fragments.items())]

    def storage_state(self) -> List[dict]:
        """Each loaded fragment's durability state (Fragment.
        storage_state), for /debug/vars."""
        return [frag.storage_state() for frag in self.fragments()
                if not frag._pending_load]

    def _open_index(self, name: str, **options) -> Index:
        idx = Index(os.path.join(self.path, name), name, wal=self.wal,
                    **options)
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

    def delete_index(self, name: str) -> None:
        """Close the index (its fragments and their WAL handles) and
        remove its directory. Close and removal stay under the create
        lock, so a racing create_index cannot reuse the path and lose
        its fresh directory (pilosa_tpu/core/holder.py:97)."""
        with self._create_mu:
            rest = dict(self.indexes)
            idx = rest.pop(name, None)
            self.indexes = rest
            MUTATION_EPOCH.bump()
            if idx is not None:
                idx.close()
                shutil.rmtree(idx.path, ignore_errors=True)

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
