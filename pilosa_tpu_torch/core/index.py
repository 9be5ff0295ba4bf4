"""Index: a namespace of frames and the column attribute store
(`attrs.db`), with the JSON `.meta` the JAX package writes (columnLabel,
timeQuantum). A frame created without a time quantum takes the
index's."""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

from ..errors import FrameExistsError
from .attr import AttrStore
from .fragment import MUTATION_EPOCH
from .frame import Frame, validate_name
from .timequantum import TimeQuantum

DEFAULT_COLUMN_LABEL = "columnID"


class Index:
    def __init__(self, path: str, name: str,
                 column_label: str = DEFAULT_COLUMN_LABEL,
                 time_quantum: str = "", wal=None):
        validate_name(name)
        self.path = path
        self.wal = wal  # core/wal.WalConfig, or None: never
        self.name = name
        self.meta = {"columnLabel": column_label,
                     "timeQuantum": str(time_quantum)}
        self.frames: Dict[str, Frame] = {}
        self._create_mu = threading.Lock()
        self.column_attr_store = AttrStore(os.path.join(path, "attrs.db"))

    @property
    def column_label(self) -> str:
        return self.meta["columnLabel"]

    @property
    def time_quantum(self) -> TimeQuantum:
        return TimeQuantum(self.meta["timeQuantum"])

    def set_time_quantum(self, q: TimeQuantum):
        self.meta["timeQuantum"] = str(q)
        self._save_meta()

    def _save_meta(self):
        with open(self.meta_path, "w") as f:
            json.dump(self.meta, f)

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
        self.column_attr_store.open()
        for name in sorted(os.listdir(self.path)):
            if os.path.isdir(os.path.join(self.path, name)):
                self._open_frame(name)

    def close(self):
        for f in self.frames.values():
            f.close()
        self.frames = {}
        self.column_attr_store.close()

    def _open_frame(self, name: str, **options) -> Frame:
        frame = Frame(os.path.join(self.path, name), self.name, name,
                      wal=self.wal, **options)
        frame.open()
        self.frames = {**self.frames, name: frame}
        return frame

    def max_slice(self) -> int:
        return max((f.max_slice() for f in self.frames.values()), default=0)

    def max_inverse_slice(self) -> int:
        return max((f.max_inverse_slice() for f in self.frames.values()),
                   default=0)

    def frame(self, name: str) -> Optional[Frame]:
        return self.frames.get(name)

    def create_frame(self, name: str, **options) -> Frame:
        with self._create_mu:
            if name in self.frames:
                raise FrameExistsError()
            return self._create_frame(name, **options)

    def create_frame_if_not_exists(self, name: str, **options) -> Frame:
        with self._create_mu:
            f = self.frames.get(name)
            return f if f is not None else self._create_frame(name,
                                                              **options)

    def _create_frame(self, name: str, **options) -> Frame:
        # A new frame takes the index's time quantum unless it names one.
        options.setdefault("time_quantum", self.meta["timeQuantum"])
        return self._open_frame(name, **options)

    def delete_frame(self, name: str) -> None:
        """Close the frame (its fragments and their WAL handles) and
        remove its directory, under the create lock
        (pilosa_tpu/core/index.py:153)."""
        with self._create_mu:
            rest = dict(self.frames)
            f = rest.pop(name, None)
            self.frames = rest
            MUTATION_EPOCH.bump()
            if f is not None:
                f.close()
                shutil.rmtree(f.path, ignore_errors=True)

    def to_dict(self) -> dict:
        return {"name": self.name, "meta": dict(self.meta),
                "frames": [f.to_dict()
                           for _, f in sorted(self.frames.items())]}
