"""Index: a namespace of frames with the JSON `.meta` the JAX package
writes (columnLabel, timeQuantum)."""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

from ..errors import FrameExistsError
from .frame import Frame, validate_name

DEFAULT_COLUMN_LABEL = "columnID"


class Index:
    def __init__(self, path: str, name: str,
                 column_label: str = DEFAULT_COLUMN_LABEL,
                 time_quantum: str = ""):
        validate_name(name)
        self.path = path
        self.name = name
        self.meta = {"columnLabel": column_label,
                     "timeQuantum": time_quantum}
        self.frames: Dict[str, Frame] = {}
        self._create_mu = threading.Lock()

    @property
    def column_label(self) -> str:
        return self.meta["columnLabel"]

    @property
    def meta_path(self) -> str:
        return os.path.join(self.path, ".meta")

    def open(self):
        os.makedirs(self.path, exist_ok=True)
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                self.meta.update(json.load(f))
        else:
            with open(self.meta_path, "w") as f:
                json.dump(self.meta, f)
        for name in sorted(os.listdir(self.path)):
            if os.path.isdir(os.path.join(self.path, name)):
                self._open_frame(name)

    def close(self):
        for f in self.frames.values():
            f.close()
        self.frames = {}

    def _open_frame(self, name: str, **options) -> Frame:
        frame = Frame(os.path.join(self.path, name), self.name, name,
                      **options)
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
            return self._open_frame(name, **options)

    def create_frame_if_not_exists(self, name: str, **options) -> Frame:
        with self._create_mu:
            f = self.frames.get(name)
            return f if f is not None else self._open_frame(name, **options)

    def to_dict(self) -> dict:
        return {"name": self.name, "meta": dict(self.meta),
                "frames": [f.to_dict()
                           for _, f in sorted(self.frames.items())]}
