"""BSI field schema: an integer field stored as bit-plane rows.

A field lives in a per-frame view named ``bsi.<field>``, so fragment
storage, staging and the count kernels carry it unchanged. Rows inside
the view:

- row 0: existence (the column has a value)
- row 1: sign (the value is negative; sign-magnitude, -0 written as +0)
- row 2+k: bit k of the magnitude, k in [0, bit_depth)

``bit_depth`` is the number of bits max(|min|, |max|) needs, so a
[0, 100] field costs 7 planes and a default field 32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..errors import PilosaError

BSI_VIEW_PREFIX = "bsi."

ROW_EXISTS = 0
ROW_SIGN = 1
ROW_PLANE0 = 2

# The declared range of a field created without min/max: the int32 span.
DEFAULT_MIN = -(2 ** 31)
DEFAULT_MAX = 2 ** 31 - 1

# 2^k weights times slice counts stay inside int64 up to this depth.
MAX_BIT_DEPTH = 62


class FieldValueError(PilosaError, ValueError):
    """A SetValue outside the field's declared [min, max] range, or an
    invalid field definition. HTTP 422."""


class FieldNotFoundError(PilosaError):
    """A query names a field the frame does not define. HTTP 404."""

    def __init__(self, frame: str = "", field: str = ""):
        self.frame = frame
        self.field = field
        super().__init__(f"field {field!r} not found in frame {frame!r}")


@dataclass(frozen=True)
class FieldSchema:
    """One integer field, persisted in the frame's meta."""

    name: str
    min: int = DEFAULT_MIN
    max: int = DEFAULT_MAX

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise FieldValueError("field name must be a non-empty string")
        if isinstance(self.min, bool) or isinstance(self.max, bool) or \
                not isinstance(self.min, int) or not isinstance(self.max, int):
            raise FieldValueError(
                f"field {self.name!r}: min/max must be integers")
        if self.min > self.max:
            raise FieldValueError(
                f"field {self.name!r}: min {self.min} > max {self.max}")
        if self.bit_depth > MAX_BIT_DEPTH:
            raise FieldValueError(
                f"field {self.name!r}: range needs {self.bit_depth} "
                f"magnitude planes, max is {MAX_BIT_DEPTH}")

    @property
    def bit_depth(self) -> int:
        """Magnitude planes the declared range needs."""
        return max(1, max(abs(self.min), abs(self.max)).bit_length())

    @property
    def row_count(self) -> int:
        """Rows of the bsi view: existence + sign + planes."""
        return ROW_PLANE0 + self.bit_depth

    @property
    def view(self) -> str:
        return BSI_VIEW_PREFIX + self.name

    def validate(self, value: int) -> int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise FieldValueError(
                f"field {self.name!r}: value must be an integer, "
                f"got {value!r}")
        if not (self.min <= value <= self.max):
            raise FieldValueError(
                f"field {self.name!r}: value {value} outside declared "
                f"range [{self.min}, {self.max}]")
        return value

    def encode(self, value: int) -> Tuple[List[int], List[int]]:
        """-> (set_rows, clear_rows) covering every row of the field, so
        an overwrite needs no read first. Zero clears the sign row."""
        self.validate(value)
        sign = value < 0
        mag = -value if sign else value
        set_rows = [ROW_EXISTS]
        clear_rows = []
        (set_rows if sign else clear_rows).append(ROW_SIGN)
        for k in range(self.bit_depth):
            row = ROW_PLANE0 + k
            if (mag >> k) & 1:
                set_rows.append(row)
            else:
                clear_rows.append(row)
        return set_rows, clear_rows

    def to_dict(self) -> dict:
        return {"name": self.name, "min": self.min, "max": self.max,
                "bitDepth": self.bit_depth}

    @classmethod
    def from_dict(cls, d: dict) -> "FieldSchema":
        return cls(name=d.get("name", ""),
                   min=d.get("min", DEFAULT_MIN),
                   max=d.get("max", DEFAULT_MAX))
