"""The protobuf messages of the bulk routes, in proto3's wire format,
written by hand: the port needs no google.protobuf.

Covers ImportRequest, ImportResponse, BlockDataRequest,
BlockDataResponse and MaxSlicesResponse with the field numbers of the
JAX package's `pilosa_tpu/wire/pilosa.proto:95-130`, and gives the bytes
its generated module gives:
- fields are written in field-number order, and a field at its default
  (an empty string, 0, an empty repeated field) is left out;
- repeated uint64 / int64 fields are packed varints; a negative int64
  is the 10-byte varint of its two's complement;
- a map entry always carries its key (field 1) and value (field 2).
The decoder also takes repeated fields unpacked (one varint a record,
or packed and unpacked runs mixed, in order), keeps the last record of
a scalar field, and skips unknown fields and known ones of another wire
type, as every proto3 parser does. The repeated fields' varints are
encoded and decoded with numpy, not a Python loop per value: one slice
of an import is ~200,000 values.

A malformed body (a truncated varint, one longer than 10 bytes, a length
past the end, invalid UTF-8 in a string) raises DecodeError.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# Content type for protobuf request/response bodies.
PROTOBUF_CT = "application/x-protobuf"

_U64 = np.uint64
_MAX_FIELD = (1 << 29) - 1
_MASK64 = (1 << 64) - 1

# Field kinds.
STRING, UINT64, PACKED_U64, PACKED_I64, MAP_STR_U64 = range(5)
_PACKED = (PACKED_U64, PACKED_I64)


class DecodeError(Exception):
    """A body that is no valid encoding of its message. Not a ValueError:
    the JAX handler answers google.protobuf's DecodeError (no ValueError
    either) with 500, and the port's handler does the same."""


# -- varints -------------------------------------------------------------------


def _varint(n: int) -> bytes:
    n &= _MASK64
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    """(value, next position) of the varint at `pos`."""
    value = shift = 0
    for i in range(10):
        if pos + i >= len(data):
            raise DecodeError("truncated varint")
        b = data[pos + i]
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value & _MASK64, pos + i + 1
        shift += 7
    raise DecodeError("varint longer than 10 bytes")


def encode_varints(values) -> bytes:
    """The varints of `values` (uint64, or int64 as two's complement),
    back to back: a packed field's payload."""
    v = np.asarray(values)
    v = v.view(_U64) if v.dtype == np.int64 else v.astype(_U64, copy=False)
    if not len(v):
        return b""
    n = np.ones(len(v), dtype=np.int64)
    for k in range(1, 10):
        n += v >= _U64(1 << (7 * k))
    # One row of up to `width` bytes a value; the mask keeps each value's
    # own bytes, in row-major order: the varints back to back.
    width = int(n.max())
    j = np.arange(width)
    rows = ((v[:, None] >> (_U64(7) * j.astype(_U64)))
            & _U64(0x7F)).astype(np.uint8)
    rows |= (j < (n - 1)[:, None]).view(np.uint8) << np.uint8(7)
    out = rows[j < n[:, None]]
    return out.tobytes()


def decode_varints(payload) -> np.ndarray:
    """The uint64 values of a packed field's payload."""
    b = np.frombuffer(payload, dtype=np.uint8)
    if not len(b):
        return np.empty(0, dtype=_U64)
    term = b < 0x80
    if not term[-1]:
        raise DecodeError("truncated varint in a packed field")
    # The common case, every value of one width (a slice's columns): a
    # (values, width) view, no index arrays.
    width = int(np.argmax(term)) + 1
    if len(b) % width == 0 and width <= 10:
        marks = term.reshape(-1, width)
        if marks[:, -1].all() and not marks[:, :-1].any():
            rows = b.reshape(-1, width)
            out = (rows[:, 0] & 0x7F).astype(_U64)
            for j in range(1, width):
                out |= (rows[:, j] & 0x7F).astype(_U64) << _U64(7 * j)
            return out
    ends = np.flatnonzero(term)
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts + 1
    longest = int(lens.max())
    if longest > 10:
        raise DecodeError("varint longer than 10 bytes")
    out = (b[starts] & 0x7F).astype(_U64)
    for j in range(1, longest):
        m = lens > j
        out[m] |= (b[starts[m] + j] & 0x7F).astype(_U64) << _U64(7 * j)
    return out


# -- messages ------------------------------------------------------------------


def _tag(num: int, wire_type: int) -> bytes:
    return _varint((num << 3) | wire_type)


def _skip_group(data: bytes, pos: int, num: int) -> int:
    """The position after the end-group record of group `num`."""
    while True:
        key, pos = _read_varint(data, pos)
        inner, wt = key >> 3, key & 7
        if wt == 4:
            if inner != num:
                raise DecodeError("mismatched end group")
            return pos
        pos = _skip(data, pos, inner, wt)


def _skip(data: bytes, pos: int, num: int, wt: int) -> int:
    if wt == 0:
        return _read_varint(data, pos)[1]
    if wt in (1, 5):
        end = pos + (8 if wt == 1 else 4)
    elif wt == 2:
        ln, pos = _read_varint(data, pos)
        end = pos + ln
    elif wt == 3:
        return _skip_group(data, pos, num)
    else:
        raise DecodeError(f"invalid wire type {wt}")
    if end > len(data):
        raise DecodeError("field runs past the end of the message")
    return end


def _records(data: bytes):
    """(field number, wire type, varint value or payload) of each record;
    fixed-width and group records come with None."""
    pos, n = 0, len(data)
    while pos < n:
        key, pos = _read_varint(data, pos)
        num, wt = key >> 3, key & 7
        if num == 0 or num > _MAX_FIELD:
            raise DecodeError(f"invalid field number {num}")
        if wt == 0:
            value, pos = _read_varint(data, pos)
            yield num, wt, value
        elif wt == 2:
            ln, pos = _read_varint(data, pos)
            if pos + ln > n:
                raise DecodeError("length runs past the end of the message")
            yield num, wt, data[pos:pos + ln]
            pos += ln
        else:
            pos = _skip(data, pos, num, wt)
            yield num, wt, None


def _utf8(raw: bytes) -> str:
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError(f"invalid UTF-8 in a string field: {e}") from None


def _map_entry(raw: bytes) -> Tuple[str, int]:
    key, value = "", 0
    for num, wt, v in _records(raw):
        if num == 1 and wt == 2:
            key = _utf8(v)
        elif num == 2 and wt == 0:
            value = v
    return key, value


_DEFAULTS = {STRING: str, UINT64: int, MAP_STR_U64: dict,
             PACKED_U64: lambda: np.empty(0, dtype=_U64),
             PACKED_I64: lambda: np.empty(0, dtype=np.int64)}


class Message:
    """A message: FIELDS is ((number, name, kind), ...) in number order.
    Repeated fields hold numpy arrays (uint64, or int64 for PACKED_I64),
    a map a dict."""

    FIELDS: Tuple[Tuple[int, str, int], ...] = ()

    def __init__(self, **values):
        for _, name, kind in self.FIELDS:
            setattr(self, name, _DEFAULTS[kind]())
        for name, value in values.items():
            kind = self._kinds()[name]
            if kind in _PACKED:
                dt = np.int64 if kind == PACKED_I64 else _U64
                value = np.asarray(value, dtype=dt).reshape(-1)
            setattr(self, name, value)

    @classmethod
    def _kinds(cls) -> Dict[str, int]:
        return {name: kind for _, name, kind in cls.FIELDS}

    def encode(self) -> bytes:
        out = bytearray()
        for num, name, kind in self.FIELDS:
            value = getattr(self, name)
            if kind == STRING:
                if value:
                    raw = value.encode("utf-8")
                    out += _tag(num, 2) + _varint(len(raw)) + raw
            elif kind == UINT64:
                if value:
                    out += _tag(num, 0) + _varint(int(value))
            elif kind in _PACKED:
                if len(value):
                    payload = encode_varints(value)
                    out += _tag(num, 2) + _varint(len(payload)) + payload
            else:
                for k, v in value.items():
                    raw = k.encode("utf-8")
                    entry = (b"\x0a" + _varint(len(raw)) + raw + b"\x10"
                             + _varint(int(v)))
                    out += _tag(num, 2) + _varint(len(entry)) + entry
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "Message":
        data = bytes(data)
        msg = cls()
        by_num = {num: (name, kind) for num, name, kind in cls.FIELDS}
        parts: Dict[str, list] = {}
        for num, wt, v in _records(data):
            spec = by_num.get(num)
            if spec is None:
                continue
            name, kind = spec
            if kind == STRING and wt == 2:
                setattr(msg, name, _utf8(v))
            elif kind == UINT64 and wt == 0:
                setattr(msg, name, v)
            elif kind in _PACKED and wt == 2:
                parts.setdefault(name, []).append(decode_varints(v))
            elif kind in _PACKED and wt == 0:
                parts.setdefault(name, []).append(np.array([v], dtype=_U64))
            elif kind == MAP_STR_U64 and wt == 2:
                k, val = _map_entry(v)
                getattr(msg, name)[k] = val
        for name, arrays in parts.items():
            arr = np.concatenate(arrays)
            if cls._kinds()[name] == PACKED_I64:
                arr = arr.view(np.int64)
            setattr(msg, name, arr)
        return msg

    def to_dict(self) -> dict:
        """Every field by name; repeated ones as lists of ints."""
        return {name: (getattr(self, name).tolist() if kind in _PACKED
                       else getattr(self, name))
                for _, name, kind in self.FIELDS}

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and self.to_dict() == other.to_dict()

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.to_dict()})"


class ImportRequest(Message):
    FIELDS = ((1, "index", STRING), (2, "frame", STRING),
              (3, "slice", UINT64), (4, "row_ids", PACKED_U64),
              (5, "column_ids", PACKED_U64), (6, "timestamps", PACKED_I64))


class ImportResponse(Message):
    FIELDS = ((1, "err", STRING),)


class BlockDataRequest(Message):
    FIELDS = ((1, "index", STRING), (2, "frame", STRING),
              (3, "view", STRING), (4, "slice", UINT64),
              (5, "block", UINT64))


class BlockDataResponse(Message):
    FIELDS = ((1, "row_ids", PACKED_U64), (2, "column_ids", PACKED_U64))


class MaxSlicesResponse(Message):
    FIELDS = ((1, "max_slices", MAP_STR_U64),)
