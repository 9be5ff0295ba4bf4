"""The protobuf messages of the port, in proto3's wire format, written
by hand: the port needs no google.protobuf.

Covers the bulk routes' ImportRequest, ImportResponse,
BlockDataRequest, BlockDataResponse and MaxSlicesResponse, the query
plane's QueryRequest and QueryResponse (QueryResult, RowResult, Pair,
Attr, ColumnAttrSet), the cluster's NodeStatus and ClusterStatus with
the index and frame metas, and the five broadcast messages with their
one-byte type tag (marshal_message / unmarshal_message), with the field
numbers of the JAX package's `pilosa_tpu/wire/pilosa.proto`, and gives
the bytes its generated module gives:
- fields are written in field-number order, and a field at its default
  (an empty string, 0, False, 0.0, an empty repeated field) is left
  out; a sub-message is written when it is set (not None), empty or
  not, as the generated module writes one it was given;
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

import struct
from typing import Dict, Tuple

import numpy as np

# Content type for protobuf request/response bodies.
PROTOBUF_CT = "application/x-protobuf"

_U64 = np.uint64
_MAX_FIELD = (1 << 29) - 1
_MASK64 = (1 << 64) - 1

# Field kinds. A MESSAGE or REPEATED field names its message class as the
# spec's fourth element.
(STRING, UINT64, PACKED_U64, PACKED_I64, MAP_STR_U64, BOOL, INT64, DOUBLE,
 MESSAGE, REPEATED) = range(10)
_PACKED = (PACKED_U64, PACKED_I64)
_DOUBLE = struct.Struct("<d")


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
        elif wt == 1:
            start, pos = pos, _skip(data, pos, num, wt)
            yield num, wt, data[start:pos]
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


_DEFAULTS = {STRING: str, UINT64: int, MAP_STR_U64: dict, BOOL: bool,
             INT64: int, DOUBLE: float, MESSAGE: lambda: None,
             REPEATED: list,
             PACKED_U64: lambda: np.empty(0, dtype=_U64),
             PACKED_I64: lambda: np.empty(0, dtype=np.int64)}


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


class Message:
    """A message: FIELDS is ((number, name, kind[, class]), ...) in
    number order. Packed repeated fields hold numpy arrays (uint64, or
    int64 for PACKED_I64), a map a dict, a MESSAGE field a Message or
    None (unset), a REPEATED field a list of Messages."""

    FIELDS: Tuple[tuple, ...] = ()

    def __init__(self, **values):
        for spec in self.FIELDS:
            setattr(self, spec[1], _DEFAULTS[spec[2]]())
        kinds = self._kinds()
        for name, value in values.items():
            kind = kinds[name]
            if kind in _PACKED:
                dt = np.int64 if kind == PACKED_I64 else _U64
                value = np.asarray(value, dtype=dt).reshape(-1)
            elif kind == REPEATED:
                value = list(value)
            setattr(self, name, value)

    @classmethod
    def _kinds(cls) -> Dict[str, int]:
        return {spec[1]: spec[2] for spec in cls.FIELDS}

    def encode(self) -> bytes:
        out = bytearray()
        for spec in self.FIELDS:
            num, name, kind = spec[:3]
            value = getattr(self, name)
            if kind == STRING:
                if value:
                    raw = value.encode("utf-8")
                    out += _tag(num, 2) + _varint(len(raw)) + raw
            elif kind in (UINT64, INT64, BOOL):
                if value:
                    out += _tag(num, 0) + _varint(int(value))
            elif kind == DOUBLE:
                if value:
                    out += _tag(num, 1) + _DOUBLE.pack(float(value))
            elif kind in _PACKED:
                if len(value):
                    payload = encode_varints(value)
                    out += _tag(num, 2) + _varint(len(payload)) + payload
            elif kind == MESSAGE:
                if value is not None:
                    raw = value.encode()
                    out += _tag(num, 2) + _varint(len(raw)) + raw
            elif kind == REPEATED:
                for m in value:
                    raw = m.encode()
                    out += _tag(num, 2) + _varint(len(raw)) + raw
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
        by_num = {spec[0]: spec[1:] for spec in cls.FIELDS}
        parts: Dict[str, list] = {}
        for num, wt, v in _records(data):
            spec = by_num.get(num)
            if spec is None:
                continue
            name, kind = spec[:2]
            if kind == STRING and wt == 2:
                setattr(msg, name, _utf8(v))
            elif kind == UINT64 and wt == 0:
                setattr(msg, name, v)
            elif kind == INT64 and wt == 0:
                setattr(msg, name, _signed(v))
            elif kind == BOOL and wt == 0:
                setattr(msg, name, bool(v))
            elif kind == DOUBLE and wt == 1:
                setattr(msg, name, _DOUBLE.unpack(v)[0])
            elif kind == MESSAGE and wt == 2:
                # Records of one sub-message field merge, as in proto3.
                prev = getattr(msg, name)
                sub = spec[2].decode(v)
                setattr(msg, name, sub if prev is None
                        else spec[2].decode(prev.encode() + bytes(v)))
            elif kind == REPEATED and wt == 2:
                getattr(msg, name).append(spec[2].decode(v))
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
        """Every field by name; packed ones as lists of ints, messages
        as dicts (None when unset)."""
        out = {}
        for spec in self.FIELDS:
            name, kind = spec[1], spec[2]
            v = getattr(self, name)
            if kind in _PACKED:
                v = v.tolist()
            elif kind == MESSAGE:
                v = None if v is None else v.to_dict()
            elif kind == REPEATED:
                v = [m.to_dict() for m in v]
            out[name] = v
        return out

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


# -- the query plane -----------------------------------------------------------

# Attr value kinds (the reference's attr.go:35-40).
ATTR_STRING, ATTR_INT, ATTR_BOOL, ATTR_FLOAT = 1, 2, 3, 4

# QueryResult.kind
RESULT_NONE, RESULT_ROW, RESULT_PAIRS, RESULT_COUNT, RESULT_CHANGED, \
    RESULT_VALCOUNT = range(6)


class Attr(Message):
    FIELDS = ((1, "key", STRING), (2, "kind", UINT64),
              (3, "string_value", STRING), (4, "int_value", INT64),
              (5, "bool_value", BOOL), (6, "float_value", DOUBLE))


class ColumnAttrSet(Message):
    FIELDS = ((1, "id", UINT64), (2, "attrs", REPEATED, Attr))


class RowResult(Message):
    FIELDS = ((1, "bits", PACKED_U64), (2, "attrs", REPEATED, Attr))


class Pair(Message):
    FIELDS = ((1, "key", UINT64), (2, "count", UINT64))


class QueryRequest(Message):
    FIELDS = ((1, "query", STRING), (2, "slices", PACKED_U64),
              (3, "column_attrs", BOOL), (4, "quantum", STRING),
              (5, "remote", BOOL))


class QueryResult(Message):
    FIELDS = ((1, "row", MESSAGE, RowResult), (2, "n", UINT64),
              (3, "pairs", REPEATED, Pair), (4, "changed", BOOL),
              (5, "kind", UINT64), (6, "value", INT64),
              (7, "val_count", UINT64))


class QueryResponse(Message):
    FIELDS = ((1, "err", STRING), (2, "results", REPEATED, QueryResult),
              (3, "column_attr_sets", REPEATED, ColumnAttrSet))


def attrs_to_proto(m: dict) -> list:
    """dict -> Attr list sorted by key (bool before int: a bool is an
    int)."""
    out = []
    for k in sorted(m):
        v = m[k]
        if isinstance(v, bool):
            a = Attr(key=k, kind=ATTR_BOOL, bool_value=v)
        elif isinstance(v, int):
            a = Attr(key=k, kind=ATTR_INT, int_value=v)
        elif isinstance(v, float):
            a = Attr(key=k, kind=ATTR_FLOAT, float_value=v)
        elif isinstance(v, str):
            a = Attr(key=k, kind=ATTR_STRING, string_value=v)
        else:
            raise TypeError(
                f"invalid attr type for {k!r}: {type(v).__name__}")
        out.append(a)
    return out


def attrs_from_proto(attrs) -> dict:
    out = {}
    for a in attrs:
        if a.kind == ATTR_STRING:
            out[a.key] = a.string_value
        elif a.kind == ATTR_INT:
            out[a.key] = int(a.int_value)
        elif a.kind == ATTR_BOOL:
            out[a.key] = bool(a.bool_value)
        elif a.kind == ATTR_FLOAT:
            out[a.key] = float(a.float_value)
    return out


def result_to_proto(result) -> QueryResult:
    """An executor result -> QueryResult: a Row, TopN pairs, a Count, a
    write's changed flag, a Sum / Min / Max {value, count}, or None."""
    from ..core.row import Row

    if isinstance(result, Row):
        return QueryResult(kind=RESULT_ROW, row=RowResult(
            bits=result.columns(), attrs=attrs_to_proto(result.attrs)))
    if isinstance(result, bool):
        return QueryResult(kind=RESULT_CHANGED, changed=result)
    if isinstance(result, int):
        return QueryResult(kind=RESULT_COUNT, n=result)
    if isinstance(result, list):
        return QueryResult(kind=RESULT_PAIRS, pairs=[
            Pair(key=int(k), count=int(n)) for k, n in result])
    if isinstance(result, dict) and "value" in result:
        return QueryResult(kind=RESULT_VALCOUNT, value=int(result["value"]),
                           val_count=int(result.get("count", 0)))
    if result is None:
        return QueryResult(kind=RESULT_NONE)
    raise TypeError(f"unserializable result: {type(result).__name__}")


def result_from_proto(qr: QueryResult):
    """QueryResult -> the executor's value, by its kind (an empty Row is
    no Count of 0)."""
    from ..core.row import Row

    if qr.kind == RESULT_ROW:
        row = Row.from_columns(qr.row.bits if qr.row is not None
                               else np.empty(0, dtype=_U64))
        row.attrs = attrs_from_proto(qr.row.attrs if qr.row is not None
                                     else [])
        return row
    if qr.kind == RESULT_PAIRS:
        return [(int(p.key), int(p.count)) for p in qr.pairs]
    if qr.kind == RESULT_CHANGED:
        return bool(qr.changed)
    if qr.kind == RESULT_VALCOUNT:
        return {"value": int(qr.value), "count": int(qr.val_count)}
    if qr.kind == RESULT_NONE:
        return None
    return int(qr.n)


# -- schema and status ---------------------------------------------------------


class IndexMeta(Message):
    FIELDS = ((1, "column_label", STRING), (2, "time_quantum", STRING))


class FrameMeta(Message):
    FIELDS = ((1, "row_label", STRING), (2, "inverse_enabled", BOOL),
              (3, "cache_type", STRING), (4, "cache_size", UINT64),
              (5, "time_quantum", STRING), (6, "fields_json", STRING))


class FrameInfo(Message):
    FIELDS = ((1, "name", STRING), (2, "meta", MESSAGE, FrameMeta))


class IndexInfo(Message):
    FIELDS = ((1, "name", STRING), (2, "meta", MESSAGE, IndexMeta),
              (3, "max_slice", UINT64), (4, "frames", REPEATED, FrameInfo),
              (5, "slices", PACKED_U64), (6, "max_inverse_slice", UINT64))


class NodeStatus(Message):
    FIELDS = ((1, "host", STRING), (2, "state", STRING),
              (3, "indexes", REPEATED, IndexInfo))


class ClusterStatus(Message):
    FIELDS = ((1, "nodes", REPEATED, NodeStatus),)


# -- broadcast messages ---------------------------------------------------------


class CreateSliceMessage(Message):
    FIELDS = ((1, "index", STRING), (2, "slice", UINT64),
              (3, "is_inverse", BOOL))


class CreateIndexMessage(Message):
    FIELDS = ((1, "index", STRING), (2, "meta", MESSAGE, IndexMeta))


class DeleteIndexMessage(Message):
    FIELDS = ((1, "index", STRING),)


class CreateFrameMessage(Message):
    FIELDS = ((1, "index", STRING), (2, "frame", STRING),
              (3, "meta", MESSAGE, FrameMeta))


class DeleteFrameMessage(Message):
    FIELDS = ((1, "index", STRING), (2, "frame", STRING))


# The one-byte type tags (the reference's broadcast.go:110-116).
_MSG_TYPES = {1: CreateSliceMessage, 2: CreateIndexMessage,
              3: DeleteIndexMessage, 4: CreateFrameMessage,
              5: DeleteFrameMessage}
_MSG_TAGS = {v: k for k, v in _MSG_TYPES.items()}


def marshal_message(msg: Message) -> bytes:
    """The type tag, then the message."""
    tag = _MSG_TAGS.get(type(msg))
    if tag is None:
        raise TypeError(f"message type not implemented: "
                        f"{type(msg).__name__}")
    return bytes([tag]) + msg.encode()


def unmarshal_message(data: bytes) -> Message:
    if not data:
        raise ValueError("empty broadcast message")
    cls = _MSG_TYPES.get(data[0])
    if cls is None:
        raise ValueError(f"invalid message type: {data[0]}")
    return cls.decode(data[1:])
