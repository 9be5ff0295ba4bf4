"""The reference file format (cookie 12346) and its op log.

Layout, all little-endian:

    u32 cookie (12346) | u32 containerCount
    containerCount x { u64 key | u32 n-1 }            # 12-byte headers
    containerCount x { u32 absolute offset }
    container blocks: array -> n x u32; bitmap -> 1024 x u64
    [integrity footer]                                # optional
    op log: repeated { u8 type | u64 value | u32 fnv32a(first 9 bytes) }

Containers with n <= 4096 are arrays, larger ones bitmaps (the reader
infers the form from n). The integrity footer that the JAX package
writes after the blocks (type byte 0xF7, u32 payload length, payload,
u32 checksum) is skipped on read and never written here, so this
module opens data directories written by either package.
"""

from __future__ import annotations

import struct

import numpy as np

from .bitmap import ARRAY_MAX_SIZE, BITMAP_N, Bitmap, Container

COOKIE = 12346
HEADER_SIZE = 8
OP_SIZE = 13
FOOTER_TYPE = 0xF7


def fnv32a(data: bytes) -> int:
    """32-bit FNV-1a (the op checksum)."""
    h = 2166136261
    for b in data:
        h ^= b
        h = (h * 16777619) & 0xFFFFFFFF
    return h


def write_op(w, typ: int, value: int) -> int:
    """Append one op record: {type u8, value u64, fnv32a u32}."""
    body = struct.pack("<BQ", typ, value)
    w.write(body + struct.pack("<I", fnv32a(body)))
    return OP_SIZE


def read_ops(data: bytes):
    """(type, value) per op record. A damaged FINAL record (a write cut
    short by a crash) is dropped; a bad checksum anywhere else raises."""
    ops = []
    off, n = 0, len(data)
    while off + OP_SIZE <= n:
        body = data[off:off + 9]
        (chk,) = struct.unpack_from("<I", data, off + 9)
        if chk != fnv32a(body):
            if off + OP_SIZE == n:
                break
            raise ValueError(f"op checksum mismatch at offset {off}")
        ops.append(struct.unpack("<BQ", body))
        off += OP_SIZE
    return ops


def write_bitmap(b: Bitmap, w) -> int:
    """Serialize the snapshot region (no ops). Returns bytes written."""
    entries = [(k, c) for k, c in zip(b.keys, b.containers) if c.n > 0]
    blocks = [c.array.astype("<u4").tobytes() if c.is_array()
              else c.bitmap.astype("<u8").tobytes() for _, c in entries]
    out = [struct.pack("<II", COOKIE, len(entries))]
    out += [struct.pack("<QI", k, c.n - 1) for k, c in entries]
    offset = HEADER_SIZE + len(entries) * 16
    for blk in blocks:
        out.append(struct.pack("<I", offset))
        offset += len(blk)
    out += blocks
    data = b"".join(out)
    w.write(data)
    return len(data)


def read_bitmap(data: bytes) -> Bitmap:
    """Parse a snapshot and replay its trailing op log."""
    if len(data) < HEADER_SIZE:
        raise ValueError("data too small")
    cookie, key_n = struct.unpack_from("<II", data, 0)
    if cookie != COOKIE:
        raise ValueError("invalid roaring file")
    offs_at = HEADER_SIZE + key_n * 12
    end = offs_at + key_n * 4
    if end > len(data):
        raise ValueError(f"truncated roaring file: {key_n} containers")
    b = Bitmap()
    for i in range(key_n):
        key, n1 = struct.unpack_from("<QI", data, HEADER_SIZE + i * 12)
        (offset,) = struct.unpack_from("<I", data, offs_at + i * 4)
        n = n1 + 1
        size = n * 4 if n <= ARRAY_MAX_SIZE else BITMAP_N * 8
        if offset + size > len(data):
            raise ValueError(f"container {key} out of bounds")
        if n <= ARRAY_MAX_SIZE:
            c = Container(array=np.frombuffer(
                data, "<u4", n, offset).astype(np.uint32))
        else:
            c = Container(bitmap=np.frombuffer(
                data, "<u8", BITMAP_N, offset).astype(np.uint64))
        b.keys.append(key)
        b.containers.append(c)
        end = offset + size
    if end < len(data) and data[end] == FOOTER_TYPE:
        (plen,) = struct.unpack_from("<I", data, end + 1)
        end += 5 + plen + 4
    for typ, value in read_ops(data[end:]):
        if typ == 0:
            b._add_one(value)
        elif typ == 1:
            b._remove_one(value)
        else:
            raise ValueError(f"invalid op type: {typ}")
        b.op_n += 1
    return b
