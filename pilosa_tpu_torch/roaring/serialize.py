"""The reference file format (cookie 12346), its integrity footer and
its op log; byte for byte the JAX package's (pilosa_tpu/roaring/
serialize.py), so either package verifies the other's files.

Layout, all little-endian:

    u32 cookie (12346) | u32 containerCount
    containerCount x { u64 key | u32 n-1 }            # 12-byte headers
    containerCount x { u32 absolute offset }
    container blocks: array -> n x u32; bitmap -> 1024 x u64
    [integrity footer]                                # optional
    op log: repeated { u8 type | u64 value | u32 fnv32a(first 9 bytes) }

Containers with n <= 4096 are arrays, larger ones bitmaps (the reader
infers the form from n).

The integrity footer (`write_bitmap(footer=True)`, every snapshot the
port writes) sits between the snapshot region and the op log, so it
rides the snapshot's temp file through the atomic rename and a crash
never tears it:

    u8 0xF7 | u32 payload_len
    payload: u32 crc32(snapshot region) | u32 containerCount
             containerCount x u32 fnv32a(container block bytes)
    u32 fnv32a(type byte .. payload)

Its type byte lies outside the op types (0 set, 1 clear). The region's
CRC catches any flipped bit of the image, the per-container FNV-1a names
the rotted containers, and the trailing checksum catches rot in the
footer itself. Files without a footer still load, unverified.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .bitmap import ARRAY_MAX_SIZE, BITMAP_N, Bitmap, Container

COOKIE = 12346
HEADER_SIZE = 8
OP_SIZE = 13
FOOTER_TYPE = 0xF7
_FOOTER_PREFIX = 5            # type byte + payload length
_FOOTER_MIN = _FOOTER_PREFIX + 8 + 4


class CorruptSnapshotError(ValueError):
    """The snapshot region or its footer failed verification: bit rot,
    not a crash-torn tail. `bad_keys`: the keys of the containers whose
    FNV-1a mismatched, when the footer could name them."""

    def __init__(self, msg: str, bad_keys=()):
        super().__init__(msg)
        self.bad_keys = list(bad_keys)


def fnv32a(data: bytes) -> int:
    """32-bit FNV-1a (the op and container checksum)."""
    h = 2166136261
    for b in data:
        h ^= b
        h = (h * 16777619) & 0xFFFFFFFF
    return h


def fnv32a_blocks(blocks) -> list:
    """fnv32a of each byte string in `blocks`. The hash is serial within
    a block, so many blocks run side by side, one numpy step a byte
    column, longest first, in runs of columns over which the count of
    blocks still going stays the same; a few cost less one by one."""
    if len(blocks) <= 16:
        return [fnv32a(b) for b in blocks]
    lens = np.array([len(b) for b in blocks], dtype=np.int64)
    order = np.argsort(-lens, kind="stable")
    # uint32 columns and a prime of the hash's own shape: every step is
    # then a same-type ufunc call, twice as fast as a mixed-type one.
    cols = np.zeros((int(lens.max()), len(blocks)), dtype=np.uint32)
    for k, i in enumerate(order):
        cols[:lens[i], k] = np.frombuffer(blocks[i], dtype=np.uint8)
    sorted_lens = lens[order]
    h = np.full(len(blocks), 2166136261, dtype=np.uint32)
    primes = np.full(len(blocks), 16777619, dtype=np.uint32)
    xor, mul = np.bitwise_xor, np.multiply
    start = 0
    for end in np.unique(sorted_lens).tolist():
        live = int(np.count_nonzero(sorted_lens >= end))
        hv, pv = h[:live], primes[:live]
        for col in cols[start:end, :live]:
            xor(hv, col, hv)
            mul(hv, pv, hv)
        start = end
    out = np.empty_like(h)
    out[order] = h
    return out.tolist()


def write_op(w, typ: int, value: int) -> int:
    """Append one op record: {type u8, value u64, fnv32a u32}."""
    body = struct.pack("<BQ", typ, value)
    w.write(body + struct.pack("<I", fnv32a(body)))
    return OP_SIZE


def scan_ops(data: bytes):
    """Parse an op log that a crash may have cut: (ops, valid_bytes,
    torn_bytes). A partial final record, or a final full record whose
    checksum fails (a write cut short), is a torn tail: every op before
    it came from a completed write, so the caller keeps them and cuts
    the tail. A bad checksum with more records after it is rot in the
    middle of the log and raises."""
    ops = []
    off, n = 0, len(data)
    while off < n:
        if off + OP_SIZE > n:
            return ops, off, n - off
        body = data[off:off + 9]
        (chk,) = struct.unpack_from("<I", data, off + 9)
        if chk != fnv32a(body):
            if off + OP_SIZE == n:
                return ops, off, OP_SIZE
            raise ValueError(f"op checksum mismatch mid-log at offset {off}")
        ops.append(struct.unpack("<BQ", body))
        off += OP_SIZE
    return ops, off, 0


def read_ops(data: bytes):
    """(type, value) per op record; any damaged record raises."""
    ops, _, torn = scan_ops(data)
    if torn:
        raise ValueError(f"torn op record: {torn} trailing bytes")
    return ops


def _container_bytes(c: Container) -> bytes:
    if c.is_array():
        return c.array.astype("<u4").tobytes()
    return c.bitmap.astype("<u8").tobytes()


def write_bitmap(b: Bitmap, w, footer: bool = False) -> int:
    """Serialize the snapshot region (no ops), followed by the integrity
    footer when `footer`. Returns bytes written. The footer hashes only
    the containers whose FNV-1a is not known (Container.fnv), and keeps
    what it hashed there."""
    entries = [(k, c) for k, c in zip(b.keys, b.containers) if c.n > 0]
    blocks = [_container_bytes(c) for _, c in entries]
    header = struct.pack("<II", COOKIE, len(entries))
    keyhdrs = b"".join(struct.pack("<QI", k, c.n - 1) for k, c in entries)
    offsets = bytearray()
    offset = HEADER_SIZE + len(entries) * 16
    for blk in blocks:
        offsets += struct.pack("<I", offset)
        offset += len(blk)
    data = b"".join([header, keyhdrs, bytes(offsets)] + blocks)
    w.write(data)
    n = len(data)
    if footer:
        todo = [i for i, (_, c) in enumerate(entries) if c.fnv is None]
        for i, h in zip(todo, fnv32a_blocks([blocks[i] for i in todo])):
            entries[i][1].fnv = h
        n += write_footer(w, zlib.crc32(data), [c.fnv for _, c in entries])
    return n


def write_footer(w, region_crc: int, container_fnvs) -> int:
    """Append an integrity footer record. Returns bytes written."""
    payload = struct.pack("<II", region_crc & 0xFFFFFFFF,
                          len(container_fnvs))
    payload += b"".join(struct.pack("<I", f) for f in container_fnvs)
    rec = struct.pack("<BI", FOOTER_TYPE, len(payload)) + payload
    rec += struct.pack("<I", fnv32a(rec))
    w.write(rec)
    return len(rec)


def _parse_footer(data: bytes, off: int):
    """(region crc, [container fnvs], record length) of the footer at
    `off` (data[off] is FOOTER_TYPE). A truncated or self-inconsistent
    footer is rot (it is written whole with the snapshot), and raises
    CorruptSnapshotError."""
    n = len(data)
    if off + _FOOTER_MIN > n:
        raise CorruptSnapshotError("integrity footer truncated")
    (plen,) = struct.unpack_from("<I", data, off + 1)
    rec_len = _FOOTER_PREFIX + plen + 4
    if plen < 8 or off + rec_len > n:
        raise CorruptSnapshotError(
            f"integrity footer out of bounds: payload={plen}")
    body = data[off:off + _FOOTER_PREFIX + plen]
    (chk,) = struct.unpack_from("<I", data, off + _FOOTER_PREFIX + plen)
    if chk != fnv32a(body):
        raise CorruptSnapshotError("integrity footer checksum mismatch")
    crc, count = struct.unpack_from("<II", data, off + _FOOTER_PREFIX)
    if plen != 8 + count * 4:
        raise CorruptSnapshotError(
            f"integrity footer length mismatch: {count} containers, "
            f"payload={plen}")
    fnvs = list(struct.unpack_from(f"<{count}I", data,
                                   off + _FOOTER_PREFIX + 8))
    return crc, fnvs, rec_len


def read_bitmap(data: bytes, truncate_torn_tail: bool = False,
                verify: bool = False) -> Bitmap:
    """Parse a snapshot and replay its trailing op log.

    truncate_torn_tail: drop a torn final op record (scan_ops) instead
    of raising; the bitmap's `torn_tail_bytes` says how many bytes the
    caller must cut off the file before it appends. A damaged record in
    the middle of the log raises either way.

    verify: check the footer, when there is one, against the region
    (the CRC, then the per-container FNV-1a to name the rotted
    containers in the CorruptSnapshotError). `verified_footer` on the
    result says whether a footer was verified: a file without one loads
    unverified."""
    if len(data) < HEADER_SIZE:
        raise ValueError("data too small")
    cookie, key_n = struct.unpack_from("<II", data, 0)
    if cookie != COOKIE:
        raise ValueError("invalid roaring file")
    offs_at = HEADER_SIZE + key_n * 12
    end = offs_at + key_n * 4
    if end > len(data):
        raise ValueError(f"truncated roaring file: {key_n} containers")
    hdr = np.frombuffer(data, dtype=np.dtype([("key", "<u8"), ("n1", "<u4")]),
                        count=key_n, offset=HEADER_SIZE)
    keys = hdr["key"].astype(np.uint64)
    ns = hdr["n1"].astype(np.int64) + 1
    offs = np.frombuffer(data, "<u4", count=key_n,
                         offset=offs_at).astype(np.int64)
    is_bm = ns > ARRAY_MAX_SIZE
    sizes = np.where(is_bm, BITMAP_N * 8, ns * 4)
    over = np.flatnonzero(offs + sizes > len(data))
    if len(over):
        raise ValueError(f"container {int(keys[over[0]])} out of bounds")
    # The bitmaps are copied out as rows of one (K, 1024) block, the
    # arrays sliced from one u32 view (offsets are multiples of 4).
    words = None
    bm_at = offs[is_bm].tolist()
    if bm_at:
        words = np.stack([np.frombuffer(data, "<u8", BITMAP_N, o)
                          for o in bm_at]).astype(np.uint64, copy=False)
    u32 = np.frombuffer(data, "<u4", count=len(data) // 4)
    b = Bitmap()
    b.keys = keys.tolist()
    row = 0
    for i in range(key_n):
        if is_bm[i]:
            b.containers.append(Container(bitmap=words[row]))
            row += 1
        else:
            at = int(offs[i]) >> 2
            b.containers.append(Container(
                array=u32[at:at + int(ns[i])].astype(np.uint32)))
    if key_n:
        end = int(offs[-1] + sizes[-1])
    if end < len(data) and data[end] == FOOTER_TYPE:
        crc, fnvs, rec_len = _parse_footer(data, end)
        if verify:
            if len(fnvs) != key_n:
                raise CorruptSnapshotError(
                    f"integrity footer container count mismatch: "
                    f"footer={len(fnvs)}, file={key_n}")
            if zlib.crc32(data[:end]) != crc:
                got = fnv32a_blocks([data[o:o + z] for o, z in
                                     zip(offs.tolist(), sizes.tolist())])
                bad = [b.keys[i] for i in range(key_n) if got[i] != fnvs[i]]
                raise CorruptSnapshotError(
                    f"snapshot region CRC mismatch ({len(bad)} rotted "
                    "containers localized)", bad_keys=bad)
            for c, h in zip(b.containers, fnvs):
                c.fnv = h
            b.verified_footer = True
        end += rec_len
    if truncate_torn_tail:
        ops, _, b.torn_tail_bytes = scan_ops(data[end:])
    else:
        ops = read_ops(data[end:])
    for typ, value in ops:
        if typ == 0:
            b._add_one(value)
        elif typ == 1:
            b._remove_one(value)
        else:
            raise ValueError(f"invalid op type: {typ}")
        b.op_n += 1
    return b
