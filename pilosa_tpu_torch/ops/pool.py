"""The packed container pool: a fragment's containers as fixed-shape
2048-word blocks (or, for sparse slices, as sorted value arrays).

Key layout: a bit at (row, col) of one slice sits at position
pos = row * 2^20 + (col % 2^20), so container key = pos >> 16 and row r
spans keys [16r, 16r + 16): a row is at most ROW_SPAN containers. Row
ids are arbitrary uint64, so a pool key is dense_row_index * 16 + block,
where dense_row_index indexes the sorted table of row ids present.
"""

from __future__ import annotations

import numpy as np

# uint32 words per container: 2^16 bits / 32.
CONTAINER_WORDS = 2048

# Containers spanned by one slice-row: 2^20 / 2^16.
ROW_SPAN = 16

# Key of an empty pool slot: above every real key, so keys stay sorted.
INVALID_KEY = np.int32(2**31 - 1)


def pack_bitmap(bitmap):
    """One slice's containers as (keys (n,) uint64 container keys,
    words (n, CONTAINER_WORDS) uint32): a copy, so the stager can take
    it under the fragment's lock and pack the pool without it."""
    keys = np.asarray(bitmap.keys, dtype=np.uint64)
    words = np.empty((len(keys), CONTAINER_WORDS // 2), dtype=np.uint64)
    if len(keys):
        np.stack([c.words() for c in bitmap.containers], out=words)
    return keys, words.view(np.uint32)


def pack_sparse(bitmap):
    """One slice's containers as sorted arrays: (keys (n,) uint64, cards
    (n,) int32, values (sum of cards,) uint16, each container's sorted
    values concatenated in key order). A copy, taken under the
    fragment's lock like pack_bitmap."""
    keys = np.asarray(bitmap.keys, dtype=np.uint64)
    vals = [c.values() for c in bitmap.containers]
    cards = np.array([len(v) for v in vals], dtype=np.int32)
    flat = (np.concatenate(vals).astype(np.uint16) if vals
            else np.empty(0, dtype=np.uint16))
    return keys, cards, flat


def pool_keys(real_keys: np.ndarray, row_ids: np.ndarray) -> np.ndarray:
    """Pool keys of one slice's sorted container keys against the sorted
    global dense row table. The mapping is monotonic, so the pool keys
    come out sorted in the containers' own order."""
    dense = np.searchsorted(row_ids, real_keys >> np.uint64(4))
    return (dense * ROW_SPAN
            + (real_keys & np.uint64(15)).astype(np.int64)).astype(np.int32)
