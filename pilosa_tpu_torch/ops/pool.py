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


# -- writes into a staged image -----------------------------------------------
#
# The host half of the write scatter (the JAX package's
# pilosa_tpu/ops/pool.py:119-225): a fragment's mutation log folds into
# final bit states, which plan into one (slot, word, set_mask,
# clear_mask) entry per touched word of the pool image; the card applies
# (w & ~clear) | set at each (ops/kernels.scatter_words, K7).


def fold_log_entries(entries):
    """Fold a fragment's mutation log (op, pos, churn) into final bit
    states: (pos uint64, val bool) arrays, the last op winning. The card
    applies final states, never op sequences."""
    final = {}
    for op, pos, _ in entries:
        final[pos] = op == 0
    return (np.fromiter(final.keys(), dtype=np.uint64, count=len(final)),
            np.fromiter(final.values(), dtype=bool, count=len(final)))


def plan_slice_mutations(keys_row: np.ndarray, row_ids: np.ndarray,
                         pos: np.ndarray, val: np.ndarray):
    """One slice's final bit states as a scatter plan against its staged
    pool: (slot int32, word int32, set_mask uint32, clear_mask uint32),
    one entry per touched (container slot, word), so a word that takes
    both sets and clears gets both masks in ONE entry and the targets
    are unique.

    keys_row: the slice's sorted, INVALID_KEY-padded pool keys; row_ids:
    the view's dense row table; pos: slice-local positions (row * 2^20 +
    col % 2^20); val: each position's final value (fold_log_entries).
    Raises KeyError when a set targets a container absent from the image
    (the caller restages); clears of absent containers drop, as a
    roaring remove of a missing key does."""
    pos = np.asarray(pos, dtype=np.uint64)
    val = np.asarray(val, dtype=bool)
    rows = pos >> np.uint64(20)
    dense = np.searchsorted(row_ids, rows)
    if len(row_ids):
        known_row = (dense < len(row_ids)) & (
            row_ids[np.minimum(dense, len(row_ids) - 1)] == rows)
    else:
        known_row = np.zeros(len(pos), dtype=bool)
    key = (dense * ROW_SPAN
           + ((pos >> np.uint64(16)) & np.uint64(15)).astype(np.int64)
           ).astype(np.int32)
    sl = np.searchsorted(keys_row, key).astype(np.int64)
    known = known_row & (sl < keys_row.shape[0]) & (
        keys_row[np.minimum(sl, keys_row.shape[0] - 1)] == key)
    if np.any(val & ~known):
        raise KeyError("set targets a container absent from the pool image")
    sl, pos, val = sl[known], pos[known], val[known]
    wd = ((pos & np.uint64(0xFFFF)) >> np.uint64(5)).astype(np.int32)
    bit = np.uint32(1) << (pos & np.uint64(31)).astype(np.uint32)

    flat = sl * CONTAINER_WORDS + wd
    order = np.argsort(flat, kind="stable")
    flat, sl, wd, bit, val = (flat[order], sl[order], wd[order], bit[order],
                              val[order])
    uniq, start = np.unique(flat, return_index=True)
    set_mask = np.zeros(len(uniq), dtype=np.uint32)
    clear_mask = np.zeros(len(uniq), dtype=np.uint32)
    group = np.searchsorted(uniq, flat)
    np.bitwise_or.at(set_mask, group[val], bit[val])
    np.bitwise_or.at(clear_mask, group[~val], bit[~val])
    return (sl[start].astype(np.int32), wd[start], set_mask, clear_mask)


def mutation_batch_width(n: int, min_batch: int = 8) -> int:
    """The power of two >= n (at least min_batch) a plan pads to, so
    batch shapes repeat."""
    b = min_batch
    while b < n:
        b *= 2
    return b


def pad_mutation_plan(plan, capacity: int, width: int = None):
    """A plan_slice_mutations result padded to `width` (default: the
    power of two of its own length). Padding entries take slot =
    capacity, past the pool, which the scatter drops: a no-op that
    collides with no real target."""
    sl, wd, sm, cm = plan
    b = mutation_batch_width(len(sl)) if width is None else width
    slot = np.full(b, capacity, dtype=np.int32)
    word = np.zeros(b, dtype=np.int32)
    set_mask = np.zeros(b, dtype=np.uint32)
    clear_mask = np.zeros(b, dtype=np.uint32)
    n = len(sl)
    slot[:n], word[:n], set_mask[:n], clear_mask[:n] = sl, wd, sm, cm
    return slot, word, set_mask, clear_mask
