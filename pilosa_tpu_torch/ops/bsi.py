"""BSI aggregation over dense plane blocks: weighted plane popcounts of
bit-sliced integer fields.

The counterpart of pilosa_tpu/ops/bsi.py. Every plane count runs K5
(ops.kernels.pair_count) on CUDA tensors and its plain version on CPU
tensors; there is no backend switch. Per-plane counts come back as int64
(a plane holds at most 2^20 bits per slice); the 2^k weighting and the
sums across planes are Python ints (`sum_from_counts`), so nothing on the
device can overflow whatever the bit depth.

Dense blocks are ``(..., words)`` arrays in the packed layout of the
container pools (bit i of word w = column 32*w + i): numpy uint32 or
torch int32 holding the same bits. Numpy input is moved to `device`
(default "cuda", which raises without a card).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..bsi.field import ROW_EXISTS, ROW_PLANE0, ROW_SIGN, FieldSchema
from ..bsi.lower import EMPTY
from .bitops import fold_tree
from .kernels import pair_count
from .pool import CONTAINER_WORDS


def _words(x, device) -> torch.Tensor:
    """`x` as an int32 tensor of the same bits: a tensor stays where it
    is, numpy goes to `device`."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.int32 else x.to(torch.int32)
    a = np.ascontiguousarray(x, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(torch.device(device))


# -- dense plane construction (tests / chip_smoke) ---------------------------

def dense_rows_from_values(columns: Sequence[int], values: Sequence[int],
                           schema: FieldSchema, n_words: int) -> np.ndarray:
    """Encode (column, value) pairs as the field's dense row matrix:
    ``(row_count, n_words)`` uint32, rows laid out like the
    ``bsi.<field>`` view (existence, sign, magnitude planes)."""
    rows = np.zeros((schema.row_count, n_words), dtype=np.uint32)
    for col, val in zip(columns, values):
        schema.validate(val)
        w, bit = divmod(int(col), 32)
        mask = np.uint32(1 << bit)
        rows[ROW_EXISTS, w] |= mask
        if val < 0:
            rows[ROW_SIGN, w] |= mask
        mag = abs(int(val))
        for k in range(schema.bit_depth):
            if (mag >> k) & 1:
                rows[ROW_PLANE0 + k, w] |= mask
    return rows


# -- per-plane popcounts ------------------------------------------------------

def _containers(row: torch.Tensor) -> torch.Tensor:
    """A flat word row as (M, 2048), zero-padded to whole containers (0
    op 0 is 0 for every K5 op, so padding counts nothing)."""
    row = row.reshape(-1)
    rem = row.shape[0] % CONTAINER_WORDS
    if rem:
        row = torch.cat([row, row.new_zeros(CONTAINER_WORDS - rem)])
    return row.reshape(-1, CONTAINER_WORDS).contiguous()


def plane_counts(planes, src=None, device="cuda") -> np.ndarray:
    """``counts[p] = |planes[p] & src|`` (|planes[p]| without `src`), one
    K5 launch per plane. `planes` is (P, words), `src` (words,) or None.
    Returns a host int64 vector of length P."""
    planes = _words(planes, device)
    src_c = _containers(_words(src, planes.device)) if src is not None else None
    out = [int(pair_count(_containers(planes[p]), src_c, "and"))
           for p in range(planes.shape[0])]
    return np.asarray(out, dtype=np.int64)


# -- exact host epilogues -----------------------------------------------------

def sum_from_counts(all_counts: Sequence[int],
                    neg_counts: Sequence[int]) -> int:
    """The signed sum from per-plane counts, in Python ints:
    sum = sum_k 2^k * (|p_k ∩ F| - 2·|p_k ∩ F ∩ neg|)."""
    total = 0
    for k, (a, n) in enumerate(zip(all_counts, neg_counts)):
        total += (1 << k) * (int(a) - 2 * int(n))
    return total


def sum_from_plane_dicts(counts: dict, neg: dict,
                         bit_depth: int) -> Tuple[int, int]:
    """-> (sum, count) from the {row_id: count} dicts of
    MeshManager.bsi_plane_counts: `counts` over the filter, `neg` over the
    filter restricted to the sign row. Absent rows count zero."""
    total = sum_from_counts(
        [counts.get(ROW_PLANE0 + k, 0) for k in range(bit_depth)],
        [neg.get(ROW_PLANE0 + k, 0) for k in range(bit_depth)])
    return total, counts.get(ROW_EXISTS, 0)


def sum_dense(planes, schema: FieldSchema, src=None,
              device="cuda") -> Tuple[int, int]:
    """-> (sum, count) of a field over one dense row matrix: the
    kernel-level twin of `bsi.host.sum_slice`."""
    planes = _words(planes, device)
    ex, sg = planes[ROW_EXISTS], planes[ROW_SIGN]
    if src is not None:
        ex = ex & _words(src, planes.device)
    neg = ex & sg
    mags = planes[ROW_PLANE0:ROW_PLANE0 + schema.bit_depth]
    all_c = plane_counts(mags, ex)
    neg_c = plane_counts(mags, neg)
    count = int(plane_counts(ex.reshape(1, -1))[0])
    return sum_from_counts(all_c, neg_c), count


# -- tree-count + extremum search over dense blocks ---------------------------

def _count(blk: torch.Tensor) -> int:
    return int(pair_count(_containers(blk)))


def tree_count_dense(tree, planes, device="cuda") -> int:
    """Count of a bsi.lower cond tree over a dense row matrix: the device
    analog of counting `bsi.host.eval_rows(tree, frag)`. Leaves index rows
    of `planes` by row id."""
    if tree == EMPTY:
        return 0
    planes = _words(planes, device)
    return _count(fold_tree(tree, lambda row_id: planes[row_id]))


def extremum_dense(planes, schema: FieldSchema, maximize: bool,
                   src=None, device="cuda") -> Optional[Tuple[int, int]]:
    """-> (value, count) extremum over one dense row matrix, or None when
    empty: an MSB-down search issuing one count per plane, with the
    semantics of `bsi.host.max_slice`/`min_slice` (positives win for max,
    negatives for min)."""
    planes = _words(planes, device)
    ex, sg = planes[ROW_EXISTS], planes[ROW_SIGN]
    if src is not None:
        ex = ex & _words(src, planes.device)
    pos, neg = ex & ~sg, ex & sg

    def search(cand, big_mag: bool) -> Tuple[int, int]:
        mag = 0
        for k in range(schema.bit_depth - 1, -1, -1):
            p = planes[ROW_PLANE0 + k]
            inter = cand & p
            if big_mag:
                if _count(inter):
                    cand, mag = inter, mag | (1 << k)
            else:
                rest = cand & ~p
                if _count(rest):
                    cand = rest
                else:
                    cand, mag = inter, mag | (1 << k)
        return mag, _count(cand)

    order = ((pos, 1), (neg, -1)) if maximize else ((neg, -1), (pos, 1))
    for side, sign in order:
        if _count(side):
            # max: positives hold the largest magnitude, negatives the
            # smallest; min mirrors.
            mag, n = search(side, big_mag=(sign > 0) == maximize)
            return sign * mag, n
    return None
