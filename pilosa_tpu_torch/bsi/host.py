"""Host roaring folds for BSI calls: the exact oracle, and the path for
what does not lower.

Exact integer math over roaring Rows read from the fragments. Per-slice
results are Python ints, so no sum overflows here.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..core.row import Row
from .field import ROW_EXISTS, ROW_PLANE0, ROW_SIGN, FieldSchema
from .lower import EMPTY, cond_tree

_EMPTY_ROW = Row()


def _frag_row(frag, row_id: int) -> Row:
    return frag.row(row_id) if frag is not None else _EMPTY_ROW


def eval_rows(tree: tuple, frag) -> Row:
    """Fold a bsi.lower tree over one fragment's rows."""
    if tree == EMPTY:
        return _EMPTY_ROW
    op = tree[0]
    if op == "leaf":
        return _frag_row(frag, tree[1])
    acc = eval_rows(tree[1], frag)
    for sub in tree[2:]:
        v = eval_rows(sub, frag)
        if op == "and":
            acc = acc.intersect(v)
        elif op == "or":
            acc = acc.union(v)
        else:  # andnot
            acc = acc.difference(v)
    return acc


def range_row(frag, schema: FieldSchema, op: str, value) -> Row:
    """Columns of one bsi fragment with ``field <op> value``."""
    return eval_rows(cond_tree(schema, op, value), frag)


def _split(frag, filter_row: Optional[Row]) -> Tuple[Row, Row]:
    """(pos, neg): the existing columns on each side of the sign split,
    within `filter_row` when given."""
    ex = _frag_row(frag, ROW_EXISTS)
    if filter_row is not None:
        ex = ex.intersect(filter_row)
    sg = _frag_row(frag, ROW_SIGN)
    return ex.difference(sg), ex.intersect(sg)


def sum_slice(frag, schema: FieldSchema,
              filter_row: Optional[Row] = None) -> Tuple[int, int]:
    """(sum, count) of the field over one slice's fragment:
    sum = sum_k 2^k * (|plane_k AND pos| - |plane_k AND neg|)."""
    pos, neg = _split(frag, filter_row)
    total = 0
    for k in range(schema.bit_depth):
        p = _frag_row(frag, ROW_PLANE0 + k)
        total += (1 << k) * (p.intersection_count(pos)
                             - p.intersection_count(neg))
    return total, pos.count() + neg.count()


def _search_mag(frag, schema: FieldSchema, cand: Row,
                maximize: bool) -> Tuple[int, Row]:
    """Search the magnitude planes MSB to LSB over candidates `cand`;
    (magnitude, the columns holding it)."""
    mag = 0
    for k in range(schema.bit_depth - 1, -1, -1):
        p = _frag_row(frag, ROW_PLANE0 + k)
        if maximize:
            hit = cand.intersect(p)
            if hit.count():
                cand = hit
                mag |= 1 << k
        else:
            miss = cand.difference(p)
            if miss.count():
                cand = miss
            else:
                cand = cand.intersect(p)
                mag |= 1 << k
    return mag, cand


def max_slice(frag, schema: FieldSchema,
              filter_row: Optional[Row] = None
              ) -> Optional[Tuple[int, int]]:
    """(max value, columns holding it) over one slice, or None when no
    column has a value. Positives win; without them the max is minus the
    smallest negative magnitude."""
    pos, neg = _split(frag, filter_row)
    if pos.count():
        mag, cand = _search_mag(frag, schema, pos, maximize=True)
        return mag, cand.count()
    if neg.count():
        mag, cand = _search_mag(frag, schema, neg, maximize=False)
        return -mag, cand.count()
    return None


def min_slice(frag, schema: FieldSchema,
              filter_row: Optional[Row] = None
              ) -> Optional[Tuple[int, int]]:
    """The mirror of max_slice: negatives win with the largest
    magnitude."""
    pos, neg = _split(frag, filter_row)
    if neg.count():
        mag, cand = _search_mag(frag, schema, neg, maximize=True)
        return -mag, cand.count()
    if pos.count():
        mag, cand = _search_mag(frag, schema, pos, maximize=False)
        return mag, cand.count()
    return None


def reduce_extremes(parts, maximize: bool) -> Optional[Tuple[int, int]]:
    """Combine per-slice (value, count) pairs (None = an empty slice)
    into the overall (value, count)."""
    best = None
    total = 0
    for part in parts:
        if part is None:
            continue
        v, n = part
        if best is None or (v > best if maximize else v < best):
            best, total = v, n
        elif v == best:
            total += n
    return None if best is None else (best, total)
