"""PQL call tree -> the numbered op shape the count kernels fold.

Bitmap (a row on the standard view, or a column on the inverse view)
leaves combined by Intersect / Union / Difference lower to a nested op
list with leaves numbered depth-first, plus the (frame, view, row_id,
required) leaf list. Anything else returns None and the executor
answers on the host: Range and integer-field trees, and trees beyond
the kernels' limits (ops.kernels.MAX_LEAVES leaves, MAX_DEPTH stack).
"""

from __future__ import annotations

from typing import List

from ..core.view import VIEW_INVERSE, VIEW_STANDARD
from ..ops.kernels import MAX_DEPTH, MAX_LEAVES, tree_depth

# Frame used when a query doesn't name one.
DEFAULT_FRAME = "general"

# Call names evaluable on device, keyed to bitwise combiners.
_TREE_OPS = {"Intersect": "and", "Union": "or", "Difference": "andnot"}


def _tree_signature(node) -> object:
    """Canonical nested-list shape of a call tree; leaves are numbered in
    depth-first order."""
    counter = [0]

    def walk(n):
        if n[0] == "leaf":
            i = counter[0]
            counter[0] += 1
            return ["leaf", i]
        return [n[0]] + [walk(c) for c in n[1:]]

    return walk(node)


def _lower_call(holder, index: str, c, leaves: List[tuple]):
    if c.name == "Bitmap":
        idx = holder.index(index)
        if idx is None:
            return None
        frame = c.args.get("frame") or DEFAULT_FRAME
        f = idx.frame(frame)
        if f is None:
            return None
        try:
            row_id, row_ok = c.uint_arg(f.row_label)
            col_id, col_ok = c.uint_arg(idx.column_label)
        except TypeError:
            return None
        if row_ok and not col_ok:
            leaves.append((frame, VIEW_STANDARD, row_id, True))
            return ["leaf"]
        if col_ok and not row_ok and f.inverse_enabled:
            leaves.append((frame, VIEW_INVERSE, col_id, True))
            return ["leaf"]
        return None  # both/neither/disabled inverse -> host path
    op = _TREE_OPS.get(c.name)
    if op is None or not c.children:
        return None
    parts = []
    for child in c.children:
        sub = _lower_call(holder, index, child, leaves)
        if sub is None:
            return None
        parts.append(sub)
    return [op] + parts


def _lower_tree(holder, index: str, c, leaves: List[tuple]):
    """Call -> nested shape list, collecting leaves; None if not
    lowerable or beyond the kernels' limits."""
    shape = _lower_call(holder, index, c, leaves)
    if shape is None or len(leaves) > MAX_LEAVES \
            or tree_depth(shape) > MAX_DEPTH:
        return None
    return shape
