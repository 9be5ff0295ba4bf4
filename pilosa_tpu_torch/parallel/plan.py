"""PQL call tree -> the numbered op tree the count kernels fold.

Bitmap leaves (a row on the standard view, or a column on the inverse
view) combined by Intersect / Union / Difference, Range(frame=f,
field <op> N) over an integer field's plane rows (bsi.lower), and the
time Range(frame=f, rowID=r, start=..., end=...) as an OR of the row
over the views that cover the time range, lower to a nested op list
plus the (frame, view, row_id, required) leaf list. A time view's leaf
is not required: a view or fragment that does not exist reads as an
empty row.
canonical_tree then puts the tree in the form the kernels fold best:
leaves deduplicated by (frame, view, row) and numbered by first use, and
the deepest operand of every and/or first, so the BSI ladders become
left-deep chains in the kernels' accumulator. Anything else returns
None and the executor answers on the host: a time Range on a frame
without a quantum or whose cover is wider than MAX_RANGE_VIEWS, and
trees beyond the kernels' limits (ops.kernels.MAX_LEAVES unique leaves,
MAX_DEPTH held values, their program length).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

from ..bsi.lower import lower_cond
from ..core.timequantum import parse_time, views_by_time_range
from ..core.view import VIEW_INVERSE, VIEW_STANDARD
from ..ops.kernels import tree_program
from ..pql.ast import Cond

# Frame used when a query doesn't name one.
DEFAULT_FRAME = "general"

# Call names evaluable on device, keyed to bitwise combiners.
_TREE_OPS = {"Intersect": "and", "Union": "or", "Difference": "andnot"}

# Views a time Range may OR on the card; a wider cover (fine quanta over
# a long range) goes to the host.
MAX_RANGE_VIEWS = 32


# The recursive helpers below are module functions, not nested closures:
# a recursive closure is a reference cycle, garbage only the cyclic
# collector frees, and a few per query make the collector's full passes
# over a large holder come much more often.


def _tree_signature(node) -> object:
    """The numbered nested-list tree of a shape: ["leaf"] markers are
    numbered depth-first; numbered leaves keep their number."""
    return _signature_walk(node, [0])


def _signature_walk(n, counter: list):
    if n[0] == "leaf":
        if len(n) > 1:
            return ["leaf", n[1]]
        counter[0] += 1
        return ["leaf", counter[0] - 1]
    return [n[0]] + [_signature_walk(c, counter) for c in n[1:]]


def format_signature(sig: str, formats) -> str:
    """A plan signature tagged with the container format(s) a launch
    reads ("ss", "sd", "ds", "dd", or any tag): a sorted-array launch
    takes its strikes under the tagged signature, so a failing format
    group quarantines only itself."""
    if isinstance(formats, str):
        formats = (formats,)
    return sig + "|fmt=" + ",".join(formats)


class PlanQuarantine:
    """Plan signatures kept off the card for a time after repeated
    out-of-memory failures: the quarantine of the JAX package's
    CompiledPlanCache (pilosa_tpu/parallel/plan.py:184-232), without its
    program cache (the port compiles nothing). `stats["quarantined"]`
    counts quarantines."""

    def __init__(self):
        self._mu = threading.Lock()
        self._until: Dict[str, float] = {}  # sig -> monotonic expiry
        self.stats = {"quarantined": 0}

    def quarantine(self, sig: str, ttl_s: float,
                   now: Optional[float] = None) -> None:
        """Keep `sig` off the card for ttl_s seconds."""
        if now is None:
            now = time.monotonic()
        with self._mu:
            self._until[sig] = now + float(ttl_s)
            self.stats["quarantined"] += 1

    def is_quarantined(self, sig: str, now: Optional[float] = None) -> bool:
        """Whether `sig` is quarantined now; an expired entry goes."""
        if now is None:
            now = time.monotonic()
        with self._mu:
            until = self._until.get(sig)
            if until is None:
                return False
            if now >= until:
                del self._until[sig]
                return False
            return True

    def quarantined_sigs(self, now: Optional[float] = None) -> List[str]:
        """The live (unexpired) quarantined signatures, sorted."""
        if now is None:
            now = time.monotonic()
        with self._mu:
            for sig in [s for s, t in self._until.items() if now >= t]:
                del self._until[sig]
            return sorted(self._until)

    def clear_quarantine(self, sig: Optional[str] = None) -> int:
        """Lift one signature's quarantine, or every one; returns how
        many were lifted."""
        with self._mu:
            if sig is None:
                n = len(self._until)
                self._until.clear()
                return n
            return 1 if self._until.pop(sig, None) is not None else 0


def canonical_tree(shape, leaves: List[tuple], out: List[tuple]):
    """The kernels' form of a lowered (shape, leaves): returns the
    numbered tree and fills `out` with its unique leaves, or returns None
    when the tree is beyond the kernels' limits. Every and/or puts its
    deepest operand first (stable among equals), which is where the
    accumulator form holds it for free; andnot keeps its first operand.
    Leaves sharing (frame, view, row) share a slot, numbered by first use
    in the reordered tree."""
    tree = _number(_order(shape, iter(leaves))[0], {}, out)
    try:
        tree_program(tree)
    except ValueError:
        out.clear()
        return None
    return tree


def _held_depth(kid) -> int:
    return -kid[1]


def _order(n, leaves):
    """(node with leaf tuples taken from `leaves` in order, held-value
    depth), with the deepest operand of every and/or first."""
    if n[0] == "leaf":
        return ("leaf", next(leaves)), 1
    kids = [_order(c, leaves) for c in n[1:]]
    if n[0] in ("and", "or"):
        kids.sort(key=_held_depth)
    depth = max([kids[0][1]] + [1 + d for _, d in kids[1:]])
    return (n[0],) + tuple(k for k, _ in kids), depth


def _number(n, slots: dict, out: List[tuple]):
    if n[0] == "leaf":
        key = n[1][:3]
        if key not in slots:
            slots[key] = len(out)
            out.append(n[1])
        return ["leaf", slots[key]]
    return [n[0]] + [_number(c, slots, out) for c in n[1:]]


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
    if c.name == "Range":
        if any(isinstance(v, Cond) for v in c.args.values()):
            return lower_cond(holder, index, c, leaves)
        return _lower_range(holder, index, c, leaves)
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


def _lower_range(holder, index: str, c, leaves: List[tuple]):
    """Range(frame=f, rowID=r, start=..., end=...) as an OR of row r
    over the views covering [start, end), each leaf not required; None
    (host path) without a quantum, a row argument or parseable times,
    or with more than MAX_RANGE_VIEWS views."""
    idx = holder.index(index)
    if idx is None:
        return None
    frame = c.args.get("frame") or DEFAULT_FRAME
    f = idx.frame(frame)
    if f is None:
        return None
    try:
        row_id, ok = c.uint_arg(f.row_label)
    except TypeError:
        return None
    start, end = c.args.get("start"), c.args.get("end")
    if not ok or not isinstance(start, str) or not isinstance(end, str):
        return None
    try:
        views = views_by_time_range(VIEW_STANDARD, parse_time(start),
                                    parse_time(end), f.time_quantum)
    except ValueError:
        return None
    if not views or len(views) > MAX_RANGE_VIEWS:
        return None
    leaves.extend((frame, v, row_id, False) for v in views)
    if len(views) == 1:
        return ["leaf"]
    return ["or"] + [["leaf"] for _ in views]


def _lower_tree(holder, index: str, c, leaves: List[tuple]) -> Optional[list]:
    """Call -> the canonical numbered tree (canonical_tree), filling
    `leaves` with its unique leaves; None if not lowerable or beyond the
    kernels' limits."""
    raw: List[tuple] = []
    shape = _lower_call(holder, index, c, raw)
    if shape is None:
        return None
    return canonical_tree(shape, raw, leaves)


def plan_signature(shape) -> str:
    """The plan signature of a lowered tree: its numbered form as JSON,
    the key of the quarantine."""
    return json.dumps(_tree_signature(shape))
