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

The host folds of a lowered tree live here too (HostQueryCache,
HostCountPlan, HostMaterializePlan): the executor's host route.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..bsi.lower import lower_cond
from ..core.fragment import MUTATION_EPOCH
from ..core.row import Row
from ..core.timequantum import parse_time, views_by_time_range
from ..core.view import VIEW_INVERSE, VIEW_STANDARD
from ..obs import profile
from ..obs import span as obs_span
from ..ops import native
from ..ops.bitops import fold_tree
from ..ops.kernels import tree_program
from ..pql.ast import Cond
from ..roaring.bitmap import (ARRAY_MAX_SIZE, Bitmap, Container,
                              bitmap_to_values)

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


# -- the host folds ------------------------------------------------------------
#
# The host route of a lowerable tree (the JAX package's
# pilosa_tpu/parallel/plan.py:282-786, without its whole-query memo):
# each leaf row of a slice expands to one dense (16 * 1024,) uint64
# block straight from its fragment's containers, the tree folds over the
# blocks (ops.native.fold_count: the fused C++ fold for a flat tree,
# numpy for a nested one), and only a Bitmap result becomes roaring.
# Host words only: the roaring containers' uint64, no torch tensor.

ROW_WORDS = 16 * 1024  # uint64 words of one row in one slice


class HostQueryCache:
    """Generation-checked caches of the host folds, one per executor.
    Every layer validates against the fragments' mutation generations
    (any write moves one, and they never go back, so an entry stored
    against a state a racing write already passed can never validate):

      - leaf blocks: (fragment, row) -> its dense (16 * 1024,) uint64
        block, at most _BLOCKS_MAX (128 KiB each, 32 MiB). Blocks are
        never mutated (fold_tree makes new arrays).
      - per-slice counts: (index, tree, leaves, slice) -> count, at most
        _MEMO_MAX, validated by the (fragment, generation) of each leaf
        view of the slice: a repeat reads generations, not words.
      - leaf matrices: (index, frame, view, row, slices) -> the row's
        (S, 16 * 1024) stack for HostMaterializePlan, validated by the
        process-wide MUTATION_EPOCH and bounded in bytes
        (PILOSA_TORCH_MATRIX_CACHE_MB, default 384, read at every put).

    Entries hold weak fragment references: a deleted index's fragments
    stay collectable, and a dead reference never validates. One lock,
    held for dict-sized work only, never across an extraction or a
    fold. Lock order: a fragment's _mu may be held while this lock is
    taken, never the other way round. `stats` has the JAX package's
    keys; the `query_*` ones stay 0 (the whole-query memo is not
    ported)."""

    _BLOCKS_MAX = 256
    _MEMO_MAX = 4096

    def __init__(self):
        self._mu = threading.Lock()
        self._blocks: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._memo: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._matrix: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._matrix_bytes = 0
        self.stats = {"block_hit": 0, "block_miss": 0,
                      "memo_hit": 0, "memo_miss": 0,
                      "query_hit": 0, "query_miss": 0, "query_reval": 0,
                      "matrix_hit": 0, "matrix_miss": 0}

    @staticmethod
    def _matrix_budget_bytes() -> int:
        return int(os.environ.get("PILOSA_TORCH_MATRIX_CACHE_MB",
                                  "384")) << 20

    def matrix_get(self, key: tuple, epoch: int):
        with self._mu:
            e = self._matrix.get(key)
            if e is not None and e[0] == epoch:
                self._matrix.move_to_end(key)
                self.stats["matrix_hit"] += 1
                return e[1]
            self.stats["matrix_miss"] += 1
            return None

    def matrix_put(self, key: tuple, epoch: int, matrix) -> None:
        with self._mu:
            old = self._matrix.pop(key, None)
            if old is not None:
                self._matrix_bytes -= old[1].nbytes
            self._matrix[key] = (epoch, matrix)
            self._matrix_bytes += matrix.nbytes
            budget = self._matrix_budget_bytes()
            while self._matrix_bytes > budget and len(self._matrix) > 1:
                _, (_, m) = self._matrix.popitem(last=False)
                self._matrix_bytes -= m.nbytes

    def block_get(self, frag, row_id: int, gen: int):
        key = (id(frag), int(row_id))
        with self._mu:
            e = self._blocks.get(key)
            # The identity check guards against id() reuse: a live weak
            # reference keeps its target's id.
            if e is not None and e[0]() is frag and e[1] == gen:
                self._blocks.move_to_end(key)
                self.stats["block_hit"] += 1
                return e[2]
            self.stats["block_miss"] += 1
            return None

    def block_put(self, frag, row_id: int, gen: int, words) -> None:
        key = (id(frag), int(row_id))
        with self._mu:
            self._blocks[key] = (weakref.ref(frag), gen, words)
            self._blocks.move_to_end(key)
            while len(self._blocks) > self._BLOCKS_MAX:
                self._blocks.popitem(last=False)

    def memo_get(self, key: tuple, snapshot: tuple):
        """`snapshot`: live (fragment or None, generation) pairs; the
        stored entry holds weak references."""
        with self._mu:
            e = self._memo.get(key)
            if e is not None and len(e[0]) == len(snapshot) and all(
                    (f0() if f0 is not None else None) is f1 and g0 == g1
                    for (f0, g0), (f1, g1) in zip(e[0], snapshot)):
                self._memo.move_to_end(key)
                self.stats["memo_hit"] += 1
                return e[1]
            self.stats["memo_miss"] += 1
            return None

    def memo_put(self, key: tuple, snapshot: tuple, count: int) -> None:
        with self._mu:
            self._memo[key] = (tuple(
                (weakref.ref(f) if f is not None else None, g)
                for f, g in snapshot), count)
            self._memo.move_to_end(key)
            while len(self._memo) > self._MEMO_MAX:
                self._memo.popitem(last=False)


class HostCountPlan:
    """A Count of a lowered tree on the host: per slice, one dense
    block a leaf row (an array container expands to words), the tree
    folded over them and counted by ops.native.fold_count (one fused
    C++ pass for a flat tree). No roaring container is built and no
    intermediate counted. An absent view, fragment or row reads as an
    all-zero block. `shape` and `leaves` come from plan._lower_tree (or
    any lowered tree, numbered or not); `cache` is a HostQueryCache
    (None: no caching)."""

    _ZEROS = None  # the shared all-zero block; read-only by convention

    def __init__(self, holder, index: str, shape, leaves: List[tuple],
                 cache: Optional[HostQueryCache] = None):
        self.holder = holder
        self.index = index
        self.leaves = leaves
        self._sig = _tree_signature(shape)
        self.cache = cache
        if cache is not None:
            self._sig_json = json.dumps(self._sig)
            self._leaves_key = tuple(
                (f, v, int(r), bool(q)) for f, v, r, q in leaves)
            # Each (frame, view) once, in order: the snapshot reads each
            # fragment's generation once.
            self._uniq_views = list(dict.fromkeys(
                (f, v) for f, v, _r, _q in leaves))

    @classmethod
    def _zeros(cls):
        if cls._ZEROS is None:
            cls._ZEROS = np.zeros(ROW_WORDS, dtype=np.uint64)
        return cls._ZEROS

    def _gen_snapshot(self, slice_: int) -> tuple:
        """(fragment or None, generation) of each leaf view of the slice:
        the count memo's validation token."""
        snap = []
        for frame, view in self._uniq_views:
            frag = self.holder.fragment(self.index, frame, view, slice_)
            if frag is None:
                snap.append((None, -1))
            else:
                with frag._mu:
                    snap.append((frag, frag.generation))
        return tuple(snap)

    def _leaf_words(self, frame, view, row_id, slice_):
        frag = self.holder.fragment(self.index, frame, view, slice_)
        if frag is None:
            return self._zeros()
        cache = self.cache
        with frag._mu:
            frag.ensure_loaded()
            if cache is not None:
                gen = frag.generation
                w = cache.block_get(frag, row_id, gen)
                if w is not None:
                    return w
            storage = frag.storage
            base = row_id * 16
            keys = storage.keys
            i = bisect.bisect_left(keys, base)
            if i >= len(keys) or keys[i] >= base + 16:
                return self._zeros()
            out = np.zeros(ROW_WORDS, dtype=np.uint64)
            while i < len(keys) and keys[i] < base + 16:
                sub = keys[i] - base
                out[sub * 1024:(sub + 1) * 1024] = \
                    storage.containers[i].words()
                i += 1
        if cache is not None:
            cache.block_put(frag, row_id, gen, out)
        return out

    def count_slice(self, slice_: int) -> int:
        cache = self.cache
        key = snap = None
        if cache is not None:
            snap = self._gen_snapshot(slice_)
            key = (self.index, self._sig_json, self._leaves_key, slice_)
            n = cache.memo_get(key, snap)
            if n is not None:
                return n
        blocks = [self._leaf_words(frame, view, row_id, slice_)
                  for frame, view, row_id, _req in self.leaves]
        n = native.fold_count(blocks, self._sig)
        if cache is not None:
            # The snapshot was read before the blocks: a write in
            # between left it stale already, so the entry never
            # validates.
            cache.memo_put(key, snap, n)
        return n

    def count_slices(self, slices) -> int:
        """The Count over `slices`, summed inline (the memo answers most
        slices of a repeat in microseconds, so a thread fan-out would
        cost more than it saves): the `host_fold` span and profile
        phase, and with a profile active its bytes_touched_hbm (128 KiB
        a leaf a slice, the fold's reads) and one row a slice."""
        slices = list(slices)
        with obs_span("host_fold", slices=len(slices)), \
                profile.phase("host_fold"):
            prof = profile.current()
            total = 0
            for s in slices:
                t0 = time.monotonic_ns() if prof is not None else 0
                n = self.count_slice(s)
                total += n
                if prof is not None:
                    prof.add_bytes("bytes_touched_hbm",
                                   len(self.leaves) * ROW_WORDS * 8)
                    prof.add_slice(
                        slice=int(s), engine="host_fold", count=int(n),
                        us=round((time.monotonic_ns() - t0) / 1e3, 1))
            return total


class HostMaterializePlan(HostCountPlan):
    """A Bitmap result of a lowered tree on the host: the leaves' dense
    blocks fold once (sharing HostCountPlan's block cache) and only the
    result becomes roaring, one segment a slice
    (Bitmap.from_dense_words), where the Row path builds every
    operand's containers and merges them pairwise."""

    def materialize_slice(self, slice_: int):
        """The slice's folded roaring Bitmap, or None when no leaf holds
        data there."""
        blocks = []
        nonzero = False
        for frame, view, row_id, _req in self.leaves:
            w = self._leaf_words(frame, view, row_id, slice_)
            nonzero = nonzero or w is not self._zeros()
            blocks.append(w)
        if not nonzero:
            return None
        acc = fold_tree(self._sig, lambda i: blocks[i])
        if any(acc is b for b in blocks):
            acc = acc.copy()  # a one-leaf tree folds to a cached block
        return Bitmap.from_dense_words(acc, own=True)

    def _leaf_matrix(self, frame, view, row_id, slices):
        """One leaf row's (len(slices), 16 * 1024) uint64 stack, through
        the epoch-checked matrix cache; a miss restacks from the block
        cache."""
        cache = self.cache
        key = epoch = None
        if cache is not None:
            epoch = MUTATION_EPOCH.n
            key = (self.index, frame, view, int(row_id), tuple(slices))
            m = cache.matrix_get(key, epoch)
            if m is not None:
                return m
        m = np.empty((len(slices), ROW_WORDS), dtype=np.uint64)
        for j, s in enumerate(slices):
            m[j] = self._leaf_words(frame, view, row_id, s)
        if cache is not None:
            cache.matrix_put(key, epoch, m)
        return m

    def materialize_row(self, slices) -> Row:
        """The whole batch folded as (S, 16 * 1024) matrices (one pass a
        tree node), one per-container popcount (the fused fold gives it
        for a flat tree), and the Row built from the nonzero containers
        with its per-slice counts filled. Bitmap containers are views
        into the result unless under a quarter of it is nonzero; then
        they are copies, so a few containers do not pin the whole
        buffer."""
        slices = list(slices)
        mats = [self._leaf_matrix(f, v, r, slices)
                for f, v, r, _req in self.leaves]
        sig = self._sig
        fused = None
        if all(c[0] == "leaf" for c in sig[1:]):
            fused = native.fold_blocks([mats[c[1]] for c in sig[1:]],
                                       sig[0])
        if fused is not None:
            flat, counts = fused
            acc = flat.reshape(len(slices), ROW_WORDS)
        else:
            acc = fold_tree(sig, lambda i: mats[i])
            if any(acc is m for m in mats):
                acc = acc.copy()  # never hand out cached memory
            counts = native.popcnt_blocks(acc.reshape(-1))
        return _row_of_blocks(acc, counts, slices)


def _row_of_blocks(acc, counts, slices) -> Row:
    """A Row of the (S, 16 * 1024) words `acc` (row s of it is slice
    slices[s]) and their per-container popcounts."""
    blocks = list(acc.reshape(-1, 1024))
    counts_l = counts.tolist()
    nz = np.flatnonzero(counts).tolist()
    copy_blocks = len(nz) * 4 < len(blocks)
    per_slice = counts.reshape(-1, 16).sum(axis=1).tolist()
    row = Row()
    cur_slice = -1
    seg = None
    for idx in nz:
        s_j = idx >> 4
        if s_j != cur_slice:
            cur_slice = s_j
            seg = Bitmap()
            row.segments[slices[s_j]] = seg
            row._counts[slices[s_j]] = per_slice[s_j]
        c = Container.__new__(Container)
        c.shared = False
        c.fnv = None
        if counts_l[idx] <= ARRAY_MAX_SIZE:
            c.array = bitmap_to_values(blocks[idx])
            c.bitmap = None
        else:
            c.array = None
            c.bitmap = blocks[idx].copy() if copy_blocks else blocks[idx]
        seg.keys.append(idx & 15)
        seg.containers.append(c)
    return row
