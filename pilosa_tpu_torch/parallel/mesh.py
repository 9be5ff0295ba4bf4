"""Staging a view's fragments onto the card, and counting over them.

One view stages as a ShardedIndex: its slices' containers packed into
one (S, cap, 2048) int32 device tensor (cap padded to a multiple of
ROW_SPAN, so every row's containers can sit as one aligned run), the
(S, cap) host copy of the sorted pool keys, and the global row table.
This port runs on one device: the slice axis is not sharded.

Leaf rows are resolved on the host (resolve_row_indices,
coarse_row_starts). A row staged as one aligned 16-container run in
every slice that holds it is `coarse` and its count reads whole runs
(K1/K2); when that run sits at one index in every slice the layout is
`uniform` and a single start per leaf serves all slices. Other rows are
read container by container through their container index (index_row,
kept on the card with a staged view), K3. count_batch picks the kernel.

Slices of low fill stage instead as sorted u16 value arrays
(SparseShardedIndex, pick_slice_formats); count_sparse_pair counts a
two-leaf op over them (K4 for two sorted-array leaves).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import kernels
from ..ops.bitops import (fold_tree, popcount, sparse_op_counts,
                          sparse_probe_intersect_counts)
from ..ops.pool import (CONTAINER_WORDS, INVALID_KEY, ROW_SPAN,
                        mutation_batch_width, pad_mutation_plan, pool_keys)
from ..roaring import ARRAY_MAX_SIZE

# Host bytes packed per host-to-device copy while staging.
_STAGE_CHUNK_BYTES = 64 << 20


class ShardedIndex(NamedTuple):
    """One frame/view's fragments, stacked on the device."""

    words: torch.Tensor     # (S, cap, CONTAINER_WORDS) int32
    keys_host: np.ndarray   # (S, cap) int32, sorted, INVALID_KEY padded
    row_ids: np.ndarray     # (R,) uint64 global dense row table

    @property
    def num_slices(self) -> int:
        return self.words.shape[0]

    @property
    def capacity(self) -> int:
        return self.words.shape[1]


def global_row_ids(slices: Sequence) -> np.ndarray:
    """The sorted uint64 row-id table over every slice's packed keys
    (slices[s][0], or None for an absent or other-format slice): shared
    by the dense and sorted-array pools of one view."""
    rows = [sl[0] >> np.uint64(4) for sl in slices
            if sl is not None and len(sl[0])]
    return (np.unique(np.concatenate(rows)) if rows
            else np.empty(0, dtype=np.uint64))


def build_sharded_index(slices: Sequence, device,
                        capacity: Optional[int] = None,
                        row_ids: Optional[np.ndarray] = None) -> ShardedIndex:
    """Stack per-slice containers into one device pool. slices[s] is
    ops.pool.pack_bitmap of slice s's bitmap, or None for an absent
    fragment (or one staged sorted-array). row_ids, when given, is the
    view's global row table (global_row_ids); capacity=0 stages an empty
    pool for a view whose populated slices all went sorted-array. The
    pool fills in host chunks of _STAGE_CHUNK_BYTES, each copied into
    the preallocated device tensor."""
    device = torch.device(device)
    s = max(1, len(slices))
    if row_ids is None:
        row_ids = global_row_ids(slices)
    counts = [len(sl[0]) if sl is not None else 0 for sl in slices]
    cap = capacity if capacity is not None else max(1, max(counts, default=1))
    cap = -(-cap // ROW_SPAN) * ROW_SPAN

    keys = np.full((s, cap), INVALID_KEY, dtype=np.int32)
    for si, sl in enumerate(slices):
        if sl is not None:
            keys[si, :len(sl[0])] = pool_keys(sl[0], row_ids)

    words = torch.empty((s, cap, CONTAINER_WORDS), dtype=torch.int32,
                        device=device)
    chunk = max(1, _STAGE_CHUNK_BYTES // max(1, cap * CONTAINER_WORDS * 4))
    for lo in range(0, s, chunk):
        hi = min(s, lo + chunk)
        buf = np.zeros((hi - lo, cap, CONTAINER_WORDS), dtype=np.uint32)
        for si in range(lo, hi):
            if slices[si] is not None:
                buf[si - lo, :len(slices[si][1])] = slices[si][1]
        words[lo:hi].copy_(torch.from_numpy(buf.view(np.int32)))
    return ShardedIndex(words=words, keys_host=keys, row_ids=row_ids)


def pack_mutation_batches(per_slice, num_slices: int, capacity: int):
    """Stack per-slice plan_slice_mutations results into padded (S, B)
    batches (slot int32, word int32, set_mask uint32, clear_mask
    uint32) for apply_writes. per_slice: {slice: plan}. B is the power
    of two of the widest slice's plan; padding rides slot = capacity,
    which the scatter drops (ops.pool.pad_mutation_plan). Only the
    written slices are padded one by one; the rest start as padding."""
    widest = max((len(v[0]) for v in per_slice.values()), default=0)
    b = mutation_batch_width(widest)
    out = (np.full((num_slices, b), capacity, dtype=np.int32),
           np.zeros((num_slices, b), dtype=np.int32),
           np.zeros((num_slices, b), dtype=np.uint32),
           np.zeros((num_slices, b), dtype=np.uint32))
    for si, plan in per_slice.items():
        for dst, src in zip(out, pad_mutation_plan(plan, capacity, b)):
            dst[si] = src
    return out


def apply_writes(staged: ShardedIndex, slot, word, set_mask, clear_mask
                 ) -> ShardedIndex:
    """Scatter pack_mutation_batches' (S, B) batches into the staged
    pool, in place (K7, kernels.scatter_words): one copy of the four
    batches to the card, one launch. The keys and the row table do not
    change, so the same ShardedIndex comes back."""
    host = np.stack([np.ascontiguousarray(a).view(np.int32)
                     for a in (slot, word, set_mask, clear_mask)])
    dev = torch.from_numpy(host).to(staged.words.device)
    kernels.scatter_words(staged.words, dev[0], dev[1], dev[2], dev[3])
    return staged


def staged_from_numpy(keys_host: np.ndarray, words, row_ids: np.ndarray,
                      device) -> ShardedIndex:
    """The JAX package's staged pool (the numpy keys, words and row ids
    its build_sharded_index(..., with_host_keys=True) yields) as this
    port's ShardedIndex. The words are copied."""
    w = np.array(words, dtype=np.uint32, order="C")
    return ShardedIndex(
        words=torch.from_numpy(w.view(np.int32)).to(torch.device(device)),
        keys_host=np.ascontiguousarray(keys_host, dtype=np.int32),
        row_ids=np.asarray(row_ids, dtype=np.uint64))


# -- sorted-array ("sparse") staging ------------------------------------------
#
# The dense image bills 8 KB per container whatever its cardinality: a
# container 3% full carries ~2 K values = 4 KB, one 0.3% full ~200 values
# = 400 B. Slices whose mean container fill is under a density threshold
# stage as sorted u16 value arrays plus a cardinality table; the rest
# keep packed words. One view can hold both pools, and a per-slice format
# byte says which pool serves each slice (pilosa_tpu/parallel/mesh.py:
# 381-616).

# Mean container fill under which a slice stages as sorted arrays (the
# reference's default).
DEFAULT_SPARSE_DENSITY_THRESHOLD = 0.05

# A container of more than 4096 values is smaller as a bitmap (4096 x 2 B
# = 8 KB, the packed-word size): the roaring array/bitmap break-even.
ARRAY_VALUE_CAP = ARRAY_MAX_SIZE

# A slice of total cardinality under this never stages sorted-array: it
# is kilobytes either way, and the separate dispatch costs more than the
# memory it saves.
SPARSE_MIN_SLICE_CARD = 1024

# The value capacity K pads to a multiple of this.
_VALUE_ALIGN = 128


class SparseShardedIndex(NamedTuple):
    """One frame/view's sorted-array slices, stacked on the device. Keys
    pack like ShardedIndex's (global dense row * 16 + sub-key), so
    resolve_row_indices works on either pool's host keys."""

    values: torch.Tensor    # (S, C, K) int16 holding u16, 0xFFFF padded
    cards: torch.Tensor     # (S, C) int32 real cardinalities
    keys_host: np.ndarray   # (S, C) int32, sorted, INVALID_KEY padded
    cards_host: np.ndarray  # (S, C) int32
    row_ids: np.ndarray     # (R,) uint64, shared with the dense pool

    @property
    def capacity(self) -> int:
        return self.values.shape[1]

    @property
    def value_cap(self) -> int:
        return self.values.shape[2]


def slice_format_stats(bitmaps: Sequence) -> np.ndarray:
    """Per-slice [n_containers, total_cardinality, max_cardinality] (S, 3)
    int64, from the containers' own counts, for pick_slice_formats. A
    slice stops at its first container over ARRAY_VALUE_CAP: its stats
    are then partial, but that max alone makes it ineligible, so the pick
    is the reference's (whose stats count every container) while a dense
    slice popcounts one bitmap container, not all of them."""
    out = np.zeros((len(bitmaps), 3), dtype=np.int64)
    for si, b in enumerate(bitmaps):
        if b is None or not len(b.keys):
            continue
        ns = []
        for c in b.containers:
            ns.append(c.n)
            if ns[-1] > ARRAY_VALUE_CAP:
                break
        out[si] = (len(ns), sum(ns), max(ns))
    return out


def pick_slice_formats(stats: np.ndarray, threshold: float,
                       prev: Optional[np.ndarray] = None,
                       band: float = 1.25,
                       value_cap: int = ARRAY_VALUE_CAP,
                       min_card: int = SPARSE_MIN_SLICE_CARD) -> np.ndarray:
    """Per-slice format: 1 = sorted-array, 0 = packed words.

    A slice goes sorted-array when its mean container fill
    (total / (n * 65536)) is under `threshold`, its total cardinality is
    at least `min_card`, and no container holds more than `value_cap`
    values. threshold <= 0 stages everything dense.

    Hysteresis: with `prev` (the formats before a restage), a slice keeps
    its format inside [threshold / band, threshold * band), so a slice
    near the boundary does not change layout on every restage."""
    s = stats.shape[0]
    n = stats[:, 0].astype(np.float64)
    total = stats[:, 1].astype(np.float64)
    density = np.where(n > 0, total / np.maximum(n, 1) / 65536.0, 1.0)
    eligible = ((stats[:, 0] > 0) & (stats[:, 2] <= value_cap)
                & (stats[:, 1] >= min_card))
    if threshold <= 0:
        return np.zeros(s, dtype=np.uint8)
    fmt = (eligible & (density < threshold)).astype(np.uint8)
    if prev is not None and band > 1.0:
        m = min(s, len(prev))
        was_sparse = prev[:m].astype(bool)
        keep_sparse = was_sparse & eligible[:m] & (
            density[:m] < threshold * band)
        go_sparse = ~was_sparse & eligible[:m] & (
            density[:m] < threshold / band)
        fmt[:m] = (keep_sparse | go_sparse).astype(np.uint8)
    return fmt


def split_bitmaps_by_format(slices: Sequence, formats: np.ndarray):
    """(dense, sparse): the full-length slice list twice, each with the
    other format's slices None."""
    dense = [b if not formats[si] else None for si, b in enumerate(slices)]
    sparse = [b if formats[si] else None for si, b in enumerate(slices)]
    return dense, sparse


def sparse_pool_dims(slices: Sequence) -> Tuple[int, int]:
    """(container capacity C, value capacity K) of the sorted-array pool
    over ops.pool.pack_sparse slices."""
    cap = max([1] + [len(sl[0]) for sl in slices if sl is not None])
    cap = -(-cap // ROW_SPAN) * ROW_SPAN
    max_card = max([1] + [int(sl[1].max()) for sl in slices
                          if sl is not None and len(sl[1])])
    return cap, -(-max_card // _VALUE_ALIGN) * _VALUE_ALIGN


def sparse_pool_bytes(num_slices: int, cap: int, k: int) -> int:
    """Device bytes of a (C = cap, K = k) sorted-array pool over
    num_slices slices: u16 values and i32 cards (the keys stay on the
    host). The JAX package's figure (pilosa_tpu/parallel/mesh.py:526) on
    a one-device mesh, less its 4-byte key a slot."""
    return max(1, num_slices) * cap * (k * 2 + 4)


def _dense_pool_bytes(num_slices: int, containers: int) -> int:
    """Device bytes of the packed-word pool over num_slices slices whose
    fullest slice holds `containers` (capacity padded to ROW_SPAN)."""
    cap = -(-containers // ROW_SPAN) * ROW_SPAN
    return max(1, num_slices) * cap * CONTAINER_WORDS * 4


def estimate_staged_bytes(slices: Sequence,
                          formats: Optional[np.ndarray] = None) -> int:
    """The device bytes staging these packed slices allocates, exactly:
    the padding of build_sharded_index and build_sparse_sharded_index.
    slices[s] is ops.pool.pack_sparse of slice s where formats[s] is 1,
    pack_bitmap elsewhere, or None for an absent fragment. It lets the
    budget refuse or make room for a staging before a byte moves (the
    JAX package's MeshManager._estimate_staged_bytes,
    pilosa_tpu/parallel/serve.py:974-999, whose figure on a one-device
    mesh is this one plus 4 bytes a key slot)."""
    if formats is not None and formats.any():
        dense, sparse = split_bitmaps_by_format(slices, formats)
        n = max((len(sl[0]) for sl in dense if sl is not None), default=0)
        return (_dense_pool_bytes(len(slices), n)
                + sparse_pool_bytes(len(slices), *sparse_pool_dims(sparse)))
    n = max((len(sl[0]) for sl in slices if sl is not None), default=1)
    return _dense_pool_bytes(len(slices), max(1, n))


def format_pool_bytes(stats: np.ndarray, formats: np.ndarray) -> int:
    """estimate_staged_bytes from per-slice [containers, total, max
    cardinality] stats (S, 3) and a format vector, without packing (the
    JAX package's MeshManager._format_pool_bytes,
    pilosa_tpu/parallel/serve.py:929-949): the figure an unstaged view
    would take, for the budget's routing peek and EXPLAIN."""
    s = len(formats)
    dense_n = stats[formats == 0, 0]
    if not formats.any():
        return _dense_pool_bytes(s, max(1, int(dense_n.max(initial=1))))
    sp = stats[formats != 0]
    cap = -(-max(1, int(sp[:, 0].max())) // ROW_SPAN) * ROW_SPAN
    k = -(-max(1, int(sp[:, 2].max())) // _VALUE_ALIGN) * _VALUE_ALIGN
    return (_dense_pool_bytes(s, int(dense_n.max(initial=0)))
            + sparse_pool_bytes(s, cap, k))


def build_sparse_sharded_index(slices: Sequence, device,
                               row_ids: Optional[np.ndarray] = None
                               ) -> SparseShardedIndex:
    """Stack the sorted-array slices into one device pool. slices[s] is
    ops.pool.pack_sparse of slice s's bitmap, or None (absent or dense),
    full-length so slice positions line up with the dense pool. Values
    pad with 0xFFFF to the pool's value capacity."""
    device = torch.device(device)
    s = max(1, len(slices))
    if row_ids is None:
        row_ids = global_row_ids(slices)
    cap, k = sparse_pool_dims(slices)
    keys = np.full((s, cap), INVALID_KEY, dtype=np.int32)
    values = np.full((s, cap, k), 0xFFFF, dtype=np.uint16)
    cards = np.zeros((s, cap), dtype=np.int32)
    for si, sl in enumerate(slices):
        if sl is None or not len(sl[0]):
            continue
        real, c, flat = sl
        n = len(real)
        # pool_keys is monotonic: the containers stay in key order.
        keys[si, :n] = pool_keys(real, row_ids)
        cards[si, :n] = c
        starts = np.repeat(np.cumsum(c) - c, c)
        values[si, np.repeat(np.arange(n), c),
               np.arange(len(flat)) - starts] = flat
    return SparseShardedIndex(
        values=torch.from_numpy(values.view(np.int16)).to(device),
        cards=torch.from_numpy(cards).to(device),
        keys_host=keys, cards_host=cards,
        row_ids=np.asarray(row_ids, dtype=np.uint64))


def sparse_staged_from_numpy(keys, values, cards, row_ids,
                             device) -> SparseShardedIndex:
    """The JAX package's sorted-array pool (the host keys, uint16 values,
    cards and row ids its build_sparse_sharded_index yields) as this
    port's SparseShardedIndex. The arrays are copied."""
    v = np.array(values, dtype=np.uint16, order="C")
    c = np.array(cards, dtype=np.int32, order="C")
    device = torch.device(device)
    return SparseShardedIndex(
        values=torch.from_numpy(v.view(np.int16)).to(device),
        cards=torch.from_numpy(c.copy()).to(device),
        keys_host=np.ascontiguousarray(keys, dtype=np.int32),
        cards_host=c, row_ids=np.asarray(row_ids, dtype=np.uint64))


def count_sparse_pair(op: str, kind: str, pool_a, pool_b, idx_a, hit_a,
                      idx_b, hit_b, mask) -> int:
    """Count of the two-leaf `op` ("and", "or", "andnot") over the slices
    in `mask` where at least one leaf serves from a sorted-array pool.

    kind: "ss" both sorted-array (K4, kernels.sparse_pair_count); "sd"
    leaf 0 sorted-array, leaf 1 dense; "ds" the reverse. The mixed kinds
    gather the dense side's containers and probe them with the sorted
    values (sparse_probe_intersect_counts), as the reference does in XLA.
    Union and difference follow from |a ∩ b| and the hit-masked operand
    cardinalities (sparse_op_counts).

    A sorted-array pool is (values, cards), a dense one (words,); idx/hit
    are the host (S, R) resolve_row_indices arrays against the pool the
    leaf serves from, mask the (S,) 1/0 slice mask. Per-slice sums are
    int64 on the device."""
    device = pool_a[0].device

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    ia, ha, ib, hb = (dev(t) for t in (idx_a, hit_a, idx_b, hit_b))
    if kind == "ss":
        inter = kernels.sparse_pair_count(pool_a[0], pool_a[1], pool_b[0],
                                          pool_b[1], ia, ha, ib, hb)
        na = kernels.leaf_cards(pool_a[1], ia, ha)
        nb = kernels.leaf_cards(pool_b[1], ib, hb)
    elif kind == "sd":
        va, na = kernels.gather_sparse(pool_a[0], pool_a[1], ia, ha)
        blk = kernels.gather_words(pool_b[0], ib, hb)
        nb = popcount(blk).sum(dim=-1, dtype=torch.int32)
        inter = sparse_probe_intersect_counts(va, na, blk)
    elif kind == "ds":
        # |a ∩ b| is symmetric; na and nb keep their leaf positions so
        # andnot stays leaf 0 minus the intersection.
        blk = kernels.gather_words(pool_a[0], ia, ha)
        na = popcount(blk).sum(dim=-1, dtype=torch.int32)
        vb, nb = kernels.gather_sparse(pool_b[0], pool_b[1], ib, hb)
        inter = sparse_probe_intersect_counts(vb, nb, blk)
    else:
        raise ValueError(f"unknown format pair {kind!r}")
    counts = sparse_op_counts(op, inter, na, nb)
    per_slice = counts.sum(dim=1, dtype=torch.int64)
    return int((per_slice * torch.from_numpy(
        np.asarray(mask, dtype=np.int64)).to(device)).sum())


def dense_row(staged: ShardedIndex, row_id: int) -> int:
    """Dense index of `row_id`, or len(row_ids) (resolves as absent)."""
    i = int(np.searchsorted(staged.row_ids, np.uint64(row_id)))
    if i >= len(staged.row_ids) or staged.row_ids[i] != np.uint64(row_id):
        return len(staged.row_ids)
    return i


def resolve_row_indices(keys_host: np.ndarray, dense_id: int):
    """(idx (S, 16) int32 within-slice container indices, hit (S, 16)
    uint32 presence) of one dense row. One searchsorted over
    slice-offset int64 keys resolves every slice; a miss lands on an
    arbitrary in-range container with hit = 0."""
    s, cap = keys_host.shape
    off = (np.arange(s, dtype=np.int64) << 33)[:, None]
    k64 = (keys_host.astype(np.int64) + off).reshape(-1)
    t = dense_id * ROW_SPAN + np.arange(ROW_SPAN, dtype=np.int64)
    t64 = (t[None, :] + off).reshape(-1)
    i = np.minimum(np.searchsorted(k64, t64), s * cap - 1)
    hit = (k64[i] == t64).astype(np.uint32)
    within = np.clip(i.reshape(s, ROW_SPAN)
                     - (np.arange(s, dtype=np.int64) * cap)[:, None],
                     0, cap - 1)
    return within.astype(np.int32), hit.reshape(s, ROW_SPAN)


def coarse_row_starts(keys_host: np.ndarray, dense_id: int):
    """(starts (S,) int32 row-run indices, valid (S,) uint32) when every
    slice holds the row's 16 containers as one contiguous, 16-aligned
    run or holds none of them; None when any slice is partial or
    unaligned, or no slice holds the row. A slice holds the row when
    any of its keys lies in the row's span, not only its first key."""
    s, cap = keys_host.shape
    if cap % ROW_SPAN != 0:
        return None
    lo = np.int64(dense_id) * ROW_SPAN
    base = np.arange(s, dtype=np.int64)
    off = base * (np.int64(1) << 33)
    k64 = (keys_host.astype(np.int64) + off[:, None]).reshape(-1)
    first = np.searchsorted(k64, lo + off) - base * cap
    held = np.searchsorted(k64, lo + ROW_SPAN + off) - base * cap - first
    present = held > 0
    if not present.any():
        return None
    # Keys are unique and sorted within a slice, so 16 keys in the span
    # are the whole run, contiguous from `first`.
    ps = first[present]
    if (held[present] != ROW_SPAN).any() or (ps % ROW_SPAN != 0).any():
        return None
    starts = np.zeros(s, dtype=np.int32)
    starts[present] = (ps // ROW_SPAN).astype(np.int32)
    return starts, present.astype(np.uint32)


class LeafLayout(NamedTuple):
    """Where one row's containers sit in a staged pool."""

    idx: np.ndarray                # (S, 16) int32
    hit: np.ndarray                # (S, 16) int32
    starts: Optional[np.ndarray]   # (S,) int32 run index, -1 = absent;
    #                                None = not coarse
    uniform: Optional[int]         # one run index for every slice
    #                                (-1 = absent everywhere), or None
    row: int                       # dense row id


def leaf_layout(keys_host: np.ndarray, dense_id: int) -> LeafLayout:
    idx, hit = resolve_row_indices(keys_host, dense_id)
    coarse = coarse_row_starts(keys_host, dense_id)
    if coarse is None and not hit.any():
        # Staged nowhere: an absent leaf, every slice reads zero.
        starts = np.full(keys_host.shape[0], -1, dtype=np.int32)
        return LeafLayout(idx, hit.astype(np.int32), starts, -1, dense_id)
    if coarse is None:
        return LeafLayout(idx, hit.astype(np.int32), None, None, dense_id)
    starts_h, valid = coarse
    starts = np.where(valid != 0, starts_h, -1).astype(np.int32)
    uniform = int(starts[0]) if (starts == starts[0]).all() else None
    return LeafLayout(idx, hit.astype(np.int32), starts, uniform, dense_id)


def slice_mask(num_slices: int, slices: Sequence[int]) -> Optional[np.ndarray]:
    """(S,) int64 1/0 over the staged slices, or None when a requested
    slice is beyond them."""
    mask = np.zeros(num_slices, dtype=np.int64)
    idx = np.asarray(list(slices), dtype=np.int64)
    if idx.size:
        if int(idx.max()) >= num_slices:
            return None
        mask[idx] = 1
    return mask


def combine_counts(per_bs: torch.Tensor, mask: torch.Tensor) -> List[int]:
    """(B, S) int32 per-(query, slice) counts -> per-query totals over
    the masked slices, summed in int64 on the device: exact at any
    slice count (a slice holds at most 2^20 bits of a row)."""
    return (per_bs.to(torch.int64) * mask).sum(dim=1).tolist()


def shared_plan(leaf_keys: Sequence[Sequence]):
    """(leaf_map, unique positions) when the batch's leaves repeat, else
    None. leaf_keys[b][l] identifies query b's leaf l; unique u is first
    seen at (b, l) = positions[u]."""
    uniq: dict = {}
    positions, leaf_map = [], []
    for b, keys in enumerate(leaf_keys):
        row = []
        for l, k in enumerate(keys):
            if k not in uniq:
                uniq[k] = len(positions)
                positions.append((b, l))
            row.append(uniq[k])
        leaf_map.append(tuple(row))
    if len(positions) >= sum(len(m) for m in leaf_map):
        return None  # nothing shared
    # K2 holds the unique words in registers: wider batches run on K1.
    if (len(positions) > kernels.MAX_SHARED_LEAVES
            or len(leaf_map[0]) > kernels.MAX_SHARED_LEAVES
            or len(leaf_map) > kernels.MAX_BATCH):
        return None
    return tuple(leaf_map), positions


def count_batch(tree, pools: Sequence[torch.Tensor],
                layouts: Sequence[Sequence[LeafLayout]], mask: np.ndarray,
                leaf_keys=None, index_rows=None):
    """Counts of B queries of one tree shape: pools[l] is leaf position
    l's staged words (the same for every query), layouts[b][l] query b's
    leaf l. leaf_keys (as for shared_plan) lets repeated leaves share
    reads. K3, for rows that are not whole runs, reads each leaf's
    index_row on the card: index_rows[l], a callable, returns it for a
    dense id of pool l where the caller keeps it there (a staged view
    does); without index_rows it goes up now. Returns (per-query totals,
    name of the wrapper that ran)."""
    device = pools[0].device
    batch, num_leaves = len(layouts), len(pools)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    flat = [lay for req in layouts for lay in req]
    if all(lay.starts is not None for lay in flat):
        plan = shared_plan(leaf_keys) if (batch > 1 and leaf_keys) else None
        if plan is not None:
            leaf_map, positions = plan
            uniq = [layouts[b][l] for b, l in positions]
            views = tuple(pools[l] for _, l in positions)
            if all(lay.uniform is not None for lay in uniq):
                starts = dev(np.array([lay.uniform for lay in uniq], np.int32))
                per = kernels.coarse_count_shared_uniform(views, starts, tree,
                                                          leaf_map)
                name = "coarse_count_shared_uniform"
            else:
                starts = dev(np.stack([lay.starts for lay in uniq]))
                per = kernels.coarse_count_batch_per_slice(views, starts,
                                                           tree, leaf_map)
                name = "coarse_count_batch_per_slice"
        elif all(lay.uniform is not None for lay in flat):
            starts = dev(np.array([lay.uniform for lay in flat], np.int32))
            if batch == 1:
                per = kernels.coarse_count_uniform(pools, starts, tree)
                name = "coarse_count_uniform"
            else:
                per = kernels.coarse_count_uniform_batch(pools, starts, tree)
                name = "coarse_count_uniform_batch"
        else:
            starts = dev(np.stack([lay.starts for lay in flat]))
            if batch == 1:
                per = kernels.coarse_count_per_slice(pools, starts, tree)
                name = "coarse_count_per_slice"
            else:
                per = kernels.coarse_count_identity_batch(pools, starts, tree)
                name = "coarse_count_identity_batch"
    else:
        rows = [[index_row(lay, device) if index_rows is None
                 else index_rows[l](lay.row) for l, lay in enumerate(req)]
                for req in layouts]
        per = kernels.tree_count_rows(pools, rows, tree)
        name = "tree_count_rows"
    return combine_counts(per, dev(mask)), name


def row_table(keys_host: np.ndarray, num_rows: int) -> np.ndarray:
    """(num_rows, S, 16) int32 container index of every dense row of a
    staged pool, -1 where the container is absent: the a_idx of
    kernels.pair_count_rows for all rows, in one pass over the keys."""
    s, _cap = keys_host.shape
    out = np.full((num_rows, s, ROW_SPAN), -1, dtype=np.int32)
    si, ci = np.nonzero(keys_host != INVALID_KEY)
    k = keys_host[si, ci]
    out[k // ROW_SPAN, si, k % ROW_SPAN] = ci
    return out


def materialize_block(tree, pools: Sequence[torch.Tensor],
                      layouts: Sequence[LeafLayout]) -> torch.Tensor:
    """The (S, 16, 2048) int32 words of a numbered op tree over one row
    of each leaf's pool, folded with torch indexing and bitwise ops."""
    return fold_tree(tree, lambda l: kernels.gather_words(
        pools[l], torch.from_numpy(layouts[l].idx).to(pools[l].device),
        torch.from_numpy(layouts[l].hit).to(pools[l].device))).contiguous()


def index_row(layout: LeafLayout, device) -> Optional[torch.Tensor]:
    """A leaf's (S, 16) int32 container index on `device`, -1 where a
    container is absent: its row of row_table, the index K3
    (kernels.tree_count_rows) reads. None for a row staged nowhere."""
    if not layout.hit.any():
        return None
    return torch.from_numpy(np.where(layout.hit != 0, layout.idx, -1).astype(
        np.int32)).to(device)


def count_rows(staged: Sequence[ShardedIndex], tree, row_ids: Sequence[int],
               slices: Sequence[int]) -> int:
    """Count of `tree` with leaf l reading row row_ids[l] of staged[l],
    over `slices`: the single-query form of count_batch."""
    layouts = [leaf_layout(st.keys_host, dense_row(st, r))
               for st, r in zip(staged, row_ids)]
    mask = slice_mask(staged[0].num_slices, slices)
    if mask is None:
        raise ValueError("slices beyond the staged pool")
    totals, _ = count_batch(tree, [st.words for st in staged], [layouts], mask)
    return int(totals[0])
