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
`uniform` and a single start per leaf serves all slices. Other rows
gather container by container (K3). count_batch picks the kernel.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops import kernels
from ..ops.pool import CONTAINER_WORDS, INVALID_KEY, ROW_SPAN, pool_keys

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


def build_sharded_index(slices: Sequence, device,
                        capacity: Optional[int] = None) -> ShardedIndex:
    """Stack per-slice containers into one device pool. slices[s] is
    ops.pool.pack_bitmap of slice s's bitmap, or None for an absent
    fragment. The pool fills in host chunks of _STAGE_CHUNK_BYTES, each
    copied into the preallocated device tensor."""
    device = torch.device(device)
    s = max(1, len(slices))
    rows = [keys >> np.uint64(4) for keys, _ in filter(None, slices)]
    row_ids = (np.unique(np.concatenate(rows)) if rows
               else np.empty(0, dtype=np.uint64))
    counts = [len(sl[0]) if sl is not None else 0 for sl in slices]
    cap = capacity if capacity is not None else max(1, max(counts, default=1))
    cap = -(-cap // ROW_SPAN) * ROW_SPAN

    keys = np.full((s, cap), INVALID_KEY, dtype=np.int32)
    for si, sl in enumerate(slices):
        if sl is not None:
            keys[si, :len(sl[0])] = pool_keys(sl[0], row_ids)

    words = torch.empty((s, cap, CONTAINER_WORDS), dtype=torch.int32,
                        device=device)
    chunk = max(1, _STAGE_CHUNK_BYTES // (cap * CONTAINER_WORDS * 4))
    for lo in range(0, s, chunk):
        hi = min(s, lo + chunk)
        buf = np.zeros((hi - lo, cap, CONTAINER_WORDS), dtype=np.uint32)
        for si in range(lo, hi):
            if slices[si] is not None:
                buf[si - lo, :len(slices[si][1])] = slices[si][1]
        words[lo:hi].copy_(torch.from_numpy(buf.view(np.int32)))
    return ShardedIndex(words=words, keys_host=keys, row_ids=row_ids)


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


def leaf_layout(keys_host: np.ndarray, dense_id: int) -> LeafLayout:
    idx, hit = resolve_row_indices(keys_host, dense_id)
    coarse = coarse_row_starts(keys_host, dense_id)
    if coarse is None and not hit.any():
        # Staged nowhere: an absent leaf, every slice reads zero.
        starts = np.full(keys_host.shape[0], -1, dtype=np.int32)
        return LeafLayout(idx, hit.astype(np.int32), starts, -1)
    if coarse is None:
        return LeafLayout(idx, hit.astype(np.int32), None, None)
    starts_h, valid = coarse
    starts = np.where(valid != 0, starts_h, -1).astype(np.int32)
    uniform = int(starts[0]) if (starts == starts[0]).all() else None
    return LeafLayout(idx, hit.astype(np.int32), starts, uniform)


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
    if len(positions) > kernels.MAX_LEAVES or len(leaf_map) > kernels.MAX_BATCH:
        return None
    return tuple(leaf_map), positions


def count_batch(tree, pools: Sequence[torch.Tensor],
                layouts: Sequence[Sequence[LeafLayout]], mask: np.ndarray,
                leaf_keys=None):
    """Counts of B queries of one tree shape: pools[l] is leaf position
    l's staged words (the same for every query), layouts[b][l] query b's
    leaf l. leaf_keys (as for shared_plan) lets repeated leaves share
    reads. Returns (per-query totals, name of the wrapper that ran)."""
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
        shape = (batch, num_leaves) + flat[0].idx.shape
        idx = dev(np.stack([lay.idx for lay in flat]).reshape(shape))
        hit = dev(np.stack([lay.hit for lay in flat]).reshape(shape))
        per = kernels.tree_count_per_slice(pools, idx, hit, tree)
        name = "tree_count_per_slice"
    return combine_counts(per, dev(mask)), name


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
