"""MeshManager: stages holder views on the card and serves Count.

A lone count (no other count in flight) runs at once on the calling
thread. Concurrent counts go through one batch thread that drains the
queue, groups requests of one tree shape over the same staged pools and
slice set, collapses identical requests, and runs each group as one
kernel launch of up to _MAX_BATCH queries (mesh.count_batch). A group
whose queries repeat leaves reads each unique row once (K2, the
shared-read program): there is no compile to amortize on this path, so
the upgrade happens the first time a composition shows sharing.

Slices of low fill stage as sorted u16 value arrays instead of packed
words (mesh.pick_slice_formats at sparse_density_threshold, default
0.05, the reference's; <= 0 stages everything dense). _resolve stages
each leaf's view once and picks the path from that staging. A count that
touches such a view runs on the calling thread (_run_sparse): a single
leaf sums the cardinality table on the host, and a two-leaf op splits
the slices by format pair into dd, sd, ds and ss groups. Any other tree
pins the view dense (_demote_to_dense), restages it, and serves it on
the dense kernels.

Staged views are restaged whole when any of their fragments moved
generation (a write), and on first use.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import resolve_device
from ..core.fragment import MUTATION_EPOCH
from ..ops.pool import pack_bitmap, pack_sparse
from .mesh import (DEFAULT_SPARSE_DENSITY_THRESHOLD, ShardedIndex,
                   SparseShardedIndex,
                   build_sharded_index, build_sparse_sharded_index,
                   count_batch, count_sparse_pair, dense_row, global_row_ids,
                   leaf_layout, pick_slice_formats, resolve_row_indices,
                   slice_format_stats, slice_mask, split_bitmaps_by_format)
from .plan import _tree_signature


class StagedView:
    """One (index, frame, view)'s staged pools + what they were staged
    from. `sparse` is the sorted-array pool, or None when every slice
    staged dense; slice_formats[s] is 1 where slice s serves from it."""

    __slots__ = ("sharded", "sparse", "slice_formats", "slice_gens",
                 "num_slices", "layouts", "sparse_layouts", "validated")

    def __init__(self, sharded: ShardedIndex, slice_gens, num_slices: int,
                 sparse: Optional[SparseShardedIndex] = None,
                 slice_formats: Optional[np.ndarray] = None):
        self.sharded = sharded
        self.sparse = sparse
        self.slice_formats = (slice_formats if slice_formats is not None
                              else np.zeros(num_slices, dtype=np.uint8))
        self.slice_gens = slice_gens  # per slice (fragment, gen) or None
        self.num_slices = num_slices
        self.layouts: Dict[int, object] = {}  # dense id -> LeafLayout
        self.sparse_layouts: Dict[int, tuple] = {}  # dense id -> (idx, hit)
        # MUTATION_EPOCH.n when the generations were last found current.
        self.validated = -1

    def layout(self, dense_id: int):
        lay = self.layouts.get(dense_id)
        if lay is None:
            lay = self.layouts[dense_id] = leaf_layout(
                self.sharded.keys_host, dense_id)
        return lay

    def sparse_layout(self, dense_id: int):
        """(idx, hit) (S, 16) of a row against the sorted-array keys."""
        lay = self.sparse_layouts.get(dense_id)
        if lay is None:
            lay = self.sparse_layouts[dense_id] = resolve_row_indices(
                self.sparse.keys_host, dense_id)
        return lay


class _CountRequest:
    __slots__ = ("tree", "pools", "layouts", "leaf_keys", "mask", "done",
                 "result", "error")

    def __init__(self, tree, pools, layouts, leaf_keys, mask):
        self.tree = tree
        self.pools = pools
        self.layouts = layouts
        self.leaf_keys = leaf_keys
        self.mask = mask
        self.done = threading.Event()
        self.result = None
        self.error = None

    def group_key(self):
        """Batchable together: one tree shape, the same pools (object
        identity: one staging generation), the same slices."""
        return (json.dumps(self.tree), tuple(id(p) for p in self.pools),
                self.mask.tobytes())

    def dedup_key(self):
        return self.group_key() + (self.leaf_keys,)


class _SparseCount:
    """A count over views with a sorted-array pool: `host_total` from
    cardinality tables, plus one job per format group, each holding the
    pools it reads."""
    __slots__ = ("tree", "op", "host_total", "jobs")

    def __init__(self, tree, op: str, host_total: int, jobs: list):
        self.tree = tree
        self.op = op
        self.host_total = host_total
        self.jobs = jobs


class MeshManager:
    """Stages holder views onto the card and serves Count."""

    _MAX_BATCH = 16

    def __init__(self, holder, device="cuda",
                 sparse_density_threshold: float =
                 DEFAULT_SPARSE_DENSITY_THRESHOLD):
        self.holder = holder
        self.device = resolve_device(device)
        self.sparse_density_threshold = sparse_density_threshold
        self._views: Dict[Tuple[str, str, str], StagedView] = {}
        # Views an n-ary tree pinned to packed words (_demote_to_dense).
        self._dense_pins: set = set()
        self._mu = threading.Lock()
        self._stats_mu = threading.Lock()
        self.stats: Counter = Counter()
        self._batch_q: "queue.Queue[_CountRequest]" = queue.Queue()
        self._batch_thread: Optional[threading.Thread] = None
        self._lone_mu = threading.Lock()
        self._counts_inflight = 0

    def _inc(self, key: str, n: int = 1) -> None:
        with self._stats_mu:
            self.stats[key] += n

    # -- staging -------------------------------------------------------------

    def refresh(self, index: str, frame: str, view: str,
                num_slices: int) -> Optional[StagedView]:
        """An up-to-date StagedView, restaged when stale; None when the
        frame does not exist. Each slice's format is picked under its
        fragment's lock, with the previous image's formats as the
        hysteresis input. Call under _mu."""
        if self.holder.frame(index, frame) is None:
            return None
        key = (index, frame, view)
        epoch = MUTATION_EPOCH.n  # read before the walk: a racing write
        sv = self._views.get(key)  # leaves the stamp behind, never ahead
        if sv is not None and sv.num_slices == num_slices and (
                sv.validated == epoch or all(
                    self._gen(index, frame, view, s) == g
                    for s, g in enumerate(sv.slice_gens))):
            sv.validated = epoch
            return sv
        t0 = time.monotonic()
        prev = sv.slice_formats if sv is not None else None
        thr = (0.0 if key in self._dense_pins
               else float(self.sparse_density_threshold))
        formats = np.zeros(num_slices, dtype=np.uint8)
        packed, gens = [], []
        for s in range(num_slices):
            frag = self.holder.fragment(index, frame, view, s)
            if frag is None:
                packed.append(None)
                gens.append(None)
                continue
            with frag._mu:  # containers, format and generation from one state
                if thr > 0:
                    formats[s] = pick_slice_formats(
                        slice_format_stats([frag.storage]), thr,
                        prev=None if prev is None else prev[s:s + 1])[0]
                packed.append(pack_sparse(frag.storage) if formats[s]
                              else pack_bitmap(frag.storage))
                gens.append((frag, frag.generation))
        self._views.pop(key, None)  # free the old pools before the new ones
        sparse = None
        if formats.any():
            dense_s, sparse_s = split_bitmaps_by_format(packed, formats)
            row_ids = global_row_ids(packed)
            populated = any(sl is not None and len(sl[0]) for sl in dense_s)
            # capacity 0 when every populated slice went sorted-array.
            sharded = build_sharded_index(
                dense_s, self.device, capacity=None if populated else 0,
                row_ids=row_ids)
            sparse = build_sparse_sharded_index(sparse_s, self.device,
                                                row_ids=row_ids)
            self._inc("stage_sparse_slices", int(formats.sum()))
        else:
            sharded = build_sharded_index(packed, self.device)
        sv = StagedView(sharded, gens, num_slices, sparse, formats)
        sv.validated = epoch
        self._views[key] = sv
        self._inc("stage")
        self._inc("stage_us", int((time.monotonic() - t0) * 1e6))
        return sv

    def _demote_to_dense(self, key, num_slices: int) -> Optional[StagedView]:
        """Pin `key` to packed words and restage it: a tree only the dense
        kernels fold reached a view with a sorted-array pool. The pin is
        sticky, so one mixed workload settles into one layout. Call
        under _mu."""
        self._dense_pins.add(key)
        self._inc("sparse_demote")
        self._views.pop(key, None)
        return self.refresh(*key, num_slices)

    def _gen(self, index, frame, view, s):
        frag = self.holder.fragment(index, frame, view, s)
        return None if frag is None else (frag, frag.generation)

    def _resolve(self, index: str, shape, leaves, slices: Sequence[int],
                 num_slices: int):
        """Stage each leaf's view once and pick the path from that
        staging: a _SparseCount when a view holds a sorted-array pool and
        the tree is one the format groups serve, else a _CountRequest for
        the dense kernels (other trees demote the sorted-array views
        first). None when a view cannot be staged or the slices reach
        past it."""
        tree = _tree_signature(shape)
        with self._mu:
            staged: Dict[Tuple[str, str], StagedView] = {}
            for frame, view, _row, _req in leaves:
                if (frame, view) not in staged:
                    sv = self.refresh(index, frame, view, num_slices)
                    if sv is None:
                        return None
                    staged[(frame, view)] = sv
            mask = slice_mask(num_slices, slices)
            if mask is None:
                return None
            if any(sv.sparse is not None for sv in staged.values()):
                op = self._sparse_shape_kind(tree)
                if op is not None:
                    return self._sparse_request(tree, op, leaves, staged,
                                                mask, num_slices)
                self._inc("fallback_sparse_shape")
                for (frame, view), sv in list(staged.items()):
                    if sv.sparse is not None:
                        sv = self._demote_to_dense((index, frame, view),
                                                   num_slices)
                        if sv is None:
                            return None
                        staged[(frame, view)] = sv
            pools, layouts, keys = [], [], []
            for frame, view, row_id, _req in leaves:
                sv = staged[(frame, view)]
                dense = dense_row(sv.sharded, row_id)
                pools.append(sv.sharded.words)
                layouts.append(sv.layout(dense))
                keys.append((id(sv.sharded.words), dense))
        return _CountRequest(tree, tuple(pools), tuple(layouts), tuple(keys),
                             mask)

    # -- serving -------------------------------------------------------------

    def count(self, index: str, shape, leaves, slices: Sequence[int],
              num_slices: int) -> Optional[int]:
        """Count over a lowered bitmap-op tree (plan._lower_tree), or
        None when the views cannot be staged. Device errors raise."""
        req = self._resolve(index, shape, leaves, slices, num_slices)
        if req is None:
            self._inc("fallback")
            return None
        if isinstance(req, _SparseCount):
            total = self._run_sparse(req)
            self._inc("sparse_count")
            self._inc("count")
            return total
        with self._lone_mu:
            self._counts_inflight += 1
            lone = self._counts_inflight == 1
        try:
            if lone:
                self._run_count_group([req])
                self._inc("lone")
            else:
                self._ensure_batch_thread()
                self._batch_q.put(req)
                req.done.wait()
            if req.error is not None:
                raise RuntimeError(f"device count failed: {req.error}") \
                    from req.error
            self._inc("count")
            return req.result
        finally:
            with self._lone_mu:
                self._counts_inflight -= 1

    # -- sorted-array serving ------------------------------------------------

    @staticmethod
    def _sparse_shape_kind(tree):
        """"leaf" for a single leaf, the op for a flat two-leaf op in leaf
        order (the shapes the sorted-array path serves), else None."""
        if tree == ["leaf", 0]:
            return "leaf"
        if (len(tree) == 3 and tree[0] in ("and", "or", "andnot")
                and tree[1] == ["leaf", 0] and tree[2] == ["leaf", 1]):
            return tree[0]
        return None

    def _sparse_request(self, tree, op: str, leaves, staged, mask,
                        num_slices: int) -> _SparseCount:
        """The format groups of a count over sorted-array pools. The
        slices split by the leaves' format pair into at most four groups:
        dd goes through count_batch on the dense pools with the group's
        mask, ss through K4, sd and ds through the probe
        (mesh.count_sparse_pair); the group counts add up. A single
        sorted-array leaf needs no kernel: its count is the cardinality
        table at the row's containers. A view whose dense pool is empty
        (every populated slice went sorted-array) serves every slice
        from the sorted-array pool, where absent containers read 0. Call
        under _mu."""
        sel = mask.astype(bool)
        host_total, jobs, legs = 0, [], []
        for frame, view, row_id, _req in leaves:
            sv = staged[(frame, view)]
            dense = dense_row(sv.sharded, row_id)
            has_dense = sv.sharded.capacity > 0
            legs.append((
                sv, sv.layout(dense) if has_dense else None,
                sv.sparse_layout(dense) if sv.sparse is not None else None,
                sv.slice_formats.astype(bool) if has_dense
                else np.ones(num_slices, dtype=bool)))
        if op == "leaf":
            sv, d_lay, s_lay, fmts = legs[0]
            if (sel & fmts).any():
                idx, hit = s_lay
                per = np.take_along_axis(sv.sparse.cards_host, idx,
                                         axis=1).astype(np.int64) * hit
                host_total = int(per[sel & fmts].sum())
                self._inc("sparse_leaf_host")
            if (sel & ~fmts).any():
                jobs.append(("dd", [sv.sharded.words], [d_lay], sel & ~fmts))
            return _SparseCount(tree, op, host_total, jobs)
        (sva, da, sa, fa), (svb, db, sb, fb) = legs
        for gk, gsel in (("dd", sel & ~fa & ~fb), ("sd", sel & fa & ~fb),
                         ("ds", sel & ~fa & fb), ("ss", sel & fa & fb)):
            if not gsel.any():
                continue
            if gk == "dd":
                jobs.append((gk, [sva.sharded.words, svb.sharded.words],
                             [da, db], gsel))
                continue
            pool_a, (ia, ha) = (
                ((sva.sparse.values, sva.sparse.cards), sa) if gk[0] == "s"
                else ((sva.sharded.words,), (da.idx, da.hit)))
            pool_b, (ib, hb) = (
                ((svb.sparse.values, svb.sparse.cards), sb) if gk[1] == "s"
                else ((svb.sharded.words,), (db.idx, db.hit)))
            jobs.append((gk, pool_a, pool_b, ia, ha, ib, hb, gsel))
        return _SparseCount(tree, op, host_total, jobs)

    def _run_sparse(self, req: _SparseCount) -> int:
        """Run a _SparseCount's groups on the calling thread, outside _mu:
        the jobs hold the pools they read."""
        total = req.host_total
        for job in req.jobs:
            gk, gmask = job[0], job[-1].astype(np.int64)
            if gk == "dd":
                totals, name = count_batch(req.tree, job[1], [job[2]], gmask)
                total += int(totals[0])
            else:
                total += count_sparse_pair(req.op, *job[:-1], gmask)
                name = "sparse_pair_count" if gk == "ss" else "sparse_probe"
            self._inc(f"kernel:{name}")
            self._inc(f"sparse_group:{gk}")
        return total

    def _ensure_batch_thread(self):
        with self._lone_mu:
            if self._batch_thread is None:
                self._batch_thread = threading.Thread(
                    target=self._batch_loop, name="mesh-count-batch",
                    daemon=True)
                self._batch_thread.start()

    def _batch_loop(self):
        """Drain what queued while the card was busy, group it, and run
        each group as one launch."""
        while True:
            reqs = [self._batch_q.get()]
            while len(reqs) < self._MAX_BATCH:
                try:
                    reqs.append(self._batch_q.get_nowait())
                except queue.Empty:
                    break
            groups: Dict[tuple, List[_CountRequest]] = {}
            for r in reqs:
                groups.setdefault(r.group_key(), []).append(r)
            for group in groups.values():
                try:
                    self._run_count_group(group)
                except Exception as e:  # noqa: BLE001 — fail this group only
                    for r in group:
                        r.error = e
                        r.done.set()

    def _run_count_group(self, group: List[_CountRequest]):
        """One launch for the group; identical requests share a slot."""
        uniq: Dict[tuple, _CountRequest] = {}
        for r in group:
            uniq.setdefault(r.dedup_key(), r)
        distinct = list(uniq.values())
        self._inc("deduped", len(group) - len(distinct))
        first = distinct[0]
        totals, kernel = count_batch(
            first.tree, first.pools, [r.layouts for r in distinct],
            first.mask, leaf_keys=[r.leaf_keys for r in distinct])
        self._inc(f"kernel:{kernel}")
        if len(distinct) > 1:
            self._inc("batched", len(distinct))
            if "shared" in kernel:
                self._inc("shared_batch", len(distinct))
        for r in group:
            r.result = int(totals[distinct.index(uniq[r.dedup_key()])])
            r.done.set()
