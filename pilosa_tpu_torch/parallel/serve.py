"""MeshManager: stages holder views on the card and serves Count.

A lone count (no other count in flight) runs at once on the calling
thread. Concurrent counts go through one batch thread that drains the
queue, groups requests of one tree shape over the same staged pools and
slice set, collapses identical requests, and runs each group as one
kernel launch of up to _MAX_BATCH queries (mesh.count_batch). A group
whose queries repeat leaves reads each unique row once (K2, the
shared-read program): there is no compile to amortize on this path, so
the upgrade happens the first time a composition shows sharing.

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

from .. import resolve_device
from ..core.fragment import MUTATION_EPOCH
from ..ops.pool import pack_bitmap
from .mesh import (ShardedIndex, build_sharded_index, count_batch, dense_row,
                   leaf_layout, slice_mask)
from .plan import _tree_signature


class StagedView:
    """One (index, frame, view)'s staged pool + what it was staged from."""

    __slots__ = ("sharded", "slice_gens", "num_slices", "layouts",
                 "validated")

    def __init__(self, sharded: ShardedIndex, slice_gens, num_slices: int):
        self.sharded = sharded
        self.slice_gens = slice_gens  # per slice (fragment, gen) or None
        self.num_slices = num_slices
        self.layouts: Dict[int, object] = {}  # dense id -> LeafLayout
        # MUTATION_EPOCH.n when the generations were last found current.
        self.validated = -1

    def layout(self, dense_id: int):
        lay = self.layouts.get(dense_id)
        if lay is None:
            lay = self.layouts[dense_id] = leaf_layout(
                self.sharded.keys_host, dense_id)
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


class MeshManager:
    """Stages holder views onto the card and serves Count."""

    _MAX_BATCH = 16

    def __init__(self, holder, device="cuda"):
        self.holder = holder
        self.device = resolve_device(device)
        self._views: Dict[Tuple[str, str, str], StagedView] = {}
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
        frame does not exist. Call under _mu."""
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
        packed, gens = [], []
        for s in range(num_slices):
            frag = self.holder.fragment(index, frame, view, s)
            if frag is None:
                packed.append(None)
                gens.append(None)
                continue
            with frag._mu:  # containers and generation from one state
                packed.append(pack_bitmap(frag.storage))
                gens.append((frag, frag.generation))
        self._views.pop(key, None)  # free the old pool before the new one
        sv = StagedView(build_sharded_index(packed, self.device), gens,
                        num_slices)
        sv.validated = epoch
        self._views[key] = sv
        self._inc("stage")
        self._inc("stage_us", int((time.monotonic() - t0) * 1e6))
        return sv

    def _gen(self, index, frame, view, s):
        frag = self.holder.fragment(index, frame, view, s)
        return None if frag is None else (frag, frag.generation)

    def _resolve(self, index: str, shape, leaves, slices: Sequence[int],
                 num_slices: int) -> Optional[_CountRequest]:
        """Stage every leaf's view and resolve its row; None when a
        view cannot be staged or the slices reach past it."""
        tree = _tree_signature(shape)
        pools, layouts, keys = [], [], []
        with self._mu:
            staged: Dict[Tuple[str, str], StagedView] = {}
            for frame, view, row_id, _req in leaves:
                sv = staged.get((frame, view))
                if sv is None:
                    sv = self.refresh(index, frame, view, num_slices)
                    if sv is None:
                        return None
                    staged[(frame, view)] = sv
                dense = dense_row(sv.sharded, row_id)
                pools.append(sv.sharded.words)
                layouts.append(sv.layout(dense))
                keys.append((id(sv.sharded.words), dense))
            mask = slice_mask(num_slices, slices)
        if mask is None:
            return None
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
