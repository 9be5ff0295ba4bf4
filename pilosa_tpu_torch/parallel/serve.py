"""MeshManager: stages holder views on the card and serves Count.

A lone count (no other count in flight) runs at once on the calling
thread. Concurrent counts go through one batch thread that drains the
queue, groups requests of one tree shape over the same staged pools and
slice set, collapses identical requests, and runs each group as one
kernel launch of up to _MAX_BATCH queries (mesh.count_batch). A group
whose queries repeat leaves reads each unique row once (K2, the
shared-read program): there is no compile to amortize on this path, so
the upgrade happens the first time a composition shows sharing. When
the previous drain held more than one request, or the query scheduler
hinted that a cohort was released together (expect_burst), the drain
waits a short window for stragglers ($PILOSA_TORCH_BATCH_WINDOW_MS,
default 3 ms, the JAX package's), so the cohort reaches the card as one
launch; a hinted drain counts `sched_hinted`.

Observability (the JAX package's seams): the batch thread is the
`mesh-count-batch` subsystem of the liveness plane, each group's launch
an in-flight op with a 30 s base; the cost ledger meters each staged
view's bytes x seconds from its staging to its eviction, shared among
the (tenant, shape) accounts that touched it; a profiled query's
staging is its `stage_h2d` phase (and `bytes_staged`), and a batched
query's wait on the batch thread its `device_exec`.

Slices of low fill stage as sorted u16 value arrays instead of packed
words (mesh.pick_slice_formats at sparse_density_threshold, default
0.05, the reference's; <= 0 stages everything dense). _resolve stages
each leaf's view once and picks the path from that staging. A count that
touches such a view runs on the calling thread (_run_sparse): a single
leaf sums the cardinality table on the host, and a two-leaf op splits
the slices by format pair into dd, sd, ds and ss groups. Any other tree
pins the view dense (_demote_to_dense), restages it, and serves it on
the dense kernels.

A leaf that is not required (a time view of Range) may name a view that
does not exist: it reads as an absent row of a view the query stages
anyway, and a count whose every view is absent is 0 with no launch.

Per-row counts (TopN, and the plane counts of the integer fields) run
on K5's serving form, kernels.pair_count_rows, with the index table of
every row of a staged view built in one pass over its keys and kept on
the card with the view (mesh.row_table). TopN's argument forms (n,
threshold, ids, a src tree, attr filters, the Tanimoto band) apply on
the host to those exact totals (rank_pairs, tanimoto_rank). A Count
over rows that are not whole runs (K3, kernels.tree_count_rows) reads
each leaf's row of that index, kept on the card with the view from the
row's first such Count on (StagedView.index_row), so a later Count
uploads only the kernel's argument block.

Writes reach a staged dense view as a scatter (refresh): each slice's
fragment log since the staged generation folds into final bit states,
which plan into unique (slot, word, set, clear) entries per slice, and
one K7 launch (kernels.scatter_words) updates the pool in place, ordered
on the stream after every count kernel already queued on it. The keys
never change, so a view's layouts and row table survive a scatter. A
write that added or removed a container, a log pruned past the staged
generation, a new or dropped fragment, a view with a sorted-array pool,
or a set the planner cannot place restages the view whole, as does the
measured cost gate when a restage has been cheaper than a scatter. A
view is staged whole on first use.

The residency governor keeps the staged views within an HBM byte budget
(_hbm_budget_bytes: config, then $PILOSA_TORCH_HBM_BUDGET_BYTES, then
the card's total memory less a headroom fraction, 8 GiB on the CPU;
<= 0 is unlimited). Views are kept in use order, and a staging that
would pass the budget first evicts the least recently used views that
no query in flight has pinned (_reserve); a view bigger than the whole
budget is refused before a byte moves (DeviceResourceError
"hbm_infeasible"). Every query pins the views it resolved, under _mu,
until its launches are done (_release_pins), and views its own
resolution touched are never evicted from under it. A
torch.cuda.OutOfMemoryError while staging or in a launch evicts every
unpinned view and retries once; a second one raises DeviceResourceError
"oom" (_oom_ladder, under _stage and _guarded_exec). A plan signature
whose launches keep running out of memory after eviction is quarantined
for a time (DeviceResourceError "quarantined"). The executor answers a
query that meets DeviceResourceError on the host; any other device error
(a kernel that does not build, a launch failure, an illegal address)
propagates and takes no strike, so it never routes a plan to the host.
An evicted view's device tensors are dropped as soon as no query holds
it (StagedView.release), so nothing that still refers to the view object
keeps its memory, and a restage frees the old image before it allocates
the new one.

A fragment whose file fails integrity verification raises
CorruptFragmentError when a staging touches it: that query fails as it
is (HTTP 500). It is not a kernel error, so it takes no strike, and not
a governor cause, so it gets no host fold, which would read the same
file. Every served Count and every per-row count passes the result seam
fault.perturb("device.exec", ..., kind="count-result"), where a delta=
rule models a kernel that silently miscomputes; the executor's shadow
verification is what catches it.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import Counter, OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import fault, obs, resolve_device
from ..core.fragment import MUTATION_EPOCH
from ..errors import DeviceResourceError
from ..obs.costs import LEDGER
from ..obs.health import HEALTH
from ..ops import kernels
from ..ops.pool import (CONTAINER_WORDS, INVALID_KEY, fold_log_entries,
                        pack_bitmap, pack_sparse, plan_slice_mutations)
from .mesh import (DEFAULT_SPARSE_DENSITY_THRESHOLD, ShardedIndex,
                   SparseShardedIndex, apply_writes, build_sharded_index,
                   build_sparse_sharded_index, count_batch,
                   count_sparse_pair, dense_row, estimate_staged_bytes,
                   format_pool_bytes, global_row_ids, index_row,
                   kernel_read_bytes, leaf_layout, materialize_block,
                   pack_mutation_batches,
                   pick_slice_formats, resolve_row_indices, row_table,
                   slice_format_stats, slice_mask, split_bitmaps_by_format)
from .plan import (PlanQuarantine, _tree_signature, format_signature,
                   plan_signature)

# Rows one pair_count_rows launch takes (its grid's y limit).
MAX_ROWS_PER_LAUNCH = 65535

# The [mesh] knobs MeshManager(config=) takes, with the JAX package's
# defaults (pilosa_tpu/config.py:113-124): the HBM budget in bytes (0:
# $PILOSA_TORCH_HBM_BUDGET_BYTES, else the card's total memory less
# hbm_headroom; negative: unlimited), the headroom fraction, the
# out-of-memory failures after eviction of one plan signature before it
# is quarantined, and the quarantine's seconds.
MESH_DEFAULTS = {"hbm_budget_bytes": 0, "hbm_headroom": 0.15,
                 "quarantine_after": 2, "quarantine_ttl": 60.0}
BUDGET_ENV = "PILOSA_TORCH_HBM_BUDGET_BYTES"
# The budget when the device is the CPU.
CPU_BUDGET_BYTES = 8 << 30
# The herd drain window, ms (the JAX package's PILOSA_TPU_BATCH_WINDOW_MS).
BATCH_WINDOW_ENV = "PILOSA_TORCH_BATCH_WINDOW_MS"
DEFAULT_BATCH_WINDOW_MS = 3.0


def mesh_config(config: Optional[dict]) -> dict:
    """The [mesh] knobs with MESH_DEFAULTS for those `config` leaves out;
    raises ValueError for a key it does not know."""
    unknown = set(config or ()) - set(MESH_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown [mesh] knobs {sorted(unknown)}; "
                         f"known: {sorted(MESH_DEFAULTS)}")
    return {**MESH_DEFAULTS, **(config or {})}


def _is_oom(e: BaseException) -> bool:
    """The one out-of-memory classifier: a torch.cuda.OutOfMemoryError
    (the card's, or fault.SimulatedResourceExhausted), raised or as the
    cause of the error raised."""
    return isinstance(e, torch.cuda.OutOfMemoryError) or isinstance(
        e.__cause__, torch.cuda.OutOfMemoryError)


def _pool_bytes(sharded: ShardedIndex,
                sparse: Optional[SparseShardedIndex]) -> int:
    """Device bytes of a view's pools: the packed words, and the sorted
    arrays' u16 values and i32 cards (the keys stay on the host)."""
    n = sharded.words.numel() * 4
    if sparse is not None:
        n += sparse.values.numel() * 2 + sparse.cards.numel() * 4
    return n


def _table_bytes(rows_dev: Optional[torch.Tensor], index_rows) -> int:
    """Device bytes of a view's row tables: K5's (R, S, 16) int32 table
    and the (S, 16) int32 index rows K3 read."""
    return ((rows_dev.numel() * 4 if rows_dev is not None else 0)
            + sum(t.numel() * 4 for t in index_rows if t is not None))


def view_stats(holder, index: str, frame: str, view: str, num_slices: int,
               threshold: float):
    """(stats, formats) of a view from its live fragments, without
    packing: per slice [containers, total, max cardinality] and the
    format a staging at `threshold` would pick (no hysteresis: no image
    to carry it). format_pool_bytes of the pair is the staging's size."""
    stats = np.zeros((num_slices, 3), dtype=np.int64)
    n = np.zeros(num_slices, dtype=np.int64)
    for s in range(num_slices):
        frag = holder.fragment(index, frame, view, s)
        if frag is None:
            continue
        with frag._mu:
            stats[s] = slice_format_stats([frag.storage])[0]
            n[s] = len(frag.storage.keys)
    formats = pick_slice_formats(stats, threshold)
    # slice_format_stats stops at a slice's first container too big for
    # an array; the byte figure wants every container.
    stats[:, 0] = n
    return stats, formats


def rank_pairs(all_rows, counts, n: int, row_ids, min_threshold: int,
               attr_predicate=None) -> List[Tuple[int, int]]:
    """TopN's semantics over exact per-row totals: the asked ids (its
    exact phase), the threshold, n, and the attr filter walked over the
    sorted rows until n match. As in the JAX package, `threshold`
    filters the exact totals, not each slice's partial count; a row
    needs at least one bit whatever the threshold."""
    if len(all_rows) == 0:
        return []
    if row_ids:
        want = np.asarray(sorted(row_ids), dtype=np.uint64)
        i = np.searchsorted(all_rows, want)
        ok = i < len(all_rows)
        ok &= all_rows[np.minimum(i, len(all_rows) - 1)] == want
        pairs = [(int(r), int(counts[j])) for r, j in zip(want[ok], i[ok])
                 if counts[j] >= max(min_threshold, 1)
                 and (attr_predicate is None or attr_predicate(int(r)))]
        pairs.sort(key=lambda p: (-p[1], p[0]))
        return pairs
    keep = np.nonzero(counts >= max(min_threshold, 1))[0]
    keep = keep[np.lexsort((all_rows[keep], -counts[keep]))]
    if attr_predicate is None:
        if n:
            keep = keep[:n]
        return [(int(all_rows[j]), int(counts[j])) for j in keep]
    out = []
    for j in keep:
        if attr_predicate(int(all_rows[j])):
            out.append((int(all_rows[j]), int(counts[j])))
            if n and len(out) == n:
                break
    return out


def tanimoto_rank(all_rows, full, inter, src_count: int, n: int,
                  tanimoto: int, row_ids, attr_predicate=None
                  ) -> List[Tuple[int, int]]:
    """The Tanimoto band over exact counts: a row is a candidate when its
    full count lies strictly inside (|src| t / 100, |src| 100 / t), and
    kept when ceil(100 |row ∩ src| / |row ∪ src|) exceeds t; pairs carry
    |row ∩ src|."""
    if src_count == 0:
        return []
    min_tan = src_count * tanimoto / 100.0
    max_tan = src_count * 100.0 / tanimoto
    wanted = set(int(r) for r in row_ids) if row_ids else None
    pairs: List[Tuple[int, int]] = []
    for j in np.lexsort((all_rows, -inter)):
        if wanted is not None and int(all_rows[j]) not in wanted:
            continue
        cnt, count = int(full[j]), int(inter[j])
        if cnt <= min_tan or cnt >= max_tan or count == 0:
            continue
        t = -(-100 * count // (cnt + src_count - count))  # ceil
        if t <= tanimoto:
            continue
        if attr_predicate is not None and not attr_predicate(
                int(all_rows[j])):
            continue
        pairs.append((int(all_rows[j]), count))
        if n and len(pairs) == n:
            break
    return pairs


def sparse_shape_kind(tree):
    """"leaf" for a single leaf, the op for a flat two-leaf op in leaf
    order (the shapes the sorted-array path serves), else None. `tree`:
    a numbered tree (plan._tree_signature)."""
    if tree == ["leaf", 0]:
        return "leaf"
    if (len(tree) == 3 and tree[0] in ("and", "or", "andnot")
            and tree[1] == ["leaf", 0] and tree[2] == ["leaf", 1]):
        return tree[0]
    return None


def resident_format(sv: "StagedView") -> str:
    """A staged view's container format: dense, sparse (every populated
    slice sorted-array) or mixed."""
    if sv.sparse is None or not sv.slice_formats.any():
        return "dense"
    if sv.slice_formats.all() or not sv.sharded.capacity:
        return "sparse"
    return "mixed"


class StagedView:
    """One (index, frame, view)'s staged pools + what they were staged
    from. `sparse` is the sorted-array pool, or None when every slice
    staged dense; slice_formats[s] is 1 where slice s serves from it.
    The cost gate's state: `last_stage_s` (this view's staging, measured
    to the card's completion; None until measured), `inc_ewma_s` (the
    moving mean of its scatters, carried across a restage of the same
    key), `inc_spend_s` (the scatters' sum since the staging) and
    `inc_count`. The governor's: `last_used` (the use-epoch of the
    resolution that last touched it), `pins` (queries in flight holding
    it), `retired` (no longer the manager's) and `grown` (a row table was
    built since the budget last looked)."""

    __slots__ = ("sharded", "sparse", "slice_formats", "slice_gens",
                 "num_slices", "layouts", "sparse_layouts", "index_rows",
                 "validated", "rows_dev", "last_stage_s", "inc_ewma_s",
                 "inc_spend_s", "inc_count", "last_used", "pins", "retired",
                 "grown", "key")

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
        # dense id -> its index_row on the pool's device (64 bytes a
        # slice), from the row's first K3 Count on.
        self.index_rows: Dict[int, Optional[torch.Tensor]] = {}
        # MUTATION_EPOCH.n when the generations were last found current.
        self.validated = -1
        # (R, S, 16) int32 row_table on the pool's device, built on the
        # first per-row count.
        self.rows_dev: Optional[torch.Tensor] = None
        self.last_stage_s: Optional[float] = None
        self.inc_ewma_s: Optional[float] = None
        self.inc_spend_s = 0.0
        self.inc_count = 0
        self.last_used = 0
        self.pins = 0
        self.retired = False
        self.grown = False
        self.key = None  # (index, frame, view), the cost ledger's

    def release(self) -> None:
        """Drop the view's tensors: it has left the manager and no query
        holds it, so whatever still refers to this object keeps none of
        its device memory."""
        self.sharded = self.sparse = self.rows_dev = None
        self.index_rows = {}

    def snapshot(self):
        """(sharded, sparse, row table, kept index rows), each read once."""
        return (self.sharded, self.sparse, self.rows_dev,
                tuple(self.index_rows.values()))

    def row_table(self) -> torch.Tensor:
        if self.rows_dev is None:
            self.rows_dev = torch.from_numpy(row_table(
                self.sharded.keys_host, len(self.sharded.row_ids))).to(
                    self.sharded.words.device)
            self.grown = True
        return self.rows_dev

    def layout(self, dense_id: int):
        lay = self.layouts.get(dense_id)
        if lay is None:
            lay = self.layouts[dense_id] = leaf_layout(
                self.sharded.keys_host, dense_id)
        return lay

    def index_row(self, dense_id: int) -> Optional[torch.Tensor]:
        """The row's container index as K3 reads it, kept on the card."""
        if dense_id not in self.index_rows:
            self.index_rows[dense_id] = index_row(
                self.layout(dense_id), self.sharded.words.device)
            self.grown = True
        return self.index_rows[dense_id]

    def sparse_layout(self, dense_id: int):
        """(idx, hit) (S, 16) of a row against the sorted-array keys."""
        lay = self.sparse_layouts.get(dense_id)
        if lay is None:
            lay = self.sparse_layouts[dense_id] = resolve_row_indices(
                self.sparse.keys_host, dense_id)
        return lay


class _CountRequest:
    """One dense Count's launch arguments. group_key: batchable together
    (one tree shape, the same pools by object identity, i.e. one staging
    generation, the same slices); dedup_key: the same count."""

    __slots__ = ("tree", "sig", "pools", "index_rows", "layouts",
                 "leaf_keys", "mask", "group_key", "dedup_key", "done",
                 "result", "error", "kernel")

    def __init__(self, tree, sig: str, pools, index_rows, layouts,
                 leaf_keys, mask):
        self.tree = tree
        self.sig = sig  # plan_signature of the tree
        self.pools = pools
        self.index_rows = index_rows  # per leaf, StagedView.index_row
        self.layouts = layouts
        self.leaf_keys = leaf_keys
        self.mask = mask
        self.group_key = (self.sig, tuple(id(p) for p in pools),
                          mask.tobytes())
        self.dedup_key = self.group_key + (leaf_keys,)
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.kernel = None  # the wrapper the batch thread ran it on

    def clear(self) -> None:
        """Drop what the request holds of the card once its count is
        read: a thread that still holds the request holds no pool."""
        self.pools = self.index_rows = self.layouts = self.error = None


class _SparseCount:
    """A count over views with a sorted-array pool: `host_total` from
    cardinality tables, plus one job per format group, each holding the
    pools it reads."""
    __slots__ = ("tree", "sig", "op", "host_total", "jobs")

    def __init__(self, tree, sig: str, op: str, host_total: int,
                 jobs: list):
        self.tree = tree
        self.sig = sig
        self.op = op
        self.host_total = host_total
        self.jobs = jobs


class MeshManager:
    """Stages holder views onto the card and serves Count, within an HBM
    budget. config: the [mesh] knobs of MESH_DEFAULTS (a dict; a key it
    leaves out takes its default)."""

    _MAX_BATCH = 16
    # A staging whose measurement failed counts at least this long, so
    # the gate does not read a fast failure as a cheap restage.
    _FAILED_STAGE_FLOOR_S = 60.0
    # Infeasibility verdicts kept (stage_infeasible's memo).
    _INFEASIBLE_CACHE_MAX = 256

    def __init__(self, holder, device="cuda",
                 sparse_density_threshold: float =
                 DEFAULT_SPARSE_DENSITY_THRESHOLD,
                 config: Optional[dict] = None):
        self.holder = holder
        self.device = resolve_device(device)
        self.sparse_density_threshold = sparse_density_threshold
        # Read on every budget resolution, so a caller may retune it.
        self._config = mesh_config(config)
        # Staged views in use order, least recently used first.
        self._views: "OrderedDict[Tuple[str, str, str], StagedView]" = \
            OrderedDict()
        # Moves whenever a view enters or leaves _views (device_memory's
        # consistency check).
        self._views_gen = 0
        # Bumped by each resolution under _mu; the views it touches carry
        # it (StagedView.last_used) and the budget does not evict them.
        self._use_epoch = 0
        # The budget from the environment or the card, once resolved.
        self._budget_resolved: Optional[int] = None
        # Whether the staged bytes passed the budget at the last eviction
        # pass (pinned or current views kept them over it).
        self._over_budget = False
        # (index, frame, view, num_slices) -> (MUTATION_EPOCH.n, verdict)
        self._infeasible: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._infeasible_mu = threading.Lock()
        self._quarantine = PlanQuarantine()
        self._plan_failures: Dict[str, int] = {}
        self._quar_mu = threading.Lock()
        # Views an n-ary tree pinned to packed words (_demote_to_dense),
        # until invalidate().
        self._dense_pins: set = set()
        # Reentrant: the OOM ladder evicts under it, from a staging that
        # holds it or a launch that does not.
        self._mu = threading.RLock()
        self._stats_mu = threading.Lock()
        self.stats: Counter = Counter()
        self._batch_q: "queue.Queue[_CountRequest]" = queue.Queue()
        self._batch_thread: Optional[threading.Thread] = None
        # The scheduler's cohort hint: requests released together that
        # the batch loop should drain in one window (expect_burst).
        self._burst_mu = threading.Lock()
        self._burst_hint = 0
        self._lone_mu = threading.Lock()
        self._counts_inflight = 0
        # The cost gate's measurements: a worker waits on a CUDA event
        # recorded after the staging or the scatter (_measure_async).
        self._measure_q: "queue.Queue" = queue.Queue(maxsize=64)
        self._measure_thread: Optional[threading.Thread] = None
        self._inc_ewma_s: Optional[float] = None  # all views: a gauge
        self._scattered = False  # the first scatter runs unmeasured

    def _inc(self, key: str, n: int = 1) -> None:
        with self._stats_mu:
            self.stats[key] += n

    def _set(self, key: str, value: int) -> None:
        with self._stats_mu:
            self.stats[key] = value

    # -- the residency governor ----------------------------------------------

    def _hbm_budget_bytes(self) -> int:
        """The staged views' byte budget; <= 0 is unlimited (no eviction,
        no infeasibility gate). In the JAX package's order
        (pilosa_tpu/parallel/serve.py:592-632): the config knob (positive:
        that many bytes, negative: unlimited, 0: fall through);
        $PILOSA_TORCH_HBM_BUDGET_BYTES; the card's total memory less
        hbm_headroom (torch.cuda.mem_get_info's total, never its free
        figure, which counts PyTorch's cached blocks as used); 8 GiB on
        the CPU. The config is read on every call; the environment and
        the card once, until _budget_resolved is reset."""
        b = int(self._config["hbm_budget_bytes"] or 0)
        if not b:
            if self._budget_resolved is None:
                raw = os.environ.get(BUDGET_ENV, "")
                try:
                    b = int(raw) if raw else None
                except ValueError:
                    b = None
                self._budget_resolved = (b if b is not None
                                         else self._probe_budget())
            b = self._budget_resolved
        self._set("hbm_budget_bytes", max(0, b))
        return b

    def _probe_budget(self) -> int:
        if self.device.type != "cuda":
            return CPU_BUDGET_BYTES
        total = torch.cuda.mem_get_info(self.device)[1]
        return int(total * (1.0 - float(self._config["hbm_headroom"])))

    def _view_bytes(self, sv: StagedView) -> int:
        """The device bytes a staged view holds: its pools (as
        estimate_staged_bytes reckons them) and the row tables it has
        built since (rows_dev, the kept index rows)."""
        sharded, sparse, rows_dev, index_rows = sv.snapshot()
        return (_pool_bytes(sharded, sparse)
                + _table_bytes(rows_dev, index_rows))

    def _staged_total(self) -> int:
        return sum(self._view_bytes(v) for v in self._views.values())

    def _drop(self, key, reason: Optional[str] = None) -> None:
        """Take `key`'s view out of the manager, counting an eviction by
        `reason` ("budget" or "oom") when given. Its tensors go now, or
        when the last query holding it releases its pin. Call under
        _mu."""
        sv = self._views.pop(key)
        self._views_gen += 1
        sv.retired = True
        LEDGER.view_evicted(key)
        if sv.pins == 0:
            sv.release()
        if reason:
            self._inc("evicted")
            self._inc(f"evicted_{reason}")

    def _evict_over_budget(self) -> None:
        """Evict least recently used views until the staged bytes fit the
        budget. Views the resolution in progress touched (the current
        use-epoch) and views pinned by a query in flight stay: a query
        over more views than the budget holds runs over it once instead
        of restaging in a loop. Sets the staged_bytes gauge. Call under
        _mu (pilosa_tpu/parallel/serve.py:673-700)."""
        total = self._staged_total()
        budget = self._hbm_budget_bytes()
        if budget > 0:
            for key in [k for k, v in self._views.items()
                        if v.last_used != self._use_epoch and v.pins == 0]:
                if total <= budget:
                    break
                total -= self._view_bytes(self._views[key])
                self._drop(key, "budget")
        self._over_budget = total > budget > 0
        self._set("staged_bytes", total)

    def _reserve(self, key, est: int, budget: int) -> None:
        """Make room for a staging of `est` bytes: evict cold unpinned
        views, least recently used first, until the others and `est` fit
        the budget; `key` itself is being replaced. Pinned or current
        views in the way leave it over budget by this staging at most.
        Call under _mu (pilosa_tpu/parallel/serve.py:1001-1023)."""
        total = sum(self._view_bytes(v) for k, v in self._views.items()
                    if k != key)
        for k in [k for k, v in self._views.items()
                  if k != key and v.pins == 0
                  and v.last_used != self._use_epoch]:
            if total + est <= budget:
                break
            total -= self._view_bytes(self._views[k])
            self._drop(k, "budget")
        self._set("staged_bytes", total)

    def _evict_for_oom(self) -> int:
        """After an out-of-memory error: evict every view no query in
        flight has pinned, current ones too (the failing query's own
        views are pinned). Returns how many went
        (pilosa_tpu/parallel/serve.py:702-722)."""
        with self._mu:
            keys = [k for k, v in self._views.items() if v.pins == 0]
            for key in keys:
                self._drop(key, "oom")
            self._set("staged_bytes", self._staged_total())
        return len(keys)

    def _pin(self, sv: StagedView, pins: Optional[list]) -> None:
        """Pin a view for the query collecting `pins`. Call under _mu."""
        if pins is not None:
            sv.pins += 1
            pins.append(sv)

    def _unpin(self, sv: StagedView, pins: Optional[list]) -> None:
        if pins is not None:
            pins.remove(sv)
            sv.pins -= 1

    def _release_pins(self, pins: list) -> None:
        """Release a query's pins: a retired view whose last pin this was
        drops its tensors. When the query built a row table on its views
        or the staged bytes are over the budget (a query over more views
        than it holds passed it), the budget evicts and the staged_bytes
        gauge is set again; otherwise nothing has changed them
        (pilosa_tpu/parallel/serve.py:1574-1600)."""
        if not pins:
            return
        with self._mu:
            grown = False
            for sv in pins:
                if sv.grown and not sv.retired:
                    # Its row tables grew: the byte-seconds meter follows.
                    LEDGER.view_staged(sv.key, self._view_bytes(sv))
                grown = grown or sv.grown
                sv.grown = False
                sv.pins -= 1
                if sv.pins == 0 and sv.retired:
                    sv.release()
            pins.clear()
            if grown or self._over_budget:
                self._evict_over_budget()

    def stage_infeasible(self, index: str, leaves, num_slices: int) -> bool:
        """Whether a leaf's view, not staged now, would alone pass the
        budget: the executor's routing peek, so a doomed query goes to
        the host before any packing. Verdicts are kept per (index, frame,
        view, num_slices) against MUTATION_EPOCH, which every write moves
        (pilosa_tpu/parallel/serve.py:821-860); the staging's own check
        stays the authority."""
        budget = self._hbm_budget_bytes()
        if budget <= 0:
            return False
        ep = MUTATION_EPOCH.n
        for frame, view in dict.fromkeys((f, v) for f, v, _r, _q in leaves):
            if (index, frame, view) in self._views:
                continue  # resident: it fit when it staged
            ck = (index, frame, view, num_slices)
            with self._infeasible_mu:
                hit = self._infeasible.get(ck)
            if hit is not None and hit[0] == ep:
                bad = hit[1]
            else:
                bad = self._view_would_exceed(index, frame, view,
                                              num_slices, budget)
                with self._infeasible_mu:
                    self._infeasible[ck] = (ep, bad)
                    self._infeasible.move_to_end(ck)
                    while len(self._infeasible) > self._INFEASIBLE_CACHE_MAX:
                        self._infeasible.popitem(last=False)
            if bad:
                return True
        return False

    def view_stats(self, index: str, frame: str, view: str,
                   num_slices: int):
        """view_stats of a view at the format threshold its staging
        would use (0 once an n-ary tree pinned it dense)."""
        thr = (0.0 if (index, frame, view) in self._dense_pins
               else float(self.sparse_density_threshold))
        return view_stats(self.holder, index, frame, view, num_slices, thr)

    def _view_would_exceed(self, index: str, frame: str, view: str,
                           num_slices: int, budget: int) -> bool:
        return format_pool_bytes(*self.view_stats(
            index, frame, view, num_slices)) > budget

    def device_memory(self) -> dict:
        """The residency report: device bytes of the staged views
        (`padded_bytes`, which equals the staged_bytes gauge after a
        query), the live share of them (`live_bytes`: valid container
        slots, a sorted array's real values), the sorted-array pools'
        `sparse_bytes` and the row tables' `table_bytes` (both inside
        padded_bytes), `residency_ratio`, and per-device figures keyed
        by the torch device string. Lock-free: it reads each view once
        and retries while _views_gen moves, and falls back to _mu after
        three tries (pilosa_tpu/parallel/serve.py:724-815)."""
        for _ in range(3):
            gen = self._views_gen
            snap = [sv.snapshot() for sv in list(self._views.values())]
            if self._views_gen == gen:
                return self._device_memory_from(snap)
        with self._mu:
            snap = [sv.snapshot() for sv in self._views.values()]
        return self._device_memory_from(snap)

    def _device_memory_from(self, snap) -> dict:
        sparse_b = table_b = 0
        padded: Dict[str, int] = {}
        live: Dict[str, int] = {}
        for sharded, sparse, rows_dev, index_rows in snap:
            dev = str(sharded.words.device)
            pool = _pool_bytes(sharded, sparse)
            tables = _table_bytes(rows_dev, index_rows)
            table_b += tables
            n = tables + int((sharded.keys_host != INVALID_KEY).sum()
                             ) * CONTAINER_WORDS * 4
            if sparse is not None:
                sparse_b += pool - sharded.words.numel() * 4
                valid = sparse.keys_host != INVALID_KEY
                n += int((sparse.cards_host.astype(np.int64) * 2 + 4)
                         [valid].sum())
            padded[dev] = padded.get(dev, 0) + pool + tables
            live[dev] = live.get(dev, 0) + n
        total, total_live = sum(padded.values()), sum(live.values())
        return {"views": len(snap), "padded_bytes": total,
                "live_bytes": total_live, "sparse_bytes": sparse_b,
                "table_bytes": table_b,
                "residency_ratio": total_live / total if total else 1.0,
                "per_device": padded, "live_per_device": live,
                "residency_per_device": {d: live[d] / b if b else 1.0
                                         for d, b in padded.items()}}

    def describe_views(self, index: str, keys) -> List[Optional[str]]:
        """The resident format (resident_format) of each (frame, view) of
        `keys` in `index`, None where it is not staged; read under _mu,
        so an eviction cannot release a view mid-read. Changes nothing:
        explain() asks it."""
        with self._mu:
            out = []
            for frame, view in keys:
                sv = self._views.get((index, frame, view))
                out.append(None if sv is None else resident_format(sv))
            return out

    def invalidate(self, index: Optional[str] = None) -> None:
        """Drop the staged views of `index`, or every view, and their
        dense pins (pilosa_tpu/parallel/serve.py:1462-1490): the
        executor calls it when an index or frame is deleted, so the card
        memory goes at once. A view a query in flight holds goes when
        that query ends."""
        with self._mu:
            for key in [k for k in self._views
                        if index is None or k[0] == index]:
                self._drop(key)
            self._dense_pins = {k for k in self._dense_pins
                                if index is not None and k[0] != index}
            self._set("staged_bytes", self._staged_total())

    # -- plan quarantine and guarded launches --------------------------------

    def _note_plan_failure(self, sig: str) -> None:
        """A launch of `sig` ran out of memory after eviction: at
        quarantine_after strikes it is quarantined for quarantine_ttl
        seconds, and the strikes start over
        (pilosa_tpu/parallel/serve.py:2067-2086)."""
        with self._quar_mu:
            n = self._plan_failures.get(sig, 0) + 1
            if n < int(self._config["quarantine_after"]):
                self._plan_failures[sig] = n
                return
            self._plan_failures.pop(sig, None)
        self._quarantine.quarantine(sig, float(self._config["quarantine_ttl"]))
        self._inc("plan_quarantined")

    def plan_quarantined(self, sig: str) -> bool:
        return self._quarantine.is_quarantined(sig)

    def quarantine_plan(self, sig: str) -> None:
        """Quarantine `sig` now, without strikes."""
        with self._quar_mu:
            self._plan_failures.pop(sig, None)
        self._quarantine.quarantine(sig, float(self._config["quarantine_ttl"]))
        self._inc("plan_quarantined")

    def quarantined_plans(self) -> List[str]:
        return self._quarantine.quarantined_sigs()

    def clear_quarantine(self, sig: Optional[str] = None) -> int:
        """Lift one signature's quarantine, or every one, and forget its
        strikes; returns how many were lifted."""
        with self._quar_mu:
            if sig is None:
                self._plan_failures.clear()
            else:
                self._plan_failures.pop(sig, None)
        return self._quarantine.clear_quarantine(sig)

    def _oom_ladder(self, attempt, what: str, on_fail=None):
        """attempt() through the OOM ladder: an out-of-memory error
        evicts every unpinned view and attempts once more; a second one
        calls on_fail() and raises DeviceResourceError("oom"). Any other
        error, a DeviceResourceError too, propagates as it is."""
        try:
            return attempt()
        except DeviceResourceError:
            raise
        except Exception as e:  # noqa: BLE001 — classified, then re-raised
            if not _is_oom(e):
                raise
        # Out of the handler: its traceback no longer holds what the
        # failed attempt allocated while the eviction frees memory.
        self._inc("oom_retries")
        self._evict_for_oom()
        try:
            return attempt()
        except DeviceResourceError:
            raise
        except Exception as e:  # noqa: BLE001 — classified, then re-raised
            if not _is_oom(e):
                raise
            msg = str(e)
        if on_fail is not None:
            on_fail()
        self._inc("fallback_oom")
        raise DeviceResourceError(f"{what} ran out of device memory after "
                                  f"eviction: {msg}", reason="oom")

    def _guarded_exec(self, sig: str, launch, kind: str = "count"):
        """launch() through the recovery ladder
        (pilosa_tpu/parallel/serve.py:2161-2225): a quarantined `sig`
        raises DeviceResourceError("quarantined") with no launch, and
        _oom_ladder runs the launch, a second out-of-memory error noting
        a strike against `sig`. Any other error (a kernel that does not
        build, a launch failure, an illegal address) propagates and
        takes no strike: the JAX package strikes it too, and a strike
        leads to a quarantine that the executor answers on the host, so
        in the port a failing kernel would stop failing its requests.
        Call outside _mu, with the launch's views pinned."""
        if self.plan_quarantined(sig):
            self._inc("fallback_quarantined")
            raise DeviceResourceError(f"plan quarantined: {sig[:80]}",
                                      reason="quarantined")

        def attempt():
            fault.point("device.exec", sig=sig, kind=kind)
            return launch()

        return self._oom_ladder(attempt, f"launch of plan {sig[:80]}",
                                on_fail=lambda: self._note_plan_failure(sig))

    # -- staging -------------------------------------------------------------

    def refresh(self, index: str, frame: str, view: str,
                num_slices: int) -> Optional[StagedView]:
        """An up-to-date StagedView, or None when the frame does not
        exist. Writes since the staging scatter into the pool when every
        written slice can take them (_scatter_pending), else the view
        restages whole (_stage). Marks the view used by the resolution in
        progress. Raises DeviceResourceError when the view cannot be
        staged within the budget or the card's memory. Call under _mu."""
        if self.holder.frame(index, frame) is None:
            return None
        key = (index, frame, view)
        epoch = MUTATION_EPOCH.n  # read before the walk: a racing write
        sv = self._views.get(key)  # leaves the stamp behind, never ahead
        if sv is not None:
            self._views.move_to_end(key)
            sv.last_used = self._use_epoch
            LEDGER.view_touched(key)
        if sv is None or sv.num_slices != num_slices:
            return self._stage(key, num_slices, epoch)
        if sv.validated == epoch:
            return sv
        pending: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        new_gens = list(sv.slice_gens)
        v = self.holder.view(index, frame, view)
        frags = v.fragments if v is not None else {}
        for s in range(num_slices):
            frag = frags.get(s)
            staged = sv.slice_gens[s]
            if frag is None:
                if staged is None:
                    continue
                return self._stage(key, num_slices, epoch)  # dropped
            if staged is None or staged[0] is not frag:
                return self._stage(key, num_slices, epoch)  # a new object
            if frag.generation == staged[1]:
                continue  # an int read: the lock only where it moved
            with frag._mu:
                gen = frag.generation
                entries = frag.log_since(staged[1])
            if entries is None or any(e[2] for e in entries):
                return self._stage(key, num_slices, epoch)
            pending[s] = fold_log_entries(entries)
            new_gens[s] = (frag, gen)
        if not pending:
            sv.validated = epoch
            return sv
        if sv.sparse is not None:
            # A sorted-array pool has no scatter (an insert shifts every
            # value after it), and it is the small one: restage.
            self._inc("refresh_pick_restage")
            return self._stage(key, num_slices, epoch)
        # The cost gate, per view: restage when this view's staging has
        # cost less than its scatters; probe with a restage once the
        # scatters have spent 20x a staging, which re-measures it.
        probe = (sv.last_stage_s is not None
                 and sv.inc_spend_s > 20.0 * sv.last_stage_s)
        inc_est = sv.inc_ewma_s
        if probe or (inc_est is not None and sv.last_stage_s is not None
                     and sv.last_stage_s < inc_est):
            self._inc("refresh_pick_restage")
            if probe:
                self._inc("refresh_probe_restage")
            else:
                # Decay on a restage the gate chose (a probe carries no
                # evidence against the scatter), so one slow scatter
                # cannot hold the gate on restaging for good.
                sv.inc_ewma_s = inc_est * 0.9
            return self._stage(key, num_slices, epoch)
        return self._scatter_pending(key, sv, pending, new_gens, epoch)

    def _scatter_pending(self, key, sv: StagedView, pending, new_gens,
                         epoch: int) -> StagedView:
        """Plan each written slice's final bit states against the staged
        keys and scatter them into the pool with one K7 launch; restage
        instead when a set lands in a container the image lacks. The
        scatter's cost, host planning to the card's completion, feeds
        the view's estimate (the manager's first scatter excepted)."""
        t0 = time.monotonic()
        try:
            per_slice = {s: plan_slice_mutations(
                sv.sharded.keys_host[s], sv.sharded.row_ids, pos, val)
                for s, (pos, val) in pending.items()}
        except KeyError:
            return self._stage(key, sv.num_slices, epoch)
        apply_writes(sv.sharded, *pack_mutation_batches(
            per_slice, sv.sharded.num_slices, sv.sharded.capacity))
        sv.slice_gens = new_gens
        sv.validated = epoch
        sv.inc_count += 1
        self._inc("incremental")
        self._inc("refresh_pick_incremental")
        if self._scattered:
            self._measure_async(sv.sharded.words, t0,
                                lambda dt, ok=True, sv=sv:
                                self._record_inc_sample(sv, dt, ok))
        self._scattered = True
        return sv

    def _stage(self, key, num_slices: int, epoch: int) -> StagedView:
        """Stage the view whole through the OOM ladder
        (pilosa_tpu/parallel/serve.py:1025-1048): an out-of-memory error
        evicts every unpinned view and stages once more; a second raises
        DeviceResourceError("oom"). A view over the whole budget raises
        DeviceResourceError("hbm_infeasible") before a byte moves. Call
        under _mu."""
        with obs.span("stage", view="/".join(key), slices=num_slices), \
                obs.profile.phase("stage_h2d"):
            return self._oom_ladder(
                lambda: self._stage_once(key, num_slices, epoch),
                f"staging {key}")

    def _stage_once(self, key, num_slices: int, epoch: int) -> StagedView:
        """Pack the view on the host, each slice's format picked under its
        fragment's lock with the previous image's formats as the
        hysteresis input; check the budget; drop the previous image
        (its pools go before the new ones are allocated) and make room;
        then build the pools on the card. The previous image's scatter
        estimate carries over."""
        index, frame, view = key
        fault.point("mesh.stage", index=index, frame=frame, view=view,
                    slices=num_slices)
        t0 = time.monotonic()
        old = self._views.get(key)
        prev = old.slice_formats if old is not None else None
        inc_ewma_s = old.inc_ewma_s if old is not None else None
        old = None
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
        budget = self._hbm_budget_bytes()
        est = estimate_staged_bytes(packed, formats) if budget > 0 else 0
        if est > budget > 0:
            self._inc("fallback_hbm_infeasible")
            raise DeviceResourceError(
                f"staged view {key} needs {est} bytes, over the {budget}-"
                "byte HBM budget", reason="hbm_infeasible")
        if key in self._views:
            self._drop(key)
        if budget > 0:
            self._reserve(key, est, budget)
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
        sv.inc_ewma_s = inc_ewma_s
        sv.last_used = self._use_epoch
        sv.key = key
        self._views[key] = sv
        self._views_gen += 1
        self._evict_over_budget()
        nbytes = _pool_bytes(sharded, sparse)
        LEDGER.view_staged(key, nbytes)
        obs.profile.add_bytes("bytes_staged", nbytes)
        self._inc("h2d_bytes", nbytes)
        self._inc("stage")
        self._inc("stage_us", int((time.monotonic() - t0) * 1e6))
        self._measure_async(sv.sharded.words, t0,
                            lambda dt, ok=True, sv=sv:
                            self._record_stage_sample(sv, dt, ok))
        return sv

    # -- the cost gate's measurements ----------------------------------------

    def _record_stage_sample(self, sv: StagedView, elapsed: float,
                             ok: bool = True) -> None:
        """A failed measurement counts at least the view's scatter
        estimate (else _FAILED_STAGE_FLOOR_S), so a fast failure never
        reads as a cheap restage."""
        if not ok:
            floor = sv.inc_ewma_s
            elapsed = max(elapsed, floor if floor is not None
                          else self._FAILED_STAGE_FLOOR_S)
        sv.last_stage_s = elapsed

    def _record_inc_sample(self, sv: StagedView, dt: float,
                           ok: bool = True) -> None:
        if not ok:  # a failure's time says nothing of a scatter's cost
            return
        with self._stats_mu:
            sv.inc_ewma_s = (dt if sv.inc_ewma_s is None
                             else 0.5 * (dt + sv.inc_ewma_s))
            self._inc_ewma_s = (dt if self._inc_ewma_s is None
                                else 0.5 * (dt + self._inc_ewma_s))
            self.stats["inc_ewma_us"] = int(self._inc_ewma_s * 1e6)
            sv.inc_spend_s += dt

    def _measure_async(self, words: torch.Tensor, t0: float, on_done) -> None:
        """on_done(seconds since t0) once the card has finished the work
        queued so far on words' stream: a CUDA event recorded now, which
        a daemon worker waits on, so the caller does not block. On the
        CPU the work is already done and on_done runs at once. A full
        queue records the time so far (a lower bound) instead."""
        if words.device.type != "cuda":
            on_done(time.monotonic() - t0)
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(words.device))
        if self._measure_thread is None:
            self._measure_thread = threading.Thread(
                target=self._measure_loop, name="mesh-cost-measure",
                daemon=True)
            self._measure_thread.start()
        try:
            self._measure_q.put_nowait((ev, t0, on_done))
        except queue.Full:
            on_done(time.monotonic() - t0)

    def _measure_loop(self):
        while True:
            ev, t0, on_done = self._measure_q.get()
            ok = True
            try:
                ev.synchronize()
            except Exception:  # noqa: BLE001 — the query surfaces it
                ok = False
            elapsed = time.monotonic() - t0
            try:
                on_done(elapsed, ok)
            except Exception:  # noqa: BLE001 — never kill the worker
                pass
            finally:
                self._measure_q.task_done()

    def _demote_to_dense(self, key, num_slices: int) -> Optional[StagedView]:
        """Pin `key` to packed words and restage it: a tree only the dense
        kernels fold reached a view with a sorted-array pool. The pin is
        sticky until invalidate(), so one mixed workload settles into one
        layout; when the dense image cannot be staged it goes, and the
        view keeps its sorted arrays. Call under _mu."""
        self._dense_pins.add(key)
        self._inc("sparse_demote")
        if key in self._views:
            self._drop(key)
        try:
            return self.refresh(*key, num_slices)
        except DeviceResourceError:
            self._dense_pins.discard(key)
            raise

    def _resolve(self, index: str, shape, leaves, slices: Sequence[int],
                 num_slices: int, pins: Optional[list] = None,
                 sig: Optional[str] = None):
        """Stage each leaf's view once and pick the path from that
        staging: a _SparseCount when a view holds a sorted-array pool and
        the tree is one the format groups serve, else a _CountRequest for
        the dense kernels (other trees demote the sorted-array views
        first). A leaf that is not required and names a view that does
        not exist reads as an absent row of another staged view; when no
        leaf's view exists the count is 0, returned as the int. None
        when a view cannot be staged or the slices reach past it. With
        `pins` (a list), each staged view is pinned for the caller's
        _release_pins. `sig`: the plan signature, when the caller has
        it."""
        tree = _tree_signature(shape)
        sig = sig or json.dumps(tree)
        with self._mu:
            self._use_epoch += 1
            staged: Dict[Tuple[str, str], StagedView] = {}
            absent = set()
            for frame, view, _row, req in leaves:
                key = (frame, view)
                if key in staged or key in absent:
                    continue
                if not req and self.holder.view(index, frame, view) is None:
                    absent.add(key)
                    continue
                sv = self.refresh(index, frame, view, num_slices)
                if sv is None:
                    return None
                self._pin(sv, pins)
                staged[key] = sv
            mask = slice_mask(num_slices, slices)
            if mask is None:
                return None
            if not staged:
                self._inc("absent_views")
                return 0
            if any(sv.sparse is not None for sv in staged.values()):
                op = sparse_shape_kind(tree)
                if op is not None:
                    return self._sparse_request(
                        tree, sig, op, leaves,
                        self._legs(staged, absent, leaves),
                        mask, num_slices)
                self._inc("fallback_sparse_shape")
                for fv in [k for k, sv in staged.items()
                           if sv.sparse is not None]:
                    # Unpinned first, so the restage frees its image.
                    self._unpin(staged[fv], pins)
                    sv = self._demote_to_dense((index,) + fv, num_slices)
                    if sv is None:
                        return None
                    self._pin(sv, pins)
                    staged[fv] = sv
            pools, index_rows, layouts, keys = [], [], [], []
            for sv, dense in self._legs(staged, absent, leaves):
                pools.append(sv.sharded.words)
                index_rows.append(sv.index_row)
                layouts.append(sv.layout(dense))
                keys.append((id(sv.sharded.words), dense))
        return _CountRequest(tree, sig, tuple(pools), tuple(index_rows),
                             tuple(layouts), tuple(keys), mask)

    @staticmethod
    def _legs(staged, absent, leaves) -> List[Tuple[StagedView, int]]:
        """(staged view, dense row id) of each leaf; a leaf of an absent
        view reads one past the last row of the first staged view."""
        spare = next(iter(staged.values()))
        out = []
        for frame, view, row_id, _req in leaves:
            if (frame, view) in absent:
                out.append((spare, len(spare.sharded.row_ids)))
            else:
                sv = staged[(frame, view)]
                out.append((sv, dense_row(sv.sharded, row_id)))
        return out

    # -- serving -------------------------------------------------------------

    def count(self, index: str, shape, leaves, slices: Sequence[int],
              num_slices: int, sig: Optional[str] = None) -> Optional[int]:
        """Count over a lowered bitmap-op tree (plan._lower_tree), or
        None when the views cannot be staged. `sig`: its plan_signature,
        when the caller has it. Raises DeviceResourceError when the card
        cannot serve it (a quarantined plan, a view over the budget, out
        of memory after the ladder); other device errors raise as they
        are."""
        pins: list = []
        req = None
        try:
            req = self._resolve(index, shape, leaves, slices, num_slices,
                                pins=pins, sig=sig)
            if req is None:
                self._inc("fallback")
                return None
            if isinstance(req, int):
                self._inc("count")
                return req
            if isinstance(req, _SparseCount):
                total = self._run_sparse(req)
                self._inc("sparse_count")
            else:
                total = self._run_dense(req)
            self._inc("count")
            # The result seam: a delta= rule is a kernel that silently
            # miscomputes, which shadow verification must catch.
            return fault.perturb("device.exec", total, sig=req.sig,
                                 kind="count-result")
        finally:
            if isinstance(req, _CountRequest):
                req.clear()
            self._release_pins(pins)

    def _run_dense(self, req: _CountRequest) -> int:
        """A lone count runs on the calling thread; concurrent ones go
        through the batch thread, whose error keeps its type when it is
        a DeviceResourceError (the executor's host fold keys on it)."""
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
                prof = obs.profile.current()
                if prof is None:
                    with obs.span("batch_wait"):
                        req.done.wait()
                else:
                    # The batch thread launches and reads back: from here
                    # the wait is the device's time (and the readback).
                    with prof.phase("device_exec"):
                        req.done.wait()
                    prof.add_bytes("bytes_touched_hbm", kernel_read_bytes(
                        req.kernel or "", [req.layouts]))
                    prof.add_slice(engine="device_batched",
                                   leaves=len(req.leaf_keys),
                                   slices=int(req.mask.sum()))
            err = req.error
            if isinstance(err, DeviceResourceError):
                raise DeviceResourceError(str(err), reason=err.reason) \
                    from err
            if err is not None:
                raise RuntimeError(f"device count failed: {err}") from err
            return req.result
        finally:
            with self._lone_mu:
                self._counts_inflight -= 1

    # -- per-row counts: TopN and the integer-field planes ------------------

    def _staged_dense(self, index: str, frame: str, view: str,
                      num_slices: int) -> Optional[StagedView]:
        """refresh, then _demote_to_dense when the view holds a
        sorted-array pool. Call under _mu."""
        sv = self.refresh(index, frame, view, num_slices)
        if sv is not None and sv.sparse is not None:
            sv = self._demote_to_dense((index, frame, view), num_slices)
        return sv

    def _row_counts(self, index: str, frame: str, view: str,
                    slices: Sequence[int], num_slices: int, src=None,
                    rows: Optional[Sequence[int]] = None,
                    with_full: bool = False):
        """(row ids (R,) uint64, counts (R,) int64) of every row the
        staged view holds, or only of `rows`, from K5's serving form
        (kernels.pair_count_rows), one launch per MAX_ROWS_PER_LAUNCH
        rows. With `src` = (numbered tree, leaves) from plan._lower_tree
        the counts are |row ∩ src|: a src that is one row of this view
        is read from the pool, any other is materialized once as an
        (S, 16, 2048) block. A view staged sorted-array is demoted to
        packed words first. with_full adds the counts without src, from
        a second launch over the same staged image: (row ids, src
        counts, full counts). None when a view cannot be staged or the
        slices reach past it. The views stay pinned, and the row table
        is built and the launches run, outside _mu, under
        _guarded_exec."""
        pins: list = []
        try:
            with self._mu:
                self._use_epoch += 1
                sv = self._staged_dense(index, frame, view, num_slices)
                mask = slice_mask(num_slices, slices)
                if sv is None or mask is None:
                    return None
                self._pin(sv, pins)
                all_rows = sv.sharded.row_ids
                sel = (None if rows is None else
                       np.nonzero(np.isin(all_rows, np.asarray(
                           list(rows), dtype=np.uint64)))[0])
                row_ids = all_rows if sel is None else all_rows[sel]
                if not len(row_ids):
                    none = np.zeros(0, dtype=np.int64)
                    return (row_ids, none) + ((none,) if with_full else ())
                pool = sv.sharded.words
                b = {}
                if src is not None:
                    tree, leaves = src
                    staged = {}
                    for f, v, _row, _req in leaves:
                        if (f, v) not in staged:
                            staged[(f, v)] = self._staged_dense(
                                index, f, v, num_slices)
                            if staged[(f, v)] is None:
                                return None
                            self._pin(staged[(f, v)], pins)
                    dense = [dense_row(staged[(f, v)].sharded, r)
                             for f, v, r, _req in leaves]
                    if tree == ["leaf", 0] and leaves[0][:2] == (frame, view):
                        b = {"b_pool": pool, "b_dense": dense[0]}
                    else:
                        b = {"b_block": (
                            tree, [staged[(f, v)].sharded.words
                                   for f, v, _r, _q in leaves],
                            [staged[(f, v)].layout(d) for (f, v, _r, _q), d
                             in zip(leaves, dense)])}

            def launch():
                table = sv.row_table()
                dev = pool.device
                bb = dict(b)
                if "b_dense" in bb:
                    d = bb.pop("b_dense")
                    bb["b_idx"] = (table[d] if d < table.shape[0] else
                                   torch.full(table.shape[1:], -1,
                                              dtype=torch.int32, device=dev))
                elif "b_block" in bb:
                    bb["b_block"] = materialize_block(*bb["b_block"])
                a_idx = (table if sel is None else
                         table[torch.from_numpy(sel).to(dev)])
                if not mask.all():
                    keep = torch.from_numpy(mask != 0).to(dev)[None, :, None]
                    a_idx = torch.where(keep, a_idx, -1)
                out = (row_ids, self._pair_rows(pool, a_idx, bb))
                return (out + (self._pair_rows(pool, a_idx, {}),)
                        if with_full else out)

            sig = "__row_counts__" + ("" if src is None else
                                      ":" + plan_signature(src[0]))
            return self._guarded_exec(sig, launch, kind="row_counts")
        finally:
            self._release_pins(pins)

    def _pair_rows(self, pool, a_idx, b) -> np.ndarray:
        """kernels.pair_count_rows over a_idx's rows, MAX_ROWS_PER_LAUNCH
        a launch, as int64 numpy totals."""
        parts = []
        prof = obs.profile.current()
        with obs.profile.phase("device_exec"), \
                obs.device_scope("pilosa:row_counts"):
            for lo in range(0, a_idx.shape[0], MAX_ROWS_PER_LAUNCH):
                parts.append(kernels.pair_count_rows(
                    pool, a_idx[lo:lo + MAX_ROWS_PER_LAUNCH].contiguous(),
                    "and", **b))
                self._inc("kernel:pair_count_rows")
            if prof is not None and pool.device.type == "cuda":
                torch.cuda.synchronize(pool.device)
        with obs.profile.phase("readback_d2h"):
            counts = (parts[0] if len(parts) == 1 else torch.cat(parts)
                      ).cpu().numpy()
        return fault.perturb("device.exec", counts, sig="__row_counts__",
                             kind="count-result")

    def bsi_plane_counts(self, index: str, frame: str, view: str,
                         slices: Sequence[int], num_slices: int, src=None,
                         rows: Optional[Sequence[int]] = None
                         ) -> Optional[Dict[int, int]]:
        """Per-row counts over a ``bsi.<field>`` view as {row_id: count}
        (_row_counts): every row the view holds, or only `rows`, each
        ANDed with `src` when given. None when a view cannot be
        staged."""
        out = self._row_counts(index, frame, view, slices, num_slices,
                               src=src, rows=rows)
        if out is None:
            return None
        self._inc("bsi_aggregate")
        return dict(zip(out[0].tolist(), out[1].tolist()))

    def row_counts(self, index: str, frame: str, view: str,
                   slices: Sequence[int], num_slices: int):
        """Exact per-row counts over the slices: (row ids, counts int64)
        or None. The JAX package's MeshManager.row_counts."""
        return self._row_counts(index, frame, view, slices, num_slices)

    def row_counts_src(self, index: str, frame: str, view: str, src_shape,
                       src_leaves, slices: Sequence[int], num_slices: int):
        """Exact per-row |row ∩ src| over the slices, src a lowered tree:
        (row ids, counts int64) or None. The JAX package's
        MeshManager.row_counts_src."""
        return self._row_counts(index, frame, view, slices, num_slices,
                                src=(src_shape, src_leaves))

    def top_n(self, index: str, frame: str, view: str,
              slices: Sequence[int], num_slices: int, n: int,
              row_ids: Sequence[int], min_threshold: int,
              src: Optional[tuple] = None, attr_predicate=None,
              tanimoto_threshold: int = 0
              ) -> Optional[List[Tuple[int, int]]]:
        """TopN in every argument form from exact counts on the card,
        with the host semantics of rank_pairs / tanimoto_rank. With
        `row_ids` this is also TopN's exact phase. With `src` = (numbered
        tree, leaves) the counts are |row ∩ src|; the Tanimoto band takes
        the full counts, the src counts and |src| (two K5 launches and a
        Count). None when a view cannot be staged."""
        rows = row_ids or None
        if tanimoto_threshold > 0:
            if src is None:
                return None
            out = self._row_counts(index, frame, view, slices, num_slices,
                                   src=src, rows=rows, with_full=True)
            src_count = (None if out is None else
                         self.count(index, src[0], src[1], slices,
                                    num_slices))
            if src_count is None:
                return None
            self._inc("topn")
            all_rows, inter, full = out
            return tanimoto_rank(all_rows, full, inter, src_count,
                                 0 if row_ids else n, tanimoto_threshold,
                                 row_ids, attr_predicate)
        out = self._row_counts(index, frame, view, slices, num_slices,
                               src=src, rows=rows)
        if out is None:
            return None
        self._inc("topn")
        return rank_pairs(out[0], out[1], n, row_ids, min_threshold,
                          attr_predicate)

    # -- sorted-array serving ------------------------------------------------

    def _sparse_request(self, tree, sig: str, op: str, leaves, legs, mask,
                        num_slices: int) -> _SparseCount:
        """The format groups of a count over sorted-array pools. The
        slices split by the leaves' format pair into at most four groups:
        dd goes through count_batch on the dense pools with the group's
        mask, ss through K4, sd and ds through the probe
        (mesh.count_sparse_pair); the group counts add up. A single
        sorted-array leaf needs no kernel: its count is the cardinality
        table at the row's containers. A view whose dense pool is empty
        (every populated slice went sorted-array) serves every slice
        from the sorted-array pool, where absent containers read 0.
        legs: _legs' (staged view, dense row id) of each leaf. Call under
        _mu."""
        sel = mask.astype(bool)
        host_total, jobs, leg_list = 0, [], []
        for sv, dense in legs:
            has_dense = sv.sharded.capacity > 0
            leg_list.append((
                sv, sv.layout(dense) if has_dense else None,
                sv.sparse_layout(dense) if sv.sparse is not None else None,
                sv.slice_formats.astype(bool) if has_dense
                else np.ones(num_slices, dtype=bool)))
        legs = leg_list
        if op == "leaf":
            sv, d_lay, s_lay, fmts = legs[0]
            if (sel & fmts).any():
                idx, hit = s_lay
                per = np.take_along_axis(sv.sparse.cards_host, idx,
                                         axis=1).astype(np.int64) * hit
                host_total = int(per[sel & fmts].sum())
                self._inc("sparse_leaf_host")
            if (sel & ~fmts).any():
                jobs.append(("dd", [sv.sharded.words], [d_lay],
                             [sv.index_row], sel & ~fmts))
            return _SparseCount(tree, sig, op, host_total, jobs)
        (sva, da, sa, fa), (svb, db, sb, fb) = legs
        for gk, gsel in (("dd", sel & ~fa & ~fb), ("sd", sel & fa & ~fb),
                         ("ds", sel & ~fa & fb), ("ss", sel & fa & fb)):
            if not gsel.any():
                continue
            if gk == "dd":
                jobs.append((gk, [sva.sharded.words, svb.sharded.words],
                             [da, db], [sva.index_row, svb.index_row],
                             gsel))
                continue
            pool_a, (ia, ha) = (
                ((sva.sparse.values, sva.sparse.cards), sa) if gk[0] == "s"
                else ((sva.sharded.words,), (da.idx, da.hit)))
            pool_b, (ib, hb) = (
                ((svb.sparse.values, svb.sparse.cards), sb) if gk[1] == "s"
                else ((svb.sharded.words,), (db.idx, db.hit)))
            jobs.append((gk, pool_a, pool_b, ia, ha, ib, hb, gsel))
        return _SparseCount(tree, sig, op, host_total, jobs)

    def _run_sparse(self, req: _SparseCount) -> int:
        """Run a _SparseCount's groups on the calling thread, outside _mu:
        the jobs hold the pools they read, and each group's launch runs
        under _guarded_exec with the plan signature tagged by its
        format pair."""
        total, sig = req.host_total, req.sig
        with obs.profile.phase("device_exec"), \
                obs.device_scope("pilosa:count_sparse"):
            return total + self._run_sparse_jobs(req, sig)

    def _run_sparse_jobs(self, req: _SparseCount, sig: str) -> int:
        total = 0
        for job in req.jobs:
            gk, gmask = job[0], job[-1].astype(np.int64)
            if gk == "dd":
                totals, name = self._guarded_exec(
                    format_signature(sig, gk),
                    lambda job=job: count_batch(req.tree, job[1], [job[2]],
                                                gmask, index_rows=job[3]))
                total += int(totals[0])
            else:
                total += self._guarded_exec(
                    format_signature(sig, gk),
                    lambda job=job: count_sparse_pair(req.op, *job[:-1],
                                                      gmask))
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

    def expect_burst(self, n: int) -> None:
        """The scheduler's cohort hint (Executor.burst_hint): n requests
        were just released together, so the next drain waits the window
        for all of them instead of launching the first alone."""
        with self._burst_mu:
            self._burst_hint += int(n)

    @staticmethod
    def _drain_window_s() -> float:
        """The herd drain window: $PILOSA_TORCH_BATCH_WINDOW_MS, default
        3 ms (an unreadable value reads as the default)."""
        try:
            ms = float(os.environ.get(BATCH_WINDOW_ENV)
                       or DEFAULT_BATCH_WINDOW_MS)
        except ValueError:
            ms = DEFAULT_BATCH_WINDOW_MS
        return max(0.0, ms) / 1e3

    def _batch_loop(self):
        """Drain what queued while the card was busy, group it, and run
        each group as one launch. Event-driven on the liveness plane: an
        empty queue is idle, not a hang; each group's launch is judged
        as an in-flight op."""
        hb = HEALTH.register("mesh-count-batch", interval=None,
                             critical=True)
        last = 1
        while True:
            hb.idle()
            first = self._batch_q.get()
            hb.beat()
            last = self._run_batch(first, last)

    def _run_batch(self, first: _CountRequest, last: int = 1) -> int:
        """One drain of the batch loop (its locals go when it returns:
        an idle batch thread holds no request). When the previous drain
        (`last` requests) showed concurrency, or a cohort was hinted, it
        waits the drain window for stragglers. Returns its size."""
        reqs = [first]
        with self._burst_mu:
            hinted = self._burst_hint > 1
        deadline = (time.monotonic() + self._drain_window_s()
                    if (last > 1 or hinted) else 0.0)
        while len(reqs) < self._MAX_BATCH:
            try:
                reqs.append(self._batch_q.get_nowait())
            except queue.Empty:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    reqs.append(self._batch_q.get(timeout=wait))
                except queue.Empty:
                    break
        with self._burst_mu:
            if self._burst_hint:
                self._burst_hint = max(0, self._burst_hint - len(reqs))
        if hinted:
            self._inc("sched_hinted")
        groups: Dict[tuple, List[_CountRequest]] = {}
        for r in reqs:
            groups.setdefault(r.group_key, []).append(r)
        for group in groups.values():
            try:
                # A launch that never returns wedges every count queued
                # behind this loop: the watchdog must see it.
                with HEALTH.inflight("mesh-count-batch", "count-group",
                                     base=30.0):
                    self._run_count_group(group)
            except Exception as e:  # noqa: BLE001 — fail this group only
                for r in group:
                    r.error = e
                    r.done.set()
        return len(reqs)

    def _run_count_group(self, group: List[_CountRequest]):
        """One launch for the group, under _guarded_exec; identical
        requests share a slot."""
        uniq: Dict[tuple, _CountRequest] = {}
        for r in group:
            uniq.setdefault(r.dedup_key, r)
        distinct = list(uniq.values())
        self._inc("deduped", len(group) - len(distinct))
        first = distinct[0]
        totals, kernel = self._guarded_exec(first.sig, lambda: count_batch(
            first.tree, first.pools, [r.layouts for r in distinct],
            first.mask, leaf_keys=[r.leaf_keys for r in distinct],
            index_rows=first.index_rows))
        self._inc(f"kernel:{kernel}")
        if len(distinct) > 1:
            self._inc("batched", len(distinct))
            if "shared" in kernel:
                self._inc("shared_batch", len(distinct))
        slot = {id(r): i for i, r in enumerate(distinct)}
        for r in group:
            r.result = int(totals[slot[id(uniq[r.dedup_key])]])
            r.kernel = kernel
            r.done.set()
