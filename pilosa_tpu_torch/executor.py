"""Executor: PQL evaluation over a Holder.

Count over a lowerable Bitmap / Intersect / Union / Difference / Range
tree goes to the card through MeshManager.count, unless cost routing
sends it to the host fold (the JAX executor's, below). Unlowerable trees
(and views that cannot be staged) count on the host (below), which
`stats["count_host"]` shows.

Cost routing (the JAX package's pilosa_tpu/executor.py:1880-1990): a
lowerable Count whose work, slices x leaves, is under `device_min_work`
folds on the host (HostCountPlan, route reason "min_work"), and so does a
Sum / Min / Max whose slices x the field's rows is; on the CPU with the
native library built, larger ones fold there too ("cpu_native"; off with
PILOSA_TORCH_CPU_ROUTE_NATIVE=off or 0). The threshold is the
`device_min_work` argument, else $PILOSA_TORCH_DEVICE_MIN_WORK, else
_DEFAULT_MIN_WORK (0); zero or less turns cost routing off, the
`cpu_native` route with it. Every routed
call counts in the manager's `routed_host`.

Sum / Min / Max over an integer field (optionally filtered by one bitmap
child) run on the card too: Sum from the per-row counts of the field's
bsi view (MeshManager.bsi_plane_counts, K5), with a second pass over the
sign row only when the first saw negatives; Min / Max as an MSB-down
search over the magnitude planes, one tree count per probe. A filter
that does not lower sends the aggregate to the host folds of bsi.host
(`stats["bsi_host"]`).

TopN runs on the card from exact per-row counts (MeshManager.top_n, K5)
in every argument form; when the card cannot serve it (a src child that
does not lower, filters without a field, a Tanimoto threshold without a
src or above 100) it runs the JAX package's two-phase host TopN over the
fragments' rank caches (`top_n_host`): an approximate pass, then an
exact recount of the candidate ids. `stats["topn_device"]` and
`stats["topn_host"]` show the path.

Within the card's memory governor (MeshManager, parallel/serve.py): a
Count whose plan signature is quarantined, or one of whose views would
alone pass the HBM budget, goes straight to the host fold
(`_route_to_host`, counted in the manager's `routed_host` and
`fallback_<reason>`; these come before the cost reasons), and a
DeviceResourceError from the manager (the
same causes found later, or out of memory after its evict-and-retry
ladder) sends that one Count, aggregate or TopN to the host path. Any
other device error propagates. `explain()` reports a Count's route and
why, its plan signature and quarantine, its views' formats and what
staging them would take, without running it.

Shadow verification (`shadow_sample` = N > 0; 0, the default, is off):
every Nth card answer of a Count, a TopN or a Sum / Min / Max is
recomputed by the host fold and compared (`_shadow_check_*`,
SHADOW_STATS `checks:<backend>` / `mismatch:<backend>`, backend `mesh`
or `bsi`). On a mismatch the host value is served and logged, and a
Count's plan signature is quarantined (MeshManager.quarantine_plan), so
the same shape folds on the host until the quarantine's TTL: the second
cause of a quarantine, after memory. A TopN is checked by recounting
the ids the card returned; TopN and the aggregates count per-row planes
keyed by view, not by one plan signature, so their mismatch quarantines
nothing (as in the JAX package).

A write that lands between the card's answer and the host fold makes
the two read different data, and under concurrent writes that alone
made a check report a mismatch (and quarantine a sound plan), in the
JAX package too. So when a Count's or a TopN's two answers differ and
some write landed since the card counted (MUTATION_EPOCH moved), both
are counted again over a state that no write to the rows they read
moved meanwhile (the fragments' generations and mutation logs,
`_settle`), and only a difference there is a mismatch; with no write
since, the first pair decides. A check that finds no such state in
SHADOW_TRIES attempts is `raced:mesh`: the card's answer stands, as any
answer of a query that overlapped writes may.

Observability (the JAX executor's seams): every Count and Sum / Min /
Max records its route, tier and latency (`_record_route`), with the
active trace's id as the latency histogram's exemplar, one row of the
query-shape flight recorder (`flight`, keyed by `_shape_sig`) and the
cost ledger's per-call tap (obs.costs.observe_route). `execute` takes
an ExecOptions whose `deadline` is checked before each call and caps a
write's backpressure wait; its setup and each Count's lowering are the
profile's `plan` phase, a host fold its `host_fold` phase, and the
manager's staging and launches add `stage_h2d`, `device_exec` and
`readback_d2h`. `estimate_service_us` and `burst_hint` are the query
scheduler's hooks (sched/).

The host folds (parallel/plan.py, the JAX package's): a lowerable Count
on the host-fold route (quarantined, hbm_infeasible, a
DeviceResourceError, or a view that cannot stage), every shadow check
and its recounts run HostCountPlan, which folds dense word blocks with
the C++ kernels of ops.native and memoizes per-slice counts against the
fragments' generations in the executor's HostQueryCache
(`host_cache_stats`); a Count that does not lower folds roaring Rows
(route "roaring"). A root Intersect / Union / Difference / Range that
lowers with more than one leaf materializes through HostMaterializePlan
(the leaves folded once, only the result built as roaring); a single
leaf, and any tree that does not lower, materializes roaring rows per
slice (a time Range ORs the row over the views that cover [start,
end)). A root Bitmap result carries the row's attrs (or the column's,
for a column Bitmap). SetBit (with an optional timestamp) / ClearBit /
SetValue write through the frame; SetRowAttrs / SetColumnAttrs through
the attribute stores.

The HTTP cluster (the JAX executor's mapReduce, pilosa_tpu/executor.py:
2582-2923, with static membership): with a `cluster` of more than one
node, a call execute() runs is split by owner (`_slices_by_node`: each
slice's preferred_owner, UP with a closed breaker first, under one
breaker snapshot a query). This node's share runs here, through the
card path above as one call over the share's slices (one MeshManager
call: K1-K4 for a Count, K5 for TopN and the BSI planes); every other
owner's share goes out as a remote leg (`client.execute_query(node,
index, pql, slices, True)`, the `fanout_remote` phase), which serves
only its slices and writes only locally and never fans out again. The
answers fold here: Counts add, rows merge (a root Bitmap's attrs are
this node's), Sums add and extremes keep the winner, TopN runs the
reference's two phases (each owner's top pairs over its slices, then an
exact recount of the candidate ids). A leg's transient failure
(`transient` True, or an unannotated error that is no QueryError)
re-splits its slices over the other owners (`resplit` in `stats`); any
other error fails the query; with `partial` a slice no owner can serve
is listed in `missing_slices`. SetBit, ClearBit and SetValue go to every
owner of their slice (`_execute_mutate_view`) and ack at
write-consistency (`required_acks`), the misses journaled as hints when
a HintManager is wired (CONSISTENCY_STATS keeps the outcomes); the attr
calls apply here and go to every other node (`_broadcast_with_hints`).
The route of a fanned-out Count or aggregate is recorded once, here,
with tier `http`.

Replica convergence's read path (the JAX executor's, pilosa_tpu/
executor.py:319-335, 678-836, 2382-2485, 2682-2730): `epochs` (parallel.
epochs.EpochTracker) learns the epochs of every write applied here, a
coordinated one or a remote leg's (`_observe_write_epochs`, whose map a
missed owner's hint carries), and each peer's digest (the server's
status poll). A query with `staleness` > 0 (X-Pilosa-Staleness, else
[cluster] default-read-staleness) is a bounded read: each slice may go
to any owner that is UP, behind a closed breaker and within the bound by
the tracker (pick_read_replica, this node first, else the shallower
queue of two), and falls back to the strict pick otherwise; `read_stats`
counts the picks as "owner|follower|fallback_owner" x "strict|bounded"
(pilosa_read_replica_total). A bounded Count that fans out is served
from `result_cache` (parallel.epochs.ResultCache) when an entry of its
(index, PQL, slices) holds the tracker's epoch token over the slices
(the sum of their known epochs, where the JAX executor takes the
highest, which a write to a lower slice does not move), read before the
count, so a write seen meanwhile stores under a stale key; every
`result_cache_verify_1_in`-th hit is counted again and compared
(SHADOW_STATS `checks:result-cache` / `mismatch:result-cache`, a
mismatch drops the entry). A strict read never consults the cache
(counted `bypass`); a remote leg neither spreads nor caches.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import Counter
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, List, Optional, Sequence

import numpy as np

from . import SLICE_WIDTH, resolve_device
from .bsi import host as bsi_host
from .bsi import lower as bsi_lower
from .bsi.field import ROW_PLANE0, ROW_SIGN, FieldNotFoundError
from .core.cache import add_to_pairs, sort_pairs
from .core.fragment import MUTATION_EPOCH, TopOptions
from .core.index import DEFAULT_COLUMN_LABEL
from .core.row import Row
from .core.timequantum import parse_time, views_by_time_range
from .core.view import VIEW_INVERSE, VIEW_STANDARD
from .errors import BroadcastError, DeadlineExceededError, \
    DeviceResourceError, FrameNotFoundError, IndexNotFoundError, \
    IndexRequiredError, QueryError, SliceUnavailableError, \
    WriteConsistencyError
from .parallel.cluster import (NODE_STATE_DOWN, SERVING_STATES, owner_tier,
                               pick_read_replica, preferred_owner)
from .parallel.epochs import EpochTracker, ResultCache, fragment_key
from .parallel.mesh import (DEFAULT_SPARSE_DENSITY_THRESHOLD, SliceSpace,
                            format_pool_bytes)
from .parallel.plan import (DEFAULT_FRAME, HostCountPlan,
                            HostMaterializePlan, HostQueryCache, _lower_tree,
                            _tree_signature, canonical_tree, plan_signature)
from .parallel.serve import mesh_config as mesh_config_check
from .parallel.serve import sparse_shape_kind, view_stats
from .ops.bsi import sum_from_plane_dicts
from .pql import Call, Cond, Query
from . import fault, obs
from .obs.flight import FlightRecorder
from .obs.metrics import Histogram, StatMap

_BINOPS = {"Intersect": "intersect", "Union": "union",
           "Difference": "difference"}
_BSI_AGGREGATES = ("Sum", "Min", "Max")
# Root calls whose result folds on the host through HostMaterializePlan
# when they lower with more than one leaf.
_MATERIALIZED = ("Intersect", "Union", "Difference", "Range")
_WRITE_CALLS = ("ClearBit", "SetBit", "SetValue", "SetRowAttrs",
                "SetColumnAttrs")

# The host TopN's threshold when none is given (the card path's
# rank_pairs keeps no row under one bit either).
MIN_THRESHOLD = 1

# Cost routing's environment (the JAX package's PILOSA_TPU_* twins).
MIN_WORK_ENV = "PILOSA_TORCH_DEVICE_MIN_WORK"
CPU_ROUTE_ENV = "PILOSA_TORCH_CPU_ROUTE_NATIVE"
USE_DEVICE_ENV = "PILOSA_TORCH_USE_DEVICE"

# Shadow verification: "checks:<backend>" / "mismatch:<backend>".
SHADOW_STATS = StatMap()
# Replicated writes' outcomes, "<level>:<outcome>" (/metrics
# pilosa_write_consistency_total): ok (every owner acked), hinted (the
# level reached, the misses journaled), below_consistency (503 after the
# dispatch), rejected_unavailable (503 before any replica applied it).
CONSISTENCY_STATS = StatMap()
# Attempts of a shadow check to count card and host over one state of
# the rows it reads, when writes keep landing between the two (_settle).
SHADOW_TRIES = 3
# Remote legs and replica writes in flight at once (the JAX executor's
# max_workers).
FANOUT_WORKERS = 8

_log = logging.getLogger("pilosa_tpu_torch.executor")


def _call_shape(c) -> str:
    """Structural fingerprint of a Call tree, names and frame arguments
    with row and column ids elided: `Count(Intersect(Bitmap[f],
    Bitmap[f]))`. The flight recorder's and the cost ledger's shape key
    (one entry a query shape, not a query)."""
    frame = c.args.get("frame")
    label = f"{c.name}[{frame}]" if isinstance(frame, str) else c.name
    if c.children:
        return (label + "("
                + ",".join(_call_shape(k) for k in c.children) + ")")
    return label


def required_acks(level: str, owners: int) -> int:
    """The replica acks (the local apply among them) a write needs
    before it is acked."""
    if level == "one":
        return 1
    if level == "all":
        return owners
    return owners // 2 + 1  # quorum


class ExecOptions:
    """Per-execute context. `deadline`: the time.monotonic() instant by
    which the whole query must finish (None: none); execute checks it
    before each call, a write's backpressure wait ends at it, and a
    remote leg gets what is left of it. `remote`: this is a remote leg
    (it serves and writes only here and fans out no further). `partial`:
    a slice no owner can serve is left out and listed in
    `missing_slices` instead of failing the query. Set while it runs:
    `used_http` (a leg went over HTTP: the route's tier) and
    `breaker_snapshot` (the breakers' states, read once a query, so a
    re-split sees what the first split saw). `staleness`: the read's
    bound in seconds; > 0 lets a slice go to an in-sync replica and a
    Count come from the result cache, 0 (the default) is a strict
    read."""

    __slots__ = ("deadline", "remote", "partial", "missing_slices",
                 "used_http", "breaker_snapshot", "staleness")

    def __init__(self, remote: bool = False,
                 deadline: Optional[float] = None, partial: bool = False,
                 staleness: float = 0.0):
        self.staleness = max(0.0, float(staleness))
        self.deadline = deadline
        self.remote = remote
        self.partial = partial
        self.missing_slices: List[int] = []
        self.used_http = False
        self.breaker_snapshot: Optional[dict] = None

    def deadline_left(self) -> Optional[float]:
        """Seconds left (negative once expired), None without one."""
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def check_deadline(self, what: str = "query") -> None:
        left = self.deadline_left()
        if left is not None and left <= 0:
            raise DeadlineExceededError(
                f"{what}: deadline exceeded by {-left * 1e6:.0f}us")


class Executor:
    """Evaluates PQL against a Holder; device work runs on `device`.
    sparse_density_threshold: mean container fill under which a slice
    stages as sorted arrays (<= 0 stages everything dense). mesh_config:
    the manager's [mesh] knobs (parallel.serve.MESH_DEFAULTS).
    shadow_sample: check 1 in N card answers on the host (0: off).
    device_min_work: cost routing's threshold in slices x leaves (None:
    $PILOSA_TORCH_DEVICE_MIN_WORK, else _DEFAULT_MIN_WORK; <= 0: off)."""

    # Off unless asked for. The JAX package's default, 192
    # (pilosa_tpu/executor.py:1888), was tuned on its own device. On the
    # card a cold host fold is no faster than the kernels at any size
    # chip_smoke's engine phase sweeps, and a warm one wins only at small
    # sizes (PERF.md), so a default waits for a benchmark that measures
    # how often the fold's caches are warm.
    _DEFAULT_MIN_WORK = 0

    def __init__(self, holder, device="cuda",
                 sparse_density_threshold: float =
                 DEFAULT_SPARSE_DENSITY_THRESHOLD,
                 mesh_config: Optional[dict] = None,
                 shadow_sample: int = 0,
                 device_min_work: Optional[int] = None,
                 host: str = "", cluster=None, client=None):
        self.holder = holder
        # The cluster (parallel.cluster.Cluster; None or one node: every
        # slice is served here), this node's host in it, and the client
        # seam of remote legs: execute_query(node, index, pql, slices,
        # remote=True[, deadline=]) -> results (api.client.ClusterClient,
        # or a test's fake), with breaker_state(host) when it has
        # breakers.
        self.host = host
        self.cluster = cluster
        self.client = client
        # [cluster] prefer-local-reads: a slice this node holds a replica
        # of is served here, not by the ring's primary.
        self.prefer_local_reads = False
        # [cluster] write-consistency, and the hinted handoff
        # (parallel.hints.HintManager) a Server wires; without it a
        # remote owner's failure fails the write.
        self.write_consistency = "quorum"
        self.hints = None
        # The legs' pool; this node's share runs in the caller's thread,
        # so no task of the pool waits on another of it.
        self._pool = ThreadPoolExecutor(max_workers=FANOUT_WORKERS,
                                        thread_name_prefix="fanout")
        # (index, num, placement) -> the SliceSpace of the slices this
        # node owns (_num_slices).
        self._spaces: dict = {}
        self.device_min_work = device_min_work
        # Resolved once, at the first routing decision.
        self._min_work_resolved: Optional[int] = None
        self._cpu_route_native: Optional[bool] = None
        self.shadow_sample = int(shadow_sample)
        self._shadow_counter = itertools.count()
        self.device = resolve_device(device)
        self.sparse_density_threshold = sparse_density_threshold
        mesh_config_check(mesh_config)  # a bad knob fails here, not later
        self.mesh_config = dict(mesh_config or {})
        self._mesh_mgr = None
        self._mesh_mu = threading.Lock()
        self._stats_mu = threading.Lock()
        self.stats: Counter = Counter()
        # Route telemetry of every Count and Sum / Min / Max (the JAX
        # executor's): which engine served it ("mesh" = the card,
        # "host-fold" = a lowerable tree folded on the host, "roaring" =
        # a tree that does not lower, "bsi-mesh" / "bsi-host"), by
        # locality tier ("route|tier"; always "local" on one card), and
        # its latency in a log2 histogram a route. /metrics reads them.
        self.route_stats = StatMap()
        self.tier_stats = StatMap()
        self._route_hists: dict = {}
        # Query shapes behind GET /debug/queryshapes ([obs]
        # queryshape-ring sets its ring).
        self.flight = FlightRecorder()
        # The host folds' caches (blocks, per-slice counts, matrices).
        self._host_cache = HostQueryCache()
        # Replica convergence's read path (module docstring): the epochs
        # known, the epoch-keyed result cache ([cluster]
        # result-cache-size sets its cap), the share of its hits counted
        # again ([integrity] result-cache-verify-1-in; 0: none) and the
        # replica picks.
        self.epochs = EpochTracker()
        self.result_cache = ResultCache()
        self.result_cache_verify_1_in = 16
        self._rc_verify_counter = itertools.count(1)
        self.read_stats = StatMap()

    def _inc(self, key: str) -> None:
        with self._stats_mu:
            self.stats[key] += 1

    @property
    def device_stats(self):
        """The card manager's counters, or None before a query built it
        (never forces construction)."""
        mgr = self._mesh_mgr
        return mgr.stats if mgr is not None else None

    def _record_route(self, route: str, t0: float, tier: str = "local",
                      call=None, staged_bytes: int = 0,
                      shadow_checked: bool = False,
                      shadow_mismatch: bool = False):
        """Count one served query under `route` and `tier`, and its
        latency since `t0` (time.monotonic()): one clock read, no device
        sync. With a trace active its id is the latency's exemplar (so
        /metrics?exemplars=true links a slow bucket to /debug/traces/
        <id>); with `call`, one flight-recorder row of its shape and the
        cost ledger's tap (staged bytes and the op count into the
        ambient (tenant, shape) account, and the baseline watch)."""
        self.route_stats.inc(f"count_{route}")
        self.tier_stats.inc(f"{route}|{tier}")
        h = self._route_hists.get(route)
        if h is None:
            h = self._route_hists.setdefault(route, Histogram())
        lat_us = (time.monotonic() - t0) * 1e6
        trace = getattr(obs.current_span(), "trace", None)
        h.observe(lat_us, exemplar=getattr(trace, "trace_id", None))
        if call is not None:
            sig = self._shape_sig(call)
            self.flight.record(sig, route, tier, lat_us,
                               staged_bytes=staged_bytes,
                               shadow_checked=shadow_checked,
                               shadow_mismatch=shadow_mismatch,
                               example=lambda: str(call))
            obs.costs.observe_route(sig, route, tier, lat_us,
                                    staged_bytes=staged_bytes)

    @staticmethod
    def _shape_sig(c) -> str:
        """_call_shape of `c`, memoized on the Call (immutable after
        parse)."""
        sig = c.__dict__.get("_shape_sig")
        if sig is None:
            try:
                sig = _call_shape(c)
            except Exception:  # noqa: BLE001 — telemetry never raises
                sig = c.name
            c.__dict__["_shape_sig"] = sig
        return sig

    def _h2d_bytes(self) -> int:
        """The manager's cumulative staged bytes (0 without one): a
        delta over a call attributes its staging to it (approximate
        under concurrency)."""
        mgr = self._mesh_mgr
        return int(mgr.stats.get("h2d_bytes", 0)) if mgr is not None else 0

    def estimate_service_us(self) -> Optional[float]:
        """The scheduler's service-time estimate: p95 of the busiest
        route's latency (us), None before 4 of them were measured."""
        best, best_n = None, 0
        for h in list(self._route_hists.values()):
            if h.total > best_n:
                best, best_n = h, h.total
        if best is None or best_n < 4:
            return None
        return best.percentile(0.95)

    def burst_hint(self, n: int) -> None:
        """The scheduler's cohort hint: n queries were released together,
        so the manager's batch loop holds its drain window open for them
        (MeshManager.expect_burst). Nothing before the manager exists: a
        hint never builds it."""
        mgr = self._mesh_mgr
        if mgr is not None and n > 1:
            mgr.expect_burst(n)

    @property
    def route_latency_hists(self) -> dict:
        """route -> Histogram of its latencies (us), for /metrics."""
        return dict(self._route_hists)

    def mesh_manager(self):
        with self._mesh_mu:
            if self._mesh_mgr is None:
                from .parallel.serve import MeshManager

                self._mesh_mgr = MeshManager(
                    self.holder, self.device,
                    sparse_density_threshold=self.sparse_density_threshold,
                    config=self.mesh_config)
            return self._mesh_mgr

    def invalidate_device_index(self, index: Optional[str] = None) -> None:
        """Drop the staged views of `index` (or all) and free their card
        memory now: the handler calls it when an index or frame is
        deleted. A later query restages from the holder."""
        if self._mesh_mgr is not None:
            self._mesh_mgr.invalidate(index)

    def execute(self, index: str, q: Query,
                slices: Optional[Sequence[int]] = None,
                opt: Optional[ExecOptions] = None) -> list:
        """Execute each call in order; one result per call. With `slices`
        given, a Bitmap is taken as a column Bitmap when it names the
        default column label ("columnID"), and it then reads no slice;
        without them, by the index's own label over the inverse view's
        slices (as the JAX package does). `opt`: its deadline is checked
        before each call (DeadlineExceededError) and caps a write's
        backpressure wait."""
        if not index:
            raise IndexRequiredError()
        with obs.profile.phase("plan"):
            opt = opt or ExecOptions()
            if opt.breaker_snapshot is None and self._clustered():
                state = getattr(self.client, "breaker_state", None)
                if callable(state):
                    opt.breaker_snapshot = {n.host: state(n.host)
                                            for n in self.cluster.nodes}
            idx = self.holder.index(index)
            need = any(c.name not in _WRITE_CALLS for c in q.calls)
            column_label = DEFAULT_COLUMN_LABEL
            defaulted = False
            if slices:
                slices = list(slices)
            else:
                slices = []
                if need:
                    if idx is None:
                        raise IndexNotFoundError()
                    defaulted = True
                    slices = list(range(idx.max_slice() + 1))
                    column_label = idx.column_label
        if q.calls and all(c.name == "SetRowAttrs" for c in q.calls):
            return self._execute_bulk_set_row_attrs(index, q.calls, opt)
        results = []
        cost_ctx = obs.costs.current()
        for call in q.calls:
            opt.check_deadline(call.name)
            if cost_ctx is not None:
                # Before it runs: its staging's residency and WAL bytes
                # charge the (tenant, shape) account of this call.
                cost_ctx.shape = self._shape_sig(call)
            call_slices = slices
            if call.name == "Bitmap" and need:
                f = self.holder.frame(index,
                                      call.args.get("frame") or DEFAULT_FRAME)
                if f is None:
                    raise FrameNotFoundError()
                if call.is_inverse(f.row_label, column_label):
                    call_slices = (list(range(idx.max_inverse_slice() + 1))
                                   if defaulted else [])
            results.append(self._execute_call(index, call, call_slices,
                                              opt))
        return results

    def _execute_call(self, index: str, c: Call, slices: List[int],
                      opt: ExecOptions):
        deadline = opt.deadline
        if c.name == "Count":
            return self._execute_count(index, c, slices, opt)
        if c.name == "SetBit":
            f, row_id, col_id = self._bit_args(index, c)
            ts = c.args.get("timestamp")
            t = None
            if isinstance(ts, str):
                try:
                    t = parse_time(ts)
                except ValueError:
                    raise QueryError(f"invalid date: {ts}") from None
            return self._execute_mutate_view(
                index, c, opt, col_id,
                lambda: f.set_bit(row_id, col_id, t, deadline=deadline))
        if c.name == "ClearBit":
            f, row_id, col_id = self._bit_args(index, c)
            return self._execute_mutate_view(
                index, c, opt, col_id,
                lambda: f.clear_bit(row_id, col_id, deadline=deadline))
        if c.name == "SetValue":
            f, fname, col_id, value = self._set_value_args(index, c)
            return self._execute_mutate_view(
                index, c, opt, col_id,
                lambda: f.set_value(fname, col_id, value, deadline=deadline))
        if c.name in _BSI_AGGREGATES:
            return self._execute_bsi_aggregate(index, c, slices, opt)
        if c.name == "TopN":
            return self._execute_top_n(index, c, slices, opt)
        if c.name == "SetRowAttrs":
            return self._execute_bulk_set_row_attrs(index, [c], opt)[0]
        if c.name == "SetColumnAttrs":
            return self._execute_set_column_attrs(index, c, opt)
        if self._fans_out(opt):
            row = self._map_reduce(
                index, c, slices, opt,
                lambda sl: self._bitmap_call(index, c, sl),
                _merge_rows) or Row()
        else:
            row = self._bitmap_call(index, c, slices)
        if c.name == "Bitmap":
            row.attrs = self._bitmap_attrs(index, c)
        return row

    def _bitmap_call(self, index: str, c: Call, slices: List[int]) -> Row:
        """A bitmap call's row over `slices`, here (no attrs)."""
        if c.name in _MATERIALIZED:
            leaves: list = []
            shape = _lower_tree(self.holder, index, c, leaves)
            if shape is not None and len(leaves) > 1:
                return HostMaterializePlan(
                    self.holder, index, shape, leaves,
                    cache=self._host_cache).materialize_row(slices)
        row = Row()
        for s in slices:
            row.merge(self._bitmap_slice(index, c, s))
        return row

    def _bitmap_attrs(self, index: str, c: Call) -> dict:
        """The attrs of a root Bitmap: the column's when it names the
        index's column label, else the row's."""
        idx = self.holder.index(index)
        if idx is None:
            return {}
        col_id, col_ok = c.uint_arg(idx.column_label)
        if col_ok:
            return idx.column_attr_store.attrs(col_id)
        f = idx.frame(c.args.get("frame") or DEFAULT_FRAME)
        if f is None:
            return {}
        row_id, _ = c.uint_arg(f.row_label)
        return f.row_attr_store.attrs(row_id)

    # -- bitmap calls (host) -------------------------------------------------

    def _bitmap_slice(self, index: str, c: Call, slice_: int) -> Row:
        if c.name == "Bitmap":
            return self._bitmap_leaf_slice(index, c, slice_)
        if c.name == "Range":
            return self._range_slice(index, c, slice_)
        op = _BINOPS.get(c.name)
        if op is None:
            raise QueryError(f"unknown call: {c.name}")
        if not c.children:
            if op == "union":
                return Row()
            raise QueryError(
                f"empty {c.name} query is currently not supported")
        out = None
        for child in c.children:
            row = self._bitmap_slice(index, child, slice_)
            out = row if out is None else getattr(out, op)(row)
        return out

    def _bitmap_leaf_slice(self, index: str, c: Call, slice_: int) -> Row:
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        frame = c.args.get("frame") or DEFAULT_FRAME
        f = idx.frame(frame)
        if f is None:
            raise FrameNotFoundError()
        row_id, row_ok = c.uint_arg(f.row_label)
        col_id, col_ok = c.uint_arg(idx.column_label)
        if row_ok and col_ok:
            raise QueryError(f"Bitmap() cannot specify both {f.row_label} "
                             f"and {idx.column_label} values")
        if not row_ok and not col_ok:
            raise QueryError(f"Bitmap() must specify either {f.row_label} "
                             f"or {idx.column_label} values")
        view, id_ = VIEW_STANDARD, row_id
        if col_ok:
            if not f.inverse_enabled:
                raise QueryError("Bitmap() cannot retrieve columns unless "
                                 "inverse storage enabled")
            view, id_ = VIEW_INVERSE, col_id
        frag = self.holder.fragment(index, frame, view, slice_)
        return frag.row(id_) if frag is not None else Row()

    def _range_slice(self, index: str, c: Call, slice_: int) -> Row:
        """Range over one slice: with a field comparison (frame=f,
        field <op> N) the plane ladder folded over the field's bsi
        fragment; else the time Range (frame=f, rowID=r, start=...,
        end=...), the row ORed over the views that cover [start, end),
        empty when the frame has no time quantum."""
        frame = c.args.get("frame") or DEFAULT_FRAME
        f = self.holder.frame(index, frame)
        if f is None:
            raise FrameNotFoundError()
        conds = [k for k, v in c.args.items() if isinstance(v, Cond)]
        if len(conds) > 1:
            raise QueryError(f"{c.name}() accepts one field comparison, "
                             f"got {len(conds)}")
        if conds:
            fname, cond = conds[0], c.args[conds[0]]
            schema = f.bsi_field(fname)
            if schema is None:
                raise FieldNotFoundError(frame, fname)
            frag = self.holder.fragment(index, frame, schema.view, slice_)
            return bsi_host.range_row(frag, schema, cond.op, cond.value)
        row_id, _ = c.uint_arg(f.row_label)
        start, end = c.args.get("start"), c.args.get("end")
        if not isinstance(start, str):
            raise QueryError("Range() start time required")
        if not isinstance(end, str):
            raise QueryError("Range() end time required")
        try:
            start_t, end_t = parse_time(start), parse_time(end)
        except ValueError:
            raise QueryError("cannot parse Range() time") from None
        q = f.time_quantum
        if not str(q):
            return Row()
        out = Row()
        for vname in views_by_time_range(VIEW_STANDARD, start_t, end_t, q):
            frag = self.holder.fragment(index, frame, vname, slice_)
            if frag is not None:
                out = out.union(frag.row(row_id))
        return out

    # -- count ---------------------------------------------------------------

    def _execute_count(self, index: str, c: Call, slices: List[int],
                       opt: Optional[ExecOptions] = None) -> int:
        if not c.children:
            raise QueryError("Count() requires an input bitmap")
        if len(c.children) > 1:
            raise QueryError("Count() only accepts a single bitmap input")
        t0 = time.monotonic()
        h2d0 = self._h2d_bytes()
        rc_key = rc_epoch = rc_verify = None
        if self._fans_out(opt):
            rc = self.result_cache
            if opt.staleness <= 0:
                rc.bypass()
            else:
                # The PQL's canonical text names the plan; the epoch
                # token is read before the count.
                rc_key = (index, str(c), tuple(slices))
                rc_epoch = self.epochs.epoch_token(index, slices)
                cached = rc.get(rc_key, rc_epoch)
                if cached is not None:
                    v1 = self.result_cache_verify_1_in
                    if v1 and next(self._rc_verify_counter) % v1 == 0:
                        rc_verify = cached
                    else:
                        self._record_route("result-cache", t0,
                                           tier=_query_tier(opt), call=c)
                        return cached
            here: dict = {}

            def local(sl):
                n, here["route"], here["check"] = self._count_here(
                    index, c, sl)
                return n

            n = self._map_reduce(index, c, slices, opt, local,
                                 _add_counts) or 0
            route = here.get("route")
            if route is None:  # every slice went to another node
                route = ("roaring" if _lower_tree(
                    self.holder, index, c.children[0], []) is None
                    else "mesh")
            checked, mismatch = here.get("check", (False, False))
        else:
            n, route, (checked, mismatch) = self._count_here(index, c,
                                                             slices)
        if rc_verify is not None:
            SHADOW_STATS.inc("checks:result-cache")
            if int(rc_verify) != n:
                SHADOW_STATS.inc("mismatch:result-cache")
                self.result_cache.invalidate(rc_key)
        elif rc_key is not None:
            self.result_cache.put(rc_key, rc_epoch, n)
        self._record_route(route, t0, tier=_query_tier(opt), call=c,
                           staged_bytes=max(0, self._h2d_bytes() - h2d0),
                           shadow_checked=checked, shadow_mismatch=mismatch)
        return n

    def _count_here(self, index: str, c: Call, slices: List[int]):
        """(count, route, (shadow checked, mismatch)) of a Count over
        `slices`, on this node's card or host."""
        child = c.children[0]
        leaves: list = []
        with obs.span("plan", call="Count", slices=len(slices)) as psp, \
                obs.profile.phase("plan"):
            shape = _lower_tree(self.holder, index, child, leaves)
            routed = None
            if shape is not None and slices:
                num = self._num_slices(index, slices)
                sig = plan_signature(shape)
                routed = self._route_to_host(
                    len(slices), len(leaves), index=index, leaves=leaves,
                    num_slices=num, sig=sig)
            psp.tag(route="roaring" if shape is None else
                    "host-fold" if not slices or routed else "mesh")
            if routed:
                psp.tag(route_reason=routed)
            switches = self._kill_switches()
            if switches:
                psp.tag(kill_switches=switches)
        if shape is not None and slices and not routed:
            epoch = MUTATION_EPOCH.n  # before the count: _settle's witness
            n = self._on_card(self.mesh_manager().count, index, shape,
                              leaves, slices, num, sig)
            if n is not None:
                self._inc("count_device")
                checked = mismatch = False
                if self._shadow_sampled():
                    checked = True
                    m = self._shadow_check_count(
                        index, child, slices, n, sig, (shape, leaves), epoch,
                        lambda: self._on_card(
                            self.mesh_manager().count, index, shape,
                            leaves, slices, num, sig))
                    mismatch, n = m != n, m
                return n, "mesh", (checked, mismatch)
        self._inc("count_host")
        n = self._count_host(index, child, slices,
                             (shape, leaves) if shape is not None else None)
        return (n, "host-fold" if shape is not None else "roaring",
                (False, False))

    def _count_host(self, index: str, child: Call, slices: List[int],
                    lowered: Optional[tuple] = None) -> int:
        """The host's Count of `child` over `slices`: HostCountPlan over
        the lowered tree (`lowered` = (shape, leaves) from _lower_tree,
        lowered here when None) through the executor's HostQueryCache,
        or the Row fold when the tree does not lower. Every host Count
        comes here: the host-fold route, the shadow checks and their
        recounts (_settle)."""
        if lowered is None:
            leaves: list = []
            shape = _lower_tree(self.holder, index, child, leaves)
            if shape is not None:
                lowered = (shape, leaves)
        if lowered is not None:
            return HostCountPlan(self.holder, index, *lowered,
                                 cache=self._host_cache).count_slices(slices)
        with obs.span("host_fold", slices=len(slices)), \
                obs.profile.phase("host_fold"):
            return sum(self._bitmap_slice(index, child, s).count()
                       for s in slices)

    @property
    def host_cache_stats(self) -> dict:
        """The host folds' cache counters (HostQueryCache.stats): /debug/
        vars `host_cache` and the pilosa_host_cache_* families."""
        return self._host_cache.stats

    # -- shadow verification ---------------------------------------------------

    def _shadow_sampled(self) -> bool:
        """True on every Nth call when shadow_sample = N > 0."""
        n = self.shadow_sample
        return n > 0 and next(self._shadow_counter) % n == 0

    def _shadow_mismatch(self, backend: str, what: str, device, host,
                         index: str, slices) -> None:
        SHADOW_STATS.inc(f"mismatch:{backend}")
        _log.error("shadow verification MISMATCH (%s %s): device=%s "
                   "host=%s index=%s slices=%d; serving the host value",
                   backend, what, device, host, index, len(slices))

    def _shadow_check_count(self, index: str, child: Call, slices,
                            device_n: int, sig: str, lowered: tuple,
                            epoch: int, recount) -> int:
        """A card Count against the host fold of the same tree
        (HostCountPlan over `lowered`, its (shape, leaves)). On a
        mismatch: the host value, and the plan signature quarantined,
        so a plan that miscomputes stops serving. `epoch`
        (MUTATION_EPOCH.n before the card counted) and `recount()` (the
        card's count again; None: it could not) are _settle's."""
        SHADOW_STATS.inc("checks:mesh")
        host_n = self._count_host(index, child, slices, lowered)
        if host_n == int(device_n) or MUTATION_EPOCH.n == epoch:
            return self._shadow_verdict_count(index, slices, device_n,
                                              host_n, sig)
        rows: dict = {}
        for frame, view, row, _q in lowered[1]:
            rows.setdefault((frame, view), set()).add(int(row))
        settled = self._settle(
            index, rows, slices, recount,
            lambda _n: self._count_host(index, child, slices, lowered))
        if settled is None:
            return device_n
        return self._shadow_verdict_count(index, slices, *settled, sig)

    def _shadow_verdict_count(self, index: str, slices, device_n: int,
                              host_n: int, sig: str) -> int:
        """A Count's answers over one state: equal, or a mismatch."""
        if host_n == int(device_n):
            return device_n
        self._shadow_mismatch("mesh", "Count", device_n, host_n, index,
                              slices)
        self.mesh_manager().quarantine_plan(sig)
        return host_n

    def _shadow_check_top_n(self, index: str, c: Call, slices, pairs,
                            epoch: int):
        """A card TopN against the host's exact recount of the ids it
        returned (Fragment.top with ids, with the same src child; no
        threshold, which the host applies per slice). Returns the pairs,
        or None on a mismatch (the caller then serves the host TopN).
        `epoch`: MUTATION_EPOCH.n before the card counted (_settle)."""
        SHADOW_STATS.inc("checks:mesh")
        if not pairs:
            return pairs

        def host_of(pairs_):
            other = c.clone()
            other.args["ids"] = sorted(int(p[0]) for p in pairs_)
            for key in ("n", "threshold"):
                other.args.pop(key, None)
            return dict(self._top_n_host_slices(index, other, slices))

        def norm(pairs_):
            return {int(k): int(v) for k, v in pairs_}

        host = host_of(pairs)
        if host == norm(pairs):
            return pairs
        if MUTATION_EPOCH.n == epoch:
            self._shadow_mismatch("mesh", "TopN", dict(pairs), host,
                                  index, slices)
            return None
        # Any write to the frame or to the src's views may move a rank.
        rows = {(c.args.get("frame") or DEFAULT_FRAME, VIEW_STANDARD): None}
        if c.children:
            leaves: list = []
            if _lower_tree(self.holder, index, c.children[0],
                           leaves) is not None:
                rows.update(((f, v), None) for f, v, _r, _q in leaves)
        settled = self._settle(
            index, rows, slices,
            lambda: self._on_card(self._top_n_device, index, c, slices),
            lambda p: host_of(p) if p else {})
        if settled is None:
            return pairs
        pairs, host = settled
        if host == norm(pairs):
            return pairs
        self._shadow_mismatch("mesh", "TopN", dict(pairs), host,
                              index, slices)
        return None

    def _settle(self, index: str, rows: dict, slices, device_fn,
                host_fn):
        """(card answer, host answer) computed over one state of the rows
        they read, for a shadow check whose first pair differed while
        some write landed (MUTATION_EPOCH moved): `rows` maps (frame,
        view) to the row ids read there (None: any row). Each attempt
        takes the fragments' generations, asks device_fn() and then
        host_fn(card answer), and holds when no write since those
        generations touched one of the rows (the fragments' mutation
        logs). None, counted `raced:mesh`, when no attempt of
        SHADOW_TRIES held or the card could not count again."""
        for _ in range(SHADOW_TRIES):
            gens = {}
            for f, v in rows:
                for sl in slices:
                    frag = self.holder.fragment(index, f, v, sl)
                    gens[(f, v, sl)] = (frag, frag and frag.generation)
            device = device_fn()
            if device is None:
                break
            host = host_fn(device)
            if not self._written_since(index, gens, rows):
                return device, host
        SHADOW_STATS.inc("raced:mesh")
        return None

    def _written_since(self, index: str, gens: dict, rows: dict) -> bool:
        """Whether a write after `gens` ((frame, view, slice) ->
        (fragment, generation)) may have changed a row of `rows`."""
        for (f, v, sl), (frag, gen) in gens.items():
            now = self.holder.fragment(index, f, v, sl)
            if now is not frag:
                return True  # made, dropped or replaced meanwhile
            if frag is None or frag.generation == gen:
                continue
            entries = frag.log_since(gen)
            want = rows[(f, v)]
            if entries is None or want is None or any(
                    pos // SLICE_WIDTH in want for _op, pos, _c in entries):
                return True
        return False

    def _shadow_check_bsi(self, index: str, c: Call, frame, schema, child,
                          slices, device_out):
        """A card Sum / Min / Max against the host folds of bsi.host."""
        SHADOW_STATS.inc("checks:bsi")
        host_out = self._bsi_host(index, frame, schema, c, child, slices)
        if c.name == "Sum" and host_out is None:
            host_out = (0, 0)

        def norm(v):
            return None if v is None else (int(v[0]), int(v[1]))

        if norm(host_out) == norm(device_out):
            return device_out
        self._shadow_mismatch("bsi", c.name, device_out, host_out, index,
                              slices)
        return host_out

    @staticmethod
    def _on_card(fn, *args):
        """fn(*args), or None when the card cannot serve it for want of
        memory or for a quarantined plan (a DeviceResourceError, which
        the manager counted): the caller then answers on the host, out of
        this handler, so the error's traceback holds no card memory
        meanwhile."""
        try:
            return fn(*args)
        except DeviceResourceError:
            return None

    def explain(self, index: str, q: Query,
                slices: Optional[Sequence[int]] = None,
                staleness: float = 0.0) -> dict:
        """The planned execution of `q`, run nowhere: for each Count, its
        route ("mesh", "host-fold" with its `route_reason`, or "roaring"
        for a tree that does not lower), its `plan` {signature,
        quarantined}, the resident format of each leaf's view
        (`device_format`) and what staging the others would take
        (`staging`), and the cost model that routed it (`cost_model`,
        `kill_switches`); for Sum / Min / Max, the route, the field's
        planes and rows and the cost model. No view stages and no counter
        moves. In a cluster each call also has its `placement`
        (_explain_placement; a bounded read's, `staleness` > 0, with its
        `read` section) and a write its `consistency`. Serves POST
        /index/{index}/query?explain=true (the JAX package's
        Executor.explain, pilosa_tpu/executor.py:1366-1557, without the
        whole-query memo)."""
        if not index:
            raise IndexRequiredError()
        idx = self.holder.index(index)
        if slices:
            slices = list(slices)
        else:
            slices = []
            if any(c.name not in _WRITE_CALLS for c in q.calls):
                if idx is None:
                    raise IndexNotFoundError()
                slices = list(range(idx.max_slice() + 1))
        return {"index": index, "slices": len(slices),
                "calls": [self._explain_call(index, c, slices, staleness)
                          for c in q.calls]}

    def _explain_call(self, index: str, c: Call, slices: List[int],
                      staleness: float = 0.0) -> dict:
        info: dict = {"call": c.name}
        if self._clustered():
            info["placement"] = self._explain_placement(index, slices,
                                                        staleness)
        if c.name in _WRITE_CALLS:
            info["route"] = "write"
            if self._clustered():
                owners = self.cluster.replica_n
                info["consistency"] = {
                    "level": self.write_consistency, "replicas": owners,
                    "required_acks": required_acks(self.write_consistency,
                                                   owners),
                    "hinted_handoff": self.hints is not None}
            return info
        if c.name in _BSI_AGGREGATES and slices:
            return self._explain_bsi_aggregate(index, c, slices, info)
        if c.name != "Count" or len(c.children) != 1 or not slices:
            return info
        leaves: list = []
        shape = _lower_tree(self.holder, index, c.children[0], leaves)
        lowerable = shape is not None and bool(leaves)
        info["cost_model"] = self._cost_model(lowerable, len(leaves),
                                              len(slices))
        info["kill_switches"] = self._kill_switches()
        if not lowerable:
            info["route"] = "roaring"
            return info
        sig = plan_signature(shape)
        num = self._num_slices(index, slices)
        reason = self._would_route_to_host(len(slices), len(leaves), index,
                                           leaves, num, sig)
        info["route"] = "host-fold" if reason else "mesh"
        if reason:
            info["route_reason"] = reason
        mgr = self._mesh_mgr
        info["plan"] = {"signature": sig, "quarantined":
                        mgr is not None and mgr.plan_quarantined(sig)}
        keys = list(dict.fromkeys((f, v) for f, v, _r, _q in leaves))
        resident = (dict(zip(keys, mgr.describe_views(index, keys)))
                    if mgr is not None else dict.fromkeys(keys))
        if mgr is not None:
            info["device_format"] = self._explain_format(leaves, shape,
                                                         resident)
        info["staging"] = self._explain_staging(index, keys, num, resident)
        return info

    def _explain_bsi_aggregate(self, index: str, c: Call, slices, info):
        """A Sum / Min / Max's planned route ("bsi-mesh", or "bsi-host"
        with its reason), its field's planes and rows and the cost model
        (pilosa_tpu/executor.py:1512-1560); a call that cannot run
        reports its error instead."""
        try:
            _frame, schema = self._bsi_call_schema(index, c)
        except (IndexNotFoundError, FrameNotFoundError, FieldNotFoundError,
                QueryError) as err:
            info["route"] = "error"
            info["error"] = str(err) or type(err).__name__
            return info
        reason = self._would_route_to_host(len(slices), schema.row_count,
                                           index)
        info["route"] = "bsi-host" if reason else "bsi-mesh"
        if reason:
            info["route_reason"] = reason
        info["bsi"] = {"field": c.args.get("field"),
                       "planes": schema.bit_depth, "rows": schema.row_count}
        info["cost_model"] = self._cost_model(None, schema.row_count,
                                              len(slices))
        info["kill_switches"] = self._kill_switches()
        return info

    @staticmethod
    def _explain_format(leaves, shape, resident: dict) -> dict:
        """Each leaf's resident format ("unstaged" when its view is not
        staged) and, where one is sorted-array, whether the format groups
        serve the tree (pilosa_tpu/executor.py:1575). `resident`: (frame,
        view) -> MeshManager.describe_views' format."""
        fmts = [resident[(f, v)] or "unstaged" for f, v, _r, _q in leaves]
        out: dict = {"leaves": fmts}
        if any(f in ("sparse", "mixed") for f in fmts):
            out["sparse_shape"] = (sparse_shape_kind(_tree_signature(shape))
                                   or "unsupported")
        return out

    def _explain_staging(self, index: str, keys, num_slices: int,
                         resident: dict) -> dict:
        """The Count's views (`keys`, (frame, view) pairs): resident ones
        with their format, the others with the format their staging would
        pick and the bytes it would allocate on the card, which are also
        the bytes it copies there (pilosa_tpu/executor.py:1612)."""
        mgr = self._mesh_mgr
        staged = unstaged = est = 0
        views: list = []
        for frame, view in keys:
            if resident[(frame, view)] is not None:
                staged += 1
                views.append({"frame": frame, "view": view,
                              "resident": True,
                              "format": resident[(frame, view)]})
                continue
            unstaged += 1
            stats, formats = (
                mgr.view_stats(index, frame, view, num_slices)
                if mgr is not None else
                view_stats(self.holder, index, frame, view, num_slices,
                           float(self.sparse_density_threshold)))
            vb = format_pool_bytes(stats, formats)
            est += vb
            n_sparse = int(formats.sum())
            n_live = int(np.count_nonzero(stats[:, 0]))
            views.append({
                "frame": frame, "view": view, "resident": False,
                "format": ("mixed" if 0 < n_sparse < n_live
                           else "sparse" if n_sparse else "dense"),
                "sparse_slices": n_sparse, "estimated_h2d_bytes": vb})
        return {"staged_views": staged, "unstaged_views": unstaged,
                "estimated_h2d_bytes": est,
                "sparse_density_threshold": self.sparse_density_threshold,
                "views": views}

    def _would_route_to_host(self, n_slices: int, num_leaves: int,
                             index: Optional[str] = None, leaves=None,
                             num_slices: int = 0,
                             sig: Optional[str] = None) -> Optional[str]:
        """The routing reason of a call over `n_slices` slices and
        `num_leaves` leaves (a Count's leaves, an aggregate's field rows),
        or None (the card), as pilosa_tpu/executor.py:1951-1976 decides
        it. The resilience half first, given the context and a manager
        (without one nothing is staged or quarantined): "quarantined"
        when `sig` is, "hbm_infeasible" when a view of `leaves` would
        alone pass the HBM budget at `num_slices`. Then the cost half:
        "min_work" under the threshold, "cpu_native" above it on the CPU
        (_cpu_native_routes). Changes nothing; explain() asks it too."""
        mgr = self._mesh_mgr
        if mgr is not None:
            if sig and mgr.plan_quarantined(sig):
                return "quarantined"
            if index is not None and leaves and mgr.stage_infeasible(
                    index, leaves, num_slices):
                return "hbm_infeasible"
        thr = self._min_work()
        if thr <= 0:
            return None
        if n_slices * max(1, num_leaves) < thr:
            return "min_work"
        if self._cpu_native_routes():
            return "cpu_native"
        return None

    def _route_to_host(self, n_slices: int, num_leaves: int,
                       index: Optional[str] = None, leaves=None,
                       num_slices: int = 0,
                       sig: Optional[str] = None) -> Optional[str]:
        """_would_route_to_host, counted in the manager's `routed_host`
        (the manager is made for it, as in the JAX package), and in
        `fallback_<reason>` for the resilience reasons."""
        reason = self._would_route_to_host(n_slices, num_leaves, index,
                                           leaves, num_slices, sig)
        if reason:
            mgr = self.mesh_manager()
            mgr._inc("routed_host")
            if reason in ("quarantined", "hbm_infeasible"):
                mgr._inc(f"fallback_{reason}")
        return reason

    def _min_work(self) -> int:
        """Cost routing's threshold: the argument, else
        $PILOSA_TORCH_DEVICE_MIN_WORK (an unreadable value reads as
        unset), else _DEFAULT_MIN_WORK; the environment is read once."""
        thr = self.device_min_work
        if thr is None:
            thr = self._min_work_resolved
        if thr is None:
            raw = os.environ.get(MIN_WORK_ENV, "")
            try:
                thr = int(raw) if raw else None
            except ValueError:
                thr = None
            if thr is None:
                thr = self._DEFAULT_MIN_WORK
            self._min_work_resolved = thr
        return int(thr)

    def _cpu_native_routes(self) -> bool:
        """Whether calls above the threshold fold on the host too: the
        executor's device is the CPU (the JAX package's cpu backend: the
        plain versions there lose to the C++ fold), the native library
        built (ops.native; a failed build raises), and
        $PILOSA_TORCH_CPU_ROUTE_NATIVE is not off or 0. Decided once."""
        verdict = self._cpu_route_native
        if verdict is None:
            from .ops import native

            verdict = (os.environ.get(CPU_ROUTE_ENV, "on").lower()
                       not in ("off", "0")
                       and self.device.type == "cpu"
                       and native.has_native())
            self._cpu_route_native = verdict
        return verdict

    @staticmethod
    def _kill_switches() -> list:
        """The routing switches set in the environment, as name=value
        (trace tags and explain())."""
        return [f"{name}={os.environ[env]}"
                for env, name in ((USE_DEVICE_ENV, "use_device"),
                                  (MIN_WORK_ENV, "device_min_work"),
                                  (CPU_ROUTE_ENV, "cpu_route_native"))
                if os.environ.get(env, "")]

    def _cost_model(self, lowerable: Optional[bool], leaves: int,
                    n_slices: int) -> dict:
        """explain()'s cost_model block (`lowerable` only for a Count)."""
        out = {"backend_on": True}
        if lowerable is not None:
            out["lowerable"] = lowerable
        return {**out, "leaves": leaves,
                "work_units": n_slices * max(1, leaves),
                "min_work": self._min_work(),
                "cpu_native_routes": self._cpu_native_routes()}

    def _num_slices(self, index: str, slices: List[int]):
        """The slice space the card stages `index`'s views over: every
        slice below the highest asked or known, or, in a cluster, the
        ones of them this node owns (a SliceSpace: the pools hold no
        bytes for the rest)."""
        idx = self.holder.index(index)
        if idx is None:  # dropped (or its holder closed) mid-query
            raise IndexNotFoundError()
        num = max(max(slices), idx.max_slice()) + 1
        if not self._clustered():
            return num
        cl = self.cluster
        key = (index, num, self.host, tuple(cl.hosts()), cl.replica_n,
               cl.partition_n)
        space = self._spaces.get(key)
        if space is None:
            parts = cl.partitions(index, range(num))
            mine = [p for p in range(cl.partition_n) if any(
                n.host == self.host for n in cl.partition_nodes(p))]
            space = SliceSpace(np.flatnonzero(np.isin(parts, mine)))
            if len(self._spaces) >= 64:
                self._spaces.clear()
            self._spaces[key] = space
        return space

    # -- integer-field aggregates ----------------------------------------------

    def _bsi_call_schema(self, index: str, c: Call):
        """(frame name, FieldSchema) of a Sum/Min/Max call; raises the
        NotFound errors the handler maps to 404."""
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        frame = c.args.get("frame") or DEFAULT_FRAME
        f = idx.frame(frame)
        if f is None:
            raise FrameNotFoundError()
        field = c.args.get("field")
        if not isinstance(field, str) or not field:
            raise QueryError(f"{c.name}() field required")
        schema = f.bsi_field(field)
        if schema is None:
            raise FieldNotFoundError(frame, field)
        return frame, schema

    def _execute_bsi_aggregate(self, index: str, c: Call, slices: List[int],
                               opt: Optional[ExecOptions] = None):
        """Sum / Min / Max over an integer field with an optional bitmap
        filter child. Sum answers {"value", "count"} ({0, 0} when no
        column holds a value), Min / Max the extremum and how many
        columns hold it, or None when no column holds a value. In a
        cluster each owner's part is reduced here: Sums add, extremes
        keep the winner and add the counts of a tie."""
        t0 = time.monotonic()
        h2d0 = self._h2d_bytes()
        if self._fans_out(opt):
            self._bsi_call_schema(index, c)  # errors before any leg
            here: dict = {}

            def local(sl):
                out, here["route"], here["check"] = self._bsi_here(
                    index, c, sl)
                return out

            maximize = c.name == "Max"

            def reduce_fn(prev, v):
                if v is None:
                    return prev
                if prev is None:
                    return v
                a = (prev["value"], prev["count"])
                b = (v["value"], v["count"])
                if c.name == "Sum":
                    s_, n = a[0] + b[0], a[1] + b[1]
                else:
                    s_, n = bsi_host.reduce_extremes([a, b], maximize)
                return {"value": int(s_), "count": int(n)}

            out = self._map_reduce(index, c, slices, opt, local, reduce_fn)
            if out is None and c.name == "Sum":
                out = {"value": 0, "count": 0}
            route = here.get("route", "bsi-mesh")
            checked, mismatch = here.get("check", (False, False))
        else:
            out, route, (checked, mismatch) = self._bsi_here(index, c,
                                                             slices)
        self._record_route(route, t0, tier=_query_tier(opt), call=c,
                           staged_bytes=max(0, self._h2d_bytes() - h2d0),
                           shadow_checked=checked, shadow_mismatch=mismatch)
        return out

    def _bsi_here(self, index: str, c: Call, slices: List[int]):
        """(answer, route, (shadow checked, mismatch)) of a Sum / Min /
        Max over `slices`, on this node's card or host."""
        frame, schema = self._bsi_call_schema(index, c)
        if len(c.children) > 1:
            raise QueryError(
                f"{c.name}() only accepts a single bitmap input")
        child = c.children[0] if c.children else None
        filt = None
        if child is not None and slices:
            fleaves: list = []
            ftree = _lower_tree(self.holder, index, child, fleaves)
            filt = (ftree, fleaves) if ftree is not None else None
        on_card = bool(slices) and (child is None or filt is not None)
        if on_card and self._route_to_host(len(slices), schema.row_count,
                                           index=index):
            on_card = False
        if on_card:
            num = self._num_slices(index, slices)
            try:
                if c.name == "Sum":
                    out = self._bsi_sum_device(index, frame, schema, filt,
                                               slices, num)
                else:
                    out = self._bsi_extremum_device(
                        index, frame, schema, filt, slices, num,
                        c.name == "Max")
            except (_Unstaged, DeviceResourceError):
                on_card = False
        self._inc("bsi_device" if on_card else "bsi_host")
        checked = mismatch = False
        if not on_card:
            with obs.profile.phase("host_fold"):
                out = self._bsi_host(index, frame, schema, c, child, slices)
        elif self._shadow_sampled():
            checked = True
            before = SHADOW_STATS.get("mismatch:bsi", 0)
            out = self._shadow_check_bsi(index, c, frame, schema, child,
                                         slices, out)
            mismatch = SHADOW_STATS.get("mismatch:bsi", 0) != before
        route = "bsi-mesh" if on_card else "bsi-host"
        if c.name == "Sum":
            s, n = out if out is not None else (0, 0)
            return ({"value": int(s), "count": int(n)}, route,
                    (checked, mismatch))
        return (None if out is None else {"value": int(out[0]),
                                          "count": int(out[1])},
                route, (checked, mismatch))

    def _bsi_host(self, index, frame, schema, c, child, slices):
        parts = []
        for s in slices:
            frag = self.holder.fragment(index, frame, schema.view, s)
            filt = (self._bitmap_slice(index, child, s)
                    if child is not None else None)
            if c.name == "Sum":
                parts.append(bsi_host.sum_slice(frag, schema, filt))
            elif c.name == "Max":
                parts.append(bsi_host.max_slice(frag, schema, filt))
            else:
                parts.append(bsi_host.min_slice(frag, schema, filt))
        if c.name == "Sum":
            return (sum(v for v, _ in parts), sum(n for _, n in parts))
        return bsi_host.reduce_extremes(parts, c.name == "Max")

    def _bsi_sum_device(self, index, frame, schema, filt, slices, num):
        """(sum, count) from the per-row counts of the bsi view; the sign
        pass (planes against sign AND filter) runs only when the first
        pass counted negatives. Raises _Unstaged when a view cannot be
        staged."""
        mgr = self.mesh_manager()
        view = schema.view
        counts = mgr.bsi_plane_counts(index, frame, view, slices, num,
                                      src=filt)
        if counts is None:
            raise _Unstaged()
        neg: dict = {}
        if counts.get(ROW_SIGN, 0):
            sign = (frame, view, ROW_SIGN, False)
            src = ((["leaf", 0], [sign]) if filt is None else
                   (["and", filt[0], ["leaf", len(filt[1])]],
                    list(filt[1]) + [sign]))
            neg = mgr.bsi_plane_counts(
                index, frame, view, slices, num, src=src,
                rows=range(ROW_PLANE0, ROW_PLANE0 + schema.bit_depth))
            if neg is None:
                raise _Unstaged()
        return sum_from_plane_dicts(counts, neg, schema.bit_depth)

    def _bsi_extremum_device(self, index, frame, schema, filt, slices, num,
                             maximize: bool):
        """(value, count) or None (no values) by an MSB-down search of the
        magnitude planes, each probe one MeshManager.count of a candidate
        tree (ANDed with the filter). Raises _Unstaged when a view cannot
        be staged or a tree does not fit the kernels."""
        mgr = self.mesh_manager()
        view = schema.view

        def count_tree(tree):
            raw: list = []
            shape = bsi_lower.to_shape(tree, frame, view, raw)
            if filt is not None:
                shape = ["and", shape, _unnumber(filt[0], filt[1], raw)]
            leaves: list = []
            tree = canonical_tree(shape, raw, leaves)
            n = (None if tree is None else
                 mgr.count(index, tree, leaves, slices, num))
            if n is None:
                raise _Unstaged()
            return n

        def search(cand, big_mag: bool):
            mag = 0
            for k in range(schema.bit_depth - 1, -1, -1):
                p = bsi_lower.leaf(ROW_PLANE0 + k)
                inter = bsi_lower.t_and(cand, p)
                if big_mag:
                    if count_tree(inter):
                        cand, mag = inter, mag | (1 << k)
                else:
                    rest = bsi_lower.t_andnot(cand, p)
                    if count_tree(rest):
                        cand = rest
                    else:
                        cand, mag = inter, mag | (1 << k)
            return mag, count_tree(cand)

        n_pos = count_tree(bsi_lower.POS)
        n_neg = count_tree(bsi_lower.NEG)
        sides = ((n_pos, bsi_lower.POS, 1), (n_neg, bsi_lower.NEG, -1))
        if not maximize:
            sides = sides[::-1]
        for n_side, base, sign in sides:
            if n_side:
                # max: positives hold the largest magnitude, negatives the
                # smallest; min mirrors.
                mag, n = search(base, big_mag=(sign > 0) == maximize)
                return sign * mag, n
        return None

    # -- TopN --------------------------------------------------------------

    def _execute_top_n(self, index: str, c: Call, slices: List[int],
                       opt: Optional[ExecOptions] = None):
        """TopN from exact per-row counts on the card (MeshManager.top_n)
        or, when the card cannot serve its form, top_n_host. In a
        cluster, the reference's two phases: each owner's top pairs over
        its slices (a leg's answer is its phase one), summed by id, then
        unless ids were asked for an exact recount of those candidate ids
        over every owner, trimmed to n. One node keeps its exact
        one-phase answer."""
        if self._fans_out(opt):
            row_ids, _ = c.uint_slice_arg("ids")
            n, _ = c.uint_arg("n")
            pairs = self._top_n_cluster(index, c, slices, opt)
            if not pairs or row_ids:
                return pairs
            other = c.clone()
            other.args["ids"] = sorted(p[0] for p in pairs)
            trimmed = self._top_n_cluster(index, other, slices, opt)
            return trimmed[:n] if n and n < len(trimmed) else trimmed
        epoch = MUTATION_EPOCH.n  # before the count: _settle's witness
        pairs = (self._on_card(self._top_n_device, index, c, slices)
                 if slices else None)
        if pairs is not None and not c.args.get("filters") \
                and not c.uint_arg("tanimotoThreshold")[0] \
                and self._shadow_sampled():
            pairs = self._shadow_check_top_n(index, c, slices, pairs, epoch)
        if pairs is not None:
            self._inc("topn_device")
            return pairs
        self._inc("topn_host")
        return self.top_n_host(index, c, slices)

    def _top_n_cluster(self, index: str, c: Call, slices: List[int],
                       opt: ExecOptions):
        pairs = self._map_reduce(
            index, c, slices, opt,
            lambda sl: self._execute_top_n(index, c, sl),
            lambda prev, v: add_to_pairs(prev or [], v))
        return sort_pairs(pairs or [])

    def _top_n_device(self, index: str, c: Call, slices: List[int]):
        """MeshManager.top_n for every form of the call, or None for the
        forms the host path serves (and reports the errors of): a src
        that does not lower, filters without a field, a Tanimoto
        threshold above 100 or without a src."""
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        if tanimoto > 100:
            return None
        frame = c.args.get("frame") or DEFAULT_FRAME
        attr_predicate = None
        filters = c.args.get("filters")
        field = c.args.get("field") or ""
        if filters and field:
            f = self.holder.frame(index, frame)
            if f is None:
                return None
            store, allowed = f.row_attr_store, set(filters)

            def attr_predicate(row_id):
                attr = store.attrs(row_id)
                return bool(attr) and attr.get(field) in allowed
        elif filters:
            return None
        if tanimoto and not c.children:
            return None
        src = None
        if c.children:
            if len(c.children) > 1:
                return None
            leaves: list = []
            tree = _lower_tree(self.holder, index, c.children[0], leaves)
            if tree is None or not leaves:
                return None
            src = (tree, leaves)
        n, _ = c.uint_arg("n")
        row_ids, _ = c.uint_slice_arg("ids")
        min_threshold, _ = c.uint_arg("threshold")
        return self.mesh_manager().top_n(
            index, frame, VIEW_STANDARD, slices,
            self._num_slices(index, slices), 0 if row_ids else n, row_ids,
            min_threshold, src=src,
            attr_predicate=attr_predicate, tanimoto_threshold=tanimoto)

    def top_n_host(self, index: str, c: Call, slices: List[int]):
        """The JAX package's host TopN: each slice's top pairs from its
        rank cache, summed by id; then, unless ids were asked for, an
        exact recount of those candidate ids, trimmed to n."""
        row_ids, _ = c.uint_slice_arg("ids")
        n, _ = c.uint_arg("n")
        pairs = self._top_n_host_slices(index, c, slices)
        if not pairs or row_ids:
            return pairs
        other = c.clone()
        other.args["ids"] = sorted(p[0] for p in pairs)
        trimmed = self._top_n_host_slices(index, other, slices)
        return trimmed[:n] if n and n < len(trimmed) else trimmed

    def _top_n_host_slices(self, index: str, c: Call, slices: List[int]):
        pairs: list = []
        for s in slices:
            pairs = add_to_pairs(pairs, self._top_n_slice(index, c, s))
        return sort_pairs(pairs)

    def _top_n_slice(self, index: str, c: Call, slice_: int):
        """One slice of the host TopN (Fragment.top)."""
        frame = c.args.get("frame") or DEFAULT_FRAME
        n, _ = c.uint_arg("n")
        field = c.args.get("field") or ""
        row_ids, _ = c.uint_slice_arg("ids")
        min_threshold, _ = c.uint_arg("threshold")
        filters = c.args.get("filters") or []
        tanimoto, _ = c.uint_arg("tanimotoThreshold")
        src = None
        if len(c.children) == 1:
            src = self._bitmap_slice(index, c.children[0], slice_)
        elif len(c.children) > 1:
            raise QueryError("TopN() can only have one input bitmap")
        frag = self.holder.fragment(index, frame, VIEW_STANDARD, slice_)
        if frag is None:
            return []
        if tanimoto > 100:
            raise QueryError("Tanimoto Threshold is from 1 to 100 only")
        return frag.top(TopOptions(
            n=n, src=src, row_ids=row_ids,
            min_threshold=min_threshold or MIN_THRESHOLD,
            filter_field=field, filter_values=filters,
            tanimoto_threshold=tanimoto))

    # -- attribute writes ----------------------------------------------------

    def _execute_bulk_set_row_attrs(self, index: str, calls,
                                    opt: Optional[ExecOptions] = None) -> list:
        """SetRowAttrs(frame=f, rowID=r, key=value, ...) calls, merged per
        frame and written to each frame's row store in one transaction;
        in a cluster then sent to every other node (with hints for the
        ones that miss it)."""
        by_frame: dict = {}
        for c in calls:
            frame = c.args.get("frame")
            if not isinstance(frame, str):
                raise QueryError("SetRowAttrs() frame required")
            f = self.holder.frame(index, frame)
            if f is None:
                raise FrameNotFoundError()
            row_id, ok = c.uint_arg(f.row_label)
            if not ok:
                raise QueryError(
                    f"SetRowAttrs() row field '{f.row_label}' required")
            attrs = dict(c.args)
            attrs.pop("frame", None)
            attrs.pop(f.row_label, None)
            by_frame.setdefault(frame, {}).setdefault(row_id, {}).update(
                attrs)
        for frame, items in by_frame.items():
            self.holder.frame(index, frame).row_attr_store.set_bulk_attrs(
                items)
        if self._fans_out(opt):
            self._broadcast_with_hints(index, Query(calls=list(calls)), opt)
        return [None] * len(calls)

    def _execute_set_column_attrs(self, index: str, c: Call,
                                  opt: Optional[ExecOptions] = None):
        """SetColumnAttrs(id=N or <column label>=N, key=value, ...), then
        in a cluster to every other node."""
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        id_, ok = c.uint_arg("id")
        col_name = "id"
        if not ok:
            id_, ok = c.uint_arg(idx.column_label)
            if not ok:
                raise QueryError("SetColumnAttrs() id required")
            col_name = idx.column_label
        attrs = dict(c.args)
        attrs.pop(col_name, None)
        idx.column_attr_store.set_attrs(id_, attrs)
        if self._fans_out(opt):
            self._broadcast_with_hints(index, Query(calls=[c]), opt)
        return None

    # -- writes --------------------------------------------------------------

    def _set_value_args(self, index: str, c: Call):
        """(frame, field, column, value) of SetValue(frame=f, columnID=N,
        <field>=V), which overwrites a column's integer value. Validated
        before any replica writes: 404 for an unknown field, 422 for a
        value outside its range."""
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        frame = c.args.get("frame")
        if not isinstance(frame, str):
            raise QueryError("SetValue() frame required")
        f = idx.frame(frame)
        if f is None:
            raise FrameNotFoundError()
        col_id, ok = c.uint_arg(idx.column_label)
        if not ok:
            raise QueryError(
                f"SetValue() column field '{idx.column_label}' required")
        fields = [(k, v) for k, v in c.args.items()
                  if k not in ("frame", idx.column_label)]
        if len(fields) != 1:
            raise QueryError(
                "SetValue() requires exactly one field=value pair")
        fname, value = fields[0]
        if isinstance(value, bool) or not isinstance(value, int):
            raise QueryError(f"SetValue() field '{fname}' must be an int")
        schema = f.bsi_field(fname)
        if schema is None:
            raise FieldNotFoundError(frame, fname)
        schema.validate(value)
        return f, fname, col_id, value

    def _bit_args(self, index: str, c: Call):
        idx = self.holder.index(index)
        if idx is None:
            raise IndexNotFoundError()
        frame = c.args.get("frame")
        if not isinstance(frame, str):
            raise QueryError(f"{c.name}() frame required")
        f = idx.frame(frame)
        if f is None:
            raise FrameNotFoundError()
        row_id, ok = c.uint_arg(f.row_label)
        if not ok:
            raise QueryError(f"{c.name}() row field '{f.row_label}' required")
        col_id, ok = c.uint_arg(idx.column_label)
        if not ok:
            raise QueryError(
                f"{c.name}() column field '{idx.column_label}' required")
        return f, row_id, col_id


    # -- the cluster ---------------------------------------------------------

    def _clustered(self) -> bool:
        return self.cluster is not None and len(self.cluster.nodes) > 1

    def _fans_out(self, opt: Optional[ExecOptions]) -> bool:
        """Whether a call is split by owner: in a cluster, for a query
        execute() runs (with its options), unless it is itself a remote
        leg (a leg never fans out again). Without options (a node's own
        share) it is served here."""
        return (self._clustered() and opt is not None
                and not opt.remote)

    def _map_reduce(self, index: str, c: Call, slices: Sequence[int],
                    opt: ExecOptions, local_fn, reduce_fn):
        """`c` over `slices` split by owner (the reference's
        executor.go:1103-1163): this node's share through
        `local_fn(slices)` (its card path, one MeshManager call for the
        share), every other owner's as a remote leg over HTTP, the
        answers folded by `reduce_fn(prev, v)` (prev None first)."""
        return self._mapper(list(self.cluster.nodes), index, c, slices,
                            opt, local_fn, reduce_fn)

    def _mapper(self, nodes, index: str, c: Call, slices: Sequence[int],
                opt: ExecOptions, local_fn, reduce_fn):
        """One split over `nodes`. The legs go out first; this node's
        share runs in the calling thread meanwhile (its errors
        propagate). A leg that fails transiently (_transient_error) has
        its slices split again over the other nodes; one that fails
        otherwise fails the query. With opt.partial a slice no node can
        serve is listed in missing_slices."""
        m = self._slices_by_node(nodes, index, slices, opt)
        futures = {}
        mine = None
        for node, node_slices in m.items():
            if node.host == self.host:
                mine = node_slices
                continue
            opt.used_http = True
            fut = self._pool.submit(obs.wrap_ctx(self._exec_remote_one),
                                    node, index, c, node_slices, opt)
            futures[fut] = (node, node_slices)
        result = None
        try:
            if mine is not None:
                result = reduce_fn(None, local_fn(mine))
            pending = set(futures)
            while pending:
                left = opt.deadline_left()
                if left is not None and left <= 0:
                    raise DeadlineExceededError(
                        f"fan-out wait: deadline exceeded by "
                        f"{-left * 1e6:.0f}us")
                done, pending = wait(pending, timeout=left,
                                     return_when=FIRST_COMPLETED)
                for fut in done:
                    node, node_slices = futures[fut]
                    try:
                        v = fut.result()
                    except Exception as err:
                        if not self._transient_error(err):
                            raise
                        rest = [n for n in nodes if n is not node]
                        try:
                            with obs.span("resplit", node=node.host,
                                          slices=len(node_slices),
                                          resplit=1):
                                self._inc("resplit")
                                v = self._mapper(rest, index, c, node_slices,
                                                 opt, local_fn, reduce_fn)
                        except SliceUnavailableError as resplit_err:
                            if opt.partial:
                                opt.missing_slices.extend(node_slices)
                                continue
                            raise err from resplit_err
                        if v is None:
                            continue
                    result = reduce_fn(result, v)
        except BaseException:
            for fut in futures:
                fut.cancel()
            raise
        return result

    @staticmethod
    def _transient_error(err: BaseException) -> bool:
        """Whether a leg's failure re-splits its slices: an error that
        says (`transient`, e.g. api.client.ClientError) is taken at its
        word; a QueryError is not (every replica would fail alike);
        anything else unannotated is (a fake client's socket error)."""
        transient = getattr(err, "transient", None)
        if transient is not None:
            return bool(transient)
        return not isinstance(err, QueryError)

    def _exec_remote(self, node, index: str, q: Query,
                     slices: Optional[Sequence[int]],
                     opt: ExecOptions) -> list:
        """`q` on `node` as a remote leg through the client seam, the
        PQL in its canonical form, with the deadline's remaining budget
        when there is one."""
        if self.client is None:
            raise SliceUnavailableError(f"no client to reach {node.host}")
        with obs.span("fanout", node=node.host,
                      slices=len(slices) if slices else 0), \
                obs.profile.phase("fanout_remote"):
            fault.point("executor.fanout", node=node.host)
            opt.check_deadline(f"fanout to {node.host}")
            kw = {}
            if opt.deadline is not None:
                kw["deadline"] = opt.deadline
            return self.client.execute_query(node, index, str(q),
                                             slices or [], True, **kw)

    def _exec_remote_one(self, node, index: str, c: Call,
                         slices: Sequence[int], opt: ExecOptions):
        results = self._exec_remote(node, index, Query(calls=[c]), slices,
                                    opt)
        return results[0] if results else None

    def _breaker_callable(self, opt: Optional[ExecOptions] = None):
        """host -> breaker state: the query's snapshot when it has one,
        else the client's live breaker_state, else None (no breakers)."""
        if opt is not None and opt.breaker_snapshot is not None:
            snap = opt.breaker_snapshot
            return lambda host: snap.get(host, "closed")
        state = getattr(self.client, "breaker_state", None)
        return state if callable(state) else None

    def _slices_by_node(self, nodes, index: str, slices: Sequence[int],
                        opt: Optional[ExecOptions] = None) -> dict:
        """node -> the slices it serves, among `nodes`: each slice's
        preferred_owner (UP with a closed breaker first; this node first
        under prefer-local-reads), or on a bounded read the replica
        pick_read_replica gives it. SliceUnavailableError when a slice
        has no owner left, unless opt.partial, which lists it missing."""
        breaker = self._breaker_callable(opt)
        prefer = self.host if self.prefer_local_reads else None
        read_bound = (opt.staleness
                      if opt is not None and not opt.remote else 0.0)
        sclass = "bounded" if read_bound > 0 else "strict"
        slices = np.asarray(list(slices), dtype=np.int64)
        parts = self.cluster.partitions(index, slices)
        m: dict = {}
        # A slice's owners are its partition's: a strict read makes one
        # pick a partition, a bounded one a pick a slice (each slice's
        # staleness is its own).
        for p in np.unique(parts).tolist():
            mine = slices[parts == p].tolist()
            owners = [o for o in self.cluster.partition_nodes(p)
                      if o in nodes]
            if opt is not None and opt.partial:
                owners = [o for o in owners if o.state in SERVING_STATES]
                if not owners:
                    opt.missing_slices.extend(mine)
                    continue
            elif not owners:
                raise SliceUnavailableError()
            if read_bound <= 0 or len(owners) < 2:
                self.read_stats.inc("owner|" + sclass, len(mine))
                m.setdefault(preferred_owner(owners, breaker, prefer=prefer),
                             []).extend(mine)
                continue
            for s in mine:
                pick = pick_read_replica(
                    owners, breaker,
                    staleness_ok=lambda h, s=s: self.epochs
                    .staleness_ok_slice(h, index, s, read_bound),
                    queue_depth=self.epochs.queue_depth, prefer=self.host)
                if pick is not None:
                    # "follower": away from the ring's primary.
                    self.read_stats.inc(
                        ("follower|" if pick.host != owners[0].host
                         else "owner|") + sclass)
                else:
                    self.read_stats.inc("fallback_owner|" + sclass)
                    pick = preferred_owner(owners, breaker, prefer=prefer)
                m.setdefault(pick, []).append(s)
        for node in m:
            m[node].sort()
        return m

    def _execute_mutate_view(self, index: str, c: Call, opt: ExecOptions,
                             col_id: int, local_fn: Callable[[], bool]):
        """A bit write to every owner of its slice (the JAX executor's
        _execute_mutate_view). Owners known DOWN or
        behind an open breaker are counted before the local apply: a
        write that cannot reach write-consistency is refused (503) with
        nothing written anywhere. The other owners get it in parallel;
        it acks once write-consistency owners (the local apply among
        them) applied it, and every owner it missed gets a hint, on the
        503 path too (an owner that applied must converge with the
        rest), carrying the epochs the local apply reached. A remote leg
        writes here only."""
        if not self._clustered():
            return local_fn()
        slice_ = col_id // SLICE_WIDTH
        owners = self.cluster.fragment_nodes(index, slice_)
        locals_ = [n for n in owners if n.host == self.host]
        remotes = [n for n in owners if n.host != self.host]
        if opt.remote or not remotes:
            ret = False
            for _ in locals_:
                ret = local_fn() or ret
            if locals_:
                self._observe_write_epochs(index, c, slice_)
            return ret
        level = self.write_consistency
        required = required_acks(level, len(owners))
        hints = self.hints
        down: list = []
        live = list(remotes)
        if hints is not None:
            breaker = self._breaker_callable()
            down = [n for n in remotes if n.state == NODE_STATE_DOWN
                    or (breaker is not None and breaker(n.host) == "open")]
            live = [n for n in remotes if n not in down]
            if len(locals_) + len(live) < required:
                CONSISTENCY_STATS.inc(f"{level}:rejected_unavailable")
                raise WriteConsistencyError(
                    f"write-consistency={level} needs {required} of "
                    f"{len(owners)} replicas, only "
                    f"{len(locals_) + len(live)} reachable",
                    level=level, required=required, acked=0)
        ret = False
        acked = 0
        for _ in locals_:
            ret = local_fn() or ret
            acked += 1
        wrote = (self._observe_write_epochs(index, c, slice_) if locals_
                 else {})
        q = Query(calls=[c])
        futures = [(node, self._pool.submit(obs.wrap_ctx(self._exec_remote),
                                            node, index, q, None, opt))
                   for node in live]
        failures = []
        for node, fut in futures:
            try:
                res = fut.result()
                if res and res[0]:
                    ret = True
                acked += 1
            except Exception as err:  # noqa: BLE001 — collected below
                failures.append((node.host, err))
        if hints is None:
            if failures:
                raise failures[0][1]
            return ret
        pql = str(q)
        missed = [n.host for n in down] + [h for h, _ in failures]
        for host in missed:
            hints.enqueue_query(host, index, pql, epochs=wrote)
        if acked >= required:
            CONSISTENCY_STATS.inc(
                f"{level}:hinted" if missed else f"{level}:ok")
            return ret
        CONSISTENCY_STATS.inc(f"{level}:below_consistency")
        raise WriteConsistencyError(
            f"write-consistency={level}: {acked} of {required} required "
            f"replica acks ({len(failures)} failed mid-write; misses "
            f"journaled as hints)",
            level=level, required=required, acked=acked)

    def _observe_write_epochs(self, index: str, c: Call,
                              slice_: int) -> dict:
        """{fragment key: epoch} of each loaded fragment of the written
        frame's views in `slice_` (a SetBit may land in standard,
        inverse and time views), fed to the tracker now: a follower
        missing this write ages from this moment."""
        frame = c.args.get("frame")
        f = self.holder.frame(index, frame if isinstance(frame, str)
                              and frame else DEFAULT_FRAME)
        out: dict = {}
        if f is None:
            return out
        for vname, view in list(f.views.items()):
            frag = view.fragments.get(slice_)
            if frag is not None and not frag._pending_load:
                key = fragment_key(index, f.name, vname, slice_)
                self.epochs.observe_local(key, frag.epoch)
                out[key] = frag.epoch
        return out

    def _broadcast_query(self, index: str, q: Query, opt: ExecOptions):
        """`q` to every other node in parallel; every answer is awaited,
        and BroadcastError names each host that failed."""
        nodes = [n for n in self.cluster.nodes if n.host != self.host]
        if not nodes:
            return
        futures = [(node, self._pool.submit(obs.wrap_ctx(self._exec_remote),
                                            node, index, q, None, opt))
                   for node in nodes]
        failures = []
        for node, fut in futures:
            try:
                fut.result()
            except Exception as err:  # noqa: BLE001 — collected below
                failures.append((node.host, err))
        if failures:
            raise BroadcastError(failures, len(nodes))

    def _broadcast_with_hints(self, index: str, q: Query,
                              opt: ExecOptions) -> None:
        """An attr write already applied here, to every other node; with
        hinted handoff the nodes that missed it get hints and the write
        acks, without it the BroadcastError stands."""
        try:
            self._broadcast_query(index, q, opt)
        except BroadcastError as err:
            if self.hints is None:
                raise
            pql = str(q)
            for host, _e in err.failures:
                self.hints.enqueue_query(host, index, pql)

    def _explain_placement(self, index: str, slices: Sequence[int],
                           staleness: float = 0.0) -> dict:
        """explain()'s `placement` in a cluster: the picks
        _slices_by_node would make, by host (the slice count, a sample of
        16, the tier; on a bounded read each pick's role: owner,
        follower or fallback_owner), the tiers' counts, the slices no
        node owns, every breaker's state and, on a bounded read, `read`
        {staleness_s, followers, fallback_owner} (the JAX executor's,
        without its ICI parts). The replica draw is seeded, so one
        answer's picks are stable."""
        import random

        state = self._breaker_callable()
        prefer = self.host if self.prefer_local_reads else None
        rnd = random.Random(0)
        per_host: dict = {}
        unowned: list = []
        tiers = {"local": 0, "http": 0}
        read = ({"staleness_s": staleness, "followers": 0,
                 "fallback_owner": 0} if staleness > 0 else None)
        for slice_ in slices:
            owners = self.cluster.fragment_nodes(index, slice_)
            if not owners:
                unowned.append(slice_)
                continue
            pick, role = None, "owner"
            if read is not None and len(owners) > 1:
                pick = pick_read_replica(
                    owners, state,
                    staleness_ok=lambda h, s=slice_: self.epochs
                    .staleness_ok_slice(h, index, s, staleness),
                    queue_depth=self.epochs.queue_depth, prefer=self.host,
                    rnd=rnd)
                if pick is None:
                    role = "fallback_owner"
                    read["fallback_owner"] += 1
                elif pick.host != owners[0].host:
                    role = "follower"
                    read["followers"] += 1
            if pick is None:
                pick = preferred_owner(owners, state, prefer=prefer)
            tier = owner_tier(pick.host, self.host)
            tiers[tier] += 1
            ent = per_host.setdefault(pick.host, {"slices": 0, "sample": [],
                                                  "tier": tier})
            ent["slices"] += 1
            if read is not None:
                roles = ent.setdefault("roles", {})
                roles[role] = roles.get(role, 0) + 1
            if len(ent["sample"]) < 16:
                ent["sample"].append(slice_)
        out = {"mode": "cluster", "nodes": per_host, "tiers": tiers,
               "tier": "http" if tiers["http"] else "local"}
        if read is not None:
            out["read"] = read
        if unowned:
            out["unowned_count"] = len(unowned)
            out["unowned_sample"] = unowned[:16]
        snap = getattr(getattr(self.client, "breakers", None), "snapshot",
                       None)
        if callable(snap):
            out["breakers"] = snap()
        return out


class _Unstaged(Exception):
    """An aggregate the card cannot serve (a view that cannot be staged,
    a filter or tree beyond the kernels): it goes to the host folds."""


def _unnumber(tree, leaves, raw: list):
    """A numbered tree over `leaves` as a lowered shape, appending its
    leaves to `raw` depth-first (the input form of canonical_tree)."""
    if tree[0] == "leaf":
        raw.append(leaves[tree[1]])
        return ["leaf"]
    return [tree[0]] + [_unnumber(c, leaves, raw) for c in tree[1:]]


def _add_counts(prev, v):
    return (prev or 0) + v


def _merge_rows(prev, v):
    """Fold a share's row into the answer (each share's Row is fresh)."""
    if prev is None:
        return v
    prev.merge(v)
    return prev


def _query_tier(opt: Optional[ExecOptions]) -> str:
    """The route's tier: `http` once a leg went over HTTP."""
    return "http" if opt is not None and opt.used_http else "local"
