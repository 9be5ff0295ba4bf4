"""HTTP handler: the routes of this slice, with the JAX handler's JSON
bodies and status codes.

  GET    /                              a page for PQL and the schema
  GET    /version                                         -> {"version"}
  GET    /index                         the schema        -> {"indexes": [...]}
  GET    /index/{index}                                   -> {"index": {...}}
  POST   /index/{index}                 create an index   -> {}
  DELETE /index/{index}                 delete an index   -> {}
  PATCH  /index/{index}/time-quantum    {"timeQuantum"}   -> {}
  POST   /index/{index}/frame/{frame}   create a frame    -> {}
  DELETE /index/{index}/frame/{frame}   delete a frame    -> {}
  PATCH  /index/{index}/frame/{frame}/time-quantum        -> {}
  GET    /index/{index}/frame/{frame}/views               -> {"views": [...]}
  POST   /index/{index}/frame/{frame}/restore?host=H   pull every fragment
         of the frame from node H (400 without host, 501 without a
         client factory)                                  -> {}
  POST   /index/{index}/query           PQL body          -> {"results": [...]}
         or a protobuf QueryRequest (query, slices, column_attrs, remote:
         a coordinator's leg, served here only, no admission) with a
         QueryResponse back when Accept names protobuf (its `err` the
         error's message, at the error's status)
         (?slices=0,1 restricts the slices; ?partial=true leaves out a
         slice no owner can serve and adds "partial" and
         "missing_slices"; ?columnAttrs=true adds
         "columnAttrs", the attrs of the columns in Bitmap results;
         ?explain=true answers the plan, Executor.explain, with a "cost"
         block of what the cost ledger holds of the tenant x shape, and
         runs nothing; ?profile=true adds "profile", the query's
         measured phases, bytes and roofline. Headers: X-Pilosa-Tenant
         (default "default"), X-Pilosa-Deadline-Us (the budget left, us;
         or ?deadline=50ms; else [cluster] query-deadline),
         X-Pilosa-Staleness (or ?staleness=; a bare number is ms, else a
         duration, "5s"; unparseable is 0; else [cluster]
         default-read-staleness): > 0 makes a bounded read, which may
         be served by an in-sync replica or the result cache; a remote
         leg takes none. Admission
         (with a scheduler): 429 + Retry-After when shed, 504 when the
         deadline expires first; a 200 of a tenant over [obs]
         cost-debt-threshold of the device time carries
         X-Pilosa-Cost-Debt)
  POST   /import                        protobuf ImportRequest (wire/):
         Frame.import_bits      -> {}, or an ImportResponse when Accept
         names protobuf; in a cluster 412 on a node that does not own
         the slice, and (with hinted handoff) copied to the slice's other
         owners under write-consistency, the misses hinted, 503 below
         it (?remote=true: a copy, applied here only)
  GET    /fragment/nodes?index=&slice=  the slice's owners -> [{"host",
         "internalHost"}] ([] without a cluster)
  GET    /hosts                         the cluster's nodes, same form
  GET    /status                        this node's status and the peers'
         last polled ones -> {"nodes": [{"host", "state", "indexes":
         [{"name", "maxSlice", "frames"}]}]}, or a ClusterStatus
  POST   /internal/message              a framed broadcast message (one
         tag byte, then CreateSlice / CreateIndex / DeleteIndex /
         CreateFrame / DeleteFrame), applied by the server
  GET    /internal/status               this node's NodeStatus (protobuf)
  GET    /internal/epochs               {"host", "epochs": {"i/f/view/slice":
         replication epoch}, "queue_depth"} (Holder.fragment_epochs; the
         scheduler's queued + in flight)
  POST   /internal/epochs/advance       {"epochs": {key: epoch}}: each
         known fragment's epoch floor-raised (never lowered; unknown
         keys skipped)                 -> {"applied": fragments raised}
  POST   /index/{index}/attr/diff       {"blocks": [{"id", "checksum"}]}:
         the column attrs of this node's blocks that differ from the
         sender's                      -> {"attrs": {id: {...}}}
  POST   /index/{index}/frame/{frame}/attr/diff   the same of the row attrs
  GET    /export?index=&frame=&view=&slice=   every bit as `row,col` lines
  GET    /fragment/data?index=&frame=&view=&slice=   the fragment's tar
  POST   /fragment/data?...             restore the fragment from a tar
  GET    /fragment/blocks?...           -> {"blocks": [{"id", "checksum"}]}
  GET    /fragment/block/data?...&block=N (or a protobuf BlockDataRequest
         body)                  -> {"rowIDs", "columnIDs"}, or a
         BlockDataResponse when Accept names protobuf
  GET    /slices/max[?inverse=true]     -> {"maxSlices": {index: n}}, or a
         MaxSlicesResponse
  GET    /schema                                          -> {"indexes": [...]}
  GET    /metrics                       Prometheus text format 0.0.4 (below;
         ?exemplars=true: latency buckets carry trace ids)
  GET    /healthz                       200 while the watchdog sweeps
  GET    /readyz                        503 with "reasons" while a critical
         subsystem (wal, sched-dispatch, mesh-count-batch) is stalled or
         the server is not serving, else 200
  GET    /debug/health                  the liveness table (obs/health.py)
  GET    /debug/bundle[?write=true]     the diagnostic dossier
  GET    /debug/slo                     SLIs, burn rates, error budgets
  GET    /debug/costs[?sort=&limit=]    the cost ledger's accounts
  GET    /debug/queries[?threshold_us=N]   recent and slow traces
  GET    /debug/traces/{id}             one trace's spans
  GET    /debug/queryshapes[?sort=&limit=]  the flight recorder
  GET    /debug/fleet[?force=true]      the federated fleet pane over the
         cluster's members; 404 {"error": "fleet view requires a cluster"}
         on a handler without one, as the JAX handler
  GET    /debug/pprof[/]                the profile index, then the thread dump
  GET    /debug/pprof/profile?seconds=N   every thread's stacks sampled at
         ~100 Hz, collapsed ("frame;frame N")
  GET    /debug/pprof/heap (= /allocs)  RSS and tracemalloc's top sites
         (?start=1 needs PILOSA_TORCH_HEAP_TRACE=1; ?stop=1, ?gc=1)
  GET    /debug/pprof/block, /mutex     sampled waits (mutex: direct lock
         waits only)
  GET    /debug/pprof/trace?seconds=N   the samples as chrome trace JSON
  GET    /debug/pprof/goroutine         every thread's stack
  GET    /debug/pprof/threadcreate      the live thread table
  GET    /debug/pprof/cmdline           sys.argv joined by NUL
  GET    /debug/vars                    the stats client's snapshot (setN,
         query.us.p50, ..., flat keys "index:i,frame:f,...,setN"),
         "uptime_seconds", "version", {"storage": {"fragments": each
         loaded fragment's storage_state, "wal": WAL_STATS,
         "group_size.count" / ".sum" / ".min" / ".max" / ".p50" / ".p95" /
         ".p99" and the same of "snapshot_us"}, "integrity": {"scrub": the
         scrubber's record,
         "shadow": SHADOW_STATS, "fragments": INTEGRITY_STATS,
         "torn_tails"}, "kernel_launches": each kernel's launches in this
         process (ops.kernels.LAUNCHES), and, once a query has built the
         card manager, "mesh": its counters (the repeat-TopN memo's
         memo_hit / memo_store / memo_size and inflight_shared among
         them), "hbm": {budget_bytes, the residency report}, and
         "quarantined_plans"}, "host_cache": the host folds' cache
         counters (Executor.host_cache_stats), "sched" (the scheduler's
         snapshot) when one is wired, and "count_calibration" (the last
         start-up check's record, ops.calibrate, K4's under "sparse")
         once a start on a card has checked its kernels, "epochs" (the
         EpochTracker's snapshot) and "result_cache" (the result cache's
         size, cap, hit rate and events)

GET /metrics renders one obs.prom.Registry, whose collectors bridge the
stores at scrape time (the JAX handler's families and names): the stats
client (pilosa_<name>_total{index,frame,view,slice}, the query latency
histograms), pilosa_build_info and pilosa_uptime_seconds, the card
manager's counters (pilosa_mesh_*, pilosa_dispatch_total{mode},
pilosa_hbm_evictions_total{reason}, pilosa_device_fallback_total
{reason}, pilosa_plan_quarantined_total, pilosa_hbm_resident_bytes
{device} and the rest of the residency report, pilosa_hbm_budget_bytes;
none before a query built the manager), the host folds' cache
(pilosa_host_cache_*: block, memo and matrix hits and misses; the
query_* gauges stay 0), the executor's routes
(pilosa_query_route_total{backend,tier},
pilosa_query_route_duration_microseconds{backend}), the fragments
(pilosa_fragment_cardinality and pilosa_fragments{state}, sampled at
most every metrics_sample_interval seconds), storage (pilosa_wal_*,
pilosa_storage_*) and integrity (pilosa_integrity_*, pilosa_scrub_*,
pilosa_shadow_*), the scheduler (pilosa_sched_*, with one), the SLO
recorder (pilosa_query_outcome_total{outcome,tenant,route},
pilosa_slo_*), the liveness plane (pilosa_health_*,
pilosa_watchdog_*), the profiles (pilosa_query_phase_us,
pilosa_roofline_*), the cost ledger (pilosa_cost_*,
pilosa_perf_regression) and the flight recorder
(pilosa_queryshape_*), the cluster (pilosa_cluster_* transport
counters and pilosa_breaker_state{host,state} with a cluster client,
pilosa_member_state{host,state} with a cluster), hinted handoff
(pilosa_hints_queued/replayed/dropped_total{target}, pilosa_hint_bytes
{target} with a hint manager), the replicated writes'
pilosa_write_consistency_total{level,outcome} and the read path's
pilosa_read_replica_total{replica,staleness},
pilosa_result_cache_events_total{event} and
pilosa_result_cache_entries. A family whose store the port lacks (the
compile counters, the plan cache, the row caches) is left out. A
collector that raises is skipped.

Every query outcome is recorded once, in _post_query, into the SLO
recorder (shed, deadline, backpressure, client and server errors,
successes), and every import's under route "import". A query runs under
a trace (the tracer's rings behind /debug/queries), the tenant's cost
account, and, with ?profile=true or every [obs] profile-sample-rate-th
query, a measured profile.

A delete drops the index's staged views from the card at once
(Executor.invalidate_device_index). An import or a restore resets the
fragments' mutation logs, so the next Count restages their views.

A Bitmap result is {"attrs", "bits"}, a TopN result [{"id", "count"}].

Errors answer {"error": message}: 404 for a missing index, frame,
fragment or integer field, 409 for one that exists, 422 for a value
outside a field's range, 503 with Retry-After for a write shed by
backpressure, 500 for a slice whose data cannot be read (a corrupt
fragment) and for a protobuf body that does not parse (as the JAX
handler answers google.protobuf's DecodeError), 400 for a bad request
or a failed query.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import re
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..bsi.field import FieldNotFoundError, FieldValueError
from .client import ClientError
from ..core.attr import diff_blocks
from ..core.fragment import INTEGRITY_STATS
from ..core.row import Row
from ..core.timequantum import parse_time_quantum
from ..core.view import VIEW_INVERSE
from ..core.scrub import SCRUB_STATS
from ..core.wal import GROUP_SIZE, SNAPSHOT_US, WAL_STATS
from .. import fault
from ..config import parse_duration
from ..errors import (DeadlineExceededError, FragmentNotFoundError,
                      FrameExistsError, FrameNotFoundError, IndexExistsError,
                      IndexNotFoundError, PilosaError, SliceUnavailableError,
                      WriteBackpressureError, WriteConsistencyError)
from ..executor import (CONSISTENCY_STATS, SHADOW_STATS, ExecOptions,
                        required_acks)
from ..obs import costs, fleet, health, profile, prom, slo
from ..obs.metrics import TIER_BYTES
from ..parallel.cluster import NODE_STATE_DOWN
from ..obs import span as obs_span
from ..obs.trace import Tracer
from ..sched import AdmissionError
from ..ops import kernels
from ..ops.calibrate import calibration_snapshot
from ..pql import ParseError, parse_string
from ..utils.stats import ExpvarStats
from ..wire import (PROTOBUF_CT, BlockDataRequest, BlockDataResponse,
                    ColumnAttrSet, CreateFrameMessage, CreateIndexMessage,
                    DeleteFrameMessage, DeleteIndexMessage, FrameMeta,
                    ImportRequest, ImportResponse, IndexMeta,
                    MaxSlicesResponse, QueryRequest, QueryResponse,
                    attrs_to_proto, result_to_proto, unmarshal_message)

VERSION = "0.1.0"


def parse_staleness(raw: str) -> float:
    """X-Pilosa-Staleness / ?staleness= in seconds: a bare number is
    milliseconds, anything else a duration ("500ms", "2s"). A value that
    does not parse is 0, a strict read: a typo never buys a staler
    answer."""
    raw = raw.strip()
    if not raw:
        return 0.0
    try:
        return max(0.0, float(raw) / 1e3)
    except ValueError:
        pass
    try:
        return max(0.0, parse_duration(raw))
    except (ValueError, KeyError):
        return 0.0

# GET /: a page that sends PQL to /index/{i}/query and shows /schema.
_WEBUI_PAGE = """<!doctype html>
<html><head><title>pilosa-tpu-torch</title></head>
<body style="font-family:monospace">
<h1>pilosa-tpu-torch</h1>
<p>index <input id="idx" value="i"> <button onclick="run()">query</button></p>
<textarea id="q" rows="6" cols="80">Count(Bitmap(rowID=0, frame=f))</textarea>
<pre id="out"></pre><h2>schema</h2><pre id="schema"></pre>
<script>
const $ = id => document.getElementById(id);
async function run() {
  const r = await fetch('/index/' + $('idx').value + '/query',
                        {method: 'POST', body: $('q').value});
  $('out').textContent = JSON.stringify(await r.json(), null, 1);
}
fetch('/schema').then(r => r.json()).then(
  s => { $('schema').textContent = JSON.stringify(s, null, 1); });
</script></body></html>
"""


class Response(NamedTuple):
    status: int
    headers: Dict[str, str]
    body: bytes

    def json(self):
        return json.loads(self.body.decode() or "null")


def _json_resp(obj, status: int = 200) -> Response:
    return Response(status, {"Content-Type": "application/json"},
                    (json.dumps(obj) + "\n").encode())


def _error_status(err: Exception) -> int:
    if isinstance(err, DeadlineExceededError):
        return 504
    if isinstance(err, AdmissionError):
        return 429
    if isinstance(err, (WriteBackpressureError, WriteConsistencyError)):
        return 503
    if isinstance(err, (SliceUnavailableError, ClientError)):
        return 500
    if isinstance(err, (IndexNotFoundError, FrameNotFoundError,
                        FragmentNotFoundError, FieldNotFoundError)):
        return 404
    if isinstance(err, (IndexExistsError, FrameExistsError)):
        return 409
    # Before ValueError -> 400: a value outside the declared range is a
    # semantic rejection, not a malformed request.
    if isinstance(err, FieldValueError):
        return 422
    if isinstance(err, (PilosaError, ParseError, ValueError, KeyError,
                        TypeError)):
        return 400
    return 500


def _error_resp(e: Exception) -> Response:
    """{"error": message} at _error_status's code; a shed write carries
    Retry-After (whole seconds, >= 1), as the JAX handler's does."""
    status = _error_status(e)
    msg = str(e) or type(e).__name__
    if status == 500 and not isinstance(e, (SliceUnavailableError,
                                            ClientError)):
        msg = f"internal error: {type(e).__name__}: {e}"
    resp = _json_resp({"error": msg}, status)
    if isinstance(e, (WriteBackpressureError, WriteConsistencyError)):
        retry = max(1, int(round(e.retry_after_s)))
        resp.headers["Retry-After"] = str(retry)
    return resp


def _proto_resp(msg, status: int = 200) -> Response:
    return Response(status, {"Content-Type": PROTOBUF_CT}, msg.encode())


def _result_to_json(result):
    if isinstance(result, Row):
        return {"attrs": result.attrs,
                "bits": [int(c) for c in result.columns()]}
    if isinstance(result, list):  # TopN pairs
        return [{"id": int(k), "count": int(n)} for k, n in result]
    return result  # int, bool, a Sum/Min/Max {value, count}, or None


def frame_meta(f) -> FrameMeta:
    """A frame's FrameMeta (CreateFrame messages, NodeStatus); its
    integer fields as the JSON list of their dicts."""
    return FrameMeta(
        row_label=f.row_label, inverse_enabled=f.inverse_enabled,
        cache_type=f.meta["cacheType"], cache_size=int(f.meta["cacheSize"]),
        time_quantum=str(f.time_quantum),
        fields_json=json.dumps([s.to_dict()
                                for _, s in sorted(f.fields.items())])
        if f.fields else "")


def _decode_options(body: bytes, mapping: Dict[str, str]) -> dict:
    doc = json.loads(body.decode() or "{}")
    if not isinstance(doc, dict):
        raise ValueError("request body must be a JSON object")
    raw = doc.get("options", {})
    if not isinstance(raw, dict):
        raise ValueError("options must be a JSON object")
    out = {}
    for k, v in raw.items():
        if k not in mapping:
            raise ValueError(f"unknown option: {k}")
        out[mapping[k]] = v
    return out


class Route(NamedTuple):
    method: str
    pattern: re.Pattern
    fn: Callable


class Handler:
    """Transport-agnostic request handler bound to a Holder + Executor."""

    def __init__(self, holder, executor, client_factory=None, stats=None,
                 tracer=None, cluster=None, host: str = "", broadcaster=None,
                 broadcast_handler=None, status_handler=None):
        self.holder = holder
        self.executor = executor
        # The cluster (parallel.cluster.Cluster; None: one node) and this
        # node's host in it: /hosts, /fragment/nodes and the import's
        # ownership check read them.
        self.cluster = cluster
        self.host = host
        # Schema changes go to the peers through the broadcaster
        # (parallel.broadcast); the Server applies what arrives at
        # /internal/message (broadcast_handler.receive_message) and
        # answers /status and /internal/status (status_handler's
        # cluster_status and local_status). None: not served (501).
        self.broadcaster = broadcaster
        self.broadcast_handler = broadcast_handler
        self.status_handler = status_handler
        # Hinted handoff (parallel.hints.HintManager, a Server wires it)
        # and [cluster] write-consistency: with hints an /import is
        # copied to the slice's other owners (?remote=true legs apply
        # here only) and the misses journaled.
        self.hints = None
        self.write_consistency = "quorum"
        # [cluster] default-read-staleness, seconds: the bound of a read
        # that brings none (0: strict).
        self.default_read_staleness = 0.0
        # The trace rings behind /debug/queries (a server passes one
        # sized by [obs]).
        self.tracer = tracer if tracer is not None else Tracer()
        # [cluster] query-deadline, seconds (0: none): the deadline of a
        # query that brings none.
        self.default_deadline = 0.0
        # [obs] profile-sample-rate: 0 profiles only ?profile=true; N
        # also every Nth query, into pilosa_query_phase_us.
        self.profile_sample_rate = 0
        self._profile_seq = itertools.count(1)
        # [obs] cost-debt-threshold: a tenant whose share of the device
        # time passes it gets X-Pilosa-Cost-Debt (<= 0: never).
        self.cost_debt_threshold = 0.5
        # The query scheduler (sched.QueryScheduler; a Server wires it
        # when [sched] is enabled). None: no admission.
        self.scheduler = None
        # The server's half of /readyz: open() done and close() not
        # begun. None: serving.
        self.ready_fn = None
        # Every query outcome, once ([slo]; None: no accounting).
        self.slo = slo.SLORecorder()
        # client_factory(host) -> api.client.InternalClient: frame restore
        # pulls a frame's fragments through it (None: 501).
        self.client_factory = client_factory
        # The stats client the holder records into (a server passes its
        # ExpvarStats); the handler adds query.<Call> counts and the
        # query.us timing.
        self.stats = stats if stats is not None else ExpvarStats()
        self.version = VERSION
        self._start_time = time.monotonic()
        # The fragment gauges are walked at most once in this many
        # seconds ([obs] metrics-sample-interval).
        self.metrics_sample_interval = 10.0
        self._frag_sample: Tuple[float, list] = (0.0, [])
        self._frag_sample_mu = threading.Lock()
        # The fleet pane behind /debug/fleet (obs.fleet.FleetAggregator
        # over the cluster's members, built at its first request): its
        # cache, [obs] fleet-scrape-interval (a Server sets it), and
        # each peer's scrape deadline, seconds.
        self.fleet_scrape_interval = 5.0
        self.fleet_scrape_deadline = 2.0
        self._fleet_agg = None
        self._fleet_mu = threading.Lock()
        # Guards /debug/pprof/heap's tracemalloc starts and stops.
        self._tracemalloc_mu = threading.Lock()
        self._tracemalloc_ours = False
        self._prom = prom.Registry()
        self._register_collectors()
        self._routes: List[Route] = []
        r = self._add_route
        r("GET", r"/", self._get_webui)
        r("GET", r"/index", self._get_indexes)
        r("GET", r"/index/(?P<index>[^/]+)", self._get_index)
        r("POST", r"/index/(?P<index>[^/]+)", self._post_index)
        r("DELETE", r"/index/(?P<index>[^/]+)", self._delete_index)
        r("PATCH", r"/index/(?P<index>[^/]+)/time-quantum",
          self._patch_index_time_quantum)
        r("POST", r"/index/(?P<index>[^/]+)/query", self._post_query)
        r("POST", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)",
          self._post_frame)
        r("DELETE", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)",
          self._delete_frame)
        r("PATCH",
          r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/time-quantum",
          self._patch_frame_time_quantum)
        r("POST", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/restore",
          self._post_frame_restore)
        r("GET", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/views",
          self._get_frame_views)
        r("POST", r"/import", self._post_import)
        r("GET", r"/export", self._get_export)
        r("GET", r"/fragment/data", self._get_fragment_data)
        r("POST", r"/fragment/data", self._post_fragment_data)
        r("GET", r"/fragment/blocks", self._get_fragment_blocks)
        r("GET", r"/fragment/block/data", self._get_fragment_block_data)
        r("GET", r"/fragment/nodes", self._get_fragment_nodes)
        r("GET", r"/hosts", self._get_hosts)
        r("GET", r"/status", self._get_status)
        r("POST", r"/internal/message", self._post_internal_message)
        r("GET", r"/internal/status", self._get_internal_status)
        r("GET", r"/internal/epochs", self._get_internal_epochs)
        r("POST", r"/internal/epochs/advance",
          self._post_internal_epochs_advance)
        r("POST", r"/index/(?P<index>[^/]+)/attr/diff",
          self._post_index_attr_diff)
        r("POST", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/attr/diff",
          self._post_frame_attr_diff)
        r("GET", r"/schema", self._get_schema)
        r("GET", r"/slices/max", self._get_slice_max)
        r("GET", r"/version", self._get_version)
        r("GET", r"/debug/vars", self._get_expvar)
        r("GET", r"/metrics", self._get_metrics)
        r("GET", r"/healthz", self._get_healthz)
        r("GET", r"/readyz", self._get_readyz)
        r("GET", r"/debug/health", self._get_debug_health)
        r("GET", r"/debug/bundle", self._get_debug_bundle)
        r("GET", r"/debug/slo", self._get_debug_slo)
        r("GET", r"/debug/costs", self._get_debug_costs)
        r("GET", r"/debug/queries", self._get_debug_queries)
        r("GET", r"/debug/traces/(?P<tid>[^/]+)", self._get_debug_trace)
        r("GET", r"/debug/queryshapes", self._get_debug_queryshapes)
        r("GET", r"/debug/fleet", self._get_debug_fleet)
        r("GET", r"/debug/pprof/profile", self._get_cpu_profile)
        r("GET", r"/debug/pprof/heap", self._get_heap_profile)
        r("GET", r"/debug/pprof/allocs", self._get_heap_profile)
        r("GET", r"/debug/pprof/(?P<kind>block|mutex)",
          self._get_block_profile)
        r("GET", r"/debug/pprof/trace", self._get_trace)
        r("GET", r"/debug/pprof/goroutine", self._get_thread_dump)
        r("GET", r"/debug/pprof/threadcreate", self._get_threadcreate)
        r("GET", r"/debug/pprof/cmdline", self._get_cmdline)
        r("GET", r"/debug/pprof/?", self._get_pprof)

    def _add_route(self, method: str, pattern: str, fn: Callable):
        self._routes.append(Route(method, re.compile("^" + pattern + "$"), fn))

    def handle(self, method: str, path: str,
               params: Optional[Dict[str, str]] = None,
               headers: Optional[Dict[str, str]] = None,
               body: bytes = b"") -> Response:
        params = params or {}
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        path_matched = False
        for route in self._routes:
            m = route.pattern.match(path)
            if m is None:
                continue
            path_matched = True
            if route.method != method:
                continue
            try:
                return route.fn(m.groupdict(), params, headers, body)
            except Exception as e:  # noqa: BLE001 — never drop the connection
                return _error_resp(e)
        if path_matched:
            return _json_resp({"error": "method not allowed"}, 405)
        return _json_resp({"error": "not found"}, 404)

    def _accepts_proto(self, headers) -> bool:
        return PROTOBUF_CT in headers.get("accept", "")

    def _sends_proto(self, headers) -> bool:
        return PROTOBUF_CT in headers.get("content-type", "")

    def _fragment_args(self, params):
        return (params["index"], params["frame"],
                params.get("view", "standard"), int(params["slice"]))

    def _fragment(self, params):
        frag = self.holder.fragment(*self._fragment_args(params))
        if frag is None:
            raise FragmentNotFoundError()
        return frag

    # -- read-only routes ------------------------------------------------------

    def _get_webui(self, pv, params, headers, body) -> Response:
        return Response(200, {"Content-Type": "text/html"},
                        _WEBUI_PAGE.encode())

    def _get_version(self, pv, params, headers, body) -> Response:
        return _json_resp({"version": VERSION})

    def _get_schema(self, pv, params, headers, body) -> Response:
        return _json_resp({"indexes": self.holder.schema()})

    def _get_indexes(self, pv, params, headers, body) -> Response:
        return self._get_schema(pv, params, headers, body)

    def _get_index(self, pv, params, headers, body) -> Response:
        idx = self.holder.index(pv["index"])
        if idx is None:
            raise IndexNotFoundError()
        return _json_resp({"index": idx.to_dict()})

    def _get_slice_max(self, pv, params, headers, body) -> Response:
        if params.get("inverse") == "true":
            maxes = self.holder.max_inverse_slices()
        else:
            maxes = self.holder.max_slices()
        if self._accepts_proto(headers):
            return _proto_resp(MaxSlicesResponse(max_slices=maxes))
        return _json_resp({"maxSlices": maxes})

    # -- replica convergence ------------------------------------------------------

    def queue_depth(self) -> int:
        """This node's load signal in the epoch digest: the scheduler's
        queued queries plus those in flight (0 without one)."""
        if self.scheduler is None:
            return 0
        try:
            d = self.scheduler.snapshot()
            return int(d.get("queued", 0)) + int(d.get("inflight", 0))
        except Exception:  # noqa: BLE001 — a load signal only
            return 0

    def _get_internal_epochs(self, pv, params, headers, body) -> Response:
        """The replication-epoch digest peers read on their status poll
        (the JAX handler's, pilosa_tpu/api/handler.py:2867-2886)."""
        return _json_resp({"host": self.host,
                           "epochs": self.holder.fragment_epochs(),
                           "queue_depth": self.queue_depth()})

    def _post_internal_epochs_advance(self, pv, params, headers,
                                      body) -> Response:
        """Floor-raise the epochs of known fragments (a hint replay's or
        anti-entropy's reconcile). Raising is the only direction, an
        unknown fragment or a malformed entry is skipped: a push never
        makes state."""
        try:
            epochs = json.loads(body or b"{}").get("epochs") or {}
        except (ValueError, AttributeError):
            return _json_resp({"error": "bad epoch advance body"}, 400)
        applied = 0
        for key, epoch in epochs.items():
            parts = str(key).split("/")
            if len(parts) != 4:
                continue
            try:
                slice_, epoch = int(parts[3]), int(epoch)
            except ValueError:
                continue
            frag = self.holder.fragment(parts[0], parts[1], parts[2], slice_)
            if frag is None:
                continue
            try:
                before = frag.epoch
                if frag.advance_epoch(epoch) > before:
                    applied += 1
            except Exception:  # noqa: BLE001 — one bad fragment
                continue
        return _json_resp({"applied": applied})

    def _post_index_attr_diff(self, pv, params, headers, body) -> Response:
        idx = self.holder.index(pv["index"])
        if idx is None:
            raise IndexNotFoundError()
        return self._attr_diff(idx.column_attr_store, body)

    def _post_frame_attr_diff(self, pv, params, headers, body) -> Response:
        f = self.holder.frame(pv["index"], pv["frame"])
        if f is None:
            raise FrameNotFoundError()
        return self._attr_diff(f.row_attr_store, body)

    def _attr_diff(self, store, body: bytes) -> Response:
        """The attrs of every block of this store that the sender lacks
        or holds otherwise, by the sender's block checksums."""
        req = json.loads(body.decode() or "{}")
        theirs = [(int(b["id"]), bytes.fromhex(b["checksum"]))
                  for b in req.get("blocks", [])]
        attrs = {}
        for bid in diff_blocks(theirs, store.blocks()):
            attrs.update({str(k): v
                          for k, v in store.block_data(bid).items()})
        return _json_resp({"attrs": attrs})

    # -- the cluster's routes ---------------------------------------------------

    def _get_hosts(self, pv, params, headers, body) -> Response:
        nodes = self.cluster.nodes if self.cluster else []
        return _json_resp([n.to_dict() for n in nodes])

    def _get_fragment_nodes(self, pv, params, headers, body) -> Response:
        nodes = (self.cluster.fragment_nodes(params["index"],
                                             int(params["slice"]))
                 if self.cluster else [])
        return _json_resp([n.to_dict() for n in nodes])

    def _get_status(self, pv, params, headers, body) -> Response:
        """This node's status and the peers' last known ones."""
        if self.status_handler is None:
            return _json_resp({"error": "status not supported"}, 501)
        status = self.status_handler.cluster_status()
        if self._accepts_proto(headers):
            return _proto_resp(status)
        return _json_resp({"nodes": [{
            "host": n.host, "state": n.state,
            "indexes": [{"name": i.name, "maxSlice": i.max_slice,
                         "frames": [f.name for f in i.frames]}
                        for i in n.indexes]} for n in status.nodes]})

    def _post_internal_message(self, pv, params, headers,
                               body) -> Response:
        if self.broadcast_handler is None:
            return _json_resp({"error": "broadcast not supported"}, 501)
        self.broadcast_handler.receive_message(unmarshal_message(body))
        return _json_resp({})

    def _get_internal_status(self, pv, params, headers, body) -> Response:
        if self.status_handler is None:
            return _json_resp({"error": "status not supported"}, 501)
        return _proto_resp(self.status_handler.local_status())

    # -- bulk data in and out --------------------------------------------------

    def _post_import(self, pv, params, headers, body) -> Response:
        """_post_import_inner with its outcome recorded under route
        "import" (no latency: batch imports must not dilute the query
        latency SLI), metered into the tenant's ("import") account of
        the cost ledger (its op and WAL bytes)."""
        tenant = headers.get("x-pilosa-tenant", "") or "default"
        cost_token = None
        if costs.LEDGER.enabled:
            ctx, cost_token = costs.activate(self._tenant_label(tenant))
            ctx.shape = "import"
            costs.LEDGER.charge("queries", 1)
        try:
            if self.slo is None:
                return self._post_import_inner(pv, params, headers, body)
            try:
                resp = self._post_import_inner(pv, params, headers, body)
            except Exception as e:
                self.slo.record(slo.outcome_for_status(_error_status(e)),
                                tenant=tenant, route="import")
                raise
            self.slo.record(slo.outcome_for_status(resp.status),
                            tenant=tenant, route="import")
            return resp
        finally:
            if cost_token is not None:
                costs.deactivate(cost_token)

    def _post_import_inner(self, pv, params, headers, body) -> Response:
        """A protobuf ImportRequest into Frame.import_bits. A timestamp
        of 0 means none; the others are seconds since the epoch, read as
        UTC (numpy's datetime64 from the integer, which is
        datetime.fromtimestamp(t, timezone.utc) without its zone, the
        JAX handler's conversion)."""
        req = ImportRequest.decode(body)
        if (self.cluster is not None and self.host
                and not self.cluster.owns_fragment(self.host, req.index,
                                                   req.slice)):
            return _json_resp(
                {"error": f"host does not own slice {req.slice}"}, 412)
        idx = self.holder.index(req.index)
        if idx is None:
            raise IndexNotFoundError()
        f = idx.frame(req.frame)
        if f is None:
            raise FrameNotFoundError()
        timestamps = None
        if len(req.timestamps):
            timestamps = req.timestamps.astype("datetime64[s]")
            timestamps[req.timestamps == 0] = np.datetime64("NaT")
        coord = None
        if (params.get("remote", "").lower() != "true"
                and self.hints is not None and self.cluster is not None
                and self.client_factory is not None):
            coord = self._import_precheck(req)  # may 503 before applying
        f.import_bits(req.row_ids, req.column_ids, timestamps)
        if coord is not None:
            self._import_replicate(req, coord)
        if self._accepts_proto(headers):
            return _proto_resp(ImportResponse())
        return _json_resp({})

    def _import_precheck(self, req):
        """Before the local apply: the slice's other owners split into
        live and known DOWN, and a 503 when write-consistency cannot be
        reached. (live, down, required, level), or None when this node
        is the only owner."""
        owners = self.cluster.fragment_nodes(req.index, req.slice)
        others = [n for n in owners if n.host != self.host]
        if not others:
            return None
        level = self.write_consistency
        required = required_acks(level, len(owners))
        down = [n for n in others if n.state == NODE_STATE_DOWN]
        live = [n for n in others if n.state != NODE_STATE_DOWN]
        if 1 + len(live) < required:
            CONSISTENCY_STATS.inc(f"{level}:rejected_unavailable")
            raise WriteConsistencyError(
                f"import: write-consistency={level} needs {required} of "
                f"{len(owners)} replicas, only {1 + len(live)} reachable",
                level=level, required=required, acked=0)
        return live, down, required, level

    def _import_replicate(self, req, coord) -> None:
        """After the local apply: the batch to the live owners in
        parallel with ?remote=true, a hint for every owner it missed
        (with the epochs the local apply reached, which the executor's
        tracker observes now), and a 503 when the acks fall short (the
        hints are durable already, so a client's retry is safe)."""
        live, down, required, level = coord
        ts = req.timestamps if len(req.timestamps) else None
        epochs = {}
        f = self.holder.frame(req.index, req.frame)
        for vname, view in (list(f.views.items()) if f is not None else []):
            frag = view.fragments.get(req.slice)
            if frag is not None and not frag._pending_load:
                key = f"{req.index}/{req.frame}/{vname}/{req.slice}"
                epochs[key] = frag.epoch
                self.executor.epochs.observe_local(key, frag.epoch)

        def send(node):
            self.client_factory(node.host).import_bits(
                req.index, req.frame, req.slice, req.row_ids,
                req.column_ids, ts, remote=True)

        failures = []
        futs = [(n, self.executor._pool.submit(send, n)) for n in live]
        for n, fut in futs:
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 — collected
                failures.append((n.host, e))
        for host in [n.host for n in down] + [h for h, _ in failures]:
            self.hints.enqueue_import(host, req.index, req.frame, req.slice,
                                      req.row_ids, req.column_ids, ts,
                                      epochs=epochs)
        acked = 1 + len(live) - len(failures)
        if acked >= required:
            CONSISTENCY_STATS.inc(
                f"{level}:hinted" if (down or failures) else f"{level}:ok")
            return
        CONSISTENCY_STATS.inc(f"{level}:below_consistency")
        raise WriteConsistencyError(
            f"import: write-consistency={level}: {acked} of {required} "
            f"required replica acks ({len(failures)} failed mid-import; "
            f"misses journaled as hints)",
            level=level, required=required, acked=acked)

    def _get_export(self, pv, params, headers, body) -> Response:
        """Every bit of one fragment as `row,col` lines."""
        rows, cols = self._fragment(params).bits()
        text = "".join(f"{r},{c}\n" for r, c in zip(rows.tolist(),
                                                     cols.tolist()))
        return Response(200, {"Content-Type": "text/csv"}, text.encode())

    def _get_fragment_data(self, pv, params, headers, body) -> Response:
        buf = io.BytesIO()
        self._fragment(params).write_to_tar(buf)
        return Response(200, {"Content-Type": "application/octet-stream"},
                        buf.getvalue())

    def _post_fragment_data(self, pv, params, headers, body) -> Response:
        index, frame, view, slice_ = self._fragment_args(params)
        f = self.holder.frame(index, frame)
        if f is None:
            raise FrameNotFoundError()
        frag = f.create_view_if_not_exists(view).create_fragment_if_not_exists(
            slice_)
        frag.read_from_tar(io.BytesIO(body))
        return _json_resp({})

    def _get_fragment_blocks(self, pv, params, headers, body) -> Response:
        blocks = [{"id": bid, "checksum": cs.hex()}
                  for bid, cs in self._fragment(params).blocks()]
        return _json_resp({"blocks": blocks})

    def _get_fragment_block_data(self, pv, params, headers,
                                 body) -> Response:
        if body:
            req = BlockDataRequest.decode(body)
        else:
            req = BlockDataRequest(
                index=params["index"], frame=params["frame"],
                view=params.get("view", "standard"),
                slice=int(params["slice"]), block=int(params["block"]))
        frag = self.holder.fragment(req.index, req.frame, req.view, req.slice)
        if frag is None:
            raise FragmentNotFoundError()
        rows, cols = frag.block_data(req.block)
        if self._accepts_proto(headers):
            return _proto_resp(BlockDataResponse(row_ids=rows,
                                                 column_ids=cols))
        return _json_resp({"rowIDs": rows.tolist(),
                           "columnIDs": cols.tolist()})

    def _post_frame_restore(self, pv, params, headers, body) -> Response:
        """Pull every fragment of every view of a frame from the node at
        ?host= (its /slices/max, the frame's /views, then /fragment/data
        a slice; an absent fragment is skipped)."""
        host = params.get("host")
        if not host:
            return _json_resp({"error": "host required"}, 400)
        if self.client_factory is None:
            return _json_resp({"error": "restore not supported"}, 501)
        index, frame = pv["index"], pv["frame"]
        f = self.holder.frame(index, frame)
        if f is None:
            raise FrameNotFoundError()
        client = self.client_factory(host)
        maxes = client.max_slices()
        inverse_maxes = client.max_slices(inverse=True)
        for view_name in client.frame_views(index, frame):
            v = f.create_view_if_not_exists(view_name)
            # Inverse views are sliced over rows, the others over columns.
            n = (inverse_maxes if view_name.startswith(VIEW_INVERSE)
                 else maxes).get(index, 0)
            for slice_ in range(n + 1):
                data = client.fragment_data(index, frame, view_name, slice_)
                if data is not None:
                    v.create_fragment_if_not_exists(slice_).read_from_tar(
                        io.BytesIO(data))
        return _json_resp({})

    def _post_index(self, pv, params, headers, body) -> Response:
        opts = _decode_options(body, {"columnLabel": "column_label",
                                      "timeQuantum": "time_quantum"})
        idx = self.holder.create_index(pv["index"], **opts)
        if self.broadcaster is not None:
            self.broadcaster.send_sync(CreateIndexMessage(
                index=idx.name, meta=IndexMeta(
                    column_label=idx.column_label,
                    time_quantum=str(idx.time_quantum))))
        return _json_resp({})

    def _delete_index(self, pv, params, headers, body) -> Response:
        self.holder.delete_index(pv["index"])
        self.executor.invalidate_device_index(pv["index"])
        if self.broadcaster is not None:
            self.broadcaster.send_sync(DeleteIndexMessage(index=pv["index"]))
        return _json_resp({})

    def _delete_frame(self, pv, params, headers, body) -> Response:
        idx = self.holder.index(pv["index"])
        if idx is None:
            raise IndexNotFoundError()
        idx.delete_frame(pv["frame"])
        self.executor.invalidate_device_index(pv["index"])
        if self.broadcaster is not None:
            self.broadcaster.send_sync(DeleteFrameMessage(
                index=pv["index"], frame=pv["frame"]))
        return _json_resp({})

    def _get_expvar(self, pv, params, headers, body) -> Response:
        """The stats client's snapshot, uptime and version, and the
        `storage`, `integrity`, `mesh` and `count_calibration` parts of
        the JAX handler's /debug/vars
        (pilosa_tpu/api/handler.py:1497-1530)."""
        wal = WAL_STATS.copy()
        snapshot = getattr(self.stats, "snapshot", None)  # NopStats: none
        out = snapshot() if snapshot is not None else {}
        out["uptime_seconds"] = round(time.monotonic() - self._start_time, 3)
        out["version"] = self.version
        out |= {"storage": {"fragments": self.holder.storage_state(),
                            "wal": wal,
                            **GROUP_SIZE.snapshot("group_size"),
                            **SNAPSHOT_US.snapshot("snapshot_us")},
               "integrity": {"scrub": self.holder.scrubber.snapshot(),
                             "shadow": SHADOW_STATS.copy(),
                             "fragments": INTEGRITY_STATS.copy(),
                             "torn_tails": wal.get("torn_tails", 0)},
               "kernel_launches": dict(kernels.LAUNCHES)}
        hc = getattr(self.executor, "host_cache_stats", None)
        if hc:
            out["host_cache"] = dict(hc)
        cc = getattr(self.executor, "client", None)
        cluster = {}
        cstats = getattr(cc, "stats", None)
        if cstats is not None and hasattr(cstats, "copy"):
            cluster = dict(cstats.copy())
            breakers = getattr(cc, "breakers", None)
            if breakers is not None:
                cluster["breakers"] = breakers.snapshot()
        if self.cluster is not None:
            cluster["members"] = self.cluster.node_states()
            cluster["resplits"] = self.executor.stats.get("resplit", 0)
        if cluster:
            out["cluster"] = cluster
        if self.hints is not None:
            out["hints"] = self.hints.snapshot()
        if self.scheduler is not None:
            out["sched"] = self.scheduler.snapshot()
        mgr = self.executor._mesh_mgr
        if mgr is not None:
            mesh = dict(mgr.stats)
            mesh["hbm"] = {"budget_bytes": max(0, mgr._hbm_budget_bytes()),
                           **mgr.device_memory()}
            mesh["quarantined_plans"] = mgr.quarantined_plans()
            out["mesh"] = mesh
        cal = calibration_snapshot()
        if cal is not None:
            out["count_calibration"] = cal
        out["epochs"] = self.executor.epochs.snapshot()
        out["result_cache"] = self.executor.result_cache.snapshot()
        return _json_resp(out)

    # -- /metrics --------------------------------------------------------------

    def _get_metrics(self, pv, params, headers, body) -> Response:
        """Prometheus text exposition (format 0.0.4) of every store the
        port has, bridged at scrape time; ?exemplars=true adds the trace
        ids of the latency buckets (OpenMetrics exemplar syntax)."""
        return Response(
            200,
            {"Content-Type": "text/plain; version=0.0.4; charset=utf-8"},
            self._prom.render(
                exemplars=params.get("exemplars") == "true").encode())

    def _register_collectors(self):
        reg = self._prom
        reg.register_collector(lambda: prom.expvar_families(self.stats))
        for fn in (self._collect_runtime, self._collect_device,
                   self._collect_host_cache, self._collect_cluster,
                   self._collect_tiers,
                   self._collect_membership, self._collect_hints,
                   self._collect_routes, self._collect_read_path,
                   self._collect_sched,
                   self._collect_fragments, self._collect_storage,
                   self._collect_integrity, self._collect_slo,
                   self._collect_flight, health.families,
                   profile.STATS.families, costs.families):
            reg.register_collector(fn)

    def _collect_read_path(self) -> list:
        """The replica picks by class and the result cache's events and
        size (the JAX handler's families)."""
        fams = []
        ex = self.executor
        picks = ex.read_stats.copy()
        if picks:
            fam = prom.MetricFamily(
                "pilosa_read_replica_total", "counter",
                "Read-path slice placements by replica class (owner = "
                "the strict ring pick, follower = spread to an in-sync "
                "replica, fallback_owner = a bounded read with no "
                "eligible follower) and staleness class (strict = "
                "X-Pilosa-Staleness absent/0, bounded = a positive "
                "budget).")
            for k, v in sorted(picks.items()):
                pick, _, sclass = k.partition("|")
                fam.add(v, {"replica": pick, "staleness": sclass or "strict"})
            fams.append(fam)
        events = ex.result_cache.stats.copy()
        if events:
            fam = prom.MetricFamily(
                "pilosa_result_cache_events_total", "counter",
                "Epoch-keyed result cache events: hit / miss / "
                "invalidate (an entry keyed to a superseded epoch) / "
                "evict (LRU) / bypass (strict or uncacheable query).")
            for k, v in sorted(events.items()):
                fam.add(v, {"event": k})
            fams.append(fam)
        fams.append(prom.MetricFamily(
            "pilosa_result_cache_entries", "gauge",
            "Entries currently held by the epoch-keyed result "
            "cache.").add(len(ex.result_cache)))
        return fams

    def _collect_sched(self) -> list:
        """Queue depth by tenant ("all" the total), sheds by reason,
        admissions by path, expiries, queue waits and cohort sizes;
        nothing without a scheduler."""
        s = self.scheduler
        if s is None:
            return []
        depth = prom.MetricFamily(
            "pilosa_sched_queue_depth", "gauge",
            "Admitted queries waiting for dispatch, by tenant "
            "('all' = total).")
        for tenant, n in sorted(s.queue_depths().items()):
            depth.add(n, {"tenant": tenant})
        st = s.stats.copy()
        shed = prom.MetricFamily(
            "pilosa_sched_shed_total", "counter",
            "Requests shed at admission (HTTP 429), by reason.")
        shed.add(st.get("shed_deadline", 0), {"reason": "deadline"})
        shed.add(st.get("shed_queue_full", 0), {"reason": "queue_full"})
        adm = prom.MetricFamily(
            "pilosa_sched_admitted_total", "counter",
            "Admitted queries by path (fastpath = idle, no queuing).")
        adm.add(st.get("fastpath", 0), {"path": "fastpath"})
        adm.add(st.get("queued", 0), {"path": "queued"})
        exp = prom.MetricFamily(
            "pilosa_sched_expired_total", "counter",
            "Queries whose deadline expired while queued (HTTP 504).")
        exp.add(st.get("expired_in_queue", 0))
        wait = prom.MetricFamily(
            "pilosa_sched_wait_microseconds", "histogram",
            "Queue wait from admission to dispatch (log2 buckets, µs).")
        wait.add_histogram(s.wait_hist)
        batch = prom.MetricFamily(
            "pilosa_sched_batch_size", "histogram",
            "Released cohort sizes (>1 = coalesced arrivals).")
        batch.add_histogram(s.batch_hist)
        return [depth, shed, adm, exp, wait, batch]

    def _collect_slo(self) -> list:
        return [] if self.slo is None else self.slo.families()

    def _collect_flight(self) -> list:
        """The flight recorder's ring: shapes held, capacity, evictions."""
        st = self.executor.flight.stats()
        return [prom.MetricFamily(
                    "pilosa_queryshape_tracked", "gauge",
                    "Query shapes currently held by the flight recorder "
                    "ring.").add(st["shapes"]),
                prom.MetricFamily(
                    "pilosa_queryshape_ring", "gauge",
                    "Flight recorder ring capacity ([obs] "
                    "queryshape-ring).").add(st["ring"]),
                prom.MetricFamily(
                    "pilosa_queryshape_evicted_total", "counter",
                    "Query shapes evicted from the flight recorder ring "
                    "(LRU).").add(st["evicted"])]

    # -- the query's own record and the liveness plane -------------------------

    def _get_debug_slo(self, pv, params, headers, body) -> Response:
        if self.slo is None:
            return _json_resp({"error": "slo accounting disabled"}, 404)
        return _json_resp(self.slo.status())

    def _get_debug_queryshapes(self, pv, params, headers, body) -> Response:
        """Per-shape traffic, latency, routes, staged bytes and shadow
        checks. ?sort=cost|p99|routed_host|count, ?limit=N."""
        return _json_resp(self.executor.flight.snapshot(
            sort=params.get("sort", "cost"),
            limit=int(params.get("limit", "50"))))

    def _get_debug_costs(self, pv, params, headers, body) -> Response:
        """The top (tenant, shape) accounts of every dimension and the
        baseline watch's bands. ?sort=device_us|hbm|staged|wal|net|
        queries|regression, ?limit=N."""
        ledger = costs.LEDGER
        limit = int(params.get("limit", "50"))
        doc = ledger.snapshot(sort=params.get("sort", "device_us"),
                              limit=limit, watch=costs.WATCH)
        doc["enabled"] = ledger.enabled
        doc["regression"] = {
            "active": [{"shape": s_, "dimension": d}
                       for s_, d in costs.WATCH.active()],
            "bands": costs.WATCH.snapshot(limit=limit)}
        doc["debt_threshold"] = self.cost_debt_threshold
        return _json_resp(doc)

    def _get_debug_queries(self, pv, params, headers, body) -> Response:
        """The recent and slow trace rings, newest first; ?threshold_us=N
        refilters the recent ring."""
        snap = self.tracer.snapshot()
        if "threshold_us" in params:
            thr = float(params["threshold_us"])
            snap["slow"] = [t for t in snap["recent"]
                            if t["duration_us"] >= thr]
            snap["slow_threshold_us"] = thr
        return _json_resp(snap)

    def _get_debug_trace(self, pv, params, headers, body) -> Response:
        tr = self.tracer.get(pv["tid"])
        if tr is None:
            return _json_resp({"error": "trace not found"}, 404)
        return _json_resp(tr.to_dict())

    def _get_healthz(self, pv, params, headers, body) -> Response:
        """Liveness: 200 while the watchdog sweeps. A stalled subsystem
        does not flip it (that is /readyz's)."""
        h = health.HEALTH
        if h.watchdog_alive():
            return _json_resp({"status": "ok", "watchdog": "alive" if
                               h.enabled and h._thread is not None
                               else "off"})
        return _json_resp({"status": "unhealthy", "watchdog": "dead"}, 503)

    def _get_readyz(self, pv, params, headers, body) -> Response:
        """Readiness: serving, and no critical subsystem stalled; 503
        with the reasons otherwise."""
        reasons = []
        if self.ready_fn is not None:
            try:
                if not self.ready_fn():
                    reasons.append("not-serving")
            except Exception:  # noqa: BLE001 — a broken probe: not serving
                reasons.append("not-serving")
        h = health.HEALTH
        reasons += [f"stalled:{name}" for name in h.stalled_critical()]
        if not h.watchdog_alive():
            reasons.append("watchdog-dead")
        if reasons:
            return _json_resp({"status": "unready", "reasons": reasons}, 503)
        return _json_resp({"status": "ok"})

    def _get_debug_health(self, pv, params, headers, body) -> Response:
        return _json_resp(health.HEALTH.snapshot())

    def _get_debug_bundle(self, pv, params, headers, body) -> Response:
        """The diagnostic dossier a watchdog trip writes, on demand;
        ?write=true also writes it under the data directory."""
        h = health.HEALTH
        doc = h.build_bundle(reason="on-demand")
        if params.get("write") == "true":
            try:
                doc["written_to"] = h.write_dossier(doc=doc)
            except OSError as e:
                doc["written_to"] = None
                doc["write_error"] = str(e)
        return Response(200, {"Content-Type": "application/json"},
                        h.encode_bundle(doc) + b"\n")

    # -- diagnosis: /debug/fleet and /debug/pprof ------------------------------

    def _fleet(self):
        """The fleet aggregator, built at first use; None without a
        cluster."""
        if self.cluster is None:
            return None
        with self._fleet_mu:
            if self._fleet_agg is None:
                self._fleet_agg = fleet.FleetAggregator(
                    members=self.cluster.node_states,
                    fetch=self._fleet_fetch,
                    interval=self.fleet_scrape_interval,
                    deadline=self.fleet_scrape_deadline,
                    breaker_state=self._fleet_breaker_state)
            return self._fleet_agg

    def _fleet_breaker_state(self, host: str) -> str:
        """The breaker state of `host` in the executor's cluster client
        ("" without one): the aggregator skips a peer whose breaker is
        open."""
        breakers = getattr(getattr(self.executor, "client", None),
                           "breakers", None)
        state = getattr(breakers, "state", None)
        return state(host) if callable(state) else ""

    def _fleet_fetch(self, host: str, path: str, timeout_s: float) -> str:
        """One scrape: this node answers through its own handler (fresh,
        never behind a breaker); a peer through the internal client,
        with its retries, the deadline and its breaker."""
        if host == self.host or self.client_factory is None:
            resp = self.handle("GET", path)
            if resp.status != 200:
                raise RuntimeError(f"local {path}: status={resp.status}")
            return resp.body.decode()
        status, data = self.client_factory(host)._do(
            "GET", path, deadline=time.monotonic() + timeout_s)
        if status != 200:
            raise RuntimeError(f"{host}{path}: status={status}")
        return data.decode()

    def _get_debug_fleet(self, pv, params, headers, body) -> Response:
        """The federated fleet pane: every member's /metrics and
        /debug/vars scraped (bounded concurrency, a deadline a node,
        breaker-aware, stale-tolerant) and the cumulative families
        merged exactly; cached fleet_scrape_interval seconds,
        ?force=true bypasses the cache. Without a cluster: 404."""
        agg = self._fleet()
        if agg is None:
            return _json_resp({"error": "fleet view requires a cluster"},
                              404)
        return _json_resp(agg.snapshot(force=params.get("force") == "true"))

    def _get_cpu_profile(self, pv, params, headers, body) -> Response:
        """Sampling CPU profile across every thread (Go's
        /debug/pprof/profile, net/http/pprof): sys._current_frames() at
        ~100 Hz for ?seconds=N (default 2, at most 30), answered as
        collapsed stacks ("frame;frame;frame N") for flamegraph.pl or
        speedscope. A sampler, not cProfile: cProfile sees only its own
        thread, and queries run on the server's and the card manager's
        threads."""
        from collections import Counter

        seconds = min(float(params.get("seconds", "2") or 2), 30.0)
        stacks: Counter = Counter()
        for _t, _name, parts in self._sample_stacks(seconds):
            stacks[";".join(parts)] += 1
        out = "".join(f"{stack} {n}\n" for stack, n in stacks.most_common())
        return Response(200, {"Content-Type": "text/plain; charset=utf-8"},
                        out.encode())

    # Frames that mean "this thread is waiting on synchronization, not
    # running": the sampling block/mutex profiles classify a sample as
    # waiting when any of its two innermost PYTHON frames matches (a
    # raw C-level Lock.acquire leaves no Python frame of its own, but
    # every composite wait — Condition.wait, Event.wait, queue.get,
    # Thread.join, selectors — runs these stdlib frames).
    _WAIT_FRAMES = frozenset((
        "threading.py:wait", "threading.py:acquire", "threading.py:join",
        "threading.py:_wait_for_tstate_lock", "queue.py:get",
        "queue.py:put", "selectors.py:select", "socket.py:accept",
        "socketserver.py:serve_forever"))
    # The mutex restriction matches only DIRECT lock waits by their
    # innermost Python frame (pure-Python RLock.acquire, Thread.join's
    # tstate lock) — a Condition/Event/queue wait also passes through
    # threading.py:wait, but classifying an idle queue consumer as
    # lock contention would misdiagnose healthy blocking as a lock
    # bottleneck, so composite waits belong to /block only. (A raw
    # C-level Lock.acquire leaves no Python frame at all and is
    # invisible to any Python sampler — documented limitation.)
    _MUTEX_FRAMES = frozenset((
        "threading.py:acquire", "threading.py:_wait_for_tstate_lock"))

    def _sample_stacks(self, seconds: float, interval: float = 0.01):
        """~1/interval Hz samples of every OTHER thread's stack:
        (t_offset_s, thread_name, [frame, ...] outermost-first).
        The shared engine under profile/block/mutex/trace."""
        import sys
        import time as _time

        me = threading.get_ident()
        samples = []
        t0 = _time.monotonic()
        deadline = t0 + seconds
        while _time.monotonic() < deadline:
            names = {t.ident: t.name for t in threading.enumerate()}
            now = _time.monotonic() - t0
            for tid, frame in list(sys._current_frames().items()):
                if tid == me:
                    continue
                parts = []
                f = frame
                while f is not None:
                    code = f.f_code
                    parts.append(f"{code.co_filename.rsplit('/', 1)[-1]}:"
                                 f"{code.co_name}")
                    f = f.f_back
                parts.reverse()
                samples.append((now, names.get(tid, str(tid)), parts))
            _time.sleep(interval)
        return samples

    def _get_block_profile(self, pv, params, headers, body) -> Response:
        """Blocking profile (Go's block and mutex profiles): a sampling
        wait profile, the stacks whose innermost frames are a
        synchronization wait (lock acquire, queue get, join, poll),
        collapsed and counted over ?seconds=N. /debug/pprof/mutex
        serves the same samples restricted to direct lock waits."""
        seconds = min(float(params.get("seconds", "2") or 2), 30.0)
        mutex_only = pv.get("kind") == "mutex"
        from collections import Counter

        waits: Counter = Counter()
        total = 0
        for _t, _name, parts in self._sample_stacks(seconds):
            total += 1
            if mutex_only:
                # Direct lock waits only, by INNERMOST frame (see
                # _MUTEX_FRAMES note): composite waits are /block's.
                if parts[-1] not in self._MUTEX_FRAMES:
                    continue
            elif not any(p in self._WAIT_FRAMES for p in parts[-2:]):
                continue
            waits[";".join(parts)] += 1
        out = [f"# sampling {'mutex' if mutex_only else 'block'} "
               f"profile: {seconds}s, {total} thread-samples, "
               f"{sum(waits.values())} in waits\n"]
        out += [f"{stack} {n}\n" for stack, n in waits.most_common()]
        return Response(200, {"Content-Type": "text/plain; charset=utf-8"},
                        "".join(out).encode())

    def _get_trace(self, pv, params, headers, body) -> Response:
        """Execution trace (Go's runtime trace): a wall-clock timeline of
        per-thread stack samples over ?seconds=N as chrome://tracing
        JSON (trace_event format, for Perfetto), one complete event a
        sample named by its innermost frame."""
        import json as _json

        seconds = min(float(params.get("seconds", "1") or 1), 30.0)
        interval = 0.005
        events = []
        for t, name, parts in self._sample_stacks(seconds, interval):
            events.append({
                "name": parts[-1], "cat": "sample", "ph": "X",
                "ts": int(t * 1e6), "dur": int(interval * 1e6),
                "pid": 1, "tid": name,
                "args": {"stack": ";".join(parts)}})
        return Response(200, {"Content-Type": "application/json"},
                        _json.dumps({"traceEvents": events}).encode())

    def _get_pprof(self, pv, params, headers, body) -> Response:
        """The profile index, the pprof surface the JAX handler mounts
        at /debug/pprof/, followed by the thread dump, so a bare GET
        /debug/pprof still answers what every thread is doing."""
        index = (
            "pilosa-tpu-torch /debug/pprof profiles:\n"
            "  profile       sampling CPU profile, all threads "
            "(?seconds=N, collapsed stacks)\n"
            "  heap          tracemalloc top allocation sites + RSS "
            "(?gc=1 collects first)\n"
            "  allocs        alias of heap\n"
            "  block         sampling wait profile (sync waits: locks, "
            "queues, joins; ?seconds=N)\n"
            "  mutex         block, restricted to lock acquires\n"
            "  trace         wall-clock timeline as chrome trace JSON "
            "(?seconds=N; open in Perfetto)\n"
            "  goroutine     per-thread stack dump\n"
            "  threadcreate  live thread table\n"
            "  cmdline       process command line\n\n"
            "other /debug endpoints:\n"
            "  /debug/vars         stats snapshot (counters + query "
            "latency p50/p95/p99; sched = scheduler queue/shed state)\n"
            "  /debug/queries      recent + slow query trace rings "
            "(?threshold_us=N re-filters)\n"
            "  /debug/traces/<id>  one query trace, all spans with "
            "timings and tags\n"
            "  /debug/health       watchdog verdicts: per-subsystem "
            "heartbeats, in-flight ops, peers\n"
            "  /debug/bundle       diagnostic dossier (thread stacks, "
            "health, rings; ?write=true persists)\n"
            "  /healthz /readyz    load-balancer probes (liveness / "
            "readiness; 503 when unready)\n\n"
            "query scheduling (when [sched] enabled):\n"
            "  POST /index/<i>/query reads X-Pilosa-Tenant for fair "
            "queuing; overload answers\n"
            "  429 + Retry-After instead of queuing doomed work; "
            "queue wait counts against the\n"
            "  query deadline (?deadline= / X-Pilosa-Deadline-Us) and "
            "profiles as sched_wait.\n"
            "  /metrics exports pilosa_sched_queue_depth{tenant}, "
            "pilosa_sched_shed_total{reason},\n"
            "  pilosa_sched_wait_microseconds, "
            "pilosa_sched_batch_size.\n\n")
        dump = self._thread_dump_text()
        return Response(200, {"Content-Type": "text/plain; charset=utf-8"},
                        (index + dump).encode())

    @staticmethod
    def _thread_dump_text() -> str:
        import sys
        import traceback

        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for tid, frame in sys._current_frames().items():
            out.append(f"--- thread {names.get(tid, '?')} ({tid}) ---")
            out.extend(ln.rstrip()
                       for ln in traceback.format_stack(frame))
        return "\n".join(out) + "\n"

    def _get_thread_dump(self, pv, params, headers, body) -> Response:
        """Every thread's stack (Go's goroutine profile)."""
        return Response(200, {"Content-Type": "text/plain; charset=utf-8"},
                        self._thread_dump_text().encode())

    def _get_threadcreate(self, pv, params, headers, body) -> Response:
        """Live thread table (name, ident, daemon, alive)."""
        rows = [f"{t.ident}\t{t.name}\tdaemon={t.daemon}\talive={t.is_alive()}"
                for t in threading.enumerate()]
        return Response(200, {"Content-Type": "text/plain; charset=utf-8"},
                        ("\n".join(rows) + "\n").encode())

    def _get_cmdline(self, pv, params, headers, body) -> Response:
        import sys

        return Response(200, {"Content-Type": "text/plain; charset=utf-8"},
                        "\x00".join(sys.argv).encode())

    def _get_heap_profile(self, pv, params, headers, body) -> Response:
        """Heap profile: tracemalloc's top allocation sites and the
        process's RSS and VM from /proc (Go's heap profile). tracemalloc
        costs something on every allocation, so it is never switched on
        implicitly: a bare GET reports the process's memory and how to
        opt in; ?start=1 begins tracing, ?stop=1 reports and then stops;
        ?gc=1 collects first, as Go's ?gc=1.

        ?start also needs PILOSA_TORCH_HEAP_TRACE=1 in the server's
        environment: the debug routes are unauthenticated, and tracing
        every allocation of the process is the operator's decision, not
        any client's. Starts and stops run under a lock, so two crossed
        requests cannot stop a trace the other thinks it owns."""
        import gc
        import tracemalloc

        # "?start=0" (or =false/=no, any case) must mean OFF: query
        # params and env values arrive as strings, and a bare
        # truthiness test would read "0" as on. One spelling list for
        # both the query flags and the env gate, so they can't drift.
        falsy = ("", "0", "false", "no")

        def flag(name: str) -> bool:
            return params.get(name, "").lower() not in falsy

        out = []
        with self._tracemalloc_mu:
            if flag("start") and not tracemalloc.is_tracing():
                if os.environ.get("PILOSA_TORCH_HEAP_TRACE",
                                  "").lower() in falsy:
                    out.append("# ?start=1 refused: set "
                               "PILOSA_TORCH_HEAP_TRACE=1 to allow this "
                               "endpoint to enable tracemalloc\n")
                else:
                    tracemalloc.start()
                    # Only a trace WE started may be stopped by
                    # ?stop=1 — an interpreter-level PYTHONTRACEMALLOC
                    # trace belongs to the operator, not this endpoint.
                    self._tracemalloc_ours = True
            if flag("gc"):
                gc.collect()
            try:
                with open("/proc/self/status") as f:
                    for ln in f:
                        if ln.startswith(("VmRSS", "VmHWM", "VmSize")):
                            out.append("# " + ln.strip() + "\n")
            except OSError:
                pass
            if tracemalloc.is_tracing():
                current, peak = tracemalloc.get_traced_memory()
                out.append(f"# tracemalloc current={current} "
                           f"peak={peak}\n\n")
                snap = tracemalloc.take_snapshot()
                for stat in snap.statistics("lineno")[:64]:
                    out.append(f"{stat.size}\t{stat.count}\t"
                               f"{stat.traceback}\n")
                if flag("stop") and self._tracemalloc_ours:
                    tracemalloc.stop()
                    self._tracemalloc_ours = False
                    out.append("# tracemalloc stopped\n")
            else:
                out.append("# tracemalloc off — ?start=1 to begin "
                           "tracing allocation sites (requires "
                           "PILOSA_TORCH_HEAP_TRACE=1 in the server "
                           "env), then re-request (?stop=1 to report "
                           "and stop)\n")
        return Response(200, {"Content-Type": "text/plain; charset=utf-8"},
                        "".join(out).encode())

    def _collect_runtime(self) -> list:
        info = prom.MetricFamily("pilosa_build_info", "gauge",
                                 "Build metadata; the value is always 1.")
        info.add(1, {"version": self.version})
        up = prom.MetricFamily("pilosa_uptime_seconds", "gauge",
                               "Seconds since this handler started.")
        up.add(time.monotonic() - self._start_time)
        return [info, up]

    def _collect_cluster(self) -> list:
        """The cluster client's transport counters (pilosa_cluster_*)
        and each peer's breaker (pilosa_breaker_state: 0 closed, 1
        half-open, 2 open); nothing without a cluster client."""
        cc = getattr(self.executor, "client", None)
        cstats = getattr(cc, "stats", None)
        fams: list = []
        if cstats is not None and hasattr(cstats, "copy"):
            fams.extend(prom.statmap_families(dict(cstats.copy()),
                                              "pilosa_cluster_"))
        snap = getattr(getattr(cc, "breakers", None), "snapshot", None)
        if callable(snap):
            order = {"closed": 0, "half-open": 1, "open": 2}
            f = prom.MetricFamily(
                "pilosa_breaker_state", "gauge",
                "Circuit breaker per peer: 0=closed, 1=half-open, "
                "2=open.")
            for host, state in sorted(snap().items()):
                f.add(order.get(state, -1), {"host": host, "state": state})
            fams.append(f)
        return fams

    def _collect_tiers(self) -> list:
        """pilosa_tier_bytes_total{tier}: bytes moved across locality
        tiers (obs.metrics.TIER_BYTES); ici stays 0 until the SPMD
        plane (ROADMAP A11d)."""
        tb = TIER_BYTES.copy()
        tier = prom.MetricFamily(
            "pilosa_tier_bytes_total", "counter",
            "Bytes moved across locality tiers: ici = descriptor-plane "
            "broadcasts over the device fabric, http = node-to-node "
            "request+response bodies.")
        for t in ("ici", "http"):
            tier.add(tb.get(t, 0), {"tier": t})
        return [tier]

    def _collect_membership(self) -> list:
        """Each node's state (pilosa_member_state: 0 DOWN, 1 JOINING, 2
        LEAVING, 3 UP); nothing without a cluster."""
        if self.cluster is None:
            return []
        order = {"DOWN": 0, "JOINING": 1, "LEAVING": 2, "UP": 3}
        f = prom.MetricFamily(
            "pilosa_member_state", "gauge",
            "Membership state per node: 0=DOWN, 1=JOINING, 2=LEAVING, "
            "3=UP/ACTIVE.")
        for host, state in sorted(self.cluster.node_states().items()):
            f.add(order.get(state, -1), {"host": host, "state": state})
        return [f]

    def _collect_hints(self) -> list:
        """Hinted handoff (parallel.hints.HINT_STATS, by target), the
        backlog's bytes with a hint manager, and the replicated writes'
        outcomes (executor.CONSISTENCY_STATS)."""
        from ..parallel.hints import HINT_STATS

        stats = HINT_STATS.copy()
        targets = sorted({k.split(":", 1)[1] for k in stats
                          if k.startswith(("queued:", "replayed:",
                                           "dropped:"))})
        queued = prom.MetricFamily(
            "pilosa_hints_queued_total", "counter",
            "Missed replica writes durably journaled as hints.")
        replayed = prom.MetricFamily(
            "pilosa_hints_replayed_total", "counter",
            "Hints replayed and acked by their target.")
        dropped = prom.MetricFamily(
            "pilosa_hints_dropped_total", "counter",
            "Hints spilled oldest-first past hint-max-bytes or lost to "
            "a torn log tail (anti-entropy heals these).")
        for t in targets:
            queued.add(stats.get(f"queued:{t}", 0), {"target": t})
            replayed.add(stats.get(f"replayed:{t}", 0), {"target": t})
            dropped.add(stats.get(f"dropped:{t}", 0), {"target": t})
        fams = [queued, replayed, dropped]
        if self.hints is not None:
            hb = prom.MetricFamily(
                "pilosa_hint_bytes", "gauge",
                "Current hint-log backlog bytes per target.")
            for t, nbytes in sorted(
                    self.hints.backlog_bytes_by_target().items()):
                hb.add(nbytes, {"target": t})
            fams.append(hb)
        wc = prom.MetricFamily(
            "pilosa_write_consistency_total", "counter",
            "Replicated-write outcomes by consistency level: ok "
            "(all replicas acked), hinted (level reached, misses "
            "journaled), below_consistency (503 after dispatch), "
            "rejected_unavailable (503 before local apply).")
        for key, n in sorted(CONSISTENCY_STATS.copy().items()):
            level, _, outcome = key.partition(":")
            if outcome:
                wc.add(n, {"level": level, "outcome": outcome})
        fams.append(wc)
        return fams

    def _collect_host_cache(self) -> list:
        """The host folds' cache counters, one gauge family a key
        (pilosa_host_cache_block_hit, ...), as the JAX handler exports
        them."""
        hc = getattr(self.executor, "host_cache_stats", None)
        if hc is None:
            return []
        return prom.statmap_families(dict(hc), "pilosa_host_cache_")

    def _collect_device(self) -> list:
        """The card manager's counters, dispatch modes, evictions,
        fallbacks and residency report; nothing before a query built
        the manager."""
        mgr = self.executor._mesh_mgr
        if mgr is None:
            return []
        with mgr._stats_mu:  # the serving threads bump it meanwhile
            stats = dict(mgr.stats)
        fams = prom.statmap_families(stats, "pilosa_mesh_")
        disp = prom.MetricFamily(
            "pilosa_dispatch_total", "counter",
            "Device dispatches by serving mode.")
        for mode, key in (("fused", "lone"), ("batched", "batched"),
                          ("shared_batch", "shared_batch"),
                          ("fallback", "fallback"),
                          ("routed_host", "routed_host")):
            disp.add(stats.get(key, 0), {"mode": mode})
        ev = prom.MetricFamily(
            "pilosa_hbm_evictions_total", "counter",
            "Staged views evicted, by trigger: budget = LRU pressure "
            "against [mesh] hbm-budget-bytes, oom = emergency eviction "
            "after the card ran out of memory.")
        ev.add(stats.get("evicted_budget", 0), {"reason": "budget"})
        ev.add(stats.get("evicted_oom", 0), {"reason": "oom"})
        fb = prom.MetricFamily(
            "pilosa_device_fallback_total", "counter",
            "Queries degraded to the host fold, by reason (unstaged = "
            "view missing/unstageable, oom = device memory exhausted "
            "after eviction, hbm_infeasible = one view overflows the "
            "budget, quarantined = plan signature serving a failure "
            "quarantine).")
        fb.add(stats.get("fallback", 0), {"reason": "unstaged"})
        for reason in ("oom", "hbm_infeasible", "quarantined"):
            fb.add(stats.get(f"fallback_{reason}", 0), {"reason": reason})
        fams += [disp, ev, fb, prom.MetricFamily(
            "pilosa_plan_quarantined_total", "counter",
            "Plan signatures quarantined off the device path after "
            "repeated failures.").add(stats.get("plan_quarantined", 0))]
        dm = mgr.device_memory()
        res = prom.MetricFamily(
            "pilosa_hbm_resident_bytes", "gauge",
            "Staged fragment-pool bytes resident per device.")
        for dev, n in sorted(dm["per_device"].items()):
            res.add(n, {"device": dev})
        rr = prom.MetricFamily(
            "pilosa_hbm_residency_ratio", "gauge",
            "Live container bytes over padded pool bytes — how much of "
            "the staged HBM footprint backs real data. Unlabeled series "
            "is the aggregate; one labeled series per device. 1.0 when "
            "nothing is staged.")
        rr.add(dm["residency_ratio"])
        for dev, r in sorted(dm["residency_per_device"].items()):
            rr.add(r, {"device": dev})
        fams += [
            res,
            prom.MetricFamily(
                "pilosa_hbm_padded_bytes", "gauge",
                "Total staged pool bytes including padding slots.")
            .add(dm["padded_bytes"]),
            prom.MetricFamily(
                "pilosa_hbm_live_bytes", "gauge",
                "Staged bytes backing live containers only.")
            .add(dm["live_bytes"]),
            prom.MetricFamily(
                "pilosa_hbm_staged_views", "gauge",
                "Fragment views currently staged on-device.")
            .add(dm["views"]),
            prom.MetricFamily(
                "pilosa_hbm_sparse_bytes", "gauge",
                "Staged pool bytes held as sorted-array (sparse) "
                "containers.").add(dm["sparse_bytes"]),
            rr,
            prom.MetricFamily(
                "pilosa_hbm_budget_bytes", "gauge",
                "Resolved staged-pool byte budget ([mesh] hbm-budget-"
                "bytes / env / the card's memory minus headroom); 0 = "
                "unlimited.").add(max(0, mgr._hbm_budget_bytes()))]
        return fams

    def _collect_routes(self) -> list:
        """Count and Sum / Min / Max queries by serving backend and tier,
        and their latency histograms."""
        ex = self.executor
        routes = prom.MetricFamily(
            "pilosa_query_route_total", "counter",
            "Count queries by serving backend and locality tier (local = "
            "this chip, ici = pod interconnect collective, http = "
            "cross-node ring).")
        by_route: dict = {}
        for k, v in ex.tier_stats.copy().items():
            route, _, tier = k.partition("|")
            by_route.setdefault(route, {})[tier] = v
        for k in sorted(ex.route_stats.copy()):
            backend = k[len("count_"):]
            for tier, v in sorted(by_route.get(backend, {}).items()):
                routes.add(v, {"backend": backend, "tier": tier})
        fams = [routes]
        hists = ex.route_latency_hists
        if hists:
            lat = prom.MetricFamily(
                "pilosa_query_route_duration_microseconds", "histogram",
                "Count latency by serving backend (log2 buckets, µs).")
            for route, h in sorted(hists.items()):
                lat.add_histogram(h, {"backend": route})
            fams.append(lat)
        return fams

    def _collect_fragments(self) -> list:
        """The fragment gauges, cached for metrics_sample_interval
        seconds: scrapers poll, and the walk is O(fragments)."""
        now = time.monotonic()
        with self._frag_sample_mu:
            stamp, fams = self._frag_sample
            if fams and now - stamp < self.metrics_sample_interval:
                return fams
        fams = self._sample_fragments()
        with self._frag_sample_mu:
            self._frag_sample = (now, fams)
        return fams

    def _sample_fragments(self) -> list:
        """Bits and fragments per frame. A fragment not loaded yet is
        counted and never parsed (a scrape must not force a load), so
        the cardinality covers loaded fragments only."""
        card = prom.MetricFamily(
            "pilosa_fragment_cardinality", "gauge",
            "Bits set per frame, loaded fragments only (sampled).")
        nf = prom.MetricFamily(
            "pilosa_fragments", "gauge",
            "Fragments per frame by load state (sampled).")
        for iname, idx in sorted(self.holder.indexes.items()):
            for fname, frame in sorted(idx.frames.items()):
                labels = {"index": iname, "frame": fname}
                bits = loaded = pending = 0
                for view in frame.views.values():
                    for frag in view.fragments.values():
                        with frag._mu:
                            if frag._pending_load:
                                pending += 1
                                continue
                            loaded += 1
                            bits += frag.storage.count()
                card.add(bits, labels)
                nf.add(loaded, dict(labels, state="loaded"))
                nf.add(pending, dict(labels, state="pending"))
        return [card, nf]

    def _collect_storage(self) -> list:
        """WAL durability: fsyncs, backpressure, snapshots, group-commit
        sizes, snapshot wall times, torn tails."""
        fsync = prom.MetricFamily(
            "pilosa_wal_fsync_total", "counter",
            "WAL group-commit fsyncs across all fragments.")
        fsync.add(WAL_STATS.get("fsync", 0))
        bp = prom.MetricFamily(
            "pilosa_wal_backpressure_total", "counter",
            "Writers gated (state=gated) or shed with 503 (state=shed) "
            "by the [storage] max-wal-ops bound.")
        bp.add(WAL_STATS.get("backpressure", 0), {"state": "gated"})
        bp.add(WAL_STATS.get("backpressure_shed", 0), {"state": "shed"})
        snaps = prom.MetricFamily(
            "pilosa_storage_snapshots_total", "counter",
            "Background fragment snapshots by outcome.")
        snaps.add(WAL_STATS.get("snapshots", 0), {"outcome": "ok"})
        snaps.add(WAL_STATS.get("snapshots_failed", 0), {"outcome": "error"})
        group = prom.MetricFamily(
            "pilosa_wal_group_size", "histogram",
            "Ops coalesced per WAL commit (group-commit batch size).")
        group.add_histogram(GROUP_SIZE)
        swall = prom.MetricFamily(
            "pilosa_storage_snapshot_us", "histogram",
            "Background snapshot wall time (microseconds).")
        swall.add_histogram(SNAPSHOT_US)
        torn = prom.MetricFamily(
            "pilosa_wal_torn_tails_total", "counter",
            "Torn final WAL records truncated at load (crash "
            "mid-append recoveries — expected after power loss; "
            "a climbing rate without crashes means flaky storage).")
        torn.add(WAL_STATS.get("torn_tails", 0))
        return [fsync, bp, snaps, group, swall, torn]

    def _collect_integrity(self) -> list:
        """Corrupt loads and repairs, the scrubber's progress, and the
        shadow checks by backend."""
        corrupt = prom.MetricFamily(
            "pilosa_integrity_corrupt_total", "counter",
            "Fragment loads that failed integrity verification "
            "(footer CRC / container FNV / op-log checksum).")
        corrupt.add(INTEGRITY_STATS.get("corrupt", 0))
        repaired = prom.MetricFamily(
            "pilosa_integrity_repaired_total", "counter",
            "Corrupt fragments restored from a verified replica copy "
            "(outcome=repaired) vs left pending with no donor "
            "(outcome=unrepaired).")
        repaired.add(INTEGRITY_STATS.get("repaired", 0),
                     {"outcome": "repaired"})
        repaired.add(INTEGRITY_STATS.get("unrepaired", 0),
                     {"outcome": "unrepaired"})
        sfrag = prom.MetricFamily(
            "pilosa_scrub_fragments_total", "counter",
            "Fragments verified by the background scrubber.")
        sfrag.add(SCRUB_STATS.get("fragments", 0))
        srep = prom.MetricFamily(
            "pilosa_scrub_repairs_total", "counter",
            "Scrubber-initiated repairs (snapshot rewrite, replica "
            "read-repair, or anti-entropy merge).")
        srep.add(SCRUB_STATS.get("repairs", 0))
        age = prom.MetricFamily(
            "pilosa_scrub_last_age_seconds", "gauge",
            "Seconds since the least-recently-scrubbed fragment "
            "was verified (0 until the first pass).")
        age.add(self.holder.scrubber.oldest_scrub_age())
        shadow_c = prom.MetricFamily(
            "pilosa_shadow_checks_total", "counter",
            "Sampled device results recomputed through the host "
            "roaring fold.")
        shadow_m = prom.MetricFamily(
            "pilosa_shadow_mismatch_total", "counter",
            "Shadow recomputations whose host answer DIFFERED from "
            "the device answer. Any nonzero value is a sev: the "
            "offending plan signature is quarantined.")
        shadow = SHADOW_STATS.copy()
        for b in sorted({k.split(":", 1)[1] for k in shadow if ":" in k}
                        ) or ["mesh"]:
            shadow_c.add(shadow.get(f"checks:{b}", 0), {"backend": b})
            shadow_m.add(shadow.get(f"mismatch:{b}", 0), {"backend": b})
        return [corrupt, repaired, sfrag, srep, age, shadow_c, shadow_m]

    def _post_frame(self, pv, params, headers, body) -> Response:
        opts = _decode_options(body, {
            "rowLabel": "row_label", "inverseEnabled": "inverse_enabled",
            "cacheType": "cache_type", "cacheSize": "cache_size",
            "timeQuantum": "time_quantum", "fields": "fields"})
        idx = self.holder.index(pv["index"])
        if idx is None:
            raise IndexNotFoundError()
        f = idx.create_frame(pv["frame"], **opts)
        if self.broadcaster is not None:
            self.broadcaster.send_sync(CreateFrameMessage(
                index=idx.name, frame=f.name, meta=frame_meta(f)))
        return _json_resp({})

    def _patch_index_time_quantum(self, pv, params, headers,
                                  body) -> Response:
        q = json.loads(body.decode() or "{}").get("timeQuantum", "")
        idx = self.holder.index(pv["index"])
        if idx is None:
            raise IndexNotFoundError()
        idx.set_time_quantum(parse_time_quantum(q))
        return _json_resp({})

    def _patch_frame_time_quantum(self, pv, params, headers,
                                  body) -> Response:
        q = json.loads(body.decode() or "{}").get("timeQuantum", "")
        f = self.holder.frame(pv["index"], pv["frame"])
        if f is None:
            raise FrameNotFoundError()
        f.set_time_quantum(parse_time_quantum(q))
        return _json_resp({})

    def _get_frame_views(self, pv, params, headers, body) -> Response:
        f = self.holder.frame(pv["index"], pv["frame"])
        if f is None:
            raise FrameNotFoundError()
        return _json_resp({"views": sorted(f.views)})

    def _post_query(self, pv, params, headers, body) -> Response:
        """_post_query_inner with its outcome recorded, exactly once, in
        the SLO recorder (pilosa_query_outcome_total{outcome, tenant}):
        successes with their latency and trace id, sheds, deadline
        expiries, backpressure, client and server errors. ?explain=true
        runs nothing and is not counted. A 200 of a tenant over the
        cost-debt threshold carries X-Pilosa-Cost-Debt."""
        if self.slo is None:
            return self._post_query_inner(pv, params, headers, body, {})
        info: dict = {}
        t0 = time.monotonic()
        try:
            resp = self._post_query_inner(pv, params, headers, body, info)
        except Exception as e:
            if not info.get("explain"):
                self.slo.record(slo.outcome_for_status(_error_status(e)),
                                tenant=info.get("tenant", "default"))
            raise
        if info.get("explain"):
            return resp
        tenant = info.get("tenant", "default")
        latency_us = ((time.monotonic() - t0) * 1e6 if resp.status < 400
                      else None)
        self.slo.record(slo.outcome_for_status(resp.status), tenant=tenant,
                        latency_us=latency_us,
                        trace_id=info.get("trace_id"))
        if resp.status < 400:
            debt = self._cost_debt(tenant)
            if debt is not None:
                resp.headers["X-Pilosa-Cost-Debt"] = debt
        return resp

    def _tenant_label(self, tenant: str) -> str:
        """The bounded tenant label ([sched] tenant-weights, "default",
        else "other"), the tenant itself without an SLO recorder."""
        return self.slo.tenant_label(tenant) if self.slo is not None \
            else tenant

    def _cost_debt(self, tenant: str) -> Optional[str]:
        """The tenant's share of the attributed device time, formatted,
        when it passes cost_debt_threshold: observe-only, no
        throttling."""
        thr = self.cost_debt_threshold
        if thr is None or thr <= 0 or not costs.LEDGER.enabled:
            return None
        label = self._tenant_label(tenant)
        share = None
        if self.scheduler is not None:
            share = self.scheduler.tenant_cost_share(label)
        if share is None:
            share = costs.LEDGER.tenant_share(label)
        return f"{share:.3f}" if share > thr else None

    def _read_staleness(self, params, headers, remote: bool) -> float:
        """A read's bound: X-Pilosa-Staleness, else ?staleness=, else
        default_read_staleness; a remote leg's is 0 (its coordinator
        picked its replica)."""
        if remote:
            return 0.0
        raw = (headers.get("x-pilosa-staleness", "")
               or params.get("staleness", ""))
        return parse_staleness(raw) if raw else self.default_read_staleness

    def _exec_options(self, params, headers, remote: bool) -> ExecOptions:
        """The query's deadline: X-Pilosa-Deadline-Us (the budget left,
        us, which a coordinator sends its legs), else ?deadline= (a
        duration, "50ms"), else, for a coordinator, the server's
        default_deadline ([cluster] query-deadline; 0: none);
        ?partial=true leaves out the slices no owner can serve; the
        read's staleness bound (_read_staleness)."""
        deadline = None
        hdr = headers.get("x-pilosa-deadline-us", "")
        if hdr:
            deadline = time.monotonic() + int(hdr) / 1e6
        elif params.get("deadline"):
            deadline = time.monotonic() + parse_duration(params["deadline"])
        elif not remote and self.default_deadline > 0:
            deadline = time.monotonic() + self.default_deadline
        return ExecOptions(remote=remote, deadline=deadline,
                           partial=params.get("partial") == "true",
                           staleness=self._read_staleness(params, headers,
                                                          remote))

    def _post_query_inner(self, pv, params, headers, body,
                          info: dict) -> Response:
        """Admission, the trace, the profile and the cost account around
        _run_query. The request is PQL with ?slices= and ?columnAttrs=,
        or a protobuf QueryRequest (its query, slices, column_attrs and
        remote: a coordinator's leg, which skips admission and the query
        stats). The profile starts before admission, so a queue wait is
        its sched_wait phase; its device_exec + host_fold is charged to
        the tenant's account as device time (times the sample rate on
        the sampled path). A remote leg joins the coordinator's trace id
        (X-Pilosa-Trace, the part before ":") and answers its spans in
        X-Pilosa-Trace-Spans; with X-Pilosa-Profile it is profiled and
        answers its profile in X-Pilosa-Profile (compact JSON both)."""
        index = pv["index"]
        if self._sends_proto(headers):
            req = QueryRequest.decode(body)
            query, slices = req.query, [int(s) for s in req.slices]
            column_attrs, remote = req.column_attrs, req.remote
        else:
            query = body.decode()
            slices = [int(s) for s in params.get("slices", "").split(",")
                      if s != ""]
            column_attrs = params.get("columnAttrs") == "true"
            remote = False
        tenant = headers.get("x-pilosa-tenant", "") or "default"
        info["tenant"] = tenant
        fault.point("handler.query", index=index, remote=remote)
        opt = self._exec_options(params, headers, remote)
        if params.get("explain") == "true" and not remote:
            info["explain"] = True
            return self._explain_query(index, params, headers, body)
        want_profile = params.get("profile") == "true" and not remote
        remote_profile = bool(remote and headers.get("x-pilosa-profile"))
        sampled = (self.profile_sample_rate > 0 and not remote
                   and next(self._profile_seq)
                   % self.profile_sample_rate == 0)
        cost_ctx = cost_token = None
        if costs.LEDGER.enabled:
            cost_ctx, cost_token = costs.activate(
                self._tenant_label(tenant),
                float(self.profile_sample_rate) if sampled else 1.0)
        prof = ptoken = None
        if want_profile or remote_profile or sampled:
            prof = profile.QueryProfile(backend=self.executor.device.type)
            if self.slo is not None and not remote:
                prof.tenant = self.slo.tenant_label(tenant)
            ptoken = profile.activate(prof)
        ticket = None
        th = ""
        try:
            if self.scheduler is not None and not remote:
                try:
                    with profile.phase("sched_wait"):
                        ticket = self.scheduler.submit(
                            tenant=tenant, deadline=opt.deadline)
                except AdmissionError as e:
                    self.stats.count("query.shed", 1)
                    return self._shed_response(e, headers)
                except DeadlineExceededError as e:
                    return self._query_error(e, headers)
            th = headers.get("x-pilosa-trace", "") if remote else ""
            trace = self.tracer.start(
                "query", trace_id=th.partition(":")[0] or None,
                index=index, query=query[:256])
            info["trace_id"] = trace.trace_id
            try:
                with trace.root:
                    resp = self._run_query(index, query, slices,
                                           column_attrs, remote, headers,
                                           opt, want_profile)
            finally:
                self.tracer.finish(trace)
        finally:
            if ticket is not None:
                self.scheduler.done(ticket)
            if prof is not None:
                profile.deactivate(ptoken)
                prof.finish()
                profile.STATS.record(prof)
            if cost_ctx is not None:
                costs.deactivate(cost_token)
                if prof is not None:
                    costs.LEDGER.record_device_us(
                        prof.phase_us("device_exec")
                        + prof.phase_us("host_fold"),
                        weight=cost_ctx.weight, tenant=cost_ctx.tenant,
                        shape=cost_ctx.shape)
        if th:
            resp.headers["X-Pilosa-Trace-Spans"] = json.dumps(
                trace.serialize_spans(), separators=(",", ":"))
        if remote_profile:
            resp.headers["X-Pilosa-Profile"] = json.dumps(
                prof.to_dict(), separators=(",", ":"))
        return resp

    def _shed_response(self, e: AdmissionError, headers=None) -> Response:
        """429 with Retry-After (whole seconds, >= 1): do not retry
        sooner."""
        retry = max(1, int(round(e.retry_after_s)))
        if headers is not None and self._accepts_proto(headers):
            resp = _proto_resp(QueryResponse(err=str(e)), 429)
        else:
            resp = _json_resp({"error": str(e), "reason": e.reason,
                               "retry_after_s": retry}, 429)
        resp.headers["Retry-After"] = str(retry)
        return resp

    def _query_error(self, e: Exception, headers) -> Response:
        """A failed query's answer: _error_resp's status (504, 503 with
        Retry-After, 404 / 422 for the field errors, 500 for an
        unreadable slice) for its errors, 400 for the rest; a protobuf
        caller gets a QueryResponse whose err is the message."""
        if isinstance(e, (FieldValueError, FieldNotFoundError,
                          WriteBackpressureError, WriteConsistencyError,
                          SliceUnavailableError, DeadlineExceededError)):
            resp = _error_resp(e)
        else:
            resp = _json_resp({"error": str(e)}, 400)
        if self._accepts_proto(headers):
            return Response(resp.status, {
                **resp.headers, "Content-Type": PROTOBUF_CT},
                QueryResponse(err=resp.json()["error"]).encode())
        return resp

    def _explain_query(self, index: str, params, headers,
                       body) -> Response:
        """Executor.explain, with a "cost" block: what the ledger holds
        of this tenant x shape (its account, the tenant's share of the
        device time, the shape's regressed dimensions). Runs nothing."""
        slices = [int(s) for s in params.get("slices", "").split(",")
                  if s != ""]
        try:
            q = parse_string(body.decode())
            plan = self.executor.explain(
                index, q, slices or None,
                staleness=self._read_staleness(params, headers, False))
        except (PilosaError, ParseError) as e:
            return _json_resp({"error": str(e)}, 400)
        plan = {**plan, "query": body.decode()[:1024]}
        ledger = costs.LEDGER
        if ledger.enabled and q.calls:
            label = self._tenant_label(
                headers.get("x-pilosa-tenant", "") or "default")
            shape = self.executor._shape_sig(q.calls[0])
            acct = ledger.snapshot(limit=ledger.max_accounts)
            row = next((a for a in acct["accounts"]
                        if a["tenant"] == label and a["shape"] == shape),
                       None)
            plan["cost"] = {
                "tenant": label, "shape": shape,
                "tenant_device_us_share": round(ledger.tenant_share(label),
                                                4),
                "account": {k: v for k, v in (row or {}).items()
                            if k not in ("tenant", "shape")},
                "regressed": [d for s_, d in costs.WATCH.active()
                              if s_ == shape]}
        return _json_resp(plan)

    def _run_query(self, index: str, query: str, slices, column_attrs: bool,
                   remote: bool, headers, opt: ExecOptions,
                   profile_section: bool) -> Response:
        try:
            with obs_span("parse", bytes=len(query)), profile.phase("parse"):
                q = parse_string(query)
            t0 = time.monotonic()
            results = self.executor.execute(index, q, slices or None, opt)
            if not remote:  # a clustered query counts once, where it came
                dt_us = int((time.monotonic() - t0) * 1e6)
                tagged = self.stats.with_tags(f"index:{index}")
                for call in q.calls:
                    tagged.count(f"query.{call.name}", 1)
                tagged.timing("query", dt_us)
                self.stats.timing("query", dt_us)
        except (PilosaError, ParseError) as e:
            return self._query_error(e, headers)
        col_sets = self._column_attr_sets(index, results) \
            if column_attrs else []
        if self._accepts_proto(headers):
            return _proto_resp(QueryResponse(
                results=[result_to_proto(r) for r in results],
                column_attr_sets=[ColumnAttrSet(id=cid,
                                                attrs=attrs_to_proto(a))
                                  for cid, a in col_sets]))
        out = {"results": [_result_to_json(r) for r in results]}
        if column_attrs:
            out["columnAttrs"] = [{"id": cid, "attrs": attrs}
                                  for cid, attrs in col_sets]
        if opt.partial:
            out["partial"] = bool(opt.missing_slices)
            out["missing_slices"] = sorted(set(opt.missing_slices))
        if profile_section:
            prof = profile.current()
            if prof is not None:
                # Before serialization: total_us is the execution's.
                out["profile"] = prof.to_dict()
        return _json_resp(out)

    def _column_attr_sets(self, index: str, results):
        """(column, attrs) of every column in the Bitmap results that has
        attrs, by column."""
        idx = self.holder.index(index)
        if idx is None:
            return []
        cols = sorted({int(c) for r in results if isinstance(r, Row)
                       for c in r.columns()})
        return [(c, a) for c in cols
                if (a := idx.column_attr_store.attrs(c))]
