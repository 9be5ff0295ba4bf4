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
         (?slices=0,1 restricts the slices; ?columnAttrs=true adds
         "columnAttrs", the attrs of the columns in Bitmap results;
         ?explain=true answers the plan, Executor.explain, with a "cost"
         block of what the cost ledger holds of the tenant x shape, and
         runs nothing; ?profile=true adds "profile", the query's
         measured phases, bytes and roofline. Headers: X-Pilosa-Tenant
         (default "default"), X-Pilosa-Deadline-Us (the budget left, us;
         or ?deadline=50ms; else [cluster] query-deadline). Admission
         (with a scheduler): 429 + Retry-After when shed, 504 when the
         deadline expires first; a 200 of a tenant over [obs]
         cost-debt-threshold of the device time carries
         X-Pilosa-Cost-Debt)
  POST   /import                        protobuf ImportRequest (wire/):
         Frame.import_bits      -> {}, or an ImportResponse when Accept
         names protobuf
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
         card manager, "mesh": its counters, "hbm": {budget_bytes, the
         residency report}, and "quarantined_plans"}, and "sched" (the
         scheduler's snapshot) when one is wired

GET /metrics renders one obs.prom.Registry, whose collectors bridge the
stores at scrape time (the JAX handler's families and names): the stats
client (pilosa_<name>_total{index,frame,view,slice}, the query latency
histograms), pilosa_build_info and pilosa_uptime_seconds, the card
manager's counters (pilosa_mesh_*, pilosa_dispatch_total{mode},
pilosa_hbm_evictions_total{reason}, pilosa_device_fallback_total
{reason}, pilosa_plan_quarantined_total, pilosa_hbm_resident_bytes
{device} and the rest of the residency report, pilosa_hbm_budget_bytes;
none before a query built the manager), the executor's routes
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
(pilosa_queryshape_*). A family whose store the port lacks (the compile
counters, the plan and host query caches, the row caches, the cluster)
is left out. A collector that raises is skipped.

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
import re
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..bsi.field import FieldNotFoundError, FieldValueError
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
                      WriteBackpressureError)
from ..executor import SHADOW_STATS, ExecOptions
from ..obs import costs, health, profile, prom, slo
from ..obs import span as obs_span
from ..obs.trace import Tracer
from ..sched import AdmissionError
from ..ops import kernels
from ..pql import ParseError, parse_string
from ..utils.stats import ExpvarStats
from ..wire import (PROTOBUF_CT, BlockDataRequest, BlockDataResponse,
                    ImportRequest, ImportResponse, MaxSlicesResponse)

VERSION = "0.1.0"

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
    if isinstance(err, WriteBackpressureError):
        return 503
    if isinstance(err, SliceUnavailableError):
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
    if status == 500 and not isinstance(e, SliceUnavailableError):
        msg = f"internal error: {type(e).__name__}: {e}"
    resp = _json_resp({"error": msg}, status)
    if isinstance(e, WriteBackpressureError):
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
                 tracer=None):
        self.holder = holder
        self.executor = executor
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
        f.import_bits(req.row_ids, req.column_ids, timestamps)
        if self._accepts_proto(headers):
            return _proto_resp(ImportResponse())
        return _json_resp({})

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
        self.holder.create_index(pv["index"], **opts)
        return _json_resp({})

    def _delete_index(self, pv, params, headers, body) -> Response:
        self.holder.delete_index(pv["index"])
        self.executor.invalidate_device_index(pv["index"])
        return _json_resp({})

    def _delete_frame(self, pv, params, headers, body) -> Response:
        idx = self.holder.index(pv["index"])
        if idx is None:
            raise IndexNotFoundError()
        idx.delete_frame(pv["frame"])
        self.executor.invalidate_device_index(pv["index"])
        return _json_resp({})

    def _get_expvar(self, pv, params, headers, body) -> Response:
        """The stats client's snapshot, uptime and version, and the
        `storage`, `integrity` and `mesh` parts of the JAX handler's
        /debug/vars (pilosa_tpu/api/handler.py:1497-1525)."""
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
        if self.scheduler is not None:
            out["sched"] = self.scheduler.snapshot()
        mgr = self.executor._mesh_mgr
        if mgr is not None:
            mesh = dict(mgr.stats)
            mesh["hbm"] = {"budget_bytes": max(0, mgr._hbm_budget_bytes()),
                           **mgr.device_memory()}
            mesh["quarantined_plans"] = mgr.quarantined_plans()
            out["mesh"] = mesh
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
                   self._collect_routes, self._collect_sched,
                   self._collect_fragments, self._collect_storage,
                   self._collect_integrity, self._collect_slo,
                   self._collect_flight, health.families,
                   profile.STATS.families, costs.families):
            reg.register_collector(fn)

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

    def _collect_runtime(self) -> list:
        info = prom.MetricFamily("pilosa_build_info", "gauge",
                                 "Build metadata; the value is always 1.")
        info.add(1, {"version": self.version})
        up = prom.MetricFamily("pilosa_uptime_seconds", "gauge",
                               "Seconds since this handler started.")
        up.add(time.monotonic() - self._start_time)
        return [info, up]

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
        idx.create_frame(pv["frame"], **opts)
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

    def _exec_options(self, params, headers) -> ExecOptions:
        """The query's deadline: X-Pilosa-Deadline-Us (the budget left,
        us), else ?deadline= (a duration, "50ms"), else the server's
        default_deadline ([cluster] query-deadline; 0: none)."""
        deadline = None
        hdr = headers.get("x-pilosa-deadline-us", "")
        if hdr:
            deadline = time.monotonic() + int(hdr) / 1e6
        elif params.get("deadline"):
            deadline = time.monotonic() + parse_duration(params["deadline"])
        elif self.default_deadline > 0:
            deadline = time.monotonic() + self.default_deadline
        return ExecOptions(deadline=deadline)

    def _post_query_inner(self, pv, params, headers, body,
                          info: dict) -> Response:
        """Admission, the trace, the profile and the cost account around
        _run_query. The profile starts before admission, so a queue wait
        is its sched_wait phase; its device_exec + host_fold is charged
        to the tenant's account as device time (times the sample rate
        on the sampled path)."""
        index = pv["index"]
        tenant = headers.get("x-pilosa-tenant", "") or "default"
        info["tenant"] = tenant
        fault.point("handler.query", index=index, remote=False)
        opt = self._exec_options(params, headers)
        if params.get("explain") == "true":
            info["explain"] = True
            return self._explain_query(index, params, headers, body)
        want_profile = params.get("profile") == "true"
        sampled = (self.profile_sample_rate > 0
                   and next(self._profile_seq)
                   % self.profile_sample_rate == 0)
        cost_ctx = cost_token = None
        if costs.LEDGER.enabled:
            cost_ctx, cost_token = costs.activate(
                self._tenant_label(tenant),
                float(self.profile_sample_rate) if sampled else 1.0)
        prof = ptoken = None
        if want_profile or sampled:
            prof = profile.QueryProfile(backend=self.executor.device.type)
            if self.slo is not None:
                prof.tenant = self.slo.tenant_label(tenant)
            ptoken = profile.activate(prof)
        ticket = None
        try:
            if self.scheduler is not None:
                try:
                    with profile.phase("sched_wait"):
                        ticket = self.scheduler.submit(
                            tenant=tenant, deadline=opt.deadline)
                except AdmissionError as e:
                    self.stats.count("query.shed", 1)
                    return self._shed_response(e)
                except DeadlineExceededError as e:
                    return _json_resp({"error": str(e)}, 504)
            trace = self.tracer.start("query", index=index,
                                      query=body[:256].decode(
                                          errors="replace"))
            info["trace_id"] = trace.trace_id
            try:
                with trace.root:
                    return self._run_query(index, params, body, opt,
                                           want_profile)
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

    def _shed_response(self, e: AdmissionError) -> Response:
        """429 with Retry-After (whole seconds, >= 1): do not retry
        sooner."""
        retry = max(1, int(round(e.retry_after_s)))
        resp = _json_resp({"error": str(e), "reason": e.reason,
                           "retry_after_s": retry}, 429)
        resp.headers["Retry-After"] = str(retry)
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
            plan = self.executor.explain(index, q, slices or None)
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

    def _run_query(self, index: str, params, body, opt: ExecOptions,
                   profile_section: bool) -> Response:
        slices = [int(s) for s in params.get("slices", "").split(",")
                  if s != ""]
        try:
            text = body.decode()
            with obs_span("parse", bytes=len(text)), profile.phase("parse"):
                q = parse_string(text)
            t0 = time.monotonic()
            results = self.executor.execute(index, q, slices or None, opt)
            dt_us = int((time.monotonic() - t0) * 1e6)
            tagged = self.stats.with_tags(f"index:{index}")
            for call in q.calls:
                tagged.count(f"query.{call.name}", 1)
            tagged.timing("query", dt_us)
            self.stats.timing("query", dt_us)
        except (FieldValueError, FieldNotFoundError, WriteBackpressureError,
                SliceUnavailableError, DeadlineExceededError) as e:
            return _error_resp(e)
        except (PilosaError, ParseError) as e:
            return _json_resp({"error": str(e)}, 400)
        out = {"results": [_result_to_json(r) for r in results]}
        if params.get("columnAttrs") == "true":
            out["columnAttrs"] = [{"id": cid, "attrs": attrs} for cid, attrs
                                  in self._column_attr_sets(index, results)]
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
