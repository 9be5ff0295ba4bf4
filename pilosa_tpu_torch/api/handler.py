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
         ?explain=true answers the plan, Executor.explain, and runs
         nothing)
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
  GET    /debug/vars                    {"storage": {"fragments": each
         loaded fragment's storage_state, "wal": WAL_STATS, "group_size",
         "snapshot_us"}, "integrity": {"scrub": the scrubber's record,
         "shadow": SHADOW_STATS, "fragments": INTEGRITY_STATS,
         "torn_tails"}, "kernel_launches": each kernel's launches in this
         process (ops.kernels.LAUNCHES), and, once a query has built the
         card manager, "mesh": its counters, "hbm": {budget_bytes, the
         residency report}, and "quarantined_plans"}

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
import json
import re
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np

from ..bsi.field import FieldNotFoundError, FieldValueError
from ..core.fragment import INTEGRITY_STATS
from ..core.row import Row
from ..core.timequantum import parse_time_quantum
from ..core.view import VIEW_INVERSE
from ..core.wal import GROUP_SIZE, SNAPSHOT_US, WAL_STATS
from ..errors import (FragmentNotFoundError, FrameExistsError,
                      FrameNotFoundError, IndexExistsError,
                      IndexNotFoundError, PilosaError, SliceUnavailableError,
                      WriteBackpressureError)
from ..executor import SHADOW_STATS
from ..ops import kernels
from ..pql import ParseError, parse_string
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

    def __init__(self, holder, executor, client_factory=None):
        self.holder = holder
        self.executor = executor
        # client_factory(host) -> api.client.InternalClient: frame restore
        # pulls a frame's fragments through it (None: 501).
        self.client_factory = client_factory
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
        """The `storage`, `integrity` and `mesh` parts of the JAX
        handler's /debug/vars (pilosa_tpu/api/handler.py:1497-1525)."""
        wal = WAL_STATS.copy()
        out = {"storage": {"fragments": self.holder.storage_state(),
                           "wal": wal,
                           "group_size": GROUP_SIZE.snapshot(),
                           "snapshot_us": SNAPSHOT_US.snapshot()},
               "integrity": {"scrub": self.holder.scrubber.snapshot(),
                             "shadow": SHADOW_STATS.copy(),
                             "fragments": INTEGRITY_STATS.copy(),
                             "torn_tails": wal.get("torn_tails", 0)},
               "kernel_launches": dict(kernels.LAUNCHES)}
        mgr = self.executor._mesh_mgr
        if mgr is not None:
            mesh = dict(mgr.stats)
            mesh["hbm"] = {"budget_bytes": max(0, mgr._hbm_budget_bytes()),
                           **mgr.device_memory()}
            mesh["quarantined_plans"] = mgr.quarantined_plans()
            out["mesh"] = mesh
        return _json_resp(out)

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
        slices = [int(s) for s in params.get("slices", "").split(",")
                  if s != ""]
        try:
            q = parse_string(body.decode())
            if params.get("explain") == "true":
                plan = self.executor.explain(pv["index"], q, slices or None)
                return _json_resp({**plan, "query": body.decode()[:1024]})
            results = self.executor.execute(pv["index"], q, slices or None)
        except (FieldValueError, FieldNotFoundError, WriteBackpressureError,
                SliceUnavailableError) as e:
            return _error_resp(e)
        except (PilosaError, ParseError) as e:
            return _json_resp({"error": str(e)}, 400)
        out = {"results": [_result_to_json(r) for r in results]}
        if params.get("columnAttrs") == "true":
            out["columnAttrs"] = [{"id": cid, "attrs": attrs} for cid, attrs
                                  in self._column_attr_sets(pv["index"],
                                                            results)]
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
