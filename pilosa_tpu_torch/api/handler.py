"""HTTP handler: the routes of this slice, with the JAX handler's JSON
bodies and status codes.

  POST   /index/{index}                 create an index   -> {}
  DELETE /index/{index}                 delete an index   -> {}
  PATCH  /index/{index}/time-quantum    {"timeQuantum"}   -> {}
  POST   /index/{index}/frame/{frame}   create a frame    -> {}
  DELETE /index/{index}/frame/{frame}   delete a frame    -> {}
  PATCH  /index/{index}/frame/{frame}/time-quantum        -> {}
  GET    /index/{index}/frame/{frame}/views               -> {"views": [...]}
  POST   /index/{index}/query           PQL body          -> {"results": [...]}
         (?slices=0,1 restricts the slices; ?columnAttrs=true adds
         "columnAttrs", the attrs of the columns in Bitmap results;
         ?explain=true answers the plan, Executor.explain, and runs
         nothing)
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
(Executor.invalidate_device_index).

A Bitmap result is {"attrs", "bits"}, a TopN result [{"id", "count"}].

Errors answer {"error": message}: 404 for a missing index, frame or
integer field, 409 for one that exists, 422 for a value outside a field's
range, 503 with Retry-After for a write shed by backpressure, 500 for a
slice whose data cannot be read (a corrupt fragment), 400 for a bad
request or a failed query.
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, NamedTuple, Optional

from ..bsi.field import FieldNotFoundError, FieldValueError
from ..core.fragment import INTEGRITY_STATS
from ..core.row import Row
from ..core.timequantum import parse_time_quantum
from ..core.wal import GROUP_SIZE, SNAPSHOT_US, WAL_STATS
from ..errors import (FrameExistsError, FrameNotFoundError, IndexExistsError,
                      IndexNotFoundError, PilosaError, SliceUnavailableError,
                      WriteBackpressureError)
from ..executor import SHADOW_STATS
from ..ops import kernels
from ..pql import ParseError, parse_string


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
                        FieldNotFoundError)):
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

    def __init__(self, holder, executor):
        self.holder = holder
        self.executor = executor
        self._routes: List[Route] = []
        r = self._add_route
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
        r("GET", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)/views",
          self._get_frame_views)
        r("GET", r"/schema", self._get_schema)
        r("GET", r"/debug/vars", self._get_expvar)

    def _add_route(self, method: str, pattern: str, fn: Callable):
        self._routes.append(Route(method, re.compile("^" + pattern + "$"), fn))

    def handle(self, method: str, path: str,
               params: Optional[Dict[str, str]] = None,
               headers: Optional[Dict[str, str]] = None,
               body: bytes = b"") -> Response:
        path_matched = False
        for route in self._routes:
            m = route.pattern.match(path)
            if m is None:
                continue
            path_matched = True
            if route.method != method:
                continue
            try:
                return route.fn(m.groupdict(), params or {}, body)
            except Exception as e:  # noqa: BLE001 — never drop the connection
                return _error_resp(e)
        if path_matched:
            return _json_resp({"error": "method not allowed"}, 405)
        return _json_resp({"error": "not found"}, 404)

    def _get_schema(self, pv, params, body) -> Response:
        return _json_resp({"indexes": self.holder.schema()})

    def _post_index(self, pv, params, body) -> Response:
        opts = _decode_options(body, {"columnLabel": "column_label",
                                      "timeQuantum": "time_quantum"})
        self.holder.create_index(pv["index"], **opts)
        return _json_resp({})

    def _delete_index(self, pv, params, body) -> Response:
        self.holder.delete_index(pv["index"])
        self.executor.invalidate_device_index(pv["index"])
        return _json_resp({})

    def _delete_frame(self, pv, params, body) -> Response:
        idx = self.holder.index(pv["index"])
        if idx is None:
            raise IndexNotFoundError()
        idx.delete_frame(pv["frame"])
        self.executor.invalidate_device_index(pv["index"])
        return _json_resp({})

    def _get_expvar(self, pv, params, body) -> Response:
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

    def _post_frame(self, pv, params, body) -> Response:
        opts = _decode_options(body, {
            "rowLabel": "row_label", "inverseEnabled": "inverse_enabled",
            "cacheType": "cache_type", "cacheSize": "cache_size",
            "timeQuantum": "time_quantum", "fields": "fields"})
        idx = self.holder.index(pv["index"])
        if idx is None:
            raise IndexNotFoundError()
        idx.create_frame(pv["frame"], **opts)
        return _json_resp({})

    def _patch_index_time_quantum(self, pv, params, body) -> Response:
        q = json.loads(body.decode() or "{}").get("timeQuantum", "")
        idx = self.holder.index(pv["index"])
        if idx is None:
            raise IndexNotFoundError()
        idx.set_time_quantum(parse_time_quantum(q))
        return _json_resp({})

    def _patch_frame_time_quantum(self, pv, params, body) -> Response:
        q = json.loads(body.decode() or "{}").get("timeQuantum", "")
        f = self.holder.frame(pv["index"], pv["frame"])
        if f is None:
            raise FrameNotFoundError()
        f.set_time_quantum(parse_time_quantum(q))
        return _json_resp({})

    def _get_frame_views(self, pv, params, body) -> Response:
        f = self.holder.frame(pv["index"], pv["frame"])
        if f is None:
            raise FrameNotFoundError()
        return _json_resp({"views": sorted(f.views)})

    def _post_query(self, pv, params, body) -> Response:
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
