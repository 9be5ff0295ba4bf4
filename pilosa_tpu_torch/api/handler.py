"""HTTP handler: the routes of this slice, with the JAX handler's JSON
bodies and status codes.

  POST /index/{index}                 create an index   -> {}
  POST /index/{index}/frame/{frame}   create a frame    -> {}
  POST /index/{index}/query           PQL body          -> {"results": [...]}
  GET  /schema                                          -> {"indexes": [...]}

Errors answer {"error": message}: 404 for a missing index or frame, 409
for one that exists, 400 for a bad request or a failed query.
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, NamedTuple, Optional

from ..core.row import Row
from ..errors import (FrameExistsError, FrameNotFoundError, IndexExistsError,
                      IndexNotFoundError, PilosaError)
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
    if isinstance(err, (IndexNotFoundError, FrameNotFoundError)):
        return 404
    if isinstance(err, (IndexExistsError, FrameExistsError)):
        return 409
    if isinstance(err, (PilosaError, ParseError, ValueError, KeyError,
                        TypeError)):
        return 400
    return 500


def _result_to_json(result):
    if isinstance(result, Row):
        return {"attrs": result.attrs,
                "bits": [int(c) for c in result.columns()]}
    return result  # int or bool


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
        r("POST", r"/index/(?P<index>[^/]+)/query", self._post_query)
        r("POST", r"/index/(?P<index>[^/]+)/frame/(?P<frame>[^/]+)",
          self._post_frame)
        r("GET", r"/schema", self._get_schema)

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
                status = _error_status(e)
                msg = str(e) or type(e).__name__
                if status == 500:
                    msg = f"internal error: {type(e).__name__}: {e}"
                return _json_resp({"error": msg}, status)
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

    def _post_frame(self, pv, params, body) -> Response:
        opts = _decode_options(body, {
            "rowLabel": "row_label", "inverseEnabled": "inverse_enabled",
            "cacheType": "cache_type", "cacheSize": "cache_size"})
        idx = self.holder.index(pv["index"])
        if idx is None:
            raise IndexNotFoundError()
        idx.create_frame(pv["frame"], **opts)
        return _json_resp({})

    def _post_query(self, pv, params, body) -> Response:
        slices = [int(s) for s in params.get("slices", "").split(",")
                  if s != ""]
        try:
            q = parse_string(body.decode())
            results = self.executor.execute(pv["index"], q, slices or None)
        except (PilosaError, ParseError) as e:
            return _json_resp({"error": str(e)}, 400)
        return _json_resp({"results": [_result_to_json(r) for r in results]})
