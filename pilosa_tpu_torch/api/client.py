"""InternalClient: an HTTP client bound to one node, for bulk data in
and out: import, export, backup and restore, the block digests, and the
schema calls they need. A reduced copy of the JAX package's client
(`pilosa_tpu/api/client.py`): stdlib urllib with a timeout, the bodies
of the port's wire codec; no retries and no circuit breakers (those
come with the cluster)."""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..errors import PilosaError
from ..wire import (PROTOBUF_CT, BlockDataRequest, BlockDataResponse,
                    ImportRequest)


class ClientError(PilosaError):
    """A transport failure (status None) or an error answer (its HTTP
    status) of a call to `host`."""

    def __init__(self, msg: str, host: Optional[str] = None,
                 status: Optional[int] = None):
        super().__init__(msg)
        self.host = host
        self.status = status


def _host_url(host: str) -> str:
    if "://" not in host:
        host = "http://" + host
    return host.rstrip("/")


class InternalClient:
    def __init__(self, host: str, timeout: float = 30.0):
        self.host = _host_url(host)
        self.timeout = timeout

    def _do(self, method: str, path: str, params: Optional[dict] = None,
            body: bytes = b"", content_type: str = "",
            accept: str = "") -> Tuple[int, bytes]:
        """(status, body) of one call; an error status is returned, not
        raised, and a transport failure raises ClientError."""
        url = self.host + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(url, data=body or None, method=method)
        if content_type:
            req.add_header("Content-Type", content_type)
        if accept:
            req.add_header("Accept", accept)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except (urllib.error.URLError, OSError) as e:
            raise ClientError(f"{method} {url}: {e}", host=self.host) from e

    def _check(self, status: int, data: bytes, what: str):
        if status >= 400:
            try:
                msg = json.loads(data.decode()).get("error", "")
            except (ValueError, AttributeError):
                msg = data[:200].decode(errors="replace")
            raise ClientError(f"{what}: status={status} {msg}",
                              host=self.host, status=status)

    # -- queries -------------------------------------------------------------

    def execute_query(self, index: str, query: str,
                      slices: Optional[Sequence[int]] = None) -> list:
        """POST /index/{index}/query with a PQL body (`?slices=` when
        given); the results list, as JSON."""
        params = {"slices": ",".join(str(int(s)) for s in slices)} \
            if slices else None
        status, data = self._do("POST", f"/index/{index}/query",
                                params=params, body=query.encode(),
                                content_type="text/plain")
        self._check(status, data, "query")
        return json.loads(data.decode())["results"]

    # -- import / export -----------------------------------------------------

    def import_bits(self, index: str, frame: str, slice_: int,
                    row_ids: Sequence[int], column_ids: Sequence[int],
                    timestamps: Optional[Sequence[int]] = None) -> int:
        """POST /import: one protobuf ImportRequest. `timestamps` are
        seconds since the epoch (0: none). Returns the body's bytes."""
        req = ImportRequest(index=index, frame=frame, slice=slice_,
                            row_ids=row_ids, column_ids=column_ids)
        if timestamps is not None and len(timestamps):
            req.timestamps = np.asarray(timestamps, dtype=np.int64)
        body = req.encode()
        status, data = self._do("POST", "/import", body=body,
                                content_type=PROTOBUF_CT)
        self._check(status, data, "import")
        return len(body)

    def export_csv(self, index: str, frame: str, view: str,
                   slice_: int) -> str:
        status, data = self._do("GET", "/export", params={
            "index": index, "frame": frame, "view": view, "slice": slice_})
        self._check(status, data, "export")
        return data.decode()

    # -- schema --------------------------------------------------------------

    def schema(self) -> List[dict]:
        status, data = self._do("GET", "/schema")
        self._check(status, data, "schema")
        return json.loads(data.decode())["indexes"]

    def max_slices(self, inverse: bool = False) -> Dict[str, int]:
        params = {"inverse": "true"} if inverse else None
        status, data = self._do("GET", "/slices/max", params=params)
        self._check(status, data, "slices/max")
        return {k: int(v)
                for k, v in json.loads(data.decode())["maxSlices"].items()}

    def frame_views(self, index: str, frame: str) -> List[str]:
        status, data = self._do("GET", f"/index/{index}/frame/{frame}/views")
        self._check(status, data, "views")
        return json.loads(data.decode())["views"]

    def create_index(self, index: str, **options):
        """Create an index; one that exists already (409) is no error."""
        body = json.dumps({"options": options}).encode() if options else b"{}"
        status, data = self._do("POST", f"/index/{index}", body=body,
                                content_type="application/json")
        if status != 409:
            self._check(status, data, "create index")

    def create_frame(self, index: str, frame: str, **options):
        """Create a frame; one that exists already (409) is no error."""
        body = json.dumps({"options": options}).encode() if options else b"{}"
        status, data = self._do("POST", f"/index/{index}/frame/{frame}",
                                body=body, content_type="application/json")
        if status != 409:
            self._check(status, data, "create frame")

    # -- block digests ---------------------------------------------------------

    def fragment_blocks(self, index: str, frame: str, view: str,
                        slice_: int) -> List[Tuple[int, bytes]]:
        """[(block id, SHA-1)]; a fragment the node lacks reads empty."""
        status, data = self._do("GET", "/fragment/blocks", params={
            "index": index, "frame": frame, "view": view, "slice": slice_})
        if status == 404:
            return []
        self._check(status, data, "fragment/blocks")
        return [(int(b["id"]), bytes.fromhex(b["checksum"]))
                for b in json.loads(data.decode())["blocks"]]

    def block_data(self, index: str, frame: str, view: str, slice_: int,
                   block: int) -> Tuple[List[int], List[int]]:
        """(row ids, slice-local column ids) of one block, over protobuf;
        a fragment the node lacks reads empty."""
        req = BlockDataRequest(index=index, frame=frame, view=view,
                               slice=slice_, block=block)
        status, data = self._do("GET", "/fragment/block/data",
                                body=req.encode(), content_type=PROTOBUF_CT,
                                accept=PROTOBUF_CT)
        if status == 404:
            return [], []
        self._check(status, data, "fragment/block/data")
        resp = BlockDataResponse.decode(data)
        return resp.row_ids.tolist(), resp.column_ids.tolist()

    # -- backup / restore ------------------------------------------------------

    def fragment_data(self, index: str, frame: str, view: str,
                      slice_: int) -> Optional[bytes]:
        """The fragment's tar (GET /fragment/data); None when the node
        has no such fragment."""
        status, data = self._do("GET", "/fragment/data", params={
            "index": index, "frame": frame, "view": view, "slice": slice_})
        if status == 404:
            return None
        self._check(status, data, "fragment/data")
        return data

    def restore_fragment(self, index: str, frame: str, view: str,
                         slice_: int, tar_bytes: bytes):
        status, data = self._do("POST", "/fragment/data", params={
            "index": index, "frame": frame, "view": view, "slice": slice_},
            body=tar_bytes, content_type="application/octet-stream")
        self._check(status, data, "fragment/data")
