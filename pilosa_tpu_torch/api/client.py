"""InternalClient: an HTTP client bound to one node, and ClusterClient,
one such client a host sharing one circuit-breaker registry. The JAX
package's client (`pilosa_tpu/api/client.py`), stdlib urllib with the
bodies of the port's wire codec: bulk data in and out (import, export,
backup and restore, the block digests), the schema calls they need, and
the cluster's calls (a remote leg's query over protobuf, a replica's
import, /fragment/nodes, /internal/status, /internal/message) and
replica convergence's (the epoch digest and its floor-raise at
/internal/epochs, the attr-store diffs; the block digests and block
data take a deadline).

A transient failure (connection refused or reset, a timeout, 502 or
503, an open breaker) is retried up to `retry_max` times with a capped
exponential backoff and a jitter drawn from an explicit random.Random
(`rand`), within the call's deadline when it has one; every attempt is
gated by and reported to the host's breaker. A remote leg carries the
deadline's remaining budget as X-Pilosa-Deadline-Us, and the
coordinator's record: X-Pilosa-Trace (trace id : span id of the current
span) and, under an active profile, X-Pilosa-Profile: 1. The leg's
spans come back in X-Pilosa-Trace-Spans and are grafted under the
current span, tagged node=<peer>; its profile comes back in
X-Pilosa-Profile and goes under the profile's `remotes`. A malformed
one of either never fails the query. Every successful call adds its
request and response bodies to TIER_BYTES["http"] and charges them as
net_http_bytes to the ambient cost account (the system row for
background calls)."""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import fault
from ..errors import DeadlineExceededError, PilosaError
from ..obs import costs
from ..obs import profile as obs_profile
from ..obs.metrics import TIER_BYTES, StatMap
from ..obs.trace import current_span
from ..wire import (PROTOBUF_CT, BlockDataRequest, BlockDataResponse,
                    ImportRequest, NodeStatus, QueryRequest, QueryResponse,
                    result_from_proto)

# Transport counters of clients made without a StatMap of their own.
STATS = StatMap()

# Statuses that mean the node or a hop before it is overloaded or
# restarting: retried, and counted by the breaker.
_TRANSIENT_STATUS = frozenset((502, 503))

# The jitter's default source.
_RAND = random.Random()


class ClientError(PilosaError):
    """A failure of a call to `host`: `status` is the answer's HTTP
    status (None for a transport failure), `transient` whether another
    replica or a retry may succeed (a refused or reset connection, a
    timeout, 502 / 503, an open breaker) or the request itself is bad
    (4xx, a remote leg's error answer) and would fail on every
    replica."""

    def __init__(self, msg: str, host: Optional[str] = None,
                 status: Optional[int] = None, transient: bool = False):
        super().__init__(msg)
        self.host = host
        self.status = status
        self.transient = transient


BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half-open"


class CircuitBreaker:
    """A host's breaker: closed -> open after `threshold` failures in a
    row -> half-open once `cooldown` seconds passed, where one probe is
    let through; its success closes the breaker, its failure opens it
    again. threshold <= 0 turns it off. An open breaker fails a call at
    once with a transient ClientError, which the executor's re-split
    takes like a dead node. on_change(host, state) fires on the open and
    close edges, outside the lock."""

    def __init__(self, host: str, threshold: int = 5, cooldown: float = 5.0,
                 stats: Optional[StatMap] = None, on_change=None):
        self.host = host
        self.threshold = threshold
        self.cooldown = cooldown
        self.stats = stats if stats is not None else STATS
        self.on_change = on_change
        self._mu = threading.Lock()
        self._state = BREAKER_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False

    def _notify(self, state: str) -> None:
        if self.on_change is None:
            return
        try:
            self.on_change(self.host, state)
        except Exception:  # noqa: BLE001 — a hook never breaks a call
            pass

    @property
    def state(self) -> str:
        with self._mu:
            if (self._state == BREAKER_OPEN
                    and time.monotonic() - self._opened_at >= self.cooldown):
                return BREAKER_HALF_OPEN
            return self._state

    def allow(self) -> None:
        """Let one attempt through, or raise a transient ClientError."""
        if self.threshold <= 0:
            return
        with self._mu:
            if self._state == BREAKER_OPEN:
                if time.monotonic() - self._opened_at >= self.cooldown:
                    self._state = BREAKER_HALF_OPEN
                    self._probing = True
                    self.stats.inc("breaker.half_open")
                    return  # this caller is the probe
            elif self._state == BREAKER_HALF_OPEN:
                if not self._probing:
                    self._probing = True
                    return
            else:
                return
            self.stats.inc("breaker.reject")
        raise ClientError(f"{self.host}: circuit breaker open",
                          host=self.host, transient=True)

    def record_success(self) -> None:
        if self.threshold <= 0:
            return
        with self._mu:
            closed = self._state != BREAKER_CLOSED
            if closed:
                self.stats.inc("breaker.close")
            self._state = BREAKER_CLOSED
            self._failures = 0
            self._probing = False
        if closed:
            self._notify(BREAKER_CLOSED)

    def record_failure(self) -> None:
        if self.threshold <= 0:
            return
        opened = False
        with self._mu:
            self._failures += 1
            self._probing = False
            if (self._state == BREAKER_HALF_OPEN
                    or self._failures >= self.threshold):
                if self._state != BREAKER_OPEN:
                    self.stats.inc("breaker.open")
                    opened = True
                self._state = BREAKER_OPEN
                self._opened_at = time.monotonic()
        if opened:
            self._notify(BREAKER_OPEN)


class BreakerRegistry:
    """host -> CircuitBreaker, made at first use with one policy; the
    registry's on_change (settable later) reaches every breaker."""

    def __init__(self, threshold: int = 5, cooldown: float = 5.0,
                 stats: Optional[StatMap] = None, on_change=None):
        self.threshold = threshold
        self.cooldown = cooldown
        self.stats = stats
        self.on_change = on_change
        self._mu = threading.Lock()
        self._by_host: Dict[str, CircuitBreaker] = {}

    def for_host(self, host: str) -> CircuitBreaker:
        with self._mu:
            b = self._by_host.get(host)
            if b is None:
                b = self._by_host[host] = CircuitBreaker(
                    host, self.threshold, self.cooldown, stats=self.stats,
                    on_change=self._fire)
            return b

    def _fire(self, host: str, state: str) -> None:
        cb = self.on_change
        if cb is not None:
            cb(host, state)

    def state(self, host: str) -> str:
        with self._mu:
            b = self._by_host.get(host)
        return b.state if b is not None else BREAKER_CLOSED

    def snapshot(self) -> Dict[str, str]:
        with self._mu:
            hosts = list(self._by_host)
        return {h: self.state(h) for h in hosts}


def _host_url(host: str) -> str:
    if "://" not in host:
        host = "http://" + host
    return host.rstrip("/")


class InternalClient:
    # A retry's backoff never exceeds this many seconds.
    _BACKOFF_CAP = 2.0

    def __init__(self, host: str, timeout: float = 30.0, retry_max: int = 2,
                 retry_backoff: float = 0.05,
                 breaker: Optional[CircuitBreaker] = None,
                 stats: Optional[StatMap] = None,
                 rand: Optional[random.Random] = None):
        self.host = _host_url(host)
        self.timeout = timeout
        self.retry_max = retry_max
        self.retry_backoff = retry_backoff
        self.breaker = breaker
        self.stats = stats if stats is not None else STATS
        self.rand = rand if rand is not None else _RAND

    def _do(self, method: str, path: str, params: Optional[dict] = None,
            body: bytes = b"", content_type: str = "", accept: str = "",
            headers: Optional[dict] = None,
            resp_headers: Optional[dict] = None,
            deadline: Optional[float] = None) -> Tuple[int, bytes]:
        """(status, body) of one call; an error status is returned, not
        raised. A transient failure is retried (class docstring) and,
        once the retries are spent, raises a transient ClientError;
        DeadlineExceededError when the deadline leaves no attempt. A
        successful call's headers go into `resp_headers`, and its
        bodies' bytes into TIER_BYTES and the cost ledger."""
        url = self.host + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        what = f"{method} {url}"
        attempt = 0
        while True:
            timeout = self.timeout
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise DeadlineExceededError(
                        f"{what}: deadline exceeded by {-left * 1e6:.0f}us")
                timeout = min(timeout, left)
            if self.breaker is not None:
                self.breaker.allow()
            try:
                fault.point("client.do", host=self.host, method=method,
                            path=path, attempt=attempt)
                req = urllib.request.Request(url, data=body or None,
                                             method=method)
                if content_type:
                    req.add_header("Content-Type", content_type)
                if accept:
                    req.add_header("Accept", accept)
                for k, v in (headers or {}).items():
                    req.add_header(k, v)
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    if resp_headers is not None:
                        resp_headers.update(resp.headers.items())
                    data = resp.read()
                    if self.breaker is not None:
                        self.breaker.record_success()
                    nbytes = len(body or b"") + len(data)
                    TIER_BYTES.inc("http", nbytes)
                    costs.LEDGER.charge("net_http_bytes", nbytes)
                    return resp.status, data
            except urllib.error.HTTPError as e:
                data = e.read()
                if e.code not in _TRANSIENT_STATUS:
                    # The node answered: it is alive, the request is
                    # what failed.
                    if self.breaker is not None:
                        self.breaker.record_success()
                    return e.code, data
                err = ClientError(f"{what}: status={e.code}", host=self.host,
                                  status=e.code, transient=True)
            except (urllib.error.URLError, OSError) as e:
                err = ClientError(f"{what}: {e}", host=self.host,
                                  transient=True)
                err.__cause__ = e
            if self.breaker is not None:
                self.breaker.record_failure()
            self.stats.inc("client.transport_error")
            attempt += 1
            if attempt > self.retry_max:
                raise err
            delay = min(self.retry_backoff * (1 << (attempt - 1)),
                        self._BACKOFF_CAP)
            delay *= 0.5 + self.rand.random()  # jitter in [0.5x, 1.5x)
            if deadline is not None and time.monotonic() + delay >= deadline:
                raise DeadlineExceededError(
                    f"{what}: deadline leaves no retry budget") from err
            self.stats.inc("client.retry")
            time.sleep(delay)

    def _check(self, status: int, data: bytes, what: str):
        if status >= 400:
            try:
                msg = json.loads(data.decode()).get("error", "")
            except (ValueError, AttributeError):
                msg = data[:200].decode(errors="replace")
            raise ClientError(f"{what}: status={status} {msg}",
                              host=self.host, status=status,
                              transient=status in _TRANSIENT_STATUS)

    # -- the cluster's calls ---------------------------------------------------

    def execute_remote(self, node, index: str, query: str,
                       slices: Sequence[int], remote: bool = True,
                       deadline: Optional[float] = None) -> list:
        """A query over protobuf (the JAX client's execute_query): the
        QueryRequest with the PQL, the slices and `remote`, the executor
        results back. `node` is taken for the executor's seam; this
        client is bound to one host. `deadline` (time.monotonic()) rides
        as X-Pilosa-Deadline-Us and bounds this call's waits and
        retries. The peer's error answer (QueryResponse.err) raises a
        non-transient ClientError: a replica would fail the same way."""
        body = QueryRequest(query=query, slices=[int(s) for s in slices],
                            remote=remote).encode()
        cur = current_span()
        prof = obs_profile.current()
        hdrs = {}
        if cur is not None:
            hdrs["X-Pilosa-Trace"] = f"{cur.trace.trace_id}:{cur.span_id}"
        if prof is not None:
            hdrs["X-Pilosa-Profile"] = "1"
        if deadline is not None:
            left = deadline - time.monotonic()
            if left <= 0:
                raise DeadlineExceededError(
                    f"query to {self.host}: deadline exceeded by "
                    f"{-left * 1e6:.0f}us")
            hdrs["X-Pilosa-Deadline-Us"] = str(int(left * 1e6))
        rhdrs: dict = {}
        status, data = self._do(
            "POST", f"/index/{index}/query", body=body,
            content_type=PROTOBUF_CT, accept=PROTOBUF_CT,
            headers=hdrs or None,
            resp_headers=rhdrs if (cur is not None or prof is not None)
            else None, deadline=deadline)
        rh = {k.lower(): v for k, v in rhdrs.items()}
        if cur is not None and rh.get("x-pilosa-trace-spans"):
            try:
                cur.trace.graft(json.loads(rh["x-pilosa-trace-spans"]),
                                cur.span_id, node=self.host)
            except (ValueError, KeyError, TypeError):
                pass  # malformed remote spans never fail the query
        if prof is not None and rh.get("x-pilosa-profile"):
            try:
                prof.merge_remote(self.host,
                                  json.loads(rh["x-pilosa-profile"]))
            except (ValueError, KeyError, TypeError):
                pass  # a malformed remote profile never fails the query
        try:
            resp = QueryResponse.decode(data)
        except Exception:
            self._check(status, data, "query")
            raise
        if resp.err:
            raise ClientError(resp.err, host=self.host, status=status,
                              transient=False)
        self._check(status, data, "query")
        return [result_from_proto(r) for r in resp.results]

    def fragment_nodes(self, index: str, slice_: int) -> List[dict]:
        """The slice's owners, [{"host", "internalHost"}]."""
        status, data = self._do("GET", "/fragment/nodes",
                                params={"index": index, "slice": slice_})
        self._check(status, data, "fragment/nodes")
        return json.loads(data.decode())

    def node_status(self) -> NodeStatus:
        """GET /internal/status: the node's schema and max slices."""
        status, data = self._do("GET", "/internal/status")
        self._check(status, data, "internal/status")
        return NodeStatus.decode(data)

    def send_message(self, data: bytes):
        """POST a framed broadcast message to /internal/message."""
        status, resp = self._do("POST", "/internal/message", body=data,
                                content_type="application/octet-stream")
        self._check(status, resp, "internal/message")

    def epoch_digest(self) -> dict:
        """GET /internal/epochs: {"host", "epochs": {fragment key:
        epoch}, "queue_depth"}."""
        status, data = self._do("GET", "/internal/epochs")
        self._check(status, data, "internal/epochs")
        return json.loads(data.decode())

    def advance_epochs(self, epochs: dict) -> int:
        """POST /internal/epochs/advance: floor-raise the node's
        fragment epochs; returns how many it raised."""
        body = json.dumps({"epochs": {str(k): int(v)
                                      for k, v in epochs.items()}}).encode()
        status, data = self._do("POST", "/internal/epochs/advance",
                                body=body, content_type="application/json")
        self._check(status, data, "internal/epochs/advance")
        try:
            return int(json.loads(data.decode()).get("applied", 0))
        except ValueError:
            return 0

    def column_attr_diff(self, index: str,
                         blocks: List[Tuple[int, bytes]]) -> Dict[int, dict]:
        """The index's column attrs of the blocks where this node's
        store differs from `blocks` (this side's checksums)."""
        return self._attr_diff(f"/index/{index}/attr/diff", blocks)

    def row_attr_diff(self, index: str, frame: str,
                      blocks: List[Tuple[int, bytes]]) -> Dict[int, dict]:
        return self._attr_diff(f"/index/{index}/frame/{frame}/attr/diff",
                               blocks)

    def _attr_diff(self, path: str,
                   blocks: List[Tuple[int, bytes]]) -> Dict[int, dict]:
        body = json.dumps({"blocks": [{"id": int(bid), "checksum": cs.hex()}
                                      for bid, cs in blocks]}).encode()
        status, data = self._do("POST", path, body=body,
                                content_type="application/json")
        self._check(status, data, "attr/diff")
        return {int(k): v
                for k, v in json.loads(data.decode())["attrs"].items()}

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
                    timestamps: Optional[Sequence[int]] = None,
                    remote: bool = False) -> int:
        """POST /import: one protobuf ImportRequest. `timestamps` are
        seconds since the epoch (0: none). `remote` marks a batch already
        coordinated (a replica's copy or a hint replay): the node applies
        it and fans it out no further. Returns the body's bytes."""
        req = ImportRequest(index=index, frame=frame, slice=slice_,
                            row_ids=row_ids, column_ids=column_ids)
        if timestamps is not None and len(timestamps):
            req.timestamps = np.asarray(timestamps, dtype=np.int64)
        body = req.encode()
        status, data = self._do("POST", "/import",
                                params={"remote": "true"} if remote
                                else None, body=body,
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
                        slice_: int, deadline: Optional[float] = None
                        ) -> List[Tuple[int, bytes]]:
        """[(block id, SHA-1)]; a fragment the node lacks reads empty.
        `deadline` (time.monotonic()) bounds the waits and retries."""
        status, data = self._do("GET", "/fragment/blocks", params={
            "index": index, "frame": frame, "view": view, "slice": slice_},
            deadline=deadline)
        if status == 404:
            return []
        self._check(status, data, "fragment/blocks")
        return [(int(b["id"]), bytes.fromhex(b["checksum"]))
                for b in json.loads(data.decode())["blocks"]]

    def block_data(self, index: str, frame: str, view: str, slice_: int,
                   block: int, deadline: Optional[float] = None
                   ) -> Tuple[List[int], List[int]]:
        """(row ids, slice-local column ids) of one block, over protobuf;
        a fragment the node lacks reads empty."""
        req = BlockDataRequest(index=index, frame=frame, view=view,
                               slice=slice_, block=block)
        status, data = self._do("GET", "/fragment/block/data",
                                body=req.encode(), content_type=PROTOBUF_CT,
                                accept=PROTOBUF_CT, deadline=deadline)
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


class ClusterClient:
    """The executor's client seam over the cluster: one InternalClient a
    host, all sharing one StatMap (/debug/vars `cluster`) and one
    BreakerRegistry, whose state(host) placement reads."""

    def __init__(self, timeout: float = 30.0, retry_max: int = 2,
                 retry_backoff: float = 0.05, breaker_threshold: int = 5,
                 breaker_cooldown: float = 5.0):
        self.timeout = timeout
        self.retry_max = retry_max
        self.retry_backoff = retry_backoff
        self.stats = StatMap()
        self.breakers = BreakerRegistry(breaker_threshold, breaker_cooldown,
                                        stats=self.stats)
        self._clients: Dict[str, InternalClient] = {}
        self._lock = threading.Lock()

    def for_host(self, host: str) -> InternalClient:
        with self._lock:
            c = self._clients.get(host)
            if c is None:
                c = self._clients[host] = InternalClient(
                    host, timeout=self.timeout, retry_max=self.retry_max,
                    retry_backoff=self.retry_backoff,
                    breaker=self.breakers.for_host(host), stats=self.stats)
            return c

    def breaker_state(self, host: str) -> str:
        return self.breakers.state(host)

    def execute_query(self, node, index, query, slices, remote=True,
                      deadline=None):
        return self.for_host(node.host).execute_remote(
            node, index, query, slices, remote=remote, deadline=deadline)
