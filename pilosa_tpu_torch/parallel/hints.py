"""Hinted handoff: the durable journal of replicated writes an owner
missed, replayed once it is back.

The JAX package's pilosa_tpu/parallel/hints.py. A write that reached
its consistency level but missed a replica (node DOWN, breaker open, a
transient failure) leaves a hint for that replica; a drainer replays
the hints once the target answers again, so replicas converge seconds
after a restart.

One append-only log a target under `<data-dir>/.hints/<host>.hintlog`,
records framed as

    u8 magic (0xF9) | u32 payload_len | payload (JSON) | u32 fnv32a(payload)

with the JAX package's bytes (encode_hint), so a log written by either
package replays through the other. Two kinds: {"kind": "query", "host",
"index", "pql"} replayed as a remote leg's query, and {"kind": "import",
"host", "index", "frame", "slice", "rows", "cols", "ts"} as a remote
import; both are idempotent, so a drainer that dies between the
target's answer and the log's truncation only replays again. Either
may carry `epochs` ({fragment key: the writer's epoch after the
write}): once the replay landed, the drainer floor-raises the target's
fragments to them (client.advance_epochs), so its epoch digest compares
with the writer's; that step is advisory, its failure only leaves the
target looking staler.

An append goes through a core.wal.WalCommitter and returns after its
group commit: a hint is as durable as the write it repairs. Opening a
log keeps its valid prefix and truncates at the first damaged record
(counted in `torn_tails`). Past `max_bytes` a target's oldest hints
spill first (`dropped:<target>`).

The drainer is one thread: each `drain_interval`, or at once on
notify(host), it replays every non-empty log in order, skips a target
whose breaker is open, stops a log at its first failure and truncates
only what the target answered.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from .. import fault
from ..core.wal import WalCommitter, WalConfig
from ..obs.health import HEALTH
from ..obs.metrics import StatMap
from ..roaring.serialize import fnv32a

HINT_MAGIC = 0xF9
_HEADER = struct.Struct("<BI")   # magic, payload length
_CRC = struct.Struct("<I")

# Process-wide counters: "queued:<target>", "replayed:<target>",
# "dropped:<target>", "torn_tails", "replay_failures" (/metrics
# pilosa_hints_*_total{target}).
HINT_STATS = StatMap()

DEFAULT_HINT_MAX_BYTES = 64 << 20
DEFAULT_DRAIN_INTERVAL = 1.0

_log = logging.getLogger("pilosa_tpu_torch.hints")


def _sanitize(host: str) -> str:
    """A log's file name for a host ("127.0.0.1:10101")."""
    return "".join(ch if ch.isalnum() or ch in "._-" else "_"
                   for ch in host) or "_"


def encode_hint(payload: dict) -> bytes:
    body = json.dumps(payload, separators=(",", ":"),
                      sort_keys=True).encode()
    return (_HEADER.pack(HINT_MAGIC, len(body)) + body
            + _CRC.pack(fnv32a(body)))


def scan_hints(data: bytes):
    """(payloads, valid bytes): the records up to the first damaged one
    (a partial tail, a bad checksum, a payload that is no JSON)."""
    out: List[dict] = []
    off, n = 0, len(data)
    while off + _HEADER.size <= n:
        magic, length = _HEADER.unpack_from(data, off)
        end = off + _HEADER.size + length + _CRC.size
        if magic != HINT_MAGIC or end > n:
            break
        body = data[off + _HEADER.size:end - _CRC.size]
        if _CRC.unpack_from(data, end - _CRC.size)[0] != fnv32a(body):
            break
        try:
            out.append(json.loads(body.decode()))
        except ValueError:
            break
        off = end
    return out, off


class HintLog:
    """One target's journal; every change under `_mu` (the committer's
    own lock nests inside it, never the other way)."""

    def __init__(self, path: str, target: str, wal_cfg: WalConfig,
                 max_bytes: int = DEFAULT_HINT_MAX_BYTES):
        self.path = path
        self.target = target
        self.max_bytes = int(max_bytes)
        self._mu = threading.RLock()
        self._records: deque = deque()   # (payload, encoded length)
        self._bytes = 0
        self._fh = None
        self._committer = WalCommitter(wal_cfg, path=path)
        self._open()

    def _open(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        data = b""
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                data = f.read()
        payloads, valid = scan_hints(data)
        if valid < len(data):
            _log.warning("hint log %s: truncating %d damaged byte(s) at "
                         "offset %d (torn tail)", self.path,
                         len(data) - valid, valid)
            HINT_STATS.inc("torn_tails")
            with open(self.path, "r+b") as f:
                f.truncate(valid)
                f.flush()
                os.fsync(f.fileno())
        for p in payloads:
            self._records.append((p, len(encode_hint(p))))
        self._bytes = valid
        self._fh = open(self.path, "ab", buffering=0)
        self._committer.retarget(self._fh)

    def append(self, payload: dict) -> None:
        """Journal one hint; returns after its group commit."""
        rec = encode_hint(payload)
        with self._mu:
            if self.max_bytes > 0 and self._bytes + len(rec) > self.max_bytes:
                self._spill_locked(len(rec))
            self._committer.write(rec)
            seq = self._committer.seq()
            self._records.append((payload, len(rec)))
            self._bytes += len(rec)
        self._committer.wait_durable(seq)
        HINT_STATS.inc(f"queued:{self.target}")

    def _spill_locked(self, need: int) -> None:
        """Drop the oldest hints until `need` bytes fit."""
        dropped = 0
        while self._records and self._bytes + need > self.max_bytes:
            _, length = self._records.popleft()
            self._bytes -= length
            dropped += 1
        if dropped:
            HINT_STATS.inc(f"dropped:{self.target}", dropped)
            _log.warning("hint log %s: spilled %d oldest hint(s) "
                         "(hint-max-bytes=%d)", self.path, dropped,
                         self.max_bytes)
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Rewrite the log to the live records (tmp, fsync, rename) and
        point the committer at the new file."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for p, _length in self._records:
                f.write(encode_hint(p))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        if self._fh is not None:
            self._fh.close()
        self._fh = open(self.path, "ab", buffering=0)
        self._committer.retarget(self._fh)
        self._bytes = sum(length for _, length in self._records)

    def peek_all(self) -> List[dict]:
        with self._mu:
            return [p for p, _ in self._records]

    def ack(self, n: int) -> None:
        """The target took the first `n` records: drop them and compact
        (after the answer: a crash between replays them again)."""
        if n <= 0:
            return
        with self._mu:
            for _ in range(min(n, len(self._records))):
                self._records.popleft()
            self._compact_locked()

    def record_count(self) -> int:
        with self._mu:
            return len(self._records)

    def byte_size(self) -> int:
        with self._mu:
            return self._bytes

    def close(self):
        with self._mu:
            self._committer.detach()
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class HintManager:
    """Every target's log and the drainer. `client_factory(host)` gives
    an api.client.InternalClient (the replay's transport);
    `breaker_state(host)` keeps replays off an open breaker (a half-open
    one takes the first replay as its probe); `stats` (the server's
    stats client) counts hintReplayN."""

    def __init__(self, directory: str,
                 client_factory: Optional[Callable] = None,
                 breaker_state: Optional[Callable[[str], str]] = None,
                 max_bytes: int = DEFAULT_HINT_MAX_BYTES,
                 drain_interval: float = DEFAULT_DRAIN_INTERVAL,
                 wal_cfg: Optional[WalConfig] = None, stats=None):
        self.directory = directory
        self.client_factory = client_factory
        self.breaker_state = breaker_state
        self.max_bytes = int(max_bytes)
        self.drain_interval = float(drain_interval)
        self.wal_cfg = wal_cfg or WalConfig()
        self.stats = stats
        self._mu = threading.Lock()
        self._logs: Dict[str, HintLog] = {}
        self._wake = threading.Event()
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._hb = None
        self._recover_existing()

    def _recover_existing(self):
        """Reopen the logs a former run left, so a restarted node keeps
        its repair duties; empty ones are removed."""
        if not os.path.isdir(self.directory):
            return
        for name in sorted(os.listdir(self.directory)):
            if not name.endswith(".hintlog"):
                continue
            path = os.path.join(self.directory, name)
            target = name[:-len(".hintlog")]
            try:
                log = HintLog(path, target, self.wal_cfg,
                              max_bytes=self.max_bytes)
            except OSError as e:
                _log.warning("hint log %s unreadable: %s", path, e)
                continue
            if log.record_count() == 0:
                log.close()
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            self._logs[target] = log

    def start(self):
        """Start the drainer (the `hint-drain` heartbeat, critical)."""
        if self._thread is not None:
            return
        self._hb = HEALTH.register("hint-drain",
                                   interval=self.drain_interval,
                                   critical=True)
        self._thread = threading.Thread(target=self._drain_loop,
                                        name="hint-drain", daemon=True)
        self._thread.start()

    def close(self):
        self._closed.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
            HEALTH.unregister("hint-drain")
        with self._mu:
            for log in self._logs.values():
                log.close()
            self._logs.clear()

    def _log_for(self, host: str) -> HintLog:
        key = _sanitize(host)
        with self._mu:
            log = self._logs.get(key)
            if log is None:
                log = self._logs[key] = HintLog(
                    os.path.join(self.directory, key + ".hintlog"), key,
                    self.wal_cfg, max_bytes=self.max_bytes)
            return log

    def enqueue_query(self, host: str, index: str, pql: str,
                      epochs: Optional[dict] = None) -> None:
        """Journal a missed PQL write (SetBit, ClearBit, SetValue, the
        attr calls) for `host`, in its canonical serialization, with the
        epochs it brought the writer's fragments to."""
        payload = {"kind": "query", "host": host, "index": index,
                   "pql": pql}
        if epochs:
            payload["epochs"] = {str(k): int(v) for k, v in epochs.items()}
        self._log_for(host).append(payload)

    def enqueue_import(self, host: str, index: str, frame: str,
                       slice_: int, rows, cols, ts=None,
                       epochs: Optional[dict] = None) -> None:
        payload = {
            "kind": "import", "host": host, "index": index,
            "frame": frame, "slice": int(slice_),
            "rows": [int(r) for r in rows],
            "cols": [int(c) for c in cols],
            "ts": [int(t) for t in ts] if ts is not None and len(ts)
            else None}
        if epochs:
            payload["epochs"] = {str(k): int(v) for k, v in epochs.items()}
        self._log_for(host).append(payload)

    def notify(self, host: str) -> None:
        """`host` is back (status poll, breaker close): drain now."""
        self._wake.set()

    def _drain_loop(self):
        while not self._closed.is_set():
            self._wake.wait(self.drain_interval)
            self._wake.clear()
            if self._closed.is_set():
                return
            self._hb.beat()
            try:
                self.drain_once()
            except Exception as e:  # noqa: BLE001 — the drainer never dies
                _log.warning("hint drain pass failed: %s", e)

    def drain_once(self) -> int:
        """One replay pass over every non-empty log; the hints replayed."""
        with self._mu:
            logs = dict(self._logs)
        replayed = 0
        for target, log in logs.items():
            if self._closed.is_set():
                break
            if log.record_count() == 0:
                continue
            host = None
            acked = 0
            try:
                for payload in log.peek_all():
                    if self._closed.is_set():
                        break
                    host = payload.get("host", target)
                    state = (self.breaker_state(host)
                             if self.breaker_state is not None else "closed")
                    if state == "open":
                        break  # wait for half-open or notify
                    fault.point("hints.replay", target=host,
                                kind=payload.get("kind", ""))
                    with HEALTH.inflight("hint-drain", "replay",
                                         base=max(30.0,
                                                  4 * self.drain_interval)):
                        self._replay(host, payload)
                    acked += 1
            except Exception as e:  # noqa: BLE001 — stop, keep the order
                HINT_STATS.inc("replay_failures")
                _log.info("hint replay to %s stopped after %d: %s",
                          host or target, acked, e)
            if acked:
                log.ack(acked)
                HINT_STATS.inc(f"replayed:{target}", acked)
                replayed += acked
                if self.stats is not None:
                    self.stats.count("hintReplayN", acked)
        return replayed

    def _replay(self, host: str, payload: dict) -> None:
        if self.client_factory is None:
            raise RuntimeError("hint replay has no client factory")
        client = self.client_factory(host)
        kind = payload.get("kind")
        if kind == "query":
            client.execute_remote(None, payload["index"], payload["pql"], [],
                                  remote=True)
        elif kind == "import":
            client.import_bits(payload["index"], payload["frame"],
                               payload["slice"], payload["rows"],
                               payload["cols"], payload.get("ts"),
                               remote=True)
        else:
            raise ValueError(f"unknown hint kind: {kind!r}")
        epochs = payload.get("epochs")
        advance = getattr(client, "advance_epochs", None)
        if epochs and advance is not None:
            # After the ops landed: an epoch never vouches for bits the
            # target does not hold yet.
            try:
                advance(epochs)
            except Exception:  # noqa: BLE001 — advisory
                pass

    def backlog_records(self) -> int:
        with self._mu:
            logs = list(self._logs.values())
        return sum(log.record_count() for log in logs)

    def backlog_bytes_by_target(self) -> Dict[str, int]:
        with self._mu:
            logs = dict(self._logs)
        return {t: log.byte_size() for t, log in logs.items()
                if log.record_count() > 0}

    def snapshot(self) -> dict:
        """/debug/vars `hints`: each target's queue and the counters."""
        with self._mu:
            logs = dict(self._logs)
        stats = HINT_STATS.copy()
        targets = {t: {"records": log.record_count(),
                       "bytes": log.byte_size(),
                       "queued_total": stats.get(f"queued:{t}", 0),
                       "replayed_total": stats.get(f"replayed:{t}", 0),
                       "dropped_total": stats.get(f"dropped:{t}", 0)}
                   for t, log in logs.items()}
        return {"targets": targets,
                "backlog_records": sum(v["records"]
                                       for v in targets.values()),
                "backlog_bytes": sum(v["bytes"] for v in targets.values()),
                "torn_tails": stats.get("torn_tails", 0),
                "replay_failures": stats.get("replay_failures", 0)}

    def wait_drained(self, timeout: float = 10.0) -> bool:
        """Wait until every backlog is empty, waking the drainer."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.backlog_records() == 0:
                return True
            self._wake.set()
            time.sleep(0.05)
        return self.backlog_records() == 0
