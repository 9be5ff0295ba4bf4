"""Liveness plane: heartbeats, in-flight op tracking, a stall/hang
watchdog, and diagnostic dossiers (the JAX package's obs/health.py, with
its names and its dossier schema).

The tracer, the SLO recorder and the cost ledger all need a request to
come back. This layer tells an operator that a loop (the WAL group
committer, a snapshot writer, the scrubber, the card's batch thread)
has silently stopped, in three parts:

- **Heartbeat**: every long-lived loop registers one by name and calls
  `beat()` each iteration. A loop with a pacing knob registers its
  interval; the watchdog flips it to STALLED when the last beat is
  older than `stall-after x interval`. Pure event loops register with
  `interval=None`: they appear in the table and the dossiers, but only
  their in-flight brackets are judged. `idle()` marks a loop parked on
  purpose, so idleness never reads as a hang.

- **InFlight**: every op that may block (a WAL commit's fsync, a
  snapshot write, a group of counts on the card) brackets itself with
  `HEALTH.inflight(subsystem, kind, base)`. Its deadline is `base x
  stall-after`; an op past it trips its subsystem with kind="inflight".
  An op still inside its deadline excuses its loop's heartbeat age.

- **Watchdog**: one sweep thread ("health-watchdog") walks the registry
  every `sweep-interval`. On each OK -> STALLED edge it counts a trip
  (`pilosa_watchdog_trips_total{subsystem,kind}`), logs the stuck
  thread's stack, and writes one **dossier** a trip edge (reset on
  recovery): a bounded JSON bundle under `<data-dir>/.dossier/` with
  every thread's stack, the health table, and the sections the server
  wired in (slow queries, query shapes, SLO status, costs, redacted
  config). `GET /debug/bundle` and `ctl diagnose` produce the same
  bundle on demand.

One process-global `HEALTH`, near-free when `enabled` is False (beat()
is one attribute read; inflight() returns a shared no-op). Peers'
gossiped health and the `watchdog.stall` fault seam come with the
cluster and the rest of the seams (ROADMAP A11, A9b); `peers` stays
empty.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from .log import get_logger
from .metrics import StatMap

OK = "ok"
STALLED = "stalled"

DOSSIER_SCHEMA = "pilosa-tpu/dossier/v1"
DOSSIER_PREFIX = "dossier-"

_MAX_STACK_FRAMES = 40


def thread_stacks(limit: int = _MAX_STACK_FRAMES) -> List[dict]:
    """Every live thread's stack, attributed by thread *name*: a dossier
    full of `Thread-7` frames is a puzzle, one full of `wal` /
    `mesh-count-batch` frames is a diagnosis."""
    by_id = {t.ident: t for t in threading.enumerate()}
    out = []
    for tid, frame in sorted(sys._current_frames().items()):
        t = by_id.get(tid)
        stack = traceback.format_stack(frame)[-limit:]
        out.append({
            "thread_id": tid,
            "name": t.name if t is not None else f"thread-{tid}",
            "daemon": bool(t.daemon) if t is not None else None,
            "stack": [s.rstrip("\n") for s in stack],
        })
    return out


def thread_stack(tid: Optional[int],
                 limit: int = _MAX_STACK_FRAMES) -> List[str]:
    """One thread's current stack (empty if it is gone)."""
    if not tid:
        return []
    frame = sys._current_frames().get(tid)
    if frame is None:
        return []
    return [s.rstrip("\n") for s in traceback.format_stack(frame)[-limit:]]


_SENSITIVE = ("secret", "password", "token", "credential", "apikey",
              "api_key", "private")


def redact_config(cfg: dict) -> dict:
    """JSON-safe copy of a config dict with anything that smells like
    a credential masked — a dossier gets attached to tickets and
    shipped to vendors; the config section must be safe to share."""
    out = {}
    for key, val in sorted(cfg.items()):
        if key.startswith("_"):
            continue
        lk = key.lower()
        if any(s in lk for s in _SENSITIVE):
            out[key] = "<redacted>"
        elif isinstance(val, (str, int, float, bool, type(None))):
            out[key] = val
        elif isinstance(val, (list, tuple)):
            out[key] = [v if isinstance(v, (str, int, float, bool))
                        else str(v) for v in val]
        elif isinstance(val, dict):
            out[key] = {str(k): (v if isinstance(v, (str, int, float,
                                                     bool)) else str(v))
                        for k, v in val.items()}
        else:
            out[key] = str(val)
    return out


class Heartbeat:
    """One long-lived loop's pulse. `beat()` is the hot path: with the
    registry disabled it is a single attribute read; enabled it is a
    handful of unlocked attribute writes (one writer — the loop's own
    thread; the watchdog reads racily, which is fine for monotonic
    timestamps)."""

    __slots__ = ("name", "interval", "critical", "last_beat", "beats",
                 "parked", "thread_id", "thread_name", "_reg")

    def __init__(self, name: str, interval: Optional[float],
                 critical: bool, reg: "HealthRegistry"):
        self.name = name
        self.interval = interval
        self.critical = critical
        self._reg = reg
        self.last_beat = time.monotonic()
        self.beats = 0
        self.parked = False
        self.thread_id = 0
        self.thread_name = ""

    def beat(self) -> None:
        if not self._reg.enabled:
            return
        # Un-park and stamp the thread's identity, then the beat.
        self.parked = False
        tid = threading.get_ident()
        if tid != self.thread_id:
            self.thread_id = tid
            self.thread_name = threading.current_thread().name
        self.last_beat = time.monotonic()
        self.beats += 1

    def idle(self) -> None:
        """The loop is about to park with nothing to do (queue empty,
        condition wait). A parked heartbeat is never age-judged."""
        self.parked = True


class _NoopInFlight:
    """Shared do-nothing bracket returned when the registry is off —
    the fast path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_INFLIGHT = _NoopInFlight()


class InFlight:
    """One potentially-blocking op: subsystem, kind, start monotonic,
    owning thread, and deadline (`base × stall-after`; None = tracked
    for visibility, never judged)."""

    __slots__ = ("subsystem", "kind", "start", "bound", "thread_id",
                 "thread_name", "_reg")

    def __init__(self, reg: "HealthRegistry", subsystem: str, kind: str,
                 bound: Optional[float]):
        self._reg = reg
        self.subsystem = subsystem
        self.kind = kind
        self.bound = bound
        self.start = 0.0
        self.thread_id = 0
        self.thread_name = ""

    def __enter__(self):
        self.start = time.monotonic()
        t = threading.current_thread()
        self.thread_id = t.ident or 0
        self.thread_name = t.name
        self._reg._track(self)
        return self

    def __exit__(self, *exc):
        self._reg._untrack(self)
        return False


class HealthRegistry:
    """The liveness ledger. One process-global instance (`HEALTH`);
    tests may build private ones. Server wiring sets the knobs from
    `[health]` config, points `dossier_dir` under the data dir, and
    registers bundle providers; library code only ever registers
    heartbeats and brackets in-flight ops."""

    def __init__(self):
        self.enabled = True
        self.stall_after = 4.0       # deadline multiple for beats + ops
        self.sweep_interval = 1.0    # watchdog period, seconds
        self.dossier_dir: Optional[str] = None
        self.dossier_max_bytes = 256 << 10
        self.dossier_keep = 8
        self.logger = get_logger("health")
        # name -> zero-arg callable returning a JSON-safe section.
        self.bundle_providers: Dict[str, Callable[[], Any]] = {}
        self._mu = threading.Lock()      # registry structure + states
        self._imu = threading.Lock()     # in-flight table (hot path)
        self._beats: Dict[str, Heartbeat] = {}
        self._inflight: Dict[int, InFlight] = {}
        self._critical: set = set()
        self._state: Dict[str, str] = {}
        self._stalled_since: Dict[str, float] = {}
        self._stall_info: Dict[str, dict] = {}
        self._trips = StatMap()          # "subsystem|kind" -> count
        self._dossier_written: set = set()   # trip-edge rate limit
        self._dossier_seq = 0
        self._peers: Dict[str, dict] = {}
        self._last_sweep = 0.0
        self._sweeps = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._refs = 0

    # -- registration --------------------------------------------------------

    def register(self, name: str, interval: Optional[float] = None,
                 critical: bool = False) -> Heartbeat:
        """Idempotent: re-registering a name returns the existing
        Heartbeat with its interval/criticality refreshed (a restarted
        component simply resumes its pulse)."""
        with self._mu:
            hb = self._beats.get(name)
            if hb is None:
                hb = self._beats[name] = Heartbeat(
                    name, interval, critical, self)
            else:
                hb.interval = interval
                hb.critical = critical
                hb.last_beat = time.monotonic()
                hb.parked = False
            if critical:
                self._critical.add(name)
            return hb

    def unregister(self, name: str) -> None:
        """Components with a close() MUST unregister interval-bearing
        heartbeats there, or the watchdog will read their silence as a
        hang after shutdown."""
        with self._mu:
            self._beats.pop(name, None)
            self._state.pop(name, None)
            self._stalled_since.pop(name, None)
            self._stall_info.pop(name, None)
            self._dossier_written.discard(name)

    def mark_critical(self, *names: str) -> None:
        """Subsystems whose STALL flips /readyz even when they only
        ever appear as in-flight ops (WAL, SPMD dispatch)."""
        with self._mu:
            self._critical.update(names)

    def inflight(self, subsystem: str, kind: str,
                 base: Optional[float] = None):
        """Bracket for a potentially-blocking op. `base` is the op's
        nominal budget in seconds; its watchdog deadline is
        `base × stall-after`. None = visibility only, never judged."""
        if not self.enabled:
            return _NOOP_INFLIGHT
        bound = None if base is None else float(base) * self.stall_after
        return InFlight(self, subsystem, kind, bound)

    def _track(self, rec: InFlight) -> None:
        with self._imu:
            self._inflight[id(rec)] = rec

    def _untrack(self, rec: InFlight) -> None:
        with self._imu:
            self._inflight.pop(id(rec), None)

    # -- the watchdog --------------------------------------------------------

    def start(self) -> None:
        """Refcounted: in-process clusters share the one watchdog."""
        with self._mu:
            self._refs += 1
            if self._thread is not None or not self.enabled:
                return
            self._stop = threading.Event()
            self._last_sweep = time.monotonic()
            self._thread = threading.Thread(
                target=self._watch_loop, name="health-watchdog",
                daemon=True)
            self._thread.start()

    def stop(self) -> None:
        with self._mu:
            self._refs = max(0, self._refs - 1)
            if self._refs > 0 or self._thread is None:
                return
            t = self._thread
            self._thread = None
            self._stop.set()
        t.join(timeout=5)

    def _watch_loop(self) -> None:
        while not self._stop.wait(self.sweep_interval):
            try:
                self.sweep()
            except Exception as e:  # noqa: BLE001 — the watchdog never dies
                self.logger.warning("watchdog sweep failed: %s", e)

    def sweep(self, now: Optional[float] = None) -> List[str]:
        """One detection pass; returns subsystems that tripped on this
        sweep (OK→STALLED edges only)."""
        if not self.enabled:
            return []
        now = time.monotonic() if now is None else now
        stalls: Dict[str, dict] = {}
        excused: set = set()
        with self._imu:
            recs = list(self._inflight.values())
        for rec in recs:
            age = now - rec.start
            if rec.bound is not None and age > rec.bound:
                prev = stalls.get(rec.subsystem)
                if prev is None or age > prev["age_s"]:
                    stalls[rec.subsystem] = {
                        "kind": "inflight", "op": rec.kind,
                        "age_s": round(age, 3),
                        "allowed_s": round(rec.bound, 3),
                        "thread_id": rec.thread_id,
                        "thread_name": rec.thread_name,
                    }
            else:
                # A tracked op still inside its own deadline excuses
                # its loop's heartbeat age: blocked-but-accounted is
                # working, not wedged.
                excused.add(rec.subsystem)
        with self._mu:
            beats = list(self._beats.values())
        for hb in beats:
            if hb.interval is None or hb.parked:
                continue
            allowed = float(hb.interval) * self.stall_after
            age = now - hb.last_beat
            if age > allowed and hb.name not in excused \
                    and hb.name not in stalls:
                stalls[hb.name] = {
                    "kind": "heartbeat",
                    "age_s": round(age, 3),
                    "allowed_s": round(allowed, 3),
                    "thread_id": hb.thread_id,
                    "thread_name": hb.thread_name,
                }
        tripped: List[tuple] = []
        recovered: List[str] = []
        with self._mu:
            names = set(self._state) | set(stalls)
            for name in names:
                new = STALLED if name in stalls else OK
                old = self._state.get(name, OK)
                self._state[name] = new
                if new == STALLED:
                    self._stall_info[name] = stalls[name]
                    if old != STALLED:
                        self._stalled_since[name] = now
                        self._trips.inc(f"{name}|{stalls[name]['kind']}")
                        tripped.append((name, stalls[name]))
                elif old == STALLED:
                    self._stalled_since.pop(name, None)
                    self._stall_info.pop(name, None)
                    # Recovery resets the dossier rate limit: the NEXT
                    # trip edge writes a fresh dossier.
                    self._dossier_written.discard(name)
                    recovered.append(name)
            self._last_sweep = now
            self._sweeps += 1
        for name, info in tripped:
            stack = thread_stack(info.get("thread_id"))
            self.logger.warning(
                "watchdog: subsystem=%s STALLED kind=%s age=%.2fs "
                "allowed=%.2fs thread=%s\n%s",
                name, info["kind"], info["age_s"], info["allowed_s"],
                info.get("thread_name") or "?",
                "".join(f"  {ln}\n" for ln in stack) or "  <no stack>\n")
            write = False
            with self._mu:
                if name not in self._dossier_written:
                    self._dossier_written.add(name)
                    write = True
            if write:
                try:
                    self.write_dossier(reason=f"stall-{name}",
                                       trip=dict(info, subsystem=name,
                                                 stack=stack))
                except Exception as e:  # noqa: BLE001 — diagnostics
                    # must never take down the watchdog
                    self.logger.warning(
                        "dossier write for %s failed: %s", name, e)
        for name in recovered:
            self.logger.info("watchdog: subsystem=%s recovered", name)
        return [name for name, _ in tripped]

    def watchdog_alive(self) -> bool:
        """The /healthz question: is the watchdog itself beating?
        True when health is disabled or not started (nothing claims
        otherwise); False only when a started watchdog stops sweeping."""
        with self._mu:
            if not self.enabled or self._thread is None:
                return True
            age = time.monotonic() - self._last_sweep
        return age <= max(5.0 * self.sweep_interval, 2.0)

    # -- rollups -------------------------------------------------------------

    def stalled(self) -> List[str]:
        with self._mu:
            return sorted(n for n, s in self._state.items()
                          if s == STALLED)

    def stalled_critical(self) -> List[str]:
        with self._mu:
            return sorted(n for n, s in self._state.items()
                          if s == STALLED and n in self._critical)

    def ready(self) -> bool:
        """No STALLED critical subsystem. (Serving-state and mesh
        capability are the server's half of /readyz.)"""
        return not self.stalled_critical()

    def state_of(self, name: str) -> str:
        with self._mu:
            return self._state.get(name, OK)

    def trips_total(self) -> int:
        return sum(self._trips.copy().values())

    def snapshot(self) -> dict:
        """The /debug/health document and the dossier's health table."""
        now = time.monotonic()
        with self._imu:
            recs = list(self._inflight.values())
        with self._mu:
            beats = list(self._beats.values())
            state = dict(self._state)
            since = dict(self._stalled_since)
            info = {k: dict(v) for k, v in self._stall_info.items()}
            critical = set(self._critical)
            peers = {h: dict(p) for h, p in self._peers.items()}
            sweeps = self._sweeps
            last = self._last_sweep
        trips = self._trips.copy()
        subsystems: Dict[str, dict] = {}
        for hb in beats:
            subsystems[hb.name] = {
                "state": state.get(hb.name, OK),
                "critical": hb.name in critical,
                "interval_s": hb.interval,
                "parked": hb.parked,
                "beats": hb.beats,
                "age_s": round(now - hb.last_beat, 3),
                "thread": hb.thread_name or None,
            }
        for name, st in state.items():
            sub = subsystems.setdefault(name, {
                "state": st, "critical": name in critical,
                "interval_s": None, "parked": False, "beats": 0,
                "age_s": None, "thread": None})
            sub["state"] = st
            if st == STALLED:
                sub["stalled_for_s"] = round(now - since.get(name, now), 3)
                sub["stall"] = info.get(name)
        by_sub: Dict[str, int] = {}
        for key, n in trips.items():
            sub_name = key.partition("|")[0]
            by_sub[sub_name] = by_sub.get(sub_name, 0) + n
        for name, n in by_sub.items():
            if name in subsystems:
                subsystems[name]["trips"] = n
        return {
            "enabled": self.enabled,
            "stall_after": self.stall_after,
            "sweep_interval_s": self.sweep_interval,
            "sweeps": sweeps,
            "watchdog_alive": self.watchdog_alive(),
            "last_sweep_age_s": (round(now - last, 3) if last else None),
            "subsystems": subsystems,
            "inflight": [{
                "subsystem": r.subsystem, "kind": r.kind,
                "age_s": round(now - r.start, 3),
                "deadline_s": r.bound, "thread": r.thread_name,
            } for r in recs],
            "stalled": sorted(n for n, s in state.items()
                              if s == STALLED),
            "stalled_critical": sorted(
                n for n, s in state.items()
                if s == STALLED and n in critical),
            "trips_total": sum(trips.values()),
            "peers": peers,
        }

    # -- dossiers ------------------------------------------------------------

    def build_bundle(self, reason: str = "on-demand",
                     trip: Optional[dict] = None) -> dict:
        """The diagnostic bundle: /debug/bundle, `ctl diagnose` and
        every watchdog trip all produce this same document."""
        doc = {
            "schema": DOSSIER_SCHEMA,
            "reason": reason,
            "written_at": time.time(),
            "trip": trip,
            "health": self.snapshot(),
            "threads": thread_stacks(),
            "sections": {},
        }
        for name in sorted(self.bundle_providers):
            try:
                doc["sections"][name] = self.bundle_providers[name]()
            except Exception as e:  # noqa: BLE001 — a broken provider
                # must not block the bundle that diagnoses it
                doc["sections"][name] = {"error": str(e)}
        return doc

    def encode_bundle(self, doc: dict) -> bytes:
        """Serialize under the size bound, shedding progressively:
        whole sections largest-first, then thread stacks (truncated
        to tails, then dropped), then everything but the trip
        summary. A dossier that cannot fit
        still says what stalled."""
        limit = int(self.dossier_max_bytes)

        def enc(d):
            return json.dumps(d, sort_keys=True, default=str,
                              separators=(",", ":")).encode()

        data = enc(doc)
        if len(data) <= limit:
            return data
        doc = dict(doc)
        doc["truncated"] = []
        sections = dict(doc.get("sections") or {})
        for name in sorted(sections,
                           key=lambda n: -len(enc(sections[n]))):
            sections[name] = "truncated"
            doc["truncated"].append(name)
            doc["sections"] = dict(sections)
            data = enc(doc)
            if len(data) <= limit:
                return data
        doc["threads"] = [dict(t, stack=t.get("stack", [])[-5:])
                          for t in doc.get("threads", [])]
        doc["truncated"].append("threads")
        data = enc(doc)
        if len(data) <= limit:
            return data
        # Even 5-frame stacks overflow in a thread-heavy process:
        # drop the thread list entirely (the trip carries the stuck
        # thread's own stack) before giving up on everything else.
        doc["threads"] = "truncated"
        data = enc(doc)
        if len(data) <= limit:
            return data
        return enc({"schema": doc.get("schema"),
                    "reason": doc.get("reason"),
                    "written_at": doc.get("written_at"),
                    "trip": doc.get("trip"),
                    "truncated": "all"})

    def write_dossier(self, reason: str = "on-demand",
                      trip: Optional[dict] = None,
                      doc: Optional[dict] = None) -> Optional[str]:
        """Build (unless given), bound, and atomically write one
        dossier; prune to `dossier_keep` newest. Returns the path, or
        None when no dossier dir is configured (bare registries in
        unit tests)."""
        if not self.dossier_dir:
            return None
        if doc is None:
            doc = self.build_bundle(reason=reason, trip=trip)
        data = self.encode_bundle(doc)
        os.makedirs(self.dossier_dir, exist_ok=True)
        with self._mu:
            self._dossier_seq += 1
            seq = self._dossier_seq
        slug = "".join(c if c.isalnum() or c in "._-" else "-"
                       for c in reason)[:48] or "dossier"
        name = (f"{DOSSIER_PREFIX}{int(time.time() * 1000):013d}"
                f"-{seq:04d}-{slug}.json")
        path = os.path.join(self.dossier_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.write(b"\n")
        os.replace(tmp, path)
        self._prune_dossiers()
        return path

    def list_dossiers(self) -> List[str]:
        """Dossier paths, oldest first (filenames sort by write time)."""
        if not self.dossier_dir or not os.path.isdir(self.dossier_dir):
            return []
        names = sorted(n for n in os.listdir(self.dossier_dir)
                       if n.startswith(DOSSIER_PREFIX)
                       and n.endswith(".json"))
        return [os.path.join(self.dossier_dir, n) for n in names]

    def _prune_dossiers(self) -> None:
        paths = self.list_dossiers()
        keep = max(1, int(self.dossier_keep))
        for path in paths[:max(0, len(paths) - keep)]:
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- test support --------------------------------------------------------

    def reset(self) -> None:
        """Drop every registration, state, and peer (tests only — a
        process-global registry must not leak one test's stalls into
        the next)."""
        with self._mu:
            self._beats.clear()
            self._critical.clear()
            self._state.clear()
            self._stalled_since.clear()
            self._stall_info.clear()
            self._dossier_written.clear()
            self._peers.clear()
            self._trips = StatMap()
            self._sweeps = 0
            self._last_sweep = 0.0
        with self._imu:
            self._inflight.clear()


HEALTH = HealthRegistry()


def families() -> list:
    """Prometheus families for the /metrics collector: bounded
    cardinality by construction — one series per registered subsystem
    (a dozen loops), never per query/tenant/shape."""
    from .prom import MetricFamily

    snap_state: Dict[str, str]
    with HEALTH._mu:
        snap_state = dict(HEALTH._state)
        for name in HEALTH._beats:
            snap_state.setdefault(name, OK)
    st = MetricFamily(
        "pilosa_health_state", "gauge",
        "Per-subsystem liveness as judged by the watchdog "
        "(0=ok, 1=stalled).")
    for name in sorted(snap_state):
        st.add(1.0 if snap_state[name] == STALLED else 0.0,
               {"subsystem": name})
    rd = MetricFamily(
        "pilosa_health_ready", "gauge",
        "Readiness rollup: 1 when no critical subsystem is stalled.")
    rd.add(1.0 if HEALTH.ready() else 0.0)
    tr = MetricFamily(
        "pilosa_watchdog_trips_total", "counter",
        "Watchdog stall detections by subsystem and detector kind.")
    for key, n in sorted(HEALTH._trips.copy().items()):
        sub, _, kind = key.partition("|")
        tr.add(n, {"subsystem": sub, "kind": kind})
    sw = MetricFamily(
        "pilosa_watchdog_sweeps_total", "counter",
        "Watchdog sweep passes completed.")
    sw.add(float(HEALTH._sweeps))
    return [st, rd, tr, sw]

