"""Federated fleet view (the JAX package's obs/fleet.py): scrape
/metrics and /debug/vars from every ring member, merge the cumulative
families exactly, and serve one pane for the whole fleet.

The merge is exact, not approximate: counters sum, and cumulative-le
histogram buckets sum per le. Every node exports the same log2 bucket
boundaries (obs.prom), so per-le addition of cumulative counts is itself
a valid cumulative histogram. Gauges are per node (uptime, residency
ratios) and are never summed; they show in the per-node rows instead.
Nodes are merged in sorted host order, so one set of scrapes always
gives the same float sums, to the last bit.

Scraping is defensive: bounded concurrency, a per-node deadline,
breaker-aware skips (an open breaker means the transport already knows
the node is sick: no second timeout), and stale tolerance (a node that
fails a scrape keeps its last good samples, aged by `scrape_age_s`, so
one sick node never blanks the pane).

This module is also the port's one Prometheus text parser: `ctl top`
reads its scrapes through parse_text and hist_percentiles, so the
operator's tools and the merge never disagree about what a scrape
means.

The handler builds one aggregator over its cluster's members
(`Cluster.node_states`), fetching its own scrapes through itself and
the peers' through the internal client; a handler without a cluster
answers GET /debug/fleet with 404.
"""

from __future__ import annotations

import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Optional, Tuple

# Sample-name suffixes whose values are cumulative and therefore sum
# exactly — both across nodes (the fleet merge) and across duplicate
# lines inside one scrape (a merged exposition, or the same family
# emitted by two collectors).
CUMULATIVE_SUFFIXES = ("_total", "_bucket", "_count", "_sum")

_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_SAMPLE_RE = re.compile(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)"
                        r"(?:\s+#.*)?$")


def is_cumulative(name: str) -> bool:
    return name.endswith(CUMULATIVE_SUFFIXES)


def parse_text(text: str) -> Dict[Tuple[str, tuple], float]:
    """Prometheus 0.0.4 text -> {(name, ((label, value), ...)): float}.

    Labels come back sorted so lookups are order-independent. Comment,
    exemplar-suffixed, and malformed lines are tolerated (an operator
    tool must survive a partially-garbled scrape). Duplicate samples
    of a cumulative family — duplicate `le` buckets across a merged
    label product, the same counter emitted twice — SUM instead of
    last-one-wins: dropping a duplicate silently undercounts, and for
    gauges (where duplicates are a real re-statement) the last value
    still wins.
    """
    out: Dict[Tuple[str, tuple], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, rawlabels, value = m.groups()
        try:
            v = float(value)
        except ValueError:
            continue
        labels = tuple(sorted(
            (k, lv.replace('\\"', '"').replace("\\\\", "\\")
                  .replace("\\n", "\n"))
            for k, lv in _LABEL_RE.findall(rawlabels or "")))
        key = (name, labels)
        if key in out and is_cumulative(name):
            out[key] += v
        else:
            out[key] = v
    return out


def hist_percentiles(metrics: dict, name: str, fixed: dict):
    """(p50, p95, p99, count) from `name`_bucket cumulative-le samples
    whose labels include `fixed`. Percentile = the smallest le whose
    cumulative count covers the quantile (exact for the log2 exporter,
    an upper bound in general). Series the fixed labels don't pin down
    (tenants, tiers, backends) sum per-le — cumulative counts stay
    cumulative under per-le addition."""
    by_le: dict = {}
    for (mname, labels), v in metrics.items():
        if mname != name + "_bucket":
            continue
        d = dict(labels)
        if any(d.get(k) != str(val) for k, val in fixed.items()):
            continue
        le = d.get("le", "")
        le = float("inf") if le == "+Inf" else float(le)
        by_le[le] = by_le.get(le, 0.0) + v
    if not by_le:
        return None
    buckets = sorted(by_le.items())
    total = buckets[-1][1]
    if total <= 0:
        return (0.0, 0.0, 0.0, 0)
    out = []
    for q in (0.50, 0.95, 0.99):
        thresh = q * total
        out.append(next((le for le, cum in buckets if cum >= thresh),
                        buckets[-1][0]))
    return (*out, int(total))


def sample_key(name: str, labels: tuple) -> str:
    """Flatten one parsed sample identity back to exposition form —
    `name{k="v",...}` — the JSON-safe key /debug/fleet serves."""
    if not labels:
        return name
    body = ",".join(f'{k}="{v}"' for k, v in labels)
    return name + "{" + body + "}"


def merge(node_samples: Iterable[Dict[Tuple[str, tuple], float]],
          ) -> Dict[Tuple[str, tuple], float]:
    """Sum every cumulative sample across nodes. Non-cumulative
    families (gauges) are dropped — a summed uptime or residency ratio
    is a lie, and the per-node rows carry those instead."""
    out: Dict[Tuple[str, tuple], float] = {}
    for samples in node_samples:
        for key, v in samples.items():
            if not is_cumulative(key[0]):
                continue
            out[key] = out.get(key, 0.0) + v
    return out


def _sum_series(samples: dict, name: str, by_label: Optional[str] = None):
    """Sum all series of `name`; with `by_label`, group the sums by
    that label's value."""
    if by_label is None:
        return sum(v for (n, _), v in samples.items() if n == name)
    out: Dict[str, float] = {}
    for (n, labels), v in samples.items():
        if n != name:
            continue
        lv = dict(labels).get(by_label, "")
        out[lv] = out.get(lv, 0.0) + v
    return out


def node_row(samples: dict, vars_snap: Optional[dict] = None) -> dict:
    """Condense one node's scrape into the fleet-pane row: tier mix,
    route mix, hint backlog, HBM residency, request totals."""
    row: dict = {}
    row["tiers"] = {k: int(v) for k, v in sorted(_sum_series(
        samples, "pilosa_query_route_total", "tier").items()) if k}
    row["routes"] = {k: int(v) for k, v in sorted(_sum_series(
        samples, "pilosa_query_route_total", "backend").items()) if k}
    queued = _sum_series(samples, "pilosa_hints_queued_total")
    replayed = _sum_series(samples, "pilosa_hints_replayed_total")
    row["hints"] = {
        "queued": int(queued),
        "replayed": int(replayed),
        "dropped": int(_sum_series(samples,
                                   "pilosa_hints_dropped_total")),
        "backlog": max(0, int(queued - replayed)),
    }
    ratio = samples.get(("pilosa_hbm_residency_ratio", ()))
    row["hbm"] = {
        "resident_bytes": int(_sum_series(samples,
                                          "pilosa_hbm_resident_bytes")),
        "budget_bytes": int(samples.get(("pilosa_hbm_budget_bytes", ()),
                                        0)),
        "residency_ratio": ratio if ratio is not None else 1.0,
    }
    # Liveness verdict: pilosa_health_state{subsystem} is 1 while that
    # subsystem is STALLED; list the wedged ones so the fleet pane names
    # the stuck loop, not just a red node.
    stalled = sorted(
        dict(labels).get("subsystem", "")
        for (n, labels), v in samples.items()
        if n == "pilosa_health_state" and v >= 1.0)
    row["health"] = {
        "ready": bool(samples.get(("pilosa_health_ready", ()), 1.0)),
        "stalled": [s for s in stalled if s],
        "watchdog_trips": int(_sum_series(
            samples, "pilosa_watchdog_trips_total")),
    }
    row["requests_total"] = int(_sum_series(
        samples, "pilosa_query_outcome_total"))
    row["uptime_seconds"] = samples.get(("pilosa_uptime_seconds", ()),
                                        0.0)
    # Scheduler queue depth is a per-tenant gauge; tenant="all" is the
    # node total. Prefer the scrape (always present when [sched] is
    # on); /debug/vars is the fallback garnish.
    qd = samples.get(("pilosa_sched_queue_depth", (("tenant", "all"),)))
    if qd is not None:
        row["queue_depth"] = int(qd)
    if vars_snap:
        sched = vars_snap.get("sched")
        if isinstance(sched, dict) and "queued" in sched:
            row["sched_queued"] = sched.get("queued")
            row.setdefault("queue_depth", int(sched.get("queued", 0)))
    # Gauge blind spot: merge() drops non-cumulative families by design
    # (a summed gauge lies), which historically made every gauge this
    # row didn't hand-pick invisible fleet-wide. Surface them all, per
    # node, keyed in exposition form — the fleet pane's only window
    # into instantaneous state (HBM residency, queue depth, regression
    # flags).
    row["gauges"] = {
        sample_key(n, labels): v
        for (n, labels), v in sorted(samples.items())
        if not is_cumulative(n)}
    return row


class _NodeCache:
    __slots__ = ("samples", "vars", "fetched_at", "error")

    def __init__(self):
        self.samples: Optional[dict] = None
        self.vars: Optional[dict] = None
        self.fetched_at = 0.0
        self.error: Optional[str] = None


class FleetAggregator:
    """Coordinator-side fleet scraper + merger behind GET /debug/fleet.

    `members()` returns {host: membership state} (Cluster.node_states);
    `fetch(host, path, timeout_s)` returns the response body as text
    and raises on failure — the handler wires an implementation that
    short-circuits the local host (no self-scrape over HTTP) and uses
    the internal client transport for peers. `breaker_state(host)`
    (optional) lets an open circuit skip the fetch entirely.

    Snapshots are cached for `interval` seconds ([obs]
    fleet-scrape-interval) so a dashboard polling /debug/fleet doesn't
    multiply into N scrapes per poll across the ring.
    """

    def __init__(self, members: Callable[[], Dict[str, str]],
                 fetch: Callable[[str, str, float], str],
                 interval: float = 5.0, deadline: float = 2.0,
                 max_concurrency: int = 8,
                 breaker_state: Optional[Callable[[str], str]] = None,
                 now: Callable[[], float] = time.monotonic):
        self.members = members
        self.fetch = fetch
        self.interval = float(interval)
        self.deadline = float(deadline)
        self.max_concurrency = max(1, int(max_concurrency))
        self.breaker_state = breaker_state
        self._now = now
        self._mu = threading.Lock()
        self._cache: Dict[str, _NodeCache] = {}
        self._last_scrape = 0.0
        self._last_snapshot: Optional[dict] = None

    # -- scraping --------------------------------------------------------

    def _scrape_one(self, host: str) -> None:
        entry = self._cache.setdefault(host, _NodeCache())
        if self.breaker_state is not None:
            state = self.breaker_state(host)
            if state == "open":
                entry.error = "breaker open"
                return
        try:
            metrics_text = self.fetch(host, "/metrics", self.deadline)
            samples = parse_text(metrics_text)
            vars_snap: Optional[dict] = None
            try:
                import json as _json
                vars_snap = _json.loads(
                    self.fetch(host, "/debug/vars", self.deadline))
            except Exception:  # noqa: BLE001 — vars are garnish
                vars_snap = None
        except Exception as e:  # noqa: BLE001 — stale-tolerant by design
            entry.error = f"{type(e).__name__}: {e}"
            return
        entry.samples = samples
        entry.vars = vars_snap
        entry.fetched_at = self._now()
        entry.error = None

    def scrape(self) -> None:
        """One fleet-wide scrape round: every member fetched under
        bounded concurrency; failures leave the node's previous sample
        set in place (aged, error-annotated)."""
        hosts = sorted(self.members())
        if not hosts:
            return
        with self._mu:
            # Forget nodes that left the ring.
            for h in [h for h in self._cache if h not in hosts]:
                del self._cache[h]
        workers = min(self.max_concurrency, len(hosts))
        if workers <= 1:
            for h in hosts:
                self._scrape_one(h)
        else:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(self._scrape_one, hosts))
        with self._mu:
            self._last_scrape = self._now()
            self._last_snapshot = None  # rebuild on next read

    # -- reading ---------------------------------------------------------

    def snapshot(self, force: bool = False) -> dict:
        """The /debug/fleet document. Rescrapes when the cached round
        is older than `interval` (or `force`)."""
        with self._mu:
            fresh = (self._last_snapshot is not None and not force
                     and self._now() - self._last_scrape < self.interval)
            if fresh:
                return self._last_snapshot
        self.scrape()
        snap = self._build()
        with self._mu:
            self._last_snapshot = snap
        return snap

    def _build(self) -> dict:
        now = self._now()
        states = self.members()
        with self._mu:
            cache = {h: (e.samples, e.vars, e.fetched_at, e.error)
                     for h, e in self._cache.items()}
        nodes: Dict[str, dict] = {}
        merged_input = []
        healthy = 0
        for host in sorted(states):
            samples, vars_snap, fetched_at, error = cache.get(
                host, (None, None, 0.0, "never scraped"))
            row: dict = {"state": states[host]}
            if samples is None:
                row["error"] = error or "never scraped"
                row["scrape_age_s"] = None
            else:
                row.update(node_row(samples, vars_snap))
                row["scrape_age_s"] = round(now - fetched_at, 3)
                row["error"] = error
                merged_input.append(samples)
                if error is None:
                    healthy += 1
            nodes[host] = row
        merged = merge(merged_input)
        phases = sorted({dict(labels).get("phase", "")
                         for (name, labels) in merged
                         if name == "pilosa_query_phase_us_bucket"}
                        - {""})
        phase_pct = {}
        for ph in phases:
            pct = hist_percentiles(merged, "pilosa_query_phase_us",
                                   {"phase": ph})
            if pct is not None:
                p50, p95, p99, n = pct
                phase_pct[ph] = {"p50_us": p50, "p95_us": p95,
                                 "p99_us": p99, "count": n}
        return {
            "generated_at": time.time(),
            "scrape_interval_s": self.interval,
            "members": len(states),
            "scraped": len(merged_input),
            "healthy": healthy,
            "nodes": nodes,
            "merged": {sample_key(n, labels): v
                       for (n, labels), v in sorted(merged.items())},
            "phase_percentiles": phase_pct,
            "requests_total": int(_sum_series(
                merged, "pilosa_query_outcome_total")),
        }
