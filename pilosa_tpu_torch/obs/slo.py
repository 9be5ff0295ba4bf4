"""SLO observatory: rolling SLIs, error budgets, multi-window burn
rates (the JAX package's obs/slo.py, with its names).

The instrumentation layers (trace/metrics/profile/prom) record what
happened; this module turns those signals into *judgments*: is the
service meeting its declared objectives, how much error budget is
left, and how fast is it burning?

One `SLORecorder` per handler. Every coordinator-side query outcome is
recorded exactly once (`Handler._post_query` is the single source of
truth — sheds, deadline expiries, backpressure, partial responses, and
successes all land in the same `pilosa_query_outcome_total{outcome,
tenant}` family), and the same event feeds three sliding windows —
5m / 1h / 6h — each a fixed ring of bucketed snapshots, so memory is
bounded no matter how long the process serves.

SLIs (Google SRE shapes, computed per window):

- **availability** — fraction of requests answering non-5xx and
  non-shed. Partial (degraded-but-answered) responses count as good;
  4xx client errors count as good (the service did its job).
- **latency** — fraction of *served* requests finishing under the
  declared `p99-us` threshold. The threshold comparison happens at
  record time against the exact value, so the SLI is exact even
  though the retained histograms are log2-bucketed.
- **shed rate** — fraction of requests shed at admission (HTTP 429),
  bounded by `shed-rate-max`.
- **correctness** — growth of `pilosa_shadow_mismatch_total` inside
  the window. The budget is zero: any growth is a violation.

Error budget accounting uses the LONGEST window as the budget period:
with availability target T, the budget fraction is (1 - T), the burn
rate over window w is bad_fraction(w) / (1 - T) (burn 1.0 = consuming
budget exactly as fast as the objective allows), and budget remaining
is 1 - burn(longest window), clamped to [0, 1]. Multi-window burn
rates are exported as `pilosa_slo_burn_rate{objective,window}` so
alerting can pair a fast window (page on 5m burn >> 1) with a slow one
(ticket on 6h burn > 1), and `/debug/slo` + `ctl top` render
the same numbers.

Tenant cardinality is bounded by construction: tenants named in
`[sched] tenant-weights` (plus "default") keep their own label; every
other value maps to "other". The clock is injectable so the window
tests replay deterministically.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# (name, span seconds, bucket seconds) — 15 buckets per ring. A ring
# covers [span - bucket, span] of history depending on phase; the
# bucket widths are coarse enough that three rings cost a few dicts
# per bucket, fine-grained enough that a 5m alert window reacts in
# tens of seconds.
WINDOWS: Tuple[Tuple[str, float, float], ...] = (
    ("5m", 300.0, 20.0),
    ("1h", 3600.0, 240.0),
    ("6h", 21600.0, 1440.0),
)

# The closed outcome vocabulary. Availability counts GOOD_OUTCOMES /
# everything; "shed" (429) and the 5xx family ("deadline" 504,
# "backpressure" 503, "error" other 5xx) are the bad half.
OUTCOMES = ("ok", "partial", "client_error", "shed", "deadline",
            "backpressure", "error")
GOOD_OUTCOMES = frozenset(("ok", "partial", "client_error"))

DEFAULT_OBJECTIVES = {
    "availability": 99.9,     # percent of non-5xx & non-shed responses
    "p99_us": 50_000.0,       # latency threshold (microseconds)
    "latency_target": 99.0,   # percent of served requests under p99-us
    "shed_rate_max": 0.05,    # max tolerated shed fraction
}

OBJECTIVE_NAMES = ("availability", "latency", "shed_rate", "correctness")

_NBUCKETS = 64  # log2 latency buckets, matching obs.metrics.Histogram


def outcome_for_status(status: int, partial: bool = False) -> str:
    """HTTP status (+ the partial flag on a 200) -> outcome label."""
    if status == 429:
        return "shed"
    if status == 504:
        return "deadline"
    if status == 503:
        return "backpressure"
    if status >= 500:
        return "error"
    if status >= 400:
        return "client_error"
    return "partial" if partial else "ok"


def log2_percentile(counts: Iterable[int], q: float) -> float:
    """Upper-bound percentile from raw log2 bucket counts: the
    smallest 2^b whose cumulative count covers the quantile (the same
    convention `ctl top` applies to the exported buckets)."""
    counts = list(counts)
    total = sum(counts)
    if total <= 0:
        return 0.0
    thresh = q * total
    cum = 0
    for b, n in enumerate(counts):
        cum += n
        if cum >= thresh and n:
            return float(1 << b) if b else 1.0
    return float(1 << (len(counts) - 1))


class _Bucket:
    """One time slot of one ring. All maps are keyed by the BOUNDED
    tenant label; latency state covers served (non-error) requests."""

    __slots__ = ("counts", "lat", "served", "under", "mm_first",
                 "mm_last")

    def __init__(self):
        # (route, tenant, outcome) -> n
        self.counts: Dict[Tuple[str, str, str], int] = {}
        # (route, tenant) -> log2 latency counts / served / under-threshold
        self.lat: Dict[Tuple[str, str], List[int]] = {}
        self.served: Dict[Tuple[str, str], int] = {}
        self.under: Dict[Tuple[str, str], int] = {}
        # Shadow-mismatch counter watermark: first/last total observed
        # while this bucket was current (None until observed).
        self.mm_first: Optional[float] = None
        self.mm_last: Optional[float] = None


class _Ring:
    """Fixed-span ring of `_Bucket`s. Rotation and eviction happen on
    access — no timer thread; an idle recorder costs nothing."""

    __slots__ = ("span", "width", "slots", "buckets")

    def __init__(self, span_s: float, bucket_s: float):
        self.span = float(span_s)
        self.width = float(bucket_s)
        self.slots = max(1, int(round(span_s / bucket_s)))
        self.buckets: deque = deque()  # (slot index, _Bucket), ascending

    def current(self, now: float) -> _Bucket:
        idx = int(now // self.width)
        if not self.buckets or self.buckets[-1][0] < idx:
            self.buckets.append((idx, _Bucket()))
            floor = idx - self.slots + 1
            while self.buckets and self.buckets[0][0] < floor:
                self.buckets.popleft()
        return self.buckets[-1][1]

    def live(self, now: float) -> List[_Bucket]:
        """Buckets still inside the window at `now`, oldest first."""
        floor = int(now // self.width) - self.slots + 1
        return [b for i, b in self.buckets if i >= floor]


def _aggregate(buckets: List[_Bucket]) -> dict:
    """Merge a window's buckets into one flat tally."""
    counts: Dict[Tuple[str, str, str], int] = {}
    lat: Dict[Tuple[str, str], List[int]] = {}
    served: Dict[Tuple[str, str], int] = {}
    under: Dict[Tuple[str, str], int] = {}
    mm_first = mm_last = None
    for b in buckets:
        for k, n in b.counts.items():
            counts[k] = counts.get(k, 0) + n
        for t, row in b.lat.items():
            dst = lat.get(t)
            if dst is None:
                lat[t] = list(row)
            else:
                for i, n in enumerate(row):
                    dst[i] += n
        for t, n in b.served.items():
            served[t] = served.get(t, 0) + n
        for t, n in b.under.items():
            under[t] = under.get(t, 0) + n
        if b.mm_first is not None and mm_first is None:
            mm_first = b.mm_first
        if b.mm_last is not None:
            mm_last = b.mm_last
    total = sum(counts.values())
    good = sum(n for (_, _, o), n in counts.items()
               if o in GOOD_OUTCOMES)
    shed = sum(n for (_, _, o), n in counts.items() if o == "shed")
    # Counters only move forward; a negative diff means the source
    # restarted, which is not a correctness violation.
    growth = max(0.0, (mm_last or 0.0) - (mm_first or 0.0)) \
        if mm_last is not None else 0.0
    return {"counts": counts, "lat": lat, "served": served,
            "under": under, "total": total, "good": good, "shed": shed,
            "mismatch_growth": growth}


def evaluate(agg: dict, objectives: dict) -> Dict[str, dict]:
    """Pure SLI + burn-rate math over one aggregated window — the
    piece a test can compute by hand.

    Returns {objective: {sli, burn_rate, ...}} where burn_rate 1.0
    means "consuming error budget exactly as fast as the objective
    tolerates"; an empty window reads as healthy (sli 1.0, burn 0).
    """
    total = agg["total"]
    out: Dict[str, dict] = {}

    target = float(objectives["availability"]) / 100.0
    budget = 1.0 - target
    bad = (total - agg["good"]) / total if total else 0.0
    sli = agg["good"] / total if total else 1.0
    if budget > 0:
        burn = bad / budget
    else:
        burn = 0.0 if bad == 0 else float("inf")
    out["availability"] = {"sli": sli, "burn_rate": burn,
                           "bad_fraction": bad}

    served = sum(agg["served"].values())
    under = sum(agg["under"].values())
    lt = float(objectives["latency_target"]) / 100.0
    lbudget = 1.0 - lt
    lbad = (served - under) / served if served else 0.0
    lsli = under / served if served else 1.0
    if lbudget > 0:
        lburn = lbad / lbudget
    else:
        lburn = 0.0 if lbad == 0 else float("inf")
    merged = [0] * _NBUCKETS
    for row in agg["lat"].values():
        for i, n in enumerate(row):
            merged[i] += n
    out["latency"] = {"sli": lsli, "burn_rate": lburn,
                      "bad_fraction": lbad,
                      "p99_us": log2_percentile(merged, 0.99)}

    srm = float(objectives["shed_rate_max"])
    shed_frac = agg["shed"] / total if total else 0.0
    if srm > 0:
        sburn = shed_frac / srm
    else:
        sburn = 0.0 if shed_frac == 0 else float("inf")
    out["shed_rate"] = {"sli": 1.0 - shed_frac, "burn_rate": sburn,
                        "shed_fraction": shed_frac}

    growth = agg["mismatch_growth"]
    out["correctness"] = {"sli": 1.0 if growth == 0 else 0.0,
                          "burn_rate": float(growth),
                          "mismatch_growth": growth}
    return out


def shadow_mismatch_total() -> float:
    """Process-wide shadow-verification mismatch count (the default
    correctness source): the executor's SHADOW_STATS `mismatch:*`.
    Lazy import: obs must not import the executor (torch) at load."""
    try:
        from ..executor import SHADOW_STATS
    except Exception:  # noqa: BLE001 — docs builds / partial installs
        return 0.0
    return float(sum(v for k, v in SHADOW_STATS.copy().items()
                     if k.startswith("mismatch:")))


class SLORecorder:
    """Per-node SLI recorder + objective evaluator. Thread-safe; the
    record path is one lock hold and a handful of dict increments
    (the reference guards < 1% of the lone-query fast path)."""

    def __init__(self, objectives: Optional[dict] = None,
                 tenants: Optional[Iterable[str]] = None,
                 now: Callable[[], float] = time.monotonic,
                 mismatch_source: Callable[[], float]
                 = shadow_mismatch_total,
                 windows: Tuple[Tuple[str, float, float], ...] = WINDOWS):
        self.objectives = dict(DEFAULT_OBJECTIVES)
        for k, v in (objectives or {}).items():
            if v is not None:
                self.objectives[k] = float(v)
        self._allowed = frozenset(tenants or ()) | {"default"}
        self._now = now
        self._mismatch_source = mismatch_source
        self._mu = threading.Lock()
        self._rings: List[Tuple[str, _Ring]] = [
            (name, _Ring(span, width)) for name, span, width in windows]
        # Cumulative outcome counters — the
        # pilosa_query_outcome_total{outcome,tenant} family.
        self.outcome_totals: Dict[Tuple[str, str], int] = {}
        self._lat_threshold = float(self.objectives["p99_us"])
        # Latest latency exemplar per (route, tenant) — (trace_id,
        # latency_us, wall ts). Surfaced as the `exemplar` field on
        # /debug/slo latency SLIs, so a p99 burn links straight to a
        # resolvable /debug/traces/<id>.
        self._lat_exemplars: Dict[Tuple[str, str],
                                  Tuple[str, float, float]] = {}

    # -- hot path --------------------------------------------------------

    def tenant_label(self, tenant: str) -> str:
        """Bound tenant cardinality: weights-file tenants + "default"
        keep their name, everything else is "other"."""
        return tenant if tenant in self._allowed else "other"

    def record(self, outcome: str, tenant: str = "default",
               latency_us: Optional[float] = None,
               route: str = "query",
               trace_id: Optional[str] = None) -> None:
        """One request outcome. `latency_us` only for served requests
        (sheds and errors have no meaningful service latency);
        `trace_id` rides along as the latency exemplar."""
        t = self.tenant_label(tenant)
        key = (route, t, outcome)
        lkey = (route, t)
        now = self._now()
        if latency_us is not None:
            lb = min(int(latency_us).bit_length(), _NBUCKETS - 1)
            under = latency_us <= self._lat_threshold
        with self._mu:
            self.outcome_totals[key] = self.outcome_totals.get(key, 0) + 1
            if latency_us is not None and trace_id is not None:
                self._lat_exemplars[lkey] = (trace_id, float(latency_us),
                                             time.time())
            for _, ring in self._rings:
                b = ring.current(now)
                b.counts[key] = b.counts.get(key, 0) + 1
                if latency_us is not None:
                    row = b.lat.get(lkey)
                    if row is None:
                        row = b.lat[lkey] = [0] * _NBUCKETS
                    row[lb] += 1
                    b.served[lkey] = b.served.get(lkey, 0) + 1
                    if under:
                        b.under[lkey] = b.under.get(lkey, 0) + 1

    def observe_mismatches(self, total: float) -> None:
        """Feed the monotonic shadow-mismatch counter. Called at read
        time (scrape / /debug/slo), not per query — correctness is
        judged by counter growth between observations."""
        now = self._now()
        with self._mu:
            for _, ring in self._rings:
                b = ring.current(now)
                if b.mm_first is None:
                    b.mm_first = total
                b.mm_last = total

    # -- read path -------------------------------------------------------

    def window_stats(self, name: str) -> dict:
        """Aggregated tallies for one named window (tests + debug)."""
        now = self._now()
        with self._mu:
            for n, ring in self._rings:
                if n == name:
                    return _aggregate(ring.live(now))
        raise KeyError(name)

    def status(self) -> dict:
        """The full judgment — served verbatim at /debug/slo, and the
        single source every exporter renders from so /metrics and the
        JSON snapshot can never disagree."""
        try:
            self.observe_mismatches(float(self._mismatch_source()))
        except Exception:  # noqa: BLE001 — the source is advisory
            pass
        now = self._now()
        with self._mu:
            aggs = [(n, _aggregate(r.live(now))) for n, r in self._rings]
            totals = dict(self.outcome_totals)
            exemplars = dict(self._lat_exemplars)
        windows = {}
        for name, agg in aggs:
            ev = evaluate(agg, self.objectives)
            tenants: Dict[str, dict] = {}
            for (_, t, o), n in sorted(agg["counts"].items()):
                row = tenants.setdefault(t, {"requests": 0})
                row[o] = row.get(o, 0) + n
                row["requests"] += n
            for t, row in tenants.items():
                merged = [0] * _NBUCKETS
                seen = False
                for (_, lt), lrow in agg["lat"].items():
                    if lt == t:
                        seen = True
                        for i, n in enumerate(lrow):
                            merged[i] += n
                if seen:
                    row["p50_us"] = log2_percentile(merged, 0.50)
                    row["p99_us"] = log2_percentile(merged, 0.99)
                    best = None
                    for (_, lt), ex in exemplars.items():
                        if lt == t and (best is None or ex[2] > best[2]):
                            best = ex
                    if best is not None:
                        row["exemplar"] = {"trace_id": best[0],
                                           "latency_us": best[1]}
            windows[name] = {"requests": agg["total"],
                             "shed": agg["shed"],
                             "mismatch_growth": agg["mismatch_growth"],
                             "objectives": ev,
                             "tenants": tenants}
        budget_window = self._rings[-1][0]
        objectives = {}
        for obj in OBJECTIVE_NAMES:
            burns = {name: windows[name]["objectives"][obj]["burn_rate"]
                     for name, _ in aggs}
            fastest = max(burns.values()) if burns else 0.0
            fastest_window = max(burns, key=burns.get) if burns else ""
            if obj == "correctness":
                growth = windows[budget_window]["mismatch_growth"]
                remaining = 1.0 if growth == 0 else 0.0
                violated = growth > 0
            else:
                consumed = burns[budget_window]
                remaining = min(1.0, max(0.0, 1.0 - consumed))
                # 1e-9 absorbs float noise at the exactly-exhausted
                # boundary (burn 1.0 must read as violated).
                violated = remaining <= 1e-9
            objectives[obj] = {
                "budget_remaining": remaining,
                "burn_rates": burns,
                "fastest_burn": fastest,
                "fastest_burn_window": fastest_window,
                "verdict": "VIOLATED" if violated else "OK",
            }
        targets = {"availability": self.objectives["availability"],
                   "latency": self.objectives["latency_target"],
                   "shed_rate": self.objectives["shed_rate_max"],
                   "correctness": 0.0}
        for obj, row in objectives.items():
            row["target"] = targets[obj]
        return {
            "objectives": objectives,
            "windows": windows,
            "budget_window": budget_window,
            "config": {"p99_us": self.objectives["p99_us"],
                       **{k: v for k, v in self.objectives.items()
                          if k != "p99_us"}},
            "outcome_totals": {f"{r}:{o}:{t}": n
                               for (r, t, o), n in sorted(totals.items())},
            "verdict": ("VIOLATED"
                        if any(r["verdict"] == "VIOLATED"
                               for r in objectives.values()) else "OK"),
        }

    def families(self) -> list:
        """MetricFamily bridge for the /metrics collector — rendered
        from the same status() the debug endpoint serves."""
        from .prom import MetricFamily

        st = self.status()
        with self._mu:
            totals = sorted(self.outcome_totals.items())
        outcome = MetricFamily(
            "pilosa_query_outcome_total", "counter",
            "Coordinator query outcomes — ok, partial, client_error, "
            "shed (429), deadline (504), backpressure (503), error "
            "(other 5xx) — the single source for availability SLIs.")
        for (r, t, o), n in totals:
            outcome.add(n, {"outcome": o, "tenant": t, "route": r})
        budget = MetricFamily(
            "pilosa_slo_budget_remaining", "gauge",
            "Error budget left per objective over the "
            f"{st['budget_window']} accounting window (1 = untouched, "
            "0 = exhausted).")
        burn = MetricFamily(
            "pilosa_slo_burn_rate", "gauge",
            "Error-budget burn rate per objective and window (1.0 = "
            "burning exactly at the tolerated pace).")
        sli = MetricFamily(
            "pilosa_slo_sli", "gauge",
            "Measured SLI per objective and window (fraction good).")
        violated = MetricFamily(
            "pilosa_slo_violated", "gauge",
            "1 when the objective's budget is exhausted (or any shadow "
            "mismatch occurred, for correctness), else 0.")
        for obj, row in st["objectives"].items():
            budget.add(row["budget_remaining"], {"objective": obj})
            violated.add(1 if row["verdict"] == "VIOLATED" else 0,
                         {"objective": obj})
            for window, rate in row["burn_rates"].items():
                burn.add(rate, {"objective": obj, "window": window})
        for window, wrow in st["windows"].items():
            for obj, ev in wrow["objectives"].items():
                sli.add(ev["sli"], {"objective": obj, "window": window})
        return [outcome, budget, burn, sli, violated]
