"""Cost observatory: per-(tenant x query-shape) resource attribution
and self-baselining perf regression detection (the JAX package's
obs/costs.py, with its names and dimensions).

Two module-level singletons, so every layer (the executor's route tap,
the WAL committer, the card-memory governor) can attribute cost
without plumbing tenants through call signatures:

``LEDGER``
    a `CostLedger` metering every query and import into a bounded
    (tenant, shape) account: device microseconds (from the measured
    profile's device_exec + host_fold, extrapolated by the profile
    sample rate on the sampled path), HBM byte-seconds (a staged view's
    bytes x dt, amortized over the accounts that touched it), staged
    bytes, WAL bytes, network bytes by tier (no tap in the port until
    the cluster, ROADMAP A11) and cache-hit savings. Every dimension is
    a cumulative counter.

``WATCH``
    a `BaselineWatch` keeping EWMA + MAD bands per (shape, backend,
    tier, dimension) over query latency and achieved bytes/s. A band's
    baseline freezes while it is regressed, so a slowdown never becomes
    the new normal, and `pilosa_perf_regression{shape,dimension}` flips
    to 1 under a real regression and back to 0 when it clears.

The attribution context rides a ContextVar (`activate`/`deactivate`):
the handler binds the tenant per request, the executor stamps the plan
shape when it records the route, and everything below charges the
ambient account. Charges with no ambient context fold into the reserved
("system", "-") account, so the sum over accounts of each dimension is
its global total.

Near-free when off: `LEDGER.enabled = False` turns every tap into one
attribute read.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from .profile import default_backend

# Dimensions metered per (tenant, shape) account, in display order.
DIMENSIONS = ("queries", "device_us", "saved_device_us",
              "hbm_byte_seconds", "staged_bytes", "wal_bytes",
              "net_ici_bytes", "net_http_bytes")

# Reserved account for charges with no ambient attribution context
# (background replication, anti-entropy, drain) and for folded
# overflow when the account table hits its bound.
FALLBACK = ("system", "-")

# Routes that answer from a cache or memo: their latency says nothing
# about execution cost, so the baseline watch must not learn from them.
_CACHED_ROUTES = frozenset(("memo", "result-cache"))


class _Ctx:
    """Mutable per-request attribution context. The handler sets the
    tenant; the executor fills in the shape once the plan is known."""

    __slots__ = ("tenant", "shape", "weight")

    def __init__(self, tenant: str, weight: float = 1.0):
        self.tenant = tenant
        self.shape = "-"
        # device_us extrapolation factor: the profile sample rate for
        # 1-in-N sampled queries, 1.0 for explicitly profiled ones.
        self.weight = weight


CURRENT_ACCOUNT: "contextvars.ContextVar[Optional[_Ctx]]" = \
    contextvars.ContextVar("pilosa_tpu_torch_cost_account", default=None)


def activate(tenant: str, weight: float = 1.0):
    """Bind a request's attribution context; returns (ctx, token)."""
    ctx = _Ctx(tenant, weight)
    return ctx, CURRENT_ACCOUNT.set(ctx)


def deactivate(token) -> None:
    CURRENT_ACCOUNT.reset(token)


def current() -> Optional[_Ctx]:
    return CURRENT_ACCOUNT.get()


class Account:
    """One (tenant, shape) row of the ledger. Mutated only under the
    ledger lock."""

    __slots__ = DIMENSIONS + ("first_seen", "last_seen")

    def __init__(self, now: float):
        for d in DIMENSIONS:
            setattr(self, d, 0.0)
        self.first_seen = now
        self.last_seen = now

    def to_dict(self) -> Dict[str, float]:
        return {d: getattr(self, d) for d in DIMENSIONS}


class _View:
    """Residency record for one staged device view: who touched it
    since staging, and when bytes × dt was last charged out."""

    __slots__ = ("nbytes", "touchers", "t_mark")

    def __init__(self, nbytes: int, t_mark: float):
        self.nbytes = int(nbytes)
        # (tenant, shape) -> touch count; bounded, overflow folds into
        # FALLBACK so amortization stays well-defined.
        self.touchers: Dict[Tuple[str, str], int] = {}
        self.t_mark = t_mark


class CostLedger:
    """Bounded (tenant × shape) resource accounts.

    Accounts are LRU-bounded at `max_accounts`; on overflow the
    least-recently-charged account is *folded* into the reserved
    FALLBACK row rather than dropped, so every dimension remains a
    conserved cumulative counter no matter how hostile the shape
    cardinality is.
    """

    MAX_TOUCHERS_PER_VIEW = 8

    def __init__(self, max_accounts: int = 256,
                 clock: Callable[[], float] = time.monotonic):
        self.enabled = True
        self.max_accounts = int(max_accounts)
        self.clock = clock
        self._mu = threading.Lock()
        self._accounts: "OrderedDict[Tuple[str, str], Account]" = \
            OrderedDict()
        # Per-shape device history feeding the cache-savings credit:
        # shape -> [device_us_total, executions].
        self._shape_dev: Dict[str, List[float]] = {}
        # Per-tenant device_us rollup for O(1) share lookups (the
        # X-Pilosa-Cost-Debt stamp sits on the query hot path).
        self._tenant_dev: Dict[str, float] = {}
        self._total_dev = 0.0
        self._dev_samples = 0
        # Staged-view residency registry for hbm_byte_seconds.
        self._views: Dict[Any, _View] = {}
        self.events = {"tracked": 0, "folded": 0, "unattributed": 0}

    # -- account table ----------------------------------------------------

    def _account_locked(self, key: Tuple[str, str], now: float) -> Account:
        acct = self._accounts.get(key)
        if acct is not None:
            self._accounts.move_to_end(key)
            acct.last_seen = now
            return acct
        if key == FALLBACK or key[0] == FALLBACK[0]:
            self.events["unattributed"] += 1
        while len(self._accounts) >= self.max_accounts:
            old_key, old = next(iter(self._accounts.items()))
            if old_key == FALLBACK:  # never fold the fallback row away
                self._accounts.move_to_end(old_key)
                if len(self._accounts) < 2:
                    break
                old_key, old = next(iter(self._accounts.items()))
            del self._accounts[old_key]
            fb = self._accounts.get(FALLBACK)
            if fb is None:
                fb = self._accounts[FALLBACK] = Account(now)
            for d in DIMENSIONS:
                setattr(fb, d, getattr(fb, d) + getattr(old, d))
            self.events["folded"] += 1
        acct = self._accounts[key] = Account(now)
        self.events["tracked"] += 1
        return acct

    def _key(self, tenant: Optional[str], shape: Optional[str]) \
            -> Tuple[str, str]:
        if tenant is None or shape is None:
            ctx = CURRENT_ACCOUNT.get()
            if ctx is not None:
                tenant = tenant if tenant is not None else ctx.tenant
                shape = shape if shape is not None else ctx.shape
        return (tenant or FALLBACK[0], shape or FALLBACK[1])

    def charge(self, dim: str, amount: float,
               tenant: Optional[str] = None,
               shape: Optional[str] = None) -> None:
        """Add `amount` to one dimension of the (tenant, shape)
        account, resolving unspecified halves from the ambient
        context. The single entry point every tap goes through."""
        if not self.enabled or amount == 0:
            return
        key = self._key(tenant, shape)
        with self._mu:
            acct = self._account_locked(key, self.clock())
            setattr(acct, dim, getattr(acct, dim) + amount)
            if dim == "device_us":
                self._tenant_dev[key[0]] = \
                    self._tenant_dev.get(key[0], 0.0) + amount
                self._total_dev += amount

    # -- executor route tap -----------------------------------------------

    def observe_route(self, shape: str, route: str, tier: str,
                      lat_us: float, staged_bytes: int = 0,
                      cache: Optional[str] = None) -> None:
        """Per-call tap from Executor._record_route: stamps the shape
        on the ambient context, meters staged bytes and op count, and
        credits cache hits with the shape's own historical device
        cost."""
        if not self.enabled:
            return
        ctx = CURRENT_ACCOUNT.get()
        if ctx is not None:
            ctx.shape = shape
            key = (ctx.tenant or FALLBACK[0], shape or FALLBACK[1])
        else:
            key = (FALLBACK[0], shape or FALLBACK[1])
        with self._mu:
            acct = self._account_locked(key, self.clock())
            acct.queries += 1
            if staged_bytes:
                acct.staged_bytes += staged_bytes
            if cache == "hit":
                hist = self._shape_dev.get(shape)
                if hist and hist[1] > 0:
                    acct.saved_device_us += hist[0] / hist[1]

    def record_device_us(self, us: float, weight: float = 1.0,
                         tenant: Optional[str] = None,
                         shape: Optional[str] = None) -> None:
        """Charge measured device_exec time (from a finished
        QueryProfile), extrapolated by the sampling weight, and feed
        the shape's cache-savings history with the unweighted
        observation."""
        if not self.enabled or us <= 0:
            return
        key = self._key(tenant, shape)
        with self._mu:
            acct = self._account_locked(key, self.clock())
            amount = us * max(1.0, weight)
            acct.device_us += amount
            self._tenant_dev[key[0]] = \
                self._tenant_dev.get(key[0], 0.0) + amount
            self._total_dev += amount
            self._dev_samples += 1
            hist = self._shape_dev.get(key[1])
            if hist is None:
                hist = self._shape_dev[key[1]] = [0.0, 0.0]
            hist[0] += us
            hist[1] += 1

    # Shares over a handful of profiled queries are noise — the first
    # tenant to land a sample briefly "owns" 100% of device time. The
    # debt signal stays silent until this many device recordings have
    # accumulated.
    MIN_SHARE_SAMPLES = 32

    def tenant_share(self, tenant: str) -> float:
        """This tenant's fraction of all attributed device_us — the
        observe-only signal behind the X-Pilosa-Cost-Debt header.
        Reports 0 until MIN_SHARE_SAMPLES device recordings exist."""
        with self._mu:
            if (self._total_dev <= 0
                    or self._dev_samples < self.MIN_SHARE_SAMPLES):
                return 0.0
            return self._tenant_dev.get(tenant, 0.0) / self._total_dev

    # -- staged-view residency (hbm_byte_seconds) --------------------------

    def view_staged(self, key: Any, nbytes: int) -> None:
        """A view landed on device: start (or restart) its residency
        meter, crediting the ambient account as first toucher."""
        if not self.enabled:
            return
        now = self.clock()
        akey = self._key(None, None)
        with self._mu:
            v = self._views.get(key)
            if v is not None:
                self._checkpoint_view_locked(v, now)
                v.nbytes = int(nbytes)
            else:
                v = self._views[key] = _View(nbytes, now)
            self._touch_locked(v, akey)

    def view_touched(self, key: Any) -> None:
        """A query resolved against an already-staged view: charge the
        interval so far, then add the ambient account to the touch
        set."""
        if not self.enabled:
            return
        ctx = CURRENT_ACCOUNT.get()
        if ctx is None:
            return  # background resolution: stager keeps paying
        now = self.clock()
        akey = (ctx.tenant or FALLBACK[0], ctx.shape or FALLBACK[1])
        with self._mu:
            v = self._views.get(key)
            if v is None:
                return
            self._checkpoint_view_locked(v, now)
            self._touch_locked(v, akey)

    def view_evicted(self, key: Any) -> None:
        """A view left the device: charge its final interval and drop
        the residency record."""
        if not self.enabled:
            return
        now = self.clock()
        with self._mu:
            v = self._views.pop(key, None)
            if v is not None:
                self._checkpoint_view_locked(v, now)

    def checkpoint(self) -> None:
        """Charge every resident view's bytes × dt up to now. Called
        from snapshot()/families() so exported byte-seconds are always
        current, and safe to call any time."""
        if not self.enabled:
            return
        now = self.clock()
        with self._mu:
            for v in self._views.values():
                self._checkpoint_view_locked(v, now)

    def _touch_locked(self, v: _View, akey: Tuple[str, str]) -> None:
        if akey not in v.touchers and \
                len(v.touchers) >= self.MAX_TOUCHERS_PER_VIEW:
            akey = FALLBACK
        v.touchers[akey] = v.touchers.get(akey, 0) + 1

    def _checkpoint_view_locked(self, v: _View, now: float) -> None:
        dt = now - v.t_mark
        v.t_mark = now
        if dt <= 0 or v.nbytes <= 0:
            return
        total = v.nbytes * dt
        touches = sum(v.touchers.values())
        shares = v.touchers.items() if touches else [(FALLBACK, 1)]
        denom = touches or 1
        for akey, n in shares:
            acct = self._account_locked(akey, now)
            acct.hbm_byte_seconds += total * (n / denom)

    # -- output ------------------------------------------------------------

    def totals(self) -> Dict[str, float]:
        self.checkpoint()
        out = {d: 0.0 for d in DIMENSIONS}
        with self._mu:
            for acct in self._accounts.values():
                for d in DIMENSIONS:
                    out[d] += getattr(acct, d)
        return out

    def snapshot(self, sort: str = "device_us", limit: int = 50,
                 watch: Optional["BaselineWatch"] = None) \
            -> Dict[str, Any]:
        """Top-K accounts plus dimension totals, shaped for
        /debug/costs. sort ∈ device_us|hbm|staged|wal|net|queries|
        regression (regression orders by the watch's active flags,
        then device_us)."""
        self.checkpoint()
        sort_dim = {"hbm": "hbm_byte_seconds", "staged": "staged_bytes",
                    "wal": "wal_bytes", "net": "net_http_bytes",
                    }.get(sort, sort)
        if sort_dim not in DIMENSIONS and sort_dim != "regression":
            sort_dim = "device_us"
        regressed = set()
        if watch is not None:
            regressed = {s for (s, _d) in watch.active()}
        with self._mu:
            rows = []
            totals = {d: 0.0 for d in DIMENSIONS}
            for (tenant, shape), acct in self._accounts.items():
                row = {"tenant": tenant, "shape": shape}
                row.update(acct.to_dict())
                row["regressed"] = shape in regressed
                rows.append(row)
                for d in DIMENSIONS:
                    totals[d] += getattr(acct, d)
            events = dict(self.events)
            n_views = len(self._views)
        if sort_dim == "regression":
            rows.sort(key=lambda r: (not r["regressed"],
                                     -r["device_us"]))
        else:
            rows.sort(key=lambda r: -r[sort_dim])
        return {"sort": sort, "accounts": rows[:max(1, int(limit))],
                "n_accounts": len(rows), "totals": totals,
                "events": events, "resident_views": n_views}

    def families(self) -> List[Any]:
        """Cumulative-counter families per account — mergeable across nodes
        by construction (merge sums duplicates across nodes)."""
        from .prom import MetricFamily
        self.checkpoint()
        specs = (
            ("pilosa_cost_queries_total", "queries",
             "Operations metered into this (tenant, shape) account."),
            ("pilosa_cost_device_us_total", "device_us",
             "Attributed device microseconds (sampled path "
             "extrapolated by the profile sample rate)."),
            ("pilosa_cost_saved_device_us_total", "saved_device_us",
             "Device microseconds avoided by result-cache hits, "
             "credited from the shape's own history."),
            ("pilosa_cost_hbm_byte_seconds_total", "hbm_byte_seconds",
             "Integrated HBM residency (bytes x seconds) amortized "
             "over the accounts that touched each staged view."),
            ("pilosa_cost_staged_bytes_total", "staged_bytes",
             "H2D bytes staged on behalf of this account."),
            ("pilosa_cost_wal_bytes_total", "wal_bytes",
             "WAL bytes group-committed on behalf of this account."),
        )
        with self._mu:
            items = list(self._accounts.items())
        fams = []
        for fname, dim, help_ in specs:
            fam = MetricFamily(fname, "counter", help_)
            for (tenant, shape), acct in items:
                # Quantize to integers: integer-valued floats sum
                # associatively, so merges of these families across nodes
                # stay exact regardless of summation order.
                val = int(getattr(acct, dim))
                if val:
                    fam.add(val, {"tenant": tenant, "shape": shape})
            if fam.samples:
                fams.append(fam)
        net = MetricFamily(
            "pilosa_cost_net_bytes_total", "counter",
            "Network bytes attributed per account, split by locality "
            "tier (per-call attribution under pilosa_tier_bytes_total).")
        for (tenant, shape), acct in items:
            for tier, dim in (("ici", "net_ici_bytes"),
                              ("http", "net_http_bytes")):
                val = getattr(acct, dim)
                if val:
                    net.add(val, {"tenant": tenant, "shape": shape,
                                  "tier": tier})
        if net.samples:
            fams.append(net)
        ev = MetricFamily(
            "pilosa_cost_ledger_events_total", "counter",
            "Ledger account-table events (tracked/folded/unattributed).")
        with self._mu:
            for name, n in sorted(self.events.items()):
                if n:
                    ev.add(n, {"account": name})
        if ev.samples:
            fams.append(ev)
        return fams


class _Band:
    """EWMA + MAD band for one (shape, backend, tier, dimension).

    `baseline` is a slow EWMA standing in for the median; `mad` is an
    EWMA of absolute deviation (×1.4826 ≈ σ under normality); `fast`
    tracks the current regime. Baseline and MAD freeze while the band
    is regressed so a sustained slowdown cannot launder itself into
    the new normal — which is also what lets the flag drop cleanly on
    recovery.
    """

    __slots__ = ("n", "baseline", "mad", "fast", "regressed", "worse")

    ALPHA_SLOW = 0.05
    ALPHA_FAST = 0.30

    def __init__(self, worse: int):
        self.n = 0
        self.baseline = 0.0
        self.mad = 0.0
        self.fast = 0.0
        self.regressed = False
        self.worse = worse  # +1: higher is worse; -1: lower is worse

    def seed(self, center: float, spread: float, n: int) -> None:
        if self.n == 0 and center > 0:
            self.baseline = self.fast = float(center)
            self.mad = max(float(spread), center * 0.05)
            self.n = int(n)

    def observe(self, value: float, k: float, min_n: int) -> None:
        if self.n == 0:
            self.baseline = self.fast = value
            self.mad = abs(value) * 0.05
            self.n = 1
            return
        self.n += 1
        self.fast += self.ALPHA_FAST * (value - self.fast)
        # Judge against the PRE-update baseline and MAD: letting the
        # anomalous sample widen the band first inflates it in
        # lockstep with the deviation, and a sustained step change
        # then never trips — it launders itself into the new normal.
        if self.n >= max(2, min_n):
            band = k * self.mad * 1.4826
            dev = (self.fast - self.baseline) * self.worse
            # Two gates: outside the MAD band AND a 25% ratio shift —
            # the ratio guard keeps ultra-tight bands (near-zero MAD
            # on a metronomic workload) from flagging measurement
            # jitter.
            if dev > band and dev > 0.25 * abs(self.baseline):
                self.regressed = True
            elif dev <= 0.5 * band or dev <= 0.10 * abs(self.baseline):
                self.regressed = False
        if not self.regressed:
            self.baseline += self.ALPHA_SLOW * (value - self.baseline)
            self.mad += self.ALPHA_SLOW * (abs(value - self.baseline)
                                           - self.mad)

    def to_dict(self) -> Dict[str, float]:
        return {"n": self.n, "baseline": round(self.baseline, 1),
                "mad": round(self.mad, 1), "current": round(self.fast, 1),
                "regressed": self.regressed}


class BaselineWatch:
    """Self-baselining regression detector over the route stream.

    Keyed (shape, backend, tier, dimension) with dimension ∈
    {latency_us, bytes_per_s}; bounded LRU at `max_bands`. Exports
    `pilosa_perf_regression{shape,dimension}` — 1 while any
    (backend, tier) band for that shape and dimension is regressed.
    """

    def __init__(self, max_bands: int = 256, k: float = 4.0,
                 min_n: int = 32):
        self.enabled = True
        self.max_bands = int(max_bands)
        self.k = float(k)
        self.min_n = int(min_n)
        self._mu = threading.Lock()
        self._bands: "OrderedDict[Tuple[str, str, str, str], _Band]" = \
            OrderedDict()

    def _band_locked(self, key: Tuple[str, str, str, str],
                     worse: int) -> _Band:
        b = self._bands.get(key)
        if b is None:
            while len(self._bands) >= self.max_bands:
                self._bands.popitem(last=False)
            b = self._bands[key] = _Band(worse)
        else:
            self._bands.move_to_end(key)
        return b

    def observe(self, shape: str, backend: str, tier: str,
                lat_us: float, bytes_per_s: float = 0.0,
                route: str = "") -> None:
        if not self.enabled or route in _CACHED_ROUTES:
            return
        with self._mu:
            self._band_locked((shape, backend, tier, "latency_us"), +1) \
                .observe(lat_us, self.k, self.min_n)
            if bytes_per_s > 0:
                self._band_locked(
                    (shape, backend, tier, "bytes_per_s"), -1) \
                    .observe(bytes_per_s, self.k, self.min_n)

    def seed(self, shape: str, backend: str, tier: str,
             dimension: str, center: float, spread: float,
             n: int) -> None:
        worse = -1 if dimension == "bytes_per_s" else +1
        with self._mu:
            self._band_locked((shape, backend, tier, dimension),
                              worse).seed(center, spread, n)

    def seed_from_flight(self, flight_snapshot: Any,
                         backend: Optional[str] = None) -> int:
        """Warm-start latency bands from the flight recorder's
        per-shape percentile history, so a restarted node watches with
        its earlier memory instead of relearning from zero. Accepts
        either the /debug/queryshapes document (rows under "top") or a
        bare row list."""
        if backend is None:
            backend = default_backend()
        rows = flight_snapshot
        if isinstance(rows, dict):
            rows = rows.get("top") or []
        seeded = 0
        for row in rows:
            shape = (row.get("signature") or row.get("shape")
                     or row.get("sig"))
            p50 = row.get("lat_p50_us") or row.get("p50_us")
            if not shape or not p50:
                continue
            hi = (row.get("lat_p95_us") or row.get("p95_us")
                  or row.get("p99_us") or p50)
            n = min(int(row.get("count", 1)), 4 * self.min_n)
            for tier in (row.get("tiers") or {"local": 1}):
                self.seed(shape, backend, tier, "latency_us",
                          float(p50), max(0.0, (hi - p50) / 2.0),
                          n)
                seeded += 1
        return seeded

    def active(self) -> List[Tuple[str, str]]:
        """Currently-regressed (shape, dimension) pairs, any
        backend/tier."""
        with self._mu:
            return sorted({(s, d)
                           for (s, _b, _t, d), band in self._bands.items()
                           if band.regressed})

    def snapshot(self, limit: int = 50) -> List[Dict[str, Any]]:
        with self._mu:
            items = list(self._bands.items())
        rows = []
        for (shape, backend, tier, dim), band in items:
            row = {"shape": shape, "backend": backend, "tier": tier,
                   "dimension": dim}
            row.update(band.to_dict())
            rows.append(row)
        rows.sort(key=lambda r: (not r["regressed"], -r["n"]))
        return rows[:max(1, int(limit))]

    def families(self) -> List[Any]:
        from .prom import MetricFamily
        with self._mu:
            flags: Dict[Tuple[str, str], int] = {}
            for (shape, _b, _t, dim), band in self._bands.items():
                if band.n >= self.min_n or band.regressed:
                    key = (shape, dim)
                    flags[key] = max(flags.get(key, 0),
                                     1 if band.regressed else 0)
        if not flags:
            return []
        fam = MetricFamily(
            "pilosa_perf_regression", "gauge",
            "1 while the shape's EWMA+MAD band says this dimension "
            "regressed against its own baseline.")
        for (shape, dim), val in sorted(flags.items()):
            fam.add(val, {"shape": shape, "dimension": dim})
        return [fam]


LEDGER = CostLedger()
WATCH = BaselineWatch()


def observe_route(shape: str, route: str, tier: str, lat_us: float,
                  staged_bytes: int = 0,
                  cache: Optional[str] = None) -> None:
    """The executor's single per-call tap: ledger + baseline watch.
    One attribute read when the ledger is disabled."""
    if not LEDGER.enabled:
        return
    LEDGER.observe_route(shape, route, tier, lat_us,
                         staged_bytes=staged_bytes, cache=cache)
    bps = staged_bytes / (lat_us / 1e6) if (staged_bytes and lat_us > 0) \
        else 0.0
    WATCH.observe(shape, default_backend(), tier, lat_us,
                  bytes_per_s=bps, route=route)


def families() -> List[Any]:
    """Collector bridge for the /metrics registry."""
    return LEDGER.families() + WATCH.families()
