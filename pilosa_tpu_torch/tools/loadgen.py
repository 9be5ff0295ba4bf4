"""Seeded, deterministic traffic with SLO verdicts, against one node of
the port (the JAX package's tools/loadgen.py, for one node).

    python -m pilosa_tpu_torch.ctl loadgen --in-process --duration 5
    python -m pilosa_tpu_torch.ctl loadgen --host H:P --index i --frame f \
        --mix read=0.6,write=0.2,topn=0.2 --mode open --burst spike

The whole request schedule (arrival times, tenants, rows, columns,
operations, PQL texts) derives from one `random.Random` seed, so the
same `--seed` replays the same workload byte for byte, the JAX
loadgen's too (`--print-schedule` prints it). Skew is zipfian over
tenants and rows, the op mix is declarative (`read=0.65,write=0.2,
topn=0.15`; also `range`, `zipf_read`, `bsi_sum`, `bsi_range`), and
the arrival rate follows a burst curve (steady, a diurnal sine, a
mid-run spike) after a warmup that is sent but not judged.

Two loop disciplines: **closed**, `--concurrency` workers with one
request each in flight (the offered load follows the service time: a
capacity probe), and **open**, requests fired at their scheduled
instants whatever completes (what exposes queueing and shedding).

Around the run it scrapes `/metrics` (the shadow-mismatch growth) and
`/debug/slo`, and writes a `LOADGEN_<seed>.json` report: achieved QPS,
per-tenant p50/p95/p99 from the client's own timings, shed and error
rates, the mismatch growth, a verdict per objective and the server's
own SLO judgment. It exits 1 on any VIOLATED objective.

`--in-process` boots a throwaway `server.Server` on a loopback port,
on the card unless $PILOSA_TORCH_USE_DEVICE says `off` (the CPU);
`--cluster-nodes N` boots N of them as one cluster (`--cluster-replicas`
copies of each slice; the JAX tool's nodes default to `off`, the port's
to the card) and sends the traffic to node 0.
`--fault` arms a fault.py spec in that server mid-run (at `--fault-at`
of the run): `device.exec:error=ResourceExhausted,prob=.5` drives the
evict, retry, host-fold and quarantine ladder under live traffic (the
bar: no wrong answer); a `watchdog.stall` spec (say
`watchdog.stall:delay=2,subsystem=scrub`) shrinks the scrub and sweep
cadence and judges the watchdog's trip and recovery.

Cluster mode's write churn: `--kill-replica-at F` closes the last node
at F of the run and `--restart-replica-at F` reopens it on its data dir;
after the run the coordinator's hints must drain to at most
`--hint-backlog-max` records and the restarted replica's block digests
of slice 0 must equal the coordinator's (anti-entropy is off, so only
the hint replay can converge it). `--staleness-ms` sends
X-Pilosa-Staleness on every request and judges the bounded reads (no
5xx, no stale result-cache serve, the cache's hit rate against the
schedule's ceiling); `--partial` sends ?partial=true.
"""

from __future__ import annotations

import argparse
import bisect
import json
import math
import os
import random
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

DEFAULT_MIX = "read=0.65,write=0.20,topn=0.15,range=0.0"

# Fixed Range() window: the schedule must be seed-deterministic, so no
# wall-clock reads anywhere in generation.
RANGE_START = "2016-01-01T00:00"
RANGE_END = "2026-01-01T00:00"

# BSI analytics ops (bsi_sum / bsi_range in the mix) target one integer
# field with a fixed declared range; prepare_index creates it and seeds
# deterministic SetValues so aggregates have data to chew on.
BSI_FIELD = "val"
BSI_MIN = -1024
BSI_MAX = 1024
BSI_SEED_COLUMNS = 256
_BSI_RANGE_OPS = (">=", ">", "<", "<=", "==")


# -- deterministic schedule generation ------------------------------------


def parse_mix(text: str) -> List[tuple]:
    """"read=0.65,write=0.2,..." -> [(op, cum_weight)] CDF."""
    ops = []
    total = 0.0
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, w = item.partition("=")
        name = name.strip()
        if name not in ("read", "write", "topn", "range",
                        "bsi_sum", "bsi_range", "zipf_read"):
            raise ValueError(f"unknown op {name!r} in mix")
        total += float(w)
        ops.append((name, total))
    if total <= 0:
        raise ValueError("op mix weights sum to zero")
    return [(name, cum / total) for name, cum in ops]


def zipf_cdf(n: int, s: float) -> List[float]:
    """CDF over ranks 1..n with P(rank k) ∝ 1/k^s."""
    weights = [1.0 / (k ** s) for k in range(1, n + 1)]
    total = sum(weights)
    out, cum = [], 0.0
    for w in weights:
        cum += w / total
        out.append(cum)
    out[-1] = 1.0
    return out


def pick(rng: random.Random, cdf: List[float]) -> int:
    return bisect.bisect_left(cdf, rng.random())


def burst_factor(curve: str, frac: float) -> float:
    """Arrival-rate multiplier at `frac` ∈ [0,1) of the run."""
    if curve == "diurnal":
        # One full day compressed into the run: peak 1.8x, trough 0.2x.
        return max(0.1, 1.0 + 0.8 * math.sin(2.0 * math.pi * frac))
    if curve == "spike":
        # 4x square wave through the middle tenth — the shape that
        # separates open-loop shedding from closed-loop slowdown.
        return 4.0 if 0.45 <= frac < 0.55 else 1.0
    return 1.0


def build_schedule(spec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The full request schedule, derived ONLY from spec values via one
    seeded RNG — same spec, same bytes. Each entry:
    {i, t (arrival offset s), phase (warmup|run), tenant, op, pql}."""
    rng = random.Random(int(spec["seed"]))
    mix = parse_mix(spec.get("mix", DEFAULT_MIX))
    mix_ops = [m[0] for m in mix]
    mix_cdf = [m[1] for m in mix]
    tenants = list(spec.get("tenants") or ("default",))
    t_cdf = zipf_cdf(len(tenants), float(spec.get("zipf_s", 1.1)))
    rows = int(spec.get("rows", 64))
    row_cdf = zipf_cdf(rows, float(spec.get("zipf_s", 1.1)))
    cols = int(spec.get("columns", 1 << 16))
    frame = spec.get("frame", "f")
    duration = float(spec["duration"])
    warmup = float(spec.get("warmup", 0.0))
    qps = float(spec["qps"])
    curve = spec.get("burst", "none")

    out: List[Dict[str, Any]] = []
    t = -warmup
    i = 0
    while t < duration:
        phase = "warmup" if t < 0 else "run"
        tenant = tenants[pick(rng, t_cdf)]
        op = mix_ops[pick(rng, mix_cdf)]
        row = pick(rng, row_cdf)
        col = rng.randrange(cols)
        if op in ("read", "zipf_read"):
            # zipf_read is the same Count shape under its own name
            # (the JAX loadgen's follower-read verdict computes its
            # cache-hit ceiling over exactly that stream).
            pql = f"Count(Bitmap(rowID={row}, frame={frame}))"
        elif op == "write":
            pql = f"SetBit(rowID={row}, frame={frame}, columnID={col})"
        elif op == "topn":
            pql = f"TopN(frame={frame}, n=10)"
        elif op == "bsi_sum":
            pql = f'Sum(frame={frame}, field="{BSI_FIELD}")'
        elif op == "bsi_range":
            cmp_op = _BSI_RANGE_OPS[
                rng.randrange(len(_BSI_RANGE_OPS))]
            thresh = rng.randrange(BSI_MIN, BSI_MAX + 1)
            pql = (f"Count(Range(frame={frame}, "
                   f"{BSI_FIELD} {cmp_op} {thresh}))")
        else:
            pql = (f'Range(rowID={row}, frame={frame}, '
                   f'start="{RANGE_START}", end="{RANGE_END}")')
        out.append({"i": i, "t": round(t + warmup, 6), "phase": phase,
                    "tenant": tenant, "op": op, "pql": pql})
        i += 1
        # Inter-arrival from the burst-curve-modulated rate. The curve
        # is sampled at the RUN fraction (warmup runs at base rate).
        frac = max(0.0, t) / duration
        rate = qps * (burst_factor(curve, frac) if t >= 0 else 1.0)
        t += 1.0 / max(rate, 1e-9)
    return out


# -- transports ------------------------------------------------------------


class HTTPTransport:
    """Raw urllib POSTs, not api.client.InternalClient, whose retries
    and status classification would hide the 429 / 503 / 504 outcomes
    the SLO math judges."""

    def __init__(self, host: str, index: str = "loadgen",
                 timeout: float = 10.0, partial: bool = False,
                 deadline: str = "", staleness_ms: float = 0.0):
        self.base = host if "://" in host else "http://" + host
        self.index = index
        self.timeout = timeout
        self.staleness_ms = float(staleness_ms)
        params = []
        if partial:
            params.append("partial=true")
        if deadline:
            params.append(f"deadline={deadline}")
        self.query_path = (f"/index/{index}/query"
                           + ("?" + "&".join(params) if params else ""))
        # X-Pilosa-Cost-Debt sightings, tenant -> count (the cost_skew
        # judge gates on the header firing for the whale and only it).
        self.debt_by_tenant: Dict[str, int] = {}
        self._debt_mu = threading.Lock()

    def do(self, entry: Dict[str, Any]) -> tuple:
        """-> (status, partial flag). A transport failure is 599, an
        error outcome, never an exception."""
        headers = {"X-Pilosa-Tenant": entry["tenant"],
                   "Content-Type": "text/plain"}
        if self.staleness_ms > 0:
            # Writes ignore the bound, so it rides every request.
            headers["X-Pilosa-Staleness"] = f"{self.staleness_ms:g}ms"
        req = urllib.request.Request(
            self.base + self.query_path, data=entry["pql"].encode(),
            headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                body = r.read()
                if r.headers.get("X-Pilosa-Cost-Debt"):
                    with self._debt_mu:
                        t = entry["tenant"]
                        self.debt_by_tenant[t] = \
                            self.debt_by_tenant.get(t, 0) + 1
                partial = b'"partial": true' in body
                return r.status, partial
        except urllib.error.HTTPError as e:
            e.read()
            return e.code, False
        except Exception:  # noqa: BLE001 — refused/reset/timeout
            return 599, False

    def get_json(self, path: str) -> Optional[dict]:
        try:
            with urllib.request.urlopen(self.base + path,
                                        timeout=self.timeout) as r:
                return json.loads(r.read())
        except Exception:  # noqa: BLE001
            return None

    def get_text(self, path: str) -> str:
        try:
            with urllib.request.urlopen(self.base + path,
                                        timeout=self.timeout) as r:
                return r.read().decode()
        except Exception:  # noqa: BLE001
            return ""


class StubTransport:
    """Test transport: records the entries it was handed and answers
    from a status function — the determinism tests run a full loadgen
    pass with no server at all."""

    def __init__(self, status_fn: Optional[Callable] = None):
        self.entries: List[Dict[str, Any]] = []
        self._fn = status_fn or (lambda entry: (200, False))
        self._mu = threading.Lock()
        self.debt_by_tenant: Dict[str, int] = {}

    def do(self, entry):
        with self._mu:
            self.entries.append(entry)
        return self._fn(entry)

    def get_json(self, path):
        return None

    def get_text(self, path):
        return ""


# -- run + report ----------------------------------------------------------


def _mismatch_total(metrics_text: str) -> float:
    total = 0.0
    for line in metrics_text.splitlines():
        if line.startswith("pilosa_shadow_mismatch_total"):
            try:
                total += float(line.rsplit(None, 1)[1])
            except (ValueError, IndexError):
                pass
    return total


def percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(math.ceil(q * len(sorted_vals))) - 1))
    return sorted_vals[idx]


def run(spec: Dict[str, Any], transport,
        log: Callable[[str], None] = lambda s: None,
        fault_cb: Optional[Callable[[], None]] = None) -> Dict[str, Any]:
    """Execute the schedule through `transport`; returns the report.

    `fault_cb` fires once, when the run crosses `fault_at` × duration
    (schedule time in open-loop, progress fraction in closed-loop).
    """
    schedule = build_schedule(spec)
    mode = spec.get("mode", "closed")
    concurrency = max(1, int(spec.get("concurrency", 4)))
    duration = float(spec["duration"])
    fault_at = float(spec.get("fault_at", 0.25)) * duration
    results: List[tuple] = []  # (entry index, status, partial, dt_s)
    res_mu = threading.Lock()
    fault_fired = threading.Event()

    def maybe_fault(progressed_s: float):
        if fault_cb is not None and progressed_s >= fault_at \
                and not fault_fired.is_set():
            fault_fired.set()
            log(f"arming fault seams at t={progressed_s:.1f}s")
            fault_cb()

    def fire(entry):
        t0 = time.monotonic()
        status, partial = transport.do(entry)
        dt = time.monotonic() - t0
        with res_mu:
            results.append((entry["i"], status, partial, dt))

    t_start = time.monotonic()
    if mode == "open":
        # Arrivals at their scheduled instants, completions be damned.
        # The pool is deep so a slow server queues here (visible as
        # latency), instead of silently closing the loop.
        with ThreadPoolExecutor(max_workers=concurrency * 8) as pool:
            for entry in schedule:
                lag = entry["t"] - (time.monotonic() - t_start)
                if lag > 0:
                    time.sleep(lag)
                maybe_fault(entry["t"])
                pool.submit(fire, entry)
    else:
        idx_mu = threading.Lock()
        pos = [0]

        def worker():
            while True:
                with idx_mu:
                    i = pos[0]
                    if i >= len(schedule):
                        return
                    pos[0] += 1
                maybe_fault(len(schedule) and
                            (i / len(schedule)) * duration)
                fire(schedule[i])

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(concurrency)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    wall = time.monotonic() - t_start

    # -- tally (run phase only; warmup requests were sent, not judged)
    phases = {e["i"]: e["phase"] for e in schedule}
    tenants_of = {e["i"]: e["tenant"] for e in schedule}
    ops_of = {e["i"]: e["op"] for e in schedule}
    times_of = {e["i"]: e["t"] for e in schedule}
    judged = [(i, st, p, dt) for i, st, p, dt in results
              if phases.get(i) == "run"]
    total = len(judged)
    by_outcome: Dict[str, int] = {}
    lat_by_tenant: Dict[str, List[float]] = {}
    # Read-stream availability and a schedule-time decile timeline
    # (the JAX loadgen's follower-read verdict gates on them under
    # replica churn; the report keeps them on one node too).
    read_total = read_5xx = 0
    ok_by_decile = [0] * 10
    total_by_decile = [0] * 10
    warmup_off = float(spec.get("warmup", 0.0))
    for i, st, partial, dt in judged:
        dec = min(9, max(0, int(
            10.0 * (times_of.get(i, 0.0) - warmup_off) / duration)))
        total_by_decile[dec] += 1
        if ops_of.get(i) in ("read", "zipf_read"):
            read_total += 1
            if st >= 500:
                read_5xx += 1
        if st == 429:
            oc = "shed"
        elif st == 504:
            oc = "deadline"
        elif st == 503:
            oc = "backpressure"
        elif st >= 500:
            oc = "error"
        elif st >= 400:
            oc = "client_error"
        else:
            oc = "partial" if partial else "ok"
            lat_by_tenant.setdefault(tenants_of[i], []).append(dt * 1e6)
            ok_by_decile[dec] += 1
        by_outcome[oc] = by_outcome.get(oc, 0) + 1

    good = sum(by_outcome.get(o, 0)
               for o in ("ok", "partial", "client_error"))
    shed = by_outcome.get("shed", 0)
    served = sorted(v for lats in lat_by_tenant.values() for v in lats)
    obj = spec["objectives"]
    p99_us = float(obj["p99_us"])
    under = sum(1 for v in served if v <= p99_us)

    mm_growth = spec.get("_mismatch_growth", 0.0)
    verdicts = {
        "availability": {
            "target": obj["availability"],
            "measured": 100.0 * good / total if total else 100.0,
        },
        "latency": {
            "target": obj["latency_target"],
            "p99_us_threshold": p99_us,
            "measured": 100.0 * under / len(served) if served else 100.0,
        },
        "shed_rate": {
            "target": obj["shed_rate_max"],
            "measured": shed / total if total else 0.0,
        },
        "correctness": {
            "target": 0,
            "measured": mm_growth,
        },
    }
    verdicts["availability"]["verdict"] = (
        "OK" if verdicts["availability"]["measured"]
        >= obj["availability"] else "VIOLATED")
    verdicts["latency"]["verdict"] = (
        "OK" if verdicts["latency"]["measured"]
        >= obj["latency_target"] else "VIOLATED")
    verdicts["shed_rate"]["verdict"] = (
        "OK" if verdicts["shed_rate"]["measured"]
        <= obj["shed_rate_max"] else "VIOLATED")
    verdicts["correctness"]["verdict"] = ("OK" if mm_growth == 0
                                          else "VIOLATED")

    per_tenant = {}
    for t, lats in sorted(lat_by_tenant.items()):
        lats.sort()
        per_tenant[t] = {
            "served": len(lats),
            "p50_us": round(percentile(lats, 0.50), 1),
            "p95_us": round(percentile(lats, 0.95), 1),
            "p99_us": round(percentile(lats, 0.99), 1),
        }

    report = {
        "spec": {k: v for k, v in spec.items()
                 if not k.startswith("_")},
        "requests_total": len(results),
        "requests_judged": total,
        "wall_s": round(wall, 3),
        "achieved_qps": round(len(results) / wall, 1) if wall > 0 else 0.0,
        "outcomes": by_outcome,
        "shed_rate": round(shed / total, 6) if total else 0.0,
        "error_rate": round((total - good) / total, 6) if total else 0.0,
        "read_total": read_total,
        "read_5xx": read_5xx,
        "ok_by_decile": ok_by_decile,
        "total_by_decile": total_by_decile,
        "mismatch_growth": mm_growth,
        "per_tenant": per_tenant,
        "objectives": verdicts,
        "verdict": ("VIOLATED"
                    if any(v["verdict"] == "VIOLATED"
                           for v in verdicts.values()) else "OK"),
    }
    return report


# -- in-process server ----------------------------------------------------


def _node_config(spec: Dict[str, Any], use_device: Optional[str] = None):
    """An in-process node's Config: on the card unless `use_device` or
    $PILOSA_TORCH_USE_DEVICE says `off`, the spec's tenants declared in
    [sched] tenant-weights, 1 in 4 reads shadow-verified and the spec's
    objectives as [slo]."""
    from ..config import Config

    cfg = Config()
    cfg.use_device = use_device or os.environ.get(
        "PILOSA_TORCH_USE_DEVICE", "on")
    cfg.sched_tenant_weights = {t: 1.0 for t in spec["tenants"]}
    cfg.integrity_shadow_sample = 4
    for k in ("availability", "latency_target", "shed_rate_max"):
        setattr(cfg, "slo_" + k, float(spec["objectives"][k]))
    cfg.slo_p99_us = float(spec["objectives"]["p99_us"])
    return cfg


def start_inprocess(spec: Dict[str, Any], log,
                    watchdog_drill: bool = False,
                    use_device: Optional[str] = None) -> tuple:
    """Boot a one-node Server on a loopback port, the spec's tenants
    declared in [sched] tenant-weights, 1 in 4 answers shadow-verified
    and the spec's objectives as [slo]: the self-contained target of
    smoke and fault-churn runs. `use_device` (default
    $PILOSA_TORCH_USE_DEVICE, else "on": the card) is the config's
    use-device; "off" serves on the CPU. With `watchdog_drill` the
    scrubber runs every 0.5 s and the watchdog sweeps every 0.2 s, so a
    watchdog.stall delay on the scrub loop (one node has no hint
    drainer) trips and recovers within a short run. Returns (server,
    host)."""
    from ..server import Server

    cfg = _node_config(spec, use_device)
    if watchdog_drill:
        cfg.integrity_scrub_interval = 0.5
        cfg.health_sweep_interval = 0.2
    cfg.data_dir = tempfile.mkdtemp(prefix="pilosa-loadgen-")
    cfg.host = "127.0.0.1:0"
    cfg.cluster_hosts = [cfg.host]
    if spec.get("cost_skew"):
        # The cost judge needs device_us attribution, which only the
        # profiler produces: sample 1 in 2 (the ledger extrapolates by
        # the sample rate, so shares stay unbiased).
        cfg.profile_sample_rate = 2
    srv = Server(cfg)
    srv.open(port=0)
    log(f"in-process server at {srv.host} (data {cfg.data_dir}, "
        f"use-device {cfg.use_device})")
    return srv, srv.host


def loopback_ports(n: int) -> List[int]:
    """n free loopback ports below the kernel's ephemeral range: a
    closed node's port inside it can become the source port of a peer's
    outgoing connection, and the node could not bind it again."""
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        lo = 32768
    rng = random.Random()
    out: List[int] = []
    while len(out) < n:
        p = rng.randrange(max(1024, lo - 12000), lo)
        if p in out:
            continue
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", p))
            except OSError:
                continue
        out.append(p)
    return out


def start_inprocess_cluster(spec: Dict[str, Any], nodes: int,
                            replicas: int, log) -> tuple:
    """Boot an N-node cluster of in-process Servers on loopback ports,
    the target of the write-churn run (a replica killed mid-run and
    restarted, judged on the hint drain's convergence). Traffic goes to
    node 0; the last node is the one killed, so the coordinator and its
    quorum partner live. Each node serves on the card unless
    $PILOSA_TORCH_USE_DEVICE says `off`. Anti-entropy and the status
    poll run every hour: convergence must come from the hint replay.
    Returns (servers, configs, hosts)."""
    from ..server import Server

    hosts = [f"127.0.0.1:{p}" for p in loopback_ports(nodes)]
    base = tempfile.mkdtemp(prefix="pilosa-loadgen-cluster-")
    servers, configs = [], []
    for i, h in enumerate(hosts):
        cfg = _node_config(spec)
        cfg.data_dir = os.path.join(base, f"node{i}")
        cfg.host = h
        cfg.cluster_hosts = list(hosts)
        cfg.replica_n = replicas
        cfg.anti_entropy_interval = 3600
        cfg.polling_interval = 3600
        srv = Server(cfg)
        srv.open()
        servers.append(srv)
        configs.append(cfg)
    log(f"in-process cluster: {nodes} nodes, replica_n={replicas}, "
        f"coordinator {hosts[0]} (data {base}, use-device "
        f"{configs[0].use_device})")
    return servers, configs, hosts


def run_replica_churn(servers, configs, duration: float,
                      kill_at: float, restart_at: float, log,
                      state: Dict[str, Any]):
    """Close the last node at `kill_at` x duration and reopen it on its
    data dir at `restart_at` x duration, paced by the wall clock: the
    write stream must keep acking while the replica is really gone."""
    from ..server import Server

    victim = len(servers) - 1
    time.sleep(max(0.0, kill_at * duration))
    log(f"churn: stopping replica {configs[victim].host}")
    servers[victim].close()
    state["killed"] = True
    if restart_at > kill_at:
        time.sleep(max(0.0, (restart_at - kill_at) * duration))
        log(f"churn: restarting replica {configs[victim].host}")
        srv = Server(configs[victim])
        srv.open()
        servers[victim] = srv
        state["restarted"] = True


def _judge_write_churn(report: Dict[str, Any], servers, configs,
                       churn_state: Dict[str, Any], args, log) -> None:
    """Cluster mode's verdict: the coordinator's breaker to the
    restarted replica is closed (the production path: breaker close ->
    mark_live -> the drainer's wake-up, without the cooldown's wait),
    the hints get a bounded window to drain, and the run is judged on
    the backlog left (at most --hint-backlog-max) and on slice 0's block
    digests on the restarted replica against the coordinator's. Folded
    into the report's verdict."""
    from ..api.client import InternalClient

    coord = servers[0]
    victim_host = configs[-1].host
    drained = True
    if churn_state.get("restarted") and coord.hints is not None:
        coord.client.breakers.for_host(victim_host).record_success()
        drained = coord.hints.wait_drained(timeout=max(30.0, args.duration))
    backlog = coord.hints.backlog_records() \
        if coord.hints is not None else 0
    hint_snap = coord.hints.snapshot() if coord.hints is not None else {}

    converged = None
    if churn_state.get("restarted"):
        try:
            blocks = [InternalClient(c.host).fragment_blocks(
                args.index, args.frame, "standard", 0)
                for c in (configs[0], configs[-1])]
            converged = blocks[0] == blocks[1]
        except Exception as e:  # noqa: BLE001 — judged, not raised
            log(f"churn: convergence probe failed: {e}")
            converged = False

    report["write_churn"] = {
        "nodes": len(servers),
        "replica_n": args.cluster_replicas,
        "killed": bool(churn_state.get("killed")),
        "restarted": bool(churn_state.get("restarted")),
        "hint_backlog_after_drain": backlog,
        "hints": hint_snap,
        "replica_converged": converged,
    }
    ok = (drained and backlog <= args.hint_backlog_max
          and converged is not False)
    report["objectives"]["hint_backlog"] = {
        "target": args.hint_backlog_max,
        "measured": backlog,
        "verdict": "OK" if ok else "VIOLATED",
    }
    if not ok:
        report["verdict"] = "VIOLATED"
    log(f"churn: backlog={backlog} converged={converged} "
        f"-> {'OK' if ok else 'VIOLATED'}")


def _metric_value(metrics_text: str, prefix: str) -> float:
    """The sum of every sample whose name and labels start with
    `prefix` (say 'pilosa_result_cache_events_total{event="hit"}')."""
    total = 0.0
    for line in metrics_text.splitlines():
        if line.startswith(prefix):
            try:
                total += float(line.rsplit(None, 1)[1])
            except (ValueError, IndexError):
                pass
    return total


def _judge_follower_reads(report: Dict[str, Any], transport,
                          spec: Dict[str, Any], args, log) -> None:
    """The verdict of a bounded-staleness run (--staleness-ms > 0):

    - read availability: no 5xx on the read stream (a bounded read
      always has a rung: a fresher replica, the owner, partial);
    - staleness: the result cache's shadow mismatches
      (backend="result-cache") stay 0;
    - the cache's hit rate at least the schedule's ceiling less 10
      points, judged once the cache saw 20 lookups;
    - with churn, the last decile's ok-rate at least
      --qps-recovery-min of the first's.

    The ceiling replays the schedule through a perfect epoch-keyed
    cache (no bound, free lookups): a write clears it, since a Count's
    key moves with any touched slice's epoch, so only the zipf repeats
    between writes can hit."""
    cached: set = set()
    possible_hits = read_n = 0
    for e in build_schedule(spec):
        if e["phase"] != "run":
            continue
        if e["op"] == "write":
            cached.clear()
        elif e["op"] in ("read", "zipf_read"):
            read_n += 1
            if e["pql"] in cached:
                possible_hits += 1
            else:
                cached.add(e["pql"])
    ceiling = possible_hits / read_n if read_n else 0.0

    metrics = transport.get_text("/metrics")
    hits = _metric_value(
        metrics, 'pilosa_result_cache_events_total{event="hit"}')
    misses = _metric_value(
        metrics, 'pilosa_result_cache_events_total{event="miss"}')
    probes = hits + misses
    hit_rate = hits / probes if probes else 0.0
    stale_served = _metric_value(
        metrics, 'pilosa_shadow_mismatch_total{backend="result-cache"}')

    read_5xx = int(report.get("read_5xx", 0))
    report["follower_reads"] = {
        "staleness_ms": spec.get("staleness_ms", 0.0),
        "read_total": report.get("read_total", 0),
        "read_5xx": read_5xx,
        "cache_hits": hits,
        "cache_misses": misses,
        "cache_hit_rate": round(hit_rate, 4),
        "zipf_hit_ceiling": round(ceiling, 4),
        "stale_cache_serves": stale_served,
    }

    obj = report["objectives"]
    obj["read_availability"] = {
        "target": 0, "measured": read_5xx,
        "verdict": "OK" if read_5xx == 0 else "VIOLATED"}
    obj["staleness"] = {
        "target": 0, "measured": stale_served,
        "verdict": "OK" if stale_served == 0 else "VIOLATED"}
    target = max(0.0, ceiling - 0.10)
    obj["cache_hit_rate"] = {
        "target": round(target, 4), "measured": round(hit_rate, 4),
        # Under 20 lookups the rate is reported, not judged.
        "verdict": "OK" if probes < 20 or hit_rate >= target
        else "VIOLATED"}

    if args.kill_replica_at >= 0:
        okd, totd = report["ok_by_decile"], report["total_by_decile"]
        first = okd[0] / totd[0] if totd[0] else 1.0
        last = okd[9] / totd[9] if totd[9] else 0.0
        ratio = last / first if first > 0 else 1.0
        report["follower_reads"]["qps_recovery_ratio"] = round(ratio, 4)
        obj["qps_recovery"] = {
            "target": args.qps_recovery_min, "measured": round(ratio, 4),
            "verdict": ("OK" if ratio >= args.qps_recovery_min
                        else "VIOLATED")}

    bad = [k for k in ("read_availability", "staleness",
                       "cache_hit_rate", "qps_recovery")
           if obj.get(k, {}).get("verdict") == "VIOLATED"]
    if bad:
        report["verdict"] = "VIOLATED"
    log(f"follower-reads: 5xx={read_5xx} hit_rate={hit_rate:.3f} "
        f"(ceiling {ceiling:.3f}) stale={stale_served:g} "
        f"-> {'VIOLATED: ' + ','.join(bad) if bad else 'OK'}")


def _judge_watchdog(report: Dict[str, Any], transport, args,
                    log) -> None:
    """Post-run verdict for a --fault spec with a `watchdog.stall` rule:
    the injected hang (a delay wedging a registered loop) must have been
    detected (/debug/health counts at least one watchdog trip) and the
    node must have recovered once the delay cleared (no subsystem still
    stalled at the run's end). Serving stayed alive throughout: the
    run's own requests show it (availability is judged apart)."""
    # Recovery needs one watchdog sweep after the injected delay
    # clears: poll briefly instead of racing the sweep cadence.
    deadline = time.monotonic() + 10.0
    doc: Dict[str, Any] = {}
    while True:
        doc = transport.get_json("/debug/health") or {}
        if int(doc.get("trips_total", 0)) > 0 \
                and not doc.get("stalled"):
            break
        if time.monotonic() >= deadline:
            break
        time.sleep(0.25)
    trips = int(doc.get("trips_total", 0))
    still_stalled = list(doc.get("stalled") or [])
    detected = trips > 0
    recovered = not still_stalled
    obj = report["objectives"]
    obj["watchdog_detection"] = {
        "target": ">=1 trip", "measured": trips,
        "verdict": "OK" if detected else "VIOLATED"}
    obj["watchdog_recovery"] = {
        "target": "no stalled subsystem at run end",
        "measured": still_stalled,
        "verdict": "OK" if recovered else "VIOLATED"}
    report["watchdog"] = {
        "trips_total": trips,
        "stalled_at_end": still_stalled,
        "watchdog_alive": bool(doc.get("watchdog_alive")),
    }
    if not (detected and recovered):
        report["verdict"] = "VIOLATED"
    log(f"watchdog: trips={trips} stalled_at_end="
        f"{still_stalled or 'none'} -> "
        f"{'OK' if detected and recovered else 'VIOLATED'}")


def _judge_cost_skew(report: Dict[str, Any], transport,
                     spec: Dict[str, Any], args, log) -> None:
    """Post-run verdict for --cost-skew (a whale and minnows):

    - attribution: the whale's share of the device_us attributed in
      /debug/costs matches its share of the schedule within
      --cost-share-tol (tenant and op picks are independent, so its
      share of queries is its share of device time);
    - debt: every X-Pilosa-Cost-Debt sighting was on a whale's answer
      (a minnow with debt means attribution leaked across accounts)."""
    counts: Dict[str, int] = {}
    for e in build_schedule(spec):
        if e["phase"] == "run":
            counts[e["tenant"]] = counts.get(e["tenant"], 0) + 1
    total_q = sum(counts.values())
    whale = max(counts, key=lambda t: counts[t]) if counts else ""
    sched_share = counts.get(whale, 0) / total_q if total_q else 0.0

    doc = transport.get_json("/debug/costs?sort=device_us&limit=200") \
        or {}
    dev_by_tenant: Dict[str, float] = {}
    for row in doc.get("accounts") or []:
        t = row.get("tenant", "")
        dev_by_tenant[t] = dev_by_tenant.get(t, 0.0) \
            + float(row.get("device_us", 0.0))
    total_dev = sum(dev_by_tenant.values())
    measured = dev_by_tenant.get(whale, 0.0) / total_dev \
        if total_dev > 0 else 0.0

    debt = dict(getattr(transport, "debt_by_tenant", {}))
    strays = sorted(t for t in debt if t != whale)

    tol = float(args.cost_share_tol)
    ok_share = total_dev > 0 and abs(measured - sched_share) <= tol
    ok_debt = not strays

    report["cost_skew"] = {
        "whale": whale,
        "scheduled_share": round(sched_share, 4),
        "device_us_share": round(measured, 4),
        "device_us_by_tenant": {t: round(v, 1)
                                for t, v in sorted(
                                    dev_by_tenant.items())},
        "debt_headers": debt,
        "debt_strays": strays,
    }
    obj = report["objectives"]
    obj["cost_attribution"] = {
        "target": round(sched_share, 4),
        "measured": round(measured, 4),
        "verdict": "OK" if ok_share else "VIOLATED"}
    obj["cost_debt"] = {
        "target": 0, "measured": len(strays),
        "verdict": "OK" if ok_debt else "VIOLATED"}
    if not (ok_share and ok_debt):
        report["verdict"] = "VIOLATED"
    log(f"cost-skew: whale={whale} share {measured:.3f} "
        f"(scheduled {sched_share:.3f}, tol {tol}) "
        f"debt={sum(debt.values())} strays={strays or 'none'} "
        f"-> {'OK' if ok_share and ok_debt else 'VIOLATED'}")


def prepare_index(host: str, index: str, frame: str, log,
                  mix: str = "", columns: int = 1 << 16,
                  seed: int = 1) -> None:
    """Create the index and the frame over HTTP (a 409, already there,
    is fine). When the mix has bsi ops the frame is created with the
    integer field, and deterministic SetValues seed it, so Sum and
    Range aggregate real data rather than empty planes."""
    bsi = any(op.startswith("bsi_") for op, _ in parse_mix(mix)) \
        if mix else False
    frame_opts: Dict[str, Any] = {"timeQuantum": "YMD"}
    if bsi:
        frame_opts["fields"] = [
            {"name": BSI_FIELD, "min": BSI_MIN, "max": BSI_MAX}]
    for path, body in ((f"/index/{index}", b"{}"),
                       (f"/index/{index}/frame/{frame}",
                        json.dumps({"options": frame_opts}).encode())):
        req = urllib.request.Request("http://" + host + path, data=body,
                                     method="POST")
        try:
            urllib.request.urlopen(req, timeout=10).read()
        except urllib.error.HTTPError as e:
            e.read()
            if e.code != 409:
                log(f"setup {path}: HTTP {e.code}")
    if not bsi:
        return
    # Seed values over a deterministic column subset (same seed, same
    # data); chunked multi-call PQL bodies keep setup round-trips low.
    rng = random.Random(seed)
    n = min(BSI_SEED_COLUMNS, columns)
    calls = [f"SetValue(frame={frame}, columnID={c}, "
             f"{BSI_FIELD}={rng.randrange(BSI_MIN, BSI_MAX + 1)})"
             for c in sorted(rng.sample(range(columns), n))]
    for k in range(0, len(calls), 64):
        req = urllib.request.Request(
            "http://" + host + f"/index/{index}/query",
            data="".join(calls[k:k + 64]).encode(), method="POST")
        try:
            urllib.request.urlopen(req, timeout=30).read()
        except urllib.error.HTTPError as e:
            e.read()
            log(f"bsi seed: HTTP {e.code}")


# -- CLI -------------------------------------------------------------------


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pilosa-tpu-torch loadgen",
        description="seeded deterministic load generation with SLO "
                    "verdicts")
    p.add_argument("--host", default="127.0.0.1:10101",
                   help="target node (host:port)")
    p.add_argument("--in-process", action="store_true",
                   help="boot a throwaway one-node server to target "
                        "(on the card unless $PILOSA_TORCH_USE_DEVICE "
                        "is off)")
    p.add_argument("--index", default="loadgen")
    p.add_argument("--frame", default="f")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--duration", type=float, default=10.0,
                   help="run seconds (schedule span, not wall bound)")
    p.add_argument("--qps", type=float, default=100.0,
                   help="offered rate (modulated by --burst)")
    p.add_argument("--warmup", type=float, default=0.0,
                   help="warmup seconds sent before t=0, not judged")
    p.add_argument("--mode", choices=("open", "closed"),
                   default="closed")
    p.add_argument("--concurrency", type=int, default=4)
    p.add_argument("--tenants", default="gold,silver,bronze",
                   help="comma list; zipf-skewed in this order")
    p.add_argument("--zipf-s", type=float, default=1.1,
                   help="zipf exponent for tenant + row skew")
    p.add_argument("--rows", type=int, default=64)
    p.add_argument("--columns", type=int, default=1 << 16)
    p.add_argument("--mix", default=DEFAULT_MIX)
    p.add_argument("--burst", choices=("none", "diurnal", "spike"),
                   default="none")
    p.add_argument("--partial", action="store_true",
                   help="send ?partial=true (graceful degradation)")
    p.add_argument("--deadline", default="",
                   help='per-query deadline (Go duration, e.g. "50ms")')
    p.add_argument("--staleness-ms", type=float, default=0.0,
                   help="send X-Pilosa-Staleness on every request "
                        "(bounded-staleness follower reads) and judge "
                        "them")
    p.add_argument("--qps-recovery-min", type=float, default=0.5,
                   help="churn runs: final-decile ok-rate must recover "
                        "to this fraction of the first decile's")
    p.add_argument("--cost-skew", action="store_true",
                   help="arm the cost-attribution judge: the heaviest "
                        "tenant's /debug/costs device_us share must "
                        "match its schedule share, and the "
                        "X-Pilosa-Cost-Debt header must stamp that "
                        "tenant only")
    p.add_argument("--cost-share-tol", type=float, default=0.25,
                   help="absolute tolerance on the whale's device_us "
                        "share vs its scheduled share")
    p.add_argument("--availability", type=float, default=99.9)
    p.add_argument("--p99-us", type=float, default=50_000.0)
    p.add_argument("--latency-target", type=float, default=99.0)
    p.add_argument("--shed-rate-max", type=float, default=0.05)
    p.add_argument("--fault", default="",
                   help="fault.py spec armed mid-run in the "
                        "server (--in-process only)")
    p.add_argument("--fault-at", type=float, default=0.25,
                   help="arm --fault at this fraction of the run")
    p.add_argument("--cluster-nodes", type=int, default=0,
                   help="boot an N-node in-process cluster instead of "
                        "a single node (implies --in-process)")
    p.add_argument("--cluster-replicas", type=int, default=3,
                   help="replica_n for --cluster-nodes")
    p.add_argument("--kill-replica-at", type=float, default=-1.0,
                   help="close one (non-coordinator) replica at this "
                        "fraction of the run (cluster mode)")
    p.add_argument("--restart-replica-at", type=float, default=-1.0,
                   help="restart the killed replica at this fraction "
                        "of the run, on the same data dir")
    p.add_argument("--hint-backlog-max", type=int, default=0,
                   help="max hint records left after the post-run "
                        "drain window (judged)")
    p.add_argument("--report", default="",
                   help="report path (default LOADGEN_<seed>.json)")
    p.add_argument("--print-schedule", action="store_true",
                   help="dump the request schedule as JSON and exit 0 "
                        "(the determinism probe)")
    p.add_argument("--quiet", action="store_true")
    return p


def spec_from_args(args) -> Dict[str, Any]:
    return {
        "seed": args.seed,
        "duration": args.duration,
        "qps": args.qps,
        "warmup": args.warmup,
        "mode": args.mode,
        "concurrency": args.concurrency,
        "tenants": [t.strip() for t in args.tenants.split(",")
                    if t.strip()],
        "zipf_s": args.zipf_s,
        "rows": args.rows,
        "columns": args.columns,
        "mix": args.mix,
        "burst": args.burst,
        "frame": args.frame,
        "fault_at": args.fault_at,
        "staleness_ms": args.staleness_ms,
        "cost_skew": args.cost_skew,
        "objectives": {
            "availability": args.availability,
            "p99_us": args.p99_us,
            "latency_target": args.latency_target,
            "shed_rate_max": args.shed_rate_max,
        },
    }


def main(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    log = (lambda s: None) if args.quiet else \
        (lambda s: print(f"loadgen: {s}", file=sys.stderr))
    spec = spec_from_args(args)

    if args.print_schedule:
        for entry in build_schedule(spec):
            sys.stdout.write(json.dumps(entry, sort_keys=True) + "\n")
        return 0

    from .. import fault

    srv = None
    servers: list = []
    configs: list = []
    churn_state: Dict[str, Any] = {}
    churn_thread = None
    host = args.host
    if args.cluster_nodes > 0:
        servers, configs, hosts = start_inprocess_cluster(
            spec, args.cluster_nodes, args.cluster_replicas, log)
        host = hosts[0]
        if args.kill_replica_at >= 0:
            churn_thread = threading.Thread(
                target=run_replica_churn,
                args=(servers, configs, args.duration,
                      args.kill_replica_at, args.restart_replica_at,
                      log, churn_state),
                daemon=True)
    elif args.in_process:
        srv, host = start_inprocess(
            spec, log,
            watchdog_drill="watchdog.stall" in (args.fault or ""))
    transport = HTTPTransport(host, index=args.index, partial=args.partial,
                              deadline=args.deadline,
                              staleness_ms=args.staleness_ms)

    fault_cb = None
    fault_rules: list = []
    if args.fault:
        if not (args.in_process or args.cluster_nodes > 0):
            log("--fault requires --in-process or --cluster-nodes (seams "
                "live in the server process); ignoring")
        else:
            def fault_cb():
                fault_rules.extend(fault.load_spec(args.fault))

    try:
        prepare_index(host, args.index, args.frame, log,
                      mix=args.mix, columns=args.columns,
                      seed=args.seed)
        mm0 = _mismatch_total(transport.get_text("/metrics"))
        n = len(build_schedule(spec))
        log(f"running {n} requests over ~{args.duration:.0f}s "
            f"({args.mode}-loop, seed {args.seed})")
        if churn_thread is not None:
            churn_thread.start()
        report = run(dict(spec), transport, log=log, fault_cb=fault_cb)
        if churn_thread is not None:
            churn_thread.join(timeout=max(30.0, args.duration))
        if servers:
            _judge_write_churn(report, servers, configs, churn_state,
                               args, log)
        if args.staleness_ms > 0:
            _judge_follower_reads(report, transport, spec, args, log)
        if args.cost_skew:
            _judge_cost_skew(report, transport, spec, args, log)
        if fault_rules and "watchdog.stall" in (args.fault or ""):
            _judge_watchdog(report, transport, args, log)
        mm1 = _mismatch_total(transport.get_text("/metrics"))
        growth = max(0.0, mm1 - mm0)
        report["mismatch_growth"] = growth
        report["objectives"]["correctness"]["measured"] = growth
        if growth > 0:
            report["objectives"]["correctness"]["verdict"] = "VIOLATED"
            report["verdict"] = "VIOLATED"
        server_slo = transport.get_json("/debug/slo")
        if server_slo is not None:
            # The server's own judgment rides along, so the report and
            # the pilosa_slo_* families can be cross-checked.
            report["server_slo"] = {
                "verdict": server_slo.get("verdict"),
                "objectives": {
                    k: {"budget_remaining": v.get("budget_remaining"),
                        "fastest_burn": v.get("fastest_burn"),
                        "verdict": v.get("verdict")}
                    for k, v in server_slo.get("objectives",
                                               {}).items()},
            }
        if fault_rules:
            report["faults_fired"] = len(fault.log())
            fault.reset()
    finally:
        if srv is not None:
            srv.close()
        for s in servers:
            try:
                s.close()
            except Exception:  # noqa: BLE001 — the victim, closed
                pass

    path = args.report or f"LOADGEN_{args.seed}.json"
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    log(f"report -> {path}")
    log(f"verdict: {report['verdict']} "
        f"(qps {report['achieved_qps']}, shed {report['shed_rate']}, "
        f"error {report['error_rate']}, mismatches "
        f"{report['mismatch_growth']})")
    return 0 if report["verdict"] == "OK" else 1


if __name__ == "__main__":
    sys.exit(main())
