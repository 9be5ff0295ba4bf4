"""`python -m pilosa_tpu_torch.ctl` (the `pilosa-tpu-torch` script) — run
a node, and bulk data in and out of one.

    server    run a node from a TOML config (server.Server): flags over
              $PILOSA_TORCH_HOST / _DATA_DIR / _USE_DEVICE over the TOML
              over the defaults (build_config); --dry-run prints the
              resolved config and imports no torch; SIGTERM or SIGINT
              closes the node and exits 0
    bench     set-bit / intersect-count / topn against a live node: one
              JSON line {"op", "n", "seconds", "ops_per_sec"}
    check     offline consistency check of fragment data files (exit 1
              on any error)
    inspect   per-container stats of a data file, as JSON
    sort      an import CSV in fragment order: by (slice, position)
    config    print the default TOML config
    import    CSV lines `row,col[,YYYY-MM-DDTHH:MM]` -> POST /import, one
              protobuf request a slice, buffered by --buffer-size bits
              (--create makes the index and the frame first)
    export    a frame's view -> `row,col` lines (-o FILE, default stdout)
    backup    a frame's view -> a tar with one `slice.N` member a
              fragment, each the fragment's own data + cache tar
    restore   such a tar -> the node, fragment by fragment

    top       one screen from two /metrics scrapes: QPS, routes, phase
              percentiles, roofline, scheduler, HBM, integrity, SLO
              budgets (-n scrapes, --interval seconds)
    costs     the cost ledger's panel from /debug/costs (--sort, --limit)
    health    the liveness panel from /debug/health and /readyz
    diagnose  GET /debug/bundle, the dossier, to -o FILE (--write also
              keeps a copy under the node's <data-dir>/.dossier/)

The flags are the JAX package's (`pilosa_tpu/ctl/main.py`); --host
defaults to $PILOSA_TORCH_HOST, else localhost:10101. The JAX ctl's
fleet and loadgen wait for ROADMAP A9b. Every batch of an
import goes to --host: a node with no cluster owns every slice. A CSV
time is read as local time (`datetime.strptime(...).timestamp()`), as
the JAX ctl reads it, and travels as seconds since the epoch.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import signal
import sys
import tarfile
import threading
import time
from datetime import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import SLICE_WIDTH
from ..config import Config

# Import CSV timestamp layout.
TIME_FORMAT = "%Y-%m-%dT%H:%M"

# Bits buffered per import flush.
DEFAULT_IMPORT_BUFFER = 1_000_000


def _parse(lines, seen: Dict[str, int]) -> Tuple[list, list, list]:
    """Rows, columns and unix times (0: none) of CSV lines. `seen`
    memoizes each distinct time string's parse."""
    rows, cols, tss = [], [], []
    for lineno, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        parts = line.split(",")
        if len(parts) < 2:
            raise ValueError(f"line {lineno}: bad row: {line!r}")
        ts = 0
        if len(parts) > 2 and parts[2].strip():
            raw = parts[2].strip()
            ts = seen.get(raw)
            if ts is None:
                ts = seen[raw] = int(datetime.strptime(
                    raw, TIME_FORMAT).timestamp())
        rows.append(int(parts[0]))
        cols.append(int(parts[1]))
        tss.append(ts)
    return rows, cols, tss


def parse_import_rows(lines) -> List[Tuple[int, int, int]]:
    """CSV lines -> (rowID, columnID, unix time or 0)."""
    return list(zip(*_parse(lines, {})))


def _env(name: str, default=None):
    return os.environ.get("PILOSA_TORCH_" + name.upper().replace("-", "_"),
                          default)


def build_config(args) -> Config:
    """flags > env > TOML > defaults."""
    cfg = Config.from_toml(args.config) if getattr(args, "config", None) \
        else Config()
    env_host = _env("host")
    if env_host:
        cfg.host = env_host
    env_dir = _env("data_dir")
    if env_dir:
        cfg.data_dir = env_dir
    if getattr(args, "data_dir", None):
        cfg.data_dir = args.data_dir
    if getattr(args, "bind", None):
        cfg.host = args.bind
        if cfg.cluster_hosts == [Config().host]:
            cfg.cluster_hosts = [args.bind]
    if getattr(args, "hosts", None):
        cfg.cluster_hosts = [h.strip() for h in args.hosts.split(",")]
    if getattr(args, "replicas", None):
        cfg.replica_n = args.replicas
    env_dev = _env("use_device")
    if env_dev:
        cfg.use_device = env_dev
    if getattr(args, "use_device", None):
        cfg.use_device = args.use_device
    return cfg


# ---- server ------------------------------------------------------------------

def cmd_server(args) -> int:
    cfg = build_config(args)
    if args.dry_run:
        # The resolved config, before anything imports torch.
        sys.stdout.write(cfg.to_toml())
        return 0
    from ..obs import log as obs_log
    from ..server import Server

    # Destination: --log-path > [log] path > top-level log-path > stderr.
    obs_log.setup(level=cfg.log_level, fmt=cfg.log_format,
                  path=args.log_path or cfg.log_file or cfg.log_path)
    srv = Server(cfg)
    srv.open()
    print(f"pilosa-tpu-torch listening on http://{srv.host} "
          f"(data: {cfg.expanded_data_dir()}, device: {cfg.device()})",
          flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    try:
        stop.wait()
    finally:
        srv.close()
    return 0


# ---- bench -------------------------------------------------------------------

def cmd_bench(args) -> int:
    """Micro-bench against a live node: set-bit (n random SetBits),
    intersect-count (n Counts of the intersection of rows 1 and 2, each
    seeded with 1,000 random columns) or topn (n TopN(n=100) over 32
    rows seeded with 10 + 30 r columns). Seeded with 1, as the JAX ctl."""
    import random

    client = _client(args)
    client.create_index(args.index)
    client.create_frame(args.index, args.frame)
    rng = random.Random(1)

    def seed_row(row_id: int, k: int):
        cols = rng.sample(range(args.max_column_id),
                          k=min(k, args.max_column_id))
        client.execute_query(args.index, "".join(
            f"SetBit({args.row_label}={row_id}, frame='{args.frame}',"
            f" {args.column_label}={c})" for c in cols))

    def timed_queries(q: str) -> float:
        t0 = time.perf_counter()
        for _ in range(args.n):
            client.execute_query(args.index, q)
        return time.perf_counter() - t0

    if args.op == "set-bit":
        t0 = time.perf_counter()
        for _ in range(args.n):
            client.execute_query(args.index, (
                f"SetBit({args.row_label}={rng.randrange(args.max_row_id)},"
                f" frame='{args.frame}',"
                f" {args.column_label}={rng.randrange(args.max_column_id)})"))
        dt = time.perf_counter() - t0
    elif args.op == "intersect-count":
        for r in (1, 2):
            seed_row(r, 1000)
        dt = timed_queries(
            f"Count(Intersect(Bitmap({args.row_label}=1, "
            f"frame='{args.frame}'), Bitmap({args.row_label}=2, "
            f"frame='{args.frame}')))")
    else:  # topn
        for r in range(min(args.max_row_id, 32)):
            seed_row(r, 10 + 30 * r)
        dt = timed_queries(f"TopN(frame='{args.frame}', n=100)")
    print(json.dumps({"op": args.op, "n": args.n, "seconds": round(dt, 4),
                      "ops_per_sec": round(args.n / dt, 2)}))
    return 0


# ---- offline file tools ------------------------------------------------------

def cmd_check(args) -> int:
    """Parse each data file (read_bitmap with its defaults) and print
    `path: ok (N bits)` or its errors; 1 if any file failed."""
    from ..roaring.serialize import read_bitmap

    rc = 0
    for path in args.paths:
        try:
            with open(path, "rb") as f:
                b = read_bitmap(f.read())
            errs = b.check()
            if errs:
                rc = 1
                for e in errs:
                    print(f"{path}: {e}")
            else:
                print(f"{path}: ok ({b.count()} bits)")
        except Exception as e:  # noqa: BLE001 — report and continue
            rc = 1
            print(f"{path}: {e}")
    return rc


def cmd_inspect(args) -> int:
    from ..roaring.serialize import read_bitmap

    with open(args.path, "rb") as f:
        b = read_bitmap(f.read())
    print(json.dumps(b.info(), indent=2))
    return 0


def cmd_sort(args) -> int:
    """An import CSV in fragment order, by (slice, row * SLICE_WIDTH +
    column % SLICE_WIDTH); times keep the CSV format."""
    with (sys.stdin if args.path == "-" else open(args.path)) as f:
        rows = parse_import_rows(f)
    rows.sort(key=lambda rc: (rc[1] // SLICE_WIDTH,
                              rc[0] * SLICE_WIDTH + rc[1] % SLICE_WIDTH))
    out = sys.stdout
    for r, c, ts in rows:
        if ts:
            stamp = datetime.fromtimestamp(ts).strftime(TIME_FORMAT)
            out.write(f"{r},{c},{stamp}\n")
        else:
            out.write(f"{r},{c}\n")
    return 0


def cmd_config(args) -> int:
    print(Config().to_toml(), end="")
    return 0


def _client(args):
    from ..api.client import InternalClient

    return InternalClient(args.host)


def _flush(client, args, rows: np.ndarray, cols: np.ndarray,
           tss: np.ndarray) -> None:
    """One import request a slice, its bits sorted by (row, col, time)."""
    slices = cols // np.uint64(SLICE_WIDTH)
    order = np.lexsort((tss, cols, rows, slices))
    rows, cols, tss, slices = rows[order], cols[order], tss[order], \
        slices[order]
    uniq, starts = np.unique(slices, return_index=True)
    ends = list(starts[1:]) + [len(slices)]
    for s, a, b in zip(uniq.tolist(), starts.tolist(), ends):
        ts = tss[a:b]
        client.import_bits(args.index, args.frame, s, rows[a:b], cols[a:b],
                           ts if ts.any() else None)
        print(f"imported {b - a} bits into slice {s} (via {args.host})",
              file=sys.stderr)


def cmd_import(args) -> int:
    client = _client(args)
    if args.create:
        client.create_index(args.index)
        client.create_frame(args.index, args.frame)
    seen: Dict[str, int] = {}
    buf: Tuple[list, list, list] = ([], [], [])

    def flush():
        _flush(client, args, np.asarray(buf[0], dtype=np.uint64),
               np.asarray(buf[1], dtype=np.uint64),
               np.asarray(buf[2], dtype=np.int64))
        for part in buf:
            part.clear()

    for path in args.paths:
        f = sys.stdin if path == "-" else open(path)
        try:
            for chunk in iter(lambda: f.readlines(1 << 20), []):
                for part, new in zip(buf, _parse(chunk, seen)):
                    part.extend(new)
                if len(buf[0]) >= args.buffer_size:
                    flush()
        finally:
            if f is not sys.stdin:
                f.close()
    if buf[0]:
        flush()
    return 0


def cmd_export(args) -> int:
    from ..api.client import ClientError

    client = _client(args)
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        max_slice = client.max_slices().get(args.index, 0)
        for s in range(max_slice + 1):
            try:
                out.write(client.export_csv(args.index, args.frame,
                                            args.view, s))
            except ClientError:  # a slice without this fragment
                continue
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_backup(args) -> int:
    """A tar with one `slice.N` member per fragment of the view, each the
    fragment's own data + cache tar."""
    client = _client(args)
    inverse = args.view.startswith("inverse")
    max_slice = client.max_slices(inverse=inverse).get(args.index, 0)
    n = 0
    with tarfile.open(args.output, "w") as tf:
        for s in range(max_slice + 1):
            data = client.fragment_data(args.index, args.frame, args.view, s)
            if data is None:
                continue
            info = tarfile.TarInfo(name=f"slice.{s}")
            info.size = len(data)
            info.mtime = int(time.time())
            tf.addfile(info, io.BytesIO(data))
            n += 1
    print(f"backed up {n} fragment(s) to {args.output}", file=sys.stderr)
    return 0


def cmd_restore(args) -> int:
    client = _client(args)
    n = 0
    with tarfile.open(args.input, "r") as tf:
        for member in tf.getmembers():
            if not member.name.startswith("slice."):
                raise ValueError(f"unexpected archive member: {member.name}")
            slice_ = int(member.name.split(".", 1)[1])
            client.restore_fragment(args.index, args.frame, args.view,
                                    slice_, tf.extractfile(member).read())
            n += 1
    print(f"restored {n} fragment(s) from {args.input}", file=sys.stderr)
    return 0


# -- the panels over a node's stores (top, costs, health, diagnose) ----------

# Sample-name suffixes whose values are cumulative: a duplicate line of
# one (the same family emitted twice) sums instead of replacing.
CUMULATIVE_SUFFIXES = ("_total", "_bucket", "_count", "_sum")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_SAMPLE_RE = re.compile(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)"
                        r"(?:\s+#.*)?$")


def _parse_prom(text: str) -> dict:
    """Prometheus 0.0.4 text -> {(name, ((label, value), ...)): float},
    labels sorted. Comments, exemplar suffixes and malformed lines are
    passed over (a panel must survive a garbled scrape); duplicate
    samples of a cumulative family sum, a gauge's last one wins (the JAX
    package's obs/fleet.parse_text)."""
    out: dict = {}
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
        if key in out and name.endswith(CUMULATIVE_SUFFIXES):
            out[key] += v
        else:
            out[key] = v
    return out


def _hist_percentiles(metrics: dict, name: str, fixed: dict):
    """(p50, p95, p99, count) from `name`_bucket samples whose labels
    include `fixed`: the smallest le whose cumulative count covers each
    quantile; series the fixed labels leave open sum per le."""
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


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TiB"


def _fmt_us(us: float) -> str:
    if us == float("inf"):
        return "inf"
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.1f}ms"
    return f"{us:.0f}us"


def render_top(host: str, cur: dict, prev: dict, dt: float) -> str:
    """One screenful from two consecutive /metrics scrapes. Pure —
    tests feed it canned scrapes."""
    lines = [f"pilosa-tpu-torch top — {host}"]

    up = cur.get(("pilosa_uptime_seconds", ()), 0.0)
    qtot = cur.get(("pilosa_query_us_count", ()), 0.0)
    qprev = prev.get(("pilosa_query_us_count", ()), 0.0) if prev else 0.0
    qps = (qtot - qprev) / dt if prev and dt > 0 else 0.0
    lines.append(f"uptime {up:.0f}s   queries {int(qtot)}   "
                 f"qps {qps:.1f}")

    # Route panel (pilosa_query_route_total{backend,tier}): per-backend
    # QPS over the scrape interval, with the BSI aggregation path
    # (bsi-mesh device / bsi-host fold) summed into one "aggregate qps"
    # figure, plus the locality-tier split (local chip / pod ICI
    # collective / cross-node HTTP).
    by_backend: dict = {}
    by_tier: dict = {}
    for (name, labels), v in sorted(cur.items()):
        if name != "pilosa_query_route_total":
            continue
        d = dict(labels)
        b = d.get("backend", "")
        by_backend[b] = by_backend.get(b, 0.0) + v
        t = d.get("tier", "local")
        by_tier[t] = by_tier.get(t, 0.0) + v
    if by_backend:
        def _route_prev(backend: str) -> float:
            if not prev:
                return 0.0
            # Sum across tier series (and tolerate pre-tier scrapes
            # whose series carry only the backend label).
            return sum(v for (name, labels), v in prev.items()
                       if name == "pilosa_query_route_total"
                       and dict(labels).get("backend", "") == backend)

        def _route_rate(backend: str, v: float) -> float:
            pv = _route_prev(backend)
            return (v - pv) / dt if prev and dt > 0 else 0.0
        routes = sorted(by_backend.items())
        lines.append("routes: " + "  ".join(
            f"{b}={int(v)} ({_route_rate(b, v):.1f}/s)"
            for b, v in routes))
        agg = [(b, v) for b, v in routes if b.startswith("bsi-")]
        if agg:
            lines.append(
                f"aggregates: qps "
                f"{sum(_route_rate(b, v) for b, v in agg):.1f}   "
                + "  ".join(f"{b}={int(v)}" for b, v in agg))
        if by_tier:
            lines.append("tiers:  " + "  ".join(
                f"{t}={int(by_tier.get(t, 0.0))}"
                for t in ("local", "ici", "http") if t in by_tier))

    # Per-phase measured percentiles (pilosa_query_phase_us{phase,
    # backend}) — only present once something has been profiled.
    pairs = sorted({(dict(labels).get("phase", ""),
                     dict(labels).get("backend", ""))
                    for (name, labels) in cur
                    if name == "pilosa_query_phase_us_bucket"})
    if pairs:
        lines.append("")
        lines.append(f"{'phase':<16}{'backend':<10}{'p50':>9}"
                     f"{'p95':>9}{'p99':>9}{'count':>8}")
        for phase, backend in pairs:
            pct = _hist_percentiles(cur, "pilosa_query_phase_us",
                                    {"phase": phase, "backend": backend})
            if pct is None:
                continue
            p50, p95, p99, n = pct
            lines.append(f"{phase:<16}{backend:<10}{_fmt_us(p50):>9}"
                         f"{_fmt_us(p95):>9}{_fmt_us(p99):>9}{n:>8}")
    else:
        lines.append("(no profiled queries yet — POST ?profile=true or "
                     "set [obs] profile-sample-rate)")

    roofs = [(dict(labels).get("backend", ""), v)
             for (name, labels), v in sorted(cur.items())
             if name == "pilosa_roofline_fraction"]
    if roofs:
        lines.append("")
        for backend, frac in roofs:
            bps = cur.get(("pilosa_roofline_bytes_per_second",
                           (("backend", backend),)), 0.0)
            lines.append(f"roofline {backend}: {frac:.3f} of peak "
                         f"({_fmt_bytes(bps)}/s)")

    # Scheduler panel (pilosa_sched_* — only present when [sched] is
    # enabled): live queue depth, shed rate over the scrape interval,
    # and the coalesced-cohort size distribution.
    depth = cur.get(("pilosa_sched_queue_depth", (("tenant", "all"),)))
    if depth is not None:
        shed_cur = sum(v for (name, _), v in cur.items()
                       if name == "pilosa_sched_shed_total")
        shed_prev = sum(v for (name, _), v in prev.items()
                        if name == "pilosa_sched_shed_total") if prev else 0.0
        shed_rate = ((shed_cur - shed_prev) / dt
                     if prev and dt > 0 else 0.0)
        line = (f"sched: queue {int(depth)}   shed {int(shed_cur)} "
                f"({shed_rate:.1f}/s)")
        pct = _hist_percentiles(cur, "pilosa_sched_batch_size", {})
        if pct is not None and pct[3] > 0:
            p50, p95, _, n_b = pct
            line += (f"   batch p50 {p50:.0f} p95 {p95:.0f} "
                     f"({n_b} cohorts)")
        lines.append("")
        lines.append(line)

    # Membership panel (pilosa_member_state{host,state} + migration
    # gauges): per-state node counts and, mid-resize, the live
    # transfer picture — join/leave progress at a glance.
    members = [(dict(labels).get("host", ""),
                dict(labels).get("state", "?"))
               for (name, labels), v in sorted(cur.items())
               if name == "pilosa_member_state"]
    if members:
        by_state: dict = {}
        for _, st in members:
            by_state[st] = by_state.get(st, 0) + 1
        line = "members: " + "  ".join(
            f"{st}={n_m}" for st, n_m in sorted(by_state.items()))
        inflight = cur.get(("pilosa_migrations_in_flight", ()))
        if inflight:
            mbytes = cur.get(("pilosa_migration_bytes_total", ()), 0.0)
            line += (f"   migrating {int(inflight)} "
                     f"({_fmt_bytes(mbytes)} moved)")
        handoff = cur.get(("pilosa_handoff_slices", ()), 0.0)
        if handoff:
            line += f"   handoff {int(handoff)} slice(s)"
        lines.append(line)

    brk = [(dict(labels).get("host", ""), v)
           for (name, labels), v in sorted(cur.items())
           if name == "pilosa_breaker_state"]
    if brk:
        state_names = {0: "closed", 1: "half-open", 2: "open"}
        lines.append("breakers: " + "  ".join(
            f"{h}={state_names.get(int(v), '?')}" for h, v in brk))

    # Hinted-handoff panel: queued/replayed/dropped totals plus live
    # backlog bytes per target. Healthy steady state reads
    # queued == replayed with no backlog; a growing backlog names the
    # target that needs attention (README runbook).
    hq = sum(v for (name, _labels), v in cur.items()
             if name == "pilosa_hints_queued_total")
    hr = sum(v for (name, _labels), v in cur.items()
             if name == "pilosa_hints_replayed_total")
    hd = sum(v for (name, _labels), v in cur.items()
             if name == "pilosa_hints_dropped_total")
    backlog = [(dict(labels).get("target", ""), v)
               for (name, labels), v in sorted(cur.items())
               if name == "pilosa_hint_bytes" and v > 0]
    if hq or hr or hd or backlog:
        line = f"hints: queued {int(hq)}   replayed {int(hr)}"
        if hd:
            line += f"   dropped {int(hd)}"
        if backlog:
            line += "   backlog " + "  ".join(
                f"{t}={_fmt_bytes(v)}" for t, v in backlog[:6])
        lines.append(line)

    hbm = [(dict(labels).get("device", ""), v)
           for (name, labels), v in sorted(cur.items())
           if name == "pilosa_hbm_resident_bytes"]
    if hbm:
        total = sum(v for _, v in hbm)
        line = (f"hbm resident: {_fmt_bytes(total)} across "
                f"{len(hbm)} device(s)  " + "  ".join(
                    f"{d}={_fmt_bytes(v)}" for d, v in hbm[:8]))
        budget = cur.get(("pilosa_hbm_budget_bytes", ()), 0.0)
        if budget:
            line += f"   budget {_fmt_bytes(budget)}"
        res = cur.get(("pilosa_hbm_residency_ratio", ()))
        if res is not None:
            line += f"   residency {res:.0%}"
        sparse = cur.get(("pilosa_hbm_sparse_bytes", ()), 0.0)
        if sparse:
            line += f"   sparse {_fmt_bytes(sparse)}"
        ev = sum(v for (name, _labels), v in cur.items()
                 if name == "pilosa_hbm_evictions_total")
        if ev:
            line += f"   evictions {int(ev)}"
        quar = cur.get(("pilosa_plan_quarantined_total", ()), 0.0)
        if quar:
            line += f"   quarantined plans {int(quar)}"
        lines.append(line)

    # Integrity panel: scrubber progress + corruption/repair tallies +
    # shadow verification. Mismatches > 0 is the wake-someone line.
    sfrag = cur.get(("pilosa_scrub_fragments_total", ()), 0.0)
    corrupt = cur.get(("pilosa_integrity_corrupt_total", ()), 0.0)
    mism = sum(v for (name, _labels), v in cur.items()
               if name == "pilosa_shadow_mismatch_total")
    if sfrag or corrupt or mism:
        line = f"integrity: scrubbed {int(sfrag)}"
        age = cur.get(("pilosa_scrub_last_age_seconds", ()))
        if age is not None:
            line += f" (oldest {age:.0f}s ago)"
        reps = cur.get(("pilosa_scrub_repairs_total", ()), 0.0)
        line += f"   corrupt {int(corrupt)}   repairs {int(reps)}"
        checks = sum(v for (name, _labels), v in cur.items()
                     if name == "pilosa_shadow_checks_total")
        if checks or mism:
            line += f"   shadow {int(checks)} checks"
            if mism:
                line += f" / {int(mism)} MISMATCH"
        lines.append(line)

    # SLO panel (pilosa_slo_* — [slo] objectives): per-objective error
    # budget remaining over the accounting window plus the fastest
    # burn rate across windows. Budget 0 / VIOLATED is the page line.
    slo_objs = sorted({dict(labels).get("objective", "")
                       for (name, labels) in cur
                       if name == "pilosa_slo_budget_remaining"})
    if slo_objs:
        parts = []
        for obj in slo_objs:
            rem = cur.get(("pilosa_slo_budget_remaining",
                           (("objective", obj),)), 0.0)
            burns = [(dict(labels).get("window", ""), v)
                     for (name, labels), v in cur.items()
                     if name == "pilosa_slo_burn_rate"
                     and dict(labels).get("objective") == obj]
            part = f"{obj} {rem * 100:.0f}%"
            if burns:
                w, rate = max(burns, key=lambda x: (x[1], x[0]))
                part += f" (burn {rate:.2f}@{w})"
            if rem <= 0:
                part += " VIOLATED"
            parts.append(part)
        lines.append("")
        lines.append("slo budget: " + "   ".join(parts))
    return "\n".join(lines) + "\n"



def cmd_top(args) -> int:
    """Scrape /metrics on an interval and render a one-screen summary
    (QPS, per-phase percentiles, roofline, scheduler queue/shed/batch,
    membership + migrations, breakers, HBM residency) —
    the operator's first-response tool."""
    import urllib.request

    url = f"http://{args.host}/metrics"
    prev: dict = {}
    t_prev = 0.0
    n = 0
    while True:
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                text = resp.read().decode()
        except OSError as e:
            print(f"scrape {url}: {e}", file=sys.stderr)
            return 1
        now = time.monotonic()
        cur = _parse_prom(text)
        out = render_top(args.host, cur, prev, now - t_prev)
        if sys.stdout.isatty() and args.n != 1:
            sys.stdout.write("\x1b[2J\x1b[H")
        sys.stdout.write(out)
        sys.stdout.flush()
        prev, t_prev = cur, now
        n += 1
        if args.n and n >= args.n:
            return 0
        time.sleep(args.interval)


def render_costs(host: str, doc: dict) -> str:
    """One screenful from a /debug/costs document: dimension totals,
    ledger health, active regressions, then the top accounts. Pure —
    tests feed it canned snapshots."""
    totals = doc.get("totals") or {}
    lines = [f"pilosa-tpu-torch costs — via {host}   "
             f"accounts {doc.get('n_accounts', 0)}   "
             f"views {doc.get('resident_views', 0)}   "
             f"sort {doc.get('sort', 'device_us')}"]
    if not doc.get("enabled", True):
        lines.append("cost ledger DISABLED ([obs] cost-ledger = false)")
        return "\n".join(lines) + "\n"
    lines.append(
        f"totals: device {_fmt_us(totals.get('device_us', 0.0))}"
        f" (saved {_fmt_us(totals.get('saved_device_us', 0.0))})   "
        f"hbm {_fmt_bytes(totals.get('hbm_byte_seconds', 0.0))}·s   "
        f"staged {_fmt_bytes(totals.get('staged_bytes', 0.0))}   "
        f"wal {_fmt_bytes(totals.get('wal_bytes', 0.0))}   "
        f"net http {_fmt_bytes(totals.get('net_http_bytes', 0.0))}"
        f" / ici {_fmt_bytes(totals.get('net_ici_bytes', 0.0))}")
    ev = doc.get("events") or {}
    if ev.get("folded") or ev.get("unattributed"):
        lines.append(f"ledger events: tracked {int(ev.get('tracked', 0))}"
                     f"   folded {int(ev.get('folded', 0))}"
                     f"   unattributed {int(ev.get('unattributed', 0))}")
    reg = (doc.get("regression") or {}).get("active") or []
    for r in reg:
        lines.append(f"REGRESSION: shape {r.get('shape', '?')} "
                     f"{r.get('dimension', '?')}")
    lines.append("")
    lines.append(f"{'tenant':<14} {'shape':<22} {'queries':>8} "
                 f"{'device':>9} {'saved':>9} {'hbm·s':>9} "
                 f"{'staged':>9} {'wal':>9} {'net':>9}")
    for row in doc.get("accounts") or []:
        net = (row.get("net_http_bytes", 0.0)
               + row.get("net_ici_bytes", 0.0))
        line = (f"{row.get('tenant', '?'):<14} "
                f"{row.get('shape', '-')[:22]:<22} "
                f"{int(row.get('queries', 0)):>8} "
                f"{_fmt_us(row.get('device_us', 0.0)):>9} "
                f"{_fmt_us(row.get('saved_device_us', 0.0)):>9} "
                f"{_fmt_bytes(row.get('hbm_byte_seconds', 0.0)):>9} "
                f"{_fmt_bytes(row.get('staged_bytes', 0.0)):>9} "
                f"{_fmt_bytes(row.get('wal_bytes', 0.0)):>9} "
                f"{_fmt_bytes(net):>9}")
        if row.get("regressed"):
            line += "  REGRESSED"
        lines.append(line)
    return "\n".join(lines) + "\n"



def cmd_costs(args) -> int:
    """Poll /debug/costs on an interval and render the attribution
    panel: who is spending the fleet's device time, HBM byte-seconds,
    WAL and network bytes — plus any active perf regressions."""
    import json as _json
    import urllib.request

    url = (f"http://{args.host}/debug/costs?sort={args.sort}"
           f"&limit={args.limit}")
    n = 0
    while True:
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                doc = _json.loads(resp.read().decode())
        except OSError as e:
            print(f"scrape {url}: {e}", file=sys.stderr)
            return 1
        out = render_costs(args.host, doc)
        if sys.stdout.isatty() and args.n != 1:
            sys.stdout.write("\x1b[2J\x1b[H")
        sys.stdout.write(out)
        sys.stdout.flush()
        n += 1
        if args.n and n >= args.n:
            return 0
        time.sleep(args.interval)


def render_health(host: str, doc: dict, ready_doc: dict) -> str:
    """One screenful from a /debug/health document plus the /readyz
    verdict: watchdog vitals, then the per-subsystem heartbeat table,
    in-flight ops, gossiped peer health. Pure — tests feed it canned
    snapshots."""
    ready = ready_doc.get("status") == "ok"
    lines = [f"pilosa-tpu-torch health — via {host}   "
             f"readyz {'OK' if ready else 'UNREADY'}   "
             f"watchdog {'alive' if doc.get('watchdog_alive') else 'DEAD'}"
             f"   sweeps {int(doc.get('sweeps', 0))}"
             f"   trips {int(doc.get('trips_total', 0))}"]
    if not ready:
        reasons = ready_doc.get("reasons") or []
        lines.append("unready: " + ", ".join(str(r) for r in reasons))
    lines.append("")
    lines.append(f"{'subsystem':<18} {'state':<8} {'crit':<5} "
                 f"{'interval':>9} {'age':>8} {'beats':>9} "
                 f"{'trips':>6}  thread")
    subs = doc.get("subsystems") or {}
    for name in sorted(subs):
        s = subs[name]
        state = s.get("state", "?")
        if s.get("parked"):
            state = "idle"
        iv = s.get("interval_s")
        age = s.get("age_s")
        line = (f"{name:<18} {state:<8} "
                f"{'yes' if s.get('critical') else '-':<5} "
                f"{(f'{iv:.2f}s' if iv else 'event'):>9} "
                f"{(f'{age:.1f}s' if age is not None else '-'):>8} "
                f"{int(s.get('beats', 0)):>9} "
                f"{int(s.get('trips', 0)):>6}  {s.get('thread', '-')}")
        if s.get("state") == "stalled":
            line += f"   STALLED {s.get('stalled_for_s', 0):.1f}s"
        lines.append(line)
    infl = doc.get("inflight") or []
    if infl:
        lines.append("")
        lines.append("in-flight ops:")
        for op in infl:
            bound = op.get("deadline_s")
            lines.append(
                f"  {op.get('subsystem', '?')}/{op.get('kind', '?')} "
                f"running {op.get('age_s', 0):.1f}s"
                f" (bound {f'{bound:.1f}s' if bound else 'none'})"
                f" on {op.get('thread', '?')}")
    peers = doc.get("peers") or {}
    if peers:
        lines.append("")
        lines.append("gossiped peers:")
        for h in sorted(peers):
            p = peers[h]
            verdict = "ok" if p.get("ready", True) else "UNREADY"
            stalled = p.get("stalled") or []
            line = f"  {h:<24} {verdict}"
            if stalled:
                line += "   stalled: " + ",".join(stalled)
            lines.append(line)
    return "\n".join(lines) + "\n"



def cmd_health(args) -> int:
    """Poll /debug/health (+ /readyz) on an interval and render the
    liveness panel: watchdog vitals, per-subsystem heartbeats,
    in-flight ops, gossiped peer verdicts."""
    import json as _json
    import urllib.request

    n = 0
    while True:
        try:
            with urllib.request.urlopen(
                    f"http://{args.host}/debug/health", timeout=10) as resp:
                doc = _json.loads(resp.read().decode())
            try:
                with urllib.request.urlopen(
                        f"http://{args.host}/readyz", timeout=10) as resp:
                    ready_doc = _json.loads(resp.read().decode())
            except urllib.error.HTTPError as e:  # 503 carries the body
                ready_doc = _json.loads(e.read().decode())
        except OSError as e:
            print(f"scrape {args.host}: {e}", file=sys.stderr)
            return 1
        out = render_health(args.host, doc, ready_doc)
        if sys.stdout.isatty() and args.n != 1:
            sys.stdout.write("\x1b[2J\x1b[H")
        sys.stdout.write(out)
        sys.stdout.flush()
        n += 1
        if args.n and n >= args.n:
            return 0
        time.sleep(args.interval)


def cmd_diagnose(args) -> int:
    """Pull GET /debug/bundle — the same bounded JSON dossier the
    watchdog writes on a trip — and save it locally for attachment to
    an incident. `--write` also asks the node to persist a copy under
    its own <data-dir>/.dossier/."""
    import urllib.request

    url = f"http://{args.host}/debug/bundle"
    if args.write:
        url += "?write=true"
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            body = resp.read()
    except OSError as e:
        print(f"fetch {url}: {e}", file=sys.stderr)
        return 1
    out = args.output
    if out == "-":
        sys.stdout.write(body.decode())
        return 0
    with open(out, "wb") as f:
        f.write(body)
    print(f"wrote {out} ({len(body)} bytes)")
    return 0



def _add_host(p):
    p.add_argument("--host",
                   default=os.environ.get("PILOSA_TORCH_HOST",
                                          "localhost:10101"),
                   help="address of a node")


def _add_ifv(p, view=True):
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-f", "--frame", required=True)
    if view:
        p.add_argument("-v", "--view", default="standard")


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="pilosa-tpu-torch",
        description="run a pilosa_tpu_torch node; bulk data in and out")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("server", help="run a node")
    p.add_argument("-c", "--config", help="TOML config file")
    p.add_argument("-d", "--data-dir")
    p.add_argument("-b", "--bind", help="host:port to listen on")
    p.add_argument("--hosts", help="comma-separated cluster hosts")
    p.add_argument("--replicas", type=int)
    p.add_argument("--use-device", choices=["auto", "on", "off"],
                   help="auto and on serve on the card (no card: the node "
                        "refuses to start), off on the CPU "
                        "($PILOSA_TORCH_USE_DEVICE also sets it)")
    p.add_argument("--log-path", default="")
    p.add_argument("--dry-run", action="store_true",
                   help="print the resolved config and exit")
    p.set_defaults(fn=cmd_server)

    p = sub.add_parser("import", help="bulk-import CSV bits")
    _add_host(p)
    _add_ifv(p, view=False)
    p.add_argument("--create", action="store_true",
                   help="create index/frame if missing")
    p.add_argument("--buffer-size", type=int, default=DEFAULT_IMPORT_BUFFER)
    p.add_argument("paths", nargs="+", help="CSV files ('-' for stdin)")
    p.set_defaults(fn=cmd_import)

    p = sub.add_parser("export", help="export a frame as CSV")
    _add_host(p)
    _add_ifv(p)
    p.add_argument("-o", "--output", default="-")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("backup", help="backup a frame view to a tar file")
    _add_host(p)
    _add_ifv(p)
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_backup)

    p = sub.add_parser("restore", help="restore a frame view from a tar file")
    _add_host(p)
    _add_ifv(p)
    p.add_argument("input")
    p.set_defaults(fn=cmd_restore)

    p = sub.add_parser("bench", help="run micro-benchmarks against a node")
    _add_host(p)
    p.add_argument("-i", "--index", default="bench")
    p.add_argument("-f", "--frame", default="general")
    p.add_argument("--op", default="set-bit",
                   choices=["set-bit", "intersect-count", "topn"])
    p.add_argument("-n", type=int, default=1000)
    p.add_argument("--max-row-id", type=int, default=1000)
    p.add_argument("--max-column-id", type=int, default=1000)
    p.add_argument("--row-label", default="rowID")
    p.add_argument("--column-label", default="columnID")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("check", help="check fragment data files")
    p.add_argument("paths", nargs="+")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("inspect", help="inspect a fragment data file")
    p.add_argument("path")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("sort", help="sort import CSV in fragment order")
    p.add_argument("path", help="CSV file ('-' for stdin)")
    p.set_defaults(fn=cmd_sort)

    p = sub.add_parser("top", help="live /metrics summary for a node")
    _add_host(p)
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between scrapes (default 2)")
    p.add_argument("-n", type=int, default=0,
                   help="number of scrapes, 0 = until interrupted")
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser("costs",
                       help="per-tenant/per-shape cost attribution panel")
    _add_host(p)
    p.add_argument("--sort", default="device_us",
                   choices=["device_us", "hbm", "staged", "wal", "net",
                            "queries", "regression"],
                   help="account ordering (default device_us)")
    p.add_argument("--limit", type=int, default=20,
                   help="accounts shown (default 20)")
    p.add_argument("--interval", type=float, default=5.0,
                   help="seconds between polls (default 5)")
    p.add_argument("-n", type=int, default=0,
                   help="number of polls, 0 = until interrupted")
    p.set_defaults(fn=cmd_costs)

    p = sub.add_parser("health",
                       help="liveness panel: watchdog, heartbeats, "
                            "in-flight ops")
    _add_host(p)
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between polls (default 2)")
    p.add_argument("-n", type=int, default=0,
                   help="number of polls, 0 = until interrupted")
    p.set_defaults(fn=cmd_health)

    p = sub.add_parser("diagnose",
                       help="pull a diagnostic dossier (/debug/bundle) "
                            "from a node")
    _add_host(p)
    p.add_argument("-o", "--output", default="-",
                   help="file to write ('-' for stdout)")
    p.add_argument("--write", action="store_true",
                   help="also persist a copy under the node's "
                        "<data-dir>/.dossier/")
    p.set_defaults(fn=cmd_diagnose)

    p = sub.add_parser("config", help="print the default config")
    p.set_defaults(fn=cmd_config)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(sys.argv[1:] if argv is None else argv)
    try:
        return args.fn(args)
    except KeyboardInterrupt:
        return 130
    except BrokenPipeError:
        return 0


def main_entry() -> None:
    """The `pilosa-tpu-torch` script (pyproject [project.scripts])."""
    sys.exit(main())


if __name__ == "__main__":
    main_entry()
