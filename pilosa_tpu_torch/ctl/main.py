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

The flags are the JAX package's (`pilosa_tpu/ctl/main.py`); --host
defaults to $PILOSA_TORCH_HOST, else localhost:10101. The JAX ctl's
top, fleet, costs, health, diagnose and loadgen read stores the port
does not have yet and are not here. Every batch of an
import goes to --host: a node with no cluster owns every slice. A CSV
time is read as local time (`datetime.strptime(...).timestamp()`), as
the JAX ctl reads it, and travels as seconds since the epoch.
"""

from __future__ import annotations

import argparse
import io
import json
import os
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
