"""`python -m pilosa_tpu_torch.ctl` — bulk data in and out of a node.

    import    CSV lines `row,col[,YYYY-MM-DDTHH:MM]` -> POST /import, one
              protobuf request a slice, buffered by --buffer-size bits
              (--create makes the index and the frame first)
    export    a frame's view -> `row,col` lines (-o FILE, default stdout)
    backup    a frame's view -> a tar with one `slice.N` member a
              fragment, each the fragment's own data + cache tar
    restore   such a tar -> the node, fragment by fragment

The flags are the JAX package's (`pilosa_tpu/ctl/main.py`); --host
defaults to $PILOSA_TORCH_HOST, else localhost:10101. Every batch of an
import goes to --host: a node with no cluster owns every slice. A CSV
time is read as local time (`datetime.strptime(...).timestamp()`), as
the JAX ctl reads it, and travels as seconds since the epoch.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import tarfile
import time
from datetime import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import SLICE_WIDTH

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
        prog="python -m pilosa_tpu_torch.ctl",
        description="bulk data in and out of a pilosa_tpu_torch node")
    sub = ap.add_subparsers(dest="cmd", required=True)

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
