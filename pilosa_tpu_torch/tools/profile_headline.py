"""The headline Count(Intersect(Bitmap, Bitmap)) on the card, layer by
layer: the twin of tools/profile_headline.py.

A holder of 960 slices (or --slices N) with 2 dense random rows (from
np.random.default_rng(7)) in frame `general` of index `i`, served by the
port's own entry points. Each component is timed per call on the host
clock, each call ending with its answer on the host (or, for noop, the
card idle); the record keeps the median, p90 and mean ms of --reps calls:

  noop      K0 probe_add on an (8, 128) tensor, then a sync: the
            dispatch floor
  stream    stream_popcount over the staged pool, fetched: the ceiling
  kernel    K1 coarse_count_uniform, the lone pair, summed and fetched
  batch16   one K1 coarse_count_uniform_batch of 16 pairs (per query:
            the call / 16)
  manager   MeshManager.count on the lowered tree (lone path: resolve,
            small uploads, the launch, the sum and its fetch)
  executor  Executor.execute on the PQL string (adds parse and plan)
  http      POST /index/i/query to the port's api.server on a free
            port over one http.client connection (adds HTTP)

The differences between neighbours are the host split of a query. The
JAX tool's variants that compare XLA program shapes (gather_only,
nomask, noshard, slab, slab_scan) have no counterpart on the card.
Writes profile_headline.json under --out.

    python -m pilosa_tpu_torch.tools.profile_headline [--device cuda|cpu]
        [--out DIR] [--slices N] [--reps N]
"""

from __future__ import annotations

import http.client
import json
import sys
import tempfile
import time

import numpy as np
import torch

from .. import resolve_device
from ..api.server import serve
from ..ops import kernels as tk
from ..ops.pool import pack_bitmap
from ..parallel.mesh import build_sharded_index, dense_row, leaf_layout
from ..parallel.plan import _lower_tree
from ..pql import parse_string
from .common import (TREE, build_holder, parser, record, require, spread,
                     sync, write_record)

SLICES = 960
ROWS = 2
REPS = 50
PQL = "Count(Intersect(Bitmap(rowID=0), Bitmap(rowID=1)))"


def _post(conn: http.client.HTTPConnection, body: str) -> int:
    conn.request("POST", "/index/i/query", body=body.encode())
    resp = conn.getresponse()
    doc = json.loads(resp.read())
    require(resp.status == 200, (resp.status, doc))
    return doc["results"][0]


def profile(device: torch.device, num_slices: int, reps: int) -> dict:
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 64, size=(num_slices, ROWS, 16, 1024),
                         dtype=np.uint64)
    want = int(np.bitwise_count(words[:, 0] & words[:, 1]).sum(
        dtype=np.int64))
    out = record(device)
    out.update(slices=num_slices, rows=ROWS, reps=reps, query=PQL,
               components={})
    with tempfile.TemporaryDirectory() as tmp:
        holder = build_holder(tmp, words)
        srv = serve(holder, device=device)
        conn = http.client.HTTPConnection(*srv.address, timeout=120)
        try:
            frags = [holder.fragment("i", "general", "standard", s)
                     for s in range(num_slices)]
            staged = build_sharded_index(
                [pack_bitmap(f.storage) for f in frags], device)
            pool = staged.words
            uni = [leaf_layout(staged.keys_host, dense_row(staged, r)).uniform
                   for r in range(ROWS)]
            starts = torch.tensor(uni, dtype=torch.int32, device=device)
            starts16 = starts.repeat(16)
            probe_x = torch.zeros((8, 128), dtype=torch.int32, device=device)
            ex = srv.handler.executor
            mgr = ex.mesh_manager()
            query = parse_string(PQL)
            leaves: list = []
            shape = _lower_tree(holder, "i", query.calls[0].children[0],
                                leaves)
            slices = list(range(num_slices))
            pool_bits = int(np.bitwise_count(words).sum(dtype=np.int64))

            def noop():
                tk.probe_add(probe_x)
                sync(device)

            components = [
                ("noop", noop, None),
                ("stream", lambda: int(tk.stream_popcount(pool)), pool_bits),
                ("kernel", lambda: int(tk.coarse_count_uniform(
                    (pool, pool), starts, TREE).sum(dtype=torch.int64)),
                 want),
                ("batch16", lambda: tk.coarse_count_uniform_batch(
                    (pool, pool), starts16, TREE).sum(
                        dim=1, dtype=torch.int64).tolist(), [want] * 16),
                ("manager", lambda: mgr.count("i", shape, leaves, slices,
                                              num_slices), want),
                ("executor", lambda: ex.execute("i", parse_string(PQL))[0],
                 want),
                ("http", lambda: _post(conn, PQL), want)]
            for name, fn, answer in components:
                got = fn()  # the first call stages, for the manager
                require(answer is None or got == answer, (name, got, answer))
                lat = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    got = fn()
                    lat.append(time.perf_counter() - t0)
                    require(answer is None or got == answer,
                            (name, got, answer))
                out["components"][name] = spread(lat)
            out["components"]["batch16"]["per_query_median"] = (
                out["components"]["batch16"]["median"] / 16)
        finally:
            conn.close()
            srv.close()
            holder.close()
    med = {k: v["median"] for k, v in out["components"].items()}
    out["adds_ms"] = {"resolve_upload_sync": med["manager"] - med["kernel"],
                      "parse_plan": med["executor"] - med["manager"],
                      "http": med["http"] - med["executor"]}
    return out


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0],
                  f"slices of the index (default {SLICES})",
                  f"timed calls per component (default {REPS})"
                  ).parse_args(argv)
    device = resolve_device(args.device)
    write_record(args.out, "profile_headline",
                 profile(device, args.slices or SLICES, args.reps or REPS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
