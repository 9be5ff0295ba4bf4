#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (pilosa_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:
  1. the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from pilosa_tpu_torch/csrc with nvcc;
  3. kernels: every wrapper on the card at the main path's shapes, held
     exactly against its plain PyTorch version, and timed;
  4. the slice: a Holder of 960 slices (1,006,632,960 columns) with 8 dense random rows, one partial row and one row in
     odd slices only, served over HTTP on 127.0.0.1: the Quickstart
     requests, a lone Count(Intersect), the 28 row pairs from 16
     concurrent clients (twice), Count(Union) / Count(Difference), and
     counts over the partial rows. Every answer is checked against
     np.bitwise_count on the host words, every kernel's launch counter
     must move during this phase, and torch.profiler measures the card's
     busy share of the second 16-client round;
  5. a `kernels` JSON line, the card line, and the final
     {"ok": true, "device": ...} line.

Exits non-zero, with no result line, when no CUDA card is present.
Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import http.client
import itertools
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SLICES = 960
DENSE_ROWS = 8
PARTIAL_ROW = 8      # blocks 0-7 of even slices only: gathers per container
ODD_ROW = 9          # all 16 blocks of odd slices only: coarse, not uniform
CLIENTS = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
RUN_BYTES = 16 * 2048 * 4  # one 16-container row run
BATCH_RUNS = 32            # distinct row runs read by a 16-query K1 batch

# kernel -> (source, the Pallas call it replaces on the main path)
KERNELS = {
    "coarse_count": ("pilosa_tpu_torch/csrc/coarse_count.cu",
                     "pilosa_tpu/ops/kernels.py:490"),
    "coarse_count_shared": ("pilosa_tpu_torch/csrc/coarse_count_shared.cu",
                            "pilosa_tpu/ops/kernels.py:668"),
    "tree_count": ("pilosa_tpu_torch/csrc/tree_count.cu",
                   "pilosa_tpu/ops/kernels.py:279"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what) -> None:
    """A check that survives python -O: failing it fails the run."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# -- data ----------------------------------------------------------------------


def make_words(num_slices: int, seed: int) -> np.ndarray:
    """(S, 10, 16, 1024) uint64 container words: rows 0-7 dense random,
    row 8 random in blocks 0-7 of even slices, row 9 random in odd
    slices; zeros elsewhere."""
    rng = np.random.default_rng(seed)
    w = np.zeros((num_slices, DENSE_ROWS + 2, 16, 1024), dtype=np.uint64)
    w[:, :DENSE_ROWS] = rng.integers(0, 2**64, size=w[:, :DENSE_ROWS].shape,
                                     dtype=np.uint64)
    w[0::2, PARTIAL_ROW, :8] = rng.integers(
        0, 2**64, size=w[0::2, PARTIAL_ROW, :8].shape, dtype=np.uint64)
    w[1::2, ODD_ROW] = rng.integers(0, 2**64, size=w[1::2, ODD_ROW].shape,
                                    dtype=np.uint64)
    return w


def build_holder(path: str, words: np.ndarray):
    """A port Holder whose index `i`, frame `general` holds `words`,
    injected as whole storage images (per-bit writes would take hours)."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.roaring import Bitmap, Container

    h = Holder(path)
    h.open()
    view = h.create_index_if_not_exists("i").create_frame_if_not_exists(
        "general").create_view_if_not_exists("standard")
    for s in range(words.shape[0]):
        bm = Bitmap()
        for r in range(words.shape[1]):
            for b in range(16):
                if words[s, r, b].any():
                    bm.keys.append(r * 16 + b)
                    bm.containers.append(Container(bitmap=words[s, r, b]))
        view.create_fragment_if_not_exists(s).replace(bm)
    return h


def host_count(words: np.ndarray, op: str, a: int, b: int) -> int:
    x, y = words[:, a], words[:, b]
    z = {"and": x & y, "or": x | y, "andnot": x & ~y}[op]
    return int(np.bitwise_count(z).sum(dtype=np.int64))


# -- timing --------------------------------------------------------------------


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` warm calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 3: kernels ----------------------------------------------------------


def kernel_phase(holder, words: np.ndarray, device, seed: int) -> dict:
    """Each wrapper at the main path's shapes against its plain version
    (ops.kernels.coarse_plain / shared_plain / tree_plain, called
    directly on the same card tensors), exactly, then both timed."""
    import torch

    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.ops.pool import pack_bitmap
    from pilosa_tpu_torch.parallel.mesh import (build_sharded_index,
                                                dense_row, leaf_layout)

    s = words.shape[0]
    frags = [holder.fragment("i", "general", "standard", i) for i in range(s)]
    t0 = time.monotonic()
    staged = build_sharded_index([pack_bitmap(f.storage) for f in frags],
                                 device)
    torch.cuda.synchronize()
    log(f"kernel phase: staged {staged.words.numel() * 4 / 1e9:.3f} GB "
        f"pool (S={s}, cap={staged.capacity}) in "
        f"{time.monotonic() - t0:.2f} s")
    pool = staged.words
    lay = {r: leaf_layout(staged.keys_host, dense_row(staged, r))
           for r in range(DENSE_ROWS + 2)}

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    pair_and = ["and", ["leaf", 0], ["leaf", 1]]
    pairs16 = list(itertools.combinations(range(DENSE_ROWS), 2))[:16]
    uni = dev([lay[0].uniform, lay[1].uniform])
    tab = dev(np.stack([lay[0].starts, lay[1].starts]))
    # K1 batches serve distinct leaves (repeats go to K2), so they run
    # on a pool of BATCH_RUNS random row runs: query q reads runs 2q and
    # 2q+1, at one index in every slice (uniform) or at a per-slice
    # rotation (table).
    gen = torch.Generator(device=device).manual_seed(seed)
    wide = torch.randint(-2**31, 2**31, (s, BATCH_RUNS * 16, 2048),
                         dtype=torch.int32, device=device, generator=gen)
    w2 = (wide, wide)
    uni32 = dev(np.arange(BATCH_RUNS))
    tab32 = dev((np.arange(BATCH_RUNS)[:, None] + np.arange(s)[None, :])
                % BATCH_RUNS)
    leaf_map = tuple(pairs16)
    shared_uni = dev([lay[r].uniform for r in range(DENSE_ROWS)])
    shared_tab = dev(np.stack([lay[r].starts for r in range(DENSE_ROWS)]))
    idx = dev(np.stack([lay[PARTIAL_ROW].idx, lay[0].idx]))
    hit = dev(np.stack([lay[PARTIAL_ROW].hit, lay[0].hit]))
    hit_np = np.stack([lay[PARTIAL_ROW].hit, lay[0].hit])
    p2, p8 = (pool, pool), (pool,) * DENSE_ROWS

    # (wrapper, kernel, kernel call, plain call, bytes moved)
    out_b = 4 * s
    cases = [
        ("coarse_count_uniform", "coarse_count",
         lambda: tk.coarse_count_uniform(p2, uni, pair_and),
         lambda: tk.coarse_plain(p2, uni, True, pair_and, 1),
         2 * s * RUN_BYTES + out_b),
        ("coarse_count_uniform_batch", "coarse_count",
         lambda: tk.coarse_count_uniform_batch(w2, uni32, pair_and),
         lambda: tk.coarse_plain(w2, uni32, True, pair_and, 16),
         BATCH_RUNS * s * RUN_BYTES + 16 * out_b),
        ("coarse_count_per_slice", "coarse_count",
         lambda: tk.coarse_count_per_slice(p2, tab, pair_and),
         lambda: tk.coarse_plain(p2, tab, False, pair_and, 1),
         2 * s * RUN_BYTES + 2 * out_b + out_b),
        ("coarse_count_identity_batch", "coarse_count",
         lambda: tk.coarse_count_identity_batch(w2, tab32, pair_and),
         lambda: tk.coarse_plain(w2, tab32, False, pair_and, 16),
         BATCH_RUNS * s * RUN_BYTES + BATCH_RUNS * out_b + 16 * out_b),
        ("coarse_count_shared_uniform", "coarse_count_shared",
         lambda: tk.coarse_count_shared_uniform(p8, shared_uni, pair_and,
                                                leaf_map),
         lambda: tk.shared_plain(p8, shared_uni, True, pair_and, leaf_map),
         DENSE_ROWS * s * RUN_BYTES + 16 * out_b),
        ("coarse_count_batch_per_slice", "coarse_count_shared",
         lambda: tk.coarse_count_batch_per_slice(p8, shared_tab, pair_and,
                                                 leaf_map),
         lambda: tk.shared_plain(p8, shared_tab, False, pair_and, leaf_map),
         DENSE_ROWS * s * RUN_BYTES + DENSE_ROWS * out_b + 16 * out_b),
        ("tree_count_per_slice", "tree_count",
         lambda: tk.tree_count_per_slice(p2, idx[None], hit[None], pair_and),
         lambda: tk.tree_plain(p2, idx[None], hit[None], pair_and),
         int(hit_np.sum()) * 2048 * 4 + 2 * idx.numel() * 4 + out_b),
    ]
    results = {}
    for name, kernel, run, plain, nbytes in cases:
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0 and got.shape == want.shape,
              f"{name}: kernel != plain (max err {err})")
        ms = time_ms(run, 20)
        plain_ms = time_ms(plain, 3)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        results[name] = {"kernel": kernel, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bytes": nbytes,
                         "gb_per_s": nbytes / ms / 1e6, "max_abs_err": err}
        log(f"  {name:30s} {kernel:20s} {ms:8.4f} ms  "
            f"{nbytes / ms / 1e6:7.1f} GB/s  bound {bound_ms:.4f} ms  "
            f"plain {plain_ms:.3f} ms  exact")
    # The wrapper total over the same per-slice vector.
    total = int(tk.tree_count_pallas(pool, idx, hit, pair_and))
    want = host_count(words, "and", PARTIAL_ROW, 0)
    check(total == want, f"tree_count_pallas {total} != host {want}")
    del staged, pool, wide, w2
    torch.cuda.empty_cache()
    return results


# -- phase 4: the slice over HTTP ----------------------------------------------


class Client:
    def __init__(self, host: str, port: int):
        self.conn = http.client.HTTPConnection(host, port, timeout=120)

    def call(self, method: str, path: str, body: str = ""):
        self.conn.request(method, path, body=body.encode())
        resp = self.conn.getresponse()
        doc = json.loads(resp.read())
        check(resp.status == 200, (method, path, body, resp.status, doc))
        return doc

    def count(self, pql: str) -> int:
        return self.call("POST", "/index/i/query", pql)["results"][0]

    def close(self):
        self.conn.close()


OPS = {"and": "Intersect", "or": "Union", "andnot": "Difference"}


def pql(op: str, a: int, b: int) -> str:
    return f"Count({OPS[op]}(Bitmap(rowID={a}), Bitmap(rowID={b})))"


def quickstart(c: Client) -> None:
    c.call("POST", "/index/q", "{}")
    c.call("POST", "/index/q/frame/f", "{}")
    for col in (7, 1_050_000):
        c.call("POST", "/index/q/query", f"SetBit(rowID=1, frame=f, columnID={col})")
    c.call("POST", "/index/q/query", "SetBit(rowID=2, frame=f, columnID=7)")
    q = "Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f)))"
    for body, want in (
            (q, [1]),
            ("ClearBit(rowID=2, frame=f, columnID=7)", [True]),
            (q, [0]),
            ("Bitmap(rowID=1, frame=f)",
             [{"attrs": {}, "bits": [7, 1_050_000]}])):
        got = c.call("POST", "/index/q/query", body)
        check(got == {"results": want}, (body, got))
    names = [i["name"] for i in c.call("GET", "/schema")["indexes"]]
    check(names == ["i", "q"], names)


def concurrent(host, port, queries, want, rounds: int = 1) -> float:
    """CLIENTS threads, each sending every query once per round (from a
    different offset); returns queries per second. Answers are checked."""
    errors = []

    def client(k):
        c = Client(host, port)
        try:
            for _ in range(rounds):
                for j in range(len(queries)):
                    i = (j + k) % len(queries)
                    got = c.count(queries[i])
                    if got != want[i]:
                        errors.append((queries[i], got, want[i]))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            c.close()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.monotonic() - t0
    check(not errors, f"concurrent answers: {errors[:5]}")
    return CLIENTS * rounds * len(queries) / dt


def profiled(fn) -> dict:
    """Run fn under torch.profiler (CUDA activity only) and report the
    device time of every kernel against the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = {e.key: e.self_device_time_total
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    busy = sum(kernels.values()) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall,
            "device_us_by_kernel": kernels}


def slice_phase(holder, words: np.ndarray, card: str, device) -> dict:
    import torch

    from pilosa_tpu_torch.api.server import serve
    from pilosa_tpu_torch.ops import kernels as tk

    t0 = time.monotonic()
    pairs = list(itertools.combinations(range(DENSE_ROWS), 2))
    want = {(op, a, b): host_count(words, op, a, b)
            for op, a, b in [("and", a, b) for a, b in pairs]
            + [("or", 0, 1), ("andnot", 1, 0), ("and", PARTIAL_ROW, 0),
               ("or", PARTIAL_ROW, 1), ("and", ODD_ROW, 2),
               ("and", ODD_ROW, PARTIAL_ROW), ("and", 3, ODD_ROW)]}
    log(f"slice phase: host answers in {time.monotonic() - t0:.2f} s")

    srv = serve(holder, device=device)
    host, port = srv.address
    ex = srv.handler.executor
    c = Client(host, port)
    try:
        t0 = time.monotonic()
        c.count(pql("and", 0, 1))  # stages the view
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        log(f"slice phase: first query (staging) {first_s:.2f} s")
        mgr = ex.mesh_manager()
        before = dict(mgr.stats)
        tk.reset_launches()
        quickstart(c)
        for key in [("and", 0, 1)] + [("or", 0, 1), ("andnot", 1, 0), ("and", PARTIAL_ROW, 0),
                    ("or", PARTIAL_ROW, 1), ("and", ODD_ROW, 2),
                    ("and", ODD_ROW, PARTIAL_ROW)]:
            got = c.count(pql(*key))
            check(got == want[key], (key, got, want[key]))
        # Lone throughput: one client, distinct pairs back to back.
        lone_q = [pql("and", a, b) for a, b in pairs]
        lone_w = [want[("and", a, b)] for a, b in pairs]
        t0 = time.monotonic()
        for q, w in zip(lone_q * 2, lone_w * 2):
            got = c.count(q)
            check(got == w, (q, got, w))
        lone_qps = 2 * len(lone_q) / (time.monotonic() - t0)
        # The 28 pairs from 16 clients, twice: the batch thread coalesces
        # them and repeated leaves take the shared-read kernel.
        conc_qps = [concurrent(host, port, lone_q, lone_w)]
        busy = profiled(lambda: conc_qps.append(
            concurrent(host, port, lone_q, lone_w)))
        # Non-uniform coarse and per-container rows under concurrency.
        mixed = [("and", ODD_ROW, 2), ("and", 3, ODD_ROW),
                 ("and", PARTIAL_ROW, 0), ("or", PARTIAL_ROW, 1)]
        concurrent(host, port, [pql(*k) for k in mixed],
                   [want[k] for k in mixed])
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        stats = dict(mgr.stats)
        by_wrapper = {k.split(":", 1)[1]: n - before.get(k, 0)
                      for k, n in stats.items() if k.startswith("kernel:")}
    finally:
        c.close()
        srv.close()
    log(f"slice phase on {card}: lone {lone_qps:.1f} QPS, "
        f"{CLIENTS} clients {conc_qps[0]:.1f} / {conc_qps[1]:.1f} QPS")
    log(f"slice phase launches {launches}, by wrapper {by_wrapper}")
    log(f"slice phase profile (second {CLIENTS}-client round): device "
        f"busy {busy['device_busy_s']:.4f} s of {busy['wall_s']:.4f} s "
        f"wall = {busy['device_busy_share']:.4f}")
    log(f"slice phase stats {json.dumps(stats, sort_keys=True)}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} launched on the main path")
    check(stats.get("batched", 0) > 0 and stats.get("shared_batch", 0) > 0,
          "concurrent counts coalesced and shared reads")
    return {"launches": launches, "launches_by_wrapper": by_wrapper,
            "stats": stats, "first_query_s": first_s, "lone_qps": lone_qps,
            "profile": busy,
            "concurrent_qps": conc_qps, "clients": CLIENTS}


# -- main ----------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from pilosa_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.monotonic()
    cuda_build.build_all()
    log(f"build: 3 kernels in {time.monotonic() - t0:.2f} s "
        f"{json.dumps(cuda_build.BUILD_SECONDS)}")

    device = torch.device("cuda")
    t0 = time.monotonic()
    words = make_words(SLICES, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        holder = build_holder(tmp, words)
        try:
            log(f"data: {SLICES} slices ({SLICES << 20} columns) in "
                f"{time.monotonic() - t0:.2f} s")
            kern = kernel_phase(holder, words, device, args.seed)
            sl = slice_phase(holder, words, card, device)
        finally:
            holder.close()

    entries = []
    for name, (source, replaces) in KERNELS.items():
        rows = {w: r for w, r in kern.items() if r["kernel"] == name}
        main_row = next(iter(rows.values()))
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sl["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
            "library_ms": None})
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "slices": SLICES,
         "seed": args.seed, "build_s": cuda_build.BUILD_SECONDS,
         "wrappers": kern, "slice": sl, "kernels": entries}, indent=1))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
