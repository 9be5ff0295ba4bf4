"""On-chip probes of the card's staging, result readback and kernel
builds: the twin of tools/probe_r5.py. One subcommand a run:

  stage     host-to-device copies of a 240-slice, cap-128 pool
            (251,658,240 B, from np.random.default_rng(11)): pageable
            .to(device) cold and warm, pin_memory() (timed on its own)
            then a non-blocking copy and a sync, 4 and 16 chunks into one
            preallocated tensor, and the port's own upload
            (parallel/mesh.staged_from_numpy). The JAX tool's placements
            (SingleDeviceSharding, make_array_from_single_device_arrays,
            a NamedSharding put) have no counterpart on one card.
  readback  what a result costs to fetch. Each query is one K1 lone-pair
            launch (coarse_count_uniform) over the staged pool and an
            int64 sum on the card; at least 200 queries per variant give
            the median and p90 µs of: a same-thread .cpu(); a synchronize
            then the fetch; the fetch on a fresh thread; a persistent
            fetch thread fed by a queue (the shape of MeshManager's batch
            thread, parallel/serve.py); launches pipelined ahead of that
            thread; a torch.cuda.Event.query() poll with 0.2 ms sleeps,
            then the fetch.
  kernels   the twin of `pallas`: builds every csrc/*.cu cold into a
            fresh directory (seconds per source), runs K0 on
            arange(1024).reshape(8, 128) int32 and checks x + 1 (the x + 1
            kernel of tools/probe_r5.py:211), then K1 per-slice over an
            (8, 32, 2048) pool against numpy, each with the seconds of its
            first call.

Writes probe_r5_<subcommand>.json under --out.

    python -m pilosa_tpu_torch.tools.probe_r5 {stage,readback,kernels}
        [--device cuda|cpu] [--out DIR] [--slices N] [--reps N]
"""

from __future__ import annotations

import contextlib
import os
import queue
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops import cuda_build
from ..ops import kernels as tk
from ..parallel.mesh import staged_from_numpy
from .common import (TREE, as_tensor, copies, parser, random_words, record,
                     require, spread, sync, timed_s, upload_splits,
                     write_record)

SLICES = 240
CAP = 128
QUERIES = 200
STAGE_REPS = 3


def _pool(slices: int) -> np.ndarray:
    return random_words(np.random.default_rng(11), (slices, CAP, 2048))


def stage(device: torch.device, slices: int, reps: int) -> dict:
    words = _pool(slices)
    host = as_tensor(words)
    want = int(np.bitwise_count(words).sum(dtype=np.int64))

    def check(dev):
        require(int(tk.stream_popcount(dev)) == want, "staged pool's bits")

    out = record(device)
    out.update(slices=slices, cap=CAP, pool_bytes=words.nbytes,
               uploads=upload_splits(host, device, check, reps))
    keys = np.tile(np.arange(CAP, dtype=np.int32), (slices, 1))
    row_ids = np.arange(CAP // 16, dtype=np.uint64)
    out["uploads"]["staged_from_numpy"] = copies(
        lambda: staged_from_numpy(keys, words, row_ids, device).words,
        device, reps, check, words.nbytes)
    return out


def _fetch_loop(inbox: "queue.Queue", outbox: "queue.Queue") -> None:
    while True:
        item = inbox.get()
        if item is None:
            return
        outbox.put((item.cpu(), time.perf_counter()))


def readback(device: torch.device, slices: int, reps: int) -> dict:
    words = _pool(slices)
    pool = as_tensor(words).to(device)
    want = int(np.bitwise_count(words[:, :16] & words[:, 16:32]).sum(
        dtype=np.int64))
    starts = torch.tensor([0, 1], dtype=torch.int32, device=device)
    n = max(QUERIES, reps or 0)

    def launch():
        return tk.coarse_count_uniform((pool, pool), starts, TREE).sum(
            dtype=torch.int64)

    def ready_poll():
        if device.type != "cuda":
            return lambda: True  # CPU work is done when its call returns
        ev = torch.cuda.Event()
        ev.record()
        return ev.query

    def same_thread():
        return launch().cpu()

    def sync_then_fetch():
        r = launch()
        sync(device)
        return r.cpu()

    def fresh_thread():
        r = launch()
        box = []
        th = threading.Thread(target=lambda: box.append(r.cpu()))
        th.start()
        th.join(timeout=60)
        require(not th.is_alive(), "fetch thread finished")
        return box[0]

    inbox: "queue.Queue" = queue.Queue()
    outbox: "queue.Queue" = queue.Queue()
    fetcher = threading.Thread(target=_fetch_loop, args=(inbox, outbox),
                               name="probe-fetch", daemon=True)
    fetcher.start()

    def fetch_thread():
        inbox.put(launch())
        return outbox.get(timeout=60)[0]

    def event_poll():
        r = launch()
        done = ready_poll()
        while not done():
            time.sleep(2e-4)
        return r.cpu()

    out = record(device)
    out.update(slices=slices, cap=CAP, queries=n, variants={})
    try:
        for name, fn in (("same_thread", same_thread),
                         ("sync_then_fetch", sync_then_fetch),
                         ("fresh_thread", fresh_thread),
                         ("fetch_thread", fetch_thread),
                         ("event_poll", event_poll)):
            for _ in range(5):
                fn()
            lat = []
            for _ in range(n):
                t0 = time.perf_counter()
                got = int(fn())
                lat.append(time.perf_counter() - t0)
                require(got == want, (name, got, want))
            out["variants"][name] = spread(lat, 1e6)
        # Pipelined: every launch queued ahead of the fetch thread; each
        # query's time is the gap between two results coming back.
        t0 = time.perf_counter()
        for _ in range(n):
            inbox.put(launch())
        got = [outbox.get(timeout=60) for _ in range(n)]
        ends = [t0] + [t for _, t in got]
        require(all(int(r) == want for r, _ in got), "pipelined answers")
        out["variants"]["pipelined"] = spread(np.diff(ends).tolist(), 1e6)
    finally:
        inbox.put(None)
        fetcher.join(timeout=60)
    require(not fetcher.is_alive(), "fetch thread stopped")
    return out


@contextlib.contextmanager
def _fresh_build_dir():
    """PILOSA_TORCH_BUILD_DIR set to a new empty directory, and the build
    times of cuda_build kept apart, for the length of the block."""
    saved = dict(cuda_build.BUILD_SECONDS)
    old = os.environ.get("PILOSA_TORCH_BUILD_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["PILOSA_TORCH_BUILD_DIR"] = tmp
        cuda_build.BUILD_SECONDS.clear()
        try:
            yield
        finally:
            if old is None:
                os.environ.pop("PILOSA_TORCH_BUILD_DIR")
            else:
                os.environ["PILOSA_TORCH_BUILD_DIR"] = old
            cuda_build.BUILD_SECONDS.clear()
            cuda_build.BUILD_SECONDS.update(saved)


def kernels(device: torch.device, slices: int) -> dict:
    """The cold build, then each kernel's first call, loaded from that
    build unless this process loaded the kernels before."""
    out = record(device)
    out["loaded_before"] = bool(cuda_build._FNS)
    with _fresh_build_dir():
        if device.type == "cuda":
            sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
            require(sources == list(cuda_build.SOURCES),
                    f"every csrc/*.cu is built: {sources}")
            t0 = time.perf_counter()
            cuda_build.build_all()
            out["build_total_s"] = time.perf_counter() - t0
            out["build_s"] = dict(cuda_build.BUILD_SECONDS)
        else:
            out["build_s"] = None  # no nvcc build for the CPU: plain versions
        ramp = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
        x = torch.from_numpy(ramp.copy()).to(device)
        out["probe_first_s"], y = timed_s(lambda: tk.probe_add(x), device)
        out["probe_correct"] = bool(np.array_equal(y.cpu().numpy(),
                                                   ramp + 1))
        require(out["probe_correct"], "K0 on arange(1024) reads x + 1")
        words = random_words(np.random.default_rng(3), (slices, 32, 2048))
        pool = as_tensor(words).to(device)
        starts = torch.tensor([[0] * slices, [1] * slices],
                              dtype=torch.int32, device=device)
        out["coarse_first_s"], per = timed_s(
            lambda: tk.coarse_count_per_slice((pool, pool), starts, TREE),
            device)
    want = np.bitwise_count(words[:, :16] & words[:, 16:]).sum(
        axis=(1, 2), dtype=np.int64)
    out["coarse_correct"] = bool(np.array_equal(per.cpu().numpy()[0], want))
    require(out["coarse_correct"], "K1 per-slice against numpy")
    out["slices"] = slices
    return out


def main(argv=None) -> int:
    ap = parser(__doc__.splitlines()[0],
                f"slices of the pool (default {SLICES}; kernels: 8)",
                f"stage: runs of each copy (default {STAGE_REPS}); "
                f"readback: queries per variant (at least {QUERIES})")
    ap.add_argument("command", choices=("stage", "readback", "kernels"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.command == "stage":
        doc = stage(device, args.slices or SLICES, args.reps or STAGE_REPS)
    elif args.command == "readback":
        doc = readback(device, args.slices or SLICES, args.reps)
    else:
        doc = kernels(device, args.slices or 8)
    write_record(args.out, f"probe_r5_{args.command}", doc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
