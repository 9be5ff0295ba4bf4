"""What the on-chip probes share: their arguments, the device, timing,
seeded pools, whole-pool uploads and the JSON record; and the density
sweep's holder and timing (build_sparse_holder, best_of: bench.py's).

Every probe takes --device (default cuda: without a card it raises,
nothing falls back), --out (default chiprun_out/probes/ of this
checkout), --slices and --reps, writes one JSON record under --out and
prints it. A record names the device it ran on; on the CPU its times
come from the host clock and are no device times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

from ..core import Holder
from ..ops.pool import CONTAINER_WORDS, ROW_SPAN
from ..roaring import Bitmap, Container

REPO = Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "chiprun_out" / "probes"
# Bytes of one 16-container row run.
RUN_BYTES = ROW_SPAN * CONTAINER_WORDS * 4
# Back-to-back calls in one timed run of a kernel: the card runs ahead of
# the host's launches, so the events measure the kernels, not the gaps.
INNER = 10
TREE = ["and", ["leaf", 0], ["leaf", 1]]


def parser(description: str, slices_help: str, reps_help: str):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the probe runs (default cuda; raises "
                         "without a card)")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT,
                    help="directory of the JSON record (default "
                         "chiprun_out/probes/ of this checkout)")
    ap.add_argument("--slices", type=int, default=None, help=slices_help)
    ap.add_argument("--reps", type=int, default=None, help=reps_help)
    return ap


def require(ok: bool, what) -> None:
    """A check that survives python -O."""
    if not ok:
        raise RuntimeError(f"probe check failed: {what}")


def record(device: torch.device) -> dict:
    """The head of a record: the device, and on a card its name, its
    nvidia-smi name and power limit, and the torch and CUDA versions."""
    doc = {"device": device.type, "torch": torch.__version__,
           "clock": "cuda events" if device.type == "cuda" else "host"}
    if device.type == "cuda":
        doc["card"] = torch.cuda.get_device_name(device)
        doc["cuda"] = torch.version.cuda
        doc["smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    return doc


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_ms(fn: Callable, device: torch.device, reps: int) -> float:
    """Median milliseconds per call over `reps` timed runs of INNER
    back-to-back calls, after one warm call: CUDA events on a card, the
    host clock (with the work done) on the CPU."""
    fn()
    sync(device)
    runs: List[float] = []
    for _ in range(max(1, reps)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(INNER):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / INNER)
        else:
            t0 = time.perf_counter()
            for _ in range(INNER):
                fn()
            runs.append((time.perf_counter() - t0) * 1e3 / INNER)
    return float(np.median(runs))


def spread(seconds: List[float], unit: float = 1e3) -> dict:
    """median / p90 / mean of per-call host times, in ms (unit 1e3) or
    µs (1e6)."""
    xs = np.asarray(seconds) * unit
    return {"median": float(np.median(xs)),
            "p90": float(np.percentile(xs, 90)),
            "mean": float(xs.mean()), "n": len(xs)}


def timed_s(fn: Callable, device: torch.device):
    """(seconds, result) of one call that ends with the card idle."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def random_words(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def as_tensor(words: np.ndarray) -> torch.Tensor:
    """A host int32 tensor over uint32 words, sharing their memory."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def pinned(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A page-locked copy for a card; on the CPU there is no transfer to
    pin for, and the tensor is returned as it is."""
    return host.pin_memory() if device.type == "cuda" else host


def upload_chunked(host: torch.Tensor, device: torch.device,
                   k: int) -> torch.Tensor:
    """`host` copied into one preallocated device tensor in k slabs of
    slices, as mesh.build_sharded_index fills its pool."""
    dst = torch.empty(host.shape, dtype=host.dtype, device=device)
    lo = 0
    for part in host.tensor_split(k):
        dst[lo:lo + part.shape[0]].copy_(part)
        lo += part.shape[0]
    return dst


def copies(fn: Callable, device: torch.device, reps: int,
           check: Callable[[torch.Tensor], None], nbytes: int) -> dict:
    """`reps` timed calls of fn, each result passed to `check`: the
    median seconds and GB/s of moving `nbytes`, and every run."""
    runs = []
    for _ in range(reps):
        dt, dev = timed_s(fn, device)
        check(dev)
        del dev
        runs.append(dt)
    s = float(np.median(runs))
    return {"s": s, "gb_per_s": nbytes / s / 1e9, "runs_s": runs}


def upload_splits(host: torch.Tensor, device: torch.device,
                  check: Callable[[torch.Tensor], None],
                  reps: int) -> Dict[str, dict]:
    """Whole-pool host-to-device copies of `host` (see copies): pageable
    cold (the first copy), then pageable, pinned (the pin timed on its
    own) and 4 and 16 chunks, each `reps` times."""
    nbytes = host.numel() * host.element_size()
    out = {"pageable_cold": copies(lambda: host.to(device, copy=True),
                                   device, 1, check, nbytes),
           "pageable": copies(lambda: host.to(device, copy=True), device,
                              reps, check, nbytes)}
    pin_s, pin = timed_s(lambda: pinned(host, device), device)
    out["pinned"] = copies(
        lambda: pin.to(device, non_blocking=True, copy=True), device, reps,
        check, nbytes)
    out["pinned"]["pin_s"] = pin_s
    for k in (4, 16):
        out[f"chunks{k}"] = copies(
            lambda k=k: upload_chunked(host, device, k), device, reps, check,
            nbytes)
    return out


def build_holder(path: str, words: np.ndarray) -> Holder:
    """Index `i`, frame `general`: words[s, r, b] is container b of row r
    in slice s, injected as whole storage images."""
    h = Holder(path)
    h.open()
    view = h.create_index_if_not_exists("i").create_frame_if_not_exists(
        "general").create_view_if_not_exists("standard")
    for s in range(words.shape[0]):
        bm = Bitmap()
        for r in range(words.shape[1]):
            for b in range(16):
                bm.keys.append(r * 16 + b)
                bm.containers.append(Container(bitmap=words[s, r, b]))
        view.create_fragment_if_not_exists(s).replace(bm)
    return h


def build_sparse_holder(tmp: str, num_slices: int, density: float = 0.03,
                        seed: int = 23) -> Holder:
    """Index `i`, frame `general`: two rows of ~density containers in all
    16 blocks of every slice (bench.py's build_sparse_holder, the same
    draws from the same seed). Containers normalize at the 4096-value
    roaring break-even, so a density above ~6.25% makes bitmap
    containers (staged dense) and a lower one sorted arrays."""
    rng = np.random.default_rng(seed)
    h = Holder(str(Path(tmp) / f"sparse{num_slices}x{density}"))
    h.open()
    view = h.create_index_if_not_exists("i").create_frame_if_not_exists(
        "general").create_view_if_not_exists("standard")
    n = int(65536 * density)
    for s in range(num_slices):
        bm = Bitmap()
        for r in (0, 1):
            for b in range(16):
                vals = np.sort(rng.choice(65536, size=n, replace=False)
                               ).astype(np.uint32)
                bm.keys.append(r * 16 + b)
                bm.containers.append(Container(array=vals).normalize())
        view.create_fragment_if_not_exists(s).replace(bm)
    return h


def best_of(fn: Callable, reps: int, iters: int) -> float:
    """The least mean seconds a call over `reps` runs of `iters` calls
    (bench.py's best_of). `fn` returns a host value, so each call ends
    with its answer read back."""
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def write_record(out_dir: Path, name: str, doc: dict) -> Path:
    """Writes <out_dir>/<name>.json and prints the record as one line."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.json"
    path.write_text(json.dumps(doc, indent=1) + "\n")
    print(json.dumps(doc), flush=True)
    return path
