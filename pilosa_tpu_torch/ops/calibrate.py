"""The start-up check of the count kernels: what the JAX package's
ops/calibrate.py does on a card, for a node that serves on its kernels
only.

check_kernels(device) holds K1 (kernels.coarse_count_uniform) against its
plain PyTorch version on the JAX package's representative uniform coarse
count: a (64, 8 x ROW_SPAN, 2048) pool of random words from
default_rng(0x9E3779B9) (64 MiB), the tree Intersect of two leaves at run
starts [0, runs - 1]. The two must be equal; then each is timed as the
best of 5 calls after 2 warm-ups, by CUDA events. K4
(kernels.pallas_sparse_pair_counts) is checked and timed the same way
against bitops.sparse_pair_intersect_counts over 512 pairs of sorted
arrays of up to 512 values. server.check_card runs it at every start on
a card, after the K0 canary and before the socket is bound. The check's
launches compare kernels with their plain versions and serve nothing, so
they are not counted in kernels.LAUNCHES (kernels.uncounted).

The last record is /debug/vars `count_calibration` (calibration_snapshot),
with the JAX record's keys: backend, source, pallas_ms (the CUDA kernel),
xla_ms (the plain version on the same device), shape, interpret (True off
the card), device (`cuda:<card name>`), elapsed_ms, and `sparse`, K4's
record.

Where the port departs from the JAX package, on purpose: the JAX node
calibrates in a background thread, serves on whichever of Pallas and XLA
won, answers "xla" when the canary, the check or the measurement fails,
and keeps its verdicts in a file by device kind. The port has no second
engine: a plain version serves CPU tensors only, so there is no verdict
to choose (a faster plain version shows in the record's numbers and is
never picked) and none to keep. The check runs on every start, so a
rebuilt or edited kernel is never served unchecked, and a mismatch or an
exception raises CalibrationError, so the node refuses to start.

Off the card (the tests) check_kernels runs the same at a small fixed
shape, 8 slices x 2 runs and 16 arrays of up to 128 values, where each
wrapper runs its plain version: the machinery end to end.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import bitops, kernels
from .pool import CONTAINER_WORDS, ROW_SPAN

_MU = threading.Lock()
_RESULT: Optional[dict] = None

# The headline Intersect+Count composition (plan._tree_signature form).
_TREE = ["and", ["leaf", 0], ["leaf", 1]]
_SEED = 0x9E3779B9


class CalibrationError(RuntimeError):
    """A kernel that disagreed with its plain version, or raised, at the
    start-up check: the card cannot be trusted to serve."""


def _device_key(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return "cpu"


def _best_ms(fn: Callable, dev: torch.device, warmup: int = 2,
             iters: int = 5) -> float:
    """Best of `iters` calls of fn() after `warmup`, in ms: CUDA events on
    the card's current stream, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn()
            end.record(stream)
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _race(kernel: Callable, plain: Callable, dev: torch.device,
          what: str) -> tuple:
    """(kernel ms, plain ms) after checking the two answers equal."""
    want, got = plain().cpu(), kernel().cpu()
    if not torch.equal(want.reshape(-1), got.reshape(-1)):
        raise AssertionError(
            f"{what} check mismatch: plain={want.reshape(-1)[:4].tolist()}"
            f"... kernel={got.reshape(-1)[:4].tolist()}...")
    return _best_ms(kernel, dev), _best_ms(plain, dev)


def _record(kernel_ms: float, plain_ms: float, shape: dict,
            dev: torch.device) -> dict:
    on_card = dev.type == "cuda"
    return {"backend": "pallas" if on_card else "xla", "source": "measured",
            "pallas_ms": round(kernel_ms, 4), "xla_ms": round(plain_ms, 4),
            "shape": shape, "interpret": not on_card}


def _measure(dev: torch.device) -> dict:
    """K1 against its plain version on the uniform coarse count: a dense
    (S, cap, 2048) pool, two leaves at uniform run starts, Intersect and
    Count (S = 64 and 8 runs on the card, 8 and 2 elsewhere)."""
    s_n, runs = (64, 8) if dev.type == "cuda" else (8, 2)
    cap = runs * ROW_SPAN
    rng = np.random.default_rng(_SEED)
    words = rng.integers(0, 1 << 32, size=(s_n, cap, CONTAINER_WORDS),
                         dtype=np.uint32)
    pool = torch.from_numpy(words.view(np.int32)).to(dev)
    starts = torch.tensor([0, runs - 1], dtype=torch.int32, device=dev)
    kernel_ms, plain_ms = _race(
        lambda: kernels.coarse_count_uniform((pool, pool), starts, _TREE),
        lambda: kernels.coarse_plain((pool, pool), starts, True, _TREE, 1),
        dev, "count")
    return _record(kernel_ms, plain_ms, {"slices": s_n, "capacity": cap},
                   dev)


def _sorted_block(rng, n: int, k: int, dev: torch.device):
    """n sorted arrays of up to k distinct u16 values (0xFFFF padded), as
    calibrate.py:330-337 of the JAX package draws them: (values int32,
    lengths int32)."""
    vals = np.full((n, k), 0xFFFF, np.uint16)
    lens = rng.integers(0, k + 1, size=n).astype(np.int32)
    for i, ln in enumerate(lens):
        vals[i, :ln] = np.sort(
            rng.choice(1 << 16, size=ln, replace=False)).astype(np.uint16)
    return (torch.from_numpy(vals.astype(np.int32)).to(dev),
            torch.from_numpy(lens).to(dev))


def _measure_sparse(dev: torch.device) -> dict:
    """K4 against its plain version on 512 pairs of sorted arrays of up
    to 512 values (16 of up to 128 off the card)."""
    n, k = (512, 512) if dev.type == "cuda" else (16, 128)
    rng = np.random.default_rng(_SEED)
    a, al = _sorted_block(rng, n, k, dev)
    b, bl = _sorted_block(rng, n, k, dev)
    kernel_ms, plain_ms = _race(
        lambda: kernels.pallas_sparse_pair_counts(a, al, b, bl),
        lambda: bitops.sparse_pair_intersect_counts(a, al, b, bl),
        dev, "sparse")
    return _record(kernel_ms, plain_ms, {"containers": n, "values": k},
                   dev)


def _timed(measure: Callable, dev: torch.device) -> dict:
    t0 = time.perf_counter()
    rec = measure(dev)
    rec["device"] = _device_key(dev)
    rec["elapsed_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
    return rec


def check_kernels(device) -> dict:
    """K1 and K4 held against their plain versions on `device`, then
    timed (the module docstring): K1's record with K4's under "sparse",
    which calibration_snapshot keeps. CalibrationError when a kernel
    disagrees or raises; the snapshot then holds source "error" and the
    error."""
    global _RESULT
    dev = torch.device(device)
    with _MU:
        t0 = time.perf_counter()
        try:
            with kernels.uncounted():
                rec = _timed(_measure, dev)
                rec["sparse"] = _timed(_measure_sparse, dev)
        except Exception as e:  # noqa: BLE001 — recorded, then raised
            rec = {"backend": None, "source": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "device": _device_key(dev),
                   "elapsed_ms": round((time.perf_counter() - t0) * 1e3, 2)}
        _RESULT = rec
    if rec["source"] == "error":
        raise CalibrationError(
            f"kernel check on {rec['device']} failed: {rec['error']}; "
            "refusing to serve")
    return rec


def calibration_snapshot() -> Optional[dict]:
    """The last check's record (None before the first): /debug/vars
    `count_calibration`."""
    rec = _RESULT
    if rec is None:
        return None
    out = dict(rec)
    if "sparse" in out:
        out["sparse"] = dict(out["sparse"])
    return out


def reset_for_tests() -> None:
    global _RESULT
    with _MU:
        _RESULT = None
