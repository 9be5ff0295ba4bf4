"""Where cold staging time goes on the card: the twin of
tools/profile_stage.py.

A view of 960 slices (or --slices N) x 8 dense random rows (cap 128;
1,006,632,960 B at 960, from np.random.default_rng(7)) in a holder, as
the server stages it, split into:

  refresh      MeshManager.refresh of a new manager: the server's whole
               cold stage (per slice under the fragment's lock the format
               pick and ops.pool.pack_bitmap, then build_sharded_index)
  pack_bitmap  the per-fragment copies alone
  stage        parallel/mesh.build_sharded_index onto the card from those
               copies: host packing and 64 MB pageable copies in turn
  pack         the same call with a CPU target: its host loop, with a
               host memcpy into fresh memory in place of each copy
  uploads      one pageable copy of the packed pool (cold, then warm),
               one pinned copy (the pin timed on its own), 4 and 16
               chunks
  overlap16    16 chunks, each packed into one of two pinned buffers
               while the copy of the one before runs on a side stream

Writes profile_stage.json under --out.

    python -m pilosa_tpu_torch.tools.profile_stage [--device cuda|cpu]
        [--out DIR] [--slices N] [--reps N]
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch

from .. import resolve_device
from ..ops import kernels as tk
from ..ops.pool import CONTAINER_WORDS, pack_bitmap
from ..parallel.mesh import build_sharded_index
from ..parallel.serve import MeshManager
from .common import (build_holder, copies, parser, pinned, record, require,
                     timed_s, upload_splits, write_record)

SLICES = 960
ROWS = 8
CAP = ROWS * 16
REPS = 1


def overlapped(slices, device: torch.device, k: int) -> torch.Tensor:
    """The pool staged in k chunks: chunk i+1 packs into one of two
    pinned host buffers while chunk i copies on a side stream."""
    s = len(slices)
    dst = torch.empty((s, CAP, CONTAINER_WORDS), dtype=torch.int32,
                      device=device)
    bounds = np.linspace(0, s, k + 1, dtype=int)
    rows = int(np.diff(bounds).max())
    bufs = [pinned(torch.empty((rows, CAP, CONTAINER_WORDS),
                               dtype=torch.int32), device) for _ in range(2)]
    copied = [None, None]
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    for i in range(k):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        if copied[i % 2] is not None:
            copied[i % 2].synchronize()  # the buffer's last copy is done
        buf = bufs[i % 2][:hi - lo]
        words = buf.numpy().view(np.uint32)
        words[:] = 0
        for si in range(lo, hi):
            words[si - lo, :len(slices[si][1])] = slices[si][1]
        if side is None:
            dst[lo:hi].copy_(buf)
            continue
        with torch.cuda.stream(side):
            dst[lo:hi].copy_(buf, non_blocking=True)
            copied[i % 2] = torch.cuda.Event()
            copied[i % 2].record(side)
    if side is not None:
        side.synchronize()
    return dst


def profile(device: torch.device, num_slices: int, reps: int) -> dict:
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 64, size=(num_slices, ROWS, 16, 1024),
                         dtype=np.uint64)
    want = int(np.bitwise_count(words).sum(dtype=np.int64))
    nbytes = words.nbytes

    def check(dev):
        require(int(tk.stream_popcount(dev)) == want, "staged pool's bits")

    out = record(device)
    out.update(slices=num_slices, rows=ROWS, pool_bytes=nbytes)
    with tempfile.TemporaryDirectory() as tmp:
        holder = build_holder(tmp, words)
        try:
            out["refresh"] = copies(
                lambda: MeshManager(holder, device).refresh(
                    "i", "general", "standard", num_slices).sharded.words,
                device, reps, check, nbytes)
            frags = [holder.fragment("i", "general", "standard", s)
                     for s in range(num_slices)]
            runs = []
            for _ in range(reps):
                dt, slices = timed_s(
                    lambda: [pack_bitmap(f.storage) for f in frags], device)
                runs.append(dt)
            out["pack_bitmap"] = {"s": float(np.median(runs)),
                                  "runs_s": runs}
        finally:
            holder.close()
    del words
    out["stage"] = copies(
        lambda: build_sharded_index(slices, device).words, device, reps,
        check, nbytes)
    runs = []
    for _ in range(reps):
        dt, host = timed_s(
            lambda: build_sharded_index(slices, "cpu").words, device)
        runs.append(dt)
    out["pack"] = {"s": float(np.median(runs)), "runs_s": runs}
    out["uploads"] = upload_splits(host, device, check, reps)
    out["uploads"]["overlap16"] = copies(
        lambda: overlapped(slices, device, 16), device, reps, check, nbytes)
    return out


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0],
                  f"slices of the view (default {SLICES})",
                  f"runs of each split, the median kept (default {REPS})"
                  ).parse_args(argv)
    device = resolve_device(args.device)
    write_record(args.out, "profile_stage",
                 profile(device, args.slices or SLICES, args.reps or REPS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
