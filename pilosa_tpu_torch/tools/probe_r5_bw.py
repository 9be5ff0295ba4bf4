"""Bandwidth probe of the coarse count kernels on the card: the twin of
tools/probe_r5_bw.py.

For S in {960, 3072} slices (or --slices N) a pool of S x 32 x 2048
random uint32 words (two dense rows of 16 runs, from
np.random.default_rng(7)) is counted as one pair, Count(Intersect) of
runs 0 and 1, by each form below; rows give ms (the median of --reps
runs timed with CUDA events) and GB/s:

  s{S}_per_slice       K1 coarse_count_per_slice (the JAX tool's
                       "current per-slice kernel")
  s{S}_blocked_t{T}    K6 coarse_count_blocked, T consecutive slices per
                       block, T in {1, 4, 8, 16, 32} (uniform_t{T})
  s{S}_plain_static    the plain PyTorch popcount over the two static
                       halves of the pool (xla_static); reported, never
                       a ceiling
  s{S}_stream          stream_popcount over the whole pool (stream): the
                       card's streaming ceiling
  s{S}_torch_sum_read  pool.sum(dtype=torch.int64), a library read rate
                       to cross-check the stream

Every count is checked against np.bitwise_count of the same words before
it is timed. Writes probe_r5_bw.json under --out.

    python -m pilosa_tpu_torch.tools.probe_r5_bw [--device cuda|cpu]
        [--out DIR] [--slices N] [--reps N]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import resolve_device
from ..ops import kernels as tk
from ..ops.bitops import popcount
from .common import (RUN_BYTES, TREE, as_tensor, kernel_ms, parser, record,
                     random_words, require, write_record)

SWEEP = (960, 3072)
CAP = 32
BLOCKS = (1, 4, 8, 16, 32)
REPS = 10


def probe(device: torch.device, slices, reps: int) -> dict:
    out = record(device)
    out.update(reps=reps, cap=CAP, rows={})
    rng = np.random.default_rng(7)
    for s in slices:
        host = random_words(rng, (s, CAP, 2048))
        pool = as_tensor(host).to(device)
        per_slice = np.bitwise_count(host[:, :16] & host[:, 16:]).sum(
            axis=(1, 2), dtype=np.int64)
        pair_bytes = 2 * s * RUN_BYTES
        pool_bytes = host.nbytes
        starts_ps = torch.tensor([[0] * s, [1] * s], dtype=torch.int32,
                                 device=device)
        starts_u = torch.tensor([0, 1], dtype=torch.int32, device=device)
        rows = [(f"s{s}_per_slice", lambda: tk.coarse_count_per_slice(
            (pool, pool), starts_ps, TREE), per_slice[None], pair_bytes)]
        rows += [(f"s{s}_blocked_t{t}", lambda t=t: tk.coarse_count_blocked(
            (pool, pool), starts_u, TREE, t), per_slice[None], pair_bytes)
            for t in BLOCKS if s % t == 0]
        rows += [
            (f"s{s}_plain_static", lambda: popcount(
                pool[:, :16] & pool[:, 16:]).sum(dtype=torch.int64),
             per_slice.sum(), pair_bytes),
            (f"s{s}_stream", lambda: tk.stream_popcount(pool),
             np.bitwise_count(host).sum(dtype=np.int64), pool_bytes),
            (f"s{s}_torch_sum_read", lambda: pool.sum(dtype=torch.int64),
             host.view(np.int32).sum(dtype=np.int64), pool_bytes)]
        for name, fn, want, nbytes in rows:
            got = fn().cpu().numpy()
            require(got.shape == np.shape(want)
                    and np.array_equal(got, want), f"{name} != numpy")
            ms = kernel_ms(fn, device, reps)
            out["rows"][name] = {"ms": ms, "bytes": nbytes,
                                 "gb_per_s": nbytes / ms / 1e6}
            print(f"{name:24s} {ms:9.4f} ms {nbytes / ms / 1e6:9.1f} GB/s",
                  flush=True)
        del pool
    return out


def main(argv=None) -> int:
    args = parser(__doc__.splitlines()[0],
                  "one slice count instead of the sweep 960, 3072",
                  f"timed runs per row (default {REPS})").parse_args(argv)
    device = resolve_device(args.device)
    slices = (args.slices,) if args.slices else SWEEP
    write_record(args.out, "probe_r5_bw",
                 probe(device, slices, args.reps or REPS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
