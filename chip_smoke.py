#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (pilosa_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N] [--dense-qps-of ROOT]

Phases, each fatal on failure:
  1. the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from pilosa_tpu_torch/csrc with nvcc, and
     run the K0 canary (ops.kernels.probe_ok);
  3. kernels: every wrapper on the card at the main path's shapes, held
     exactly against its plain PyTorch version, and timed;
  4. the dense slice: a Holder of 960 slices (1,006,632,960 columns)
     whose frame `general` holds 8 dense random rows, one partial row
     and one row in odd slices only, served over HTTP on 127.0.0.1: the
     Quickstart requests, a lone Count(Intersect), the 28 row pairs from
     16 concurrent clients (twice), Count(Union) / Count(Difference), and
     counts over the partial rows. Every answer is checked against
     np.bitwise_count on the host words, the launch counter of each
     dense kernel (K1-K3) must move during this phase, and torch.profiler
     measures the card's busy share of the second 16-client round;
  5. the sorted-array kernel K4 at the sparse slice's shapes (one pair of
     frame `sparse` over 960 x 16 containers), held exactly against its
     plain version and timed, with its byte bound and the time its
     binary searches' shared-memory lookups would take;
  6. the sparse slice over HTTP: frame `sparse` (rows 0-7 of 1,024-2,048
     values in every container of every slice, a fill of 1.6-3.1%, and
     row 8 in blocks 0-7 of even slices) and frame `mixed` (rows 0-1
     sorted-array in even slices, dense in odd ones) stage as sorted
     arrays at the default threshold 0.05; the 28 pairs lone and from 16
     clients, Union / Difference, sparse x dense and dense x sparse
     pairs, the partial row, an absent row, a single leaf (no kernel),
     the mixed pair (ss and dd groups in one query), then a three-leaf
     tree that demotes `sparse` to packed words and a pair that then
     runs K1. Every answer is checked against the host; K4's counter,
     each format group and the demote must show;
  7. K5 (pair_count) at the integer field's shapes: the flat pair of each
     op at (15,360, 2048) and at an M that is no multiple of a block, and
     the serving form over the staged `bsi.val` view as the Sum runs it
     (no b, b = the sign row, b = a filter block); plus K1 on the
     canonical tree of Count(Range(val > 1000)) and the K0 canary. Each
     held exactly against its plain version and timed beside its bound;
  8. the integer-field slice over HTTP: field `val` of frame `general`
     (min -32768, max 32767: 16 planes; uniform values in half the
     columns of all 960 slices, made slice by slice from the seed) serves
     Sum, Min and Max with and without the filter Bitmap(frame=general,
     rowID=0), Count(Range(val op c)) for all seven operators with
     constants on both sides of 0 and at the edges, then a handful of
     SetValue writes (and a refused one) and the aggregates again. Every
     answer is checked against the numpy truth; K0 (at server start), K5
     and K1 must launch, `count_host` must not move, and torch.profiler
     measures the card's busy share of a round of Sums;
  9. a `kernels` JSON line, the card line, and the final
     {"ok": true, "device": ...} line.

Each HTTP phase runs one full pass of Python's cyclic collector right
after its staging query and reports its time, so that no timed window
holds the pass that staging would otherwise set off.

Exits non-zero, with no result line, when no CUDA card is present.
Details go to chiprun_out/chip_smoke.json.

With --dense-qps-of ROOT it runs phases 1, 2 and 4 only, built and
served by the package under ROOT, and prints their QPS as one JSON line:
run it alternately on two checkouts to compare their dense serving.
With --lone-latency-of ROOT it runs phases 1 and 2 and the lone Counts
of phase 4 only, 56 of them as in phase 4 and then 560 more, and prints
their latency and the collector's full passes as one JSON line.
"""

from __future__ import annotations

import argparse
import gc
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
SPARSE_ROWS = 8      # frame `sparse`: all 16 blocks of every slice
SPARSE_PARTIAL = 8   # frame `sparse`: blocks 0-7 of even slices only
BUCKET = 32          # sorted-array rows hold one value per 32-wide bucket
CLIENTS = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
# Shared-memory lookups per second of an H100 SXM: one 4-byte bank
# access per lane per clock, 32 lanes on each of 132 SMs at the
# 1.98 GHz boost clock (NVIDIA's data sheet).
SMEM_LOOKUPS_PER_S = 132 * 32 * 1.98e9
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
    "sparse_pair_count": ("pilosa_tpu_torch/csrc/sparse_pair_count.cu",
                          "pilosa_tpu/ops/kernels.py:843"),
    "probe_ok": ("pilosa_tpu_torch/csrc/probe_ok.cu",
                 "pilosa_tpu/ops/kernels.py:121"),
    "pair_count": ("pilosa_tpu_torch/csrc/pair_count.cu",
                   "pilosa_tpu/ops/kernels.py:176"),
}
# The kernels each served path must launch.
DENSE_PATH = ("coarse_count", "coarse_count_shared", "tree_count")
SPARSE_PATH = ("sparse_pair_count", "coarse_count")
BSI_PATH = ("probe_ok", "pair_count", "coarse_count", "tree_count")
# The integer field: the repo's own BSI configuration (bench.py:2079-2167).
BSI_FIELD, BSI_MIN, BSI_MAX = "val", -32768, 32767
BSI_ROWS = 18        # existence, sign, 16 magnitude planes
FLAT_M = 15_360      # the ops-level pair at chip shape: 960 x 16 containers


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


class SparseRows:
    """Sorted-array rows drawn in one vectorised pass: row r's container
    b of slice s holds BUCKET * j + off[s, r, b, j] for j < lens[s, r, b],
    one value per 32-wide bucket, so every container comes out sorted and
    unique and the host answers stay vectorised. lens 0 = absent. Rows
    0-7 fill all 16 blocks of every slice with 1,024-2,048 values; row 8
    fills blocks 0-7 of even slices only."""

    def __init__(self, num_slices: int, seed: int):
        rng = np.random.default_rng(seed + 1)
        rows = SPARSE_ROWS + 1
        self.off = rng.integers(0, BUCKET, size=(num_slices, rows, 16, 2048),
                                dtype=np.uint8)
        self.lens = rng.integers(1024, 2049, size=(num_slices, rows, 16),
                                 dtype=np.int32)
        self.lens[1::2, SPARSE_PARTIAL] = 0
        self.lens[0::2, SPARSE_PARTIAL, 8:] = 0

    def values(self, s: int, r: int, b: int) -> np.ndarray:
        n = self.lens[s, r, b]
        return (np.arange(n, dtype=np.uint32) * BUCKET
                + self.off[s, r, b, :n])

    def inter(self, rows) -> np.ndarray:
        """(S, 16) cardinalities of the intersection of `rows`."""
        same = np.ones(self.off.shape[:1] + (16, 2048), dtype=bool)
        n = self.lens[:, rows[0]]
        for r in rows[1:]:
            same &= self.off[:, r] == self.off[:, rows[0]]
            n = np.minimum(n, self.lens[:, r])
        return (same & (np.arange(2048) < n[..., None])).sum(axis=2)

    def probe(self, r: int, words: np.ndarray, g: int) -> np.ndarray:
        """(S, 16) |sparse row r ∩ dense row g of `words`|."""
        v = (np.arange(2048, dtype=np.int64) * BUCKET
             + self.off[:, r].astype(np.int64))
        w = np.take_along_axis(words[:, g], v >> 6, axis=2)
        bit = (w >> (v & 63).astype(np.uint64)) & np.uint64(1)
        held = np.arange(2048) < self.lens[:, r][..., None]
        return (bit.astype(bool) & held).sum(axis=2)

    def card(self, r: int) -> np.ndarray:
        return self.lens[:, r].astype(np.int64)


def op_count(op: str, inter, na, nb) -> int:
    """Total of a set op from per-container |a ∩ b| and cardinalities."""
    per = {"and": inter, "or": na + nb - inter, "andnot": na - inter}[op]
    return int(np.sum(per, dtype=np.int64))


def add_sparse_frames(holder, words: np.ndarray, sp: SparseRows) -> None:
    """Frame `sparse` of index `i` holds `sp`'s rows; frame `mixed` holds
    its rows 0-1 in even slices and `general`'s rows 0-1 in odd ones."""
    from pilosa_tpu_torch.roaring import Bitmap, Container

    idx = holder.index("i")
    views = {f: idx.create_frame_if_not_exists(f).create_view_if_not_exists(
        "standard") for f in ("sparse", "mixed")}
    for s in range(sp.lens.shape[0]):
        for frame in ("sparse", "mixed"):
            bm = Bitmap()
            for r in range(SPARSE_ROWS + 1 if frame == "sparse" else 2):
                for b in range(16):
                    if frame == "mixed" and s % 2:
                        c = Container(bitmap=words[s, r, b])
                    elif sp.lens[s, r, b]:
                        c = Container(array=sp.values(s, r, b))
                    else:
                        continue
                    bm.keys.append(r * 16 + b)
                    bm.containers.append(c)
            views[frame].create_fragment_if_not_exists(s).replace(bm)


class BsiTruth:
    """The integer field's values, made slice by slice from the seed and
    never held whole (960 x 2^20 int64 would be 8 GB): the numpy truth
    keeps a histogram of the values over all columns and one over the
    columns of the filter (`general` row 0), and answers every query
    from them."""

    def __init__(self, num_slices: int, seed: int, words: np.ndarray):
        self.num_slices, self.seed, self.words = num_slices, seed, words
        self.hist = np.zeros(BSI_MAX - BSI_MIN + 1, dtype=np.int64)
        self.fhist = np.zeros_like(self.hist)
        self.written: dict = {}  # column -> value set by SetValue

    def slice_values(self, s: int):
        """(values int64, exists bool) of slice s's 2^20 columns: uniform
        over the field's range in half the columns, 0 elsewhere."""
        rng = np.random.default_rng([self.seed, 3, s])
        vals = rng.integers(BSI_MIN, BSI_MAX + 1, size=1 << 20,
                            dtype=np.int64)
        exists = rng.random(1 << 20) < 0.5
        vals[~exists] = 0
        return vals, exists

    def filter_bits(self, s: int) -> np.ndarray:
        return np.unpackbits(self.words[s, 0].view(np.uint8),
                             bitorder="little").astype(bool)

    def planes(self, s: int):
        """Slice s's (18, 16, 1024) uint64 bsi rows, and its two
        histograms."""
        vals, exists = self.slice_values(s)
        mags = np.abs(vals).astype(np.uint16)
        bits = np.unpackbits(mags.view(np.uint8).reshape(-1, 2), axis=1,
                             bitorder="little")
        out = np.empty((BSI_ROWS, (1 << 20) // 8), dtype=np.uint8)
        out[0] = np.packbits(exists, bitorder="little")
        out[1] = np.packbits(vals < 0, bitorder="little")
        out[2:] = np.packbits(np.ascontiguousarray(bits.T), axis=1,
                              bitorder="little")
        keep = exists & self.filter_bits(s)
        n = len(self.hist)
        return (out.view(np.uint64).reshape(BSI_ROWS, 16, 1024),
                np.bincount(vals[exists] - BSI_MIN, minlength=n),
                np.bincount(vals[keep] - BSI_MIN, minlength=n))

    def value(self, col: int):
        """The value column `col` holds now, or None."""
        if col in self.written:
            return self.written[col]
        vals, exists = self.slice_values(col >> 20)
        return int(vals[col & 0xFFFFF]) if exists[col & 0xFFFFF] else None

    def set_value(self, col: int, v: int) -> None:
        old = self.value(col)
        filt = bool(self.filter_bits(col >> 20)[col & 0xFFFFF])
        for h, on in ((self.hist, True), (self.fhist, filt)):
            if on and old is not None:
                h[old - BSI_MIN] -= 1
            if on:
                h[v - BSI_MIN] += 1
        self.written[col] = v

    @staticmethod
    def _agg(h: np.ndarray, name: str):
        vals = np.arange(BSI_MIN, BSI_MAX + 1, dtype=np.int64)
        if name == "Sum":
            return {"value": int((vals * h).sum()), "count": int(h.sum())}
        held = np.nonzero(h)[0]
        if not len(held):
            return None
        i = held[-1] if name == "Max" else held[0]
        return {"value": int(vals[i]), "count": int(h[i])}

    def aggregate(self, name: str, filtered: bool):
        return self._agg(self.fhist if filtered else self.hist, name)

    def range_count(self, op: str, c) -> int:
        v = np.arange(BSI_MIN, BSI_MAX + 1, dtype=np.int64)
        if op == "><":
            sel = (v >= c[0]) & (v <= c[1])
        else:
            sel = {">": v > c, ">=": v >= c, "<": v < c, "<=": v <= c,
                   "==": v == c, "!=": v != c}[op]
        return int(self.hist[sel].sum())


def add_bsi_field(holder, truth: BsiTruth) -> float:
    """Field `val` of frame `general`, its planes injected slice by slice
    as whole storage images (SetValue per column would take days). The
    slices are made by a pool of threads: numpy releases the GIL in the
    heavy calls. Returns the seconds spent."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.bsi import FieldSchema
    from pilosa_tpu_torch.roaring import Bitmap, Container

    t0 = time.monotonic()
    frame = holder.index("i").frame("general")
    schema = frame.create_field_if_not_exists(
        FieldSchema(BSI_FIELD, BSI_MIN, BSI_MAX))
    check(schema.row_count == BSI_ROWS, "16-plane field")
    view = frame.create_view_if_not_exists(schema.view)

    def one(s):
        rows, h, fh = truth.planes(s)
        bm = Bitmap()
        for r in range(BSI_ROWS):
            for b in range(16):
                if rows[r, b].any():
                    bm.keys.append(r * 16 + b)
                    bm.containers.append(Container(bitmap=rows[r, b]))
        view.create_fragment_if_not_exists(s).replace(bm)
        return h, fh

    with ThreadPoolExecutor(8) as pool:
        for h, fh in pool.map(one, range(truth.num_slices)):
            truth.hist += h
            truth.fhist += fh
    return time.monotonic() - t0


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
                         "bound_ms": bound_ms, "bound_by": "bytes",
                         "bytes": nbytes,
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

    def raw(self, method: str, path: str, body: str = ""):
        self.conn.request(method, path, body=body.encode())
        resp = self.conn.getresponse()
        return resp.status, json.loads(resp.read())

    def call(self, method: str, path: str, body: str = ""):
        status, doc = self.raw(method, path, body)
        check(status == 200, (method, path, body, status, doc))
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


def collect_after_staging(phase: str) -> float:
    """One full pass of Python's cyclic collector, timed and logged, ms.
    Staging leaves so many new long-lived objects that the collector makes
    a full pass over the whole heap soon after it, longer than a short
    timed window can absorb; the phases run it right after their staging
    query, so that it lands in no timed window, and report what it
    costs."""
    t0 = time.monotonic()
    gc.collect()
    ms = (time.monotonic() - t0) * 1e3
    log(f"{phase}: full collection after staging {ms:.1f} ms")
    return ms


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
        collect_ms = collect_after_staging("slice phase")
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
    for k in DENSE_PATH:
        check(launches[k] > 0, f"kernel {k} launched on the dense path")
    check(stats.get("batched", 0) > 0 and stats.get("shared_batch", 0) > 0,
          "concurrent counts coalesced and shared reads")
    return {"launches": launches, "launches_by_wrapper": by_wrapper,
            "stats": stats, "first_query_s": first_s, "lone_qps": lone_qps,
            "collect_after_staging_ms": collect_ms, "profile": busy,
            "concurrent_qps": conc_qps, "clients": CLIENTS}


# -- phase 5: K4 at the sparse slice's shapes ----------------------------------


def sparse_kernel_phase(holder, sp: SparseRows, device) -> dict:
    """K4 on one pair of frame `sparse` (rows 0 and 1, every container of
    every slice) against its plain version (ops.kernels.sparse_pair_plain
    on the same card tensors), exactly, then both timed. Bound: the
    bytes the pair needs (the real values of both sides, the idx/hit and
    cardinality reads, the output) over the memory rate. Beside it, a
    design figure: the shared-memory lookups of K4's binary searches
    (len_a * ceil(log2 len_b) per container pair) over
    SMEM_LOOKUPS_PER_S."""
    import torch

    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.ops.pool import pack_sparse
    from pilosa_tpu_torch.parallel.mesh import (build_sparse_sharded_index,
                                                dense_row,
                                                resolve_row_indices)

    s = sp.lens.shape[0]
    t0 = time.monotonic()
    staged = build_sparse_sharded_index(
        [pack_sparse(holder.fragment("i", "sparse", "standard", i).storage)
         for i in range(s)], device)
    torch.cuda.synchronize()
    pool_bytes = staged.values.numel() * 2 + staged.cards.numel() * 4
    log(f"sparse kernel phase: staged {pool_bytes / 1e9:.3f} GB sorted-array "
        f"pool (S={s}, C={staged.capacity}, K={staged.value_cap}) in "
        f"{time.monotonic() - t0:.2f} s")
    tables = [resolve_row_indices(staged.keys_host, dense_row(staged, r))
              for r in (0, 1)]
    (ia, ha), (ib, hb) = tables
    ia, ha, ib, hb = (torch.from_numpy(np.ascontiguousarray(t, np.int32))
                      .to(device) for t in (ia, ha, ib, hb))
    args = (staged.values, staged.cards, staged.values, staged.cards, ia, ha,
            ib, hb)
    got, want = tk.sparse_pair_count(*args), tk.sparse_pair_plain(*args)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(err == 0 and got.shape == want.shape == (s, 16),
          f"sparse_pair_count: kernel != plain (max err {err})")
    host = sp.inter((0, 1))
    check((got.cpu().numpy() == host).all(), "sparse_pair_count != host")
    ms = time_ms(lambda: tk.sparse_pair_count(*args), 50)
    plain_ms = time_ms(lambda: tk.sparse_pair_plain(*args), 3)

    la = np.take_along_axis(staged.cards_host, tables[0][0], 1) * tables[0][1]
    lb = np.take_along_axis(staged.cards_host, tables[1][0], 1) * tables[1][1]
    nbytes = (2 * int(la.sum() + lb.sum())   # the real values, once
              + 4 * 4 * s * 16               # idx/hit of both sides
              + 2 * 4 * s * 16               # one card per side and pair
              + 4 * s * 16)                  # the output
    both = (la > 0) & (lb > 0)
    lookups = int((la[both].astype(np.int64)
                   * np.ceil(np.log2(np.maximum(lb[both], 2)))).sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    lookups_ms = lookups / SMEM_LOOKUPS_PER_S * 1e3
    # The lookups are the binary-search design's own work; a merge of the
    # two sorted arrays needs ~la + lb steps, far under the byte time, so
    # the function's floor is the bytes.
    res = {"kernel": "sparse_pair_count", "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bytes_ms, "bound_by": "bytes",
           "bytes": nbytes, "bytes_bound_ms": bytes_ms, "lookups": lookups,
           "lookups_bound_ms": lookups_ms, "max_abs_err": err,
           "pairs": s * 16, "pool_bytes": pool_bytes,
           "dense_image_bytes": s * staged.capacity * 2048 * 4}
    log(f"  sparse_pair_count {ms:8.4f} ms  bound {bytes_ms:.4f} ms (bytes); "
        f"binary-search lookups {lookups_ms:.4f} ms  plain {plain_ms:.3f} ms"
        f"  exact")
    del staged, args, ia, ha, ib, hb
    torch.cuda.empty_cache()
    return res


# -- phase 6: the sparse slice over HTTP -----------------------------------------


# A tree only the dense kernels fold: it demotes frame `sparse`.
TRI = ("Count(Intersect(Bitmap(rowID=0, frame=sparse), "
       "Bitmap(rowID=1, frame=sparse), Bitmap(rowID=2, frame=sparse)))")


def fpql(op: str, a: int, fa: str, b: int, fb: str) -> str:
    return (f"Count({OPS[op]}(Bitmap(rowID={a}, frame={fa}), "
            f"Bitmap(rowID={b}, frame={fb})))")


def sparse_answers(words: np.ndarray, sp: SparseRows) -> dict:
    """Host answers of the sparse phase's queries, by PQL."""
    want = {}
    odd = words[1::2]
    for a, b in itertools.combinations(range(SPARSE_ROWS), 2):
        want[fpql("and", a, "sparse", b, "sparse")] = int(
            sp.inter((a, b)).sum())
    for op in ("or", "andnot"):
        for a, b in ((0, 1), (SPARSE_PARTIAL, 0), (0, SPARSE_PARTIAL)):
            want[fpql(op, a, "sparse", b, "sparse")] = op_count(
                op, sp.inter((a, b)), sp.card(a), sp.card(b))
    want[fpql("and", SPARSE_PARTIAL, "sparse", 0, "sparse")] = int(
        sp.inter((SPARSE_PARTIAL, 0)).sum())
    ng = np.bitwise_count(words[:, 1]).sum(axis=2).astype(np.int64)
    inter = sp.probe(2, words, 1)
    for op in OPS:
        want[fpql(op, 2, "sparse", 1, "general")] = op_count(
            op, inter, sp.card(2), ng)
        want[fpql(op, 1, "general", 2, "sparse")] = op_count(
            op, inter, ng, sp.card(2))
    want[fpql("and", 50, "sparse", 0, "sparse")] = 0
    want[fpql("or", 50, "sparse", 0, "sparse")] = int(sp.card(0).sum())
    want["Count(Bitmap(rowID=3, frame=sparse))"] = int(sp.card(3).sum())
    even = sp.inter((0, 1))[0::2]
    for op in OPS:
        want[fpql(op, 0, "mixed", 1, "mixed")] = op_count(
            op, even, sp.card(0)[0::2], sp.card(1)[0::2]) + host_count(
            odd, op, 0, 1)
    want[TRI] = int(sp.inter((0, 1, 2)).sum())
    return want


def sparse_phase(holder, words: np.ndarray, sp: SparseRows, card: str,
                 device) -> dict:
    """The sorted-array path through the normal entry points. Counters are
    set to 0 just before and read just after; the single leaf must
    launch nothing, and the pair after the demote must run K1."""
    import torch

    from pilosa_tpu_torch.api.server import serve
    from pilosa_tpu_torch.ops import kernels as tk

    t0 = time.monotonic()
    want = sparse_answers(words, sp)
    log(f"sparse phase: host answers in {time.monotonic() - t0:.2f} s")
    srv = serve(holder, device=device)
    host, port = srv.address
    mgr = srv.handler.executor.mesh_manager()
    c = Client(host, port)

    def ask(q):
        got = c.count(q)
        check(got == want[q], (q, got, want[q]))

    try:
        pairs = [fpql("and", a, "sparse", b, "sparse")
                 for a, b in itertools.combinations(range(SPARSE_ROWS), 2)]
        t0 = time.monotonic()
        ask(pairs[0])  # stages the view
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        sv = mgr._views[("i", "sparse", "standard")]
        check(sv.sparse is not None and bool(sv.slice_formats.all())
              and sv.sharded.capacity == 0, "frame sparse staged sorted")
        staged_bytes = sv.sparse.values.numel() * 2 + \
            sv.sparse.cards.numel() * 4
        log(f"sparse phase: first query (staging {staged_bytes / 1e9:.3f} "
            f"GB) {first_s:.2f} s")
        collect_ms = collect_after_staging("sparse phase")
        before = dict(mgr.stats)
        tk.reset_launches()
        t0 = time.monotonic()
        for q in pairs * 2:
            ask(q)
        lone_qps = 2 * len(pairs) / (time.monotonic() - t0)
        conc_qps = [concurrent(host, port, pairs, [want[q] for q in pairs])]
        busy = profiled(lambda: conc_qps.append(
            concurrent(host, port, pairs, [want[q] for q in pairs])))
        leaf = "Count(Bitmap(rowID=3, frame=sparse))"
        for q in want:
            if q in pairs or q in (leaf, TRI):
                continue
            ask(q)
        k_before = dict(tk.LAUNCHES)
        ask(leaf)
        torch.cuda.synchronize()
        check(dict(tk.LAUNCHES) == k_before, "single leaf launched nothing")
        mixed = mgr._views[("i", "mixed", "standard")]
        check(list(mixed.slice_formats[:4]) == [1, 0, 1, 0],
              "mixed: even slices sorted, odd slices dense")
        stats = {k: n - before.get(k, 0) for k, n in mgr.stats.items()}
        # A three-leaf tree demotes `sparse` to packed words ...
        ask(TRI)
        sv = mgr._views[("i", "sparse", "standard")]
        check(sv.sparse is None and mgr.stats["sparse_demote"] == 1,
              "three-leaf tree demoted frame sparse")
        dense_bytes = sv.sharded.words.numel() * 4
        # ... and a pair over it then runs K1.
        k_before = dict(tk.LAUNCHES)
        ask(pairs[1])
        torch.cuda.synchronize()
        check(tk.LAUNCHES["coarse_count"] > k_before["coarse_count"]
              and tk.LAUNCHES["sparse_pair_count"]
              == k_before["sparse_pair_count"], "demoted pair ran K1")
        launches = dict(tk.LAUNCHES)
        all_stats = dict(mgr.stats)
    finally:
        c.close()
        srv.close()
    log(f"sparse phase on {card}: lone {lone_qps:.1f} QPS, {CLIENTS} clients "
        f"{conc_qps[0]:.1f} / {conc_qps[1]:.1f} QPS; staged "
        f"{staged_bytes} B sorted-array vs {dense_bytes} B dense image")
    log(f"sparse phase launches {launches}")
    log(f"sparse phase profile (second {CLIENTS}-client round): device "
        f"busy {busy['device_busy_s']:.4f} s of {busy['wall_s']:.4f} s "
        f"wall = {busy['device_busy_share']:.4f}")
    log(f"sparse phase stats {json.dumps(all_stats, sort_keys=True)}")
    for k in SPARSE_PATH:
        check(launches[k] > 0, f"kernel {k} launched on the sparse path")
    check(stats.get("sparse_count", 0) > 0, "sparse counts served")
    for group in ("ss", "sd", "ds", "dd"):
        check(stats.get(f"sparse_group:{group}", 0) > 0,
              f"format group {group} served")
    check(all_stats["sparse_demote"] == 1, "one demote")
    return {"launches": launches, "stats": all_stats,
            "first_query_s": first_s, "lone_qps": lone_qps,
            "collect_after_staging_ms": collect_ms,
            "concurrent_qps": conc_qps, "profile": busy, "clients": CLIENTS,
            "staged_bytes_sparse": staged_bytes,
            "staged_bytes_dense_image": dense_bytes}


# -- phase 7: K5, K1 on a Range tree, and K0 at the integer field's shapes ------


def bsi_kernel_phase(holder, truth: BsiTruth, device, seed: int) -> dict:
    """K5's flat pair for each op (random words, 126 MB a side) and its
    serving form over the staged `bsi.val` view as the Sum runs it; K1
    on the canonical tree of Count(Range(val > 1000)); the K0 canary.
    Each against its plain version on the same card tensors, exactly,
    then both timed. Bounds: each input byte once over the memory rate
    (K5's popcount and bitwise op per 16 bytes are far under the card's
    integer rate)."""
    import torch

    from pilosa_tpu_torch.bsi import cond_tree, to_shape
    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.ops.cuda_build import kernel_fn
    from pilosa_tpu_torch.ops.pool import pack_bitmap
    from pilosa_tpu_torch.parallel.mesh import (build_sharded_index,
                                                container_table, dense_row,
                                                leaf_layout)
    from pilosa_tpu_torch.parallel.plan import canonical_tree

    s = truth.num_slices
    t0 = time.monotonic()
    view = f"bsi.{BSI_FIELD}"
    staged = build_sharded_index(
        [pack_bitmap(holder.fragment("i", "general", view, i).storage)
         for i in range(s)], device)
    torch.cuda.synchronize()
    log(f"bsi kernel phase: staged {staged.words.numel() * 4 / 1e9:.3f} GB "
        f"(S={s}, cap={staged.capacity}) in {time.monotonic() - t0:.2f} s")
    pool = staged.words
    lay = [leaf_layout(staged.keys_host, dense_row(staged, r))
           for r in range(BSI_ROWS)]
    ones = np.ones(s, dtype=np.int64)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    tables = [container_table(lay, ones), container_table(lay[2:], ones),
              container_table(lay[1:2], ones)[0]]
    # Bytes of the containers present (K5 reads no absent one): the top
    # plane of a uniform 16-bit field is nearly empty (only -32768 sets
    # it), so the view holds ~17 full rows.
    rows_b, planes_b, sign_b = (int((t >= 0).sum()) * 8192 for t in tables)
    a_all, a_planes, sign_idx = (dev(t) for t in tables)
    block = dev(truth.words[:, 0].view(np.int32).reshape(s, 16, 2048))
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand_words(m):
        return torch.randint(-2**31, 2**31, (m, 2048), dtype=torch.int32,
                             device=device, generator=gen)

    fa, fb = rand_words(FLAT_M + 1), rand_words(FLAT_M + 1)
    a, b = fa[:FLAT_M], fb[:FLAT_M]
    cells = 16 * s
    idx_b = 4 * 16 * s  # one int32 container index per (row, slice, block)
    cases = [
        ("pair_count_rows (Sum, no b)", "pair_count",
         lambda: tk.pair_count_rows(pool, a_all),
         lambda: tk.pair_rows_plain(pool, a_all, "and", None, None, None),
         rows_b + BSI_ROWS * idx_b + 8 * BSI_ROWS),
        ("pair_count_rows (sign pass, b = sign row)", "pair_count",
         lambda: tk.pair_count_rows(pool, a_planes, "and", b_pool=pool,
                                    b_idx=sign_idx),
         lambda: tk.pair_rows_plain(pool, a_planes, "and", pool, sign_idx,
                                    None),
         planes_b + sign_b + (BSI_ROWS - 1) * idx_b + 8 * 16),
        ("pair_count_rows (filtered Sum, b = block)", "pair_count",
         lambda: tk.pair_count_rows(pool, a_all, "and", b_block=block),
         lambda: tk.pair_rows_plain(pool, a_all, "and", None, None, block),
         rows_b + s * RUN_BYTES + BSI_ROWS * idx_b + 8 * BSI_ROWS),
    ]
    for op in ("and", "or", "xor", "andnot"):
        cases.append((f"pair_count {op} ({FLAT_M}, 2048)", "pair_count",
                      lambda op=op: tk.pair_count(a, b, op),
                      lambda op=op: tk.pair_count_plain(a, b, op),
                      2 * FLAT_M * 8192 + 8))
    cases.append((f"pair_count and ({FLAT_M + 1}, 2048)", "pair_count",
                  lambda: tk.pair_count(fa, fb, "and"),
                  lambda: tk.pair_count_plain(fa, fb, "and"),
                  2 * (FLAT_M + 1) * 8192 + 8))
    # The tree Count(Range(val > 1000)) runs: 18 distinct rows after
    # dedupe. The nearly empty top plane is not a whole run in every
    # slice, so the serving path gathers per container (K3), as here.
    raw: list = []
    leaves: list = []
    tree = canonical_tree(to_shape(cond_tree(
        holder.index("i").frame("general").bsi_field(BSI_FIELD), ">", 1000),
        "general", view, raw), raw, leaves)
    r_lay = [lay[lf[2]] for lf in leaves]
    r_pools = (pool,) * len(leaves)
    r_idx = dev(np.stack([x.idx for x in r_lay])[None])
    r_hit = dev(np.stack([x.hit for x in r_lay])[None])
    cases.append(("tree_count_per_slice (Range val > 1000)", "tree_count",
                  lambda: tk.tree_count_per_slice(r_pools, r_idx, r_hit, tree),
                  lambda: tk.tree_plain(r_pools, r_idx, r_hit, tree),
                  int(sum(x.hit.sum() for x in r_lay)) * 8192
                  + 2 * r_idx.numel() * 4 + 4 * s))
    results = {}
    for name, kernel, run, plain, nbytes in cases:
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0 and got.shape == want.shape,
              f"{name}: kernel != plain (max err {err})")
        ms = time_ms(run, 20)
        plain_ms = time_ms(plain, 1 if "rows" in name else 3)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        results[name] = {"kernel": kernel, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": "bytes",
                         "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6,
                         "max_abs_err": err, "library_ms": None}
        log(f"  {name:42s} {ms:8.4f} ms  {nbytes / ms / 1e6:7.1f} GB/s  "
            f"bound {bound_ms:.4f} ms  plain {plain_ms:.3f} ms  exact")
    check(len(leaves) == BSI_ROWS, f"Range tree has {len(leaves)} leaves")
    # The Sum's plane counts against the truth.
    counts = tk.pair_count_rows(pool, a_all).tolist()
    check(counts[0] == int(truth.hist.sum()), "existence count = truth")
    # K0: the canary kernel alone, launched on a standing tensor; its
    # plain version and the one PyTorch call that does the same (x + 1).
    x = torch.zeros((8, 128), dtype=torch.int32, device=device)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(device).cuda_stream
    check(tk.probe_ok(device), "probe_ok")
    ms = time_ms(lambda: kernel_fn("probe_ok")(x.data_ptr(), x.numel(),
                                                stream), 50)
    results["probe_ok"] = {
        "kernel": "probe_ok", "ms": ms,
        "plain_ms": time_ms(lambda: tk.probe_plain(x), 50),
        "library_ms": time_ms(lambda: torch.add(x, 1, out=y), 50),
        "bound_ms": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "bytes": 2 * x.numel() * 4, "max_abs_err": 0}
    log(f"  probe_ok {ms:.4f} ms per launch, plain "
        f"{results['probe_ok']['plain_ms']:.4f} ms")
    del staged, pool, a_all, a_planes, block, fa, fb, a, b, r_pools, r_idx
    torch.cuda.empty_cache()
    return results


# -- phase 8: the integer-field slice over HTTP ---------------------------------

RANGE_CONSTS = (-32769, -32768, -32767, -1000, -1, 0, 1, 1000, 32766, 32767,
                32768)
BETWEEN = ((-1000, 1000), (BSI_MIN, BSI_MAX), (5, 5), (10, -10))
FILTER = "Bitmap(frame=general, rowID=0), "


def agg_pql(name: str, filtered: bool) -> str:
    return (f"{name}({FILTER if filtered else ''}frame=general, "
            f'field="{BSI_FIELD}")')


def range_pql(op: str, c) -> str:
    arg = f"[{c[0]}, {c[1]}]" if op == "><" else str(c)
    return f"Count(Range(frame=general, {BSI_FIELD} {op} {arg}))"


def bsi_phase(holder, truth: BsiTruth, card: str, device) -> dict:
    """The integer field through the normal entry points. Counters are
    set to 0 just before the server starts (it launches K0) and read
    after the last query."""
    import torch

    from pilosa_tpu_torch.api.server import serve
    from pilosa_tpu_torch.ops import kernels as tk

    tk.reset_launches()
    srv = serve(holder, device=device)
    host, port = srv.address
    ex = srv.handler.executor
    c = Client(host, port)
    aggs = [(n, f) for f in (False, True) for n in ("Sum", "Min", "Max")]
    ranges = [(op, k) for op in (">", ">=", "<", "<=", "==", "!=")
              for k in RANGE_CONSTS] + [("><", k) for k in BETWEEN]

    def ask_aggs():
        for name, filt in aggs:
            got = c.count(agg_pql(name, filt))
            want = truth.aggregate(name, filt)
            check(got == want, (name, filt, got, want))

    def timed(q, n):
        t0 = time.monotonic()
        for _ in range(n):
            c.count(q)
        return (time.monotonic() - t0) / n * 1e3

    try:
        t0 = time.monotonic()
        got = c.count(agg_pql("Sum", False))  # stages the view
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        check(got == truth.aggregate("Sum", False), ("first Sum", got))
        log(f"bsi phase: first Sum (staging {BSI_ROWS} rows) {first_s:.2f} s")
        collect_ms = collect_after_staging("bsi phase")
        ask_aggs()
        t0 = time.monotonic()
        for op, k in ranges:
            got = c.count(range_pql(op, k))
            want = truth.range_count(op, k)
            check(got == want, (op, k, got, want))
        range_ms = (time.monotonic() - t0) / len(ranges) * 1e3
        ms = {"Sum": timed(agg_pql("Sum", False), 20),
              "Sum filtered": timed(agg_pql("Sum", True), 20),
              "Min": timed(agg_pql("Min", False), 5),
              "Max filtered": timed(agg_pql("Max", True), 5),
              "Count(Range(val > 1000))": timed(range_pql(">", 1000), 20),
              "Range, all ops (mean)": range_ms}
        busy = profiled(lambda: timed(agg_pql("Sum", False), 20))
        # Writes: overwrite an existing value, flip its sign, write the
        # field's edges into columns with and without a value, rewrite a
        # column twice; then a refused one changes nothing.
        last = truth.num_slices - 1
        cols = [5, (1 << 20) * min(17, last) + 3, (1 << 20) * last + 77,
                1 << 20, 123_456]
        writes = [(cols[0], 31000), (cols[1], -32768), (cols[2], 32767),
                  (cols[3], 0), (cols[4], -5), (cols[4], 17)]
        for col, v in writes:
            had = truth.value(col)
            got = c.count(f"SetValue(frame=general, columnID={col}, "
                          f"{BSI_FIELD}={v})")
            check(got is (had != v), ("SetValue", col, v, got, had))
            truth.set_value(col, v)
        status, doc = c.raw("POST", "/index/i/query",
                            f"SetValue(frame=general, columnID=9, "
                            f"{BSI_FIELD}=40000)")
        check(status == 422, ("out-of-range SetValue", status, doc))
        t0 = time.monotonic()
        ask_aggs()
        restage_s = time.monotonic() - t0
        for op, k in ((">=", 31000), ("==", -32768), ("==", 32767),
                      ("<", 0), ("!=", 0)):
            got = c.count(range_pql(op, k))
            check(got == truth.range_count(op, k), (op, k, got))
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        stats = dict(ex.stats)
        mstats = dict(ex.mesh_manager().stats)
    finally:
        c.close()
        srv.close()
    log(f"bsi phase on {card}: ms per query {json.dumps(ms)}; aggregates "
        f"after the writes (restage included) {restage_s:.2f} s")
    log(f"bsi phase launches {launches}; executor {stats}")
    log(f"bsi phase profile (20 Sums): device busy "
        f"{busy['device_busy_s']:.4f} s of {busy['wall_s']:.4f} s wall = "
        f"{busy['device_busy_share']:.4f}")
    for k in BSI_PATH:
        check(launches[k] > 0, f"kernel {k} launched on the bsi path")
    check(stats.get("count_host", 0) == 0 and stats.get("bsi_host", 0) == 0,
          "nothing counted on the host")
    return {"launches": launches, "stats": stats, "mesh_stats": mstats,
            "first_query_s": first_s, "collect_after_staging_ms": collect_ms,
            "ms_per_query": ms, "after_writes_s": restage_s, "profile": busy}


# -- main ----------------------------------------------------------------------


def dense_qps_only(root: Path, card: str, smi: str, seed: int) -> int:
    """Phase 4 alone, served by the package under `root`, and its QPS as
    one JSON line: run it once per tree, alternating, to compare two
    trees' dense serving in one call."""
    import torch

    words = make_words(SLICES, seed)
    with tempfile.TemporaryDirectory() as tmp:
        holder = build_holder(tmp, words)
        try:
            sl = slice_phase(holder, words, card, torch.device("cuda"))
        finally:
            holder.close()
    busy = sl["profile"]["device_busy_share"]
    print(json.dumps({"dense_qps_of": str(root), "card": smi,
                      "first_query_s": sl["first_query_s"],
                      "collect_after_staging_ms":
                          sl["collect_after_staging_ms"],
                      "lone_qps": sl["lone_qps"],
                      "concurrent_qps": sl["concurrent_qps"],
                      "device_busy_share": busy}), flush=True)
    return 0


def lone_latency_only(root: Path, smi: str, seed: int) -> int:
    """The dense slice's lone Counts alone, served by the package under
    `root`, as one JSON line: the collector's automatic full passes from
    the end of staging on (offset from it and length) and whether one fell
    in the first window of 56 lone requests (the slice phase's lone
    window, answers checked); then one full collection and 560 more lone
    requests, their median, p90 and mean latency and QPS. Run it
    alternately on two checkouts to compare their lone serving."""
    import torch

    from pilosa_tpu_torch.api.server import serve

    words = make_words(SLICES, seed)
    pairs = list(itertools.combinations(range(DENSE_ROWS), 2))
    qs = [pql("and", a, b) for a, b in pairs]
    want = [host_count(words, "and", a, b) for a, b in pairs]
    passes, begun = [], []

    def on_pass(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                begun.append(time.monotonic())
            else:
                passes.append((begun[-1], time.monotonic() - begun[-1]))

    def lone(queries, answers):
        lat = []
        for q, w in zip(queries, answers):
            t0 = time.monotonic()
            got = c.count(q)
            lat.append(time.monotonic() - t0)
            check(w is None or got == w, (q, got, w))
        return lat

    with tempfile.TemporaryDirectory() as tmp:
        holder = build_holder(tmp, words)
        srv = serve(holder, device=torch.device("cuda"))
        c = Client(*srv.address)
        gc.callbacks.append(on_pass)
        try:
            c.count(qs[0])  # stages the view
            staged = time.monotonic()
            first = lone(qs * 2, want * 2)
            first_end = time.monotonic()
            auto = list(passes)
            collect_ms = collect_after_staging("lone latency")
            t0 = time.monotonic()
            lat = sorted(lone(qs * 20, [None] * len(qs) * 20))
            wall = time.monotonic() - t0
        finally:
            gc.callbacks.remove(on_pass)
            c.close()
            srv.close()
            holder.close()
    print(json.dumps({
        "lone_latency_of": str(root), "card": smi,
        "passes_after_staging": [
            {"at_s": t - staged, "ms": d * 1e3} for t, d in auto],
        "pass_in_first_window": any(staged <= t <= first_end
                                    for t, _ in auto),
        "first_window_qps": len(first) / (first_end - staged),
        "collect_ms": collect_ms, "n": len(lat),
        "median_ms": lat[len(lat) // 2] * 1e3,
        "p90_ms": lat[int(0.9 * len(lat))] * 1e3,
        "mean_ms": sum(lat) / len(lat) * 1e3,
        "qps": len(lat) / wall}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--dense-qps-of", metavar="ROOT", type=Path,
                    help="run only phase 4, served by the pilosa_tpu_torch "
                         "package under ROOT (a checkout of any commit), "
                         "and print its QPS as one JSON line")
    ap.add_argument("--lone-latency-of", metavar="ROOT", type=Path,
                    help="run only the dense slice's lone Counts, served "
                         "by the package under ROOT, and print their "
                         "latency and the collector's passes as one JSON "
                         "line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    root = (args.dense_qps_of or args.lone_latency_of or REPO).resolve()
    sys.path.insert(0, str(root))
    from pilosa_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.monotonic()
    cuda_build.build_all()
    log(f"build: {len(cuda_build.BUILD_SECONDS)} libraries in "
        f"{time.monotonic() - t0:.2f} s "
        f"{json.dumps(cuda_build.BUILD_SECONDS)}")
    if args.dense_qps_of:
        return dense_qps_only(root, card, smi, args.seed)
    if args.lone_latency_of:
        return lone_latency_only(root, smi, args.seed)
    from pilosa_tpu_torch.ops import kernels as tk

    check(tk.probe_ok(torch.device("cuda")), "K0 canary")
    log("K0 canary: ok")

    device = torch.device("cuda")
    t0 = time.monotonic()
    words = make_words(SLICES, args.seed)
    sp = SparseRows(SLICES, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        holder = build_holder(tmp, words)
        try:
            add_sparse_frames(holder, words, sp)
            log(f"data: {SLICES} slices ({SLICES << 20} columns) in "
                f"{time.monotonic() - t0:.2f} s")
            kern = kernel_phase(holder, words, device, args.seed)
            sl = slice_phase(holder, words, card, device)
            kern["sparse_pair_count"] = sparse_kernel_phase(holder, sp,
                                                            device)
            sps = sparse_phase(holder, words, sp, card, device)
            truth = BsiTruth(SLICES, args.seed, words)
            gen_s = add_bsi_field(holder, truth)
            log(f"bsi data: {SLICES} slices of field {BSI_FIELD} made, "
                f"packed and injected in {gen_s:.2f} s")
            kern.update(bsi_kernel_phase(holder, truth, device, args.seed))
            bsi = bsi_phase(holder, truth, card, device)
            bsi["data_s"] = gen_s
        finally:
            holder.close()

    # Each kernel's launches come from the path it serves.
    served = {"sparse_pair_count": sps, "probe_ok": bsi, "pair_count": bsi}
    launches = {k: served.get(k, sl)["launches"][k] for k in KERNELS}
    entries = []
    for name, (source, replaces) in KERNELS.items():
        rows = {w: r for w, r in kern.items() if r["kernel"] == name}
        main_row = next(iter(rows.values()))
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row.get("library_ms")})
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "slices": SLICES,
         "seed": args.seed, "build_s": cuda_build.BUILD_SECONDS,
         "wrappers": kern, "slice": sl, "sparse_slice": sps,
         "bsi_slice": bsi,
         "kernels": entries}, indent=1))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
