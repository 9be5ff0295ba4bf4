#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (pilosa_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N] [--dense-qps-of ROOT | --lone-latency-of
                          ROOT | --sparse-qps-of ROOT | --kernel-times-of ROOT]

Phases, each fatal on failure:
  1. the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from pilosa_tpu_torch/csrc with nvcc (each
     library's ptxas report of registers, stack and spills goes to
     chiprun_out/ptxas/), and run the K0 canary (ops.kernels.probe_ok);
  3. kernels: every wrapper on the card at the main path's shapes, held
     exactly against its plain PyTorch version, and timed (CUDA events
     over back-to-back calls, and the profiler's device time, left null
     when its trace misses launches); K2 also
     at its wide shape, 16 unique runs under 16 queries of a 4-leaf tree;
     then K1's slice sweep (S in 24, 96, 240, 960 x a lone pair, the
     29-leaf OR of a time cover and a 16-query uniform batch, over
     random runs; at 960 also the per-slice form fed the uniform starts
     expanded on the card) and K3's (a pair and the 29-leaf OR, 3 in 4
     containers present, over the same slice counts, gathered and over a
     container table, and a tree of Count(Range(val > 1000))'s shape at
     960 slices), each held exactly against its plain version beside its
     byte bound. The ptxas report of K1, K3 and K6 must show no spill;
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
     plain version and the host and timed, with its byte bound;
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
  7. the card-memory governor over HTTP at 960 slices: index `r` gets a
     copy of `general`, and four views (`general` dense, `sparse`
     sorted-array, `mixed`, `r`'s `general`; 3.21 GB) are served under a
     budget of 60% of their bytes (serve(..., hbm_budget_bytes=)): 2
     round-robin rounds of a Count(Intersect) on each, every answer
     equal to numpy, evictions required, and after each Count the staged
     bytes within the budget (over it by one view at most while a query
     holds its views) and torch.cuda.memory_allocated following them
     within 64 MB; then 16 clients at once, a Count on every frame each.
     Then a real torch.cuda.OutOfMemoryError: a ballast leaves less free
     memory than `general` needs, but enough with `sparse` and `mixed`
     evicted, and the ladder stages it on its retry (exact, on the
     card); with only `mixed` resident and too little memory even
     without it, the host answers (fallback_oom). A budget below one
     view answers on the host with nothing staged, and ?explain=true
     says why; DELETE /index/r/frame/general frees that view's bytes
     within 1 MB, and the frame recreated under its name answers from
     its new data. K1 and K4 must launch. Every other serving phase must
     end with fallback_oom, fallback_hbm_infeasible,
     fallback_quarantined and plan_quarantined at 0;
  8. K5 (pair_count) at the integer field's shapes: the flat pair of each
     op at (15,360, 2048) and at an M that is no multiple of a block, and
     the serving form over the staged `bsi.val` view as the Sum runs it
     (no b, b = the sign row, b = a filter block); plus K3 on the
     canonical tree of Count(Range(val > 1000)) (over the view's row
     table, as the serving path runs it, and gathered; with device
     time) and the K0 canary. Each held exactly against its plain version
     and timed beside its bound;
  9. the integer-field slice over HTTP: field `val` of frame `general`
     (min -32768, max 32767: 16 planes; uniform values in half the
     columns of all 960 slices, made slice by slice from the seed) serves
     Sum, Min and Max with and without the filter Bitmap(frame=general,
     rowID=0), Count(Range(val op c)) for all seven operators with
     constants on both sides of 0 and at the edges, then a handful of
     SetValue writes (and a refused one) and the aggregates again. Every
     answer is checked against the numpy truth; K0 (at server start), K5
     and K1 must launch, `count_host` must not move, and torch.profiler
     measures the card's busy share of a round of Sums;
 10. time-quantum Range over HTTP: index `tq` (quantum YMD, inherited by
     its frame `events`) of 96 slices, rows 0-3, each (row, day) of April
     2017 a seeded random 1/64 of the columns: the 30 day views stage
     sorted-array, the month, the year and `standard` dense. Every single
     day (no launch), the month (one view), 2 days (K4), 7 days (the days
     demote to packed words: K1) and 29 days (K1's lone path), then
     timestamped SetBits seen through GET .../views and Ranges (one over
     a view that does not exist) and quantum inheritance over HTTP. Every
     answer is checked against numpy; K1 and K4 must launch, no Range
     may count on the host, and the staged and demoted bytes are
     recorded. Then the path's kernels at its shapes, as the manager
     resolves them: K1 over the 7- and 29-day covers (one demoted day
     view a leaf), K4 over the 2-day pair (two sorted-array day views),
     and K1 on the 29-leaf tree over 29 random runs of the headline's 960
     slices; each held exactly against its plain version and the truth,
     and timed beside its bound;
 11. TopN over HTTP: lone TopN(frame=general, n=100) on the 960 slices
     of phase 4 (p50 / p90 of 200 calls), then index `t`, frame `topn`
     (the repo's TopN configuration: 4096 rows, one container per row
     per slice, ~30% bitmaps of ~25% fill, the rest arrays of
     n ~ U[1, 4096], 10% absent; 64 slices) in every form: n, threshold,
     ids, a src Bitmap, field / filters after SetRowAttrs over HTTP on
     100 rows (and a Bitmap's attrs), tanimotoThreshold. Every answer is
     checked against numpy with the card path's semantics; every TopN
     must run on the card and launch K5, which is then held exactly
     against its plain version and the truth at the `topn` shape and at
     `general`'s (10 rows x 960 slices) and timed beside its byte bound
     and the index table's bytes; torch.profiler measures the card's
     busy share of a round of TopNs;
 12. writes over HTTP on frame `general` at 960 slices, under the
     holder's `group` WAL policy (the server's default; the bulk loads
     go through Fragment.replace and write no op records): 90 rounds,
     each a batch of 1, 16 or 256 SetBit / ClearBit calls into existing
     containers of rows 0-7 from up to 16 clients, then a Count(
     Intersect) held against numpy with the writes applied and timed
     (p50 / p90); every round's refresh must be a scatter (one K7
     launch, the manager's stats deltas). Then a write into a new row
     (a restage, timed beside the scatters), then 16 clients at once
     SetBit-ing into the newest slice (write QPS, fsyncs, ops per
     commit). K7 is held exactly against its plain version at the
     rounds' batch shapes, at (960, 1024) entries and over 8-4096 unique
     sorted entries a slice, and timed beside its byte bound and the
     scattered-sector probe over the same sectors (csrc/sector_probe.cu,
     a measurement, not a kernel). The bsi phase's SetValues also
     scatter; the time phase's writes into sorted-array day views
     restage, by design;
 13. durability and integrity at 960 slices under `group`: index `i`,
     frame `general` (the headline rows after phase 12's writes, and a
     mask row 21 of 40,000 columns in each of slices 0-3 where row 0 is
     clear and row 1 set, so that each SetBit there adds one to Count(
     Intersect(row 0, row 1)) and the bits a run kept are Intersect(
     row 0, row 21)) written to a new directory as footered
     snapshots, and index `d2`. (1) 16 clients SetBit into slices 0-3
     until each fragment has taken 1 background snapshot at the default
     max_op_n while one client counts without pause: every Count lies
     between the truth with the writes acked before it and with those
     sent before its answer, the last is exact, the side .wal files are
     gone, and no restage but the cost gate's (the snapshots move no
     generation); snapshot ms, write-ack ms inside and outside snapshot
     windows and Count ms are printed, and K7 is held against its plain
     version at the largest batch. (2) Backpressure: DUR_STALL armed
     through the spec syntax with max_wal_ops 256: all 16 writers get
     503 with Retry-After, and the Count keeps every acked write. (3)
     Power loss: the server as a child process on the card with
     PILOSA_TORCH_FAULT arming SIGKILL before the 301st commit fsync,
     the 2nd snapshot fsync and the 2nd snapshot rename in turn
     (--max-op-n 500), 16 HTTP writers until it dies; each restart on
     the same directory keeps every acked bit and nothing unsent, and
     its Count (K1) and partial-row Count (K3) equal the truth with the
     kept writes (K0 at each start; open and first-Count times printed).
     (4) A byte flipped in a loaded fragment's file is found by a scrub
     pass and rewritten from memory, the Count unchanged; one flipped at
     rest makes the Count over index `i` answer 500 and `d2` still
     answers. (5) On the main holder with shadow sampling 1 in 1: the
     lone Count, 4 clients at once over the 6 pairs of rows 0-3, a
     `sparse` Count (K4),
     TopN(n=100) and Sum (K5), all checked with no mismatch; a delta=5
     fault at the result seam is served as the host value, quarantines
     the plan (?explain) and the next Count of that shape folds on the
     host; then the lone Count's p50 at 1 in 1, 1 in 100 and 0.
     K7, K1, K3 and K0 must launch on this path (the children's counts
     from their /debug/vars);
 14. bulk data in and out, on a new holder and a server on the card
     (frames and files through the port's HTTP routes, InternalClient
     and ctl): (1) frame `sparse`'s rows 0-7 at slices 0-479 (~94M
     bits) into index `imp` as one protobuf POST /import a slice, from 4
     InternalClient threads in a spawned process of their own (MB/s,
     bits/s, request p50), then the first Count's staging, the 28 pairs
     lone and from 16 clients (K4, sorted-array); (2) 1,000 bits
     imported into slice 17 of that staged view: the next Count
     restages (stat `stage`), exact, and TopN(n=8) on K5; (3) `ctl
     import --create` of a 250,000-line CSV (rows 0-3, 96 slices,
     minutes of April 2017 as local time) into index `tqi` (quantum YMD)
     on a server of its own: one day, 7 days and the month on rows 0
     and 3 equal numpy through the same conversion, with the kernels
     each launched, and `ctl export` gives the imported set; (4) `ctl
     backup` of index `i`'s `general` (960 slices) from a server on the
     main holder and `ctl restore` into index `rst`: every restored file
     equals its backed-up data member, and the pair (K1), the partial
     row (K3) and the 28 pairs from 16 clients (K2) equal numpy (backup
     and restore MB/s); (5) POST /index/fr/frame/general/restore?host=
     from a third server holding 96 slices of the headline rows (a cut
     for time); (6) GET /export of slices 0-3 byte for byte, the block
     digests and block data (JSON, protobuf) of slice 0 against numpy.
     Then K5 at the imported frame's shape against its plain version.
     The main holder's index `tq` is dropped first: a fragment holds two
     file descriptors. K4, K5, K1, K2, K3 and K0 must launch;
 15. the node from its config: `ctl config` parsed by the port's
     Config and by tomllib (to_toml of the parse equals it) and `ctl
     server --dry-run -c node.toml -b ADDR` (the flag over the TOML);
     then `python -m pilosa_tpu_torch.ctl server -c node.toml` as a
     child process on the card, over a new directory of the headline
     rows at 960 slices written as footered snapshots (as phase 13's),
     with [mesh] hbm-budget-bytes at 1.5x `general`'s staged bytes,
     [storage] group fsyncs and max-op-n 500, [integrity] shadow 1 in
     10, [log] JSON into chiprun_out/node.log and a declared
     [[schema.indexes]] cfg/f/val in [-1000, 1000] (the spawn-to-
     /version seconds; /schema shows the field; every log line is
     JSON): the pair (K1, lone p50 and QPS over the 28 pairs), the
     partial row (K3), the 28 pairs spread over 16 clients, once
     (K2; 1 in 10 Counts pays a shadow fold); on cfg/f,
     SetValue on 2,000 columns over 96 slices, Sum (K5),
     Count(Range(val > 100)) (K3), 100 more SetValues and Sum again
     (K7 scatters them into the staged field), all against numpy; `ctl
     bench` set-bit 1,000, intersect-count 200 (K4: rows of 1,000 bits
     in one container stage as sorted arrays) and topn 200, then the
     Count and TopN(n=10) on index `bench` against numpy over its
     export; 20 scrapes of /metrics (p50 ms), each parsed as text
     format 0.0.4 (TYPE before samples, cumulative buckets ending in
     +Inf, _count equal to it), whose budget, resident bytes,
     evictions, fallbacks, fsyncs, snapshots, shadow checks and routes
     equal /debug/vars read in the same pause; SIGTERM (exit 0 within
     30 s); `ctl check` over every data file of i/general/standard and
     of cfg (exit 0, the bits summing to numpy's) and `ctl inspect` of
     slice 0 (numpy's container keys and counts); a restart from the
     same node.toml: the schema again unchanged, the pair and the Sum
     exact, the first Count's seconds. K0, K1, K2, K3, K4, K5 and K7
     must launch (the children's counts from their /debug/vars);
 16. admission and the query's own record: an in-process server.Server
     on the card from a TOML ([sched] queue-depth 16, tenant-weights
     gold = 4; [obs] profile-sample-rate 10, cost-debt-threshold 0.5;
     [health] sweep-interval 100 ms, stall-after 4) over phase 15's
     directory (`general` at 960 slices): (1) the lone Count(Intersect)
     with ?profile=true: parse, plan, device_exec and readback_d2h, its
     bytes_touched_hbm the K1 pair's 2 x 960 runs, its roofline share
     at most 1 of the card's own peak (3.35e12 B/s on an H100), the
     trace at /debug/traces/{id} down to the launch; the partial-row
     Count profiled (K3); (2) the 28 pairs from 16 clients, twice,
     through the scheduler, K2 launches a round and `sched_hinted` beside
     phase 4's rounds without a scheduler; (3) overload: 64 clients, half
     tenant gold, each request X-Pilosa-Deadline-Us 20000: 429s with
     Retry-After or 504s, every 200 equal to numpy, the
     pilosa_query_outcome_total deltas by outcome and tenant equal to the
     clients' own counts, /debug/slo's availability and shed rate equal
     to them, the served share of each tenant; then 20 requests shed
     through the sched.admit seam (429); (4) /debug/costs: each tenant's
     ledger queries equal its served Counts, `general`'s residency on
     the pair's account, X-Pilosa-Cost-Debt on exactly the dominant
     tenant's answers, /debug/queryshapes counting the pair's shape
     exactly; (5) /healthz and /readyz, then one SetBit held 6 s at the
     storage.fsync seam: `wal` STALLED at /debug/health, /readyz 503, one
     dossier within dossier-max, then /readyz 200, the SetBit acked and
     counted; `ctl health`, `costs` and `top -n 1` and `ctl diagnose -o
     FILE` against the node; (6) the lone Count's p50 over 200 calls
     with every store on and with [sched], [slo], [health], the cost
     ledger and sampling off, in turns (off, on, on, off), the same
     server's stores wired anew from each TOML, printed. K0,
     K1, K2 and K3 must launch on this path;
 17. the on-chip probe tools (pilosa_tpu_torch/tools) through their
     main(): probe_r5_bw (K1, K6 at every T, the plain static pair,
     stream_popcount and torch's sum over pools of 960 and 3072 slices),
     probe_r5 kernels / stage / readback, profile_stage and
     profile_headline, each record under chiprun_out/probes/; K6 and
     stream_popcount must launch on this path, and then K6 at every T
     and both slice counts and stream_popcount are held exactly against
     their plain versions and numpy, and timed;
 18. a `kernels` JSON line (each kernel's launches summed over the
     serving paths 4-16, each path's counters set to 0 just before it;
     K6's and the stream's from the probe path, the one they serve; the
     count of each path beside it), the card line, and the final
     {"ok": true, "device": ...} line.

Each HTTP phase runs one full pass of Python's cyclic collector right
after its staging query and reports its time, so that no timed window
holds the pass that staging would otherwise set off.

Exits non-zero, with no result line, when no CUDA card is present.
Details go to chiprun_out/chip_smoke.json.

With --dense-qps-of ROOT it runs phases 1, 2 and 4 only, built and
served by the package under ROOT, and prints their QPS as one JSON line:
run it alternately on two checkouts to compare their dense serving.
--sparse-qps-of ROOT does the same with phase 6. --kernel-times-of ROOT
runs phases 1 and 2 and then K4 at the chip shape, K2's two wrappers
at the headline and the wide shape, K1's and K3's slice sweeps of phase
3, K6 at T = 1, 4 and 32 over 960 slices, and K7 at (960, 1024) and over
phase 12's sweep beside the scattered-sector probe, on inputs made on
the card from the seed, each held exactly against its plain version and
timed, and prints the times and the ptxas report as one JSON line: run
it on a parent and a change in turns (parent, change, change, parent) to
compare their kernels on one card (the forms and the probe a parent
lacks are left out of its line).
With --lone-latency-of ROOT it runs phases 1 and 2 and the lone Counts
of phase 4 only, 56 of them as in phase 4 and then 560 more, and prints
their latency and the collector's full passes as one JSON line.
"""

from __future__ import annotations

import argparse
import gc
import http.client
import io
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from datetime import datetime, timedelta
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
                 "pilosa_tpu/ops/kernels.py:121, tools/probe_r5.py:211"),
    "pair_count": ("pilosa_tpu_torch/csrc/pair_count.cu",
                   "pilosa_tpu/ops/kernels.py:176"),
    "coarse_count_blocked": ("pilosa_tpu_torch/csrc/coarse_count_blocked.cu",
                             "tools/probe_r5_bw.py:82"),
    "stream_popcount": ("pilosa_tpu_torch/csrc/coarse_count_blocked.cu",
                        "tools/probe_r5_bw.py:144 (the XLA whole-pool "
                        "popcount, no Pallas call)"),
    "apply_writes": ("pilosa_tpu_torch/csrc/apply_writes.cu",
                     "pilosa_tpu/parallel/mesh.py:1997 (the XLA program "
                     "compile_serve_apply_writes, no Pallas call)"),
}
# The kernels each served path must launch.
DENSE_PATH = ("coarse_count", "coarse_count_shared", "tree_count")
SPARSE_PATH = ("sparse_pair_count", "coarse_count")
BSI_PATH = ("probe_ok", "pair_count", "coarse_count", "tree_count",
            "apply_writes")
PROBE_PATH = ("coarse_count_blocked", "stream_popcount", "probe_ok",
              "coarse_count")
PROBE_SLICES = (SLICES, 3072)  # the bandwidth probe's sweep
# The kernels only the probe path launches.
PROBE_ONLY = ("coarse_count_blocked", "stream_popcount")
# The integer field: the repo's own BSI configuration (bench.py:2079-2167).
BSI_FIELD, BSI_MIN, BSI_MAX = "val", -32768, 32767
BSI_ROWS = 18        # existence, sign, 16 magnitude planes
FLAT_M = 15_360      # the ops-level pair at chip shape: 960 x 16 containers
# K2's wide shape: 16 unique runs (its limit) under 16 queries of a
# 4-leaf tree with one nested operand.
WIDE_UNIQUE = 16
WIDE_TREE = ["or", ["and", ["leaf", 0], ["leaf", 1]],
             ["andnot", ["leaf", 2], ["leaf", 3]]]


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


def build_holder(path: str, words: np.ndarray, wal=None, index: str = "i"):
    """A port Holder whose index `index`, frame `general` holds `words`,
    injected as whole storage images (per-bit writes would take hours;
    `replace` writes no op records). `wal` is its WAL policy
    (core/wal.WalConfig; None: the bare Holder's `never`)."""
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.roaring import Bitmap, Container

    h = Holder(path) if wal is None else Holder(path, wal=wal)
    h.open()
    view = h.create_index_if_not_exists(index).create_frame_if_not_exists(
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


WARM_CALLS = 10  # calls traced before a window of traced()
WINDOW = "chip_smoke.window"


def traced(fn, warm):
    """Runs warm() and then fn() under torch.profiler (CPU and CUDA
    activity), fn inside a record_function window after a synchronize.
    A trace lacks the kernels of the first calls made after it opens
    (1-9 of 10 on the H100), so only device activity that starts inside
    the window counts; the window's own annotation on the device
    timeline does not. Returns ({kernel key: ([warm (start, end) µs],
    [window (start, end) µs])}, fn's wall seconds, synchronize
    included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm()
        torch.cuda.synchronize()
        time.sleep(0.002)
        with record_function(WINDOW):
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    events = prof.events()
    window = next(e.time_range for e in events if e.name == WINDOW)
    cuda = torch.autograd.DeviceType.CUDA
    held: dict = {}
    for e in events:
        if e.device_type == cuda and e.key != WINDOW:
            r = e.time_range
            held.setdefault(e.key, ([], []))[
                window.start <= r.start <= window.end].append(
                    (r.start, r.end))
    return held, wall


def device_ms(fn, reps: int, warm_calls: int = WARM_CALLS):
    """Mean device milliseconds of the kernels one call launches, by
    torch.profiler over `reps` calls after `warm_calls` (traced()): the
    card's own time, without the host gaps between calls that time_ms
    counts when a call's host work outlasts its kernels. Returns (ms,
    missed): ms is None when the window holds a count of some activity
    that is no multiple of reps; missed lists each activity whose warm
    calls or window lack launches, with what each held."""
    def calls(n):
        for _ in range(n):
            fn()

    fn()
    held, _wall = traced(lambda: calls(reps), lambda: calls(warm_calls))
    us = sum(b - a for _, ins in held.values() for a, b in ins)
    missed = [{"key": key[:80], "warm_held": len(warm),
               "warm_calls": warm_calls, "held": len(ins), "calls": reps}
              for key, (warm, ins) in held.items()
              if len(ins) % reps or len(warm) % warm_calls]
    whole = all(m["held"] % reps == 0 for m in missed)
    if not whole:
        log(f"  (the window lacks launches: {missed})")
    return (us / reps / 1e3 if whole else None), missed


def measure(cases, reps: int, plain_reps: int = 3,
            warm_calls: int = WARM_CALLS) -> dict:
    """Each (wrapper, kernel, kernel call, plain call, bytes moved) case:
    the kernel held exactly against its plain version on the same card
    tensors, then timed: `ms` by CUDA events over back-to-back calls,
    `device_ms` by the profiler after warm_calls traced calls (null when
    its trace missed launches), the plain version by events (skipped
    when plain_reps is 0)."""
    import torch

    results = {}
    for name, kernel, run, plain, nbytes in cases:
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0 and got.shape == want.shape,
              f"{name}: kernel != plain (max err {err})")
        del got, want
        ms = time_ms(run, reps)
        dev_ms, missed = device_ms(run, reps, warm_calls)
        plain_ms = time_ms(plain, plain_reps) if plain_reps else None
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        results[name] = {"kernel": kernel, "ms": ms, "device_ms": dev_ms,
                         "trace_missed": missed,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": "bytes", "bytes": nbytes,
                         "gb_per_s": nbytes / ms / 1e6, "max_abs_err": err}
        plain_s = f"{plain_ms:.3f} ms" if plain_ms is not None else "-"
        dev_s = f"{dev_ms:.4f}" if dev_ms is not None else "null"
        log(f"  {name:36s} {kernel:20s} {ms:8.4f} ms (device {dev_s})"
            f"  {nbytes / ms / 1e6:7.1f} GB/s  bound {bound_ms:.4f} ms  "
            f"plain {plain_s}  exact")
    return results


# -- phase 3: kernels ----------------------------------------------------------


def shared_cases(views, uni, tab, tree, leaf_map, tag: str = ""):
    """K2's two wrappers over `views` (U unique runs): the (U,) uniform
    starts and the (U, S) table, as measure() cases."""
    from pilosa_tpu_torch.ops import kernels as tk

    s, u, out_b = views[0].shape[0], len(views), 4 * views[0].shape[0]
    return [
        ("coarse_count_shared_uniform" + tag, "coarse_count_shared",
         lambda: tk.coarse_count_shared_uniform(views, uni, tree, leaf_map),
         lambda: tk.shared_plain(views, uni, True, tree, leaf_map),
         u * s * RUN_BYTES + len(leaf_map) * out_b),
        ("coarse_count_batch_per_slice" + tag, "coarse_count_shared",
         lambda: tk.coarse_count_batch_per_slice(views, tab, tree, leaf_map),
         lambda: tk.shared_plain(views, tab, False, tree, leaf_map),
         u * s * RUN_BYTES + u * out_b + len(leaf_map) * out_b)]


def random_runs(s: int, runs: int, device, seed: int):
    """(s, 16 * runs, 2048) random int32 words on the card, and the (runs,)
    and (runs, s) start forms of reading run u as unique run u."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    pool = torch.randint(-2**31, 2**31, (s, runs * 16, 2048),
                         dtype=torch.int32, device=device, generator=gen)
    uni = torch.arange(runs, dtype=torch.int32, device=device)
    return pool, uni, uni[:, None].expand(runs, s).contiguous()


def wide_shared_cases(s: int, device, seed: int):
    """K2 at the widest batch its limits allow: U = 16 random runs of s
    slices, B = 16 queries of WIDE_TREE (4 leaves, one nested operand),
    query q reading runs q, q + 5, q + 10 and q + 15 (mod 16)."""
    pool, uni, tab = random_runs(s, WIDE_UNIQUE, device, seed + 2)
    leaf_map = tuple(tuple((q + 5 * i) % WIDE_UNIQUE for i in range(4))
                     for q in range(16))
    return shared_cases((pool,) * WIDE_UNIQUE, uni, tab, WIDE_TREE,
                        leaf_map, " (wide)")


# K1's slice sweep: the shapes the tiled fold (csrc/coarse_tiles.cuh) was
# built for, from a few slices (cut into chunks) to the headline's 960
# (whole runs): a lone pair, the time path's 29-leaf OR and a 16-query
# uniform batch (query q reads runs 2q and 2q+1), over BATCH_RUNS random
# runs of each slice count.
SWEEP_SLICES = (24, 96, 240, 960)
SWEEP_OR_LEAVES = 29
K6_SWEEP_T = (1, 4, 32)


def or_tree(n: int):
    """The planner's canonical OR of n optional views: a time cover."""
    from pilosa_tpu_torch.parallel.plan import canonical_tree

    return canonical_tree(["or"] + [["leaf"]] * n,
                          [("f", f"standard_{d}", 1, False)
                           for d in range(n)], [])


def k1_sweep_cases(pool, uni):
    """K1 on one slice count's pool of BATCH_RUNS random runs: the lone
    pair, the 29-leaf OR and the 16-query batch, as measure() cases with
    their byte bounds (each run read once, each count written once)."""
    from pilosa_tpu_torch.ops import kernels as tk

    s = pool.shape[0]
    pair = ["and", ["leaf", 0], ["leaf", 1]]
    or29 = or_tree(SWEEP_OR_LEAVES)
    p2, p29 = (pool, pool), (pool,) * SWEEP_OR_LEAVES
    u2, u29 = uni[:2], uni[:SWEEP_OR_LEAVES]
    return [
        (f"coarse_count sweep (pair, S={s})", "coarse_count",
         lambda: tk.coarse_count_uniform(p2, u2, pair),
         lambda: tk.coarse_plain(p2, u2, True, pair, 1),
         2 * s * RUN_BYTES + 4 * s),
        (f"coarse_count sweep (29-leaf OR, S={s})", "coarse_count",
         lambda: tk.coarse_count_uniform(p29, u29, or29),
         lambda: tk.coarse_plain(p29, u29, True, or29, 1),
         SWEEP_OR_LEAVES * s * RUN_BYTES + 4 * s),
        (f"coarse_count sweep (16-query batch, S={s})", "coarse_count",
         lambda: tk.coarse_count_uniform_batch(p2, uni, pair),
         lambda: tk.coarse_plain(p2, uni, True, pair, 16),
         BATCH_RUNS * s * RUN_BYTES + 16 * 4 * s)]


def k1_sweep(device, seed: int, reps: int, plain_reps: int = 3) -> dict:
    """K1's slice sweep, one slice count at a time (each pool freed
    before the next), every case held exactly against coarse_plain and
    timed; at the headline's slices also the per-slice form with the
    uniform starts expanded to its (L, S) table on the card, the one
    start form K1 would keep without its uniform form."""
    import torch

    from pilosa_tpu_torch.ops import kernels as tk

    results = {}
    for s in SWEEP_SLICES:
        pool, uni, _tab = random_runs(s, BATCH_RUNS, device, seed + s)
        cases = k1_sweep_cases(pool, uni)
        if s == SLICES:
            pair = ["and", ["leaf", 0], ["leaf", 1]]
            p2, u2 = (pool, pool), uni[:2]
            cases.append((
                f"coarse_count sweep (pair, S={s}, per-slice form, "
                "starts expanded on the card)", "coarse_count",
                lambda: tk.coarse_count_per_slice(
                    p2, u2[:, None].expand(2, s).contiguous(), pair),
                lambda: tk.coarse_plain(p2, u2, True, pair, 1),
                2 * s * RUN_BYTES + 4 * s))
        results.update(measure(cases, reps, plain_reps))
        del pool, uni, _tab, cases
        torch.cuda.empty_cache()
    return results


# K3's slice sweep (the tiled fold in table mode): a pair and the time
# path's 29-leaf OR over random runs, 3 in 4 containers present, at the
# sweep's slice counts; then a tree of Count(Range(val > 1000))'s shape
# at the headline's 960 slices: 18 rows, the top plane nearly empty.
K3_PRESENT = 0.75
K3_TOP_PRESENT = 0.001


def k3_cases(pool, tree, rows, present, tag: str):
    """K3 on `pool` (whole random runs) with leaf l reading run rows[l],
    container j present with probability present[l]: the gathered
    (1, L, S, 16) idx / hit form (tree_count_per_slice, which every
    version of the package takes) and, where the package has it, the
    serving form over the leaves' rows of one (R, S, 16) container
    table on the card (tree_count_rows), as measure() cases. Bounds: the
    containers present, read once, the index (both idx and hit for the
    gathered form, one table row a leaf for the table form) and the (S,)
    out."""
    import torch

    from pilosa_tpu_torch.ops import kernels as tk

    s, runs = pool.shape[0], pool.shape[1] // 16
    gen = torch.Generator(device=pool.device).manual_seed(len(rows) + s)
    table = (torch.arange(runs * 16, dtype=torch.int32, device=pool.device)
             .view(runs, 1, 16).expand(runs, s, 16).contiguous())
    p = torch.tensor(present, device=pool.device)[:, None, None]
    keep = torch.rand((len(rows), s, 16), device=pool.device,
                      generator=gen) < p
    sel = torch.tensor(rows, device=pool.device)
    table[sel] = torch.where(keep, table[sel], -1)
    idx = table[sel].clamp(min=0)[None].contiguous()
    hit = (table[sel] >= 0).to(torch.int32)[None].contiguous()
    views = (pool,) * len(rows)
    cont_b = int(hit.sum()) * 2048 * 4
    out = [(f"tree_count_per_slice ({tag}, S={s})", "tree_count",
            lambda: tk.tree_count_per_slice(views, idx, hit, tree),
            lambda: tk.tree_plain(views, idx, hit, tree),
            cont_b + 2 * idx.numel() * 4 + 4 * s)]
    if hasattr(tk, "tree_count_rows"):
        req = [[table[r] for r in rows]]
        out.append((f"tree_count_rows ({tag}, S={s})", "tree_count",
                    lambda: tk.tree_count_rows(views, req, tree),
                    lambda: tk.rows_plain(views, req, tree),
                    cont_b + len(rows) * s * 64 + 4 * s))
    return out


def range_tree():
    """The canonical tree of Count(Range(val > 1000)) over the repo's
    16-plane field, and each leaf's row (0 existence, 1 sign, 2-17 the
    planes)."""
    from pilosa_tpu_torch.bsi import FieldSchema, cond_tree, to_shape
    from pilosa_tpu_torch.parallel.plan import canonical_tree

    schema = FieldSchema(BSI_FIELD, BSI_MIN, BSI_MAX)
    raw, leaves = [], []
    tree = canonical_tree(to_shape(cond_tree(schema, ">", 1000), "general",
                                   schema.view, raw), raw, leaves)
    return tree, [lf[2] for lf in leaves]


def k3_sweep(device, seed: int, reps: int, plain_reps: int = 3) -> dict:
    """K3's slice sweep and the Range-shaped tree (k3_cases), one pool at
    a time, each case held exactly against its plain version and timed."""
    import torch

    results = {}
    pair = ["and", ["leaf", 0], ["leaf", 1]]
    for s in SWEEP_SLICES:
        pool, _uni, _tab = random_runs(s, BATCH_RUNS, device, seed + s)
        cases = (k3_cases(pool, pair, [0, 1], [K3_PRESENT] * 2, "pair")
                 + k3_cases(pool, or_tree(SWEEP_OR_LEAVES),
                            list(range(SWEEP_OR_LEAVES)),
                            [K3_PRESENT] * SWEEP_OR_LEAVES, "29-leaf OR"))
        results.update(measure(cases, reps, plain_reps))
        del pool, _uni, _tab, cases
        torch.cuda.empty_cache()
    tree, rows = range_tree()
    pool, _uni, _tab = random_runs(SLICES, BSI_ROWS, device, seed + 18)
    present = [K3_TOP_PRESENT if r == BSI_ROWS - 1 else 1.0 for r in rows]
    # The Range tree runs ~0.7 ms: warm the trace for longer.
    results.update(measure(k3_cases(pool, tree, rows, present,
                                    "Range val > 1000 shape"), reps,
                           plain_reps, warm_calls=50))
    del pool, _uni, _tab
    torch.cuda.empty_cache()
    return results


def k6_cases(device, seed: int, ts=K6_SWEEP_T):
    """K6 (coarse_count_blocked) at T in ts over the probe's pool at the
    headline's slices (a pair over cap 32), against coarse_plain's
    uniform form; the same inputs for every tree."""
    import torch

    from pilosa_tpu_torch.ops import kernels as tk

    gen = torch.Generator(device=device).manual_seed(seed + 6)
    pool = torch.randint(-2**31, 2**31, (SLICES, 32, 2048),
                         dtype=torch.int32, device=device, generator=gen)
    starts = torch.tensor([0, 1], dtype=torch.int32, device=device)
    pair = ["and", ["leaf", 0], ["leaf", 1]]
    pp = (pool, pool)
    return [(f"coarse_count_blocked t{t} (S={SLICES})",
             "coarse_count_blocked",
             lambda t=t: tk.coarse_count_blocked(pp, starts, pair, t),
             lambda: tk.coarse_plain(pp, starts, True, pair, 1),
             2 * SLICES * RUN_BYTES + 8 + 4 * SLICES) for t in ts]


def kernel_phase(holder, words: np.ndarray, device, seed: int) -> dict:
    """Each wrapper at the main path's shapes against its plain version
    (ops.kernels.coarse_plain / shared_plain / tree_plain, called
    directly on the same card tensors), exactly, then both timed."""
    import torch

    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.ops.pool import pack_bitmap
    from pilosa_tpu_torch.parallel.mesh import (build_sharded_index,
                                                dense_row, index_row,
                                                leaf_layout)

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
    shared_uni = dev([lay[r].uniform for r in range(DENSE_ROWS)])
    shared_tab = dev(np.stack([lay[r].starts for r in range(DENSE_ROWS)]))
    idx = dev(np.stack([lay[PARTIAL_ROW].idx, lay[0].idx]))
    hit = dev(np.stack([lay[PARTIAL_ROW].hit, lay[0].hit]))
    hit_np = np.stack([lay[PARTIAL_ROW].hit, lay[0].hit])
    p2, p8 = (pool, pool), (pool,) * DENSE_ROWS
    # K3's serving form reads the leaves' container indexes on the card.
    k3_rows = [[index_row(lay[PARTIAL_ROW], device),
                index_row(lay[0], device)]]

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
        *shared_cases(p8, shared_uni, shared_tab, pair_and,
                      tuple(pairs16)),
        *wide_shared_cases(s, device, seed),
        ("tree_count_rows", "tree_count",
         lambda: tk.tree_count_rows(p2, k3_rows, pair_and),
         lambda: tk.rows_plain(p2, k3_rows, pair_and),
         int(hit_np.sum()) * 2048 * 4 + 2 * s * 64 + out_b),
        ("tree_count_per_slice", "tree_count",
         lambda: tk.tree_count_per_slice(p2, idx[None], hit[None], pair_and),
         lambda: tk.tree_plain(p2, idx[None], hit[None], pair_and),
         int(hit_np.sum()) * 2048 * 4 + 2 * idx.numel() * 4 + out_b),
    ]
    results = measure(cases, 20)
    # The wrapper total over the same per-slice vector.
    total = int(tk.tree_count_pallas(pool, idx, hit, pair_and))
    want = host_count(words, "and", PARTIAL_ROW, 0)
    check(total == want, f"tree_count_pallas {total} != host {want}")
    del staged, pool, wide, w2, k3_rows
    torch.cuda.empty_cache()
    log("kernel phase: K1's and K3's slice sweeps")
    results.update(k1_sweep(device, seed, 20))
    results.update(k3_sweep(device, seed, 20))
    torch.cuda.empty_cache()
    return results


# -- phase 4: the slice over HTTP ----------------------------------------------


class Client:
    def __init__(self, host: str, port: int, index: str = "i"):
        self.conn = http.client.HTTPConnection(host, port, timeout=120)
        self.index = index

    def raw(self, method: str, path: str, body: str = ""):
        self.conn.request(method, path, body=body.encode())
        resp = self.conn.getresponse()
        return resp.status, json.loads(resp.read())

    def call(self, method: str, path: str, body: str = ""):
        status, doc = self.raw(method, path, body)
        check(status == 200, (method, path, body, status, doc))
        return doc

    def count(self, pql: str) -> int:
        return self.call("POST", f"/index/{self.index}/query",
                         pql)["results"][0]

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


def concurrent(host, port, queries, want, rounds: int = 1,
               index: str = "i") -> float:
    """CLIENTS threads, each sending every query once per round (from a
    different offset) to `index`; returns queries per second. Answers are
    checked."""
    errors = []

    def client(k):
        c = Client(host, port, index)
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
    """Run fn under torch.profiler (traced(), after WARM_CALLS small
    kernels) and report the device time of every kernel that starts in
    fn's window against its wall time."""
    import torch

    def warm():
        x = torch.zeros(1, device="cuda")
        for _ in range(WARM_CALLS):
            x += 1

    held, wall = traced(fn, warm)
    kernels = {key: sum(b - a for a, b in ins)
               for key, (_, ins) in held.items() if ins}
    busy = sum(kernels.values()) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall,
            "device_us_by_kernel": kernels,
            "warm_held": {key[:80]: len(w) for key, (w, _) in held.items()}}


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
        k2 = [tk.LAUNCHES["coarse_count_shared"]]
        conc_qps = [concurrent(host, port, lone_q, lone_w)]
        k2.append(tk.LAUNCHES["coarse_count_shared"])
        busy = profiled(lambda: conc_qps.append(
            concurrent(host, port, lone_q, lone_w)))
        k2.append(tk.LAUNCHES["coarse_count_shared"])
        k2_rounds = [b - a for a, b in zip(k2, k2[1:])]
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
    log(f"slice phase launches {launches}, by wrapper {by_wrapper}; K2 "
        f"launches a 16-client round {k2_rounds}")
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
            "concurrent_qps": conc_qps, "clients": CLIENTS,
            "k2_rounds": k2_rounds}


# -- phase 5: K4 at the sparse slice's shapes ----------------------------------


def sparse_kernel_phase(holder, sp: SparseRows, device) -> dict:
    """K4 on one pair of frame `sparse` (rows 0 and 1, every container of
    every slice) against its plain version (ops.kernels.sparse_pair_plain
    on the same card tensors), exactly, then both timed. Bound: the
    bytes the pair needs (the real values of both sides, the idx/hit and
    cardinality reads, the output) over the memory rate. The counts are
    also held against the host's."""
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
    got = tk.sparse_pair_count(*args).cpu().numpy()
    check(got.shape == (s, 16) and (got == sp.inter((0, 1))).all(),
          "sparse_pair_count != host")
    la = np.take_along_axis(staged.cards_host, tables[0][0], 1) * tables[0][1]
    lb = np.take_along_axis(staged.cards_host, tables[1][0], 1) * tables[1][1]
    res = measure([sparse_pair_case(args, la, lb)], 50)["sparse_pair_count"]
    res.update(pairs=s * 16, pool_bytes=pool_bytes,
               dense_image_bytes=s * staged.capacity * 2048 * 4)
    del staged, args, ia, ha, ib, hb
    torch.cuda.empty_cache()
    return res


def sparse_pair_case(args, la: np.ndarray, lb: np.ndarray):
    """K4 over `args` as a measure() case. Bound: the bytes the pair
    needs (the real values of both sides, la and lb of them, the idx/hit
    and cardinality reads, the output) over the memory rate."""
    from pilosa_tpu_torch.ops import kernels as tk

    pairs = la.size
    nbytes = (2 * int(la.sum() + lb.sum())   # the real values, once
              + 4 * 4 * pairs                # idx/hit of both sides
              + 2 * 4 * pairs                # one card per side and pair
              + 4 * pairs)                   # the output
    return ("sparse_pair_count", "sparse_pair_count",
            lambda: tk.sparse_pair_count(*args),
            lambda: tk.sparse_pair_plain(*args), nbytes)


def sparse_pair_inputs(sp: SparseRows, device):
    """Rows 0 and 1 of `sp` as one sorted-array pool of (S, 32, 2048),
    row r's block b at container 16 r + b, and the (S, 16) tables of
    their pair: the chip shape of K4 without a Holder. Returns (K4's
    arguments, la, lb)."""
    import torch

    s = sp.lens.shape[0]
    j = np.arange(2048, dtype=np.uint32)
    vals = (j * BUCKET + sp.off[:, :2]).astype(np.uint16)
    vals[j >= sp.lens[:, :2, :, None]] = 0xFFFF
    cards = np.ascontiguousarray(sp.lens[:, :2].reshape(s, 32))
    blocks = np.broadcast_to(np.arange(16, dtype=np.int32), (s, 16))
    one = np.ones((s, 16), dtype=np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    pool = dev(vals.reshape(s, 32, 2048).view(np.int16))
    args = (pool, dev(cards), pool, dev(cards), dev(blocks), dev(one),
            dev(blocks + 16), dev(one))
    return args, cards[:, :16], cards[:, 16:]


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


# -- the card-memory governor: budget, a real OOM, infeasible, DELETE ----------

RES_FRAMES = (("i", "general"), ("i", "sparse"), ("i", "mixed"),
              ("r", "general"))
RES_ROUNDS = 2           # round-robin rounds, each a Count on every frame
RES_BUDGET_SHARE = 0.6   # the budget's share of the four views' bytes
RES_SLACK = 64 << 20     # memory_allocated's room over staged_bytes
RES_DELETE_SLACK = 1 << 20
RES_INFEASIBLE_BUDGET = 100 << 20  # below any view at 960 slices
RES_MIN_BYTES = 3_000_000_000      # the four views hold at least this
RES_PATH = ("coarse_count", "sparse_pair_count")
FALLBACKS = ("fallback_oom", "fallback_hbm_infeasible",
             "fallback_quarantined", "plan_quarantined")


def add_copy_frame(holder, src: str, frame: str, dst: str) -> float:
    """Index `dst`, frame `frame`: a copy of index `src`'s frame, slice by
    slice (storage clones; `replace` writes no op records). Seconds."""
    t0 = time.monotonic()
    view = holder.create_index_if_not_exists(dst).create_frame_if_not_exists(
        frame).create_view_if_not_exists("standard")
    src_view = holder.view(src, frame, "standard")
    for s, frag in sorted(src_view.fragments.items()):
        view.create_fragment_if_not_exists(s).replace(frag.storage.clone())
    return time.monotonic() - t0


def res_queries(words: np.ndarray, sp: SparseRows, rounds: int) -> list:
    """(index, frame, PQL, answer) of each round-robin Count: a pair of
    rows of the frame, another pair each round."""
    pairs = list(itertools.combinations(range(DENSE_ROWS), 2))
    dense = {p: host_count(words, "and", *p) for p in pairs[:rounds]}
    mixed = (int(sp.inter((0, 1))[0::2].sum())
             + host_count(words[1::2], "and", 0, 1))
    out = []
    for r in range(rounds):
        a, b = pairs[r % len(pairs)]
        for index, frame in RES_FRAMES:
            if frame == "mixed":
                out.append((index, frame, fpql("and", 0, frame, 1, frame),
                            mixed))
            elif frame == "sparse":
                out.append((index, frame, fpql("and", a, frame, b, frame),
                            int(sp.inter((a, b)).sum())))
            else:
                out.append((index, frame, fpql("and", a, frame, b, frame),
                            dense[(a, b)]))
    return out


def res_count(c: Client, index: str, pql_: str) -> int:
    return c.call("POST", f"/index/{index}/query", pql_)["results"][0]


def no_fallback(phase: str, stats: dict) -> None:
    """No query of the phase was served off the card unnoticed."""
    bad = {k: stats.get(k, 0) for k in FALLBACKS if stats.get(k, 0)}
    check(not bad, f"{phase}: nothing left the card ({bad})")


def view_need(holder, index: str, frame: str) -> int:
    """Bytes staging the view would allocate on the card."""
    from pilosa_tpu_torch.parallel.mesh import format_pool_bytes
    from pilosa_tpu_torch.parallel.serve import view_stats

    return format_pool_bytes(*view_stats(holder, index, frame, "standard",
                                         SLICES, 0.05))


def residency_phase(holder, words: np.ndarray, sp: SparseRows, card: str,
                    device) -> dict:
    """The governor through the normal entry points at 960 slices, the
    kernels' counters set to 0 at the start and read at the end:
    res_budget, res_oom, res_infeasible and res_delete, each on a server
    of its own."""
    import torch

    from pilosa_tpu_torch import fault
    from pilosa_tpu_torch.ops import kernels as tk

    copy_s = add_copy_frame(holder, "i", "general", "r")
    queries = res_queries(words, sp, RES_ROUNDS)
    log(f"residency phase: index r (a copy of general) in {copy_s:.2f} s")
    need = {f"{i}/{f}": view_need(holder, i, f) for i, f in RES_FRAMES}
    total = sum(need.values())
    check(total >= RES_MIN_BYTES, f"the four views hold >= 3 GB: {need}")
    budget = int(RES_BUDGET_SHARE * total)
    log(f"residency phase: views {json.dumps(need)}, {total / 1e9:.3f} GB; "
        f"budget {budget / 1e9:.3f} GB")
    gc.collect()
    torch.cuda.synchronize()
    tk.reset_launches()
    fired0 = dict(fault.STATS)
    out = {"views_bytes": need, "budget_bytes": budget, "copy_s": copy_s,
           "rounds": RES_ROUNDS}
    out.update(res_budget(holder, queries, need, budget, card, device))
    out.update(res_oom(holder, queries, need, device))
    check(dict(fault.STATS) == fired0, "no injected fault fired")
    out.update(res_infeasible(holder, queries, device))
    out.update(res_delete(holder, queries, device))
    torch.cuda.synchronize()
    out["launches"] = dict(tk.LAUNCHES)
    log(f"residency phase launches {out['launches']}")
    for k in RES_PATH:
        check(out["launches"][k] > 0,
              f"kernel {k} launched on the residency path")
    return out


def res_budget(holder, queries, need: dict, budget: int, card: str,
               device) -> dict:
    """RES_ROUNDS round-robin rounds of Counts over the four views under
    `budget`, each equal to numpy: after each, the staged bytes within the
    budget (or over by one view while a query holds it) and
    memory_allocated following them within RES_SLACK; then CLIENTS
    clients at once, each a Count on every frame."""
    import torch

    from pilosa_tpu_torch.api.server import serve

    base = torch.cuda.memory_allocated()
    biggest = max(need.values())
    srv = serve(holder, device=device, hbm_budget_bytes=budget)
    ex = srv.handler.executor
    mgr = ex.mesh_manager()
    c = Client(*srv.address)
    try:
        restages, worst = [], 0
        t0 = time.monotonic()
        for index, frame, q, want in queries:
            before = dict(mgr.stats)
            t1 = time.monotonic()
            got = res_count(c, index, q)
            dt = time.monotonic() - t1
            check(got == want, (index, q, got, want))
            st = dict(mgr.stats)
            if st.get("stage", 0) > before.get("stage", 0):
                restages.append((f"{index}/{frame}", round(dt * 1e3, 3),
                                 (st["stage_us"] - before.get("stage_us", 0))
                                 / 1e3))
            staged = st.get("staged_bytes", 0)
            check(staged <= budget or staged - budget <= biggest,
                  f"staged {staged} within budget {budget} (+ one view)")
            torch.cuda.synchronize()
            alloc = torch.cuda.memory_allocated() - base
            worst = max(worst, abs(alloc - staged))
            check(abs(alloc - staged) <= RES_SLACK,
                  f"memory_allocated {alloc} follows staged {staged}")
        rounds_s = time.monotonic() - t0
        st = dict(mgr.stats)
        check(st.get("evicted_budget", 0) > 0, "evictions under the budget")
        no_fallback("residency rounds", st)
        ms = [r[1] for r in restages]
        log(f"residency phase on {card}: {len(queries)} Counts in "
            f"{rounds_s:.2f} s, {len(restages)} restages (Count ms p50 "
            f"{np.percentile(ms, 50):.1f}, max {max(ms):.1f}); evicted "
            f"{st.get('evicted_budget', 0)} by the budget; memory_allocated "
            f"within {worst / 1e6:.3f} MB of staged_bytes")
        log(f"residency phase restages (view, Count ms, staging host ms): "
            f"{json.dumps(restages)}")
        herd = queries[:4 * len(RES_FRAMES)]
        errors = []

        def client(k):
            cc = Client(*srv.address)
            try:
                for j in range(len(RES_FRAMES)):
                    index, _f, q, want = herd[(j + k) % len(herd)]
                    got = res_count(cc, index, q)
                    if got != want:
                        errors.append((q, got, want))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
            finally:
                cc.close()

        stage0 = st.get("stage", 0)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(CLIENTS)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        herd_s = time.monotonic() - t0
        check(not errors, f"herd under the budget: {errors[:5]}")
        hst = dict(mgr.stats)
        no_fallback("residency herd", hst)
        check(all(sv.pins == 0 for sv in mgr._views.values()), "no pin left")
        check(hst.get("staged_bytes", 0) <= budget + biggest,
              "herd residency")
        log(f"residency phase: {CLIENTS} clients x {len(RES_FRAMES)} Counts "
            f"in {herd_s:.2f} s, {hst['stage'] - stage0} restages, evicted "
            f"{hst.get('evicted_budget', 0)} by the budget in all")
        return {"rounds_s": rounds_s, "restages": restages, "herd_s": herd_s,
                "alloc_vs_staged_max": worst, "stats": hst,
                "herd_restages": hst["stage"] - stage0}
    finally:
        ex.invalidate_device_index()
        c.close()
        srv.close()


def res_oom(holder, queries, need: dict, device) -> dict:
    """A real torch.cuda.OutOfMemoryError. With `sparse` and `mixed`
    resident and a ballast leaving less free memory than `general` needs
    but enough once they go, the ladder evicts them and stages `general`
    on its retry. Then, with `mixed` alone resident and too little free
    even without it, the ladder evicts it, fails again, and the host
    answers."""
    import torch

    from pilosa_tpu_torch import fault
    from pilosa_tpu_torch.api.server import serve

    gen = next(q for q in queries if q[:2] == ("i", "general"))
    mixed = next(q for q in queries if q[1] == "mixed")
    srv = serve(holder, device=device, hbm_budget_bytes=-1)
    ex = srv.handler.executor
    mgr = ex.mesh_manager()
    c = Client(*srv.address)
    ballast = []

    def delta(before, keys):
        st = dict(mgr.stats)
        return {k: st.get(k, 0) - before.get(k, 0) for k in keys}

    try:
        torch.cuda.empty_cache()
        for index, frame, q, want in queries[:len(RES_FRAMES)]:
            if frame in ("sparse", "mixed"):
                check(res_count(c, index, q) == want, q)
        before = dict(mgr.stats)
        ballast += fault.fill_cache(device)
        free = torch.cuda.mem_get_info()[0]
        ballast.append(torch.empty(free - need["i/general"] // 2,
                                   dtype=torch.uint8, device=device))
        free1 = torch.cuda.mem_get_info()[0]
        check(free1 < need["i/general"] <= free1 + before["staged_bytes"],
              f"free {free1} < view {need['i/general']} <= free + "
              f"resident {before['staged_bytes']}")
        t0 = time.monotonic()
        got = res_count(c, "i", gen[2])
        oom_ms = (time.monotonic() - t0) * 1e3
        d = delta(before, ("oom_retries", "evicted_oom", "count",
                           "fallback_oom", "stage"))
        check(got == gen[3], ("OOM recovered", got, gen[3]))
        check(d["oom_retries"] >= 1 and d["evicted_oom"] >= 1
              and d["count"] == 1 and d["fallback_oom"] == 0
              and d["stage"] == 1, f"the ladder staged on its retry: {d}")
        log(f"residency phase: a real OutOfMemoryError (free {free1 / 1e9:.3f}"
            f" GB < view {need['i/general'] / 1e9:.3f} GB): evicted "
            f"{d['evicted_oom']}, retried, Count in {oom_ms:.1f} ms on the "
            "card")
        ballast.clear()
        ex.invalidate_device_index()
        torch.cuda.empty_cache()
        check(res_count(c, "i", mixed[2]) == mixed[3], mixed)
        resident = dict(mgr.stats)["staged_bytes"]
        target = (need["i/general"] - resident) // 2
        ballast += fault.fill_cache(device)
        ballast.append(torch.empty(torch.cuda.mem_get_info()[0] - target,
                                   dtype=torch.uint8, device=device))
        before = dict(mgr.stats)
        host0 = ex.stats["count_host"]
        t0 = time.monotonic()
        got = res_count(c, "i", gen[2])
        fold_ms = (time.monotonic() - t0) * 1e3
        d2 = delta(before, ("oom_retries", "evicted_oom", "count",
                            "fallback_oom"))
        check(got == gen[3], ("host fold after OOM", got, gen[3]))
        check(d2["fallback_oom"] >= 1 and d2["evicted_oom"] >= 1
              and d2["count"] == 0 and ex.stats["count_host"] == host0 + 1,
              f"out of memory after eviction: the host answered: {d2}")
        log(f"residency phase: with {target / 1e9:.3f} GB free and "
            f"{resident / 1e9:.3f} GB evictable, the ladder evicted "
            f"{d2['evicted_oom']} and the host answered in {fold_ms:.1f} ms")
        return {"oom": {"free_bytes": free1, "count_ms": oom_ms, **d},
                "oom_fold": {"free_bytes": target, "evictable": resident,
                             "count_ms": fold_ms, **d2}}
    finally:
        ballast.clear()
        ex.invalidate_device_index()
        c.close()
        srv.close()
        torch.cuda.empty_cache()


def res_infeasible(holder, queries, device) -> dict:
    """A budget below one view: the host answers, nothing stages, and
    ?explain=true names the reason."""
    from pilosa_tpu_torch.api.server import serve

    gen = [q for q in queries if q[:2] == ("i", "general")][:2]
    srv = serve(holder, device=device,
                hbm_budget_bytes=RES_INFEASIBLE_BUDGET)
    ex = srv.handler.executor
    c = Client(*srv.address)
    try:
        t0 = time.monotonic()
        for q in gen:
            check(res_count(c, "i", q[2]) == q[3], ("infeasible", q))
        inf_s = time.monotonic() - t0
        status, plan = c.raw("POST", "/index/i/query?explain=true", gen[0][2])
        st = dict(ex.mesh_manager().stats)
        call = plan["calls"][0]
        check(status == 200 and call["route"] == "host-fold"
              and call["route_reason"] == "hbm_infeasible",
              ("explain", status, plan))
        check(st.get("fallback_hbm_infeasible", 0) >= 1
              and st.get("stage", 0) == 0 and st.get("routed_host", 0) >= 1,
              f"infeasible: host, nothing staged: {st}")
        log(f"residency phase: budget {RES_INFEASIBLE_BUDGET} B: 2 Counts on "
            f"the host in {inf_s:.2f} s, fallback_hbm_infeasible "
            f"{st['fallback_hbm_infeasible']}, routed_host "
            f"{st['routed_host']}; explain: {call['route']} "
            f"({call['route_reason']})")
        return {"infeasible": {"seconds": inf_s, "stats": st}}
    finally:
        c.close()
        srv.close()


def res_delete(holder, queries, device) -> dict:
    """DELETE /index/r/frame/general answers the JAX handler's 200 {},
    memory_allocated drops by the view's bytes within RES_DELETE_SLACK,
    /debug/vars counts one view fewer, and the frame recreated under its
    name answers from its new data."""
    import torch

    from pilosa_tpu_torch.api.server import serve

    rq = next(q for q in queries if q[0] == "r")
    srv = serve(holder, device=device)
    ex = srv.handler.executor
    c = Client(*srv.address)
    try:
        check(res_count(c, "r", rq[2]) == rq[3], rq)
        mgr = ex.mesh_manager()
        vb = mgr._view_bytes(mgr._views[("r", "general", "standard")])
        views0 = c.call("GET", "/debug/vars")["mesh"]["hbm"]["views"]
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        status, body = c.raw("DELETE", "/index/r/frame/general")
        check((status, body) == (200, {}), ("DELETE", status, body))
        torch.cuda.synchronize()
        freed = m0 - torch.cuda.memory_allocated()
        views1 = c.call("GET", "/debug/vars")["mesh"]["hbm"]["views"]
        check(abs(freed - vb) <= RES_DELETE_SLACK and views1 == views0 - 1,
              f"DELETE freed {freed} of the view's {vb} bytes; views "
              f"{views0} -> {views1}")
        c.call("POST", "/index/r/frame/general", "{}")
        for col in (5, 9, 1_050_000):
            for row in (0, 1):
                c.call("POST", "/index/r/query", f"SetBit(rowID={row}, "
                       f"frame=general, columnID={col})")
        got = res_count(c, "r", fpql("and", 0, "general", 1, "general"))
        check(got == 3, ("the recreated frame's Count", got))
        log(f"residency phase: DELETE /index/r/frame/general freed "
            f"{freed / 1e9:.6f} GB (view {vb / 1e9:.6f} GB), views {views0} "
            f"-> {views1}; the recreated frame counts {got}")
        return {"delete": {"freed_bytes": freed, "view_bytes": vb,
                           "views": [views0, views1]}}
    finally:
        ex.invalidate_device_index()
        c.close()
        srv.close()


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
                                                dense_row, leaf_layout,
                                                row_table)
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
    check(staged.row_ids.tolist() == list(range(BSI_ROWS)), "18 rows")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    table = row_table(staged.keys_host, BSI_ROWS)
    tables = [table, table[2:], table[1]]
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
    r_rows = [[a_all[x.row] for x in r_lay]]
    present_b = int(sum(x.hit.sum() for x in r_lay)) * 8192
    # K3 in its serving form (the leaves' rows of the view's container
    # index on the card) and the gathered form, with device time: each call runs ~0.7 ms, so the
    # trace is warmed for longer.
    k3 = measure([
        ("tree_count_rows (Range val > 1000)", "tree_count",
         lambda: tk.tree_count_rows(r_pools, r_rows, tree),
         lambda: tk.rows_plain(r_pools, r_rows, tree),
         present_b + len(leaves) * s * 64 + 4 * s),
        ("tree_count_per_slice (Range val > 1000)", "tree_count",
         lambda: tk.tree_count_per_slice(r_pools, r_idx, r_hit, tree),
         lambda: tk.tree_plain(r_pools, r_idx, r_hit, tree),
         present_b + 2 * r_idx.numel() * 4 + 4 * s)], 20, warm_calls=50)
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
    results.update(k3)
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
    log(f"bsi phase: the SetValue writes reached the staged views as "
        f"{mstats.get('incremental', 0)} scatters (K7 launches "
        f"{launches['apply_writes']}); {mstats.get('stage', 0)} stagings in "
        f"all, {mstats.get('refresh_pick_restage', 0)} restages picked")
    for k in BSI_PATH:
        check(launches[k] > 0, f"kernel {k} launched on the bsi path")
    check(mstats.get("incremental", 0) > 0, "the SetValues scattered")
    check(stats.get("count_host", 0) == 0 and stats.get("bsi_host", 0) == 0,
          "nothing counted on the host")
    return {"launches": launches, "stats": stats, "mesh_stats": mstats,
            "first_query_s": first_s, "collect_after_staging_ms": collect_ms,
            "ms_per_query": ms, "after_writes_s": restage_s, "profile": busy}


# -- phase 9: time-quantum Range and timestamped writes -------------------------

# Index `tq` (quantum YMD, inherited by its frame `events`), the repo's
# time-quantum configuration (bench.py:1136-1139) at TIME_SLICES slices:
# rows 0-3, each (row, day) of April 2017 a seeded random 1/64 of the
# columns. The days stage sorted-array; the month, the year and
# `standard` hold their union (~37% fill) and stage dense.
TIME_SLICES = 96
TIME_ROWS = 4
TIME_DAYS = 30
TIME_WRITE_ROW = 5   # the row the timestamped SetBits write
# (name, first day, day after the last): a cover of one view each day,
# one month view, 2 days (K4), 7 days and 29 days (K1's lone path).
TIME_COVERS = (("month", 1, 31), ("2 days", 20, 22), ("7 days", 3, 10),
               ("29 days", 1, 30))
TIME_PATH = ("coarse_count", "sparse_pair_count")


def day_str(d: int) -> str:
    """Day d of April 2017 (d = 31 is May 1) as a PQL time."""
    return (datetime(2017, 3, 31) + timedelta(days=d)).strftime(
        "%Y-%m-%dT%H:%M")


def time_pql(r: int, start: str, end: str) -> str:
    return (f'Count(Range(rowID={r}, frame=events, start="{start}", '
            f'end="{end}"))')


def days_pql(r: int, d0: int, d1: int) -> str:
    return time_pql(r, day_str(d0), day_str(d1))


class TimeTruth:
    """The day rows of each slice, made from the seed, and the truth of
    every cover (and every single day) per row, summed over slices."""

    def __init__(self, num_slices: int, seed: int):
        self.num_slices, self.seed = num_slices, seed
        self.covers = {(name, r): 0 for name, _, _ in TIME_COVERS
                       for r in range(TIME_ROWS)}
        self.days = np.zeros((TIME_ROWS, TIME_DAYS), dtype=np.int64)

    def slice_days(self, s: int) -> np.ndarray:
        """(rows, days, 16, 1024) uint64: each bit set with p = 1/64 (an
        AND of six random words)."""
        rng = np.random.default_rng([self.seed, 11, s])
        w = rng.integers(0, 2**64, size=(TIME_ROWS, TIME_DAYS, 16, 1024),
                         dtype=np.uint64)
        for _ in range(5):
            w &= rng.integers(0, 2**64, size=w.shape, dtype=np.uint64)
        return w

    def add(self, w: np.ndarray) -> None:
        self.days += np.bitwise_count(w).sum(axis=(2, 3), dtype=np.int64)
        for name, d0, d1 in TIME_COVERS:
            u = np.bitwise_or.reduce(w[:, d0 - 1:d1 - 1], axis=1)
            for r in range(TIME_ROWS):
                self.covers[(name, r)] += int(
                    np.bitwise_count(u[r]).sum(dtype=np.int64))


def add_time_index(holder, truth: TimeTruth) -> float:
    """Index `tq` with quantum YMD and frame `events` (which inherits
    it), its views injected slice by slice as whole storage images: the
    30 day views as array containers, and `standard`, `standard_2017`
    and `standard_201704` as the union's bitmap containers. Built by a
    pool of threads. Returns the seconds spent."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.roaring import Bitmap, Container

    t0 = time.monotonic()
    idx = holder.create_index("tq", time_quantum="YMD")
    frame = idx.create_frame("events")
    check(str(frame.time_quantum) == "YMD", "frame inherits YMD")
    days = [frame.create_view_if_not_exists(f"standard_201704{d:02d}")
            for d in range(1, TIME_DAYS + 1)]
    unions = [frame.create_view_if_not_exists(v) for v in
              ("standard", "standard_2017", "standard_201704")]

    def one(s):
        w = truth.slice_days(s)
        bits = np.unpackbits(w.view(np.uint8), axis=-1, bitorder="little")
        for d, view in enumerate(days):
            bm = Bitmap()
            for r in range(TIME_ROWS):
                for b in range(16):
                    bm.keys.append(r * 16 + b)
                    bm.containers.append(Container(array=np.flatnonzero(
                        bits[r, d, b]).astype(np.uint32)))
            view.create_fragment_if_not_exists(s).replace(bm)
        u = np.bitwise_or.reduce(w, axis=1)
        for view in unions:
            bm = Bitmap()
            for r in range(TIME_ROWS):
                for b in range(16):
                    bm.keys.append(r * 16 + b)
                    bm.containers.append(Container(bitmap=u[r, b].copy()))
            view.create_fragment_if_not_exists(s).replace(bm)
        return w

    with ThreadPoolExecutor(8) as pool:
        for w in pool.map(one, range(truth.num_slices)):
            truth.add(w)
    return time.monotonic() - t0


def staged_bytes(mgr, index: str) -> dict:
    """Bytes of every staged view of an index: packed words (dense) and
    sorted arrays with their cardinalities (sparse)."""
    out = {"dense": 0, "sparse": 0, "views_dense": 0, "views_sparse": 0}
    for (i, _f, _v), sv in mgr._views.items():
        if i != index:
            continue
        out["dense"] += sv.sharded.words.numel() * 4
        out["views_dense"] += sv.sharded.capacity > 0
        if sv.sparse is not None:
            out["sparse"] += (sv.sparse.values.numel() * 2
                              + sv.sparse.cards.numel() * 4)
            out["views_sparse"] += 1
    return out


def resolved(holder, mgr, index: str, query: str, num_slices: int):
    """What the manager resolves for the child of the Count `query`,
    lowered as the executor lowers it: a dense _CountRequest, a
    _SparseCount or an int. Staging aside, it launches nothing."""
    from pilosa_tpu_torch.parallel.plan import _lower_tree
    from pilosa_tpu_torch.pql.parser import parse_string

    leaves: list = []
    shape = _lower_tree(holder, index,
                        parse_string(query).calls[0].children[0], leaves)
    check(shape is not None, f"{query} lowers")
    return mgr._resolve(index, shape, leaves, range(num_slices), num_slices)


def request_case(name: str, req):
    """The kernel count_batch runs for one dense _CountRequest, as a
    measure() case against its plain version: K1's uniform or per-slice
    form over whole-row runs, else K3 over the leaves' container indexes
    kept on the card (StagedView.index_row). Bound:
    the runs (containers) present, read once, the start tables (the
    leaves' table rows) and the (S,) output."""
    import torch

    from pilosa_tpu_torch.ops import kernels as tk

    check(hasattr(req, "layouts"), f"{name}: a dense count request")
    pools, lays, tree = req.pools, req.layouts, req.tree
    s, out_b = pools[0].shape[0], 4 * pools[0].shape[0]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            pools[0].device)

    if all(lay.uniform is not None for lay in lays):
        starts = dev([lay.uniform for lay in lays])
        runs = s * sum(lay.uniform >= 0 for lay in lays)
        return (name, "coarse_count",
                lambda: tk.coarse_count_uniform(pools, starts, tree),
                lambda: tk.coarse_plain(pools, starts, True, tree, 1),
                runs * RUN_BYTES + out_b)
    if all(lay.starts is not None for lay in lays):
        starts = dev(np.stack([lay.starts for lay in lays]))
        runs = sum(int((lay.starts >= 0).sum()) for lay in lays)
        return (name, "coarse_count",
                lambda: tk.coarse_count_per_slice(pools, starts, tree),
                lambda: tk.coarse_plain(pools, starts, False, tree, 1),
                runs * RUN_BYTES + starts.numel() * 4 + out_b)
    rows = [[get(lay.row) for get, lay in zip(req.index_rows, lays)]]
    present = sum(int(lay.hit.sum()) for lay in lays)
    return (name, "tree_count",
            lambda: tk.tree_count_rows(pools, rows, tree),
            lambda: tk.rows_plain(pools, rows, tree),
            present * 2048 * 4 + len(lays) * s * 64 + out_b)


def sparse_request_case(name: str, req, device):
    """K4 on the one sorted-array group (ss, every slice) of a two-leaf
    _SparseCount, as a measure() case (sparse_pair_case), and the
    per-(slice, container) cardinalities of its two leaves."""
    import torch

    jobs = [j for j in req.jobs if j[0] == "ss"]
    check(len(req.jobs) == 1 and len(jobs) == 1 and jobs[0][-1].all(),
          f"{name}: one sorted-array group over every slice")
    _, pa, pb, ia, ha, ib, hb, _sel = jobs[0]
    args = (pa[0], pa[1], pb[0], pb[1], *(
        torch.from_numpy(np.ascontiguousarray(t, np.int32)).to(device)
        for t in (ia, ha, ib, hb)))
    la = np.take_along_axis(pa[1].cpu().numpy(), ia, 1) * ha
    lb = np.take_along_axis(pb[1].cpu().numpy(), ib, 1) * hb
    return (name,) + sparse_pair_case(args, la, lb)[1:], la, lb


def time_phase(holder, truth: TimeTruth, card: str, device) -> dict:
    """Time Ranges over HTTP, each held against the numpy truth: every
    single day (the days stage sorted-array and a lone leaf launches
    nothing), a month (one dense view), 2 days (two sorted-array leaves:
    K4), 7 days (a wider OR demotes the days to packed words: K1) and 29
    days (beyond K2's 16 leaves: K1's lone path). Then timestamped
    SetBits over HTTP, seen through GET .../views and Ranges (one over a
    view that does not exist), and quantum inheritance over HTTP. The
    counters are set to 0 just before the server starts and read after
    the last query."""
    import torch

    from pilosa_tpu_torch.api.server import serve
    from pilosa_tpu_torch.ops import kernels as tk

    tk.reset_launches()
    srv = serve(holder, device=device)
    host, port = srv.address
    ex = srv.handler.executor
    mgr = ex.mesh_manager()
    c = Client(host, port)
    ms = {}

    def ask(q, want):
        got = c.call("POST", "/index/tq/query", q)["results"][0]
        check(got == want, (q, got, want))

    def timed(q, want, n):
        t0 = time.monotonic()
        for _ in range(n):
            ask(q, want)
        return (time.monotonic() - t0) / n * 1e3

    try:
        t0 = time.monotonic()
        for d in range(1, TIME_DAYS + 1):
            for r in range(TIME_ROWS):
                ask(days_pql(r, d, d + 1), int(truth.days[r, d - 1]))
        torch.cuda.synchronize()
        days_s = time.monotonic() - t0
        sorted_bytes = staged_bytes(mgr, "tq")
        check(sorted_bytes["views_sparse"] == TIME_DAYS,
              f"the days staged sorted-array: {sorted_bytes}")
        log(f"time phase: {TIME_DAYS * TIME_ROWS} single days (staging "
            f"{TIME_DAYS} sorted-array views, {sorted_bytes['sparse']} B) "
            f"in {days_s:.2f} s")
        collect_ms = collect_after_staging("time phase")
        k_before = dict(tk.LAUNCHES)
        ask(days_pql(0, 5, 6), int(truth.days[0, 4]))
        check(dict(tk.LAUNCHES) == k_before, "a single day launched nothing")
        first = {}
        for name, d0, d1 in TIME_COVERS:
            t0 = time.monotonic()
            for r in range(TIME_ROWS):
                ask(days_pql(r, d0, d1), truth.covers[(name, r)])
            torch.cuda.synchronize()
            first[name] = time.monotonic() - t0
            if name == "2 days":
                check(tk.LAUNCHES["sparse_pair_count"]
                      > k_before["sparse_pair_count"], "2 days launched K4")
                # K4's inputs as the pair resolves now: the 7- and
                # 29-day covers demote these views.
                k4_case, la, lb = sparse_request_case(
                    "sparse_pair_count (2 days)", resolved(
                        holder, mgr, "tq", days_pql(1, d0, d1),
                        TIME_SLICES), device)
        demoted = staged_bytes(mgr, "tq")
        log(f"time phase: first covers (staging and demotes included) "
            f"{json.dumps(first)}; staged after the demotes {demoted}")
        collect_after_staging("time phase (demoted)")
        for name, d0, d1 in TIME_COVERS:
            ms[name] = timed(days_pql(1, d0, d1), truth.covers[(name, 1)],
                             PROFILED_CALLS)
        busy = profiled(lambda: timed(days_pql(2, 1, 30),
                                      truth.covers[("29 days", 2)],
                                      PROFILED_CALLS))
        # Timestamped writes: a new month and day view, and a Range whose
        # cover holds a view that does not exist (May 1).
        cols = [3, (1 << 20) * (TIME_SLICES - 1) + 5, 777_777]
        st0 = dict(mgr.stats)
        for col in cols:
            got = c.call("POST", "/index/tq/query",
                         f"SetBit(rowID={TIME_WRITE_ROW}, frame=events, "
                         f'columnID={col}, timestamp="2017-05-02T10:00")')
            check(got == {"results": [True]}, ("SetBit", col, got))
        views = c.call("GET", "/index/tq/frame/events/views")["views"]
        check({"standard_201705", "standard_20170502"} <= set(views)
              and len(views) == 3 + TIME_DAYS + 2, views)
        # May (one new view), May 2, April 30 - May 2 (May 1 has no
        # view), April (row 5 holds nothing there).
        for start, end, want in (
                ("2017-05-01T00:00", "2017-06-01T00:00", len(cols)),
                ("2017-05-02T00:00", "2017-05-03T00:00", len(cols)),
                ("2017-04-30T00:00", "2017-05-03T00:00", len(cols)),
                ("2017-04-01T00:00", "2017-05-01T00:00", 0)):
            ask(time_pql(TIME_WRITE_ROW, start, end), want)
        refresh = {k: mgr.stats.get(k, 0) - st0.get(k, 0)
                   for k in ("stage", "incremental", "refresh_pick_restage")}
        absent_before = mgr.stats.get("absent_views", 0)
        ask(time_pql(TIME_WRITE_ROW, "2017-05-01T00:00",
                     "2017-05-02T00:00"), 0)
        check(mgr.stats.get("absent_views", 0) == absent_before + 1,
              "a cover of absent views answered without a launch")
        # Quantum inheritance over HTTP.
        c.call("POST", "/index/tq2", '{"options": {"timeQuantum": "YM"}}')
        c.call("POST", "/index/tq2/frame/f", "{}")
        c.call("POST", "/index/tq2/query", 'SetBit(rowID=1, frame=f, '
               'columnID=9, timestamp="2017-04-02T09:00")')
        views2 = c.call("GET", "/index/tq2/frame/f/views")["views"]
        check(views2 == ["standard", "standard_2017", "standard_201704"],
              views2)
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        stats = dict(ex.stats)
        mstats = dict(mgr.stats)
        # K1 on the 7- and 29-day covers as the main path ran them: one
        # staged (demoted) day view a leaf.
        covers = {name: resolved(holder, mgr, "tq", days_pql(1, d0, d1),
                                 TIME_SLICES)
                  for name, d0, d1 in TIME_COVERS
                  if name in ("7 days", "29 days")}
    finally:
        c.close()
        srv.close()
    kern = time_kernel_cases(truth, covers, k4_case, la, lb, device)
    log(f"time phase on {card}: ms per Count(Range) {json.dumps(ms)}")
    log(f"time phase launches {launches}; executor {stats}")
    log(f"time phase profile ({PROFILED_CALLS} Counts of 29 days): device "
        f"busy "
        f"{busy['device_busy_s']:.4f} s of {busy['wall_s']:.4f} s wall = "
        f"{busy['device_busy_share']:.4f}")
    log(f"time phase stats {json.dumps(mstats, sort_keys=True)}")
    log(f"time phase: the timestamped writes and the Ranges after them "
        f"staged {refresh['stage']} times ({refresh['refresh_pick_restage']}"
        f" of them restages of views with a sorted-array pool, which have "
        f"no scatter; the rest new views, and restages after the new row "
        f"{TIME_WRITE_ROW} added containers) and scattered "
        f"{refresh['incremental']} times")
    for k in TIME_PATH:
        check(launches[k] > 0, f"kernel {k} launched on the time path")
    check(stats.get("count_host", 0) == 0, "no time Range on the host")
    check(mstats.get("sparse_demote", 0) >= 29, "the days demoted")
    return {"launches": launches, "stats": stats, "mesh_stats": mstats,
            "slices": TIME_SLICES, "collect_after_staging_ms": collect_ms,
            "single_days_s": days_s, "first_cover_s": first,
            "ms_per_query": ms, "profile": busy,
            "staged_sorted_array": sorted_bytes,
            "staged_after_demotes": demoted, "writes_refresh": refresh,
            "kernels": kern}


def time_kernel_cases(truth: TimeTruth, covers: dict, k4_case, la, lb,
                      device) -> dict:
    """The time path's kernels at its own shapes, each held exactly
    against its plain version and timed, and its total against the
    numpy truth: K1 over the 7- and 29-day covers (one pool a leaf, 96
    slices), K4 over the 2-day pair, and K1 on the 29-day tree over 29
    random row runs at the headline's SLICES, where K1 fills the card."""
    import torch

    from pilosa_tpu_torch.ops import kernels as tk

    cover_cases = {name: request_case(f"coarse_count ({name})", req)
                   for name, req in covers.items()}
    for name, case in cover_cases.items():
        got = int(case[2]().sum())
        check(got == truth.covers[(name, 1)],
              (case[0], got, truth.covers[(name, 1)]))
    inter = k4_case[2]().cpu().numpy()
    check(op_count("or", inter, la, lb) == truth.covers[("2 days", 1)],
          "K4 over 2 days = truth")
    req_tree = covers["29 days"].tree
    pool, starts, _tab = random_runs(SLICES, TIME_DAYS - 1, device,
                                     truth.seed + 5)
    pools = (pool,) * (TIME_DAYS - 1)
    wide = (f"coarse_count (29 days, S={SLICES})", "coarse_count",
            lambda: tk.coarse_count_uniform(pools, starts, req_tree),
            lambda: tk.coarse_plain(pools, starts, True, req_tree, 1),
            (TIME_DAYS - 1) * SLICES * RUN_BYTES + 4 * SLICES)
    log("time phase kernels (row 1; each held exactly against its plain "
        "version):")
    out = measure([*cover_cases.values(), k4_case, wide], 20)
    del pool, pools
    torch.cuda.empty_cache()
    return out


# -- phase 10: TopN, its rank cache and the attribute stores --------------------

# Index `t`, frame `topn`: the repo's own TopN configuration
# (bench.py:114-150, 1979-2019) at TOPN_SLICES slices: 4096 rows, one
# container (block 0) per row per slice, ~30% bitmaps of ~25% fill, the
# rest sorted arrays of n ~ U[1, 4096], 10% of rows absent per slice.
# Row 0 is a bitmap in every slice: the src of the Tanimoto query.
TOPN_SLICES = 64
TOPN_ROWS = 4096
TOPN_N = 100
TOPN_LONE_CALLS = 200  # lone TopN(frame=general, n=100) over HTTP
TOPN_TIMED_CALLS = 50  # lone TopN(frame=topn, n=100), timed
PROFILED_CALLS = 20    # the round torch.profiler reads
TOPN_ATTR_ROWS = np.arange(0, TOPN_ROWS, 41)[:100]  # SetRowAttrs targets
TOPN_TANIMOTO = 10
TOPN_PATH = ("pair_count", "probe_ok")


class TopnTruth:
    """Per-row totals over the slices: `counts` (bits), `inter` (bits in
    common with row 0)."""

    def __init__(self, num_slices: int, seed: int):
        self.num_slices, self.seed = num_slices, seed
        self.counts = np.zeros(TOPN_ROWS, dtype=np.int64)
        self.inter = np.zeros(TOPN_ROWS, dtype=np.int64)

    def slice_rows(self, s: int):
        """(words (rows, 1024) uint64, bitmap rows, {array row: sorted
        uint32 values}) of slice s."""
        rng = np.random.default_rng([self.seed, 13, s])
        present = rng.random(TOPN_ROWS) >= 0.1
        is_bm = rng.random(TOPN_ROWS) < 0.3
        present[0] = is_bm[0] = True
        bm_rows = np.flatnonzero(present & is_bm)
        w = np.zeros((TOPN_ROWS, 1024), dtype=np.uint64)
        w[bm_rows] = (rng.integers(0, 2**64, size=(len(bm_rows), 1024),
                                   dtype=np.uint64)
                      & rng.integers(0, 2**64, size=(len(bm_rows), 1024),
                                     dtype=np.uint64))
        perm = rng.permutation(65536).astype(np.uint32)
        arr_rows = np.flatnonzero(present & ~is_bm)
        ns = rng.integers(1, 4097, size=len(arr_rows))
        starts = rng.integers(0, 65536 - ns)
        arrays = {int(r): np.sort(perm[a:a + n])
                  for r, a, n in zip(arr_rows, starts, ns)}
        if arrays:
            pos = np.concatenate([v.astype(np.int64) + (r << 16)
                                  for r, v in arrays.items()])
            np.bitwise_or.at(w.view(np.uint8).reshape(-1), pos >> 3,
                             (1 << (pos & 7)).astype(np.uint8))
        return w, bm_rows, arrays

    def add(self, w: np.ndarray) -> None:
        self.counts += np.bitwise_count(w).sum(axis=1, dtype=np.int64)
        self.inter += np.bitwise_count(w & w[0]).sum(axis=1, dtype=np.int64)

    @staticmethod
    def rank(counts, n: int, thr: int = 1, ids=None, keep=None):
        """TopN's pairs on the card path: exact totals at or above the
        threshold, by count then id; `ids` restricts the rows (and n is
        then 0), `keep` is the attr filter."""
        rows = np.arange(len(counts))
        sel = counts >= max(thr, 1)
        if ids is not None:
            sel &= np.isin(rows, ids)
            n = 0
        if keep is not None:
            sel &= keep
        order = np.lexsort((rows[sel], -counts[sel]))
        out = [{"id": int(r), "count": int(k)} for r, k in
               zip(rows[sel][order], counts[sel][order])]
        return out[:n] if n else out

    def tanimoto(self, t: int, n: int = 0):
        src = int(self.counts[0])
        full, inter = self.counts, self.inter
        band = (full > src * t / 100.0) & (full < src * 100.0 / t) & (inter > 0)
        union = np.maximum(full + src - inter, 1)
        sim = -(-100 * inter // union)
        return self.rank(np.where(band & (sim > t), inter, 0), n)


def add_topn_index(holder, truth: TopnTruth) -> float:
    """Index `t`, frame `topn`: slice by slice as whole storage images
    (the rank cache is rebuilt from each image), by a pool of threads.
    Returns the seconds spent."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.roaring import Bitmap, Container

    t0 = time.monotonic()
    view = holder.create_index("t").create_frame(
        "topn").create_view_if_not_exists("standard")

    def one(s):
        w, bm_rows, arrays = truth.slice_rows(s)
        bm = Bitmap()
        for r in sorted(set(bm_rows.tolist()) | set(arrays)):
            bm.keys.append(r * 16)
            bm.containers.append(Container(array=arrays[r]) if r in arrays
                                 else Container(bitmap=w[r].copy()))
        view.create_fragment_if_not_exists(s).replace(bm)
        return w

    with ThreadPoolExecutor(8) as pool:
        for w in pool.map(one, range(truth.num_slices)):
            truth.add(w)
    return time.monotonic() - t0


def general_topn(words: np.ndarray, n: int):
    counts = np.bitwise_count(words).sum(axis=(0, 2, 3), dtype=np.int64)
    return TopnTruth.rank(counts, n)


def rows_case(mgr, key, want: np.ndarray, name: str) -> dict:
    """K5 over a staged view at its serving shape, as TopN runs it
    (every row, b = none), held exactly against its plain version
    (plain timed once: it takes seconds) and its totals against `want`
    (the numpy truth by row id), and timed. Bound: the containers
    present, read once, the index table and the (R,) output."""
    import torch

    from pilosa_tpu_torch.ops import kernels as tk

    sv = mgr._views[key]
    pool, a_idx = sv.sharded.words, sv.row_table()
    present = int((a_idx >= 0).sum())
    nbytes = present * 8192 + a_idx.numel() * 4 + 8 * a_idx.shape[0]
    got = tk.pair_count_rows(pool, a_idx).cpu().numpy()
    check(got.tolist() == want[sv.sharded.row_ids.astype(np.int64)].tolist(),
          f"{name}: K5 = truth")
    res = measure([(name, "pair_count",
                    lambda: tk.pair_count_rows(pool, a_idx),
                    lambda: tk.pair_rows_plain(pool, a_idx, "and", None,
                                               None, None), nbytes)],
                  20, plain_reps=1)[name]
    res.update(library_ms=None, index_table_bytes=a_idx.numel() * 4,
               pool_bytes=pool.numel() * 4, containers_present=present,
               shape=list(a_idx.shape))
    log(f"  {name}: index table {a_idx.numel() * 4} B, pool "
        f"{pool.numel() * 4} B, {present} containers present")
    return res


def topn_phase(holder, words: np.ndarray, truth: TopnTruth, card: str,
               device) -> dict:
    """TopN over HTTP: lone TopN(frame=general, n=100) on the headline's
    960 slices (p50 / p90 of TOPN_LONE_CALLS calls), then frame `topn`
    in every form (n, threshold, ids, a src Bitmap, field / filters
    after SetRowAttrs over HTTP on 100 rows, tanimotoThreshold), each
    held against the numpy truth with the card path's semantics, and a
    Bitmap's attrs. K5 at the `topn` shape against its plain version.
    The counters are set to 0 just before the server starts (it
    launches K0) and read after the last query."""
    import torch

    from pilosa_tpu_torch.api.server import serve
    from pilosa_tpu_torch.ops import kernels as tk

    want_general = general_topn(words, TOPN_N)
    thr = int(np.sort(truth.counts)[-300])
    ids = sorted(np.random.default_rng(truth.seed).choice(
        TOPN_ROWS, 50, replace=False).tolist()) + [TOPN_ROWS + 7]
    cats = {int(r): "ab"[k % 2] for k, r in enumerate(TOPN_ATTR_ROWS)}
    keep_a = np.zeros(TOPN_ROWS, dtype=bool)
    keep_a[[r for r, v in cats.items() if v == "a"]] = True
    queries = [
        (f"TopN(frame=topn, n={TOPN_N})", truth.rank(truth.counts, TOPN_N)),
        (f"TopN(frame=topn, n={TOPN_N}, threshold={thr})",
         truth.rank(truth.counts, TOPN_N, thr)),
        (f"TopN(frame=topn, threshold={thr})",
         truth.rank(truth.counts, 0, thr)),
        (f"TopN(frame=topn, ids={json.dumps(ids).replace(' ', '')})",
         truth.rank(truth.counts, 0, ids=ids)),
        (f"TopN(Bitmap(rowID=0, frame=topn), frame=topn, n={TOPN_N})",
         truth.rank(truth.inter, TOPN_N)),
        (f'TopN(frame=topn, n=10, field="cat", filters=["a"])',
         truth.rank(truth.counts, 10, keep=keep_a)),
        (f"TopN(Bitmap(rowID=0, frame=topn), frame=topn, "
         f"tanimotoThreshold={TOPN_TANIMOTO})",
         truth.tanimoto(TOPN_TANIMOTO)),
    ]
    tk.reset_launches()
    srv = serve(holder, device=device)
    host, port = srv.address
    ex = srv.handler.executor
    mgr = ex.mesh_manager()
    c = Client(host, port)

    def ask(index, q, want):
        got = c.call("POST", f"/index/{index}/query", q)["results"][0]
        check(got == want, (q, str(got)[:200], str(want)[:200]))

    def lat(index, q, want, n):
        out = []
        for _ in range(n):
            t0 = time.monotonic()
            ask(index, q, want)
            out.append((time.monotonic() - t0) * 1e3)
        return {"calls": n, "p50_ms": float(np.percentile(out, 50)),
                "p90_ms": float(np.percentile(out, 90)),
                "mean_ms": float(np.mean(out))}

    try:
        gq = f"TopN(frame=general, n={TOPN_N})"
        t0 = time.monotonic()
        ask("i", gq, want_general)
        general_first_s = time.monotonic() - t0
        lone = lat("i", gq, want_general, TOPN_LONE_CALLS)
        log(f"topn phase: lone {gq} over HTTP at {SLICES} slices: p50 "
            f"{lone['p50_ms']:.3f} ms, p90 {lone['p90_ms']:.3f} ms "
            f"({TOPN_LONE_CALLS} calls; first {general_first_s:.2f} s)")
        t0 = time.monotonic()
        ask("t", *queries[0])
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        staged = staged_bytes(mgr, "t")
        table_b = mgr._views[("t", "topn", "standard")].rows_dev.numel() * 4
        log(f"topn phase: first TopN (staging {staged['dense']} B, index "
            f"table {table_b} B) {first_s:.2f} s")
        collect_ms = collect_after_staging("topn phase")
        body = " ".join(f'SetRowAttrs(frame=topn, rowID={r}, cat="{v}")'
                        for r, v in cats.items())
        got = c.call("POST", "/index/t/query", body)
        check(got == {"results": [None] * len(cats)}, "SetRowAttrs")
        r0 = int(TOPN_ATTR_ROWS[2])
        got = c.call("POST", "/index/t/query",
                     f"Bitmap(rowID={r0}, frame=topn)")["results"][0]
        check(got["attrs"] == {"cat": cats[r0]}, ("Bitmap attrs", got["attrs"]))
        for q, want in queries:
            ask("t", q, want)
        check(len(queries[-1][1]) > 0, "the Tanimoto band holds rows")
        topn_lat = lat("t", queries[0][0], queries[0][1], TOPN_TIMED_CALLS)
        busy = profiled(lambda: lat("t", queries[0][0], queries[0][1],
                                    PROFILED_CALLS))
        log(f"topn phase: TopN(frame=topn, n={TOPN_N}) p50 "
            f"{topn_lat['p50_ms']:.3f} ms, p90 {topn_lat['p90_ms']:.3f} ms")
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        stats = dict(ex.stats)
        mstats = dict(mgr.stats)
        kern = {
            "pair_count_rows (TopN, frame topn)": rows_case(
                mgr, ("t", "topn", "standard"), truth.counts,
                f"pair_count_rows (TopN, {TOPN_ROWS} rows x {TOPN_SLICES} "
                f"slices)"),
            "pair_count_rows (TopN, frame general)": rows_case(
                mgr, ("i", "general", "standard"), np.bitwise_count(
                    words).sum(axis=(0, 2, 3), dtype=np.int64),
                f"pair_count_rows (TopN, {words.shape[1]} rows x "
                f"{words.shape[0]} slices)")}
    finally:
        c.close()
        srv.close()
    log(f"topn phase on {card}: launches {launches}; executor {stats}")
    log(f"topn phase profile ({PROFILED_CALLS} TopNs of frame topn): "
        f"device busy "
        f"{busy['device_busy_s']:.4f} s of {busy['wall_s']:.4f} s wall = "
        f"{busy['device_busy_share']:.4f}")
    log(f"topn phase stats {json.dumps(mstats, sort_keys=True)}")
    for k in TOPN_PATH:
        check(launches[k] > 0, f"kernel {k} launched on the TopN path")
    check(stats.get("topn_host", 0) == 0 and stats.get("topn_device", 0)
          == 1 + TOPN_LONE_CALLS + 1 + len(queries) + TOPN_TIMED_CALLS
          + PROFILED_CALLS,
          f"every TopN on the card: {stats}")
    check(mstats.get("kernel:pair_count_rows", 0) >= stats["topn_device"],
          "each TopN counted on K5")
    return {"launches": launches, "stats": stats, "mesh_stats": mstats,
            "slices": TOPN_SLICES, "rows": TOPN_ROWS,
            "lone_general": lone, "general_first_s": general_first_s,
            "topn_latency": topn_lat, "first_query_s": first_s,
            "collect_after_staging_ms": collect_ms, "staged": staged,
            "index_table_bytes": table_b, "profile": busy, "kernels": kern}


# -- phase 11: writes into the staged image ------------------------------------

WRITE_ROUNDS = 90
WRITE_BATCHES = (1, 16, 256)  # SetBit / ClearBit calls a round, in turn
WRITERS = 16                  # concurrent clients (rounds and the herd)
WRITER_OPS = 100              # SetBits each herd client sends
WRITE_PATH = ("apply_writes", "coarse_count")
K7_WIDE = (SLICES, 1024)      # K7 held at a shape above a launch floor
K7_SWEEP = (8, 64, 256, 1024, 4096)  # K7's entries a slice, at SLICES
K7_CAP = 160                  # the headline view's capacity: 10 row runs
SECTOR = 32                   # bytes the card moves to touch one word


def flip_bits(words: np.ndarray, rows, cols, set_: np.ndarray) -> None:
    """Apply SetBit (set_) / ClearBit writes at (row, column) to the
    (S, rows, 16, 1024) uint64 truth."""
    cols = np.asarray(cols, dtype=np.int64)
    s, o = cols >> 20, cols & ((1 << 20) - 1)
    b, i = o >> 16, o & 0xFFFF
    bit = np.left_shift(np.uint64(1), (i & 63).astype(np.uint64))
    idx = (s, np.asarray(rows), b, i >> 6)
    for k in range(len(cols)):  # one at a time: a word may repeat
        at = tuple(a[k] for a in idx)
        words[at] = (words[at] | bit[k]) if set_[k] else (
            words[at] & ~bit[k])


def k7_offsets(pool, batch):
    """The flat word offsets (int64) of a K7 batch's live entries into
    `pool`, in entry order."""
    import torch

    slot, word = batch[0], batch[1]
    s, cap = pool.shape[0], pool.shape[1]
    live = (slot >= 0) & (slot < cap) & (word >= 0) & (word < 2048)
    s_idx = torch.arange(s, device=slot.device)[:, None].expand_as(slot)
    flat = (s_idx * cap + slot.long()) * 2048 + word.long()
    return flat[live].contiguous()


def k7_sectors(offsets) -> int:
    """The 32-byte sectors (8 words) a set of word offsets touches."""
    import torch

    return int(torch.unique(offsets // 8).numel())


def k7_case(name: str, pool, batch, reps: int = 200) -> dict:
    """K7 on a clone of a staged pool against its plain version on
    another clone, the same (S, B) card batches, timed by events and by
    the profiler. Bound: a 32-byte sector read and written for each
    sector the live entries touch, and each entry's 16 bytes read, over
    the card's memory rate. Returns {name: row}."""
    import torch

    from pilosa_tpu_torch.ops import kernels as tk

    a, b = pool.clone(), pool.clone()
    tk.scatter_words(a, *batch)
    tk.scatter_plain(b, *batch)
    torch.cuda.synchronize()
    err = 0 if torch.equal(a, b) else int(
        (a.to(torch.int64) - b.to(torch.int64)).abs().max())
    check(err == 0, f"{name}: K7 != plain")
    offsets = k7_offsets(pool, batch)
    live, sectors = int(offsets.numel()), k7_sectors(offsets)
    nbytes = sectors * 2 * SECTOR + batch[0].numel() * 16
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    plain_ms = time_ms(lambda: tk.scatter_plain(b, *batch), 10)
    ms = time_ms(lambda: tk.scatter_words(a, *batch), reps)
    # A trace lacks the first launches after it opens (20 of K7's in a run
    # with 10 warm calls): warm it for longer.
    dev_ms, missed = device_ms(lambda: tk.scatter_words(a, *batch), reps,
                               warm_calls=100)
    del a, b
    dev_s = f"{dev_ms:.4f}" if dev_ms is not None else "null"
    log(f"  {name:44s} apply_writes {ms:8.4f} ms (device {dev_s})  "
        f"bound {bound_ms:.5f} ms  plain {plain_ms:.3f} ms  exact")
    return {name: {"kernel": "apply_writes", "ms": ms, "device_ms": dev_ms,
                   "trace_missed": missed, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": "bytes",
                   "bytes": nbytes, "entries": int(batch[0].numel()),
                   "live_entries": live, "sectors": sectors,
                   "shape": list(batch[0].shape), "library_ms": None,
                   "max_abs_err": err}}


PROBE_FLIP = 0x80000001  # the bits the probe's exactness check flips


def sector_case(name: str, pool, batch, reps: int = 200) -> dict:
    """The scattered-sector probe (kernels.sector_probe, a measurement,
    not a kernel of any path) over the sectors of a K7 batch's live
    entries in the same order and in K7's block size, held exactly against its plain version with PROBE_FLIP, then timed
    with flip 0 by events and by the profiler. Its bytes: a 32-byte
    sector read and written a sector and 8 bytes an offset. Returns
    {name: row}, or {} where the package has no probe."""
    import torch

    from pilosa_tpu_torch.ops import kernels as tk

    if not hasattr(tk, "sector_probe"):
        return {}
    offsets = k7_offsets(pool, batch)
    a, b = pool.clone(), pool.clone()
    tk.sector_probe(a, offsets, PROBE_FLIP)
    tk.sector_probe_plain(b, offsets, PROBE_FLIP)
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"{name}: probe != plain")
    sectors = k7_sectors(offsets)
    nbytes = sectors * 2 * SECTOR + offsets.numel() * 8

    def run():
        tk.sector_probe(a, offsets, 0)

    ms = time_ms(run, reps)
    dev_ms, missed = device_ms(run, reps, warm_calls=100)
    del a, b
    dev_s = f"{dev_ms:.4f}" if dev_ms is not None else "null"
    log(f"  {name:44s} sector_probe {ms:8.4f} ms (device {dev_s})  "
        f"{sectors} sectors, {nbytes / (dev_ms or ms) / 1e6:7.1f} GB/s")
    return {name: {"kernel": "sector_probe", "ms": ms, "device_ms": dev_ms,
                   "trace_missed": missed, "bytes": nbytes,
                   "sectors": sectors, "offsets": int(offsets.numel()),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes", "max_abs_err": 0}}


def k7_sweep_batch(s: int, cap: int, b: int, device, seed: int):
    """(S, b) batches of b unique targets a slice, sorted by (slot,
    word) as the planner sorts them, with random masks: the four int32
    card tensors."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand((s, cap * 2048), device=device, generator=g).topk(
        b, dim=1).indices.sort(dim=1).values
    masks = [torch.randint(-2**31, 2**31 - 1, (s, b), generator=g,
                           device=device, dtype=torch.int32)
             for _ in range(2)]
    return ((flat // 2048).to(torch.int32).contiguous(),
            (flat % 2048).to(torch.int32).contiguous(), *masks)


def k7_sweep(pool, device, seed: int) -> dict:
    """K7 at K7_WIDE (random slots, words 0, 2, .., 2046 a slice) and at
    every entry count of K7_SWEEP, each beside the scattered-sector
    probe over the same sectors (k7_case, sector_case)."""
    import torch

    s_, b_ = K7_WIDE
    g = torch.Generator(device=device).manual_seed(seed)
    wide = (torch.randint(0, pool.shape[1], (s_, b_), generator=g,
                          device=device, dtype=torch.int32),
            (torch.arange(b_, device=device, dtype=torch.int32) * 2)
            .repeat(s_, 1),
            torch.randint(-2**31, 2**31 - 1, (s_, b_), generator=g,
                          device=device, dtype=torch.int32),
            torch.randint(-2**31, 2**31 - 1, (s_, b_), generator=g,
                          device=device, dtype=torch.int32))
    out = k7_case(f"apply_writes ({s_} x {b_})", pool, wide)
    out.update(sector_case(f"sector_probe ({s_} x {b_})", pool, wide))
    for b in K7_SWEEP:
        batch = k7_sweep_batch(pool.shape[0], pool.shape[1], b, device,
                               seed + b)
        out.update(k7_case(f"apply_writes sweep ({pool.shape[0]} x {b})",
                           pool, batch))
        out.update(sector_case(f"sector_probe ({pool.shape[0]} x {b})",
                               pool, batch))
        del batch
        torch.cuda.empty_cache()
    return out


def write_phase(holder, words: np.ndarray, card: str, device,
                seed: int) -> dict:
    """Writes mixed with queries over HTTP on frame `general` (dense, 960
    slices) under the holder's `group` policy: WRITE_ROUNDS rounds, each
    a batch of W in WRITE_BATCHES SetBit / ClearBit calls into existing
    containers of rows 0-7 (from up to WRITERS clients at once), then a
    timed Count(Intersect) held against numpy with the writes applied;
    every round's refresh must be a scatter (the stats deltas). Then a
    write into a new row, which must restage, timed beside the scatters;
    then WRITERS clients sending SetBits at once into the newest slice
    (write QPS, fsyncs, ops per commit). K7 is then held against its
    plain version at the rounds' batch shapes, at K7_WIDE and over the
    K7_SWEEP entry counts, each sweep shape beside the scattered-sector
    probe (k7_sweep). The
    counters are set to 0 just before the server starts and read after
    the last query. `words` is updated to the written state."""
    import torch

    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.api.server import serve
    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.parallel import serve as tserve

    rng = np.random.default_rng(seed + 7)
    frags = list(holder.view("i", "general", "standard").fragments.values())
    policy = frags[0]._wal.cfg.fsync_policy
    check(policy == "group", f"the holder writes under group, not {policy}")
    batches: dict = {}
    real_apply = tserve.apply_writes
    current = {"w": None}

    def recording_apply(staged, *batch):
        batches.setdefault(current["w"], tuple(np.array(a) for a in batch))
        return real_apply(staged, *batch)

    def wal_totals():
        return (sum(f._wal.fsyncs for f in frags),
                sum(f._wal.committed_ops for f in frags))

    tk.reset_launches()
    srv = serve(holder, device=device)
    host, port = srv.address
    ex = srv.handler.executor
    mgr = ex.mesh_manager()
    clients = [Client(host, port) for _ in range(WRITERS)]
    pool_ex = ThreadPoolExecutor(WRITERS)
    c = clients[0]
    tserve.apply_writes = recording_apply
    try:
        t0 = time.monotonic()
        check(c.count(pql("and", 0, 1)) == host_count(words, "and", 0, 1),
              "first Count")
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        log(f"write phase: first query (staging) {first_s:.2f} s")
        collect_ms = collect_after_staging("write phase")
        lat = {w: [] for w in WRITE_BATCHES}
        paths = []
        write_s = {w: 0.0 for w in WRITE_BATCHES}
        for k in range(WRITE_ROUNDS):
            w = WRITE_BATCHES[k % len(WRITE_BATCHES)]
            current["w"] = w
            cols = np.unique(rng.integers(0, SLICES << 20, size=w))
            while len(cols) < w:
                cols = np.unique(np.concatenate([cols, rng.integers(
                    0, SLICES << 20, size=w - len(cols))]))
            rows = rng.integers(0, DENSE_ROWS, size=w)
            set_ = rng.random(w) < 0.5
            calls = [f"{'SetBit' if s_ else 'ClearBit'}(rowID={r}, "
                     f"frame=general, columnID={col})"
                     for r, col, s_ in zip(rows, cols, set_)]
            parts = [calls[j::WRITERS] for j in range(min(w, WRITERS))]
            before = dict(mgr.stats)
            t0 = time.monotonic()
            list(pool_ex.map(lambda j: clients[j].call(
                "POST", "/index/i/query", " ".join(parts[j])),
                range(len(parts))))
            write_s[w] += time.monotonic() - t0
            flip_bits(words, rows, cols, set_)
            a, b = (int(x) for x in rng.choice(DENSE_ROWS, 2, replace=False))
            want = host_count(words, "and", a, b)
            t0 = time.monotonic()
            got = c.count(pql("and", a, b))
            lat[w].append((time.monotonic() - t0) * 1e3)
            check(got == want, ("post-write Count", k, w, got, want))
            d = {key: mgr.stats.get(key, 0) - before.get(key, 0)
                 for key in ("incremental", "stage")}
            paths.append("incremental" if d == {"incremental": 1, "stage": 0}
                         else json.dumps(d))
        every = [x for w in WRITE_BATCHES for x in lat[w]]
        post = {"p50_ms": float(np.percentile(every, 50)),
                "p90_ms": float(np.percentile(every, 90)),
                "by_batch": {str(w): {
                    "rounds": len(lat[w]),
                    "p50_ms": float(np.percentile(lat[w], 50)),
                    "p90_ms": float(np.percentile(lat[w], 90)),
                    "write_s_per_round": write_s[w] / len(lat[w])}
                    for w in WRITE_BATCHES}}
        by_path = dict(Counter(paths))
        log(f"write phase on {card}: the Count after each round's writes, "
            f"p50 {post['p50_ms']:.3f} ms, p90 {post['p90_ms']:.3f} ms over "
            f"{WRITE_ROUNDS} rounds; by W {json.dumps(post['by_batch'])}")
        log(f"write phase: refresh path per round {json.dumps(by_path)}")
        check(by_path == {"incremental": WRITE_ROUNDS},
              f"every round scattered: {by_path}")
        sv = mgr._views[("i", "general", "standard")]
        inc_ewma_ms = (sv.inc_ewma_s or 0.0) * 1e3
        # A write into a new row adds a container: a restage.
        before = dict(mgr.stats)
        col = int(rng.integers(0, SLICES << 20))
        c.call("POST", "/index/i/query",
               f"SetBit(rowID={DENSE_ROWS + 12}, frame=general, "
               f"columnID={col})")
        t0 = time.monotonic()
        got = c.count(f"Count(Bitmap(rowID={DENSE_ROWS + 12}))")
        torch.cuda.synchronize()
        restage_ms = (time.monotonic() - t0) * 1e3
        check(got == 1, ("Count of the new row", got))
        d = {key: mgr.stats.get(key, 0) - before.get(key, 0)
             for key in ("incremental", "stage", "stage_us")}
        check(d["stage"] == 1 and d["incremental"] == 0,
              f"the churn write restaged: {d}")
        collect_after_staging("write phase (restage)")
        sv2 = mgr._views[("i", "general", "standard")]
        for _ in range(100):  # the staging's measurement lands on a worker
            if sv2.last_stage_s is not None:
                break
            time.sleep(0.01)
        restage = {"count_ms": restage_ms, "stage_us": d["stage_us"],
                   "last_stage_s": sv2.last_stage_s,
                   "scatter_ewma_ms": inc_ewma_ms}
        log(f"write phase: the churn write's Count {restage_ms:.1f} ms "
            f"(restage {d['stage_us'] / 1e3:.1f} ms on the host, "
            f"{(sv2.last_stage_s or 0) * 1e3:.1f} ms to the card's "
            f"completion) against a scatter's {inc_ewma_ms:.3f} ms "
            f"(the gate's estimate) and the post-write Count p50 "
            f"{post['p50_ms']:.3f} ms")
        # The herd: WRITERS clients at once into the newest slice, where
        # new columns arrive.
        herd_cols = ((SLICES - 1) << 20) + rng.choice(
            1 << 20, size=(WRITERS, WRITER_OPS), replace=False)
        herd_rows = rng.integers(0, DENSE_ROWS, size=(WRITERS, WRITER_OPS))
        fs0, ops0 = wal_totals()

        def herd(j):
            cl = clients[j]
            return [cl.call("POST", "/index/i/query",
                            f"SetBit(rowID={r}, frame=general, "
                            f"columnID={col})")["results"][0]
                    for r, col in zip(herd_rows[j], herd_cols[j])]

        current["w"] = "herd"
        t0 = time.monotonic()
        acks = list(pool_ex.map(herd, range(WRITERS)))
        herd_s = time.monotonic() - t0
        fs1, ops1 = wal_totals()
        flip_bits(words, herd_rows.ravel(), herd_cols.ravel(),
                  np.ones(herd_cols.size, dtype=bool))
        n = WRITERS * WRITER_OPS
        herd_out = {"writes": n, "seconds": herd_s, "write_qps": n / herd_s,
                    "fsyncs": fs1 - fs0, "ops": ops1 - ops0,
                    "ops_per_commit": (ops1 - ops0) / max(1, fs1 - fs0),
                    "changed": int(sum(sum(bool(x) for x in a)
                                       for a in acks))}
        check(herd_out["ops"] == n and 0 < herd_out["fsyncs"] < n,
              f"the herd's writes shared commits: {herd_out}")
        got = c.count(pql("and", 0, 1))
        check(got == host_count(words, "and", 0, 1), ("after the herd", got))
        log(f"write phase: {WRITERS} clients x {WRITER_OPS} SetBits into "
            f"slice {SLICES - 1}: {herd_out['write_qps']:.1f} writes/s, "
            f"{herd_out['fsyncs']} fsyncs for {herd_out['ops']} ops "
            f"({herd_out['ops_per_commit']:.2f} ops per commit)")
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        stats = dict(ex.stats)
        mstats = dict(mgr.stats)
        # K7 against its plain version: the rounds' batches, then K7_WIDE
        # unique targets (distinct words, random slots) per slice and the
        # K7_SWEEP batches, each beside the scattered-sector probe.
        pool = mgr._views[("i", "general", "standard")].sharded.words
        kern = {}
        for w in WRITE_BATCHES:
            dev = tuple(torch.from_numpy(np.ascontiguousarray(a).view(
                np.int32)).to(device) for a in batches[w])
            kern.update(k7_case(f"apply_writes (round batch, W={w})",
                                pool, dev))
        kern.update(k7_sweep(pool, device, seed))
    finally:
        tserve.apply_writes = real_apply
        pool_ex.shutdown()
        for cl in clients:
            cl.close()
        srv.close()
    log(f"write phase launches {launches}; executor {stats}")
    log(f"write phase stats {json.dumps(mstats, sort_keys=True)}")
    for k in WRITE_PATH:
        check(launches[k] > 0, f"kernel {k} launched on the write path")
    check(launches["apply_writes"] == mstats.get("incremental", 0),
          "one K7 launch a scatter")
    return {"launches": launches, "stats": stats, "mesh_stats": mstats,
            "first_query_s": first_s, "collect_after_staging_ms": collect_ms,
            "post_write_count": post, "paths": by_path,
            "restage": restage, "herd": herd_out, "kernels": kern,
            "policy": policy}


# -- phase 13: durability and integrity --------------------------------------------

DUR_SLICES = (0, 1, 2, 3)   # the slices the durability writers write
DUR_MASK_ROW = 21           # holds every column a writer may set
DUR_CANDIDATES = 40_000     # such columns per written slice
DUR_SNAPSHOTS = 1           # background snapshots each written slice takes
DUR_MAX_WAL_OPS = 256       # the backpressure step's bound
DUR_STALL = "storage.fsync:kind=snapshot,delay=2s"
KILL_MAX_OP_N = 500         # the killed servers' snapshot threshold
KILLS = (("commit fsync", "storage.fsync:kind=commit,after=300,"
          "error=SIGKILL"),
         ("snapshot fsync", "storage.fsync:kind=snapshot,after=1,"
          "error=SIGKILL"),
         ("rename", "storage.rename:after=1,error=SIGKILL"))
ROT_SCRUBBED, ROT_COLD = 5, 7   # the slices whose files the rot step flips
ROT_OFFSET = 4096               # inside the snapshot region
SHADOW_ROUND = 1                # queries each of the clients sends
# Clients of the 1-in-1 round: each Count pays a host fold (~0.4 s
# alone, longer under concurrency), so the round is cut from 16.
SHADOW_CLIENTS = 4
SHADOW_TIMED = ((1, 10), (100, 100), (0, 100))  # (1 in N, lone Counts)
DURABILITY_PATH = ("apply_writes", "coarse_count", "tree_count", "probe_ok")


class DurTruth:
    """The durability phase's numpy truth. Every write sets row 0 at a
    column where row 0 is clear and row 1 set, so it adds exactly one
    to Count(Intersect(row 0, row 1)), and the columns it may take are
    the mask row's: the bits a run kept are then Intersect(row 0,
    mask), read over HTTP whatever died. `sent` holds each column a
    client sent, `acked` each one a 200 answered."""

    def __init__(self, words: np.ndarray, seed: int):
        self.words = words
        self.c0 = host_count(words, "and", 0, 1)
        self.p0 = host_count(words, "and", PARTIAL_ROW, 0)
        rng = np.random.default_rng([seed, 13])
        self.free = {}
        self.row8 = set()
        for s in DUR_SLICES:
            r0 = np.unpackbits(words[s, 0].view(np.uint8), bitorder="little")
            r1 = np.unpackbits(words[s, 1].view(np.uint8), bitorder="little")
            r8 = np.unpackbits(words[s, PARTIAL_ROW].view(np.uint8),
                               bitorder="little")
            cols = rng.permutation(np.flatnonzero(
                (r0 == 0) & (r1 == 1)))[:DUR_CANDIDATES]
            self.free[s] = list(int(c) for c in cols[::-1])
            self.row8.update((s << 20) | int(c) for c in cols if r8[c])
        self.mask = {s: np.sort(np.asarray(self.free[s], dtype=np.uint32))
                     for s in DUR_SLICES}
        self.sent, self.acked = set(), set()
        self.kept = set()  # the writes the image holds
        self.mu = threading.Lock()

    def next_col(self, s: int) -> int:
        with self.mu:
            col = (s << 20) | self.free[s].pop()
            self.sent.add(col)
            return col

    def ack(self, col: int) -> None:
        with self.mu:
            self.acked.add(col)
            self.kept.add(col)

    def count(self, kept=None) -> int:
        return self.c0 + len(self.kept if kept is None else kept)

    def partial(self, kept=None) -> int:
        return self.p0 + len((self.kept if kept is None else kept)
                             & self.row8)


PAIR = pql("and", 0, 1)
PARTIAL = pql("and", PARTIAL_ROW, 0)
KEPT = f"Intersect(Bitmap(rowID=0), Bitmap(rowID={DUR_MASK_ROW}))"


def setbit(col: int) -> str:
    return f"SetBit(rowID=0, frame=general, columnID={col})"


def write_dur_dir(path: str, truth: DurTruth) -> float:
    """The durability index on disk: index `i`, frame `general` at every
    slice (rows 0-9 of the words, the mask row in the written slices),
    each fragment file a snapshot with its integrity footer, as the
    snapshot worker writes one (the container checksums of a batch of
    slices are taken in one vectorized pass); and index `d2`, one bit.
    Returns the seconds spent."""
    import zlib

    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.roaring import Bitmap, Container
    from pilosa_tpu_torch.roaring.serialize import (fnv32a_blocks,
                                                    write_bitmap,
                                                    write_footer)

    t0 = time.monotonic()
    h = Holder(path)
    h.open()
    h.create_index("i").create_frame("general").create_view_if_not_exists(
        "standard")
    h.create_index("d2").create_frame("f").set_bit(3, 5)
    h.close()
    words = truth.words
    frag_dir = Path(path) / "i" / "general" / "standard" / "fragments"
    frag_dir.mkdir(parents=True, exist_ok=True)
    for lo in range(0, words.shape[0], 96):
        bms, blocks = [], []
        for s in range(lo, min(lo + 96, words.shape[0])):
            bm = Bitmap()
            for r in range(words.shape[1]):
                for b in range(16):
                    if words[s, r, b].any():
                        bm.keys.append(r * 16 + b)
                        bm.containers.append(Container(bitmap=words[s, r, b]))
            if s in truth.mask:
                m = truth.mask[s]
                for b in range(16):
                    vals = m[(m >> 16) == b] & 0xFFFF
                    if len(vals):
                        bm.keys.append(DUR_MASK_ROW * 16 + b)
                        bm.containers.append(Container(
                            array=vals.astype(np.uint32)).normalize())
            bms.append((s, bm))
            blocks += [c.array.astype("<u4").tobytes() if c.is_array()
                       else c.bitmap.astype("<u8").tobytes()
                       for c in bm.containers]
        fnvs = fnv32a_blocks(blocks)
        at = 0
        for s, bm in bms:
            region = io.BytesIO()
            write_bitmap(bm, region)
            data = region.getvalue()
            with open(frag_dir / str(s), "wb") as f:
                f.write(data)
                write_footer(f, zlib.crc32(data),
                             fnvs[at:at + len(bm.keys)])
            at += len(bm.keys)
            if s == 0:  # the batch path writes the snapshot's bytes
                check((frag_dir / "0").read_bytes() == bm.to_bytes(
                    footer=True), "slice 0 written as a snapshot")
    return time.monotonic() - t0


def dur_client_post(c: "Client", body: str):
    """(status, doc, Retry-After) of one query."""
    c.conn.request("POST", "/index/i/query", body=body.encode())
    resp = c.conn.getresponse()
    return resp.status, json.loads(resp.read()), resp.getheader(
        "Retry-After")


def pct(xs, q):
    """The q-th percentile of xs, or None when it is empty."""
    return float(np.percentile(xs, q)) if len(xs) else None


def dur_background(srv, holder, truth: DurTruth, device) -> dict:
    """Step 1: 16 clients SetBit into DUR_SLICES until each of their
    fragments has taken DUR_SNAPSHOTS background snapshots, while one
    client counts without pause. Each Count lies between the truth with
    the writes acked before it was sent and the truth with those sent
    before its answer; the last equals the truth; no snapshot restages
    the view."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch.parallel import serve as tserve

    host, port = srv.address
    mgr = srv.handler.executor.mesh_manager()
    frags = {s: holder.fragment("i", "general", "standard", s)
             for s in DUR_SLICES}
    windows = {s: [] for s in DUR_SLICES}
    for s, frag in frags.items():
        def start(orig=frag._start_snapshot, s=s):
            windows[s].append([time.monotonic(), None])
            return orig()

        def finish(err, t0, orig=frag._finish_snapshot, s=s):
            try:
                return orig(err, t0)
            finally:
                windows[s][-1][1] = time.monotonic()

        frag._start_snapshot, frag._finish_snapshot = start, finish
    snap0 = {s: f._snap_gen for s, f in frags.items()}
    batches = []
    real_apply = tserve.apply_writes

    def recording_apply(staged, *batch):
        batches.append(tuple(np.array(a) for a in batch))
        return real_apply(staged, *batch)

    acks = []  # (slice, sent, acked)
    counts = []
    stop = threading.Event()
    errors = []

    def writer(k):
        s = DUR_SLICES[k % len(DUR_SLICES)]
        c = Client(host, port)
        try:
            while frags[s]._snap_gen - snap0[s] < DUR_SNAPSHOTS:
                col = truth.next_col(s)
                t0 = time.monotonic()
                c.call("POST", "/index/i/query", setbit(col))
                t1 = time.monotonic()
                truth.ack(col)
                acks.append((s, t0, t1))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            c.close()

    def counter():
        c = Client(host, port)
        try:
            while not stop.is_set():
                with truth.mu:
                    lo = truth.count()
                t0 = time.monotonic()
                got = c.count(PAIR)
                counts.append((time.monotonic() - t0) * 1e3)
                with truth.mu:
                    hi = truth.c0 + len(truth.sent)
                if not lo <= got <= hi:
                    errors.append(("Count under writes", lo, got, hi))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            c.close()

    before = dict(mgr.stats)
    tserve.apply_writes = recording_apply
    try:
        t0 = time.monotonic()
        cthread = threading.Thread(target=counter)
        cthread.start()
        with ThreadPoolExecutor(CLIENTS) as pool_ex:
            list(pool_ex.map(writer, range(CLIENTS)))
        stop.set()
        cthread.join()
        wall = time.monotonic() - t0
    finally:
        tserve.apply_writes = real_apply
        for frag in frags.values():
            del frag._start_snapshot, frag._finish_snapshot
    check(not errors, f"durability writes and Counts: {errors[:5]}")
    for frag in frags.values():
        check(frag.wait_snapshot(timeout=60), "the snapshots landed")
        check(not os.path.exists(frag.side_wal_path),
              f"{frag.side_wal_path} is gone after the snapshot")
    c = Client(host, port)
    try:
        check(c.count(PAIR) == truth.count(), "the Count after the writes")
        check(c.count(PARTIAL) == truth.partial(),
              "the partial-row Count after the writes")
    finally:
        c.close()
    d = {k: mgr.stats.get(k, 0) - before.get(k, 0)
         for k in ("incremental", "stage", "refresh_pick_restage")}
    check(d["incremental"] > 0 and d["stage"] == d["refresh_pick_restage"],
          f"refreshes scattered; no snapshot restaged the view: {d}")
    snaps = {s: f._snap_gen - snap0[s] for s, f in frags.items()}
    # Each snapshot's wall time, start to finish, as the fragment times
    # it (the log2 SNAPSHOT_US histogram keeps no single values).
    snap_ms = [(b - a) * 1e3 for ws in windows.values() for a, b in ws
               if b is not None]
    inside, outside = [], []
    for s, t0, t1 in acks:
        hit = any(a <= t1 and (b or t1) >= t0 for a, b in windows[s])
        (inside if hit else outside).append((t1 - t0) * 1e3)
    out = {"writes": len(acks), "seconds": wall,
           "write_qps": len(acks) / wall, "snapshots": snaps,
           "snapshot_ms": {"n": len(snap_ms), "p50": pct(snap_ms, 50),
                           "max": max(snap_ms) if snap_ms else None},
           "ack_ms_inside_snapshots": {"n": len(inside), "p50": pct(inside, 50),
                                       "p99": pct(inside, 99)},
           "ack_ms_outside": {"n": len(outside), "p50": pct(outside, 50),
                              "p99": pct(outside, 99)},
           "count_ms": {"n": len(counts), "p50": pct(counts, 50),
                        "p90": pct(counts, 90)},
           "refresh": d}
    big = max(batches, key=lambda bt: int((bt[0] >= 0).sum()),
              default=None)
    if big is not None:
        import torch

        pool = mgr._views[("i", "general", "standard")].sharded.words
        dev = tuple(torch.from_numpy(np.ascontiguousarray(a).view(
            np.int32)).to(device) for a in big)
        out["kernels"] = k7_case("apply_writes (durability batch)", pool,
                                 dev)
    log(f"durability: {len(acks)} acked SetBits from {CLIENTS} clients "
        f"into slices {list(DUR_SLICES)} in {wall:.2f} s "
        f"({out['write_qps']:.1f}/s), snapshots {snaps}, snapshot ms p50 "
        f"{out['snapshot_ms']['p50']} max {out['snapshot_ms']['max']}")
    log(f"durability: write ack ms inside snapshot windows "
        f"{json.dumps(out['ack_ms_inside_snapshots'])}, outside "
        f"{json.dumps(out['ack_ms_outside'])}; the {len(counts)} Counts "
        f"under writes p50 {out['count_ms']['p50']} p90 "
        f"{out['count_ms']['p90']} ms; refresh {d}")
    return out


def dur_backpressure(srv, holder, truth: DurTruth) -> dict:
    """Step 2: snapshots stalled 2 s (DUR_STALL, armed as a spec) under
    max_wal_ops = DUR_MAX_WAL_OPS: 16 writers into slice 0 meet 503 with
    Retry-After; then every acked write is in the Count."""
    from concurrent.futures import ThreadPoolExecutor

    from pilosa_tpu_torch import fault
    from pilosa_tpu_torch.core.wal import WAL_STATS

    host, port = srv.address
    frag = holder.fragment("i", "general", "standard", 0)
    cfg = frag.wal_cfg  # the holder's, shared by every fragment
    default = cfg.max_wal_ops
    w0 = WAL_STATS.copy()
    sheds, errors = [], []

    def writer(k):
        c = Client(host, port)
        try:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                col = truth.next_col(0)
                status, doc, retry = dur_client_post(c, setbit(col))
                if status == 503:
                    sheds.append((retry, doc.get("error", "")))
                    return
                if status != 200:
                    errors.append((status, doc))
                    return
                truth.ack(col)
            errors.append(f"client {k} never shed")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            c.close()

    cfg.max_wal_ops = DUR_MAX_WAL_OPS
    fault.load_spec(DUR_STALL)
    t0 = time.monotonic()
    try:
        with ThreadPoolExecutor(CLIENTS) as pool_ex:
            list(pool_ex.map(writer, range(CLIENTS)))
    finally:
        fault.reset()
        cfg.max_wal_ops = default
    wall = time.monotonic() - t0
    check(frag.wait_snapshot(timeout=60), "the stalled snapshot landed")
    check(not errors, f"backpressure writers: {errors[:5]}")
    check(len(sheds) == CLIENTS and all(
        r is not None and int(r) >= 1 and "backpressure" in e
        for r, e in sheds), f"503 with Retry-After: {sheds[:3]}")
    c = Client(host, port)
    try:
        got = c.count(PAIR)
        dv = c.call("GET", "/debug/vars")
    finally:
        c.close()
    check(got == truth.count(), ("no acked write lost to the shed", got,
                                 truth.count()))
    w = {k: WAL_STATS.get(k, 0) - w0.get(k, 0)
         for k in ("backpressure", "backpressure_shed")}
    check(w["backpressure_shed"] >= CLIENTS, f"sheds counted: {w}")
    log(f"durability: backpressure {w['backpressure']} waits, "
        f"backpressure_shed {w['backpressure_shed']} in {wall:.2f} s "
        f"(max_wal_ops {DUR_MAX_WAL_OPS}, {DUR_STALL}); Retry-After "
        f"{sorted({r for r, _ in sheds})}; /debug/vars wal "
        f"{json.dumps(dv['storage']['wal'], sort_keys=True)}")
    return {**w, "seconds": wall, "retry_after": [r for r, _ in sheds],
            "wal": dv["storage"]["wal"]}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ServerChild:
    """The port's server as a child process on `path`:
    python -m pilosa_tpu_torch.api.server, with PILOSA_TORCH_FAULT set
    to `spec` (or unset)."""

    def __init__(self, root: Path, path: str, device, spec: str = ""):
        import queue

        self.port = free_port()
        env = {k: v for k, v in os.environ.items()
               if k != "PILOSA_TORCH_FAULT"}
        if spec:
            env["PILOSA_TORCH_FAULT"] = spec
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.api.server", "-d", path,
             "-b", f"127.0.0.1:{self.port}", "--device", str(device),
             "--max-op-n", str(KILL_MAX_OP_N), "--scrub-interval", "0"],
            cwd=str(root), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()
        self.open_s = None
        seen = []
        deadline = time.monotonic() + 180
        while True:
            left = deadline - time.monotonic()
            check(left > 0 and self.proc.poll() is None,
                  f"the server child started: {''.join(seen[-20:])}")
            try:
                line = self.lines.get(timeout=min(left, 1.0))
            except queue.Empty:
                continue
            seen.append(line)
            if line.startswith("serving "):
                self.open_s = float(line.split("holder opened in ")[1]
                                    .split()[0])
                break
        self.ready_s = time.monotonic() - self.t0

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line)

    def client(self) -> "Client":
        return Client("127.0.0.1", self.port)

    def stop(self):
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)


def dur_verify(srv_or_child, truth: DurTruth, what: str) -> dict:
    """After a restart: the kept writes (Intersect(row 0, mask))
    hold every acked one and none that was not sent; Count(Intersect)
    (K1) and the partial-row Count (K3) equal the truth with exactly
    the kept writes. Times the first Count (it stages the view)."""
    c = srv_or_child.client()
    try:
        t0 = time.monotonic()
        got = c.count(PAIR)
        first_ms = (time.monotonic() - t0) * 1e3
        kept = {int(x) for x in c.call("POST", "/index/i/query",
                                       KEPT)["results"][0]["bits"]}
        part = c.count(PARTIAL)
        launches = c.call("GET", "/debug/vars")["kernel_launches"]
    finally:
        c.close()
    with truth.mu:
        lost = truth.acked - kept
        extra = kept - truth.sent
        check(not lost and not extra,
              f"{what}: {len(lost)} acked bits lost, {len(extra)} unsent "
              f"bits kept")
        truth.kept = kept
    check(got == truth.count(), (what, "Count", got, truth.count()))
    check(part == truth.partial(), (what, "partial Count", part,
                                    truth.partial()))
    return {"first_count_ms": first_ms, "kept": len(kept),
            "launches": launches}


def dur_kills(root: Path, path: str, truth: DurTruth, device) -> dict:
    """Step 3: power loss on the card. For each KILLS spec a server child
    runs with it armed while 16 clients SetBit until it dies by SIGKILL;
    the next child restarts on the same directory (and verifies it, see
    dur_verify) before it takes its own writes; a last child verifies
    the last kill. Each restart's open and first-Count times."""
    from concurrent.futures import ThreadPoolExecutor

    launches: Counter = Counter()
    rounds = []
    child = ServerChild(root, path, device, KILLS[0][1])
    try:
        for k, (what, _spec) in enumerate(KILLS):
            v = dur_verify(child, truth, f"before the {what} kill"
                           if k == 0 else f"after the {KILLS[k - 1][0]} kill")
            launches.update(v["launches"])
            n0 = len(truth.acked)
            errors = []

            def writer(j, child=child):
                s = DUR_SLICES[j % len(DUR_SLICES)]
                c = child.client()
                deadline = time.monotonic() + 60
                try:
                    while time.monotonic() < deadline:
                        col = truth.next_col(s)
                        status, doc, _ = dur_client_post(c, setbit(col))
                        if status != 200:
                            errors.append((status, doc))
                            return
                        truth.ack(col)
                    errors.append("no kill within 60 s")
                except (OSError, http.client.HTTPException):
                    return  # the kill
                finally:
                    c.close()

            t0 = time.monotonic()
            with ThreadPoolExecutor(CLIENTS) as pool_ex:
                list(pool_ex.map(writer, range(CLIENTS)))
            check(not errors, f"writes before the {what} kill: {errors[:3]}")
            rc = child.proc.wait(timeout=60)
            check(rc == -9, f"the {what} kill ended the server: rc {rc}")
            rounds.append({"kill": what, "acked": len(truth.acked) - n0,
                           "writes_s": time.monotonic() - t0,
                           "open_s": child.open_s,
                           "ready_s": child.ready_s,
                           "first_count_ms": v["first_count_ms"]})
            spec = KILLS[k + 1][1] if k + 1 < len(KILLS) else ""
            child = ServerChild(root, path, device, spec)
            rounds[-1].update(restart_open_s=child.open_s,
                              restart_ready_s=child.ready_s)
        v = dur_verify(child, truth, f"after the {KILLS[-1][0]} kill")
        launches.update(v["launches"])
        for k, r in enumerate(rounds):
            r["restart_first_count_ms"] = (
                rounds[k + 1]["first_count_ms"] if k + 1 < len(rounds)
                else v["first_count_ms"])
            log(f"durability: {r['kill']} kill after {r['acked']} acked "
                f"writes; restart: holder open {r['restart_open_s']:.3f} s, "
                f"server ready {r['restart_ready_s']:.2f} s, first Count "
                f"{r['restart_first_count_ms']:.1f} ms; every acked bit "
                f"kept")
    finally:
        child.stop()
    return {"rounds": rounds, "launches": dict(launches),
            "kept": len(truth.kept), "acked": len(truth.acked)}


def dur_rot(root: Path, path: str, truth: DurTruth, device) -> dict:
    """Step 4: rot under a loaded view is found by a scrub pass and
    rewritten from memory, the Count unchanged; rot in a file at rest
    answers 500 for the Count that touches it, and another index still
    answers."""
    from pilosa_tpu_torch.api.server import serve
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.core.scrub import SCRUB_STATS, Scrubber
    from pilosa_tpu_torch.core.wal import FSYNC_GROUP, WalConfig
    from pilosa_tpu_torch.roaring import Bitmap

    def flip(s):
        f = Path(path) / "i" / "general" / "standard" / "fragments" / str(s)
        with open(f, "r+b") as fh:
            fh.seek(ROT_OFFSET)
            b = fh.read(1)
            fh.seek(ROT_OFFSET)
            fh.write(bytes([b[0] ^ 0x01]))
        return f

    out = {}
    holder = Holder(path, wal=WalConfig(FSYNC_GROUP))
    holder.open()
    srv = serve(holder, device=device)
    try:
        c = Client(*srv.address)
        try:
            check(c.count(PAIR) == truth.count(), "Count before the rot")
            f = flip(ROT_SCRUBBED)
            s0 = SCRUB_STATS.copy()
            scrub = Scrubber(holder, rate_limit=0)
            t0 = time.monotonic()
            n = scrub.scrub_pass()
            dt = time.monotonic() - t0
            d = {k: SCRUB_STATS.get(k, 0) - s0.get(k, 0)
                 for k in ("corrupt", "repairs", "unrepaired", "fragments")}
            check(d["corrupt"] == 1 and d["repairs"] == 1
                  and d["unrepaired"] == 0, f"the scrub found the rot: {d}")
            check(Bitmap.from_bytes(f.read_bytes(), truncate_torn_tail=True,
                                    verify=True).verified_footer,
                  "the rotted file rewritten with a footer")
            check(c.count(PAIR) == truth.count(), "Count after the scrub")
            out["scrub"] = {"fragments": n, "seconds": dt,
                            "bytes": scrub.last_pass_bytes,
                            "bytes_per_s": scrub.last_pass_bytes / dt,
                            "deltas": d, "stats": SCRUB_STATS.copy()}
        finally:
            c.close()
    finally:
        srv.close()
        holder.close()
    flip(ROT_COLD)
    holder = Holder(path, wal=WalConfig(FSYNC_GROUP))
    holder.open()
    srv = serve(holder, device=device)
    try:
        c = Client(*srv.address)
        try:
            status, doc = c.raw("POST", "/index/i/query", PAIR)
            check(status == 500 and "corrupt" in doc.get("error", ""),
                  ("a Count over the rotted slice", status, doc))
            got = c.call("POST", "/index/d2/query",
                         "Count(Bitmap(rowID=3, frame=f))")["results"][0]
            check(got == 1, ("a Count over another index", got))
        finally:
            c.close()
    finally:
        srv.close()
        holder.close()
    out["cold_rot"] = {"status": status, "error": doc.get("error", "")[:200]}
    log(f"durability: scrub pass over {out['scrub']['fragments']} "
        f"fragments, {out['scrub']['bytes']} B in "
        f"{out['scrub']['seconds']:.2f} s "
        f"({out['scrub']['bytes_per_s'] / 1e6:.1f} MB/s), rot found and "
        f"rewritten from memory; SCRUB_STATS "
        f"{json.dumps(out['scrub']['stats'], sort_keys=True)}; rot at rest: "
        f"{status} \"{out['cold_rot']['error'][:80]}\", index d2 answers")
    return out


def dur_shadow(holder, words: np.ndarray, sp: "SparseRows",
               bsi: "BsiTruth", device) -> dict:
    """Step 5, on the main holder at 1 in 1: the lone Count, a 4-client
    round, a Count on `sparse`, TopN(n=100) and Sum, each checked on the
    host with no mismatch; then a delta=5 result fault: the host value
    is served, the plan quarantined (?explain), and the next Count of
    that shape folds on the host, exact. Then the lone Count's p50 at 1
    in 1, 1 in 100 and 0, back to back."""
    from pilosa_tpu_torch import fault
    from pilosa_tpu_torch.api.server import serve
    from pilosa_tpu_torch.executor import SHADOW_STATS

    pairs = list(itertools.combinations(range(4), 2))  # 6 pairs, 4 rows
    want = {(a, b): host_count(words, "and", a, b) for a, b in pairs}
    srv = serve(holder, device=device, shadow_sample=1)
    ex = srv.handler.executor
    host, port = srv.address
    c = Client(host, port)
    try:
        sh0 = SHADOW_STATS.copy()
        check(c.count(PAIR) == want[(0, 1)], "lone Count")
        mgr = ex.mesh_manager()
        from pilosa_tpu_torch.ops import kernels as tk

        k0 = tk.LAUNCHES["coarse_count_shared"]
        errors = []

        def client(k):
            cl = Client(host, port)
            try:
                for j in range(SHADOW_ROUND):
                    a, b = pairs[(k * SHADOW_ROUND + j) % len(pairs)]
                    got = cl.count(pql("and", a, b))
                    if got != want[(a, b)]:
                        errors.append((a, b, got))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
            finally:
                cl.close()

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SHADOW_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        check(not errors, f"shadow round: {errors[:5]}")
        shared = tk.LAUNCHES["coarse_count_shared"] - k0
        sq = fpql("and", 0, "sparse", 1, "sparse")
        check(c.count(sq) == int(sp.inter((0, 1)).sum()), "sparse Count")
        top = c.call("POST", "/index/i/query",
                     f"TopN(frame=general, n={TOPN_N})")["results"][0]
        counts = np.bitwise_count(words).sum(axis=(0, 2, 3), dtype=np.int64)
        got = {t["id"]: t["count"] for t in top}
        check(all(got[r] == counts[r] for r in range(len(counts))),
              "TopN's counts of the headline rows")
        s = c.call("POST", "/index/i/query",
                   agg_pql("Sum", False))["results"][0]
        check(s == bsi.aggregate("Sum", False), ("Sum", s))
        d = {k: SHADOW_STATS.get(k, 0) - sh0.get(k, 0)
             for k in ("checks:mesh", "mismatch:mesh", "checks:bsi",
                       "mismatch:bsi")}
        check(d["checks:mesh"] >= 3 + SHADOW_CLIENTS * SHADOW_ROUND
              and d["checks:bsi"] >= 1 and d["mismatch:mesh"] == 0
              and d["mismatch:bsi"] == 0, f"clean shadow checks: {d}")
        # A kernel that miscomputes: the result seam adds 5.
        fault.arm("device.exec", delta=5, kind="count-result")
        try:
            m0 = SHADOW_STATS.get("mismatch:mesh", 0)
            h0 = ex.stats["count_host"]
            check(c.count(PAIR) == want[(0, 1)],
                  "the perturbed Count answers the host value")
            check(SHADOW_STATS.get("mismatch:mesh", 0) == m0 + 1,
                  "one mismatch")
            plan = c.call("POST", "/index/i/query?explain=true",
                          pql("and", 2, 3))["calls"][0]
            check(plan["plan"]["quarantined"]
                  and plan.get("route_reason") == "quarantined",
                  f"?explain shows the quarantine: {plan}")
            check(c.count(pql("and", 2, 3)) == want[(2, 3)]
                  and ex.stats["count_host"] == h0 + 1,
                  "the next Count of that shape folds on the host")
        finally:
            fault.reset()
        mgr.clear_quarantine()
        timed = {}
        for n, calls in SHADOW_TIMED:
            ex.shadow_sample = n
            lat = []
            for _ in range(calls):
                t0 = time.monotonic()
                got = c.count(PAIR)
                lat.append((time.monotonic() - t0) * 1e3)
                check(got == want[(0, 1)], "timed Count")
            timed[f"1in{n}"] = {"calls": calls, "p50_ms": pct(lat, 50),
                                "p90_ms": pct(lat, 90)}
    finally:
        c.close()
        srv.close()
    log(f"durability: shadow checks {json.dumps(d)}, K2 launches in the "
        f"{CLIENTS}-client round {shared}; the perturbed Count served the "
        f"host value and quarantined its plan; lone Count p50 by sampling "
        f"{json.dumps({k: v['p50_ms'] for k, v in timed.items()})} ms")
    return {"shadow": d, "k2_in_round": shared, "timed": timed,
            "mesh_stats": dict(mgr.stats)}


def durability_phase(holder, words: np.ndarray, sp: "SparseRows",
                     bsi: "BsiTruth", tmp: str, root: Path, card: str,
                     device, seed: int) -> dict:
    """Phase 13 (module docstring). The kernel counters are set to 0
    just before the phase's first server starts and read after its last
    query; the children's launches come from their /debug/vars."""
    import torch

    from pilosa_tpu_torch.api.server import serve
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.core.wal import FSYNC_GROUP, WalConfig
    from pilosa_tpu_torch.ops import kernels as tk

    t_phase = time.monotonic()
    steps = {}

    def mark(name):
        steps[name] = time.monotonic() - t_phase - sum(steps.values())

    truth = DurTruth(words, seed)
    path = os.path.join(tmp, "durability")
    write_s = write_dur_dir(path, truth)
    log(f"durability: {SLICES} slices written as footered snapshots in "
        f"{write_s:.2f} s")
    tk.reset_launches()
    holder_d = Holder(path, wal=WalConfig(FSYNC_GROUP))
    t0 = time.monotonic()
    holder_d.open()
    open_s = time.monotonic() - t0
    srv = serve(holder_d, device=device)
    try:
        c = Client(*srv.address)
        try:
            t0 = time.monotonic()
            check(c.count(PAIR) == truth.count(), "first durable Count")
            first_s = time.monotonic() - t0
        finally:
            c.close()
        collect_after_staging("durability")
        mark("setup")
        bg = dur_background(srv, holder_d, truth, device)
        mark("background snapshots")
        bp = dur_backpressure(srv, holder_d, truth)
        mstats = dict(srv.handler.executor.mesh_manager().stats)
    finally:
        srv.close()
        holder_d.close()
    mark("backpressure")
    kills = dur_kills(root, path, truth, device)
    mark("power loss")
    rot = dur_rot(root, path, truth, device)
    mark("rot")
    shadow = dur_shadow(holder, words, sp, bsi, device)
    mark("shadow")
    torch.cuda.synchronize()
    launches = Counter(tk.LAUNCHES)
    launches.update(kills["launches"])
    launches = {k: launches.get(k, 0) for k in KERNELS}
    wall = time.monotonic() - t_phase
    log(f"durability phase launches {launches} (children "
        f"{kills['launches']}); {wall:.1f} s, by step "
        f"{json.dumps({k: round(v, 1) for k, v in steps.items()})}")
    for k in DURABILITY_PATH:
        check(launches[k] > 0, f"kernel {k} launched on the durability path")
    return {"launches": launches, "stats": {}, "mesh_stats": mstats,
            "write_dir_s": write_s, "open_s": open_s, "first_query_s": first_s,
            "background": bg, "backpressure": bp, "kills": kills,
            "rot": rot, "shadow": shadow, "seconds": wall,
            "step_seconds": steps,
            "kernels": bg.get("kernels", {})}


# -- phase 14: bulk data in and out ---------------------------------------------

BULK_THREADS = 4          # import clients, as a parallel `ctl import`
BULK_NEW_SLICE = 17       # the slice the import into a staged view hits
BULK_SLICES = SLICES // 2  # the slices the protobuf import loads (a cut)
BULK_NEW_BITS = 1_000
TQI_BITS = 250_000        # the timestamped CSV's lines
TQI_SLICES = 96
TQI_ROWS = 4
FR_SLICES = 96            # the frame restored from another node (a cut)
CSV_TIME = "%Y-%m-%dT%H:%M"  # the ctl's time column
TQI_RANGES = (("1 day", 10, 11), ("7 days", 3, 10), ("month", 1, 31))
BULK_PATH = ("sparse_pair_count", "pair_count", "coarse_count",
             "coarse_count_shared", "tree_count", "probe_ok")


def sparse_slice_bits(sp: SparseRows, s: int):
    """(rows, columns) as uint64 of frame `sparse`'s rows 0-7 in slice s,
    in position order (row, then column)."""
    vals = (np.arange(2048, dtype=np.uint64) * np.uint64(BUCKET)
            + sp.off[s, :SPARSE_ROWS].astype(np.uint64))
    held = np.arange(2048) < sp.lens[s, :SPARSE_ROWS][..., None]
    r, b, _ = np.nonzero(held)
    cols = (np.uint64(s << 20) + (b.astype(np.uint64) << np.uint64(16))
            + vals[held])
    return r.astype(np.uint64), cols


def slice_sets(sp: SparseRows, s: int) -> dict:
    """{row: its sorted absolute columns in slice s}, rows 0-7."""
    rows, cols = sparse_slice_bits(sp, s)
    return {r: cols[rows == r] for r in range(SPARSE_ROWS)}


def import_client(host: str, seed: int, draw: int, slices: int,
                  threads: int, conn) -> None:
    """The import's clients, in a process of their own as `ctl import`
    is: the arrays of the first `slices` of the `draw`-slice SparseRows
    made from the seed first, then, on the parent's word, one POST
    /import a slice from `threads` InternalClients. Sends the wall, the
    bodies' bytes and each request's ms (or the errors) to `conn`."""
    from pilosa_tpu_torch.api.client import InternalClient

    sp = SparseRows(draw, seed)
    bits = [sparse_slice_bits(sp, s) for s in range(slices)]
    del sp
    conn.send("ready")
    conn.recv()
    todo = iter(range(slices))
    mu = threading.Lock()
    lat, sent, errors = [], [], []

    def worker():
        cl = InternalClient(host, timeout=600)
        while True:
            with mu:
                s = next(todo, None)
            if s is None:
                return
            rows, cols = bits[s]
            t0 = time.monotonic()
            try:
                n = cl.import_bits("imp", "sparse", s, rows, cols)
            except Exception as e:  # noqa: BLE001 — sent to the parent
                errors.append(repr(e))
                return
            with mu:
                lat.append((time.monotonic() - t0) * 1e3)
                sent.append(n)

    pool = [threading.Thread(target=worker) for _ in range(threads)]
    t0 = time.monotonic()
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    conn.send({"wall_s": time.monotonic() - t0, "bytes": int(sum(sent)),
               "ms": lat, "errors": errors})


def bulk_import(host: str, seed: int) -> dict:
    """Runs import_client in a spawned process (the parent holds the
    card) and returns its record; the window opens once the child's
    arrays are made."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    mine, theirs = ctx.Pipe()
    proc = ctx.Process(target=import_client, args=(
        host, seed, SLICES, BULK_SLICES, BULK_THREADS, theirs), daemon=True)
    proc.start()
    try:
        check(mine.poll(600) and mine.recv() == "ready",
              "the import client made its arrays")
        mine.send("go")
        check(mine.poll(1200), "the import client finished")
        res = mine.recv()
    finally:
        proc.join(60)
        if proc.is_alive():
            proc.kill()
    check(not res["errors"] and len(res["ms"]) == BULK_SLICES,
          f"imports: {res['errors'][:3]}")
    return res


def tqi_csv(path: str, seed: int):
    """Write TQI_BITS lines `row,col,time` (rows 0-3, columns uniform over
    TQI_SLICES slices, times uniform over the minutes of April 2017) and
    return (rows, cols, UTC day of each bit as datetime64[D]): the time
    read as the ctl reads it (local time) and stored as the server
    stores it (UTC)."""
    rng = np.random.default_rng([seed, 12])
    rows = rng.integers(0, TQI_ROWS, TQI_BITS)
    cols = rng.integers(0, TQI_SLICES << 20, TQI_BITS)
    minutes = rng.integers(0, 30 * 24 * 60, TQI_BITS)
    start = datetime(2017, 4, 1)
    names = [(start + timedelta(minutes=m)).strftime(CSV_TIME)
             for m in range(30 * 24 * 60)]
    unix = np.array([int(datetime.strptime(n, CSV_TIME).timestamp())
                     for n in names], dtype=np.int64)
    with open(path, "w") as f:
        f.write("".join(f"{r},{c},{names[m]}\n" for r, c, m in zip(
            rows.tolist(), cols.tolist(), minutes.tolist())))
    day = unix[minutes].astype("datetime64[s]").astype("datetime64[D]")
    return rows, cols, day


def tqi_pql(r: int, d0: int, d1: int) -> str:
    end = "2017-05-01T00:00" if d1 > 30 else f"2017-04-{d1:02d}T00:00"
    return (f'Count(Range(rowID={r}, frame=events, '
            f'start="2017-04-{d0:02d}T00:00", end="{end}"))')


def tqi_truth(rows, cols, day, r: int, d0: int, d1: int) -> int:
    lo = np.datetime64(f"2017-04-{d0:02d}")
    hi = (np.datetime64("2017-05-01") if d1 > 30
          else np.datetime64(f"2017-04-{d1:02d}"))
    sel = (rows == r) & (day >= lo) & (day < hi)
    return len(np.unique(cols[sel]))


def bulk_phase(holder, words: np.ndarray, sp: SparseRows, tmp: str,
               card: str, device, seed: int) -> dict:
    """Phase 14 (module docstring). The kernel counters are set to 0 just
    before the phase's first server starts and read after its last
    query; K5 is then held against its plain version at the imported
    frame's shape."""
    import hashlib
    import tarfile

    import torch

    from pilosa_tpu_torch.api.client import InternalClient
    from pilosa_tpu_torch.api.server import serve
    from pilosa_tpu_torch.core import Holder
    from pilosa_tpu_torch.core.wal import FSYNC_GROUP, WalConfig
    from pilosa_tpu_torch.ctl.main import main as ctl
    from pilosa_tpu_torch.ops import kernels as tk

    t_phase = time.monotonic()
    steps, out = {}, {}

    def mark(name):
        steps[name] = time.monotonic() - t_phase - sum(steps.values())

    # Truths and request arrays, outside every timed window.
    pairs = list(itertools.combinations(range(SPARSE_ROWS), 2))
    want = {(a, b): int(sp.inter((a, b))[:BULK_SLICES].sum())
            for a, b in pairs}
    nbits = int(sp.lens[:BULK_SLICES, :SPARSE_ROWS].sum(dtype=np.int64))
    rng = np.random.default_rng([seed, 14])
    new_rows = rng.integers(0, 2, BULK_NEW_BITS).astype(np.uint64)
    new_cols = (np.uint64(BULK_NEW_SLICE << 20)
                + rng.integers(0, 1 << 20, BULK_NEW_BITS).astype(np.uint64))
    sets = slice_sets(sp, BULK_NEW_SLICE)
    after = {r: np.union1d(c, new_cols[new_rows == r]) if r < 2 else c
             for r, c in sets.items()}
    want_after = {(a, b): want[(a, b)]
                  - len(np.intersect1d(sets[a], sets[b]))
                  + len(np.intersect1d(after[a], after[b]))
                  for a, b in pairs}
    totals = np.array([int(sp.card(r)[:BULK_SLICES].sum()) + len(after[r])
                       - len(sets[r]) for r in range(SPARSE_ROWS)],
                      dtype=np.int64)
    want_topn = TopnTruth.rank(totals, SPARSE_ROWS)
    mark("truths")

    # A fragment holds two file descriptors (its flock and its append
    # fd). The time phase's index `tq` (96 slices x 33 views) is done
    # with: dropping it keeps the holders below the descriptor limit.
    import resource

    holder.delete_index("tq")
    out["fds"] = {"open_after_dropping_tq": len(os.listdir("/proc/self/fd")),
                  "limit": list(resource.getrlimit(resource.RLIMIT_NOFILE))}
    log(f"bulk: {out['fds']['open_after_dropping_tq']} file descriptors "
        f"open, limit {out['fds']['limit']}")
    bh = Holder(os.path.join(tmp, "bulk"), wal=WalConfig(FSYNC_GROUP))
    bh.open()
    th = Holder(os.path.join(tmp, "bulk_tq"), wal=WalConfig(FSYNC_GROUP))
    th.open()
    fh = build_holder(os.path.join(tmp, "bulk_fr"), words[:FR_SLICES],
                      wal=WalConfig(FSYNC_GROUP), index="fr")
    tar_path = REPO / "chiprun_out" / "bulk_backup.tar"
    tar_path.parent.mkdir(exist_ok=True)
    tk.reset_launches()
    srv = serve(bh, device=device)
    main_srv = serve(holder, device=device)
    fr_srv = serve(fh, device=device)
    tq_srv = serve(th, device=device)
    servers = [srv, main_srv, fr_srv, tq_srv]
    host = "%s:%d" % srv.address
    ex = srv.handler.executor
    c = Client(*srv.address, index="imp")
    try:
        # 1. Protobuf import of frame `sparse`'s rows at BULK_SLICES slices.
        c.call("POST", "/index/imp", "{}")
        c.call("POST", "/index/imp/frame/sparse", "{}")
        imp = bulk_import(host, seed)
        imp.pop("errors")
        imp_lat = np.asarray(imp.pop("ms"))
        out["import"] = dict(imp, bits=nbits, slices=BULK_SLICES,
                             threads=BULK_THREADS,
                             mb_per_s=imp["bytes"] / imp["wall_s"] / 1e6,
                             bits_per_s=nbits / imp["wall_s"],
                             request_p50_ms=float(np.percentile(imp_lat, 50)),
                             request_p90_ms=float(np.percentile(imp_lat, 90)))
        log(f"bulk: imported {nbits} bits in {BULK_SLICES} requests "
            f"({imp['bytes']} B) in {imp['wall_s']:.2f} s from "
            f"{BULK_THREADS} clients: {out['import']['mb_per_s']:.1f} MB/s, "
            f"{out['import']['bits_per_s']:.0f} bits/s, request p50 "
            f"{out['import']['request_p50_ms']:.1f} ms")
        mark("import")
        qs = [fpql("and", a, "sparse", b, "sparse") for a, b in pairs]
        t0 = time.monotonic()
        got = c.count(qs[0])
        torch.cuda.synchronize()
        first_s = time.monotonic() - t0
        check(got == want[pairs[0]], ("first imported Count", got))
        mgr = ex.mesh_manager()
        sv = mgr._views[("imp", "sparse", "standard")]
        check(sv.sparse is not None and bool(sv.slice_formats.all()),
              "imported frame sparse staged sorted")
        out["first_count_s"] = first_s
        log(f"bulk: first Count over the imported frame (staging) "
            f"{first_s:.2f} s")
        collect_after_staging("bulk")
        k4 = tk.LAUNCHES["sparse_pair_count"]
        for q, p in zip(qs, pairs):
            got = c.count(q)
            check(got == want[p], (q, got, want[p]))
        out["concurrent_qps"] = concurrent(
            *srv.address, qs, [want[p] for p in pairs], index="imp")
        check(tk.LAUNCHES["sparse_pair_count"] > k4,
              "the imported pairs ran K4")
        mark("imported Counts")

        # 2. An import into the staged view restages it, exact.
        before = dict(mgr.stats)
        t0 = time.monotonic()
        InternalClient(host).import_bits("imp", "sparse", BULK_NEW_SLICE,
                                         new_rows, new_cols)
        import_s = time.monotonic() - t0
        t0 = time.monotonic()
        got = c.count(qs[0])
        torch.cuda.synchronize()
        restage_ms = (time.monotonic() - t0) * 1e3
        check(got == want_after[pairs[0]], ("Count after the import", got))
        delta = {k: mgr.stats.get(k, 0) - before.get(k, 0)
                 for k in ("stage", "stage_us", "incremental",
                           "refresh_pick_restage")}
        check(delta["stage"] == 1 and delta["incremental"] == 0,
              f"the import restaged the view: {delta}")
        for q, p in zip(qs, pairs):
            got = c.count(q)
            check(got == want_after[p], (q, got, want_after[p]))
        got = c.call("POST", "/index/imp/query",
                     f"TopN(frame=sparse, n={SPARSE_ROWS})")["results"][0]
        check(got == want_topn, ("TopN over the imported frame", got))
        out["restage"] = {"import_ms": import_s * 1e3,
                          "count_ms": restage_ms, "stats": delta}
        log(f"bulk: {BULK_NEW_BITS} bits into slice {BULK_NEW_SLICE} in "
            f"{import_s * 1e3:.1f} ms; the next Count restaged in "
            f"{restage_ms:.1f} ms (stats {delta}); TopN exact")
        mark("import into a staged view")

        # 3. ctl import of a timestamped CSV into a YMD index, on a
        # server of its own (its 33 views x 96 slices are closed after).
        tq_host = "%s:%d" % tq_srv.address
        csv_path = os.path.join(tmp, "tqi.csv")
        t0 = time.monotonic()
        trows, tcols, tday = tqi_csv(csv_path, seed)
        csv_s = time.monotonic() - t0
        tq = Client(*tq_srv.address, index="tqi")
        try:
            tq.call("POST", "/index/tqi", json.dumps(
                {"options": {"timeQuantum": "YMD"}}))
            t0 = time.monotonic()
            check(ctl(["import", "--host", tq_host, "-i", "tqi", "-f",
                       "events", "--create", csv_path]) == 0, "ctl import")
            ctl_s = time.monotonic() - t0
            views = tq.call("GET", "/index/tqi/frame/events/views")["views"]
            ranges = {}
            for name, d0, d1 in TQI_RANGES:
                for r in (0, TQI_ROWS - 1):
                    k_before = dict(tk.LAUNCHES)
                    got = tq.count(tqi_pql(r, d0, d1))
                    w = tqi_truth(trows, tcols, tday, r, d0, d1)
                    check(got == w, (name, r, got, w))
                    torch.cuda.synchronize()
                    ranges[f"{name}, row {r}"] = {
                        "count": got, "launched": sorted(
                            k for k, n in tk.LAUNCHES.items()
                            if n > k_before.get(k, 0))}
            exp_path = os.path.join(tmp, "tqi_export.csv")
            t0 = time.monotonic()
            check(ctl(["export", "--host", tq_host, "-i", "tqi", "-f",
                       "events", "-o", exp_path]) == 0, "ctl export")
            export_s = time.monotonic() - t0
            with open(exp_path) as f:
                exported = set(f.read().split())
            check(exported == {f"{r},{col}" for r, col in
                               zip(trows.tolist(), tcols.tolist())},
                  "ctl export = the imported CSV's (row, col) set")
            tq_mstats = dict(tq_srv.handler.executor.mesh_manager().stats)
        finally:
            tq.close()
            tq_srv.close()
            th.close()
        out["ctl_import"] = {"bits": TQI_BITS, "csv_s": csv_s,
                             "wall_s": ctl_s, "bits_per_s": TQI_BITS / ctl_s,
                             "views": len(views), "ranges": ranges,
                             "export_s": export_s, "mesh_stats": tq_mstats}
        log(f"bulk: ctl import of {TQI_BITS} timestamped lines into "
            f"{len(views)} views in {ctl_s:.2f} s "
            f"({TQI_BITS / ctl_s:.0f} bits/s); Ranges exact, launched "
            f"{json.dumps(ranges)}; ctl export in {export_s:.2f} s, the "
            "imported set")
        mark("ctl import")

        # 4. ctl backup of index i's `general`, ctl restore into `rst`.
        mhost = "%s:%d" % main_srv.address
        t0 = time.monotonic()
        check(ctl(["backup", "--host", mhost, "-i", "i", "-f", "general",
                   "-o", str(tar_path)]) == 0, "ctl backup")
        backup_s = time.monotonic() - t0
        tar_bytes = tar_path.stat().st_size
        c.call("POST", "/index/rst", "{}")
        c.call("POST", "/index/rst/frame/general", "{}")
        t0 = time.monotonic()
        check(ctl(["restore", "--host", host, "-i", "rst", "-f", "general",
                   str(tar_path)]) == 0, "ctl restore")
        restore_s = time.monotonic() - t0
        n_same = 0
        with tarfile.open(tar_path) as tf:
            for m in tf.getmembers():
                s = int(m.name.split(".")[1])
                with tarfile.open(fileobj=tf.extractfile(m)) as inner:
                    data = inner.extractfile("data").read()
                frag = bh.fragment("rst", "general", "standard", s)
                with open(frag.path, "rb") as f:
                    n_same += f.read() == data
        check(n_same == SLICES, f"{n_same} restored files = their data "
                                "members")
        rst = Client(*srv.address, index="rst")
        try:
            launched = {}
            for key in (("and", 0, 1), ("and", PARTIAL_ROW, 0)):
                k_before = dict(tk.LAUNCHES)
                got = rst.count(pql(*key))
                check(got == host_count(words, *key), ("rst", key, got))
                torch.cuda.synchronize()
                launched[pql(*key)] = sorted(
                    k for k, n in tk.LAUNCHES.items()
                    if n > k_before.get(k, 0))
        finally:
            rst.close()
        k2 = tk.LAUNCHES["coarse_count_shared"]
        dense_q = [pql("and", a, b) for a, b in
                   itertools.combinations(range(DENSE_ROWS), 2)]
        rst_qps = concurrent(*srv.address, dense_q,
                             [host_count(words, "and", a, b) for a, b in
                              itertools.combinations(range(DENSE_ROWS), 2)],
                             index="rst")
        check(tk.LAUNCHES["coarse_count_shared"] > k2,
              "16 clients on the restored frame ran K2")
        check("coarse_count" in launched[pql("and", 0, 1)]
              and "tree_count" in launched[pql("and", PARTIAL_ROW, 0)],
              f"restored Counts ran K1 and K3: {launched}")
        out["backup"] = {"bytes": tar_bytes, "backup_s": backup_s,
                         "restore_s": restore_s,
                         "backup_mb_per_s": tar_bytes / backup_s / 1e6,
                         "restore_mb_per_s": tar_bytes / restore_s / 1e6,
                         "launched": launched, "concurrent_qps": rst_qps}
        log(f"bulk: backup of {SLICES} fragments ({tar_bytes} B) in "
            f"{backup_s:.2f} s ({tar_bytes / backup_s / 1e6:.1f} MB/s), "
            f"restore in {restore_s:.2f} s "
            f"({tar_bytes / restore_s / 1e6:.1f} MB/s); every data member "
            f"equal; Counts exact, launched {launched}")
        mark("backup and restore")

        # 5. Frame restore from another node.
        c.call("POST", "/index/fr", "{}")
        c.call("POST", "/index/fr/frame/general", "{}")
        t0 = time.monotonic()
        c.call("POST", "/index/fr/frame/general/restore?host=%s:%d"
               % fr_srv.address)
        fr_s = time.monotonic() - t0
        frc = Client(*srv.address, index="fr")
        try:
            for key in (("and", 0, 1), ("and", PARTIAL_ROW, 0)):
                got = frc.count(pql(*key))
                w = host_count(words[:FR_SLICES], *key)
                check(got == w, ("frame restore", key, got, w))
        finally:
            frc.close()
        out["frame_restore"] = {"slices": FR_SLICES, "s": fr_s}
        log(f"bulk: frame restore of {FR_SLICES} slices from another node "
            f"in {fr_s:.2f} s; Counts exact")
        mark("frame restore")

        # 6. Export and the block digests.
        cl = InternalClient(host)
        for s in range(4):
            rows, cols = sparse_slice_bits(sp, s)
            wcsv = "".join(f"{r},{col}\n" for r, col in zip(rows.tolist(),
                                                             cols.tolist()))
            check(cl.export_csv("imp", "sparse", "standard", s) == wcsv,
                  f"GET /export of slice {s}")
        rows, cols = sparse_slice_bits(sp, 0)
        pos = (rows << np.uint64(20)) | (cols & np.uint64((1 << 20) - 1))
        digest = hashlib.sha1(pos.astype("<u8").tobytes()).digest()
        check(cl.fragment_blocks("imp", "sparse", "standard", 0)
              == [(0, digest)], "GET /fragment/blocks")
        want_rc = ((pos >> np.uint64(20)).tolist(),
                   (pos & np.uint64((1 << 20) - 1)).tolist())
        check(cl.block_data("imp", "sparse", "standard", 0, 0) == want_rc,
              "GET /fragment/block/data, protobuf")
        doc = c.call("GET", "/fragment/block/data?index=imp&frame=sparse&"
                            "view=standard&slice=0&block=0")
        check((doc["rowIDs"], doc["columnIDs"]) == want_rc,
              "GET /fragment/block/data, JSON")
        log("bulk: export of slices 0-3 byte for byte, blocks and block "
            "data (JSON, protobuf) of slice 0 equal numpy")
        mark("export and blocks")
        torch.cuda.synchronize()
        launches = {k: tk.LAUNCHES.get(k, 0) for k in KERNELS}
        stats = dict(ex.stats)
        mstats = dict(mgr.stats)
        kern = {"pair_count_rows (TopN, imported frame sparse)": rows_case(
            mgr, ("imp", "sparse", "standard"), totals,
            f"pair_count_rows (TopN, imported {SPARSE_ROWS} rows x "
            f"{BULK_SLICES} slices)")}
    finally:
        c.close()
        for server in servers:
            server.close()
        for h in (bh, th, fh):
            h.close()
        tar_path.unlink(missing_ok=True)
    wall = time.monotonic() - t_phase
    log(f"bulk phase on {card}: launches {launches}; {wall:.1f} s, by step "
        f"{json.dumps({k: round(v, 1) for k, v in steps.items()})}")
    log(f"bulk phase stats {json.dumps(mstats, sort_keys=True)}")
    for k in BULK_PATH:
        check(launches[k] > 0, f"kernel {k} launched on the bulk path")
    check(stats.get("count_host", 0) == 0 and stats.get("topn_host", 0) == 0,
          f"no bulk query on the host: {stats}")
    return dict(out, launches=launches, stats=stats, mesh_stats=mstats,
                seconds=wall, step_seconds=steps, kernels=kern)



# -- phase 15: the node from its config ------------------------------------------

CONFIG_PATH = ("probe_ok", "coarse_count", "coarse_count_shared", "tree_count",
               "sparse_pair_count", "pair_count", "apply_writes")
CFG_COLUMNS = 2_000       # SetValues into cfg/f/val ...
CFG_SLICES = 96           # ... over these slices, in block 0 of each
CFG_MORE = 100            # SetValues into the staged field (K7)
CFG_RANGE = 100           # Count(Range(val > CFG_RANGE))
CFG_BUDGET_X = 1.5        # [mesh] hbm-budget-bytes over general's bytes
CFG_SCRAPES = 20
CFG_ROUNDS = 1            # rounds of the 28 pairs spread over 16 clients
BENCH_OPS = (("set-bit", 1000), ("intersect-count", 200), ("topn", 200))


def ctl_run(root: Path, *argv, timeout: float = 600) -> str:
    """`python -m pilosa_tpu_torch.ctl ARGV` from root; its stdout. A
    non-zero exit fails the run."""
    p = subprocess.run([sys.executable, "-m", "pilosa_tpu_torch.ctl",
                        *map(str, argv)], cwd=str(root), capture_output=True,
                       text=True, timeout=timeout)
    check(p.returncode == 0, ("ctl", argv, p.returncode, p.stderr[-3000:]))
    return p.stdout


def http_text(host: str, port: int, path: str) -> str:
    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
        check(resp.status == 200, (path, resp.status, body[:300]))
        return body
    finally:
        conn.close()


def parse_prom(text: str) -> dict:
    """{(name, ((label, value), ...)): value} of a text-format 0.0.4
    body, checked as it goes: every line parses, a family's TYPE comes
    before its samples, a histogram's buckets are cumulative and end in
    +Inf, and its _count equals that bucket."""
    import re

    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? '
                        r'(NaN|[+-]Inf|-?[0-9][0-9.e+-]*)$')
    types, out, buckets = {}, {}, {}
    check(text.endswith("\n"), "the exposition ends with a newline")
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ", 3)
            check(name not in types, f"family {name} typed twice")
            types[name] = mtype
            continue
        if not line or line.startswith("# HELP "):
            continue
        m = sample.match(line)
        check(m is not None, f"unparseable sample line {line!r}")
        name, labels = m.group(1), tuple(re.findall(
            r'(\w+)="((?:[^"\\]|\\.)*)"', m.group(3) or ""))
        fam = name if name in types else re.sub(r"_(bucket|sum|count)$",
                                                "", name)
        check(fam in types, f"sample {name} before its TYPE")
        value = float(m.group(4))
        out[(name, labels)] = value
        if types[fam] == "histogram" and name.endswith("_bucket"):
            key = (fam, tuple(kv for kv in labels if kv[0] != "le"))
            buckets.setdefault(key, []).append((dict(labels)["le"], value))
    for (fam, labels), bs in buckets.items():
        counts = [v for _, v in bs]
        check(counts == sorted(counts) and bs[-1][0] == "+Inf",
              f"{fam} buckets cumulative, ending in +Inf")
        check(out[(fam + "_count", labels)] == bs[-1][1],
              f"{fam}_count equals its +Inf bucket")
    return out


def fam_sum(samples: dict, name: str, **labels) -> float:
    """The sum of `name`'s samples whose labels include `labels`."""
    return sum(v for (n, ls), v in samples.items() if n == name
               and all(dict(ls).get(k) == w for k, w in labels.items()))


class NodeChild:
    """`python -m pilosa_tpu_torch.ctl server -c TOML` as a child process
    (output appended to `out`); ready when /version answers."""

    def __init__(self, root: Path, toml: Path, port: int, out: Path):
        self.port = port
        self.out = open(out, "a")
        t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.ctl", "server", "-c",
             str(toml)], cwd=str(root), stdout=self.out,
            stderr=subprocess.STDOUT)
        deadline = t0 + 300
        while True:
            check(self.proc.poll() is None and time.monotonic() < deadline,
                  f"the config node started: {out.read_text()[-3000:]}")
            try:
                doc = Client("127.0.0.1", port).call("GET", "/version")
                break
            except OSError:
                time.sleep(0.1)
        self.ready_s = time.monotonic() - t0
        check(doc.get("version"), ("version", doc))

    def client(self, index: str = "i") -> "Client":
        return Client("127.0.0.1", self.port, index)

    def launches(self) -> dict:
        c = self.client()
        try:
            return c.call("GET", "/debug/vars")["kernel_launches"]
        finally:
            c.close()

    def stop(self) -> float:
        """SIGTERM; the seconds until it exited, which must be with 0
        within 30 s."""
        import signal

        t0 = time.monotonic()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
            rc = None
        self.out.close()
        check(rc == 0, f"the config node exited 0 on SIGTERM: rc {rc}")
        return time.monotonic() - t0


def spread(host, port, queries, want, rounds: int) -> float:
    """`rounds` times, the queries spread over CLIENTS concurrent
    clients (client k sends queries k, k + CLIENTS, ...): each query
    once a round, so that the shadow folds of 1 in 10 stay few. Answers
    are checked; returns queries per second."""
    errors = []

    def client(k):
        c = Client(host, port)
        try:
            for i in range(k, len(queries), CLIENTS):
                got = c.count(queries[i])
                if got != want[i]:
                    errors.append((queries[i], got, want[i]))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            c.close()

    t0 = time.monotonic()
    for _ in range(rounds):
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    dt = time.monotonic() - t0
    check(not errors, f"spread answers: {errors[:5]}")
    return rounds * len(queries) / dt


def cfg_bits(values: dict) -> int:
    """Bits a field's view holds for {column: value}: existence, sign
    and the magnitude's planes."""
    v = np.asarray(list(values.values()), dtype=np.int64)
    return int(len(v) + (v < 0).sum()
               + np.bitwise_count(np.abs(v).astype(np.uint64)).sum())


def config_phase(words: np.ndarray, tmp: str, root: Path, card: str,
                 seed: int, dense: dict) -> dict:
    """Phase 15 (module docstring). `dense` is phase 4's record: its
    staged bytes (`general`'s view) set the budget, its lone QPS is the
    latency compared. The children's kernel launches come from their
    /debug/vars just before each SIGTERM."""
    import tomllib

    from pilosa_tpu_torch.config import Config

    t_phase = time.monotonic()
    out: dict = {}
    # (1) The config round trip.
    text = ctl_run(root, "config")
    check(Config.from_toml(text, is_text=True).to_toml() == text
          and tomllib.loads(text)["host"] == Config().host,
          "ctl config parses back to its own text")
    truth = DurTruth(words, seed)
    path = os.path.join(tmp, "config_node")
    write_s = write_dur_dir(path, truth)
    budget = int(CFG_BUDGET_X * dense["stats"]["staged_bytes"])
    dense_lone_qps = dense["lone_qps"]
    port = free_port()
    log_path = REPO / "chiprun_out" / "node.log"
    log_path.parent.mkdir(exist_ok=True)
    log_path.unlink(missing_ok=True)
    toml = Path(tmp) / "node.toml"
    toml.write_text(
        f'data-dir = "{path}"\nhost = "127.0.0.1:{port}"\n'
        f"[mesh]\nhbm-budget-bytes = {budget}\n"
        '[storage]\nfsync-policy = "group"\nmax-op-n = 500\n'
        "[integrity]\nshadow-sample-1-in = 10\n"
        f'[log]\nformat = "json"\nlevel = "info"\npath = "{log_path}"\n'
        '[[schema.indexes]]\nname = "cfg"\n[[schema.indexes.frames]]\n'
        'name = "f"\n[[schema.indexes.frames.fields]]\nname = "val"\n'
        "min = -1000\nmax = 1000\n")
    dry = tomllib.loads(ctl_run(root, "server", "--dry-run", "-c", toml,
                                "-b", "127.0.0.1:1"))
    check(dry["host"] == "127.0.0.1:1" and dry["data-dir"] == path
          and dry["mesh"]["hbm-budget-bytes"] == budget
          and dry["storage"]["max-op-n"] == 500
          and dry["integrity"]["shadow-sample-1-in"] == 10
          and dry["schema"]["indexes"][0]["frames"][0]["fields"][0][
              "name"] == "val", f"--dry-run: the flag over the TOML {dry}")
    # (2) The node on the card.
    node_out = REPO / "chiprun_out" / "node.out"
    node_out.unlink(missing_ok=True)
    node = NodeChild(root, toml, port, node_out)
    out["ready_s"] = node.ready_s
    launches: Counter = Counter()
    pairs = list(itertools.combinations(range(DENSE_ROWS), 2))
    lone_q = [pql("and", a, b) for a, b in pairs]
    lone_w = [host_count(words, "and", a, b) for a, b in pairs]
    rng = np.random.default_rng([seed, 15])
    cols = ((np.arange(CFG_COLUMNS) % CFG_SLICES) << 20) | rng.choice(
        1 << 16, CFG_COLUMNS, replace=False)
    values = dict(zip(cols.tolist(),
                      rng.integers(-1000, 1001, CFG_COLUMNS).tolist()))
    counts_sent = 0
    try:
        c = node.client()
        cf = node.client("cfg")
        try:
            schema = c.call("GET", "/schema")["indexes"]
            fields = [fd["name"] for ix in schema if ix["name"] == "cfg"
                      for fr in ix["frames"] if fr["name"] == "f"
                      for fd in fr["meta"]["fields"]]
            check(fields == ["val"], f"/schema shows cfg/f/val: {schema}")
            t0 = time.monotonic()
            check(c.count(PAIR) == truth.count(), "the pair Count")
            out["first_count_s"] = time.monotonic() - t0
            lat = []
            for q, w in zip(lone_q, lone_w):
                t0 = time.monotonic()
                got = c.count(q)
                lat.append((time.monotonic() - t0) * 1e3)
                check(got == w, ("lone", q, got, w))
            # 1 in 10 of them pays a ~0.4 s shadow fold: the p50 is the
            # lone latency, phase 4's 1 / QPS its mean without shadows.
            out["lone"] = {"n": len(lat), "p50_ms": pct(lat, 50),
                           "p90_ms": pct(lat, 90),
                           "phase4_mean_ms": 1e3 / dense_lone_qps}
            check(c.count(PARTIAL) == truth.partial(), "the partial row")
            out["concurrent_qps"] = spread("127.0.0.1", port, lone_q,
                                           lone_w, CFG_ROUNDS)
            counts_sent += 2 + len(lat) + CFG_ROUNDS * len(lone_q)
            # cfg/f: SetValue, Sum, Range, more SetValues, Sum.
            items = list(values.items())
            for lo in range(0, len(items), 100):
                cf.call("POST", "/index/cfg/query", "".join(
                    f"SetValue(frame=f, columnID={col}, val={v})"
                    for col, v in items[lo:lo + 100]))

            def check_sum(what):
                got = cf.call("POST", "/index/cfg/query",
                              'Sum(frame=f, field="val")')["results"][0]
                want = {"value": sum(values.values()), "count": len(values)}
                check(got == want, (what, got, want))

            check_sum("Sum")
            got = cf.count(f"Count(Range(frame=f, val > {CFG_RANGE}))")
            want = sum(v > CFG_RANGE for v in values.values())
            check(got == want, ("Count(Range)", got, want))
            counts_sent += 1
            more = rng.integers(-1000, 1001, CFG_MORE).tolist()
            cf.call("POST", "/index/cfg/query", "".join(
                f"SetValue(frame=f, columnID={col}, val={v})"
                for col, v in zip(cols[:CFG_MORE].tolist(), more)))
            values.update(zip(cols[:CFG_MORE].tolist(), more))
            check_sum("Sum after the SetValues into the staged field")
            # (4) ctl bench against the node.
            bench = {}
            for op, n in BENCH_OPS:
                res = json.loads(ctl_run(root, "bench", "--host",
                                         f"127.0.0.1:{port}", "--op", op,
                                         "-n", n).strip().splitlines()[-1])
                check(res["op"] == op and res["n"] == n, res)
                bench[op] = res["ops_per_sec"]
            counts_sent += dict(BENCH_OPS)["intersect-count"]
            export = http_text("127.0.0.1", port, "/export?index=bench&"
                               "frame=general&view=standard&slice=0")
            rc = np.array([ln.split(",") for ln in export.split()],
                          dtype=np.int64)
            rows = {int(r): set(rc[rc[:, 0] == r, 1].tolist())
                    for r in np.unique(rc[:, 0])}
            cb = node.client("bench")
            try:
                got = cb.call("POST", "/index/bench/query",
                              "Count(Intersect(Bitmap(rowID=1, frame="
                              "general), Bitmap(rowID=2, frame=general)))"
                              "TopN(frame=general, n=10)")["results"]
            finally:
                cb.close()
            counts_sent += 1
            check(got[0] == len(rows[1] & rows[2]),
                  ("bench Count", got[0], len(rows[1] & rows[2])))
            ranked = sorted(((len(v), r) for r, v in rows.items()),
                            key=lambda x: (-x[0], x[1]))
            want = [n for n, _ in ranked[:10]]
            check([t["count"] for t in got[1]] == want
                  and all(len(rows[t["id"]]) == t["count"] for t in got[1]),
                  ("bench TopN", got[1], ranked[:12]))
            out["bench_ops_per_sec"] = bench
            # (5) /metrics against /debug/vars, in one pause.
            scrape_ms = []
            for _ in range(CFG_SCRAPES):
                t0 = time.monotonic()
                text = http_text("127.0.0.1", port, "/metrics")
                scrape_ms.append((time.monotonic() - t0) * 1e3)
                m = parse_prom(text)
            dv = c.call("GET", "/debug/vars")
            mesh, wal = dv["mesh"], dv["storage"]["wal"]
            shadow = dv["integrity"]["shadow"]
            check(fam_sum(m, "pilosa_hbm_budget_bytes") == budget,
                  ("budget", fam_sum(m, "pilosa_hbm_budget_bytes"), budget))
            check(fam_sum(m, "pilosa_hbm_resident_bytes")
                  == mesh["staged_bytes"] == mesh["hbm"]["padded_bytes"],
                  ("resident bytes", fam_sum(m, "pilosa_hbm_resident_bytes"),
                   mesh["staged_bytes"], mesh["hbm"]["padded_bytes"]))
            zero = {f: fam_sum(m, f) for f in (
                "pilosa_hbm_evictions_total", "pilosa_device_fallback_total")}
            check(zero == {f: 0 for f in zero}
                  and mesh.get("evicted", 0) == 0, ("no eviction", zero))
            checks = {
                "fsync": (fam_sum(m, "pilosa_wal_fsync_total"),
                          wal.get("fsync", 0)),
                "snapshots": (fam_sum(m, "pilosa_storage_snapshots_total",
                                      outcome="ok"), wal.get("snapshots", 0)),
                "shadow": (fam_sum(m, "pilosa_shadow_checks_total"),
                           sum(v for k, v in shadow.items()
                               if k.startswith("checks:"))),
                "mismatch": (fam_sum(m, "pilosa_shadow_mismatch_total"),
                             sum(v for k, v in shadow.items()
                                 if k.startswith("mismatch:")))}
            check(all(a == b for a, b in checks.values())
                  and checks["fsync"][0] > 0 and checks["snapshots"][0] > 0
                  and checks["shadow"][0] > 0 and checks["mismatch"][0] == 0,
                  ("/metrics against /debug/vars", checks))
            routes = {b: fam_sum(m, "pilosa_query_route_total", backend=b)
                      for b in ("mesh", "host-fold", "roaring", "bsi-mesh",
                                "bsi-host")}
            check(routes["mesh"] == counts_sent and routes["bsi-mesh"] == 2
                  and routes["host-fold"] == routes["bsi-host"] == 0,
                  ("routes", routes, counts_sent))
            out["metrics"] = {"scrape_p50_ms": pct(scrape_ms, 50),
                              "scrape_max_ms": max(scrape_ms),
                              "bytes": len(text), "families": len({
                                  n for n, _ in m}), "checks": checks,
                              "routes": routes, "budget": budget,
                              "staged_bytes": mesh["staged_bytes"]}
            out["schema"] = c.call("GET", "/schema")["indexes"]
        finally:
            c.close()
            cf.close()
        launches.update(node.launches())
    finally:
        out["stop_s"] = node.stop()
    lines = log_path.read_text().splitlines()
    check(lines and all(isinstance(json.loads(ln), dict) for ln in lines),
          "every log line is JSON")
    # (6) The files the node left.
    base = Path(path)
    gen = sorted(p for p in (base / "i/general/standard/fragments").iterdir()
                 if p.name.isdigit())
    cfg_files = sorted(p for p in base.glob("cfg/*/*/fragments/*")
                       if p.name.isdigit())
    t0 = time.monotonic()
    report = ctl_run(root, "check", *gen, *cfg_files)
    check_s = time.monotonic() - t0
    bits = {}
    for line in report.splitlines():
        f, _, rest = line.rpartition(": ok (")
        check(rest.endswith(" bits)"), f"ctl check: {line}")
        bits[Path(f)] = int(rest.split()[0])
    mask_bits = sum(len(m) for m in truth.mask.values())
    want_gen = int(np.bitwise_count(words).sum(dtype=np.int64)) + mask_bits
    got_gen = sum(bits[p] for p in gen)
    check(got_gen == want_gen, ("general's bits", got_gen, want_gen))
    got_cfg = sum(bits[p] for p in cfg_files)
    check(got_cfg == cfg_bits(values), ("cfg's bits", got_cfg,
                                        cfg_bits(values)))
    info = json.loads(ctl_run(root, "inspect", gen[0]))
    want_keys = [(r * 16 + b, int(np.bitwise_count(words[0, r, b]).sum()))
                 for r in range(words.shape[1]) for b in range(16)
                 if words[0, r, b].any()]
    if 0 in truth.mask:
        m0 = truth.mask[0]
        want_keys += [(DUR_MASK_ROW * 16 + b, int(((m0 >> 16) == b).sum()))
                      for b in range(16) if ((m0 >> 16) == b).any()]
    check([(x["key"], x["n"]) for x in info["containers"]] == want_keys,
          "ctl inspect of slice 0 gives numpy's containers")
    # (7) The restart.
    node = NodeChild(root, toml, port, node_out)
    try:
        c = node.client()
        cf = node.client("cfg")
        try:
            check(c.call("GET", "/schema")["indexes"] == out["schema"],
                  "the schema applied again, unchanged")
            t0 = time.monotonic()
            check(c.count(PAIR) == truth.count(), "the pair after restart")
            restart_first_s = time.monotonic() - t0
            got = cf.call("POST", "/index/cfg/query",
                          'Sum(frame=f, field="val")')["results"][0]
            check(got == {"value": sum(values.values()),
                          "count": len(values)}, ("Sum after restart", got))
        finally:
            c.close()
            cf.close()
        launches.update(node.launches())
    finally:
        node.stop()
    launches = {k: launches.get(k, 0) for k in KERNELS}
    wall = time.monotonic() - t_phase
    out.update(launches=launches, stats={}, write_dir_s=write_s,
               check_s=check_s, files_checked=len(bits),
               restart_ready_s=node.ready_s,
               restart_first_count_s=restart_first_s, seconds=wall,
               kernels={})
    log(f"config node on {card}: ready {out['ready_s']:.2f} s after spawn "
        f"(restart {node.ready_s:.2f} s); first Count "
        f"{out['first_count_s']:.2f} s (restart {restart_first_s:.2f} s); "
        f"lone p50 {out['lone']['p50_ms']:.3f} ms (phase 4's mean "
        f"{out['lone']['phase4_mean_ms']:.3f} ms); the 28 pairs over "
        f"{CLIENTS} clients {out['concurrent_qps']:.1f} QPS; bench "
        f"{json.dumps(out['bench_ops_per_sec'])} ops/s; /metrics p50 "
        f"{out['metrics']['scrape_p50_ms']:.2f} ms over {CFG_SCRAPES} "
        f"scrapes ({out['metrics']['bytes']} B, "
        f"{out['metrics']['families']} series); SIGTERM exit in "
        f"{out['stop_s']:.2f} s; ctl check of {len(bits)} files "
        f"{check_s:.2f} s")
    log(f"config phase launches {launches}; {wall:.1f} s")
    for k in CONFIG_PATH:
        check(launches[k] > 0, f"kernel {k} launched on the config path")
    return out


# -- phase 16: admission and the query's own record -----------------------------

ADM_PATH = ("probe_ok", "coarse_count", "coarse_count_shared", "tree_count")
ADM_CLIENTS = 64          # the overload's clients, half of them tenant gold
ADM_REQUESTS = 10         # requests each overload client sends
ADM_DEADLINE_US = 20_000  # each overload request's X-Pilosa-Deadline-Us
ADM_FORCED = 20           # requests shed through the sched.admit seam
ADM_STALL_S = 6.0         # the held commit: past stall-after 4 x base 1 s
ADM_LONE_CALLS = 200      # lone Counts a turn of the cost comparison
ADM_DEBT_PROBES = 5       # requests a tenant sends to read its debt header


def adm_toml(path: str, port: int, on: bool = True) -> str:
    """The phase's node: every store on (the scheduler's queue depth 16,
    tenant gold at weight 4, 1 in 10 queries profiled, the debt
    threshold 0.5, the watchdog every 100 ms judging at 4x), or the
    scheduler, SLO and health off, no cost ledger and no sampling."""
    head = f'data-dir = "{path}"\nhost = "127.0.0.1:{port}"\n'
    if not on:
        return head + ("[sched]\nenabled = false\n[slo]\nenabled = false\n"
                       "[health]\nenabled = false\n[obs]\n"
                       "cost-ledger = false\nprofile-sample-rate = 0\n")
    return head + ("[sched]\nqueue-depth = 16\n[sched.tenant-weights]\n"
                   "gold = 4\n[obs]\nprofile-sample-rate = 10\n"
                   "cost-debt-threshold = 0.5\n[health]\n"
                   'sweep-interval = "100ms"\nstall-after = 4\n')


def adm_post(conn, path: str, body: str, headers=None):
    """(status, response headers, JSON doc) of one POST."""
    conn.request("POST", path, body=body.encode(), headers=headers or {})
    resp = conn.getresponse()
    return resp.status, dict(resp.getheaders()), json.loads(resp.read())


def adm_server(toml: str):
    """An in-process Server on the card from TOML text, open."""
    from pilosa_tpu_torch.config import Config
    from pilosa_tpu_torch.server import Server

    srv = Server(Config.from_toml(toml, is_text=True))
    srv.open()
    return srv


def adm_settle(srv) -> None:
    """Wait for the server's `warm` thread (it loads every fragment the
    open left lazy, under the interpreter lock) and collect, so that no
    timed or profiled query shares the host with either."""
    for t in srv._threads:
        if t.name == "warm":
            t.join(timeout=300)
    gc.collect()


def adm_outcomes(samples: dict) -> dict:
    """{(outcome, tenant): n} of pilosa_query_outcome_total, route query."""
    return {(dict(ls)["outcome"], dict(ls)["tenant"]): v
            for (n, ls), v in samples.items()
            if n == "pilosa_query_outcome_total"
            and dict(ls).get("route") == "query"}


def adm_overload(port: int, queries, want) -> dict:
    """ADM_CLIENTS clients at once, the odd ones tenant gold, each sending
    ADM_REQUESTS of the queries with a deadline of ADM_DEADLINE_US: each
    answer is a 200 equal to numpy, a 429 with Retry-After >= 1, or a
    504. Returns the clients' own counts by (outcome, tenant)."""
    from pilosa_tpu_torch.obs.slo import outcome_for_status

    counts: Counter = Counter()
    debts: Counter = Counter()
    errors, mu = [], threading.Lock()

    def client(k):
        tenant = "gold" if k % 2 else "default"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            for j in range(ADM_REQUESTS):
                i = (k * ADM_REQUESTS + j) % len(queries)
                status, hdr, doc = adm_post(
                    conn, "/index/i/query", queries[i],
                    {"X-Pilosa-Tenant": tenant,
                     "X-Pilosa-Deadline-Us": str(ADM_DEADLINE_US)})
                bad = None
                if status == 200 and doc["results"] != [want[i]]:
                    bad = (queries[i], doc, want[i])
                elif status == 429 and int(hdr.get("Retry-After", 0)) < 1:
                    bad = ("429 without Retry-After", hdr)
                elif status not in (200, 429, 504):
                    bad = (status, doc)
                with mu:
                    counts[(outcome_for_status(status), tenant)] += 1
                    if status == 200 and "X-Pilosa-Cost-Debt" in hdr:
                        debts[tenant] += 1
                    if bad:
                        errors.append(bad)
        except Exception as e:  # noqa: BLE001 — reported below
            with mu:
                errors.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(ADM_CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"overload answers: {errors[:5]}")
    return {"counts": counts, "debts": debts,
            "seconds": time.monotonic() - t0}


def adm_lone_p50(srv, toml: str, calls: int, want: int) -> dict:
    """The lone pair Count's p50 / p90 (ms, over HTTP) over `calls`
    calls on the open Server `srv`, its [obs], [sched], [slo] and
    [health] wired anew from `toml` (Server._wire_observability; the
    scheduler it held is closed first): the same staged view and the
    same process for both configurations, so the turns differ only in
    the stores."""
    from pilosa_tpu_torch.config import Config

    if srv.scheduler is not None:
        srv.scheduler.close()
    srv.config = Config.from_toml(toml, is_text=True)
    srv._wire_observability()
    gc.collect()
    c = Client("127.0.0.1", int(srv.host.rpartition(":")[2]))
    try:
        lat = []
        for _ in range(calls):
            t0 = time.monotonic()
            got = c.count(PAIR)
            lat.append((time.monotonic() - t0) * 1e3)
            check(got == want, ("cost comparison Count", got, want))
    finally:
        c.close()
    return {"p50_ms": pct(lat, 50), "p90_ms": pct(lat, 90)}


def admission_phase(words: np.ndarray, tmp: str, root: Path, card: str,
                    seed: int, dense: dict) -> dict:
    """Phase 16 (module docstring), on the config phase's directory:
    `general` at 960 slices, the headline rows and a mask row."""
    import torch

    from pilosa_tpu_torch import fault
    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.sched import AdmissionError

    t_phase = time.monotonic()
    out: dict = {}
    truth = DurTruth(words, seed)
    path = os.path.join(tmp, "config_node")
    pairs = list(itertools.combinations(range(DENSE_ROWS), 2))
    lone_q = [pql("and", a, b) for a, b in pairs]
    lone_w = [host_count(words, "and", a, b) for a, b in pairs]
    served: Counter = Counter()  # 200 Counts by tenant, every step
    tk.reset_launches()
    port = free_port()
    srv = adm_server(adm_toml(path, port))
    h = srv.handler
    mgr = None
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        c = Client("127.0.0.1", port)
        # The ledger is process-wide: the earlier phases' servers charged
        # it too, so this phase reads its own accounts as deltas.
        ledger0: Counter = Counter()
        for a in c.call("GET", "/debug/costs?limit=100000")["accounts"]:
            ledger0[a["tenant"]] += a["queries"]
        # (1) The lone Count, profiled, and its trace.
        t0 = time.monotonic()
        check(c.count(PAIR) == truth.count(), "the staging pair")
        out["first_count_s"] = time.monotonic() - t0
        adm_settle(srv)
        mgr = h.executor.mesh_manager()
        launches0 = dict(tk.LAUNCHES)
        status, _, doc = adm_post(conn, "/index/i/query?profile=true", PAIR)
        check(status == 200 and doc["results"] == [truth.count()],
              ("profiled pair", status, doc))
        prof = doc["profile"]
        served["default"] += 2
        phases = set(prof["phases_us"])
        check({"parse", "plan", "device_exec", "readback_d2h"} <= phases,
              f"profile phases {prof['phases_us']}")
        want_bytes = 2 * SLICES * RUN_BYTES
        check(prof["bytes"]["bytes_touched_hbm"] == want_bytes,
              ("bytes_touched_hbm", prof["bytes"], want_bytes))
        check(dict(tk.LAUNCHES)["coarse_count"]
              > launches0["coarse_count"], "the profiled pair ran K1")
        rf = prof["roofline"]
        frac = rf["fraction_of_peak"]
        check(frac is None or 0 < frac <= 1.0, f"roofline {rf}")
        if card == "NVIDIA H100 80GB HBM3":
            check(rf["peak_bytes_per_s"] == 3.35e12 and frac is not None,
                  f"the H100's peak: {rf}")
        out["profile"] = prof
        recent = c.call("GET", "/debug/queries")["recent"]
        tid = recent[0]["id"]
        check(recent[0]["tags"]["query"] == PAIR, recent[0])
        tr = c.call("GET", f"/debug/traces/{tid}")
        names = [sp["name"] for sp in tr["spans"]]
        check({"query", "parse", "plan", "launch"} <= set(names),
              f"the trace's spans {names}")
        out["trace_spans"] = names
        k3 = dict(tk.LAUNCHES)["tree_count"]
        status, _, doc = adm_post(conn, "/index/i/query?profile=true",
                                  PARTIAL)
        check(status == 200 and doc["results"] == [truth.partial()],
              ("profiled partial row", status, doc))
        served["default"] += 1
        check(dict(tk.LAUNCHES)["tree_count"] > k3
              and doc["profile"]["slices"][0]["kernel"] == "tree_count_rows",
              ("the partial row ran K3", doc["profile"].get("slices")))
        out["partial_profile"] = doc["profile"]
        # (2) Overload, its outcome accounting and forced sheds, while
        # the service estimate knows only lone Counts.
        before = adm_outcomes(parse_prom(http_text("127.0.0.1", port,
                                                   "/metrics")))
        ov = adm_overload(port, lone_q, lone_w)
        after = adm_outcomes(parse_prom(http_text("127.0.0.1", port,
                                                  "/metrics")))
        delta = {k: after.get(k, 0) - before.get(k, 0)
                 for k in set(after) | set(before)}
        delta = {k: v for k, v in delta.items() if v}
        check(delta == dict(ov["counts"]),
              ("outcome_total against the clients", delta, ov["counts"]))
        check(ov["counts"][("shed", "gold")] + ov["counts"][
            ("shed", "default")] + ov["counts"][("deadline", "gold")]
            + ov["counts"][("deadline", "default")] > 0,
            f"the overload shed or expired: {ov['counts']}")
        for t in ("gold", "default"):
            served[t] += ov["counts"][("ok", t)]
        slo = c.call("GET", "/debug/slo")
        w5 = slo["windows"]["5m"]
        n_before = sum(served.values()) - sum(
            ov["counts"][("ok", t)] for t in ("gold", "default"))
        total = n_before + sum(ov["counts"].values())
        shed = sum(v for (o, _), v in ov["counts"].items() if o == "shed")
        bad = sum(v for (o, _), v in ov["counts"].items() if o != "ok")
        check(w5["requests"] == total and w5["shed"] == shed,
              ("/debug/slo 5m", w5["requests"], w5["shed"], total, shed))
        ev = w5["objectives"]
        check(abs(ev["availability"]["sli"] - (total - bad) / total) < 1e-9
              and abs(ev["shed_rate"]["shed_fraction"] - shed / total)
              < 1e-9, ("availability and shed rate", ev))
        share = {t: ov["counts"][("ok", t)] / sum(
            v for (_, tt), v in ov["counts"].items() if tt == t)
            for t in ("gold", "default")}
        out["overload"] = {"counts": {f"{o}:{t}": v for (o, t), v
                                      in sorted(ov["counts"].items())},
                           "served_share": share,
                           "seconds": ov["seconds"],
                           "debt_headers": dict(ov["debts"]),
                           "availability": ev["availability"]["sli"],
                           "shed_fraction": ev["shed_rate"]["shed_fraction"]}
        fault.arm("sched.admit", times=ADM_FORCED,
                  error=AdmissionError("forced shed", 1.0, "forced"))
        forced = [adm_post(conn, "/index/i/query", PAIR)
                  for _ in range(ADM_FORCED)]
        fault.reset()
        check(all(s_ == 429 and hd.get("Retry-After") == "1"
                  for s_, hd, _ in forced),
              f"forced sheds {[(s_, hd.get('Retry-After')) for s_, hd, _ in forced]}")
        # (3) The 28 pairs from 16 clients, twice, through the scheduler.
        rounds = []
        for _ in range(2):
            k2, hinted = (dict(tk.LAUNCHES)["coarse_count_shared"],
                          mgr.stats.get("sched_hinted", 0))
            qps = concurrent("127.0.0.1", port, lone_q, lone_w)
            rounds.append({"qps": qps, "k2": dict(tk.LAUNCHES)[
                "coarse_count_shared"] - k2, "sched_hinted": mgr.stats.get(
                    "sched_hinted", 0) - hinted})
        served["default"] += 2 * CLIENTS * len(lone_q)
        check(all(r["k2"] > 0 for r in rounds), f"K2 launched {rounds}")
        out["rounds"] = rounds
        out["sched_after_rounds"] = dict(srv.scheduler.stats)
        # (4) Costs and shapes.
        costs = c.call("GET", "/debug/costs?limit=100000&sort=queries")
        by_tenant: Counter = Counter()
        dev_us: Counter = Counter()
        for a in costs["accounts"]:
            by_tenant[a["tenant"]] += a["queries"]
            dev_us[a["tenant"]] += a["device_us"]
        by_tenant.subtract(ledger0)
        check(by_tenant["gold"] == served["gold"]
              and by_tenant["default"] == served["default"],
              ("ledger queries against the served Counts", dict(by_tenant),
               dict(served)))
        pair_shape = "Count(Intersect(Bitmap,Bitmap))"
        hbm = [a for a in costs["accounts"]
               if a["tenant"] == "default" and a["shape"] == pair_shape]
        check(hbm and hbm[0]["hbm_byte_seconds"] > 0,
              ("general's residency on the pair's account", hbm))
        tot_dev = sum(dev_us.values())
        shares = {t: dev_us[t] / tot_dev for t in dev_us}
        probes = {}
        for t in ("gold", "default"):
            got = [adm_post(conn, "/index/i/query", PAIR,
                            {"X-Pilosa-Tenant": t})
                   for _ in range(ADM_DEBT_PROBES)]
            check(all(s_ == 200 and d["results"] == [truth.count()]
                      for s_, _, d in got), ("debt probes", got))
            served[t] += ADM_DEBT_PROBES
            probes[t] = sum("X-Pilosa-Cost-Debt" in hd for _, hd, _ in got)
        dominant = [t for t, v in shares.items() if v > 0.5]
        check(dominant and all(
            probes[t] == (ADM_DEBT_PROBES if shares.get(t, 0) > 0.5 else 0)
            for t in probes),
            ("X-Pilosa-Cost-Debt on the dominant tenant", shares, probes))
        out["costs"] = {"queries": dict(by_tenant), "device_share": shares,
                        "debt_probes": probes,
                        "totals": costs["totals"]}
        shapes = c.call("GET", "/debug/queryshapes?sort=count&limit=100")
        rows = {r["signature"]: r["count"] for r in shapes["top"]}
        check(rows.get(pair_shape) == sum(served.values()),
              ("queryshapes' pair", rows, sum(served.values())))
        out["queryshapes"] = rows
        # (5) Health: a commit held past stall-after x the wal base.
        check(c.call("GET", "/healthz")["status"] == "ok"
              and c.call("GET", "/readyz")["status"] == "ok",
              "healthz and readyz")
        from pilosa_tpu_torch.obs.health import HEALTH

        col = truth.next_col(0)
        old_dossiers = set(HEALTH.list_dossiers())
        fault.arm("storage.fsync", delay=ADM_STALL_S, times=1,
                  kind="commit")
        acked = []
        writer = threading.Thread(target=lambda: acked.append(
            adm_post(http.client.HTTPConnection("127.0.0.1", port,
                                                timeout=120),
                     "/index/i/query", setbit(col))))
        t0 = time.monotonic()
        writer.start()
        stalled_s = ready_503 = None
        while time.monotonic() - t0 < ADM_STALL_S - 0.5:
            sub = c.call("GET", "/debug/health")["subsystems"].get("wal", {})
            if sub.get("state") == "stalled":
                stalled_s = time.monotonic() - t0
                s_, body_ = c.raw("GET", "/readyz")
                ready_503 = (s_, body_)
                break
            time.sleep(0.05)
        check(stalled_s is not None and ready_503[0] == 503
              and "stalled:wal" in ready_503[1]["reasons"],
              ("wal stalled and /readyz 503", stalled_s, ready_503))
        # The sweep marks the subsystem, logs the stack, then writes.
        while True:
            dossiers = [d for d in HEALTH.list_dossiers()
                        if d not in old_dossiers]
            if dossiers or time.monotonic() - t0 > ADM_STALL_S - 0.5:
                break
            time.sleep(0.05)
        check(len(dossiers) == 1 and os.path.getsize(dossiers[0])
              <= HEALTH.dossier_max_bytes,
              ("one dossier within dossier-max", dossiers))
        dossier = json.loads(Path(dossiers[0]).read_text())
        check(dossier["schema"] == "pilosa-tpu/dossier/v1"
              and dossier["reason"] == "stall-wal", dossier.get("reason"))
        writer.join(timeout=60)
        fault.reset()
        check(acked and acked[0][0] == 200
              and acked[0][2]["results"] == [True],
              ("the held SetBit acked", acked))
        truth.ack(col)
        t1 = time.monotonic()
        while c.raw("GET", "/readyz")[0] != 200:
            check(time.monotonic() - t1 < 10, "/readyz back to 200")
            time.sleep(0.05)
        check(c.count(PAIR) == truth.count(), "the acked SetBit counted")
        served["default"] += 1
        out["health"] = {"stalled_after_s": stalled_s,
                         "recovered_after_s": time.monotonic() - t0,
                         "dossier_bytes": os.path.getsize(dossiers[0]),
                         "trips": HEALTH.trips_total()}
        host = f"127.0.0.1:{port}"
        diag = Path(tmp) / "diagnose.json"
        panels = {}

        def panel(argv):
            panels[argv[0]] = ctl_run(root, *argv, "--host", host,
                                      timeout=120)

        ctl_threads = [threading.Thread(target=panel, args=(argv,))
                       for argv in (("health", "-n", 1), ("costs", "-n", 1),
                                    ("top", "-n", 1),
                                    ("diagnose", "-o", diag))]
        for t in ctl_threads:
            t.start()
        for t in ctl_threads:
            t.join()
        check(len(panels) == 4 and all(
            panels[k].strip() for k in ("health", "costs", "top")),
            f"ctl health, costs, top and diagnose: {sorted(panels)}")
        bundle = json.loads(diag.read_text())
        check(bundle["schema"] == "pilosa-tpu/dossier/v1"
              and "slo" in bundle["sections"], "ctl diagnose's dossier")
        c.close()
        conn.close()
        out["mesh_stats"] = dict(mgr.stats)
        # (6) The cost of the stores: the lone Count, off / on / on / off.
        cost = {"off": [], "on": []}
        for turn in ("off", "on", "on", "off"):
            cost[turn].append(adm_lone_p50(
                srv, adm_toml(path, port, turn == "on"), ADM_LONE_CALLS,
                truth.count()))
    finally:
        fault.reset()
        srv.close()
    from pilosa_tpu_torch.obs import costs as obs_costs
    from pilosa_tpu_torch.obs import health as obs_health

    obs_costs.LEDGER.enabled = obs_costs.WATCH.enabled = True
    obs_health.HEALTH.enabled = True
    launches = {k: tk.LAUNCHES.get(k, 0) for k in KERNELS}
    out["store_cost"] = cost
    wall = time.monotonic() - t_phase
    out.update(launches=launches, stats=out.get("mesh_stats", {}),
               seconds=wall, kernels={})
    p4 = dense.get("k2_rounds", [])
    log(f"admission phase on {card}: profiled pair device_exec "
        f"{prof['phases_us']['device_exec']:.1f} us, readback "
        f"{prof['phases_us']['readback_d2h']:.1f} us, bytes "
        f"{prof['bytes']['bytes_touched_hbm']}, roofline "
        f"{rf['fraction_of_peak']} of {rf.get('peak_bytes_per_s')} B/s; "
        f"spans {out['trace_spans']}")
    log(f"admission phase K2 launches a round {[r['k2'] for r in rounds]} "
        f"(sched_hinted {[r['sched_hinted'] for r in rounds]}, QPS "
        f"{[round(r['qps'], 1) for r in rounds]}) beside phase 4's "
        f"{p4} without a scheduler")
    log(f"admission phase overload ({ADM_CLIENTS} clients x "
        f"{ADM_REQUESTS}, deadline {ADM_DEADLINE_US} us): "
        f"{json.dumps(out['overload'], sort_keys=True)}")
    log(f"admission phase costs {json.dumps(out['costs'], sort_keys=True)}")
    log(f"admission phase health {json.dumps(out['health'])}")
    log(f"admission phase lone Count p50 ms, stores off / on / on / off: "
        f"{cost['off'][0]['p50_ms']:.4f} / {cost['on'][0]['p50_ms']:.4f} / "
        f"{cost['on'][1]['p50_ms']:.4f} / {cost['off'][1]['p50_ms']:.4f}")
    log(f"admission phase launches {launches}; {wall:.1f} s")
    for k in ADM_PATH:
        check(launches[k] > 0, f"kernel {k} launched on the admission path")
    return out


# -- phase 17: the on-chip probe tools -------------------------------------------


def probe_phase(device, seed: int) -> dict:
    """The probe tools through their main(), the counters set to 0 just
    before and read just after; then K6 (coarse_count_blocked) at every T
    over pools of PROBE_SLICES and stream_popcount, each held exactly
    against its plain version (coarse_plain's uniform form, stream_plain)
    and against numpy; the rows at SLICES are timed."""
    import torch

    from pilosa_tpu_torch.ops import kernels as tk
    from pilosa_tpu_torch.tools import (probe_r5, probe_r5_bw,
                                       profile_headline, profile_stage)

    out_dir = REPO / "chiprun_out" / "probes"
    common = ["--device", "cuda", "--out", str(out_dir)]
    runs = [("probe_r5_bw", probe_r5_bw, ["--reps", "5"]),
            ("probe_r5_kernels", probe_r5, ["kernels"]),
            ("probe_r5_stage", probe_r5, ["stage", "--reps", "2"]),
            ("probe_r5_readback", probe_r5, ["readback"]),
            ("profile_stage", profile_stage, []),
            ("profile_headline", profile_headline, ["--reps", "30"])]
    seconds = {}
    t_phase = time.monotonic()
    tk.reset_launches()
    for name, mod, argv in runs:
        t0 = time.monotonic()
        check(mod.main(argv + common) == 0, f"{name} exits 0")
        seconds[name] = time.monotonic() - t0
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    log(f"probe phase: tools in {json.dumps(seconds)} s; launches "
        f"{launches}")
    for k in PROBE_PATH:
        check(launches[k] > 0, f"kernel {k} launched on the probe path")
    # Each tool checked its own answers against numpy and raised if one
    # was wrong; their records go into chip_smoke.json.
    records = {name: json.loads((out_dir / f"{name}.json").read_text())
               for name, _, _ in runs}

    pair = ["and", ["leaf", 0], ["leaf", 1]]
    gen = torch.Generator(device=device).manual_seed(seed)
    results, checked = {}, {}
    for s in PROBE_SLICES:
        pool = torch.randint(-2**31, 2**31, (s, 32, 2048), dtype=torch.int32,
                             device=device, generator=gen)
        host = pool.cpu().numpy().view(np.uint32)
        per = np.bitwise_count(host[:, :16] & host[:, 16:]).sum(
            axis=(1, 2), dtype=np.int64)[None]
        starts = torch.tensor([0, 1], dtype=torch.int32, device=device)
        pp = (pool, pool)

        def plain():
            return tk.coarse_plain(pp, starts, True, pair, 1)

        want = plain()
        check(np.array_equal(want.cpu().numpy(), per), f"plain K6 S={s}")
        cases = [(f"coarse_count_blocked t{t} (S={s})",
                  "coarse_count_blocked",
                  lambda t=t: tk.coarse_count_blocked(pp, starts, pair, t),
                  plain, want, 2 * s * RUN_BYTES + 8 + 4 * s)
                 for t in tk.BLOCK_SLICES]
        want_bits = int(np.bitwise_count(host).sum(dtype=np.int64))
        cases.append((f"stream_popcount (S={s})", "stream_popcount",
                      lambda: tk.stream_popcount(pool),
                      lambda: tk.stream_plain(pool),
                      tk.stream_plain(pool), host.nbytes + 8))
        check(int(cases[-1][4]) == want_bits, f"plain stream S={s}")
        for name, kernel, run, plain_fn, ref, nbytes in cases:
            got = run()
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
            check(err == 0 and got.shape == ref.shape,
                  f"{name}: kernel != plain (max err {err})")
            check(np.array_equal(got.cpu().numpy(),
                                 per if kernel == "coarse_count_blocked"
                                 else want_bits), f"{name} != numpy")
            if s != SLICES:
                checked[name] = {"kernel": kernel, "max_abs_err": err}
                continue
            ms = time_ms(run, 20)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            results[name] = {
                "kernel": kernel, "ms": ms, "plain_ms": time_ms(plain_fn, 3),
                "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
                "gb_per_s": nbytes / ms / 1e6, "max_abs_err": err,
                "library_ms": None}
            log(f"  {name:36s} {ms:8.4f} ms  {nbytes / ms / 1e6:7.1f} GB/s  "
                f"bound {bound_ms:.4f} ms  plain "
                f"{results[name]['plain_ms']:.3f} ms  exact")
        log(f"probe phase: K6 at T {tk.BLOCK_SLICES} and stream_popcount "
            f"match plain and numpy at S={s}")
        del pool, pp, want
    torch.cuda.empty_cache()
    phase_s = time.monotonic() - t_phase
    log(f"probe phase: {phase_s:.2f} s in all")
    return {"launches": launches, "tool_s": seconds, "phase_s": phase_s,
            "records": records, "kernels": results, "checked": checked}


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


def sparse_qps_only(root: Path, card: str, smi: str, seed: int) -> int:
    """Phase 6 alone, served by the package under `root`, and its QPS
    and busy share as one JSON line: run it once per tree, alternating,
    to compare two trees' sorted-array serving in one call."""
    import torch

    words = make_words(SLICES, seed)
    sp = SparseRows(SLICES, seed)
    with tempfile.TemporaryDirectory() as tmp:
        holder = build_holder(tmp, words)
        try:
            add_sparse_frames(holder, words, sp)
            sps = sparse_phase(holder, words, sp, card, torch.device("cuda"))
        finally:
            holder.close()
    print(json.dumps({"sparse_qps_of": str(root), "card": smi,
                      "first_query_s": sps["first_query_s"],
                      "collect_after_staging_ms":
                          sps["collect_after_staging_ms"],
                      "lone_qps": sps["lone_qps"],
                      "concurrent_qps": sps["concurrent_qps"],
                      "device_busy_share":
                          sps["profile"]["device_busy_share"]}), flush=True)
    return 0


def kernel_times_only(root: Path, smi: str, seed: int, ptxas: dict) -> int:
    """K4 at the chip shape, K2's two wrappers at the headline and the
    wide shape, K1's slice sweep (k1_sweep), K6 at T in K6_SWEEP_T over
    the headline's slices, K3's slice sweep and Range-shaped tree
    (k3_sweep), and K7 at K7_WIDE and over K7_SWEEP beside the
    scattered-sector probe (k7_sweep, on a random pool of the headline
    view's shape), built and run by the package under `root`, each held
    exactly against its plain version, timed, and printed as one JSON
    line with the build's ptxas report. The inputs are made on the card
    from the seed, the same for every tree: run it alternately on two
    checkouts (parent, change, change, parent) to compare their kernels
    on one card."""
    import torch

    device = torch.device("cuda")
    args, la, lb = sparse_pair_inputs(SparseRows(SLICES, seed), device)
    pool, uni, tab = random_runs(SLICES, DENSE_ROWS, device, seed + 1)
    pairs16 = tuple(itertools.combinations(range(DENSE_ROWS), 2))[:16]
    cases = [sparse_pair_case(args, la, lb),
             *shared_cases((pool,) * DENSE_ROWS, uni, tab,
                           ["and", ["leaf", 0], ["leaf", 1]], pairs16),
             *wide_shared_cases(SLICES, device, seed)]
    rows = measure(cases, 50, plain_reps=0)
    del cases, pool, uni, tab
    torch.cuda.empty_cache()
    rows.update(k1_sweep(device, seed, 50, plain_reps=0))
    rows.update(measure(k6_cases(device, seed), 50, plain_reps=0))
    rows.update(k3_sweep(device, seed, 50, plain_reps=0))
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    pool = torch.randint(-2**31, 2**31, (SLICES, K7_CAP, 2048),
                         dtype=torch.int32, device=device, generator=gen)
    rows.update(k7_sweep(pool, device, seed))
    print(json.dumps({"kernel_times_of": str(root), "card": smi,
                      "rows": rows, "ptxas": ptxas}), flush=True)
    return 0


def save_ptxas(build_dir: Path, tag: str) -> dict:
    """Copies the build's ptxas reports (nvcc -Xptxas -v, one log per
    library) to chiprun_out/ptxas/<tag>/ and returns each library's
    lines on registers, stack, spills and shared memory."""
    out = REPO / "chiprun_out" / "ptxas" / tag
    out.mkdir(parents=True, exist_ok=True)
    summary = {}
    for path in sorted(Path(build_dir).glob("*.log")):
        text = path.read_text(errors="replace")
        (out / path.name).write_text(text)
        summary[path.name.rsplit("-", 1)[0]] = [
            line.split("info    :")[-1].strip()
            for line in text.splitlines()
            if "registers" in line or "stack frame" in line
            or "Compiling entry" in line]
    return summary


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
    ap.add_argument("--sparse-qps-of", metavar="ROOT", type=Path,
                    help="run only phase 6, served by the package under "
                         "ROOT, and print its QPS as one JSON line")
    ap.add_argument("--kernel-times-of", metavar="ROOT", type=Path,
                    help="run only the timed shapes of K4, K2, K1's and "
                         "K3's slice sweeps, K6 and K7's sweep (with the "
                         "scattered-sector probe) with the kernels of the "
                         "package under ROOT, and print their times and "
                         "ptxas report as one JSON line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    root = (args.dense_qps_of or args.lone_latency_of or args.sparse_qps_of
            or args.kernel_times_of or REPO).resolve()
    sys.path.insert(0, str(root))
    from pilosa_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # Every fragment holds two file descriptors, and the holders of the
    # phases hold ~10,000 fragments at once.
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    log(f"open files: limit {soft}, raised to {hard}")

    t0 = time.monotonic()
    cuda_build.build_all()
    build_s = dict(cuda_build.BUILD_SECONDS)
    log(f"build: {len(build_s)} libraries in "
        f"{time.monotonic() - t0:.2f} s {json.dumps(build_s)}")
    ptxas = save_ptxas(cuda_build.build_dir(), root.name)
    for name in ("sparse_pair_count", "coarse_count_shared", "coarse_count",
                 "coarse_count_blocked", "tree_count", "apply_writes"):
        log(f"ptxas {name}: {' | '.join(ptxas.get(name, []))}")
    if args.dense_qps_of:
        return dense_qps_only(root, card, smi, args.seed)
    if args.lone_latency_of:
        return lone_latency_only(root, smi, args.seed)
    if args.sparse_qps_of:
        return sparse_qps_only(root, card, smi, args.seed)
    if args.kernel_times_of:
        return kernel_times_only(root, smi, args.seed, ptxas)
    from pilosa_tpu_torch.ops import kernels as tk

    for name in ("coarse_count", "coarse_count_blocked", "tree_count"):
        spills = [line for line in ptxas.get(name, []) if "spill" in line]
        check(spills and all("0 bytes spill stores, 0 bytes spill loads"
                             in line for line in spills),
              f"ptxas reports no spill in {name}: {spills}")
    check(tk.probe_ok(torch.device("cuda")), "K0 canary")
    log("K0 canary: ok")

    device = torch.device("cuda")
    t0 = time.monotonic()
    words = make_words(SLICES, args.seed)
    sp = SparseRows(SLICES, args.seed)
    from pilosa_tpu_torch.core.wal import FSYNC_GROUP, WalConfig

    phase_s = {}
    t_lap = [time.monotonic()]

    def done(phase: str) -> None:
        """Log and keep the seconds since the previous phase ended."""
        now = time.monotonic()
        phase_s[phase], t_lap[0] = now - t_lap[0], now
        log(f"phase {phase}: {phase_s[phase]:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        # The server's default policy: an acknowledged write is durable.
        holder = build_holder(tmp, words, wal=WalConfig(FSYNC_GROUP))
        try:
            add_sparse_frames(holder, words, sp)
            log(f"data: {SLICES} slices ({SLICES << 20} columns) in "
                f"{time.monotonic() - t0:.2f} s")
            done("data")
            kern = kernel_phase(holder, words, device, args.seed)
            done("kernels")
            sl = slice_phase(holder, words, card, device)
            done("dense")
            kern["sparse_pair_count"] = sparse_kernel_phase(holder, sp,
                                                            device)
            sps = sparse_phase(holder, words, sp, card, device)
            done("sparse")
            res = residency_phase(holder, words, sp, card, device)
            done("residency")
            truth = BsiTruth(SLICES, args.seed, words)
            gen_s = add_bsi_field(holder, truth)
            log(f"bsi data: {SLICES} slices of field {BSI_FIELD} made, "
                f"packed and injected in {gen_s:.2f} s")
            kern.update(bsi_kernel_phase(holder, truth, device, args.seed))
            bsi = bsi_phase(holder, truth, card, device)
            bsi["data_s"] = gen_s
            done("bsi")
            ttruth = TimeTruth(TIME_SLICES, args.seed)
            gen_s = add_time_index(holder, ttruth)
            gc.collect()
            log(f"time data: {TIME_SLICES} slices x {TIME_DAYS} days of "
                f"{TIME_ROWS} rows made and injected in {gen_s:.2f} s")
            tq = time_phase(holder, ttruth, card, device)
            tq["data_s"] = gen_s
            kern.update(tq["kernels"])
            done("time")
            ntruth = TopnTruth(TOPN_SLICES, args.seed)
            gen_s = add_topn_index(holder, ntruth)
            gc.collect()
            log(f"topn data: {TOPN_SLICES} slices of {TOPN_ROWS} rows made "
                f"and injected in {gen_s:.2f} s")
            topn = topn_phase(holder, words, ntruth, card, device)
            topn["data_s"] = gen_s
            kern.update(topn["kernels"])
            done("topn")
            gc.collect()
            writes = write_phase(holder, words, card, device, args.seed)
            kern.update(writes["kernels"])
            done("writes")
            gc.collect()
            dur = durability_phase(holder, words, sp, truth, tmp, root, card,
                                   device, args.seed)
            kern.update(dur["kernels"])
            done("durability")
            gc.collect()
            bulk = bulk_phase(holder, words, sp, tmp, card, device,
                              args.seed)
            kern.update(bulk["kernels"])
            done("bulk")
            gc.collect()
            node = config_phase(words, tmp, root, card, args.seed, sl)
            done("config")
            gc.collect()
            adm = admission_phase(words, tmp, root, card, args.seed, sl)
            done("admission")
        finally:
            holder.close()
    probes = probe_phase(device, args.seed)
    kern.update(probes["kernels"])
    done("probes")
    log("phase seconds "
        f"{json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")

    # Each kernel's launches: the sum over the serving paths, each counted
    # from 0 just before it was driven; K6 and the stream serve only the
    # probe path, whose own loops the other kernels' counts leave out.
    paths = {"dense": sl, "sparse": sps, "residency": res, "bsi": bsi,
             "time": tq, "topn": topn, "writes": writes, "durability": dur,
             "bulk": bulk, "config": node, "admission": adm,
             "probes": probes}
    for name, r in paths.items():
        if name not in ("residency", "probes"):
            no_fallback(f"{name} phase", r.get("mesh_stats", r["stats"]))
    by_path = {k: {p: r["launches"][k] for p, r in paths.items()}
               for k in KERNELS}
    launches = {k: sum(n for p, n in by_path[k].items()
                       if (p == "probes") == (k in PROBE_ONLY))
                for k in KERNELS}
    entries = []
    for name, (source, replaces) in KERNELS.items():
        rows = {w: r for w, r in kern.items() if r["kernel"] == name}
        main_row = next(iter(rows.values()))
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": by_path[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": main_row["ms"], "device_ms": main_row.get("device_ms"),
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row.get("library_ms")})
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "slices": SLICES,
         "seed": args.seed, "build_s": build_s, "ptxas": ptxas,
         "wrappers": kern, "slice": sl, "sparse_slice": sps,
         "residency": res,
         "bsi_slice": bsi, "time_slice": tq, "topn_slice": topn,
         "write_slice": writes, "durability": dur, "bulk": bulk,
         "config_node": node, "admission": adm, "probes": probes,
         "phase_seconds": phase_s,
         "kernels": entries}, indent=1))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
