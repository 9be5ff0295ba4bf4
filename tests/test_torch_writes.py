"""Writes into the staged image: the port's write scatter (K7's plain
version, the host planner, the refresh path and its cost gate) against
the JAX package's.

On inputs made once with numpy from fixed seeds: the log fold, the
per-slice planner (its KeyError included), the padding and the (S, B)
batches equal the JAX package's; K7's plain version equals the JAX
package's scatter_words; the JAX package's incremental-write and
measured-gate cases run through both managers with equal answers and
equal stats; a log pruned past its limit restages; the layouts and the
row table survive a scatter and go with a restage; and a seeded stream
of writes mixed with Count, Range, Sum and TopN answers the same
through both executors, with the same restages and scatters, at
sparse-density thresholds 0 and 0.05. Exact throughout: these are bits
and integer counts.
"""

import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.bsi import FieldSchema as JaxSchema
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.ops import pool as jpool
from pilosa_tpu.parallel import mesh as jmesh
from pilosa_tpu.parallel.plan import _lower_tree as jax_lower_tree
from pilosa_tpu.parallel.serve import MeshManager as JaxMeshManager
from pilosa_tpu.pql import parse_string as jax_parse

from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.ops import pool as tpool
from pilosa_tpu_torch.parallel import mesh as tmesh
from pilosa_tpu_torch.parallel.plan import _lower_tree
from pilosa_tpu_torch.parallel.serve import MeshManager
from pilosa_tpu_torch.pql import parse_string
from torch_threads import one_torch_thread  # noqa: F401

GATE_STATS = ("stage", "incremental", "refresh_pick_incremental",
              "refresh_pick_restage", "refresh_probe_restage")

JAX = SimpleNamespace(
    name="jax", Holder=JaxHolder, parse=jax_parse, lower=jax_lower_tree,
    manager=JaxMeshManager,
    executor=lambda h, thr=None: JaxExecutor(
        h, use_device=True, device_min_work=0,
        mesh_config=({} if thr is None
                     else {"sparse_density_threshold": thr})))
PORT = SimpleNamespace(
    name="port", Holder=Holder, parse=parse_string, lower=_lower_tree,
    manager=lambda h: MeshManager(h, device="cpu"),
    executor=lambda h, thr=None: Executor(
        h, device="cpu", **({} if thr is None
                            else {"sparse_density_threshold": thr})))


def gate_stats(stats) -> dict:
    d = dict(stats.copy())
    return {k: d.get(k, 0) for k in GATE_STATS}


def both(fn, tmp_path):
    """fn(pkg, path) through each package on its own directory: the two
    results must be equal."""
    got = {pkg.name: fn(pkg, tmp_path / pkg.name) for pkg in (JAX, PORT)}
    assert got["port"] == got["jax"]
    return got["port"]


def open_holder(pkg, path):
    h = pkg.Holder(str(path))
    h.open()
    return h


# -- the host planner -----------------------------------------------------------


def random_log(rng, n: int, rows: int = 4):
    """(op, pos, churn) entries over a few rows and containers, with
    repeats, so the fold has sets and clears of one bit to order."""
    pos = (rng.integers(0, rows, n) * SLICE_WIDTH
           + rng.integers(0, 3, n) * 65536 + rng.integers(0, 96, n))
    return [(int(op), int(p), bool(c)) for op, p, c in zip(
        rng.integers(0, 2, n), pos, rng.random(n) < 0.1)]


@pytest.mark.parametrize("seed", range(4))
def test_fold_log_entries_matches_jax(seed):
    entries = random_log(np.random.default_rng(seed), 300)
    got, want = tpool.fold_log_entries(entries), jpool.fold_log_entries(
        entries)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert tpool.fold_log_entries([])[0].shape == (0,)


def pool_keys_for(rng, row_ids, cap: int):
    """A sorted, INVALID_KEY-padded key row over some of each row's 16
    sub-keys."""
    keys = sorted(int(d) * 16 + int(b) for d in range(len(row_ids))
                  for b in rng.choice(16, size=6, replace=False))
    out = np.full(cap, tpool.INVALID_KEY, dtype=np.int32)
    out[:len(keys)] = keys
    return out


@pytest.mark.parametrize("seed", range(4))
def test_plan_slice_mutations_matches_jax(seed):
    rng = np.random.default_rng(seed)
    row_ids = np.array([0, 3, 7, 1 << 40], dtype=np.uint64)
    keys = pool_keys_for(rng, row_ids, 32)
    present = keys[keys != tpool.INVALID_KEY]
    key = rng.choice(present, size=200)
    pos = (row_ids[key // 16] * np.uint64(SLICE_WIDTH)
           + (key % 16).astype(np.uint64) * np.uint64(65536)
           + rng.integers(0, 200, 200).astype(np.uint64))
    val = rng.random(200) < 0.6
    # Clears of absent containers and absent rows drop in both.
    pos = np.concatenate([pos, np.array(
        [5 * SLICE_WIDTH + 1, int(row_ids[1]) * SLICE_WIDTH + 15 * 65536],
        dtype=np.uint64)])
    val = np.concatenate([val, [False, False]])
    if 15 in (present[(present // 16) == 1] % 16):
        val[-1] = True  # still present: a set is as good
    fpos, fval = tpool.fold_log_entries(
        [(0 if v else 1, int(p), False) for p, v in zip(pos, val)])
    got = tpool.plan_slice_mutations(keys, row_ids, fpos, fval)
    want = jpool.plan_slice_mutations(keys, row_ids, fpos, fval)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(np.unique(got[0].astype(np.int64) * 2048 + got[1])) == len(
        got[0])  # unique targets


@pytest.mark.parametrize("where", ["absent container", "absent row",
                                   "empty table"])
def test_plan_refuses_a_set_into_an_absent_container(where):
    rng = np.random.default_rng(9)
    row_ids = np.array([2, 4], dtype=np.uint64)
    keys = pool_keys_for(rng, row_ids, 16)
    missing = next(b for b in range(16) if 16 + b not in keys)
    pos = {"absent container": 4 * SLICE_WIDTH + missing * 65536 + 3,
           "absent row": 9 * SLICE_WIDTH + 3,
           "empty table": 2 * SLICE_WIDTH}[where]
    if where == "empty table":
        row_ids = np.zeros(0, dtype=np.uint64)
    args = (keys, row_ids, np.array([pos], dtype=np.uint64),
            np.array([True]))
    for planner in (tpool.plan_slice_mutations, jpool.plan_slice_mutations):
        with pytest.raises(KeyError):
            planner(*args)
    # The clear of the same bit plans to nothing in both.
    args = args[:3] + (np.array([False]),)
    for got, want in zip(tpool.plan_slice_mutations(*args),
                         jpool.plan_slice_mutations(*args)):
        assert got.shape == want.shape == (0,)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100, 1024, 1025])
def test_padding_matches_jax(n):
    assert tpool.mutation_batch_width(n) == jpool.mutation_batch_width(n)
    rng = np.random.default_rng(n)
    plan = (rng.integers(0, 40, n).astype(np.int32),
            rng.integers(0, 2048, n).astype(np.int32),
            rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32))
    for width in (None, tpool.mutation_batch_width(n) * 2):
        got = tpool.pad_mutation_plan(plan, 48, width)
        want = jpool.pad_mutation_plan(plan, 48, width)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("seed", range(3))
def test_pack_mutation_batches_matches_jax(seed):
    rng = np.random.default_rng(seed)
    per_slice = {}
    for s in rng.choice(6, size=3, replace=False):
        n = int(rng.integers(1, 40))
        per_slice[int(s)] = (
            rng.integers(0, 32, n).astype(np.int32),
            rng.integers(0, 2048, n).astype(np.int32),
            rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32))
    got = tmesh.pack_mutation_batches(per_slice, 6, 32)
    want = jmesh.pack_mutation_batches(per_slice, 6, 32)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    empty = tmesh.pack_mutation_batches({}, 2, 16)
    assert all(np.array_equal(g, w) for g, w in zip(
        empty, jmesh.pack_mutation_batches({}, 2, 16)))


# -- K7's plain version -------------------------------------------------------


def scatter_inputs(seed: int, s: int, cap: int, b: int, live: int):
    """A random pool and (S, B) batches: `live` unique targets a slice,
    one word both set and cleared, the rest padding at slot = cap."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(s, cap, 2048),
                         dtype=np.uint64).astype(np.uint32)
    slot = np.full((s, b), cap, dtype=np.int32)
    word = np.zeros((s, b), dtype=np.int32)
    sm = np.zeros((s, b), dtype=np.uint32)
    cm = np.zeros((s, b), dtype=np.uint32)
    for si in range(s):
        flat = rng.choice(cap * 2048, size=live, replace=False)
        slot[si, :live], word[si, :live] = flat // 2048, flat % 2048
        sm[si, :live] = rng.integers(0, 2**32, live, dtype=np.uint64)
        cm[si, :live] = rng.integers(0, 2**32, live, dtype=np.uint64)
    sm[0, 0], cm[0, 0] = 0x0000FFFF, 0xFFFF0000  # set and cleared
    return words, slot, word, sm, cm


def as_t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


@pytest.mark.parametrize("s,cap,b,live", [(1, 16, 8, 3), (3, 32, 64, 40),
                                          (4, 16, 16, 16)])
def test_scatter_plain_matches_jax(s, cap, b, live):
    words, slot, word, sm, cm = scatter_inputs(s * cap + b, s, cap, b, live)
    want = np.stack([np.asarray(jpool.scatter_words(
        jnp.asarray(words[si]), jnp.asarray(slot[si]), jnp.asarray(word[si]),
        jnp.asarray(sm[si]), jnp.asarray(cm[si]))) for si in range(s)])
    pool = as_t(words)
    out = tk.scatter_words(pool, as_t(slot), as_t(word), as_t(sm), as_t(cm))
    assert out is pool  # in place
    assert np.array_equal(pool.numpy().view(np.uint32), want)
    # One slice's pool with (B,) batches: the Pallas-free contract of the
    # JAX package's ops/pool.scatter_words itself.
    one = as_t(words[0])
    tk.scatter_words(one, as_t(slot[0]), as_t(word[0]), as_t(sm[0]),
                     as_t(cm[0]))
    assert np.array_equal(one.numpy().view(np.uint32), want[0])


def test_apply_writes_scatters_the_packed_batches():
    words, slot, word, sm, cm = scatter_inputs(5, 2, 16, 32, 20)
    staged = tmesh.ShardedIndex(words=as_t(words),
                                keys_host=np.zeros((2, 16), np.int32),
                                row_ids=np.zeros(0, np.uint64))
    out = tmesh.apply_writes(staged, slot, word, sm, cm)
    want = np.stack([np.asarray(jpool.scatter_words(
        jnp.asarray(words[si]), jnp.asarray(slot[si]), jnp.asarray(word[si]),
        jnp.asarray(sm[si]), jnp.asarray(cm[si]))) for si in range(2)])
    assert out is staged
    assert np.array_equal(staged.words.numpy().view(np.uint32), want)


def test_scatter_words_refuses_bad_shapes():
    pool = torch.zeros((2, 16, 2048), dtype=torch.int32)
    ok = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.scatter_words(pool, ok, ok, ok, torch.zeros((2, 9),
                                                       dtype=torch.int32))
    with pytest.raises(ValueError):
        tk.scatter_words(pool, ok.to(torch.int64), ok, ok, ok)
    with pytest.raises(ValueError):
        tk.scatter_words(pool[:, :, :1024], ok, ok, ok, ok)


# -- the JAX package's incremental-write cases, through both managers ---------


def seed_frame(pkg, path, bits, frame="general"):
    h = open_holder(pkg, path)
    f = h.create_index_if_not_exists("i").create_frame_if_not_exists(frame)
    for row, col in bits:
        f.set_bit(row, col)
    return h, f


def q(pkg, ex, pql):
    return ex.execute("i", pkg.parse(pql))


PAIR = "Count(Intersect(Bitmap(rowID=10), Bitmap(rowID=11)))"


def test_writes_apply_without_restage(tmp_path):
    def run(pkg, path):
        h, f = seed_frame(pkg, path, [(10, c) for c in range(64)]
                          + [(11, c) for c in range(0, 64, 2)])
        try:
            ex = pkg.executor(h)
            out = [q(pkg, ex, PAIR)]
            mgr = ex.mesh_manager()
            out.append(gate_stats(mgr.stats))
            for c in range(64, 96):  # into existing containers
                f.set_bit(10, c)
                f.set_bit(11, c)
            out += [q(pkg, ex, PAIR), gate_stats(mgr.stats)]
            f.clear_bit(10, 0)
            out += [q(pkg, ex, PAIR), gate_stats(mgr.stats)]
            return out
        finally:
            h.close()

    out = both(run, tmp_path)
    assert out[0] == [32] and out[2] == [64] and out[4] == [63]
    assert out[5]["stage"] == 1 and out[5]["incremental"] == 2


@pytest.mark.parametrize("case", ["container churn", "emptied container",
                                  "new slice", "set then clear"])
def test_incremental_write_cases(tmp_path, case):
    seeds = {"container churn": [(10, 0), (11, 0)],
             "emptied container": [(10, 0), (10, 70000), (11, 0)],
             "new slice": [(10, 0)],
             "set then clear": [(10, c) for c in range(8)]}[case]

    def run(pkg, path):
        h, f = seed_frame(pkg, path, seeds)
        try:
            ex = pkg.executor(h)
            out = [q(pkg, ex, "Count(Bitmap(rowID=10))")]
            if case == "container churn":
                f.set_bit(99, 5)  # a new row: a new container
                out.append(q(pkg, ex, "Count(Bitmap(rowID=99))"))
            elif case == "emptied container":
                f.clear_bit(10, 70000)  # its container's last bit
                out.append(q(pkg, ex, "Count(Bitmap(rowID=10))"))
            elif case == "new slice":
                f.set_bit(10, 3 * SLICE_WIDTH + 1)
                out.append(q(pkg, ex, "Count(Bitmap(rowID=10))"))
            else:
                f.set_bit(10, 9)
                f.clear_bit(10, 9)   # one word set then cleared
                f.clear_bit(10, 0)
                f.set_bit(10, 0)     # one word cleared then set
                out.append(q(pkg, ex, "Count(Bitmap(rowID=10))"))
            return out + [gate_stats(ex.mesh_manager().stats)]
        finally:
            h.close()

    out = both(run, tmp_path)
    want = {"container churn": ([1], [1], 2, 0),
            "emptied container": ([2], [1], 2, 0),
            "new slice": ([1], [2], 2, 0),
            "set then clear": ([8], [8], 1, 1)}[case]
    assert (out[0], out[1], out[2]["stage"], out[2]["incremental"]) == want


# -- the measured cost gate, through both managers ----------------------------


def gate_setup(pkg, path, frames=("g",)):
    h = open_holder(pkg, path)
    idx = h.create_index_if_not_exists("i")
    for name in frames:
        f = idx.create_frame_if_not_exists(name)
        for s in range(2):
            f.set_bit(1, s * SLICE_WIDTH + 3)
    mgr = pkg.manager(h)
    return h, mgr


def settle(sv):
    """Wait for the staging's measurement (the JAX package's lands on a
    worker; the port's, on the CPU, at once)."""
    import time

    if hasattr(sv.sharded.words, "block_until_ready"):
        sv.sharded.words.block_until_ready()
    for _ in range(200):
        if sv.last_stage_s is not None:
            return
        time.sleep(0.01)
    raise AssertionError("the staging was never measured")


def count_rows(pkg, h, mgr, pql="Count(Bitmap(frame=g, rowID=1))"):
    tree = pkg.parse(pql).calls[0].children[0]
    leaves = []
    shape = pkg.lower(h, "i", tree, leaves)
    return mgr.count("i", shape, leaves, [0, 1], 2)


def test_restage_picked_when_cheaper(tmp_path):
    def run(pkg, path):
        h, mgr = gate_setup(pkg, path)
        try:
            sv = mgr.refresh("i", "g", "standard", 2)
            settle(sv)
            sv.last_stage_s = 1e-4   # staging declared cheap,
            sv.inc_ewma_s = 10.0     # scattering dear
            h.frame("i", "g").set_bit(1, 7)
            mgr.refresh("i", "g", "standard", 2)
            sv2 = mgr._views[("i", "g", "standard")]
            # The estimate decays on the gate's restage and carries over.
            return (gate_stats(mgr.stats), sv2 is not sv, sv2.inc_ewma_s,
                    count_rows(pkg, h, mgr))
        finally:
            h.close()

    stats, fresh, ewma, n = both(run, tmp_path)
    assert stats["stage"] == 2 and stats["refresh_pick_restage"] == 1
    assert fresh and ewma == pytest.approx(9.0) and n == 3


def test_incremental_picked_when_cheaper(tmp_path):
    def run(pkg, path):
        h, mgr = gate_setup(pkg, path)
        try:
            sv = mgr.refresh("i", "g", "standard", 2)
            settle(sv)
            sv.last_stage_s = 10.0   # staging declared dear
            sv.inc_ewma_s = 0.001
            h.frame("i", "g").set_bit(1, 7)
            mgr.refresh("i", "g", "standard", 2)
            return gate_stats(mgr.stats), count_rows(pkg, h, mgr)
        finally:
            h.close()

    stats, n = both(run, tmp_path)
    assert stats["incremental"] == stats["refresh_pick_incremental"] == 1
    assert stats["stage"] == 1 and n == 3


def test_probe_restage_reexplores_stale_stage_cost(tmp_path):
    def run(pkg, path):
        h, mgr = gate_setup(pkg, path)
        try:
            sv = mgr.refresh("i", "g", "standard", 2)
            settle(sv)
            sv.last_stage_s = 0.001
            sv.inc_spend_s = 0.5     # > 20 x the staging
            sv.inc_ewma_s = 1e-6     # the plain rule would scatter
            h.frame("i", "g").set_bit(1, 7)
            mgr.refresh("i", "g", "standard", 2)
            sv2 = mgr._views[("i", "g", "standard")]
            # The probe starts the spend afresh and leaves the estimate.
            return (gate_stats(mgr.stats), sv2.inc_spend_s, sv2.inc_ewma_s,
                    count_rows(pkg, h, mgr))
        finally:
            h.close()

    stats, spend, ewma, n = both(run, tmp_path)
    assert stats["stage"] == 2 and stats["refresh_probe_restage"] == 1
    assert spend == 0.0 and ewma == 1e-6 and n == 3


def test_gate_is_per_view(tmp_path):
    def run(pkg, path):
        h, mgr = gate_setup(pkg, path, frames=("small", "large"))
        try:
            svs = mgr.refresh("i", "small", "standard", 2)
            svl = mgr.refresh("i", "large", "standard", 2)
            settle(svs)
            settle(svl)
            mgr._inc_ewma_s = 10.0   # another view's dear scatters
            svs.inc_ewma_s = 10.0
            svl.inc_ewma_s = None    # none of this view's own yet
            svl.last_stage_s = 1.0
            h.frame("i", "large").set_bit(1, 7)
            mgr.refresh("i", "large", "standard", 2)
            return gate_stats(mgr.stats)
        finally:
            h.close()

    stats = both(run, tmp_path)
    assert stats["stage"] == 2 and stats["refresh_pick_incremental"] == 1


# -- the log's reach, and what a scatter keeps ---------------------------------


@pytest.mark.parametrize("writes,restaged", [(8192, False), (8193, True)])
def test_log_pruned_past_its_limit_restages(tmp_path, writes, restaged):
    def run(pkg, path):
        h, f = seed_frame(pkg, path, [(1, 3), (1, 4)], frame="g")
        try:
            ex = pkg.executor(h)
            pql = "Count(Bitmap(frame=g, rowID=1))"
            out = [q(pkg, ex, pql)]
            for _ in range(writes - 1):
                f.set_bit(1, 3)  # logged although it changes nothing
            f.set_bit(1, 5)
            return out + [q(pkg, ex, pql), gate_stats(ex.mesh_manager().stats)]
        finally:
            h.close()

    before, after, stats = both(run, tmp_path)
    assert before == [2] and after == [3]
    assert (stats["stage"], stats["incremental"]) == (
        (2, 0) if restaged else (1, 1))


def test_layouts_survive_a_scatter_and_go_with_a_restage(tmp_path):
    """A view's leaf layouts, its row table and its rows' container
    indexes survive a scatter and go with a restage. Rows 1 and 2 hold
    one container of slice 0 (row 2 one of slice 1 too), not whole runs,
    so K3 counts them through their container indexes, kept on the card
    with the view (StagedView.index_row, kernels.tree_count_rows): after
    a scatter it reads the same indexes over the written words, and after
    a restage indexes built from the new keys."""
    h, f = seed_frame(PORT, tmp_path, [(1, c) for c in range(0, 600, 3)]
                      + [(2, c) for c in range(0, 600, 2)]
                      + [(2, SLICE_WIDTH + 9)], frame="g")
    try:
        ex = Executor(h, device="cpu")
        mgr = ex.mesh_manager()
        pql = "Count(Intersect(Bitmap(frame=g, rowID=1), " \
              "Bitmap(frame=g, rowID=2)))"
        assert q(PORT, ex, pql) == [100]
        assert mgr.stats["kernel:tree_count_rows"] == 1
        sv = mgr._views[("i", "g", "standard")]
        rows = dict(sv.index_rows)
        # K3 keeps its two rows' indexes, not the view's whole table.
        assert len(rows) == 2 and sv.rows_dev is None
        assert ex.execute("i", parse_string("TopN(frame=g, n=2)"))[0] == [
            (2, 301), (1, 200)]
        layouts, table = dict(sv.layouts), sv.rows_dev
        assert layouts and table is not None
        for dense, idx in rows.items():
            assert torch.equal(idx, table[dense])
        f.set_bit(1, 1)      # existing containers: a scatter
        f.clear_bit(2, 0)
        assert q(PORT, ex, pql) == [99]
        assert mgr.stats["kernel:tree_count_rows"] == 2
        assert ex.execute("i", parse_string("TopN(frame=g, n=2)"))[0] == [
            (2, 300), (1, 201)]
        assert mgr._views[("i", "g", "standard")] is sv
        assert all(sv.layouts[k] is v for k, v in layouts.items())
        assert all(sv.index_rows[k] is v for k, v in rows.items())
        assert sv.rows_dev is table
        assert gate_stats(mgr.stats)["incremental"] == 1
        f.set_bit(7, 5)      # a new row: a restage
        assert q(PORT, ex, "Count(Bitmap(frame=g, rowID=7))") == [1]
        assert mgr.stats["kernel:tree_count_rows"] == 3
        fresh = mgr._views[("i", "g", "standard")]
        seven = fresh.sharded.row_ids.tolist().index(7)
        assert fresh is not sv and fresh.rows_dev is None
        assert set(fresh.layouts) == {seven}
        assert set(fresh.index_rows) == {seven}
        idx = fresh.index_rows[seven]
        assert tuple(idx.shape) == (2, 16) and int(idx[0, 0]) >= 0
        assert (idx[0, 1:] == -1).all() and (idx[1:] == -1).all()
        assert gate_stats(mgr.stats)["stage"] == 2
    finally:
        h.close()


# -- a seeded stream of writes and queries through both executors --------------

STREAM_SLICES = 3
FIELD_MIN, FIELD_MAX = -500, 500


def seed_stream_data(path, seed: int):
    """Frame `general`: rows 0-1 at ~12% fill and rows 2-3 at ~0.5% in
    every container of every slice (dense at either threshold), a BSI
    field `val` over 2,000 columns; frame `sparse`: rows 0-2 at ~0.5%
    (sorted-array at 0.05)."""
    rng = np.random.default_rng(seed)
    h = JaxHolder(str(path))
    h.open()
    try:
        idx = h.create_index_if_not_exists("i")
        g = idx.create_frame_if_not_exists("general")
        sp = idx.create_frame_if_not_exists("sparse")
        rows, cols = [], []
        for r, per in ((0, 8000), (1, 8000), (2, 300), (3, 300)):
            for s in range(STREAM_SLICES):
                for b in range(16):
                    c = rng.choice(65536, size=per, replace=False)
                    rows.append(np.full(per, r))
                    cols.append(s * SLICE_WIDTH + b * 65536 + c)
        g.import_bits(np.concatenate(rows), np.concatenate(cols))
        rows, cols = [], []
        for r in range(3):
            c = rng.choice(STREAM_SLICES * SLICE_WIDTH, size=15000,
                           replace=False)
            rows.append(np.full(c.size, r))
            cols.append(c)
        sp.import_bits(np.concatenate(rows), np.concatenate(cols))
        g.create_field_if_not_exists(JaxSchema("val", FIELD_MIN, FIELD_MAX))
        vcols = rng.choice(STREAM_SLICES * SLICE_WIDTH, size=2000,
                           replace=False)
        for c, v in zip(vcols, rng.integers(FIELD_MIN, FIELD_MAX + 1, 2000)):
            g.set_value("val", int(c), int(v))
    finally:
        h.close()


def stream_ops(seed: int, n: int = 120) -> list:
    """Writes (most into existing containers, a few that churn) mixed
    with the queries that read them."""
    rng = np.random.default_rng(seed + 100)
    ops = []
    for _ in range(n):
        k = rng.random()
        col = int(rng.integers(0, STREAM_SLICES * SLICE_WIDTH))
        if k < 0.30:
            ops.append(f"SetBit(rowID={int(rng.integers(0, 4))}, "
                       f"frame=general, columnID={col})")
        elif k < 0.45:
            ops.append(f"ClearBit(rowID={int(rng.integers(0, 4))}, "
                       f"frame=general, columnID={col})")
        elif k < 0.50:
            ops.append(f"SetBit(rowID={int(rng.integers(0, 3))}, "
                       f"frame=sparse, columnID={col})")
        elif k < 0.53:
            ops.append(f"SetBit(rowID={int(rng.integers(20, 23))}, "
                       f"frame=general, columnID={col})")  # churn
        elif k < 0.58:
            ops.append(f"SetValue(frame=general, columnID={col}, "
                       f"val={int(rng.integers(FIELD_MIN, FIELD_MAX))})")
        elif k < 0.72:
            a, b = rng.choice(4, size=2, replace=False)
            op = ("Intersect", "Union", "Difference")[int(rng.integers(3))]
            ops.append(f"Count({op}(Bitmap(rowID={a}, frame=general), "
                       f"Bitmap(rowID={b}, frame=general)))")
        elif k < 0.78:
            a, b = rng.choice(3, size=2, replace=False)
            ops.append(f"Count(Intersect(Bitmap(rowID={a}, frame=sparse), "
                       f"Bitmap(rowID={b}, frame=sparse)))")
        elif k < 0.85:
            c = int(rng.integers(FIELD_MIN, FIELD_MAX))
            ops.append(f"Count(Range(frame=general, val > {c}))")
        elif k < 0.92:
            ops.append('Sum(frame=general, field="val")')
        else:
            ops.append(f"TopN(frame=general, n={int(rng.integers(1, 6))})")
    return ops


def as_plain(result):
    if hasattr(result, "columns"):
        return ("row", [int(c) for c in result.columns()])
    if isinstance(result, list):
        return [tuple(int(x) for x in p) for p in result]
    return result


@pytest.fixture(scope="module")
def stream_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("writes_stream")
    seed_stream_data(base / "seed", 11)
    return base


@pytest.mark.parametrize("threshold", [0.0, 0.05], ids=["dense", "sparse"])
def test_write_stream_matches_jax(stream_dir, tmp_path, threshold,
                                  monkeypatch):
    """Measured timings differ between the packages, so the measurements
    are switched off in both: the gate then always scatters, and every
    restage comes from the data (churn, sorted-array views, a new
    fragment) alone, which both must see alike."""
    for mgr_cls in (JaxMeshManager, MeshManager):
        monkeypatch.setattr(mgr_cls, "_measure_async",
                            lambda self, *a, **k: None)
    ops = stream_ops(int(threshold * 100))

    def run(pkg, path):
        shutil.copytree(stream_dir / "seed", path)
        h = open_holder(pkg, path)
        try:
            ex = pkg.executor(h, threshold)
            out = [as_plain(ex.execute("i", pkg.parse(op))[0]) for op in ops]
            return out, gate_stats(ex.mesh_manager().stats)
        finally:
            h.close()

    out, stats = both(run, tmp_path)
    assert stats["incremental"] > 0 and stats["stage"] > 1
    if threshold:
        assert stats["refresh_pick_restage"] > 0  # the sorted-array frame
