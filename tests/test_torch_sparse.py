"""The port's sorted-array ("sparse") Count path against the JAX package.

Every function is held exactly (tolerance 0: counts are integers) against
its JAX counterpart on the same numpy inputs made from a seed: the pair
counts (the Pallas kernel in interpret mode and the XLA gather ladder),
the array x bitmap probe, the inclusion-exclusion identities, the format
pick, the sorted-array staging, counts over pools staged by the JAX
package, and the served queries of a holder written by pilosa_tpu, with
both executors at the default density threshold of 0.05.
"""

import functools

import numpy as np
import pytest
import torch

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.ops import bitops as jb
from pilosa_tpu.ops import kernels as jk
from pilosa_tpu.parallel import mesh as jm
from pilosa_tpu.pql import parse_string as jax_parse
from pilosa_tpu.roaring import Bitmap as JaxBitmap

from pilosa_tpu_torch.api.server import THRESHOLD_ENV, parse_args, serve
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import bitops as tb
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.ops.pool import pack_bitmap, pack_sparse
from pilosa_tpu_torch.parallel import mesh as tm
from pilosa_tpu_torch.pql import parse_string
from pilosa_tpu_torch.roaring import Bitmap
from torch_threads import one_torch_thread  # noqa: F401

# Every container boundary of the roaring array form (as in
# tests/test_sparse_format.py): empty, singletons at both edges and at
# the pad value 65535, full 4096-value containers, both edges at once.
BOUNDARY_CONTAINERS = [
    [],
    [0],
    [65535],
    [7],
    list(range(4096)),
    list(range(0, 65536, 16)),
    list(range(61440, 65536)),
    [0, 1, 2, 3, 65532, 65533, 65534, 65535],
    list(range(100, 200)),
]


def pad_pool(arrays, k=None):
    """(N, K) int32 values padded with 0xFFFF + (N,) lengths."""
    if k is None:
        k = max((len(a) for a in arrays), default=1)
        k = max(8, -(-k // 8) * 8)
    vals = np.full((len(arrays), k), 0xFFFF, dtype=np.int32)
    lens = np.zeros(len(arrays), dtype=np.int32)
    for i, a in enumerate(arrays):
        a = np.asarray(sorted(a), dtype=np.int32)
        vals[i, :len(a)] = a
        lens[i] = len(a)
    return vals, lens


def tt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def host_inter(a, b) -> int:
    return len(set(map(int, a)) & set(map(int, b)))


@functools.lru_cache(maxsize=None)
def boundary_case():
    """Every boundary container (plus random ones) against every other,
    with the JAX answers: (a_vals, a_len, b_vals, b_len, host, pallas,
    xla)."""
    rng = np.random.default_rng(3)
    cs = list(BOUNDARY_CONTAINERS) + [
        sorted(rng.choice(65536, size=n, replace=False))
        for n in (1, 100, 2048, 4096)]
    a_list = [a for a in cs for _ in cs]
    b_list = [b for _ in cs for b in cs]
    a_vals, a_len = pad_pool(a_list)
    b_vals, b_len = pad_pool(b_list)
    host = np.array([host_inter(a, b) for a, b in zip(a_list, b_list)])
    pallas = np.asarray(jk.pallas_sparse_pair_counts(
        a_vals, a_len, b_vals, b_len, interpret=True))
    xla = np.asarray(jb.sparse_pair_intersect_counts(a_vals, a_len, b_vals,
                                                     b_len))
    return a_vals, a_len, b_vals, b_len, host, pallas, xla


PAIR_FNS = {"pallas_sparse_pair_counts": tk.pallas_sparse_pair_counts,
            "sparse_pair_intersect_counts": tb.sparse_pair_intersect_counts}


# -- 1. the pair count, the probe and the op identities -----------------------


@pytest.mark.parametrize("name", sorted(PAIR_FNS))
@pytest.mark.parametrize("as_int16", [False, True])
def test_pair_counts_match_jax(name, as_int16):
    a_vals, a_len, b_vals, b_len, host, pallas, xla = boundary_case()
    a, b = tt(a_vals), tt(b_vals)
    if as_int16:  # the pools' dtype: values >= 32768 read negative
        a, b = tb.u16_bits(a), tb.u16_bits(b)
    got = PAIR_FNS[name](a, tt(a_len), b, tt(b_len))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), host)


def test_pad_value_is_not_a_member():
    # 65535 in a against b whose only 65535 is padding, and the reverse.
    a_vals, a_len = pad_pool([[65535], [3, 65535], [3]], k=8)
    b_vals, b_len = pad_pool([[3], [65535], [3, 65535]], k=8)
    want = np.asarray(jk.pallas_sparse_pair_counts(a_vals, a_len, b_vals,
                                                   b_len, interpret=True))
    np.testing.assert_array_equal(want, [0, 1, 1])
    for fn in PAIR_FNS.values():
        got = fn(tt(a_vals), tt(a_len), tt(b_vals), tt(b_len))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(PAIR_FNS))
def test_pair_asymmetric_value_caps(name):
    rng = np.random.default_rng(5)
    a_list = [sorted(rng.choice(65536, size=n, replace=False))
              for n in (0, 1, 60, 64)]
    b_list = [sorted(rng.choice(65536, size=n, replace=False))
              for n in (4096, 3000, 1, 0)]
    a_vals, a_len = pad_pool(a_list, k=64)
    b_vals, b_len = pad_pool(b_list, k=4096)
    want = np.asarray(jk.pallas_sparse_pair_counts(
        a_vals, a_len, b_vals, b_len, interpret=True))
    np.testing.assert_array_equal(
        want, [host_inter(a, b) for a, b in zip(a_list, b_list)])
    got = PAIR_FNS[name](tt(a_vals), tt(a_len), tt(b_vals), tt(b_len))
    np.testing.assert_array_equal(got.numpy(), want)


def test_flat_contract_keeps_leading_shape():
    a_vals, a_len, b_vals, b_len, _, pallas, _ = boundary_case()
    n = (len(a_len) // 13) * 13
    shape = (13, n // 13)
    got = tk.pallas_sparse_pair_counts(
        tt(a_vals[:n].reshape(shape + (-1,))), tt(a_len[:n].reshape(shape)),
        tt(b_vals[:n].reshape(shape + (-1,))), tt(b_len[:n].reshape(shape)))
    np.testing.assert_array_equal(got.numpy(), pallas[:n].reshape(shape))


def test_probe_matches_jax():
    rng = np.random.default_rng(9)
    a_vals, a_len = pad_pool(BOUNDARY_CONTAINERS)
    words = np.zeros((len(BOUNDARY_CONTAINERS), 2048), dtype=np.uint32)
    for i in range(len(words)):
        bits = rng.choice(65536, size=rng.integers(0, 20000), replace=False)
        np.bitwise_or.at(words[i], bits >> 5,
                         np.uint32(1) << (bits & 31).astype(np.uint32))
    words[4, 2047] = 0xFFFFFFFF  # the word 0xFFFF padding probes
    want = np.asarray(jb.sparse_probe_intersect_counts(a_vals, a_len, words))
    for a in (tt(a_vals), tb.u16_bits(tt(a_vals))):
        got = tb.sparse_probe_intersect_counts(a, tt(a_len),
                                               tt(words.view(np.int32)))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["and", "or", "andnot", "xor"])
def test_op_counts_match_jax(op):
    rng = np.random.default_rng(13)
    na = rng.integers(0, 4097, size=(6, 16)).astype(np.int32)
    nb = rng.integers(0, 4097, size=(6, 16)).astype(np.int32)
    inter = np.minimum(na, nb) // 2
    want = np.asarray(jb.sparse_op_counts(op, inter, na, nb))
    got = tb.sparse_op_counts(op, tt(inter), tt(na), tt(nb))
    np.testing.assert_array_equal(got.numpy(), want)


def test_op_counts_reject_unknown_op():
    with pytest.raises(ValueError):
        tb.sparse_op_counts("nand", 0, 0, 0)


# -- 2. format pick and staging -----------------------------------------------


@pytest.mark.parametrize("threshold", [-1.0, 0.0, 0.01, 0.05, 0.2])
@pytest.mark.parametrize("with_prev", [False, True])
def test_pick_slice_formats_matches_jax(threshold, with_prev):
    rng = np.random.default_rng(17)
    s = 400
    n = rng.integers(0, 33, size=s)
    mx = rng.integers(0, 6000, size=s)
    total = np.where(n > 0, rng.integers(0, 1 + n * 65536 // 8), 0)
    stats = np.stack([n, total, mx], axis=1).astype(np.int64)
    prev = (rng.random(s - 7) < 0.5).astype(np.uint8) if with_prev else None
    want = jm.pick_slice_formats(stats, threshold, prev=prev)
    got = tm.pick_slice_formats(stats, threshold, prev=prev)
    np.testing.assert_array_equal(got, want)
    if threshold == 0.05:
        assert 0 < want.sum() < s  # the draw reaches both formats


def random_values(rng, slices):
    """Per slice the sorted positions of a few rows: rows 0-2 of a few
    hundred values per container with 65535 at a container edge, row 4
    in slice 0 only, an absent slice 3, and in slice 1 a first container
    of 8000 values (bitmap form, so the slice stages dense)."""
    out = []
    for s in range(slices):
        if s == 3:
            out.append(None)
            continue
        pos = []
        for row in (0, 1, 2, 4) if s == 0 else (0, 1, 2):
            for blk in rng.choice(np.arange(1, 16), size=3, replace=False):
                base = row * SLICE_WIDTH + int(blk) * 65536
                pos.append(base + rng.choice(65536, size=400, replace=False))
            pos.append([row * SLICE_WIDTH + 65535])
        if s == 1:
            pos.append(rng.choice(12000, size=8000, replace=False))
        out.append(np.unique(np.concatenate(pos)).astype(np.uint64))
    return out


def bitmaps_both(values):
    return ([None if v is None else JaxBitmap(v) for v in values],
            [None if v is None else Bitmap(v) for v in values])


def test_slice_format_stats_matches_jax():
    jbms, tbms = bitmaps_both(random_values(np.random.default_rng(19), 5))
    want = jm.slice_format_stats(jbms)
    got = tm.slice_format_stats(tbms)
    # Slice 1 opens with an 8000-value container: the port stops there.
    np.testing.assert_array_equal(np.delete(got, 1, 0), np.delete(want, 1, 0))
    assert got[1, 0] == 1 and got[1, 2] == want[1, 2] > tm.ARRAY_VALUE_CAP
    for thr in (0.05, 0.5):
        for prev in (None, np.ones(5, np.uint8)):
            np.testing.assert_array_equal(
                tm.pick_slice_formats(got, thr, prev=prev),
                jm.pick_slice_formats(want, thr, prev=prev))


def test_build_sparse_sharded_index_matches_jax():
    jbms, tbms = bitmaps_both(random_values(np.random.default_rng(23), 5))
    formats = jm.pick_slice_formats(jm.slice_format_stats(jbms), 0.05)
    np.testing.assert_array_equal(formats, [1, 0, 1, 0, 1])
    j_dense, j_sparse = jm.split_bitmaps_by_format(jbms, formats)
    rid = jm.global_row_ids(jbms)
    j_sp, j_rows, j_keys, j_cards = jm.build_sparse_sharded_index(
        j_sparse, None, row_ids=rid)
    _, _, j_dkeys = jm.build_sharded_index(j_dense, None, with_host_keys=True,
                                           row_ids=rid)

    packed = [None if b is None else (pack_sparse(b) if f else pack_bitmap(b))
              for b, f in zip(tbms, formats)]
    t_dense, t_sparse = tm.split_bitmaps_by_format(packed, formats)
    t_rid = tm.global_row_ids(packed)
    np.testing.assert_array_equal(t_rid, rid)
    sp = tm.build_sparse_sharded_index(t_sparse, "cpu", row_ids=t_rid)
    np.testing.assert_array_equal(sp.keys_host, j_keys)
    np.testing.assert_array_equal(sp.cards_host, j_cards)
    np.testing.assert_array_equal(sp.cards.numpy(), j_cards)
    np.testing.assert_array_equal(sp.values.numpy().view(np.uint16),
                                  np.asarray(j_sp.values))
    np.testing.assert_array_equal(sp.row_ids, j_rows)
    assert tm.sparse_pool_dims(t_sparse) == jm.sparse_pool_dims(j_sparse)
    dense = tm.build_sharded_index(t_dense, "cpu", row_ids=t_rid)
    np.testing.assert_array_equal(dense.keys_host, j_dkeys)


def test_all_sparse_view_stages_an_empty_dense_pool():
    jbms, tbms = bitmaps_both(random_values(np.random.default_rng(29), 1))
    rid = jm.global_row_ids(jbms)
    j_idx, _, j_keys = jm.build_sharded_index([None], None,
                                              with_host_keys=True,
                                              row_ids=rid, capacity=0)
    dense = tm.build_sharded_index([None], "cpu", capacity=0,
                                   row_ids=tm.global_row_ids(
                                       [pack_sparse(tbms[0])]))
    assert dense.words.shape == (1, 0, 2048) == np.asarray(j_idx.words).shape
    assert dense.keys_host.shape == j_keys.shape == (1, 0)


def host_op(op, a, b) -> int:
    a, b = set(map(int, a)), set(map(int, b))
    return len({"and": a & b, "or": a | b, "andnot": a - b}[op])


def row_values(values, slices, row):
    """Per slice the within-slice positions of `row`."""
    out = []
    for s in slices:
        v = values[s]
        if v is None:
            out.append(np.empty(0, dtype=np.int64))
            continue
        lo = np.uint64(row * SLICE_WIDTH)
        out.append((v[(v >= lo) & (v < lo + np.uint64(SLICE_WIDTH))]
                    - lo).astype(np.int64))
    return out


def test_counts_over_jax_staged_pools():
    """count_sparse_pair (K4 for ss, the probe for sd/ds) over the JAX
    package's own staging, carried across with sparse_staged_from_numpy
    and staged_from_numpy, against the host."""
    values = random_values(np.random.default_rng(31), 5)
    jbms, _ = bitmaps_both(values)
    rid = jm.global_row_ids(jbms)
    formats = jm.pick_slice_formats(jm.slice_format_stats(jbms), 0.05)
    _, j_sparse = jm.split_bitmaps_by_format(jbms, formats)
    sp, _, keys, cards = jm.build_sparse_sharded_index(j_sparse, None,
                                                       row_ids=rid)
    dn, _, dkeys = jm.build_sharded_index(jbms, None, with_host_keys=True,
                                          row_ids=rid)
    staged_sp = tm.sparse_staged_from_numpy(keys, np.asarray(sp.values),
                                            cards, rid, "cpu")
    staged_dn = tm.staged_from_numpy(dkeys, np.asarray(dn.words), rid, "cpu")
    pools = {"s": (staged_sp.values, staged_sp.cards),
             "d": (staged_dn.words,)}
    tables = {"s": staged_sp.keys_host, "d": staged_dn.keys_host}
    mask = formats.astype(np.int64)  # the slices the sorted pool holds
    assert list(mask) == [1, 0, 1, 0, 1]
    for kind in ("ss", "sd", "ds"):
        for op in ("and", "or", "andnot"):
            for ra, rb in ((0, 1), (2, 4), (4, 9)):
                ia, ha = tm.resolve_row_indices(
                    tables[kind[0]], tm.dense_row(staged_sp, ra))
                ib, hb = tm.resolve_row_indices(
                    tables[kind[1]], tm.dense_row(staged_sp, rb))
                got = tm.count_sparse_pair(op, kind, pools[kind[0]],
                                           pools[kind[1]], ia, ha, ib, hb,
                                           mask)
                sl = np.flatnonzero(mask)
                want = sum(host_op(op, a, b) for a, b in zip(
                    row_values(values, sl, ra), row_values(values, sl, rb)))
                assert got == want, (kind, op, ra, rb)


def test_serving_wrapper_matches_jax_gather():
    """K4's serving wrapper over (S, C, K) pools and (S, 16) idx/hit
    against the JAX package's container gather + Pallas kernel."""
    values = random_values(np.random.default_rng(37), 5)
    jbms, _ = bitmaps_both(values)
    jbms[1] = None  # its 8000-value container is no array container
    rid = jm.global_row_ids(jbms)
    sp, _, keys, cards = jm.build_sparse_sharded_index(jbms, None,
                                                       row_ids=rid)
    staged = tm.sparse_staged_from_numpy(keys, np.asarray(sp.values), cards,
                                         rid, "cpu")
    ia, ha = jm.resolve_row_indices(keys, 0)
    ib, hb = jm.resolve_row_indices(keys, 3)  # row 4: slice 0 only
    va, na = jm._gather_sparse_containers(sp.values, sp.cards, ia, ha)
    vb, nb = jm._gather_sparse_containers(sp.values, sp.cards, ib, hb)
    want = np.asarray(jk.pallas_sparse_pair_counts(va, na, vb, nb,
                                                   interpret=True))
    got = tk.sparse_pair_count(staged.values, staged.cards, staged.values,
                               staged.cards, *(tt(np.asarray(t, np.int32))
                                               for t in (ia, ha, ib, hb)))
    np.testing.assert_array_equal(got.numpy().reshape(-1), want)
    assert got.shape == (5, 16)


# -- 3. served queries ----------------------------------------------------------


NUM_SLICES = 2


def seed_holder(path):
    """Frame `sp`: rows 1-3 of ~1500 values over three containers of
    each slice (sorted-array), row 4 in slice 0 only, 65535 at a
    container edge of rows 1 and 2. Frame `dn`: rows 1-2 with an
    8000-value container (packed words). Frame `mx`: rows 1-2 sparse in
    slice 0 and dense in slice 1."""
    rng = np.random.default_rng(41)
    h = JaxHolder(str(path))
    h.open()
    idx = h.create_index_if_not_exists("i")

    def sparse_cols(s):
        blocks = rng.choice(16, size=3, replace=False)
        c = (blocks[:, None] * 65536
             + rng.choice(65536, size=(3, 500), replace=False))
        return np.unique(c) + s * SLICE_WIDTH

    def dense_cols(s):
        return rng.choice(12000, size=8000, replace=False) + s * SLICE_WIDTH

    layout = {"sp": {(r, s): sparse_cols for r in (1, 2, 3)
                     for s in range(NUM_SLICES)} | {(4, 0): sparse_cols},
              "dn": {(r, s): dense_cols for r in (1, 2)
                     for s in range(NUM_SLICES)},
              "mx": {(r, s): (sparse_cols, dense_cols)[s] for r in (1, 2)
                     for s in range(NUM_SLICES)}}
    for frame, cells in layout.items():
        f = idx.create_frame_if_not_exists(frame)
        rows, cols = [], []
        for (r, s), make in cells.items():
            c = make(s)
            rows.append(np.full(c.size, r))
            cols.append(c)
        f.import_bits(np.concatenate(rows), np.concatenate(cols))
    sp = idx.frame("sp")
    for r in (1, 2):
        sp.set_bit(r, 7 * 65536 + 65535)
    h.close()


OPS = ("Intersect", "Union", "Difference")


def pair(op, a, fa, b, fb):
    return (f"Count({op}(Bitmap(rowID={a}, frame={fa}), "
            f"Bitmap(rowID={b}, frame={fb})))")


QUERIES = (
    [pair(op, 1, "sp", 2, "sp") for op in OPS]           # ss
    + [pair(op, 4, "sp", 1, "sp") for op in OPS]         # partial row
    + [pair(op, 1, "sp", 2, "dn") for op in OPS]         # sd
    + [pair(op, 1, "dn", 2, "sp") for op in OPS]         # ds
    + [pair("Intersect", 1, "dn", 2, "dn"),              # dd
       pair("Union", 1, "mx", 2, "mx"),                  # ss + dd
       pair("Difference", 1, "mx", 3, "sp"),             # ss + ds
       pair("Union", 99, "sp", 1, "sp"),                 # absent row
       pair("Intersect", 1, "sp", 99, "dn"),
       "Count(Bitmap(rowID=1, frame=sp))",               # single leaf
       "Count(Bitmap(rowID=2, frame=mx))",
       "Count(Bitmap(rowID=99, frame=sp))",
       # n-ary: demotes `sp` to packed words, then a pair runs dense.
       "Count(Union(Bitmap(rowID=1, frame=sp), Bitmap(rowID=2, frame=sp), "
       "Bitmap(rowID=3, frame=sp)))",
       pair("Intersect", 1, "sp", 3, "sp")])


def jax_answers(path, queries, **kwargs):
    h = JaxHolder(str(path))
    h.open()
    try:
        ex = JaxExecutor(h, use_device=True, device_min_work=0, **kwargs)
        out = [ex.execute("i", jax_parse(q))[0] for q in queries]
        return out, ex.mesh_manager().stats.copy()
    finally:
        h.close()


def port_answers(path, queries, **kwargs):
    h = Holder(str(path))
    h.open()
    try:
        ex = Executor(h, device="cpu", **kwargs)
        out = [ex.execute("i", parse_string(q))[0] for q in queries]
        return out, ex
    finally:
        h.close()


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_COUNT_BACKEND", "pallas_interpret")
    monkeypatch.delenv("PILOSA_TPU_SPARSE_DENSITY_THRESHOLD", raising=False)
    seed_holder(tmp_path / "data")
    return tmp_path / "data"


def test_served_queries_match_jax(data_dir):
    want, jstats = jax_answers(data_dir, QUERIES)
    got, ex = port_answers(data_dir, QUERIES)
    assert got == want
    assert jstats["sparse_count"] > 0
    stats = ex.mesh_manager().stats
    assert ex.stats["count_device"] == len(QUERIES)
    assert stats["sparse_count"] > 0
    for group in ("ss", "sd", "ds", "dd"):
        assert stats[f"sparse_group:{group}"] > 0, group
    assert stats["kernel:sparse_pair_count"] > 0
    assert stats["sparse_leaf_host"] > 0
    assert stats["sparse_demote"] == 1
    assert stats["fallback_sparse_shape"] == 1
    views = ex.mesh_manager()._views
    assert views[("i", "sp", "standard")].sparse is None  # pinned dense
    mx = views[("i", "mx", "standard")]
    assert mx.sparse is not None and list(mx.slice_formats) == [1, 0]


def test_write_then_count_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_COUNT_BACKEND", "pallas_interpret")
    seq = [pair("Union", 1, "sp", 2, "sp"),
           "SetBit(rowID=1, frame=sp, columnID=3)",
           f"SetBit(rowID=2, frame=sp, columnID={SLICE_WIDTH + 3})",
           pair("Union", 1, "sp", 2, "sp"),
           "Count(Bitmap(rowID=1, frame=sp))",
           "ClearBit(rowID=1, frame=sp, columnID=3)",
           pair("Intersect", 1, "sp", 2, "sp")]
    for name in ("jax", "port"):
        seed_holder(tmp_path / name)
    want, _ = jax_answers(tmp_path / "jax", seq)
    got, ex = port_answers(tmp_path / "port", seq)
    assert got == want
    assert want[3] == want[0] + 2
    stats = ex.mesh_manager().stats
    assert stats["sparse_count"] == 4
    assert stats["stage"] >= 2  # the writes restaged the view


def test_kill_switch_stages_everything_dense(data_dir):
    want, jstats = jax_answers(data_dir, QUERIES[:12], mesh_config={
        "sparse_density_threshold": 0.0})
    got, ex = port_answers(data_dir, QUERIES[:12],
                           sparse_density_threshold=0)
    assert got == want
    assert jstats.get("sparse_count", 0) == 0
    stats = ex.mesh_manager().stats
    assert stats["sparse_count"] == 0 and stats["stage_sparse_slices"] == 0
    assert all(sv.sparse is None
               for sv in ex.mesh_manager()._views.values())


def test_env_overrides_the_threshold(monkeypatch):
    """The environment variable sets the server flag's default; the flag
    itself wins over it."""
    argv = ["-d", "data"]
    monkeypatch.delenv(THRESHOLD_ENV, raising=False)
    assert parse_args(argv).sparse_density_threshold == 0.05
    monkeypatch.setenv(THRESHOLD_ENV, "0")
    assert parse_args(argv).sparse_density_threshold == 0
    assert parse_args(argv + ["--sparse-density-threshold", "0.05"]) \
        .sparse_density_threshold == 0.05


def test_serve_passes_the_threshold(tmp_path):
    h = Holder(str(tmp_path))
    h.open()
    try:
        srv = serve(h, device="cpu", sparse_density_threshold=0)
        try:
            mgr = srv.handler.executor.mesh_manager()
            assert mgr.sparse_density_threshold == 0
        finally:
            srv.close()
        ex = Executor(h, device="cpu")
        assert ex.mesh_manager().sparse_density_threshold == 0.05
    finally:
        h.close()


def test_dense_path_demotes_a_sorted_view(data_dir):
    """_resolve picks the path from the one staging it makes: a pair over
    a sorted-array view resolves to the format groups, and a tree only
    the dense kernels fold demotes the view first, so the dense request
    never reads a view whose sorted-array pool holds slices."""
    tri = ("Count(Intersect(Bitmap(rowID=1, frame=sp), "
           "Bitmap(rowID=2, frame=sp), Bitmap(rowID=3, frame=sp)))")
    qs = [pair("Intersect", 1, "sp", 2, "sp"), tri]
    want, _ = jax_answers(data_dir, qs)
    h = Holder(str(data_dir))
    h.open()
    try:
        mgr = Executor(h, device="cpu").mesh_manager()
        from pilosa_tpu_torch.parallel.plan import _lower_tree
        from pilosa_tpu_torch.parallel.serve import (_CountRequest,
                                                     _SparseCount)

        def resolve(q):
            leaves = []
            shape = _lower_tree(h, "i", parse_string(q).calls[0].children[0],
                                leaves)
            return mgr._resolve("i", shape, leaves, [0, 1], NUM_SLICES)

        req = resolve(qs[0])
        assert isinstance(req, _SparseCount) and mgr.stats["stage"] == 1
        assert mgr._run_sparse(req) == want[0]
        req = resolve(qs[1])
        assert isinstance(req, _CountRequest)
        mgr._run_count_group([req])
        assert req.result == want[1]
        assert mgr.stats["sparse_demote"] == 1
        assert mgr._views[("i", "sp", "standard")].sparse is None
    finally:
        h.close()


def test_restage_keeps_a_boundary_slice_sorted(tmp_path):
    """One slice of mean fill d = 3000 / (6 x 65536): at a threshold of
    0.0070 a fresh pick is dense (d > 0.0070), but a slice staged sorted
    keeps its format while d < 0.0070 x 1.25; at 0.0060 it converts."""
    h = Holder(str(tmp_path))
    h.open()
    try:
        f = h.create_index("i").create_frame("f")
        rng = np.random.default_rng(43)
        cols = np.concatenate([b * 65536 + rng.choice(65536, 500,
                                                      replace=False)
                               for b in range(6)])
        rows = np.repeat([1, 2], 1500)
        f.create_view_if_not_exists("standard") \
            .create_fragment_if_not_exists(0).import_bits(rows, cols)
        base = int(cols[0])
        q = parse_string("Count(Union(Bitmap(rowID=1, frame=f), "
                         "Bitmap(rowID=2, frame=f)))")
        ex = Executor(h, device="cpu", sparse_density_threshold=0.0084)
        mgr = ex.mesh_manager()

        def sv():
            return mgr._views[("i", "f", "standard")]

        assert ex.execute("i", q)[0] == 3000
        assert sv().sparse is not None
        mgr.sparse_density_threshold = 0.0070
        ex.execute("i", parse_string(
            f"ClearBit(rowID=1, frame=f, columnID={base})"))
        assert ex.execute("i", q)[0] == 2999
        assert sv().sparse is not None  # kept by the band
        fresh = Executor(h, device="cpu", sparse_density_threshold=0.0070)
        assert fresh.execute("i", q)[0] == 2999
        assert fresh.mesh_manager()._views[("i", "f", "standard")] \
            .sparse is None  # no previous format: dense
        mgr.sparse_density_threshold = 0.0060
        ex.execute("i", parse_string(
            f"SetBit(rowID=1, frame=f, columnID={base})"))
        assert ex.execute("i", q)[0] == 3000
        assert sv().sparse is None  # beyond the band: converts
        assert mgr.stats["stage"] == 3
    finally:
        h.close()


def test_concurrent_sparse_counts_under_restages(data_dir):
    """Threads count sorted-array, mixed and sd pairs while a writer keeps
    restaging the dense frame they read (a row no query reads): every
    answer stays exact. A short switch interval forces interleavings.
    Each write adds or removes a whole container (one bit of row 7 set
    and cleared in turn), so every refresh that sees a write restages,
    whatever the scatter's cost gate would pick."""
    import sys
    import threading

    queries = [pair("Intersect", 1, "sp", 2, "sp"),
               pair("Union", 1, "mx", 2, "mx"),
               pair("Difference", 1, "sp", 2, "dn"),
               "Count(Bitmap(rowID=3, frame=sp))"]
    want, _ = jax_answers(data_dir, queries)
    h = Holder(str(data_dir))
    h.open()
    old = sys.getswitchinterval()
    try:
        ex = Executor(h, device="cpu")
        dn = h.index("i").frame("dn")
        errors, stop = [], threading.Event()

        def reader(k):
            for j in range(12):
                i = (j + k) % len(queries)
                got = ex.execute("i", parse_string(queries[i]))[0]
                if got != want[i]:
                    errors.append((queries[i], got, want[i]))

        def writer():
            while not stop.is_set():
                dn.set_bit(7, 0)
                dn.clear_bit(7, 0)

        sys.setswitchinterval(1e-5)
        w = threading.Thread(target=writer)
        threads = [threading.Thread(target=reader, args=(k,))
                   for k in range(12)]
        w.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        stop.set()
        w.join(30)
        assert not any(t.is_alive() for t in threads) and not w.is_alive()
        assert errors == []
        stats = ex.mesh_manager().stats
        assert stats["sparse_count"] == 12 * 12
        assert stats["stage"] > 3  # the writer forced restages
    finally:
        sys.setswitchinterval(old)
        h.close()
