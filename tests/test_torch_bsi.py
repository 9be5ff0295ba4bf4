"""Integer (BSI) fields in the port against the JAX package.

Every layer is held exactly against its JAX counterpart on inputs made
once with numpy from a fixed seed: the schema and its encoding, the
comparison trees, PQL, the pair-count kernel (the port's plain version on
CPU tensors against the Pallas kernel in interpret mode), the dense
aggregates of ops.bsi, and the slice end to end: SetValue, Count(Range)
for every operator, and Sum / Min / Max with and without a filter through
both executors. The port's counts must come from its device path.
"""

import gc
import json
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.bsi import FieldSchema as JaxSchema
from pilosa_tpu.bsi import cond_tree as jax_cond_tree
from pilosa_tpu.bsi import lower as jax_lower
from pilosa_tpu.bsi.field import FieldNotFoundError as JaxFieldNotFound
from pilosa_tpu.bsi.field import FieldValueError as JaxFieldValueError
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.ops import bsi as jax_bsi
from pilosa_tpu.ops import kernels as jk
from pilosa_tpu.pql import parse_string as jax_parse

from pilosa_tpu_torch.api.handler import Handler
from pilosa_tpu_torch.bsi import (MAX_BIT_DEPTH, FieldNotFoundError,
                                  FieldSchema, FieldValueError, cond_tree)
from pilosa_tpu_torch.bsi import lower as tl
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops import bsi as tbsi
from pilosa_tpu_torch.ops import kernels as tk
from pilosa_tpu_torch.parallel.plan import _lower_tree, canonical_tree
from pilosa_tpu_torch.pql import parse_string
from torch_threads import one_torch_thread  # noqa: F401

OPS = (">", ">=", "<", "<=", "==", "!=")
PAIR_OPS = ("and", "or", "xor", "andnot")
SCHEMAS = [(-32768, 32767), (0, 100), (-100, 50), (0, 0), (-7, -3),
           (-(2 ** 31), 2 ** 31 - 1), (-(2 ** 62) + 1, 2 ** 62 - 1)]


def constants(lo: int, hi: int) -> list:
    """Comparison constants around 0, the range edges and past them."""
    d = max(1, max(abs(lo), abs(hi)).bit_length())
    out = {0, 1, -1, lo, hi, lo - 1, hi + 1, lo + 1, hi - 1,
           (1 << (d - 1)), -(1 << (d - 1)), (1 << d), -(1 << d),
           hi // 3, lo // 3}
    return sorted(out)


# -- schema, trees, PQL -------------------------------------------------------


@pytest.mark.parametrize("lo,hi", SCHEMAS)
def test_schema_matches_jax(lo, hi):
    mine, ref = FieldSchema("v", lo, hi), JaxSchema("v", lo, hi)
    assert (mine.bit_depth, mine.row_count, mine.view) == \
        (ref.bit_depth, ref.row_count, ref.view)
    assert mine.to_dict() == ref.to_dict()
    for v in (lo, hi, 0, lo // 7, hi // 5, (lo + hi) // 2):
        if lo <= v <= hi:
            assert mine.encode(v) == ref.encode(v)
    for bad in (lo - 1, hi + 1, True, "1"):
        with pytest.raises(FieldValueError):
            mine.encode(bad)
        with pytest.raises(JaxFieldValueError):
            ref.encode(bad)


@pytest.mark.parametrize("lo,hi", SCHEMAS)
def test_cond_trees_match_jax(lo, hi):
    mine, ref = FieldSchema("v", lo, hi), JaxSchema("v", lo, hi)
    cs = constants(lo, hi)
    for op in OPS:
        for c in cs:
            assert cond_tree(mine, op, c) == jax_cond_tree(ref, op, c), (op, c)
    for pair in ((lo, hi), (cs[1], cs[-2]), (hi, lo), (0, 0)):
        assert cond_tree(mine, "><", pair) == jax_cond_tree(ref, "><", pair)
    for name in ("POS", "NEG", "EMPTY"):
        assert getattr(tl, name) == getattr(jax_lower, name)
    tree = cond_tree(mine, ">", cs[len(cs) // 2])
    mine_leaves, ref_leaves = [], []
    assert tl.to_shape(tree, "f", mine.view, mine_leaves) == \
        jax_lower.to_shape(tree, "f", ref.view, ref_leaves)
    assert mine_leaves == ref_leaves


PQL = [
    'Range(frame="f", val >= 10)',
    "Range(frame=f, val > -3)",
    "Range(val < 0, frame=f)",
    "Range(frame=f, val <= 7)",
    "Range(frame=f, val == -12)",
    "Range(frame=f, val != 0)",
    "Range(frame=f, val >< [-5, 10])",
    'Count(Intersect(Range(frame=f, val>=1), Bitmap(frame="g", rowID=2)))',
    'Sum(Bitmap(frame=general, rowID=0), frame=f, field="val")',
    'Min(frame=f, field="val")',
    "SetValue(frame=f, columnID=10, val=-42)",
]


@pytest.mark.parametrize("q", PQL)
def test_pql_round_trips_like_jax(q):
    mine, ref = parse_string(q), jax_parse(q)
    assert str(mine) == str(ref)
    assert str(parse_string(str(mine))) == str(mine)


@pytest.mark.parametrize("q", ["Range(frame=f, val >< 3)",
                               "Range(frame=f, val >= 1.5)",
                               "Range(frame=f, val >< [1, 2, 3])",
                               'Range(frame=f, val > "x")'])
def test_bad_conditions_fail_to_parse(q):
    from pilosa_tpu_torch.pql import ParseError

    with pytest.raises(ParseError):
        parse_string(q)


# -- canonical trees ----------------------------------------------------------


def nested_filter(n: int) -> list:
    if n == 1:
        return ["leaf"]
    return ["and", nested_filter(n // 2), nested_filter(n - n // 2)]


@pytest.mark.parametrize("depth", range(1, MAX_BIT_DEPTH + 1))
def test_every_ladder_fits_the_kernels(depth):
    """Every comparison of a field up to MAX_BIT_DEPTH planes, alone and
    ANDed with a 16-leaf filter (flat or nested), fits K1/K3 after
    canonicalization: leaves, program length and held values."""
    mx = (1 << depth) - 1
    schema = FieldSchema("v", -mx, mx)
    conds = [(op, c) for op in OPS for c in constants(-mx, mx)]
    conds += [("><", (-mx, mx)), ("><", (1, mx - 1)), ("><", (-mx // 3, 0))]
    filters = [None, ["or"] + [["leaf"]] * 16, nested_filter(16)]
    for op, c in conds:
        for filt in filters:
            raw = []
            shape = tl.to_shape(cond_tree(schema, op, c), "f", schema.view,
                                raw)
            if filt is not None:
                shape = ["and", shape, filt]
                raw += [("g", "standard", r, True) for r in range(16)]
            leaves = []
            tree = canonical_tree(shape, raw, leaves)
            assert tree is not None, (op, c, filt)
            assert tk.tree_depth(tree) <= tk.MAX_DEPTH
            assert len(leaves) <= tk.MAX_LEAVES
            assert len(leaves) == len({lf[:3] for lf in raw})


def test_canonical_tree_dedupes_and_folds_left_deep():
    raw = [("f", "v", r, False) for r in (5, 6, 5, 7, 6)]
    shape = ["and", ["leaf"], ["or", ["leaf"], ["and", ["leaf"],
                                                ["leaf"]]], ["leaf"]]
    leaves = []
    tree = canonical_tree(shape, raw, leaves)
    # The nested operands move first and leaves are numbered by first use
    # in that order; rows 5 and 6 keep one slot each.
    assert leaves == [raw[0], raw[3], raw[1]]
    assert tree == ["and", ["or", ["and", ["leaf", 0], ["leaf", 1]],
                            ["leaf", 2]], ["leaf", 0], ["leaf", 2]]
    # andnot keeps its operand order.
    leaves = []
    assert canonical_tree(["andnot", ["leaf"], ["or", ["leaf"], ["leaf"]]],
                          raw[:3], leaves) == \
        ["andnot", ["leaf", 0], ["or", ["leaf", 1], ["leaf", 0]]]


# -- K5 pair_count against Pallas #2 ------------------------------------------


def word_pair(m: int, seed: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, size=(m, 2048), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, size=(m, 2048), dtype=np.uint32)
    a[0, :64] = 0xFFFFFFFF
    b[-1] = 0
    return a, b


def tt(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("op", PAIR_OPS)
@pytest.mark.parametrize("m", [1, 7, 9, 64])
def test_pair_count_matches_pallas(op, m):
    a, b = word_pair(m, 100 + m)
    got = tk.pair_count(tt(a), tt(b), op)
    assert got.dtype == torch.int64 and got.dim() == 0
    want = jk._pallas_pair_count(jnp.asarray(a), jnp.asarray(b), op=op,
                                 interpret=True)
    fused = jk.fused_pair_count(jnp.asarray(a), jnp.asarray(b), op,
                                force_pallas=True, interpret=True)
    assert int(got) == int(want) == int(fused)


def test_pair_count_without_b_is_popcount():
    a, _ = word_pair(9, 3)
    want = int(np.bitwise_count(a).sum())
    assert int(tk.pair_count(tt(a))) == want
    with pytest.raises(ValueError):
        tk.pair_count(tt(a), None, "nand")
    with pytest.raises(ValueError):
        tk.pair_count(tt(a[:, :1024]))


@pytest.mark.parametrize("op", PAIR_OPS)
@pytest.mark.parametrize("b_kind", ["none", "row", "block"])
def test_pair_count_rows_matches_pallas(op, b_kind):
    """The serving form: each row's containers gathered by its index
    table (absent = zero) against b, as Pallas #2 counts the same pair."""
    rng = np.random.default_rng(len(op) * 7 + len(b_kind))
    s, cap, p = 3, 32, 4
    pool = rng.integers(0, 1 << 32, size=(s, cap, 2048), dtype=np.uint32)
    a_idx = rng.integers(0, cap, size=(p, s, 16)).astype(np.int32)
    a_idx[rng.random(a_idx.shape) < 0.25] = -1
    b_idx = rng.integers(-1, cap, size=(s, 16)).astype(np.int32)
    block = rng.integers(0, 1 << 32, size=(s, 16, 2048), dtype=np.uint32)

    def gather(idx):
        out = pool[np.arange(s)[:, None], np.maximum(idx, 0)]
        return out * (idx >= 0)[..., None].astype(np.uint32)

    b = {"none": None, "row": gather(b_idx), "block": block}[b_kind]
    kw = {"none": {}, "row": {"b_pool": tt(pool),
                              "b_idx": torch.from_numpy(b_idx)},
          "block": {"b_block": tt(block)}}[b_kind]
    got = tk.pair_count_rows(tt(pool), torch.from_numpy(a_idx), op, **kw)
    assert got.dtype == torch.int64 and got.shape == (p,)
    for r in range(p):
        a = gather(a_idx[r]).reshape(-1, 2048)
        if b is None:
            want = int(np.bitwise_count(a).sum())
        else:
            want = int(jk._pallas_pair_count(
                jnp.asarray(a), jnp.asarray(b.reshape(-1, 2048)), op=op,
                interpret=True))
        assert int(got[r]) == want, (r, op, b_kind)


def test_probe_ok_plain():
    assert tk.probe_ok("cpu") is True


# -- ops.bsi against the JAX ops.bsi ------------------------------------------

N_WORDS = 2500  # not a whole number of 2048-word containers


def field_values(schema: FieldSchema, n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    cols = rng.choice(N_WORDS * 32, size=n, replace=False)
    vals = rng.integers(schema.min, schema.max + 1, size=n)
    vals[:4] = [schema.min, schema.max, 0, schema.max // 2]
    return dict(zip(cols.tolist(), vals.tolist()))


def dense(schema, vals):
    cols, vv = zip(*sorted(vals.items()))
    rows = tbsi.dense_rows_from_values(cols, vv, schema, N_WORDS)
    ref = jax_bsi.dense_rows_from_values(cols, vv, JaxSchema(
        schema.name, schema.min, schema.max), N_WORDS)
    assert (rows == ref).all()
    return rows


def filter_words(vals, every: int) -> np.ndarray:
    src = np.zeros(N_WORDS, dtype=np.uint32)
    for i, c in enumerate(sorted(vals)):
        if i % every == 0:
            src[c // 32] |= np.uint32(1 << (c % 32))
    return src


@pytest.mark.parametrize("filtered", [False, True])
def test_plane_counts_and_sum_dense_match_jax(filtered):
    schema = FieldSchema("val", -(2 ** 12), 2 ** 12)
    vals = field_values(schema, 300, 5)
    planes = dense(schema, vals)
    src = filter_words(vals, 3) if filtered else None
    got = tbsi.plane_counts(planes, src, device="cpu")
    want = jax_bsi.plane_counts(planes, src, backend="pallas", interpret=True)
    assert got.dtype == np.int64 and (got == want).all()
    js = JaxSchema("val", schema.min, schema.max)
    want_sum = jax_bsi.sum_dense(planes, js, src=src, backend="pallas",
                                 interpret=True)
    assert tbsi.sum_dense(planes, schema, src=src, device="cpu") == want_sum
    keep = set(sorted(vals)[::3]) if filtered else set(vals)
    assert want_sum == (sum(vals[c] for c in keep), len(keep))


@pytest.mark.parametrize("maximize", [True, False])
@pytest.mark.parametrize("sign", [0, 1, -1])
@pytest.mark.parametrize("filtered", [False, True])
def test_extremum_dense_matches_jax(maximize, sign, filtered):
    schema = FieldSchema("val", -(2 ** 10), 2 ** 10)
    vals = field_values(schema, 80, 11 + sign)
    if sign:  # one-signed populations take both search branches
        vals = {c: sign * abs(v) for c, v in vals.items()}
    planes = dense(schema, vals)
    src = filter_words(vals, 2) if filtered else None
    got = tbsi.extremum_dense(planes, schema, maximize, src=src,
                              device="cpu")
    want = jax_bsi.extremum_dense(planes, JaxSchema("val", -1024, 1024),
                                  maximize, src=src, backend="pallas",
                                  interpret=True)
    assert got == want


def test_extremum_dense_empty():
    schema = FieldSchema("val", -10, 10)
    planes = np.zeros((schema.row_count, N_WORDS), dtype=np.uint32)
    assert tbsi.extremum_dense(planes, schema, True, device="cpu") is None


def test_tree_count_dense_matches_jax():
    schema = FieldSchema("val", -500, 500)
    js = JaxSchema("val", -500, 500)
    vals = field_values(schema, 150, 13)
    planes = dense(schema, vals)
    for op, c in ((">", 0), (">=", -17), ("<", 129), ("<=", -128),
                  ("==", 0), ("!=", 5), ("><", (-100, 100)), (">", 9999)):
        got = tbsi.tree_count_dense(cond_tree(schema, op, c), planes,
                                    device="cpu")
        want = jax_bsi.tree_count_dense(jax_cond_tree(js, op, c), planes,
                                        backend="pallas", interpret=True)
        assert got == want, (op, c)


def test_sum_epilogue_is_exact_beyond_int64_planes():
    counts = {0: 3, 1: 1}
    counts.update({2 + k: 1 << 20 for k in range(62)})
    neg = {2 + k: 1 for k in range(62)}
    got = tbsi.sum_from_plane_dicts(counts, neg, 62)
    assert got == jax_bsi.sum_from_plane_dicts(counts, neg, 62)
    assert got[0] == sum(((1 << 20) - 2) << k for k in range(62))


# -- the slice end to end -----------------------------------------------------

NUM_SLICES = 3
VAL = (-32768, 32767)
BIG = (-(2 ** 31), 2 ** 31 - 1)  # the default field's range


def encode_bits(lo, hi, cols, vals):
    """(rows, cols) of the set bits of a field's bsi view."""
    d = max(1, max(abs(lo), abs(hi)).bit_length())
    mags = np.abs(vals)
    rows, out = [np.zeros(len(cols), np.int64)], [cols]
    rows.append(np.ones(int((vals < 0).sum()), np.int64))
    out.append(cols[vals < 0])
    for k in range(d):
        on = ((mags >> k) & 1).astype(bool)
        rows.append(np.full(int(on.sum()), 2 + k, np.int64))
        out.append(cols[on])
    return np.concatenate(rows), np.concatenate(out)


def seed_data(path, per_slice: int, seed: int = 31) -> dict:
    """A JAX-written holder: frame `f` with fields `val` (bit depth 16) and
    `big` (the default 32-bit field), frame `general` with filter rows
    0-2. Returns the values {field: {column: value}}."""
    rng = np.random.default_rng(seed)
    h = JaxHolder(str(path))
    h.open()
    idx = h.create_index_if_not_exists("i")
    f = idx.create_frame_if_not_exists("f")
    g = idx.create_frame_if_not_exists("general")
    truth = {}
    for name, (lo, hi) in (("val", VAL), ("big", BIG)):
        f.create_field_if_not_exists(JaxSchema(name, lo, hi))
        view = f.create_view_if_not_exists(f"bsi.{name}")
        truth[name] = {}
        for s in range(NUM_SLICES):
            cols = np.sort(rng.choice(SLICE_WIDTH, size=per_slice,
                                      replace=False)) + s * SLICE_WIDTH
            vals = rng.integers(lo, hi + 1, size=per_slice, dtype=np.int64)
            vals[:6] = [lo, hi, 0, -1, 1, hi // 2]
            rows, bits = encode_bits(lo, hi, cols, vals)
            view.create_fragment_if_not_exists(s).import_bits(rows, bits)
            truth[name].update(zip(cols.tolist(), vals.tolist()))
    for r in range(3):
        cols = rng.choice(NUM_SLICES * SLICE_WIDTH, size=per_slice * 2,
                          replace=False)
        g.import_bits(np.full(cols.size, r), cols)
    h.close()
    return truth


def e2e_queries(truth) -> list:
    cols = sorted(truth["val"])
    qs = []
    for field, filt in (("val", ""), ("val", "Bitmap(frame=general, rowID=0), "),
                        ("val", "Intersect(Bitmap(frame=general, rowID=0), "
                                "Bitmap(frame=general, rowID=1)), "),
                        ("val", "Union(Bitmap(frame=general, rowID=1), "
                                "Range(frame=f, val > 100)), "),
                        ("big", ""), ("big", "Bitmap(frame=general, rowID=2), ")):
        for agg in ("Sum", "Min", "Max"):
            qs.append(f'{agg}({filt}frame=f, field="{field}")')
    for op in OPS:
        for c in (-32769, -32768, -1000, -1, 0, 1, 999, 32767, 32768):
            qs.append(f"Count(Range(frame=f, val {op} {c}))")
        qs.append(f"Count(Range(frame=f, big {op} -7))")
    for lo, hi in ((-1000, 1000), (-32768, 32767), (5, 5), (10, -10)):
        qs.append(f"Count(Range(frame=f, val >< [{lo}, {hi}]))")
    qs += ["Range(frame=f, val >= 30000)",
           "Count(Intersect(Range(frame=f, val < 0), "
           "Bitmap(frame=general, rowID=0)))",
           "Count(Difference(Range(frame=f, val != 0), "
           "Range(frame=f, big > 0)))"]
    # Writes: overwrite, flip sign, zero, a column with no value yet, a
    # new slice; then read everything that depends on them.
    new_col = NUM_SLICES * SLICE_WIDTH + 5
    for col, v in ((cols[10], 32767), (cols[11], -32768), (cols[12], 0),
                   (cols[13] + 1, -5), (new_col, 12345), (cols[10], 31000)):
        qs.append(f"SetValue(frame=f, columnID={col}, val={v})")
    qs += ['Sum(frame=f, field="val")', 'Min(frame=f, field="val")',
           'Max(frame=f, field="val")',
           'Sum(Bitmap(frame=general, rowID=0), frame=f, field="val")',
           "Count(Range(frame=f, val >= 31000))",
           "Count(Range(frame=f, val == 12345))",
           f"SetValue(frame=f, columnID={cols[3]}, val=40000)",    # 422
           f"SetValue(frame=f, columnID={cols[3]}, nope=1)",       # 404
           'Sum(frame=f, field="nope")',                           # 404
           'Min(frame=f, field="val")']
    return qs


def plain(result):
    if hasattr(result, "columns"):
        return ("row", [int(c) for c in result.columns()])
    return result


def run_all(ex, parse, queries, errors):
    out = []
    for q in queries:
        try:
            out.append(plain(ex.execute("i", parse(q))[0]))
        except errors as e:
            out.append(("error", type(e).__name__))
    return out


@pytest.fixture(scope="module", params=[0.0, 0.05],
                ids=["dense", "threshold"])
def e2e(request, tmp_path_factory):
    """Both executors over the same query sequence on copies of one
    seeded data directory; at threshold 0.05 the bsi views stage sorted-
    array first and demote."""
    base = tmp_path_factory.mktemp("bsi_e2e")
    truth = seed_data(base / "jax", per_slice=1500)
    shutil.copytree(base / "jax", base / "port")
    queries = e2e_queries(truth)
    jh = JaxHolder(str(base / "jax"))
    jh.open()
    try:
        jax_out = run_all(JaxExecutor(jh, use_device=False), jax_parse,
                          queries, (JaxFieldValueError, JaxFieldNotFound))
    finally:
        jh.close()
    ph = Holder(str(base / "port"))
    ph.open()
    try:
        ex = Executor(ph, device="cpu",
                      sparse_density_threshold=request.param)
        port_out = run_all(ex, parse_string, queries,
                           (FieldValueError, FieldNotFoundError))
        stats, mstats = dict(ex.stats), dict(ex.mesh_manager().stats)
    finally:
        ph.close()
    return queries, jax_out, port_out, stats, mstats, request.param


@pytest.mark.parametrize("i", range(len(e2e_queries(
    {"val": {k: 0 for k in range(20)}}))))
def test_slice_answers_match_jax(e2e, i):
    queries, jax_out, port_out, *_ = e2e
    assert port_out[i] == jax_out[i], queries[i]


def test_slice_ran_on_the_device_path(e2e):
    queries, jax_out, port_out, stats, mstats, thr = e2e
    counts = sum(q.startswith("Count(") for q in queries)
    aggs = sum(q.split("(")[0] in ("Sum", "Min", "Max")
               and "nope" not in q for q in queries)
    assert stats.get("count_host", 0) == 0
    assert stats["count_device"] == counts
    # The Union filter holds a Range: it lowers too, so every aggregate
    # with a known field ran on the device path.
    assert stats["bsi_device"] == aggs and stats.get("bsi_host", 0) == 0
    assert mstats["kernel:pair_count_rows"] > 0
    assert mstats["bsi_aggregate"] == mstats["kernel:pair_count_rows"]
    if thr:
        assert mstats.get("sparse_demote", 0) >= 1
    # The errors and the values the JAX package answers are the port's.
    assert ("error", "FieldValueError") in port_out
    assert ("error", "FieldNotFoundError") in port_out


def test_slice_matches_the_jax_device_route(tmp_path):
    """A few of the same queries against the JAX package's own device
    route (its mesh aggregates and counts), not only its host folds."""
    seed_data(tmp_path / "jax", per_slice=1500)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    queries = ['Sum(frame=f, field="val")',
               'Sum(Bitmap(frame=general, rowID=0), frame=f, field="val")',
               'Max(frame=f, field="val")', 'Sum(frame=f, field="big")',
               "Count(Range(frame=f, val > 1000))",
               "Count(Range(frame=f, val >< [-7, 7]))"]
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    try:
        jex = JaxExecutor(jh, use_device=True, device_min_work=0)
        want = [jex.execute("i", jax_parse(q))[0] for q in queries]
        routes = dict(jex.route_stats.copy())
    finally:
        jh.close()
    assert routes.get("count_bsi-mesh", 0) >= 3
    ph = Holder(str(tmp_path / "port"))
    ph.open()
    try:
        ex = Executor(ph, device="cpu")
        assert [ex.execute("i", parse_string(q))[0] for q in queries] == want
        assert ex.stats["bsi_device"] == 4 and ex.stats["count_device"] == 2
    finally:
        ph.close()


def test_sum_sign_pass_runs_only_with_negatives(tmp_path):
    h = Holder(str(tmp_path))
    h.open()
    try:
        f = h.create_index_if_not_exists("i").create_frame_if_not_exists("f")
        f.create_field_if_not_exists(FieldSchema("v", -100, 100))
        for col, v in ((1, 5), (2, 7), (SLICE_WIDTH + 3, 100)):
            f.set_value("v", col, v)
        ex = Executor(h, device="cpu")
        q = parse_string('Sum(frame=f, field="v")')
        assert ex.execute("i", q)[0] == {"value": 112, "count": 3}
        assert ex.mesh_manager().stats["kernel:pair_count_rows"] == 1
        f.set_value("v", 2, -7)
        assert ex.execute("i", q)[0] == {"value": 98, "count": 3}
        assert ex.mesh_manager().stats["kernel:pair_count_rows"] == 3
    finally:
        h.close()


@pytest.mark.parametrize("q", [
    "Intersect(Bitmap(frame=f, rowID=1), Bitmap(frame=f, rowID=2))",
    "Range(frame=f, v > 17)"])
def test_planning_a_count_leaves_no_cyclic_garbage(tmp_path, q):
    """Lowering, canonicalizing and programming a tree frees everything
    by reference count: cyclic garbage would bring the collector's full
    passes over a large holder sooner, each a stall of the queries in
    flight."""
    h = Holder(str(tmp_path))
    h.open()
    try:
        f = h.create_index_if_not_exists("i").create_frame_if_not_exists("f")
        f.create_field_if_not_exists(FieldSchema("v", -100, 100))
        f.set_bit(1, 5)
        f.set_value("v", 5, 42)
        call = parse_string(q).calls[0]
        gc.collect()
        gc.disable()
        try:
            for _ in range(20):
                leaves: list = []
                tree = _lower_tree(h, "i", call, leaves)
                tk.tree_program(tree)
            assert gc.collect() == 0
        finally:
            gc.enable()
        assert tree is not None and leaves
    finally:
        h.close()


def test_empty_field_answers(tmp_path):
    h = Holder(str(tmp_path))
    h.open()
    try:
        f = h.create_index_if_not_exists("i").create_frame_if_not_exists("f")
        f.create_field_if_not_exists(FieldSchema("v", -10, 10))
        f.set_bit(1, 5)  # the index has a slice, the field no fragment
        ex = Executor(h, device="cpu")
        for q, want in (('Sum(frame=f, field="v")', {"value": 0, "count": 0}),
                        ('Min(frame=f, field="v")', None),
                        ('Max(frame=f, field="v")', None),
                        ("Count(Range(frame=f, v > -10))", 0)):
            assert ex.execute("i", parse_string(q))[0] == want, q
        assert ex.stats["count_host"] == 0
    finally:
        h.close()


def test_low_fill_field_stages_sorted_then_serves_dense(tmp_path):
    """A field of ~2,000 values per slice stages as sorted arrays at the
    default threshold; the plane counts demote it to packed words and
    every answer still comes from the device path."""
    truth = seed_data(tmp_path / "d", per_slice=2000, seed=5)
    vals = truth["val"]
    h = Holder(str(tmp_path / "d"))
    h.open()
    try:
        ex = Executor(h, device="cpu")
        mgr = ex.mesh_manager()
        # A single-leaf count stages the view and serves it sorted-array.
        n = ex.execute("i", parse_string(
            "Count(Range(frame=f, val >= 0))"))[0]
        assert n == sum(v >= 0 for v in vals.values())
        assert mgr.stats["stage_sparse_slices"] == NUM_SLICES
        got = ex.execute("i", parse_string('Sum(frame=f, field="val")'))[0]
        assert got == {"value": sum(vals.values()), "count": len(vals)}
        assert mgr.stats["sparse_demote"] == 1
        assert mgr._views[("i", "f", "bsi.val")].sparse is None
        got = ex.execute("i", parse_string('Max(frame=f, field="val")'))[0]
        top = max(vals.values())
        assert got == {"value": top,
                       "count": sum(v == top for v in vals.values())}
        assert ex.stats["count_host"] == 0 and ex.stats["bsi_host"] == 0
    finally:
        h.close()


def test_unlowerable_filter_runs_on_host(tmp_path):
    truth = seed_data(tmp_path / "d", per_slice=200, seed=6)
    h = Holder(str(tmp_path / "d"))
    h.open()
    try:
        ex = Executor(h, device="cpu")
        # 81 distinct rows: beyond the kernels' leaf cap.
        filt = "Union(" + ", ".join(
            f"Bitmap(frame=general, rowID={r})"
            for r in range(tk.MAX_LEAVES + 1)) + ")"
        got = ex.execute("i", parse_string(
            f'Sum({filt}, frame=f, field="val")'))[0]
        rows = set()
        for r in range(3):
            rows |= set(int(c) for c in ex.execute("i", parse_string(
                f"Bitmap(frame=general, rowID={r})"))[0].columns())
        keep = [v for c, v in truth["val"].items() if c in rows]
        assert got == {"value": sum(keep), "count": len(keep)}
        assert ex.stats["bsi_host"] == 1 and ex.stats["bsi_device"] == 0
    finally:
        h.close()


# -- HTTP ---------------------------------------------------------------------


def test_http_fields_schema_and_errors(tmp_path):
    h = Holder(str(tmp_path))
    h.open()
    try:
        hd = Handler(h, Executor(h, device="cpu"))

        def call(method, path, body=""):
            r = hd.handle(method, path, {}, {}, body.encode())
            return r.status, json.loads(r.body)

        assert call("POST", "/index/i")[0] == 200
        opts = {"options": {"fields": [{"name": "val", "min": -100,
                                        "max": 1000}]}}
        assert call("POST", "/index/i/frame/f", json.dumps(opts))[0] == 200
        frames = call("GET", "/schema")[1]["indexes"][0]["frames"]
        assert frames[0]["meta"]["fields"] == [
            {"name": "val", "min": -100, "max": 1000, "bitDepth": 10}]
        for col, v in ((1, 7), (2, -100), (SLICE_WIDTH, 1000)):
            assert call("POST", "/index/i/query",
                        f"SetValue(frame=f, columnID={col}, val={v})") == \
                (200, {"results": [True]})
        assert call("POST", "/index/i/query", 'Sum(frame=f, field="val")') == \
            (200, {"results": [{"value": 907, "count": 3}]})
        assert call("POST", "/index/i/query",
                    'Min(frame=f, field="val") Max(frame=f, field="val") '
                    "Count(Range(frame=f, val >< [0, 999]))")[1] == \
            {"results": [{"value": -100, "count": 1},
                         {"value": 1000, "count": 1}, 1]}
        assert call("POST", "/index/i/query",
                    "SetValue(frame=f, columnID=3, val=1001)")[0] == 422
        assert call("POST", "/index/i/query",
                    "SetValue(frame=f, columnID=3, nope=1)")[0] == 404
        assert call("POST", "/index/i/query",
                    'Max(frame=f, field="nope")')[0] == 404
        # Nothing was written by the refused SetValue.
        assert call("POST", "/index/i/query", 'Sum(frame=f, field="val")') == \
            (200, {"results": [{"value": 907, "count": 3}]})
    finally:
        h.close()
