"""Cost routing (Executor.device_min_work, the `cpu_native` route) against
the JAX package's (pilosa_tpu/executor.py:1880-1990), after
tests/test_serve.py's TestCostRouting.

One seeded directory, written by the JAX package over 96 slices, goes
through the JAX Executor (use_device=True, device_min_work=N) and the
port's (device="cpu", device_min_work=N) for N in {0, 192, 10**9}, with
Counts under (96 work units), at (192) and above (288, 384) the default
threshold and the field aggregates (96 x 12 rows): the answers, the
route each took, its route_reason, the manager's `routed_host` and
explain()'s route and cost_model are equal. Tolerance 0 throughout.
The JAX conftest turns cost routing off for its suite
(PILOSA_TPU_DEVICE_MIN_WORK=0), and the port's default is off; every
executor here opts in with the explicit argument, which beats both.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.bsi import FieldSchema as JaxSchema
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.pql import parse_string as jax_parse

from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.pql import parse_string
from torch_threads import one_torch_thread  # noqa: F401

NUM_SLICES = 96
VAL = (-1000, 1000)  # 10 planes: 12 rows of the bsi view
ROWS = 12
THRESHOLDS = (0, 192, 10 ** 9)
PAIR = "Count(Intersect(Bitmap(rowID=0), Bitmap(rowID=1)))"
# (query, work units = slices x leaves or field rows)
QUERIES = [
    ("Count(Bitmap(rowID=0))", 96),
    (PAIR, 192),
    ("Count(Union(Bitmap(rowID=0), Bitmap(rowID=1), Bitmap(rowID=2)))",
     288),
    ("Count(Union(Intersect(Bitmap(rowID=0), Bitmap(rowID=1)), "
     "Difference(Bitmap(rowID=2), Bitmap(rowID=3))))", 384),
    ('Sum(frame=f, field="val")', NUM_SLICES * ROWS),
    ('Sum(Bitmap(rowID=0), frame=f, field="val")', NUM_SLICES * ROWS),
    ('Max(frame=f, field="val")', NUM_SLICES * ROWS),
    ('Min(Bitmap(rowID=1), frame=f, field="val")', NUM_SLICES * ROWS),
]


def write_data(path):
    """Rows 0-3 of `general`: 40 random columns in each of the 96 slices;
    field `val` of frame `f`: 200 columns over the slices."""
    rng = np.random.default_rng(1802)
    h = JaxHolder(str(path))
    h.open()
    idx = h.create_index_if_not_exists("i")
    g = idx.create_frame_if_not_exists("general")
    f = idx.create_frame_if_not_exists("f")
    f.create_field_if_not_exists(JaxSchema("val", *VAL))
    for r in range(4):
        cols = (np.arange(NUM_SLICES)[:, None] * SLICE_WIDTH
                + rng.choice(4096, size=(NUM_SLICES, 40))).reshape(-1)
        cols = np.unique(cols)
        g.import_bits(np.full(cols.size, r), cols)
    for c in rng.choice(NUM_SLICES * SLICE_WIDTH, size=200, replace=False):
        f.set_value("val", int(c), int(rng.integers(VAL[0], VAL[1] + 1)))
    h.close()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("routing")
    write_data(root / "seed")
    return root


def plain(v):
    return dict(v) if isinstance(v, dict) else v


def drive(make, parse, path, n):
    """explain() then execute each query on a fresh executor of the
    package (`make(holder, n)`); per query its answer, explain's call,
    the routes recorded and the manager's routed_host moved."""
    out = []
    h = make.holder(str(path))
    h.open()
    try:
        for q, _units in QUERIES:
            ex = make(h, n)
            info = ex.explain("i", parse(q))["calls"][0]
            before = dict(ex.route_stats)
            ans = plain(ex.execute("i", parse(q))[0])
            routes = {k: v - before.get(k, 0)
                      for k, v in dict(ex.route_stats).items()
                      if v != before.get(k, 0)}
            out.append({"answer": ans, "explain": info, "routes": routes,
                        "routed_host": ex.mesh_manager().stats.get(
                            "routed_host", 0)})
    finally:
        h.close()
    return out


def jax_make(h, n):
    return JaxExecutor(h, use_device=True, device_min_work=n)


def port_make(h, n):
    return Executor(h, device="cpu", device_min_work=n)


jax_make.holder = JaxHolder
port_make.holder = Holder


@pytest.fixture(scope="module", params=THRESHOLDS, ids=lambda n: f"N{n}")
def both(request, data, tmp_path_factory):
    n = request.param
    base = tmp_path_factory.mktemp(f"routing_{n}")
    shutil.copytree(data / "seed", base / "jax")
    shutil.copytree(data / "seed", base / "port")
    # The port's environment as the JAX suite's (its conftest sets
    # PILOSA_TPU_DEVICE_MIN_WORK=0): the explicit argument routes, the
    # environment shows in kill_switches.
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PILOSA_TORCH_DEVICE_MIN_WORK",
                  os.environ.get("PILOSA_TPU_DEVICE_MIN_WORK", ""))
        return (n, drive(jax_make, jax_parse, base / "jax", n),
                drive(port_make, parse_string, base / "port", n))


@pytest.mark.parametrize("i", range(len(QUERIES)),
                         ids=[f"q{i}" for i in range(len(QUERIES))])
def test_routes_and_answers_equal_jax(both, i):
    n, jax_out, port_out = both
    j, t = jax_out[i], port_out[i]
    assert t["answer"] == j["answer"], QUERIES[i][0]
    assert t["routes"] == j["routes"]
    assert t["routed_host"] == j["routed_host"]
    for key in ("route", "route_reason", "cost_model"):
        assert t["explain"].get(key) == j["explain"].get(key), key
    units = QUERIES[i][1]
    want = (None if n <= 0 else "min_work" if units < n else "cpu_native")
    assert t["explain"].get("route_reason") == want
    assert t["explain"]["cost_model"]["work_units"] == units
    assert t["routed_host"] == (want is not None)


def test_kill_switches_equal_jax(both):
    _n, jax_out, port_out = both
    for j, t in zip(jax_out, port_out):
        if t["explain"]["call"] == "Count":
            assert t["explain"]["kill_switches"] == j["explain"][
                "kill_switches"] == ["device_min_work=0"]


# -- TestCostRouting, case by case -------------------------------------------

BITS = [(1, c) for c in range(50)] + [(2, c) for c in range(0, 50, 2)]


@pytest.fixture
def holders(tmp_path):
    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    f = jh.create_index_if_not_exists("i").create_frame_if_not_exists(
        "general")
    for row, col in BITS:
        f.set_bit(row, col)
    jh.close()
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jh, th = JaxHolder(str(tmp_path / "jax")), Holder(str(tmp_path / "port"))
    jh.open()
    th.open()
    yield jh, th
    jh.close()
    th.close()


def q(ex, pql, parse=parse_string):
    return ex.execute("i", parse(pql))


def test_small_query_routes_to_host(holders):
    jh, th = holders
    pql = "Count(Intersect(Bitmap(rowID=1), Bitmap(rowID=2)))"
    je = JaxExecutor(jh, use_device=True, device_min_work=192)
    te = Executor(th, device="cpu", device_min_work=192)
    assert q(je, pql, jax_parse) == q(te, pql) == [25]
    for ex in (je, te):
        stats = ex.mesh_manager().stats
        assert stats["routed_host"] == 1
        assert stats.get("count", 0) == 0  # the card never served it
    assert te.stats["count_host"] == 1


def test_large_query_stays_on_device(holders, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_CPU_ROUTE_NATIVE", "off")
    monkeypatch.setenv("PILOSA_TORCH_CPU_ROUTE_NATIVE", "off")
    jh, th = holders
    je = JaxExecutor(jh, use_device=True, device_min_work=1)
    te = Executor(th, device="cpu", device_min_work=1)
    assert q(je, "Count(Bitmap(rowID=1))", jax_parse) == q(
        te, "Count(Bitmap(rowID=1))") == [50]
    for ex in (je, te):
        assert ex.mesh_manager().stats.get("routed_host", 0) == 0
        assert ex.mesh_manager().stats["count"] == 1
    assert te.stats["count_device"] == 1
    assert te._cpu_native_routes() is False


@pytest.mark.parametrize("value", ["0", "OFF"])
def test_cpu_native_off_through_the_env(holders, monkeypatch, value):
    monkeypatch.setenv("PILOSA_TORCH_CPU_ROUTE_NATIVE", value)
    _jh, th = holders
    te = Executor(th, device="cpu", device_min_work=1)
    assert q(te, "Count(Bitmap(rowID=1))") == [50]
    assert te.stats["count_device"] == 1
    info = te.explain("i", parse_string("Count(Bitmap(rowID=1))"))
    call = info["calls"][0]
    assert call["route"] == "mesh"
    assert call["cost_model"]["cpu_native_routes"] is False
    assert f"cpu_route_native={value}" in call["kill_switches"]


def test_large_query_routes_to_host_on_the_cpu(holders):
    jh, th = holders
    pql = "Count(Intersect(Bitmap(rowID=1), Bitmap(rowID=2)))"
    je = JaxExecutor(jh, use_device=True, device_min_work=1)
    te = Executor(th, device="cpu", device_min_work=1)
    assert q(je, pql, jax_parse) == q(te, pql) == [25]
    for ex in (je, te):
        assert ex.mesh_manager().stats["routed_host"] == 1
        assert ex.mesh_manager().stats.get("count", 0) == 0
    call = te.explain("i", parse_string(pql))["calls"][0]
    assert (call["route"], call["route_reason"]) == ("host-fold",
                                                     "cpu_native")


def test_cpu_native_routing_skips_the_card(holders):
    """On a card the above-threshold Count is not routed, and the verdict
    is kept (the JAX package's test_backend_aware_routing_skips_tpu)."""
    _jh, th = holders
    te = Executor(th, device="cpu", device_min_work=1)
    te.device = torch.device("cuda")  # the verdict reads the device only
    assert not te._would_route_to_host(1, 1)
    te.device = torch.device("cpu")
    assert not te._would_route_to_host(1, 1)


def test_zero_threshold_disables_routing(holders):
    jh, th = holders
    je = JaxExecutor(jh, use_device=True)  # conftest: env 0
    te = Executor(th, device="cpu")  # the default: off
    assert q(je, "Count(Bitmap(rowID=1))", jax_parse) == q(
        te, "Count(Bitmap(rowID=1))") == [50]
    for ex in (je, te):
        assert ex.mesh_manager().stats.get("routed_host", 0) == 0
        assert ex.mesh_manager().stats["count"] == 1


def test_env_threshold(holders, monkeypatch):
    jh, th = holders
    monkeypatch.setenv("PILOSA_TPU_DEVICE_MIN_WORK", "64")
    monkeypatch.setenv("PILOSA_TORCH_DEVICE_MIN_WORK", "64")
    je, te = JaxExecutor(jh, use_device=True), Executor(th, device="cpu")
    assert q(je, "Count(Bitmap(rowID=1))", jax_parse) == q(
        te, "Count(Bitmap(rowID=1))") == [50]
    for ex in (je, te):
        assert ex.mesh_manager().stats["routed_host"] == 1


@pytest.mark.parametrize("arg,env,want", [
    (None, None, None), (None, "64", 64), (None, "junk", None),
    (None, "-1", -1), (7, "64", 7), (0, "64", 0), (None, "0", 0)])
def test_threshold_resolution_order(holders, monkeypatch, arg, env, want):
    """The argument, then the environment, then the default, in both
    packages (want None: the default, 192 in the JAX package and 0, off,
    in the port)."""
    jh, th = holders
    for name in ("PILOSA_TPU_DEVICE_MIN_WORK", "PILOSA_TORCH_DEVICE_MIN_WORK"):
        if env is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, env)
    je = JaxExecutor(jh, use_device=True, device_min_work=arg)
    te = Executor(th, device="cpu", device_min_work=arg)
    if want is None:
        assert (je._min_work(), te._min_work()) == (192, 0)
    else:
        assert je._min_work() == te._min_work() == want
    assert (JaxExecutor._DEFAULT_MIN_WORK, Executor._DEFAULT_MIN_WORK) == (
        192, 0)


def test_negative_threshold_disables_routing(holders):
    _jh, th = holders
    te = Executor(th, device="cpu", device_min_work=-5)
    assert q(te, "Count(Bitmap(rowID=1))") == [50]
    assert te.stats["count_device"] == 1


def test_routed_count_goes_through_count_host(holders, monkeypatch):
    """A routed Count folds on HostCountPlan through _count_host, the one
    host Count seam, with its lowered tree."""
    _jh, th = holders
    calls = []
    real = Executor._count_host

    def spy(self, index, child, slices, lowered=None):
        calls.append(lowered is not None)
        return real(self, index, child, slices, lowered)

    monkeypatch.setattr(Executor, "_count_host", spy)
    te = Executor(th, device="cpu", device_min_work=192)
    assert q(te, "Count(Intersect(Bitmap(rowID=1), Bitmap(rowID=2)))") == [25]
    assert calls == [True]
    assert te.route_stats.get("count_host-fold") == 1


def test_routed_sum_goes_to_bsi_host(tmp_path):
    write_data(tmp_path / "seed")
    shutil.copytree(tmp_path / "seed", tmp_path / "port")
    th = Holder(str(tmp_path / "port"))
    th.open()
    try:
        te = Executor(th, device="cpu", device_min_work=10 ** 9)
        ref = Executor(th, device="cpu", device_min_work=0)
        pql = 'Sum(frame=f, field="val")'
        assert q(te, pql) == q(ref, pql)
        assert te.stats["bsi_host"] == 1 and te.stats["bsi_device"] == 0
        assert ref.stats["bsi_device"] == 1
        assert te.mesh_manager().stats["routed_host"] == 1
        assert te.route_stats.get("count_bsi-host") == 1
        assert te.mesh_manager().stats.get("kernel:pair_count_rows", 0) == 0
        call = te.explain("i", parse_string(pql))["calls"][0]
        assert (call["route"], call["route_reason"]) == ("bsi-host",
                                                         "min_work")
        assert call["bsi"] == {"field": "val", "planes": 10, "rows": ROWS}
    finally:
        th.close()


def test_explain_reports_a_bad_aggregate_instead_of_raising(holders):
    jh, th = holders
    pql = 'Sum(frame=nosuch, field="val")'
    je = JaxExecutor(jh, use_device=True, device_min_work=192)
    te = Executor(th, device="cpu", device_min_work=192)
    j = je.explain("i", jax_parse(pql))["calls"][0]
    t = te.explain("i", parse_string(pql))["calls"][0]
    assert t["route"] == j["route"] == "error"
