"""The port's card-memory governor against the JAX package's.

The cases of tests/test_device_resilience.py, tests/test_serve.py's
TestHbmBudgetEviction and tests/test_sparse_format.py's TestMixedEviction,
one for one: each scripted sequence runs through the JAX executor (its
8-virtual-device CPU mesh, Pallas in interpret mode) and through the
port's Executor(device="cpu"), each on its own directory seeded the same
way, and the two must give equal answers, the same views resident in
the same use order after every step (so the same evictions; budgets in
each package's own view bytes) and equal governor counters: evicted,
evicted_budget, evicted_oom, oom_retries, fallback_oom,
fallback_hbm_infeasible, fallback_quarantined, plan_quarantined and
routed_host. The JAX executor runs with PILOSA_TPU_LONE_FUSED=off: its
lone fused path launches a Count a second way after a failed first
one, which the port (one launch path) has not, so with it on every
fault would fire twice as often there.

Also here: the port's staging estimate against the JAX package's on a
one-device mesh (the port's is smaller by exactly 4 bytes a key slot:
its keys stay on the host), the quarantine's TTL semantics, the fault
seams, the release of an evicted view's tensors (a weakref to its pool
dies once its last query ends), a restage that frees the old image
before the new one is allocated, the batch thread keeping an
out-of-memory error's type, and a kernel error that is not about
memory propagating instead of being answered on the host.
"""

import threading
import time
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu import fault as jfault
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.core.fragment import MUTATION_EPOCH as JAX_EPOCH
from pilosa_tpu.executor import Executor as JaxExecutor
from pilosa_tpu.parallel import mesh as jmesh
from pilosa_tpu.parallel.plan import CompiledPlanCache
from pilosa_tpu.parallel.serve import MeshManager as JaxMeshManager
from pilosa_tpu.pql import parse_string as jax_parse

from pilosa_tpu_torch import fault as tfault
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.core.fragment import MUTATION_EPOCH
from pilosa_tpu_torch.errors import DeviceResourceError
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.ops.pool import (CONTAINER_WORDS, ROW_SPAN,
                                       pack_bitmap, pack_sparse)
from pilosa_tpu_torch.parallel import mesh as tmesh
from pilosa_tpu_torch.parallel import serve as tserve
from pilosa_tpu_torch.parallel.plan import PlanQuarantine
from pilosa_tpu_torch.pql import parse_string
from torch_threads import one_torch_thread  # noqa: F401

GOV = ("evicted", "evicted_budget", "evicted_oom", "oom_retries",
       "fallback_oom", "fallback_hbm_infeasible", "fallback_quarantined",
       "plan_quarantined", "routed_host")

JAX = SimpleNamespace(
    name="jax", Holder=JaxHolder, parse=jax_parse, fault=jfault,
    make=lambda h, cfg: JaxExecutor(h, use_device=True, mesh_config=cfg),
    # A minimal view on the 8-device mesh: 1 slice pads to 8, each of
    # ROW_SPAN slots holds its words and a 4-byte key.
    view=8 * ROW_SPAN * (CONTAINER_WORDS * 4 + 4),
    budget_env=("PILOSA_TPU_HBM_BUDGET_MB", "0"),
    bump=JAX_EPOCH.bump_structural)
PORT = SimpleNamespace(
    name="port", Holder=Holder, parse=parse_string, fault=tfault,
    make=lambda h, cfg: Executor(h, device="cpu", mesh_config=cfg),
    # One slice of ROW_SPAN slots of words (the keys stay on the host),
    # and the 64-byte index row K3 keeps for the one-container row these
    # fixtures count.
    view=ROW_SPAN * CONTAINER_WORDS * 4 + 64,
    budget_env=(tserve.BUDGET_ENV, "0"),
    bump=MUTATION_EPOCH.bump)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_LONE_FUSED", "off")
    for f in (jfault, tfault):
        f.reset(seed=0)
    yield
    for f in (jfault, tfault):
        f.reset(seed=0)


def both(fn, tmp_path, same: bool = True):
    """fn(pkg, holder) through each package, each on its own holder: the
    two results must be equal. With same=False, {package: result}."""
    got = {}
    for pkg in (JAX, PORT):
        h = pkg.Holder(str(tmp_path / pkg.name))
        h.open()
        try:
            got[pkg.name] = fn(pkg, h)
        finally:
            h.close()
        for f in (jfault, tfault):
            f.reset(seed=0)
    if not same:
        return got
    assert got["port"] == got["jax"]
    return got["port"]


def cfg(budget, **over):
    out = {"hbm_budget_bytes": budget, "hbm_headroom": 0.15,
           "quarantine_after": 2, "quarantine_ttl": 60.0}
    out.update(over)
    return out


def seed(h, index="i", frame="general", bits=()):
    f = h.create_index_if_not_exists(index).create_frame_if_not_exists(frame)
    for row, col in bits:
        f.set_bit(row, col)
    return f


def q(pkg, e, pql, index="i"):
    return e.execute(index, pkg.parse(pql))


def gov(mgr, *extra) -> dict:
    d = dict(mgr.stats.copy())
    return {k: d.get(k, 0) for k in GOV + extra}


def resident(mgr) -> list:
    """The staged views' frames, least recently used first."""
    return [k[1] for k in mgr._views]


def staged_bytes(mgr) -> int:
    return dict(mgr.stats.copy()).get("staged_bytes", 0)


# -- budget accounting ---------------------------------------------------------


def test_estimate_matches_staged_bytes(tmp_path):
    def run(pkg, h):
        seed(h, bits=[(1, 0), (2, SLICE_WIDTH + 5)])
        e = pkg.make(h, cfg(-1))
        assert q(pkg, e, "Count(Bitmap(rowID=1))") == [1]
        mgr = e.mesh_manager()
        sv = mgr._views[("i", "general", "standard")]
        if pkg is JAX:
            bitmaps, _ = mgr._snapshot_fragments("i", "general", "standard",
                                                 sv.num_slices)
            est, pools = mgr._estimate_staged_bytes(bitmaps), \
                mgr._view_bytes(sv)
        else:
            est = tmesh.estimate_staged_bytes(
                [pack_bitmap(h.fragment("i", "general", "standard",
                                        s).storage)
                 for s in range(sv.num_slices)])
            # The port's view bytes also count the index rows K3 read
            # for this Count (64 B a slice), built after the staging.
            pools = tserve._pool_bytes(sv.sharded, sv.sparse)
            assert mgr._view_bytes(sv) == pools + 64 * sv.num_slices
        assert est == pools
        assert mgr._view_bytes(sv) == staged_bytes(mgr)
        return gov(mgr, "stage")

    both(run, tmp_path)


def test_budget_resolution_order(tmp_path, monkeypatch):
    def run(pkg, h):
        env = "PILOSA_TPU_HBM_BUDGET_BYTES" if pkg is JAX else \
            tserve.BUDGET_ENV
        mgr = pkg.make(h, cfg(12345)).mesh_manager()
        out = [mgr._hbm_budget_bytes()]
        monkeypatch.setenv(env, "777")  # only when config leaves it at 0
        mgr._config["hbm_budget_bytes"] = 0
        mgr._budget_resolved = None
        out.append(mgr._hbm_budget_bytes())
        mgr._config["hbm_budget_bytes"] = -1  # negative: unlimited
        out.append(mgr._hbm_budget_bytes())
        mgr._config["hbm_budget_bytes"] = 4096
        mgr._hbm_budget_bytes()
        out.append(dict(mgr.stats.copy())["hbm_budget_bytes"])
        monkeypatch.delenv(env)
        mgr._config["hbm_budget_bytes"] = 0
        mgr._budget_resolved = None
        # No device memory limit on the CPU: 8 GiB.
        out.append(mgr._hbm_budget_bytes())
        return out

    assert both(run, tmp_path) == [12345, 777, -1, 4096, 8 << 30]


def test_lru_eviction_order(tmp_path):
    def run(pkg, h):
        idx = h.create_index_if_not_exists("i")
        for fr in ("f1", "f2", "f3"):
            idx.create_frame_if_not_exists(fr).set_bit(1, 7)
        # Room for two views: staging the third evicts the LRU (f1).
        e = pkg.make(h, cfg(2 * pkg.view))
        trail = []
        for fr in ("f1", "f2", "f3"):
            trail.append(q(pkg, e, f"Count(Bitmap(rowID=1, frame={fr}))"))
            trail.append(resident(e.mesh_manager()))
        mgr = e.mesh_manager()
        assert staged_bytes(mgr) <= 2 * pkg.view
        # Touch f2, then stage f1 again: f3, the least recently used,
        # goes. Fresh rows get past the JAX executor's query memo.
        for pql in ("Count(Bitmap(rowID=2, frame=f2))",
                    "Count(Bitmap(rowID=2, frame=f1))"):
            trail.append(q(pkg, e, pql))
            trail.append(resident(mgr))
        return trail, gov(mgr)

    trail, stats = both(run, tmp_path)
    assert trail[-1] == ["f2", "f1"] and stats["evicted_budget"] == 2


def test_resident_view_not_evicted_by_its_own_restage(tmp_path):
    def run(pkg, h):
        f = seed(h, bits=[(1, 0)])
        e = pkg.make(h, cfg(pkg.view))
        out = [q(pkg, e, "Count(Bitmap(rowID=1))")]
        # A new row: a restage over the view's own slot, which the
        # budget must not count as another view's bytes.
        f.set_bit(ROW_SPAN + 5, 3)
        out.append(q(pkg, e, "Count(Bitmap(rowID=1))"))
        mgr = e.mesh_manager()
        return out, resident(mgr), gov(mgr, "stage")

    out, views, stats = both(run, tmp_path)
    assert views == ["general"] and stats["stage"] == 2


# -- pins ------------------------------------------------------------------------


def test_pinned_views_survive_oom_eviction(tmp_path):
    def run(pkg, h):
        seed(h, bits=[(1, 0)])
        e = pkg.make(h, cfg(-1))
        assert q(pkg, e, "Count(Bitmap(rowID=1))") == [1]
        mgr = e.mesh_manager()
        sv = mgr._views[("i", "general", "standard")]
        sv.pins = 1
        out = [mgr._evict_for_oom(), resident(mgr)]
        sv.pins = 0
        out += [mgr._evict_for_oom(), resident(mgr), staged_bytes(mgr)]
        return out, gov(mgr)

    out, stats = both(run, tmp_path)
    assert out == [0, ["general"], 1, [], 0] and stats["evicted_oom"] == 1


def test_pins_released_after_query(tmp_path):
    def run(pkg, h):
        seed(h, bits=[(1, 0), (2, 1)])
        e = pkg.make(h, cfg(-1))
        out = q(pkg, e, "Count(Intersect(Bitmap(rowID=1), Bitmap(rowID=2)))")
        return out, [sv.pins for sv in e.mesh_manager()._views.values()]

    assert both(run, tmp_path) == ([0], [0])


def test_budget_eviction_skips_pinned(tmp_path):
    def run(pkg, h):
        idx = h.create_index_if_not_exists("i")
        for fr in ("f1", "f2", "f3"):
            idx.create_frame_if_not_exists(fr).set_bit(1, 7)
        e = pkg.make(h, cfg(2 * pkg.view))
        out = [q(pkg, e, f"Count(Bitmap(rowID=1, frame={fr}))")
               for fr in ("f1", "f2")]
        mgr = e.mesh_manager()
        sv = mgr._views[("i", "f1", "standard")]
        sv.pins = 1  # a query in flight
        try:
            out.append(q(pkg, e, "Count(Bitmap(rowID=1, frame=f3))"))
            # f1 is pinned: f2 goes, though f1 is older.
            out.append(resident(mgr))
        finally:
            sv.pins = 0
        return out, gov(mgr)

    out, _ = both(run, tmp_path)
    assert out[-1] == ["f1", "f3"]


# -- the OOM ladder ------------------------------------------------------------


def test_stage_oom_evicts_and_retries(tmp_path):
    def run(pkg, h):
        seed(h, bits=[(1, 0), (1, SLICE_WIDTH + 2)])
        e = pkg.make(h, cfg(-1))
        pkg.fault.arm("mesh.stage", error=pkg.fault.SimulatedResourceExhausted,
                      times=1)
        return q(pkg, e, "Count(Bitmap(rowID=1))"), gov(e.mesh_manager(),
                                                      "stage")

    out, stats = both(run, tmp_path)
    assert out == [2] and stats["oom_retries"] == 1 and stats["stage"] == 1


def test_exec_oom_recovers_in_request(tmp_path):
    def run(pkg, h):
        seed(h, bits=[(1, 0), (1, 1)])
        e = pkg.make(h, cfg(-1))
        fired0 = pkg.fault.STATS.get("fault.device.exec", 0)
        pkg.fault.arm("device.exec",
                      error=pkg.fault.SimulatedResourceExhausted, times=1)
        out = q(pkg, e, "Count(Bitmap(rowID=1))")
        fired = pkg.fault.STATS.get("fault.device.exec", 0) - fired0
        return out, fired, gov(e.mesh_manager(), "count")

    out, fired, stats = both(run, tmp_path)
    assert out == [2] and fired == 1 and stats["oom_retries"] == 1


def test_persistent_exec_oom_host_folds_correctly(tmp_path):
    def run(pkg, h):
        seed(h, bits=[(1, 0), (1, 1), (2, 1)])
        e = pkg.make(h, cfg(-1, quarantine_after=1000))  # the ladder alone
        pkg.fault.arm("device.exec",
                      error=pkg.fault.SimulatedResourceExhausted)
        out = q(pkg, e, "Count(Intersect(Bitmap(rowID=1), Bitmap(rowID=2)))")
        return out, gov(e.mesh_manager(), "count")

    out, stats = both(run, tmp_path)
    assert out == [1] and stats["fallback_oom"] == 1 and stats["count"] == 0


def test_stage_oom_after_eviction_host_folds(tmp_path):
    """The one counted difference: the JAX package's Count of a view not
    staged yet stages it from its sorted-array probe and, when that
    fails, once more from its dense path, so each of its failed stagings
    runs the ladder twice. The port stages once."""
    def run(pkg, h):
        seed(h, bits=[(1, 0)])
        e = pkg.make(h, cfg(-1))
        pkg.fault.arm("mesh.stage", error=pkg.fault.SimulatedResourceExhausted)
        return q(pkg, e, "Count(Bitmap(rowID=1))"), gov(e.mesh_manager(),
                                                      "stage")

    got = both(run, tmp_path, same=False)
    (out, stats), (jout, jstats) = got["port"], got["jax"]
    assert out == jout == [1] and stats["stage"] == jstats["stage"] == 0
    ladder = ("oom_retries", "fallback_oom")
    assert {k: 2 * v for k, v in stats.items() if k in ladder} == \
        {k: v for k, v in jstats.items() if k in ladder} == \
        {"oom_retries": 2, "fallback_oom": 2}
    assert {k: v for k, v in stats.items() if k not in ladder} == \
        {k: v for k, v in jstats.items() if k not in ladder}


# -- infeasible views ----------------------------------------------------------


def test_budget_below_one_view_host_folds(tmp_path):
    """The first Count finds the view over the budget when it stages it
    (the JAX package: twice, from its sorted-array probe and its dense
    path, as in test_stage_oom_after_eviction_host_folds); the later
    ones at the executor's routing peek, once each in both."""
    def run(pkg, h):
        seed(h, bits=[(1, 0), (1, SLICE_WIDTH + 2)])
        e = pkg.make(h, cfg(1000))  # below any view
        out = [q(pkg, e, f"Count(Bitmap(rowID={r}))") for r in (1, 2, 3)]
        mgr = e.mesh_manager()
        return out, gov(mgr, "stage"), staged_bytes(mgr)

    got = both(run, tmp_path, same=False)
    (out, stats, staged), (jout, jstats, jstaged) = got["port"], got["jax"]
    assert out == jout == [[2], [0], [0]] and staged == jstaged == 0
    assert stats.pop("fallback_hbm_infeasible") == 3
    assert jstats.pop("fallback_hbm_infeasible") == 4
    assert stats == jstats and stats["stage"] == 0
    assert stats["routed_host"] == 2


def test_routing_peek_skips_doomed_stage(tmp_path):
    def run(pkg, h):
        seed(h, bits=[(1, 0)])
        e = pkg.make(h, cfg(1000))
        out = [q(pkg, e, "Count(Bitmap(rowID=1))")]  # builds the manager
        routed0 = gov(e.mesh_manager())["routed_host"]
        out.append(q(pkg, e, "Count(Bitmap(rowID=2))"))
        # The second Count routes at the executor's peek.
        out.append(gov(e.mesh_manager())["routed_host"] - routed0)
        return out

    assert both(run, tmp_path) == [[1], [0], 1]


def test_infeasible_cache_invalidated_by_writes(tmp_path):
    def run(pkg, h):
        f = seed(h, bits=[(1, 0)])
        e = pkg.make(h, cfg(1000))
        out = [q(pkg, e, "Count(Bitmap(rowID=1))")]
        mgr = e.mesh_manager()
        leaves = [("general", "standard", 1, True)]
        out.append(mgr.stage_infeasible("i", leaves, 1))
        # A larger budget: the verdict flips once a write moves the
        # epoch the memo is kept against.
        mgr._config["hbm_budget_bytes"] = 10 * pkg.view
        mgr._budget_resolved = None
        f.set_bit(3, 3)
        out.append(mgr.stage_infeasible(
            "i", leaves, h.index("i").max_slice() + 1))
        return out

    assert both(run, tmp_path) == [[1], True, False]


# -- plan quarantine -----------------------------------------------------------


@pytest.mark.parametrize("cls", [CompiledPlanCache, PlanQuarantine])
def test_quarantine_ttl_expiry(cls):
    c = cls()
    c.quarantine("sigA", ttl_s=60.0, now=1000.0)
    assert c.is_quarantined("sigA", now=1030.0)
    assert c.quarantined_sigs(now=1030.0) == ["sigA"]
    assert not c.is_quarantined("sigA", now=1061.0)
    assert c.quarantined_sigs(now=1061.0) == []
    assert c.stats["quarantined"] == 1
    c.quarantine("sigB", ttl_s=1.0, now=0.0)
    c.quarantine("sigC", ttl_s=1.0, now=0.0)
    assert c.clear_quarantine("sigB") == 1 and c.clear_quarantine() == 1


def test_repeated_failures_quarantine_plan(tmp_path):
    def run(pkg, h):
        seed(h, bits=[(1, 0), (1, 1)])
        e = pkg.make(h, cfg(-1, quarantine_after=2))
        pkg.fault.arm("device.exec",
                      error=pkg.fault.SimulatedResourceExhausted)
        # Fresh rows, one plan signature: every query still answers,
        # on the host once the device path fails.
        out = [q(pkg, e, f"Count(Bitmap(rowID={r}))") for r in (1, 2, 3, 4)]
        mgr = e.mesh_manager()
        out.append(len(mgr.quarantined_plans()))
        # A quarantined plan skips the card: the seam stops firing.
        fired = pkg.fault.STATS["fault.device.exec"]
        out.append(q(pkg, e, "Count(Bitmap(rowID=9))"))
        out.append(pkg.fault.STATS["fault.device.exec"] - fired)
        return out, gov(mgr)

    out, stats = both(run, tmp_path)
    assert out == [[2], [0], [0], [0], 1, [0], 0]
    assert stats["plan_quarantined"] == 1
    assert stats["fallback_quarantined"] == 3


def test_clear_quarantine_restores_device_path(tmp_path):
    def run(pkg, h):
        seed(h, bits=[(1, 0)])
        e = pkg.make(h, cfg(-1, quarantine_after=1))
        pkg.fault.arm("device.exec",
                      error=pkg.fault.SimulatedResourceExhausted, times=4)
        out = [q(pkg, e, "Count(Bitmap(rowID=1))")]
        mgr = e.mesh_manager()
        out += [len(mgr.quarantined_plans()), mgr.clear_quarantine(),
                mgr.quarantined_plans()]
        pkg.fault.reset(seed=0)
        out.append(q(pkg, e, "Count(Bitmap(rowID=2))"))
        return out, gov(mgr, "count")

    out, stats = both(run, tmp_path)
    assert out == [[1], 1, 1, [], [0]] and stats["count"] == 1


def test_explain_shows_quarantine(tmp_path):
    def run(pkg, h):
        seed(h, bits=[(1, 0)])
        e = pkg.make(h, cfg(-1, quarantine_after=1))
        pkg.fault.arm("device.exec",
                      error=pkg.fault.SimulatedResourceExhausted, times=4)
        assert q(pkg, e, "Count(Bitmap(rowID=1))") == [1]
        info = e.explain("i", pkg.parse("Count(Bitmap(rowID=2))"))
        call = info["calls"][0]
        plan = call["plan_cache"] if pkg is JAX else call["plan"]
        return call["route"], call["route_reason"], plan["quarantined"]

    assert both(run, tmp_path) == ("host-fold", "quarantined", True)


# -- the fault seams -------------------------------------------------------------


def test_prob_schedule_deterministic():
    def run(f):
        f.reset(seed=1234)
        f.arm("device.exec", error=ValueError, prob=0.5)
        pattern = []
        for _ in range(32):
            try:
                f.point("device.exec", sig="s", kind="count")
                pattern.append(0)
            except ValueError:
                pattern.append(1)
        return pattern

    first = run(tfault)
    assert first == run(tfault) == run(jfault)  # one seeded schedule
    assert 0 < sum(first) < 32
    with pytest.raises(ValueError):
        tfault.arm("client.do")  # only the card's two seams


def test_stage_seam_carries_context(tmp_path):
    def run(pkg, h):
        seed(h, bits=[(1, 0)])
        e = pkg.make(h, cfg(-1))
        fired0 = pkg.fault.STATS.get("fault.mesh.stage", 0)
        # A rule for another frame does not fire.
        pkg.fault.arm("mesh.stage", error=pkg.fault.SimulatedResourceExhausted,
                      frame="other")
        out = q(pkg, e, "Count(Bitmap(rowID=1))")
        return (out, pkg.fault.STATS.get("fault.mesh.stage", 0) - fired0,
                gov(e.mesh_manager()))

    out, fired, stats = both(run, tmp_path)
    assert out == [1] and fired == 0 and stats["oom_retries"] == 0


def test_simulated_oom_is_torch_oom():
    import torch

    err = tfault.SimulatedResourceExhausted()
    assert isinstance(err, torch.cuda.OutOfMemoryError)
    assert tserve._is_oom(err)
    try:
        raise RuntimeError("wrapped") from err
    except RuntimeError as wrapped:
        assert tserve._is_oom(wrapped)
    assert not tserve._is_oom(RuntimeError("illegal address"))


# -- the residency report --------------------------------------------------------


def test_device_memory_report_fields(tmp_path):
    def run(pkg, h):
        seed(h, bits=[(1, 0), (2, SLICE_WIDTH + 1)])
        e = pkg.make(h, cfg(-1))
        assert q(pkg, e, "Count(Bitmap(rowID=1))") == [1]
        mgr = e.mesh_manager()
        dm = mgr.device_memory()
        return (dm["views"], dm["padded_bytes"] == staged_bytes(mgr),
                0 < dm["live_bytes"] <= dm["padded_bytes"],
                sum(dm["per_device"].values()) == dm["padded_bytes"],
                0 < dm["residency_ratio"] <= 1.0)

    assert both(run, tmp_path) == (1, True, True, True, True)


def test_device_memory_consistent_under_concurrent_staging(tmp_path):
    """A scrape racing restages, scatters and invalidations reads one
    residency generation: per-device totals equal the padded total."""
    def run(pkg, h):
        f = seed(h, bits=[(1, 0)])
        e = pkg.make(h, cfg(-1))
        assert q(pkg, e, "Count(Bitmap(rowID=1))") == [1]
        mgr = e.mesh_manager()
        stop = threading.Event()
        errors: list = []

        def churn():
            col = 1
            try:
                while not stop.is_set():
                    f.set_bit(1 + col % 3, col % SLICE_WIDTH)
                    col += 97
                    with mgr._mu:  # the port's refresh runs under _mu
                        mgr.refresh("i", "general", "standard", 1)
                    if col % 13 == 0:
                        mgr.invalidate("i")
            except Exception as ex:  # noqa: BLE001 — asserted below
                errors.append(ex)

        t = threading.Thread(target=churn, daemon=True)
        t.start()
        deadline = time.monotonic() + 1.0
        samples = torn = 0
        try:
            while time.monotonic() < deadline:
                dm = mgr.device_memory()
                torn += (sum(dm["per_device"].values()) != dm["padded_bytes"]
                         or dm["live_bytes"] > dm["padded_bytes"])
                samples += 1
        finally:
            stop.set()
            t.join(timeout=10)
        return not t.is_alive(), errors, torn, samples > 50

    assert both(run, tmp_path) == (True, [], 0, True)


# -- a herd under the budget ---------------------------------------------------


def test_concurrent_herd_under_budget(tmp_path):
    """Six workers over four frames, a budget of two views: no errors,
    exact answers, evictions, no pin left, residency within the budget."""
    def run(pkg, h):
        idx = h.create_index_if_not_exists("i")
        frames = ["f1", "f2", "f3", "f4"]
        for fr in frames:
            fo = idx.create_frame_if_not_exists(fr)
            fo.set_bit(1, 3)
            fo.set_bit(1, 9)
        e = pkg.make(h, cfg(2 * pkg.view))
        errors: list = []
        wrong: list = []

        def worker(wid):
            try:
                for i in range(12):
                    fr = frames[(wid + i) % len(frames)]
                    row, want = ((1, [2]) if i % 2 == 0
                                 else (100 + wid * 100 + i, [0]))
                    out = q(pkg, e, f"Count(Bitmap(rowID={row}, frame={fr}))")
                    if out != want:
                        wrong.append((fr, row, out))
            except Exception as ex:  # noqa: BLE001 — asserted below
                errors.append(ex)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        mgr = e.mesh_manager()
        return (any(t.is_alive() for t in threads), errors, wrong,
                gov(mgr)["evicted_budget"] >= 1,
                all(sv.pins == 0 for sv in mgr._views.values()),
                staged_bytes(mgr) <= 2 * pkg.view,
                q(pkg, e, "Count(Bitmap(rowID=1, frame=f1))"))

    assert both(run, tmp_path) == (False, [], [], True, True, True, [2])


# -- tests/test_serve.py TestHbmBudgetEviction -----------------------------------


def seed_blocks(h, frames):
    """Rows 1 and 2 in all 16 blocks of slice 0 of each frame."""
    idx = h.create_index_if_not_exists("i")
    for fr in frames:
        f = idx.create_frame_if_not_exists(fr)
        for blk in range(16):
            f.set_bit(1, blk * 65536 + 3)
            f.set_bit(2, blk * 65536 + 3)


def test_lru_eviction_and_restage(tmp_path):
    def run(pkg, h):
        seed_blocks(h, ["f1", "f2", "f3"])
        e = pkg.make(h, {})
        mgr = e.mesh_manager()

        def pql(fr):
            pkg.bump()  # past the JAX executor's query memo
            return (f"Count(Intersect(Bitmap(rowID=1, frame={fr}), "
                    f"Bitmap(rowID=2, frame={fr})))")

        trail = [q(pkg, e, pql("f1"))]
        one = mgr._view_bytes(next(iter(mgr._views.values())))
        mgr._config["hbm_budget_bytes"] = 2 * one + one // 2
        for fr in ("f2", "f3", "f1"):
            trail += [q(pkg, e, pql(fr)), resident(mgr),
                      gov(mgr)["evicted"]]
        return trail

    assert both(run, tmp_path) == [[16], [16], ["f1", "f2"], 0,
                                   [16], ["f2", "f3"], 1,
                                   [16], ["f3", "f1"], 2]


def test_multi_frame_query_not_thrashed(tmp_path):
    """A tree over more frames than the budget holds runs over it, with
    no eviction from under its own resolution, and repeats without a
    restage."""
    def run(pkg, h):
        seed_blocks(h, ["f1", "f2", "f3"])
        e = pkg.make(h, {})
        mgr = e.mesh_manager()
        q3 = ("Count(Union(Bitmap(rowID=1, frame=f1), "
              "Bitmap(rowID=1, frame=f2), Bitmap(rowID=1, frame=f3)))")
        out = [q(pkg, e, q3)]
        one = mgr._view_bytes(next(iter(mgr._views.values())))
        mgr._config["hbm_budget_bytes"] = 2 * one + one // 2
        mgr.invalidate()
        for _ in range(2):
            pkg.bump()
            out += [q(pkg, e, q3), resident(mgr)]
        return out, gov(mgr, "stage")

    out, stats = both(run, tmp_path)
    assert out[-1] == ["f1", "f2", "f3"]
    assert stats["evicted"] == 0 and stats["stage"] == 6


def test_zero_budget_disables_eviction(tmp_path, monkeypatch):
    def run(pkg, h):
        seed_blocks(h, ["f1", "f2", "f3"])
        monkeypatch.setenv(*pkg.budget_env)
        e = pkg.make(h, {})
        out = [q(pkg, e, f"Count(Bitmap(rowID=1, frame={fr}))")
               for fr in ("f1", "f2", "f3")]
        return out, resident(e.mesh_manager()), gov(e.mesh_manager())

    out, views, stats = both(run, tmp_path)
    assert views == ["f1", "f2", "f3"] and stats["evicted"] == 0


# -- tests/test_sparse_format.py TestMixedEviction -------------------------------


def seed_frame(h, frame, sparse: bool, seed_: int, slices: int = 1):
    """Rows 1-3 of `frame`: sparse, 200 values in each of 16 containers
    of every slice (a fill of 0.3%, sorted-array at 0.05); dense, 40,000
    in each (bitmaps)."""
    rng = np.random.default_rng(seed_)
    f = h.create_index_if_not_exists("i").create_frame_if_not_exists(frame)
    per = 200 if sparse else 40_000
    rows, cols = [], []
    for s in range(slices):
        for r in (1, 2, 3):
            for b in range(16):
                c = rng.choice(65536, size=per, replace=False)
                rows.append(np.full(per, r, dtype=np.uint64))
                cols.append((s * SLICE_WIDTH + b * 65536 + c).astype(
                    np.uint64))
    view = f.create_view_if_not_exists("standard")
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    for s in range(slices):
        sel = (cols // SLICE_WIDTH) == s
        view.create_fragment_if_not_exists(s).import_bits(rows[sel],
                                                          cols[sel])
    return f


def test_mixed_format_eviction_under_budget(tmp_path):
    """Round robin over sorted-array and dense frames under a budget that
    cannot hold them all: exact answers, the byte ledger charges the
    sorted-array pools their own bytes, and residency stays within the
    budget."""
    frames = ["sp1", "sp2", "dn1", "dn2"]

    def run(pkg, h):
        for i, fr in enumerate(frames):
            seed_frame(h, fr, fr.startswith("sp"), 3 + i)
        probe = pkg.make(h, {"hbm_budget_bytes": -1})
        want = [q(pkg, probe, f"Count(Bitmap(rowID=1, frame={fr}))")
                for fr in frames]
        mgr = probe.mesh_manager()
        per_view = {k[1]: mgr._view_bytes(v) for k, v in mgr._views.items()}
        small = per_view["sp1"] < per_view["dn1"]
        budget = int(sum(per_view.values()) - per_view["dn1"] // 2)
        e = pkg.make(h, {"hbm_budget_bytes": budget})
        trail = []
        for i in range(12):
            fr = frames[i % len(frames)]
            pkg.bump()  # past the JAX executor's query memo
            trail.append(q(pkg, e, f"Count(Bitmap(rowID=1, frame={fr}))")
                         == want[i % len(frames)])
            trail.append(resident(e.mesh_manager()))
        smgr = e.mesh_manager()
        dm = smgr.device_memory()
        return (small, trail, gov(smgr)["evicted_budget"] > 0,
                staged_bytes(smgr) <= budget, dm["padded_bytes"] <= budget,
                0 < dm["residency_ratio"] <= 1.0)

    small, trail, *checks = both(run, tmp_path)
    assert small and all(checks) and all(trail[0::2])


# -- the staging estimate against the JAX package's ----------------------------

FIXTURES = {"dense": ("dn", "dn"), "sparse": ("sp", "sp"),
            "mixed": ("sp", "dn")}


@pytest.mark.parametrize("threshold", [0.0, 0.05])
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_estimate_is_jax_one_device_less_key_bytes(tmp_path, fixture,
                                                   threshold):
    """The port's estimate of a two-slice view (slice 0 and slice 1 of
    the fixture's kinds) equals the JAX package's on a one-device mesh
    less 4 bytes a key slot, dense and sorted-array; it equals what the
    port's staging allocates and the stats-only figure of the routing
    peek."""
    def kinds(h):
        rng = np.random.default_rng(11)
        f = h.create_index_if_not_exists("i").create_frame_if_not_exists(
            "f")
        view = f.create_view_if_not_exists("standard")
        for s, kind in enumerate(FIXTURES[fixture]):
            per = 200 if kind == "sp" else 40_000
            rows, cols = [], []
            for r in (1, 2, 3):
                for b in range(5 + s):
                    c = rng.choice(65536, size=per, replace=False)
                    rows.append(np.full(per, r, dtype=np.uint64))
                    cols.append((s * SLICE_WIDTH + b * 65536 + c).astype(
                        np.uint64))
            view.create_fragment_if_not_exists(s).import_bits(
                np.concatenate(rows), np.concatenate(cols))

    jh = JaxHolder(str(tmp_path / "jax"))
    jh.open()
    try:
        kinds(jh)
        jmgr = JaxMeshManager(jh, mesh=jmesh.default_mesh(1))
        bitmaps, _ = jmgr._snapshot_fragments("i", "f", "standard", 2)
        jfmt = jmesh.pick_slice_formats(jmesh.slice_format_stats(bitmaps),
                                        threshold)
        jax_est = jmgr._estimate_staged_bytes(bitmaps, jfmt)
    finally:
        jh.close()
    th = Holder(str(tmp_path / "port"))
    th.open()
    try:
        kinds(th)
        frags = [th.fragment("i", "f", "standard", s).storage
                 for s in range(2)]
        fmt = tmesh.pick_slice_formats(tmesh.slice_format_stats(frags),
                                       threshold)
        assert fmt.tolist() == jfmt.tolist()
        packed = [pack_sparse(b) if fmt[s] else pack_bitmap(b)
                  for s, b in enumerate(frags)]
        est = tmesh.estimate_staged_bytes(packed, fmt)
        ex = Executor(th, device="cpu", sparse_density_threshold=threshold)
        assert ex.execute("i", parse_string("Count(Bitmap(rowID=1, "
                                            "frame=f))"))[0] > 0
        mgr = ex.mesh_manager()
        sv = mgr._views[("i", "f", "standard")]
        slots = sv.sharded.keys_host.size + (
            sv.sparse.keys_host.size if sv.sparse is not None else 0)
        assert est == tserve._pool_bytes(sv.sharded, sv.sparse)
        assert est == tmesh.format_pool_bytes(
            *tserve.view_stats(th, "i", "f", "standard", 2, threshold))
        assert est == jax_est - 4 * slots
        assert (sv.sparse is not None) == bool(fmt.any())
    finally:
        th.close()


# -- the release of card memory --------------------------------------------------


def port_executor(h, budget=-1, **over):
    return Executor(h, device="cpu", mesh_config=cfg(budget, **over))


def test_evicted_view_freed_when_its_last_query_ends(tmp_path):
    """A view evicted unpinned drops its pool at once, though its
    StagedView object is still referenced; a view dropped while a query
    holds it (invalidate: an index or frame deleted) keeps its pool
    until that query releases its pin."""
    h = Holder(str(tmp_path / "port"))
    h.open()
    try:
        idx = h.create_index_if_not_exists("i")
        for fr in ("f1", "f2", "f3"):
            idx.create_frame_if_not_exists(fr).set_bit(1, 7)
        ex = port_executor(h, budget=PORT.view)  # room for one view
        assert q(PORT, ex, "Count(Bitmap(rowID=1, frame=f1))") == [1]
        mgr = ex.mesh_manager()
        sv1 = mgr._views[("i", "f1", "standard")]
        pool1 = weakref.ref(sv1.sharded.words)
        assert q(PORT, ex, "Count(Bitmap(rowID=1, frame=f2))") == [1]
        assert pool1() is None and sv1.retired  # evicted, freed at once
        pins: list = []
        with mgr._mu:
            sv = mgr.refresh("i", "f2", "standard", 1)
            mgr._pin(sv, pins)  # a query in flight on f2
        pool = weakref.ref(sv.sharded.words)
        mgr.invalidate("i")
        assert not mgr._views and sv.retired  # dropped...
        assert pool() is not None  # ...but held by its query
        mgr._release_pins(pins)
        assert pool() is None and sv.pins == 0
        assert mgr.stats["evicted_budget"] == 1
        assert mgr.device_memory()["views"] == 0
    finally:
        h.close()


@pytest.mark.parametrize("kind", ["dense", "sorted-array"])
def test_restage_frees_old_image_before_new_one(tmp_path, monkeypatch,
                                                kind):
    """A restage drops the old pool before it allocates the new one,
    though the refresh that restages still refers to the old view: the
    restage's peak is one image."""
    h = Holder(str(tmp_path / "port"))
    h.open()
    try:
        f = seed_frame(h, "f", kind != "dense", 5)
        ex = port_executor(h)
        pql = "Count(Bitmap(rowID=1, frame=f))"
        n = q(PORT, ex, pql)
        mgr = ex.mesh_manager()
        sv = mgr._views[("i", "f", "standard")]
        assert (sv.sparse is not None) == (kind != "dense")
        old = weakref.ref(sv.sharded.words if kind == "dense"
                          else sv.sparse.values)
        del sv
        seen = []
        build_name = ("build_sharded_index" if kind == "dense"
                      else "build_sparse_sharded_index")
        real = getattr(tserve, build_name)

        def build(*a, **kw):
            seen.append(old() is None)
            return real(*a, **kw)

        monkeypatch.setattr(tserve, build_name, build)
        f.set_bit(9, 5)  # a new row: a container the image lacks
        assert q(PORT, ex, pql) == n
        assert seen == [True] and mgr.stats["stage"] == 2
    finally:
        h.close()


def jax_counts(tmp_path, queries, bits):
    """The JAX executor's answers to `queries` over a frame of `bits`."""
    h = JaxHolder(str(tmp_path / "jax"))
    h.open()
    try:
        seed(h, bits=bits)
        e = JaxExecutor(h, use_device=True, mesh_config=cfg(-1))
        return [e.execute("i", jax_parse(p))[0] for p in queries]
    finally:
        h.close()


@pytest.mark.parametrize("times", [1, 3, None])
def test_batch_thread_keeps_oom_type(tmp_path, times):
    """Eight threads count at once through the batch thread while launches
    run out of memory: the ladder retries on the card or the host answers,
    and every answer equals the JAX executor's (a batched error that kept
    no type would fail the request)."""
    rng = np.random.default_rng(4)
    bits = [(int(r), int(c)) for r, c in zip(
        rng.integers(0, 4, 400), rng.integers(0, 2 * SLICE_WIDTH, 400))]
    queries = [f"Count(Intersect(Bitmap(rowID={a}), Bitmap(rowID={b})))"
               for a in range(4) for b in range(4) if a != b][:8]
    want = jax_counts(tmp_path, queries, bits)
    h = Holder(str(tmp_path / "port"))
    h.open()
    try:
        seed(h, bits=bits)
        ex = port_executor(h, quarantine_after=1000)
        assert q(PORT, ex, queries[0]) == [want[0]]  # stages the view
        mgr = ex.mesh_manager()
        tfault.arm("device.exec", error=tfault.SimulatedResourceExhausted,
                   times=times)
        mgr._counts_inflight += 1  # a count in flight: no lone path
        got = [None] * len(queries)
        errors: list = []
        barrier = threading.Barrier(len(queries))

        def client(i):
            try:
                barrier.wait(timeout=30)
                got[i] = q(PORT, ex, queries[i])[0]
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        mgr._counts_inflight -= 1
        assert not any(t.is_alive() for t in threads)
        assert errors == [] and got == want
        assert mgr.stats["oom_retries"] >= 1 and mgr.stats["lone"] == 1
        if times is None:
            assert mgr.stats["fallback_oom"] >= 1
            assert ex.stats["count_host"] == len(queries)
    finally:
        h.close()


def test_non_oom_kernel_error_propagates(tmp_path):
    """A kernel error that is not about memory fails the request every
    time: it is not answered on the host, and it takes no strike against
    the plan (the JAX package strikes it, and a plan quarantined after
    the default two strikes would be answered on the host from then on).
    Only a quarantine the ladder sets sends the Count to the host."""
    h = Holder(str(tmp_path / "port"))
    h.open()
    try:
        seed(h, bits=[(1, 0), (2, 0)])
        ex = Executor(h, device="cpu")  # the default quarantine_after
        assert ex.mesh_manager()._config["quarantine_after"] == 2
        pql = "Count(Intersect(Bitmap(rowID=1), Bitmap(rowID=2)))"
        assert q(PORT, ex, pql) == [1]
        mgr = ex.mesh_manager()
        tfault.arm("device.exec", error=RuntimeError("illegal address"))
        fired0 = tfault.STATS["fault.device.exec"]
        for _ in range(3):
            with pytest.raises(RuntimeError, match="illegal address"):
                q(PORT, ex, pql)
        assert tfault.STATS["fault.device.exec"] - fired0 == 3
        assert ex.stats["count_host"] == 0
        assert mgr.stats["oom_retries"] == 0
        assert mgr._plan_failures == {} and mgr.quarantined_plans() == []
        assert mgr.stats["plan_quarantined"] == 0
        # A quarantined plan raises the error the executor folds on.
        sig = '["and", ["leaf", 0], ["leaf", 1]]'
        mgr.quarantine_plan(sig)
        with pytest.raises(DeviceResourceError) as err:
            mgr.count("i", ["and", ["leaf", 0], ["leaf", 1]],
                      [("general", "standard", 1, True),
                       ("general", "standard", 2, True)], [0], 1)
        assert err.value.reason == "quarantined"
    finally:
        h.close()


def test_quarantine_ttl_knob_lifts_quarantine(tmp_path):
    """quarantine_ttl below its default: a plan quarantined by an
    out-of-memory strike serves on the card again once the TTL lapses."""
    def run(pkg, h):
        seed(h, bits=[(1, 0)])
        e = pkg.make(h, cfg(-1, quarantine_after=1, quarantine_ttl=1.0))
        pkg.fault.arm("device.exec",
                      error=pkg.fault.SimulatedResourceExhausted, times=4)
        out = [q(pkg, e, "Count(Bitmap(rowID=1))")]
        mgr = e.mesh_manager()
        out.append(len(mgr.quarantined_plans()))
        pkg.fault.reset(seed=0)
        time.sleep(1.1)
        out += [mgr.quarantined_plans(), q(pkg, e, "Count(Bitmap(rowID=2))")]
        return out, gov(mgr, "count")

    out, stats = both(run, tmp_path)
    assert out == [[1], 1, [], [0]] and stats["count"] == 1


@pytest.mark.parametrize("headroom", [0.15, 0.5])
def test_headroom_knob_sizes_the_probed_budget(tmp_path, monkeypatch,
                                                headroom):
    """hbm_headroom: with no budget configured, the card's budget is its
    total memory less that share (mem_get_info's total, never its free
    figure), probed once."""
    h = Holder(str(tmp_path / "port"))
    h.open()
    try:
        monkeypatch.delenv(tserve.BUDGET_ENV, raising=False)
        mgr = tserve.MeshManager(h, device="cpu",
                                 config={"hbm_headroom": headroom})
        probes = []

        def mem_get_info(device=None):
            probes.append(device)
            return (1 << 30, 80 << 30)  # (free, total)

        monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
        mgr.device = torch.device("cuda", 0)  # the probe alone runs
        want = int((80 << 30) * (1.0 - headroom))
        assert mgr._hbm_budget_bytes() == mgr._hbm_budget_bytes() == want
        assert probes == [torch.device("cuda", 0)]
    finally:
        h.close()


def test_steady_query_skips_the_budget_pass(tmp_path, monkeypatch):
    """A query's release runs the budget's eviction pass only when it
    built a row table on its views or the staged bytes are over the
    budget: Counts over resident views with their tables built recompute
    nothing, and staged_bytes still equals the view's bytes. A query
    over more views than the budget holds keeps the pass running until
    a later release brings the bytes back under it."""
    h = Holder(str(tmp_path / "port"))
    h.open()
    try:
        seed_blocks(h, ["f1", "f2"])
        ex = port_executor(h)
        mgr = ex.mesh_manager()
        passes = []
        real = mgr._evict_over_budget
        monkeypatch.setattr(mgr, "_evict_over_budget",
                            lambda: (passes.append(1), real())[1])
        pql = "Count(Bitmap(rowID=1, frame=f1))"
        first = q(PORT, ex, pql)
        n0 = len(passes)
        assert n0 >= 1
        sv = mgr._views[("i", "f1", "standard")]
        assert staged_bytes(mgr) == mgr._view_bytes(sv)
        for _ in range(3):
            assert q(PORT, ex, pql) == first
        assert len(passes) == n0
        assert staged_bytes(mgr) == mgr._view_bytes(sv)
        # A budget of one view and a query over two: over it until the
        # next query's release evicts the view that query left cold.
        one = mgr._view_bytes(sv)
        mgr._config["hbm_budget_bytes"] = one
        q(PORT, ex, "Count(Union(Bitmap(rowID=1, frame=f1), "
                    "Bitmap(rowID=1, frame=f2)))")
        assert resident(mgr) == ["f1", "f2"] and mgr._over_budget
        q(PORT, ex, "Count(Bitmap(rowID=1, frame=f2))")
        assert resident(mgr) == ["f2"] and not mgr._over_budget
        assert staged_bytes(mgr) <= one
    finally:
        h.close()


@pytest.mark.parametrize("make", [
    lambda h, cfg: Executor(h, device="cpu", mesh_config=cfg),
    lambda h, cfg: tserve.MeshManager(h, device="cpu", config=cfg)])
def test_unknown_mesh_knob_is_refused(tmp_path, make):
    """A misspelt knob fails where it is given, not at the first query."""
    h = Holder(str(tmp_path / "port"))
    h.open()
    try:
        with pytest.raises(ValueError, match="hbm_budget"):
            make(h, {"hbm_budget": 1 << 30})
        assert make(h, cfg(1 << 30)) is not None
    finally:
        h.close()
