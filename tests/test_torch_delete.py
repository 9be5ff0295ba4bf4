"""The port's DELETE routes, ?explain=true and GET /debug/vars against the
JAX handler.

The same requests go to the JAX Handler (its executor on the device
path) and to the port's Handler (Executor(device="cpu")), each over its
own holder seeded the same way: status codes and JSON bodies must be
equal, and /debug/vars and the plan must carry the JAX handler's keys
(the port's residency report adds `table_bytes`; the plan's placement,
cost model and calibration are not ported). A deleted index or frame
drops its staged views and frees their pools at once, and one recreated
under the same name answers from its new data.
"""

import os
import weakref
from types import SimpleNamespace

import pytest

from pilosa_tpu import SLICE_WIDTH
from pilosa_tpu.api.handler import Handler as JaxHandler
from pilosa_tpu.core import Holder as JaxHolder
from pilosa_tpu.executor import Executor as JaxExecutor

from pilosa_tpu_torch.api.handler import Handler
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.executor import Executor
from torch_threads import one_torch_thread  # noqa: F401

JAX = SimpleNamespace(
    name="jax", Holder=JaxHolder,
    handler=lambda h, cfg: JaxHandler(h, JaxExecutor(
        h, use_device=True, mesh_config=cfg)))
PORT = SimpleNamespace(
    name="port", Holder=Holder,
    handler=lambda h, cfg: Handler(h, Executor(h, device="cpu",
                                               mesh_config=cfg)))

COUNT = "Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2, frame=f)))"
SETUP = [("POST", "/index/i", ""), ("POST", "/index/i/frame/f", ""),
         ("POST", "/index/i/frame/g", "")] + [
    ("POST", "/index/i/query", f"SetBit(rowID={r}, frame={fr}, "
                               f"columnID={c})")
    for fr in ("f", "g") for r, c in ((1, 3), (1, 9), (2, 9),
                                      (2, SLICE_WIDTH + 1), (1, SLICE_WIDTH + 1))]


@pytest.fixture(autouse=True)
def _lone_fused_off(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_LONE_FUSED", "off")


def call(handler, method, path, body="", params=None):
    resp = handler.handle(method, path, params or {}, {}, body.encode())
    return resp.status, resp.json()


def both(fn, tmp_path, cfg=None, same=True):
    """fn(pkg, handler, holder) through each package over its own holder
    after SETUP; the two results must be equal. With same=False,
    {package: result}."""
    got = {}
    for pkg in (JAX, PORT):
        path = str(tmp_path / pkg.name)
        h = pkg.Holder(path)
        h.open()
        try:
            handler = pkg.handler(h, dict(cfg or {}))
            for method, route, body in SETUP:
                assert call(handler, method, route, body)[0] == 200
            got[pkg.name] = fn(pkg, handler, h)
        finally:
            h.close()
    if not same:
        return got
    assert got["port"] == got["jax"]
    return got["port"]


def test_delete_index(tmp_path):
    def run(pkg, handler, h):
        out = [call(handler, "POST", "/index/i/query", COUNT)]
        if pkg is PORT:
            mgr = handler.executor.mesh_manager()
            pool = weakref.ref(mgr._views[("i", "f", "standard")]
                               .sharded.words)
        out.append(call(handler, "DELETE", "/index/i"))
        if pkg is PORT:
            assert not mgr._views and pool() is None
            assert mgr.device_memory()["padded_bytes"] == 0
        out.append(os.path.exists(os.path.join(h.path, "i")))
        out.append(call(handler, "GET", "/schema"))
        out.append(call(handler, "POST", "/index/i/query", COUNT))
        out.append(call(handler, "DELETE", "/index/nope"))
        return out

    out = both(run, tmp_path)
    assert out[0] == (200, {"results": [2]}) and out[1] == (200, {})
    assert out[2] is False and out[4][0] == 400


def test_delete_frame_and_recreate(tmp_path):
    """DELETE /index/i/frame/f drops the index's staged views; a frame
    recreated under the name answers from its new data, though the old
    fragments' generations may match the new ones."""
    def run(pkg, handler, h):
        g = "Count(Bitmap(rowID=1, frame=g))"
        out = [call(handler, "POST", "/index/i/query", COUNT),
               call(handler, "POST", "/index/i/query", g)]
        out.append(call(handler, "DELETE", "/index/i/frame/f"))
        if pkg is PORT:
            assert not handler.executor.mesh_manager()._views
        out.append(os.path.exists(os.path.join(h.path, "i", "f")))
        out.append(call(handler, "POST", "/index/i/query", COUNT))
        out.append(call(handler, "POST", "/index/i/frame/f", ""))
        for c in (5, 9, SLICE_WIDTH + 7):
            for r in (1, 2):
                call(handler, "POST", "/index/i/query",
                     f"SetBit(rowID={r}, frame=f, columnID={c})")
        out.append(call(handler, "POST", "/index/i/query", COUNT))
        out.append(call(handler, "POST", "/index/i/query", g))
        out.append(call(handler, "DELETE", "/index/i/frame/nope"))
        out.append(call(handler, "DELETE", "/index/nope/frame/f"))
        return out

    out = both(run, tmp_path)
    assert out[0] == (200, {"results": [2]})
    assert out[2] == (200, {}) and out[3] is False
    assert out[4] == (400, {"error": "frame not found"})  # gone
    assert out[6] == (200, {"results": [3]}) and out[7] == out[1]
    assert out[8] == (200, {}) and out[9] == (404, {"error":
                                                    "index not found"})


def test_explain(tmp_path):
    """?explain=true plans a Count without running it: no staging, no
    count; the route, the views' residency and format, and the query
    echo match the JAX handler's."""
    def run(pkg, handler, h):
        out = []
        for step in range(2):
            status, plan = call(handler, "POST", "/index/i/query", COUNT,
                                {"explain": "true"})
            c = plan["calls"][0]
            st = c["staging"]
            out.append((status, plan["index"], plan["slices"], plan["query"],
                        c["call"], c["route"], c.get("route_reason"),
                        st["staged_views"], st["unstaged_views"],
                        [(v["frame"], v["resident"], v["format"])
                         for v in st["views"]],
                        c.get("device_format")))
            if pkg is PORT:
                mgr = handler.executor._mesh_mgr
                assert mgr is None or mgr.stats["count"] == step
                assert c["plan"]["signature"] == \
                    '["and", ["leaf", 0], ["leaf", 1]]'
                assert c["plan"]["quarantined"] is False
                assert st["estimated_h2d_bytes"] == (
                    0 if step else 2 * 16 * 2048 * 4)
            # The pair the other way round: past the JAX executor's
            # query memo, which its explain would report.
            out.append(call(handler, "POST", "/index/i/query", COUNT
                            .replace("rowID=1", "rowID=x")
                            .replace("rowID=2", "rowID=1")
                            .replace("rowID=x", "rowID=2")))
        status, plan = call(handler, "POST", "/index/i/query",
                            "SetBit(rowID=1, frame=f, columnID=1)",
                            {"explain": "true"})
        out.append((status, plan["calls"][0]["route"]))
        return out

    out = both(run, tmp_path)
    assert out[0][5] == "mesh" and out[0][7:9] == (0, 1)
    assert out[2][7:9] == (1, 0) and out[4] == (200, "write")


def test_debug_vars_mesh(tmp_path):
    """GET /debug/vars: no `mesh` until a query builds the manager; then
    its counters, `hbm` (the budget and the residency report: the JAX
    handler's keys, plus the port's `table_bytes`) and the quarantined
    plans."""
    def run(pkg, handler, h):
        out = ["mesh" in call(handler, "GET", "/debug/vars")[1]]
        call(handler, "POST", "/index/i/query", COUNT)
        status, doc = call(handler, "GET", "/debug/vars")
        mesh = doc["mesh"]
        hbm = mesh["hbm"]
        out += [status, mesh["stage"], mesh["count"],
                mesh["hbm_budget_bytes"], hbm["budget_bytes"], hbm["views"],
                hbm["padded_bytes"] == mesh["staged_bytes"] > 0,
                sum(hbm["per_device"].values()) == hbm["padded_bytes"],
                0 < hbm["live_bytes"] <= hbm["padded_bytes"],
                mesh["quarantined_plans"]]
        return out, set(hbm), hbm.get("table_bytes")

    got = both(run, tmp_path, cfg={"hbm_budget_bytes": 12345678}, same=False)
    (out, keys, table), (jout, jkeys, _) = got["port"], got["jax"]
    assert out == jout == [False, 200, 1, 1, 12345678, 12345678, 1, True,
                           True, True, []]
    assert keys == jkeys | {"table_bytes"}
    # The pair's rows are not whole runs: K3 read them, and the view
    # keeps each one's index row, 64 B a slice.
    assert table == 2 * 2 * 64
