"""The diagnosis routes of the handler (/debug/fleet and the nine
/debug/pprof routes) against the JAX handler's, on the CPU.

Both handlers (fixture `pkg`) answer the ten new routes with the same
statuses and content types; the heap route refuses ?start=1 without the
environment knob (PILOSA_TORCH_HEAP_TRACE for the port,
PILOSA_TPU_HEAP_TRACE for the JAX package) and starts and stops
tracemalloc with it; the thread dump names the calling thread; the
profile, block, mutex and trace routes sample the other threads
(tests/test_api.py's cases on both packages). The port serves 42 of the
JAX handler's 52 routes.
"""

import json
import threading
import time
import tracemalloc

import pytest

from torch_obs import PKGS, isolated_stores, pkg  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

HEAP_ENV = {"jax": "PILOSA_TPU_HEAP_TRACE", "torch": "PILOSA_TORCH_HEAP_TRACE"}

# (path, params) of the ten routes this slice adds.
ROUTES = [
    ("/debug/fleet", {}),
    ("/debug/pprof", {}),
    ("/debug/pprof/", {}),
    ("/debug/pprof/profile", {"seconds": "0.05"}),
    ("/debug/pprof/heap", {}),
    ("/debug/pprof/heap", {"start": "1"}),
    ("/debug/pprof/allocs", {}),
    ("/debug/pprof/block", {"seconds": "0.05"}),
    ("/debug/pprof/mutex", {"seconds": "0.05"}),
    ("/debug/pprof/trace", {"seconds": "0.05"}),
    ("/debug/pprof/goroutine", {}),
    ("/debug/pprof/threadcreate", {}),
    ("/debug/pprof/cmdline", {}),
]


def handlers(tmp_path):
    """A port handler and a JAX handler without a cluster (the JAX
    fleet pane needs one), each over its own holder."""
    from pilosa_tpu.api import Handler as JaxHandler
    from pilosa_tpu.core import Holder as JaxHolder
    from pilosa_tpu.executor import Executor as JaxExecutor

    holder, port = PKGS["torch"].make_handler(tmp_path / "p")
    jholder = JaxHolder(str(tmp_path / "j"))
    jholder.open()
    jax = JaxHandler(jholder, JaxExecutor(jholder, use_device=False))
    return (holder, jholder), port, jax


@pytest.fixture
def both(tmp_path, monkeypatch):
    for env in HEAP_ENV.values():
        monkeypatch.delenv(env, raising=False)
    holders, port, jax = handlers(tmp_path)
    yield port, jax
    for h in holders:
        h.close()


@pytest.fixture
def handler(pkg, tmp_path, monkeypatch):
    monkeypatch.delenv(HEAP_ENV[pkg.name], raising=False)
    holder, h = pkg.make_handler(tmp_path / "d")
    yield h
    holder.close()


@pytest.mark.parametrize("path,params", ROUTES,
                         ids=[p + ("?" + "&".join(q) if q else "")
                              for p, q in ROUTES])
def test_routes_answer_as_the_jax_handler(both, path, params):
    port, jax = both
    a = port.handle("GET", path, dict(params))
    b = jax.handle("GET", path, dict(params))
    assert (a.status, a.headers) == (b.status, b.headers)
    assert a.status == (404 if path == "/debug/fleet" else 200)
    assert not tracemalloc.is_tracing() or path != "/debug/pprof/heap"


def test_post_is_not_allowed(both):
    port, jax = both
    for path in ("/debug/pprof/goroutine", "/debug/fleet"):
        assert port.handle("POST", path).status == \
            jax.handle("POST", path).status == 405


def test_route_table_is_42_of_the_jax_handlers(both):
    port, jax = both
    mine = {(r.method, r.pattern.pattern) for r in port._routes}
    theirs = {(r.method, r.pattern.pattern) for r in jax._routes}
    # 42 before the cluster's five routes (/status, /hosts,
    # /fragment/nodes, /internal/message, /internal/status) and replica
    # convergence's four (the two attr diffs, GET /internal/epochs and
    # its advance); only POST /cluster/resize is left. The test keeps
    # its name.
    assert len(port._routes) == len(mine) == 51 and len(theirs) == 52
    assert theirs - mine == {("POST", "^/cluster/resize$")}
    assert mine <= theirs


def test_index_lists_profiles_and_dumps_threads(handler):
    body = handler.handle("GET", "/debug/pprof").body.decode()
    for name in ("profile", "heap", "allocs", "block", "mutex", "trace",
                 "goroutine", "threadcreate", "cmdline"):
        assert f"  {name} " in body
    assert "--- thread MainThread" in body
    assert handler.handle("GET", "/debug/pprof/").body.decode().endswith(
        "\n")


def test_thread_dump_names_the_calling_thread(handler):
    got = {}

    def call():
        got["body"] = handler.handle(
            "GET", "/debug/pprof/goroutine").body.decode()

    t = threading.Thread(target=call, name="pprof-caller")
    t.start()
    t.join()
    assert "--- thread pprof-caller (" in got["body"]
    assert "--- thread MainThread (" in got["body"]
    rows = handler.handle("GET", "/debug/pprof/threadcreate").body.decode()
    assert "\tMainThread\tdaemon=False\talive=True" in rows


def test_cmdline_is_argv(handler):
    import sys

    body = handler.handle("GET", "/debug/pprof/cmdline").body
    assert body == "\x00".join(sys.argv).encode()


def test_heap_start_needs_the_env_knob(handler, pkg, monkeypatch):
    if tracemalloc.is_tracing():
        pytest.skip("interpreter-level tracemalloc active "
                    "(PYTHONTRACEMALLOC)")
    for p in ({}, {"start": "0"}, {"start": "false"}):
        r = handler.handle("GET", "/debug/pprof/heap", p)
        assert r.status == 200 and "?start=1" in r.body.decode()
        assert not tracemalloc.is_tracing()
    env = HEAP_ENV[pkg.name]
    for val in (None, "0", "False", "NO"):
        if val is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, val)
        r = handler.handle("GET", "/debug/pprof/heap", {"start": "1"})
        assert r.status == 200
        assert f"refused: set {env}=1" in r.body.decode()
        assert not tracemalloc.is_tracing()
    monkeypatch.setenv(env, "1")
    try:
        assert handler.handle("GET", "/debug/pprof/heap",
                              {"start": "1"}).status == 200
        assert tracemalloc.is_tracing()
        blob = [bytearray(10000) for _ in range(10)]  # noqa: F841
        r = handler.handle("GET", "/debug/pprof/heap",
                           {"gc": "1", "stop": "1"})
        assert "current=" in r.body.decode()
        assert "# tracemalloc stopped" in r.body.decode()
        assert not tracemalloc.is_tracing()
    finally:
        if tracemalloc.is_tracing():
            tracemalloc.stop()


def test_profile_samples_other_threads(handler):
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            time.sleep(0.001)

    t = threading.Thread(target=spin, name="profilee", daemon=True)
    t.start()
    try:
        r = handler.handle("GET", "/debug/pprof/profile",
                           {"seconds": "0.3"})
        assert r.status == 200
        body = r.body.decode()
        assert "test_torch_pprof.py:spin" in body
        for line in body.splitlines():
            stack, n = line.rsplit(" ", 1)
            assert int(n) > 0 and ";" in stack
    finally:
        stop.set()
        t.join()


def test_block_and_mutex(handler):
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, daemon=True)
    t.start()
    time.sleep(0.05)
    joiner = threading.Thread(target=t.join, daemon=True)
    try:
        r = handler.handle("GET", "/debug/pprof/block", {"seconds": "0.2"})
        body = r.body.decode()
        assert r.status == 200 and "# sampling block profile" in body
        assert "threading.py:wait" in body
        joiner.start()
        time.sleep(0.05)
        b2 = handler.handle("GET", "/debug/pprof/mutex",
                            {"seconds": "0.2"}).body.decode()
        assert "# sampling mutex profile" in b2
        assert "_wait_for_tstate_lock" in b2
        assert "queue.py:get" not in b2
    finally:
        stop.set()
        t.join()
        joiner.join()


def test_trace_is_chrome_trace_json(handler):
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="traced", daemon=True)
    t.start()
    try:
        r = handler.handle("GET", "/debug/pprof/trace", {"seconds": "0.1"})
        assert r.status == 200
        doc = json.loads(r.body)
        assert doc["traceEvents"]
        for ev in doc["traceEvents"]:
            assert ev["ph"] == "X" and ev["cat"] == "sample"
            assert ev["name"] == ev["args"]["stack"].rsplit(";", 1)[-1]
        assert "traced" in {ev["tid"] for ev in doc["traceEvents"]}
    finally:
        stop.set()
        t.join()
