"""The liveness plane (obs/health.py) against the JAX package's.

tests/test_health.py's tests, run on both packages (fixture `pkg`):
heartbeat and in-flight bookkeeping, trip and recovery edges swept
with an explicit `now` (nothing sleeps), the excused set, the dossier's
rate limit, stack attribution by thread name, /healthz, /readyz,
/debug/health, /debug/bundle and the /metrics families, dossier size
bounds and retention, the refcounted watchdog thread (sweeps every
10 ms) and the `ctl health` panel. Gossip and the watchdog.stall seam
wait for the cluster and the rest of the seams (ROADMAP A11, A9b).
Equal between the packages: redact_config on seeded configs and on each
package's own Config. Port only: a real WAL commit held at the
storage.fsync seam trips `wal` (critical: /readyz 503) and recovers,
the card manager's batch thread registers `mesh-count-batch`, and a
Server wires [health] and stops its watchdog at close().
"""

import json
import threading
import time

import numpy as np
import pytest

from pilosa_tpu.config import Config as JaxConfig
from pilosa_tpu_torch.config import Config
from pilosa_tpu_torch.server import Server
from torch_obs import PKGS, isolated_stores, pkg  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

JAX_HEALTH, PORT_HEALTH = PKGS["jax"].health, PKGS["torch"].health


def _reg(pkg, **kw):
    r = pkg.health.HealthRegistry()
    for k, v in kw.items():
        setattr(r, k, v)
    return r


# ---------------------------------------------------------------------------
# bookkeeping


class TestHeartbeatBookkeeping:
    def test_register_is_idempotent_and_refreshes(self, pkg):
        r = _reg(pkg)
        hb1 = r.register("loop", interval=1.0)
        hb2 = r.register("loop", interval=2.0, critical=True)
        assert hb1 is hb2
        assert hb1.interval == 2.0
        assert "loop" in r.snapshot()["subsystems"]

    def test_beat_stamps_thread_and_counts(self, pkg):
        r = _reg(pkg)
        hb = r.register("loop", interval=1.0)
        out = {}

        def work():
            hb.beat()
            out["name"] = hb.thread_name

        t = threading.Thread(target=work, name="my-loop")
        t.start()
        t.join()
        assert hb.beats == 1
        assert out["name"] == "my-loop"
        assert r.snapshot()["subsystems"]["loop"]["thread"] == "my-loop"

    def test_disabled_registry_is_inert(self, pkg):
        r = _reg(pkg, enabled=False)
        hb = r.register("loop", interval=0.001)
        hb.beat()
        assert hb.beats == 0  # beat() returned at the enabled check
        cm = r.inflight("loop", "op", base=0.001)
        assert cm is pkg.health._NOOP_INFLIGHT
        with cm:
            pass
        assert r.sweep(now=time.monotonic() + 1e6) == []

    def test_unregister_clears_state(self, pkg):
        r = _reg(pkg)
        r.register("loop", interval=0.001)
        assert r.sweep(now=time.monotonic() + 10) == ["loop"]
        r.unregister("loop")
        assert r.stalled() == []
        assert "loop" not in r.snapshot()["subsystems"]

    def test_inflight_tracked_and_untracked(self, pkg):
        r = _reg(pkg)
        with r.inflight("wal", "commit", base=5.0) as rec:
            snap = r.snapshot()
            assert len(snap["inflight"]) == 1
            op = snap["inflight"][0]
            assert op["subsystem"] == "wal" and op["kind"] == "commit"
            assert op["deadline_s"] == pytest.approx(
                5.0 * r.stall_after)
            assert rec.thread_name == threading.current_thread().name
        assert r.snapshot()["inflight"] == []


# ---------------------------------------------------------------------------
# trip + recovery edges


class TestTripAndRecovery:
    def test_heartbeat_trip_and_recovery(self, pkg):
        r = _reg(pkg)
        hb = r.register("drain", interval=0.01, critical=True)
        t0 = time.monotonic()
        # Within bound: no trip.
        assert r.sweep(now=t0 + 0.01) == []
        # Past stall-after x interval: one trip edge.
        assert r.sweep(now=t0 + 1.0) == ["drain"]
        assert r.state_of("drain") == pkg.health.STALLED
        assert r.stalled_critical() == ["drain"]
        assert not r.ready()
        info = r.snapshot()["subsystems"]["drain"]
        assert info["stall"]["kind"] == "heartbeat"
        # Still stalled: NOT a second edge.
        assert r.sweep(now=t0 + 2.0) == []
        assert r.trips_total() == 1
        # The loop beats again -> recovery.
        hb.beat()
        assert r.sweep() == []
        assert r.state_of("drain") == pkg.health.OK
        assert r.ready()

    def test_inflight_trip_and_recovery(self, pkg):
        r = _reg(pkg)
        with r.inflight("wal", "commit", base=0.01):
            t0 = time.monotonic()
            assert r.sweep(now=t0 + 5.0) == ["wal"]
            info = r.snapshot()["subsystems"]["wal"]
            assert info["stall"]["kind"] == "inflight"
            assert info["stall"]["op"] == "commit"
        # Op exited -> next sweep recovers.
        assert r.sweep() == []
        assert r.state_of("wal") == pkg.health.OK

    def test_unbounded_inflight_never_judged(self, pkg):
        r = _reg(pkg)
        with r.inflight("snapshot", "write"):  # base=None
            assert r.sweep(now=time.monotonic() + 1e6) == []

    def test_parked_heartbeat_never_judged(self, pkg):
        r = _reg(pkg)
        hb = r.register("sched", interval=0.01)
        hb.idle()
        assert r.sweep(now=time.monotonic() + 1e6) == []

    def test_event_loop_heartbeat_never_judged(self, pkg):
        r = _reg(pkg)
        r.register("spmd-worker", interval=None)
        assert r.sweep(now=time.monotonic() + 1e6) == []

    def test_inflight_within_bound_excuses_heartbeat(self, pkg):
        """A drainer blocked inside a TRACKED replay (still within its
        own deadline) is working, not wedged."""
        r = _reg(pkg)
        r.register("drain", interval=0.01)
        with r.inflight("drain", "replay", base=1e6):
            assert r.sweep(now=time.monotonic() + 10.0) == []
        # Bracket gone, heartbeat still stale -> now it IS a hang.
        assert r.sweep(now=time.monotonic() + 10.0) == ["drain"]

    def test_dossier_rate_limit_resets_on_recovery(self, tmp_path, pkg):
        r = _reg(pkg, dossier_dir=str(tmp_path / "d"))
        hb = r.register("drain", interval=0.01)
        t0 = time.monotonic()
        assert r.sweep(now=t0 + 1.0) == ["drain"]
        assert len(r.list_dossiers()) == 1
        # Still stalled across later sweeps: no second dossier.
        r.sweep(now=t0 + 2.0)
        r.sweep(now=t0 + 3.0)
        assert len(r.list_dossiers()) == 1
        # Recover, then trip again: the limit reset, fresh dossier.
        hb.beat()
        r.sweep()
        assert r.sweep(now=time.monotonic() + 1.0) == ["drain"]
        assert len(r.list_dossiers()) == 2
        assert r.trips_total() == 2


# ---------------------------------------------------------------------------
# stack attribution


class TestStackAttribution:
    def test_named_thread_attributed_in_dump(self, pkg):
        release = threading.Event()
        entered = threading.Event()

        def wedge():
            entered.set()
            release.wait(10)

        t = threading.Thread(target=wedge, name="hint-drain-test",
                             daemon=True)
        t.start()
        assert entered.wait(5)
        try:
            dump = pkg.health.thread_stacks()
            mine = [d for d in dump if d["name"] == "hint-drain-test"]
            assert len(mine) == 1
            assert any("wedge" in ln for ln in mine[0]["stack"])
            # Single-thread variant: the trip log's stack.
            stack = pkg.health.thread_stack(t.ident)
            assert any("release.wait" in ln or "wedge" in ln
                       for ln in stack)
        finally:
            release.set()
            t.join()

    def test_unknown_tid_empty_stack(self, pkg):
        assert pkg.health.thread_stack(999999999) == []
        assert pkg.health.thread_stack(None) == []


# ---------------------------------------------------------------------------
# endpoints


@pytest.fixture
def handler(tmp_path, pkg):
    holder, h = pkg.make_handler(tmp_path / "data")
    yield h
    holder.close()


class TestEndpoints:
    def test_healthz_ok(self, handler, pkg):
        r = handler.handle("GET", "/healthz")
        assert r.status == 200
        assert r.json()["status"] == "ok"

    def test_readyz_flips_on_critical_stall_healthz_stays(self, handler, pkg):
        assert handler.handle("GET", "/readyz").status == 200
        hb = pkg.health.HEALTH.register("hint-drain", interval=0.01, critical=True)
        pkg.health.HEALTH.sweep(now=time.monotonic() + 1.0)
        r = handler.handle("GET", "/readyz")
        assert r.status == 503
        assert "stalled:hint-drain" in r.json()["reasons"]
        # Liveness is about the watchdog, not the workload: still 200.
        assert handler.handle("GET", "/healthz").status == 200
        hb.beat()
        pkg.health.HEALTH.sweep()
        assert handler.handle("GET", "/readyz").status == 200

    def test_readyz_degraded_partial_mode(self, handler, pkg):
        """A NON-critical stall (rebalance, gossip) degrades but does
        not unready the node — partial mode keeps serving."""
        pkg.health.HEALTH.register("rebalance", interval=0.01, critical=False)
        pkg.health.HEALTH.sweep(now=time.monotonic() + 1.0)
        assert pkg.health.HEALTH.stalled() == ["rebalance"]
        assert handler.handle("GET", "/readyz").status == 200

    def test_readyz_not_serving(self, handler, pkg):
        handler.ready_fn = lambda: False
        r = handler.handle("GET", "/readyz")
        assert r.status == 503
        assert "not-serving" in r.json()["reasons"]
        handler.ready_fn = lambda: True
        assert handler.handle("GET", "/readyz").status == 200

    def test_debug_health_document(self, handler, pkg):
        pkg.health.HEALTH.register("wal", interval=None)
        doc = handler.handle("GET", "/debug/health").json()
        assert doc["enabled"] is True
        assert doc["watchdog_alive"] is True
        assert "wal" in doc["subsystems"]
        assert doc["subsystems"]["wal"]["interval_s"] is None

    def test_debug_bundle_schema(self, handler, pkg):
        doc = handler.handle("GET", "/debug/bundle").json()
        assert doc["schema"] == pkg.health.DOSSIER_SCHEMA
        assert doc["reason"] == "on-demand"
        assert isinstance(doc["threads"], list)
        assert any(t["name"] == "MainThread" for t in doc["threads"])
        assert "health" in doc and "sections" in doc

    def test_metrics_families_present(self, handler, pkg):
        pkg.health.HEALTH.register("wal", interval=None)
        text = handler.handle("GET", "/metrics").body.decode()
        assert "pilosa_health_ready 1" in text
        assert 'pilosa_health_state{subsystem="wal"} 0' in text
        assert "pilosa_watchdog_sweeps_total" in text

    def test_trip_visible_in_metrics(self, handler, pkg):
        pkg.health.HEALTH.register("hint-drain", interval=0.01, critical=True)
        pkg.health.HEALTH.sweep(now=time.monotonic() + 1.0)
        text = handler.handle("GET", "/metrics").body.decode()
        assert 'pilosa_health_state{subsystem="hint-drain"} 1' in text
        assert ('pilosa_watchdog_trips_total{subsystem="hint-drain",'
                'kind="heartbeat"} 1') in text
        assert "pilosa_health_ready 0" in text


# ---------------------------------------------------------------------------
# dossiers


class TestDossiers:
    def test_no_dossier_dir_returns_none(self, pkg):
        assert _reg(pkg).write_dossier() is None

    def test_size_bound_progressive_shedding(self, tmp_path, pkg):
        r = _reg(pkg, dossier_dir=str(tmp_path / "d"), dossier_max_bytes=4096)
        r.bundle_providers["huge"] = lambda: ["x" * 100] * 200
        r.bundle_providers["small"] = lambda: {"ok": 1}
        data = r.encode_bundle(r.build_bundle())
        assert len(data) <= 4096
        doc = json.loads(data)
        # The big section shed first; the small one survives if room.
        assert "huge" in doc.get("truncated", [])

    def test_thread_heavy_process_sheds_threads_not_trip(self, pkg):
        # Hundreds of live threads (a real server, or a full test
        # run) overflow the bound even at 5-frame stacks — the
        # thread list drops as a unit and the trip survives.
        r = _reg(pkg, dossier_max_bytes=4096)
        r.bundle_providers["huge"] = lambda: ["x" * 100] * 200
        doc = r.build_bundle(reason="stall-wal",
                             trip={"kind": "inflight"})
        doc["threads"] = [{"name": f"t{i}", "stack": ["frame"] * 40}
                          for i in range(300)]
        data = r.encode_bundle(doc)
        assert len(data) <= 4096
        out = json.loads(data)
        assert out.get("truncated") != "all"
        assert "huge" in out["truncated"]
        assert out["threads"] == "truncated"
        assert out["reason"] == "stall-wal"
        assert out["trip"]["kind"] == "inflight"

    def test_minimal_doc_under_tiny_bound(self, pkg):
        r = _reg(pkg, dossier_max_bytes=1024)
        r.bundle_providers["huge"] = lambda: ["y" * 100] * 100
        data = r.encode_bundle(r.build_bundle(
            reason="stall-x", trip={"kind": "heartbeat"}))
        assert len(data) <= 1024
        doc = json.loads(data)
        assert doc["reason"] == "stall-x"
        assert doc["trip"]["kind"] == "heartbeat"

    def test_retention_prunes_oldest(self, tmp_path, pkg):
        r = _reg(pkg, dossier_dir=str(tmp_path / "d"), dossier_keep=3)
        paths = [r.write_dossier(reason=f"r{i}") for i in range(6)]
        kept = r.list_dossiers()
        assert len(kept) == 3
        assert kept == sorted(kept)
        assert paths[-1] in kept and paths[0] not in kept

    def test_broken_provider_contained(self, pkg):
        r = _reg(pkg)
        r.bundle_providers["bad"] = lambda: 1 / 0
        doc = r.build_bundle()
        assert "error" in doc["sections"]["bad"]

    def test_redact_config_masks_secrets(self, pkg):
        cfg = {"bind": "h:1", "api_token": "hunter2",
               "tls_password": "x", "_private_attr": 1,
               "weird": object()}
        out = pkg.health.redact_config(cfg)
        assert out["bind"] == "h:1"
        assert out["api_token"] == "<redacted>"
        assert out["tls_password"] == "<redacted>"
        assert "_private_attr" not in out
        assert isinstance(out["weird"], str)


# ---------------------------------------------------------------------------
# gossip propagation + read steering


class TestWatchdogThread:
    def test_refcounted_start_stop(self, pkg):
        pkg.health.HEALTH.sweep_interval = 0.01
        pkg.health.HEALTH.start()
        pkg.health.HEALTH.start()
        try:
            assert pkg.health.HEALTH._thread is not None
            deadline = time.monotonic() + 5
            while pkg.health.HEALTH.snapshot()["sweeps"] == 0:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            assert pkg.health.HEALTH.watchdog_alive()
        finally:
            pkg.health.HEALTH.stop()
            assert pkg.health.HEALTH._thread is not None  # one ref remains
            pkg.health.HEALTH.stop()
            assert pkg.health.HEALTH._thread is None
            pkg.health.HEALTH.sweep_interval = 1.0



class TestCtlHealthPanel:
    DOC = {"watchdog_alive": True, "sweeps": 12, "trips_total": 1,
           "subsystems": {
               "wal": {"state": "stalled", "critical": True,
                       "interval_s": None, "age_s": None, "beats": 0,
                       "trips": 1, "thread": None, "stalled_for_s": 2.5},
               "cache-flush": {"state": "ok", "critical": False,
                               "interval_s": 60.0, "age_s": 1.5,
                               "beats": 3, "parked": False,
                               "thread": "cache-flush"}},
           "inflight": [{"subsystem": "wal", "kind": "commit",
                         "age_s": 6.0, "deadline_s": 4.0,
                         "thread": "Thread-9"}]}

    def test_render_health_equals_the_jax_panel(self, pkg):
        ready = {"status": "unready", "reasons": ["stalled:wal"]}
        out = pkg.ctl.render_health("h:1", self.DOC, ready)
        assert "readyz UNREADY" in out and "STALLED 2.5s" in out
        assert "wal/commit running 6.0s (bound 4.0s)" in out
        want = PKGS["jax"].ctl.render_health("h:1", self.DOC, ready)
        assert out.splitlines()[1:] == want.splitlines()[1:]


class TestEqualToTheJaxPackage:
    @pytest.mark.parametrize("seed", range(3))
    def test_redact_config_seeded(self, seed):
        rng = np.random.default_rng(seed)
        keys = ["bind", "api_token", "tls_password", "_private",
                "data_dir", "Secret_Key", "weights", "hosts", "n",
                "ratio", "flag", "none", "obj", "credential_file"]
        cfg = {}
        for k in keys:
            kind = int(rng.integers(7))
            cfg[k] = [f"v{int(rng.integers(99))}", int(rng.integers(9)),
                      float(rng.random()), bool(rng.integers(2)), None,
                      [1, "a", 2.5, object()], {"a": 1, "b": [2]}][kind]
        assert PORT_HEALTH.redact_config(cfg) == \
            JAX_HEALTH.redact_config(cfg)

    def test_redact_each_config(self):
        """Each package's own Config, as its server's dossier holds it:
        the same keys, and equal values for the keys the schema names
        alike."""
        port = PORT_HEALTH.redact_config(vars(Config()))
        jax = JAX_HEALTH.redact_config(vars(JaxConfig()))
        for k in ("sched_tenant_weights", "slo_availability",
                  "health_stall_after", "cost_debt_threshold",
                  "query_deadline", "trace_ring"):
            assert port[k] == jax[k]


class TestPortLoops:
    def test_wal_commit_stall_trips_and_recovers(self, tmp_path):
        """A commit held at storage.fsync past stall-after x its base:
        `wal` STALLED (critical, so not ready) while it holds, a
        dossier written once, recovery after; the write is acked."""
        from pilosa_tpu_torch import fault
        from pilosa_tpu_torch.core import Holder
        from pilosa_tpu_torch.core.wal import WalConfig

        reg = PORT_HEALTH.HEALTH
        reg.sweep_interval = 0.01
        reg.stall_after = 0.05  # a 1 s base -> 50 ms bound
        reg.dossier_dir = str(tmp_path / ".dossier")
        reg.mark_critical("wal")
        holder = Holder(str(tmp_path / "d"), wal=WalConfig("group"))
        holder.open()
        reg.start()
        try:
            f = holder.create_index("i").create_frame("f")
            f.set_bit(1, 1)
            fault.arm("storage.fsync", delay=0.5, times=1, kind="commit")
            done = []
            t = threading.Thread(target=lambda: done.append(
                f.set_bit(1, 2)))
            t.start()
            deadline = time.monotonic() + 0.45
            while reg.state_of("wal") != PORT_HEALTH.STALLED:
                assert time.monotonic() < deadline, "no trip"
                time.sleep(0.005)
            assert not reg.ready() and reg.stalled_critical() == ["wal"]
            info = reg.snapshot()["subsystems"]["wal"]["stall"]
            assert info["kind"] == "inflight" and info["op"] == "commit"
            t.join(5)
            assert done == [True]
            deadline = time.monotonic() + 2
            while reg.state_of("wal") != PORT_HEALTH.OK:
                assert time.monotonic() < deadline, "no recovery"
                time.sleep(0.005)
            paths = reg.list_dossiers()
            assert len(paths) == 1
            doc = json.loads(open(paths[0]).read())
            assert doc["schema"] == PORT_HEALTH.DOSSIER_SCHEMA
            assert doc["reason"] == "stall-wal"
        finally:
            reg.stop()
            fault.reset()
            holder.close()
        assert reg._thread is None

    def test_batch_thread_registers(self, tmp_path):
        holder, h = PKGS["torch"].make_handler(tmp_path / "d")
        try:
            assert h.handle("POST", "/index/i").status == 200
            assert h.handle("POST", "/index/i/frame/f").status == 200
            h.handle("POST", "/index/i/query",
                     body=b"SetBit(rowID=1, frame=f, columnID=1)")
            mgr = h.executor.mesh_manager()
            mgr._ensure_batch_thread()
            deadline = time.monotonic() + 5
            while "mesh-count-batch" not in PORT_HEALTH.HEALTH._beats:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            hb = PORT_HEALTH.HEALTH._beats["mesh-count-batch"]
            assert hb.interval is None and hb.critical
        finally:
            holder.close()

    def test_server_wires_health(self, tmp_path):
        c = Config.from_toml(
            '[health]\nsweep-interval = "10ms"\nstall-after = 3\n'
            'dossier-max = 65536\ndossier-keep = 2\n', is_text=True)
        c.data_dir = str(tmp_path / "d")
        c.host = "127.0.0.1:0"
        c.use_device = "off"
        s = Server(c)
        reg = PORT_HEALTH.HEALTH
        s.open(port=0)
        try:
            assert reg.sweep_interval == 0.01 and reg.stall_after == 3.0
            assert reg.dossier_max_bytes == 65536 and reg.dossier_keep == 2
            assert reg.dossier_dir == str(tmp_path / "d" / ".dossier")
            assert reg._thread is not None
            h = s.handler
            assert h.handle("GET", "/readyz").status == 200
            doc = h.handle("GET", "/debug/health").json()
            assert doc["subsystems"]["cache-flush"]["interval_s"] == 60.0
            assert {"sched-dispatch", "wal", "mesh-count-batch"} <= \
                reg._critical
            bundle = h.handle("GET", "/debug/bundle").json()
            assert {"config", "slow_queries", "queryshapes", "slo",
                    "costs", "vars"} <= set(bundle["sections"])
            assert bundle["sections"]["config"]["data_dir"] == c.data_dir
        finally:
            s.close()
        assert reg._thread is None
        assert h.handle("GET", "/readyz").status == 503
