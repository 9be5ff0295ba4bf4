"""Server: one node as an operator runs it, from a Config (config.py).

Wires Config -> Holder (the stats client, the [storage] WalConfig, the
[integrity] scrubber) -> Executor (the device from use-device, the
[mesh] knobs, the sparse-density threshold, the shadow sample) ->
Handler -> APIServer. `build_handler` is the one place a node's
executor and handler are made: `api.server.serve` uses it too, and its
handler keeps the JAX Handler's defaults (a tracer and an SLO recorder,
no scheduler).

Admission and the query's own record (the JAX server's wiring,
pilosa_tpu/server.py:283-472): [obs] sizes the trace rings, the slow
threshold, the profile sample rate, the flight recorder's ring and the
cost ledger's knobs (the ledger and its watch are process-wide); [sched]
builds the query scheduler (when enabled) with the executor's service
estimate and cohort hint; [slo] the SLO recorder, its tenant labels
bounded by [sched] tenant-weights; [health] the process-wide liveness
registry (sweep interval, stall-after, dossiers under
<data-dir>/.dossier/; sched-dispatch, wal and mesh-count-batch are
critical: their stall makes /readyz answer 503); [cluster]
query-deadline the deadline of a query that brings none.

open() opens the holder, applies the declared [[schema.indexes]]
(idempotent), runs the K0 canary on a card (a card that fails it is
refused before the socket is bound), binds (port 0 picks a free port and
the node's host becomes the real address), starts the watchdog, and
starts the daemons: the rank-cache flush every 60 s (the `cache-flush`
heartbeat), the scrubber at scrub-interval with 10% jitter when
[integrity] is enabled, and the `warm` thread that loads the fragments
a start left lazy. close() stops them in the JAX node's order: /readyz
turns 503, the scheduler releases what it queued, the watchdog stops,
`warm` is joined before the holder closes, and the staged views leave
the card first.

The port serves one node. A config that needs a cluster (more than one
[cluster] host, type gossip or spmd, ici-hosts) is refused with an
error that names the key; clusters wait for ROADMAP A11.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from .config import Config

CACHE_FLUSH_INTERVAL = 60.0

# What the port reads from a config and does not act on yet (one log
# line at open()).
NOT_ACTED_ON = ("[anti-entropy]", "[rebalance]",
                "[obs] fleet-scrape-interval",
                "[cluster] timeouts, retries, breakers, hints and read "
                "staleness", "[integrity] result-cache-verify-1-in")


def refuse_cluster(cfg: Config) -> None:
    """Raise ValueError, naming the key, for a config that needs more
    than one node."""
    where = "the port serves one node; clusters wait for ROADMAP A11"
    if len(cfg.cluster_hosts) > 1:
        raise ValueError(f"[cluster] hosts lists {len(cfg.cluster_hosts)} "
                         f"hosts {cfg.cluster_hosts}: {where}")
    if cfg.cluster_type in ("gossip", "spmd"):
        raise ValueError(f'[cluster] type = "{cfg.cluster_type}": {where}')
    if cfg.cluster_type not in ("http", "static"):
        raise ValueError(f"unknown cluster type: {cfg.cluster_type!r} "
                         "(want static, http, gossip, or spmd)")
    if cfg.cluster_ici_hosts:
        raise ValueError(f"[cluster] ici-hosts = {cfg.cluster_ici_hosts}: "
                         f"{where}")


def build_handler(holder, device, sparse_density_threshold: float,
                  mesh_config: Optional[dict] = None, shadow_sample: int = 0,
                  stats=None, tracer=None):
    """The node's Executor and Handler over an open or opening holder;
    frame restore reaches other nodes through api.client.InternalClient.
    Returns the Handler (its `executor` is the Executor)."""
    from .api.client import InternalClient
    from .api.handler import Handler
    from .executor import Executor

    ex = Executor(holder, device=device,
                  sparse_density_threshold=sparse_density_threshold,
                  mesh_config=mesh_config, shadow_sample=shadow_sample)
    return Handler(holder, ex, client_factory=InternalClient, stats=stats,
                   tracer=tracer)


def check_card(executor) -> None:
    """The K0 canary (ops.kernels.probe_ok) on a card; RuntimeError when
    it fails. Nothing on the CPU."""
    from .ops.kernels import probe_ok

    if executor.device.type == "cuda" and not probe_ok(executor.device):
        raise RuntimeError(f"kernel canary failed on {executor.device}: "
                           "refusing to serve")


class Server:
    """One node: HTTP API + executor + daemons."""

    def __init__(self, config: Optional[Config] = None, logger=None):
        from .core.holder import Holder
        from .obs.trace import Tracer
        from .utils.stats import ExpvarStats

        self.config = cfg = config or Config()
        refuse_cluster(cfg)
        self.logger = logger or logging.getLogger("pilosa_tpu_torch.server")
        self.closing = threading.Event()
        self.stats = ExpvarStats()
        # Before the executor: the stager reads the chunk size from env.
        cfg.apply_mesh_env()
        scrub = cfg.integrity_scrub_interval if cfg.integrity_enabled else 0.0
        self.holder = Holder(cfg.expanded_data_dir(), wal=cfg.wal_config(),
                             scrub_interval=scrub,
                             scrub_rate_limit=cfg.integrity_rate_limit,
                             stats=self.stats)
        self.host = cfg.host
        self.tracer = Tracer(ring=cfg.trace_ring,
                             slow_us=cfg.slow_query_threshold * 1e6)
        self.handler = build_handler(
            self.holder, cfg.device(), cfg.sparse_density_threshold(),
            mesh_config=cfg.mesh_config(),
            shadow_sample=cfg.integrity_shadow_sample, stats=self.stats,
            tracer=self.tracer)
        self.handler.metrics_sample_interval = cfg.metrics_sample_interval
        self.executor = self.handler.executor
        self._ready = False
        self._wire_observability()
        self._api = None
        self._threads: list = []
        self._health_started = False

    def _wire_observability(self):
        """[obs], [sched], [slo], [health] and [cluster] query-deadline
        onto the handler, the executor and the process-wide stores."""
        import os

        from .obs import costs, health, slo

        cfg, h, ex = self.config, self.handler, self.executor
        h.profile_sample_rate = cfg.profile_sample_rate
        h.default_deadline = cfg.query_deadline
        ex.flight.ring = max(1, int(cfg.queryshape_ring))
        self.scheduler = None
        if cfg.sched_enabled:
            from .sched import QueryScheduler

            self.scheduler = QueryScheduler(
                max_window_us=cfg.sched_max_window_us,
                idle_window_us=cfg.sched_idle_window_us,
                queue_depth=cfg.sched_queue_depth,
                default_service_us=cfg.sched_default_service_us,
                tenant_weights=cfg.sched_tenant_weights,
                estimator=ex.estimate_service_us,
                on_release=ex.burst_hint)
            h.scheduler = self.scheduler
        on = bool(cfg.cost_ledger)
        costs.LEDGER.enabled = costs.WATCH.enabled = on
        costs.LEDGER.max_accounts = max(1, int(cfg.cost_max_accounts))
        costs.WATCH.max_bands = max(1, int(cfg.cost_watch_bands))
        costs.WATCH.k = float(cfg.cost_regression_k)
        costs.WATCH.min_n = max(2, int(cfg.cost_regression_min_n))
        h.cost_debt_threshold = float(cfg.cost_debt_threshold)
        if self.scheduler is not None and on:
            self.scheduler.cost_share_fn = costs.LEDGER.tenant_share
        h.slo = (slo.SLORecorder(objectives=cfg.slo_objectives(),
                                 tenants=cfg.sched_tenant_weights)
                 if cfg.slo_enabled else None)
        reg = health.HEALTH
        reg.enabled = bool(cfg.health_enabled)
        reg.sweep_interval = max(0.01, float(cfg.health_sweep_interval))
        reg.stall_after = max(1.0, float(cfg.health_stall_after))
        reg.dossier_max_bytes = max(1024, int(cfg.health_dossier_max))
        reg.dossier_keep = max(1, int(cfg.health_dossier_keep))
        reg.dossier_dir = os.path.join(cfg.expanded_data_dir(), ".dossier")
        reg.mark_critical("sched-dispatch", "wal", "mesh-count-batch")
        h.ready_fn = lambda: self._ready
        reg.bundle_providers.update({
            "config": lambda: health.redact_config(vars(cfg)),
            "slow_queries": self._bundle_endpoint("/debug/queries"),
            "queryshapes": self._bundle_endpoint("/debug/queryshapes"),
            "slo": self._bundle_endpoint("/debug/slo"),
            "costs": self._bundle_endpoint("/debug/costs"),
            "vars": self._bundle_endpoint("/debug/vars"),
        })

    def _bundle_endpoint(self, path: str):
        """A dossier section: this node's own answer at `path`."""
        def provider():
            resp = self.handler.handle("GET", path)
            return resp.json() if resp.status == 200 else {
                "status": resp.status}
        return provider

    # -- lifecycle -------------------------------------------------------------

    def open(self, port: Optional[int] = None):
        from .api.server import APIServer

        self.holder.open()
        self._apply_config_schema()
        check_card(self.executor)
        bind_host, _, bind_port = self.host.rpartition(":")
        if port is None:
            port = int(bind_port or 10101)
        self._api = APIServer(self.handler, bind_host or "127.0.0.1", port)
        h, p = self._api.address
        if port == 0:
            self.host = f"{bind_host or h}:{p}"
        self._api.start()
        self.logger.info("config read but not acted on yet: %s",
                         "; ".join(NOT_ACTED_ON))
        from .obs.health import HEALTH

        # The watchdog before the loops it watches.
        HEALTH.start()
        self._health_started = True
        hb = HEALTH.register("cache-flush", interval=CACHE_FLUSH_INTERVAL)
        for name, target, args in (
                ("cache-flush", self._loop,
                 (self.holder.flush_caches, CACHE_FLUSH_INTERVAL, hb)),
                ("warm", self.holder.warm, (self.closing,))):
            t = threading.Thread(target=target, name=name, args=args,
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._ready = True

    def close(self):
        from .obs.health import HEALTH

        self._ready = False
        if self.scheduler is not None:
            self.scheduler.close()
        if self._health_started:
            HEALTH.unregister("cache-flush")
            HEALTH.stop()
            self._health_started = False
        self.closing.set()
        # Join warm BEFORE holder.close(): a warm mid-load after close
        # would reopen a WAL fd on a fragment whose flock was released.
        for t in self._threads:
            t.join(timeout=10)
        if self._api is not None:
            self._api.close()
        try:
            self.executor.invalidate_device_index()
        except Exception as e:  # noqa: BLE001 — the card may be gone
            self.logger.warning("view drop at close: %s", e)
        self.holder.close()

    def _loop(self, fn, interval: float, hb):
        while not self.closing.wait(interval):
            hb.beat()
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — daemons never die
                self.logger.warning("daemon error: %s", e)

    def _apply_config_schema(self):
        """The declared [[schema.indexes]]: create the indexes, frames
        and integer fields at open. Idempotent: existing objects are
        kept and missing fields added; a field whose definition differs
        from the one on disk raises (a node must not serve a schema that
        contradicts its config)."""
        from .bsi.field import FieldSchema

        for ix in self.config.schema_indexes:
            opts = {}
            if ix.get("column-label"):
                opts["column_label"] = ix["column-label"]
            idx = self.holder.create_index_if_not_exists(ix["name"], **opts)
            for fr in ix.get("frames", []):
                fopts = {}
                if fr.get("row-label"):
                    fopts["row_label"] = fr["row-label"]
                f = idx.create_frame_if_not_exists(fr["name"], **fopts)
                for fd in fr.get("fields", []):
                    f.create_field_if_not_exists(FieldSchema.from_dict(fd))
