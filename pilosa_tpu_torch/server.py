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
(idempotent), runs the K0 canary on a card and then the check of K1
and K4 against their plain versions (ops.calibrate; a card that fails
either is refused before the socket is bound), binds (port 0 picks a
free port and the node's host becomes the real address), starts the
watchdog, and
starts the daemons: the rank-cache flush every 60 s (the `cache-flush`
heartbeat), the scrubber at scrub-interval with 10% jitter when
[integrity] is enabled, and the `warm` thread that loads the fragments
a start left lazy. close() stops them in the JAX node's order: /readyz
turns 503, the scheduler releases what it queued, the watchdog stops,
`warm` is joined before the holder closes, and the staged views leave
the card first.

The HTTP cluster with static membership (the JAX server's, without
gossip and the SPMD plane): [cluster] hosts,
replicas and partitions make the Cluster (placement by a host's
position in `hosts`); client-timeout, retries, retry-backoff and
breaker-* the ClusterClient, one InternalClient a peer over one breaker
registry; with more than one host of type "http" schema changes reach
every peer through the HTTPBroadcaster (type "static": no broadcast);
write-consistency and prefer-local-reads go to the executor, and the
HintManager journals under <data-dir>/.hints/ what a replicated write
or import missed, its drainer (the critical `hint-drain` heartbeat)
replaying every hint-drain-interval. An opening breaker marks its node
DOWN, a closing one marks it UP and wakes the drainer
(_breaker_change). The `status-poll` daemon (polling-interval) pulls
each peer's /internal/status: it merges the peer's schema and max
slices, marks an unreachable peer DOWN and a reachable one UP again,
and wakes the drainer when a DOWN peer came back. /status and
/internal/status answer cluster_status and local_status; /internal/
message applies a broadcast (receive_message). Refused, with the key
named: type "gossip" (membership change, ROADMAP A11c), type "spmd"
and a non-empty ici-hosts (the SPMD plane, A11d).

Replica convergence (the JAX server's, pilosa_tpu/server.py:292-303,
380, 475-477, 600-750): with more than one host the `anti-entropy`
daemon runs a HolderSyncer pass (core/syncer.py) every [anti-entropy]
interval, each start up to `jitter` late (-1: a tenth of the interval),
each peer fetch bounded by block-deadline; the holder's
IntegrityContext gets `_repair_source`, which streams a corrupt
fragment's tar from the first UP replica whose copy verifies (its
footer, and block checksums equal to what that replica reports); the
scrubber gets the cluster for its cross-replica diff. The status poll
also feeds the executor's EpochTracker: this node's own epochs first,
then each peer's GET /internal/epochs (a peer it cannot reach is
forgotten, so it is no follower-read target). [cluster]
default-read-staleness is the bound of a read that brings none,
result-cache-size the result cache's cap, and [integrity]
result-cache-verify-1-in how many of its hits are counted again.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Optional

from .config import Config

CACHE_FLUSH_INTERVAL = 60.0

# What the port reads from a config and does not act on yet (one log
# line at open()).
NOT_ACTED_ON = ("[rebalance]",)


def refuse_cluster(cfg: Config) -> None:
    """Raise ValueError, naming the key, for a cluster the port does not
    run yet: gossip membership, the SPMD plane, interconnect peers."""
    if cfg.cluster_type == "gossip":
        raise ValueError('[cluster] type = "gossip": membership change '
                         'waits for ROADMAP A11c; use type = "http"')
    if cfg.cluster_type == "spmd":
        raise ValueError('[cluster] type = "spmd": the SPMD plane waits '
                         'for ROADMAP A11d')
    if cfg.cluster_type not in ("http", "static"):
        raise ValueError(f"unknown cluster type: {cfg.cluster_type!r} "
                         "(want static, http, gossip, or spmd)")
    if cfg.cluster_ici_hosts:
        raise ValueError(f"[cluster] ici-hosts = {cfg.cluster_ici_hosts}: "
                         "the SPMD plane waits for ROADMAP A11d")


def build_handler(holder, device, sparse_density_threshold: float,
                  mesh_config: Optional[dict] = None, shadow_sample: int = 0,
                  stats=None, tracer=None, host: str = "", cluster=None,
                  client=None):
    """The node's Executor and Handler over an open or opening holder.
    In a cluster (`cluster`, this node's `host`, `client` an
    api.client.ClusterClient) the executor fans out through the client
    and frame restore, the import's copies and the broadcasts reach the
    peers through its per-host clients; without one, through a fresh
    api.client.InternalClient. Returns the Handler (its `executor` is
    the Executor)."""
    from .api.client import InternalClient
    from .api.handler import Handler
    from .executor import Executor

    ex = Executor(holder, device=device,
                  sparse_density_threshold=sparse_density_threshold,
                  mesh_config=mesh_config, shadow_sample=shadow_sample,
                  host=host, cluster=cluster, client=client)
    return Handler(holder, ex, client_factory=(
        client.for_host if client is not None else InternalClient),
        stats=stats, tracer=tracer, cluster=cluster, host=host)


def check_card(executor) -> None:
    """On a card, the K0 canary (ops.kernels.probe_ok), then K1 and K4
    held against their plain versions and timed (ops.calibrate.
    check_kernels, /debug/vars count_calibration). RuntimeError when the
    canary fails, CalibrationError (a RuntimeError) when a kernel
    disagrees or raises. The JAX node calibrates in a background thread
    and serves on XLA whatever comes of it (pilosa_tpu/server.py:203-217);
    the port has no second engine to serve with, so it checks before it
    serves, at every start. Nothing on the CPU."""
    from .ops.calibrate import check_kernels
    from .ops.kernels import probe_ok

    dev = executor.device
    if dev.type != "cuda":
        return
    if not probe_ok(dev):
        raise RuntimeError(f"kernel canary failed on {dev}: "
                           "refusing to serve")
    check_kernels(dev)


class Server:
    """One node: HTTP API + executor + daemons."""

    def __init__(self, config: Optional[Config] = None, logger=None):
        from .core.holder import Holder
        from .core.syncer import Closing
        from .obs.trace import Tracer
        from .utils.stats import ExpvarStats

        self.config = cfg = config or Config()
        refuse_cluster(cfg)
        self.logger = logger or logging.getLogger("pilosa_tpu_torch.server")
        self.closing = Closing()
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
        self._wire_cluster()
        self.handler = build_handler(
            self.holder, cfg.device(), cfg.sparse_density_threshold(),
            mesh_config=cfg.mesh_config(),
            shadow_sample=cfg.integrity_shadow_sample, stats=self.stats,
            tracer=self.tracer, host=self.host, cluster=self.cluster,
            client=self.client)
        self.handler.metrics_sample_interval = cfg.metrics_sample_interval
        self.executor = self.handler.executor
        self.executor.write_consistency = cfg.write_consistency
        self.executor.prefer_local_reads = cfg.prefer_local_reads
        self.executor.hints = self.handler.hints = self.hints
        self.handler.write_consistency = cfg.write_consistency
        self.handler.broadcaster = self.broadcaster
        self.handler.broadcast_handler = self
        self.handler.status_handler = self
        self._ready = False
        self._wire_observability()
        self._wire_convergence()
        self._api = None
        self._threads: list = []
        self._health_started = False
        # The last NodeStatus of each peer (the status poll's).
        self._peer_status: dict = {}

    def _wire_cluster(self):
        """[cluster] onto the Cluster, the ClusterClient, the node set
        and broadcaster (threaded into the holder before it opens) and,
        with more than one host, the HintManager."""
        import os

        from .api.client import ClusterClient
        from .parallel.broadcast import (HTTPBroadcaster, NopBroadcaster,
                                         StaticNodeSet)
        from .parallel.cluster import Cluster, Node
        from .parallel.hints import HintManager

        cfg = self.config
        self.cluster = Cluster(nodes=[Node(h) for h in cfg.cluster_hosts],
                               replica_n=cfg.replica_n,
                               partition_n=cfg.partition_n)
        self.client = ClusterClient(
            timeout=cfg.client_timeout, retry_max=cfg.retry_max,
            retry_backoff=cfg.retry_backoff,
            breaker_threshold=cfg.breaker_threshold,
            breaker_cooldown=cfg.breaker_cooldown)
        self.node_set = StaticNodeSet(cfg.cluster_hosts)
        if cfg.cluster_type == "http" and len(cfg.cluster_hosts) > 1:
            self.broadcaster = HTTPBroadcaster(
                self.node_set, self.host, self.client.for_host,
                logger=self.logger)
        else:
            self.broadcaster = NopBroadcaster()
        self.holder.broadcaster = self.broadcaster
        self.hints = None
        if len(self.cluster.nodes) > 1:
            self.hints = HintManager(
                os.path.join(cfg.expanded_data_dir(), ".hints"),
                client_factory=self.client.for_host,
                breaker_state=self.client.breaker_state,
                max_bytes=cfg.hint_max_bytes,
                drain_interval=cfg.hint_drain_interval,
                wal_cfg=cfg.wal_config(), stats=self.stats)
            self.client.breakers.on_change = self._breaker_change

    def _wire_observability(self):
        """[obs], [sched], [slo], [health] and [cluster] query-deadline
        onto the handler, the executor and the process-wide stores."""
        import os

        from .obs import costs, health, slo

        cfg, h, ex = self.config, self.handler, self.executor
        h.profile_sample_rate = cfg.profile_sample_rate
        h.default_deadline = cfg.query_deadline
        # The fleet pane's cache (/debug/fleet over the cluster's
        # members).
        h.fleet_scrape_interval = cfg.fleet_scrape_interval
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
        reg.mark_critical("sched-dispatch", "wal", "hint-drain",
                          "mesh-count-batch")
        h.ready_fn = lambda: self._ready
        reg.bundle_providers.update({
            "config": lambda: health.redact_config(vars(cfg)),
            "slow_queries": self._bundle_endpoint("/debug/queries"),
            "queryshapes": self._bundle_endpoint("/debug/queryshapes"),
            "slo": self._bundle_endpoint("/debug/slo"),
            "costs": self._bundle_endpoint("/debug/costs"),
            "vars": self._bundle_endpoint("/debug/vars"),
        })

    def _wire_convergence(self):
        """The read path's settings, read-repair's source and the
        scrubber's cross-replica diff."""
        cfg, ex = self.config, self.executor
        self.handler.default_read_staleness = cfg.default_read_staleness
        ex.result_cache.cap = max(1, int(cfg.result_cache_size))
        ex.result_cache_verify_1_in = int(cfg.result_cache_verify_1_in)
        self.holder.integrity.repair_source = self._repair_source
        scrub = self.holder.scrubber
        scrub.host, scrub.cluster = self.host, self.cluster
        scrub.client_factory = self.client.for_host
        scrub.stats = self.stats
        scrub.op_deadline = cfg.sync_block_deadline

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
            node = self.cluster.node_by_host(self.config.host)
            if node is not None:
                node.host = self.host
            self.executor.host = self.handler.host = self.host
            self.holder.scrubber.host = self.host
            if hasattr(self.broadcaster, "local_host"):
                self.broadcaster.local_host = self.host
        self._api.start()
        self.logger.info("config read but not acted on yet: %s",
                         "; ".join(NOT_ACTED_ON))
        from .obs.health import HEALTH

        # The watchdog before the loops it watches.
        HEALTH.start()
        self._health_started = True
        if self.hints is not None:
            self.hints.start()
        hb = HEALTH.register("cache-flush", interval=CACHE_FLUSH_INTERVAL)
        poll_hb = HEALTH.register("status-poll",
                                  interval=self.config.polling_interval)
        daemons = [("cache-flush", self._loop,
                    (self.holder.flush_caches, CACHE_FLUSH_INTERVAL, hb)),
                   ("status-poll", self._loop,
                    (self._status_poll_tick, self.config.polling_interval,
                     poll_hb)),
                   ("warm", self.holder.warm, (self.closing,))]
        ae = self.config.anti_entropy_interval
        if len(self.cluster.nodes) > 1 and ae > 0:
            jitter = self.config.anti_entropy_jitter
            jitter = jitter if jitter >= 0 else 0.1 * ae
            ae_hb = HEALTH.register("anti-entropy", interval=ae + jitter)
            daemons.append(("anti-entropy", self._loop,
                            (self._anti_entropy_tick, ae, ae_hb, jitter)))
        for name, target, args in daemons:
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
            for name in ("cache-flush", "status-poll", "anti-entropy"):
                HEALTH.unregister(name)
            HEALTH.stop()
            self._health_started = False
        self.closing.close()
        # Join warm BEFORE holder.close(): a warm mid-load after close
        # would reopen a WAL fd on a fragment whose flock was released.
        for t in self._threads:
            t.join(timeout=10)
        if self.hints is not None:
            self.hints.close()
        if self._api is not None:
            self._api.close()
        try:
            self.executor.invalidate_device_index()
        except Exception as e:  # noqa: BLE001 — the card may be gone
            self.logger.warning("view drop at close: %s", e)
        self.holder.close()

    def _loop(self, fn, interval: float, hb, jitter: float = 0.0):
        """fn every `interval` seconds, each run up to `jitter` seconds
        late (uniform: nodes that share a config do not run in step)."""
        import random

        while not self.closing.wait(interval):
            if jitter > 0 and self.closing.wait(random.uniform(0, jitter)):
                return
            hb.beat()
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — daemons never die
                self.logger.warning("daemon error: %s", e)
            hb.beat()  # a long run is not the wait's stall

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

    # -- the cluster -------------------------------------------------------------

    def _breaker_change(self, host: str, state: str):
        """An opening breaker marks its node DOWN (writes then hint it
        instead of waiting on it); a closing one marks it UP and wakes
        the drainer."""
        from .api.client import BREAKER_CLOSED, BREAKER_OPEN

        if state == BREAKER_OPEN:
            if self.cluster.mark_unreachable(host):
                self.logger.info("breaker open: marked %s DOWN", host)
        elif state == BREAKER_CLOSED:
            if self.cluster.mark_live(host):
                self.logger.info("breaker closed: %s back UP", host)
            if self.hints is not None:
                self.hints.notify(host)

    def _anti_entropy_tick(self):
        """One HolderSyncer pass over the fragments this node owns, the
        `anti-entropy` subsystem's in-flight op (visibility only: a
        pass's wall time scales with the data, its first one hashes
        every owned fragment)."""
        import time

        from .core.syncer import HolderSyncer
        from .obs.health import HEALTH

        if len(self.cluster.nodes) <= 1:
            return
        t0 = time.monotonic()
        with HEALTH.inflight("anti-entropy", "pass"):
            HolderSyncer(self.holder, self.host, self.cluster,
                         self.client.for_host, self.closing,
                         stats=self.stats,
                         op_deadline=self.config.sync_block_deadline
                         ).sync_holder()
        self.stats.count("anti_entropy", 1)
        self.logger.info("anti-entropy pass in %.2f s",
                         time.monotonic() - t0)

    def _repair_source(self, frag) -> Optional[bytes]:
        """Read-repair's source: the fragment's tar from the first UP
        replica whose copy verifies, its footer and its block checksums
        against what the same replica reports at /fragment/blocks (a
        rotted replica never becomes the donor); None when none does."""
        from .core.fragment import bitmap_block_checksums, bitmap_from_tar
        from .parallel.cluster import NODE_STATE_UP

        for node in self.cluster.fragment_nodes(frag.index, frag.slice):
            if node.host == self.host or node.state != NODE_STATE_UP:
                continue
            client = self.client.for_host(node.host)
            try:
                tar = client.fragment_data(frag.index, frag.frame,
                                           frag.view, frag.slice)
                bm = bitmap_from_tar(tar) if tar else None
                if bm is None:
                    continue
                want = dict(client.fragment_blocks(
                    frag.index, frag.frame, frag.view, frag.slice))
                if bitmap_block_checksums(bm) != want:
                    self.logger.warning(
                        "read-repair: %s serves inconsistent checksums "
                        "for %s/%s/%s/%d; skipped", node.host, frag.index,
                        frag.frame, frag.view, frag.slice)
                    continue
                return tar
            except Exception as e:  # noqa: BLE001 — the next replica
                self.logger.warning("read-repair fetch from %s failed: %s",
                                    node.host, e)
        return None

    def _status_poll_tick(self):
        """Each peer's /internal/status: its schema and max slices are
        merged here, an unreachable peer is marked DOWN, a reachable one
        UP, and a peer back from DOWN wakes the drainer. The epoch
        tracker first sees this node's own epochs (writes that passed
        no coordinator here: replica legs, imports, repairs, replays),
        then each reachable peer's digest; an unreachable peer is
        forgotten (no digest: no follower read)."""
        from .parallel.cluster import NODE_STATE_DOWN

        tracker = self.executor.epochs
        try:
            tracker.observe_digest(self.host, self.holder.fragment_epochs(),
                                   self.handler.queue_depth())
        except Exception:  # noqa: BLE001 — telemetry never stops a poll
            pass
        for node in self.cluster.nodes:
            if node.host == self.host:
                continue
            try:
                status = self.client.for_host(node.host).node_status()
            except Exception:  # noqa: BLE001 — an unreachable peer
                node.mark_unreachable()
                tracker.forget_host(node.host)
                continue
            was_down = node.state == NODE_STATE_DOWN
            node.mark_live()
            if was_down and self.hints is not None:
                self.hints.notify(node.host)
            self._peer_status[node.host] = status
            self.handle_remote_status(status)
            try:
                digest = self.client.for_host(node.host).epoch_digest()
                tracker.observe_digest(node.host,
                                       digest.get("epochs") or {},
                                       int(digest.get("queue_depth") or 0))
            except Exception:  # noqa: BLE001 — the digest stays absent
                pass

    def receive_message(self, msg):
        """Apply a peer's broadcast (POST /internal/message)."""
        from . import wire

        if isinstance(msg, wire.CreateSliceMessage):
            idx = self.holder.index(msg.index)
            if idx is None:
                raise ValueError(f"local index not found: {msg.index}")
            if msg.is_inverse:
                idx.set_remote_max_inverse_slice(msg.slice)
            else:
                idx.set_remote_max_slice(msg.slice)
        elif isinstance(msg, wire.CreateIndexMessage):
            meta = msg.meta or wire.IndexMeta()
            self.holder.create_index_if_not_exists(
                msg.index, column_label=meta.column_label or "columnID",
                time_quantum=meta.time_quantum)
        elif isinstance(msg, wire.DeleteIndexMessage):
            self.holder.delete_index(msg.index)
            self.executor.invalidate_device_index(msg.index)
        elif isinstance(msg, wire.CreateFrameMessage):
            idx = self.holder.index(msg.index)
            if idx is None:
                raise ValueError(f"local index not found: {msg.index}")
            self._create_frame(idx, msg.frame, msg.meta or wire.FrameMeta())
        elif isinstance(msg, wire.DeleteFrameMessage):
            idx = self.holder.index(msg.index)
            if idx is not None:
                idx.delete_frame(msg.frame)
                self.executor.invalidate_device_index(msg.index)
        else:
            raise ValueError(f"unknown message: {type(msg).__name__}")

    def _create_frame(self, idx, name: str, meta):
        """A peer's frame here (idempotent), with its integer fields; a
        field whose range differs from the one here is logged and
        skipped (the peers disagree: an operator's problem)."""
        from .bsi.field import FieldSchema, FieldValueError

        f = idx.create_frame_if_not_exists(
            name, row_label=meta.row_label or "rowID",
            inverse_enabled=meta.inverse_enabled,
            cache_type=meta.cache_type or "ranked",
            cache_size=meta.cache_size or 50000,
            time_quantum=meta.time_quantum)
        for d in json.loads(meta.fields_json) if meta.fields_json else []:
            try:
                f.create_field_if_not_exists(FieldSchema.from_dict(d))
            except FieldValueError as e:
                self.logger.warning("field sync skipped for frame %r: %s",
                                    f.name, e)

    def local_status(self):
        """This node's NodeStatus: every index with its meta, max slices
        and frames."""
        from . import wire
        from .api.handler import frame_meta

        ns = wire.NodeStatus(host=self.host, state="UP")
        for _, idx in sorted(self.holder.indexes.items()):
            ns.indexes.append(wire.IndexInfo(
                name=idx.name, meta=wire.IndexMeta(
                    column_label=idx.column_label,
                    time_quantum=str(idx.time_quantum)),
                max_slice=idx.max_slice(),
                max_inverse_slice=idx.max_inverse_slice(),
                frames=[wire.FrameInfo(name=f.name, meta=frame_meta(f))
                        for _, f in sorted(idx.frames.items())]))
        return ns

    def cluster_status(self):
        """This node's status, then each peer's last polled one (or its
        host alone) with the state this node holds for it."""
        from . import wire

        cs = wire.ClusterStatus(nodes=[self.local_status()])
        for node in self.cluster.nodes:
            if node.host == self.host:
                continue
            st = self._peer_status.get(node.host)
            if st is not None:
                st = wire.NodeStatus.decode(st.encode())
                st.state = node.state
                cs.nodes.append(st)
            else:
                cs.nodes.append(wire.NodeStatus(host=node.host,
                                                state=node.state))
        return cs

    def handle_remote_status(self, status):
        """Merge a peer's schema: its indexes and frames made here, its
        max slices learned."""
        from . import wire

        for ii in status.indexes:
            meta = ii.meta or wire.IndexMeta()
            idx = self.holder.create_index_if_not_exists(
                ii.name, column_label=meta.column_label or "columnID",
                time_quantum=meta.time_quantum)
            idx.set_remote_max_slice(ii.max_slice)
            idx.set_remote_max_inverse_slice(ii.max_inverse_slice)
            for fr in ii.frames:
                self._create_frame(idx, fr.name, fr.meta or wire.FrameMeta())
