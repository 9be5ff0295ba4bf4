"""Server: one node as an operator runs it, from a Config (config.py).

Wires Config -> Holder (the stats client, the [storage] WalConfig, the
[integrity] scrubber) -> Executor (the device from use-device, the
[mesh] knobs, the sparse-density threshold, the shadow sample) ->
Handler -> APIServer. `build_handler` is the one place a node's
executor and handler are made: `api.server.serve` uses it too.

open() opens the holder, applies the declared [[schema.indexes]]
(idempotent), runs the K0 canary on a card (a card that fails it is
refused before the socket is bound), binds (port 0 picks a free port and
the node's host becomes the real address), and starts the daemons: the
rank-cache flush every 60 s, the scrubber at scrub-interval with 10%
jitter when [integrity] is enabled, and the `warm` thread that loads
the fragments a start left lazy. close() stops them in the JAX node's
order: `warm` is joined before the holder closes, and the staged views
leave the card first.

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
NOT_ACTED_ON = ("[anti-entropy]", "[rebalance]", "[sched]", "[slo]",
                "[health]", "[obs] but metrics-sample-interval",
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
                  stats=None):
    """The node's Executor and Handler over an open or opening holder;
    frame restore reaches other nodes through api.client.InternalClient.
    Returns the Handler (its `executor` is the Executor)."""
    from .api.client import InternalClient
    from .api.handler import Handler
    from .executor import Executor

    ex = Executor(holder, device=device,
                  sparse_density_threshold=sparse_density_threshold,
                  mesh_config=mesh_config, shadow_sample=shadow_sample)
    return Handler(holder, ex, client_factory=InternalClient, stats=stats)


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
        self.handler = build_handler(
            self.holder, cfg.device(), cfg.sparse_density_threshold(),
            mesh_config=cfg.mesh_config(),
            shadow_sample=cfg.integrity_shadow_sample, stats=self.stats)
        self.handler.metrics_sample_interval = cfg.metrics_sample_interval
        self.executor = self.handler.executor
        self._api = None
        self._threads: list = []

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
        for name, target, args in (
                ("cache-flush", self._loop,
                 (self.holder.flush_caches, CACHE_FLUSH_INTERVAL)),
                ("warm", self.holder.warm, (self.closing,))):
            t = threading.Thread(target=target, name=name, args=args,
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def close(self):
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

    def _loop(self, fn, interval: float):
        while not self.closing.wait(interval):
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
