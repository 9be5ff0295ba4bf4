"""Node configuration: the JAX node's TOML schema, read by the port.

Every key of the JAX package's config (`pilosa_tpu/config.py`) loads
here under the same name, default and validation, and `to_toml` prints
the same text, so a JAX node's file starts a port node unchanged:

    data-dir, host, log-path, use-device
    [cluster] [anti-entropy] [rebalance] [obs] [log] [sched]
    [sched.tenant-weights] [mesh] [storage] [integrity] [slo] [health]
    [plugins] (vestigial) and the declarative [[schema.indexes]] with
    [[schema.indexes.frames]] and [[schema.indexes.frames.fields]]

Durations accept Go-style strings ("10m", "60s", "1h30m", "250ms",
"50us", "10ns"); bare numbers are seconds.

What the port's Server (server.py) acts on: data-dir, host, log-path,
use-device, [log], [mesh], [storage], [integrity] (with
result-cache-verify-1-in), [anti-entropy] (interval, jitter,
block-deadline), [obs], [sched], [slo],
[health], [[schema.indexes]] and [cluster]'s type (http or static),
hosts, replicas, partitions, query-deadline, client-timeout, retries,
retry-backoff, breaker-threshold, breaker-cooldown, prefer-local-reads,
write-consistency, hint-max-bytes, hint-drain-interval,
polling-interval, default-read-staleness and result-cache-size. It
reads and does not act on yet [rebalance]; it refuses type gossip or
spmd and a non-empty ici-hosts, naming the key.

Where the port departs from the JAX node, on purpose:

- use-device: `auto` and `on` mean the card, `off` the CPU. `auto`
  never probes and never falls back: without a card the node refuses
  to start (Config.device).
- [mesh] count-backend: `auto` and `pallas` both mean the hand-written
  CUDA kernels, checked against their plain versions at every start
  (server.check_card); `xla` and `pallas_interpret` raise at load,
  naming the key (parse_count_backend).
- [mesh] stage-chunk-mb becomes the env default
  $PILOSA_TORCH_STAGE_CHUNK_MB (apply_mesh_env);
  $PILOSA_TORCH_SPARSE_DENSITY_THRESHOLD and
  $PILOSA_TORCH_HBM_BUDGET_BYTES keep overriding their keys.

This module imports neither torch nor numpy: `ctl server --dry-run`
prints a resolved config without them.
"""

from __future__ import annotations

import os
import re
import tomllib
from typing import List

STAGE_CHUNK_ENV = "PILOSA_TORCH_STAGE_CHUNK_MB"
THRESHOLD_ENV = "PILOSA_TORCH_SPARSE_DENSITY_THRESHOLD"
COUNT_BACKENDS = ("auto", "pallas")

DEFAULT_HOST = "localhost:10101"
DEFAULT_ANTI_ENTROPY_INTERVAL = 600.0
DEFAULT_POLLING_INTERVAL = 60.0
# The JAX node's [cluster] defaults (read here, never acted on).
DEFAULT_GOSSIP_PORT = 14000
DEFAULT_PARTITION_N = 16
DEFAULT_REPLICA_N = 1

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|\u00b5s|ms|h|m|s)")
_UNIT_S = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 1e-3,
           "us": 1e-6, "\u00b5s": 1e-6, "ns": 1e-9}


def parse_duration(s) -> float:
    """Go-style duration string -> seconds ("10m", "1h30m", "250ms");
    bare numbers, also in a string, are seconds. The one duration parser
    of the port (fault specs and server flags use it too)."""
    if isinstance(s, (int, float)):
        return float(s)
    s = s.strip()
    if not s:
        return 0.0
    try:
        return float(s)  # a bare number in a string: seconds
    except ValueError:
        pass
    pos = 0
    total = 0.0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration: {s!r}")
        total += float(m.group(1)) * _UNIT_S[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration: {s!r}")
    return total


WRITE_CONSISTENCY_LEVELS = ("one", "quorum", "all")


def parse_write_consistency(value: str) -> str:
    """Validate [cluster] write-consistency. Raises on anything else —
    a typo ("qourum") silently downgrading to some default would
    change what an ack means."""
    v = str(value or "").strip().lower()
    if v not in WRITE_CONSISTENCY_LEVELS:
        raise ValueError(
            f"write-consistency must be one of "
            f"{'/'.join(WRITE_CONSISTENCY_LEVELS)}, got {value!r}")
    return v


def parse_count_backend(value) -> str:
    """[mesh] count-backend. `auto` and `pallas` both mean the
    hand-written CUDA kernels: the port has no second engine for a
    calibration to choose. `xla` and `pallas_interpret` have no counterpart
    that serves on a card (only the plain PyTorch versions, which never
    do), so they raise, as does any other value."""
    v = str(value or "").strip().lower()
    if v not in COUNT_BACKENDS:
        raise ValueError(
            f"[mesh] count-backend = {value!r} is not served by this "
            f"port: {'/'.join(COUNT_BACKENDS)} (both mean the CUDA "
            "kernels)")
    return v


def parse_use_device(value: str):
    """Shared use-device token parse (config, env, Executor auto):
    True/False = forced on/off, None = auto. Raises ValueError on
    anything else so a typo can't silently change serving behavior."""
    v = (value or "").strip().lower()
    if v in ("on", "true", "1", "yes"):
        return True
    if v in ("off", "false", "0", "no"):
        return False
    if v in ("auto", ""):
        return None
    raise ValueError(f"use-device must be auto/on/off, got {value!r}")


def _parse_schema(sh: dict) -> List[dict]:
    """Normalize [[schema.indexes]] into plain dicts, validating shape
    and every field definition eagerly (FieldSchema's constructor
    raises on bad names/ranges) — a typo'd declarative schema should
    fail at config load, not halfway through server open."""
    from .bsi.field import FieldSchema

    out = []
    for ix in sh.get("indexes", []):
        name = str(ix.get("name", "")).strip()
        if not name:
            raise ValueError("[[schema.indexes]] entry missing name")
        frames = []
        for fr in ix.get("frames", []):
            fname = str(fr.get("name", "")).strip()
            if not fname:
                raise ValueError(
                    f"schema index {name!r}: frame entry missing name")
            fields = []
            for fd in fr.get("fields", []):
                # Round-trip through FieldSchema for validation; keep
                # the plain dict (to_dict adds derived bitDepth, which
                # from_dict ignores — harmless either way).
                fields.append(FieldSchema.from_dict(dict(fd)).to_dict())
            frames.append({"name": fname,
                           "row-label": str(fr.get("row-label", "")),
                           "fields": fields})
        out.append({"name": name,
                    "column-label": str(ix.get("column-label", "")),
                    "frames": frames})
    return out


class Config:
    def __init__(self):
        self.data_dir: str = "~/.pilosa_tpu"
        self.host: str = DEFAULT_HOST
        self.log_path: str = ""
        # Where the node serves: "auto" and "on" mean the card, "off"
        # the CPU (Config.device).
        self.use_device: str = "auto"
        self.cluster_hosts: List[str] = [DEFAULT_HOST]
        # Broadcast transport: "http" (POST /internal/message to static
        # peers), "gossip" (SWIM membership + epidemic broadcast), or
        # "static" (no broadcast) — reference config.go cluster.type.
        self.cluster_type: str = "http"
        self.gossip_port: int = DEFAULT_GOSSIP_PORT
        self.gossip_seed: str = ""
        # The JAX node's multi-host data plane ([cluster] type =
        # "spmd"): its coordinator and this process's rank. Read only;
        # the port's Server refuses an spmd cluster.
        self.spmd_coordinator: str = ""
        self.spmd_num_processes: int = -1
        self.spmd_process_id: int = -1
        self.replica_n: int = DEFAULT_REPLICA_N
        self.partition_n: int = DEFAULT_PARTITION_N
        # [cluster] fault tolerance (module docstring): per-attempt
        # client timeout, default query deadline (0 = none), transient
        # retry count + backoff base, per-node circuit breaker.
        self.client_timeout: float = 30.0
        self.query_deadline: float = 0.0
        self.retry_max: int = 2
        self.retry_backoff: float = 0.05
        self.breaker_threshold: int = 5
        self.breaker_cooldown: float = 5.0
        # Locality tie-break for slice placement: serve a healthy
        # locally-held replica instead of the ring-order primary. Off
        # by default (reference-faithful load spreading); turn on for
        # read-heavy single-coordinator deployments so a resize with
        # overlapping replica sets keeps QPS flat.
        self.prefer_local_reads: bool = False
        # [cluster] ici-hosts: the JAX node's interconnect peers whose
        # data dirs are replicated here. Read only: the port's Server
        # refuses a non-empty list.
        self.cluster_ici_hosts: List[str] = []
        # [cluster] write consistency + hinted handoff: replica acks
        # required before a write is acked (one|quorum|all), the
        # per-target hint log byte bound, and the drainer pacing.
        self.write_consistency: str = "quorum"
        self.hint_max_bytes: int = 64 << 20
        self.hint_drain_interval: float = 1.0
        # [cluster] read-path resilience: default staleness bound for
        # queries without an X-Pilosa-Staleness header (0 = strict,
        # owner-only reads — the reference semantics) and the
        # epoch-keyed result-cache capacity (entries; 0/negative
        # clamps to 1 at wiring).
        self.default_read_staleness: float = 0.0
        self.result_cache_size: int = 4096
        self.polling_interval: float = DEFAULT_POLLING_INTERVAL
        self.anti_entropy_interval: float = DEFAULT_ANTI_ENTROPY_INTERVAL
        # [anti-entropy] — jitter spreads pass starts across nodes
        # (-1 = auto: 10% of interval); block-deadline bounds each
        # peer block fetch so a wedged replica can't stall the pass.
        self.anti_entropy_jitter: float = -1.0
        self.sync_block_deadline: float = 30.0
        # [rebalance] — live slice migration (parallel/rebalance.py):
        # transfer concurrency, per-transfer retries, backoff base.
        self.rebalance_concurrency: int = 2
        self.rebalance_retry_max: int = 3
        self.rebalance_retry_backoff: float = 0.2
        # Parity-only (reference config.go:50, cmd/server.go:96): the
        # reference declares [plugins] path but ships no plugin loader,
        # so the field is vestigial there and deliberately inert here —
        # accepted so reference TOML files load unchanged, never read.
        self.plugins_path: str = ""
        # [obs] — query tracing: slow-query threshold and the
        # recent-trace ring size (read; the port has no tracer yet).
        self.slow_query_threshold: float = 0.25
        self.trace_ring: int = 256
        # Refresh cadence for the sampled fragment gauges on /metrics
        # (row-cache sizes, cardinality): the walk is cheap but
        # O(fragments), and Prometheus scrapes on a timer.
        self.metrics_sample_interval: float = 10.0
        # Continuous profiling: 0 profiles only on ?profile=true; N
        # every Nth query (read; the port has no profiler yet).
        self.profile_sample_rate: int = 0
        # Federated fleet view (GET /debug/fleet): coordinator-side
        # scrape-round cache TTL — a dashboard polling faster than this
        # reuses the last merged snapshot instead of re-scraping the
        # whole ring.
        self.fleet_scrape_interval: float = 5.0
        # Query-shape flight recorder ring (GET /debug/queryshapes):
        # distinct plan signatures retained (LRU beyond that).
        self.queryshape_ring: int = 256
        # Cost observatory (obs/costs.py): bounded (tenant × shape)
        # resource accounts (LRU overflow folds into the reserved
        # system row, so dimensions stay conserved) and the EWMA+MAD
        # baseline watch behind pilosa_perf_regression. cost-ledger =
        # false turns every attribution tap into one attribute read.
        self.cost_ledger: bool = True
        self.cost_max_accounts: int = 256
        self.cost_watch_bands: int = 256
        self.cost_regression_k: float = 4.0
        self.cost_regression_min_n: int = 32
        # device_us share beyond which a tenant's query responses
        # carry the observe-only X-Pilosa-Cost-Debt header (share and
        # debt ratio, no throttling). <= 0 disables the stamp.
        self.cost_debt_threshold: float = 0.5
        # [log] — structured logging (obs/log.py). `log_format` "json"
        # injects the active trace/span id into every record so log
        # lines join against /debug/traces. `log_file` empty falls back
        # to the top-level log-path, then stderr.
        self.log_level: str = "info"
        self.log_format: str = "text"
        self.log_file: str = ""
        # [sched] — adaptive query scheduler (sched/): deadline-aware
        # admission (429 + Retry-After shedding), adaptive batching
        # window feeding the mesh batch loop, per-tenant weighted fair
        # queues keyed by the X-Pilosa-Tenant header.
        self.sched_enabled: bool = True
        self.sched_max_window_us: float = 2000.0
        self.sched_idle_window_us: float = 150.0
        self.sched_queue_depth: int = 256
        self.sched_default_service_us: float = 1500.0
        self.sched_tenant_weights: dict = {}
        # [mesh] — the card-memory governor (parallel/serve.py): byte
        # budget for staged views (0 = $PILOSA_TORCH_HBM_BUDGET_BYTES,
        # else the card's memory less the headroom fraction; negative =
        # unlimited), plus the plan quarantine knobs (failures before a
        # plan signature leaves the card, and for how long).
        self.mesh_hbm_budget_bytes: int = 0
        self.mesh_hbm_headroom: float = 0.15
        self.mesh_quarantine_after: int = 2
        self.mesh_quarantine_ttl: float = 60.0
        self.mesh_sparse_density_threshold: float = 0.05
        # Staging chunk size (parallel.mesh, installed as the env
        # default $PILOSA_TORCH_STAGE_CHUNK_MB) and the count backend
        # (parse_count_backend: auto and pallas mean the CUDA kernels).
        self.mesh_stage_chunk_mb: int = 64
        self.mesh_count_backend: str = "auto"
        # [storage] — durable sustained-write ingest (core/wal.py):
        # group-commit fsync policy, WAL bound + backpressure deadline,
        # snapshot threshold override (0 = fragment default).
        self.storage_fsync_policy: str = "group"
        self.storage_group_window_us: float = 250.0
        self.storage_max_wal_ops: int = 65536
        self.storage_backpressure_deadline: float = 1.0
        self.storage_max_op_n: int = 0
        # [integrity] — data-integrity subsystem (core/scrub.py,
        # executor shadow verification): scrubber pacing and the
        # device-result sampling rate.
        self.integrity_enabled: bool = True
        self.integrity_scrub_interval: float = 600.0
        self.integrity_rate_limit: int = 16 << 20
        self.integrity_shadow_sample: int = 0
        # Every Nth result-cache HIT is withheld and recomputed
        # through the normal path; a divergence increments the shadow
        # mismatch counter and invalidates the entry. 0 disables.
        self.result_cache_verify_1_in: int = 16
        # [slo] — declared service objectives (obs/slo.py). The
        # availability/latency targets are percentages; shed-rate-max
        # is a fraction; correctness (zero shadow-mismatch growth) has
        # no knob — its budget is always zero.
        self.slo_enabled: bool = True
        self.slo_availability: float = 99.9
        self.slo_p99_us: float = 50_000.0
        self.slo_latency_target: float = 99.0
        self.slo_shed_rate_max: float = 0.05
        # [health] — liveness plane (obs/health.py): the watchdog
        # sweep period, the stall-after deadline multiple applied to
        # every heartbeat interval and in-flight op budget, and the
        # dossier size/retention bounds.
        self.health_enabled: bool = True
        self.health_sweep_interval: float = 1.0
        self.health_stall_after: float = 4.0
        self.health_dossier_max: int = 262_144
        self.health_dossier_keep: int = 8
        # [[schema.indexes]] — declarative schema applied at server
        # open (module docstring). Normalized dicts: {"name", optional
        # "column-label", "frames": [{"name", optional "row-label",
        # "fields": [{"name", "min", "max"}, ...]}, ...]}.
        self.schema_indexes: List[dict] = []

    @classmethod
    def from_toml(cls, path_or_text: str, is_text: bool = False) -> "Config":
        if is_text:
            data = tomllib.loads(path_or_text)
        else:
            with open(path_or_text, "rb") as f:
                data = tomllib.load(f)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict) -> "Config":
        c = cls()
        c.data_dir = data.get("data-dir", c.data_dir)
        c.host = data.get("host", c.host)
        c.log_path = data.get("log-path", c.log_path)
        c.use_device = str(data.get("use-device", c.use_device))
        cl = data.get("cluster", {})
        c.cluster_hosts = list(cl.get("hosts", [])) or [c.host]
        c.cluster_type = str(cl.get("type", c.cluster_type))
        c.gossip_port = int(cl.get("gossip-port", c.gossip_port))
        c.gossip_seed = str(cl.get("gossip-seed", c.gossip_seed))
        c.replica_n = int(cl.get("replicas", c.replica_n))
        c.partition_n = int(cl.get("partitions", c.partition_n))
        c.spmd_coordinator = str(cl.get("spmd-coordinator",
                                        c.spmd_coordinator))
        c.spmd_num_processes = int(cl.get("spmd-processes",
                                          c.spmd_num_processes))
        c.spmd_process_id = int(cl.get("spmd-process-id",
                                       c.spmd_process_id))
        if "client-timeout" in cl:
            c.client_timeout = parse_duration(cl["client-timeout"])
        if "query-deadline" in cl:
            c.query_deadline = parse_duration(cl["query-deadline"])
        c.retry_max = int(cl.get("retries", c.retry_max))
        if "retry-backoff" in cl:
            c.retry_backoff = parse_duration(cl["retry-backoff"])
        c.breaker_threshold = int(cl.get("breaker-threshold",
                                         c.breaker_threshold))
        if "breaker-cooldown" in cl:
            c.breaker_cooldown = parse_duration(cl["breaker-cooldown"])
        c.prefer_local_reads = bool(cl.get("prefer-local-reads",
                                           c.prefer_local_reads))
        c.cluster_ici_hosts = list(cl.get("ici-hosts",
                                          c.cluster_ici_hosts))
        c.write_consistency = parse_write_consistency(
            cl.get("write-consistency", c.write_consistency))
        c.hint_max_bytes = int(cl.get("hint-max-bytes", c.hint_max_bytes))
        if "hint-drain-interval" in cl:
            c.hint_drain_interval = parse_duration(
                cl["hint-drain-interval"])
        if "polling-interval" in cl:
            c.polling_interval = parse_duration(cl["polling-interval"])
        if "default-read-staleness" in cl:
            c.default_read_staleness = parse_duration(
                cl["default-read-staleness"])
        c.result_cache_size = int(cl.get("result-cache-size",
                                         c.result_cache_size))
        ae = data.get("anti-entropy", {})
        if "interval" in ae:
            c.anti_entropy_interval = parse_duration(ae["interval"])
        if "jitter" in ae:
            j = ae["jitter"]
            c.anti_entropy_jitter = (
                -1.0 if str(j).strip().startswith("-")
                else parse_duration(j))
        if "block-deadline" in ae:
            c.sync_block_deadline = parse_duration(ae["block-deadline"])
        rb = data.get("rebalance", {})
        c.rebalance_concurrency = int(rb.get("concurrency",
                                             c.rebalance_concurrency))
        c.rebalance_retry_max = int(rb.get("retries",
                                           c.rebalance_retry_max))
        if "retry-backoff" in rb:
            c.rebalance_retry_backoff = parse_duration(rb["retry-backoff"])
        c.plugins_path = str(data.get("plugins", {}).get("path",
                                                         c.plugins_path))
        ob = data.get("obs", {})
        if "slow-query-threshold" in ob:
            c.slow_query_threshold = parse_duration(
                ob["slow-query-threshold"])
        c.trace_ring = int(ob.get("trace-ring", c.trace_ring))
        if "metrics-sample-interval" in ob:
            c.metrics_sample_interval = parse_duration(
                ob["metrics-sample-interval"])
        c.profile_sample_rate = int(ob.get("profile-sample-rate",
                                           c.profile_sample_rate))
        if "fleet-scrape-interval" in ob:
            c.fleet_scrape_interval = parse_duration(
                ob["fleet-scrape-interval"])
        c.queryshape_ring = int(ob.get("queryshape-ring",
                                       c.queryshape_ring))
        c.cost_ledger = bool(ob.get("cost-ledger", c.cost_ledger))
        c.cost_max_accounts = int(ob.get("cost-max-accounts",
                                         c.cost_max_accounts))
        c.cost_watch_bands = int(ob.get("cost-watch-bands",
                                        c.cost_watch_bands))
        c.cost_regression_k = float(ob.get("cost-regression-k",
                                           c.cost_regression_k))
        c.cost_regression_min_n = int(ob.get("cost-regression-min-n",
                                             c.cost_regression_min_n))
        c.cost_debt_threshold = float(ob.get("cost-debt-threshold",
                                             c.cost_debt_threshold))
        lg = data.get("log", {})
        c.log_level = str(lg.get("level", c.log_level))
        c.log_format = str(lg.get("format", c.log_format))
        c.log_file = str(lg.get("path", c.log_file))
        sc = data.get("sched", {})
        c.sched_enabled = bool(sc.get("enabled", c.sched_enabled))
        c.sched_max_window_us = float(sc.get("max-window-us",
                                             c.sched_max_window_us))
        c.sched_idle_window_us = float(sc.get("idle-window-us",
                                              c.sched_idle_window_us))
        c.sched_queue_depth = int(sc.get("queue-depth",
                                         c.sched_queue_depth))
        c.sched_default_service_us = float(
            sc.get("default-service-us", c.sched_default_service_us))
        c.sched_tenant_weights = {
            str(k): float(v)
            for k, v in dict(sc.get("tenant-weights", {})).items()}
        me = data.get("mesh", {})
        c.mesh_hbm_budget_bytes = int(me.get("hbm-budget-bytes",
                                             c.mesh_hbm_budget_bytes))
        c.mesh_hbm_headroom = float(me.get("hbm-headroom-fraction",
                                           c.mesh_hbm_headroom))
        c.mesh_quarantine_after = int(me.get("quarantine-after",
                                             c.mesh_quarantine_after))
        if "quarantine-ttl" in me:
            c.mesh_quarantine_ttl = parse_duration(me["quarantine-ttl"])
        c.mesh_sparse_density_threshold = float(
            me.get("sparse-density-threshold",
                   c.mesh_sparse_density_threshold))
        c.mesh_stage_chunk_mb = int(me.get("stage-chunk-mb",
                                           c.mesh_stage_chunk_mb))
        c.mesh_count_backend = parse_count_backend(
            me.get("count-backend", c.mesh_count_backend))
        st = data.get("storage", {})
        c.storage_fsync_policy = str(st.get("fsync-policy",
                                            c.storage_fsync_policy))
        c.storage_group_window_us = float(
            st.get("group-commit-window-us", c.storage_group_window_us))
        c.storage_max_wal_ops = int(st.get("max-wal-ops",
                                           c.storage_max_wal_ops))
        if "backpressure-deadline" in st:
            c.storage_backpressure_deadline = parse_duration(
                st["backpressure-deadline"])
        c.storage_max_op_n = int(st.get("max-op-n", c.storage_max_op_n))
        it = data.get("integrity", {})
        c.integrity_enabled = bool(it.get("enabled", c.integrity_enabled))
        if "scrub-interval" in it:
            c.integrity_scrub_interval = parse_duration(
                it["scrub-interval"])
        c.integrity_rate_limit = int(it.get("scrub-rate-limit-bytes",
                                            c.integrity_rate_limit))
        c.integrity_shadow_sample = int(it.get("shadow-sample-1-in",
                                               c.integrity_shadow_sample))
        c.result_cache_verify_1_in = int(it.get(
            "result-cache-verify-1-in", c.result_cache_verify_1_in))
        sl = data.get("slo", {})
        c.slo_enabled = bool(sl.get("enabled", c.slo_enabled))
        c.slo_availability = float(sl.get("availability",
                                          c.slo_availability))
        c.slo_p99_us = float(sl.get("p99-us", c.slo_p99_us))
        c.slo_latency_target = float(sl.get("latency-target",
                                            c.slo_latency_target))
        c.slo_shed_rate_max = float(sl.get("shed-rate-max",
                                           c.slo_shed_rate_max))
        he = data.get("health", {})
        c.health_enabled = bool(he.get("enabled", c.health_enabled))
        if "sweep-interval" in he:
            c.health_sweep_interval = parse_duration(he["sweep-interval"])
        c.health_stall_after = float(he.get("stall-after",
                                            c.health_stall_after))
        c.health_dossier_max = int(he.get("dossier-max",
                                          c.health_dossier_max))
        c.health_dossier_keep = int(he.get("dossier-keep",
                                           c.health_dossier_keep))
        c.schema_indexes = _parse_schema(data.get("schema", {}))
        return c

    def slo_objectives(self) -> dict:
        """The [slo] targets keyed as obs.slo.SLORecorder takes them."""
        return {
            "availability": self.slo_availability,
            "p99_us": self.slo_p99_us,
            "latency_target": self.slo_latency_target,
            "shed_rate_max": self.slo_shed_rate_max,
        }

    def expanded_data_dir(self) -> str:
        return os.path.expanduser(self.data_dir)

    def wal_config(self):
        """Build the [storage] WalConfig threaded Holder -> Fragment.
        Raises ValueError on a bad fsync-policy (a typo must not
        silently weaken durability)."""
        from .core.wal import WalConfig  # imports torch: not at load

        return WalConfig(
            fsync_policy=self.storage_fsync_policy,
            group_window_us=self.storage_group_window_us,
            max_wal_ops=self.storage_max_wal_ops,
            backpressure_deadline=self.storage_backpressure_deadline,
            max_op_n=self.storage_max_op_n or None)

    def mesh_config(self) -> dict:
        """The card-memory governor's [mesh] knobs, as the dict that
        Executor(mesh_config=) takes (parallel.serve.MESH_DEFAULTS)."""
        return {
            "hbm_budget_bytes": self.mesh_hbm_budget_bytes,
            "hbm_headroom": self.mesh_hbm_headroom,
            "quarantine_after": self.mesh_quarantine_after,
            "quarantine_ttl": self.mesh_quarantine_ttl,
        }

    def sparse_density_threshold(self) -> float:
        """[mesh] sparse-density-threshold; $PILOSA_TORCH_SPARSE_DENSITY_
        THRESHOLD wins when it is set."""
        env = os.environ.get(THRESHOLD_ENV)
        return float(env) if env else self.mesh_sparse_density_threshold

    def apply_mesh_env(self) -> None:
        """Install [mesh] stage-chunk-mb as a process-env default
        (setdefault: an exported $PILOSA_TORCH_STAGE_CHUNK_MB wins); the
        stager reads it at each staging (parallel.mesh)."""
        os.environ.setdefault(STAGE_CHUNK_ENV, str(self.mesh_stage_chunk_mb))

    def use_device_flag(self):
        """None = auto, True/False = forced on/off. Unrecognized values
        raise: a typo ("onn") must not change where the node serves."""
        return parse_use_device(self.use_device)

    def device(self) -> str:
        """The torch device the node serves on. The port departs from
        the JAX node here: `auto` never probes and never falls back to
        the CPU; it means the card, as `on` does, and a node without one
        refuses to start. Only `off` (the caller's explicit choice) is
        the CPU."""
        return "cpu" if self.use_device_flag() is False else "cuda"

    def to_toml(self) -> str:
        """Default-config printer (`pilosa config`, ctl/config.go)."""
        hosts = ", ".join(f'"{h}"' for h in self.cluster_hosts)
        return (
            f'data-dir = "{self.data_dir}"\n'
            f'host = "{self.host}"\n'
            f'log-path = "{self.log_path}"\n'
            f'use-device = "{self.use_device}"\n'
            f"\n[cluster]\n"
            f'type = "{self.cluster_type}"\n'
            f"replicas = {self.replica_n}\n"
            f"partitions = {self.partition_n}\n"
            f"hosts = [{hosts}]\n"
            f"gossip-port = {self.gossip_port}\n"
            f'gossip-seed = "{self.gossip_seed}"\n'
            f'spmd-coordinator = "{self.spmd_coordinator}"\n'
            f"spmd-processes = {self.spmd_num_processes}\n"
            f"spmd-process-id = {self.spmd_process_id}\n"
            f'client-timeout = "{int(self.client_timeout * 1000)}ms"\n'
            f'query-deadline = "{int(self.query_deadline * 1000)}ms"\n'
            f"retries = {self.retry_max}\n"
            f'retry-backoff = "{int(self.retry_backoff * 1000)}ms"\n'
            f"breaker-threshold = {self.breaker_threshold}\n"
            f'breaker-cooldown = "{int(self.breaker_cooldown * 1000)}ms"\n'
            f"prefer-local-reads = "
            f"{'true' if self.prefer_local_reads else 'false'}\n"
            f"ici-hosts = ["
            + ", ".join(f'"{h}"' for h in self.cluster_ici_hosts)
            + "]\n"
            f'write-consistency = "{self.write_consistency}"\n'
            f"hint-max-bytes = {self.hint_max_bytes}\n"
            f'hint-drain-interval = '
            f'"{int(self.hint_drain_interval * 1000)}ms"\n'
            f'polling-interval = "{int(self.polling_interval)}s"\n'
            f'default-read-staleness = '
            f'"{int(self.default_read_staleness * 1000)}ms"\n'
            f"result-cache-size = {self.result_cache_size}\n"
            f"\n[anti-entropy]\n"
            f'interval = "{int(self.anti_entropy_interval)}s"\n'
            f'jitter = "{int(self.anti_entropy_jitter)}s"\n'
            f'block-deadline = "{int(self.sync_block_deadline)}s"\n'
            f"\n[rebalance]\n"
            f"concurrency = {self.rebalance_concurrency}\n"
            f"retries = {self.rebalance_retry_max}\n"
            f'retry-backoff = '
            f'"{int(self.rebalance_retry_backoff * 1000)}ms"\n'
            f"\n[obs]\n"
            f'slow-query-threshold = '
            f'"{int(self.slow_query_threshold * 1000)}ms"\n'
            f"trace-ring = {self.trace_ring}\n"
            f'metrics-sample-interval = '
            f'"{int(self.metrics_sample_interval)}s"\n'
            f"profile-sample-rate = {self.profile_sample_rate}\n"
            f'fleet-scrape-interval = '
            f'"{int(self.fleet_scrape_interval)}s"\n'
            f"queryshape-ring = {self.queryshape_ring}\n"
            f"cost-ledger = {'true' if self.cost_ledger else 'false'}\n"
            f"cost-max-accounts = {self.cost_max_accounts}\n"
            f"cost-watch-bands = {self.cost_watch_bands}\n"
            f"cost-regression-k = {self.cost_regression_k}\n"
            f"cost-regression-min-n = {self.cost_regression_min_n}\n"
            f"cost-debt-threshold = {self.cost_debt_threshold}\n"
            f"\n[log]\n"
            f'level = "{self.log_level}"\n'
            f'format = "{self.log_format}"\n'
            f'path = "{self.log_file}"\n'
            f"\n[sched]\n"
            f"enabled = {'true' if self.sched_enabled else 'false'}\n"
            f"max-window-us = {int(self.sched_max_window_us)}\n"
            f"idle-window-us = {int(self.sched_idle_window_us)}\n"
            f"queue-depth = {self.sched_queue_depth}\n"
            f"default-service-us = "
            f"{int(self.sched_default_service_us)}\n"
            f"\n[sched.tenant-weights]\n"
            + "".join(f'"{k}" = {v}\n'
                      for k, v in sorted(self.sched_tenant_weights.items()))
            + f"\n[mesh]\n"
            f"hbm-budget-bytes = {self.mesh_hbm_budget_bytes}\n"
            f"hbm-headroom-fraction = {self.mesh_hbm_headroom}\n"
            f"quarantine-after = {self.mesh_quarantine_after}\n"
            f'quarantine-ttl = '
            f'"{int(self.mesh_quarantine_ttl * 1000)}ms"\n'
            f"sparse-density-threshold = "
            f"{self.mesh_sparse_density_threshold}\n"
            f"stage-chunk-mb = {self.mesh_stage_chunk_mb}\n"
            f'count-backend = "{self.mesh_count_backend}"\n'
            + f"\n[storage]\n"
            f'fsync-policy = "{self.storage_fsync_policy}"\n'
            f"group-commit-window-us = "
            f"{int(self.storage_group_window_us)}\n"
            f"max-wal-ops = {self.storage_max_wal_ops}\n"
            f'backpressure-deadline = '
            f'"{int(self.storage_backpressure_deadline * 1000)}ms"\n'
            f"max-op-n = {self.storage_max_op_n}\n"
            f"\n[integrity]\n"
            f"enabled = {'true' if self.integrity_enabled else 'false'}\n"
            f'scrub-interval = "{int(self.integrity_scrub_interval)}s"\n'
            f"scrub-rate-limit-bytes = {self.integrity_rate_limit}\n"
            f"shadow-sample-1-in = {self.integrity_shadow_sample}\n"
            f"result-cache-verify-1-in = "
            f"{self.result_cache_verify_1_in}\n"
            f"\n[slo]\n"
            f"enabled = {'true' if self.slo_enabled else 'false'}\n"
            f"availability = {self.slo_availability}\n"
            f"p99-us = {int(self.slo_p99_us)}\n"
            f"latency-target = {self.slo_latency_target}\n"
            f"shed-rate-max = {self.slo_shed_rate_max}\n"
            f"\n[health]\n"
            f"enabled = {'true' if self.health_enabled else 'false'}\n"
            f'sweep-interval = '
            f'"{int(self.health_sweep_interval * 1000)}ms"\n'
            f"stall-after = {self.health_stall_after}\n"
            f"dossier-max = {self.health_dossier_max}\n"
            f"dossier-keep = {self.health_dossier_keep}\n"
            + self._schema_toml()
        )

    def _schema_toml(self) -> str:
        """[[schema.indexes]] tables for to_toml; empty schema emits
        nothing (the section is optional and has no defaults)."""
        parts = []
        for ix in self.schema_indexes:
            parts.append(f'\n[[schema.indexes]]\nname = "{ix["name"]}"\n')
            if ix.get("column-label"):
                parts.append(f'column-label = "{ix["column-label"]}"\n')
            for fr in ix.get("frames", []):
                parts.append(f'\n[[schema.indexes.frames]]\n'
                             f'name = "{fr["name"]}"\n')
                if fr.get("row-label"):
                    parts.append(f'row-label = "{fr["row-label"]}"\n')
                for fd in fr.get("fields", []):
                    parts.append(f'\n[[schema.indexes.frames.fields]]\n'
                                 f'name = "{fd["name"]}"\n'
                                 f'min = {fd["min"]}\n'
                                 f'max = {fd["max"]}\n')
        return "".join(parts)
