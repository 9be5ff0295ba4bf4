"""Socket adapter: mounts a Handler on a threading HTTP server.

Run a node:  python -m pilosa_tpu_torch.api.server -d DIR -b HOST:PORT
(add --device cpu to serve without a card, and
--sparse-density-threshold 0 to stage every slice as packed words; the
flag's default comes from $PILOSA_TORCH_SPARSE_DENSITY_THRESHOLD when
that is set). --fsync-policy {never,group,always} sets when a write is
acknowledged (core/wal.py); the default, `group`, is the JAX server's.
--hbm-budget-bytes, --hbm-headroom-fraction, --quarantine-after and
--quarantine-ttl are the card-memory governor's [mesh] knobs
(parallel/serve.MESH_DEFAULTS), with the JAX server's defaults.
--max-wal-ops, --backpressure-deadline and --max-op-n are its [storage]
knobs (core/wal.WalConfig), --scrub-interval, --scrub-rate-limit-bytes
and --shadow-sample-1-in its [integrity] ones (core/scrub.py,
Executor.shadow_sample), with the JAX config's names and defaults.
$PILOSA_TORCH_FAULT arms fault rules at start (fault.py). SIGTERM or
SIGINT closes the server and the holder. A node run from a TOML config
is `python -m pilosa_tpu_torch.ctl server -c FILE` (server.Server).
"""

from __future__ import annotations

import argparse
import os
import signal
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from .. import fault
from ..core.scrub import DEFAULT_SCRUB_RATE_LIMIT
from ..core.wal import (DEFAULT_BACKPRESSURE_DEADLINE, DEFAULT_MAX_WAL_OPS,
                        FSYNC_GROUP, FSYNC_POLICIES, WalConfig)
from ..config import THRESHOLD_ENV, parse_duration
from ..parallel.mesh import DEFAULT_SPARSE_DENSITY_THRESHOLD
from ..parallel.serve import BUDGET_ENV, MESH_DEFAULTS


class APIServer:
    """Owns the listening socket + serve thread for one Handler."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        api = self

        class _Request(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # A response goes out as two writes (headers, then body):
            # with Nagle on, the body can wait for the client's delayed
            # ACK of the headers, tens of ms a request on some hosts.
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):
                pass

            def _dispatch(self):
                parsed = urllib.parse.urlsplit(self.path)
                params = {k: v[-1] for k, v in
                          urllib.parse.parse_qs(parsed.query).items()}
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                resp = api.handler.handle(
                    self.command, parsed.path.rstrip("/") or "/", params,
                    dict(self.headers.items()), body)
                self.send_response(resp.status)
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(resp.body)))
                self.end_headers()
                self.wfile.write(resp.body)

            do_GET = do_POST = do_PATCH = do_DELETE = _dispatch

        # Herds of concurrent clients overflow the default backlog of 5.
        srv_cls = type("_PilosaHTTPServer", (ThreadingHTTPServer,),
                       {"request_queue_size": 128, "daemon_threads": True})
        self._server = srv_cls((host, port), _Request)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address[:2]

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="pilosa-http", daemon=True)
        self._thread.start()

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def serve(holder, device="cuda", host: str = "127.0.0.1", port: int = 0,
          sparse_density_threshold: float =
          DEFAULT_SPARSE_DENSITY_THRESHOLD, shadow_sample: int = 0,
          **mesh_config) -> APIServer:
    """Start serving `holder`; returns the running APIServer. mesh_config:
    the card-memory governor's knobs (hbm_budget_bytes, hbm_headroom,
    quarantine_after, quarantine_ttl; parallel.serve.MESH_DEFAULTS).
    shadow_sample: check 1 in N card answers on the host (0: off). Frame
    restore reaches other nodes through api.client.InternalClient.
    server.check_card runs first (on a card the K0 canary and the
    check of K1 and K4), and a card that fails it is refused before
    the socket is bound. The executor and handler come from
    server.build_handler, as a Server's do."""
    from ..server import build_handler, check_card

    handler = build_handler(holder, device, sparse_density_threshold,
                            mesh_config=mesh_config,
                            shadow_sample=shadow_sample,
                            stats=holder.stats)
    check_card(handler.executor)
    srv = APIServer(handler, host, port)
    srv.start()
    return srv


def parse_args(argv=None) -> argparse.Namespace:
    """The server's flags. --sparse-density-threshold defaults to
    $PILOSA_TORCH_SPARSE_DENSITY_THRESHOLD when set, else 0.05."""
    ap = argparse.ArgumentParser(prog="python -m pilosa_tpu_torch.api.server")
    ap.add_argument("-d", "--data-dir", required=True)
    ap.add_argument("-b", "--bind", default="127.0.0.1:10101")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sparse-density-threshold", type=float,
                    default=float(os.environ.get(THRESHOLD_ENV) or
                                  DEFAULT_SPARSE_DENSITY_THRESHOLD),
                    help="mean container fill under which a slice stages "
                         f"as sorted arrays; <= 0 stages all dense "
                         f"(default: ${THRESHOLD_ENV}, else "
                         f"{DEFAULT_SPARSE_DENSITY_THRESHOLD})")
    ap.add_argument("--fsync-policy", choices=FSYNC_POLICIES,
                    default=FSYNC_GROUP,
                    help="when a SetBit / ClearBit is acknowledged: after "
                         "a group-commit fsync covers its op record "
                         "(group, the default), after its own fsync "
                         "(always), or at once, without fsync (never)")
    ap.add_argument("--hbm-budget-bytes", type=int,
                    default=MESH_DEFAULTS["hbm_budget_bytes"],
                    help="device bytes the staged views may hold; 0: "
                         f"${BUDGET_ENV}, else the card's total memory "
                         "less the headroom fraction; negative: unlimited")
    ap.add_argument("--hbm-headroom-fraction", type=float,
                    default=MESH_DEFAULTS["hbm_headroom"],
                    help="share of the card's memory the derived budget "
                         "leaves to the kernels' own tensors")
    ap.add_argument("--quarantine-after", type=int,
                    default=MESH_DEFAULTS["quarantine_after"],
                    help="out-of-memory failures after eviction of one "
                         "plan signature before it is kept off the card "
                         "(the host answers it)")
    ap.add_argument("--quarantine-ttl", type=float,
                    default=MESH_DEFAULTS["quarantine_ttl"],
                    help="seconds a quarantined plan signature stays off "
                         "the card")
    ap.add_argument("--max-wal-ops", type=int, default=DEFAULT_MAX_WAL_OPS,
                    help="ops of a fragment not yet covered by a snapshot "
                         "past which writers wait for one (0: unbounded)")
    ap.add_argument("--backpressure-deadline", type=parse_duration,
                    default=DEFAULT_BACKPRESSURE_DEADLINE,
                    help="how long a waiting writer waits for a snapshot "
                         "before it is shed with 503 and Retry-After "
                         "(seconds, or 250ms, 1s)")
    ap.add_argument("--max-op-n", type=int, default=0,
                    help="ops after which a fragment snapshots in the "
                         "background (0: the default, 2000)")
    ap.add_argument("--scrub-interval", type=parse_duration, default=600.0,
                    help="how often the scrubber re-verifies every "
                         "fragment file (seconds, or 10m; 0: off)")
    ap.add_argument("--scrub-rate-limit-bytes", type=int,
                    default=DEFAULT_SCRUB_RATE_LIMIT,
                    help="the scrubber's read budget, bytes/s (0: unpaced)")
    ap.add_argument("--shadow-sample-1-in", type=int, default=0,
                    help="recompute 1 in N card Count / TopN / Sum / Min / "
                         "Max answers on the host and compare (0: off)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    from ..core import Holder
    from ..utils.stats import ExpvarStats

    args = parse_args(argv)
    fault.load_env()
    host, _, port = args.bind.rpartition(":")
    holder = Holder(args.data_dir, wal=WalConfig(
        args.fsync_policy, max_wal_ops=args.max_wal_ops,
        backpressure_deadline=args.backpressure_deadline,
        max_op_n=args.max_op_n or None),
        scrub_interval=args.scrub_interval,
        scrub_rate_limit=args.scrub_rate_limit_bytes, stats=ExpvarStats())
    t0 = time.monotonic()
    holder.open()
    open_s = time.monotonic() - t0
    srv = serve(holder, args.device, host or "127.0.0.1", int(port),
                args.sparse_density_threshold,
                shadow_sample=args.shadow_sample_1_in,
                hbm_budget_bytes=args.hbm_budget_bytes,
                hbm_headroom=args.hbm_headroom_fraction,
                quarantine_after=args.quarantine_after,
                quarantine_ttl=args.quarantine_ttl)
    print(f"serving {args.data_dir} on {host}:{port} ({args.device}); "
          f"holder opened in {open_s:.3f} s", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
        holder.close()


if __name__ == "__main__":
    main()
