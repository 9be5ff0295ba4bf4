"""Socket adapter: mounts a Handler on a threading HTTP server.

Run a node:  python -m pilosa_tpu_torch.api.server -d DIR -b HOST:PORT
(add --device cpu to serve without a card, and
--sparse-density-threshold 0 to stage every slice as packed words; the
flag's default comes from $PILOSA_TORCH_SPARSE_DENSITY_THRESHOLD when
that is set).
"""

from __future__ import annotations

import argparse
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from ..parallel.mesh import DEFAULT_SPARSE_DENSITY_THRESHOLD

THRESHOLD_ENV = "PILOSA_TORCH_SPARSE_DENSITY_THRESHOLD"


class APIServer:
    """Owns the listening socket + serve thread for one Handler."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        api = self

        class _Request(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

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

            do_GET = do_POST = _dispatch

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
          DEFAULT_SPARSE_DENSITY_THRESHOLD) -> APIServer:
    """Start serving `holder`; returns the running APIServer."""
    from ..executor import Executor
    from .handler import Handler

    ex = Executor(holder, device=device,
                  sparse_density_threshold=sparse_density_threshold)
    srv = APIServer(Handler(holder, ex), host, port)
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
    return ap.parse_args(argv)


def main(argv=None) -> None:
    from ..core import Holder

    args = parse_args(argv)
    host, _, port = args.bind.rpartition(":")
    holder = Holder(args.data_dir)
    holder.open()
    srv = serve(holder, args.device, host or "127.0.0.1", int(port),
                args.sparse_density_threshold)
    print(f"serving {args.data_dir} on {host}:{port} ({args.device})",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
        holder.close()


if __name__ == "__main__":
    main()
