"""The broadcast plane: schema and slice changes sent to every peer.

The JAX package's pilosa_tpu/parallel/broadcast.py (the reference's
broadcast.go and httpbroadcast/): a Broadcaster sends a typed wire
message (CreateSlice, CreateIndex, DeleteIndex, CreateFrame,
DeleteFrame) to each peer as POST /internal/message with the one-byte
tag framing; the Server applies what it receives (receive_message).
Liveness comes from the status poll, not from gossip probes.

send_sync delivers to every peer now and raises the first error;
send_async sends from a thread a peer and returns at once.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

from ..wire import marshal_message


class Broadcaster:
    def send_sync(self, msg) -> None:
        raise NotImplementedError

    def send_async(self, msg) -> None:
        raise NotImplementedError


class NopBroadcaster(Broadcaster):
    def send_sync(self, msg) -> None:
        pass

    def send_async(self, msg) -> None:
        pass


class StaticNodeSet:
    """The peer hosts, fixed by the config."""

    def __init__(self, hosts: Optional[Sequence[str]] = None):
        self._hosts = list(hosts or [])

    def nodes(self) -> List[str]:
        return list(self._hosts)

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass


class HTTPBroadcaster(Broadcaster):
    """Delivers framed messages to every peer but `local_host`;
    `client_factory(host)` gives a client with send_message(bytes)."""

    def __init__(self, node_set: StaticNodeSet, local_host: str,
                 client_factory: Callable, logger=None):
        self.node_set = node_set
        self.local_host = local_host
        self.client_factory = client_factory
        self.logger = logger or logging.getLogger(
            "pilosa_tpu_torch.broadcast")

    def _peers(self) -> List[str]:
        return [h for h in self.node_set.nodes() if h != self.local_host]

    def _send(self, host: str, data: bytes) -> Optional[Exception]:
        try:
            self.client_factory(host).send_message(data)
            return None
        except Exception as e:  # noqa: BLE001 — the caller decides
            self.logger.warning("broadcast to %s failed: %s", host, e)
            return e

    def send_sync(self, msg) -> None:
        data = marshal_message(msg)
        peers = self._peers()
        if not peers:
            return
        with ThreadPoolExecutor(max_workers=len(peers)) as pool:
            for err in pool.map(lambda h: self._send(h, data), peers):
                if err is not None:
                    raise err

    def send_async(self, msg) -> None:
        data = marshal_message(msg)
        for host in self._peers():
            threading.Thread(target=self._send, args=(host, data),
                             name="broadcast-send", daemon=True).start()
