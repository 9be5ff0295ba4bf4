"""Cluster placement: nodes, partitions and replica owners.

The JAX package's placement (pilosa_tpu/parallel/cluster.py), itself the
reference's cluster.go:198-277: the column space is cut into 2^20-wide
slices, (index, slice) hashes to one of `partition_n` partitions by
fnv64a over the index's bytes and the big-endian slice, and a partition
goes to `replica_n` consecutive nodes of the ring from the jump
consistent hash's primary. Placement depends only on a host's position
in the node list, so two clusters that list their hosts in one order
place every slice alike.

Node states are spelled as the JAX package spells them on the wire and
in /status. The resize lifecycle (JOINING, LEAVING, the handoff ledger)
comes with membership change (ROADMAP A11c); the static cluster keeps
the constants and the legal edges, and liveness moves a node between UP
and DOWN only.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

DEFAULT_PARTITION_N = 16
DEFAULT_REPLICA_N = 1

NODE_STATE_UP = "UP"
NODE_STATE_ACTIVE = NODE_STATE_UP
NODE_STATE_DOWN = "DOWN"
NODE_STATE_JOINING = "JOINING"
NODE_STATE_LEAVING = "LEAVING"

# States that may serve queries.
SERVING_STATES = (NODE_STATE_UP, NODE_STATE_LEAVING)

# Legal lifecycle edges (anything -> DOWN goes through mark_unreachable).
_TRANSITIONS = {
    NODE_STATE_JOINING: {NODE_STATE_UP, NODE_STATE_DOWN},
    NODE_STATE_UP: {NODE_STATE_LEAVING, NODE_STATE_DOWN},
    NODE_STATE_LEAVING: {NODE_STATE_UP, NODE_STATE_DOWN},
    NODE_STATE_DOWN: {NODE_STATE_JOINING, NODE_STATE_UP},
}

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv64a(data: bytes) -> int:
    h = _FNV64_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & _MASK64
    return h


class Node:
    """One member: its host ("ip:port") and its state."""

    def __init__(self, host: str, internal_host: str = "",
                 state: str = NODE_STATE_UP):
        self.host = host
        self.internal_host = internal_host
        self.state = state

    def set_state(self, state: str):
        """Raw setter, for liveness feeds that speak only UP and DOWN."""
        self.state = state

    def transition(self, state: str):
        """A lifecycle edge; ValueError for one _TRANSITIONS lacks."""
        if state == self.state:
            return
        if state not in _TRANSITIONS.get(self.state, ()):
            raise ValueError(f"illegal node transition {self.state} -> "
                             f"{state} for {self.host}")
        self.state = state

    def mark_live(self):
        """A reachable node that was DOWN is UP again."""
        if self.state == NODE_STATE_DOWN:
            self.state = NODE_STATE_UP

    def mark_unreachable(self):
        self.state = NODE_STATE_DOWN

    def to_dict(self) -> dict:
        return {"host": self.host, "internalHost": self.internal_host}

    def __repr__(self):
        return f"Node({self.host!r})"


class JmpHasher:
    """Jump consistent hash (Lamping and Veach), the default."""

    def hash(self, key: int, n: int) -> int:
        key &= _MASK64
        b, j = -1, 0
        while j < n:
            b = j
            key = (key * 2862933555777941757 + 1) & _MASK64
            j = int(float(b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
        return b


class ModHasher:
    """key % n: a deterministic hasher for tests."""

    def hash(self, key: int, n: int) -> int:
        return key % n


class ConstHasher:
    """Always bucket `i`: a hasher for tests."""

    def __init__(self, i: int = 0):
        self.i = i

    def hash(self, key: int, n: int) -> int:
        return self.i


class Cluster:
    """The node list and the placement over it."""

    def __init__(self, nodes: Optional[List[Node]] = None, hasher=None,
                 partition_n: int = DEFAULT_PARTITION_N,
                 replica_n: int = DEFAULT_REPLICA_N):
        self.nodes: List[Node] = nodes or []
        self.hasher = hasher or JmpHasher()
        self.partition_n = partition_n
        self.replica_n = replica_n
        # (index, partition_n) -> partition of slice s at [s].
        self._parts: Dict[tuple, np.ndarray] = {}
        self._parts_mu = threading.Lock()

    def hosts(self) -> List[str]:
        return [n.host for n in self.nodes]

    def node_by_host(self, host: str) -> Optional[Node]:
        for n in self.nodes:
            if n.host == host:
                return n
        return None

    def mark_unreachable(self, host: str) -> bool:
        """host -> DOWN; True when it was not DOWN already."""
        n = self.node_by_host(host)
        if n is None or n.state == NODE_STATE_DOWN:
            return False
        n.mark_unreachable()
        return True

    def mark_live(self, host: str) -> bool:
        """host DOWN -> UP; True when it came back (the edge that wakes
        a hint drainer)."""
        n = self.node_by_host(host)
        if n is None or n.state != NODE_STATE_DOWN:
            return False
        n.mark_live()
        return True

    def node_states(self) -> Dict[str, str]:
        return {n.host: n.state for n in self.nodes}

    def partition(self, index: str, slice_: int) -> int:
        data = index.encode() + int(slice_).to_bytes(8, "big")
        return fnv64a(data) % self.partition_n

    def partitions(self, index: str, slices) -> np.ndarray:
        """partition() of each of `slices`, as an int64 array: each
        index's hashes are kept (they depend on nothing else), so a
        query's placement costs a lookup a slice, not a hash."""
        idx = np.asarray(slices, dtype=np.int64)
        if not idx.size:
            return idx
        key = (index, self.partition_n)
        with self._parts_mu:
            table = self._parts.get(key)
            need = int(idx.max()) + 1
            if table is None or len(table) < need:
                have = 0 if table is None else len(table)
                grown = np.fromiter(
                    (self.partition(index, s) for s in range(have, need)),
                    dtype=np.int64, count=need - have)
                table = grown if table is None else np.concatenate(
                    (table, grown))
                self._parts[key] = table
        return table[idx]

    def partition_nodes(self, partition_id: int,
                        ring: Optional[List[Node]] = None) -> List[Node]:
        """The partition's owners: the jump hash's primary, then the
        next nodes of the ring."""
        ring = self.nodes if ring is None else ring
        if not ring:
            return []
        replica_n = min(max(self.replica_n, 1), len(ring))
        primary = self.hasher.hash(partition_id, len(ring))
        return [ring[(primary + i) % len(ring)] for i in range(replica_n)]

    def fragment_nodes(self, index: str, slice_: int) -> List[Node]:
        return self.partition_nodes(self.partition(index, slice_))

    def owns_fragment(self, host: str, index: str, slice_: int) -> bool:
        return any(n.host == host for n in self.fragment_nodes(index, slice_))

    def owns_slices(self, index: str, max_slice: int, host: str) -> List[int]:
        """The slices up to max_slice whose PRIMARY owner is host."""
        out = []
        for s in range(max_slice + 1):
            p = self.partition(index, s)
            if self.nodes[self.hasher.hash(p, len(self.nodes))].host == host:
                out.append(s)
        return out

    def status(self) -> dict:
        return {"nodes": [{"host": n.host, "state": n.state}
                          for n in self.nodes]}


def owner_tier(host: str, local_host: str) -> str:
    """`local` when the owner is this node, else `http`: the tier label
    of pilosa_query_route_total and of explain's placement."""
    return "local" if host == local_host else "http"


def preferred_owner(owners: List[Node],
                    breaker_state: Optional[Callable[[str], str]] = None,
                    prefer: Optional[str] = None) -> Node:
    """Which owner serves a slice: UP owners whose breaker is closed,
    then any UP owner, then LEAVING ones, then anyone (liveness and
    breakers are advisory: the executor's re-split decides). Within the
    winning tier `prefer` (this node's host) breaks the tie."""

    def pick(cands: List[Node]) -> Node:
        if prefer is not None:
            for o in cands:
                if o.host == prefer:
                    return o
        return cands[0]

    up = [o for o in owners if o.state == NODE_STATE_UP]
    if breaker_state is not None:
        healthy = [o for o in up if breaker_state(o.host) == "closed"]
        if healthy:
            return pick(healthy)
    if up:
        return pick(up)
    leaving = [o for o in owners if o.state == NODE_STATE_LEAVING]
    return pick(leaving or owners)


def pick_read_replica(owners: List[Node],
                      breaker_state: Optional[Callable[[str], str]] = None,
                      staleness_ok: Optional[Callable[[str], bool]] = None,
                      queue_depth: Optional[Callable[[str], int]] = None,
                      prefer: Optional[str] = None,
                      rnd=None) -> Optional[Node]:
    """A bounded-staleness read's replica (the JAX package's, without
    its interconnect tie-break and peer-health filter): of the owners
    that are UP, with a closed breaker and within the read's staleness
    (`staleness_ok(host)`, the EpochTracker's check; `prefer` passes it
    unasked), `prefer` (this node) wins, else the shallower queue
    (`queue_depth(host)`) of two drawn by `rnd.sample` (power of two
    choices; `rnd` defaults to the random module). None when no owner
    is eligible: the caller falls back to preferred_owner."""
    cands = [o for o in owners if o.state == NODE_STATE_UP]
    if breaker_state is not None:
        cands = [o for o in cands if breaker_state(o.host) == "closed"]
    if staleness_ok is not None:
        cands = [o for o in cands if o.host == prefer or staleness_ok(o.host)]
    if not cands:
        return None
    for o in cands:
        if o.host == prefer:
            return o
    if len(cands) == 1:
        return cands[0]
    a, b = (rnd or random).sample(cands, 2)
    qd = queue_depth or (lambda _h: 0)
    da, db = qd(a.host), qd(b.host)
    if da != db:
        return a if da < db else b
    return a
