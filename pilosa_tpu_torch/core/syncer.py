"""Anti-entropy: HolderSyncer walks the fragments this node owns and
FragmentSyncer brings each one's replicas together (the JAX package's
pilosa_tpu/core/syncer.py, itself the reference's holder.go:364-562 and
fragment.go:1300-1481).

For each fragment: the 100-row block checksums of every replica are
compared with this copy's (a peer that cannot be reached is skipped and
counted); each block that differs anywhere is pulled from every peer
(`sync_block`, the `syncer.block` fault seam), majority-merged here
(Fragment.merge_block) and, for the standard view, the diff each peer
needs is pushed to it as SetBit / ClearBit PQL on a remote leg (other
views converge through their own merges on each replica). A peer whose
block map matched this copy's exactly then has its epoch floor-raised to
this copy's (`_reconcile_epochs`). HolderSyncer also diffs the column
and row attr stores against every other node and takes the attrs it
lacks.

`client_factory(host)` gives an api.client.InternalClient, or anything
with its fragment_blocks / block_data / execute_remote / advance_epochs /
column_attr_diff / row_attr_diff (the tests' fakes). Counters go to
`stats` (the server's stats client): syncer_blocks_scanned,
syncer_blocks_dirty, syncer_blocks_merged, syncer_peers_skipped,
syncer_epochs_reconciled.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

from .. import SLICE_WIDTH, fault
from .view import VIEW_INVERSE, VIEW_STANDARD

_log = logging.getLogger("pilosa_tpu_torch.syncer")


def _count(stats, name: str, n: int = 1) -> None:
    """Bump a counter of a stats client (`count`) or a StatMap (`inc`)."""
    if stats is None or n == 0:
        return
    if hasattr(stats, "count"):
        stats.count(name, n)
    elif hasattr(stats, "inc"):
        stats.inc(name, n)


class Closing:
    """The cancellation flag a server's close sets: a pass stops at its
    next check."""

    def __init__(self):
        self._event = threading.Event()

    def close(self):
        self._event.set()

    @property
    def closed(self) -> bool:
        return self._event.is_set()

    def is_set(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float) -> bool:
        return self._event.wait(timeout)


class FragmentSyncer:
    """Syncs one fragment over its replica set (`nodes`, this node
    among them). `op_deadline` > 0 bounds each peer fetch, in seconds."""

    def __init__(self, fragment, host: str, nodes,
                 client_factory: Callable, closing: Optional[Closing] = None,
                 row_label: str = "rowID", column_label: str = "columnID",
                 stats=None, op_deadline: float = 0.0):
        self.fragment = fragment
        self.host = host
        self.nodes = nodes
        self.client_factory = client_factory
        self.closing = closing or Closing()
        # The frame's own labels, so a pushed SetBit parses there.
        self.row_label = row_label
        self.column_label = column_label
        self.stats = stats
        self.op_deadline = float(op_deadline)

    def _peers(self) -> List[str]:
        return [n.host for n in self.nodes if n.host != self.host]

    def _deadline_kw(self) -> dict:
        if self.op_deadline > 0:
            return {"deadline": time.monotonic() + self.op_deadline}
        return {}

    def _what(self) -> str:
        f = self.fragment
        return f"{f.index}/{f.frame}/{f.view}/{f.slice}"

    def sync_fragment(self) -> None:
        """Merge every block whose checksum differs on any replica, then
        raise the epochs of the peers that matched exactly."""
        f = self.fragment
        local = dict(f.blocks())
        remote_sets = []
        for host in self._peers():
            if self.closing.closed:
                return
            try:
                blocks = dict(self.client_factory(host).fragment_blocks(
                    f.index, f.frame, f.view, f.slice,
                    **self._deadline_kw()))
            except Exception as e:  # noqa: BLE001 — skip that peer
                _count(self.stats, "syncer_peers_skipped")
                _log.info("sync %s: peer %s unreachable, skipped: %s",
                          self._what(), host, e)
                continue
            remote_sets.append((host, blocks))
        dirty = set()
        converged = []
        for host, blocks in remote_sets:
            peer_dirty = False
            for bid in set(blocks) | set(local):
                if blocks.get(bid) != local.get(bid):
                    dirty.add(bid)
                    peer_dirty = True
            if not peer_dirty:
                converged.append(host)
        scanned = set(local)
        for _, blocks in remote_sets:
            scanned.update(blocks)
        _count(self.stats, "syncer_blocks_scanned", len(scanned))
        _count(self.stats, "syncer_blocks_dirty", len(dirty))
        for bid in sorted(dirty):
            if self.closing.closed:
                return
            self.sync_block(bid)
        self._reconcile_epochs(converged)

    def _reconcile_epochs(self, hosts: List[str]) -> None:
        """Floor-raise each peer whose block map matched this copy's
        exactly to this copy's epoch: the replicas agree on the bits but
        each counted its own writes. A peer that just took pushed diffs
        waits for the next pass, so an epoch never vouches for bits not
        yet there. Advisory: a failure leaves the digest behind, which
        only makes that replica look staler."""
        f = self.fragment
        epoch = int(getattr(f, "epoch", 0) or 0)
        if not epoch or not hosts:
            return
        key = self._what()
        for host in hosts:
            if self.closing.closed:
                return
            advance = getattr(self.client_factory(host), "advance_epochs",
                              None)
            if advance is None:
                continue
            try:
                advance({key: epoch})
                _count(self.stats, "syncer_epochs_reconciled")
            except Exception as e:  # noqa: BLE001 — advisory
                _log.info("sync %s: epoch reconcile to %s failed: %s",
                          key, host, e)

    def sync_block(self, block_id: int) -> None:
        """Majority-merge one block here and push each peer its diff. A
        peer that cannot be reached adds nothing to the consensus."""
        f = self.fragment
        fault.point("syncer.block", index=f.index, frame=f.frame,
                    view=f.view, slice=f.slice, block=block_id)
        peers, data = [], []
        for host in self._peers():
            try:
                rows, cols = self.client_factory(host).block_data(
                    f.index, f.frame, f.view, f.slice, block_id,
                    **self._deadline_kw())
            except Exception as e:  # noqa: BLE001 — skip that peer
                _count(self.stats, "syncer_peers_skipped")
                _log.info("sync %s block %d: peer %s unreachable, "
                          "skipped: %s", self._what(), block_id, host, e)
                continue
            peers.append(host)
            data.append((rows, cols))
        diffs = f.merge_block(block_id, data)
        _count(self.stats, "syncer_blocks_merged")
        if f.view != VIEW_STANDARD:
            return
        base = f.slice * SLICE_WIDTH
        for host, ((set_rows, set_cols), (clear_rows, clear_cols)) in zip(
                peers, diffs):
            calls = [self._bit_pql("SetBit", r, base + c)
                     for r, c in zip(set_rows.tolist(), set_cols.tolist())]
            calls += [self._bit_pql("ClearBit", r, base + c)
                      for r, c in zip(clear_rows.tolist(),
                                      clear_cols.tolist())]
            if not calls:
                continue
            try:
                # A remote leg: the peer applies the writes and fans them
                # out no further.
                self.client_factory(host).execute_remote(
                    None, f.index, "".join(calls), [], remote=True)
            except Exception as e:  # noqa: BLE001 — the next pass retries
                _count(self.stats, "syncer_peers_skipped")
                _log.info("sync %s block %d: diff push to %s failed: %s",
                          self._what(), block_id, host, e)

    def _bit_pql(self, name: str, row_id: int, column_id: int) -> str:
        return (f"{name}(frame={self.fragment.frame!r}, "
                f"{self.row_label}={int(row_id)}, "
                f"{self.column_label}={int(column_id)})")


class HolderSyncer:
    """One anti-entropy pass over a holder (holder.go:364-562)."""

    def __init__(self, holder, host: str, cluster,
                 client_factory: Callable, closing: Optional[Closing] = None,
                 stats=None, op_deadline: float = 0.0):
        self.holder = holder
        self.host = host
        self.cluster = cluster
        self.client_factory = client_factory
        self.closing = closing or Closing()
        self.stats = stats
        self.op_deadline = float(op_deadline)

    def sync_holder(self) -> None:
        """Every index's column attrs, every frame's row attrs, and every
        fragment of every view in the slices this node owns (up to the
        index's max slice, or max inverse slice for inverse views)."""
        for index_name in sorted(self.holder.indexes):
            if self.closing.closed:
                return
            idx = self.holder.index(index_name)
            if idx is None:
                continue
            self.sync_index(idx)
            limits = {VIEW_STANDARD: idx.max_slice(),
                      VIEW_INVERSE: idx.max_inverse_slice()}
            for frame_name in sorted(idx.frames):
                f = idx.frame(frame_name)
                if f is None:
                    continue
                self.sync_frame(index_name, f)
                for view in list(f.views.values()):
                    inverse = (view.name == VIEW_INVERSE or
                               view.name.startswith(VIEW_INVERSE + "_"))
                    limit = limits[VIEW_INVERSE if inverse
                                   else VIEW_STANDARD]
                    for slice_ in range(limit + 1):
                        if self.closing.closed:
                            return
                        if not self.cluster.owns_fragment(
                                self.host, index_name, slice_):
                            continue
                        self.sync_fragment(index_name, f.name, view.name,
                                           slice_)

    def sync_index(self, idx) -> None:
        self._sync_attrs(idx.column_attr_store,
                         lambda client, blocks:
                         client.column_attr_diff(idx.name, blocks))

    def sync_frame(self, index_name: str, frame) -> None:
        self._sync_attrs(frame.row_attr_store,
                         lambda client, blocks:
                         client.row_attr_diff(index_name, frame.name,
                                              blocks))

    def _sync_attrs(self, store, diff_fn) -> None:
        """Send this store's block checksums to every other node and
        take the attrs of the blocks where it differs."""
        for node in self.cluster.nodes:
            if node.host == self.host or self.closing.closed:
                continue
            try:
                attrs = diff_fn(self.client_factory(node.host),
                                store.blocks())
            except Exception as e:  # noqa: BLE001 — skip that peer
                _log.info("attr sync with %s failed: %s", node.host, e)
                continue
            if attrs:
                store.set_bulk_attrs(attrs)

    def sync_fragment(self, index: str, frame: str, view: str,
                      slice_: int) -> None:
        """Create the fragment here if need be, then sync its replicas
        (best effort: a failure is logged and the pass goes on)."""
        f = self.holder.frame(index, frame)
        if f is None or self.closing.closed:
            return
        frag = f.create_view_if_not_exists(view) \
            .create_fragment_if_not_exists(slice_)
        syncer = FragmentSyncer(
            frag, self.host, self.cluster.fragment_nodes(index, slice_),
            self.client_factory, self.closing, row_label=f.row_label,
            column_label=self.holder.index(index).column_label,
            stats=self.stats, op_deadline=self.op_deadline)
        try:
            syncer.sync_fragment()
        except Exception as e:  # noqa: BLE001 — best effort
            _log.info("fragment sync %s/%s/%s/%d failed: %s", index, frame,
                      view, slice_, e)
