"""Node IPAM controller: central podCIDR allocation.

Reference: pkg/controller/nodeipam/ipam/range_allocator.go:47
NewCIDRRangeAllocator — carves the cluster CIDR into per-node subnets of
node-cidr-mask-size, occupies CIDRs already recorded on nodes at start
(:82), allocates the lowest free subnet to each new node
(AllocateOrOccupyCIDR :214 via cidr_set.go AllocateNext), patches
node.spec.podCIDR (:310 updateCIDRsAllocation), and releases the subnet
when the node is deleted (ReleaseCIDR :240).

The round-3 build assigned pod IP ranges node-side (kubelet/cri.py
ip_prefix); the control-plane loop is the reference's actual shape —
the kubelet CONSUMES spec.podCIDR (kubelet.py _update_node_status reads
it into the fake CNI's range) instead of inventing its own.
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Dict, Optional

from ..client.informer import EventHandler
from .base import Controller

DEFAULT_CLUSTER_CIDR = "10.244.0.0/16"
DEFAULT_NODE_MASK_SIZE = 24


class CIDRSet:
    """cidr_set.go — a bitmap over the 2^(mask - prefix) per-node
    subnets of the cluster CIDR; lowest free index wins, released
    indices are reused."""

    def __init__(self, cluster_cidr: str, node_mask_size: int):
        self.net = ipaddress.ip_network(cluster_cidr)
        if node_mask_size < self.net.prefixlen:
            raise ValueError(
                f"node mask /{node_mask_size} is wider than the cluster "
                f"CIDR {cluster_cidr}"
            )
        self.node_mask_size = node_mask_size
        self.max_cidrs = 1 << (node_mask_size - self.net.prefixlen)
        self._used: set = set()
        self._lock = threading.Lock()

    def _subnet(self, index: int) -> str:
        base = int(self.net.network_address)
        offset = index << (self.net.max_prefixlen - self.node_mask_size)
        addr = ipaddress.ip_address(base + offset)
        return f"{addr}/{self.node_mask_size}"

    def _index_of(self, cidr: str) -> int:
        net = ipaddress.ip_network(cidr)
        if not net.subnet_of(self.net):
            raise ValueError(f"{cidr} is not within {self.net}")
        off = int(net.network_address) - int(self.net.network_address)
        return off >> (self.net.max_prefixlen - self.node_mask_size)

    def allocate_next(self) -> Optional[str]:
        with self._lock:
            for i in range(self.max_cidrs):
                if i not in self._used:
                    self._used.add(i)
                    return self._subnet(i)
            return None  # exhausted (cidr_set.go ErrCIDRRangeNoCIDRsRemaining)

    def occupy(self, cidr: str) -> None:
        with self._lock:
            self._used.add(self._index_of(cidr))

    def release(self, cidr: str) -> None:
        with self._lock:
            self._used.discard(self._index_of(cidr))

    def used_count(self) -> int:
        with self._lock:
            return len(self._used)


class NodeIpamController(Controller):
    name = "nodeipam"

    def __init__(self, clientset, informer_factory,
                 cluster_cidr: str = DEFAULT_CLUSTER_CIDR,
                 node_cidr_mask_size: int = DEFAULT_NODE_MASK_SIZE,
                 workers: int = 1):
        super().__init__(workers=workers)
        self.client = clientset
        self.cidrs = CIDRSet(cluster_cidr, node_cidr_mask_size)
        self.informer = informer_factory.informer_for("nodes")
        # node name -> allocated cidr (for release on delete, where the
        # informer hands us the last-seen object)
        self._allocated: Dict[str, str] = {}
        self._alloc_lock = threading.Lock()
        self._events = None
        self.informer.add_event_handler(EventHandler(
            on_add=lambda n: self.enqueue(n.metadata.name),
            on_update=lambda o, n: self.enqueue(n.metadata.name),
            on_delete=self._on_delete,
        ))

    def _recorder(self):
        if self._events is None:
            from ..client.events import EventRecorder

            self._events = EventRecorder(self.client, "node-ipam-controller")
        return self._events

    def _on_delete(self, node) -> None:
        """ReleaseCIDR (:240): the subnet returns to the pool, and any
        node still waiting (a previous exhaustion) gets re-enqueued —
        without this the freed subnet sits idle until an unrelated
        event happens to touch the starved node."""
        cidr = node.spec.pod_cidr or self._allocated.get(node.metadata.name)
        with self._alloc_lock:
            self._allocated.pop(node.metadata.name, None)
        if cidr:
            try:
                self.cidrs.release(cidr)
            except ValueError:
                pass  # foreign CIDR recorded on the node; nothing to release
            for other in self.informer.list():
                if not other.spec.pod_cidr:
                    self.enqueue(other.metadata.name)

    def sync(self, key: str) -> None:
        """AllocateOrOccupyCIDR (:214): occupy a pre-recorded podCIDR,
        else allocate the lowest free subnet and patch the node."""
        node = self.informer.get(key)
        if node is None:
            return
        if node.spec.pod_cidr:
            with self._alloc_lock:
                already = self._allocated.get(key) == node.spec.pod_cidr
                self._allocated[key] = node.spec.pod_cidr
            if not already:
                try:
                    self.cidrs.occupy(node.spec.pod_cidr)
                except ValueError:
                    pass  # outside the cluster CIDR: leave it (ref logs)
            return
        cidr = self.cidrs.allocate_next()
        if cidr is None:
            # exhausted: record CIDRNotAvailable and RAISE so the
            # rate-limited workqueue retries with backoff (the reference
            # range_allocator returns the error for the same reason —
            # returning success would strand the node until an
            # unrelated event; releases also re-enqueue, _on_delete)
            self._recorder().event(
                node, "Warning", "CIDRNotAvailable",
                "no CIDRs remaining in cluster CIDR",
            )
            raise RuntimeError(f"cluster CIDR exhausted; node {key} waits")
        with self._alloc_lock:
            self._allocated[key] = cidr
        try:
            fresh = self.client.nodes.get(key)
            fresh.spec.pod_cidr = cidr
            self.client.nodes.update(fresh)
        except Exception:
            # conflict/deleted: return the subnet and retry via the
            # workqueue backoff
            with self._alloc_lock:
                self._allocated.pop(key, None)
            self.cidrs.release(cidr)
            raise
