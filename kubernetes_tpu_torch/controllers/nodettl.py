"""Node TTL controller.

Reference: pkg/controller/ttl/ttl_controller.go — annotates every node
with node.alpha.kubernetes.io/ttl, the seconds kubelets may cache
secrets/configmaps. The TTL scales with cluster size over a boundary
ladder (:50 ttlBoundaries: <=100 nodes -> 0s, <=500 -> 15s, <=1000 ->
30s, <=2000 -> 60s, else 300s) with hysteresis (sizeMin/sizeMax) so the
annotation doesn't flap at a boundary.
"""

from __future__ import annotations

import copy

from ..client.informer import EventHandler
from .base import Controller

TTL_ANNOTATION = "node.alpha.kubernetes.io/ttl"

# (sizeMin, sizeMax, ttlSeconds) — ttl_controller.go:50 ttlBoundaries
_BOUNDARIES = (
    (0, 100, 0),
    (90, 500, 15),
    (450, 1000, 30),
    (900, 2000, 60),
    (1800, 1 << 62, 300),
)


class TTLController(Controller):
    name = "node-ttl"

    def __init__(self, clientset, informer_factory):
        super().__init__(workers=1)
        self.client = clientset
        self.node_informer = informer_factory.informer_for("nodes")
        self._boundary = 0  # index into _BOUNDARIES
        self.node_informer.add_event_handler(EventHandler(
            on_add=self._on_count_change,
            on_delete=self._on_count_change,
        ))

    def _on_count_change(self, node) -> None:
        n = self.node_informer.count()  # O(1); no full-store copy per event
        b = self._boundary
        # hysteresis walk (ttl_controller.go updateNodeCount)
        while b < len(_BOUNDARIES) - 1 and n > _BOUNDARIES[b][1]:
            b += 1
        while b > 0 and n < _BOUNDARIES[b][0]:
            b -= 1
        if b != self._boundary:
            # boundary crossed: every node's annotation needs refreshing
            self._boundary = b
            for other in self.node_informer.list():
                self.enqueue(other.metadata.name)
        else:
            # steady state: only the (possibly new) node itself — fanning
            # out on every add makes a 5000-node bootstrap O(n^2)
            self.enqueue(node.metadata.name)

    def desired_ttl(self) -> int:
        return _BOUNDARIES[self._boundary][2]

    def sync(self, key: str) -> None:
        node = self.node_informer.get(key)
        if node is None:
            return
        want = str(self.desired_ttl())
        anns = node.metadata.annotations or {}
        if anns.get(TTL_ANNOTATION) == want:
            return
        updated = copy.deepcopy(node)
        updated.metadata.annotations = dict(anns)
        updated.metadata.annotations[TTL_ANNOTATION] = want
        self.client.nodes.update(updated)
