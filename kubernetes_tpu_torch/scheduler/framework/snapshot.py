"""Scheduler cache snapshot: immutable view of cluster state for one cycle.

Reference: pkg/scheduler/internal/cache/snapshot.go:29 Snapshot — the node
list plus the two secondary lists (HavePodsWithAffinity,
HavePodsWithRequiredAntiAffinity) that let InterPodAffinity skip nodes, and
the cluster-wide image state index used by ImageLocality.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ...api import types as v1
from .types import ImageStateSummary, NodeInfo


class Snapshot:
    def __init__(self, node_infos: Optional[List[NodeInfo]] = None):
        self.node_info_list: List[NodeInfo] = node_infos or []
        self.node_info_map: Dict[str, NodeInfo] = {
            ni.node.metadata.name: ni for ni in self.node_info_list if ni.node
        }
        self.have_pods_with_affinity_list = [
            ni for ni in self.node_info_list if ni.pods_with_affinity
        ]
        self.have_pods_with_required_anti_affinity_list = [
            ni for ni in self.node_info_list if ni.pods_with_required_anti_affinity
        ]
        self.generation = 0

    @classmethod
    def from_objects(cls, pods: List[v1.Pod], nodes: List[v1.Node]) -> "Snapshot":
        """snapshot.go:48 NewSnapshot: build NodeInfos from raw objects and
        populate per-node ImageStates with cluster-wide spread counts."""
        by_node: Dict[str, NodeInfo] = {}
        for node in nodes:
            ni = NodeInfo()
            ni.set_node(node)
            by_node[node.metadata.name] = ni
        for pod in pods:
            name = pod.spec.node_name
            if name in by_node:
                by_node[name].add_pod(pod)
        # image spread index (snapshot.go createImageExistenceMap)
        image_nodes: Dict[str, set] = {}
        for node in nodes:
            for image in node.status.images or []:
                for n in image.names or []:
                    image_nodes.setdefault(n, set()).add(node.metadata.name)
        for node in nodes:
            ni = by_node[node.metadata.name]
            states: Dict[str, ImageStateSummary] = {}
            for image in node.status.images or []:
                for n in image.names or []:
                    states[n] = ImageStateSummary(image.size_bytes, len(image_nodes[n]))
            ni.image_states = states
        return cls([by_node[n.metadata.name] for n in nodes])

    # NodeInfos lister surface (snapshot.go:139-166)
    def list(self) -> List[NodeInfo]:
        return self.node_info_list

    def get(self, node_name: str) -> NodeInfo:
        ni = self.node_info_map.get(node_name)
        if ni is None:
            raise KeyError(f"nodeinfo not found for node name {node_name!r}")
        return ni

    def num_nodes(self) -> int:
        return len(self.node_info_list)
