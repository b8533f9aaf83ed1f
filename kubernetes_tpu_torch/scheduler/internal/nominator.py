"""PodNominator: tracks preemptor pods nominated onto nodes they are
waiting to land on.

Reference: pkg/scheduler/internal/queue/scheduling_queue.go:711
nominatedPodMap — AddNominatedPod/DeleteNominatedPodIfExists/
UpdateNominatedPod + NominatedPodsForNode, consumed by
RunFilterPluginsWithNominatedPods (framework.go:610) to double-filter
against higher-priority nominated-but-unbound pods.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ...api import types as v1


class PodNominator:
    def __init__(self):
        self._lock = threading.RLock()
        self._by_node: Dict[str, List[v1.Pod]] = {}
        self._node_of: Dict[str, str] = {}  # pod key -> node name

    def add_nominated_pod(self, pod: v1.Pod, node_name: str = "") -> None:
        with self._lock:
            self._delete_locked(pod)
            node = node_name or pod.status.nominated_node_name
            if not node:
                return
            key = v1.pod_key(pod)
            self._node_of[key] = node
            self._by_node.setdefault(node, []).append(pod)

    def delete_nominated_pod_if_exists(self, pod: v1.Pod) -> None:
        with self._lock:
            self._delete_locked(pod)

    def _delete_locked(self, pod: v1.Pod) -> None:
        key = v1.pod_key(pod)
        node = self._node_of.pop(key, None)
        if node is None:
            return
        pods = self._by_node.get(node, [])
        self._by_node[node] = [p for p in pods if v1.pod_key(p) != key]
        if not self._by_node[node]:
            del self._by_node[node]

    def update_nominated_pod(self, old: v1.Pod, new: v1.Pod) -> None:
        with self._lock:
            # preserve the nomination across updates that drop the field
            # (scheduling_queue.go:771 UpdateNominatedPod)
            node = self._node_of.get(v1.pod_key(old), "")
            self._delete_locked(old)
            target = new.status.nominated_node_name or node
            if target:
                self.add_nominated_pod(new, target)

    def nominated_pods_for_node(self, node_name: str) -> List[v1.Pod]:
        with self._lock:
            return list(self._by_node.get(node_name, []))

    def all_nominated_pods(self) -> List[v1.Pod]:
        """Every currently-nominated pod (the fast preemption planner's
        envelope check scans these for required anti-affinity terms)."""
        with self._lock:
            return [p for pods in self._by_node.values() for p in pods]
