"""Disruption controller: PodDisruptionBudget status maintenance.

Reference: pkg/controller/disruption/disruption.go — trySync (:581):
find pods matching the PDB selector, count healthy (ready) ones, compute
desiredHealthy from minAvailable / maxUnavailable (getExpectedPodCount
:654 resolves percentages against the controller's scale), and write
status {currentHealthy, desiredHealthy, expectedPods, disruptionsAllowed}.
The eviction subresource consults disruptionsAllowed; the scheduler's
preemption PDB partitioning reads the same status.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from ..api import types as v1
from ..api.labels import Selector
from ..client.informer import EventHandler, meta_namespace_key
from .base import Controller, get_controller_of, is_pod_ready


def _resolve(value: str, scale: int) -> int:
    """intstr.GetValueFromIntOrPercent with round-up (disruption.go uses
    round-up for minAvailable percentages)."""
    s = str(value)
    if s.endswith("%"):
        return math.ceil(scale * int(s[:-1]) / 100)
    return int(s)


class DisruptionController(Controller):
    name = "disruption"

    def __init__(self, clientset, informer_factory, workers: int = 2):
        super().__init__(workers=workers)
        self.client = clientset
        self.pdb_informer = informer_factory.informer_for("poddisruptionbudgets")
        self.pod_informer = informer_factory.informer_for("pods")
        self.rs_informer = informer_factory.informer_for("replicasets")
        self.deploy_informer = informer_factory.informer_for("deployments")
        self.pdb_informer.add_event_handler(
            EventHandler(
                on_add=lambda o: self.enqueue(meta_namespace_key(o)),
                on_update=lambda o, n: self.enqueue(meta_namespace_key(n)),
            )
        )
        self.pod_informer.add_event_handler(
            EventHandler(
                on_add=self._on_pod,
                on_update=lambda o, n: self._on_pod(n),
                on_delete=self._on_pod,
            )
        )

    def _on_pod(self, pod: v1.Pod) -> None:
        for pdb in self.pdb_informer.list():
            if pdb.metadata.namespace != pod.metadata.namespace:
                continue
            if Selector.from_label_selector(pdb.spec.selector).matches(
                pod.metadata.labels
            ):
                self.enqueue(meta_namespace_key(pdb))

    def _expected_scale(self, pod: v1.Pod) -> Optional[int]:
        """Controller's declared scale for one pod (getExpectedScale)."""
        ref = get_controller_of(pod)
        if ref is None:
            return None
        if ref.kind == "ReplicaSet":
            rs = self.rs_informer.get(f"{pod.metadata.namespace}/{ref.name}")
            if rs is None:
                return None
            # deployment-owned replicasets report the deployment's scale
            rs_ref = get_controller_of(rs)
            if rs_ref is not None and rs_ref.kind == "Deployment":
                dep = self.deploy_informer.get(
                    f"{pod.metadata.namespace}/{rs_ref.name}"
                )
                if dep is not None:
                    return dep.spec.replicas if dep.spec.replicas is not None else 1
            return rs.spec.replicas if rs.spec.replicas is not None else 1
        return None

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        pdb = self.pdb_informer.get(key)
        if pdb is None:
            return
        sel = Selector.from_label_selector(pdb.spec.selector)
        pods = [
            p
            for p in self.pod_informer.list()
            if p.metadata.namespace == namespace
            and sel.matches(p.metadata.labels)
            and p.metadata.deletion_timestamp is None
        ]
        current_healthy = sum(1 for p in pods if is_pod_ready(p))
        expected, desired = self._expected_and_desired(pdb, pods)
        allowed = max(0, current_healthy - desired)
        status = v1.PodDisruptionBudgetStatus(
            disruptions_allowed=allowed,
            current_healthy=current_healthy,
            desired_healthy=desired,
            expected_pods=expected,
        )
        if (
            status.disruptions_allowed == pdb.status.disruptions_allowed
            and status.current_healthy == pdb.status.current_healthy
            and status.desired_healthy == pdb.status.desired_healthy
            and status.expected_pods == pdb.status.expected_pods
        ):
            return
        live = self.client.resource("poddisruptionbudgets").get(name, namespace)
        live.status = status
        self.client.resource("poddisruptionbudgets").update_status(live)

    def _expected_and_desired(self, pdb, pods) -> Tuple[int, int]:
        if pdb.spec.max_unavailable is not None:
            # maxUnavailable needs the controllers' declared scale (:654):
            # expected = sum of each distinct owning controller's scale
            scales = {}
            for p in pods:
                ref = get_controller_of(p)
                if ref is not None:
                    scales.setdefault(
                        (ref.kind, ref.name), self._expected_scale(p) or 0
                    )
            expected = sum(scales.values()) or len(pods)
            desired = max(0, expected - _resolve(pdb.spec.max_unavailable, expected))
            return expected, desired
        expected = len(pods)
        if pdb.spec.min_available is None:
            return expected, 0
        return expected, _resolve(pdb.spec.min_available, expected)
