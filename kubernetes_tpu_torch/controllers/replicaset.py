"""ReplicaSet controller.

Reference: pkg/controller/replicaset/replica_set.go — syncReplicaSet
(:646), manageReplicas (:554: slow-start batch creates, ranked deletes,
expectations), calculateStatus (replica_set_utils.go). Adoption is by
controller ownerRef; orphans matching the selector are adopted
(controller_ref_manager.go ClaimPods).
"""

from __future__ import annotations

import copy
import threading
import time
from typing import List, Optional

from ..api import apps, types as v1
from ..api.labels import Selector
from ..client.informer import EventHandler, meta_namespace_key
from ..utils import serde
from .base import (
    Controller,
    ControllerExpectations,
    controller_ref,
    get_controller_of,
    is_pod_active,
    is_pod_ready,
    rand_suffix,
    slow_start_batch,
)

BURST_REPLICAS = 500  # replica_set.go:77 BurstReplicas
SLOW_START_INITIAL_BATCH = 1  # controller_utils.go SlowStartInitialBatchSize



def selector_for(ls: Optional[v1.LabelSelector]) -> Selector:
    return Selector.from_label_selector(ls)


def pod_delete_cost(pod: v1.Pod) -> tuple:
    """getPodsToDelete ranking (replica_set.go:787 via
    controller.ActivePodsWithRanks): prefer deleting unassigned, then
    pending, then not-ready, then youngest."""
    assigned = 1 if pod.spec.node_name else 0
    phase_rank = {"Pending": 0, "Unknown": 1, "Running": 2}.get(pod.status.phase, 0)
    ready = 1 if is_pod_ready(pod) else 0
    created = pod.metadata.creation_timestamp or 0.0
    return (assigned, phase_rank, ready, -created)


class ReplicaSetController(Controller):
    name = "replicaset"
    kind = "ReplicaSet"
    resource = "replicasets"

    def __init__(self, clientset, informer_factory, workers: int = 2):
        super().__init__(workers=workers)
        self.client = clientset
        self.rs_informer = informer_factory.informer_for(self.resource)
        self.pod_informer = informer_factory.informer_for("pods")
        self.expectations = ControllerExpectations()
        self._wire_handlers()

    def _selector(self, rs) -> Selector:
        """Overridable: ReplicationController carries a map selector
        (core/v1) instead of a LabelSelector."""
        return selector_for(rs.spec.selector)

    # -- event handlers (replica_set.go:108-129 informer wiring) -----------

    def _wire_handlers(self) -> None:
        self.rs_informer.add_event_handler(
            EventHandler(
                on_add=lambda rs: self.enqueue(meta_namespace_key(rs)),
                on_update=lambda old, new: self.enqueue(meta_namespace_key(new)),
                on_delete=self._on_rs_delete,
            )
        )
        self.pod_informer.add_event_handler(
            EventHandler(
                on_add=self._on_pod_add,
                on_update=lambda old, new: self._on_pod_update(new),
                on_delete=self._on_pod_delete,
            )
        )

    def _on_rs_delete(self, rs) -> None:
        key = meta_namespace_key(rs)
        self.expectations.delete_expectations(key)
        self.enqueue(key)

    def _owner_key(self, pod: v1.Pod) -> Optional[str]:
        ref = get_controller_of(pod)
        if ref is None or ref.kind != self.kind:
            return None
        return f"{pod.metadata.namespace}/{ref.name}"

    def _on_pod_add(self, pod: v1.Pod) -> None:
        key = self._owner_key(pod)
        if key:
            self.expectations.creation_observed(key)
            self.enqueue(key)

    def _on_pod_update(self, pod: v1.Pod) -> None:
        # MODIFIED events never touch expectations (reference: only addPod
        # calls CreationObserved, replica_set.go:296 updatePod does not)
        key = self._owner_key(pod)
        if key:
            self.enqueue(key)

    def _on_pod_delete(self, pod: v1.Pod) -> None:
        key = self._owner_key(pod)
        if key:
            self.expectations.deletion_observed(key)
            self.enqueue(key)

    # -- sync ---------------------------------------------------------------

    def _claimed_pods(self, rs: apps.ReplicaSet) -> List[v1.Pod]:
        sel = self._selector(rs)
        out = []
        for pod in self.pod_informer.list():
            if pod.metadata.namespace != rs.metadata.namespace:
                continue
            if not is_pod_active(pod):
                continue
            ref = get_controller_of(pod)
            if ref is not None:
                if ref.uid == rs.metadata.uid:
                    out.append(pod)
                continue
            # orphan adoption: matches selector, not owned
            if sel.matches(pod.metadata.labels):
                adopted = copy.deepcopy(pod)
                refs = adopted.metadata.owner_references or []
                refs.append(controller_ref(rs, self.kind))
                adopted.metadata.owner_references = refs
                try:
                    self.client.pods.update(adopted)
                    out.append(adopted)
                except Exception:  # noqa: BLE001 — conflict: next sync retries
                    pass
        return out

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        rs = self.rs_informer.get(key)
        if rs is None:
            self.expectations.delete_expectations(key)
            return
        pods = self._claimed_pods(rs)
        if self.expectations.satisfied(key) and rs.metadata.deletion_timestamp is None:
            self._manage_replicas(key, rs, pods)
            pods = self._claimed_pods(rs)
        self._update_status(rs, pods)

    def _manage_replicas(self, key: str, rs: apps.ReplicaSet, pods: List[v1.Pod]) -> None:
        want = rs.spec.replicas if rs.spec.replicas is not None else 1
        diff = len(pods) - want
        if diff < 0:
            n = min(-diff, BURST_REPLICAS)
            self.expectations.expect_creations(key, n)
            created = slow_start_batch(
                n, SLOW_START_INITIAL_BATCH, lambda i: self._create_pod(rs)
            )
            for _ in range(n - created):
                self.expectations.creation_observed(key)
        elif diff > 0:
            n = min(diff, BURST_REPLICAS)
            victims = sorted(pods, key=pod_delete_cost)[:n]
            self.expectations.expect_deletions(key, n)
            for pod in victims:
                try:
                    self.client.pods.delete(pod.metadata.name, pod.metadata.namespace)
                except Exception:  # noqa: BLE001
                    self.expectations.deletion_observed(key)

    def _create_pod(self, rs: apps.ReplicaSet) -> bool:
        tmpl = rs.spec.template
        pod = v1.Pod(
            metadata=v1.ObjectMeta(
                name=f"{rs.metadata.name}-{rand_suffix()}",
                namespace=rs.metadata.namespace,
                labels=dict(tmpl.metadata.labels or {}),
                annotations=dict(tmpl.metadata.annotations or {}) or None,
                owner_references=[controller_ref(rs, self.kind)],
            ),
            spec=serde.from_dict(v1.PodSpec, serde.to_dict(tmpl.spec)) or v1.PodSpec(),
        )
        try:
            self.client.pods.create(pod)
            return True
        except Exception:  # noqa: BLE001
            return False

    def _update_status(self, rs: apps.ReplicaSet, pods: List[v1.Pod]) -> None:
        sel = self._selector(rs)
        fully_labeled = sum(1 for p in pods if sel.matches(p.metadata.labels))
        ready = sum(1 for p in pods if is_pod_ready(p))
        min_ready = rs.spec.min_ready_seconds or 0
        now = time.time()
        available = 0
        for p in pods:
            if not is_pod_ready(p):
                continue
            if min_ready <= 0:
                available += 1
                continue
            start = p.status.start_time or p.metadata.creation_timestamp or now
            if now - start >= min_ready:
                available += 1
        new = self._make_status(rs, pods, fully_labeled, ready, available)
        if serde.to_dict(new) != serde.to_dict(rs.status):
            updated = copy.deepcopy(rs)
            updated.status = new
            try:
                self.client.resource(self.resource).update_status(updated)
            except Exception:  # noqa: BLE001 — next event retries
                pass

    def _make_status(self, rs, pods, fully_labeled, ready, available):
        return apps.ReplicaSetStatus(
            replicas=len(pods),
            fully_labeled_replicas=fully_labeled,
            ready_replicas=ready,
            available_replicas=available,
            observed_generation=rs.metadata.generation,
        )
