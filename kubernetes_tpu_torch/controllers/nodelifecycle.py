"""Node lifecycle controller: heartbeat monitoring, taints, eviction.

Reference: pkg/controller/nodelifecycle/node_lifecycle_controller.go —
monitorNodeHealth (:756) marks a node's Ready condition Unknown once its
heartbeat (Lease renewTime / NodeStatus condition heartbeats) is older
than nodeMonitorGracePeriod, then applies the NoExecute
node.kubernetes.io/unreachable or not-ready taint (:659
processTaintBaseEviction); the taint manager
(scheduler/taint_manager.go) evicts pods without a matching NoExecute
toleration (respecting tolerationSeconds).
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Dict, Optional

from ..api import types as v1
from ..api.taints import toleration_tolerates_taint


class NodeLifecycleController:
    name = "nodelifecycle"

    def __init__(
        self,
        clientset,
        informer_factory,
        node_monitor_period: float = 5.0,
        node_monitor_grace_period: float = 40.0,
    ):
        self.client = clientset
        self.node_informer = informer_factory.informer_for("nodes")
        self.pod_informer = informer_factory.informer_for("pods")
        self.lease_informer = informer_factory.informer_for("leases")
        self.monitor_period = node_monitor_period
        self.grace_period = node_monitor_grace_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # pod key -> eviction deadline (taint manager's timed workqueue)
        self._evictions: Dict[str, float] = {}

    def run(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.monitor_period):
            try:
                self.monitor_node_health()
                self.process_evictions()
            except Exception:  # noqa: BLE001
                import traceback

                traceback.print_exc()

    # -- health monitoring --------------------------------------------------

    def _last_heartbeat(self, node: v1.Node) -> float:
        latest = node.metadata.creation_timestamp or 0.0
        lease = self.lease_informer.get(f"kube-node-lease/{node.metadata.name}")
        if lease is not None and lease.spec.renew_time:
            latest = max(latest, lease.spec.renew_time)
        for cond in node.status.conditions or []:
            if cond.last_heartbeat_time:
                latest = max(latest, cond.last_heartbeat_time)
        return latest

    @staticmethod
    def _ready_condition(node: v1.Node) -> Optional[v1.NodeCondition]:
        for cond in node.status.conditions or []:
            if cond.type == "Ready":
                return cond
        return None

    @staticmethod
    def _has_taint(node: v1.Node, key: str) -> bool:
        return any(t.key == key for t in node.spec.taints or [])

    def monitor_node_health(self) -> None:
        now = time.time()
        for node in self.node_informer.list():
            stale = now - self._last_heartbeat(node) > self.grace_period
            ready = self._ready_condition(node)
            if stale:
                if ready is None or ready.status != "Unknown":
                    self._set_ready_condition(
                        node,
                        "Unknown",
                        "NodeStatusUnknown",
                        "Kubelet stopped posting node status.",
                    )
                self._ensure_taint(node, v1.TAINT_NODE_UNREACHABLE, "NoExecute")
            else:
                if ready is not None and ready.status == "False":
                    self._ensure_taint(node, v1.TAINT_NODE_NOT_READY, "NoExecute")
                elif ready is not None and ready.status == "True":
                    self._remove_taints(
                        node, (v1.TAINT_NODE_UNREACHABLE, v1.TAINT_NODE_NOT_READY)
                    )
                if ready is not None and ready.status == "Unknown":
                    # heartbeat resumed but condition still Unknown: the
                    # kubelet's next status update will fix it; clear taints
                    # only once Ready flips back
                    pass

    def _set_ready_condition(
        self, node: v1.Node, status: str, reason: str, message: str
    ) -> None:
        updated = copy.deepcopy(node)
        now = time.time()
        conds = updated.status.conditions or []
        for cond in conds:
            if cond.type == "Ready":
                cond.status = status
                cond.reason = reason
                cond.message = message
                cond.last_transition_time = now
                break
        else:
            conds.append(
                v1.NodeCondition(
                    type="Ready",
                    status=status,
                    reason=reason,
                    message=message,
                    last_transition_time=now,
                )
            )
        updated.status.conditions = conds
        try:
            self.client.nodes.update_status(updated)
        except Exception:  # noqa: BLE001 — retried next period
            pass

    def _ensure_taint(self, node: v1.Node, key: str, effect: str) -> None:
        if self._has_taint(node, key):
            return
        updated = copy.deepcopy(node)
        updated.spec.taints = (updated.spec.taints or []) + [
            v1.Taint(key=key, effect=effect)
        ]
        try:
            self.client.nodes.update(updated)
        except Exception:  # noqa: BLE001
            pass

    def _remove_taints(self, node: v1.Node, keys) -> None:
        taints = [t for t in node.spec.taints or [] if t.key not in keys]
        if len(taints) == len(node.spec.taints or []):
            return
        updated = copy.deepcopy(node)
        updated.spec.taints = taints or None
        try:
            self.client.nodes.update(updated)
        except Exception:  # noqa: BLE001
            pass

    # -- NoExecute eviction (taint manager) ---------------------------------

    def process_evictions(self) -> None:
        now = time.time()
        nodes = {n.metadata.name: n for n in self.node_informer.list()}
        live = set()
        for pod in self.pod_informer.list():
            if not pod.spec.node_name or pod.metadata.deletion_timestamp is not None:
                continue
            node = nodes.get(pod.spec.node_name)
            if node is None:
                continue
            noexec = [t for t in node.spec.taints or [] if t.effect == "NoExecute"]
            if not noexec:
                continue
            key = f"{pod.metadata.namespace}/{pod.metadata.name}"
            deadline = self._eviction_deadline(pod, noexec, now)
            if deadline is None:
                continue  # tolerates forever
            live.add(key)
            self._evictions.setdefault(key, deadline)
            if now >= self._evictions[key]:
                try:
                    self.client.pods.delete(pod.metadata.name, pod.metadata.namespace)
                except Exception:  # noqa: BLE001
                    pass
                self._evictions.pop(key, None)
        for key in list(self._evictions):
            if key not in live:
                self._evictions.pop(key)

    @staticmethod
    def _eviction_deadline(pod: v1.Pod, taints, now: float) -> Optional[float]:
        """None = tolerated forever; else absolute eviction time (minimum
        tolerationSeconds across taints; untolerated taint = evict now)."""
        deadline = None
        for taint in taints:
            matched = [
                tol
                for tol in pod.spec.tolerations or []
                if toleration_tolerates_taint(tol, taint)
            ]
            if not matched:
                return now
            secs = [
                tol.toleration_seconds
                for tol in matched
                if tol.toleration_seconds is not None
            ]
            if secs:
                d = now + max(0, min(secs))
                deadline = d if deadline is None else min(deadline, d)
        return deadline
