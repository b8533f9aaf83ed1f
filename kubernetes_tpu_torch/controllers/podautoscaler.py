"""Horizontal pod autoscaler controller.

Reference: pkg/controller/podautoscaler/horizontal.go —
reconcileAutoscaler (:584): read the target's scale, gather per-pod CPU
utilization from the metrics API, desired = ceil(current *
(observed/target)) (replica_calculator.go:79 GetResourceReplicas via
metricsclient), clamp to [min,max], apply a 10% tolerance band
(horizontal.go:62 tolerance = 0.1), and write the scale + status. Runs on
a fixed resync interval (default 15s, --horizontal-pod-autoscaler-sync-
period).

The metrics source is injectable (the reference talks to metrics.k8s.io;
hollow clusters install a synthetic source). A MetricsSource returns the
current CPU utilization percentage of one pod (requests-relative).
"""

from __future__ import annotations

import math
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from ..api import types as v1
from ..api.labels import Selector
from ..apiserver.server import APIError, NotFound

TOLERANCE = 0.1  # horizontal.go:62
DEFAULT_TARGET_UTILIZATION = 80


class HorizontalController:
    name = "horizontalpodautoscaling"

    def __init__(
        self,
        clientset,
        informer_factory,
        metrics: Optional[Callable[[v1.Pod], Optional[int]]] = None,
        sync_period: float = 15.0,
    ):
        self.client = clientset
        # pod -> CPU utilization % (None = metric missing for that pod)
        self.metrics = metrics or (lambda pod: None)
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.sync_period):
            try:
                self.sync_all()
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    # -- reconcile ----------------------------------------------------------

    def sync_all(self) -> None:
        hpas, _ = self.client.resource("horizontalpodautoscalers").list()
        for hpa in hpas:
            try:
                self.reconcile(hpa)
            except APIError:
                pass

    def _target_client(self, kind: str):
        resource = {
            "Deployment": "deployments",
            "ReplicaSet": "replicasets",
            "StatefulSet": "statefulsets",
            "ReplicationController": "replicationcontrollers",
        }.get(kind)
        return self.client.resource(resource) if resource else None

    def reconcile(self, hpa) -> None:
        ref = hpa.spec.scale_target_ref
        client = self._target_client(ref.kind)
        if client is None:
            return
        try:
            target = client.get(ref.name, hpa.metadata.namespace)
        except NotFound:
            return
        current = target.spec.replicas if target.spec.replicas is not None else 1
        sel = Selector.from_label_selector(target.spec.selector)
        pods = [
            p
            for p in self.client.pods.list(namespace=hpa.metadata.namespace)[0]
            if sel.matches(p.metadata.labels)
            and p.metadata.deletion_timestamp is None
            and p.status.phase == "Running"
        ]
        target_util = (
            hpa.spec.target_cpu_utilization_percentage or DEFAULT_TARGET_UTILIZATION
        )
        utils: List[int] = []
        for p in pods:
            u = self.metrics(p)
            if u is not None:
                utils.append(u)
        min_replicas = hpa.spec.min_replicas or 1
        if not utils:
            desired = current  # no metrics: hold (reference marks condition)
            observed = None
        else:
            observed = sum(utils) // len(utils)
            ratio = observed / target_util
            # tolerance band (replica_calculator.go:92)
            desired = current if abs(1.0 - ratio) <= TOLERANCE else math.ceil(
                current * ratio
            )
        desired = max(min_replicas, min(hpa.spec.max_replicas or desired, desired))
        if desired != current:
            target.spec.replicas = desired
            client.update(target)
        hpa_client = self.client.resource("horizontalpodautoscalers")
        live = hpa_client.get(hpa.metadata.name, hpa.metadata.namespace)
        changed = (
            live.status.current_replicas != current
            or live.status.desired_replicas != desired
            or live.status.current_cpu_utilization_percentage != observed
        )
        live.status.current_replicas = current
        live.status.desired_replicas = desired
        live.status.current_cpu_utilization_percentage = observed
        if desired != current:
            live.status.last_scale_time = time.time()
        if changed:
            hpa_client.update_status(live)
