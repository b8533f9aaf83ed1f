"""metrics.k8s.io types + the metrics-server equivalent.

Reference: staging/src/k8s.io/metrics/pkg/apis/metrics/v1beta1/types.go —
NodeMetrics (:27), PodMetrics (:62) with per-container usage; served by
metrics-server through the aggregator and consumed by HPA and
`kubectl top`. Here the types are ordinary resources and MetricsServer
is the scraper loop: it derives usage from an injectable per-pod usage
function (hollow clusters synthesize usage from requests) and writes
nodemetrics/podmetrics objects each period.
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..utils.metrics import Counter, Gauge, legacy_registry
from .quantity import Quantity
from .types import ObjectMeta

# -- controller-plane supervision metrics (controllers/manager.Supervisor) --
# Served through the same process-wide registry every component's /metrics
# handler exposes; the supervisor sets them on every crash/restart so a
# flapping loop is visible without log archaeology.

controller_restarts_total = legacy_registry.register(Counter(
    "controller_restarts_total",
    "Controller loops restarted by the supervisor after a crash.",
    ("controller",),
))
controller_healthy = legacy_registry.register(Gauge(
    "controller_healthy",
    "1 while the controller loop runs; 0 while crashed/awaiting restart.",
    ("controller",),
))


@dataclass
class ContainerMetrics:
    name: str = ""
    usage: Optional[Dict[str, str]] = None  # {"cpu": "100m", "memory": "64Mi"}


@dataclass
class NodeMetrics:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    timestamp: Optional[float] = None
    window: float = 10.0
    usage: Optional[Dict[str, str]] = None
    kind: str = "NodeMetrics"
    api_version: str = "metrics.k8s.io/v1beta1"


@dataclass
class PodMetrics:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    timestamp: Optional[float] = None
    window: float = 10.0
    containers: Optional[List[ContainerMetrics]] = None
    kind: str = "PodMetrics"
    api_version: str = "metrics.k8s.io/v1beta1"


def default_usage_fn(pod) -> Dict[str, str]:
    """Hollow-node usage synthesis: usage == requests (the most useful
    deterministic default for tests/benchmarks)."""
    cpu = 0
    mem = 0
    for c in pod.spec.containers or []:
        req = (c.resources.requests or {}) if c.resources else {}
        cpu += Quantity(req.get("cpu", 0)).milli_value()
        mem += Quantity(req.get("memory", 0)).value()
    return {"cpu": f"{cpu}m", "memory": str(mem)}


class MetricsServer:
    """Scrape loop: pods/nodes -> podmetrics/nodemetrics objects."""

    def __init__(
        self,
        clientset,
        usage_fn: Optional[Callable] = None,
        period: float = 10.0,
    ):
        self.client = clientset
        self.usage_fn = usage_fn or default_usage_fn
        self.period = period
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
        while not self._stop.wait(self.period):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    def scrape_once(self) -> None:
        now = time.time()
        pods, _ = self.client.pods.list()
        per_node: Dict[str, Dict[str, int]] = {}
        pm_client = self.client.resource("podmetrics")
        for pod in pods:
            if pod.status.phase != "Running" or not pod.spec.node_name:
                continue
            usage = self.usage_fn(pod)
            node_acc = per_node.setdefault(
                pod.spec.node_name, {"cpu": 0, "memory": 0}
            )
            node_acc["cpu"] += Quantity(usage.get("cpu", 0)).milli_value()
            node_acc["memory"] += Quantity(usage.get("memory", 0)).value()
            pm = PodMetrics(
                metadata=ObjectMeta(
                    name=pod.metadata.name, namespace=pod.metadata.namespace
                ),
                timestamp=now,
                containers=[
                    ContainerMetrics(
                        name=(pod.spec.containers or [None])[0].name
                        if pod.spec.containers
                        else "c",
                        usage=usage,
                    )
                ],
            )
            self._upsert(pm_client, pm)
        nm_client = self.client.resource("nodemetrics")
        nodes, _ = self.client.nodes.list()
        for node in nodes:
            acc = per_node.get(node.metadata.name, {"cpu": 0, "memory": 0})
            nm = NodeMetrics(
                metadata=ObjectMeta(name=node.metadata.name),
                timestamp=now,
                usage={"cpu": f"{acc['cpu']}m", "memory": str(acc["memory"])},
            )
            self._upsert(nm_client, nm)
        # drop metrics for pods/nodes that no longer exist
        live = {
            (p.metadata.namespace, p.metadata.name)
            for p in pods
            if p.status.phase == "Running"
        }
        stale, _ = pm_client.list()
        for pm in stale:
            if (pm.metadata.namespace, pm.metadata.name) not in live:
                try:
                    pm_client.delete(pm.metadata.name, pm.metadata.namespace)
                except Exception:  # noqa: BLE001
                    pass
        live_nodes = {n.metadata.name for n in nodes}
        stale_nodes, _ = nm_client.list()
        for nm in stale_nodes:
            if nm.metadata.name not in live_nodes:
                try:
                    nm_client.delete(nm.metadata.name)
                except Exception:  # noqa: BLE001
                    pass

    @staticmethod
    def _upsert(client, obj) -> None:
        from ..apiserver.server import NotFound

        try:
            live = client.get(obj.metadata.name, obj.metadata.namespace)
            live.timestamp = obj.timestamp
            live.usage = getattr(obj, "usage", None)
            if hasattr(obj, "containers"):
                live.containers = obj.containers
            client.update(live)
        except NotFound:
            client.create(obj)


def pod_metrics_source(clientset):
    """HPA metrics source backed by the metrics API: pod -> CPU
    utilization %% of requests (replica_calculator's
    GetResourceUtilizationRatio numerator/denominator)."""

    def source(pod) -> Optional[int]:
        from ..apiserver.server import NotFound

        try:
            pm = clientset.resource("podmetrics").get(
                pod.metadata.name, pod.metadata.namespace
            )
        except NotFound:
            return None
        used = sum(
            Quantity((c.usage or {}).get("cpu", 0)).milli_value()
            for c in pm.containers or []
        )
        requested = 0
        for c in pod.spec.containers or []:
            req = (c.resources.requests or {}) if c.resources else {}
            requested += Quantity(req.get("cpu", 0)).milli_value()
        if requested == 0:
            return None
        return int(100 * used / requested)

    return source
