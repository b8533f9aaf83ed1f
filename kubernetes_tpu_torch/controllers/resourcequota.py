"""ResourceQuota controller: keep quota status.used current.

Reference: pkg/controller/resourcequota/resource_quota_controller.go —
syncResourceQuota (:407): recalculate usage for every resource the quota
constrains via the quota registry evaluators, and update status {hard,
used} when drifted. Enforcement happens in admission
(apiserver/admission.py resource_quota); this loop keeps the published
status truthful and catches deletes (admission only sees creates).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, Optional

from ..api import types as v1
from ..apiserver.admission import _QUOTA_COUNTED, _hard_to_units, pod_compute_usage
from ..apiserver.server import APIError


def _format_used(key: str, amount: int) -> str:
    if key == "requests.cpu":
        return f"{amount}m"
    return str(amount)


class ResourceQuotaController:
    name = "resourcequota"

    def __init__(self, clientset, informer_factory, sync_period: float = 5.0):
        self.client = clientset
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

    def _usage(self, namespace: str) -> Dict[str, int]:
        used: Dict[str, int] = {}
        pods, _ = self.client.pods.list(namespace=namespace)
        for pod in pods:
            for k, amt in pod_compute_usage(pod).items():
                used[k] = used.get(k, 0) + amt
        for resource, key in _QUOTA_COUNTED.items():
            items, _ = self.client.resource(resource).list(namespace=namespace)
            used[key] = len(items)
        return used

    def sync_all(self) -> None:
        quotas, _ = self.client.resource("resourcequotas").list()
        usage_by_ns: Dict[str, Dict[str, int]] = {}
        for quota in quotas:
            ns = quota.metadata.namespace
            if ns not in usage_by_ns:
                usage_by_ns[ns] = self._usage(ns)
            used_units = usage_by_ns[ns]
            hard = quota.spec.hard or {}
            hard_units = _hard_to_units(hard)
            used = {
                k: _format_used(unit_key, used_units.get(unit_key, 0))
                for k, unit_key in (
                    (k, {"cpu": "requests.cpu", "memory": "requests.memory"}.get(k, k))
                    for k in hard
                )
            }
            if quota.status.used == used and quota.status.hard == dict(hard):
                continue
            try:
                live = self.client.resource("resourcequotas").get(
                    quota.metadata.name, ns
                )
                live.status = v1.ResourceQuotaStatus(hard=dict(hard), used=used)
                self.client.resource("resourcequotas").update_status(live)
            except APIError:
                pass

    def sync_once(self) -> None:
        """Test hook: one synchronous pass."""
        self.sync_all()
