"""EndpointSlice controller.

Reference: pkg/controller/endpointslice/endpointslice_controller.go —
syncService (:292): for each Service with a selector, mirror its pods into
EndpointSlice objects labeled kubernetes.io/service-name, at most
maxEndpointsPerSlice endpoints per slice (:61, default 100); the
reconciler (reconciler.go) creates/updates/deletes slices to match the
desired endpoint set. Slices are named <service>-<index> here (the
reference uses generateName).
"""

from __future__ import annotations

import copy
from typing import List, Optional

from ..api import discovery
from ..api import types as v1
from ..api.labels import Selector
from ..apiserver.server import NotFound
from ..client.informer import EventHandler, meta_namespace_key
from ..utils import serde
from .base import Controller, is_pod_ready


class EndpointSliceController(Controller):
    name = "endpointslice"

    def __init__(
        self,
        clientset,
        informer_factory,
        workers: int = 2,
        max_endpoints_per_slice: int = discovery.MAX_ENDPOINTS_PER_SLICE,
    ):
        super().__init__(workers=workers)
        self.client = clientset
        self.max_per_slice = max_endpoints_per_slice
        self.svc_informer = informer_factory.informer_for("services")
        self.pod_informer = informer_factory.informer_for("pods")
        self.slice_informer = informer_factory.informer_for("endpointslices")
        self.svc_informer.add_event_handler(
            EventHandler(
                on_add=lambda s: self.enqueue(meta_namespace_key(s)),
                on_update=lambda o, n: self.enqueue(meta_namespace_key(n)),
                on_delete=lambda s: self.enqueue(meta_namespace_key(s)),
            )
        )
        self.pod_informer.add_event_handler(
            EventHandler(
                on_add=self._on_pod_event,
                on_update=self._on_pod_update,
                on_delete=self._on_pod_event,
            )
        )

    def _on_pod_event(self, pod: v1.Pod) -> None:
        for svc in self.svc_informer.list():
            if svc.metadata.namespace != pod.metadata.namespace:
                continue
            if not svc.spec.selector:
                continue
            if Selector.from_match_labels(svc.spec.selector).matches(
                pod.metadata.labels
            ):
                self.enqueue(meta_namespace_key(svc))

    def _on_pod_update(self, old: v1.Pod, new: v1.Pod) -> None:
        self._on_pod_event(new)
        if (old.metadata.labels or {}) != (new.metadata.labels or {}):
            self._on_pod_event(old)

    # -- sync ---------------------------------------------------------------

    def _owned_slices(self, namespace: str, name: str) -> List:
        out = []
        for sl in self.slice_informer.list():
            if sl.metadata.namespace != namespace:
                continue
            if (sl.metadata.labels or {}).get(discovery.LABEL_SERVICE_NAME) == name:
                out.append(sl)
        return out

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        svc: Optional[v1.Service] = self.svc_informer.get(key)
        slices_client = self.client.resource("endpointslices")
        if svc is None or not svc.spec.selector:
            for sl in self._owned_slices(namespace, name):
                try:
                    slices_client.delete(sl.metadata.name, namespace)
                except NotFound:
                    pass
            return
        sel = Selector.from_match_labels(svc.spec.selector)
        endpoints: List[discovery.Endpoint] = []
        for pod in self.pod_informer.list():
            if pod.metadata.namespace != namespace:
                continue
            if not sel.matches(pod.metadata.labels):
                continue
            if not pod.status.pod_ip or pod.metadata.deletion_timestamp is not None:
                continue
            if pod.status.phase in ("Succeeded", "Failed"):
                continue
            endpoints.append(
                discovery.Endpoint(
                    addresses=[pod.status.pod_ip],
                    conditions=discovery.EndpointConditions(ready=is_pod_ready(pod)),
                    node_name=pod.spec.node_name,
                    target_ref_name=pod.metadata.name,
                    target_ref_namespace=pod.metadata.namespace,
                )
            )
        endpoints.sort(key=lambda e: e.addresses[0])
        ports = [
            discovery.EndpointSlicePort(
                name=p.name, port=p.target_port or p.port, protocol=p.protocol
            )
            for p in (svc.spec.ports or [])
        ]
        # chunk into slices of max_per_slice
        desired = []
        for i in range(0, max(1, len(endpoints)), self.max_per_slice):
            desired.append(
                discovery.EndpointSlice(
                    metadata=v1.ObjectMeta(
                        name=f"{name}-{i // self.max_per_slice}",
                        namespace=namespace,
                        labels={discovery.LABEL_SERVICE_NAME: name},
                    ),
                    endpoints=endpoints[i : i + self.max_per_slice] or None,
                    ports=ports or None,
                )
            )
        existing = {sl.metadata.name: sl for sl in self._owned_slices(namespace, name)}
        for sl in desired:
            cur = existing.pop(sl.metadata.name, None)
            if cur is None:
                slices_client.create(sl)
            elif serde.to_dict(cur.endpoints) != serde.to_dict(sl.endpoints) or (
                serde.to_dict(cur.ports) != serde.to_dict(sl.ports)
            ):
                # never mutate the informer-cached object (cache copy
                # discipline): a failed update would leave the cache
                # pre-agreeing with desired state and starve the retry
                updated = copy.deepcopy(cur)
                updated.endpoints = sl.endpoints
                updated.ports = sl.ports
                slices_client.update(updated)
        for leftover in existing.values():
            try:
                slices_client.delete(leftover.metadata.name, namespace)
            except NotFound:
                pass
