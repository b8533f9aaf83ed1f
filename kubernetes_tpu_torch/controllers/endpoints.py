"""Endpoints controller.

Reference: pkg/controller/endpoint/endpoints_controller.go — syncService
(:555): for each Service with a selector, collect its pods' IPs into
ready/not-ready address sets per port and write the Endpoints object of
the same name.
"""

from __future__ import annotations

from typing import List, Optional

from ..api import types as v1
from ..api.labels import Selector
from ..apiserver.server import NotFound
from ..client.informer import EventHandler, meta_namespace_key
from ..utils import serde
from .base import Controller, is_pod_ready


class EndpointsController(Controller):
    name = "endpoints"

    def __init__(self, clientset, informer_factory, workers: int = 2):
        super().__init__(workers=workers)
        self.client = clientset
        self.svc_informer = informer_factory.informer_for("services")
        self.pod_informer = informer_factory.informer_for("pods")
        self._wire_handlers()

    def _wire_handlers(self) -> None:
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
        # enqueue every service in the pod's namespace whose selector matches
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
        # services selecting the OLD labels must also re-sync, or a
        # relabeled pod's IP lingers in its former service's endpoints
        # (endpoints_controller.go:200 updatePod unions both sets)
        self._on_pod_event(new)
        if (old.metadata.labels or {}) != (new.metadata.labels or {}):
            self._on_pod_event(old)

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        svc: Optional[v1.Service] = self.svc_informer.get(key)
        if svc is None:
            try:
                self.client.endpoints.delete(name, namespace)
            except NotFound:
                pass
            return
        if not svc.spec.selector:
            return  # headless-without-selector: endpoints managed manually
        sel = Selector.from_match_labels(svc.spec.selector)
        ready: List[v1.EndpointAddress] = []
        not_ready: List[v1.EndpointAddress] = []
        for pod in self.pod_informer.list():
            if pod.metadata.namespace != namespace:
                continue
            if not sel.matches(pod.metadata.labels):
                continue
            if not pod.status.pod_ip or pod.metadata.deletion_timestamp is not None:
                continue
            if pod.status.phase in ("Succeeded", "Failed"):
                continue
            addr = v1.EndpointAddress(
                ip=pod.status.pod_ip,
                node_name=pod.spec.node_name,
                target_ref_name=pod.metadata.name,
                target_ref_namespace=pod.metadata.namespace,
            )
            (ready if is_pod_ready(pod) else not_ready).append(addr)
        ports = [
            v1.EndpointPort(name=p.name, port=p.target_port or p.port, protocol=p.protocol)
            for p in (svc.spec.ports or [])
        ]
        subsets = []
        if ready or not_ready:
            subsets.append(
                v1.EndpointSubset(
                    addresses=sorted(ready, key=lambda a: a.ip) or None,
                    not_ready_addresses=sorted(not_ready, key=lambda a: a.ip) or None,
                    ports=ports or None,
                )
            )
        ep = v1.Endpoints(
            metadata=v1.ObjectMeta(name=name, namespace=namespace),
            subsets=subsets or None,
        )
        try:
            existing = self.client.endpoints.get(name, namespace)
            if serde.to_dict(existing.subsets) == serde.to_dict(ep.subsets):
                return
            existing.subsets = ep.subsets
            self.client.endpoints.update(existing)
        except NotFound:
            self.client.endpoints.create(ep)
