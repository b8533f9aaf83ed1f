"""EndpointSlice mirroring controller.

Reference: pkg/controller/endpointslicemirroring/ — custom Endpoints
objects (for Services WITHOUT a selector, maintained by users) are
mirrored into EndpointSlices so consumers can rely on the slice API
alone. Mirrored slices carry kubernetes.io/service-name plus
endpointslice.kubernetes.io/managed-by=endpointslicemirroring-controller
(:metrics & reconciler.go); Endpoints owned by the endpoints controller
(their Service HAS a selector) are skipped.
"""

from __future__ import annotations

from typing import List

from ..api import discovery
from ..api import types as v1
from ..apiserver.server import NotFound
from ..client.informer import EventHandler, meta_namespace_key
from .base import Controller

MANAGED_BY_LABEL = "endpointslice.kubernetes.io/managed-by"
MANAGED_BY = "endpointslicemirroring-controller"


class EndpointSliceMirroringController(Controller):
    name = "endpointslicemirroring"

    def __init__(self, clientset, informer_factory, workers: int = 1,
                 max_endpoints_per_slice: int = discovery.MAX_ENDPOINTS_PER_SLICE):
        super().__init__(workers=workers)
        self.client = clientset
        self.max_per_slice = max_endpoints_per_slice
        self.ep_informer = informer_factory.informer_for("endpoints")
        self.svc_informer = informer_factory.informer_for("services")
        self.slice_informer = informer_factory.informer_for("endpointslices")
        self.ep_informer.add_event_handler(EventHandler(
            on_add=lambda e: self.enqueue(meta_namespace_key(e)),
            on_update=lambda o, n: self.enqueue(meta_namespace_key(n)),
            on_delete=lambda e: self.enqueue(meta_namespace_key(e)),
        ))
        self.svc_informer.add_event_handler(EventHandler(
            on_add=lambda s: self.enqueue(meta_namespace_key(s)),
            on_update=lambda o, n: self.enqueue(meta_namespace_key(n)),
            # Service deletion must clean up its mirrored slices
            on_delete=lambda s: self.enqueue(meta_namespace_key(s)),
        ))

    def _mirrored_slices(self, namespace: str, name: str) -> List:
        return [
            sl for sl in self.slice_informer.list()
            if sl.metadata.namespace == namespace
            and (sl.metadata.labels or {}).get(MANAGED_BY_LABEL) == MANAGED_BY
            and (sl.metadata.labels or {}).get(
                discovery.LABEL_SERVICE_NAME) == name
        ]

    def _desired(self, ep: v1.Endpoints) -> List[discovery.EndpointSlice]:
        # one slice group PER SUBSET: a subset's addresses serve exactly
        # that subset's ports — merging ports across subsets would
        # advertise addresses on ports they do not serve (the reference
        # reconciler likewise keys slices by the subset's port set)
        slices: List[discovery.EndpointSlice] = []
        for si, subset in enumerate(ep.subsets or []):
            ports = [
                discovery.EndpointSlicePort(
                    name=p.name, protocol=p.protocol or "TCP", port=p.port)
                for p in subset.ports or []
            ]
            endpoints: List[discovery.Endpoint] = []
            for addr in subset.addresses or []:
                endpoints.append(discovery.Endpoint(
                    addresses=[addr.ip],
                    conditions=discovery.EndpointConditions(ready=True),
                    node_name=getattr(addr, "node_name", "") or "",
                ))
            for addr in subset.not_ready_addresses or []:
                endpoints.append(discovery.Endpoint(
                    addresses=[addr.ip],
                    conditions=discovery.EndpointConditions(ready=False),
                ))
            for i in range(0, max(len(endpoints), 1), self.max_per_slice):
                chunk = endpoints[i:i + self.max_per_slice]
                slices.append(discovery.EndpointSlice(
                    metadata=v1.ObjectMeta(
                        name=(f"{ep.metadata.name}-mirror-{si}"
                              f"-{i // self.max_per_slice}"),
                        namespace=ep.metadata.namespace,
                        labels={
                            discovery.LABEL_SERVICE_NAME: ep.metadata.name,
                            MANAGED_BY_LABEL: MANAGED_BY,
                        },
                    ),
                    endpoints=chunk,
                    ports=list(ports) or None,
                ))
        return slices

    def sync(self, key: str) -> None:
        namespace, _, name = key.partition("/")
        ep = self.ep_informer.get(key)
        svc = self.svc_informer.get(key)
        # mirror ONLY custom Endpoints: a Service with a selector owns its
        # endpoints via the endpoints/endpointslice controllers
        mirrorable = (
            ep is not None and svc is not None and not svc.spec.selector
        )
        existing = self._mirrored_slices(namespace, name)
        if not mirrorable:
            for sl in existing:
                try:
                    self.client.resource("endpointslices").delete(
                        sl.metadata.name, namespace)
                except NotFound:
                    pass
            return
        desired = self._desired(ep)
        desired_names = {d.metadata.name for d in desired}
        for sl in existing:
            if sl.metadata.name not in desired_names:
                try:
                    self.client.resource("endpointslices").delete(
                        sl.metadata.name, namespace)
                except NotFound:
                    pass
        by_name = {sl.metadata.name: sl for sl in existing}
        for d in desired:
            cur = by_name.get(d.metadata.name)
            if cur is None:
                self.client.resource("endpointslices").create(d)
            else:
                from ..utils import serde

                if serde.to_dict(cur.endpoints) != serde.to_dict(d.endpoints) \
                        or serde.to_dict(cur.ports) != serde.to_dict(d.ports):
                    d.metadata.resource_version = cur.metadata.resource_version
                    self.client.resource("endpointslices").update(d)
