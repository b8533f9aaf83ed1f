"""kube-aggregator equivalent: APIService routing to delegate servers.

Reference: staging/src/k8s.io/kube-aggregator — APIService objects
(pkg/apis/apiregistration/v1/types.go:17) declare that a group/version is
served by an external extension apiserver; the aggregator proxies those
requests (pkg/apiserver/handler_proxy.go) and serves everything else from
the local delegate chain. In-proc equivalent: `AggregatedAPIServer`
exposes the same verb surface as APIServer; resources claimed by a
registered APIService route to that service's delegate APIServer, all
others to the local one. Clientset/informers work unchanged against it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api import types as v1
from .server import APIServer, NotFound, ResourceInfo


@dataclass
class APIServiceSpec:
    group: str = ""
    version: str = "v1"
    # local in-proc delegate is registered programmatically (the service/
    # port fields of the reference select a Service to proxy to)
    group_priority_minimum: int = 0
    version_priority: int = 0


@dataclass
class APIServiceCondition:
    type: str = ""  # Available
    status: str = ""


@dataclass
class APIServiceStatus:
    conditions: Optional[List[APIServiceCondition]] = None


@dataclass
class APIService:
    metadata: v1.ObjectMeta = field(default_factory=v1.ObjectMeta)
    spec: APIServiceSpec = field(default_factory=APIServiceSpec)
    status: APIServiceStatus = field(default_factory=APIServiceStatus)
    kind: str = "APIService"
    api_version: str = "apiregistration.k8s.io/v1"


class AggregatedAPIServer:
    """Routes per-resource to delegate APIServers; defaults to local."""

    def __init__(self, local: Optional[APIServer] = None):
        self.local = local or APIServer()
        self.local.register_resource(ResourceInfo("apiservices", APIService, False))
        # resource name -> (owning APIService name, delegate APIServer)
        self._routes: Dict[str, tuple] = {}

    def register_api_service(self, svc: APIService, delegate: APIServer) -> None:
        """Install the APIService object and route its group's resources
        (everything the delegate serves that the local server doesn't) to
        the delegate."""
        expected = f"{svc.spec.version}.{svc.spec.group}"
        if svc.metadata.name != expected:
            raise ValueError(f"APIService name must be {expected!r}")
        try:
            self.local.get("apiservices", svc.metadata.name)
        except NotFound:
            svc.status.conditions = [
                APIServiceCondition(type="Available", status="True")
            ]
            self.local.create("apiservices", svc)
        for info in delegate.resources():
            if info.name not in self.local._resources:
                self._routes[info.name] = (svc.metadata.name, delegate)

    def unregister_api_service(self, name: str) -> None:
        try:
            self.local.delete("apiservices", name)
        except NotFound:
            pass
        # drop exactly this APIService's routes (others keep serving)
        self._routes = {
            res: (owner, delegate)
            for res, (owner, delegate) in self._routes.items()
            if owner != name
        }

    # -- routing ------------------------------------------------------------

    def _server_for(self, resource: str) -> APIServer:
        if resource in self.local._resources:
            return self.local
        route = self._routes.get(resource)
        if route is not None:
            return route[1]
        return self.local  # raises unknown-resource NotFound downstream

    def resources(self):
        out = list(self.local.resources())
        seen = {i.name for i in out}
        for name, (_, delegate) in self._routes.items():
            for info in delegate.resources():
                if info.name == name and name not in seen:
                    out.append(info)
                    seen.add(name)
        return tuple(out)

    def _info(self, resource: str):
        return self._server_for(resource)._info(resource)

    def register_resource(self, info: ResourceInfo) -> None:
        self.local.register_resource(info)

    # verb surface (what Clientset calls)
    def create(self, resource, obj):
        return self._server_for(resource).create(resource, obj)

    def get(self, resource, name, namespace=""):
        return self._server_for(resource).get(resource, name, namespace)

    def update(self, resource, obj, subresource=""):
        return self._server_for(resource).update(resource, obj, subresource)

    def update_status(self, resource, obj, fence=None):
        if fence is not None:
            return self._server_for(resource).update_status(
                resource, obj, fence=fence)
        return self._server_for(resource).update_status(resource, obj)

    def delete(self, resource, name, namespace="", fence=None):
        if fence is not None:
            return self._server_for(resource).delete(
                resource, name, namespace, fence=fence)
        return self._server_for(resource).delete(resource, name, namespace)

    def remove_finalizer(self, resource, name, namespace, finalizer):
        return self._server_for(resource).remove_finalizer(
            resource, name, namespace, finalizer
        )

    def list(self, resource, namespace=None, label_selector=None):
        return self._server_for(resource).list(resource, namespace, label_selector)

    def watch(self, resource, namespace=None, since_revision=None):
        return self._server_for(resource).watch(resource, namespace, since_revision)

    def bind_pod(self, namespace, pod_name, node_name, fence=None):
        if fence is not None:
            return self.local.bind_pod(namespace, pod_name, node_name,
                                       fence=fence)
        return self.local.bind_pod(namespace, pod_name, node_name)

    def bind_pods(self, bindings, fence=None):
        if fence is not None:
            return self.local.bind_pods(bindings, fence=fence)
        return self.local.bind_pods(bindings)

    @property
    def store(self):
        return self.local.store

    @property
    def _mutating(self):
        return self.local._mutating

    @property
    def _validating(self):
        return self.local._validating

    @property
    def _post_write(self):
        return self.local._post_write

    @property
    def _resources(self):
        return self.local._resources
