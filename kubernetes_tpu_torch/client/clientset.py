"""Typed clientset over the in-process APIServer.

Mirrors client-go's generated clientset surface (reference:
staging/src/k8s.io/client-go/kubernetes/clientset.go) narrowed to the
resources the control plane uses. The transport is an in-proc call; the
semantics (conflicts, not-found, list+watch revisions) are identical to
the HTTP path, which is what the components depend on.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..api import types as v1
from ..api.labels import Selector
from ..apiserver.server import APIServer, TypedWatch


class _ResourceClient:
    def __init__(self, api: APIServer, resource: str):
        self._api = api
        self._resource = resource

    def create(self, obj: Any) -> Any:
        return self._api.create(self._resource, obj)

    def create_many(self, objs) -> None:
        """Best-effort bulk create (event firehose): ONE request on
        wire-backed servers (create_bulk), a loop in-proc; individual
        failures are swallowed (callers are fire-and-forget paths)."""
        bulk = getattr(self._api, "create_bulk", None)
        if bulk is not None:
            bulk(self._resource, list(objs))
            return
        for obj in objs:
            try:
                self._api.create(self._resource, obj)
            except Exception:  # noqa: BLE001 — best-effort semantics
                pass

    def get(self, name: str, namespace: str = "") -> Any:
        return self._api.get(self._resource, name, namespace)

    def update(self, obj: Any) -> Any:
        return self._api.update(self._resource, obj)

    def update_status(self, obj: Any, fence=None) -> Any:
        if fence is not None:
            return self._api.update_status(self._resource, obj, fence=fence)
        return self._api.update_status(self._resource, obj)

    def delete(self, name: str, namespace: str = "",
               propagation_policy: Optional[str] = None, fence=None) -> None:
        if fence is not None:
            self._api.delete(self._resource, name, namespace,
                             propagation_policy=propagation_policy,
                             fence=fence)
            return
        self._api.delete(self._resource, name, namespace,
                         propagation_policy=propagation_policy)

    def list(
        self, namespace: Optional[str] = None, label_selector: Optional[Selector] = None
    ) -> Tuple[List[Any], int]:
        return self._api.list(self._resource, namespace, label_selector)

    def watch(
        self, namespace: Optional[str] = None, since_revision: Optional[int] = None
    ) -> TypedWatch:
        return self._api.watch(self._resource, namespace, since_revision)


class _PodClient(_ResourceClient):
    def bind(self, namespace: str, pod_name: str, node_name: str,
             fence=None) -> None:
        if fence is not None:
            self._api.bind_pod(namespace, pod_name, node_name, fence=fence)
            return
        self._api.bind_pod(namespace, pod_name, node_name)

    def bind_many(self, bindings: List[Tuple[str, str, str]], fence=None):
        """Bulk bindings [(namespace, name, node)]; per-binding outcome
        list (None = bound, APIError otherwise). `fence` (a leader-lease
        fencing token) makes every write conditional on the lease still
        naming the caller — see APIServer._fence_precondition."""
        if fence is not None:
            return self._api.bind_pods(bindings, fence=fence)
        return self._api.bind_pods(bindings)


class Clientset:
    def __init__(self, api: APIServer):
        self.api = api
        self.pods = _PodClient(api, "pods")
        self.nodes = _ResourceClient(api, "nodes")
        self.services = _ResourceClient(api, "services")
        self.endpoints = _ResourceClient(api, "endpoints")
        self.namespaces = _ResourceClient(api, "namespaces")
        self.configmaps = _ResourceClient(api, "configmaps")
        self.secrets = _ResourceClient(api, "secrets")
        self.serviceaccounts = _ResourceClient(api, "serviceaccounts")
        self.persistentvolumes = _ResourceClient(api, "persistentvolumes")
        self.persistentvolumeclaims = _ResourceClient(api, "persistentvolumeclaims")
        self.replicationcontrollers = _ResourceClient(api, "replicationcontrollers")
        self.replicasets = _ResourceClient(api, "replicasets")
        self.deployments = _ResourceClient(api, "deployments")
        self.daemonsets = _ResourceClient(api, "daemonsets")
        self.statefulsets = _ResourceClient(api, "statefulsets")
        self.jobs = _ResourceClient(api, "jobs")
        self.cronjobs = _ResourceClient(api, "cronjobs")
        self.storageclasses = _ResourceClient(api, "storageclasses")
        self.csinodes = _ResourceClient(api, "csinodes")
        self.priorityclasses = _ResourceClient(api, "priorityclasses")

    def resource(self, name: str) -> _ResourceClient:
        return _ResourceClient(self.api, name)
