"""Root CA certificate publisher.

Reference: pkg/controller/certificates/rootcacertpublisher/publisher.go —
ensure every namespace holds a `kube-root-ca.crt` ConfigMap with the
cluster CA bundle (`ca.crt` key) so workloads can verify the apiserver;
reconciles on namespace add and on ConfigMap mutation/deletion (:116
syncNamespace).
"""

from __future__ import annotations

from ..api import types as v1
from ..apiserver.server import AlreadyExists, NotFound
from ..client.informer import EventHandler
from .base import Controller, retry_on_conflict

ROOT_CA_CONFIGMAP = "kube-root-ca.crt"


class RootCACertPublisher(Controller):
    name = "root-ca-cert-publisher"

    def __init__(self, clientset, informer_factory, root_ca: str,
                 workers: int = 1):
        super().__init__(workers=workers)
        self.client = clientset
        self.root_ca = root_ca
        self.ns_informer = informer_factory.informer_for("namespaces")
        self.cm_informer = informer_factory.informer_for("configmaps")
        self.ns_informer.add_event_handler(EventHandler(
            on_add=lambda ns: self.enqueue(ns.metadata.name),
            on_update=lambda o, n: self.enqueue(n.metadata.name),
        ))
        self.cm_informer.add_event_handler(EventHandler(
            on_update=self._on_cm_update, on_delete=self._on_cm_delete,
        ))

    def _on_cm_update(self, old: v1.ConfigMap, new: v1.ConfigMap) -> None:
        if new.metadata.name == ROOT_CA_CONFIGMAP:
            self.enqueue(new.metadata.namespace)

    def _on_cm_delete(self, cm: v1.ConfigMap) -> None:
        if cm.metadata.name == ROOT_CA_CONFIGMAP:
            self.enqueue(cm.metadata.namespace)

    def sync(self, key: str) -> None:
        ns = self.ns_informer.get(key)
        if ns is None or ns.metadata.deletion_timestamp is not None:
            return
        if getattr(ns.status, "phase", "") == "Terminating":
            return
        try:
            cm = self.client.configmaps.get(ROOT_CA_CONFIGMAP, key)
        except NotFound:
            try:
                self.client.configmaps.create(v1.ConfigMap(
                    metadata=v1.ObjectMeta(
                        name=ROOT_CA_CONFIGMAP, namespace=key),
                    data={"ca.crt": self.root_ca},
                ))
            except AlreadyExists:
                pass
            return
        if (cm.data or {}).get("ca.crt") == self.root_ca:
            return

        def apply():
            fresh = self.client.configmaps.get(ROOT_CA_CONFIGMAP, key)
            fresh.data = dict(fresh.data or {})
            fresh.data["ca.crt"] = self.root_ca
            self.client.configmaps.update(fresh)

        retry_on_conflict(apply)
