"""Namespace lifecycle controller.

Reference: pkg/controller/namespace/namespace_controller.go +
deletion/namespaced_resources_deleter.go — when a Namespace has a
deletionTimestamp, delete every namespaced object in it (enumerated via
discovery, here APIServer.resources()), then remove the `kubernetes`
finalizer so the store completes the delete.
"""

from __future__ import annotations

import copy

from ..api import types as v1
from ..apiserver.server import NotFound
from ..client.informer import EventHandler
from .base import Controller

FINALIZER = "kubernetes"


class NamespaceController(Controller):
    name = "namespace"

    def __init__(self, clientset, informer_factory, workers: int = 2):
        super().__init__(workers=workers)
        self.client = clientset
        self.ns_informer = informer_factory.informer_for("namespaces")
        self.ns_informer.add_event_handler(
            EventHandler(
                on_add=lambda ns: self.enqueue(ns.metadata.name),
                on_update=lambda o, n: self.enqueue(n.metadata.name),
            )
        )

    def sync(self, key: str) -> None:
        ns = self.ns_informer.get(key)
        if ns is None:
            return
        if ns.metadata.deletion_timestamp is None:
            # ensure the finalizer + Active phase on live namespaces
            # (namespaces are created with spec.finalizers=["kubernetes"])
            changed = False
            updated = copy.deepcopy(ns)
            if FINALIZER not in (updated.metadata.finalizers or []):
                updated.metadata.finalizers = (updated.metadata.finalizers or []) + [
                    FINALIZER
                ]
                changed = True
            if updated.status.phase != "Active":
                updated.status.phase = "Active"
                changed = True
            if changed:
                try:
                    self.client.namespaces.update(updated)
                except Exception:  # noqa: BLE001 — conflict: re-sync on event
                    pass
            return
        # terminating: drain all namespaced content
        remaining = 0
        api = self.client.api
        for info in api.resources():
            if not info.namespaced:
                continue
            items, _ = api.list(info.name, namespace=key)
            for obj in items:
                remaining += 1
                try:
                    api.delete(info.name, obj.metadata.name, key)
                except NotFound:
                    pass
        if remaining > 0:
            self.enqueue_after(key, 0.05)
            return
        if ns.status.phase != "Terminating":
            updated = copy.deepcopy(ns)
            updated.status.phase = "Terminating"
            try:
                self.client.namespaces.update_status(updated)
            except Exception:  # noqa: BLE001
                pass
        api.remove_finalizer("namespaces", key, "", FINALIZER)
