"""Garbage collector: ownerReference-based cascading deletion.

Reference: pkg/controller/garbagecollector/garbagecollector.go — the GC
builds a dependency graph from every resource's ownerReferences
(graph_builder.go) and deletes dependents whose owners are gone
(attemptToDeleteItem, :501: an object is garbage when all its owner
references point to non-existent objects).

All three propagation policies are handled:
  Background (default): owner gone → dependents collected next scan;
  Foreground (:609 processDeletingDependentsItem): the owner carries the
    foregroundDeletion finalizer; the GC deletes dependents with
    blockOwnerDeletion first and removes the finalizer when none remain;
  Orphan (:673 orphanDependents): the GC strips the owner's
    ownerReferences from every dependent, then removes the finalizer.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, Optional, Tuple

from ..apiserver.server import (
    APIError,
    APIServer,
    FINALIZER_FOREGROUND,
    FINALIZER_ORPHAN,
    NotFound,
)
from .base import Controller

KIND_TO_RESOURCE = {
    "Pod": "pods",
    "Node": "nodes",
    "ReplicaSet": "replicasets",
    "Deployment": "deployments",
    "DaemonSet": "daemonsets",
    "StatefulSet": "statefulsets",
    "Job": "jobs",
    "CronJob": "cronjobs",
    "Service": "services",
    "Endpoints": "endpoints",
    "ConfigMap": "configmaps",
    "PersistentVolumeClaim": "persistentvolumeclaims",
}


class GarbageCollector(Controller):
    name = "garbagecollector"

    def __init__(self, clientset, scan_interval: float = 0.2):
        super().__init__(workers=1)
        self.client = clientset
        self.api: APIServer = clientset.api
        self._interval = scan_interval
        self._scan_thread: Optional[threading.Thread] = None
        self._stop_scan = threading.Event()

    def run(self) -> None:
        super().run()
        self._scan_thread = threading.Thread(target=self._scan_loop, daemon=True)
        self._scan_thread.start()

    def stop(self) -> None:
        self._stop_scan.set()
        super().stop()
        if self._scan_thread is not None:
            self._scan_thread.join(timeout=5)

    def _scan_loop(self) -> None:
        while not self._stop_scan.wait(self._interval):
            try:
                self.collect_once()
            except Exception:  # noqa: BLE001
                import traceback

                traceback.print_exc()

    def _owner_exists(
        self, namespace: str, ref, cache: Dict[Tuple[str, str, str], Optional[str]]
    ) -> bool:
        resource = KIND_TO_RESOURCE.get(ref.kind)
        if resource is None:
            return True  # unknown kinds are never collected (virtual nodes)
        ck = (resource, namespace, ref.name)
        if ck not in cache:
            try:
                obj = self.api.get(resource, ref.name, namespace)
                cache[ck] = obj.metadata.uid
            except APIError:
                try:  # cluster-scoped owner fallback
                    obj = self.api.get(resource, ref.name, "")
                    cache[ck] = obj.metadata.uid
                except APIError:
                    cache[ck] = None
        uid = cache[ck]
        return uid is not None and (not ref.uid or uid == ref.uid)

    def collect_once(self) -> int:
        """One full-graph scan; returns number of objects deleted."""
        deleted = 0
        cache: Dict[Tuple[str, str, str], Optional[str]] = {}
        # one pass to index everything (the graph builder's world view)
        world = []  # (resource, obj)
        for info in self.api.resources():
            items, _ = self.api.list(info.name)
            world.extend((info.name, obj) for obj in items)
        dependents_of: Dict[str, list] = {}  # owner uid -> [(resource, obj)]
        for resource, obj in world:
            for ref in obj.metadata.owner_references or []:
                if ref.uid:
                    dependents_of.setdefault(ref.uid, []).append((resource, obj))

        # owners mid-foreground/orphan deletion (processDeletingDependentsItem)
        for resource, obj in world:
            meta = obj.metadata
            if meta.deletion_timestamp is None:
                continue
            fins = meta.finalizers or []
            deps = dependents_of.get(meta.uid, [])
            if FINALIZER_FOREGROUND in fins:
                blocking = [
                    (r, d) for r, d in deps
                    if any(
                        ref.uid == meta.uid and ref.block_owner_deletion
                        for ref in d.metadata.owner_references or []
                    )
                ]
                for r, d in blocking:
                    try:
                        self.api.delete(r, d.metadata.name, d.metadata.namespace)
                        deleted += 1
                    except NotFound:
                        pass
                if not blocking:
                    self._remove_finalizer(
                        resource, meta.name, meta.namespace, FINALIZER_FOREGROUND
                    )
            elif FINALIZER_ORPHAN in fins:
                all_stripped = True
                for r, d in deps:
                    orphaned = copy.deepcopy(d)
                    orphaned.metadata.owner_references = [
                        ref for ref in orphaned.metadata.owner_references or []
                        if ref.uid != meta.uid
                    ] or None
                    try:
                        self.api.update(r, orphaned)
                    except NotFound:
                        pass  # dependent already gone: nothing to orphan
                    except APIError:
                        # conflict: the finalizer must STAY until every
                        # dependent is stripped — releasing the owner now
                        # would hard-delete it and the next background
                        # scan would collect this still-owned dependent
                        all_stripped = False
                if all_stripped:
                    self._remove_finalizer(
                        resource, meta.name, meta.namespace, FINALIZER_ORPHAN
                    )

        # background collection: dependents whose owners are all gone
        for resource, obj in world:
            refs = obj.metadata.owner_references or []
            if not refs:
                continue
            if any(
                self._owner_exists(obj.metadata.namespace, r, cache) for r in refs
            ):
                continue
            # re-read before destroying: the orphan pass above may have
            # stripped this object's refs within this very scan, and the
            # world snapshot is stale (attemptToDeleteItem works from a
            # live get for the same reason)
            try:
                live = self.api.get(resource, obj.metadata.name, obj.metadata.namespace)
            except APIError:
                continue
            if not live.metadata.owner_references:
                continue
            try:
                self.api.delete(resource, obj.metadata.name, obj.metadata.namespace)
                deleted += 1
            except NotFound:
                pass
        return deleted

    def _remove_finalizer(self, resource, name, namespace, finalizer) -> None:
        try:
            self.api.remove_finalizer(resource, name, namespace, finalizer)
        except APIError:
            pass  # finalized concurrently: the scan must keep going

    def sync(self, key: str) -> None:
        self.collect_once()
