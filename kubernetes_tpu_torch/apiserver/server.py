"""Typed object CRUD + watch over the KV store — the apiserver equivalent.

Reproduces the request-path semantics the control plane depends on
(reference: staging/src/k8s.io/apiserver/pkg/endpoints/handlers/create.go:52
decode→admit→store, update.go with resourceVersion conflict checks,
watch.go streaming; pkg/registry/core/pod/rest for the binding
subresource):

  * objects get uid / creationTimestamp / resourceVersion on create;
    resourceVersion is the store mod revision (etcd3 semantics);
  * update requires a matching resourceVersion or raises Conflict —
    optimistic concurrency exactly like GuaranteedUpdate's precondition;
  * list returns (items, list_resource_version) so informers can start a
    watch with no event gap; watch replays from any uncompacted revision;
  * pods/{name}/binding sets spec.nodeName once — the scheduler's bind
    verb (DefaultBinder POST, pkg/scheduler/framework/plugins/
    defaultbinder/default_binder.go) — and fails if already bound;
  * admission hooks run mutate-then-validate on writes (pkg/admission).

Objects are stored as serde dicts (wire shape) and re-hydrated per read, so
callers can never alias stored state — the watch cache's copy discipline.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Type

from ..api import types as v1
from ..api.labels import Selector
from ..store import kv
from ..utils import serde


class APIError(Exception):
    code = 500  # HTTP status the reference would serve for this error


class NotFound(APIError):
    code = 404


class AlreadyExists(APIError):
    code = 409


class Conflict(APIError):
    code = 409


class Invalid(APIError):
    code = 422


class FenceExpired(APIError):
    """A write carried a fencing token whose lease no longer matches the
    stored leader lease (different holder or a newer leaseTransitions
    epoch): the caller is a deposed leader and must demote, not retry.
    Deliberately NOT a kv.Conflict subclass — guaranteed_update's
    optimistic retry loop must not paper over a dead fence."""

    code = 409


@dataclass(frozen=True)
class ResourceInfo:
    name: str  # plural, e.g. "pods"
    type: Type
    namespaced: bool


def _default_resources() -> Tuple["ResourceInfo", ...]:
    from ..api import (
        apps,
        autoscaling,
        batch,
        certificates,
        discovery,
        metrics,
        networking,
        rbac,
        storage,
    )
    from ..client.events import Event

    return (
        ResourceInfo("serviceaccounts", rbac.ServiceAccount, True),
        ResourceInfo(
            "certificatesigningrequests",
            certificates.CertificateSigningRequest,
            False,
        ),
        # RBAC objects are API resources whether or not the RBAC
        # authorizer (SecureAPIServer) is active — the
        # clusterrole-aggregation controller reconciles them either way
        ResourceInfo("roles", rbac.Role, True),
        ResourceInfo("clusterroles", rbac.ClusterRole, False),
        ResourceInfo("rolebindings", rbac.RoleBinding, True),
        ResourceInfo("clusterrolebindings", rbac.ClusterRoleBinding, False),
        ResourceInfo("nodemetrics", metrics.NodeMetrics, False),
        ResourceInfo("podmetrics", metrics.PodMetrics, True),
        ResourceInfo("pods", v1.Pod, True),
        ResourceInfo("nodes", v1.Node, False),
        ResourceInfo("endpointslices", discovery.EndpointSlice, True),
        ResourceInfo(
            "horizontalpodautoscalers", autoscaling.HorizontalPodAutoscaler, True
        ),
        ResourceInfo("resourcequotas", v1.ResourceQuota, True),
        ResourceInfo("limitranges", v1.LimitRange, True),
        ResourceInfo("poddisruptionbudgets", v1.PodDisruptionBudget, True),
        ResourceInfo("events", Event, True),
        ResourceInfo("leases", v1.Lease, True),
        ResourceInfo("services", v1.Service, True),
        ResourceInfo("endpoints", v1.Endpoints, True),
        ResourceInfo("namespaces", v1.Namespace, False),
        ResourceInfo("configmaps", v1.ConfigMap, True),
        ResourceInfo("secrets", v1.Secret, True),
        ResourceInfo("persistentvolumes", v1.PersistentVolume, False),
        ResourceInfo("persistentvolumeclaims", v1.PersistentVolumeClaim, True),
        ResourceInfo("replicationcontrollers", v1.ReplicationController, True),
        ResourceInfo("replicasets", apps.ReplicaSet, True),
        ResourceInfo("deployments", apps.Deployment, True),
        ResourceInfo("daemonsets", apps.DaemonSet, True),
        ResourceInfo("statefulsets", apps.StatefulSet, True),
        ResourceInfo("jobs", batch.Job, True),
        ResourceInfo("cronjobs", batch.CronJob, True),
        ResourceInfo("storageclasses", storage.StorageClass, False),
        ResourceInfo("csinodes", storage.CSINode, False),
        ResourceInfo("priorityclasses", storage.PriorityClass, False),
        ResourceInfo("runtimeclasses", storage.RuntimeClass, False),
        ResourceInfo("networkpolicies", networking.NetworkPolicy, True),
        ResourceInfo("ingresses", networking.Ingress, True),
        ResourceInfo("ingressclasses", networking.IngressClass, False),
    )


@dataclass(frozen=True)
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    object: Any
    revision: int


class TypedWatch:
    def __init__(self, raw: kv.Watch, typ: Type):
        self._raw = raw
        self._typ = typ

    def raw_events(self) -> kv.Watch:
        """The underlying store watch (raw dict values). The HTTP wire
        streams these directly: hydrating to typed objects and
        re-serializing per watcher was pure per-event overhead on the
        watch fan-out path."""
        return self._raw

    @property
    def closed(self) -> bool:
        """True once the underlying store watch died (e.g. an apiserver
        crash killed every stream): reflectors re-list+re-watch."""
        return getattr(self._raw, "closed", False)

    def stop(self) -> None:
        self._raw.stop()

    def _hydrate(self, ev: kv.Event) -> WatchEvent:
        # stamp the event revision as resourceVersion (etcd3: the event's
        # object carries mod_revision == event revision), matching _stamp
        # on get/list — informer caches must hold current RVs or every
        # optimistic update they feed conflicts
        obj = serde.from_dict(self._typ, ev.value)
        obj.metadata.resource_version = str(ev.revision)
        return WatchEvent(ev.type, obj, ev.revision)

    def __iter__(self) -> Iterator[WatchEvent]:
        for ev in self._raw:
            yield self._hydrate(ev)

    def poll(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        ev = self._raw.poll(timeout)
        if ev is None:
            return None
        return self._hydrate(ev)


# admission plugin signature: (resource, operation, obj) -> None | raises
AdmissionFunc = Callable[[str, str, Any], None]

# GC propagation finalizers (apimachinery metav1.FinalizerDeleteDependents
# / FinalizerOrphanDependents)
FINALIZER_FOREGROUND = "foregroundDeletion"
FINALIZER_ORPHAN = "orphan"


class APIServer:
    def __init__(
        self,
        store: Optional[kv.KVStore] = None,
        resources: Optional[Tuple[ResourceInfo, ...]] = None,
        mutating_admission: Optional[List[AdmissionFunc]] = None,
        validating_admission: Optional[List[AdmissionFunc]] = None,
    ):
        self.store = store or kv.KVStore()
        if resources is None:
            resources = _default_resources()
        self._resources: Dict[str, ResourceInfo] = {r.name: r for r in resources}
        self._mutating = mutating_admission or []
        self._validating = validating_admission or []
        # called AFTER a successful create/update/hard-delete with
        # (resource, op, obj) — serving-state side effects (e.g. CRD
        # registration) must not fire for writes the store rejects
        self._post_write: List[AdmissionFunc] = []
        self._lock = threading.Lock()
        # node-name -> kubelet node API (logs/exec proxying: the
        # reference's apiserver→kubelet connection behind
        # pods/{name}/log and pods/{name}/exec, registry/core/pod/rest)
        self._node_proxies: Dict[str, Any] = {}

    def register_resource(self, info: ResourceInfo) -> None:
        self._resources[info.name] = info

    # -- node proxy (kubelet API) ------------------------------------------

    def register_node_proxy(self, node_name: str, handler: Any) -> None:
        with self._lock:
            self._node_proxies[node_name] = handler

    def unregister_node_proxy(self, node_name: str) -> None:
        with self._lock:
            self._node_proxies.pop(node_name, None)

    def pod_logs(self, name: str, namespace: str = "", container: str = "",
                 tail: Optional[int] = None) -> List[str]:
        """GET pods/{name}/log: resolve the pod's node, proxy to its
        kubelet (handlers in registry/core/pod/rest/log.go)."""
        pod = self.get("pods", name, namespace)
        if not pod.spec.node_name:
            raise Invalid(f"pod {name} is not scheduled yet")
        with self._lock:
            h = self._node_proxies.get(pod.spec.node_name)
        if h is None:
            raise NotFound(f"no kubelet connection for node {pod.spec.node_name}")
        return h.container_logs(name, namespace, container, tail)

    def pod_exec(self, name: str, namespace: str, cmd: List[str],
                 container: str = "") -> Tuple[str, int]:
        """POST pods/{name}/exec → kubelet → CRI ExecSync."""
        return self._node_handler_for(name, namespace).exec_in_pod(
            name, namespace, cmd, container
        )

    def _node_handler_for(self, name: str, namespace: str):
        pod = self.get("pods", name, namespace)
        if not pod.spec.node_name:
            raise Invalid(f"pod {name} is not scheduled yet")
        with self._lock:
            h = self._node_proxies.get(pod.spec.node_name)
        if h is None:
            raise NotFound(f"no kubelet connection for node {pod.spec.node_name}")
        return h

    def pod_exec_stream(self, name: str, namespace: str, cmd: List[str],
                        container: str = ""):
        """Streaming exec (the SPDY/remotecommand proxy path: the
        apiserver connects the client stream to the kubelet's streaming
        server; cri/streaming)."""
        return self._node_handler_for(name, namespace).exec_stream_in_pod(
            name, namespace, cmd, container
        )

    def pod_attach(self, name: str, namespace: str, container: str = ""):
        return self._node_handler_for(name, namespace).attach_pod(
            name, namespace, container
        )

    def pod_portforward(self, name: str, namespace: str, port: int):
        return self._node_handler_for(name, namespace).portforward_pod(
            name, namespace, port
        )

    # -- keys --------------------------------------------------------------

    def _info(self, resource: str) -> ResourceInfo:
        info = self._resources.get(resource)
        if info is None:
            raise NotFound(f"unknown resource {resource!r}")
        return info

    def _key(self, info: ResourceInfo, namespace: str, name: str) -> str:
        if info.namespaced:
            if not namespace:
                raise Invalid(f"{info.name} is namespaced: namespace required")
            return f"/registry/{info.name}/{namespace}/{name}"
        return f"/registry/{info.name}/{name}"

    def _prefix(self, info: ResourceInfo, namespace: Optional[str]) -> str:
        if info.namespaced and namespace:
            return f"/registry/{info.name}/{namespace}/"
        return f"/registry/{info.name}/"

    # -- verbs -------------------------------------------------------------

    def create(self, resource: str, obj: Any) -> Any:
        info = self._info(resource)
        meta = obj.metadata
        if not meta.name:
            raise Invalid("metadata.name is required")
        if resource == "certificatesigningrequests":
            # stamp the requester identity server-side (certificates
            # types.go:89-99: Username/Groups are set by the apiserver
            # from the authenticated request, never trusted from the
            # body) — otherwise any CSR-creating identity could assert a
            # bootstrap identity and mint auto-approved node credentials.
            # In-proc callers with no request context are the trusted
            # local path (same trust level as writing the store directly).
            from ..api.certificates import CertificateSigningRequestStatus
            from .requestcontext import current_user

            user = current_user()
            if user is not None:
                obj.spec.username = user.name
                obj.spec.groups = list(user.groups or ())
            # a CREATE never carries status: a caller-supplied Approved
            # condition would let the signer mint credentials without
            # any approver having acted (create.go drops status for
            # every resource with a status subresource)
            obj.status = CertificateSigningRequestStatus()
        # non-atomic admission runs OUTSIDE the lock — webhook plugins do
        # blocking HTTP here and may re-enter the server; only hooks
        # flagged `atomic` (quota: usage check must not race the write
        # past the hard limit) run under the lock with the store write
        for admit in self._mutating:
            admit(resource, "CREATE", obj)
        for admit in self._validating:
            if not getattr(admit, "atomic", False):
                admit(resource, "CREATE", obj)
        with self._lock:
            for admit in self._validating:
                if getattr(admit, "atomic", False):
                    admit(resource, "CREATE", obj)
            meta.uid = meta.uid or str(uuid.uuid4())
            meta.creation_timestamp = meta.creation_timestamp or time.time()
            if resource == "namespaces" and "kubernetes" not in (meta.finalizers or []):
                # stamped server-side at create (pkg/registry/core/namespace/
                # strategy.go PrepareForCreate) so a delete racing the
                # namespace controller can never skip the content drain
                meta.finalizers = (meta.finalizers or []) + ["kubernetes"]
            key = self._key(info, meta.namespace, meta.name)
            body = serde.to_dict(obj)
            try:
                rev = self.store.create(key, body)
            except kv.KeyExists:
                raise AlreadyExists(key)
        created = self._stamp(info, body, rev)
        for hook in self._post_write:
            hook(resource, "CREATE", created)
        return created

    def get(self, resource: str, name: str, namespace: str = "") -> Any:
        info = self._info(resource)
        try:
            kvv = self.store.get(self._key(info, namespace, name))
        except kv.KeyNotFound as e:
            raise NotFound(str(e))
        return self._stamp(info, kvv.value, kvv.mod_revision)

    def update(self, resource: str, obj: Any, subresource: str = "") -> Any:
        """Full-object update guarded by metadata.resourceVersion (empty
        resourceVersion = unconditional last-write-wins, as the reference
        allows for updates without preconditions)."""
        info = self._info(resource)
        meta = obj.metadata
        key = self._key(info, meta.namespace, meta.name)
        op = "UPDATE"
        if resource == "certificatesigningrequests":
            # CSR spec is immutable after create for authenticated
            # callers (the reference's strategy.PrepareForUpdate copies
            # the old spec): rewriting spec.username post-create would
            # defeat the requester stamping above
            from .requestcontext import current_user

            if current_user() is not None:
                try:
                    old = self.get(resource, meta.name, meta.namespace)
                    obj.spec = old.spec
                except NotFound:
                    pass
        for admit in self._mutating:
            admit(resource, op, obj)
        for admit in self._validating:
            admit(resource, op, obj)
        expected = int(meta.resource_version) if meta.resource_version else None
        body = serde.to_dict(obj)
        try:
            rev = self.store.update(key, body, expected_mod_revision=expected)
        except kv.KeyNotFound as e:
            raise NotFound(str(e))
        except kv.Conflict as e:
            raise Conflict(str(e))
        updated = self._stamp(info, body, rev)
        for hook in self._post_write:
            hook(resource, op, updated)
        return updated

    def delete(self, resource: str, name: str, namespace: str = "",
               propagation_policy: Optional[str] = None, fence=None) -> None:
        """Delete, honoring finalizers: an object with a non-empty
        metadata.finalizers list is soft-deleted (deletionTimestamp stamped,
        object kept) until the last finalizer is removed by its controller —
        the reference's graceful-deletion/finalization flow
        (apiserver/pkg/registry/generic/registry/store.go Delete →
        deletionTimestamp + finalizer wait).

        propagation_policy: None/"Background" (default), "Foreground"
        (block on dependents: the GC deletes blocking dependents first),
        or "Orphan" (the GC strips ownerReferences from dependents)."""
        info = self._info(resource)
        key = self._key(info, namespace, name)
        fence_check = self._fence_precondition(fence, "delete")
        # DELETE admission (validating webhooks guard deletions in the
        # reference dispatcher); the current object is what hooks see
        try:
            current = self.get(resource, name, namespace)
        except NotFound:
            current = None
        if current is not None:
            for admit in self._mutating:
                admit(resource, "DELETE", current)
            for admit in self._validating:
                admit(resource, "DELETE", current)
        # propagationPolicy (DeleteOptions): Foreground/Orphan stamp the
        # matching GC finalizer so the garbage collector finishes the
        # delete only after dependents are deleted / orphaned
        # (apimachinery DeletionPropagation; registry/store.go
        # deletionFinalizersForGarbageCollection)
        gc_finalizer = {
            "Foreground": FINALIZER_FOREGROUND,
            "Orphan": FINALIZER_ORPHAN,
        }.get(propagation_policy or "")
        if gc_finalizer is not None:
            def add_fin(body):
                nb = dict(body)
                meta = dict(nb.get("metadata", {}))
                fins = list(meta.get("finalizers", []))
                if gc_finalizer not in fins:
                    meta["finalizers"] = fins + [gc_finalizer]
                nb["metadata"] = meta
                return nb

            try:
                self.store.guaranteed_update(key, add_fin,
                                             precondition=fence_check)
            except kv.KeyNotFound as e:
                raise NotFound(str(e))
        # The finalizer check and the write are guarded by the same
        # mod_revision so a concurrent add/remove of the last finalizer
        # can't strand a soft-deleted object or bypass finalization
        # (store.go Delete's conditional txn).
        for _ in range(16):
            try:
                kvv = self.store.get(key)
            except kv.KeyNotFound as e:
                raise NotFound(str(e))
            body = kvv.value
            try:
                if body.get("metadata", {}).get("finalizers"):
                    if body.get("metadata", {}).get("deletionTimestamp") is not None:
                        return  # already soft-deleted; rewriting would just
                        # bump the revision and storm the watchers
                    nb = dict(body)
                    meta = dict(nb.get("metadata", {}))
                    meta["deletionTimestamp"] = time.time()
                    nb["metadata"] = meta
                    self.store.update(key, nb,
                                      expected_mod_revision=kvv.mod_revision,
                                      precondition=fence_check)
                else:
                    del_rev = self.store.delete(
                        key, expected_mod_revision=kvv.mod_revision,
                        precondition=fence_check
                    )
                    deleted = self._stamp(info, body, del_rev)
                    for hook in self._post_write:
                        hook(resource, "DELETE", deleted)
                return
            except kv.Conflict:
                continue
            except kv.KeyNotFound as e:
                raise NotFound(str(e))
        raise Conflict(f"{key}: too many conflicts in delete")

    def remove_finalizer(self, resource: str, name: str, namespace: str, finalizer: str) -> None:
        """Drop one finalizer; if the object is soft-deleted and none remain,
        complete the deletion (the finalization endpoint's behavior)."""
        info = self._info(resource)
        key = self._key(info, namespace, name)
        done = {}

        def apply(body):
            nb = dict(body)
            meta = dict(nb.get("metadata", {}))
            fins = [f for f in meta.get("finalizers", []) if f != finalizer]
            if fins:
                meta["finalizers"] = fins
            else:
                meta.pop("finalizers", None)
            nb["metadata"] = meta
            done["delete"] = not fins and meta.get("deletionTimestamp") is not None
            done["body"] = nb
            return nb

        try:
            rev = self.store.guaranteed_update(key, apply)
            # guarded completion: if another writer (e.g. adding a new
            # finalizer) raced in after the removal, re-check before deleting
            while done.get("delete"):
                try:
                    del_rev = self.store.delete(key, expected_mod_revision=rev)
                    deleted = self._stamp(info, done["body"], del_rev)
                    for hook in self._post_write:
                        hook(resource, "DELETE", deleted)
                    break
                except kv.Conflict:
                    kvv = self.store.get(key)
                    meta = kvv.value.get("metadata", {})
                    if meta.get("finalizers") or meta.get("deletionTimestamp") is None:
                        break  # no longer eligible for hard delete
                    rev = kvv.mod_revision
        except kv.KeyNotFound:
            pass

    def resources(self) -> Tuple[ResourceInfo, ...]:
        """Registered resource infos (discovery — the namespace controller
        and GC enumerate these the way the reference uses the discovery
        client + metadata informers)."""
        return tuple(self._resources.values())

    def list(
        self,
        resource: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Selector] = None,
    ) -> Tuple[List[Any], int]:
        info = self._info(resource)
        kvs, rev = self.store.list(self._prefix(info, namespace))
        items = []
        for kvv in kvs:
            obj = self._stamp(info, kvv.value, kvv.mod_revision)
            if label_selector is not None and not label_selector.matches(
                obj.metadata.labels
            ):
                continue
            items.append(obj)
        return items, rev

    def watch(
        self,
        resource: str,
        namespace: Optional[str] = None,
        since_revision: Optional[int] = None,
    ) -> TypedWatch:
        info = self._info(resource)
        raw = self.store.watch(self._prefix(info, namespace), since_revision)
        return TypedWatch(raw, info.type)

    # -- fencing -----------------------------------------------------------

    def _fence_precondition(self, fence, op: str):
        """Store-level precondition for a fenced write: the stored leader
        lease must still show the token's holder at the token's
        leaseTransitions epoch (the monotonic fencing number — adoption
        bumps it, so a deposed leader's token can never validate again).
        Runs atomically with the commit under the store lock; the check is
        deliberately clock-free — expiry is the elector's own job (it
        self-fences a margin BEFORE the lease runs out), the server only
        compares epochs. `fence` is duck-typed (lock_name, lock_namespace,
        holder_identity, transitions) so the storage layer never imports
        the client."""
        if fence is None:
            return None
        lease_key = self._key(
            self._info("leases"), fence.lock_namespace, fence.lock_name
        )

        def check():
            try:
                spec = self.store.get(lease_key).value.get("spec", {})
            except kv.KeyNotFound:
                spec = {}
            if (
                spec.get("holderIdentity", "") != fence.holder_identity
                or spec.get("leaseTransitions", 0) != fence.transitions
            ):
                from ..scheduler import metrics

                metrics.fencing_rejections.inc(op=op)
                raise FenceExpired(
                    f"{op}: fencing token for {fence.holder_identity!r} "
                    f"(epoch {fence.transitions}) is stale — lease "
                    f"{lease_key} now held by "
                    f"{spec.get('holderIdentity', '')!r} "
                    f"(epoch {spec.get('leaseTransitions', 0)})"
                )

        return check

    # -- subresources ------------------------------------------------------

    def bind_pod(self, namespace: str, pod_name: str, node_name: str,
                 fence=None) -> None:
        """pods/{name}/binding: set spec.nodeName exactly once (reference:
        pkg/registry/core/pod/storage/storage.go BindingREST.Create —
        'pod X is already assigned to node Y' conflict)."""
        info = self._info("pods")
        key = self._key(info, namespace, pod_name)

        def apply(body):
            current = body.get("spec", {}).get("nodeName", "")
            if current and current != node_name:
                raise Conflict(
                    f"pod {namespace}/{pod_name} is already assigned to node {current}"
                )
            new_body = dict(body)
            new_body["spec"] = dict(body.get("spec", {}))
            new_body["spec"]["nodeName"] = node_name
            return new_body

        try:
            self.store.guaranteed_update(
                key, apply, precondition=self._fence_precondition(fence, "bind")
            )
        except kv.KeyNotFound as e:
            raise NotFound(str(e))

    def bind_pods(
        self, bindings: List[Tuple[str, str, str]], fence=None
    ) -> List[Optional[APIError]]:
        """Bulk binding application: N pods/{name}/binding writes in one
        call, per-binding outcomes (None = bound). Semantically identical
        to N bind_pod calls; exists because the scheduler's batched cycle
        lands thousands of bindings at once and the per-call overhead
        (lock churn, method dispatch) was measurable in the full-loop
        profile. The reference amortizes the same cost with 8 parallel
        binder goroutines (pkg/scheduler/scheduler.go:540) — under a GIL,
        batching is the equivalent lever."""
        results: List[Optional[APIError]] = []
        for namespace, pod_name, node_name in bindings:
            try:
                self.bind_pod(namespace, pod_name, node_name, fence=fence)
                results.append(None)
            except APIError as e:
                results.append(e)
        return results

    def update_status(self, resource: str, obj: Any, fence=None) -> Any:
        """status subresource: replaces only .status (handlers for
        pods/status, nodes/status)."""
        info = self._info(resource)
        meta = obj.metadata
        key = self._key(info, meta.namespace, meta.name)
        # admission runs for status subresource writes too (the reference
        # builds admission.Attributes with subresource="status"; e.g.
        # NodeRestriction must gate kubelet status updates)
        for admit in self._mutating:
            admit(resource, "UPDATE", obj)
        for admit in self._validating:
            admit(resource, "UPDATE", obj)
        status_body = serde.to_dict(obj).get("status", {})
        final = {}

        def apply(body):
            new_body = dict(body)
            new_body["status"] = status_body
            final.clear()
            final.update(new_body)
            return new_body

        try:
            rev = self.store.guaranteed_update(
                key, apply,
                precondition=self._fence_precondition(fence, "update_status"),
            )
        except kv.KeyNotFound as e:
            raise NotFound(str(e))
        return self._stamp(info, final, rev)

    # -- helpers -----------------------------------------------------------

    def _stamp(self, info: ResourceInfo, body: Dict, rev: int) -> Any:
        obj = serde.from_dict(info.type, body)
        obj.metadata.resource_version = str(rev)
        return obj
