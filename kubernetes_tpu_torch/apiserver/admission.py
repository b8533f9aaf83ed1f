"""In-tree admission plugins.

Reference: plugin/pkg/admission/* wired through the apiserver's
mutate-then-validate chain (staging/src/k8s.io/apiserver/pkg/admission).
Implemented set (the ones the control plane's own behavior depends on):

  * NamespaceLifecycle  — reject creates in missing/terminating namespaces
    (namespace/lifecycle/admission.go)
  * LimitRanger         — apply container default requests/limits, enforce
    min/max (limitranger/admission.go)
  * Priority            — resolve priorityClassName -> spec.priority
    (priority/admission.go)
  * DefaultTolerationSeconds — add 300s not-ready/unreachable NoExecute
    tolerations (defaulttolerationseconds/admission.go)
  * ResourceQuota       — enforce namespace quotas on pod creation
    (resourcequota/admission.go; usage recalculated by the quota
    controller, controllers/resourcequota.py)

Each plugin is a callable (resource, operation, obj) -> None that mutates
in place (mutating chain) or raises Invalid (validating chain).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api import types as v1
from ..api.quantity import Quantity, parse_quantity
from ..utils import serde
from .server import APIServer, Invalid, NotFound

DEFAULT_TOLERATION_SECONDS = 300  # defaulttolerationseconds/admission.go:38


def _quantities_equal(a: dict, b: dict) -> bool:
    """Semantic quantity equality: {"cpu": "1"} == {"cpu": "1000m"}."""
    if set(a) != set(b):
        return False
    try:
        return all(parse_quantity(a[k]) == parse_quantity(b[k]) for k in a)
    except (ValueError, ArithmeticError, TypeError, AttributeError):
        # unparseable values (None, lists, ...) fall back to the strict
        # comparison the reference's conflict check would fail anyway
        return a == b


def namespace_lifecycle(api: APIServer):
    """Reject writes into nonexistent or terminating namespaces."""

    exempt = {"default", "kube-system", "kube-public", "kube-node-lease"}

    def admit(resource: str, op: str, obj) -> None:
        if resource == "namespaces" or op != "CREATE":
            return
        info = api._info(resource)
        if not info.namespaced:
            return
        ns = obj.metadata.namespace
        if not ns:
            return
        try:
            namespace = api.get("namespaces", ns)
        except NotFound:
            if ns in exempt:
                return  # system namespaces exist implicitly here
            raise Invalid(f"namespace {ns!r} not found")
        if namespace.metadata.deletion_timestamp is not None:
            raise Invalid(f"namespace {ns!r} is terminating")

    return admit


def limit_ranger(api: APIServer):
    """Defaults + min/max enforcement from LimitRange objects."""

    def admit(resource: str, op: str, obj) -> None:
        if resource != "pods" or op != "CREATE":
            return
        try:
            limits, _ = api.list("limitranges", obj.metadata.namespace)
        except NotFound:
            return
        items = [it for lr in limits for it in (lr.spec.limits or [])]
        if not items:
            return
        for container in obj.spec.containers or []:
            res = container.resources or v1.ResourceRequirements()
            requests = dict(res.requests or {})
            clims = dict(res.limits or {})
            for item in items:
                if item.type != "Container":
                    continue
                for k, qty in (item.default_request or {}).items():
                    requests.setdefault(k, qty)
                for k, qty in (item.default or {}).items():
                    clims.setdefault(k, qty)
                for k, qty in (item.min or {}).items():
                    if k in requests and parse_quantity(requests[k]) < parse_quantity(qty):
                        raise Invalid(
                            f"minimum {k} usage per Container is {qty}"
                        )
                for k, qty in (item.max or {}).items():
                    if k in requests and parse_quantity(requests[k]) > parse_quantity(qty):
                        raise Invalid(
                            f"maximum {k} usage per Container is {qty}"
                        )
            container.resources = v1.ResourceRequirements(
                requests=requests or None, limits=clims or None
            )

    return admit


def priority_admission(api: APIServer):
    """Resolve spec.priorityClassName to spec.priority
    (plugin/pkg/admission/priority/admission.go:131)."""

    def admit(resource: str, op: str, obj) -> None:
        if resource != "pods" or op != "CREATE":
            return
        name = obj.spec.priority_class_name
        if not name:
            return
        try:
            pc = api.get("priorityclasses", name)
        except NotFound:
            raise Invalid(f"no PriorityClass with name {name!r} was found")
        obj.spec.priority = pc.value

    return admit


def default_toleration_seconds(api: APIServer):
    """Append 300s NoExecute tolerations for not-ready/unreachable unless
    the pod already tolerates them."""

    def admit(resource: str, op: str, obj) -> None:
        if resource != "pods" or op != "CREATE":
            return
        tolerations = list(obj.spec.tolerations or [])
        for key in (v1.TAINT_NODE_NOT_READY, v1.TAINT_NODE_UNREACHABLE):
            if any(
                t.key in (key, None, "") and t.effect in ("NoExecute", "", None)
                for t in tolerations
            ):
                continue
            tolerations.append(
                v1.Toleration(
                    key=key,
                    operator="Exists",
                    effect="NoExecute",
                    toleration_seconds=DEFAULT_TOLERATION_SECONDS,
                )
            )
        obj.spec.tolerations = tolerations

    return admit


def pod_compute_usage(pod: v1.Pod) -> Dict[str, int]:
    """Pod's chargeable quota usage: requests.cpu (milli), requests.memory
    (bytes), pods (count). Terminal pods don't count
    (resourcequota/evaluator/core/pods.go)."""
    if pod.status.phase in ("Succeeded", "Failed"):
        return {}
    cpu = 0
    mem = 0
    for c in pod.spec.containers or []:
        req = (c.resources.requests or {}) if c.resources else {}
        cpu += Quantity(req.get("cpu", 0)).milli_value()
        mem += Quantity(req.get("memory", 0)).value()
    return {"requests.cpu": cpu, "requests.memory": mem, "pods": 1}


_QUOTA_COUNTED = {
    "services": "services",
    "configmaps": "configmaps",
    "persistentvolumeclaims": "persistentvolumeclaims",
    "replicationcontrollers": "replicationcontrollers",
}


def _hard_to_units(hard: Dict[str, str]) -> Dict[str, int]:
    out = {}
    for k, qty in (hard or {}).items():
        key = {"cpu": "requests.cpu", "memory": "requests.memory"}.get(k, k)
        if key == "requests.cpu":
            out[key] = Quantity(qty).milli_value()
        elif key == "requests.memory":
            out[key] = Quantity(qty).value()
        else:
            out[key] = Quantity(qty).value()
    return out


def resource_quota(api: APIServer):
    """Enforce hard limits at pod/object creation against current usage.

    The reference admission checks the evaluator's usage against
    status.hard with a live recompute on conflict; here usage comes from
    the same store the controller recalculates into status.used."""

    def current_usage(namespace: str) -> Dict[str, int]:
        used: Dict[str, int] = {}
        pods, _ = api.list("pods", namespace)
        for pod in pods:
            for k, amt in pod_compute_usage(pod).items():
                used[k] = used.get(k, 0) + amt
        for resource, key in _QUOTA_COUNTED.items():
            items, _ = api.list(resource, namespace)
            used[key] = len(items)
        return used

    def admit(resource: str, op: str, obj) -> None:
        if op != "CREATE":
            return
        chargeable = resource == "pods" or resource in _QUOTA_COUNTED
        if not chargeable:
            return
        ns = obj.metadata.namespace
        if not ns:
            return
        quotas, _ = api.list("resourcequotas", ns)
        if not quotas:
            return
        used = current_usage(ns)
        if resource == "pods":
            delta = pod_compute_usage(obj)
        else:
            delta = {_QUOTA_COUNTED[resource]: 1}
        for quota in quotas:
            hard = _hard_to_units(quota.spec.hard or {})
            for key, limit in hard.items():
                want = used.get(key, 0) + delta.get(key, 0)
                if want > limit:
                    raise Invalid(
                        f"exceeded quota: {quota.metadata.name}, "
                        f"requested: {key}={delta.get(key, 0)}, "
                        f"used: {key}={used.get(key, 0)}, "
                        f"limited: {key}={limit}"
                    )

    admit.atomic = True  # runs under the server write lock (CAS analog)
    return admit


def service_account_admission(api: APIServer):
    """ServiceAccount admission (plugin/pkg/admission/serviceaccount/
    admission.go) — the load-bearing plugin that injects tokens:
      * default spec.serviceAccountName to "default" (:228);
      * reject pods referencing a ServiceAccount that doesn't exist
        (:241 — the SA controller creates "default" per namespace);
      * mount the SA's token secret as a pod volume unless automount is
        disabled (:263 mountServiceAccountToken)."""

    import time as _time

    # (ns, sa) -> (secret name, stamp): pod creates are the apiserver's
    # hottest write; a full secrets list per create would be O(secrets)
    # serde work. Bounded staleness (like the reference's informer lag);
    # "" entries (no token yet) also cache so bursts don't re-list.
    token_cache: Dict[Tuple[str, str], Tuple[str, float]] = {}
    TOKEN_CACHE_TTL = 10.0

    def find_token_secret(ns: str, sa_name: str) -> str:
        hit = token_cache.get((ns, sa_name))
        now = _time.monotonic()
        if hit is not None and now - hit[1] < TOKEN_CACHE_TTL:
            return hit[0]
        token_secret = ""
        try:
            secrets, _ = api.list("secrets", ns)
        except NotFound:
            secrets = []
        for s in secrets:
            if (
                s.type == v1.SECRET_TYPE_SERVICE_ACCOUNT_TOKEN
                and (s.metadata.annotations or {}).get(
                    v1.SERVICE_ACCOUNT_NAME_ANNOTATION) == sa_name
            ):
                token_secret = s.metadata.name
                break
        token_cache[(ns, sa_name)] = (token_secret, now)
        return token_secret

    def admit(resource: str, op: str, obj) -> None:
        if resource != "pods" or op != "CREATE":
            return
        if not obj.spec.service_account_name:
            obj.spec.service_account_name = "default"
        sa_name = obj.spec.service_account_name
        ns = obj.metadata.namespace
        try:
            api.get("serviceaccounts", sa_name, ns)
        except NotFound:
            # the reference retries while the SA controller catches up;
            # here "default" is implicit (admission must not deadlock
            # bootstrap), any other missing SA is rejected
            if sa_name != "default":
                raise Invalid(
                    f'service account {ns}/{sa_name} was not found'
                )
        if obj.spec.automount_service_account_token is False:
            return
        if any(
            (vol.source or {}).get("secret", {}).get("secretName", "")
            .startswith(f"{sa_name}-token-")
            for vol in obj.spec.volumes or []
        ):
            return
        token_secret = find_token_secret(ns, sa_name)
        if not token_secret:
            return  # no token yet: the kubelet remounts on restart
        volumes = list(obj.spec.volumes or [])
        volumes.append(v1.Volume(
            name=f"{sa_name}-token",
            source={"secret": {"secretName": token_secret}},
        ))
        obj.spec.volumes = volumes

    return admit


def node_restriction(api: APIServer):
    """NodeRestriction (plugin/pkg/admission/noderestriction/admission.go):
    a kubelet identity (user system:node:<name> in group system:nodes) may
    only write objects tied to ITS node — its own Node object/status, its
    own node-lease, and pods bound to it. Identity comes from the
    request-context thread-local (requestcontext.py)."""

    from .requestcontext import current_user

    def node_of(user) -> str:
        if user is None or "system:nodes" not in (user.groups or ()):
            return ""
        if not user.name.startswith("system:node:"):
            return ""
        return user.name[len("system:node:"):]

    def admit(resource: str, op: str, obj) -> None:
        node_name = node_of(current_user())
        if not node_name:
            return
        if resource == "nodes":
            if obj.metadata.name != node_name:
                raise Invalid(
                    f"node {node_name!r} is not allowed to modify node "
                    f"{obj.metadata.name!r}"
                )
            return
        if resource == "leases":
            if obj.metadata.name != node_name:
                raise Invalid(
                    f"node {node_name!r} can only touch its own lease"
                )
            return
        if resource == "pods":
            bound = obj.spec.node_name
            if bound != node_name:
                raise Invalid(
                    f"node {node_name!r} can only modify pods with "
                    f"spec.nodeName set to itself"
                )
            return
        if op in ("CREATE", "UPDATE", "DELETE") and resource in (
            "events",
        ):
            return  # kubelets report events freely (rate-limited separately)
        raise Invalid(
            f"node {node_name!r} may not modify resource {resource!r}"
        )

    return admit


def event_rate_limit(api: APIServer, qps: float = 50.0, burst: int = 100):
    """EventRateLimit (plugin/pkg/admission/eventratelimit/admission.go):
    token-bucket Event creates per namespace (the Namespace limit type —
    a hot loop spamming events must not drown the store)."""

    import threading
    import time

    buckets: Dict[str, Tuple[float, float]] = {}  # ns -> (tokens, stamp)
    lock = threading.Lock()

    def admit(resource: str, op: str, obj) -> None:
        if resource != "events" or op != "CREATE":
            return
        ns = obj.metadata.namespace or "default"
        now = time.monotonic()
        with lock:
            tokens, stamp = buckets.get(ns, (float(burst), now))
            tokens = min(float(burst), tokens + (now - stamp) * qps)
            if tokens < 1.0:
                buckets[ns] = (tokens, now)
                raise Invalid(
                    f"event creation rate in namespace {ns!r} exceeds "
                    f"{qps}/s (limit type: Namespace)"
                )
            buckets[ns] = (tokens - 1.0, now)

    return admit


DEFAULT_STORAGE_CLASS_ANNOTATION = "storageclass.kubernetes.io/is-default-class"
# single source of truth: the finalizer this plugin stamps is exactly the
# one the protection controllers release
from ..controllers.volumeprotection import (  # noqa: E402
    PVC_PROTECTION_FINALIZER,
    PV_PROTECTION_FINALIZER,
)

POD_SECURITY_ENFORCE_LABEL = "pod-security.kubernetes.io/enforce"


def default_storage_class(api: APIServer):
    """DefaultStorageClass (plugin/pkg/admission/storage/storageclass/
    setdefault/admission.go): a PVC created without storageClassName gets
    the cluster's default class (the is-default-class annotation)."""

    def admit(resource: str, op: str, obj) -> None:
        if resource != "persistentvolumeclaims" or op != "CREATE":
            return
        # nil-only check (admission.go:87): storageClassName="" is the
        # documented opt-out that pins the claim to classless static PVs
        if obj.spec.storage_class_name is not None:
            return
        try:
            classes, _ = api.list("storageclasses")
        except NotFound:
            return
        defaults = [
            sc for sc in classes
            if (sc.metadata.annotations or {}).get(
                DEFAULT_STORAGE_CLASS_ANNOTATION) == "true"
        ]
        if not defaults:
            return
        if len(defaults) > 1:
            # admission.go:108: more than one default is a config error
            raise Invalid(
                f"{len(defaults)} default StorageClasses were found"
            )
        obj.spec.storage_class_name = defaults[0].metadata.name

    return admit


def storage_object_in_use_protection(api: APIServer):
    """StorageObjectInUseProtection (plugin/pkg/admission/storage/
    storageobjectinuse/admission.go): stamp the protection finalizers at
    CREATE so the pvc/pv-protection controllers
    (controllers/volumeprotection.py) can hold deletion while in use."""

    def admit(resource: str, op: str, obj) -> None:
        if op != "CREATE":
            return
        fin = {
            "persistentvolumeclaims": PVC_PROTECTION_FINALIZER,
            "persistentvolumes": PV_PROTECTION_FINALIZER,
        }.get(resource)
        if fin is None:
            return
        fins = list(obj.metadata.finalizers or [])
        if fin not in fins:
            obj.metadata.finalizers = fins + [fin]

    return admit


def always_pull_images(api: APIServer):
    """AlwaysPullImages (plugin/pkg/admission/alwayspullimages/
    admission.go): force imagePullPolicy=Always on every container so a
    pod can never reuse another tenant's locally-cached private image."""

    def admit(resource: str, op: str, obj) -> None:
        if resource != "pods" or op not in ("CREATE", "UPDATE"):
            return
        for c in list(obj.spec.init_containers or []) + list(
                obj.spec.containers or []):
            c.image_pull_policy = "Always"

    return admit


def limit_pod_hard_anti_affinity_topology(api: APIServer):
    """LimitPodHardAntiAffinityTopology (plugin/pkg/admission/antiaffinity/
    admission.go): required anti-affinity terms may only use the hostname
    topology key (cluster-wide anti-affinity at zone/region scale is a
    scheduling-capacity foot-gun)."""

    def admit(resource: str, op: str, obj) -> None:
        if resource != "pods" or op != "CREATE":
            return
        aff = obj.spec.affinity
        anti = aff.pod_anti_affinity if aff else None
        for term in (
            anti.required_during_scheduling_ignored_during_execution
            if anti else None
        ) or []:
            if term.topology_key != v1.LABEL_HOSTNAME:
                raise Invalid(
                    "affinity.podAntiAffinity."
                    "requiredDuringSchedulingIgnoredDuringExecution: "
                    f"topologyKey {term.topology_key!r} is not allowed "
                    f"(only {v1.LABEL_HOSTNAME})"
                )

    return admit


def pod_security(api: APIServer):
    """PodSecurity-lite: enforce the baseline/restricted profiles on
    namespaces labeled pod-security.kubernetes.io/enforce (the PSP
    successor, policy/pod-security-admission). Baseline rejects
    privileged containers, host namespaces and hostPath volumes;
    restricted additionally requires runAsNonRoot and disallows
    privilege escalation."""

    def violations(pod: v1.Pod, level: str) -> List[str]:
        out = []
        if pod.spec.host_network:
            out.append("hostNetwork=true")
        if pod.spec.host_pid:
            out.append("hostPID=true")
        if pod.spec.host_ipc:
            out.append("hostIPC=true")
        for vol in pod.spec.volumes or []:
            if (vol.source or {}).get("hostPath"):
                out.append(f"hostPath volume {vol.name!r}")
        for c in list(pod.spec.init_containers or []) + list(
                pod.spec.containers or []):
            sc = c.security_context or {}
            if sc.get("privileged"):
                out.append(f"privileged container {c.name!r}")
            if level == "restricted":
                if sc.get("runAsNonRoot") is not True:
                    out.append(
                        f"container {c.name!r} must set runAsNonRoot=true"
                    )
                if sc.get("allowPrivilegeEscalation") is not False:
                    out.append(
                        f"container {c.name!r} must set "
                        "allowPrivilegeEscalation=false"
                    )
        return out

    def admit(resource: str, op: str, obj) -> None:
        # CREATE only: the reference plugin exempts subresource writes,
        # and this build's update_status runs the validating chain with
        # op=UPDATE — enforcing there would freeze status reporting for
        # pre-existing pods the moment a namespace gets labeled
        if resource != "pods" or op != "CREATE":
            return
        ns = obj.metadata.namespace
        if not ns:
            return
        try:
            namespace = api.get("namespaces", ns)
        except NotFound:
            return
        level = (namespace.metadata.labels or {}).get(
            POD_SECURITY_ENFORCE_LABEL, "privileged")
        if level not in ("baseline", "restricted"):
            return
        found = violations(obj, level)
        if found:
            raise Invalid(
                f"pod violates PodSecurity \"{level}\": " + "; ".join(found)
            )

    return admit


def persistent_volume_claim_resize(api: APIServer):
    """PersistentVolumeClaimResize (plugin/pkg/admission/storage/
    persistentvolume/resize/admission.go): a PVC storage request may only
    GROW, and only when its StorageClass allows volume expansion."""
    from ..api.quantity import Quantity

    def admit(resource: str, op: str, obj) -> None:
        if resource != "persistentvolumeclaims" or op != "UPDATE":
            return
        try:
            old = api.get(
                "persistentvolumeclaims", obj.metadata.name,
                obj.metadata.namespace,
            )
        except NotFound:
            return
        new_req = (obj.spec.resources.requests or {}).get("storage") \
            if obj.spec.resources else None
        old_req = (old.spec.resources.requests or {}).get("storage") \
            if old.spec.resources else None
        if new_req is None or old_req is None:
            return
        new_q, old_q = Quantity(new_req).value(), Quantity(old_req).value()
        if new_q == old_q:
            return
        if new_q < old_q:
            raise Invalid(
                "persistent volume claims cannot be shrunk "
                f"({old_req} -> {new_req})"
            )
        # growth: the class must allow expansion (admission.go:119)
        cls_name = obj.spec.storage_class_name or old.spec.storage_class_name
        allow = False
        if cls_name:
            try:
                sc = api.get("storageclasses", cls_name)
                allow = bool(getattr(sc, "allow_volume_expansion", False))
            except NotFound:
                allow = False
        if not allow:
            raise Invalid(
                "only dynamically provisioned pvc can be resized and "
                "the storageclass that provisions the pvc must support resize"
            )

    return admit


def taint_nodes_by_condition(api: APIServer):
    """TaintNodesByCondition (plugin/pkg/admission/nodetaint/
    admission.go): every NEW node starts tainted
    node.kubernetes.io/not-ready:NoSchedule until its lifecycle
    controller observes a Ready condition and lifts it."""
    NOT_READY = "node.kubernetes.io/not-ready"

    def admit(resource: str, op: str, obj) -> None:
        if resource != "nodes" or op != "CREATE":
            return
        taints = list(obj.spec.taints or [])
        if any(t.key == NOT_READY and t.effect == "NoSchedule"
               for t in taints):
            return
        taints.append(v1.Taint(key=NOT_READY, effect="NoSchedule"))
        obj.spec.taints = taints

    return admit


def runtime_class_admission(api: APIServer):
    """RuntimeClass (plugin/pkg/admission/runtimeclass/admission.go):
    resolve spec.runtimeClassName at pod CREATE — the class must exist,
    its overhead is stamped onto the pod (conflicting user-set overhead
    rejected), and its scheduling constraints merge into the pod."""

    def admit(resource: str, op: str, obj) -> None:
        if resource != "pods" or op != "CREATE":
            return
        name = obj.spec.runtime_class_name
        if not name:
            return
        try:
            rc = api.get("runtimeclasses", name)
        except NotFound:
            raise Invalid(f"pod rejected: RuntimeClass {name!r} not found")
        if rc.overhead is not None and rc.overhead.pod_fixed:
            if obj.spec.overhead and not _quantities_equal(
                    obj.spec.overhead, rc.overhead.pod_fixed):
                raise Invalid(
                    "pod rejected: Pod's Overhead doesn't match "
                    f"RuntimeClass's defined Overhead ({rc.overhead.pod_fixed})"
                )
            obj.spec.overhead = dict(rc.overhead.pod_fixed)
        if rc.scheduling is not None:
            if rc.scheduling.node_selector:
                merged = dict(obj.spec.node_selector or {})
                for k, val in rc.scheduling.node_selector.items():
                    if k in merged and merged[k] != val:
                        raise Invalid(
                            "pod rejected: conflict with RuntimeClass "
                            f"nodeSelector key {k!r}"
                        )
                    merged[k] = val
                obj.spec.node_selector = merged
            if rc.scheduling.tolerations:
                obj.spec.tolerations = list(obj.spec.tolerations or []) + [
                    t if isinstance(t, v1.Toleration)
                    else serde.from_dict(v1.Toleration, t)
                    for t in rc.scheduling.tolerations
                ]

    return admit


def certificate_approval(api: APIServer):
    """CertificateApproval (plugin/pkg/admission/certificates/approval/
    admission.go:44): adding an Approved/Denied condition requires the
    requester to hold the `approve` verb on `signers` for the CSR's
    signerName (exact name or the <domain>/* wildcard)."""
    from ..api import certificates as certs
    from .requestcontext import current_user

    return _certificate_verb_gate(
        api, verb="approve",
        changed=lambda old, new: (
            _csr_condition_types(new) - _csr_condition_types(old)
        ) & {certs.APPROVED, certs.DENIED},
        current_user=current_user,
    )


def certificate_signing(api: APIServer):
    """CertificateSigning (plugin/pkg/admission/certificates/signing/
    admission.go): populating status.certificate requires the `sign`
    verb on the CSR's signer."""
    from .requestcontext import current_user

    def changed(old, new) -> bool:
        return bool(new.status.certificate) and (
            old is None or new.status.certificate != old.status.certificate
        )

    return _certificate_verb_gate(
        api, verb="sign", changed=changed, current_user=current_user,
    )


def _csr_condition_types(csr) -> set:
    if csr is None:
        return set()
    return {c.type for c in csr.status.conditions or []}


def _certificate_verb_gate(api: APIServer, verb: str, changed, current_user):
    def admit(resource: str, op: str, obj) -> None:
        if resource != "certificatesigningrequests" or op != "UPDATE":
            return
        authorizer = getattr(api, "authorizer", None)
        user = current_user()
        if authorizer is None or user is None:
            # no RBAC surface on this server (plain APIServer) — the
            # reference plugin equally requires an authorizer to act
            return
        try:
            old = api.get("certificatesigningrequests", obj.metadata.name)
        except NotFound:
            old = None
        if not changed(old, obj):
            return
        signer = obj.spec.signer_name
        domain = signer.split("/", 1)[0] + "/*" if "/" in signer else signer
        if authorizer.authorize(user, verb, "signers", "", signer) or \
                authorizer.authorize(user, verb, "signers", "", domain):
            return
        from .auth import Forbidden
        raise Forbidden(
            f"user not permitted to {verb} requests with signerName "
            f"{signer!r}"
        )

    return admit


def certificate_subject_restriction(api: APIServer):
    """CertificateSubjectRestriction (plugin/pkg/admission/certificates/
    subjectrestriction/admission.go): the kube-apiserver-client signer
    must never issue a certificate claiming system:masters."""
    import json as _json

    def admit(resource: str, op: str, obj) -> None:
        if resource != "certificatesigningrequests" or op != "CREATE":
            return
        if obj.spec.signer_name != "kubernetes.io/kube-apiserver-client":
            return
        try:
            req = _json.loads(obj.spec.request or "{}")
        except ValueError:
            req = None
        if not isinstance(req, dict):
            # fail CLOSED: an unparseable (or non-object) request must
            # not bypass the system:masters gate
            # (subjectrestriction/admission.go denies on parse failure)
            raise Invalid(
                "unable to parse CSR spec.request for signer "
                "kubernetes.io/kube-apiserver-client"
            )
        groups = req.get("groups") or req.get("organizations") or []
        if "system:masters" in groups:
            raise Invalid(
                "use of kubernetes.io/kube-apiserver-client signer with "
                "system:masters group is not allowed"
            )

    return admit


def default_ingress_class(api: APIServer):
    """DefaultIngressClass (plugin/pkg/admission/network/
    defaultingressclass/admission.go): an Ingress created without
    ingressClassName gets the cluster default; two defaults is a
    configuration error."""
    from ..api.networking import DEFAULT_INGRESS_CLASS_ANNOTATION

    def admit(resource: str, op: str, obj) -> None:
        if resource != "ingresses" or op != "CREATE":
            return
        if obj.spec.ingress_class_name is not None:
            return
        try:
            classes, _ = api.list("ingressclasses")
        except NotFound:
            return
        defaults = [
            c for c in classes
            if (c.metadata.annotations or {}).get(
                DEFAULT_INGRESS_CLASS_ANNOTATION) == "true"
        ]
        if not defaults:
            return
        if len(defaults) > 1:
            raise Invalid(
                f"{len(defaults)} default IngressClasses were found, "
                "only 1 allowed"
            )
        obj.spec.ingress_class_name = defaults[0].metadata.name

    return admit


def default_admission_chain(api: APIServer) -> Tuple[List, List]:
    """(mutating, validating) — reference default-enabled order
    (kubeapiserver/options/plugins.go:108-140, minus cloud/deprecated)."""
    mutating = [
        namespace_lifecycle(api),
        service_account_admission(api),
        taint_nodes_by_condition(api),
        priority_admission(api),
        runtime_class_admission(api),
        default_toleration_seconds(api),
        limit_ranger(api),
        default_storage_class(api),
        storage_object_in_use_protection(api),
        default_ingress_class(api),
    ]
    validating = [
        node_restriction(api),
        pod_security(api),
        event_rate_limit(api),
        persistent_volume_claim_resize(api),
        certificate_approval(api),
        certificate_signing(api),
        certificate_subject_restriction(api),
        resource_quota(api),
    ]
    return mutating, validating


def install_default_admission(api: APIServer) -> APIServer:
    mutating, validating = default_admission_chain(api)
    api._mutating.extend(mutating)
    api._validating.extend(validating)
    return api
