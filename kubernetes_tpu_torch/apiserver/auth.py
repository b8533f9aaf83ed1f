"""Authentication + RBAC authorization in front of the apiserver.

Reference: the apiserver handler chain runs WithAuthentication then
WithAuthorization before any handler (staging/src/k8s.io/apiserver/pkg/
server/config.go:719-745); authn resolves the request to a user.Info
(token authenticator: pkg/authentication/token), authz asks the RBAC
authorizer (plugin/pkg/auth/authorizer/rbac/rbac.go VisitRulesFor:
ClusterRoleBindings always apply, RoleBindings apply in their namespace;
system:masters bypasses).

In-proc equivalent: `SecureAPIServer` wraps an APIServer; `as_user(token)`
authenticates and returns a clientset-compatible facade whose every verb
is authorized first (Forbidden on deny — the 403 analog). RBAC objects
live in the store like any other resource, so kubectl can manage them.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..api import rbac
from .server import APIError, APIServer, ResourceInfo

GROUP_MASTERS = "system:masters"
GROUP_AUTHENTICATED = "system:authenticated"


class Unauthorized(APIError):
    """No/invalid credentials."""

    code = 401


class Forbidden(APIError):
    """Authenticated but not allowed."""

    code = 403


@dataclass(frozen=True)
class UserInfo:
    name: str
    groups: tuple = ()
    # the real authenticated identity when this user is impersonated
    # (WithImpersonation, apiserver/pkg/endpoints/filters/impersonation.go)
    impersonated_by: str = ""


class TokenAuthenticator:
    """Static token table (the token-auth-file authenticator)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tokens: Dict[str, UserInfo] = {}

    def add_token(self, token: str, user: str, groups: Optional[List[str]] = None) -> None:
        with self._lock:
            self._tokens[token] = UserInfo(
                user, tuple(groups or ()) + (GROUP_AUTHENTICATED,)
            )

    def authenticate(self, token: str) -> UserInfo:
        with self._lock:
            user = self._tokens.get(token)
        if user is None:
            raise Unauthorized("invalid bearer token")
        return user


class RBACAuthorizer:
    """RBAC evaluation over the stored Role/Binding objects."""

    def __init__(self, api: APIServer):
        self.api = api

    def _subject_matches(self, s: rbac.Subject, user: UserInfo, namespace: str) -> bool:
        if s.kind == "User":
            return s.name == user.name
        if s.kind == "Group":
            return s.name in user.groups
        if s.kind == "ServiceAccount":
            return user.name == f"system:serviceaccount:{s.namespace}:{s.name}"
        return False

    def _rules_for(self, ref: rbac.RoleRef, binding_ns: str) -> List[rbac.PolicyRule]:
        try:
            if ref.kind == "ClusterRole":
                role = self.api.get("clusterroles", ref.name)
            else:
                role = self.api.get("roles", ref.name, binding_ns)
        except APIError:
            return []
        return role.rules or []

    def _api_group(self, resource: str) -> str:
        """Resource's API group, derived from the registered type's
        apiVersion ("apps/v1" -> "apps", "v1" -> core "")."""
        try:
            info = self.api._info(resource)
            api_version = info.type().api_version
        except Exception:  # noqa: BLE001 — unknown resource: core group
            return ""
        return api_version.split("/", 1)[0] if "/" in api_version else ""

    def authorize(
        self, user: UserInfo, verb: str, resource: str, namespace: str, name: str = ""
    ) -> bool:
        """VisitRulesFor: cluster bindings grant everywhere; role bindings
        grant inside their own namespace only."""
        if GROUP_MASTERS in user.groups:
            return True
        group = self._api_group(resource)
        try:
            crbs, _ = self.api.list("clusterrolebindings")
        except APIError:
            crbs = []
        for b in crbs:
            if any(self._subject_matches(s, user, "") for s in b.subjects or []):
                for rule in self._rules_for(b.role_ref, ""):
                    if rbac.rule_matches(rule, verb, resource, name, group):
                        return True
        if namespace:
            try:
                rbs, _ = self.api.list("rolebindings", namespace)
            except APIError:
                rbs = []
            for b in rbs:
                if any(
                    self._subject_matches(s, user, namespace)
                    for s in b.subjects or []
                ):
                    for rule in self._rules_for(b.role_ref, namespace):
                        if rbac.rule_matches(rule, verb, resource, name, group):
                            return True
        return False


RBAC_RESOURCES = (
    ResourceInfo("roles", rbac.Role, True),
    ResourceInfo("clusterroles", rbac.ClusterRole, False),
    ResourceInfo("rolebindings", rbac.RoleBinding, True),
    ResourceInfo("clusterrolebindings", rbac.ClusterRoleBinding, False),
    ResourceInfo("serviceaccounts", rbac.ServiceAccount, True),
)


def _with_audit(logger, user: UserInfo, verb: str, resource: str,
                namespace: str, name: str, inner, body=None):
    """WithAudit (config.go:737): RequestReceived before dispatch,
    ResponseComplete with the real status code after — wrapping flow
    control and authorization so 429s and 403s are in the trail."""
    if logger is None:
        return inner()
    from . import audit as audit_pkg
    from ..utils import serde

    rule = logger.policy.level_for(user.name, verb, resource, namespace)
    if not audit_pkg.record_levels(rule.level):
        return inner()
    audit_id = logger.new_audit_id()

    def event(stage, code, response_object=None):
        return audit_pkg.Event(
            audit_id=audit_id,
            stage=stage,
            level=rule.level,
            user=user.name,
            groups=list(user.groups),
            verb=verb,
            resource=resource,
            namespace=namespace,
            name=name,
            impersonated_by=user.impersonated_by,
            response_code=code,
            request_object=(
                serde.to_dict(body)
                if body is not None and audit_pkg.includes_request(rule.level)
                else None
            ),
            response_object=response_object,
        )

    if audit_pkg.STAGE_REQUEST_RECEIVED not in rule.omit_stages:
        logger.emit(event(audit_pkg.STAGE_REQUEST_RECEIVED, 0))
    omit_complete = audit_pkg.STAGE_RESPONSE_COMPLETE in rule.omit_stages
    try:
        out = inner()
    except APIError as e:
        if not omit_complete:
            logger.emit(
                event(audit_pkg.STAGE_RESPONSE_COMPLETE, getattr(e, "code", 500))
            )
        raise
    except BaseException:
        # unexpected failure: the Panic-stage event (audit/types.go
        # StagePanic) — without it the trail under-reports exactly the
        # requests that blew up
        if audit_pkg.STAGE_PANIC not in rule.omit_stages:
            logger.emit(event(audit_pkg.STAGE_PANIC, 500))
        raise
    if omit_complete:
        return out
    resp = None
    if audit_pkg.includes_response(rule.level) and out is not None:
        try:
            resp = serde.to_dict(out)
        except Exception:  # noqa: BLE001 — lists/streams: metadata only
            resp = None
    logger.emit(event(audit_pkg.STAGE_RESPONSE_COMPLETE, 200, resp))
    return out


class _AuthorizedResourceClient:
    """clientset-compatible per-resource facade: the secured chain in the
    reference's handler order — authn happened at as_user; each verb then
    runs audit, APF (seat held for the call), and RBAC authorization."""

    def __init__(self, secure: "SecureAPIServer", user: UserInfo, resource: str):
        self._s = secure
        self._user = user
        self._resource = resource

    def _check(self, verb: str, namespace: str = "", name: str = "") -> None:
        if not self._s.authorizer.authorize(
            self._user, verb, self._resource, namespace, name
        ):
            raise Forbidden(
                f'user "{self._user.name}" cannot {verb} resource '
                f'"{self._resource}"'
                + (f' in namespace "{namespace}"' if namespace else "")
            )

    def _gated(self, verb: str, namespace: str, name: str, fn, body=None):
        """The secured chain for one verb, in the reference's handler
        order (config.go:719-745): audit OUTSIDE flow control OUTSIDE
        authorization — so APF 429s and authz 403s are both recorded."""

        def inner():
            from .requestcontext import request_user

            fc = self._s.flow_controller
            if fc is None:
                self._check(verb, namespace, name)
                with request_user(self._user):
                    return fn()
            from .flowcontrol import RequestInfo

            req = RequestInfo(
                user=self._user.name,
                groups=self._user.groups,
                verb=verb,
                resource=self._resource,
            )
            with fc.dispatch(req):
                self._check(verb, namespace, name)
                with request_user(self._user):
                    return fn()

        return _with_audit(
            self._s.audit, self._user, verb, self._resource,
            namespace, name, inner, body,
        )

    def create(self, obj):
        return self._gated(
            "create", obj.metadata.namespace, "",
            lambda: self._s.api.create(self._resource, obj), body=obj,
        )

    def get(self, name: str, namespace: str = ""):
        return self._gated(
            "get", namespace, name,
            lambda: self._s.api.get(self._resource, name, namespace),
        )

    def update(self, obj):
        return self._gated(
            "update", obj.metadata.namespace, obj.metadata.name,
            lambda: self._s.api.update(self._resource, obj), body=obj,
        )

    def update_status(self, obj):
        return self._gated(
            "update", obj.metadata.namespace, obj.metadata.name,
            lambda: self._s.api.update_status(self._resource, obj), body=obj,
        )

    def delete(self, name: str, namespace: str = "",
               propagation_policy: Optional[str] = None):
        return self._gated(
            "delete", namespace, name,
            lambda: self._s.api.delete(
                self._resource, name, namespace,
                propagation_policy=propagation_policy,
            ),
        )

    def list(self, namespace=None, label_selector=None):
        return self._gated(
            "list", namespace or "", "",
            lambda: self._s.api.list(self._resource, namespace, label_selector),
        )

    def watch(self, namespace=None, since_revision=None):
        # watches are long-lived: audit + classify + authorize the SETUP
        # only — the seat is released before the stream is returned (the
        # reference accounts watch setup, not the stream)
        def inner():
            fc = self._s.flow_controller
            if fc is None:
                self._check("watch", namespace or "")
            else:
                from .flowcontrol import RequestInfo

                req = RequestInfo(
                    user=self._user.name, groups=self._user.groups,
                    verb="watch", resource=self._resource,
                )
                with fc.dispatch(req):
                    self._check("watch", namespace or "")
            return self._s.api.watch(self._resource, namespace, since_revision)

        return _with_audit(
            self._s.audit, self._user, "watch", self._resource,
            namespace or "", "", inner,
        )


class _AuthorizedClientset:
    def __init__(self, secure: "SecureAPIServer", user: UserInfo):
        self._secure = secure
        self.user = user

    def resource(self, name: str) -> _AuthorizedResourceClient:
        return _AuthorizedResourceClient(self._secure, self.user, name)

    def impersonate(
        self, username: str, groups: Optional[List[str]] = None
    ) -> "_AuthorizedClientset":
        """WithImpersonation (endpoints/filters/impersonation.go): the
        real user must hold the `impersonate` verb on users (name =
        target) and on groups (name = each group); subsequent requests
        run as the target, with the real identity kept for audit."""
        authz = self._secure.authorizer

        def inner():
            if not authz.authorize(self.user, "impersonate", "users", "", username):
                raise Forbidden(
                    f'user "{self.user.name}" cannot impersonate user "{username}"'
                )
            for g in groups or []:
                if not authz.authorize(self.user, "impersonate", "groups", "", g):
                    raise Forbidden(
                        f'user "{self.user.name}" cannot impersonate group "{g}"'
                    )
            return None

        # audited like any other request: repeated denied impersonation
        # probes are exactly what the forensic trail exists for
        _with_audit(
            self._secure.audit, self.user, "impersonate", "users",
            "", username, inner,
        )
        target = UserInfo(
            username,
            tuple(groups or ()) + (GROUP_AUTHENTICATED,),
            impersonated_by=self.user.name,
        )
        return _AuthorizedClientset(self._secure, target)

    def bind_pod(self, namespace: str, pod_name: str, node_name: str):
        """POST pods/{name}/binding through the secured chain (the
        scheduler's bind verb — subresource pods/binding, verb=create,
        as the reference's RBAC for system:kube-scheduler grants it)."""
        sub = _AuthorizedResourceClient(self._secure, self.user, "pods/binding")
        return sub._gated(
            "create", namespace, pod_name,
            lambda: self._secure.api.bind_pod(namespace, pod_name, node_name),
        )

    def remove_finalizer(self, resource: str, name: str, namespace: str,
                         finalizer: str):
        """Finalizer removal is an update on the resource (the reference
        gates /finalize subresources on update)."""
        sub = _AuthorizedResourceClient(self._secure, self.user, resource)
        return sub._gated(
            "update", namespace, name,
            lambda: self._secure.api.remove_finalizer(
                resource, name, namespace, finalizer
            ),
        )

    def pod_logs(self, name: str, namespace: str = "", container: str = "",
                 tail: Optional[int] = None):
        """GET pods/{name}/log through the secured chain. The reference
        gates this on the pods/log subresource (registry/core/pod/rest/
        log.go behind installer-registered subresource routes) — without
        it, log reads would be the one request class with no audit trail."""
        sub = _AuthorizedResourceClient(self._secure, self.user, "pods/log")
        return sub._gated(
            "get", namespace, name,
            lambda: self._secure.api.pod_logs(name, namespace, container, tail),
        )

    def pod_exec(self, name: str, namespace: str, cmd: List[str],
                 container: str = ""):
        """POST pods/{name}/exec through the secured chain (pods/exec
        subresource, verb=create — matching the reference's SPDY exec
        handshake authorization)."""
        sub = _AuthorizedResourceClient(self._secure, self.user, "pods/exec")
        return sub._gated(
            "create", namespace, name,
            lambda: self._secure.api.pod_exec(name, namespace, cmd, container),
        )

    def __getattr__(self, name: str):
        # pods/nodes/... attribute access like Clientset
        if name.startswith("_"):
            raise AttributeError(name)
        return _AuthorizedResourceClient(self._secure, self.user, name)


class SecureAPIServer:
    """APIServer + authn + audit + APF + RBAC authz (the secured handler
    chain in the reference's order: WithAuthentication → WithAudit →
    WithImpersonation → WithPriorityAndFairness → WithAuthorization,
    pkg/server/config.go:719-745)."""

    def __init__(
        self, api: Optional[APIServer] = None, flow_controller=None, audit=None
    ):
        self.api = api or APIServer()
        for info in RBAC_RESOURCES:
            self.api.register_resource(info)
        self.authenticator = TokenAuthenticator()
        self.authorizer = RBACAuthorizer(self.api)
        self.flow_controller = flow_controller
        self.audit = audit  # audit.AuditLogger or None

    def as_user(self, token: str) -> _AuthorizedClientset:
        """Authenticate a bearer token -> authorized clientset facade."""
        return _AuthorizedClientset(self, self.authenticator.authenticate(token))

    def service_account_token(self, namespace: str, name: str) -> str:
        """Mint a token for a ServiceAccount (the token controller's job:
        pkg/controller/serviceaccount/tokens_controller.go)."""
        import uuid

        token = f"sa-{uuid.uuid4().hex}"
        self.authenticator.add_token(
            token,
            f"system:serviceaccount:{namespace}:{name}",
            [f"system:serviceaccounts:{namespace}", "system:serviceaccounts"],
        )
        return token
