"""kubeadm equivalent: phased init, worker/control-plane join, bootstrap
tokens, and certificate lifecycle.

Reference: cmd/kubeadm — init runs an ordered phase list (app/cmd/phases/
init: preflight, certs, kubeconfig, control-plane, upload-config,
mark-control-plane, bootstrap-token, addon), each independently
invocable (`kubeadm init phase <name>`) and skippable (--skip-phases);
join (app/cmd/join.go) discovers the cluster with a bootstrap token
(abcdef.16-hex format, stored as a Secret in kube-system per
bootstrap.kubernetes.io/token) and brings up a kubelet;
`kubeadm certs check-expiration` / `renew` manage the PKI.

The in-proc trust model: this build's "certificates" are signed identity
records (HMAC over cn/org/expiry with the cluster CA key) whose tokens
register with the SecureAPIServer's authenticator — the same
issue/verify/expire/renew lifecycle without an X.509 stack, which no
in-proc boundary would check anyway.
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .api import types as v1

TOKEN_SECRET_PREFIX = "bootstrap-token-"
TOKEN_ID_LEN = 6
TOKEN_SECRET_LEN = 16
DEFAULT_CERT_TTL = 365 * 24 * 3600.0  # kubeadm's 1-year component certs
DEFAULT_TOKEN_TTL = 24 * 3600.0  # bootstrap tokens default to 24h
CONTROL_PLANE_LABEL = "node-role.kubernetes.io/control-plane"
CONTROL_PLANE_TAINT = "node-role.kubernetes.io/master"


def generate_bootstrap_token() -> str:
    """abcdef.0123456789abcdef (bootstraputil.GenerateBootstrapToken)."""
    alphabet = "abcdefghijklmnopqrstuvwxyz0123456789"
    tid = "".join(secrets.choice(alphabet) for _ in range(TOKEN_ID_LEN))
    tsec = "".join(secrets.choice(alphabet) for _ in range(TOKEN_SECRET_LEN))
    return f"{tid}.{tsec}"


@dataclass
class Certificate:
    """A signed identity record (the X.509-shaped subset kubeadm manages:
    CommonName/Organization map to user/groups, NotAfter to expiry)."""

    common_name: str
    organizations: List[str]
    not_after: float
    signature: str = ""
    token: str = ""  # the bearer credential registered for this identity


class CertificateAuthority:
    """Issue/verify/renew identity records (kubeadm's pkiutil + renewal
    manager, app/phases/certs)."""

    def __init__(self, key: Optional[bytes] = None):
        self.key = key or secrets.token_bytes(32)
        self._lock = threading.Lock()
        self.issued: Dict[str, Certificate] = {}  # name -> cert

    def _sign(self, cn: str, orgs: List[str], not_after: float) -> str:
        msg = f"{cn}|{','.join(sorted(orgs))}|{not_after:.3f}".encode()
        return hmac.new(self.key, msg, hashlib.sha256).hexdigest()

    def public_bundle(self) -> str:
        """The distributable CA identity (the ca.crt bundle analog):
        clients pin this fingerprint to verify they're talking to the
        cluster this CA anchors (root-ca-cert-publisher payload;
        discovery's --discovery-token-ca-cert-hash)."""
        return "sha256:" + hashlib.sha256(self.key).hexdigest()

    def issue(self, name: str, common_name: str, organizations: List[str],
              ttl: float = DEFAULT_CERT_TTL) -> Certificate:
        not_after = time.time() + ttl
        cert = Certificate(
            common_name=common_name,
            organizations=list(organizations),
            not_after=not_after,
            signature=self._sign(common_name, organizations, not_after),
            token=f"cert-{secrets.token_hex(16)}",
        )
        with self._lock:
            self.issued[name] = cert
        return cert

    def verify(self, cert: Certificate) -> bool:
        if time.time() >= cert.not_after:
            return False
        want = self._sign(cert.common_name, cert.organizations, cert.not_after)
        return hmac.compare_digest(want, cert.signature)

    def check_expiration(self, within: float = 0.0) -> Dict[str, float]:
        """name -> seconds until expiry (kubeadm certs check-expiration);
        only entries expiring within `within` seconds when given."""
        now = time.time()
        with self._lock:
            out = {n: c.not_after - now for n, c in self.issued.items()}
        if within:
            out = {n: left for n, left in out.items() if left <= within}
        return out

    def renew(self, name: str, ttl: float = DEFAULT_CERT_TTL) -> Certificate:
        """kubeadm certs renew <name>: re-issue with a fresh expiry (same
        identity, same bearer token so live components keep working)."""
        with self._lock:
            old = self.issued[name]
        cert = Certificate(
            common_name=old.common_name,
            organizations=list(old.organizations),
            not_after=time.time() + ttl,
            token=old.token,
        )
        cert.signature = self._sign(
            cert.common_name, cert.organizations, cert.not_after
        )
        with self._lock:
            self.issued[name] = cert
        return cert


@dataclass
class Phase:
    name: str
    run: Callable[["InitContext"], None]


@dataclass
class InitContext:
    """What phases read/write (kubeadm's workflow.RunData analog)."""

    secure: object  # apiserver.auth.SecureAPIServer
    cluster_name: str = "kubernetes"
    node_name: str = "control-plane-0"
    ca: CertificateAuthority = field(default_factory=CertificateAuthority)
    bootstrap_token: str = ""
    admin_token: str = ""
    results: Dict[str, bool] = field(default_factory=dict)


# -- the init phases (same order as app/cmd/phases/init) --------------------


def _apply(api, resource: str, obj) -> None:
    """Create-or-replace: phases are individually re-runnable (`kubeadm
    init phase <name>` twice must succeed idempotently, as the
    reference's phases do)."""
    try:
        api.create(resource, obj)
    except Exception:
        try:
            live = api.get(resource, obj.metadata.name,
                           obj.metadata.namespace)
            obj.metadata.resource_version = live.metadata.resource_version
            api.update(resource, obj)
        except Exception:
            raise


def _phase_preflight(ctx: InitContext) -> None:
    # environment checks: store reachable, clean registry prefix
    ctx.secure.api.list("namespaces")


def _phase_certs(ctx: InitContext) -> None:
    """Issue the control-plane PKI: CA-signed identities for admin,
    apiserver, controller-manager, scheduler, kubelet client."""
    for name, cn, orgs in (
        ("admin", "kubernetes-admin", ["system:masters"]),
        ("controller-manager", "system:kube-controller-manager", []),
        ("scheduler", "system:kube-scheduler", []),
        (f"kubelet-{ctx.node_name}", f"system:node:{ctx.node_name}",
         ["system:nodes"]),
    ):
        cert = ctx.ca.issue(name, cn, orgs)
        ctx.secure.authenticator.add_token(cert.token, cn, orgs)
    ctx.admin_token = ctx.ca.issued["admin"].token


def _phase_kubeconfig(ctx: InitContext) -> None:
    """Admin/component kubeconfigs: a ConfigMap holding the cluster
    coordinates + identity references (files in the reference)."""
    _apply(ctx.secure.api, "configmaps", v1.ConfigMap(
        metadata=v1.ObjectMeta(name="kubeconfig-admin", namespace="kube-system"),
        data={"cluster": ctx.cluster_name, "user": "kubernetes-admin"},
    ))


def _phase_upload_config(ctx: InitContext) -> None:
    """kubeadm-config ConfigMap (uploadconfig phase) — what joining nodes
    read to discover cluster settings."""
    _apply(ctx.secure.api, "configmaps", v1.ConfigMap(
        metadata=v1.ObjectMeta(name="kubeadm-config", namespace="kube-system"),
        data={"clusterName": ctx.cluster_name},
    ))


def _phase_mark_control_plane(ctx: InitContext) -> None:
    """Label + taint the control-plane node (markcontrolplane phase)."""
    api = ctx.secure.api
    try:
        node = api.get("nodes", ctx.node_name)
    except Exception:  # noqa: BLE001 — no node object yet: create a stub
        node = v1.Node(metadata=v1.ObjectMeta(name=ctx.node_name))
        node = api.create("nodes", node)
    node.metadata.labels = dict(node.metadata.labels or {})
    node.metadata.labels[CONTROL_PLANE_LABEL] = ""
    taints = list(node.spec.taints or [])
    if not any(t.key == CONTROL_PLANE_TAINT for t in taints):
        # idempotent: phases are individually re-runnable (kubeadm init
        # phase mark-control-plane twice must not stack taints)
        taints.append(
            v1.Taint(key=CONTROL_PLANE_TAINT, value="", effect="NoSchedule")
        )
    node.spec.taints = taints
    api.update("nodes", node)


def _phase_bootstrap_token(ctx: InitContext) -> None:
    """Create the join token as a kube-system Secret
    (bootstraptoken phase; bootstrap.kubernetes.io/token type)."""
    token = ctx.bootstrap_token or generate_bootstrap_token()
    tid, tsec = token.split(".", 1)
    _apply(ctx.secure.api, "secrets", v1.Secret(
        metadata=v1.ObjectMeta(
            name=f"{TOKEN_SECRET_PREFIX}{tid}", namespace="kube-system"),
        type="bootstrap.kubernetes.io/token",
        data={
            "token-id": tid,
            "token-secret": tsec,
            "expiration": str(time.time() + DEFAULT_TOKEN_TTL),
            "usage-bootstrap-authentication": "true",
            "usage-bootstrap-signing": "true",
        },
    ))
    # cluster-info in kube-public (bootstraptoken/clusterinfo phase):
    # the anonymous discovery document joiners read; the bootstrapsigner
    # controller maintains its jws-kubeconfig-<tokenID> signatures
    _apply(ctx.secure.api, "configmaps", v1.ConfigMap(
        metadata=v1.ObjectMeta(name="cluster-info", namespace="kube-public"),
        data={
            "kubeconfig": (
                f"cluster={ctx.cluster_name};"
                f"ca={ctx.ca.public_bundle()}"
            ),
        },
    ))
    ctx.bootstrap_token = token


INIT_PHASES: List[Phase] = [
    Phase("preflight", _phase_preflight),
    Phase("certs", _phase_certs),
    Phase("kubeconfig", _phase_kubeconfig),
    Phase("upload-config", _phase_upload_config),
    Phase("mark-control-plane", _phase_mark_control_plane),
    Phase("bootstrap-token", _phase_bootstrap_token),
]


def init(secure, node_name: str = "control-plane-0",
         skip_phases: Optional[List[str]] = None,
         only_phase: str = "") -> InitContext:
    """kubeadm init: run the phase list in order. `only_phase` runs a
    single phase (kubeadm init phase <name>); `skip_phases` mirrors
    --skip-phases."""
    ctx = InitContext(secure=secure, node_name=node_name)
    skip = set(skip_phases or ())
    for phase in INIT_PHASES:
        if only_phase and phase.name != only_phase:
            continue
        if phase.name in skip:
            ctx.results[phase.name] = False
            continue
        phase.run(ctx)
        ctx.results[phase.name] = True
    return ctx


# -- join -------------------------------------------------------------------


class InvalidToken(Exception):
    pass


def _validate_token(api, token: str) -> None:
    """Token discovery/validation (app/discovery/token): the secret must
    exist, match, allow authentication, and not be expired."""
    try:
        tid, tsec = token.split(".", 1)
    except ValueError:
        raise InvalidToken(f"malformed bootstrap token {token!r}")
    try:
        secret = api.get("secrets", f"{TOKEN_SECRET_PREFIX}{tid}", "kube-system")
    except Exception:
        raise InvalidToken(f"unknown bootstrap token id {tid!r}")
    data = secret.data or {}
    if data.get("token-secret") != tsec:
        raise InvalidToken("bootstrap token secret mismatch")
    if data.get("usage-bootstrap-authentication") != "true":
        raise InvalidToken("token not usable for authentication")
    if float(data.get("expiration", "0")) < time.time():
        raise InvalidToken("bootstrap token expired")


def join(ctx: InitContext, node_name: str,
         control_plane: bool = False, token: str = "",
         via_csr: bool = False, csr_timeout: float = 30.0) -> Certificate:
    """kubeadm join: validate the bootstrap token, obtain the node's
    kubelet identity (TLS bootstrap analog), and for --control-plane
    joins mark the node and mint component identities too.

    via_csr=True runs the real TLS-bootstrap shape: create a
    CertificateSigningRequest as the bootstrap identity and wait for the
    csrapproving + csrsigning controllers to approve and issue it
    (kubelet/certificate/bootstrap; requires those controllers running
    against the same apiserver with ctx.ca)."""
    api = ctx.secure.api
    _validate_token(api, token or ctx.bootstrap_token)
    if via_csr:
        cert = _join_via_csr(ctx, node_name, token or ctx.bootstrap_token,
                             csr_timeout)
    else:
        cert = ctx.ca.issue(
            f"kubelet-{node_name}", f"system:node:{node_name}",
            ["system:nodes"]
        )
    ctx.secure.authenticator.add_token(
        cert.token, cert.common_name, cert.organizations
    )
    if control_plane:
        sub = InitContext(
            secure=ctx.secure, node_name=node_name, ca=ctx.ca,
            cluster_name=ctx.cluster_name,
        )
        _phase_mark_control_plane(sub)
    return cert


def _join_via_csr(ctx: InitContext, node_name: str, token: str,
                  timeout: float) -> Certificate:
    import json as _json

    from .api import certificates as certsapi

    api = ctx.secure.api
    tid = token.split(".", 1)[0]
    name = f"node-csr-{node_name}"
    csr = certsapi.CertificateSigningRequest(
        metadata=certsapi.ObjectMeta(name=name),
        spec=certsapi.CertificateSigningRequestSpec(
            request=certsapi.encode_request(
                f"system:node:{node_name}", ["system:nodes"]
            ),
            signer_name=certsapi.SIGNER_KUBE_APISERVER_CLIENT_KUBELET,
            usages=["client auth"],
            username=f"system:bootstrap:{tid}",
            groups=["system:bootstrappers"],
        ),
    )
    try:
        api.create("certificatesigningrequests", csr)
    except Exception:  # noqa: BLE001 — re-join: an existing CSR may be ours
        pass
    deadline = time.time() + timeout
    while time.time() < deadline:
        cur = api.get("certificatesigningrequests", name)
        # never adopt a pre-existing CSR for a DIFFERENT identity: an
        # attacker could pre-create node-csr-<victim> and harvest the
        # issued credential (the signer writes the bearer token into
        # status.certificate)
        if cur.spec.request != csr.spec.request:
            raise InvalidToken(
                f"existing CSR {name!r} requests a different identity; "
                "refusing to adopt it"
            )
        if cur.status.certificate:
            rec = _json.loads(cur.status.certificate)
            if rec.get("commonName") != f"system:node:{node_name}":
                raise InvalidToken(
                    f"CSR {name!r} was issued for "
                    f"{rec.get('commonName')!r}, not this node"
                )
            return Certificate(
                common_name=rec["commonName"],
                organizations=list(rec["organizations"]),
                not_after=float(rec["notAfter"]),
                signature=rec.get("signature", ""),
                token=rec.get("token", ""),
            )
        time.sleep(0.05)
    raise TimeoutError(
        f"CSR {name!r} was not approved+signed within {timeout}s "
        "(are csrapproving/csrsigning running?)"
    )
