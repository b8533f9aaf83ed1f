"""Bootstrap-token controllers: cluster-info signer + token cleaner.

Reference: pkg/controller/bootstrap/ —
  * bootstrapsigner.go: maintains JWS signatures over the kube-public
    cluster-info ConfigMap's kubeconfig, one `jws-kubeconfig-<tokenID>`
    entry per usable signing token (tokens with
    usage-bootstrap-signing=true); stale signatures (token gone/expired)
    are removed so joiners can't validate against revoked tokens;
  * tokencleaner.go: deletes bootstrap token Secrets past their
    `expiration`.

The JWS here is an HMAC-SHA256 over the kubeconfig content keyed by the
full token (the reference uses JWS with the token secret as the shared
key — same trust model: only holders of the token can verify).
"""

from __future__ import annotations

import hashlib
import hmac
import time

from ..api import types as v1
from ..client.informer import EventHandler
from .base import Controller, retry_on_conflict

TOKEN_SECRET_PREFIX = "bootstrap-token-"
TOKEN_TYPE = "bootstrap.kubernetes.io/token"
CLUSTER_INFO = "cluster-info"
KUBE_PUBLIC = "kube-public"
JWS_PREFIX = "jws-kubeconfig-"


def sign_kubeconfig(kubeconfig: str, token_id: str, token_secret: str) -> str:
    """detached-JWS analog: HMAC(full token, content)."""
    key = f"{token_id}.{token_secret}".encode()
    return hmac.new(key, kubeconfig.encode(), hashlib.sha256).hexdigest()


class BootstrapSignerController(Controller):
    name = "bootstrapsigner"

    def __init__(self, clientset, informer_factory, workers: int = 1):
        super().__init__(workers=workers)
        self.client = clientset
        self.cm_informer = informer_factory.informer_for("configmaps")
        self.secret_informer = informer_factory.informer_for("secrets")
        self.cm_informer.add_event_handler(EventHandler(
            on_add=self._on_cm, on_update=lambda o, n: self._on_cm(n),
        ))
        self.secret_informer.add_event_handler(EventHandler(
            on_add=self._on_secret,
            on_update=lambda o, n: self._on_secret(n),
            on_delete=self._on_secret,
        ))

    def _on_cm(self, cm: v1.ConfigMap) -> None:
        if cm.metadata.namespace == KUBE_PUBLIC and \
                cm.metadata.name == CLUSTER_INFO:
            self.enqueue(CLUSTER_INFO)

    def _on_secret(self, s: v1.Secret) -> None:
        if s.metadata.namespace == "kube-system" and s.type == TOKEN_TYPE:
            self.enqueue(CLUSTER_INFO)

    def _signing_tokens(self):
        """(token_id, token_secret) for usable signing tokens."""
        now = time.time()
        out = []
        for s in self.secret_informer.list():
            if s.metadata.namespace != "kube-system" or s.type != TOKEN_TYPE:
                continue
            data = s.data or {}
            if data.get("usage-bootstrap-signing") != "true":
                continue
            exp = data.get("expiration")
            if exp is not None and float(exp) < now:
                continue
            tid, tsec = data.get("token-id"), data.get("token-secret")
            if tid and tsec:
                out.append((tid, tsec))
        return out

    def sync(self, key: str) -> None:
        cm = self.cm_informer.get(f"{KUBE_PUBLIC}/{CLUSTER_INFO}")
        if cm is None:
            return
        kubeconfig = (cm.data or {}).get("kubeconfig", "")
        want = {
            f"{JWS_PREFIX}{tid}": sign_kubeconfig(kubeconfig, tid, tsec)
            for tid, tsec in self._signing_tokens()
        }
        have = {
            k: vv for k, vv in (cm.data or {}).items()
            if k.startswith(JWS_PREFIX)
        }
        if want == have:
            return

        def apply():
            fresh = self.client.configmaps.get(CLUSTER_INFO, KUBE_PUBLIC)
            data = {
                k: vv for k, vv in (fresh.data or {}).items()
                if not k.startswith(JWS_PREFIX)
            }
            kc = data.get("kubeconfig", "")
            for tid, tsec in self._signing_tokens():
                data[f"{JWS_PREFIX}{tid}"] = sign_kubeconfig(kc, tid, tsec)
            fresh.data = data
            self.client.configmaps.update(fresh)

        retry_on_conflict(apply)


class TokenCleanerController(Controller):
    name = "tokencleaner"

    def __init__(self, clientset, informer_factory, workers: int = 1,
                 sync_period: float = 10.0):
        super().__init__(workers=workers)
        self.client = clientset
        self.sync_period = sync_period
        self.secret_informer = informer_factory.informer_for("secrets")
        self.enqueue_after("tick", 0.0)

    def sync(self, key: str) -> None:
        try:
            now = time.time()
            for s in self.secret_informer.list():
                if s.metadata.namespace != "kube-system" or \
                        s.type != TOKEN_TYPE:
                    continue
                exp = (s.data or {}).get("expiration")
                if exp is None or float(exp) >= now:
                    continue
                try:
                    self.client.secrets.delete(
                        s.metadata.name, s.metadata.namespace
                    )
                except Exception:  # noqa: BLE001 — delete races are fine
                    pass
        finally:
            if not self._stopped.is_set():
                self.enqueue_after("tick", self.sync_period)
