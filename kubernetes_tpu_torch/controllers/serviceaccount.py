"""ServiceAccount + token controllers.

Reference: pkg/controller/serviceaccount/serviceaccounts_controller.go
(ensure the "default" ServiceAccount exists in every active namespace)
and tokens_controller.go (maintain a token Secret per ServiceAccount,
typed kubernetes.io/service-account-token, annotated with the owning
SA; delete secrets whose SA is gone).

Token minting: the reference signs JWTs with the cluster key; here the
mint function is pluggable — SecureAPIServer.service_account_token
registers the token with the authenticator so wire clients can actually
authenticate with it (see cluster.py wiring), and the default mint
produces an opaque random token.
"""

from __future__ import annotations

import uuid
from typing import Callable, Optional

from ..api import rbac
from ..api import types as v1
from ..client.informer import EventHandler, meta_namespace_key
from .base import Controller


def _default_mint(namespace: str, name: str) -> str:
    return f"sa-{uuid.uuid4().hex}"


class ServiceAccountController(Controller):
    """Default-SA-per-namespace (serviceaccounts_controller.go:44
    DefaultServiceAccountsControllerOptions: names=["default"])."""

    name = "serviceaccount"

    def __init__(self, clientset, informer_factory, names=("default",)):
        super().__init__(workers=1)
        self.client = clientset
        self.names = tuple(names)
        self.ns_informer = informer_factory.informer_for("namespaces")
        self.sa_informer = informer_factory.informer_for("serviceaccounts")
        self.ns_informer.add_event_handler(EventHandler(
            on_add=lambda ns: self.enqueue(ns.metadata.name),
            on_update=lambda old, new: self.enqueue(new.metadata.name),
        ))
        # a deleted SA in a live namespace is recreated
        self.sa_informer.add_event_handler(EventHandler(
            on_delete=lambda sa: self.enqueue(sa.metadata.namespace),
        ))

    def sync(self, key: str) -> None:
        ns = self.ns_informer.get(key)
        if ns is None or ns.metadata.deletion_timestamp is not None:
            return
        existing = {
            sa.metadata.name
            for sa in self.sa_informer.list()
            if sa.metadata.namespace == key
        }
        for name in self.names:
            if name in existing:
                continue
            self.client.serviceaccounts.create(rbac.ServiceAccount(
                metadata=v1.ObjectMeta(name=name, namespace=key)
            ))


class TokensController(Controller):
    """One token Secret per ServiceAccount (tokens_controller.go)."""

    name = "serviceaccount-token"

    def __init__(self, clientset, informer_factory,
                 mint: Optional[Callable[[str, str], str]] = None):
        super().__init__(workers=1)
        self.client = clientset
        self.mint = mint or _default_mint
        self.sa_informer = informer_factory.informer_for("serviceaccounts")
        self.secret_informer = informer_factory.informer_for("secrets")
        self.sa_informer.add_event_handler(EventHandler(
            on_add=lambda sa: self.enqueue(meta_namespace_key(sa)),
            on_delete=lambda sa: self.enqueue(meta_namespace_key(sa)),
        ))
        # a deleted token secret must be re-minted (tokens_controller.go
        # watches secrets for exactly this)
        self.secret_informer.add_event_handler(EventHandler(
            on_delete=self._on_secret_delete,
        ))

    def _on_secret_delete(self, secret) -> None:
        if secret.type != v1.SECRET_TYPE_SERVICE_ACCOUNT_TOKEN:
            return
        sa = (secret.metadata.annotations or {}).get(
            v1.SERVICE_ACCOUNT_NAME_ANNOTATION
        )
        if sa:
            self.enqueue(f"{secret.metadata.namespace}/{sa}")

    def _token_secrets_of(self, namespace: str, name: str):
        return [
            s for s in self.secret_informer.list()
            if s.metadata.namespace == namespace
            and s.type == v1.SECRET_TYPE_SERVICE_ACCOUNT_TOKEN
            and (s.metadata.annotations or {}).get(
                v1.SERVICE_ACCOUNT_NAME_ANNOTATION) == name
        ]

    def sync(self, key: str) -> None:
        namespace, name = key.split("/", 1)
        sa = self.sa_informer.get(key)
        secrets = self._token_secrets_of(namespace, name)
        if sa is None:
            # SA gone: its token secrets go too (tokens_controller.go
            # deleteTokens)
            for s in secrets:
                try:
                    self.client.secrets.delete(s.metadata.name, namespace)
                except Exception:  # noqa: BLE001 — already gone
                    pass
            return
        if secrets:
            return
        token = self.mint(namespace, name)
        self.client.secrets.create(v1.Secret(
            metadata=v1.ObjectMeta(
                name=f"{name}-token-{uuid.uuid4().hex[:5]}",
                namespace=namespace,
                annotations={v1.SERVICE_ACCOUNT_NAME_ANNOTATION: name},
            ),
            type=v1.SECRET_TYPE_SERVICE_ACCOUNT_TOKEN,
            data={"token": token, "namespace": namespace},
        ))
