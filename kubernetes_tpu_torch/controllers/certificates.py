"""CSR controllers: signing, approval, cleanup.

Reference: pkg/controller/certificates/ —
  * signer/signer.go: isssue certificates for approved CSRs whose
    signerName the controller handles (CertificateController.Sync ->
    handler; signing happens only when Approved and not yet issued);
  * approver/sarapprove.go: auto-approve kubelet client CSRs whose
    requester holds the right bootstrap identity (recognizers over
    (csr, x509cr));
  * cleaner/cleaner.go: garbage-collect CSRs — pending older than 24h,
    approved/denied/failed older than 1h, and issued certs past expiry
    (:40-47 constants).

The PKI here is kubeadm.py's CertificateAuthority (HMAC-signed identity
records); `spec.request`/`status.certificate` carry JSON-encoded records
(api/certificates.py docstring).
"""

from __future__ import annotations

import json
import time
from typing import Optional

from ..api import certificates as certs
from ..api import types as v1
from ..client.informer import EventHandler
from .base import Controller, retry_on_conflict

PENDING_TTL = 24 * 3600.0  # cleaner.go pendingExpiration
RESOLVED_TTL = 3600.0      # cleaner.go approvedExpiration / deniedExpiration


def _key(csr) -> str:
    return csr.metadata.name


def _mark_failed(client, name: str, message: str) -> None:
    def apply():
        fresh = client.resource("certificatesigningrequests").get(name)
        if certs.has_condition(fresh, certs.FAILED):
            return
        fresh.status.conditions = (fresh.status.conditions or []) + [
            certs.CertificateSigningRequestCondition(
                type=certs.FAILED, reason="SigningError", message=message,
                last_update_time=time.time(),
            )
        ]
        client.resource("certificatesigningrequests").update_status(fresh)

    retry_on_conflict(apply)


class CSRSigningController(Controller):
    """certificates/signer: sign Approved, unissued CSRs for the
    well-known kube-apiserver-client signers using the cluster CA."""

    name = "csrsigning"

    SIGNERS = (
        certs.SIGNER_KUBE_APISERVER_CLIENT,
        certs.SIGNER_KUBE_APISERVER_CLIENT_KUBELET,
        certs.SIGNER_KUBELET_SERVING,
    )

    def __init__(self, clientset, informer_factory, ca, workers: int = 1):
        super().__init__(workers=workers)
        self.client = clientset
        self.ca = ca  # kubeadm.CertificateAuthority
        self.informer = informer_factory.informer_for(
            "certificatesigningrequests"
        )
        self.informer.add_event_handler(EventHandler(
            on_add=lambda c: self.enqueue(_key(c)),
            on_update=lambda o, n: self.enqueue(_key(n)),
        ))

    def sync(self, key: str) -> None:
        csr = self.informer.get(key)
        if csr is None or csr.spec.signer_name not in self.SIGNERS:
            return
        if csr.status.certificate or not certs.has_condition(csr, certs.APPROVED):
            return
        if certs.has_condition(csr, certs.DENIED) or \
                certs.has_condition(csr, certs.FAILED):
            return
        try:
            req = certs.decode_request(csr.spec.request)
        except (ValueError, TypeError):
            # malformed request must not wedge the sync in a requeue
            # loop: mark Failed once (signer.go's terminal-failure path)
            _mark_failed(self.client, csr.metadata.name,
                         "unparseable spec.request")
            return
        ttl = float(csr.spec.expiration_seconds or 0) or None
        cert = self.ca.issue(
            f"csr-{csr.metadata.name}",
            req["commonName"], req.get("organizations", []),
            **({"ttl": ttl} if ttl else {}),
        )

        def apply():
            fresh = self.client.resource("certificatesigningrequests").get(
                csr.metadata.name
            )
            if fresh.status.certificate:
                return
            fresh.status.certificate = json.dumps({
                "commonName": cert.common_name,
                "organizations": cert.organizations,
                "notAfter": cert.not_after,
                "signature": cert.signature,
                "token": cert.token,
            })
            self.client.resource("certificatesigningrequests").update_status(
                fresh
            )

        retry_on_conflict(apply)


class CSRApprovingController(Controller):
    """certificates/approver: auto-approve node-client CSRs from
    bootstrap identities (sarapprove.go recognizers: the kubelet
    bootstrap flow's system:bootstrap:<id> / system:node:* users asking
    for the kube-apiserver-client-kubelet signer)."""

    name = "csrapproving"

    def __init__(self, clientset, informer_factory, workers: int = 1):
        super().__init__(workers=workers)
        self.client = clientset
        self.informer = informer_factory.informer_for(
            "certificatesigningrequests"
        )
        self.informer.add_event_handler(EventHandler(
            on_add=lambda c: self.enqueue(_key(c)),
            on_update=lambda o, n: self.enqueue(_key(n)),
        ))

    @staticmethod
    def _recognize(csr) -> Optional[str]:
        """-> approval reason, or None when not auto-approvable."""
        if csr.spec.signer_name != certs.SIGNER_KUBE_APISERVER_CLIENT_KUBELET:
            return None
        try:
            req = certs.decode_request(csr.spec.request)
        except (ValueError, TypeError):
            return None  # malformed: not approvable (cleaner reaps it)
        if not req.get("commonName", "").startswith("system:node:"):
            return None
        if "system:nodes" not in req.get("organizations", []):
            return None
        user = csr.spec.username or ""
        groups = csr.spec.groups or []
        if user.startswith("system:bootstrap:") or \
                "system:bootstrappers" in groups:
            return "AutoApproved kubelet client certificate (bootstrap)"
        if user.startswith("system:node:"):
            return "AutoApproved kubelet client certificate (renewal)"
        return None

    def sync(self, key: str) -> None:
        csr = self.informer.get(key)
        if csr is None:
            return
        if certs.has_condition(csr, certs.APPROVED) or \
                certs.has_condition(csr, certs.DENIED):
            return
        reason = self._recognize(csr)
        if reason is None:
            return

        def apply():
            fresh = self.client.resource("certificatesigningrequests").get(
                csr.metadata.name
            )
            if certs.has_condition(fresh, certs.APPROVED):
                return
            fresh.status.conditions = (fresh.status.conditions or []) + [
                certs.CertificateSigningRequestCondition(
                    type=certs.APPROVED, reason="AutoApproved",
                    message=reason, last_update_time=time.time(),
                )
            ]
            self.client.resource("certificatesigningrequests").update_status(
                fresh
            )

        retry_on_conflict(apply)


class CSRCleanerController(Controller):
    """certificates/cleaner: delete CSRs past their useful life."""

    name = "csrcleaner"

    def __init__(self, clientset, informer_factory, workers: int = 1,
                 sync_period: float = 60.0,
                 pending_ttl: float = PENDING_TTL,
                 resolved_ttl: float = RESOLVED_TTL):
        super().__init__(workers=workers)
        self.client = clientset
        self.sync_period = sync_period
        self.pending_ttl = pending_ttl
        self.resolved_ttl = resolved_ttl
        self.informer = informer_factory.informer_for(
            "certificatesigningrequests"
        )
        self.enqueue_after("tick", 0.0)

    def sync(self, key: str) -> None:
        try:
            now = time.time()
            for csr in self.informer.list():
                created = csr.metadata.creation_timestamp or now
                resolved = (certs.has_condition(csr, certs.APPROVED)
                            or certs.has_condition(csr, certs.DENIED)
                            or certs.has_condition(csr, certs.FAILED))
                if resolved:
                    # age from the resolving condition's LastUpdateTime
                    # (cleaner.go isOlderThan(c.LastUpdateTime, ...)): a
                    # CSR pending >TTL that then gets approved must get a
                    # fresh TTL for the signer to issue the certificate,
                    # not be deleted out from under it
                    created = max(
                        [created] + [
                            c.last_update_time
                            for c in csr.status.conditions or []
                            if c.type in (certs.APPROVED, certs.DENIED,
                                          certs.FAILED)
                            and c.last_update_time is not None
                        ]
                    )
                expired_cert = False
                if csr.status.certificate:
                    try:
                        rec = json.loads(csr.status.certificate)
                        expired_cert = now >= float(rec.get("notAfter", now))
                    except (ValueError, TypeError):
                        expired_cert = True  # unparseable: clean it up
                ttl = self.resolved_ttl if resolved else self.pending_ttl
                if expired_cert or now - created > ttl:
                    try:
                        self.client.resource(
                            "certificatesigningrequests"
                        ).delete(csr.metadata.name)
                    except Exception:  # noqa: BLE001 — races are fine
                        pass
        finally:
            if not self._stopped.is_set():
                self.enqueue_after("tick", self.sync_period)
