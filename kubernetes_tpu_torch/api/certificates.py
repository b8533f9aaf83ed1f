"""certificates.k8s.io CertificateSigningRequest types.

Reference: staging/src/k8s.io/api/certificates/v1/types.go —
CertificateSigningRequest (:28) with Spec (request bytes, signerName,
usages, expirationSeconds, username/groups of the requester) and Status
(conditions Approved/Denied/Failed (:208), issued certificate bytes).

The TPU build's PKI is kubeadm.py's HMAC-signed identity records (an
X.509-shaped subset: CommonName/Organizations/NotAfter), so `request`
carries a JSON-encoded identity request and `certificate` the
JSON-encoded signed record — same object flow, same controller split
(signing vs approval vs cleanup), without an ASN.1 dependency.

Well-known signers (:41-60): kubernetes.io/kube-apiserver-client,
kubernetes.io/kube-apiserver-client-kubelet, kubernetes.io/kubelet-serving.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

from .types import ObjectMeta

SIGNER_KUBE_APISERVER_CLIENT = "kubernetes.io/kube-apiserver-client"
SIGNER_KUBE_APISERVER_CLIENT_KUBELET = (
    "kubernetes.io/kube-apiserver-client-kubelet"
)
SIGNER_KUBELET_SERVING = "kubernetes.io/kubelet-serving"

APPROVED = "Approved"
DENIED = "Denied"
FAILED = "Failed"


@dataclass
class CertificateSigningRequestSpec:
    # JSON-encoded identity request: {"commonName": ..., "organizations":
    # [...]} (the CSR PEM's subject, in this build's record shape)
    request: str = ""
    signer_name: str = ""
    usages: Optional[List[str]] = None
    expiration_seconds: Optional[int] = None
    # requester identity, stamped by the apiserver in the reference
    # (types.go:89-99); callers set it from their authenticated user
    username: str = ""
    groups: Optional[List[str]] = None


@dataclass
class CertificateSigningRequestCondition:
    type: str = ""  # Approved | Denied | Failed
    status: str = "True"
    reason: str = ""
    message: str = ""
    last_update_time: Optional[float] = None


@dataclass
class CertificateSigningRequestStatus:
    conditions: Optional[List[CertificateSigningRequestCondition]] = None
    # JSON-encoded signed identity record (kubeadm.Certificate fields)
    certificate: str = ""


@dataclass
class CertificateSigningRequest:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CertificateSigningRequestSpec = field(
        default_factory=CertificateSigningRequestSpec
    )
    status: CertificateSigningRequestStatus = field(
        default_factory=CertificateSigningRequestStatus
    )
    kind: str = "CertificateSigningRequest"
    api_version: str = "certificates.k8s.io/v1"


def encode_request(common_name: str, organizations: List[str]) -> str:
    return json.dumps(
        {"commonName": common_name, "organizations": list(organizations)},
        sort_keys=True,
    )


def decode_request(request: str) -> dict:
    return json.loads(request)


def has_condition(csr: CertificateSigningRequest, cond_type: str) -> bool:
    return any(c.type == cond_type for c in csr.status.conditions or [])
