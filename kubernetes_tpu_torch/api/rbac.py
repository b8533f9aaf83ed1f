"""rbac.authorization.k8s.io types.

Reference: staging/src/k8s.io/api/rbac/v1/types.go — PolicyRule (:47),
Role (:106), ClusterRole (:155), RoleBinding (:123), ClusterRoleBinding
(:175), Subject (:77). Wildcards ("*") in verbs/resources/apiGroups
follow rbac/v1 semantics (VerbMatches/ResourceMatches in
plugin/pkg/auth/authorizer/rbac/rbac.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .types import ObjectMeta

ALL = "*"


@dataclass
class PolicyRule:
    verbs: List[str] = field(default_factory=list)
    api_groups: Optional[List[str]] = None
    resources: Optional[List[str]] = None
    resource_names: Optional[List[str]] = None
    non_resource_urls: Optional[List[str]] = None


@dataclass
class Subject:
    kind: str = ""  # User | Group | ServiceAccount
    name: str = ""
    namespace: str = ""


@dataclass
class RoleRef:
    kind: str = ""  # Role | ClusterRole
    name: str = ""
    api_group: str = "rbac.authorization.k8s.io"


@dataclass
class Role:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    rules: Optional[List[PolicyRule]] = None
    kind: str = "Role"
    api_version: str = "rbac.authorization.k8s.io/v1"


@dataclass
class AggregationRule:
    """rbac/v1 AggregationRule: label selectors over ClusterRoles whose
    rules the aggregation controller unions into this role (types.go
    AggregationRule; pkg/controller/clusterroleaggregation)."""

    # match-labels dicts (one per selector; the reference uses full
    # LabelSelectors — match_labels is the shape kube ships by default,
    # e.g. rbac.authorization.k8s.io/aggregate-to-admin: "true")
    cluster_role_selectors: Optional[List[Dict[str, str]]] = None


@dataclass
class ClusterRole:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    rules: Optional[List[PolicyRule]] = None
    aggregation_rule: Optional[AggregationRule] = None
    kind: str = "ClusterRole"
    api_version: str = "rbac.authorization.k8s.io/v1"


@dataclass
class RoleBinding:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    subjects: Optional[List[Subject]] = None
    role_ref: RoleRef = field(default_factory=RoleRef)
    kind: str = "RoleBinding"
    api_version: str = "rbac.authorization.k8s.io/v1"


@dataclass
class ClusterRoleBinding:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    subjects: Optional[List[Subject]] = None
    role_ref: RoleRef = field(default_factory=RoleRef)
    kind: str = "ClusterRoleBinding"
    api_version: str = "rbac.authorization.k8s.io/v1"


@dataclass
class ServiceAccount:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    kind: str = "ServiceAccount"
    api_version: str = "v1"


def rule_matches(
    rule: PolicyRule, verb: str, resource: str, name: str = "", api_group: str = ""
) -> bool:
    """VerbMatches + APIGroupMatches + ResourceMatches + resourceNames
    (rbac.go:76-120). A rule with no apiGroups matches only the core
    group (""), matching the reference's required-field semantics."""
    if not any(v == ALL or v == verb for v in rule.verbs):
        return False
    groups = rule.api_groups if rule.api_groups is not None else [""]
    if not any(g == ALL or g == api_group for g in groups):
        return False
    resources = rule.resources or []
    if not any(r == ALL or r == resource for r in resources):
        return False
    if rule.resource_names:
        return name != "" and name in rule.resource_names
    return True
