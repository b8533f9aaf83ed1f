"""NetworkPolicy evaluation model.

Reference semantics: the NetworkPolicy API contract
(staging/src/k8s.io/api/networking/v1/types.go:30 + the conformance
behaviors CNI plugins implement — kube-proxy itself does not enforce
NetworkPolicy; this model is the data-plane twin the same way
proxier.py models the Service chains without a kernel):

  * a pod UNSELECTED by any policy for a direction accepts everything
    in that direction (default-allow);
  * once ANY policy selects it for a direction, only traffic matched by
    SOME rule of SOME selecting policy passes (policies are additive,
    whitelist-only);
  * a rule with no peers matches every source/destination; a rule with
    no ports matches every port;
  * peers match by podSelector (same namespace unless a
    namespaceSelector is present), namespaceSelector (any pod in
    matching namespaces), both ANDed when both are set, or ipBlock
    (CIDR minus excepts).
"""

from __future__ import annotations

import ipaddress
from typing import Dict, List, Optional, Sequence

from ..api import types as v1
from ..api.labels import Selector
from ..api.networking import (
    NetworkPolicy,
    NetworkPolicyPeer,
    NetworkPolicyPort,
    POLICY_TYPE_EGRESS,
    POLICY_TYPE_INGRESS,
    effective_policy_types,
)


class Endpoint:
    """One traffic endpoint: a pod (labels + namespace + ip) or a bare
    IP (external traffic)."""

    __slots__ = ("namespace", "labels", "ip", "named_ports")

    def __init__(self, namespace: str = "", labels: Optional[Dict] = None,
                 ip: str = "", named_ports: Optional[Dict] = None):
        self.namespace = namespace
        self.labels = labels or {}
        self.ip = ip
        # container port name -> (containerPort, protocol): named
        # NetworkPolicyPort targets resolve against the DESTINATION
        # pod's container specs PER (name, protocol) — a UDP "web"
        # container port must not satisfy a TCP policy port (types.go:
        # the named lookup matches both fields). Bare-int values are
        # accepted and read as TCP (the ContainerPort default).
        self.named_ports = {
            name: (v if isinstance(v, tuple) else (v, "TCP"))
            for name, v in (named_ports or {}).items()
        }

    @classmethod
    def from_pod(cls, pod: v1.Pod) -> "Endpoint":
        named = {
            p.name: (p.container_port, getattr(p, "protocol", None) or "TCP")
            for c in pod.spec.containers or []
            for p in c.ports or []
            if getattr(p, "name", None)
        }
        return cls(
            namespace=pod.metadata.namespace,
            labels=dict(pod.metadata.labels or {}),
            ip=pod.status.pod_ip,
            named_ports=named,
        )

    @classmethod
    def external(cls, ip: str) -> "Endpoint":
        return cls(ip=ip)

    @property
    def is_pod(self) -> bool:
        return bool(self.namespace)


class NetworkPolicyEvaluator:
    """Evaluates allowed() over a policy set + namespace labels."""

    def __init__(self, policies: Sequence[NetworkPolicy],
                 namespaces: Optional[Dict[str, Dict[str, str]]] = None):
        self.policies = list(policies)
        # namespace name -> labels (namespaceSelector targets)
        self.namespaces = namespaces or {}

    def _selecting(self, pod: Endpoint, direction: str) -> List[NetworkPolicy]:
        out = []
        for pol in self.policies:
            if pol.metadata.namespace != pod.namespace:
                continue
            if direction not in effective_policy_types(pol.spec):
                continue
            sel = Selector.from_label_selector(pol.spec.pod_selector)
            if sel.matches(pod.labels):
                out.append(pol)
        return out

    def _peer_matches(self, peer: NetworkPolicyPeer, other: Endpoint,
                      policy_ns: str) -> bool:
        if peer.ip_block is not None:
            if not other.ip:
                return False
            try:
                addr = ipaddress.ip_address(other.ip)
                if addr not in ipaddress.ip_network(peer.ip_block.cidr):
                    return False
                for ex in peer.ip_block.except_ or []:
                    if addr in ipaddress.ip_network(ex):
                        return False
                return True
            except ValueError:
                return False
        if not other.is_pod:
            return False  # selector peers never match external IPs
        if peer.namespace_selector is not None:
            ns_labels = self.namespaces.get(other.namespace, {})
            if not Selector.from_label_selector(
                peer.namespace_selector
            ).matches(ns_labels):
                return False
            if peer.pod_selector is not None:
                return Selector.from_label_selector(
                    peer.pod_selector
                ).matches(other.labels)
            return True
        if peer.pod_selector is not None:
            # no namespaceSelector: same-namespace pods only (types.go)
            return other.namespace == policy_ns and \
                Selector.from_label_selector(
                    peer.pod_selector
                ).matches(other.labels)
        return False

    @staticmethod
    def _port_matches(ports: Optional[List[NetworkPolicyPort]],
                      port: int, protocol: str, dst: Endpoint) -> bool:
        if not ports:
            return True  # no ports = every port
        for p in ports:
            if (p.protocol or "TCP") != protocol:
                continue
            if p.port is None:
                return True
            lo = p.port
            if isinstance(lo, str):
                # named port: resolves against the destination pod's
                # container specs per (name, protocol) — a name whose
                # container port carries a different protocol resolves
                # to nothing; unresolvable names match nothing
                # (endPort is invalid with a named port, types.go)
                resolved = dst.named_ports.get(lo)
                if resolved is None:
                    continue
                num, proto = resolved
                if proto != (p.protocol or "TCP"):
                    continue
                if port == num:
                    return True
                continue
            hi = p.end_port if p.end_port is not None else lo
            if lo <= port <= hi:
                return True
        return False

    def allowed(self, src: Endpoint, dst: Endpoint, port: int,
                protocol: str = "TCP") -> bool:
        """Both directions must pass: dst's ingress policies AND src's
        egress policies (conformance: a connection needs both sides).
        `port` is a port on dst; named policy ports resolve against dst."""
        return self._direction_allowed(
            dst, src, port, protocol, POLICY_TYPE_INGRESS
        ) and self._direction_allowed(
            src, dst, port, protocol, POLICY_TYPE_EGRESS
        )

    def _direction_allowed(self, subject: Endpoint, other: Endpoint,
                           port: int, protocol: str, direction: str) -> bool:
        if not subject.is_pod:
            return True  # external endpoints are not policy subjects
        # traffic destination: the subject for ingress, the remote for
        # egress — named policy ports always resolve against it
        dst = subject if direction == POLICY_TYPE_INGRESS else other
        selecting = self._selecting(subject, direction)
        if not selecting:
            return True  # default-allow when unselected
        for pol in selecting:
            rules = (
                pol.spec.ingress if direction == POLICY_TYPE_INGRESS
                else pol.spec.egress
            ) or []
            for rule in rules:
                peers = (
                    rule.from_ if direction == POLICY_TYPE_INGRESS
                    else rule.to
                )
                if not self._port_matches(rule.ports, port, protocol, dst):
                    continue
                if not peers:
                    return True  # no peers = every counterpart
                if any(
                    self._peer_matches(p, other, pol.metadata.namespace)
                    for p in peers
                ):
                    return True
        return False
