"""Request auditing: the apiserver's forensic trail.

Reference: staging/src/k8s.io/apiserver/pkg/audit (policy/checker.go level
evaluation, audit.Event with stages) wired as WithAudit in the handler
chain (pkg/server/config.go:737). Events carry an audit ID, stage, user
(+ impersonated user), verb, object ref, and the response status; the
policy picks a level per request: None, Metadata, Request (include the
request object), RequestResponse (also the response object).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

LEVEL_NONE = "None"
LEVEL_METADATA = "Metadata"
LEVEL_REQUEST = "Request"
LEVEL_REQUEST_RESPONSE = "RequestResponse"

_LEVEL_ORDER = {
    LEVEL_NONE: 0,
    LEVEL_METADATA: 1,
    LEVEL_REQUEST: 2,
    LEVEL_REQUEST_RESPONSE: 3,
}

STAGE_REQUEST_RECEIVED = "RequestReceived"
STAGE_RESPONSE_COMPLETE = "ResponseComplete"
STAGE_PANIC = "Panic"


@dataclass
class PolicyRule:
    """One audit policy rule (audit/v1 Policy.rules[]): first match wins."""

    level: str
    users: Optional[List[str]] = None  # None = any
    verbs: Optional[List[str]] = None
    resources: Optional[List[str]] = None
    namespaces: Optional[List[str]] = None
    omit_stages: List[str] = field(default_factory=list)

    def matches(self, user: str, verb: str, resource: str, namespace: str) -> bool:
        return (
            (self.users is None or user in self.users)
            and (self.verbs is None or verb in self.verbs)
            and (self.resources is None or resource in self.resources)
            and (self.namespaces is None or namespace in self.namespaces)
        )


@dataclass
class Policy:
    rules: List[PolicyRule] = field(
        default_factory=lambda: [PolicyRule(level=LEVEL_METADATA)]
    )

    def level_for(
        self, user: str, verb: str, resource: str, namespace: str
    ) -> PolicyRule:
        """policy/checker.go LevelAndStages: first matching rule wins;
        no match -> None level."""
        for r in self.rules:
            if r.matches(user, verb, resource, namespace):
                return r
        return PolicyRule(level=LEVEL_NONE)


@dataclass
class Event:
    audit_id: str
    stage: str
    level: str
    user: str
    groups: List[str]
    verb: str
    resource: str
    namespace: str
    name: str
    impersonated_by: str = ""  # the real identity when impersonating
    response_code: int = 0
    request_object: Optional[Dict] = None
    response_object: Optional[Dict] = None
    stage_timestamp: float = field(default_factory=time.time)


class AuditLogger:
    """Policy-filtered event sink (the log backend; the reference also
    ships a webhook backend — a sink callable covers both shapes)."""

    def __init__(
        self,
        policy: Optional[Policy] = None,
        sink: Optional[Callable[[Event], None]] = None,
        capacity: int = 10000,
    ):
        self.policy = policy or Policy()
        self._sink = sink
        self._events: List[Event] = []
        self._lock = threading.Lock()
        self._capacity = capacity

    def new_audit_id(self) -> str:
        return uuid.uuid4().hex

    def emit(self, event: Event) -> None:
        with self._lock:
            self._events.append(event)
            if len(self._events) > self._capacity:
                self._events = self._events[-self._capacity :]
        if self._sink is not None:
            self._sink(event)

    def events(
        self,
        user: Optional[str] = None,
        resource: Optional[str] = None,
        stage: Optional[str] = None,
    ) -> List[Event]:
        with self._lock:
            evs = list(self._events)
        return [
            e
            for e in evs
            if (user is None or e.user == user)
            and (resource is None or e.resource == resource)
            and (stage is None or e.stage == stage)
        ]


def record_levels(level: str) -> bool:
    """Does this level produce events at all?"""
    return _LEVEL_ORDER[level] >= _LEVEL_ORDER[LEVEL_METADATA]


def includes_request(level: str) -> bool:
    return _LEVEL_ORDER[level] >= _LEVEL_ORDER[LEVEL_REQUEST]


def includes_response(level: str) -> bool:
    return _LEVEL_ORDER[level] >= _LEVEL_ORDER[LEVEL_REQUEST_RESPONSE]
