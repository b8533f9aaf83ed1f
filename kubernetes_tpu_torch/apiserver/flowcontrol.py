"""API Priority & Fairness (APF): request classification + flow control.

Reference: staging/src/k8s.io/apiserver/pkg/util/flowcontrol —
WithPriorityAndFairness sits in the handler chain (server/config.go:726);
FlowSchemas classify each request (by user/group/resource rules, lowest
matchingPrecedence wins) onto a PriorityLevelConfiguration whose
concurrency shares bound how many requests execute at once; excess
requests wait in a bounded per-level queue (fair queuing across flows)
and are rejected when the queue is full — the 429 Retry-After path.
`exempt` levels bypass queuing entirely (system-masters traffic).

In-proc equivalent: FlowController.classify(RequestInfo) picks the
level; `with controller.dispatch(req): ...` holds a seat for the
request's duration (seats are semaphores per level; queue overflow and
seat-wait timeouts raise TooManyRequests). The secured chain wires it in
the reference's handler order — authn → APF → authz — via
SecureAPIServer(flow_controller=...) (apiserver/auth.py).
FlowSchema/PriorityLevelConfiguration are stored resources managed like
any other object; the mandatory exempt/catch-all bootstrap objects are
re-ensured if deleted.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

from ..api import types as v1
from .server import APIError, APIServer, ResourceInfo

ALL = "*"


class TooManyRequests(APIError):
    """Queue for the priority level is full (HTTP 429 analog)."""

    code = 429


@dataclass
class PriorityLevelLimited:
    # assured concurrency seats for this level (the reference computes
    # shares across levels; here seats are declared directly)
    assured_concurrency_shares: int = 10
    queue_length_limit: int = 50


@dataclass
class PriorityLevelConfigurationSpec:
    type: str = "Limited"  # Limited | Exempt
    limited: Optional[PriorityLevelLimited] = None


@dataclass
class PriorityLevelConfiguration:
    metadata: v1.ObjectMeta = field(default_factory=v1.ObjectMeta)
    spec: PriorityLevelConfigurationSpec = field(
        default_factory=PriorityLevelConfigurationSpec
    )
    kind: str = "PriorityLevelConfiguration"
    api_version: str = "flowcontrol.apiserver.k8s.io/v1beta1"


@dataclass
class FlowSchemaSubject:
    kind: str = ""  # User | Group | ServiceAccount
    name: str = ALL


@dataclass
class FlowSchemaRule:
    subjects: Optional[List[FlowSchemaSubject]] = None
    verbs: Optional[List[str]] = None
    resources: Optional[List[str]] = None


@dataclass
class FlowSchemaSpec:
    priority_level_configuration: str = ""  # PLC name
    matching_precedence: int = 1000  # lower wins
    rules: Optional[List[FlowSchemaRule]] = None


@dataclass
class FlowSchema:
    metadata: v1.ObjectMeta = field(default_factory=v1.ObjectMeta)
    spec: FlowSchemaSpec = field(default_factory=FlowSchemaSpec)
    kind: str = "FlowSchema"
    api_version: str = "flowcontrol.apiserver.k8s.io/v1beta1"


@dataclass(frozen=True)
class RequestInfo:
    user: str = ""
    groups: tuple = ()
    verb: str = ""
    resource: str = ""


def _subject_matches(s: FlowSchemaSubject, req: RequestInfo) -> bool:
    if s.kind == "User":
        return s.name in (ALL, req.user)
    if s.kind == "Group":
        return s.name == ALL or s.name in req.groups
    if s.kind == "ServiceAccount":
        return req.user.startswith("system:serviceaccount:") and (
            s.name == ALL or req.user.endswith(f":{s.name}")
        )
    return False


def _rule_matches(rule: FlowSchemaRule, req: RequestInfo) -> bool:
    if rule.subjects and not any(_subject_matches(s, req) for s in rule.subjects):
        return False
    verbs = rule.verbs or [ALL]
    if not any(x in (ALL, req.verb) for x in verbs):
        return False
    resources = rule.resources or [ALL]
    return any(x in (ALL, req.resource) for x in resources)


class _Level:
    def __init__(self, plc: PriorityLevelConfiguration):
        self.name = plc.metadata.name
        self.config_key = (plc.metadata.name, plc.metadata.resource_version)
        self.exempt = plc.spec.type == "Exempt"
        limited = plc.spec.limited or PriorityLevelLimited()
        self.seats = threading.Semaphore(max(1, limited.assured_concurrency_shares))
        self.queue_limit = limited.queue_length_limit
        self._waiting = 0
        self._lock = threading.Lock()

    def acquire(self, timeout: Optional[float]) -> None:
        if self.exempt:
            return
        # free seat: take it without touching the queue accounting (the
        # queue limit gates only requests that actually have to WAIT —
        # queue_length_limit=0 must still admit up to `seats` requests)
        if self.seats.acquire(blocking=False):
            return
        with self._lock:
            if self._waiting >= self.queue_limit:
                raise TooManyRequests(
                    f"priority level {self.name!r}: queue full "
                    f"({self.queue_limit} waiting)"
                )
            self._waiting += 1
        try:
            acquired = self.seats.acquire(timeout=timeout)
        finally:
            with self._lock:
                self._waiting -= 1
        if not acquired:
            raise TooManyRequests(
                f"priority level {self.name!r}: timed out waiting for a seat"
            )

    def release(self) -> None:
        if not self.exempt:
            self.seats.release()


class FlowController:
    """Classify + gate requests; rebuilds levels when the configs change."""

    def __init__(self, api: APIServer, default_timeout: float = 30.0):
        self.api = api
        self.default_timeout = default_timeout
        self._lock = threading.Lock()
        self._levels: dict = {}
        self._config_rev = None
        self._store_rev = None
        api.register_resource(
            ResourceInfo("prioritylevelconfigurations", PriorityLevelConfiguration, False)
        )
        api.register_resource(ResourceInfo("flowschemas", FlowSchema, False))
        self.install_defaults()

    def install_defaults(self) -> None:
        """The mandatory objects (the reference ships exempt + catch-all:
        pkg/apis/flowcontrol/bootstrap)."""
        for plc in (
            PriorityLevelConfiguration(
                metadata=v1.ObjectMeta(name="exempt"),
                spec=PriorityLevelConfigurationSpec(type="Exempt"),
            ),
            PriorityLevelConfiguration(
                metadata=v1.ObjectMeta(name="global-default"),
                spec=PriorityLevelConfigurationSpec(
                    type="Limited",
                    limited=PriorityLevelLimited(
                        assured_concurrency_shares=20, queue_length_limit=128
                    ),
                ),
            ),
        ):
            try:
                self.api.create("prioritylevelconfigurations", plc)
            except APIError:
                pass
        for fs in (
            FlowSchema(
                metadata=v1.ObjectMeta(name="exempt"),
                spec=FlowSchemaSpec(
                    priority_level_configuration="exempt",
                    matching_precedence=1,
                    rules=[FlowSchemaRule(
                        subjects=[FlowSchemaSubject(kind="Group", name="system:masters")]
                    )],
                ),
            ),
            FlowSchema(
                metadata=v1.ObjectMeta(name="catch-all"),
                spec=FlowSchemaSpec(
                    priority_level_configuration="global-default",
                    matching_precedence=10000,
                    rules=[FlowSchemaRule()],
                ),
            ),
        ):
            try:
                self.api.create("flowschemas", fs)
            except APIError:
                pass

    # -- classification -----------------------------------------------------

    def _refresh(self) -> None:
        # entirely under the lock: a racing refresh from a stale list
        # snapshot could otherwise rebuild a level from OLD config and
        # mint fresh seats while the new level's seats are held
        with self._lock:
            store_rev = self.api.store.revision
            if store_rev == self._store_rev:
                return  # fast path: no store write since the last check
            plcs, _ = self.api.list("prioritylevelconfigurations")
            schemas, _ = self.api.list("flowschemas")
            signature = (
                tuple((p.metadata.name, p.metadata.resource_version) for p in plcs),
                tuple((s.metadata.name, s.metadata.resource_version) for s in schemas),
            )
            self._store_rev = store_rev
            if signature == self._config_rev:
                return
            # rebuild only CHANGED levels: an unchanged level keeps its
            # live semaphore — replacing it would mint fresh seats while
            # requests still hold the old ones (seat-limit bypass)
            fresh = {}
            for p in plcs:
                key = (p.metadata.name, p.metadata.resource_version)
                existing = self._levels.get(p.metadata.name)
                if existing is not None and existing.config_key == key:
                    fresh[p.metadata.name] = existing
                else:
                    fresh[p.metadata.name] = _Level(p)
            self._levels = fresh
            self._schemas = sorted(
                schemas, key=lambda s: (s.spec.matching_precedence, s.metadata.name)
            )
            self._config_rev = signature

    def classify(self, req: RequestInfo) -> _Level:
        self._refresh()
        with self._lock:
            for schema in self._schemas:
                if any(_rule_matches(r, req) for r in schema.spec.rules or []):
                    level = self._levels.get(schema.spec.priority_level_configuration)
                    if level is not None:
                        return level
            fallback = self._levels.get("global-default")
        if fallback is not None:
            return fallback
        # mandatory object deleted: re-ensure the bootstrap objects (the
        # reference's apf controller continuously re-creates them)
        self.install_defaults()
        self._store_rev = None
        self._refresh()
        with self._lock:
            return self._levels["global-default"]

    # -- gating -------------------------------------------------------------

    def dispatch(self, req: RequestInfo, timeout: Optional[float] = None):
        """Context manager holding a seat for the request's level."""
        level = self.classify(req)
        controller = self

        class _Seat:
            def __enter__(self):
                level.acquire(
                    controller.default_timeout if timeout is None else timeout
                )
                return level

            def __exit__(self, *exc):
                level.release()

        return _Seat()
