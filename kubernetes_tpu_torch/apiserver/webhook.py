"""Admission webhooks: external mutate/validate over real HTTP.

Reference: staging/src/k8s.io/apiserver/pkg/admission/plugin/webhook —
Mutating/ValidatingWebhookConfiguration objects declare per-rule hooks;
the apiserver POSTs an admission/v1 AdmissionReview {request: {uid,
resource, operation, object}} to each matching webhook
(mutating/dispatcher.go, validating/dispatcher.go); mutating responses
carry a base64 JSONPatch (patchType: JSONPatch) applied before the next
webhook; a denial (allowed: false) rejects the request; connection
failures honor failurePolicy Fail|Ignore.

WebhookAdmission registers one mutating + one validating hook on the
APIServer chain and dispatches to the configurations stored in the
cluster (so kubectl/apply manage them like the reference).
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..api import types as v1
from ..utils import serde
from .server import APIServer, Invalid, ResourceInfo

ALL = "*"


@dataclass
class WebhookClientConfig:
    url: str = ""


@dataclass
class RuleWithOperations:
    operations: Optional[List[str]] = None  # CREATE | UPDATE | DELETE | *
    resources: Optional[List[str]] = None   # plural names or *


@dataclass
class Webhook:
    name: str = ""
    client_config: WebhookClientConfig = field(default_factory=WebhookClientConfig)
    rules: Optional[List[RuleWithOperations]] = None
    failure_policy: str = "Fail"  # Fail | Ignore
    timeout_seconds: int = 10


@dataclass
class MutatingWebhookConfiguration:
    metadata: v1.ObjectMeta = field(default_factory=v1.ObjectMeta)
    webhooks: Optional[List[Webhook]] = None
    kind: str = "MutatingWebhookConfiguration"
    api_version: str = "admissionregistration.k8s.io/v1"


@dataclass
class ValidatingWebhookConfiguration:
    metadata: v1.ObjectMeta = field(default_factory=v1.ObjectMeta)
    webhooks: Optional[List[Webhook]] = None
    kind: str = "ValidatingWebhookConfiguration"
    api_version: str = "admissionregistration.k8s.io/v1"


def _rule_matches(rules: Optional[List[RuleWithOperations]], resource: str, op: str) -> bool:
    for rule in rules or []:
        ops = rule.operations or [ALL]
        res = rule.resources or [ALL]
        if any(o == ALL or o == op for o in ops) and any(
            r == ALL or r == resource for r in res
        ):
            return True
    return False


def apply_json_patch(doc: Any, patch: List[Dict]) -> Any:
    """RFC 6902 subset: add / replace / remove with object+array paths
    (what admission webhooks emit; apimachinery uses evanphx/json-patch)."""

    def resolve(parts: List[str]):
        parent = None
        cur = doc
        for raw in parts:
            key = raw.replace("~1", "/").replace("~0", "~")
            parent = cur
            if isinstance(cur, list):
                cur = cur[int(key)] if key != "-" else None
            else:
                cur = cur.get(key) if isinstance(cur, dict) else None
            yield parent, key, cur

    for op in patch:
        parts = [p for p in op["path"].split("/")[1:]]
        walked = list(resolve(parts))
        parent, key, _ = walked[-1]
        kind = op["op"]
        if kind in ("add", "replace"):
            value = op["value"]
            if isinstance(parent, list):
                if key == "-":
                    parent.append(value)
                elif kind == "add":
                    parent.insert(int(key), value)
                else:
                    parent[int(key)] = value
            else:
                parent[key] = value
        elif kind == "remove":
            if isinstance(parent, list):
                del parent[int(key)]
            else:
                parent.pop(key, None)
        else:
            raise Invalid(f"unsupported JSONPatch op {kind!r}")
    return doc


class WebhookAdmission:
    """Dispatches stored webhook configurations on every write."""

    def __init__(self, api: APIServer):
        self.api = api

    def install(self) -> "WebhookAdmission":
        self.api.register_resource(
            ResourceInfo(
                "mutatingwebhookconfigurations", MutatingWebhookConfiguration, False
            )
        )
        self.api.register_resource(
            ResourceInfo(
                "validatingwebhookconfigurations",
                ValidatingWebhookConfiguration,
                False,
            )
        )
        self.api._mutating.append(self._mutate)
        self.api._validating.append(self._validate)
        return self

    # -- dispatch -----------------------------------------------------------

    def _configs(self, resource_name: str):
        try:
            items, _ = self.api.list(resource_name)
        except Exception:  # noqa: BLE001
            return []
        return items

    def _call(self, hook: Webhook, resource: str, op: str, obj: Any) -> Dict:
        review = {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "request": {
                "uid": str(uuid.uuid4()),
                "resource": {"resource": resource},
                "operation": op,
                "object": serde.to_dict(obj),
            },
        }
        req = urllib.request.Request(
            hook.client_config.url,
            data=json.dumps(review).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=hook.timeout_seconds) as resp:
            body = json.loads(resp.read())
        response = body.get("response")
        if not isinstance(response, dict):
            # malformed AdmissionReview = call failure, routed through
            # failurePolicy (NOT a denial)
            raise OSError("malformed AdmissionReview response (no response object)")
        return response

    def _dispatch(self, configs, resource: str, op: str, obj: Any, mutating: bool) -> None:
        if resource in (
            "mutatingwebhookconfigurations",
            "validatingwebhookconfigurations",
        ):
            return  # never webhook the webhook configs themselves
        for cfg in configs:
            for hook in cfg.webhooks or []:
                if not _rule_matches(hook.rules, resource, op):
                    continue
                try:
                    response = self._call(hook, resource, op, obj)
                except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
                    if hook.failure_policy == "Ignore":
                        continue
                    raise Invalid(
                        f'failed calling webhook "{hook.name}": {e}'
                    )
                if not response.get("allowed", False):
                    msg = (response.get("status") or {}).get(
                        "message", "admission webhook denied the request"
                    )
                    raise Invalid(f'admission webhook "{hook.name}" denied: {msg}')
                if mutating and response.get("patch"):
                    if response.get("patchType") != "JSONPatch":
                        raise Invalid(
                            f'webhook "{hook.name}": unsupported patchType'
                        )
                    patch = json.loads(base64.b64decode(response["patch"]))
                    doc = apply_json_patch(serde.to_dict(obj), patch)
                    info = self.api._info(resource)
                    fresh = serde.from_dict(info.type, doc)
                    # mutate in place WITHOUT replacing obj.metadata: the
                    # create path holds a `meta = obj.metadata` alias it
                    # stamps uid/creationTimestamp onto after admission
                    for attr, value in fresh.__dict__.items():
                        if attr == "metadata":
                            obj.metadata.__dict__.update(value.__dict__)
                        else:
                            setattr(obj, attr, value)

    def _mutate(self, resource: str, op: str, obj: Any) -> None:
        self._dispatch(
            self._configs("mutatingwebhookconfigurations"), resource, op, obj, True
        )

    def _validate(self, resource: str, op: str, obj: Any) -> None:
        self._dispatch(
            self._configs("validatingwebhookconfigurations"), resource, op, obj, False
        )
