"""HTTP scheduler extender: out-of-tree Filter/Prioritize/Bind webhooks.

Reference: pkg/scheduler/core/extender.go:42 HTTPExtender (:273 Filter,
:343 Prioritize, :380 Bind, :412 send — POST JSON per verb) and the wire
types staging/src/k8s.io/kube-scheduler/extender/v1/types.go:71
ExtenderArgs {pod, nodes|nodenames}, :86 ExtenderFilterResult
{nodes|nodenames, failedNodes, error}, :118 HostPriority {host, score},
ExtenderBindingArgs {podName, podNamespace, podUID, node}.

nodeCacheCapable extenders receive/return node NAMES only; otherwise full
node objects travel (exactly the reference's two modes).
"""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, List, Optional, Tuple

from ..api import types as v1
from ..utils import serde
from .apis.config import Extender as ExtenderConfig


class ExtenderError(Exception):
    pass


class HTTPExtender:
    def __init__(self, cfg: ExtenderConfig, opener=None):
        self.cfg = cfg
        self._opener = opener or urllib.request.urlopen

    @property
    def name(self) -> str:
        return self.cfg.url_prefix

    @property
    def ignorable(self) -> bool:
        return self.cfg.ignorable

    # -- interest (extender.go:441 IsInterested) ---------------------------

    def is_interested(self, pod: v1.Pod) -> bool:
        if not self.cfg.managed_resources:
            return True
        managed = set(self.cfg.managed_resources)
        for c in list(pod.spec.containers) + list(pod.spec.init_containers or []):
            for res in (c.resources.requests or {}, c.resources.limits or {}):
                if managed.intersection(res):
                    return True
        return False

    # -- verbs -------------------------------------------------------------

    def filter(
        self, pod: v1.Pod, nodes: List[v1.Node]
    ) -> Tuple[List[v1.Node], Dict[str, str]]:
        """(feasible nodes, failed {node: reason}); extender.go:273."""
        if not self.cfg.filter_verb:
            return nodes, {}
        args = self._args(pod, nodes)
        result = self._send(self.cfg.filter_verb, args)
        if result.get("error"):
            raise ExtenderError(result["error"])
        failed = result.get("failedNodes") or {}
        if self.cfg.node_cache_capable:
            names = result.get("nodenames")
            if names is None:
                kept = [n for n in nodes if n.metadata.name not in failed]
            else:
                keep = set(names)
                kept = [n for n in nodes if n.metadata.name in keep]
        else:
            items = (result.get("nodes") or {}).get("items", None)
            if items is None:
                kept = [n for n in nodes if n.metadata.name not in failed]
            else:
                kept = [serde.from_dict(v1.Node, item) for item in items]
        return kept, dict(failed)

    def prioritize(
        self, pod: v1.Pod, nodes: List[v1.Node]
    ) -> Tuple[List[Dict], int]:
        """(HostPriorityList, weight); extender.go:343."""
        if not self.cfg.prioritize_verb:
            return [{"host": n.metadata.name, "score": 0} for n in nodes], 0
        args = self._args(pod, nodes)
        result = self._send(self.cfg.prioritize_verb, args)
        return list(result or []), self.cfg.weight

    def bind(self, pod: v1.Pod, node_name: str) -> None:
        """extender.go:380 Bind."""
        if not self.cfg.bind_verb:
            raise ExtenderError("extender has no bind verb")
        args = {
            "podName": pod.metadata.name,
            "podNamespace": pod.metadata.namespace,
            "podUID": pod.metadata.uid,
            "node": node_name,
        }
        result = self._send(self.cfg.bind_verb, args)
        if result and result.get("error"):
            raise ExtenderError(result["error"])

    def supports_bind(self) -> bool:
        return bool(self.cfg.bind_verb)

    def supports_preemption(self) -> bool:
        return bool(self.cfg.preempt_verb)

    # -- wire --------------------------------------------------------------

    def _args(self, pod: v1.Pod, nodes: List[v1.Node]) -> Dict:
        args: Dict = {"pod": serde.to_dict(pod)}
        if self.cfg.node_cache_capable:
            args["nodenames"] = [n.metadata.name for n in nodes]
        else:
            args["nodes"] = {"items": [serde.to_dict(n) for n in nodes]}
        return args

    def _send(self, verb: str, args: Dict):
        url = f"{self.cfg.url_prefix.rstrip('/')}/{verb}"
        req = urllib.request.Request(
            url,
            data=json.dumps(args).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with self._opener(req, timeout=self.cfg.http_timeout_seconds) as resp:
            return json.loads(resp.read().decode())
