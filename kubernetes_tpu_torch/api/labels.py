"""Label selector semantics.

Reimplements apimachinery label selection exactly as the scheduler consumes
it (reference: staging/src/k8s.io/apimachinery/pkg/labels/selector.go
Requirement.Matches; metav1.LabelSelectorAsSelector in
staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/helpers.go; node selector
term matching in pkg/apis/core/v1/helper/helpers.go MatchNodeSelectorTerms).

Key subtleties preserved:
  - a nil LabelSelector matches NOTHING; an empty one matches EVERYTHING
  - NotIn / DoesNotExist match when the key is absent
  - Gt/Lt parse both sides as integers and fail the match on parse error
  - node selector terms are ORed; expressions within a term are ANDed;
    a term with no expressions and no fields matches nothing
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .types import (
    LabelSelector,
    LabelSelectorRequirement,
    Node,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    Pod,
)

IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"


def requirement_matches(
    key: str, operator: str, values: Optional[List[str]], labels: Dict[str, str]
) -> bool:
    """One selector requirement against a label set (selector.go:194 Matches)."""
    values = values or []
    has = key in labels
    if operator == IN:
        return has and labels[key] in values
    if operator == NOT_IN:
        return (not has) or labels[key] not in values
    if operator == EXISTS:
        return has
    if operator == DOES_NOT_EXIST:
        return not has
    if operator in (GT, LT):
        if not has or len(values) != 1:
            return False
        lhs = _parse_int64(labels[key])
        rhs = _parse_int64(values[0])
        if lhs is None or rhs is None:
            return False
        return lhs > rhs if operator == GT else lhs < rhs
    return False


_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


def _parse_int64(s: str) -> Optional[int]:
    """strconv.ParseInt(s, 10, 64) semantics: optional sign + ASCII digits
    only (no whitespace, underscores, or unicode digits), must fit int64."""
    if not s:
        return None
    body = s[1:] if s[0] in "+-" else s
    if not body or not all("0" <= c <= "9" for c in body):
        return None
    v = int(s)
    if v < _INT64_MIN or v > _INT64_MAX:
        return None
    return v


def _split_requirements(s: str):
    """Split on commas not inside `in (...)` value parentheses."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


class Selector:
    """Compiled label selector: a conjunction of requirements.

    Mirrors labels.Selector. Use Selector.from_label_selector for the
    metav1.LabelSelector conversion (nil -> matches nothing).
    """

    __slots__ = ("requirements", "_matches_nothing")

    def __init__(self, requirements, matches_nothing: bool = False):
        self.requirements = requirements  # list of (key, op, values)
        self._matches_nothing = matches_nothing

    @classmethod
    def nothing(cls) -> "Selector":
        return cls([], matches_nothing=True)

    @classmethod
    def everything(cls) -> "Selector":
        return cls([])

    @classmethod
    def from_label_selector(cls, sel: Optional[LabelSelector]) -> "Selector":
        """metav1.LabelSelectorAsSelector (helpers.go:34)."""
        if sel is None:
            return cls.nothing()
        reqs = []
        for k, v in sorted((sel.match_labels or {}).items()):
            reqs.append((k, IN, [v]))
        for expr in sel.match_expressions or []:
            reqs.append((expr.key, expr.operator, list(expr.values or [])))
        return cls(reqs)

    @classmethod
    def from_match_labels(cls, match_labels: Optional[Dict[str, str]]) -> "Selector":
        """labels.SelectorFromSet — nil/empty set matches everything."""
        reqs = [(k, IN, [v]) for k, v in sorted((match_labels or {}).items())]
        return cls(reqs)

    @classmethod
    def parse(cls, selector: str) -> "Selector":
        """labels.Parse (selector.go:852): the string grammar used by
        `kubectl -l` / list options — comma-joined requirements of the
        forms `k=v`, `k==v`, `k!=v`, `k in (a,b)`, `k notin (a,b)`, `k`
        (exists), `!k` (does not exist), `k>n`, `k<n`."""
        import re

        set_req = re.compile(
            r"^(?P<key>\S+)\s+(?P<op>in|notin)\s*\((?P<vals>[^)]*)\)$", re.IGNORECASE
        )
        reqs = []
        for part in _split_requirements(selector):
            part = part.strip()
            if not part:
                continue
            m = set_req.match(part)
            if m:
                # the real lexer tokenizes on '(' so `k in(a,b)` is valid
                op = IN if m.group("op").lower() == "in" else NOT_IN
                values = [v.strip() for v in m.group("vals").split(",") if v.strip()]
                reqs.append((m.group("key"), op, values))
                continue
            for token, op in (("!=", NOT_IN), ("==", IN), ("=", IN), (">", GT), ("<", LT)):
                idx = part.find(token)
                if idx > 0:
                    reqs.append(
                        (part[:idx].strip(), op, [part[idx + len(token):].strip()])
                    )
                    break
            else:
                if part.startswith("!"):
                    reqs.append((part[1:].strip(), DOES_NOT_EXIST, []))
                else:
                    reqs.append((part, EXISTS, []))
        return cls(reqs)

    def matches(self, labels: Optional[Dict[str, str]]) -> bool:
        if self._matches_nothing:
            return False
        labels = labels or {}
        return all(
            requirement_matches(k, op, vals, labels) for (k, op, vals) in self.requirements
        )

    def is_everything(self) -> bool:
        return not self._matches_nothing and not self.requirements


def _node_selector_requirements_match(
    reqs: Optional[List[NodeSelectorRequirement]], labels: Dict[str, str]
) -> bool:
    return all(
        requirement_matches(r.key, r.operator, r.values, labels) for r in reqs or []
    )


def match_node_selector_terms(
    terms: Optional[List[NodeSelectorTerm]],
    node_labels: Dict[str, str],
    node_fields: Dict[str, str],
) -> bool:
    """OR over terms, AND within (helpers.go MatchNodeSelectorTerms).

    Terms with neither expressions nor fields match nothing; an overall
    empty/None term list matches nothing.
    """
    for term in terms or []:
        if not term.match_expressions and not term.match_fields:
            continue
        if not _node_selector_requirements_match(term.match_expressions, node_labels):
            continue
        if not _node_selector_requirements_match(term.match_fields, node_fields):
            continue
        return True
    return False


def node_fields(node: Node) -> Dict[str, str]:
    return {"metadata.name": node.metadata.name}


def pod_matches_node_selector_and_affinity(pod: Pod, node: Node) -> bool:
    """PodMatchesNodeSelectorAndAffinityTerms
    (reference: pkg/scheduler/framework/plugins/helper/node_affinity.go:27).

    nodeSelector (all labels must be present) AND required node affinity.
    """
    labels = node.metadata.labels or {}
    if pod.spec.node_selector:
        for k, v in pod.spec.node_selector.items():
            if labels.get(k) != v:
                return False
    affinity = pod.spec.affinity
    if (
        affinity is not None
        and affinity.node_affinity is not None
        and affinity.node_affinity.required_during_scheduling_ignored_during_execution
        is not None
    ):
        required: NodeSelector = (
            affinity.node_affinity.required_during_scheduling_ignored_during_execution
        )
        return match_node_selector_terms(
            required.node_selector_terms, labels, node_fields(node)
        )
    return True
