"""lock-order: the static half of the lock-order discipline.

Per file, every function's ``with <lock>:`` nesting is extracted (a
with-context whose terminal name looks lock-ish per
``manifests.LOCK_NAME_RE`` counts as an acquisition; ``self.X`` inside
class ``C`` is canonicalised to ``C.X`` so all methods of a class share
lock nodes). Direct nesting contributes held->acquired edges; calls
made while holding a lock are recorded and resolved one level within
the same file (with a fixpoint closure over the intra-file call graph),
so ``with self._lock: self._helper()`` picks up locks the helper takes.

Globally the edges form one acquisition graph; any cycle (two locks
taken in both orders somewhere in the codebase) is a potential deadlock
and fails the lint. Self-edges are ignored — re-entrant acquisition is
RLock territory, not an ordering bug. The dynamic twin of this checker
is ``kubernetes_tpu/testing/locks.py``, which asserts the same property
over the orders actually observed in the chaos/endurance suites.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from . import manifests
from .core import Violation

CHECKER = "lock-order"


def _lock_label(expr: ast.AST, scope: str) -> Optional[str]:
    """Canonical label if `expr` is a lock acquisition context."""
    if isinstance(expr, ast.Name):
        name = expr.id
        if name in manifests.LOCK_NAME_DENY:
            return None
        if manifests.LOCK_NAME_RE.search(name):
            return name
        return None
    if isinstance(expr, ast.Attribute):
        attr = expr.attr
        if not manifests.LOCK_NAME_RE.search(attr):
            return None
        if isinstance(expr.value, ast.Name):
            base = expr.value.id
            if base == "self":
                # C.method scope -> class-qualified lock name
                cls = scope.split(".")[0] if "." in scope else scope
                return f"{cls}.{attr}"
            return f"{base}.{attr}"
        return attr
    return None


class _FuncLocks(ast.NodeVisitor):
    """Walks one function body tracking the held-lock stack."""

    def __init__(self, scope: str):
        self.scope = scope
        self.held: List[str] = []
        self.acquires: List[List] = []  # [label, line]
        self.edges: List[List] = []     # [held, acquired, line]
        self.calls: List[List] = []     # [callee, [held...], line]

    def visit_With(self, node):  # noqa: N802 (ast visitor API)
        self._with(node)

    def visit_AsyncWith(self, node):  # noqa: N802
        self._with(node)

    def _with(self, node) -> None:
        labels = []
        for item in node.items:
            label = _lock_label(item.context_expr, self.scope)
            if label is not None:
                self.acquires.append([label, node.lineno])
                for h in self.held:
                    if h != label:
                        self.edges.append([h, label, node.lineno])
                self.held.append(label)
                labels.append(label)
        for stmt in node.body:
            self.visit(stmt)
        for _ in labels:
            self.held.pop()

    def visit_Call(self, node):  # noqa: N802
        if self.held:
            callee = ""
            if isinstance(node.func, ast.Attribute):
                callee = node.func.attr
            elif isinstance(node.func, ast.Name):
                callee = node.func.id
            if callee:
                self.calls.append([callee, list(self.held), node.lineno])
        self.generic_visit(node)

    # nested defs get their own _FuncLocks pass; don't descend here
    def visit_FunctionDef(self, node):  # noqa: N802
        pass

    def visit_AsyncFunctionDef(self, node):  # noqa: N802
        pass

    def visit_Lambda(self, node):  # noqa: N802
        pass


def check_file(rel: str, tree: ast.Module, src: str, scope_of,
               facts: dict) -> List[Violation]:
    functions: Dict[str, dict] = {}
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        scope = scope_of[node.lineno]
        walker = _FuncLocks(scope)
        for stmt in node.body:
            walker.visit(stmt)
        if walker.acquires or walker.calls:
            functions[scope] = {
                "acquires": walker.acquires,
                "edges": walker.edges,
                "calls": walker.calls,
            }
    if functions:
        facts["locks"] = functions
    return []


def _closure(functions: Dict[str, dict]) -> Dict[str, Set[str]]:
    """Fixpoint: locks each function may acquire, via same-file calls."""
    by_last: Dict[str, List[str]] = {}
    for scope in functions:
        by_last.setdefault(scope.split(".")[-1], []).append(scope)
    acq: Dict[str, Set[str]] = {
        scope: {a for a, _ in info["acquires"]}
        for scope, info in functions.items()
    }
    changed = True
    while changed:
        changed = False
        for scope, info in functions.items():
            for callee, _held, _line in info["calls"]:
                for target in by_last.get(callee, ()):
                    extra = acq[target] - acq[scope]
                    if extra:
                        acq[scope] |= extra
                        changed = True
    return acq


def check_global(root: str, all_facts: dict) -> List[Violation]:
    # edge -> one example (path, line) site
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for rel, facts in sorted(all_facts.items()):
        functions = facts.get("locks")
        if not functions:
            continue
        for scope, info in functions.items():
            for a, b, line in info["edges"]:
                edges.setdefault((a, b), (rel, line))
        closure = _closure(functions)
        for scope, info in functions.items():
            for callee, held, line in info["calls"]:
                for target, locks in closure.items():
                    if target.split(".")[-1] != callee:
                        continue
                    for lock in locks:
                        for h in held:
                            if h != lock:
                                edges.setdefault((h, lock), (rel, line))

    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())

    cycles = _find_cycles(graph)
    out: List[Violation] = []
    for cycle in cycles:
        sites = []
        for i, a in enumerate(cycle):
            b = cycle[(i + 1) % len(cycle)]
            site = edges.get((a, b))
            if site:
                sites.append(f"{a}->{b} at {site[0]}:{site[1]}")
        path, line = edges.get((cycle[0], cycle[1 % len(cycle)]),
                               ("<global>", 0))
        out.append(Violation(
            CHECKER, path, line, "<global>", "lock-cycle",
            "lock acquisition cycle: " + " -> ".join(cycle + [cycle[0]]) +
            " (" + "; ".join(sites) + ")"))
    return out


def _find_cycles(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Distinct elementary cycles, canonicalised (rotation-minimal)."""
    seen: Set[Tuple[str, ...]] = set()
    cycles: List[List[str]] = []

    def dfs(node: str, stack: List[str], on_stack: Set[str]):
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_stack:
                i = stack.index(nxt)
                cyc = stack[i:]
                k = cyc.index(min(cyc))
                canon = tuple(cyc[k:] + cyc[:k])
                if canon not in seen:
                    seen.add(canon)
                    cycles.append(list(canon))
            elif len(stack) < 12:  # bounded: lock graphs are tiny
                stack.append(nxt)
                on_stack.add(nxt)
                dfs(nxt, stack, on_stack)
                on_stack.discard(nxt)
                stack.pop()

    for start in sorted(graph):
        dfs(start, [start], {start})
    return cycles
