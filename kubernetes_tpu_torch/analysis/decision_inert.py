"""decision-inert: observability modules cannot mutate scheduling state.

Modules listed in ``manifests.DECISION_INERT_MODULES`` (tracing,
devtime, selfstats, explain) exist to watch the scheduler, never to
steer it — a trace path that can change a placement is the bug class
the shadow-audit work explicitly promised away. Two rules:

  inert-deny-import    the module imports (absolutely or relatively)
                       anything under the mutating scheduling-state
                       surface (``manifests.INERT_DENY_IMPORTS``)
  inert-mutation-call  the module calls a mutating carry/session/cache
                       API by name (``manifests.INERT_DENY_CALLS``),
                       regardless of how the receiver was obtained
"""

from __future__ import annotations

import ast
from typing import List

from . import manifests
from .core import Violation

CHECKER = "decision-inert"


def _resolve_relative(rel: str, level: int, module: str) -> str:
    """Dotted absolute module for a `from ...x import y` in file `rel`."""
    pkg_parts = rel.rsplit("/", 1)[0].split("/")  # containing package
    if level > 1:
        pkg_parts = pkg_parts[:len(pkg_parts) - (level - 1)]
    base = ".".join(pkg_parts)
    return f"{base}.{module}" if module else base


def _denied(dotted: str) -> bool:
    for prefix in manifests.INERT_DENY_IMPORTS:
        if dotted == prefix or dotted.startswith(prefix + "."):
            return True
    return False


def check_file(rel: str, tree: ast.Module, src: str, scope_of,
               facts: dict) -> List[Violation]:
    if rel not in manifests.DECISION_INERT_MODULES:
        return []
    out: List[Violation] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _denied(alias.name):
                    out.append(Violation(
                        CHECKER, rel, node.lineno, scope_of[node.lineno],
                        "inert-deny-import",
                        f"observability module imports `{alias.name}` "
                        "(mutating scheduling-state surface)"))
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = _resolve_relative(rel, node.level, node.module or "")
            else:
                base = node.module or ""
            for alias in node.names:
                dotted = f"{base}.{alias.name}" if base else alias.name
                if _denied(base) or _denied(dotted):
                    out.append(Violation(
                        CHECKER, rel, node.lineno, scope_of[node.lineno],
                        "inert-deny-import",
                        f"observability module imports `{dotted}` "
                        "(mutating scheduling-state surface)"))
        elif isinstance(node, ast.Call):
            name = ""
            if isinstance(node.func, ast.Attribute):
                name = node.func.attr
            elif isinstance(node.func, ast.Name):
                name = node.func.id
            if name in manifests.INERT_DENY_CALLS:
                out.append(Violation(
                    CHECKER, rel, node.lineno, scope_of[node.lineno],
                    "inert-mutation-call",
                    f"observability module calls mutating API "
                    f"`{name}()`"))
    return sorted(out, key=lambda v: (v.line, v.code))
