"""seam-pairing: fault-seam counters bump WITH a flight-recorder dump.

The PR 8 contract: when a fault seam fires (device fault, worker
restart, parity drift) the metric increment and the ring-buffer dump
must travel together, otherwise the counter says "something happened"
and the recorder has no record of it. Statically: any
``<counters>.<seam>.inc(...)`` must sit in a function that also calls
``dump_seam`` (``metrics.py`` itself, which defines the paired helper,
is exempt).
"""

from __future__ import annotations

import ast
from typing import Dict, List

from . import manifests
from .core import Violation

CHECKER = "seam-pairing"


def _seam_counter_of_inc(node: ast.Call) -> str:
    """Counter name if this is `<...>.<seam_counter>.inc(...)`, else ''."""
    func = node.func
    if not (isinstance(func, ast.Attribute) and func.attr == "inc"):
        return ""
    recv = func.value
    if isinstance(recv, ast.Attribute) and \
            recv.attr in manifests.SEAM_COUNTERS:
        return recv.attr
    if isinstance(recv, ast.Name) and recv.id in manifests.SEAM_COUNTERS:
        return recv.id
    return ""


def _calls_pair(node: ast.Call) -> bool:
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr == manifests.SEAM_PAIR_CALL
    if isinstance(func, ast.Name):
        return func.id == manifests.SEAM_PAIR_CALL
    return False


def check_file(rel: str, tree: ast.Module, src: str, scope_of,
               facts: dict) -> List[Violation]:
    if rel in manifests.SEAM_EXEMPT_MODULES:
        return []
    incs: Dict[str, List] = {}    # scope -> [(counter, line)]
    paired: Dict[str, bool] = {}  # scope -> saw dump_seam
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        scope = scope_of[node.lineno]
        counter = _seam_counter_of_inc(node)
        if counter:
            incs.setdefault(scope, []).append((counter, node.lineno))
        if _calls_pair(node):
            paired[scope] = True
    out: List[Violation] = []
    for scope, sites in sorted(incs.items()):
        if paired.get(scope):
            continue
        for counter, line in sites:
            out.append(Violation(
                CHECKER, rel, line, scope, "seam-unpaired",
                f"`{counter}.inc()` without a `dump_seam` call in the "
                "same function — seam counters must pair with a "
                "flight-recorder dump"))
    return sorted(out, key=lambda v: (v.line, v.code))
