"""knob-registry: every KTPU_* env read routes through utils/knobs.py.

Per-file: any direct ``os.environ[...]`` / ``os.environ.get`` /
``os.getenv`` READ of a ``KTPU_*`` name outside ``utils/knobs.py`` is
flagged (writes — Store/Del subscripts, ``.pop``, ``.setdefault`` used
by test harnesses to inject config — stay legal; only reads bypass the
registry). Reads through the ``knobs.get_*`` accessors are recorded as
facts.

Global: cross-references three sources and fails on any disagreement —
the accessor reads across the package, the ``Knob(...)`` declarations
in ``utils/knobs.py``, and the ``KTPU_*`` tokens in the README knob
table. A knob read but never declared would raise KeyError at runtime;
a knob declared but absent from the README means the table drifted; a
README token that is not a declared knob is stale documentation.

The port's copy reads the README's port knob table alone, the lines
between manifests.KNOB_TABLE_BEGIN and KNOB_TABLE_END (the reference's
table, above it, declares knobs the port does not read); a README
without that span is read whole.
"""

from __future__ import annotations

import ast
import dataclasses  # the port's KNOB_TABLE message
import os
from typing import List

from . import manifests
from .core import Violation

CHECKER = "knob-registry"

_ENV_ATTRS = frozenset({"environ"})
_READ_METHODS = frozenset({"get"})


def _is_environ(node: ast.AST) -> bool:
    """True for `os.environ` / bare `environ` attribute chains."""
    if isinstance(node, ast.Attribute) and node.attr in _ENV_ATTRS:
        return True
    if isinstance(node, ast.Name) and node.id in _ENV_ATTRS:
        return True
    return False


def _const_knob(node: ast.AST) -> str:
    """The KTPU_* literal if `node` is one, else ''."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str) and \
            node.value.startswith(manifests.KNOB_PREFIX):
        return node.value
    return ""


def check_file(rel: str, tree: ast.Module, src: str, scope_of,
               facts: dict) -> List[Violation]:
    out: List[Violation] = []
    reads = []  # [name, line, scope] for accessor reads (facts)
    is_registry = rel == manifests.KNOBS_MODULE
    for node in ast.walk(tree):
        # os.environ["KTPU_X"] in Load context
        if isinstance(node, ast.Subscript) and _is_environ(node.value) and \
                isinstance(node.ctx, ast.Load):
            name = _const_knob(node.slice)
            if name and not is_registry:
                out.append(Violation(
                    CHECKER, rel, node.lineno, scope_of[node.lineno],
                    "env-read",
                    f"direct os.environ read of {name}; use "
                    "utils/knobs.py accessors"))
        elif isinstance(node, ast.Call):
            func = node.func
            # os.environ.get("KTPU_X") — .pop/.setdefault are writes
            if isinstance(func, ast.Attribute) and \
                    func.attr in _READ_METHODS and \
                    _is_environ(func.value) and node.args:
                name = _const_knob(node.args[0])
                if name and not is_registry:
                    out.append(Violation(
                        CHECKER, rel, node.lineno, scope_of[node.lineno],
                        "env-read",
                        f"os.environ.get read of {name}; use "
                        "utils/knobs.py accessors"))
            # os.getenv("KTPU_X") / getenv("KTPU_X")
            elif ((isinstance(func, ast.Attribute) and func.attr == "getenv")
                  or (isinstance(func, ast.Name) and func.id == "getenv")) \
                    and node.args:
                name = _const_knob(node.args[0])
                if name and not is_registry:
                    out.append(Violation(
                        CHECKER, rel, node.lineno, scope_of[node.lineno],
                        "env-read",
                        f"os.getenv read of {name}; use "
                        "utils/knobs.py accessors"))
            # knobs.get_*("KTPU_X") accessor reads -> facts
            elif isinstance(func, ast.Attribute) and \
                    func.attr.startswith("get_") and \
                    isinstance(func.value, ast.Name) and \
                    func.value.id in ("knobs", "_knobs") and node.args:
                name = _const_knob(node.args[0])
                if name:
                    reads.append([name, node.lineno, scope_of[node.lineno]])
    facts["knob_reads"] = reads
    return out


def _declared_knobs(root: str) -> dict:
    """Knob names declared in utils/knobs.py -> declaration line."""
    path = os.path.join(root, manifests.KNOBS_MODULE)
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=manifests.KNOBS_MODULE)
    declared = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id in ("Knob", "_declare"):
            name = ""
            if node.args:
                name = _const_knob(node.args[0])
            for kw in node.keywords:
                if kw.arg == "name":
                    name = _const_knob(kw.value)
            if name:
                declared[name] = node.lineno
    return declared


def _knob_table_span(text: str) -> str:
    """The README text between the port's KNOB_TABLE markers, or the
    whole text when the README has no such span."""
    begin = text.find(manifests.KNOB_TABLE_BEGIN)
    end = text.find(manifests.KNOB_TABLE_END, begin + 1)
    if begin < 0 or end < 0:
        return text
    return text[begin + len(manifests.KNOB_TABLE_BEGIN):end]


def _knob_table_file(f):
    """The README file `f` as a file of its KNOB_TABLE span alone."""
    import io

    return io.StringIO(_knob_table_span(f.read()))


def check_global(root: str, all_facts: dict) -> List[Violation]:
    out: List[Violation] = []
    declared = _declared_knobs(root)

    # accessor reads of undeclared knobs (KeyError at runtime)
    for rel, facts in sorted(all_facts.items()):
        for name, line, scope in facts.get("knob_reads", ()):
            if name not in declared:
                out.append(Violation(
                    CHECKER, rel, line, scope, "undeclared-knob",
                    f"{name} read via knobs accessor but not declared "
                    "in utils/knobs.py"))

    # README knob table must cover every declared knob, and mention no
    # stale ones
    readme_path = os.path.join(root, manifests.README)
    readme_tokens = set()
    if os.path.exists(readme_path):
        with open(readme_path, "r", encoding="utf-8") as f:
            f = _knob_table_file(f)  # the port's KNOB_TABLE span only
            readme_tokens = set(manifests.KNOB_TOKEN_RE.findall(f.read()))
    for name in sorted(declared):
        if name not in readme_tokens:
            out.append(Violation(
                CHECKER, manifests.README, 1, "<module>",
                "knob-missing-readme",
                f"{name} is declared in utils/knobs.py but absent from "
                "the README knob table (regenerate with "
                "scripts/lint.py --knob-table)"))
            # the port's KNOB_TABLE is rendered by the port's CLI
            out[-1] = dataclasses.replace(out[-1], message=out[-1].message
                                          .replace("scripts/lint.py",
                                                   manifests.CLI))
    for token in sorted(readme_tokens):
        if token not in declared:
            out.append(Violation(
                CHECKER, manifests.README, 1, "<module>",
                "knob-unknown-readme",
                f"README mentions {token}, which is not a declared knob"))
    return out
