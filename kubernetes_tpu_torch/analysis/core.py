"""ktpu-lint framework: file walking, pragmas, baseline, mtime cache.

The suite is stdlib-only (``ast`` + ``tokenize``) and never imports the
code it checks — it must run in <10s as a tier-1 pytest and cannot drag
jax in. Architecture:

  per-file phase   each checker parses one file's AST and returns
                   (violations, facts); results are cached per file
                   keyed on (mtime, size) + a tool fingerprint, so a
                   warm repo re-lints in milliseconds.
  global phase     cross-file contracts (knob registry <-> README
                   <-> env reads; the lock acquisition graph) combine
                   the per-file facts — cheap, never cached.

Pragmas: ``# ktpu: allow-<rule>(<reason>)`` on a flagged line (or the
comment line directly above it) waives that rule for that line; placed
on (or directly above) a ``def``/``class`` line it waives the rule for
the whole body — that is how audited session-build functions declare
"host syncs here are the build, not the dispatch path". Reasons are
mandatory and render in ``scripts/lint.py --explain``.

Baseline: ``analysis/baseline.json`` grandfathers pre-existing
violations by a line-number-free key (checker:path:function:code:ordinal),
so edits elsewhere in a file never churn it. The committed baseline may
only shrink: ``--update-baseline`` re-records it, and the tier-1
meta-test fails any PR whose baseline gained entries.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Tuple

from . import manifests

ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(ANALYSIS_DIR))
BASELINE_PATH = os.path.join(ANALYSIS_DIR, "baseline.json")
CACHE_PATH = os.path.join(ANALYSIS_DIR, ".lint_cache.json")

PRAGMA_RE = re.compile(r"#\s*ktpu:\s*allow-([a-z-]+)\s*\((.*)\)\s*$")

# rule names accepted in pragmas, mapped to the checker they waive
PRAGMA_RULES = ("sync", "knob", "inert", "seam", "lock")
RULE_TO_CHECKER = {
    "sync": "host-sync",
    "knob": "knob-registry",
    "inert": "decision-inert",
    "seam": "seam-pairing",
    "lock": "lock-order",
}
CHECKER_TO_RULE = {v: k for k, v in RULE_TO_CHECKER.items()}


@dataclasses.dataclass(frozen=True)
class Violation:
    checker: str
    path: str  # repo-relative, forward slashes
    line: int
    func: str  # dotted Class.method scope, or "<module>"
    code: str  # stable machine code for the pattern
    message: str
    key: str = ""  # baseline key; filled by the runner

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Violation":
        return cls(**d)


@dataclasses.dataclass
class Allowed:
    """A pragma-waived site (rendered by lint.py --explain)."""

    checker: str
    path: str
    line: int
    func: str
    code: str
    reason: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Pragmas:
    """Pragma index for one file: line waivers + def/class span waivers."""

    def __init__(self, src: str, tree: ast.Module):
        self.line_rules: Dict[int, Tuple[str, str]] = {}
        self.spans: List[Tuple[int, int, str, str]] = []
        try:
            tokens = tokenize.generate_tokens(io.StringIO(src).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = PRAGMA_RE.search(tok.string)
                if m:
                    self.line_rules[tok.start[0]] = (m.group(1), m.group(2))
        except tokenize.TokenError:
            pass
        # def/class-level spans: a pragma on the header line or the line
        # directly above it covers the whole body
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                continue
            for cand in (node.lineno, node.lineno - 1):
                hit = self.line_rules.get(cand)
                if hit:
                    self.spans.append(
                        (node.lineno, node.end_lineno or node.lineno,
                         hit[0], hit[1]))

    def waiver(self, rule: str, line: int) -> Optional[str]:
        """The reason string if `rule` is waived at `line`, else None."""
        for cand in (line, line - 1):
            hit = self.line_rules.get(cand)
            if hit and hit[0] == rule:
                return hit[1]
        for start, end, r, reason in self.spans:
            if r == rule and start <= line <= end:
                return reason
        return None


def qualified_scopes(tree: ast.Module) -> Dict[ast.AST, str]:
    """Map every function/class node to its dotted scope name."""
    out: Dict[ast.AST, str] = {}

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                name = f"{prefix}.{child.name}" if prefix else child.name
                out[child] = name
                visit(child, name)
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def enclosing_func(tree: ast.Module) -> Dict[int, str]:
    """Line -> innermost enclosing function scope ("<module>" outside)."""
    scopes = qualified_scopes(tree)
    spans: List[Tuple[int, int, str]] = []
    for node, name in scopes.items():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            spans.append((node.lineno, node.end_lineno or node.lineno, name))
    spans.sort(key=lambda s: (s[0], -(s[1] - s[0])))

    def lookup(line: int) -> str:
        best = "<module>"
        best_len = None
        for start, end, name in spans:
            if start <= line <= end:
                ln = end - start
                if best_len is None or ln <= best_len:
                    best, best_len = name, ln
        return best

    return _LineScopeMap(lookup)


class _LineScopeMap(dict):
    def __init__(self, lookup):
        super().__init__()
        self._lookup = lookup

    def __missing__(self, line):
        v = self._lookup(line)
        self[line] = v
        return v


# ---------------------------------------------------------------------------
# file discovery


def iter_py_files(root: str = REPO_ROOT) -> Iterable[str]:
    """Repo-relative paths of every package .py file, sorted."""
    pkg = os.path.join(root, "kubernetes_tpu")
    # the port lints its own PACKAGE (manifests.PACKAGE), not the reference
    pkg = os.path.join(root, manifests.PACKAGE)
    out = []
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if fn.endswith(".py"):
                full = os.path.join(dirpath, fn)
                out.append(os.path.relpath(full, root).replace(os.sep, "/"))
    return sorted(out)


# ---------------------------------------------------------------------------
# baseline


def load_baseline(path: Optional[str] = None) -> Dict[str, str]:
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return dict(data.get("entries", {}))


def save_baseline(entries: Dict[str, str],
                  path: Optional[str] = None) -> None:
    path = path or BASELINE_PATH
    body = {
        "comment": (
            "Grandfathered ktpu-lint violations. Keys are "
            "checker:path:scope:code:ordinal (line-free, edit-stable). "
            "This file may ONLY shrink: fix or pragma the site, then "
            "run scripts/lint.py --update-baseline. The tier-1 "
            "meta-test rejects any PR that grows it."
        ),
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    # the port's baseline names the port's CLI (manifests.CLI)
    body["comment"] = body["comment"].replace("scripts/lint.py", manifests.CLI)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(body, f, indent=2, sort_keys=False)
        f.write("\n")


# ---------------------------------------------------------------------------
# cache


def _tool_fingerprint() -> str:
    h = hashlib.sha1()
    for fn in sorted(os.listdir(ANALYSIS_DIR)):
        if fn.endswith(".py"):
            full = os.path.join(ANALYSIS_DIR, fn)
            st = os.stat(full)
            h.update(f"{fn}:{st.st_mtime_ns}:{st.st_size};".encode())
    return h.hexdigest()


def load_cache() -> dict:
    try:
        with open(CACHE_PATH, "r", encoding="utf-8") as f:
            cache = json.load(f)
    except (OSError, ValueError):
        return {"fingerprint": "", "files": {}}
    if cache.get("fingerprint") != _tool_fingerprint():
        return {"fingerprint": "", "files": {}}
    return cache


def save_cache(cache: dict) -> None:
    cache["fingerprint"] = _tool_fingerprint()
    try:
        with open(CACHE_PATH, "w", encoding="utf-8") as f:
            json.dump(cache, f)
    except OSError:
        pass  # read-only checkout: the cache is an optimization only


# ---------------------------------------------------------------------------
# runner


@dataclasses.dataclass
class Report:
    violations: List[Violation]        # actionable (not baselined)
    baselined: List[Violation]         # matched a baseline entry
    allowed: List[Allowed]             # pragma-waived sites
    stale_baseline: List[str]          # baseline keys with no live match
    files_checked: int = 0
    files_from_cache: int = 0

    @property
    def clean(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return {
            "clean": self.clean,
            "violations": [v.to_json() for v in self.violations],
            "baselined": [v.to_json() for v in self.baselined],
            "allowed": [a.to_json() for a in self.allowed],
            "stale_baseline": list(self.stale_baseline),
            "files_checked": self.files_checked,
            "files_from_cache": self.files_from_cache,
        }


def _assign_keys(violations: List[Violation]) -> List[Violation]:
    """Stable per-(checker,path,scope,code) ordinals — line-free keys."""
    counters: Dict[Tuple[str, str, str, str], int] = {}
    out = []
    for v in sorted(violations, key=lambda v: (v.path, v.line, v.code)):
        ident = (v.checker, v.path, v.func, v.code)
        n = counters.get(ident, 0)
        counters[ident] = n + 1
        key = f"{v.checker}:{v.path}:{v.func}:{v.code}:{n}"
        out.append(dataclasses.replace(v, key=key))
    return out


def run(root: str = REPO_ROOT, *, use_cache: bool = True,
        paths: Optional[List[str]] = None) -> Report:
    """Run every checker over the package; returns the full Report."""
    # imported here so `import core` never cycles with checker modules
    from . import (decision_inert, host_sync, knob_registry, lock_order,
                   seam_pairing)

    file_checkers = (host_sync, knob_registry, decision_inert, seam_pairing,
                     lock_order)

    cache = load_cache() if use_cache else {"fingerprint": "", "files": {}}
    cached_files: dict = cache.setdefault("files", {})

    raw: List[Violation] = []
    allowed: List[Allowed] = []
    all_facts: Dict[str, dict] = {}
    from_cache = 0

    rels = list(paths) if paths is not None else list(iter_py_files(root))
    for rel in rels:
        full = os.path.join(root, rel)
        st = os.stat(full)
        stamp = [st.st_mtime_ns, st.st_size]
        entry = cached_files.get(rel)
        if use_cache and entry and entry.get("stamp") == stamp:
            raw.extend(Violation.from_json(d) for d in entry["violations"])
            allowed.extend(Allowed(**d) for d in entry["allowed"])
            all_facts[rel] = entry["facts"]
            from_cache += 1
            continue
        with open(full, "r", encoding="utf-8") as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as e:
            raw.append(Violation(
                checker="parse", path=rel, line=e.lineno or 0,
                func="<module>", code="syntax-error",
                message=f"file does not parse: {e.msg}"))
            all_facts[rel] = {}
            continue
        pragmas = Pragmas(src, tree)
        scope_of = enclosing_func(tree)
        facts: dict = {}
        file_viol: List[Violation] = []
        file_allowed: List[Allowed] = []
        for checker in file_checkers:
            found = checker.check_file(rel, tree, src, scope_of, facts)
            rule = CHECKER_TO_RULE[checker.CHECKER]
            for v in found:
                reason = pragmas.waiver(rule, v.line)
                if reason is not None:
                    file_allowed.append(Allowed(
                        checker=v.checker, path=v.path, line=v.line,
                        func=v.func, code=v.code, reason=reason))
                else:
                    file_viol.append(v)
        raw.extend(file_viol)
        allowed.extend(file_allowed)
        all_facts[rel] = facts
        cached_files[rel] = {
            "stamp": stamp,
            "violations": [v.to_json() for v in file_viol],
            "allowed": [a.to_json() for a in file_allowed],
            "facts": facts,
        }

    # drop cache entries for deleted files
    for gone in set(cached_files) - set(rels):
        if paths is None:
            cached_files.pop(gone, None)

    # global phase (cross-file contracts; never cached)
    raw.extend(knob_registry.check_global(root, all_facts))
    raw.extend(lock_order.check_global(root, all_facts))

    if use_cache:
        save_cache(cache)

    keyed = _assign_keys(raw)
    baseline = load_baseline()
    actionable = [v for v in keyed if v.key not in baseline]
    grandfathered = [v for v in keyed if v.key in baseline]
    live_keys = {v.key for v in keyed}
    stale = [k for k in sorted(baseline) if k not in live_keys]
    return Report(
        violations=actionable,
        baselined=grandfathered,
        allowed=allowed,
        stale_baseline=stale,
        files_checked=len(rels),
        files_from_cache=from_cache,
    )


def update_baseline(root: str = REPO_ROOT) -> Report:
    """Re-record the baseline to exactly the current violation set."""
    report = run(root, use_cache=False)
    entries = {
        v.key: v.message
        for v in list(report.violations) + list(report.baselined)
    }
    save_baseline(entries)
    return run(root, use_cache=False)
