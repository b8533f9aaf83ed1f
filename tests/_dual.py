"""A reference test module's cases, run against either package.

`module_for(name, package)` executes tests/<name>.py (and the tests/util.py
it imports) with every `kubernetes_tpu` import pointed at `package`, as a
module of its own; `cases(name)` lists the module's test functions and
test methods (with their `parametrize` values expanded), and `run_case`
runs one case of the module for one package: its module- and class-level
fixtures resolved here (generators torn down after the case), pytest's own
(`tmp_path`, `monkeypatch`, ...) through `request`.

tests/test_torch_http.py and tests/test_torch_apiserver_tail.py
parametrize each case over both packages, so the reference's own cases
hold the port's copies of its modules to the same behaviour."""

from __future__ import annotations

import inspect
import re
import sys
import types
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")
_HERE = Path(__file__).resolve().parent
_REF = re.compile(r"\bkubernetes_tpu\b")


def module_for(name: str, package: str) -> types.ModuleType:
    modname = f"tests._dual_{package}_{name}"
    mod = sys.modules.get(modname)
    if mod is not None:
        return mod
    if name != "util":
        module_for("util", package)
    path = _HERE / f"{name}.py"
    src = _REF.sub(package, path.read_text())
    src = src.replace("from .util import",
                      f"from tests._dual_{package}_util import")
    mod = types.ModuleType(modname)
    mod.__file__ = str(path)
    mod.__package__ = "tests"
    sys.modules[modname] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


@dataclass(frozen=True)
class Case:
    module: str
    cls: Optional[str]
    func: str
    params: Dict = field(default_factory=dict, hash=False, compare=False)
    pid: str = ""

    @property
    def id(self) -> str:
        head = "::".join(x for x in (self.module, self.cls, self.func) if x)
        return head + (f"[{self.pid}]" if self.pid else "")


def _expand(module, cls, name, func):
    marks = [m for m in getattr(func, "pytestmark", [])
             if m.name == "parametrize"]
    if not marks:
        return [Case(module, cls, name)]
    (mark,) = marks
    names = [n.strip() for n in mark.args[0].split(",")]
    values = list(mark.args[1])
    ids = mark.kwargs.get("ids") or [str(v) for v in values]
    out = []
    for v, pid in zip(values, ids):
        v = v if len(names) > 1 else (v,)
        out.append(Case(module, cls, name, dict(zip(names, v)), str(pid)))
    return out


def cases(name: str, skip=()) -> list:
    """The reference module's cases in definition order, less those whose
    id is in `skip`."""
    mod = module_for(name, PACKAGES[0])
    out = []
    for attr, obj in vars(mod).items():
        if attr.startswith("test_") and inspect.isfunction(obj):
            out += _expand(name, None, attr, obj)
        elif attr.startswith("Test") and inspect.isclass(obj):
            for m, f in vars(obj).items():
                if m.startswith("test_") and inspect.isfunction(f):
                    out += _expand(name, attr, m, f)
    return [c for c in out if c.id not in skip]


class _Fixtures:
    def __init__(self, request, mod, owner):
        self.request, self.mod, self.owner = request, mod, owner
        self.values, self.teardown = {}, []

    def get(self, name):
        if name in self.values:
            return self.values[name]
        fix = getattr(type(self.owner), name, None) if self.owner else None
        bound = fix is not None
        if fix is None:
            fix = getattr(self.mod, name, None)
        wrapped = getattr(fix, "_get_wrapped_function", None)
        if wrapped is None:
            value = self.request.getfixturevalue(name)
        else:
            fn = wrapped()
            args = list(inspect.signature(fn).parameters)
            if bound:
                args = args[1:]
            kw = {a: self.get(a) for a in args}
            value = fn(self.owner, **kw) if bound else fn(**kw)
            if inspect.isgenerator(value):
                gen, value = value, next(value)
                self.teardown.append(gen)
        self.values[name] = value
        return value

    def close(self):
        for gen in reversed(self.teardown):
            try:
                next(gen)
            except StopIteration:
                pass


def run_case(request, package: str, case: Case) -> None:
    mod = module_for(case.module, package)
    owner = getattr(mod, case.cls)() if case.cls else None
    func = getattr(owner, case.func) if owner else getattr(mod, case.func)
    fixtures = _Fixtures(request, mod, owner)
    try:
        kwargs = {n: case.params[n] if n in case.params else fixtures.get(n)
                  for n in inspect.signature(func).parameters}
        func(**kwargs)
    finally:
        fixtures.close()
