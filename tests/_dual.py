"""A reference test module's cases, run against either package.

`module_for(name, package)` executes tests/<name>.py (and the tests/util.py
it imports) with every `kubernetes_tpu` import pointed at `package`, as a
module of its own; `cases(name)` lists the module's test functions and
test methods (with their `parametrize` values expanded), and `run_case`
runs one case of the module for one package: its module- and class-level
fixtures resolved here (generators torn down after the case; a fixture
with `params` makes one case a value, read through `request.param`),
pytest's own (`tmp_path`, `monkeypatch`, ...) through `request`. A case
whose reference function is marked `slow` has `slow` set, so the file
that runs it can mark its copies slow too.

`run_case(..., cpu_backend=True)` runs the port's case with every
`TPUBackend` built without a device on the CPU (the port's default is the
card, which raises without CUDA): the reference's cases build
`Cluster(...)` and `create_scheduler(...)` with no device to name.
`native_library(package)` loads a package's native KV store library,
building it once for every worker (tests/test_torch_stores.py).

tests/test_torch_http.py and tests/test_torch_apiserver_tail.py
parametrize each case over both packages, so the reference's own cases
hold the port's copies of its modules to the same behaviour."""

from __future__ import annotations

import fcntl
import functools
import inspect
import itertools
import os
import re
import subprocess
import sys
import tempfile
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
    # a parametrized fixture's value, by fixture name
    fparams: Dict = field(default_factory=dict, hash=False, compare=False)
    slow: bool = False

    @property
    def id(self) -> str:
        head = "::".join(x for x in (self.module, self.cls, self.func) if x)
        return head + (f"[{self.pid}]" if self.pid else "")


def _fixture_params(fix):
    marker = getattr(fix, "_fixture_function_marker", None)
    return list(marker.params) if marker and marker.params else None


def _expand(module, cls, name, func, fixtures):
    all_marks = getattr(func, "pytestmark", [])
    slow = any(m.name == "slow" for m in all_marks)
    marks = [m for m in all_marks if m.name == "parametrize"]
    if not marks:
        combos = [({}, "")]
    else:
        (mark,) = marks
        names = [n.strip() for n in mark.args[0].split(",")]
        values = list(mark.args[1])
        ids = mark.kwargs.get("ids") or [str(v) for v in values]
        combos = [(dict(zip(names, v if len(names) > 1 else (v,))), str(pid))
                  for v, pid in zip(values, ids)]
    # a fixture with params, named by the function: one case a value
    fixed = [(a, _fixture_params(fixtures[a]))
             for a in inspect.signature(func).parameters if a in fixtures]
    fixed = [(a, ps) for a, ps in fixed if ps]
    out = []
    for params, pid in combos:
        for values in itertools.product(*(ps for _, ps in fixed)):
            fparams = {a: v for (a, _), v in zip(fixed, values)}
            ids = "-".join([pid] * bool(pid) + [str(v) for v in values])
            out.append(Case(module, cls, name, params, ids, fparams, slow))
    return out


def cases(name: str, skip=()) -> list:
    """The reference module's cases in definition order, less those whose
    id is in `skip`."""
    mod = module_for(name, PACKAGES[0])
    fixtures = {a: o for a, o in vars(mod).items()
                if hasattr(o, "_fixture_function_marker")}
    out = []
    for attr, obj in vars(mod).items():
        if attr.startswith("test_") and inspect.isfunction(obj):
            out += _expand(name, None, attr, obj, fixtures)
        elif attr.startswith("Test") and inspect.isclass(obj):
            own = dict(fixtures, **{a: o for a, o in vars(obj).items()
                                    if hasattr(o, "_fixture_function_marker")})
            for m, f in vars(obj).items():
                if m.startswith("test_") and inspect.isfunction(f):
                    out += _expand(name, attr, m, f, own)
    return [c for c in out if c.id not in skip]


class _ParamRequest:
    """pytest's `request` with the `param` of one fixture's value."""

    def __init__(self, request, param):
        self._request, self.param = request, param

    def __getattr__(self, name):
        return getattr(self._request, name)


class _Fixtures:
    def __init__(self, request, mod, owner, fparams=None):
        self.request, self.mod, self.owner = request, mod, owner
        self.fparams = fparams or {}
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
            kw = {a: (_ParamRequest(self.request, self.fparams[name])
                      if a == "request" and name in self.fparams
                      else self.get(a)) for a in args}
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


def cpu_backends(monkeypatch) -> None:
    """Every port `TPUBackend` built with no device (and no mesh) runs on
    the CPU until the test ends."""
    from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend

    init = TPUBackend.__init__

    @functools.wraps(init)
    def on_cpu(self, *args, **kw):
        if kw.get("device") is None and kw.get("mesh") is None:
            kw["device"] = "cpu"
        init(self, *args, **kw)

    monkeypatch.setattr(TPUBackend, "__init__", on_cpu)


_NATIVE = _HERE.parent / "native"


def native_library(package: str):
    """`package.store.native.load_library()` on a copy of the repo's
    native/kvstore.cpp that only this function writes. Under an exclusive
    lock on native/build/.kvstore.lock, native/build/locked/libkvstore.so
    is built (when missing or older than the source) by native/Makefile
    into a directory of its own and renamed into place; the module's
    `_LIB_PATH` names it while the library loads. The reference's own
    tests build native/build/libkvstore.so in place and take no lock: no
    process loads that file through here, so none loads it half-written."""
    native = __import__(f"{package}.store.native", fromlist=["native"])
    build = _NATIVE / "build"
    build.mkdir(exist_ok=True)
    lib = build / "locked" / "libkvstore.so"
    with open(build / ".kvstore.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        src = _NATIVE / "kvstore.cpp"
        if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
            lib.parent.mkdir(exist_ok=True)
            tmp = tempfile.mkdtemp(prefix=".kvstore-", dir=build)
            out = os.path.join(tmp, "libkvstore.so")
            subprocess.run(["make", "-s", f"BUILD={tmp}", out],
                           cwd=_NATIVE, check=True, capture_output=True)
            os.replace(out, lib)
            os.rmdir(tmp)
        shared, native._LIB_PATH = native._LIB_PATH, str(lib)
        try:
            return native.load_library()
        finally:
            native._LIB_PATH = shared


def run_case(request, package: str, case: Case,
             cpu_backend: bool = False) -> None:
    if cpu_backend and package == "kubernetes_tpu_torch":
        cpu_backends(request.getfixturevalue("monkeypatch"))
    mod = module_for(case.module, package)
    owner = getattr(mod, case.cls)() if case.cls else None
    func = getattr(owner, case.func) if owner else getattr(mod, case.func)
    fixtures = _Fixtures(request, mod, owner, case.fparams)
    try:
        kwargs = {n: case.params[n] if n in case.params else fixtures.get(n)
                  for n in inspect.signature(func).parameters}
        func(**kwargs)
    finally:
        fixtures.close()
