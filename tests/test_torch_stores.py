"""The port's stores (store/kv.py, store/wal.py and, from ROADMAP.md Queue
1 slice 10f, store/native.py over the repo's native/kvstore.cpp) hold to
the reference's own cases: those of tests/test_store.py (every case over
the Python, native and durable stores) and tests/test_durable_store.py
(WAL recovery, crash drills, an apiserver crash under informers and
controllers) run against each package through tests/_dual.py.

Both packages load one build of native/kvstore.cpp: `native_library`
builds it once, under a lock, apart from the file the reference's own
tests build in place, so no worker loads a half-written library."""

from __future__ import annotations

import shutil

import pytest

from . import _dual
from ._dual import PACKAGES, cases, native_library, run_case

CASES = [c for m in ("test_store", "test_durable_store") for c in cases(m)]
PAIRS = [pytest.param(c, p, id=f"{c.id}-{p}",
                      marks=[pytest.mark.slow] if c.slow else [])
         for c in CASES for p in PACKAGES]


@pytest.mark.parametrize("case,package", PAIRS)
def test_reference_case(case, package, request):
    native_library(package)
    run_case(request, package, case, cpu_backend=True)


def test_every_store_case_runs_on_both_packages():
    """58 cases, none slow, none left off either side; the native store's
    cases are among them."""
    assert len(CASES) == 58
    assert not [c for c in CASES if c.slow]
    assert sorted((p.values[0].id, p.values[1]) for p in PAIRS) == sorted(
        (c.id, p) for c in CASES for p in PACKAGES)
    ids = {c.id for c in CASES}
    assert "test_store::TestCRUD::test_create_get[native]" in ids
    assert "test_store::TestParityExtras::test_explicit_compact[native]" \
        in ids
    assert sum(1 for c in CASES if c.module == "test_durable_store") == 18


@pytest.mark.parametrize("package", PACKAGES)
def test_native_library_never_loads_the_shared_file(package, tmp_path,
                                                    monkeypatch):
    """A half-written native/build/libkvstore.so (as the reference's own
    tests' unlocked `make` leaves it mid-link) is neither loaded nor
    touched: the library comes from the copy built under the lock."""
    native = __import__(f"{package}.store.native", fromlist=["native"])
    for name in ("Makefile", "kvstore.cpp"):
        shutil.copy(_dual._NATIVE / name, tmp_path / name)
    (tmp_path / "build").mkdir()
    shared = tmp_path / "build" / "libkvstore.so"
    shared.write_bytes(b"\x7fELF\x02\x01\x01")
    monkeypatch.setattr(_dual, "_NATIVE", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_LIB_PATH", str(shared))
    lib = native_library(package)
    assert lib._name == str(tmp_path / "build" / "locked" / "libkvstore.so")
    handle = lib.kv_new(0)
    assert handle
    lib.kv_free(handle)
    assert shared.read_bytes() == b"\x7fELF\x02\x01\x01"
    assert native._LIB_PATH == str(shared)
