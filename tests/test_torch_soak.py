"""The port's fault soak and endurance slice (ROADMAP.md Queue 1, slice
10f: `cluster.py`, testing/chaos.py, testing/invariants.py and
testing/locks.py over the port's TPUBackend) hold to the reference's own
cases: those of tests/test_fault_soak.py (device faults, pipeline-worker
kills and node deaths under a ReplicaSet, inside the lock-order
sentinel) and tests/test_endurance.py (overload waves and the invariant
suite over /metricsz) run against each package through tests/_dual.py,
the port's backends on the CPU (`run_case(..., cpu_backend=True)`). The
long soak and the long random mix are `slow` in the reference and
here."""

from __future__ import annotations

import pytest

from ._dual import PACKAGES, cases, run_case

CASES = [c for m in ("test_fault_soak", "test_endurance") for c in cases(m)]
PAIRS = [pytest.param(c, p, id=f"{c.id}-{p}",
                      marks=[pytest.mark.slow] if c.slow else [])
         for c in CASES for p in PACKAGES]


@pytest.mark.parametrize("case,package", PAIRS)
def test_reference_case(case, package, request):
    run_case(request, package, case, cpu_backend=True)


def test_every_soak_case_runs_on_both_packages():
    """5 cases, the two long ones slow, none left off either side."""
    assert len(CASES) == 5
    assert sorted(c.id for c in CASES if c.slow) == [
        "test_endurance::test_endurance_random_mix_long",
        "test_fault_soak::test_fault_soak_long"]
    assert sorted((p.values[0].id, p.values[1]) for p in PAIRS) == sorted(
        (c.id, p) for c in CASES for p in PACKAGES)
    for p in PAIRS:
        assert (pytest.mark.slow in p.marks) == p.values[0].slow
