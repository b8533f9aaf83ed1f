"""The port's `cluster.py` and chaos tooling (ROADMAP.md Queue 1, slice
10f) hold to the reference's own cases: those of
tests/test_cluster_bootstrap.py (the whole control plane over the Python
and the native store), tests/test_chaos.py (a ChaosMonkey over a
Deployment) and tests/test_failover.py (fenced writes, the self-fence
margin, cold-restart reconciliation, two schedulers racing for one lease)
run against each package through tests/_dual.py.

The reference's cases build `Cluster(...)` and `create_scheduler(...)`
with no device; the port's default is the card, so the port's copy runs
with every `TPUBackend` on the CPU (`run_case(..., cpu_backend=True)`).
The multi-seed failover soak is `slow` in the reference and here."""

from __future__ import annotations

import pytest

from ._dual import PACKAGES, cases, native_library, run_case

CASES = [c for m in ("test_cluster_bootstrap", "test_chaos",
                     "test_failover") for c in cases(m)]
PAIRS = [pytest.param(c, p, id=f"{c.id}-{p}",
                      marks=[pytest.mark.slow] if c.slow else [])
         for c in CASES for p in PACKAGES]


@pytest.mark.parametrize("case,package", PAIRS)
def test_reference_case(case, package, request):
    if case.params.get("native_store"):
        native_library(package)
    run_case(request, package, case, cpu_backend=True)


def test_every_cluster_case_runs_on_both_packages():
    """12 cases, the three soak seeds slow, none left off either side."""
    assert len(CASES) == 12
    assert sorted(c.id for c in CASES if c.slow) == [
        f"test_failover::test_dual_scheduler_failover_soak[{s}]"
        for s in (1, 2, 3)]
    assert sorted((p.values[0].id, p.values[1]) for p in PAIRS) == sorted(
        (c.id, p) for c in CASES for p in PACKAGES)
    for p in PAIRS:
        assert (pytest.mark.slow in p.marks) == p.values[0].slow
