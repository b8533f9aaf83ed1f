"""The port's second controller slice (ROADMAP.md Queue 1, 10b) holds to
the reference's own cases, on the CPU.

The cases of tests/test_controllers_extended.py (CronJob, TTL after
finished, disruption, the horizontal pod autoscaler, admission and
quota) and tests/test_volumes.py (PV matching, the volume plugins, the
PV binder) run against each package through tests/_dual.py: each
package's own copies of `controllers/{cronjob,ttlafterfinished,
disruption,podautoscaler,resourcequota,persistentvolume}.py` and the
rest of the slice."""

from __future__ import annotations

import pytest

from ._dual import PACKAGES, cases, run_case

CASES = [c for m in ("test_controllers_extended", "test_volumes")
         for c in cases(m)]


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case(case, package, request):
    run_case(request, package, case)


def test_every_case_runs_on_both_packages():
    assert len(CASES) == 43
    assert len({c.id for c in CASES}) == len(CASES)
