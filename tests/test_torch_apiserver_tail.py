"""The port's copies of the apiserver's remaining modules (auth,
flowcontrol, audit, webhook, crd, aggregator, and utils/featuregate) hold
to the reference's own cases: those of tests/test_auth.py,
test_flowcontrol.py, test_audit.py, test_webhook.py,
test_crd_featuregate.py and test_aggregator.py run against each package
(tests/_dual.py). One of them builds a `Cluster` (cluster.py, ROADMAP.md
Queue 1 slice 10f), whose scheduler's backend runs on the CPU in the port's
copy (`run_case(..., cpu_backend=True)`)."""

from __future__ import annotations

import pytest

from ._dual import PACKAGES, cases, run_case

CASES = [c for m in ("test_auth", "test_flowcontrol", "test_audit",
                     "test_webhook", "test_crd_featuregate",
                     "test_aggregator") for c in cases(m)]


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case(case, package, request):
    run_case(request, package, case, cpu_backend=True)
