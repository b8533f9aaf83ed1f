"""The port's admission chain (kubernetes_tpu_torch/apiserver/admission.py)
holds to the reference's own cases: those of tests/test_admission_r2.py
and tests/test_admission_r3.py run against each package (tests/_dual.py).

Every case runs on both packages, the token-mount case too: it needs
`controllers.serviceaccount`, which came with the second controller
slice (ROADMAP.md, Queue 1, 10b). `PORT_WAITS` stays empty, and
`test_pairs_cover_every_case_on_both_packages` fails if a case is left
off either side."""

from __future__ import annotations

import importlib.util

import pytest

from ._dual import PACKAGES, cases, run_case

PORT_WAITS: dict = {}
CASES = [c for m in ("test_admission_r2", "test_admission_r3")
         for c in cases(m)]
PAIRS = [(c, p) for c in CASES for p in PACKAGES
         if not (p == "kubernetes_tpu_torch" and c.id in PORT_WAITS)]


@pytest.mark.parametrize("case,package", PAIRS,
                         ids=[f"{c.id}-{p}" for c, p in PAIRS])
def test_reference_case(case, package, request):
    run_case(request, package, case)


def test_pairs_cover_every_case_on_both_packages():
    assert not PORT_WAITS
    assert len(CASES) == 26
    assert sorted((c.id, p) for c, p in PAIRS) == sorted(
        (c.id, p) for c in CASES for p in PACKAGES)
    assert "test_admission_r2::TestTokenMountE2E::" \
        "test_pod_gets_default_sa_token_mounted" in {c.id for c in CASES}
    assert importlib.util.find_spec(
        "kubernetes_tpu_torch.controllers.serviceaccount") is not None
