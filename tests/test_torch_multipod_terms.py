"""tests/test_torch_multipod.py's parity checks on the affinity-term
cases (the kernel's ur > 0 variant): ScanSession with multipod_k > 1
equals PallasSession's multipod kernel in interpret mode on out rows
[:4, :n] and every carry after every batch (the IPA template-interference
leg `gmat` included), and `schedule_exact` decides as one pod per
step."""

import pytest

from . import test_torch_multipod as multipod

MK_CASES = multipod.mk_cases(term=True)


@pytest.mark.parametrize("case,mk", MK_CASES)
def test_multipod_equals_pallas(case, mk):
    multipod.check_multipod_equals_pallas(case, mk)


@pytest.mark.parametrize("case,mk", MK_CASES)
def test_schedule_exact_equals_one_pod_per_step(case, mk):
    multipod.check_schedule_exact(case, mk)
