"""The two saturating rows of chip_smoke.py's phase 15 (IPA-churn-2000n
and Unschedulable-churn-500n), scaled down (tests/_rows.py), through both
packages' `run_workload`, as tests/test_torch_rows.py runs the others:
each ends on its 15 s stall with the same pods bound to the same nodes in
both packages. At full size (2000 nodes) chip_smoke.py holds the card's
run of IPA-churn to its invariants (one anti-affine pod a hostname, every
hostname used, no node over its allocatable) and to no CPU run, which
would take minutes there; this is its comparison with the reference."""

from __future__ import annotations

import pytest

from kubernetes_tpu.perf import harness as ref_harness
from kubernetes_tpu_torch.perf import harness

from ._rows import run_row, small_spec


@pytest.mark.parametrize("key", ["ipachurn", "unschedchurn"])
def test_saturating_row_binds_as_reference(key, monkeypatch):
    spec = small_spec(key)
    r_ref, ref = run_row(ref_harness, spec, monkeypatch)
    r, got = run_row(harness, spec, monkeypatch, device="cpu")
    assert got == ref
    assert r.num_bound == r_ref.num_bound
    bound = sum(1 for v in got.values() if v)
    if key == "ipachurn":
        # one app=churn pod a hostname
        assert bound == spec["num_nodes"]
        assert len(set(v for v in got.values() if v)) == bound
    else:
        # every third measured pod asks for 8 CPU and never fits
        assert r.num_bound == spec["num_pods"] - len(
            range(0, spec["num_pods"], spec["second_every"]))
