"""The rows of scripts/bench_configs.py that chip_smoke.py's phase 15 runs
on the card (its MATRIX_ROWS), scaled down to a few dozen nodes and pods
(tests/_rows.py), through both packages' `run_workload`: the reference's
on the CPU (its jnp hoisted session), the port's with device="cpu". Each
row binds every pod to the same node in both, the gang rows admit every
gang with no rollback or rejection, and the pod counts agree. The two
saturating rows, whose runs end on a 15 s stall, are in
tests/test_torch_rows_churn.py.

`Workload(wire=True)` puts the HTTP apiserver under every client: the
"basic" row's small shape binds over the wire as it does in process, in
each package."""

from __future__ import annotations

import pytest

import chip_smoke
from kubernetes_tpu.perf import harness as ref_harness
from kubernetes_tpu_torch.perf import harness

from ._rows import run_row, small_spec

ROWS = [k for k, v in chip_smoke.MATRIX_ROWS.items()
        if not v.get("saturating")]


@pytest.mark.parametrize("key", ROWS)
def test_row_binds_as_reference(key, monkeypatch):
    spec = small_spec(key)
    r_ref, ref = run_row(ref_harness, spec, monkeypatch)
    r, got = run_row(harness, spec, monkeypatch, device="cpu")
    assert len(got) == spec["num_init_pods"] + spec["num_pods"]
    assert all(got.values())
    assert got == ref
    assert r.num_bound == r_ref.num_bound == spec["num_pods"]
    if spec.get("gang_size"):
        assert r.gang_admitted == r_ref.gang_admitted \
            == spec["num_pods"] // spec["gang_size"]
        assert not sum((r.gang_rollbacks or {}).values())
        assert not sum((r.gang_rejected or {}).values())


@pytest.mark.parametrize("package", ["kubernetes_tpu", "kubernetes_tpu_torch"])
def test_wire_binds_as_in_process(package, monkeypatch):
    h = ref_harness if package == "kubernetes_tpu" else harness
    kw = {} if h is ref_harness else {"device": "cpu"}
    spec = dict(chip_smoke.WIRE_ROWS["basic"], num_nodes=12,
                num_init_pods=24, num_pods=48, max_batch=16)
    _, in_process = run_row(h, spec, monkeypatch, **kw)
    r, wire = run_row(h, dict(spec, wire=True), monkeypatch, **kw)
    assert len(wire) == 72 and all(wire.values())
    assert wire == in_process
    assert r.num_bound == 48
