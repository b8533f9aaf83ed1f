"""The port's observability surface holds to the reference's own cases:
tests/test_observability.py (the metrics registry, events, leader
election, the threshold tracer `utils/trace.py` of slice 10g, the flight
recorder, backend-health Events, the /configz knobs and the harness's
per-stage latency fields) run against the port through tests/_dual.py.

The reference's cases build `Scheduler(backend="tpu")` and
`run_workload(...)` with no device; the port's default is the card, so
every port `TPUBackend` runs on the CPU here (`cpu_backend=True`).
`_mini_scheduler` imports `tests.util` at call time, which names the
reference's API types: for the port's cases that name is the port's copy
of tests/util.py. The dump case renders the port's flight-recorder dump
with scripts/trace_report.py, which imports the reference's tracing
module: the dump is JSON, and reading the port's with the reference's
reader is part of what the case holds. Only the port's side runs here:
test_observability.py runs the reference's."""

from __future__ import annotations

import sys

import pytest

from ._dual import cases, module_for, run_case

PORT = "kubernetes_tpu_torch"
CASES = cases("test_observability")


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_reference_case_on_port(case, request, monkeypatch):
    monkeypatch.setitem(sys.modules, "tests.util", module_for("util", PORT))
    run_case(request, PORT, case, cpu_backend=True)


def test_every_reference_case_runs():
    """The reference's 14 cases, the threshold tracer's two among them,
    all on the port's modules."""
    assert len(CASES) == 14
    ids = {c.id for c in CASES}
    assert "test_observability::test_trace_threshold" in ids
    assert ("test_observability::TestFlightRecorder::"
            "test_threshold_trace_mirrors_into_recorder") in ids
    mod = module_for("test_observability", PORT)
    assert mod.Trace.__module__ == "kubernetes_tpu_torch.utils.trace"
    assert mod.tracing.__name__ == "kubernetes_tpu_torch.utils.tracing"
