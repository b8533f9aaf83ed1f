"""The scheduler_perf rows of chip_smoke.py's phase 15 (MATRIX_ROWS),
scaled down for the CPU tests: tests/test_torch_rows.py and
tests/test_torch_rows_churn.py run each through both packages'
`run_workload`."""

from __future__ import annotations

import chip_smoke

# a few dozen nodes and pods; each row keeps its templates, with_pvc
# mode, second_every, saturating flag and stall_stop. Gang sizes: 8 as
# the Gang row has it; the 64- and 256-rank rows at 16 and 32, so that a
# wave still spans two and four 8-GPU nodes
SMALL = dict(num_nodes=24, num_init_pods=16, num_pods=48, max_batch=16)
GANG_SIZE = {"gang": 8, "gang64": 16, "gang256": 32}


def small_spec(key):
    spec = dict(chip_smoke.MATRIX_ROWS[key], **SMALL)
    if key in GANG_SIZE:
        spec.update(num_nodes=16, gang_size=GANG_SIZE[key],
                    num_pods=3 * GANG_SIZE[key])
    if key == "ipachurn":
        # 16 hostnames: 8 init and 8 measured pods bind, 22 never can
        spec.update(num_nodes=16, num_init_pods=8, num_pods=30)
    return spec


def run_row(harness, spec, monkeypatch, **kw):
    """`harness.run_workload` of the spec; -> (Result, pod -> node)."""
    apis = []

    class Captured(harness.APIServer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            apis.append(self)

    monkeypatch.setattr(harness, "APIServer", Captured)
    w = chip_smoke.matrix_workload(harness, spec)
    r = harness.run_workload(w, **kw)
    pods, _ = harness.Clientset(apis[0]).pods.list(namespace="default")
    return r, {p.metadata.name: p.spec.node_name for p in pods}
