"""Repeat one of chip_smoke.py's preemption rows (phase 14) and record how
every pod was bound, to hunt a rare node over its allocatable (ROADMAP.md
Queue 3). From the repository's root:

    python3 -m kubernetes_tpu_torch.perf.repeat_row 14b 25          # the card
    python3 -m kubernetes_tpu_torch.perf.repeat_row 14b 25 --cpu    # the CPU

Each run is `run_workload` of the row as chip_smoke's `preemption_cell`
builds it (on the CPU with the kernel rung's plain version). Every bind is
recorded with its time, thread and caller (a batch's harvest, a failure
wave's bind, a nominated placement, the oracle) and the scheduler's
wave-bind count, and so is each `_fit_harvest` and each pod removal from
the scheduler's cache. A node over its allocatable prints what was bound
there and removed from it. The last line is one JSON object: the row, the
runs and the runs with a node over its allocatable."""

from __future__ import annotations

import json
import sys
import threading
import time


def _record(scheduler_cls, cache_cls):
    """Wrap the bind paths; -> (the record list, its clock's zero)."""
    rec, lock, t0 = [], threading.Lock(), [time.perf_counter()]

    def add(kind, caller, items, *extra):
        with lock:
            rec.append((time.perf_counter() - t0[0],
                        threading.current_thread().name, kind, caller,
                        extra, items))

    batch, one = scheduler_cls._assume_and_bind_batch, \
        scheduler_cls._assume_and_bind
    fit, remove = scheduler_cls._fit_harvest, cache_cls.remove_pod

    def assume_and_bind_batch(self, bound):
        add("bind", sys._getframe(1).f_code.co_name,
            [(i.pod.metadata.name, n) for i, n in bound], self._wave_binds)
        return batch(self, bound)

    def assume_and_bind(self, pod, node, *args, **kwargs):
        add("bind", sys._getframe(1).f_code.co_name,
            [(pod.metadata.name, node)], self._wave_binds)
        return one(self, pod, node, *args, **kwargs)

    def fit_harvest(self, bound):
        out = fit(self, bound)
        add("fit", "_fit_harvest", [(i.pod.metadata.name, n)
                                    for i, n in bound], len(out))
        return out

    def remove_pod(self, pod):
        add("remove", "cache", [(pod.metadata.name, pod.spec.node_name)])
        return remove(self, pod)

    scheduler_cls._assume_and_bind_batch = assume_and_bind_batch
    scheduler_cls._assume_and_bind = assume_and_bind
    scheduler_cls._fit_harvest = fit_harvest
    cache_cls.remove_pod = remove_pod
    return rec, t0


def main(argv) -> int:
    import chip_smoke as cs
    from kubernetes_tpu_torch.client import Clientset
    from kubernetes_tpu_torch.perf.harness import (
        PodTemplate,
        Workload,
        run_workload,
    )
    from kubernetes_tpu_torch.scheduler import tpu_backend
    from kubernetes_tpu_torch.scheduler.internal.cache import SchedulerCache
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

    label, runs = argv[0], int(argv[1])
    cpu = "--cpu" in argv
    row = {lb: (spec, init, tmpl)
           for lb, spec, init, tmpl in cs.PREEMPTION_ROWS}[label]
    if cpu:
        init = tpu_backend.TPUBackend.__init__

        def kernel_rung(self, *args, **kwargs):
            kwargs.setdefault("use_kernel", True)
            init(self, *args, **kwargs)

        tpu_backend.TPUBackend.__init__ = kernel_rung
    else:
        from kubernetes_tpu_torch.ops import build
        from kubernetes_tpu_torch.ops import scan_kernel as sk
        from kubernetes_tpu_torch.ops import whatif_kernel as wk

        build.build([sk.SOURCE, wk.SOURCE])
    rec, t0 = _record(Scheduler, SchedulerCache)
    spec, init_t, tmpl = row
    over_runs = 0
    for i in range(runs):
        rec.clear()
        t0[0] = time.perf_counter()
        run = cs.LoopRun(not cpu)
        w = Workload(init_template=PodTemplate(cpu="900m", memory="64Mi",
                                               priority=1, **init_t),
                     template=PodTemplate(cpu="900m", memory="64Mi",
                                          priority=100, **tmpl), **spec)
        try:
            r = run_workload(w, device="cpu") if cpu else run_workload(w)
        finally:
            run.close()
        c = Clientset(run.apis[-1])
        pods, _ = c.pods.list(namespace="default")
        nodes, _ = c.nodes.list()
        over = cs.overcommitted(pods, nodes)
        print(f"{label} run {i}: {r.num_bound} of {w.num_pods} bound, over "
              f"{over}, {len(run.batches)} batches, "
              f"{time.perf_counter() - t0[0]:.1f} s", flush=True)
        if not over:
            continue
        over_runs += 1
        there = {p.metadata.name for p in pods if p.spec.node_name in over}
        print(f"  pods there: {sorted(there)}", flush=True)
        for t, thread, kind, caller, extra, items in rec:
            hit = [(p, n) for p, n in items if p in there or n in over]
            if hit or kind == "fit":
                print(f"  {t:.4f} {thread} {kind} {caller} {extra} "
                      f"{hit or len(items)}", flush=True)
    print(json.dumps({"row": label, "runs": runs, "over_runs": over_runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
