"""Preemption rows through one package's scheduler loop on the CPU, with
the evictions and the planner's node-skew guard accounted for.

    JAX_PLATFORMS=cpu python scripts/preemption_accounting.py \
        --package kubernetes_tpu --row ipa --whatif 1 --runs 3

--package is `kubernetes_tpu` (the JAX reference) or
`kubernetes_tpu_torch` (the port, run with device="cpu"); only the named
package is imported. --row picks Preemption-500n-500hi (`plain`),
Preemption-PDB-500n-500hi (`pdb`) or Preemption-IPA-500n-500hi (`ipa`)
at their full size (scripts/bench_configs.py). --whatif sets KTPU_WHATIF
(1: the device rung, 0: the numpy fast rung).

Each run prints one JSON line: the pods bound; the priority-1 pods
evicted; the preemptions the loop applied and the victims they named
(every eviction should be a named victim; a preemptor the loop plans
again before its victims' delete echoes land names a new one); the
planner paths and what-if fallbacks inside the harness's window; and,
for each planned pod whose encoding moved after its wave's books were
pinned (the `node-skew` guard), the encoding calls that moved it, by
thread and caller.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import threading
import time
import traceback

ROWS = {
    "plain": ("Preemption-500n-500hi", {}, {}, {}),
    "pdb": ("Preemption-PDB-500n-500hi", {"pdb_disruptions_allowed": 2000},
            {"labels": {"app": "victim"}}, {}),
    "ipa": ("Preemption-IPA-500n-500hi", {}, {"labels": {"app": "victim"}},
            {"pod_affinity_zone": True, "labels": {"app": "victim"}}),
}
ENCODING_CALLS = ("add_node", "update_node_alloc", "remove_node", "add_pod",
                  "swap_pod_object", "remove_pod", "rebuild", "set_cluster")


def instrument(pkg):
    """Wrap the encoding's mutators, the planner's per-pod launch and the
    loop's preemption apply; returns the dict they fill."""
    enc_mod = importlib.import_module(pkg + ".models.encoding")
    planner_mod = importlib.import_module(
        pkg + ".scheduler.preemption_device")
    sched_mod = importlib.import_module(pkg + ".scheduler.scheduler")
    rec = {"moves": [], "skews": [], "preemptions": 0, "named": 0}

    for name in ENCODING_CALLS:
        orig = getattr(enc_mod.ClusterEncoding, name)

        def call(self, *a, _orig=orig, _name=name, **k):
            out = _orig(self, *a, **k)
            callers = [f.name for f in traceback.extract_stack(limit=5)[:-1]]
            rec["moves"].append((self.version, _name,
                                 threading.current_thread().name,
                                 " < ".join(reversed(callers[-3:]))))
            return out

        setattr(enc_mod.ClusterEncoding, name, call)

    plan_one = planner_mod.DevicePreemptionPlanner._plan_one_device

    def plan_one_device(self, pod, limit):
        now = self.backend.enc.version
        if now != self._books_version:
            moved = collections.Counter(
                m[1:] for m in list(rec["moves"])
                if self._books_version < m[0] <= now)
            rec["skews"].append([list(k) + [n] for k, n in moved.items()])
        return plan_one(self, pod, limit)

    planner_mod.DevicePreemptionPlanner._plan_one_device = plan_one_device

    apply = sched_mod.Scheduler._apply_preemptions

    def apply_preemptions(self, items, cycle):
        rec["preemptions"] += len(items)
        rec["named"] += sum(len(cand.victims) for _, cand in items)
        return apply(self, items, cycle)

    sched_mod.Scheduler._apply_preemptions = apply_preemptions
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", required=True,
                    choices=("kubernetes_tpu", "kubernetes_tpu_torch"))
    ap.add_argument("--row", required=True, choices=sorted(ROWS))
    ap.add_argument("--whatif", choices=("0", "1"), default="1")
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args()
    os.environ["KTPU_WHATIF"] = args.whatif
    pkg = args.package
    if pkg == "kubernetes_tpu":
        import jax

        jax.config.update("jax_enable_x64", True)
    harness = importlib.import_module(pkg + ".perf.harness")
    client = importlib.import_module(pkg + ".client")
    rec = instrument(pkg)
    apis = []

    class CapturedAPIServer(harness.APIServer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            apis.append(self)

    harness.APIServer = CapturedAPIServer
    name, extra, init, template = ROWS[args.row]
    for run in range(args.runs):
        rec.update(moves=[], skews=[], preemptions=0, named=0)
        w = harness.Workload(
            name=name, num_nodes=500, num_init_pods=2000, num_pods=500,
            init_template=harness.PodTemplate(cpu="900m", memory="64Mi",
                                              priority=1, **init),
            template=harness.PodTemplate(cpu="900m", memory="64Mi",
                                         priority=100, **template),
            max_batch=512, timeout=900.0, stall_stop=30.0, **extra)
        t0 = time.perf_counter()
        r = harness.run_workload(
            w, **({"device": "cpu"} if pkg == "kubernetes_tpu_torch" else {}))
        pods, _ = client.Clientset(apis[-1]).pods.list(namespace="default")
        left = {p.metadata.name for p in pods}
        evicted = sum(f"init-{i}" not in left
                      for i in range(w.num_init_pods))
        print(json.dumps({
            "package": pkg, "row": name, "whatif": args.whatif, "run": run,
            "bound": r.num_bound, "evicted": evicted,
            "preemptions": rec["preemptions"], "victims_named": rec["named"],
            "planner_paths": r.preemption_planner_paths,
            "whatif_fallbacks": r.whatif_fallbacks,
            "node_skew_moves": rec["skews"][:3],
            "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
