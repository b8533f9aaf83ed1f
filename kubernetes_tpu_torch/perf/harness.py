"""Workload runner: declarative node/pod ops → throughput + latency stats.

Reference: test/integration/scheduler_perf/scheduler_perf_test.go —
workloads are op sequences (createNodes, createPods with optional
podTemplate features, barrier); measured pods get timing; collectors
sample SchedulingThroughput at 1s (util.go:220-284) and latency
percentiles come from per-pod scheduling timestamps.

The cluster is the real in-proc slice: APIServer + informers + the real
Scheduler loop (oracle or TPU backend) — the same shape as the reference's
mustSetupScheduler (util.go:61) with a real apiserver+etcd and no kubelet.

Port of kubernetes_tpu/perf/harness.py. `run_workload` takes `device`:
the TPU backend runs on the card unless the caller names another (the
tests pass "cpu"). `wire` puts the HTTP apiserver (apiserver/http.py)
between every client and the store, as the reference does. One of the
reference's options raises NotImplementedError, since what it needs is not
ported yet: `mesh_devices` (the sharded session; ROADMAP.md, Queue 1,
item 9). It does not fall back to the single-device run.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api import types as v1
from ..apiserver import APIServer
from ..client import Clientset, SharedInformerFactory
from ..scheduler.framework.runtime import Framework
from ..scheduler.plugins.registry import (
    default_plugins_without,
    new_in_tree_registry,
)
from ..scheduler.scheduler import Scheduler
from ..testing.synth import make_node, make_pod

DENSITY_FAIL_THRESHOLD = 30.0  # scheduler_test.go:41 threshold3K
DENSITY_WARN_THRESHOLD = 100.0  # scheduler_test.go:40 warning3K
CSI_PERF_DRIVER = "csi.perf.example"  # the CSIPVs workloads' driver


@dataclass
class PodTemplate:
    """Pod features, mirroring performance-config.yaml templates."""

    cpu: str = "100m"
    memory: str = "128Mi"
    labels: Dict[str, str] = field(default_factory=lambda: {"app": "perf"})
    priority: Optional[int] = None  # spec.priority (preemption workloads)
    spread_zone: bool = False  # PodTopologySpread on zone, ScheduleAnyway
    spread_zone_hard: bool = False  # maxSkew=1 DoNotSchedule on zone
    spread_hostname_hard: bool = False  # maxSkew=1 DoNotSchedule on hostname
    anti_affinity_zone: bool = False  # required anti-affinity on zone
    anti_affinity_hostname: bool = False  # required anti-affinity per node
    extended: Optional[Dict[str, str]] = None  # e.g. {"example.com/gpu": "1"}
    # SchedulingSecrets: secret volumes (no scheduling constraint — pins
    # that volume-bearing non-PVC pods stay on the kernel fast path)
    secret_volumes: int = 0
    # required pod AFFINITY on zone toward self-labels (SchedulingPodAffinity)
    pod_affinity_zone: bool = False
    # preferred (anti-)affinity on zone (SchedulingPreferredPodAffinity /
    # SchedulingPreferredPodAntiAffinity)
    preferred_affinity_zone: bool = False
    preferred_anti_affinity_zone: bool = False
    # required node affinity: zone In [zone-0, zone-1] (SchedulingNodeAffinity)
    node_affinity_zones: Optional[List[str]] = None
    # one pre-bound PVC+PV per measured pod (SchedulingInTreePVs /
    # SchedulingCSIPVs): "zonal" labels the PV with the pod-index zone;
    # "csi" additionally carries a CSI driver (attach-limit accounting)
    with_pvc: str = ""  # "" | "zonal" | "csi" | "migrated"

    def build(self, name: str, namespace: str = "default") -> v1.Pod:
        constraints = []
        if self.spread_zone:
            constraints.append(
                v1.TopologySpreadConstraint(
                    max_skew=1,
                    topology_key=v1.LABEL_ZONE,
                    when_unsatisfiable="ScheduleAnyway",
                    label_selector=v1.LabelSelector(match_labels=dict(self.labels)),
                )
            )
        if self.spread_zone_hard:
            constraints.append(
                v1.TopologySpreadConstraint(
                    max_skew=1,
                    topology_key=v1.LABEL_ZONE,
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=v1.LabelSelector(match_labels=dict(self.labels)),
                )
            )
        if self.spread_hostname_hard:
            constraints.append(
                v1.TopologySpreadConstraint(
                    max_skew=1,
                    topology_key=v1.LABEL_HOSTNAME,
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=v1.LabelSelector(match_labels=dict(self.labels)),
                )
            )
        affinity = None
        pod_affinity = None
        pod_anti = None
        node_aff = None
        if self.anti_affinity_zone or self.anti_affinity_hostname:
            pod_anti = v1.PodAntiAffinity(
                required_during_scheduling_ignored_during_execution=[
                    v1.PodAffinityTerm(
                        label_selector=v1.LabelSelector(
                            match_labels=dict(self.labels)
                        ),
                        topology_key=(
                            v1.LABEL_ZONE
                            if self.anti_affinity_zone
                            else v1.LABEL_HOSTNAME
                        ),
                    )
                ]
            )
        if self.pod_affinity_zone:
            pod_affinity = v1.PodAffinity(
                required_during_scheduling_ignored_during_execution=[
                    v1.PodAffinityTerm(
                        label_selector=v1.LabelSelector(
                            match_labels=dict(self.labels)
                        ),
                        topology_key=v1.LABEL_ZONE,
                    )
                ]
            )
        if self.preferred_affinity_zone or self.preferred_anti_affinity_zone:
            term = v1.WeightedPodAffinityTerm(
                weight=100,
                pod_affinity_term=v1.PodAffinityTerm(
                    label_selector=v1.LabelSelector(
                        match_labels=dict(self.labels)
                    ),
                    topology_key=v1.LABEL_ZONE,
                ),
            )
            if self.preferred_affinity_zone:
                pod_affinity = pod_affinity or v1.PodAffinity()
                pod_affinity.preferred_during_scheduling_ignored_during_execution = [term]
            else:
                pod_anti = pod_anti or v1.PodAntiAffinity()
                pod_anti.preferred_during_scheduling_ignored_during_execution = [term]
        if self.node_affinity_zones:
            node_aff = v1.NodeAffinity(
                required_during_scheduling_ignored_during_execution=v1.NodeSelector(
                    node_selector_terms=[
                        v1.NodeSelectorTerm(match_expressions=[
                            v1.NodeSelectorRequirement(
                                key=v1.LABEL_ZONE, operator="In",
                                values=list(self.node_affinity_zones),
                            )
                        ])
                    ]
                )
            )
        if pod_affinity or pod_anti or node_aff:
            affinity = v1.Affinity(
                pod_affinity=pod_affinity,
                pod_anti_affinity=pod_anti,
                node_affinity=node_aff,
            )
        pod = make_pod(
            name,
            namespace=namespace,
            cpu=self.cpu,
            memory=self.memory,
            labels=dict(self.labels),
            priority=self.priority,
            constraints=constraints or None,
            affinity=affinity,
            extended=self.extended,
        )
        if self.secret_volumes:
            pod.spec.volumes = [
                v1.Volume(name=f"sec{i}", source={"secret": {
                    "secretName": f"perf-secret-{i}"}})
                for i in range(self.secret_volumes)
            ]
        return pod


@dataclass
class Workload:
    """One benchmark case (a performance-config.yaml entry)."""

    name: str
    num_nodes: int
    num_init_pods: int = 0
    num_pods: int = 0  # measured
    init_template: PodTemplate = field(default_factory=PodTemplate)
    template: PodTemplate = field(default_factory=PodTemplate)
    # churn mixing: every `second_every`-th measured pod is stamped from
    # second_template instead (e.g. permanently-unschedulable pods
    # churning between schedulable ones — the reference's Unschedulable
    # workload variants); 0 disables
    second_template: Optional[PodTemplate] = None
    second_every: int = 0
    backend: str = "tpu"
    n_zones: int = 3
    max_batch: int = 128
    timeout: float = 600.0
    # gang scheduling (north-star stress: 8-pod groups over GPU nodes):
    # measured pods are grouped into gangs of this size via the
    # Coscheduling Permit plugin; 0 disables
    gang_size: int = 0
    gang_permit_timeout: float = 60.0
    node_extended: Optional[Dict[str, str]] = None  # extra node capacity
    # stop when bound-count is unchanged for this many seconds (workloads
    # with permanently-unschedulable pods never reach bound==total; 0 =
    # only the timeout stops the run)
    stall_stop: float = 0.0
    # run the WHOLE control plane over the real HTTP wire: the apiserver
    # serves a socket (apiserver/http.py) and every client — informers,
    # scheduler binds, events — goes through RemoteAPIServer, matching
    # the reference harness's real apiserver boundary (util.go:61). The
    # in-proc default isolates scheduler cost; wire=True measures the
    # HTTP tax once (VERDICT r2 missing #6).
    wire: bool = False
    # saturation workload: bindable pods < num_pods BY DESIGN (e.g.
    # IPA-churn's anti-affinity saturates the nodes) — pods_per_sec is
    # then bound/window arithmetic, not machine speed; the honest
    # headline for such rows is attempts_per_sec
    saturating: bool = False
    # PodDisruptionBudget over the init template's labels (the
    # Preemption-with-PDBs workload: victims are PDB-covered, the
    # planner's vectorized PDB partitioning is on the measured path);
    # None disables, an int is status.disruptionsAllowed
    pdb_disruptions_allowed: Optional[int] = None
    # measure the kernel-direct rate for THIS config in-process after
    # the loop phase (same templates, same session, no queue/cache/bind
    # path) and record loop_kernel_ratio = full-loop / kernel-direct —
    # the adjudicating number for the "close the loop-vs-kernel gap"
    # target (full-loop >= 50% of kernel-direct on Default-5000n).
    # Off by default: CI-size harness tests must not pay the extra
    # dispatches; scripts/bench_configs.py turns it on for every row.
    kernel_direct: bool = False
    # shadow parity sentinel sampling rate (KTPU_SHADOW_SAMPLE semantics,
    # 0..1): sampled decided pods are replayed through the oracle chain
    # in the completion worker and drift is counted per plugin. 0 (the
    # default) is decision-inert and launch-free — benchmark rows only
    # pay the audit when they opt in.
    shadow_sample: float = 0.0
    # columnar scheduler cache (KTPU_COLUMNAR_CACHE): False pins the
    # per-pod object writeback path for A/B rows (scripts/probe_assume.py
    # and the completion-tax adjudication in bench_configs.py)
    columnar: bool = True
    # multi-host mesh scale-out: shard the node axis over this many
    # devices (0 = single-device backend). The sharded session is not
    # ported: run_workload raises for any other value
    mesh_devices: int = 0


@dataclass
class Result:
    name: str
    backend: str
    num_nodes: int
    num_pods: int
    duration_s: float
    throughput_avg: float  # pods/s over the measured phase
    # percentiles of the 1s bind-rate samples, over the BINDING PHASE
    # (first bind .. last bind): workloads with non-binding phases by
    # design — preemption's plan/evict lead-in, churn's unschedulable
    # retry tail — would otherwise report the phase mix (p50 = 0 from
    # zero-bind seconds outside the binding phase), which says nothing
    # about binding cadence. throughput_avg stays over the FULL window
    # (conservative: it charges those phases).
    throughput_p50: float
    throughput_p90: float
    throughput_p99: float
    attempts: int = 0
    num_bound: int = 0  # measured pods actually bound (== num_pods on success)
    # per-pod scheduling latency percentiles (seconds), EXACT from the
    # scheduler's sample buffer — the reference extracts the same
    # Perc50/90/99 from scheduler_pod_scheduling_duration_seconds
    # (scheduler_perf_test.go:50-58, util.go:177-218).
    # pod_scheduling_* = queue admission -> bind sent (includes queue wait)
    # attempt_* = queue pop -> bind sent (one attempt's latency)
    pod_scheduling_p50: float = 0.0
    pod_scheduling_p90: float = 0.0
    pod_scheduling_p99: float = 0.0
    attempt_p50: float = 0.0
    attempt_p90: float = 0.0
    attempt_p99: float = 0.0
    # device session builds during the run, by kernel kind (pallas = the
    # single-launch fast path; hoisted = jnp fallback) — records which
    # path the config actually rode (VERDICT r2: wire into bench output).
    # session_kind = the live session's class at end of run; builds are
    # split in-window vs cumulative-since-process-start so "built during
    # init and survived" is distinguishable from "never built"
    session_builds: Optional[Dict[str, int]] = None
    session_builds_total: Optional[Dict[str, int]] = None
    session_kind: str = ""
    # WHY the config rode the session it rode: "kind/reason" -> builds
    # since process start. A config on HoistedSession must carry its
    # downgrade reason here — no benchmark row rides the slow path
    # silently (the Preferred-affinity configs did for two rounds).
    session_build_reasons: Optional[Dict[str, int]] = None
    # WHY live sessions were torn down during the measured window
    # (scheduler_session_rebuilds_total{reason}, IN-WINDOW delta): the
    # rebuild-storm attribution — churn reasons (foreign-pod-add /
    # pod-remove) here mean events fell off the delta fast path
    session_rebuild_reasons: Optional[Dict[str, int]] = None
    # cluster events absorbed as incremental session deltas instead of
    # teardowns (scheduler_session_delta_applies_total{kind}, in-window)
    session_delta_applies: Optional[Dict[str, int]] = None
    # attempts/s over the measured window — the headline for saturating
    # workloads (headline_metric says which number to read)
    attempts_per_sec: float = 0.0
    headline_metric: str = "pods_per_sec"
    # multi-pod scan steps + speculative dispatch (in-window counter
    # deltas): conflicts = speculative per-step decisions invalidated by
    # an earlier pod of the same step; replays = the sequential
    # re-decisions that kept them exact; hits/misses = pipelined
    # dispatches chained on a not-yet-harvested carry that landed
    # cleanly / were re-driven
    multipod_conflicts: int = 0
    conflict_replays: int = 0
    speculative_hits: int = 0
    speculative_misses: int = 0
    # kernel-direct pods/s measured in-process for the same config
    # (Workload.kernel_direct), and the ratio the roadmap target reads:
    # loop_kernel_ratio = throughput_avg / kernel_direct_pods_per_sec
    kernel_direct_pods_per_sec: float = 0.0
    loop_kernel_ratio: float = 0.0
    # preemption planner-ladder accounting (in-window deltas): which
    # rung planned the wave pods (path -> count), how many fused
    # what-if launches ran, and why any device-rung pod fell a rung —
    # the counters that adjudicate the oracle-bound -> dispatch-bound
    # claim on the chip rerun
    preemption_planner_paths: Optional[Dict[str, int]] = None
    whatif_launches: int = 0
    whatif_fallbacks: Optional[Dict[str, int]] = None
    # gang all-or-nothing accounting (in-window counter deltas): waves
    # admitted whole / rejected{reason} / rolled back{reason}, plus
    # members evicted as whole-gang victim units — the atomicity ledger
    # for the Gang-* rows (admitted * gang_size == num_bound on a clean
    # run; any rollback names its reason). Admission percentiles are
    # EXACT, from the Coscheduling plugin's per-wave sample buffer
    # (first member parked -> wave admitted), not histogram buckets.
    # All zero/None on rows without gangs.
    gang_admitted: int = 0
    gang_rejected: Optional[Dict[str, int]] = None
    gang_rollbacks: Optional[Dict[str, int]] = None
    gang_preempted: int = 0
    gang_admission_p50: float = 0.0
    gang_admission_p99: float = 0.0
    # per-stage latency attribution (KTPU_TRACE >= 1): flight-recorder
    # span summaries over the measured window, stage -> {count, total_s,
    # p50_s, p99_s} for pop / encode / delta-apply / dispatch / wait /
    # harvest / replay / assume / reserve-permit / bind / planner /
    # session — the breakdown that says WHICH stage owns the
    # loop-vs-kernel gap instead of one end-to-end number. None with
    # tracing off (the headline path is bit-identical to pre-trace
    # behavior there).
    stage_latency: Optional[Dict[str, Dict[str, float]]] = None
    # wall-clock coverage of the recorded spans (first span start ->
    # last span end): the reconciliation anchor against duration_s /
    # the first-bind..last-bind window
    stage_window_s: float = 0.0
    trace_level: int = 0
    # shadow parity sentinel accounting (in-window deltas): decided pods
    # sampled for the oracle replay, and drift counted by plugin — the
    # production signal the chip rerun adjudicates (None/0 with
    # shadow_sample=0, where the sentinel never runs)
    shadow_samples: int = 0
    shadow_drift: Optional[Dict[str, int]] = None
    # node-axis shard count the row rode (scheduler_mesh_shards; 0 =
    # single-device). Mesh rows' session_builds slugs carry the same
    # number ("sharded@8/-") so per-rep build accounting in
    # bench_configs.py stays per-shard-count when a rep falls off the
    # mesh path
    mesh_shards: int = 0
    # device-timeline attribution (KTPU_DEVTIME >= 1): host<->device
    # overlap over the measured window merged from the device timeline
    # and the flight-recorder ring (overlapped / min(host, device) — on
    # the 1-CPU box this is the measured form of "block_until_ready
    # cannot overlap"), the kernel/transfer/compile device-seconds
    # split with H2D/D2H byte totals, and the in-window count of
    # dispatch-path AOT recompiles (compile storms become a counted
    # event). 0/None with devtime off — the headline path stays
    # bit-identical there, pinned by test.
    overlap_ratio: float = 0.0
    device_time: Optional[Dict[str, float]] = None
    recompiles: int = 0
    devtime_level: int = 0

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def _bind_rate_samples(bind_ts: List[float]) -> List[float]:
    """Per-second bind rates over the exact first-bind..last-bind window,
    computed from the bind events themselves (no polling grid). Returns
    [] when the binding phase is shorter than one second — per-second
    cadence is unresolvable there and the caller falls back to the
    run-average rate (the old grid reported a 1000/k quantization
    artifact for exactly those runs)."""
    if not bind_ts:
        return []
    first, last = bind_ts[0], bind_ts[-1]
    span = last - first
    if span < 1.0:
        return []
    nb = int(math.ceil(span))
    counts = [0] * nb
    for t in bind_ts:
        counts[min(nb - 1, int(t - first))] += 1
    widths = [1.0] * (nb - 1) + [span - (nb - 1)]
    # a sliver of a final bucket (< 0.2s) is noise, not a rate sample
    return [c / wd for c, wd in zip(counts, widths) if wd >= 0.2]


def _percentile(samples: List[float], p: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(round(p / 100.0 * len(s) + 0.5)) - 1))
    return s[idx]


def _label_counts(counter, default: str = "-") -> Dict[str, int]:
    """first-label counter aggregation -> {label: total} (session-build
    kinds, rebuild reasons, delta kinds)."""
    out: Dict[str, int] = {}
    for key, val in counter.items():
        slug = key[0] if key else default
        out[slug] = out.get(slug, 0) + int(val)
    return out


def _shard_suffix(key) -> str:
    """"@<shards>" for builds that rode a mesh, "" for single-device —
    mesh rows keep per-shard-count accounting without changing the
    slugs every existing single-device row records."""
    shards = key[2] if len(key) > 2 and key[2] else ""
    return f"@{shards}" if shards else ""


def _session_build_counts() -> Dict[str, int]:
    """scheduler_tpu_session_builds_total by kind (plus "@<shards>" for
    mesh builds), from the live registry."""
    from ..scheduler.metrics import session_builds

    out: Dict[str, int] = {}
    for key, val in session_builds.items():
        kind = key[0] if key else "unknown"
        slug = f"{kind}{_shard_suffix(key)}"
        out[slug] = out.get(slug, 0) + int(val)
    return out


def _session_build_reasons() -> Dict[str, int]:
    """scheduler_tpu_session_builds_total by (kind, reason): the recorded
    WHY behind every session build — a hoisted row names its downgrade."""
    from ..scheduler.metrics import session_builds

    out: Dict[str, int] = {}
    for key, val in session_builds.items():
        kind = key[0] if key else "unknown"
        reason = key[1] if len(key) > 1 and key[1] else "-"
        slug = f"{kind}{_shard_suffix(key)}/{reason}"
        out[slug] = out.get(slug, 0) + int(val)
    return out


def _counter_window(now: Dict[str, int], base: Dict[str, int]) -> Dict[str, int]:
    return {
        k: v - base.get(k, 0) for k, v in now.items() if v - base.get(k, 0)
    }


def _counter_total(counter) -> int:
    return int(sum(v for _, v in counter.items()))


def _kernel_direct_rate(sched, w: "Workload", reps: int = 3) -> float:
    """Kernel-direct pods/s for THIS config, measured in-process on the
    run's own backend right after the loop phase (scheduler paused,
    pipeline drained): encode a batch stamped from the measured
    template and time raw session dispatches — no queue, no cache, no
    bind path. The same-config full-loop/kernel-direct ratio is what
    the ROADMAP "close the loop-vs-kernel gap" target regresses
    (>= 50% on Default-5000n).

    The measurement runs on a THROWAWAY session: the live session is
    torn down first (device_state() may donate dirty-row buffers a live
    session still references, and the phantom kdirect assumes must
    never land in a carry real pods could be decided against), the
    fresh session absorbs the build + bucket compile on the warm
    dispatch, and the polluted session is dropped again afterwards —
    the host encoding never sees the phantom pods, so a later real
    dispatch rebuilds clean. Callers freeze every in-window counter
    BEFORE calling this (the teardown/build pair is accounting noise).
    Failures (PVC templates the raw encoder cannot resolve, demoted
    backends) report 0.0 — the ratio is then omitted, never
    fabricated."""
    tpu = sched.tpu
    if tpu is None or not w.kernel_direct:
        return 0.0
    nb = max(1, min(w.max_batch, w.num_pods or 1, 512))
    pods = [w.template.build(f"kdirect-{i}") for i in range(nb)]
    try:
        with tpu._lock:
            tpu._flush_pending()
            arrays = []
            for p in pods:
                enc = tpu.pe.encode(p)
                arrays.append(
                    {k: v for k, v in enc.items() if not k.startswith("_")}
                )
            tpu._invalidate_session("kernel-direct")
            try:
                tpu._session_schedule(arrays)  # build + bucket compile
                t0 = time.perf_counter()
                for _ in range(reps):
                    tpu._session_schedule(arrays)
                dt = time.perf_counter() - t0
            finally:
                tpu._invalidate_session("kernel-direct")
        return nb * reps / dt if dt > 0 else 0.0
    except Exception:  # noqa: BLE001 — report the loop numbers regardless
        return 0.0


def run_workload(w: Workload, quiet: bool = True, device=None) -> Result:
    if w.backend == "tpu" and w.mesh_devices:
        raise NotImplementedError(
            f"Workload(mesh_devices={w.mesh_devices}): the sharded session "
            "is not ported yet")
    if not w.columnar:
        os.environ["KTPU_COLUMNAR_CACHE"] = "0"
    else:
        os.environ.pop("KTPU_COLUMNAR_CACHE", None)
    api = APIServer()
    http_srv = None
    if w.wire:
        from ..apiserver.http import HTTPAPIServer, RemoteAPIServer

        http_srv = HTTPAPIServer(api=api).start()
        api = RemoteAPIServer(http_srv.address)
    try:
        return _run(w, quiet, device, api)
    finally:
        if http_srv is not None:
            http_srv.stop()


def _run(w: Workload, quiet: bool, device, api) -> Result:
    cs = Clientset(api)
    csi_mode = "csi" in (w.template.with_pvc, w.init_template.with_pvc)
    migrated_mode = "migrated" in (
        w.template.with_pvc, w.init_template.with_pvc)
    for i in range(w.num_nodes):
        cs.nodes.create(
            make_node(
                f"node-{i}",
                labels={
                    v1.LABEL_HOSTNAME: f"node-{i}",
                    v1.LABEL_ZONE: f"zone-{i % w.n_zones}",
                    v1.LABEL_REGION: f"region-{i % w.n_zones % 2}",
                },
                extended=w.node_extended,
            )
        )
        if csi_mode or migrated_mode:
            from ..api.storage import CSINode, CSINodeDriver, CSINodeSpec

            drivers = []
            if csi_mode:
                drivers.append(CSINodeDriver(name=CSI_PERF_DRIVER, count=64))
            if migrated_mode:
                # performance-config.yaml:107-114 csiNodeAllocatable for
                # the migrated ebs driver
                drivers.append(
                    CSINodeDriver(name="ebs.csi.aws.com", count=39))
            cs.resource("csinodes").create(CSINode(
                metadata=v1.ObjectMeta(name=f"node-{i}"),
                spec=CSINodeSpec(drivers=drivers),
            ))
    if w.pdb_disruptions_allowed is not None:
        cs.resource("poddisruptionbudgets").create(v1.PodDisruptionBudget(
            metadata=v1.ObjectMeta(name="bench-pdb", namespace="default"),
            spec=v1.PodDisruptionBudgetSpec(
                selector=v1.LabelSelector(
                    match_labels=dict(w.init_template.labels or {})),
            ),
            status=v1.PodDisruptionBudgetStatus(
                disruptions_allowed=w.pdb_disruptions_allowed),
        ))
    factory = SharedInformerFactory(cs)
    tpu_backend = None
    if w.backend == "tpu":
        from ..scheduler.tpu_backend import TPUBackend

        tpu_backend = TPUBackend(device=device)
    sched = Scheduler(cs, factory, backend=w.backend, max_batch=w.max_batch,
                      tpu_backend=tpu_backend)
    if w.backend == "tpu":
        # pre-size the encoding for the whole workload: without this the
        # pod/term tables walk the 1.5x capacity ladder and every step is
        # a rebuild + fresh XLA compile inside the measured window
        total = w.num_init_pods + w.num_pods
        anti_per_pod = sum((
            w.template.anti_affinity_zone, w.template.anti_affinity_hostname,
        ))
        init_anti = sum((
            w.init_template.anti_affinity_zone,
            w.init_template.anti_affinity_hostname,
        ))
        sched.tpu.enc.reserve(
            pods=int(total * 1.25),
            anti_terms=w.num_pods * anti_per_pod + w.num_init_pods * init_anti,
        )
        if w.shadow_sample:
            sched.tpu.set_shadow_sample(w.shadow_sample)
    if w.backend == "oracle" or w.gang_size > 1:
        plugins = default_plugins_without("DefaultPreemption")
        plugin_config = {}
        if w.gang_size > 1:
            # Coscheduling needs BOTH points: permit gates, reserve indexes
            plugins["permit"] = [("Coscheduling", 1)]
            plugins["reserve"] = plugins.get("reserve", []) + [("Coscheduling", 1)]
            plugin_config["Coscheduling"] = {
                "permit_timeout_seconds": w.gang_permit_timeout
            }
        sched.framework = Framework(
            new_in_tree_registry(),
            plugins=plugins,
            plugin_config=plugin_config,
            snapshot_fn=lambda: sched.snapshot,
            handle_extras={"cache": sched.cache},
        )
        sched.framework.nominator = sched.nominator
        sched.framework.pdb_lister = sched._list_pdbs
    factory.start()
    # 5000-node initial lists take a while on a loaded host; the default
    # 10s sync window is for unit-test scale
    if not factory.wait_for_cache_sync(timeout=180.0):
        raise RuntimeError("informer sync failed")
    try:
        def _stage(n_create, create_one):
            """Create pods with the scheduler paused and resume only once
            the informer has delivered them all to the queue — so the
            drain happens in full max_batch buckets (each distinct batch
            bucket is a fresh XLA compile; racing the informer produces
            ragged first batches that compile inside the measured
            window)."""
            sched.pause()
            # let any in-flight schedule_one pop (0.2s timeout) park
            # before events start arriving, or it leaks a tiny batch
            time.sleep(0.3)
            for i in range(n_create):
                create_one(i)
            deadline = time.monotonic() + 60
            last, settled = -1, time.monotonic()
            while time.monotonic() < deadline:
                n = sched.queue.num_active()
                if n >= n_create:
                    break
                if n != last:
                    last, settled = n, time.monotonic()
                elif time.monotonic() - settled > 2.0:
                    break  # informer drained; count short of n_create is fine
                time.sleep(0.02)
            sched.resume()

        # init pods (scheduled but not measured — warms caches + compile)
        def _attach_pvc(pod, i, tmpl, prefix):
            """One pre-bound PVC+PV per pod (mustSetupScheduler's PV
            fixtures): zonal PVs carry the pod-index zone label
            (VolumeZone constraints), csi PVs a driver (attach limits)."""
            pv = v1.PersistentVolume(
                metadata=v1.ObjectMeta(
                    name=f"{prefix}pv-{i}",
                    labels=(
                        {v1.LABEL_ZONE: f"zone-{i % w.n_zones}"}
                        if tmpl.with_pvc in ("zonal", "migrated") else {}
                    ),
                ),
                spec=v1.PersistentVolumeSpec(
                    capacity={"storage": "1Gi"},
                    access_modes=["ReadWriteOnce"],
                    csi=(
                        {"driver": CSI_PERF_DRIVER, "volumeHandle": f"h-{i}"}
                        if tmpl.with_pvc == "csi" else None
                    ),
                    # SchedulingMigratedInTreePVs (performance-config.
                    # yaml:99-135, pv-aws.yaml): an IN-TREE cloud-disk
                    # source the csi-translation layer rewrites to its
                    # CSI twin (ebs.csi.aws.com)
                    aws_elastic_block_store=(
                        {"volumeID": f"vol-{prefix}{i}"}
                        if tmpl.with_pvc == "migrated" else None
                    ),
                ),
                status=v1.PersistentVolumeStatus(phase="Bound"),
            )
            cs.resource("persistentvolumes").create(pv)
            cs.resource("persistentvolumeclaims").create(
                v1.PersistentVolumeClaim(
                    metadata=v1.ObjectMeta(
                        name=f"{prefix}claim-{i}", namespace="default"
                    ),
                    spec=v1.PersistentVolumeClaimSpec(
                        access_modes=["ReadWriteOnce"],
                        volume_name=f"{prefix}pv-{i}",
                        resources=v1.ResourceRequirements(
                            requests={"storage": "1Gi"}
                        ),
                    ),
                )
            )
            pod.spec.volumes = [v1.Volume(
                name="data",
                source={"persistentVolumeClaim":
                        {"claimName": f"{prefix}claim-{i}"}},
            )]

        def _create_init(i):
            pod = w.init_template.build(f"init-{i}")
            if w.init_template.with_pvc:
                _attach_pvc(pod, i, w.init_template, "i-")
            cs.pods.create(pod)

        if w.num_init_pods:
            sched.start()
            _stage(w.num_init_pods, _create_init)
            if not _wait_all_bound(cs, w.num_init_pods, w.timeout):
                raise RuntimeError("init pods did not all bind")
        else:
            sched.start()

        # measured pods
        from ..scheduler.plugins.coscheduling import (
            GROUP_LABEL,
            MIN_AVAILABLE_LABEL,
        )

        # stage the full backlog (scheduler paused until the queue holds
        # every measured pod): the measured phase drains full max_batch
        # batches; the reference's harness likewise measures scheduling,
        # not client-side creation

        def _create_measured(i):
            tmpl = w.template
            if w.second_every and w.second_template is not None \
                    and i % w.second_every == 0:
                tmpl = w.second_template
            pod = tmpl.build(f"measure-{i}")
            if tmpl.with_pvc:
                _attach_pvc(pod, i, tmpl, "m-")
            if w.gang_size > 1:
                # annotations, not labels: gang identity must not enter
                # the encoded self rows (see coscheduling.pod_group)
                pod.metadata.annotations = {
                    GROUP_LABEL: f"gang-{i // w.gang_size}",
                    MIN_AVAILABLE_LABEL: str(w.gang_size),
                }
            cs.pods.create(pod)

        _stage(w.num_pods, _create_measured)
        from ..scheduler import metrics as sched_metrics

        def total_attempts() -> int:
            return int(sum(v for _, v in sched_metrics.schedule_attempts.items()))

        def bound_count() -> int:
            """Successful-bind count from the scheduler's own counter —
            NOT a pods.list(): hydrating 10k+ pods through serde every
            second inside the measured window is real host work that
            competes with the scheduler for the GIL and the store."""
            return int(sum(
                v for k, v in sched_metrics.schedule_attempts.items()
                if sched_metrics.SCHEDULED in k
            ))

        from ..scheduler.metrics import (
            conflict_replays,
            gang_admitted as gang_admitted_ctr,
            gang_preempted as gang_preempted_ctr,
            gang_rejected as gang_rejected_ctr,
            gang_rollbacks as gang_rollbacks_ctr,
            multipod_conflicts,
            parity_drift,
            preemption_planner,
            session_delta_applies,
            session_rebuilds,
            shadow_samples as shadow_samples_ctr,
            speculative_dispatches,
            whatif_fallbacks,
            whatif_launches,
        )

        attempts0 = total_attempts()
        builds0 = _session_build_counts()
        rebuild_reasons0 = _label_counts(session_rebuilds)
        delta_applies0 = _label_counts(session_delta_applies)
        conflicts0 = _counter_total(multipod_conflicts)
        replays0 = _counter_total(conflict_replays)
        spec0 = _label_counts(speculative_dispatches)
        planner0 = _label_counts(preemption_planner)
        whatif0 = _counter_total(whatif_launches)
        whatif_fb0 = _label_counts(whatif_fallbacks)
        shadow0 = _counter_total(shadow_samples_ctr)
        drift0 = _label_counts(parity_drift)
        gang_adm0 = _counter_total(gang_admitted_ctr)
        gang_rej0 = _label_counts(gang_rejected_ctr)
        gang_rb0 = _label_counts(gang_rollbacks_ctr)
        gang_pre0 = _counter_total(gang_preempted_ctr)
        # admission-latency samples are read from the plugin's buffer,
        # windowed by length mark (maxlen 100k >> any bench's wave
        # count, so init-phase samples never push measured ones out)
        gang_plugin = sched._gang_plugin()
        gang_samp0 = (
            len(gang_plugin.admission_samples)
            if gang_plugin is not None else 0
        )
        bound0 = bound_count()
        n_ts0 = len(sched.bind_timestamps)
        from ..utils import devtime, tracing

        trace_mark = tracing.RECORDER.mark() if tracing.enabled() else 0
        dt_mark = devtime.TIMELINE.mark() if devtime.enabled() else 0
        compiles0 = devtime.TIMELINE.compiles
        t0 = time.perf_counter()
        t0_mono = time.monotonic()  # bind_timestamps' clock
        last_bound = 0
        stall_since = t0
        deadline = t0 + w.timeout
        last_att = 0
        # this loop is ONLY the stop condition (completion / stall /
        # timeout): throughput comes from the scheduler's exact per-bind
        # timestamps below, not from this 1s polling grid — the grid's
        # quantization made every sub-second 500-node run read as a
        # 1000/k pods/s artifact (999.4 / 499.9 / 333.3 ...)
        while time.perf_counter() < deadline:
            time.sleep(1.0)
            bound = bound_count() - bound0
            att = total_attempts() - attempts0
            now = time.perf_counter()
            # the stall clock runs only while the scheduler is live but
            # not progressing: ATTEMPTS reset it too (a preemption wave
            # records failures long before its first bind), and nothing
            # counts as a stall before the first attempt (the first
            # dispatch of a fresh shape can compile for >30s on the chip)
            if bound != last_bound or att != last_att or (bound == 0 and att == 0):
                stall_since = now
            last_bound, last_att = bound, att
            if bound >= w.num_pods:
                break
            if w.stall_stop and now - stall_since >= w.stall_stop:
                break
        sched.pause()  # no fresh dispatches while results are read
        sched._drain_pipeline(timeout=30.0)  # land in-flight tail binds
        dt = time.perf_counter() - t0
        # exact measured-phase bind timestamps (monotonic, bind-sent
        # time; binder threads may land batches slightly out of order)
        bind_ts = sorted(
            t - t0_mono for t in list(sched.bind_timestamps)[n_ts0:]
        )
        bound_for_rate: Optional[int] = None
        if w.stall_stop and stall_since - t0 > 0 and last_bound < w.num_pods:
            # drop the idle stall tail from the measured window — and
            # the binds the post-pause pipeline drain landed AFTER it
            # (counting them against a dt cut at the stall point would
            # inflate the reported rate)
            dt = stall_since - t0
            bind_ts = [t for t in bind_ts if t <= dt]
            bound_for_rate = len(bind_ts)
        elif bind_ts and last_bound >= w.num_pods:
            # every measured pod bound: the window ends at the LAST BIND,
            # not at the poll loop's next 1s tick
            dt = max(bind_ts[-1], 1e-9)
        # percentile series scoped to the binding phase (see the Result
        # field comment): per-second bind rates over the exact
        # first-bind .. last-bind window, from the bind events themselves
        samples = _bind_rate_samples(bind_ts)
        pods, _ = cs.pods.list(namespace="default")
        # count bound MEASURED pods by name: preemption workloads evict
        # init pods, so "total bound minus num_init" would undercount
        bound_measured = sum(
            1 for p in pods
            if p.spec.node_name and p.metadata.name.startswith("measure-")
        )
        # exact per-pod latency percentiles over the measured pods: the
        # scheduler's sample ring holds (e2e, attempt, attempts) tuples;
        # take the most recent num_pods entries (init pods scheduled
        # first). A run that bound nothing reports 0.0s, not a stale
        # init-phase sample.
        lat = (
            list(sched.latency_samples)[-bound_measured:]
            if bound_measured > 0 else []
        )
        e2e = [s[0] for s in lat]
        att = [s[1] for s in lat]
        builds_total = _session_build_counts()
        builds = {
            k: v - builds0.get(k, 0)
            for k, v in builds_total.items()
            if v - builds0.get(k, 0)
        }
        if not samples and dt:
            # binding phase shorter than 1s: per-second cadence is
            # unresolvable — the run-average is the only honest sample
            samples = [
                (bound_for_rate if bound_for_rate is not None
                 else bound_measured) / dt
            ]
        tp_avg = round(
            (bound_for_rate if bound_for_rate is not None
             else bound_measured) / dt, 2
        ) if dt else 0.0
        # freeze EVERY in-window counter before the kernel-direct
        # measurement: its throwaway session teardown/build pair (and
        # any multipod replays it takes) must not leak into the
        # loop-phase accounting
        build_reasons = _session_build_reasons()
        rebuild_reasons = _counter_window(
            _label_counts(session_rebuilds), rebuild_reasons0
        )
        delta_applies = _counter_window(
            _label_counts(session_delta_applies), delta_applies0
        )
        n_conflicts = _counter_total(multipod_conflicts) - conflicts0
        n_replays = _counter_total(conflict_replays) - replays0
        spec_now = _label_counts(speculative_dispatches)
        planner_paths = _counter_window(
            _label_counts(preemption_planner), planner0
        )
        n_whatif = _counter_total(whatif_launches) - whatif0
        whatif_fb = _counter_window(
            _label_counts(whatif_fallbacks), whatif_fb0
        )
        n_shadow = _counter_total(shadow_samples_ctr) - shadow0
        shadow_drift = _counter_window(_label_counts(parity_drift), drift0)
        n_gang_adm = _counter_total(gang_admitted_ctr) - gang_adm0
        gang_rej = _counter_window(
            _label_counts(gang_rejected_ctr), gang_rej0
        )
        gang_rb = _counter_window(
            _label_counts(gang_rollbacks_ctr), gang_rb0
        )
        n_gang_pre = _counter_total(gang_preempted_ctr) - gang_pre0
        gang_samples = (
            list(gang_plugin.admission_samples)[gang_samp0:]
            if gang_plugin is not None else []
        )
        session_kind = (
            type(sched.tpu._session).__name__
            if sched.tpu is not None and sched.tpu._session is not None
            else ""
        )
        # per-stage latency attribution, scoped to the measured window
        # (the mark() anchor above) and frozen BEFORE the kernel-direct
        # measurement, whose throwaway dispatches must not pollute the
        # stage breakdown. Ring capacity bounds the window: a run that
        # out-writes KTPU_TRACE_CAPACITY keeps only the newest spans
        # (stage_window_s shows the actual coverage).
        stage_latency = None
        stage_window = 0.0
        trace_events: list = []
        if tracing.enabled():
            trace_events = tracing.RECORDER.snapshot(since=trace_mark)
            stage_latency = tracing.stage_stats(trace_events)
            stage_window = round(tracing.window_span(trace_events), 3)
        # device-timeline attribution, same anchoring discipline as the
        # stage breakdown: in-window records only, frozen BEFORE the
        # kernel-direct throwaway session (whose dispatches would
        # otherwise inflate device_busy). Overlap merges against the
        # ring spans captured above — with tracing off there is no host
        # timeline to merge, so host_busy/overlap honestly report 0.
        ov_ratio = 0.0
        device_time = None
        n_recompiles = 0
        if devtime.enabled():
            dt_records = devtime.TIMELINE.snapshot(since=dt_mark)
            device_time = devtime.device_time_summary(dt_records)
            ov = devtime.overlap(dt_records, trace_events)
            ov_ratio = ov["overlap_ratio"]
            device_time.update(
                {k: ov[k] for k in
                 ("window_s", "device_busy_s", "host_busy_s",
                  "overlapped_s")}
            )
            n_recompiles = devtime.TIMELINE.compiles - compiles0
        kd_rate = round(_kernel_direct_rate(sched, w), 2)
        return Result(
            name=w.name,
            backend=w.backend,
            num_nodes=w.num_nodes,
            num_pods=w.num_pods,
            duration_s=round(dt, 2),
            throughput_avg=tp_avg,
            throughput_p50=round(_percentile(samples, 50), 2),
            throughput_p90=round(_percentile(samples, 90), 2),
            throughput_p99=round(_percentile(samples, 99), 2),
            attempts=total_attempts() - attempts0,
            num_bound=bound_measured,
            pod_scheduling_p50=round(_percentile(e2e, 50), 4),
            pod_scheduling_p90=round(_percentile(e2e, 90), 4),
            pod_scheduling_p99=round(_percentile(e2e, 99), 4),
            attempt_p50=round(_percentile(att, 50), 4),
            attempt_p90=round(_percentile(att, 90), 4),
            attempt_p99=round(_percentile(att, 99), 4),
            session_builds=builds,
            session_builds_total=builds_total,
            session_build_reasons=build_reasons,
            session_rebuild_reasons=rebuild_reasons,
            session_delta_applies=delta_applies,
            session_kind=session_kind,
            attempts_per_sec=(
                round((total_attempts() - attempts0) / dt, 2) if dt else 0.0
            ),
            headline_metric=(
                "attempts_per_sec" if w.saturating else "pods_per_sec"
            ),
            multipod_conflicts=n_conflicts,
            conflict_replays=n_replays,
            speculative_hits=spec_now.get("hit", 0) - spec0.get("hit", 0),
            speculative_misses=spec_now.get("miss", 0)
            - spec0.get("miss", 0),
            kernel_direct_pods_per_sec=kd_rate,
            loop_kernel_ratio=(
                round(tp_avg / kd_rate, 4) if kd_rate else 0.0
            ),
            preemption_planner_paths=planner_paths,
            whatif_launches=n_whatif,
            whatif_fallbacks=whatif_fb,
            gang_admitted=n_gang_adm,
            gang_rejected=gang_rej,
            gang_rollbacks=gang_rb,
            gang_preempted=n_gang_pre,
            gang_admission_p50=round(_percentile(gang_samples, 50), 4),
            gang_admission_p99=round(_percentile(gang_samples, 99), 4),
            stage_latency=stage_latency,
            stage_window_s=stage_window,
            trace_level=tracing.level(),
            shadow_samples=n_shadow,
            shadow_drift=shadow_drift,
            mesh_shards=(
                int(sched.tpu.mesh.devices.size)
                if sched.tpu is not None and sched.tpu.mesh is not None
                else 0
            ),
            overlap_ratio=ov_ratio,
            device_time=device_time,
            recompiles=n_recompiles,
            devtime_level=devtime.level(),
        )
    finally:
        sched.stop()
        factory.stop()


def _wait_all_bound(cs: Clientset, n: int, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        pods, _ = cs.pods.list(namespace="default")
        if sum(1 for p in pods if p.spec.node_name) >= n:
            return True
        time.sleep(0.2)
    return False


# the reference's benchmark suite shapes (performance-config.yaml)
STANDARD_WORKLOADS = {
    "SchedulingBasic": Workload(
        "SchedulingBasic", num_nodes=500, num_init_pods=1000, num_pods=1000
    ),
    "Density3K": Workload("Density3K", num_nodes=100, num_pods=3000),
    "SchedulingPodTopologySpread": Workload(
        "SchedulingPodTopologySpread",
        num_nodes=500,
        num_init_pods=1000,
        num_pods=1000,
        template=PodTemplate(spread_zone=True),
    ),
    "SchedulingPodAntiAffinity": Workload(
        "SchedulingPodAntiAffinity",
        num_nodes=500,
        num_init_pods=100,
        num_pods=400,
        template=PodTemplate(anti_affinity_zone=False),
    ),
    "Scheduling5000Nodes": Workload(
        "Scheduling5000Nodes",
        num_nodes=5000,
        num_init_pods=1000,
        num_pods=1000,
        template=PodTemplate(spread_zone=True),
    ),
    # north-star gang-scheduling stress (BASELINE.md): 1000 groups x 8 pods,
    # 4000 GPU nodes, Coscheduling Permit gate
    "GangScheduling": Workload(
        "GangScheduling",
        num_nodes=4000,
        num_pods=8000,
        gang_size=8,
        template=PodTemplate(extended={"example.com/gpu": "1"}),
        node_extended={"example.com/gpu": "8"},
    ),
}
