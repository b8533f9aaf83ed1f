#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kubernetes_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from the sources in this checkout
   (into build/torch_kernels/; one nvcc per source, started together);
3. each kernel against its plain PyTorch version on the card, on a mixed
   ~600-node cluster (hostname DoNotSchedule spread, zone ScheduleAnyway
   spread, no constraint, tainted and unschedulable nodes, a
   capacity-starved template): out rows and carries must be equal;
4. the main path at full size, as bench.py sets it up: the batched
   scheduling session (ScanSession) over synth_cluster(5000) with
   3 x 4096 pending zone-spread pods — one warm-up batch, two measured
   batches; every pod must be placed, the kernel must have been launched
   once per batch, and the first measured batch must equal the plain
   version run from a copy of the same carry; its three launches must all
   have gone through the cluster kernel at the default size (`CLUSTER`);
   4b. the cluster sweep: on phase 4's first measured batch, from the
   carry before it, the one-block kernel and the cluster kernel at every
   size of 2, 4, 8, 16 blocks that the card can place, each equal to the
   plain version (out rows and carries) and timed (CUDA events, median of
   3); then two directed cases at Np = 768 (680 identical nodes), at every
   size: plain pods that tie on every lane, so the min-lane tie-break
   walks across every slice boundary, and pods that only the last node
   can take (in the last slice that holds a node; at 16 blocks the slice
   after it holds padding lanes only);
5. affinity-term templates (the kernel's ur > 0 variant) against the
   plain version on a ~600-node cluster whose bound pods carry terms
   too: hostname anti-affinity with more pods than nodes can take, zone
   affinity through the first-pod escape, weight-100 preferred zone
   anti-affinity, and plain pods carrying the anti-affine label
   (cross-template D1); out rows and all six carries must be equal, on
   one block and at every cluster size phase 4b placed;
6. the pod-affinity path at full size, as scheduler_perf's
   SchedulingPreferredPodAffinity-5000n and SchedulingPodAffinity-5000n
   set it up (scripts/bench_configs.py:267-281): 5000 nodes, 2048 bound
   app=aff pods, 5000 pending pods with the preferred (or required) zone
   affinity toward app=aff, batches of 904 (warm-up), 2048 and 2048;
   every pod must be placed, the ur > 0 variant launched once per batch,
   all three launches through the cluster kernel at `CLUSTER`, and the
   first measured batch must equal the plain version;
   6b. the ur > 0 sweep: phase 4b on each affinity cell's first measured
   batch (one block, then 2, 4, 8, 16 blocks; each == plain, rows and all
   six carries, and timed); then the directed `kcnt` cases at Np = 768,
   at every size: pods with a required (and, in the twin, preferred) zone
   affinity toward their own label, zones interleaved over the lanes, so
   that a block reading a stale `kcnt` would admit another zone's lanes
   (required: out row 2 and the decisions move) or drop the affinity
   score (preferred); every pod after the first lands in the first's
   zone;
7. multi-pod steps (mk = 4 pods per step, the conflict-suffix contract):
   a. on the phase-3 and phase-5 clusters, one mk=4 launch against the
      plain version (out rows 0-3 and carries), then `schedule_exact`
      (the backend's suffix replay) over every batch, whose decisions and final
      carries must equal an mk=1 session's;
   b. at full size on a zone-pinned tenant mix: synth_cluster(5000,
      n_zones=4) and 3 x 4096 pods of four tenants, tenant t pinned to
      zone-t by a required node affinity (SchedulingNodeAffinity-5000n,
      scripts/bench_configs.py:290-295, split into four node pools); an
      mk=1 and an mk=4 session over the same batches must place every
      pod with equal decisions and carries, and the first measured mk=4
      batch must equal the plain version; scan_multi and scan_full are
      timed on that batch from the same carry;
   c. at full size on the conflict-heavy batches (the phase-4 zone-spread
      batch and the phase-6 preferred-affinity batch): one `schedule` of
      an mk=4 session on the same cluster, from a copy of the carry (one
      launch each), rows and carries == plain version;
8. the "eval" and "apply" modes: on the first batch of the phase-3 and
   phase-5 clusters, eval -> apply pod by pod replays full mode exactly
   and a forced -1 leaves the carries bit-identical; each mode's kernel
   equals the plain version; at full size, the phase-4 session's
   `evaluate` over its first measured batch and `apply_decisions` of
   that batch's decisions, from the carry before it (one launch each):
   both == plain version, and the apply reproduces full mode's carry;
9. cluster churn into the live session (the kernel's delta mode): from the
   phase-4 session after its three batches, one flush of 4096 events, the
   backend's queue cap — 1024 evictions of pods phase 4 placed, 2048
   foreign pods bound to random nodes with the spread templates' labels
   and requests, 992 foreign pods with other labels, 32 allocatable-only
   node updates by a GCD multiple — each classified as the backend
   classifies it (kubernetes_tpu_torch/testing/churn.py); `apply_deltas`
   is one launch of scan_delta, which equals the plain version on a copy
   of the carry; the carries then equal a fresh session's built from the
   mutated encoding (unscaled, valid lanes), the next 4096-pod batch
   decides as the fresh session does, and so does a session built before
   the churn that takes the flush through the host seed path. The same on
   the phase-6 preferred-affinity session (ur > 0) with 256 foreign pods
   that match no term (`ucnt` / `kcnt` untouched), where an `app=aff`
   pod classifies as structural. In each cell the grid kernel is also
   held to the plain version (max abs err 0, every carry) on the flush
   in a seeded random order, on every event of it moved to one node, on
   64 random int32 payloads whose adds wrap, and on its first event
   alone. 1-event and full flushes are timed (the kernel by CUDA events;
   the `apply_deltas` call split into host prep and kernel) beside the
   fresh session's build;
10. the probes (kubernetes_tpu_torch/probes/, the counterparts of
   scripts/probe_pallas.py, probe_pallas2.py and probe_fixed_cost.py):
   each kernel == its plain version, probe_scan's first decisions 0..7,
   the fixed launch cost (first and steady launches, wall and CUDA-event
   time); int64_probe and torch.add(ones, a, alpha=2) each alone, by a
   CUDA graph of 200 launches replayed 5 times in turns (the medians);
11. the hoisted session (`HoistedSession`, plain torch: a Python loop of
   per-pod steps, no kernel of its own):
   a. from the encoding phase 4's session started from, the first 512
      pods of phase 4's first measured batch: `HoistedSession(cuda)`
      decides as `ScanSession(cuda)`; its build s, ms per pod (host window
      and CUDA events), pods/s, ScanSession's ms per pod on the same pods,
      and, under `torch.profiler` over 64 pods, kernels per pod and the
      card's busy share;
   b. the same on the preferred-affinity cell's first batch (904 pods,
      `dyn_ipa`);
   c. bench.py's zone-spread shape at 5000 nodes with a quarter of the
      pods carrying hostPort 8080: `ScanSession` refuses it
      (`host-ports`); `HoistedSession` on cuda and on cpu from the same
      encoding give identical decisions and carries (`cp_any` / `cp_wild`
      / `cp_trip` included), and no two placed pods share a node's port;
   d. explain_k=3 on 256 pods of 11a: `explain_payload` on cuda equals the
      one on cpu, and each placed pod's first candidate is its decision;
   e. phase 9's zone-spread flush, as its classified delta dicts, into a
      `HoistedSession(cuda)` built from the encoding before the churn: the
      carries, alloc and allowed_pods then equal a fresh session's from
      the mutated encoding, and the next 512 pods decide as it does;
   f. the f64 PTS weight log(n + 2) on the card: torch.log there against
      the port's table, and the table read on the card equal to the host's;
12. the backend (`scheduler/tpu_backend.py` TPUBackend, on the card) fed
   through a `SchedulerCache` it listens to (5000 nodes and their bound
   pods as cache events), batches through `dispatch_many` / `harvest` as
   a scheduler drives them, placements assumed back into the cache:
   a. phase 4's cell (3 x 4096 pods) on fresh backends at max_pending 2
      and 1, two runs each, alternating which goes first: every run
      binds every pod as phase 4's ScanSession did; the medians of pods/s
      over the two measured batches, the kernel's CUDA-event time over
      the host window, the host stages, the session build; and the first
      batch in two fresh processes, without and with a warm launch of the
      kernel session at build;
   b. phase 6's preferred-affinity cell (ur > 0): bindings == phase 6's;
   c. phase 9's zone-spread events (4096, the delta queue's cap) as cache
      events into 12a's depth-1 backend, queued as deltas; the next 4096
      pods flush them in one scan_delta launch and bind as a fresh backend
      fed the mutated cluster does, and the carries after equal its;
   d. 11c's host-port pods (512) through the backend on the card and on
      the CPU: HoistedSession on both (reason host-ports on the card),
      equal bindings;
   e. a fault drill on 12a's pods: a NaN harvest re-driven on the kernel,
      a dispatch raise that persists through the retries (demoting the
      ladder; the batch re-drives on the hoisted session), the probe
      re-promoting the ladder within the run (KTPU_PROBE_INTERVAL 0.05 s
      here), the next batches on the kernel; bindings == 12a's.
   12a-12c stay on the kernel rung with 0 device faults and 0 failed delta
   applies; each kernel of the kernels' line carries `backend_launches`,
   and scan_full, scan_full_ipa and scan_delta must have some.

13. the scheduler loop (`scheduler/scheduler.py` Scheduler: the port's
   APIServer, informers, PriorityQueue and TPUBackend on the card, bound
   through the apiserver), driven through its entry point
   `perf.harness.run_workload`:
   a. SchedulingBasic-500 (scripts/bench_configs.py's "basic" row: 500
      nodes, 1000 init and 1000 measured pods, max_batch 1024) on the card
      and on the CPU: every pod bound, to the same node on both; on the
      card the ladder stays on the kernel rung, the session is
      ScanSession, 0 device faults, scan_full launched;
   b. Default-5000n-10k (the "default5000" row: 5000 nodes, 6144 init and
      10000 measured zone-spread pods, max_batch 2048, kernel_direct):
      every pod bound, every scan_full launch on the `CLUSTER`-block
      cluster, loop_kernel_ratio > 0, and the bindings equal a fresh
      backend's `schedule_many` replay of the batches in the order the
      loop dispatched them, fed the same nodes through a SchedulerCache;
      (d: the same cell, at `TRACED_PODS` init and measured pods, with
      the flight recorder on, level 1, for the loop's per-stage span
      summary: pop, dispatch, wait, harvest, assume, bind, ...);
   c. the ladder through the loop (13a's cluster, max_batch 64): a
      dispatch raise from the second measured batch on demotes to the
      oracle rung, whose framework chain schedules the faulted batch; the
      probe re-promotes to the kernel rung; a pod bound mid-run by another
      actor reaches the live session as a delta (scan_delta launched);
      every pod bound once, no node over its allocatable.
   Each cell prints pods/s (mean, p50, p90), pod scheduling latency p50
   and p99, attempts, the window and wall time, session builds, launches
   per kernel variant, kernel ms per measured batch by CUDA events around
   the backend's launches, the kernel share of the window and
   loop_kernel_ratio; the kernels' line gains `loop_launches`.

14. the device preemption planner (`ops/whatif.py`; the what-if's
   kernels of `ops/csrc/whatif.cu`: the context kernel once a context and
   template, the minimum-structure kernel and the walk once a preemptor;
   the device rung of `scheduler/preemption_device.py`), the what-if on by
   its default:
   a-c. Preemption-500n-500hi, Preemption-PDB-500n-500hi and
      Preemption-IPA-500n-500hi (scripts/bench_configs.py:131-137,
      :229-237, :245-255: 500 nodes saturated by 2000 priority-1 pods,
      `PREEMPTORS` (256 of the rows' 500) priority-100 preemptors;
      PDB-covered victims; preemptors with a
      required zone affinity toward the victims) through `run_workload`:
      every preemptor bound, no node over its allocatable, every victim of
      priority 1, every preemptor planned on the device rung (no what-if
      fallback but the planner's node-skew guard, a pod re-planned while
      victims' delete echoes move the encoding), the ladder on its top
      rung with 0 faults; the what-if and context kernels' launches
      counted from 0 over each call (the minimum-structure kernel's: 0,
      no preemptor has a spread constraint), the first 64 of each held to
      the plain version; 14a's first launches timed (CUDA graph), == plain,
      against both bounds (what the launches read and write for their
      dims and data; a walk-only kernel's);
   d. scripts/probe_preemption.py's sweep (50x2, 200x4, 500x4, 500x8 and
      the affinity preemptors at 50x2, 200x4; waves of 8, preemptors
      asking twice the probe's request so that each needs an eviction) on
      fresh backends on the card: the device, fast and oracle plans
      agree; ms per preemptor of each rung, the kernels alone (CUDA graph)
      against their bounds and the plain version, context builds; CUDA
      launches and the card's busy ms per what-if at 500x8 and at the
      affinity preemptors' 200x4 (`torch.profiler`, in a fresh process:
      the torch-prologue design before the kernels took the prologue in
      had 54 launches and 0.10-0.17 ms); every what-if and context launch
      of the sweep held to the plain version on the card;
   e. raise-whatif on a wave's first preemptor: it falls to the fast rung
      on the same books, no victim claimed twice, no session rebuild;
   f. `gang_feasible` on the card against the same reductions on the CPU
      at several k;
   g. directed what-if cases (plain, spread, affinity, first-pod-escape
      and host-port preemptors over 10- and 600-node clusters; L 4 / 8 /
      16, gang slots, nominated pods, claimed drains): the context kernel
      and the what-if == the plain version, the minimum-structure kernel
      launched exactly for the spread preemptor; at 600 nodes each kind's
      what-if, and the minimum-structure kernel alone, timed against
      their bounds.

15. the rest of the scheduler_perf matrix on the card, after every earlier
   session is released:
   a. ops/batch.py `schedule_batch` (eager torch, the reference's
      sequential batch) on phase 4's cluster at full width over the first
      512 pods of its first measured batch: decisions == a ScanSession's
      on the same pods from the same encoding, and new_carry's
      requested / nz_requested / pod_count and pod rows == the host
      encoding after them; ms per pod (host window, CUDA events) and
      kernels per pod (torch.profiler);
   b. every other single-device row of scripts/bench_configs.py (:55-300;
      `MATRIX_ROWS`: PTS-heavy, IPA churn, the three gang rows,
      unschedulable churn, secrets, the in-tree / CSI / migrated PV rows,
      the pod-affinity and node-affinity rows at 500 and 5000 nodes)
      through `run_workload` on the card at the sizes that file gives
      them, but for the measured pods of the 5000-node twins, PTS-heavy
      and the 8- and 64-pod gangs (`TWIN_PODS`, `PTS_PODS`, `GANG_PODS`):
      every measured pod bound (the two saturating rows: some), no node
      over its allocatable in any resource, no two anti-affine pods on
      one hostname, the ladder on its top rung with 0 device faults; the
      non-saturating rows' bindings == a fresh backend's `schedule_many`
      replay of the loop's batches (the PV rows with the run's volumes);
      the 500-node rows' bindings == the port's CPU run of the row (six
      at a time in worker processes, after every timed run); the gang
      rows 0 rollbacks, 0 rejections and no torn gang (testing/faults.py
      GangIntegrityChecker); the PV rows each pod's PV zone its node's
      zone and no node over its CSINode attach count. Each row prints
      pods/s (mean, p50, p90), attempts/s, latency p50 / p99, the window,
      the session builds with their reasons, the rung each batch rode
      (session class / ladder mode) and the pods scheduled on the oracle
      path, launches by variant, planner paths and what-if launches;
   c. SchedulingBasic-500 and Default-5000n-10k (BENCH_WIRE_CONFIGS.json's
      first two rows) with `wire=True`: the HTTP apiserver
      (apiserver/http.py) under every client, Default-5000n-10k at
      `WIRE_DEFAULT_PODS` init and measured pods; SchedulingBasic-500's
      bindings == 13a's in process, pods/s and latency beside them;
      Default-5000n-10k's == a `schedule_many` replay of its batches.

16. the node-sharded mesh (parallel/, ops/sharded_scan.py
   ShardedScanSession, TPUBackend(mesh=), Workload(mesh_devices)) on the
   card: shards share cuda:0, in both layouts — one group of k shards,
   and k one-shard groups (the cross-group collectives on one card):
   a. phase 4's zone-spread cell (its first measured 4096-pod batch) and
      phase 6's preferred-affinity cell (its 2048-pod batch, ur > 0), from
      the encodings their sessions started from, at 1, 2, 3 and 8 shards
      in both layouts: best, score and n_feasible == ScanSession's on the
      same pods, the gathered carries == its carries; ms per pod, and
      kernels per pod and the card's busy share under torch.profiler;
   b. phase 9's 4096-event flush into 8-shard sessions in both layouts
      (one scan_delta launch a group, each == the plain version): carries
      == ScanSession's after the same flush and a rebuild's, the next
      batch as both; and on a hostname-only 5000-node cluster 64 node
      leaves, 64 joins and 512 pod events into a live 8-group session:
      carries == a rebuild's, the next batch as the rebuild and
      ScanSession;
   c. Mesh-20000n-8sh (scripts/bench_configs.py:305) through
      `run_workload` unreduced: every batch on ShardedScanSession at the
      kernel rung; the bindings == the same row on the single-device loop
      and a `schedule_many` replay; pods/s and latency of both runs;
   d. the three Preemption rows' clusters, their first 64 preemptors
      planned by the device rung on an 8-shard backend and a
      single-device one: equal plans; the mesh's what-if and context
      launches held to the plain version;
   e. an explain build and a ladder-demoted build of the mesh backend:
      HoistedSessions on the lead device, counted under their reasons,
      deciding 512 of 16a's pods as 16a did.
   The kernels' line's scan_delta, whatif and whatif_context entries
   gain `mesh_launches` (phase 16's own, which must not be 0).

17. the workload controllers and admission (controllers/, apiserver/
   admission.py) driving the card's scheduler, after every earlier
   session is released: the port's APIServer with the default admission
   chain, informers, `scheduler.factory.create_scheduler` (TPUBackend on
   the card, max_batch 2048), the ReplicaSet, Deployment, DaemonSet,
   StatefulSet, Job, Namespace, Endpoints, volume-protection,
   node-lifecycle and garbage-collector controllers started by hand, over
   Default-5000n-10k's 5000 nodes (registered Ready, the not-ready taint
   admission gives them lifted by the node lifecycle controller). Until
   the kubelets are ported, `StatusWriter` stands in for them: it marks
   every bound pod Running and Ready (a Job's pod Succeeded) and renews
   the nodes' leases. Pods are cut by 4 (`CTRL_*`):
   a. a Deployment of 512 zone-spread replicas (DoNotSchedule, maxSkew 1
      per version), then a new template rolled out at maxSurge and
      maxUnavailable 25 %: every replica bound once, zone skew <= 1 for
      each ReplicaSet, no node over its allocatable, the first rollout's
      bindings equal a fresh backend's `schedule_many` replay of its
      batches, the rollout's deletions applied as deltas (scan_delta);
   b. a Deployment of 256 replicas with a weight-100 preferred hostname
      anti-affinity (ur > 0): every replica bound, scan_full_ipa on the
      `CLUSTER`-block cluster, bindings equal a replay;
   c. 32 nodes holding 17a's pods stop heartbeating (grace 8 s): the node
      lifecycle controller taints them unreachable:NoExecute and evicts
      17a's pods (`fast_failover`), the ReplicaSet re-creates them, each
      re-bound, none created after a taint bound to a tainted node;
      eviction-to-rebind latency, and the session teardowns and builds
      the taints caused, by reason;
   d. Deployment 17a deleted with background propagation: the garbage
      collector removes its ReplicaSets and pods; the deletes flushed
      into the live ScanSession leave carries equal to a fresh session's
      built from the encoding; a Job of 128 pods binds as a fresh backend
      fed that cluster decides, then completes; a DaemonSet over a 64-node
      pool puts one pod on each pool node and none elsewhere, the rung of
      each of its batches and every session refusal printed.
   Every batch of a-c on the kernel session at the ladder's top rung, 0
   device faults, 0 controller sync errors (`SyncErrors`); the kernels'
   line gains `controllers_launches` (phase 17's own; scan_full,
   scan_full_ipa and scan_delta must have some).

It prints the kernels' line, a `{"hoisted_session": ...}` line with phase
11's numbers, a `{"backend": ...}` line with phase 12's, a `{"loop": ...}`
line with phase 13's, a `{"preemption": ...}` line with phase 14's, a
`{"matrix": ...}` line with phase 15's, a `{"mesh": ...}` line with phase
16's, a `{"controllers": ...}` line with phase 17's, then `{"ok": true,
"device": {...}}` last.
It needs a CUDA card and imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096
AFF_BATCHES = (904, 2048, 2048)   # scheduler_perf max_batch 2048, 5000 pods
MK = 4                           # pods per multi-pod step in phase 7
TENANTS = 4
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
SOURCE = "kubernetes_tpu_torch/ops/csrc/scan_full.cu"
PROBES = "kubernetes_tpu_torch/probes/csrc/probes.cu"
REPLACES = "kubernetes_tpu/ops/pallas_scan.py"
CHURN = {"evict": 1024, "spread": 2048, "other": 992, "alloc": 32}
AFF_FOREIGN = 256
HOISTED_PODS = 512               # pods per phase-11 batch (11a, 11c, 11e)
EXPLAIN_PODS = 256               # phase 11d
PROFILED_PODS = 64               # phases 11a / 11b under torch.profiler
HOST_PORT = 8080


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def encode_templates(pe, pods):
    from kubernetes_tpu_torch.ops.hoisted import template_fingerprint

    arrays = [{k: v for k, v in pe.encode(p).items() if not k.startswith("_")}
              for p in pods]
    templates, seen = [], set()
    for a in arrays:
        fp = template_fingerprint(a)
        if fp not in seen:
            seen.add(fp)
            templates.append(a)
    return arrays, templates


def presized_encoding(nodes, init_pods, pending):
    """bench.py's phantom pre-sizing: the pod table is sized for the
    whole run in one rebuild."""
    from kubernetes_tpu_torch.models.encoding import ClusterEncoding
    from kubernetes_tpu_torch.models.pod_encoder import PodEncoder
    from kubernetes_tpu_torch.testing.synth import synth_pending_pods

    enc = ClusterEncoding()
    phantoms = []
    for i, p in enumerate(pending):
        q = synth_pending_pods(1, spread=True)[0]
        q.metadata.name = f"phantom-{i}"
        q.metadata.labels = dict(p.metadata.labels or {})
        q.spec.node_name = nodes[i % len(nodes)].metadata.name
        phantoms.append(q)
    enc.set_cluster(nodes, init_pods + phantoms)
    pe = PodEncoder(enc)
    for p in pending[:8]:
        pe.encode(p)
    enc.device_state("cuda")
    for q in phantoms:
        enc.remove_pod(q)
    return enc, pe


def reserved_encoding(nodes, init_pods, pending, anti_terms=0):
    """The encoding pre-sized for the whole workload as the perf harness
    does (kubernetes_tpu/perf/harness.py:603-614): pod rows for every
    pod with 25 % headroom and the anti-affinity term rows; and, beyond
    the harness, score-term rows for every pod, so that binding a placed
    pod into the encoding is an incremental row write and never defers a
    full rebuild out of the measured window."""
    from kubernetes_tpu_torch.models.encoding import ClusterEncoding
    from kubernetes_tpu_torch.models.pod_encoder import PodEncoder

    enc = ClusterEncoding()
    enc.reserve(pods=int((len(init_pods) + len(pending)) * 1.25),
                anti_terms=anti_terms,
                score_terms=len(init_pods) + len(pending))
    enc.set_cluster(nodes, init_pods)
    pe = PodEncoder(enc)
    for p in pending[:8]:
        pe.encode(p)
    enc.device_state("cuda")
    return enc, pe


def reset_counts(sk):
    sk.LAUNCHES = 0
    sk.VARIANT_LAUNCHES.update(dict.fromkeys(sk.VARIANT_LAUNCHES, 0))
    sk.CLUSTER_LAUNCHES.update(dict.fromkeys(sk.CLUSTER_LAUNCHES, 0))


def only(sk, **counts):
    """The launch counts expected when only the named variants ran."""
    want = dict.fromkeys(sk.VARIANT_LAUNCHES, 0)
    want.update(counts)
    return want


def batch_inputs(sess, arrays, mode="full"):
    """The kernel inputs ScanSession builds for this batch."""
    import torch
    from kubernetes_tpu_torch.ops.scan import LANE, batch_prologue

    Bp, tmpl, mfa, msa = batch_prologue(sess._fps, sess._tp_np, arrays,
                                        minimum=LANE,
                                        require_unbound=mode == "full")
    meta, match = sess._pack_batch(len(arrays), Bp, tmpl, mfa, msa)
    return (torch.from_numpy(meta).to(sess.device),
            torch.from_numpy(match).to(sess.device))


def forced_pairs(sess, decisions, Bp):
    """apply's int32 [2*Bp] payload of (lane | -1, ok) pairs."""
    import torch

    fv = torch.zeros(2 * Bp, dtype=torch.int32)
    for i, d in enumerate(decisions):
        fv[2 * i] = d if d >= 0 else -1
        fv[2 * i + 1] = 1 if d >= 0 else 0
    return fv.to(sess.device)


def clone(carry):
    return {k: v.clone() for k, v in carry.items()}


def clone_to(carry, device):
    return {k: v.to(device, copy=True) for k, v in carry.items()}


def carries_equal(a, b) -> bool:
    import torch

    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def carry_err(carry_a, carry_b) -> int:
    return max(int((carry_a[k].long() - carry_b[k].long()).abs().max())
               for k in carry_a)


def max_abs_err(out_a, out_b, n, carry_a, carry_b) -> int:
    err = int((out_a[:4, :n].long() - out_b[:4, :n].long()).abs().max())
    return max(err, carry_err(carry_a, carry_b))


def weights_of(sk, sess):
    return tuple(int(sess.weights[k]) for k in sk.WEIGHT_ORDER)


def kernel_vs_plain(sess, arrays, carry, mode="full", mk=1, decisions=None):
    """Kernel and plain version on the same inputs from equal carries, in
    `mode` with mk pods per step (apply: `decisions` forced); returns
    (max_abs_err, kernel out, kernel ms, plain ms). `carry` is advanced
    by the kernel."""
    import torch
    from kubernetes_tpu_torch.ops import scan_kernel as sk

    meta, match = batch_inputs(sess, arrays, mode)
    forced = (forced_pairs(sess, decisions, meta.shape[0] - 1)
              if mode == "apply" else None)
    weights = weights_of(sk, sess)
    ref_carry = clone(carry)
    statics = sess._get_statics()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = sk.scan_full(meta, match, statics, carry, sess.shapes, weights,
                       mode=mode, mk=mk, forced=forced)
    e1.record()
    torch.cuda.synchronize()
    kernel_ms = e0.elapsed_time(e1)
    t0 = time.perf_counter()
    ref = sk.scan_full_reference(meta, match, statics, ref_carry,
                                 sess.shapes, weights, mode=mode, mk=mk,
                                 forced=forced)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n = len(arrays)
    equal = torch.equal(out[:4, :n], ref[:4, :n]) and carries_equal(
        carry, ref_carry)
    err = max_abs_err(out, ref, n, carry, ref_carry)
    if not equal:
        raise AssertionError(f"scan_full (UR={sess.UR}, mode={mode}, "
                             f"mk={mk}) kernel != plain version (max abs "
                             f"err {err})")
    return err, out, kernel_ms, plain_ms


def time_kernel(sess, arrays, carry, mode="full", mk=1, decisions=None,
                runs=3, cluster=None):
    """Median CUDA-event ms of `runs` launches, each from a copy of
    `carry` (`cluster` as scan_full takes it); returns (median, the
    runs)."""
    import torch
    from kubernetes_tpu_torch.ops import scan_kernel as sk

    meta, match = batch_inputs(sess, arrays, mode)
    forced = (forced_pairs(sess, decisions, meta.shape[0] - 1)
              if mode == "apply" else None)
    times = []
    for _ in range(runs):
        c = clone(carry)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        sk.scan_full(meta, match, sess._get_statics(), c, sess.shapes,
                     weights_of(sk, sess), mode=mode, mk=mk, forced=forced,
                     cluster=cluster)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times), times


def sizes_vs_plain(sk, sess, arrays, carry, sizes, label, ref=None):
    """Mode "full" at every cluster size in `sizes` (1 = the one-block
    kernel), each from a copy of `carry` and == the plain version: out
    rows 0-3 and every carry. `ref` is the plain version's (out, carry)
    from `carry`, run here when None. A size the card cannot place is
    logged and left out. Returns (ref out, ref carry, the sizes run)."""
    import torch

    meta, match = batch_inputs(sess, arrays)
    statics, w = sess._get_statics(), weights_of(sk, sess)
    if ref is None:
        ref_carry = clone(carry)
        ref = (sk.scan_full_reference(meta, match, statics, ref_carry,
                                      sess.shapes, w), ref_carry)
    ref_out, ref_carry = ref
    k = len(arrays)
    ran = []
    for cb in sizes:
        c = clone(carry)
        try:
            out = sk.scan_full(meta, match, statics, c, sess.shapes, w,
                               cluster=cb)
        except sk.ClusterUnplaceable as e:
            log(f"{label}: {e}; left out")
            continue
        torch.cuda.synchronize()
        if not (torch.equal(out[:4, :k], ref_out[:4, :k])
                and carries_equal(c, ref_carry)):
            raise AssertionError(
                f"{label} at cluster={cb}: kernel != plain version (max abs "
                f"err {max_abs_err(out, ref_out, k, c, ref_carry)})")
        ran.append(cb)
    return ref_out, ref_carry, ran


def small_case():
    """~600 nodes, 4 templates, 512 pods in batches of 256 (phase 3)."""
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.testing.synth import make_pod, synth_cluster

    nodes, init_pods = synth_cluster(600, pods_per_node=1, seed=7)
    for i, node in enumerate(nodes):
        taints = []
        if i % 7 == 0:
            taints.append(v1.Taint("dedicated", "infra", "NoSchedule"))
        if i % 5 == 0:
            taints.append(v1.Taint("spot", "true", "PreferNoSchedule"))
        node.spec.taints = taints or None
        node.spec.unschedulable = i % 11 == 0
        if i % 30 == 0:  # the only nodes with the scarce resource
            node.status.allocatable["example.com/gpu"] = "2"
            node.status.capacity["example.com/gpu"] = "2"

    def spread(key, action, app):
        return [v1.TopologySpreadConstraint(
            max_skew=1, topology_key=key, when_unsatisfiable=action,
            label_selector=v1.LabelSelector(match_labels={"app": app}))]

    pending = []
    for i in range(512):
        t = i % 4
        if t == 0:
            p = make_pod(f"host-{i}", cpu="100m", labels={"app": "host"},
                         constraints=spread(v1.LABEL_HOSTNAME,
                                            "DoNotSchedule", "host"))
        elif t == 1:
            p = make_pod(f"zone-{i}", cpu="200m", memory="256Mi",
                         labels={"app": "zone"},
                         constraints=spread(v1.LABEL_ZONE, "ScheduleAnyway",
                                            "zone"))
        elif t == 2:
            p = make_pod(f"plain-{i}", cpu="50m", labels={"app": "plain"})
            p.spec.tolerations = [v1.Toleration(
                key="dedicated", operator="Exists", effect="NoSchedule")]
        else:
            p = make_pod(f"gpu-{i}", cpu="500m", labels={"app": "gpu"},
                         extended={"example.com/gpu": "1"})
        pending.append(p)
    enc, pe = presized_encoding(nodes, init_pods, pending)
    arrays, templates = encode_templates(pe, pending)
    return {"label": "phase-3 cluster", "enc": enc, "arrays": arrays,
            "templates": templates, "batch": 256, "nodes": len(nodes)}


def phase_small(case):
    """Phase 3: kernel == plain on the ~600-node cluster."""
    from kubernetes_tpu_torch.ops.scan import ScanSession

    arrays = case["arrays"]
    sess = ScanSession(case["enc"].device_state("cuda"), case["templates"],
                       multipod_k=1, device="cuda")
    carry = sess._initial_carry()
    carry0 = clone(carry)
    err = 0
    placed = unplaced = 0
    kernel_ms = []
    for lo in (0, 256):
        batch = arrays[lo:lo + 256]
        e, out, ms, _ = kernel_vs_plain(sess, batch, carry)
        err = max(err, e)
        kernel_ms.append(ms)
        best = out[0, :len(batch)]
        placed += int((best >= 0).sum())
        unplaced += int((best < 0).sum())
    if unplaced == 0 or placed == 0:
        raise AssertionError(f"small cluster: expected both placed and "
                             f"unplaced pods, got {placed}/{unplaced}")
    log(f"phase 3: kernel == plain on {case['nodes']} nodes, T={sess.T}, "
        f"{len(arrays)} pods in 2 batches ({placed} placed, {unplaced} "
        "unschedulable)")
    # the first batch again from the same carry: is its first launch slow
    # because it is the process's first, or because of its work?
    _, again = time_kernel(sess, arrays[:256], carry0)
    log(f"phase 3: scan_full {[round(x, 3) for x in kernel_ms]} ms per "
        f"256-pod batch at Np={sess.Np}; the first batch again from its "
        f"carry {[round(x, 3) for x in again]} ms")
    return err


def affinity(v1, kind, labels, key):
    """A pod (anti-)affinity with one term toward `labels` on `key`:
    kind is "anti" / "aff" (required) or "pref-anti" / "pref-aff"
    (preferred, weight 100 — the scheduler_perf templates)."""
    term = v1.PodAffinityTerm(
        label_selector=v1.LabelSelector(match_labels=dict(labels)),
        topology_key=key)
    if kind.startswith("pref-"):
        weighted = [v1.WeightedPodAffinityTerm(weight=100,
                                               pod_affinity_term=term)]
        if kind == "pref-anti":
            return v1.Affinity(pod_anti_affinity=v1.PodAntiAffinity(
                preferred_during_scheduling_ignored_during_execution=weighted))
        return v1.Affinity(pod_affinity=v1.PodAffinity(
            preferred_during_scheduling_ignored_during_execution=weighted))
    if kind == "anti":
        return v1.Affinity(pod_anti_affinity=v1.PodAntiAffinity(
            required_during_scheduling_ignored_during_execution=[term]))
    return v1.Affinity(pod_affinity=v1.PodAffinity(
        required_during_scheduling_ignored_during_execution=[term]))


def terms_case():
    """~600 nodes, 4 term templates, 1024 pods in batches of 512 (phase
    5). Bound pods carry the hostname anti-affinity on 400 of the nodes,
    so the anti-affine template runs out of nodes."""
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.testing.synth import make_pod, synth_cluster

    nodes, init_pods = synth_cluster(600, pods_per_node=1, seed=11)
    anti = affinity(v1, "anti", {"app": "anti"}, v1.LABEL_HOSTNAME)
    init_pods += [make_pod(f"bound-anti-{i}", cpu="100m",
                           labels={"app": "anti"}, affinity=anti,
                           node_name=nodes[i].metadata.name)
                  for i in range(len(nodes)) if i % 3 != 0]
    pending = []
    for i in range(1024):
        t = i % 4
        if t == 0:    # hostname anti-affinity toward its own label
            p = make_pod(f"anti-{i}", cpu="100m", labels={"app": "anti"},
                         affinity=anti)
        elif t == 1:  # zone affinity toward a label no bound pod carries
            p = make_pod(f"aff-{i}", cpu="100m", memory="64Mi",
                         labels={"svc": "new"},
                         affinity=affinity(v1, "aff", {"svc": "new"},
                                           v1.LABEL_ZONE))
        elif t == 2:  # weight-100 preferred zone anti-affinity
            p = make_pod(f"pref-{i}", cpu="200m", labels={"tier": "pref"},
                         affinity=affinity(v1, "pref-anti", {"tier": "pref"},
                                           v1.LABEL_ZONE))
        else:         # plain, with the label template 0's terms select
            p = make_pod(f"plain-{i}", cpu="50m", labels={"app": "anti"})
        pending.append(p)
    enc, pe = reserved_encoding(nodes, init_pods, pending,
                                anti_terms=len(init_pods) + len(pending))
    arrays, templates = encode_templates(pe, pending)
    return {"label": "phase-5 cluster", "enc": enc, "arrays": arrays,
            "templates": templates, "batch": 512, "nodes": len(nodes)}


def phase_terms_small(sk, gpu, case, sizes):
    """Phase 5: the ur > 0 kernel == plain on the ~600-node term
    cluster, at the default size and at every other size in `sizes`."""
    from kubernetes_tpu_torch.ops.scan import ScanSession

    arrays = case["arrays"]
    sess = ScanSession(case["enc"].device_state("cuda"), case["templates"],
                       multipod_k=1, device="cuda")
    if not sess.UR:
        raise AssertionError("term templates did not select the ur > 0 "
                             "variant")
    carry = sess._initial_carry()
    err = 0
    kernel_ms = []
    decisions = []
    for lo in (0, 512):
        batch = arrays[lo:lo + 512]
        before = clone(carry)
        e, out, ms, _ = kernel_vs_plain(sess, batch, carry)
        sizes_vs_plain(sk, sess, batch, before,
                       [cb for cb in sizes if cb != sk.CLUSTER],
                       f"phase 5 batch {lo // 512}", ref=(out, carry))
        err = max(err, e)
        kernel_ms.append(ms)
        decisions += out[0, :len(batch)].tolist()
    placed = [0] * 4
    for i, d in enumerate(decisions):
        placed[i % 4] += d >= 0
    if placed[0] >= 256 or min(placed[1:]) == 0:
        raise AssertionError(f"term cluster: expected unschedulable "
                             f"anti-affine pods and every other template "
                             f"placed, got {placed} of 256 each")
    log(f"phase 5: scan_full_ipa == plain on {case['nodes']} nodes, "
        f"T={sess.T}, UR={sess.UR}, {len(arrays)} pods in 2 batches, at "
        f"every cluster size {sorted(set(sizes) | {sk.CLUSTER})}, placed "
        f"per template {placed} of 256")
    log(f"phase 5: scan_full_ipa {[round(x, 3) for x in kernel_ms]} ms per "
        f"512-pod batch at Np={sess.Np} (cluster={sk.CLUSTER}) [{gpu}]")
    return err


def phase_zone_spread(sk, gpu):
    """Phase 4: the main path at full size. Returns its numbers and the
    session (and its mk=4 twin on the same cluster), the first measured
    batch, the carry before it and the carry after it (the kernel's, from
    that carry)."""
    import torch
    from kubernetes_tpu_torch.ops.scan import ScanSession
    from kubernetes_tpu_torch.testing.synth import (
        synth_cluster,
        synth_pending_pods,
    )

    t0 = time.perf_counter()
    nodes, init_pods = synth_cluster(5000, pods_per_node=2)
    pending = synth_pending_pods(3 * BATCH, spread=True)
    enc, pe = presized_encoding(nodes, init_pods, pending)
    _, templates = encode_templates(pe, pending)
    log(f"setup: {len(nodes)} nodes, {len(init_pods)} init pods, "
        f"{len(pending)} pending in {time.perf_counter() - t0:.1f} s")
    # the encoding the session starts from, for phase 11a
    snapshot0 = enc.host_snapshot()
    t0 = time.perf_counter()
    sess = ScanSession(enc.device_state("cuda"), templates, multipod_k=1,
                       device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the same session at mk pods per step, for phase 7c
    multi = ScanSession(enc.device_state("cuda"), templates, multipod_k=MK,
                        device="cuda")
    log(f"session build: {build_s:.3f} s (N={sess.N}, Np={sess.Np}, "
        f"T={sess.T}, C={sess.C}, R={sess.R}, K={sess.K}) [{gpu}]")

    stage = {"encode": 0.0, "schedule": 0.0, "wait": 0.0, "harvest": 0.0}

    def run_batch(lo):
        """bench.py's session loop for one batch: encode, schedule (one
        kernel launch), wait for the decisions, bind them back into the
        encoding."""
        pods = pending[lo:lo + BATCH]
        t = [time.perf_counter()]
        batch = [{k: v for k, v in pe.encode(p).items()
                  if not k.startswith("_")} for p in pods]
        t.append(time.perf_counter())
        ys = sess.schedule(batch)
        t.append(time.perf_counter())
        decisions = ScanSession.decisions(ys)
        t.append(time.perf_counter())
        for pod, best in zip(pods, decisions):
            if best >= 0:
                pod.spec.node_name = enc.node_names[best]
                enc.add_pod(pod, pod.spec.node_name)
        t.append(time.perf_counter())
        for name, a, b in zip(stage, t, t[1:]):
            stage[name] += b - a
        return batch, ys, decisions

    reset_counts(sk)
    _, _, decisions = run_batch(0)  # warm-up
    torch.cuda.synchronize()
    carry_before = clone(sess._carry)
    stage.update(dict.fromkeys(stage, 0.0))
    gc.collect()  # no collection of earlier phases' garbage in the window
    t0 = time.perf_counter()
    batch1, ys1, d1 = run_batch(BATCH)
    _, _, d2 = run_batch(2 * BATCH)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    decisions += d1 + d2
    launches = sk.LAUNCHES
    pods_per_s = 2 * BATCH / window_s
    carry_end = clone(sess._carry)   # after the 3 batches, for phase 9
    if launches != 3 or sk.VARIANT_LAUNCHES != only(sk, scan_full=3):
        raise AssertionError(f"scan_full launched {sk.VARIANT_LAUNCHES} "
                             "times for 3 batches")
    want = dict.fromkeys(sk.CLUSTER_LAUNCHES, 0)
    want[sk.CLUSTER] = 3
    if sk.CLUSTER_LAUNCHES != want:
        raise AssertionError(f"the main path's launches by cluster size "
                             f"{sk.CLUSTER_LAUNCHES}, not 3 at {sk.CLUSTER}")
    unplaced = sum(d < 0 for d in decisions)
    if unplaced:
        raise AssertionError(f"{unplaced} of {len(decisions)} pods unplaced")
    log(f"main path: {len(decisions)} pods placed, {launches} launches "
        f"for 3 batches, all on the {sk.CLUSTER}-block cluster kernel; "
        f"{pods_per_s:.1f} pods/s over the 2 measured batches [{gpu}]")
    log("main path window (2 batches): " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in stage.items())
        + f", total {window_s * 1e3:.1f} ms")

    # the first measured batch again, from the same carry: kernel timing
    # (CUDA events) and the plain version on the card
    after1 = clone(carry_before)
    err, out, _, plain_ms = kernel_vs_plain(sess, batch1, after1)
    if not torch.equal(out[:3, :BATCH], ys1["rows"][:3, :BATCH]):
        raise AssertionError("replayed batch differs from the main path's")
    kernel_ms, times = time_kernel(sess, batch1, carry_before)
    meta, match = batch_inputs(sess, batch1)
    bound_ms, bound_by, nbytes, ops = bound(sess, meta, match, out, BATCH)
    log(f"scan_full: {kernel_ms:.3f} ms per {BATCH}-pod batch at "
        f"{sess.N} nodes (runs {[round(x, 3) for x in times]}), plain "
        f"version {plain_ms:.1f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes} bytes, {ops} ops) [{gpu}]")
    bindings = {p.metadata.name: p.spec.node_name or None for p in pending}
    return {"cell": "zone spread 5000n", "launches": launches, "err": err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "sess": sess, "multi": multi,
            "bindings": bindings, "window_s": window_s,
            "batch": batch1, "carry_before": carry_before, "after": after1,
            "out": out, "enc": enc, "pe": pe, "templates": templates,
            "pending": pending, "carry_end": carry_end, "build_s": build_s,
            "snapshot0": snapshot0}


def directed_case():
    """Phase 4b's directed cases at Np = 768 (the phase-3 cluster's node
    axis: 680 nodes in 681 lanes): identical nodes and no bound pods; 768
    plain pods, which tie on every empty lane, and 128 pods that a node
    selector pins to the last node. Returns (encoding, the tie pods'
    arrays, the pinned pods' arrays, templates, the last node's lane)."""
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.testing.synth import make_pod, synth_cluster

    nodes, _ = synth_cluster(680)
    last = nodes[-1].metadata.name
    ties = [make_pod(f"tie-{i}", cpu="100m", labels={"app": "tie"})
            for i in range(768)]
    pinned = []
    for i in range(128):
        p = make_pod(f"pinned-{i}", cpu="100m", labels={"app": "pinned"})
        p.spec.node_selector = {v1.LABEL_HOSTNAME: last}
        pinned.append(p)
    enc, pe = reserved_encoding(nodes, [], ties + pinned)
    arrays, templates = encode_templates(pe, ties + pinned)
    return (enc, arrays[:len(ties)], arrays[len(ties):], templates,
            enc.node_names.index(last))


def phase_cluster(sk, gpu, d, phase):
    """Phases 4b and 6b: the one-block kernel and every cluster size the
    card places, on a cell's first measured batch from the carry before
    it, each == the plain version (the cell's plain run of that batch:
    `d["out"]`, `d["after"]`) and timed. Returns the sweep."""
    sess, batch = d["sess"], d["batch"]
    n = len(batch)
    _, _, sizes = sizes_vs_plain(sk, sess, batch, d["carry_before"],
                                 (1, *sk.CLUSTER_SIZES),
                                 f"phase {phase} {d['cell']}",
                                 ref=(d["out"], d["after"]))
    if 1 not in sizes or sk.CLUSTER not in sizes:
        raise AssertionError(f"phase {phase}: sweep placed only {sizes}")
    points = []
    for cb in sizes:
        ms, runs = time_kernel(sess, batch, d["carry_before"], cluster=cb)
        lanes = max(hi - lo for lo, hi in sk.cluster_slices(sess.Np, cb))
        points.append({"cb": cb, "ms": ms, "runs": runs, "lanes": lanes})
        log(f"phase {phase} {d['cell']}: cluster={cb}: == plain; {lanes} "
            f"lanes per block ({-(-lanes // sk.THREADS)} per thread), "
            f"{ms:.3f} ms per {n}-pod batch (runs "
            f"{[round(x, 3) for x in runs]}), {ms * 1e3 / n:.3f} us per pod "
            f"[{gpu}]")
    fastest = min(points, key=lambda p: p["ms"])["cb"]
    log(f"phase {phase} {d['cell']}: fastest cluster={fastest}, default "
        f"CLUSTER={sk.CLUSTER} [{gpu}]")
    return {"block_ms": points[0]["ms"], "sizes": sizes,
            "sweep": [{"cb": p["cb"], "ms": p["ms"],
                       "lanes_per_block": p["lanes"]} for p in points[1:]]}


def cluster_directed(sk, sizes):
    """Phase 4b's directed cases (`directed_case`): at every cluster size
    in `sizes` (1 = the one-block kernel) == the plain version, the tie
    pods walking the lanes in order, the pinned pods placed on the last
    node only, until it is full."""
    from kubernetes_tpu_torch.ops.scan import ScanSession

    enc, ties, pinned, templates, last = directed_case()
    dsess = ScanSession(enc.device_state("cuda"), templates, multipod_k=1,
                        device="cuda")
    carry0 = dsess._initial_carry()
    for label, arrays in (("tie", ties), ("pinned", pinned)):
        k = len(arrays)
        ref, _, _ = sizes_vs_plain(sk, dsess, arrays, carry0, sizes,
                                   f"directed case {label}")
        best = ref[0, :k].tolist()
        placed = [b for b in best if b >= 0]
        if label == "tie":
            # every node's lane once, in lane order, before any lane twice
            if best[:last + 1] != list(range(last + 1)):
                raise AssertionError(f"tie case: decisions {best[:16]}... "
                                     "do not walk the lanes in order")
        elif not placed or len(placed) == k or set(placed) != {last}:
            raise AssertionError(f"pinned case: {len(placed)} of {k} placed "
                                 f"on {sorted(set(placed))}, lane {last}")
        log(f"phase 4b: directed case {label} (N={dsess.N}, Np={dsess.Np}, "
            f"{k} pods, {len(placed)} placed): every size {sizes} == plain")


def affinity_workload(kind):
    """Phase 6's cell (and 12b's): (name, nodes, bound app=aff pods,
    pending pods, their affinity, labels)."""
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.testing.synth import make_pod, synth_cluster

    name = {"pref-aff": "SchedulingPreferredPodAffinity-5000n",
            "aff": "SchedulingPodAffinity-5000n"}[kind]
    nodes, _ = synth_cluster(5000, pods_per_node=0)
    labels = {"app": "aff"}
    init_pods = [make_pod(f"init-{i}", cpu="100m", memory="128Mi",
                          labels=labels,
                          node_name=nodes[i % len(nodes)].metadata.name)
                 for i in range(2048)]
    aff = affinity(v1, kind, labels, v1.LABEL_ZONE)
    pending = [make_pod(f"pod-{i}", cpu="100m", memory="128Mi",
                        labels=labels, affinity=aff)
               for i in range(sum(AFF_BATCHES))]
    return name, nodes, init_pods, pending, aff, labels


def phase_affinity(sk, gpu, kind):
    """scheduler_perf's Scheduling{Preferred,}PodAffinity-5000n through
    the session: every pod placed, the ur > 0 variant once per batch, all
    on the cluster kernel at `CLUSTER`, the first measured batch == plain.
    Returns this phase's numbers, the session (and its mk=4 twin on the
    same cluster), the first measured batch, the carry before it and the
    plain version's out and carry after it."""
    import torch
    from kubernetes_tpu_torch.ops.scan import ScanSession

    t0 = time.perf_counter()
    name, nodes, init_pods, pending, aff, labels = affinity_workload(kind)
    enc, pe = reserved_encoding(nodes, init_pods, pending)
    _, templates = encode_templates(pe, pending)
    setup_s = time.perf_counter() - t0
    # the encoding the session starts from, for phase 11b
    snapshot0 = enc.host_snapshot()
    t0 = time.perf_counter()
    sess = ScanSession(enc.device_state("cuda"), templates, multipod_k=1,
                       device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the same session at mk pods per step, for phase 7c
    multi = ScanSession(enc.device_state("cuda"), templates, multipod_k=MK,
                        device="cuda")
    w45_scale = int(sess._ipa["w45_scale"]) if sess.UR else None
    log(f"phase 6 {name}: setup {setup_s:.1f} s, session build "
        f"{build_s:.3f} s (N={sess.N}, Np={sess.Np}, T={sess.T}, "
        f"UR={sess.UR}, w45_scale={w45_scale}) [{gpu}]")
    if not sess.UR:
        raise AssertionError(f"{name}: the session has no IPA carries")

    stage = {"encode": 0.0, "schedule": 0.0, "wait": 0.0, "harvest": 0.0}
    decisions = []
    batches = []
    reset_counts(sk)
    lo = 0
    for i, size in enumerate(AFF_BATCHES):
        if i == 1:
            torch.cuda.synchronize()
            carry_before = clone(sess._carry)
            stage.update(dict.fromkeys(stage, 0.0))
            gc.collect()
            t_window = time.perf_counter()
        pods = pending[lo:lo + size]
        lo += size
        t = [time.perf_counter()]
        batch = [{k: v for k, v in pe.encode(p).items()
                  if not k.startswith("_")} for p in pods]
        t.append(time.perf_counter())
        ys = sess.schedule(batch)
        t.append(time.perf_counter())
        d = ScanSession.decisions(ys)
        t.append(time.perf_counter())
        for pod, best in zip(pods, d):
            if best >= 0:
                pod.spec.node_name = enc.node_names[best]
                enc.add_pod(pod, pod.spec.node_name)
        t.append(time.perf_counter())
        for key, a, b in zip(stage, t, t[1:]):
            stage[key] += b - a
        decisions += d
        batches.append((batch, ys))
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t_window
    launches = dict(sk.VARIANT_LAUNCHES)
    if enc._rebuild_needed:
        raise AssertionError(f"{name}: binding the placed pods deferred a "
                             "rebuild of the encoding")
    if launches != only(sk, scan_full_ipa=len(AFF_BATCHES)):
        raise AssertionError(f"{name}: launches {launches} for "
                             f"{len(AFF_BATCHES)} batches")
    want = dict.fromkeys(sk.CLUSTER_LAUNCHES, 0)
    want[sk.CLUSTER] = len(AFF_BATCHES)
    if sk.CLUSTER_LAUNCHES != want:
        raise AssertionError(f"{name}: launches by cluster size "
                             f"{sk.CLUSTER_LAUNCHES}, not "
                             f"{len(AFF_BATCHES)} at {sk.CLUSTER}")
    unplaced = sum(x < 0 for x in decisions)
    if unplaced:
        raise AssertionError(f"{name}: {unplaced} of {len(decisions)} pods "
                             "unplaced")
    n_meas = sum(AFF_BATCHES[1:])
    pods_per_s = n_meas / window_s
    log(f"phase 6 {name}: {len(decisions)} pods placed, "
        f"{launches['scan_full_ipa']} launches of scan_full_ipa for "
        f"{len(AFF_BATCHES)} batches, all on the {sk.CLUSTER}-block cluster "
        f"kernel; {pods_per_s:.1f} pods/s over the "
        f"{len(AFF_BATCHES) - 1} measured batches [{gpu}]")
    log(f"phase 6 {name} window: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in stage.items())
        + f", total {window_s * 1e3:.1f} ms [{gpu}]")

    batch1, ys1 = batches[1]
    n1 = len(batch1)
    after1 = clone(carry_before)
    err, out, _, plain_ms = kernel_vs_plain(sess, batch1, after1)
    if not torch.equal(out[:3, :n1], ys1["rows"][:3, :n1]):
        raise AssertionError(f"{name}: replayed batch differs from the "
                             "session's")
    kernel_ms, times = time_kernel(sess, batch1, carry_before)
    meta, match = batch_inputs(sess, batch1)
    bound_ms, bound_by, nbytes, ops = bound(sess, meta, match, out, n1)
    log(f"phase 6 {name}: scan_full_ipa {kernel_ms:.3f} ms per {n1}-pod "
        f"batch at {sess.N} nodes on {sk.CLUSTER} blocks (runs "
        f"{[round(x, 3) for x in times]}), "
        f"{kernel_ms * 1e3 / n1:.2f} us per pod, plain version "
        f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes} bytes, {ops} ops) [{gpu}]")
    return {"cell": name, "launches": launches["scan_full_ipa"], "err": err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "sess": sess, "multi": multi,
            "batch": batch1, "carry_before": carry_before, "after": after1,
            "out": out, "enc": enc, "pe": pe, "templates": templates,
            "affinity": aff, "labels": labels, "build_s": build_s,
            "snapshot0": snapshot0, "batch0": batches[0][0],
            "kind": kind, "window_s": window_s,
            "bindings": {p.metadata.name: p.spec.node_name or None
                         for p in pending}}


KCNT_ZONES = 4


def kcnt_case(kind, n_nodes=680, n_pods=512, seed=5):
    """Phase 6b's directed `kcnt` case at Np = 768: nodes whose zones
    interleave over the lanes (zone = node mod 4, so every cluster slice
    holds every zone), n_nodes bound app=other pods of 500m on nodes drawn
    from `seed`, and n_pods pending app=kz pods with a required (`kind`
    "required") or weight-100 preferred zone pod affinity toward app=kz,
    which no bound pod carries. Returns (encoding, pod arrays, templates,
    the zone of each lane)."""
    import numpy as np
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.testing.synth import make_pod, synth_cluster

    nodes, _ = synth_cluster(n_nodes, n_zones=KCNT_ZONES)
    rng = np.random.default_rng(seed)
    init_pods = [make_pod(f"other-{i}", cpu="500m", memory="1Gi",
                          labels={"app": "other"},
                          node_name=nodes[int(j)].metadata.name)
                 for i, j in enumerate(rng.integers(0, n_nodes, n_nodes))]
    labels = {"app": "kz"}
    aff = affinity(v1, "aff" if kind == "required" else "pref-aff", labels,
                   v1.LABEL_ZONE)
    pending = [make_pod(f"kz-{i}", cpu="100m", memory="128Mi",
                        labels=labels, affinity=aff) for i in range(n_pods)]
    enc, pe = reserved_encoding(nodes, init_pods, pending)
    arrays, templates = encode_templates(pe, pending)
    zone = {n.metadata.name: n.metadata.labels[v1.LABEL_ZONE] for n in nodes}
    return enc, arrays, templates, [zone.get(x) for x in enc.node_names]


def kcnt_directed(sk, gpu, sizes):
    """Phase 6b's directed `kcnt` cases (`kcnt_case`, required and
    preferred): at every cluster size in `sizes` == the plain version
    (out rows and all six carries), and every pod after the first placed
    in the first pod's zone."""
    from kubernetes_tpu_torch.ops.scan import ScanSession

    for kind in ("required", "preferred"):
        enc, arrays, templates, lane_zone = kcnt_case(kind)
        dsess = ScanSession(enc.device_state("cuda"), templates,
                            multipod_k=1, device="cuda")
        if not dsess.UR:
            raise AssertionError(f"kcnt case {kind}: no IPA carries")
        k = len(arrays)
        ref, ref_carry, _ = sizes_vs_plain(sk, dsess, arrays,
                                           dsess._initial_carry(), sizes,
                                           f"kcnt case {kind}")
        best = ref[0, :k].tolist()
        zones = [lane_zone[b] if b >= 0 else None for b in best]
        if zones[0] is None or zones[1:] != [zones[0]] * (k - 1):
            raise AssertionError(f"kcnt case {kind}: pods left the first "
                                 f"pod's zone: {zones[:16]}...")
        log(f"phase 6b: directed kcnt case {kind} (N={dsess.N}, "
            f"Np={dsess.Np}, UR={dsess.UR}, {k} pods, all in "
            f"{zones[0]}; kcnt max {int(ref_carry['kcnt'].max())}): every "
            f"size {sizes} == plain [{gpu}]")


def phase_multipod_small(sk, gpu, case):
    """Phase 7a on one ~600-node cluster: one mk=4 launch == plain from
    the initial carry, then `schedule_exact` at mk=4 over every batch,
    whose decisions and final carries must equal an mk=1 session's."""
    import torch
    from kubernetes_tpu_torch.ops.scan import ScanSession
    from kubernetes_tpu_torch.scheduler.tpu_backend import schedule_exact

    arrays, bs = case["arrays"], case["batch"]
    cluster = case["enc"].device_state("cuda")
    multi = ScanSession(cluster, case["templates"], multipod_k=MK,
                        device="cuda")
    one = ScanSession(cluster, case["templates"], multipod_k=1,
                      device="cuda")
    variant = "scan_multi_ipa" if multi.UR else "scan_multi"
    err, out, ms, plain_ms = kernel_vs_plain(
        multi, arrays[:bs], multi._initial_carry(), mk=MK)
    _, suffix = ScanSession.conflict_stats({"rows": out, "n": bs, "mk": MK})
    n_batches = (len(arrays) + bs - 1) // bs
    reset_counts(sk)
    got, want = [], []
    for lo in range(0, len(arrays), bs):
        batch = arrays[lo:lo + bs]
        got += schedule_exact(multi, batch)
        want += ScanSession.decisions(one.schedule(batch))
    torch.cuda.synchronize()
    launches = dict(sk.VARIANT_LAUNCHES)
    if got != want:
        raise AssertionError(f"7a {case['label']}: schedule_exact at mk={MK} "
                             "decided otherwise than one pod per step")
    if not carries_equal(multi._carry, one._carry):
        raise AssertionError(f"7a {case['label']}: mk={MK} carries differ "
                             "from one pod per step")
    if launches[variant] < n_batches or launches != only(
            sk, **{variant: launches[variant],
                   variant.replace("multi", "full"): n_batches}):
        raise AssertionError(f"7a {case['label']}: launches {launches}")
    relaunches = launches[variant] - n_batches
    log(f"phase 7a {case['label']}: {variant} == plain at mk={MK} on the "
        f"first {bs}-pod batch ({ms:.3f} ms, plain version "
        f"{plain_ms:.1f} ms, suffix from pod {suffix}); schedule_exact over "
        f"{n_batches} batches == mk=1 session (decisions and carries), "
        f"{relaunches} conflicts, {launches[variant]} launches of "
        f"{variant} ({relaunches} relaunches) [{gpu}]")
    return {"cell": case["label"], "variant": variant,
            "launches": launches[variant], "err": err, "ms": ms,
            "plain_ms": plain_ms, "relaunches": relaunches}


def tenant_pods(n):
    """Pods of four tenants, round robin: tenant t is app=tenant-t,
    100m/128Mi, with a required node affinity zone In [zone-t]."""
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.testing.synth import make_pod

    def pinned(zone):
        return v1.Affinity(node_affinity=v1.NodeAffinity(
            required_during_scheduling_ignored_during_execution=v1.NodeSelector(
                node_selector_terms=[v1.NodeSelectorTerm(match_expressions=[
                    v1.NodeSelectorRequirement(key=v1.LABEL_ZONE,
                                               operator="In",
                                               values=[zone])])])))

    return [make_pod(f"tenant-{i}", cpu="100m", memory="128Mi",
                     labels={"app": f"tenant-{i % TENANTS}"},
                     affinity=pinned(f"zone-{i % TENANTS}"))
            for i in range(n)]


def phase_tenants(sk, gpu):
    """Phase 7b: the zone-pinned tenant mix at 5000 nodes, an mk=1 and an
    mk=4 session (the latter through schedule_exact) over the same
    batches, each on an encoding of its own that its harvest binds
    into."""
    import torch
    from kubernetes_tpu_torch.ops.scan import ScanSession
    from kubernetes_tpu_torch.scheduler.tpu_backend import schedule_exact
    from kubernetes_tpu_torch.testing.synth import synth_cluster

    runs = {}
    for mk in (1, MK):
        t0 = time.perf_counter()
        nodes, init_pods = synth_cluster(5000, n_zones=TENANTS,
                                         pods_per_node=2)
        pending = tenant_pods(3 * BATCH)
        enc, pe = presized_encoding(nodes, init_pods, pending)
        _, templates = encode_templates(pe, pending)
        setup_s = time.perf_counter() - t0
        sess = ScanSession(enc.device_state("cuda"), templates,
                           multipod_k=mk, device="cuda")
        stage = {"encode": 0.0, "schedule": 0.0, "harvest": 0.0}
        decisions = []
        reset_counts(sk)
        for i in range(3):
            if i == 1:
                torch.cuda.synchronize()
                carry_before = clone(sess._carry)
                stage.update(dict.fromkeys(stage, 0.0))
                gc.collect()
                t_window = time.perf_counter()
            pods = pending[i * BATCH:(i + 1) * BATCH]
            t = [time.perf_counter()]
            batch = [{k: v for k, v in pe.encode(p).items()
                      if not k.startswith("_")} for p in pods]
            t.append(time.perf_counter())
            d = schedule_exact(sess, batch)   # launches, waits, replays
            t.append(time.perf_counter())
            for pod, best in zip(pods, d):
                if best >= 0:
                    pod.spec.node_name = enc.node_names[best]
                    enc.add_pod(pod, pod.spec.node_name)
            t.append(time.perf_counter())
            for key, a, b in zip(stage, t, t[1:]):
                stage[key] += b - a
            decisions += d
            if i == 1:
                batch1 = batch
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t_window
        launches = dict(sk.VARIANT_LAUNCHES)
        pods_per_s = 2 * BATCH / window_s
        runs[mk] = {"sess": sess, "decisions": decisions,
                    "launches": launches, "carry_before": carry_before,
                    "batch": batch1, "pods_per_s": pods_per_s}
        log(f"phase 7b tenant mix, mk={mk}: setup {setup_s:.1f} s "
            f"(N={sess.N}, Np={sess.Np}, T={sess.T}); {len(decisions)} pods, "
            f"launches {({k: v for k, v in launches.items() if v})}; "
            f"{pods_per_s:.1f} pods/s over the 2 measured batches; window "
            + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in stage.items())
            + f", total {window_s * 1e3:.1f} ms [{gpu}]")
    one, multi = runs[1], runs[MK]
    unplaced = sum(d < 0 for d in multi["decisions"])
    if unplaced:
        raise AssertionError(f"7b: {unplaced} of {len(multi['decisions'])} "
                             f"pods unplaced at mk={MK}")
    if multi["decisions"] != one["decisions"]:
        raise AssertionError(f"7b: mk={MK} decisions differ from mk=1")
    if not carries_equal(multi["sess"]._carry, one["sess"]._carry):
        raise AssertionError(f"7b: mk={MK} carries differ from mk=1")
    n_multi = multi["launches"]["scan_multi"]
    if one["launches"] != only(sk, scan_full=3) or n_multi < 3 or \
            multi["launches"] != only(sk, scan_multi=n_multi):
        raise AssertionError(f"7b: launches {one['launches']} (mk=1), "
                             f"{multi['launches']} (mk={MK})")
    relaunches = n_multi - 3
    sess, batch1 = multi["sess"], multi["batch"]
    carry_before = multi["carry_before"]
    err, out, _, plain_ms = kernel_vs_plain(sess, batch1,
                                            clone(carry_before), mk=MK)
    _, suffix = ScanSession.conflict_stats(
        {"rows": out, "n": BATCH, "mk": MK})
    if suffix is None and out[0, :BATCH].tolist() != \
            multi["decisions"][BATCH:2 * BATCH]:
        raise AssertionError("7b: replayed batch differs from the "
                             "session's")
    # the same batch from the same carry, in turns: scan_full, scan_multi
    full_runs, multi_runs = [], []
    for _ in range(3):
        full_runs += time_kernel(sess, batch1, carry_before, runs=1)[1]
        multi_runs += time_kernel(sess, batch1, carry_before, mk=MK,
                                  runs=1)[1]
    full_ms = statistics.median(full_runs)
    multi_ms = statistics.median(multi_runs)
    meta, match = batch_inputs(sess, batch1)
    bound_ms, bound_by, nbytes, ops = bound(sess, meta, match, out, BATCH,
                                            mk=MK)
    log(f"phase 7b tenant mix: every pod placed, mk={MK} == mk=1 "
        f"(decisions and carries); {relaunches} conflicts, {n_multi} "
        f"launches of scan_multi for 3 batches ({relaunches} relaunches); "
        f"scan_multi {multi_ms:.3f} ms (runs "
        f"{[round(x, 3) for x in multi_runs]}) against scan_full "
        f"{full_ms:.3f} ms (runs {[round(x, 3) for x in full_runs]}) per "
        f"{BATCH}-pod batch from the same carry; plain version (mk={MK}) "
        f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes} bytes, {ops} ops); pods/s mk=1 "
        f"{one['pods_per_s']:.1f}, mk={MK} {multi['pods_per_s']:.1f} "
        f"[{gpu}]")
    return {"cell": "tenant mix 5000n (7b)", "launches": n_multi,
            "err": err, "ms": multi_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "full_ms": full_ms, "relaunches": relaunches}


def phase_conflict_heavy(sk, gpu, d):
    """Phase 7c: one `schedule` of the mk=4 session over a
    conflict-heavy full-size batch from a copy of its carry, rows and
    carries == plain, no replay."""
    import torch
    from kubernetes_tpu_torch.ops.scan import ScanSession

    sess, batch, carry_before = d["multi"], d["batch"], d["carry_before"]
    n = len(batch)
    variant = "scan_multi_ipa" if sess.UR else "scan_multi"
    sess._carry = clone(carry_before)
    reset_counts(sk)
    ys = sess.schedule(batch)
    torch.cuda.synchronize()
    launches = dict(sk.VARIANT_LAUNCHES)
    if launches != only(sk, **{variant: 1}):
        raise AssertionError(f"7c {d['cell']}: launches {launches}")
    # the kernel again from the same carry, held to the plain version
    after = clone(carry_before)
    err, out, _, plain_ms = kernel_vs_plain(sess, batch, after, mk=MK)
    if not (torch.equal(ys["rows"][:4, :n], out[:4, :n])
            and carries_equal(sess._carry, after)):
        raise AssertionError(f"7c {d['cell']}: the session's rows or "
                             "carries differ from the plain version's")
    _, suffix = ScanSession.conflict_stats(ys)
    kernel_ms, times = time_kernel(sess, batch, carry_before, mk=MK)
    meta, match = batch_inputs(sess, batch)
    bound_ms, bound_by, nbytes, ops = bound(sess, meta, match, out, n,
                                            mk=MK)
    log(f"phase 7c {d['cell']}: ScanSession(multipod_k={MK}).schedule == "
        f"plain (rows and carries), {launches[variant]} launch of "
        f"{variant}, suffix from pod {suffix} of {n}; {kernel_ms:.3f} ms "
        f"per batch (runs {[round(x, 3) for x in times]}), plain version "
        f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes} bytes, {ops} ops) [{gpu}]")
    return {"cell": f"{d['cell']}, conflict-heavy (7c)",
            "launches": launches[variant], "err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "suffix": suffix}


def phase_eval_apply(sk, gpu, cases, zone):
    """Phase 8: eval -> apply pod by pod replays full mode on the first
    batch of each ~600-node cluster, a forced -1 is a no-op, and each
    mode's kernel equals the plain version; then one eval and one apply
    launch over the phase-4 batch."""
    import torch
    from kubernetes_tpu_torch.ops.scan import ScanSession

    sessions = []
    reset_counts(sk)
    for case in cases:
        batch = case["arrays"][:case["batch"]]
        cluster = case["enc"].device_state("cuda")
        full = ScanSession(cluster, case["templates"], multipod_k=1,
                           device="cuda")
        split = ScanSession(cluster, case["templates"], multipod_k=1,
                            device="cuda")
        want = ScanSession.decisions(full.schedule(batch))
        got = []
        for a in batch:
            ((best, _),) = split.evaluate([a])
            got.append(best)
            split.apply_decisions([a], [best])
        if got != want or not carries_equal(split._carry, full._carry):
            raise AssertionError(f"8 {case['label']}: eval -> apply does "
                                 "not replay full mode")
        before = clone(split._carry)
        split.apply_decisions([batch[0]], [-1])
        if not carries_equal(split._carry, before):
            raise AssertionError(f"8 {case['label']}: a forced -1 moved "
                                 "the carries")
        sessions.append((case, split))
    torch.cuda.synchronize()
    launches = dict(sk.VARIANT_LAUNCHES)
    for name in ("scan_eval", "scan_eval_ipa", "scan_apply",
                 "scan_apply_ipa"):
        if not launches[name]:
            raise AssertionError(f"8: {name} was not launched ({launches})")
    err = 0
    for case, split in sessions:
        batch = case["arrays"][case["batch"]:2 * case["batch"]]
        e, out, _, _ = kernel_vs_plain(split, batch, clone(split._carry),
                                       mode="eval")
        err = max(err, e)
        e, _, _, _ = kernel_vs_plain(split, batch, clone(split._carry),
                                     mode="apply",
                                     decisions=out[0, :len(batch)].tolist())
        err = max(err, e)
    n_pods = sum(c["batch"] for c in cases)
    log(f"phase 8: eval -> apply pod by pod == full mode on {n_pods} pods "
        f"of the phase-3 and phase-5 clusters, a forced -1 leaves the "
        f"carries bit-identical, eval and apply == plain; launches "
        f"{({k: v for k, v in launches.items() if v})} [{gpu}]")

    # full width: the phase-4 session's own evaluate / apply_decisions
    # over its first measured batch, from the carry before it
    sess, batch, carry_before = zone["sess"], zone["batch"], \
        zone["carry_before"]
    n = len(batch)
    statics, weights = sess._get_statics(), weights_of(sk, sess)
    sess._carry = clone(carry_before)
    reset_counts(sk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pairs = sess.evaluate(batch)
    eval_call_ms = (time.perf_counter() - t0) * 1e3
    eval_launches = dict(sk.VARIANT_LAUNCHES)
    if eval_launches != only(sk, scan_eval=1):
        raise AssertionError(f"8: evaluate launched {eval_launches}")
    meta, match = batch_inputs(sess, batch, "eval")
    ref_carry = clone(carry_before)
    t0 = time.perf_counter()
    ref = sk.scan_full_reference(meta, match, statics, ref_carry,
                                 sess.shapes, weights, mode="eval")
    torch.cuda.synchronize()
    eval_plain_ms = (time.perf_counter() - t0) * 1e3
    got = torch.tensor(pairs, dtype=torch.int64).T
    err = max(err, int((got - ref[:2, :n].long().cpu()).abs().max()))
    if not (torch.equal(got, ref[:2, :n].long().cpu())
            and carries_equal(sess._carry, carry_before)
            and carries_equal(ref_carry, carry_before)):
        raise AssertionError("8: evaluate differs from the plain version "
                             "or moved the carries")
    full_out = zone["out"]
    if pairs[0] != (int(full_out[0, 0]), int(full_out[1, 0])):
        raise AssertionError("8: the first pod's eval differs from full "
                             "mode's decision")
    decisions = full_out[0, :n].tolist()
    reset_counts(sk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.apply_decisions(batch, decisions)
    torch.cuda.synchronize()
    apply_call_ms = (time.perf_counter() - t0) * 1e3
    apply_launches = dict(sk.VARIANT_LAUNCHES)
    if apply_launches != only(sk, scan_apply=1):
        raise AssertionError(f"8: apply_decisions launched {apply_launches}")
    forced = forced_pairs(sess, decisions, meta.shape[0] - 1)
    ref_carry = clone(carry_before)
    t0 = time.perf_counter()
    sk.scan_full_reference(*batch_inputs(sess, batch, "apply"), statics,
                           ref_carry, sess.shapes, weights, mode="apply",
                           forced=forced)
    torch.cuda.synchronize()
    apply_plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(err, carry_err(sess._carry, ref_carry))
    if not (carries_equal(sess._carry, ref_carry)
            and carries_equal(sess._carry, zone["after"])):
        raise AssertionError("8: apply_decisions of the batch's decisions "
                             "differs from the plain version or from full "
                             "mode's carry")
    # kernel times: bare launches from copies of the carry (not counted)
    eval_ms, eval_runs = time_kernel(sess, batch, carry_before, mode="eval")
    apply_ms, apply_runs = time_kernel(sess, batch, carry_before,
                                       mode="apply", decisions=decisions)
    eval_bound = bound(sess, meta, match, ref, n, mode="eval")
    apply_bound = bound(sess, meta, match, ref, n, mode="apply",
                        forced=forced)
    log(f"phase 8 full width ({n}-pod phase-4 batch): the session's "
        f"evaluate ({eval_call_ms:.3f} ms for the call, 1 launch of "
        f"scan_eval) == plain, carries untouched; apply_decisions of full "
        f"mode's decisions ({apply_call_ms:.3f} ms for the call, 1 launch "
        f"of scan_apply) == plain == full mode's carry; scan_eval "
        f"{eval_ms:.3f} ms (runs {[round(x, 3) for x in eval_runs]}), plain "
        f"version {eval_plain_ms:.1f} ms, bound {eval_bound[0]:.4f} ms by "
        f"{eval_bound[1]} ({eval_bound[2]} bytes, {eval_bound[3]} ops); "
        f"scan_apply {apply_ms:.3f} ms (runs "
        f"{[round(x, 3) for x in apply_runs]}), plain version "
        f"{apply_plain_ms:.1f} ms, bound {apply_bound[0]:.4f} ms by "
        f"{apply_bound[1]} ({apply_bound[2]} bytes, {apply_bound[3]} ops) "
        f"[{gpu}]")

    def total(counts, name):
        return counts[name] + counts[f"{name}_ipa"]

    return {
        "err": err,
        "eval": {"launches": total(launches, "scan_eval")
                 + total(eval_launches, "scan_eval"), "ms": eval_ms,
                 "plain_ms": eval_plain_ms, "bound_ms": eval_bound[0],
                 "bound_by": eval_bound[1], "call_ms": eval_call_ms},
        "apply": {"launches": total(launches, "scan_apply")
                  + total(apply_launches, "scan_apply"), "ms": apply_ms,
                  "plain_ms": apply_plain_ms, "bound_ms": apply_bound[0],
                  "bound_by": apply_bound[1], "call_ms": apply_call_ms},
    }


def unscaled(sess, carry):
    """The four carries and alloc in the encoding's units (x the
    session's GCD), on the valid node lanes, as int64 numpy."""
    import numpy as np

    g, R, N = sess._gcd, sess.R, sess.N
    valid = sess._valid_n[0, :N] != 0
    c = {k: carry[k].cpu().numpy().astype(np.int64)
         for k in ("requested", "nzpc", "cnt_fn", "cnt_sn")}
    c["requested"] = c["requested"][:R] * g[:, None]
    c["nzpc"][:2] *= g[:2, None]
    c["alloc"] = sess._alloc[:R].astype(np.int64) * g[:, None]
    return {k: v[:, :N][:, valid] for k, v in c.items()}


def churn_events(d, rng):
    """Phase 9's flush on the zone-spread cell: CHURN evictions of placed
    pods, foreign pods bound to random nodes with the spread templates'
    labels and requests and with other (init-pod) labels, and
    allocatable-only updates of random nodes by a GCD multiple of cpu and
    one pod; shuffled. -> [(kind, object)]."""
    import copy

    from kubernetes_tpu_torch.testing.synth import (
        make_pod,
        synth_pending_pods,
    )

    enc, sess = d["enc"], d["sess"]
    names = [n for n in enc.node_names if n is not None]
    placed = [p for p in d["pending"] if p.spec.node_name]
    events = [("remove", p) for p in rng.sample(placed, CHURN["evict"])]
    for i, p in enumerate(synth_pending_pods(CHURN["spread"], spread=True)):
        p.metadata.name = f"foreign-{i}"
        p.spec.node_name = rng.choice(names)
        events.append(("add", p))
    for i in range(CHURN["other"]):
        events.append(("add", make_pod(
            f"foreign-other-{i}", cpu="100m", memory="128Mi",
            labels={"app": f"init-{i % 8}"}, node_name=rng.choice(names))))
    A = enc._arrays
    g0 = int(sess._gcd[0])
    bump = g0 * max(1, 1000 // g0)              # about one core
    for name in rng.sample(names, CHURN["alloc"]):
        i = enc.node_index[name]
        node = copy.deepcopy(enc._nodes[name])
        for res in (node.status.allocatable, node.status.capacity):
            res["cpu"] = f"{int(A['alloc'][i][0]) + bump}m"
            res["pods"] = str(int(A["allowed_pods"][i]) + 1)
        events.append(("alloc", node))
    rng.shuffle(events)
    return events


def classify(sess, enc, events):
    """Each event through the backend's classifiers (the encoding mutated
    as the backend mutates it): (deltas, refused)."""
    from kubernetes_tpu_torch.testing import churn

    deltas, refused = [], 0
    for kind, obj in events:
        if kind == "alloc":
            delta = churn.alloc_patch(sess, enc, obj)
        elif kind == "add":
            delta = churn.pod_delta(
                sess, enc, obj, obj.spec.node_name, 1,
                lambda p=obj: enc.add_pod(p, p.spec.node_name))
        else:
            delta = churn.pod_delta(sess, enc, obj, obj.spec.node_name, -1,
                                    lambda p=obj: enc.remove_pod(p))
        if delta is None:
            refused += 1
        else:
            deltas.append(delta)
    return deltas, refused


def time_delta(sess, node, rows, carry, runs=3):
    """Median CUDA-event ms of `runs` bare delta launches, each on a copy
    of `carry` (not counted as the main path's)."""
    import torch
    from kubernetes_tpu_torch.ops import scan_kernel as sk

    times = []
    for _ in range(runs):
        c = clone(carry)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        sk.carry_delta(node, rows, sess._get_statics(), c, sess.shapes)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times), times


class timed_prep:
    """Within the block, the session's delta prep steps (`_delta_rows`,
    `_pack_deltas`, `_upload`, wrapped on the instance) add their host ms
    to the dict the block gets: rows_ms, pack_ms, upload_ms and their sum
    prep_ms."""

    def __init__(self, sess):
        self.sess = sess
        self.spent = {"rows_ms": 0.0, "pack_ms": 0.0, "upload_ms": 0.0}

    def __enter__(self):
        for name, key in (("_delta_rows", "rows_ms"),
                          ("_pack_deltas", "pack_ms"),
                          ("_upload", "upload_ms")):
            setattr(self.sess, name, self._timed(key, getattr(self.sess,
                                                              name)))
        return self.spent

    def _timed(self, key, fn):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                self.spent[key] += (time.perf_counter() - t0) * 1e3
        return run

    def __exit__(self, *exc):
        for name in ("_delta_rows", "_pack_deltas", "_upload"):
            delattr(self.sess, name)
        self.spent["prep_ms"] = sum(self.spent.values())
        return False


def graph_ms(fn, runs=20):
    """Device ms of one fn() launch: `runs` calls captured in one CUDA
    graph (after a warm-up call on the capture's side stream), the graph
    replayed once between two CUDA events, over `runs`."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / runs


INT64_GRAPH_RUNS = 200


def graph_turns(fa, fb, runs, reps=5):
    """Device ms of one fa() and one fb() launch: each's `runs` calls
    captured in a CUDA graph, the two graphs replayed `reps` times each in
    turns (a, b, b, a, ...) between CUDA events -> (a's ms per launch a
    replay, b's)."""
    import torch

    graphs = []
    for fn in (fa, fb):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(runs):
                fn()
        graphs.append(g)
    torch.cuda.synchronize()
    times = ([], [])
    for rep in range(reps):
        for i in ((0, 1) if rep % 2 == 0 else (1, 0)):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graphs[i].replay()
            e1.record()
            torch.cuda.synchronize()
            times[i].append(e0.elapsed_time(e1) / runs)
    return times


def delta_cases(sk, sess, carry, node, payload, in_order, label):
    """Phase 9's order-free cases on one cell, each a flush by the bare
    kernel and by carry_delta_reference on copies of `carry` (not
    counted), equal on every carry: the cell's flush in a seeded random
    order (also == `in_order`, the plain version's in-order result),
    every event of the flush on one node, 64 events of random int32
    payloads on 4 of the flush's nodes (their adds wrap int32 on some
    lane), and the flush's first event alone. -> {case: max abs err}."""
    import numpy as np
    import torch

    rng = np.random.default_rng(8)
    perm = rng.permutation(len(node))
    wrap_node = rng.choice(np.unique(node), 4)[rng.integers(0, 4, 64)]
    wrap_rows = rng.integers(-2 ** 31, 2 ** 31, (64, payload.shape[1]),
                             dtype=np.int64).astype(np.int32)
    Rp = carry["requested"].shape[0]
    want = carry["requested"].cpu().numpy().astype(np.int64)
    np.add.at(want.T, wrap_node, wrap_rows[:, :Rp].astype(np.int64))
    if not ((want < -2 ** 31) | (want >= 2 ** 31)).any():
        raise AssertionError(f"9 {label}: the wrap case does not wrap")
    cases = {"permuted": (node[perm], payload[perm]),
             "one node": (np.full_like(node, node[0]), payload),
             "int32 wrap": (wrap_node.astype(np.int32), wrap_rows),
             "1 event": (node[:1], payload[:1])}
    statics = sess._get_statics()
    errs = {}
    for name, (n, rows) in cases.items():
        n_t = torch.from_numpy(np.ascontiguousarray(n)).cuda()
        rows_t = torch.from_numpy(np.ascontiguousarray(rows)).cuda()
        by_kernel, by_plain = clone(carry), clone(carry)
        sk.carry_delta(n_t, rows_t, statics, by_kernel, sess.shapes)
        sk.carry_delta_reference(n_t, rows_t, statics, by_plain, sess.shapes)
        errs[name] = carry_err(by_kernel, by_plain)
        if not carries_equal(by_kernel, by_plain) or (
                name == "permuted" and not carries_equal(by_kernel,
                                                         in_order)):
            raise AssertionError(f"9 {label}: scan_delta != plain version "
                                 f"on the {name} case (max abs err "
                                 f"{errs[name]})")
    return errs


def phase_churn(sk, gpu, d, events, next_pods, label):
    """Phase 9 on one cell: the live session `d["sess"]` (its carry as
    the cell's batches left it) absorbs `events` in one flush. Returns
    this cell's numbers."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops.scan import ScanSession

    sess, enc, pe, templates = d["sess"], d["enc"], d["pe"], d["templates"]
    # a session from the encoding as it stands, before the churn: it
    # takes the flush through the host seed path, never launched before
    seeded = ScanSession(enc.device_state("cuda"), templates, multipod_k=1,
                         device="cuda")
    pre_churn = enc.host_snapshot()  # for phase 11e
    t0 = time.perf_counter()
    deltas, refused = classify(sess, enc, events)
    classify_ms = (time.perf_counter() - t0) * 1e3
    post_churn = enc.host_snapshot()  # for phase 16b
    if refused or len(deltas) != len(events):
        raise AssertionError(f"9 {label}: {refused} of {len(events)} events "
                             "refused as structural")
    if not all(seeded.delta_compatible(x["dres"], x["dnz"])
               for x in deltas if x["kind"] != "node-alloc"):
        raise AssertionError(f"9 {label}: a delta falls outside the seeded "
                             "session's GCD envelope")
    carry_before = clone(sess._carry)
    node, payload = ScanSession._pack_deltas(
        [sess._delta_rows(x) for x in deltas])
    node_t = torch.from_numpy(node).cuda()
    rows_t = torch.from_numpy(payload).cuda()
    statics = sess._get_statics()
    # (b) the kernel against the plain version on copies of the carry
    by_kernel, by_plain = clone(carry_before), clone(carry_before)
    sk.carry_delta(node_t, rows_t, statics, by_kernel, sess.shapes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sk.carry_delta_reference(node_t, rows_t, statics, by_plain, sess.shapes)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = carry_err(by_kernel, by_plain)
    if not carries_equal(by_kernel, by_plain):
        raise AssertionError(f"9 {label}: scan_delta != plain version (max "
                             f"abs err {err})")
    case_errs = delta_cases(sk, sess, carry_before, node, payload, by_plain,
                            label)
    # (a) the session's own flush: one counted launch
    ipa_before = {k: sess._carry[k].clone() for k in ("ucnt", "kcnt")
                  if k in sess._carry}
    reset_counts(sk)
    torch.cuda.synchronize()
    with timed_prep(sess) as prep:
        t0 = time.perf_counter()
        sess.apply_deltas(deltas)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(sk.VARIANT_LAUNCHES)
    if launches != only(sk, scan_delta=1):
        raise AssertionError(f"9 {label}: apply_deltas launched {launches}")
    if not carries_equal({k: sess._carry[k] for k in by_kernel}, by_kernel):
        raise AssertionError(f"9 {label}: the session's flush differs from "
                             "the bare kernel's")
    if not all(torch.equal(sess._carry[k], v) for k, v in ipa_before.items()):
        raise AssertionError(f"9 {label}: the flush moved ucnt / kcnt")
    # a 1-event flush (a zero node-alloc patch): the call and the kernel
    zero = {"kind": "node-alloc", "node": 0, "dallowed": 0,
            "dalloc": np.zeros(sess.R, np.int64)}
    reset_counts(sk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.apply_deltas([zero])
    torch.cuda.synchronize()
    one_call_ms = (time.perf_counter() - t0) * 1e3
    if sk.VARIANT_LAUNCHES != only(sk, scan_delta=1):
        raise AssertionError(f"9 {label}: a 1-event flush launched "
                             f"{sk.VARIANT_LAUNCHES}")
    kernel_ms, runs = time_delta(sess, node_t, rows_t, carry_before)
    one = [torch.from_numpy(a).cuda() for a in ScanSession._pack_deltas(
        [sess._delta_rows(zero)])]
    one_ms, _ = time_delta(sess, *one, carry_before)
    # every event on one node: one owner lane per row takes them all
    same_node = [torch.full_like(node_t, int(node[0])), rows_t]
    same_ms, _ = time_delta(sess, *same_node, carry_before)
    # the kernel alone: launches back to back in a CUDA graph
    scratch = clone(carry_before)
    device = {name: graph_ms(lambda n=n, r=r: sk.carry_delta(
        n, r, statics, scratch, sess.shapes))
        for name, (n, r) in (("device_ms", (node_t, rows_t)),
                             ("one_device_ms", one),
                             ("same_node_device_ms", same_node))}
    # (c) a fresh session from the mutated encoding: what a rebuild costs,
    # and the carries it starts from
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh = ScanSession(enc.device_state("cuda"), templates, multipod_k=1,
                        device="cuda")
    fresh._carry = fresh._initial_carry()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    got, want = unscaled(sess, sess._carry), unscaled(fresh, fresh._carry)
    diff = [k for k in want if not np.array_equal(got[k], want[k])]
    if diff:
        raise AssertionError(f"9 {label}: {diff} differ from a fresh "
                             "session's")
    # (e) the seeded session through the seed path (no launch)
    reset_counts(sk)
    seeded.apply_deltas(deltas)
    if seeded._carry is not None or sk.LAUNCHES:
        raise AssertionError(f"9 {label}: the seed path launched")
    seed_got = {k: getattr(seeded, f"_{k}0") for k in
                ("requested", "nzpc", "cnt_fn", "cnt_sn")}
    if any(not np.array_equal(a, b) for a, b in zip(
            unscaled(seeded, {k: torch.from_numpy(v)
                              for k, v in seed_got.items()}).values(),
            want.values())):
        raise AssertionError(f"9 {label}: the seed path's arrays differ "
                             "from a fresh session's")
    # (d) the next batch in all three sessions
    batch = [{k: v for k, v in pe.encode(p).items()
              if not k.startswith("_")} for p in next_pods]
    decided = [ScanSession.decisions(x.schedule(batch))
               for x in (sess, fresh, seeded)]
    if decided[0] != decided[1] or decided[2] != decided[1]:
        raise AssertionError(f"9 {label}: the next batch decides otherwise "
                             "than a fresh session")
    placed = sum(x >= 0 for x in decided[0])
    nbound = delta_bound(sess, node, payload)
    counts = {x["kind"]: 0 for x in deltas}
    for x in deltas:
        counts[x["kind"]] += 1
    log(f"phase 9 {label}: {len(events)} events classified in "
        f"{classify_ms:.1f} ms ({counts}, {refused} refused); apply_deltas "
        f"1 launch of scan_delta == plain (max abs err {err}), ucnt/kcnt "
        f"untouched; carries == a fresh session's (unscaled, valid lanes); "
        f"the next {len(batch)}-pod batch ({placed} placed) decides as the "
        f"fresh session and the seed-path session do. scan_delta "
        f"{kernel_ms:.3f} ms per {len(deltas)}-event flush (runs "
        f"{[round(x, 3) for x in runs]}), {one_ms:.3f} ms per 1-event "
        f"flush, {same_ms:.3f} ms with every event on one node; the kernel "
        f"alone (CUDA graph, back to back) {device['device_ms']:.4f} / "
        f"{device['one_device_ms']:.4f} / "
        f"{device['same_node_device_ms']:.4f} ms; apply_deltas call "
        f"{call_ms:.3f} ms ({len(deltas)} events: host prep "
        f"{prep['prep_ms']:.3f} ms = rows {prep['rows_ms']:.3f} + pack "
        f"{prep['pack_ms']:.3f} + uploads {prep['upload_ms']:.3f}, kernel "
        f"{device['device_ms']:.4f}, the rest "
        f"{call_ms - prep['prep_ms'] - device['device_ms']:.3f}) "
        f"and {one_call_ms:.3f} ms (1 event); order-free cases == plain "
        f"(max abs err {case_errs}); plain version {plain_ms:.1f} ms; "
        f"bound {nbound[0]:.4f} ms by {nbound[1]} ({nbound[2]} bytes, "
        f"{nbound[3]} ops); a rebuild: fresh session build {build_s:.3f} s "
        f"[{gpu}]")
    return {"cell": label, "launches": 2,
            "err": max(err, *case_errs.values()), "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": nbound[0],
            "bound_by": nbound[1], "one_ms": one_ms, "same_node_ms": same_ms,
            **device, "call_ms": call_ms, **prep, "one_call_ms": one_call_ms,
            "build_s": build_s, "events": len(deltas), "refused": refused,
            "case_errs": case_errs, "deltas": deltas, "pre_churn": pre_churn,
            "post_churn": post_churn, "next_batch": batch}


def phase_churn_zone(sk, gpu, zone):
    """Phase 9 on the zone-spread cell."""
    import random

    from kubernetes_tpu_torch.testing.synth import synth_pending_pods

    zone["sess"]._carry = clone(zone["carry_end"])
    events = churn_events(zone, random.Random(9))
    next_pods = synth_pending_pods(BATCH, spread=True)
    for i, p in enumerate(next_pods):
        p.metadata.name = f"next-{i}"
    return phase_churn(sk, gpu, zone, events, next_pods, "zone spread 5000n")


def phase_churn_affinity(sk, gpu, d):
    """Phase 9 on the preferred-affinity cell (ur > 0): foreign pods that
    match no term, and an app=aff pod that classifies as structural."""
    import random

    from kubernetes_tpu_torch.ops.hoisted import ipa_term_match_np
    from kubernetes_tpu_torch.testing import churn
    from kubernetes_tpu_torch.testing.synth import make_pod

    sess, enc = d["sess"], d["enc"]
    rng = random.Random(6)
    names = [n for n in enc.node_names if n is not None]
    probe = make_pod("foreign-aff", cpu="100m", memory="128Mi",
                     labels=dict(d["labels"]), node_name=names[0])
    rows = churn.pod_self_rows(enc, probe)
    if not ipa_term_match_np(sess._term_np, rows) or churn.pod_delta(
            sess, enc, probe, names[0], 1, lambda: None) is not None:
        raise AssertionError("9: an app=aff pod did not classify as "
                             "structural")
    events = [("add", make_pod(f"foreign-{i}", cpu="100m", memory="128Mi",
                               node_name=rng.choice(names)))
              for i in range(AFF_FOREIGN)]
    next_pods = [make_pod(f"next-{i}", cpu="100m", memory="128Mi",
                          labels=dict(d["labels"]), affinity=d["affinity"])
                 for i in range(AFF_BATCHES[-1])]
    got = phase_churn(sk, gpu, d, events, next_pods, d["cell"])
    log(f"phase 9 {d['cell']}: an {d['labels']} pod classifies as "
        "structural (ipa_term_match_np)")
    return got


def wall_ms(fn):
    """Host ms of fn() on the card, synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_probes(gpu):
    """Phase 10: each probe through its entry point (counted), held to
    its plain version, timed, and bounded. Returns the kernels-line
    entries."""
    import torch
    from kubernetes_tpu_torch.probes import event_ms
    from kubernetes_tpu_torch.probes import probe_fixed_cost as pf
    from kubernetes_tpu_torch.probes import probe_layouts as pl
    from kubernetes_tpu_torch.probes import probe_scan as ps

    entries = []

    def add(name, replaces, launches, err, ms, plain_ms, nbound,
            library_ms=None, **extra):
        entries.append(entry(name, replaces, {
            "launches": launches, "err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbound[0], "bound_by": nbound[1],
            "library_ms": library_ms}, source=PROBES, **extra))
        return nbound

    # probe_scan (scripts/probe_pallas.py:38)
    req, alloc = ps.inputs("cuda")
    ps.LAUNCHES.update(dict.fromkeys(ps.LAUNCHES, 0))
    out = ps.probe_scan(req, alloc)
    torch.cuda.synchronize()
    n_scan = ps.LAUNCHES["probe_scan"]
    plain_ms, ref = wall_ms(lambda: ps.probe_scan_reference(req, alloc))
    err = int((out.long() - ref.long()).abs().max())
    first = out[:8, 0].tolist()
    if err or first != list(range(8)):
        raise AssertionError(f"10: probe_scan != plain version (err {err}) "
                             f"or first decisions {first}")
    times = event_ms(lambda: ps.probe_scan(req, alloc))
    ms = statistics.median(times)
    B, N = ps.B, ps.N
    # fit (add, compare), score (subtract, select), the argmax compare per
    # lane and step; the one-hot update per step
    nb = add("probe_scan", "scripts/probe_pallas.py:38", n_scan, err, ms,
             plain_ms, roofline(4 * (B + N + B * ps.OUT_LANES),
                                5 * B * N + B),
             us_per_step=ms * 1e3 / B)
    log(f"phase 10: probe_scan == plain, first decisions {first}; "
        f"{ms:.3f} ms for {B} steps over {N} lanes ({ms * 1e3 / B:.2f} us "
        f"per step; runs {[round(x, 3) for x in times]}), plain version "
        f"{plain_ms:.1f} ms, bound {nb[0]:.5f} ms by {nb[1]} [{gpu}]")

    # probe_int64 (scripts/probe_pallas.py:69)
    a = ps.int64_input("cuda")
    out = ps.probe_int64(a)
    torch.cuda.synchronize()
    n64 = ps.LAUNCHES["probe_int64"]
    plain_ms, ref = wall_ms(lambda: ps.probe_int64_reference(a))
    err = int((out - ref).abs().max())
    if err:
        raise AssertionError(f"10: probe_int64 != plain version ({err})")
    call_ms = statistics.median(event_ms(lambda: ps.probe_int64(a)))
    ones = torch.ones_like(a)
    library_call_ms = statistics.median(
        event_ms(lambda: torch.add(ones, a, alpha=2)))
    # the kernel and the library call alone: each a CUDA graph of
    # INT64_GRAPH_RUNS launches, replayed 5 times in turns
    kernel_runs, library_runs = graph_turns(
        lambda: ps.probe_int64(a), lambda: torch.add(ones, a, alpha=2),
        INT64_GRAPH_RUNS)
    ms, library_ms = (statistics.median(x) for x in (kernel_runs,
                                                       library_runs))
    nb = add("probe_int64", "scripts/probe_pallas.py:69", n64, err, ms,
             plain_ms, roofline(2 * a.numel() * 8, 2 * a.numel()),
             library_ms=library_ms, runs=kernel_runs,
             library_runs=library_runs, call_ms=call_ms,
             library_call_ms=library_call_ms)
    log(f"phase 10: probe_int64 == plain ({out[0, :3].tolist()}); {ms:.5f} "
        f"ms, torch.add(1, a, alpha=2) {library_ms:.5f} ms (medians of 5 "
        f"replays of a {INT64_GRAPH_RUNS}-launch CUDA graph: "
        f"{[round(x, 5) for x in kernel_runs]}, "
        f"{[round(x, 5) for x in library_runs]}); one call by CUDA events "
        f"{call_ms:.4f} / {library_call_ms:.4f} ms; plain version "
        f"{plain_ms:.3f} ms, bound {nb[0]:.7f} ms by {nb[1]} [{gpu}]")

    # probe_layouts k1-k3 (scripts/probe_pallas2.py:14)
    req, alloc = pl.inputs("cuda")
    pl.LAUNCHES = 0
    outs = {k: pl.probe_layouts(k, req, alloc) for k in pl.KERNELS}
    torch.cuda.synchronize()
    n_lay = pl.LAUNCHES
    err, ms, plain_ms, nbytes, ops, parts = 0, 0.0, 0.0, 0, 0, {}
    for k, name in pl.KERNELS.items():
        p_ms, ref = wall_ms(
            lambda k=k: pl.probe_layouts_reference(k, req, alloc))
        e = float((outs[k] - ref).abs().max())
        err = max(err, e)
        if e:
            raise AssertionError(f"10: probe_layouts {name} != plain ({e})")
        k_ms = statistics.median(
            event_ms(lambda k=k: pl.probe_layouts(k, req, alloc)))
        B, N = req.shape[0], alloc.shape[1]
        k_ops = (B * pl.OUT_LANES if k == 1 else 2 * B * N) + (B if k == 3
                                                               else 0)
        nbytes += 4 * (req.numel() + alloc.numel() + req.numel())
        ops += k_ops
        ms += k_ms
        plain_ms += p_ms
        parts[f"k{k}"] = {"ms": k_ms, "decisions": outs[k][:8, 0].tolist()}
        log(f"phase 10: probe_layouts {name}: OK == plain, decisions "
            f"{outs[k][:8, 0].tolist()}, {k_ms:.4f} ms ({k_ms * 1e3 / B:.2f} "
            f"us per step), plain version {p_ms:.1f} ms [{gpu}]")
    nb = add("probe_layouts", "scripts/probe_pallas2.py:14", n_lay, err, ms,
             plain_ms, roofline(nbytes, ops), parts=parts)
    log(f"phase 10: probe_layouts k1+k2+k3 {ms:.4f} ms, bound {nb[0]:.6f} "
        f"ms by {nb[1]} [{gpu}]")

    # probe_fixed_cost (scripts/probe_fixed_cost.py:49)
    pf.LAUNCHES = 0
    m = pf.measure("cuda")
    n_fixed = pf.LAUNCHES
    if not m["equal"]:
        raise AssertionError("10: probe_fixed_cost != plain version")
    tensors, _ = pf.arguments("cuda")
    plain_ms, _ = wall_ms(lambda: pf.fixed_cost_reference(tensors["meta"],
                                                          pf.Bp))
    # out written once and B_real read; the body's 8*Bp*(B_real + 1)
    # adds as it is written
    nb = add("probe_fixed_cost", "scripts/probe_fixed_cost.py:49", n_fixed,
             0, m["steady_event_ms"], plain_ms,
             roofline(8 * pf.Bp * 4 + 4, 8 * pf.Bp * (pf.Bp + 1)),
             first_event_ms=m["first_event_ms"],
             first_wall_ms=m["first_wall_ms"],
             steady_wall_ms=m["steady_wall_ms"],
             empty_event_ms=m["empty_event_ms"],
             empty_wall_ms=m["empty_wall_ms"])
    log(f"phase 10: probe_fixed_cost == plain; first launch in this process "
        f"(its library just loaded) "
        f"{m['first_wall_ms']:.3f} ms wall / {m['first_event_ms']:.3f} ms "
        f"events, steady (min of {pf.STEADY}) {m['steady_wall_ms']:.3f} ms "
        f"wall / {m['steady_event_ms']:.3f} ms events, B_real = 0 "
        f"{m['empty_wall_ms']:.3f} ms wall / {m['empty_event_ms']:.3f} ms "
        f"events; {n_fixed} launches; bound {nb[0]:.6f} ms by {nb[1]} "
        f"[{gpu}]")
    return entries


def hoisted_run(sess, pods):
    """One HoistedSession.schedule over `pods` on the card: (decisions,
    ys, host ms, CUDA-event ms). The events bracket the enqueue of the
    per-pod steps; the host window ends when the decisions are read."""
    import torch
    from kubernetes_tpu_torch.ops.hoisted import HoistedSession

    gc.collect()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    ys = sess.schedule(pods)
    e1.record()
    decisions = HoistedSession.decisions(ys)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return decisions, ys, host_ms, e0.elapsed_time(e1)


def hoisted_vs_scan(gpu, snapshot, templates, pods, label, dyn_ipa):
    """Phases 11a / 11b: HoistedSession and ScanSession on the card, both
    built from the encoding `snapshot` (the carry the cell's ScanSession
    started from), schedule `pods`; their decisions must be equal (the
    reference's contract between the kernel session and the hoisted one,
    kubernetes_tpu/ops/pallas_scan.py:213-217). Returns the numbers."""
    import torch
    from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
    from kubernetes_tpu_torch.ops.hoisted import HoistedSession
    from kubernetes_tpu_torch.ops.scan import ScanSession

    cluster = cluster_from_numpy(snapshot, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = HoistedSession(cluster, templates, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if hs.dyn_ipa != dyn_ipa or hs.multipod_k != 1:
        raise AssertionError(f"{label}: dyn_ipa {hs.dyn_ipa}, multipod_k "
                             f"{hs.multipod_k}")
    ss = ScanSession(cluster, templates, multipod_k=1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ScanSession.decisions(ss.schedule(pods))
    scan_ms = (time.perf_counter() - t0) * 1e3
    carry0 = {k: v.clone() for k, v in hs._carry.items()}
    got, _, host_ms, event_ms = hoisted_run(hs, pods)
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"{label}: HoistedSession decides {bad} of "
                             f"{len(pods)} pods otherwise than ScanSession")
    # the first pods again from the carry before them, under the profiler:
    # the card's busy time and the kernels launched per pod
    hs._carry = carry0
    busy = device_busy(lambda: hs.schedule(pods[:PROFILED_PODS]))
    n = len(pods)
    placed = sum(d >= 0 for d in got)
    log(f"phase {label}: HoistedSession(cuda) == ScanSession(cuda) on "
        f"{n} pods ({placed} placed) at {cluster['valid'].shape[0]} node "
        f"rows, T={len(templates)}, dyn_ipa={hs.dyn_ipa}; build "
        f"{build_s:.3f} s; {host_ms / n:.3f} ms per pod by the host "
        f"window, {event_ms / n:.3f} ms by CUDA events; "
        f"{n / host_ms * 1e3:.1f} pods/s; ScanSession on the same pods "
        f"{scan_ms / n:.4f} ms per pod (one schedule call, wait included); "
        f"under the profiler ({PROFILED_PODS} pods): {busy['kernels_per_pod']:.1f} "
        f"kernels per pod, the card busy {busy['busy_ms']:.3f} of "
        f"{busy['window_ms']:.3f} ms ({busy['busy_share']:.1%}) [{gpu}]")
    return {"cell": label, "pods": n, "build_s": build_s,
            "ms_per_pod": host_ms / n, "event_ms_per_pod": event_ms / n,
            "pods_per_s": n / host_ms * 1e3,
            "scan_session_ms_per_pod": scan_ms / n, **busy, "sess": hs,
            "cluster": cluster}


def device_busy(fn, pods=PROFILED_PODS):
    """Run fn under torch.profiler: the card's busy time (the sum of its
    kernels' device time), the host window, and kernels per pod of the
    `pods` it schedules. The device's activity alone is traced (the host's
    ops would only slow the trace's processing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    return {"busy_ms": busy_ms, "window_ms": window_ms,
            "busy_share": busy_ms / window_ms,
            "kernels_per_pod": len(kernels) / pods}


def phase_host_ports(gpu):
    """Phase 11c: bench.py's zone-spread shape at 5000 nodes with a
    quarter of the pods carrying a hostPort (the carried NodePorts tables);
    ScanSession refuses it, HoistedSession on cuda and on cpu from the
    same encoding decide equally and leave equal carries, and no two
    placed pods share a (node, port)."""
    import torch
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
    from kubernetes_tpu_torch.ops.hoisted import HoistedSession
    from kubernetes_tpu_torch.ops.scan import ScanSession, SessionUnsupported
    from kubernetes_tpu_torch.testing.synth import (
        synth_cluster,
        synth_pending_pods,
    )

    t0 = time.perf_counter()
    nodes, init_pods = synth_cluster(5000, pods_per_node=2)
    pending = synth_pending_pods(HOISTED_PODS, spread=True)
    for i, p in enumerate(pending):
        if i % 4 == 1:
            p.spec.containers[0].ports = [v1.ContainerPort(
                host_port=HOST_PORT, container_port=HOST_PORT)]
    enc, pe = presized_encoding(nodes, init_pods, pending)
    arrays, templates = encode_templates(pe, pending)
    snapshot = enc.host_snapshot()
    setup_s = time.perf_counter() - t0
    try:
        ScanSession(cluster_from_numpy(snapshot, "cuda"), templates,
                    device="cuda")
        raise AssertionError("11c: ScanSession took host-port templates")
    except SessionUnsupported as exc:
        if exc.reason != "host-ports":
            raise
    t0 = time.perf_counter()
    cuda = HoistedSession(cluster_from_numpy(snapshot, "cuda"), templates,
                          device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = HoistedSession(cluster_from_numpy(snapshot, "cpu"), templates,
                         device="cpu")
    cpu_build_s = time.perf_counter() - t0
    got, _, host_ms, event_ms = hoisted_run(cuda, arrays)
    t0 = time.perf_counter()
    want = HoistedSession.decisions(cpu.schedule(arrays))
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if got != want:
        raise AssertionError("11c: cuda and cpu decide otherwise")
    if not carries_equal(cuda._carry, clone_to(cpu._carry, "cuda")):
        raise AssertionError("11c: the carries differ after the batch")
    ported = [d for i, d in enumerate(got) if i % 4 == 1 and d >= 0]
    if len(ported) != len(set(ported)):
        raise AssertionError("11c: two pods share a (node, port)")
    held = cuda._carry["cp_any"].cpu()
    if int(held.max()) > 1:
        raise AssertionError("11c: a node's port table counts a port twice")
    n = len(arrays)
    log(f"phase 11c host ports: setup {setup_s:.1f} s; {n} pods, "
        f"{len(ported)} with hostPort {HOST_PORT} placed on distinct nodes; "
        f"ScanSession refuses (host-ports); HoistedSession cuda == cpu "
        f"(decisions and every carry, cp_any / cp_wild / cp_trip "
        f"included); build {build_s:.3f} s (cpu {cpu_build_s:.3f} s); "
        f"{host_ms / n:.3f} ms per pod by the host window, "
        f"{event_ms / n:.3f} ms by CUDA events, {n / host_ms * 1e3:.1f} "
        f"pods/s (cpu {cpu_ms / n:.3f} ms per pod) [{gpu}]")
    return {"cell": "11c host ports", "pods": n, "build_s": build_s,
            "ms_per_pod": host_ms / n, "event_ms_per_pod": event_ms / n,
            "pods_per_s": n / host_ms * 1e3, "cpu_ms_per_pod": cpu_ms / n}


def phase_explain(gpu, snapshot, templates, pods):
    """Phase 11d: explain_k=3 on the card and on the cpu from the same
    encoding: equal payloads, and each placed pod's first candidate is its
    decision."""
    import numpy as np
    from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
    from kubernetes_tpu_torch.ops.hoisted import HoistedSession

    sessions = [HoistedSession(cluster_from_numpy(snapshot, dev), templates,
                               explain_k=3, device=dev)
                for dev in ("cuda", "cpu")]
    got, ys, host_ms, event_ms = hoisted_run(sessions[0], pods)
    ys_cpu = sessions[1].schedule(pods)
    if got != HoistedSession.decisions(ys_cpu):
        raise AssertionError("11d: cuda and cpu decide otherwise")
    pay = HoistedSession.explain_payload(ys)
    pay_cpu = HoistedSession.explain_payload(ys_cpu)
    for i, (a, b) in enumerate(zip(pay, pay_cpu)):
        for k in a:
            if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
                raise AssertionError(f"11d: pod {i} payload {k} differs")
        if got[i] >= 0 and int(a["topk_idx"][0]) != got[i]:
            raise AssertionError(f"11d: pod {i}'s first candidate is not "
                                 "its decision")
    n = len(pods)
    log(f"phase 11d explain: explain_k=3 on {n} pods, payload cuda == cpu "
        f"(bits, top-3 indices, totals, score splits), every first "
        f"candidate the decision; {host_ms / n:.3f} ms per pod by the "
        f"host window, {event_ms / n:.3f} ms by CUDA events [{gpu}]")
    return {"cell": "11d explain", "pods": n, "ms_per_pod": host_ms / n,
            "event_ms_per_pod": event_ms / n}


def phase_hoisted_churn(gpu, zone, churn, pods):
    """Phase 11e: phase 9's zone-spread flush, as the classified delta
    dicts, into a HoistedSession on the card built from the encoding
    before the churn; its carries and alloc then equal a fresh session's
    from the mutated encoding, and the next pods decide as that fresh
    session does."""
    import torch
    from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
    from kubernetes_tpu_torch.ops.hoisted import HoistedSession

    templates = zone["templates"]
    live = HoistedSession(cluster_from_numpy(churn["pre_churn"], "cuda"),
                          templates, device="cuda")
    # ScanSession's match rows cover its pow2-padded template axis (copies
    # of template 0 past T): the first T rows are the hoisted session's
    t_n = len(templates)
    deltas = [dict(d, mf=d["mf"][:t_n], ms=d["ms"][:t_n])
              if d["kind"] != "node-alloc" else d for d in churn["deltas"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    live.apply_deltas(deltas)
    torch.cuda.synchronize()
    apply_ms = (time.perf_counter() - t0) * 1e3
    fresh = HoistedSession(zone["enc"].device_state("cuda"), templates,
                           device="cuda")
    if not carries_equal(live._carry, fresh._carry):
        raise AssertionError("11e: the patched carries differ from a "
                             "fresh session's")
    for k in ("alloc", "allowed_pods"):
        if not torch.equal(live._c_static[k], fresh._c_static[k]):
            raise AssertionError(f"11e: the patched {k} differs")
    got, _, host_ms, _ = hoisted_run(live, pods)
    want = HoistedSession.decisions(fresh.schedule(pods))
    if got != want:
        raise AssertionError("11e: the next pods decide otherwise than a "
                             "fresh session")
    log(f"phase 11e churn: {len(deltas)} events into HoistedSession(cuda) "
        f"by one apply_deltas in {apply_ms:.3f} ms; carries, alloc and "
        f"allowed_pods == a fresh session's; the next {len(pods)} pods "
        f"({sum(d >= 0 for d in got)} placed) decide as the fresh session "
        f"does ({host_ms / len(pods):.3f} ms per pod) [{gpu}]")
    return {"cell": "11e churn", "events": len(deltas), "apply_ms": apply_ms}


def phase_log(gpu, n_max):
    """Phase 11f: the PTS weight log(n + 2) in f64 on the card. torch.log
    there against the table (math.log's values, which the CPU tests hold
    to JAX's CPU f64 log), and the session's table read on the card equal
    to the table built on the host, for n in [0, n_max]."""
    import torch
    from kubernetes_tpu_torch.ops import kernel as K

    x = torch.arange(n_max + 1, dtype=torch.float64)
    table = K.log_table(n_max, torch.device("cpu"))
    direct = torch.log(x.cuda() + 2.0).cpu()
    differ = int((direct.view(torch.int64) != table.view(torch.int64)).sum())
    on_card = K.log_plus_2(x.cuda(), n_max)
    if not torch.equal(on_card.cpu().view(torch.int64),
                       table.view(torch.int64)):
        raise AssertionError("11f: the table read on the card differs")
    log(f"phase 11f f64 log: torch.log on the card differs from math.log "
        f"(= JAX's CPU f64 log) at {differ} of {n_max + 1} arguments n + 2; "
        f"the port's table read on the card equals it at all [{gpu}]")
    return {"log_args": n_max + 1, "torch_log_differs": differ}


def phase_hoisted(gpu, zone, pref, churn):
    """Phase 11: the hoisted session (HoistedSession) on the card."""
    out = {"11a": hoisted_vs_scan(gpu, zone["snapshot0"], zone["templates"],
                                  zone["batch"][:HOISTED_PODS],
                                  "11a zone spread 5000n", False)}
    out["11b"] = hoisted_vs_scan(gpu, pref["snapshot0"], pref["templates"],
                                 pref["batch0"], f"11b {pref['cell']}", True)
    out["11c"] = phase_host_ports(gpu)
    out["11d"] = phase_explain(gpu, zone["snapshot0"], zone["templates"],
                               zone["batch"][:EXPLAIN_PODS])
    out["11e"] = phase_hoisted_churn(gpu, zone, churn,
                                     churn["next_batch"][:HOISTED_PODS])
    n_max = max(int(zone["snapshot0"]["valid"].shape[0]),
                int(zone["snapshot0"]["npair"].shape[1]))
    out["11f"] = phase_log(gpu, n_max)
    for k in ("11a", "11b"):
        out[k].pop("sess")
        out[k].pop("cluster")
    return out


# -- phase 12: the backend (TPUBackend) on the card ---------------------------

BACKEND_HOST_PODS = 512          # phase 12d's pods (11c's shape, cut)
BACKEND_REPS = 2                 # phase 12a's runs at each depth
DRILL_SMALL = 256                # phase 12e's faulted batches


def backend_world(nodes, init_pods, pending, max_pending=2, device="cuda"):
    """A port SchedulerCache with a TPUBackend listening; the encoding
    pre-sized as the perf harness does (kubernetes_tpu/perf/
    harness.py:603-614, plus score-term rows, as `reserved_encoding`);
    the nodes and the bound pods enter as cache events; then, as
    `reserved_encoding` does, a few pending pods are encoded and the
    encoding synced, so that its vocabularies and tables hold their
    sizes from the first batch on. -> (cache, backend, feed s)."""
    from kubernetes_tpu_torch.scheduler.internal.cache import SchedulerCache
    from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend

    t0 = time.perf_counter()
    be = TPUBackend(device=device)
    be.max_pending = max_pending
    be.enc.reserve(pods=int((len(init_pods) + len(pending)) * 1.25),
                   score_terms=len(init_pods) + len(pending))
    cache = SchedulerCache()
    cache.add_listener(be)
    for node in nodes:
        cache.add_node(node)
    for pod in init_pods:
        cache.add_pod(pod)
    for pod in pending[:8]:
        be.pe.encode(pod)
    with be._on_stream():
        be.enc.device_state(be.device)
    return cache, be, time.perf_counter() - t0


def assumed(pod, node):
    """The assumed copy of a placed pod, as the scheduler hands it to
    the cache (the caller's object is never mutated)."""
    import copy

    q = copy.copy(pod)
    q.spec = copy.copy(pod.spec)
    q.spec.node_name = node
    return q


class BackendRun:
    """Drives batches through `dispatch_many` / `harvest` as a scheduler
    with `max_pending` batches in flight does: a batch is harvested when
    the pipeline is full (inside dispatch_many) or at the end, and each
    harvest's placements are assumed in the cache (the listener's echo).
    Times each session build, and brackets each kernel launch of the
    session with CUDA events on the backend's stream (`kernel_ms`)."""

    def __init__(self, cache, be):
        import torch
        from kubernetes_tpu_torch.ops import scan as scan_mod

        self.cache, self.be = cache, be
        self.bindings = {}
        self.build_s = []
        self.events = []
        # host seconds in dispatch_many (encode + enqueue, and at depth 1
        # the inline harvest), harvest (wait + readback + decode + the
        # encoding's assume), the cache's assume_pods, and waiting on the
        # batches' events (inside both)
        self.stage = dict.fromkeys(("dispatch", "harvest", "assume", "wait"),
                                   0.0)
        orig_wait = be._wait_ready

        def timed_wait(*args):
            t0 = time.perf_counter()
            try:
                return orig_wait(*args)
            finally:
                self.stage["wait"] += time.perf_counter() - t0

        be._wait_ready = timed_wait
        self._scan_mod = scan_mod
        self._orig = scan_mod.scan_full
        orig_build = be._build_session

        def timed_build():
            t0 = time.perf_counter()
            out = orig_build()
            self.build_s.append(time.perf_counter() - t0)
            return out

        be._build_session = timed_build
        cuda = be.device.type == "cuda"

        def timed_scan(*args, **kwargs):
            if not cuda:
                return self._orig(*args, **kwargs)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self._orig(*args, **kwargs)
            e1.record()
            self.events.append((e0, e1))
            return out

        scan_mod.scan_full = timed_scan

    def close(self):
        self._scan_mod.scan_full = self._orig

    def reset(self):
        self.stage.update(dict.fromkeys(self.stage, 0.0))

    def _timed(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.stage[name] += time.perf_counter() - t0

    def land(self, results):
        placed = []
        for pod, node in results:
            self.bindings[pod.metadata.name] = node
            if node:
                placed.append(assumed(pod, node))
        self._timed("assume", self.cache.assume_pods, placed)

    def run(self, batches, measured=False):
        """Every batch through the pipeline; returns the host window s.
        A measured window starts after a collection and runs with the
        collector off (a full pass over the run's objects takes longer
        than a batch)."""
        if measured:
            gc.collect()
            gc.disable()
        t0 = time.perf_counter()
        try:
            handles = []
            for batch in batches:
                handles.append(self._timed("dispatch", self.be.dispatch_many,
                                           batch))
                # a handle the dispatch harvested (pipeline full) lands now
                while handles and handles[0].results is not None:
                    self.land(self._timed("harvest", self.be.harvest,
                                          handles.pop(0)))
            for h in handles:
                self.land(self._timed("harvest", self.be.harvest, h))
            return time.perf_counter() - t0
        finally:
            if measured:
                gc.enable()

    def stages_ms(self):
        return {k: v * 1e3 for k, v in self.stage.items()}

    def kernel_ms(self, start=0):
        return sum(a.elapsed_time(b) for a, b in self.events[start:])


def counters():
    """The backend's metrics that phase 12 asserts on, as flat dicts."""
    from kubernetes_tpu_torch.scheduler import metrics

    return {name: dict(getattr(metrics, name).items())
            for name in ("session_builds", "session_rebuilds",
                         "session_delta_applies", "device_faults")}


def counters_delta(before):
    after = counters()
    return {name: {k: v - before[name].get(k, 0.0)
                   for k, v in after[name].items()
                   if v != before[name].get(k, 0.0)}
            for name in after}


def assert_top_rung(be, delta, label, allow_hoisted=False):
    """12a-12c: the ladder on its top rung throughout, 0 device faults,
    0 failed delta applies, no hoisted build."""
    if be.ladder.rung() != be.ladder.top or be.ladder.demotions:
        raise AssertionError(f"{label}: ladder left its top rung "
                             f"({be.ladder.mode()}, {be.ladder.demotions} "
                             "demotions)")
    if delta["device_faults"]:
        raise AssertionError(f"{label}: device faults {delta['device_faults']}")
    failed = {k: v for k, v in delta["session_rebuilds"].items()
              if k[0] == "delta-apply-failed"}
    if failed:
        raise AssertionError(f"{label}: failed delta applies {failed}")
    hoisted = {k: v for k, v in delta["session_builds"].items()
               if k[0] != "kernel"}
    if hoisted and not allow_hoisted:
        raise AssertionError(f"{label}: builds below the kernel rung "
                             f"{hoisted}")


def launched(sk, before):
    return {k: v - before[k] for k, v in sk.VARIANT_LAUNCHES.items()
            if v != before[k]}


def zone_batches():
    from kubernetes_tpu_torch.testing.synth import synth_pending_pods

    pending = synth_pending_pods(3 * BATCH, spread=True)
    return [pending[i:i + BATCH] for i in range(0, len(pending), BATCH)]


def phase_backend_zone(sk, gpu, zone, nodes, init_pods):
    """Phase 12a: phase 4's cell through fresh backends at max_pending 2
    and 1, BACKEND_REPS runs each, alternating which depth goes first;
    every run binds as phase 4's ScanSession did. Returns the numbers
    (medians over the runs, and every window), the last depth-1 world
    (for 12c) and each run's launches."""
    import torch

    out = {"cell": "12a zone spread 5000n"}
    runs = {2: [], 1: []}
    launches = []
    order = [d for rep in range(BACKEND_REPS)
             for d in ((2, 1) if rep % 2 == 0 else (1, 2))]
    for depth in order:
        batches = zone_batches()
        cache, be, feed_s = backend_world(
            nodes, init_pods, [p for b in batches for p in b],
            max_pending=depth)
        before, lbefore = counters(), dict(sk.VARIANT_LAUNCHES)
        run = BackendRun(cache, be)
        try:
            first_s = run.run(batches[:1])      # builds the session
            torch.cuda.synchronize()
            k0 = len(run.events)
            run.reset()
            window_s = run.run(batches[1:], measured=True)
            kernel_ms = run.kernel_ms(k0)
        finally:
            run.close()
        delta = counters_delta(before)
        launches.append(launched(sk, lbefore))
        assert_top_rung(be, delta, f"12a depth {depth}")
        if run.bindings != zone["bindings"]:
            bad = sum(run.bindings.get(k) != v
                      for k, v in zone["bindings"].items())
            raise AssertionError(f"12a depth {depth}: {bad} bindings differ "
                                 "from phase 4's ScanSession")
        if launches[-1].get("scan_full", 0) < 3:
            raise AssertionError(f"12a depth {depth}: launches "
                                 f"{launches[-1]}")
        runs[depth].append({
            "window_ms": window_s * 1e3, "kernel_ms": kernel_ms,
            "first_batch_ms": first_s * 1e3, "build_s": run.build_s[0],
            "feed_s": feed_s, "stages_ms": run.stages_ms()})
        log(f"phase 12a depth {depth}: {len(run.bindings)} pods == phase "
            f"4's bindings; fed 5000 nodes + {len(init_pods)} pods through "
            f"the cache in {feed_s:.2f} s; first batch (session build "
            f"{run.build_s[0]:.3f} s) {first_s * 1e3:.1f} ms; 2 measured "
            f"batches {window_s * 1e3:.1f} ms, kernel {kernel_ms:.3f} ms by "
            f"CUDA events; host stages " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in run.stages_ms().items())
            + f"; rung {be.ladder.mode()}, 0 faults [{gpu}]")
        if depth == 1:
            world = (cache, be, run)
    n = 2 * BATCH
    for depth, rs in runs.items():
        med = {k: statistics.median(r[k] for r in rs)
               for k in ("window_ms", "kernel_ms", "first_batch_ms",
                         "build_s", "feed_s")}
        med["stages_ms"] = {k: statistics.median(r["stages_ms"][k]
                                                 for r in rs)
                            for k in rs[0]["stages_ms"]}
        med["pods_per_s"] = n / med["window_ms"] * 1e3
        med["kernel_share"] = med["kernel_ms"] / med["window_ms"]
        med["windows_ms"] = [r["window_ms"] for r in rs]
        out[f"depth{depth}"] = med
        log(f"phase 12a depth {depth}, median of {len(rs)} runs: "
            f"{med['window_ms']:.1f} ms for {n} pods ({med['pods_per_s']:.1f} "
            f"pods/s; windows {[round(w, 1) for w in med['windows_ms']]}), "
            f"kernel share {med['kernel_share']:.1%}, wait "
            f"{med['stages_ms']['wait']:.1f} ms, session build "
            f"{med['build_s']:.3f} s [{gpu}]")
    out["depth_gain_ms"] = out["depth1"]["window_ms"] - \
        out["depth2"]["window_ms"]
    out["enqueue"] = enqueue_probe(gpu, world[1])
    return out, world, launches


def enqueue_probe(gpu, be):
    """What the pinned uploads buy: the host time of one
    `ScanSession.schedule` (batch prep, staged uploads, launch) on the
    card idle and with the previous batch's kernel still running, on a
    scratch session from `be`'s encoding (its launches are not the
    backend's and no phase-12 count includes them)."""
    import torch
    from kubernetes_tpu_torch.ops.scan import ScanSession
    from kubernetes_tpu_torch.testing.synth import synth_pending_pods

    pods = synth_pending_pods(2 * BATCH, spread=True)
    arrays = [{k: v for k, v in be.pe.encode(p).items()
               if not k.startswith("_")} for p in pods]
    sess = ScanSession(be.enc.scratch_state("cuda"),
                       list(be._known_templates.values()), device="cuda")
    times = {"idle_ms": [], "busy_ms": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.schedule(arrays[:BATCH])
        times["idle_ms"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()       # the first batch's kernel runs
        sess.schedule(arrays[BATCH:])
        times["busy_ms"].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    out = {k: statistics.median(v) for k, v in times.items()}
    log(f"phase 12a enqueue: one {BATCH}-pod ScanSession.schedule takes "
        f"{out['idle_ms']:.2f} ms of host time on an idle card and "
        f"{out['busy_ms']:.2f} ms with the previous batch's kernel running "
        f"(medians of 3) [{gpu}]")
    return out


def warm_launch(sess) -> None:
    """The counterpart of the reference's warm_buckets that the backend
    leaves out: one launch of a built ScanSession's kernel over a batch of
    no pods (meta[0] = 0), on the current stream; the carries stay as
    they are."""
    import numpy as np
    from kubernetes_tpu_torch.ops.scan import LANE, WEIGHT_ORDER, scan_full

    if sess._carry is None:
        sess._carry = sess._initial_carry()
    dev = sess._stage({"meta": np.zeros(1 + LANE, np.int32),
                       "match": np.zeros((LANE, 2 * LANE), np.int8)})
    scan_full(dev["meta"], dev["match"], sess._get_statics(), sess._carry,
              sess.shapes, tuple(int(sess.weights[k]) for k in WEIGHT_ORDER),
              mode="full", mk=sess.multipod_k)


def warm_child(flag: int) -> None:
    """A fresh process: the first batch of 12a's cell through a backend,
    with (1) or without (0) a warm launch of the kernel session as it is
    built. Prints one JSON line."""
    import torch
    from kubernetes_tpu_torch.testing.synth import synth_cluster

    nodes, init_pods = synth_cluster(5000, pods_per_node=2)
    batches = zone_batches()
    cache, be, _ = backend_world(nodes, init_pods,
                                 [p for b in batches for p in b])
    if flag:
        build = be._build_session

        def build_and_warm():
            sess = build()
            with be._on_stream():
                warm_launch(sess)
            return sess

        be._build_session = build_and_warm
    torch.cuda.synchronize()
    run = BackendRun(cache, be)
    try:
        first_s = run.run(batches[:1])
    finally:
        run.close()
    print(json.dumps({"warm": flag, "first_batch_ms": first_s * 1e3,
                      "build_s": run.build_s[0],
                      "scan_ms": run.kernel_ms(0)}), flush=True)


def warm_compare(gpu):
    """12a's first batch in two fresh processes, warm launch off and on."""
    out = {}
    for flag in (0, 1):
        res = subprocess.run(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
             f"chip_smoke.warm_child({flag})"],
            capture_output=True, text=True, timeout=300, cwd=HERE)
        if res.returncode != 0:
            raise AssertionError(f"12a warm child {flag} failed:\n"
                                 f"{res.stderr[-3000:]}")
        out["warm" if flag else "cold"] = json.loads(
            res.stdout.strip().splitlines()[-1])
    log(f"phase 12a first batch in a fresh process: without the warm launch "
        f"{out['cold']['first_batch_ms']:.1f} ms (build "
        f"{out['cold']['build_s']:.3f} s, launches by CUDA events "
        f"{out['cold']['scan_ms']:.3f} ms), with it "
        f"{out['warm']['first_batch_ms']:.1f} ms (build "
        f"{out['warm']['build_s']:.3f} s, launches {out['warm']['scan_ms']:.3f}"
        f" ms) [{gpu}]")
    return out


def phase_backend_affinity(sk, gpu, pref):
    """Phase 12b: phase 6's preferred-affinity cell through the backend
    (ur > 0), its batches at max_pending 2; bindings == phase 6's."""
    name, nodes, init_pods, pending, _, _ = affinity_workload(pref["kind"])
    cache, be, feed_s = backend_world(nodes, init_pods, pending)
    batches, lo = [], 0
    for size in AFF_BATCHES:
        batches.append(pending[lo:lo + size])
        lo += size
    before, lbefore = counters(), dict(sk.VARIANT_LAUNCHES)
    run = BackendRun(cache, be)
    try:
        run.run(batches[:1])
        k0 = len(run.events)
        run.reset()
        window_s = run.run(batches[1:], measured=True)
        kernel_ms = run.kernel_ms(k0)
    finally:
        run.close()
    delta = counters_delta(before)
    launches = launched(sk, lbefore)
    assert_top_rung(be, delta, "12b")
    if run.bindings != pref["bindings"]:
        bad = sum(run.bindings.get(k) != v for k, v in pref["bindings"].items())
        raise AssertionError(f"12b: {bad} bindings differ from phase 6's")
    if launches.get("scan_full_ipa", 0) < len(AFF_BATCHES):
        raise AssertionError(f"12b: launches {launches}")
    n = sum(AFF_BATCHES[1:])
    log(f"phase 12b {name}: {len(run.bindings)} pods == phase 6's bindings; "
        f"feed {feed_s:.2f} s, build {run.build_s[0]:.3f} s; "
        f"{n / window_s:.1f} pods/s over the {len(AFF_BATCHES) - 1} measured "
        f"batches at max_pending 2, kernel {kernel_ms:.3f} ms by CUDA events "
        f"({kernel_ms / (window_s * 1e3):.1%} of the window); host stages "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in run.stages_ms().items())
        + f"; launches {launches} [{gpu}]")
    return {"cell": f"12b {name}", "pods_per_s": n / window_s,
            "stages_ms": run.stages_ms(),
            "window_ms": window_s * 1e3, "kernel_ms": kernel_ms,
            "kernel_share": kernel_ms / (window_s * 1e3),
            "build_s": run.build_s[0], "feed_s": feed_s,
            "launches": launches}


def phase_backend_churn(sk, gpu, world, nodes):
    """Phase 12c: phase 9's zone-spread events as cache events into 12a's
    depth-1 backend, queued as deltas (the cap KTPU_MAX_QUEUED_DELTAS);
    the next batch flushes them; its bindings and the carries after it
    equal those of a fresh backend fed the mutated cluster."""
    import random

    import numpy as np
    from kubernetes_tpu_torch.ops.scan import ScanSession
    from kubernetes_tpu_torch.testing.synth import synth_pending_pods

    cache, be, run = world
    sess = be._session
    if not isinstance(sess, ScanSession):
        raise AssertionError(f"12c: the live session is {type(sess).__name__}")
    placed = [p for p in cache.list_pods()
              if p.metadata.name.startswith("pending-")]
    events = churn_events({"enc": be.enc, "sess": sess, "pending": placed},
                          random.Random(9))
    before, lbefore = counters(), dict(sk.VARIANT_LAUNCHES)
    t0 = time.perf_counter()
    for kind, obj in events:
        if kind == "add":
            cache.add_pod(obj)
        elif kind == "remove":
            cache.remove_pod(obj)
        else:
            cache.update_node(obj)
    events_ms = (time.perf_counter() - t0) * 1e3
    queued = len(be._deltas)
    if be._session is not sess or queued != len(events):
        raise AssertionError(f"12c: {queued} of {len(events)} events queued "
                             f"(session kept: {be._session is sess})")
    flush = {}
    orig_flush = be._apply_session_deltas_locked

    def timed_flush():
        t = time.perf_counter()
        orig_flush()
        flush.setdefault("ms", (time.perf_counter() - t) * 1e3)

    be._apply_session_deltas_locked = timed_flush
    next_pods = synth_pending_pods(BATCH, spread=True)
    for i, p in enumerate(next_pods):
        p.metadata.name = f"next-{i}"
    live = BackendRun(cache, be)
    try:
        live.run([next_pods])
    finally:
        live.close()
    delta = counters_delta(before)
    launches = launched(sk, lbefore)
    assert_top_rung(be, delta, "12c")
    applies = sum(delta["session_delta_applies"].values())
    rebuilds = sum(delta["session_rebuilds"].values())
    if applies != len(events) or rebuilds or be._session is not sess:
        raise AssertionError(f"12c: {applies} deltas applied, {rebuilds} "
                             f"rebuilds {delta['session_rebuilds']}")
    if launches.get("scan_delta") != 1 or launches.get("scan_full") != 1:
        raise AssertionError(f"12c: launches {launches}")
    # a fresh backend fed the mutated cluster, nodes in the live lanes'
    # order
    cur_nodes, bound = cache.dump()
    by_name = {n.metadata.name: n for n in cur_nodes}
    mut_nodes = [by_name[n] for n in be.enc.node_names if n]
    bound = [p for p in bound if not p.metadata.name.startswith("next-")]
    t0 = time.perf_counter()
    fcache, fresh, _ = backend_world(mut_nodes, bound, next_pods)
    frun = BackendRun(fcache, fresh)
    try:
        frun.run([next_pods])
    finally:
        frun.close()
    fresh_s = time.perf_counter() - t0
    want = {k: v for k, v in frun.bindings.items()}
    got = {k: live.bindings[k] for k in want}
    if got != want:
        bad = sum(got[k] != want[k] for k in want)
        raise AssertionError(f"12c: {bad} of the next batch's bindings "
                             "differ from a fresh backend's")
    if list(fresh.enc.node_names[:fresh.enc.n_lanes]) != \
            list(be.enc.node_names[:be.enc.n_lanes]):
        raise AssertionError("12c: the fresh backend's lanes differ")
    a = unscaled(sess, sess._carry)
    b = unscaled(fresh._session, fresh._session._carry)
    diff = [k for k in b if not np.array_equal(a[k], b[k])]
    if diff:
        raise AssertionError(f"12c: carries {diff} differ from a fresh "
                             "backend's")
    log(f"phase 12c churn: {len(events)} cache events in {events_ms:.1f} ms, "
        f"all {queued} queued as deltas (cap {be.max_queued_deltas}); the "
        f"next {BATCH}-pod batch flushed them ({applies:.0f} delta applies, "
        f"{rebuilds:.0f} rebuilds, one scan_delta launch; flush "
        f"{flush.get('ms', 0.0):.3f} ms) and bound as a fresh backend fed "
        f"the mutated cluster (built and run in {fresh_s:.2f} s); carries "
        f"after it equal (unscaled, valid lanes) [{gpu}]")
    return {"cell": "12c churn", "events": len(events),
            "events_ms": events_ms, "deltas_applied": applies,
            "rebuilds": rebuilds, "flush_ms": flush.get("ms"),
            "fresh_s": fresh_s, "launches": launches}


def phase_backend_host_ports(sk, gpu):
    """Phase 12d: 11c's pods (cut to BACKEND_HOST_PODS) through the backend
    on the card and on the CPU: a HoistedSession (reason host-ports) on
    both, equal bindings, 0 device faults."""
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.testing.synth import (
        synth_cluster,
        synth_pending_pods,
    )

    nodes, init_pods = synth_cluster(5000, pods_per_node=2)
    pending = synth_pending_pods(BACKEND_HOST_PODS, spread=True)
    for i, p in enumerate(pending):
        if i % 4 == 1:
            p.spec.containers[0].ports = [v1.ContainerPort(
                host_port=HOST_PORT, container_port=HOST_PORT)]
    out = {"cell": "12d host ports", "pods": len(pending)}
    bindings = {}
    for device in ("cuda", "cpu"):
        cache, be, _ = backend_world(nodes, init_pods, pending,
                                     device=device)
        before = counters()
        run = BackendRun(cache, be)
        try:
            window_s = run.run([pending])
        finally:
            run.close()
        delta = counters_delta(before)
        builds = delta["session_builds"]
        # the CPU backend's top rung is the hoisted session itself
        reason = "host-ports" if device == "cuda" else "platform is not cuda"
        if builds != {("hoisted", reason, ""): 1.0} \
                or delta["device_faults"]:
            raise AssertionError(f"12d {device}: builds {builds}, faults "
                                 f"{delta['device_faults']}")
        bindings[device] = run.bindings
        out[f"{device}_ms_per_pod"] = window_s * 1e3 / len(pending)
    if bindings["cuda"] != bindings["cpu"]:
        raise AssertionError("12d: the card's backend binds otherwise than "
                             "the CPU's")
    ported = [bindings["cuda"][p.metadata.name] for i, p in enumerate(pending)
              if i % 4 == 1 and bindings["cuda"][p.metadata.name]]
    if len(ported) != len(set(ported)):
        raise AssertionError("12d: two pods share a (node, port)")
    log(f"phase 12d host ports: {len(pending)} pods through the backend, "
        f"HoistedSession (reason host-ports) on cuda and on cpu, equal "
        f"bindings, {len(ported)} hostPort pods on distinct nodes, 0 device "
        f"faults; {out['cuda_ms_per_pod']:.3f} ms per pod on the card, "
        f"{out['cpu_ms_per_pod']:.3f} on the CPU [{gpu}]")
    return out


def phase_backend_faults(sk, gpu, zone, nodes, init_pods):
    """Phase 12e: 12a's pods through a backend with a FaultInjector: a NaN
    harvest on one pipelined batch (re-driven on the kernel), then a
    dispatch raise on another that persists through the retries (three
    consecutive faults demote the ladder; the batch re-drives on the
    hoisted rung); the probe (KTPU_PROBE_INTERVAL short) re-promotes the
    ladder within the run, and the next batches run on the kernel again.
    Every binding equals 12a's (phase 4's)."""
    from kubernetes_tpu_torch.ops.scan import ScanSession
    from kubernetes_tpu_torch.scheduler.degradation import RUNG_KERNEL
    from kubernetes_tpu_torch.testing.faults import FaultInjector

    pending = [p for b in zone_batches() for p in b]
    os.environ["KTPU_PROBE_INTERVAL"] = "0.05"
    try:
        cache, be, _ = backend_world(nodes, init_pods, pending)
    finally:
        del os.environ["KTPU_PROBE_INTERVAL"]
    inj = FaultInjector()
    be.faults = inj
    be.retry_base = 0.0  # the demoted re-drive starts before any probe
    s = DRILL_SMALL
    parts = [pending[:BATCH], pending[BATCH:BATCH + s],
             pending[BATCH + s:BATCH + 2 * s],
             pending[BATCH + 2 * s:2 * BATCH], pending[2 * BATCH:]]
    before, lbefore = counters(), dict(sk.VARIANT_LAUNCHES)
    run = BackendRun(cache, be)
    t0 = time.perf_counter()
    try:
        run.run(parts[:1])
        inj.arm("nan-harvest", shots=1)
        run.run(parts[1:2])
        if be.ladder.rung() != RUNG_KERNEL:
            raise AssertionError("12e: a NaN harvest demoted the ladder")
        inj.arm("raise-dispatch", shots=3, min_rung=RUNG_KERNEL)
        run.run(parts[2:3])
        demoted = be.ladder.demotions
        deadline = time.monotonic() + 30
        while be.ladder.rung() != RUNG_KERNEL and time.monotonic() < deadline:
            time.sleep(0.01)
        promoted_s = time.perf_counter() - t0
        if be.ladder.rung() != RUNG_KERNEL:
            raise AssertionError("12e: the probe did not re-promote")
        lk = dict(sk.VARIANT_LAUNCHES)
        run.run(parts[3:])
        on_kernel = isinstance(be._session, ScanSession) and \
            sk.VARIANT_LAUNCHES["scan_full"] > lk["scan_full"]
    finally:
        run.close()
        be.close()
    delta = counters_delta(before)
    faults = delta["device_faults"]
    builds = delta["session_builds"]
    if not demoted or not on_kernel or faults.get(("invalid",), 0) < 1 \
            or faults.get(("raise",), 0) < 3 \
            or ("hoisted", "ladder-demoted", "") not in builds:
        raise AssertionError(f"12e: demotions {demoted}, back on the kernel "
                             f"{on_kernel}, faults {faults}")
    if run.bindings != zone["bindings"]:
        bad = sum(run.bindings.get(k) != v for k, v in zone["bindings"].items())
        raise AssertionError(f"12e: {bad} bindings differ from 12a's")
    log(f"phase 12e fault drill: NaN harvest -> re-driven on the kernel; "
        f"dispatch raise x3 -> demoted to hoisted, re-driven there; the "
        f"probe re-promoted to kernel {promoted_s:.2f} s into the drill, and "
        f"the next batches ran on the kernel; all {len(run.bindings)} "
        f"bindings == 12a's; faults {faults}; builds {builds}; injected "
        f"{inj.injected} [{gpu}]")
    return {"cell": "12e fault drill", "faults": {k[0]: v for k, v in
                                                   faults.items()},
            "demotions": demoted, "promotions": be.ladder.promotions,
            "promoted_s": promoted_s,
            "builds": {"/".join(k[:2]): v for k, v in builds.items()},
            "launches": launched(sk, lbefore)}


def phase_backend(sk, gpu, zone, pref):
    """Phase 12: the backend on the card. Returns (numbers, launches per
    kernel variant over 12a-12c plus 12e)."""
    from kubernetes_tpu_torch.testing.synth import synth_cluster

    nodes, init_pods = synth_cluster(5000, pods_per_node=2)
    out = {}
    total = dict.fromkeys(sk.VARIANT_LAUNCHES, 0)
    out["12a"], world, launches = phase_backend_zone(sk, gpu, zone, nodes,
                                                     init_pods)
    out["12a"]["warm"] = warm_compare(gpu)
    out["12b"] = phase_backend_affinity(sk, gpu, pref)
    out["12c"] = phase_backend_churn(sk, gpu, world, nodes)
    out["12d"] = phase_backend_host_ports(sk, gpu)
    out["12e"] = phase_backend_faults(sk, gpu, zone, nodes, init_pods)
    for got in (*launches, out["12b"]["launches"],
                out["12c"]["launches"], out["12e"]["launches"]):
        for k, v in got.items():
            total[k] += v
    return out, total


# -- phase 13: the scheduler loop -------------------------------------------

# scripts/bench_configs.py's "basic" and "default5000" rows
LOOP_BASIC = dict(name="SchedulingBasic-500", num_nodes=500,
                  num_init_pods=1000, num_pods=1000, max_batch=1024)
LOOP_DEFAULT = dict(name="Default-5000n-10k", num_nodes=5000,
                    num_init_pods=6144, num_pods=10000, max_batch=2048,
                    timeout=900.0, spread=True)
TRACED_PODS = 2048               # 13d's init and measured pods (cut)
DRILL_BATCH = 64                 # phase 13c's max_batch
DRILL_WAVES = (512, 488)         # 13c's measured pods: faulted wave, then clean


class LoopRun:
    """One `run_workload` call watched from outside: the harness's APIServer is captured (to list the
    bindings), every batch the loop hands to `TPUBackend.dispatch_many`
    is recorded in order (a copy of each pod, pending as dispatched), and
    on the card each `scan_full` launch of the backend is bracketed with
    CUDA events on the backend's stream, tagged "measured" (a batch of
    measure-* pods), "init" (another loop batch) or "other" (launched
    outside dispatch_many: the harness's kernel-direct rate). Each batch's
    rung is kept too (the session class it rode and the ladder's mode), and
    the pods the loop scheduled pod by pod through the framework (the
    oracle path) are counted. With `gang`, a GangIntegrityChecker watches
    the run's pods through an informer of its own."""

    def __init__(self, cuda: bool, gang: bool = False):
        import copy

        import torch
        from kubernetes_tpu_torch.ops import scan as scan_mod
        from kubernetes_tpu_torch.perf import harness
        from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
        from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend

        self.apis, self.batches, self.events, self.backends = [], [], [], []
        self.rungs, self.oracle_pods = [], 0
        self.gang_checker, self._factories = None, []
        self._restore = []
        self._tag = "other"
        run = self

        class CapturedAPIServer(harness.APIServer):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                run.apis.append(self)
                if gang:
                    run._watch_gangs(self)

        orig_dispatch = TPUBackend.dispatch_many
        orig_oracle = Scheduler._schedule_one_oracle

        def schedule_one_oracle(sched, info):
            run.oracle_pods += 1
            return orig_oracle(sched, info)

        def dispatch_many(be, pods):
            if be not in run.backends:
                run.backends.append(be)
            batch = []
            for p in pods:
                q = copy.copy(p)
                q.spec = copy.copy(p.spec)
                batch.append(q)
            run.batches.append(batch)
            run._tag = "measured" if any(
                p.metadata.name.startswith("measure-") for p in pods) \
                else "init"
            try:
                return orig_dispatch(be, pods)
            finally:
                run._tag = "other"
                session = be._session
                run.rungs.append((len(pods), type(session).__name__
                                  if session is not None else "no session",
                                  be.ladder.mode()))

        orig_scan = scan_mod.scan_full

        def scan_full(*args, **kwargs):
            if not cuda:
                return orig_scan(*args, **kwargs)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig_scan(*args, **kwargs)
            e1.record()
            run.events.append((run._tag, e0, e1))
            return out

        for obj, name, new in ((harness, "APIServer", CapturedAPIServer),
                               (TPUBackend, "dispatch_many", dispatch_many),
                               (Scheduler, "_schedule_one_oracle",
                                schedule_one_oracle),
                               (scan_mod, "scan_full", scan_full)):
            self._restore.append((obj, name, getattr(obj, name)))
            setattr(obj, name, new)

    def _watch_gangs(self, api):
        from kubernetes_tpu_torch.client import (
            Clientset,
            SharedInformerFactory,
        )
        from kubernetes_tpu_torch.testing.faults import GangIntegrityChecker

        factory = SharedInformerFactory(Clientset(api))
        self.gang_checker = GangIntegrityChecker().attach(factory.pods())
        factory.start()
        self._factories.append(factory)

    def rung_summary(self):
        """{"session class / ladder mode": [batches, pods]} over the run."""
        out = {}
        for n, kind, mode in self.rungs:
            b = out.setdefault(f"{kind}/{mode}", [0, 0])
            b[0] += 1
            b[1] += n
        return out

    def close(self):
        for obj, name, orig in reversed(self._restore):
            setattr(obj, name, orig)
        for factory in self._factories:
            factory.stop()

    def kernel_ms(self, tags=("init", "measured")):
        import torch

        if self.events:
            torch.cuda.synchronize()
        return [a.elapsed_time(b) for t, a, b in self.events if t in tags]

    def bindings(self):
        from kubernetes_tpu_torch.client import Clientset

        pods, _ = Clientset(self.apis[-1]).pods.list(namespace="default")
        return {p.metadata.name: p.spec.node_name for p in pods}


def loop_workload(spec, **extra):
    """The harness's Workload for a LOOP_* row (`spread`: a zone
    ScheduleAnyway spread on the init and measured templates)."""
    from kubernetes_tpu_torch.perf.harness import PodTemplate, Workload

    kw = dict(spec)
    if kw.pop("spread", False):
        kw["init_template"] = PodTemplate(spread_zone=True)
        kw["template"] = PodTemplate(spread_zone=True)
    kw.update(extra)
    return Workload(**kw)


def loop_cell(sk, gpu, label, w, device="cuda", trace=False):
    """`run_workload(w, device=device)` under a LoopRun (with `trace`, the
    flight recorder on at level 1 for the call, so that the harness
    returns its per-stage span summary). Checks what holds for every
    cell: every measured pod bound unless the workload is saturating
    (then some), every pod bound to one node, no node over its
    allocatable, and on the card the ladder on its top rung with 0 device
    faults (a session the kernel refuses is not a fault: the rung each
    batch rode and the reasons of every session build are printed).
    Returns the cell's printed numbers (the launches per kernel variant in
    the call: counts set to 0 just before it, read just after), the
    bindings, the LoopRun, and the run's pods and nodes."""
    from kubernetes_tpu_torch.client import Clientset
    from kubernetes_tpu_torch.ops import whatif_kernel as wk
    from kubernetes_tpu_torch.perf.harness import run_workload
    from kubernetes_tpu_torch.utils import tracing

    cuda = device == "cuda"
    before = counters()
    if cuda:
        reset_counts(sk)
        wk.LAUNCHES = 0
    run = LoopRun(cuda, gang=w.gang_size > 1)
    level = tracing.set_level(1) if trace else None
    t0 = time.perf_counter()
    try:
        r = run_workload(w, device=device)
        wall_s = time.perf_counter() - t0
        cs = Clientset(run.apis[-1])
        pods, _ = cs.pods.list(namespace="default")
        nodes, _ = cs.nodes.list()
        gang = run.gang_checker
        if gang is not None:
            deadline = time.monotonic() + MATRIX_STALL_GRACE
            while gang.partial_gangs() and time.monotonic() < deadline:
                time.sleep(0.1)
            gang = {"partial": len(gang.partial_gangs()),
                    "violations": list(gang.violations)}
    finally:
        run.close()
        if trace:
            tracing.set_level(level)
    launches = {k: v for k, v in sk.VARIANT_LAUNCHES.items() if v} \
        if cuda else {}
    if cuda and wk.LAUNCHES:
        launches["whatif"] = wk.LAUNCHES
    cluster = {k: v for k, v in sk.CLUSTER_LAUNCHES.items() if v} \
        if cuda else {}
    delta = counters_delta(before)
    # session builds in this call, by kind and by kind / reason (the
    # harness's session_build_reasons counts the process's)
    builds, reasons = {}, {}
    for k, v in delta["session_builds"].items():
        builds[k[0]] = builds.get(k[0], 0) + int(v)
        slug = f"{k[0]}/{k[1] or '-'}"
        reasons[slug] = reasons.get(slug, 0) + int(v)
    measured_ms = run.kernel_ms(("measured",))
    loop_ms = run.kernel_ms()
    window_ms = r.duration_s * 1e3
    bindings = {p.metadata.name: p.spec.node_name for p in pods}
    out = {
        "cell": label, "row": w.name, "device": device,
        "nodes": w.num_nodes, "init": w.num_init_pods, "pods": w.num_pods,
        "max_batch": w.max_batch, "pods_per_s": r.throughput_avg,
        "pods_per_s_p50": r.throughput_p50,
        "pods_per_s_p90": r.throughput_p90,
        "attempts_per_s": r.attempts_per_sec,
        "latency_p50_s": r.pod_scheduling_p50,
        "latency_p99_s": r.pod_scheduling_p99, "attempts": r.attempts,
        "bound": r.num_bound, "window_s": r.duration_s, "wall_s": wall_s,
        "session_kind": r.session_kind, "session_builds": builds,
        "session_build_reasons": reasons,
        "session_rebuild_reasons": r.session_rebuild_reasons,
        "rungs": run.rung_summary(), "oracle_pods": run.oracle_pods,
        "batches": len(run.batches), "launches": launches,
        "cluster_launches": cluster,
        "planner_paths": r.preemption_planner_paths,
        "whatif_launches": r.whatif_launches,
        "whatif_fallbacks": r.whatif_fallbacks,
        "kernel_ms_per_batch": (statistics.mean(measured_ms)
                                if measured_ms else None),
        "kernel_ms_measured": sum(measured_ms),
        "kernel_ms_loop": sum(loop_ms),
        "kernel_share": (sum(measured_ms) / window_ms
                         if measured_ms and window_ms else None),
        "kernel_direct_pods_per_s": r.kernel_direct_pods_per_sec,
        "loop_kernel_ratio": r.loop_kernel_ratio,
    }
    if trace:
        out["stage_latency"] = r.stage_latency
        out["stage_window_s"] = r.stage_window_s
    if w.gang_size > 1:
        out.update(gang_admitted=r.gang_admitted,
                   gang_rejected=r.gang_rejected,
                   gang_rollbacks=r.gang_rollbacks,
                   gang_admission_p50_s=r.gang_admission_p50,
                   gang_admission_p99_s=r.gang_admission_p99, gang=gang)
    over = overcommitted(pods, nodes)
    unbound = sum(1 for v in bindings.values() if not v)
    if over or len(bindings) != w.num_init_pods + w.num_pods:
        raise AssertionError(f"{label} on {device}: nodes over their "
                             f"allocatable {over[:5]}, {len(bindings)} pods")
    if w.saturating:
        if not 0 < r.num_bound < w.num_pods:
            raise AssertionError(f"{label} on {device}: {r.num_bound} of "
                                 f"{w.num_pods} bound in a saturating row")
    elif r.num_bound != w.num_pods or unbound:
        raise AssertionError(f"{label} on {device}: {r.num_bound} of "
                             f"{w.num_pods} measured pods bound, {unbound} "
                             "pods unbound")
    if cuda:
        be = run.backends[-1]
        if be.ladder.rung() != be.ladder.top or be.ladder.demotions \
                or delta["device_faults"]:
            raise AssertionError(f"{label}: ladder {be.ladder.mode()}, "
                                 f"{be.ladder.demotions} demotions, faults "
                                 f"{delta['device_faults']}")
    log(f"phase {label} {w.name} on {device}: {r.num_bound} of "
        f"{w.num_pods} measured pods bound (+{w.num_init_pods} init) over "
        f"{w.num_nodes} nodes, no node over its allocatable; "
        f"{r.throughput_avg} pods/s (p50 {r.throughput_p50}, p90 "
        f"{r.throughput_p90}), {r.attempts_per_sec} attempts/s; pod "
        f"scheduling latency p50 {r.pod_scheduling_p50} s, p99 "
        f"{r.pod_scheduling_p99} s; window {r.duration_s} s, wall "
        f"{wall_s:.2f} s; session {r.session_kind}, builds in the call "
        f"{reasons}, rebuilds {r.session_rebuild_reasons}; rungs (batches, "
        f"pods) {out['rungs']}, {run.oracle_pods} pods on the oracle path; "
        f"launches {launches} (cluster sizes {cluster}); planner paths "
        f"{r.preemption_planner_paths}, what-if launches "
        f"{r.whatif_launches}, fallbacks {r.whatif_fallbacks}; kernel "
        + (f"{out['kernel_ms_per_batch']:.3f} ms per measured batch by CUDA "
           f"events, {out['kernel_share']:.1%} of the window"
           if measured_ms else "not timed (no CUDA events on the CPU)")
        + (f"; kernel-direct {r.kernel_direct_pods_per_sec} pods/s, "
           f"loop_kernel_ratio {r.loop_kernel_ratio}"
           if w.kernel_direct else "")
        + ("; stages (count, total ms): " + ", ".join(
            f"{k} {int(v['count'])} {v['total_s'] * 1e3:.1f}"
            for k, v in sorted((r.stage_latency or {}).items()))
           + f" over {r.stage_window_s} s of spans" if trace else "")
        + (f"; gangs admitted {r.gang_admitted}, rejected "
           f"{r.gang_rejected}, rollbacks {r.gang_rollbacks}, admission "
           f"p50 {r.gang_admission_p50} s p99 {r.gang_admission_p99} s, "
           f"checker {gang}" if w.gang_size > 1 else "")
        + f" [{gpu}]")
    return out, bindings, run, pods, nodes


def kernel_cell(label, out):
    """Phase 13's cells ride the kernel session and launch `scan_full`."""
    if out["device"] == "cuda" and (out["session_kind"] != "ScanSession"
                                    or not out["launches"].get("scan_full")):
        raise AssertionError(f"{label}: session {out['session_kind']}, "
                             f"launches {out['launches']}")


def replay_bindings(batches, nodes, device="cuda", volumes=None, bound=(),
                    weights=None):
    """The loop's batches, in the order it dispatched them, through a fresh
    TPUBackend's `schedule_many` fed the same nodes (and the pods `bound`
    to them before the first batch) through a SchedulerCache; each batch's
    placements assumed back into the cache (the loop's assume), as phase
    12 does. `volumes`: the run's (PVCs, PVs, CSINodes), read by the
    backend's volume resolver as the loop's informers feed it; `weights`:
    the loop backend's score weights (its profile's)."""
    from kubernetes_tpu_torch.scheduler.internal.cache import SchedulerCache
    from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend
    from kubernetes_tpu_torch.scheduler.volume_device import (
        VolumeDeviceResolver,
    )

    be = TPUBackend(device=device, weights=weights)
    if volumes is not None:
        pvcs, pvs, csinodes = volumes
        be.set_volume_resolver(VolumeDeviceResolver(
            lambda: pvcs, lambda: pvs, lambda: csinodes))
    be.enc.reserve(pods=int((sum(len(b) for b in batches) + len(bound))
                            * 1.25))
    cache = SchedulerCache()
    cache.add_listener(be)
    for node in nodes:
        cache.add_node(node)
    for pod in bound:
        cache.add_pod(pod)
    out = {}
    try:
        for batch in batches:
            placed = []
            for pod, node in be.schedule_many(batch):
                out[pod.metadata.name] = node
                if node:
                    placed.append(assumed(pod, node))
            cache.assume_pods(placed)
    finally:
        be.close()
    return out


def loop_drill(device, num_nodes=500, num_init=1000, waves=DRILL_WAVES,
               max_batch=DRILL_BATCH, use_kernel=None):
    """Phase 13c (and, small and on the CPU, tests/test_torch_loop.py):
    the degradation ladder through the live scheduler loop. The harness's
    cluster (nodes as run_workload makes them) through the port's
    APIServer, informers and Scheduler(max_batch) on
    TPUBackend(device); init pods bound on the top rung; then the first
    wave of measured pods with a FaultInjector that makes every dispatch
    raise from the wave's second batch on: the retries demote the ladder
    to hoisted, then to oracle, where the framework's plugin chain
    schedules pod by pod; once the oracle has scheduled a batch's worth,
    the faulted batch's pods among them, the fault is disarmed and the
    probe re-promotes the ladder rung by rung. The second wave runs on the
    top rung again; before its second batch a pod bound straight to
    node-7 by another actor is created through the apiserver, and the
    cache listener queues it into the live session as a delta. Returns
    the drill's numbers; raises if a pod binds twice, stays unbound, or a
    node holds more than its allocatable."""
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.apiserver import APIServer
    from kubernetes_tpu_torch.client import Clientset, SharedInformerFactory
    from kubernetes_tpu_torch.ops.scan import ScanSession
    from kubernetes_tpu_torch.perf.harness import PodTemplate
    from kubernetes_tpu_torch.scheduler import metrics
    from kubernetes_tpu_torch.scheduler.degradation import RUNG_ORACLE
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
    from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend
    from kubernetes_tpu_torch.testing.faults import (
        BindIntegrityChecker,
        FaultInjector,
    )
    from kubernetes_tpu_torch.testing.synth import make_node, make_pod

    api = APIServer()
    cs = Clientset(api)
    for i in range(num_nodes):
        cs.nodes.create(make_node(f"node-{i}", labels={
            v1.LABEL_HOSTNAME: f"node-{i}", v1.LABEL_ZONE: f"zone-{i % 3}",
            v1.LABEL_REGION: f"region-{i % 3 % 2}"}))
    factory = SharedInformerFactory(cs)
    be = TPUBackend(device=device, use_kernel=use_kernel)
    sched = Scheduler(cs, factory, backend="tpu", max_batch=max_batch,
                      tpu_backend=be)
    total = num_init + sum(waves)
    be.enc.reserve(pods=int((total + 1) * 1.25))
    be.retry_base = 0.0
    ladder = be.ladder
    ladder._probe_interval = ladder._probe_delay = 0.05
    ladder._probe_max = 0.2
    inj = FaultInjector()
    sched.install_fault_injector(inj)
    checker = BindIntegrityChecker().attach(factory.pods())
    drill = {"wave": "init", "batches": 0, "faulted": set(), "oracle": [],
             "foreign": False, "rung_at_foreign": None}
    orig_dispatch = be.dispatch_many
    orig_oracle = sched._schedule_one_oracle

    def dispatch(pods):
        drill["batches"] += 1
        if drill["wave"] == "a" and not drill["faulted"] \
                and drill["batches"] == 2:
            inj.arm("raise-dispatch", shots=-1)
            drill["faulted"] = {p.metadata.name for p in pods}
            drill["t_fault"] = time.perf_counter()
        if drill["wave"] == "b" and not drill["foreign"] \
                and isinstance(be._session, ScanSession):
            drill["foreign"] = True
            drill["rung_at_foreign"] = ladder.mode()
            drill["deltas0"] = sum(v for _, v in
                                   metrics.session_delta_applies.items())
            # the harness pods' requests and label: a new label value
            # would grow the encoding's vocabulary, and requests off the
            # kernel session's GCD scale leave its delta envelope (either
            # is a rebuild)
            cs.pods.create(make_pod("foreign", cpu=tmpl.cpu,
                                    memory=tmpl.memory, node_name="node-7",
                                    labels=dict(tmpl.labels)))
            deadline = time.monotonic() + 30
            while not sched.cache.has_pod("default/foreign") \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
        return orig_dispatch(pods)

    def oracle(info):
        if ladder.rung() == RUNG_ORACLE:
            drill["oracle"].append(info.pod.metadata.name)
            if len(drill["oracle"]) >= max_batch and inj.armed(
                    "raise-dispatch") and drill["faulted"] <= set(
                        drill["oracle"]):
                inj.disarm("raise-dispatch")
                drill["t_disarm"] = time.perf_counter()
        return orig_oracle(info)

    be.dispatch_many = dispatch
    sched._schedule_one_oracle = oracle
    tmpl = PodTemplate()

    def stage(prefix, n, timeout=300.0):
        sched.pause()
        time.sleep(0.3)
        bound0 = len(sched.bind_timestamps)
        for i in range(n):
            cs.pods.create(tmpl.build(f"{prefix}-{i}"))
        deadline = time.monotonic() + 60
        while sched.queue.num_active() < n and time.monotonic() < deadline:
            time.sleep(0.02)
        t0 = time.perf_counter()
        sched.resume()
        deadline = time.monotonic() + timeout
        while len(sched.bind_timestamps) - bound0 < n:
            if time.monotonic() > deadline:
                raise AssertionError(f"13c: wave {prefix} did not bind "
                                     f"({len(sched.bind_timestamps) - bound0}"
                                     f" of {n})")
            time.sleep(0.01)
        return time.perf_counter() - t0

    t_start = time.perf_counter()
    try:
        factory.start()
        if not factory.wait_for_cache_sync(timeout=180.0):
            raise AssertionError("13c: informer sync failed")
        sched.start()
        init_s = stage("init", num_init)
        drill["wave"], drill["batches"] = "a", 0
        wave_a_s = stage("measure-a", waves[0])
        deadline = time.monotonic() + 60
        while ladder.rung() != ladder.top and time.monotonic() < deadline:
            time.sleep(0.01)
        repromoted_s = time.perf_counter() - drill.get("t_disarm", 0.0)
        if ladder.rung() != ladder.top:
            raise AssertionError(f"13c: the probe did not re-promote "
                                 f"({ladder.mode()})")
        drill["wave"] = "b"
        wave_b_s = stage("measure-b", waves[1])
        sched.pause()
        sched._drain_pipeline(timeout=30.0)
        deltas = sum(v for _, v in metrics.session_delta_applies.items()) \
            - drill.get("deltas0", 0)
    finally:
        sched.shutdown()
        factory.stop()
    pods, _ = cs.pods.list(namespace="default")
    nodes, _ = cs.nodes.list()
    unbound = [p.metadata.name for p in pods if not p.spec.node_name]
    over = overcommitted(pods, nodes)
    binds = len(sched.bind_timestamps)
    out = {
        "cell": "13c ladder drill", "device": device, "nodes": num_nodes,
        "pods": total, "max_batch": max_batch, "binds": binds,
        "unbound": len(unbound), "overcommitted_nodes": over,
        "bind_violations": list(checker.violations),
        "faulted_batch": len(drill["faulted"]),
        "oracle_pods": len(drill["oracle"]),
        "faulted_on_oracle": drill["faulted"] <= set(drill["oracle"]),
        "demotions": ladder.demotions, "promotions": ladder.promotions,
        "rung_at_end": ladder.mode(), "rung_at_foreign": drill[
            "rung_at_foreign"], "foreign": drill["foreign"],
        "delta_applies": deltas, "injected": dict(inj.injected),
        "init_s": init_s, "wave_a_s": wave_a_s, "wave_b_s": wave_b_s,
        "repromoted_s": repromoted_s,
        "wall_s": time.perf_counter() - t_start,
    }
    if unbound or binds != total or over or checker.violations \
            or not out["faulted_on_oracle"] or ladder.demotions < 2 \
            or ladder.promotions < 2 or ladder.rung() != ladder.top \
            or not drill["foreign"] or deltas < 1:
        raise AssertionError(f"13c: {out}")
    return out


def phase_loop(sk, gpu):
    """Phase 13: the scheduler loop on the card through its entry points.
    Returns (numbers, launches per kernel variant over the phase, 13a's and
    13b's bindings on the card with their numbers, for phase 15c)."""
    from kubernetes_tpu_torch.client import Clientset

    total = dict.fromkeys(sk.VARIANT_LAUNCHES, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    out = {}
    t0 = time.perf_counter()
    # 13a: SchedulingBasic-500 on the card, then on the CPU
    w = loop_workload(LOOP_BASIC, kernel_direct=True)
    a, card, _, _, _ = loop_cell(sk, gpu, "13a", w)
    kernel_cell("13a", a)
    add(a["launches"])
    cpu, cpu_bind, _, _, _ = loop_cell(sk, gpu, "13a",
                                       loop_workload(LOOP_BASIC),
                                       device="cpu")
    if card != cpu_bind:
        bad = sum(card.get(k) != v for k, v in cpu_bind.items())
        raise AssertionError(f"13a: {bad} of {len(card)} bindings differ "
                             "between the card and the CPU")
    a["cpu"] = {k: cpu[k] for k in ("pods_per_s", "latency_p50_s",
                                    "latency_p99_s", "window_s", "wall_s",
                                    "session_kind")}
    log(f"phase 13a: all {len(card)} bindings equal on the card and on the "
        f"CPU [{gpu}]")
    out["13a"] = a
    # 13b: Default-5000n-10k; the bindings against a schedule_many replay
    w = loop_workload(LOOP_DEFAULT, kernel_direct=True)
    b, bind_b, run_b, _, _ = loop_cell(sk, gpu, "13b", w)
    kernel_cell("13b", b)
    add(b["launches"])
    if b["launches"].get("scan_full") != b["cluster_launches"].get(
            sk.CLUSTER) or len(b["cluster_launches"]) != 1:
        raise AssertionError(f"13b: scan_full launches {b['launches']} not "
                             f"all on the {sk.CLUSTER}-block cluster "
                             f"({b['cluster_launches']})")
    if not b["loop_kernel_ratio"] > 0:
        raise AssertionError("13b: loop_kernel_ratio 0 (the kernel-direct "
                             "measurement failed)")
    t1 = time.perf_counter()
    nodes, _ = Clientset(run_b.apis[-1]).nodes.list()
    batches = run_b.batches
    replay = replay_bindings(batches, nodes)
    b["replay_s"] = time.perf_counter() - t1
    diff = sorted(k for k in bind_b if replay.get(k) != bind_b[k])
    b["replay_differs"] = len(diff)
    if diff:
        raise AssertionError(f"13b: {len(diff)} of {len(bind_b)} loop "
                             f"bindings differ from the schedule_many "
                             f"replay, first {diff[:5]}")
    log(f"phase 13b: all {len(bind_b)} loop bindings equal a fresh "
        f"backend's schedule_many replay of the loop's {len(batches)} "
        f"batches ({b['replay_s']:.2f} s) [{gpu}]")
    out["13b"] = b
    # 13d: 13b with the flight recorder on, for its stage split, at
    # TRACED_PODS measured pods (the 900 s budget)
    d, _, _, _, _ = loop_cell(sk, gpu, "13d", loop_workload(
        LOOP_DEFAULT, num_init_pods=TRACED_PODS, num_pods=TRACED_PODS),
        trace=True)
    kernel_cell("13d", d)
    add(d["launches"])
    out["13d"] = d
    # 13c: the ladder drill through the loop
    reset_counts(sk)
    c = loop_drill("cuda")
    c["launches"] = {k: v for k, v in sk.VARIANT_LAUNCHES.items() if v}
    add(c["launches"])
    if not c["launches"].get("scan_delta") or not c["launches"].get(
            "scan_full"):
        raise AssertionError(f"13c: launches {c['launches']}")
    log(f"phase 13c ladder drill: {c['pods']} pods over {c['nodes']} nodes "
        f"at max_batch {c['max_batch']}, each bound once ({c['binds']} binds,"
        f" 0 rebinds, no node over its allocatable); a dispatch raise from "
        f"the first wave's 2nd batch on: {c['demotions']} demotions to "
        f"oracle, the framework scheduled {c['oracle_pods']} pods "
        f"(the faulted batch's {c['faulted_batch']} among them); the probe "
        f"re-promoted to {c['rung_at_end']} {c['repromoted_s']:.2f} s after "
        f"the fault was disarmed ({c['promotions']} promotions); a foreign "
        f"pod bound mid-run reached the live session on the "
        f"{c['rung_at_foreign']} rung ({c['delta_applies']} delta applies); "
        f"launches {c['launches']}; wall {c['wall_s']:.2f} s [{gpu}]")
    out["13c"] = c
    out["phase_s"] = time.perf_counter() - t0
    keep = ("pods_per_s", "latency_p50_s", "latency_p99_s", "window_s")
    return out, total, {"13a": card, "13b": bind_b,
                        "13a_numbers": {k: a[k] for k in keep},
                        "13b_numbers": {k: b[k] for k in keep}}


# phase 14: the preemption rows of scripts/bench_configs.py (:131-137,
# :229-237, :245-255), at their own sizes but for their preemptors (500,
# cut: the whole script has to end within 900 s)
PREEMPTORS = 256
PREEMPTION_ROWS = (
    ("14a", dict(name="Preemption-500n-500hi", num_nodes=500,
                 num_init_pods=2000, num_pods=PREEMPTORS, max_batch=512,
                 timeout=900.0, stall_stop=30.0), {}, {}),
    ("14b", dict(name="Preemption-PDB-500n-500hi", num_nodes=500,
                 num_init_pods=2000, num_pods=PREEMPTORS, max_batch=512,
                 timeout=900.0, stall_stop=30.0,
                 pdb_disruptions_allowed=2000),
     {"labels": {"app": "victim"}}, {}),
    ("14c", dict(name="Preemption-IPA-500n-500hi", num_nodes=500,
                 num_init_pods=2000, num_pods=PREEMPTORS, max_batch=512,
                 timeout=900.0, stall_stop=30.0),
     {"labels": {"app": "victim"}},
     {"pod_affinity_zone": True, "labels": {"app": "victim"}}),
)
# 14d: scripts/probe_preemption.py's sweep (nodes x victims per node)
WHATIF_POINTS = ("50x2", "200x4", "500x4", "500x8")
WHATIF_AFF_POINTS = ("50x2", "200x4")
WHATIF_WAVE = 8
WHATIF_REPS = 3
WHATIF_KEEP = 64                 # what-if launches kept per 14a-c cell
WHATIF_SOURCE = "kubernetes_tpu_torch/ops/csrc/whatif.cu"


class WhatifWatch:
    """ops.whatif's `whatif_device` and `whatif_context` wrapped for one
    phase: every what-if counted, the first `keep` calls of each kept with
    their inputs and outputs (None: all), so that each can be held to its
    plain version on the same inputs. A node-alloc delta may patch a live
    session's alloc rows in place after the call: the kept call keeps a
    copy of them."""

    def __init__(self, keep=None):
        from kubernetes_tpu_torch.ops import whatif as wi

        self.calls, self.contexts, self.n, self.keep = [], [], 0, keep
        self._mod = wi
        self._orig = run, context = wi.whatif_device, wi.whatif_context
        watch = self

        def kept(tab):
            return dict(tab, alloc=tab["alloc"].clone(),
                        allowed=tab["allowed"].clone())

        def device(tab, buf, d):
            out = run(tab, buf, d)
            watch.n += 1
            if watch.keep is None or len(watch.calls) < watch.keep:
                watch.calls.append(((kept(tab), buf, d), out))
            return out

        def ctx(tab, d):
            inv = context(tab, d)
            if watch.keep is None or len(watch.contexts) < watch.keep:
                watch.contexts.append(((kept(tab), d), inv))
            return inv

        wi.whatif_device, wi.whatif_context = device, ctx

    def close(self):
        self._mod.whatif_device, self._mod.whatif_context = self._orig


def walk_errs(calls, contexts=()):
    """Each kept what-if launch's output against `whatif_plain`, and each
    kept context launch's invariants against `context_reference`, on the
    same inputs on the card: the count of differing values."""
    import torch
    from kubernetes_tpu_torch.ops import whatif_kernel as wk

    torch.cuda.synchronize()
    err = 0
    for (tab, buf, d), out in calls:
        if out.device.type != "cuda":
            raise AssertionError("a what-if launch ran off the card")
        err += int((out != wk.whatif_plain(tab, buf, d)).sum())
    for (tab, d), inv in contexts:
        ref = wk.context_reference(tab, d)
        err += sum(int((inv[k] != ref[k]).sum()) for k in ref)
    return err


# the walk-only kernel's inputs (the design in which a torch prologue fed
# a walk kernel): the prologue's tensors, the victim slots, the nominated
# aggregates
WALK_PROLOGUE = ("free0", "cnt0", "allowed", "req", "chk", "gate", "pts_sh",
                 "pts_mn", "reg_at", "pts_chk", "self_m", "f_skew")
WALK_PROLOGUE_IPA = ("anti_eff", "anti_chk", "aff_eff", "aff_key_on",
                     "aff_valid", "aff_total", "aff_keys", "has_aff",
                     "aff_all_keys", "self_match_all")
class Reads:
    """The distinct elements of each tensor a launch reads or writes:
    `at` adds elements by index (broadcast), `whole` a whole tensor;
    `nbytes` counts each element once."""

    def __init__(self):
        self.lin, self.size, self.full = {}, {}, {}

    def at(self, name, t, *idx):
        import torch

        idx = torch.broadcast_tensors(*(
            torch.as_tensor(i, device=t.device).long() for i in idx))
        lin = sum(i * s for i, s in zip(idx, t.stride()))
        self.lin.setdefault(name, []).append(lin.reshape(-1))
        self.size[name] = t.element_size()

    def whole(self, name, t):
        self.full[name] = t.nbytes

    def nbytes(self):
        import torch

        return sum(self.full.values()) + sum(
            int(torch.unique(torch.cat(v)).numel()) * self.size[k]
            for k, v in self.lin.items() if k not in self.full)


def whatif_reads(tab, pk, d, p, out):
    """The bytes one what-if's walk launch reads and writes for this
    launch's dims and data, each element once (the kernel's own order):
    every lane reads gate0 and its slots' valid flags and writes its
    output row; a lane whose invariant gate is open reads its prologue
    (the pod-count word; the checked resource columns of alloc, requested
    and the claimed drain; with a valid spread constraint the key flags
    of the valid constraints and, at each checked one, its pair and the
    pair's shared count, claimed drain and registration, and the minimum
    structure; with the IPA terms the key flags of the valid anti terms
    and, at each checked one, its pair, count and claimed drain; the
    nominated pods' values only with nominated pods); a lane whose whole
    gate is open also reads the affinity terms (their key flags, pairs,
    counts and drains; the totals) and its L slots' rows at the checked
    words only."""
    import torch

    rd = Reads()
    dev = out.device
    has_nom, dyn_ipa, any_f = (bool(d[k]) for k in ("has_nom", "dyn_ipa",
                                                    "any_f"))
    g0, g = tab["gate0"], p["gate"]
    o0, o1 = g0.nonzero()[:, 0], g.nonzero()[:, 0]
    n0, n1 = o0[:, None], o1[:, None]
    ls = torch.arange(d["L"], device=dev)[None, :]
    nom = has_nom
    for k, t in (("gate0", g0), ("v_valid", pk["v_valid"]), ("out", out),
                 ("req_check", tab["req_check"]),
                 ("req_has_any", tab["req_has_any"])):
        rd.whole(k, t)
    ci = p["chk"].nonzero()[:, 0][None, :]
    rd.at("req", tab["req"], ci)
    for k, t in (("alloc", tab["alloc"]), ("requested", tab["requested"]),
                 ("pre_req", pk["pre_req"])) + (
            (("nom_req", pk["nom_req"]),) if nom else ()):
        rd.at(k, t, n0, ci)
    for k, t in (("pod_count", tab["pod_count"]), ("pre_cnt", pk["pre_cnt"]),
                 ("allowed", tab["allowed"])) + (
            (("nom_cnt", pk["nom_cnt"]),) if nom else ()):
        rd.at(k, t, o0)
    rd.at("v_req", pk["v_req"], n1[:, :, None], ls[:, :, None],
          ci[:, None, :])
    rd.at("v_cnt", pk["v_cnt"], n1, ls)
    if any_f:
        rd.whole("f_valid", tab["f_valid"])
        rd.at("f_key_on", tab["f_key_on"], n0,
              tab["f_valid"].nonzero()[:, 0][None, :])
        ni, cc = (p["pts_chk"] & g0[:, None]).nonzero(as_tuple=True)
        pair = tab["f_pair_cn"][ni, cc].long()
        rd.at("f_pair_cn", tab["f_pair_cn"], ni, cc)
        for k, t in (("shared0", tab["shared0"]),
                     ("pre_shared", pk["pre_shared"]),
                     ("f_reg_real", tab["f_reg_real"])):
            rd.at(k, t, cc, pair)
        for k in ("f_self_match", "f_skew"):
            rd.at(k, tab[k], cc)
        rd.at("mins", torch.empty((d["C"], 3), dtype=torch.int64,
                                  device=dev), cc[:, None],
              torch.arange(3, device=dev)[None, :])
        if nom:
            rd.at("nom_mfs", pk["nom_mfs"], ni, cc)
        ni, cc = (p["pts_chk"] & g[:, None]).nonzero(as_tuple=True)
        rd.at("v_mfs", pk["v_mfs"], ni[:, None], ls, cc[:, None])
    if dyn_ipa:
        rd.whole("anti_valid", tab["anti_valid"])
        rd.at("anti_key_on", tab["anti_key_on"], n0,
              tab["anti_valid"].nonzero()[:, 0][None, :])
        ni, tt = (p["anti_chk"] & g0[:, None]).nonzero(as_tuple=True)
        key = tab["anti_key"][tt].long()
        rd.at("anti_key", tab["anti_key"], tt)
        rd.at("pok", tab["pok"], ni, key)
        rd.at("anti0", tab["anti0"], ni, tt)
        rd.at("pre_anti", pk["pre_anti"], tt, tab["pok"][ni, key].long())
        if nom:
            rd.at("nom_manti", pk["nom_manti"], ni, tt)
        ni, tt = (p["anti_chk"] & g[:, None]).nonzero(as_tuple=True)
        rd.at("v_manti", pk["v_manti"], ni[:, None], ls, tt[:, None])
        rd.whole("has_aff", tab["has_aff"])
        if bool(tab["has_aff"]) and len(o1):
            for k, t in (("aff_valid", tab["aff_valid"]),
                         ("self_match_all", tab["self_match_all"]),
                         ("atot0", tab["atot0"]),
                         ("pre_atot", pk["pre_atot"])):
                rd.whole(k, t)
            tv = tab["aff_valid"].nonzero()[:, 0][None, :]
            key = tab["aff_key"][tv].long()
            rd.at("aff_key", tab["aff_key"], tv)
            rd.at("nkey", tab["nkey"], n1, key)
            rd.at("pok", tab["pok"], n1, key)
            rd.at("aff0", tab["aff0"], n1, tv)
            rd.at("pre_aff", pk["pre_aff"], tab["pok"][n1, key].long())
            rd.at("aff_all_keys", tab["aff_all_keys"], o1)
            if nom:
                rd.at("nom_mall", pk["nom_mall"], o1)
            rd.at("v_mall", pk["v_mall"], n1, ls)
    return rd.nbytes()


def mins_bound(tab, d):
    """Least time for the minimum-structure kernel: shared0, the claimed
    drain and the registration flags of every pair read once, [C, 3]
    written; a few operations per pair of each constraint."""
    nbytes = sum(tab[k].nbytes for k in ("shared0", "f_reg_real")) \
        + d["C"] * d["VNP"] * 4 + 24 * d["C"]
    return roofline(nbytes, 4 * d["C"] * d["VNP"])


def whatif_bound(call):
    """Least time for one what-if, two ways: (the redesigned launches'
    bound, the walk-only bound), each (ms, "bytes" or "operations", bytes,
    ops). The redesign's bytes: what its launches read and write for
    this launch's dims and data (`whatif_reads`; with a valid spread
    constraint also `mins_bound`'s). The walk's: a walk-only kernel's
    inputs (the torch prologue's tensors, the victim slots and nominated
    aggregates) and outputs. The operations, both: the feasibility passes
    this launch's data needs (fits_now, base and one per valid slot on a
    node whose gate is open, twice with nominated pods), each a compare
    per checked resource, a few per PTS constraint and IPA term; the
    running eviction's sums; the redesign's also its minimum structure."""
    from kubernetes_tpu_torch.ops import whatif_kernel as wk

    (tab, buf, d), out = call
    has_nom = bool(d["has_nom"])
    pk = wk.unpack(buf, d)
    dyn_ipa = bool(d["dyn_ipa"])
    p = wk.lane_prologue(tab, pk, dyn_ipa)
    n, L, r, c = d["N"], d["L"], d["R"], d["C"]
    taa, ta = d["TAA"], d["TA"]
    open_ = p["gate"]
    n1 = int(open_.sum())
    valid = int((pk["v_valid"] & open_[:, None]).sum())
    passes = (2 * n1 + valid) * (2 if has_nom else 1)
    per_pass = 3 + 3 * int(p["chk"].sum()) + 8 * c + (
        4 * taa + 4 * ta + 4 if dyn_ipa else 0)
    per_slot = r + 1 + c + taa + 1
    ops = passes * per_pass + per_slot * (n1 * L + valid)
    nom_bytes = sum(pk[f"nom_{k}"].nbytes
                    for k in ("req", "cnt", "mfs", "manti", "mall"))
    walk_bytes = sum(p[k].nbytes for k in WALK_PROLOGUE + (
        WALK_PROLOGUE_IPA if dyn_ipa else ())) + sum(
        pk[f"v_{k}"].nbytes for k in ("valid", "cnt", "req", "mfs", "manti",
                                      "mall")) \
        + (nom_bytes if has_nom else 0) + out.nbytes
    new_bytes, new_ops = whatif_reads(tab, pk, d, p, out), ops
    if d["any_f"]:
        _, _, mb, mo = mins_bound(tab, d)
        new_bytes, new_ops = new_bytes + mb, new_ops + mo
    return roofline(new_bytes, new_ops), roofline(walk_bytes, ops)


def time_whatif(call):
    """One kept what-if launch, held to the plain version: ms by a CUDA
    graph of 20 launches (after one graph to warm), the plain version's
    ms by CUDA events over 5 calls, and both bounds."""
    import torch
    from kubernetes_tpu_torch.ops import whatif_kernel as wk

    (tab, buf, d), _ = call
    # a first graph in the process runs cold (10-30 % over the same graph
    # again): warm up once
    graph_ms(lambda: wk.whatif_device(tab, buf, d))
    if not torch.equal(wk.whatif_device(tab, buf, d),
                       wk.whatif_plain(tab, buf, d)):
        raise AssertionError("what-if != the plain version")
    ms = graph_ms(lambda: wk.whatif_device(tab, buf, d))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        wk.whatif_plain(tab, buf, d)
    e1.record()
    torch.cuda.synchronize()
    (bound_ms, bound_by, nbytes, ops), walk = whatif_bound(call)
    shape = {k: d[k] for k in ("N", "L", "R", "C", "TAA", "TA", "VNP", "kw",
                               "any_f")}
    return {"ms": ms, "plain_ms": e0.elapsed_time(e1) / 5,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops, "walk_bound_ms": walk[0], "walk_bound_by": walk[1],
            "walk_bytes": walk[2],
            "shape": dict(shape, has_nom=bool(d["has_nom"]),
                          dyn_ipa=bool(d["dyn_ipa"]))}


def time_mins(tab, buf, d):
    """The minimum-structure kernel alone on one preemptor's inputs, held
    to `mins_reference`: ms by a CUDA graph of 20 launches (after one to
    warm), the plain version's by CUDA events over 5 calls, its bound."""
    import torch
    from kubernetes_tpu_torch.ops import whatif_kernel as wk

    graph_ms(lambda: wk.whatif_mins(tab, buf, d))
    if not torch.equal(wk.whatif_mins(tab, buf, d),
                       wk.mins_reference(tab, wk.unpack(buf, d))):
        raise AssertionError("what-if minimum structure != plain")
    ms = graph_ms(lambda: wk.whatif_mins(tab, buf, d))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        wk.mins_reference(tab, wk.unpack(buf, d))
    e1.record()
    torch.cuda.synchronize()
    bound_ms, bound_by, nbytes, ops = mins_bound(tab, d)
    return {"ms": ms, "plain_ms": e0.elapsed_time(e1) / 5,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops, "shape": {k: d[k] for k in ("C", "VNP")}}


def context_reads(tab, d, inv):
    """The bytes the context kernel reads and writes, each element once
    (the kernel's own order): the same-key flags and the f_cnt rows they
    select; static_mask; under dyn_ports, for each node still open, each
    valid wanted port's holders until the first conflict; under dyn_ipa,
    the existing pods' anti terms of each node still open until the first
    that fails it, the pairs and the selected count rows of the
    preemptor's anti and affinity terms, their static counts, the
    matches-all totals; the invariants written."""
    import torch

    rd = Reads()
    dev = tab["alloc"].device
    vnp, tj = d["VNP"], d["tj"]
    for k in ("static_mask", "f_same_key"):
        rd.whole(k, tab[k])
    for k, t in inv.items():
        rd.whole(k, t)
    rows = tab["f_same_key"].any(dim=0).nonzero()[:, 0]
    rd.at("f_cnt", tab["f_cnt"], rows[:, None],
          torch.arange(vnp, device=dev)[None, :])
    g = tab["static_mask"].clone()
    if d["dyn_ports"]:
        rd.whole("want_valid", tab["want_valid"])
        for q in tab["want_valid"].nonzero()[:, 0].tolist():
            idx = g.nonzero()[:, 0]
            pr = int(tab["want_pair"][q])
            rd.at("want_wild", tab["want_wild"], q)
            rd.at("want_pair", tab["want_pair"], q)
            if bool(tab["want_wild"][q]):
                rd.at("cp_any", tab["cp_any"], idx, pr)
                hit = tab["cp_any"][idx, pr] > 0
            else:
                tr = int(tab["want_triple"][q])
                rd.at("cp_wild", tab["cp_wild"], idx, pr)
                hit = tab["cp_wild"][idx, pr] > 0
                rd.at("want_triple", tab["want_triple"], q)
                rd.at("cp_trip", tab["cp_trip"], idx[~hit], tr)
                hit = hit | (tab["cp_trip"][idx, tr] > 0)
            g[idx[hit]] = False
    if d["dyn_ipa"]:
        pok, nkey, u_cnt = tab["pok"], tab["nkey"], tab["u_cnt"]
        idx = g.nonzero()[:, 0]
        rd.at("fail_existing", tab["fail_existing"], idx)
        idx = idx[~tab["fail_existing"][idx]]
        us, ts = tab["m_anti"][:, :, tj].nonzero(as_tuple=True)
        if len(idx):
            rd.at("m_anti", tab["m_anti"],
                  torch.arange(d["U"], device=dev)[:, None],
                  torch.arange(d["TAA"], device=dev)[None, :], tj)
        keys = tab["kaa_all"][us, ts].long()[None, :]
        rd.at("kaa_all", tab["kaa_all"], us, ts)
        nn = idx[:, None].expand(-1, keys.shape[1])
        kk = keys.expand(len(idx), -1)
        on = nkey[nn, kk]
        pr = pok[nn, kk].long()
        hit = on & (u_cnt[us[None, :].expand_as(pr), pr] > 0)
        first = (hit.long().cumsum(dim=1) - hit.long()) == 0
        rd.at("nkey", nkey, nn[first], kk[first])
        m = first & on
        rd.at("pok", pok, nn[m], kk[m])
        rd.at("u_cnt", u_cnt, us[None, :].expand_as(pr)[m], pr[m])
        nall = torch.arange(d["N"], device=dev)[:, None]
        for kind, key_t, cnt_k in (("anti", "anti_key", "anti_cnt_n"),
                                   ("aff", "aff_key", "aff_cnt_n")):
            rd.whole(key_t, tab[key_t])
            rd.whole(cnt_k, tab[cnt_k])
            key = tab[key_t].long()[None, :]
            rd.at("pok", pok, nall, key)
            pair = pok[nall, key].long()                   # [N, T]
            if kind == "anti":
                rd.at("m_anti", tab["m_anti"], tj,
                      torch.arange(d["TAA"], device=dev)[:, None],
                      torch.arange(d["U"], device=dev)[None, :])
                sel = tab["m_anti"][tj]                    # [TAA, U]
                t_, u_ = sel.nonzero(as_tuple=True)
                rd.at("u_cnt", u_cnt, u_[None, :], pair[:, t_])
            else:
                rd.whole("match_all", tab["match_all"])
                u_ = tab["match_all"].nonzero()[:, 0]
                rd.at("u_cnt", u_cnt, u_[None, :, None], pair[:, None, :])
        rd.whole("aff_valid", tab["aff_valid"])
        rd.whole("aff_total", tab["aff_total"])
        u_ = tab["match_all"].nonzero()[:, 0]
        tv = tab["aff_valid"].nonzero()[:, 0]
        rd.at("k_cnt", tab["k_cnt"], u_[:, None],
              tab["aff_key"][tv].long()[None, :])
    return rd.nbytes()


def time_context(call):
    """One kept context launch: ms by a CUDA graph of 20 launches (after
    one to warm), the plain version's by CUDA events over 5 calls, and its
    bound (`context_reads`' bytes; a few operations per same-key term,
    host port, existing anti term and count product)."""
    import torch
    from kubernetes_tpu_torch.ops import whatif_kernel as wk

    (tab, d), inv = call
    graph_ms(lambda: wk.whatif_context(tab, d))  # warm, as time_whatif
    ms = graph_ms(lambda: wk.whatif_context(tab, d))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(5):
        wk.context_reference(tab, d)
    e1.record()
    torch.cuda.synchronize()
    n, c, vnp, u = d["N"], d["C"], d["VNP"], d["U"]
    ops = 2 * c * c * vnp + n * (3 * d["MP"] + 3 * u * d["TAA"]
                                 + 2 * u * (d["TAA"] + d["TA"])) \
        + 2 * u * d["TA"]
    bound_ms, bound_by, nbytes, ops = roofline(context_reads(tab, d, inv),
                                               ops)
    return {"ms": ms, "plain_ms": e0.elapsed_time(e1) / 5,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops, "shape": {k: d[k] for k in (
                "N", "C", "VNP", "U", "TAA", "TA", "MP", "dyn_ipa",
                "dyn_ports")}}


# 14g: the directed what-if cases (tests/test_torch_whatif.py's clusters)
WHATIF_KINDS = ("plain", "spread", "ipa", "ipa-self", "ports")
WHATIF_CASE_NODES = (10, 600)


def whatif_case_world(kind, n_nodes, seed):
    """A zoned cluster saturated by labelled low-priority pods and one
    preemptor of `kind` (plain; spread: a zone DoNotSchedule constraint;
    ipa: a zone affinity and a hostname anti-affinity term; ipa-self:
    affinity toward its own label, which no pod carries; ports: a host
    port), as the port's objects."""
    import random

    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.testing.synth import make_node, make_pod

    rng = random.Random(seed)
    nodes = [make_node(f"n{i}", cpu="4", memory="16Gi", pods=8,
                       labels={"zone": f"z{i % 3}",
                               v1.LABEL_HOSTNAME: f"n{i}"})
             for i in range(n_nodes)]
    pods = [make_pod(f"p{i}-{j}", cpu=f"{rng.choice([500, 900, 1500])}m",
                     memory="64Mi", node_name=f"n{i}", priority=1,
                     labels={"app": rng.choice(["x", "y"])})
            for i in range(n_nodes) for j in range(rng.randint(1, 4))]

    def term(labels, key):
        return v1.PodAffinityTerm(
            label_selector=v1.LabelSelector(match_labels=labels),
            topology_key=key)

    pod = make_pod("hi", cpu="1500m", memory="64Mi", priority=100,
                   labels={"app": "x"})
    if kind == "ipa":
        pod.spec.affinity = v1.Affinity(
            pod_affinity=v1.PodAffinity(
                required_during_scheduling_ignored_during_execution=[
                    term({"app": "x"}, "zone")]),
            pod_anti_affinity=v1.PodAntiAffinity(
                required_during_scheduling_ignored_during_execution=[
                    term({"app": "y"}, v1.LABEL_HOSTNAME)]))
    elif kind == "ipa-self":
        pod.metadata.labels = {"app": "z"}
        pod.spec.affinity = v1.Affinity(pod_affinity=v1.PodAffinity(
            required_during_scheduling_ignored_during_execution=[
                term({"app": "z"}, "zone")]))
    elif kind == "spread":
        pod.spec.topology_spread_constraints = [v1.TopologySpreadConstraint(
            max_skew=1, topology_key="zone",
            when_unsatisfiable="DoNotSchedule",
            label_selector=v1.LabelSelector(match_labels={"app": "x"}))]
    elif kind == "ports":
        pod.spec.containers[0].ports = [v1.ContainerPort(
            host_port=8080, container_port=8080)]
    return nodes, pods, pod


def whatif_inputs(rng, ctx, nps, alloc, L, gang, has_nom, drain=True):
    """Seeded victim slots (a padded last slot; gang slots with up to 3
    members), nominated aggregates and claimed drains (zero without
    `drain`) in the planner's numpy layout."""
    import numpy as np

    n = ctx.n_lanes
    r = alloc.shape[1]
    c = nps["f_same_key"].shape[0]
    taa = nps["ipaaa_valid"].shape[0]
    vnp = ctx.vnp
    valid = rng.random((n, L)) < 0.75
    valid[:, -1] = False
    cnt = np.where(valid, rng.integers(1, 4, (n, L)), 0) if gang \
        else valid.astype(np.int64)
    v = {
        "valid": valid, "cnt": cnt.astype(np.int64),
        "req": np.where(valid[..., None], rng.integers(
            0, alloc[:, None, :] // 3 + 1, (n, L, r)), 0).astype(np.int64),
        "mfs": np.where(valid[..., None], rng.integers(0, 3, (n, L, c)),
                        0).astype(np.int32),
        "manti": np.where(valid[..., None], rng.integers(0, 2, (n, L, taa)),
                          0).astype(np.int32),
        "mall": np.where(valid, rng.integers(0, 2, (n, L)), 0
                         ).astype(np.int32),
    }
    nom = {
        "req": (rng.integers(0, alloc // 4 + 1, (n, r))
                * (rng.random((n, 1)) < 0.3)).astype(np.int64),
        "cnt": rng.integers(0, 2, n).astype(np.int64),
        "mfs": rng.integers(0, 3, (n, c)).astype(np.int32),
        "manti": rng.integers(0, 2, (n, taa)).astype(np.int32),
        "mall": rng.integers(0, 2, n).astype(np.int32),
        "has_nom": has_nom,
    }
    pre = {
        "req": (rng.integers(0, alloc // 5 + 1, (n, r))
                * (rng.random((n, 1)) < 0.3)).astype(np.int64),
        "cnt": rng.integers(0, 2, n).astype(np.int64),
        "shared": rng.integers(0, 3, (c, vnp)).astype(np.int32),
        "anti": rng.integers(0, 2, (taa, vnp)).astype(np.int32),
        "aff": rng.integers(0, 2, vnp).astype(np.int32),
    }
    if not drain:
        pre = {k: np.zeros_like(a) for k, a in pre.items()}
    pre["shared"][:, 0] = 0
    pre["anti"][:, 0] = 0
    pre["aff"][0] = 0
    pre["atot"] = np.int32(pre["aff"].sum())
    return v, nom, pre


def whatif_cases(gpu, device="cuda", timed=True):
    """14g: on each WHATIF_KINDS preemptor over 10- and 600-node clusters,
    the context kernel == `context_reference`, and the what-if ==
    `whatif_plain` on seeded slots (L 4 / 8 / 16, gang slots, nominated
    pods, claimed drains), bit for bit; the minimum-structure kernel
    launched exactly where a spread constraint is valid. On the larger
    cluster the first case of each kind timed (CUDA graph; with `timed`),
    and the minimum-structure kernel alone on the spread preemptor's.
    Bare-wrapper launches: counted, but not on any path."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import whatif_kernel as wk
    from kubernetes_tpu_torch.ops.whatif import WhatifContext
    from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend

    checked = {"contexts": 0, "launches": 0, "mins_launches": 0, "ms": {},
               "mins": None}
    for kind in WHATIF_KINDS:
        for n_nodes in WHATIF_CASE_NODES:
            nodes, pods, pod = whatif_case_world(kind, n_nodes, n_nodes)
            be = TPUBackend(device=device)
            for nd in nodes:
                be.on_add_node(nd)
            for p in pods:
                be.on_add_pod(p, p.spec.node_name)
            pa = {k: a for k, a in be.pe.encode(pod).items()
                  if not k.startswith("_")}
            ctx = WhatifContext.from_encoding(be.enc, pa, device=device)
            tj = ctx.template_index(pa)
            tab, d, any_f = ctx.tables(tj)
            if any_f != (kind == "spread"):
                raise AssertionError(f"14g {kind}: any_f {any_f}")
            ref = wk.context_reference(tab, d)
            bad = [k for k in ref if not torch.equal(tab[k], ref[k])]
            if bad:
                raise AssertionError(f"14g {kind} {n_nodes}: context kernel "
                                     f"!= plain in {bad}")
            checked["contexts"] += 1
            nps = ctx.np_slices(tj)
            alloc = np.asarray(be.enc.host_snapshot()["alloc"])
            for seed, (L, gang, has_nom) in enumerate(
                    ((4, False, False), (8, True, True), (16, False, True))):
                rng = np.random.default_rng(100 * n_nodes + seed)
                v, nom, pre = whatif_inputs(rng, ctx, nps, alloc, L, gang,
                                            has_nom, drain=seed > 0)
                dv = wk.launch_dims(d, L, has_nom, any_f)
                host = np.zeros(wk.layout(dv)[1], np.uint8)
                wk.pack(v, nom, pre, dv, host)
                buf = torch.from_numpy(host).to(device)
                m0 = wk.MINS_LAUNCHES
                got = wk.whatif_device(tab, buf, dv)
                if wk.MINS_LAUNCHES - m0 != int(any_f and buf.is_cuda):
                    raise AssertionError(f"14g {kind}: {wk.MINS_LAUNCHES - m0}"
                                         " minimum-structure launches")
                checked["mins_launches"] += wk.MINS_LAUNCHES - m0
                want = wk.whatif_plain(tab, buf, dv)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"14g {kind} {n_nodes} L {L}: what-if != plain in "
                        f"{int((got != want).sum())} bools")
                checked["launches"] += 1
                if timed and seed == 0 and n_nodes == max(WHATIF_CASE_NODES):
                    checked["ms"][kind] = time_whatif(((tab, buf, dv), got))
                    if any_f:
                        checked["mins"] = time_mins(tab, buf, dv)
            be.close()
    log(f"phase 14g: {checked['contexts']} context launches == plain, "
        f"{checked['launches']} what-if launches (kinds "
        f"{', '.join(WHATIF_KINDS)}; {WHATIF_CASE_NODES} nodes; L 4 / 8 / "
        f"16) == plain, {checked['mins_launches']} of them with the "
        "minimum-structure kernel (the spread kind's); at "
        f"{max(WHATIF_CASE_NODES)} nodes, ms (CUDA graph) and bound by kind "
        + json.dumps({k: {x: r[x] for x in ("ms", "bound_ms", "bound_by",
                                            "bytes", "shape")}
                      for k, r in checked["ms"].items()})
        + (f"; the minimum-structure kernel alone {checked['mins']['ms']:.5f}"
           f" ms, plain {checked['mins']['plain_ms']:.3f} ms, bound "
           f"{checked['mins']['bound_ms']:.7f} ms "
           f"({checked['mins']['bound_by']}, {checked['mins']['bytes']} B) "
           f"at {checked['mins']['shape']}" if checked["mins"] else "")
        + f" [{gpu}]")
    return checked


def overcommitted(pods, nodes):
    """Nodes whose bound pods' requests of a resource (cpu, memory, an
    extended resource; a resource the node does not list has 0) or count
    is above their allocatable."""
    from kubernetes_tpu_torch.api.quantity import parse_quantity

    used = {}
    for p in pods:
        u = used.setdefault(p.spec.node_name, {})
        for c in p.spec.containers:
            for k, q in (c.resources.requests or {}).items():
                u[k] = u.get(k, 0) + parse_quantity(q)
        u["pods"] = u.get("pods", 0) + 1
    over = []
    for node in nodes:
        a = node.status.allocatable
        u = used.get(node.metadata.name, {})
        if any(v > (int(a["pods"]) if k == "pods"
                    else parse_quantity(a.get(k, "0")))
               for k, v in u.items()):
            over.append(node.metadata.name)
    return over


def preempted():
    """(preemptions applied, victims they named) so far: the loop's
    scheduler_preemption_attempts_total and the sum of its
    scheduler_preemption_victims."""
    from kubernetes_tpu_torch.scheduler import metrics

    attempts = sum(v for _, v in metrics.preemption_attempts.items())
    named = next(float(line.split()[-1])
                 for line in metrics.preemption_victims.collect()
                 if line.startswith("scheduler_preemption_victims_sum"))
    return int(attempts), int(named)


def preemption_cell(sk, gpu, label, spec, init, template):
    """One Preemption row through `run_workload` on the card, the what-if
    planner on by its default: every measured pod bound, no node over its
    allocatable, every victim of lower priority than every preemptor,
    every preemptor planned on the device rung (what-if launches > 0), no
    what-if fallback but the planner's node-skew guard (a pod re-planned
    while its wave's encoding moved), the ladder on its top rung with 0
    device faults. The what-if kernel's launches and the scan variants' are
    counted from 0 over the call."""
    from kubernetes_tpu_torch.client import Clientset
    from kubernetes_tpu_torch.ops import whatif_kernel as wk
    from kubernetes_tpu_torch.perf.harness import (
        PodTemplate,
        Workload,
        run_workload,
    )

    w = Workload(init_template=PodTemplate(cpu="900m", memory="64Mi",
                                           priority=1, **init),
                 template=PodTemplate(cpu="900m", memory="64Mi",
                                      priority=100, **template), **spec)
    before = counters()
    pre0 = preempted()
    reset_counts(sk)
    wk.LAUNCHES = wk.MINS_LAUNCHES = wk.CONTEXT_LAUNCHES = 0
    run = LoopRun(True)
    watch = WhatifWatch(keep=WHATIF_KEEP)
    t0 = time.perf_counter()
    try:
        r = run_workload(w)
    finally:
        watch.close()
        run.close()
    wall_s = time.perf_counter() - t0
    launches = {k: v for k, v in sk.VARIANT_LAUNCHES.items() if v}
    launches["whatif"] = wk.LAUNCHES
    launches["whatif_mins"] = wk.MINS_LAUNCHES
    launches["whatif_context"] = wk.CONTEXT_LAUNCHES
    delta = counters_delta(before)
    cs = Clientset(run.apis[-1])
    pods, _ = cs.pods.list(namespace="default")
    nodes, _ = cs.nodes.list()
    left = {p.metadata.name for p in pods}
    victims = sorted(f"init-{i}" for i in range(w.num_init_pods)
                     if f"init-{i}" not in left)
    hi = [p for p in pods if (p.spec.priority or 0) >= 100]
    lo_prio = {p.spec.priority for p in pods
               if (p.spec.priority or 0) < 100}
    be = run.backends[-1]
    attempts, named = (a - b for a, b in zip(preempted(), pre0))
    out = {
        "cell": label, "row": w.name, "pods_per_s": r.throughput_avg,
        "pods_per_s_p50": r.throughput_p50,
        "latency_p50_s": r.pod_scheduling_p50,
        "latency_p99_s": r.pod_scheduling_p99, "attempts": r.attempts,
        "bound": r.num_bound, "pods": w.num_pods, "window_s": r.duration_s,
        "wall_s": wall_s, "victims": len(victims),
        "preemptions": attempts, "victims_named": named,
        "planner_paths": r.preemption_planner_paths,
        "whatif_launches": r.whatif_launches,
        "whatif_fallbacks": r.whatif_fallbacks, "launches": launches,
        "session_kind": r.session_kind,
        "session_rebuilds": r.session_rebuild_reasons,
        "session_builds": {k[0]: int(v)
                           for k, v in delta["session_builds"].items()},
        "context_builds": be.whatif_builds,
        "context_build_ms": (be.whatif_build_s * 1e3 / be.whatif_builds
                             if be.whatif_builds else None),
    }
    over = overcommitted(pods, nodes)
    unbound = [p.metadata.name for p in hi if not p.spec.node_name]
    paths = r.preemption_planner_paths or {}
    if r.num_bound != w.num_pods or unbound or over:
        raise AssertionError(f"{label}: {r.num_bound} of {w.num_pods} bound,"
                             f" unbound {unbound[:5]}, over {over[:5]}")
    if not victims or lo_prio - {1} or len(hi) != w.num_pods:
        raise AssertionError(f"{label}: {len(victims)} victims, priorities "
                             f"below the preemptors {lo_prio}")
    # every evicted pod was a victim a preemption named (a preemptor the
    # loop re-plans before its victims' delete echoes land names a new
    # one, as the reference's loop does)
    if named != len(victims):
        raise AssertionError(f"{label}: {len(victims)} evicted, {named} "
                             f"named by {attempts} preemptions")
    # a fallback may only be the planner's guard against concurrent churn
    # ("node-skew": the encoding moved between the wave's books and the
    # launch, as victims' delete echoes land; the reference's loop shows
    # it too), raised before any launch; every other planned pod rides
    # the device rung
    fallbacks = dict(r.whatif_fallbacks or {})
    skewed = fallbacks.pop("node-skew", 0)
    device = paths.get("device", 0)
    if fallbacks or not r.whatif_launches or device < w.num_pods \
            or sum(paths.values()) - device != skewed \
            or wk.LAUNCHES < r.whatif_launches:
        raise AssertionError(f"{label}: paths {paths}, whatif launches "
                             f"{r.whatif_launches} (kernel {wk.LAUNCHES}), "
                             f"fallbacks {r.whatif_fallbacks}")
    if be.ladder.rung() != be.ladder.top or delta["device_faults"]:
        raise AssertionError(f"{label}: ladder {be.ladder.mode()}, faults "
                             f"{delta['device_faults']}")
    out["walk_err"] = walk_errs(watch.calls, watch.contexts)
    out["walks_checked"] = len(watch.calls)
    out["contexts_checked"] = len(watch.contexts)
    if out["walk_err"]:
        raise AssertionError(f"{label}: the what-if kernels differ from the "
                             f"plain version in {out['walk_err']} values")
    log(f"phase {label} {w.name}: {r.num_bound} preemptors bound over "
        f"{w.num_nodes} nodes ({len(victims)} victims evicted, named by "
        f"{attempts} preemptions, all of "
        f"priority {sorted(lo_prio)} < 100; no node over its allocatable); "
        f"{r.throughput_avg} pods/s (p50 {r.throughput_p50}); latency p50 "
        f"{r.pod_scheduling_p50} s, p99 {r.pod_scheduling_p99} s; "
        f"{r.attempts} attempts; planner paths {paths}, what-if launches "
        f"{r.whatif_launches} (kernel {wk.LAUNCHES}), fallbacks "
        f"{r.whatif_fallbacks}; context builds {be.whatif_builds} "
        f"({out['context_build_ms']} ms each); session {r.session_kind}, "
        f"rebuilds {r.session_rebuild_reasons}; launches {launches}; "
        f"{len(watch.calls)} what-if and {len(watch.contexts)} context "
        f"launches == plain; window {r.duration_s} s, wall {wall_s:.2f} s "
        f"[{gpu}]")
    return out, watch


def saturated_cluster(n_nodes, vpn, labels=None, zones=3):
    """scripts/probe_preemption.py's cluster, as the port's objects."""
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.testing.synth import make_node, make_pod

    cpu_m = 4000 // max(vpn + 1, 1)
    nodes = [make_node(f"n{i}", cpu="4", pods=2 * vpn + 4,
                       labels={"zone": f"z{i % zones}",
                               v1.LABEL_HOSTNAME: f"n{i}"})
             for i in range(n_nodes)]
    pods = []
    for i in range(n_nodes):
        for j in range(vpn):
            p = make_pod(f"low-{i}-{j}", cpu=f"{cpu_m}m", memory="64Mi",
                         node_name=f"n{i}", priority=1,
                         labels=labels or {})
            p.status.start_time = float((i * 31 + j * 7) % 97)
            pods.append(p)
    return nodes, pods, cpu_m


def oracle_plan(snapshot, pod):
    """The DefaultPreemption plugin's dry run (the oracle rung) for one
    preemptor -> (node, sorted victims) or None."""
    from kubernetes_tpu_torch.scheduler.framework.interface import CycleState
    from kubernetes_tpu_torch.scheduler.framework.runtime import Framework
    from kubernetes_tpu_torch.scheduler.internal.nominator import (
        PodNominator,
    )
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        default_plugins,
        new_in_tree_registry,
    )

    f = Framework(new_in_tree_registry(), plugins=default_plugins(),
                  snapshot_fn=lambda: snapshot)
    f.nominator = PodNominator()
    f.pdb_lister = lambda: []
    state = CycleState()
    if f.run_pre_filter_plugins(state, pod) is not None:
        raise AssertionError("oracle: prefilter refused the preemptor")
    statuses = {}
    for ni in snapshot.list():
        st = f.run_filter_plugins(state, pod, ni)
        if st:
            statuses[ni.node.metadata.name] = next(iter(st.values()))
    result, _ = f.plugins["DefaultPreemption"].post_filter(
        state, pod, statuses)
    if result is None:
        return None
    return (result.nominated_node_name,
            sorted(p.metadata.name for p in result.victims))


def cand_key(c):
    from kubernetes_tpu_torch.scheduler.preemption_device import (
        ORACLE_FALLBACK,
    )

    if c is None:
        return None
    if c is ORACLE_FALLBACK:
        return "oracle-fallback"
    return (c.node_name, sorted(p.metadata.name for p in c.victims))


class GcClock:
    """The seconds Python's garbage collector ran while it was open (its
    `gc.callbacks` start / stop pairs)."""

    def __init__(self):
        self.s = 0.0
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.s += time.perf_counter() - self._t0
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def whatif_world(point, affinity):
    """A 14d point's world: a saturated cluster (`point` is nodes x
    victims a node) on a fresh backend on the card, and a wave of
    WHATIF_WAVE preemptors asking twice the probe's request, so that each
    needs an eviction. -> (backend, snapshot, wave, dev_plan), dev_plan()
    planning the wave on the device rung, synchronized."""
    import torch
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.scheduler.framework.snapshot import Snapshot
    from kubernetes_tpu_torch.scheduler.internal.nominator import (
        PodNominator,
    )
    from kubernetes_tpu_torch.scheduler.preemption_device import (
        DevicePreemptionPlanner,
    )
    from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend
    from kubernetes_tpu_torch.testing.synth import make_pod

    n_nodes, vpn = (int(x) for x in point.split("x"))
    labels = {"app": "victim"} if affinity else None
    nodes, pods, cpu_m = saturated_cluster(n_nodes, vpn, labels=labels)
    snapshot = Snapshot.from_objects(pods, nodes)
    be = TPUBackend()
    if not be.whatif:
        raise AssertionError("14d: the what-if is off by default on the card")
    for n in nodes:
        be.on_add_node(n)
    for p in pods:
        be.on_add_pod(p, p.spec.node_name)
    aff = v1.Affinity(pod_affinity=v1.PodAffinity(
        required_during_scheduling_ignored_during_execution=[
            v1.PodAffinityTerm(label_selector=v1.LabelSelector(
                match_labels={"app": "victim"}), topology_key="zone")]))
    # the probe's preemptors ask for cpu_m, which fits beside the victims
    # (4000 - vpn * cpu_m >= cpu_m); twice that needs one eviction
    wave = [make_pod(f"{'a' if affinity else ''}hi-{k}",
                     cpu=f"{2 * cpu_m}m",
                     memory="64Mi", priority=100, labels=labels,
                     affinity=aff if affinity else None)
            for k in range(WHATIF_WAVE)]
    elig = {v1.pod_key(p): (True, not affinity) for p in wave}

    def dev_plan():
        pl = DevicePreemptionPlanner(snapshot, PodNominator(), be,
                                     eligibility=elig)
        out = pl.plan(list(wave))
        torch.cuda.synchronize()
        if set(pl.planner_paths) != {"device"}:
            raise AssertionError(f"14d {point}: paths {pl.planner_paths}")
        return out

    return be, snapshot, wave, dev_plan


def whatif_point(gpu, point, affinity, watch):
    """One point of 14d (`whatif_world`): the wave planned by the device
    rung, the fast rung (not for the affinity preemptors, outside its
    envelope) and the oracle (the first preemptor): the plans must agree.
    Times each rung per preemptor (host clock, the device wave
    synchronized), the kernels alone, and the context builds."""
    from kubernetes_tpu_torch.scheduler.internal.nominator import (
        PodNominator,
    )
    from kubernetes_tpu_torch.scheduler.preemption import (
        FastPreemptionPlanner,
    )

    be, snapshot, wave, dev_plan = whatif_world(point, affinity)

    def fast_plan():
        return FastPreemptionPlanner(snapshot, PodNominator()).plan(
            list(wave))

    def per_preemptor_ms(fn):
        """(median ms a preemptor over WHATIF_REPS waves, each wave's ms
        a preemptor, each wave's ms in the garbage collector, the
        plans)."""
        fn()
        reps, gc_ms = [], []
        for _ in range(WHATIF_REPS):
            with GcClock() as clock:
                t0 = time.perf_counter()
                out = fn()
                reps.append((time.perf_counter() - t0) * 1e3 / WHATIF_WAVE)
            gc_ms.append(clock.s * 1e3)
        return statistics.median(reps), reps, gc_ms, out

    n0 = len(watch.calls)
    builds0 = be.whatif_builds
    dev_ms, dev_reps, dev_gc, dev_out = per_preemptor_ms(dev_plan)
    n_nodes, vpn = (int(x) for x in point.split("x"))
    row = {"point": point, "profile": "ipa-affinity" if affinity else
           "plain", "nodes": n_nodes, "victims_per_node": vpn,
           "wave": WHATIF_WAVE, "device_ms_per_preemptor": dev_ms,
           "device_ms_reps": dev_reps, "device_gc_ms_reps": dev_gc,
           "context_builds": be.whatif_builds,
           "context_builds_in_reps": be.whatif_builds - builds0,
           "context_build_ms": be.whatif_build_s * 1e3 / max(
               be.whatif_builds, 1)}
    if not affinity:
        (row["fast_ms_per_preemptor"], row["fast_ms_reps"], _,
         fast_out) = per_preemptor_ms(fast_plan)
        if [cand_key(c) for c in dev_out] != [cand_key(c) for c in fast_out]:
            raise AssertionError(f"14d {point}: device and fast plans differ")
    with GcClock() as clock:
        t0 = time.perf_counter()
        want = oracle_plan(snapshot, wave[0])
        row["oracle_ms_per_preemptor"] = (time.perf_counter() - t0) * 1e3
    row["oracle_gc_ms"] = clock.s * 1e3
    if cand_key(dev_out[0]) != want:
        raise AssertionError(f"14d {point}: device {cand_key(dev_out[0])} "
                             f"!= oracle {want}")
    row["candidates"] = sum(c is not None for c in dev_out)
    if row["candidates"] != WHATIF_WAVE:
        raise AssertionError(f"14d {point}: {row['candidates']} of "
                             f"{WHATIF_WAVE} preemptors found victims")
    call = watch.calls[n0]
    row.update({f"kernel_{k}": v for k, v in time_whatif(call).items()})
    log(f"phase 14d {point} {row['profile']}: device "
        f"{dev_ms:.3f} ms per preemptor (median; waves "
        f"{', '.join(f'{x:.3f}' for x in dev_reps)}, of which in the "
        f"collector {', '.join(f'{x:.1f}' for x in dev_gc)} ms a wave)"
        + (f", fast {row['fast_ms_per_preemptor']:.3f}"
           if not affinity else "")
        + f", oracle {row['oracle_ms_per_preemptor']:.3f} (first "
        f"preemptor, {row['oracle_gc_ms']:.1f} ms in the collector); plans "
        f"agree ({row['candidates']} of {WHATIF_WAVE} "
        f"with a candidate); kernels {row['kernel_ms']:.4f} ms (CUDA graph)"
        f", plain "
        f"{row['kernel_plain_ms']:.3f} ms, bound "
        f"{row['kernel_bound_ms']:.6f} ms ({row['kernel_bound_by']}; the "
        f"walk's {row['kernel_walk_bound_ms']:.6f}); context builds "
        f"{be.whatif_builds} at {row['context_build_ms']:.1f} ms [{gpu}]")
    return row


def whatif_profile(point, affinity):
    """One 14d point's CUDA launches and the card's busy ms per what-if:
    `whatif_world`'s wave planned once to warm (the context built, the
    library loaded), then again under torch.profiler, the card's activity
    alone; every kernel and copy of the wave, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from kubernetes_tpu_torch.ops import whatif_kernel as wk

    be, _, _, dev_plan = whatif_world(point, affinity)
    dev_plan()
    k0 = wk.LAUNCHES
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dev_plan()
    n = max(wk.LAUNCHES - k0, 1)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    names = {}
    for e in events:
        names[e.name] = names.get(e.name, 0) + 1
    be.close()
    return {"whatif_kernels_in_wave": wk.LAUNCHES - k0,
            "cuda_launches_per_whatif": len(events) / n,
            "cuda_launches_by_name": names,
            "device_busy_ms_per_whatif": sum(
                e.device_time_total for e in events) / 1e3 / n,
            "whatif_kernel_ms_by_profiler": sum(
                e.device_time_total for e in events
                if "whatif" in e.name) / 1e3 / n}


# the 14d points traced for launches and busy time: the largest of each
# profile (a fresh world each, so not every point)
WHATIF_PROFILED = (("500x8", False), ("200x4", True))


def whatif_profile_child() -> None:
    """A fresh process: `whatif_profile` at the WHATIF_PROFILED points.
    Prints one JSON line."""
    rows = {f"{pt} {'ipa-affinity' if aff else 'plain'}":
            whatif_profile(pt, aff) for pt, aff in WHATIF_PROFILED}
    print(json.dumps(rows), flush=True)


def whatif_profiles(gpu):
    """14d's launches per what-if at the WHATIF_PROFILED points, traced in
    a fresh process: in a full pass, after the earlier phases,
    torch.profiler kept only a wave's last device events (a process that
    ran only phase 14 traced them all)."""
    res = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
         "chip_smoke.whatif_profile_child()"],
        capture_output=True, text=True, timeout=300, cwd=HERE)
    if res.returncode != 0:
        raise AssertionError(f"14d profile child failed:\n"
                             f"{res.stderr[-3000:]}")
    rows = json.loads(res.stdout.strip().splitlines()[-1])
    for key, r in rows.items():
        if r["whatif_kernels_in_wave"] != WHATIF_WAVE:
            raise AssertionError(f"14d profile {key}: {r}")
        log(f"phase 14d profile {key} (a fresh process): "
            f"{r['cuda_launches_per_whatif']:.1f} CUDA launches per what-if "
            f"({r['cuda_launches_by_name']} in a wave of {WHATIF_WAVE}), "
            f"the card busy {r['device_busy_ms_per_whatif']:.4f} ms per "
            f"what-if, the what-if kernels {r['whatif_kernel_ms_by_profiler']:.4f}"
            f" ms; with the prologue in torch 54 and 0.10-0.17 ms [{gpu}]")
    return rows


def whatif_fault_drill(gpu):
    """14e: raise-whatif on the first preemptor of a 3-pod wave on the
    card: it falls to the fast rung on the same books, the rest ride the
    device rung, no victim is claimed twice, and the session count does
    not move."""
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.scheduler import metrics
    from kubernetes_tpu_torch.scheduler.framework.snapshot import Snapshot
    from kubernetes_tpu_torch.scheduler.internal.nominator import (
        PodNominator,
    )
    from kubernetes_tpu_torch.scheduler.preemption_device import (
        DevicePreemptionPlanner,
    )
    from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend
    from kubernetes_tpu_torch.testing.faults import FaultInjector
    from kubernetes_tpu_torch.testing.synth import make_pod

    nodes, pods, cpu_m = saturated_cluster(200, 4)
    be = TPUBackend()
    for n in nodes:
        be.on_add_node(n)
    for p in pods:
        be.on_add_pod(p, p.spec.node_name)
    inj = FaultInjector()
    inj.arm("raise-whatif", shots=1)
    be.faults = inj
    r0 = sum(v for _, v in metrics.session_rebuilds.items())
    wave = [make_pod(f"hi-{k}", cpu=f"{2 * cpu_m}m", memory="64Mi",
                     priority=100) for k in range(3)]
    pl = DevicePreemptionPlanner(
        Snapshot.from_objects(pods, nodes), PodNominator(), be,
        eligibility={v1.pod_key(p): (True, True) for p in wave})
    cands = pl.plan(wave)
    keys = [v1.pod_key(v) for c in cands if c is not None for v in c.victims]
    out = {"paths": pl.planner_paths, "injected": dict(inj.injected),
           "victims": len(keys), "rung": be.ladder.mode(),
           "rebuilds": sum(v for _, v in metrics.session_rebuilds.items())
           - r0}
    if pl.planner_paths != ["fast", "device", "device"] \
            or inj.injected.get("raise-whatif") != 1 \
            or None in cands or len(keys) != len(set(keys)) \
            or out["rebuilds"]:
        raise AssertionError(f"14e: {out}")
    log(f"phase 14e raise-whatif drill: paths {pl.planner_paths}, "
        f"{len(keys)} victims claimed once each, session rebuilds +0, "
        f"ladder {be.ladder.mode()} [{gpu}]")
    return out


def gang_check(gpu):
    """14f: `gang_feasible` on the card against the plain version (the
    same reductions on a CPU what-if view of the same encoding) at
    several k."""
    from kubernetes_tpu_torch.ops.whatif import WhatifContext
    from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend
    from kubernetes_tpu_torch.testing.synth import make_pod

    nodes, pods, _ = saturated_cluster(500, 2)
    be = TPUBackend()
    for n in nodes:
        be.on_add_node(n)
    for p in pods:
        be.on_add_pod(p, p.spec.node_name)
    gang = make_pod("gang", cpu="1", memory="64Mi", priority=1)
    pa = {k: a for k, a in be.pe.encode(gang).items()
          if not k.startswith("_")}
    cpu_ctx = WhatifContext.from_encoding(be.enc, pa, device="cpu")
    tj = cpu_ctx.template_index(pa)
    rows = []
    for k in (1, 2, 64, 500, 501, 5000):
        got = be.gang_feasible(gang, k)
        want = cpu_ctx.gang_fits(tj, k)
        rows.append((k, got))
        if got is not want:
            raise AssertionError(f"14f: k={k} card {got} plain {want}")
    if {g for _, g in rows} != {True, False}:
        raise AssertionError(f"14f: one answer only {rows}")
    log(f"phase 14f gang_feasible on the card == plain at k "
        f"{[k for k, _ in rows]}: {[g for _, g in rows]} [{gpu}]")
    return rows


def phase_preemption(sk, gpu):
    """Phase 14: the device preemption planner on the card. Returns (the
    phase's numbers, the kernels-line numbers of the what-if kernels and
    of the context kernel, launches per scan variant over 14a-c)."""
    t0 = time.perf_counter()
    marks = [("", t0)]

    def mark(label):
        marks.append((label, time.perf_counter()))

    out = {}
    loop_launches = {}
    kept, kept_ctx = [], []
    for label, spec, init, template in PREEMPTION_ROWS:
        cell, watch = preemption_cell(sk, gpu, label, spec, init, template)
        out[label] = cell
        kept += watch.calls
        kept_ctx += watch.contexts
        for k, v in cell["launches"].items():
            loop_launches[k] = loop_launches.get(k, 0) + v
        mark(label)
    # the kernels at the main path's shape: 14a's first launches
    main = time_whatif(kept[0])
    context = time_context(kept_ctx[0])
    log(f"phase 14 kernels at 14a's shape {main['shape']}: what-if "
        f"{main['ms']:.5f} ms (CUDA graph), "
        f"plain {main['plain_ms']:.3f} ms, bound {main['bound_ms']:.6f} ms "
        f"({main['bound_by']}, {main['bytes']} B), the walk's "
        f"{main['walk_bound_ms']:.6f} ms ({main['walk_bytes']} B); context "
        f"{context['ms']:.5f} ms, plain {context['plain_ms']:.3f} ms, bound "
        f"{context['bound_ms']:.6f} ms ({context['bound_by']}, "
        f"{context['bytes']} B) [{gpu}]")
    mark("kernels")
    watch = WhatifWatch()
    try:
        out["14d"] = [whatif_point(gpu, pt, False, watch)
                      for pt in WHATIF_POINTS] + [
            whatif_point(gpu, pt, True, watch) for pt in WHATIF_AFF_POINTS]
    finally:
        watch.close()
    mark("14d")
    profiles = whatif_profiles(gpu)
    mark("14d profile")
    for row in out["14d"]:
        row.update(profiles.get(f"{row['point']} {row['profile']}", {}))
    err = walk_errs(kept, kept_ctx) + walk_errs(watch.calls, watch.contexts)
    if err:
        raise AssertionError(f"14d: the what-if kernels differ from the "
                             f"plain version in {err} values")
    log(f"phase 14d: {len(watch.calls)} what-if and {len(watch.contexts)} "
        f"context launches of the sweep and {len(kept)} / {len(kept_ctx)} "
        f"of 14a-c == plain [{gpu}]")
    mark("14d check")
    out["14e"] = whatif_fault_drill(gpu)
    mark("14e")
    out["14f"] = gang_check(gpu)
    mark("14f")
    out["14g"] = whatif_cases(gpu)
    mark("14g")
    out["phase_s"] = time.perf_counter() - t0
    out["seconds"] = {b[0]: round(b[1] - a[1], 1)
                      for a, b in zip(marks, marks[1:])}
    log(f"phase 14 seconds: {out['seconds']}, {out['phase_s']:.1f} in all")
    mins = out["14g"]["mins"]
    kernel = dict(main, launches=loop_launches["whatif"], err=err,
                  checked=len(kept) + len(watch.calls)
                  + out["14g"]["launches"],
                  mins={"launches": loop_launches["whatif_mins"],
                        "case_launches": out["14g"]["mins_launches"],
                        **{k: mins[k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "bytes",
                                                "shape")}})
    context = dict(context, launches=loop_launches["whatif_context"],
                   err=err, checked=len(kept_ctx) + len(watch.contexts)
                   + out["14g"]["contexts"])
    return out, (kernel, context), loop_launches


# -- phase 15: the rest of the scheduler_perf matrix -------------------------

# scripts/bench_configs.py's single-device rows beyond phases 13 and 14
# (:55-300), at the sizes it gives them but for the twins' TWIN_PODS;
# templates as PodTemplate keyword arguments, so that the tests can stamp
# both packages' harnesses
_GPU_POD = {"extended": {"example.com/gpu": "1"}}
_GPU_NODE = {"example.com/gpu": "8"}
_SPREAD = {"spread_zone": True}
_AFF = {"labels": {"app": "aff"}}
# measured pods cut from the file's (nodes never), so that the whole
# script ends within 900 s (PERF.md, 4. Cells): the 5000-node twins' from
# 5000, PTS-heavy's from 20000, the gang rows' from 8000 and 4096, and
# over the wire Default-5000n-10k's init and measured pods from 6144 and
# 10000 (its bindings held to a replay of its batches)
TWIN_PODS = 512
PTS_PODS = 2048
GANG_PODS = 2048
WIRE_DEFAULT_PODS = 2048
MATRIX_ROWS = {
    "pts20k": dict(
        name="PTS-heavy-5000n-20k", num_nodes=5000, num_init_pods=4096,
        num_pods=PTS_PODS, max_batch=2048, timeout=1200.0,
        init_template=dict(_SPREAD, spread_zone_hard=True),
        template=dict(_SPREAD, spread_zone_hard=True)),
    "ipachurn": dict(
        name="IPA-churn-2000n-5000", num_nodes=2000, num_init_pods=1024,
        num_pods=5000, max_batch=1024, timeout=900.0, stall_stop=15.0,
        saturating=True,
        init_template={"anti_affinity_hostname": True,
                       "labels": {"app": "churn"}},
        template={"anti_affinity_hostname": True,
                  "labels": {"app": "churn"}}),
    "gang": dict(
        name="Gang-4000n-1000x8", num_nodes=4000, num_init_pods=2048,
        num_pods=GANG_PODS, gang_size=8, max_batch=1024, timeout=900.0,
        init_template=_GPU_POD, template=_GPU_POD, node_extended=_GPU_NODE),
    "gang64": dict(
        name="Gang-4000n-64x64", num_nodes=4000, num_init_pods=2048,
        num_pods=GANG_PODS, gang_size=64, max_batch=1024, timeout=900.0,
        init_template=_GPU_POD, template=_GPU_POD, node_extended=_GPU_NODE),
    "gang256": dict(
        name="Gang-4000n-8x256", num_nodes=4000, num_init_pods=2048,
        num_pods=2048, gang_size=256, max_batch=1024, timeout=900.0,
        init_template=_GPU_POD, template=_GPU_POD, node_extended=_GPU_NODE),
    "unschedchurn": dict(
        name="Unschedulable-churn-500n", num_nodes=500, num_init_pods=1000,
        num_pods=3000, max_batch=512, timeout=900.0, stall_stop=15.0,
        saturating=True, init_template=_SPREAD, template=_SPREAD,
        second_template={"cpu": "8", "memory": "64Gi"}, second_every=3),
    "secrets": dict(
        name="SchedulingSecrets-500n", num_nodes=500, num_init_pods=1000,
        num_pods=1000, max_batch=1024, template={"secret_volumes": 2}),
    "intreepvs": dict(
        name="SchedulingInTreePVs-500n", num_nodes=500, num_init_pods=1000,
        num_pods=1000, max_batch=1024, timeout=900.0,
        init_template={"with_pvc": "zonal"}, template={"with_pvc": "zonal"}),
    "csipvs": dict(
        name="SchedulingCSIPVs-500n", num_nodes=500, num_init_pods=1000,
        num_pods=1000, max_batch=1024, timeout=900.0,
        init_template={"with_pvc": "csi"}, template={"with_pvc": "csi"}),
    "migratedpvs": dict(
        name="SchedulingMigratedInTreePVs-500n", num_nodes=500,
        num_init_pods=1000, num_pods=1000, max_batch=1024, timeout=900.0,
        init_template={"with_pvc": "migrated"},
        template={"with_pvc": "migrated"}),
    "podaffinity": dict(
        name="SchedulingPodAffinity-500n", num_nodes=500, num_init_pods=1000,
        num_pods=1000, max_batch=1024, timeout=900.0, init_template=_AFF,
        template=dict(_AFF, pod_affinity_zone=True)),
    "prefaffinity": dict(
        name="SchedulingPreferredPodAffinity-500n", num_nodes=500,
        num_init_pods=1000, num_pods=1000, max_batch=1024, timeout=900.0,
        init_template=_AFF, template=dict(_AFF, preferred_affinity_zone=True)),
    "prefantiaffinity": dict(
        name="SchedulingPreferredPodAntiAffinity-500n", num_nodes=500,
        num_init_pods=1000, num_pods=1000, max_batch=1024, timeout=900.0,
        init_template=_AFF,
        template=dict(_AFF, preferred_anti_affinity_zone=True)),
    "nodeaffinity": dict(
        name="SchedulingNodeAffinity-500n", num_nodes=500, num_init_pods=1000,
        num_pods=1000, max_batch=1024,
        template={"node_affinity_zones": ["zone-0", "zone-1"]}),
    "intreepvs5000": dict(
        name="SchedulingInTreePVs-5000n", num_nodes=5000, num_init_pods=2048,
        num_pods=TWIN_PODS, max_batch=2048, timeout=900.0,
        init_template={"with_pvc": "zonal"}, template={"with_pvc": "zonal"}),
    "podaffinity5000": dict(
        name="SchedulingPodAffinity-5000n", num_nodes=5000,
        num_init_pods=2048, num_pods=TWIN_PODS, max_batch=2048,
        timeout=900.0,
        init_template=_AFF, template=dict(_AFF, pod_affinity_zone=True)),
    "prefaffinity5000": dict(
        name="SchedulingPreferredPodAffinity-5000n", num_nodes=5000,
        num_init_pods=2048, num_pods=TWIN_PODS, max_batch=2048,
        timeout=900.0,
        init_template=_AFF, template=dict(_AFF, preferred_affinity_zone=True)),
    "prefantiaffinity5000": dict(
        name="SchedulingPreferredPodAntiAffinity-5000n", num_nodes=5000,
        num_init_pods=2048, num_pods=TWIN_PODS, max_batch=2048,
        timeout=900.0,
        init_template=_AFF,
        template=dict(_AFF, preferred_anti_affinity_zone=True)),
    "nodeaffinity5000": dict(
        name="SchedulingNodeAffinity-5000n", num_nodes=5000,
        num_init_pods=2048, num_pods=TWIN_PODS, max_batch=2048,
        timeout=900.0,
        template={"node_affinity_zones": ["zone-0", "zone-1"]}),
}


# 15c: the first two rows of BENCH_WIRE_CONFIGS.json, phase 13a's and
# 13b's (scripts/bench_configs.py's "basic" and "default5000")
WIRE_ROWS = {
    "basic": dict(name="SchedulingBasic-500", num_nodes=500,
                  num_init_pods=1000, num_pods=1000, max_batch=1024),
    "default5000": dict(
        name="Default-5000n-10k", num_nodes=5000,
        num_init_pods=WIRE_DEFAULT_PODS, num_pods=WIRE_DEFAULT_PODS,
        max_batch=2048, timeout=900.0,
        init_template=_SPREAD, template=_SPREAD),
}


def matrix_workload(harness, spec, **override):
    """A MATRIX_ROWS spec as `harness`'s Workload (the port's or, in the
    tests, the reference's), with `override` on top."""
    kw = dict(spec, **override)
    for key in ("init_template", "template", "second_template"):
        if key in kw:
            kw[key] = harness.PodTemplate(**kw[key])
    return harness.Workload(**kw)


SCHEDULE_BATCH_PODS = 512        # phase 15a's pods (phase 4's batch, cut)
MATRIX_CPU_NODES = 500           # 15b's rows of this size also run on the CPU
MATRIX_CPU_WORKERS = 6           # ... in this many worker processes at once
MATRIX_CPU_THREADS = 1           # torch threads in each
MATRIX_STALL_GRACE = 30.0        # seconds a gang checker may lag the run


def phase_schedule_batch(gpu, zone):
    """15a: ops/batch.py `schedule_batch` on the card, on phase 4's
    zone-spread cluster at full width (the encoding phase 4's session
    started from) over the first SCHEDULE_BATCH_PODS pods of its first
    measured batch: the decisions equal a ScanSession's on the same pods
    from the same encoding; new_carry's `requested`, `nz_requested` and
    `pod_count` equal the host encoding's after those decisions (each
    placed pod's request added to its node's row, as
    ClusterEncoding.add_pod adds it), and the pod rows it wrote are the
    placed pods'. ms per pod by the host window and by CUDA events;
    kernels per pod under torch.profiler over PROFILED_PODS pods."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
    from kubernetes_tpu_torch.ops.batch import schedule_batch
    from kubernetes_tpu_torch.ops.scan import ScanSession

    snap = zone["snapshot0"]
    pods = zone["batch"][:SCHEDULE_BATCH_PODS]
    n = len(pods)
    cluster = cluster_from_numpy(snap, "cuda")
    free = np.flatnonzero(~snap["pvalid"])[:n].tolist()
    ss = ScanSession(cluster, zone["templates"], multipod_k=1,
                     device="cuda")
    want = ScanSession.decisions(ss.schedule(pods))
    del ss
    gc.collect()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    got, carry = schedule_batch(cluster, pods, free)
    e1.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    event_ms = e0.elapsed_time(e1)
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"15a: schedule_batch decides {bad} of {n} "
                             "pods otherwise than ScanSession")
    exp = {k: snap[k].copy() for k in ("requested", "nz_requested",
                                       "pod_count")}
    for pa, d in zip(pods, want):
        if d >= 0:
            exp["requested"][d] += pa["req"]
            exp["nz_requested"][d] += pa["nz_req"]
            exp["pod_count"][d] += 1
    diff = [k for k, a in exp.items()
            if not np.array_equal(carry[k].cpu().numpy(), a)
            or carry[k].dtype != torch.from_numpy(a).dtype]
    rows = np.asarray(free)
    placed = np.asarray(want) >= 0
    if not np.array_equal(carry["pvalid"].cpu().numpy()[rows], placed) \
            or not np.array_equal(carry["pnode"].cpu().numpy()[rows],
                                  np.where(placed, want, 0)):
        diff.append("pod rows")
    for k, v in cluster.items():      # the cluster's tensors untouched
        if k in carry and v.data_ptr() == carry[k].data_ptr():
            diff.append(f"{k} aliases the cluster")
    if diff:
        raise AssertionError(f"15a: new_carry differs from the host "
                             f"encoding in {diff}")
    busy = device_busy(lambda: schedule_batch(cluster, pods[:PROFILED_PODS],
                                              free))
    out = {"cell": "15a schedule_batch zone spread 5000n", "pods": n,
           "nodes": int(snap["n_nodes"]),
           "node_rows": int(snap["valid"].shape[0]),
           "placed": int(placed.sum()), "ms_per_pod": host_ms / n,
           "event_ms_per_pod": event_ms / n,
           "pods_per_s": n / host_ms * 1e3, **busy}
    log(f"phase 15a schedule_batch: {n} pods of phase 4's batch at "
        f"{out['nodes']} nodes ({out['node_rows']} rows), decisions == "
        f"ScanSession's ({out['placed']} placed); new_carry's requested, "
        f"nz_requested, pod_count and pod rows == the host encoding after "
        f"them; {host_ms / n:.3f} ms per pod by the host window, "
        f"{event_ms / n:.3f} ms by CUDA events, {out['pods_per_s']:.1f} "
        f"pods/s; under the profiler ({PROFILED_PODS} pods) "
        f"{busy['kernels_per_pod']:.1f} kernels per pod, the card busy "
        f"{busy['busy_ms']:.3f} of {busy['window_ms']:.3f} ms "
        f"({busy['busy_share']:.1%}) [{gpu}]")
    return out


def volume_checks(cs, pods, nodes):
    """The PVC rows' invariants over the run's objects: each bound pod's
    PV zone (where the PV has one) is its node's zone, and no node holds
    more distinct CSI volumes of a driver (in-tree sources translated)
    than its CSINode allows. -> (pods checked, violations)."""
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.volume.csi_translation import pv_csi_source

    pvs = {pv.metadata.name: pv
           for pv in cs.resource("persistentvolumes").list()[0]}
    claims = {c.metadata.name: c for c in cs.resource(
        "persistentvolumeclaims").list(namespace="default")[0]}
    limits = {c.metadata.name: {d.name: d.count for d in c.spec.drivers or []}
              for c in cs.resource("csinodes").list()[0]}
    zone_of = {n.metadata.name: n.metadata.labels.get(v1.LABEL_ZONE)
               for n in nodes}
    attached, bad, checked = {}, [], 0
    for p in pods:
        node = p.spec.node_name
        if not node:
            continue
        for vol in p.spec.volumes or []:
            claim = (vol.source or {}).get("persistentVolumeClaim")
            if not claim:
                continue
            checked += 1
            pv = pvs[claims[claim["claimName"]].spec.volume_name]
            zone = (pv.metadata.labels or {}).get(v1.LABEL_ZONE)
            if zone is not None and zone != zone_of[node]:
                bad.append(f"{p.metadata.name}: PV zone {zone} on {node} "
                           f"({zone_of[node]})")
            src = pv_csi_source(pv)
            if src:
                attached.setdefault((node, src["driver"]), set()).add(
                    src["volumeHandle"])
    for (node, driver), handles in attached.items():
        cap = limits.get(node, {}).get(driver)
        if cap is None or len(handles) > cap:
            bad.append(f"{node}: {len(handles)} {driver} volumes, CSINode "
                       f"allows {cap}")
    return checked, bad


def anti_affine_shared(pods):
    """Nodes holding two pods with a required hostname anti-affinity term
    that matches the other's labels."""
    from kubernetes_tpu_torch.api import types as v1

    by_node = {}
    for p in pods:
        if p.spec.node_name:
            by_node.setdefault(p.spec.node_name, []).append(p)
    shared = []
    for node, group in by_node.items():
        for p in group:
            anti = p.spec.affinity and p.spec.affinity.pod_anti_affinity
            terms = anti and \
                anti.required_during_scheduling_ignored_during_execution
            for term in terms or []:
                if term.topology_key != v1.LABEL_HOSTNAME:
                    continue
                sel = term.label_selector.match_labels or {}
                if any(q is not p and all((q.metadata.labels or {}).get(k)
                                          == v for k, v in sel.items())
                       for q in group):
                    shared.append(node)
    return sorted(set(shared))


def matrix_cell(sk, gpu, key, spec, device="cuda", **override):
    """`loop_cell` of one row (`spec`, a MATRIX_ROWS or WIRE_ROWS entry,
    with `override` on its Workload)."""
    from kubernetes_tpu_torch.perf import harness

    w = matrix_workload(harness, spec, **override)
    label = f"15{'c' if w.wire else 'b'} {key}"
    return loop_cell(sk, gpu, label, w, device=device)


def matrix_checks(key, out, run, pods, nodes):
    """Phase 15b's invariant checks beyond `matrix_cell`'s, right after the
    row: the gang rows' admissions (0 rollbacks, 0 rejections, no torn
    gang), the PV rows' zones and attach counts, one anti-affine pod a
    hostname. Returns what the replay of a non-saturating row needs (the
    loop's batches, the nodes, the PV rows' volumes), else None."""
    from kubernetes_tpu_torch.client import Clientset

    spec = MATRIX_ROWS[key]
    label = out["cell"]
    held = out["held"] = ["no node over its allocatable"]
    if spec.get("gang_size", 0) > 1:
        if sum((out["gang_rollbacks"] or {}).values()) \
                or sum((out["gang_rejected"] or {}).values()) \
                or out["gang"]["partial"] or out["gang"]["violations"]:
            raise AssertionError(f"{label}: gangs {out['gang']}, rollbacks "
                                 f"{out['gang_rollbacks']}, rejected "
                                 f"{out['gang_rejected']}")
        held.append("every gang whole, 0 rollbacks, 0 rejections")
    cs = Clientset(run.apis[-1])
    with_pvc = spec.get("template", {}).get("with_pvc")
    if with_pvc:
        checked, bad = volume_checks(cs, pods, nodes)
        out["volumes_checked"] = checked
        if bad or checked != len(pods):
            raise AssertionError(f"{label}: {checked} volumes checked, "
                                 f"{bad[:5]}")
        held.append(f"{checked} PV zones == node zones, CSI attach counts "
                    "within CSINode")
    shared = anti_affine_shared(pods)
    if shared:
        raise AssertionError(f"{label}: anti-affine pods share {shared[:5]}")
    held.append("no anti-affine pods on one hostname")
    if spec.get("template", {}).get("anti_affinity_hostname"):
        # one pod a hostname fits every node: each node ends with one
        bound = sum(1 for p in pods if p.spec.node_name)
        if bound != min(len(nodes), len(pods)):
            raise AssertionError(f"{label}: {bound} pods bound over "
                                 f"{len(nodes)} nodes")
        held.append(f"every hostname holds one ({bound} bound)")
    if spec.get("saturating"):
        return None
    volumes = None
    if with_pvc:
        volumes = tuple(cs.resource(r).list(**kw)[0] for r, kw in (
            ("persistentvolumeclaims", {"namespace": "default"}),
            ("persistentvolumes", {}), ("csinodes", {})))
    return run.batches, nodes, volumes, run.oracle_pods


def replay_check(out, bindings, job):
    """A non-saturating row's bindings against a fresh backend's
    `schedule_many` replay of the loop's batches (`replay_bindings`)."""
    batches, nodes, volumes, oracle_pods = job
    t0 = time.perf_counter()
    replay = replay_bindings(batches, nodes, volumes=volumes)
    out["replay_s"] = time.perf_counter() - t0
    diff = sorted(k for k, v in bindings.items()
                  if k in replay and replay[k] != v)
    missing = sum(1 for k in bindings if k not in replay)
    out["replay_differs"], out["replay_missing"] = len(diff), missing
    if diff or missing != oracle_pods:
        raise AssertionError(f"{out['cell']}: {len(diff)} loop bindings "
                             f"differ from the schedule_many replay (first "
                             f"{diff[:5]}), {missing} pods not in a batch, "
                             f"{oracle_pods} on the oracle")


def cpu_row(key, spec, gpu):
    """One row's CPU run (TPUBackend(device="cpu"), its hoisted session),
    in a worker process of phase 15b. -> (numbers, bindings, the lines it
    would have printed)."""
    import torch
    from kubernetes_tpu_torch.ops import scan_kernel as sk

    torch.set_num_threads(MATRIX_CPU_THREADS)
    lines = []
    globals()["log"] = lines.append
    out, bindings, _, _, _ = matrix_cell(sk, gpu, key, spec, device="cpu")
    return out, bindings, lines


def phase_matrix(sk, gpu, loop_bindings):
    """Phase 15: 15b, every MATRIX_ROWS row on the card through
    `run_workload`, then 15c, the first two rows of BENCH_WIRE_CONFIGS.json
    (13a's and 13b's) over the HTTP apiserver, whose bindings must equal
    13a's and 13b's in-process ones. The checks that measure nothing run
    last: the 500-node rows' CPU runs, MATRIX_CPU_WORKERS at a time in
    worker processes, while this process replays the non-saturating rows'
    batches (what a row keeps for its replay is frozen out of the
    collector's reach meanwhile, so that it costs no later window a
    collection). Returns (numbers, launches per kernel variant over the
    phase)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    out, jobs = {}, {}
    t0 = time.perf_counter()
    try:
        for key, spec in MATRIX_ROWS.items():
            cell, bindings, run, pods, nodes = matrix_cell(sk, gpu, key, spec)
            add(cell["launches"])
            jobs[key] = bindings, matrix_checks(key, cell, run, pods, nodes)
            out[key] = cell
            del run, pods, nodes
            gc.collect()
            gc.freeze()
        loops = {"13a": LOOP_BASIC, "13b": LOOP_DEFAULT}
        for (key, spec), loop_key in zip(WIRE_ROWS.items(), ("13a", "13b")):
            cell, bindings, run, _, nodes = matrix_cell(sk, gpu, key, spec,
                                                        wire=True)
            add(cell["launches"])
            if spec["num_init_pods"] != loops[loop_key]["num_init_pods"]:
                # cut below its in-process twin's init pods: held, as
                # 15b's rows are, to a replay of its own batches
                replay_check(cell, bindings, (run.batches, nodes, None,
                                              run.oracle_pods))
                log(f"phase 15c {key}: all {len(bindings)} bindings over "
                    f"the wire equal a schedule_many replay of its "
                    f"batches ({cell['replay_s']:.1f} s); "
                    f"{cell['pods_per_s']} pods/s, latency p50 "
                    f"{cell['latency_p50_s']} s, p99 "
                    f"{cell['latency_p99_s']} s [{gpu}]")
                out[f"wire_{key}"] = cell
                del run, nodes
                continue
            del run, nodes
            # the in-process run's bindings of the pods this run has (a
            # cut row's pods are the first of the in-process row's, and
            # the session decides pod by pod in creation order)
            want = {k: v for k, v in loop_bindings[loop_key].items()
                    if k in bindings}
            diff = sorted(k for k, v in want.items() if bindings.get(k) != v)
            if diff or len(want) != len(bindings):
                raise AssertionError(f"15c {key}: {len(diff)} of {len(want)}"
                                     f" bindings over the wire differ from "
                                     f"{loop_key}'s in-process run, first "
                                     f"{diff[:5]}")
            cell["in_process"] = loop_bindings[f"{loop_key}_numbers"]
            log(f"phase 15c {key}: all {len(want)} bindings over the wire "
                f"equal {loop_key}'s in process; {cell['pods_per_s']} pods/s"
                f" against {cell['in_process']['pods_per_s']}, latency p50 "
                f"{cell['latency_p50_s']} s against "
                f"{cell['in_process']['latency_p50_s']}, p99 "
                f"{cell['latency_p99_s']} s against "
                f"{cell['in_process']['latency_p99_s']} [{gpu}]")
            out[f"wire_{key}"] = cell
    finally:
        gc.unfreeze()
    out["measured_s"] = time.perf_counter() - t0
    cpu_keys = [k for k, v in MATRIX_ROWS.items()
                if v["num_nodes"] == MATRIX_CPU_NODES]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(MATRIX_CPU_WORKERS, mp_context=ctx) as pool:
        futures = {k: pool.submit(cpu_row, k, MATRIX_ROWS[k], gpu)
                   for k in cpu_keys}
        for key, (bindings, job) in jobs.items():
            if job is not None:
                replay_check(out[key], bindings, job)
        for key, fut in futures.items():
            cpu_cell, cpu, lines = fut.result()
            for line in lines:
                log(line)
            cell = out[key]
            cell["cpu"] = {k: cpu_cell[k] for k in (
                "pods_per_s", "latency_p50_s", "latency_p99_s", "window_s",
                "wall_s", "session_kind", "bound")}
            bindings = jobs[key][0]
            diff = sorted(k for k, v in cpu.items() if bindings.get(k) != v)
            cell["cpu_differs"] = len(diff)
            if diff or len(cpu) != len(bindings):
                raise AssertionError(f"{cell['cell']}: {len(diff)} of "
                                     f"{len(bindings)} bindings differ "
                                     f"between the card and the CPU, first "
                                     f"{diff[:5]}")
    for key, cell in out.items():
        if key in MATRIX_ROWS:
            log(f"phase {cell['cell']}: checks held: " + "; ".join(
                cell["held"] + [f"{k} {cell[k]}" for k in (
                    "replay_differs", "replay_missing", "replay_s",
                    "cpu_differs") if k in cell]) + f" [{gpu}]")
    out["phase_s"] = time.perf_counter() - t0
    return out, total


# -- phase 16: the node-sharded mesh on the card -------------------------------

MESH_SHARDS = (1, 2, 3, 8)       # 16a's shard counts, each in both layouts
MESH_PROFILED_PODS = 16          # 16a's pods under torch.profiler, a layout
MESH_NODE_CHURN = 64             # 16b's node leaves, and as many joins
MESH_POD_CHURN = 512             # 16b's pod events between them
MESH_CHURN_PODS = 1024           # 16b's batches (before, after the churn)
MESH_PREEMPTORS = 64             # 16d's preemptors a Preemption row
MESH_LADDER_PODS = 512           # 16e's batches (the hoisted rung)
MESH_ROWS = {                    # scripts/bench_configs.py:305-316
    "mesh20k": dict(name="Mesh-20000n-8sh", num_nodes=20000,
                    num_init_pods=1024, num_pods=4096, mesh_devices=8,
                    max_batch=1024, timeout=1800.0),
    "mesh50k": dict(name="Mesh-50000n-8sh", num_nodes=50000,
                    num_init_pods=512, num_pods=2048, mesh_devices=8,
                    max_batch=512, timeout=2400.0),
    "mesh100k": dict(name="Mesh-100000n-8sh", num_nodes=100000,
                     num_init_pods=256, num_pods=1024, mesh_devices=8,
                     max_batch=256, timeout=3600.0),
}


def mesh_of(nsh, split, device="cuda:0"):
    """`nsh` shards on one card: one group of nsh shards, or (`split`)
    nsh one-shard groups — the cross-group collectives on one card."""
    from kubernetes_tpu_torch.parallel.sharded import make_mesh

    return make_mesh(devices=[device] * (nsh if split else 1),
                     n_devices=nsh)


def mesh_layouts():
    return [mesh_of(nsh, split) for nsh in MESH_SHARDS
            for split in ((False, True) if nsh > 1 else (False,))]


def gathered_vs(sh, carry, label):
    """A sharded session's gathered carries against a ScanSession's carry
    on its Np lanes (kcnt: the shards' partials sum to its totals), the
    lanes past Np untouched."""
    import numpy as np

    got = sh.gathered_carry()
    for k, v in carry.items():
        v = v.cpu().numpy()
        if k == "kcnt":
            ok = np.array_equal(v[:, 0], got[k].sum(1))
        else:
            ok = (np.array_equal(v, got[k][:, :v.shape[1]])
                  and not got[k][:, v.shape[1]:].any())
        if not ok:
            raise AssertionError(f"{label}: gathered carry {k} differs from "
                                 "ScanSession's")


def mesh_session_cell(sk, gpu, label, snapshot, templates, pods,
                      meshes=None):
    """16a on one cell: ScanSession and ShardedScanSession at every shard
    count of MESH_SHARDS in both layouts, each from the encoding
    `snapshot`, schedule `pods` in one batch: decisions, score and
    n_feasible equal, the gathered carries equal ScanSession's. ms per
    pod by the host window (enqueue to the rows read back), and under
    torch.profiler over MESH_PROFILED_PODS more pods the kernels per pod
    and the card's busy share."""
    import torch
    from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
    from kubernetes_tpu_torch.ops.scan import ScanSession
    from kubernetes_tpu_torch.ops.sharded_scan import ShardedScanSession

    n = len(pods)
    cluster = cluster_from_numpy(snapshot, "cuda")
    ss = ScanSession(cluster, templates, multipod_k=1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ss.schedule(pods)["rows"][:3, :n].cpu()
    scan_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for mesh in meshes or mesh_layouts():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sh = ShardedScanSession(cluster, templates, mesh=mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        reset_counts(sk)
        t0 = time.perf_counter()
        got = sh.schedule(pods)["rows"][:3, :n].cpu()
        host_ms = (time.perf_counter() - t0) * 1e3
        if sk.LAUNCHES:
            raise AssertionError(f"{label} {mesh.layout}: the step launched "
                                 f"{sk.VARIANT_LAUNCHES}")
        if not torch.equal(got, want):
            bad = int((got != want).any(0).sum())
            raise AssertionError(f"{label} {mesh.layout}: {bad} of {n} pods' "
                                 "best / score / n_feasible differ from "
                                 "ScanSession's")
        gathered_vs(sh, ss._carry, f"{label} {mesh.layout}")
        replays = sh.graph_replays
        busy = device_busy(lambda: sh.schedule(pods[:MESH_PROFILED_PODS]),
                           MESH_PROFILED_PODS)
        row = {"layout": mesh.layout, "shards": mesh.nsh,
               "groups": len(mesh.groups), "devices": mesh.n_devices,
               "Npl": sh.Npl, "UR": sh.UR, "build_s": build_s,
               "ms_per_pod": host_ms / n, "pods_per_s": n / host_ms * 1e3,
               "graph_replays": replays, **busy}
        rows.append(row)
        log(f"phase 16a {label} {mesh.layout} ({mesh.nsh} shards in "
            f"{len(mesh.groups)} groups on {mesh.n_devices} device, Npl "
            f"{sh.Npl}): {n} pods == ScanSession (best, score, n_feasible; "
            f"gathered carries); build {build_s:.3f} s; {host_ms / n:.4f} ms "
            f"per pod ({n / host_ms * 1e3:.1f} pods/s, {replays} graph "
            f"replays); under the profiler ({MESH_PROFILED_PODS} pods) "
            f"{busy['kernels_per_pod']:.1f} kernels per pod, the card busy "
            f"{busy['busy_ms']:.3f} of {busy['window_ms']:.3f} ms "
            f"({busy['busy_share']:.1%}) [{gpu}]")
        del sh
    log(f"phase 16a {label}: ScanSession {scan_ms / n:.4f} ms per pod on the "
        f"same {n} pods (one launch, wait included) [{gpu}]")
    return {"cell": label, "pods": n, "scan_session_ms_per_pod": scan_ms / n,
            "layouts": rows}


class DeltaCheck:
    """ops.sharded_scan's `carry_delta` wrapped for one phase: each launch
    is held against the plain version on a copy of its carry and the same
    inputs — `carry_delta_grouped`, the kernel's own order-free
    formulation in plain torch (tests/test_torch_delta_grid.py holds it to
    `carry_delta_reference` and the reference's `_carry_delta_scan`), a
    vectorized plain version where the event-by-event one takes a second
    a group; the launches are counted by the wrapper as always."""

    def __init__(self):
        from kubernetes_tpu_torch.ops import sharded_scan

        self.err, self.calls = 0, 0
        self._mod, self._orig = sharded_scan, sharded_scan.carry_delta
        check = self

        def launch(node, rows, statics, carry, shapes):
            from kubernetes_tpu_torch.ops.scan_kernel import (
                carry_delta_grouped,
            )

            plain = clone(carry)
            carry_delta_grouped(node, rows, statics, plain, shapes)
            check._orig(node, rows, statics, carry, shapes)
            check.err = max(check.err, carry_err(carry, plain))
            check.calls += 1

        sharded_scan.carry_delta = launch

    def close(self):
        self._mod.carry_delta = self._orig


def mesh_unscaled(sess, snapshot):
    """A sharded session's gathered carries and alloc in the encoding's
    units, on the valid lanes of `snapshot` (its node rows)."""
    import numpy as np

    valid = np.asarray(snapshot["valid"]).astype(bool)
    N, g, R = valid.shape[0], sess._gcd, sess.R
    c = {k: v.astype(np.int64) for k, v in sess.gathered_carry().items()
         if k in ("requested", "nzpc", "cnt_fn", "cnt_sn")}
    c["requested"] = c["requested"][:R] * g[:, None]
    c["nzpc"][:2] *= g[:2, None]
    c["alloc"] = sess._alloc[:R].astype(np.int64) * g[:, None]
    return {k: v[:, :N][:, valid] for k, v in c.items()}


def mesh_flush(sk, sess, deltas, label):
    """One apply_deltas on a sharded session under a DeltaCheck: every
    group's scan_delta launch == plain; -> (launches, ms)."""
    import torch

    check = DeltaCheck()
    reset_counts(sk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        sess.apply_deltas(deltas)
        torch.cuda.synchronize()
    finally:
        check.close()
    ms = (time.perf_counter() - t0) * 1e3
    launches = sk.VARIANT_LAUNCHES["scan_delta"]
    if check.err or launches != check.calls or sk.LAUNCHES != launches:
        raise AssertionError(f"{label}: scan_delta max abs err {check.err} "
                             f"against the plain version, launches "
                             f"{sk.VARIANT_LAUNCHES}")
    return launches, ms


def mesh_churn_zone(sk, gpu, zone, churn0, meshes=None):
    """16b (i): phase 9's 4096-event flush into nsh = 8 sessions built
    from the encoding before the churn, in both layouts (one group: one
    launch; eight groups: one a group, the other groups' event nodes as
    extra lanes): each launch == plain; the carries equal ScanSession's
    after the same flush and a fresh sharded session's from the encoding
    after it (unscaled, valid lanes); the next batch decides as both."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
    from kubernetes_tpu_torch.ops.scan import ScanSession
    from kubernetes_tpu_torch.ops.sharded_scan import ShardedScanSession

    pre, post = churn0["pre_churn"], churn0["post_churn"]
    # the next batch: phase 9's first MESH_CHURN_PODS (eight groups take
    # 2.7 ms a pod)
    deltas = churn0["deltas"]
    batch = churn0["next_batch"][:MESH_CHURN_PODS]
    templates = zone["templates"]
    ss = ScanSession(cluster_from_numpy(pre, "cuda"), templates,
                     multipod_k=1, device="cuda")
    ss._carry = ss._initial_carry()
    ss.apply_deltas(deltas)
    want_next = ScanSession.decisions(ss.schedule(batch))
    out = []
    for mesh in meshes or (mesh_of(8, False), mesh_of(8, True)):
        label = f"16b zone flush {mesh.layout}"
        sh = ShardedScanSession(cluster_from_numpy(pre, "cuda"), templates,
                                mesh=mesh)
        launches, ms = mesh_flush(sk, sh, deltas, label)
        if launches != len(mesh.groups):
            raise AssertionError(f"{label}: {launches} launches for "
                                 f"{len(mesh.groups)} groups")
        fresh = ShardedScanSession(cluster_from_numpy(post, "cuda"),
                                   templates, mesh=mesh)
        got, want = mesh_unscaled(sh, post), mesh_unscaled(fresh, post)
        diff = [k for k in want if not np.array_equal(got[k], want[k])]
        if diff:
            raise AssertionError(f"{label}: {diff} differ from a rebuild's")
        ref = ScanSession(cluster_from_numpy(pre, "cuda"), templates,
                          multipod_k=1, device="cuda")
        ref._carry = ref._initial_carry()
        ref.apply_deltas(deltas)
        gathered_vs(sh, ref._carry, label)
        nxt = [ShardedScanSession.decisions(s.schedule(batch))
               for s in (sh, fresh)]
        if nxt[0] != want_next or nxt[1] != want_next:
            raise AssertionError(f"{label}: the next batch decides otherwise "
                                 "than ScanSession and a rebuild")
        out.append({"layout": mesh.layout, "events": len(deltas),
                    "launches": launches, "ms": ms})
        log(f"phase {label}: {len(deltas)} events in {launches} scan_delta "
            f"launch(es), each == plain (max abs err 0), apply_deltas "
            f"{ms:.1f} ms with the plain checks; carries == ScanSession's "
            f"after the same flush and == a rebuild's (unscaled, valid "
            f"lanes); the next {len(batch)} pods decide as both [{gpu}]")
        del sh, fresh, ref
    return out


def mesh_churn_nodes(sk, gpu):
    """16b (ii): node churn into a live nsh = 8 session (eight one-shard
    groups) on a hostname-only cluster (the node-delta envelope:
    synth_cluster(5000, pods_per_node=1), plain pending pods): a batch
    bound, then MESH_NODE_CHURN pod-free nodes leave, MESH_POD_CHURN pod
    events, the nodes join again under their names (LIFO: their lanes),
    MESH_POD_CHURN more pod events — every event a delta, the node ones
    lane-column writes between the scan_delta runs. The carries then equal
    a rebuild's (unscaled, valid lanes) and the next batch decides as the
    rebuild and a fresh ScanSession do."""
    import random

    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops.scan import ScanSession
    from kubernetes_tpu_torch.ops.sharded_scan import ShardedScanSession
    from kubernetes_tpu_torch.testing import churn
    from kubernetes_tpu_torch.testing.synth import (
        make_pod,
        synth_cluster,
        synth_pending_pods,
    )

    rng = random.Random(16)
    nodes, init_pods = synth_cluster(5000, pods_per_node=1)
    pending = synth_pending_pods(2 * MESH_CHURN_PODS)
    foreign = [make_pod(f"foreign-{i}", cpu="100m", memory="128Mi",
                        labels={"app": f"init-{i % 8}"})
               for i in range(MESH_POD_CHURN)]
    enc, pe = presized_encoding(nodes, init_pods, pending + foreign)
    batches, templates = encode_templates(pe, pending)
    mesh = mesh_of(8, True)
    label = f"16b node churn {mesh.layout}"
    sh = ShardedScanSession(enc.device_state("cuda"), templates, mesh=mesh)
    if not sh._node_delta_ok:
        raise AssertionError(f"{label}: outside the node-delta envelope")
    first = batches[:MESH_CHURN_PODS]
    for pod, best in zip(pending, ShardedScanSession.decisions(
            sh.schedule(first))):
        if best >= 0:
            pod.spec.node_name = enc.node_names[best]
            enc.add_pod(pod, pod.spec.node_name)
    free = [n.metadata.name for n in nodes
            if not enc._arrays["pod_count"][enc.node_index[n.metadata.name]]]
    gone = rng.sample(free, MESH_NODE_CHURN)
    live = [n for n in (x.metadata.name for x in nodes) if n not in gone]
    deltas = []

    def pod_events(lo):
        for i, p in enumerate(foreign[lo:lo + MESH_POD_CHURN // 2]):
            p.spec.node_name = rng.choice(live)
            deltas.append(churn.pod_delta(
                sh, enc, p, p.spec.node_name, 1,
                lambda p=p: enc.add_pod(p, p.spec.node_name)))
        placed = [p for p in pending[:MESH_CHURN_PODS] if p.spec.node_name]
        for p in rng.sample(placed, MESH_POD_CHURN // 2):
            deltas.append(churn.pod_delta(
                sh, enc, p, p.spec.node_name, -1,
                lambda p=p: enc.remove_pod(p)))
            p.spec.node_name = ""

    for name in gone:
        deltas.append(sh.node_leave_delta(enc.remove_node(name)))
    pod_events(0)
    by_name = {n.metadata.name: n for n in nodes}
    for name in reversed(gone):
        lane = enc.add_node(by_name[name])
        deltas.append(sh.node_join_delta(enc.node_slice_cluster(lane), lane))
    pod_events(MESH_POD_CHURN // 2)
    if any(d is None for d in deltas):
        raise AssertionError(f"{label}: {sum(d is None for d in deltas)} "
                             "events refused as structural")
    kinds = {}
    for d in deltas:
        kinds[d["kind"]] = kinds.get(d["kind"], 0) + 1
    launches, ms = mesh_flush(sk, sh, deltas, label)
    post = enc.host_snapshot()
    fresh = ShardedScanSession(enc.device_state("cuda"), templates,
                               mesh=mesh)
    got, want = mesh_unscaled(sh, post), mesh_unscaled(fresh, post)
    diff = [k for k in want if not np.array_equal(got[k], want[k])]
    if diff:
        raise AssertionError(f"{label}: {diff} differ from a rebuild's")
    second = batches[MESH_CHURN_PODS:]
    ss = ScanSession(enc.device_state("cuda"), templates, multipod_k=1,
                     device="cuda")
    nxt = [type(s).decisions(s.schedule(second)) for s in (sh, fresh, ss)]
    if nxt[0] != nxt[1] or nxt[0] != nxt[2]:
        raise AssertionError(f"{label}: the next batch decides otherwise "
                             "than a rebuild and ScanSession")
    placed = sum(d >= 0 for d in nxt[0])
    torch.cuda.synchronize()
    log(f"phase {label}: {kinds} into the live session in {launches} "
        f"scan_delta launches (each == plain, max abs err 0) and the "
        f"lane-column writes between them, apply_deltas {ms:.1f} ms with the "
        f"plain checks; carries == a rebuild's (unscaled, valid lanes); the "
        f"next {len(second)} pods ({placed} placed) decide as the rebuild "
        f"and ScanSession [{gpu}]")
    return {"layout": mesh.layout, "events": kinds, "launches": launches,
            "ms": ms}


def mesh_loop(sk, gpu, key="mesh20k"):
    """16c: a MESH_ROWS row through `run_workload` on the card, unreduced:
    every batch on ShardedScanSession at the kernel rung; the bindings
    equal the same row on the single-device loop and a `schedule_many`
    replay of the loop's batches."""
    from kubernetes_tpu_torch.perf import harness

    spec = MESH_ROWS[key]
    out, bindings, run, _, nodes = loop_cell(
        sk, gpu, f"16c {key}", matrix_workload(harness, spec))
    rungs = out["rungs"]
    if set(rungs) != {"ShardedScanSession/kernel"} \
            or out["session_kind"] != "ShardedScanSession":
        raise AssertionError(f"16c {key}: batches on {rungs}, session "
                             f"{out['session_kind']}")
    # the replay needs the batches alone: the run's apiserver and caches
    # go before the next run builds its own (at 100000 nodes two worlds
    # do not fit the host)
    job = (run.batches, nodes, None, run.oracle_pods)
    del run
    gc.collect()
    single, single_bindings, _, _, _ = loop_cell(
        sk, gpu, f"16c {key} single-device",
        matrix_workload(harness, spec, mesh_devices=0))
    gc.collect()
    diff = sorted(k for k, v in bindings.items()
                  if single_bindings.get(k) != v)
    if diff or len(bindings) != len(single_bindings):
        raise AssertionError(f"16c {key}: {len(diff)} bindings differ from "
                             f"the single-device loop's (first {diff[:5]})")
    replay_check(out, bindings, job)
    log(f"phase 16c {key}: bindings == the single-device loop's "
        f"({single['pods_per_s']} pods/s, latency p50 "
        f"{single['latency_p50_s']} s, p99 {single['latency_p99_s']} s) and "
        f"== a schedule_many replay ({out['replay_s']:.1f} s) [{gpu}]")
    return {"mesh": out, "single": single}


def mesh_whatif(sk, gpu):
    """16d: the three Preemption rows' clusters (500 nodes, 2000
    priority-1 pods four to a node, the rows' victim labels and PDB), the
    first MESH_PREEMPTORS preemptors of each planned by the device rung on
    an nsh = 8 backend and on a single-device one: equal plans (node and
    victims), every preemptor on the device path; the mesh's what-if
    launches counted, each held to the plain walk."""
    import torch
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.ops import whatif_kernel as wk
    from kubernetes_tpu_torch.perf.harness import PodTemplate
    from kubernetes_tpu_torch.scheduler.framework.snapshot import Snapshot
    from kubernetes_tpu_torch.scheduler.internal.nominator import (
        PodNominator,
    )
    from kubernetes_tpu_torch.scheduler.preemption_device import (
        DevicePreemptionPlanner,
    )
    from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend
    from kubernetes_tpu_torch.testing.synth import make_node

    out, launches, mins, contexts, checked, errs = [], 0, 0, 0, 0, 0
    for label, spec, init, template in PREEMPTION_ROWS:
        n_nodes = spec["num_nodes"]
        nodes = [make_node(f"node-{i}", labels={
            v1.LABEL_HOSTNAME: f"node-{i}",
            v1.LABEL_ZONE: f"zone-{i % 3}",
            v1.LABEL_REGION: f"region-{i % 3 % 2}"})
            for i in range(n_nodes)]
        lo = PodTemplate(cpu="900m", memory="64Mi", priority=1, **init)
        hi = PodTemplate(cpu="900m", memory="64Mi", priority=100,
                         **template)
        victims = []
        for i in range(spec["num_init_pods"]):
            p = lo.build(f"init-{i}")
            p.spec.node_name = f"node-{i % n_nodes}"
            victims.append(p)
        wave = [hi.build(f"measure-{i}") for i in range(MESH_PREEMPTORS)]
        pdbs = None
        if spec.get("pdb_disruptions_allowed") is not None:
            pdbs = [v1.PodDisruptionBudget(
                metadata=v1.ObjectMeta(name="bench-pdb", namespace="default"),
                spec=v1.PodDisruptionBudgetSpec(selector=v1.LabelSelector(
                    match_labels=dict(lo.labels or {}))),
                status=v1.PodDisruptionBudgetStatus(
                    disruptions_allowed=spec["pdb_disruptions_allowed"]))]
        fast_ok = not template.get("pod_affinity_zone")
        elig = {v1.pod_key(p): (True, fast_ok) for p in wave}
        plans = []
        for mesh in (mesh_of(8, False), None):
            be = TPUBackend(mesh=mesh)
            for n in nodes:
                be.on_add_node(n)
            for p in victims:
                be.on_add_pod(p, p.spec.node_name)
            snapshot = Snapshot.from_objects(victims, nodes)
            watch = WhatifWatch(keep=WHATIF_KEEP) if mesh else None
            k0, m0, c0 = wk.LAUNCHES, wk.MINS_LAUNCHES, wk.CONTEXT_LAUNCHES
            t0 = time.perf_counter()
            try:
                pl = DevicePreemptionPlanner(snapshot, PodNominator(), be,
                                             pdbs=pdbs, eligibility=elig)
                cands = pl.plan(list(wave))
                torch.cuda.synchronize()
            finally:
                if watch is not None:
                    watch.close()
            ms = (time.perf_counter() - t0) * 1e3 / len(wave)
            if set(pl.planner_paths) != {"device"}:
                raise AssertionError(f"16d {label}: planner paths "
                                     f"{pl.planner_paths}")
            if mesh is not None:
                launches += wk.LAUNCHES - k0
                mins += wk.MINS_LAUNCHES - m0
                contexts += wk.CONTEXT_LAUNCHES - c0
                checked += len(watch.calls) + len(watch.contexts)
                errs = max(errs, walk_errs(watch.calls, watch.contexts))
                mesh_ms, builds = ms, be.whatif_builds
            plans.append([cand_key(c) for c in cands])
            be.close()
        if plans[0] != plans[1]:
            bad = sum(a != b for a, b in zip(*plans))
            raise AssertionError(f"16d {label}: {bad} of {len(wave)} plans "
                                 "differ from the single-device device rung's")
        found = sum(c is not None for c in plans[0])
        out.append({"cell": label, "row": spec["name"],
                    "preemptors": len(wave), "with_victims": found,
                    "mesh_ms_per_preemptor": mesh_ms,
                    "single_ms_per_preemptor": ms,
                    "context_builds": builds})
        log(f"phase 16d {label} {spec['name']}: {len(wave)} preemptors on an "
            f"8-shard backend plan as the single-device device rung "
            f"({found} with victims); {mesh_ms:.3f} ms a preemptor on the "
            f"mesh, {ms:.3f} single-device; what-if context builds "
            f"{builds} [{gpu}]")
    if errs or not launches or not contexts:
        raise AssertionError(f"16d: {launches} what-if and {contexts} context"
                             f" launches on the mesh, {errs} differing "
                             "outputs against the plain version")
    return out, {"launches": launches, "mins_launches": mins,
                 "context_launches": contexts, "checked": checked,
                 "err": errs}


def mesh_ladder(gpu, zone, decisions):
    """16e: the mesh backend's session ladder off the kernel rung: an
    explain build and a ladder-demoted build (TPUBackend's own session
    build over phase 4's encoding before its first batch) are
    HoistedSessions on the lead device, counted under their reasons;
    each decides MESH_LADDER_PODS of 16a's pods as 16a did."""
    import torch
    from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
    from kubernetes_tpu_torch.ops.hoisted import (
        HoistedSession,
        template_fingerprint,
    )
    from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend

    pods = zone["batch"][:MESH_LADDER_PODS]
    want = decisions[:MESH_LADDER_PODS]
    cluster = cluster_from_numpy(zone["snapshot0"], "cuda")
    be = TPUBackend(mesh=mesh_of(8, False))
    be.enc.device_state = lambda device=None: cluster
    be._known_templates = {template_fingerprint(t): t
                           for t in zone["templates"]}
    out = {}
    for reason in ("explain", "mesh-ladder-demoted"):
        be.explain = reason == "explain"
        if reason != "explain":
            be.ladder.demote()
        before = counters()
        t0 = time.perf_counter()
        with be._on_stream():
            sess = be._build_session_impl()
            got = HoistedSession.decisions(sess.schedule(pods))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        builds = {k: v for k, v in counters_delta(before)[
            "session_builds"].items() if v}
        if not isinstance(sess, HoistedSession) \
                or builds != {("hoisted", reason, "8"): 1.0}:
            raise AssertionError(f"16e {reason}: {type(sess).__name__}, "
                                 f"builds {builds}")
        if got != want:
            raise AssertionError(f"16e {reason}: decisions differ from 16a's")
        out[reason] = {"pods": len(pods), "ms_per_pod": ms / len(pods),
                       "builds": {"/".join(k): v for k, v in builds.items()}}
        log(f"phase 16e {reason}: the mesh backend's session build is a "
            f"HoistedSession on {sess.device} (builds {builds}); "
            f"{len(pods)} pods decide as 16a did; {ms / len(pods):.3f} ms "
            f"per pod, build included [{gpu}]")
    be.close()
    return out


def mesh_cards(sk, gpu):
    """16a and 16b's zone flush across every card of the machine (run
    alone on a multi-card machine; not a phase of `main`): 8 shards in
    one group a card, and one shard a card, against ScanSession on the
    first card. The cross-group reductions and the extra lanes of the
    flush then cross cards."""
    import random

    import torch
    from kubernetes_tpu_torch.ops.scan import ScanSession
    from kubernetes_tpu_torch.parallel.sharded import make_mesh
    from kubernetes_tpu_torch.testing.synth import (
        synth_cluster,
        synth_pending_pods,
    )

    n = torch.cuda.device_count()
    if n < 2:
        raise AssertionError(f"mesh_cards: {n} card(s)")
    cards = [f"cuda:{i}" for i in range(n)]
    meshes = [make_mesh(devices=cards, n_devices=8),
              make_mesh(devices=cards, n_devices=n)]
    nodes, init_pods = synth_cluster(5000, pods_per_node=2)
    pending = synth_pending_pods(2 * BATCH, spread=True)
    enc, pe = presized_encoding(nodes, init_pods, pending)
    arrays, templates = encode_templates(pe, pending)
    snapshot0 = enc.host_snapshot()
    # a quarter of 16a's batch: across cards the step runs eagerly
    out = {"16a": mesh_session_cell(sk, gpu, "zone spread 5000n",
                                    snapshot0, templates,
                                    arrays[BATCH:BATCH + BATCH // 4],
                                    meshes=meshes)}
    sess = ScanSession(enc.device_state("cuda"), templates, multipod_k=1,
                       device="cuda")
    for pod, best in zip(pending, ScanSession.decisions(
            sess.schedule(arrays[:BATCH]))):
        if best >= 0:
            pod.spec.node_name = enc.node_names[best]
            enc.add_pod(pod, pod.spec.node_name)
    d = {"enc": enc, "sess": sess, "pending": pending}
    events = churn_events(d, random.Random(9))
    pre = enc.host_snapshot()
    deltas, refused = classify(sess, enc, events)
    if refused:
        raise AssertionError(f"mesh_cards: {refused} events refused")
    nxt = synth_pending_pods(BATCH // 4, spread=True)
    for i, p in enumerate(nxt):
        p.metadata.name = f"next-{i}"
    churn0 = {"pre_churn": pre, "post_churn": enc.host_snapshot(),
              "deltas": deltas, "next_batch": [
                  {k: v for k, v in pe.encode(p).items()
                   if not k.startswith("_")} for p in nxt]}
    out["16b"] = mesh_churn_zone(sk, gpu, {"templates": templates}, churn0,
                                 meshes=meshes)
    return out


def phase_mesh(sk, gpu, zone, pref, churn0):
    """Phase 16: the node-sharded mesh (parallel/, ops/sharded_scan.py,
    TPUBackend(mesh=)) on the card. -> (numbers, scan_delta launches and
    their check, what-if launches and their check)."""
    import torch
    from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
    from kubernetes_tpu_torch.ops.scan import ScanSession

    # the earlier phases' heap out of the collector's reach (as phase 15
    # does for its rows): a full collection over it would land in the
    # windows below
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    marks = {}

    def mark(label):
        marks[label] = round(time.perf_counter() - t0 - sum(marks.values()),
                             1)

    out = {"16a": [
        mesh_session_cell(sk, gpu, "zone spread 5000n", zone["snapshot0"],
                          zone["templates"], zone["batch"]),
        mesh_session_cell(sk, gpu, pref["cell"], pref["snapshot0"],
                          pref["templates"], pref["batch"])]}
    mark("16a")
    out["16b"] = mesh_churn_zone(sk, gpu, zone, churn0)
    out["16b"].append(mesh_churn_nodes(sk, gpu))
    delta_launches = sum(c["launches"] for c in out["16b"])
    gc.collect()
    torch.cuda.empty_cache()
    mark("16b")
    out["16c"] = mesh_loop(sk, gpu)
    mark("16c")
    out["16d"], whatif = mesh_whatif(sk, gpu)
    mark("16d")
    ss = ScanSession(cluster_from_numpy(zone["snapshot0"], "cuda"),
                     zone["templates"], multipod_k=1, device="cuda")
    out["16e"] = mesh_ladder(gpu, zone, ScanSession.decisions(
        ss.schedule(zone["batch"][:MESH_LADDER_PODS])))
    mark("16e")
    out["phase_s"] = time.perf_counter() - t0
    gc.unfreeze()
    log(f"phase 16 seconds: {marks}, {out['phase_s']:.1f} in all")
    out["seconds"] = marks
    return out, delta_launches, whatif


# phase 17: the workload controllers and admission feeding
# the card's scheduler, on Default-5000n-10k's nodes
# (scripts/bench_configs.py:64-69, synth_cluster(5000), 3 zones; never
# cut). Its pods are cut by 4 for the 900 s budget: the controllers' host
# work grows faster than their pods (a ReplicaSet sync walks every pod, on
# every pod event), and 2048 / 1024 / 512 took 129 s.
CTRL_NODES = 5000
CTRL_REPLICAS = 512              # 17a's Deployment (cut from 2048)
CTRL_ANTI_REPLICAS = 256         # 17b's Deployment (cut from 1024)
CTRL_STALE = 32                  # 17c's nodes that stop heartbeating
CTRL_GRACE = 8.0                 # 17c's node_monitor_grace_period, s
CTRL_MONITOR = 0.2               # 17c's node_monitor_period, s
CTRL_JOB_PODS = 128              # 17d's Job, parallelism (cut from 512)
CTRL_POOL = 64                   # 17d's DaemonSet pool (the last nodes)
CTRL_MAX_BATCH = 2048            # the Default-5000n-10k row's max_batch
CTRL_WAIT = 240.0                # the longest any wait of the phase may take


def fast_failover(v1):
    """A toleration that names node.kubernetes.io/unreachable:NoExecute
    with a value the node lifecycle controller's taint does not carry.
    Naming the key and effect keeps DefaultTolerationSeconds admission
    from adding its 300 s toleration; not matching the taint makes the pod
    leave an unreachable node at once (tolerationSeconds 0 says so too)
    and keeps the scheduler from placing its replacement there: that
    controller adds no unreachable:NoSchedule taint (upstream's
    doNoScheduleTaintingPass does)."""
    return v1.Toleration(key=v1.TAINT_NODE_UNREACHABLE, operator="Equal",
                         value="partitioned", effect="NoExecute",
                         toleration_seconds=0)


def ctrl_template(v1, labels, image="app:1", spread=False, anti=False,
                  failover=False):
    """A controller's pod template with the Default-5000n-10k row's
    requests (100m, 128Mi): `spread` a zone spread (DoNotSchedule, maxSkew
    1) over pods with these labels; `anti` a weight-100 preferred pod
    anti-affinity on the hostname against them; `failover` fast_failover's
    toleration."""
    spec = v1.PodSpec(containers=[v1.Container(
        name="c", image=image, resources=v1.ResourceRequirements(
            requests={"cpu": "100m", "memory": "128Mi"}))])
    if spread:
        spec.topology_spread_constraints = [v1.TopologySpreadConstraint(
            max_skew=1, topology_key=v1.LABEL_ZONE,
            when_unsatisfiable="DoNotSchedule",
            label_selector=v1.LabelSelector(match_labels=dict(labels)))]
    if anti:
        spec.affinity = affinity(v1, "pref-anti", labels, v1.LABEL_HOSTNAME)
    if failover:
        spec.tolerations = [fast_failover(v1)]
    return v1.PodTemplateSpec(metadata=v1.ObjectMeta(labels=dict(labels)),
                              spec=spec)


def web_deployment(v1, apps, name, replicas, version, image):
    """A stateless service's Deployment (maxSurge and maxUnavailable 25 %):
    its pods spread over the zones per version, so that each ReplicaSet
    spreads on its own (as matchLabelKeys: [pod-template-hash] does
    upstream), and leave an unreachable node at once."""
    return apps.Deployment(
        metadata=v1.ObjectMeta(name=name, namespace="default"),
        spec=apps.DeploymentSpec(
            replicas=replicas,
            selector=v1.LabelSelector(match_labels={"app": name}),
            template=ctrl_template(v1, {"app": name, "version": version},
                                   image, spread=True, failover=True),
            strategy=apps.DeploymentStrategy(
                type="RollingUpdate",
                rolling_update=apps.RollingUpdateDeployment(
                    max_surge="25%", max_unavailable="25%"))))


class StatusWriter:
    """Stand-in for the kubelets, which the port does not have yet, as
    tests/test_controllers.py `mark_running_ready` is: every pod bound to a
    node is marked Running and Ready through the apiserver, a Job's pod
    Succeeded (held while `hold_jobs` is set); and each node's lease
    renewed on `heartbeat`. Records when each pod was added, bound and
    deleted (the phase's clock), and how often a pod was bound."""

    def __init__(self, cs, factory):
        import queue
        import threading

        from kubernetes_tpu_torch.client.informer import EventHandler

        self.cs = cs
        self.q = queue.Queue()
        self._lock = threading.Lock()
        self.added, self.bound, self.deleted = {}, {}, {}
        self.bind_counts = {}
        self.hold_jobs, self.held = True, []
        self._thread = None
        factory.pods().add_event_handler(EventHandler(
            on_add=self._on_add, on_update=self._on_update,
            on_delete=self._on_delete))

    @staticmethod
    def key(pod):
        return f"{pod.metadata.namespace}/{pod.metadata.name}"

    def _on_add(self, pod):
        self.added.setdefault(self.key(pod), time.perf_counter())
        if pod.spec.node_name:
            self._on_bind(pod)

    def _on_update(self, old, new):
        if new.spec.node_name and not old.spec.node_name:
            self._on_bind(new)

    def _on_bind(self, pod):
        key = self.key(pod)
        self.bound[key] = (pod.spec.node_name, time.perf_counter())
        self.bind_counts[key] = self.bind_counts.get(key, 0) + 1
        self.q.put(key)

    def _on_delete(self, pod):
        self.deleted[self.key(pod)] = time.perf_counter()

    def start(self):
        import threading

        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="status-writer")
        self._thread.start()

    def stop(self):
        self.q.put(None)
        self._thread.join(timeout=10)

    def release_jobs(self):
        with self._lock:
            self.hold_jobs = False
            held, self.held = self.held, []
        for key in held:
            self.q.put(key)

    def _loop(self):
        from kubernetes_tpu_torch.apiserver.server import Conflict, NotFound

        while True:
            key = self.q.get()
            if key is None:
                return
            ns, name = key.split("/", 1)
            for _ in range(8):
                try:
                    pod = self.cs.pods.get(name, ns)
                except NotFound:
                    break
                job = any(r.kind == "Job"
                          for r in pod.metadata.owner_references or [])
                with self._lock:
                    hold = job and self.hold_jobs
                    if hold:
                        self.held.append(key)
                if hold:
                    break
                self._mark(pod, job)
                try:
                    self.cs.pods.update_status(pod)
                    break
                except NotFound:
                    break
                except Conflict:
                    continue

    @staticmethod
    def _mark(pod, job):
        from kubernetes_tpu_torch.api import types as v1

        if job:
            pod.status.phase = "Succeeded"
            return
        pod.status.phase = "Running"
        pod.status.start_time = time.time()
        pod.status.conditions = [v1.PodCondition(type="Ready",
                                                 status="True")]

    def heartbeat(self, names):
        """The kubelets' lease renewals (kube-node-lease/<node>)."""
        from kubernetes_tpu_torch.api import types as v1
        from kubernetes_tpu_torch.apiserver.server import NotFound

        leases = self.cs.resource("leases")
        now = time.time()
        for name in names:
            try:
                lease = leases.get(name, "kube-node-lease")
            except NotFound:
                leases.create(v1.Lease(
                    metadata=v1.ObjectMeta(name=name,
                                           namespace="kube-node-lease"),
                    spec=v1.LeaseSpec(holder_identity=name, renew_time=now)))
                continue
            lease.spec.renew_time = now
            leases.update(lease)


class SyncErrors:
    """Counts the controllers' failed syncs by wrapping each controller's
    sync entry points on the instance (the modules stay as they are):
    a Conflict or AlreadyExists is the informer-lag retry the workers
    expect and is counted apart; anything else is an error."""

    def __init__(self):
        import threading

        self.errors, self.retries = {}, {}
        self._lock = threading.Lock()

    def count(self, counts, label):
        with self._lock:
            counts[label] = counts.get(label, 0) + 1

    def wrap(self, ctrl, *names):
        from kubernetes_tpu_torch.apiserver.server import (
            AlreadyExists,
            Conflict,
        )

        for name in names:
            fn = getattr(ctrl, name)
            label = f"{ctrl.name}.{name}"

            def wrapped(*args, _fn=fn, _label=label, **kwargs):
                try:
                    return _fn(*args, **kwargs)
                except (AlreadyExists, Conflict):
                    self.count(self.retries, _label)
                    raise
                except Exception:
                    self.count(self.errors, _label)
                    raise

            setattr(ctrl, name, wrapped)
        return ctrl


def wait_for(cond, label, timeout=CTRL_WAIT, interval=0.05):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{label}: not within {timeout:.0f} s")
        time.sleep(interval)


def zone_skew(pods, zone_of):
    zones = {z: 0 for z in set(zone_of.values())}
    for p in pods:
        zones[zone_of[p.spec.node_name]] += 1
    return max(zones.values()) - min(zones.values())


def quantiles(xs):
    if not xs:
        return None, None
    xs = sorted(xs)
    return (statistics.median(xs),
            xs[min(len(xs) - 1, int(round(0.99 * (len(xs) - 1))))])


class ControllerWorld:
    """Phase 17's cluster: the port's APIServer with the default admission
    chain, one SharedInformerFactory, the Scheduler of
    `scheduler.factory.create_scheduler` (the default profile, max_batch
    2048, TPUBackend on `device`), the controllers started by hand, and
    the StatusWriter; `CTRL_NODES` nodes of synth_cluster (the last
    `CTRL_POOL` labelled pool=agents) registered Ready with their leases. A
    NodeLifecycleController with a long grace period lifts the not-ready
    taint admission puts on each new node; 17c swaps it for a short one."""

    def __init__(self, sk, device="cuda"):
        from kubernetes_tpu_torch.api import types as v1
        from kubernetes_tpu_torch.apiserver import APIServer
        from kubernetes_tpu_torch.apiserver.admission import (
            install_default_admission,
        )
        from kubernetes_tpu_torch.client import (
            Clientset,
            SharedInformerFactory,
        )
        from kubernetes_tpu_torch.client.informer import EventHandler
        from kubernetes_tpu_torch.controllers.daemonset import (
            DaemonSetController,
        )
        from kubernetes_tpu_torch.controllers.deployment import (
            DeploymentController,
        )
        from kubernetes_tpu_torch.controllers.endpoints import (
            EndpointsController,
        )
        from kubernetes_tpu_torch.controllers.job import JobController
        from kubernetes_tpu_torch.controllers.namespace import (
            NamespaceController,
        )
        from kubernetes_tpu_torch.controllers.replicaset import (
            ReplicaSetController,
        )
        from kubernetes_tpu_torch.controllers.statefulset import (
            StatefulSetController,
        )
        from kubernetes_tpu_torch.controllers.volumeprotection import (
            PVCProtectionController,
            PVProtectionController,
        )
        from kubernetes_tpu_torch.scheduler.apis.config import (
            default_configuration,
        )
        from kubernetes_tpu_torch.scheduler.factory import create_scheduler
        from kubernetes_tpu_torch.testing.synth import synth_cluster

        t0 = time.perf_counter()
        self.sk, self.device, self.v1 = sk, device, v1
        self.api = APIServer()
        install_default_admission(self.api)
        self.cs = Clientset(self.api)
        nodes, _ = synth_cluster(CTRL_NODES)
        now = time.time()
        for i, node in enumerate(nodes):
            if i >= CTRL_NODES - CTRL_POOL:
                node.metadata.labels["pool"] = "agents"
            node.status.conditions = [v1.NodeCondition(
                type="Ready", status="True", last_heartbeat_time=now)]
            self.cs.nodes.create(node)
        self.names = [n.metadata.name for n in nodes]
        self.pool = set(self.names[CTRL_NODES - CTRL_POOL:])
        self.zone_of = {n.metadata.name: n.metadata.labels[v1.LABEL_ZONE]
                        for n in nodes}
        self.factory = SharedInformerFactory(self.cs)
        cfg = default_configuration()
        cfg.max_batch = CTRL_MAX_BATCH
        self.run = LoopRun(device == "cuda")
        self.sched = create_scheduler(self.cs, self.factory, cfg,
                                      device=device)
        self.be = self.sched.tpu
        self._watch_sessions()
        pods = 2 * CTRL_REPLICAS + CTRL_ANTI_REPLICAS + CTRL_JOB_PODS \
            + CTRL_POOL
        self.be.enc.reserve(pods=int(pods * 1.25),
                            score_terms=int(CTRL_ANTI_REPLICAS * 1.25))
        self.writer = StatusWriter(self.cs, self.factory)
        self.writer.heartbeat(self.names)
        self.heartbeat_t = time.time()
        self.tainted = {}
        self.factory.nodes().add_event_handler(EventHandler(
            on_update=self._on_node))
        self.errors = SyncErrors()
        self.controllers = [self.errors.wrap(c, "sync") for c in (
            ReplicaSetController(self.cs, self.factory),
            DeploymentController(self.cs, self.factory),
            DaemonSetController(self.cs, self.factory),
            StatefulSetController(self.cs, self.factory),
            JobController(self.cs, self.factory),
            NamespaceController(self.cs, self.factory),
            EndpointsController(self.cs, self.factory),
            PVCProtectionController(self.cs, self.factory),
            PVProtectionController(self.cs, self.factory))]
        self.nlc = self.lifecycle(period=1.0, grace=3600.0)
        self.gc = None
        self.factory.start()
        if not self.factory.wait_for_cache_sync(timeout=180.0):
            raise AssertionError("17: informer sync failed")
        for c in self.controllers:
            c.run()
        self.nlc.run()
        self.writer.start()
        self.sched.start()
        not_ready = v1.TAINT_NODE_NOT_READY
        wait_for(lambda: not any(
            t.key == not_ready for n in self.factory.nodes().list()
            for t in n.spec.taints or []), "17: the not-ready taints")
        self.setup_s = time.perf_counter() - t0

    def _watch_sessions(self):
        """Record each teardown request of the backend's session (its
        reason, and whether a session was live) and each build (the
        reason of the teardown before it, the session class)."""
        be = self.be
        self.invalidations, self.builds = [], []
        invalidate, build = be._invalidate_session, be._build_session

        def invalidate_session(reason="unspecified"):
            self.invalidations.append((reason, be._session is not None))
            invalidate(reason)

        def build_session():
            s = build()
            self.builds.append(f"{type(s).__name__}/"
                               f"{be._last_invalidate or 'initial'}")
            return s

        be._invalidate_session = invalidate_session
        be._build_session = build_session

    def lifecycle(self, period, grace):
        from kubernetes_tpu_torch.controllers.nodelifecycle import (
            NodeLifecycleController,
        )

        return self.errors.wrap(NodeLifecycleController(
            self.cs, self.factory, node_monitor_period=period,
            node_monitor_grace_period=grace),
            "monitor_node_health", "process_evictions")

    def _on_node(self, old, new):
        key = self.v1.TAINT_NODE_UNREACHABLE
        if any(t.key == key and t.effect == "NoExecute"
               for t in new.spec.taints or []):
            self.tainted.setdefault(new.metadata.name, time.perf_counter())

    def close(self):
        for c in self.controllers:
            c.stop()
        for c in (self.nlc, self.gc):
            if c is not None:
                c.stop()
        self.writer.stop()
        self.sched.shutdown()
        self.factory.stop()
        self.be.close()
        self.run.close()

    # -- reading the world (through the informers: a list from the
    # apiserver decodes every object, and polling it would hold the
    # interpreter that the controllers and the scheduler share) ----------

    def pods(self, **labels):
        return [p for p in self.factory.pods().list() if all(
            (p.metadata.labels or {}).get(k) == v for k, v in labels.items())]

    def nodes(self):
        return self.factory.nodes().list()

    def replicasets(self):
        return self.factory.informer_for("replicasets").list()

    def rs_of(self, app, version):
        for rs in self.replicasets():
            if rs.metadata.labels.get("app") == app and \
                    rs.metadata.labels.get("version") == version:
                return rs
        return None

    def available(self, app, version, want):
        rs = self.rs_of(app, version)
        return rs is not None and rs.status.available_replicas == want \
            and len(self.pods(app=app, version=version)) == want

    def idle(self):
        """The scheduler has nothing queued or in flight."""
        with self.sched._inflight_lock:
            busy = self.sched._inflight
        return not busy and self.sched.queue.num_active() == 0

    def checks(self, label, pods):
        """Every pod bound once, to one node; no node over its
        allocatable."""
        nodes = self.nodes()
        unbound = [p.metadata.name for p in pods if not p.spec.node_name]
        twice = {k: n for k, n in self.writer.bind_counts.items() if n > 1}
        over = overcommitted(self.pods(), nodes)
        if unbound or twice or over:
            raise AssertionError(f"{label}: unbound {unbound[:5]}, bound "
                                 f"twice {list(twice)[:5]}, nodes over "
                                 f"their allocatable {over[:5]}")

    def mark(self):
        """(batches, kernel events, counters, launches, session
        teardowns and builds) so far."""
        return (len(self.run.batches), len(self.run.events), counters(),
                dict(self.sk.VARIANT_LAUNCHES),
                dict(self.sk.CLUSTER_LAUNCHES), len(self.invalidations),
                len(self.builds))

    def since(self, mark, label, top=True):
        """What the case from `mark` on did: batches, their rungs, kernel
        ms (CUDA events), launches by variant and cluster size, session
        builds by kind (a kernel refusal's reason shows there) and by the
        teardown before them, teardown requests by reason ([calls, of a
        live session]), delta applies by kind; with `top`,
        every batch on the kernel session at the ladder's top rung and 0
        device faults."""
        b0, e0, c0, l0, k0, i0, s0 = mark
        delta = counters_delta(c0)
        events = [(a, b) for tag, a, b in self.run.events[e0:]
                  if tag != "replay"]
        if events:
            import torch

            torch.cuda.synchronize()
        rungs = {}
        for n, kind, mode in self.run.rungs[b0:]:
            r = rungs.setdefault(f"{kind}/{mode}", [0, 0])
            r[0] += 1
            r[1] += n
        ms = [a.elapsed_time(b) for a, b in events]
        out = {
            "batches": len(self.run.batches) - b0, "rungs": rungs,
            "launches": launched(self.sk, l0),
            "cluster_launches": {k: v - k0[k] for k, v in
                                 self.sk.CLUSTER_LAUNCHES.items()
                                 if v != k0[k]},
            "session_builds": {"/".join(k[:2]): v for k, v in
                               delta["session_builds"].items()},
            "builds_after": {},
            "teardowns": {},
            "delta_applies": {k[0]: v for k, v in
                              delta["session_delta_applies"].items()},
            "device_faults": sum(delta["device_faults"].values()),
            "kernel_ms": sum(ms),
        }
        for b in self.builds[s0:]:
            out["builds_after"][b] = out["builds_after"].get(b, 0) + 1
        for reason, live in self.invalidations[i0:]:
            t = out["teardowns"].setdefault(reason, [0, 0])
            t[0] += 1
            t[1] += live
        if top:
            top_mode = self.be.ladder.mode() if \
                self.be.ladder.rung() == self.be.ladder.top else None
            off = [k for k in rungs if k != f"ScanSession/{top_mode}"]
            if off or self.be.ladder.demotions or out["device_faults"]:
                raise AssertionError(
                    f"{label}: batches off the kernel rung {rungs}, "
                    f"{self.be.ladder.demotions} demotions, "
                    f"{out['device_faults']} device faults")
        return out

    def replay(self, label, b0, b1, bound):
        """The loop's batches b0:b1 through a fresh backend fed the nodes
        and the pods bound before them: the same bindings. Its launches
        are a comparison's: they are taken out of the counts again, and
        its CUDA events are tagged "replay"."""
        sk = self.sk
        nodes = self.nodes()
        counts = (dict(sk.VARIANT_LAUNCHES), dict(sk.CLUSTER_LAUNCHES),
                  sk.LAUNCHES)
        t0 = time.perf_counter()
        self.run._tag = "replay"
        try:
            want = replay_bindings(self.run.batches[b0:b1], nodes,
                                   device=self.device, bound=bound,
                                   weights=self.be.weights)
        finally:
            self.run._tag = "other"
            sk.VARIANT_LAUNCHES.update(counts[0])
            sk.CLUSTER_LAUNCHES.update(counts[1])
            sk.LAUNCHES = counts[2]
        got = {p.metadata.name: p.spec.node_name for p in self.pods()}
        diff = sorted(k for k in want if got.get(k) != want[k])
        if diff or not want:
            raise AssertionError(f"{label}: {len(diff)} of {len(want)} "
                                 f"bindings differ from the replay, first "
                                 f"{diff[:5]}")
        return {"replayed": len(want), "batches": b1 - b0,
                "replay_s": time.perf_counter() - t0}


def ctrl_rollout(w, gpu):
    """17a: a Deployment's first rollout, then a rolling update."""
    from kubernetes_tpu_torch.api import apps

    v1, cs = w.v1, w.cs
    m0 = w.mark()
    t0 = time.perf_counter()
    cs.deployments.create(web_deployment(v1, apps, "web", CTRL_REPLICAS,
                                         "v1", "web:1"))
    wait_for(lambda: w.available("web", "v1", CTRL_REPLICAS) and w.idle(),
             "17a: the first rollout")
    first = w.pods(app="web", version="v1")
    w.checks("17a", first)
    skew1 = zone_skew(first, w.zone_of)
    keys = [StatusWriter.key(p) for p in first]
    t_create = min(w.writer.added[k] for k in keys)
    t_bind = max(w.writer.bound[k][1] for k in keys)
    a = {"first": w.since(m0, "17a first rollout"),
         "pods_per_s": len(first) / (t_bind - t_create),
         "first_create_to_last_bind_s": t_bind - t_create,
         "first_wall_s": time.perf_counter() - t0}
    a["first"].update(w.replay("17a", m0[0], len(w.run.batches), ()))
    m1 = w.mark()
    # the rolling update: a new template (image and version label)
    t1 = time.perf_counter()
    live = cs.deployments.get("web", "default")
    live.spec.template = web_deployment(v1, apps, "web", CTRL_REPLICAS,
                                        "v2", "web:2").spec.template
    cs.deployments.update(live)

    def rolled():
        old = w.rs_of("web", "v1")
        return (old is not None and old.spec.replicas == 0
                and old.status.replicas == 0
                and not w.pods(app="web", version="v1")
                and w.available("web", "v2", CTRL_REPLICAS) and w.idle())

    wait_for(rolled, "17a: the rolling update")
    a["rollout_wall_s"] = time.perf_counter() - t1
    new = w.pods(app="web", version="v2")
    w.checks("17a update", new)
    skew2 = zone_skew(new, w.zone_of)
    a["update"] = w.since(m1, "17a rolling update")
    a["zone_skew"] = {"v1": skew1, "v2": skew2}
    removes = a["update"]["delta_applies"].get("pod-remove", 0)
    if skew1 > 1 or skew2 > 1 or not a["update"]["launches"].get(
            "scan_delta") or not removes:
        raise AssertionError(f"17a: zone skew {a['zone_skew']}, launches "
                             f"{a['update']['launches']}, delta applies "
                             f"{a['update']['delta_applies']}")
    log(f"phase 17a Deployment web, {CTRL_REPLICAS} zone-spread replicas "
        f"over {CTRL_NODES} nodes: the first rollout bound every replica "
        f"once ({a['pods_per_s']:.1f} pods/s from the controller's first "
        f"create to the last bind, {a['first_create_to_last_bind_s']:.2f} "
        f"s; zone skew {skew1}), equal to a fresh backend's replay of its "
        f"{a['first']['batches']} batches; the rolling update (maxSurge "
        f"25 %, maxUnavailable 25 %) took {a['rollout_wall_s']:.2f} s to "
        f"the old ReplicaSet at 0 and {CTRL_REPLICAS} new Ready (zone skew "
        f"{skew2}), no node over its allocatable; first rollout "
        f"{a['first']}; update {a['update']} [{gpu}]")
    return a


def ctrl_anti(w, gpu):
    """17b: a second Deployment whose pods prefer other hostnames than
    their own (ur > 0)."""
    from kubernetes_tpu_torch.api import apps

    v1, cs = w.v1, w.cs
    bound = w.pods()
    m0 = w.mark()
    t0 = time.perf_counter()
    cs.deployments.create(apps.Deployment(
        metadata=v1.ObjectMeta(name="api", namespace="default"),
        spec=apps.DeploymentSpec(
            replicas=CTRL_ANTI_REPLICAS,
            selector=v1.LabelSelector(match_labels={"app": "api"}),
            template=ctrl_template(v1, {"app": "api", "version": "v1"},
                                   "api:1", anti=True))))
    wait_for(lambda: w.available("api", "v1", CTRL_ANTI_REPLICAS)
             and w.idle(), "17b: the rollout")
    pods = w.pods(app="api")
    w.checks("17b", pods)
    b1 = len(w.run.batches)
    b = w.since(m0, "17b")
    b["wall_s"] = time.perf_counter() - t0
    ipa = b["launches"].get("scan_full_ipa", 0)
    on_cluster = b["cluster_launches"].get(w.sk.CLUSTER, 0)
    if not ipa or on_cluster != ipa + b["launches"].get("scan_full", 0):
        raise AssertionError(f"17b: launches {b['launches']}, cluster "
                             f"sizes {b['cluster_launches']}")
    b.update(w.replay("17b", m0[0], b1, bound))
    log(f"phase 17b Deployment api, {CTRL_ANTI_REPLICAS} replicas with a "
        f"weight-100 preferred hostname anti-affinity: every replica bound "
        f"once in {b['wall_s']:.2f} s, scan_full_ipa launched {ipa} times, "
        f"all on the {w.sk.CLUSTER}-block cluster; bindings equal a fresh "
        f"backend's replay of its {b['batches']} batches; {b} [{gpu}]")
    return b


def ctrl_lifecycle(w, gpu):
    """17c: nodes that stop heartbeating are tainted and drained; the
    ReplicaSet re-creates the evicted pods."""
    import threading

    holding = sorted({p.spec.node_name for p in w.pods(app="web")} - w.pool,
                     key=lambda n: int(n.split("-")[1]))
    stale = set(holding[:CTRL_STALE])
    healthy = [n for n in w.names if n not in stale]
    on_stale = {StatusWriter.key(p) for p in w.pods(app="web")
                if p.spec.node_name in stale}
    m0 = w.mark()
    t0 = time.perf_counter()
    # the long-grace controller steps down; every node but the stale ones
    # renews its lease, and keeps renewing while 17c runs
    w.nlc.stop()
    w.writer.heartbeat(healthy)
    age = time.time() - w.heartbeat_t
    if age <= CTRL_GRACE:
        time.sleep(CTRL_GRACE - age + 0.1)
    stop = threading.Event()

    def renew():
        while not stop.wait(CTRL_GRACE / 3):
            w.writer.heartbeat(healthy)

    renewer = threading.Thread(target=renew, daemon=True)
    renewer.start()
    w.nlc = w.lifecycle(period=CTRL_MONITOR, grace=CTRL_GRACE)
    t_start = time.perf_counter()
    w.nlc.run()
    try:
        wait_for(lambda: stale <= set(w.tainted), "17c: the taints")
        wait_for(lambda: all(k in w.writer.deleted for k in on_stale),
                 "17c: the evictions")
        wait_for(lambda: w.available("web", "v2", CTRL_REPLICAS)
                 and w.idle(), "17c: the re-binds")
    finally:
        stop.set()
        renewer.join(timeout=10)
        w.nlc.stop()
    w.nlc = None
    t_taint = min(w.tainted[n] for n in stale)
    extra = set(w.tainted) - stale
    pods = w.pods()
    web = [p for p in pods if p.metadata.labels.get("app") == "web"]
    w.checks("17c", web)
    # replicas created after the first taint, and any pod (deleted since
    # or not) created after its node's taint that was bound there
    fresh = [StatusWriter.key(p) for p in web
             if w.writer.added[StatusWriter.key(p)] > t_taint]
    landed = [k for k, (node, _) in w.writer.bound.items()
              if node in w.tainted
              and w.writer.added.get(k, 0.0) > w.tainted[node]]
    evicted = sorted(w.writer.deleted[k] for k in on_stale)
    rebinds = sorted(w.writer.bound[k][1] for k in fresh)
    lat = [b - e for e, b in zip(evicted, rebinds)]
    c = w.since(m0, "17c")
    c.update({
        "stale_nodes": len(stale), "tainted_other_nodes": len(extra),
        "evicted": len(on_stale), "recreated": len(fresh),
        "landed_on_tainted": landed,
        "web_left_on_tainted": sum(p.spec.node_name in stale for p in web),
        "api_left_on_tainted": sum(p.spec.node_name in stale for p in pods
                                   if p.metadata.labels.get("app") == "api"),
        "taint_after_s": t_taint - t_start,
        "evict_to_rebind_p50_s": quantiles(lat)[0],
        "evict_to_rebind_p99_s": quantiles(lat)[1],
        "wall_s": time.perf_counter() - t0})
    if extra or landed or c["web_left_on_tainted"] or \
            len(fresh) != len(on_stale) or not on_stale:
        raise AssertionError(f"17c: {c}")
    log(f"phase 17c node lifecycle: {len(stale)} nodes holding web pods "
        f"stopped heartbeating (grace {CTRL_GRACE} s, monitor "
        f"{CTRL_MONITOR} s), tainted unreachable:NoExecute "
        f"{c['taint_after_s']:.2f} s after the controller started; "
        f"{len(on_stale)} web pods evicted and re-created, each re-bound "
        f"(eviction to re-bind p50 {c['evict_to_rebind_p50_s']:.3f} s, p99 "
        f"{c['evict_to_rebind_p99_s']:.3f} s), none on a tainted node; "
        f"{c['api_left_on_tainted']} api pods stay there (DefaultToleration"
        f"Seconds' 300 s); session teardowns by reason [calls, of a live "
        f"session] {c['teardowns']}, builds after them {c['builds_after']};"
        f" {c} [{gpu}]")
    return c


def ctrl_cascade(w, gpu):
    """17d: the garbage collector's cascade into the live session, then a
    Job and a DaemonSet."""
    import numpy as np
    from kubernetes_tpu_torch.api import apps, batch
    from kubernetes_tpu_torch.controllers.garbagecollector import (
        GarbageCollector,
    )
    from kubernetes_tpu_torch.ops.scan import ScanSession

    v1, cs, be = w.v1, w.cs, w.be
    d = {}
    m0 = w.mark()
    t0 = time.perf_counter()
    w.gc = w.errors.wrap(GarbageCollector(cs, scan_interval=0.5),
                         "collect_once")
    w.gc.run()
    keys = [StatusWriter.key(p) for p in w.pods(app="web")]
    web = len(keys)
    cs.deployments.delete("web", "default", propagation_policy="Background")

    def collected():
        return not w.pods(app="web") and not any(
            rs.metadata.labels.get("app") == "web"
            for rs in w.replicasets())

    wait_for(collected, "17d: the cascade")
    wait_for(lambda: not any(w.sched.cache.has_pod(k) for k in keys),
             "17d: the scheduler's cache")
    w.gc.stop()
    w.gc = None
    d["cascade_s"] = time.perf_counter() - t0
    d["collected_pods"] = web
    # the live session absorbed the deletes as deltas: flushed, its
    # carries equal a fresh session's from the encoding at this moment
    with be._lock:
        sess = be._session
        if not isinstance(sess, ScanSession):
            raise AssertionError(f"17d: no live kernel session after the "
                                 f"cascade ({type(sess).__name__})")
        queued = len(be._deltas)
        be._apply_session_deltas_locked()
        be._sync_stream()
        if be._session is not sess:
            raise AssertionError("17d: the flush rebuilt the session")
        state = {k: v.clone() for k, v in
                 be.enc.device_state(w.device).items()}
        fresh = ScanSession(state, list(be._known_templates.values()),
                            be.weights, device=w.device)
        if sess._carry is None:
            sess._carry = sess._initial_carry()
        a = unscaled(sess, sess._carry)
        b = unscaled(fresh, fresh._initial_carry())
    diff = [k for k in b if not np.array_equal(a[k], b[k])]
    if diff or queued < web:
        raise AssertionError(f"17d: carries {diff} differ from a fresh "
                             f"session's ({queued} deltas queued for {web} "
                             "deletes)")
    d["queued_deltas"] = queued
    del fresh
    d["cascade"] = w.since(m0, "17d cascade", top=False)
    # the Job, held to a fresh backend fed the cluster at this moment
    bound = w.pods()
    m1 = w.mark()
    t1 = time.perf_counter()
    cs.jobs.create(batch.Job(
        metadata=v1.ObjectMeta(name="batch", namespace="default"),
        spec=batch.JobSpec(
            parallelism=CTRL_JOB_PODS, completions=CTRL_JOB_PODS,
            template=ctrl_template(v1, {"app": "batch"}, "batch:1",
                                   failover=True))))
    wait_for(lambda: len(w.writer.held) == CTRL_JOB_PODS and w.idle(),
             "17d: the Job's binds")
    b2 = len(w.run.batches)
    job = w.pods(app="batch")
    w.checks("17d Job", job)
    d["job"] = w.since(m1, "17d Job", top=False)
    d["job"].update(w.replay("17d Job", m1[0], b2, bound))
    w.writer.release_jobs()

    def complete():
        j = cs.jobs.get("batch", "default")
        return any(c.type == "Complete" and c.status == "True"
                   for c in j.status.conditions or [])

    wait_for(complete, "17d: the Job's completion")
    d["job"]["wall_s"] = time.perf_counter() - t1
    # the DaemonSet over the pool
    m2 = w.mark()
    t2 = time.perf_counter()
    tmpl = ctrl_template(v1, {"app": "agent"}, "agent:1")
    tmpl.spec.node_selector = {"pool": "agents"}
    cs.daemonsets.create(apps.DaemonSet(
        metadata=v1.ObjectMeta(name="agent", namespace="kube-system"),
        spec=apps.DaemonSetSpec(
            selector=v1.LabelSelector(match_labels={"app": "agent"}),
            template=tmpl)))

    def daemons():
        pods = w.pods(app="agent")
        return len(pods) == CTRL_POOL and all(
            p.spec.node_name for p in pods) and w.idle()

    wait_for(daemons, "17d: the DaemonSet")
    agents = w.pods(app="agent")
    w.checks("17d DaemonSet", agents)
    on = sorted(p.spec.node_name for p in agents)
    if on != sorted(w.pool):
        raise AssertionError(f"17d: DaemonSet pods on {on[:5]}..., not one "
                             f"on each of the {CTRL_POOL} pool nodes")
    d["daemonset"] = w.since(m2, "17d DaemonSet", top=False)
    d["daemonset"]["wall_s"] = time.perf_counter() - t2
    log(f"phase 17d garbage collection: deleting Deployment web "
        f"(background) collected its ReplicaSets and {web} pods in "
        f"{d['cascade_s']:.2f} s; {queued} queued deltas flushed into the "
        f"live ScanSession, whose carries then equal a fresh session's "
        f"from the encoding (unscaled, valid lanes); Job batch "
        f"({CTRL_JOB_PODS} pods, parallelism {CTRL_JOB_PODS}) bound as a "
        f"fresh backend fed that cluster decides ({d['job']['replayed']} "
        f"pods, {d['job']['batches']} batches) and completed; DaemonSet "
        f"agent one pod on each of the {CTRL_POOL} pool nodes, none "
        f"elsewhere, its batches on {d['daemonset']['rungs']}, session "
        f"builds {d['daemonset']['session_builds']} (a kernel refusal shows "
        f"as a hoisted build's reason); cascade {d['cascade']}; Job "
        f"{d['job']}; DaemonSet {d['daemonset']} [{gpu}]")
    return d


def phase_controllers(sk, gpu, device="cuda"):
    """Phase 17: the workload controllers and admission driving the card's
    scheduler (ControllerWorld; its StatusWriter stands in for the
    kubelets until they are ported). Returns (numbers, launches per kernel
    variant over the phase: counts set to 0 just before it)."""
    t0 = time.perf_counter()
    reset_counts(sk)
    w = ControllerWorld(sk, device)
    out = {"nodes": CTRL_NODES, "setup_s": w.setup_s}
    try:
        out["17a"] = ctrl_rollout(w, gpu)
        out["17b"] = ctrl_anti(w, gpu)
        out["17c"] = ctrl_lifecycle(w, gpu)
        out["17d"] = ctrl_cascade(w, gpu)
        window_s = time.perf_counter() - t0
        kernel_ms = sum(w.run.kernel_ms(("init", "measured", "other")))
    finally:
        w.close()
    launches = {k: v for k, v in sk.VARIANT_LAUNCHES.items() if v}
    # the cases' sums (a replay's builds fall between their marks)
    totals = {"session_builds": {}, "builds_after": {}, "delta_applies": {}}
    for case in (out["17a"]["first"], out["17a"]["update"], out["17b"],
                 out["17c"], out["17d"]["cascade"], out["17d"]["job"],
                 out["17d"]["daemonset"]):
        for key, acc in totals.items():
            for k, v in case[key].items():
                acc[k] = acc.get(k, 0) + v
    out.update(totals)
    out.update({
        "launches": launches,
        "sync_errors": w.errors.errors, "sync_retries": w.errors.retries,
        "kernel_ms": kernel_ms,
        "kernel_share": kernel_ms / 1e3 / window_s if window_s else None,
        "phase_s": time.perf_counter() - t0})
    if w.errors.errors:
        raise AssertionError(f"17: controller sync errors {w.errors.errors}")
    idle = [k for k in ("scan_full", "scan_full_ipa", "scan_delta")
            if not launches.get(k)]
    if idle:
        raise AssertionError(f"17: kernels the controllers' path never "
                             f"launched: {idle}")
    log(f"phase 17 the controllers: {out['17a']['pods_per_s']:.1f} pods/s "
        f"from the first create to the last bind of 17a, rollout "
        f"{out['17a']['rollout_wall_s']:.2f} s, eviction to re-bind p50 "
        f"{out['17c']['evict_to_rebind_p50_s']:.3f} s p99 "
        f"{out['17c']['evict_to_rebind_p99_s']:.3f} s; session builds by "
        f"kind {out['session_builds']}, by the teardown before them "
        f"{out['builds_after']}; launches {launches}; delta applies "
        f"{out['delta_applies']}; kernel {kernel_ms:.1f} ms, "
        f"{out['kernel_share']:.2%} of the phase's window; 0 sync errors "
        f"({w.errors.retries} conflict retries); setup {w.setup_s:.1f} s, "
        f"phase {out['phase_s']:.1f} s [{gpu}]")
    return out, launches


def ipa_ops(ipa, t) -> tuple:
    """The IPA branch's operations for one template-t pod, from the
    session's gate matrices: only the nonzero gate entries of the terms
    the template has. -> (per lane of the filter, per feasible lane of
    the score, per pod)."""
    import numpy as np

    def nnz(rows):
        return int(np.count_nonzero(rows))

    sub = ipa["anti_valid"].shape[1]
    d1 = nnz(ipa["g1"][t])
    # D2 / D3: a product per nonzero gate entry and a compare per valid
    # term (D3 only where the template has affinity terms)
    d2 = sum(nnz(ipa["wanti"][t * sub + tau]) + 1 for tau in range(sub)
             if ipa["anti_valid"][t, tau])
    d3 = sum(nnz(ipa["waff"][t * sub + tau]) + 1 for tau in range(sub)
             if ipa["aff_valid"][t, tau]) if ipa["has_aff"][t] else 0
    # D4+D5: the weighted dot and the multiply by w45_scale
    d45 = nnz(ipa["w45"][t])
    d45 += 1 if d45 else 0
    # the per-pod aff_total delta and presence flag from kcnt
    per_pod = nnz(ipa["w3tot"][t]) + nnz(ipa["gpres"][t])
    return d1 + d2 + d3, d45, per_pod


# operations of the balanced / least rows on one lane (two IEEE divisions,
# the fraction difference and scale, two floored least divisions, the
# weighted sum)
BALANCED_LEAST_OPS = 20


def bound(sess, meta, match, out, n, mode="full", mk=1, forced=None):
    """Least time the card could take for one batch: the larger of the
    bytes the function must move (inputs read once, outputs written once;
    with mk > 1 the group scratch written and read once) over the memory
    rate, and its elementwise int32/f32 operations over the f32 rate.
    Counted from this batch's data: the filter sweeps run on every lane,
    the score and argmax on the feasible lanes only (with mk > 1 not for
    the pods of a group that starts inside the conflict suffix, which
    need only their feasible count), the multi-pod recheck (a scratch
    load and compare on every lane, the fit over R dims and the
    balanced/least rows on the pod's feasible lanes) for pods 1.. of a
    group before the suffix (the suffix's first pod is not charged: out
    rows do not show whether its count legs fired first, which skips
    the recheck), the commit on the pods committed and the keys the
    chosen node has. "eval" does no commit and writes no carry; "apply" only
    commits."""
    from kubernetes_tpu_torch.ops.scan import LANE

    statics = sess._get_statics()
    carry_bytes = sum(t.numel() * t.element_size()
                      for t in sess._carry.values())
    if mode == "apply":
        keys = ("scalars", "stat", "prow_f", "prow_s") + (
            ("prow_ipa",) if sess.UR else ())
        tensors = [meta, match, out, forced, *(statics[k] for k in keys)]
    else:
        tensors = [meta, match, out, *statics.values()]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += carry_bytes * (1 if mode == "eval" else 2)
    if mk > 1:
        nbytes += 2 * (2 * mk * sess.Np * 4)
    sc = sess._scalars.tolist()
    T, C, R = sess.T, sess.C, sess.R
    off_tc = T * (2 * R + 4)
    tmpl = meta[1:1 + n].tolist()
    if mode == "apply":
        fv = forced.tolist()
        commits = [fv[2 * b] if fv[2 * b + 1] else -1 for b in range(n)]
    else:
        commits = out[0, :n].tolist() if mode == "full" else [-1] * n
    feas = out[2, :n].tolist()
    flags = out[3, :n].tolist()
    mrows = match[:n].ne(0).sum(dim=1).tolist()
    ipa = sess._ipa
    ipa_t = [ipa_ops(ipa, t) for t in range(T)] if sess.UR else None
    suffix = next((b for b in range(n) if flags[b] > 0), n) if mk > 1 \
        else n
    ops = 0
    for b in range(n):
        t = tmpl[b]
        if mode != "apply":
            n_fv = sum(sc[off_tc + 0 * T * C + t * C + c] != 0
                       for c in range(C))
            n_sv = sum(sc[off_tc + 1 * T * C + t * C + c] != 0
                       for c in range(C))
            sweep = 3 * R + 3 + n_fv * (2 * C + 4) + 8 + sess.K
            score = n_sv * (C + 6) + 55
            scored = b - b % mk <= suffix
            ops += sess.Np * sweep + scored * feas[b] * score
            if ipa_t:
                lane_ops, feas_ops, pod_ops = ipa_t[t]
                ops += (sess.Np * lane_ops + scored * feas[b] * feas_ops
                        + pod_ops)
        if mk > 1 and b % mk and b < suffix:
            # the recheck: a load and a compare of the group scratch per
            # lane, then the fit and the balanced/least rows on the lanes
            # the pod found feasible
            ops += 2 * sess.Np + feas[b] * (3 * R + 3 + BALANCED_LEAST_OPS)
        if commits[b] >= 0:
            # a compare and an add per lane for each matched row
            ops += 2 * sess.Np * mrows[b]
            if ipa_t:
                # a compare and an add per lane of ucnt, and the 128
                # kcnt lanes, for each IPA key the chosen node has
                keys = int((ipa["prow_ipa"][:, commits[b]] >= 0).sum())
                ops += keys * (2 * sess.Np + LANE)
    return roofline(nbytes, ops)


def roofline(nbytes, ops):
    """(least ms, "bytes" or "operations", bytes, ops): the larger of the
    bytes over the card's memory rate and the operations over its f32
    rate."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations"), nbytes, ops


def delta_bound(sess, node, payload):
    """Least time for one delta flush: the payload read once, the statics
    it reads (the scalar prefix, each template's s_src row, prow_f,
    prow_s) read once, the four carries read and written once; a compare
    and an add per lane for each payload row that moves a pair (nonzero,
    and the node has a pair id there; for cnt_sn also a nonzero factor,
    and a multiply), and the utilization adds."""
    import numpy as np
    from kubernetes_tpu_torch.ops import scan_kernel as sk

    Np, TCp, T, C, CP, SR = sess.Np, sess.TCp, sess.T, sess.C, sess.CP, \
        sess.SR
    Rp = sess._requested0.shape[0]
    carry_bytes = sum(sess._carry[k].numel() * 4 for k in
                      ("requested", "nzpc", "cnt_fn", "cnt_sn"))
    nbytes = (node.nbytes + payload.nbytes + 2 * carry_bytes
              + 4 * (sk.n_scalars(T, C, sess.R, 0) + T * Np + 2 * TCp * Np))
    mf = payload[:, Rp + 8:Rp + 8 + TCp]
    ms = payload[:, Rp + 8 + TCp:]
    pf = sess._prow_f[:, node].T >= 0                     # [E, TCp]
    ps = sess._prow_s[:, node].T >= 0
    factor = sess._perno_rows[:, 0][None] + (
        1 - sess._perno_rows[:, 0][None]) * sess._src_rows[:, node].T
    rows_f = int(((mf != 0) & pf).sum())
    rows_s = int(((ms != 0) & ps & (factor != 0)).sum())
    ops = 2 * Np * rows_f + 3 * Np * rows_s + int(
        np.count_nonzero(payload[:, :Rp + 8]))
    return roofline(nbytes, ops)


def entry(name, replaces, d, source=SOURCE, **extra):
    """One kernel's entry of the kernels line; `replaces` is a line of the
    scan kernel's file or a "file:line"."""
    if isinstance(replaces, int):
        replaces = f"{REPLACES}:{replaces}"
    e = {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": d["launches"],
         "max_abs_err": d["err"], "ms": d["ms"], "plain_ms": d["plain_ms"],
         "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
         "library_ms": d.get("library_ms"), "matched": True}
    e.update(extra)
    return e


def cells(rows):
    return [{k: r[k] for k in ("cell", "launches", "ms", "plain_ms",
                               "bound_ms", "bound_by", "block_ms", "sweep")
             if k in r}
            for r in rows]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from kubernetes_tpu_torch.ops import scan_kernel as sk

    gpu = gpu_line()
    log(gpu)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    from kubernetes_tpu_torch import probes
    from kubernetes_tpu_torch.ops import build
    from kubernetes_tpu_torch.ops import whatif_kernel as wk
    from kubernetes_tpu_torch.utils.compilation_cache import (
        enable_persistent_cache,
    )

    cache = enable_persistent_cache()
    log(f"kernel build directory {build.BUILD_DIR}"
        + ("" if cache else " (KTPU_COMPILATION_CACHE off: no reuse)"))
    t0 = time.perf_counter()
    built = build.build([sk.SOURCE, probes.SOURCE, wk.SOURCE], verbose=True)
    log("phase 2: built " + ", ".join(
        f"{src.name} in {sec:.2f} s" for src, sec in built.items())
        + f" (one nvcc each, in parallel; {time.perf_counter() - t0:.2f} s "
        "in all)")

    marks = [("2", time.perf_counter())]

    def mark(label):
        marks.append((label, time.perf_counter()))

    small = small_case()
    small_err = phase_small(small)
    mark("3")
    zone = phase_zone_spread(sk, gpu)                              # phase 4
    sweep = phase_cluster(sk, gpu, zone, "4b")                     # 4b
    sizes = sweep["sizes"]
    cluster_directed(sk, sizes)
    mark("4")
    terms = terms_case()
    terms_err = phase_terms_small(sk, gpu, terms, sizes)           # phase 5
    mark("5")
    aff = [phase_affinity(sk, gpu, kind) for kind in ("pref-aff", "aff")]
    for a in aff:                                                  # 6b
        a.update(phase_cluster(sk, gpu, a, "6b"))
    kcnt_directed(sk, gpu, sizes)
    mark("6")
    multi_small = [phase_multipod_small(sk, gpu, c)                # 7a
                   for c in (small, terms)]
    tenants = phase_tenants(sk, gpu)                               # 7b
    heavy = [phase_conflict_heavy(sk, gpu, d) for d in (zone, aff[0])]
    mark("7")
    ev = phase_eval_apply(sk, gpu, (small, terms), zone)           # 8
    mark("8")
    churn = [phase_churn_zone(sk, gpu, zone),                      # 9
             phase_churn_affinity(sk, gpu, aff[0])]
    mark("9")
    probe_entries = phase_probes(gpu)                              # 10
    mark("10")
    hoisted = phase_hoisted(gpu, zone, aff[0], churn[0])           # 11
    mark("11")
    backend, backend_launches = phase_backend(sk, gpu, zone, aff[0])  # 12
    mark("12")
    loop, loop_launches, loop_bindings = phase_loop(sk, gpu)       # 13
    mark("13")
    preemption, whatif, pre_launches = phase_preemption(sk, gpu)   # 14
    mark("14")
    # phase 15 runs after every earlier session is released
    for d in (zone, *aff, tenants, *heavy, *churn):
        for k in [k for k, v in d.items()
                  if type(v).__name__.endswith("Session")]:
            del d[k]
    gc.collect()
    torch.cuda.empty_cache()
    matrix = {"15a": phase_schedule_batch(gpu, zone)}             # 15a
    rows, matrix_launches = phase_matrix(sk, gpu, loop_bindings)   # 15b, c
    matrix.update(rows)
    mark("15")
    mesh, mesh_deltas, mesh_whatif = phase_mesh(sk, gpu, zone, aff[0],
                                                churn[0])          # 16
    mark("16")
    gc.collect()
    torch.cuda.empty_cache()
    controllers, ctrl_launches = phase_controllers(sk, gpu)        # 17
    mark("17")
    for k, v in (*pre_launches.items(), *matrix_launches.items()):
        loop_launches[k] = loop_launches.get(k, 0) + v
    log("seconds by phase: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.1f}" for a, b in zip(marks, marks[1:]))
        + f"; build and phases 3-17 {marks[-1][1] - t0:.1f}")

    zone["err"] = max(zone["err"], small_err)
    # scan_full_ipa reports its slower cell; `cells` keeps both cells'
    # numbers, sweeps included
    slow = max(aff, key=lambda a: a["ms"])
    ipa = dict(slow, launches=sum(a["launches"] for a in aff),
               err=max(terms_err, *(a["err"] for a in aff)))
    # scan_multi reports the tenant mix; `cells` lists every phase-7 cell
    # (both variants) and `launches` sums their counted launches
    multi_cells = [tenants] + [
        dict(m, cell=f"{m['cell']}, {m['variant']} (7a)")
        for m in multi_small] + heavy
    multi = dict(tenants, launches=sum(c["launches"] for c in multi_cells),
                 err=max(c["err"] for c in multi_cells))
    kernels = [
        entry("scan_full", 1247, zone, cluster=sk.CLUSTER,
              block_ms=sweep["block_ms"], sweep=sweep["sweep"]),
        entry("scan_full_ipa", 1552, ipa, cluster=sk.CLUSTER,
              block_ms=slow["block_ms"], sweep=slow["sweep"],
              cell=slow["cell"], cells=cells(aff)),
        entry("scan_multi", 1798, multi, cell=tenants["cell"],
              cells=cells(multi_cells)),
        entry("scan_eval", 1751, dict(ev["eval"], err=ev["err"]),
              call_ms=ev["eval"]["call_ms"]),
        entry("scan_apply", 1737, dict(ev["apply"], err=ev["err"]),
              call_ms=ev["apply"]["call_ms"]),
        # the zone-spread flush; `cells` keeps both cells' numbers
        entry("scan_delta", 168, dict(
            churn[0], launches=sum(c["launches"] for c in churn),
            err=max(c["err"] for c in churn)), cell=churn[0]["cell"],
            one_event_ms=churn[0]["one_ms"], call_ms=churn[0]["call_ms"],
            prep_ms=churn[0]["prep_ms"], device_ms=churn[0]["device_ms"],
            rebuild_s=churn[0]["build_s"], mesh_launches=mesh_deltas,
            cells=[{k: c[k] for k in ("cell", "events", "ms", "device_ms",
                                      "one_ms", "one_device_ms",
                                      "same_node_ms", "same_node_device_ms",
                                      "call_ms", "prep_ms", "plain_ms",
                                      "bound_ms", "bound_by", "build_s",
                                      "case_errs")}
                   for c in churn]),
        *probe_entries,
        entry("whatif", "kubernetes_tpu/ops/whatif.py:116", whatif[0],
              source=WHATIF_SOURCE, checked_launches=whatif[0]["checked"],
              shape=whatif[0]["shape"],
              walk_bound_ms=whatif[0]["walk_bound_ms"],
              walk_bound_by=whatif[0]["walk_bound_by"],
              mesh_launches=mesh_whatif["launches"],
              mesh_checked_launches=mesh_whatif["checked"],
              # the minimum-structure kernel, launched by the what-if only
              # where a spread constraint is valid: 0 times on the main
              # path, the loop and the mesh (no preemptor there has one);
              # held to plain and timed in 14g
              mins=dict(whatif[0]["mins"],
                        mesh_launches=mesh_whatif["mins_launches"])),
        entry("whatif_context", "kubernetes_tpu/ops/whatif.py:146",
              whatif[1], source=WHATIF_SOURCE,
              checked_launches=whatif[1]["checked"],
              shape=whatif[1]["shape"],
              mesh_launches=mesh_whatif["context_launches"]),
    ]
    idle = [e["name"] for e in kernels if not e["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched on their path: {idle}")
    # phase 16: the mesh path's own launches (counts set to 0 before each
    # of its flushes and planner waves)
    idle = [e["name"] for e in kernels
            if e["name"] in ("scan_delta", "whatif", "whatif_context")
            and not e.get("mesh_launches")]
    if idle:
        raise AssertionError(f"kernels the mesh never launched: {idle}")
    # phases 12 and 13: each kernel's launches by the backend's calls and
    # by the scheduler loop's
    for e in kernels:
        variants = {"scan_full": ("scan_full",),
                    "scan_full_ipa": ("scan_full_ipa",),
                    "scan_multi": ("scan_multi", "scan_multi_ipa"),
                    "scan_eval": ("scan_eval", "scan_eval_ipa"),
                    "scan_apply": ("scan_apply", "scan_apply_ipa"),
                    "scan_delta": ("scan_delta",),
                    "whatif": ("whatif",),
                    "whatif_context": ("whatif_context",)}.get(e["name"], ())
        e["backend_launches"] = sum(backend_launches.get(v, 0)
                                    for v in variants)
        e["loop_launches"] = sum(loop_launches.get(v, 0) for v in variants)
        e["controllers_launches"] = sum(ctrl_launches.get(v, 0)
                                        for v in variants)
    idle = [n for n in ("scan_full", "scan_full_ipa", "scan_delta")
            if not next(e for e in kernels if e["name"] == n)[
                "backend_launches"]]
    if idle:
        raise AssertionError(f"kernels the backend never launched: {idle}")
    idle = [n for n in ("scan_full", "scan_full_ipa", "scan_delta",
                        "whatif", "whatif_context")
            if not next(e for e in kernels if e["name"] == n)[
                "loop_launches"]]
    if idle:
        raise AssertionError(f"kernels the loop never launched: {idle}")
    # phase 17: the controllers' path
    idle = [n for n in ("scan_full", "scan_full_ipa", "scan_delta")
            if not next(e for e in kernels if e["name"] == n)[
                "controllers_launches"]]
    if idle:
        raise AssertionError(f"kernels the controllers never launched: "
                             f"{idle}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"hoisted_session": hoisted}))
    log(json.dumps({"backend": backend}))
    log(json.dumps({"loop": loop}))
    log(json.dumps({"preemption": preemption}, default=str))
    log(json.dumps({"matrix": matrix}, default=str))
    log(json.dumps({"mesh": mesh}, default=str))
    log(json.dumps({"controllers": controllers}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
