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
      (the suffix replay) over every batch, whose decisions and final
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
   time);
11. the hoisted session (`HoistedSession`, plain torch: a Python loop of
   per-pod steps, no kernel of its own):
   a. from the encoding phase 4's session started from, the first 1024
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
      the mutated encoding, and the next 1024 pods decide as it does;
   f. the f64 PTS weight log(n + 2) on the card: torch.log there against
      the port's table, and the table read on the card equal to the host's.

It prints the kernels' line, a `{"hoisted_session": ...}` line with phase
11's numbers, then `{"ok": true, "device": {...}}` last.
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
HOISTED_PODS = 1024              # pods per phase-11 batch (11a, 11c, 11e)
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
    return {"cell": "zone spread 5000n", "launches": launches, "err": err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "sess": sess, "multi": multi,
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


def phase_affinity(sk, gpu, kind):
    """scheduler_perf's Scheduling{Preferred,}PodAffinity-5000n through
    the session: every pod placed, the ur > 0 variant once per batch, all
    on the cluster kernel at `CLUSTER`, the first measured batch == plain.
    Returns this phase's numbers, the session (and its mk=4 twin on the
    same cluster), the first measured batch, the carry before it and the
    plain version's out and carry after it."""
    import torch
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.ops.scan import ScanSession
    from kubernetes_tpu_torch.testing.synth import make_pod, synth_cluster

    name = {"pref-aff": "SchedulingPreferredPodAffinity-5000n",
            "aff": "SchedulingPodAffinity-5000n"}[kind]
    t0 = time.perf_counter()
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
            "snapshot0": snapshot0, "batch0": batches[0][0]}


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
    from kubernetes_tpu_torch.ops.scan import ScanSession, schedule_exact

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
    from kubernetes_tpu_torch.ops.scan import ScanSession, schedule_exact
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
            "next_batch": batch}


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
    ms = statistics.median(event_ms(lambda: ps.probe_int64(a)))
    ones = torch.ones_like(a)
    library_ms = statistics.median(
        event_ms(lambda: torch.add(ones, a, alpha=2)))
    nb = add("probe_int64", "scripts/probe_pallas.py:69", n64, err, ms,
             plain_ms, roofline(2 * a.numel() * 8, 2 * a.numel()),
             library_ms=library_ms)
    log(f"phase 10: probe_int64 == plain ({out[0, :3].tolist()}); {ms:.4f} "
        f"ms, torch.add(1, a, alpha=2) {library_ms:.4f} ms, plain version "
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


def device_busy(fn):
    """Run fn under torch.profiler: the card's busy time (the sum of its
    kernels' device time), the host window, and kernels per pod of
    PROFILED_PODS."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    return {"busy_ms": busy_ms, "window_ms": window_ms,
            "busy_share": busy_ms / window_ms,
            "kernels_per_pod": len(kernels) / PROFILED_PODS}


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

    t0 = time.perf_counter()
    built = build.build([sk.SOURCE, probes.SOURCE], verbose=True)
    log("phase 2: built " + ", ".join(
        f"{src.name} in {sec:.2f} s" for src, sec in built.items())
        + f" (one nvcc each, in parallel; {time.perf_counter() - t0:.2f} s "
        "in all)")

    small = small_case()
    small_err = phase_small(small)
    zone = phase_zone_spread(sk, gpu)                              # phase 4
    sweep = phase_cluster(sk, gpu, zone, "4b")                     # 4b
    sizes = sweep["sizes"]
    cluster_directed(sk, sizes)
    terms = terms_case()
    terms_err = phase_terms_small(sk, gpu, terms, sizes)           # phase 5
    aff = [phase_affinity(sk, gpu, kind) for kind in ("pref-aff", "aff")]
    for a in aff:                                                  # 6b
        a.update(phase_cluster(sk, gpu, a, "6b"))
    kcnt_directed(sk, gpu, sizes)
    multi_small = [phase_multipod_small(sk, gpu, c)                # 7a
                   for c in (small, terms)]
    tenants = phase_tenants(sk, gpu)                               # 7b
    heavy = [phase_conflict_heavy(sk, gpu, d) for d in (zone, aff[0])]
    ev = phase_eval_apply(sk, gpu, (small, terms), zone)           # 8
    churn = [phase_churn_zone(sk, gpu, zone),                      # 9
             phase_churn_affinity(sk, gpu, aff[0])]
    probe_entries = phase_probes(gpu)                              # 10
    hoisted = phase_hoisted(gpu, zone, aff[0], churn[0])           # 11

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
            rebuild_s=churn[0]["build_s"],
            cells=[{k: c[k] for k in ("cell", "events", "ms", "device_ms",
                                      "one_ms", "one_device_ms",
                                      "same_node_ms", "same_node_device_ms",
                                      "call_ms", "prep_ms", "plain_ms",
                                      "bound_ms", "bound_by", "build_s",
                                      "case_errs")}
                   for c in churn]),
        *probe_entries,
    ]
    idle = [e["name"] for e in kernels if not e["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched on their path: {idle}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"hoisted_session": hoisted}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
