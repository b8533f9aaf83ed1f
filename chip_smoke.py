#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kubernetes_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from the sources in this checkout
   (into build/torch_kernels/);
3. each kernel against its plain PyTorch version on the card, on a mixed
   ~600-node cluster (hostname DoNotSchedule spread, zone ScheduleAnyway
   spread, no constraint, tainted and unschedulable nodes, a
   capacity-starved template): out rows and carries must be equal;
4. the main path at full size, as bench.py sets it up: the batched
   scheduling session (ScanSession) over synth_cluster(5000) with
   3 x 4096 pending zone-spread pods — one warm-up batch, two measured
   batches; every pod must be placed, the kernel must have been launched
   once per batch, and the first measured batch must equal the plain
   version run from a copy of the same carry.

It prints the kernels' line, then `{"ok": true, "device": {...}}` last.
It needs a CUDA card and imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores


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


def batch_inputs(sess, arrays):
    """The kernel inputs ScanSession.schedule builds for this batch."""
    import torch
    from kubernetes_tpu_torch.ops.scan import LANE, batch_prologue

    Bp, tmpl, mfa, msa = batch_prologue(sess._fps, sess._tp_np, arrays,
                                        minimum=LANE)
    meta, match = sess._pack_batch(len(arrays), Bp, tmpl, mfa, msa)
    return (torch.from_numpy(meta).to(sess.device),
            torch.from_numpy(match).to(sess.device))


def clone(carry):
    return {k: v.clone() for k, v in carry.items()}


def max_abs_err(out_a, out_b, n, carry_a, carry_b) -> int:
    err = int((out_a[:3, :n].long() - out_b[:3, :n].long()).abs().max())
    for k in carry_a:
        err = max(err, int((carry_a[k].long() - carry_b[k].long())
                           .abs().max()))
    return err


def kernel_vs_plain(sess, arrays, carry):
    """Kernel and plain version on the same inputs from equal carries;
    returns (max_abs_err, kernel out, kernel ms, plain ms). `carry` is
    advanced by the kernel."""
    import torch
    from kubernetes_tpu_torch.ops import scan_kernel as sk

    meta, match = batch_inputs(sess, arrays)
    weights = tuple(int(sess.weights[k]) for k in sk.WEIGHT_ORDER)
    ref_carry = clone(carry)
    statics = sess._get_statics()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = sk.scan_full(meta, match, statics, carry, sess.shapes, weights)
    e1.record()
    torch.cuda.synchronize()
    kernel_ms = e0.elapsed_time(e1)
    t0 = time.perf_counter()
    ref = sk.scan_full_reference(meta, match, statics, ref_carry,
                                 sess.shapes, weights)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n = len(arrays)
    equal = torch.equal(out[:3, :n], ref[:3, :n]) and all(
        torch.equal(carry[k], ref_carry[k]) for k in carry)
    err = max_abs_err(out, ref, n, carry, ref_carry)
    if not equal:
        raise AssertionError(f"scan_full kernel != plain version "
                             f"(max abs err {err})")
    return err, out, kernel_ms, plain_ms


def phase_small():
    """~600 nodes, 4 templates, 2 batches of 256: kernel == plain."""
    from kubernetes_tpu_torch.api import types as v1
    from kubernetes_tpu_torch.ops.scan import ScanSession
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
    sess = ScanSession(enc.device_state("cuda"), templates, device="cuda")
    carry = sess._initial_carry()
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
    log(f"phase 3: kernel == plain on {len(nodes)} nodes, T={sess.T}, "
        f"{len(arrays)} pods in 2 batches ({placed} placed, {unplaced} "
        "unschedulable)")
    log(f"phase 3: scan_full {[round(x, 3) for x in kernel_ms]} ms per "
        f"256-pod batch at Np={sess.Np}")
    return err


def bound(sess, meta, match, out, n) -> tuple:
    """Least time the card could take for one batch: the larger of the
    bytes the function must move (inputs read once, outputs written once)
    over the memory rate, and its elementwise int32/f32 operations over
    the f32 rate. Counted from this batch's data: the filter sweeps run
    on every lane, the score and argmax on the feasible lanes only."""
    tensors = [meta, match, out, *sess._get_statics().values()]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += 2 * sum(t.numel() * t.element_size()
                      for t in sess._carry.values())
    sc = sess._scalars.tolist()
    T, C, R = sess.T, sess.C, sess.R
    off_tc = T * (2 * R + 4)
    tmpl = meta[1:1 + n].tolist()
    feas = out[2, :n].tolist()
    mrows = match[:n].ne(0).sum(dim=1).tolist()
    ops = 0
    for b in range(n):
        t = tmpl[b]
        n_fv = sum(sc[off_tc + 0 * T * C + t * C + c] != 0 for c in range(C))
        n_sv = sum(sc[off_tc + 1 * T * C + t * C + c] != 0 for c in range(C))
        sweep = 3 * R + 3 + n_fv * (2 * C + 4) + 8 + sess.K
        score = n_sv * (C + 6) + 55
        ops += sess.Np * sweep + feas[b] * score + 2 * sess.Np * mrows[b]
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations"), nbytes, ops


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

    t0 = time.perf_counter()
    built = sk.build(verbose=True)
    log(f"phase 2: built scan_full in {built:.2f} s "
        f"({time.perf_counter() - t0:.2f} s with checks)")

    small_err = phase_small()

    # ---- phase 4: the main path at full size ----
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
    t0 = time.perf_counter()
    sess = ScanSession(enc.device_state("cuda"), templates, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
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

    sk.LAUNCHES = 0
    _, _, decisions = run_batch(0)  # warm-up
    torch.cuda.synchronize()
    carry_before = clone(sess._carry)
    stage.update(dict.fromkeys(stage, 0.0))
    t0 = time.perf_counter()
    batch1, ys1, d1 = run_batch(BATCH)
    _, _, d2 = run_batch(2 * BATCH)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    decisions += d1 + d2
    launches = sk.LAUNCHES
    pods_per_s = 2 * BATCH / window_s
    if launches != 3:
        raise AssertionError(f"scan_full launched {launches} times for 3 "
                             "batches")
    unplaced = sum(d < 0 for d in decisions)
    if unplaced:
        raise AssertionError(f"{unplaced} of {len(decisions)} pods unplaced")
    log(f"main path: {len(decisions)} pods placed, {launches} launches "
        f"for 3 batches; {pods_per_s:.1f} pods/s over the 2 measured "
        f"batches [{gpu}]")
    log("main path window (2 batches): " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in stage.items())
        + f", total {window_s * 1e3:.1f} ms")

    # the first measured batch again, from the same carry: kernel timing
    # (CUDA events) and the plain version on the card
    err, out, _, plain_ms = kernel_vs_plain(sess, batch1,
                                            clone(carry_before))
    if not torch.equal(out[:3, :BATCH], ys1["rows"][:3, :BATCH]):
        raise AssertionError("replayed batch differs from the main path's")
    meta, match = batch_inputs(sess, batch1)
    weights = tuple(int(sess.weights[k]) for k in sk.WEIGHT_ORDER)
    times = []
    for _ in range(3):
        c = clone(carry_before)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        sk.scan_full(meta, match, sess._get_statics(), c, sess.shapes,
                     weights)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    kernel_ms = statistics.median(times)
    bound_ms, bound_by, nbytes, ops = bound(sess, meta, match, out, BATCH)
    log(f"scan_full: {kernel_ms:.3f} ms per {BATCH}-pod batch at "
        f"{sess.N} nodes (runs {[round(x, 3) for x in times]}), plain "
        f"version {plain_ms:.1f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes} bytes, {ops} ops) [{gpu}]")

    kernels = [{
        "name": "scan_full",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/ops/csrc/scan_full.cu",
        "replaces": "kubernetes_tpu/ops/pallas_scan.py:1247",
        "launches": launches,
        "max_abs_err": max(err, small_err),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "matched": True,
    }]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
