"""Entry points of the port: one scheduling step on a device, and a dry
run of the node-sharded mesh.

The port's counterpart of the repo's `__graft_entry__.py`. `entry()`
gives the flagship function (ops/kernel.py `schedule_pod`: filter and
score every node of a cluster for one pending pod) and its arguments on
`device`, the card unless the caller names another. `dryrun_multichip`
runs the mesh (parallel/sharded.py, ops/sharded_scan.py): one step of
`ShardedScheduler`, the hoisted and the node-sharded sessions against
their single-device twins, the backend's mesh session build, and a short
scheduler loop on the mesh.
"""

from __future__ import annotations

import copy
import random
import time
from typing import Dict

import torch

from .device import resolve_device


def _example_inputs(n_nodes: int = 16, n_pods: int = 32, device=None,
                    pod_tensors: bool = True):
    """Small synthetic cluster + one pending pod, encoded for the kernel:
    the cluster on `device`, the pod's arrays too (`pod_tensors`) or as
    the encoder's numpy arrays."""
    from .models.encoding import ClusterEncoding
    from .models.pod_encoder import PodEncoder
    from .testing.synth import synth_cluster, synth_pending_pods

    dev = resolve_device(device)
    nodes, pods = synth_cluster(n_nodes, pods_per_node=max(1, n_pods // n_nodes))
    enc = ClusterEncoding()
    enc.set_cluster(nodes, pods)
    pe = PodEncoder(enc)
    pending = synth_pending_pods(1, spread=True)[0]
    pod_arrays = {
        k: torch.as_tensor(v).to(dev) if pod_tensors else v
        for k, v in pe.encode(pending).items() if not k.startswith("_")
    }
    cluster = enc.device_state(dev)  # after encode: vocabs may have grown
    return cluster, pod_arrays


def entry(device=None):
    """(fn, example_args): `schedule_pod` and its (cluster, pod) tensors on
    `device` (the card by default)."""
    from .ops.kernel import schedule_pod

    cluster, pod_arrays = _example_inputs(device=device)
    return schedule_pod, (cluster, pod_arrays)


def mesh_for(n_devices: int, device=None):
    """The dry run's mesh: the larger of 8 and `n_devices` node-axis shards
    over `n_devices` groups: the first CUDA devices, or `device` named
    `n_devices` times (eight "cpu" groups are the cross-group path on one
    host)."""
    from .parallel.sharded import make_mesh

    if device is not None:
        devices = [resolve_device(device)] * n_devices
    else:
        resolve_device(None)
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                               f"{n_devices} CUDA devices; {have} present")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    return make_mesh(devices=devices, n_devices=max(8, n_devices))


def dryrun_multichip(n_devices: int, device=None) -> Dict:
    """Run the scheduling step and a short loop over a mesh of
    `n_devices` groups (`mesh_for`); raises on any disagreement. Returns
    the mesh's layout and the session builds it counted."""
    from .parallel.sharded import ShardedScheduler

    mesh = mesh_for(n_devices, device)
    sched = ShardedScheduler(mesh=mesh)
    n = 4 * mesh.nsh
    cluster, pod_arrays = _example_inputs(n_nodes=n, n_pods=8,
                                          device=mesh.lead,
                                          pod_tensors=False)
    out = sched.schedule(cluster, pod_arrays)
    n_feasible = int(out["n_feasible"])
    assert n_feasible > 0, "dry run scheduled a pod onto an empty feasible set"
    assert int(out["best_idx"]) < cluster["valid"].shape[0]

    # the batched step over the mesh: the template-hoisted scan over the
    # padded cluster
    from .testing.synth import synth_cluster, synth_pending_pods

    nodes, init_pods = synth_cluster(n, pods_per_node=1)
    pending = synth_pending_pods(8, spread=True)
    c, arrays, _ = _synth_session_inputs(nodes, init_pods, pending,
                                         mesh.lead)
    decisions, _ = sched.schedule_batch_hoisted(c, arrays)
    assert len(decisions) == len(pending)
    assert any(d >= 0 for d in decisions), "sharded batch bound no pods"

    _dryrun_session_512(sched)
    builds = _dryrun_sharded_scan(mesh, n_nodes=512)
    _dryrun_scheduler_loop(mesh, n_nodes=512)
    return {"layout": mesh.layout, "session_builds": builds}


def _synth_session_inputs(nodes, init_pods, pending, device):
    """(cluster tensors on `device`, encoded pending, deduped templates):
    the encoder pre-sized with phantom copies of the pending pods (the pod
    table must fit the whole run: no re-encode inside a session)."""
    from .models.encoding import ClusterEncoding
    from .models.pod_encoder import PodEncoder
    from .ops.hoisted import template_fingerprint

    enc = ClusterEncoding()
    phantoms = []
    for i, p in enumerate(pending):
        q = copy.deepcopy(p)
        q.metadata.name = f"ph-{i}"
        q.spec.node_name = nodes[i % len(nodes)].metadata.name
        phantoms.append(q)
    enc.set_cluster(
        copy.deepcopy(nodes), copy.deepcopy(init_pods) + phantoms)
    pe = PodEncoder(enc)
    arrays = [
        {k: v for k, v in pe.encode(p).items() if not k.startswith("_")}
        for p in pending
    ]
    enc.device_state(device)
    for q in phantoms:
        enc.remove_pod(q)
    templates, seen = [], set()
    for a in arrays:
        fp = template_fingerprint(a)
        if fp not in seen:
            seen.add(fp)
            templates.append(a)
    return enc.device_state(device), arrays, templates


def _dryrun_session_512(sched, n_nodes: int = 512) -> None:
    """The hoisted session over the mesh against the single-device one,
    with a hostname anti-affinity template (the dynamic term carries)."""
    from .api import types as v1
    from .ops.hoisted import HoistedSession
    from .testing.synth import make_pod, synth_cluster

    lead = sched.mesh.lead
    nodes, init_pods = synth_cluster(n_nodes, pods_per_node=1)
    anti = v1.Affinity(
        pod_anti_affinity=v1.PodAntiAffinity(
            required_during_scheduling_ignored_during_execution=[
                v1.PodAffinityTerm(
                    label_selector=v1.LabelSelector(
                        match_labels={"app": "churn"}
                    ),
                    topology_key=v1.LABEL_HOSTNAME,
                )
            ]
        )
    )
    pending = [
        make_pod(f"m-{i}", cpu="50m", labels={"app": "churn"}, affinity=anti)
        for i in range(48)
    ]
    cluster, arrays, templates = _synth_session_inputs(
        nodes, init_pods, pending, lead)
    single = HoistedSession(dict(cluster), templates, device=lead)
    multi = sched.session(cluster, templates)
    got_single, got_multi = [], []
    for lo in range(0, len(arrays), 24):
        batch = arrays[lo:lo + 24]
        got_single.extend(
            HoistedSession.decisions(single.schedule(batch))[:len(batch)])
        got_multi.extend(
            HoistedSession.decisions(multi.schedule(batch))[:len(batch)])
    assert got_multi == got_single, (
        f"mesh session diverged from single-device: "
        f"{got_multi} != {got_single}")
    placed = [d for d in got_multi if d >= 0]
    assert len(placed) == len(set(placed)) == 48, (
        "hostname anti-affinity must place one pod per node")


def _dryrun_sharded_scan(mesh, n_nodes: int = 512) -> Dict[str, float]:
    """ShardedScanSession against ScanSession at `n_nodes`, then the
    backend's mesh session build, counted in
    scheduler_tpu_session_builds_total{kind, reason, shards}."""
    from .ops.scan import ScanSession
    from .ops.sharded_scan import ShardedScanSession
    from .testing.synth import synth_cluster, synth_pending_pods

    nodes, init_pods = synth_cluster(n_nodes, pods_per_node=1)
    pending = synth_pending_pods(48, spread=True)
    cluster, arrays, templates = _synth_session_inputs(
        nodes, init_pods, pending, mesh.lead)
    single = ScanSession(dict(cluster), templates, multipod_k=1,
                         device=mesh.lead)
    cluster2, arrays2, templates2 = _synth_session_inputs(
        nodes, init_pods, pending, mesh.lead)
    multi = ShardedScanSession(cluster2, templates2, mesh=mesh,
                               multipod_k=1)
    got_single, got_multi = [], []
    for lo in range(0, len(arrays), 24):
        got_single.extend(ScanSession.decisions(
            single.schedule(arrays[lo:lo + 24]))[:24])
        got_multi.extend(ScanSession.decisions(
            multi.schedule(arrays2[lo:lo + 24]))[:24])
    assert got_multi == got_single, (
        f"sharded session diverged from the single-device session: "
        f"{got_multi} != {got_single}")
    assert all(d >= 0 for d in got_multi), "sharded session bound nothing"

    # the backend's session build on the mesh path
    from .ops.hoisted import template_fingerprint
    from .scheduler.metrics import session_builds
    from .scheduler.tpu_backend import TPUBackend

    labels = dict(kind="kernel", reason="mesh-sharded", shards=str(mesh.nsh))
    before = session_builds.value(**labels)
    backend = TPUBackend(rng=random.Random(0), mesh=mesh)
    for n in nodes:
        backend.enc.add_node(n)
    for p in init_pods:
        if p.spec.node_name:
            backend.enc.add_pod(p, p.spec.node_name)
    for p in pending:  # templates from the backend's own vocabularies
        a = {k: v for k, v in backend.pe.encode(p).items()
             if not k.startswith("_")}
        backend._known_templates.setdefault(template_fingerprint(a), a)
    with backend._on_stream():
        sess = backend._build_session()
    assert type(sess).__name__ == "ShardedScanSession", type(sess).__name__
    after = session_builds.value(**labels)
    assert after == before + 1, (before, after)
    return {f"{labels['kind']}/{labels['reason']}@{labels['shards']}": after}


def _dryrun_scheduler_loop(mesh, n_nodes: int = 512) -> None:
    """The scheduler loop (apiserver, informers, queue, cache) driving
    TPUBackend(mesh=...): 48 pods, half with hostname anti-affinity."""
    from .api import types as v1
    from .apiserver import APIServer
    from .client import Clientset, SharedInformerFactory
    from .scheduler.scheduler import Scheduler
    from .scheduler.tpu_backend import TPUBackend
    from .testing.synth import make_node, make_pod

    api = APIServer()
    cs = Clientset(api)
    for i in range(n_nodes):
        cs.nodes.create(make_node(
            f"node-{i}",
            labels={
                v1.LABEL_HOSTNAME: f"node-{i}",
                v1.LABEL_ZONE: f"zone-{i % 3}",
            },
        ))
    factory = SharedInformerFactory(cs)
    backend = TPUBackend(rng=random.Random(0), mesh=mesh)
    sched = Scheduler(
        cs, factory, backend="tpu", tpu_backend=backend, max_batch=64
    )
    factory.start()
    if not factory.wait_for_cache_sync(120):
        raise RuntimeError("informer sync failed")
    sched.start()
    try:
        # stage the backlog so it goes out as one batch
        sched.pause()
        time.sleep(0.3)
        anti = v1.Affinity(pod_anti_affinity=v1.PodAntiAffinity(
            required_during_scheduling_ignored_during_execution=[
                v1.PodAffinityTerm(
                    label_selector=v1.LabelSelector(match_labels={"app": "dm"}),
                    topology_key=v1.LABEL_HOSTNAME,
                )
            ]
        ))
        n_pods = 48
        for i in range(n_pods):
            cs.pods.create(make_pod(
                f"dm-{i}", cpu="50m", labels={"app": "dm"},
                affinity=anti if i % 2 == 0 else None,
            ))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and sched.queue.num_active() < n_pods:
            time.sleep(0.05)
        sched.resume()
        if not sched.wait_idle(600):
            raise RuntimeError("meshed scheduler loop did not settle")
        pods, _ = cs.pods.list(namespace="default")
        bound = [p for p in pods if p.spec.node_name]
        assert len(bound) == n_pods, f"meshed loop bound {len(bound)}/{n_pods}"
        anti_nodes = [
            p.spec.node_name for p in bound
            if int(p.metadata.name.split("-")[1]) % 2 == 0
        ]
        assert len(set(anti_nodes)) == len(anti_nodes), (
            "hostname anti-affinity violated through the meshed loop")
    finally:
        sched.stop()
        factory.stop()

