"""Synthetic cluster + workload generators.

Shapes follow the reference's scheduler_perf harness: nodes of 110 pods /
4 CPU / 32Gi (reference: test/integration/scheduler_perf/
scheduler_test.go:56-60 makeBasePod and node template), zone-labelled for
topology-spread workloads (config/performance-config.yaml), pods stamped
from a small set of templates so encoding caches amortize exactly as the
harness's template-stamped pods do.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ..api import types as v1


def make_node(
    name: str,
    cpu: str = "4",
    memory: str = "32Gi",
    pods: int = 110,
    labels: Optional[Dict[str, str]] = None,
    taints: Optional[List[v1.Taint]] = None,
    unschedulable: bool = False,
    images: Optional[List[v1.ContainerImage]] = None,
    extended: Optional[Dict[str, str]] = None,
) -> v1.Node:
    alloc = {"cpu": cpu, "memory": memory, "pods": str(pods)}
    if extended:
        alloc.update(extended)
    return v1.Node(
        metadata=v1.ObjectMeta(name=name, labels=dict(labels or {})),
        spec=v1.NodeSpec(unschedulable=unschedulable, taints=taints),
        status=v1.NodeStatus(capacity=dict(alloc), allocatable=alloc, images=images),
    )


def make_pod(
    name: str,
    namespace: str = "default",
    cpu: Optional[str] = None,
    memory: Optional[str] = None,
    node_name: str = "",
    labels: Optional[Dict[str, str]] = None,
    priority: Optional[int] = None,
    affinity: Optional[v1.Affinity] = None,
    constraints: Optional[List[v1.TopologySpreadConstraint]] = None,
    image: str = "registry.example/app:v1",
    extended: Optional[Dict[str, str]] = None,
) -> v1.Pod:
    requests: Dict[str, str] = {}
    if cpu is not None:
        requests["cpu"] = cpu
    if memory is not None:
        requests["memory"] = memory
    if extended:
        requests.update(extended)
    return v1.Pod(
        metadata=v1.ObjectMeta(name=name, namespace=namespace, labels=dict(labels or {})),
        spec=v1.PodSpec(
            containers=[
                v1.Container(
                    name="c0",
                    image=image,
                    resources=v1.ResourceRequirements(requests=requests or None),
                )
            ],
            node_name=node_name,
            priority=priority,
            affinity=affinity,
            topology_spread_constraints=constraints,
        ),
    )


def synth_cluster(
    n_nodes: int,
    n_zones: int = 3,
    pods_per_node: int = 0,
    seed: int = 0,
) -> tuple:
    """Nodes with hostname/zone/region topology labels plus pods_per_node
    running pods stamped from one template (the scheduler_perf initPods
    pattern). Returns (nodes, pods)."""
    rng = random.Random(seed)
    nodes: List[v1.Node] = []
    for i in range(n_nodes):
        name = f"node-{i}"
        labels = {
            v1.LABEL_HOSTNAME: name,
            v1.LABEL_ZONE: f"zone-{i % n_zones}",
            v1.LABEL_REGION: f"region-{i % n_zones % 2}",
        }
        nodes.append(make_node(name, labels=labels))
    pods: List[v1.Pod] = []
    for i in range(n_nodes * pods_per_node):
        node = f"node-{rng.randrange(n_nodes)}"
        pods.append(
            make_pod(
                f"init-pod-{i}",
                cpu="10m",
                memory="16Mi",
                node_name=node,
                labels={"app": f"init-{i % 8}"},
            )
        )
    return nodes, pods


def synth_pending_pods(
    n_pods: int,
    n_templates: int = 4,
    cpu: str = "100m",
    memory: str = "128Mi",
    spread: bool = False,
) -> List[v1.Pod]:
    """Pending pods stamped from n_templates distinct specs (labels differ
    per template; names differ per pod). With spread=True each template
    carries a zone topology-spread constraint (the PodTopologySpread
    benchmark shape: performance-config.yaml SchedulingPodTopologySpread)."""
    pods: List[v1.Pod] = []
    for i in range(n_pods):
        t = i % n_templates
        labels = {"app": f"tmpl-{t}"}
        constraints = None
        if spread:
            constraints = [
                v1.TopologySpreadConstraint(
                    max_skew=1,
                    topology_key=v1.LABEL_ZONE,
                    when_unsatisfiable="ScheduleAnyway",
                    label_selector=v1.LabelSelector(match_labels=dict(labels)),
                )
            ]
        pods.append(
            make_pod(
                f"pending-{i}",
                cpu=cpu,
                memory=memory,
                labels=labels,
                constraints=constraints,
            )
        )
    return pods
