"""Node-side helpers the encoders import.

Partial copy of kubernetes_tpu/scheduler/plugins/nodebasic.py: the port
needs these names only, not the plugins (references: node_ports.go:60,
image_locality.go:118, node_prefer_avoid_pods.go).
"""

from __future__ import annotations

from typing import List

from ...api import types as v1


def get_container_ports(*pods: v1.Pod) -> List[v1.ContainerPort]:
    """node_ports.go:60 getContainerPorts."""
    ports = []
    for pod in pods:
        for container in pod.spec.containers:
            for port in container.ports or []:
                if port.host_port > 0:
                    ports.append(port)
    return ports


def normalized_image_name(name: str) -> str:
    """image_locality.go:118: append :latest when untagged."""
    if name.rfind(":") <= name.rfind("/"):
        name += ":latest"
    return name


PREFER_AVOID_PODS_ANNOTATION = "scheduler.alpha.kubernetes.io/preferAvoidPods"
