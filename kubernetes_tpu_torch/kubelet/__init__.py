"""Node agent (kubelet equivalent) + hollow-node machinery.

Reference: pkg/kubelet (syncLoop kubelet.go:1831, pod workers
pod_workers.go:158, PLEG pleg/generic.go:190, CRI
cri/remote/remote_runtime.go, node status kubelet_node_status.go,
nodelease, prober, eviction) and pkg/kubemark (hollow_kubelet.go).
"""

from .cri import FakeRuntimeService, PodSandbox, RuntimeContainer  # noqa: F401
from .kubelet import Kubelet, KubeletConfig  # noqa: F401
