"""Kubemark: hollow nodes for simulated scale.

Reference: pkg/kubemark/hollow_kubelet.go:105 — REAL kubelet code with
every external effector faked (fake CRI, fake mounter, fake cadvisor…)
so thousands of nodes can run against one control plane. Here a
HollowCluster spins N Kubelet instances, each with its own
FakeRuntimeService, against the in-proc apiserver.
"""

from .hollow import HollowCluster  # noqa: F401
