"""Test/benchmark fixtures: pod/node builders and synthetic cluster
generators (reference: pkg/scheduler/testing/wrappers.go,
test/integration/scheduler_perf/config/performance-config.yaml)."""

from .synth import make_node, make_pod, synth_cluster, synth_pending_pods  # noqa: F401
