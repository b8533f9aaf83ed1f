"""scheduler_perf: the reference's scheduler benchmark harness, rebuilt.

Reference: test/integration/scheduler_perf/ — declarative workloads
(config/performance-config.yaml), throughput sampling (util.go:220
ThroughputCollector, 1s interval), latency percentiles, and the density
thresholds (scheduler_test.go:40-41: fail <30 pods/s, warn <100)."""

from .harness import Workload, run_workload, DENSITY_FAIL_THRESHOLD, DENSITY_WARN_THRESHOLD  # noqa: F401
