"""Prometheus-style metrics registry (component-base/metrics equivalent).

Reference: staging/src/k8s.io/component-base/metrics — Counter/Gauge/
Histogram vectors with label sets, a process-wide legacy registry
(legacyregistry/registry.go) backing every component's /metrics handler,
and text exposition in the Prometheus format.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class _Metric:
    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared {sorted(self.label_names)}"
            )
        return tuple(labels[k] for k in self.label_names)

    def _fmt_labels(self, key: Tuple[str, ...]) -> str:
        if not self.label_names:
            return ""
        inner = ",".join(f'{n}="{v}"' for n, v in zip(self.label_names, key))
        return "{" + inner + "}"


class Counter(_Metric):
    type_name = "counter"

    def __init__(self, name, help, label_names=()):
        super().__init__(name, help, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def items(self) -> List[Tuple[Tuple[str, ...], float]]:
        """All (label-values, value) pairs — the public iteration surface
        (consumers must not reach into _values/_lock)."""
        with self._lock:
            return list(self._values.items())

    def collect(self) -> List[str]:
        with self._lock:
            return [
                f"{self.name}{self._fmt_labels(k)} {v}"
                for k, v in sorted(self._values.items())
            ]


class Gauge(_Metric):
    type_name = "gauge"

    def __init__(self, name, help, label_names=()):
        super().__init__(name, help, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = value

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def remove(self, **labels) -> None:
        """Drop one label series (per-entity gauges — e.g. a per-watcher
        buffer depth — must not leak series after the entity is gone)."""
        with self._lock:
            self._values.pop(self._key(labels), None)

    collect = Counter.collect


class Histogram(_Metric):
    type_name = "histogram"

    def __init__(self, name, help, label_names=(), buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}
        if not label_names:
            # Prometheus convention: an unlabeled histogram exports at
            # zero from birth, so a reader can tell "no observations
            # yet" from "metric missing" — an SLI that only appears
            # under traffic is invisible exactly when its absence is
            # the signal (labeled series still appear on first use).
            key = self._key({})
            self._counts[key] = [0] * len(self.buckets)
            self._sums[key] = 0.0
            self._totals[key] = 0

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            i = bisect.bisect_left(self.buckets, value)
            if i < len(counts):
                counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def percentile(self, p: float, **labels) -> float:
        """Approximate percentile from bucket counts (upper bound)."""
        key = self._key(labels)
        with self._lock:
            counts = self._counts.get(key)
            total = self._totals.get(key, 0)
        if not counts or not total:
            return 0.0
        target = p / 100.0 * total
        acc = 0
        for i, cnt in enumerate(counts):
            acc += cnt
            if acc >= target:
                return self.buckets[i]
        return self.buckets[-1]

    def collect(self) -> List[str]:
        out = []
        with self._lock:
            for key in sorted(self._counts):
                cum = 0
                for i, b in enumerate(self.buckets):
                    cum += self._counts[key][i]
                    labels = list(zip(self.label_names, key)) + [("le", str(b))]
                    inner = ",".join(f'{n}="{v}"' for n, v in labels)
                    out.append(f"{self.name}_bucket{{{inner}}} {cum}")
                inf_labels = list(zip(self.label_names, key)) + [("le", "+Inf")]
                inner = ",".join(f'{n}="{v}"' for n, v in inf_labels)
                out.append(f"{self.name}_bucket{{{inner}}} {self._totals[key]}")
                out.append(f"{self.name}_sum{self._fmt_labels(key)} {self._sums[key]}")
                out.append(f"{self.name}_count{self._fmt_labels(key)} {self._totals[key]}")
        return out


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
            return metric

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def expose(self) -> str:
        """Prometheus text format (the /metrics body)."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.type_name}")
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


# the process-wide registry (legacyregistry)
legacy_registry = Registry()
