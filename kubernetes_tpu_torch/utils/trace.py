"""Latency tracing with threshold logging (k8s.io/utils/trace equivalent).

Reference: the scheduler wraps each cycle in a utiltrace span and logs the
step breakdown only when it exceeds a threshold
(pkg/scheduler/core/generic_scheduler.go:96-97, 100ms); apiserver handlers
do the same per request (endpoints/handlers/create.go:52).

The structured sibling lives in utils/tracing.py (span recorder +
flight recorder): a Trace answers "was this ONE cycle slow?" at a log
line; record_spans() forwards its step breakdown into the flight
recorder so threshold traces and pipeline spans land in the same
exportable record.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, Tuple


class Trace:
    def __init__(self, name: str, **fields):
        self.name = name
        self.fields = fields
        self.start = time.perf_counter()
        self.steps: List[Tuple[float, str]] = []

    def step(self, msg: str) -> None:
        self.steps.append((time.perf_counter(), msg))

    def total_seconds(self) -> float:
        return time.perf_counter() - self.start

    def record_spans(self, stage: str = "cycle") -> None:
        """Mirror the step breakdown into the flight recorder (one span
        per step, named "<trace>/<step>"); no-op when tracing is off."""
        from . import tracing

        if not tracing.enabled():
            return
        last = self.start
        for t, msg in self.steps:
            tracing.RECORDER.record(
                f"{self.name}/{msg}", stage, last, t - last,
                self.fields or None,
            )
            last = t

    def log_if_long(self, threshold: float, out=sys.stderr) -> bool:
        total = self.total_seconds()
        if total < threshold:
            return False
        fields = ",".join(f"{k}={v}" for k, v in self.fields.items())
        print(f'Trace "{self.name}" ({fields}): total {total*1000:.1f}ms', file=out)
        last = self.start
        for t, msg in self.steps:
            print(f"  step {((t - last) * 1000):.1f}ms: {msg}", file=out)
            last = t
        return True
