"""Event recording (client-go tools/record equivalent).

Reference: staging/src/k8s.io/client-go/tools/record/event.go — an
EventRecorder stamps Events (reason, message, involved object) and a
broadcaster sinks them to the apiserver; the scheduler emits "Scheduled" /
"FailedScheduling" (pkg/scheduler/scheduler.go:423) and preemption events.

Recording is ASYNCHRONOUS, like the reference's broadcaster (event.go
StartRecordingToSink drains a buffered watch channel on its own
goroutine; Event() never blocks the caller on the API write — a full
buffer drops the event). Here: event() enqueues onto a bounded deque
serviced by a daemon thread; overflow drops the INCOMING event (the
broadcaster's DropIfChannelFull) and counts it in dropped_events.
flush() waits for the queue to drain (tests; Scheduler.stop).

Events aggregate by (involved object, reason, message): a repeat bumps
count instead of creating a new object (event_aggregator semantics).
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..api import types as v1


@dataclass
class ObjectReference:
    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""


@dataclass
class Event:
    metadata: v1.ObjectMeta = field(default_factory=v1.ObjectMeta)
    involved_object: ObjectReference = field(default_factory=ObjectReference)
    reason: str = ""
    message: str = ""
    type: str = "Normal"  # Normal | Warning
    count: int = 1
    first_timestamp: Optional[float] = None
    last_timestamp: Optional[float] = None
    source_component: str = ""
    kind: str = "Event"
    api_version: str = "v1"


class EventRecorder:
    MAX_QUEUE = 4096  # event.go maxQueuedEvents-equivalent backpressure

    def __init__(self, clientset, component: str):
        self._client = clientset.resource("events")
        self._component = component
        self._lock = threading.Lock()
        self._known: Dict[tuple, str] = {}  # aggregation key -> event name
        # unbounded deque, bounded by hand in event(): the INCOMING event
        # is dropped when full (watch.NewBroadcaster's DropIfChannelFull
        # — a full channel never evicts already-queued events), counted
        # in dropped_events
        self._queue: deque = deque()
        self.dropped_events = 0
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._thread: Optional[threading.Thread] = None
        # unique-name suffix: one uuid per recorder + a counter, instead of
        # a uuid4 per event (uuid4 was visible in bind-path profiles)
        self._name_base = uuid.uuid4().hex[:6]
        self._seq = itertools.count()

    def event(self, obj, event_type: str, reason: str, message: str) -> None:
        """Enqueue; never blocks on the API (record never blocks callers)."""
        ref = ObjectReference(
            kind=getattr(obj, "kind", ""),
            namespace=obj.metadata.namespace,
            name=obj.metadata.name,
            uid=obj.metadata.uid,
        )
        with self._lock:
            if len(self._queue) >= self.MAX_QUEUE:
                self.dropped_events += 1
                return
            self._idle.clear()
            self._queue.append((ref, event_type, reason, message, time.time()))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="event-broadcaster"
                )
                self._thread.start()
        self._wake.set()

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait until every queued event has been sunk (test/shutdown aid)."""
        return self._idle.wait(timeout)

    def _run(self) -> None:
        while True:
            self._wake.wait()
            while True:
                with self._lock:
                    if not self._queue:
                        self._wake.clear()
                        self._idle.set()
                        break
                    batch = [self._queue.popleft()
                             for _ in range(min(len(self._queue), 256))]
                self._sink_batch(batch)

    def _sink_batch(self, batch) -> None:
        """Aggregation-aware bulk sink: repeats of known keys take the
        per-event count-bump path; NEW events go out as one bulk create
        (a 2048-pod bind wave is 2048 Scheduled events — one POST each
        was a visible slice of the wire tax)."""
        fresh: Dict[tuple, Event] = {}
        for item in batch:
            ref, event_type, reason, message, now = item
            key = (ref.kind, ref.namespace, ref.name, reason, message)
            dup = fresh.get(key)
            if dup is not None:
                # in-batch repeat: aggregate before it ever hits the API
                dup.count += 1
                dup.last_timestamp = now
                continue
            with self._lock:
                known = key in self._known
            if known:
                self._sink(*item)
                continue
            name = f"{ref.name}.{self._name_base}{next(self._seq):x}"
            fresh[key] = Event(
                metadata=v1.ObjectMeta(
                    name=name, namespace=ref.namespace or "default"
                ),
                involved_object=ref,
                reason=reason,
                message=message,
                type=event_type,
                first_timestamp=now,
                last_timestamp=now,
                source_component=self._component,
            )
        if not fresh:
            return
        try:
            self._client.create_many(list(fresh.values()))
            with self._lock:
                for key, ev in fresh.items():
                    self._known[key] = ev.metadata.name
        except Exception:  # noqa: BLE001 — events are best-effort
            pass

    def _sink(self, ref: ObjectReference, event_type: str, reason: str,
              message: str, now: float) -> None:
        key = (ref.kind, ref.namespace, ref.name, reason, message)
        with self._lock:
            existing_name = self._known.get(key)
        try:
            if existing_name:
                try:
                    ev = self._client.get(existing_name, ref.namespace or "default")
                    ev.count += 1
                    ev.last_timestamp = now
                    self._client.update(ev)
                    return
                except Exception:
                    pass  # fall through to create
            name = f"{ref.name}.{self._name_base}{next(self._seq):x}"
            ev = Event(
                metadata=v1.ObjectMeta(name=name, namespace=ref.namespace or "default"),
                involved_object=ref,
                reason=reason,
                message=message,
                type=event_type,
                first_timestamp=now,
                last_timestamp=now,
                source_component=self._component,
            )
            self._client.create(ev)
            with self._lock:
                self._known[key] = name
        except Exception:
            pass  # events are best-effort
