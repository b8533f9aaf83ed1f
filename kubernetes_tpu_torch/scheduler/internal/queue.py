"""Scheduling queue: activeQ + backoffQ + unschedulableQ.

Reference: pkg/scheduler/internal/queue/scheduling_queue.go:113
PriorityQueue —

  * activeQ: heap ordered by the profile's QueueSort less() (PrioritySort:
    higher .spec.priority first, then earlier timestamp;
    plugins/queuesort/priority_sort.go);
  * podBackoffQ: heap by backoff expiry; backoff = 1s * 2^attempts capped
    at 10s (:48 DefaultPodInitialBackoffDuration/DefaultPodMaxBackoff);
  * unschedulableQ: map of pods that failed scheduling, flushed to active/
    backoff by MoveAllToActiveOrBackoffQueue on cluster events (:292) or
    by the 60s leftover flusher (:60 unschedulableQTimeInterval);
  * schedulingCycle / moveRequestCycle (:120-134): a pod that failed in a
    cycle started BEFORE the last move request may have missed the event,
    so it goes to backoffQ instead of unschedulableQ (:365).

Pop blocks; flushes run lazily inside the pop wait loop (the reference
runs them on goroutine tickers — same observable behavior, no threads).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ...api import types as v1
from ..framework.types import QueuedPodInfo

DEFAULT_POD_INITIAL_BACKOFF = 1.0  # scheduling_queue.go:48
DEFAULT_POD_MAX_BACKOFF = 10.0
UNSCHEDULABLE_Q_TIME_INTERVAL = 60.0  # scheduling_queue.go:60


def default_less(a: QueuedPodInfo, b: QueuedPodInfo) -> bool:
    """PrioritySort.Less (plugins/queuesort/priority_sort.go:45).

    Equal priority ties break on pod CREATION time, then queue-entry
    time. The reference's QueuedPodInfo.Timestamp survives requeues, so
    its order is first-seen; ours is rebuilt per add, and an informer's
    initial list delivers in store-key (lexicographic) order — without
    the creation tie-break a cold-restarted scheduler would pop the
    same backlog in a different order than the instance that watched
    the pods arrive, and restart-reconcile parity (bit-identical
    assignments) breaks."""
    pa = a.pod.spec.priority or 0
    pb = b.pod.spec.priority or 0
    if pa != pb:
        return pa > pb
    ca = a.pod.metadata.creation_timestamp or a.timestamp
    cb = b.pod.metadata.creation_timestamp or b.timestamp
    if ca != cb:
        return ca < cb
    return a.timestamp < b.timestamp


class _Heap:
    """Stable heap over QueuedPodInfo with a less() comparator."""

    def __init__(self, less: Callable[[QueuedPodInfo, QueuedPodInfo], bool]):
        self._less = less
        self._seq = itertools.count()
        self._items: List[Tuple[object, QueuedPodInfo]] = []
        self._keys: Dict[str, object] = {}  # pod key -> wrapper identity

    class _Wrap:
        __slots__ = ("info", "less", "seq", "removed")

        def __init__(self, info, less, seq):
            self.info = info
            self.less = less
            self.seq = seq
            self.removed = False

        def __lt__(self, other):
            if self.less(self.info, other.info):
                return True
            if self.less(other.info, self.info):
                return False
            return self.seq < other.seq

    def push(self, info: QueuedPodInfo) -> None:
        key = v1.pod_key(info.pod)
        self.delete(info.pod)
        w = self._Wrap(info, self._less, next(self._seq))
        self._keys[key] = w
        heapq.heappush(self._items, (w, info))

    def pop(self) -> Optional[QueuedPodInfo]:
        while self._items:
            w, info = heapq.heappop(self._items)
            if not w.removed:
                del self._keys[v1.pod_key(info.pod)]
                return info
        return None

    def peek(self) -> Optional[QueuedPodInfo]:
        while self._items:
            w, info = self._items[0]
            if w.removed:
                heapq.heappop(self._items)
                continue
            return info
        return None

    def delete(self, pod: v1.Pod) -> bool:
        w = self._keys.pop(v1.pod_key(pod), None)
        if w is not None:
            w.removed = True
            return True
        return False

    def get(self, pod: v1.Pod) -> Optional[QueuedPodInfo]:
        w = self._keys.get(v1.pod_key(pod))
        return w.info if w else None

    def __contains__(self, pod_key: str) -> bool:
        return pod_key in self._keys

    def __len__(self) -> int:
        return len(self._keys)

    def items(self) -> List[QueuedPodInfo]:
        return [w.info for w in self._keys.values()]


class PriorityQueue:
    def __init__(
        self,
        less: Callable[[QueuedPodInfo, QueuedPodInfo], bool] = default_less,
        pod_initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
        pod_max_backoff: float = DEFAULT_POD_MAX_BACKOFF,
        now=time.monotonic,
    ):
        self._lock = threading.Condition()
        self._now = now
        self._initial_backoff = pod_initial_backoff
        self._max_backoff = pod_max_backoff
        self._active = _Heap(less)
        self._backoff = _Heap(self._backoff_less)
        self._unschedulable: Dict[str, QueuedPodInfo] = {}
        self._scheduling_cycle = 0
        self._move_request_cycle = 0
        self._closed = False
        self._last_leftover_flush = self._now()

    # -- backoff math (scheduling_queue.go:746 getBackoffTime) -------------

    def _backoff_duration(self, info: QueuedPodInfo) -> float:
        d = self._initial_backoff
        for _ in range(info.attempts - 1):
            d *= 2
            if d >= self._max_backoff:
                return self._max_backoff
        return d

    def _backoff_expiry(self, info: QueuedPodInfo) -> float:
        return info.last_failure_timestamp + self._backoff_duration(info)

    def _backoff_less(self, a: QueuedPodInfo, b: QueuedPodInfo) -> bool:
        return self._backoff_expiry(a) < self._backoff_expiry(b)

    def _is_backing_off(self, info: QueuedPodInfo) -> bool:
        return self._backoff_expiry(info) > self._now()

    # -- producers ---------------------------------------------------------

    def add(self, pod: v1.Pod) -> None:
        with self._lock:
            info = QueuedPodInfo(pod, timestamp=self._now())
            key = v1.pod_key(pod)
            self._backoff.delete(pod)
            self._unschedulable.pop(key, None)
            self._active.push(info)
            self._lock.notify()

    def requeue_with_backoff(self, pod: v1.Pod) -> None:
        """Failed-attempt requeue for a pod that HELD capacity (a
        rolled-back gang member): enter through the backoff heap at the
        initial backoff, not the active heap. An active-heap re-entry
        would let the rollback's own members instantly re-camp the
        capacity their rollback just released — under the gang deadlock
        breaker that is a livelock: the backed-off wave's members beat
        the stalled rival gang's pending member to every pop, the
        mutual stall re-forms, and the breaker alternates victims
        forever with zero progress."""
        with self._lock:
            key = v1.pod_key(pod)
            if (
                key in self._unschedulable
                or self._active.get(pod)
                or self._backoff.get(pod)
            ):
                return
            info = QueuedPodInfo(pod, timestamp=self._now())
            info.attempts = 1  # first backoff rung (initial_backoff)
            info.last_failure_timestamp = self._now()
            self._backoff.push(info)
            self._lock.notify()

    def add_unschedulable_if_not_present(
        self, info: QueuedPodInfo, pod_scheduling_cycle: int
    ) -> None:
        """scheduling_queue.go:365 AddUnschedulableIfNotPresent."""
        with self._lock:
            key = v1.pod_key(info.pod)
            if (
                key in self._unschedulable
                or self._active.get(info.pod)
                or self._backoff.get(info.pod)
            ):
                return
            info.last_failure_timestamp = self._now()
            if self._move_request_cycle >= pod_scheduling_cycle:
                self._backoff.push(info)
            else:
                self._unschedulable[key] = info
            self._lock.notify()

    def update(self, old_pod: Optional[v1.Pod], new_pod: v1.Pod) -> None:
        """scheduling_queue.go:445 Update: refresh in place; an update to an
        unschedulable pod that might make it schedulable moves it out."""
        with self._lock:
            info = self._active.get(new_pod)
            if info is not None:
                info.pod = new_pod
                self._active.push(info)
                return
            info = self._backoff.get(new_pod)
            if info is not None:
                info.pod = new_pod
                return
            key = v1.pod_key(new_pod)
            info = self._unschedulable.get(key)
            if info is not None:
                info.pod = new_pod
                if old_pod is not None and self._spec_changed(old_pod, new_pod):
                    del self._unschedulable[key]
                    if self._is_backing_off(info):
                        self._backoff.push(info)
                    else:
                        self._active.push(info)
                    self._lock.notify()
                return
            self._active.push(QueuedPodInfo(new_pod, timestamp=self._now()))
            self._lock.notify()

    @staticmethod
    def _spec_changed(old: v1.Pod, new: v1.Pod) -> bool:
        from ...utils import serde

        return serde.to_dict(old.spec) != serde.to_dict(new.spec) or (
            old.metadata.labels != new.metadata.labels
        )

    def delete(self, pod: v1.Pod) -> None:
        with self._lock:
            self._active.delete(pod)
            self._backoff.delete(pod)
            self._unschedulable.pop(v1.pod_key(pod), None)

    # -- cluster events (scheduling_queue.go:292) --------------------------

    def move_all_to_active_or_backoff_queue(self, event: str) -> None:
        with self._lock:
            for key, info in list(self._unschedulable.items()):
                if self._is_backing_off(info):
                    self._backoff.push(info)
                else:
                    self._active.push(info)
                del self._unschedulable[key]
            self._move_request_cycle = self._scheduling_cycle
            self._lock.notify_all()

    def activate(self, pod: v1.Pod) -> bool:
        """scheduling_queue.go Activate: move THIS pod to activeQ now,
        from wherever it is parked (unschedulableQ or backoffQ),
        skipping any remaining backoff. The scheduler calls it when an
        event provably resolves the pod's unschedulability — a nominated
        preemptor whose last victim's delete just echoed (the reference's
        queueing-hint immediate path; waiting out 2^attempts backoff
        after the victim is already gone is pure idle time — the r3
        preemption workload spent most of its 88.6s p50 pod latency
        exactly there). Returns False when the pod is not parked here
        (already active, or not yet re-added — callers handle that by
        checking pending state at add time)."""
        with self._lock:
            key = v1.pod_key(pod)
            info = self._unschedulable.pop(key, None)
            if info is None:
                info = self._backoff.get(pod)
                if info is not None:
                    self._backoff.delete(pod)
            if info is None:
                return False
            self._active.push(info)
            self._move_request_cycle = self._scheduling_cycle
            self._lock.notify_all()
            return True

    # -- consumer ----------------------------------------------------------

    @property
    def scheduling_cycle(self) -> int:
        with self._lock:
            return self._scheduling_cycle

    def pop(self, timeout: Optional[float] = None) -> Optional[QueuedPodInfo]:
        """Blocks for the highest-priority active pod; counts the cycle."""
        deadline = None if timeout is None else self._now() + timeout
        with self._lock:
            while not self._closed:
                self._flush_locked()
                info = self._active.pop()
                if info is not None:
                    self._scheduling_cycle += 1
                    info.attempts += 1
                    return info
                wait = 0.1
                if deadline is not None:
                    remaining = deadline - self._now()
                    if remaining <= 0:
                        return None
                    wait = min(wait, remaining)
                self._lock.wait(wait)
            return None

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    # -- flushers (lazy; reference: ticker goroutines at :257-259) ---------

    def _flush_locked(self) -> None:
        now = self._now()
        while True:
            info = self._backoff.peek()
            if info is None or self._backoff_expiry(info) > now:
                break
            self._backoff.pop()
            self._active.push(info)
        if now - self._last_leftover_flush >= UNSCHEDULABLE_Q_TIME_INTERVAL:
            self._last_leftover_flush = now
            for key, info in list(self._unschedulable.items()):
                if now - info.last_failure_timestamp >= UNSCHEDULABLE_Q_TIME_INTERVAL:
                    del self._unschedulable[key]
                    if self._is_backing_off(info):
                        self._backoff.push(info)
                    else:
                        self._active.push(info)

    # -- introspection -----------------------------------------------------

    def pending_pods(self) -> List[v1.Pod]:
        with self._lock:
            return (
                [i.pod for i in self._active.items()]
                + [i.pod for i in self._backoff.items()]
                + [i.pod for i in self._unschedulable.values()]
            )

    def num_active(self) -> int:
        with self._lock:
            return len(self._active)

    def depths(self) -> Tuple[int, int, int]:
        """(active, backoff, unschedulable) counts — the cheap form of
        pending_pods() for per-tick consumers (the overload monitor and
        the scheduler_pending_pods gauges) that must not copy the queue
        contents on every completed batch."""
        with self._lock:
            return (
                len(self._active),
                len(self._backoff),
                len(self._unschedulable),
            )
