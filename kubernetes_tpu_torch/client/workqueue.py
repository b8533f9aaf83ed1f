"""Rate-limited work queues (client-go util/workqueue equivalent).

Reference: staging/src/k8s.io/client-go/util/workqueue —
queue.go (dedupe: dirty/processing sets), delaying_queue.go (AddAfter via
heap + timer thread), default_rate_limiters.go (per-item exponential
backoff, ItemExponentialFailureRateLimiter 5ms→1000s).
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple


class WorkQueue:
    """Deduplicating FIFO: an item being processed that is re-added is
    re-queued only after Done (queue.go:65)."""

    def __init__(self):
        self._lock = threading.Condition()
        self._queue: List[Any] = []
        self._dirty: Set[Any] = set()
        self._processing: Set[Any] = set()
        self._shutting_down = False

    def add(self, item: Any) -> None:
        with self._lock:
            self._add_locked(item)

    def _add_locked(self, item: Any) -> None:
        if self._shutting_down or item in self._dirty:
            return
        self._dirty.add(item)
        if item in self._processing:
            return
        self._queue.append(item)
        # notify_all: the delaying-timer thread waits on this condition too,
        # and notify() could wake it instead of a consumer
        self._lock.notify_all()

    def get(self, timeout: Optional[float] = None) -> Tuple[Optional[Any], bool]:
        """(item, shutdown). Blocks until an item or shutdown."""
        with self._lock:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._queue and not self._shutting_down:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None, False
                self._lock.wait(remaining)
            if not self._queue:
                return None, True
            item = self._queue.pop(0)
            self._processing.add(item)
            self._dirty.discard(item)
            return item, False

    def done(self, item: Any) -> None:
        with self._lock:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._lock.notify_all()

    def shutdown(self) -> None:
        with self._lock:
            self._shutting_down = True
            self._lock.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)


class RateLimitingQueue(WorkQueue):
    """WorkQueue + AddAfter + per-item exponential failure backoff."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 1000.0):
        super().__init__()
        self._base_delay = base_delay
        self._max_delay = max_delay
        self._failures: Dict[Any, int] = {}
        self._waiting: List[Tuple[float, int, Any]] = []
        self._seq = 0
        self._timer = threading.Thread(target=self._drain_waiting, daemon=True)
        self._timer_started = False

    def _ensure_timer(self) -> None:
        if not self._timer_started:
            self._timer_started = True
            self._timer.start()

    def add_after(self, item: Any, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        with self._lock:
            if self._shutting_down:
                return
            self._seq += 1
            heapq.heappush(self._waiting, (time.monotonic() + delay, self._seq, item))
            self._ensure_timer()
            self._lock.notify_all()  # wake the timer for an earlier deadline

    def add_rate_limited(self, item: Any) -> None:
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
        delay = min(self._base_delay * (2 ** n), self._max_delay)
        self.add_after(item, delay)

    def forget(self, item: Any) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def num_requeues(self, item: Any) -> int:
        with self._lock:
            return self._failures.get(item, 0)

    def shutdown(self) -> None:
        """Shut down, flushing the pending delay heap (delaying_queue.go
        ShutDown drops waiters: delayed retries belong to the loop being
        stopped — handing them to its condemned workers would run syncs
        concurrently with a supervisor-rebuilt replacement) and cancelling
        the drain timer — without the join a test tearing down hundreds
        of queues leaks a parked timer thread per queue."""
        with self._lock:
            self._shutting_down = True
            self._waiting.clear()
            self._failures.clear()
            self._lock.notify_all()
        if self._timer_started and self._timer is not threading.current_thread():
            self._timer.join(timeout=2)

    def _drain_waiting(self) -> None:
        """Sleep until the next deadline (delaying_queue.go waitingLoop);
        woken early when add_after schedules something sooner."""
        with self._lock:
            while not self._shutting_down:
                now = time.monotonic()
                while self._waiting and self._waiting[0][0] <= now:
                    _, _, item = heapq.heappop(self._waiting)
                    self._add_locked(item)
                timeout = (
                    self._waiting[0][0] - now if self._waiting else None
                )
                self._lock.wait(timeout)
