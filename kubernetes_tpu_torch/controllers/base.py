"""Controller machinery shared by all control loops.

The reference's canonical controller shape (reference:
pkg/controller/replicaset/replica_set.go:177 Run → workers ×
processNextWorkItem → syncHandler; expectations in
pkg/controller/controller_utils.go:152 ControllerExpectations) is:
informer events enqueue a key on a rate-limited workqueue; N workers pop
keys and run a level-triggered sync; expectations suppress redundant
syncs while our own creates/deletes are still in flight.
"""

from __future__ import annotations

import random
import string
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..api import types as v1
from ..client.workqueue import RateLimitingQueue


class ControllerExpectations:
    """pkg/controller/controller_utils.go:152 — per-key counts of creates/
    deletes we've issued but not yet observed; a key is 'satisfied' when
    both hit zero (or the record expired: 5min TTL guards lost events)."""

    TTL = 300.0

    def __init__(self):
        self._lock = threading.Lock()
        self._exp: Dict[str, Tuple[int, int, float]] = {}

    def expect_creations(self, key: str, n: int) -> None:
        with self._lock:
            self._exp[key] = (n, 0, time.time())

    def expect_deletions(self, key: str, n: int) -> None:
        with self._lock:
            self._exp[key] = (0, n, time.time())

    def set_expectations(self, key: str, creates: int, deletes: int) -> None:
        """controller_utils.go SetExpectations — one record for a sync that
        issues both creates and deletes (setting them separately would
        overwrite the first count)."""
        with self._lock:
            self._exp[key] = (creates, deletes, time.time())

    def creation_observed(self, key: str) -> None:
        self._bump(key, -1, 0)

    def deletion_observed(self, key: str) -> None:
        self._bump(key, 0, -1)

    def _bump(self, key: str, dc: int, dd: int) -> None:
        with self._lock:
            rec = self._exp.get(key)
            if rec is None:
                return
            c, d, ts = rec
            self._exp[key] = (c + dc, d + dd, ts)

    def satisfied(self, key: str) -> bool:
        with self._lock:
            rec = self._exp.get(key)
            if rec is None:
                return True
            c, d, ts = rec
            return (c <= 0 and d <= 0) or (time.time() - ts > self.TTL)

    def delete_expectations(self, key: str) -> None:
        with self._lock:
            self._exp.pop(key, None)


class Controller:
    """Base loop: queue + workers; subclasses implement sync(key)."""

    name = "controller"

    def __init__(self, workers: int = 2):
        self.queue = RateLimitingQueue()
        self._workers = workers
        self._threads: List[threading.Thread] = []
        self._stopped = threading.Event()

    def enqueue(self, key: str) -> None:
        self.queue.add(key)

    def enqueue_after(self, key: str, delay: float) -> None:
        self.queue.add_after(key, delay)

    def sync(self, key: str) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def run(self) -> None:
        for i in range(self._workers):
            t = threading.Thread(
                target=self._worker, name=f"{self.name}-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stopped.set()
        self.queue.shutdown()
        for t in self._threads:
            t.join(timeout=5)

    def _worker(self) -> None:
        while True:
            key, shutdown = self.queue.get(timeout=0.5)
            if shutdown:
                return
            if key is None:
                if self._stopped.is_set():
                    return
                continue
            try:
                self.sync(key)
            except Exception as e:  # noqa: BLE001 — requeue with backoff, like
                # processNextWorkItem's utilruntime.HandleError + AddRateLimited
                if not self._stopped.is_set():
                    self.queue.add_rate_limited(key)
                    from ..apiserver.server import AlreadyExists, Conflict

                    if not isinstance(e, (AlreadyExists, Conflict)):
                        # conflicts / create races are the normal
                        # informer-lag retry path; don't spam the log
                        import traceback

                        traceback.print_exc()
            else:
                self.queue.forget(key)
            finally:
                self.queue.done(key)


def is_pod_active(pod: v1.Pod) -> bool:
    """controller_utils.go IsPodActive: not succeeded/failed, not deleting."""
    return (
        pod.status.phase not in ("Succeeded", "Failed")
        and pod.metadata.deletion_timestamp is None
    )


def is_pod_ready(pod: v1.Pod) -> bool:
    """podutil.IsPodReady: Ready condition True."""
    for cond in pod.status.conditions or []:
        if cond.type == "Ready":
            return cond.status == "True"
    return False


def controller_ref(owner, controller_kind: str) -> v1.OwnerReference:
    """metav1.NewControllerRef equivalent."""
    return v1.OwnerReference(
        api_version=owner.api_version,
        kind=controller_kind,
        name=owner.metadata.name,
        uid=owner.metadata.uid,
        controller=True,
        block_owner_deletion=True,
    )


def get_controller_of(obj) -> Optional[v1.OwnerReference]:
    """metav1.GetControllerOf: the ownerRef with controller=true."""
    for ref in obj.metadata.owner_references or []:
        if ref.controller:
            return ref
    return None


def rand_suffix(n: int = 5) -> str:
    """names.SimpleNameGenerator's random suffix for generateName."""
    return "".join(random.choices(string.ascii_lowercase + string.digits, k=n))


def retry_on_conflict(fn: Callable[[], None], attempts: int = 5) -> None:
    """client-go retry.RetryOnConflict: re-run the read-modify-write on
    resourceVersion conflicts (stale informer copies are expected)."""
    from ..apiserver.server import Conflict

    for i in range(attempts):
        try:
            fn()
            return
        except Conflict:
            if i == attempts - 1:
                raise
            time.sleep(0.01 * (i + 1))


def slow_start_batch(count: int, initial: int, fn: Callable[[int], bool]) -> int:
    """controller_utils.go:758 slowStartBatch: create in doubling batches
    (1, 2, 4, …) so a persistently failing create doesn't stampede the API
    server; stops at the first batch with a failure. Returns successes."""
    remaining = count
    successes = 0
    batch = min(remaining, initial)
    idx = 0
    while batch > 0:
        ok = 0
        for _ in range(batch):
            if fn(idx):
                ok += 1
            idx += 1
        successes += ok
        if ok < batch:
            break
        remaining -= batch
        batch = min(2 * batch, remaining)
    return successes
