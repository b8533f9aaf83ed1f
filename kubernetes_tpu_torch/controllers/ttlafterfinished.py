"""TTL-after-finished controller: garbage-collect finished Jobs.

Reference: pkg/controller/ttlafterfinished/ttlafterfinished_controller.go —
processJob (:219): once a Job has Complete/Failed condition and
spec.ttlSecondsAfterFinished is set, delete it when
completion/finish time + TTL has passed; otherwise requeue for the
remaining duration.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Optional

from ..apiserver.server import NotFound


class TTLAfterFinishedController:
    name = "ttlafterfinished"

    def __init__(self, clientset, informer_factory, sync_period: float = 5.0):
        self.client = clientset
        self.sync_period = sync_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.sync_period):
            try:
                self.sync_all()
            except Exception:  # noqa: BLE001
                traceback.print_exc()

    @staticmethod
    def _finish_time(job) -> Optional[float]:
        for cond in job.status.conditions or []:
            if cond.type in ("Complete", "Failed") and cond.status == "True":
                return job.status.completion_time or cond.last_transition_time
        return None

    def sync_all(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()
        jobs, _ = self.client.jobs.list()
        for job in jobs:
            ttl = job.spec.ttl_seconds_after_finished
            if ttl is None:
                continue
            finished = self._finish_time(job)
            if finished is None:
                continue
            if now >= finished + ttl:
                try:
                    self.client.jobs.delete(job.metadata.name, job.metadata.namespace)
                except NotFound:
                    pass
