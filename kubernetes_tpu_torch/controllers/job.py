"""Job controller.

Reference: pkg/controller/job/job_controller.go — syncJob (:436): run up
to `parallelism` active pods until `completions` succeed; pod failures
count toward `backoffLimit` (past it the Job gets a Failed condition and
active pods are deleted); completion sets the Complete condition.
ttlSecondsAfterFinished cleanup lives in pkg/controller/ttlafterfinished.
"""

from __future__ import annotations

import copy
import time
from typing import List

from ..api import batch, types as v1
from ..client.informer import EventHandler, meta_namespace_key
from ..utils import serde
from .base import (
    Controller,
    ControllerExpectations,
    controller_ref,
    get_controller_of,
    rand_suffix,
    slow_start_batch,
)



def _finished(job: batch.Job) -> bool:
    for c in job.status.conditions or []:
        if c.type in ("Complete", "Failed") and c.status == "True":
            return True
    return False


class JobController(Controller):
    name = "job"
    kind = "Job"

    def __init__(self, clientset, informer_factory, workers: int = 2):
        super().__init__(workers=workers)
        self.client = clientset
        self.job_informer = informer_factory.informer_for("jobs")
        self.pod_informer = informer_factory.informer_for("pods")
        self.expectations = ControllerExpectations()
        self._wire_handlers()

    def _wire_handlers(self) -> None:
        self.job_informer.add_event_handler(
            EventHandler(
                on_add=lambda j: self.enqueue(meta_namespace_key(j)),
                on_update=lambda o, n: self.enqueue(meta_namespace_key(n)),
                on_delete=lambda j: self.enqueue(meta_namespace_key(j)),
            )
        )
        self.pod_informer.add_event_handler(
            EventHandler(
                on_add=self._on_pod_event,
                on_update=lambda o, n: self._on_pod_event(n, update=True),
                on_delete=lambda p: self._on_pod_event(p, deleted=True),
            )
        )

    def _on_pod_event(self, pod: v1.Pod, update: bool = False, deleted: bool = False) -> None:
        ref = get_controller_of(pod)
        if ref is None or ref.kind != self.kind:
            return
        key = f"{pod.metadata.namespace}/{ref.name}"
        if deleted:
            self.expectations.deletion_observed(key)
        elif not update:
            self.expectations.creation_observed(key)
        self.enqueue(key)

    def _owned_pods(self, job: batch.Job) -> List[v1.Pod]:
        out = []
        for pod in self.pod_informer.list():
            if pod.metadata.namespace != job.metadata.namespace:
                continue
            ref = get_controller_of(pod)
            if ref is not None and ref.uid == job.metadata.uid:
                out.append(pod)
        return out

    def sync(self, key: str) -> None:
        job = self.job_informer.get(key)
        if job is None:
            self.expectations.delete_expectations(key)
            return
        if _finished(job):
            return
        pods = self._owned_pods(job)
        active = [
            p
            for p in pods
            if p.status.phase not in ("Succeeded", "Failed")
            and p.metadata.deletion_timestamp is None
        ]
        succeeded = sum(1 for p in pods if p.status.phase == "Succeeded")
        failed = sum(1 for p in pods if p.status.phase == "Failed")

        parallelism = job.spec.parallelism if job.spec.parallelism is not None else 1
        completions = (
            job.spec.completions if job.spec.completions is not None else parallelism
        )
        backoff_limit = (
            job.spec.backoff_limit if job.spec.backoff_limit is not None else 6
        )

        status = copy.deepcopy(job.status)
        if status.start_time is None:
            status.start_time = time.time()

        exceeded = failed > backoff_limit
        past_deadline = (
            job.spec.active_deadline_seconds is not None
            and status.start_time is not None
            and time.time() - status.start_time >= job.spec.active_deadline_seconds
        )
        if exceeded or past_deadline:
            for p in active:
                try:
                    self.client.pods.delete(p.metadata.name, p.metadata.namespace)
                except Exception:  # noqa: BLE001
                    pass
            reason = "BackoffLimitExceeded" if exceeded else "DeadlineExceeded"
            status.conditions = (status.conditions or []) + [
                batch.JobCondition(
                    type="Failed",
                    status="True",
                    reason=reason,
                    last_transition_time=time.time(),
                )
            ]
            active = []
        elif succeeded >= completions:
            status.conditions = (status.conditions or []) + [
                batch.JobCondition(
                    type="Complete", status="True", last_transition_time=time.time()
                )
            ]
            status.completion_time = time.time()
        elif self.expectations.satisfied(key):
            still_needed = completions - succeeded
            want_active = min(parallelism, still_needed)
            diff = want_active - len(active)
            if diff > 0:
                self.expectations.expect_creations(key, diff)
                created = slow_start_batch(diff, 1, lambda i: self._create_pod(job))
                for _ in range(diff - created):
                    self.expectations.creation_observed(key)
            elif diff < 0:
                victims = active[:(-diff)]
                self.expectations.expect_deletions(key, len(victims))
                for p in victims:
                    try:
                        self.client.pods.delete(p.metadata.name, p.metadata.namespace)
                    except Exception:  # noqa: BLE001
                        self.expectations.deletion_observed(key)

        status.active = len(active)
        status.succeeded = succeeded
        status.failed = failed
        if serde.to_dict(status) != serde.to_dict(job.status):
            updated = copy.deepcopy(job)
            updated.status = status
            try:
                self.client.jobs.update_status(updated)
            except Exception:  # noqa: BLE001
                pass

    def _create_pod(self, job: batch.Job) -> bool:
        tmpl = job.spec.template
        spec = serde.from_dict(v1.PodSpec, serde.to_dict(tmpl.spec)) or v1.PodSpec()
        if spec.restart_policy == "Always":
            spec.restart_policy = "Never"
        labels = dict(tmpl.metadata.labels or {})
        labels.setdefault("job-name", job.metadata.name)
        pod = v1.Pod(
            metadata=v1.ObjectMeta(
                name=f"{job.metadata.name}-{rand_suffix()}",
                namespace=job.metadata.namespace,
                labels=labels,
                owner_references=[controller_ref(job, self.kind)],
            ),
            spec=spec,
        )
        try:
            self.client.pods.create(pod)
            return True
        except Exception:  # noqa: BLE001
            return False
