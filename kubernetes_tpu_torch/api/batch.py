"""batch/v1 + batch/v1beta1 types: Job, CronJob.

Reference: staging/src/k8s.io/api/batch/v1/types.go (Job) and
batch/v1beta1/types.go (CronJob). Fields limited to what the job and
cronjob controllers reconcile on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .types import LabelSelector, ObjectMeta, PodTemplateSpec


@dataclass
class JobSpec:
    parallelism: Optional[int] = None  # default 1
    completions: Optional[int] = None  # default: == parallelism
    backoff_limit: Optional[int] = None  # default 6
    active_deadline_seconds: Optional[int] = None
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    ttl_seconds_after_finished: Optional[int] = None


@dataclass
class JobCondition:
    type: str = ""  # Complete | Failed
    status: str = ""
    reason: str = ""
    message: str = ""
    last_transition_time: Optional[float] = None


@dataclass
class JobStatus:
    conditions: Optional[List[JobCondition]] = None
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    start_time: Optional[float] = None
    completion_time: Optional[float] = None


@dataclass
class Job:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: JobSpec = field(default_factory=JobSpec)
    status: JobStatus = field(default_factory=JobStatus)
    kind: str = "Job"
    api_version: str = "batch/v1"


@dataclass
class CronJobSpec:
    schedule: str = ""  # cron format
    suspend: bool = False
    job_template_spec: JobSpec = field(default_factory=JobSpec)
    concurrency_policy: str = "Allow"  # Allow | Forbid | Replace
    successful_jobs_history_limit: Optional[int] = None
    failed_jobs_history_limit: Optional[int] = None


@dataclass
class CronJobStatus:
    last_schedule_time: Optional[float] = None
    active: Optional[List[str]] = None  # names of running Jobs


@dataclass
class CronJob:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CronJobSpec = field(default_factory=CronJobSpec)
    status: CronJobStatus = field(default_factory=CronJobStatus)
    kind: str = "CronJob"
    api_version: str = "batch/v1beta1"
