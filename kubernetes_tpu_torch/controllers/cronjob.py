"""CronJob controller.

Reference: pkg/controller/cronjob/cronjob_controller.go — syncAll (:103)
polls every 10s, syncOne (:209): compute the most recent unmet schedule
time since status.lastScheduleTime (getRecentUnmetScheduleTimes,
utils.go:98), honor suspend and concurrencyPolicy (Allow/Forbid/Replace),
create the Job (getJobFromTemplate names it <cronjob>-<scheduledTime>,
utils.go:211), update status.active/lastScheduleTime, and prune finished
jobs beyond the history limits (:386 cleanupFinishedJobs).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import List, Optional, Tuple

from ..api import batch
from ..api import types as v1
from ..apiserver.server import APIError, NotFound
from .base import controller_ref


def _parse_field(expr: str, lo: int, hi: int) -> frozenset:
    """One cron field: * , - / lists (standard 5-field cron grammar)."""
    out = set()
    for part in expr.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part == "*":
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = int(a), int(b)
        else:
            start = end = int(part)
        if start < lo or end > hi or start > end:
            raise ValueError(f"cron field {expr!r} out of range [{lo},{hi}]")
        out.update(range(start, end + 1, step))
    return frozenset(out)


class CronSchedule:
    """Standard 5-field cron: minute hour day-of-month month day-of-week.

    Matches the robfig/cron subset the reference depends on (dom/dow OR
    rule: when both are restricted, either matching fires)."""

    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) != 5:
            raise ValueError(f"cron expression needs 5 fields: {expr!r}")
        self.minute = _parse_field(fields[0], 0, 59)
        self.hour = _parse_field(fields[1], 0, 23)
        self.dom = _parse_field(fields[2], 1, 31)
        self.month = _parse_field(fields[3], 1, 12)
        self.dow = _parse_field(fields[4], 0, 6)  # 0 = Sunday
        self._dom_star = fields[2] == "*"
        self._dow_star = fields[4] == "*"

    def matches(self, t: float) -> bool:
        tm = time.gmtime(int(t))
        if tm.tm_min not in self.minute or tm.tm_hour not in self.hour:
            return False
        if tm.tm_mon not in self.month:
            return False
        dow = (tm.tm_wday + 1) % 7  # python Mon=0 -> cron Sun=0
        dom_ok = tm.tm_mday in self.dom
        dow_ok = dow in self.dow
        if self._dom_star and self._dow_star:
            return True
        if self._dom_star:
            return dow_ok
        if self._dow_star:
            return dom_ok
        return dom_ok or dow_ok  # standard cron OR rule

    def _day_matches(self, tm) -> bool:
        if tm.tm_mon not in self.month:
            return False
        dow = (tm.tm_wday + 1) % 7
        dom_ok, dow_ok = tm.tm_mday in self.dom, dow in self.dow
        if self._dom_star and self._dow_star:
            return True
        if self._dom_star:
            return dow_ok
        if self._dow_star:
            return dom_ok
        return dom_ok or dow_ok

    def next_after(self, t: float, horizon: float = 366 * 86400) -> Optional[float]:
        """First matching minute strictly after t. Field-wise walk: iterate
        days, then the schedule's hour/minute sets — O(days + |hours| x
        |minutes|), never a minute-by-minute scan over the horizon (an
        unsatisfiable schedule like 'Feb 31' costs 366 day-checks, not
        500k minute-checks)."""
        start = (int(t) // 60 + 1) * 60
        day0 = start - (start % 86400)
        hours, minutes = sorted(self.hour), sorted(self.minute)
        for d in range(int(horizon // 86400) + 2):
            day = day0 + d * 86400
            if not self._day_matches(time.gmtime(day)):
                continue
            for h in hours:
                for m in minutes:
                    cand = day + h * 3600 + m * 60
                    if cand >= start:
                        if cand - t > horizon:
                            return None
                        return float(cand)
        return None

    def unmet_times(self, earliest: float, now: float, limit: int = 100) -> List[float]:
        """Schedule times in (earliest, now], at most the first `limit`
        (getRecentUnmetScheduleTimes shape; prefer latest_unmet for the
        scheduling decision — it is O(1) in backlog size)."""
        out: List[float] = []
        t = earliest
        while len(out) < limit:
            t = self.next_after(t, horizon=now - t + 120)
            if t is None or t > now:
                break
            out.append(t)
        return out

    def latest_unmet(self, earliest: float, now: float) -> Optional[float]:
        """Most recent schedule time in (earliest, now], found by a
        BACKWARD field-wise walk from now — cost is independent of how
        long the controller was down (the reference instead errors out
        above 100 missed times; skipping the backlog and running the
        newest time is the behavior operators want from that state)."""
        end = int(now) // 60 * 60  # minute containing/below now
        day0 = end - (end % 86400)
        hours, minutes = sorted(self.hour, reverse=True), sorted(
            self.minute, reverse=True
        )
        for d in range(367):
            day = day0 - d * 86400
            if day + 86400 <= earliest:
                break
            if not self._day_matches(time.gmtime(day)):
                continue
            for h in hours:
                for m in minutes:
                    cand = day + h * 3600 + m * 60
                    if cand > end:
                        continue
                    if cand <= earliest:
                        return None
                    return float(cand)
        return None


class CronJobController:
    """Poll-based, like the reference (no informer event wiring needed)."""

    name = "cronjob"
    kind = "CronJob"

    def __init__(self, clientset, informer_factory, sync_period: float = 10.0):
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

    # -- sync ---------------------------------------------------------------

    def sync_all(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()
        cronjobs, _ = self.client.cronjobs.list()
        jobs, _ = self.client.jobs.list()
        by_owner = {}
        for job in jobs:
            for ref in job.metadata.owner_references or []:
                if ref.kind == self.kind:
                    by_owner.setdefault(
                        (job.metadata.namespace, ref.name), []
                    ).append(job)
        for cj in cronjobs:
            try:
                self.sync_one(
                    cj, by_owner.get((cj.metadata.namespace, cj.metadata.name), []), now
                )
            except APIError:
                pass  # conflict/missing: retried next period

    @staticmethod
    def _job_finished(job: batch.Job) -> Optional[str]:
        for cond in job.status.conditions or []:
            if cond.type in ("Complete", "Failed") and cond.status == "True":
                return cond.type
        return None

    def sync_one(self, cj: batch.CronJob, owned: List[batch.Job], now: float) -> None:
        active = [j for j in owned if self._job_finished(j) is None]
        # prune history (cleanupFinishedJobs): oldest first beyond the limit
        for want, limits in (
            ("Complete", cj.spec.successful_jobs_history_limit),
            ("Failed", cj.spec.failed_jobs_history_limit),
        ):
            if limits is None:
                continue
            done = sorted(
                (j for j in owned if self._job_finished(j) == want),
                key=lambda j: j.status.completion_time or 0,
            )
            for j in done[: max(0, len(done) - limits)]:
                try:
                    self.client.jobs.delete(j.metadata.name, j.metadata.namespace)
                except NotFound:
                    pass
        # status.active reflects reality even when suspended
        self._update_status(cj, [j.metadata.name for j in active], None)
        if cj.spec.suspend:
            return
        sched = CronSchedule(cj.spec.schedule)
        earliest = (
            cj.status.last_schedule_time
            or cj.metadata.creation_timestamp
            or now - self.sync_period
        )
        run_time = sched.latest_unmet(earliest, now)
        if run_time is None:
            return
        if cj.spec.concurrency_policy == "Forbid" and active:
            return
        if cj.spec.concurrency_policy == "Replace":
            for j in active:
                try:
                    self.client.jobs.delete(j.metadata.name, j.metadata.namespace)
                except NotFound:
                    pass
            active = []
        job = batch.Job(
            metadata=v1.ObjectMeta(
                # getJobFromTemplate: name = <cron>-<minutes since epoch>
                name=f"{cj.metadata.name}-{int(run_time) // 60}",
                namespace=cj.metadata.namespace,
                labels=dict(cj.spec.job_template_spec.template.metadata.labels or {}),
                owner_references=[controller_ref(cj, self.kind)],
            ),
            spec=cj.spec.job_template_spec,
        )
        try:
            self.client.jobs.create(job)
        except APIError:
            pass  # AlreadyExists: another worker/period won
        self._update_status(
            cj, [j.metadata.name for j in active] + [job.metadata.name], run_time
        )

    def _update_status(
        self, cj: batch.CronJob, active: List[str], last_schedule: Optional[float]
    ) -> None:
        changed = sorted(active) != sorted(cj.status.active or [])
        if last_schedule is not None and last_schedule != cj.status.last_schedule_time:
            changed = True
        if not changed:
            return
        live = self.client.cronjobs.get(cj.metadata.name, cj.metadata.namespace)
        live.status.active = sorted(active) or None
        if last_schedule is not None:
            live.status.last_schedule_time = last_schedule
        self.client.cronjobs.update_status(live)
        cj.status = live.status
