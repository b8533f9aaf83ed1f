"""Lease-based leader election (client-go tools/leaderelection equivalent).

Reference: staging/src/k8s.io/client-go/tools/leaderelection/
leaderelection.go — Run (:196: acquire → renew loop → OnStoppedLeading),
tryAcquireOrRenew (:317: read record, adopt if expired, update with
optimistic concurrency), defaults LeaseDuration 15s / RenewDeadline 10s /
RetryPeriod 2s; the lock is a coordination/v1 Lease object
(resourcelock/leaselock.go). OnStoppedLeading in the components is fatal
(crash-and-restart HA model, cmd/kube-scheduler/app/server.go:204) — here
it's a callback the embedding process decides on.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..api import types as v1
from ..apiserver.server import APIError, Conflict, NotFound


@dataclass
class LeaderElectionConfig:
    lock_name: str = "kube-scheduler"
    lock_namespace: str = "kube-system"
    identity: str = ""
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0
    # full-jitter factor on the acquire retry: N candidates polling on the
    # same beat all CAS the lease in the same instant and all but one
    # conflict, every cycle — jitter de-synchronizes the herd
    retry_jitter: float = 0.2
    # seconds before lease EXPIRY (not renew_deadline) a leader stops
    # trusting its own holdership: a GC-paused/partitioned instance whose
    # renews stall must demote strictly before a peer's adoption window
    # opens at lease_duration, or the two overlap for up to the clock
    # skew between them. None resolves KTPU_LEASE_FENCE_MARGIN.
    fence_margin: Optional[float] = None


@dataclass(frozen=True)
class FencingToken:
    """The identity + lease epoch a fenced write carries. Validity is
    clock-free: the apiserver accepts the write iff the stored lease
    still names `holder_identity` at `transitions` — adoption bumps
    leaseTransitions, so a deposed leader's token can never validate
    again no matter whose clock is wrong (the monotonic fencing number
    from the Chubby/ZooKeeper lock literature)."""

    lock_name: str
    lock_namespace: str
    holder_identity: str
    transitions: int


class LeaderElector:
    def __init__(
        self,
        clientset,
        config: LeaderElectionConfig,
        on_started_leading: Callable[[], None],
        on_stopped_leading: Callable[[], None],
        now=time.time,
    ):
        if config.lease_duration <= config.renew_deadline:
            raise ValueError("leaseDuration must be greater than renewDeadline")
        if config.renew_deadline <= config.retry_period:
            raise ValueError("renewDeadline must be greater than retryPeriod")
        if not config.identity:
            raise ValueError("identity is required")
        self._leases = clientset.resource("leases")
        self.cfg = config
        if config.fence_margin is None:
            from ..utils import knobs

            # the knob default assumes production lease durations; a
            # short (test-scale) lease gets a proportional margin rather
            # than a rejection — only an EXPLICIT margin can be invalid
            config.fence_margin = min(
                knobs.get_float("KTPU_LEASE_FENCE_MARGIN"),
                config.lease_duration / 4.0,
            )
        if config.fence_margin >= config.lease_duration:
            raise ValueError("fence_margin must be less than leaseDuration")
        self._on_started = on_started_leading
        self._on_stopped = on_stopped_leading
        self._now = now
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.is_leader = threading.Event()
        self._observed_renew_time: float = 0.0
        self._observed_holder: str = ""
        # epoch + timestamp of OUR OWN last successful renew (local clock
        # — the self-fence deadline must not trust the store's clock)
        self._transitions: int = 0
        self._last_renew: float = 0.0
        # chaos hooks (testing/chaos.py): a partitioned elector cannot
        # reach the store — renews fail, the token freezes, and the
        # instance must self-fence on the margin like a real netsplit
        self.partitioned = False
        self._abdicated = threading.Event()
        self._backoff_until: float = 0.0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self.run, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        # stop() can be reached from inside run() (on_stopped_leading
        # chains often call back into the embedding component's stop)
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)
        self._release()

    def _release(self) -> None:
        """leaderelection.go ReleaseOnCancel: a stopping leader vacates
        the lease record so the successor acquires on its next retry
        instead of waiting out the full lease_duration (graceful handoff;
        an actual crash still pays the expiry wait — that's failover)."""
        if self.partitioned:
            self.is_leader.clear()
            return  # can't reach the store; the lease expires on its own
        try:
            lease = self._leases.get(self.cfg.lock_name, self.cfg.lock_namespace)
        except APIError:
            return
        if lease.spec.holder_identity != self.cfg.identity:
            return
        lease.spec.holder_identity = ""
        lease.spec.renew_time = None
        try:
            self._leases.update(lease)  # resourceVersion-guarded CAS
        except APIError:
            pass
        self.is_leader.clear()

    def run(self) -> None:
        """leaderelection.go:196 Run: acquire, then renew until lost."""
        while not self._stop.is_set():
            if not self._acquire():
                return  # stopped
            self._on_started()
            self._renew_loop()
            self.is_leader.clear()
            self._on_stopped()
            if self._stop.is_set():
                return

    # -- phases ------------------------------------------------------------

    def _acquire(self) -> bool:
        while not self._stop.is_set():
            if self._now() >= self._backoff_until and self._try_acquire_or_renew():
                self.is_leader.set()
                return True
            self._stop.wait(
                self.cfg.retry_period
                * (1.0 + self.cfg.retry_jitter * random.random())
            )
        return False

    def _renew_loop(self) -> None:
        while not self._stop.is_set():
            if self._abdicated.is_set():
                self._abdicated.clear()
                self._release()
                return
            # the self-fence deadline: whichever comes FIRST of the renew
            # deadline and `margin` seconds before our own lease would
            # expire. Measured on the local clock from our own last
            # successful renew — a partitioned or GC-paused instance whose
            # renews stall demotes at lease_duration - margin, strictly
            # before any peer's adoption window opens at lease_duration.
            deadline = min(
                self._now() + self.cfg.renew_deadline,
                self._last_renew + self.cfg.lease_duration
                - self.cfg.fence_margin,
            )
            renewed = False
            while (self._now() < deadline and not self._stop.is_set()
                   and not self._abdicated.is_set()):
                if self._try_acquire_or_renew():
                    renewed = True
                    break
                self._stop.wait(self.cfg.retry_period)
            if self._abdicated.is_set():
                self._abdicated.clear()
                self._release()
                return
            if not renewed:
                return  # lost the lease (or self-fenced on the margin)
            # jittered gap between renews: N leaders across the fleet
            # renewing on the same beat hammer the store in phase
            self._stop.wait(
                self.cfg.retry_period
                * (1.0 + self.cfg.retry_jitter * random.random())
            )

    # -- the CAS (leaderelection.go:317 tryAcquireOrRenew) -----------------

    def _try_acquire_or_renew(self) -> bool:
        if self.partitioned:
            return False  # netsplit: the store is unreachable from here
        now = self._now()
        try:
            lease = self._leases.get(self.cfg.lock_name, self.cfg.lock_namespace)
        except NotFound:
            lease = v1.Lease(
                metadata=v1.ObjectMeta(
                    name=self.cfg.lock_name, namespace=self.cfg.lock_namespace
                ),
                spec=v1.LeaseSpec(
                    holder_identity=self.cfg.identity,
                    lease_duration_seconds=int(self.cfg.lease_duration),
                    acquire_time=now,
                    renew_time=now,
                ),
            )
            try:
                self._leases.create(lease)
                self._transitions = 0
                self._last_renew = now
                return True
            except APIError:
                return False
        spec = lease.spec
        if spec.holder_identity != self.cfg.identity:
            expired = (
                spec.renew_time is None
                or spec.renew_time + self.cfg.lease_duration < now
            )
            if not expired:
                self._observed_holder = spec.holder_identity
                return False
            spec.lease_transitions += 1
            spec.acquire_time = now
        spec.holder_identity = self.cfg.identity
        spec.lease_duration_seconds = int(self.cfg.lease_duration)
        spec.renew_time = now
        try:
            self._leases.update(lease)  # resourceVersion-guarded CAS
            self._transitions = spec.lease_transitions
            self._last_renew = now
            return True
        except (Conflict, APIError):
            return False

    # -- fencing / chaos hooks ---------------------------------------------

    def fencing_token(self) -> Optional[FencingToken]:
        """The token fenced writes carry while this instance leads; None
        when not leading. Latched at promotion (the epoch can't change
        while we hold the lease — adoption requires expiry first)."""
        if not self.is_leader.is_set():
            return None
        return FencingToken(
            lock_name=self.cfg.lock_name,
            lock_namespace=self.cfg.lock_namespace,
            holder_identity=self.cfg.identity,
            transitions=self._transitions,
        )

    def abdicate(self, cooldown: float = 0.0) -> None:
        """Drill hook: gracefully hand the lease off — vacate the record
        (the successor adopts on its next retry, bumping the epoch) and
        stay out of the race for `cooldown` seconds so a warm standby
        wins deterministically. The renew loop notices within one
        retry_period."""
        self._backoff_until = self._now() + cooldown
        self._abdicated.set()

    @property
    def leader_identity(self) -> str:
        try:
            lease = self._leases.get(self.cfg.lock_name, self.cfg.lock_namespace)
            return lease.spec.holder_identity
        except APIError:
            return ""
