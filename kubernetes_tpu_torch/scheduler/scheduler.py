"""The scheduler: queue → scheduleOne → assume → async bind.

Reference: pkg/scheduler/scheduler.go — New (:188), Run (:311,
wait.UntilWithContext(scheduleOne)), scheduleOne (:427), assume (:359),
bind (:381); event wiring pkg/scheduler/eventhandlers.go:364
addAllEventHandlers.

Pipeline shape preserved exactly: the SCHEDULING cycle is serial (one pod
at a time against the assumed state), the BINDING cycle is asynchronous
per pod (a worker thread doing the apiserver bind), bridged by the
assume/forget protocol in the cache — plus the TPU twist: the scheduling
cycle drains a RUN of pending pods from the queue and schedules them in
one batched device dispatch (ops/batch.py) when their specs allow,
preserving sequential assume semantics.

TPU mode runs those cycles as a three-stage pipeline (pipeline_depth,
default 2): the scheduler thread pops + encodes + dispatches batch k+1,
the device scans batch k (double-buffered dispatches chained on the
session carry), and a completion worker — the async bind queue —
harvests batch k-1 and runs assume -> reserve/permit -> bind-submit ->
failure handling strictly in dispatch order. Decisions are bit-identical
to the sequential depth-0 path (tests/test_pipeline_parity.py): the
device carry is the assume cache, so completion order — not completion
TIME — is what sequential assume semantics require.
"""

from __future__ import annotations

import copy
import logging
import os
import random
import threading
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import time as _time

from ..api import types as v1
from ..apiserver.server import APIError, FenceExpired
from ..client.clientset import Clientset
from ..client.events import EventRecorder
from ..client.informer import EventHandler, SharedInformerFactory, meta_namespace_key
from ..utils import devtime, knobs, serde, tracing
from . import metrics
from .core import GenericScheduler, ScheduleResult
from .framework.interface import Code, CycleState, FitError
from .framework.runtime import Framework
from .framework.snapshot import Snapshot
from .internal.cache import SchedulerCache
from .internal.nominator import PodNominator
from .internal.queue import PriorityQueue
from . import preemption as fast_preemption
from .plugins.defaultpreemption import get_lower_priority_nominated_pods
from .plugins.registry import default_plugins, new_in_tree_registry
from .degradation import RUNG_ORACLE, DeviceFault
from .tpu_backend import TPUBackend

logger = logging.getLogger(__name__)


class WorkerKilled(Exception):
    """A pipeline worker thread was told to die (FaultInjector kill seam
    / ChaosMonkey crash-scheduler). Escapes the per-iteration isolation
    so the supervision wrapper sees a real crash."""


class PipelineStalled(RuntimeError):
    """_drain_pipeline exceeded its timeout: in-flight batches did not
    land even though every device wait is watchdog-bounded. The raiser
    has already demoted the ladder; callers requeue their pods instead
    of blocking the scheduler forever."""


def _has_required_anti_affinity(pod: v1.Pod) -> bool:
    a = pod.spec.affinity
    return (
        a is not None
        and a.pod_anti_affinity is not None
        and bool(a.pod_anti_affinity.required_during_scheduling_ignored_during_execution)
    )


class Scheduler:
    def __init__(
        self,
        clientset: Clientset,
        informer_factory: SharedInformerFactory,
        framework: Optional[Framework] = None,
        backend: str = "tpu",  # "tpu" | "oracle"
        tpu_backend: Optional[TPUBackend] = None,
        percentage_of_nodes_to_score: int = 100,
        max_batch: int = 128,
        rng: Optional[random.Random] = None,
        pod_initial_backoff: float = 1.0,
        pod_max_backoff: float = 10.0,
        extenders: Optional[List] = None,
        parallelism: int = 16,
        pipeline_depth: int = 2,
    ):
        self.client = clientset
        self.informers = informer_factory
        self.cache = SchedulerCache()
        self.queue = PriorityQueue(
            pod_initial_backoff=pod_initial_backoff,
            pod_max_backoff=pod_max_backoff,
        )
        self.extenders = extenders or []
        self.parallelism = parallelism
        self.backend = backend
        self.max_batch = max_batch
        self.rng = rng or random.Random()
        self.snapshot = Snapshot()
        self.nominator = PodNominator()
        # a Framework exists in BOTH modes: TPU mode uses it for the long
        # tail (preemption dry-runs, extenders) — SURVEY.md §7 stage 4.
        # The default framework gets real volume listers: the kernel
        # path's bound-PVC pods pass through VolumeBinding's Reserve and
        # the oracle diversion needs a working binder (the factory wires
        # richer extras for configured profiles, factory.py:126)
        self.framework = framework or Framework(
            new_in_tree_registry(),
            plugins=default_plugins(),
            snapshot_fn=lambda: self.snapshot,
            handle_extras=self._volume_handle_extras(),
        )
        self.framework.nominator = self.nominator
        self.framework.pdb_lister = self._list_pdbs
        self.framework.cache = self.cache  # Coscheduling counts reservations
        # The oracle algorithm exists in BOTH modes: TPU mode routes pods
        # whose constraints the kernel can't express (PVC volumes) to it
        self.algorithm = GenericScheduler(
            percentage_of_nodes_to_score=percentage_of_nodes_to_score,
            extenders=self.extenders,
            rng=self.rng,
        )
        # pipelined scheduling loop (PERF_NOTES "kernel-to-loop gap"):
        # depth N lets N dispatched batches ride ahead of their
        # completions. The scheduler thread only pops + encodes +
        # dispatches; a dedicated completion worker (the async bind
        # queue) harvests device results and runs assume -> reserve/
        # permit -> bind-submit -> failure handling, strictly in
        # dispatch order — so the device scans batch k while the host
        # encodes k+1 and binds k-1. Depth 0 = fully sequential
        # (dispatch then complete inline on the scheduler thread): the
        # bit-parity reference path (tests/test_pipeline_parity.py).
        self.pipeline_depth = max(0, pipeline_depth)
        if backend == "tpu":
            self.tpu = tpu_backend or TPUBackend(rng=self.rng)
            self.tpu.max_pending = max(1, self.pipeline_depth)
            # with a completion worker present (depth >= 1), a full
            # _pending FIFO back-pressures dispatch_many on a condition
            # variable instead of harvesting inline — the scheduler
            # thread never decodes a harvest (the dispatch critical
            # path never pays harvest+assume+decode)
            self.tpu.async_harvest_drain = self.pipeline_depth >= 1
            self.cache.add_listener(self.tpu)
            self._wire_volume_device()
        else:
            self.tpu = None
        self._stop = threading.Event()
        self._paused = threading.Event()
        # completion queue: (todo, handle, cycle) in dispatch order. The
        # worker pops the HEAD, completes it, THEN removes it — so an
        # empty deque means every dispatched batch has fully landed
        # (assumed + bind submitted + failures handled).
        self._completions: deque = deque()
        self._completion_cv = threading.Condition()
        self._completion_thread: Optional[threading.Thread] = None
        # decided placements that never landed in the cache (assume lost
        # to an informer race, RETRY re-gates, recovery abandons): while
        # the dropping batch was in flight, LATER in-flight batches
        # chained on a carry containing the dropped placement — a basis
        # the cache never held. Latched onto each handle at dispatch
        # (with the cache's foreign-mutation generation) so the shadow
        # sentinel voids audits whose flight overlapped a drop. Plain
        # int under the GIL: written by the completion worker, read at
        # dispatch.
        self._dropped_decisions = 0
        # binds the failure wave makes on the completion worker, off the
        # pipeline (a redispatched pod that fits now). Latched onto each
        # handle before dispatch: a batch in flight across such a bind
        # chained on a carry without it, and its harvest is checked
        # against the cache before it is assumed (_fit_harvest).
        self._wave_binds = 0
        # exact per-pod scheduling latencies (seconds) for the perf
        # harness: (queue-admission->bind-sent, pop->bind-sent, attempts).
        # The histograms carry the same data bucket-quantized; the harness
        # wants exact percentiles (scheduler_perf util.go:177 extracts
        # Perc50/90/99 from the live histogram — ours keeps the samples).
        self.latency_samples: deque = deque(maxlen=200_000)
        # monotonic bind-sent time per bound pod: the perf harness reads
        # the EXACT first-bind..last-bind window from these instead of a
        # 1s polling grid (whose quantization turned every sub-second
        # 500-node run into a 1000/k pods/s artifact)
        self.bind_timestamps: deque = deque(maxlen=200_000)
        # permit drainer state: pods parked at Permit (WAIT) register a
        # listener and a single thread releases them in waves
        self._permit_lock = threading.Lock()
        self._permit_parked: Dict[str, Tuple] = {}
        self._permit_released: List[Tuple] = []
        self._permit_wake = threading.Event()
        self._permit_thread: Optional[threading.Thread] = None
        # gang deadlock-breaker hysteresis: (ns, group) -> (membership
        # signature, consecutive stalled ticks); a back-off fires only
        # after KTPU_GANG_DEADLOCK_TICKS identical observations with
        # >=2 gangs stalled, and never the same gang twice in a row
        self._gang_stall: Dict[Tuple[str, str], Tuple] = {}
        self._gang_tick_last = 0.0
        self._gang_last_backoff: Optional[Tuple[str, str]] = None
        # in-flight preemptions, tracked per NOMINATED NODE: a node's
        # preemptors are parked until the node's ENTIRE claimed victim
        # set has delete-echoed, then queue.activate()d together —
        # precise event-driven re-admission (scheduling_queue.go
        # Activate / queueing-hints semantics) instead of flushing every
        # parked pod on every delete. Waking each preemptor on its OWN
        # victims alone thrashes when several preemptors share a node
        # (the planner's pick-one legitimately piles them up): the early
        # riser fails the nominated-node filter against its siblings'
        # still-dying victims, falls into the kernel path, and replans —
        # measured as a mid-window session teardown + 14s recompile.
        # The pod-key set also backs the guard that stops a re-popped
        # preemptor from planning a SECOND victim set while the first is
        # dying (the oracle's PodEligibleToPreemptOthers
        # terminating-victim check, default_preemption.go:539).
        self._preempt_lock = threading.Lock()
        self._node_waves: Dict[str, Tuple[set, List]] = {}  # node -> (victim keys, infos)
        self._victim_waiters: Dict[str, str] = {}  # victim key -> node
        self._inflight_preemptors: set = set()  # pod keys
        self._thread: Optional[threading.Thread] = None
        # device-fault plumbing: the injector seam (None in production),
        # and the drain budget — generous relative to the backend's
        # dispatch watchdog, which is what actually unsticks a wedged
        # wait; the drain timeout is the second line of defense
        self.faults = None
        self.drain_timeout = knobs.get_float(
            "KTPU_DRAIN_TIMEOUT", default=None)
        # leader election / fencing (enable_leader_election): every
        # state-changing write carries self._fence; the apiserver
        # rejects a token whose lease epoch has moved on. The token is
        # LATCHED — demotion deliberately leaves the stale token in
        # place so straggler binder-thread writes are rejected server-
        # side instead of going out unfenced; only the next promotion
        # replaces it.
        self.elector = None
        self._fence = None
        # requeue-exactly-once across the demote -> promote round trip:
        # pod key -> metadata.generation of every pod the demotion
        # drain sent back to the queue; the next reconcile_from_store
        # consults (then clears) it so the relist cannot requeue the
        # same generation a second time
        self._drain_requeued: Dict[str, int] = {}
        self._reconcile_lock = threading.Lock()
        self._binders = ThreadPoolExecutor(max_workers=8, thread_name_prefix="binder")
        self._inflight = 0  # scheduling batches + binds not yet finished
        self._inflight_lock = threading.Lock()
        self.profile_name = (
            self.framework.profile_name if self.framework else "default-scheduler"
        )
        self.recorder = EventRecorder(clientset, self.profile_name)
        # backend-health Events involve the SCHEDULER itself (there is
        # no single pod to attach a ladder demotion to); observers watch
        # Events on this pseudo-object the way they watch node Events
        import types as _pytypes

        self._self_ref = _pytypes.SimpleNamespace(
            kind="Scheduler",
            metadata=v1.ObjectMeta(
                name=self.profile_name, namespace="default", uid=""),
        )
        if self.tpu is not None:
            self.tpu.health_cb = self._health_event
        from ..utils import configz

        configz.install_knobs(
            "ktpu",
            pipeline_depth=self.pipeline_depth,
            max_batch=self.max_batch,
            # the RESOLVED drain budget (the /configz contract is
            # runtime-effective values): mirror _drain_pipeline's
            # default derivation when KTPU_DRAIN_TIMEOUT is unset
            drain_timeout=(
                self.drain_timeout
                if self.drain_timeout is not None
                else max(30.0, 3.0 * (self.tpu.watchdog_timeout
                                      if self.tpu is not None else 30.0))
            ),
            backend=self.backend,
        )
        # host-overload monitor (degradation.OverloadMonitor): watches
        # completion-FIFO age, queue depth and completion-stage latency
        # once per completed batch; under sustained pressure sheds
        # optional work in a fixed order with hysteretic LIFO restore.
        # Decision-inert by construction (tests/test_overload.py pins a
        # never-triggered run bit-identical) — levers only change how
        # much audit/overlap work the host pays for.
        self._shed_saved: Dict[str, object] = {}
        self._completion_durations: deque = deque(maxlen=64)
        self.overload = None
        if self.tpu is not None and knobs.get_bool("KTPU_OVERLOAD"):
            from .degradation import OverloadMonitor

            high_age = knobs.get_float("KTPU_OVERLOAD_FIFO_AGE")
            high_q = knobs.get_int(
                "KTPU_OVERLOAD_QUEUE_DEPTH",
                default=max(256, 4 * self.max_batch))
            self.overload = OverloadMonitor(
                self._overload_levers(),
                high_fifo_age=high_age,
                low_fifo_age=knobs.get_float(
                    "KTPU_OVERLOAD_FIFO_AGE_LOW", default=high_age * 0.2),
                high_queue_depth=high_q,
                low_queue_depth=knobs.get_int(
                    "KTPU_OVERLOAD_QUEUE_DEPTH_LOW", default=high_q // 4),
                # stage-latency signal is opt-in: per-stage p99 is
                # workload-shaped, the deployment sets the water mark
                high_stage_p99=knobs.get_float("KTPU_OVERLOAD_STAGE_P99"),
                shed_dwell=knobs.get_int("KTPU_OVERLOAD_SHED_DWELL"),
                restore_dwell=knobs.get_int("KTPU_OVERLOAD_RESTORE_DWELL"),
                cooldown=knobs.get_float("KTPU_OVERLOAD_COOLDOWN"),
                on_shed=lambda what, sig: self._health_event(
                    "Warning", "OverloadShed",
                    f"host overload: shed {what} ({sig})"),
                on_restore=lambda what, sig: self._health_event(
                    "Normal", "OverloadRestore",
                    f"host pressure cleared: restored {what}"),
            )
            configz.install_knobs(
                "ktpu",
                overload=True,
                overload_fifo_age=self.overload.high_fifo_age,
                overload_fifo_age_low=self.overload.low_fifo_age,
                overload_queue_depth=self.overload.high_queue_depth,
                overload_queue_depth_low=self.overload.low_queue_depth,
                overload_stage_p99=self.overload.high_stage_p99,
                overload_shed_dwell=self.overload.shed_dwell,
                overload_restore_dwell=self.overload.restore_dwell,
                overload_cooldown=self.overload.cooldown,
                overload_levers=[
                    name for name, _, _ in self.overload.levers],
            )
        else:
            configz.install_knobs("ktpu", overload=False)
        self._add_event_handlers()

    def _overload_levers(self) -> List[Tuple]:
        """The fixed shed order, cheapest-loss first: each lever is
        (name, shed, restore) and touches only OPTIONAL work — the
        explain decode, the parity sentinel's sample rate, the flight
        recorder, dispatch speculation. None of them can change a
        placement; none tears down the live device session (that is the
        point: shedding must cost ~nothing, see
        TPUBackend.set_shadow_rate_only)."""
        from ..utils import configz

        tpu = self.tpu
        saved = self._shed_saved

        def shed_explain():
            tpu.explain_harvest = False

        def restore_explain():
            tpu.explain_harvest = True

        def shed_shadow():
            saved["shadow"] = tpu.shadow_sample
            tpu.set_shadow_rate_only(0.0)

        def restore_shadow():
            tpu.set_shadow_rate_only(saved.pop("shadow", 0.0))

        def shed_devtime():
            saved["devtime"] = devtime.level()
            devtime.set_level(0)
            configz.install_knobs("ktpu", devtime_level=0)

        def restore_devtime():
            lvl = saved.pop("devtime", 0)
            devtime.set_level(lvl)
            configz.install_knobs("ktpu", devtime_level=lvl)

        def shed_trace():
            saved["trace"] = tracing.level()
            tracing.set_level(0)
            configz.install_knobs("ktpu", trace_level=0)

        def restore_trace():
            lvl = saved.pop("trace", 0)
            tracing.set_level(lvl)
            configz.install_knobs("ktpu", trace_level=lvl)

        def shed_speculation():
            saved["speculation"] = tpu.speculation
            tpu.speculation = False
            configz.install_knobs("ktpu", speculation=False)

        def restore_speculation():
            spec = saved.pop("speculation", True)
            tpu.speculation = spec
            configz.install_knobs("ktpu", speculation=spec)

        return [
            ("explain-harvest", shed_explain, restore_explain),
            ("shadow-sample", shed_shadow, restore_shadow),
            ("devtime", shed_devtime, restore_devtime),
            ("trace", shed_trace, restore_trace),
            ("speculation", shed_speculation, restore_speculation),
        ]

    def _health_event(self, event_type: str, reason: str,
                      message: str) -> None:
        """Backend/pipeline health transition -> k8s Event on the
        scheduler pseudo-object (the TPUBackend's health_cb target and
        the pipeline seams' own reporter). Repeats aggregate into one
        Event with a bumped count (EventRecorder semantics), so a miss
        storm or a flapping ladder stays one line per transition kind."""
        self.recorder.event(self._self_ref, event_type, reason, message)

    # -- event wiring (eventhandlers.go:364) -------------------------------

    def _add_event_handlers(self) -> None:
        pods = self.informers.pods()
        nodes = self.informers.nodes()

        def assigned(pod: v1.Pod) -> bool:
            return bool(pod.spec.node_name)

        def on_pod_add(pod: v1.Pod) -> None:
            if assigned(pod):
                self.cache.add_pod(pod)  # may confirm an assumed pod
                self.nominator.delete_nominated_pod_if_exists(pod)
                self._clear_preempt_tracking(pod)
            elif self._schedulable(pod):
                if pod.status.nominated_node_name:
                    self.nominator.add_nominated_pod(pod)
                self.queue.add(pod)

        def on_pod_update(old: v1.Pod, new: v1.Pod) -> None:
            if assigned(new):
                if assigned(old):
                    self.cache.update_pod(old, new)
                else:
                    self.cache.add_pod(new)
                self.nominator.delete_nominated_pod_if_exists(new)
                # a pod can BECOME assigned while a queue entry for it
                # exists (another scheduler instance bound it, or a
                # relist refresh after restart delivers the bound state
                # as an update) — retire the entry and any preemption
                # tracking exactly as the add path does, or the ghost
                # entry 409s on every future bind attempt
                self.queue.delete(new)
                self._clear_preempt_tracking(new)
            elif self._schedulable(new):
                self.nominator.update_nominated_pod(old, new)
                self.queue.update(old, new)

        def on_pod_delete(pod: v1.Pod) -> None:
            if assigned(pod):
                self.cache.remove_pod(pod)
                self.queue.move_all_to_active_or_backoff_queue("AssignedPodDelete")
                self._on_victim_deleted(pod)
            else:
                self.nominator.delete_nominated_pod_if_exists(pod)
                self.queue.delete(pod)
                self._clear_preempt_tracking(pod)
                # a deleted pod parked at Permit must resolve NOW, not
                # camp assumed until its timeout — and if it is a gang
                # member, the whole gang rolls back with it (its wave
                # can never complete; partial gangs must not hold
                # capacity)
                fwk = self.framework
                if fwk is not None and hasattr(fwk, "get_waiting_pod") \
                        and fwk.get_waiting_pod(v1.pod_key(pod)) is not None:
                    gang = self._gang_plugin()
                    if gang is not None:
                        gang.reject_gang_of(
                            pod, "member-deleted",
                            message=f"gang member "
                                    f"{pod.metadata.name!r} was deleted "
                                    f"while waiting at Permit",
                        )
                    # non-gang waiting pods (or a raced gate): direct
                    # rejection is the idempotent backstop
                    fwk.reject_waiting_pod(
                        v1.pod_key(pod), "Scheduler",
                        "pod deleted while waiting at Permit",
                    )

        pods.add_event_handler(
            EventHandler(on_add=on_pod_add, on_update=on_pod_update, on_delete=on_pod_delete)
        )

        def on_node_add(node: v1.Node) -> None:
            self.cache.add_node(node)
            self.queue.move_all_to_active_or_backoff_queue("NodeAdd")

        def on_node_update(old: v1.Node, new: v1.Node) -> None:
            self.cache.update_node(new)
            self.queue.move_all_to_active_or_backoff_queue("NodeUpdate")

        def on_node_delete(node: v1.Node) -> None:
            self.cache.remove_node(node.metadata.name)

        nodes.add_event_handler(
            EventHandler(on_add=on_node_add, on_update=on_node_update, on_delete=on_node_delete)
        )

    @staticmethod
    def _schedulable(pod: v1.Pod) -> bool:
        return pod.metadata.deletion_timestamp is None

    def _volume_handle_extras(self) -> dict:
        from ..volume.binder import SchedulerVolumeBinder

        pvc_inf = self.informers.informer_for("persistentvolumeclaims")
        pv_inf = self.informers.informer_for("persistentvolumes")
        sc_inf = self.informers.informer_for("storageclasses")
        csi_inf = self.informers.informer_for("csinodes")
        return {
            "volume_binder": SchedulerVolumeBinder(
                list_pvcs=pvc_inf.list,
                list_pvs=pv_inf.list,
                list_storage_classes=sc_inf.list,
                client=self.client,
                get_pvc=pvc_inf.get,
            ),
            "volume_listers": (pvc_inf.list, pv_inf.list),
            "csi_node_lister": csi_inf.list,
        }

    def _wire_volume_device(self) -> None:
        """Volume device path (volume_device.py): PVC/PV/CSINode listers
        feed the resolver; any volume-object event bumps its version and
        queues an encoding rebuild. Informers are created HERE — before
        factory.start() — because lazily-created informers never start."""
        from .volume_device import VolumeDeviceResolver

        pvc_inf = self.informers.informer_for("persistentvolumeclaims")
        pv_inf = self.informers.informer_for("persistentvolumes")
        csi_inf = self.informers.informer_for("csinodes")
        resolver = VolumeDeviceResolver(pvc_inf.list, pv_inf.list, csi_inf.list)
        self.tpu.set_volume_resolver(resolver)

        def bump_for(kind):
            return EventHandler(
                on_add=lambda obj: self.tpu.on_volume_change(kind, obj),
                on_update=lambda old, new: self.tpu.on_volume_change(kind, new),
                on_delete=lambda obj: self.tpu.on_volume_change(kind, obj),
            )

        pvc_inf.add_event_handler(bump_for("pvc"))
        pv_inf.add_event_handler(bump_for("pv"))
        csi_inf.add_event_handler(bump_for("csinode"))

    # -- leader election / split-brain-safe failover -----------------------

    def enable_leader_election(self, identity: str, config=None) -> None:
        """Arm lease-based leader election (call before start()): the
        instance then starts PAUSED and only pops pods while it holds
        the leader lease. Every state-changing write — binds,
        nominatedNodeName patches, victim deletes — carries the lease
        fencing token, and the apiserver rejects a deposed epoch's
        writes with FenceExpired; on fence loss the instance demotes
        (pause, abandon the device FIFO, flush completions) and rejoins
        the election."""
        from ..client.leaderelection import LeaderElectionConfig, LeaderElector

        if config is None:
            config = LeaderElectionConfig(identity=identity)
        elif not config.identity:
            config.identity = identity
        self.elector = LeaderElector(
            self.client,
            config,
            on_started_leading=self._on_started_leading,
            on_stopped_leading=self._on_stopped_leading,
        )

    def _on_started_leading(self) -> None:
        """Promotion (elector thread): latch the fencing token FIRST —
        every write from here on carries the new epoch — then reconcile
        the authoritative store into the caches, then open the pop
        gate. Order matters: reconcile-before-resume is what makes a
        restarted leader's decisions bit-identical to a never-crashed
        one's on the surviving pod set."""
        self._fence = self.elector.fencing_token()
        metrics.leader_transitions.inc()
        logger.info(
            "%s promoted to leader (epoch %s)",
            self.profile_name, getattr(self._fence, "transitions", None),
        )
        self._health_event(
            "Normal", "LeaderElected",
            f"{self.profile_name} acquired the scheduler lease",
        )
        try:
            self.reconcile_from_store()
        except Exception:  # noqa: BLE001 — the informer relist is the
            # backstop for anything a failed reconcile missed
            traceback.print_exc()
        self.resume()

    def _on_stopped_leading(self) -> None:
        """Demotion (fence loss, abdication, or stop): close the pop
        gate, abandon not-yet-harvested device batches and flush the
        completion FIFO (abandoned batches resolve RETRY_NODE and
        requeue), and record what the drain requeued so the NEXT
        promotion's reconcile can't requeue the same generation twice.
        The stale fencing token is deliberately NOT cleared: straggler
        writes still in binder threads must be rejected server-side,
        not escape unfenced."""
        self.pause()
        # roll back every waiting gang BEFORE draining: the parked
        # members hold assumed capacity this instance no longer owns —
        # the successor relists and reschedules them, and a deposed
        # leader completing a gang later would only bounce off the
        # fence one member-bind at a time. Whole waves, never a prefix.
        gang = self._gang_plugin()
        if gang is not None:
            for gate in gang.waiting_gangs():
                gang.reject_gang(
                    gate.namespace, gate.group, "demotion",
                    message="scheduler demoted while the gang waited "
                            "at Permit",
                )
        with self._completion_cv:
            fifo_pods = [
                info.pod for item in self._completions for info in item[0]
            ]
        # the completion worker is STILL RUNNING here (demotion is not
        # teardown) — it owns the FIFO, so flush through it: abandon the
        # un-harvested device batches (their results resolve RETRY_NODE)
        # and wait for the worker to land everything. Popping the FIFO
        # from this thread (_recover_completions) would race the worker.
        try:
            if self.tpu is not None:
                self.tpu.abandon_pending()
            self._drain_pipeline()
        except Exception:  # noqa: BLE001 — demotion must complete
            traceback.print_exc()
        pending = {v1.pod_key(p) for p in self.queue.pending_pods()}
        for pod in fifo_pods:
            key = v1.pod_key(pod)
            if key in pending:
                self._drain_requeued[key] = pod.metadata.generation or 0
        logger.info("%s demoted: lease lost or released", self.profile_name)

    def reconcile_from_store(self) -> Dict[str, int]:
        """Cold-restart / promotion reconciliation: relist pods from the
        authoritative store and repair this instance's view so a
        restarted (or newly promoted) scheduler treats the surviving pod
        set exactly as a never-crashed one would.

        - adopted: already-bound pods the cache doesn't know (a prior
          leader's binds that landed while this instance was down);
        - cleared: stale nominatedNodeName on unbound pods with no
          preemption in flight HERE — the old leader died mid-
          preemption and nobody is freeing that capacity anymore;
        - requeued: unbound, undeleted, unassumed pods entered into the
          queue exactly once (deduped by pod key + generation against
          both the live queue and the demotion drain's requeues).
        """
        with self._reconcile_lock:
            counts = {"adopted": 0, "requeued": 0, "cleared": 0}
            try:
                pods, _ = self.client.pods.list()
            except APIError:
                traceback.print_exc()
                return counts
            queued = {v1.pod_key(p) for p in self.queue.pending_pods()}
            # the store lists by key (lexicographic); requeue must
            # replay CREATION order or the restarted queue pops pod-2
            # after pod-19 and the batch placements diverge from the
            # never-crashed run's (restart parity is bit-identical
            # assignments, not just all-bound)
            pods.sort(key=lambda p: (
                p.metadata.creation_timestamp or 0.0,
                int(p.metadata.resource_version or 0),
            ))
            for pod in pods:
                key = v1.pod_key(pod)
                if pod.spec.node_name:
                    if not self.cache.has_pod(key):
                        self.cache.add_pod(pod)
                        counts["adopted"] += 1
                    continue
                if pod.metadata.deletion_timestamp is not None:
                    continue
                if (pod.status.nominated_node_name
                        and not self._preemption_in_flight(pod)):
                    self._reconcile_clear_nomination(pod)
                    counts["cleared"] += 1
                gen = pod.metadata.generation or 0
                if key in queued or self._drain_requeued.get(key) == gen:
                    continue  # already pending exactly once
                if self.cache.is_assumed_pod(pod):
                    continue  # an in-flight bind of ours owns it
                self.queue.add(pod)
                counts["requeued"] += 1
            gang = self._gang_plugin()
            if gang is not None:
                try:
                    self._reconcile_gangs(gang, pods)
                except Exception:  # noqa: BLE001 — gang healing must
                    # not break the base reconcile
                    traceback.print_exc()
            self._drain_requeued.clear()
            for outcome, n in counts.items():
                if n:
                    metrics.restart_reconcile.inc(n, outcome=outcome)
            logger.info(
                "%s reconciled from store: %d adopted, %d requeued, "
                "%d nominations cleared", self.profile_name,
                counts["adopted"], counts["requeued"], counts["cleared"],
            )
            return counts

    def _reconcile_gangs(self, gang, pods: List[v1.Pod]) -> None:
        """Promotion-time gang healing (the gang extension of the
        cold-restart reconcile): (1) bound gang members from a prior
        leader SEED the reserved-member index, so their re-driven
        siblings rejoin the partially-bound gang instead of waiting on
        a full fresh wave that can never assemble; (2) orphaned gang
        reservations — waves still parked HERE (a re-promoted leader)
        whose members are gone from the store, bound by another
        instance, or older than KTPU_GANG_PERMIT_TIMEOUT — roll back
        whole (reason=reconcile), releasing the capacity a dead
        transaction was camping on. A deposed leader's own late
        member-binds need no handling here: they bounce off the lease
        fence server-side (FenceExpired -> forget, never requeue)."""
        for pod in pods:
            if pod.spec.node_name and pod.metadata.deletion_timestamp is None:
                gang.seed_reserved(pod)
        by_key = {v1.pod_key(p): p for p in pods}
        timeout = knobs.get_float("KTPU_GANG_PERMIT_TIMEOUT") or 0.0
        now = _time.monotonic()
        for gate in gang.waiting_gangs():
            reason = None
            if gate.age(now) > timeout:
                reason = (
                    f"gang {gate.group!r}: wave older than "
                    f"KTPU_GANG_PERMIT_TIMEOUT ({timeout:.0f}s) at "
                    f"promotion"
                )
            else:
                for k in gate.members():
                    p = by_key.get(k)
                    if p is None or p.metadata.deletion_timestamp is not None \
                            or p.spec.node_name:
                        reason = (
                            f"gang {gate.group!r}: waiting member {k} is "
                            f"no longer pending in the store"
                        )
                        break
            if reason is not None:
                gang.reject_gang(
                    gate.namespace, gate.group, "reconcile", message=reason
                )

    def _reconcile_clear_nomination(self, pod: v1.Pod) -> None:
        """A relisted unbound pod carries a nomination from a preemption
        this instance never started: the victims are gone or will never
        be deleted — either way the nomination is a lie. Clear it in
        the nominator, the API object, and the local copy headed for
        the queue (synchronous, unlike _clear_nomination's binder-pool
        path: reconcile must finish before the pop gate opens)."""
        self.nominator.delete_nominated_pod_if_exists(pod)
        try:
            fresh = self.client.pods.get(
                pod.metadata.name, pod.metadata.namespace
            )
            fresh.status.nominated_node_name = ""
            self.client.pods.update_status(fresh, fence=self._fence)
        except APIError:
            pass
        pod.status.nominated_node_name = ""

    # -- run loop ----------------------------------------------------------

    def install_fault_injector(self, inj) -> None:
        """Wire a FaultInjector seam (testing/faults.py) into the
        pipeline workers and the TPU backend — the ChaosMonkey
        wedge-device / crash-scheduler disruptions arm faults on it."""
        self.faults = inj
        if self.tpu is not None:
            self.tpu.faults = inj

    def _check_kill(self, worker: str) -> None:
        inj = self.faults
        if inj is not None and inj.take_kill(worker):
            raise WorkerKilled(worker)

    def _supervised(self, name: str, fn, recover=None) -> None:
        """Panic isolation for a pipeline worker thread (the Supervisor's
        policy — controllers/manager.py — at thread granularity): a crash
        is counted, recovered (in-flight work drained back to the queue),
        and the loop restarts with fresh state under capped exponential
        backoff + full jitter. A clean return (stop) ends supervision."""
        backoff = 0.02
        while not self._stop.is_set():
            try:
                fn()
                return
            except BaseException:  # noqa: BLE001 — isolation is the point
                traceback.print_exc()
                metrics.worker_restarts.inc(worker=name)
                tracing.event("worker-crash", "fault", worker=name)
                metrics.dump_seam(f"worker-restart-{name}", worker=name)
                self._health_event(
                    "Warning", "WorkerRestart",
                    f"supervised pipeline worker '{name}' crashed and "
                    f"was restarted (in-flight work drained back to the "
                    f"queue)",
                )
                if recover is not None:
                    try:
                        recover()
                    except Exception:  # noqa: BLE001 — recovery best-effort
                        traceback.print_exc()
                delay = min(backoff, 2.0) * (1 + 0.5 * self.rng.random())
                backoff *= 2
                if self._stop.wait(delay):
                    return

    def start(self) -> None:
        if self._thread is None:
            if self.elector is not None:
                # standby until elected: the loop runs but the pop gate
                # stays closed — _on_started_leading opens it
                self.pause()
                self.elector.start()
            self._thread = threading.Thread(
                target=self._supervised, args=("scheduler", self._run),
                name="scheduler-loop", daemon=True,
            )
            self._thread.start()

    def pause(self) -> None:
        """Suspend popping (the queue keeps accumulating). Lets a caller
        stage a large backlog so the batch path drains it at full
        max_batch width instead of racing the producer with small ragged
        batches (each distinct batch bucket is an XLA compile)."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def stop(self) -> None:
        self.shutdown()

    def shutdown(self, timeout: float = 30.0) -> bool:
        """Deterministic teardown: stop the loop, land (or abandon) every
        in-flight batch, JOIN every worker thread, shut the binder pool.
        Idempotent. Returns True when every thread joined in time — the
        test suites' no-leaked-threads contract (daemon-flag teardown is
        the fallback, not the plan)."""
        ok = True
        if self.elector is not None:
            # vacate the lease FIRST so a standby takes over on its next
            # retry instead of waiting out expiry; on_stopped_leading
            # (pause + FIFO drain) is harmless ahead of full teardown
            try:
                self.elector.stop()
            except Exception:  # noqa: BLE001 — teardown best-effort
                traceback.print_exc()
        self._stop.set()
        self._permit_wake.set()  # let the permit drainer exit
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            ok &= not self._thread.is_alive()
        # the drainer submits released waves to the binder pool — join it
        # BEFORE the pool shuts down, or a mid-wave submit would raise and
        # strand the wave's assumed pods
        if self._permit_thread is not None:
            self._permit_thread.join(timeout=timeout)
            ok &= not self._permit_thread.is_alive()
        if self.backend == "tpu":
            try:
                # loop is dead; the completion worker lands the tail
                # batches (it drains the queue before honoring _stop),
                # and their binds must enter the pool before it shuts.
                # Every device wait inside is watchdog-bounded, so this
                # drain converges (or PipelineStalled demotes + escapes).
                self._drain_pipeline(timeout=timeout)
            except Exception:  # noqa: BLE001 — teardown best-effort
                traceback.print_exc()
        if self._completion_thread is not None:
            with self._completion_cv:
                self._completion_cv.notify_all()
            self._completion_thread.join(timeout=timeout)
            ok &= not self._completion_thread.is_alive()
        if self._completions and (
            self._completion_thread is None
            or not self._completion_thread.is_alive()
        ):
            # worker gone with batches still queued (stall/crash at
            # teardown): flush the FIFO deterministically — harvested
            # batches bind, abandoned ones requeue their pods
            self._recover_completions()
        if self.tpu is not None:
            self.tpu.close()  # stop the ladder probe thread
        self._binders.shutdown(wait=True)
        if not self.recorder.flush(timeout=5.0):  # events are async
            logger.warning(
                "event queue did not drain within 5s at scheduler stop "
                "(%d events dropped during the run)",
                self.recorder.dropped_events,
            )
        return ok

    def _run(self) -> None:
        import time

        last_cleanup = time.monotonic()
        while not self._stop.is_set():
            # kill seam OUTSIDE the isolation try: a WorkerKilled must
            # reach the supervision wrapper, not the keep-alive except.
            # It fires at the loop boundary — nothing popped, nothing in
            # flight — so the restart needs no recovery pass.
            self._check_kill("scheduler")
            try:
                if self._paused.is_set():
                    if self.backend == "tpu":
                        self._drain_pipeline()
                    time.sleep(0.02)
                    continue
                self.schedule_one(timeout=0.2)
                now = time.monotonic()
                if now - last_cleanup >= 1.0:  # cache.go:125 1s cleanup ticker
                    last_cleanup = now
                    self.cache.cleanup_expired_assumed_pods()
                    active, backoff, unsched = self.queue.depths()
                    metrics.pending_pods.set(active, queue="active")
                    metrics.pending_pods.set(backoff, queue="backoff")
                    metrics.pending_pods.set(
                        unsched, queue="unschedulable")
            except Exception:  # keep the loop alive; scheduleOne logs errors
                traceback.print_exc()

    # -- scheduling cycle --------------------------------------------------

    def schedule_one(self, timeout: Optional[float] = None) -> bool:
        """One scheduling cycle; returns False on queue timeout. In TPU
        mode, drains up to max_batch pods and schedules them in batched
        dispatches with sequential assume semantics."""
        info = self.queue.pop(timeout=timeout)
        if info is None:
            if self.backend == "tpu":
                self._drain_pipeline()  # idle: land the tail batches
            return False
        if self._paused.is_set():
            # pause() landed while this thread was already blocked in
            # pop: hand the pod back instead of scheduling past the
            # pause — a demoted leader must not pop work its successor
            # now owns
            self.queue.add(info.pod)
            return False
        info.pop_timestamp = _time.monotonic()
        with self._inflight_lock:
            self._inflight += 1
        t0 = _time.perf_counter()
        n_scheduled = 1
        try:
            if self.backend == "tpu":
                infos = [info]
                with tracing.span("pop", "pop") as sp:
                    while len(infos) < self.max_batch:
                        nxt = self.queue.pop(timeout=0)
                        if nxt is None:
                            break
                        nxt.pop_timestamp = info.pop_timestamp
                        infos.append(nxt)
                    sp.set(n=len(infos))
                n_scheduled = len(infos)
                metrics.batch_size.observe(n_scheduled)
                self._schedule_batch_tpu(infos)
            else:
                self._schedule_one_oracle(info)
        finally:
            dt = _time.perf_counter() - t0
            for _ in range(n_scheduled):
                metrics.scheduling_algorithm_duration.observe(dt / n_scheduled)
            with self._inflight_lock:
                self._inflight -= 1
        return True

    def _skip(self, pod: v1.Pod) -> bool:
        """scheduler.go:620 skipPodSchedule: deleted or already assumed.
        A pod ABSENT from the informer cache is deleted too: its delete
        event raced the pod's in-flight window (popped at delete time,
        so queue.delete was a no-op) and a failed bind re-queued it
        afterwards — scheduling it again would 404-bind and re-queue
        forever, a ghost entry cycling the queue (the reference's
        MakeDefaultErrorFunc drops exactly this case; surfaced by the
        soak's queue-returns-to-baseline invariant under delete churn)."""
        current = self.informers.pods().get(meta_namespace_key(pod))
        if current is None:
            return True
        if current.metadata.deletion_timestamp is not None:
            return True
        return self.cache.is_assumed_pod(pod)

    def _needs_oracle(self, pod: v1.Pod) -> bool:
        """Pods whose constraints live outside the TPU kernel take the
        oracle path. PVC-bearing pods ride the kernel when their volume
        constraints are statically resolvable (all PVCs bound, claims
        unshared — volume_device.py); unbound PVCs keep the oracle
        (VolumeBinding's provisioning decisions are host-side)."""
        if not any(
            (vol.source or {}).get("persistentVolumeClaim")
            for vol in pod.spec.volumes or []
        ):
            return False
        return self.tpu is None or not self.tpu.volume_kernel_safe(pod)

    def _schedule_batch_tpu(self, infos: List) -> None:
        cycle = self.queue.scheduling_cycle
        todo = [i for i in infos if not self._skip(i.pod)]
        if todo and self.tpu.ladder.rung() <= RUNG_ORACLE:
            # degradation ladder fully demoted: no device dispatch at
            # all — every pod rides the oracle until the background
            # probe re-promotes the backend (degradation.py)
            if not self._drain_or_requeue(todo):
                return
            for info in todo:
                self._schedule_one_oracle(info)
            return
        if self.framework is not None:
            # one partition pass: _needs_oracle runs a resolver pass for
            # PVC pods, and pending pods SHARING a claim within this
            # batch must not both ride the kernel (attach counting is
            # unique-handle; the refcount gate only sees assumed pods)
            from .volume_device import pod_pvc_names

            oracle_infos, kernel_infos = [], []
            batch_claims: set = set()
            for i in todo:
                claims = {
                    (i.pod.metadata.namespace, c)
                    for c in pod_pvc_names(i.pod)
                } if i.pod.spec.volumes else set()
                if self._needs_oracle(i.pod) or (claims & batch_claims):
                    oracle_infos.append(i)
                else:
                    kernel_infos.append(i)
                    batch_claims |= claims
            todo = kernel_infos
            if oracle_infos:
                # the oracle schedules against the cache snapshot: every
                # pipelined batch's assumes must land first
                if not self._drain_or_requeue(oracle_infos + todo):
                    return
                for info in oracle_infos:
                    self._schedule_one_oracle(info)
            # nominated-node short-circuit (generic_scheduler.go:235
            # evaluateNominatedNode): a preemptor whose victims were
            # evicted re-arrives with a nominated node — feasibility is
            # checked on THAT node only and the pod binds there without a
            # kernel dispatch (and without racing other waves' pods for
            # the freed capacity)
            nominated = [
                i for i in todo
                if (i.nominated_node or i.pod.status.nominated_node_name)
            ]
            if nominated:
                # feasibility runs on the cache snapshot — same drain
                # requirement as the oracle path
                if not self._drain_or_requeue(todo):
                    return
                placed = self._place_nominated(nominated)
                if placed:
                    todo = [i for i in todo if id(i) not in placed]
        if not todo:
            return
        # pipelined dispatch: enqueue this batch's scan (async on the
        # live session — it chains on the previous batch's carry), hand
        # the completion (harvest -> assume -> bind -> failures) to the
        # completion worker, and return to pop + encode the next batch.
        # The device double-buffers (tpu.max_pending); the worker
        # preserves dispatch order. Depth 0 completes inline — the
        # sequential reference path the parity gate compares against.
        # latch the basis BEFORE dispatch: a foreign event landing
        # between the latch and the session's delta fold is in the carry
        # but reads as "advanced" at completion — a conservative audit
        # skip. Latching after would invert that into false drift.
        basis_gen = (self.cache.foreign_mutations(),
                     self._dropped_decisions)
        wave_binds = self._wave_binds
        try:
            handle = self.tpu.dispatch_many([i.pod for i in todo])
        except Exception:  # noqa: BLE001 — the backend recovers its own
            # faults internally; an escape here is defensive: the pods
            # were never handed to the pipeline, so requeue exactly once
            traceback.print_exc()
            for info in todo:
                self.queue.add(info.pod)
            return
        handle.basis_mutations = basis_gen
        handle.wave_binds = wave_binds
        if self.pipeline_depth <= 0:
            self._complete_batch(todo, handle, cycle, _time.monotonic())
            return
        with self._completion_cv:
            if self._completion_thread is None:
                self._completion_thread = threading.Thread(
                    target=self._supervised,
                    args=("completion", self._completion_loop,
                          self._recover_completions),
                    name="batch-completions", daemon=True,
                )
                self._completion_thread.start()
            # the enqueue timestamp rides the FIFO item: queue-to-
            # completion age is the overload monitor's primary signal
            self._completions.append((todo, handle, cycle,
                                      _time.monotonic()))
            self._completion_cv.notify_all()
            # backpressure: the assume/bind lag stays bounded by the
            # pipeline depth (an unbounded queue would let the cache
            # trail arbitrarily far behind the device carry)
            while (
                len(self._completions) > self.pipeline_depth
                and not self._stop.is_set()
            ):
                self._completion_cv.wait(0.2)

    def _completion_loop(self) -> None:
        """The async bind queue: completes dispatched batches strictly in
        dispatch order, off the scheduling thread's critical path.
        assume-before-bind: a batch's decisions enter the scheduler cache
        (the device carry already holds them) before its bind POSTs go
        out; a failed bind forgets the assumed pod and requeues it
        unassigned — the reference's assume -> async bind ->
        confirm/forget contract (scheduler.go:359,:540)."""
        while True:
            with self._completion_cv:
                while not self._completions and not self._stop.is_set():
                    self._completion_cv.wait(0.2)
                if not self._completions:
                    return  # stopped and fully drained
                item = self._completions[0]
            # kill seam OUTSIDE the per-batch isolation: the worker dies
            # at a batch boundary (nothing harvested, nothing assumed)
            # and the supervision wrapper recovers + restarts it
            self._check_kill("completion")
            try:
                self._complete_batch(*item)
            except Exception:  # the worker must outlive batch bugs:
                # its death would strand every queued completion
                traceback.print_exc()
            finally:
                # remove AFTER completing: an empty deque means every
                # dispatched batch has fully landed (_drain_pipeline).
                # Guarded: a teardown-time _recover_completions flush may
                # have raced this item out already.
                with self._completion_cv:
                    if self._completions and self._completions[0] is item:
                        self._completions.popleft()
                    self._completion_cv.notify_all()

    def _recover_completions(self) -> None:
        """Completion-worker crash recovery: restore the invariant
        "every popped pod is either bound exactly once or back in the
        queue" before the fresh worker starts. Not-yet-harvested device
        batches are abandoned at the backend (their results resolve to
        RETRY_NODE; nothing of theirs ever touched the host encoding),
        then every queued completion is run to its terminal state:
        already-decided batches assume + bind exactly once, abandoned
        ones send their pods back to the scheduling queue."""
        if self.tpu is not None:
            self.tpu.abandon_pending()
        while True:
            with self._completion_cv:
                if not self._completions:
                    self._completion_cv.notify_all()
                    return
                item = self._completions[0]
            try:
                self._complete_batch(*item)
            except Exception:  # noqa: BLE001 — keep flushing the FIFO
                traceback.print_exc()
            finally:
                with self._completion_cv:
                    if self._completions and self._completions[0] is item:
                        self._completions.popleft()
                    self._completion_cv.notify_all()

    def _drain_pipeline(self, timeout: Optional[float] = None) -> bool:
        """Block until every dispatched batch has fully completed
        (assumed + binds submitted + failures handled). Runs on idle,
        pause, and stop, and before any path that reads the scheduler
        cache as ground truth (oracle scheduling, nominated placement).

        The wait is BOUNDED: every device wait inside the completion
        worker is already watchdog-bounded (TPUBackend.harvest), so a
        wedged device resolves through the fault/retry path well inside
        the drain budget. Exceeding it anyway means the pipeline is
        stalled beyond what retries can fix — demote the ladder and
        raise PipelineStalled; callers requeue their pods. Blocking the
        whole scheduler forever is the one forbidden outcome."""
        if self.pipeline_depth <= 0:
            return True
        if timeout is None:
            timeout = self.drain_timeout
        if timeout is None:
            watchdog = self.tpu.watchdog_timeout if self.tpu is not None \
                else 30.0
            # budget: every queued batch may burn a full watchdog +
            # retry storm before resolving
            timeout = max(30.0, 3.0 * watchdog)
        deadline = _time.monotonic() + timeout
        while True:
            with self._completion_cv:
                if not self._completions:
                    return True
                # orphaned-batch seam: the dispatching thread can append
                # a batch AFTER the worker saw (empty deque, _stop set)
                # and exited — the enqueue path only spawns a worker
                # when the thread slot is None, so nothing would ever
                # land it. The worker is dead, so the FIFO has no other
                # owner: land it from here.
                worker = self._completion_thread
                orphan = (
                    self._stop.is_set()
                    and (worker is None or not worker.is_alive())
                )
                item = self._completions[0] if orphan else None
                if item is None:
                    wait = min(0.2, deadline - _time.monotonic())
                    if wait <= 0:
                        stuck = len(self._completions)
                        break
                    self._completion_cv.wait(wait)
                    continue
            try:
                self._complete_batch(*item)
            except Exception:  # noqa: BLE001 — keep flushing the FIFO
                traceback.print_exc()
            finally:
                with self._completion_cv:
                    if self._completions and self._completions[0] is item:
                        self._completions.popleft()
                    self._completion_cv.notify_all()
        tracing.event("pipeline-stalled", "fault", stuck=stuck,
                      timeout=timeout)
        metrics.dump_seam("pipeline-stalled", stuck=stuck)
        demoted = self.tpu is not None and self.tpu.ladder.demote()
        self._health_event(
            "Warning", "PipelineStalled",
            "dispatched batches failed to land within the drain budget"
            + ("; backend demoted" if demoted else ""),
        )
        if demoted:
            logger.warning(
                "pipeline stalled: %d batches undrained after %.1fs — "
                "backend demoted to %s", stuck, timeout,
                self.tpu.ladder.mode(),
            )
            self.tpu._ensure_probe_thread()
        raise PipelineStalled(
            f"{stuck} dispatched batches failed to land within {timeout}s"
        )

    def _drain_or_requeue(self, infos: List) -> bool:
        """_drain_pipeline for the mid-cycle callers: on a stall the
        given (popped, not yet dispatched) infos go back to the queue
        exactly once and the cycle aborts."""
        try:
            self._drain_pipeline()
            return True
        except PipelineStalled:
            traceback.print_exc()
            for info in infos:
                self.queue.add(info.pod)
            return False

    def _complete_batch(self, todo: List, handle, cycle: int,
                        enq_ts: Optional[float] = None) -> None:
        # overload injection seam (ChaosMonkey kind="overload"): a
        # transient completion-worker stall, the synthetic form of the
        # host falling behind. Before harvest so the whole batch ages.
        if self.faults is not None:
            self.faults.on_completion()
        t0 = _time.monotonic()
        try:
            self._complete_batch_inner(todo, handle, cycle)
        finally:
            now = _time.monotonic()
            self._completion_durations.append(now - t0)
            age = (now - enq_ts) if enq_ts is not None else 0.0
            depth = len(self._completions)
            metrics.completion_fifo_depth.set(depth)
            metrics.completion_fifo_age.set(age)
            metrics.attempt_duration.observe(now - t0, stage="complete")
            metrics.attempt_duration.observe(age, stage="fifo-wait")
            if self.overload is not None:
                # completion-stage p99 over the recent window — the
                # same seam the PR-8 recorder spans as stage=complete
                durs = sorted(self._completion_durations)
                p99 = durs[int(0.99 * (len(durs) - 1))] if durs else 0.0
                active, backoff, unsched = self.queue.depths()
                self.overload.observe(
                    fifo_depth=depth,
                    fifo_age=age,
                    queue_depth=active + backoff,
                    stage_p99=p99,
                )

    def _complete_batch_inner(self, todo: List, handle,
                              cycle: int) -> None:
        results = self.tpu.harvest(handle)
        by_key = {v1.pod_key(p): node for p, node in results}
        from .tpu_backend import RETRY_NODE

        if self.tpu.shadow_sample > 0:
            # shadow parity sentinel: audit BEFORE this batch's assumes
            # land — the cache still holds the decision-time state for
            # pod 0 (completion is strictly FIFO, so every earlier
            # batch's assumes are already in)
            try:
                self._shadow_audit(results, handle)
            except Exception:  # noqa: BLE001 — the auditor observes the
                # pipeline, it must never break it
                traceback.print_exc()

        bound: List[Tuple] = []  # (info, node)
        failed: List = []
        gang = self._gang_plugin()
        for info in todo:
            node = by_key.get(v1.pod_key(info.pod))
            if node == RETRY_NODE:
                # volume gate/encode race: not unschedulable — re-gate
                # on the next pop instead of parking for the flusher.
                # Counts as a dropped decision for the sentinel's basis
                # gate: a recovery-abandoned batch resolves RETRY while
                # overlapping flights chained on its carry.
                self._dropped_decisions += 1
                if gang is not None:
                    # a gang member's dispatch abandoned (device fault /
                    # recovery): re-drive the ENTIRE gang, never a
                    # prefix — roll back its waiting wave so parked
                    # siblings release their reservations and requeue
                    # alongside this member
                    gang.reject_gang_of(
                        info.pod, "device-fault",
                        message=f"gang member "
                                f"{info.pod.metadata.name!r} abandoned "
                                f"mid-dispatch (device fault recovery)",
                    )
                self.queue.add(info.pod)
            elif node is None:
                failed.append(info)
            else:
                bound.append((info, node))
        if bound and getattr(handle, "wave_binds",
                             self._wave_binds) != self._wave_binds:
            bound = self._fit_harvest(bound)
        if bound:
            self._assume_and_bind_batch(bound)
        if failed:
            self._handle_failure_wave(failed, cycle)

    def _fit_harvest(self, bound: List[Tuple]) -> List[Tuple]:
        """A harvest whose flight overlapped a failure-wave bind, checked
        in batch order against the cache's requests: the bind landed
        behind the carry the batch chained on, so the batch may have given
        the same room to one of its pods. A placement that no longer fits
        leaves the session and the encoding and goes back to the queue;
        the rest are returned to be assumed."""
        from .plugins.noderesources import (
            compute_pod_resource_request,
            fits_request,
        )

        self.snapshot = self.cache.update_snapshot(self.snapshot)
        infos: Dict = {}
        kept: List[Tuple] = []
        dropped: List[Tuple] = []
        for info, node in bound:
            base = self.snapshot.node_info_map.get(node)
            if base is None or self.cache.has_pod(v1.pod_key(info.pod)):
                kept.append((info, node))
                continue
            ni = infos.get(node)
            if ni is None:
                ni = infos[node] = base.clone()
            if fits_request(compute_pod_resource_request(info.pod), ni):
                dropped.append((info, node))
            else:
                ni.add_pod(info.pod)
                kept.append((info, node))
        if dropped:
            self._dropped_decisions += len(dropped)
            tracing.event("placement-dropped", "fault", n=len(dropped))
            self.tpu.drop_placements([(i.pod, n) for i, n in dropped])
            for info, _ in dropped:
                self.queue.add(info.pod)
        return kept

    def _shadow_audit(self, results: List[Tuple], handle) -> None:
        """Shadow parity sentinel (KTPU_SHADOW_SAMPLE): replay sampled
        decided pods through the oracle filter/score chain against the
        decision-time cache state and count per-plugin drift.

        Runs on the completion worker BEFORE this batch's assumes land,
        so the cache holds exactly what the device carry held when the
        batch dispatched. Informer events that raced the flight would
        break that equality — the stale-basis gate (the handle's
        dispatch-latched foreign-mutation generation vs the cache's now)
        voids those audits (scheduler_shadow_skips_total{reason=
        "stale-basis"}) instead of reporting drift the device never
        caused; under completion lag (overload stalls, crash recovery)
        coverage drops but the zero-drift invariant stays meaningful.
        Pod i of the batch decided
        against the carry plus pods 0..i-1 of its own batch, so each
        sampled pod gets a private Snapshot with those prefix decisions
        cloned in — the shared cache NodeInfos are never touched.

        Drift = the device's node is infeasible per the oracle, or scores
        strictly below the oracle's max total; with an explain payload on
        the handle, ANY per-plugin mask/score mismatch counts even when
        the decision agrees (attribution_diff — the early-warning case).
        Each drift bumps scheduler_parity_drift_total{plugin}, dumps the
        flight-recorder ring through the shadow-drift seam, and freezes a
        replayable repro bundle."""
        from . import explain as explain_mod
        from .tpu_backend import RETRY_NODE

        rate = self.tpu.shadow_sample
        sampled = [
            i for i, (_, node) in enumerate(results)
            if node is not None and node != RETRY_NODE
            and self.rng.random() < rate
        ]
        if not sampled:
            return
        # decision-time cluster state, once per audited batch. Columnar
        # mode: an O(changed) clone view off the cache's generation-keyed
        # audit cache — no per-audit NodeInfo reconstruction from raw
        # objects, no Quantity re-parse (the reason production shadow
        # sample rates were capped). Object mode (KTPU_COLUMNAR_CACHE=0):
        # the raw dump + Snapshot.from_objects rebuild. Neither touches
        # update_snapshot's generation bookkeeping — a throwaway audit
        # must not starve the scheduling thread's incremental refreshes.
        base_infos = self.cache.audit_view()
        base_nodes = base_pods = None
        if base_infos is None:
            base_nodes, base_pods = self.cache.dump()
        basis = getattr(handle, "basis_mutations", None)
        if basis is not None and (self.cache.foreign_mutations(),
                                  self._dropped_decisions) != basis:
            # stale-basis gate, checked AFTER the state read so nothing
            # can land between the check and the read: either the cluster
            # moved under this flight (foreign event, expiry, forget) or
            # an overlapping in-flight batch dropped a decided placement
            # the chained carry had — in both cases the read is not the
            # decision-time state. Void the audit, keep the drift
            # counter honest.
            metrics.shadow_skips.inc(len(sampled), reason="stale-basis")
            return
        node_names = handle.node_names or []
        if base_infos is not None:
            # prefix decisions land incrementally across ascending
            # samples: each touched node is copy-on-write cloned once
            # (the audit_view clones are shared and must stay pristine),
            # then pod i's snapshot is just the current overlay state
            by_name = {
                ni.node.metadata.name: ni for ni in base_infos
            }
            overlaid: set = set()
            applied = 0
        for i in sampled:
            pod, node = results[i]
            metrics.shadow_samples.inc()
            if base_infos is not None:
                for p, n in results[applied:i]:
                    if n is None or n == RETRY_NODE:
                        continue
                    clone = copy.copy(p)
                    clone.spec = copy.copy(p.spec)
                    clone.spec.node_name = n
                    tgt = by_name.get(n)
                    if tgt is None:
                        continue  # from_objects also drops unknown nodes
                    if n not in overlaid:
                        tgt = tgt.clone()
                        by_name[n] = tgt
                        overlaid.add(n)
                    tgt.add_pod(clone)
                applied = i
                shadow_snap = Snapshot(list(by_name.values()))
            else:
                prefix = []
                for p, n in results[:i]:
                    if n is None or n == RETRY_NODE:
                        continue
                    clone = serde.from_dict(v1.Pod, serde.to_dict(p))
                    clone.spec.node_name = n
                    prefix.append(clone)
                shadow_pods = base_pods + prefix
                shadow_snap = Snapshot.from_objects(shadow_pods, base_nodes)
            oracle_bd = explain_mod.oracle_breakdown(shadow_snap, pod)
            device_bd = None
            if handle.explain is not None and i < len(handle.explain) \
                    and node_names:
                device_bd = explain_mod.payload_breakdown(
                    handle.explain[i], node_names)
            if explain_mod.decision_drifts(oracle_bd, node):
                plugins = explain_mod.drift_plugins(
                    oracle_bd, device_bd, node)
            elif device_bd is not None:
                plugins = explain_mod.attribution_diff(oracle_bd, device_bd)
            else:
                plugins = []
            if not plugins:
                continue
            key = v1.pod_key(pod)
            for plugin in plugins:
                metrics.parity_drift.inc(plugin=plugin)
            metrics.dump_seam(
                "shadow-drift", pod=key, node=node,
                plugins=",".join(plugins),
            )
            if base_infos is not None:
                # bundle inputs only materialize on drift (the rare
                # case) — never on the clean-audit hot path
                bundle_nodes = [ni.node for ni in by_name.values()]
                bundle_pods = [
                    pi.pod for ni in by_name.values() for pi in ni.pods
                ]
            else:
                bundle_nodes, bundle_pods = base_nodes, shadow_pods
            try:
                bundle = explain_mod.write_bundle(
                    pod, bundle_nodes, bundle_pods, node, plugins,
                    oracle_bd, device_bd, weights=self.tpu.weights,
                )
            except Exception:  # noqa: BLE001 — an unwritable bundle dir
                # must not swallow the drift signal itself
                traceback.print_exc()
                bundle = "<bundle write failed>"
            logger.warning(
                "shadow parity drift: pod %s on %s disagrees with the "
                "oracle replay (plugins: %s); repro bundle: %s",
                key, node, ",".join(plugins), bundle,
            )
            self._health_event(
                "Warning", "ShadowParityDrift",
                f"device decision for {key} diverged from the oracle "
                f"replay ({','.join(plugins)})",
            )

    def _handle_failure_wave(self, failed: List, cycle: int) -> None:
        """Failure handling for a whole batch at once. Preemption can
        only evict strictly-lower-priority victims, so pods at or below
        the cluster's priority floor park immediately (no dry-run can
        help). The rest split between the batched fast planner
        (preemption.py — one numpy pass over every node for the whole
        wave) and the oracle path (a batched kernel re-evaluation
        recovers per-node statuses, then DefaultPreemption runs per
        pod). The per-pod schedule() the redispatch replaces was a
        session teardown + full kernel launch each (r2's preemption
        crawl); the fast planner removes even the redispatch."""
        has_post_filter = bool(
            self.framework is not None and self.framework.post_filter_plugins
        )
        min_prio = self.cache.min_pod_priority() if has_post_filter else 0
        redispatch: List = []
        preemptable: List = []
        for info in failed:
            if self._preemption_in_flight(info.pod):
                # victims from a previous plan are still dying — park and
                # wait for their delete echoes (the oracle's terminating-
                # victim eligibility gate); planning a SECOND victim set
                # now would double-evict. Re-check after parking: the
                # last echo may have landed in between, with activate()
                # a no-op because the pod wasn't parked yet
                self._record_failure(info, cycle, {})
                if not self._preemption_in_flight(info.pod):
                    self.queue.activate(info.pod)
            elif not has_post_filter or (info.pod.spec.priority or 0) <= min_prio:
                self._record_failure(info, cycle, {})
            else:
                preemptable.append(info)
        if preemptable:
            self.snapshot = self.cache.update_snapshot(self.snapshot)
            pdbs = self._list_pdbs()
            # a nominated pod's required anti-affinity only matters to a
            # preemptor its terms MATCH (the nominated pod is ADDed in
            # RunFilterPluginsWithNominatedPods) — collect the terms once,
            # gate per pod
            from .framework.types import PodInfo as _PI

            nominated_anti_terms = [
                t
                for p in self.nominator.all_nominated_pods()
                if _has_required_anti_affinity(p)
                for t in _PI(p).required_anti_affinity_terms
            ]
            from .preemption_device import (
                ORACLE_FALLBACK,
                DevicePreemptionPlanner,
                device_eligible,
            )

            # ONE cluster pass over the pods with required anti-affinity
            # for the whole wave (satellite of the planner-ladder PR):
            # fast_eligible used to re-walk them per failed pod
            anti_terms = fast_preemption.WaveAntiTerms(self.snapshot)
            use_device = self.tpu is not None and self.tpu.whatif_enabled()
            fast: List = []
            eligibility: Dict[str, Tuple[bool, bool]] = {}
            for info in preemptable:
                pod = info.pod
                nominated_hit = any(
                    t.matches(pod) for t in nominated_anti_terms
                )
                fast_ok = not nominated_hit and fast_preemption.fast_eligible(
                    pod, self.snapshot, pdbs, self.extenders,
                    anti_terms=anti_terms,
                )
                dev_ok = (
                    use_device
                    and not nominated_hit
                    and device_eligible(pod, self.extenders, anti_terms)
                )
                if fast_ok or dev_ok:
                    eligibility[v1.pod_key(pod)] = (dev_ok, fast_ok)
                    fast.append(info)
                else:
                    redispatch.append(info)
            if fast:
                # victims claimed by in-flight waves whose delete echoes
                # have not landed in the cache yet must not be claimed
                # again (their capacity is already spoken for by the
                # claiming preemptor's nominator entry)
                with self._preempt_lock:
                    claimed = set(self._victim_waiters)
                if use_device:
                    # three-rung planner ladder: device what-if scan ->
                    # numpy fast planner -> oracle redispatch, one shared
                    # set of wave books so rungs never double-claim
                    planner = DevicePreemptionPlanner(
                        self.snapshot, self.nominator, self.tpu,
                        args=self._preemption_args(),
                        claimed_victims=claimed,
                        pdbs=pdbs,
                        eligibility=eligibility,
                    )
                else:
                    planner = fast_preemption.FastPreemptionPlanner(
                        self.snapshot, self.nominator,
                        args=self._preemption_args(),
                        claimed_victims=claimed,
                        pdbs=pdbs,
                    )
                with tracing.span("preemption-plan", "planner",
                                  n=len(fast)) as psp:
                    cands = planner.plan([i.pod for i in fast])
                    paths = getattr(planner, "planner_paths", None)
                    if paths and tracing.enabled():
                        mix: Dict[str, int] = {}
                        for p in paths:
                            mix[p] = mix.get(p, 0) + 1
                        psp.set(**mix)
                        if tracing.RECORDER.pod_level():
                            for info, path in zip(fast, paths):
                                tracing.provenance(
                                    v1.pod_key(info.pod), planner=path)
                preempted: List[Tuple] = []
                for info, cand, fits in zip(fast, cands, planner.fits_now):
                    if cand is ORACLE_FALLBACK:
                        # mid-wave rung exhaustion (device fault on a pod
                        # the numpy envelope rejects): the oracle rung
                        redispatch.append(info)
                    elif fits:
                        # cluster state moved since the batch dispatched:
                        # the pod fits without preemption — let the
                        # kernel re-evaluate (scores + sequential assume)
                        redispatch.append(info)
                    elif cand is None:
                        # preemption cannot help anymore: a stale
                        # nomination would keep short-circuiting the
                        # batch path for nothing — clear it and take
                        # normal backoff
                        if info.nominated_node or \
                                info.pod.status.nominated_node_name:
                            self._clear_nomination(info)
                        self._record_failure(info, cycle, {})
                    else:
                        preempted.append((info, cand))
                if preempted:
                    self._apply_preemptions(preempted, cycle)
        if redispatch:
            # ONE batched re-evaluation recovers per-node failure
            # statuses for every failed pod (the preemption dry-run's
            # input). A pod that now FITS (state moved since its batch)
            # binds; the batched evaluation is against one state, so only
            # the first fit binds directly — later fits re-dispatch
            # singly to keep sequential-assume semantics (rare: failure
            # waves mostly stay failed).
            from .tpu_backend import RETRY_NODE

            bound_once = False
            for info, (node, statuses) in zip(
                redispatch, self.tpu.reevaluate([i.pod for i in redispatch])
            ):
                if node == RETRY_NODE:
                    self.queue.add(info.pod)
                elif node is None:
                    self._record_failure(info, cycle, statuses)
                elif not bound_once:
                    bound_once = True
                    self._assume_and_bind(info.pod, node, info=info)
                    self._wave_binds += 1
                else:
                    try:
                        r = self.tpu.schedule(info.pod)
                        self._assume_and_bind(
                            info.pod, r.suggested_host, info=info
                        )
                        self._wave_binds += 1
                    except FitError as fe:
                        self._record_failure(
                            info, cycle, fe.filtered_nodes_statuses
                        )
                    except DeviceFault:
                        # retries exhausted inside schedule(): back to
                        # the queue exactly once; the ladder (already
                        # fault-counted) decides the next attempt's path
                        self.queue.add(info.pod)

    def _preemption_args(self) -> dict:
        """The DefaultPreemption plugin's candidate-count args, so the
        fast planner scans exactly as far as the oracle would."""
        if self.framework is not None:
            for pl in self.framework.post_filter_plugins:
                if getattr(pl, "name", "") == "DefaultPreemption":
                    return {
                        "minCandidateNodesPercentage":
                            pl.min_candidate_nodes_percentage,
                        "minCandidateNodesAbsolute":
                            pl.min_candidate_nodes_absolute,
                    }
        return {}

    def _apply_preemptions(self, items: List[Tuple], cycle: int) -> None:
        """PrepareCandidate (default_preemption.go:690) for a wave of
        fast-planned candidates. Scheduler-thread work is the in-memory
        bookkeeping only (nominations, metrics, queue parking); the API
        effects — victim deletes, then nominatedNodeName status patches —
        run on a worker so the scheduler is already parked on the queue
        when the delete echoes flush the wave back (the r3 serial apply
        held the scheduling thread for the whole wave)."""
        for info, cand in items:
            pod = info.pod
            metrics.preemption_attempts.inc()
            metrics.preemption_victims.observe(len(cand.victims))
            self.recorder.event(
                pod, "Normal", "Preempted",
                f"preempted {len(cand.victims)} pod(s) on node "
                f"{cand.node_name}",
            )
            self.nominator.add_nominated_pod(pod, cand.node_name)
            info.nominated_node = cand.node_name
            for lower in get_lower_priority_nominated_pods(
                self.nominator, pod, cand.node_name
            ):
                self.nominator.delete_nominated_pod_if_exists(lower)
            # register the victim set on the node's wave, THEN park: the
            # node's preemptors re-activate together when its last
            # claimed victim's delete echoes
            pkey = v1.pod_key(pod)
            vkeys = {v1.pod_key(v) for v in cand.victims}
            with self._preempt_lock:
                pending, infos = self._node_waves.setdefault(
                    cand.node_name, (set(), [])
                )
                pending |= vkeys
                infos.append(info)
                self._inflight_preemptors.add(pkey)
                for vk in vkeys:
                    self._victim_waiters[vk] = cand.node_name
            self._record_failure(info, cycle, {})
            # the wave may have fully drained between registration and
            # parking — activate now rather than never
            if not self._preemption_in_flight(pod):
                self.queue.activate(pod)

        extra_victims = self._gang_preemption_closure(items)

        def _effects(items=items, extra_victims=extra_victims):
            # victims first — their deletion unblocks the preemptors; the
            # status patch is observability (the in-memory nominated_node
            # already steers the queue and the placement short-circuit)
            from ..apiserver.server import NotFound

            for info, cand in items:
                for victim in cand.victims:
                    try:
                        self.client.pods.delete(
                            victim.metadata.name, victim.metadata.namespace,
                            fence=self._fence,
                        )
                    except NotFound:
                        # already gone — but ONLY resolve the wave here
                        # if the delete echo has also been processed
                        # (victim absent from the informer cache);
                        # otherwise the in-flight echo fires
                        # _on_victim_deleted itself, and resolving
                        # early would activate preemptors against a
                        # cache that still shows the victim
                        if self.informers.pods().get(
                            meta_namespace_key(victim)
                        ) is None:
                            self._on_victim_deleted(victim)
                    except APIError:
                        # transient server error: the victim may still
                        # be alive — leave the wave pending (the 60s
                        # leftover flush is the honest fallback)
                        logger.warning(
                            "victim delete failed for %s",
                            v1.pod_key(victim), exc_info=True,
                        )
            # gang closure: bound siblings of evicted gang members go
            # too (whole gangs or none), same echo bookkeeping
            for victim in extra_victims:
                try:
                    self.client.pods.delete(
                        victim.metadata.name, victim.metadata.namespace,
                        fence=self._fence,
                    )
                except NotFound:
                    if self.informers.pods().get(
                        meta_namespace_key(victim)
                    ) is None:
                        self._on_victim_deleted(victim)
                except APIError:
                    logger.warning(
                        "gang sibling delete failed for %s",
                        v1.pod_key(victim), exc_info=True,
                    )
            for info, cand in items:
                try:
                    fresh = self.client.pods.get(
                        info.pod.metadata.name, info.pod.metadata.namespace
                    )
                    fresh.status.nominated_node_name = cand.node_name
                    self.client.pods.update_status(fresh, fence=self._fence)
                except APIError:
                    pass

        with self._inflight_lock:
            self._inflight += 1
        try:
            self._binders.submit(self._run_then_release, _effects)
        except RuntimeError:  # pool shut down (stop() race)
            with self._inflight_lock:
                self._inflight -= 1
            _effects()

    def _gang_preemption_closure(self, items: List[Tuple]) -> List[v1.Pod]:
        """Whole-gangs-or-none eviction closure for a preemption wave.

        The planners already emit same-node gang victims as indivisible
        units; what they cannot see is a victim gang's members bound on
        OTHER nodes.  One informer pass finds those bound siblings and
        registers them on the claiming preemptor's node wave (so the
        preemptor re-activates only once the whole gang's deletes have
        echoed), returning them for _effects to delete.  Any
        still-waiting wave of a victim gang is rolled back too — its
        parked members release their reservations rather than straggle
        in as a partial gang."""
        from .plugins.coscheduling import pod_group

        # (ns, group) -> node wave that claims the closure's echoes
        gang_nodes: Dict[Tuple[str, str], str] = {}
        claimed = set()
        for info, cand in items:
            for victim in cand.victims:
                claimed.add(v1.pod_key(victim))
                group, min_available = pod_group(victim)
                if group and min_available > 1:
                    gk = (victim.metadata.namespace, group)
                    gang_nodes.setdefault(gk, cand.node_name)
        if not gang_nodes:
            return []

        extra: List[v1.Pod] = []
        for pod in self.informers.pods().list():
            group, min_available = pod_group(pod)
            if not group or min_available <= 1:
                continue
            node = gang_nodes.get((pod.metadata.namespace, group))
            if node is None:
                continue
            key = v1.pod_key(pod)
            if key in claimed:
                continue
            if not pod.spec.node_name or pod.metadata.deletion_timestamp:
                continue
            with self._preempt_lock:
                if key in self._victim_waiters:
                    continue  # already claimed by an in-flight wave
                pending, _infos = self._node_waves.setdefault(
                    node, (set(), [])
                )
                pending.add(key)
                self._victim_waiters[key] = node
            claimed.add(key)
            extra.append(pod)

        gangpl = self._gang_plugin()
        for (ns, group), _node in gang_nodes.items():
            metrics.gang_preempted.inc()
            if gangpl is not None:
                gangpl.reject_gang(
                    ns, group, "preempted",
                    message=f"gang {group!r} preempted by higher-priority "
                            f"pod(s); rolling back its waiting members",
                )
        return extra

    def _clear_nomination(self, info) -> None:
        """util.ClearNominatedNodeName equivalent: the nomination can no
        longer lead anywhere (no candidate and no fit) — drop it from the
        nominator, the queue bookkeeping, and the API status."""
        pod = info.pod
        info.nominated_node = ""
        self.nominator.delete_nominated_pod_if_exists(pod)
        if pod.status.nominated_node_name:
            def _clear(pod=pod):
                try:
                    fresh = self.client.pods.get(
                        pod.metadata.name, pod.metadata.namespace
                    )
                    fresh.status.nominated_node_name = ""
                    self.client.pods.update_status(fresh, fence=self._fence)
                except APIError:
                    pass
            with self._inflight_lock:
                self._inflight += 1
            try:
                self._binders.submit(self._run_then_release, _clear)
            except RuntimeError:  # pool shut down (stop() race)
                with self._inflight_lock:
                    self._inflight -= 1
                _clear()

    def _on_victim_deleted(self, pod: v1.Pod) -> None:
        """A deleted assigned pod may be a claimed preemption victim:
        when its node's LAST outstanding victim goes, activate every
        preemptor nominated there (skip any remaining backoff — the
        capacity they were promised just finished freeing)."""
        key = v1.pod_key(pod)
        ready: List = []
        with self._preempt_lock:
            node = self._victim_waiters.pop(key, None)
            if node is None:
                return
            wave = self._node_waves.get(node)
            if wave is None:
                return
            pending, infos = wave
            pending.discard(key)
            if not pending:
                del self._node_waves[node]
                for info in infos:
                    self._inflight_preemptors.discard(v1.pod_key(info.pod))
                ready = infos
        for info in ready:
            self.queue.activate(info.pod)

    def _clear_preempt_tracking(self, pod: v1.Pod) -> None:
        """The preemptor bound or was deleted: drop its in-flight state.
        Its node wave keeps draining for any sibling preemptors."""
        key = v1.pod_key(pod)
        with self._preempt_lock:
            if key not in self._inflight_preemptors:
                return
            self._inflight_preemptors.discard(key)
            for node, (pending, infos) in list(self._node_waves.items()):
                infos[:] = [i for i in infos if v1.pod_key(i.pod) != key]
                if not infos and not pending:
                    del self._node_waves[node]

    def _preemption_in_flight(self, pod: v1.Pod) -> bool:
        with self._preempt_lock:
            return v1.pod_key(pod) in self._inflight_preemptors

    def _run_then_release(self, fn) -> None:
        try:
            fn()
        except Exception:  # noqa: BLE001
            traceback.print_exc()
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _place_nominated(self, infos: List) -> set:
        """Feasibility on the nominated node ONLY (the reference's
        evaluateNominatedNode); feasible pods assume+bind directly.
        Returns ids of placed infos."""
        self.snapshot = self.cache.update_snapshot(self.snapshot)
        bound: List[Tuple] = []
        placed: set = set()
        for info in infos:
            node_name = (
                info.nominated_node or info.pod.status.nominated_node_name
            )
            ni = self.snapshot.node_info_map.get(node_name)
            if ni is None:
                continue
            state = CycleState()
            st = self.framework.run_pre_filter_plugins(state, info.pod)
            if st is not None and not st.is_success():
                continue
            st = self.framework.run_filter_plugins_with_nominated_pods(
                state, info.pod, ni, self.nominator
            )
            if st is not None:
                continue
            bound.append((info, node_name))
            placed.add(id(info))
        if bound:
            self._assume_and_bind_batch(bound)
        return placed

    def _assume_and_bind_batch(self, bound: List[Tuple]) -> None:
        """Batched assume + binding-cycle kickoff. Per-pod semantics match
        _assume_and_bind exactly; the batching removes the host costs the
        full-loop profile blamed: per-pod serde deep copies, cache-lock
        ping-pong between assume (scheduler thread) and finish_binding
        (binder pool), one executor submission + bind POST + event write
        per pod. The reference's answer to the same costs is 8 parallel
        binder goroutines (scheduler.go:540); under a GIL the equivalent
        lever is one binder task carrying the whole batch."""
        # shallow clone (pod + spec): only spec.nodeName diverges; the
        # informer's confirm replaces the cache entry with its own object
        # moments later. Deep-copying 4k pods through serde per batch was
        # ~10% of the measured window.
        assumed_list: List[v1.Pod] = []
        for info, node in bound:
            assumed = copy.copy(info.pod)
            assumed.spec = copy.copy(info.pod.spec)
            assumed.spec.node_name = node
            assumed_list.append(assumed)
        with tracing.span("assume", "assume", n=len(assumed_list)):
            ok = self.cache.assume_pods(assumed_list)
        batch_items: List[Tuple] = []  # (assumed, node, state, info)
        # one check per harvest, not per pod: with no Reserve and no
        # Permit plugins registered (the common profile), the entire
        # _reserve_and_permit call is a guaranteed "bind" — skip the
        # per-pod framework dispatch. CycleState is still minted per pod
        # (PreBind/PostBind read it in the binding cycle).
        fwk = self.framework
        plugins_engaged = fwk is not None and (
            fwk.reserve_plugins or fwk.permit_plugins)
        with tracing.span("reserve-permit", "reserve-permit",
                          n=len(assumed_list)):
            for (info, node), assumed, assumed_ok in zip(
                    bound, assumed_list, ok):
                if not assumed_ok:
                    # already in cache (informer raced us): the device
                    # carry keeps this placement, the cache never takes
                    # it — void overlapping shadow audits
                    self._dropped_decisions += 1
                    continue
                state = CycleState()
                if not plugins_engaged or self._reserve_and_permit(
                        state, assumed, node, info) == "bind":
                    batch_items.append((assumed, node, state, info))
        if batch_items:
            with self._inflight_lock:
                self._inflight += 1
            try:
                self._binders.submit(self._bind_batch, batch_items)
            except RuntimeError:
                # pool shut down (stop() raced a lagging completion):
                # bind inline — we're already off the scheduler thread,
                # and stranding the batch assumed-in-cache is worse
                self._bind_batch(batch_items)

    def _reserve_and_permit(
        self, state: CycleState, assumed: v1.Pod, node_name: str, info
    ) -> str:
        """Shared Reserve+Permit sequence for an already-assumed pod
        (scheduler.go:508,:520). Returns "bind" when the caller should
        proceed to the binding cycle; "handled" when the pod was aborted
        or parked on a WAIT thread here."""
        fwk = self.framework
        if fwk is None:
            return "bind"
        # RunReservePluginsReserve (scheduler.go:508)
        st = fwk.run_reserve_plugins_reserve(state, assumed, node_name)
        if st is not None and not st.is_success():
            fwk.run_reserve_plugins_unreserve(state, assumed, node_name)
            self._abort_binding(assumed, f"Reserve: {st.message()}")
            return "handled"
        # RunPermitPlugins (scheduler.go:520); WAIT parks the pod and the
        # binding thread blocks in wait_on_permit
        st = fwk.run_permit_plugins(state, assumed, node_name)
        if st is not None and not st.is_success() and st.code != Code.WAIT:
            fwk.run_reserve_plugins_unreserve(state, assumed, node_name)
            self._abort_binding(assumed, f"Permit: {st.message()}")
            return "handled"
        if st is not None and st.code == Code.WAIT:
            # WAIT-parked pods must NOT occupy the bounded binder pool: a
            # gang larger than the pool would deadlock (every worker
            # blocked in wait_on_permit, the unblocking pod queued behind
            # them). The reference runs one goroutine per binding cycle
            # (scheduler.go:540); a thread per parked pod at gang scale
            # (thousands parked at once) thrashes the GIL, so parked pods
            # register a resolution listener and ONE drainer thread
            # releases them through the batched binding cycle.
            self._park_waiting(assumed, node_name, state, info)
            return "handled"
        return "bind"

    # -- permit drainer: WAIT pods without a thread each -------------------

    def _park_waiting(
        self, assumed: v1.Pod, node_name: str, state: CycleState, info
    ) -> None:
        with self._inflight_lock:
            self._inflight += 1
        key = v1.pod_key(assumed)
        wp = self.framework.get_waiting_pod(key)
        if wp is None:
            # resolved before we could park (plugin allowed within
            # run_permit_plugins' return): plain binding cycle
            try:
                self._binders.submit(self._bind, assumed, node_name, state, info)
            except RuntimeError:  # pool shut down (stop() race)
                with self._inflight_lock:
                    self._inflight -= 1
                self._retry_failed_bind(assumed)
            return
        with self._permit_lock:
            self._permit_parked[key] = (assumed, node_name, state, info, wp)
            if self._permit_thread is None:
                self._permit_thread = threading.Thread(
                    target=self._permit_drain_loop,
                    name="permit-drainer", daemon=True,
                )
                self._permit_thread.start()
        wp.add_listener(lambda k=key: self._permit_release(k))

    def _permit_release(self, key: str) -> None:
        with self._permit_lock:
            item = self._permit_parked.pop(key, None)
            if item is not None:
                self._permit_released.append(item)
        self._permit_wake.set()

    def _permit_drain_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._permit_drain_once()
            except Exception:  # the drainer must outlive plugin bugs:
                # its death would strand every parked pod forever
                traceback.print_exc()

    def _permit_drain_once(self) -> None:
        # wake on releases, or in time for the nearest permit deadline
        with self._permit_lock:
            parked = list(self._permit_parked.values())
        now = _time.monotonic()
        next_deadline = min(
            (wp.deadline for _, _, _, _, wp in parked), default=now + 0.5
        )
        self._permit_wake.wait(timeout=max(0.02, min(next_deadline - now, 0.5)))
        self._permit_wake.clear()
        now = _time.monotonic()
        for _, _, _, _, wp in parked:
            # deadline is immutable: the lock-free check skips the cv
            # acquisition for the (vast) non-expired majority
            if now >= wp.deadline:
                wp.timeout_if_due(now)  # fires the release listener
        try:
            self._gang_deadlock_tick(now)
        except Exception:  # noqa: BLE001 — the breaker observes; a bug
            # in it must not kill the drainer
            traceback.print_exc()
        with self._permit_lock:
            released, self._permit_released = self._permit_released, []
        if not released:
            return
        items: List[Tuple] = []
        aborted: List[Tuple[v1.Pod, str]] = []
        fwk = self.framework
        for assumed, node_name, state, info, _wp in released:
            try:
                # resolved already — returns instantly and unparks the pod
                st = fwk.wait_on_permit(assumed)
                if st is not None and not st.is_success():
                    fwk.run_reserve_plugins_unreserve(state, assumed, node_name)
                    aborted.append((assumed, f"Permit: {st.message()}"))
                    with self._inflight_lock:
                        self._inflight -= 1
                    continue
            except Exception:
                # release the inflight hold and requeue rather than
                # stranding the assumed pod
                traceback.print_exc()
                with self._inflight_lock:
                    self._inflight -= 1
                try:
                    self._retry_failed_bind(assumed)
                except Exception:  # noqa: BLE001
                    traceback.print_exc()
                continue
            items.append((assumed, node_name, state, info))
        if aborted:
            # a gang rollback rejects the whole wave into ONE drain pass:
            # abort it as one batch (single cache lock, one carry-delta
            # batch to the device session), each member requeued exactly
            # once — its WaitingPod resolved exactly once to get here
            try:
                self._abort_binding_batch(aborted)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
        if items:
            # hand the whole release wave to the batched binding cycle;
            # swap the per-pod inflight holds for the batch's single one
            with self._inflight_lock:
                self._inflight -= len(items) - 1
            try:
                self._binders.submit(self._bind_batch, items)
            except RuntimeError:
                # pool already shut down (stop() race): release the wave
                # instead of stranding it assumed-in-cache
                with self._inflight_lock:
                    self._inflight -= 1
                for assumed, _, _, _ in items:
                    try:
                        self._retry_failed_bind(assumed)
                    except Exception:  # noqa: BLE001
                        traceback.print_exc()

    def _bind_batch(self, items: List[Tuple]) -> None:
        """Binding cycle for a whole batch in one worker: PreBind per pod,
        bulk bind application, single-lock finish_binding, batched metrics,
        async events. `unsettled` tracks pods whose outcome is not yet
        decided: an unexpected exception must forget+requeue them, or the
        assumed pods would phantom-occupy node resources forever
        (cleanup_expired_assumed_pods only expires pods whose binding
        FINISHED — an assumed pod that never reaches finish_binding has
        no expiry)."""
        unsettled = {id(assumed): assumed for assumed, _, _, _ in items}
        bind_t0 = _time.monotonic()
        bind_sp = tracing.span("bind", "bind", n=len(items))
        bind_sp.__enter__()
        try:
            fwk = self.framework
            ready: List[Tuple] = []
            for assumed, node, state, info in items:
                if fwk is not None:
                    st = fwk.run_pre_bind_plugins(state, assumed, node)
                    if st is not None and not st.is_success():
                        fwk.run_reserve_plugins_unreserve(state, assumed, node)
                        unsettled.pop(id(assumed), None)
                        self._abort_binding(assumed, f"PreBind: {st.message()}")
                        continue
                ready.append((assumed, node, state, info))
            if not ready:
                return
            outcomes = self.client.pods.bind_many(
                [(a.metadata.namespace, a.metadata.name, node)
                 for a, node, _, _ in ready],
                fence=self._fence,
            )
            now = _time.monotonic()
            done: List[Tuple] = []
            for (assumed, node, state, info), err in zip(ready, outcomes):
                unsettled.pop(id(assumed), None)
                if isinstance(err, FenceExpired):
                    # our lease epoch is dead: the new leader owns this
                    # pod now. Forget the assumed state but do NOT
                    # requeue — requeuing here is how a deposed leader
                    # double-schedules (the successor's reconcile has
                    # already relisted it).
                    self.cache.forget_pod(assumed)
                elif err is not None:
                    self._retry_failed_bind(assumed)
                else:
                    done.append((assumed, node, state, info))
            if not done:
                return
            self.cache.finish_binding_many([a for a, _, _, _ in done])
            metrics.schedule_attempts.inc(
                len(done), result=metrics.SCHEDULED, profile=self.profile_name
            )
            for assumed, node, state, info in done:
                # one pod's PostBind/event failure must not skip the
                # rest of the batch's hooks (all of `done` is already
                # bound — there is nothing left to unwind)
                try:
                    self._observe_bound(info, now)
                    self.recorder.event(
                        assumed, "Normal", "Scheduled",
                        f"Successfully assigned {assumed.metadata.namespace}/"
                        f"{assumed.metadata.name} to {node}",
                    )
                    if fwk is not None:
                        fwk.run_post_bind_plugins(state, assumed, node)
                except Exception:  # noqa: BLE001
                    traceback.print_exc()
        except FenceExpired:
            # whole-call fence rejection (a frontend that raises instead
            # of collecting per-binding outcomes): forget, never requeue
            for assumed in unsettled.values():
                self.cache.forget_pod(assumed)
        except Exception:
            traceback.print_exc()
            for assumed in unsettled.values():
                try:
                    self._retry_failed_bind(assumed)
                except Exception:  # noqa: BLE001 — keep releasing the rest
                    traceback.print_exc()
        finally:
            bind_sp.__exit__(None, None, None)
            metrics.attempt_duration.observe(
                _time.monotonic() - bind_t0, stage="bind")
            with self._inflight_lock:
                self._inflight -= 1

    def _retry_failed_bind(self, assumed: v1.Pod) -> None:
        """Bind POST failed: forget and requeue UNASSIGNED (keeping the
        failed nodeName would pin every retry to that node via the
        NodeName filter)."""
        self.cache.forget_pod(assumed)
        retry = serde.from_dict(v1.Pod, serde.to_dict(assumed))
        retry.spec.node_name = ""
        self.queue.add(retry)

    def _observe_bound(self, info, now: float) -> None:
        """Per-pod scheduling-latency metrics at bind-sent time."""
        if info is None:
            return
        e2e = now - info.initial_attempt_timestamp
        attempt = now - (info.pop_timestamp or info.initial_attempt_timestamp)
        metrics.pod_scheduling_duration.observe(e2e, attempts=str(info.attempts))
        metrics.scheduling_attempt_duration.observe(attempt)
        # kube-style SLO histograms (scheduler_perf SLIs): e2e from the
        # FIRST attempt stamp, attempt from the LAST queue pop, queue
        # wait as the difference — all from stamps that already exist.
        metrics.e2e_duration.observe(e2e)
        metrics.attempt_duration.observe(attempt, stage="attempt")
        metrics.queue_wait.observe(max(0.0, e2e - attempt))
        self.latency_samples.append((e2e, attempt, info.attempts))
        self.bind_timestamps.append(now)

    def _schedule_one_oracle(self, info) -> None:
        pod = info.pod
        cycle = self.queue.scheduling_cycle
        if self._skip(pod):
            return
        self.snapshot = self.cache.update_snapshot(self.snapshot)
        state = CycleState()
        try:
            result = self.algorithm.schedule(
                state, self.framework, pod, self.snapshot, nominator=self.nominator
            )
        except FitError as fe:
            self._record_failure(info, cycle, fe.filtered_nodes_statuses, state)
            return
        self._assume_and_bind(pod, result.suggested_host, state, info=info)

    # -- failure path: preemption then unschedulable queue -----------------

    def _list_pdbs(self) -> List[v1.PodDisruptionBudget]:
        try:
            items, _ = self.client.resource("poddisruptionbudgets").list()
            return items
        except Exception:
            return []

    def _record_failure(
        self,
        info,
        cycle: int,
        statuses: Optional[Dict[str, object]] = None,
        state: Optional[CycleState] = None,
    ) -> None:
        """scheduler.go:427 failure branch: RunPostFilterPlugins (preemption)
        then park in the unschedulable queue with nominatedNodeName set so
        the next attempt lands on the freed node."""
        pod = info.pod
        metrics.schedule_attempts.inc(
            result=metrics.UNSCHEDULABLE, profile=self.profile_name
        )
        self.recorder.event(
            pod, "Warning", "FailedScheduling",
            f"0/{self.cache.node_count()} nodes are available",
        )
        if statuses:
            try:
                self._try_preempt(pod, statuses, state)
            except Exception:
                traceback.print_exc()
        self.queue.add_unschedulable_if_not_present(info, cycle)

    def _try_preempt(self, pod: v1.Pod, statuses, state: Optional[CycleState]) -> None:
        self.snapshot = self.cache.update_snapshot(self.snapshot)
        if state is None:
            # TPU path: the kernel bypassed the oracle PreFilter, but the
            # preemption dry-run's AddPod/RemovePod extensions read its
            # CycleState — run it here (framework.go:426)
            state = CycleState()
            st = self.framework.run_pre_filter_plugins(state, pod)
            if st is not None and not st.is_success():
                return
        metrics.preemption_attempts.inc()
        metrics.preemption_planner.inc(path="oracle")
        result, status = self.framework.run_post_filter_plugins(state, pod, statuses)
        if result is None or status is None or not status.is_success():
            return
        node_name = result.nominated_node_name
        metrics.preemption_victims.observe(len(result.victims))
        self.recorder.event(
            pod, "Normal", "Preempted",
            f"preempted {len(result.victims)} pod(s) on node {node_name}",
        )
        # PrepareCandidate (default_preemption.go:690): patch nomination,
        # evict victims, clear lower-priority nominations on that node
        self.nominator.add_nominated_pod(pod, node_name)
        try:
            fresh = self.client.pods.get(pod.metadata.name, pod.metadata.namespace)
            fresh.status.nominated_node_name = node_name
            self.client.pods.update_status(fresh, fence=self._fence)
        except APIError:
            pass
        for victim in result.victims:
            try:
                self.client.pods.delete(
                    victim.metadata.name, victim.metadata.namespace,
                    fence=self._fence,
                )
            except APIError:
                pass
        for lower in get_lower_priority_nominated_pods(self.nominator, pod, node_name):
            self.nominator.delete_nominated_pod_if_exists(lower)

    # -- assume + binding cycle (scheduler.go:359,:540) --------------------

    def _assume_and_bind(
        self,
        pod: v1.Pod,
        node_name: str,
        state: Optional[CycleState] = None,
        info=None,
    ) -> None:
        # copy before assume (scheduler.go:445 pod.DeepCopy): the queue and
        # informer cache must not see the assumed nodeName. Shallow pod+spec
        # copy suffices — only spec.nodeName diverges and nothing mutates
        # the shared tail objects (the copy discipline informers enforce).
        assumed = copy.copy(pod)
        assumed.spec = copy.copy(pod.spec)
        assumed.spec.node_name = node_name
        try:
            self.cache.assume_pod(assumed)
        except ValueError:
            return  # already in cache (informer raced us)
        state = state if state is not None else CycleState()
        if self._reserve_and_permit(state, assumed, node_name, info) != "bind":
            return
        with self._inflight_lock:
            self._inflight += 1
        self._binders.submit(self._bind, assumed, node_name, state, info)

    def _abort_binding(self, assumed: v1.Pod, reason: str) -> None:
        """Reserve/Permit/PreBind failure: forget the assumed pod and retry
        it unassigned (scheduler.go:516 failure branches)."""
        self.cache.forget_pod(assumed)
        self.recorder.event(assumed, "Warning", "FailedScheduling", reason)
        retry = serde.from_dict(v1.Pod, serde.to_dict(assumed))
        retry.spec.node_name = ""
        self.queue.add(retry)

    def _abort_binding_batch(self, items: List[Tuple[v1.Pod, str]]) -> None:
        """_abort_binding for a whole rollback wave (a rejected gang):
        one batched cache forget — the device session absorbs the
        wave's released capacity as one carry-delta batch — then each
        member requeues unassigned, exactly once."""
        self.cache.forget_pods([assumed for assumed, _ in items])
        for assumed, reason in items:
            self.recorder.event(
                assumed, "Warning", "FailedScheduling", reason)
            retry = serde.from_dict(v1.Pod, serde.to_dict(assumed))
            retry.spec.node_name = ""
            # backoff re-entry, not active: the wave's released capacity
            # must be claimable by OTHER pods (a rival gang's stalled
            # member) before these members re-drive, or a deadlock
            # back-off re-forms the same stall it just broke
            self.queue.requeue_with_backoff(retry)

    # -- gang transaction seams --------------------------------------------

    def _gang_plugin(self):
        """The Coscheduling permit plugin instance, when the profile
        enables it (None otherwise) — the scheduler-side rollback paths
        (deletion, deadlock, device fault, demotion, reconcile) all
        route whole-gang rejections through its wave gates."""
        fwk = self.framework
        if fwk is None:
            return None
        for pl in getattr(fwk, "permit_plugins", ()):
            if getattr(pl, "name", "") == "Coscheduling":
                return pl
        return None

    def _gang_deadlock_tick(self, now: float) -> None:
        """Host-side gang deadlock breaker, ticked from the permit
        drainer: two or more gangs each camping on partial capacity the
        others need make no membership progress — after
        KTPU_GANG_DEADLOCK_TICKS consecutive stalled observations (at
        least KTPU_GANG_DEADLOCK_INTERVAL apart) the YOUNGEST stalled
        gang (latest first park) is backed off whole, freeing its
        reserved capacity for the elders. Bounded and hysteretic: one
        gang per trigger, never the same gang twice in a row, never
        with fewer than two stalled gangs, and a gang whose membership
        moved resets its own counter. A stalled gang that is jointly
        INFEASIBLE on the current cluster (the batched positive-delta
        what-if says its remaining members can never co-place) is
        preferred as the back-off victim — it can never complete, so
        backing off a feasible younger gang instead would be waste."""
        gang = self._gang_plugin()
        if gang is None:
            return
        interval = knobs.get_float("KTPU_GANG_DEADLOCK_INTERVAL")
        if now - self._gang_tick_last < (interval or 0.0):
            return
        self._gang_tick_last = now
        gates = [g for g in gang.waiting_gangs() if not g.failed]
        if len(gates) < 2:
            self._gang_stall = {}
            return
        ticks = max(1, knobs.get_int("KTPU_GANG_DEADLOCK_TICKS") or 1)
        stalled = []
        nxt: Dict[Tuple[str, str], Tuple] = {}
        for g in gates:
            sig = frozenset(g.members())
            prev_sig, count = self._gang_stall.get(
                (g.namespace, g.group), (None, 0))
            count = count + 1 if sig == prev_sig else 1
            nxt[(g.namespace, g.group)] = (sig, count)
            if count >= ticks:
                stalled.append(g)
        self._gang_stall = nxt
        if len(stalled) < 2:
            return
        stalled.sort(key=lambda g: g.first_park or 0.0, reverse=True)
        infeasible = [
            g for g in stalled if self._gang_feasible(g) is False
        ]
        ordered = infeasible + [g for g in stalled if g not in infeasible]
        victim = ordered[0]
        if (victim.namespace, victim.group) == self._gang_last_backoff \
                and len(ordered) > 1:
            victim = ordered[1]
        self._gang_last_backoff = (victim.namespace, victim.group)
        self._gang_stall.pop((victim.namespace, victim.group), None)
        gang.reject_gang(
            victim.namespace, victim.group, "deadlock",
            message=f"gang {victim.group!r} backed off by the deadlock "
                    f"breaker ({len(stalled)} gangs mutually stalled)",
        )

    def _gang_feasible(self, gate) -> Optional[bool]:
        """Joint co-placement feasibility for a waiting gang: can its
        REMAINING members (beyond the ones already reserved) co-place
        on the current cluster at all? Scored as one batched
        positive-delta what-if launch on a scratch carry
        (ops/whatif.py gang_fits): per-node multiplicity of the member
        template, summed and compared against the need. None = unknown
        (whatif off, no parked member to take the template from, or
        the launch faulted) — callers must treat unknown as feasible."""
        tpu = self.tpu
        fn = getattr(tpu, "gang_feasible", None)
        if tpu is None or fn is None or not tpu.whatif_enabled():
            return None
        member_keys = gate.members()
        with self._permit_lock:
            probe = next(
                (self._permit_parked[k][0] for k in member_keys
                 if k in self._permit_parked),
                None,
            )
        if probe is None:
            return None
        gang = self._gang_plugin()
        reserved = 0
        if gang is not None:
            reserved = gang._reserved_members(gate.group, gate.namespace)
        remaining = gate.min_available - reserved
        if remaining <= 0:
            return True
        return fn(probe, remaining)

    def _bind(
        self, assumed: v1.Pod, node_name: str, state: CycleState, info=None
    ) -> None:
        try:
            fwk = self.framework
            if fwk is not None:
                # WaitOnPermit (framework.go:1015) then PreBind (volume
                # binding API writes happen here, scheduler.go:540)
                st = fwk.wait_on_permit(assumed)
                if st is not None and not st.is_success():
                    fwk.run_reserve_plugins_unreserve(state, assumed, node_name)
                    self._abort_binding(assumed, f"Permit: {st.message()}")
                    return
                st = fwk.run_pre_bind_plugins(state, assumed, node_name)
                if st is not None and not st.is_success():
                    fwk.run_reserve_plugins_unreserve(state, assumed, node_name)
                    self._abort_binding(assumed, f"PreBind: {st.message()}")
                    return
            self.client.pods.bind(
                assumed.metadata.namespace, assumed.metadata.name, node_name,
                fence=self._fence,
            )
            self.cache.finish_binding(assumed)
            metrics.schedule_attempts.inc(
                result=metrics.SCHEDULED, profile=self.profile_name
            )
            self._observe_bound(info, _time.monotonic())
            self.recorder.event(
                assumed, "Normal", "Scheduled",
                f"Successfully assigned {assumed.metadata.namespace}/"
                f"{assumed.metadata.name} to {node_name}",
            )
            if self.framework is not None:
                self.framework.run_post_bind_plugins(state, assumed, node_name)
        except FenceExpired:
            # deposed mid-bind: forget the assumed pod, do NOT requeue —
            # the successor relisted it at promotion (before FenceExpired
            # — a subclass of APIError — the clause below would have
            # requeued it into a double-schedule)
            self.cache.forget_pod(assumed)
        except APIError:
            self._retry_failed_bind(assumed)
        except Exception:
            traceback.print_exc()
            self.cache.forget_pod(assumed)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    # -- introspection -----------------------------------------------------

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Test helper: queue drained AND no batch/bind in flight."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._inflight_lock:
                inflight = self._inflight
            with self._completion_cv:
                completions = len(self._completions)
            if (
                inflight == 0
                and completions == 0  # pipelined tail batches
                and not self.queue.pending_pods()
            ):
                return True
            time.sleep(0.05)
        return False
