"""Framework runtime: instantiates plugins from a profile and runs the
extension points.

Reference: pkg/scheduler/framework/runtime/framework.go — NewFramework
(:238), RunPreFilterPlugins (:426), RunFilterPlugins (:530),
RunFilterPluginsWithNominatedPods (:610), RunPreScorePlugins (:687),
RunScorePlugins (:723; score loop -> NormalizeScore -> x weight),
RunReservePlugins*, RunPermitPlugins (:962), RunPreBind/Bind/PostBind.

The per-node parallel loops (parallelize.Until with 16 workers) are run
serially here: the CPU oracle path exists for semantic parity testing and as
a fallback; the production path is the one-dispatch TPU kernel in
kubernetes_tpu.ops, which replaces RunFilterPlugins x nodes and
RunScorePlugins x nodes entirely.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ...api.types import Node, Pod, pod_key
from . import interface as fwk
from .interface import Code, CycleState, NodeScore, Status
from .types import NodeInfo, PodInfo


class WaitingPod:
    """A pod parked at Permit (runtime/waiting_pods_map.go waitingPod):
    each WAIT-returning plugin must Allow it, any may Reject; the binding
    goroutine blocks in Framework.wait_on_permit until resolution or the
    max plugin timeout."""

    def __init__(self, pod: Pod, plugin_timeouts: Dict[str, float]):
        self.pod = pod
        self._pending = set(plugin_timeouts)
        self._cv = threading.Condition()
        self._resolved = False
        self._status: Optional[Status] = None
        self._deadline = time.monotonic() + max(plugin_timeouts.values())
        self._listeners: List[Callable[[], None]] = []
        self._gate = None

    def set_gate(self, gate) -> None:
        """Attach a resolution arbiter (plugins/coscheduling.py GangGate).
        When the deadline and the gang's completion race, exactly one
        side wins: a timeout may resolve this pod ONLY after flipping
        the gate to failed; if the gate already completed, the allow()
        from the completing thread is in flight and timeout yields."""
        self._gate = gate

    def pending_plugins(self) -> List[str]:
        with self._cv:
            return sorted(self._pending)

    @property
    def deadline(self) -> float:
        return self._deadline

    def allow(self, plugin_name: str) -> None:
        with self._cv:
            self._pending.discard(plugin_name)
            if not self._pending and not self._resolved:
                self._resolved = True
                self._status = None  # success
            self._cv.notify_all()
            fire = self._take_listeners_locked()
        for fn in fire:
            fn()

    def reject(self, plugin_name: str, msg: str) -> None:
        with self._cv:
            if not self._resolved:
                self._resolved = True
                self._status = Status.unschedulable(
                    f"pod {self.pod.metadata.name!r} rejected while waiting at "
                    f"Permit: {msg}"
                )
                self._status.failed_plugin = plugin_name
            self._cv.notify_all()
            fire = self._take_listeners_locked()
        for fn in fire:
            fn()

    def add_listener(self, fn: Callable[[], None]) -> None:
        """Call fn() once, when this pod resolves (allow-all / reject /
        timeout); immediately if already resolved. Lets ONE drainer thread
        service every parked pod instead of one blocked thread per pod —
        a gang workload parks thousands at once."""
        with self._cv:
            if not self._resolved:
                self._listeners.append(fn)
                return
        fn()

    def timeout_if_due(self, now: float) -> bool:
        """Resolve with the timeout status if the deadline passed (the
        drainer's replacement for the per-thread wait loop's timeout).
        Returns False when a gang gate says completion won the race:
        the pod is NOT resolved here — the completing thread's allow()
        is about to resolve it success."""
        with self._cv:
            if self._resolved or now < self._deadline:
                return self._resolved
        return self._try_timeout()

    def _try_timeout(self) -> bool:
        """Arbitrate a due deadline against the gang gate (if any).
        True: this pod is resolved (timed out, or something else
        resolved it concurrently). False: the gate completed first —
        yield to the completing thread's allow()."""
        gate = self._gate
        if gate is not None and not gate.fail():
            with self._cv:
                return self._resolved
        with self._cv:
            if not self._resolved:
                self._resolved = True
                self._status = Status.unschedulable(
                    f"pod {self.pod.metadata.name!r} timed out waiting at "
                    f"Permit"
                )
                self._cv.notify_all()
            fire = self._take_listeners_locked()
        for fn in fire:
            fn()
        return True

    def _take_listeners_locked(self) -> List[Callable[[], None]]:
        if not self._resolved or not self._listeners:
            return []
        fire, self._listeners = self._listeners, []
        return fire

    def wait(self) -> Optional[Status]:
        while True:
            with self._cv:
                while not self._resolved:
                    remaining = self._deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=min(remaining, 0.5))
                if self._resolved:
                    status = self._status
                    fire = self._take_listeners_locked()
                    break
            if self._try_timeout():
                with self._cv:
                    status = self._status
                    fire = self._take_listeners_locked()
                break
            # the gang gate completed first: allow() is in flight on the
            # completing thread — wait for it to land, then re-read
            with self._cv:
                if not self._resolved:
                    self._cv.wait(timeout=0.05)
        for fn in fire:
            fn()
        return status

PluginFactory = Callable[[Optional[dict], "Framework"], fwk.Plugin]


class Registry(dict):
    """Plugin name -> factory (runtime/registry.go Registry)."""

    def register(self, name: str, factory: PluginFactory) -> None:
        if name in self:
            raise ValueError(f"a plugin named {name} already exists")
        self[name] = factory

    def merge(self, other: "Registry") -> None:
        for name, factory in other.items():
            self.register(name, factory)


class PluginSet:
    """Enabled plugins for one extension point with weights."""

    def __init__(self, enabled: Optional[List[Tuple[str, int]]] = None):
        self.enabled = enabled or []  # [(name, weight)]


class Framework:
    """One profile's configured plugin pipeline (framework.go:90 frameworkImpl)."""

    def __init__(
        self,
        registry: Registry,
        profile_name: str = "default-scheduler",
        plugins: Optional[Dict[str, List[Tuple[str, int]]]] = None,
        plugin_config: Optional[Dict[str, dict]] = None,
        snapshot_fn: Optional[Callable[[], object]] = None,
        parallelism: int = 16,
        handle_extras: Optional[Dict[str, object]] = None,
    ):
        self.profile_name = profile_name
        self.parallelism = parallelism
        self._snapshot_fn = snapshot_fn
        self._plugins_cfg = plugins or {}
        plugin_config = plugin_config or {}
        # Handle surface consumed by plugins at construction time
        # (interface.go:515 Handle: listers, clientset, volume binder).
        self.volume_binder = None
        self.volume_listers = None
        self.csi_node_lister = None
        self.client = None
        self.cache = None  # SchedulerCache (Coscheduling reservation counts)
        self.service_lister = None  # ServiceAffinity
        self.spread_listers = None  # SelectorSpread: () -> (svcs, rcs, rss, sss)
        for key, value in (handle_extras or {}).items():
            setattr(self, key, value)
        # Permit waiting-pods map (runtime/waiting_pods_map.go)
        self._waiting_pods: Dict[str, WaitingPod] = {}
        self._waiting_lock = threading.Lock()

        # Instantiate each referenced plugin exactly once (framework.go:276).
        needed: List[str] = []
        for names in self._plugins_cfg.values():
            for name, _ in names:
                if name not in needed:
                    needed.append(name)
        self.plugins: Dict[str, fwk.Plugin] = {}
        for name in needed:
            if name not in registry:
                raise ValueError(f"{name} does not exist in the plugin registry")
            self.plugins[name] = registry[name](plugin_config.get(name), self)

        def point(key: str) -> List[fwk.Plugin]:
            return [self.plugins[name] for name, _ in self._plugins_cfg.get(key, [])]

        self.queue_sort_plugins = point("queueSort")
        self.pre_filter_plugins = point("preFilter")
        self.filter_plugins = point("filter")
        self.post_filter_plugins = point("postFilter")
        self.pre_score_plugins = point("preScore")
        self.score_plugins = point("score")
        self.score_plugin_weight = {
            name: weight for name, weight in self._plugins_cfg.get("score", [])
        }
        self.reserve_plugins = point("reserve")
        self.permit_plugins = point("permit")
        self.pre_bind_plugins = point("preBind")
        self.bind_plugins = point("bind")
        self.post_bind_plugins = point("postBind")

    # -- Handle surface (interface.go:515) ---------------------------------
    def snapshot_shared_lister(self):
        return self._snapshot_fn() if self._snapshot_fn else None

    # -- QueueSort ---------------------------------------------------------
    def queue_sort_func(self):
        if not self.queue_sort_plugins:
            return None
        return self.queue_sort_plugins[0].less

    # -- PreFilter ---------------------------------------------------------
    def run_pre_filter_plugins(self, state: CycleState, pod: Pod) -> Optional[Status]:
        for pl in self.pre_filter_plugins:
            status = pl.pre_filter(state, pod)
            if not fwk.is_success(status):
                status.failed_plugin = pl.name
                return status
        return None

    def run_pre_filter_extension_add_pod(
        self, state: CycleState, pod: Pod, pod_info_to_add: PodInfo, node_info: NodeInfo
    ) -> Optional[Status]:
        for pl in self.pre_filter_plugins:
            if pl.pre_filter_extensions() is not None:
                status = pl.add_pod(state, pod, pod_info_to_add, node_info)
                if not fwk.is_success(status):
                    return status
        return None

    def run_pre_filter_extension_remove_pod(
        self, state: CycleState, pod: Pod, pod_info_to_remove: PodInfo, node_info: NodeInfo
    ) -> Optional[Status]:
        for pl in self.pre_filter_plugins:
            if pl.pre_filter_extensions() is not None:
                status = pl.remove_pod(state, pod, pod_info_to_remove, node_info)
                if not fwk.is_success(status):
                    return status
        return None

    # -- Filter ------------------------------------------------------------
    def run_filter_plugins(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Dict[str, Status]:
        """framework.go:530: runs all filter plugins, stops at first failure
        (unless recording all statuses); returns plugin->status map."""
        statuses: Dict[str, Status] = {}
        for pl in self.filter_plugins:
            status = pl.filter(state, pod, node_info)
            if not fwk.is_success(status):
                if not status.is_unschedulable():
                    status = Status(Code.ERROR, [f"running {pl.name!r} filter plugin: {status.message()}"])
                status.failed_plugin = pl.name
                statuses[pl.name] = status
                break
        return statuses

    def run_filter_plugins_with_nominated_pods(
        self, state: CycleState, pod: Pod, node_info: NodeInfo, nominator=None
    ) -> Optional[Status]:
        """framework.go:610: evaluate filters twice when the node has
        higher-priority nominated pods — once with them added, once without."""
        pod_priority = pod.spec.priority or 0
        nominated = []
        if nominator is not None and node_info.node is not None:
            nominated = [
                p
                for p in nominator.nominated_pods_for_node(node_info.node.metadata.name)
                if (p.spec.priority or 0) >= pod_priority
                and pod_key(p) != pod_key(pod)
            ]
        for run_with_nominated in ([True, False] if nominated else [False]):
            state_to_use = state
            node_info_to_use = node_info
            if run_with_nominated:
                state_to_use = state.clone()
                node_info_to_use = node_info.clone()
                for p in nominated:
                    pi = PodInfo(p)
                    node_info_to_use.add_pod_info(pi)
                    status = self.run_pre_filter_extension_add_pod(
                        state_to_use, pod, pi, node_info_to_use
                    )
                    if not fwk.is_success(status):
                        return status
            statuses = self.run_filter_plugins(state_to_use, pod, node_info_to_use)
            if statuses:
                return next(iter(statuses.values()))
        return None

    # -- PostFilter --------------------------------------------------------
    def run_post_filter_plugins(
        self, state: CycleState, pod: Pod, filtered_node_status_map: Dict[str, Status]
    ) -> Tuple[Optional[object], Optional[Status]]:
        statuses = []
        for pl in self.post_filter_plugins:
            result, status = pl.post_filter(state, pod, filtered_node_status_map)
            if status is not None and status.code == Code.SUCCESS:
                return result, status
            if status is not None and status.code != Code.UNSCHEDULABLE:
                return None, status
            statuses.append(status)
        reasons = [r for s in statuses if s for r in s.reasons]
        return None, Status(Code.UNSCHEDULABLE, reasons)

    # -- PreScore / Score --------------------------------------------------
    def run_pre_score_plugins(
        self, state: CycleState, pod: Pod, nodes: Sequence[Node]
    ) -> Optional[Status]:
        for pl in self.pre_score_plugins:
            status = pl.pre_score(state, pod, nodes)
            if not fwk.is_success(status):
                return Status(
                    Code.ERROR,
                    [f"running PreScore plugin {pl.name!r}: {status.message()}"],
                )
        return None

    def run_score_plugins(
        self, state: CycleState, pod: Pod, nodes: Sequence[Node]
    ) -> Tuple[Dict[str, List[NodeScore]], Optional[Status]]:
        """framework.go:723 RunScorePlugins.

        THE LOOP THE TPU KERNEL REPLACES. Order is load-bearing for parity:
        (1) per-node raw scores, (2) NormalizeScore per plugin, (3) x weight.
        """
        plugin_to_node_scores: Dict[str, List[NodeScore]] = {}
        for pl in self.score_plugins:
            scores = []
            for node in nodes:
                s, status = pl.score(state, pod, node.metadata.name)
                if not fwk.is_success(status):
                    return {}, Status(
                        Code.ERROR,
                        [f"plugin {pl.name!r} failed with: {status.message()}"],
                    )
                scores.append(NodeScore(node.metadata.name, s))
            plugin_to_node_scores[pl.name] = scores
        for pl in self.score_plugins:
            if pl.has_normalize:
                status = pl.normalize_score(state, pod, plugin_to_node_scores[pl.name])
                if not fwk.is_success(status):
                    return {}, Status(
                        Code.ERROR,
                        [f"plugin {pl.name!r} failed with: {status.message()}"],
                    )
        for pl in self.score_plugins:
            weight = self.score_plugin_weight.get(pl.name, 1)
            scores = plugin_to_node_scores[pl.name]
            for ns in scores:
                if ns.score > fwk.MAX_NODE_SCORE or ns.score < fwk.MIN_NODE_SCORE:
                    return {}, Status(
                        Code.ERROR,
                        [
                            f"plugin {pl.name!r} returns an invalid score {ns.score}, "
                            f"it should in the range of [{fwk.MIN_NODE_SCORE}, {fwk.MAX_NODE_SCORE}] after normalizing"
                        ],
                    )
                ns.score = ns.score * weight
        return plugin_to_node_scores, None

    # -- Reserve / Permit / Bind -------------------------------------------
    def run_reserve_plugins_reserve(self, state: CycleState, pod: Pod, node_name: str) -> Optional[Status]:
        for pl in self.reserve_plugins:
            status = pl.reserve(state, pod, node_name)
            if not fwk.is_success(status):
                return status
        return None

    def run_reserve_plugins_unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        # unreserve in reverse registration order (framework.go:932)
        for pl in reversed(self.reserve_plugins):
            pl.unreserve(state, pod, node_name)

    # Longest a Permit plugin may park a pod (framework.go maxTimeout 15min).
    MAX_PERMIT_TIMEOUT = 15 * 60.0

    def run_permit_plugins(self, state: CycleState, pod: Pod, node_name: str) -> Optional[Status]:
        """framework.go:962 RunPermitPlugins: WAIT-returning plugins park the
        pod in the waiting-pods map; the binding cycle then blocks in
        wait_on_permit (framework.go:1015)."""
        plugin_timeouts: Dict[str, float] = {}
        for pl in self.permit_plugins:
            status, timeout = pl.permit(state, pod, node_name)
            if not fwk.is_success(status):
                if status.code == Code.WAIT:
                    plugin_timeouts[pl.name] = min(
                        timeout or self.MAX_PERMIT_TIMEOUT, self.MAX_PERMIT_TIMEOUT
                    )
                    continue
                if status.is_unschedulable():
                    status.failed_plugin = pl.name
                    return status
                return Status(Code.ERROR, [f"running Permit plugin {pl.name!r}: {status.message()}"])
        if plugin_timeouts:
            wp = WaitingPod(pod, plugin_timeouts)
            with self._waiting_lock:
                self._waiting_pods[pod_key(pod)] = wp
            # notify the WAIT-returning plugins AFTER publishing the
            # map entry: a gang plugin attaches its gate and records
            # the park time here, and any later member completing the
            # gang must be able to find this pod via get_waiting_pod
            for pl in self.permit_plugins:
                if pl.name in plugin_timeouts:
                    on_waiting = getattr(pl, "on_waiting", None)
                    if on_waiting is not None:
                        on_waiting(wp)
            return Status(Code.WAIT)
        return None

    def wait_on_permit(self, pod: Pod) -> Optional[Status]:
        """framework.go:1015 WaitOnPermit: block the binding goroutine until
        every waiting Permit plugin allows (or one rejects / times out)."""
        with self._waiting_lock:
            wp = self._waiting_pods.get(pod_key(pod))
        if wp is None:
            return None
        try:
            return wp.wait()
        finally:
            with self._waiting_lock:
                self._waiting_pods.pop(pod_key(pod), None)

    def get_waiting_pod(self, key: str) -> Optional[WaitingPod]:
        with self._waiting_lock:
            return self._waiting_pods.get(key)

    def iterate_waiting_pods(self) -> List[WaitingPod]:
        with self._waiting_lock:
            return list(self._waiting_pods.values())

    def reject_waiting_pod(self, key: str, plugin_name: str, msg: str) -> bool:
        wp = self.get_waiting_pod(key)
        if wp is None:
            return False
        wp.reject(plugin_name, msg)
        return True

    def run_pre_bind_plugins(self, state: CycleState, pod: Pod, node_name: str) -> Optional[Status]:
        for pl in self.pre_bind_plugins:
            status = pl.pre_bind(state, pod, node_name)
            if not fwk.is_success(status):
                return Status(Code.ERROR, [f"running PreBind plugin {pl.name!r}: {status.message()}"])
        return None

    def run_bind_plugins(self, state: CycleState, pod: Pod, node_name: str) -> Optional[Status]:
        if not self.bind_plugins:
            return Status(Code.ERROR, ["no bind plugin configured"])
        for pl in self.bind_plugins:
            status = pl.bind(state, pod, node_name)
            if status is not None and status.code == Code.SKIP:
                continue
            if not fwk.is_success(status):
                return Status(Code.ERROR, [f"bind plugin {pl.name!r} failed to bind: {status.message()}"])
            return status
        return None

    def run_post_bind_plugins(self, state: CycleState, pod: Pod, node_name: str) -> None:
        for pl in self.post_bind_plugins:
            pl.post_bind(state, pod, node_name)

    def has_filter_plugins(self) -> bool:
        return bool(self.filter_plugins)

    def has_score_plugins(self) -> bool:
        return bool(self.score_plugins)
