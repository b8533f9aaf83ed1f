"""Scheduler assembly from KubeSchedulerConfiguration.

Reference: pkg/scheduler/factory.go:90 create — config profiles →
framework instances, extender configs → HTTPExtenders, queue/backoff
knobs → PriorityQueue; cmd/kube-scheduler/app/server.go:299 Setup.

Port of kubernetes_tpu/scheduler/factory.py. The backend it builds runs
on `device` (the card unless the caller names another); a profile's
meshDevices raises NotImplementedError, since the sharded session is not
ported yet (ROADMAP.md, Queue 1, item 9).
"""

from __future__ import annotations

from typing import Optional

from ..client.clientset import Clientset
from ..client.informer import SharedInformerFactory
from .apis.config import (
    ConfigError,
    KubeSchedulerConfiguration,
    default_configuration,
    merged_plugins_for_profile,
    validate_configuration,
)
from .extender import HTTPExtender
from .framework.runtime import Framework
from .plugins.registry import new_in_tree_registry
from .scheduler import Scheduler
from .tpu_backend import TPUBackend
from ..volume.binder import SchedulerVolumeBinder

# score plugin name -> kernel weight key (ops/kernel.py DEFAULT_WEIGHTS)
_KERNEL_WEIGHT_KEYS = {
    "NodeResourcesBalancedAllocation": "balanced",
    "ImageLocality": "image",
    "InterPodAffinity": "ipa",
    "NodeResourcesLeastAllocated": "least",
    "NodeAffinity": "node_affinity",
    "NodePreferAvoidPods": "prefer_avoid",
    "PodTopologySpread": "pts",
    "TaintToleration": "taint",
}


def create_scheduler(
    clientset: Clientset,
    informer_factory: SharedInformerFactory,
    cfg: Optional[KubeSchedulerConfiguration] = None,
    profile_name: Optional[str] = None,
    registry=None,
    device=None,
) -> Scheduler:
    cfg = cfg or default_configuration()
    validate_configuration(cfg)
    if profile_name is None:
        profile = cfg.profiles[0]
    else:
        by_name = {p.scheduler_name: p for p in cfg.profiles}
        if profile_name not in by_name:
            raise ConfigError(f"no profile named {profile_name!r}")
        profile = by_name[profile_name]
    merged = merged_plugins_for_profile(profile)

    tpu_backend = None
    if profile.backend == "tpu":
        if cfg.extenders:
            raise ConfigError(
                "extenders require the oracle backend (profile backend: oracle)"
            )
        weights = {k: 0 for k in _KERNEL_WEIGHT_KEYS.values()}
        for name, weight in merged.get("score", []):
            key = _KERNEL_WEIGHT_KEYS.get(name)
            if key is None:
                raise ConfigError(
                    f"score plugin {name!r} has no TPU kernel equivalent; "
                    f"use backend: oracle for this profile"
                )
            weights[key] = weight
        if profile.mesh_devices:
            raise NotImplementedError(
                f"meshDevices: {profile.mesh_devices}: the sharded session "
                "is not ported yet (ROADMAP.md, Queue 1, item 9)")
        tpu_backend = TPUBackend(weights=weights, device=device)

    sched = Scheduler(
        clientset,
        informer_factory,
        backend=profile.backend,
        tpu_backend=tpu_backend,
        percentage_of_nodes_to_score=cfg.percentage_of_nodes_to_score,
        max_batch=cfg.max_batch,
        pod_initial_backoff=cfg.pod_initial_backoff_seconds,
        pod_max_backoff=cfg.pod_max_backoff_seconds,
        extenders=[HTTPExtender(e) for e in cfg.extenders],
        parallelism=cfg.parallelism,
    )
    # Volume subsystem wiring: informer-cache listers + API client for the
    # binder (volume_binding.go New → SchedulerVolumeBinder).
    pvc_inf = informer_factory.informer_for("persistentvolumeclaims")
    pv_inf = informer_factory.informer_for("persistentvolumes")
    sc_inf = informer_factory.informer_for("storageclasses")
    csi_inf = informer_factory.informer_for("csinodes")
    # Spread/service-affinity informers only when a profile plugin consumes
    # them (the default profile doesn't); created eagerly — BEFORE
    # informer_factory.start() — because a lazily-created informer would
    # never be started.
    enabled_names = {n for entries in merged.values() for n, _ in entries}
    spread_listers = None
    service_lister = None
    if enabled_names & {"SelectorSpread", "ServiceAffinity"}:
        svc_inf = informer_factory.informer_for("services")
        rc_inf = informer_factory.informer_for("replicationcontrollers")
        rs_inf = informer_factory.informer_for("replicasets")
        ss_inf = informer_factory.informer_for("statefulsets")
        service_lister = svc_inf.list
        spread_listers = (
            lambda: (svc_inf.list(), rc_inf.list(), rs_inf.list(), ss_inf.list())
        )
    volume_binder = SchedulerVolumeBinder(
        list_pvcs=pvc_inf.list,
        list_pvs=pv_inf.list,
        list_storage_classes=sc_inf.list,
        client=clientset,
        get_pvc=pvc_inf.get,
    )
    framework = Framework(
        registry or new_in_tree_registry(),
        profile_name=profile.scheduler_name,
        plugins=merged,
        plugin_config=profile.plugin_config,
        snapshot_fn=lambda: sched.snapshot,
        parallelism=cfg.parallelism,
        handle_extras={
            "volume_binder": volume_binder,
            "volume_listers": (pvc_inf.list, pv_inf.list),
            "csi_node_lister": csi_inf.list,
            "client": clientset,
            "service_lister": service_lister,
            "spread_listers": spread_listers,
        },
    )
    framework.nominator = sched.nominator
    framework.pdb_lister = sched._list_pdbs
    framework.cache = sched.cache
    sched.framework = framework
    sched.profile_name = profile.scheduler_name
    return sched
