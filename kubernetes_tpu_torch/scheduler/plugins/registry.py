"""Default plugin registry and the default algorithm-provider profile.

Reference: pkg/scheduler/framework/plugins/registry.go NewInTreeRegistry and
pkg/scheduler/algorithmprovider/registry.go:71 getDefaultConfig (plugin sets
and score weights of the default profile).

"""

from __future__ import annotations

from ..framework.runtime import Registry
from . import interpodaffinity, nodebasic, noderesources, podtopologyspread


def new_in_tree_registry() -> Registry:
    r = Registry()
    r.register("PrioritySort", lambda a, h: nodebasic.PrioritySort(a, h))
    r.register("NodeResourcesFit", lambda a, h: noderesources.Fit(a, h))
    r.register("NodeResourcesBalancedAllocation", lambda a, h: noderesources.BalancedAllocation(a, h))
    r.register("NodeResourcesLeastAllocated", lambda a, h: noderesources.LeastAllocated(a, h))
    r.register("NodeResourcesMostAllocated", lambda a, h: noderesources.MostAllocated(a, h))
    r.register("RequestedToCapacityRatio", lambda a, h: noderesources.RequestedToCapacityRatio(a, h))
    r.register("NodeName", lambda a, h: nodebasic.NodeName(a, h))
    r.register("NodePorts", lambda a, h: nodebasic.NodePorts(a, h))
    r.register("NodeUnschedulable", lambda a, h: nodebasic.NodeUnschedulable(a, h))
    r.register("TaintToleration", lambda a, h: nodebasic.TaintToleration(a, h))
    r.register("NodeAffinity", lambda a, h: nodebasic.NodeAffinity(a, h))
    r.register("ImageLocality", lambda a, h: nodebasic.ImageLocality(a, h))
    r.register("NodePreferAvoidPods", lambda a, h: nodebasic.NodePreferAvoidPods(a, h))
    r.register("PodTopologySpread", lambda a, h: podtopologyspread.PodTopologySpread(a, h))
    r.register("InterPodAffinity", lambda a, h: interpodaffinity.InterPodAffinity(a, h))
    r.register("DefaultBinder", lambda a, h: nodebasic.DefaultBinder(a, h))
    from .coscheduling import Coscheduling
    from .defaultpreemption import DefaultPreemption

    r.register("DefaultPreemption", lambda a, h: DefaultPreemption(a, h))
    r.register("Coscheduling", lambda a, h: Coscheduling(a, h))
    from .nodelabel import NodeLabel
    from .selectorspread import SelectorSpread
    from .serviceaffinity import ServiceAffinity

    r.register("SelectorSpread", lambda a, h: SelectorSpread(a, h))
    r.register("NodeLabel", lambda a, h: NodeLabel(a, h))
    r.register("ServiceAffinity", lambda a, h: ServiceAffinity(a, h))
    from .volumebinding import VolumeBinding
    from .volumes import NodeVolumeLimits, VolumeRestrictions, VolumeZone

    r.register("VolumeBinding", lambda a, h: VolumeBinding(a, h))
    r.register("VolumeRestrictions", lambda a, h: VolumeRestrictions(a, h))
    r.register("VolumeZone", lambda a, h: VolumeZone(a, h))
    r.register("NodeVolumeLimits", lambda a, h: NodeVolumeLimits(a, h))
    # In-tree per-cloud limit plugins share the CSI-translated counting
    # path (nodevolumelimits/non_csi.go), each scoped to its own driver.
    for name, driver in (
        ("EBSLimits", "ebs.csi.aws.com"),
        ("GCEPDLimits", "pd.csi.storage.gke.io"),
        ("AzureDiskLimits", "disk.csi.azure.com"),
    ):
        cls = type(name, (NodeVolumeLimits,), {"name": name, "only_driver": driver})
        r.register(name, (lambda c: lambda a, h: c(a, h))(cls))
    return r


def default_plugins() -> dict:
    """algorithmprovider/registry.go:71-148 getDefaultConfig, as the
    framework's {extension point: [(name, weight)]} map."""
    return {
        "queueSort": [("PrioritySort", 1)],
        "preFilter": [
            ("NodeResourcesFit", 1),
            ("NodePorts", 1),
            ("PodTopologySpread", 1),
            ("InterPodAffinity", 1),
            ("VolumeBinding", 1),
            # TPU-build deviation: these precompute their per-pod state in
            # PreFilter so Filter is per-node work only (the reference
            # recomputes inside Filter, csi.go/volume_zone.go)
            ("VolumeZone", 1),
            ("NodeVolumeLimits", 1),
            ("EBSLimits", 1),
            ("GCEPDLimits", 1),
            ("AzureDiskLimits", 1),
        ],
        "filter": [
            ("NodeUnschedulable", 1),
            ("NodeName", 1),
            ("TaintToleration", 1),
            ("NodeAffinity", 1),
            ("NodePorts", 1),
            ("NodeResourcesFit", 1),
            ("VolumeRestrictions", 1),
            ("EBSLimits", 1),
            ("GCEPDLimits", 1),
            ("NodeVolumeLimits", 1),
            ("AzureDiskLimits", 1),
            ("VolumeBinding", 1),
            ("VolumeZone", 1),
            ("PodTopologySpread", 1),
            ("InterPodAffinity", 1),
        ],
        "postFilter": [("DefaultPreemption", 1)],
        "preScore": [
            ("InterPodAffinity", 1),
            ("PodTopologySpread", 1),
            ("TaintToleration", 1),
            ("NodeAffinity", 1),
        ],
        "score": [
            ("NodeResourcesBalancedAllocation", 1),
            ("ImageLocality", 1),
            ("InterPodAffinity", 1),
            ("NodeResourcesLeastAllocated", 1),
            ("NodeAffinity", 1),
            ("NodePreferAvoidPods", 10000),
            ("PodTopologySpread", 2),
            ("TaintToleration", 1),
        ],
        "reserve": [("VolumeBinding", 1)],
        "preBind": [("VolumeBinding", 1)],
        "bind": [("DefaultBinder", 1)],
    }


def default_plugins_without(*names: str) -> dict:
    cfg = default_plugins()
    return {
        point: [(n, w) for n, w in plugins if n not in names]
        for point, plugins in cfg.items()
    }
