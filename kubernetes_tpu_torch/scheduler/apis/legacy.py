"""Legacy Policy API: JSON predicates/priorities mapped onto plugins.

Reference: pkg/scheduler/apis/config/legacy_types.go:26 Policy and
pkg/scheduler/framework/plugins/legacy_registry.go — each legacy
predicate/priority name maps to modern plugin registrations at the
correct extension points; custom predicates (CheckNodeLabelPresence,
TestServiceAffinity) carry typed arguments that become plugin args.

`policy_to_profile` produces a KubeSchedulerProfile whose plugins REPLACE
the default sets ('*' disabled + explicit enables), matching
factory.go:207 createFromConfig semantics: a Policy fully determines the
predicate/priority sets.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .config import ConfigError, KubeSchedulerProfile, Plugin, Plugins

# legacy predicate name -> [(extension point, plugin name)]
# (legacy_registry.go NewLegacyRegistry predicate mappings)
PREDICATE_TO_PLUGIN: Dict[str, List[Tuple[str, str]]] = {
    "PodFitsResources": [("preFilter", "NodeResourcesFit"), ("filter", "NodeResourcesFit")],
    "PodFitsHostPorts": [("preFilter", "NodePorts"), ("filter", "NodePorts")],
    "HostName": [("filter", "NodeName")],
    "MatchNodeSelector": [("filter", "NodeAffinity")],
    "NoDiskConflict": [("filter", "VolumeRestrictions")],
    "NoVolumeZoneConflict": [("preFilter", "VolumeZone"), ("filter", "VolumeZone")],
    "MaxCSIVolumeCountPred": [("preFilter", "NodeVolumeLimits"), ("filter", "NodeVolumeLimits")],
    "MaxEBSVolumeCount": [("preFilter", "EBSLimits"), ("filter", "EBSLimits")],
    "MaxGCEPDVolumeCount": [("preFilter", "GCEPDLimits"), ("filter", "GCEPDLimits")],
    "MaxAzureDiskVolumeCount": [("preFilter", "AzureDiskLimits"), ("filter", "AzureDiskLimits")],
    "CheckNodeUnschedulable": [("filter", "NodeUnschedulable")],
    "PodToleratesNodeTaints": [("filter", "TaintToleration")],
    "MatchInterPodAffinity": [("preFilter", "InterPodAffinity"), ("filter", "InterPodAffinity")],
    "EvenPodsSpread": [("preFilter", "PodTopologySpread"), ("filter", "PodTopologySpread")],
    "CheckVolumeBinding": [
        ("preFilter", "VolumeBinding"),
        ("filter", "VolumeBinding"),
        ("reserve", "VolumeBinding"),
        ("preBind", "VolumeBinding"),
    ],
    "CheckNodeLabelPresence": [("filter", "NodeLabel")],
    "TestServiceAffinity": [("preFilter", "ServiceAffinity"), ("filter", "ServiceAffinity")],
}

# legacy priority name -> [(extension point, plugin name)]
PRIORITY_TO_PLUGIN: Dict[str, List[Tuple[str, str]]] = {
    "LeastRequestedPriority": [("score", "NodeResourcesLeastAllocated")],
    "MostRequestedPriority": [("score", "NodeResourcesMostAllocated")],
    "BalancedResourceAllocation": [("score", "NodeResourcesBalancedAllocation")],
    "RequestedToCapacityRatioPriority": [("score", "RequestedToCapacityRatio")],
    "SelectorSpreadPriority": [("preScore", "SelectorSpread"), ("score", "SelectorSpread")],
    "ServiceSpreadingPriority": [("preScore", "SelectorSpread"), ("score", "SelectorSpread")],
    "NodeAffinityPriority": [("preScore", "NodeAffinity"), ("score", "NodeAffinity")],
    "TaintTolerationPriority": [("preScore", "TaintToleration"), ("score", "TaintToleration")],
    "InterPodAffinityPriority": [("preScore", "InterPodAffinity"), ("score", "InterPodAffinity")],
    "EvenPodsSpreadPriority": [("preScore", "PodTopologySpread"), ("score", "PodTopologySpread")],
    "ImageLocalityPriority": [("score", "ImageLocality")],
    "NodePreferAvoidPodsPriority": [("score", "NodePreferAvoidPods")],
    "NodeLabelPriority": [("score", "NodeLabel")],
    "ServiceAntiAffinityPriority": [("preScore", "ServiceAffinity"), ("score", "ServiceAffinity")],
}

# always-on plugins regardless of Policy content (createFromConfig keeps
# QueueSort/Bind/PostFilter wiring)
_MANDATORY = {
    "queueSort": [("PrioritySort", 1)],
    "postFilter": [("DefaultPreemption", 1)],
    "bind": [("DefaultBinder", 1)],
}


def policy_to_profile(policy: dict, backend: str = "oracle") -> KubeSchedulerProfile:
    """Parse a legacy Policy dict (the JSON/ConfigMap format) into a
    profile with fully-specified plugin sets."""
    if policy.get("kind") not in (None, "Policy"):
        raise ConfigError(f"not a Policy: kind={policy.get('kind')!r}")
    points: Dict[str, List[Tuple[str, int]]] = {k: list(v) for k, v in _MANDATORY.items()}
    plugin_config: Dict[str, dict] = {}

    def add(point: str, name: str, weight: int = 1) -> None:
        cur = points.setdefault(point, [])
        for i, (n, w) in enumerate(cur):
            if n == name:
                if point == "score":
                    # two legacy priorities mapping to one plugin sum their
                    # weights (legacy_registry.go ProcessPriorityPolicy)
                    cur[i] = (n, w + weight)
                return
        cur.append((name, weight))

    for pred in policy.get("predicates", []) or []:
        name = pred.get("name", "")
        arg = pred.get("argument") or {}
        if name not in PREDICATE_TO_PLUGIN:
            raise ConfigError(f"unknown predicate {name!r}")
        for point, plugin in PREDICATE_TO_PLUGIN[name]:
            add(point, plugin)
        if name == "CheckNodeLabelPresence" and "labelsPresence" in arg:
            lp = arg["labelsPresence"]
            key = "presentLabels" if lp.get("presence", True) else "absentLabels"
            cfg = plugin_config.setdefault("NodeLabel", {})
            cfg.setdefault(key, []).extend(lp.get("labels", []))
        if name == "TestServiceAffinity" and "serviceAffinity" in arg:
            cfg = plugin_config.setdefault("ServiceAffinity", {})
            cfg.setdefault("affinityLabels", []).extend(
                arg["serviceAffinity"].get("labels", [])
            )

    for prio in policy.get("priorities", []) or []:
        name = prio.get("name", "")
        weight = int(prio.get("weight", 1))
        arg = prio.get("argument") or {}
        if name not in PRIORITY_TO_PLUGIN:
            raise ConfigError(f"unknown priority {name!r}")
        for point, plugin in PRIORITY_TO_PLUGIN[name]:
            add(point, plugin, weight if point == "score" else 1)
        if name == "NodeLabelPriority" and "labelPreference" in arg:
            lp = arg["labelPreference"]
            key = (
                "presentLabelsPreference"
                if lp.get("presence", True)
                else "absentLabelsPreference"
            )
            cfg = plugin_config.setdefault("NodeLabel", {})
            cfg.setdefault(key, []).extend(lp.get("labels", []))
        if name == "ServiceAntiAffinityPriority" and "serviceAntiAffinity" in arg:
            cfg = plugin_config.setdefault("ServiceAffinity", {})
            cfg.setdefault("antiAffinityLabelsPreference", []).append(
                arg["serviceAntiAffinity"].get("label", "")
            )

    # build a Plugins override: disable '*' then enable exactly `points`
    plugins = Plugins()
    for point, entries in points.items():
        ps = plugins.point(point)
        ps.disabled.append(Plugin("*", 0))
        for name, weight in entries:
            ps.enabled.append(Plugin(name, weight))
    # clear extension points the Policy doesn't populate
    for point in Plugins._FIELD_OF_POINT:
        if point not in points:
            plugins.point(point).disabled.append(Plugin("*", 0))
    return KubeSchedulerProfile(
        scheduler_name=policy.get("schedulerName", "default-scheduler"),
        plugins=plugins,
        plugin_config=plugin_config,
        backend=backend,
    )
