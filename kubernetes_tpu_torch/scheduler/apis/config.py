"""KubeSchedulerConfiguration: the typed config that assembles a scheduler.

Reference: pkg/scheduler/apis/config/types.go:49 KubeSchedulerConfiguration
(Parallelism, PercentageOfNodesToScore, PodInitialBackoffSeconds,
PodMaxBackoffSeconds, Profiles, Extenders), :109 KubeSchedulerProfile,
:170 Plugins / :200 PluginSet / :219 Plugin, :336 Extender; defaulting
pkg/scheduler/apis/config/v1beta1/defaults.go; validation
pkg/scheduler/apis/config/validation/validation.go.

The TPU backend is selected exactly the way the reference selects custom
behavior — through the config surface: a profile-level `backend: tpu`
field (our one extension; the reference's analog is a PluginConfig args
object or an Extenders entry, SURVEY.md §5 config system). Enabled/
disabled plugin merging follows the v1beta1 rules: profile plugins extend
the defaults; a Disabled entry of "*" wipes the point's defaults first.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..plugins.registry import default_plugins

DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE = 0  # adaptive (types.go:240)


@dataclass
class Plugin:
    name: str = ""
    weight: int = 0


@dataclass
class PluginSet:
    enabled: List[Plugin] = field(default_factory=list)
    disabled: List[Plugin] = field(default_factory=list)


EXTENSION_POINTS = (
    "queueSort", "preFilter", "filter", "postFilter", "preScore", "score",
    "reserve", "permit", "preBind", "bind", "postBind",
)


@dataclass
class Plugins:
    queue_sort: PluginSet = field(default_factory=PluginSet)
    pre_filter: PluginSet = field(default_factory=PluginSet)
    filter: PluginSet = field(default_factory=PluginSet)
    post_filter: PluginSet = field(default_factory=PluginSet)
    pre_score: PluginSet = field(default_factory=PluginSet)
    score: PluginSet = field(default_factory=PluginSet)
    reserve: PluginSet = field(default_factory=PluginSet)
    permit: PluginSet = field(default_factory=PluginSet)
    pre_bind: PluginSet = field(default_factory=PluginSet)
    bind: PluginSet = field(default_factory=PluginSet)
    post_bind: PluginSet = field(default_factory=PluginSet)

    _FIELD_OF_POINT = {
        "queueSort": "queue_sort", "preFilter": "pre_filter", "filter": "filter",
        "postFilter": "post_filter", "preScore": "pre_score", "score": "score",
        "reserve": "reserve", "permit": "permit", "preBind": "pre_bind",
        "bind": "bind", "postBind": "post_bind",
    }

    def point(self, name: str) -> PluginSet:
        return getattr(self, self._FIELD_OF_POINT[name])


@dataclass
class KubeSchedulerProfile:
    scheduler_name: str = "default-scheduler"
    plugins: Optional[Plugins] = None
    plugin_config: Dict[str, dict] = field(default_factory=dict)
    backend: str = "tpu"  # tpu | oracle (the TPU build's selector)
    # multi-chip: shard the node axis over the first N devices as a
    # jax.sharding.Mesh (0 = single device). The analog of the
    # reference's `parallelism` knob, pointed at chips instead of
    # goroutines (parallel/sharded.py).
    mesh_devices: int = 0


@dataclass
class Extender:
    """types.go:336 Extender (the HTTP webhook config)."""

    url_prefix: str = ""
    filter_verb: str = ""
    preempt_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    weight: int = 1
    enable_https: bool = False
    http_timeout_seconds: float = 30.0
    node_cache_capable: bool = False
    ignorable: bool = False
    managed_resources: List[str] = field(default_factory=list)


@dataclass
class KubeSchedulerConfiguration:
    parallelism: int = 16
    percentage_of_nodes_to_score: int = DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE
    pod_initial_backoff_seconds: float = 1.0
    pod_max_backoff_seconds: float = 10.0
    profiles: List[KubeSchedulerProfile] = field(default_factory=list)
    extenders: List[Extender] = field(default_factory=list)
    max_batch: int = 128  # TPU scan-batch width (TPU-build extension)


def default_configuration() -> KubeSchedulerConfiguration:
    """defaults.go: one default profile, adaptive scoring percentage."""
    return KubeSchedulerConfiguration(profiles=[KubeSchedulerProfile()])


def gang_configuration(
    permit_timeout: float = 60.0,
) -> KubeSchedulerConfiguration:
    """The default profile plus the Coscheduling gang gate, enabled at
    BOTH of its extension points (Permit gates the wave, Reserve indexes
    members into it) — the config-surface analog of the perf harness's
    gang_size wiring, for clusters (drills, soaks) built through
    `Cluster(scheduler_config=...)`."""
    plugins = Plugins()
    plugins.permit.enabled.append(Plugin("Coscheduling", 1))
    plugins.reserve.enabled.append(Plugin("Coscheduling", 1))
    profile = KubeSchedulerProfile(
        plugins=plugins,
        plugin_config={
            "Coscheduling": {"permit_timeout_seconds": permit_timeout}
        },
    )
    return KubeSchedulerConfiguration(profiles=[profile])


# -- plugin merge (v1beta1 mergePlugins semantics) --------------------------


def merged_plugins_for_profile(
    profile: KubeSchedulerProfile,
) -> Dict[str, List[Tuple[str, int]]]:
    """Defaults + profile's Enabled minus Disabled ('*' clears the point).

    Returns the framework's {point: [(name, weight)]} map."""
    merged = {k: list(v) for k, v in default_plugins().items()}
    if profile.plugins is None:
        return merged
    for point in EXTENSION_POINTS:
        ps = profile.plugins.point(point)
        current = merged.get(point, [])
        disabled_names = {p.name for p in ps.disabled}
        if "*" in disabled_names:
            current = []
        else:
            current = [(n, w) for n, w in current if n not in disabled_names]
        for p in ps.enabled:
            weight = p.weight if p.weight else 1
            current = [(n, w) for n, w in current if n != p.name]
            current.append((p.name, weight))
        merged[point] = current
    return merged


# -- validation (validation.go) ---------------------------------------------


class ConfigError(ValueError):
    pass


def validate_configuration(cfg: KubeSchedulerConfiguration) -> None:
    if cfg.parallelism <= 0:
        raise ConfigError("parallelism must be greater than 0")
    if not (0 <= cfg.percentage_of_nodes_to_score <= 100):
        raise ConfigError("percentageOfNodesToScore must be in [0, 100]")
    if cfg.pod_initial_backoff_seconds <= 0:
        raise ConfigError("podInitialBackoffSeconds must be greater than 0")
    if cfg.pod_max_backoff_seconds < cfg.pod_initial_backoff_seconds:
        raise ConfigError("podMaxBackoffSeconds must be >= podInitialBackoffSeconds")
    if not cfg.profiles:
        raise ConfigError("at least one profile is required")
    names = [p.scheduler_name for p in cfg.profiles]
    if len(set(names)) != len(names):
        raise ConfigError(f"duplicate profile schedulerName in {names}")
    for profile in cfg.profiles:
        if not profile.scheduler_name:
            raise ConfigError("schedulerName is required")
        if profile.backend not in ("tpu", "oracle"):
            raise ConfigError(f"unknown backend {profile.backend!r}")
        if profile.mesh_devices < 0:
            raise ConfigError("meshDevices must be >= 0")
        if profile.mesh_devices and profile.backend != "tpu":
            raise ConfigError("meshDevices requires the tpu backend")
        merged = merged_plugins_for_profile(profile)
        for name, weight in merged.get("score", []):
            if weight < 0:
                raise ConfigError(f"score plugin {name}: weight must be >= 0")
        if len(merged.get("queueSort", [])) != 1:
            raise ConfigError("exactly one queueSort plugin is required")
        if not merged.get("bind"):
            raise ConfigError("at least one bind plugin is required")
    for ext in cfg.extenders:
        if not ext.url_prefix:
            raise ConfigError("extender urlPrefix is required")
        if ext.weight <= 0:
            raise ConfigError("extender weight must be positive")


# -- loading ----------------------------------------------------------------


def _from_camel(d: dict, keymap: Dict[str, str]) -> dict:
    return {keymap.get(k, k): v for k, v in d.items()}


def load_configuration(text: str) -> KubeSchedulerConfiguration:
    """Parse YAML/JSON config (the --config file). Shape follows
    kube-scheduler's v1beta1 wire format (camelCase keys)."""
    try:
        import yaml  # type: ignore

        data = yaml.safe_load(text)
    except ImportError:
        data = json.loads(text)
    if not isinstance(data, dict):
        raise ConfigError("config root must be a mapping")
    cfg = KubeSchedulerConfiguration()
    cfg.parallelism = data.get("parallelism", cfg.parallelism)
    cfg.percentage_of_nodes_to_score = data.get(
        "percentageOfNodesToScore", cfg.percentage_of_nodes_to_score
    )
    cfg.pod_initial_backoff_seconds = data.get(
        "podInitialBackoffSeconds", cfg.pod_initial_backoff_seconds
    )
    cfg.pod_max_backoff_seconds = data.get(
        "podMaxBackoffSeconds", cfg.pod_max_backoff_seconds
    )
    cfg.max_batch = data.get("maxBatch", cfg.max_batch)
    for pd in data.get("profiles", []) or []:
        profile = KubeSchedulerProfile(
            scheduler_name=pd.get("schedulerName", "default-scheduler"),
            backend=pd.get("backend", "tpu"),
            mesh_devices=pd.get("meshDevices", 0),
        )
        if "plugins" in pd and pd["plugins"]:
            plugins = Plugins()
            for point, body in pd["plugins"].items():
                if point not in Plugins._FIELD_OF_POINT:
                    raise ConfigError(f"unknown extension point {point!r}")
                ps = plugins.point(point)
                for e in body.get("enabled", []) or []:
                    ps.enabled.append(Plugin(e["name"], e.get("weight", 0)))
                for e in body.get("disabled", []) or []:
                    ps.disabled.append(Plugin(e["name"], e.get("weight", 0)))
            profile.plugins = plugins
        for pc in pd.get("pluginConfig", []) or []:
            profile.plugin_config[pc["name"]] = pc.get("args", {})
        cfg.profiles.append(profile)
    if not cfg.profiles:
        cfg.profiles = [KubeSchedulerProfile()]
    for ed in data.get("extenders", []) or []:
        cfg.extenders.append(
            Extender(
                url_prefix=ed.get("urlPrefix", ""),
                filter_verb=ed.get("filterVerb", ""),
                preempt_verb=ed.get("preemptVerb", ""),
                prioritize_verb=ed.get("prioritizeVerb", ""),
                bind_verb=ed.get("bindVerb", ""),
                weight=ed.get("weight", 1),
                enable_https=ed.get("enableHTTPS", False),
                http_timeout_seconds=ed.get("httpTimeout", 30.0),
                node_cache_capable=ed.get("nodeCacheCapable", False),
                ignorable=ed.get("ignorable", False),
                managed_resources=[
                    r.get("name", "") for r in ed.get("managedResources", []) or []
                ],
            )
        )
    validate_configuration(cfg)
    return cfg
