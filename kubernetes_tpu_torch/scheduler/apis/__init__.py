"""Scheduler ComponentConfig (reference: pkg/scheduler/apis/config)."""

from .config import (  # noqa: F401
    Extender,
    KubeSchedulerConfiguration,
    KubeSchedulerProfile,
    Plugin,
    PluginSet,
    Plugins,
    default_configuration,
    load_configuration,
    validate_configuration,
)
