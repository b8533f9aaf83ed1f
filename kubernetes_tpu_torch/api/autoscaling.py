"""autoscaling/v1 HorizontalPodAutoscaler types.

Reference: staging/src/k8s.io/api/autoscaling/v1/types.go —
HorizontalPodAutoscaler (:33) with ScaleTargetRef, Min/MaxReplicas,
TargetCPUUtilizationPercentage; status CurrentReplicas/DesiredReplicas/
CurrentCPUUtilizationPercentage/LastScaleTime.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .types import ObjectMeta


@dataclass
class CrossVersionObjectReference:
    kind: str = ""
    name: str = ""
    api_version: str = ""


@dataclass
class HorizontalPodAutoscalerSpec:
    scale_target_ref: CrossVersionObjectReference = field(
        default_factory=CrossVersionObjectReference
    )
    min_replicas: Optional[int] = None  # default 1
    max_replicas: int = 0
    target_cpu_utilization_percentage: Optional[int] = None  # default 80


@dataclass
class HorizontalPodAutoscalerStatus:
    observed_generation: Optional[int] = None
    last_scale_time: Optional[float] = None
    current_replicas: int = 0
    desired_replicas: int = 0
    current_cpu_utilization_percentage: Optional[int] = None


@dataclass
class HorizontalPodAutoscaler:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: HorizontalPodAutoscalerSpec = field(
        default_factory=HorizontalPodAutoscalerSpec
    )
    status: HorizontalPodAutoscalerStatus = field(
        default_factory=HorizontalPodAutoscalerStatus
    )
    kind: str = "HorizontalPodAutoscaler"
    api_version: str = "autoscaling/v1"
