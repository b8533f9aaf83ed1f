"""Volume subsystem: scheduler volume binder + PV matching.

Reference: pkg/controller/volume/scheduling (SchedulerVolumeBinder),
pkg/controller/volume/persistentvolume (binder controller, index.go
findBestMatchForClaim).
"""

from .binder import (  # noqa: F401
    PodVolumes,
    SchedulerVolumeBinder,
    find_matching_volume,
    pv_matches_claim,
    pv_node_affinity_matches,
)
