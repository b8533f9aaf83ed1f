"""Kubelet container-manager subsystems: checkpointing, device plugins,
CPU manager state, pod-resources API.

Reference frame:
- CheckpointManager: pkg/kubelet/checkpointmanager/checkpoint_manager.go
  (CRC-checksummed files, atomic write, CorruptCheckpointError on
  mismatch; checksum/checksum.go).
- DeviceManager: pkg/kubelet/cm/devicemanager/manager.go (plugin
  Registration + ListAndWatch + Allocate; GetCapacity's
  capacity/allocatable/deleted-resources triple; podDevices checkpointed
  via checkpoint/checkpoint.go so allocations survive kubelet restart).
- CPUManager static policy state: pkg/kubelet/cm/cpumanager/{policy_static,
  state/state_checkpoint}.go (integral-CPU Guaranteed containers get
  exclusive cpusets carved from the shared pool; state checkpointed).
- PodResourcesServer: staging/src/k8s.io/kubelet/pkg/apis/podresources
  (List() -> per-pod per-container device + cpuset assignments).

The transport in the reference is gRPC over unix sockets; in this build
plugins and the pod-resources API are in-proc objects with the same
message shapes and the same state machines (the process boundary is not
where the behavior lives).
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api import types as v1
from ..api.quantity import Quantity


class CorruptCheckpointError(Exception):
    """Checksum mismatch (checkpoint_manager.go ErrCorruptCheckpoint)."""


class CheckpointManager:
    """Directory of checksummed checkpoint files.

    File format: one JSON object {"data": <payload>, "checksum": <crc32>}
    where the checksum covers the canonical (sorted-key, compact) JSON of
    the payload — the same shape as the reference's Checkpoint interface
    (MarshalCheckpoint + VerifyChecksum, checkpoint_manager.go:40-60).
    Writes are atomic (tmp file + rename) so a crash mid-write leaves the
    previous checkpoint intact.
    """

    def __init__(self, directory: str):
        self._dir = directory
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    @staticmethod
    def _checksum(data) -> int:
        canon = json.dumps(data, sort_keys=True, separators=(",", ":"))
        return zlib.crc32(canon.encode()) & 0xFFFFFFFF

    def _path(self, name: str) -> str:
        assert "/" not in name
        return os.path.join(self._dir, name)

    def create_checkpoint(self, name: str, data) -> None:
        blob = json.dumps({"data": data, "checksum": self._checksum(data)})
        tmp = self._path(name) + ".tmp"
        with self._lock:
            with open(tmp, "w") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(name))

    def get_checkpoint(self, name: str):
        """Returns the payload, or raises FileNotFoundError /
        CorruptCheckpointError."""
        with self._lock:
            with open(self._path(name)) as f:
                raw = f.read()
        try:
            obj = json.loads(raw)
            data, checksum = obj["data"], obj["checksum"]
        except (json.JSONDecodeError, KeyError, TypeError) as e:
            raise CorruptCheckpointError(name) from e
        if self._checksum(data) != checksum:
            raise CorruptCheckpointError(name)
        return data

    def remove_checkpoint(self, name: str) -> None:
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            pass

    def list_checkpoints(self) -> List[str]:
        return sorted(
            f for f in os.listdir(self._dir) if not f.endswith(".tmp")
        )


# ---------------------------------------------------------------------------
# device plugins


@dataclass
class Device:
    """api.proto Device: id + health."""

    id: str
    healthy: bool = True


@dataclass
class AllocateResponse:
    """Subset of api.proto ContainerAllocateResponse the kubelet records."""

    envs: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)


class DevicePlugin:
    """In-proc stand-in for one registered device plugin endpoint.

    The reference plugin serves Registration + ListAndWatch + Allocate
    over a unix socket (api.proto); here the manager calls these methods
    directly and the plugin pushes device-list updates through the
    listener the manager installs (the ListAndWatch stream).
    """

    def __init__(self, resource_name: str, devices: List[Device]):
        assert "/" in resource_name, "extended resources are domain/name"
        self.resource_name = resource_name
        self._devices = {d.id: d for d in devices}
        self._listener: Optional[Callable[[List[Device]], None]] = None
        self._lock = threading.Lock()

    # Registration + ListAndWatch
    def connect(self, listener: Callable[[List[Device]], None]) -> None:
        with self._lock:
            self._listener = listener
            devices = list(self._devices.values())
        listener(devices)

    def set_health(self, device_id: str, healthy: bool) -> None:
        """Device health flip mid-stream (ListAndWatch update)."""
        with self._lock:
            self._devices[device_id].healthy = healthy
            listener = self._listener
            devices = list(self._devices.values())
        if listener:
            listener(devices)

    # Allocate
    def allocate(self, device_ids: List[str]) -> AllocateResponse:
        return AllocateResponse(
            envs={f"DEVICE_{i}": d for i, d in enumerate(sorted(device_ids))}
        )


class AdmissionError(Exception):
    """Pod cannot be admitted (UnexpectedAdmissionError in the reference's
    kubelet admit handler when Allocate fails)."""


class DeviceManager:
    """Tracks plugin-provided extended resources and allocates devices to
    containers with checkpointed assignments (devicemanager/manager.go).
    """

    CHECKPOINT = "kubelet_internal_checkpoint"  # manager.go kubeletDeviceManagerCheckpoint

    def __init__(self, checkpoint_manager: Optional[CheckpointManager] = None):
        self._plugins: Dict[str, DevicePlugin] = {}
        self._devices: Dict[str, Dict[str, Device]] = {}  # resource -> id -> Device
        # pod uid -> container -> resource -> [device ids]
        self._pod_devices: Dict[str, Dict[str, Dict[str, List[str]]]] = {}
        self._stale: Set[str] = set()  # resources whose plugin went away
        # resources already torn down but still reported in `removed` on
        # EVERY get_capacity until the plugin re-registers: the signal is
        # idempotent, so a caller that discards it (or whose node-status
        # write fails) gets it again next period
        self._removed: Set[str] = set()
        self._lock = threading.Lock()
        self._ckpt = checkpoint_manager
        if self._ckpt is not None:
            self._restore()

    # -- registration / ListAndWatch ---------------------------------------

    def register_plugin(self, plugin: DevicePlugin) -> None:
        res = plugin.resource_name
        with self._lock:
            self._plugins[res] = plugin
            self._stale.discard(res)
            self._removed.discard(res)
        plugin.connect(lambda devices, r=res: self._update_devices(r, devices))

    def unregister_plugin(self, resource_name: str) -> None:
        """Endpoint gone: devices stay visible in capacity as a deleted
        resource until GetCapacity reports them removed (manager.go
        markResourceUnhealthy + GetCapacity deletedResources)."""
        with self._lock:
            self._plugins.pop(resource_name, None)
            self._stale.add(resource_name)

    def _update_devices(self, resource: str, devices: List[Device]) -> None:
        with self._lock:
            self._devices[resource] = {
                d.id: Device(d.id, d.healthy) for d in devices
            }
        self._write_checkpoint()

    # -- capacity ----------------------------------------------------------

    def get_capacity(self) -> Tuple[Dict[str, str], Dict[str, str], List[str]]:
        """(capacity, allocatable, removed-resources). Allocatable counts
        only healthy devices; a resource whose plugin unregistered is
        returned in removed so node status drops it."""
        capacity: Dict[str, str] = {}
        allocatable: Dict[str, str] = {}
        with self._lock:
            for res, devs in list(self._devices.items()):
                if res in self._stale:
                    del self._devices[res]
                    self._removed.add(res)
                    continue
                capacity[res] = str(len(devs))
                allocatable[res] = str(sum(1 for d in devs.values() if d.healthy))
            self._stale.clear()
            removed = sorted(self._removed)
        return capacity, allocatable, removed

    # -- allocation --------------------------------------------------------

    def _allocated_ids(self, resource: str) -> Set[str]:
        out: Set[str] = set()
        for containers in self._pod_devices.values():
            for resources in containers.values():
                out.update(resources.get(resource, []))
        return out

    def allocate(self, pod: v1.Pod) -> Dict[str, AllocateResponse]:
        """Admit-time allocation for every container's plugin resources
        (manager.go Allocate). Idempotent per pod uid. Returns
        container -> AllocateResponse. Raises AdmissionError when healthy
        unallocated devices are insufficient."""
        uid = pod.metadata.uid or f"{pod.metadata.namespace}/{pod.metadata.name}"
        responses: Dict[str, AllocateResponse] = {}
        with self._lock:
            if uid in self._pod_devices:
                return {}  # already allocated (restart reconcile)
            pending: Dict[str, Dict[str, List[str]]] = {}
            for c in pod.spec.containers:
                requests = (c.resources and c.resources.requests) or {}
                for res, qty in requests.items():
                    if res not in self._plugins:
                        continue
                    need = Quantity(qty).value()
                    devs = self._devices.get(res, {})
                    taken = self._allocated_ids(res)
                    for cs in pending.values():
                        taken.update(cs.get(res, []))
                    free = sorted(
                        d.id
                        for d in devs.values()
                        if d.healthy and d.id not in taken
                    )
                    if len(free) < need:
                        raise AdmissionError(
                            f"pod {pod.metadata.name}: want {need} {res}, "
                            f"have {len(free)} allocatable"
                        )
                    pending.setdefault(c.name, {})[res] = free[:need]
            if pending:
                self._pod_devices[uid] = pending
        for cname, resources in pending.items():
            merged = AllocateResponse()
            for res, ids in resources.items():
                try:
                    resp = self._plugins[res].allocate(ids)
                except KeyError:
                    # plugin unregistered between reservation and the
                    # Allocate call: undo and reject
                    with self._lock:
                        self._pod_devices.pop(uid, None)
                    raise AdmissionError(f"device plugin for {res} is gone")
                merged.envs.update(resp.envs)
                merged.annotations.update(resp.annotations)
            responses[cname] = merged
        if pending:
            self._write_checkpoint()
        return responses

    def remove_pod(self, uid: str) -> None:
        with self._lock:
            existed = self._pod_devices.pop(uid, None) is not None
        if existed:
            self._write_checkpoint()

    def pod_devices(self, uid: str) -> Dict[str, Dict[str, List[str]]]:
        with self._lock:
            return {
                c: {r: list(ids) for r, ids in rs.items()}
                for c, rs in self._pod_devices.get(uid, {}).items()
            }

    # -- checkpointing ------------------------------------------------------

    def _write_checkpoint(self) -> None:
        if self._ckpt is None:
            return
        with self._lock:
            # snapshot AND persist under the lock: two racing writers
            # releasing between snapshot and write could persist
            # checkpoints out of order, restoring stale allocations after
            # a kubelet restart
            data = {
                "podDeviceEntries": {
                    uid: {
                        c: {r: list(ids) for r, ids in rs.items()}
                        for c, rs in containers.items()
                    }
                    for uid, containers in self._pod_devices.items()
                },
                "registeredDevices": {
                    res: sorted(devs) for res, devs in self._devices.items()
                },
            }
            self._ckpt.create_checkpoint(self.CHECKPOINT, data)

    def _restore(self) -> None:
        try:
            data = self._ckpt.get_checkpoint(self.CHECKPOINT)
        except FileNotFoundError:
            return
        except CorruptCheckpointError:
            # manager.go: corrupt checkpoint -> start clean (the node
            # re-admits; allocations reconcile from the runtime)
            self._ckpt.remove_checkpoint(self.CHECKPOINT)
            return
        with self._lock:
            self._pod_devices = data.get("podDeviceEntries", {})


# ---------------------------------------------------------------------------
# CPU manager (static policy state machine)


class CPUManager:
    """Static-policy cpuset assignment with checkpointed state
    (cpumanager/policy_static.go + state/state_checkpoint.go).

    Guaranteed-QoS containers requesting integral CPUs get exclusive CPUs
    carved from the shared pool; everything else runs on the shared pool.
    """

    CHECKPOINT = "cpu_manager_state"

    def __init__(self, num_cpus: int, checkpoint_manager: Optional[CheckpointManager] = None):
        self._all = list(range(num_cpus))
        # (pod uid, container) -> [cpu ids]
        self._assignments: Dict[str, List[int]] = {}
        self._lock = threading.Lock()
        self._ckpt = checkpoint_manager
        if self._ckpt is not None:
            self._restore()

    @staticmethod
    def _guaranteed_integral_cpus(pod: v1.Pod, c: v1.Container) -> int:
        """policy_static.go guaranteedCPUs: Guaranteed QoS (requests ==
        limits for every resource of every container) + integral cpu."""
        for cc in pod.spec.containers:
            req = (cc.resources and cc.resources.requests) or {}
            lim = (cc.resources and cc.resources.limits) or {}
            if not lim or any(
                Quantity(req.get(r, lim[r])) != Quantity(lim[r]) for r in lim
            ) or set(req) - set(lim):
                return 0
        lim = (c.resources and c.resources.limits) or {}
        if "cpu" not in lim:
            return 0
        q = Quantity(lim["cpu"])
        return q.value() if q.milli_value() % 1000 == 0 else 0

    def _key(self, uid: str, container: str) -> str:
        return f"{uid}/{container}"

    def shared_pool(self) -> List[int]:
        with self._lock:
            taken = {c for cpus in self._assignments.values() for c in cpus}
        return [c for c in self._all if c not in taken]

    def add_container(self, pod: v1.Pod, container_name: str) -> List[int]:
        """Returns the container's cpuset (exclusive or shared pool)."""
        uid = pod.metadata.uid or f"{pod.metadata.namespace}/{pod.metadata.name}"
        spec = next(c for c in pod.spec.containers if c.name == container_name)
        n = self._guaranteed_integral_cpus(pod, spec)
        if n == 0:
            return self.shared_pool()
        key = self._key(uid, container_name)
        with self._lock:
            if key in self._assignments:
                return list(self._assignments[key])
            taken = {c for cpus in self._assignments.values() for c in cpus}
            free = [c for c in self._all if c not in taken]
            if len(free) < n:
                raise AdmissionError(
                    f"container {container_name}: want {n} exclusive CPUs, "
                    f"free pool has {len(free)}"
                )
            self._assignments[key] = free[:n]
        self._write_checkpoint()
        return free[:n]

    def remove_pod(self, uid: str) -> None:
        with self._lock:
            stale = [k for k in self._assignments if k.startswith(uid + "/")]
            for k in stale:
                del self._assignments[k]
        if stale:
            self._write_checkpoint()

    def assignments(self) -> Dict[str, List[int]]:
        with self._lock:
            return {k: list(v) for k, v in self._assignments.items()}

    def _write_checkpoint(self) -> None:
        if self._ckpt is None:
            return
        with self._lock:
            # persist under the lock so racing writers can't commit
            # out-of-order checkpoints (same discipline as DeviceManager)
            data = {
                "entries": {k: list(v) for k, v in self._assignments.items()},
                "policyName": "static",
            }
            self._ckpt.create_checkpoint(self.CHECKPOINT, data)

    def _restore(self) -> None:
        try:
            data = self._ckpt.get_checkpoint(self.CHECKPOINT)
        except FileNotFoundError:
            return
        except CorruptCheckpointError:
            self._ckpt.remove_checkpoint(self.CHECKPOINT)
            return
        with self._lock:
            self._assignments = {
                k: list(v) for k, v in data.get("entries", {}).items()
            }


# ---------------------------------------------------------------------------
# pod-resources API


@dataclass
class ContainerResources:
    name: str
    devices: Dict[str, List[str]]  # resource -> device ids
    cpu_ids: List[int]


@dataclass
class PodResources:
    name: str
    namespace: str
    containers: List[ContainerResources]


class PodResourcesServer:
    """List() over the kubelet's live assignment state
    (podresources/server_v1.go; transport here is a method call)."""

    def __init__(
        self,
        pods_provider: Callable[[], List[v1.Pod]],
        device_manager: Optional[DeviceManager] = None,
        cpu_manager: Optional[CPUManager] = None,
    ):
        self._pods = pods_provider
        self._dm = device_manager
        self._cm = cpu_manager

    def list(self) -> List[PodResources]:
        out = []
        for pod in self._pods():
            uid = pod.metadata.uid or f"{pod.metadata.namespace}/{pod.metadata.name}"
            devs = self._dm.pod_devices(uid) if self._dm else {}
            cpus = self._cm.assignments() if self._cm else {}
            out.append(
                PodResources(
                    name=pod.metadata.name,
                    namespace=pod.metadata.namespace,
                    containers=[
                        ContainerResources(
                            name=c.name,
                            devices=devs.get(c.name, {}),
                            cpu_ids=cpus.get(f"{uid}/{c.name}", []),
                        )
                        for c in pod.spec.containers
                    ],
                )
            )
        return out
