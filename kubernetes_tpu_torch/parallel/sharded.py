"""The node-axis mesh: shards of the cluster's node axis, held by one
process.

Port of kubernetes_tpu/parallel/sharded.py. The reference shards the
node axis of the dense cluster encoding over a jax.sharding.Mesh and
lets GSPMD turn the kernel's node-wide reductions (normalize min/max,
topology-pair counts, the argmax) into collectives. The port's mesh is
single-controller as the reference's is — one scheduler process owns
every shard — but torch has no GSPMD: a `Mesh` is a list of groups,
each a torch device and the number of node-axis shards it holds, in
shard order. Shards on one device form one group and are processed by
one set of torch ops over their concatenated lane range; a shard count
above the device count places several shards on one device (the port's
form of `--xla_force_host_platform_device_count`), and a caller may list
one device in several groups to run the cross-group path on one card.

The mesh's shard count (the reference's `mesh.devices.size`, here
`Mesh.nsh` and `Mesh.devices.size`: one entry per shard) and its device
count (`Mesh.n_devices`) are separate numbers. The exact two-phase
session over a mesh is ops/sharded_scan.py `ShardedScanSession`; the
rest of this module (`shard_cluster`, `ShardedScheduler`) pads the node
axis to the shard multiple and runs the single-device functions on the
mesh's lead device, whose decisions are the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.vocab import node_headroom
from ..ops.kernel import DEFAULT_WEIGHTS, schedule_pod
from ..utils import knobs
from .partition import NODE_AXIS

__all__ = [
    "NODE_AXIS", "NODE_DIM0_KEYS", "Mesh", "MeshGroup", "make_mesh",
    "node_capacity_multiple", "node_headroom", "pad_node_axis",
    "shard_cluster", "replicate_pod", "select", "ShardedScheduler",
]

# Cluster-dict arrays whose dim 0 is the node axis (ClusterEncoding node
# rows). Everything else — pod rows, term tables, vocab-indexed vectors,
# scalars — is replicated.
NODE_DIM0_KEYS = frozenset(
    {
        "valid", "alloc", "requested", "nz_requested", "pod_count",
        "allowed_pods", "unschedulable", "taints", "ports_triple",
        "ports_pair_any", "ports_pair_wild", "npair", "nkey", "pair_of_key",
        "nnum", "nnum_valid", "img_size", "avoid",
    }
)


class MeshGroup:
    """`k` consecutive node-axis shards, from shard `s0`, on `device`."""

    __slots__ = ("device", "k", "s0")

    def __init__(self, device: torch.device, k: int, s0: int):
        self.device, self.k, self.s0 = device, k, s0

    def __repr__(self) -> str:
        last = self.s0 + self.k - 1
        return f"MeshGroup({self.device}, shards {self.s0}..{last})"


class Mesh:
    """A 1-D mesh over the node axis: groups of shards, in shard order.

    `groups` is a sequence of (device, shard count). `nsh` is the shard
    count, `devices` one torch.device per shard (so `devices.size` is the
    shard count, as on a jax mesh), `n_devices` the number of distinct
    devices, and `lead` the first group's device, where cross-group
    reductions meet and the single-device paths run."""

    axis_names = (NODE_AXIS,)

    def __init__(self, groups: Sequence):
        out: List[MeshGroup] = []
        s0 = 0
        for dev, k in groups:
            k = int(k)
            if k < 1:
                raise ValueError(f"a mesh group needs >= 1 shard, got {k}")
            out.append(MeshGroup(torch.device(dev), k, s0))
            s0 += k
        if not out:
            raise ValueError("a mesh needs at least one group")
        self.groups = tuple(out)
        self.nsh = s0
        self.devices = np.array(
            [g.device for g in out for _ in range(g.k)], dtype=object)
        self.n_devices = len({str(g.device) for g in out})
        self.lead = out[0].device

    @property
    def layout(self) -> str:
        """'<shards>x<groups>@<devices>', e.g. '8x1@1' (one group of 8
        shards on one device) or '8x8@1' (eight one-shard groups)."""
        return f"{self.nsh}x{len(self.groups)}@{self.n_devices}"

    def __repr__(self) -> str:
        return f"Mesh({self.layout}: {list(self.groups)})"


def make_mesh(devices=None, n_devices: Optional[int] = None,
              device=None) -> Mesh:
    """1-D mesh of `n_devices` node-axis shards.

    `n_devices` is the SHARD count (the reference's name): with none
    given, `KTPU_MESH_DEVICES` picks it (0/unset = one shard per
    device). `devices` lists the groups' devices: each entry is one
    group, and an entry may repeat (the same device in several groups).
    Without `devices`, every CUDA device is one group (or `device`, e.g.
    "cpu", is the one group); CUDA must be present then, as for every
    entry point of the port. With at least as many entries as shards,
    the first `n_devices` entries hold one shard each; with fewer, the
    shards spread over the entries, the earlier groups taking one more
    where they do not divide."""
    if devices is None:
        if device is not None:
            devices = [resolve_device(device)]
        else:
            resolve_device(None)
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    if n_devices is None:
        n_devices = knobs.get_int("KTPU_MESH_DEVICES") or len(devices)
    nsh = int(n_devices)
    if nsh < 1:
        raise ValueError(f"make_mesh: shard count {nsh} < 1")
    if len(devices) >= nsh:
        return Mesh([(d, 1) for d in devices[:nsh]])
    q, r = divmod(nsh, len(devices))
    return Mesh([(d, q + (1 if i < r else 0))
                 for i, d in enumerate(devices)])


def node_capacity_multiple(mesh: Mesh) -> int:
    return int(mesh.nsh)


def pad_node_axis(cluster: Dict, multiple: int,
                  headroom: Optional[float] = None) -> Dict:
    """Pad node-axis arrays so dim 0 divides the shard count, with
    growth headroom quantized to shard multiples.

    Padding rows are all-zero: `valid` stays False so padded nodes are
    infeasible, and id columns hit the vocab null sentinel (id 0).
    `headroom` (default `KTPU_NODE_HEADROOM`) over-pads by a fraction of
    the live node count so later node adds stay inside the same padded
    shape. Tensors stay on their device; numpy arrays stay numpy."""
    n = cluster["valid"].shape[0]
    h = node_headroom() if headroom is None else max(0.0, headroom)
    want = max(n, int(-(-n * (1.0 + h) // 1)))
    target = -(-want // multiple) * multiple
    if target == n:
        return cluster
    out = dict(cluster)
    for k in NODE_DIM0_KEYS:
        v = cluster[k]
        if isinstance(v, torch.Tensor):
            pad = torch.zeros((target - n,) + tuple(v.shape[1:]),
                              dtype=v.dtype, device=v.device)
            out[k] = torch.cat([v, pad])
        else:
            widths = [(0, target - n)] + [(0, 0)] * (np.ndim(v) - 1)
            out[k] = np.pad(np.asarray(v), widths)
    return out


def _on(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def shard_cluster(cluster: Dict, mesh: Mesh) -> Dict:
    """The cluster dict for the mesh's single-device paths: node rows
    padded to the shard multiple (`pad_node_axis`), every array on the
    lead device. Without GSPMD the dict stays whole: the node-axis cut
    (parallel/partition.py CLUSTER_PARTITION_RULES, SESSION_PARTITION_RULES)
    is ShardedScanSession's."""
    cluster = pad_node_axis(cluster, node_capacity_multiple(mesh))
    return {k: _on(v, mesh.lead) for k, v in cluster.items()}


def replicate_pod(pod_arrays: Dict, mesh: Mesh) -> Dict:
    """The pending pod's encoded arrays on the lead device."""
    return {
        k: _on(np.asarray(v), mesh.lead)
        for k, v in pod_arrays.items()
        if not k.startswith("_")
    }


def select(out: Dict) -> Dict:
    """Best node (max total, lowest index wins ties) plus the feasible
    count — the reference's select, on the device the outputs lie on."""
    total = out["total"]
    return {
        "best_score": total.max(),
        "best_idx": torch.argmax(total),
        "n_feasible": out["feasible"].to(torch.int32).sum(),
    }


class ShardedScheduler:
    """Holds a mesh and dispatches scheduling cycles over it.

    Torch has no GSPMD: where the reference lets XLA partition the
    single-device programs over the mesh, `schedule`, `session` and
    `schedule_batch_hoisted` run the port's single-device functions
    (ops/kernel.py `schedule_pod`, ops/hoisted.py `HoistedSession`,
    `schedule_batch_hoisted`) on the mesh's lead device, over the
    cluster padded to the shard multiple — decisions are the
    reference's. The node-sharded session is ops/sharded_scan.py."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 weights: Optional[Dict[str, int]] = None):
        self.mesh = mesh or make_mesh()
        self.weights = dict(weights or DEFAULT_WEIGHTS)

    def schedule(self, cluster: Dict, pod_arrays: Dict) -> Dict:
        c = shard_cluster(cluster, self.mesh)
        p = replicate_pod(pod_arrays, self.mesh)
        out = schedule_pod(c, p, self.weights)
        out.update(select(out))
        return out

    def session(self, cluster: Dict, template_arrays_list, weights=None):
        """Cross-batch hoisted session (ops/hoisted.py HoistedSession) on
        the lead device, over the padded cluster."""
        from ..ops import hoisted

        c = shard_cluster(cluster, self.mesh)
        return hoisted.HoistedSession(c, template_arrays_list,
                                      weights or self.weights,
                                      device=self.mesh.lead)

    def schedule_batch_hoisted(self, cluster: Dict, pod_arrays_list):
        """Template-hoisted batched scan on the lead device over the
        padded cluster: (decisions, ys), the contract of
        ops.hoisted.schedule_batch_hoisted."""
        from ..ops import hoisted

        c = shard_cluster(cluster, self.mesh)
        return hoisted.schedule_batch_hoisted(c, pod_arrays_list,
                                              self.weights)
