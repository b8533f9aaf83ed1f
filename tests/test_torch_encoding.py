"""The port's cluster and pod encodings equal the reference's.

The port's ClusterEncoding keeps the reference's host half and holds
torch tensors on the device side; after the same random add/remove
churn, its device_state("cpu") (first upload, then in-place dirty-row
rewrites) must equal the reference's host_snapshot() key by key, in
dtype and value. The port's PodEncoder must produce the reference's
arrays for the same pods."""

import copy
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.models.encoding import ClusterEncoding as RefEncoding
from kubernetes_tpu.models.pod_encoder import PodEncoder as RefPodEncoder
from kubernetes_tpu_torch.api import types as port_v1
from kubernetes_tpu_torch.models.encoding import (
    ClusterEncoding,
    cluster_from_numpy,
)
from kubernetes_tpu_torch.models.pod_encoder import PodEncoder

from .test_kernel_parity import random_cluster, random_pending
from .util import make_node, make_pod

SEEDS = (0, 1, 2)


def _port_obj(obj):
    """The same object as the port's API type: the port's api/types.py
    is a copy, so a round trip through the reference's serde keeps every
    field."""
    from kubernetes_tpu.utils import serde as ref_serde
    from kubernetes_tpu_torch.utils import serde

    cls = getattr(port_v1, type(obj).__name__)
    return serde.from_dict(cls, ref_serde.to_dict(obj))


def _assert_same(host: dict, dev: dict):
    assert set(host) == set(dev)
    for k, a in host.items():
        t = dev[k]
        assert isinstance(t, torch.Tensor), k
        b = t.numpy()
        assert b.dtype == np.asarray(a).dtype, (k, b.dtype, a.dtype)
        assert b.shape == np.asarray(a).shape, (k, b.shape)
        assert np.array_equal(b, a), k


def _churn(rng, encs, nodes, pods):
    """Apply one random event to every encoding (reference first)."""
    bound = [p for p in pods if p.spec.node_name]
    kind = rng.random()
    if kind < 0.45 or not bound:
        p = make_pod(
            f"churn-{rng.randrange(10 ** 9)}",
            namespace=rng.choice(["default", "other"]),
            labels={"app": rng.choice(["a", "b", "c"])},
            cpu=rng.choice([None, "100m", "1"]),
            memory=rng.choice([None, "64Mi", "1Gi"]),
            node_name=rng.choice(nodes).metadata.name,
        )
        pods.append(p)
        for enc, conv in encs:
            enc.add_pod(conv(p), p.spec.node_name)
    elif kind < 0.85:
        p = rng.choice(bound)
        pods.remove(p)
        for enc, conv in encs:
            enc.remove_pod(conv(p))
    elif kind < 0.95:
        n = make_node(f"new-{rng.randrange(10 ** 9)}",
                      labels={"zone": rng.choice(["z0", "z1", "z9"])})
        nodes.append(n)
        for enc, conv in encs:
            enc.add_node(conv(n))
    else:
        empty = [n for n in nodes
                 if not any(p.spec.node_name == n.metadata.name
                            for p in pods)]
        if empty:
            n = rng.choice(empty)
            nodes.remove(n)
            for enc, conv in encs:
                enc.remove_node(n.metadata.name)


@pytest.mark.parametrize("seed", SEEDS)
def test_device_state_equals_host_snapshot_after_churn(seed):
    rng = random.Random(seed)
    nodes, pods = random_cluster(rng)
    ref, port = RefEncoding(), ClusterEncoding()
    # headroom lanes so node adds can land incrementally
    ref.reserve(nodes=len(nodes) + 4)
    port.reserve(nodes=len(nodes) + 4)
    ref.set_cluster(copy.deepcopy(nodes), copy.deepcopy(pods))
    port.set_cluster([_port_obj(n) for n in nodes],
                     [_port_obj(p) for p in pods])
    _assert_same(ref.host_snapshot(), port.device_state("cpu"))
    encs = ((ref, copy.deepcopy), (port, _port_obj))
    for step in range(30):
        _churn(rng, encs, nodes, pods)
        if step % 5 == 4:  # in-place dirty-row sync, then compare
            _assert_same(ref.host_snapshot(), port.device_state("cpu"))
    _assert_same(ref.host_snapshot(), port.device_state("cpu"))
    # a scratch upload is a separate copy of the same state
    scratch = port.scratch_state("cpu")
    _assert_same(ref.host_snapshot(), scratch)
    cached = port.device_state("cpu")
    assert all(scratch[k].data_ptr() != cached[k].data_ptr()
               for k in cached if cached[k].numel())


@pytest.mark.parametrize("seed", SEEDS)
def test_cluster_from_numpy_carries_reference_encoding(seed):
    rng = random.Random(100 + seed)
    nodes, pods = random_cluster(rng)
    ref = RefEncoding()
    ref.set_cluster(nodes, pods)
    host = ref.host_snapshot()
    dev = cluster_from_numpy(host, "cpu")
    _assert_same(host, dev)
    # a copy, not a view of the host arrays
    host["requested"][...] += 1
    assert not np.array_equal(dev["requested"].numpy(), host["requested"])


@pytest.mark.parametrize("seed", SEEDS)
def test_pod_encoder_equals_reference(seed):
    rng = random.Random(200 + seed)
    nodes, pods = random_cluster(rng)
    pending = []
    for i in range(6):
        p = random_pending(rng)
        p.metadata.name = f"enc-{seed}-{i}"
        pending.append(p)
    ref = RefEncoding()
    port = ClusterEncoding()
    ref.set_cluster(copy.deepcopy(nodes), copy.deepcopy(pods))
    port.set_cluster([_port_obj(n) for n in nodes],
                     [_port_obj(p) for p in pods])
    rpe, ppe = RefPodEncoder(ref), PodEncoder(port)
    for p in pending:
        ra = rpe.encode(copy.deepcopy(p))
        pa = ppe.encode(_port_obj(p))
        keys = {k for k in ra if not k.startswith("_")}
        assert keys == {k for k in pa if not k.startswith("_")}
        for k in sorted(keys):
            a, b = np.asarray(ra[k]), np.asarray(pa[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.array_equal(a, b), k
    _assert_same(ref.host_snapshot(), port.device_state("cpu"))
