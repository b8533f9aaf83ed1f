"""The port's scheduling backend (kubernetes_tpu_torch/scheduler/
tpu_backend.py TPUBackend) against the reference's, on the CPU.

Each case builds the reference's SchedulerCache + TPUBackend() (its jnp
hoisted session on the CPU) and the port's SchedulerCache +
TPUBackend(device="cpu"), each fed the same objects in its own package's
api.types, and drives both identically. The port runs on both of its
rungs: `use_kernel` forced on (ScanSession on the scan kernels' plain
versions) and off (HoistedSession).

- the seeded event stream of tests/test_session_deltas.py (batches,
  foreign adds and removes, affinity pods, heartbeats, allocatable
  updates), seeds 0-3: identical bindings on both rungs; on the hoisted
  rung the session builds, teardowns and delta applies, by kind and
  reason, equal the reference's (its "platform is not tpu" build reason
  is the port's "platform is not cuda"). On the kernel rung ScanSession
  may refuse a delta the hoisted session takes (its int32 / GCD
  envelope), which costs a rebuild, so those counts are reported, not
  required;
- the reference backend reads its encoding's device state through
  private copies here (`_private_device_state`): on the CPU, JAX may
  alias a 64-byte aligned host array of the encoding, so an allocatable
  update written into the host array in place reaches the live session
  once through the alias and once more as the queued delta, and the
  reference's delta path then binds otherwise than its own rebuild path
  in some processes (the race behind ROADMAP's test_session_deltas.py
  flake). With the copies it binds as its rebuild path does, in every
  process; the port reads no host array through a device tensor;
- `schedule` (one pod, and zero-feasible -> FitError with the same
  statuses), `reevaluate`, `dispatch_many` chains at max_pending 1 and 2
  against `schedule_many`, a host-port batch (the kernel rung demotes it,
  reason host-ports), an explain batch (KTPU_EXPLAIN=1: the same top-k
  payloads) and a batch of more than 8 templates (the one-shot hoisted
  dispatch).
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

from kubernetes_tpu.api import types as v1
from kubernetes_tpu.scheduler import metrics as ref_metrics
from kubernetes_tpu.scheduler.framework.interface import FitError as RefFitError
from kubernetes_tpu.scheduler.internal.cache import SchedulerCache as RefCache
from kubernetes_tpu.scheduler.tpu_backend import TPUBackend as RefBackend
from kubernetes_tpu_torch.scheduler import metrics
from kubernetes_tpu_torch.scheduler.framework.interface import FitError
from kubernetes_tpu_torch.scheduler.internal.cache import SchedulerCache
from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend

from .test_session_deltas import (
    _anti_pod,
    _event_stream,
    _plain_pod,
    _spread_pod,
)
from .test_torch_encoding import _port_obj
from .util import make_node, make_pod, spread_constraint

RUNGS = {"kernel": True, "hoisted": False}
# the reference's CPU build reason and the port's
REASONS = {"platform is not tpu": "platform is not cuda"}


def _node(i, cpu=None):
    return make_node(
        f"node-{i}", cpu=cpu or str(4 + (i % 2) * 2), memory="16Gi",
        pods=64,
        labels={v1.LABEL_HOSTNAME: f"node-{i}", "zone": f"z{i % 3}"},
    )


def _private_device_state(enc):
    """The reference encoding's device_state() as fresh copies of its host
    arrays, made from host copies, so that no array a session holds
    aliases one that the encoding later writes in place."""
    import jax.numpy as jnp

    sync = enc.device_state

    def device_state():
        keys = sync()
        host = enc.host_snapshot()
        return {k: jnp.asarray(np.array(host[k], copy=True)) for k in keys}

    enc.device_state = device_state


class _World:
    """One package's cache + backend, fed reference objects (converted to
    the port's api.types on the port's side)."""

    def __init__(self, port: bool, use_kernel: bool = False,
                 n_nodes: int = 6):
        self.port = port
        if port:
            self.be = TPUBackend(device="cpu", use_kernel=use_kernel)
            self.cache = SchedulerCache()
            self.metrics = metrics
            self.conv = _port_obj
        else:
            self.be = RefBackend()
            _private_device_state(self.be.enc)
            self.cache = RefCache()
            self.metrics = ref_metrics
            self.conv = copy.deepcopy
        self.cache.add_listener(self.be)
        for i in range(n_nodes):
            self.cache.add_node(self.conv(_node(i)))

    def counts(self):
        out = {}
        for name in ("session_builds", "session_rebuilds",
                     "session_delta_applies"):
            for key, val in getattr(self.metrics, name).items():
                key = tuple(REASONS.get(k, k) for k in key)
                out[(name,) + key] = val
        return out

    def run(self, pods):
        """One batch through dispatch_many + harvest: {name: node}."""
        h = self.be.dispatch_many([self.conv(p) for p in pods])
        return {p.metadata.name: node for p, node in self.be.harvest(h)}


def _delta(after, before):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def _replay(world: _World, ops):
    """test_session_deltas._replay, against one world."""
    decisions = {}
    bound = {}
    for op, payload in ops:
        if op == "schedule":
            mk = {"spread": _spread_pod, "plain": _plain_pod,
                  "anti": _anti_pod}
            decisions.update(world.run(
                [mk[tmpl](name) for tmpl, name in payload]))
        elif op == "add":
            name, node, labels = payload
            p = world.conv(_plain_pod(
                name, node=node,
                labels={"app": "spread" if labels == "spread" else "x"}))
            bound[name] = p
            world.cache.add_pod(p)
        elif op in ("remove", "remove-anti"):
            world.cache.remove_pod(bound.pop(payload))
        elif op == "add-anti":
            name, node = payload
            p = world.conv(_anti_pod(name, node=node))
            bound[name] = p
            world.cache.add_pod(p)
        elif op == "heartbeat":
            world.cache.update_node(world.conv(_node(payload)))
        elif op == "alloc-update":
            i = payload
            world.cache.update_node(world.conv(
                _node(i, cpu=str(8 + (i % 2) * 2))))
    return decisions


@pytest.mark.parametrize("rung", sorted(RUNGS))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_event_stream_parity(seed, rung):
    ops = _event_stream(seed)
    ref, port = _World(False), _World(True, RUNGS[rung])
    before = (ref.counts(), port.counts())
    want = _replay(ref, ops)
    got = _replay(port, ops)
    assert got == want
    assert any(want.values())
    ref_counts = _delta(ref.counts(), before[0])
    port_counts = _delta(port.counts(), before[1])
    applies = sum(v for k, v in port_counts.items()
                  if k[0] == "session_delta_applies")
    if rung == "hoisted":
        assert port_counts == ref_counts
        assert applies > 0, "no event rode the carry-delta path"
    else:
        kinds = {k[1] for k in port_counts if k[0] == "session_builds"}
        assert kinds <= {"kernel", "hoisted"}
        # the anti-affinity templates ride the kernel too: no build of
        # this stream demotes
        assert ("session_builds", "hoisted") not in {
            k[:2] for k in port_counts}
        print(f"seed {seed} kernel rung: {port_counts}; reference "
              f"{ref_counts}")
    assert port.be.ladder.rung() == port.be.ladder.top


def _fit_error_statuses(exc):
    return _statuses(exc.filtered_nodes_statuses)


def _statuses(statuses):
    return {name: (st.code.value, tuple(st.reasons))
            for name, st in statuses.items()}


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_schedule_one_pod_and_fit_error(rung):
    """schedule(): the same node for fitting pods (plain, spread, bound
    by nodeName), and a zero-feasible pod raises FitError with the same
    per-node statuses."""
    ref, port = _World(False), _World(True, RUNGS[rung])
    pods = [_plain_pod("one"), _spread_pod("two"),
            _plain_pod("pinned", node="node-4"), _anti_pod("three")]
    for p in pods:
        want = ref.be.schedule(ref.conv(p))
        got = port.be.schedule(port.conv(p))
        assert (got.suggested_host, got.evaluated_nodes,
                got.feasible_nodes) == (want.suggested_host,
                                        want.evaluated_nodes,
                                        want.feasible_nodes)
    giant = make_pod("giant", cpu="64", memory="1Gi")
    with pytest.raises(RefFitError) as want:
        ref.be.schedule(ref.conv(giant))
    with pytest.raises(FitError) as got:
        port.be.schedule(port.conv(giant))
    assert got.value.num_all_nodes == want.value.num_all_nodes == 6
    assert _fit_error_statuses(got.value) == _fit_error_statuses(want.value)
    assert len(got.value.filtered_nodes_statuses) == 6


def test_reevaluate_parity():
    """reevaluate(): best node or per-node statuses, per pod, as the
    reference's."""
    ref, port = _World(False), _World(True, True)
    for w in (ref, port):
        w.run([_plain_pod(f"fill-{i}", cpu="3") for i in range(4)])
    pods = [_plain_pod("fits"), make_pod("giant", cpu="64", memory="1Gi"),
            _spread_pod("spread"), _plain_pod("big", cpu="3")]
    want = ref.be.reevaluate([ref.conv(p) for p in pods])
    got = port.be.reevaluate([port.conv(p) for p in pods])
    assert len(got) == len(want) == len(pods)
    for (gn, gs), (wn, ws) in zip(got, want):
        assert gn == wn
        assert _statuses(gs) == _statuses(ws)


def _stream_batches(n_batches=4, size=6):
    out = []
    for b in range(n_batches):
        batch = []
        for i in range(size):
            name = f"b{b}-{i}"
            batch.append(_spread_pod(name) if (b + i) % 3
                         else _plain_pod(name))
        out.append(batch)
    return out


@pytest.mark.parametrize("rung", sorted(RUNGS))
@pytest.mark.parametrize("depth", [1, 2])
def test_dispatch_chain_equals_schedule_many(depth, rung):
    """dispatch_many / harvest at max_pending 1 and 2 (each batch
    harvested only when the pipeline is full) bind as schedule_many on
    the same batches, and as the reference's chain."""
    batches = _stream_batches()
    seq = _World(True, RUNGS[rung])
    want = {}
    for b in batches:
        want.update({p.metadata.name: n for p, n in
                     seq.be.schedule_many([seq.conv(p) for p in b])})
    for w in (_World(True, RUNGS[rung]), _World(False)):
        w.be.max_pending = depth
        got, handles = {}, []
        for b in batches:
            handles.append(w.be.dispatch_many([w.conv(p) for p in b]))
        for h in handles:
            got.update({p.metadata.name: n for p, n in w.be.harvest(h)})
        assert got == want, (w.port, depth)
    assert all(want.values())


def test_host_port_batch_demotes_to_hoisted():
    """Host-port templates: the kernel rung's ScanSession refuses them
    (SessionUnsupported, reason host-ports), the backend builds the
    hoisted session, counted under that reason, and the bindings equal
    the reference's."""
    ref, port = _World(False), _World(True, True)
    before = port.counts()
    pods = [make_pod(f"hp-{i}", cpu="100m", memory="32Mi",
                     labels={"app": "hp"}, host_port=8080 if i % 2 else 0)
            for i in range(8)]
    want = ref.run(pods)
    got = port.run(pods)
    assert got == want
    nodes = [want[f"hp-{i}"] for i in range(1, 8, 2)]
    assert len(set(nodes)) == len(nodes)
    builds = _delta(port.counts(), before)
    assert builds.get(("session_builds", "hoisted", "host-ports", "")) \
        >= 1, builds
    assert type(port.be._session).__name__ == "HoistedSession"
    assert port.be.ladder.rung() == port.be.ladder.top


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_explain_batch_parity(rung, monkeypatch):
    """KTPU_EXPLAIN=1: explain rides the hoisted session on both rungs
    (reason explain); each harvest carries the same top-k payloads as
    the reference's."""
    monkeypatch.setenv("KTPU_EXPLAIN", "1")
    ref, port = _World(False), _World(True, RUNGS[rung])
    assert ref.be.explain and port.be.explain
    before = port.counts()
    for b in _stream_batches(3, 5):
        hr = ref.be.dispatch_many([ref.conv(p) for p in b])
        hp = port.be.dispatch_many([port.conv(p) for p in b])
        want = ref.be.harvest(hr)
        got = port.be.harvest(hp)
        assert [n for _, n in got] == [n for _, n in want]
        if hr.explain is None:
            assert hp.explain is None  # the synchronous first batch
            continue
        assert len(hp.explain) == len(hr.explain) == len(b)
        for g, w in zip(hp.explain, hr.explain):
            for k in ("topk_idx", "topk_total", "topk_scores", "bits"):
                assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k
    builds = _delta(port.counts(), before)
    assert builds.get(("session_builds", "hoisted", "explain", "")) >= 1


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_template_overflow_parity(rung):
    """A batch of more than 8 distinct templates takes the one-shot
    hoisted dispatch (teardown reason template-overflow) and binds as
    the reference does."""
    ref, port = _World(False), _World(True, RUNGS[rung])
    pods = [make_pod(f"t-{i}", cpu=f"{100 + 10 * i}m", memory="32Mi",
                     labels={"app": f"t{i}"},
                     constraints=[spread_constraint(
                         1, "zone", "ScheduleAnyway", {"app": f"t{i}"})])
            for i in range(10)]
    ref.run([_plain_pod("warm")])
    port.run([_plain_pod("warm")])
    before = (ref.counts(), port.counts())
    want = ref.run(pods)
    got = port.run(pods)
    assert got == want and all(got.values())
    assert _delta(port.counts(), before[1]).get(
        ("session_rebuilds", "template-overflow", "")) == 1
    assert _delta(ref.counts(), before[0]).get(
        ("session_rebuilds", "template-overflow", "")) == 1
