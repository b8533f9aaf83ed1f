"""Fault tolerance of the port's backend: the FaultInjector, the
degradation ladder and the dispatch/harvest pipeline's recovery, on the
CPU.

The cases of tests/test_fault_tolerance.py that need only the backend
(TestFaultInjector, TestScheduleRetryPaths, TestDegradationLadder), with
the port's names (the top rung is RUNG_KERNEL, "kernel"); its
TestFaultParity raise / NaN-harvest / wedge cases at the backend level:
dispatch_many / harvest at max_pending 2 with a FaultInjector armed on
one batch bind as a fault-free run does, and the fault is recorded under
its kind. Then the port's own trouble spots:

- `_validate_decisions` and `corrupt_harvest` read a tensor back with
  `.cpu()`: a stand-in tensor that np.asarray refuses, as it refuses a
  tensor on the card, is validated and corrupted all the same;
- the pinned staging ring (models/encoding.py StagingRing) never rewrites
  a staging set before the event of the batch that last used it has
  completed (stand-in events);
- a backend on the card whose kernel library fails to build raises at
  construction instead of demoting.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.models.encoding import StagingRing
from kubernetes_tpu_torch.scheduler import metrics
from kubernetes_tpu_torch.scheduler.degradation import (
    RUNG_HOISTED,
    RUNG_KERNEL,
    RUNG_ORACLE,
    DegradationLadder,
    DeviceFault,
)
from kubernetes_tpu_torch.scheduler.framework.interface import FitError
from kubernetes_tpu_torch.scheduler.tpu_backend import RETRY_NODE, TPUBackend
from kubernetes_tpu_torch.testing.faults import FaultInjector, InjectedFault

from .test_torch_backend import RUNGS, _stream_batches, _World
from .test_torch_encoding import _port_obj
from .util import make_node, make_pod


def _faults(kind):
    return dict(metrics.device_faults.items()).get((kind,), 0.0)


# -- unit: injector ---------------------------------------------------------


class TestFaultInjector:
    def test_arm_shots_consume_and_count(self):
        inj = FaultInjector()
        inj.arm("raise-dispatch", shots=2)
        for _ in range(2):
            with pytest.raises(InjectedFault):
                inj.on_dispatch(rung=RUNG_HOISTED)
        inj.on_dispatch(rung=RUNG_HOISTED)  # shots exhausted: clean
        assert inj.injected["raise-dispatch"] == 2

    def test_min_rung_filter(self):
        """A kernel-only fault must not fire on hoisted dispatches."""
        inj = FaultInjector()
        inj.arm("raise-dispatch", shots=-1, min_rung=RUNG_KERNEL)
        inj.on_dispatch(rung=RUNG_HOISTED)  # below min_rung: clean
        with pytest.raises(InjectedFault):
            inj.on_dispatch(rung=RUNG_KERNEL)
        inj.disarm("raise-dispatch")
        inj.on_dispatch(rung=RUNG_KERNEL)

    def test_wedge_consume(self):
        inj = FaultInjector()
        inj.arm("wedge-wait", shots=1)
        assert inj.wedge_active()
        inj.consume_wedge()
        assert not inj.wedge_active()
        assert inj.injected["wedge-wait"] == 1

    def test_wedge_rejects_min_rung(self):
        inj = FaultInjector()
        with pytest.raises(ValueError):
            inj.arm("wedge-wait", shots=1, min_rung=RUNG_KERNEL)

    def test_wedged_probe_consumes_shot(self):
        """A wedge armed while the backend is demoted must be consumed by
        the probe's own timed-out wait, or it could never re-promote."""
        b = TPUBackend(device="cpu")
        b.watchdog_timeout = 0.1
        inj = FaultInjector()
        b.faults = inj
        inj.arm("wedge-wait", shots=1)
        assert b._probe_device() is False  # wedged canary
        assert not inj.wedge_active()
        assert b._probe_device() is True  # shot consumed: device answers

    @pytest.mark.parametrize("leaf", ["numpy", "tensor"])
    def test_corrupt_harvest_saturates_ints_and_nans_floats(self, leaf):
        inj = FaultInjector()
        inj.arm("nan-harvest", shots=1)
        rows, score = np.zeros((8, 4), np.int32), np.ones(4)
        if leaf == "tensor":
            rows, score = torch.from_numpy(rows), torch.from_numpy(score)
        ys = {"rows": rows, "score": score, "n": 2}
        bad = inj.corrupt_harvest(ys)
        assert bad["n"] == 2  # host scalars steer decode: untouched
        assert (np.asarray(bad["rows"]) == np.iinfo(np.int32).max).all()
        assert np.isnan(np.asarray(bad["score"])).all()
        assert isinstance(bad["rows"], type(rows))
        assert (np.asarray(ys["rows"]) == 0).all()  # the original stays
        # one shot: the next harvest is clean
        assert inj.corrupt_harvest(ys) is ys


class TestScheduleRetryPaths:
    def test_zero_feasible_still_raises_fit_error(self):
        b = TPUBackend(device="cpu")
        for i in range(3):
            b.on_add_node(_port_obj(make_node(f"n-{i}", cpu="2",
                                              memory="4Gi")))
        giant = _port_obj(make_pod("giant", cpu="64", memory="1Gi"))
        with pytest.raises(FitError) as e:
            b.schedule(giant)
        assert len(e.value.filtered_nodes_statuses) == 3

    @pytest.mark.parametrize("rung", sorted(RUNGS))
    def test_oracle_rung_raises_device_fault_without_dispatch(self, rung):
        """At the oracle rung schedule()/reevaluate() must not touch the
        device at all."""
        b = TPUBackend(device="cpu", use_kernel=RUNGS[rung])
        b.on_add_node(_port_obj(make_node("n-0", cpu="8", memory="16Gi")))
        while b.ladder.demote():
            pass
        assert b.ladder.rung() == RUNG_ORACLE
        inj = FaultInjector()
        b.faults = inj
        inj.arm("raise-dispatch", shots=-1)  # would fire on any dispatch
        with pytest.raises(DeviceFault):
            b.schedule(_port_obj(make_pod("p", cpu="100m")))
        nodes = b.reevaluate([_port_obj(make_pod("q", cpu="100m"))])
        assert nodes == [(RETRY_NODE, {})]
        assert not inj.injected, "device was dispatched at the oracle rung"


# -- unit: degradation ladder ----------------------------------------------


class TestDegradationLadder:
    def test_demotes_kernel_hoisted_oracle_and_repromotes(self):
        ladder = DegradationLadder(top=RUNG_KERNEL, threshold=3)
        assert ladder.mode() == "kernel"
        assert metrics.backend_mode.value() == RUNG_KERNEL
        for expected in ("hoisted", "oracle"):
            demoted = [ladder.record_fault("raise") for _ in range(3)]
            assert demoted == [False, False, True]
            assert ladder.mode() == expected
            assert metrics.backend_mode.value() == ladder.rung()
        for _ in range(5):
            assert not ladder.record_fault("raise")
        assert ladder.mode() == "oracle" and ladder.demotions == 2
        # probe recovery is stepwise: oracle -> hoisted -> kernel
        assert ladder.on_probe(True) and ladder.mode() == "hoisted"
        assert ladder.on_probe(True) and ladder.mode() == "kernel"
        assert not ladder.on_probe(True)  # at top: no-op
        assert ladder.promotions == 2
        assert metrics.backend_mode.value() == RUNG_KERNEL

    def test_success_resets_consecutive_count(self):
        ladder = DegradationLadder(top=RUNG_HOISTED, threshold=2)
        assert not ladder.record_fault()
        ladder.record_success()
        assert not ladder.record_fault()  # count restarted: no demotion
        assert ladder.mode() == "hoisted"

    def test_failed_probe_backs_off_capped(self):
        ladder = DegradationLadder(
            top=RUNG_HOISTED, threshold=1, probe_interval=0.1, probe_max=0.4,
            rng=random.Random(0),
        )
        ladder.record_fault()
        delays = []
        for _ in range(4):
            delays.append(ladder.probe_delay())
            ladder.on_probe(False)
        assert delays[0] < delays[-1] <= 0.4 * 2
        # promotion does NOT restore the cadence …
        ladder.on_probe(True)
        assert ladder.probe_delay() > 0.1 * 2
        # … only a clean harvest at the top rung does
        ladder.record_success()
        assert ladder.probe_delay() <= 0.1 * 2

    def test_flap_hysteresis_decays_to_probe_max(self):
        ladder = DegradationLadder(
            top=RUNG_HOISTED, threshold=1, probe_interval=0.1, probe_max=0.4,
            rng=random.Random(0),
        )
        for _ in range(4):  # flap cycles
            ladder.record_fault()
            assert ladder.on_probe(True)
        assert ladder.probe_delay() >= 0.4  # pinned at the cap

    def test_backend_ladder_demotes_and_probe_repromotes(self):
        """Through the backend: three faulted attempts at one batch demote
        the kernel rung and send the batch back (RETRY_NODE); the next
        batch builds the hoisted session (reason ladder-demoted) and
        binds; the probe thread's clean canary then re-promotes the
        ladder, and the batch after builds the kernel session again."""
        import time

        w = _World(True, True)
        w.be.ladder._probe_interval = w.be.ladder._probe_delay = 0.3
        w.be.retry_base = 0.0
        inj = FaultInjector()
        w.be.faults = inj
        inj.arm("raise-dispatch", shots=3, min_rung=RUNG_KERNEL)
        batches = _stream_batches(3, 4)
        before = w.counts()
        got = w.run(batches[0])
        assert set(got.values()) == {RETRY_NODE}
        assert w.be.ladder.mode() == "hoisted"
        got = w.run(batches[1])
        assert type(w.be._session).__name__ == "HoistedSession"
        assert all(n and n != RETRY_NODE for n in got.values())
        builds = {k: v for k, v in w.counts().items()
                  if v != before.get(k, 0.0)}
        assert ("session_builds", "hoisted", "ladder-demoted", "") in builds
        deadline = time.monotonic() + 10
        while w.be.ladder.rung() != RUNG_KERNEL \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert w.be.ladder.rung() == RUNG_KERNEL
        assert w.be._session is None  # probe-promoted teardown
        got = w.run(batches[2])
        assert type(w.be._session).__name__ == "ScanSession"
        assert all(n and n != RETRY_NODE for n in got.values())
        w.be.close()


# -- fault parity at the backend level --------------------------------------


def _drive(arm_plan, rung, watchdog=0.3):
    """The same batches through a fault-free backend and through one
    with `arm_plan` (batch index -> fault kind) armed at max_pending 2,
    each batch harvested only when the pipeline is full; returns both
    binding maps and the injector."""
    batches = _stream_batches(6, 5)
    maps = {}
    inj = None
    for faulty in (False, True):
        w = _World(True, RUNGS[rung])
        w.be.max_pending = 2
        w.be.retry_base = 0.0
        if faulty:
            inj = FaultInjector()
            w.be.faults = inj
            w.be.watchdog_timeout = watchdog
        got, handles = {}, []
        for i, b in enumerate(batches):
            if faulty and i in arm_plan:
                inj.arm(arm_plan[i], shots=1)
            handles.append(w.be.dispatch_many([w.conv(p) for p in b]))
        for h in handles:
            got.update({p.metadata.name: n for p, n in w.be.harvest(h)})
        maps[faulty] = got
        assert w.be.ladder.rung() == w.be.ladder.top  # transient: no demotion
    return maps, inj


@pytest.mark.parametrize("rung", sorted(RUNGS))
@pytest.mark.parametrize("kind, fault", [
    ("raise-dispatch", "raise"),
    ("nan-harvest", "invalid"),
    ("wedge-wait", "timeout"),
])
def test_fault_recovers_bit_identical(kind, fault, rung):
    before = _faults(fault)
    maps, inj = _drive({2: kind}, rung)
    assert inj.injected.get(kind, 0) >= 1
    assert maps[False] == maps[True], f"{kind} recovery changed decisions"
    assert all(maps[False].values())
    assert _faults(fault) - before >= 1


# -- the port's trouble spots -----------------------------------------------


class _CardTensor(torch.Tensor):
    """A tensor np.asarray refuses, as it refuses a tensor on the card;
    `.cpu()` reads it back."""

    def __array__(self, *args, **kwargs):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")

    def numpy(self, *args, **kwargs):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")

    def cpu(self, *args, **kwargs):
        return self.as_subclass(torch.Tensor).clone()


def _card(a):
    return torch.as_tensor(a).as_subclass(_CardTensor)


def test_validate_decisions_reads_tensors_back():
    b = TPUBackend(device="cpu")
    ys = {"best": _card(np.array([0, 2, -1])),
          "score": _card(np.array([1.0, 2.0, 0.0])), "_b_real": 3}
    with pytest.raises(TypeError):
        np.asarray(ys["score"])
    b._validate_decisions([0, 2, -1], 3, ys)  # finite: passes
    ys["score"] = _card(np.array([1.0, np.nan, 0.0]))
    with pytest.raises(DeviceFault) as e:
        b._validate_decisions([0, 2, -1], 3, ys)
    assert e.value.kind == "invalid"


def test_corrupt_harvest_reads_tensors_back():
    inj = FaultInjector()
    inj.arm("nan-harvest", shots=1)
    ys = {"rows": _card(np.zeros((8, 4), np.int32)),
          "score": _card(np.ones(4)), "n": 2, "mk": 1}
    bad = inj.corrupt_harvest(ys)
    assert inj.injected["nan-harvest"] == 1
    assert (bad["rows"].numpy() == np.iinfo(np.int32).max).all()
    assert np.isnan(bad["score"].numpy()).all()
    assert bad["n"] == 2 and bad["mk"] == 1
    # the corrupted payload fails validation as a device fault
    with pytest.raises(DeviceFault):
        TPUBackend(device="cpu")._validate_decisions(
            bad["rows"][0, :2].tolist(), 4, bad)


class _Event:
    """A stand-in CUDA event: complete only once the test says so (or a
    waiter synchronizes on it); records what the ring asked of it."""

    log = []

    def __init__(self):
        self.done = False
        self.recorded = False

    def record(self, stream=None):
        self.recorded = True

    def query(self):
        return self.done

    def synchronize(self):
        _Event.log.append(("sync", self))
        self.done = True


def test_staging_ring_waits_for_the_set_it_reuses(monkeypatch):
    _Event.log = []
    ring = StagingRing("cpu", depth=2, event_factory=_Event)
    writes = []
    real = StagingRing._buffer

    def spy(self, bufs, name, a):
        buf = real(self, bufs, name, a)
        writes.append((name, buf.data_ptr(), list(_Event.log)))
        return buf

    monkeypatch.setattr(StagingRing, "_buffer", spy)
    batches = [np.full(4, k, np.int32) for k in range(5)]
    ring.upload({"meta": batches[0]})
    e0 = ring._events[0]
    ring.upload({"meta": batches[1]})
    e1 = ring._events[1]
    assert e0.recorded and e1.recorded and not _Event.log
    # set 0 again: its batch's copies have not completed, so the ring
    # waits on e0 BEFORE it rewrites the buffer
    ring.upload({"meta": batches[2]})
    assert _Event.log == [("sync", e0)]
    assert writes[2][0] == "meta" and writes[2][1] == writes[0][1]
    assert writes[2][2] == [("sync", e0)]
    assert ring.waits == 1
    # set 1: its event has completed already — reused without a wait
    e1.done = True
    ring.upload({"meta": batches[3]})
    assert _Event.log == [("sync", e0)] and ring.waits == 1
    assert writes[3][1] == writes[1][1]
    # a set is never rewritten while its event is pending
    ring.upload({"meta": batches[4]})
    assert ring.waits == 2


def test_cuda_backend_raises_when_the_kernel_library_fails(monkeypatch):
    """A backend on the card builds and loads its kernel libraries at
    construction (the scan's with the kernel rung, the what-if's with the
    what-if on, its default on the card); a build error raises there
    instead of surfacing later as device faults the ladder would absorb
    by demoting, or at a first launch."""
    from kubernetes_tpu_torch.ops import scan_kernel, whatif_kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: object())
    monkeypatch.delenv("KTPU_WHATIF", raising=False)

    def broken(source):
        def load():
            raise RuntimeError(f"nvcc failed on {source} (1)")
        return load

    monkeypatch.setattr(scan_kernel, "_lib", broken("scan_full.cu"))
    monkeypatch.setattr(whatif_kernel, "_lib", broken("whatif.cu"))
    with pytest.raises(RuntimeError, match="nvcc failed on scan_full.cu"):
        TPUBackend(device="cuda")
    # the hoisted rung needs no scan library, but the what-if's, which
    # is on by default on the card
    with pytest.raises(RuntimeError, match="nvcc failed on whatif.cu"):
        TPUBackend(device="cuda", use_kernel=False)
    # the hoisted rung with the what-if off needs no kernel library
    monkeypatch.setenv("KTPU_WHATIF", "0")
    assert TPUBackend(device="cuda", use_kernel=False).ladder.mode() == \
        "hoisted"


def test_left_out_features_raise(monkeypatch):
    """The mesh is ported: a parallel/sharded.py Mesh is taken (its lead
    device is the backend's), anything else raises TypeError. The what-if
    planner is ported: off by default on the CPU, on with KTPU_WHATIF=1,
    and gang_feasible then answers a bool."""
    from kubernetes_tpu_torch.parallel.sharded import make_mesh

    with pytest.raises(TypeError):
        TPUBackend(device="cpu", mesh=object())
    mb = TPUBackend(device="cpu", mesh=make_mesh(device="cpu", n_devices=2))
    assert mb.mesh.nsh == 2 and mb.device.type == "cpu"
    monkeypatch.delenv("KTPU_WHATIF", raising=False)
    b = TPUBackend(device="cpu")
    assert not b.whatif and not b.whatif_enabled()
    assert b.gang_feasible(_port_obj(make_pod("g", cpu="1")), 2) is None
    monkeypatch.setenv("KTPU_WHATIF", "1")
    b = TPUBackend(device="cpu")
    assert b.whatif and b.whatif_enabled()
    b.on_add_node(_port_obj(make_node("n0", cpu="4", pods=10)))
    assert b.gang_feasible(_port_obj(make_pod("g", cpu="1")), 2) is True
