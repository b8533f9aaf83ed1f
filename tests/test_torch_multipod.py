"""Multi-pod scan steps of the port (ScanSession with multipod_k > 1, its
scan_full kernel run here through the plain PyTorch version on the CPU)
against the reference: out rows [:4, :n] (row 3 the conflict-suffix
flag) and every carry after every batch equal PallasSession's multipod
kernel in interpret mode; `schedule_exact` (the backend's suffix replay
loop, scheduler/tpu_backend.py) decides exactly as one pod per step; the
two directed races of tests/test_pipeline_parity.py (last slot,
overtake) conflict and replay as the reference does; and the host halves
(conflict_stats, the multipod_k resolution) follow the reference's rules. The affinity-term
cases run the same checks in tests/test_torch_multipod_terms.py (a file
of its own, so that the two halves of the interpret-mode compiles run on
two workers)."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as v1
from kubernetes_tpu.ops.hoisted import HoistedSession
from kubernetes_tpu.ops.pallas_scan import PallasSession
from kubernetes_tpu.scheduler.internal.cache import SchedulerCache
from kubernetes_tpu.scheduler.tpu_backend import TPUBackend
from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
from kubernetes_tpu_torch.ops import scan_kernel
from kubernetes_tpu_torch.ops.kernel import multipod_k
from kubernetes_tpu_torch.ops.scan import ScanSession
from kubernetes_tpu_torch.scheduler.degradation import DeviceFault
from kubernetes_tpu_torch.scheduler.tpu_backend import schedule_exact

from .test_torch_prologue import CASES, build_case
from .util import make_node, make_pod


def is_term_case(case):
    return case.startswith(("terms_", "fuzzterms-"))


def mk_cases(term: bool):
    """Every case of the kind at mk=4; two of them at 2 and 8 as well."""
    wide = (("terms_zone_required_anti", "fuzzterms-1") if term
            else ("spread_multi_batch", "fuzz-0"))
    return [(c, 4) for c in CASES if is_term_case(c) == term] + [
        (c, k) for c in wide for k in (2, 8)]


MK_CASES = mk_cases(term=False)


def _port_session(enc, templates, **kw):
    return ScanSession(cluster_from_numpy(enc.host_snapshot(), "cpu"),
                       templates, device="cpu", **kw)


def _assert_carries_equal(ps, ss, where):
    assert set(ps._carry) == set(ss._carry) == set(ss.carry_keys)
    for k in ss.carry_keys:
        assert np.array_equal(np.asarray(ps._carry[k]),
                              ss._carry[k].numpy()), (where, k)


def check_multipod_equals_pallas(case, mk):
    enc, arrays, templates, batch = build_case(case)
    ps = PallasSession(enc.device_state(), templates, interpret=True,
                       multipod_k=mk)
    ss = _port_session(enc, templates, multipod_k=mk)
    assert ss.multipod_k == ps.multipod_k == mk
    assert np.array_equal(ps._gmat, ss._gmat)
    for lo in range(0, len(arrays), batch):
        b = arrays[lo:lo + batch]
        n = len(b)
        yp, ys = ps.schedule(b), ss.schedule(b)
        assert ys["mk"] == yp["mk"] == mk
        rp, rs = np.asarray(yp["rows"]), ys["rows"].numpy()
        assert np.array_equal(rp[:4, :n], rs[:4, :n]), (lo, rp[:4, :n],
                                                         rs[:4, :n])
        assert ScanSession.conflict_stats(ys) == \
            PallasSession.conflict_stats(yp)
        _assert_carries_equal(ps, ss, lo)


def check_schedule_exact(case, mk):
    """The suffix replay lands every pod where one pod per step does:
    the decisions equal HoistedSession's, the carries an mk=1
    ScanSession's, after every batch."""
    enc, arrays, templates, batch = build_case(case)
    hs = HoistedSession(enc.device_state(), templates, multipod_k=1)
    one = _port_session(enc, templates, multipod_k=1)
    multi = _port_session(enc, templates, multipod_k=mk)
    for lo in range(0, len(arrays), batch):
        b = arrays[lo:lo + batch]
        want = HoistedSession.decisions(hs.schedule(b))[:len(b)]
        assert ScanSession.decisions(one.schedule(b)) == want
        assert schedule_exact(multi, b) == want, lo
        for k in one.carry_keys:
            assert torch.equal(one._carry[k], multi._carry[k]), (lo, k)


@pytest.mark.parametrize("case,mk", MK_CASES)
def test_multipod_equals_pallas(case, mk):
    check_multipod_equals_pallas(case, mk)


@pytest.mark.parametrize("case,mk", MK_CASES)
def test_schedule_exact_equals_one_pod_per_step(case, mk):
    check_schedule_exact(case, mk)


def test_schedule_exact_refuses_suffix_at_batch_head():
    class HeadConflict:
        @staticmethod
        def schedule(arrays):
            return {"n": len(arrays)}

        @staticmethod
        def decisions(ys):
            return [-1] * ys["n"]

        @staticmethod
        def conflict_stats(ys):
            return 1, 0

    # the backend's loop raises its device fault (kind "invalid")
    with pytest.raises(DeviceFault) as err:
        schedule_exact(HeadConflict(), [{}, {}])
    assert err.value.kind == "invalid"


def _encode(be, pods):
    return [{k: v for k, v in be.pe.encode(p).items()
             if not k.startswith("_")} for p in pods]


def _race_sessions(be, templates):
    """(reference multipod kernel, port) at mk=2 over the backend's
    encoding."""
    ps = PallasSession(be.enc.device_state(), templates, be.weights,
                       interpret=True, multipod_k=2)
    ss = ScanSession(cluster_from_numpy(be.enc.host_snapshot(), "cpu"),
                     templates, be.weights, multipod_k=2, device="cpu")
    return ps, ss


def _race(be, templates, arrays, want):
    """Both multipod kernels flag the second pod as the suffix; the
    replay decides as one pod per step."""
    ps, ss = _race_sessions(be, templates)
    yp, ys = ps.schedule(list(arrays)), ss.schedule(list(arrays))
    assert np.array_equal(np.asarray(yp["rows"])[:4, :2],
                          ys["rows"][:4, :2].numpy())
    assert ScanSession.conflict_stats(ys) == (1, 1)
    assert PallasSession.conflict_stats(yp) == (1, 1)
    _, fresh = _race_sessions(be, templates)
    assert schedule_exact(fresh, list(arrays)) == want


def test_directed_conflict_replay_last_slot():
    """tests/test_pipeline_parity.py's last-slot race through the port:
    two pods of one step race for the one 2-cpu slot; the second's
    speculative pick is the first's node (same node, and its fit
    flips)."""
    cache = SchedulerCache()
    be = TPUBackend()
    cache.add_listener(be)
    for i, cpu in enumerate(["3", "1"]):  # node-0 fits ONE 2-cpu pod
        cache.add_node(make_node(
            f"node-{i}", cpu=cpu, memory="16Gi", pods=64,
            labels={v1.LABEL_HOSTNAME: f"node-{i}"}))
    be.enc.reserve(pods=256)
    pods = [make_pod(f"race-{i}", namespace="default", cpu="2",
                     memory="128Mi", labels={"app": "race"})
            for i in range(2)]
    arrays = _encode(be, pods)
    ref = HoistedSession(be.enc.device_state(), [arrays[0]], be.weights,
                         multipod_k=1)
    want = HoistedSession.decisions(ref.schedule(list(arrays)))
    assert want == [0, -1]
    _race(be, [arrays[0]], arrays, want)


def test_directed_conflict_replay_overtake():
    """tests/test_pipeline_parity.py's overtake race through the port:
    pod 1 commits on a node pod 2 did NOT pick (node-0), rebalancing it
    so that its refreshed total overtakes pod 2's speculative winner
    (node-1) — only the utilization recheck can catch it."""
    cache = SchedulerCache()
    be = TPUBackend()
    cache.add_listener(be)
    for i in range(2):
        cache.add_node(make_node(
            f"node-{i}", cpu="10", memory="10Gi", pods=64,
            labels={v1.LABEL_HOSTNAME: f"node-{i}"}))
    cache.add_pod(make_pod("fill0", namespace="default", cpu="4",
                           memory="1Mi", labels={"app": "f"},
                           node_name="node-0"))
    cache.add_pod(make_pod("fill1", namespace="default", cpu="4300m",
                           memory="4400Mi", labels={"app": "f"},
                           node_name="node-1"))
    be.enc.reserve(pods=128)
    p1 = make_pod("big", namespace="default", cpu="50m", memory="4Gi",
                  labels={"app": "x"})
    p2 = make_pod("small", namespace="default", cpu="100m",
                  memory="100Mi", labels={"app": "y"})
    arrays = _encode(be, [p1, p2])
    # pod 2 alone picks node-1: its speculative winner in the step
    _, solo = _race_sessions(be, arrays)
    assert [d for d, _ in solo.evaluate([arrays[1]])] == [1]
    ref = HoistedSession(be.enc.device_state(), arrays, be.weights,
                         multipod_k=1)
    want = HoistedSession.decisions(ref.schedule(list(arrays)))
    assert want == [0, 0]
    _race(be, arrays, arrays, want)


def test_conflict_stats_decodes_suffix():
    """tests/test_pipeline_parity.py's decode cases, on numpy rows and on
    the session's torch rows."""
    rows = np.full((8, 8), -1, np.int32)
    # one-pod-per-step batches never report conflicts
    assert ScanSession.conflict_stats(
        {"rows": rows, "n": 6, "mk": 1}) == (0, None)
    rows[3, :6] = 0
    assert ScanSession.conflict_stats(
        {"rows": rows, "n": 6, "mk": 4}) == (0, None)
    # suffix from the first flagged pod; ONE detection per suffix (later
    # flags are collateral), padding rows ignored
    rows[3, 2:] = 1
    assert ScanSession.conflict_stats(
        {"rows": rows, "n": 6, "mk": 4}) == (1, 2)
    assert ScanSession.conflict_stats(
        {"rows": torch.from_numpy(rows), "n": 6, "mk": 4}) == (1, 2)
    rows[3, :] = 0
    rows[3, 7] = 1
    assert ScanSession.conflict_stats(
        {"rows": torch.from_numpy(rows), "n": 6, "mk": 4}) == (0, None)


def test_multipod_k_resolution(monkeypatch):
    """tests/test_pipeline_parity.py's resolution rules, with the port's
    platforms: "cuda" and "cpu" default to 1, "tpu" to the reference's
    4."""
    monkeypatch.delenv("KTPU_MULTIPOD_K", raising=False)
    # port-carrying sessions are pinned to 1 whatever else says
    assert multipod_k(8, dyn_ports=True) == 1
    # explicit beats env; clamped to a pow2 <= 64
    monkeypatch.setenv("KTPU_MULTIPOD_K", "16")
    assert multipod_k(8) == 8
    assert multipod_k(6) == 4
    assert multipod_k(200) == 64
    assert multipod_k(0) == 1
    # env beats the platform default (the kill switch)
    assert multipod_k() == 16
    assert multipod_k(platform="cuda") == 16
    monkeypatch.setenv("KTPU_MULTIPOD_K", "1")
    assert multipod_k() == 1
    # platform default: the reference's 4 on TPU, 1 on the port's devices
    monkeypatch.delenv("KTPU_MULTIPOD_K")
    assert multipod_k(platform="tpu") == 4
    assert multipod_k(platform="cuda") == 1
    assert multipod_k(platform="cpu") == 1


def test_session_resolves_multipod_k(monkeypatch):
    enc, _, templates, _ = build_case("no_constraints")
    monkeypatch.delenv("KTPU_MULTIPOD_K", raising=False)
    assert _port_session(enc, templates).multipod_k == 1
    monkeypatch.setenv("KTPU_MULTIPOD_K", "8")
    assert _port_session(enc, templates).multipod_k == 8
    assert _port_session(enc, templates, multipod_k=3).multipod_k == 2


@pytest.mark.parametrize("mode,mk", [("full", 3), ("full", 128),
                                     ("full", 0), ("eval", 2),
                                     ("apply", 4), ("full", True)])
def test_scan_full_rejects_bad_step_width(mode, mk):
    enc, arrays, templates, batch = build_case("no_constraints")
    ss = _port_session(enc, templates)
    ss.schedule(arrays[:batch])
    meta = torch.zeros(1 + 128, dtype=torch.int32)
    match = torch.zeros((128, 256), dtype=torch.int8)
    forced = torch.zeros(256, dtype=torch.int32) if mode == "apply" else None
    with pytest.raises(ValueError):
        scan_kernel.scan_full(meta, match, ss._get_statics(), ss._carry,
                              ss.shapes, (1,) * 8, mode=mode, mk=mk,
                              forced=forced)
