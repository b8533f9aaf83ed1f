"""The port's split eval / apply modes (ScanSession.evaluate and
apply_decisions, the scan_full kernel's "eval" and "apply" modes run here
through the plain PyTorch version on the CPU) against the reference's
PallasSession in interpret mode, on the shapes of tests/test_pallas_scan.py
TestEvalApplySplit and on two affinity-term cases: per-pod results and
carries equal the reference's, eval -> apply pod by pod replays full mode
exactly, and a forced −1 (an off-shard placement) leaves every carry
bit-identical."""

import copy

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.hoisted import template_fingerprint
from kubernetes_tpu.ops.pallas_scan import PallasSession
from kubernetes_tpu.ops.pallas_scan import batch_prologue as ref_prologue
from kubernetes_tpu.testing.synth import synth_cluster, synth_pending_pods
from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
from kubernetes_tpu_torch.ops import scan_kernel
from kubernetes_tpu_torch.ops.scan import ScanSession, batch_prologue

from .test_hoisted import _encode_all, _presized_encoding
from .test_torch_prologue import build_case

# TestEvalApplySplit's shape, and two term cases (the ur > 0 variant)
CASES = ("split", "terms_zone_required_anti", "terms_weight100_preferred")


def _templates_of(arrays):
    templates, seen = [], set()
    for a in arrays:
        fp = template_fingerprint(a)
        if fp not in seen:
            seen.add(fp)
            templates.append(a)
    return templates


def _build(case, n_pods=12):
    """(reference encoding, pod arrays, templates)."""
    if case == "split":
        nodes, init_pods = synth_cluster(12, pods_per_node=1)
        pending = synth_pending_pods(16, spread=True)
        enc, pe = _presized_encoding(copy.deepcopy(nodes),
                                     copy.deepcopy(init_pods),
                                     copy.deepcopy(pending))
        arrays = _encode_all(enc, pe, pending)
        return enc, arrays[:n_pods], _templates_of(arrays)
    enc, arrays, templates, _ = build_case(case)
    return enc, arrays[:n_pods], templates


def _sessions(enc, templates):
    ps = PallasSession(enc.device_state(), templates, interpret=True,
                       multipod_k=1)
    ss = ScanSession(cluster_from_numpy(enc.host_snapshot(), "cpu"),
                     templates, multipod_k=1, device="cpu")
    return ps, ss


def _assert_carries_equal(ps, ss, where):
    for k in ss.carry_keys:
        assert np.array_equal(np.asarray(ps._carry[k]),
                              ss._carry[k].numpy()), (where, k)


@pytest.mark.parametrize("case", CASES)
def test_eval_apply_replays_full(case):
    """Pod by pod: the port's evaluate equals the reference's, its apply
    moves the carries as the reference's does, and the decisions equal
    the port's full mode on the same pods."""
    enc, arrays, templates = _build(case)
    full = ScanSession(cluster_from_numpy(enc.host_snapshot(), "cpu"),
                       templates, multipod_k=1, device="cpu")
    want = ScanSession.decisions(full.schedule(arrays))
    ps, ss = _sessions(enc, templates)
    got = []
    for i, a in enumerate(arrays):
        ev = ss.evaluate([a])
        assert ev == ps.evaluate([a]), i
        ((best, _score),) = ev
        got.append(best)
        ss.apply_decisions([a], [best])
        ps.apply_decisions([a], [best])
        _assert_carries_equal(ps, ss, i)
    assert got == want
    for k in ss.carry_keys:
        assert torch.equal(ss._carry[k], full._carry[k]), k


@pytest.mark.parametrize("case", CASES)
def test_evaluate_batch_equals_pallas(case):
    """One eval launch over a batch: every pod against the same carry,
    out rows [:3, :n] equal the reference's and the carries stay as they
    were; then the batch's decisions applied in one apply launch."""
    enc, arrays, templates = _build(case)
    ps, ss = _sessions(enc, templates)
    ss.schedule(arrays[:2])
    ps.schedule(arrays[:2])
    before = {k: v.clone() for k, v in ss._carry.items()}
    batch = arrays[2:]
    yp = ps._dispatch_mode(batch, "eval")
    ys = ss._dispatch_mode(batch, "eval")
    n = len(batch)
    assert np.array_equal(np.asarray(yp["rows"])[:3, :n],
                          ys["rows"][:3, :n].numpy())
    for k in ss.carry_keys:
        assert torch.equal(ss._carry[k], before[k]), k
    decisions = ys["rows"][0, :n].tolist()
    ss.apply_decisions(batch, decisions)
    ps.apply_decisions(batch, decisions)
    _assert_carries_equal(ps, ss, "apply")


@pytest.mark.parametrize("case", CASES)
def test_off_shard_apply_is_noop(case):
    """Forcing −1 (the pod landed on another shard's nodes) leaves every
    carry bit-identical and the next eval unchanged; a real apply then
    moves the carry as the reference's does."""
    enc, arrays, templates = _build(case)
    ps, ss = _sessions(enc, templates)
    before = ss.evaluate([arrays[0]])
    assert before == ps.evaluate([arrays[0]])
    carry = {k: v.clone() for k, v in ss._carry.items()}
    ss.apply_decisions([arrays[0]], [-1])
    for k in ss.carry_keys:
        assert torch.equal(ss._carry[k], carry[k]), k
    assert ss.evaluate([arrays[0]]) == before
    ss.apply_decisions([arrays[0]], [before[0][0]])
    ps.apply_decisions([arrays[0]], [before[0][0]])
    _assert_carries_equal(ps, ss, "apply")
    assert ss.evaluate([arrays[1]]) == ps.evaluate([arrays[1]])


def test_batch_prologue_takes_bound_pods_when_asked():
    """The eval / apply modes take bound pods (require_unbound=False);
    schedule refuses them, as the reference does."""
    enc, arrays, templates = _build("split", n_pods=2)
    _, ss = _sessions(enc, templates)
    bound = dict(arrays[0])
    bound["has_node_name"] = np.bool_(True)
    fps = {template_fingerprint(bound): 0}
    for prologue in (batch_prologue, ref_prologue):
        with pytest.raises(ValueError):
            prologue(fps, ss._tp_np, [bound], minimum=128)
    Bp, tmpl, mfa, msa = batch_prologue(fps, ss._tp_np, [bound],
                                        minimum=128, require_unbound=False)
    rBp, rtmpl, rmfa, rmsa = ref_prologue(fps, ss._tp_np, [bound],
                                          minimum=128, require_unbound=False)
    assert Bp == rBp and np.array_equal(tmpl, rtmpl)
    for a, b in zip(mfa + msa, rmfa + rmsa):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("mode,forced", [
    ("apply", None),                 # apply needs its pairs
    ("eval", (256,)),                # pairs are for apply alone
    ("full", (256,)),
    ("apply", (128,)),               # [2 * Bp]
])
def test_scan_full_rejects_bad_forced(mode, forced):
    enc, arrays, templates = _build("split", n_pods=2)
    _, ss = _sessions(enc, templates)
    ss.schedule(arrays)
    meta = torch.zeros(1 + 128, dtype=torch.int32)
    match = torch.zeros((128, 256), dtype=torch.int8)
    fv = None if forced is None else torch.zeros(forced, dtype=torch.int32)
    with pytest.raises(ValueError):
        scan_kernel.scan_full(meta, match, ss._get_statics(), ss._carry,
                              ss.shapes, (1,) * 8, mode=mode, forced=fv)
