"""The Hopper probes' plain PyTorch versions (kubernetes_tpu_torch/probes/,
the counterparts of scripts/probe_pallas.py, probe_pallas2.py and
probe_fixed_cost.py) against a direct numpy statement of the functions the
TPU probe kernels compute, exactly, at the TPU probes' shapes and at small
ones where the carry fills up.

The JAX probes themselves cannot run here: they build and run their
kernels for a TPU (pltpu memory spaces, Mosaic) at import, so the numpy
statements below take their place. The wrappers send CPU tensors to the
plain versions and count no launch; the kernels are held to the plain
versions on the card by chip_smoke.py (phase 10)."""

import ctypes

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch import probes
from kubernetes_tpu_torch.ops import build
from kubernetes_tpu_torch.ops.scan_kernel import ARG_PTRS
from kubernetes_tpu_torch.probes import probe_fixed_cost as pf
from kubernetes_tpu_torch.probes import probe_layouts as pl
from kubernetes_tpu_torch.probes import probe_scan as ps


def _scan_np(req, alloc):
    """scripts/probe_pallas.py's kernel: per step fit, score, first-max
    argmax, one-hot update, out row = best."""
    util = np.zeros(alloc.shape[1], np.float32)
    a = alloc[0]
    out = np.empty((req.shape[0], 128), np.int32)
    for b in range(req.shape[0]):
        r = req[b, 0]
        score = np.where(util + r <= a, a - util, np.float32(-1.0))
        best = int(np.argmax(score))
        util[best] = util[best] + r
        out[b] = best
    return out


def _layouts_np(k, req, alloc):
    """scripts/probe_pallas2.py's bodies k1, k2 and k3."""
    util = np.zeros(alloc.shape[1], np.float32)
    out = np.empty_like(req)
    for b in range(req.shape[0]):
        if k == 1:
            out[b] = req[b] + util[0]
            continue
        best = int(np.argmax(alloc[0] - util))
        if k == 3:
            util[best] = util[best] + req[b, 0]
        out[b] = np.float32(best)
    return out


def _small_scan_inputs(seed):
    """Few lanes, uneven capacities and requests, more steps than fit:
    nodes fill, ties break to the first lane, and late steps find no
    node (every score -1, argmax 0)."""
    rng = np.random.default_rng(seed)
    req = rng.choice(np.float32([0.25, 0.5, 0.75, 1.0]), (40, 1))
    alloc = rng.choice(np.float32([1.0, 2.0, 3.0]), (1, 9))
    return req.astype(np.float32), alloc.astype(np.float32)


def test_probe_scan_tpu_shapes():
    req, alloc = ps.inputs("cpu")
    assert (tuple(req.shape), tuple(alloc.shape)) == ((ps.B, 1), (1, ps.N))
    before = dict(ps.LAUNCHES)
    out = ps.probe_scan(req, alloc)
    assert ps.LAUNCHES == before
    assert np.array_equal(out.numpy(), _scan_np(req.numpy(), alloc.numpy()))
    # each node takes 6 pods of 0.5 in 3.0: step b picks lane b
    assert out[:8, 0].tolist() == list(range(8))
    assert out[:, 0].tolist() == list(range(ps.B))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_scan_fills_nodes(seed):
    req, alloc = _small_scan_inputs(seed)
    out = ps.probe_scan(torch.from_numpy(req), torch.from_numpy(alloc))
    want = _scan_np(req, alloc)
    assert np.array_equal(out.numpy(), want)
    assert len(set(want[:, 0].tolist())) > 1


def test_probe_int64():
    a = ps.int64_input("cpu")
    assert a.dtype == torch.int64 and tuple(a.shape) == (8, 128)
    big = torch.tensor([[2 ** 40, -(2 ** 41), 3]], dtype=torch.int64)
    for x in (a, big):
        assert np.array_equal(ps.probe_int64(x).numpy(), x.numpy() * 2 + 1)
    assert ps.probe_int64(big)[0, 0] == 2 ** 41 + 1


@pytest.mark.parametrize("k", [1, 2, 3])
def test_probe_layouts(k):
    req, alloc = pl.inputs("cpu")
    assert tuple(req.shape) == (pl.B, 128) and tuple(alloc.shape) == (1, pl.N)
    before = pl.LAUNCHES
    out = pl.probe_layouts(k, req, alloc)
    assert pl.LAUNCHES == before
    assert np.array_equal(out.numpy(),
                          _layouts_np(k, req.numpy(), alloc.numpy()))
    want = {1: [0.5] * 8, 2: [0.0] * 8, 3: [float(i) for i in range(8)]}[k]
    assert out[:8, 0].tolist() == want


@pytest.mark.parametrize("k", [2, 3])
def test_probe_layouts_uneven(k):
    rng = np.random.default_rng(k)
    req = rng.choice(np.float32([0.5, 1.5]), (24, 128)).astype(np.float32)
    alloc = rng.choice(np.float32([1.0, 2.0, 4.0]), (1, 7))
    alloc = alloc.astype(np.float32)
    out = pl.probe_layouts(k, torch.from_numpy(req), torch.from_numpy(alloc))
    assert np.array_equal(out.numpy(), _layouts_np(k, req, alloc))


def test_probe_layouts_rejects_bad_input():
    req, alloc = pl.inputs("cpu")
    with pytest.raises(ValueError):
        pl.probe_layouts(4, req, alloc)
    with pytest.raises(ValueError):
        pl.probe_layouts(1, req[:, :64].contiguous(), alloc)


def test_fixed_cost_plain_version():
    """The trivial kernel's function: out [8, Bp] = -1 + B_real, at the
    TPU probe's shapes, behind the scan kernel's full argument set."""
    tensors, dims = pf.arguments("cpu")
    assert set(tensors) <= set(ARG_PTRS)
    assert tuple(tensors["out"].shape) == (8, pf.Bp)
    assert tensors["scalars"].numel() == 216     # the TPU probe's table
    assert dims[:9] == [pf.T, pf.C, pf.Np, pf.R, pf.SR, pf.TCp, pf.K,
                        pf.CP, pf.Bp]
    before = pf.LAUNCHES
    pf.fixed_cost(tensors, dims)
    assert pf.LAUNCHES == before
    assert np.array_equal(tensors["out"].numpy(),
                          np.full((8, pf.Bp), pf.Bp - 1, np.int32))
    meta = torch.zeros(1 + pf.Bp, dtype=torch.int32)
    for breal in (0, 5):
        meta[0] = breal
        assert np.array_equal(pf.fixed_cost_reference(meta, pf.Bp).numpy(),
                              np.full((8, pf.Bp), breal - 1, np.int32))


def test_probes_lib_configured_once(monkeypatch):
    """`probes.lib()` loads the library and sets its entry points'
    signatures once per process; later calls return the same object and
    neither load nor configure it again (no CUDA needed: the loader is
    replaced by a counter)."""

    class Entry:
        def __init__(self):
            self.sets = 0

        def __setattr__(self, name, value):
            if name in ("argtypes", "restype"):
                object.__setattr__(self, "sets", self.sets + 1)
            object.__setattr__(self, name, value)

    class FakeLib:
        def __init__(self):
            for name in probes._SIGNATURES:
                setattr(self, name, Entry())

    loads = []

    def load(source):
        loads.append(source)
        return FakeLib()

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(probes, "_LIB", None)
    first = probes.lib()
    assert loads == [probes.SOURCE]
    for name, argtypes in probes._SIGNATURES.items():
        fn = getattr(first, name)
        assert fn.argtypes == list(argtypes) and fn.restype is ctypes.c_int
        assert fn.sets == 2
    assert probes.lib() is first and probes.lib() is first
    assert len(loads) == 1
    assert all(getattr(first, n).sets == 2 for n in probes._SIGNATURES)
