"""The what-if program's device layout (kubernetes_tpu_torch/ops/whatif_kernel.py,
ops/csrc/whatif.cu) on the CPU, where the wrappers take their plain versions.

Every what-if result here is held to the reference's jitted `_whatif_run`
(kubernetes_tpu/ops/whatif.py) on what-if contexts built from the same real
clusters in each package, with seeded inputs; the path is integer and bool,
so every comparison is exact equality.

- The packed input buffer: `pack` / `unpack` round-trip every array of the
  planner's layout (dyn_ipa x nominated pods x gang slots, L 4 / 8 / 16),
  and the run over the buffer equals the reference.
- The kernels' argument lists: `PTRS`, `DIMS` and `PACKED` against the
  `WPtr` / `WDim` enums of the CUDA source.
- The minimum-structure wrapper on the CPU against numpy.
- The (context, template) cache: one context over a wave of eight
  preemptors whose claimed drains grow equals the reference and a fresh
  context at every step, with the invariants computed once.
- The spec check that guards every CUDA launch raises WhatifKernelError.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.ops import whatif, whatif_kernel as wk
from kubernetes_tpu_torch.ops.whatif_kernel import WhatifKernelError, outputs

from .test_torch_whatif import _contexts, _random_inputs

_KEYS = ("fits_now", "base", "victims")


def _assert_equal(got, want):
    got = outputs(got)
    for key in _KEYS:
        g = got[key].numpy()
        w = np.asarray(want[key])
        assert g.dtype == np.bool_ and g.shape == w.shape, key
        assert np.array_equal(g, w), key


@pytest.fixture(scope="module")
def worlds():
    """Contexts of both packages for a plain, an affinity-term and a
    spread preemptor, built once for the module."""
    return {kind: _contexts(kind, seed=5) for kind in ("plain", "ipa",
                                                       "spread")}


def _planner_arrays(v, nom, pre):
    """name -> array of what `pack` writes, under PACKED's names."""
    src = {f"v_{k}": a for k, a in v.items()}
    src.update({f"nom_{k}": a for k, a in nom.items() if k != "has_nom"})
    src.update({f"pre_{k}": a for k, a in pre.items()})
    return src


@pytest.mark.parametrize("L", [4, 8, 16])
@pytest.mark.parametrize("gang", [False, True])
@pytest.mark.parametrize("has_nom", [False, True])
@pytest.mark.parametrize("kind", ["plain", "ipa"])
def test_pack_round_trip_and_run(worlds, kind, has_nom, gang, L):
    """Every array of one preemptor lands in its own aligned slot of the
    one buffer and comes back unchanged; the run over that buffer (the
    plain version of the launch) equals the reference."""
    rb, pb, rctx, pctx, rpa, ppa = worlds[kind]
    tj = pctx.template_index(ppa)
    rng = np.random.default_rng(L * 8 + 4 * has_nom + 2 * gang)
    v, nom, pre = _random_inputs(rng, rctx, rctx.np_slices(tj),
                                 rb.enc.host_snapshot(), L, gang, has_nom)
    tab, d, any_f = pctx.tables(tj)
    assert d["dyn_ipa"] == (kind == "ipa")
    dims = wk.launch_dims(d, L, has_nom, any_f)
    lay, nbytes = wk.layout(dims)
    assert list(lay) == list(wk.PACKED)
    offs = [off for off, _, _ in lay.values()]
    assert offs == sorted(offs) and all(o % wk.ALIGN == 0 for o in offs)
    assert all(dims[f"o_{k}"] == off for k, (off, _, _) in lay.items())
    buf = np.full(nbytes, 0xA5, np.uint8)
    wk.pack(v, nom, pre, dims, buf)
    back = wk.unpack(torch.from_numpy(buf), dims)
    src = _planner_arrays(v, nom, pre)
    for name, (off, dtype, shape) in lay.items():
        t = back[name]
        assert t.dtype == dtype and tuple(t.shape) == shape, name
        assert np.array_equal(t.numpy(), np.asarray(src[name]).reshape(
            shape)), name
    out = wk.whatif_device(tab, torch.from_numpy(buf), dims)
    assert out.dtype == torch.bool and tuple(out.shape) == (d["N"], L + 2)
    _assert_equal(out, rctx.run(tj, v, nom, pre))


def _enum(src: str, name: str):
    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [e.strip() for e in body.split(",") if e.strip()]


def test_arguments_match_kernel_enums():
    """The wrapper's pointer and int arguments are the CUDA source's WPtr
    and WDim enums, in order, and the packed offsets follow PACKED."""
    src = wk.SOURCE.read_text()
    ptrs = _enum(src, "WPtr")
    dims = _enum(src, "WDim")
    assert ptrs[-1] == "N_PTRS" and dims[-1] == "N_DIMS"
    assert ptrs[:-1] == [f"P_{k.upper()}" for k in wk.PTRS]
    assert dims[:-1] == [f"D_{k.upper()}" for k in wk.DIMS]
    assert [k for k in wk.DIMS if k.startswith("o_")] == [
        f"o_{k}" for k in wk.PACKED]
    # the C side's constants and entry points are the wrapper's
    assert f"TEAM = {wk.TEAM};" in src
    assert "BIG = %dLL;" % wk.BIG in src
    for entry in ("whatif_context_launch", "whatif_mins_launch",
                  "whatif_launch"):
        assert f'extern "C" int {entry}(void* const* p, const int* d,' in src


@pytest.mark.parametrize("kind", ["spread", "ipa"])
def test_context_cache_over_a_growing_wave(worlds, kind, monkeypatch):
    """Eight preemptors planned against one cached context, each with the
    claimed drains of the ones before it (pre_* growing, as a wave's
    claims do): every launch equals the reference and a context built
    fresh for that step, and the context's invariants are computed once."""
    rb, pb, rctx, pctx, rpa, ppa = worlds[kind]
    # a context of its own: the module's is shared with other tests
    ctx = whatif.WhatifContext.from_encoding(pb.enc, ppa, device="cpu")
    tj = ctx.template_index(ppa)
    calls = []
    real = whatif.whatif_context

    def counted(tab, d):
        calls.append(d["tj"])
        return real(tab, d)

    monkeypatch.setattr(whatif, "whatif_context", counted)
    rng = np.random.default_rng(21)
    nps = rctx.np_slices(tj)
    host = rb.enc.host_snapshot()
    _, _, acc = _random_inputs(rng, rctx, nps, host, 8, False, False,
                               drain=False)
    first = None
    for step in range(8):
        v, nom, grow = _random_inputs(rng, rctx, nps, host, 8, step % 2 == 1,
                                      step % 3 == 0)
        pre = {k: acc[k] + grow[k] for k in ("req", "cnt", "shared",
                                             "anti", "aff")}
        pre["atot"] = np.int32(pre["aff"].sum())
        acc = pre
        got = ctx.run(tj, v, nom, pre)
        _assert_equal(got, rctx.run(tj, v, nom, pre))
        fresh = whatif.WhatifContext.from_encoding(pb.enc, ppa, device="cpu")
        assert torch.equal(fresh.run(tj, v, nom, pre), got), step
        tables = ctx.tables(tj)
        if first is None:
            first = tables
        assert tables is first
    # the cached context once, each fresh context once
    assert calls == [tj] * 9


@pytest.mark.parametrize("drain", [False, True])
def test_mins_wrapper_routes_cpu_to_plain(worlds, drain):
    """whatif_mins on CPU tensors is its plain version (no launch
    counted): per spread constraint, the min, the count at the min and the
    min of the rest of its registered pairs' claimed-drained shared
    counts (numpy here), unregistered pairs counting as BIG."""
    rb, pb, rctx, pctx, rpa, ppa = worlds["spread"]
    tj = pctx.template_index(ppa)
    tab, d, any_f = pctx.tables(tj)
    assert any_f
    rng = np.random.default_rng(31)
    v, nom, pre = _random_inputs(rng, rctx, rctx.np_slices(tj),
                                 rb.enc.host_snapshot(), 4, False, False,
                                 drain=drain)
    dims = wk.launch_dims(d, 4, False, any_f)
    buf = np.zeros(wk.layout(dims)[1], np.uint8)
    wk.pack(v, nom, pre, dims, buf)
    before = wk.MINS_LAUNCHES
    got = wk.whatif_mins(tab, torch.from_numpy(buf), dims)
    assert wk.MINS_LAUNCHES == before
    assert got.dtype == torch.int64 and tuple(got.shape) == (d["C"], 3)
    shared = tab["shared0"].numpy() - pre["shared"]
    reg = tab["f_reg_real"].numpy()
    for c in range(d["C"]):
        x = np.where(reg[c], shared[c], wk.BIG)
        m1 = x.min()
        want = [m1, (x == m1).sum(), np.where(x == m1, wk.BIG, x).min()]
        assert got[c].tolist() == [int(w) for w in want], c


def _ok_tensors():
    return {"a": torch.zeros((3, 2), dtype=torch.int64),
            "b": torch.zeros(4, dtype=torch.bool)}


_SPECS = {"a": (torch.int64, (3, 2)), "b": (torch.bool, (4,))}


@pytest.mark.parametrize("fault", ["missing", "dtype", "shape",
                                   "contiguous", "device"])
def test_spec_check_raises(fault):
    """The check every CUDA launch passes first: a missing tensor, a wrong
    dtype, shape or device, or a strided view raises WhatifKernelError
    (naming the tensor); the well-formed set passes."""
    wk.check(_ok_tensors(), _SPECS, "cpu")
    named = _ok_tensors()
    device = "cpu"
    if fault == "missing":
        del named["b"]
    elif fault == "dtype":
        named["a"] = named["a"].to(torch.int32)
    elif fault == "shape":
        named["b"] = torch.zeros(5, dtype=torch.bool)
    elif fault == "contiguous":
        named["a"] = torch.zeros((2, 3), dtype=torch.int64).T
    else:
        device = "meta"
    with pytest.raises(WhatifKernelError, match="a" if fault in (
            "dtype", "contiguous", "device") else "b"):
        wk.check(named, _SPECS, device)


def test_launch_guards_raise(worlds):
    """A planner-shaped launch that the kernels cannot take raises
    WhatifKernelError before anything is launched: a context table of the
    wrong dtype or shape or a strided one, more eviction words than a warp
    holds, and an input array of the wrong shape for the buffer."""
    rb, pb, rctx, pctx, rpa, ppa = worlds["plain"]
    tj = pctx.template_index(ppa)
    tab, d, any_f = pctx.tables(tj)
    with pytest.raises(WhatifKernelError, match="exceed"):
        wk.launch_dims(dict(d, R=wk.TEAM * wk.MAX_KW), 4, False, any_f)
    dims = wk.launch_dims(d, 4, False, any_f)
    specs = dict(wk._table_specs(dims), **wk._inv_specs(dims))
    wk.check(tab, specs, "cpu")
    for name, bad in (("alloc", tab["alloc"].to(torch.int32)),
                      ("f_pair_cn", tab["f_pair_cn"].T),
                      ("gate0", tab["gate0"][:-1])):
        with pytest.raises(WhatifKernelError, match=name):
            wk.check(dict(tab, **{name: bad}), specs, "cpu")
    rng = np.random.default_rng(2)
    v, nom, pre = _random_inputs(rng, rctx, rctx.np_slices(tj),
                                 rb.enc.host_snapshot(), 8, False, False)
    with pytest.raises(WhatifKernelError, match="v_valid"):
        wk.pack(v, nom, pre, dims, np.zeros(wk.layout(dims)[1], np.uint8))
