"""The delta mode's order-free formulation: `carry_delta_grouped` (the plain
PyTorch statement of the grid kernel `carry_delta_kernel` in
ops/csrc/scan_full.cu: per carry row, the sum over every event whose key
equals the lane's key, modulo 2**32) against `carry_delta_reference` (the
events one by one) and the reference's jnp program `_carry_delta_scan`,
bit for bit on every carry.

Inputs are made from a seed with numpy: events in their order and
permuted, many events on one node, pair id -1 lanes (on the event's node
and elsewhere), zero perno / s_src factors, payloads that wrap int32, and
single events; then the flushes of real sessions (test_torch_deltas.py's
FACTOR_CASES). The kernel itself runs on the card only, where chip_smoke.py
(phase 9) holds it to `carry_delta_reference` on the same kinds of flush."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.pallas_scan import _carry_delta_scan
from kubernetes_tpu_torch.ops import scan_kernel

from .test_torch_deltas import FACTOR_CASES, _case, _port_session
from .test_torch_deltas import _random_payload

CARRIES = ("requested", "nzpc", "cnt_fn", "cnt_sn")


def _synthetic(seed, E, Np=96, T=2, C=2, CP=4, R=3, Rp=8, SR=8):
    """(shapes, statics, carry, node, rows) of random int32 arrays: pair
    ids in [-1, 3) (a quarter of lanes -1), s_src rows with zeros, perno
    flags of both kinds, half the payload entries zero."""
    rng = np.random.default_rng(seed)
    TCp = T * CP
    sc = rng.integers(0, 3, scan_kernel.n_scalars(T, C, R, 0))
    off = T * (2 * R + 4) + scan_kernel.W_S_PERNO * T * C
    sc[off:off + T * C] = np.arange(T * C) % 2
    statics = {
        "scalars": sc.astype(np.int32),
        "stat": rng.integers(-2, 3, (T * SR, Np)).astype(np.int32),
        "prow_f": rng.integers(-1, 3, (TCp, Np)).astype(np.int32),
        "prow_s": rng.integers(-1, 3, (TCp, Np)).astype(np.int32),
    }
    carry = {k: rng.integers(-50, 50, (n, Np)).astype(np.int32)
             for k, n in zip(CARRIES, (Rp, 8, TCp, TCp))}
    node = rng.integers(0, Np, E).astype(np.int32)
    rows = rng.integers(-3, 4, (E, scan_kernel.delta_width(Rp, TCp)))
    rows[rng.random(rows.shape) < 0.5] = 0
    shapes = (T, C, Np, R, SR, TCp, 1, CP)
    return shapes, statics, carry, node, rows.astype(np.int32)


def _flush(kind, seed):
    """A FLUSHES entry's (shapes, statics, carry, node, rows, order):
    `order` permutes the events for carry_delta_grouped."""
    E = 1 if kind == "one event" else 160
    shapes, statics, carry, node, rows = _synthetic(seed, E)
    rng = np.random.default_rng(seed + 1)
    order = np.arange(E)
    if kind == "permuted":
        order = rng.permutation(E)
    elif kind == "one node":
        node[:] = node[0]
    elif kind == "pair -1 node":
        # every event on a node whose pair id is -1 in some rows
        lanes = np.flatnonzero((statics["prow_f"] < 0).any(axis=0)
                               & (statics["prow_s"] < 0).any(axis=0))
        node = rng.choice(lanes, E).astype(np.int32)
    elif kind == "zero factor":
        # s_src 0 on every node: the shared-key score rows get nothing
        statics["stat"][7::shapes[4]] = 0
    elif kind == "int32 wrap":
        rows = rng.integers(-2 ** 31, 2 ** 31, rows.shape,
                            dtype=np.int64).astype(np.int32)
        node = rng.integers(0, 3, E).astype(np.int32)
    return shapes, statics, carry, node, rows, order


def _jnp_flush(shapes, statics, carry, node, rows):
    """The reference's `_carry_delta_scan` on the same flush."""
    T, C, Np, R, SR, TCp, K, CP = shapes
    Rp = carry["requested"].shape[0]
    src_rows, perno_rows = scan_kernel.delta_factor_rows(
        {k: torch.from_numpy(v) for k, v in statics.items()}, shapes)
    xs = {"node": node, "dres": rows[:, :Rp], "dnzpc": rows[:, Rp:Rp + 8],
          "mf": rows[:, Rp + 8:Rp + 8 + TCp], "ms": rows[:, Rp + 8 + TCp:]}
    # fresh copies: the program donates its carry
    got = _carry_delta_scan(
        {k: jnp.asarray(carry[k].copy()) for k in CARRIES},
        jnp.asarray(statics["prow_f"]), jnp.asarray(statics["prow_s"]),
        jnp.asarray(src_rows.numpy()), jnp.asarray(perno_rows.numpy()),
        {k: jnp.asarray(v) for k, v in xs.items()})
    return {k: np.asarray(v) for k, v in got.items()}


def _torch_flush(fn, shapes, statics, carry, node, rows):
    out = {k: torch.from_numpy(v.copy()) for k, v in carry.items()}
    fn(torch.from_numpy(np.ascontiguousarray(node)),
       torch.from_numpy(np.ascontiguousarray(rows)),
       {k: torch.from_numpy(v) for k, v in statics.items()}, out, shapes)
    return {k: v.numpy() for k, v in out.items()}


FLUSHES = ("in order", "permuted", "one node", "pair -1 node",
           "zero factor", "int32 wrap", "one event")


@pytest.mark.parametrize("kind", FLUSHES)
def test_grouped_equals_sequential(kind):
    shapes, statics, carry, node, rows, order = _flush(kind, len(kind))
    ref = _torch_flush(scan_kernel.carry_delta_reference, shapes, statics,
                       carry, node, rows)
    grouped = _torch_flush(scan_kernel.carry_delta_grouped, shapes, statics,
                           carry, node[order], rows[order])
    want = _jnp_flush(shapes, statics, carry, node, rows)
    for k in CARRIES:
        assert np.array_equal(ref[k], want[k]), k
        assert np.array_equal(grouped[k], want[k]), k
    moved = [k for k in CARRIES if not np.array_equal(want[k], carry[k])]
    assert moved, "the flush moved no carry"
    if kind == "int32 wrap":
        wide = carry["requested"].astype(np.int64)
        np.add.at(wide.T, node, rows[:, :wide.shape[0]].astype(np.int64))
        assert ((wide < -2 ** 31) | (wide >= 2 ** 31)).any()
    if kind == "zero factor":
        # the shared-key score rows get nothing
        _, perno = scan_kernel.delta_factor_rows(
            {k: torch.from_numpy(v) for k, v in statics.items()}, shapes)
        still = (perno[:, 0] == 0).numpy()
        assert still.any()
        assert np.array_equal(want["cnt_sn"][still], carry["cnt_sn"][still])


@pytest.mark.parametrize("case", FACTOR_CASES)
def test_grouped_equals_sequential_on_sessions(case):
    """A real session's statics and carry, its flush permuted."""
    enc, templates = _case(case)
    ss = _port_session(enc.host_snapshot(), templates)
    rng = np.random.default_rng(len(case) + 7)
    node, rows = _random_payload(rng, ss, 48)
    statics = {k: ss._get_statics()[k].numpy()
               for k in ("scalars", "stat", "prow_f", "prow_s")}
    carry = {k: v.numpy() for k, v in ss._initial_carry().items()
             if k in CARRIES}
    order = rng.permutation(len(node))
    ref = _torch_flush(scan_kernel.carry_delta_reference, ss.shapes,
                       statics, carry, node, rows)
    grouped = _torch_flush(scan_kernel.carry_delta_grouped, ss.shapes,
                           statics, carry, node[order], rows[order])
    want = _jnp_flush(ss.shapes, statics, carry, node, rows)
    for k in CARRIES:
        assert np.array_equal(ref[k], want[k]), k
        assert np.array_equal(grouped[k], want[k]), k


def test_grouped_rejects_node_outside_axis():
    shapes, statics, carry, node, rows = _synthetic(0, 4)
    node[2] = shapes[2]
    with pytest.raises(ValueError):
        _torch_flush(scan_kernel.carry_delta_grouped, shapes, statics, carry,
                     node, rows)
