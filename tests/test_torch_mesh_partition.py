"""The port's node-axis placement (kubernetes_tpu_torch/parallel/) against
the reference's: the rule tables of parallel/partition.py, make_mesh,
pad_node_axis, shard_cluster and ShardedScheduler of parallel/sharded.py,
on the shapes of tests/test_mesh_partition.py.

A port mesh is a list of (device, shard count) groups held by one
process; the tests run both layouts on the CPU: one group of k shards,
and k one-shard groups on the same device (the cross-group path)."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.parallel import partition as ref_partition
from kubernetes_tpu.parallel.sharded import pad_node_axis as ref_pad
from kubernetes_tpu_torch.api import types as v1
from kubernetes_tpu_torch.ops.sharded_scan import ShardedScanSession
from kubernetes_tpu_torch.parallel.partition import (
    CLUSTER_PARTITION_RULES,
    NODE_AXIS,
    SESSION_PARTITION_RULES,
    P,
    match_partition_rules,
    pmax,
    psum,
    session_specs,
    shard_map_compat,
    shard_tree,
    tree_path_to_string,
    tree_paths,
)
from kubernetes_tpu_torch.parallel.sharded import (
    NODE_DIM0_KEYS,
    Mesh,
    ShardedScheduler,
    make_mesh,
    node_capacity_multiple,
    pad_node_axis,
    shard_cluster,
)
from kubernetes_tpu_torch.scheduler.internal.cache import SchedulerCache
from kubernetes_tpu_torch.scheduler.tpu_backend import TPUBackend

from .test_torch_encoding import _port_obj
from .util import make_node, make_pod


def meshes(nsh):
    """Both layouts of `nsh` shards on the CPU: one group, nsh groups."""
    out = [make_mesh(devices=["cpu"], n_devices=nsh)]
    if nsh > 1:
        out.append(make_mesh(devices=["cpu"] * nsh, n_devices=nsh))
    return out


def _backend(n_nodes=6, mesh=None, fill=True):
    cache = SchedulerCache()
    be = TPUBackend(mesh=mesh, device=None if mesh is not None else "cpu")
    cache.add_listener(be)
    for i in range(n_nodes):
        cache.add_node(_port_obj(make_node(
            f"node-{i}", cpu="8", memory="32Gi",
            labels={v1.LABEL_HOSTNAME: f"node-{i}"})))
    if fill:
        # every LIVE node carries allocation, so an all-zero padding row
        # would win the least-allocated leg if it ever reached scoring
        for i in range(n_nodes):
            cache.add_pod(_port_obj(make_pod(
                f"fill-{i}", namespace="default", cpu="2", memory="4Gi",
                labels={"app": "fill"}, node_name=f"node-{i}")))
    return cache, be


def _probe(be, name="probe"):
    return {k: va for k, va in be.pe.encode(_port_obj(make_pod(
        name, namespace="default", cpu="100m", memory="64Mi",
        labels={"app": "p"}))).items() if not k.startswith("_")}


def _host(cluster):
    return {k: v.numpy() for k, v in cluster.items()}


# ---------------------------------------------------------------- rules


class TestRuleTables:
    def test_tables_are_the_references(self):
        """Same regexes and specs, in order; the session table adds the
        port's zone-id row `zid` to the per-node statics."""
        got = [(r, tuple(s)) for r, s in CLUSTER_PARTITION_RULES]
        ref = ref_partition
        want = [(r, tuple(s)) for r, s in ref.CLUSTER_PARTITION_RULES]
        assert got == want
        got = [(r, tuple(s)) for r, s in SESSION_PARTITION_RULES]
        want = [(r, tuple(s)) for r, s in ref.SESSION_PARTITION_RULES]
        assert len(got) == len(want)
        for (gr, gs), (wr, ws) in zip(got, want):
            assert gs == ws
            assert gr == wr or gr == wr.replace("|prow_ipa)$",
                                                "|prow_ipa|zid)$"), (gr, wr)

    @pytest.mark.parametrize("name", [
        "carry/requested", "carry/kcnt", "statics/stat", "statics/onehot",
        "statics/zvalid_s_rows", "statics/prow_ipa", "statics/zid",
        "delta/src_rows", "delta/perno_rows", "tables/req", "xs/mf"])
    def test_session_specs_equal_reference(self, name):
        group, key = name.split("/")
        leaf = np.zeros((4, 8, 16), np.int32)
        got = session_specs(group, {key: leaf})[key]
        if key == "zid":  # the port's own row: split like every node row
            assert tuple(got) == (None, NODE_AXIS)
            return
        want = ref_partition.session_specs(group, {key: leaf})[key]
        assert tuple(got) == tuple(want)


class TestClusterRules:
    def test_rules_cover_every_device_state_leaf(self):
        """The port encoding's cluster dict is fully covered and its specs
        are the reference's for the same dict."""
        _, be = _backend()
        cluster = _host(be.enc.device_state("cpu"))
        specs = match_partition_rules(CLUSTER_PARTITION_RULES, cluster)
        want = ref_partition.match_partition_rules(
            ref_partition.CLUSTER_PARTITION_RULES, cluster)
        assert set(specs) == set(cluster)
        for k, spec in specs.items():
            assert tuple(spec) == tuple(want[k]), k
            if k in NODE_DIM0_KEYS:
                assert spec == P(NODE_AXIS), (k, spec)
            else:
                assert spec == P(), (k, spec)

    def test_unmatched_leaf_raises(self):
        with pytest.raises(ValueError, match="partition rule not found"):
            match_partition_rules(
                [("^valid$", P(NODE_AXIS))], {"mystery": np.zeros((8, 4))})

    def test_scalar_short_circuit(self):
        specs = match_partition_rules(
            [(".*", P(NODE_AXIS))],
            {"s": np.int32(3), "one": np.zeros((1,)), "v": np.zeros((8,)),
             "t": torch.zeros(1)})
        assert specs["s"] == P()
        assert specs["one"] == P()
        assert specs["t"] == P()
        assert specs["v"] == P(NODE_AXIS)

    def test_tree_path_to_string_nested(self):
        tree = {"a": {"b": [np.zeros(2), np.zeros(2)]}}
        paths = [tree_path_to_string(p) for p, _ in tree_paths(tree)]
        assert paths == ["a/b/0", "a/b/1"]


class TestSessionRules:
    @pytest.mark.parametrize("layout", [0, 1])
    def test_rules_cover_every_session_leaf(self, layout):
        """Every statics / delta / carry leaf of a live ShardedScanSession
        matches a rule, and every node-sharded leaf of a group holds its
        shards' lanes, k * Npl (Npl = Nps / nsh)."""
        mesh = meshes(8)[layout]
        _, be = _backend(n_nodes=19, mesh=mesh)
        sess = ShardedScanSession(be.enc.device_state("cpu"), [_probe(be)],
                                  be.weights, mesh=mesh)
        nsh = mesh.nsh
        assert sess.Nps == sess.Npl * nsh
        sharded = 0
        for g in sess._groups:
            tree = {"statics": {k: v for k, v in g.st.items()
                                if k not in ("zidx", "scalars")},
                    "delta": {"scalars": g.st["scalars"]},
                    "carry": g.carry}
            specs = match_partition_rules(SESSION_PARTITION_RULES, tree)
            for (path, arr), (_, spec) in zip(tree_paths(tree),
                                              tree_paths(specs)):
                name = tree_path_to_string(path)
                assert arr.device == g.device, name
                dim = spec.node_dim()
                if dim is None:
                    continue
                want = g.k if name == "carry/kcnt" else g.k * sess.Npl
                assert arr.shape[dim] == want, (name, arr.shape)
                sharded += 1
            assert session_specs("carry", g.carry) == specs["carry"]
        assert sharded >= len(sess._groups) * (len(sess._groups[0].carry)
                                                + 10)

    def test_session_rules_reject_unknown_group(self):
        with pytest.raises(ValueError, match="partition rule not found"):
            match_partition_rules(
                SESSION_PARTITION_RULES, {"mystery": {"x": np.zeros((8, 8))}})

    def test_shard_tree_cuts_and_copies(self):
        """Node-axis leaves are cut to each group's lanes in shard order,
        replicated leaves are whole; every piece is a copy."""
        mesh = Mesh([("cpu", 1), ("cpu", 2), ("cpu", 1)])
        a = np.arange(2 * 16, dtype=np.int32).reshape(2, 16)
        tree = {"carry": {"requested": a},
                "tables": {"req": np.ones((3, 2), np.int32)}}
        parts = shard_tree(tree, SESSION_PARTITION_RULES, mesh)
        assert [p["carry"]["requested"].shape[1] for p in parts] == [4, 8, 4]
        got = np.concatenate([p["carry"]["requested"].numpy()
                              for p in parts], axis=1)
        assert np.array_equal(got, a)
        for p in parts:
            assert p["tables"]["req"].shape == (3, 2)
        a[:] = 0
        assert parts[0]["carry"]["requested"].sum() > 0
        with pytest.raises(ValueError, match="does not divide"):
            shard_tree({"carry": {"x": np.zeros((2, 6))}},
                       SESSION_PARTITION_RULES, Mesh([("cpu", 4)]))


# ----------------------------------------------------------- make_mesh


class TestMakeMesh:
    def test_env_device_count(self, monkeypatch):
        monkeypatch.setenv("KTPU_MESH_DEVICES", "4")
        mesh = make_mesh(device="cpu")
        assert mesh.devices.size == mesh.nsh == 4
        assert mesh.axis_names == (NODE_AXIS,)
        assert len(mesh.groups) == 1 and mesh.n_devices == 1

    def test_env_zero_means_one_shard_per_device(self, monkeypatch):
        monkeypatch.setenv("KTPU_MESH_DEVICES", "0")
        assert make_mesh(devices=["cpu", "cpu"]).nsh == 2

    def test_explicit_count_wins(self, monkeypatch):
        monkeypatch.setenv("KTPU_MESH_DEVICES", "1")
        assert make_mesh(device="cpu", n_devices=2).devices.size == 2

    def test_layouts(self):
        """Shards over fewer devices spread, earlier groups first; a
        device listed k times makes k groups; shard count and device
        count are separate numbers."""
        m = make_mesh(devices=["cpu", "cpu", "cpu"], n_devices=8)
        assert [g.k for g in m.groups] == [3, 3, 2]
        assert [g.s0 for g in m.groups] == [0, 3, 6]
        assert (m.nsh, m.n_devices, m.layout) == (8, 1, "8x3@1")
        m = make_mesh(devices=["cpu"] * 8, n_devices=8)
        assert [g.k for g in m.groups] == [1] * 8
        assert m.lead == torch.device("cpu")
        assert node_capacity_multiple(m) == 8
        with pytest.raises(ValueError):
            make_mesh(device="cpu", n_devices=0)

    def test_no_cuda_raises_by_default(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(n_devices=2)

    def test_backend_mesh_device_must_be_lead(self):
        mesh = make_mesh(device="cpu", n_devices=2)
        be = TPUBackend(mesh=mesh, device="cpu")
        assert be.device == mesh.lead and be.use_kernel
        assert be.enc.node_quantum == 2
        with pytest.raises((ValueError, RuntimeError)):
            TPUBackend(mesh=mesh, device="cuda")


# ------------------------------------------------------- pad_node_axis


class TestPadNodeAxis:
    def _cluster(self, n):
        _, be = _backend(n_nodes=n, fill=False)
        return _host(be.enc.device_state("cpu"))

    def _same_as_reference(self, c, multiple, headroom=None):
        got = pad_node_axis(c, multiple, headroom=headroom)
        want = ref_pad(c, multiple, headroom=headroom)
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
        tc = pad_node_axis({k: torch.from_numpy(v) for k, v in c.items()},
                           multiple, headroom=headroom)
        for k in want:
            assert np.array_equal(tc[k].numpy(), np.asarray(want[k])), k
        return got

    def test_quantized_to_shard_multiple(self, monkeypatch):
        monkeypatch.delenv("KTPU_NODE_HEADROOM", raising=False)
        c = self._cluster(6)
        ncap = c["valid"].shape[0]
        out = self._same_as_reference(c, 8)
        want = -(-ncap // 8) * 8
        for k in NODE_DIM0_KEYS:
            assert out[k].shape[0] == want, k
        assert out["n_nodes"] is c["n_nodes"]

    def test_headroom_over_pads(self):
        c = self._cluster(6)
        ncap = c["valid"].shape[0]
        out = self._same_as_reference(c, 4, headroom=1.0)
        assert out["valid"].shape[0] == -(-(ncap * 2) // 4) * 4

    def test_already_aligned_is_identity(self):
        c = self._cluster(6)
        assert pad_node_axis(c, 1, headroom=0.0) is c

    def test_padding_rows_are_infeasible_zeros(self):
        c = self._cluster(6)
        ncap = c["valid"].shape[0]
        out = self._same_as_reference(c, 64)
        for k in NODE_DIM0_KEYS:
            assert not np.asarray(out[k][ncap:]).any(), k

    def test_env_headroom_applies(self, monkeypatch):
        monkeypatch.setenv("KTPU_NODE_HEADROOM", "0.5")
        c = self._cluster(6)
        ncap = c["valid"].shape[0]
        out = self._same_as_reference(c, 2)
        assert out["valid"].shape[0] == -(-int(np.ceil(ncap * 1.5)) // 2) * 2


# -------------------------------------------- padding never schedules


class TestPaddingExclusion:
    """Every live node carries allocation, so the all-zero padding rows
    would WIN the least-allocated leg if they ever reached scoring —
    `valid` stays False in the pad, at every shard count and layout."""

    @pytest.mark.parametrize("nsh", [2, 4, 8])
    def test_single_cycle_never_picks_padding(self, nsh):
        mesh = make_mesh(device="cpu", n_devices=nsh)
        _, be = _backend(n_nodes=5, fill=True)
        n_live = be.enc.n_nodes
        out = ShardedScheduler(mesh=mesh).schedule(
            dict(be.enc.device_state("cpu")), _probe(be))
        best = int(out["best_idx"])
        total = out["total"].numpy()
        assert total.shape[0] % nsh == 0
        assert best < n_live, (best, n_live)
        assert int(out["n_feasible"]) == n_live
        assert (total[n_live:] < total[best]).all()

    @pytest.mark.parametrize("nsh", [2, 4, 8])
    @pytest.mark.parametrize("layout", [0, 1])
    def test_session_never_picks_padding(self, nsh, layout):
        mesh = meshes(nsh)[layout]
        _, be = _backend(n_nodes=5, fill=True)
        n_live = be.enc.n_nodes
        arrays = [_probe(be, f"w-{i}") for i in range(6)]
        sess = ShardedScanSession(be.enc.device_state("cpu"), [arrays[0]],
                                  be.weights, mesh=mesh)
        assert sess.Nps >= n_live and sess.Nps % nsh == 0
        got = ShardedScanSession.decisions(sess.schedule(arrays))
        assert all(0 <= d < n_live for d in got), (got, n_live)

    def test_whole_shard_of_padding(self):
        """Headroom large enough that ENTIRE shards are fake nodes."""
        mesh = make_mesh(device="cpu", n_devices=8)
        _, be = _backend(n_nodes=3, fill=True)
        n_live = be.enc.n_nodes
        cluster = pad_node_axis(be.enc.device_state("cpu"),
                                node_capacity_multiple(mesh), headroom=4.0)
        assert cluster["valid"].shape[0] >= 5 * n_live
        out = ShardedScheduler(mesh=mesh).schedule(cluster, _probe(be))
        assert int(out["best_idx"]) < n_live
        assert int(out["n_feasible"]) == n_live

    def test_session_and_batch_on_the_lead_device(self):
        """ShardedScheduler's session and one-shot batch decide as the
        single-device HoistedSession does."""
        from kubernetes_tpu_torch.ops.hoisted import HoistedSession

        mesh = make_mesh(devices=["cpu"] * 4, n_devices=4)
        _, be = _backend(n_nodes=7, fill=True)
        arrays = [_probe(be, f"w-{i}") for i in range(9)]
        c = be.enc.device_state("cpu")
        want = HoistedSession.decisions(
            HoistedSession(c, [arrays[0]], be.weights,
                           device="cpu").schedule(arrays))
        ss = ShardedScheduler(mesh=mesh, weights=be.weights)
        s = ss.session(c, [arrays[0]])
        assert HoistedSession.decisions(s.schedule(arrays)) == want
        got, _ = ss.schedule_batch_hoisted(c, arrays)
        assert got[:len(arrays)] == want[:len(arrays)]


# ------------------------------------------------------ shard_map smoke


class TestShardMapCompat:
    @pytest.mark.parametrize("layout", [0, 1])
    def test_psum_over_node_axis(self, layout):
        mesh = meshes(8)[layout]
        x = torch.arange(16.0)

        def f(xs):
            return psum(xs.sum())

        f_sharded = shard_map_compat(f, mesh, in_specs=(P(NODE_AXIS),),
                                     out_specs=P())
        assert float(f_sharded(x)) == float(x.sum())

    def test_node_axis_out_and_pmax(self):
        mesh = meshes(4)[1]
        x = torch.arange(8)

        def f(xs):
            return xs + pmax(xs.max()), xs.max()

        out, m = shard_map_compat(f, mesh, in_specs=(P(NODE_AXIS),),
                                  out_specs=(P(NODE_AXIS), P()))(x)
        assert out.tolist() == (x + 7).tolist()
        assert int(m) == 1  # the lead group's own value

    def test_errors_propagate(self):
        mesh = meshes(2)[1]

        def f(xs):
            if int(xs[0]) > 0:
                raise KeyError("boom")
            return psum(xs.sum())

        with pytest.raises(KeyError):
            shard_map_compat(f, mesh, (P(NODE_AXIS),), P())(torch.arange(4))

    def test_shard_cluster_places_on_lead(self):
        mesh = make_mesh(device="cpu", n_devices=8)
        _, be = _backend(n_nodes=6, fill=False)
        c = shard_cluster(_host(be.enc.device_state("cpu")), mesh)
        for k in NODE_DIM0_KEYS:
            assert c[k].shape[0] % mesh.nsh == 0, k
        for v in c.values():
            assert isinstance(v, torch.Tensor) and v.device == mesh.lead
