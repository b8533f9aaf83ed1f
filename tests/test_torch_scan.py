"""ScanSession (the port's batched scheduling session and its scan_full
kernel, run here through the kernel's plain PyTorch version on the CPU)
against the reference: numpy statics equal PallasSession's, out rows
[:3, :n] and carries after every batch equal PallasSession in interpret
mode exactly, and decisions equal HoistedSession — on the session shapes
of tests/test_pallas_scan.py and three fuzzed clusters."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.hoisted import HoistedSession
from kubernetes_tpu.ops.pallas_scan import PallasSession, PallasUnsupported
from kubernetes_tpu_torch.models.encoding import cluster_from_numpy
from kubernetes_tpu_torch.ops import scan_kernel
from kubernetes_tpu_torch.ops.scan import (
    CARRY_KEYS,
    ScanSession,
    SessionUnsupported,
)

from .test_hoisted import _encode_all, _presized_encoding
from .test_torch_prologue import CASES, build_case
from .util import make_pod

STATICS = ("_alloc", "_stat", "_requested0", "_nzpc0", "_cnt_fn0",
           "_cnt_sn0", "_prow_f", "_prow_s", "_regrow_f", "_konn_f",
           "_konn_s", "_zvalid_node_s", "_zvalid_s", "_shasall", "_valid_n",
           "_scalars")


def _port_session(enc, templates, **kw):
    return ScanSession(cluster_from_numpy(enc.host_snapshot(), "cpu"),
                       templates, device="cpu", **kw)


@pytest.mark.parametrize("case", CASES)
def test_scan_session_equals_pallas_and_hoisted(case):
    enc, arrays, templates, batch = build_case(case)
    hs = HoistedSession(enc.device_state(), templates)
    ps = PallasSession(enc.device_state(), templates, interpret=True,
                       multipod_k=1)
    ss = _port_session(enc, templates)
    for k in STATICS:
        a, b = getattr(ps, k), getattr(ss, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    launches = scan_kernel.LAUNCHES
    got, ref = [], []
    for lo in range(0, len(arrays), batch):
        b = arrays[lo:lo + batch]
        n = len(b)
        yp, ys = ps.schedule(b), ss.schedule(b)
        rp, rs = np.asarray(yp["rows"]), ys["rows"].numpy()
        assert np.array_equal(rp[:3, :n], rs[:3, :n]), (lo, rp[:3, :n],
                                                         rs[:3, :n])
        for k in CARRY_KEYS:
            assert np.array_equal(np.asarray(ps._carry[k]),
                                  ss._carry[k].numpy()), (lo, k)
        got.extend(ScanSession.decisions(ys))
        ref.extend(HoistedSession.decisions(hs.schedule(b))[:n])
    assert got == ref
    # the CPU path runs the plain version: no kernel launch is counted
    assert scan_kernel.LAUNCHES == launches


def _unsupported_case(kind):
    from kubernetes_tpu.api import types as v1
    from kubernetes_tpu.testing.synth import synth_cluster, synth_pending_pods

    nodes, init_pods = synth_cluster(4, pods_per_node=1)
    pending = synth_pending_pods(4, spread=True)
    kw = {}
    if kind == "host-ports":
        pending = [make_pod(f"hp-{i}", cpu="10m", host_port=8080)
                   for i in range(2)]
    elif kind == "weights-exceed-f32":
        kw = {"weights": {"balanced": 1, "image": 1, "ipa": 1, "least": 1,
                          "node_affinity": 1, "prefer_avoid": 10 ** 6,
                          "pts": 2, "taint": 1}}
    elif kind == "affinity-terms":
        term = v1.PodAffinityTerm(
            label_selector=v1.LabelSelector(match_labels={"app": "a"}),
            topology_key=v1.LABEL_HOSTNAME)
        pending = [make_pod(f"aa-{i}", labels={"app": "a"},
                            affinity=v1.Affinity(
                                pod_anti_affinity=v1.PodAntiAffinity(
                                    required_during_scheduling_ignored_during_execution=[term])))
                   for i in range(2)]
    elif kind == "multipod":
        kw = {"multipod_k": 4}
    enc, pe = _presized_encoding(nodes, init_pods, pending)
    return enc, _encode_all(enc, pe, pending)[:1], kw


@pytest.mark.parametrize("kind", ["host-ports", "weights-exceed-f32"])
def test_unsupported_shape_reason_matches_pallas(kind):
    enc, templates, kw = _unsupported_case(kind)
    with pytest.raises(PallasUnsupported) as ref:
        PallasSession(enc.device_state(), templates, interpret=True, **kw)
    with pytest.raises(SessionUnsupported) as got:
        _port_session(enc, templates, **kw)
    assert got.value.reason == ref.value.reason == kind


@pytest.mark.parametrize("kind", ["affinity-terms", "multipod"])
def test_later_slice_shapes_raise(kind):
    enc, templates, kw = _unsupported_case(kind)
    with pytest.raises(SessionUnsupported) as got:
        _port_session(enc, templates, **kw)
    assert got.value.reason == kind


def test_scan_full_rejects_bad_inputs():
    enc, arrays, templates, batch = build_case("no_constraints")
    ss = _port_session(enc, templates)
    ys = ss.schedule(arrays[:batch])
    assert ys["rows"].dtype == torch.int32
    bad = {k: v.to(torch.int64) for k, v in ss._get_statics().items()}
    meta = torch.zeros(1 + 128, dtype=torch.int32)
    match = torch.zeros((128, 256), dtype=torch.int8)
    with pytest.raises(ValueError):
        scan_kernel.scan_full(meta, match, bad, ss._carry, ss.shapes,
                              (1,) * 8)


# f32 x in [0, 65536) where torch.log(x + 2) differs from jnp.log(x + 2)
# on the CPU (each by one ulp); the PTS score weight is log(n + 2)
LOG_DIFFS = frozenset((
    5, 45, 47, 177, 333, 381, 400, 427, 432, 624, 713, 714, 719, 728, 793,
    856, 1164, 1312, 1331, 1383, 1421, 1429, 1431, 1451, 1467, 1532, 1560,
    1575, 1577, 1753, 1779, 1880, 1915, 1948, 2313, 2434, 2479, 2502, 2524,
    2529, 2775, 2776, 2843, 2855, 2858, 2860, 2862, 2882, 2889, 2918, 3098,
    3278, 3397, 3466, 3623, 3731, 3769, 3797, 3826, 4350, 4469, 4751, 4933,
    5269, 5303, 5482, 5656, 5689, 5737, 5868, 5902, 5934, 6075, 6104, 6182,
    6195, 6254, 6277, 6342, 6364, 6404, 6421, 6519, 6589, 6747, 6776, 6779,
    6947, 7110, 7176, 7239, 7733, 8073, 8717, 8942, 9309, 9343, 9394, 9440,
    9547, 9740, 10119, 10511, 10652, 10674, 10679, 10910, 10962, 10997, 11080,
    11103, 11141, 11165, 11214, 11425, 11449, 11496, 11540, 11558, 11652,
    11775, 11820, 11834, 11851, 11875, 11934, 11972, 12012, 12020, 12025,
    12040, 12116, 12158, 12219, 12351, 12573, 12612, 12663, 12758, 12774,
    12797, 12813, 12972, 13118, 13261, 13718, 13921, 13975, 13983, 14092,
    14174, 14346, 14560, 14954, 15194, 15310, 17234, 17882, 18092, 18236,
    18516, 18752, 18817, 18912, 18968, 19172, 19304, 19583, 19707, 19827,
    19853, 19939, 20256, 20264, 20424, 20539, 20718, 20940, 20965, 20974,
    21020, 21082, 21151, 21173, 21187, 21189, 21218, 21244, 21262, 21331,
    21387, 21407, 21520, 21568, 21635, 21687, 21699, 21739, 21783, 21840,
    21841, 21842, 21844, 21845, 21886, 21948, 22053, 22134, 22276, 22317,
    22318, 22411, 22424, 22428, 22432, 22511, 22578, 22585, 22630, 22710,
    22749, 22911, 22941, 23088, 23224, 23351, 23382, 23472, 23475, 23500,
    23551, 23665, 23686, 23736, 23796, 23823, 23836, 23991, 24004, 24013,
    24083, 24173, 24208, 24345, 24401, 24402, 24511, 24563, 24637, 24694,
    24724, 24815, 24841, 24851, 24862, 25143, 25171, 25193, 25337, 25359,
    25408, 25524, 25539, 25607, 25622, 25705, 25896, 25965, 26140, 26209,
    26210, 26211, 26212, 26214, 26215, 26456, 26611, 26640, 26697, 26782,
    26945, 27094, 27113, 27165, 27492, 27527, 27969, 28008, 28055, 28105,
    28254, 28401, 28544, 28562, 28675, 28843, 28939, 28967, 29520, 29628,
    29888, 30013, 30273, 30362, 30391, 30514, 31430, 31459, 33451, 34137,
    34676, 34787, 35064, 35083, 35141, 35740, 35774, 35977, 36741, 36891,
    37052, 37493, 37689, 37911, 38004, 38044, 38117, 38427, 38541, 38556,
    38714, 38758, 38843, 39157, 39187, 39470, 39497, 39588, 39929, 40222,
    40372, 40518, 40675, 41346, 41443, 41492, 41699, 41706, 41805, 42120,
    42350, 42443, 42564, 42596, 42624, 42629, 42777, 42779, 42815, 42817,
    42859, 42872, 42943, 43049, 43066, 43069, 43114, 43177, 43253, 43373,
    43476, 43561, 43576, 43615, 43647, 43854, 43875, 43969, 43994, 44208,
    44222, 44249, 44262, 44281, 44346, 44433, 44438, 44637, 44707, 44764,
    44788, 44833, 44854, 44862, 44895, 44960, 44979, 45073, 45184, 45204,
    45236, 45259, 45341, 45441, 45512, 45545, 45632, 45665, 45687, 45688,
    45772, 45811, 45894, 45913, 45925, 45980, 46063, 46159, 46203, 46277,
    46344, 46383, 46425, 46472, 46510, 46555, 46588, 46610, 46681, 46746,
    46890, 46924, 47020, 47058, 47163, 47213, 47316, 47363, 47428, 47480,
    47537, 47556, 47579, 47613, 47742, 47765, 47853, 47994, 48054, 48065,
    48086, 48091, 48235, 48250, 48300, 48431, 48538, 48543, 48594, 48622,
    48638, 48693, 48805, 48900, 48963, 49015, 49073, 49084, 49115, 49216,
    49236, 49260, 49311, 49410, 49483, 49591, 49598, 49661, 49720, 49744,
    49757, 49826, 49969, 50056, 50089, 50278, 50341, 50380, 50401, 50406,
    50411, 50527, 50535, 50566, 50581, 50624, 50703, 50885, 50956, 50984,
    51232, 51269, 51512, 51604, 51636, 51861, 51875, 51919, 51973, 52028,
    52048, 52055, 52062, 52338, 52376, 52847, 52943, 53015, 53202, 53229,
    53271, 53595, 53692, 53880, 53913, 54008, 54101, 54203, 54361, 54493,
    54514, 54631, 54767, 54851, 54878, 54918, 55235, 55277, 55444, 55514,
    55660, 55881, 55906, 55938, 56104, 56148, 56196, 56275, 56477, 56540,
    56579, 56760, 57136, 57319, 57379, 57424, 57601, 57616, 57621, 58246,
    58247, 58258, 58823, 59192, 59621, 59645, 61044, 61263, 61329, 61373,
    61596, 61762, 62806, 62851, 63383,
))


def test_log_weights_against_reference():
    import jax.numpy as jnp

    x = np.arange(65536, dtype=np.float32)
    ref = np.asarray(jnp.log(jnp.asarray(x) + np.float32(2.0)))
    got = torch.log(torch.from_numpy(x) + 2.0).numpy()
    ulps = np.abs(ref.view(np.int32).astype(np.int64)
                  - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert set(np.nonzero(ulps)[0].tolist()) == LOG_DIFFS
