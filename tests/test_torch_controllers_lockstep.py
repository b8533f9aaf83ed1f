"""The second controller slice (ROADMAP.md Queue 1, 10b) feeds both
packages' schedulers the same way, on the CPU.

tests/test_torch_controllers.py's lock step (`_Lockstep`: the same
60-node, 3-zone seeded cluster, informers caught up, one controller key
at a time, one batch of every pending pod, a status writer, no
transition on the wall clock) gains the disruption controller, the
PersistentVolume binder and a StatefulSet controller with a claim
template (chip_smoke.py `claim_statefulset`: neither package's
StatefulSet has volumeClaimTemplates), synced one key at a time like the
others, and the horizontal pod autoscaler, whose periodic sync opens
each round. In each package:

- a Deployment of 120 zone-spread replicas (chip_smoke.py
  `web_deployment`) under a PodDisruptionBudget (minAvailable 90 %)
  rolls out; an HPA (target 100 % CPU, 120 to 180 replicas) whose
  metrics report 150 % for every pod scales it to 180, then at 50 % back
  to 120; one pod is then evicted through the apiserver (deleted once
  the budget allows a disruption) and its replacement re-binds;
- a 12-replica Parallel StatefulSet with a claim template binds against
  12 pre-created zonal volumes (node affinity on the zone label, a
  StorageClass that binds at once).

The packages must agree on (a) each scale's per-node pod counts, (b) the
budget's status after each scale and after the eviction, and (c) each
claim's volume and each StatefulSet pod's node, every pod in its
volume's zone."""

from __future__ import annotations

import importlib

import pytest

import chip_smoke

from . import test_torch_controllers as base

HPA_MAX = 180
HPA_TARGET = 100
LOAD_UP, LOAD_DOWN = 150, 50       # % of the target: ceil(1.5 * 120) = 180
PDB_MIN = "90%"
SS_REPLICAS = 12
ZONES = ("zone-0", "zone-1", "zone-2")


class _Run:
    """One package's 10b scenario on `base._Lockstep`."""

    def __init__(self, port: bool):
        self.load = LOAD_UP
        self.package = base.PACKAGES[1] if port else base.PACKAGES[0]
        self.ls = base._Lockstep(port, extra=self._extra)

    def _mod(self, name):
        return importlib.import_module(f"{self.package}.{name}")

    def _extra(self, ls):
        server = ls.m.apiserver_server
        ss = chip_smoke.claim_statefulset(
            self._mod("controllers.statefulset").StatefulSetController,
            ls.m.api_types, server.AlreadyExists)
        self.hpa = self._mod("controllers.podautoscaler").HorizontalController(
            ls.cs, ls.factory, metrics=lambda pod: self.load)
        return {
            "statefulset": ss(ls.cs, ls.factory),
            "pv-binder": self._mod(
                "controllers.persistentvolume").PersistentVolumeController(
                ls.cs, ls.factory),
            "disruption": self._mod(
                "controllers.disruption").DisruptionController(
                ls.cs, ls.factory),
        }

    def hpa_round(self):
        """The HPA's periodic sync. -> 1 when it moved the Deployment."""
        before = self.ls.cs.deployments.get("web", "default").spec.replicas
        self.hpa.sync_all()
        self.ls.settle()
        return int(self.ls.cs.deployments.get(
            "web", "default").spec.replicas != before)

    def pdb(self):
        s = self.ls.cs.resource("poddisruptionbudgets").get(
            "web", "default").status
        return (s.disruptions_allowed, s.current_healthy, s.desired_healthy)

    def web_at(self, n):
        ls = self.ls
        return ls.available("v1", n) and sum(
            p.metadata.labels.get("app") == "web"
            for p in ls.cs.pods.list(namespace="default")[0]) == n

    def scale(self):
        """(counts, budget status) at 120, after the HPA's scale to 180
        and after its scale back to 120."""
        ls, v1 = self.ls, self.ls.m.api_types
        auto = self._mod("api.autoscaling")
        ls.cs.resource("poddisruptionbudgets").create(v1.PodDisruptionBudget(
            metadata=v1.ObjectMeta(name="web", namespace="default"),
            spec=v1.PodDisruptionBudgetSpec(
                min_available=PDB_MIN,
                selector=v1.LabelSelector(match_labels={"app": "web"}))))
        ls.cs.deployments.create(chip_smoke.web_deployment(
            v1, ls.m.api_apps, "web", base.REPLICAS, "v1", "web:1"))
        ls.run_until(lambda: self.web_at(base.REPLICAS))
        out = [(self.web_counts(), self.pdb())]
        ls.cs.resource("horizontalpodautoscalers").create(
            auto.HorizontalPodAutoscaler(
                metadata=v1.ObjectMeta(name="web", namespace="default"),
                spec=auto.HorizontalPodAutoscalerSpec(
                    scale_target_ref=auto.CrossVersionObjectReference(
                        kind="Deployment", name="web"),
                    min_replicas=base.REPLICAS, max_replicas=HPA_MAX,
                    target_cpu_utilization_percentage=HPA_TARGET)))
        ls.run_until(lambda: self.web_at(HPA_MAX), periodic=self.hpa_round)
        out.append((self.web_counts(), self.pdb()))
        self.load = LOAD_DOWN
        ls.run_until(lambda: self.web_at(base.REPLICAS),
                     periodic=self.hpa_round)
        out.append((self.web_counts(), self.pdb()))
        return out

    def web_counts(self):
        return self.ls.counts()["v1"]

    def evict(self):
        """One web pod evicted through the apiserver: the one on the
        lowest-numbered node (the oldest there), deleted once the budget
        allows a disruption. -> (its node, the budget once the disruption
        controller saw the delete, the budget and counts after the
        replacement is Ready)."""
        ls = self.ls
        pods = [p for p in ls.cs.pods.list(namespace="default")[0]
                if p.metadata.labels.get("app") == "web"]
        victim = min(pods, key=lambda p: (
            int(p.spec.node_name.split("-")[1]),
            p.metadata.creation_timestamp))
        ls.settle()
        assert self.pdb()[0] >= 1
        ls.cs.pods.delete(victim.metadata.name, "default")
        ls.settle()
        disruption = ls.extra["disruption"]
        while ls.sync_one(disruption):
            ls.settle()
        seen = self.pdb()
        ls.run_until(lambda: self.web_at(base.REPLICAS))
        return victim.spec.node_name, seen, self.pdb(), self.web_counts()

    def volumes(self):
        """The StatefulSet against the zonal volumes. -> ({claim: volume},
        {pod: node}, {volume: zone})."""
        ls, v1 = self.ls, self.ls.m.api_types
        sc, pvs = chip_smoke.zonal_volumes(
            v1, self._mod("api.storage"), SS_REPLICAS, ZONES)
        ls.cs.storageclasses.create(sc)
        for pv in pvs:
            ls.cs.persistentvolumes.create(pv)
        ls.cs.statefulsets.create(chip_smoke.claim_set(
            v1, ls.m.api_apps, "db", SS_REPLICAS, {"app": "db"}))

        def ready():
            pods = [p for p in ls.cs.pods.list(namespace="default")[0]
                    if p.metadata.labels.get("app") == "db"]
            return len(pods) == SS_REPLICAS and all(
                p.status.phase == "Running" for p in pods)

        ls.run_until(ready)
        claims = {c.metadata.name: c.spec.volume_name for c in
                  ls.cs.persistentvolumeclaims.list(namespace="default")[0]}
        nodes = {p.metadata.name: p.spec.node_name
                 for p in ls.cs.pods.list(namespace="default")[0]
                 if p.metadata.labels.get("app") == "db"}
        zone_of = {pv.metadata.name: pv.spec.node_affinity.required
                   .node_selector_terms[0].match_expressions[0].values[0]
                   for pv in pvs}
        return claims, nodes, zone_of


_RESULTS = {}


def _scenario(port):
    if port not in _RESULTS:
        run = _Run(port)
        try:
            scaled = run.scale()
            evicted = run.evict()
            claims, nodes, zone_of = run.volumes()
            _RESULTS[port] = dict(scaled=scaled, evicted=evicted,
                                  claims=claims, nodes=nodes,
                                  zone_of=zone_of,
                                  batches=list(run.ls.batches),
                                  builds=list(run.ls.builds))
        finally:
            run.ls.close()
    return _RESULTS[port]


@pytest.fixture(scope="module")
def both():
    return _scenario(False), _scenario(True)


def test_hpa_scales_as_reference(both):
    """(a) The per-node counts at 120, after the HPA's scale to 180 and
    after its scale back to 120 equal the reference's; each within the
    zone spread's maxSkew."""
    ref, got = both
    for (r_counts, _), (g_counts, _), want in zip(
            ref["scaled"], got["scaled"],
            (base.REPLICAS, HPA_MAX, base.REPLICAS)):
        assert g_counts == r_counts
        assert sum(g_counts.values()) == want
        assert base._zone_skew(g_counts) <= 1


def test_pdb_status_as_reference(both):
    """(b) The budget's (disruptions allowed, current healthy, desired
    healthy) after each scale and after the eviction equal the
    reference's and what minAvailable 90 % of the Ready pods gives."""
    ref, got = both
    statuses = [s for _, s in got["scaled"]]
    assert statuses == [s for _, s in ref["scaled"]]
    assert statuses == [(12, 120, 108), (18, 180, 162), (12, 120, 108)]
    node, seen, after, counts = got["evicted"]
    assert (node, seen, after) == ref["evicted"][:3]
    assert seen == (11, 119, 108)
    assert after == (12, 120, 108)
    assert counts == ref["evicted"][3]
    assert sum(counts.values()) == base.REPLICAS


def test_statefulset_volumes_as_reference(both):
    """(c) Each claim's volume and each pod's node equal the reference's;
    every pod sits in its volume's zone."""
    ref, got = both
    assert got["claims"] == ref["claims"]
    assert got["nodes"] == ref["nodes"]
    assert len(got["nodes"]) == SS_REPLICAS
    for pod, node in got["nodes"].items():
        pv = got["claims"][f"data-{pod}"]
        assert pv
        assert f"zone-{int(node.split('-')[1]) % 3}" == got["zone_of"][pv]


def test_every_batch_rode_the_device_rung(both):
    """Both packages scheduled the same batches, every one on their
    backend's device session: the lock step asserts that no batch moved
    the ladder, and each session built is the device rung's."""
    ref, got = both
    assert got["batches"] == ref["batches"]
    assert sum(got["batches"]) == base.REPLICAS + (HPA_MAX - base.REPLICAS) \
        + 1 + SS_REPLICAS
    assert set(got["builds"]) == {"ScanSession"}
    assert set(ref["builds"]) == {"HoistedSession"}
