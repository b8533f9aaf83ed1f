"""HollowCluster: N hollow kubelets against one apiserver.

Reference: pkg/kubemark/hollow_kubelet.go (real kubelet, fake effectors)
and cmd/kubemark. Each hollow node shares one informer factory (one watch
stream per resource, fanned out to every kubelet's handlers — the same
shape as kubemark pods sharing an apiserver)."""

from __future__ import annotations

from typing import Dict, List, Optional

from ..client.informer import SharedInformerFactory
from ..kubelet.cri import FakeRuntimeService
from ..kubelet.kubelet import Kubelet, KubeletConfig


class HollowCluster:
    def __init__(
        self,
        clientset,
        n_nodes: int,
        node_name_prefix: str = "hollow",
        labels_for=None,  # (index) -> extra labels
        config_overrides: Optional[dict] = None,
    ):
        self.client = clientset
        self.factory = SharedInformerFactory(clientset)
        self.kubelets: List[Kubelet] = []
        self.runtimes: Dict[str, FakeRuntimeService] = {}
        overrides = config_overrides or {}
        for i in range(n_nodes):
            name = f"{node_name_prefix}-{i}"
            # per-node pod-IP range (the real CNI hands each node a podCIDR;
            # one shared prefix would collide pod IPs across nodes and break
            # endpoint/proxy state keyed by IP)
            runtime = FakeRuntimeService(ip_prefix=f"10.{64 + i // 256}.{i % 256}")
            cfg = KubeletConfig(
                node_name=name,
                labels=(labels_for(i) if labels_for else {}),
                **overrides,
            )
            kl = Kubelet(self.client, self.factory, config=cfg, runtime=runtime)
            self.kubelets.append(kl)
            self.runtimes[name] = runtime

    def start(self, wait_sync: float = 10.0) -> None:
        self.factory.start()
        if not self.factory.wait_for_cache_sync(wait_sync):
            raise RuntimeError("hollow cluster informers failed to sync")
        for kl in self.kubelets:
            kl.run()

    def stop(self) -> None:
        for kl in self.kubelets:
            kl.stop()
        self.factory.stop()
