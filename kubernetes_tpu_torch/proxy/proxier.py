"""Service data plane: the kube-proxy equivalent.

Reference: pkg/proxy/iptables/proxier.go — syncProxyRules (:814) is a
full-state resync: walk every service port, synthesize the chain graph

    PREROUTING -> KUBE-SERVICES -> KUBE-SVC-<hash> (per service port)
                    -> [affinity] KUBE-SEP-<hash> via recent-match
                    -> statistic random 1/n -> KUBE-SEP-<hash> (DNAT)
    KUBE-NODEPORTS -> KUBE-SVC-<hash>   (NodePort services)
    REJECT for service ports with no ready endpoints

and restore it atomically. The kernel's netfilter is native surface the
TPU build can't inherit (SURVEY §2.4.3); `Netfilter` here is a faithful
in-memory model of the chain semantics (first-match, jumps, statistic
random, recent/affinity) so the routing behavior — VIP -> backend
selection, session affinity, nodePorts, REJECT on empty — is testable
and hollow nodes get a real data path.

Endpoint state comes from EndpointSlices via EndpointSliceCache
(pkg/proxy/endpointslicecache.go), services from the service informer;
sync is event-driven with a min-interval, like the reference's
async.BoundedFrequencyRunner (proxier.go:788).
"""

from __future__ import annotations

import hashlib
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..client.informer import EventHandler
from .endpointslicecache import EndpointSliceCache

CLIENT_IP_DEFAULT_TIMEOUT = 10800.0  # core/v1 DefaultClientIPServiceAffinitySeconds


@dataclass(frozen=True)
class Packet:
    dst_ip: str
    dst_port: int
    protocol: str = "TCP"
    src_ip: str = ""


@dataclass
class Rule:
    """One iptables rule: match fields -> target.

    target is a chain name (jump), ("DNAT", ip, port), or "REJECT".
    probability models `-m statistic --mode random --probability p`;
    affinity_check models `-m recent --rcheck` against the service
    chain's bucket.
    """

    target: object
    dst_ip: Optional[str] = None
    dst_port: Optional[int] = None
    protocol: Optional[str] = None
    probability: Optional[float] = None
    affinity_check: bool = False


@dataclass
class Chain:
    name: str
    rules: List[Rule] = field(default_factory=list)
    records_affinity: bool = False  # service chain with ClientIP affinity


class Netfilter:
    """In-memory chain evaluator with first-match + jump semantics."""

    def __init__(self, rng: Optional[random.Random] = None):
        self.chains: Dict[str, Chain] = {}
        self._rng = rng or random.Random(0)
        # affinity buckets: (svc chain, src_ip) -> (sep chain, stamp)
        self._recent: Dict[Tuple[str, str], Tuple[str, float]] = {}
        self._affinity_timeout = CLIENT_IP_DEFAULT_TIMEOUT
        self._lock = threading.Lock()

    def replace(self, chains: Dict[str, Chain], affinity_timeout: float) -> None:
        """Atomic rule swap (iptables-restore)."""
        with self._lock:
            self.chains = chains
            self._affinity_timeout = affinity_timeout
            live = set(chains)
            self._recent = {k: v for k, v in self._recent.items() if k[0] in live}

    def route(self, pkt: Packet) -> Optional[Tuple[str, int]]:
        """Evaluate a packet from KUBE-SERVICES. Returns the DNAT
        destination (ip, port) or None for no match (pass through);
        raises ConnectionRefusedError for REJECT. Updates the affinity
        bucket when a ClientIP service chain is traversed."""
        with self._lock:
            path: List[Tuple[str, str]] = []  # (chain, chosen sep) markers
            res = self._eval_chain("KUBE-SERVICES", pkt, 0, path)
            if res is not None:
                for chain_name, sep in path:
                    self._recent[(chain_name, pkt.src_ip)] = (sep, time.time())
            return res

    def _eval_chain(self, name: str, pkt: Packet, depth: int, path) -> Optional[Tuple[str, int]]:
        if depth > 16:  # kernel max chain-jump depth analog
            return None
        chain = self.chains.get(name)
        if chain is None:
            return None
        for rule in chain.rules:
            if rule.dst_ip is not None and rule.dst_ip != pkt.dst_ip:
                continue
            if rule.dst_port is not None and rule.dst_port != pkt.dst_port:
                continue
            if rule.protocol is not None and rule.protocol != pkt.protocol:
                continue
            if rule.affinity_check:
                hit = self._recent.get((name, pkt.src_ip))
                if hit is None or time.time() - hit[1] > self._affinity_timeout:
                    continue
                res = self._eval_chain(hit[0], pkt, depth + 1, path)
                if res is not None:
                    path.append((name, hit[0]))
                    return res
                continue
            if rule.probability is not None and self._rng.random() >= rule.probability:
                continue
            if rule.target == "REJECT":
                raise ConnectionRefusedError(f"{pkt.dst_ip}:{pkt.dst_port} rejected")
            if isinstance(rule.target, tuple) and rule.target[0] == "DNAT":
                return rule.target[1], rule.target[2]
            res = self._eval_chain(rule.target, pkt, depth + 1, path)
            if res is not None:
                if chain.records_affinity and isinstance(rule.target, str):
                    path.append((name, rule.target))  # svc chain -> chosen sep
                return res
        return None


def _chain_hash(*parts: str) -> str:
    return hashlib.sha256("/".join(parts).encode()).hexdigest()[:16].upper()


class BoundedFrequencyRunner:
    """Serialize + rate-limit a sync function (the reference's
    async.BoundedFrequencyRunner): immediate run when outside the
    min interval, one deferred timer-run otherwise. Shared by the
    iptables and ipvs proxier modes."""

    def __init__(self, fn, min_interval: float = 0.0):
        self._fn = fn
        self._min = min_interval
        self._lock = threading.Lock()
        self._mutex = threading.Lock()  # serializes fn itself
        self._last = 0.0
        self._pending = False

    def run(self) -> None:
        with self._lock:
            now = time.time()
            if self._min and now - self._last < self._min:
                if not self._pending:
                    self._pending = True
                    delay = max(0.0, self._min - (now - self._last))
                    timer = threading.Timer(delay, self.flush)
                    timer.daemon = True
                    timer.start()
                return
            self._last = now
        with self._mutex:
            self._fn()

    def flush(self) -> None:
        with self._lock:
            if not self._pending:
                return
            self._pending = False
            self._last = time.time()
        with self._mutex:
            self._fn()

    def run_now(self) -> None:
        """Unconditional serialized run (tests / manual resync)."""
        with self._lock:
            self._last = time.time()
        with self._mutex:
            self._fn()


class Proxier:
    """Per-node proxy: informers -> Netfilter rule graph.

    Reference: pkg/proxy/iptables/proxier.go NewProxier + syncProxyRules;
    the reference's ServiceChangeTracker/EndpointChangeTracker feed the
    same full-state walk this performs straight from the informer caches.
    """

    def __init__(
        self,
        informer_factory,
        node_name: str = "",
        min_sync_period: float = 0.0,
        rng: Optional[random.Random] = None,
    ):
        self.node_name = node_name
        self.netfilter = Netfilter(rng=rng)
        self.slice_cache = EndpointSliceCache()
        # serializes rule synthesis (service and slice events arrive on
        # different informer dispatch threads; an older-snapshot sync must
        # not finish last and clobber newer rules) and rate-limits it
        self._runner = BoundedFrequencyRunner(
            self._sync_proxy_rules_locked, min_sync_period
        )
        self.sync_count = 0
        self.svc_informer = informer_factory.informer_for("services")
        self.slice_informer = informer_factory.informer_for("endpointslices")
        self.svc_informer.add_event_handler(
            EventHandler(
                on_add=lambda s: self._schedule_sync(),
                on_update=lambda o, n: self._schedule_sync(),
                on_delete=lambda s: self._schedule_sync(),
            )
        )
        self.slice_informer.add_event_handler(
            EventHandler(
                on_add=self._on_slice,
                on_update=lambda o, n: self._on_slice(n),
                on_delete=self._on_slice_delete,
            )
        )

    def _on_slice(self, sl) -> None:
        self.slice_cache.update_slice(sl)
        self._schedule_sync()

    def _on_slice_delete(self, sl) -> None:
        self.slice_cache.delete_slice(sl)
        self._schedule_sync()

    def _schedule_sync(self) -> None:
        self._runner.run()

    def flush_pending(self) -> None:
        """Run a sync if one was rate-limited (BoundedFrequencyRunner tick)."""
        self._runner.flush()

    # -- the resync ---------------------------------------------------------

    def sync_proxy_rules(self) -> None:
        self._runner.run_now()

    def _sync_proxy_rules_locked(self) -> None:
        chains: Dict[str, Chain] = {}
        services = Chain("KUBE-SERVICES")
        nodeports = Chain("KUBE-NODEPORTS")
        chains[services.name] = services
        chains[nodeports.name] = nodeports
        for svc in sorted(
            self.svc_informer.list(),
            key=lambda s: (s.metadata.namespace, s.metadata.name),
        ):
            if svc.spec.type == "ExternalName" or not svc.spec.cluster_ip:
                continue
            ns, name = svc.metadata.namespace, svc.metadata.name
            use_affinity = svc.spec.session_affinity == "ClientIP"
            for port in svc.spec.ports or []:
                svc_chain = f"KUBE-SVC-{_chain_hash(ns, name, port.name, port.protocol)}"
                eps = [
                    e
                    for e in self.slice_cache.endpoints_for(ns, name, port.name)
                    if e.ready
                ]
                is_nodeport = (
                    svc.spec.type in ("NodePort", "LoadBalancer") and port.node_port
                )
                if not eps:
                    # no ready endpoints: REJECT (proxier.go:1078, filter table)
                    services.rules.append(
                        Rule(
                            target="REJECT",
                            dst_ip=svc.spec.cluster_ip,
                            dst_port=port.port,
                            protocol=port.protocol,
                        )
                    )
                    if is_nodeport:
                        nodeports.rules.append(
                            Rule(
                                target="REJECT",
                                dst_port=port.node_port,
                                protocol=port.protocol,
                            )
                        )
                    continue
                svc_rules: List[Rule] = []
                if use_affinity:
                    svc_rules.append(Rule(target=None, affinity_check=True))
                for i, ep in enumerate(eps):
                    sep = f"KUBE-SEP-{_chain_hash(ns, name, port.name, ep.ip, str(ep.port))}"
                    chains[sep] = Chain(sep, [Rule(target=("DNAT", ep.ip, ep.port))])
                    remaining = len(eps) - i
                    # statistic-random cascade: P(k) = 1/(n-k) yields uniform
                    # selection across endpoints (proxier.go:1540)
                    svc_rules.append(
                        Rule(
                            target=sep,
                            probability=(1.0 / remaining) if remaining > 1 else None,
                        )
                    )
                chains[svc_chain] = Chain(
                    svc_chain, svc_rules, records_affinity=use_affinity
                )
                services.rules.append(
                    Rule(
                        target=svc_chain,
                        dst_ip=svc.spec.cluster_ip,
                        dst_port=port.port,
                        protocol=port.protocol,
                    )
                )
                if is_nodeport:
                    nodeports.rules.append(
                        Rule(
                            target=svc_chain,
                            dst_port=port.node_port,
                            protocol=port.protocol,
                        )
                    )
        # KUBE-SERVICES falls through to KUBE-NODEPORTS last (proxier.go:1292)
        services.rules.append(Rule(target="KUBE-NODEPORTS"))
        self.netfilter.replace(chains, CLIENT_IP_DEFAULT_TIMEOUT)
        self.sync_count += 1

    # -- client surface (the "kernel" path) ---------------------------------

    def route(self, pkt: Packet) -> Tuple[str, int]:
        """Route a flow; raises ConnectionRefusedError on REJECT and
        LookupError when no rule matches. Returns the DNAT (pod_ip, port)."""
        res = self.netfilter.route(pkt)
        if res is None:
            raise LookupError(f"no service rule for {pkt.dst_ip}:{pkt.dst_port}")
        return res
