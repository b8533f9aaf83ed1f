"""IPVS proxier mode.

Reference: pkg/proxy/ipvs/proxier.go — syncProxyRules (:1023) programs
the kernel's IP Virtual Server table: one virtual server per
(clusterIP/nodePort, port, protocol) with the service's ready endpoints
as real servers, scheduled by rr/wrr/lc/sh... (--ipvs-scheduler,
default rr); session affinity uses IPVS persistence (timeout per
virtual server). `IPVSTable` models that kernel table; `IPVSProxier`
is the same informer-driven resync loop as the iptables mode
(proxy/proxier.py) targeting the table instead of chains.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..client.informer import EventHandler
from .endpointslicecache import EndpointSliceCache
from .proxier import CLIENT_IP_DEFAULT_TIMEOUT, BoundedFrequencyRunner, Packet


@dataclass
class RealServer:
    ip: str
    port: int
    weight: int = 1
    active_conn: int = 0


@dataclass
class VirtualServer:
    ip: str
    port: int
    protocol: str = "TCP"
    scheduler: str = "rr"  # rr | lc (least-connection) | sh (source hash)
    persistence_seconds: float = 0.0  # >0 = ClientIP affinity
    reals: List[RealServer] = field(default_factory=list)
    _rr_index: int = 0


class IPVSTable:
    """In-memory IP Virtual Server table with scheduling semantics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._vs: Dict[Tuple[str, int, str], VirtualServer] = {}
        # persistence: (vs key, src ip) -> (real index key, stamp)
        self._affinity: Dict[Tuple, Tuple[Tuple[str, int], float]] = {}

    def replace(self, servers: List[VirtualServer]) -> None:
        with self._lock:
            new = {(v.ip, v.port, v.protocol): v for v in servers}
            # carry connection counts + rr position for unchanged servers
            for key, old in self._vs.items():
                cur = new.get(key)
                if cur is None:
                    continue
                cur._rr_index = old._rr_index
                by_addr = {(r.ip, r.port): r for r in cur.reals}
                for r in old.reals:
                    live = by_addr.get((r.ip, r.port))
                    if live is not None:
                        live.active_conn = r.active_conn
            self._vs = new
            live_keys = set(new)
            self._affinity = {
                k: v for k, v in self._affinity.items() if k[0] in live_keys
            }

    def virtual_servers(self) -> List[VirtualServer]:
        with self._lock:
            return list(self._vs.values())

    def route(self, pkt: Packet) -> Optional[Tuple[str, int]]:
        """Schedule one connection; None when no virtual server matches,
        ConnectionRefusedError when the VS has no real servers."""
        with self._lock:
            vs = self._vs.get((pkt.dst_ip, pkt.dst_port, pkt.protocol))
            if vs is None:
                return None
            if not vs.reals:
                raise ConnectionRefusedError(
                    f"{pkt.dst_ip}:{pkt.dst_port} has no real servers"
                )
            key = (pkt.dst_ip, pkt.dst_port, pkt.protocol)
            if vs.persistence_seconds > 0:
                hit = self._affinity.get((key, pkt.src_ip))
                if hit is not None and time.time() - hit[1] <= vs.persistence_seconds:
                    addr = hit[0]
                    real = next(
                        (r for r in vs.reals if (r.ip, r.port) == addr), None
                    )
                    if real is not None:
                        real.active_conn += 1
                        self._affinity[(key, pkt.src_ip)] = (addr, time.time())
                        return real.ip, real.port
            real = self._schedule(vs, pkt)
            real.active_conn += 1
            if vs.persistence_seconds > 0:
                self._affinity[(key, pkt.src_ip)] = (
                    (real.ip, real.port),
                    time.time(),
                )
            return real.ip, real.port

    @staticmethod
    def _schedule(vs: VirtualServer, pkt: Packet) -> RealServer:
        if vs.scheduler == "lc":
            return min(vs.reals, key=lambda r: (r.active_conn, r.ip))
        if vs.scheduler == "sh":
            return vs.reals[hash(pkt.src_ip) % len(vs.reals)]
        # rr
        real = vs.reals[vs._rr_index % len(vs.reals)]
        vs._rr_index += 1
        return real

    def conn_close(self, pkt_dst: Tuple[str, int, str], real: Tuple[str, int]) -> None:
        with self._lock:
            vs = self._vs.get(pkt_dst)
            if vs is None:
                return
            for r in vs.reals:
                if (r.ip, r.port) == real and r.active_conn > 0:
                    r.active_conn -= 1


class IPVSProxier:
    """Same resync loop as the iptables proxier, targeting IPVSTable."""

    def __init__(
        self,
        informer_factory,
        node_name: str = "",
        scheduler: str = "rr",
        min_sync_period: float = 0.0,
    ):
        self.node_name = node_name
        self.scheduler = scheduler
        self.table = IPVSTable()
        self.slice_cache = EndpointSliceCache()
        self._runner = BoundedFrequencyRunner(
            self._sync_proxy_rules_locked, min_sync_period
        )
        self.sync_count = 0
        self.svc_informer = informer_factory.informer_for("services")
        self.slice_informer = informer_factory.informer_for("endpointslices")
        self.svc_informer.add_event_handler(
            EventHandler(
                on_add=lambda s: self._runner.run(),
                on_update=lambda o, n: self._runner.run(),
                on_delete=lambda s: self._runner.run(),
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
        self._runner.run()

    def _on_slice_delete(self, sl) -> None:
        self.slice_cache.delete_slice(sl)
        self._runner.run()

    def sync_proxy_rules(self) -> None:
        self._runner.run_now()

    def _sync_proxy_rules_locked(self) -> None:
        servers: List[VirtualServer] = []
        for svc in self.svc_informer.list():
            if svc.spec.type == "ExternalName" or not svc.spec.cluster_ip:
                continue
            ns, name = svc.metadata.namespace, svc.metadata.name
            persistence = (
                CLIENT_IP_DEFAULT_TIMEOUT
                if svc.spec.session_affinity == "ClientIP"
                else 0.0
            )
            for port in svc.spec.ports or []:
                reals = [
                    RealServer(ip=e.ip, port=e.port)
                    for e in self.slice_cache.endpoints_for(ns, name, port.name)
                    if e.ready
                ]
                servers.append(
                    VirtualServer(
                        ip=svc.spec.cluster_ip,
                        port=port.port,
                        protocol=port.protocol,
                        scheduler=self.scheduler,
                        persistence_seconds=persistence,
                        reals=reals,
                    )
                )
                if (
                    svc.spec.type in ("NodePort", "LoadBalancer")
                    and port.node_port
                ):
                    # ipvs binds nodePorts on the node's own addresses;
                    # model with a wildcard node address
                    servers.append(
                        VirtualServer(
                            ip="0.0.0.0",
                            port=port.node_port,
                            protocol=port.protocol,
                            scheduler=self.scheduler,
                            persistence_seconds=persistence,
                            reals=[
                                RealServer(ip=r.ip, port=r.port) for r in reals
                            ],
                        )
                    )
        self.table.replace(servers)
        self.sync_count += 1

    def route(self, pkt: Packet) -> Tuple[str, int]:
        res = self.table.route(pkt)
        if res is None and pkt.dst_ip != "0.0.0.0":
            # nodePort fallthrough: any node address -> the 0.0.0.0 VS
            res = self.table.route(
                Packet("0.0.0.0", pkt.dst_port, pkt.protocol, pkt.src_ip)
            )
        if res is None:
            raise LookupError(f"no virtual server for {pkt.dst_ip}:{pkt.dst_port}")
        return res
