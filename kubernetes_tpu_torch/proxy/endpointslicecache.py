"""EndpointSlice cache: merge a service's slices into one endpoint list.

Reference: pkg/proxy/endpointslicecache.go — EndpointSliceCache keeps
per-service slice info (updatePending/checkoutChanges) and
endpointInfoByServicePort (:204) flattens every tracked slice of a service
into per-port endpoint lists, deduplicating by address.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..api import discovery


@dataclass(frozen=True)
class EndpointInfo:
    ip: str
    port: int
    ready: bool
    node_name: str


class EndpointSliceCache:
    def __init__(self):
        self._lock = threading.Lock()
        # (namespace, service) -> {slice name -> EndpointSlice}
        self._slices: Dict[Tuple[str, str], Dict[str, discovery.EndpointSlice]] = {}

    @staticmethod
    def _service_key(sl: discovery.EndpointSlice) -> Optional[Tuple[str, str]]:
        svc = (sl.metadata.labels or {}).get(discovery.LABEL_SERVICE_NAME)
        if not svc:
            return None
        return (sl.metadata.namespace, svc)

    def update_slice(self, sl: discovery.EndpointSlice) -> None:
        key = self._service_key(sl)
        if key is None:
            return
        with self._lock:
            self._slices.setdefault(key, {})[sl.metadata.name] = sl

    def delete_slice(self, sl: discovery.EndpointSlice) -> None:
        key = self._service_key(sl)
        if key is None:
            return
        with self._lock:
            per_svc = self._slices.get(key)
            if per_svc is not None:
                per_svc.pop(sl.metadata.name, None)
                if not per_svc:
                    self._slices.pop(key, None)

    def endpoints_for(
        self, namespace: str, service: str, port_name: str
    ) -> List[EndpointInfo]:
        """Flattened, deduplicated endpoints of one service port
        (endpointInfoByServicePort)."""
        with self._lock:
            slices = list(self._slices.get((namespace, service), {}).values())
        seen = set()
        out: List[EndpointInfo] = []
        for sl in slices:
            port_num = None
            for p in sl.ports or []:
                if p.name == port_name:
                    port_num = p.port
                    break
            if port_num is None:
                continue
            for ep in sl.endpoints or []:
                for addr in ep.addresses:
                    if addr in seen:
                        continue
                    seen.add(addr)
                    out.append(
                        EndpointInfo(
                            ip=addr,
                            port=port_num,
                            ready=ep.conditions.ready,
                            node_name=ep.node_name,
                        )
                    )
        out.sort(key=lambda e: e.ip)
        return out
