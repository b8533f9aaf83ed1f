from .proxier import Netfilter, Packet, Proxier
from .ipvs import IPVSProxier, IPVSTable
from .endpointslicecache import EndpointSliceCache

__all__ = [
    "Netfilter",
    "Packet",
    "Proxier",
    "IPVSProxier",
    "IPVSTable",
    "EndpointSliceCache",
]
