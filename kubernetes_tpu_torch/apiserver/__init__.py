"""In-process API server: typed REST semantics over the revisioned store.

Reference: staging/src/k8s.io/apiserver request path (pkg/endpoints/
handlers/{create,get,update,delete,watch}.go) + pkg/registry REST
strategies. See server.py.
"""

from .server import APIServer, Conflict, NotFound, AlreadyExists, WatchEvent  # noqa: F401
