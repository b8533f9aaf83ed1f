"""Client runtime: clientset, informers, workqueues, leader election.

The client-go equivalent (reference: staging/src/k8s.io/client-go) for the
in-process control plane: every component watches the apiserver through a
shared informer and reconciles through a rate-limited workqueue.
"""

from .clientset import Clientset  # noqa: F401
from .informer import Informer, SharedInformerFactory  # noqa: F401
from .workqueue import RateLimitingQueue  # noqa: F401
