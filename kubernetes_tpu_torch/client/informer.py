"""Informer machinery: Reflector list+watch → indexer cache → handlers.

Reference: staging/src/k8s.io/client-go/tools/cache —
Reflector.ListAndWatch (reflector.go:254): LIST at a consistent revision,
then WATCH from it, re-listing on compaction ("410 Gone"); DeltaFIFO →
handler distribution (shared_informer.go:368 Run); thread-safe store with
the same object-copy discipline.

Handlers run on the informer's single dispatch thread — ordering per
object is preserved, exactly as a processorListener delivers.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..api import types as v1
from ..store import kv
from .clientset import _ResourceClient


def meta_namespace_key(obj: Any) -> str:
    """cache.MetaNamespaceKeyFunc: 'namespace/name' or 'name'."""
    meta = obj.metadata
    if meta.namespace:
        return f"{meta.namespace}/{meta.name}"
    return meta.name


class EventHandler:
    """client-go ResourceEventHandlerFuncs."""

    def __init__(
        self,
        on_add: Optional[Callable[[Any], None]] = None,
        on_update: Optional[Callable[[Any, Any], None]] = None,
        on_delete: Optional[Callable[[Any], None]] = None,
    ):
        self.on_add = on_add
        self.on_update = on_update
        self.on_delete = on_delete


class Informer:
    """One resource's shared informer: local cache + event fan-out."""

    def __init__(self, client: _ResourceClient, namespace: Optional[str] = None):
        self._client = client
        self._namespace = namespace
        self._lock = threading.RLock()
        self._cache: Dict[str, Any] = {}
        self._handlers: List[EventHandler] = []
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watch = None

    # -- lister surface ----------------------------------------------------

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._cache.get(key)

    def list(self) -> List[Any]:
        with self._lock:
            return list(self._cache.values())

    def count(self) -> int:
        """O(1) store size — callers that only need a count must not pay
        a full list() copy on informer event threads."""
        with self._lock:
            return len(self._cache)

    def has_synced(self) -> bool:
        return self._synced.is_set()

    def event_handlers(self) -> List[EventHandler]:
        """Registered handlers (copy) — lets an owner diff registrations
        so it can retire a dead consumer's handlers (the supervisor does
        this when it rebuilds a crashed controller)."""
        with self._lock:
            return list(self._handlers)

    def add_event_handler(self, handler: EventHandler) -> None:
        with self._lock:
            self._handlers.append(handler)
            # late-joining handlers see the current cache as adds
            # (shared_informer.go:565 addListener semantics)
            if self._synced.is_set() and handler.on_add:
                for obj in self._cache.values():
                    handler.on_add(obj)

    def remove_event_handler(self, handler: EventHandler) -> None:
        """Deregister (client-go 2.26+ RemoveEventHandler): stopped
        consumers (e.g. a killed kubelet) must not stay fanned-out to."""
        with self._lock:
            try:
                self._handlers.remove(handler)
            except ValueError:
                pass

    # -- run loop ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._watch is not None:
            self._watch.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def wait_for_cache_sync(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                rev = self._list_and_sync()
                self._watch_loop(rev)
            except kv.Compacted:
                continue  # re-list (reflector.go 410-Gone path)
            except Exception:  # noqa: BLE001 — reflector.go retries with backoff
                if self._stop.is_set():
                    return
                import traceback

                traceback.print_exc()
                self._stop.wait(1.0)

    def _list_and_sync(self) -> int:
        items, rev = self._client.list(namespace=self._namespace)
        fresh = {meta_namespace_key(o): o for o in items}
        with self._lock:
            old = self._cache
            self._cache = fresh
            handlers = list(self._handlers)
            for key, obj in fresh.items():
                prev = old.get(key)
                for h in handlers:
                    if prev is None:
                        if h.on_add:
                            h.on_add(obj)
                    elif h.on_update:
                        h.on_update(prev, obj)
            for key, obj in old.items():
                if key not in fresh:
                    for h in handlers:
                        if h.on_delete:
                            h.on_delete(obj)
            self._synced.set()
        return rev

    def _watch_loop(self, rev: int) -> None:
        self._watch = self._client.watch(
            namespace=self._namespace, since_revision=rev
        )
        while not self._stop.is_set():
            ev = self._watch.poll(timeout=0.2)
            if ev is None:
                if self._stop.is_set():
                    return
                if getattr(self._watch, "closed", False):
                    # dead stream: return to _run, which re-lists and
                    # re-watches — reflector.go's ListAndWatch retry
                    # path. Both wire watches (HTTP disconnect, server
                    # restart) and in-proc watches (an apiserver crash
                    # stops every store watch marked closed) end here.
                    return
                continue
            key = meta_namespace_key(ev.object)
            with self._lock:
                handlers = list(self._handlers)
                if ev.type == kv.DELETED:
                    prev = self._cache.pop(key, None)
                    for h in handlers:
                        if h.on_delete:
                            h.on_delete(ev.object if prev is None else prev)
                else:
                    prev = self._cache.get(key)
                    self._cache[key] = ev.object
                    for h in handlers:
                        if prev is None:
                            if h.on_add:
                                h.on_add(ev.object)
                        elif h.on_update:
                            h.on_update(prev, ev.object)


class SharedInformerFactory:
    """informers.SharedInformerFactory: one informer per resource."""

    def __init__(self, clientset):
        self._clientset = clientset
        self._informers: Dict[str, Informer] = {}
        self._lock = threading.Lock()
        self._started = False

    def informer_for(self, resource: str) -> Informer:
        with self._lock:
            inf = self._informers.get(resource)
            if inf is None:
                client = getattr(self._clientset, resource, None)
                if client is None:
                    client = self._clientset.resource(resource)
                inf = Informer(client)
                self._informers[resource] = inf
                if self._started:
                    # factory already running: late informers start now
                    # (client-go requires a second Start() call; implicit
                    # here so consumers created after Run aren't silently
                    # cache-dead)
                    inf.start()
            return inf

    def informers(self) -> Dict[str, Informer]:
        """Current resource -> informer map (copy)."""
        with self._lock:
            return dict(self._informers)

    def pods(self) -> Informer:
        return self.informer_for("pods")

    def nodes(self) -> Informer:
        return self.informer_for("nodes")

    def start(self) -> None:
        with self._lock:
            self._started = True
            for inf in self._informers.values():
                inf.start()

    def stop(self) -> None:
        with self._lock:
            self._started = False
            for inf in self._informers.values():
                inf.stop()

    def wait_for_cache_sync(self, timeout: float = 10.0) -> bool:
        with self._lock:
            informers = list(self._informers.values())
        return all(inf.wait_for_cache_sync(timeout) for inf in informers)
