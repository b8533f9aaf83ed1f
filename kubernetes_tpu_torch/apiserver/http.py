"""The apiserver's HTTP wire: REST verbs + streaming watch + bearer authn.

The reference's defining process boundary is HTTP — route install
(reference: staging/src/k8s.io/apiserver/pkg/endpoints/installer.go:190
registerResourceHandlers), the secured handler chain
(pkg/server/config.go:719 DefaultBuildHandlerChain), and chunked
streaming watch (pkg/endpoints/handlers/watch.go). This module provides
both ends of that boundary for the TPU build:

  HTTPAPIServer   serves an APIServer (or SecureAPIServer) over real
                  sockets: /api/v1 and /apis/{group}/{version} routes,
                  JSON bodies, `?watch=true` chunked event streams,
                  Bearer-token authentication when secured.
  RemoteAPIServer an APIServer-compatible client over the wire: the same
                  surface Clientset/informers/kubectl consume in-proc,
                  so every component can connect via HTTP unchanged.

Paths follow the reference's shape:
  /api/v1/namespaces/{ns}/{resource}[/{name}[/{subresource}]]
  /api/v1/{resource}[/{name}[/{subresource}]]          (cluster-scoped)
  /apis/{group}/{version}/...                          (same tail)
Subresources: status (PUT), binding (POST, pods), finalize (PUT),
log (GET, pods), exec (POST, pods).

The in-proc path stays for unit-test speed; this wire is what
tests/test_http_apiserver.py's end-to-end slice runs every component
over.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from ..api import types as v1
from ..store import kv, wal
from ..utils import knobs, serde
from ..utils.metrics import Counter, Gauge, Histogram, legacy_registry
from .server import APIError, APIServer, NotFound, ResourceInfo, WatchEvent

watch_evictions = legacy_registry.register(
    Counter(
        "apiserver_watch_evictions_total",
        "Watch streams force-closed because the client could not drain "
        "its bounded send buffer (bytes over KTPU_WATCH_BUFFER, or no "
        "socket-write progress for KTPU_WATCH_EVICT_AFTER seconds with "
        "frames queued). Slow-consumer backpressure: one wedged reader "
        "must not block the hub's event fan-out, and the hard close is "
        "safe — the client's reflector sees EOF (RemoteWatch.closed) and "
        "recovers via re-list+re-watch. A sustained rate here names a "
        "consumer that cannot keep up with the event volume.",
        (),
    )
)
watchers_gauge = legacy_registry.register(
    Gauge(
        "apiserver_watchers",
        "Chunked watch streams currently being served across this "
        "process's HTTP apiservers (per-hub counts are on "
        "HTTPAPIServer.watcher_count). The endurance soak's leak "
        "invariant expects this to return to baseline after chaos.",
        (),
    )
)
watch_delivery = legacy_registry.register(
    Histogram(
        "apiserver_watch_delivery_seconds",
        "Event-ready to socket-write latency per watch frame: stamped "
        "when the producer loop pulls the event batch off the store "
        "hub, observed on the writer thread AFTER the chunked write "
        "flushes. Heartbeats are excluded — this is the event SLI the "
        "wire open item needs a p99 for, and a rising tail here (with "
        "apiserver_watch_buffer_depth climbing) names a consumer "
        "drifting toward eviction before it crosses the threshold.",
        (),
        buckets=tuple(0.0001 * 2 ** i for i in range(20)),
    )
)
watch_buffer_depth = legacy_registry.register(
    Gauge(
        "apiserver_watch_buffer_depth",
        "Frames queued in one watcher's bounded send buffer, keyed by a "
        "per-stream id. Updated on every enqueue and drain; the series "
        "is removed when the watcher finishes, so the exposition only "
        "ever lists live streams.",
        ("watcher",),
    )
)
wire_events = legacy_registry.register(
    Counter(
        "apiserver_wire_events_total",
        "Store events pulled off the shared fan-out watch, counted ONCE "
        "per event regardless of how many watchers receive it. The "
        "denominator of the single-serialize invariant: "
        "wire_serializations_total / wire_events_total must equal the "
        "number of wire encodings in use (1 per encoding), never the "
        "watcher count — scripts/probe_wire.py asserts exactly that.",
        (),
    )
)
wire_serializations = legacy_registry.register(
    Counter(
        "apiserver_wire_serializations_total",
        "Watch events actually serialized into wire frames (frame-memo "
        "misses), per encoding. The fan-out serializes each event once "
        "per encoding and shares the bytes by reference across every "
        "matching watcher, so this grows with event volume — NOT with "
        "watcher count. A ratio above encodings-in-use per event names "
        "a broken memo (the pre-fan-out per-watcher tax coming back).",
        ("encoding",),
    )
)
wire_frames = legacy_registry.register(
    Counter(
        "apiserver_wire_frames_total",
        "Event frames enqueued into watcher send buffers, per encoding "
        "(one per event per matching watcher; heartbeats excluded). "
        "With wire_events_total this gives the fan-out amplification, "
        "and per unit time the aggregate frames/s the WireFanout bench "
        "headlines.",
        ("encoding",),
    )
)
wire_encode_bytes = legacy_registry.register(
    Counter(
        "apiserver_wire_encode_bytes_total",
        "Bytes produced by wire serialization (watch frame encodes and "
        "binary list entries), per encoding. Counted at encode time — "
        "shared fan-out frames count once no matter how many watchers "
        "the bytes reach, so this measures serialization cost, not "
        "socket volume.",
        ("encoding",),
    )
)


def _status_body(code: int, message: str, reason: str = "") -> bytes:
    return json.dumps({
        "kind": "Status", "apiVersion": "v1",
        "status": "Failure", "message": message, "code": code,
        # the reference's Status.reason analog: lets the client rebuild
        # the precise error class (Conflict vs AlreadyExists share 409)
        "reason": reason,
    }).encode()


import collections as _collections
import itertools as _itertools

_watch_ids = _itertools.count(1)

_RAW_EVENT_CAP = 8192

# wire media types: JSON is the default and the fallback; ktpu-binary is
# the store/wal.py record grammar on the socket (shared with
# native/kvstore.cpp's framing), negotiated per request via Accept
MEDIA_JSON = "application/json"
MEDIA_BINARY = "application/ktpu-binary"

ENC_JSON = "json"
ENC_BINARY = "binary"

_TYPE_TO_OP = {kv.ADDED: wal.OP_CREATE, kv.MODIFIED: wal.OP_UPDATE,
               kv.DELETED: wal.OP_DELETE}
_OP_TO_TYPE = {v: k for k, v in _TYPE_TO_OP.items()}

# heartbeat frames precomputed once per media type: 1000 idle watchers
# tick twice a second each, and rebuilding the frame per watcher per
# tick was measurable for exactly zero information content. The JSON
# heartbeat is the pre-binary wire's exact bytes (a blank line the
# client's readline loop skips); the binary one is an OP_HEARTBEAT
# record the binary decode loop drops.
_pack_u32 = wal._U32.pack  # the snapshot grammar's crc32 trailer width

HEARTBEAT_JSON = b" \n"
HEARTBEAT_BINARY = wal.encode_record(
    wal.Record(wal.OP_HEARTBEAT, "", None, 0, 0))
_HEARTBEATS = {ENC_JSON: HEARTBEAT_JSON, ENC_BINARY: HEARTBEAT_BINARY}


def _stamped_object(ev) -> Dict:
    obj = dict(ev.value)
    meta = dict(obj.get("metadata") or {})
    # the event revision is the object's resourceVersion (etcd3
    # semantics; TypedWatch._hydrate stamps the same way)
    meta["resourceVersion"] = str(ev.revision)
    obj["metadata"] = meta
    return obj


def encode_json_frame(ev) -> bytes:
    """One JSON watch frame — byte-identical to the pre-binary wire."""
    return json.dumps({
        "type": ev.type, "revision": ev.revision,
        "object": _stamped_object(ev),
    }).encode() + b"\n"


def encode_binary_frame(ev) -> bytes:
    """One binary watch frame: a wal.py record whose value is the
    resourceVersion-stamped object — the WAL grammar on the socket."""
    return wal.encode_record(wal.Record(
        _TYPE_TO_OP[ev.type], ev.key, _stamped_object(ev), ev.revision, 0))


_FRAME_ENCODERS = {ENC_JSON: encode_json_frame, ENC_BINARY: encode_binary_frame}


class _FrameMemo:
    """Cross-watcher frame memo for ONE hub/store: every watcher of a
    prefix streams identical bytes per (event, encoding), encoded once.

    The memo key (generation, store key, revision, type, encoding) is
    only unique WITHIN one store — two apiservers in the same process
    (bench_configs' 17 sequential workloads, multi-cluster tests) mint
    colliding (key, revision, type) triples for different objects. A
    process-global memo served one cluster's cached frame bytes to
    another cluster's watcher; scoping the memo to the hub makes
    collisions impossible. The GENERATION term guards the same aliasing
    within one store across time: a durable store crash (fsync=False
    rollback) re-mints revisions, so an un-bumped memo would serve the
    pre-crash object's bytes for a post-crash (key, revision, type)
    triple — the fan-out folds the store incarnation into every key."""

    def __init__(self, cap: int = _RAW_EVENT_CAP):
        self._memo: Dict[Tuple, bytes] = {}
        self._order: "_collections.deque" = _collections.deque()
        self._cap = cap
        self._lock = threading.Lock()

    def encode(self, ev, generation: int = 0, encoding: str = ENC_JSON) -> bytes:
        memo_key = (generation, ev.key, ev.revision, ev.type, encoding)
        with self._lock:
            hit = self._memo.get(memo_key)
        if hit is not None:
            return hit
        out = _FRAME_ENCODERS[encoding](ev)
        wire_serializations.inc(encoding=encoding)
        wire_encode_bytes.inc(len(out), encoding=encoding)
        with self._lock:
            self._memo[memo_key] = out
            self._order.append(memo_key)
            while len(self._order) > self._cap:
                self._memo.pop(self._order.popleft(), None)
        return out


# backward-compat alias (the memo predates the fan-out and multi-encoding
# support; the generation default keeps the old call shape working)
_RawEventMemo = _FrameMemo


class _WatchSink:
    """One watcher's registration with the hub fan-out: a PR-11 bounded
    frame buffer plus the eviction state machine. The dispatcher thread
    pushes shared frame BYTES (by reference — never re-serialized per
    watcher) under `cv`; the handler thread is the writer, coalescing
    queued frames into chunked socket writes. Eviction (byte budget
    blown, or frames queued with no socket progress for `evict_after`)
    marks the sink dead and hard-closes the connection — the close is
    both the unblock for a writer wedged mid-`send` and the re-list
    signal for the client's reflector."""

    def __init__(self, prefix: str, encoding: str, max_bytes: int,
                 evict_after: float, connection) -> None:
        self.prefix = prefix
        self.encoding = encoding
        self.max_bytes = max(1, int(max_bytes))
        self.evict_after = float(evict_after)
        self._connection = connection
        self.cv = threading.Condition()
        self.buf: "_collections.deque" = _collections.deque()  # (bytes, ready)
        self.bytes = 0
        self.done = False      # stream over: flush what's queued, then EOF
        self.dead = False      # stop now: no trailer, no more writes
        self.evicted = False
        self.last_drain = time.monotonic()
        self.wid = f"w{next(_watch_ids)}"

    def push(self, data: bytes, ready: Optional[float]) -> bool:
        """False = the sink is dead (or this push evicted it)."""
        with self.cv:
            if self.dead:
                return False
            stalled = bool(self.buf) and (
                time.monotonic() - self.last_drain > self.evict_after)
            if self.bytes + len(data) > self.max_bytes or stalled:
                self._evict_locked()
                return False
            self.buf.append((data, ready))
            self.bytes += len(data)
            watch_buffer_depth.set(len(self.buf), watcher=self.wid)
            self.cv.notify_all()
            return True

    def check_stall(self, now: float) -> None:
        """Dispatcher-side stall sweep: with the writer wedged inside a
        blocking socket write it can never run its own clock, so the
        fan-out evicts on its poll tick — frames queued, zero drain
        progress for evict_after."""
        with self.cv:
            if (not self.dead and self.buf
                    and now - self.last_drain > self.evict_after):
                self._evict_locked()

    def finish(self) -> None:
        """End the stream cleanly (hub shutdown / store watch died)."""
        with self.cv:
            self.done = True
            self.cv.notify_all()

    def _evict_locked(self) -> None:
        self.evicted = True
        self.dead = True
        watch_evictions.inc()
        self.cv.notify_all()
        # the writer may be wedged inside a socket write: a clean
        # chunked trailer is impossible, and closing the socket is both
        # the unblock and the client's re-list signal
        try:
            self._connection.close()
        except OSError:
            pass


class _WatchFanout:
    """Per-hub broadcast path: ONE dispatcher thread polls ONE shared
    store watch and fans every event out to all registered sinks —
    serialized exactly once per encoding in use (frame memo), prefix
    matching done once per distinct (prefix, encoding) group, bytes
    enqueued by reference. This replaces a store watch + producer thread
    PER WATCHER: at 1000 watchers the old shape serialized every event
    1000 times and woke 2000 threads; this shape serializes once or
    twice and wakes the writers with shared bytes.

    Gap-free attach: the shared watch is opened at the store's current
    revision; a watcher arriving later replays (since_revision,
    last_dispatched] out of the store's retained history UNDER THE
    DISPATCH LOCK, then rides the live feed — no missed or duplicated
    event, and a compacted since_revision raises kv.Compacted before
    response headers (the 410 re-list contract)."""

    def __init__(self, hub: "HTTPAPIServer", store) -> None:
        self._hub = hub
        self._store = store
        self._lock = threading.Lock()
        self._sinks: List[_WatchSink] = []
        self._watch: Optional[kv.Watch] = None
        self._thread: Optional[threading.Thread] = None
        self._last_rev = 0
        self._reopens = 0
        self._stopped = False
        self.memo = _FrameMemo()

    @property
    def generation(self) -> Tuple[int, int]:
        """Frame-memo epoch: (dispatcher reopen count, store
        incarnation). The incarnation term is read live so a crashed-and-
        rebuilt store can never alias a re-minted (key, revision, type)
        triple onto a stale cached frame, even before the dispatcher
        notices its watch died."""
        return (self._reopens, int(getattr(self._store, "incarnation", 0)))

    def attach(self, sink: _WatchSink, since_revision: Optional[int]) -> None:
        with self._lock:
            self._ensure_dispatcher()
            since = self._last_rev if since_revision is None else since_revision
            gen = self.generation
            # raises kv.Compacted -> the handler's 410 path, pre-headers
            backlog = self._store.history_since(sink.prefix, since)
            now = time.monotonic()
            for ev in backlog:
                if ev.revision > self._last_rev:
                    break  # the live dispatch loop delivers the rest
                sink.push(self.memo.encode(ev, gen, sink.encoding), now)
            self._sinks.append(sink)

    def detach(self, sink: _WatchSink) -> None:
        with self._lock:
            try:
                self._sinks.remove(sink)
            except ValueError:
                pass

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            w, self._watch = self._watch, None
            sinks = list(self._sinks)
        if w is not None:
            w.stop()
        for s in sinks:
            s.finish()

    def _ensure_dispatcher(self) -> None:
        """Caller holds self._lock."""
        if self._watch is not None or self._stopped:
            return
        # opening at the CURRENT revision makes the live feed start
        # exactly where attach()'s history replay ends: zero gap
        self._last_rev = self._store.revision
        self._watch = self._store.watch("", since_revision=self._last_rev)
        self._reopens += 1
        self._thread = threading.Thread(
            target=self._run, args=(self._watch,),
            name="watch-fanout", daemon=True)
        self._thread.start()

    def _run(self, w: kv.Watch) -> None:
        hub = self._hub
        last_sweep = time.monotonic()
        while hub.running and not self._stopped:
            ev = w.poll(timeout=0.25)
            now = time.monotonic()
            if ev is None:
                if getattr(w, "closed", False):
                    break
                self._sweep(now)
                last_sweep = now
                continue
            # micro-batch: drain what's already queued so prefix grouping
            # and the per-sink push run once per burst, not per event
            events = [ev]
            while len(events) < 256:
                nxt = w.poll(timeout=0)
                if nxt is None:
                    break
                events.append(nxt)
            with self._lock:
                if self._watch is not w:
                    return  # superseded (stop/reopen)
                self._last_rev = events[-1].revision
                gen = self.generation
                groups: Dict[Tuple[str, str], List[_WatchSink]] = {}
                for s in self._sinks:
                    groups.setdefault((s.prefix, s.encoding), []).append(s)
                wire_events.inc(len(events))
                for (prefix, enc), sinks in groups.items():
                    parts = [
                        self.memo.encode(e, gen, enc)
                        for e in events if e.key.startswith(prefix)
                    ]
                    if not parts:
                        continue
                    data = parts[0] if len(parts) == 1 else b"".join(parts)
                    wire_frames.inc(len(parts) * len(sinks), encoding=enc)
                    for s in sinks:
                        s.push(data, now)
            if now - last_sweep > 0.25:
                self._sweep(now)
                last_sweep = now
        # the shared store watch died (crash recovery stops every
        # stream) or the hub stopped: end every response so remote
        # reflectors re-list instead of heartbeating forever
        with self._lock:
            if self._watch is w:
                self._watch = None
                self._thread = None
                self._reopens += 1  # memo epoch: no stale-frame aliasing
            sinks = list(self._sinks)
        w.stop()
        for s in sinks:
            s.finish()

    def _sweep(self, now: float) -> None:
        with self._lock:
            sinks = list(self._sinks)
        for s in sinks:
            s.check_stall(now)


def _split_path(path: str) -> Tuple[str, str, str, str]:
    """-> (resource, namespace, name, subresource); raises NotFound."""
    parts = [p for p in path.split("/") if p]
    # strip the version prefix: api/v1 or apis/{group}/{version}
    if len(parts) >= 2 and parts[0] == "api":
        parts = parts[2:]
    elif len(parts) >= 3 and parts[0] == "apis":
        parts = parts[3:]
    else:
        raise NotFound(f"unrecognized path {path!r}")
    namespace = ""
    if parts and parts[0] == "namespaces" and len(parts) >= 2:
        # /namespaces/{ns}/... — but a bare /namespaces[/name] addresses
        # the namespaces resource itself, and /namespaces/{name}/status|
        # finalize are SUBRESOURCES of a namespace (the reference
        # registers those two routes explicitly; nothing else collides
        # with the namespaced-collection shape)
        if len(parts) == 3 and parts[2] in ("status", "finalize"):
            return "namespaces", "", parts[1], parts[2]
        if len(parts) >= 3:
            namespace = parts[1]
            parts = parts[2:]
    if not parts:
        raise NotFound(f"no resource in path {path!r}")
    resource = parts[0]
    name = parts[1] if len(parts) >= 2 else ""
    sub = parts[2] if len(parts) >= 3 else ""
    return resource, namespace, name, sub


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "kubernetes-tpu-apiserver"
    # small JSON requests ping-pong on kept-alive sockets: Nagle +
    # delayed-ACK stalls every exchange by ~40ms without this
    disable_nagle_algorithm = True

    # quiet the default stderr access log
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    # -- plumbing ----------------------------------------------------------

    @property
    def hub(self) -> "HTTPAPIServer":
        return self.server.hub  # type: ignore[attr-defined]

    def _client_api(self):
        """The per-request API surface: the raw APIServer, or the
        authenticated facade when secured (WithAuthentication)."""
        secure = self.hub.secure
        if secure is None:
            return self.hub.api
        auth = self.headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            raise _HTTPError(401, "missing bearer token")
        from .auth import APIError as _  # noqa: F401 (same hierarchy)

        return secure.as_user(auth[len("Bearer "):].strip())

    def _body(self) -> Dict:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        return json.loads(raw) if raw else {}

    def _send_json(self, code: int, payload: Any) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, body: str, content_type: str) -> None:
        raw = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _send_error(self, e: Exception) -> None:
        code = getattr(e, "code", 500)
        body = _status_body(
            code, str(e), reason=getattr(e, "reason", "") or type(e).__name__
        )
        # errors can fire BEFORE the request body was read (authn,
        # routing); unread body bytes would desync the next keep-alive
        # request on this socket, so always close after an error
        self.close_connection = True
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _dispatch(self, method: str) -> None:
        try:
            url = urlsplit(self.path)
            params = {k: vs[0] for k, vs in parse_qs(url.query).items()}
            if url.path in ("/apis", "/api"):
                return self._discovery()
            if url.path in ("/healthz", "/readyz", "/livez"):
                return self._send_json(200, {"status": "ok"})
            if url.path in ("/configz", "/metricsz"):
                # component debug surface (component-base configz/metrics):
                # /configz = the registered live configs as JSON, /metricsz
                # = Prometheus text exposition of every scheduler_* metric
                from ..utils import configz

                if url.path == "/configz":
                    return self._send_text(
                        200, configz.handler_body(), "application/json")
                return self._send_text(
                    200, configz.metricsz_body(),
                    "text/plain; version=0.0.4; charset=utf-8")
            resource, ns, name, sub = _split_path(url.path)
            handler = getattr(self, f"_verb_{method.lower()}")
            handler(resource, ns, name, sub, params)
        except _HTTPError as e:
            self._send_error(e)
        except kv.Compacted as e:
            # the watch-from-a-compacted-revision contract on the wire:
            # 410 Gone, which the client rebuilds as kv.Compacted so the
            # reflector's re-list path fires (reflector.go 410 handling)
            gone = _HTTPError(410, str(e))
            gone.reason = "Compacted"
            self._send_error(gone)
        except APIError as e:
            self._send_error(e)
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 — WithPanicRecovery
            self._send_error(_HTTPError(500, f"internal error: {e}"))

    def do_GET(self):  # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def do_PUT(self):  # noqa: N802
        self._dispatch("PUT")

    def do_DELETE(self):  # noqa: N802
        self._dispatch("DELETE")

    # -- discovery ---------------------------------------------------------

    def _discovery(self) -> None:
        api = self.hub.api
        self._send_json(200, {
            "resources": [
                {
                    "name": info.name,
                    "namespaced": info.namespaced,
                    "kind": info.type.__name__,
                }
                for info in api.resources()
            ]
        })

    # -- verbs -------------------------------------------------------------

    def _resource_client(self, resource: str):
        api = self._client_api()
        if isinstance(api, APIServer):
            return _RawFacade(api, resource)
        return api.resource(resource)

    def _wire_encoding(self) -> str:
        """Per-request content negotiation: ktpu-binary only when the
        client's Accept names it; JSON is the default and the fallback
        (an old or kill-switched client never sees binary bytes)."""
        accept = self.headers.get("Accept", "")
        return ENC_BINARY if MEDIA_BINARY in accept else ENC_JSON

    def _verb_get(self, resource, ns, name, sub, params) -> None:
        if resource == "pods" and sub == "log":
            api = self._client_api()
            lines = api.pod_logs(
                name, ns, params.get("container", ""),
                int(params["tailLines"]) if "tailLines" in params else None,
            )
            return self._send_json(200, {"lines": lines})
        client = self._resource_client(resource)
        if name:
            return self._send_json(200, serde.to_dict(client.get(name, ns)))
        if params.get("watch") in ("1", "true"):
            return self._stream_watch(client, ns, params)
        if self._wire_encoding() == ENC_BINARY:
            # binary LIST fast path: stream the raw store dicts straight
            # into kv_list entries, skipping the per-item
            # from_dict->to_dict round trip entirely (the dominant
            # server-side list cost in the wire profile). Only on the
            # hub's own plain api — a secure facade must keep running
            # authz through client.list below.
            hub = self.hub
            store = getattr(hub.api, "store", None)
            if hub.secure is None and store is not None:
                info = hub.api._info(resource)
                prefix = (f"/registry/{info.name}/{ns}/"
                          if info.namespaced and ns
                          else f"/registry/{info.name}/")
                kvs, rev = store.list(prefix)
                return self._stream_binary_list_raw(kvs, rev)
            items, rev = client.list(namespace=ns or None)
            return self._stream_binary_list(resource, items, rev)
        items, rev = client.list(namespace=ns or None)
        self._send_json(200, {
            "items": [serde.to_dict(o) for o in items],
            "metadata": {"resourceVersion": str(rev)},
        })

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

    def _stream_binary_list(self, resource, items, rev: int) -> None:
        """Chunked binary LIST from decoded objects (the facade path —
        secure hubs and foreign facades). The entry value is the serde
        dict with resourceVersion already stamped by the list path, so
        the client rebuilds the exact objects the JSON path would
        carry."""
        info = self.hub.api._info(resource)

        def entries():
            for obj in items:
                meta = obj.metadata
                if info.namespaced:
                    key = (f"/registry/{info.name}/{meta.namespace}"
                           f"/{meta.name}")
                else:
                    key = f"/registry/{info.name}/{meta.name}"
                yield (key, serde.to_dict(obj), 0,
                       int(meta.resource_version or 0))

        self._stream_snapshot(entries(), len(items), rev)

    def _stream_binary_list_raw(self, kvs, rev: int) -> None:
        """Chunked binary LIST straight from store KVs: the stored dict
        is what from_dict would re-serialize, so frame it as-is with
        resourceVersion stamped from mod_revision (exactly what
        APIServer._stamp does after ITS from_dict) — zero serde on the
        serving thread."""

        def entries():
            for kvv in kvs:
                value = dict(kvv.value)
                meta = dict(value.get("metadata") or {})
                meta["resourceVersion"] = str(kvv.mod_revision)
                value["metadata"] = meta
                yield (kvv.key, value, kvv.create_revision,
                       kvv.mod_revision)

        self._stream_snapshot(entries(), len(kvs), rev)

    def _stream_snapshot(self, entries, count: int, rev: int) -> None:
        """The shared wire body: wal.py snapshot grammar — header, one
        kv_list-framed entry per object (streamed in ~64KiB chunks
        instead of one monolithic json.dumps), crc32 trailer."""
        import zlib

        self.send_response(200)
        self.send_header("Content-Type", MEDIA_BINARY)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        head = wal.snapshot_header(count, rev, 0)
        crc = zlib.crc32(head)
        pending = [head]
        nbytes = len(head)
        total = nbytes
        for key, value, create_rev, mod_rev in entries:
            entry = wal.encode_snapshot_entry(
                key, value, create_rev, mod_rev)
            crc = zlib.crc32(entry, crc)
            pending.append(entry)
            nbytes += len(entry)
            total += len(entry)
            if nbytes >= 64 * 1024:
                self._write_chunk(b"".join(pending))
                pending = []
                nbytes = 0
        pending.append(_pack_u32(crc))
        self._write_chunk(b"".join(pending))
        self.wfile.write(b"0\r\n\r\n")
        wire_encode_bytes.inc(total + 4, encoding=ENC_BINARY)

    def _stream_watch(self, client, ns, params) -> None:
        """Chunked streaming watch (watch.go ServeHTTP) over the hub's
        shared fan-out.

        The watch is SET UP through the per-request client facade —
        authn/authz, flow control and the Compacted check all fire
        exactly as before — but the per-watcher store watch it returns
        is immediately released: events reach this stream through the
        hub's _WatchFanout, which serializes each store event once per
        encoding in use and enqueues the frame bytes by reference into
        every matching watcher's bounded buffer. This HANDLER thread is
        the stream's writer (one thread per watcher, not the old
        producer+writer pair): it coalesces queued frames into chunked
        socket writes — byte-bounded at a quarter of the buffer budget,
        frame-bounded by KTPU_WIRE_BATCH_FRAMES — writes heartbeats from
        the per-media precomputed constant on idle ticks, and observes
        the delivery SLI after each flush.

        Slow-consumer backpressure is PR-11's contract unchanged: a
        watcher whose buffer passes hub.watch_buffer_bytes, or holds
        frames with no socket progress for hub.watch_evict_after
        seconds, is EVICTED — counted and hard-closed, with the fan-out
        sweeping stall clocks so a writer wedged inside send() still
        gets evicted. Eviction is safe: the client's RemoteWatch sees
        EOF, sets `closed`, and its reflector re-lists."""
        since = params.get("resourceVersion")
        since_rev = int(since) if since else None
        w = client.watch(namespace=ns or None, since_revision=since_rev)
        raw = w.raw_events() if hasattr(w, "raw_events") else None
        hub = self.hub
        fanout = hub.fanout
        if raw is None or fanout is None:
            return self._stream_watch_direct(w)
        encoding = self._wire_encoding()
        prefix = getattr(raw, "_prefix", "")
        # authz/flow-control/Compacted all checked above; the fan-out's
        # shared watch carries the events from here
        w.stop()
        sink = _WatchSink(
            prefix, encoding,
            max_bytes=getattr(hub, "watch_buffer_bytes", 256 * 1024),
            evict_after=getattr(hub, "watch_evict_after", 10.0),
            connection=self.connection,
        )
        # raises kv.Compacted -> 410 while headers are still unsent
        fanout.attach(sink, since_rev)
        try:
            self.send_response(200)
            self.send_header(
                "Content-Type",
                MEDIA_BINARY if encoding == ENC_BINARY else MEDIA_JSON)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
        except (BrokenPipeError, ConnectionResetError, OSError):
            fanout.detach(sink)
            self.close_connection = True
            return
        hub.watcher_started()
        heartbeat = _HEARTBEATS[encoding]
        batch_frames = max(1, int(getattr(hub, "wire_batch_frames", 512)))
        byte_cap = sink.max_bytes // 4
        cv = sink.cv
        buf = sink.buf
        try:
            while True:
                parts: List[bytes] = []
                ready_list: List[float] = []
                with cv:
                    if not buf and not sink.done and not sink.dead:
                        cv.wait(0.5)
                    if sink.dead:
                        return
                    if not hub.running:
                        sink.done = True
                    if buf:
                        nbytes = 0
                        while (buf and len(parts) < batch_frames
                               and nbytes < byte_cap):
                            data, ready = buf.popleft()
                            parts.append(data)
                            nbytes += len(data)
                            if ready is not None:
                                ready_list.append(ready)
                        sink.bytes -= nbytes
                        watch_buffer_depth.set(len(buf), watcher=sink.wid)
                    elif sink.done:
                        return
                    else:
                        # idle tick: the precomputed heartbeat keeps dead
                        # peers detectable (and excluded from the SLI)
                        parts.append(heartbeat)
                # a slow reader blocks HERE, on this handler thread —
                # never the fan-out dispatcher feeding every watcher
                self._write_chunk(
                    parts[0] if len(parts) == 1 else b"".join(parts))
                self.wfile.flush()
                if ready_list:
                    # event-ready -> socket-write SLI, observed only
                    # AFTER the flush (heartbeats carry no timestamp)
                    now = time.monotonic()
                    for r in ready_list:
                        watch_delivery.observe(now - r)
                with cv:
                    sink.last_drain = time.monotonic()
        except (BrokenPipeError, ConnectionResetError, OSError):
            with cv:
                sink.dead = True
        finally:
            fanout.detach(sink)
            if not sink.evicted and not sink.dead:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass
            elif sink.evicted:
                # eviction already hard-closed the socket; nothing to
                # flush — the EOF/RST IS the client's re-list signal
                pass
            self.close_connection = True
            watch_buffer_depth.remove(watcher=sink.wid)
            hub.watcher_finished()

    def _stream_watch_direct(self, w) -> None:
        """Fallback for watches with no raw store feed (no fan-out):
        hydrate-and-serialize per event on this thread. No production
        path lands here — both client facades return TypedWatch — but
        the wire stays correct for foreign facades."""
        self.send_response(200)
        self.send_header("Content-Type", MEDIA_JSON)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        hub = self.hub
        hub.watcher_started()
        try:
            while hub.running:
                ev = w.poll(timeout=0.5)
                if ev is None:
                    if getattr(w, "closed", False):
                        break
                    data = HEARTBEAT_JSON
                else:
                    data = json.dumps({
                        "type": ev.type,
                        "revision": ev.revision,
                        "object": serde.to_dict(ev.object),
                    }).encode() + b"\n"
                self._write_chunk(data)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            w.stop()
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass
            self.close_connection = True
            hub.watcher_finished()

    def _verb_post(self, resource, ns, name, sub, params) -> None:
        api = self._client_api()
        if resource == "pods" and sub == "binding":
            body = self._body()
            api.bind_pod(ns, name, body.get("target", {}).get("name", ""))
            return self._send_json(201, {"status": "Success"})
        if resource == "bulkbindings":
            # TPU-build extension (no reference counterpart): the batched
            # scheduler loop lands thousands of bindings per cycle; one
            # request per binding was the dominant wire tax. Semantics
            # are exactly N bindings with per-binding outcomes.
            body = self._body()
            outcomes = []
            for b in body.get("bindings") or []:
                try:
                    api.bind_pod(
                        b.get("namespace", ""), b.get("name", ""),
                        b.get("node", ""),
                    )
                    outcomes.append(None)
                except APIError as e:
                    outcomes.append(
                        {"code": getattr(e, "code", 500), "message": str(e)}
                    )
            return self._send_json(200, {"outcomes": outcomes})
        if resource == "bulkcreate":
            # TPU-build extension beside bulkbindings: N creates of one
            # resource in one request (the event firehose), best-effort
            # per-item outcomes
            body = self._body()
            target = body.get("resource", "")
            info = api._info(target)
            n_ok = 0
            for item in body.get("items") or []:
                try:
                    api.create(target, serde.from_dict(info.type, item))
                    n_ok += 1
                except APIError:
                    pass
            return self._send_json(200, {"created": n_ok})
        if resource == "pods" and sub == "exec":
            body = self._body()
            out, code = api.pod_exec(
                name, ns, list(body.get("command") or []),
                body.get("container", ""),
            )
            return self._send_json(200, {"output": out, "exitCode": code})
        info = self.hub.api._info(resource)
        obj = serde.from_dict(info.type, self._body())
        if info.namespaced and ns and not obj.metadata.namespace:
            # the reference defaults the object to the path namespace
            # (handlers/create.go scope check + defaulting)
            obj.metadata.namespace = ns
        created = self._resource_client(resource).create(obj)
        self._send_json(201, serde.to_dict(created))

    def _verb_put(self, resource, ns, name, sub, params) -> None:
        if sub == "finalize":
            api = self._client_api()
            body = self._body()
            api.remove_finalizer(resource, name, ns, body.get("remove", ""))
            return self._send_json(200, {"status": "Success"})
        info = self.hub.api._info(resource)
        obj = serde.from_dict(info.type, self._body())
        if info.namespaced and ns and not obj.metadata.namespace:
            obj.metadata.namespace = ns
        client = self._resource_client(resource)
        if sub == "status":
            updated = client.update_status(obj)
        elif sub:
            raise NotFound(f"unknown subresource {sub!r}")
        else:
            updated = client.update(obj)
        self._send_json(200, serde.to_dict(updated))

    def _verb_delete(self, resource, ns, name, sub, params) -> None:
        self._resource_client(resource).delete(
            name, ns,
            propagation_policy=params.get("propagationPolicy") or None,
        )
        self._send_json(200, {"status": "Success"})


class _HTTPError(APIError):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class _RawFacade:
    """Adapts the raw APIServer to the per-resource client shape the
    handler drives (the same shape _AuthorizedResourceClient has)."""

    def __init__(self, api: APIServer, resource: str):
        self._api = api
        self._resource = resource

    def create(self, obj):
        return self._api.create(self._resource, obj)

    def get(self, name, namespace=""):
        return self._api.get(self._resource, name, namespace)

    def update(self, obj):
        return self._api.update(self._resource, obj)

    def update_status(self, obj):
        return self._api.update_status(self._resource, obj)

    def delete(self, name, namespace="", propagation_policy=None):
        return self._api.delete(self._resource, name, namespace,
                                propagation_policy=propagation_policy)

    def list(self, namespace=None, label_selector=None):
        return self._api.list(self._resource, namespace, label_selector)

    def watch(self, namespace=None, since_revision=None):
        return self._api.watch(self._resource, namespace, since_revision)


class _WatchHTTPServer(ThreadingHTTPServer):
    # A watch hub takes hundreds of reflector connects in one burst
    # (cold start: every component re-lists and re-watches at once).
    # The stdlib backlog of 5 turns that burst into SYN-retransmit
    # stalls — measured ~136ms PER CONNECT on the bench box, 166s to
    # attach 1000 watchers — so listen deep; the kernel clamps to
    # net.core.somaxconn anyway.
    request_queue_size = 1024


class HTTPAPIServer:
    """Serve an APIServer (or SecureAPIServer) on a real socket."""

    def __init__(self, api=None, secure=None, host: str = "127.0.0.1",
                 port: int = 0):
        from .auth import SecureAPIServer

        if secure is None and isinstance(api, SecureAPIServer):
            secure = api
            api = secure.api
        self.secure = secure
        self.api = api or (secure.api if secure else APIServer())
        self._httpd = _WatchHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.hub = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self.running = False
        # per-hub broadcast path: ONE shared store watch fans out to
        # every stream, frames serialized once per encoding (the memo
        # lives on the fanout; per-hub because (key, revision, type) is
        # unique only within one store)
        store = getattr(self.api, "store", None)
        self.fanout = _WatchFanout(self, store) if store is not None else None
        self.raw_event_memo = (
            self.fanout.memo if self.fanout is not None else _FrameMemo())
        # slow-consumer backpressure knobs (_stream_watch): bounded
        # per-watcher send buffer + max stall before eviction. Tests
        # shrink these per-hub; production tunes via env.
        self.watch_buffer_bytes = int(knobs.get_int("KTPU_WATCH_BUFFER"))
        self.watch_evict_after = float(
            knobs.get_float("KTPU_WATCH_EVICT_AFTER"))
        self.wire_batch_frames = int(
            knobs.get_int("KTPU_WIRE_BATCH_FRAMES"))
        self._watch_lock = threading.Lock()
        self.watcher_count = 0  # live streams on THIS hub
        from ..utils import configz

        configz.install_knobs(
            "apiserver",
            watch_buffer_bytes=self.watch_buffer_bytes,
            watch_evict_after=self.watch_evict_after,
            wire_batch_frames=self.wire_batch_frames,
        )

    def watcher_started(self) -> None:
        with self._watch_lock:
            self.watcher_count += 1
        watchers_gauge.inc()

    def watcher_finished(self) -> None:
        with self._watch_lock:
            self.watcher_count -= 1
        watchers_gauge.dec()

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "HTTPAPIServer":
        self.running = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.running = False
        if self.fanout is not None:
            self.fanout.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


# ---------------------------------------------------------------------------
# client side


class RemoteWatch:
    """TypedWatch-compatible stream over a chunked HTTP watch response:
    a reader thread feeds a queue; poll()/stop() match the in-proc
    contract informers consume (client/informer.py reflector).

    The reader speaks whichever encoding the response negotiated: JSON
    lines (default), or ktpu-binary — the store/wal.py record grammar
    decoded incrementally off the socket (iter_records stops cleanly at
    an incomplete tail, so records may straddle reads freely)."""

    def __init__(self, conn_factory, typ):
        self._typ = typ
        self._q: Queue = Queue()
        self._stopped = threading.Event()
        # the informer reflector checks this on idle polls: a dead stream
        # (disconnect, server restart) must trigger a re-list+re-watch,
        # not an eternally-stale cache
        self.closed = False
        self._resp = conn_factory()
        ctype = ""
        try:
            ctype = self._resp.getheader("Content-Type") or ""
        except Exception:  # noqa: BLE001 — non-http.client responses
            pass
        self.binary = ctype.startswith(MEDIA_BINARY)
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def _read_loop(self) -> None:
        import http.client

        try:
            if self.binary:
                self._read_binary()
            else:
                self._read_json()
        except (OSError, ValueError, AttributeError,
                http.client.HTTPException):
            # AttributeError: http.client internals after a concurrent
            # close() from stop(); IncompleteRead: the server hard-closed
            # mid-chunk (eviction) — both are the EOF the reflector acts
            # on, not errors
            pass
        finally:
            self.closed = True

    def _read_json(self) -> None:
        while not self._stopped.is_set():
            line = self._resp.readline()
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            raw = json.loads(line)
            obj = serde.from_dict(self._typ, raw["object"])
            self._q.put(WatchEvent(raw["type"], obj, raw["revision"]))

    def _read_binary(self) -> None:
        buf = b""
        while not self._stopped.is_set():
            chunk = self._resp.read1(1 << 16)
            if not chunk:
                break
            buf += chunk
            end = 0
            for rec, off in wal.iter_records(buf):
                end = off
                if rec.op == wal.OP_HEARTBEAT:
                    continue
                obj = serde.from_dict(self._typ, rec.value)
                self._q.put(WatchEvent(_OP_TO_TYPE[rec.op], obj, rec.rev))
            if end:
                buf = buf[end:]

    def poll(self, timeout: Optional[float] = None):
        try:
            return self._q.get(timeout=timeout)
        except Empty:
            return None

    def __iter__(self):
        while True:
            ev = self.poll(timeout=0.5)
            if ev is not None:
                yield ev
            elif self._stopped.is_set() or self.closed:
                # queue drained and the stream is gone (poll returns None
                # only when empty, so buffered events are never dropped)
                return

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._resp.close()
        except OSError:
            pass
        conn = getattr(self._resp, "_conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass


class RemoteAPIServer:
    """APIServer-compatible surface over HTTP — Clientset, informers,
    controllers, the scheduler, and kubectl run against it unchanged."""

    def __init__(self, base_url: str, token: str = "",
                 resources: Optional[Tuple[ResourceInfo, ...]] = None):
        self.base_url = base_url.rstrip("/")
        self.token = token
        split = urlsplit(self.base_url)
        self._host = split.hostname
        self._port = split.port or 80
        if resources is None:
            from .server import _default_resources

            resources = _default_resources()
        self._resources: Dict[str, ResourceInfo] = {r.name: r for r in resources}
        self._local = threading.local()  # per-thread keep-alive connection
        # negotiate the binary wire for watch/list by default; the
        # KTPU_WIRE_BINARY=0 kill switch drops the Accept header
        # entirely, restoring the exact pre-binary requests and (JSON)
        # response bytes. Servers without binary support just answer
        # JSON — Accept is a preference, not a demand.
        self.wire_binary = bool(knobs.get_bool("KTPU_WIRE_BINARY"))
        # single-DESERIALIZE mirror of the server's single-serialize: a
        # (storage key, mod_revision) pair names an immutable snapshot,
        # so repeated binary LISTs (poll loops, reflector re-syncs)
        # skip serde for every unchanged entry. Same sharing contract
        # as the informer cache: callers must not mutate listed
        # objects. Crude bound — a re-decode is cheap, a leak is not.
        self._decode_memo: Dict[Tuple[str, int], Any] = {}

    # -- plumbing ----------------------------------------------------------

    def _info(self, resource: str) -> ResourceInfo:
        info = self._resources.get(resource)
        if info is None:
            raise NotFound(f"unknown resource {resource!r}")
        return info

    def register_resource(self, info: ResourceInfo) -> None:
        self._resources[info.name] = info

    def resources(self) -> Tuple[ResourceInfo, ...]:
        return tuple(self._resources.values())

    def _path(self, info: ResourceInfo, namespace: str, name: str = "",
              sub: str = "") -> str:
        parts = ["/api/v1"]
        if info.namespaced and namespace:
            parts.append(f"namespaces/{namespace}")
        parts.append(info.name)
        if name:
            parts.append(name)
        if sub:
            parts.append(sub)
        return "/".join(parts)

    def _conn(self):
        """Per-thread persistent HTTP/1.1 connection (keep-alive): a
        fresh TCP handshake per request was the dominant wire tax —
        client-go likewise reuses transports."""
        import http.client

        conn = getattr(self._local, "conn", None)
        fresh = False
        if conn is None or conn.sock is None:
            # conn.sock is None after the server closed the socket (every
            # error response sends Connection: close): http.client would
            # transparently auto-reconnect WITHOUT our setsockopt, and
            # Nagle would silently come back — recreate instead
            if conn is not None:
                conn.close()
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=30
            )
            conn.connect()
            conn.sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
            self._local.conn = conn
            fresh = True
        return conn, fresh

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            finally:
                self._local.conn = None

    def _request(self, method: str, path: str, body: Optional[Dict] = None,
                 query: str = "", accept: str = "",
                 raw_response: bool = False):
        """JSON request/response by default; `accept` adds content
        negotiation and `raw_response` returns (bytes, content_type)
        for 2xx instead of a parsed dict (error bodies are always JSON
        Status objects regardless of Accept)."""
        import http.client

        payload = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if accept:
            headers["Accept"] = accept
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        url = path + (f"?{query}" if query else "")
        for attempt in (0, 1):
            conn, fresh = self._conn()
            try:
                # send phase: a STALE kept-alive socket fails here before
                # the server saw the request — safe to retry any verb
                # once. On a freshly-connected socket the failure can be
                # mid-send (headers+body partially flushed and possibly
                # parsed server-side), so only idempotent GETs retry then
                conn.request(method, url, body=payload, headers=headers)
            except (http.client.HTTPException, OSError):
                self._drop_conn()
                if attempt or (fresh and method != "GET"):
                    raise
                continue
            try:
                resp = conn.getresponse()
                raw = resp.read()
            except (http.client.HTTPException, OSError):
                # response phase: the server may have APPLIED the request
                # (a retried POST would duplicate side effects — e.g. a
                # re-sent bulkbindings would turn every outcome into a
                # Conflict); only idempotent GETs retry here
                self._drop_conn()
                if attempt or method != "GET":
                    raise
                continue
            if resp.will_close:
                # server said Connection: close (error responses do):
                # drop now so the next request gets a fresh NODELAY socket
                self._drop_conn()
            if resp.status >= 400:
                data = json.loads(raw) if raw else {}
                raise self._error(
                    resp.status, data.get("message", ""),
                    data.get("reason", ""),
                )
            if raw_response:
                return raw, (resp.getheader("Content-Type") or "")
            return json.loads(raw) if raw else {}

    @staticmethod
    def _error(code: int, message: str, reason: str = ""):
        from .auth import Forbidden, Unauthorized
        from .server import AlreadyExists, Conflict, Invalid

        if reason == "Compacted" or code == 410:
            # not an APIError on purpose: the informer reflector catches
            # kv.Compacted and re-lists — identical to the in-proc path
            return kv.Compacted(message)
        classes = (NotFound, AlreadyExists, Conflict, Invalid,
                   Unauthorized, Forbidden)
        for cls in classes:
            if cls.__name__ == reason:
                return cls(message)
        for cls in classes:
            if cls.code == code:
                return cls(message)
        e = APIError(message)
        e.code = code
        return e

    # -- APIServer surface -------------------------------------------------

    def create(self, resource: str, obj: Any) -> Any:
        info = self._info(resource)
        data = self._request(
            "POST", self._path(info, obj.metadata.namespace),
            serde.to_dict(obj),
        )
        return serde.from_dict(info.type, data)

    def create_bulk(self, resource: str, objs) -> None:
        """N creates in ONE request (bulkcreate extension route),
        best-effort; falls back to per-object POSTs on older servers."""
        try:
            self._request(
                "POST", "/api/v1/bulkcreate",
                {"resource": resource,
                 "items": [serde.to_dict(o) for o in objs]},
            )
            return
        except NotFound:
            pass
        for obj in objs:
            try:
                self.create(resource, obj)
            except APIError:
                pass

    def get(self, resource: str, name: str, namespace: str = "") -> Any:
        info = self._info(resource)
        data = self._request("GET", self._path(info, namespace, name))
        return serde.from_dict(info.type, data)

    def update(self, resource: str, obj: Any) -> Any:
        info = self._info(resource)
        data = self._request(
            "PUT", self._path(info, obj.metadata.namespace, obj.metadata.name),
            serde.to_dict(obj),
        )
        return serde.from_dict(info.type, data)

    def update_status(self, resource: str, obj: Any) -> Any:
        info = self._info(resource)
        data = self._request(
            "PUT",
            self._path(info, obj.metadata.namespace, obj.metadata.name, "status"),
            serde.to_dict(obj),
        )
        return serde.from_dict(info.type, data)

    def delete(self, resource: str, name: str, namespace: str = "",
               propagation_policy: Optional[str] = None) -> None:
        info = self._info(resource)
        query = (
            f"propagationPolicy={propagation_policy}"
            if propagation_policy else ""
        )
        self._request("DELETE", self._path(info, namespace, name), query=query)

    def remove_finalizer(self, resource: str, name: str, namespace: str,
                         finalizer: str) -> None:
        info = self._info(resource)
        self._request(
            "PUT", self._path(info, namespace, name, "finalize"),
            {"remove": finalizer},
        )

    def list(self, resource: str, namespace: Optional[str] = None,
             label_selector=None) -> Tuple[List[Any], int]:
        info = self._info(resource)
        path = self._path(info, namespace or "")
        if self.wire_binary:
            raw, ctype = self._request(
                "GET", path, accept=MEDIA_BINARY, raw_response=True)
            if ctype.startswith(MEDIA_BINARY):
                entries, rev, _ = wal.decode_snapshot(raw, label=path)
                memo = self._decode_memo
                if len(memo) > 65536:
                    memo.clear()
                items = []
                for key, value, _crev, mrev in entries:
                    obj = memo.get((key, mrev))
                    if obj is None:
                        obj = serde.from_dict(info.type, value)
                        memo[(key, mrev)] = obj
                    items.append(obj)
            else:  # older server: negotiated down to JSON
                data = json.loads(raw) if raw else {}
                items = [serde.from_dict(info.type, d)
                         for d in data.get("items", [])]
                rev = int(data.get("metadata", {})
                          .get("resourceVersion", "0"))
        else:
            data = self._request("GET", path)
            items = [serde.from_dict(info.type, d)
                     for d in data.get("items", [])]
            rev = int(data.get("metadata", {}).get("resourceVersion", "0"))
        if label_selector is not None:
            items = [
                o for o in items
                if label_selector.matches(o.metadata.labels or {})
            ]
        return items, rev

    def watch(self, resource: str, namespace: Optional[str] = None,
              since_revision: Optional[int] = None) -> RemoteWatch:
        import http.client

        info = self._info(resource)
        path = self._path(info, namespace or "")
        query = "watch=true"
        if since_revision is not None:
            query += f"&resourceVersion={since_revision}"

        def connect():
            conn = http.client.HTTPConnection(self._host, self._port)
            headers = {}
            if self.wire_binary:
                headers["Accept"] = MEDIA_BINARY
            if self.token:
                headers["Authorization"] = f"Bearer {self.token}"
            conn.request("GET", f"{path}?{query}", headers=headers)
            resp = conn.getresponse()
            if resp.status >= 400:
                raw = resp.read()
                data = json.loads(raw) if raw else {}
                conn.close()
                raise self._error(
                    resp.status, data.get("message", ""),
                    data.get("reason", ""),
                )
            resp._conn = conn  # keep the socket alive with the response
            return resp

        return RemoteWatch(connect, info.type)

    def bind_pod(self, namespace: str, pod_name: str, node_name: str) -> None:
        info = self._info("pods")
        self._request(
            "POST", self._path(info, namespace, pod_name, "binding"),
            {"target": {"kind": "Node", "name": node_name}},
        )

    def bind_pods(self, bindings):
        """Bulk-bind over ONE request (the bulkbindings extension route):
        per-binding outcomes, same semantics as N binding POSTs. Falls
        back to per-binding POSTs against servers without the route."""
        try:
            data = self._request(
                "POST", "/api/v1/bulkbindings",
                {"bindings": [
                    {"namespace": ns, "name": name, "node": node}
                    for ns, name, node in bindings
                ]},
            )
            out = []
            for oc in data.get("outcomes", []):
                if oc is None:
                    out.append(None)
                else:
                    out.append(self._error(
                        int(oc.get("code", 500)), oc.get("message", "")
                    ))
            if len(out) == len(bindings):
                return out
        except NotFound:
            pass  # older server: no bulk route
        results = []
        for namespace, pod_name, node_name in bindings:
            try:
                self.bind_pod(namespace, pod_name, node_name)
                results.append(None)
            except APIError as e:
                results.append(e)
        return results

    def pod_logs(self, name: str, namespace: str = "", container: str = "",
                 tail: Optional[int] = None) -> List[str]:
        info = self._info("pods")
        query = f"container={container}" if container else ""
        if tail is not None:
            query += ("&" if query else "") + f"tailLines={tail}"
        data = self._request(
            "GET", self._path(info, namespace, name, "log"), query=query
        )
        return list(data.get("lines", []))

    def pod_exec(self, name: str, namespace: str, cmd: List[str],
                 container: str = "") -> Tuple[str, int]:
        info = self._info("pods")
        data = self._request(
            "POST", self._path(info, namespace, name, "exec"),
            {"command": list(cmd), "container": container},
        )
        return data.get("output", ""), int(data.get("exitCode", 0))

    def server_resources(self) -> List[Dict]:
        """Discovery: what the remote end actually serves."""
        return list(self._request("GET", "/apis").get("resources", []))
