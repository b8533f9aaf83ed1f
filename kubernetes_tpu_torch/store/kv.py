"""Revisioned, ordered, watchable in-process KV store — the etcd equivalent.

The reference keeps all cluster state in etcd, reached only through the
apiserver's storage.Interface (reference: staging/src/k8s.io/apiserver/pkg/
storage/etcd3/store.go:143 Create, :286 GuaranteedUpdate, :816 Watch).
This module reproduces the semantics that layer relies on:

  * a single monotonically-increasing int64 revision over ALL keys (the
    etcd store revision; object resourceVersion = mod revision);
  * conditional writes — create-if-absent, update/delete guarded by the
    expected mod revision (the transactional compare etcd3 store.go uses);
  * prefix range reads returning (values, store revision);
  * watches from a historical revision: replay from the event log, then
    live delivery; asking for a compacted revision raises Compacted — the
    equivalent of etcd's "410 Gone" that forces a client re-list
    (client-go reflector.go ListAndWatch re-list path).

Values are opaque Python objects; callers must treat returned values as
immutable (the apiserver layer stores serialized dicts and deep-copies at
its own boundary).
"""

from __future__ import annotations

import bisect
import os
import queue
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

from . import wal

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


class StoreError(Exception):
    pass


class KeyExists(StoreError):
    pass


class KeyNotFound(StoreError):
    pass


class Conflict(StoreError):
    """Mod-revision precondition failed (optimistic concurrency)."""


class Compacted(StoreError):
    """Requested watch revision predates the retained event log (410 Gone)."""


@dataclass(frozen=True)
class Event:
    type: str  # ADDED | MODIFIED | DELETED
    key: str
    value: Any  # current value (ADDED/MODIFIED) or last value (DELETED)
    revision: int


@dataclass(frozen=True)
class KeyValue:
    key: str
    value: Any
    create_revision: int
    mod_revision: int


class Watch:
    """One watch stream: iterate for events; stop() ends the stream."""

    _SENTINEL = object()

    def __init__(self, store: "KVStore", prefix: str):
        self._store = store
        self._prefix = prefix
        self._q: "queue.Queue" = queue.Queue()
        self._stopped = False
        # a stopped watch is a DEAD stream: reflectors poll this to know
        # they must re-list+re-watch (the informer's restart-surviving
        # path after an apiserver crash kills every live watch)
        self.closed = False

    def _deliver(self, ev: Event) -> None:
        if not self._stopped and ev.key.startswith(self._prefix):
            self._q.put(ev)

    def stop(self) -> None:
        if not self._stopped:
            self._stopped = True
            self.closed = True
            self._store._remove_watch(self)
            self._q.put(self._SENTINEL)

    def __iter__(self) -> Iterator[Event]:
        while True:
            ev = self._q.get()
            if ev is self._SENTINEL:
                return
            yield ev

    def poll(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Next event or None on timeout/stop."""
        try:
            ev = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        return None if ev is self._SENTINEL else ev


class KVStore:
    #: conditional writes accept a `precondition` callable (checked
    #: atomically under the store lock) — the capability the fencing
    #: layer probes before trusting guaranteed_update to be race-free
    supports_precondition = True

    #: bumped by crashing store facades (DurableKVStore) each time the
    #: live state is rebuilt; a plain in-memory store never restarts.
    #: Consumers (the HTTP fan-out's frame memo) fold it into cache keys
    #: so a (key, revision, type) triple re-minted by a rollback can
    #: never alias a stale cached frame.
    incarnation = 0

    def __init__(self, history_limit: int = 100_000):
        self._lock = threading.RLock()
        self._data: Dict[str, KeyValue] = {}
        self._keys: List[str] = []  # sorted for range reads
        self._rev = 0
        self._history: deque = deque()  # Events, oldest first
        self._history_limit = history_limit
        self._compacted_rev = 0  # events <= this are gone
        self._watches: List[Watch] = []

    # -- reads -------------------------------------------------------------

    @property
    def revision(self) -> int:
        with self._lock:
            return self._rev

    @property
    def compacted_revision(self) -> int:
        """Events at or below this revision are gone (watch floor)."""
        with self._lock:
            return self._compacted_rev

    def get(self, key: str) -> KeyValue:
        with self._lock:
            kv = self._data.get(key)
            if kv is None:
                raise KeyNotFound(key)
            return kv

    def list(self, prefix: str) -> Tuple[List[KeyValue], int]:
        """All KVs under prefix (key-ordered) + the store revision, the
        consistent LIST the reflector's initial sync needs."""
        with self._lock:
            lo = bisect.bisect_left(self._keys, prefix)
            out = []
            for i in range(lo, len(self._keys)):
                k = self._keys[i]
                if not k.startswith(prefix):
                    break
                out.append(self._data[k])
            return out, self._rev

    # -- writes ------------------------------------------------------------

    def create(self, key: str, value: Any) -> int:
        with self._lock:
            if key in self._data:
                raise KeyExists(key)
            self._rev += 1
            kv = KeyValue(key, value, self._rev, self._rev)
            self._data[key] = kv
            bisect.insort(self._keys, key)
            self._emit(Event(ADDED, key, value, self._rev))
            return self._rev

    def update(
        self,
        key: str,
        value: Any,
        expected_mod_revision: Optional[int] = None,
        precondition=None,
    ) -> int:
        with self._lock:
            kv = self._data.get(key)
            if kv is None:
                raise KeyNotFound(key)
            if expected_mod_revision is not None and kv.mod_revision != expected_mod_revision:
                raise Conflict(
                    f"{key}: mod_revision {kv.mod_revision} != expected {expected_mod_revision}"
                )
            if precondition is not None:
                # under the store RLock (re-entrant: the callable may read
                # OTHER keys — the fencing check reads the leader lease) so
                # check + commit are one atomic step
                precondition()
            self._rev += 1
            self._data[key] = KeyValue(key, value, kv.create_revision, self._rev)
            self._emit(Event(MODIFIED, key, value, self._rev))
            return self._rev

    def delete(
        self,
        key: str,
        expected_mod_revision: Optional[int] = None,
        precondition=None,
    ) -> int:
        with self._lock:
            kv = self._data.get(key)
            if kv is None:
                raise KeyNotFound(key)
            if expected_mod_revision is not None and kv.mod_revision != expected_mod_revision:
                raise Conflict(
                    f"{key}: mod_revision {kv.mod_revision} != expected {expected_mod_revision}"
                )
            if precondition is not None:
                precondition()
            self._rev += 1
            del self._data[key]
            i = bisect.bisect_left(self._keys, key)
            del self._keys[i]
            self._emit(Event(DELETED, key, kv.value, self._rev))
            return self._rev

    def guaranteed_update(self, key: str, fn, max_retries: int = 16,
                          precondition=None) -> int:
        return guaranteed_update(self, key, fn, max_retries, precondition)

    # -- watch -------------------------------------------------------------

    def watch(self, prefix: str = "", since_revision: Optional[int] = None) -> Watch:
        """Events with revision > since_revision under prefix. since=None
        means 'from now' (live-only); any int — INCLUDING 0, the revision
        of an empty store — replays history after that revision, so a
        lister that saw revision 0 has no list->watch event gap. Raises
        Compacted if the backlog was trimmed past the requested
        revision."""
        with self._lock:
            w = Watch(self, prefix)
            if since_revision is not None:
                if since_revision < self._compacted_rev:
                    raise Compacted(
                        f"revision {since_revision} compacted (floor {self._compacted_rev})"
                    )
                for ev in self._history:
                    if ev.revision > since_revision:
                        w._deliver(ev)
            self._watches.append(w)
            return w

    def history_since(
        self, prefix: str = "", since_revision: int = 0,
    ) -> List[Event]:
        """Retained events with revision > since_revision under prefix —
        the watch() replay as a value, for fan-out hubs that attach a
        late watcher to an already-running shared stream: replay the gap
        under the store lock, then ride the shared live feed with no
        missed or duplicated event. Raises Compacted exactly as watch()
        would."""
        with self._lock:
            if since_revision < self._compacted_rev:
                raise Compacted(
                    f"revision {since_revision} compacted (floor {self._compacted_rev})"
                )
            return [
                ev for ev in self._history
                if ev.revision > since_revision and ev.key.startswith(prefix)
            ]

    def _remove_watch(self, w: Watch) -> None:
        with self._lock:
            try:
                self._watches.remove(w)
            except ValueError:
                pass

    def _emit(self, ev: Event) -> None:
        self._history.append(ev)
        while len(self._history) > self._history_limit:
            dropped = self._history.popleft()
            self._compacted_rev = dropped.revision
        for w in self._watches:
            w._deliver(ev)

    def compact(self, revision: int) -> None:
        """Drop history up to revision (etcd compaction)."""
        with self._lock:
            while self._history and self._history[0].revision <= revision:
                dropped = self._history.popleft()
                self._compacted_rev = dropped.revision


_EVENT_OPS = {ADDED: wal.OP_CREATE, MODIFIED: wal.OP_UPDATE, DELETED: wal.OP_DELETE}
_OP_EVENTS = {v: k for k, v in _EVENT_OPS.items()}


class DurableKVStore:
    """KVStore + append-only WAL + periodic snapshots — etcd's durability
    contract for the control plane (reference: etcd server/storage/wal +
    snap behind the apiserver's storage.Interface).

    Every mutation is framed into <path>/wal.log (store/wal.py) before it
    is acknowledged; every `snapshot_every` records the full state is
    written to <path>/snapshot.db and the WAL is rewritten down to the
    records that rebuild the retained event history. Construction (and
    the `recover` alias) replays snapshot+WAL back to the exact
    (rev, compacted_rev, data, history) the acknowledged writes produced:
    replay is idempotent — records at or below the snapshot revision only
    contribute history, records below the compaction floor contribute
    nothing — and a torn final record is discarded as the crash's own
    half-write, then truncated so appends resume at a record boundary.

    Values must be JSON-serializable (they are: the apiserver stores
    serde dicts). fsync=True acknowledges only durable writes — the
    crash drill's "zero lost acknowledged writes" assert rides on it;
    fsync=False trades the unsynced tail for write latency, exactly the
    etcd `--unsafe-no-fsync` posture.
    """

    supports_precondition = True

    def __init__(
        self,
        path: str,
        history_limit: int = 100_000,
        snapshot_every: int = 4096,
        fsync: bool = True,
    ):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._wal_path = os.path.join(path, "wal.log")
        self._snap_path = os.path.join(path, "snapshot.db")
        self._history_limit = history_limit
        self._snapshot_every = snapshot_every
        self._fsync = fsync
        # one writer lock over apply+log keeps WAL order == revision order
        self._dlock = threading.RLock()
        self._records_since_snapshot = 0
        self.incarnation = 0
        self._inner = self._rebuild()
        self._writer = wal.WALWriter(self._wal_path, fsync=fsync)

    @classmethod
    def recover(cls, path: str, **kw) -> "DurableKVStore":
        """Rebuild a store from its directory — what a restarted apiserver
        does. Recovery IS construction; the alias names the intent."""
        return cls(path, **kw)

    # -- recovery ----------------------------------------------------------

    def _rebuild(self) -> KVStore:
        inner = KVStore(history_limit=self._history_limit)
        snap = wal.read_snapshot(self._snap_path)
        if snap is not None:
            items, rev, compacted = snap
            with inner._lock:
                for key, value, create_rev, mod_rev in items:
                    inner._data[key] = KeyValue(key, value, create_rev, mod_rev)
                inner._keys = sorted(inner._data)
                inner._rev = rev
                inner._compacted_rev = compacted
        records, valid_end = wal.read_wal(self._wal_path)
        with inner._lock:
            for rec in records:
                self._replay(inner, rec)
            while len(inner._history) > self._history_limit:
                dropped = inner._history.popleft()
                inner._compacted_rev = dropped.revision
        # drop the torn tail so the next append starts a clean record
        wal.truncate(self._wal_path, valid_end)
        return inner

    @staticmethod
    def _replay(inner: KVStore, rec: "wal.Record") -> None:
        """Apply one WAL record; caller holds inner._lock. State applies
        only past the snapshot revision; history applies only past the
        compaction floor — together that makes replay idempotent."""
        if rec.op == wal.OP_COMPACT:
            DurableKVStore._apply_floor(inner, rec.compacted_rev)
            return
        if rec.rev > inner._rev:
            if rec.op == wal.OP_CREATE:
                inner._data[rec.key] = KeyValue(rec.key, rec.value, rec.rev, rec.rev)
                bisect.insort(inner._keys, rec.key)
            elif rec.op == wal.OP_UPDATE:
                prev = inner._data.get(rec.key)
                create_rev = prev.create_revision if prev is not None else rec.rev
                inner._data[rec.key] = KeyValue(rec.key, rec.value, create_rev, rec.rev)
            else:  # OP_DELETE
                if rec.key in inner._data:
                    del inner._data[rec.key]
                    i = bisect.bisect_left(inner._keys, rec.key)
                    del inner._keys[i]
            inner._rev = rec.rev
        if rec.rev > inner._compacted_rev:
            inner._history.append(
                Event(_OP_EVENTS[rec.op], rec.key, rec.value, rec.rev)
            )
        DurableKVStore._apply_floor(inner, rec.compacted_rev)

    @staticmethod
    def _apply_floor(inner: KVStore, floor: int) -> None:
        while inner._history and inner._history[0].revision <= floor:
            inner._history.popleft()
        if floor > inner._compacted_rev:
            inner._compacted_rev = floor

    # -- reads: delegate to the live in-memory store -----------------------

    @property
    def revision(self) -> int:
        return self._inner.revision

    @property
    def compacted_revision(self) -> int:
        return self._inner.compacted_revision

    def get(self, key: str) -> KeyValue:
        return self._inner.get(key)

    def list(self, prefix: str) -> Tuple[List[KeyValue], int]:
        return self._inner.list(prefix)

    def watch(self, prefix: str = "", since_revision: Optional[int] = None) -> Watch:
        # under _dlock: a watch racing crash() must not register on the
        # inner store being discarded — it would never be stopped/closed
        # and its reflector would poll a silent stream forever instead of
        # re-listing
        with self._dlock:
            return self._inner.watch(prefix, since_revision)

    def history_since(
        self, prefix: str = "", since_revision: int = 0,
    ) -> List[Event]:
        with self._dlock:
            return self._inner.history_since(prefix, since_revision)

    # -- writes: apply, then log before acknowledging ----------------------

    def create(self, key: str, value: Any) -> int:
        with self._dlock:
            rev = self._inner.create(key, value)
            self._log(wal.OP_CREATE, key, value, rev)
            return rev

    def update(
        self,
        key: str,
        value: Any,
        expected_mod_revision: Optional[int] = None,
        precondition=None,
    ) -> int:
        with self._dlock:
            rev = self._inner.update(key, value, expected_mod_revision,
                                     precondition=precondition)
            self._log(wal.OP_UPDATE, key, value, rev)
            return rev

    def delete(
        self,
        key: str,
        expected_mod_revision: Optional[int] = None,
        precondition=None,
    ) -> int:
        with self._dlock:
            # the DELETED event (and its WAL record) carries the last value
            prev = self._inner.get(key)
            rev = self._inner.delete(key, expected_mod_revision,
                                     precondition=precondition)
            self._log(wal.OP_DELETE, key, prev.value, rev)
            return rev

    def guaranteed_update(self, key: str, fn, max_retries: int = 16,
                          precondition=None) -> int:
        return guaranteed_update(self, key, fn, max_retries, precondition)

    def compact(self, revision: int) -> None:
        with self._dlock:
            self._inner.compact(revision)
            self._log(wal.OP_COMPACT, "", None, self._inner.revision)

    def _log(self, op: int, key: str, value: Any, rev: int) -> None:
        self._writer.append(
            wal.Record(op, key, value, rev, self._inner.compacted_revision)
        )
        self._records_since_snapshot += 1
        if self._records_since_snapshot >= self._snapshot_every:
            self._snapshot_locked()

    # -- snapshot / lifecycle ----------------------------------------------

    def snapshot(self) -> None:
        """Force a snapshot + WAL rotation now (tests / operator hook)."""
        with self._dlock:
            self._snapshot_locked()

    def _snapshot_locked(self) -> None:
        inner = self._inner
        with inner._lock:
            items = [
                (kvv.key, kvv.value, kvv.create_revision, kvv.mod_revision)
                for kvv in (inner._data[k] for k in inner._keys)
            ]
            rev = inner._rev
            compacted = inner._compacted_rev
            history = list(inner._history)
        wal.write_snapshot(self._snap_path, items, rev, compacted)
        # the retained WAL is exactly the records that rebuild the retained
        # history (floor, rev]; state at `rev` now lives in the snapshot
        self._writer.close()
        wal.rewrite(self._wal_path, [
            wal.Record(_EVENT_OPS[ev.type], ev.key, ev.value, ev.revision, compacted)
            for ev in history
        ])
        self._writer = wal.WALWriter(self._wal_path, fsync=self._fsync)
        self._records_since_snapshot = 0

    def sync(self) -> None:
        """Advance the durability watermark to everything written."""
        with self._dlock:
            self._writer.sync()

    def close(self) -> None:
        with self._dlock:
            self._writer.close()

    def crash(self, torn: bool = False) -> None:
        """SIGKILL-equivalent crash + restart as one atomic step: drop the
        in-memory state to what is durable on disk, then recover in place.
        Acknowledged-but-unsynced records (fsync=False) are lost exactly
        as a power cut would lose them; torn=True additionally leaves a
        half-written record at the tail (the write the crash caught
        mid-append), which recovery must discard. Every live watch dies
        marked `closed`, so reflectors re-list against the recovered
        revision — the restart-surviving watch contract."""
        with self._dlock:
            old = self._inner
            self._writer.crash(torn=torn)
            self._inner = self._rebuild()
            self._writer = wal.WALWriter(self._wal_path, fsync=self._fsync)
            self._records_since_snapshot = 0
            # the rebuilt store can re-mint (key, revision) pairs the old
            # incarnation already emitted (fsync=False rollback); anyone
            # caching per-revision artifacts must treat this as an epoch
            self.incarnation += 1
        with old._lock:
            watches = list(old._watches)
        for w in watches:
            w.stop()


def guaranteed_update(store, key: str, fn, max_retries: int = 16,
                      precondition=None) -> int:
    """Read-modify-write with conflict retry (etcd3 store.go:286
    GuaranteedUpdate's optimistic loop). fn(value) -> new value. Shared by
    every store backend so retry semantics can't diverge.

    `precondition` (zero-arg, raises to veto) is evaluated atomically with
    the commit on stores that support it (`supports_precondition`); on
    plain dict-backed stores it degrades to check-then-write — adequate
    for the fencing layer because a stale fence can only get MORE stale.
    """
    if precondition is not None and not getattr(
            store, "supports_precondition", False):
        for _ in range(max_retries):
            kv = store.get(key)
            new_value = fn(kv.value)
            precondition()
            try:
                return store.update(key, new_value, expected_mod_revision=kv.mod_revision)
            except Conflict:
                continue
        raise Conflict(f"{key}: too many conflicts in guaranteed_update")
    for _ in range(max_retries):
        kv = store.get(key)
        new_value = fn(kv.value)
        try:
            if precondition is not None:
                return store.update(key, new_value,
                                    expected_mod_revision=kv.mod_revision,
                                    precondition=precondition)
            return store.update(key, new_value, expected_mod_revision=kv.mod_revision)
        except Conflict:
            continue
    raise Conflict(f"{key}: too many conflicts in guaranteed_update")
