"""ctypes binding for the native (C++) KV store — the etcd-equivalent.

Reference: the reference's store is etcd, a native process beside the
apiserver (SURVEY.md §2.4.2; staging/src/k8s.io/apiserver/pkg/storage/
etcd3). `NativeKVStore` is drop-in for store.kv.KVStore (same methods,
exceptions, and Watch surface — tests/test_store.py runs the same
suite over both), backed by native/kvstore.cpp:

  * values cross the boundary as JSON bytes, so callers can never alias
    stored state (the copy discipline the apiserver depends on);
  * watch polls block inside the shared library with the GIL released —
    N informers polling do not serialize the interpreter;
  * the library is built on demand with g++ (native/Makefile) — no
    pip/pybind11 (the environment bans installs; ctypes is stdlib).
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import subprocess
import threading
from typing import Any, Iterator, List, Optional, Tuple

from .kv import (
    ADDED,
    DELETED,
    MODIFIED,
    Compacted,
    Conflict,
    Event,
    KeyExists,
    KeyNotFound,
    KeyValue,
)

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libkvstore.so")
_EVENT_TYPES = {0: ADDED, 1: MODIFIED, 2: DELETED}

_lib = None
_lib_lock = threading.Lock()


def _build_library() -> None:
    subprocess.run(
        ["make", "-s", "build/libkvstore.so"],
        cwd=os.path.abspath(_NATIVE_DIR),
        check=True,
        capture_output=True,
    )


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the shared library; cached."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            _build_library()
        lib = ctypes.CDLL(os.path.abspath(_LIB_PATH))
        lib.kv_new.restype = ctypes.c_void_p
        lib.kv_new.argtypes = [ctypes.c_int64]
        lib.kv_free.argtypes = [ctypes.c_void_p]
        lib.kv_buf_free.argtypes = [ctypes.c_void_p]
        lib.kv_create.restype = ctypes.c_int64
        lib.kv_create.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.kv_update.restype = ctypes.c_int64
        lib.kv_update.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.kv_delete.restype = ctypes.c_int64
        lib.kv_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.kv_get.restype = ctypes.c_void_p
        lib.kv_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.kv_list.restype = ctypes.c_void_p
        lib.kv_list.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.kv_rev.restype = ctypes.c_int64
        lib.kv_rev.argtypes = [ctypes.c_void_p]
        lib.kv_compacted_rev.restype = ctypes.c_int64
        lib.kv_compacted_rev.argtypes = [ctypes.c_void_p]
        lib.kv_compact.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.kv_watch_new.restype = ctypes.c_int64
        lib.kv_watch_new.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.kv_watch_free.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.kv_watch_poll.restype = ctypes.c_void_p
        lib.kv_watch_poll.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return lib


def _take_buf(lib, ptr: int, length: int) -> bytes:
    try:
        return ctypes.string_at(ptr, length)
    finally:
        lib.kv_buf_free(ptr)


class NativeWatch:
    """Watch stream over a native watch id; poll blocks GIL-free."""

    def __init__(self, store: "NativeKVStore", wid: int):
        self._store = store
        self._wid = wid
        self._stopped = threading.Event()

    @property
    def closed(self) -> bool:
        """Dead-stream marker (kv.Watch.closed parity): reflectors
        re-list when the stream they poll has been stopped."""
        return self._stopped.is_set()

    def stop(self) -> None:
        if not self._stopped.is_set():
            self._stopped.set()
            self._store._lib.kv_watch_free(self._store._h, self._wid)

    def poll(self, timeout: Optional[float] = None) -> Optional[Event]:
        # timeout=None blocks until an event or stop() (kv.Watch.poll
        # semantics); the native wait wakes on stop via the store CV, so
        # loop in bounded chunks rather than waiting forever in C
        while True:
            if self._stopped.is_set():
                return None
            ms = 3_600_000 if timeout is None else int(timeout * 1000)
            out_len = ctypes.c_int64()
            ptr = self._store._lib.kv_watch_poll(
                self._store._h, self._wid, ms, ctypes.byref(out_len)
            )
            if ptr:
                break
            if timeout is not None:
                return None
        buf = _take_buf(self._store._lib, ptr, out_len.value)
        etype = buf[0]
        klen = struct.unpack_from("<I", buf, 1)[0]
        key = buf[5 : 5 + klen].decode()
        off = 5 + klen
        vlen = struct.unpack_from("<I", buf, off)[0]
        value = json.loads(buf[off + 4 : off + 4 + vlen]) if vlen else None
        rev = struct.unpack_from("<q", buf, off + 4 + vlen)[0]
        return Event(_EVENT_TYPES[etype], key, value, rev)

    def __iter__(self) -> Iterator[Event]:
        while not self._stopped.is_set():
            ev = self.poll(timeout=0.2)
            if ev is not None:
                yield ev


class NativeKVStore:
    """Drop-in KVStore over the C++ library (same API surface)."""

    #: the C side cannot evaluate a Python precondition inside its write
    #: lock; callers get check-then-write (see kv.guaranteed_update) —
    #: adequate for fencing (a stale fence only gets MORE stale) but not
    #: atomic, so the capability flag stays honest
    supports_precondition = False

    def __init__(self, history_limit: int = 100_000):
        self._lib = load_library()
        self._h = self._lib.kv_new(history_limit)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.kv_free(self._h)
                self._h = None
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass

    # -- reads -------------------------------------------------------------

    @property
    def revision(self) -> int:
        return self._lib.kv_rev(self._h)

    @property
    def compacted_revision(self) -> int:
        return self._lib.kv_compacted_rev(self._h)

    def get(self, key: str) -> KeyValue:
        out_len = ctypes.c_int64()
        create_rev = ctypes.c_int64()
        mod_rev = ctypes.c_int64()
        ptr = self._lib.kv_get(
            self._h, key.encode(), ctypes.byref(out_len),
            ctypes.byref(create_rev), ctypes.byref(mod_rev),
        )
        if not ptr:
            raise KeyNotFound(key)
        value = json.loads(_take_buf(self._lib, ptr, out_len.value))
        return KeyValue(key, value, create_rev.value, mod_rev.value)

    def list(self, prefix: str) -> Tuple[List[KeyValue], int]:
        out_len = ctypes.c_int64()
        ptr = self._lib.kv_list(self._h, prefix.encode(), ctypes.byref(out_len))
        buf = _take_buf(self._lib, ptr, out_len.value)
        n = struct.unpack_from("<I", buf, 0)[0]
        off = 4
        items: List[KeyValue] = []
        for _ in range(n):
            klen = struct.unpack_from("<I", buf, off)[0]
            key = buf[off + 4 : off + 4 + klen].decode()
            off += 4 + klen
            vlen = struct.unpack_from("<I", buf, off)[0]
            value = json.loads(buf[off + 4 : off + 4 + vlen])
            off += 4 + vlen
            create_rev, mod_rev = struct.unpack_from("<qq", buf, off)
            off += 16
            items.append(KeyValue(key, value, create_rev, mod_rev))
        rev = struct.unpack_from("<q", buf, off)[0]
        return items, rev

    # -- writes ------------------------------------------------------------

    def create(self, key: str, value: Any) -> int:
        data = json.dumps(value).encode()
        rev = self._lib.kv_create(self._h, key.encode(), data, len(data))
        if rev == -1:
            raise KeyExists(key)
        return rev

    def update(
        self, key: str, value: Any, expected_mod_revision: Optional[int] = None,
        precondition=None,
    ) -> int:
        if precondition is not None:
            precondition()
        data = json.dumps(value).encode()
        expected = -1 if expected_mod_revision is None else expected_mod_revision
        rev = self._lib.kv_update(self._h, key.encode(), data, len(data), expected)
        if rev == -1:
            raise KeyNotFound(key)
        if rev == -2:
            raise Conflict(
                f"{key}: mod_revision != expected {expected_mod_revision}"
            )
        return rev

    def delete(self, key: str, expected_mod_revision: Optional[int] = None,
               precondition=None) -> int:
        if precondition is not None:
            precondition()
        expected = -1 if expected_mod_revision is None else expected_mod_revision
        rev = self._lib.kv_delete(self._h, key.encode(), expected)
        if rev == -1:
            raise KeyNotFound(key)
        if rev == -2:
            raise Conflict(
                f"{key}: mod_revision != expected {expected_mod_revision}"
            )
        return rev

    def guaranteed_update(self, key: str, fn, max_retries: int = 16,
                          precondition=None) -> int:
        from .kv import guaranteed_update

        return guaranteed_update(self, key, fn, max_retries, precondition)

    def compact(self, revision: int) -> None:
        """Drop history up to revision (etcd compaction)."""
        self._lib.kv_compact(self._h, revision)

    # -- watch -------------------------------------------------------------

    def watch(
        self, prefix: str = "", since_revision: Optional[int] = None
    ) -> NativeWatch:
        # None = live-only (kv.py semantics); the C side uses -1 for that.
        # 0 replays from the beginning (empty-store list revision).
        since = -1 if since_revision is None else since_revision
        wid = self._lib.kv_watch_new(self._h, prefix.encode(), since)
        if wid == -2:
            raise Compacted(
                f"revision {since_revision} compacted "
                f"(floor {self._lib.kv_compacted_rev(self._h)})"
            )
        return NativeWatch(self, wid)
