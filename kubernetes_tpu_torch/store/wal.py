"""Write-ahead-log + snapshot framing for the durable KV store.

The reference's store is etcd, whose durability contract is exactly this
pair: an fsync'd append-only WAL of raft entries plus periodic snapshots
that bound replay (etcd server/storage/wal, snap). The on-disk grammar
here deliberately mirrors native/kvstore.cpp's wire framing (watch-poll
event buffers and kv_list result buffers) so the two backends can share
tooling:

  WAL record   frame   = len:u32 | crc32:u32 | payload
               payload = op:u8 | klen:u32 | key | vlen:u32 | value_json
                         | rev:i64 | compacted_rev:i64
  Snapshot     header  = magic 'KVSN' | version:u32 | rev:i64
                         | compacted_rev:i64 | count:u32
               entry   = klen:u32 | key | vlen:u32 | value_json
                         | create_rev:i64 | mod_rev:i64   (kv_list framing)
               trailer = crc32:u32 over header+entries

All integers little-endian. A torn final WAL record (short frame, short
payload, or CRC mismatch) terminates replay cleanly: it is the
half-written record of the crash itself, never an acknowledged write —
acknowledgements happen only after the fsync that made the record whole.
Snapshots are written tmp-then-rename, so the snapshot file is never
torn; a crash between snapshot and WAL rotation leaves stale WAL records
behind, which replay skips idempotently.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Iterator, List, NamedTuple, Optional, Tuple

OP_CREATE = 0  # matches the native event type ids (kvstore.cpp)
OP_UPDATE = 1
OP_DELETE = 2
OP_COMPACT = 3
# wire-only op: the HTTP watch path frames its keep-alive ticks in the
# same record grammar so a binary stream is records all the way down.
# Never valid on disk — WAL replay knows only ops 0..3.
OP_HEARTBEAT = 4

_FRAME = struct.Struct("<II")  # payload length, crc32(payload)
_U32 = struct.Struct("<I")
_TAIL = struct.Struct("<qq")  # rev, compacted_rev
_SNAP_HEAD = struct.Struct("<qqI")  # rev, compacted_rev, entry count
_ENTRY_REVS = struct.Struct("<qq")  # create_rev, mod_rev
_SNAP_MAGIC = b"KVSN"
_SNAP_VERSION = 1


class WALError(Exception):
    """Unrecoverable on-disk corruption (NOT a torn tail, which is normal)."""


class Record(NamedTuple):
    op: int
    key: str
    value: Any  # CREATE/UPDATE: new value; DELETE: last value; COMPACT: None
    rev: int
    compacted_rev: int  # the store's compaction floor AFTER this op


def encode_record(rec: Record) -> bytes:
    key = rec.key.encode()
    val = json.dumps(rec.value).encode()
    payload = b"".join((
        bytes((rec.op,)),
        _U32.pack(len(key)), key,
        _U32.pack(len(val)), val,
        _TAIL.pack(rec.rev, rec.compacted_rev),
    ))
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def _decode_payload(payload: bytes) -> Record:
    op = payload[0]
    klen = _U32.unpack_from(payload, 1)[0]
    key = payload[5:5 + klen].decode()
    off = 5 + klen
    vlen = _U32.unpack_from(payload, off)[0]
    value = json.loads(payload[off + 4:off + 4 + vlen])
    rev, compacted_rev = _TAIL.unpack_from(payload, off + 4 + vlen)
    return Record(op, key, value, rev, compacted_rev)


def iter_records(buf: bytes) -> Iterator[Tuple[Record, int]]:
    """(record, end_offset) pairs; stops silently at a torn/corrupt tail."""
    off = 0
    n = len(buf)
    while n - off >= _FRAME.size:
        plen, crc = _FRAME.unpack_from(buf, off)
        start = off + _FRAME.size
        if start + plen > n:
            return  # torn tail: frame promised more bytes than exist
        payload = buf[start:start + plen]
        if zlib.crc32(payload) != crc:
            return  # torn tail: record half-written when the crash hit
        try:
            rec = _decode_payload(payload)
        except (IndexError, struct.error, ValueError, UnicodeDecodeError):
            return
        off = start + plen
        yield rec, off


def read_wal(path: str) -> Tuple[List[Record], int]:
    """All intact records + the byte offset where the intact prefix ends
    (the truncation point that drops a torn tail)."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except FileNotFoundError:
        return [], 0
    records: List[Record] = []
    end = 0
    for rec, off in iter_records(buf):
        records.append(rec)
        end = off
    return records, end


def truncate(path: str, offset: int) -> None:
    """Drop everything past offset (the torn tail) so appends resume at a
    record boundary."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size <= offset:
        return
    with open(path, "r+b") as f:
        f.truncate(offset)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    # the rename itself must be durable, or a crash can resurrect the
    # replaced file (the classic create-rename-fsync dance)
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def rewrite(path: str, records: List[Record]) -> None:
    """Atomically replace the WAL with exactly `records` (rotation)."""
    _atomic_write(path, b"".join(encode_record(r) for r in records))


def snapshot_header(count: int, rev: int, compacted_rev: int) -> bytes:
    return (_SNAP_MAGIC + _U32.pack(_SNAP_VERSION)
            + _SNAP_HEAD.pack(rev, compacted_rev, count))


def encode_snapshot_entry(
    key: str, value: Any, create_rev: int, mod_rev: int,
) -> bytes:
    """One kv_list-framed entry — the unit the HTTP binary list streams."""
    k = key.encode()
    val = json.dumps(value).encode()
    return (_U32.pack(len(k)) + k + _U32.pack(len(val)) + val
            + _ENTRY_REVS.pack(create_rev, mod_rev))


def encode_snapshot(
    items: List[Tuple[str, Any, int, int]],  # (key, value, create_rev, mod_rev)
    rev: int,
    compacted_rev: int,
) -> bytes:
    body = bytearray()
    body += snapshot_header(len(items), rev, compacted_rev)
    for key, value, create_rev, mod_rev in items:
        body += encode_snapshot_entry(key, value, create_rev, mod_rev)
    body += _U32.pack(zlib.crc32(bytes(body)))
    return bytes(body)


def write_snapshot(
    path: str,
    items: List[Tuple[str, Any, int, int]],  # (key, value, create_rev, mod_rev)
    rev: int,
    compacted_rev: int,
) -> None:
    _atomic_write(path, encode_snapshot(items, rev, compacted_rev))


def decode_snapshot(
    buf: bytes, label: str = "<buf>",
) -> Tuple[List[Tuple[str, Any, int, int]], int, int]:
    """-> (items, rev, compacted_rev). Raises WALError on corruption."""
    head_len = len(_SNAP_MAGIC) + _U32.size + _SNAP_HEAD.size
    if len(buf) < head_len + _U32.size or buf[:4] != _SNAP_MAGIC:
        raise WALError(f"snapshot {label}: bad magic/size")
    if zlib.crc32(buf[:-4]) != _U32.unpack_from(buf, len(buf) - 4)[0]:
        raise WALError(f"snapshot {label}: checksum mismatch")
    version = _U32.unpack_from(buf, 4)[0]
    if version != _SNAP_VERSION:
        raise WALError(f"snapshot {label}: unknown version {version}")
    rev, compacted_rev, count = _SNAP_HEAD.unpack_from(buf, 8)
    off = head_len
    items: List[Tuple[str, Any, int, int]] = []
    try:
        for _ in range(count):
            klen = _U32.unpack_from(buf, off)[0]
            key = buf[off + 4:off + 4 + klen].decode()
            off += 4 + klen
            vlen = _U32.unpack_from(buf, off)[0]
            value = json.loads(buf[off + 4:off + 4 + vlen])
            off += 4 + vlen
            create_rev, mod_rev = _ENTRY_REVS.unpack_from(buf, off)
            off += _ENTRY_REVS.size
            items.append((key, value, create_rev, mod_rev))
    except (struct.error, ValueError, UnicodeDecodeError) as e:
        raise WALError(f"snapshot {label}: truncated entries: {e}")
    return items, rev, compacted_rev


def read_snapshot(
    path: str,
) -> Optional[Tuple[List[Tuple[str, Any, int, int]], int, int]]:
    """-> (items, rev, compacted_rev), or None when no snapshot exists.
    Raises WALError on corruption: snapshots are written atomically, so a
    bad one is disk damage, not a crash artifact."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except FileNotFoundError:
        return None
    return decode_snapshot(buf, label=path)


class WALWriter:
    """Append-only record log with explicit durability tracking.

    `durable_offset` is the byte count known to be on the platter: with
    fsync=True it tracks every append (each acknowledged write is
    durable, etcd's contract); with fsync=False it only advances on
    sync(), and crash() discards the in-between — exactly what a power
    cut does to the OS page cache."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self._do_fsync = fsync
        self._f = open(path, "ab")
        # pre-existing bytes either were fsynced by their writer or
        # survived a real crash: both count as durable
        self.durable_offset = self._f.tell()

    def append(self, rec: Record) -> None:
        self._f.write(encode_record(rec))
        self._f.flush()
        if self._do_fsync:
            os.fsync(self._f.fileno())
            self.durable_offset = self._f.tell()

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self.durable_offset = self._f.tell()

    def close(self, sync: bool = True) -> None:
        if self._f.closed:
            return
        if sync:
            self.sync()
        self._f.close()

    def crash(self, torn: bool = False) -> None:
        """SIGKILL-equivalent: abandon the handle, drop every byte past
        the last fsync, and (optionally) leave a half-written record at
        the tail — the write the crash caught mid-append."""
        durable = self.durable_offset
        try:
            self._f.close()  # without flush-ordering guarantees; see below
        except OSError:
            pass
        # close() flushed Python's buffer into the page cache, but a real
        # crash loses the page cache too: model it by truncating to the
        # fsync watermark
        truncate(self.path, durable)
        if torn:
            junk = encode_record(
                Record(OP_CREATE, "__torn__", {"torn": True}, 1 << 60, 0)
            )
            with open(self.path, "ab") as f:
                f.write(junk[: len(junk) // 2])
