"""IKeyValueStore: the storage-engine abstraction and the memory engine
(the port of foundationdb_tpu/server/kvstore.py, whole).

Reference: fdbserver/IKeyValueStore.h (:45-50 -- set/clear/commit/
readValue/readRange behind an opaque factory openKVStore :120) and
fdbserver/KeyValueStoreMemory.actor.cpp: a log-structured engine -- the
full dataset lives in an ordered in-memory map; mutations are logged to a
DiskQueue WAL; a periodic snapshot bounds replay; recovery = load the
newest valid snapshot + replay the WAL suffix.  Acknowledged commits
survive a kill; a torn tail rolls back to the last durable commit
boundary.

Serialization of WAL records: op:1 | klen:4 | key | vlen:4 | value, one
DiskQueue record per commit (records are atomic under the queue's
checksum scan).  The snapshot file is seq:4 | items_len:4 | items | crc:4,
written to <prefix>.snap.new, fsynced and renamed over <prefix>.snap.

The calls are synchronous (the reference's commit and recover await its
simulated files), over a RealFileSystem (server/real_fs.py).
"""

from __future__ import annotations

import bisect
import struct
import zlib
from typing import Dict, List, Optional, Tuple

from ..core.trace import TraceEvent
from .disk_queue import DiskQueue

_OP_SET = 0
_OP_CLEAR = 1
_U32 = struct.Struct("<I")


def _enc_kv(op: int, a: bytes, b: bytes) -> bytes:
    return bytes([op]) + _U32.pack(len(a)) + a + _U32.pack(len(b)) + b


def _dec_ops(blob: bytes) -> List[Tuple[int, bytes, bytes]]:
    out = []
    i = 0
    while i < len(blob):
        op = blob[i]
        i += 1
        (la,) = _U32.unpack_from(blob, i)
        i += 4
        a = blob[i:i + la]
        i += la
        (lb,) = _U32.unpack_from(blob, i)
        i += 4
        b = blob[i:i + lb]
        i += lb
        out.append((op, a, b))
    return out


class IKeyValueStore:
    """Engine API (reference IKeyValueStore.h:45-50)."""

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def clear(self, begin: bytes, end: bytes) -> None:
        raise NotImplementedError

    def commit(self) -> None:
        raise NotImplementedError

    def read_value(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def read_range(self, begin: bytes, end: bytes, limit: int = 1 << 30
                   ) -> List[Tuple[bytes, bytes]]:
        raise NotImplementedError

    def recover(self) -> None:
        raise NotImplementedError

    def stats(self) -> dict:
        """Engine-shape counters (page counts, key counts); engines
        override with what they can report cheaply."""
        return {"engine": type(self).__name__}


class KVStoreMemory(IKeyValueStore):
    """Log-structured memory engine (reference KeyValueStoreMemory)."""

    SNAPSHOT_EVERY_BYTES = 1 << 20    # WAL bytes between snapshots

    def __init__(self, fs, prefix: str) -> None:
        self.fs = fs
        self.prefix = prefix
        self.queue = DiskQueue(fs.open(prefix + ".wal"))
        self._keys: List[bytes] = []
        self._map: Dict[bytes, bytes] = {}
        self._uncommitted: List[Tuple[int, bytes, bytes]] = []
        self._wal_bytes_since_snapshot = 0

    # -- mutation ------------------------------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        self._uncommitted.append((_OP_SET, key, value))

    def clear(self, begin: bytes, end: bytes) -> None:
        self._uncommitted.append((_OP_CLEAR, begin, end))

    def commit(self) -> None:
        """Log the batch as ONE record (atomic under recovery), fsync,
        then apply to the in-memory image."""
        batch, self._uncommitted = self._uncommitted, []
        if batch:
            blob = b"".join(_enc_kv(op, a, b) for op, a, b in batch)
            self.queue.push(blob)
            self._wal_bytes_since_snapshot += len(blob)
        self.queue.commit()
        for op, a, b in batch:
            self._apply(op, a, b)
        if self._wal_bytes_since_snapshot >= self.SNAPSHOT_EVERY_BYTES:
            self._write_snapshot()

    def _apply(self, op: int, a: bytes, b: bytes) -> None:
        if op == _OP_SET:
            if a not in self._map:
                bisect.insort(self._keys, a)
            self._map[a] = b
        else:
            lo = bisect.bisect_left(self._keys, a)
            hi = bisect.bisect_left(self._keys, b)
            for k in self._keys[lo:hi]:
                del self._map[k]
            del self._keys[lo:hi]

    # -- reads ---------------------------------------------------------------
    def read_value(self, key: bytes) -> Optional[bytes]:
        return self._map.get(key)

    def read_range(self, begin: bytes, end: bytes, limit: int = 1 << 30
                   ) -> List[Tuple[bytes, bytes]]:
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        return [(k, self._map[k]) for k in self._keys[lo:hi][:limit]]

    def stats(self) -> dict:
        return {"engine": "memory", "keys": len(self._keys),
                "wal_bytes_since_snapshot": self._wal_bytes_since_snapshot}

    # -- snapshot + recovery (reference log-structured snapshot + WAL) -------
    def _write_snapshot(self) -> None:
        """Write the full image to a fresh snapshot file, fsync it, rename
        it over the old one, then pop the WAL up to the snapshot point
        (the WAL is trimmed only after the snapshot is durable)."""
        snap_seq = self.queue.next_seq - 1
        blob = _U32.pack(snap_seq if snap_seq >= 0 else 0)
        items = b"".join(_enc_kv(_OP_SET, k, self._map[k])
                         for k in self._keys)
        payload = _U32.pack(len(items)) + items
        f = self.fs.open(self.prefix + ".snap.new")
        f.truncate(0)
        f.write(0, blob + payload + _U32.pack(zlib.crc32(blob + payload)))
        f.sync()
        # Atomic promote: the old snapshot is replaced only after sync.
        self.fs.rename(self.prefix + ".snap.new", self.prefix + ".snap")
        self.queue.pop(snap_seq)
        self._wal_bytes_since_snapshot = 0
        TraceEvent("KVStoreSnapshot").detail("Prefix", self.prefix).detail(
            "UpToSeq", snap_seq).detail("Keys", len(self._keys)).log()

    def recover(self) -> None:
        self._keys, self._map = [], {}
        base_seq = 0
        if self.fs.exists(self.prefix + ".snap"):
            f = self.fs.open(self.prefix + ".snap")
            data = f.read(0, f.size())
            if len(data) >= 12:
                crc_stored = _U32.unpack_from(data, len(data) - 4)[0]
                if zlib.crc32(data[:-4]) == crc_stored:
                    base_seq = _U32.unpack_from(data, 0)[0]
                    (items_len,) = _U32.unpack_from(data, 4)
                    for op, k, v in _dec_ops(data[8:8 + items_len]):
                        self._apply(op, k, v)
        records = self.queue.recover()
        replayed = 0
        for seq, blob in records:
            if seq <= base_seq:
                continue
            for op, a, b in _dec_ops(blob):
                self._apply(op, a, b)
            replayed += 1
        TraceEvent("KVStoreRecovered").detail(
            "Prefix", self.prefix).detail("SnapshotSeq", base_seq).detail(
            "WalRecords", replayed).detail("Keys", len(self._keys)).log()


def open_kv_store(engine: str, fs, prefix: str) -> IKeyValueStore:
    """Engine factory (reference openKVStore :120): "memory" or "btree"
    over `fs`'s files named from `prefix`."""
    if engine == "memory":
        return KVStoreMemory(fs, prefix)
    if engine == "btree":
        from .kvstore_btree import KVStoreBTree
        return KVStoreBTree(fs, prefix)
    raise ValueError(f"unknown storage engine {engine!r}")
