"""The worker's durable half: the boot scan of a data directory and the
recruitment of TLogs and storage servers over it (trimmed copy of
foundationdb_tpu/server/worker.py).

Reference: fdbserver/worker.actor.cpp -- at boot a worker re-instantiates
the durable roles it finds in its data directory (old-generation TLogs,
which serve lock and peek to the next recovery, and storage servers from
their engines) before registering; a recruited TLog starts at the
recovery version, carries its tags' data from the old generation and
records its starting version before it acknowledges recruitment.

Kept: the scan (_boot_scan :74-130) as boot_scan(), _init_tlog (:221-236)
as init_tlog(), and the engine half of _init_storage (:463-481) as
init_storage().  File names are the reference's: tlog-<id>.wal, and
storage-<tag>.wal and .snap (memory engine) or .btree.  The roles answer
within the call, so there is no worker process, registration, rejoin
transaction or engine migration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from time import perf_counter
from typing import Dict, List, Optional

from ..core.trace import Severity, TraceEvent
from ..txn.types import Version
from .disk_queue import DiskQueue
from .interfaces import Tag
from .kvstore import open_kv_store
from .kvstore_btree import PAGE_SIZE
from .storage import _META_KEY, StorageServer
from .tlog import TLog

# Each engine kind's files after the storage-<tag> prefix.
ENGINE_FILES = {"memory": (".wal", ".snap"), "btree": (".btree",)}


def tlog_file(tlog_id: str) -> str:
    return f"tlog-{tlog_id}.wal"


@dataclass
class BootScan:
    """The durable roles a data directory held."""

    tlogs: Dict[str, TLog] = field(default_factory=dict)     # by id
    storage: Dict[Tag, StorageServer] = field(default_factory=dict)
    engines: Dict[Tag, str] = field(default_factory=dict)    # tag -> kind
    dropped: List[str] = field(default_factory=list)         # twin files
    # Seconds spent rebuilding the TLogs and the storage servers, and the
    # bytes their recovery read (_recovered_bytes).
    tlog_s: float = 0.0
    storage_s: float = 0.0
    tlog_bytes: int = 0
    storage_bytes: int = 0


def _recovered_bytes(fs, prefix: str, kind: str, engine) -> int:
    """What an engine's recovery read: the memory engine's snapshot and
    WAL, or the B-tree's live pages (its page file is sparse: page ids
    freed within a commit are never written)."""
    if kind == "btree":
        st = engine.stats()
        return (st["page_count"] - st["free_pages"]) * PAGE_SIZE
    return sum(fs.size(prefix + ext) for ext in ENGINE_FILES[kind]
               if fs.exists(prefix + ext))


def boot_scan(fs) -> BootScan:
    """Re-instantiate the durable roles found in `fs` (a RealFileSystem):
    every tlog-<id>.wal through TLog.from_disk, and every storage prefix
    through StorageServer.from_engine of each engine kind found.  Where
    both kinds are found for one prefix (a kill between an engine
    migration's commit and its old files' removal), the one further
    along is kept (ties favour the B-tree) and the other's files are
    deleted."""
    scan = BootScan()
    storage_found: Dict[str, list] = {}
    for name in sorted(fs.files):
        if name.startswith("tlog-") and name.endswith(".wal"):
            tlog_id = name[len("tlog-"):-len(".wal")]
            t0 = perf_counter()
            f = fs.open(name)
            scan.tlog_bytes += f.size()
            scan.tlogs[tlog_id] = TLog.from_disk(tlog_id, DiskQueue(f))
            scan.tlog_s += perf_counter() - t0
        elif name.startswith("storage-") and (
                name.endswith(".wal") or name.endswith(".btree")):
            if name.endswith(".wal"):
                kind, prefix = "memory", name[:-len(".wal")]
            else:
                kind, prefix = "btree", name[:-len(".btree")]
            storage_found.setdefault(prefix, []).append(kind)
    t0 = perf_counter()
    for prefix, kinds in sorted(storage_found.items()):
        candidates = []
        for kind in kinds:
            engine = open_kv_store(kind, fs, prefix)
            ss = StorageServer.from_engine(engine)
            scan.storage_bytes += _recovered_bytes(fs, prefix, kind, engine)
            if ss is not None:
                candidates.append((ss.version, kind != "memory", kind, ss))
        if not candidates:
            continue
        candidates.sort(key=lambda c: c[:3])
        _v, _pref, kind, ss = candidates[-1]
        for _lv, _lp, lkind, _lss in candidates[:-1]:
            TraceEvent("WorkerBootScanTwinDropped", Severity.Warn).detail(
                "Prefix", prefix).detail("Kept", kind).detail(
                "Dropped", lkind).log()
            for ext in ENGINE_FILES[lkind]:
                fs.delete(prefix + ext)
                scan.dropped.append(prefix + ext)
        scan.storage[ss.tag] = ss
        scan.engines[ss.tag] = kind
    scan.storage_s = perf_counter() - t0
    if scan.tlogs or scan.storage:
        TraceEvent("WorkerBootScan").detail("TLogs", len(scan.tlogs)).detail(
            "Storage", len(scan.storage)).log()
    return scan


def init_tlog(fs, tlog_id: str, recovery_version: Version, epoch: int,
              recover_tags: Optional[Dict[Tag, TLog]] = None,
              recover_popped: Optional[Dict[Tag, Version]] = None) -> TLog:
    """Recruit a TLog of generation `epoch` at `recovery_version` over a
    fresh tlog-<id>.wal (a stale one under the same id is deleted first:
    a recovery scan must not walk into its synced tail), carry its tags'
    data from the old holders (TLog.recover_from), then durably record
    its starting version (TLog.write_genesis) before it serves."""
    name = tlog_file(tlog_id)
    fs.delete(name)
    tlog = TLog(tlog_id, recovery_version,
                disk_queue=DiskQueue(fs.open(name)), epoch=epoch)
    if recover_tags:
        tlog.recover_from(recover_tags, recover_popped or {},
                          recovery_version)
    tlog.write_genesis()
    return tlog


def init_storage(fs, ss_id: str, tag: Tag, engine: str,
                 log_system) -> StorageServer:
    """Recruit a storage server over a fresh engine of kind `engine`
    (stale files of every kind under its prefix are deleted: this runs
    only before any commit was acknowledged), its identity record made
    durable at version 0 before it serves, so a kill at any later point
    finds a recoverable store."""
    prefix = f"storage-{tag}"
    for exts in ENGINE_FILES.values():
        for ext in exts:
            fs.delete(prefix + ext)
    kv = open_kv_store(engine, fs, prefix)
    ss = StorageServer(ss_id, tag, log_system, engine=kv)
    kv.set(_META_KEY, ss._meta_blob(0))
    kv.commit()
    return ss
