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
init_storage(), which StaticCluster calls within the call.  File names are
the reference's: tlog-<id>.wal, and storage-<tag>.wal and .snap (memory
engine) or .btree.

Worker (:28-912) is the recruitment surface of a process of SimFdbCluster
(server/cluster.py): the boot scan of its machine's files (the roles it
finds run on the process), registration with each new cluster
controller (_register_loop :825, re-announced every 10 s of simulated
time as the reference's stats announce re-registers), the ServerDBInfo
watch that re-targets its storage servers at each epoch's TLogs
(_watch_db_info :754), the guarded init loops (_serve_inits :188) and
_init_master, _init_tlog, _init_commit_proxy, _init_grv_proxy,
_init_ratekeeper, _init_data_distributor, _init_resolver and
_init_storage, _gc_tlog_files, _serve_wait_failure and _serve_ping.  The
port's roles call each other within the call where they did before (a
proxy's log system, a storage server's pulls), so a recruited role's
interface carries its role as a backref, `interface.role`, which the
wire leaves out.  A Resolver role's conflict set is built by the port's
factory with the cluster's backend on the cluster's device.  A storage
server pulls on each read, and the worker's update loop makes its
engine durable and pops the logs once a second of simulated time (the
reference's _update_storage_loop, which the port's role runs a pass of
at a time).

_commit_server_tags and _rejoin_storage write the server registry for
each storage server recruited here or brought back by the boot scan.
Every storage server here carries its engine's kind (engine_name, on
its interface too) and make_engine_factory's factory (the reference's
_ENGINE_FILES, here ENGINE_FILES, and _make_engine_factory), with which
the wiggle's MigrateEngineRequest re-images it onto another engine.  A
storage server recruited into a serving epoch (by data distribution,
for a lost one) owns no span until a move's fetch gives it one.
_init_data_distributor runs the distributor with this worker's
ServerDBInfo and the request's epoch.

Worker.run installs the slow-task detector on the loop (:878-881) and
starts the sampling profiler under FDB_PROFILE=1.  A storage server whose
durability pass fails (an io_error from its disk) kills its process, as a
TLog whose sync fails does (server/tlog.py _die_on_disk_error).

Left out: the backup worker, the log router, the storage cache and its
watch, the knob watch, the health monitor and the machine stats and
metrics of the registration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from time import perf_counter
from typing import Dict, List, Optional

from ..core.trace import Severity, TraceEvent
from ..rpc.endpoint import RequestStream
from ..txn.types import Version
from .disk_queue import DiskQueue
from .interfaces import Tag
from .kvstore import open_kv_store
from .kvstore_btree import PAGE_SIZE
from .shardmap import RangeMap
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
    ss.engine_name = engine
    ss.interface.engine_name = engine
    kv.set(_META_KEY, ss._meta_blob(0))
    kv.commit()
    return ss


def make_engine_factory(fs, tag: Tag, ss: StorageServer):
    """The storage server's `name -> (new engine, cleanup_old)` factory
    for an engine migration (reference _make_engine_factory :251-270):
    stale files of the target kind are deleted before the new engine
    opens, and cleanup_old deletes the old kind's files (the boot scan
    recovers by extension: a leftover would come back as a twin)."""
    prefix = f"storage-{tag}"

    def factory(name: str):
        for ext in ENGINE_FILES.get(name, ()):
            fs.delete(prefix + ext)
        new_engine = open_kv_store(name, fs, prefix)

        def cleanup_old(_old=ss.engine_name):
            for ext in ENGINE_FILES.get(_old, ()):
                fs.delete(prefix + ext)
        return new_engine, cleanup_old

    return factory


class Worker:
    """One process's recruitment surface (reference workerServer)."""

    UPDATE_STORAGE_INTERVAL = 1.0
    REANNOUNCE_INTERVAL = 10.0

    def __init__(self, process, coordinators, process_class: str = "unset",
                 config=None, device=None, set_kwargs=None) -> None:
        """`config`: the cluster's DatabaseConfiguration (the storage
        engine, log replication and conflict backend of its roles).
        `device` and `set_kwargs`: where and how a recruited Resolver
        role's conflict set is built (conflict/api.py new_conflict_set)."""
        from ..core.futures import AsyncVar, Promise
        from .interfaces import ServerDBInfo, WorkerInterface
        self.process = process
        self.coordinators = coordinators
        self.process_class = process_class
        self.config = config
        self.device = device
        self.set_kwargs = dict(set_kwargs or {})
        self.interface = WorkerInterface(process.name)
        self.db_info: AsyncVar = AsyncVar(ServerDBInfo())
        self.storage_roles: List[StorageServer] = []
        # Every log and storage role hosted here, by id and tag: the boot
        # scan's and the recruited ones, reported to the controller so a
        # recovery resolves the core state's ids to live interfaces.
        self.recovered_logs: Dict[str, object] = {}
        self.recovered_storage: Dict[Tag, object] = {}
        self.storage_versions: Dict[Tag, int] = {}
        self.roles: List[object] = []       # every role this worker runs
        self._current_cc = None
        self._rejoin_f = None
        self._scanned: Promise = Promise()

    def _fs(self):
        from ..rpc.sim import get_simulator
        return get_simulator().fs_for(self.process)

    def _log_replication(self) -> int:
        return getattr(self.config, "log_replication", 1) \
            if self.config else 1

    def _log_system(self, tlogs, replication: int):
        from .commit_proxy import LogSystemClient
        return LogSystemClient([t.role for t in tlogs], replication)

    def _stamp_locality(self, ss: StorageServer) -> None:
        loc = self.process.locality
        ss.interface.locality = (loc.dcid, loc.zoneid, loc.machineid)

    def _run_role(self, role) -> None:
        role.run(self.process)
        self.roles.append(role)

    # -- boot-time disk scan (reference worker.actor.cpp data-dir scan) ------
    async def _boot_scan(self) -> None:
        """Bring back the durable roles of this machine's files before the
        first registration: old-generation TLogs (lock and peek for the
        next recovery) and storage servers."""
        try:
            scan = boot_scan(self._fs())
            for tlog_id, tlog in scan.tlogs.items():
                self._run_role(tlog)
                self.recovered_logs[tlog_id] = tlog.interface
            for tag, ss in sorted(scan.storage.items()):
                ss.engine_name = scan.engines[tag]
                ss.interface.engine_name = ss.engine_name
                ss._engine_factory = make_engine_factory(self._fs(), tag, ss)
                self._run_role(ss)
                self._stamp_locality(ss)
                self.storage_roles.append(ss)
                self.recovered_storage[tag] = ss.interface
                self.storage_versions[tag] = ss.version
            if self.recovered_storage:
                self._rejoin_f = self.process.spawn(
                    self._rejoin_storage(), f"{self.process.name}.ssRejoin")
        finally:
            self._scanned.send(None)

    async def _commit_server_tags(self, tags: Dict[Tag, object]) -> None:
        """Write {tag: interface} into the server registry through the
        database (reference: a storage server's serverList entry, written
        when it is recruited and when it rejoins): every commit proxy
        takes the newest incarnation into its directory, and the next
        recovery replays it.  Retries until it commits: the transaction
        system may itself be recovering."""
        from ..client.database import ClusterConnection, Database
        from ..core.error import FdbError
        from .system_data import server_tag_key, server_tag_value
        db = Database(ClusterConnection(self.coordinators))
        try:
            t = db.create_transaction()
            t.access_system_keys = True
            while True:
                try:
                    for tag, iface in tags.items():
                        t.set(server_tag_key(tag), server_tag_value(iface))
                    await t.commit()
                    TraceEvent("SSRegistryCommitted").detail(
                        "Worker", self.process.name).detail(
                        "Tags", sorted(tags)).log()
                    return
                except FdbError as e:
                    await t.on_error(e)
        finally:
            db.cluster.close()

    async def _rejoin_storage(self) -> None:
        await self._commit_server_tags(dict(self.recovered_storage))

    # -- role instantiation --------------------------------------------------
    async def _serve_inits(self, queue, handler, name: str) -> None:
        """A failing recruitment answers its error and the loop goes on
        (a dead loop would break every later recruitment here)."""
        async for req in queue:
            try:
                await handler(req)
            except Exception as e:  # noqa: BLE001
                TraceEvent("WorkerInitFailed", Severity.Error).detail(
                    "Init", name).detail("Worker", self.process.name).detail(
                    "Error", repr(e)).log()
                if req.reply is not None and not req.reply.is_set():
                    req.reply.send_error(e)

    async def _init_master(self, req) -> None:
        from ..core.scheduler import now
        from .master import Master, master_server
        master = Master(epoch=req.epoch, clock=now)
        # Registered before the reply, which carries the interface.
        for s in master.interface.streams():
            self.process.register(s)
        self.roles.append(master)
        self.process.spawn(
            master_server(master, self.process, self.coordinators,
                          self.config, req.cc),
            f"{self.process.name}.master")
        req.reply.send(master.interface)

    async def _init_tlog(self, req) -> None:
        tlog = init_tlog(self._fs(), req.tlog_id, req.recovery_version,
                         req.epoch,
                         {t: i.role for t, i in req.recover_tags.items()},
                         dict(req.recover_popped))
        self._run_role(tlog)
        self._gc_tlog_files(req.epoch)
        self.recovered_logs[req.tlog_id] = tlog.interface
        self._announce_roles()
        req.reply.send(tlog.interface)

    def _gc_tlog_files(self, epoch: int) -> None:
        """Delete TLog files two or more generations old: epoch e carried
        every record of e-1 it needed into its own queues, so e-2 and
        older are never locked again."""
        fs = self._fs()
        for name in list(fs.files):
            if not (name.startswith("tlog-") and name.endswith(".wal")):
                continue
            tid = name[len("tlog-"):-len(".wal")]
            if ".e" not in tid:
                continue
            try:
                file_epoch = int(tid.rsplit(".e", 1)[1])
            except ValueError:
                continue
            if file_epoch <= epoch - 2:
                fs.delete(name)

    async def _init_commit_proxy(self, req) -> None:
        from .commit_proxy import CommitProxy
        from .shardmap import RangeMap
        key_servers: RangeMap = RangeMap(default=None)
        for b, e, tags in req.key_servers_ranges:
            key_servers.set_range(b, e, list(tags))
        proxy = CommitProxy(
            req.proxy_id, [r.role for r in req.resolvers],
            list(req.key_resolvers_ranges),
            recovery_version=req.recovery_version, master=req.master.role,
            log_system=self._log_system(req.tlogs, self._log_replication()),
            key_servers=key_servers)
        proxy.storage_interfaces = dict(req.storage_interfaces)
        self._run_role(proxy)
        req.reply.send(proxy.interface)

    async def _init_grv_proxy(self, req) -> None:
        from .grv_proxy import GrvProxy
        proxy = GrvProxy(req.proxy_id, req.master.role,
                         [t.role for t in req.tlogs])
        self._run_role(proxy)
        req.reply.send(proxy.interface)

    async def _init_ratekeeper(self, req) -> None:
        from .ratekeeper import Ratekeeper
        rk = Ratekeeper(req.rk_id)
        self._run_role(rk)
        req.reply.send(rk.interface)

    async def _init_data_distributor(self, req) -> None:
        from ..client.database import ClusterConnection, Database
        from .data_distribution import DataDistributor
        dd = DataDistributor(req.dd_id,
                             Database(ClusterConnection(self.coordinators)),
                             req.storage_interfaces, req.key_servers_ranges,
                             replication=req.replication)
        # This worker's ServerDBInfo: the distributor recruits through its
        # cluster controller and halts when a later epoch names another.
        dd.run(self.process, db_info_var=self.db_info, epoch=req.epoch)
        self.roles.append(dd)
        req.reply.send(dd.interface)

    async def _init_resolver(self, req) -> None:
        from .resolver import Resolver
        backend = getattr(self.config, "conflict_backend", None) or "torch"
        r = Resolver(req.resolver_id, req.recovery_version, backend=backend,
                     proxy_ids=list(req.proxy_ids), device=self.device,
                     **self.set_kwargs)
        self._run_role(r)
        req.reply.send(r.interface)

    async def _init_storage(self, req) -> None:
        """A fresh storage server (only before any commit was
        acknowledged: stale files under its tag are deleted), pulling from
        the current epoch's TLogs once they are broadcast."""
        # A previous recruitment of this tag here (a failed earlier
        # recovery attempt) is replaced.
        for old in [s for s in self.storage_roles if s.tag == req.tag]:
            self.storage_roles.remove(old)
        # A rejoin still retrying carries the replaced interface: cancel
        # it before it can land after this recruitment's registry write,
        # and rejoin the other recovered tags on their own.
        rejoin_f = self._rejoin_f
        if rejoin_f is not None and not rejoin_f.is_ready():
            rejoin_f.cancel()
            remaining = {t: i for t, i in self.recovered_storage.items()
                         if t != req.tag}
            if remaining:
                self._rejoin_f = self.process.spawn(
                    self._commit_server_tags(remaining),
                    f"{self.process.name}.ssRejoin")
        info = self.db_info.get()
        ls = (self._log_system(info.tlogs, self._log_replication())
              if info.tlogs else None)
        engine = req.engine or getattr(self.config, "storage_engine",
                                       "memory")
        ss = init_storage(self._fs(), req.ss_id, req.tag, engine, ls)
        ss._engine_factory = make_engine_factory(self._fs(), req.tag, ss)
        if ls is not None:
            # Recruited by data distribution into a serving epoch: it
            # holds nothing until a move's fetch gives it a span.
            ss.shards = RangeMap(default=("absent", 0))
        self._run_role(ss)
        self._stamp_locality(ss)
        self.storage_roles.append(ss)
        self.recovered_storage[req.tag] = ss.interface
        self.storage_versions[req.tag] = 0
        self._announce_roles()
        self.process.spawn(self._commit_server_tags({req.tag: ss.interface}),
                           f"{self.process.name}.ssRegistry")
        req.reply.send(ss.interface)

    def _announce_roles(self) -> None:
        """Refresh the controller's entry for this worker (reference
        registrationClient re-registers when its roles change)."""
        from .interfaces import RegisterWorkerRequest
        if self._current_cc is None:
            return
        loc = self.process.locality
        for ss in self.storage_roles:
            self.storage_versions[ss.tag] = ss.version
        RequestStream.at(self._current_cc.register_worker.endpoint).send(
            RegisterWorkerRequest(
                worker=self.interface, process_class=self.process_class,
                recovered_logs=dict(self.recovered_logs),
                recovered_storage=dict(self.recovered_storage),
                storage_versions=dict(self.storage_versions),
                locality=(loc.dcid, loc.zoneid, loc.machineid)))

    async def _reannounce_loop(self) -> None:
        """Re-register every REANNOUNCE_INTERVAL seconds: the one-way
        registration has no acknowledgement, and one sent to a controller
        a moment before its stream exists is lost (the reference's stats
        announce loop heals it the same way)."""
        from ..core.scheduler import delay
        while True:
            await delay(self.REANNOUNCE_INTERVAL)
            self._announce_roles()

    async def _update_storage_loop(self) -> None:
        """Once a second: every storage server here pulls to what the
        logs hold durably and makes it durable in its engine, popping the
        logs there (StorageServer.update_storage)."""
        from ..core.scheduler import delay
        while True:
            await delay(self.UPDATE_STORAGE_INTERVAL)
            for ss in list(self.storage_roles):
                if ss.log_system is None:
                    continue
                try:
                    ss._reaches(ss.log_system.durable_version())
                    ss.update_storage()
                except Exception as e:
                    self._die_on_storage_error(ss, e)
                    raise

    def _die_on_storage_error(self, ss, e: Exception) -> None:
        """A storage server whose durability pass fails kills its process
        (reference: io_error kills fdbserver): durable_version would
        freeze while the cluster acknowledged commits, so the failure
        monitors must fire and data distribution re-replicate."""
        from ..core.coverage import test_coverage
        from ..core.error import FdbError
        if isinstance(e, FdbError) and e.name == "io_error":
            test_coverage("StorageIoErrorDeath")
        TraceEvent("SSUpdateStorageError", Severity.Error).detail(
            "Id", ss.id).detail("Error", repr(e)).log()
        self.process.die(f"SSUpdateStorageError:{e!r}")

    async def _serve_wait_failure(self) -> None:
        """Held requests break when this process dies: the failure
        signal of the worker (reference WaitFailure.actor.cpp)."""
        from .failure import hold_wait_failure
        await hold_wait_failure(self.interface.wait_failure)

    async def _serve_ping(self) -> None:
        async for req in self.interface.ping.queue:
            req.reply.send(req.echo)

    # -- ServerDBInfo watch: re-target storage pull cursors ------------------
    async def _watch_db_info(self) -> None:
        known_epoch = -1
        while True:
            info = self.db_info.get()
            if (info.epoch != known_epoch and info.tlogs and
                    info.recovery_state in ("accepting_commits",
                                            "fully_recovered")):
                known_epoch = info.epoch
                for ss in self.storage_roles:
                    ss.set_log_system(
                        self._log_system(info.tlogs, info.log_replication),
                        info.recovery_version, info.epoch)
            await self.db_info.on_change()

    # -- registration and the ServerDBInfo subscription ----------------------
    async def _register_loop(self, leader_var) -> None:
        """Register with each new controller and long-poll its
        ServerDBInfo (reference registrationClient)."""
        from ..core.futures import wait_any
        from ..core.scheduler import delay
        from .cluster_controller import GetServerDBInfoRequest
        await self._scanned.get_future()
        known_version = -1
        cc = None
        while True:
            leader = leader_var.get()
            new_cc = leader.serialized_info if leader else None
            if new_cc is not cc:
                cc = new_cc
                self._current_cc = cc
                known_version = -1
                if cc is not None:
                    TraceEvent("WorkerRegistering").detail(
                        "Worker", self.process.name).detail(
                        "CC", getattr(cc, "id", "?")).log()
                    self._announce_roles()
            if cc is None:
                await leader_var.on_change()
                continue
            reply_f = RequestStream.at(
                cc.get_server_db_info.endpoint).get_reply(
                GetServerDBInfoRequest(known_version=known_version))
            from ..core.futures import swallow
            idx, _ = await wait_any([swallow(reply_f),
                                     leader_var.on_change()])
            if idx == 1:
                continue
            if reply_f.is_error():
                # Unreachable: wait for a new leader, unless it already
                # changed (that wakeup would be lost).
                cur = leader_var.get()
                if (cur.serialized_info if cur else None) is cc:
                    await wait_any([leader_var.on_change(), delay(1.0)])
                continue
            version, info = reply_f.get()
            known_version = version
            self.db_info.set(info)

    def run(self, leader_var) -> None:
        p = self.process
        for s in self.interface.streams():
            p.register(s)
        # Every worker's loop gets slow-task detection (core/profiler.py),
        # and FDB_PROFILE=1 starts the process's sampling profiler.
        from ..core.profiler import (install_slow_task_detection,
                                     maybe_start_profiler)
        from ..core.scheduler import get_event_loop
        install_slow_task_detection(get_event_loop())
        maybe_start_profiler(spawn=p.spawn)
        p.spawn(self._boot_scan(), f"{p.name}.bootScan")
        inits = [
            (self.interface.init_master, self._init_master, "master"),
            (self.interface.init_tlog, self._init_tlog, "tlog"),
            (self.interface.init_commit_proxy, self._init_commit_proxy,
             "commitProxy"),
            (self.interface.init_grv_proxy, self._init_grv_proxy, "grvProxy"),
            (self.interface.init_resolver, self._init_resolver, "resolver"),
            (self.interface.init_storage, self._init_storage, "storage"),
            (self.interface.init_ratekeeper, self._init_ratekeeper,
             "ratekeeper"),
            (self.interface.init_data_distributor,
             self._init_data_distributor, "dataDistributor"),
        ]
        for stream, handler, name in inits:
            p.spawn(self._serve_inits(stream.queue, handler, name),
                    f"{p.name}.init:{name}")
        p.spawn(self._serve_wait_failure(), f"{p.name}.waitFailure")
        p.spawn(self._serve_ping(), f"{p.name}.ping")
        p.spawn(self._watch_db_info(), f"{p.name}.watchDbInfo")
        p.spawn(self._update_storage_loop(), f"{p.name}.updateStorage")
        p.spawn(self._reannounce_loop(), f"{p.name}.reannounce")
        p.spawn(self._register_loop(leader_var), f"{p.name}.register")
