"""The static cluster's write path, and the resolution and scheduling
planes inside it (trimmed copy of foundationdb_tpu/server/cluster.py,
SimCluster, and of the master's resolution balancing).

StaticCluster is the port's SimCluster (:35-115), the post-recovery
steady state of static recruitment: one master, N Resolver roles on the
card behind the commit proxies, n TLogs (each over a DiskQueue in a data
directory the caller names) with a LogSystemClient of `replication`,
n storage servers with tags 0..n-1, each memory-only or over a durable
engine ("memory" or "btree") in the same directory, the shard map
SimCluster builds (teams of `replication` consecutive tags, over
boundaries the caller may pass), and one GRV proxy a commit proxy; the
generation's DBCoreState is written to the directory.  A batch committed
through it gets its version from the master, is resolved, logged durably
on every TLog and acknowledged, and is then read back from every replica
at the version its CommitID names:

  read_version()  a read version from a GRV proxy: the master's live
      committed version;
  commit(proxy_id, requests)  that proxy commits the requests, in
      batches of at most the batcher's cap (and any repair batch, each
      through the master), and answers their replies;
  pull()  every storage server pulls its tag up to the logs' version;
  get(key, version), get_range(begin, end, version, limit)  the value or
      rows at `version`, one answer a replica of the key's team;
  load(keys, values)  sorted keys and their values into each storage
      server that owns them, at the recovery version, as
      StorageServer.from_engine fills a replica from its engine, each
      engine imaged there;
  update_storage()  every engine takes its server's pulled versions and
      the logs are popped to its durable version;
  kill()  drop everything as a killed process would, nothing synced;
  StaticCluster.recover(datadir, ...)  reopen a killed cluster in a new
      epoch (the boot scan, the epoch end, a new TLog generation carrying
      the un-popped data, the storage servers re-targeted, new roles at
      the recovery version): every acknowledged commit reads back.

On the port's event loop (core/scheduler.py EventLoop), the same cluster
serves clients with every role in a simulated process of its own on the
port's SimNetwork (rpc/sim.py, rpc/network.py: the reference's
SimCluster, :100-143):

  start(loop)  install `loop` and a Simulator and start each role on a
      process of its own: the master, the TLogs, the Resolver roles,
      the storage servers, the commit proxies (their batchers send the
      master's, the resolvers' and the TLogs' requests over the
      network), the first GRV proxy (the reference's SimCluster has
      one GRV proxy) and, with `data_distribution`, the data
      distributor ("dd", server/data_distribution.py: its metadata
      transactions go through a Database over this cluster, and it
      moves, splits, merges and re-replicates shards;
      start_data_distribution() starts it later on a started cluster);
  database()  a client/database.py Database over the proxies'
      interfaces;
  run_until(future, timeout)  drive the loop until `future` resolves,
      raising at once if a role's actor fails;
  kill_process(role_id) (also stop_role)  kill one role's process: its
      actors cancelled, its endpoints dropped, every request to it and
      every reply it owed answering broken_promise (a storage server's
      reaches the data distributor through its failure monitor);
  clog_process(role_id, seconds)  hold its process's traffic.

The synchronous methods above stay as they are (every role answers
within the call; a started cluster's storage servers still pull from
the TLog roles within the call); pass `clock=loop.now` so the master's
versions follow the loop's time.

ResolutionPlane wires N port Resolver roles, each over its own conflict
set on one device, one CommitProxy a proxy id, the keyResolvers map as
the reference's SimCluster builds it (cluster.py:62-74: the user
keyspace cut at the boundaries, the \\xff system range owned by every
resolver), one ResolutionBalancer, one GrvProxy a proxy id and one
Ratekeeper.  The caller supplies the versions, as the master would:

  admit(proxy_id, requests, read_version)  one admission round of that
      proxy's GRV predictor (server/grv_proxy.py);
  commit(proxy_id, requests, prev_version, version)  the proxy commits a
      batch of CommitTransactionRequests (reorder, resolution, repair
      collection, the replies) and returns its repair requests, which the
      caller commits next on the chain, at a version below the next
      batch's;
  feed()  the ratekeeper polls every role's heat and the fold goes into
      every GRV proxy's predictor;
  resolve(proxy_id, txns, prev_version, version)  the resolution stage
      alone, the merged reply;
  balance(version)  one balancing step.

commit() and resolve() hand a proxy the boundary moves it has not been
handed with its batch.

Every storage server owns the spans of its teams in the shard map and
no other (its reads elsewhere answer wrong_shard_server), at the start
and after a recovery, whose shard map is the core state's with the
TXS_TAG deltas of the moves replayed onto it.

SimFdbCluster (below) is the reference's real topology over the same
roles: coordinators, fungible workers, an elected cluster controller and
a master that recovers each epoch (server/master.py master_server).

Left out of StaticCluster: the ratekeeper's rate budgets, the
coordinators (the core state is a file of the data directory), region
failover, backup, tenants, the database lock, configuration changes and
log routers; outside a started cluster the roles answer within the
call, so batches go in version-chain order.
"""

from __future__ import annotations

import time
from bisect import bisect_left
from typing import Any, List, Optional, Sequence, Tuple

from ..conflict.window import resolve_device
from ..core.error import err
from ..core.futures import Promise, wait_any
from ..core.scheduler import set_event_loop
from ..core.trace import TraceEvent
from ..txn.types import CommitTransactionRef, Version
from .commit_proxy import (COMMIT_TRANSACTION_BATCH_COUNT_MAX, CommitProxy,
                           LogSystemClient)
from .grv_proxy import GrvProxy
from .interfaces import (CommitTransactionRequest, GetKeyValuesRequest,
                         GetValueRequest, ResolveTransactionBatchReply, ask)
from .master import (DBCoreState, Master, ResolutionBalancer,
                     _key_resolver_ranges, _split_points,
                     _valid_resolver_ranges, epoch_end)
from .ratekeeper import Ratekeeper
from .real_fs import RealFileSystem
from .resolver import Resolver
from .shardmap import RangeMap
from .storage import StorageServer
from .worker import boot_scan, init_storage, init_tlog, tlog_file


class ResolutionPlane:
    def __init__(self, n_resolvers: int, proxy_ids: List[str],
                 boundaries: Optional[List[bytes]] = None, device=None,
                 backend: str = "torch", master: Any = None,
                 log_system: Optional[LogSystemClient] = None,
                 key_servers: Optional[RangeMap] = None,
                 tlogs: Sequence[Any] = (), recovery_version: Version = 0,
                 **set_kwargs) -> None:
        """`boundaries`: the n-1 cut keys of the user keyspace (static
        even byte splits by default; seed_resolver_boundaries makes them
        from a shard map).  Every role's set is built by the factory with `backend` on
        `device` -- `cuda` unless the caller names another; with no
        device named and no card present this raises -- and `set_kwargs`
        (capacity, delta_capacity, ...).  `master`, `log_system`,
        `key_servers` (each commit proxy gets its own copy) and `tlogs`
        wire the proxies into a write path (StaticCluster); without them
        the caller supplies the versions.  `recovery_version`: where the
        roles' chains and windows start (a read below it is too old)."""
        ranges = []
        if boundaries is None or len(boundaries) == n_resolvers - 1:
            ranges = _key_resolver_ranges(n_resolvers, boundaries=boundaries)
        if not _valid_resolver_ranges(ranges[:-1], n_resolvers):
            raise ValueError(f"{n_resolvers} resolvers cannot own the user "
                             f"keyspace cut at {boundaries!r}")
        # The user keyspace's ownership (the core state's resolver_ranges).
        self.user_ranges = ranges[:-1]
        self.resolvers = [
            Resolver(f"resolver{i}", recovery_version,
                     backend=backend, proxy_ids=list(proxy_ids),
                     device=device, **set_kwargs)
            for i in range(n_resolvers)]
        self.key_resolvers: RangeMap = RangeMap(default=0)
        for b, e, idx in ranges:
            self.key_resolvers.set_range(b, e, idx)
        self.proxies = {pid: CommitProxy(
            pid, self.resolvers, self.key_resolvers,
            recovery_version=recovery_version, master=master,
            log_system=log_system,
            key_servers=None if key_servers is None else key_servers.copy())
            for pid in proxy_ids}
        self.balancer = ResolutionBalancer(ranges,
                                           expected_proxies=proxy_ids)
        self.grv_proxies = {pid: GrvProxy(pid, master, tlogs)
                            for pid in proxy_ids}
        self.ratekeeper = Ratekeeper()

    def admit(self, proxy_id: str, requests: List[CommitTransactionRequest],
              read_version: Version) -> List[CommitTransactionRequest]:
        """One admission round at proxy `proxy_id`'s GRV predictor: the
        admitted requests (those deferred last round first); a request
        admitted after a deferral reads at `read_version`."""
        return self.grv_proxies[proxy_id].admit(requests, read_version)

    def commit(self, proxy_id: str, requests: List[CommitTransactionRequest],
               prev_version: Version, version: Version
               ) -> List[CommitTransactionRequest]:
        """Proxy `proxy_id` commits `requests` at `version` (adopting every
        boundary move it has not been handed) and answers each request's
        reply; returns the repair requests."""
        return self.proxies[proxy_id].commit(
            requests, prev_version, version,
            self.balancer.changes_for(proxy_id))

    def feed(self) -> list:
        """The ratekeeper's heat poll of every role, folded into every GRV
        proxy's predictor; the folded rows (none while
        SCHED_PREDICTOR_ENABLED is off)."""
        rows = self.ratekeeper.poll_conflict_heat(self.resolvers)
        for grv in self.grv_proxies.values():
            grv.fold_conflict_heat(rows)
        return rows

    def resolve(self, proxy_id: str, batch: List[CommitTransactionRef],
                prev_version: Version, version: Version
                ) -> ResolveTransactionBatchReply:
        """Proxy `proxy_id` resolves `batch` at `version` (its
        predecessor on the chain is `prev_version`), adopting every
        boundary move it has not been handed; the merged reply."""
        return self.proxies[proxy_id].resolve(
            batch, prev_version, version,
            self.balancer.changes_for(proxy_id))

    def balance(self, version: Version) -> Optional[tuple]:
        """One balancing step after `version`; the move made, or None."""
        return self.balancer.step(self.resolvers, version)


CORE_STATE_FILE = "coreState"


def write_core_state(fs, cs: DBCoreState) -> None:
    """Write `cs` as one packed DBCoreState blob, atomically: to a new
    file, fsynced, renamed over the old one, the directory fsynced (the
    reference's coordinators' generation register)."""
    f = fs.open(CORE_STATE_FILE + ".new")
    f.truncate(0)
    f.write(0, cs.pack())
    f.sync()
    fs.rename(CORE_STATE_FILE + ".new", CORE_STATE_FILE)
    fs.sync_dir()


def read_core_state(fs) -> DBCoreState:
    if not fs.exists(CORE_STATE_FILE):
        raise err("master_recovery_failed",
                  f"no core state in {fs.datadir}")
    f = fs.open(CORE_STATE_FILE)
    return DBCoreState.unpack(f.read(0, f.size()))


class StaticCluster:
    def __init__(self, n_resolvers: int = 1,
                 proxy_ids: Sequence[str] = ("p0",), n_storage: int = 2,
                 n_tlogs: int = 1, replication: int = 1, *,
                 datadir: str,
                 storage_boundaries: Optional[List[bytes]] = None,
                 resolver_boundaries: Optional[List[bytes]] = None,
                 storage_engine: Optional[str] = None,
                 device=None, backend: str = "torch",
                 clock=time.monotonic, data_distribution: bool = False,
                 **set_kwargs) -> None:
        """`datadir`: the data directory (made if missing): the TLogs'
        queues, tlog-log<i>.e1.wal, the storage engines' files and the
        core state.  `storage_boundaries`: the interior cut keys of the
        shard map (n_storage - 1 even byte splits by default); shard i's
        team is the `replication` tags from i on, modulo n_storage.
        `storage_engine`: None (memory-only storage servers, lost with
        the process), "memory" or "btree" (the reference's
        DatabaseConfiguration.storage_engine values).
        `resolver_boundaries`, `device`, `backend` and `set_kwargs`: the
        resolution plane's (ResolutionPlane); its roles run on `cuda`
        unless the caller names another device, and with none named and
        no card present this raises.  `clock`: the master's, in
        seconds.  `data_distribution`: start() starts a data
        distributor too."""
        if storage_engine not in (None, "memory", "btree"):
            raise ValueError(f"unknown storage engine {storage_engine!r}")
        self.fs = RealFileSystem(datadir)
        self.storage_engine = storage_engine
        tlogs = [init_tlog(self.fs, f"log{i}.e1", 0, 1)
                 for i in range(n_tlogs)]
        log_system = LogSystemClient(tlogs, replication)
        if storage_engine is None:
            storage = [StorageServer(f"ss{i}", tag=i, log_system=log_system)
                       for i in range(n_storage)]
        else:
            storage = [init_storage(self.fs, f"ss{i}", i, storage_engine,
                                    log_system) for i in range(n_storage)]
        if storage_boundaries is None:
            storage_boundaries = _split_points(n_storage)
        bounds = [b""] + list(storage_boundaries) + [b"\xff\xff"]
        ranges = [(bounds[i], bounds[i + 1],
                   [(i + j) % n_storage for j in range(replication)])
                  for i in range(len(bounds) - 1)]
        self.replication = replication
        self.data_distribution = data_distribution
        self._wire(Master(clock=clock), log_system, storage, ranges,
                   n_resolvers, proxy_ids, resolver_boundaries, 0, device,
                   backend, set_kwargs)
        self.core_state = DBCoreState(
            epoch=1, recovery_version=0,
            log_replication=log_system.replication,
            key_servers_ranges=ranges, n_resolvers=n_resolvers,
            tlog_ids=[t.id for t in tlogs],
            storage_ids={ss.tag: ss.id for ss in storage},
            resolver_ranges=self.plane.user_ranges)
        write_core_state(self.fs, self.core_state)
        self.recovery: Optional[dict] = None

    def _wire(self, master: Master, log_system: LogSystemClient,
              storage: List[StorageServer], key_servers_ranges,
              n_resolvers: int, proxy_ids, resolver_boundaries,
              recovery_version: Version, device, backend: str,
              set_kwargs: dict) -> None:
        """The roles of one generation around its log system and storage
        servers: the shard map, the resolution plane at
        `recovery_version` cut at `resolver_boundaries`, the proxies, the
        master."""
        self.master = master
        self.log_system = log_system
        self.tlogs = log_system.tlogs
        self.storage = storage
        self.key_servers: RangeMap = RangeMap(default=None)
        for b, e, team in key_servers_ranges:
            self.key_servers.set_range(b, e, list(team))
        for ss in storage:
            ss.shards = RangeMap(default=("absent", 0))
        for b, e, team in key_servers_ranges:
            for tag in team:
                storage[tag].shards.set_range(b, e, ("owned", 0))
        self.dd = None
        self.plane = ResolutionPlane(
            n_resolvers, list(proxy_ids), device=device, backend=backend,
            master=master, log_system=log_system,
            key_servers=self.key_servers, tlogs=self.tlogs,
            boundaries=resolver_boundaries,
            recovery_version=recovery_version, **set_kwargs)
        # The master hands the balancer's boundary moves out with its
        # version replies (the reference's resolver_changes).
        self.master.balancer = self.plane.balancer

    @classmethod
    def recover(cls, datadir: str, proxy_ids: Sequence[str] = ("p0",), *,
                device=None, backend: str = "torch", clock=time.monotonic,
                data_distribution: bool = False,
                **set_kwargs) -> "StaticCluster":
        """Reopen a killed cluster from `datadir` in a new epoch: the boot
        scan (TLog.from_disk of every queue, StorageServer.from_engine of
        every engine), the epoch end (master.epoch_end: lock, recovery
        version, holders, the shard map replayed), a new TLog generation
        carrying each tag's un-popped data and durable before the new
        core state is written, the old generation's files deleted after
        it, the storage servers re-targeted at the new log system
        (set_log_system rolls back a replica that ran past the recovery
        version), and new Resolver roles at the recovery version (a read
        below it is too old) with new commit and GRV proxies over the
        recovered shard map (the moves' TXS_TAG deltas replayed onto the
        core state's).  `device`, `backend`, `data_distribution` and
        `set_kwargs` as the constructor's; with no device named and no card present this
        raises before the directory is touched.  `recovery` holds the
        seconds and sizes of the parts."""
        if backend != "cpu":
            resolve_device(device)
        t0 = time.perf_counter()
        fs = RealFileSystem(datadir)
        prev = read_core_state(fs)
        scan = boot_scan(fs)
        t1 = time.perf_counter()
        end = epoch_end(prev, scan.tlogs, clock)
        t2 = time.perf_counter()
        n_tlogs = len(prev.tlog_ids)
        teams = LogSystemClient([None] * n_tlogs, prev.log_replication)
        tlogs = []
        for i in range(n_tlogs):
            mine = {tag: holder for tag, holder in end.tag_holders.items()
                    if i in teams.team_for_tag(tag)}
            tlogs.append(init_tlog(
                fs, f"log{i}.e{end.epoch}", end.recovery_version, end.epoch,
                mine, {tag: end.popped[tag] for tag in mine}))
        missing = [tag for tag in prev.storage_ids if tag not in scan.storage]
        if missing:
            raise err("master_recovery_failed",
                      f"no durable storage server for tags {missing}")
        storage = [scan.storage[tag] for tag in sorted(prev.storage_ids)]
        # The plane's cut as the core state keeps it (the static cluster
        # persists no balancing move: the ranges are in resolver order).
        cut = [e for _b, e, _i in prev.resolver_ranges[:-1]]
        cs = DBCoreState(
            epoch=end.epoch, recovery_version=end.recovery_version,
            log_replication=prev.log_replication,
            key_servers_ranges=end.key_servers_ranges,
            n_resolvers=prev.n_resolvers,
            map_version=end.recovery_version,
            tlog_ids=[t.id for t in tlogs],
            storage_ids={ss.tag: ss.id for ss in storage},
            resolver_ranges=list(prev.resolver_ranges))
        write_core_state(fs, cs)
        # The old generation: every record it still had to give is in the
        # new one's queues, and the core state names only the new one.
        for tid, old in scan.tlogs.items():
            old.disk_queue.file.close()
            if tid not in cs.tlog_ids:
                fs.delete(tlog_file(tid))
        t3 = time.perf_counter()
        log_system = LogSystemClient(tlogs, prev.log_replication)
        rolled_back = 0
        for ss in storage:
            before = ss.version
            ss.set_log_system(log_system, end.recovery_version, end.epoch)
            rolled_back += ss.version < before
        t4 = time.perf_counter()
        c = cls.__new__(cls)
        c.fs = fs
        c.storage_engine = scan.engines[storage[0].tag]
        c.replication = prev.log_replication
        c.data_distribution = data_distribution
        c._wire(end.master, log_system, storage, end.key_servers_ranges,
                prev.n_resolvers, proxy_ids, cut, end.recovery_version,
                device, backend, set_kwargs)
        c.core_state = cs
        t5 = time.perf_counter()
        c.recovery = {
            "epoch": end.epoch, "recovery_version": end.recovery_version,
            "s": t5 - t0, "scan_s": t1 - t0, "tlog_scan_s": scan.tlog_s,
            "engines_s": scan.storage_s, "epoch_end_s": t2 - t1,
            "new_tlogs_s": t3 - t2, "set_log_system_s": t4 - t3,
            "roles_s": t5 - t4, "tlog_bytes": scan.tlog_bytes,
            "engine_bytes": scan.storage_bytes,
            "carried_bytes": sum(t.bytes_in_memory for t in tlogs),
            "keys": sum(len(ss.data) for ss in storage),
            "rolled_back": rolled_back, "txs_deltas": end.txs_deltas,
            "dropped": scan.dropped}
        return c

    # -- the simulated processes (reference SimCluster :100-143) ---------------
    def start(self, loop) -> None:
        """Install `loop` and a Simulator (rpc/sim.py, whose SimNetwork
        becomes the installed network), and start every role in a
        simulated process of its own, each a kill target (the reference's
        SimCluster :100-111): the master ("master"), each TLog, Resolver
        role and storage server (by id), each commit proxy (by proxy id),
        the first GRV proxy ("grv") and, with `data_distribution`, the
        data distributor ("dd").  Each role registers its streams
        on its process and spawns its actors there; the commit proxies
        learn the storage servers' interfaces for their location
        service."""
        from ..rpc.sim import Simulator, set_simulator
        self.loop = loop
        set_event_loop(loop)
        self.sim = Simulator()
        set_simulator(self.sim)
        ssis = {ss.tag: ss.interface for ss in self.storage}
        roles = {"master": self.master}
        for t in self.tlogs:
            roles[t.id] = t
        for r in self.plane.resolvers:
            roles[r.id] = r
        for ss in self.storage:
            roles[ss.id] = ss
        for pid, proxy in self.plane.proxies.items():
            proxy.storage_interfaces = ssis
            roles[pid] = proxy
        roles["grv"] = next(iter(self.plane.grv_proxies.values()))
        self.processes = {}
        # Broken by the first role actor that ends other than by a kill's
        # cancellation.
        self._failure = Promise()
        for name, role in roles.items():
            proc = self.sim.new_process(name=name)
            self.processes[name] = proc
            if name in (ss.id for ss in self.storage):
                loc = proc.locality
                role.interface.locality = (loc.dcid, loc.zoneid,
                                           loc.machineid)
            for f in role.run(proc):
                f.on_ready(self._role_ended)
        if self.data_distribution:
            self.start_data_distribution()

    def start_data_distribution(self) -> None:
        """Start the data distributor on a started cluster, in a process
        of its own ("dd"; start() does so with `data_distribution`): a
        Database over this cluster for its metadata transactions, every
        storage server's interface, and the shard map as the first commit
        proxy holds it."""
        from .data_distribution import DataDistributor
        proxy = next(iter(self.plane.proxies.values()))
        self.dd = DataDistributor(
            "dd", self.database(), proxy.storage_interfaces,
            list(proxy.key_servers.ranges()), self.replication)
        proc = self.sim.new_process(name="dd")
        self.processes["dd"] = proc
        for f in self.dd.run(proc):
            # A failure monitor ends once it has handled its server's
            # death: only an error is the distributor's failure.
            f.on_ready(self._dd_actor_ended)

    def _role_ended(self, f) -> None:
        if f.is_error() and getattr(f.error, "name", "") == \
                "operation_cancelled":
            return
        if not self._failure.is_set():
            self._failure.send_error(
                f.error if f.is_error() else
                err("internal_error", "a role's actor ended"))

    def _dd_actor_ended(self, f) -> None:
        if f.is_error():
            self._role_ended(f)

    # The proxy lists Database reads (the reference's cluster.py:131-143);
    # a killed proxy stays in them and answers broken_promise, as a
    # killed process of the reference's static harness does.
    @property
    def grv_proxies(self):
        return [next(iter(self.plane.grv_proxies.values())).interface]

    @property
    def commit_proxies(self):
        return [p.interface for p in self.plane.proxies.values()]

    def database(self):
        """A Database over this cluster's proxies (start() first)."""
        from ..client.database import Database
        return Database(self)

    def run_until(self, future, timeout: Optional[float] = None):
        """Drive the loop until `future` resolves and return its value
        (or raise its error); a role actor that fails first raises its
        error.  timed_out past `timeout` seconds of the loop's time."""
        _idx, value = self.loop.run_until(
            wait_any([future, self._failure.get_future()]), timeout)
        return value

    def kill_process(self, role_id: str) -> None:
        """Kill the process of one role (`role_id`: "master", a TLog's,
        Resolver role's or storage server's id, a commit proxy's id, or
        "grv"; the reference's processes map): its actors are cancelled
        and its endpoints dropped, so requests to it and every reply it
        still owed answer broken_promise."""
        self.sim.kill_process(self.processes[role_id])

    stop_role = kill_process

    def clog_process(self, role_id: str, seconds: float) -> None:
        """Hold every message to and from one role's process for
        `seconds` of the loop's time (the reference's clogInterface):
        delivery resumes, in order, when the clog ends."""
        self.sim.clog_process(self.processes[role_id], seconds)

    def update_storage(self) -> int:
        """Every storage server with an engine makes its pulled versions
        durable and pops the logs there (StorageServer.update_storage);
        returns the servers whose durable version moved."""
        return sum(ss.update_storage() for ss in self.storage)

    def read_version(self, proxy_id: Optional[str] = None) -> Version:
        """A read version from a GRV proxy (the first by default)."""
        grv = self.plane.grv_proxies[
            proxy_id or next(iter(self.plane.grv_proxies))]
        return grv.get_read_version().version

    def commit(self, proxy_id: str, requests: List[CommitTransactionRequest]
               ) -> List[Tuple[Version, Version]]:
        """Proxy `proxy_id` commits `requests` in order, in batches of at
        most COMMIT_TRANSACTION_BATCH_COUNT_MAX (the reference batcher's
        cap), each batch followed by the repair batch it returns, each at
        a version of its own from the master; every request is answered
        through its reply.  Returns the (previous, commit) version of
        each batch committed, in order."""
        proxy = self.plane.proxies[proxy_id]
        cap = COMMIT_TRANSACTION_BATCH_COUNT_MAX
        out = []
        for i in range(0, max(len(requests), 1), cap):
            batch = requests[i:i + cap]
            while True:
                prev = self.master.version
                batch = proxy.commit(batch)
                out.append((prev, self.master.version))
                if not batch:
                    break
        return out

    def pull(self) -> int:
        """Every storage server pulls its tag up to the logs' version;
        returns the pull steps that moved a version."""
        return sum(ss.pull() for ss in self.storage)

    def team(self, key: bytes) -> List[StorageServer]:
        """The replicas of the shard holding `key`, in team order (the
        first commit proxy's shard map: every proxy's is the same once
        it has resolved a batch after the last move)."""
        proxy = next(iter(self.plane.proxies.values()))
        return [self.storage[t] for t in proxy.tags_for_key(key)]

    def get(self, key: bytes, version: Version) -> List[Optional[bytes]]:
        """The value of `key` at `version`, one a replica of its team;
        raises the error a replica answered with (future_version,
        transaction_too_old)."""
        return [ask(ss.get_value, GetValueRequest(key, version)).value
                for ss in self.team(key)]

    def get_range(self, begin: bytes, end: bytes, version: Version,
                  limit: int = 1 << 62) -> List[list]:
        """The live rows of [begin, end) at `version`, at most `limit`,
        one list a replica: the shards the range spans are read in turn,
        each from its team, replica j of each shard adding to list j."""
        proxy = next(iter(self.plane.proxies.values()))
        out: List[list] = []
        for b, e, tags in proxy.key_servers.intersecting(begin, end):
            for j, tag in enumerate(tags or ()):
                if j == len(out):
                    out.append([])
                rows = out[j]
                if len(rows) < limit:
                    rows += ask(self.storage[tag].get_key_values,
                                GetKeyValuesRequest(
                                    b, e, version, limit=limit - len(rows),
                                    limit_bytes=1 << 62)).data
        return out

    def load(self, keys, values) -> None:
        """Put sorted `keys` and their `values` (sequences of bytes, or
        numpy bytes arrays, which drop trailing NUL bytes as numpy does)
        into every replica of the shard each key falls in, at the
        recovery version.  Each storage server must still be empty."""
        keys = keys.tolist() if hasattr(keys, "tolist") else list(keys)
        values = (values.tolist() if hasattr(values, "tolist")
                  else list(values))
        per_ss = {ss.tag: ([], []) for ss in self.storage}
        for b, e, tags in self.key_servers.ranges():
            lo, hi = bisect_left(keys, b), bisect_left(keys, e)
            for tag in tags or ():
                per_ss[tag][0].extend(keys[lo:hi])
                per_ss[tag][1].extend(values[lo:hi])
        for ss in self.storage:
            ks, vs = per_ss[ss.tag]
            ss.load(ks, vs)

    def close(self) -> None:
        """Close every file of the data directory (all acknowledged state
        is already durable)."""
        self.fs.close()

    def kill(self) -> None:
        """What a killed process leaves: its file descriptors released as
        the kernel releases them, with nothing flushed, written or synced
        (records pushed but not committed, engine mutations not
        committed and the roles' memory are lost), and every role
        dropped, the Resolver roles' device state with them."""
        self.fs.close()
        self.plane = self.master = self.log_system = None
        self.tlogs = self.storage = []



class SimFdbCluster:
    """The real topology (a trimmed copy of the JAX package's cluster.py
    SimFdbCluster, :146-455): coordinators and fungible worker processes
    on the port's Simulator.  The stateless workers campaign for cluster
    controller through the coordinators; the winner recruits a master,
    which recovers (server/master.py master_server) and recruits every
    role of the transaction system onto workers.  Kill a process of the
    transaction system (or the controller's) and the cluster recovers
    into a new epoch.

    The Resolver roles' conflict sets are built with the configuration's
    backend ("torch" when it names none) on `device`: the card unless the
    caller passes device="cpu"; with none named, a device backend and no
    card present, this raises.  `set_kwargs` go to every set (capacity,
    delta_capacity, ...).  Every durable file lives in its machine's
    simulated file system (server/sim_fs.py), so a restarted worker finds
    its TLogs and storage engines and power_fail_reboot() boots the
    cluster again from what was synced.

    add_coordinator and spec_of (:363-378) start the coordinators a
    quorum change moves to and name them.

    Left out: a second cluster in the same simulation (the reference's
    `sim` and `name_prefix`)."""

    def __init__(self, config=None, n_workers: int = 4,
                 n_storage_workers: int = 2, n_coordinators: int = 3,
                 loop=None, n_zones: int = 0, device=None,
                 **set_kwargs) -> None:
        """n_zones > 0 places the storage workers round-robin into that
        many failure zones; 0 makes every machine its own zone."""
        from ..core.scheduler import EventLoop
        from ..rpc.sim import Simulator, set_simulator
        from .interfaces import DatabaseConfiguration
        self.config = config or DatabaseConfiguration()
        if (self.config.conflict_backend or "torch") in (
                "torch", "torch-raw", "sharded"):
            resolve_device(device)
        self.device = device
        self.set_kwargs = set_kwargs
        # Cold-boot recruitment waits for the whole initial pool: the
        # storage workers and at least one stateless one.
        self.config.min_workers = max(self.config.min_workers,
                                      min(n_storage_workers + 1, n_workers))
        self.n_workers = n_workers
        self.n_storage_workers = n_storage_workers
        self.n_coordinators = n_coordinators
        self.n_zones = n_zones
        self.loop = loop or EventLoop(sim=True)
        set_event_loop(self.loop)
        self.sim = Simulator()
        set_simulator(self.sim)
        # Leadership change ids of restarted workers: never reused, and
        # higher than the originals' (a rebooted worker does not take the
        # leadership back on a tie).
        self._next_change_id = 10000
        self._boot()

    def _boot(self) -> None:
        """(Re)create the coordinator and worker processes.  Machine ids
        are stable, so a second _boot after power_fail_all() finds each
        machine's files (registers, TLog queues, engines)."""
        from .coordination import (CoordinationClientInterface,
                                   CoordinationServer)
        self.coordinators = []
        self.coordinator_clients = []
        for i in range(self.n_coordinators):
            p = self.sim.new_process(name=f"coord{i}",
                                     machineid=f"mach.coord{i}",
                                     process_class="coordinator")
            server = CoordinationServer(f"coord{i}", fs=self.sim.fs_for(p))
            server.run(p)
            self.coordinators.append((p, server))
            self.coordinator_clients.append(
                CoordinationClientInterface(server))
        self.workers = []
        for i in range(self.n_workers):
            pclass = "storage" if i < self.n_storage_workers else "stateless"
            zone = (f"z{i % self.n_zones}"
                    if self.n_zones and pclass == "storage" else "")
            p = self.sim.new_process(name=f"worker{i}",
                                     machineid=f"mach.worker{i}",
                                     process_class=pclass, zoneid=zone)
            # Only stateless workers campaign (a storage worker leading
            # would put the control plane on a data node).
            self.workers.append((p,) + self._spawn_worker_roles(
                p, campaign=(pclass == "stateless"), change_id=i))
        self.sim.on_reboot = self._handle_reboot

    def _spawn_worker_roles(self, p, campaign: bool, change_id: int):
        """(Re)start a worker's stack on process `p`: its candidacy (a
        campaigner) or its leader monitor, and its Worker (whose boot scan
        recovers the machine's TLogs and engines).  Returns (worker, cc,
        leader_var), a self.workers entry without the process."""
        from ..core.futures import AsyncVar
        from .cluster_controller import ClusterController
        from .coordination import monitor_leader, try_become_leader
        from .worker import Worker
        p.cc_campaign = campaign
        leader_var = AsyncVar(None)
        cc = None
        if campaign and p.process_class == "stateless":
            cc = ClusterController(f"cc.{p.name}.c{change_id}",
                                   self.coordinator_clients, self.config)
            cc.register_streams(p)   # endpoints exist before any win
            p.spawn(try_become_leader(self.coordinator_clients,
                                      cc.interface, leader_var,
                                      change_id=change_id),
                    f"{p.name}.campaign")
            p.spawn(self._cc_runner(p, cc, leader_var, change_id),
                    f"{p.name}.ccRunner")
        else:
            p.spawn(monitor_leader(self.coordinator_clients, leader_var),
                    f"{p.name}.monitorLeader")
        worker = Worker(p, self.coordinator_clients,
                        process_class=p.process_class, config=self.config,
                        device=self.device, set_kwargs=self.set_kwargs)
        worker.run(leader_var)
        return worker, cc, leader_var

    def _bump_change_id(self) -> int:
        cid = self._next_change_id
        self._next_change_id += 1
        return cid

    def _handle_reboot(self, p) -> None:
        """sim.on_reboot: a rebooted worker re-runs its stack on the same
        process; a rebooted coordinator its server, at the same address
        (the well-known tokens every client holds keep reaching it)."""
        for idx, entry in enumerate(self.workers):
            if entry[0] is p:
                self.workers[idx] = (p,) + self._spawn_worker_roles(
                    p, campaign=getattr(p, "cc_campaign",
                                        p.process_class == "stateless"),
                    change_id=self._bump_change_id())
                TraceEvent("SimWorkerRebooted").detail(
                    "Worker", p.name).detail("Epoch", p.epoch).log()
                return
        for idx, (cp, _server) in enumerate(self.coordinators):
            if cp is p:
                self._respawn_coordinator(idx, p)
                return

    def _respawn_coordinator(self, idx: int, p) -> None:
        """A fresh CoordinationServer on `p`, its registers recovered from
        the machine's files; the shared client list is updated in place
        (its endpoints equal the old ones)."""
        from .coordination import (CoordinationClientInterface,
                                   CoordinationServer)
        server = CoordinationServer(p.name, fs=self.sim.fs_for(p))
        server.run(p)
        self.coordinators[idx] = (p, server)
        self.coordinator_clients[idx] = CoordinationClientInterface(server)
        TraceEvent("SimCoordinatorRestarted").detail(
            "Coordinator", p.name).detail("Epoch", p.epoch).log()

    def restart_coordinator(self, i: int, hard: bool = False):
        """Restart coordinator `i`: a rolling reboot of a live one, or
        (hard, or dead) a new process on the same machine and address.
        Its registers come back from its files either way."""
        p_old, _server = self.coordinators[i]
        if p_old.alive and not hard:
            self.sim.reboot_process(p_old)   # respawned by the hook
            return p_old
        if p_old.alive:
            self.sim.kill_process(p_old)
        p = self.sim.new_process(name=p_old.name,
                                 machineid=p_old.locality.machineid,
                                 process_class="coordinator",
                                 dcid=p_old.locality.dcid,
                                 address=p_old.address)
        self._respawn_coordinator(i, p)
        return p

    def restart_worker(self, i: int):
        """Bring worker `i` back after a kill: a new process on the same
        machine (its files are found and recovered); a live one gets a
        rolling reboot instead."""
        p_old = self.workers[i][0]
        if p_old.alive:
            self.sim.reboot_process(p_old)   # respawned by the hook
            return p_old
        p = self.sim.new_process(name=p_old.name,
                                 machineid=p_old.locality.machineid,
                                 process_class=p_old.process_class,
                                 dcid=p_old.locality.dcid,
                                 zoneid=p_old.locality.zoneid)
        self.workers[i] = (p,) + self._spawn_worker_roles(
            p, campaign=getattr(p_old, "cc_campaign",
                                p_old.process_class == "stateless"),
            change_id=self._bump_change_id())
        return p

    def add_coordinator(self, name: Optional[str] = None):
        """Start one more coordination server mid-run (a quorum change's
        target must serve its registers before the management probe
        reaches it); returns (process, server)."""
        from .coordination import CoordinationServer
        i = len(self.coordinators)
        name = name or f"coord{i}"
        p = self.sim.new_process(name=name, machineid=f"mach.{name}",
                                 process_class="coordinator")
        server = CoordinationServer(name, fs=self.sim.fs_for(p))
        server.run(p)
        self.coordinators.append((p, server))
        return p, server

    @staticmethod
    def spec_of(pairs) -> str:
        """The connection spec "ip:port,..." of (process, server) pairs."""
        return ",".join(f"{p.address.ip}:{p.address.port}"
                        for p, _ in pairs)

    def add_worker(self, pclass: str = "stateless",
                   name: Optional[str] = None, campaign: bool = False,
                   zoneid: str = ""):
        """One more worker mid-run (a better-class worker joining makes
        the controller recruit a better master)."""
        i = len(self.workers)
        name = name or f"worker{i}"
        p = self.sim.new_process(name=name, machineid=f"mach.{name}",
                                 process_class=pclass, zoneid=zoneid)
        roles = self._spawn_worker_roles(p, campaign=campaign,
                                         change_id=100 + i)
        self.workers.append((p,) + roles)
        return p, roles[0]

    def power_fail_reboot(self) -> None:
        """Whole-cluster power loss and restart: every un-synced write is
        dropped, every process dies, and a fresh boot recovers from the
        durable files alone."""
        self.sim.power_fail_all()
        self._boot()

    @staticmethod
    async def _cc_runner(process, cc, leader_var, my_change_id) -> None:
        """Run the controller while this worker leads; halt it when
        deposed (a deposed controller would recruit a rival system)."""
        started = False
        while True:
            leader = leader_var.get()
            is_me = leader is not None and leader.change_id == my_change_id
            if is_me and not started:
                cc.run(process)
                started = True
            elif not is_me and started:
                cc.halt()
                started = False
            await leader_var.on_change()

    def database(self):
        """A Database that follows the leader to each epoch's proxies."""
        from ..client.database import ClusterConnection, Database
        return Database(ClusterConnection(self.coordinator_clients))

    def run_until(self, future, timeout: Optional[float] = None):
        return self.loop.run_until(future, timeout)

    # -- fault helpers --------------------------------------------------------
    def process_of(self, interface):
        """The simulated process hosting a role, by any of its endpoints'
        address."""
        for attr in vars(interface).values():
            ep = getattr(attr, "_endpoint", None)
            if ep is not None:
                return self.sim.processes.get(ep.address)
        return None

    def current_cc(self):
        """The cluster controller running as the live leader."""
        for p, _w, cc, leader_var in self.workers:
            if cc is None or not p.alive:
                continue
            leader = leader_var.get()
            if leader is not None and leader.serialized_info is cc.interface:
                return cc
        return None

    def worker_process(self, i: int):
        return self.workers[i][0]
