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

Left out: the client (Database and its transactions), the location
service, the ratekeeper's rate budgets, the coordinators (the core state
is a file of the data directory), region failover, backup, tenants, the
database lock, configuration changes, log routers and the RPC transport;
the roles answer within the call, so batches go in version-chain order.
"""

from __future__ import annotations

import time
from bisect import bisect_left
from typing import Any, List, Optional, Sequence, Tuple

from ..conflict.window import resolve_device
from ..core.error import err
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
                 clock=time.monotonic, **set_kwargs) -> None:
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
        seconds."""
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
        recovered shard map.  `device`, `backend` and `set_kwargs` as
        the constructor's; with no device named and no card present this
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
