"""The static cluster's write path, and the resolution and scheduling
planes inside it (trimmed copy of foundationdb_tpu/server/cluster.py,
SimCluster, and of the master's resolution balancing).

StaticCluster is the port's SimCluster (:35-115), the post-recovery
steady state of static recruitment: one master, N Resolver roles on the
card behind the commit proxies, n TLogs (each over a DiskQueue in a
directory the caller names) with a LogSystemClient of `replication`,
n storage servers with tags 0..n-1 and the shard map SimCluster builds
(teams of `replication` consecutive tags, over boundaries the caller may
pass), and one GRV proxy a commit proxy.  A batch committed through it
gets its version from the master, is resolved, logged durably on every
TLog and acknowledged, and is then read back from every replica at the
version its CommitID names:

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
      StorageServer.from_engine fills a replica from its engine.

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
service, the ratekeeper's rate budgets, recovery and the RPC transport;
the roles answer within the call, so batches go in version-chain order.
"""

from __future__ import annotations

import os
import time
from bisect import bisect_left
from typing import Any, List, Optional, Sequence, Tuple

from ..txn.types import CommitTransactionRef, Version
from .commit_proxy import (COMMIT_TRANSACTION_BATCH_COUNT_MAX, CommitProxy,
                           LogSystemClient)
from .disk_queue import DiskQueue
from .grv_proxy import GrvProxy
from .interfaces import (CommitTransactionRequest, GetKeyValuesRequest,
                         GetValueRequest, ResolveTransactionBatchReply, ask)
from .master import (Master, ResolutionBalancer, _key_resolver_ranges,
                     _split_points, _valid_resolver_ranges)
from .ratekeeper import Ratekeeper
from .real_fs import RealFile
from .resolver import Resolver
from .shardmap import RangeMap
from .storage import StorageServer
from .tlog import TLog


class ResolutionPlane:
    def __init__(self, n_resolvers: int, proxy_ids: List[str],
                 boundaries: Optional[List[bytes]] = None, device=None,
                 backend: str = "torch", master: Any = None,
                 log_system: Optional[LogSystemClient] = None,
                 key_servers: Optional[RangeMap] = None,
                 tlogs: Sequence[Any] = (), **set_kwargs) -> None:
        """`boundaries`: the n-1 cut keys of the user keyspace (static
        even byte splits by default; seed_resolver_boundaries makes them
        from a shard map).  Every role's set is built by the factory with
        `backend` on `device` -- `cuda` unless the caller names another;
        with no device named and no card present this raises -- and
        `set_kwargs` (capacity, delta_capacity, ...).  `master`,
        `log_system`, `key_servers` (each commit proxy gets its own copy)
        and `tlogs` wire the proxies into a write path (StaticCluster);
        without them the caller supplies the versions."""
        ranges = []
        if boundaries is None or len(boundaries) == n_resolvers - 1:
            ranges = _key_resolver_ranges(n_resolvers, boundaries=boundaries)
        if not _valid_resolver_ranges(ranges[:-1], n_resolvers):
            raise ValueError(f"{n_resolvers} resolvers cannot own the user "
                             f"keyspace cut at {boundaries!r}")
        self.resolvers = [
            Resolver(f"resolver{i}", 0, backend=backend,
                     proxy_ids=list(proxy_ids), device=device, **set_kwargs)
            for i in range(n_resolvers)]
        self.key_resolvers: RangeMap = RangeMap(default=0)
        for b, e, idx in ranges:
            self.key_resolvers.set_range(b, e, idx)
        self.proxies = {pid: CommitProxy(
            pid, self.resolvers, self.key_resolvers, master=master,
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


class StaticCluster:
    def __init__(self, n_resolvers: int = 1,
                 proxy_ids: Sequence[str] = ("p0",), n_storage: int = 2,
                 n_tlogs: int = 1, replication: int = 1, *,
                 datadir: str,
                 storage_boundaries: Optional[List[bytes]] = None,
                 resolver_boundaries: Optional[List[bytes]] = None,
                 device=None, backend: str = "torch",
                 clock=time.monotonic, **set_kwargs) -> None:
        """`datadir`: the directory of the TLogs' queue files (one file
        a TLog, log<i>.dq), made if missing.  `storage_boundaries`: the interior cut keys of the shard
        map (n_storage - 1 even byte splits by default); shard i's team
        is the `replication` tags from i on, modulo n_storage.
        `resolver_boundaries`, `device`, `backend` and `set_kwargs`: the
        resolution plane's (ResolutionPlane); its roles run on `cuda`
        unless the caller names another device, and with none named and
        no card present this raises.  `clock`: the master's, in
        seconds."""
        proxy_ids = list(proxy_ids)
        self.master = Master(clock=clock)
        os.makedirs(datadir, exist_ok=True)
        self.tlogs = [TLog(f"log{i}", disk_queue=DiskQueue(RealFile(
                          os.path.join(datadir, f"log{i}.dq"), f"log{i}.dq")))
                      for i in range(n_tlogs)]
        self.log_system = LogSystemClient(self.tlogs, replication)
        self.storage = [StorageServer(f"ss{i}", tag=i,
                                      log_system=self.log_system)
                        for i in range(n_storage)]
        self.key_servers: RangeMap = RangeMap(default=None)
        if storage_boundaries is None:
            storage_boundaries = _split_points(n_storage)
        bounds = [b""] + list(storage_boundaries) + [b"\xff\xff"]
        for i in range(len(bounds) - 1):
            team = [(i + j) % n_storage for j in range(replication)]
            self.key_servers.set_range(bounds[i], bounds[i + 1], team)
        self.plane = ResolutionPlane(
            n_resolvers, proxy_ids, boundaries=resolver_boundaries,
            device=device, backend=backend, master=self.master,
            log_system=self.log_system, key_servers=self.key_servers,
            tlogs=self.tlogs, **set_kwargs)
        # The master hands the balancer's boundary moves out with its
        # version replies (the reference's resolver_changes).
        self.master.balancer = self.plane.balancer

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
        """Close the TLogs' queue files."""
        for t in self.tlogs:
            t.disk_queue.file.close()
