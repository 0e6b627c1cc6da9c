"""The resolution plane and the scheduling plane around it: N Resolver
roles behind the commit proxies, one GRV admission a proxy and the
ratekeeper's heat poll (trimmed copy of the resolver, GRV-proxy and
ratekeeper wiring of foundationdb_tpu/server/cluster.py and of the
master's resolution balancing).

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

Left out: every other role of SimCluster (master version allocation,
TLogs, storage, the client) and the RPC transport; the roles answer
within the call, so batches go in version-chain order.
"""

from __future__ import annotations

from typing import List, Optional

from ..txn.types import CommitTransactionRef, Version
from .commit_proxy import CommitProxy
from .grv_proxy import GrvProxy
from .interfaces import CommitTransactionRequest, ResolveTransactionBatchReply
from .master import (ResolutionBalancer, _key_resolver_ranges,
                     _valid_resolver_ranges)
from .ratekeeper import Ratekeeper
from .resolver import Resolver
from .shardmap import RangeMap


class ResolutionPlane:
    def __init__(self, n_resolvers: int, proxy_ids: List[str],
                 boundaries: Optional[List[bytes]] = None, device=None,
                 backend: str = "torch", **set_kwargs) -> None:
        """`boundaries`: the n-1 cut keys of the user keyspace (static
        even byte splits by default; seed_resolver_boundaries makes them
        from a shard map).  Every role's set is built by the factory with
        `backend` on `device` -- `cuda` unless the caller names another;
        with no device named and no card present this raises -- and
        `set_kwargs` (capacity, delta_capacity, ...)."""
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
        self.proxies = {pid: CommitProxy(pid, self.resolvers,
                                         self.key_resolvers)
                        for pid in proxy_ids}
        self.balancer = ResolutionBalancer(ranges,
                                           expected_proxies=proxy_ids)
        self.grv_proxies = {pid: GrvProxy(pid) for pid in proxy_ids}
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
