"""The resolution plane: N Resolver roles behind the commit proxies
(trimmed copy of the resolver wiring of foundationdb_tpu/server/cluster.py
and of the master's resolution balancing).

ResolutionPlane wires N port Resolver roles, each over its own conflict
set on one device, one CommitProxy resolution stage a proxy id, the
keyResolvers map as the reference's SimCluster builds it
(cluster.py:62-74: the user keyspace cut at the boundaries, the \\xff
system range owned by every resolver) and one ResolutionBalancer.  The
caller supplies the versions, as the master would: resolve() hands a
proxy the boundary moves it has not been handed with its batch, and
balance() runs one balancing step.

Left out: every other role of SimCluster (master version allocation,
TLogs, storage, GRV proxies, the client) and the RPC transport; the
roles answer within the call, so batches go in version-chain order.
"""

from __future__ import annotations

from typing import List, Optional

from ..txn.types import CommitTransactionRef, Version
from .commit_proxy import CommitProxy
from .interfaces import ResolveTransactionBatchReply
from .master import (ResolutionBalancer, _key_resolver_ranges,
                     _valid_resolver_ranges)
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
