"""The Resolver role and the resolution plane over the port's conflict
sets (the port of the resolver part of foundationdb_tpu/server/):
resolveBatch with its version chain, resend cache, state-transaction
broadcast and heat tracker; the commit proxy's resolution stage (clip
over N resolvers, min-merge), the resolver boundaries and resolution
balancing, the plane that wires them, and the messages a host hands a
role."""

from .cluster import ResolutionPlane
from .commit_proxy import CommitProxy
from .interfaces import (RESOLVER_ALL, Reply, ResolutionMetricsRequest,
                         ResolutionSplitRequest, ResolverHeatRequest,
                         ResolveTransactionBatchReply,
                         ResolveTransactionBatchRequest)
from .master import ResolutionBalancer, seed_resolver_boundaries
from .notified import NotifiedVersion
from .resolver import Resolver
from .shardmap import RangeMap
from .system_data import SYSTEM_KEYS_BEGIN

__all__ = ["CommitProxy", "NotifiedVersion", "RESOLVER_ALL", "RangeMap",
           "Reply", "ResolutionBalancer", "ResolutionMetricsRequest",
           "ResolutionPlane", "ResolutionSplitRequest", "ResolverHeatRequest",
           "Resolver", "ResolveTransactionBatchReply",
           "ResolveTransactionBatchRequest", "SYSTEM_KEYS_BEGIN",
           "seed_resolver_boundaries"]
