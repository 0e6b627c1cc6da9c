"""The Resolver role and the resolution plane over the port's conflict
sets (the port of the resolver part of foundationdb_tpu/server/):
resolveBatch with its version chain, resend cache, state-transaction
broadcast and heat tracker; the commit proxy's resolution stage (clip
over N resolvers, min-merge), the resolver boundaries and resolution
balancing, the plane that wires them, the scheduling plane around it
(the GRV proxies' predictor admission, the ratekeeper's heat poll, the
commit proxy's reorder and repair in commit()), and the messages a host
hands a role."""

from .cluster import ResolutionPlane
from .commit_proxy import CommitProxy
from .grv_proxy import GrvProxy
from .interfaces import (RESOLVER_ALL, CommitID, CommitTransactionRequest,
                         Reply, ResolutionMetricsRequest,
                         ResolutionSplitRequest, ResolverHeatRequest,
                         ResolveTransactionBatchReply,
                         ResolveTransactionBatchRequest)
from .master import ResolutionBalancer, seed_resolver_boundaries
from .notified import NotifiedVersion
from .ratekeeper import Ratekeeper
from .resolver import Resolver
from .shardmap import RangeMap
from .system_data import SYSTEM_KEYS_BEGIN

__all__ = ["CommitID", "CommitProxy", "CommitTransactionRequest",
           "GrvProxy", "NotifiedVersion", "RESOLVER_ALL", "RangeMap",
           "Ratekeeper", "Reply", "ResolutionBalancer",
           "ResolutionMetricsRequest",
           "ResolutionPlane", "ResolutionSplitRequest", "ResolverHeatRequest",
           "Resolver", "ResolveTransactionBatchReply",
           "ResolveTransactionBatchRequest", "SYSTEM_KEYS_BEGIN",
           "seed_resolver_boundaries"]
