"""The Resolver role over the port's conflict sets (the port of the
resolver part of foundationdb_tpu/server/): resolveBatch with its version
chain, resend cache, state-transaction broadcast and heat tracker, and
the messages a host hands it."""

from .interfaces import (ResolutionMetricsRequest, ResolutionSplitRequest,
                         ResolverHeatRequest, ResolveTransactionBatchReply,
                         ResolveTransactionBatchRequest)
from .notified import NotifiedVersion
from .resolver import Resolver

__all__ = ["NotifiedVersion", "ResolutionMetricsRequest",
           "ResolutionSplitRequest", "ResolverHeatRequest", "Resolver",
           "ResolveTransactionBatchReply", "ResolveTransactionBatchRequest"]
