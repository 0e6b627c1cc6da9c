"""The transaction roles over the port's conflict sets (the port of the
write path of foundationdb_tpu/server/): the Resolver role (resolveBatch
with its version chain, resend cache, state-transaction broadcast and
heat tracker); the commit proxy (the resolution stage: clip over N
resolvers, min-merge; the scheduling stages; mutation-to-tag routing with
versionstamps and the push to the log system), the master's commit
versions, resolver boundaries and resolution balancing, the GRV proxies'
read versions and predictor admission, the ratekeeper's heat poll, the
TLogs over their disk queues and the MVCC storage servers; the planes
and the static cluster that wire them (cluster.py), and the messages a
host hands a role."""

from .cluster import ResolutionPlane, StaticCluster
from .commit_proxy import CommitProxy, LogSystemClient
from .disk_queue import DiskQueue
from .grv_proxy import GrvProxy
from .interfaces import (RESOLVER_ALL, TXS_TAG, CommitID,
                         CommitTransactionRequest, Reply,
                         ResolutionMetricsRequest, ResolutionSplitRequest,
                         ResolverHeatRequest, ResolveTransactionBatchReply,
                         ResolveTransactionBatchRequest, ask)
from .master import Master, ResolutionBalancer, seed_resolver_boundaries
from .notified import NotifiedVersion
from .ratekeeper import Ratekeeper
from .real_fs import RealFile
from .resolver import Resolver
from .shardmap import RangeMap
from .storage import StorageServer, VersionedMap
from .system_data import (KEY_SERVERS_PREFIX, SYSTEM_KEYS_BEGIN,
                          key_servers_key, key_servers_value)
from .tlog import TLog

__all__ = ["CommitID", "CommitProxy", "CommitTransactionRequest",
           "DiskQueue", "GrvProxy", "KEY_SERVERS_PREFIX", "LogSystemClient",
           "Master", "NotifiedVersion", "RESOLVER_ALL", "RangeMap",
           "Ratekeeper", "RealFile", "Reply",
           "ResolutionBalancer", "ResolutionMetricsRequest",
           "ResolutionPlane", "ResolutionSplitRequest", "ResolverHeatRequest",
           "Resolver", "ResolveTransactionBatchReply",
           "ResolveTransactionBatchRequest", "SYSTEM_KEYS_BEGIN",
           "StaticCluster", "StorageServer", "TLog", "TXS_TAG",
           "VersionedMap", "ask", "key_servers_key", "key_servers_value",
           "seed_resolver_boundaries"]
