"""The transaction roles over the port's conflict sets (the port of the
write path of foundationdb_tpu/server/): the Resolver role (resolveBatch
with its version chain, resend cache, state-transaction broadcast and
heat tracker); the commit proxy (the resolution stage: clip over N
resolvers, min-merge; the scheduling stages; mutation-to-tag routing with
versionstamps and the push to the log system), the master's commit
versions, resolver boundaries and resolution balancing, the GRV proxies'
read versions and predictor admission, the ratekeeper's heat poll, the
TLogs over their disk queues (with spill, lock and recovery) and the MVCC
storage servers over their storage engines (kvstore.py, kvstore_btree.py);
the core state and the epoch end (master.py), the boot scan and
recruitment over a data directory (worker.py); the planes and the static
cluster that wire them and reopen it after a kill (cluster.py); the
control plane that recruits them onto workers and recovers each epoch:
the coordinators (coordination.py), the cluster controller
(cluster_controller.py), the Worker (worker.py), the master's recovery
(master.py master_server) and SimFdbCluster (cluster.py) over the
machines' simulated files (sim_fs.py); and the messages a host hands a
role."""

from .cluster import ResolutionPlane, SimFdbCluster, StaticCluster
from .commit_proxy import CommitProxy, LogSystemClient
from .disk_queue import DiskQueue
from .grv_proxy import GrvProxy
from .interfaces import (RESOLVER_ALL, TXS_TAG, CommitID,
                         CommitTransactionRequest, Reply,
                         ResolutionMetricsRequest, ResolutionSplitRequest,
                         ResolverHeatRequest, ResolveTransactionBatchReply,
                         ResolveTransactionBatchRequest, ask)
from .kvstore import IKeyValueStore, KVStoreMemory, open_kv_store
from .kvstore_btree import KVStoreBTree
from .master import (DBCoreState, EpochEnd, Master, ResolutionBalancer,
                     epoch_end, master_server, seed_resolver_boundaries)
from .notified import NotifiedVersion
from .ratekeeper import Ratekeeper
from .real_fs import RealFile, RealFileSystem
from .resolver import Resolver
from .shardmap import RangeMap
from .storage import StorageServer, VersionedMap
from .system_data import (KEY_SERVERS_PREFIX, SYSTEM_KEYS_BEGIN,
                          key_servers_key, key_servers_value)
from .tlog import TLog
from .worker import BootScan, Worker, boot_scan, init_storage, init_tlog

__all__ = ["BootScan", "CommitID", "CommitProxy",
           "CommitTransactionRequest", "DBCoreState", "DiskQueue",
           "EpochEnd", "GrvProxy", "IKeyValueStore", "KEY_SERVERS_PREFIX",
           "KVStoreBTree", "KVStoreMemory", "LogSystemClient",
           "Master", "NotifiedVersion", "RESOLVER_ALL", "RangeMap",
           "Ratekeeper", "RealFile", "RealFileSystem", "Reply",
           "ResolutionBalancer", "ResolutionMetricsRequest",
           "ResolutionPlane", "ResolutionSplitRequest", "ResolverHeatRequest",
           "Resolver", "ResolveTransactionBatchReply",
           "ResolveTransactionBatchRequest", "SYSTEM_KEYS_BEGIN",
           "SimFdbCluster", "StaticCluster", "StorageServer", "TLog",
           "TXS_TAG", "VersionedMap", "Worker", "ask", "boot_scan",
           "epoch_end", "init_storage", "init_tlog", "key_servers_key",
           "key_servers_value", "master_server", "open_kv_store",
           "seed_resolver_boundaries"]
