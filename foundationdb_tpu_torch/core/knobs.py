"""Server and client knobs the port reads (trimmed copy of
foundationdb_tpu/core/knobs.py).

What the port's conflict path, its supervision layer, the Resolver
role and the write path consult, with the reference's defaults: the
master's version knobs VERSIONS_PER_SECOND and MAX_VERSIONS_IN_FLIGHT
(server/master.py) and MAX_READ_TRANSACTION_LIFE_VERSIONS, which is also
the storage servers' MVCC window (server/storage.py); the TLog's peek
budget TLOG_PEEK_DESIRED_BYTES and its spill threshold
TLOG_SPILL_THRESHOLD (server/tlog.py); the B-tree engine's
BTREE_PREFIX_COMPRESSION (server/kvstore_btree.py); HEAT_TELEMETRY_ENABLED, the
master switch of the heat-telemetry attribution that
ConflictSet.resolve_with_conflicts fills (conflict/api.py) and of the
role's conflict heat; the CONFLICT_* knobs of the backend factory, of
conflict/supervisor.py and of the heat table (conflict/heat.py);
MAX_WRITE_TRANSACTION_LIFE_VERSIONS, the span of the role's window floor
(server/resolver.py) and of the proxy's ownership history
(server/commit_proxy.py); METRICS_EMIT_INTERVAL, the cadence of
CounterCollection.emit_loop; and the scheduling plane's three stage
switches and TXN_REPAIR_MAX_ATTEMPTS (server/grv_proxy.py,
server/ratekeeper.py, the commit proxy's commit()).  The reference's
other SCHED_* and TXN_REPAIR_* knobs are module constants at their
defaults (sched/predictor.py, sched/repair.py, server/grv_proxy.py,
server/commit_proxy.py), and SCHED_ADMISSION_DELAY_S has no counterpart:
the port's GRV admission has no clock, and a deferred request waits one
admission round instead.  Set them the way the reference's tests do:
mutate the process-wide registry,
`server_knobs().CONFLICT_PIPELINE_DEPTH = 2`, and restore it after.

The event-loop roles read the commit batcher's window and byte cap
(COMMIT_TRANSACTION_BATCH_*, server/commit_proxy.py), the GRV starter's
interval (START_TRANSACTION_BATCH_INTERVAL_MIN, server/grv_proxy.py) and
how long a storage server holds a read at a version its logs do not yet
have (STORAGE_FUTURE_VERSION_TIMEOUT, server/storage.py).  The transport
reads PEER_HEALTH_ENABLED, the switch of its per-peer samples
(rpc/network.py, rpc/real_network.py, rpc/transport.py), and
RPC_COLUMNAR_ENABLED, whether the hot messages are encoded as columnar
frames (rpc/serde.py).  ClientKnobs
is the reference's (:448-522), for client/database.py, but for
MAX_BATCH_SIZE and TSS_SAMPLE_RATE, which come with the code that reads
them.
"""

from __future__ import annotations


class ServerKnobs:
    """Server-side knobs, with the reference's defaults (but see
    CONFLICT_SET_BACKEND)."""

    def __init__(self) -> None:
        # Cadence of the periodic {group}Metrics / LatencyBand emission
        # (core/histogram.CounterCollection.emit_loop).
        self.METRICS_EMIT_INTERVAL = 5.0

        # Versions (the reference's foundationdb_tpu/core/knobs.py:96-99):
        # the master hands out VERSIONS_PER_SECOND versions a second of
        # wall time, at most MAX_READ_TRANSACTION_LIFE_VERSIONS / 2 a
        # request and at most MAX_VERSIONS_IN_FLIGHT past the live
        # committed version; storage servers keep the last
        # MAX_READ_TRANSACTION_LIFE_VERSIONS versions readable.
        self.VERSIONS_PER_SECOND = 1_000_000
        self.MAX_READ_TRANSACTION_LIFE_VERSIONS = 5 * self.VERSIONS_PER_SECOND
        # The resolver keeps the write history of the last
        # MAX_WRITE_TRANSACTION_LIFE_VERSIONS versions; its window floor
        # trails each batch's version by that.
        self.MAX_WRITE_TRANSACTION_LIFE_VERSIONS = 5 * self.VERSIONS_PER_SECOND
        self.MAX_VERSIONS_IN_FLIGHT = 100 * self.VERSIONS_PER_SECOND

        # Byte budget of one TLog peek reply (the reference's :410): at
        # least one entry is always sent.
        self.TLOG_PEEK_DESIRED_BYTES = 1e6
        # Resident payload bytes above which a TLog moves its oldest
        # durable entries to references into its queue file, served back
        # by peek (the reference's :399).
        self.TLOG_SPILL_THRESHOLD = 1500e6

        # The B-tree engine writes prefix-compressed leaves (one shared
        # prefix a page); both leaf forms always decode (the reference's
        # :302).
        self.BTREE_PREFIX_COMPRESSION = False

        # Conflict-set backend selector of conflict/api.new_conflict_set:
        # "torch" (supervised, on `cuda`), "torch-raw" (bare), "sharded",
        # "cpu" (the oracle) or "auto".  The reference defaults to its
        # oracle; the port's entry points run on the card unless asked
        # otherwise, so the port defaults to "torch".
        self.CONFLICT_SET_BACKEND = "torch"

        # Device-backend supervision (conflict/supervisor.py): deadline
        # budget per device call, transient-retry policy, health-trip
        # thresholds and the degraded-mode re-probe cadence.
        self.CONFLICT_BACKEND_SUPERVISED = True
        # Per-call deadline; 0 runs device calls inline, unguarded.
        self.CONFLICT_DEVICE_TIMEOUT_S = 600.0
        self.CONFLICT_DEVICE_MAX_RETRIES = 2      # transient-error retries
        self.CONFLICT_DEVICE_RETRY_BACKOFF_S = 0.05   # doubles per retry
        # Health-monitor failure-streak length (an unrecovered hard
        # failure degrades at once whatever this is).
        self.CONFLICT_BACKEND_FAILURE_THRESHOLD = 3
        self.CONFLICT_DEVICE_LATENCY_SLO_S = 0.0  # 0 disables the SLO trip
        self.CONFLICT_DEVICE_SLO_STRIKES = 8      # consecutive slow batches
        self.CONFLICT_BACKEND_REPROBE_S = 5.0     # doubles per failed probe
        # Depth-N dispatch pipeline: most batches in flight (dispatched,
        # verdicts not yet folded) before a dispatch folds the oldest.
        self.CONFLICT_PIPELINE_DEPTH = 8

        # Cluster heat telemetry (the reference's conflict/heat.py): gates
        # the per-batch conflict attribution of resolve_with_conflicts and
        # the supervised device path's mirror attribution.
        self.HEAT_TELEMETRY_ENABLED = True
        # Most aborted txns of a device-path batch attributed exactly
        # through the supervisor's mirror; the rest keep conservative
        # whole-read-set blame (the ConservativeAttribution counter).
        self.CONFLICT_ATTRIBUTION_SAMPLE = 32
        # Rows per table in HotConflictRange emission and the resolver's
        # heat status.
        self.CONFLICT_HEAT_TOP_K = 8
        # The resolver's heat table bound (load + conflict columns,
        # halved when full).
        self.CONFLICT_HEAT_TABLE_MAX = 4096

        # Conflict-aware transaction scheduling (sched/), three stages,
        # all off by default: every stage is bit-invisible when its knob
        # is off.  (a) The GRV proxies' predictor admission (a request
        # whose declared tag or tenant maps to a predicted-doomed range
        # waits one admission round, at most server/grv_proxy.py
        # SCHED_MAX_DEFERRALS times) and the ratekeeper's heat poll.
        self.SCHED_PREDICTOR_ENABLED = False
        # (b) The commit proxy's intra-batch reorder.
        self.SCHED_REORDER_ENABLED = False
        # (c) The commit proxy's repair of opted-in staleness-only aborts:
        # at most MAX_ATTEMPTS re-resolutions a txn; past one, the ladder
        # backs a culprit range off (sched/repair.py RepairLadder).
        self.SCHED_REPAIR_ENABLED = False
        self.TXN_REPAIR_MAX_ATTEMPTS = 1

        # The commit proxy's batcher (the reference's :103, :106): a batch
        # closes COMMIT_TRANSACTION_BATCH_INTERVAL_MIN after its first
        # request, or at the byte cap or server/commit_proxy.py's
        # COMMIT_TRANSACTION_BATCH_COUNT_MAX (the reference's knob
        # default, a constant here: a versionstamp numbers a batch's
        # transactions in 2 bytes).
        self.COMMIT_TRANSACTION_BATCH_INTERVAL_MIN = 0.001
        self.COMMIT_TRANSACTION_BATCH_BYTES_MAX = 8 << 20
        # The GRV proxy's transaction starter (the reference's :355).
        self.START_TRANSACTION_BATCH_INTERVAL_MIN = 1e-6
        # How long a read at a version past the logs waits before
        # future_version (the reference's :379).
        self.STORAGE_FUTURE_VERSION_TIMEOUT = 1.0

        # The transport (the reference's :127 and :283): per-peer health
        # samples on every send, and the columnar frames of the hot
        # messages (decoding reads either format whatever this says).
        self.PEER_HEALTH_ENABLED = True
        self.RPC_COLUMNAR_ENABLED = False


class ClientKnobs:
    """Client-side knobs, with the reference's defaults."""

    def __init__(self) -> None:
        # Client-side GRV batching window (GRV_BATCH_ENABLED): must stay
        # below the GRV round trip it amortizes.
        self.GRV_BATCH_TIMEOUT = 0.001
        self.DEFAULT_BACKOFF = 0.01
        self.DEFAULT_MAX_BACKOFF = 1.0
        self.BACKOFF_GROWTH_RATE = 2.0
        self.TRANSACTION_SIZE_LIMIT = 1 << 24
        self.KEY_SIZE_LIMIT = 10000
        self.VALUE_SIZE_LIMIT = 100000
        # Duplicate a storage read to the next replica when the preferred
        # one hasn't answered within this delay (reference LoadBalance
        # second-request hedging).
        self.HEDGE_REQUEST_DELAY = 0.075
        # Client-side GRV batching (reference readVersionBatcher in
        # NativeAPI.actor.cpp): concurrent plain transactions of one
        # Database share a single GetReadVersionRequest
        # (transaction_count = N).  Off by default: one GRV per
        # transaction.
        self.GRV_BATCH_ENABLED = False
        # Read-version lease (causal-read-risky, default off): a read
        # version from a GRV reply is reused for up to this many seconds;
        # a read-only transaction can miss writes committed inside the
        # window (the reference's CAUSAL_READ_RISKY trade).  0 disables.
        self.GRV_LEASE_S = 0.0


_server = ServerKnobs()
_client = ClientKnobs()


def server_knobs() -> ServerKnobs:
    return _server


def client_knobs() -> ClientKnobs:
    return _client
