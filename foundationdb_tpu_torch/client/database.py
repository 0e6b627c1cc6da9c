"""Database / Transaction: the client API (a trimmed copy of
foundationdb_tpu/client/database.py).

Reference: fdbclient/NativeAPI.actor.cpp (Database/Transaction: GRV
batching :2717, location cache :2334, getValue :2476, getRange :3311,
tryCommit :5018, onError retry loop) layered with ReadYourWrites semantics
(fdbclient/ReadYourWrites.actor.cpp): reads see the transaction's own
uncommitted writes, and read/write conflict ranges accrue automatically.

Usage, on the port's event loop (server/cluster.py StaticCluster):
    loop = EventLoop()
    cluster = StaticCluster(..., clock=loop.now, datadir=...)
    cluster.start(loop)
    db = cluster.database()
    async def work():
        txn = db.create_transaction()
        while True:
            try:
                v = await txn.get(b"counter")
                txn.set(b"counter", bump(v))
                await txn.commit()
                return
            except FdbError as e:
                await txn.on_error(e)
    cluster.run_until(loop.spawn(work()))

Kept whole: the proxies taken round robin; the client-side GRV batcher
and the read-version lease, gated by knobs and off by default; the
location cache (a range read's chunk that answers wrong_shard_server or
broken_promise drops its shard from it, as a point read drops its key:
after a shard moves, the reference's range read would ask the vacated
team again on every retry), get_shard_location; read_replica with replica failover, hedging after
HEDGE_REQUEST_DELAY and the latency ordering; and Transaction's reads
(get, get_range with its shard-by-shard chunks), the conflicting-keys
rows, writes, versionstamps, conflict ranges, commit, on_error, run,
reset and set_read_version.

ClusterConnection (the reference's :50-125, but get_status) is the
client's handle to a SimFdbCluster (server/cluster.py): it follows the
elected cluster controller through the coordinators (monitor_leader) and
long-polls its ClientDBInfo, so a Database reaches each new epoch's
proxies after a recovery.

Left out on purpose: open_cluster and get_status (a real network's
cluster file and a status document), watches (the port's storage servers have none), the
TSS compare and quarantine, tenants and open_tenant, the \xff\xff/status,
/management and /metrics special-key modules (they read a status document
the port does not build), the debug_id trace points, throttle tags on
reads, and the lock_aware option (the port's proxy has no lock).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..core.error import FdbError, err
from ..core.futures import Future
from ..core.knobs import client_knobs
from ..core.scheduler import delay
from ..rpc.endpoint import RequestStream
from ..server.interfaces import (CommitTransactionRequest,
                                 GetKeyServerLocationsRequest,
                                 GetKeyValuesRequest, GetReadVersionRequest,
                                 GetValueRequest, TransactionPriority)
from ..server.shardmap import RangeMap
from ..txn.types import (CommitTransactionRef, KeyRange, MutationType,
                         Version, key_after)
from .writemap import WriteMap

RETRYABLE = frozenset({
    "not_committed", "transaction_too_old", "future_version",
    "commit_unknown_result", "process_behind", "proxy_memory_limit_exceeded",
    "broken_promise", "request_maybe_delivered", "connection_failed",
    "wrong_shard_server",
})


class ClusterConnection:
    """The dynamic connection: tracks the elected cluster controller
    through the coordinators and long-polls its ClientDBInfo (reference
    MonitorLeader.actor.cpp and OpenDatabaseRequest)."""

    def __init__(self, coordinators) -> None:
        from ..core.futures import AsyncVar
        from ..core.scheduler import spawn
        from ..server.coordination import monitor_leader
        from ..server.interfaces import ClientDBInfo
        self.coordinators = coordinators
        self.leader = AsyncVar(None)
        self.client_info = AsyncVar(ClientDBInfo())
        self._actors = [
            spawn(monitor_leader(coordinators, self.leader),
                  "client.monitorLeader"),
            spawn(self._open_database_loop(), "client.openDatabase"),
        ]

    @property
    def grv_proxies(self):
        return self.client_info.get().grv_proxies

    @property
    def commit_proxies(self):
        return self.client_info.get().commit_proxies

    async def wait_ready(self) -> None:
        while not (self.grv_proxies and self.commit_proxies):
            await self.client_info.on_change()

    async def _open_database_loop(self) -> None:
        from ..core.futures import swallow, wait_any
        from ..server.interfaces import OpenDatabaseRequest
        known_epoch = -1
        while True:
            leader = self.leader.get()
            cc = leader.serialized_info if leader else None
            if cc is None:
                await self.leader.on_change()
                continue
            reply_f = RequestStream.at(cc.open_database.endpoint).get_reply(
                OpenDatabaseRequest(known_epoch=known_epoch))
            # A poll parked on a deposed or dead controller must not
            # strand the client: race it against a leader change.
            idx, _ = await wait_any([swallow(reply_f),
                                     self.leader.on_change()])
            if idx == 1:
                continue
            if reply_f.is_error():
                await delay(0.5)
                continue
            info = reply_f.get()
            known_epoch = info.epoch
            self.client_info.set(info)

    def close(self) -> None:
        for a in self._actors:
            if not a.is_ready():
                a.cancel()


class Database:
    """Client handle to a cluster (reference DatabaseContext)."""

    def __init__(self, cluster: Any) -> None:
        # `cluster` provides grv_proxies / commit_proxies interface lists
        # (server/cluster.py StaticCluster).
        self.cluster = cluster
        self._location_cache: RangeMap = RangeMap(default=None)
        self._rr = 0   # round-robin over proxies / replicas
        # Per-replica EWMA latency (reference QueueModel feeding
        # LoadBalance.actor.h): reads prefer faster replicas; a failed
        # attempt is penalized so the replica sorts last until the
        # penalty decays and it proves itself again.
        self._replica_latency: dict = {}
        # Read-version acquisition fast paths (both knob-gated,
        # default off — the knobs-off client issues exactly one GRV per
        # transaction as before):
        #  - _grv_lease: (expires_at, reply) — a GRV_LEASE_S-bounded
        #    cached read version (causal-read-risky: a leased version may
        #    trail the latest commit; OCC still aborts stale read-write
        #    conflicts, and this client's OWN commits bump the lease
        #    floor so read-your-own-writes holds per client).
        #  - _grv_batch: waiters of the in-flight client-side GRV batch
        #    (reference readVersionBatcher): concurrent plain
        #    transactions share one GetReadVersionRequest with
        #    transaction_count = N.
        self._grv_lease: Optional[Tuple[float, Any]] = None
        self._grv_batch: Optional[List[Any]] = None
        self._grv_refreshing = False
        # This client's highest committed version: the floor below which
        # a GRV reply must never ARM the lease (a reply resolved at the
        # proxy before our commit can arrive after it — arming with it
        # would break per-client read-your-own-writes while the lease
        # was empty).
        self._grv_commit_floor: Version = 0
        # Lease hits not yet reported to the GRV plane: piggybacked on
        # the NEXT real request's transaction_count, so the ratekeeper's
        # released-rate accounting still sees the true transaction load.
        self._grv_leases_unreported = 0
        self.grv_stats = {"leased": 0, "batched": 0, "requests": 0,
                          "refreshes": 0}

    from ..rpc.endpoint import TRANSPORT_ERRORS as _FAILOVER_ERRORS

    # Replicas whose EWMA latencies fall in the same band alternate
    # round-robin — strict fastest-first would pin ALL reads onto one
    # replica and halve the team's read throughput.
    _LATENCY_BAND = 0.05

    @staticmethod
    def _replica_key(ssi):
        # The replica's read stream (one object an interface, whether its
        # endpoint is an address on the network or the stream itself).
        stream = getattr(ssi, "get_value", None)
        return id(stream) if stream is not None else id(ssi)

    def _order_replicas(self, ssis):
        self._rr += 1
        rr = self._rr
        # Age penalties/estimates toward zero so a demoted replica is
        # re-probed eventually instead of staying blacklisted forever.
        for k in self._replica_latency:
            self._replica_latency[k] *= 0.9
        return sorted(
            ssis, key=lambda s: (
                int(self._replica_latency.get(self._replica_key(s), 0.0)
                    / self._LATENCY_BAND),
                (rr + ssis.index(s)) % len(ssis)))

    def _note_latency(self, ssi, dt: float) -> None:
        k = self._replica_key(ssi)
        prev = self._replica_latency.get(k, dt)
        self._replica_latency[k] = 0.8 * prev + 0.2 * dt

    async def read_replica(self, ssis, stream_of, make_request):
        """One storage read with REPLICA FAILOVER and HEDGING (reference
        LoadBalance.actor.h): replicas are tried fastest-first; transport
        failures move to the next replica instead of surfacing, so a dead
        replica costs latency, not a client error.  When the preferred
        replica is SLOW (no reply within the hedge delay) the request is
        duplicated to the next replica and the first answer wins — a
        degraded-but-alive replica costs the hedge delay, not its full
        stall (reference secondRequestPool duplicate requests).
        Non-transport errors (wrong_shard_server, future_version, ...)
        raise through."""
        from ..core.futures import swallow, wait_any
        from ..core.knobs import client_knobs
        from ..core.scheduler import delay as _delay
        from ..core.scheduler import now as _now
        hedge_s = float(client_knobs().HEDGE_REQUEST_DELAY)
        ordered = self._order_replicas(list(ssis))
        last: Optional[BaseException] = None
        i = 0
        while i < len(ordered):
            ssi = ordered[i]
            t0 = _now()
            f = RequestStream.at(
                stream_of(ssi).endpoint).get_reply(make_request())
            hedge = None
            hedge_ssi = None
            hedge_t0 = 0.0
            demoted = False
            if i + 1 < len(ordered):
                # The losing hedge timer stays in the scheduler heap
                # until it fires: one (float, lambda) tuple living
                # hedge_s — a few hundred entries even at 10k reads/s,
                # not worth a cancellable-timer mechanism.
                idx, _ = await wait_any([swallow(f), _delay(hedge_s)])
                if idx == 1 and not f.is_ready():
                    hedge_ssi = ordered[i + 1]
                    hedge_t0 = _now()
                    hedge = RequestStream.at(
                        stream_of(hedge_ssi).endpoint).get_reply(
                        make_request())
                    await wait_any([swallow(f), swallow(hedge)])
                    if hedge.is_ready() and not f.is_ready():
                        # Hedge won: demote the laggard so later reads
                        # prefer the responsive replica.  Its own latency
                        # is measured from ITS send, not t0 — charging
                        # the hedge delay to the winner would misorder
                        # it below genuinely slower replicas.
                        self._note_latency(ssi, 1.0)
                        demoted = True
                        if not hedge.is_error():
                            self._note_latency(hedge_ssi,
                                               _now() - hedge_t0)
                            return hedge.get()
                        # Hedge errored while the preferred replica is
                        # STILL silent: if replicas remain beyond both,
                        # move on rather than waiting out the stall (the
                        # abandoned read is idempotent); with nothing
                        # left, the slow-but-alive replica is still the
                        # best bet — fall through and await it.
                        e2 = hedge.error
                        if getattr(e2, "name", "") not in \
                                self._FAILOVER_ERRORS:
                            raise e2
                        self._note_latency(hedge_ssi, 1.0)
                        last = e2
                        if i + 2 < len(ordered):
                            i += 2
                            continue
                        hedge = None       # spent; await f below
            try:
                reply = await f
                self._note_latency(ssi, _now() - t0)
                return reply
            except FdbError as e:
                if e.name in self._FAILOVER_ERRORS:
                    if not demoted:
                        self._note_latency(ssi, 1.0)  # demote; decays back
                    last = e
                    # The hedge may still deliver: harvest it before
                    # moving on (it targeted the NEXT replica).
                    if hedge is not None:
                        try:
                            reply = await hedge
                            self._note_latency(hedge_ssi,
                                               _now() - hedge_t0)
                            return reply
                        except FdbError as e2:
                            if e2.name not in self._FAILOVER_ERRORS:
                                raise
                            self._note_latency(hedge_ssi, 1.0)
                            last = e2
                            i += 1      # both tried: skip the hedged one
                    i += 1
                    continue
                raise
        raise last or err("wrong_shard_server", "no replica answered")

    # -- proxies -------------------------------------------------------------
    async def _await_ready(self) -> None:
        waiter = getattr(self.cluster, "wait_ready", None)
        if waiter is not None:
            await waiter()

    def _grv_proxy(self):
        proxies = self.cluster.grv_proxies
        if not proxies:
            raise err("request_maybe_delivered", "no GRV proxies known yet")
        self._rr += 1
        return proxies[self._rr % len(proxies)]

    def _commit_proxy(self):
        proxies = self.cluster.commit_proxies
        if not proxies:
            raise err("request_maybe_delivered",
                      "no commit proxies known yet")
        self._rr += 1
        return proxies[self._rr % len(proxies)]

    # -- read-version acquisition (reference readVersionBatcher :2717) -------
    def _read_version_future(self, priority: int, debug_id: str,
                             tags: tuple, tenant_id: int) -> Future:
        """One transaction's read-version future.  Plain requests
        (DEFAULT priority, no tags/tenant/debug id) may be served from
        the lease or folded into the client-side batch; everything else
        — throttle tags, tenant identity, priorities, traced txns —
        keeps its own request so proxy-side enforcement and the
        scheduling predictor see the true identity."""
        from ..core.futures import Promise
        knobs = client_knobs()
        plain = (priority == TransactionPriority.DEFAULT and not tags
                 and tenant_id == -1 and not debug_id)
        if plain:
            reply = self._leased_read_version()
            if reply is not None:
                self.grv_stats["leased"] += 1
                self._grv_leases_unreported += 1
                p: Promise = Promise()
                p.send(reply)
                return p.get_future()
            if knobs.GRV_BATCH_ENABLED:
                p = Promise()
                if self._grv_batch is None:
                    self._grv_batch = [p]
                    from ..core.scheduler import spawn
                    spawn(self._flush_grv_batch(), "client.grvBatcher")
                else:
                    self.grv_stats["batched"] += 1
                    self._grv_batch.append(p)
                return p.get_future()
        self.grv_stats["requests"] += 1
        proxy = self._grv_proxy()
        count = 1
        if plain:
            count += self._take_unreported_leases()
        return RequestStream.at(
            proxy.get_consistent_read_version.endpoint).get_reply(
            GetReadVersionRequest(priority=priority, debug_id=debug_id,
                                  transaction_count=count,
                                  tags=tags, tenant_id=tenant_id))

    def _take_unreported_leases(self) -> int:
        n, self._grv_leases_unreported = self._grv_leases_unreported, 0
        return n

    async def _flush_grv_batch(self) -> None:
        """Close the batching window, issue ONE GRV carrying the whole
        batch's transaction_count (the ratekeeper budget charge stays
        exact), fan the reply out to every waiter."""
        from ..core.scheduler import delay
        await delay(float(client_knobs().GRV_BATCH_TIMEOUT))
        waiters, self._grv_batch = self._grv_batch or [], None  # flowlint: state -- owns the drained batch (swap pattern)
        self.grv_stats["requests"] += 1
        try:
            proxy = self._grv_proxy()
            reply = await RequestStream.at(
                proxy.get_consistent_read_version.endpoint).get_reply(
                GetReadVersionRequest(
                    transaction_count=(len(waiters) +
                                       self._take_unreported_leases())))
        except BaseException as e:  # noqa: BLE001 — waiters must never
            # hang: every promise gets the failure (retryable at each
            # transaction's own retry loop); cancellation keeps unwinding.
            for p in waiters:
                if not p.is_set():
                    p.send_error(err("request_maybe_delivered",
                                     f"batched GRV failed: {e!r}"))
            if not isinstance(e, Exception):
                raise
            return
        self._note_grv_reply(reply)
        for p in waiters:
            if not p.is_set():
                p.send(reply)

    def _leased_read_version(self):
        """The cached GRV reply while the lease is fresh, else None.
        A hit in the BACK HALF of the window kicks one background
        refresh, so under steady traffic the lease renews without any
        transaction ever blocking on the expiry round trip (the
        synchronous miss-burst — all committers stalling on one GRV at
        once — measurably costs ~25% e2e commits/s)."""
        lease_s = float(client_knobs().GRV_LEASE_S)
        if lease_s <= 0.0 or self._grv_lease is None:
            return None
        from ..core.scheduler import now
        expires, reply = self._grv_lease
        t = now()
        if t <= expires:
            if t > expires - lease_s / 2 and not self._grv_refreshing:
                self._grv_refreshing = True
                from ..core.scheduler import spawn
                spawn(self._refresh_lease(), "client.grvLeaseRefresh")
            return reply
        self._grv_lease = None
        return None

    async def _refresh_lease(self) -> None:
        """Background lease renewal: one plain GRV whose reply re-arms
        the window.  Failures are dropped — the next consumer then pays
        the round trip like any lease miss."""
        try:
            self.grv_stats["requests"] += 1
            self.grv_stats["refreshes"] += 1
            proxy = self._grv_proxy()
            reply = await RequestStream.at(
                proxy.get_consistent_read_version.endpoint).get_reply(
                GetReadVersionRequest(
                    transaction_count=(1 +
                                       self._take_unreported_leases())))
            self._note_grv_reply(reply)
        except FdbError:
            pass
        finally:
            self._grv_refreshing = False

    def _note_grv_reply(self, reply) -> None:
        """Fold a genuine proxy reply into the lease (never synthetic
        set_read_version futures — they lack the reply surface — and
        never locked-database replies); the lease version only moves
        forward.  Each reply object is folded AT MOST ONCE: a lease HIT
        re-observes the cached reply at consumption, and letting that
        refresh the expiry would slide the lease forever under
        continuous traffic — the GRV_LEASE_S staleness bound must be
        measured from a real proxy round trip."""
        lease_s = float(client_knobs().GRV_LEASE_S)
        if lease_s <= 0.0 or not hasattr(reply, "tag_throttles") or \
                getattr(reply, "locked", False):
            return
        if getattr(reply, "_lease_noted", False):
            return
        reply._lease_noted = True
        from ..core.scheduler import now
        if reply.version < self._grv_commit_floor:
            # Resolved at the proxy before our own latest commit:
            # arming the (possibly empty) lease with it would serve
            # later transactions a version below this client's writes.
            import dataclasses as _dc
            reply = _dc.replace(reply, version=self._grv_commit_floor)
            reply._lease_noted = True
        if self._grv_lease is not None and \
                self._grv_lease[1].version > reply.version:
            # The held version is newer (e.g. our own commit bumped the
            # floor), but this FRESH round trip still proves recency:
            # refresh the expiry on the newer held reply.
            self._grv_lease = (now() + lease_s, self._grv_lease[1])
            return
        self._grv_lease = (now() + lease_s, reply)

    def _note_commit_version(self, version: Version) -> None:
        """This client's own commit bumps the lease floor so a later
        leased transaction reads its writes (per-client causality; the
        proxies reported the version to the master before the commit
        reply, so `version` is a legal read version cluster-wide).  The
        floor is tracked even while no lease is armed: an in-flight GRV
        reply that RESOLVED before this commit may otherwise arm the
        lease below it."""
        if float(client_knobs().GRV_LEASE_S) <= 0.0:
            return
        if version > self._grv_commit_floor:
            self._grv_commit_floor = version
        if self._grv_lease is None:
            return
        expires, reply = self._grv_lease
        if version > reply.version:
            import dataclasses as _dc
            bumped = _dc.replace(reply, version=version)
            # The copy is lease-internal, not a fresh proxy round trip:
            # it must never re-enter _note_grv_reply as "new" (expiry
            # would slide; see there).
            bumped._lease_noted = True
            self._grv_lease = (expires, bumped)

    # -- location cache (reference getKeyLocation :2334) ---------------------
    async def get_key_location(self, key: bytes) -> List[Any]:
        cached = self._location_cache.lookup(key)
        if cached is not None:
            return cached
        proxy = self._commit_proxy()
        reply = await RequestStream.at(
            proxy.get_key_servers_locations.endpoint).get_reply(
            GetKeyServerLocationsRequest(begin=key, end=key_after(key)))
        for rng, ssis in reply.results:
            self._location_cache.set_range(rng.begin, rng.end, ssis)
        out = self._location_cache.lookup(key)
        if out is None:
            raise err("wrong_shard_server", f"no location for {key!r}")
        return out

    async def get_location_before(self, end: bytes
                                  ) -> Tuple[bytes, bytes, List[Any]]:
        """Shard containing the greatest key strictly below `end` (for
        reverse scans)."""
        b, e, ssis = self._location_cache.range_before(end)
        if ssis is not None:
            return b, e, ssis
        proxy = self._commit_proxy()
        reply = await RequestStream.at(
            proxy.get_key_servers_locations.endpoint).get_reply(
            GetKeyServerLocationsRequest(begin=b"", end=end, limit=1,
                                         reverse=True))
        for rng, team in reply.results:
            self._location_cache.set_range(rng.begin, rng.end, team)
        b, e, ssis = self._location_cache.range_before(end)
        if ssis is None:
            raise err("wrong_shard_server", f"no location before {end!r}")
        return b, e, ssis

    def invalidate_cache(self, key: bytes) -> None:
        self._location_cache.set_range(key, key_after(key), None)

    async def get_shard_location(self, key: bytes):
        """(shard_begin, shard_end, [StorageServerInterface]) of the shard
        holding `key`: the consistency check's surface."""
        await self.get_key_location(key)
        return self._location_cache.range_containing(key)

    def create_transaction(self) -> "Transaction":
        return Transaction(self)


class Transaction:
    """One transaction attempt chain (reference Transaction + RYW)."""

    def __init__(self, db: Database) -> None:
        self.db = db
        self._backoff = client_knobs().DEFAULT_BACKOFF
        self._reset()

    def _reset(self) -> None:
        """Clear per-attempt state (keeps backoff and options; see
        reset/on_error)."""
        self._read_version: Optional[Future] = None
        self.writes = WriteMap()
        self.read_conflict_ranges: List[Tuple[bytes, bytes]] = []
        self._extra_write_ranges: List[Tuple[bytes, bytes]] = []
        self.committed_version: Version = -1
        self.priority = TransactionPriority.DEFAULT
        # Per-attempt versionstamp future: dropped on reset, so waiters of
        # a failed attempt see broken_promise (reference: the versionstamp
        # future errors when the transaction is reset).
        self._versionstamp_promise = None
        self._committed_stamp = None
        self._committed_readonly = False
        # Reference ACCESS_SYSTEM_KEYS transaction option: \xff keys are
        # rejected unless explicitly enabled (management/DD transactions).
        if not hasattr(self, "access_system_keys"):
            self.access_system_keys = False
        # REPORT_CONFLICTING_KEYS option + the resulting ranges of the
        # last not_committed attempt, surfaced via
        # \xff\xff/transaction/conflicting_keys (reference RYW +
        # SpecialKeySpace ConflictingKeysImpl).  Both survive _reset so
        # the retry loop can read them before on_error clears state.
        if not hasattr(self, "report_conflicting_keys"):
            self.report_conflicting_keys = False
        if not hasattr(self, "_conflicting_keys"):
            # Survives attempt resets: the RETRY reads the previous
            # attempt's conflicts (reference: conflicting-keys special
            # keys are populated for the attempt after the conflict).
            self._conflicting_keys: List[Tuple[bytes, bytes]] = []
        # Throttling tag (reference TransactionOptions::tags /
        # fdbclient/TagThrottle): carried on GRVs and commits (the port
        # throttles nothing; reads do not carry it).
        if not hasattr(self, "tag"):
            self.tag: str = ""
        # Tenant identity (reference TenantInfo on CommitTransactionRef):
        # -1 = raw (tenant-less) transaction, the only kind the port
        # has.
        if not hasattr(self, "tenant_id"):
            self.tenant_id: int = -1
        # DEBUG_TRANSACTION_IDENTIFIER (reference option): a non-empty id
        # rides the GRV and commit requests (no trace points here).
        if not hasattr(self, "debug_id"):
            self.debug_id: str = ""
        # Transaction-repair opt-in (sched/repair.py): the
        # client declares its mutations remain valid under re-read
        # (blind writes, atomic ops, existence guards), so the commit
        # proxy may re-stamp a staleness-only abort at a fresh read
        # version and re-resolve it server-side instead of bouncing.
        # NEVER set this on a transaction whose mutation VALUES were
        # computed from its reads — the server cannot re-run client
        # logic, so a repair would commit stale derivations.
        if not hasattr(self, "repairable"):
            self.repairable: bool = False

    def reset(self) -> None:
        self._conflicting_keys = []
        self._reset()
        self._backoff = client_knobs().DEFAULT_BACKOFF

    # -- read version --------------------------------------------------------
    def get_read_version(self) -> Future:
        if self._read_version is None:
            self._read_version = self.db._read_version_future(
                priority=self.priority, debug_id=self.debug_id,
                tags=(self.tag,) if self.tag else (),
                tenant_id=self.tenant_id)
        return self._read_version

    GRV_TIMEOUT = 5.0
    COMMIT_TIMEOUT = 10.0

    def set_read_version(self, version: Version) -> None:
        """Read at a caller-chosen version (reference
        fdb_transaction_set_read_version): chunked backup snapshots read
        every chunk at ONE version for a consistent image."""
        from types import SimpleNamespace
        from ..core.futures import Promise
        p: Promise = Promise()
        p.send(SimpleNamespace(version=version))
        self._read_version = p.get_future()

    async def _ensure_read_version(self) -> Version:
        from ..core.futures import wait_any
        if self._read_version is None:
            await self.db._await_ready()
        f = self.get_read_version()
        idx, _ = await wait_any([f, delay(self.GRV_TIMEOUT)])
        if idx == 1:
            # Recovery in flight: the proxy we asked is gone or wedged.
            self._read_version = None
            raise err("request_maybe_delivered", "GRV timed out")
        reply = f.get()
        self.db._note_grv_reply(reply)
        return reply.version

    # Special keyspace (reference SpecialKeySpace.actor.h ConflictingKeys
    # module): boundary keys under this prefix with \x01 = range begin,
    # \x00 = range end, populated after a not_committed attempt with
    # report_conflicting_keys set.
    CONFLICTING_KEYS_PREFIX = b"\xff\xff/transaction/conflicting_keys/"

    def _conflicting_key_rows(self) -> List[Tuple[bytes, bytes]]:
        # Coalesce first: per-resolver clipping can split one logical
        # range at resolver boundaries, and un-merged pieces would emit
        # the shared boundary twice with contradictory begin/end markers.
        merged: List[List[bytes]] = []
        for b, e in sorted(self._conflicting_keys):
            if merged and b <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([b, e])
        rows: List[Tuple[bytes, bytes]] = []
        p = self.CONFLICTING_KEYS_PREFIX
        for b, e in merged:
            rows.append((p + b, b"\x01"))
            rows.append((p + e, b"\x00"))
        return rows

    # -- reads ---------------------------------------------------------------
    async def get(self, key: bytes, snapshot: bool = False
                  ) -> Optional[bytes]:
        if key.startswith(self.CONFLICTING_KEYS_PREFIX):
            for k, v in self._conflicting_key_rows():
                if k == key:
                    return v
            return None
        _check_key(key, self.access_system_keys)
        if not snapshot:
            self.read_conflict_ranges.append((key, key_after(key)))
        if self.writes.is_unreadable(key):
            raise err("accessed_unreadable")
        if self.writes.has_writes(key) and not self.writes.needs_base(key):
            return self.writes.merge(key, None)
        base = await self._storage_get(key)
        return self.writes.merge(key, base)

    async def _storage_get(self, key: bytes) -> Optional[bytes]:
        version = await self._ensure_read_version()
        ssis = await self.db.get_key_location(key)
        if not ssis:
            raise err("wrong_shard_server", f"no team for {key!r}")
        try:
            reply = await self.db.read_replica(
                ssis, lambda s: s.get_value,
                lambda: GetValueRequest(key=key, version=version))
        except FdbError as e:
            if e.name in ("broken_promise", "wrong_shard_server"):
                self.db.invalidate_cache(key)
            raise
        return reply.value

    async def get_range(self, begin: bytes, end: bytes, limit: int = 1000,
                        reverse: bool = False, snapshot: bool = False,
                        limit_bytes: int = 0
                        ) -> List[Tuple[bytes, bytes]]:
        """Range read with RYW overlay (reference getRange :3311).

        The scan proceeds shard chunk by shard chunk from the iteration end
        (begin for forward, end for reverse); each chunk's snapshot data is
        complete for its covered span, so overlaying this transaction's
        writes per-span cannot leave gaps even when the storage reply was
        limit-truncated.

        `limit_bytes` > 0 bounds the TOTAL result bytes across chunks
        (reference GetRangeLimits.bytes): the scan stops once the budget
        is consumed, with the row that crossed it included — so large-
        value scans can stream in bounded slices instead of holding a
        whole shard's rows.  0 (default) keeps the per-chunk storage
        default."""
        if begin >= end:
            return []
        p = self.CONFLICTING_KEYS_PREFIX
        if begin.startswith(p) or (begin <= p and end > p):
            rows = [(k, v) for k, v in self._conflicting_key_rows()
                    if begin <= k < end]
            if reverse:
                rows.reverse()
            return rows[:limit]
        if not snapshot:
            self.read_conflict_ranges.append((begin, end))
        version = await self._ensure_read_version()
        out: List[Tuple[bytes, bytes]] = []
        nbytes = 0
        budget = limit_bytes if limit_bytes > 0 else 0
        # Per-chunk request bound: the remaining budget, capped at the
        # storage default — shipping a huge remaining budget as ONE
        # chunk's limit_bytes would ask storage to materialize and
        # encode it all in a single reply frame.
        def chunk_bytes() -> int:
            return min(budget - nbytes, 1 << 20) if budget else 0
        if not reverse:
            cursor = begin
            while cursor < end and len(out) < limit:
                data, covered_end = await self._fetch_chunk_forward(
                    cursor, end, version, limit - len(out), chunk_bytes())
                merged = self._merge_span(data, cursor, covered_end)
                out.extend(merged)
                cursor = covered_end
                if budget:
                    # Only the new span's bytes: re-summing `out` per
                    # chunk would make budgeted scans O(rows^2).
                    nbytes += sum(len(k) + len(v) for k, v in merged)
                    if nbytes >= budget:
                        break
        else:
            cursor = end
            while cursor > begin and len(out) < limit:
                data, covered_begin = await self._fetch_chunk_reverse(
                    begin, cursor, version, limit - len(out), chunk_bytes())
                merged = self._merge_span(sorted(data), covered_begin, cursor)
                out.extend(reversed(merged))
                cursor = covered_begin
                if budget:
                    nbytes += sum(len(k) + len(v) for k, v in merged)
                    if nbytes >= budget:
                        break
        return out[:limit]

    async def _fetch_chunk_forward(
            self, cursor: bytes, end: bytes, version: Version, limit: int,
            limit_bytes: int = 0
    ) -> Tuple[List[Tuple[bytes, bytes]], bytes]:
        """One storage fetch; returns (data, covered_end): the snapshot is
        complete over [cursor, covered_end)."""
        ssis = await self.db.get_key_location(cursor)
        _, rng_e, _ = self.db._location_cache.range_containing(cursor)
        shard_end = min(rng_e, end)
        if not ssis:
            raise err("wrong_shard_server")
        kwargs = {"limit_bytes": limit_bytes} if limit_bytes > 0 else {}
        reply = await self._read_chunk(
            cursor, ssis, lambda: GetKeyValuesRequest(
                begin=cursor, end=shard_end, version=version, limit=limit,
                **kwargs))
        if reply.more and reply.data:
            return reply.data, key_after(reply.data[-1][0])
        return reply.data, shard_end

    async def _fetch_chunk_reverse(
            self, begin: bytes, cursor: bytes, version: Version, limit: int,
            limit_bytes: int = 0
    ) -> Tuple[List[Tuple[bytes, bytes]], bytes]:
        """One reverse storage fetch; returns (data descending,
        covered_begin): complete over [covered_begin, cursor)."""
        rng_b, _, ssis = await self.db.get_location_before(cursor)
        shard_begin = max(rng_b, begin)
        if not ssis:
            raise err("wrong_shard_server")
        kwargs = {"limit_bytes": limit_bytes} if limit_bytes > 0 else {}
        reply = await self._read_chunk(
            shard_begin, ssis, lambda: GetKeyValuesRequest(
                begin=shard_begin, end=cursor, version=version, limit=limit,
                reverse=True, **kwargs))
        if reply.more and reply.data:
            return reply.data, reply.data[-1][0]   # inclusive smallest key
        return reply.data, shard_begin

    async def _read_chunk(self, key: bytes, ssis, make_request):
        """One chunk's read from the team cached for `key`'s shard; a
        team that answers wrong_shard_server or broken_promise drops
        that shard from the location cache, so the retry locates it
        again (a chunk of a range read, as a point read does; the
        reference's range read keeps the stale entry)."""
        try:
            return await self.db.read_replica(
                ssis, lambda s: s.get_key_values, make_request)
        except FdbError as e:
            if e.name in ("broken_promise", "wrong_shard_server"):
                b, e_, _t = self.db._location_cache.range_containing(key)
                self.db._location_cache.set_range(b, e_, None)
            raise

    def _merge_span(self, base: List[Tuple[bytes, bytes]], begin: bytes,
                    end: bytes) -> List[Tuple[bytes, bytes]]:
        """Overlay writes onto a snapshot that is COMPLETE over [begin, end);
        returns ascending merged items for exactly that span."""
        if not self.writes.mutations:
            return list(base)
        merged = dict(base)
        for _, cb, ce in self.writes.clears_in(begin, end):
            for k in [k for k in merged if cb <= k < ce]:
                del merged[k]
        for key in self.writes.touched_keys_in(begin, end):
            val = self.writes.merge(key, merged.get(key))
            if val is None:
                merged.pop(key, None)
            else:
                merged[key] = val
        return sorted(merged.items())

    # -- writes --------------------------------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        _check_key(key, self.access_system_keys)
        _check_value(value)
        self.writes.set(key, value)

    def clear(self, key: bytes, end: Optional[bytes] = None) -> None:
        _check_key(key, self.access_system_keys)
        self.writes.clear(key, end if end is not None else key_after(key))

    def atomic_op(self, op: MutationType, key: bytes, operand: bytes) -> None:
        _check_key(key, self.access_system_keys)
        self.writes.atomic_op(op, key, operand)

    # -- versionstamped operations (reference CommitTransaction.h:55-96,
    # versionstamp future NativeAPI.actor.cpp:5094) -------------------------
    def set_versionstamped_key(self, key_template: bytes, offset: int,
                               value: bytes) -> None:
        """Set a key whose 10-byte slot at `offset` is replaced with the
        commit versionstamp (8B big-endian version + 2B batch index) by
        the commit proxy.  `key_template[offset:offset+10]` is the
        placeholder."""
        _check_key(key_template, self.access_system_keys)
        _check_value(value)
        if not 0 <= offset <= len(key_template) - 10:
            raise err("client_invalid_operation",
                      "versionstamp slot out of range")
        self.writes.atomic_op(
            MutationType.SetVersionstampedKey,
            key_template + offset.to_bytes(4, "little"), value)

    def set_versionstamped_value(self, key: bytes, value_template: bytes,
                                 offset: int = 0) -> None:
        """Set `key` to a value whose 10-byte slot at `offset` becomes the
        commit versionstamp."""
        _check_key(key, self.access_system_keys)
        _check_value(value_template)
        if not 0 <= offset <= len(value_template) - 10:
            raise err("client_invalid_operation",
                      "versionstamp slot out of range")
        self.writes.atomic_op(
            MutationType.SetVersionstampedValue, key,
            value_template + offset.to_bytes(4, "little"))

    def get_versionstamp(self) -> Future:
        """Future for this attempt's 10-byte versionstamp; resolves after
        a successful commit, errors on a read-only commit (no commit
        version exists), and breaks on reset."""
        if self._versionstamp_promise is None:
            from ..core.futures import Promise
            self._versionstamp_promise = Promise()
            if self._committed_stamp is not None:
                self._versionstamp_promise.send(self._committed_stamp)
            elif self.committed_version == -1 and \
                    self._committed_readonly:
                self._versionstamp_promise.send_error(
                    err("operation_failed",
                        "read-only transaction has no versionstamp"))
        return self._versionstamp_promise.get_future()

    def add_read_conflict_range(self, begin: bytes, end: bytes) -> None:
        self.read_conflict_ranges.append((begin, end))

    def add_write_conflict_range(self, begin: bytes, end: bytes) -> None:
        self._extra_write_ranges.append((begin, end))

    # -- commit (reference tryCommit :5018) ----------------------------------
    async def commit(self) -> Version:
        wcr = self.writes.write_conflict_ranges() + self._extra_write_ranges  # flowlint: state -- commit resolves the entry-time write set
        if not self.writes.mutations and not wcr:
            # Read-only: nothing to resolve (reference returns immediately).
            self.committed_version = -1
            self._committed_readonly = True
            if self._versionstamp_promise is not None and \
                    not self._versionstamp_promise.is_set():
                self._versionstamp_promise.send_error(
                    err("operation_failed",
                        "read-only transaction has no versionstamp"))
            return -1
        read_snapshot = 0
        if self.read_conflict_ranges:
            read_snapshot = await self._ensure_read_version()
        txn = CommitTransactionRef(  # flowlint: state -- one txn snapshot per commit attempt
            read_conflict_ranges=[KeyRange(b, e) for b, e in
                                  _coalesce(self.read_conflict_ranges)],
            write_conflict_ranges=[KeyRange(b, e) for b, e in
                                   _coalesce(wcr)],
            mutations=self.writes.mutations,
            read_snapshot=read_snapshot,
            report_conflicting_keys=self.report_conflicting_keys,
            tenant_id=self.tenant_id,
            tag=self.tag)
        if txn.expected_size() > client_knobs().TRANSACTION_SIZE_LIMIT:
            raise err("transaction_too_large")
        await self.db._await_ready()
        proxy = self.db._commit_proxy()
        from ..core.futures import wait_any
        f = RequestStream.at(proxy.commit.endpoint).get_reply(  # flowlint: state -- the in-flight commit future
            CommitTransactionRequest(transaction=txn,
                                     debug_id=self.debug_id,
                                     repair_eligible=self.repairable))
        try:
            idx, _ = await wait_any([f, delay(self.COMMIT_TIMEOUT)])
        except FdbError as e:
            # The proxy may have logged the commit before dying: a lost
            # reply means the outcome is UNKNOWN, never "didn't happen" —
            # retrying as not-committed could double-apply (reference
            # tryCommit maps these to commit_unknown_result).
            if e.name in ("broken_promise", "connection_failed",
                          "request_maybe_delivered"):
                raise err("commit_unknown_result", f"commit lost: {e.name}")
            if e.name == "not_committed":
                # Conflicting read ranges ride the error reply; surface
                # them as \xff\xff/transaction/conflicting_keys to the
                # retry (reference NativeAPI :5118-5123).
                self._conflicting_keys = list(getattr(e, "details", []))
            raise
        if idx == 1:
            raise err("commit_unknown_result", "commit timed out")
        reply = f.get()
        self.committed_version = reply.version
        self.db._note_commit_version(reply.version)
        from ..txn.types import make_versionstamp
        self._committed_stamp = make_versionstamp(reply.version,
                                                  reply.txn_batch_index)
        if self._versionstamp_promise is not None and \
                not self._versionstamp_promise.is_set():
            self._versionstamp_promise.send(self._committed_stamp)
        return reply.version

    # -- retry loop (reference onError) --------------------------------------
    async def on_error(self, e: BaseException) -> None:
        if not (isinstance(e, FdbError) and e.name in RETRYABLE):
            raise e
        knobs = client_knobs()
        backoff = self._backoff
        self._reset()
        self._backoff = min(backoff * knobs.BACKOFF_GROWTH_RATE,
                            knobs.DEFAULT_MAX_BACKOFF)
        await delay(backoff)

    async def run(self, fn) -> Any:
        """Retry loop helper (reference runRYWTransaction): `fn(txn)` is an
        async callable; retried on retryable errors after reset."""
        while True:
            try:
                result = await fn(self)
                await self.commit()
                return result
            except BaseException as e:  # noqa: BLE001
                await self.on_error(e)


def _check_key(key: bytes, allow_system: bool = False) -> None:
    if len(key) > client_knobs().KEY_SIZE_LIMIT:
        raise err("key_too_large")
    if key >= (b"\xff\xff" if allow_system else b"\xff"):
        raise err("key_outside_legal_range")


def _check_value(value: bytes) -> None:
    if len(value) > client_knobs().VALUE_SIZE_LIMIT:
        raise err("value_too_large")


def _coalesce(ranges: List[Tuple[bytes, bytes]]
              ) -> List[Tuple[bytes, bytes]]:
    """Sort + merge overlapping conflict ranges."""
    if not ranges:
        return []
    rs = sorted(r for r in ranges if r[0] < r[1])
    out = [rs[0]] if rs else []
    for b, e in rs[1:]:
        if b <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((b, e))
    return out
