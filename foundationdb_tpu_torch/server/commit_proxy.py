"""The commit proxy: the commit pipeline over the resolution plane and the
log system (trimmed copy of foundationdb_tpu/server/commit_proxy.py).

Reference: fdbserver/CommitProxyServer.actor.cpp getResolution (:660,
ResolutionRequestBuilder :88), determineCommittedTransactions
(:792-806), assignMutationsToStorageServers (:891) and the logging and
reply phases of CommitBatchContext.  resolve() holds phases 2-3 of the
reference's _commit_batch_impl (:377-400): it adopts the master's resolver
boundary moves into its per-key ownership history (keyResolvers,
:154-181), clips each transaction's conflict ranges to every resolver
that owned them within the MVCC window, hands each Resolver role its
request, and merges the replies: a transaction commits iff every resolver
that judged it committed it, another proxy's state transaction commits
iff every resolver committed it (its \xff/keyServers/ mutations are
applied to this proxy's shard map then), and a reporter's conflicting
ranges are the union over the resolvers.

commit() runs the reference's _commit_batch_impl around it (:328-624):
phase 1, a version from the master (GetCommitVersionRequest, in
request_num order, with the boundary moves riding the reply), unless the
caller hands the versions in; the sched stage (b) reorder of the batch
(SCHED_REORDER_ENABLED; from there on the batch, its verdicts, ranges,
versionstamps and repair indices are in the reordered index, as in the
reference); the resolution; and with the master's version, phases 3-5:
the committed mutations routed to the tags of their storage teams
(_assign_mutations_to_tags: versionstamps spliced at the reordered
index, clears clipped per shard, \xff/keyServers/ mutations applied to
the shard map first and also sent on TXS_TAG, and before each the
disownment fence sent to every tag the change drops from a team), the
push to every TLog
through the LogSystemClient, which returns once every TLog has made the
version durable, and the committed version reported to the master.  Then
stage (c) _collect_repairs (SCHED_REPAIR_ENABLED, with its RepairLadder
at the reference's defaults), and the reply fan-out with the reference's
repair bookkeeping: each request not repaired is answered through its
own reply, exactly once, so the caller never sees the reordered index; a
repaired request carries its original reply into the repair batch
commit() returns, which the caller commits next on this proxy's chain
(through the master too, so every TLog's chain stays contiguous).  No
reply goes out before its version is durable on every TLog: a push or
report that fails raises out of commit() with no request answered.
With every SCHED_* knob off, commit()'s verdicts are resolve()'s.

Method for method the reference's, with these changes of form: the
requests the resolution stage takes are the transactions themselves (the
reference's CommitTransactionRequests carry each one as .transaction);
in commit() every role answers within the call, so a proxy hands its
batches over in version-chain order and the repair batch is the caller's
next call rather than a spawned actor; of the reference's two request builders and two
mutation assignments, which give the same requests and messages, only
the vectorised ones are kept (the builder clips inline, so _clip_ranges
has no copy here); and phase timings are kept in `phase_seconds` rather
than histograms.

Left out on purpose: tenant validation (_tenant_prefix_ok,
_validate_tenants) and the lock fence (db_locked), for the port's proxy
has neither tenants nor a lock; _apply_metadata's side effects other
than the shard map, the server registry and the configuration's
nudge to the master (backup, lock, cache ranges); the BACKUP, CACHE, TSS and region twin tags; the commit-debug spans and the
CommitConflictDetail trace of an aborted debug_id txn; the pipelining
gates (a logged commit() runs its batch to the end within the call, the
batcher waits for one batch before it closes the next; both refuse a
batch over COMMIT_TRANSACTION_BATCH_COUNT_MAX, and StaticCluster.commit
cuts requests to it); and the latency histograms.  Its counters are the
sched stages', the batcher's
(CommitBatches, CommitBatchTxns) and the replies' (TxnCommitted,
TxnConflicted, TxnTooOld, the reference's).

On a simulated or real process (run(process)), two actors serve the
proxy's interface, beside its waitFailure holder: _commit_batcher (the
reference's :220-286 without the lock and tenant fences and the buggify
of an early close) closes a batch COMMIT_TRANSACTION_BATCH_INTERVAL_MIN
after its first request, or at the byte cap or
COMMIT_TRANSACTION_BATCH_COUNT_MAX, and hands it to commit_async() and
every repair batch after it, each at a version of its own from the
master: commit()'s body (one coroutine, _commit) with the master's, the
resolvers' and the TLogs' requests sent to their interfaces over the
network; _serve_locations (:1305-1327 without the storage caches)
answers a client's key-location request with whole shards and their
storage interfaces.  A batch that fails marks the proxy broken: its
unanswered requests and every later one answer commit_unknown_result,
and the batcher's future carries the error.
"""

from __future__ import annotations

import dataclasses
from bisect import bisect_right
from time import perf_counter
from typing import Any, Dict, List, Optional, Tuple

from ..core.coverage import test_coverage
from ..core.error import FdbError, err
from ..core.futures import Future, wait_all
from ..core.histogram import CounterCollection
from ..core.knobs import server_knobs
from ..core.scheduler import delay, now
from ..core.trace import Severity, TraceEvent
from ..rpc.endpoint import RequestStream
from ..sched.reorder import moved_count, reorder_batch
from ..sched.repair import RepairLadder, repair_eligible
from ..txn.types import (CommitResult, CommitTransactionRef, KeyRange,
                         Mutation, MutationType, Version, make_versionstamp)
from .interfaces import (RESOLVER_ALL, TXS_TAG, CommitID,
                         CommitProxyInterface, CommitTransactionRequest,
                         GetCommitVersionRequest, GetKeyServerLocationsReply,
                         Reply, ReportRawCommittedVersionRequest,
                         ResolveTransactionBatchReply,
                         ResolveTransactionBatchRequest, Tag,
                         TLogCommitRequest, TLogPeekRequest, TLogPopRequest,
                         ask, call, run_within_call, same_incarnation)
from .failure import hold_wait_failure
from .shardmap import RangeMap
from .system_data import (DISOWN_SHARD_PREFIX, SYSTEM_KEYS_BEGIN,
                          apply_key_servers_mutation, disowned_spans,
                          parse_conf_mutation, parse_server_tag_mutation)

# Past this many txns stage (b) takes the one-round in-degree sort
# (the reference's SCHED_REORDER_EXACT_MAX default).
REORDER_EXACT_MAX = 1024
# The most transactions a logged batch holds (the reference batcher's
# COMMIT_TRANSACTION_BATCH_COUNT_MAX default); a versionstamp numbers its
# transaction's batch index in 2 bytes.
COMMIT_TRANSACTION_BATCH_COUNT_MAX = 32768


class LogSystemClient:
    """Client half of the tag-partitioned log system (reference
    ILogSystem::push, TagPartitionedLogSystem.actor.cpp).  Each tag's
    messages go to a team of `replication` TLogs; every TLog sees every
    version (possibly with no messages) so its version chain stays
    contiguous, and a push is durable only when ALL TLogs ack."""

    def __init__(self, tlogs: List[Any], replication: int = 1) -> None:
        self.tlogs = tlogs  # TLog roles
        self.replication = max(1, min(replication, len(tlogs)))

    def team_for_tag(self, tag: Tag) -> List[int]:
        n = len(self.tlogs)
        return [(tag + j) % n for j in range(self.replication)]

    def _requests(self, prev_version: Version, version: Version,
                  known_committed_version: Version,
                  messages: Dict[Tag, List[Mutation]]
                  ) -> List[TLogCommitRequest]:
        """Each TLog's request at `version`: its tags' messages."""
        per_log: List[Dict[Tag, List[Mutation]]] = [
            {} for _ in self.tlogs]
        for tag, msgs in messages.items():
            for i in self.team_for_tag(tag):
                per_log[i][tag] = msgs
        return [TLogCommitRequest(
                    prev_version=prev_version, version=version,
                    known_committed_version=known_committed_version,
                    messages=msgs) for msgs in per_log]

    def push(self, prev_version: Version, version: Version,
             known_committed_version: Version,
             messages: Dict[Tag, List[Mutation]]) -> List[Version]:
        """Hand every TLog its tags' messages at `version`; returns each
        TLog's durable version, once all of them have answered.  A TLog
        that raises (its disk queue failed) or answers nothing (stopped)
        raises here."""
        return [ask(tlog.commit, req) for tlog, req in zip(
            self.tlogs, self._requests(prev_version, version,
                                       known_committed_version, messages))]

    def push_over_network(self, prev_version: Version, version: Version,
                          known_committed_version: Version,
                          messages: Dict[Tag, List[Mutation]]) -> Future:
        """push() with each request sent to its TLog's interface: the
        Future of every TLog's durable version."""
        return wait_all([
            RequestStream.at(tlog.interface.commit.endpoint).get_reply(req)
            for tlog, req in zip(self.tlogs, self._requests(
                prev_version, version, known_committed_version, messages))])

    def durable_version(self) -> Version:
        """The newest version durable on every TLog: no recovery of this
        generation can end below it (its recovery version is the least
        end version over the locked logs)."""
        return min(t.durable_version for t in self.tlogs)

    def pop(self, tag: Tag, to: Version) -> None:
        for i in self.team_for_tag(tag):
            self.tlogs[i].pop(TLogPopRequest(tag=tag, to=to))

    def peek_tag(self, tag: Tag, begin: Version):
        """Peek one team member, failing over to the next replica of the
        team when one does not answer (reference peek cursor's
        best-server selection)."""
        last_err: Optional[FdbError] = None
        for i in self.team_for_tag(tag):
            try:
                return ask(self.tlogs[i].peek, TLogPeekRequest(tag=tag,
                                                               begin=begin))
            except FdbError as e:
                last_err = e
        raise last_err


def _splice_stamp(data: bytes, stamp: bytes) -> bytes:
    """Replace the 10-byte slot addressed by the trailing 4-byte
    little-endian offset with the versionstamp, dropping the suffix."""
    off = int.from_bytes(data[-4:], "little")
    body = data[:-4]
    if off + 10 > len(body):
        # Malformed offset: clamp to append semantics rather than corrupt.
        return body + stamp
    return body[:off] + stamp + body[off + 10:]


class CommitProxy:
    def __init__(self, proxy_id: str, resolvers: List[Any],
                 key_resolvers, recovery_version: Version = 0,
                 master: Any = None,
                 log_system: Optional[LogSystemClient] = None,
                 key_servers: Optional[RangeMap] = None) -> None:
        """`resolvers`: the Resolver roles, by index.  `key_resolvers`:
        a RangeMap, or a list of (begin, end, value) triples, whose
        values are resolver indices (the recruitment shape) or ownership
        histories, tuples of (version, resolver index) newest first.
        `master` (server/master.py Master) and `log_system`: the roles a
        commit() that takes no versions asks for its version and logs to.
        `key_servers`: this proxy's own copy of the shard map, a RangeMap
        of storage teams (lists of tags); empty by default."""
        self.id = proxy_id
        self.resolvers = resolvers
        self.master = master
        self.log_system = log_system
        # key -> [Tag] storage team (reference keyInfo/tagsForKey :926).
        self.key_servers: RangeMap = (key_servers if key_servers is not None
                                      else RangeMap(default=None))
        self.committed_version: Version = recovery_version
        self.version_request_num = 0
        # Seconds of the last commit()'s phases (version, resolution,
        # assign, push, report, replies; the reference's stage histograms).
        self.phase_seconds: Dict[str, float] = {}
        # key -> OWNERSHIP HISTORY: tuple of (version, resolver_idx),
        # newest first (reference ProxyCommitData::keyResolvers: a range
        # goes to every resolver that owned it within the MVCC window, so
        # old-snapshot conflict checks reach the resolver holding that
        # span's write history).
        if isinstance(key_resolvers, RangeMap):
            key_resolvers = key_resolvers.ranges()
        hist_map: RangeMap = RangeMap(default=((recovery_version, 0),))
        for b, e, v in key_resolvers:
            if isinstance(v, int):
                hist_map.set_range(b, e, ((recovery_version, v),))
            else:
                hist_map.set_range(b, e, tuple(v))
        self.key_resolvers = hist_map
        self._resolver_changes_hwm: Version = 0
        self.last_resolved_version: Version = recovery_version
        # Exactly-once cursor over foreign state transactions (version,
        # origin proxy, seq); see _apply_foreign_state.
        self._state_hwm: Tuple[Version, str, int] = (-1, "", -1)
        # The committed foreign state txns of the last commit() batch.
        self.last_state_transactions: List[tuple] = []
        self.local_batch_number = 0
        # The sched stages' counters (scheduler_status).
        self.metrics = CounterCollection("CommitProxy", proxy_id)
        # Built at the first repair collection.
        self._repair_ladder: Optional[RepairLadder] = None
        # The event-loop half (run()): the client-facing streams, the
        # storage interfaces the location service names by tag, and the
        # batcher's state.
        self.interface = CommitProxyInterface(proxy_id)
        self.interface.role = self   # in-process backref (not on the wire)
        self.storage_interfaces: Dict[Tag, Any] = {}
        self.broken = False
        self._wait_failure_actor = None     # the holder run() spawns
        # Seconds the batcher spent on its batches, and of them the
        # seconds waiting on the other roles' replies.
        self.batch_seconds = 0.0
        self.wait_seconds = 0.0

    # -- the commit batch (reference _commit_batch_impl, :328-624) -----------
    def commit(self, batch: List[CommitTransactionRequest],
               prev_version: Optional[Version] = None,
               commit_version: Optional[Version] = None,
               resolver_changes=()) -> List[CommitTransactionRequest]:
        """Commit one batch, every role called within the call.  With no
        versions given, phase 1 asks the master for the batch's version
        (the boundary moves ride its reply) and phases 3-5 log the
        committed mutations: routed to their tags, pushed to every TLog
        and durable there, the version reported to the master, all
        before any reply.  With versions given (`prev_version`,
        `commit_version`, and the moves in `resolver_changes`), the batch
        is resolved and answered at them and nothing is logged.  Either
        way stage (b) reorders the batch, resolve() resolves it, stage
        (c) collects its repairs, and every request not repaired is
        answered through its own reply: a CommitID, or not_committed (a
        reporter's conflicting ranges as its details) or
        transaction_too_old.  Returns the repair requests, each
        re-stamped at the commit version and carrying its original
        reply, for the caller to commit as the next batch on this
        proxy's chain."""
        return run_within_call(self._commit(
            batch, prev_version, commit_version, resolver_changes, False))

    async def commit_async(self, batch: List[CommitTransactionRequest]
                           ) -> List[CommitTransactionRequest]:
        """commit() of a logged batch with the master, the resolvers and
        the TLogs on processes of their own: each request to them crosses
        the network (their interfaces), and the batch waits for their
        replies (the batcher's path once the roles run on processes)."""
        return await self._commit(batch, None, None, (), True)

    async def _commit(self, batch, prev_version, commit_version,
                      resolver_changes, net: bool):
        """commit()'s body: `net` sends each role's request over the
        network; without it every role answers within the call and the
        coroutine never suspends."""
        t0 = perf_counter()
        self.local_batch_number += 1
        batch_num = self.local_batch_number  # flowlint: state -- this batch's number, kept across its awaits
        logged = commit_version is None
        if logged:
            if self.master is None or self.log_system is None:
                raise RuntimeError(f"proxy {self.id}: commit() without "
                                   "versions needs a master and a log "
                                   "system")
            self._refuse_unloggable(batch)
            self.version_request_num += 1
            vreply = await self._wait(call(
                self.master, "serve_commit_version", "get_commit_version",
                GetCommitVersionRequest(request_num=self.version_request_num,
                                        proxy_id=self.id), net))
            prev_version, commit_version = \
                vreply.prev_version, vreply.version
            resolver_changes = vreply.resolver_changes
        self.last_versions = (prev_version, commit_version)
        phases = {"version": perf_counter() - t0}
        knobs = server_knobs()
        if knobs.SCHED_REORDER_ENABLED and len(batch) > 1:
            batch = self._reorder(batch)
        txns = [req.transaction for req in batch]
        if net:
            merged = await self._resolve_over_network(
                txns, prev_version, commit_version, resolver_changes)
        else:
            merged = self.resolve(txns, prev_version, commit_version,
                                  resolver_changes)
        self.last_state_transactions = merged.state_transactions
        verdicts = merged.committed
        self.last_verdicts = verdicts
        conflict_ranges = merged.conflicting_ranges
        t = perf_counter()
        phases["resolution"] = t - t0 - phases["version"]
        if logged:
            messages = self._assign_mutations_to_tags(batch, verdicts,
                                                      commit_version)
            phases["assign"] = perf_counter() - t
            t = perf_counter()
            # Phase 4: every TLog makes the version durable before the
            # push returns; it raises, and nothing is answered, if one
            # cannot.
            if net:
                await self._wait(self.log_system.push_over_network(
                    prev_version, commit_version, self.committed_version,
                    messages))
            else:
                self.log_system.push(prev_version, commit_version,
                                     self.committed_version, messages)
            phases["push"] = perf_counter() - t
            t = perf_counter()
            if commit_version > self.committed_version:
                self.committed_version = commit_version
            # Phase 5: the master learns the committed version BEFORE any
            # client does, so a later read version sees this commit.
            await self._wait(call(
                self.master, "serve_report_committed",
                "report_live_committed_version",
                ReportRawCommittedVersionRequest(version=commit_version),
                net))
            phases["report"] = perf_counter() - t
            t = perf_counter()
        repaired: set = set()
        repair_reqs: List[CommitTransactionRequest] = []
        if knobs.SCHED_REPAIR_ENABLED:
            repair_reqs = self._collect_repairs(
                batch, verdicts, conflict_ranges, merged.attribution_exact,
                commit_version, repaired)
        self._send_replies(batch, verdicts, conflict_ranges, commit_version,
                           batch_num, repaired)
        phases["replies"] = perf_counter() - t
        self.phase_seconds = phases
        return repair_reqs

    async def _wait(self, f):
        """Await `f`, its seconds kept in `wait_seconds` (the batcher's
        time waiting on the other roles, not working)."""
        t = perf_counter()
        try:
            return await f
        finally:
            self.wait_seconds += perf_counter() - t

    # -- the batcher (reference commitBatcher :199, _commit_batcher
    # :220-286) ---------------------------------------------------------------
    async def _commit_batcher(self) -> None:
        knobs = server_knobs()
        queue = self.interface.commit.queue
        while True:
            first = await queue.pop()
            if self.broken:
                first.reply.send_error(err("commit_unknown_result"))
                continue
            batch = [first]
            batch_bytes = first.transaction.expected_size()
            deadline = now() + knobs.COMMIT_TRANSACTION_BATCH_INTERVAL_MIN
            while (batch_bytes < knobs.COMMIT_TRANSACTION_BATCH_BYTES_MAX and
                   len(batch) < COMMIT_TRANSACTION_BATCH_COUNT_MAX):
                if not queue.empty():
                    req = await queue.pop()
                    batch.append(req)
                    batch_bytes += req.transaction.expected_size()
                    continue
                remaining = deadline - now()
                if remaining <= 0:
                    break
                await delay(remaining)
            await self._commit_batch(batch)

    async def _commit_batch(self, batch: List[CommitTransactionRequest]
                            ) -> None:
        """One closed batch through commit_async(), then each repair
        batch it returns, each at a version of its own from the master
        (the reference spawns _commit_batch; here the batcher waits for
        it, so one batch of a proxy is in flight at a time).  A batch
        that fails marks the proxy broken, answers the unanswered
        requests commit_unknown_result (the reference's _commit_batch)
        and raises on."""
        t0 = perf_counter()
        self.metrics.counter("CommitBatches").add(1)
        self.metrics.counter("CommitBatchTxns").add(len(batch))
        pending = batch
        try:
            while pending:
                reqs = pending
                pending = await self.commit_async(reqs)
        except BaseException as e:  # noqa: BLE001 -- must answer everyone
            self.broken = True
            TraceEvent("CommitProxyBatchFailed", Severity.Error).detail(
                "Proxy", self.id).detail("Error", repr(e)).log()
            for req in reqs:
                if not req.reply.is_set():
                    req.reply.send_error(err("commit_unknown_result"))
            # A broken proxy dies visibly (reference :309-318): its
            # waitFailure breaks, so its master ends the epoch (a proxy
            # whose TLogs the next epoch locked would otherwise leave its
            # master serving a dead generation).
            if self._wait_failure_actor is not None and \
                    not self._wait_failure_actor.is_ready():
                self._wait_failure_actor.cancel()
            raise
        finally:
            self.batch_seconds += perf_counter() - t0

    # -- key server locations (reference :1488 doKeyServerLocationRequest,
    # _serve_locations :1305-1327) -------------------------------------------
    async def _serve_locations(self) -> None:
        async for req in self.interface.get_key_servers_locations.queue:
            results = []
            shards = list(self.key_servers.ranges())
            if req.reverse:
                shards.reverse()   # serve the LAST shards of the span first
            for b, e, tags in shards:
                # Full (unclipped) shard boundaries so the client's
                # location cache covers whole shards, not just the span.
                if e <= req.begin or b >= req.end:
                    continue
                ssis = [self.storage_interfaces[t] for t in (tags or [])
                        if t in self.storage_interfaces]
                results.append((KeyRange(b, e), ssis))
                if len(results) >= req.limit:
                    break
            req.reply.send(GetKeyServerLocationsReply(results=results))

    def run(self, process) -> list:
        """Register the interface's streams on `process` and spawn the
        batcher, the location service and the waitFailure holder there;
        their futures.  From here on the batcher's batches reach the
        master, the resolvers and the TLogs through their interfaces."""
        for stream in self.interface.streams():
            process.register(stream)
        self._wait_failure_actor = process.spawn(
            hold_wait_failure(self.interface.wait_failure),
            f"{self.id}.waitFailure")
        return [
            process.spawn(self._commit_batcher(), f"{self.id}.batcher"),
            process.spawn(self._serve_locations(), f"{self.id}.locations"),
            self._wait_failure_actor]

    def _refuse_unloggable(self, batch: List[CommitTransactionRequest]
                           ) -> None:
        """Raise, before a version is asked for, on a batch the write
        path cannot log: more than COMMIT_TRANSACTION_BATCH_COUNT_MAX
        transactions (a versionstamp numbers its transaction in 2
        bytes)."""
        if len(batch) > COMMIT_TRANSACTION_BATCH_COUNT_MAX:
            raise ValueError(
                f"proxy {self.id}: a batch of {len(batch)} transactions; "
                f"the most is {COMMIT_TRANSACTION_BATCH_COUNT_MAX}")

    def _reorder(self, batch: List[CommitTransactionRequest]
                 ) -> List[CommitTransactionRequest]:
        """Sched stage (b): intra-batch conflict-aware reorder, a host-side
        pre-pass placing readers before the writers that would abort them
        (sched/reorder.py).  Batch order is this proxy's choice; verdicts
        and replies follow the REORDERED index from here on."""
        order = reorder_batch([req.transaction for req in batch],
                              exact_max=REORDER_EXACT_MAX)
        moved = moved_count(order)
        self.metrics.counter("ReorderBatches").add(1)
        if moved:
            batch = [batch[i] for i in order]
            self.metrics.counter("ReorderSwaps").add(moved)
            test_coverage("ProxyBatchReordered")
        return batch

    def _send_replies(self, batch, verdicts, conflict_ranges,
                      commit_version: Version, batch_num: int,
                      repaired: set) -> None:
        """The reply fan-out (reference :510-580): every request not
        repaired, answered through its own reply, with the repair
        bookkeeping of requests that were themselves repairs."""
        counter = self.metrics.counter
        answered = [0, 0, 0]    # by verdict code
        for t_idx, (req, verdict) in enumerate(zip(batch, verdicts)):
            if t_idx in repaired:
                continue   # reply comes from the repair batch
            answered[int(verdict)] += 1
            if verdict == CommitResult.COMMITTED:
                if req.repair_attempt > 0:
                    # A server-side repair landed: the abort the client
                    # never saw became a commit one batch later.
                    counter("RepairSucceeded").add(1)
                    if self._repair_ladder is not None:
                        # The range proved repairable again: drop its
                        # backoff rungs so later repairs flow.
                        self._repair_ladder.note_success(
                            (r.begin, r.end) for r in
                            req.transaction.read_conflict_ranges)
                    test_coverage("ProxyTxnRepairCommitted")
                req.reply.send(CommitID(version=commit_version,
                                        txn_batch_id=batch_num,
                                        txn_batch_index=t_idx))
            elif verdict == CommitResult.TOO_OLD:
                req.reply.send_error(err("transaction_too_old"))
            else:
                if req.repair_attempt > 0:
                    # Repair budget spent and the re-resolve STILL
                    # conflicted: the abort goes back to the client like
                    # any other.
                    counter("RepairExhausted").add(1)
                e = err("not_committed")
                if t_idx in conflict_ranges:
                    # Rides the error reply to the client (reference
                    # SpecialKeySpace ConflictingKeysImpl).
                    e.details = conflict_ranges[t_idx]
                req.reply.send_error(e)
        for name, n in zip(("TxnConflicted", "TxnTooOld", "TxnCommitted"),
                           answered):
            counter(name).add(n)

    def _collect_repairs(self, batch, verdicts, conflict_ranges,
                         conflict_exact, commit_version: Version,
                         repaired: set) -> List[CommitTransactionRequest]:
        """Repair candidates of one resolved batch (sched stage c):
        CONFLICT verdicts that opted in, carry attempt budget, and whose
        EXACT culprit attribution lies entirely inside the declared read
        set (pure staleness, sched/repair.py).  Marks chosen indices in
        `repaired` and returns the re-stamped requests (original replies
        attached) for the follow-up batch."""
        max_attempts = int(server_knobs().TXN_REPAIR_MAX_ATTEMPTS)
        ladder = self._repair_ladder
        if ladder is None:
            ladder = self._repair_ladder = RepairLadder.default()
        out: List[CommitTransactionRequest] = []
        for t_idx, (req, verdict) in enumerate(zip(batch, verdicts)):
            if verdict != CommitResult.CONFLICT or not req.repair_eligible:
                continue
            attempt = req.repair_attempt
            culprits = conflict_ranges.get(t_idx) or []
            if attempt >= max_attempts and culprits:
                # The WHOLE attempt budget is spent and the re-resolve
                # still conflicted: back the culprit RANGE off so later
                # transactions blaming it skip their ladders.
                # Intermediate rungs do NOT back off.
                ladder.note_failure(culprits, commit_version)
            if not repair_eligible(
                    req.transaction, culprits,
                    conflict_exact.get(t_idx, False) and
                    t_idx in conflict_ranges, attempt, max_attempts):
                continue
            if attempt > 0 and \
                    not ladder.should_attempt(culprits, commit_version):
                # Ladder backoff gates CLIMBS only (rung 2+): the first
                # repair of any abort stays unconditional.
                self.metrics.counter("RepairBackedOff").add(1)
                test_coverage("ProxyRepairBackedOff")
                continue
            self.metrics.counter("RepairAttempted").add(1)
            test_coverage("ProxyTxnRepaired")
            repaired.add(t_idx)
            out.append(CommitTransactionRequest(
                transaction=dataclasses.replace(
                    req.transaction, read_snapshot=commit_version),
                debug_id=req.debug_id, repair_eligible=True,
                repair_attempt=attempt + 1, reply=req.reply))
        return out

    def scheduler_status(self) -> Dict[str, int]:
        """This proxy's slice of status cluster.scheduler (reorder and
        repair counters; the GRV proxies contribute the predictor
        side)."""
        c = self.metrics.counter
        return {
            "reorder_batches": c("ReorderBatches").value,
            "reorder_swaps": c("ReorderSwaps").value,
            "repairs_attempted": c("RepairAttempted").value,
            "repairs_succeeded": c("RepairSucceeded").value,
            "repairs_exhausted": c("RepairExhausted").value,
            "repairs_backed_off": c("RepairBackedOff").value,
        }

    # -- phases 2-3 of the batch pipeline ------------------------------------
    def resolve(self, batch: List[CommitTransactionRef],
                prev_version: Version, commit_version: Version,
                resolver_changes=()) -> ResolveTransactionBatchReply:
        """Resolve one batch across the resolvers: adopt the boundary
        moves handed over with the batch's version, send every resolver
        its request, and merge the replies.  Returns the merged reply:
        the verdicts in batch order, the committed foreign state
        transactions in (version, origin, seq) order, and the reporters'
        conflicting ranges with their exactness, by batch index."""
        if resolver_changes:
            self._apply_resolver_changes(resolver_changes)
        requests, index_maps = self._build_resolution_requests(
            batch, prev_version, commit_version)
        resolutions = []
        for role, req in zip(self.resolvers, requests):
            req.reply = Reply()
            role.resolve_batch(req)
            if not req.reply.sent:
                raise RuntimeError(
                    f"proxy {self.id}: resolver {role.id} holds batch "
                    f"{commit_version} until it has resolved "
                    f"{prev_version}: batches go in version-chain order")
            resolutions.append(req.reply.value)
        return self._merge_resolutions(batch, commit_version, index_maps,
                                       resolutions)

    async def _resolve_over_network(self, batch, prev_version: Version,
                                    commit_version: Version,
                                    resolver_changes=()
                                    ) -> ResolveTransactionBatchReply:
        """resolve() with each resolver's request sent to its interface
        (a request ahead of its predecessor waits at the role)."""
        if resolver_changes:
            self._apply_resolver_changes(resolver_changes)
        requests, index_maps = self._build_resolution_requests(
            batch, prev_version, commit_version)
        resolutions = await self._wait(wait_all([
            RequestStream.at(role.interface.resolve.endpoint).get_reply(req)
            for role, req in zip(self.resolvers, requests)]))
        return self._merge_resolutions(batch, commit_version, index_maps,
                                       resolutions)

    def _merge_resolutions(self, batch, commit_version: Version,
                           index_maps, resolutions
                           ) -> ResolveTransactionBatchReply:
        self.last_resolved_version = commit_version
        state = self._apply_foreign_state(resolutions)
        committed = self._determine_committed(batch, index_maps, resolutions)
        ranges, exact = self._merge_conflicts(index_maps, resolutions)
        return ResolveTransactionBatchReply(
            committed=committed, state_transactions=state,
            conflicting_ranges=ranges, attribution_exact=exact)

    # -- resolution request building (reference :88-181) ---------------------
    def _apply_resolver_changes(self, changes) -> None:
        """Adopt master-piggybacked resolver boundary moves exactly once,
        in change-version order (reference :1175-1182)."""
        for kr, idx, v in sorted(changes, key=lambda c: c[2]):
            if v <= self._resolver_changes_hwm:
                continue
            self._resolver_changes_hwm = v
            floor = v - int(
                server_knobs().MAX_WRITE_TRANSACTION_LIFE_VERSIONS)
            for b, e, hist in list(self.key_resolvers.intersecting(
                    kr.begin, kr.end)):
                # Prepend the new owner; trim history below the MVCC
                # window (the entry at/below the floor is the owner at
                # window start and must be kept).
                kept = [(v, idx)]
                for hv, hidx in tuple(hist or ()):
                    kept.append((hv, hidx))
                    if hv <= floor:
                        break
                self.key_resolvers.set_range(b, e, tuple(kept))
            TraceEvent("ProxyResolverChange").detail(
                "Proxy", self.id).detail("Begin", kr.begin).detail(
                "End", kr.end).detail("To", idx).detail("Version", v).log()

    def _eligible(self, hist, floor: Version) -> List[int]:
        """Resolvers owning any part of the MVCC window above `floor`:
        walk newest-first; the first entry at/below the floor is the owner
        at window start and terminates the walk.  A RESOLVER_ALL entry
        (the \\xff system range) expands to every resolver: system-key
        conflict ranges are checked by ALL resolvers against identical
        broadcast history."""
        out: List[int] = []
        for v, idx in hist:
            if idx == RESOLVER_ALL:
                for j in range(len(self.resolvers)):
                    if j not in out:
                        out.append(j)
            elif idx not in out:
                out.append(idx)
            if v <= floor:
                break
        return out

    def _build_resolution_requests(
            self, batch: List[CommitTransactionRef],
            prev_version: Version, commit_version: Version):
        """One request per resolver; each transaction's conflict ranges are
        clipped to the ranges that resolver owns.  Every resolver receives
        every batch (possibly with no transactions) to keep its version
        chain contiguous.  Returns (requests, index_maps): index_maps[i]
        lists the batch index of each transaction resolver i was sent.

        The reference's vectorised builder (PROXY_VECTORIZED_ASSEMBLY,
        :761-855), whose requests equal its plain one's (:689-759): the
        boundary arrays are bound once, each conflict range is walked
        exactly once with bisect, each history tuple's eligible resolvers
        are computed once a batch (the floor is batch-constant), and the
        fragments accrete straight into the request lists."""
        n = len(self.resolvers)
        requests = [ResolveTransactionBatchRequest(
            prev_version=prev_version, version=commit_version,
            last_received_version=self.last_resolved_version,
            transactions=[], proxy_id=self.id) for _ in range(n)]
        index_maps: List[List[int]] = [[] for _ in range(n)]
        floor = commit_version - int(
            server_knobs().MAX_WRITE_TRANSACTION_LIFE_VERSIONS)
        km = self.key_resolvers
        bounds = km._bounds
        values = km._values
        end_key = km.end_key
        nbounds = len(bounds)
        elig_cache: Dict[tuple, List[int]] = {}
        all_resolvers = list(range(n))
        sysb = SYSTEM_KEYS_BEGIN
        clear = MutationType.ClearRange
        for t_idx, txn in enumerate(batch):
            # Metadata-bearing ("state") transactions go to EVERY resolver
            # with their mutations attached: each resolver records them with
            # its local verdict and streams them to the other proxies
            # (reference Resolver.actor.cpp:220-249).
            is_state = any(
                m.param1 >= sysb or
                (m.type == clear and m.param2 > sysb)
                for m in txn.mutations)
            clipped_r: Dict[int, List[KeyRange]] = {}
            clipped_w: Dict[int, List[KeyRange]] = {}
            for ranges, sink in ((txn.read_conflict_ranges, clipped_r),
                                 (txn.write_conflict_ranges, clipped_w)):
                for r in ranges:
                    b, e = r.begin, r.end
                    if b >= e:
                        continue
                    i = bisect_right(bounds, b) - 1
                    while i < nbounds:
                        rb = bounds[i]
                        if rb >= e:
                            break
                        re_ = bounds[i + 1] if i + 1 < nbounds else end_key
                        cb = rb if rb > b else b
                        ce = re_ if re_ < e else e
                        if cb < ce:
                            hist = values[i]
                            elig = elig_cache.get(hist)
                            if elig is None:
                                elig = elig_cache[hist] = \
                                    self._eligible(hist, floor)
                            kr = KeyRange(cb, ce)
                            for idx in elig:
                                lst = sink.get(idx)
                                if lst is None:
                                    lst = sink[idx] = []
                                lst.append(kr)
                        i += 1
            if is_state:
                touched: Any = all_resolvers
            else:
                touched = set(clipped_r)
                touched.update(clipped_w)
                # Read-only/no-range txns: resolver 0 decides.
                touched = sorted(touched) if touched else (0,)
            for idx in touched:
                reqs_idx = requests[idx]
                clipped = CommitTransactionRef(
                    read_conflict_ranges=clipped_r.get(idx, []),
                    write_conflict_ranges=clipped_w.get(idx, []),
                    mutations=list(txn.mutations) if is_state else [],
                    read_snapshot=txn.read_snapshot,
                    report_conflicting_keys=txn.report_conflicting_keys,
                    # Tenant/tag identity rides the clipped fragment for
                    # the resolver's conflict-heat tracker.
                    tenant_id=txn.tenant_id, tag=txn.tag)
                if is_state:
                    reqs_idx.txn_state_transactions.append(
                        len(reqs_idx.transactions))
                reqs_idx.transactions.append(clipped)
                index_maps[idx].append(t_idx)
        return requests, index_maps

    # -- merging the replies (reference :954-980, :1058-1070, :430-450) ------
    def _apply_foreign_state(self, resolutions) -> List[tuple]:
        """Other proxies' state transactions as this proxy learns them
        (reference applyMetadataEffect :737): every resolver reports each
        one with its LOCAL verdict; the global verdict is the AND (min)
        across resolvers.  Entries are taken in (version, origin, seq)
        order exactly once -- a high-water mark guards against
        re-delivery from batches whose last_received_version lagged --
        and a committed one's mutations are applied to this proxy's shard
        map.  Returns the committed ones, (version, origin, seq,
        mutations, verdict), in that order."""
        merged: Dict[Tuple[Version, str, int], List] = {}
        for reply in resolutions:
            for version, origin, seq, mutations, verdict in \
                    reply.state_transactions:
                key = (version, origin, seq)
                cur = merged.get(key)
                if cur is None:
                    merged[key] = [mutations, verdict]
                else:
                    cur[1] = min(cur[1], verdict)
        out = []
        for key in sorted(merged):
            if key <= self._state_hwm or key[1] == self.id:
                continue
            self._state_hwm = key
            mutations, verdict = merged[key]
            if verdict == CommitResult.COMMITTED:
                for m in mutations:
                    self._apply_metadata(m)
                out.append((*key, mutations, verdict))
        return out

    def _apply_metadata(self, m: Mutation) -> bool:
        """One committed system mutation's effect on this proxy: the shard
        map's, the server registry's on its storage directory (a retired
        tag leaves it; a new incarnation replaces the interface held, the
        same one is kept), and a configuration change's nudge to the
        master (reference :893-906).  True if the mutation is metadata
        the next recovery replays from TXS_TAG."""
        handled = apply_key_servers_mutation(self.key_servers, m)
        cf = parse_conf_mutation(m)
        if cf is not None:
            # The fields and their values, so that the master can tell a
            # retried, identical configure (after commit_unknown_result
            # across the recovery it caused) from a change.
            try:
                RequestStream.at(self.master.interface.config_changed
                                 .endpoint).send(dict(cf))
            except Exception:  # noqa: BLE001 -- no master to tell (a
                pass           # StaticCluster's): recovery reads the conf
            handled = True
        st = parse_server_tag_mutation(m)
        if st is not None:
            for tag, iface in st:
                if iface is None:
                    self.storage_interfaces.pop(tag, None)
                elif not same_incarnation(self.storage_interfaces.get(tag),
                                          iface):
                    self.storage_interfaces[tag] = iface
            handled = True
        return handled

    def _determine_committed(self, batch, index_maps, resolutions
                             ) -> List[CommitResult]:
        """Verdict = min over the resolvers that saw the transaction
        (commit iff ALL resolvers said committed; CONFLICT=0 < TOO_OLD=1,
        so under min() CONFLICT dominates TOO_OLD)."""
        verdicts = [CommitResult.COMMITTED] * len(batch)
        for r_idx, reply in enumerate(resolutions):
            for local_i, verdict in enumerate(reply.committed):
                t_idx = index_maps[r_idx][local_i]
                verdicts[t_idx] = min(verdicts[t_idx], verdict)
        return verdicts

    @staticmethod
    def _merge_conflicts(index_maps, resolutions
                         ) -> Tuple[Dict[int, list], Dict[int, bool]]:
        """Each reporter's conflicting read ranges, the union across the
        resolvers that judged it, and its attribution exactness: exact
        only if EVERY resolver that aborted it pinned true culprits (one
        conservative vote over-blames the union).  By batch index."""
        conflict_ranges: Dict[int, list] = {}
        conflict_exact: Dict[int, bool] = {}
        for r_idx, reply in enumerate(resolutions):
            imap = index_maps[r_idx]
            for local_i, ranges in reply.conflicting_ranges.items():
                if local_i < len(imap):
                    conflict_ranges.setdefault(imap[local_i],
                                               []).extend(ranges)
        for r_idx, reply in enumerate(resolutions):
            imap = index_maps[r_idx]
            for local_i, exact in reply.attribution_exact.items():
                if local_i < len(imap):
                    t_idx = imap[local_i]
                    conflict_exact[t_idx] = \
                        conflict_exact.get(t_idx, True) and bool(exact)
        return conflict_ranges, conflict_exact

    # -- mutation -> tag routing (reference :891-1034) -----------------------
    def tags_for_key(self, key: bytes) -> List[Tag]:
        return self.key_servers.lookup(key) or []

    def _assign_mutations_to_tags(
            self, batch: List[CommitTransactionRequest],
            verdicts: List[CommitResult], commit_version: Version
    ) -> Dict[Tag, List[Mutation]]:
        """The committed transactions' mutations, by the tag of each
        storage server that holds their keys, in batch order.  The
        reference's vectorised assignment (PROXY_VECTORIZED_ASSEMBLY,
        :1198), whose messages equal its plain one's (:1111): one pass
        over the shard map's boundary arrays with bisect point lookups.
        A versionstamped mutation becomes a SetValue with the 10-byte
        stamp (commit version, the transaction's index in the batch as
        resolved) spliced in; a clear is clipped to each shard it spans;
        a \xff/keyServers/ mutation moves this proxy's shard map before
        any later mutation is routed, and also rides TXS_TAG, and is then
        routed to storage like any key; before the map moves, each tag
        the change drops from a span's team gets the disownment fence of
        that span (system_data.DISOWN_SHARD_PREFIX), so the server closes
        the span at this version even if no other message reaches it."""
        messages: Dict[Tag, List[Mutation]] = {}
        ks = self.key_servers
        bounds = ks._bounds
        values = ks._values
        sysb = SYSTEM_KEYS_BEGIN
        set_vsk = MutationType.SetVersionstampedKey
        set_vsv = MutationType.SetVersionstampedValue
        set_val = MutationType.SetValue
        clear = MutationType.ClearRange
        for t_idx, (req, verdict) in enumerate(zip(batch, verdicts)):
            if verdict != CommitResult.COMMITTED:
                continue
            stamp = None   # built lazily per transaction
            for m in req.transaction.mutations:
                mt = m.type
                if mt is set_vsk or mt is set_vsv:
                    if stamp is None:
                        stamp = make_versionstamp(commit_version, t_idx)
                    if mt is set_vsk:
                        m = Mutation(set_val,
                                     _splice_stamp(m.param1, stamp),
                                     m.param2)
                    else:
                        m = Mutation(set_val, m.param1,
                                     _splice_stamp(m.param2, stamp))
                    mt = set_val
                p1 = m.param1
                if p1 >= sysb or (mt is clear and m.param2 > sysb):
                    # Metadata side effects first (ApplyMetadataMutation
                    # .cpp:52-61), the fences of the tags a team loses
                    # before them; the shard map may change under us, so
                    # the boundary arrays are bound again.
                    for dtag, db_, de_ in disowned_spans(
                            self.key_servers, m):
                        messages.setdefault(dtag, []).append(Mutation(
                            set_val, DISOWN_SHARD_PREFIX + db_, de_))
                    if self._apply_metadata(m):
                        messages.setdefault(TXS_TAG, []).append(m)
                    ks = self.key_servers
                    bounds = ks._bounds
                    values = ks._values
                if mt is clear:
                    # A clear can span shards: clip per intersecting shard
                    # so each storage team gets only its part (:980-1010).
                    p2 = m.param2
                    i = bisect_right(bounds, p1) - 1
                    nb = len(bounds)
                    while i < len(values):
                        rb = bounds[i]
                        if rb >= p2:
                            break
                        re_ = bounds[i + 1] if i + 1 < nb else ks.end_key
                        tags = values[i]
                        if tags:
                            cb = rb if rb > p1 else p1
                            ce = re_ if re_ < p2 else p2
                            clipped = Mutation(clear, cb, ce)
                            for tag in tags:
                                lst = messages.get(tag)
                                if lst is None:
                                    lst = messages[tag] = []
                                lst.append(clipped)
                        i += 1
                else:
                    tags = values[bisect_right(bounds, p1) - 1]
                    if tags:
                        for tag in tags:
                            lst = messages.get(tag)
                            if lst is None:
                                lst = messages[tag] = []
                            lst.append(m)
        return messages
