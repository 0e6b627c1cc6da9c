"""The GRV proxy: read versions and the predictor admission (trimmed copy
of foundationdb_tpu/server/grv_proxy.py).

A read version is the master's live committed version, after every TLog
of the log system has confirmed it is running (_reply_batch :307, the
reference's getLiveCommittedVersion): get_read_version().

What is kept of the reference's GrvProxy: the conflict predictor
(sched/predictor.py, one table a proxy, :44-53), the deferral of a
request whose declared tag or tenant maps to a predicted-doomed range
(sched_blocked, :110-133) with its SchedDeferrals counter and its
SCHED_MAX_DEFERRALS starvation bound, the re-admission of deferred
requests at the front of the queue, in order (:235-245), the fold of the
ratekeeper's heat rows into the predictor (:276-282), and
scheduler_status.

One change of form: the port's plane is synchronous and has no clock, so
a deferred request waits one admission round (the caller's batch
cadence: the next admit() call) instead of SCHED_ADMISSION_DELAY_S of
simulated time.  The request is the commit itself, whose transaction
declares its tag and tenant; it takes its read version at admission: a
request admitted after a deferral is re-stamped at the round's read
version (bench.py's model of the stage, :875-905), and one admitted at
once keeps the snapshot it came with.

On a simulated or real process (run(process)), the request queue and the
starter serve the proxy's interface, beside its waitFailure holder:
_queue_requests (:67) files each
GetReadVersionRequest into its priority's queue, and
_transaction_starter (:177) wakes on an arrival, waits
START_TRANSACTION_BATCH_INTERVAL_MIN, releases every queued request,
immediate first, then default, then batch, and answers them with one
read version (_reply_batch :307: the TLogs' confirmations and the
master's live committed version asked over the network), counting
TxnStarted by each request's transaction_count.

Left out on purpose: the ratekeeper's tps and batch-tps budgets and
their token buckets (every queued request is released), tag throttles,
the predictor's deferral at GRV (the port defers at admit()), the
confirm's timeout (a TLog that does not answer fails the batch's
replies with its error) and the latency histograms.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Optional

from ..core.coverage import test_coverage
from ..core.error import FdbError, err
from ..core.futures import Promise, wait_all
from ..core.histogram import CounterCollection
from ..core.knobs import server_knobs
from ..core.scheduler import delay
from ..sched.predictor import ConflictPredictor
from ..txn.types import Version
from .interfaces import (CommitTransactionRequest,
                         GetRawCommittedVersionRequest, GetReadVersionReply,
                         GetReadVersionRequest, GrvProxyInterface,
                         TLogConfirmRunningRequest, TransactionPriority, call,
                         run_within_call)
from .failure import hold_wait_failure

# The starvation bound (the reference's SCHED_MAX_DEFERRALS default): a
# request is deferred at most this many rounds, then admitted.
SCHED_MAX_DEFERRALS = 3


class GrvProxy:
    def __init__(self, proxy_id: str, master: Any = None,
                 tlogs: Optional[List[Any]] = None) -> None:
        """`master` (server/master.py Master) and `tlogs`: what a read
        version is asked of (get_read_version)."""
        self.id = proxy_id
        self.master = master
        self.tlogs = list(tlogs or [])
        # Conflict predictor: per-proxy hot-range abort-probability table
        # fed from the ratekeeper's heat poll.  Inert while
        # SCHED_PREDICTOR_ENABLED is off: no deferrals.
        self.predictor = ConflictPredictor.default()
        self._sched_deferred: List[CommitTransactionRequest] = []
        self.metrics = CounterCollection("GrvProxy", proxy_id)
        # The event-loop half (run()): priority queues, immediate >
        # default > batch (reference SystemTransactionQueue / DefaultQueue
        # / BatchQueue), and the starter's wakeup.
        self.interface = GrvProxyInterface(proxy_id)
        self.interface.role = self   # in-process backref (not on the wire)
        self.queues: List[List[GetReadVersionRequest]] = [[], [], []]
        self.stats = {"grvs": 0, "batches": 0}
        self._wakeup: Optional[Promise] = None

    def get_read_version(self) -> GetReadVersionReply:
        """A read version (reference _reply_batch :307): every TLog
        confirms it is running -- a stopped one does not answer, and that
        raises broken_promise -- then the master's live committed
        version, which covers every commit a client has heard of."""
        return run_within_call(self._read_version(False))

    async def _read_version(self, net: bool) -> GetReadVersionReply:
        """get_read_version()'s body; `net` asks the TLogs and the master
        through their interfaces."""
        await wait_all([call(tlog, "confirm_running", "confirm_running",
                             TLogConfirmRunningRequest(), net)
                        for tlog in self.tlogs])
        vreply = await call(self.master, "serve_live_committed",
                            "get_live_committed_version",
                            GetRawCommittedVersionRequest(), net)
        return GetReadVersionReply(version=vreply.version)

    async def _queue_requests(self) -> None:
        try:
            async for req in \
                    self.interface.get_consistent_read_version.queue:
                pri = min(max(req.priority, TransactionPriority.BATCH),
                          TransactionPriority.IMMEDIATE)
                self.queues[pri].append(req)
                if self._wakeup is not None:
                    w, self._wakeup = self._wakeup, None
                    w.send(None)
        finally:
            # The process is gone: the queued requests' replies break.
            for q in self.queues:
                for req in q:
                    req.reply.send_error(err("broken_promise"))
                q.clear()

    async def _transaction_starter(self) -> None:
        interval = server_knobs().START_TRANSACTION_BATCH_INTERVAL_MIN
        while True:
            if not any(self.queues):
                # Sleep until a request arrives (no virtual-time polling).
                self._wakeup = Promise()
                await self._wakeup.get_future()
            await delay(interval)
            batch = []
            for pri in (TransactionPriority.IMMEDIATE,
                        TransactionPriority.DEFAULT,
                        TransactionPriority.BATCH):
                batch += self.queues[pri]
                self.queues[pri] = []
            if batch:
                self.stats["batches"] += 1
                await self._reply_batch(batch)

    async def _reply_batch(self, batch: List[GetReadVersionRequest]) -> None:
        """One read version for every request of the batch, TxnStarted
        charged each request's transaction_count (a client's batched
        request carries N).  A read version that cannot be had (a TLog
        or the master gone) answers every request with its error."""
        try:
            reply = await self._read_version(True)
        except FdbError as e:
            for req in batch:
                req.reply.send_error(e)
            return
        n_txns = 0
        n_batched = 0
        for req in batch:
            c = max(1, int(getattr(req, "transaction_count", 1) or 1))
            n_txns += c
            if c > 1:
                n_batched += 1
        self.stats["grvs"] += n_txns
        self.metrics.counter("TxnStarted").add(n_txns)
        if n_batched:
            self.metrics.counter("ClientBatchedGrvRequests").add(n_batched)
        for req in batch:
            req.reply.send(GetReadVersionReply(version=reply.version))

    def run(self, process) -> list:
        """Register the interface's streams on `process` and spawn the
        queue, the starter and the waitFailure holder there; their
        futures."""
        for stream in self.interface.streams():
            process.register(stream)
        return [
            process.spawn(self._queue_requests(), f"{self.id}.queue"),
            process.spawn(self._transaction_starter(), f"{self.id}.starter"),
            process.spawn(hold_wait_failure(self.interface.wait_failure),
                          f"{self.id}.waitFailure")]

    def admit(self, requests: Iterable[CommitTransactionRequest],
              read_version: Version) -> List[CommitTransactionRequest]:
        """One admission round: the requests deferred in the last round
        first, in their order, then `requests`.  Returns the admitted
        ones; a predicted-doomed request is held for the next round
        instead, at most SCHED_MAX_DEFERRALS times."""
        arrivals = self._sched_deferred + list(requests)
        self._sched_deferred = []
        admitted: List[CommitTransactionRequest] = []
        for req in arrivals:
            if self._sched_blocked(req):
                continue
            if getattr(req, "_sched_defers", 0):
                # A deferred request acquires its read version at
                # ADMISSION (the whole point of the wait).
                req.transaction = dataclasses.replace(
                    req.transaction, read_snapshot=read_version)
            admitted.append(req)
        return admitted

    def _sched_blocked(self, req: CommitTransactionRequest) -> bool:
        """Predictor deferral (sched stage a): a request whose declared
        tag/tenant maps to a predicted-doomed range waits a round in a
        side queue instead of burning a near-certain resolve-and-abort
        round trip.  At most SCHED_MAX_DEFERRALS deferrals per request --
        then it is admitted unconditionally (starvation-proof)."""
        if not server_knobs().SCHED_PREDICTOR_ENABLED:
            return False
        defers = getattr(req, "_sched_defers", 0)
        if defers >= SCHED_MAX_DEFERRALS:
            return False
        txn = req.transaction
        if not self.predictor.is_doomed((txn.tag,) if txn.tag else (),
                                        txn.tenant_id):
            return False
        req._sched_defers = defers + 1
        self._sched_deferred.append(req)
        self.metrics.counter("SchedDeferrals").add(1)
        test_coverage("GrvSchedDeferral")
        return True

    def fold_conflict_heat(self, rows) -> None:
        """Fold the ratekeeper's heat rows into the predictor table; the
        reference's rate-info reply carries no rows (None) when the fold
        is empty, and then the table is left as it is."""
        if rows:
            self.predictor.update(rows)

    def scheduler_status(self) -> dict:
        """This proxy's slice of status cluster.scheduler: predictor
        table, deferral counter and the requests held for the next
        round."""
        doc = self.predictor.status()
        doc["deferrals"] = self.metrics.counter("SchedDeferrals").value
        doc["deferred_held"] = len(self._sched_deferred)
        return doc
