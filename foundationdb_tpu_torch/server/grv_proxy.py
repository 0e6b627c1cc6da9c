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

Left out on purpose: the request batching and the priority queues, the
ratekeeper's tps and batch-tps budgets and their token buckets, tag
throttles, the confirm's timeout (a TLog answers within the call or not
at all), the core/coverage.py test_coverage call, which belongs to the
simulator, and the RPC.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Optional

from ..core.histogram import CounterCollection
from ..core.knobs import server_knobs
from ..sched.predictor import ConflictPredictor
from ..txn.types import Version
from .interfaces import (CommitTransactionRequest,
                         GetRawCommittedVersionRequest, GetReadVersionReply,
                         TLogConfirmRunningRequest, ask)

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

    def get_read_version(self) -> GetReadVersionReply:
        """A read version (reference _reply_batch :307): every TLog
        confirms it is running -- a stopped one does not answer, and that
        raises broken_promise -- then the master's live committed
        version, which covers every commit a client has heard of."""
        for tlog in self.tlogs:
            ask(tlog.confirm_running, TLogConfirmRunningRequest())
        vreply = ask(self.master.serve_live_committed,
                     GetRawCommittedVersionRequest())
        return GetReadVersionReply(version=vreply.version)

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
