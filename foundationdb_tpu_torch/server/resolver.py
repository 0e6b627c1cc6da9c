"""Resolver: OCC conflict detection for its key-range partition.

The port of foundationdb_tpu/server/resolver.py.  Reference:
fdbserver/Resolver.actor.cpp resolveBatch (:104) -- batches are totally
ordered per resolver by prevVersion -> version chaining (:141-151); each
batch runs through the ConflictSet; duplicate requests (proxy resends)
are answered from a per-proxy reply cache (ProxyRequestsInfo :37,
outstandingBatches :175).  The set comes from the port's
new_conflict_set: by default the supervised torch set on `cuda`; the
caller names `device="cpu"` to run it on the CPU.

The port has no reactor, so the role is driven by calls, not actors:
resolve_batch(req) and the serve_* methods each take one request and
answer it through `req.reply.send(...)`, as the reference's actor bodies
do.  resolve_batch is the reference's _resolve_batch statement for
statement, except for the chain wait: a request whose prev_version is
ahead of the role's version is parked (a continuation in the version's
(threshold, seq) heap); each version.set wakes the parked requests now
due, and they run in heap order after the current reply has been sent,
never recursively -- the reference's reply order.  A superseded resend
gets no reply.

Two deliberate exceptions to the reference's body:
  * the `offload_blocking` branch (:117-125), which runs a synchronous
    native engine on the thread pool, is not ported: the port has no
    such engine;
  * the `resolver.slowBatch` BUGGIFY delay (:78-80) is a sleep on the
    reactor, which the port does not have: its host draws the site and
    sleeps before handing the request over, and passes the time the
    request arrived as resolve_batch's `t_in`, so that QueueWait holds
    the sleep as the reference's does.

Left out: run(process) and hold_wait_failure, the RPC wiring that
registers the streams and spawns the serving loops; a host calls
resolve_batch, serve_metrics, serve_split, serve_heat and emit_heat_once
itself, and runs `metrics.emit_loop()` (and the set's) if it has a loop.
"""

from __future__ import annotations

from collections import deque
from itertools import chain
from typing import Deque, Dict, List, Optional, Tuple

from ..conflict.api import ConflictSet, new_conflict_set
from ..conflict.heat import ConflictHeatTracker
from ..core.histogram import CounterCollection
from ..core.knobs import server_knobs
from ..core.scheduler import now
from ..core.trace import TraceEvent, trace_batch_event
from ..txn.types import CommitResult, Version
from .interfaces import (ResolveTransactionBatchReply,
                         ResolveTransactionBatchRequest)
from .notified import NotifiedVersion


class _ProxyInfo:
    """Per-proxy dedup state (reference ProxyRequestsInfo)."""

    __slots__ = ("last_version", "last_received_version", "outstanding")

    def __init__(self) -> None:
        self.last_version: Version = -1
        self.last_received_version: Version = -1
        # version -> cached reply for resends of still-unacked batches.
        self.outstanding: Dict[Version, ResolveTransactionBatchReply] = {}


class Resolver:
    SAMPLE_EVERY = 8

    def __init__(self, resolver_id: str = "r0",
                 recovery_version: Version = 0,
                 backend: Optional[str] = None,
                 proxy_ids: Optional[List[str]] = None,
                 **backend_kwargs) -> None:
        self.id = resolver_id
        self.version = NotifiedVersion(recovery_version)
        self.conflict_set: ConflictSet = new_conflict_set(
            backend, oldest_version=recovery_version, **backend_kwargs)
        self.proxy_infos: Dict[str, _ProxyInfo] = {}
        for pid in proxy_ids or []:
            info = _ProxyInfo()
            info.last_received_version = recovery_version
            self.proxy_infos[pid] = info
        self.total_state_bytes = 0
        self.resolved_batches = 0
        self.metrics = CounterCollection("Resolver", resolver_id)
        # The unified heat / load sample table (conflict/heat.py): the
        # load column keeps the resolutionBalancing sampling (reference
        # Resolver.actor.cpp:191-198), the conflict column the decayed
        # hot conflict ranges with tenant / tag breakdowns.
        self._ranges_since_poll = 0
        self._metrics_polls = 0
        self.heat = ConflictHeatTracker(
            sample_every=self.SAMPLE_EVERY,
            table_max=int(server_knobs().CONFLICT_HEAT_TABLE_MAX))
        # Accumulated state transactions for cross-proxy metadata
        # broadcast (reference :220-249): (version, origin_proxy, seq,
        # mutations, local_verdict), version-ascending; trimmed once every
        # registered proxy's last_received_version has passed.
        self.state_txns: List[tuple] = []
        # Requests woken from the chain wait, run in order once the
        # request in hand has replied.
        self._ready: Deque[Tuple[ResolveTransactionBatchRequest, float]] = \
            deque()
        self._running = False
        ev = TraceEvent("ResolverStarted").detail("Id", self.id).detail(
            "Backend", type(self.conflict_set).__name__)
        inner = getattr(self.conflict_set, "device", None)
        if inner is not None:
            ev.detail("Device", type(inner).__name__)
        ev.log()

    # -- resolveBatch ---------------------------------------------------------
    def resolve_batch(self, req: ResolveTransactionBatchRequest,
                      t_in: Optional[float] = None) -> None:
        """Resolve `req` and answer it through req.reply, or park it until
        the version reaches req.prev_version; then run every request that
        became due, in order.  `t_in` is the request's arrival time, for
        a host that held it before handing it over (the slowBatch delay);
        by default, now.

        A request that raises (its reply's send, say) does not stop the
        others: as the reference's actors each fail alone, every request
        that became due still runs, and the first error is raised after
        the last of them."""
        if t_in is None:
            t_in = now()
        self.proxy_infos.setdefault(req.proxy_id, _ProxyInfo())
        # Order by version chain: wait for our version to catch up to the
        # batch's prev_version (reference :141-151).
        self.version.when_at_least(
            req.prev_version,
            lambda _v, req=req, t_in=t_in: self._ready.append((req, t_in)))
        if self._running:
            return
        self._running = True
        error = None
        try:
            while self._ready:
                try:
                    self._resolve_one(*self._ready.popleft())
                except Exception as e:  # noqa: BLE001 - raised below
                    error = error or e
        finally:
            self._running = False
        if error is not None:
            raise error

    def parked(self) -> int:
        """Requests waiting for their predecessor."""
        return self.version.waiting()

    def drop_parked(self) -> int:
        """Forget every parked request unanswered, as the reference's
        cancelled actors drop theirs (its host is going away); returns
        how many there were."""
        self._ready.clear()
        return self.version.drop_waiters()

    def _resolve_one(self, req: ResolveTransactionBatchRequest,
                     t_in: float) -> None:
        proxy = self.proxy_infos[req.proxy_id]
        # Queue band: arrival -> eligible to run (the version-chain wait
        # IS this resolver's queue; reference queueWaitLatencyDist).
        self.metrics.histogram("QueueWait").record(now() - t_in)

        if req.version <= proxy.last_version:
            # Duplicate (resend): answer from cache; a superseded request
            # is dropped unanswered.
            cached = proxy.outstanding.get(req.version)
            if cached is not None:
                req.reply.send(cached)
            return

        assert self.version.get() == req.prev_version, (
            f"resolver {self.id}: version chain broken "
            f"{self.version.get()} != {req.prev_version}")

        if req.span:
            trace_batch_event("CommitDebug", req.span,
                              f"Resolver.{self.id}.resolveBatch")

        knobs = server_knobs()
        new_oldest = max(self.conflict_set.oldest_version,
                         req.version -
                         int(knobs.MAX_WRITE_TRANSACTION_LIFE_VERSIONS))
        _t0 = now()
        cs = self.conflict_set
        committed, conflicting = cs.resolve_with_conflicts(
            req.transactions, req.version, new_oldest_version=new_oldest)
        self.metrics.histogram("Resolve").record(now() - _t0)
        if req.span:
            trace_batch_event("CommitDebug", req.span,
                              f"Resolver.{self.id}.afterResolve")
        self.metrics.counter("TxnResolved").add(len(req.transactions))
        n_conflicts = sum(1 for c in committed
                          if c == CommitResult.CONFLICT)
        self.metrics.counter("TxnConflicts").add(n_conflicts)
        if getattr(cs, "degraded", False):
            # Supervised device backend running on its CPU mirror: correct
            # but slow; visible to status consumers.
            self.metrics.counter("TxnResolvedDegraded").add(
                len(req.transactions))
        self._sample_batch(req.transactions)
        self._record_conflict_heat(req.transactions, committed, cs,
                                   n_conflicts)
        # Per-txn attribution exactness for aborted txns: True iff the
        # backend pinned the true culprit range rather than blaming the
        # whole read set.
        exact_map = getattr(cs, "last_attribution_exact", None) or {}
        attribution_exact = {
            i: bool(exact_map.get(i, False))
            for i, v in enumerate(committed) if v == CommitResult.CONFLICT}
        # Foreign state txns resolved since this proxy last heard from us
        # (strictly before this batch's version; ours are appended below).
        lrv = req.last_received_version
        reply = ResolveTransactionBatchReply(
            committed=committed,
            conflicting_ranges=conflicting,
            attribution_exact=attribution_exact,
            state_transactions=[e for e in self.state_txns
                                if e[0] > lrv and e[1] != req.proxy_id])
        self.resolved_batches += 1

        # Record this batch's state transactions with OUR local verdict.
        for seq, t_idx in enumerate(req.txn_state_transactions):
            entry = (req.version, req.proxy_id, seq,
                     req.transactions[t_idx].mutations, committed[t_idx])
            self.state_txns.append(entry)
            self.total_state_bytes += sum(
                m.expected_size() for m in entry[3])

        # Cache for resend dedup; trim acknowledged batches (reference
        # :175 outstandingBatches, trimmed by lastReceivedVersion).
        proxy.last_version = req.version
        proxy.last_received_version = max(proxy.last_received_version,
                                          req.last_received_version)
        proxy.outstanding[req.version] = reply
        for v in [v for v in proxy.outstanding
                  if v < proxy.last_received_version]:
            del proxy.outstanding[v]
        # Trim state txns every live proxy has received (memory bound;
        # reference RESOLVER_STATE_MEMORY_LIMIT backpressure :126-135).
        min_lrv = min(p.last_received_version
                      for p in self.proxy_infos.values())
        if self.state_txns and self.state_txns[0][0] <= min_lrv:
            kept = [e for e in self.state_txns if e[0] > min_lrv]
            self.total_state_bytes -= sum(
                sum(m.expected_size() for m in e[3])
                for e in self.state_txns[:len(self.state_txns) - len(kept)])
            self.state_txns = kept

        # Advance the chain BEFORE the reply is sent; the requests it
        # wakes run after this one has replied.
        self.version.set(req.version)
        req.reply.send(reply)

    def _sample_batch(self, transactions) -> None:
        heat = self.heat
        n = 0
        for txn in transactions:
            for r in chain(txn.read_conflict_ranges,
                           txn.write_conflict_ranges):
                n += 1
                heat.sample_load(r.begin, r.end)
        self._ranges_since_poll += n

    def _record_conflict_heat(self, transactions, committed,
                              conflict_set, n_conflicts: int) -> None:
        """Per-range heat attribution for the batch's aborted txns: the
        conflict set's last_attribution names the culprit range(s) (exact
        for the oracle; for a knob-bounded sample on the supervised device
        path, the unsampled rest skipped and counted by
        HeatConservativeTxns).  Tenant / tag identity rides the
        transaction."""
        if not n_conflicts or not server_knobs().HEAT_TELEMETRY_ENABLED:
            return
        attr = getattr(conflict_set, "last_attribution", None) or {}
        exact = getattr(conflict_set, "last_attribution_exact", None) or {}
        heat = self.heat
        recorded = 0
        inexact = n_conflicts - len(attr)   # skipped entirely
        for i, ranges in attr.items():
            txn = transactions[i]
            tenant = getattr(txn, "tenant_id", -1)
            tag = getattr(txn, "tag", "")
            for b, e in ranges:
                heat.record_conflict(b, e, tenant_id=tenant, tag=tag)
                recorded += 1
            if not exact.get(i, False):
                inexact += 1                # recorded, but whole read set
        if recorded:
            self.metrics.counter("HeatConflictRanges").add(recorded)
        if inexact > 0:
            self.metrics.counter("HeatConservativeTxns").add(inexact)

    # -- the served requests --------------------------------------------------
    def serve_metrics(self, req) -> None:
        """ResolutionMetricsRequest: the conflict ranges seen since the
        last poll; every 8th poll decays the load samples so splits track
        recent load."""
        n, self._ranges_since_poll = self._ranges_since_poll, 0
        self._metrics_polls += 1
        if self._metrics_polls % 8 == 0:
            self.heat.decay()
        req.reply.send(n)

    def serve_split(self, req) -> None:
        """ResolutionSplitRequest: a key splitting [begin, end)'s sampled
        load at `fraction`, from the load column projected onto
        range-begin keys; None when nothing was sampled there."""
        inside = self.heat.split_load(req.begin, req.end)
        total = sum(v for _k, v in inside)
        split_key = None
        if total > 0:
            acc = 0
            for k, v in inside:
                acc += v
                # Walk past the fraction point to the first VALID split
                # key: a head-heavy range whose first key holds the mass
                # must still split (at the next sample).
                if acc >= total * req.fraction and \
                        req.begin < k < req.end:
                    split_key = k
                    break
        req.reply.send(split_key)

    def serve_heat(self, req) -> None:
        """ResolverHeatRequest: top-k decayed conflict ranges with their
        tag / tenant attribution; empty while heat telemetry is off."""
        if not server_knobs().HEAT_TELEMETRY_ENABLED:
            req.reply.send([])
            return
        req.reply.send(self.heat.feed_rows(max(1, int(req.top_k))))

    def emit_heat_once(self) -> None:
        """One tick of the reference's _emit_heat: a HotConflictRange
        trace event for each of the top-K decayed conflict ranges; nothing
        while heat telemetry is off or nothing conflicted."""
        knobs = server_knobs()
        if not knobs.HEAT_TELEMETRY_ENABLED:
            return
        for b, e, conflicts, load in self.heat.top_conflicts(
                int(knobs.CONFLICT_HEAT_TOP_K)):
            TraceEvent("HotConflictRange").detail(
                "Id", self.id).detail("Begin", b).detail(
                "End", e).detail("Conflicts", conflicts).detail(
                "Load", load).log()

    def heat_status(self) -> dict:
        """This resolver's slice of the cluster's heat status."""
        return self.heat.to_status(
            int(server_knobs().CONFLICT_HEAT_TOP_K))

    def backend_status(self) -> dict:
        """Supervision state of the conflict backend (degraded / tripped /
        fallback counters); {} for unsupervised backends."""
        status = getattr(self.conflict_set, "status", None)
        return status() if callable(status) else {}
