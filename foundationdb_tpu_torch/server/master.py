"""Resolver boundaries and resolution balancing (trimmed copy of the
resolution-plane part of foundationdb_tpu/server/master.py).

Reference: fdbserver/masterserver.actor.cpp resolutionBalancing (:1318)
with the resolver's metrics and split endpoints
(Resolver.actor.cpp:341-348), and the resolver_changes the master
piggybacks on its version replies (:1175-1182).  Here: the epoch's
keyResolvers assignment as recruitment seeds it (seed_resolver_boundaries,
_valid_resolver_ranges, _key_resolver_ranges), and ResolutionBalancer,
whose step() is one pass of resolution_balancing's loop body and which
keeps the master's record of the moves (resolution_changes, handed to a
proxy with its next version and dropped once every expected proxy has
seen them, as _allocate_version does).

Master (:57-170) hands out commit versions: VERSIONS_PER_SECOND a second
of the clock's time (at least 1, at most
MAX_READ_TRANSACTION_LIFE_VERSIONS / 2 a request, at most
MAX_VERSIONS_IN_FLIGHT past the live committed version), each proxy's
requests answered in request_num order with a resend answered from its
cache, and the balancer's moves riding each reply (resolver_changes); it
keeps the live committed version the proxies report and the GRV proxies
read.  The clock is a constructor argument (time.monotonic by default),
so a test can drive it.  The calls are synchronous, so a request that
arrives ahead of its predecessor raises instead of parking.

Left out: the balancing loop's interval delay (the caller steps the
balancer), the DBCoreState persistence of the moved boundaries and the
whole recovery state machine (coordination is not ported).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from ..core.knobs import server_knobs
from ..core.trace import TraceEvent
from ..txn.types import KeyRange, Version
from .interfaces import (RESOLVER_ALL, GetCommitVersionReply,
                         GetCommitVersionRequest, GetRawCommittedVersionReply,
                         GetRawCommittedVersionRequest,
                         ReportRawCommittedVersionRequest, Reply,
                         ResolutionMetricsRequest, ResolutionSplitRequest)
from .shardmap import RangeMap
from .system_data import SYSTEM_KEYS_BEGIN

# Resolution balancing's gates, the reference's knob defaults
# (foundationdb_tpu/core/knobs.py:333-334): the least ranges a poll on the
# busiest resolver before a move, and the busiest-to-least-busy load
# ratio that triggers one.
RESOLUTION_BALANCING_MIN_LOAD = 50
RESOLUTION_BALANCING_RATIO = 1.5


def _split_points(n: int) -> List[bytes]:
    return [bytes([(256 * i) // n]) for i in range(1, n)]


def seed_resolver_boundaries(key_servers_ranges, n_resolvers: int
                             ) -> List[bytes]:
    """n-1 interior cut keys for the resolver plane, seeded equi-depth
    from the storage shard map, triples (begin, end, team): DD keeps
    shards split by data volume, so shard begin keys sample the committed
    key distribution -- static even byte splits would land a
    shared-prefix keyspace (tenants, "k000..." keys) entirely on one
    resolver.  Falls back to static byte splits when the shard map is too
    coarse to cut n ways (cold boot)."""
    if n_resolvers <= 1:
        return []
    cands = sorted({b for b, _e, _team in key_servers_ranges
                    if b"" < b < SYSTEM_KEYS_BEGIN})
    if len(cands) < n_resolvers - 1:
        return _split_points(n_resolvers)
    cuts: List[bytes] = []
    for i in range(1, n_resolvers):
        c = cands[min(len(cands) - 1, (i * len(cands)) // n_resolvers)]
        if not cuts or c > cuts[-1]:
            cuts.append(c)
    if len(cuts) != n_resolvers - 1:
        return _split_points(n_resolvers)
    return cuts


def _valid_resolver_ranges(ranges, n_resolvers: int) -> bool:
    """A user-keyspace ownership list is adoptable iff it covers
    [b"", \\xff) contiguously AND every resolver index owns some user
    range (a count increase must re-seed, or the extra resolvers would
    hold only the \\xff broadcast)."""
    if not ranges:
        return False
    cur = b""
    seen = set()
    for b, e, idx in ranges:
        if b != cur or e <= b or not 0 <= idx < n_resolvers:
            return False
        seen.add(idx)
        cur = e
    return cur == SYSTEM_KEYS_BEGIN and len(seen) == n_resolvers


def _key_resolver_ranges(n_resolvers: int,
                         user_ranges=None,
                         boundaries: Optional[List[bytes]] = None
                         ) -> List[Tuple[bytes, bytes, int]]:
    """The epoch's keyResolvers assignment: user-keyspace ownership ranges
    (adopted, seeded from `boundaries`, or static even byte splits) plus
    the \\xff system range broadcast to ALL resolvers -- every resolver
    holds identical system-key history, so metadata transactions resolve
    identically everywhere and boundary moves never migrate it."""
    if user_ranges is None:
        if boundaries is None:
            boundaries = _split_points(n_resolvers)
        bounds = [b""] + list(boundaries) + [SYSTEM_KEYS_BEGIN]
        user_ranges = [(bounds[i], bounds[i + 1], i)
                       for i in range(n_resolvers)]
    return list(user_ranges) + [
        (SYSTEM_KEYS_BEGIN, b"\xff\xff", RESOLVER_ALL)]


class ResolutionBalancer:
    """Moves resolver boundaries by measured load, and keeps the moves
    until every proxy has them.

    When the busiest resolver's ranges since the last poll exceed the
    least busy's by RESOLUTION_BALANCING_RATIO (and at least
    RESOLUTION_BALANCING_MIN_LOAD), the first of its owned ranges that
    its sampled load splits is cut at the load midpoint and the upper
    part moves to the least busy.  The \\xff system range (RESOLVER_ALL)
    never matches a resolver index, so it never moves."""

    def __init__(self, key_resolver_ranges, expected_proxies=()) -> None:
        self.owned: RangeMap = RangeMap(default=0)
        for b, e, idx in key_resolver_ranges:
            self.owned.set_range(b, e, idx)
        # (KeyRange, resolver_idx, change_version) in change order.
        self.resolution_changes: list = []
        self.resolution_changes_version: Version = 0
        # The proxies of the epoch; a change is dropped once all of them
        # have been handed it (a version-age GC would let an idle proxy
        # miss a move and keep routing to the old owner).
        self.expected_proxies = list(expected_proxies)
        self.last_change_seen: Dict[str, Version] = {}

    def step(self, resolvers, version: Version) -> Optional[tuple]:
        """One pass of the reference's loop body over the roles' metrics
        and split requests; `version` is the last version handed out.
        Returns the change made, or None."""
        loads = []
        for r in resolvers:
            reply = Reply()
            r.serve_metrics(ResolutionMetricsRequest(reply=reply))
            loads.append(reply.value)
        hi = max(range(len(loads)), key=lambda i: loads[i])
        lo = min(range(len(loads)), key=lambda i: loads[i])
        if loads[hi] < RESOLUTION_BALANCING_MIN_LOAD or \
                loads[hi] < loads[lo] * RESOLUTION_BALANCING_RATIO or \
                hi == lo:
            return None
        src_ranges = [(b, e) for b, e, idx in self.owned.ranges()
                      if idx == hi]
        split = e = None
        for rb, re_ in src_ranges:
            reply = Reply()
            resolvers[hi].serve_split(ResolutionSplitRequest(
                begin=rb, end=re_, fraction=0.5, reply=reply))
            cand = reply.value
            if cand is not None and rb < cand < re_:
                e, split = re_, cand
                break
        if split is None:
            return None
        self.owned.set_range(split, e, lo)
        # Strictly increasing: two moves with no version handed out
        # between them must not share a change version, or proxies (which
        # dedup by version) would drop the second.
        self.resolution_changes_version = max(
            version + 1, self.resolution_changes_version + 1)
        change = (KeyRange(split, e), lo, self.resolution_changes_version)
        self.resolution_changes.append(change)
        TraceEvent("ResolutionBalanced").detail(
            "From", hi).detail("To", lo).detail(
            "SplitKey", split).detail("End", e).detail(
            "Loads", loads).log()
        return change

    def changes_for(self, proxy_id: str) -> list:
        """The changes a version reply to `proxy_id` carries: first drop
        those every expected proxy has been handed, then hand this proxy
        the rest (reference Master._allocate_version, _reply_version)."""
        self.last_change_seen.setdefault(proxy_id, 0)
        if self.resolution_changes:
            seen = [self.last_change_seen.get(pid, 0)
                    for pid in (self.expected_proxies or
                                list(self.last_change_seen))]
            floor = min(seen) if seen else 0
            self.resolution_changes = [
                c for c in self.resolution_changes if c[2] > floor]
        self.last_change_seen[proxy_id] = max(
            self.last_change_seen[proxy_id], self.resolution_changes_version)
        return list(self.resolution_changes)


class _ProxyVersionState:
    """Per-proxy request ordering + resend dedup (reference
    MasterData::lastCommitProxyVersionReplies)."""

    __slots__ = ("last_request_num", "replies")

    def __init__(self) -> None:
        # Proxies number requests from 1; "0 already served" seeds the chain.
        self.last_request_num = 0
        self.replies: Dict[int, GetCommitVersionReply] = {}


class Master:
    """One master epoch's commit-version state."""

    def __init__(self, recovery_version: Version = 0,
                 clock: Callable[[], float] = time.monotonic,
                 balancer: Optional[ResolutionBalancer] = None) -> None:
        """`clock`: seconds, read once a version request.  `balancer`:
        the resolution balancer whose moves ride the version replies (none:
        no moves)."""
        self.version: Version = recovery_version       # last allocated
        self.live_committed_version: Version = recovery_version
        self.last_version_time: float = 0.0
        self.clock = clock
        self.balancer = balancer
        self.proxy_states: Dict[str, _ProxyVersionState] = {}

    # -- version allocation (reference getVersion :1126) ---------------------
    def _allocate_version(self, proxy_id: str) -> GetCommitVersionReply:
        knobs = server_knobs()
        t1 = self.clock()
        if self.last_version_time == 0.0:
            self.last_version_time = t1
        to_add = max(1, min(int(knobs.MAX_READ_TRANSACTION_LIFE_VERSIONS / 2),
                            int(knobs.VERSIONS_PER_SECOND *
                                (t1 - self.last_version_time))))
        self.last_version_time = t1
        prev = self.version
        new_version = self.version + to_add
        # Gap cap: don't run more than MAX_VERSIONS_IN_FLIGHT ahead of the
        # fully-committed frontier.
        max_allowed = self.live_committed_version + int(
            knobs.MAX_VERSIONS_IN_FLIGHT)
        new_version = max(prev + 1, min(new_version, max_allowed))
        self.version = new_version
        changes, changes_version = [], 0
        if self.balancer is not None:
            # The balancer drops the changes every expected proxy has been
            # handed, then hands this proxy the rest (the reference's
            # resolver-change GC and last_change_seen).
            changes = self.balancer.changes_for(proxy_id)
            changes_version = self.balancer.resolution_changes_version
        return GetCommitVersionReply(
            version=new_version, prev_version=prev,
            resolver_changes=changes,
            resolver_changes_version=changes_version)

    def serve_commit_version(self, req: GetCommitVersionRequest) -> None:
        """A proxy's version request: a resend of an answered request is
        answered from the cache (and dropped, unanswered, once evicted, as
        the reference drops it); the next request gets a new version; one
        ahead of its predecessor raises (the reference parks it, and the
        calls here are synchronous)."""
        st = self.proxy_states.setdefault(req.proxy_id, _ProxyVersionState())
        if req.request_num <= st.last_request_num:
            cached = st.replies.get(req.request_num)
            if cached is not None:
                req.reply.send(cached)
            return
        if req.request_num > st.last_request_num + 1:
            raise RuntimeError(
                f"master: request {req.request_num} of {req.proxy_id} "
                f"arrived before {st.last_request_num + 1}")
        reply = self._allocate_version(req.proxy_id)
        st.last_request_num = req.request_num
        st.replies[req.request_num] = reply
        # Drop replies older than the one before this (proxy won't resend).
        st.replies = {n: r for n, r in st.replies.items()
                      if n >= req.request_num - 1}
        req.reply.send(reply)

    # -- live committed version (reference :1217) ----------------------------
    def serve_live_committed(self, req: GetRawCommittedVersionRequest
                             ) -> None:
        req.reply.send(GetRawCommittedVersionReply(
            version=self.live_committed_version))

    def serve_report_committed(self, req: ReportRawCommittedVersionRequest
                               ) -> None:
        if req.version > self.live_committed_version:
            self.live_committed_version = req.version
        req.reply.send(None)
