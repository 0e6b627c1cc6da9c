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

Left out: the loop's interval delay (the caller steps the balancer),
the DBCoreState persistence of the moved boundaries (coordination is not
ported) and version allocation (the plane's caller supplies versions).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core.trace import TraceEvent
from ..txn.types import KeyRange, Version
from .interfaces import (RESOLVER_ALL, Reply, ResolutionMetricsRequest,
                         ResolutionSplitRequest)
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
