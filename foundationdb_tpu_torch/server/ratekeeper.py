"""The ratekeeper's conflict-heat poll (trimmed copy of
foundationdb_tpu/server/ratekeeper.py).

The reference's ratekeeper polls every resolver's conflict-heat feed
(_poll_conflict_heat, :392) and folds the rows (_fold_conflict_heat,
:416) for the GRV proxies' predictors, which read them off the rate-info
replies they already poll for.  Here poll_conflict_heat(resolvers) is one
turn of that loop, synchronous: each role answers a ResolverHeatRequest
within the call (Resolver.serve_heat), and it returns the fold for the
plane to hand every GRV proxy (server/cluster.py feed()).

As a recruited role (a cluster controller's master recruits one an
epoch, server/worker.py) it registers RatekeeperInterface's waitFailure
stream, the failure signal its master watches.

Left out on purpose: the rate budget (storage and TLog queue polls, the
tps and batch-tps limits), tag throttles and tag metering, the rate-info
and status streams, and the RPC.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..core.knobs import server_knobs
from ..core.scheduler import TaskPriority
from ..rpc.endpoint import RequestStream
from ..sched.predictor import TABLE_MAX
from .failure import hold_wait_failure
from .interfaces import Reply, ResolverHeatRequest


class RatekeeperInterface:
    """The reference's RatekeeperInterface but its rate-info and status
    streams."""

    def __init__(self, rk_id: str = "rk") -> None:
        self.id = rk_id
        self.wait_failure = RequestStream("rk.waitFailure",
                                          TaskPriority.FailureMonitor)

    def streams(self) -> List[RequestStream]:
        return [self.wait_failure]


class Ratekeeper:
    def __init__(self, ratekeeper_id: str = "ratekeeper") -> None:
        self.id = ratekeeper_id
        self.interface = RatekeeperInterface(ratekeeper_id)
        self.interface.role = self   # in-process backref (not on the wire)

    def run(self, process) -> list:
        """Register the interface on `process` and hold its waitFailure
        requests there; the holder's future."""
        for stream in self.interface.streams():
            process.register(stream)
        return [process.spawn(hold_wait_failure(self.interface.wait_failure),
                              f"{self.id}.waitFailure")]

    def poll_conflict_heat(self, resolvers: List[Any]) -> List[tuple]:
        """One turn of the reference's _poll_conflict_heat: ask every role
        for its top heat rows and fold them.  Idle while
        SCHED_PREDICTOR_ENABLED is off (no request, no rows).  Returns the
        folded rows."""
        if not server_knobs().SCHED_PREDICTOR_ENABLED or not resolvers:
            return []
        top_k = max(8, TABLE_MAX // 8)
        per_resolver = []
        for role in resolvers:
            req = ResolverHeatRequest(top_k=top_k, reply=Reply())
            role.serve_heat(req)
            per_resolver.append(req.reply.value)
        return self._fold_conflict_heat(per_resolver, top_k)

    @staticmethod
    def _fold_conflict_heat(per_resolver: List[Any], top_k: int
                            ) -> List[tuple]:
        """Merge per-resolver feed rows: resolver partitions are
        disjoint over user keys, but the broadcast \\xff range (and a
        boundary move's history overlap) can surface one range twice —
        sum counts, merge identity breakdowns.  Output hottest-first,
        key-ordered on ties (deterministic)."""
        merged: Dict[tuple, list] = {}
        for rows in per_resolver:
            for row in rows or ():
                begin, end, conflicts, load = row[0], row[1], row[2], row[3]
                tags = dict(row[4] or {}) if len(row) > 4 else {}
                tenants = dict(row[5] or {}) if len(row) > 5 else {}
                e = merged.get((begin, end))
                if e is None:
                    merged[(begin, end)] = [conflicts, load, tags, tenants]
                else:
                    e[0] += conflicts
                    e[1] += load
                    for t, n in tags.items():
                        e[2][t] = e[2].get(t, 0) + n
                    for t, n in tenants.items():
                        e[3][t] = e[3].get(t, 0) + n
        rows = [(b, e, v[0], v[1], v[2], v[3])
                for (b, e), v in merged.items()]
        rows.sort(key=lambda r: (-r[2], r[0], r[1]))
        return rows[:top_k]
