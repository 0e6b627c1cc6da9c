"""Server knobs the port reads (trimmed copy of foundationdb_tpu/core/knobs.py).

Only what the port's conflict path consults: HEAT_TELEMETRY_ENABLED, the
master switch of the heat-telemetry attribution that
ConflictSet.resolve_with_conflicts fills (conflict/api.py).  Set it the way
the reference's tests do: mutate the process-wide registry,
`server_knobs().HEAT_TELEMETRY_ENABLED = False`, and restore it after.
The supervisor's CONFLICT_* and HEAT_* knobs join when the supervisor is
ported.
"""

from __future__ import annotations


class ServerKnobs:
    """Server-side knobs, with the reference's defaults."""

    def __init__(self) -> None:
        # Cluster heat telemetry (the reference's conflict/heat.py): gates
        # the per-batch conflict attribution of resolve_with_conflicts.
        self.HEAT_TELEMETRY_ENABLED = True


_server = ServerKnobs()


def server_knobs() -> ServerKnobs:
    return _server
