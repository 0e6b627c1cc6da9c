"""Code-coverage markers (a copy of foundationdb_tpu/core/coverage.py;
reference flow's TEST() macro and the TestHarness coverage ledger).

`test_coverage("...")` marks a code path as exercised; `covered()`,
`hits()`, `report()` and `missing()` read the port's own registry (no
other package's markers reach it).  The ledger below lists the markers
of the reference's code base, so report() names a path that never fired
even where the port has no such path yet.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Set

_hits: Counter = Counter()
_registered: Set[str] = set()


def test_coverage(name: str) -> None:
    """Mark this code path as exercised (reference TEST(name))."""
    _registered.add(name)
    _hits[name] += 1


def register(name: str) -> None:
    """Pre-register a marker so report() can list it as NEVER hit even
    when the marking line itself never executed."""
    _registered.add(name)


def covered(name: str) -> bool:
    return _hits[name] > 0


def hits(name: str) -> int:
    return _hits[name]


def report() -> Dict[str, int]:
    return {name: _hits[name] for name in sorted(_registered)}


def missing() -> List[str]:
    return [name for name in sorted(_registered) if _hits[name] == 0]


def reset() -> None:
    _hits.clear()


# Markers that exist in the codebase (kept in sync with the
# test_coverage() call sites); ensembles report any that never fire.
for _name in (
    "RecoveryMasterLockedOldGeneration",
    "RecoveryRegionFailover",
    "TLogSpillActivated",
    "TaskBucketReclaim",
    "DDShardMerge",
    "RatekeeperThrottling",
    "RatekeeperTenantQuota",
    "ProxyTenantRejected",
    # Chaos engine: disk-fault detection paths.  Every injected
    # corruption/IO fault must be CAUGHT by the layer above — these mark
    # the catch sites, so a suite that injects faults the code silently
    # serves through shows up as a never-hit marker.
    "SimDiskIoErrorInjected",
    "SimDiskBitRotInjected",
    "DiskQueueCrcCaught",
    "BTreeSlotCrcCaught",
    "StorageIoErrorDeath",
    "TLogIoErrorDeath",
    "ChaosNemesisSwizzle",
    "ChaosNemesisAttrition",
    "ChaosNemesisPartition",
    # Resolution-plane attrition: a live resolver's worker is
    # killed; recovery must recruit a fresh plane with verdict
    # continuity (Cycle + ConsistencyCheck run alongside).
    "ChaosNemesisResolverKill",
    # Disaster-recovery nemesis battery: undrained region
    # failover (primary dc hard-killed mid-traffic, remote plane adopted
    # at min(end_version)), rolling coordinator restart (re-election +
    # CoordinationClientInterface re-pointing), fatal disk fault with
    # worker restart (the topology heals instead of shrinking), and a
    # backup captured + restored while the nemesis runs.
    "ChaosRegionFailover",
    "ChaosCoordinatorRestart",
    "ChaosFatalDiskRestart",
    "BackupRestoreUnderChaos",
    # Conflict-aware scheduling: predictor deferral at GRV
    # admission, intra-batch reorder at the commit proxy, and the
    # server-side repair path (attempted + committed) — the SchedChaos
    # spec must keep exercising all three stages.
    "GrvSchedDeferral",
    "ProxyBatchReordered",
    "ProxyTxnRepaired",
    "ProxyTxnRepairCommitted",
    # Gray-failure battery: one live link latency-inflated —
    # delivery still succeeds, so only the peer-health plane (ping RTT
    # verdicts, server/health.py) can observe it.
    "ChaosNemesisGrayClog",
    # Shard-disownment fence (system_data.py DISOWN_SHARD_PREFIX): a
    # storage server that missed DD's out-of-band RemoveShardRequest
    # (unreachable during the move) closes the range in-stream instead
    # of serving frozen data — the stale-read hole the chaos battery
    # flushed out.
    "SSDisownShardFence",
):
    register(_name)
