"""Transaction repair eligibility: staleness-only aborts, exactly blamed
(copy of foundationdb_tpu/sched/repair.py, function for function).

Reference: "Transaction Repair: Full Serializability Without Locks"
(arXiv 1403.5645) — an aborted transaction whose only sin is a stale
read set can be salvaged by re-executing against fresh reads instead of
bouncing to the client.  This plane cannot re-run client logic, so the
salvage is OPT-IN (``CommitTransactionRequest.repair_eligible``): the
client declares its mutations remain valid under re-read — blind
writes, atomic ops, existence guards.  The commit proxy then re-stamps
the transaction at a fresh read version and re-resolves it once
(``TXN_REPAIR_MAX_ATTEMPTS``), converting a full client round trip into
one extra resolver hop.

The eligibility predicate is deliberately strict:

* the abort's attribution must be EXACT (the resolvers pinned the true
  culprit ranges; conservative whole-read-set blame proves nothing);
* every culprit must lie INSIDE the transaction's declared read set —
  pure read-set staleness, no write-write component to re-stamp away
  (in this OCC plane conflicts are read-vs-write by construction, so a
  culprit escaping the read set marks attribution breakage, not a
  repairable abort);
* the attempt budget must not be exhausted.

Beyond the single re-resolution, ``RepairLadder`` implements the bounded
multi-attempt ladder (``TXN_REPAIR_MAX_ATTEMPTS`` > 1): each FAILED
re-resolution of a culprit range backs that RANGE off for
``backoff_versions`` doubling per rung, on the commit-VERSION clock — no
wall time, so the ladder is deterministic in simulation and identical in
the bench's pipeline model.  A range rewritten faster than one batch
interval stops burning resolver round trips after a couple of rungs,
while cold ranges keep repairing at full speed; entries expire as the
version clock passes them.

Pure functions + a pure-state class, no clock, no RNG — callable from
the proxy's commit path and from the bench's host-side pipeline model
alike.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

# The commit proxy's ladder (RepairLadder.default()), at the reference's
# knob defaults: a range's base backoff after its ladder is exhausted, in
# versions (TXN_REPAIR_BACKOFF_VERSIONS), and the table's bound
# (TXN_REPAIR_LADDER_TABLE_MAX).
BACKOFF_VERSIONS, LADDER_TABLE_MAX = 250, 1024


def culprits_in_read_set(read_ranges: Sequence,
                         culprits: Iterable[Tuple[bytes, bytes]]) -> bool:
    """Every culprit [b, e) contained in some declared read range.
    Culprits arrive clipped per resolver, so containment (not equality)
    is the right test."""
    spans = [(r.begin, r.end) for r in read_ranges]
    for b, e in culprits:
        if not any(rb <= b and e <= re for rb, re in spans):
            return False
    return True


def repair_eligible(txn, culprits: List[Tuple[bytes, bytes]],
                    exact: bool, attempt: int, max_attempts: int) -> bool:
    """Can this CONFLICT-verdict transaction be re-stamped and
    re-resolved server-side?  See the module doc for the gates."""
    if attempt >= max_attempts:
        return False
    if not exact or not culprits:
        return False
    return culprits_in_read_set(txn.read_conflict_ranges, culprits)


class RepairLadder:
    """Per-range repair backoff on the commit-version clock.

    ``note_failure(culprits, version)`` is called when a repair
    attempt's re-resolution STILL conflicted: every culprit range climbs
    one rung and is blocked until ``version + backoff << (rung-1)``.
    ``should_attempt(culprits, version)`` gates the next repair of any
    transaction blaming a blocked range.  State is bounded by
    ``table_max`` (expired entries trimmed first, then the
    earliest-expiring — the least-blocked — so the hottest ranges keep
    their rungs).  Deliberately version-driven: deterministic in
    simulation, replayable in the bench model, and self-expiring as the
    cluster's version clock advances."""

    __slots__ = ("backoff_versions", "table_max", "_entries")

    def __init__(self, backoff_versions: int = 1000,
                 table_max: int = 1024) -> None:
        self.backoff_versions = max(1, int(backoff_versions))
        self.table_max = max(1, int(table_max))
        # (begin, end) -> [blocked_until_version, rung]
        self._entries: Dict[Tuple[bytes, bytes], list] = {}

    @classmethod
    def default(cls) -> "RepairLadder":
        return cls(BACKOFF_VERSIONS, LADDER_TABLE_MAX)

    def should_attempt(self, culprits: Iterable[Tuple[bytes, bytes]],
                       version: int) -> bool:
        entries = self._entries
        for key in culprits:
            ent = entries.get(key)
            if ent is not None and version < ent[0]:
                return False
        return True

    def note_failure(self, culprits: Iterable[Tuple[bytes, bytes]],
                     version: int) -> None:
        entries = self._entries
        for key in culprits:
            ent = entries.get(key)
            if ent is None:
                entries[key] = [version + self.backoff_versions, 1]
            else:
                rung = min(ent[1] + 1, 16)   # cap the shift, not the block
                ent[0] = version + (self.backoff_versions << (rung - 1))
                ent[1] = rung
        if len(entries) > self.table_max:
            self._trim(version)

    def note_success(self, spans: Iterable[Tuple[bytes, bytes]]) -> None:
        """A repair covering these read spans committed: drop the rungs
        of every blocked range CONTAINED in them.  Containment, not
        equality — entries are keyed by resolver-CLIPPED culprit
        fragments (see culprits_in_read_set), so a straddling range's
        fragments must still clear when the whole declared range
        repairs."""
        entries = self._entries
        if not entries:
            return
        spans = list(spans)
        if not spans:
            return
        for key in [k for k in entries
                    if any(sb <= k[0] and k[1] <= se for sb, se in spans)]:
            del entries[key]

    def blocked_count(self, version: int) -> int:
        return sum(1 for until, _ in self._entries.values()
                   if version < until)

    def _trim(self, version: int) -> None:
        entries = self._entries
        expired = [k for k, (until, _r) in entries.items()
                   if until <= version]
        for k in expired:
            del entries[k]
        if len(entries) > self.table_max:
            for k in sorted(entries, key=lambda k: entries[k][0])[
                    :len(entries) - self.table_max]:
                del entries[k]
