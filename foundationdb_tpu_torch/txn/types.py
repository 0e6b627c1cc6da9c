"""Transaction payload types (trimmed to what the resolver and the write
path use).

Equivalents of the reference's fdbclient/CommitTransaction.h
(MutationRef :55-96, CommitTransactionRef :179, the versionstamp) and
fdbclient/FDBTypes.h (KeyRangeRef, Version, strinc).  Keys are raw bytes,
ordered lexicographically; ranges are half-open [begin, end).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional

Version = int


def strinc(key: bytes) -> bytes:
    """Smallest key strictly greater than every key with prefix `key`.

    Reference: flow strinc() -- strips trailing 0xff bytes then increments the
    last byte. Raises if key is empty or all 0xff (no such key exists)."""
    key = key.rstrip(b"\xff")
    if not key:
        raise ValueError("strinc on empty/all-0xff key")
    return key[:-1] + bytes([key[-1] + 1])


def key_after(key: bytes) -> bytes:
    """Smallest key strictly greater than `key` (append \\x00)."""
    return key + b"\x00"


def single_key_range(key: bytes) -> "KeyRange":
    return KeyRange(key, key_after(key))


@dataclass(frozen=True, order=True)
class KeyRange:
    """Half-open key interval [begin, end); empty if begin >= end."""

    begin: bytes
    end: bytes

    def __post_init__(self) -> None:
        if self.begin > self.end:
            from ..core.error import err
            raise err("inverted_range", f"{self.begin!r} > {self.end!r}")

    def empty(self) -> bool:
        return self.begin >= self.end

    def contains(self, key: bytes) -> bool:
        return self.begin <= key < self.end

    def overlaps(self, other: "KeyRange") -> bool:
        return self.begin < other.end and other.begin < self.end

    def intersect(self, other: "KeyRange") -> Optional["KeyRange"]:
        b, e = max(self.begin, other.begin), min(self.end, other.end)
        return KeyRange(b, e) if b < e else None


def make_versionstamp(version: int, batch_index: int) -> bytes:
    """The 10-byte versionstamp: 8B big-endian commit version + 2B
    big-endian transaction batch index (reference CommitTransaction.h:55).
    An index past 65,535 does not fit and raises OverflowError."""
    return version.to_bytes(8, "big") + batch_index.to_bytes(2, "big")


class MutationType(IntEnum):
    """Mutation op codes (reference fdbclient/CommitTransaction.h:55-96)."""

    SetValue = 0
    ClearRange = 1
    AddValue = 2
    DebugKeyRange = 3
    DebugKey = 4
    NoOp = 5
    And = 6
    Or = 7
    Xor = 8
    AppendIfFits = 9
    AvailableForReuse = 10
    Reserved_For_LogProtocolMessage = 11
    Max = 12
    Min = 13
    SetVersionstampedKey = 14
    SetVersionstampedValue = 15
    ByteMin = 16
    ByteMax = 17
    MinV2 = 18
    AndV2 = 19
    CompareAndClear = 20


# The ops a storage server resolves against the key's current value when it
# applies them (txn/atomic.py; the versionstamped ones become SetValue at
# the commit proxy first).
ATOMIC_OPS = {
    MutationType.AddValue, MutationType.And, MutationType.Or, MutationType.Xor,
    MutationType.AppendIfFits, MutationType.Max, MutationType.Min,
    MutationType.SetVersionstampedKey, MutationType.SetVersionstampedValue,
    MutationType.ByteMin, MutationType.ByteMax, MutationType.MinV2,
    MutationType.AndV2, MutationType.CompareAndClear,
}


@dataclass
class Mutation:
    """One mutation: (type, param1, param2).

    SetValue: param1=key, param2=value. ClearRange: param1=begin, param2=end.
    Atomic ops: param1=key, param2=operand."""

    type: MutationType
    param1: bytes
    param2: bytes

    def expected_size(self) -> int:
        return len(self.param1) + len(self.param2) + 12

    @staticmethod
    def set_value(key: bytes, value: bytes) -> "Mutation":
        return Mutation(MutationType.SetValue, key, value)

    @staticmethod
    def clear_range(begin: bytes, end: bytes) -> "Mutation":
        return Mutation(MutationType.ClearRange, begin, end)


@dataclass
class CommitTransactionRef:
    """A transaction as submitted for commit: its conflict ranges, read
    snapshot and mutations (reference fdbclient/CommitTransaction.h:179).
    Mutations are not part of the conflict check: the resolver counts
    their bytes and hands a state transaction's on to the other proxies.
    tenant_id (-1 = raw) and tag are the identity the resolver's heat
    tracker blames an abort on (conflict/heat.py)."""

    read_conflict_ranges: List[KeyRange] = field(default_factory=list)
    write_conflict_ranges: List[KeyRange] = field(default_factory=list)
    mutations: List[Mutation] = field(default_factory=list)
    read_snapshot: Version = 0
    report_conflicting_keys: bool = False
    tenant_id: int = -1
    tag: str = ""

    def expected_size(self) -> int:
        s = sum(len(r.begin) + len(r.end) for r in
                self.read_conflict_ranges + self.write_conflict_ranges)
        return s + sum(m.expected_size() for m in self.mutations)


class CommitResult(IntEnum):
    """Per-transaction resolver verdict.

    Reference ConflictBatch::TransactionCommitResult (ConflictSet.h:41-45)."""

    CONFLICT = 0
    TOO_OLD = 1
    COMMITTED = 2
