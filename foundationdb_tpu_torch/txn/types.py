"""Transaction payload types (trimmed to what the conflict path uses).

Equivalents of the reference's fdbclient/CommitTransaction.h
(CommitTransactionRef :179) and fdbclient/FDBTypes.h (KeyRangeRef,
Version).  Keys are raw bytes, ordered lexicographically; ranges are
half-open [begin, end).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional

Version = int


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


@dataclass
class CommitTransactionRef:
    """A transaction as submitted for commit: its conflict ranges and read
    snapshot (reference fdbclient/CommitTransaction.h:179).  Mutations are
    not part of the conflict check and are carried opaquely."""

    read_conflict_ranges: List[KeyRange] = field(default_factory=list)
    write_conflict_ranges: List[KeyRange] = field(default_factory=list)
    mutations: list = field(default_factory=list)
    read_snapshot: Version = 0
    report_conflicting_keys: bool = False


class CommitResult(IntEnum):
    """Per-transaction resolver verdict.

    Reference ConflictBatch::TransactionCommitResult (ConflictSet.h:41-45)."""

    CONFLICT = 0
    TOO_OLD = 1
    COMMITTED = 2
