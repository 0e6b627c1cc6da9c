"""Transaction payload types used by the conflict path, the resolver and
the write path, and the atomic operators (atomic.py)."""

from .types import (ATOMIC_OPS, CommitResult, CommitTransactionRef, KeyRange,
                    Mutation, MutationType, Version, key_after,
                    make_versionstamp, single_key_range, strinc)

__all__ = ["ATOMIC_OPS", "CommitResult", "CommitTransactionRef", "KeyRange",
           "Mutation", "MutationType", "Version", "key_after",
           "make_versionstamp", "single_key_range", "strinc"]
